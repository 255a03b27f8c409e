"""On-demand ``torch.profiler`` capture sessions.

Mirrors :mod:`svoc_tpu.obsplane.profiler` (``profiler.py:1-203``):
:class:`ProfileCapture` on ``torch.profiler`` where the reference's is
on ``jax.profiler``, with the card's activity (``ProfilerActivity.CUDA``)
recorded whenever CUDA is available.

- **manual**: :meth:`ProfileCapture.start` / :meth:`~ProfileCapture.stop`
  capture into ``<out_dir>/profile-<n>`` (a monotone index, never a
  timestamp: the path is journaled and the wall clock never enters
  journal data), where the stop writes the Chrome trace ``trace.json``;
- **automatic**: the
  :class:`~svoc_torch.utils.postmortem.PostmortemMonitor` calls
  :meth:`~ProfileCapture.maybe_capture` on SLO burn and breaker-open,
  rate-limited (120 s between automatic captures by default);
- **bounded**: every capture ends after ``max_duration_s`` (30 s by
  default).

Where the port departs: ``torch.profiler`` must be stopped on the thread
that started it (a stop from another thread, such as the reference's
timer thread, crashes the process), so the capture belongs to the thread
that started it.  The duration bound is a deadline checked there: the
first call of :meth:`~ProfileCapture.poll`, :meth:`~ProfileCapture.start`,
:meth:`~ProfileCapture.stop`, :meth:`~ProfileCapture.maybe_capture` or
:meth:`~ProfileCapture.status` on that thread after the deadline stops
it, and a stop asked from another thread is recorded and carried out the
same way (``stop_pending``).

A completed capture journals one ``profile.captured`` event (trigger and
path).  A capture that fails counts into ``profile_errors{stage=}`` and
comes back as an ``error`` status; serving never stops over telemetry.
The last completed capture's profiler stays readable as
:attr:`ProfileCapture.last` (its ``key_averages()`` carry the device
times).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Optional

from svoc_torch.utils.metrics import MetricsRegistry
from svoc_torch.utils.metrics import registry as _default_registry

#: The Chrome trace's file name inside a capture's directory.
TRACE_FILE = "trace.json"


class ProfileCapture:
    """One process-wide profiler session manager (``torch.profiler``
    takes one active capture at a time)."""

    def __init__(
        self,
        out_dir: str = "profiles",
        *,
        journal=None,
        metrics: Optional[MetricsRegistry] = None,
        max_duration_s: float = 30.0,
        auto_min_interval_s: float = 120.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.out_dir = out_dir
        self._journal = journal
        self._metrics = metrics or _default_registry
        self.max_duration_s = max_duration_s
        self.auto_min_interval_s = auto_min_interval_s
        self._clock = clock
        self._lock = threading.Lock()
        self._active: Optional[dict] = None
        self._profiler: Any = None
        #: The thread that started the active capture, its deadline on the
        #: monotonic clock, and whether another thread asked it to stop.
        self._owner: Optional[int] = None
        self._deadline = 0.0
        self._stop_requested = False
        self._captures = 0
        self._last_auto: Optional[float] = None
        #: The last completed capture's ``torch.profiler.profile``.
        self.last: Any = None

    # -- availability --------------------------------------------------------

    @staticmethod
    def available() -> bool:
        try:
            import torch.profiler  # noqa: F401

            return True
        except Exception:
            return False

    def _emit(self, event_type: str, **data) -> None:
        j = self._journal
        if j is None:
            from svoc_torch.utils.events import journal as j
        j.emit(event_type, **data)

    def _error(self, stage: str, exc: Exception) -> dict:
        self._metrics.counter("profile_errors", labels={"stage": stage}).add(1)
        return {"status": "error", "stage": stage, "error": f"{type(exc).__name__}: {exc}"}

    # -- capture lifecycle ---------------------------------------------------

    def start(self, trigger: str = "manual", duration_s: Optional[float] = None) -> dict:
        """Start a capture owned by the calling thread.  Returns a status
        dict and never raises: ``started``, ``already_running`` or
        ``error``."""
        self.poll()
        duration = min(self.max_duration_s,
                       duration_s if duration_s is not None else self.max_duration_s)
        with self._lock:
            if self._active is not None:
                return {"status": "already_running", **self._active}
            self._captures += 1
            index = self._captures
        log_dir = os.path.join(self.out_dir, f"profile-{index:04d}")
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
        except Exception as e:
            return self._error("import", e)
        try:
            os.makedirs(log_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:
            return self._error("start", e)
        info = {"path": log_dir, "trigger": trigger, "index": index}
        with self._lock:
            self._active = info
            self._profiler = prof
            self._owner = threading.get_ident()
            self._deadline = time.monotonic() + duration
            self._stop_requested = False
        self._metrics.counter("profile_captures", labels={"trigger": trigger}).add(1)
        return {"status": "started", "duration_s": duration, **info}

    def stop(self) -> dict:
        """Stop the active capture, write its Chrome trace and journal
        ``profile.captured``; from another thread than the owner's, the
        stop is recorded (``stop_pending``) for the owner's next call."""
        with self._lock:
            info = self._active
            if info is None:
                return {"status": "idle"}
            if threading.get_ident() != self._owner:
                self._stop_requested = True
                return {"status": "stop_pending", **info}
            prof = self._profiler
            self._active = self._profiler = self._owner = None
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(info["path"], TRACE_FILE))
        except Exception as e:
            return self._error("stop", e)
        self.last = prof
        # The data carries no clock reading: the capture's timing lives in
        # the trace, not the journal.
        self._emit("profile.captured", trigger=info["trigger"], path=info["path"])
        return {"status": "captured", **info}

    def poll(self) -> Optional[dict]:
        """On the owning thread, stop the capture when its deadline has
        passed or another thread asked; returns the stop's status, or
        None when there was nothing to stop."""
        with self._lock:
            due = (self._active is not None and threading.get_ident() == self._owner
                   and (self._stop_requested or time.monotonic() >= self._deadline))
        return self.stop() if due else None

    def maybe_capture(self, trigger: str) -> Optional[dict]:
        """The automatic path: start a capture unless one runs or the
        rate limit holds (counted in ``profile_suppressed``)."""
        self.poll()
        now = self._clock()
        with self._lock:
            if self._active is not None:
                return None
            if self._last_auto is not None and now - self._last_auto < self.auto_min_interval_s:
                self._metrics.counter("profile_suppressed", labels={"reason": "rate_limit"}).add(1)
                return None
            self._last_auto = now
        return self.start(trigger=trigger)

    def status(self) -> dict:
        self.poll()
        with self._lock:
            active = dict(self._active) if self._active else None
            captures = self._captures
        return {
            "available": self.available(),
            "active": active,
            "captures": captures,
            "max_duration_s": self.max_duration_s,
        }

    def attach(self, console) -> None:
        """Expose through a CommandConsole: the ``profile`` command and
        ``GET /api/profile`` read ``console.profiler``."""
        console.profiler = self
