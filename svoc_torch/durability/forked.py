"""Children of the durability gates, forked from one fork server.

The kill/restart gate (:mod:`svoc_torch.tools.crash_smoke`) and the
fault-space fuzzer (:mod:`svoc_torch.tools.chaos_fuzz`) run each phase
of a scenario as a child process that is SIGKILLed at its fault point.
Where the reference spawns a fresh interpreter a child, the port forks
each from ``multiprocessing``'s fork server, one a parent process,
started at the first child: it has imported torch and the children's
modules (:data:`PRELOAD`) and never initialised CUDA.  A child is still
its own process, killed and reaped as a spawned one is, and initialises
CUDA itself after the fork; it skips a fresh interpreter's start and
imports (6-10 s of torch's on an H100's host).

A child runs ``module.main(argv)`` with its standard output and error in
temporary files that :meth:`ForkedChild.communicate` reads back.  A
process that forks no more children ends the server with :func:`stop`;
left alone, it outlives its parent for a moment.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

#: What the fork server imports before it forks a child: torch and both
#: gates' child modules, nothing that initialises CUDA.  The server starts
#: once a parent process, so it preloads for every gate.
PRELOAD = (
    "torch",
    "numpy.random",
    "sqlite3",
    "svoc_torch.apps.session",
    "svoc_torch.cluster.scenario",
    "svoc_torch.consensus.batch",
    "svoc_torch.durability.scenario",
    "svoc_torch.io.chain",
    "svoc_torch.ops.fused_consensus",
    "svoc_torch.resilience.retry",
    "svoc_torch.utils.checkpoint",
    "svoc_torch.tools.crash_smoke",
    "svoc_torch.tools.chaos_fuzz",
)

#: True in a forked child: its imports were the fork server's.
IN_CHILD = False


def _child_main(module: str, argv: List[str], out: str, err: str, env: Dict[str, str]) -> None:
    """A forked child: its output to ``out`` and ``err``, ``env`` set,
    then ``module.main(argv)``."""
    global IN_CHILD
    for fd, path in ((1, out), (2, err)):
        f = os.open(path, os.O_WRONLY | os.O_TRUNC)
        os.dup2(f, fd)
        os.close(f)
    os.environ.update(env)
    IN_CHILD = True
    try:
        rc = importlib.import_module(module).main(argv)
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
    sys.exit(rc)


class ForkedChild:
    """``module.main(argv)`` in a child forked from the fork server, with
    the part of :class:`subprocess.Popen` the gates read
    (``communicate``, ``returncode``); ``env`` is set in the child."""

    def __init__(self, module: str, argv: List[str], env: Optional[Dict[str, str]] = None):
        import multiprocessing

        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload(list(PRELOAD))
        self._paths = []
        for suffix in (".out", ".err"):
            fd, path = tempfile.mkstemp(prefix="forked-", suffix=suffix)
            os.close(fd)
            self._paths.append(path)
        self._proc = ctx.Process(target=_child_main, args=(module, list(argv), *self._paths, dict(env or {})))
        self._proc.start()

    @property
    def returncode(self) -> Optional[int]:
        return self._proc.exitcode

    def communicate(self, timeout: Optional[float] = None) -> Tuple[str, str]:
        """Wait for the child (SIGKILLing it past ``timeout``, then
        raising :class:`subprocess.TimeoutExpired` with its output); its
        ``(stdout, stderr)``."""
        self._proc.join(timeout)
        timed_out = self._proc.is_alive()
        if timed_out:
            self._proc.kill()
            self._proc.join()
        texts = []
        for path in self._paths:
            with open(path, encoding="utf-8", errors="replace") as f:
                texts.append(f.read())
            os.remove(path)
        if timed_out:
            raise subprocess.TimeoutExpired(self._proc.name, timeout, texts[0], texts[1])
        return texts[0], texts[1]


def run(module: str, argv: List[str], timeout_s: float, env: Optional[Dict[str, str]] = None) -> Tuple[int, str, str]:
    """One forked child to its end: ``(returncode, stdout, stderr)``,
    ``-9`` when it was SIGKILLed."""
    child = ForkedChild(module, argv, env)
    out, err = child.communicate(timeout_s)
    return child.returncode, out, err


def stop() -> None:
    """End the fork server, if one runs, and reap it.  A later child
    starts a new one."""
    from multiprocessing import forkserver

    server = forkserver._forkserver  # the module's singleton; Python 3.12 has no public stop
    if server._forkserver_pid is not None:
        server._stop()
