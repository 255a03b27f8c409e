"""Hacker News comment ingest: the sources and the scrape loop.

Mirrors :mod:`svoc_tpu.io.scraper` (``scraper.py:1-263``):

- :class:`SeleniumHNSource` — the reference's live source over a
  headless Firefox (``client/scraper.py``), import-gated: without the
  ``selenium`` package (or an injected ``driver``) it raises
  ``RuntimeError`` at construction, as the reference's does.  A page
  wait that runs out (:class:`ScrapeTimeout`, or selenium's own) or one
  bad post skips that unit of work and counts ``scrape_faults{stage=}``;
- :class:`SyntheticSource` — HN-comment-shaped texts of 8 to 59 words
  from a fixed vocabulary, drawn with numpy's ``default_rng``, so the
  same seed gives the same texts in both packages (the draws of
  ``rng.choice``, taken as the indices it draws);
- :func:`catch_up_delay_s` and :func:`run_scraper` — the source-agnostic
  loop (``scraper.py:74-94``) with the restart catch-up wait, bounded by
  ``max_rounds``/``stop_event`` and degrading on a failed round.

Nothing here touches the device; a live run needs a browser and the
network, which the tests replace with a faked ``selenium``.
"""

from __future__ import annotations

import datetime as _dt
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

#: Default scrape period in seconds (``scraper.py:21``).
DEFAULT_RATE_S = 600

HN_URL = "https://news.ycombinator.com/newcomments"
#: The DOM selector extracted in-page (``client/hn_scraper.js:3``).
COMMENT_SELECTOR = "div.commtext"


class ScrapeTimeout(RuntimeError):
    """A scrape wait ran out: the portable twin of selenium's
    ``TimeoutException``."""


def _timeout_types() -> tuple:
    """Exception classes that mean "the wait expired": always
    :class:`ScrapeTimeout`, plus selenium's when the package exists."""
    try:
        from selenium.common.exceptions import TimeoutException

        return (ScrapeTimeout, TimeoutException)
    except ImportError:
        return (ScrapeTimeout,)


class SeleniumHNSource:
    """The live HN source with the reference's Selenium behaviour,
    degrading instead of dying: a wait timeout or one bad post skips that
    unit of work, counts ``scrape_faults``, and the scrape goes on.

    ``driver`` injects a ready webdriver (fake drivers in tests, remote
    grids); without it the reference's headless Firefox is built, and the
    selenium import is gated with a clear error."""

    def __init__(self, headless: bool = True, timeout_s: float = 10.0, driver=None):
        if driver is None:
            try:
                from selenium import webdriver
                from selenium.webdriver.firefox.options import Options
            except ImportError as e:
                raise RuntimeError(
                    "SeleniumHNSource needs the 'selenium' package and a "
                    "Firefox driver; use SyntheticSource in offline "
                    "environments"
                ) from e
            options = Options()
            if headless:
                options.add_argument("--headless")
            driver = webdriver.Firefox(options=options)
        self._driver = driver
        self._timeout_s = timeout_s

    #: The reference's in-page extraction (``hn_scraper.js:3-9``): one
    #: driver round trip for the whole page.
    _EXTRACT_SCRIPT = (
        "return Array.from(document.querySelectorAll('div.commtext'))"
        ".map(e => e.textContent.trim());"
    )

    def __call__(self) -> List[str]:
        from svoc_torch.utils.metrics import registry as _metrics

        d = self._driver
        d.get(HN_URL)
        try:
            posts = self._wait_for_posts()
        except _timeout_types():
            # The page stayed empty past the deadline: skip this round.
            _metrics.counter("scrape_faults", labels={"stage": "page"}).add(1)
            return []
        # One in-page script for all posts; a script failure degrades to
        # the per-element loop, which can skip single bad posts.
        script = getattr(d, "execute_script", None)
        if script is not None:
            try:
                return [t for t in script(self._EXTRACT_SCRIPT) if t]
            except Exception:
                _metrics.counter("scrape_faults", labels={"stage": "page"}).add(1)
        out: List[str] = []
        for el in posts:
            try:
                text = self._post_text(el)
            except Exception:
                _metrics.counter("scrape_faults", labels={"stage": "post"}).add(1)
                continue
            if text:
                out.append(text)
        return out

    def _wait_for_posts(self):
        """The reference's ``WebDriverWait(presence_of_element_located)``
        (``client/scraper.py:25-42``) as a portable poll; raises
        :class:`ScrapeTimeout` on expiry."""
        deadline = time.monotonic() + self._timeout_s
        while True:
            # By.CSS_SELECTOR's literal value: no selenium import needed.
            posts = self._driver.find_elements("css selector", COMMENT_SELECTOR)
            if posts:
                return posts
            if time.monotonic() >= deadline:
                raise ScrapeTimeout(f"no {COMMENT_SELECTOR!r} within {self._timeout_s}s")
            time.sleep(min(0.25, max(self._timeout_s / 10.0, 0.01)))

    @staticmethod
    def _post_text(element) -> str:
        return (element.get_attribute("textContent") or "").strip()

    def close(self) -> None:
        self._driver.quit()


class SyntheticSource:
    """Deterministic offline comment batches (HN-comment-shaped text)."""

    _VOCAB = (
        "the a this compiler startup latency throughput rust python jax "
        "tpu actually interesting scale database network kernel cache "
        "memory model vector consensus oracle distributed blockchain "
        "performance benchmark thread async await parse build deploy"
    ).split()

    def __init__(self, batch: int = 30, seed: int = 0):
        self.batch = batch
        self._rng = np.random.default_rng(seed)

    def __call__(self) -> List[str]:
        # rng.choice(vocab, size=k) draws integers(0, len(vocab), size=k):
        # the same draws, without converting the vocabulary to an array
        # and joining numpy strings each comment (about 2.5x the speed).
        words, n = self._VOCAB, len(self._VOCAB)
        out = []
        for _ in range(self.batch):
            k = int(self._rng.integers(8, 60))
            out.append(" ".join([words[i] for i in self._rng.integers(0, n, size=k).tolist()]))
        return out


def catch_up_delay_s(last_timestamp: Optional[str], rate_s: float, now: Optional[float] = None) -> float:
    """Seconds to sleep before the first scrape so that a restart keeps
    the cadence (``scraper.py:78-86``): the rest of the period that began
    at the last stored comment."""
    if not last_timestamp:
        return 0.0
    try:
        parsed = _dt.datetime.fromisoformat(last_timestamp)
    except ValueError:
        return 0.0
    if parsed.tzinfo is None:
        # sqlite's CURRENT_TIMESTAMP is naive UTC.
        parsed = parsed.replace(tzinfo=_dt.timezone.utc)
    last = parsed.timestamp()
    now = time.time() if now is None else now
    elapsed = now - last
    if elapsed < 0 or elapsed >= rate_s:
        return 0.0
    return rate_s - elapsed


def run_scraper(
    store,
    source: Callable[[], Sequence[str]],
    rate_s: float = DEFAULT_RATE_S,
    max_rounds: Optional[int] = None,
    stop_event: Optional[threading.Event] = None,
    sleep: Callable[[float], None] = time.sleep,
    fault_plan=None,
) -> int:
    """The scrape loop (``scraper.py:188-263``); returns the comments
    stored in ``store`` (a :class:`~svoc_torch.io.comment_store.CommentStore`).
    ``max_rounds``/``stop_event`` bound it.  A failed round (a source
    error, or ``fault_plan.fire("scrape")`` raising) counts one
    ``scrape_faults{stage="round"}`` and the loop sleeps on."""
    from svoc_torch.utils.metrics import registry as _metrics
    from svoc_torch.utils.metrics import stage_span

    total = 0
    delay = catch_up_delay_s(store.last_timestamp(), rate_s)
    if delay:
        sleep(delay)
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        if stop_event is not None and stop_event.is_set():
            break
        with stage_span("scrape"):
            try:
                if fault_plan is not None:
                    fault_plan.fire("scrape")
                batch = source()
            except Exception:
                _metrics.counter("scrape_faults", labels={"stage": "round"}).add(1)
                batch = ()
            if batch:
                total += store.save(batch)
        rounds += 1
        if max_rounds is not None and rounds >= max_rounds:
            break
        sleep(rate_s)
    return total
