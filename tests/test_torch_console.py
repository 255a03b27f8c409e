"""The port's operator console against the JAX package's, on the CPU.

Twins of ``tests/test_apps.py``'s console and CLI tests,
``tests/test_live_mode.py`` and ``tests/test_selenium_source.py``:

- every command's lines on one seeded session (the same store, the
  deterministic ``fake_sentiment_vectorizer``, fresh journals and metric
  registries in both packages) equal the reference ``CommandConsole``'s,
  except the recorded lines that name the route or the package
  (``claims``' ``impl=``, ``help``'s profiler, ``drain``'s hint).  ``metrics``, ``metrics prom`` and ``metrics trace``
  print process-wide timings and counters, so only their shape is held
  (no ``error:`` line, the usage line equal);
- with a fabric, a serving tier, a durability manager and a drain
  attached, the ``claims``, ``serving``, ``durability`` and ``drain``
  lines equal the reference's, ``costs`` does but for its measured
  times and the route in its keys, and ``slo`` names the same
  objectives (its latency counts are host times);
- ``cli.main`` on a standard-input script, ``--int8`` reaching the
  session, and ``--device`` defaulting to CUDA;
- ``cluster``, ``reconfig`` and ``fleet`` over a two-replica fleet;
- each ``attach`` hook;
- the rest of the scraper (``SeleniumHNSource``, ``run_scraper``,
  ``catch_up_delay_s``) against a faked ``selenium``, and the console's
  ``scraper``/``live_mode`` background loops.

Tolerance: none; the lines are compared as strings.
"""

from __future__ import annotations

import io
import itertools
import re
import sys
import threading
import time
import types

import numpy as np
import pytest

pytest.importorskip("jax")

from conftest import fake_sentiment_vectorizer

import svoc_tpu.apps.session as ref_session_mod
import svoc_tpu.utils.events as ref_events
import svoc_tpu.utils.metrics as ref_metrics
import svoc_tpu.utils.postmortem as ref_postmortem
from svoc_tpu.apps.commands import CommandConsole as RefConsole
from svoc_tpu.apps.session import Session as RefSession
from svoc_tpu.apps.session import SessionConfig as RefConfig
from svoc_tpu.io.comment_store import CommentStore as RefStore
from svoc_tpu.io.scraper import SyntheticSource as RefSource

import svoc_torch.apps.session as session_mod
import svoc_torch.utils.events as events
import svoc_torch.utils.metrics as metrics
import svoc_torch.utils.postmortem as postmortem
from svoc_torch.apps import cli
from svoc_torch.apps.commands import CommandConsole
from svoc_torch.apps.session import Session, SessionConfig
from svoc_torch.io import scraper
from svoc_torch.io.comment_store import CommentStore
from svoc_torch.io.scraper import SyntheticSource

#: Lines that name the route: ``claims``' header and ``help``.
ROUTE_LINES = ("fabric: ", "Commands:")


#: The reference's process-wide tracer as imported, before any test
#: swapped it: what sessions of earlier test files traced into.
REF_PROCESS_TRACER = ref_metrics.tracer


@pytest.fixture
def fresh(monkeypatch):
    """Fresh process journals, metric registries, span tracers and
    lineage scopes in both packages, so that ``events``, ``slo``,
    ``audit``'s span counts, the seqs and the sessions' lineage ids
    start from nothing, whatever sessions the process built before.

    The tracer is also swapped where a module bound it at import time
    (``apps/session.py``'s ``tracer``, ``utils/postmortem.py``'s
    ``_default_tracer``); ``stage_span`` and ``events.audit_record``
    read ``metrics.tracer`` when called."""
    for mod_events, mod_metrics, mod_session, mod_postmortem in (
        (events, metrics, session_mod, postmortem),
        (ref_events, ref_metrics, ref_session_mod, ref_postmortem),
    ):
        reg = mod_metrics.MetricsRegistry()
        tracer = mod_metrics.Tracer(reg)
        monkeypatch.setattr(mod_metrics, "registry", reg)
        monkeypatch.setattr(mod_metrics, "tracer", tracer)
        monkeypatch.setattr(mod_session, "tracer", tracer)
        monkeypatch.setattr(mod_postmortem, "_default_tracer", tracer)
        monkeypatch.setattr(mod_events, "journal", mod_events.EventJournal(registry=reg))
        monkeypatch.setattr(mod_events, "_lineage_scopes", itertools.count(1))


def _pair(n_comments=200, **config):
    store, ref_store = CommentStore(), RefStore()
    store.save(SyntheticSource(batch=n_comments)())
    ref_store.save(RefSource(batch=n_comments)())
    port = CommandConsole(Session(SessionConfig(**config), store=store, vectorizer=fake_sentiment_vectorizer,
                                  journal=events.journal, device="cpu"))
    ref = RefConsole(RefSession(RefConfig(**config), store=ref_store, vectorizer=fake_sentiment_vectorizer,
                                journal=ref_events.journal))
    return port, ref


def _same(port, ref, command):
    ours, theirs = port.query(command), ref.query(command)
    # ``drain``'s hint names the package its GracefulDrain comes from.
    assert [line.replace("svoc_torch.", "svoc_tpu.") for line in ours] == theirs, (command, ours, theirs)
    return ours


SCRIPT = [
    "", "bogus", "dimension", "admin_list", "oracle_list", "replacement_propositions",
    "replacement_menu", "commit", "multimodal", "audit", "contract_declaration_address",
    "contract_address", "is_consensus_active", "resilience",
    "fetch", "multimodal", "multimodal 3", "multimodal 0", "multimodal 8", "multimodal 1 2",
    "multimodal auto", "commit", "resume", "consensus", "reliability_first_pass", "reliability",
    "is_consensus_active", "get_oracle_value_list", "resilience", "audit", "audit blk-none-1",
    "fetch", "commit", "resume", "reliability",
    "update_proposition 0 6 0x99", "replacement_propositions", "update_proposition 0 None",
    "update_proposition 0 6 0x99", "vote_for_a_proposition 0 0 maybe", "vote_for_a_proposition 1 0",
    "update_proposition 99 6 0x99", "update_proposition 0 1 2 3",
    "claims", "serving", "durability", "cluster", "reconfig", "fleet", "costs", "profile", "drain",
    "auto_fetch", "auto_commit on", "auto_commit off", "auto_resume on", "auto_resume off",
    "auto_commit", "auto_resume", "scraper", "live_mode", "events 7", "events 1 2", "events",
    "metrics bogus", "metrics prom trace", "clear",
]


def _slo_shape(lines):
    """``slo``'s objectives, without the counts and burn rates: the
    latency objectives count host dispatch times, which differ between
    the packages (the reference's first dispatch compiles)."""
    return [line.split(":")[0].split(" (objective")[0] for line in lines]


def test_every_command_equals_the_reference(fresh):
    port, ref = _pair()
    for command in SCRIPT:
        _same(port, ref, command)
    # The vote by address reaches the majority and swaps the oracle.
    addr = hex(ref.session.adapter.call_admin_list()[1])
    assert _same(port, ref, f"vote_for_a_proposition {addr} 0 yes") == ["Done."]
    assert port.session.adapter.oracle_index_to_address(6) == 0x99
    for command in ("oracle_list", "replacement_propositions", "get_oracle_value_list 0", "events 12"):
        _same(port, ref, command)
    help_ours, help_theirs = port.query("help"), ref.query("help")
    assert help_ours == [help_theirs[0].replace("jax.profiler", "torch.profiler")]
    # Process-wide timings and counters: the shape only.
    for command in ("metrics", "metrics prom", "metrics trace"):
        lines = port.query(command)
        assert lines and not any(line.startswith("error:") for line in lines), command
    assert any(line.startswith("fetch_") or "fetch" in line for line in port.query("metrics prom"))
    assert _slo_shape(port.query("slo")) == _slo_shape(ref.query("slo"))
    _same(port, ref, "exit")
    assert port.session.application_on is False


def test_audit_ignores_spans_of_earlier_sessions(fresh):
    """Sessions built earlier in the same process left spans under the
    lineage ids that the fresh scopes mint again: ``tests/test_apps.py``
    run before this file fills the reference's tracer alone, so its
    ``audit`` counted more spans than the port's. ``audit`` counts only
    this session's."""
    for name in ("fetch", "vectorize", "consensus", "commit"):
        with REF_PROCESS_TRACER.span(name, lineage="blk1-000001"):
            pass
    port, ref = _pair()
    for command in ("fetch", "commit", "audit", "audit blk1-000001"):
        _same(port, ref, command)
    assert any(line.startswith("  events: ") for line in port.query("audit blk1-000001"))


def test_write_callback_streams():
    lines = []
    store = CommentStore()
    store.save(SyntheticSource(batch=50)())
    c = CommandConsole(Session(store=store, vectorizer=fake_sentiment_vectorizer, device="cpu"),
                       write=lines.append)
    c.query("dimension")
    assert lines == ["Dimension: 6"]


# ---------------------------------------------------------------------------
# With the fabric, the tier and the durability plane attached
# ---------------------------------------------------------------------------


def _attached(pkg, tmp_path):
    """One console with a MultiSession, a ServingTier, a RecoveryManager
    and a GracefulDrain attached, built from ``pkg``'s modules."""
    if pkg == "port":
        from svoc_torch.durability.recovery import GracefulDrain, RecoveryManager
        from svoc_torch.fabric.registry import ClaimSpec
        from svoc_torch.fabric.session import MultiSession
        from svoc_torch.serving.scenario import VirtualClock
        from svoc_torch.serving.tier import ServingTier
        console, _ = _pair()
        Store, Source, EventJournal, Registry = CommentStore, SyntheticSource, events.EventJournal, \
            metrics.MetricsRegistry
        kw = {"device": "cpu"}
    else:
        from svoc_tpu.durability.recovery import GracefulDrain, RecoveryManager
        from svoc_tpu.fabric.registry import ClaimSpec
        from svoc_tpu.fabric.session import MultiSession
        from svoc_tpu.serving.scenario import VirtualClock
        from svoc_tpu.serving.tier import ServingTier
        _, console = _pair()
        Store, Source, EventJournal, Registry = RefStore, RefSource, ref_events.EventJournal, \
            ref_metrics.MetricsRegistry
        kw = {}

    def store_factory(claim_id):
        store = Store()
        store.save(Source(batch=60, seed=len(claim_id))())
        return store

    reg = Registry()
    multi = MultiSession(base_seed=3, vectorizer=fake_sentiment_vectorizer, store_factory=store_factory,
                         journal=EventJournal(registry=reg), metrics=reg, lineage_scope="con",
                         max_claims_per_batch=4, **kw)
    for cid in ("alpha", "beta"):
        multi.add_claim(ClaimSpec(claim_id=cid, n_oracles=7))
    multi.attach(console)
    tier = ServingTier(multi, vectorizer=fake_sentiment_vectorizer, clock=VirtualClock())
    tier.attach(console)
    out_dir = tmp_path / pkg
    out_dir.mkdir()
    manager = RecoveryManager(multi, out_dir=str(out_dir), tier=tier)
    manager.attach(console)
    drain = GracefulDrain(manager=manager, tier=tier)
    drain.attach(console)
    return console, str(out_dir)


def test_attached_planes_equal_the_reference(fresh, tmp_path):
    port, port_dir = _attached("port", tmp_path)
    ref, ref_dir = _attached("ref", tmp_path)
    assert port.fabric.snapshot()["device_resident"] is False

    def same(command):
        ours = [line.replace(port_dir, "<dir>") for line in port.query(command)]
        theirs = [line.replace(ref_dir, "<dir>") for line in ref.query(command)]
        if command == "costs":
            # The ledger's cells carry measured host times and the route.
            ours = [re.sub(r"[0-9.]+ ms", "<ms>", line).replace("|plain|", "|xla|") for line in ours]
            theirs = [re.sub(r"[0-9.]+ ms", "<ms>", line) for line in theirs]
        if ours and ours[0].startswith(ROUTE_LINES):
            assert ours[0].replace("impl=plain", "impl=xla") == theirs[0], command
            ours, theirs = ours[1:], theirs[1:]
        assert ours == theirs, (command, ours, theirs)
        assert not any(line.startswith("error:") for line in ours), command

    for command in ("claims", "serving", "costs", "durability"):
        same(command)
    port.fabric.run(2)
    ref.fabric.run(2)
    for command in ("claims", "serving submit alpha the rollout went great",
                    "serving submit gamma nobody home", "serving submit alpha", "serving step",
                    "serving", "serving bogus", "costs", "claims", "durability snapshot",
                    "durability", "durability bogus", "drain", "drain"):
        same(command)
    assert _slo_shape(port.query("slo")) == _slo_shape(ref.query("slo"))


def test_fleet_planes_equal_the_reference(fresh, tmp_path):
    """``cluster``, ``reconfig`` and ``fleet`` over the reconfiguration
    tests' two-replica fleet (``tests/test_torch_reconfig.py``)."""
    from test_torch_reconfig import PORT, REF, build_fleet

    port, ref = _pair()
    for console, pkg in ((port, PORT), (ref, REF)):
        router, _placement, controller, _metrics = build_fleet(pkg, tmp_path / ("p" if pkg is PORT else "r"))
        router.attach(console)
        router.fleet_plane.attach(console)
        controller.attach(console)
    dirs = (str(tmp_path / "p"), str(tmp_path / "r"))
    for command in ("cluster", "cluster status", "cluster bogus", "cluster migrate c0",
                    "cluster migrate c0 r0", "cluster", "cluster adopt-orphans", "reconfig",
                    "reconfig status", "reconfig abort", "reconfig apply", "reconfig bogus", "fleet"):
        ours = [line.replace(dirs[0], "<dir>") for line in port.query(command)]
        theirs = [line.replace(dirs[1], "<dir>") for line in ref.query(command)]
        assert ours == theirs, (command, ours, theirs)
        assert not any(line.startswith("error:") for line in ours), command


def test_every_attach_hook_sets_its_console_attribute(tmp_path):
    from svoc_torch.obsplane.profiler import ProfileCapture

    console, _ = _attached("port", tmp_path)
    assert console.fabric is not None and console.serving is not None
    assert console.durability is not None and console.drainer is not None
    capture = ProfileCapture(str(tmp_path / "prof"))
    capture.attach(console)
    assert console.profiler is capture
    assert console.query("profile")[0].startswith("active: ")
    assert console.query("profile bogus") == ["usage: profile [start [seconds]|stop|status]"]


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def test_cli_main_on_a_stdin_script(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO("dimension\nbogus\nexit\n"))
    assert cli.main(["--disable_startup_fetch", "--seed-comments", "50", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Dimension: 6" in out and "Unknown command: bogus (try 'help')" in out
    assert "error:" not in out


def test_cli_int8_flag_reaches_the_session_and_device_defaults_to_cuda(monkeypatch):
    built = {}
    real = cli.Session

    def capturing(**kwargs):
        session = real(**kwargs)
        built["config"], built["device"] = session.config, session.device
        return session

    monkeypatch.setattr(cli, "Session", capturing)
    monkeypatch.setattr(sys, "stdin", io.StringIO("exit\n"))
    assert cli.main(["--int8", "--disable_startup_fetch", "--seed-comments", "5", "--device", "cpu"]) == 0
    assert built["config"].quant_inference == "int8" and str(built["device"]) == "cpu"
    assert cli.build_parser().parse_args([]).device == "cuda"
    from svoc_tpu.apps.cli import build_parser as ref_parser

    ours = {a.dest for a in cli.build_parser()._actions}
    assert ours - {a.dest for a in ref_parser()._actions} == {"device"}
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--disable_startup_fetch", "--seed-comments", "5"])


# ---------------------------------------------------------------------------
# The scraper against a faked selenium, and the console's loops
# ---------------------------------------------------------------------------


class FakeElement:
    def __init__(self, text):
        self.text = text

    def get_attribute(self, name):
        assert name == "textContent"
        return self.text


class FlakyElement:
    def get_attribute(self, name):
        raise RuntimeError("stale element")


class FakeDriver:
    instances = []

    def __init__(self, options=None, elements=None):
        self.options = options
        self.elements = elements if elements is not None else [FakeElement(" a "), FakeElement("b")]
        self.urls, self.quit_called = [], False
        FakeDriver.instances.append(self)

    def get(self, url):
        self.urls.append(url)

    def find_elements(self, by, selector):
        assert (by, selector) == ("css selector", scraper.COMMENT_SELECTOR)
        return self.elements

    def quit(self):
        self.quit_called = True


class ScriptedFakeDriver(FakeDriver):
    def execute_script(self, script):
        assert "div.commtext" in script
        return [e.text.strip() for e in self.elements if isinstance(e, FakeElement)]


@pytest.fixture
def fake_selenium(monkeypatch):
    """A ``selenium`` package whose Firefox is :class:`ScriptedFakeDriver`."""
    FakeDriver.instances.clear()

    class Options:
        def __init__(self):
            self.args = []

        def add_argument(self, a):
            self.args.append(a)

    class TimeoutException(Exception):
        pass

    selenium = types.ModuleType("selenium")
    webdriver = types.ModuleType("selenium.webdriver")
    webdriver.Firefox = lambda options=None: ScriptedFakeDriver(options)
    firefox = types.ModuleType("selenium.webdriver.firefox")
    options_mod = types.ModuleType("selenium.webdriver.firefox.options")
    options_mod.Options = Options
    common = types.ModuleType("selenium.common")
    exceptions = types.ModuleType("selenium.common.exceptions")
    exceptions.TimeoutException = TimeoutException
    selenium.webdriver = webdriver
    for name, mod in {"selenium": selenium, "selenium.webdriver": webdriver,
                      "selenium.webdriver.firefox": firefox,
                      "selenium.webdriver.firefox.options": options_mod,
                      "selenium.common": common, "selenium.common.exceptions": exceptions}.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return TimeoutException


def _fault_count(stage):
    return metrics.registry.counter("scrape_faults", labels={"stage": stage}).count


def test_selenium_source_without_selenium_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "selenium", None)
    with pytest.raises(RuntimeError, match="selenium"):
        scraper.SeleniumHNSource()


def test_selenium_source_page_flow_and_options(fake_selenium):
    source = scraper.SeleniumHNSource()
    assert source() == ["a", "b"]
    driver = FakeDriver.instances[-1]
    assert driver.urls == [scraper.HN_URL] and driver.options.args == ["--headless"]
    assert scraper.SeleniumHNSource(headless=False)._driver.options.args == []
    assert fake_selenium in scraper._timeout_types()
    source.close()
    assert driver.quit_called


def test_flaky_posts_timeouts_and_script_failures_degrade_and_count():
    before = _fault_count("post")
    source = scraper.SeleniumHNSource(driver=FakeDriver(elements=[FakeElement("ok"), FlakyElement(),
                                                                  FakeElement("  ")]))
    assert source() == ["ok"] and _fault_count("post") == before + 1
    page = _fault_count("page")
    empty = scraper.SeleniumHNSource(driver=FakeDriver(elements=[]), timeout_s=0.02)
    assert empty() == [] and _fault_count("page") == page + 1

    class BrokenScript(FakeDriver):
        def execute_script(self, script):
            raise RuntimeError("csp")

    assert scraper.SeleniumHNSource(driver=BrokenScript())() == ["a", "b"]
    assert _fault_count("page") == page + 2


def test_run_scraper_rounds_faults_and_catch_up():
    store = CommentStore()
    calls = []

    def source():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("network flap")
        return ["x", "y"]

    before = _fault_count("round")
    sleeps = []
    assert scraper.run_scraper(store, source, rate_s=5, max_rounds=3, sleep=sleeps.append) == 4
    assert _fault_count("round") == before + 1 and store.count() == 4
    # The stored comments' timestamp makes the next start wait out its period.
    assert sleeps[0] == 5 or 0 < sleeps[0] <= 5

    class Plan:
        def fire(self, op):
            assert op == "scrape"
            raise RuntimeError("injected")

    assert scraper.run_scraper(CommentStore(), lambda: ["z"], max_rounds=2, sleep=lambda s: None,
                               fault_plan=Plan()) == 0
    stop = threading.Event()
    stop.set()
    assert scraper.run_scraper(CommentStore(), lambda: ["z"], stop_event=stop) == 0


@pytest.mark.parametrize("stamp,now,want", [
    (None, 100.0, 0.0), ("garbage", 100.0, 0.0),
    ("1970-01-01 00:00:10", 40.0, 570.0), ("1970-01-01 00:00:10", 700.0, 0.0),
    ("1970-01-01 00:10:00", 40.0, 0.0),
])
def test_catch_up_delay_equals_the_reference(stamp, now, want):
    from svoc_tpu.io.scraper import catch_up_delay_s as ref_delay

    assert scraper.catch_up_delay_s(stamp, 600, now=now) == ref_delay(stamp, 600, now=now) == want


def _join_scraper(console, timeout=5.0):
    thread = console._scraper_thread
    if thread is not None:
        thread.join(timeout)


def test_console_scraper_and_live_mode_loops(fake_selenium):
    store = CommentStore()
    session = Session(SessionConfig(scraper_rate_s=0.01, refresh_rate_s=0.01, live_scraper=True),
                      store=store, vectorizer=fake_sentiment_vectorizer, device="cpu")
    console = CommandConsole(session)
    assert console.query("scraper on") == ["Scraper: ENABLED (hn-live)"]
    assert console.query("scraper on") == ["Scraper: ENABLED (already running)"]
    deadline = time.monotonic() + 5
    while store.count() == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert store.count() > 0
    assert console.query("scraper off") == ["Scraper: DISABLED"]
    _join_scraper(console)
    assert FakeDriver.instances[-1].quit_called  # the loop's exit quits the browser
    lines = console.query("live_mode on")
    assert lines == ["Live mode: ENABLED (scraper=hn-live, auto_fetch+auto_commit on)"]
    deadline = time.monotonic() + 10
    while not session.adapter.call_consensus_active() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert session.adapter.call_consensus_active()
    assert console.query("live_mode off") == ["Live mode: DISABLED"]
    console.stop()
    _join_scraper(console)
    assert console.query("auto_fetch off") == ["Auto-Fetch: DISABLED"]


def test_scraper_falls_back_to_synthetic_without_selenium(monkeypatch):
    monkeypatch.setitem(sys.modules, "selenium", None)
    session = Session(SessionConfig(scraper_rate_s=60.0, live_scraper=True), store=CommentStore(),
                      vectorizer=fake_sentiment_vectorizer, device="cpu")
    console = CommandConsole(session)
    assert console.query("scraper on") == ["Scraper: ENABLED (synthetic (selenium unavailable))"]
    console.stop()
    _join_scraper(console)
    assert np.isfinite(session.store.count())
