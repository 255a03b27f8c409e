"""The operator console: the textual command API.

Mirrors :mod:`svoc_tpu.apps.commands` (``commands.py:1-1304``):
:class:`CommandConsole` with the whole command language dispatched at
``commands.py:230-1113``, the background loops (``_start_auto_fetch``
with its generation token, the scraper thread with its claim → build →
commit start and ``discard``) and :meth:`CommandConsole.stop`.  Every
command returns the console lines it produced (and streams them through
an optional ``write`` callback), so one dispatcher serves the CLI
(:mod:`svoc_torch.apps.cli`), the web UI (:mod:`svoc_torch.apps.web`)
and the tests.

Each command's lines are the reference's on the same seeded session,
with three recorded differences that name the route or the package
(ROADMAP §C):

- ``claims`` prints ``impl=cuda`` or ``impl=plain`` (the router's
  route, which its device decides) where the reference prints ``xla``
  or ``pallas``;
- ``help`` names ``torch.profiler`` where the reference names
  ``jax.profiler`` (the ``profile`` command's capture,
  :class:`svoc_torch.obsplane.profiler.ProfileCapture`);
- ``drain`` without a handler points at ``svoc_torch.durability``
  where the reference points at ``svoc_tpu.durability``.

``multimodal`` runs the mixture fit on the session's device.  Nothing
here launches a kernel itself: the session, the fabric and the tier it
reads do.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, List, Optional

from svoc_torch.apps.session import Session
from svoc_torch.io.chain import ChainCommitError, to_hex


def _addr_str(addr) -> str:
    """Hex for felt ints, verbatim for symbolic sim addresses."""
    return to_hex(addr) if isinstance(addr, int) else str(addr)

HELP = """Commands:
    - help / clear / exit

    - fetch
    - auto_fetch on/off (default: off)
    - auto_commit on/off (default: off, ie. fetch => commit)
    - auto_resume on/off (default: off, ie. commit => resume)
    - scraper on/off (default: off)
    - live_mode on/off (default: off; scraper + auto_fetch + auto_commit)
    - metrics [prom|trace] (throughput / latency / stage percentiles;
      'prom' dumps the Prometheus text exposition the /metrics
      endpoint serves; 'trace' lists the most recent stage spans)
    - resilience (circuit-breaker state, per-slot oracle health
      scores, quarantine set, replacement count)
    - events [N] (the flight recorder's newest N journal events;
      default 10)
    - audit [lineage] (per-block audit record — events, spans, and a
      summary joined on one lineage id; default: the last fetch)
    - slo (declarative objectives as fast/slow burn rates; with a
      fabric/serving tier attached, per-claim and serving-tier burn
      rates follow the session's)
    - claims (multi-claim fabric status: per-claim cycles, consensus
      validity, replacements, lineage — docs/FABRIC.md)
    - serving [submit <claim> <text...> | step] (continuous-batching
      serving tier status / one manual request / one manual cycle —
      docs/SERVING.md)
    - durability [snapshot] (crash-consistency status: snapshot
      freshness, commit-intent WAL health, open cycles; 'snapshot'
      forces one — docs/RESILIENCE.md)
    - costs (shape-keyed dispatch-cost ledger: warm/cold EMA seconds
      per compile key + per-stage request latency decomposition —
      docs/OBSERVABILITY.md §cost-attribution)
    - profile [start [seconds]|stop|status] (on-demand torch.profiler
      capture, bounded duration; default: status)
    - cluster [status | migrate <claim> <replica> | adopt-orphans]
      (multi-replica fleet: placement map + epoch, per-replica
      health/breakers, one operator migration, or re-adoption of
      quarantined migration slices — docs/CLUSTER.md)
    - reconfig [status | apply <plan.json> | abort] (live
      reconfiguration plane: transactional drain → re-pin →
      recover-warm under traffic — docs/RECONFIG.md)
    - fleet (fleet observability plane: hop-chain count, per-source
      observation accounting, fleet SLO alerts, recent anomalies,
      postmortem bundles — docs/OBSERVABILITY.md §fleet-plane)
    - drain (graceful teardown: stop admission, flush queues,
      snapshot, postmortem bundle — what SIGTERM does)
    - multimodal [K|auto] (mixture analysis of the last fetch;
      default K=2, 'auto' selects K by BIC)

    - contract_declaration_address
    - contract_address

    - (S) commit (send update_prediction for each oracle)

    - (S) resume
    - (S) consensus
    - (S) reliability_first_pass
    - (S) reliability

    - (S) is_consensus_active

    - (S) admin_list
    - (S) oracle_list
    - (S) dimension
    - (S) replacement_menu
    - (S) replacement_propositions

    - (S) update_proposition <caller_admin> None
    - (S) update_proposition <caller_admin> <old_oracle> <new_oracle>
    - (S) vote_for_a_proposition <caller_admin> <which_admin> yes/no

For <admin> <oracle> arguments, specify either the contract index or
the address starting with "0x".

(S) indicates a chain interaction (local simulator or Sepolia).
"""


def on_off_to_bool(x: str) -> bool:
    return x == "on"


class CommandConsole:
    """Stateful command dispatcher over a :class:`Session`."""

    def __init__(
        self,
        session: Optional[Session] = None,
        write: Optional[Callable[[str], None]] = None,
    ):
        self.session = session or Session()
        self._write = write
        #: Multi-claim fabric (docs/FABRIC.md): set by
        #: ``MultiSession.attach`` — the ``claims`` command and
        #: ``/api/state``'s ``claims`` section read it.  None = the
        #: single-claim console of PRs 1–5, unchanged.
        self.fabric = None
        #: Continuous-batching serving tier (docs/SERVING.md): set by
        #: ``ServingTier.attach`` — the ``serving`` command,
        #: ``POST /api/submit``, and ``/api/state``'s ``serving``
        #: section read it.  None = no request path (batch-only).
        self.serving = None
        #: Durability layer (docs/RESILIENCE.md §durability): set by
        #: ``RecoveryManager.attach`` / ``GracefulDrain.attach`` — the
        #: ``durability``/``drain`` commands and ``/api/state``'s
        #: durability section read them.  None = in-memory-only.
        self.durability = None
        self.drainer = None
        #: On-demand profiler (docs/OBSERVABILITY.md
        #: §cost-attribution): set by ``ProfileCapture.attach`` — the
        #: ``profile`` command and ``GET /api/profile`` read it.
        self.profiler = None
        #: Multi-replica fleet router (docs/CLUSTER.md): set by
        #: ``ClusterRouter.attach`` — the ``cluster`` command and
        #: ``/api/state``'s cluster section read it.  None = the
        #: single-replica deployments of PRs 1–17, unchanged.
        self.cluster = None
        #: Live reconfiguration plane (docs/RECONFIG.md): set by
        #: ``ReconfigController.attach`` — the ``reconfig`` command and
        #: ``/api/state``'s reconfig section read it.  None = no
        #: transactional re-pin path (static fleet config).
        self.reconfig = None
        #: Fleet observability plane (docs/OBSERVABILITY.md
        #: §fleet-plane): set by ``FleetPlane.attach`` — the ``fleet``
        #: command, ``GET /metrics/fleet``, and ``/api/state``'s
        #: fleet-obs section read it.  None = no fleet plane wired.
        self.fleetplane = None
        self._auto_fetch_thread: Optional[threading.Thread] = None
        self._scraper_stop: Optional[threading.Event] = None
        self._scraper_thread: Optional[threading.Thread] = None
        #: Serializes background-loop lifecycle (auto_fetch generation
        #: token, scraper thread handles): query() is deliberately
        #: unserialized, so racing 'auto_fetch on' / 'scraper on'
        #: commands would otherwise both pass the check-then-act and
        #: leave two loops running.
        self._bg_lock = threading.Lock()

    # -- address/index parsing (web_interface.py:71-107) -------------------

    def _make_oracle_index(self, token: str) -> int:
        if token.upper().startswith("0X"):
            return self.session.adapter.address_to_oracle_index(int(token, 16))
        return int(token)

    def _make_admin_address(self, token: str):
        if token.upper().startswith("0X"):
            return int(token, 16)
        return self.session.adapter.admin_index_to_address(int(token))

    def _make_admin_index(self, token: str) -> int:
        if token.upper().startswith("0X"):
            return self.session.adapter.address_to_admin_index(int(token, 16))
        return int(token)

    def _propositions_as_str(self, only_not_none: bool = False) -> List[str]:
        lines = []
        for index, prop in enumerate(
            self.session.adapter.call_replacement_propositions()
        ):
            if prop is None:
                if not only_not_none:
                    lines.append(f"- Admin {index} : None")
            else:
                lines.append(f"- Admin {index} :")
                lines.append(f"  - {prop[0]} -> {hex(prop[1])}")
        return lines

    # -- dispatcher (web_interface.py:133-303) ------------------------------

    def query(self, text: str) -> List[str]:
        """Dispatch one command.

        Deliberately NOT serialized here: the web UI's
        ThreadingHTTPServer handlers, the stdin console, and the
        auto_fetch loop share one session, and holding a dispatch-wide
        lock would freeze all of them behind a slow chain RPC or the
        first fetch's model build.  Safety is layered below instead —
        session field mutation under ``session.lock``, whole-fleet
        commits under the commit lock, each chain read/tx atomic under
        the adapter lock (tx-granular interleaving beyond that matches
        the real chain), and the vectorizer build double-checked
        (``Session`` docstring)."""
        out: List[str] = []

        def emit(line: str) -> None:
            out.append(line)
            if self._write:
                self._write(line)

        parts = text.split()
        if not parts:
            return out
        cmd, args = parts[0], parts[1:]
        adapter = self.session.adapter

        try:
            if cmd == "help":
                emit(HELP)
            elif cmd == "clear":
                emit("\x1b[clear]")
            elif cmd == "exit":
                self.stop()
                self.session.application_on = False
            elif cmd == "fetch":
                emit("Processing ..")
                preview = self.session.fetch()
                emit(
                    f"fetched {preview['n_comments']} comments -> "
                    f"{self.session.config.n_oracles} oracle predictions"
                )
                emit(
                    "mean   : "
                    + ", ".join(f"{x:0.3f}" for x in preview["mean"])
                )
                emit(
                    "median : "
                    + ", ".join(f"{x:0.3f}" for x in preview["median"])
                )
                suspects = [
                    str(i)
                    for i, r in enumerate(preview["normalized_ranks"])
                    if r <= 0.2  # the UI's red threshold (simulation_graphics.js:97-99)
                ]
                emit("suspected failing oracles : " + ", ".join(suspects))
            elif cmd == "auto_fetch":
                if len(args) != 1:
                    emit("Unexpected number of arguments.")
                    return out
                # set_auto_flags bumps state_version: the web UI's push
                # stream surfaces flag toggles live, not on next fetch.
                self.session.set_auto_flags(fetch=on_off_to_bool(args[0]))
                if self.session.auto_fetch:
                    emit("Auto-Fetch: ENABLED")
                    self._start_auto_fetch()
                else:
                    emit("Auto-Fetch: DISABLED")
            elif cmd == "auto_commit":
                if len(args) != 1:
                    emit("Unexpected number of arguments.")
                    return out
                self.session.set_auto_flags(commit=on_off_to_bool(args[0]))
                emit(
                    "Auto-Commit: "
                    + ("ENABLED" if self.session.auto_commit else "DISABLED")
                )
            elif cmd == "auto_resume":
                if len(args) != 1:
                    emit("Unexpected number of arguments.")
                    return out
                self.session.set_auto_flags(resume=on_off_to_bool(args[0]))
                emit(
                    "Auto-Resume: "
                    + ("ENABLED" if self.session.auto_resume else "DISABLED")
                )
            elif cmd == "commit":
                if self.session.predictions is None:
                    emit("Fetch before!")
                else:
                    emit("Commit predictions...")
                    try:
                        n = self.session.commit()
                        emit(f"Done ({n} transactions).")
                    except ChainCommitError as e:
                        # Partial commits are ON CHAIN — say exactly how
                        # far the loop got and what broke it.
                        emit(
                            f"Commit FAILED after {e.committed}/{e.total} "
                            f"transactions at oracle "
                            f"{_addr_str(e.failed_oracle)}: {e.cause}"
                        )
            elif cmd == "consensus":
                consensus = adapter.call_consensus()
                emit("consensus :\n" + ",".join(f"{x:0.2f}" for x in consensus))
            elif cmd == "reliability_first_pass":
                emit(
                    "reliability_first_pass : "
                    f"{adapter.call_first_pass_consensus_reliability()}"
                )
            elif cmd == "reliability":
                emit(
                    "reliability : "
                    f"{adapter.call_second_pass_consensus_reliability()}"
                )
                trend = adapter.rel2_trend()
                if trend["n"] >= 2:
                    emit(
                        f"trend ({trend['n']} samples): "
                        f"{trend['delta']:+.3f}"
                        + (
                            "  ⚠ falling — a coordinated-bias approach "
                            "shows as a rel₂ slide (ALGORITHM.md §5)"
                            if trend["falling"]
                            else ""
                        )
                    )
            elif cmd == "resume":
                state = adapter.resume()
                self.session.bump_state()
                emit(f"consensus_active: {state['consensus_active']}")
                emit(
                    "consensus : "
                    + ", ".join(f"{x:0.2f}" for x in state["consensus"])
                )
                emit(
                    "reliability_first_pass : "
                    f"{state['reliability_first_pass']:0.3f}"
                )
                emit(
                    "reliability_second_pass : "
                    f"{state['reliability_second_pass']:0.3f}"
                )
                emit(
                    "skewness : "
                    + ", ".join(f"{x:0.2f}" for x in state["skewness"])
                )
                emit(
                    "kurtosis : "
                    + ", ".join(f"{x:0.2f}" for x in state["kurtosis"])
                )
            elif cmd == "is_consensus_active":
                emit(f"Is consensus active: {adapter.call_consensus_active()}")
            elif cmd == "admin_list":
                emit("[Admin list]")
                for idx, admin in enumerate(adapter.call_admin_list()):
                    emit(f"Admin {idx} : {admin}")
            elif cmd == "oracle_list":
                emit("[Oracle list]")
                for idx, oracle in enumerate(adapter.call_oracle_list()):
                    emit(f"Oracle {idx} : {oracle}")
            elif cmd == "dimension":
                emit(f"Dimension: {adapter.call_dimension()}")
            elif cmd in ("replacement_propositions", "replacement_menu"):
                emit("Replacement propositions :")
                for line in self._propositions_as_str():
                    emit(line)
            elif cmd == "update_proposition":
                caller = self._make_admin_address(args[0])
                if len(args) == 2 and args[1] == "None":
                    adapter.invoke_update_proposition(caller)
                    emit("Done.")
                elif len(args) == 3:
                    old_oracle = self._make_oracle_index(args[1])
                    # New address: 0x-hex or decimal, like every other
                    # address argument (help text contract).
                    new_oracle = (
                        int(args[2], 16)
                        if args[2].upper().startswith("0X")
                        else int(args[2])
                    )
                    adapter.invoke_update_proposition(
                        caller, old_oracle, new_oracle
                    )
                    emit("Done.")
                else:
                    emit("Unexpected number of arguments.")
            elif cmd == "vote_for_a_proposition":
                if len(args) != 3:
                    emit("Unexpected number of arguments.")
                    return out
                if args[2].upper() == "YES":
                    value = True
                elif args[2].upper() == "NO":
                    value = False
                else:
                    emit("Invalid command: only yes/no accepted")
                    return out
                caller = self._make_admin_address(args[0])
                which = self._make_admin_index(args[1])
                adapter.invoke_vote_for_a_proposition(caller, which, value)
                emit("Done.")
            elif cmd == "get_oracle_value_list":
                caller = self._make_admin_address(args[0]) if args else (
                    adapter.call_admin_list()[0]
                )
                from svoc_torch.ops.fixedpoint import wsad_to_string

                for addr, vec, enabled, reliable in (
                    adapter.call_oracle_value_list_wsad(caller)
                ):
                    # wsad_to_string rendering (utils.cairo:283-297) —
                    # truncated 3-digit decimals of the EXACT stored
                    # wsad ints (a float round trip can lose an ulp and
                    # print a wrong digit).
                    values = ", ".join(
                        wsad_to_string(v, 3) for v in vec
                    )
                    emit(
                        f"{_addr_str(addr)} : [{values}] "
                        f"enabled={enabled} reliable={reliable}"
                    )
            elif cmd == "contract_declaration_address":
                emit(
                    "Contract Declaration Address :\n"
                    f"{self.session.config.declared_address}"
                )
            elif cmd == "contract_address":
                emit(
                    f"Contract Address :\n{self.session.config.deployed_address}"
                )
            elif cmd == "scraper":
                if len(args) != 1:
                    emit("Unexpected number of arguments.")
                    return out
                if on_off_to_bool(args[0]):
                    source_name = self._start_scraper()
                    if source_name is None:
                        emit("Scraper: not started (superseded or stopped)")
                    else:
                        emit(f"Scraper: ENABLED ({source_name})")
                else:
                    self._stop_scraper()
                    emit("Scraper: DISABLED")
            elif cmd == "metrics":
                from svoc_torch.utils.metrics import (
                    registry as _metrics,
                    sample_runtime_gauges,
                    tracer as _tracer,
                )

                if len(args) > 1 or (args and args[0] not in ("prom", "trace")):
                    emit("Usage: metrics [prom|trace]")
                    return out
                # Same on-demand device/runtime gauge sample as the
                # /metrics endpoint — console and scrape agree.
                sample_runtime_gauges(_metrics)
                if args and args[0] == "prom":
                    for line in _metrics.render_prometheus().splitlines():
                        emit(line)
                elif args and args[0] == "trace":
                    spans = _tracer.recent(20)
                    if not spans:
                        emit("no spans recorded yet")
                    for s in spans:
                        emit(
                            f"{'  ' * s.depth}{s.name}: "
                            f"{s.duration_s * 1e3:.2f}ms "
                            f"[{s.thread}]"
                        )
                else:
                    lines = _metrics.report()
                    for line in lines or ["no metrics recorded yet"]:
                        emit(line)
            elif cmd == "resilience":
                snap = self.session.resilience_snapshot()
                emit(f"breaker: {snap['breaker']}")
                health = snap["health"]
                if health:
                    emit("oracle health (slot: score):")
                    for slot in sorted(health, key=int):
                        flag = (
                            "  QUARANTINED"
                            if int(slot) in snap["quarantined"]
                            else ""
                        )
                        emit(f"  {slot}: {health[slot]:.3f}{flag}")
                else:
                    emit("no health scores yet (no supervised commits)")
                emit(f"replacements: {snap['replacements']}")
                quarantine = snap.get("input_quarantine")
                if quarantine is None:
                    emit("input quarantine: no gated fetch yet")
                elif not quarantine["quarantined"]:
                    emit(
                        "input quarantine: clean "
                        f"({quarantine['admitted']}/{quarantine['total']} "
                        "admitted)"
                    )
                else:
                    emit(
                        "input quarantine: "
                        + ", ".join(
                            f"slot {q['slot']} ({q['reason']})"
                            for q in quarantine["quarantined"]
                        )
                    )
            elif cmd == "events":
                from svoc_torch.utils.events import journal as _journal

                if len(args) > 1:
                    emit("Usage: events [N]")
                    return out
                n = int(args[0]) if args else 10
                records = _journal.recent(n)
                if not records:
                    emit("no events recorded yet")
                for rec in records:
                    data = " ".join(
                        f"{k}={v}" for k, v in sorted(rec.data.items())
                    )
                    emit(
                        f"#{rec.seq} {rec.type}"
                        + (f" [{rec.lineage}]" if rec.lineage else "")
                        + (f" {data}" if data else "")
                    )
            elif cmd == "audit":
                if len(args) > 1:
                    emit("Usage: audit [lineage]")
                    return out
                record = self.session.audit(args[0] if args else None)
                if not record.get("found"):
                    emit(
                        "no audit record"
                        + (
                            f" for {record['lineage']}"
                            if record.get("lineage")
                            else " — run 'fetch' first"
                        )
                    )
                    return out
                emit(f"audit {record['lineage']}:")
                s = record["summary"]
                quarantined = s.get("quarantined") or {}
                emit(
                    f"  quarantined: {len(quarantined)}"
                    + (
                        " ("
                        + ", ".join(
                            f"slot {slot}: {reason}"
                            for slot, reason in sorted(quarantined.items())
                        )
                        + ")"
                        if quarantined
                        else ""
                    )
                )
                emit(
                    f"  commit: sent={s.get('commit_sent', 0)}"
                    f" skipped={s.get('commit_skipped', 0)}"
                    f" retries={s.get('commit_retries', 0)}"
                    f" failures={len(s.get('commit_failures') or [])}"
                )
                if s.get("charged"):
                    emit("  charged: " + ", ".join(s["charged"]))
                for rep in s.get("replacements") or []:
                    emit(
                        f"  replaced slot {rep.get('slot')}: "
                        f"{rep.get('old')} -> {rep.get('new')}"
                    )
                breaker_line = (
                    " -> ".join(s["breaker_transitions"])
                    if s.get("breaker_transitions")
                    else "stayed " + self.session.breaker.state()
                )
                emit(f"  breaker: {breaker_line}")
                emit(
                    f"  events: {len(record['events'])}, "
                    f"spans: {len(record['spans'])}"
                )
            elif cmd == "claims":
                # Multi-claim fabric status (docs/FABRIC.md): one line
                # per claim — cycle count, last consensus validity, the
                # claim's own replacement/quarantine accounting, and
                # its latest block lineage.
                if self.fabric is None:
                    emit(
                        "no claim fabric attached — this console serves "
                        "a single-claim session"
                    )
                    return out
                snapshot = self.fabric.snapshot()
                emit(
                    f"fabric: {snapshot['n_claims']} claims, "
                    f"{snapshot['steps']} steps, "
                    f"impl={snapshot['consensus_impl']}, "
                    f"mesh={snapshot.get('mesh') or 'none'}"
                    + (" pipelined" if snapshot.get("pipelined") else "")
                )
                for claim_id in sorted(snapshot["claims"]):
                    c = snapshot["claims"][claim_id]
                    consensus = c.get("consensus") or {}
                    valid = consensus.get("interval_valid")
                    emit(
                        f"  {claim_id}: cycles={c['cycles']}"
                        + (" PAUSED" if c.get("paused") else "")
                        + f" valid={'-' if valid is None else valid}"
                        + f" admitted={consensus.get('admitted', '-')}"
                        + f" replacements={c.get('replacements', 0)}"
                        + (
                            f" quarantined={c['quarantined']}"
                            if c.get("quarantined")
                            else ""
                        )
                        + (f" block={c['lineage']}" if c.get("lineage") else "")
                    )
            elif cmd == "serving":
                # Continuous-batching serving tier (docs/SERVING.md):
                # status, one manual submit, or one manual cycle.
                if self.serving is None:
                    emit(
                        "no serving tier attached — this console serves "
                        "batch/pull mode only"
                    )
                    return out
                if args and args[0] == "submit":
                    if len(args) < 3:
                        emit("usage: serving submit <claim> <text...>")
                        return out
                    try:
                        response = self.serving.submit(
                            args[1], " ".join(args[2:])
                        )
                    except KeyError:
                        emit(f"unknown claim '{args[1]}'")
                        return out
                    emit(
                        f"{response['status']}: {response['request_id']}"
                        + (
                            f" ({response['reason']})"
                            if response["status"] == "shed"
                            else ""
                        )
                        + f" lineage={response['lineage']}"
                    )
                elif args and args[0] == "step":
                    report = self.serving.step()
                    emit(
                        f"step {report['step']}: {report['requests']} "
                        f"requests over {report['claims']} claims, "
                        f"served {len(report['served'])}"
                    )
                elif args:
                    emit("usage: serving [submit <claim> <text...> | step]")
                else:
                    snap = self.serving.snapshot()
                    emit(
                        f"serving: {snap['steps']} steps, "
                        f"submitted={snap['submitted']:g} "
                        f"admitted={snap['admitted']:g} "
                        f"cached={snap['cached']:g} "
                        f"shed={snap['shed']:g} "
                        f"completed={snap['completed']:g}"
                    )
                    cache = snap["cache"]
                    emit(
                        f"  cache: {cache['size']}/{cache['capacity']} "
                        f"entries, hit rate {cache['hit_rate']:.1%} "
                        f"({cache['hits']:g} hits, "
                        f"{cache['evictions']:g} evictions)"
                    )
                    acfg = self.serving.frontend.controller.config
                    emit(
                        f"  burn rate: {snap['burn_rate']:.2f}x "
                        f"({acfg.burn_slo} {acfg.burn_window} window)"
                    )
                    latency = snap["latency"]
                    if latency.get("count"):
                        emit(
                            f"  latency: p50 {latency['p50'] * 1e3:.1f} ms, "
                            f"p99 {latency['p99'] * 1e3:.1f} ms "
                            f"over {latency['count']:g} requests"
                        )
                    queues = snap["queues"]
                    if any(queues.values()):
                        emit(
                            "  queues: "
                            + ", ".join(
                                f"{cid}={depth}"
                                for cid, depth in sorted(queues.items())
                                if depth
                            )
                        )
            elif cmd == "durability":
                # Crash-consistency status (docs/RESILIENCE.md
                # §durability): snapshot freshness + WAL health.
                if self.durability is None:
                    emit(
                        "no durability layer attached — this session's "
                        "state is in-memory only (chain writes are still "
                        "exact within the process lifetime)"
                    )
                    return out
                if args and args[0] == "snapshot":
                    path = self.durability.snapshot()
                    emit(f"snapshot written: {path}")
                    return out
                if args:
                    emit("usage: durability [snapshot]")
                    return out
                status = self.durability.status()
                emit(
                    f"snapshot: {status['snapshot_path']}"
                    + (
                        ""
                        if status["snapshot_exists"]
                        else " (none yet)"
                    )
                    + f", {status['snapshots_this_process']} this process"
                )
                emit(
                    f"wal: {status['wal_path'] or '(none)'}, "
                    f"{status['wal_records']} records, "
                    f"{len(status['wal_open_cycles'])} open cycles"
                )
                for lin in status["wal_open_cycles"]:
                    emit(f"  OPEN {lin} — a commit is in flight (or a "
                         "crash awaits reconciliation)")
            elif cmd == "cluster":
                # Multi-replica fleet status / operator migration
                # (docs/CLUSTER.md).
                if self.cluster is None:
                    emit(
                        "no cluster attached — this is a single-replica "
                        "deployment (wire a ClusterRouter and "
                        "attach(console) — docs/CLUSTER.md)"
                    )
                    return out
                sub = args[0] if args else "status"
                if sub == "migrate":
                    if len(args) != 3:
                        emit("usage: cluster migrate <claim> <replica>")
                        return out
                    report = self.cluster.migrate(
                        args[1], args[2], reason="operator"
                    )
                    emit(
                        f"migrated {args[1]} -> {args[2]} "
                        f"(epoch {report['epoch']}, cursor "
                        f"{report['cursor']}, continuity "
                        f"{'ok' if report['continuity'] else 'BROKEN'})"
                    )
                    return out
                if sub == "adopt-orphans":
                    report = self.cluster.adopt_orphans()
                    for cid, info in sorted(report["adopted"].items()):
                        emit(
                            f"adopted {cid} -> {info['replica']} "
                            f"(cursor {info['cursor']}, continuity "
                            f"{'ok' if info['continuity'] else 'BROKEN'})"
                        )
                    for cid, reason in sorted(report["remaining"].items()):
                        emit(f"  still orphaned {cid}: {reason}")
                    if not report["adopted"] and not report["remaining"]:
                        emit("no orphaned claims")
                    return out
                if sub != "status":
                    emit(
                        "usage: cluster [status | migrate <claim> "
                        "<replica> | adopt-orphans]"
                    )
                    return out
                snap = self.cluster.snapshot()
                emit(
                    f"cluster: epoch {snap['epoch']}, "
                    f"{len(snap['replicas'])} replica(s), "
                    f"{len(snap['claims'])} claim(s)"
                    + (
                        f", retired: {', '.join(snap['retired'])}"
                        if snap["retired"]
                        else ""
                    )
                )
                for rid, rep in sorted(snap["replicas"].items()):
                    requests = rep.get("requests", {})
                    owned = sorted(
                        cid
                        for cid, owner in snap["claims"].items()
                        if owner == rid
                    )
                    emit(
                        f"  {rid}: "
                        f"{'alive' if rep.get('alive') else 'DEAD'}, "
                        f"breaker {rep.get('breaker', '?')}, "
                        f"claims [{', '.join(owned)}], "
                        f"completed {requests.get('completed', 0):.0f}"
                    )
            elif cmd == "reconfig":
                # Live reconfiguration plane (docs/RECONFIG.md):
                # transactional drain → re-pin → recover-warm.
                if self.reconfig is None:
                    emit(
                        "no reconfiguration plane attached — wire a "
                        "ReconfigController and attach(console) "
                        "(docs/RECONFIG.md)"
                    )
                    return out
                sub = args[0] if args else "status"
                if sub == "apply":
                    if len(args) != 2:
                        emit("usage: reconfig apply <plan.json>")
                        return out
                    from svoc_torch.cluster.reconfig import ReconfigPlan

                    with open(args[1]) as f:
                        plan = ReconfigPlan.from_dict(json.load(f))
                    report = self.reconfig.apply(plan)
                    if report["status"] == "committed":
                        emit(
                            f"committed epoch {report['epoch']} "
                            f"(plan {report['plan_fingerprint'][:16]}, "
                            f"{len(report['replicas'])} replica(s) "
                            f"re-pinned, {report['deferred_released']} "
                            "deferred request(s) released)"
                        )
                    elif report["status"] == "noop":
                        emit("plan is a no-op — nothing to change")
                    else:
                        emit(
                            f"ABORTED in {report['phase']} "
                            f"({report['cause']}) — fleet rolled back "
                            "to the pre-plan state"
                        )
                    return out
                if sub == "abort":
                    report = self.reconfig.request_abort()
                    emit(
                        f"{report['status']}"
                        + (
                            f" (phase {report['phase']})"
                            if "phase" in report
                            else f": {report.get('detail', '')}"
                        )
                    )
                    return out
                if sub != "status":
                    emit("usage: reconfig [status | apply <plan.json> | abort]")
                    return out
                status = self.reconfig.status()
                emit(
                    f"reconfig: phase {status['phase']}, "
                    f"epoch {status['epoch']}, "
                    f"holding {len(status['holding'])} replica(s), "
                    f"{status['deferred']} deferred request(s)"
                )
                for entry in status["chain"]:
                    emit(
                        f"  epoch {entry['epoch']}: plan "
                        f"{entry['plan'][:16]} over {entry['pre_fleet'][:16]}"
                    )
            elif cmd == "fleet":
                # Fleet observability plane (docs/OBSERVABILITY.md
                # §fleet-plane): merged telemetry + hop chains +
                # anomaly state.
                if self.fleetplane is None:
                    emit(
                        "no fleet plane attached — wire a FleetPlane "
                        "and attach(console) (docs/OBSERVABILITY.md "
                        "§fleet-plane)"
                    )
                    return out
                snap = self.fleetplane.snapshot()
                if not snap["enabled"]:
                    emit(
                        "fleet plane DISABLED (SVOC_FLEET_PLANE / "
                        "PERF_DECISIONS.json fleet_plane — resolved at "
                        "construction, SVOC011)"
                    )
                    return out
                emit(
                    f"fleet plane: step {snap['step']}, "
                    f"{len(snap['sources'])} source(s) "
                    f"[{', '.join(snap['sources'])}], "
                    f"{snap['chains']} hop chain(s)"
                    + (
                        f", retired: {', '.join(snap['retired'])}"
                        if snap["retired"]
                        else ""
                    )
                )
                for sid, acct in sorted(snap["observations"].items()):
                    emit(
                        f"  {sid}: {acct['records']} obs record(s), "
                        f"last seq {acct['last_seq']}, "
                        f"dropped {acct['dropped']}"
                    )
                alerting = snap["slo"]["alerting"]
                emit(
                    "fleet SLOs: "
                    + (
                        "ALERTING " + ", ".join(alerting)
                        if alerting
                        else "quiet"
                    )
                )
                anomaly = snap.get("anomaly") or {}
                emit(
                    f"anomaly: {anomaly.get('series', 0)} series, "
                    f"{anomaly.get('alerts_total', 0)} alert(s)"
                )
                for a in snap["recent_anomalies"]:
                    emit(
                        f"  step {a['step']} {a['source']}/{a['family']}: "
                        f"delta {a['delta']:g} ({a['trigger']}, "
                        f"z={a['z']:.1f}, streak {a['streak']}"
                        + (", SUSTAINED)" if a["sustained"] else ")")
                    )
                for path in snap["bundles"]:
                    emit(f"  bundle: {path}")
            elif cmd == "costs":
                # Shape-keyed dispatch-cost ledger
                # (docs/OBSERVABILITY.md §cost-attribution).
                plane = getattr(self.serving, "cost_plane", None) \
                    if self.serving is not None else None
                if plane is None:
                    emit(
                        "no cost plane attached — wire a ServingTier "
                        "(docs/OBSERVABILITY.md §cost-attribution)"
                    )
                    return out
                snap = plane.snapshot()
                ledger = snap["ledger"]
                emit(
                    f"cost plane: "
                    f"{'enabled' if snap['enabled'] else 'DISABLED'} — "
                    f"{ledger['keys']} keys, {ledger['samples']} samples "
                    f"(alpha={ledger['alpha']}), "
                    f"{snap['observations']} observation records"
                )
                for key_str, entry in sorted(snap["entries"].items()):
                    cells = entry["warmth"]
                    rendered = "  ".join(
                        f"{w}: {cells[w]['ema_s'] * 1e3:.2f} ms "
                        f"({cells[w]['samples']}x)"
                        for w in ("cold", "prewarmed", "warm")
                        if w in cells
                    )
                    emit(f"  {key_str} [{entry['group']}]  {rendered}")
            elif cmd == "profile":
                # On-demand torch.profiler capture (bounded duration,
                # docs/OBSERVABILITY.md §cost-attribution).
                if self.profiler is None:
                    emit(
                        "no profiler attached — construct a "
                        "ProfileCapture and attach(console) "
                        "(docs/OBSERVABILITY.md §cost-attribution)"
                    )
                    return out
                sub = args[0] if args else "status"
                if sub == "start":
                    duration = float(args[1]) if len(args) > 1 else None
                    result = self.profiler.start(duration_s=duration)
                elif sub == "stop":
                    result = self.profiler.stop()
                elif sub == "status":
                    result = self.profiler.status()
                else:
                    emit("usage: profile [start [seconds]|stop|status]")
                    return out
                for k, v in sorted(result.items()):
                    emit(f"{k}: {v}")
            elif cmd == "drain":
                # The SIGTERM path, manually (docs/RESILIENCE.md
                # §drain): stop admission, flush, snapshot, bundle.
                if self.drainer is None:
                    emit(
                        "no drain handler attached — wire a "
                        "GracefulDrain (svoc_torch.durability) first"
                    )
                    return out
                report = self.drainer.drain(reason="console")
                if report.get("already_drained"):
                    emit("already drained")
                    return out
                flush = report.get("flush") or {}
                emit(
                    f"drained: {flush.get('flush_steps', 0)} flush steps, "
                    f"{flush.get('deferred', 0)} requests deferred"
                )
                if report.get("snapshot"):
                    emit(f"snapshot: {report['snapshot']}")
                if report.get("bundle"):
                    emit(f"bundle: {report['bundle']}")
            elif cmd == "slo":

                def emit_burns(snapshot, detail: bool = False) -> None:
                    for name in sorted(snapshot):
                        s = snapshot[name]
                        emit(
                            f"{name} (objective {s['objective']:.0%}): "
                            f"fast burn {s['fast']['burn']:.2f}x, "
                            f"slow burn {s['slow']['burn']:.2f}x"
                            + ("  ALERTING" if s["alerting"] else "")
                        )
                        if detail:
                            emit(
                                f"  {s['description']}: "
                                f"{s['good']:g}/{s['total']:g} good"
                            )

                emit_burns(self.session.slo_snapshot(), detail=True)
                # Per-claim burn rates (docs/FABRIC.md §slo): each
                # claim's evaluator covers ITS commit/admission
                # counters, so one burning market reads as that market,
                # not as fleet-average dilution.
                if self.fabric is not None:
                    for state in self.fabric.registry.states():
                        emit_burns(state.evaluator.evaluate())
                # Serving-tier objectives (docs/SERVING.md): the
                # request_latency burn here is the SAME gauge admission
                # reads — the operator sees exactly what the controller
                # sees.
                if self.serving is not None:
                    emit_burns(self.serving.slo_snapshot())
            elif cmd == "multimodal":
                # Mixture-model analysis of the LAST fetched fleet
                # (svoc_torch/sim/multimodal.py), on the session's device.
                if len(args) > 1:
                    emit("Unexpected number of arguments.")
                    return out
                with self.session.lock:
                    predictions = self.session.predictions
                if predictions is None:
                    emit("No predictions yet — run 'fetch' first.")
                    return out
                import numpy as np
                import torch

                from svoc_torch.sim.multimodal import (
                    multimodal_consensus,
                    select_k,
                )

                fleet = torch.as_tensor(
                    np.asarray(predictions), dtype=torch.float32,
                    device=self.session.device,
                )

                # K capped by the fleet size: a duplicated farthest-point
                # center would split a true pole's weight across clones.
                k_max = min(8, predictions.shape[0])
                if args and args[0] == "auto":
                    k_poles, bics = select_k(fleet, k_max=k_max)
                    emit(
                        f"BIC selects K={k_poles} "
                        f"(scores: "
                        + ", ".join(f"{b:0.1f}" for b in bics)
                        + ")"
                    )
                else:
                    k_poles = int(args[0]) if args else 2
                    if not 1 <= k_poles <= k_max:
                        emit(f"K must be in [1, {k_max}].")
                        return out

                n_failing = min(
                    self.session.config.n_failing,
                    predictions.shape[0] - 1,
                )
                res = multimodal_consensus(fleet, k_poles, n_failing)
                res = res._replace(**{
                    name: getattr(res, name).cpu()
                    for name in ("essence", "pole_means", "pole_weights",
                                 "pole_sigmas", "reliable")
                })
                order = np.argsort(-np.asarray(res.pole_weights))
                emit(f"mixture fit over {predictions.shape[0]} oracles, "
                     f"K={k_poles} pole(s):")
                for rank, k in enumerate(order):
                    mean = ", ".join(
                        f"{x:0.3f}" for x in np.asarray(res.pole_means[k])
                    )
                    emit(
                        f"  pole {rank} [w={float(res.pole_weights[k]):0.3f}"
                        f" sigma={float(res.pole_sigmas[k]):0.4f}] : {mean}"
                    )
                emit(
                    "essence (dominant pole) : "
                    + ", ".join(f"{x:0.3f}" for x in np.asarray(res.essence))
                )
                flagged = [
                    str(i) for i, r in enumerate(np.asarray(res.reliable))
                    if not r
                ]
                emit("flagged unreliable : " + (", ".join(flagged) or "none"))
            elif cmd == "live_mode":
                # The reference stubs this (web_interface.py:228;
                # oracle_scheduler.py:174-182 TODO).  Here it is the
                # full live pipeline: ingest + classify + commit.
                if len(args) != 1:
                    emit("Unexpected number of arguments.")
                    return out
                if on_off_to_bool(args[0]):
                    source_name = self._start_scraper() or "unchanged"
                    self.session.set_auto_flags(fetch=True, commit=True)
                    self._start_auto_fetch()
                    emit(f"Live mode: ENABLED (scraper={source_name}, "
                         "auto_fetch+auto_commit on)")
                else:
                    self.session.set_auto_flags(fetch=False, commit=False)
                    self._stop_scraper()
                    emit("Live mode: DISABLED")
            else:
                emit(f"Unknown command: {cmd} (try 'help')")
        except Exception as e:  # the dispatcher never crashes the REPL
            emit(f"error: {type(e).__name__}: {e}")
        return out

    # -- background loops ---------------------------------------------------

    def _start_auto_fetch(self) -> None:
        """simulation_mode (oracle_scheduler.py:163-171): fetch every
        ``refresh_rate_s`` while the flag holds.

        Each start bumps a generation token; a superseded loop exits at
        its next check even if off→on toggles race its wind-down, so
        exactly one loop serves the current enable.  The bump+start is
        atomic under ``_bg_lock`` — racing starts would otherwise both
        read the same token and neither loop would ever yield."""
        with self._bg_lock:
            gen = self._auto_fetch_gen = getattr(self, "_auto_fetch_gen", 0) + 1

        def loop():
            import time

            from svoc_torch.apps.session import EmptyStoreError
            from svoc_torch.resilience.breaker import CircuitOpenError

            while (
                gen == self._auto_fetch_gen
                and self.session.auto_fetch
                and self.session.application_on
            ):
                try:
                    # No outer lock hold: fetch/commit/bump_state lock
                    # internally and the adapter serializes per
                    # operation — a slow or hung chain RPC in this loop
                    # must never freeze the console / web UI behind the
                    # session lock.
                    self.session.fetch()
                    if self.session.auto_commit:
                        breaker_open = False
                        try:
                            # Resilient path: backoff + resume of
                            # partial fleets + breaker — a flaky chain
                            # degrades this loop, it never kills it.
                            self.session.commit_resilient()
                            if self.session.auto_resume:
                                self.session.adapter.resume()
                                self.session.bump_state()
                        except CircuitOpenError:
                            # Chain declared down: skip this cycle
                            # cheaply; the breaker half-opens after its
                            # reset window and the next cycle probes.
                            breaker_open = True
                            from svoc_torch.utils.metrics import registry as _m

                            _m.counter("auto_fetch_breaker_skips").add(1)
                        finally:
                            # Health fold runs on every commit cycle,
                            # success or tx-level failure — quarantine
                            # decisions need BOTH kinds of evidence.
                            # Never raises (Session.supervisor_step).
                            # EXCEPT on a breaker-open skip: the step's
                            # own chain reads would hang against the
                            # very backend the breaker just declared
                            # dead, re-wedging the loop the skip freed.
                            if not breaker_open:
                                self.session.supervisor_step()
                            # Burn-rate fold (docs/OBSERVABILITY.md
                            # §slo): registry-only, no chain I/O, so it
                            # runs even on breaker-open cycles — an
                            # outage is exactly when burn rates matter.
                            self.session.slo_step()
                except EmptyStoreError:
                    # Not an error in a composite loop: live mode starts
                    # the scraper and this loop together, so early
                    # cycles legitimately find an empty store — wait for
                    # ingest instead of error-spamming.
                    from svoc_torch.utils.metrics import registry as _m

                    _m.counter("auto_fetch_waiting").add(1)
                except Exception as e:
                    # Surface the failure (once per distinct message) and
                    # count it, instead of silently spinning.
                    msg = f"auto_fetch error: {type(e).__name__}: {e}"
                    if msg != getattr(self, "_last_auto_fetch_error", None):
                        self._last_auto_fetch_error = msg
                        if self._write:
                            self._write(msg)
                    from svoc_torch.utils.metrics import registry as _m

                    _m.counter("auto_fetch_errors").add(1)
                time.sleep(self.session.config.refresh_rate_s)

        self._auto_fetch_thread = threading.Thread(target=loop, daemon=True)
        self._auto_fetch_thread.start()

    def _start_scraper(self) -> Optional[str]:
        """Start the ingest loop; returns the source actually used
        ("hn-live" when Selenium is available and requested, else the
        offline synthetic generator), or ``None`` when nothing was
        started (claim superseded by a newer command, or stopped before
        the commit phase).

        Claim → build → commit: the slot is claimed by a fresh stop
        event under ``_bg_lock`` (racing 'scraper on' commands would
        otherwise both pass the is-alive check and orphan one loop's
        stop event), but the SOURCE BUILD runs unlocked — a Selenium
        browser launch takes seconds (or hangs), and 'scraper off' /
        'exit' must never block behind it.  The commit phase starts the
        thread only if this claim is still the current one."""
        with self._bg_lock:
            winding_down = None
            if self._scraper_thread and self._scraper_thread.is_alive():
                if self._scraper_stop is not None and self._scraper_stop.is_set():
                    winding_down = self._scraper_thread
                else:
                    return "already running"
            stop = self._scraper_stop = threading.Event()
        if winding_down is not None:
            # A just-stopped loop is winding down — wait it out (outside
            # the lock) so the restart actually starts a fresh loop.
            winding_down.join(timeout=5)
            if winding_down.is_alive():
                # Still wedged (e.g. a hung Selenium page fetch): do NOT
                # start a second loop writing to the same store — report
                # "not started"; the user can retry once it dies
                # (ADVICE r3).  Mark our claim stopped so the retry
                # takes the winding-down path instead of "already
                # running".
                with self._bg_lock:
                    if self._scraper_stop is stop:
                        stop.set()
                return None

        from svoc_torch.io.scraper import (
            SeleniumHNSource,
            SyntheticSource,
            run_scraper,
        )

        source, source_name = None, "synthetic"
        if self.session.config.live_scraper:
            try:
                source, source_name = SeleniumHNSource(), "hn-live"
            except RuntimeError:
                source_name = "synthetic (selenium unavailable)"
        if source is None:
            source = SyntheticSource()

        def discard() -> None:
            # Release the source (a Selenium source holds a live
            # headless Firefox that GC never quits) — on a lost claim
            # AND when the loop exits (the reference gets this for free
            # by running the scraper as a killable subprocess,
            # ``main.py:38``; a thread must quit the browser itself).
            close = getattr(source, "close", None)
            if close:
                close()

        def loop():
            try:
                run_scraper(
                    self.session.store,
                    source,
                    rate_s=self.session.config.scraper_rate_s,
                    stop_event=stop,
                    sleep=lambda s: stop.wait(s),
                )
            finally:
                discard()

        with self._bg_lock:
            if self._scraper_stop is not stop:
                discard()
                return None  # superseded by a newer scraper command
            if stop.is_set():
                # 'scraper off' landed between claim and commit — honor
                # it rather than starting a loop that exits immediately.
                discard()
                self._scraper_stop = None
                return None
            self._scraper_thread = threading.Thread(target=loop, daemon=True)
            self._scraper_thread.start()
        return source_name

    def _stop_scraper(self) -> None:
        with self._bg_lock:
            if self._scraper_stop is not None:
                self._scraper_stop.set()

    def stop(self) -> None:
        self.session.set_auto_flags(fetch=False)
        self._stop_scraper()
