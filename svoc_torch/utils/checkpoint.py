"""Checkpoint / resume: training state, simulations and service state.

Mirrors :mod:`svoc_tpu.utils.checkpoint` (``checkpoint.py:1-575``):

- **Training state**: ``save_train_state`` and ``restore_train_state``
  (``:59-85``), which write a :class:`TrainState` with orbax there.
  Here one ``torch.save`` file holds the step and the model's and the
  optimizer's state dicts; a state sharded over a mesh is gathered whole
  first, and restores onto any mesh through its factory's
  ``shard_state``.
- **Simulation state**: :func:`contract_to_dict`/:func:`contract_from_dict`
  (``:87-158``) and :func:`save_simulation`/:func:`restore_simulation`
  (``:160-237``), the contract simulator plus the session cursor.
- **Service state**: the supervisor and breaker state (``:239-305``),
  :func:`session_durable_dict` (``:307``) and
  :func:`restore_durable_session` (``:371``),
  :func:`multi_session_to_dict`, ``claim_spec_*`` and
  :func:`restore_multi_session` (``:466-549``), and the atomic
  :func:`save_snapshot`/:func:`load_snapshot` (``:551``, ``:573``).  A
  claim present in the snapshot but absent from the restoring fabric is
  QUARANTINED into the snapshot's ``unclaimed`` section — never
  silently dropped, never a crash.

Where the port departs: the PRNG key is the port's threefry key (the
two uint32 words in an int64 tensor, :mod:`svoc_torch.sim.prng`),
serialised as the reference serialises its ``uint32[2]`` key — a list
of two ints — and restored onto the session's device; the rolling
request window is a float32 tensor on that device, serialised as the
reference's float32 array is.  A snapshot written by either package
restores in the other.  A rebuilt contract
takes the session's device for its batched commit's sweep.  Snapshot
JSON is the reference's, key for key.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from svoc_torch.consensus.state import OracleConsensusContract
from svoc_torch.train.trainer import ShardedTrainState, TrainState, unshard_state

#: The snapshot promotion boundary.  Declared in
#: :mod:`svoc_torch.durability.faultspace` (importing the durability
#: package from here at module top would cycle through
#: ``durability/__init__`` → ``recovery`` → this module); the names are
#: bound here so :func:`save_snapshot` fires them by constant.
SNAPSHOT_PRE_RENAME = "snapshot.pre_rename"
SNAPSHOT_POST_RENAME = "snapshot.post_rename"

_SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# Training state
# ---------------------------------------------------------------------------


def save_train_state(path: str, state: "TrainState | ShardedTrainState") -> None:
    """Write ``state`` to the file ``path``.  A sharded state is written
    whole (:func:`svoc_torch.train.trainer.unshard_state`), so the file is
    the same whatever mesh wrote it, and a factory's ``shard_state``
    places the restored state on any mesh (``tools/finetune_demo.py:
    224-240``: orbax's restore, then ``device_put`` to another mesh)."""
    if isinstance(state, ShardedTrainState):
        state = unshard_state(state)
    torch.save(
        {
            "step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
        },
        os.path.abspath(path),
    )


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """Load a checkpoint into ``template``'s model and optimizer, in place
    (e.g. a fresh ``init_state(...)`` of the same model and ``tx``), and
    return it at the saved step.  The file is read to the host; the two
    ``load_state_dict`` calls place each tensor as the template keeps
    it (the optimizer keeps its step counts on the host)."""
    saved = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    template.model.load_state_dict(saved["model"])
    template.optimizer.load_state_dict(saved["optimizer"])
    return TrainState(saved["step"], template.model, template.optimizer)


# ---------------------------------------------------------------------------
# Simulation state
# ---------------------------------------------------------------------------


def contract_to_dict(c: OracleConsensusContract) -> Dict[str, Any]:
    """Serialize every storage slot of the contract simulator."""
    return {
        "version": _SCHEMA_VERSION,
        "admins": list(c.admins),
        "oracles": [
            {
                "address": o.address,
                "enabled": o.enabled,
                "reliable": o.reliable,
                "value": list(o.value),
            }
            for o in c.oracles
        ],
        "enable_oracle_replacement": c.enable_oracle_replacement,
        "required_majority": c.required_majority,
        "n_failing_oracles": c.n_failing_oracles,
        "constrained": c.constrained,
        "unconstrained_max_spread": c.unconstrained_max_spread,
        "dimension": c.dimension,
        "strict_interval": c.strict_interval,
        "n_active_oracles": c.n_active_oracles,
        "consensus_active": c.consensus_active,
        "consensus_value": list(c.consensus_value),
        "reliability_first_pass": c.reliability_first_pass,
        "reliability_second_pass": c.reliability_second_pass,
        "skewness": list(c.skewness),
        "kurtosis": list(c.kurtosis),
        "vote_matrix": [
            [i, j, v] for (i, j), v in c.vote_matrix.items() if v
        ],
        "replacement_propositions": [
            list(p) if p is not None else None
            for p in c.replacement_propositions
        ],
    }


def contract_from_dict(d: Dict[str, Any], device=None) -> OracleConsensusContract:
    """Rebuild a contract from :func:`contract_to_dict`; its batched
    commit's certification sweep runs on ``device`` (``None``: CUDA,
    resolved at the first sweep)."""
    if d.get("version") != _SCHEMA_VERSION:
        raise ValueError(f"unknown contract snapshot version {d.get('version')}")
    c = OracleConsensusContract(
        admins=d["admins"],
        oracles=[o["address"] for o in d["oracles"]],
        enable_oracle_replacement=d["enable_oracle_replacement"],
        required_majority=d["required_majority"],
        n_failing_oracles=d["n_failing_oracles"],
        constrained=d["constrained"],
        unconstrained_max_spread=0.0,
        dimension=d["dimension"],
        strict_interval=d["strict_interval"],
        device=device,
    )
    c.unconstrained_max_spread = int(d["unconstrained_max_spread"])
    for info, o in zip(c.oracles, d["oracles"]):
        info.enabled = o["enabled"]
        info.reliable = o["reliable"]
        info.value = [int(x) for x in o["value"]]
    c.n_active_oracles = d["n_active_oracles"]
    c.consensus_active = d["consensus_active"]
    c.consensus_value = [int(x) for x in d["consensus_value"]]
    c.reliability_first_pass = int(d["reliability_first_pass"])
    c.reliability_second_pass = int(d["reliability_second_pass"])
    c.skewness = [int(x) for x in d["skewness"]]
    c.kurtosis = [int(x) for x in d["kurtosis"]]
    for i, j, v in d["vote_matrix"]:
        c.vote_matrix[(i, j)] = v
    c.replacement_propositions = [
        tuple(p) if p is not None else None
        for p in d["replacement_propositions"]
    ]
    return c


def save_simulation(path: str, session) -> None:
    """Persist a :class:`svoc_torch.apps.session.Session`'s durable state:
    the local contract + the circular-window cursor (the volatile
    ``globalState.simulation_step`` the reference loses on restart)."""
    from svoc_torch.io.chain import LocalChainBackend

    backend = session.adapter.backend
    if not isinstance(backend, LocalChainBackend):
        raise ValueError(
            "save_simulation only applies to local-simulator sessions; "
            "Sepolia state lives on chain (use the resume command)"
        )
    payload = {
        "version": _SCHEMA_VERSION,
        "contract": contract_to_dict(backend.contract),
        "simulation_step": session.simulation_step,
        "config": dataclasses.asdict(session.config),
    }
    with open(path, "w") as f:
        json.dump(payload, f)


def restore_simulation(path: str, session) -> None:
    """Rehydrate ``session`` in place from :func:`save_simulation` —
    contract, cursor, *and* config (so fleet shape always matches the
    restored contract; a stale vectorizer sized for the old config is
    dropped when the dimension changed)."""
    from svoc_torch.apps.session import SessionConfig
    from svoc_torch.io.chain import ChainAdapter, LocalChainBackend
    from svoc_torch.resilience.retry import RetryPolicy
    from svoc_torch.resilience.supervisor import SupervisorConfig

    with open(path) as f:
        payload = json.load(f)
    contract = contract_from_dict(payload["contract"], device=session.device)
    cfg_dict = dict(payload["config"])
    # dataclasses.asdict flattened the nested resilience dataclasses to
    # plain dicts in the JSON — rebuild them, or the restored session's
    # first resilient commit dies on dict.delays().
    if isinstance(cfg_dict.get("commit_retry"), dict):
        cfg_dict["commit_retry"] = RetryPolicy(**cfg_dict["commit_retry"])
    if isinstance(cfg_dict.get("supervisor"), dict):
        cfg_dict["supervisor"] = SupervisorConfig(**cfg_dict["supervisor"])
    restored_config = SessionConfig(**cfg_dict)
    if restored_config.dimension != session.config.dimension:
        session._vectorizer = None
    session.config = restored_config
    session.adapter = ChainAdapter(LocalChainBackend(contract))
    # The supervisor watches THE session's adapter — rebind it to the
    # restored one, or health folds and replacement votes would keep
    # acting on the discarded pre-restore contract.
    session.supervisor.adapter = session.adapter
    session.supervisor.config = restored_config.supervisor
    # Claim-derived state (docs/FABRIC.md) is computed at Session
    # construction; a claim session's checkpoint restored into a plain
    # Session() must keep partitioning the journal per claim (lineage
    # ``blk<scope>-<claim>-<n>``) and labeling supervisor series, or
    # its audit records and per-claim fingerprints silently stop
    # matching.  (The breaker keeps the constructing session's series
    # name — breaker state is deliberately NOT checkpointed.)
    session.supervisor.claim = restored_config.claim
    scope = (
        restored_config.lineage_scope
        if restored_config.lineage_scope is not None
        else session.lineage_prefix[len("blk"):].split("-", 1)[0]
    )
    session.lineage_prefix = (
        f"blk{scope}-{restored_config.claim}"
        if restored_config.claim
        else f"blk{scope}"
    )
    session.simulation_step = payload["simulation_step"]


# ---------------------------------------------------------------------------
# Service state (docs/RESILIENCE.md §durability)
# ---------------------------------------------------------------------------


def _addr_json(addr: Any) -> Any:
    """Sim/real addresses are ints (the felt space); symbolic test
    doubles degrade to repr — good enough for display, and a restore
    keyed on them only has to match other reprs from the same dump."""
    return addr if isinstance(addr, (int, str)) else repr(addr)


def supervisor_state_to_dict(sup) -> Dict[str, Any]:
    """Everything :class:`~svoc_torch.resilience.supervisor.
    FleetHealthSupervisor` folds across steps: EMA scores, hysteresis
    streaks, the quarantine set, pending (un-folded) failures, the step
    count, and the replacement history/backstop state."""
    with sup._lock:
        return {
            "scores": [[_addr_json(a), s] for a, s in sup._scores.items()],
            "streaks": [[_addr_json(a), n] for a, n in sup._streaks.items()],
            "quarantined": [_addr_json(a) for a in sup._quarantined],
            "pending_failures": [
                [_addr_json(a), n] for a, n in sup._pending_failures.items()
            ],
            "steps": sup._steps,
            "replace_disabled": sup._replace_disabled,
            "replacements": [dict(r) for r in sup.replacements],
        }


def restore_supervisor_state(sup, d: Dict[str, Any]) -> None:
    with sup._lock:
        sup._scores = {a: float(s) for a, s in d.get("scores", [])}
        sup._streaks = {a: int(n) for a, n in d.get("streaks", [])}
        sup._quarantined = set(d.get("quarantined", []))
        sup._pending_failures = {
            a: int(n) for a, n in d.get("pending_failures", [])
        }
        sup._steps = int(d.get("steps", 0))
        sup._replace_disabled = bool(d.get("replace_disabled", False))
        sup.replacements = [dict(r) for r in d.get("replacements", [])]


def breaker_state_to_dict(breaker) -> Dict[str, Any]:
    with breaker._lock:
        return {
            "state": breaker._state,
            "consecutive_failures": breaker._consecutive_failures,
        }


def restore_breaker_state(breaker, d: Dict[str, Any]) -> None:
    """Rehydrate a breaker conservatively: a snapshot-OPEN breaker
    restores OPEN with a FRESH reset window (the outage may have ended
    while we were dead — half-open probes will find out in one
    ``reset_timeout_s``); half-open collapses to open (the in-flight
    probe died with the process).  Transitions go through the normal
    path so the gauge/counter/journal story stays consistent."""
    from svoc_torch.resilience.breaker import BREAKER_CLOSED, BREAKER_OPEN

    state = d.get("state", BREAKER_CLOSED)
    with breaker._lock:
        breaker._consecutive_failures = int(d.get("consecutive_failures", 0))
        if state == BREAKER_CLOSED:
            breaker._transition(BREAKER_CLOSED)
        else:
            breaker._opened_at = breaker._clock()
            breaker._probes_in_flight = 0
            breaker._transition(BREAKER_OPEN)
    breaker._flush_events()


def session_durable_dict(session) -> Dict[str, Any]:
    """The full per-claim durable state: the :func:`save_simulation`
    payload PLUS what PRs 6–7 added in memory — the rolling request
    window, the block source, the lineage/publish cursors, the PRNG
    key, and the supervisor/breaker state.  The contract is included
    for self-contained checkpoints; crash recovery over a durable
    chain log IGNORES it (the replayed chain is strictly newer —
    :func:`restore_durable_session`)."""
    from svoc_torch.io.chain import LocalChainBackend

    backend = session.adapter.backend
    inner = getattr(backend, "backend", None)
    contract = None
    if isinstance(backend, LocalChainBackend):
        contract = contract_to_dict(backend.contract)
    elif isinstance(inner, LocalChainBackend):
        contract = contract_to_dict(inner.contract)
    with session.lock:
        window = session._request_window
        key = session._key_value
        payload = {
            "version": _SCHEMA_VERSION,
            "contract": contract,
            "simulation_step": session.simulation_step,
            "config": dataclasses.asdict(session.config),
            "request_window": (
                None if window is None else window.cpu().tolist()
            ),
            "block_source": session._block_source,
            "last_lineage": session.last_lineage,
            "fetch_claim": session._fetch_claim,
            "fetch_published": session._fetch_published,
            # The published predictions themselves: fetch_published is
            # a cursor — restoring the cursor without the payload would
            # leave the commit path with "window N published" and
            # nothing to commit (the publish guard refuses to re-fetch
            # an already-published claim).
            "predictions": (
                None
                if session.predictions is None
                else np.asarray(session.predictions).tolist()
            ),
            "state_version": session.state_version,
            # Operator toggles: a crash must not silently flip the
            # fleet back to manual (or worse, re-enable auto_commit
            # the operator turned off mid-incident).
            "auto_fetch": session.auto_fetch,
            "auto_commit": session.auto_commit,
            "auto_resume": session.auto_resume,
            # The PRNG key as raw uint32 words: post-restore fleet
            # draws CONTINUE the stream instead of replaying it from
            # the seed (two restarts must not publish the same
            # bootstrap noise twice).
            "prng_key": (
                None if key is None else [int(w) for w in key.tolist()]
            ),
        }
    payload["supervisor"] = supervisor_state_to_dict(session.supervisor)
    payload["breaker"] = breaker_state_to_dict(session.breaker)
    return payload


def restore_durable_session(
    payload: Dict[str, Any], session, adapter=None
) -> None:
    """Rehydrate ``session`` from :func:`session_durable_dict`.

    ``adapter`` — when the caller already rebuilt the chain (a replayed
    :mod:`svoc_torch.durability.chainlog` tx log, or a real Sepolia
    adapter), the snapshot's embedded contract is IGNORED: the chain
    outlived us and is strictly newer than any snapshot.  Without it,
    falls back to the embedded contract like :func:`restore_simulation`.
    """
    from svoc_torch.apps.session import SessionConfig
    from svoc_torch.io.chain import ChainAdapter, LocalChainBackend
    from svoc_torch.resilience.retry import RetryPolicy
    from svoc_torch.resilience.supervisor import SupervisorConfig

    cfg_dict = dict(payload["config"])
    if isinstance(cfg_dict.get("commit_retry"), dict):
        cfg_dict["commit_retry"] = RetryPolicy(**cfg_dict["commit_retry"])
    if isinstance(cfg_dict.get("supervisor"), dict):
        cfg_dict["supervisor"] = SupervisorConfig(**cfg_dict["supervisor"])
    restored_config = SessionConfig(**cfg_dict)
    if restored_config.dimension != session.config.dimension:
        session._vectorizer = None
    session.config = restored_config
    if adapter is not None:
        session.adapter = adapter
    else:
        if payload.get("contract") is None:
            raise ValueError(
                "snapshot has no embedded contract and no adapter was "
                "provided — rebuild the chain first (replay_chain_log)"
            )
        session.adapter = ChainAdapter(
            LocalChainBackend(
                contract_from_dict(payload["contract"], device=session.device)
            )
        )
    session.supervisor.adapter = session.adapter
    session.supervisor.config = restored_config.supervisor
    session.supervisor.claim = restored_config.claim
    restore_supervisor_state(session.supervisor, payload.get("supervisor", {}))
    restore_breaker_state(session.breaker, payload.get("breaker", {}))
    scope = (
        restored_config.lineage_scope
        if restored_config.lineage_scope is not None
        else session.lineage_prefix[len("blk"):].split("-", 1)[0]
    )
    session.lineage_prefix = (
        f"blk{scope}-{restored_config.claim}"
        if restored_config.claim
        else f"blk{scope}"
    )
    window = payload.get("request_window")
    key = payload.get("prng_key")
    with session.lock:
        session.simulation_step = int(payload["simulation_step"])
        # The port keeps the rolling window as a float32 tensor on the
        # session's device (apps/session.py::request_window).
        session._request_window = (
            None
            if window is None
            else torch.tensor(
                np.asarray(window, dtype=np.float32), device=session.device
            )
        )
        session._block_source = payload.get("block_source", "store")
        session.last_lineage = payload.get("last_lineage")
        # Lineage continuity: the next fetch must mint claim N+1, or a
        # restarted session would re-mint already-published lineage ids
        # and merge two different blocks' audit records.
        session._fetch_claim = int(payload.get("fetch_claim", 0))
        session._fetch_published = int(payload.get("fetch_published", 0))
        # The port's threefry key: the two uint32 words in an int64
        # tensor on the session's device (svoc_torch.sim.prng).
        session._key_value = (
            None
            if key is None
            else torch.tensor(
                np.asarray(key, dtype=np.uint32).astype(np.int64),
                device=session.device,
            )
        )
        preds = payload.get("predictions")
        session.predictions = (
            None if preds is None else np.asarray(preds, dtype=np.float64)
        )
        # state_version stays monotonic across the restore: a web
        # client polling with a pre-crash version must still see the
        # next redraw.
        session.state_version = max(
            session.state_version, int(payload.get("state_version", 0))
        )
        session.auto_fetch = bool(
            payload.get("auto_fetch", session.auto_fetch)
        )
        session.auto_commit = bool(
            payload.get("auto_commit", session.auto_commit)
        )
        session.auto_resume = bool(
            payload.get("auto_resume", session.auto_resume)
        )


def multi_session_to_dict(multi) -> Dict[str, Any]:
    """Snapshot a :class:`svoc_torch.fabric.session.MultiSession`: the
    claim registry's membership (specs) + every claim's durable session
    state + the router's scheduling cursor.  ``tamper`` hooks are
    scenario-local callables and are NOT serialized (a restored claim
    is honest until its scenario re-arms it)."""
    claims: Dict[str, Any] = {}
    for state in multi.registry.states():
        claims[state.spec.claim_id] = {
            "spec": claim_spec_to_dict(state.spec),
            "cycles": state.cycles,
            "paused": state.paused,
            "session": session_durable_dict(state.session),
        }
    return {
        "version": _SCHEMA_VERSION,
        "router_steps": multi.router.steps,
        "claims": claims,
        "unclaimed": {},
    }


def claim_spec_to_dict(spec) -> Dict[str, Any]:
    d = dataclasses.asdict(spec)
    d.pop("tamper", None)  # callables don't serialize; re-arm on restore
    return d


def claim_spec_from_dict(d: Dict[str, Any]):
    from svoc_torch.fabric.registry import ClaimSpec

    return ClaimSpec(**d)


def restore_multi_session(
    payload: Dict[str, Any], multi, adapters: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    """Rehydrate ``multi``'s claims in place from
    :func:`multi_session_to_dict`.

    Membership may have CHANGED between snapshot and restore (a claim
    added or removed by an operator, a different scenario roster): a
    snapshot claim with no live counterpart is moved into the
    snapshot's ``unclaimed`` section — quarantined, not dropped, so a
    later restore (or a human) can still recover it — and a live claim
    with no snapshot state is left fresh.  ``adapters`` maps claim id →
    rebuilt chain adapter (:func:`restore_durable_session` semantics).
    Returns ``{"restored": [...], "unclaimed": [...], "fresh": [...]}``.
    """
    adapters = adapters or {}
    live = {s.spec.claim_id: s for s in multi.registry.states()}
    restored: list = []
    unclaimed = payload.setdefault("unclaimed", {})
    # A previously-quarantined orphan whose claim is back in the live
    # roster is reclaimed — the quarantine is a waiting room, not a
    # grave.  When the snapshot ALSO carries fresher live state for
    # the id, that state wins and the orphan STAYS quarantined (an
    # eager pop here would silently drop it — the exact failure the
    # section exists to prevent).
    claims = payload.setdefault("claims", {})
    for cid in [c for c in list(unclaimed) if c in live]:
        if cid not in claims:
            claims[cid] = unclaimed.pop(cid)
    fresh = [cid for cid in live if cid not in payload.get("claims", {})]
    for cid, entry in list(payload.get("claims", {}).items()):
        state = live.get(cid)
        if state is None:
            # Orphan: quarantine into the snapshot itself.  Never raise
            # — the rest of the fabric must come back up.
            unclaimed[cid] = entry
            continue
        restore_durable_session(
            entry["session"], state.session, adapter=adapters.get(cid)
        )
        state.cycles = int(entry.get("cycles", 0))
        state.paused = bool(entry.get("paused", False))
        restored.append(cid)
    multi.router.steps = int(payload.get("router_steps", 0))
    return {
        "restored": sorted(restored),
        "unclaimed": sorted(unclaimed),
        "fresh": sorted(fresh),
    }


def save_snapshot(path: str, payload: Dict[str, Any]) -> None:
    """Atomic (tmp + rename + fsync file AND directory) JSON write —
    a snapshot either exists whole or not at all, and the rename is
    durable before we return (the recovery manager may rotate the WAL
    immediately after, trusting the snapshot exists)."""
    from svoc_torch.durability.faultspace import fault_point
    from svoc_torch.utils.events import _json_safe, fsync_dir

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_json_safe(payload), f)
        f.flush()
        os.fsync(f.fileno())
    # A kill here leaves only the .tmp — recovery must use the PREVIOUS
    # snapshot plus the journal tail + WAL, never the half-promoted one.
    fault_point(SNAPSHOT_PRE_RENAME)
    os.replace(tmp, path)
    fsync_dir(path)
    # Snapshot durable, caller's follow-up (WAL rotation) not yet run.
    fault_point(SNAPSHOT_POST_RENAME)


def load_snapshot(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
