"""Durable local chain: a tx log that survives the process.

Mirrors :mod:`svoc_tpu.durability.chainlog` (``chainlog.py:1-300``):
:class:`DurableLocalBackend` (``:101``), :func:`read_chain_log`,
:func:`replay_chain_log` and :func:`duplicate_predictions`, with their
four declared fault points.  Log lines are the reference's, byte for
byte, for the same txs.

The real deployment's chain (Sepolia) is EXTERNAL — it survives our
process dying mid-commit, which is exactly what makes crash consistency
hard (a restart must ask the chain what landed).  The in-memory
:class:`~svoc_torch.io.chain.LocalChainBackend` dies WITH the process, so
neither the recovery manager nor the kill/restart harness could observe
the one failure mode that matters.  This wrapper restores the external
property for simulations:

- every successful ``invoke`` (signed tx) appends one fsynced record to
  a tx log **after** the in-memory contract applied it — a tx is "on
  chain" iff it is in the log.  A kill between the in-memory apply and
  the append evaporates the tx, which is indistinguishable from the tx
  never landing (the in-memory state dies too): process-level
  atomicity, and reverted txs never pollute the log.
- :func:`replay_chain_log` rebuilds the contract state on restart by
  re-applying the log onto a fresh contract — the simulator's
  equivalent of the chain simply still being there.

The log is ALSO the harness's duplicate-tx witness: each
``update_prediction`` record carries the caller and the payload digest,
so the crash smoke (:mod:`svoc_torch.tools.crash_smoke`) asserts zero
``(caller, digest)`` duplicates across a kill/restart matrix without
trusting any in-process accounting.

The wrapper deliberately does NOT forward the adapter's THROUGHPUT
batch entrypoint (``invoke_update_predictions_batch``): tx-granular
logging is the point there, and the adapter falls back to the per-tx
loop when the attribute is absent.  The commit PLANE's one-RPC
entrypoint (``update_predictions_batched``, docs/RESILIENCE.md
§batched-commits) IS forwarded: the external chain processes a batch
as one call but still persists per-tx state, so the wrapper applies
the batch on the inner contract and then logs every applied tx with
ONE fsync — "a tx is on chain iff logged" holds record by record, and
the ``duplicate_predictions`` witness keeps seeing tx granularity.  A
mid-batch failure logs the applied prefix before the error propagates.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, List

from svoc_torch.consensus.state import OracleConsensusContract
from svoc_torch.durability.faultspace import (
    SMOKE_CRASH,
    SMOKE_FUZZ,
    armed,
    declare,
    fault_point,
    torn_line_write,
)
from svoc_torch.durability.wal import payload_digest, read_wal, seal_jsonl
from svoc_torch.io.chain import LocalChainBackend

#: The simulated chain's fault surface (docs/RESILIENCE.md
#: §fault-surface): the apply→log window and the record boundaries of
#: the batched plane.
CHAINLOG_TX_POST_APPLY = declare(
    "chainlog.tx.post_apply",
    owner="svoc_torch/durability/chainlog.py",
    invariant="a tx killed between in-memory apply and the log append "
    "evaporated — the restart must classify it stranded and resend",
    actions=("kill", "torn"),
    smokes=(SMOKE_FUZZ,),
    modes=("per_tx",),
)
CHAINLOG_TX_POST_FSYNC = declare(
    "chainlog.tx.post_fsync",
    owner="svoc_torch/durability/chainlog.py",
    invariant="a tx durably on chain whose WAL landed record was never "
    "written must classify landed via the chain digest, never resend",
    actions=("kill",),
    smokes=(SMOKE_FUZZ, SMOKE_CRASH),
    modes=("per_tx",),
)
CHAIN_BATCH_PRE_LOG = declare(
    "chain.batch.pre_log",
    owner="svoc_torch/durability/chainlog.py",
    invariant="a whole batch killed between apply and the first log "
    "append evaporated — every slot must classify stranded and resend",
    actions=("kill",),
    smokes=(SMOKE_FUZZ,),
    modes=("batched",),
)
CHAIN_BATCH_MID_FLEET = declare(
    "chain.batch.mid_fleet",
    owner="svoc_torch/durability/chainlog.py",
    invariant="a batched commit killed mid-log leaves a durable tx "
    "prefix: the reconciler must classify it landed (chain digest / "
    "landed_batch) and resend only the suffix",
    actions=("kill",),
    smokes=(SMOKE_FUZZ, SMOKE_CRASH),
    modes=("batched",),
)


class DurableLocalBackend:
    """A :class:`LocalChainBackend` whose txs survive the process."""

    def __init__(self, contract: OracleConsensusContract, log_path: str):
        self._inner = LocalChainBackend(contract)
        self.log_path = log_path
        seal_jsonl(log_path)  # a torn tail is a tx that never landed
        self._f = None

    # The supervisor's locality probe and the fault injector both walk
    # ``.backend`` chains — expose the wrapped backend the same way.
    @property
    def backend(self) -> LocalChainBackend:
        return self._inner

    @property
    def contract(self) -> OracleConsensusContract:
        return self._inner.contract

    # -- reads pass through -------------------------------------------------

    def call(self, function_name: str) -> Any:
        return self._inner.call(function_name)

    def call_as(self, caller: int, function_name: str) -> Any:
        return self._inner.call_as(caller, function_name)

    # -- writes: apply, then journal ---------------------------------------

    def invoke(self, caller: int, function_name: str, /, **kwargs) -> None:
        self._inner.invoke(caller, function_name, **kwargs)
        record: Dict[str, Any] = {"caller": int(caller), "fn": function_name}
        if function_name == "update_prediction":
            felts = [int(x) for x in kwargs["prediction"]]
            record["prediction"] = felts
            record["digest"] = payload_digest(felts)
        elif function_name == "update_proposition":
            p = kwargs["proposition"]
            record["proposition"] = None if p is None else [int(p[0]), int(p[1])]
        elif function_name == "vote_for_a_proposition":
            record["which_admin"] = int(kwargs["which_admin"])
            record["support"] = bool(kwargs["support_his_proposition"])
        # The apply→log window: a kill here evaporates the tx (the
        # in-memory state dies with the process) — indistinguishable
        # from the tx never landing; ``torn`` leaves the power-cut
        # half-record ``seal_jsonl`` repairs.
        fault_point(
            CHAINLOG_TX_POST_APPLY,
            payload={"fn": function_name},
            torn=lambda: self._torn_append(record),
        )
        self._append(record)
        # The tx is durably on chain; the WAL's landed record is not
        # yet written (the old ``inter_tx`` kill point, now named).
        fault_point(CHAINLOG_TX_POST_FSYNC, payload={"fn": function_name})

    def update_predictions_batched(
        self, callers, predictions
    ) -> int:
        """The one-RPC commit plane over the durable log (module
        docstring): apply the whole batch on the inner contract, then
        log every applied tx with a single fsync.  A mid-batch
        :class:`~svoc_torch.consensus.state.BatchTxError` logs the
        applied prefix before propagating — those txs ARE on chain."""

        def log_applied(n: int) -> None:
            records = []
            for caller, felts in list(zip(callers, predictions))[:n]:
                felts = [int(x) for x in felts]
                records.append(
                    {
                        "caller": int(caller),
                        "fn": "update_prediction",
                        "prediction": felts,
                        "digest": payload_digest(felts),
                    }
                )
            if records:
                # The whole applied batch is about to hit the log — a
                # kill here evaporates every tx at once.
                fault_point(CHAIN_BATCH_PRE_LOG, payload={"n": len(records)})
            if armed():
                # Chaos harness: per-record append + fsync so a
                # mid-fleet kill leaves exactly the durable prefix a
                # real external chain would (the production one-fsync
                # batch has no observable mid-point to kill at).
                for i, record in enumerate(records):
                    self._append(record)
                    fault_point(
                        CHAIN_BATCH_MID_FLEET,
                        payload={"fn": "update_prediction", "index": i},
                    )
            else:
                self._append_many(records)

        from svoc_torch.consensus.state import BatchTxError

        try:
            sent = self._inner.update_predictions_batched(
                callers, predictions
            )
        except BatchTxError as e:
            log_applied(e.index)
            raise
        log_applied(sent)
        return sent

    def _append(self, record: Dict[str, Any]) -> None:
        self._append_many([record])

    def _torn_append(self, record: Dict[str, Any]) -> None:
        """The ``torn`` writer for this log's fault points — the shared
        power-cut primitive; the caller (the armed controller) SIGKILLs
        immediately after."""
        if self._f is None:
            self._f = open(self.log_path, "a")
        torn_line_write(self._f, record)

    def _append_many(self, records) -> None:
        if not records:
            return
        if self._f is None:
            self._f = open(self.log_path, "a")
        for record in records:
            self._f.write(json.dumps(record, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            with contextlib.suppress(OSError):
                self._f.close()
            self._f = None


def read_chain_log(path: str) -> List[Dict[str, Any]]:
    """The tx log, torn-tail tolerant (same crash semantics as the
    WAL reader — a torn tail is a tx that never durably landed, and
    :func:`replay_chain_log` must skip it, not crash)."""
    records = read_wal(path)
    # A torn final record could parse as JSON yet be a truncated felt
    # list — guard by requiring the per-kind mandatory keys.
    out = []
    for r in records:
        fn = r.get("fn")
        if fn == "update_prediction" and "digest" not in r:
            continue
        if "caller" not in r or fn is None:
            continue
        out.append(r)
    return out


def replay_chain_log(
    path: str, contract: OracleConsensusContract
) -> int:
    """Re-apply the tx log onto ``contract`` (freshly constructed with
    the deployment constructor args) — the restarted process's view of
    the still-alive chain.  Returns the number of replayed txs."""
    backend = LocalChainBackend(contract)
    n = 0
    for r in read_chain_log(path):
        fn = r["fn"]
        if fn == "update_prediction":
            backend.invoke(
                r["caller"], fn, prediction=[int(x) for x in r["prediction"]]
            )
        elif fn == "update_proposition":
            p = r.get("proposition")
            backend.invoke(
                r["caller"], fn,
                proposition=None if p is None else (int(p[0]), int(p[1])),
            )
        elif fn == "vote_for_a_proposition":
            backend.invoke(
                r["caller"], fn,
                which_admin=r["which_admin"],
                support_his_proposition=r["support"],
            )
        else:  # pragma: no cover — unknown entrypoints never logged
            raise ValueError(f"unknown logged entrypoint {fn!r}")
        n += 1
    return n


def duplicate_predictions(path: str) -> List[Dict[str, Any]]:
    """Every ``(caller, digest)`` pair that appears more than once in
    the tx log — the harness's zero-duplicates witness.  Fleet payloads
    vary per cycle (continuous sentiment vectors), so a repeated pair
    means the same tx was sent twice."""
    seen: Dict[tuple, int] = {}
    dups: List[Dict[str, Any]] = []
    for r in read_chain_log(path):
        if r["fn"] != "update_prediction":
            continue
        key = (r["caller"], r["digest"])
        seen[key] = seen.get(key, 0) + 1
        if seen[key] == 2:
            dups.append({"caller": r["caller"], "digest": r["digest"]})
    return dups
