"""Starknet chain adapter: typed reads and writes over a pluggable backend.

Mirrors :mod:`svoc_tpu.io.chain` (``chain.py:28-1128``), the whole
module.  Reference: ``client/contract.py``, its felt252↔float codec
(``:35-53``), per-oracle ``Account`` registry (``:61-90``), typed
``call_*`` reads (``:131-190``), sequential per-oracle signed writes
(``:200-264``) and index↔address resolution (``:95-123``).

- :class:`ChainBackend` — the protocol: ``call(fn) -> felts`` and
  ``invoke(caller, fn, **kwargs)``.
- :class:`LocalChainBackend` — the contract simulator
  (:class:`svoc_torch.consensus.state.OracleConsensusContract`) behind
  the same felt calldata.  Its batched entrypoints run the contract's
  certified commit, whose sweep runs on the device the contract was
  built with.
- :class:`StarknetBackend` — Sepolia through ``starknet.py`` with the
  reference's V3 resource bounds, imported only when built, so the
  module loads without it.
- :class:`ChainAdapter` — the typed API, the same over both backends:
  the per-tx loop, the batched fleet commit above
  ``BATCH_COMMIT_THRESHOLD`` oracles with its fall-through to the per-tx
  loop when the batch is not certified, the one-RPC batched plane, the
  replacement vote and ``resume``.

The WAL hooks (``on_intent``/``on_landed``, and ``wal`` with its
``intent_batch``/``landed_batch``) are duck-typed; the WAL is
:class:`svoc_torch.durability.wal.CommitIntentWAL`.  Addresses are plain
ints (the felt address space).
"""

from __future__ import annotations

import asyncio
import functools
import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from svoc_torch.consensus.state import ContractError, OracleConsensusContract
from svoc_torch.ops.fixedpoint import (
    encode_matrix,
    encode_vector,
    fwsad_to_float,
    wsad_to_felt,
)

#: Reference V3 transaction resource bounds (``client/contract.py:29-32``).
RESOURCE_BOUND_L1_GAS = (259806, 153060543928007)

_fault_point = None


def _fire_fault_point(name: str, **kwargs) -> None:
    """Fire a named fault point (docs/RESILIENCE.md §fault-surface).

    The adapter's RPC boundaries are part of the chaos fuzzer's
    surface, but ``durability/chainlog.py`` imports this module — a
    top-level import back into the durability package would be circular, so the hook binds lazily (the declarations live in
    :mod:`svoc_torch.durability.faultspace`).  One cached-global check
    per signed tx when disarmed."""
    global _fault_point
    if _fault_point is None:
        from svoc_torch.durability.faultspace import fault_point

        _fault_point = fault_point
    _fault_point(name, **kwargs)


class ChainCommitError(RuntimeError):
    """A commit loop failed mid-way: earlier txs ARE on chain.

    The reference's sequential per-oracle submit
    (``client/contract.py:200-208``) has no rollback — a failure after
    k transactions leaves k oracle predictions committed.  This error
    carries that accounting so callers can surface it instead of
    guessing from a traceback.
    """

    def __init__(
        self, committed: int, total: int, failed_oracle, cause,
        sent_count: Optional[int] = None,
    ):
        self.committed = committed
        self.total = total
        self.failed_oracle = failed_oracle
        self.cause = cause
        #: Transactions actually landed by the failing ATTEMPT.  Equals
        #: ``committed - start`` on the plain path, but diverges when
        #: quarantine ``skip`` slots sit inside the attempted range
        #: (``committed`` is a fleet INDEX for resume; skipped slots
        #: advance it without sending a tx).  ``None`` when the raiser
        #: did not supply it — consumers must fall back to the index
        #: delta (``committed - start``), NEVER to ``committed``, which
        #: on a resumed attempt would overstate landed txs and credit
        #: a zero-progress failure as breaker progress.
        self.sent_count = sent_count
        super().__init__(
            f"commit failed at oracle {failed_oracle!r} after "
            f"{committed}/{total} transactions: {cause}"
        )


class BatchCommitUnsupported(RuntimeError):
    """A fleet commit cannot run as ONE batched RPC — the caller must
    take the per-tx loop instead (ALWAYS counted:
    ``commit_batch_fallback{reason=}``, docs/RESILIENCE.md
    §batched-commits).  Raised BEFORE any chain mutation or WAL record,
    so falling back is always safe."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.detail = detail
        super().__init__(
            f"batched commit unavailable ({reason})"
            + (f": {detail}" if detail else "")
        )


def to_hex(x: int) -> str:
    return f"0x{x:0x}"


def from_hex(x: str) -> int:
    return int(x, 16)


class ChainBackend(Protocol):
    def call(self, function_name: str) -> Any: ...

    def call_as(self, caller: int, function_name: str) -> Any: ...

    def invoke(self, caller: int, function_name: str, /, **kwargs) -> None: ...


class LocalChainBackend:
    """In-memory chain: the contract simulator behind the felt ABI.

    Values cross this boundary exactly as they would cross the real one
    — wsad ints two's-complement-wrapped around the felt prime — so the
    adapter's codec path is exercised identically for sim and Sepolia.
    """

    def __init__(self, contract: OracleConsensusContract):
        self.contract = contract

    # -- reads: mirror the Cairo view entrypoints --------------------------

    def call(self, function_name: str) -> Any:
        c = self.contract
        if function_name == "get_consensus_value":
            return [wsad_to_felt(x) for x in c.get_consensus_value()]
        if function_name == "get_skewness":
            return [wsad_to_felt(x) for x in c.get_skewness()]
        if function_name == "get_kurtosis":
            return [wsad_to_felt(x) for x in c.get_kurtosis()]
        if function_name == "get_first_pass_consensus_reliability":
            return wsad_to_felt(c.get_first_pass_consensus_reliability())
        if function_name == "get_second_pass_consensus_reliability":
            return wsad_to_felt(c.get_second_pass_consensus_reliability())
        if function_name == "consensus_active":
            return c.consensus_active
        if function_name == "get_admin_list":
            return list(c.get_admin_list())
        if function_name == "get_oracle_list":
            return list(c.get_oracle_list())
        if function_name == "get_predictions_dimension":
            return c.get_predictions_dimension()
        if function_name == "get_replacement_propositions":
            return list(c.get_replacement_propositions())
        raise KeyError(f"unknown view function {function_name!r}")

    def call_as(self, caller: int, function_name: str) -> Any:
        if function_name == "get_oracle_value_list":
            # Same encoding the chain would use: wsad values prime-wrapped
            # to felt252 (contract.cairo:772-798 returns FeltVectors).
            return [
                (addr, [wsad_to_felt(x) for x in vec], enabled, reliable)
                for addr, vec, enabled, reliable in (
                    self.contract.get_oracle_value_list(caller)
                )
            ]
        raise KeyError(f"unknown caller-view function {function_name!r}")

    # -- writes: the three invoke entrypoints ------------------------------

    def invoke(self, caller: int, function_name: str, /, **kwargs) -> None:
        c = self.contract
        if function_name == "update_prediction":
            c.update_prediction(caller, kwargs["prediction"], encoding="felt")
        elif function_name == "update_proposition":
            c.update_proposition(caller, kwargs["proposition"])
        elif function_name == "vote_for_a_proposition":
            c.vote_for_a_proposition(
                caller, kwargs["which_admin"], kwargs["support_his_proposition"]
            )
        else:
            raise KeyError(f"unknown invoke function {function_name!r}")

    def update_predictions_batched(
        self,
        callers: Sequence[int],
        predictions: Sequence[Sequence[int]],
    ) -> int:
        """The commit plane's ONE-RPC fleet entrypoint
        (docs/RESILIENCE.md §batched-commits): one backend call carries
        every (caller, felt payload) pair, with the EXACT sequential
        per-tx semantics (a mid-fleet panic raises
        :class:`svoc_torch.consensus.state.BatchTxError` with the failed
        index; the prefix IS applied — chain semantics, no rollback).

        Unlike :meth:`invoke_update_predictions_batch` (the ≥64-fleet
        throughput path), this uses ``on_uncertified="sequential"``:
        the RPC-count contract is the point, so an uncertifiable batch
        runs the exact engine per tx INSIDE the one call instead of
        bouncing back to N adapter-level RPCs."""
        return self.contract.update_predictions_batch(
            callers,
            predictions,
            encoding="felt",
            on_uncertified="sequential",
        )

    def invoke_update_predictions_batch(
        self,
        callers: Sequence[int],
        predictions: Sequence[Sequence[int]],
        on_uncertified: str = "raise",
    ) -> int:
        """Fleet-scale commit: same sequential-tx semantics as looping
        ``invoke(…, "update_prediction")`` caller by caller, at O(1)
        golden-engine recomputes (:mod:`svoc_torch.consensus.batch`).
        Only the local simulator offers this — the real chain has no
        batched entrypoint, so :class:`StarknetBackend` keeps the
        per-tx loop.  Default ``on_uncertified="raise"``: the adapter
        reruns its own per-tx loop rather than holding its lock across
        an O(N)-recompute fallback."""
        return self.contract.update_predictions_batch(
            callers,
            predictions,
            encoding="felt",
            on_uncertified=on_uncertified,
        )


class StarknetBackend:
    """Sepolia JSON-RPC backend (``client/contract.py`` semantics).

    Reads go through one ABI-resolved contract on the node client;
    writes re-resolve the contract with the *caller's* account as
    provider and submit a signed ``invoke_v3`` with the reference's
    fixed resource bounds (``client/contract.py:211-264``).
    """

    def __init__(
        self,
        node_url: str,
        deployed_address: int,
        accounts: Dict[int, Any],
        client: Any = None,
    ):
        try:
            from starknet_py.contract import Contract
            from starknet_py.net.client_models import ResourceBounds
            from starknet_py.net.full_node_client import FullNodeClient
        except ImportError as e:  # pragma: no cover — package present in CI mocks
            raise RuntimeError(
                "StarknetBackend needs the 'starknet.py' package; use "
                "LocalChainBackend for simulation"
            ) from e
        self._Contract = Contract
        self._bounds = ResourceBounds(*RESOURCE_BOUND_L1_GAS)
        self.client = client if client is not None else FullNodeClient(node_url=node_url)
        self.deployed_address = deployed_address
        self.accounts = accounts  # address -> starknet Account
        self._read_contract = asyncio.run(
            Contract.from_address(
                provider=self.client, address=deployed_address
            )
        )
        #: ABI is immutable per (caller, address) — cache the resolved
        #: contract per account so a commit cycle costs one RPC per tx,
        #: not two (client/contract.py re-resolves every time; that is
        #: a reference inefficiency, not semantics).
        self._caller_contracts: Dict[int, Any] = {}

    def call(self, function_name: str) -> Any:
        return asyncio.run(
            self._read_contract.functions[function_name].call()
        )[0]

    def _caller_contract(self, caller: int):
        contract = self._caller_contracts.get(caller)
        if contract is None:
            contract = asyncio.run(
                self._Contract.from_address(
                    provider=self.accounts[caller], address=self.deployed_address
                )
            )
            self._caller_contracts[caller] = contract
        return contract

    def call_as(self, caller: int, function_name: str) -> Any:
        contract = self._caller_contract(caller)
        return asyncio.run(contract.functions[function_name].call())[0]

    def invoke(self, caller: int, function_name: str, /, **kwargs) -> None:
        contract = self._caller_contract(caller)
        asyncio.run(
            contract.functions[function_name].invoke_v3(
                **kwargs, l1_resource_bounds=self._bounds
            )
        )


class DeployedContract:
    """Result of :func:`declare_and_deploy` — what ``contract_info.json``
    records (``client/data/contract_info.json:2-4``)."""

    def __init__(self, class_hash: int, address: int):
        self.class_hash = class_hash
        self.address = address

    def contract_info(self, rpc_url: str) -> Dict[str, str]:
        """The ``contract_info.json`` payload for this deployment."""
        return {
            "rpc": rpc_url,
            "declared_address": to_hex(self.class_hash),
            "deployed_address": to_hex(self.address),
        }


def declare_and_deploy(
    account: Any,
    cfg: Any,
    compiled_contract: str,
    compiled_contract_casm: Optional[str] = None,
    auto_estimate: bool = True,
) -> DeployedContract:
    """Declare the Sierra/CASM contract and deploy an instance with the
    consensus configuration frozen in the constructor calldata — the
    reference's manual Argent/starkli flow
    (``contract/README.md:41-66``) as one call.

    ``account`` is the paying ``starknet.py`` Account; ``cfg`` a
    :class:`svoc_torch.io.deploy.DeployConfig`.  Both transactions are
    awaited to acceptance; the result carries the class hash and the
    deployed address (what ``contract_info.json`` stores).
    """
    try:
        from starknet_py.contract import Contract
    except ImportError as e:  # pragma: no cover — package present in CI mocks
        raise RuntimeError(
            "declare_and_deploy needs the 'starknet.py' package; use "
            "LocalChainBackend for simulation"
        ) from e

    from svoc_torch.io.deploy import constructor_args

    async def _run():
        declare_result = await Contract.declare_v3(
            account=account,
            compiled_contract=compiled_contract,
            compiled_contract_casm=compiled_contract_casm,
            auto_estimate=auto_estimate,
        )
        await declare_result.wait_for_acceptance()
        deploy_result = await declare_result.deploy_v3(
            constructor_args=constructor_args(cfg),
            auto_estimate=auto_estimate,
        )
        await deploy_result.wait_for_acceptance()
        return declare_result, deploy_result

    declare_result, deploy_result = asyncio.run(_run())
    return DeployedContract(
        class_hash=int(declare_result.class_hash),
        address=int(deploy_result.deployed_contract.address),
    )


def load_account_data(path: str) -> Tuple[List[dict], List[dict]]:
    """Parse the ``data/sepolia.json`` layout (``client/contract.py:61-71``,
    template at ``client/README.md:38-77``): parallel hex-string lists
    ``admins_addresses``/``admins_private_keys`` and
    ``oracles_addresses``/``oracles_private_keys`` (3 admins, 8 oracles
    in the reference deployment)."""
    with open(path) as f:
        data = json.load(f)
    admins = [
        {"address": a, "private_key": k}
        for a, k in zip(
            data["admins_addresses"], data["admins_private_keys"], strict=True
        )
    ]
    oracles = [
        {"address": a, "private_key": k}
        for a, k in zip(
            data["oracles_addresses"], data["oracles_private_keys"], strict=True
        )
    ]
    return admins, oracles


def load_contract_info(path: str) -> Tuple[str, int, int]:
    """Parse ``data/contract_info.json`` (``client/README.md:22-30``):
    ``(rpc_url, declared_address, deployed_address)``."""
    with open(path) as f:
        info = json.load(f)
    return (
        info["rpc"],
        from_hex(info["declared_address"]),
        from_hex(info["deployed_address"]),
    )


def build_starknet_accounts(
    client: Any, admins: Sequence[dict], oracles: Sequence[dict]
) -> Dict[int, Any]:
    """``Account`` objects keyed by int address for every admin and
    oracle entry (``client/contract.py:73-84``)."""
    from starknet_py.net.account.account import Account
    from starknet_py.net.models.chains import StarknetChainId
    from starknet_py.net.signer.stark_curve_signer import KeyPair

    accounts: Dict[int, Any] = {}
    for entry in list(admins) + list(oracles):
        accounts[from_hex(entry["address"])] = Account(
            client=client,
            address=entry["address"],
            key_pair=KeyPair.from_private_key(entry["private_key"]),
            chain=StarknetChainId.SEPOLIA,
        )
    return accounts


def starknet_backend_from_files(
    contract_info_path: str, accounts_path: str
) -> "StarknetBackend":
    """The full reference bootstrap (``retrieve_account_data``,
    ``client/contract.py:61-90``): RPC client from ``contract_info.json``,
    per-identity accounts from ``sepolia.json``, ABI-resolved contract."""
    from starknet_py.net.full_node_client import FullNodeClient

    rpc, _declared, deployed = load_contract_info(contract_info_path)
    client = FullNodeClient(node_url=rpc)
    admins, oracles = load_account_data(accounts_path)
    accounts = build_starknet_accounts(client, admins, oracles)
    return StarknetBackend(rpc, deployed, accounts, client=client)


def _atomic(fn):
    """Serialize one adapter operation (backend call/invoke + its cache
    write) on the adapter lock.  Deliberately NOT applied to the
    composite loops (``update_all_the_predictions``, ``resume``): their
    inner ops each lock individually, so a long chain commit never
    monopolizes the adapter — interleaving at transaction granularity
    is exactly what the real chain permits anyway."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


class ChainAdapter:
    """The typed chain API (``call_*`` / ``invoke_*`` parity).

    Thread-safe at operation granularity: each read or signed tx is
    atomic under the adapter lock (protecting the in-memory contract
    simulator's state machine and the read cache), while composites
    interleave at tx granularity like the real chain."""

    #: rel₂ trajectory ring size (~4 h of 1-per-minute resumes).
    REL2_HISTORY = 256

    def __init__(self, backend: ChainBackend):
        self.backend = backend
        #: Last-read cache, the ``globalState.remote_*`` equivalent
        #: (``client/common.py:43-55``) — rehydrated by ``resume``.
        self.cache: Dict[str, Any] = {}
        #: (monotonic_s, rel₂) samples appended on every second-pass
        #: reliability read.  The LEVEL of rel₂ cannot detect a
        #: coordinated majority capture (after takeover it reads the
        #: adversary band's dispersion — healthy); the TRAJECTORY shows
        #: the approach (docs/ALGORITHM.md §5 breakdown curve), so the
        #: console and web UI surface the trend.
        self.rel2_history: deque = deque(maxlen=self.REL2_HISTORY)
        self._lock = threading.RLock()

    def cache_snapshot(self) -> Dict[str, Any]:
        """Consistent copy of the read cache for UI rendering — safe
        against a concurrent ``resume`` rehydrating it key by key."""
        with self._lock:
            return dict(self.cache)

    # -- reads (client/contract.py:131-190) --------------------------------

    @_atomic
    def call_consensus(self) -> List[float]:
        v = [fwsad_to_float(x) for x in self.backend.call("get_consensus_value")]
        self.cache["consensus"] = v
        return v

    @_atomic
    def call_skewness(self) -> List[float]:
        v = [fwsad_to_float(x) for x in self.backend.call("get_skewness")]
        self.cache["skewness"] = v
        return v

    @_atomic
    def call_kurtosis(self) -> List[float]:
        v = [fwsad_to_float(x) for x in self.backend.call("get_kurtosis")]
        self.cache["kurtosis"] = v
        return v

    @_atomic
    def call_first_pass_consensus_reliability(self) -> float:
        v = fwsad_to_float(
            self.backend.call("get_first_pass_consensus_reliability")
        )
        self.cache["reliability_first_pass"] = v
        return v

    @_atomic
    def call_second_pass_consensus_reliability(self) -> float:
        v = fwsad_to_float(
            self.backend.call("get_second_pass_consensus_reliability")
        )
        self.cache["reliability_second_pass"] = v
        self.rel2_history.append((time.monotonic(), v))
        return v

    @_atomic
    def peek_second_pass_reliability(self) -> float:
        """Same read as :meth:`call_second_pass_consensus_reliability`
        but WITHOUT feeding the rel₂ trajectory ring (or the cache) —
        for high-frequency machine readers like the fleet supervisor at
        auto-loop cadence.  The ring is sized for ~1-per-minute
        operator reads (``REL2_HISTORY``); a 5 s supervision loop
        appending to it would shrink the 30-minute capture-slide alarm
        window to minutes and mask a slow coordinated slide."""
        return fwsad_to_float(
            self.backend.call("get_second_pass_consensus_reliability")
        )

    def rel2_trend(self, window_s: float = 1800.0) -> Dict[str, Any]:
        """Trajectory summary of the second-pass reliability over the
        trailing ``window_s``: ``delta`` (latest − window start),
        ``falling`` (delta below −0.05 — the operator alarm condition:
        capture approaches as a rel₂ SLIDE, docs/ALGORITHM.md §5),
        ``n`` samples considered, and the ``history`` values."""
        with self._lock:
            samples = list(self.rel2_history)
        now = time.monotonic()
        window = [v for t, v in samples if now - t <= window_s]
        if len(window) < 2:
            return {"delta": 0.0, "falling": False, "n": len(window),
                    "history": window}
        delta = window[-1] - window[0]
        return {
            "delta": delta,
            "falling": delta < -0.05,
            "n": len(window),
            "history": window,
        }

    @_atomic
    def call_consensus_active(self) -> bool:
        v = bool(self.backend.call("consensus_active"))
        self.cache["consensus_active"] = v
        return v

    @_atomic
    def call_admin_list(self) -> List:
        v = self.backend.call("get_admin_list")
        self.cache["admin_list"] = v
        return v

    @_atomic
    def call_oracle_list(self) -> List:
        v = self.backend.call("get_oracle_list")
        self.cache["oracle_list"] = v
        return v

    @_atomic
    def call_dimension(self) -> int:
        v = int(self.backend.call("get_predictions_dimension"))
        self.cache["dimension"] = v
        return v

    @_atomic
    def call_replacement_propositions(self) -> List:
        v = self.backend.call("get_replacement_propositions")
        self.cache["replacement_propositions"] = v
        return v

    @_atomic
    def call_oracle_value_list(self, caller) -> List:
        """Admin-only raw dump, decoded: ``(address, [floats], enabled,
        reliable)`` per oracle (``client/contract.py:188-190``)."""
        v = [
            (addr, [fwsad_to_float(x) for x in vec], enabled, reliable)
            for addr, vec, enabled, reliable in self.backend.call_as(
                caller, "get_oracle_value_list"
            )
        ]
        self.cache["oracle_value_list"] = v
        return v

    @_atomic
    def call_oracle_value_list_wsad(self, caller) -> List:
        """Like :meth:`call_oracle_value_list` but with EXACT wsad ints
        (felt calldata two's-complement-decoded, no float round trip) —
        the console's ``wsad_to_string`` rendering needs the stored
        integer: ~28 % of wsad values lose an ulp through
        float-and-back, which truncated display turns into a whole
        wrong digit (0.007000 → '0.006')."""
        from svoc_torch.ops.fixedpoint import felt_to_wsad

        return [
            (addr, [felt_to_wsad(int(x)) for x in vec], enabled, reliable)
            for addr, vec, enabled, reliable in self.backend.call_as(
                caller, "get_oracle_value_list"
            )
        ]

    @_atomic
    def get_the_predictions(self) -> List[List[int]]:
        """The EXACT felt vectors currently stored on chain, one per
        oracle slot — the WAL reconciler's landed/stranded witness
        (docs/RESILIENCE.md §durability): a commit intent whose payload
        digest matches its slot's read landed before the crash; a
        mismatch means the slot still holds the previous block's value
        and the tx is stranded.  Admin-gated like
        ``get_oracle_value_list`` (the raw per-oracle dump is the only
        entrypoint that exposes stored values); bulk by design — the
        reconciler reads the fleet ONCE per cycle instead of paying
        two RPCs per slot.  Propagates chain errors — the reconciler
        classifies those as *unknown*, never as stranded."""
        admins = self.backend.call("get_admin_list")
        if not admins:
            raise RuntimeError("contract has no admins to read values as")
        rows = self.backend.call_as(admins[0], "get_oracle_value_list")
        return [[int(x) for x in vec] for _addr, vec, _en, _rel in rows]

    def get_the_prediction(self, slot: int) -> List[int]:
        """One slot of :meth:`get_the_predictions`; raises
        ``IndexError`` for an out-of-range slot."""
        rows = self.get_the_predictions()
        if not 0 <= int(slot) < len(rows):
            raise IndexError(f"slot {slot} outside [0, {len(rows)})")
        return rows[int(slot)]

    # -- index/address resolution (client/contract.py:95-123) --------------

    def address_to_oracle_index(self, address) -> int:
        return self.call_oracle_list().index(address)

    def oracle_index_to_address(self, index: int):
        return self.call_oracle_list()[index]

    def address_to_admin_index(self, address) -> int:
        return self.call_admin_list().index(address)

    def admin_index_to_address(self, index: int):
        return self.call_admin_list()[index]

    # -- writes (client/contract.py:200-264) -------------------------------

    @staticmethod
    def _count_rpc(mode: str, n: int = 1) -> None:
        """Commit-plane RPC accounting (``chain_commit_rpcs{mode=}``,
        process registry — ``bench_hotpath.py`` and ``make
        hotpath-smoke`` assert the batched plane pays 1 per claim-cycle
        where the tx plane pays N).  Lazy import: chain I/O must stay
        importable without the metrics plane."""
        from svoc_torch.utils.metrics import registry as _metrics

        _metrics.counter("chain_commit_rpcs", labels={"mode": mode}).add(n)

    @staticmethod
    def _count_fallback(reason: str) -> None:
        """The batched commit plane degrading is counted under the same
        family as retry.py's resume machinery
        (``commit_batch_fallback{reason=}``, docs/RESILIENCE.md
        §batched-commits) — fallbacks are counted, never silent."""
        from svoc_torch.utils.metrics import registry as _metrics

        _metrics.counter(
            "commit_batch_fallback", labels={"reason": reason}
        ).add(1)

    @_atomic
    def invoke_update_prediction(self, oracle_address, prediction) -> None:
        _fire_fault_point(
            "chain.tx.pre_invoke", payload={"fn": "update_prediction"}
        )
        self._count_rpc("tx")
        self.backend.invoke(
            oracle_address,
            "update_prediction",
            prediction=encode_vector(prediction),
        )

    #: Fleets at or above this size take the backend's batched commit
    #: when it has one (the local simulator); below it the per-tx loop
    #: keeps the reference's tx-granular interleaving observable.
    BATCH_COMMIT_THRESHOLD = 64

    def update_all_the_predictions(
        self,
        predictions: Sequence,
        *,
        batch: Optional[bool] = None,
        start: int = 0,
        skip: Sequence[int] = (),
        lineage: Optional[str] = None,
        on_intent: Optional[Callable[[int, Any, List[int]], None]] = None,
        on_landed: Optional[Callable[[int], None]] = None,
    ) -> int:
        """One signed tx per oracle, in oracle-list order
        (``client/contract.py:200-208``); returns the tx count *sent by
        this call*.

        Each account signs sequentially (its nonce space advances one tx
        at a time; the next oracle's tx is only submitted after the
        previous returned).  A failure mid-loop raises
        :class:`ChainCommitError` with the partial-commit count — the
        earlier transactions are on chain and are NOT rolled back.

        ``start`` resumes a partially-committed fleet: oracles before
        ``start`` are skipped (their txs are already on chain — see
        the reference's ``resilience/retry.py::commit_fleet_with_resume``).
        ``ChainCommitError.committed`` is always ABSOLUTE (the failed
        oracle's fleet index, counting the resumed prefix), so
        ``start=e.committed`` re-sends exactly the stranded suffix and
        never duplicates a landed tx.

        ``skip`` holds ABSOLUTE fleet indices whose tx must not be
        sent at all (the quarantine gate's refusals,
        docs/ROBUSTNESS.md): skipped slots are passed over without a
        transaction and WITHOUT counting into the returned tx count,
        while ``committed``/resume indices keep counting them as fleet
        positions — ``start=e.committed`` resume semantics are
        unchanged.  A non-empty ``skip`` forces the per-tx loop (the
        batched entrypoint commits a contiguous caller range).

        ``batch=None`` auto-selects the backend's batched fleet commit
        (same sequential semantics, O(1) golden recomputes — see
        :meth:`svoc_torch.consensus.state.OracleConsensusContract.update_predictions_batch`)
        when the remaining suffix is ≥ ``BATCH_COMMIT_THRESHOLD``;
        ``True``/``False`` force it on/off.

        ``lineage`` tags the ``commit`` stage span with the fleet
        block's lineage id (the reference's ``utils/events``) so the span is
        joinable into the block's audit record.

        ``on_intent(idx, oracle, felts)`` / ``on_landed(idx)`` are the
        commit-intent WAL's per-tx hooks (docs/RESILIENCE.md
        §durability): the intent hook runs IMMEDIATELY before each tx
        with the exact felt payload about to be signed, the landed hook
        immediately after the invoke returns.  Hooks force the per-tx
        loop (intent granularity IS the tx granularity).  A hook
        exception propagates unwrapped — a WAL that cannot persist the
        intent must stop the commit ("no durable intent, no tx"), and
        that is an infrastructure failure, not the oracle's.
        """
        from svoc_torch.utils.metrics import stage_span

        with stage_span("commit", lineage=lineage):
            return self._update_all_the_predictions(
                predictions, batch=batch, start=start, skip=skip,
                on_intent=on_intent, on_landed=on_landed,
            )

    @_atomic
    def _invoke_prediction_felts(self, oracle_address, felts: List[int]) -> None:
        """Pre-encoded twin of :meth:`invoke_update_prediction` — the
        WAL path encodes once, journals the felts, then signs the SAME
        payload (digest in the log must equal digest on the wire)."""
        # The signed-tx RPC boundary: an injected ``error`` here is the
        # transport fault the retry/resume machinery must absorb; a
        # ``kill`` leaves a durable intent whose tx never went out.
        _fire_fault_point(
            "chain.tx.pre_invoke", payload={"fn": "update_prediction"}
        )
        self._count_rpc("tx")
        self.backend.invoke(
            oracle_address, "update_prediction", prediction=felts
        )

    def update_predictions_batched(
        self,
        predictions: Sequence,
        *,
        start: int = 0,
        skip: Sequence[int] = (),
        lineage: Optional[str] = None,
        wal=None,
    ) -> int:
        """ONE chain RPC carrying the fleet's whole payload
        (docs/RESILIENCE.md §batched-commits): the batched commit plane
        behind ``commit_mode="batched"``.  Identical chain state,
        journal events, and failure accounting as the per-tx loop —
        only the RPC and WAL-record granularity change (N→1 and
        2N→2 per clean cycle).

        Raises :class:`BatchCommitUnsupported` — BEFORE any mutation or
        WAL record — when the plane cannot run as one RPC: the backend
        has no ``update_predictions_batched`` entrypoint (Sepolia's
        per-account signing, chaos wrappers) or ``skip`` holds
        quarantined slots (the batched entrypoint commits a contiguous
        caller range).  The caller counts the fallback
        (``commit_batch_fallback{reason=}``) and reruns per tx.

        ``wal`` (duck-typed as :class:`svoc_torch.durability.wal.WALCycle`): the
        cycle-open record already carries the full payload matrix, so
        ONE fsynced ``intent_batch`` covers the whole attempt before
        the RPC and one ``landed_batch`` records it after — on a
        mid-batch failure the applied prefix is recorded durably before
        the error propagates, and the restart reconciler classifies
        ``landed_batch`` slots exactly like per-tx ``landed`` ones.

        A mid-fleet failure raises :class:`ChainCommitError` with the
        per-tx path's exact accounting (``committed`` = absolute failed
        index, ``sent_count`` = txs this attempt landed); a malformed
        prediction is THAT tx's failure after the prefix commits, as in
        the per-tx loop.
        """
        skip_set = frozenset(int(i) for i in skip)
        if skip_set:
            raise BatchCommitUnsupported(
                "skip_slots",
                f"{len(skip_set)} quarantined slot(s) force tx granularity",
            )
        batched_invoke = getattr(
            self.backend, "update_predictions_batched", None
        )
        if batched_invoke is None:
            raise BatchCommitUnsupported(
                "unsupported", type(self.backend).__name__
            )
        from svoc_torch.utils.metrics import stage_span

        with stage_span("commit", lineage=lineage):
            oracles = self.call_oracle_list()
            total = min(len(oracles), len(predictions))
            if not 0 <= start <= total:
                raise ValueError(f"start={start} outside [0, {total}]")
            # Vectorized felt encode, per-tx error semantics: the first
            # malformed row truncates the batch — its prefix commits,
            # then the failure surfaces at that tx's absolute index
            # with the original codec exception as cause.
            encoded = encode_matrix(
                np.asarray(predictions, dtype=np.float64)[start:total],
                on_error="none",
            )
            felts: List[List[int]] = []
            codec_failure = None
            for t, row in enumerate(encoded, start=start):
                if row is None:
                    try:
                        encode_vector(predictions[t])
                        cause: Exception = ValueError(
                            "prediction has no felt encoding"
                        )
                    except Exception as e:  # noqa: BLE001 — the real codec error
                        cause = e
                    codec_failure = (t, cause)
                    break
                felts.append(row)
            slots = list(range(start, start + len(felts)))
            sent = 0
            if felts:
                if wal is not None:
                    # One durable intent for the whole batch ("no
                    # durable intent, no tx" at batch granularity); WAL
                    # append failures propagate unwrapped, before the
                    # RPC, exactly like the per-tx hook contract.
                    wal.intent_batch(slots)
                from svoc_torch.consensus.state import (
                    BatchNotCertified,
                    BatchTxError,
                )

                # The one-RPC boundary of the batched plane: the batch
                # intent is durable, the RPC has not gone out yet.
                _fire_fault_point(
                    "chain.batch.pre_rpc", payload={"n": len(felts)}
                )
                self._count_rpc("batch")
                # Bounded work on the local simulator (one certified
                # sweep, or the exact engine in-place for uncertifiable
                # batches) — held under the adapter lock like the
                # throughput batch path.
                with self._lock:
                    try:
                        sent = batched_invoke(
                            oracles[start : start + len(felts)], felts
                        )
                    except BatchNotCertified as e:
                        # A "raise"-mode backend refused BEFORE any
                        # mutation; the already-journaled batch intent
                        # is harmless (the reconciler digest-classifies
                        # intents without landed records).
                        raise BatchCommitUnsupported(
                            "uncertified", str(e)
                        ) from e
                    except BatchTxError as e:
                        if wal is not None and e.index > 0:
                            wal.landed_batch(slots[: e.index])
                        raise ChainCommitError(
                            committed=start + e.index,
                            total=total,
                            failed_oracle=e.oracle_address,
                            cause=e.cause,
                            sent_count=e.index,
                        ) from e
                if wal is not None:
                    wal.landed_batch(slots)
            if codec_failure is not None:
                t, cause = codec_failure
                raise ChainCommitError(
                    committed=start + sent,
                    total=total,
                    failed_oracle=oracles[t],
                    cause=cause,
                    sent_count=sent,
                ) from cause
            return sent

    def _update_all_the_predictions(
        self,
        predictions: Sequence,
        *,
        batch: Optional[bool] = None,
        start: int = 0,
        skip: Sequence[int] = (),
        on_intent: Optional[Callable[[int, Any, List[int]], None]] = None,
        on_landed: Optional[Callable[[int], None]] = None,
    ) -> int:
        oracles = self.call_oracle_list()
        total = min(len(oracles), len(predictions))
        if not 0 <= start <= total:
            raise ValueError(f"start={start} outside [0, {total}]")
        skip_set = frozenset(int(i) for i in skip)
        if skip_set and not all(0 <= i < total for i in skip_set):
            raise ValueError(f"skip indices {sorted(skip_set)} outside [0, {total})")
        batched_invoke = getattr(
            self.backend, "invoke_update_predictions_batch", None
        )
        wal_hooks = on_intent is not None or on_landed is not None
        if batch is None:
            batch = (
                not skip_set
                and not wal_hooks
                and batched_invoke is not None
                and total - start >= self.BATCH_COMMIT_THRESHOLD
            )
        if batch and skip_set:
            raise ValueError(
                "batch commit cannot skip slots (contiguous caller "
                "range) — use batch=False with skip"
            )
        if batch and wal_hooks:
            raise ValueError(
                "batch commit cannot journal per-tx intents — use "
                "batch=False with on_intent/on_landed"
            )
        if batch:
            if batched_invoke is None:
                raise ValueError(
                    "backend has no batched commit (Sepolia submits one "
                    "signed tx per oracle) — use batch=False"
                )
            from svoc_torch.consensus.state import BatchNotCertified, BatchTxError

            # Per-tx codec semantics: a malformed prediction (NaN, junk)
            # is THAT tx's failure after the prefix commits, exactly as
            # in the per-tx loop — not a whole-batch abort.  Indices
            # here are ABSOLUTE fleet positions (the resumed prefix
            # counts), matching ChainCommitError's accounting.
            felts = []
            codec_failure = None
            for t, p in enumerate(predictions[start:total], start=start):
                try:
                    felts.append(encode_vector(p))
                except Exception as e:
                    codec_failure = (t, e)
                    break
            self._count_rpc("batch")
            # The fast path is bounded work (one device sweep + one
            # golden recompute) — safe to hold the adapter lock for.
            # An UNCERTIFIED batch raises before any mutation, and the
            # O(N)-golden-recompute fallback runs through the ordinary
            # per-tx loop below instead, which locks per transaction —
            # a long commit must never monopolize the adapter
            # (the _atomic design note).
            fell_through = False
            with self._lock:
                try:
                    committed = batched_invoke(
                        oracles[start : start + len(felts)], felts
                    )
                except BatchTxError as e:
                    raise ChainCommitError(
                        committed=start + e.index,
                        total=total,
                        failed_oracle=e.oracle_address,
                        cause=e.cause,
                        sent_count=e.index,
                    ) from e
                except BatchNotCertified:
                    # counted, never silent: the throughput batch path
                    # degrading to the exact per-tx loop is the same
                    # contract surface as retry.py's resume machinery
                    self._count_fallback("uncertified")
                    fell_through = True  # exact per-tx loop below
            if not fell_through:
                if codec_failure is not None:
                    t, cause = codec_failure
                    raise ChainCommitError(
                        committed=start + committed,
                        total=total,
                        failed_oracle=oracles[t],
                        cause=cause,
                        sent_count=committed,
                    ) from cause
                return committed
        n = 0
        for idx in range(start, total):
            if idx in skip_set:
                continue  # quarantined slot: no tx, no count
            oracle, prediction = oracles[idx], predictions[idx]
            felts = None
            if wal_hooks:
                # Encode BEFORE the intent hook: a codec failure is
                # this tx's failure (as on the plain path) and must not
                # leave a journaled intent for a payload that can never
                # be signed.
                try:
                    felts = encode_vector(prediction)
                except Exception as e:
                    raise ChainCommitError(
                        committed=idx,
                        total=total,
                        failed_oracle=oracle,
                        cause=e,
                        sent_count=n,
                    ) from e
                if on_intent is not None:
                    on_intent(idx, oracle, felts)  # WAL errors propagate
            try:
                if felts is not None:
                    self._invoke_prediction_felts(oracle, felts)
                else:
                    self.invoke_update_prediction(oracle, prediction)
            except ChainCommitError:
                raise
            except Exception as e:
                raise ChainCommitError(
                    committed=idx,
                    total=total,
                    failed_oracle=oracle,
                    cause=e,
                    sent_count=n,
                ) from e
            if on_landed is not None:
                on_landed(idx)
            n += 1
        return n

    @_atomic
    def invoke_update_proposition(
        self,
        admin_address,
        old_oracle_index: Optional[int] = None,
        new_oracle_address: Optional[int] = None,
    ) -> None:
        if (old_oracle_index is None) != (new_oracle_address is None):
            raise ValueError(
                "old_oracle_index and new_oracle_address must be both set "
                "or both None"
            )
        proposition = (
            None
            if old_oracle_index is None
            else (old_oracle_index, new_oracle_address)
        )
        self.backend.invoke(
            admin_address, "update_proposition", proposition=proposition
        )

    @_atomic
    def invoke_vote_for_a_proposition(
        self, admin_address, which_admin: int, support: bool
    ) -> None:
        self.backend.invoke(
            admin_address,
            "vote_for_a_proposition",
            which_admin=which_admin,
            support_his_proposition=support,
        )

    def resume(self) -> Dict[str, Any]:
        """Composite chain read-back (the ``resume`` command,
        ``client/web_interface.py:205-225``): refresh every cached view."""
        self.call_consensus_active()
        self.call_consensus()
        self.call_first_pass_consensus_reliability()
        self.call_second_pass_consensus_reliability()
        self.call_skewness()
        self.call_kurtosis()
        self.call_admin_list()
        self.call_oracle_list()
        self.call_dimension()
        try:
            self.call_replacement_propositions()
        except ContractError:
            # Contract deployed with replacement disabled; anything else
            # (RPC failures, codec bugs) propagates like the other reads.
            self.cache["replacement_propositions"] = None
        return self.cache_snapshot()
