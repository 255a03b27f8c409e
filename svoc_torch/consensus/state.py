"""Stateful oracle-consensus contract simulator.

Mirrors :mod:`svoc_tpu.consensus.state` (``state.py:28-571``:
``OracleConsensusContract``, ``ContractError``, ``BatchTxError``,
``BatchNotCertified``, ``OracleInfo``, the replacement vote).  A pure
Python state machine in place of the Starknet test VM, every transition
as in ``contract/src/contract.cairo``:

- constructor calldata layout (``contract.cairo:236-265``);
- per-oracle prediction updates behind the activation gate: the
  consensus is recomputed once **all** oracles have committed, then on
  every commit (``contract.cairo:331-343`` and ``:447-449``);
- the constrained input interval check (``contract.cairo:589-593``);
- caller access control ('not an oracle', 'not an admin', 'not admin');
- the admins' replacement vote: the A×A vote matrix, proposition
  resets, the majority check and the in-place address swap
  (``contract.cairo:547-580``, ``:661-738``).

Numeric state is exact wsad ints from
:mod:`svoc_torch.consensus.wsad_engine`; ``as_floats=True`` getters give
real-valued views.

The batched fleet commit
(:meth:`OracleConsensusContract.update_predictions_batch`) certifies its
intermediate recomputes with
:func:`svoc_torch.consensus.batch.prefix_margins_sweep` on the
contract's ``device``: ``None`` means CUDA and raises without a card
(:func:`svoc_torch.device.resolve_device`).  It is resolved at the first
sweep, so the golden-only paths (the per-tx loop, batches under the
gate, a reliable subset of at most 3) never need a device.  There is no
CPU fallback; the tests pass ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

import torch

from svoc_torch.consensus import wsad_engine as eng
from svoc_torch.device import resolve_device
from svoc_torch.ops.fixedpoint import WSAD, felt_to_wsad, from_wsad, to_wsad

Address = Hashable
Proposition = Optional[Tuple[int, Address]]


class ContractError(AssertionError):
    """A failed contract assert (the Cairo short-string panic message)."""


class BatchTxError(Exception):
    """Transaction ``index`` of a batched commit failed; txs before it
    ARE applied (sequential chain semantics — no batch rollback)."""

    def __init__(self, index: int, oracle_address, cause: BaseException):
        self.index = index
        self.oracle_address = oracle_address
        self.cause = cause
        super().__init__(
            f"batch tx {index} (oracle {oracle_address!r}) failed: {cause}"
        )


class BatchNotCertified(Exception):
    """The batch cannot take the fast path (device certification failed,
    duplicate callers, or a too-small reliable subset).  Raised BEFORE
    any state mutation, so the caller can rerun the exact per-tx loop
    from a clean slate."""


@dataclass
class OracleInfo:
    """``OracleInfo`` storage struct (``contract.cairo:73-78``)."""

    address: Address
    enabled: bool = False  # has a value?
    reliable: bool = True  # passes the consensus?
    value: List[int] = field(default_factory=list)  # wsad vector


class OracleConsensusContract:
    """In-memory ``OracleConsensusNDS`` (``contract.cairo:38-832``).
    ``device`` is where the batched commit's certification sweep runs
    (``None``: CUDA, resolved at the first sweep)."""

    def __init__(
        self,
        admins: Sequence[Address],
        oracles: Sequence[Address],
        *,
        enable_oracle_replacement: bool = True,
        required_majority: int = 2,
        n_failing_oracles: int = 2,
        constrained: bool = True,
        unconstrained_max_spread: float = 0.0,
        dimension: int = 2,
        strict_interval: bool = True,
        device: "str | torch.device | None" = None,
    ):
        self.device = device
        self.admins = list(admins)
        self.oracles = [
            OracleInfo(address=a, value=[0] * dimension) for a in oracles
        ]
        self.enable_oracle_replacement = enable_oracle_replacement
        self.required_majority = required_majority
        self.n_failing_oracles = n_failing_oracles
        self.constrained = constrained
        self.unconstrained_max_spread = to_wsad(unconstrained_max_spread)
        self.dimension = dimension
        self.strict_interval = strict_interval

        self.n_active_oracles = 0
        self.consensus_active = False
        self.consensus_value: List[int] = [0] * dimension
        self.reliability_first_pass = 0
        self.reliability_second_pass = 0
        self.skewness: List[int] = [0] * dimension
        self.kurtosis: List[int] = [0] * dimension

        n_admins = len(self.admins)
        self.vote_matrix: Dict[Tuple[int, int], bool] = {
            (i, j): False for i in range(n_admins) for j in range(n_admins)
        }
        self.replacement_propositions: List[Proposition] = [None] * n_admins
        self._oracle_index_map: Optional[Dict[Address, int]] = None

    # -- lookup helpers (contract.cairo:505-540) ---------------------------

    def _find_oracle_index(self, address: Address) -> Optional[int]:
        # Cairo's linear scan, memoized (first match wins like the scan;
        # rebuilt on replacement swaps) — a 1024-oracle commit cycle is
        # otherwise O(N²) in lookups alone.
        if self._oracle_index_map is None:
            m: Dict[Address, int] = {}
            for i, o in enumerate(self.oracles):
                m.setdefault(o.address, i)
            self._oracle_index_map = m
        return self._oracle_index_map.get(address)

    def _find_admin_index(self, address: Address) -> Optional[int]:
        for i, a in enumerate(self.admins):
            if a == address:
                return i
        return None

    def _require_admin(self, caller: Address) -> int:
        idx = self._find_admin_index(caller)
        if idx is None:
            raise ContractError("not an admin")
        return idx

    # -- prediction path (contract.cairo:588-603) --------------------------

    def update_prediction(
        self, caller: Address, prediction: Sequence, *, encoding: str = "float"
    ) -> None:
        """Commit one oracle's prediction vector.

        ``encoding``: "float" (real units), "wsad" (scaled ints), or
        "felt" (felt252 two's-complement calldata as sent on chain).
        """
        idx, wsad_pred = self._validate_one(caller, prediction, encoding)
        self._update_consensus(idx, wsad_pred)

    def _validate_one(
        self, caller: Address, prediction: Sequence, encoding: str
    ) -> Tuple[int, List[int]]:
        """One tx's decode + checks, in the contract's order — shared by
        the single-tx and batched paths so they cannot drift."""
        wsad_pred = self._decode_one(prediction, encoding)
        if len(wsad_pred) != self.dimension:
            raise ContractError("wrong dimension")
        if self.constrained:
            eng.nd_interval_check(wsad_pred)
        idx = self._find_oracle_index(caller)
        if idx is None:
            raise ContractError("not an oracle")
        return idx, wsad_pred

    def _golden_recompute(self, values: List[List[int]]) -> Dict:
        """The exact big-int two-pass consensus with THIS contract's
        configuration — the one engine call every commit path shares."""
        return eng.two_pass_consensus(
            values,
            constrained=self.constrained,
            n_failing=self.n_failing_oracles,
            max_spread=self.unconstrained_max_spread,
            strict_interval=self.strict_interval,
        )

    def _update_consensus(self, oracle_index: int, prediction: List[int]) -> None:
        # update_a_single_oracle (contract.cairo:331-343)
        info = self.oracles[oracle_index]
        prev = (info.enabled, info.value, self.n_active_oracles)
        if not info.enabled:
            self.n_active_oracles += 1
        info.enabled = True
        info.value = list(prediction)

        # activation gate (contract.cairo:447-449 / :375-377)
        if self.n_active_oracles != len(self.oracles):
            return

        try:
            result = self._golden_recompute([o.value for o in self.oracles])
        except Exception:
            # Any Cairo panic (interval error, division by zero in the
            # n<4 moment formulas, ...) reverts the whole transaction,
            # including the single-oracle update above — restore it
            # before re-raising.
            info.enabled, info.value, self.n_active_oracles = prev
            raise
        self._write_consensus_result(result)

    # -- batched fleet commit (svoc_torch.consensus.batch) ------------------

    def _decode_one(self, prediction: Sequence, encoding: str) -> List[int]:
        if encoding == "float":
            return [to_wsad(float(x)) for x in prediction]
        if encoding == "wsad":
            return [int(x) for x in prediction]
        if encoding == "felt":
            return [felt_to_wsad(int(x)) for x in prediction]
        raise ValueError(f"unknown encoding {encoding!r}")

    def update_predictions_batch(
        self,
        callers: Sequence[Address],
        predictions: Sequence[Sequence],
        *,
        encoding: str = "float",
        on_uncertified: str = "sequential",
    ) -> int:
        """Commit one tx per (caller, prediction) pair in order, with the
        EXACT final state and panic behavior of calling
        :meth:`update_prediction` sequentially, in O(1) golden-engine
        recomputes instead of O(len(callers)).

        How: intermediate recomputes only write derived state that the
        next recompute overwrites, so they are unobservable from outside
        the batch unless they *panic*; a device-side float sweep
        (:mod:`svoc_torch.consensus.batch`) certifies every intermediate
        state sits outside the exact engine's panic surfaces by a guard
        band, and the final block goes through the golden big-int engine
        untouched.  Uncertifiable batches (degenerate fleets, near-ties
        at the reliability cut, duplicate callers, reliable subsets ≤ 3
        whose moment denominators hit zero) take the exact sequential
        path instead: in-place when ``on_uncertified="sequential"``
        (slower, never wrong), or by raising :class:`BatchNotCertified`
        BEFORE any state mutation when ``on_uncertified="raise"`` so the
        caller can rerun its own per-tx loop (the chain adapter uses
        this to avoid holding its lock across O(N) golden recomputes).

        Raises :class:`BatchTxError` when tx ``index`` fails; txs before
        it are applied (chain semantics, ``client/contract.py:200-208``
        has no rollback).  Returns the tx count on full success.
        """
        if encoding not in ("float", "wsad", "felt"):
            raise ValueError(f"unknown encoding {encoding!r}")
        if on_uncertified not in ("sequential", "raise"):
            raise ValueError(f"unknown on_uncertified {on_uncertified!r}")
        txs = list(zip(callers, predictions))
        total = len(txs)
        if total == 0:
            return 0

        def uncertified(reason: str) -> int:
            if on_uncertified == "raise":
                raise BatchNotCertified(reason)
            return self._sequential_batch(decoded, indices, pending)

        # Per-tx validation in update_prediction's order; the first
        # failure truncates the batch (prefix still commits, then the
        # error surfaces with its tx index).  Everything a tx raises —
        # including codec errors from malformed elements — is that TX's
        # failure, exactly as in the sequential loop.
        decoded: List[List[int]] = []
        indices: List[int] = []
        pending: Optional[BatchTxError] = None
        seen = set()
        has_duplicates = False
        for t, (caller, prediction) in enumerate(txs):
            try:
                idx, wsad_pred = self._validate_one(
                    caller, prediction, encoding
                )
            except Exception as e:
                pending = BatchTxError(t, caller, e)
                break
            if idx in seen:
                has_duplicates = True
            seen.add(idx)
            decoded.append(wsad_pred)
            indices.append(idx)

        T = len(decoded)

        def finish(committed: int) -> int:
            if pending is not None:
                raise pending
            return committed

        if T == 0:
            return finish(0)
        if has_duplicates:
            return uncertified("duplicate caller")

        # Activation trajectory: tx k triggers a recompute iff all
        # oracles are enabled after it (contract.cairo:447-449).
        n_active = self.n_active_oracles
        first_recompute = None  # 1-based prefix length
        enabled_now = {i for i, o in enumerate(self.oracles) if o.enabled}
        for k, idx in enumerate(indices, start=1):
            if idx not in enabled_now:
                enabled_now.add(idx)
                n_active += 1
            if first_recompute is None and n_active == len(self.oracles):
                first_recompute = k

        if first_recompute is None:
            # Gate never opens: plain value writes, no consensus.
            for idx, pred in zip(indices, decoded):
                info = self.oracles[idx]
                if not info.enabled:
                    self.n_active_oracles += 1
                info.enabled = True
                info.value = list(pred)
            return finish(T)

        # Moment denominators (n-1)(n-2) / (n-2)(n-3) hit zero when the
        # reliable subset N - n_failing is ≤ 3: EVERY recompute panics
        # (math.cairo:336/:358) — a surface the float sweep does not
        # model, so take the exact path.
        if len(self.oracles) - self.n_failing_oracles <= 3:
            return uncertified("reliable subset <= 3")

        # Certify the intermediate recomputes (prefixes
        # first_recompute..T-1) on the device in one fused sweep.
        inter_ks = list(range(first_recompute, T))
        if inter_ks:
            from svoc_torch.consensus import batch as dev

            cfg = dev.ConsensusConfig(
                n_failing=self.n_failing_oracles,
                constrained=self.constrained,
                max_spread=from_wsad(self.unconstrained_max_spread),
                smooth_mode="cairo",
            )
            old = np.array(
                [[from_wsad(x) for x in o.value] for o in self.oracles],
                dtype=np.float32,
            )
            new = old.copy()
            pos = np.full(len(self.oracles), T + 1, dtype=np.int32)
            for t, (idx, pred) in enumerate(zip(indices, decoded)):
                new[idx] = [from_wsad(x) for x in pred]
                pos[idx] = t
            # The f32 guard-band error analysis (batch.CertifyMargins)
            # assumes O(1)-magnitude values; constrained contracts are
            # interval-checked into [0,1], but unconstrained values are
            # unbounded and large magnitudes inflate float quantization
            # past the bands (eps(16)·ulp² still clears them ~10×).
            if float(max(np.max(np.abs(old)), np.max(np.abs(new)))) > 16.0:
                return uncertified("value magnitude beyond f32 guard bands")
            # Bucket the prefix count to a power of two (min 8) by
            # repeating the final prefix, as the reference does to bound
            # its compiles; a repeated prefix has identical margins, so
            # the all() over `safe` below is unchanged.
            k_bucket = 8
            while k_bucket < len(inter_ks):
                k_bucket *= 2
            padded_ks = inter_ks + [inter_ks[-1]] * (k_bucket - len(inter_ks))
            device = resolve_device(self.device)
            margins = dev.prefix_margins_sweep(
                torch.from_numpy(old).to(device),
                torch.from_numpy(new).to(device),
                torch.from_numpy(pos).to(device),
                cfg,
                torch.tensor(padded_ks, dtype=torch.int32, device=device),
            )
            safe = dev.certify(margins, cfg, self.strict_interval)
            if not bool(np.all(safe)):
                return uncertified("device certification failed")

        # Fast path: apply everything, one golden recompute at the end.
        applied_prev = []
        for idx, pred in zip(indices, decoded):
            info = self.oracles[idx]
            applied_prev.append((idx, info.enabled, info.value))
            if not info.enabled:
                self.n_active_oracles += 1
            info.enabled = True
            info.value = list(pred)
        try:
            result = self._golden_recompute([o.value for o in self.oracles])
        except Exception as e:
            # Only the FINAL tx's recompute can panic (intermediates are
            # certified) — revert that one tx, and re-derive the state
            # the sequential loop would have left behind: the certified
            # prefix-(T-1) recompute, when there was one.
            idx, was_enabled, old_value = applied_prev[-1]
            info = self.oracles[idx]
            if not was_enabled:
                self.n_active_oracles -= 1
            info.enabled, info.value = was_enabled, old_value
            if first_recompute <= T - 1:
                try:
                    self._write_consensus_result(
                        self._golden_recompute(
                            [o.value for o in self.oracles]
                        )
                    )
                except Exception:
                    # Unreachable when certification is sound; never let
                    # a re-derive failure mask the tx error and its
                    # partial-commit accounting.  Derived state stays
                    # pre-batch — still a valid past consensus.
                    pass
            raise BatchTxError(T - 1, txs[T - 1][0], e) from e
        self._write_consensus_result(result)
        return finish(T)

    def _write_consensus_result(self, result: Dict) -> None:
        for o, ok in zip(self.oracles, result["reliable"]):
            o.reliable = ok
        self.consensus_value = result["essence"]
        self.reliability_first_pass = result["reliability_first_pass"]
        self.reliability_second_pass = result["reliability_second_pass"]
        self.skewness = result["skewness"]
        self.kurtosis = result["kurtosis"]
        self.consensus_active = True

    def _sequential_batch(
        self,
        decoded: List[List[int]],
        indices: List[int],
        pending: Optional[BatchTxError],
    ) -> int:
        """Exact per-tx fallback (identical to looping update_prediction)."""
        for t, (idx, pred) in enumerate(zip(indices, decoded)):
            try:
                self._update_consensus(idx, pred)
            except Exception as e:
                raise BatchTxError(t, self.oracles[idx].address, e) from e
        if pending is not None:
            raise pending
        return len(decoded)

    # -- replacement votes (contract.cairo:547-580, :661-738) --------------

    def update_proposition(self, caller: Address, proposition: Proposition) -> None:
        if not self.enable_oracle_replacement:
            raise ContractError("replacement disabled")
        admin_index = self._require_admin(caller)

        if proposition is None:
            self.replacement_propositions[admin_index] = None
            return

        old_oracle_index, new_oracle_address = proposition
        if not (0 <= old_oracle_index < len(self.oracles)):
            raise ContractError("wrong old oracle index")
        if self._find_oracle_index(new_oracle_address) is not None:
            raise ContractError("the oracle is already in the team")

        # Changing a proposition forfeits collected votes, then self-vote
        # (contract.cairo:687-712).
        for i in range(len(self.admins)):
            self.vote_matrix[(i, admin_index)] = False
        self.vote_matrix[(admin_index, admin_index)] = True
        self.replacement_propositions[admin_index] = (
            old_oracle_index,
            new_oracle_address,
        )

    def vote_for_a_proposition(
        self, caller: Address, which_admin: int, support: bool
    ) -> None:
        if not self.enable_oracle_replacement:
            raise ContractError("replacement disabled")
        voter_index = self._require_admin(caller)
        self.vote_matrix[(voter_index, which_admin)] = support
        self._check_for_replacement(which_admin)

    def _check_for_replacement(self, which_proposition: int) -> None:
        # Cairo's vote matrix is a LegacyMap with default-false reads, so
        # an out-of-range target column just counts the single vote that
        # was written (contract.cairo:549-564) — .get mirrors that.
        n_admins = len(self.admins)
        n_votes = sum(
            1
            for i in range(n_admins)
            if self.vote_matrix.get((i, which_proposition), False)
        )
        if self.required_majority > n_votes:
            return
        # LegacyMap<usize, Option> reads default to None out of range;
        # guard against Python negative-index wrap-around too.
        proposition = (
            self.replacement_propositions[which_proposition]
            if 0 <= which_proposition < n_admins
            else None
        )
        # Cairo unwraps unconditionally (contract.cairo:572) — voting a
        # majority onto an empty proposition panics there too.
        if proposition is None:
            raise ContractError("Option::unwrap failed")
        which_oracle, new_address = proposition
        # Only the address is swapped; enabled/reliable/value persist
        # (contract.cairo:573-576).
        self.oracles[which_oracle].address = new_address
        self._oracle_index_map = None
        self.replacement_propositions = [None] * n_admins
        self.vote_matrix = {
            (i, j): False for i in range(n_admins) for j in range(n_admins)
        }

    # -- getters (contract.cairo:605-830) ----------------------------------

    def get_consensus_value(self, as_floats: bool = False):
        v = list(self.consensus_value)
        return [from_wsad(x) for x in v] if as_floats else v

    def get_first_pass_consensus_reliability(self, as_floats: bool = False):
        r = self.reliability_first_pass
        return from_wsad(r) if as_floats else r

    def get_second_pass_consensus_reliability(self, as_floats: bool = False):
        r = self.reliability_second_pass
        return from_wsad(r) if as_floats else r

    def get_skewness(self, as_floats: bool = False):
        return [from_wsad(x) for x in self.skewness] if as_floats else list(
            self.skewness
        )

    def get_kurtosis(self, as_floats: bool = False):
        return [from_wsad(x) for x in self.kurtosis] if as_floats else list(
            self.kurtosis
        )

    def get_admin_list(self) -> List[Address]:
        return list(self.admins)

    def get_oracle_list(self) -> List[Address]:
        return [o.address for o in self.oracles]

    def get_oracle_value_list(self, caller: Address):
        """Admin-only raw dump (``contract.cairo:772-798``)."""
        if self._find_admin_index(caller) is None:
            raise ContractError("not admin")
        return [
            (o.address, list(o.value), o.enabled, o.reliable) for o in self.oracles
        ]

    def get_replacement_propositions(self) -> List[Proposition]:
        if not self.enable_oracle_replacement:
            raise ContractError("replacement disabled")
        return list(self.replacement_propositions)

    def get_a_specific_proposition(self, which_admin: int) -> Proposition:
        if not self.enable_oracle_replacement:
            raise ContractError("replacement disabled")
        # LegacyMap<usize, Option> reads default to None out of range
        # (and Python's negative-index wrap-around must not leak).
        if not 0 <= which_admin < len(self.admins):
            return None
        return self.replacement_propositions[which_admin]

    def get_predictions_dimension(self) -> int:
        return self.dimension

    @property
    def wsad(self) -> int:
        return WSAD
