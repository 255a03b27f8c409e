"""The mesh runner, and the oracle-sharded consensus and fleet step.

Mirrors :mod:`svoc_tpu.parallel.sharded` (``sharded.py:1-332``:
``shard_map``, ``consensus_out_specs``, ``_consensus_body``,
``sharded_consensus_fn``, ``_fleet_body``, ``fleet_consensus_shard_map``,
``sharded_fleet_step_fn``).

**The runner.**  :func:`shard_map` is the single-controller counterpart
of ``jax.shard_map`` (:mod:`svoc_torch.parallel.mesh` says why the port's
mesh is single-controller): it splits each input by its :class:`P` spec
and runs the body once per slot, on that slot's device, so every kernel
a body calls launches on its slot's tensors' device
(``ops/_build.py::launch``).  Inside the body, :func:`axis_index`,
:func:`axis_size`, :func:`all_gather` (concatenate in axis-index order),
:func:`psum` (add the partials in axis-index order) and :func:`ppermute`
(each slot gets its source's piece) are plain tensor ops across the
slots of the body's group (the slots that differ only along the named
axis), so autograd follows them from slot to slot.  Outputs are assembled by their specs on the
mesh's first slot's device; an axis an output spec leaves out is
replicated, and the slot at index 0 along it gives the value.

How the slots run:

- An axis that no input or output spec names carries nothing the body
  could tell apart, so the body runs once along it, on the slot at
  index 0; a collective over such an axis raises.  So a claim-sharded
  dispatch on a ``"2x4"`` mesh runs its body twice, once a claim shard,
  and the oracle-axis slots share that result
  (:mod:`svoc_torch.parallel.claim_shard`).
- With ``collectives=False`` the slots run one after another on the
  caller's thread, and any collective raises: the form of a body with no
  cross-slot math (the claim shard's exact-parity contract).
- Otherwise each running slot gets a thread (long-lived ones, kept
  idle between runs: a fresh thread pays for CUDA's per-thread setup),
  and the threads run in lockstep: one at a time, in slot order, each up to its next
  collective, so the collective of round *r* reads every slot's
  contribution to round *r*.  The work is as serial as the caller's
  (kernel launches and launch counters see one slot at a time, in slot
  order); each thread takes the caller's grad and inference modes and
  its current stream on every device of the mesh.

No path falls back to an unsharded run: a spec that does not divide its
dimension raises.

**The bodies** are XLA in the reference, not Pallas, so plain torch ops
on the slot's device are their port.  The psum body adds float64
partials in slot order and rounds each sum once to float32, which is not
XLA's float32 all-reduce bit for bit: it is held to the reference at
``tests/test_parallel.py``'s bars (rtol 1e-5; skewness and kurtosis rtol
1e-4, atol 1e-5).  The fleet body keys
every oracle by its global index (:func:`oracle_rows`), so the fleet is
bitwise the same however the mesh splits it.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from svoc_torch.consensus.kernel import ConsensusConfig, ConsensusOutput, reliability
from svoc_torch.ops import sort as sort_ops
from svoc_torch.ops import stats
from svoc_torch.parallel.mesh import Mesh, NamedSharding, P, ShardedArray
from svoc_torch.robustness.sanitize import quarantine_mask
from svoc_torch.sim import prng

# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

_local = threading.local()


class _Aborted(Exception):
    """Another slot raised; this one unwinds."""


class _Lockstep:
    """Runs the slot threads one at a time, in slot order, handing the
    turn on at every collective and at the body's end; a collective's
    contributions are kept by call number.  Each slot waits on an event
    of its own, so a handoff wakes the next slot alone."""

    def __init__(self, n: int):
        self.n = n
        self.lock = threading.Lock()
        self.wake = [threading.Event() for _ in range(n)]
        self.wake[0].set()
        self.done = [False] * n
        self.error: Optional[BaseException] = None
        self.deposits: Dict[int, Dict[int, Any]] = {}

    def wait_turn(self, k: int) -> None:
        self.wake[k].wait()
        self.wake[k].clear()
        if self.error is not None:
            raise _Aborted()

    def pass_turn(self, k: int, finished: bool = False) -> None:
        with self.lock:
            self.done[k] = self.done[k] or finished
            nxt = (k + 1) % self.n
            for _ in range(self.n):
                if not self.done[nxt]:
                    break
                nxt = (nxt + 1) % self.n
        self.wake[nxt].set()

    def fail(self, error: BaseException) -> None:
        with self.lock:
            if self.error is None:
                self.error = error
        for event in self.wake:
            event.set()


class _SlotContext:
    __slots__ = ("mesh", "coords", "index", "device", "mapped", "lockstep", "calls", "slot_of")

    def __init__(self, mesh, coords, index, mapped, lockstep, slot_of):
        self.mesh = mesh
        self.coords = coords
        self.index = index
        self.device = mesh.devices[tuple(coords[a] for a in mesh.axis_names)]
        self.mapped = mapped
        self.lockstep = lockstep
        self.calls = 0
        self.slot_of = slot_of


def _context() -> _SlotContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError("mesh collectives run only inside a shard_map body")
    return ctx


def _check_axis(ctx: _SlotContext, axis: str) -> None:
    if axis not in ctx.mesh.shape:
        raise ValueError(f"axis {axis!r} is not an axis of {ctx.mesh}")
    if axis not in ctx.mapped:
        raise ValueError(
            f"axis {axis!r} is named by no spec of this shard_map, so its body runs once along it; "
            "name the axis in a spec to use it in the body"
        )


def axis_index(axis: str) -> int:
    """This slot's index along ``axis`` (``jax.lax.axis_index``)."""
    ctx = _context()
    _check_axis(ctx, axis)
    return ctx.coords[axis]


def axis_size(axis: str) -> int:
    """The size of ``axis`` (``jax.lax.psum(1, axis)``)."""
    ctx = _context()
    _check_axis(ctx, axis)
    return ctx.mesh.shape[axis]


def current_device() -> torch.device:
    """The device of the slot whose body is running."""
    return _context().device


def _exchange(axis: str, value) -> List[Any]:
    """Every contribution of this slot's group to this collective, in
    axis-index order."""
    ctx = _context()
    _check_axis(ctx, axis)
    size = ctx.mesh.shape[axis]
    if size == 1:
        return [value]
    lockstep = ctx.lockstep
    if lockstep is None:
        raise RuntimeError(f"a collective over {axis!r} in a shard_map run with collectives=False")
    call = ctx.calls
    ctx.calls += 1
    with lockstep.lock:
        lockstep.deposits.setdefault(call, {})[ctx.index] = value
    lockstep.pass_turn(ctx.index)
    lockstep.wait_turn(ctx.index)
    peers = []
    for i in range(size):
        coords = dict(ctx.coords, **{axis: i})
        slot = ctx.slot_of[tuple(coords[a] for a in ctx.mesh.axis_names)]
        got = lockstep.deposits.get(call, {})
        if slot not in got:
            raise RuntimeError(f"slot {coords} did not reach collective {call} over {axis!r}")
        peers.append(got[slot])
    return peers


def all_gather(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """The group's pieces concatenated along ``dim`` in axis-index order,
    on this slot's device (``jax.lax.all_gather(..., tiled=True)``)."""
    dev = current_device()
    return torch.cat([p.to(dev) for p in _exchange(axis, x)], dim=dim)


def psum(x, axis: str):
    """The group's partials added in axis-index order, on this slot's
    device (``jax.lax.psum``).  Python numbers add as numbers."""
    peers = _exchange(axis, x)
    if not isinstance(x, torch.Tensor):
        return sum(peers[1:], peers[0])
    dev = current_device()
    total = peers[0].to(dev)
    for p in peers[1:]:
        total = total + p.to(dev)
    return total


def ppermute(x, axis: str, perm):
    """``jax.lax.ppermute``: ``perm`` lists ``(source, destination)``
    pairs of indices along ``axis``; each slot gets what its source
    passed, on its own device, and a slot that no pair names as a
    destination gets zeros.  ``x`` is a tensor or a tuple or list of
    them, sent in one exchange.  The copy is a differentiable
    ``.to(device)`` (no copy between slots of one device), so autograd
    carries a gradient back to the source slot."""
    ctx = _context()
    _check_axis(ctx, axis)
    size = ctx.mesh.shape[axis]
    pairs = [(int(src), int(dst)) for src, dst in perm]
    sources, dests = [p[0] for p in pairs], [p[1] for p in pairs]
    if len(set(sources)) < len(sources) or len(set(dests)) < len(dests) or not all(
            0 <= i < size for i in sources + dests):
        raise ValueError(f"perm {perm} is not a partial permutation of the {size} indices of {axis!r}")
    peers = _exchange(axis, x)
    src = dict((d, s) for s, d in pairs).get(ctx.coords[axis])
    dev = current_device()
    if src is None:
        return _map_tensors(torch.zeros_like, x)
    return _map_tensors(lambda t: t.to(dev), peers[src])


def _map_tensors(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(fn(t) for t in x)
    return fn(x)


def to_slot(tree):
    """Every tensor of a (nested) dict on the running slot's device: a
    replicated parameter tree passed with ``P()`` arrives as the caller
    holds it."""
    dev = current_device()
    if isinstance(tree, dict):
        return {k: to_slot(v) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _spec_axes(tree) -> set:
    if isinstance(tree, P):
        return {a for a in tree if a is not None}
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, (tuple, list)):
        return set().union(*(_spec_axes(t) for t in tree)) if tree else set()
    raise TypeError(f"not a spec tree: {tree!r}")


def _local_input(mesh: Mesh, spec, x, coords: dict):
    """A slot's piece of one input.  A dict of specs splits a dict input
    key by key; a :class:`P` that names an axis splits every tensor of a
    dict input (a spec is a prefix of its input's tree, as in JAX)."""
    if isinstance(spec, dict):
        if set(spec) != set(x):
            raise ValueError("a dict of specs needs an input dict of the same keys")
        return {k: _local_input(mesh, spec[k], x[k], coords) for k in x}
    if isinstance(x, dict) and any(a is not None for a in spec):
        return {k: _local_input(mesh, spec, v, coords) for k, v in x.items()}
    if isinstance(x, ShardedArray):
        if tuple(x.spec) != tuple(spec):
            raise ValueError(f"a ShardedArray placed by {x.spec} passed where {spec} is expected")
        return x.local(coords)
    return NamedSharding(mesh, spec).local(x, coords)


def _assemble(spec_tree, outs: Dict[Tuple[int, ...], Any], mesh: Mesh, select: Callable):
    """One output leaf (or tree) from the slots' outputs by its specs."""
    if not isinstance(spec_tree, P):
        parts = [
            _assemble(s, outs, mesh, lambda o, i=i, sel=select: sel(o)[i])
            for i, s in enumerate(spec_tree)
        ]
        sample = select(next(iter(outs.values())))
        return type(sample)(*parts) if hasattr(sample, "_fields") else type(sample)(parts)
    named = [(dim, axis) for dim, axis in enumerate(spec_tree) if axis is not None]
    controller = mesh.controller

    def build(level: int, coords: dict):
        if level == len(named):
            leaf = select(outs[tuple(coords.get(a, 0) for a in mesh.axis_names)])
            return leaf.to(controller) if isinstance(leaf, torch.Tensor) else leaf
        dim, axis = named[level]
        return torch.cat(
            [build(level + 1, dict(coords, **{axis: i})) for i in range(mesh.shape[axis])], dim=dim
        )

    return build(0, {})


def _thread_state(mesh: Mesh):
    """The caller's grad and inference modes and its current stream on
    each card of the mesh, for the slot threads."""
    cards = sorted({d.index or 0 for d in mesh.devices.flat if d.type == "cuda"})
    streams = [torch.cuda.current_stream(i) for i in cards]
    return torch.is_grad_enabled(), torch.is_inference_mode_enabled(), streams


def shard_map(
    f: Callable,
    *,
    mesh: Mesh,
    in_specs: Tuple,
    out_specs,
    collectives: bool = True,
) -> Callable:
    """``f`` run once per slot of ``mesh`` on its inputs' pieces
    (``jax.shard_map``'s counterpart; the module docstring says how).
    ``in_specs`` holds one spec a positional input: a :class:`P`, or a
    dict of them for a dict input (:func:`_local_input`); ``out_specs``
    the output tree's specs (a :class:`P`, or a tuple or NamedTuple of
    them)."""
    mapped = _spec_axes(tuple(in_specs)) | _spec_axes(out_specs)
    unknown = mapped - set(mesh.axis_names)
    if unknown:
        raise ValueError(f"specs name axes {sorted(unknown)} that {mesh} lacks")
    ranges = [range(mesh.shape[a]) if a in mapped else range(1) for a in mesh.axis_names]
    slots = [dict(zip(mesh.axis_names, c)) for c in itertools.product(*ranges)]
    slot_of = {tuple(c[a] for a in mesh.axis_names): i for i, c in enumerate(slots)}
    in_specs = tuple(in_specs)

    def run_slot(index: int, lockstep, args):
        coords = slots[index]
        _local.ctx = _SlotContext(mesh, coords, index, mapped, lockstep, slot_of)
        try:
            local = [_local_input(mesh, s, a, coords) for s, a in zip(in_specs, args)]
            return f(*local)
        finally:
            _local.ctx = None

    def mapped_fn(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"shard_map body takes {len(in_specs)} inputs, got {len(args)}")
        if getattr(_local, "ctx", None) is not None:
            raise RuntimeError("shard_map bodies do not nest")
        outs: Dict[Tuple[int, ...], Any] = {}
        if not collectives or len(slots) == 1:
            for i, coords in enumerate(slots):
                outs[tuple(coords[a] for a in mesh.axis_names)] = run_slot(i, None, args)
        else:
            outs = _run_lockstep(run_slot, slots, mesh, args)
        return _assemble(out_specs, outs, mesh, lambda o: o)

    return mapped_fn


class _SlotWorker:
    """A long-lived slot thread that runs the tasks put on its queue.  A
    fresh thread pays for CUDA's per-thread setup (a cuBLAS handle among
    it) at its first launches, milliseconds where a launch takes
    microseconds, so the runner keeps its threads."""

    def __init__(self):
        self.tasks: "queue.SimpleQueue" = queue.SimpleQueue()
        threading.Thread(target=self._loop, daemon=True, name="svoc-slot").start()

    def _loop(self) -> None:
        while True:
            task = self.tasks.get()
            try:
                task()
            except BaseException:  # noqa: BLE001 — a task reports its own errors; the worker lives on
                pass


_idle_workers: List[_SlotWorker] = []
_idle_lock = threading.Lock()


def _drop_workers_after_fork() -> None:
    """A forked child has none of its parent's threads."""
    global _idle_lock
    _idle_workers.clear()
    _idle_lock = threading.Lock()


os.register_at_fork(after_in_child=_drop_workers_after_fork)


def _acquire_workers(n: int) -> List[_SlotWorker]:
    """``n`` idle slot threads, started when there are too few; runs of
    shard_maps on several caller threads take different ones."""
    with _idle_lock:
        got = [_idle_workers.pop() for _ in range(min(n, len(_idle_workers)))]
    return got + [_SlotWorker() for _ in range(n - len(got))]


def _release_workers(workers: List[_SlotWorker]) -> None:
    with _idle_lock:
        _idle_workers.extend(workers)


def _run_lockstep(run_slot, slots, mesh, args):
    lockstep = _Lockstep(len(slots))
    grad, inference, streams = _thread_state(mesh)
    results: List[Any] = [None] * len(slots)
    finished = [threading.Event() for _ in slots]

    def worker(index: int):
        try:
            with contextlib.ExitStack() as stack:
                if inference:
                    stack.enter_context(torch.inference_mode())
                stack.enter_context(torch.set_grad_enabled(grad))
                for s in streams:
                    stack.enter_context(torch.cuda.stream(s))
                lockstep.wait_turn(index)
                results[index] = run_slot(index, lockstep, args)
            lockstep.pass_turn(index, finished=True)
        except _Aborted:
            pass
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller's thread
            lockstep.fail(e)
        finally:
            finished[index].set()

    workers = _acquire_workers(len(slots))
    for i, w in enumerate(workers):
        w.tasks.put(functools.partial(worker, i))
    for event in finished:
        event.wait()
    _release_workers(workers)
    if lockstep.error is not None:
        raise lockstep.error
    return {tuple(c[a] for a in mesh.axis_names): results[i] for i, c in enumerate(slots)}


# ---------------------------------------------------------------------------
# The oracle-sharded consensus
# ---------------------------------------------------------------------------


def consensus_out_specs(axis: str) -> ConsensusOutput:
    """Specs of a shard-mapped consensus: per-oracle outputs split over
    ``axis``, block outputs replicated."""
    return ConsensusOutput(
        essence=P(),
        essence_first_pass=P(),
        reliability_first_pass=P(),
        reliability_second_pass=P(),
        reliable=P(axis),
        quadratic_risk=P(axis),
        skewness=P(),
        kurtosis=P(),
        interval_valid=P(),
    )


def _consensus_body(cfg: ConsensusConfig, axis: str, gate=None):
    """The body ``values_local [N/d, M]`` → the consensus, per-oracle
    outputs local (``sharded.py:60-200``).  The medians and the rank
    mask read the gathered block, the means are psums.  ``gate=(lo,
    hi)`` adds the input-integrity quarantine on the gathered block
    (quarantined oracles leave both passes and rank last) and returns
    the local admission mask as well.

    Every psum adds float64 partials and rounds once to float32, so a
    sum does not depend on how the oracle axis is split (float32
    partials added in slot order moved a skewness near 0 past its 1e-5
    bar between one slot and two)."""

    def gsum(x: torch.Tensor, dim=None) -> torch.Tensor:
        local = x.sum(dtype=torch.float64) if dim is None else x.sum(dim=dim, dtype=torch.float64)
        return psum(local, axis).to(x.dtype)

    def body(values_local: torch.Tensor):
        n_local, dim = values_local.shape
        n = n_local * axis_size(axis)
        ax = axis_index(axis)
        own = slice(ax * n_local, (ax + 1) * n_local)
        values = all_gather(values_local, axis)
        if gate is not None:
            ok = quarantine_mask(values, gate[0], gate[1])
            # Neutral fill before any arithmetic: 0 * NaN is NaN.
            values = torch.where(ok[:, None] & torch.isfinite(values), values, 0.0)
            ok_local, values_local = ok[own], values[own]
            base_mask = ok
            okf_local = ok_local.to(values.dtype)
            n_ok = gsum(okf_local)
        else:
            base_mask = torch.ones(n, dtype=torch.bool, device=values.device)

        # ---- FIRST PASS (over the admitted subset when gated) ----
        essence1 = stats.masked_smooth_median(values, base_mask, cfg.smooth_mode)
        qr_local = stats.quadratic_risk(values_local, essence1)
        if gate is not None:
            mean_qr = gsum(qr_local * okf_local) / torch.clamp(n_ok, min=1.0)
        else:
            mean_qr = gsum(qr_local) / n
        rel1 = reliability(cfg, mean_qr, dim)
        qr = all_gather(qr_local, axis)
        if gate is not None:
            reliable = sort_ops.gated_reliability_mask(qr, base_mask, n_ok.to(torch.int64), cfg.n_failing)
        else:
            reliable = sort_ops.reliability_mask(qr, cfg.n_failing)

        # ---- SECOND PASS (risk still centred on essence₁) ----
        if cfg.constrained:
            essence2 = stats.masked_smooth_median(values, reliable, cfg.smooth_mode)
        else:
            essence2 = stats.masked_mean(values, reliable)
        reliable_local = reliable[own]
        n_rel = gsum(reliable_local.to(qr_local.dtype))
        mean_qr2 = gsum(qr_local * reliable_local) / torch.clamp(n_rel, min=1.0)
        rel2 = reliability(cfg, mean_qr2, dim)

        # ---- MOMENTS over the reliable subset, psum-reduced ----
        w = reliable_local[:, None].to(values_local.dtype)
        denom = torch.clamp(n_rel, min=1.0)
        mean_rel = gsum(values_local * w, 0) / denom
        centered = (values_local - mean_rel[None, :]) * w
        var = gsum(centered**2, 0) / denom
        std = torch.clamp(torch.sqrt(var), min=1e-30)
        z = centered / std[None, :]
        s3 = gsum(z**3, 0)
        s4 = gsum(z**4, 0)
        skew = s3 * n_rel / torch.clamp((n_rel - 1.0) * (n_rel - 2.0), min=1.0)
        t1 = s4 * n_rel * (n_rel + 1.0) / torch.clamp(n_rel - 1.0, min=1.0)
        t2 = 3.0 * (n_rel - 1.0) ** 2
        kurt = (t1 - t2) / torch.clamp((n_rel - 2.0) * (n_rel - 3.0), min=1.0)

        valid = stats.interval_ok(rel1) & stats.interval_ok(rel2)
        # Fewer than two reliable oracles is no consensus (kernel parity).
        if n - cfg.n_failing < 2:
            valid = valid & False
        if gate is not None:
            valid = valid & (n_ok >= 2.0) & (n_rel >= 2.0)
            essence1 = torch.where(torch.isfinite(essence1), essence1, 0.0)
            essence2 = torch.where(torch.isfinite(essence2), essence2, 0.0)

        out = ConsensusOutput(
            essence=essence2,
            essence_first_pass=essence1,
            reliability_first_pass=rel1,
            reliability_second_pass=rel2,
            reliable=reliable_local,
            quadratic_risk=qr_local,
            skewness=skew,
            kurtosis=kurt,
            interval_valid=valid,
        )
        if gate is not None:
            return out, ok_local
        return out

    return body


def sharded_consensus_fn(mesh: Mesh, cfg: ConsensusConfig, axis: str = "oracle") -> Callable:
    """The two-pass consensus with ``values [N, M]`` split over ``axis``:
    per-oracle outputs (``reliable``, ``quadratic_risk``) assembled from
    the slots, block outputs replicated.  The semantics of
    :func:`svoc_torch.consensus.kernel.consensus_step`."""
    return shard_map(
        _consensus_body(cfg, axis), mesh=mesh, in_specs=(P(axis, None),), out_specs=consensus_out_specs(axis)
    )


# ---------------------------------------------------------------------------
# The fleet, keyed by global oracle index
# ---------------------------------------------------------------------------


def oracle_rows(
    key: torch.Tensor,
    window: torch.Tensor,
    n_oracles: int,
    n_failing: int,
    subset_size: int,
    first: int,
    count: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bootstrap fleet's rows ``first .. first + count - 1``
    (``sharded.py:202-238``, ``claim_shard.py:385-424``), for ``key
    [..., 2]`` and ``window [..., W, M]`` of the same leading axes:
    ``fold_in(key, 0)`` permutes the slots and its first ``n_failing``
    are the failing ones; oracle ``i`` draws from ``fold_in(key, i +
    1)`` split in two, a ``uniform`` of ``M`` (failing) and a
    ``choice`` of ``subset_size`` window rows without replacement whose
    mean it reports (honest).  Every stream is keyed by the global
    index, so the rows are the same bits however the fleet is split.
    The mean adds the rows in index order and multiplies by the float32
    ``1 / subset_size``, as XLA compiles ``jnp.mean`` on the CPU.
    Returns ``(values [..., count, M], honest [..., count])``."""
    lead = key.shape[:-1]
    w, m = window.shape[-2:]
    dev = window.device
    perm = prng.permutation(prng.fold_in(key, 0), n_oracles)
    failing = torch.zeros(*lead, n_oracles, dtype=torch.bool, device=dev)
    failing.scatter_(-1, perm[..., :n_failing].to(dev), True)
    failing = failing[..., first : first + count]
    k_fail, k_boot = prng.split(prng.fold_in_range(key, first + 1, count), 2).unbind(-2)
    fail_val = prng.uniform(k_fail, (m,)).to(dev)
    idx = prng.choice(k_boot, w, subset_size).to(dev)  # [..., count, subset]
    b = int(np.prod(lead, dtype=np.int64))
    flat = window.reshape(b, w, m)
    rows = flat.gather(1, idx.reshape(b, count * subset_size, 1).expand(b, count * subset_size, m))
    rows = rows.reshape(b, count, subset_size, m)
    total = rows[:, :, 0]
    for j in range(1, subset_size):
        total = total + rows[:, :, j]
    boot_val = (total * float(np.float32(1.0 / subset_size))).reshape(*lead, count, m)
    values = torch.where(failing[..., None], fail_val.to(window.dtype), boot_val)
    return values, ~failing


def _fleet_body(n_oracles: int, n_failing: int, subset_size: int, axis: str):
    """The body ``(key, window) → (values_local, honest_local)``: this
    slot's oracles of the fleet (:func:`oracle_rows`)."""

    def body(key, window):
        n_local = n_oracles // axis_size(axis)
        return oracle_rows(key, window, n_oracles, n_failing, subset_size, axis_index(axis) * n_local, n_local)

    return body


def fleet_consensus_shard_map(
    mesh: Mesh,
    cfg: ConsensusConfig,
    n_oracles: int,
    subset_size: int = 10,
    axis: str = "oracle",
    gate=None,
) -> Callable:
    """``(key, window) → (ConsensusOutput, honest)``: the fleet made on
    each slot and its consensus, one shard_map (``sharded.py:241-294``).
    ``gate=(lo, hi)`` adds the quarantine; the step then returns
    ``(ConsensusOutput, honest, admitted)``."""
    n_dev = mesh.shape[axis]
    if n_oracles % n_dev:
        raise ValueError(f"n_oracles={n_oracles} not divisible by mesh size {n_dev}")
    gen = _fleet_body(n_oracles, cfg.n_failing, subset_size, axis)
    consensus = _consensus_body(cfg, axis, gate)

    if gate is not None:
        def step(key, window):
            values_local, honest_local = gen(key, window)
            out, ok_local = consensus(values_local)
            return out, honest_local, ok_local

        out_specs = (consensus_out_specs(axis), P(axis), P(axis))
    else:
        def step(key, window):
            values_local, honest_local = gen(key, window)
            return consensus(values_local), honest_local

        out_specs = (consensus_out_specs(axis), P(axis))
    return shard_map(step, mesh=mesh, in_specs=(P(), P()), out_specs=out_specs)


def sharded_fleet_step_fn(
    mesh: Mesh,
    cfg: ConsensusConfig,
    n_oracles: int,
    subset_size: int = 10,
    axis: str = "oracle",
    gate=None,
) -> Callable:
    """The simulation step ``(key, window [W, M]) → (ConsensusOutput,
    honest [N])`` with the fleet made only as per-slot shards
    (``sharded.py:297-332``); ``gate`` as in
    :func:`fleet_consensus_shard_map`."""
    return fleet_consensus_shard_map(mesh, cfg, n_oracles, subset_size, axis, gate)
