"""Mesh construction and sharding policy.

Mirrors :mod:`svoc_tpu.parallel.mesh` (``mesh.py:1-304``: the axis
names, ``CLAIM_MESH_ENV``, ``MeshConfigError``, ``MeshSpec``,
``make_mesh``, ``parse_claim_mesh``, ``claim_mesh``, ``best_mesh``,
``hybrid_mesh``, ``init_distributed``, ``replicated``, ``row_sharded``),
with :class:`ShardedArray`, the counterpart of a ``jax.Array`` that a
``NamedSharding`` placed: one piece a slot, each on its slot's device
(the mesh train state keeps its tensors so).

Axis conventions (as in the reference):

- ``"oracle"`` — the fleet axis: N simulated oracles split over slots;
- ``"data"`` — the batch axis of the data-parallel serving step;
- ``"model"`` — the tensor-parallel axis;
- ``"claim"`` — the claim axis of the claim cube (pure data
  parallelism, no collective crosses it);
- ``"replica"`` — the multi-host axis of :func:`hybrid_mesh`.

**The mesh is single-controller.**  The reference drives every mesh
from one Python process (``jax.sharding.Mesh`` and ``shard_map``), and
its tests run that mesh on 8 simulated CPU devices.  The fabric's
``ClaimRouter(mesh=)`` is one router process dispatching a claim cube
over a claim × oracle grid, so the port's mesh is one too: a
:class:`Mesh` is a named grid of explicit ``torch.device`` slots, and
:func:`svoc_torch.parallel.sharded.shard_map` runs a body once per slot
on that slot's device, its collectives plain tensor ops across slots.
A process group (one process a rank) could not be that router without
a feature the reference lacks.

One device may fill several slots: the slot inventory
(:func:`mesh_devices`) lists every visible card (or the CPU)
:data:`MESH_SLOTS` times (8, the reference's simulated device count),
cards interleaved, so a mesh of at most as many slots as cards
puts each slot on its own card, and a ``"2x4"`` mesh on one H100 (or on
the CPU) is 8 slots of that one device.  A copy between two slots of
one device is a no-op.

:func:`init_distributed` is the one place that touches
``torch.distributed``: the multi-host twin of
``jax.distributed.initialize``.  Nothing in the port needs it on one
host.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from svoc_torch.device import resolve_device

#: Axis names of the 2-D claim-cube mesh: claims are pure data
#: parallelism, oracles carry the consensus collectives.
CLAIM_AXIS = "claim"
ORACLE_AXIS = "oracle"
#: Inference/fine-tune axes and the multi-host axis of :func:`hybrid_mesh`.
DATA_AXIS = "data"
MODEL_AXIS = "model"
REPLICA_AXIS = "replica"

#: ``SVOC_MESH=<claims>x<oracles>``: the operator override the router
#: reads when it is given no ``mesh`` (:func:`resolve_claim_mesh`).
CLAIM_MESH_ENV = "SVOC_MESH"
#: Slots each device offers to a mesh: the port's counterpart of the
#: reference tests' ``--xla_force_host_platform_device_count=8``.
MESH_SLOTS = 8
#: The committed ``claim_mesh`` decision (``PERF_DECISIONS.json:4``,
#: ``"none"``): no mesh unless ``SVOC_MESH`` or the caller names one.
DEFAULT_CLAIM_MESH = None


class MeshConfigError(ValueError):
    """A claim-mesh spec failed validation (a bad ``SVOC_MESH`` form, a
    mesh of more slots than the inventory holds).  The message names the
    spec, the expected form and the inventory."""


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A named mesh factorization, e.g. ``MeshSpec(("data", "oracle"), (2, 4))``."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def n_devices(self) -> int:
        return int(math.prod(self.axis_sizes))


class P(tuple):
    """A partition spec, ``jax.sharding.PartitionSpec``'s counterpart:
    one entry a tensor dimension, the mesh axis that splits it or None;
    ``P()`` is replicated (trailing dimensions are never split)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class Mesh:
    """A named grid of ``torch.device`` slots (``jax.sharding.Mesh``'s
    counterpart).  ``devices`` is an object array of the grid's shape;
    ``shape`` maps each axis name to its size, in order."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"a {devices.ndim}-D device grid cannot take axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names repeat: {self.axis_names}")
        self.devices = devices
        self.shape = collections.OrderedDict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def controller(self) -> torch.device:
        """The device that sharded outputs are assembled on: the first
        slot's."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({dict(self.shape)}, devices={devs})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives on a mesh (``jax.sharding.NamedSharding``'s
    counterpart): a placement descriptor that the runner splits inputs
    by and assembles outputs by."""

    mesh: Mesh
    spec: P

    def local(self, x, coords: dict):
        """The piece of ``x`` that the slot at ``coords`` (axis → index)
        holds, on that slot's device.  Replicated inputs that are not
        tensors are passed as they are."""
        device = self.mesh.devices[tuple(coords[a] for a in self.mesh.axis_names)]
        if not isinstance(x, torch.Tensor):
            if any(a is not None for a in self.spec):
                raise TypeError(f"spec {self.spec} splits a {type(x).__name__}, not a tensor")
            return x
        if len(self.spec) > x.dim():
            raise ValueError(f"spec {self.spec} has more entries than the {x.dim()}-D input")
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            size = self.mesh.shape[axis]
            if x.shape[dim] % size:
                raise ValueError(
                    f"dimension {dim} of size {x.shape[dim]} does not divide by mesh axis {axis!r} of {size}"
                )
            chunk = x.shape[dim] // size
            x = x.narrow(dim, coords[axis] * chunk, chunk)
        return x.to(device)


class ShardedArray:
    """One logical tensor kept as one piece a slot of a mesh, each piece
    on its slot's device: the counterpart of a ``jax.Array`` placed by a
    :class:`NamedSharding` (its ``addressable_shards``).  The pieces split
    the whole as ``sharding.spec`` says; slots that differ only along an
    axis the spec leaves out hold equal pieces, each a tensor of its
    own.  ``pieces`` maps a slot's coordinates (one index an axis, in the
    mesh's axis order) to its piece."""

    def __init__(self, sharding: NamedSharding, shape, pieces: Dict[Tuple[int, ...], torch.Tensor]):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.pieces = pieces

    @classmethod
    def put(cls, x: torch.Tensor, sharding: NamedSharding, requires_grad: bool = False) -> "ShardedArray":
        """``x`` split by ``sharding``, a copy of its piece on each slot
        (``jax.device_put``); with ``requires_grad`` each piece is a leaf
        that autograd fills a ``.grad`` of."""
        mesh = sharding.mesh
        pieces = {}
        for key in slot_keys(mesh):
            piece = sharding.local(x.detach(), dict(zip(mesh.axis_names, key))).clone()
            pieces[key] = piece.requires_grad_(requires_grad)
        return cls(sharding, x.shape, pieces)

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> P:
        return self.sharding.spec

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def addressable_shards(self) -> List[torch.Tensor]:
        """Every slot's piece (``jax.Array.addressable_shards``' data)."""
        return list(self.pieces.values())

    def local(self, coords: dict) -> torch.Tensor:
        """The piece of the slot at ``coords`` (axis → index)."""
        return self.pieces[tuple(coords[a] for a in self.mesh.axis_names)]

    def gather(self) -> torch.Tensor:
        """The whole tensor on the mesh's controller, detached: the
        pieces joined along the axes the spec names, from the slots at
        index 0 along the others."""
        mesh = self.mesh
        named = [(dim, axis) for dim, axis in enumerate(self.spec) if axis is not None]

        def build(level: int, coords: dict) -> torch.Tensor:
            if level == len(named):
                return self.pieces[tuple(coords.get(a, 0) for a in mesh.axis_names)].detach().to(mesh.controller)
            dim, axis = named[level]
            return torch.cat([build(level + 1, dict(coords, **{axis: i})) for i in range(mesh.shape[axis])], dim=dim)

        return build(0, {})

    def __repr__(self) -> str:
        return f"ShardedArray({tuple(self.shape)}, {self.spec}, {self.mesh})"


def slot_keys(mesh: Mesh) -> List[Tuple[int, ...]]:
    """Every slot's coordinates, in slot order (the last axis fastest)."""
    return list(itertools.product(*(range(n) for n in mesh.shape.values())))


def canonical_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card, as a
    tensor placed there reports it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_devices(device=None) -> List[torch.device]:
    """The slot inventory: every visible card when ``device`` is CUDA
    (``None``: CUDA, raising without a card), else ``device`` itself,
    each :data:`MESH_SLOTS` times, cards interleaved."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    return cards * MESH_SLOTS


def make_mesh(spec: MeshSpec, devices: Optional[Sequence] = None, device=None) -> Mesh:
    """A :class:`Mesh` for ``spec`` over the first ``spec.n_devices`` of
    ``devices`` (default :func:`mesh_devices` of ``device``); raises if
    there are not enough."""
    devs = list(devices if devices is not None else mesh_devices(device))
    need = spec.n_devices
    if len(devs) < need:
        raise ValueError(f"mesh {spec} needs {need} devices, only {len(devs)} available")
    grid = np.empty(need, dtype=object)
    grid[:] = [canonical_device(d) for d in devs[:need]]
    return Mesh(grid.reshape(spec.axis_sizes), spec.axis_names)


def parse_claim_mesh(spec) -> Optional[Tuple[int, int]]:
    """``"<claims>x<oracles>"`` → ``(claims, oracles)``; ``None`` /
    ``""`` / ``"none"`` / ``"off"`` → ``None`` (unsharded dispatch).  A
    2-tuple passes unchanged; anything else raises
    :class:`MeshConfigError` naming the expected form."""
    if spec is None:
        return None
    if isinstance(spec, (tuple, list)):
        if len(spec) != 2:
            raise MeshConfigError(f"claim mesh tuple must be (claims, oracles), got {spec!r}")
        claims, oracles = spec
    else:
        text = str(spec).strip().lower()
        if text in ("", "none", "off"):
            return None
        parts = text.split("x")
        if len(parts) != 2:
            raise MeshConfigError(
                f"claim mesh spec {spec!r} is not of the form <claims>x<oracles> "
                f"(e.g. {CLAIM_MESH_ENV}=2x4)"
            )
        try:
            claims, oracles = (int(p) for p in parts)
        except ValueError:
            raise MeshConfigError(
                f"claim mesh spec {spec!r} has non-integer axis sizes (expected e.g. {CLAIM_MESH_ENV}=2x4)"
            ) from None
    if claims < 1 or oracles < 1:
        raise MeshConfigError(f"claim mesh axes must be >= 1, got {claims}x{oracles}")
    return int(claims), int(oracles)


def resolve_claim_mesh() -> Optional[str]:
    """``SVOC_MESH`` when set, else :data:`DEFAULT_CLAIM_MESH` (the
    reference's ``consensus/dispatch.py:276-292`` with the committed
    ``claim_mesh`` record kept as a constant).  ``"none"``/``"off"`` →
    None."""
    raw = os.environ.get(CLAIM_MESH_ENV, "").strip()
    value = raw or DEFAULT_CLAIM_MESH
    if not value or value.lower() in ("none", "off"):
        return None
    return value


def claim_mesh(spec, devices: Optional[Sequence] = None, device=None) -> Optional[Mesh]:
    """The 2-D ``(claim, oracle)`` mesh of the sharded claim cube
    (:mod:`svoc_torch.parallel.claim_shard`), or None for ``None`` /
    ``"none"`` / ``"off"``.  ``spec`` is the ``SVOC_MESH`` form or a
    ``(claims, oracles)`` tuple; the slots come from ``devices``
    (default :func:`mesh_devices` of ``device``)."""
    parsed = parse_claim_mesh(spec)
    if parsed is None:
        return None
    claims, oracles = parsed
    devs = list(devices if devices is not None else mesh_devices(device))
    if claims * oracles > len(devs):
        raise MeshConfigError(
            f"claim mesh {claims}x{oracles} needs {claims * oracles} slots, only {len(devs)} "
            f"available — each device offers {MESH_SLOTS} slots; add cards, or pass the slots "
            "as devices="
        )
    return make_mesh(MeshSpec((CLAIM_AXIS, ORACLE_AXIS), (claims, oracles)), devs)


def best_mesh(axis_name: str = ORACLE_AXIS, devices: Optional[Sequence] = None, device=None) -> Mesh:
    """A 1-D mesh over the whole slot inventory: the default fleet layout."""
    devs = list(devices if devices is not None else mesh_devices(device))
    return make_mesh(MeshSpec((axis_name,), (len(devs),)), devs)


def hybrid_mesh(
    ici_spec: MeshSpec,
    dcn_axis: str = REPLICA_AXIS,
    n_slices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    device=None,
) -> Mesh:
    """A multi-host mesh: ``dcn_axis`` ranges over hosts and ``ici_spec``
    factorizes the slots of each host.  Data or replica parallelism goes
    on ``dcn_axis``; the chatty axes on ``ici_spec``'s.  One controller
    sees one host, so ``n_slices`` defaults to 1, which is
    ``make_mesh`` over ``(dcn_axis=1) × ici_spec``.  With more slices,
    ``devices`` lists them host-major and ``ici_spec`` must cover every
    slot of a host."""
    devs = list(devices if devices is not None else mesh_devices(device))
    n_slices = 1 if n_slices is None else int(n_slices)
    axis_names = (dcn_axis,) + ici_spec.axis_names
    if n_slices == 1:
        return make_mesh(MeshSpec(axis_names, (1,) + ici_spec.axis_sizes), devs)
    per_slice = len(devs) // n_slices
    if ici_spec.n_devices != per_slice:
        raise ValueError(
            f"ici spec {ici_spec} covers {ici_spec.n_devices} chips but each of the {n_slices} "
            f"slices has {per_slice}"
        )
    return make_mesh(MeshSpec(axis_names, (n_slices,) + ici_spec.axis_sizes), devs)


#: Launchers' environment variables that mean a multi-host run was set up.
DISTRIBUTED_ENV = ("MASTER_ADDR", "TORCHELASTIC_RUN_ID")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Multi-host bring-up, the twin of the reference's
    (``mesh.py:225-291``) on ``torch.distributed``: the one call a
    multi-host launch makes before any card is used.

    ``init_process_group`` is always attempted (with no arguments it
    reads a launcher's ``env://`` variables); a lone host where nothing
    is configured is a no-op returning False, so library code can call
    this unconditionally.  Returns True when the process group is (or
    already was) initialised.  A configured bring-up (an argument, or a
    launcher's variable) never fails silently.  Order matters:
    ``local_device_ids`` narrows ``CUDA_VISIBLE_DEVICES``, which CUDA
    reads once, so a late call (CUDA already initialised) is a no-op
    alone and raises when a bring-up was configured."""
    import torch.distributed as dist

    explicit = any(v is not None for v in (coordinator_address, process_id, local_device_ids)) or (
        num_processes or 0
    ) > 1
    env_signal = any(os.environ.get(v) for v in DISTRIBUTED_ENV)
    if dist.is_available() and dist.is_initialized():
        return True  # initialised by the launcher
    if torch.cuda.is_initialized():
        if explicit or env_signal:
            raise RuntimeError(
                "init_distributed() must run before CUDA is initialised, but CUDA is live and a "
                "multi-host bring-up was configured"
            )
        return False  # a late call on a lone host
    if local_device_ids is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(str(int(i)) for i in local_device_ids)
    init_method = "env://"
    if coordinator_address is not None:
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    try:
        dist.init_process_group(
            backend="nccl" if torch.cuda.is_available() else "gloo",
            init_method=init_method,
            world_size=-1 if num_processes is None else int(num_processes),
            rank=-1 if process_id is None else int(process_id),
        )
        return True
    except (RuntimeError, ValueError):
        if explicit or env_signal:
            raise  # a configured bring-up must not fail silently
        return False  # nothing configured: a single-host no-op


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh, axis_name: str) -> NamedSharding:
    """The leading dimension split over ``axis_name``, the rest replicated."""
    return NamedSharding(mesh, P(axis_name))
