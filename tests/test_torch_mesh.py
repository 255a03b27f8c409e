"""The port's mesh helpers against the JAX package's, on the CPU.

Twin of ``tests/test_mesh.py``: factorizations, validation, the hybrid
single- and multi-slice paths, and ``init_distributed``'s contract under
the same monkeypatch shape (``torch.distributed`` standing in for
``jax.distributed``).  The port's slots are 8 of the CPU
(``MESH_SLOTS``), the reference's 8 simulated devices.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from svoc_tpu.parallel import mesh as ref_mesh  # noqa: E402

from svoc_torch.consensus.kernel import ConsensusConfig, consensus_step  # noqa: E402
from svoc_torch.parallel import mesh  # noqa: E402
from svoc_torch.parallel.mesh import MeshSpec, best_mesh, hybrid_mesh, make_mesh  # noqa: E402
from svoc_torch.parallel.sharded import sharded_consensus_fn  # noqa: E402


def test_make_mesh_validates_device_count():
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_mesh(MeshSpec(("oracle",), (16,)), device="cpu")
    with pytest.raises(ValueError, match="needs 16 devices"):
        ref_mesh.make_mesh(ref_mesh.MeshSpec(("oracle",), (16,)))


def test_best_mesh_uses_all_slots():
    m = best_mesh(device="cpu")
    assert m.axis_names == ("oracle",) == ref_mesh.best_mesh().axis_names
    assert m.devices.size == 8 == ref_mesh.best_mesh().devices.size
    assert {str(d) for d in m.devices.flat} == {"cpu"}


def test_slot_inventory_interleaves_cards(monkeypatch):
    monkeypatch.setattr(mesh, "MESH_SLOTS", 2)
    assert best_mesh(device="cpu").size == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # Cards interleaved: a mesh of two slots puts one on each card.
    assert [str(d) for d in mesh.mesh_devices("cuda")] == ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    with pytest.raises(RuntimeError, match="defaults to CUDA"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        mesh.mesh_devices()


def test_hybrid_mesh_single_slice():
    m = hybrid_mesh(MeshSpec(("data", "model"), (2, 2)), device="cpu")
    ref = ref_mesh.hybrid_mesh(ref_mesh.MeshSpec(("data", "model"), (2, 2)))
    assert m.axis_names == ref.axis_names == ("replica", "data", "model")
    assert m.devices.shape == ref.devices.shape == (1, 2, 2)


def test_hybrid_mesh_validates_oversized_spec():
    with pytest.raises(ValueError, match="needs 32 devices"):
        hybrid_mesh(MeshSpec(("oracle",), (32,)), device="cpu")


def test_hybrid_mesh_multi_slice_branch():
    """Two slices of four slots, host-major: the grid, the axis names,
    and a real sharded consensus over the ici axis."""
    m = hybrid_mesh(MeshSpec(("oracle",), (4,)), n_slices=2, device="cpu")
    assert m.axis_names == ("replica", "oracle")
    assert m.devices.shape == (2, 4)
    cfg = ConsensusConfig(n_failing=2, constrained=True)
    values = torch.rand(16, 6, generator=torch.Generator().manual_seed(0))
    out = sharded_consensus_fn(m, cfg, axis="oracle")(values)
    torch.testing.assert_close(out.essence, consensus_step(values, cfg).essence, rtol=1e-5, atol=0)


def test_hybrid_mesh_multi_slice_rejects_partial_ici_coverage():
    with pytest.raises(ValueError, match="covers 2 chips but"):
        hybrid_mesh(MeshSpec(("oracle",), (2,)), n_slices=2, device="cpu")


def test_placement_descriptors():
    m = best_mesh(device="cpu")
    assert mesh.replicated(m).spec == () and mesh.row_sharded(m, "oracle").spec == ("oracle",)
    x = torch.arange(16).reshape(8, 2)
    pieces = [mesh.row_sharded(m, "oracle").local(x, {"oracle": i}) for i in range(8)]
    assert torch.equal(torch.cat(pieces), x)
    assert torch.equal(mesh.replicated(m).local(x, {"oracle": 3}), x)
    assert mesh.canonical_device("cpu") == torch.device("cpu")


def test_init_distributed_contract(monkeypatch):
    """The multi-host bring-up law, on ``torch.distributed``: the bring-up
    is always attempted, a lone host where nothing is configured is a
    no-op, a configured bring-up never fails silently, and a late call
    (CUDA live) is benign alone but loud when configured."""
    import torch.distributed as dist

    for var in mesh.DISTRIBUTED_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # restored after the test
    monkeypatch.setattr(dist, "is_initialized", lambda: False)

    # --- late call (CUDA live): benign alone, loud when configured
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert mesh.init_distributed() is False
    with pytest.raises(RuntimeError, match="before CUDA is initialised"):
        mesh.init_distributed(coordinator_address="10.0.0.1:1234", num_processes=4)

    # --- before CUDA: attempted, a no-op only when nothing is configured
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    calls = []

    def fake_init(**kw):
        calls.append(kw)
        if kw["init_method"] == "env://":
            raise ValueError("environment variable MASTER_ADDR expected")

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    assert mesh.init_distributed() is False  # attempted, nothing configured
    assert len(calls) == 1
    assert mesh.init_distributed(coordinator_address="10.0.0.1:1234", num_processes=4, process_id=1,
                                 local_device_ids=[2]) is True
    assert calls[-1]["init_method"] == "tcp://10.0.0.1:1234"
    assert (calls[-1]["world_size"], calls[-1]["rank"]) == (4, 1)
    import os

    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2"
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        mesh.init_distributed()  # a launcher's variable: configured, so loud

    # already initialised by the launcher -> True, no re-init
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    n = len(calls)
    assert mesh.init_distributed() is True
    assert len(calls) == n


def test_mesh_rejects_bad_grids():
    with pytest.raises(ValueError, match="cannot take axes"):
        mesh.Mesh(np.array(["cpu"] * 4, dtype=object), ("a", "b"))
    with pytest.raises(ValueError, match="repeat"):
        mesh.Mesh(np.empty((1, 1), dtype=object), ("a", "a"))
