"""Device-mesh parallelism of the port (mirrors :mod:`svoc_tpu.parallel`).

The oracle fleet and the claim cube live on a single-controller
:class:`~svoc_torch.parallel.mesh.Mesh` of ``torch.device`` slots, and
the consensus reductions are plain tensor ops across slots
(:mod:`svoc_torch.parallel.sharded`).  Exports the reference's names but
``pipeline_forward_fn`` and ``stack_block_params``: the pipeline waits
for ROADMAP A12e part 2, with ring attention, the sequence-parallel
encoder and the sharded train factories.  :mod:`~svoc_torch.parallel.
encoder_math` holds the functional encoder math the W8A8 forward runs
on.
"""

from svoc_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    best_mesh,
    make_mesh,
)
from svoc_torch.parallel.serving import (  # noqa: F401
    batch_sharding,
    dp_serving_step_fn,
    serving_mesh,
)
from svoc_torch.parallel.sharded import (  # noqa: F401
    sharded_consensus_fn,
    sharded_fleet_step_fn,
)
