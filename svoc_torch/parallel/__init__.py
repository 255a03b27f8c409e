"""Device-mesh parallelism of the port (mirrors :mod:`svoc_tpu.parallel`).

The oracle fleet and the claim cube live on a single-controller
:class:`~svoc_torch.parallel.mesh.Mesh` of ``torch.device`` slots, and
the consensus reductions are plain tensor ops across slots
(:mod:`svoc_torch.parallel.sharded`).  Exports the reference's names.
The sequence and layer paths sit beside them:
:mod:`~svoc_torch.parallel.ring_attention`,
:mod:`~svoc_torch.parallel.sp_encoder` and
:mod:`~svoc_torch.parallel.pipeline`, and the tensor-parallel and ZeRO-1
train factories live in :mod:`svoc_torch.train.trainer`.
:mod:`~svoc_torch.parallel.encoder_math` holds the functional encoder
math that the W8A8 forward, the sequence-parallel encoder, the pipeline
and the tensor-parallel step run on.
"""

from svoc_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    best_mesh,
    make_mesh,
)
from svoc_torch.parallel.pipeline import (  # noqa: F401
    pipeline_forward_fn,
    stack_block_params,
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
