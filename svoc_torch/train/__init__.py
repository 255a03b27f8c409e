"""Fine-tuning of the port's encoder (mirrors :mod:`svoc_tpu.train`): the
one-device steps, and the sequence-parallel, tensor-parallel and ZeRO-1
steps on a mesh (:mod:`svoc_torch.train.trainer`)."""

from svoc_torch.train.trainer import (  # noqa: F401
    Batch,
    PackedTrainBatch,
    ShardedTrainState,
    TrainState,
    adam,
    adamw,
    init_state,
    make_packed_train_step,
    make_sharded_packed_train_step,
    make_sharded_train_step,
    make_sp_train_step,
    make_train_step,
    max_shard_fraction,
    sgd,
    unshard_state,
)
