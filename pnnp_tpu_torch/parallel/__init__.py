"""Several devices through ``torch.distributed`` (counterpart of
``pnnp_tpu/parallel``)."""

from pnnp_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedNoiseStep,
    ShardedTrainStep,
    average_gradients,
    barrier,
    bind_data_group,
    init_distributed,
    loader_shard,
    make_eval_metrics_step_sharded,
    make_mesh,
    make_sharded_noise_step,
    make_sharded_train_step,
    place_batch,
    rank_seed,
    replicate,
    shard_batch,
    spatial_eval,
    spatial_eval_auto,
)
