"""Data parallelism over torch.distributed (counterpart of
pytorch_camvid_tpu/parallel): the ranks' mesh, the data-parallel step
wrappers, H-sharded halo convs and stages, and setting up the ranks."""

from pytorch_camvid_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, make_mesh, make_multislice_mesh, batch_sharding,
    replicated_sharding)
from pytorch_camvid_tpu_torch.parallel.data_parallel import (  # noqa: F401
    jit_train_step, jit_chain_train_step, jit_eval_step, shard_batch)
from pytorch_camvid_tpu_torch.parallel.shard_map_dp import (  # noqa: F401
    shard_map_train_step, shard_map_eval_step)
from pytorch_camvid_tpu_torch.parallel.spatial import (  # noqa: F401
    conv3x3_halo, make_spatial_conv, encoder_stage_halo, make_spatial_stage)
from pytorch_camvid_tpu_torch.parallel.multihost import (  # noqa: F401
    init_distributed, is_primary, put_global, put_global_tree)
