from ilswiss_tpu_torch.parallel.mesh import (
    DATA_AXIS, ENV_AXIS, MODEL_AXIS, RankGroup, init_group, spawn_ranks,
)
from ilswiss_tpu_torch.parallel.distributed import (
    DistributedOffPolicyRunner, DistributedOnPolicyRunner, all_reduce_mean,
    restore_across_topology,
)
