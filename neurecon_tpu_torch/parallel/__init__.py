from neurecon_tpu_torch.parallel.distributed import (get_local_rank, get_rank,
                                                     get_world_size, init_env,
                                                     is_master, process_group)
from neurecon_tpu_torch.parallel.sharding import (RayShard, make_sharded_render,
                                                  make_sharded_train_step, shard_rays)

__all__ = ["RayShard", "get_local_rank", "get_rank", "get_world_size", "init_env",
           "is_master", "make_sharded_render", "make_sharded_train_step",
           "process_group", "shard_rays"]
