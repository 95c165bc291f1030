from .mesh import (DATA_AXIS, make_mesh, make_mesh_2d,
                   initialize_distributed, batch_sharding,
                   replicated_sharding, data_shardings, shard_data,
                   device_put, replicate_tree, Sharding)
from .data_parallel import (DataParallelBatchLoop, DataParallelMinibatchLoop,
                            make_shard_map_step, make_cache_refresh_step)
