from .dist import (all_reduce_sum, all_reduce_sum_grad, batch_is_sharded, broadcast_state,
                   gather_rows, gather_views_major, get_dist_info, init_distributed,
                   is_distributed, join_launcher, launcher_env, row_counts, shard_sum,
                   shard_sum_grad, sharded_batch, sum_gradients)

__all__ = ["all_reduce_sum", "all_reduce_sum_grad", "batch_is_sharded", "broadcast_state",
           "gather_rows", "gather_views_major", "get_dist_info", "init_distributed",
           "is_distributed", "join_launcher", "launcher_env", "row_counts", "shard_sum",
           "shard_sum_grad", "sharded_batch", "sum_gradients"]
