from vadcl_tpu_torch.parallel.sharding import (
    cross_host_concat,
    cross_host_gather_ragged,
    global_max,
    global_sum,
)

__all__ = ["cross_host_concat", "cross_host_gather_ragged", "global_max", "global_sum"]
