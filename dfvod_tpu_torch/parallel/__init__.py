"""Data parallelism, clip-parallel serving and training over
``torch.distributed`` (counterpart of ``dfvod_tpu/parallel/``): one
process per card, as the reference runs (``util/misc.py:441-479``, ``tools/launch.py``), where the
JAX package runs one program over a device mesh."""
from dfvod_tpu_torch.parallel.dist import (  # noqa: F401
    all_gather_rows,
    all_reduce_sum,
    barrier,
    check_divisible,
    clip_group_rows,
    clip_layout,
    collective_device,
    gather_rows,
    init_distributed,
    initialized,
    is_main_process,
    local_devices,
    make_groups,
    rank,
    reduce_mean,
    reduce_scatter_rows,
    shard_rows,
    spawn,
    under_torchrun,
    world,
)
