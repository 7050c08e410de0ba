from ray_tpu_torch.util.collective.async_handles import (  # noqa: F401
    CollectiveHandle,
)
from ray_tpu_torch.util.collective.collective import (  # noqa: F401
    allgather,
    allgather_object,
    allgather_async,
    allreduce,
    allreduce_async,
    barrier,
    broadcast,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    recv,
    reducescatter,
    reducescatter_async,
    send,
    sendrecv,
    supports_async,
)
