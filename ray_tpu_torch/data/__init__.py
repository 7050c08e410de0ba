"""Host batches onto the device (``data.iterator``): pinned staging, a
side-stream copy and a double buffer."""
from ray_tpu_torch.data.iterator import iter_device_batches  # noqa: F401
