"""AIR's checkpoint (``air.checkpoint.Checkpoint``): dict, directory,
bytes and URI forms, and the port's ``torch_state`` form."""
from ray_tpu_torch.air.checkpoint import Checkpoint  # noqa: F401
