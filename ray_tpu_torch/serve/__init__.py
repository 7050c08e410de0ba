"""Serve's shape-bucketing request batcher (``serve.batching``)."""
from ray_tpu_torch.serve.batching import batch  # noqa: F401
