"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, beside it.

It runs the GPT-2 training step of ``ray_tpu`` on an NVIDIA H100 through
the same module layout and public names (``models.gpt2``,
``models.layers``, ``ops.flash_attention``, ``parallel.train_step``,
``parallel.ring_attention``), with hand-written Hopper kernels where
``ray_tpu`` has Pallas kernels. It imports torch and never jax, and
nothing of ``ray_tpu``. Entry points run on the CUDA device unless the
caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
