"""PyTorch/CUDA port of the EdgeShard serving stack.

A second package beside the JAX reference (``repro``): the same module
paths and names, plain PyTorch inside, and hand-written CUDA kernels for
Hopper where the reference has Pallas kernels.  It imports ``torch`` and
``numpy`` only -- never ``jax`` and nothing of ``repro``; the jax-free
host modules it needs (config, runtime protocol, scheduler, request types)
are kept as its own copies.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present they raise (see
:func:`repro_torch.device.resolve_device`).  Importing the package builds
and loads nothing CUDA-specific: kernels compile with ``nvcc`` on first use.
"""
