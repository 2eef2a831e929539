"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the GPU.

    There is no silent CPU fallback: with ``device=None`` and no CUDA
    device present this raises, so a run that was meant for the card can
    never quietly measure the CPU.  Pass ``device="cpu"`` to run on the CPU
    on purpose (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


def torch_dtype(name: Optional[str]) -> torch.dtype:
    """``ModelConfig.dtype`` strings ("bfloat16", "float32", ...) as torch
    dtypes."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype
