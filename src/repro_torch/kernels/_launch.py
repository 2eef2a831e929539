"""What the kernel wrappers share: where a call runs, the checks of dtypes
and layout every kernel makes, and the typed C entry point that raises on a
CUDA error.  Each wrapper keeps its own shape checks and argument list."""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels import build

#: dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(name: str, tensors: Sequence[torch.Tensor]) -> bool:
    """True when every tensor lies on the CPU, where the wrapper takes its
    plain version; False when all lie on one CUDA device; raises
    otherwise."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    return False


def check_dtypes(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """q and the K/V storage in float32 or bfloat16, K and V alike."""
    if q.dtype not in DTYPE_CODES or k.dtype not in DTYPE_CODES \
            or v.dtype != k.dtype:
        raise ValueError(f"{name}: dtypes q {q.dtype}, K/V {k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 and bfloat16")


def check_layout(name: str, dense: Sequence[torch.Tensor],
                 aligned: Sequence[torch.Tensor]) -> None:
    """``dense`` contiguous, ``aligned`` on 16 bytes (the kernels load K/V
    rows in 16-byte vectors)."""
    if not all(t.is_contiguous() for t in dense):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError(f"{name}: K/V storage must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device, which the attention kernels' split plans
    fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


#: what every attention entry takes after its shapes and strides: scale,
#: softcap, window and the dtype codes of q and K/V
ATTENTION_SCALARS = (ctypes.c_float, ctypes.c_float, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int)


class Entry:
    """One C entry point of the kernel library.  Every entry takes
    ``n_tensors`` pointers, ``n_ints`` shapes and strides, then the
    ``scalars`` (by default those of the attention entries) and the stream,
    and returns ``cudaGetLastError()``.  It is typed at its first call,
    which builds the library, and raises if the launch failed."""

    def __init__(self, symbol: str, n_tensors: int, n_ints: int,
                 scalars: Sequence = ATTENTION_SCALARS):
        self.symbol, self.n_tensors, self.n_ints = symbol, n_tensors, n_ints
        self.scalars = tuple(scalars)
        self._fn = None

    def __call__(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(build.load(), self.symbol)
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = ([p] * self.n_tensors + [i] * self.n_ints
                           + list(self.scalars) + [p])
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err}")
