"""RG-LRU sequence scan: the Hopper kernel's wrapper and its plain PyTorch
version.

Port of ``repro.kernels.rglru_scan.rglru_scan_pallas`` behind the
``repro.kernels.ops.rglru_scan`` calling convention::

    log_a, b [B, S, R] float32
    h0       [B, R] float32, or None (zeros)
    ->  h    [B, S, R] float32,  h_t = exp(log_a_t) * h_{t-1} + b_t

- :func:`rglru_scan` -- the wrapper.  On CUDA tensors it launches the kernel
  in ``csrc/rglru_scan.cu`` (or raises); it takes the plain version only
  for tensors on the CPU.  ``rglru_scan.launches`` counts kernel launches.
- :func:`rglru_scan_plain` -- the plain version: the sequential recurrence
  of ``repro.kernels.ref.rglru_scan_ref``, a loop over S.

No single PyTorch operator computes a linear recurrence, so the kernel has
no library counterpart.  The model's ``impl="ref"`` path runs a log-depth
doubling scan instead (``repro_torch.models.rglru.rglru_scan``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._launch import Entry, on_cpu

_launch = Entry("rglru_scan_launch", n_tensors=4, n_ints=3, scalars=())


def rglru_scan_plain(log_a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments and result)."""
    a = torch.exp(log_a)
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0
    out = torch.empty_like(b)
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The RG-LRU scan (see the module docstring).

    CPU tensors take :func:`rglru_scan_plain`; CUDA tensors launch the
    kernel, and anything the kernel does not take raises -- there is no
    fallback from the card to the plain version.
    """
    tensors = (log_a, b) if h0 is None else (log_a, b, h0)
    if on_cpu("rglru_scan", tensors):
        return rglru_scan_plain(log_a, b, h0)
    if log_a.dim() != 3 or b.shape != log_a.shape or (
            h0 is not None and h0.shape != (log_a.shape[0], log_a.shape[2])):
        raise ValueError(f"rglru_scan: log_a {tuple(log_a.shape)}, b "
                         f"{tuple(b.shape)} and h0 "
                         f"{None if h0 is None else tuple(h0.shape)} must be "
                         f"[B, S, R], [B, S, R] and [B, R]")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"rglru_scan: dtypes {[t.dtype for t in tensors]}; "
                         f"the kernel takes float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rglru_scan: inputs must be contiguous")
    bb, s, r = log_a.shape
    if bb > 65535:
        raise ValueError(f"rglru_scan: batch {bb} > 65535")
    out = torch.empty_like(log_a)
    if out.numel() == 0:
        return out
    _launch(log_a.device, log_a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(),   # NULL: zeros
            out.data_ptr(), bb, s, r)
    rglru_scan.launches += 1
    return out


#: kernel launches so far (the plain version on CPU tensors counts none)
rglru_scan.launches = 0
