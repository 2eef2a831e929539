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
- :func:`scan_plan` -- the kernel's launch plan (channels a block, steps a
  stage, stages, copy width, copy warps, grid, shared memory) from the
  shapes, the inputs' alignment and the SM count only; the wrapper passes
  it to the C entry as it is.
- :func:`rglru_scan_plain` -- the plain version: the sequential recurrence
  of ``repro.kernels.ref.rglru_scan_ref``, a loop over S.

No single PyTorch operator computes a linear recurrence, so the kernel has
no library counterpart.  The model's ``impl="ref"`` path runs a log-depth
doubling scan instead (``repro_torch.models.rglru.rglru_scan``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels._launch import Entry, on_cpu, sm_count

_launch = Entry("rglru_scan_launch", n_tensors=4, n_ints=8, scalars=())

#: channels a block: the chain warp's 32 lanes, one 128-byte row of a step
STRIP = 32
#: the launch plan by the blocks an SM holds (the grid's blocks over the SM
#: count) and the steps: (more blocks an SM than, at least S, steps a
#: stage, stages, copy warps), the first row that applies.  With more than
#: one block an SM the SM's issue slots are shared by every block's warps,
#: and short stages with few copy warps do best (two from 512 steps; at
#: 256 steps three fill the ring sooner); with one block
#: an SM or fewer, long stages and many copy warps keep each chain fed
#: (NVIDIA H100 80GB HBM3, 700 W: PERF.md §6, row 5, from
#: ``scripts/ab_rglru_scan.py --plans``).
PLAN_TABLE = ((2.0, 512, 32, 4, 2), (1.5, 1, 32, 4, 3), (0.9, 1, 64, 4, 5),
              (0.0, 1, 128, 3, 7))


class ScanPlan(NamedTuple):
    """How ``csrc/rglru_scan.cu`` runs one call: ``strip`` channels a
    block, ``stages`` shared-memory stages of ``steps`` steps each,
    ``copy_warps`` warps beside the chain warp that fill them.  ``vec`` is
    the floats a copy moves: 4 (16-byte ``cp.async``) or 1 (4-byte, when
    R % 4 != 0 or a base is not 16-byte aligned).  ``grid`` is (strips,
    slots); ``smem_bytes`` the ring's dynamic shared memory."""
    strip: int
    steps: int
    stages: int
    vec: int
    copy_warps: int
    grid: Tuple[int, int]
    smem_bytes: int


def scan_plan(shape: Sequence[int], aligned: bool, n_sm: int) -> ScanPlan:
    """The launch plan of a call on ``log_a``/``b`` of ``shape`` [B, S, R]
    on a card of ``n_sm`` SMs; ``aligned``: both bases lie on 16 bytes.
    Shapes, alignment and the SM count only, so a call needs no host sync
    and can be captured in a CUDA graph."""
    b, s, r = shape
    grid = (-(-r // STRIP), b)
    per_sm = grid[0] * grid[1] / n_sm
    steps, stages, copy_warps = next(row[2:] for row in PLAN_TABLE
                                     if per_sm > row[0] and s >= row[1])
    stages = min(stages, -(-s // steps))
    vec = 4 if aligned and r % 4 == 0 else 1
    return ScanPlan(STRIP, steps, stages, vec, copy_warps, grid,
                    stages * 2 * steps * STRIP * 4)


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
    plan = scan_plan(log_a.shape, log_a.data_ptr() % 16 == 0
                     and b.data_ptr() % 16 == 0, sm_count(log_a.device))
    _launch(log_a.device, log_a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(),   # NULL: zeros
            out.data_ptr(), bb, s, r, plan.strip, plan.steps, plan.stages,
            plan.vec, plan.copy_warps)
    rglru_scan.launches += 1
    return out


#: kernel launches so far (the plain version on CPU tensors counts none)
rglru_scan.launches = 0
