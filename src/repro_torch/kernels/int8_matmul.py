"""Weight-only int8 matmul: the Hopper kernel's wrapper, its plain PyTorch
version and the quantizer.

Port of ``repro.kernels.int8_matmul`` behind the ``repro.kernels.ops``
calling convention::

    x     [..., K] float32 or bfloat16
    w_q   [K, N]   int8
    scale [1, N]   float32
    ->  y [..., N] in x's dtype,  y = (x @ w_q) * scale

- :func:`int8_matmul` -- the wrapper (``ops.int8_matmul``: any leading
  dimensions, any M, K and N).  On CUDA tensors it launches the kernel in
  ``csrc/int8_matmul.cu`` (or raises): bfloat16 x on the tensor cores,
  float32 x on the CUDA cores.  It takes the plain version only for
  tensors on the CPU.  ``int8_matmul.launches`` counts calls that launch
  (one per call, the split-K reduction pass included).
- :func:`tile_plan` -- the kernel's rows per block, K splits and grid,
  from the shapes and the SM count alone.
- :func:`int8_matmul_plain` -- the plain version, the semantics of
  ``repro.kernels.ref.int8_matmul_ref``: the float32 product of x and w_q,
  times ``scale``, cast to x's dtype.  It forms the product in float64 and
  rounds it to float32 once, so its result does not depend on a summation
  order (the kernel sums float32 x in float64 too; see its source note).
- :func:`quantize_int8` -- per output column, symmetric:
  ``scale = max(max|w| over K, 1e-8) / 127`` and
  ``w_q = clip(round(w / scale), -127, 127)``, half to even.

No model of the JAX package quantizes its weights, so no serving or
training path reaches the kernel: the op is its entry point.  The library
yardstick (``torch.matmul`` on the dequantized weight) lives in
``chip_smoke.py`` only.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels._launch import DTYPE_CODES, Entry, on_cpu, sm_count

_launch = Entry("int8_matmul_launch", n_tensors=5, n_ints=4,
                scalars=(ctypes.c_int,))

#: K per split at least this long (a split-K block should loop over tiles)
_MIN_SPLIT_K = 256

#: output columns per block, and the rows per block at M <= ``SMALL_M``,
#: the rows above it and the K per stage of each x dtype's kernel: the
#: bfloat16 kernel on the tensor cores, the float32 one on the CUDA cores.
#: ``csrc/int8_matmul.cu`` states the same (``kBN``, ``kSmallM``,
#: ``kBf16Tiles``, ``kF32Tiles``).
BN = 128
SMALL_M = 16
TILES = {torch.bfloat16: (16, 128, 32), torch.float32: (16, 64, 16)}
#: blocks per SM the split-K plan fills, per x dtype, at M <= ``SMALL_M``
#: and above: four of the bfloat16 kernel's 16-row blocks fit an SM (64
#: registers a thread), and at llama2-7b's M = 4 projections four were
#: faster than two (``scripts/ab_int8_matmul.py --per-sm``); two of its
#: 128-row blocks fit; the float32 kernel's plan is the one it always had
BLOCKS_PER_SM = {torch.bfloat16: (4, 2), torch.float32: (2, 2)}


class TilePlan(NamedTuple):
    """How a call's output tiles and K are cut across blocks."""
    rows: int                   # output rows per block (BM)
    splits: int                 # the splits asked of the kernel
    k_chunk: int                # K per split, a whole number of stages
    grid: Tuple[int, int, int]  # (column tiles, row tiles, non-empty splits)


def tile_plan(m: int, k: int, n: int, sms: int,
              dtype: torch.dtype = torch.bfloat16) -> TilePlan:
    """The kernel's grid for x [m, k] in ``dtype`` and w_q [k, n] on a card
    of ``sms`` SMs, from the shapes alone.  K is split across blocks until
    the grid holds ``BLOCKS_PER_SM`` blocks per SM, each split at least
    ``_MIN_SPLIT_K`` long (the last one too); one split when the output
    tiles alone fill the card.  The kernel derives the same ``k_chunk`` and
    grid from ``splits``; raises where the grid exceeds CUDA's 65535 row
    tiles."""
    small, large, bk = TILES[dtype]
    rows, per_sm = ((small, BLOCKS_PER_SM[dtype][0]) if m <= SMALL_M
                    else (large, BLOCKS_PER_SM[dtype][1]))
    tiles = -(-n // BN) * -(-m // rows)
    splits = max(1, min(-(-per_sm * sms // tiles), k // _MIN_SPLIT_K))
    while True:
        k_chunk = -(-k // splits)
        k_chunk = -(-k_chunk // bk) * bk        # whole stages
        used = -(-k // k_chunk)
        if used == 1 or k - (used - 1) * k_chunk >= _MIN_SPLIT_K:
            break
        splits -= 1
    grid = (-(-n // BN), -(-m // rows), used)
    if grid[1] > 65535 or grid[2] > 65535:
        raise ValueError(f"int8_matmul: M = {m} needs {grid[1]} row tiles of "
                         f"{rows}; the kernel takes at most 65535")
    return TilePlan(rows, splits, k_chunk, grid)


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of ``w`` [K, N]:
    returns (w_q [K, N] int8, scale [1, N] float32)."""
    amax = w.float().abs().amax(dim=0, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale.float()


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the op (same arguments and result)."""
    y = (x.double() @ w_q.double()).float()
    return (y * scale).to(x.dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ int8 w_q [K, N] * scale [1, N] -> [..., N] in x's dtype.

    CPU tensors take :func:`int8_matmul_plain`; CUDA tensors launch the
    kernel, and anything the kernel does not take raises -- there is no
    fallback from the card to the plain version.
    """
    if on_cpu("int8_matmul", (x, w_q, scale)):
        return int8_matmul_plain(x, w_q, scale)
    if x.dim() < 1 or w_q.dim() != 2 or x.shape[-1] != w_q.shape[0] \
            or tuple(scale.shape) != (1, w_q.shape[1]):
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)} and scale {tuple(scale.shape)} "
                         f"must be [..., K], [K, N] and [1, N]")
    if x.dtype not in DTYPE_CODES or w_q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise ValueError(f"int8_matmul: dtypes x {x.dtype}, w_q {w_q.dtype}, "
                         f"scale {scale.dtype}; the kernel takes float32 or "
                         f"bfloat16 x, int8 w_q and float32 scale")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("int8_matmul: inputs must be contiguous")
    k, n = w_q.shape
    lead = x.shape[:-1]
    m = x.numel() // k if k else 0
    out = torch.empty(*lead, n, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    plan = tile_plan(m, k, n, sm_count(x.device), x.dtype)
    used = plan.grid[2]
    # split-K partial sums: float64 for float32 x, float32 for bfloat16 x
    part = torch.empty(used * m * n, device=x.device,
                       dtype=torch.float64 if x.dtype == torch.float32
                       else torch.float32) if used > 1 else None
    _launch(x.device, x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            m, k, n, plan.splits, DTYPE_CODES[x.dtype])
    int8_matmul.launches += 1
    return out


#: kernel launches so far (the plain version on CPU tensors counts none)
int8_matmul.launches = 0
