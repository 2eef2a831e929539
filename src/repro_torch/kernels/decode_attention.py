"""GQA attention for one decode step over contiguous ring caches: the Hopper
kernel's wrapper and its plain PyTorch version.

Port of ``repro.kernels.decode_attention.decode_attention_bhd`` behind the
``repro.kernels.ops.decode_attention`` calling convention::

    q [B, H, D] or [B, 1, H, D]
    k_cache, v_cache [B, C, KH, D]   float32 or bfloat16 ring caches
    key_pos [C] or [B, C] int32      absolute position per ring slot
    pos [] or [B] int32              decode position (per row after a
                                     masked, length-bucketed prefill)

Ring slot ``c`` of row ``b`` is attended when ``key_pos >= 0``,
``key_pos <= pos`` and, with a window, ``key_pos > pos - window``.  Softmax
runs in float32; a fully masked row gives exact zeros.  The output has q's
shape and dtype.

- :func:`decode_attention` -- the wrapper.  On CUDA tensors it launches the
  kernel in ``csrc/decode_attention.cu`` (or raises); it takes the plain
  version only for tensors on the CPU.  ``decode_attention.launches``
  counts wrapper calls that launched the kernel, one per call whether the
  ring was split (a split pass and a merge pass) or not.
- :func:`split_plan` -- how many blocks share one slot's ring, from shapes
  and the SM count only.
- :func:`decode_attention_plain` -- the plain version: mask, softmax in
  float32 over the whole ring.

The kernel is built with the port's other kernels by
:mod:`repro_torch.kernels.build`.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels._launch import (DTYPE_CODES, Entry, check_dtypes,
                                         check_layout, on_cpu, sm_count)

_launch = Entry("decode_attention_launch", n_tensors=8, n_ints=9)

#: keys per tile, query rows per block and most splits of the kernel
#: (kTileKeys, kRowsPerBlock and kMaxSplits in csrc/decode_attention.cu)
TILE_KEYS, ROWS_PER_BLOCK, MAX_SPLITS = 64, 16, 64
#: the longest split the plan aims at, and the blocks per SM it aims at
SPLIT_KEYS, BLOCKS_PER_SM = 256, 4


def split_plan(b: int, kh: int, g: int, c: int, n_sm: int) -> Tuple[int, int]:
    """``(S, L)``: the kernel walks each slot's ``c``-key ring in ``S``
    splits of ``L`` keys, a whole number of tiles, each split on a block of
    its own (``b * kh * ceil(g / 16)`` blocks before the split, ``n_sm``
    SMs).  S aims at ``BLOCKS_PER_SM`` blocks per SM and at splits of at
    most ``SPLIT_KEYS`` keys, at most one split per tile and
    ``MAX_SPLITS`` in all; so S is 1 when the blocks already fill the card
    and the ring is short.  It depends on shapes only -- never on ``pos``
    or ``key_pos``, which would need a host sync and would break a CUDA
    graph's capture."""
    tiles = -(-c // TILE_KEYS)
    blocks = b * kh * -(-g // ROWS_PER_BLOCK)
    want = max(-(-BLOCKS_PER_SM * n_sm // blocks), -(-c // SPLIT_KEYS))
    per = -(-tiles // max(1, min(want, tiles, MAX_SPLITS)))   # tiles a split
    return -(-tiles // per), per * TILE_KEYS


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, key_pos: torch.Tensor,
                           pos: torch.Tensor, *, window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments and result)."""
    q3 = q[:, 0] if q.dim() == 4 else q
    b, h, d = q3.shape
    c, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    kp = key_pos.long().expand(b, c)                             # [B, C]
    qpos = pos.long().expand(b)[:, None]                         # [B, 1]
    mask = (kp >= 0) & (kp <= qpos)
    if window is not None:
        mask &= kp > qpos - window
    qg = q3.float().reshape(b, kh, g, d)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float()) \
        * (1.0 / math.sqrt(d))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    m4 = mask[:, None, None]                                     # [B,1,1,C]
    s = torch.where(m4, s, -1e30)
    p = torch.where(m4, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float()) / l
    o = o.reshape(b, h, d).to(q.dtype)
    return o[:, None] if q.dim() == 4 else o


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, key_pos: torch.Tensor,
                     pos: torch.Tensor, *, window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Decode attention over ring caches (see the module docstring).

    CPU tensors take :func:`decode_attention_plain`; CUDA tensors launch
    the kernel, and anything the kernel does not take raises -- there is no
    fallback from the card to the plain version.
    """
    tensors = (q, k_cache, v_cache, key_pos, pos)
    if on_cpu("decode_attention", tensors):
        return decode_attention_plain(q, k_cache, v_cache, key_pos, pos,
                                      window=window, softcap=softcap)
    q3 = q[:, 0] if q.dim() == 4 and q.shape[1] == 1 else q
    if q3.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)}")
    b, h, d = q3.shape
    bk, c, kh, dk = k_cache.shape
    if bk != b or c == 0 or dk != d or h % kh or d % 32 or d > 256:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)}: head_dim must match, be a "
                         f"multiple of 32 up to 256, and H a multiple of KH")
    check_dtypes("decode_attention", q, k_cache, v_cache)
    if key_pos.shape not in ((c,), (b, c)) or pos.shape not in ((), (b,)):
        raise ValueError(f"decode_attention: key_pos {tuple(key_pos.shape)} "
                         f"and pos {tuple(pos.shape)} do not fit B={b}, C={c}")
    if key_pos.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("decode_attention: key_pos and pos must be int32")
    if (window is not None and window <= 0) or \
            (softcap is not None and softcap <= 0):
        raise ValueError(f"decode_attention: window {window} and softcap "
                         f"{softcap} must be positive when given")
    check_layout("decode_attention", (q3, k_cache, v_cache, key_pos, pos),
                 (k_cache, v_cache))
    if b == 0:
        return torch.empty_like(q)
    out = torch.empty_like(q3)
    splits, split_len = split_plan(b, kh, h // kh, c, sm_count(q.device))
    # the splits' (m, l) and acc, held here until the launch is queued
    part = [torch.empty((b, h, splits, n), dtype=torch.float32,
                        device=q.device) for n in (2, d)] if splits > 1 else []
    part_ptrs = [t.data_ptr() for t in part] or [None, None]
    _launch(q.device,
            q3.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            key_pos.data_ptr(), pos.data_ptr(), out.data_ptr(), *part_ptrs,
            b, h, kh, d, c, c if key_pos.dim() == 2 else 0, pos.dim(),
            splits, split_len,
            1.0 / math.sqrt(d), float(softcap or 0.0), int(window or 0),
            DTYPE_CODES[q.dtype], DTYPE_CODES[k_cache.dtype])
    decode_attention.launches += 1
    return out[:, None] if q.dim() == 4 else out


#: wrapper calls that launched the kernel so far (the plain version on CPU
#: tensors counts none)
decode_attention.launches = 0
