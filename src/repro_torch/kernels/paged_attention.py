"""Paged GQA attention for one decode / verify step: the Hopper kernel's
wrapper and its plain PyTorch version.

Port of ``repro.kernels.decode_attention.paged_decode_attention_bhd`` (and,
with ``KQ > 1`` query tokens per slot, ``paged_verify_attention_bhd``)
behind the ``repro.kernels.ops`` wrappers' calling convention::

    q [B, H, D] or [B, KQ, H, D]       query token i of slot b sits at
                                       position pos[b] + i
    k_pool, v_pool [NB+1, bs, KH, D]   shared block pools (last = scratch)
    bt [B, >= nbs] int32               block table, -1 = unmapped
    key_pos [B, nbs*bs] int32          absolute position per ring slot
    pos [B] int32

Key ``t`` of ring slot ``ib*bs + t`` is attended by query row ``i`` when
``bt[b, ib]`` is mapped, ``0 <= key_pos <= pos + i`` and, with a window,
``key_pos > pos + i - window``.  Softmax runs in float32; a fully masked
row gives exact zeros.  The output has q's shape and dtype.

- :func:`paged_attention` -- the wrapper.  On CUDA tensors it launches the
  kernel in ``csrc/paged_attention.cu`` (or raises); it takes the plain
  version only for tensors on the CPU.  ``paged_attention.launches``
  counts wrapper calls that launched the kernel, one per call whether the
  table was split (a split pass and a merge pass) or not.
- :func:`table_split_plan` -- how many blocks share one slot's table, from
  the call's shapes and the SM count only.
- :func:`paged_attention_plain` -- the plain version: gather the slot's
  blocks in ring order, mask, softmax in float32.

The kernel is built with the port's other kernels by
:mod:`repro_torch.kernels.build`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels._launch import (DTYPE_CODES, Entry, check_dtypes,
                                         check_layout, on_cpu, sm_count)
from repro_torch.kernels.decode_attention import split_plan

_launch = Entry("paged_attention_launch", n_tensors=9, n_ints=11)


def table_split_plan(q_shape: Sequence[int], pool_shape: Sequence[int],
                     n_keys: int, n_sm: int) -> Tuple[int, int]:
    """``(S, L)``: the kernel walks each slot's table of ``n_keys`` logical
    keys in ``S`` splits of ``L`` keys, each on a block of its own.  It is
    :func:`~repro_torch.kernels.decode_attention.split_plan` at the GQA
    group ``g = H // KH`` -- not ``KQ * g`` -- so a verify call (q
    ``[B, KQ, H, D]``) splits exactly as a decode call (q ``[B, H, D]``)
    does, and its row ``i`` repeats the decode call's arithmetic at
    ``pos + i``.  Shapes and the SM count only: never ``pos``, ``key_pos``
    or ``bt``, so a call needs no host sync and can be captured in a CUDA
    graph."""
    b, h = q_shape[0], q_shape[-2]
    kh = pool_shape[2]
    return split_plan(b, kh, h // kh, n_keys, n_sm)


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, bt: torch.Tensor,
                          key_pos: torch.Tensor, pos: torch.Tensor, *,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments and result)."""
    q4 = q[:, None] if q.dim() == 3 else q
    b, kq, h, d = q4.shape
    n_pool, bs, kh = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    g = h // kh
    c = key_pos.shape[1]
    table = bt[:, :c // bs].long()
    mapped = (table >= 0) & (table < n_pool)
    read = torch.where(mapped, table, n_pool - 1)
    ck = k_pool[read].reshape(b, c, kh, d).float()
    cv = v_pool[read].reshape(b, c, kh, d).float()
    kp = key_pos.long()
    qpos = pos.long()[:, None] + torch.arange(kq, device=q.device)   # [B, KQ]
    valid = (kp >= 0) & mapped.repeat_interleave(bs, dim=1)          # [B, C]
    mask = valid[:, None, :] & (kp[:, None, :] <= qpos[:, :, None])
    if window is not None:
        mask &= kp[:, None, :] > qpos[:, :, None] - window
    qg = q4.float().reshape(b, kq, kh, g, d)
    s = torch.einsum("bikgd,bckd->bkgic", qg, ck) * (1.0 / math.sqrt(d))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    m5 = mask[:, None, None]                                  # [B,1,1,KQ,C]
    s = torch.where(m5, s, -1e30)
    p = torch.where(m5, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgic,bckd->bkgid", p, cv) / l          # [B,KH,g,KQ,D]
    o = o.permute(0, 3, 1, 2, 4).reshape(b, kq, h, d).to(q.dtype)
    return o[:, 0] if q.dim() == 3 else o


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, bt: torch.Tensor,
                    key_pos: torch.Tensor, pos: torch.Tensor, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Paged attention through the block table (see the module docstring).

    CPU tensors take :func:`paged_attention_plain`; CUDA tensors launch the
    kernel, and anything the kernel does not take raises -- there is no
    fallback from the card to the plain version.
    """
    tensors = (q, k_pool, v_pool, bt, key_pos, pos)
    if on_cpu("paged_attention", tensors):
        return paged_attention_plain(q, k_pool, v_pool, bt, key_pos, pos,
                                     window=window, softcap=softcap)
    q4 = q[:, None] if q.dim() == 3 else q
    if q4.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged_attention: bad shapes q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    b, kq, h, d = q4.shape
    n_pool, bs, kh, dk = k_pool.shape
    if dk != d or h % kh or d % 32 or d > 256:
        raise ValueError(f"paged_attention: head_dim {d} (pools {dk}) must "
                         f"be a multiple of 32 up to 256 and H={h} a "
                         f"multiple of KH={kh}")
    check_dtypes("paged_attention", q, k_pool, v_pool)
    c = key_pos.shape[-1]
    if key_pos.shape != (b, c) or c % bs or pos.shape != (b,) \
            or bt.dim() != 2 or bt.shape[0] != b or bt.shape[1] < c // bs:
        raise ValueError(f"paged_attention: bt {tuple(bt.shape)}, key_pos "
                         f"{tuple(key_pos.shape)}, pos {tuple(pos.shape)} do "
                         f"not fit B={b}, bs={bs}")
    if (window is not None and window <= 0) or \
            (softcap is not None and softcap <= 0):
        raise ValueError(f"paged_attention: window {window} and softcap "
                         f"{softcap} must be positive when given")
    if any(t.dtype != torch.int32 for t in (bt, key_pos, pos)):
        raise ValueError("paged_attention: bt, key_pos and pos must be int32")
    if bt.stride(1) != 1:
        raise ValueError("paged_attention: bt rows must be dense")
    check_layout("paged_attention", (q4, k_pool, v_pool, key_pos, pos),
                 (k_pool, v_pool))
    if b == 0:
        return torch.empty_like(q)
    out = torch.empty_like(q4)
    splits, split_len = table_split_plan(q4.shape, k_pool.shape, c,
                                         sm_count(q.device))
    # the splits' (m, l) and acc, held here until the launch is queued
    part = [torch.empty((b, kq, h, splits, n), dtype=torch.float32,
                        device=q.device) for n in (2, d)] \
        if splits > 1 else []
    part_ptrs = [t.data_ptr() for t in part] or [None, None]
    _launch(q.device,
            q4.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
            key_pos.data_ptr(), pos.data_ptr(), out.data_ptr(), *part_ptrs,
            b, kq, h, kh, d, bs, c // bs, bt.stride(0), n_pool, splits,
            split_len, 1.0 / math.sqrt(d), float(softcap or 0.0),
            int(window or 0), DTYPE_CODES[q.dtype],
            DTYPE_CODES[k_pool.dtype])
    paged_attention.launches += 1
    return out[:, 0] if q.dim() == 3 else out


#: wrapper calls that launched the kernel so far (the plain version on CPU
#: tensors counts none)
paged_attention.launches = 0
