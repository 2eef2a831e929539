"""Causal flash attention over a whole sequence: the Hopper kernel's wrapper
and its plain PyTorch version.

Port of ``repro.kernels.flash_attention.flash_attention_bhsd`` behind the
``repro.kernels.ops.flash_attention`` calling convention (model layout)::

    q    [B, S, H, D]    float32 or bfloat16
    k, v [B, S, KH, D]   the same dtype, H a multiple of KH (GQA, MQA)
    ->   [B, S, H, D]    q's dtype

Query row ``i`` sees key ``j`` when ``j <= i`` and, with a window,
``j > i - window``.  Logits are float32, scaled by ``1/sqrt(D)``, then
soft-capped; softmax and the P V product run in float32 (the model's
``_sdpa`` instead rounds P to v's dtype before the product), and a row that
sees no key gives zeros.

- :func:`flash_attention` -- the wrapper.  On CUDA tensors it launches the
  kernel in ``csrc/flash_attention.cu`` (or raises); it takes the plain
  version only for tensors on the CPU.  ``flash_attention.launches`` counts
  kernel launches.
- :func:`flash_attention_plain` -- the plain version: the masked softmax
  over the whole [S, S] logits, the semantics of
  ``repro.kernels.ref.flash_attention_ref`` and of the TPU kernel's body.
- :func:`tile_plan` -- the kernel's walk, mirrored on the host from shapes
  alone: each block's query rows, the key tiles it visits and which of them
  take a per-element mask.

The bfloat16 kernel runs both products on the tensor cores (bf16 in,
float32 sums).  It splits each probability into three bf16 terms, ``p_0 =
bf16(p)`` and each next one bf16 of what the terms before it missed, and
adds the three products, so P V stays a float32 product to about 2**-27 of
p, as in the plain version and the TPU body: with one term (2**-9) or two
(2**-18) outputs near zero, where a row's few keys cancel, land more than a
bf16 step from the exact result.  The float32 kernel runs on the CUDA
cores.

The JAX wrapper pads S to a multiple of 128 and masks the padded keys
(``kv_len``); the kernel masks keys past S in its ragged last tile instead,
which is the same function, so this wrapper pads nothing.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels._launch import (DTYPE_CODES, Entry, check_dtypes,
                                         check_layout, on_cpu)

_launch = Entry("flash_attention_launch", n_tensors=4, n_ints=5)

#: head dims the kernel is built for
HEAD_DIMS = (32, 64, 128, 256)
#: (query rows per block, keys per tile) of the kernel's instances (its
#: Shape<T, D>): the bfloat16 one gives each warp 16 rows, 8 warps and
#: tiles of 64 keys at D <= 128, 4 warps and 32 keys at D = 256; the float32
#: one 64 rows and 64 keys at every D
BLOCK_SHAPE = {torch.bfloat16: {32: (128, 64), 64: (128, 64),
                                128: (128, 64), 256: (64, 32)},
               torch.float32: {d: (64, 64) for d in HEAD_DIMS}}


class QueryTile(NamedTuple):
    """One block's query rows ``[q0, q0 + rows)`` and its walk: key tiles
    ``first`` to ``last``, of which ``masked`` take a per-element mask."""
    q0: int
    first: int
    last: int
    masked: Tuple[int, ...]


class TilePlan(NamedTuple):
    rows: int                      # query rows per block
    keys: int                      # keys per tile
    tiles: Tuple[QueryTile, ...]   # one per block row of the grid


def tile_plan(s: int, window: Optional[int], d: int,
              dtype: torch.dtype = torch.bfloat16) -> TilePlan:
    """The kernel's walk for sequence length ``s``, from shapes alone, with
    the formulas of ``csrc/flash_attention.cu``: the block of query rows
    ``[q0, q0 + rows)`` (real rows up to ``q_hi = min(q0 + rows, s) - 1``)
    visits key tiles from ``max(0, q0 - window + 1) // keys`` (0 without a
    window) to ``q_hi // keys``; tile ``t`` (keys from ``k0 = t * keys``)
    is fully visible to every real row when ``k0 + keys - 1 <= q0`` and,
    with a window, ``k0 >= q_hi - window + 1``; every other tile of the walk
    is masked per element.  The float32 kernel masks every tile."""
    rows, keys = BLOCK_SHAPE[dtype][d]
    tiles = []
    for q0 in range(0, s, rows):
        q_hi = min(q0 + rows, s) - 1
        first = max(0, q0 - window + 1) // keys if window else 0
        last = q_hi // keys
        # the fully visible tiles form one range: [lo, hi]
        hi = (q0 - keys + 1) // keys if dtype == torch.bfloat16 else -1
        lo = -(-(q_hi - window + 1) // keys) if window else 0
        masked = tuple(t for t in range(first, min(last, lo - 1) + 1)) + \
            tuple(t for t in range(max(first, lo, hi + 1), last + 1))
        tiles.append(QueryTile(q0, first, last, masked))
    return TilePlan(rows, keys, tuple(tiles))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments and result)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    qg = q.float().reshape(b, s, kh, h // kh, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) \
        * (1.0 / math.sqrt(d))
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]                          # [S, S]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    logits = torch.where(mask, logits, -1e30)
    p = torch.where(mask, torch.exp(logits - logits.amax(-1, keepdim=True)),
                    0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgst,btkd->bkgsd", p, v.float()) / l
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Causal attention over the whole sequence (see the module docstring).

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel, and anything the kernel does not take raises -- there is no
    fallback from the card to the plain version.  The kernel has no
    backward, as the reference's Pallas kernel has none (``jax.grad``
    through it fails): on CUDA tensors it raises when autograd is on and an
    input requires a gradient.  Train on the ``"ref"`` path, or call it
    under ``torch.no_grad()``.
    """
    tensors = (q, k, v)
    if on_cpu("flash_attention", tensors):
        return flash_attention_plain(q, k, v, window=window, softcap=softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "flash_attention: the kernel has no backward (nor has the "
            "reference's Pallas kernel); take gradients on impl='ref', or "
            "call it under torch.no_grad()")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[B, S, H, D], [B, S, KH, D] and [B, S, KH, D]")
    b, s, h, d = q.shape
    kh = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}: batch, sequence and head_dim "
                         f"must match, and H be a multiple of KH")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d}; the kernel is "
                         f"built for {HEAD_DIMS}")
    check_dtypes("flash_attention", q, k, v)
    if q.dtype != k.dtype:
        raise ValueError(f"flash_attention: q {q.dtype} and K/V {k.dtype} "
                         f"must share one dtype")
    if (window is not None and window <= 0) or \
            (softcap is not None and softcap <= 0):
        raise ValueError(f"flash_attention: window {window} and softcap "
                         f"{softcap} must be positive when given")
    check_layout("flash_attention", tensors, tensors)
    plan = tile_plan(s, window, d, q.dtype)
    if len(plan.tiles) > 65535:
        raise ValueError(f"flash_attention: S={s} needs more than 65535 "
                         f"tiles of {plan.rows} query rows")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, s, h, kh, d, 1.0 / math.sqrt(d),
            float(softcap or 0.0), int(window or 0), DTYPE_CODES[q.dtype],
            DTYPE_CODES[k.dtype])
    flash_attention.launches += 1
    return out


#: kernel launches so far (the plain version on CPU tensors counts none)
flash_attention.launches = 0
