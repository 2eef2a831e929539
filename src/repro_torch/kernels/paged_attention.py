"""Paged GQA attention for one decode / verify step: the Hopper kernel, its
plain PyTorch version, its wrapper and its build.

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
  version only for tensors on the CPU.  ``paged_attention.launches`` counts
  kernel launches.
- :func:`paged_attention_plain` -- the plain version: gather the slot's
  blocks in ring order, mask, softmax in float32.
- :func:`build` -- ``nvcc`` at first use into ``build/repro_torch_kernels/``,
  keyed by a hash of the source and flags.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None


class Build(NamedTuple):
    """A built kernel library; ``log`` is what ``nvcc -Xptxas -v`` printed
    (registers, shared memory, spills) and ``seconds`` the compile time,
    both empty when the library was already built."""
    path: Path
    log: str = ""
    seconds: float = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the paged attention kernel is built "
                       "with the CUDA toolkit at first use on a GPU machine")


def build() -> Build:
    """Compile the kernel into a shared library, once per hash of the
    source and flags."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"paged_attention-{key}.so"
    if lib.exists():
        return Build(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{log}")
    os.replace(tmp, lib)
    return Build(lib, log, seconds)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        fn = lib.paged_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p,              # tensors
                       i, i, i, i, i, i, i, i, i,        # shapes and strides
                       ctypes.c_float, ctypes.c_float, i,  # scale, softcap, window
                       i, i, p]                          # dtypes, stream
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_plain(q, k_pool, v_pool, bt, key_pos, pos,
                                     window=window, softcap=softcap)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("paged_attention: all tensors must be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
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
    if q.dtype not in _DTYPE_CODES or k_pool.dtype not in _DTYPE_CODES \
            or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"paged_attention: dtypes q {q.dtype}, pools "
                         f"{k_pool.dtype}/{v_pool.dtype}; the kernel takes "
                         f"float32 and bfloat16")
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
    if not all(t.is_contiguous() for t in (q4, k_pool, v_pool, key_pos, pos)) \
            or bt.stride(1) != 1:
        raise ValueError("paged_attention: q, pools, key_pos and pos must be "
                         "contiguous and bt rows dense")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attention: pools must be 16-byte aligned")
    if b == 0:
        return torch.empty_like(q)
    out = torch.empty_like(q4)
    err = _load().paged_attention_launch(
        q4.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
        key_pos.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, kq, h, kh, d, bs, c // bs, bt.stride(0), n_pool,
        1.0 / math.sqrt(d), float(softcap or 0.0), int(window or 0),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out[:, 0] if q.dim() == 3 else out


#: kernel launches so far (the plain version on CPU tensors counts none)
paged_attention.launches = 0
