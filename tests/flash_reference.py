"""The flash kernel's one-bf16-step check, shared by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``: the plain version's arithmetic in float64, and
the count of outputs more than one bf16 step from it.

The float32 plain version rounds its logits to float32 too, so once the
logits are large (q scaled by 16) its own outputs near zero lie more than
one bf16 step (2**-7 of the binade, plus 1e-6) from the exact result.  The
check is held to the float64 result, where no such error hides the
kernel's.
"""
import math
from typing import Optional

import torch


def flash_attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """``flash_attention_plain``'s arithmetic in float64; a float64 result."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    qg = q.double().reshape(b, s, kh, h // kh, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.double()) / math.sqrt(d)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    logits = torch.where(mask, logits, -1e30)
    p = torch.where(mask, torch.exp(logits - logits.amax(-1, keepdim=True)),
                    0.0)
    o = torch.einsum("bkgst,btkd->bkgsd", p, v.double()) \
        / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def bf16_steps_apart(got: torch.Tensor, want: torch.Tensor) -> int:
    """How many outputs lie more than one bf16 step from ``want``: 2**-7 of
    its binade, plus 1e-6 near zero."""
    got, want = got.double(), want.double()
    step = torch.exp2(torch.floor(torch.log2(want.abs()))) * 2 ** -7
    return int(((got - want).abs() > step + 1e-6).sum())
