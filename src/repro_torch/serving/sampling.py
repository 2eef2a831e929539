"""Host sampling for the serving path, on ``torch.Generator`` s.

Port of ``repro.serving.sampling``.  Each request draws from its own
generator, seeded from ``(seed, uid)`` (:func:`request_generator`), so a
request's tokens do not depend on which other requests share its batch.
``torch`` and ``jax.random`` give different numbers for the same seed:
temperature > 0 outputs of the two packages agree in distribution only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.types import SamplingParams


def request_generator(seed: int, uid: int) -> torch.Generator:
    """A CPU generator seeded from ``(seed, uid)``."""
    state = np.random.SeedSequence([int(seed), int(uid)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(state))
    return gen


def sample_logits(generator: torch.Generator, logits: torch.Tensor,
                  sp: SamplingParams) -> torch.Tensor:
    """logits [B, V] -> tokens [B] (int64); greedy when temperature <= 0."""
    if sp.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / sp.temperature
    if sp.top_k:
        kth = torch.topk(logits, sp.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
