"""Stub modality frontends.  Port of ``repro.models.frontends``.

The ``[vlm]`` and ``[audio]`` configs (pixtral-12b, musicgen-large) specify
the transformer backbone only; their ViT and EnCodec frontends are stubs
that provide *precomputed* patch or frame embeddings of the right shape,
which ``transformer.forward`` and ``decode_step`` take as float inputs.
Raw pixels or waveforms never leave the source device; only embeddings
enter the backbone.

The reference's ``jax.ShapeDtypeStruct`` carriers are tensors on the
``meta`` device here: a shape and a dtype, no storage.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import Device, resolve_device, torch_dtype
from repro_torch.models.config import ModelConfig


def frontend_embedding_spec(cfg: ModelConfig, batch: int,
                            seq_len: int) -> torch.Tensor:
    """The shape and dtype of the embeddings the stub frontend produces,
    ``[batch, seq_len, d_model]`` in the model dtype, on ``meta``."""
    if cfg.frontend not in ("vision", "audio"):
        raise ValueError(f"{cfg.name} has no frontend (frontend="
                         f"{cfg.frontend!r})")
    return torch.empty((batch, seq_len, cfg.d_model),
                       dtype=torch_dtype(cfg.dtype), device="meta")


def fake_frontend_embeddings(cfg: ModelConfig, generator: torch.Generator,
                             batch: int, seq_len: int,
                             device: Device = None) -> torch.Tensor:
    """Deterministic stand-in embeddings for tests and smoke runs: standard
    normal draws from ``generator`` (which must live on ``device``) in the
    model dtype, scaled by ``1/sqrt(d_model)``.

    Vision: patch embeddings (pixtral's ViT output after the projector).
    Audio: EnCodec frame embeddings (musicgen consumes token embeddings of
    interleaved codebooks; the stub collapses them to one stream).  The
    draws differ from ``jax.random``'s for the same seed.
    """
    dev = resolve_device(device)
    x = torch.randn((batch, seq_len, cfg.d_model), generator=generator,
                    device=dev, dtype=torch_dtype(cfg.dtype))
    return x / math.sqrt(cfg.d_model)


def input_spec_for(cfg: ModelConfig, batch: int, seq_len: int,
                   decode: bool = False) -> torch.Tensor:
    """The input's shape and dtype for an (arch, shape) combination, on
    ``meta``.  Decode steps consume token ids ``[batch]`` (the frontend only
    runs on the prompt); sequence modes consume embeddings for a
    stub-frontend config and token ids ``[batch, seq_len]`` otherwise."""
    if decode:
        return torch.empty((batch,), dtype=torch.int32, device="meta")
    if cfg.frontend is not None:
        return frontend_embedding_spec(cfg, batch, seq_len)
    return torch.empty((batch, seq_len), dtype=torch.int32, device="meta")
