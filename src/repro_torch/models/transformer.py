"""Decoder-only transformer over attention, RG-LRU, mLSTM and sLSTM blocks,
with dense or mixture-of-experts FFNs: the train-mode forward and its
losses, prefill, decode and speculative verify.

Port of the entry points of ``repro.models.transformer``:

- :func:`forward`     -- ``mode="train"``: logits over the full sequence, no
  caches; ``mode="prefill"``: logits over the (left-padded) prompt plus
  populated ring caches,
- :func:`forward_hidden`, :func:`cross_entropy_loss`, :func:`chunked_xent`
  and :func:`train_loss` -- the training objective,
- :func:`decode_step` -- one token in, one logits row out, over ring or
  paged caches,
- :func:`extend_step` -- a prompt chunk in at its absolute positions, over
  paged caches that already hold the keys before it (streamed admission),
- :func:`verify_step` -- K tokens in, K logits rows out, over paged caches.

Every entry point takes integer tokens or a stub frontend's float
embeddings (``models/frontends.py``) and adds sinusoidal position
embeddings where the config asks for them (:func:`_embed_inputs`).

Parameters are the reference's tree with the layer stack unrolled (see
:mod:`repro_torch.bridge`)::

    {"embedding": [V, d], "lm_head": [d, V] (untied only),
     "final_norm": {"scale": [d]}, "layers": [per-layer dict, ...]}

and caches are one dict per layer.  A Python loop over layers replaces the
reference's ``lax.scan`` over stacked parameters, and the caches update in
place (``index_put_``) where the reference rebuilt them.  A block's mixer
is attention, RG-LRU (the hybrid recurrentgemma), mLSTM or sLSTM (xLSTM);
its FFN is dense, a mixture of experts (granite-moe, kimi-k2; see
:mod:`repro_torch.models.moe`) or absent.  The MoE blocks' load-balance
losses sum over layers into the auxiliary loss of :func:`forward_hidden`
and :func:`train_loss`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru, xlstm
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.kvcache import (DEFAULT_BLOCK_SIZE, init_block_cache,
                                        init_paged_block_cache)
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       lm_logits, sinusoidal_embedding)

#: the modes of :func:`forward`
FORWARD_MODES = ("train", "prefill")

Caches = List[Dict[str, torch.Tensor]]


#: the block kinds whose mixers the port runs
BLOCK_KINDS = ("attn", "rglru", "mlstm", "slstm")

#: the sequence and decode functions of each recurrent mixer
_RECURRENT = {
    "rglru": (rglru.apply_rglru_seq, rglru.apply_rglru_decode),
    "mlstm": (xlstm.apply_mlstm_seq, xlstm.apply_mlstm_decode),
    "slstm": (xlstm.apply_slstm_seq, xlstm.apply_slstm_decode),
}


def _check_block(spec: BlockSpec) -> None:
    if spec.kind not in BLOCK_KINDS:
        raise ValueError(f"unknown block kind {spec.kind!r}: expected one "
                         f"of {BLOCK_KINDS}")


def _specs(cfg: ModelConfig, layers: Optional[Sequence[int]]):
    specs = cfg.layer_specs()
    return specs if layers is None else [specs[l] for l in layers]


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16, device=None,
                layers: Optional[Sequence[int]] = None) -> Caches:
    """Ring caches, one per layer (of ``layers``: default every layer): the
    contiguous layout, and the prefill workspace of both layouts."""
    return [init_block_cache(cfg, spec, batch, max_len, dtype, device)
            for spec in _specs(cfg, layers)]


def init_paged_caches(cfg: ModelConfig, batch: int, max_len: int,
                      num_blocks: int, block_size: int = DEFAULT_BLOCK_SIZE,
                      dtype: torch.dtype = torch.bfloat16,
                      device=None,
                      layers: Optional[Sequence[int]] = None) -> Caches:
    """Paged caches, one per layer (of ``layers``: default every layer;
    ``batch`` = slots): an attention layer holds a block pool plus per-slot
    block tables; any other layer keeps its dense per-slot state (``pos``
    is per-slot [B] in every layout, so each slot owns its position in the
    batched decode)."""
    return [init_paged_block_cache(cfg, spec, batch, max_len, num_blocks,
                                   block_size, dtype, device)
            if spec.kind == "attn" else
            init_block_cache(cfg, spec, batch, max_len, dtype, device)
            for spec in _specs(cfg, layers)]


def _apply_block(cfg: ModelConfig, spec: BlockSpec, params: Dict,
                 x: torch.Tensor, positions: Optional[torch.Tensor], mode: str,
                 cache: Optional[Dict], impl: str,
                 write_mask: Optional[torch.Tensor] = None,
                 seq_valid: Optional[torch.Tensor] = None,
                 verify_lens: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """One block -> (x, its aux loss: the MoE load-balance term, a float32
    scalar tensor, or 0.0 for a dense FFN); ``cache`` updates in place
    (``None`` in train mode).  ``seq_valid`` ([B, S], masked prefill and verify) re-zeroes pad
    activations on exit so they cannot leak into later layers; recurrent
    blocks treat its pad steps as state-preserving no-ops.  Decode reads an
    attention cache by its kind: a paged cache holds a block pool
    (``k_pool``), a ring cache ``k``.  Extend and verify need attention
    caches, as in the reference."""
    _check_block(spec)
    if mode in ("extend", "verify") and spec.kind != "attn":
        raise ValueError(
            f"{mode} (chunked/offset prefill or speculative verify) requires "
            f"attention caches; got {spec.kind!r} -- gate via "
            f"kvcache.prefix_sharing_supported")
    h = apply_norm(params["norm1"], x, cfg.norm)
    if spec.kind in _RECURRENT:
        seq_fn, decode_fn = _RECURRENT[spec.kind]
        if mode == "decode":
            mix, _ = decode_fn(params["mixer"], cfg, h, cache)
        elif mode not in ("train", "prefill"):
            raise ValueError(f"unknown mode {mode!r}")
        elif spec.kind == "rglru":
            mix, _ = seq_fn(params["mixer"], cfg, h, cache, impl,
                            seq_valid=seq_valid)
        else:
            mix, _ = seq_fn(params["mixer"], cfg, h, cache,
                            seq_valid=seq_valid)
    elif mode == "train":
        mix = attn.attend_full(params["mixer"], cfg, spec, h, positions, impl)
    elif mode == "prefill":
        mix, _ = attn.prefill_cache(params["mixer"], cfg, spec, h, positions,
                                    cache, impl)
    elif mode == "extend":
        mix, _ = attn.extend_cache(params["mixer"], cfg, spec, h, positions,
                                   seq_valid, cache, impl)
    elif mode == "verify":
        mix, _ = attn.attend_verify_paged(params["mixer"], cfg, spec, h,
                                          verify_lens, cache, impl)
    elif mode == "decode" and "k_pool" in cache:
        mix, _ = attn.attend_decode_paged(params["mixer"], cfg, spec, h,
                                          cache, impl, write_mask=write_mask)
    elif mode == "decode":
        mix, _ = attn.attend_decode(params["mixer"], cfg, spec, h, cache,
                                    impl)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if cfg.post_norm:
        mix = apply_norm(params["post_norm1"], mix, cfg.norm)
    x = x + mix
    aux = 0.0
    if spec.moe is not None or spec.mlp != "none":
        h2 = apply_norm(params["norm2"], x, cfg.norm)
        if spec.moe is not None:
            ffn, aux = moe_mod.apply_moe(params["ffn"], cfg, spec.moe, h2)
        else:
            ffn = apply_mlp(params["ffn"], h2, spec.mlp)
        if cfg.post_norm:
            ffn = apply_norm(params["post_norm2"], ffn, cfg.norm)
        x = x + ffn
    if seq_valid is not None:
        x = torch.where(seq_valid[..., None], x, 0)
    return x, aux


def _embed_inputs(cfg: ModelConfig, params: Dict, inputs: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """The first block's input: integer tokens [B, S] through the
    embedding, or a frontend's float embeddings [B, S, d] cast to the
    model dtype (the embedding's), plus the sinusoidal position embeddings
    for ``pos_emb="sinusoidal"`` at ``positions`` [S] (shared by the batch)
    or [B, S] (per row)."""
    if inputs.is_floating_point():
        x = inputs.to(params["embedding"].dtype)
    else:
        x = embed_tokens(params, cfg, inputs)
    return add_positions(cfg, x, positions)


def add_positions(cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """``x`` plus the sinusoidal position embeddings at ``positions`` for
    ``pos_emb="sinusoidal"``; ``x`` as it is otherwise."""
    if cfg.pos_emb == "sinusoidal":
        emb = sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
        x = x + (emb if emb.dim() == x.dim() else emb[None])
    return x


def _first_pos(caches: Caches) -> torch.Tensor:
    """The slots' decode positions [B]: an attention layer's ``pos`` (a
    ring's or a pool's), else the first layer's."""
    for cache in caches:
        if "key_pos" in cache:
            return cache["pos"]
    return caches[0]["pos"]


def forward(cfg: ModelConfig, params: Dict, inputs: torch.Tensor,
            caches: Optional[Caches] = None, *, mode: str = "prefill",
            prompt_lens: Optional[torch.Tensor] = None,
            impl: str = "ref") -> Tuple[torch.Tensor, Optional[Caches]]:
    """inputs [B, S] int tokens, or [B, S, d] float embeddings (a
    frontend's) -> (logits [B, S, vocab], caches or None).

    ``mode="train"``: the full sequence at positions ``0 .. S-1``, no caches
    (``caches`` and ``prompt_lens`` must be None); returns (logits, None).
    ``impl="cuda"`` runs the flash-attention kernel, which has no backward:
    take gradients on ``"ref"``, as the reference takes them on ``"xla"``.

    ``mode="prefill"`` fills ``caches``.  ``prompt_lens`` ([B] int) marks
    inputs as *left-padded* to S with true lengths ``prompt_lens[b]``:
    positions become per-row (``s - (S - plen)``; negative at pads), pad
    keys are masked out of attention and written with ``key_pos == -1``,
    and pad activations are zeroed between blocks -- so logits at real
    positions and the resulting caches are independent of the padded width.
    """
    if mode not in FORWARD_MODES:
        raise ValueError(f"unknown mode {mode!r}: expected one of "
                         f"{FORWARD_MODES}")
    if mode == "train":
        if caches is not None or prompt_lens is not None:
            raise ValueError("mode='train' takes no caches and no "
                             "prompt_lens")
        hidden, _ = forward_hidden(cfg, params, inputs, impl)
        return lm_logits(params, cfg, hidden), None
    if caches is None:
        raise ValueError("mode='prefill' needs caches (init_caches)")
    b, s = inputs.shape[:2]
    cols = torch.arange(s, dtype=torch.int32, device=inputs.device)
    if prompt_lens is None:
        positions, seq_valid = cols, None
    else:
        plen = prompt_lens.to(device=inputs.device, dtype=torch.int32)
        positions = cols[None] - (s - plen)[:, None]                 # [B, S]
        seq_valid = positions >= 0
    x = _embed_inputs(cfg, params, inputs, positions)
    if seq_valid is not None:
        x = torch.where(seq_valid[..., None], x, 0)
    for spec, p, cache in zip(cfg.layer_specs(), params["layers"], caches):
        x, _ = _apply_block(cfg, spec, p, x, positions, "prefill", cache,
                            impl, seq_valid=seq_valid)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params, cfg, x), caches


def forward_hidden(cfg: ModelConfig, params: Dict, inputs: torch.Tensor,
                   impl: str = "ref") -> Tuple[torch.Tensor, torch.Tensor]:
    """The train-mode forward up to the final normalized hidden state
    [B, S, d] (no logits: :func:`chunked_xent` computes them blockwise),
    and the auxiliary loss: the MoE blocks' load-balance terms summed over
    layers (float32 zeros for a model without MoE blocks)."""
    s = inputs.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=inputs.device)
    x = _embed_inputs(cfg, params, inputs, positions)
    aux_total = torch.zeros((), dtype=torch.float32, device=inputs.device)
    for spec, p in zip(cfg.layer_specs(), params["layers"]):
        x, aux = _apply_block(cfg, spec, p, x, positions, "train", None, impl)
        aux_total = aux_total + aux
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, aux_total


def _nll(logits: torch.Tensor, labels: torch.Tensor,
         z_loss: float) -> torch.Tensor:
    """Per-token NLL in float32 plus ``z_loss * logsumexp**2``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return logz - gold + z_loss * logz.square()


def cross_entropy_loss(cfg: ModelConfig, logits: torch.Tensor,
                       labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_loss: float = 1e-4) -> torch.Tensor:
    """Mean next-token NLL in float32 plus ``z_loss * logsumexp**2``; with
    ``mask`` ([B, S], 1 for counted tokens) the masked mean."""
    nll = _nll(logits, labels, z_loss)
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def chunked_xent(cfg: ModelConfig, params: Dict, hidden: torch.Tensor,
                 labels: torch.Tensor, chunk: int,
                 z_loss: float = 1e-4) -> torch.Tensor:
    """Cross entropy (with z-loss, unmasked) over sequence chunks of
    ``chunk`` positions, never holding the [B, S, V] logits at once; S must
    be a multiple of ``chunk``.  A Python loop replaces the reference's
    ``lax.scan``."""
    b, s, _ = hidden.shape
    if s % chunk:
        raise ValueError(f"chunked_xent: S={s} is no multiple of chunk "
                         f"{chunk}")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        logits = lm_logits(params, cfg, hidden[:, c0:c0 + chunk])
        total = total + _nll(logits, labels[:, c0:c0 + chunk], z_loss).sum()
    return total / (b * s)


def train_loss(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
               labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
               impl: str = "ref", xent_chunk: Optional[int] = None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {"ce", "aux"}): the cross entropy of ``labels`` under the
    train-mode forward of ``tokens``, through :func:`chunked_xent` when
    ``xent_chunk`` is set (which ignores ``mask``, as in the reference).
    ``total`` is ``ce + load_balance_weight * aux``, the weight read from
    the pattern's (last) MoE spec; without MoE blocks ``aux`` is 0."""
    hidden, aux = forward_hidden(cfg, params, tokens, impl)
    if xent_chunk:
        ce = chunked_xent(cfg, params, hidden, labels, xent_chunk)
    else:
        ce = cross_entropy_loss(cfg, lm_logits(params, cfg, hidden), labels,
                                mask)
    lb_weight = 0.0
    for spec in cfg.pattern:
        if spec.moe is not None:
            lb_weight = spec.moe.load_balance_weight
    return ce + lb_weight * aux, {"ce": ce, "aux": aux}


def decode_step(cfg: ModelConfig, params: Dict, inputs: torch.Tensor,
                caches: Caches, impl: str = "ref",
                write_mask: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Caches]:
    """One decode step over ring or paged caches. inputs: [B] int tokens
    or [B, d] float embeddings.

    Returns (logits [B, vocab], caches).  Every slot decodes at its own
    ``pos``.  On paged caches ``write_mask [B]`` freezes masked slots' pool
    writes (they go to the scratch block); ring caches and a hybrid's dense
    recurrent state take every row, as the reference's decode does (an
    idle slot's rows are overwritten whole by its next prefill).
    ``impl="cuda"`` reads the caches with the decode or paged attention
    kernel; unknown impls raise.
    """
    if write_mask is not None and not any("k_pool" in c for c in caches):
        raise ValueError("write_mask applies to paged caches only")
    x = _embed_inputs(cfg, params, inputs[:, None],
                      _first_pos(caches)[:, None])
    for spec, p, cache in zip(cfg.layer_specs(), params["layers"], caches):
        x, _ = _apply_block(cfg, spec, p, x, None, "decode", cache, impl,
                            write_mask=write_mask)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params, cfg, x)[:, 0], caches


def extend_step(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                caches: Caches, starts: torch.Tensor, lens: torch.Tensor,
                impl: str = "ref") -> Tuple[torch.Tensor, Caches]:
    """Chunked/offset prefill over paged caches: run ``tokens`` [B, S]
    (right-aligned payload, left-padded to S, true lengths ``lens`` [B]) at
    absolute positions ``starts[b] .. starts[b] + lens[b] - 1`` with every
    earlier cache key visible -- the continuation twin of
    ``forward(mode="prefill")`` for prompts whose head is already cached (an
    adopted shared prefix and/or earlier chunks).

    Returns (logits [B, S, vocab], caches).  Row ``b``'s last-token logits
    sit at ``logits[b, -1]``; a row with ``lens[b] == 0`` and ``starts[b]``
    at its position is a no-op.  Only valid for paged all-attention
    deployments with no effective sliding window
    (``kvcache.prefix_sharing_supported``); recurrent kinds raise.
    """
    s = tokens.shape[1]
    starts = starts.to(device=tokens.device, dtype=torch.int32)
    lens = lens.to(device=tokens.device, dtype=torch.int32)
    cols = torch.arange(s, dtype=torch.int32, device=tokens.device)[None]
    positions = starts[:, None] + cols - (s - lens)[:, None]      # [B, S]
    seq_valid = cols >= (s - lens)[:, None]
    x = _embed_inputs(cfg, params, tokens, positions)
    x = torch.where(seq_valid[..., None], x, 0)
    for spec, p, cache in zip(cfg.layer_specs(), params["layers"], caches):
        x, _ = _apply_block(cfg, spec, p, x, positions, "extend", cache,
                            impl, seq_valid=seq_valid)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params, cfg, x), caches


def verify_step(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                caches: Caches, lens: torch.Tensor, impl: str = "ref",
                ) -> Tuple[torch.Tensor, Caches]:
    """Speculative verify over paged caches: score ``tokens`` [B, K] -- row
    ``b``'s first ``lens[b]`` entries are the last accepted token and its
    drafts, left-aligned -- in one pass at positions ``pos[b] ..
    pos[b] + lens[b] - 1``.

    Returns (logits [B, K, vocab], caches): ``logits[b, i]`` is the next
    token's distribution after fed token ``i``.  ``lens[b] == 0`` rows are
    idle (writes to scratch, state frozen) and ``lens[b] == 1`` is a decode
    step.  The caches come back advanced by ``lens`` with every candidate
    key written; the caller rolls rejected positions back.
    """
    kq = tokens.shape[1]
    lens = lens.to(torch.int32)
    cols = torch.arange(kq, dtype=torch.int32, device=tokens.device)[None]
    seq_valid = cols < lens[:, None]                               # [B, K]
    x = _embed_inputs(cfg, params, tokens,
                      _first_pos(caches)[:, None] + cols)
    x = torch.where(seq_valid[..., None], x, 0)
    for spec, p, cache in zip(cfg.layer_specs(), params["layers"], caches):
        x, _ = _apply_block(cfg, spec, p, x, None, "verify", cache, impl,
                            seq_valid=seq_valid, verify_lens=lens)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params, cfg, x), caches
