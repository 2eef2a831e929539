"""EdgeShard pipeline runtime on one device: the paper's layer-sharded
collaborative inference as a stage ring over one card.

Port of ``repro.core.pipeline``.  The DP planner (``core/partition.py``)
decides which contiguous slab of layers lives on which stage; stages may be
uneven, and a stage may hold no layer at all (plans such as ``(0, 1, 31)``
are real planner outputs).  The reference runs the plan as one SPMD program
over a mesh axis; here every stage runs on the same device, in lockstep:

- a stage is a range of ``params["layers"]`` (:func:`stage_layers`).  It
  holds references to the model's own layer tensors: nothing is restacked
  (the reference pads every stage to ``l_max`` periods for ``shard_map``,
  which at llama2-7b would be a second copy of the weights),
- the activation hand-off is a rotation of the stages' input buffers at the
  end of a tick, after every stage ran on the buffer it held before the
  tick -- the reference's ``ppermute`` after the layer scan,
- **EdgeShard-No-bubbles** decode is :func:`pipeline_decode_tick`: each
  tick, stage 0 ingests micro-batch ``tick % M`` and every other stage
  advances the micro-batch riding in its buffer, so a micro-batch fed at
  tick t returns its logits at the end of tick ``t + n_stages - 1``.
  Validity rides the ring on the host; a stage whose micro-batch is not
  live skips its work outright (the reference computes it and discards it
  with a select), so dead ticks read and write no cache,
- the final norm and the LM head run once a tick, on the last stage's
  output (the reference computes them on every stage and keeps the last
  stage's); the float32 logits are recorded for stage 0, the paper's
  return-to-source hop.

Pipeline mode partitions at period granularity and needs
``n_layers % period == 0``; recurrentgemma-2b's 2-block tail raises, as in
the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.partition import Plan
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import DEFAULT_BLOCK_SIZE
from repro_torch.models.layers import apply_norm, embed_tokens, lm_logits


@dataclass(frozen=True)
class PipelineSpec:
    """Stage layout: ``periods_per_stage[s]`` periods on stage s (uneven OK)."""

    n_stages: int
    periods_per_stage: Tuple[int, ...]

    def __post_init__(self):
        assert len(self.periods_per_stage) == self.n_stages
        assert all(p >= 0 for p in self.periods_per_stage)

    @property
    def n_periods(self) -> int:
        return sum(self.periods_per_stage)

    @property
    def l_max(self) -> int:
        return max(self.periods_per_stage)

    @property
    def starts(self) -> Tuple[int, ...]:
        out, acc = [], 0
        for p in self.periods_per_stage:
            out.append(acc)
            acc += p
        return tuple(out)


def even_pipeline_spec(cfg: ModelConfig, n_stages: int) -> PipelineSpec:
    n = cfg.n_full_periods
    base, extra = divmod(n, n_stages)
    return PipelineSpec(n_stages, tuple(base + (1 if s < extra else 0)
                                        for s in range(n_stages)))


def spec_from_plan(cfg: ModelConfig, plan: Plan, n_stages: int) -> PipelineSpec:
    """Map a DP plan over units (embed + blocks + head) to period counts."""
    assert cfg.n_layers % cfg.period == 0, "pipeline needs whole periods"
    blocks_per_stage: List[int] = []
    for st in plan.stages:
        lo = max(st.start, 1)            # drop the embed unit
        hi = min(st.end, cfg.n_layers)   # drop the head unit
        blocks_per_stage.append(max(0, hi - lo + 1))
    while len(blocks_per_stage) > n_stages:
        # merge the smallest stage into its right neighbour (or left, if
        # last); pop FIRST so the target index is computed on the shrunk
        # list — the augmented-assign form loses blocks when j > i.
        i = int(np.argmin(blocks_per_stage))
        v = blocks_per_stage.pop(i)
        j = min(i, len(blocks_per_stage) - 1)
        blocks_per_stage[j] += v
    while len(blocks_per_stage) < n_stages:
        i = int(np.argmax(blocks_per_stage))
        half = blocks_per_stage[i] // 2
        blocks_per_stage[i] -= half
        blocks_per_stage.insert(i + 1, half)
    total_p = cfg.n_full_periods
    raw = np.array(blocks_per_stage, float) / cfg.period
    base = np.floor(raw).astype(int)
    rem = total_p - int(base.sum())
    order = np.argsort(-(raw - base))
    for idx in order[:rem]:
        base[idx] += 1
    assert base.sum() == total_p
    return PipelineSpec(n_stages, tuple(int(x) for x in base))


# --------------------------------------------------------------------------- #
# stage layout
# --------------------------------------------------------------------------- #

def stage_layers(cfg: ModelConfig, spec: PipelineSpec) -> Tuple[range, ...]:
    """Stage s's layers: a contiguous range of indices into
    ``params["layers"]``, ``cfg.layer_specs()`` and the per-layer caches
    (empty for a stage without layers).  Raises for a model whose layers
    are not whole periods, or a spec that does not cover them."""
    if cfg.n_layers % cfg.period:
        raise ValueError(
            f"{cfg.name}: pipeline mode requires n_layers % period == 0 "
            f"({cfg.n_layers} layers, period {cfg.period})")
    if spec.n_periods != cfg.n_full_periods:
        raise ValueError(f"spec covers {spec.n_periods} periods, "
                         f"{cfg.name} has {cfg.n_full_periods}")
    p = cfg.period
    return tuple(range(start * p, (start + n) * p)
                 for start, n in zip(spec.starts, spec.periods_per_stage))


def _run_stage(cfg: ModelConfig, params: Dict, layers: range,
               x: torch.Tensor, positions: Optional[torch.Tensor], mode: str,
               caches: Optional[List[Dict]], impl: str) -> torch.Tensor:
    specs = cfg.layer_specs()
    for l in layers:
        x, _ = T._apply_block(cfg, specs[l], params["layers"][l], x,
                              positions, mode,
                              None if caches is None else caches[l], impl)
    return x


# --------------------------------------------------------------------------- #
# microbatched forward (scoring)
# --------------------------------------------------------------------------- #

def pipeline_forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                     spec: PipelineSpec, n_microbatches: int,
                     impl: str = "ref") -> torch.Tensor:
    """GPipe-style microbatched train-mode forward. tokens [B, S] -> logits
    [B, S, V].  At step t stage s runs micro-batch ``t - s``; the last
    stage's outputs, in micro-batch order, go through the final norm and
    the LM head.  ``impl="cuda"`` runs the flash-attention kernel in every
    stage's layers (no backward: call it under ``torch.no_grad``)."""
    b, s = tokens.shape[:2]
    m = n_microbatches
    if b % m:
        raise ValueError(f"batch {b} is no multiple of {m} micro-batches")
    layers = stage_layers(cfg, spec)
    ns = spec.n_stages
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    tokens_mb = tokens.reshape(m, b // m, *tokens.shape[1:])
    buf: List[Optional[torch.Tensor]] = [None] * ns
    acc: List[Optional[torch.Tensor]] = [None] * m
    for t in range(m + ns - 1):
        out: List[Optional[torch.Tensor]] = [None] * ns
        for st in range(ns):
            if not 0 <= t - st < m:
                continue                    # warm-up or drain: stage idles
            x = embed_tokens(params, cfg, tokens_mb[t]) if st == 0 \
                else buf[st]
            out[st] = _run_stage(cfg, params, layers[st], x, positions,
                                 "train", None, impl)
        if t >= ns - 1:
            acc[t - (ns - 1)] = out[-1]
        buf = [None] + out[:-1]
    x = torch.cat(acc).reshape(b, s, cfg.d_model)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params, cfg, x)


# --------------------------------------------------------------------------- #
# no-bubbles decode: tick protocol
# --------------------------------------------------------------------------- #

@dataclass
class PipelineDecodeState:
    """The ring's state.  ``caches`` are per layer, over every micro-batch:
    ring caches with one row per micro-batch, or paged caches whose pools
    are shared and whose ``bt``/``key_pos``/``pos`` have one row per
    micro-batch (one block table, shared by every attention layer); a
    recurrent layer's state (RG-LRU, mLSTM, sLSTM) has one row per
    micro-batch on both layouts.  A micro-batch is
    one request stream (one lane: several lanes a slot arrive with the
    batcher that fills them).  The ring itself rides on the
    host: ``buf[s]`` is the activation entering stage s (``None`` where no
    live micro-batch rides), ``buf_mb``/``buf_valid`` its micro-batch and
    validity."""

    caches: List[Dict[str, torch.Tensor]]
    buf: List[Optional[torch.Tensor]]     # [n_stages] x [1, 1, d]
    buf_mb: List[int]
    buf_valid: List[bool]
    logits_out: torch.Tensor              # [M, V] float32
    token_ready: np.ndarray               # [M] bool
    tick: int = 0


def init_pipeline_decode_state(cfg: ModelConfig, spec: PipelineSpec,
                               n_microbatches: int, max_len: int,
                               dtype: torch.dtype = torch.bfloat16,
                               cache_layout: str = "contiguous",
                               num_blocks: int = 0,
                               block_size: int = DEFAULT_BLOCK_SIZE,
                               device=None) -> PipelineDecodeState:
    stage_layers(cfg, spec)
    m = n_microbatches
    if cache_layout == "paged":
        caches = T.init_paged_caches(cfg, m, max_len, num_blocks, block_size,
                                     dtype, device)
        pools = [c for c in caches if "k_pool" in c]
        if not pools:
            raise ValueError(f"{cfg.name} has no attention layer to page: "
                             f"use the contiguous layout")
        for cache in pools[1:]:             # one table for every pool
            cache["bt"] = pools[0]["bt"]
    elif cache_layout == "contiguous":
        caches = T.init_caches(cfg, m, max_len, dtype, device)
    else:
        raise ValueError(f"cache_layout={cache_layout!r}: expected "
                         f"'contiguous' or 'paged'")
    ns = spec.n_stages
    return PipelineDecodeState(
        caches=caches, buf=[None] * ns, buf_mb=[0] * ns,
        buf_valid=[False] * ns,
        logits_out=torch.zeros((m, cfg.vocab_size),
                               dtype=torch.float32, device=device),
        token_ready=np.zeros(m, bool))


def _mb_view(cache: Dict[str, torch.Tensor],
             mb: int) -> Dict[str, torch.Tensor]:
    """Micro-batch ``mb``'s view of one layer's cache: row slices (views,
    so the in-place decode writes persist).  Paged: the layer-wide pools
    plus the micro-batch's table row and ``key_pos``/``pos`` rows."""
    if "k_pool" in cache:
        view = {k: cache[k] for k in ("k_pool", "v_pool")}
        view.update({k: cache[k][mb:mb + 1] for k in ("bt", "key_pos", "pos")})
        return view
    return {k: t[mb:mb + 1] for k, t in cache.items()}


def reset_slot(state: PipelineDecodeState, slot: int, start: int = 0) -> None:
    """Fresh caches for micro-batch ``slot``, in place: ring rows and
    recurrent state rows as ``init_caches`` makes them; on the paged layout
    the slot's ring view only (the host returns its blocks), the pools
    untouched.

    ``start > 0`` is a streamed admission over an adopted shared prefix
    (paged only): ring slot equals absolute position under the prefix gate
    (no window), so the rows below ``start`` are marked live with their
    own positions and decoding resumes at ``start``."""
    for cache in state.caches:
        if "k_pool" in cache:
            kp = cache["key_pos"][slot]
            row = torch.arange(kp.shape[0], dtype=kp.dtype, device=kp.device)
            kp.copy_(torch.where(row < start, row, -1))
            cache["pos"][slot] = start
        else:
            if start:
                raise ValueError("reset_slot: an adopted start needs the "
                                 "paged layout")
            for key, t in cache.items():
                t[slot] = -1 if key == "key_pos" else 0
    state.logits_out[slot] = 0.
    state.token_ready[slot] = False


def rollback_slot(state: PipelineDecodeState, slot: int, new_pos: int) -> None:
    """Speculative rejection, in place: drop micro-batch ``slot``'s keys at
    positions ``>= new_pos`` from every paged layer (``key_pos`` rows to -1)
    and resume its decode at ``new_pos``.  Ring slot equals absolute
    position under the spec gate, so the ``key_pos`` values are the
    positions.  No pool tensor and no other slot is touched; the rejected
    keys stay in their blocks, masked, until decode overwrites them."""
    for cache in state.caches:
        if "k_pool" in cache:
            kp = cache["key_pos"][slot]
            kp.masked_fill_(kp >= new_pos, -1)
            cache["pos"][slot] = new_pos


def kill_slot(state: PipelineDecodeState, slot: int) -> None:
    """Invalidate every in-flight activation of micro-batch ``slot``, so a
    preempted slot's remaining stage passes write nothing."""
    state.buf_valid = [v and mb != slot
                       for v, mb in zip(state.buf_valid, state.buf_mb)]


def pipeline_decode_tick(cfg: ModelConfig, params: Dict,
                         state: PipelineDecodeState,
                         feed_tokens: torch.Tensor, spec: PipelineSpec,
                         impl: str = "ref", feed_valid: bool = True,
                         ) -> Optional[int]:
    """One no-bubbles decode tick, in place on ``state``.

    Stage 0 ingests ``feed_tokens [1]`` for micro-batch ``tick % M``
    (live when ``feed_valid``); every other stage advances the micro-batch
    riding in the buffer it held before the tick; the last stage's live
    output goes through the final norm and the LM head into
    ``logits_out[mb]`` (float32 ``[V]``) and ``token_ready[mb]``.
    Then the buffers rotate one stage on.  Returns the micro-batch whose
    logits completed this tick, or None.  Sampling happens on the host.

    A stage whose micro-batch is not live -- a warm-up tick, a slot with
    no request (``feed_valid=False``), a killed slot -- runs nothing, so
    its caches stay bit for bit as they were.
    """
    ns = spec.n_stages
    m = state.logits_out.shape[0]
    layers = stage_layers(cfg, spec)
    mbs = [state.tick % m] + state.buf_mb[1:]
    valid = [bool(feed_valid)] + state.buf_valid[1:]
    out: List[Optional[torch.Tensor]] = [None] * ns
    for s in range(ns):
        if not valid[s]:
            continue
        x = embed_tokens(params, cfg, feed_tokens[:, None]) if s == 0 \
            else state.buf[s]
        views = {l: _mb_view(state.caches[l], mbs[s])
                 for l in layers[s]}
        out[s] = _run_stage(cfg, params, layers[s], x, None, "decode",
                            views, impl)
    done = None
    if valid[-1]:
        h = apply_norm(params["final_norm"], out[-1], cfg.norm)
        done = mbs[-1]
        state.logits_out[done] = lm_logits(params, cfg, h)[0, 0].float()
        state.token_ready[done] = True
    state.buf = [None] + out[:-1]
    state.buf_mb = [0] + mbs[:-1]
    state.buf_valid = [False] + valid[:-1]
    state.tick += 1
    return done
