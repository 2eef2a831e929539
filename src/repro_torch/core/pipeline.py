"""EdgeShard pipeline runtime: the paper's layer-sharded collaborative
inference as a stage ring.

Port of ``repro.core.pipeline``.  The DP planner (``core/partition.py``)
decides which contiguous slab of layers lives on which stage; stages may be
uneven, and a stage may hold no layer at all (plans such as ``(0, 1, 31)``
are real planner outputs).  The reference runs the plan as one SPMD program
over a mesh axis.  Here :class:`StageRing` runs every stage in this process,
one after another, and :mod:`repro_torch.core.stage_procs` one process a
stage, all at the same time, over the same pieces (:func:`stage_decode`,
:func:`ring_turn`, :func:`ring_advance`, the slot operations and the
vocabulary shards); :mod:`repro_torch.core.mesh_procs` runs the scoring
forward over a ``(data, model)`` mesh of processes.  In this process:

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
  return-to-source hop,
- ``vocab_sharded`` computes the reference's vocab-sharded tick (the
  embedding rows and the head columns split over the stages) one shard
  after another.

Pipeline mode partitions at period granularity and needs
``n_layers % period == 0``; recurrentgemma-2b's 2-block tail raises, as in
the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.partition import Plan
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import DEFAULT_BLOCK_SIZE
from repro_torch.models.layers import (apply_norm, lm_logits, scale_embedding,
                                       softcap)


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
    """GPipe-style microbatched train-mode forward, every stage in this
    process. tokens [B, S] (or a frontend's float embeddings [B, S, d]) ->
    logits [B, S, V].  At step t stage s runs micro-batch ``t - s``; the
    last stage's outputs, in micro-batch order, go through the final norm
    and the LM head.  ``impl="cuda"`` runs the flash-attention kernel in
    every stage's layers (no backward: call it under ``torch.no_grad``).
    Its counterpart across processes, the reference's over a mesh (stages
    over one axis, each micro-batch's rows over others), is
    :meth:`repro_torch.core.mesh_procs.MeshProcs.pipeline_forward`."""
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
            x = T._embed_inputs(cfg, params, tokens_mb[t], positions) \
                if st == 0 else buf[st]
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
    validity.

    A stage process (:mod:`repro_torch.core.stage_procs`) holds the same
    state over its own layers' caches only, and the host a copy with no
    caches: ``buf_mb``/``buf_valid``/``tick`` are replicated on every
    process, as the reference replicates them over its stage axis."""

    caches: List[Dict[str, torch.Tensor]]
    buf: List[Optional[torch.Tensor]]     # [n_stages] x [1, 1, d]
    buf_mb: List[int]
    buf_valid: List[bool]
    logits_out: torch.Tensor              # [M, V] float32
    token_ready: np.ndarray               # [M] bool
    tick: int = 0


def init_stage_caches(cfg: ModelConfig, layers: Sequence[int],
                      n_microbatches: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      cache_layout: str = "contiguous",
                      num_blocks: int = 0,
                      block_size: int = DEFAULT_BLOCK_SIZE,
                      device=None) -> List[Dict[str, torch.Tensor]]:
    """The caches of ``layers`` (in order), over every micro-batch; on the
    paged layout their pools share one ``[M, nbs]`` block table."""
    m = n_microbatches
    if cache_layout == "paged":
        caches = T.init_paged_caches(cfg, m, max_len, num_blocks, block_size,
                                     dtype, device, layers)
        pools = [c for c in caches if "k_pool" in c]
        for cache in pools[1:]:             # one table for every pool
            cache["bt"] = pools[0]["bt"]
    elif cache_layout == "contiguous":
        caches = T.init_caches(cfg, m, max_len, dtype, device, layers)
    else:
        raise ValueError(f"cache_layout={cache_layout!r}: expected "
                         f"'contiguous' or 'paged'")
    return caches


def init_pipeline_decode_state(cfg: ModelConfig, spec: PipelineSpec,
                               n_microbatches: int, max_len: int,
                               dtype: torch.dtype = torch.bfloat16,
                               cache_layout: str = "contiguous",
                               num_blocks: int = 0,
                               block_size: int = DEFAULT_BLOCK_SIZE,
                               device=None) -> PipelineDecodeState:
    stage_layers(cfg, spec)
    caches = init_stage_caches(cfg, range(cfg.n_layers), n_microbatches,
                               max_len, dtype, cache_layout, num_blocks,
                               block_size, device)
    if cache_layout == "paged" and not any("k_pool" in c for c in caches):
        raise ValueError(f"{cfg.name} has no attention layer to page: "
                         f"use the contiguous layout")
    return ring_state(spec.n_stages, caches, torch.zeros(
        (n_microbatches, cfg.vocab_size), dtype=torch.float32,
        device=device))


def ring_state(n_stages: int, caches: List[Dict[str, torch.Tensor]],
               logits_out: torch.Tensor) -> PipelineDecodeState:
    """A ring with nothing in flight over ``caches``, recording into
    ``logits_out`` ``[M, V]``."""
    return PipelineDecodeState(
        caches=caches, buf=[None] * n_stages, buf_mb=[0] * n_stages,
        buf_valid=[False] * n_stages, logits_out=logits_out,
        token_ready=np.zeros(logits_out.shape[0], bool))


def _mb_view(cache: Dict[str, torch.Tensor],
             mb: int) -> Dict[str, torch.Tensor]:
    """Micro-batch ``mb``'s view of one layer's cache: row slices (views,
    so the in-place decode writes persist).  Paged: the layer-wide pools
    plus the micro-batch's table row and ``key_pos``/``pos`` rows (and an
    int8 cache's scale pools)."""
    if "k_pool" in cache:
        view = {k: cache[k] for k in ("k_pool", "v_pool", "k_scale_pool",
                                      "v_scale_pool") if k in cache}
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


def push_table(state: PipelineDecodeState, table: np.ndarray) -> None:
    """The host's block table ``[M, nbs]`` into the table the pools share
    (nothing on a ring without pools)."""
    pool = next((c for c in state.caches if "k_pool" in c), None)
    if pool is not None:
        pool["bt"].copy_(torch.from_numpy(table).to(pool["bt"].device))


def ring_turn(state: PipelineDecodeState, feed_valid: bool,
              ) -> Tuple[List[int], List[bool]]:
    """Each stage's micro-batch and validity this tick: stage 0 takes
    micro-batch ``tick % M`` (live when ``feed_valid``), every other stage
    what rode into its buffer."""
    m = state.logits_out.shape[0]
    return ([state.tick % m] + state.buf_mb[1:],
            [bool(feed_valid)] + state.buf_valid[1:])


def ring_advance(state: PipelineDecodeState, mbs: List[int],
                 valid: List[bool],
                 out: Optional[List[Optional[torch.Tensor]]] = None) -> None:
    """The end of a tick: buffers (``out``, where this process holds them),
    micro-batches and validity rotate one stage on."""
    if out is not None:
        state.buf = [None] + out[:-1]
    state.buf_mb = [0] + mbs[:-1]
    state.buf_valid = [False] + valid[:-1]
    state.tick += 1


def stage_decode(cfg: ModelConfig, params: Dict, layers: range,
                 caches: List[Dict[str, torch.Tensor]], x: torch.Tensor,
                 mb: int, impl: str, first: int = 0) -> torch.Tensor:
    """One stage's decode of micro-batch ``mb``: ``layers`` over the
    activation ``x`` [1, 1, d], ``caches[l - first]`` being layer l's."""
    views = {l: _mb_view(caches[l - first], mb) for l in layers}
    return _run_stage(cfg, params, layers, x, None, "decode", views, impl)


def feed_positions(state: PipelineDecodeState, mb: int,
                   feed_pos: Optional[int], device) -> torch.Tensor:
    """The fed token's position [1, 1], for sinusoidal positions: the
    host's ``feed_pos``, else read from the caches, where every layer's
    pos row agrees at a feed (a slot's turns are M >= n_stages ticks
    apart, so its last token has left the ring)."""
    if feed_pos is not None:
        return torch.full((1, 1), feed_pos, dtype=torch.int32, device=device)
    return T._first_pos(state.caches)[mb:mb + 1, None]


# --------------------------------------------------------------------------- #
# the vocabulary sharded over the stages
# --------------------------------------------------------------------------- #

def vocab_shard(cfg: ModelConfig, n_stages: int, stage: int) -> slice:
    """Stage ``stage``'s rows of the embedding and columns of the LM head
    when the vocabulary is sharded over ``n_stages`` stages."""
    if cfg.vocab_size % n_stages:
        raise ValueError(f"the vocab-sharded tick needs vocab_size % "
                         f"n_stages == 0: {cfg.vocab_size} over "
                         f"{n_stages} stages")
    vs = cfg.vocab_size // n_stages
    return slice(stage * vs, (stage + 1) * vs)


def vocab_params(cfg: ModelConfig, params: Dict, shard: slice) -> Dict:
    """A stage's vocabulary weights: ``embedding`` rows [V/n, d] and the
    matching ``head`` columns [d, V/n] (the rows transposed when the
    embedding is tied); views of ``params``' tensors."""
    emb = params["embedding"][shard]
    return {"embedding": emb,
            "head": emb.T if cfg.tie_embeddings
            else params["lm_head"][:, shard]}


def embed_partial(rows: torch.Tensor, base: int,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` that fall in the stage's shard
    ``rows`` (vocabulary ids ``base ..``), zero elsewhere: summed over the
    stages they are the embedding."""
    n = rows.shape[0]
    ids = tokens - base
    inside = (ids >= 0) & (ids < n)
    got = rows[ids.clamp(0, n - 1)]
    return torch.where(inside[..., None], got, torch.zeros_like(got))


def logits_partial(cfg: ModelConfig, h: torch.Tensor,
                   head: torch.Tensor) -> torch.Tensor:
    """The normed hidden's float32 logits over one stage's columns."""
    return softcap(h @ head, cfg.final_logit_softcap).float()


# --------------------------------------------------------------------------- #
# no-bubbles decode: tick protocol
# --------------------------------------------------------------------------- #

def pipeline_decode_tick(cfg: ModelConfig, params: Dict,
                         state: PipelineDecodeState,
                         feed_tokens: torch.Tensor, spec: PipelineSpec,
                         impl: str = "ref", feed_valid: bool = True,
                         feed_pos: Optional[int] = None,
                         vocab_sharded: bool = False) -> Optional[int]:
    """One no-bubbles decode tick, in place on ``state``.

    Stage 0 ingests ``feed_tokens [1]`` for micro-batch ``tick % M``
    (live when ``feed_valid``) at position ``feed_pos`` (default: the
    caches' pos row); every other stage advances the micro-batch
    riding in the buffer it held before the tick; the last stage's live
    output goes through the final norm and the LM head into
    ``logits_out[mb]`` (float32 ``[V]``) and ``token_ready[mb]``.
    Then the buffers rotate one stage on.  Returns the micro-batch whose
    logits completed this tick, or None.  Sampling happens on the host.

    A stage whose micro-batch is not live -- a warm-up tick, a slot with
    no request (``feed_valid=False``), a killed slot -- runs nothing, so
    its caches stay bit for bit as they were.

    ``vocab_sharded`` computes the embedding and the head as the
    reference's vocab-sharded tick does, one stage's shard after another
    (:func:`vocab_shard`; raises unless ``vocab_size % n_stages == 0``):
    the sum of the stages' masked partial rows, then the port's embed
    (gemma's scale, sinusoidal positions), and the logits of each stage's
    columns of the last stage's normed hidden, placed at their offsets.
    The process ring (:mod:`repro_torch.core.stage_procs`) runs the same
    arithmetic with the collectives between.
    """
    ns = spec.n_stages
    layers = stage_layers(cfg, spec)
    shards = [vocab_shard(cfg, ns, s) for s in range(ns)] \
        if vocab_sharded else []
    mbs, valid = ring_turn(state, feed_valid)
    out: List[Optional[torch.Tensor]] = [None] * ns
    for s in range(ns):
        if not valid[s]:
            continue
        if s == 0:
            tokens = feed_tokens[:, None]
            pos = feed_positions(state, mbs[0], feed_pos, tokens.device)
            if vocab_sharded:
                rows = sum(embed_partial(params["embedding"][sh], sh.start,
                                         tokens) for sh in shards)
                x = T.add_positions(cfg, scale_embedding(cfg, rows), pos)
            else:
                x = T._embed_inputs(cfg, params, tokens, pos)
        else:
            x = state.buf[s]
        out[s] = stage_decode(cfg, params, layers[s], state.caches, x,
                              mbs[s], impl)
    done = None
    if valid[-1]:
        h = apply_norm(params["final_norm"], out[-1], cfg.norm)
        done = mbs[-1]
        if vocab_sharded:
            for sh in shards:
                state.logits_out[done, sh] = logits_partial(
                    cfg, h, vocab_params(cfg, params, sh)["head"])[0, 0]
        else:
            state.logits_out[done] = lm_logits(params, cfg, h)[0, 0].float()
        state.token_ready[done] = True
    ring_advance(state, mbs, valid, out)
    return done


class StageRing:
    """The stage ring in this process: every stage, one after another, on
    one device.  :class:`repro_torch.core.stage_procs.StageProcs` runs the
    same ring with one process a stage behind the same methods, which is
    all :class:`~repro_torch.runtime.pipeline_backend.PipelineBackend`
    calls."""

    def __init__(self, cfg: ModelConfig, params: Dict, spec: PipelineSpec,
                 state: PipelineDecodeState, impl: str = "ref",
                 vocab_sharded: bool = False):
        self.cfg, self.params, self.spec = cfg, params, spec
        self.state, self.impl = state, impl
        self.vocab_sharded = vocab_sharded
        self._device = state.logits_out.device

    def tick(self, feed: int, valid: bool, pos: int) -> Optional[int]:
        """One tick feeding token ``feed`` at position ``pos``
        (:func:`pipeline_decode_tick`)."""
        with torch.no_grad():
            return pipeline_decode_tick(
                self.cfg, self.params, self.state,
                torch.tensor([feed], dtype=torch.int64, device=self._device),
                self.spec, impl=self.impl, feed_valid=valid, feed_pos=pos,
                vocab_sharded=self.vocab_sharded)

    def reset_slot(self, slot: int, start: int = 0) -> None:
        reset_slot(self.state, slot, start)

    def rollback_slot(self, slot: int, new_pos: int) -> None:
        rollback_slot(self.state, slot, new_pos)

    def kill_slot(self, slot: int) -> None:
        kill_slot(self.state, slot)

    def push_table(self, table: np.ndarray) -> None:
        push_table(self.state, table)

    def close(self) -> None:
        """Nothing to release: the ring lives in this process."""
