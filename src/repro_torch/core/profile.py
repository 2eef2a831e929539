"""Offline profiling stage (paper §III, Fig. 3 stage 1).

The paper measures per-layer execution traces on every device.  On this
container the profile is *analytic*: per-layer FLOPs / bytes derived from the
:class:`ModelConfig`, combined with a device roofline
``t = max(flops / eff_flops, bytes / mem_bw)``.  The output interface —
per-layer compute times per device, activation sizes, memory requirements —
is exactly what the paper's measured traces provide, so measured traces can
be dropped in via :func:`ModelProfile.from_traces`.

Partitionable units are ``[embed, block_0 .. block_{L-1}, head]`` — the
embedding is pinned to the source node by the privacy constraint (Eq. 4) and
the head unit pays the return-to-source hop (Eq. 6, case i=N-1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.devices import ClusterSpec, DeviceSpec
from repro_torch.models.config import BlockSpec, ModelConfig

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


@dataclass(frozen=True)
class Workload:
    """The serving workload the paper profiles (32-token prompts, 96 generated)."""

    prompt_len: int = 32
    gen_tokens: int = 96
    batch: int = 1
    dtype_bytes: int = 4           # the paper uses full-precision inference

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.gen_tokens

    @property
    def mean_decode_context(self) -> float:
        return self.prompt_len + self.gen_tokens / 2.0


@dataclass(frozen=True)
class UnitCost:
    """Per-layer (partitionable unit) cost terms."""

    name: str
    flops_prefill_per_token: float   # avg FLOPs per prompt token
    flops_decode_per_token: float    # FLOPs per generated token (per sequence)
    weight_bytes: float
    act_bytes_per_token: float       # activation handed to the next unit
    kv_bytes_per_token: float        # KV/recurrent state appended per token
    state_bytes: float = 0.0         # fixed-size recurrent state (per sequence)


def _attn_flops(cfg: ModelConfig, spec: BlockSpec, context: float) -> float:
    """Attention FLOPs for one token attending to ``context`` keys."""
    d, q, kv, h, hd = (cfg.d_model, cfg.q_dim, cfg.kv_dim,
                       cfg.n_heads, cfg.resolved_head_dim)
    ctx = min(context, spec.window) if spec.window else context
    proj = 2 * d * (q + 2 * kv) + 2 * q * d
    attn = 4 * h * hd * ctx
    return proj + attn


def _ffn_flops(cfg: ModelConfig, spec: BlockSpec) -> float:
    d = cfg.d_model
    if spec.moe is not None:
        m = spec.moe
        router = 2 * d * m.num_experts
        experts = (m.top_k + m.num_shared_experts) * 3 * 2 * d * m.d_expert
        return router + experts
    if spec.mlp == "swiglu":
        return 3 * 2 * d * cfg.d_ff
    if spec.mlp == "gelu":
        return 2 * 2 * d * cfg.d_ff
    return 0.0


def _recurrent_flops(cfg: ModelConfig, spec: BlockSpec) -> float:
    d = cfg.d_model
    if spec.kind == "rglru":
        r = cfg.rnn_dim
        return 2 * d * (2 * r) + 2 * r * d + 2 * cfg.conv_width * r + 10 * r
    if spec.kind == "mlstm":
        dp = int(d * cfg.mlstm_proj_factor)
        proj = 2 * d * (2 * dp) + 3 * 2 * dp * dp + 2 * dp * d
        recur = 6 * dp * dp / cfg.n_heads
        return proj + recur
    if spec.kind == "slstm":
        dp = int(d * cfg.slstm_proj_factor)
        return 8 * 2 * d * d + 2 * (d * dp + dp * d)
    raise ValueError(spec.kind)


def block_unit_cost(cfg: ModelConfig, spec: BlockSpec, idx: int,
                    workload: Workload) -> UnitCost:
    dt = workload.dtype_bytes
    d = cfg.d_model
    # mixer
    if spec.kind == "attn":
        f_pre = _attn_flops(cfg, spec, workload.prompt_len / 2.0)
        f_dec = _attn_flops(cfg, spec, workload.mean_decode_context)
        kv_per_tok = 2 * cfg.kv_dim * dt
        state = 0.0
    else:
        f_pre = f_dec = _recurrent_flops(cfg, spec)
        kv_per_tok = 0.0
        if spec.kind == "rglru":
            state = (cfg.rnn_dim + cfg.conv_width * cfg.rnn_dim) * dt
        elif spec.kind == "mlstm":
            dp = int(d * cfg.mlstm_proj_factor)
            state = (dp * dp / cfg.n_heads + 2 * dp) * dt
        else:
            state = 4 * d * dt
    # ffn
    f_ffn = _ffn_flops(cfg, spec)
    weight = cfg.block_param_count(spec) * dt
    return UnitCost(
        name=f"block{idx}:{spec.kind}" + ("+moe" if spec.moe else ""),
        flops_prefill_per_token=f_pre + f_ffn,
        flops_decode_per_token=f_dec + f_ffn,
        weight_bytes=weight,
        act_bytes_per_token=d * dt,
        kv_bytes_per_token=kv_per_tok,
        state_bytes=state,
    )


@dataclass
class ModelProfile:
    """All per-unit costs for one model under one workload."""

    config: ModelConfig
    workload: Workload
    units: List[UnitCost]

    # ------------------------------------------------------------------ #
    @classmethod
    def from_config(cls, cfg: ModelConfig, workload: Workload) -> "ModelProfile":
        dt = workload.dtype_bytes
        d = cfg.d_model
        units: List[UnitCost] = []
        units.append(UnitCost(
            name="embed",
            flops_prefill_per_token=0.0, flops_decode_per_token=0.0,
            weight_bytes=cfg.vocab_size * d * dt,
            act_bytes_per_token=d * dt, kv_bytes_per_token=0.0))
        for i, spec in enumerate(cfg.layer_specs()):
            units.append(block_unit_cost(cfg, spec, i, workload))
        head_w = (0 if cfg.tie_embeddings else cfg.vocab_size * d) + d
        units.append(UnitCost(
            name="head",
            flops_prefill_per_token=2 * d * cfg.vocab_size,
            flops_decode_per_token=2 * d * cfg.vocab_size,
            weight_bytes=head_w * dt,
            # only sampled token ids return to the source (4B each)
            act_bytes_per_token=4.0, kv_bytes_per_token=0.0))
        return cls(cfg, workload, units)

    @classmethod
    def from_traces(cls, cfg: ModelConfig, workload: Workload,
                    units: Sequence[UnitCost]) -> "ModelProfile":
        """Plug in measured traces (the paper's actual profiling output)."""
        return cls(cfg, workload, list(units))

    # ------------------------------------------------------------------ #
    @property
    def n_units(self) -> int:
        return len(self.units)

    def comp_time(self, u: UnitCost, dev: DeviceSpec, phase: str = "mixed") -> float:
        """Per-token execution time of a unit on a device (roofline model).

        ``mixed`` averages prefill and decode per-token times, matching the
        paper's profiling methodology ("take the average").
        """
        b = self.workload.batch
        w = self.workload

        def t(flops: float, ctx_bytes: float, tokens_in_flight: int) -> float:
            comp = flops * tokens_in_flight / dev.effective_flops
            # decode is weight-bandwidth bound: weights stream once per step
            mem = (u.weight_bytes + ctx_bytes * tokens_in_flight) / dev.mem_bw
            return max(comp, mem) / tokens_in_flight

        kv_read_dec = u.kv_bytes_per_token * w.mean_decode_context + u.state_bytes
        t_pre = t(u.flops_prefill_per_token, u.kv_bytes_per_token * w.prompt_len / 2,
                  w.prompt_len * b)
        t_dec = t(u.flops_decode_per_token, kv_read_dec, b)
        if phase == "prefill":
            return t_pre
        if phase == "decode":
            return t_dec
        return 0.5 * (t_pre + t_dec)

    def comp_time_matrix(self, cluster: ClusterSpec, phase: str = "mixed") -> np.ndarray:
        """t_comp[i, j]: per-token time of unit i on device j (paper notation)."""
        out = np.empty((self.n_units, cluster.n))
        for i, u in enumerate(self.units):
            for j, dev in enumerate(cluster.devices):
                out[i, j] = self.comp_time(u, dev, phase)
        return out

    def act_bytes(self) -> np.ndarray:
        """Per-step activation bytes sent from unit i to unit i+1 (batch-wide)."""
        return np.array([u.act_bytes_per_token * self.workload.batch
                         for u in self.units])

    def req_bytes(self, batch: Optional[int] = None) -> np.ndarray:
        """Req_i: memory to host unit i (weights + KV cache + workspace)."""
        b = batch if batch is not None else self.workload.batch
        total = self.workload.total_len
        out = np.empty(self.n_units)
        for i, u in enumerate(self.units):
            kv = u.kv_bytes_per_token * total * b + u.state_bytes * b
            workspace = 2 * u.act_bytes_per_token * b
            out[i] = u.weight_bytes + kv + workspace
        return out

    def total_weight_bytes(self) -> float:
        return float(sum(u.weight_bytes for u in self.units))

    def max_batch_for(self, mem_per_unit: np.ndarray, assignment: np.ndarray,
                      cluster: ClusterSpec, cap: int = 64) -> int:
        """Largest batch whose KV fits every participating device (paper §VII:
        batch-size-aware planning, implemented here as a feasibility sweep)."""
        best = 0
        for b in range(1, cap + 1):
            req = self.req_bytes(batch=b)
            used = np.zeros(cluster.n)
            for i, j in enumerate(assignment):
                used[j] += req[i]
            if all(used[j] <= cluster.mem(j) for j in range(cluster.n)):
                best = b
            else:
                break
        return best
