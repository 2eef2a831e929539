"""Discrete-event simulator of collaborative LLM inference (paper §III/§IV-B).

Simulates the three execution modes of the paper:

- ``sequential``  — one user, devices take turns (Fig. 4a)        -> latency
- ``bubbles``     — pipeline with an iteration barrier (Fig. 5a)  -> throughput
- ``nobubbles``   — EdgeShard-No-bubbles: a micro-batch starts its next token
  as soon as its previous token returns to the first stage (Fig. 5b)

Devices and inter-stage links are modelled as serially-reusable resources;
durations come from the analytic (or measured) :class:`ModelProfile`.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import List, Literal, Optional

import numpy as np

from repro_torch.core.devices import ClusterSpec
from repro_torch.core.partition import Plan, Stage
from repro_torch.core.profile import ModelProfile, Workload


@dataclass
class StageCosts:
    """Flattened per-stage durations for one (plan, workload) pair."""

    prefill: np.ndarray        # [S] seconds to prefill one micro-batch
    decode: np.ndarray         # [S] seconds to decode one token (micro-batch)
    comm_prefill: np.ndarray   # [S-1] activation transfer after stage s, prefill
    comm_decode: np.ndarray    # [S-1] same for one decode step
    return_comm: float         # last stage -> source hand-back of sampled ids

    @property
    def n_stages(self) -> int:
        return len(self.prefill)


def build_stage_costs(profile: ModelProfile, cluster: ClusterSpec,
                      plan: Plan, mb_batch: int) -> StageCosts:
    stages = plan.stages
    w = profile.workload
    pre, dec = [], []
    for st in stages:
        dev = cluster.devices[st.device]
        tp = td = 0.0
        for i in range(st.start, st.end + 1):
            u = profile.units[i]
            tp += profile.comp_time(u, dev, "prefill") * w.prompt_len * mb_batch
            td += profile.comp_time(u, dev, "decode") * mb_batch
        pre.append(tp)
        dec.append(td)
    cp, cd = [], []
    for a, b in zip(stages[:-1], stages[1:]):
        bw = cluster.bandwidth[a.device, b.device]
        per_tok = profile.units[a.end].act_bytes_per_token
        cp.append(per_tok * w.prompt_len * mb_batch / bw)
        cd.append(per_tok * mb_batch / bw)
    last = stages[-1]
    ret_bw = cluster.bandwidth[last.device, cluster.source]
    ret = 0.0 if last.device == cluster.source else 4.0 * mb_batch / ret_bw
    return StageCosts(np.array(pre), np.array(dec),
                      np.array(cp), np.array(cd), ret)


@dataclass
class SimResult:
    makespan: float
    tokens_generated: int
    latency_per_token: float       # seconds / token (sequential semantics)
    throughput: float              # tokens / second

    def __repr__(self):
        return (f"SimResult(makespan={self.makespan:.4f}s, "
                f"tokens={self.tokens_generated}, "
                f"latency={1e3 * self.latency_per_token:.2f}ms/tok, "
                f"throughput={self.throughput:.2f}tok/s)")


def simulate_sequential(costs: StageCosts, gen_tokens: int) -> SimResult:
    """Single-request latency: every token flows through all stages serially."""
    per_prefill = float(costs.prefill.sum() + costs.comm_prefill.sum())
    per_decode = float(costs.decode.sum() + costs.comm_decode.sum()
                       + costs.return_comm)
    makespan = per_prefill + per_decode * gen_tokens
    tokens = gen_tokens + 1          # prefill emits the first token
    return SimResult(makespan, tokens, makespan / tokens,
                     tokens / makespan)


def simulate_pipeline(costs: StageCosts, gen_tokens: int, n_microbatches: int,
                      mb_batch: int,
                      schedule: Literal["bubbles", "nobubbles"] = "nobubbles",
                      ) -> SimResult:
    """Event-driven pipeline simulation.

    Tasks are (microbatch b, token t, stage s); t=0 is the prefill pass.
    ``bubbles``: token t+1 of any micro-batch may only start after *all*
    micro-batches finished token t (iteration barrier, Fig. 5a).
    ``nobubbles``: a micro-batch re-enters stage 0 as soon as its sampled
    token returns (Fig. 5b).
    """
    S = costs.n_stages
    dev_free = [0.0] * S
    n_tokens = gen_tokens + 1
    done_at = np.zeros((n_microbatches, n_tokens))
    # (ready_time, seq, b, t, s); seq breaks ties FIFO
    heap: List = []
    seq = 0
    for b in range(n_microbatches):
        heapq.heappush(heap, (0.0, seq, b, 0, 0)); seq += 1
    round_done = [0] * n_tokens       # completed micro-batches per token round
    pending_barrier: List = []        # tasks waiting for the iteration barrier
    barrier_time = np.zeros(n_tokens)

    def dur(t: int, s: int) -> float:
        return float(costs.prefill[s] if t == 0 else costs.decode[s])

    def comm(t: int, s: int) -> float:
        if s >= S - 1:
            return 0.0
        return float(costs.comm_prefill[s] if t == 0 else costs.comm_decode[s])

    makespan = 0.0
    while heap:
        ready, _, b, t, s = heapq.heappop(heap)
        start = max(ready, dev_free[s])
        finish = start + dur(t, s)
        dev_free[s] = finish
        makespan = max(makespan, finish)
        if s < S - 1:
            heapq.heappush(heap, (finish + comm(t, s), seq, b, t, s + 1)); seq += 1
            continue
        # token t of micro-batch b fully generated
        token_done = finish + costs.return_comm
        done_at[b, t] = token_done
        makespan = max(makespan, token_done)
        round_done[t] += 1
        if round_done[t] == n_microbatches:
            barrier_time[t] = max(done_at[:, t].max(), token_done)
            # release any tasks parked on this barrier
            for (bb, tt) in [p for p in pending_barrier if p[1] == t + 1]:
                pending_barrier.remove((bb, tt))
                heapq.heappush(heap, (max(barrier_time[t], done_at[bb, tt - 1]),
                                      seq, bb, tt, 0)); seq += 1
        if t + 1 < n_tokens:
            if schedule == "nobubbles":
                heapq.heappush(heap, (token_done, seq, b, t + 1, 0)); seq += 1
            else:
                if round_done[t] == n_microbatches:
                    heapq.heappush(heap, (barrier_time[t], seq, b, t + 1, 0)); seq += 1
                else:
                    pending_barrier.append((b, t + 1))
    tokens = n_tokens * n_microbatches * mb_batch
    return SimResult(makespan, tokens, makespan / tokens, tokens / makespan)
