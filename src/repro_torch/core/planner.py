"""End-to-end planning: config + cluster + workload -> deployment plan + metrics.

This is the "task scheduling optimization" stage of Fig. 3, wrapped so that
benchmarks, tests, and the JAX runtime all consume one object.  It also
implements the batch-size-aware throughput planning the paper lists as future
work (§VII): the throughput objective is swept over feasible micro-batch
sizes under each device's KV-cache memory budget.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Literal, Optional

import numpy as np

from repro_torch.core.devices import ClusterSpec
from repro_torch.core.partition import (INF, INFEASIBLE, PartitionProblem,
                                        Plan, cloud_edge_plans, edge_solo,
                                        even_partition, plan_latency,
                                        solve_latency, solve_latency_best,
                                        solve_throughput)
from repro_torch.core.profile import ModelProfile, Workload
from repro_torch.core.simulator import (SimResult, build_stage_costs,
                                        simulate_pipeline, simulate_sequential)
from repro_torch.models.config import ModelConfig


@dataclass
class Deployment:
    """A planned deployment plus simulated end-to-end metrics."""

    method: str
    plan: Plan
    batch: int
    latency_ms_per_token: float      # sequential latency
    throughput_tok_s: float          # pipelined throughput (nobubbles)
    oom: bool = False

    @property
    def ok(self) -> bool:
        return not self.oom


OOM = lambda method: Deployment(method, INFEASIBLE, 0, float("inf"), 0.0, oom=True)


def build_problem(cfg: ModelConfig, cluster: ClusterSpec, workload: Workload,
                  phase: str = "mixed", batch: Optional[int] = None,
                  ) -> PartitionProblem:
    profile = ModelProfile.from_config(cfg, workload)
    return PartitionProblem(
        t_comp=profile.comp_time_matrix(cluster, phase),
        act_bytes=profile.act_bytes(),
        bandwidth=cluster.bandwidth,
        req=profile.req_bytes(batch=batch),
        mem=np.array([d.memory_bytes for d in cluster.devices]),
        source=cluster.source,
    )


def _evaluate(cfg: ModelConfig, cluster: ClusterSpec, workload: Workload,
              plan: Plan, method: str, n_microbatches: int = 4,
              schedule: str = "nobubbles") -> Deployment:
    if plan.objective == INF or len(plan.assignment) == 0:
        return OOM(method)
    profile = ModelProfile.from_config(cfg, workload)
    seq_costs = build_stage_costs(profile, cluster, plan, mb_batch=1)
    seq = simulate_sequential(seq_costs, workload.gen_tokens)
    # throughput: largest feasible micro-batch for this assignment
    mem = np.array([d.memory_bytes for d in cluster.devices])
    max_b = profile.max_batch_for(mem, plan.assignment, cluster)
    if max_b == 0:
        return OOM(method)
    pipe_costs = build_stage_costs(profile, cluster, plan, mb_batch=max_b)
    pipe = simulate_pipeline(pipe_costs, workload.gen_tokens, n_microbatches,
                             max_b, schedule=schedule)
    return Deployment(method, plan, max_b,
                      1e3 * seq.latency_per_token, pipe.throughput)


def plan_deployment(cfg: ModelConfig, cluster: ClusterSpec,
                    workload: Workload,
                    objective: Literal["latency", "throughput"] = "latency",
                    ) -> Deployment:
    """EdgeShard: joint device selection + partition for the given objective."""
    prob = build_problem(cfg, cluster, workload)
    if objective == "latency":
        plan = solve_latency_best(prob)
    else:
        plan = solve_throughput(prob)
    return _evaluate(cfg, cluster, workload, plan, f"edgeshard-{objective}")


def baseline_suite(cfg: ModelConfig, cluster: ClusterSpec, workload: Workload,
                   cloud: Optional[int] = None,
                   n_microbatches: int = 4,
                   schedule: str = "nobubbles") -> Dict[str, Deployment]:
    """The paper's Table-IV comparison set."""
    if cloud is None:
        cloud = int(np.argmax([d.flops for d in cluster.devices]))
    prob = build_problem(cfg, cluster, workload)
    out: Dict[str, Deployment] = {}
    out["edge-solo"] = _evaluate(cfg, cluster, workload, edge_solo(prob),
                                 "edge-solo", n_microbatches, schedule)
    ce = cloud_edge_plans(prob, cloud)
    out["cloud-edge-even"] = _evaluate(cfg, cluster, workload,
                                       ce["cloud-edge-even"], "cloud-edge-even",
                                       n_microbatches, schedule)
    out["cloud-edge-opt"] = _evaluate(cfg, cluster, workload,
                                      ce["cloud-edge-opt"], "cloud-edge-opt",
                                      n_microbatches, schedule)
    out["edgeshard"] = _evaluate(cfg, cluster, workload, solve_latency_best(prob),
                                 "edgeshard", n_microbatches, schedule)
    thru_plan = solve_throughput(prob)
    out["edgeshard-throughput"] = _evaluate(cfg, cluster, workload, thru_plan,
                                            "edgeshard-throughput",
                                            n_microbatches, schedule)
    # EdgeShard-Even (used by the paper for the 70B comparison)
    lat_plan = out["edgeshard"].plan
    if lat_plan is not INFEASIBLE and len(lat_plan.assignment):
        devs = lat_plan.devices_used
        out["edgeshard-even"] = _evaluate(cfg, cluster, workload,
                                          even_partition(prob, devs),
                                          "edgeshard-even",
                                          n_microbatches, schedule)
    return out
