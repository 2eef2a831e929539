"""EdgeShard core of the port: profiling, partition DPs, pipeline simulator
and planner (numpy copies of ``repro.core``'s modules), and the torch stage
pipeline (``repro_torch.core.pipeline``, imported on its own)."""
from repro_torch.core.devices import (ClusterSpec, DeviceSpec, paper_testbed,
                                      tpu_pod_cluster)
from repro_torch.core.partition import (PartitionProblem, Plan, Stage,
                                        brute_force_latency,
                                        brute_force_throughput,
                                        cloud_edge_plans, edge_solo,
                                        even_partition, plan_latency,
                                        plan_stage_time, solve_latency,
                                        solve_latency_best, solve_throughput)
from repro_torch.core.planner import (Deployment, baseline_suite,
                                      build_problem, plan_deployment)
from repro_torch.core.profile import ModelProfile, UnitCost, Workload
from repro_torch.core.simulator import (SimResult, StageCosts,
                                        build_stage_costs, simulate_pipeline,
                                        simulate_sequential)

__all__ = [
    "ClusterSpec", "DeviceSpec", "paper_testbed", "tpu_pod_cluster",
    "PartitionProblem", "Plan", "Stage", "brute_force_latency",
    "brute_force_throughput", "cloud_edge_plans", "edge_solo",
    "even_partition", "plan_latency", "plan_stage_time", "solve_latency",
    "solve_latency_best",
    "solve_throughput", "Deployment", "baseline_suite", "build_problem",
    "plan_deployment", "ModelProfile", "UnitCost", "Workload", "SimResult",
    "StageCosts", "build_stage_costs", "simulate_pipeline",
    "simulate_sequential",
]
