"""Partition planner CLI — the paper's scheduling-optimization stage.

    PYTHONPATH=src python -m repro_torch.examples.partition_plan \
        --arch llama2-13b --objective throughput --cloud-bw 10

Shows how the DP's device selection and layer partition change with the
objective (Algo. 1 vs Algo. 2), bandwidth, and quantization (int8 halves
every Req_i, changing feasibility — the paper's §II motivation).  Host
only: no device is touched.
"""
import argparse

from repro_torch.configs import CONFIGS, get_config
from repro_torch.core import Workload, build_problem, paper_testbed
from repro_torch.core.devices import MBPS
from repro_torch.core.partition import solve_latency_best, solve_throughput
from repro_torch.core.planner import _evaluate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b", choices=sorted(CONFIGS))
    ap.add_argument("--objective", default="latency",
                    choices=["latency", "throughput"])
    ap.add_argument("--cloud-bw", type=float, default=1.0, help="Mbps")
    ap.add_argument("--edge-bw", type=float, default=50.0, help="Mbps")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 (halves memory requirements)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    cluster = paper_testbed(cloud_bw=args.cloud_bw * MBPS,
                            edge_bw=args.edge_bw * MBPS)
    dtype_bytes = 1 if args.int8 else 4
    workload = Workload(prompt_len=32, gen_tokens=96, batch=1,
                        dtype_bytes=dtype_bytes)
    prob = build_problem(cfg, cluster, workload)
    solver = solve_latency_best if args.objective == "latency" \
        else solve_throughput
    plan = solver(prob)
    if plan.objective == float("inf"):
        print("INFEASIBLE: model does not fit the cluster memory")
        return
    print(f"{args.arch} | objective={args.objective} | "
          f"cloud {args.cloud_bw} Mbps | "
          f"{'int8' if args.int8 else 'fp32'}")
    print(f"DP objective: {plan.objective * 1e3:.3f} ms")
    for st in plan.stages:
        dev = cluster.devices[st.device]
        n_units = st.end - st.start + 1
        print(f"  {n_units:3d} units [{st.start:3d}..{st.end:3d}] -> "
              f"dev{st.device:2d} {dev.name}")
    dep = _evaluate(cfg, cluster, workload, plan, "plan", n_microbatches=8)
    print(f"simulated: {dep.latency_ms_per_token:.2f} ms/token, "
          f"{dep.throughput_tok_s:.2f} tok/s @ batch {dep.batch}")


if __name__ == "__main__":
    main()
