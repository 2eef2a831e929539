"""Quickstart: plan an EdgeShard deployment, inspect it, and serve it.

Runs the paper's pipeline end-to-end on the decision layer: profile
Llama2-7B, solve the joint device-selection + partition DPs on the paper's
15-device testbed, simulate latency/throughput for every method of
Table IV — then serve requests over the planned deployment through the
``LLM`` facade (here on the simulated backend, so it runs instantly with no
model weights and touches no device; ``kind="pipeline", params=...``
serves the real thing, as :mod:`repro_torch.examples.serve_pipeline`
does).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from repro_torch.configs import PAPER_MODELS
from repro_torch.core import Workload, baseline_suite, paper_testbed
from repro_torch.core.devices import MBPS
from repro_torch.serving import LLM, SamplingParams


def main():
    cfg = PAPER_MODELS["llama2-7b"]
    cluster = paper_testbed(cloud_bw=1 * MBPS)      # 12x AGX, 2x NX, 1x RTX3090
    workload = Workload(prompt_len=32, gen_tokens=96, batch=1, dtype_bytes=4)

    print(f"model: {cfg.name} ({cfg.param_count() / 1e9:.2f}B params)")
    print(f"cluster: {len(cluster.devices)} devices, "
          f"source={cluster.devices[0].name}, cloud link 1 Mbps\n")

    suite = baseline_suite(cfg, cluster, workload, n_microbatches=8)
    print(f"{'method':24s} {'latency':>12s} {'throughput':>12s} {'devices':>8s}")
    for name, d in suite.items():
        if d.oom:
            print(f"{name:24s} {'OOM':>12s} {'OOM':>12s} {'-':>8s}")
        else:
            print(f"{name:24s} {d.latency_ms_per_token:10.2f}ms "
                  f"{d.throughput_tok_s:8.2f}t/s {len(d.plan.devices_used):8d}")

    es = suite["edgeshard"]
    print("\nEdgeShard plan (unit ranges -> device):")
    for st in es.plan.stages:
        dev = cluster.devices[st.device]
        print(f"  units {st.start:3d}..{st.end:3d} -> device {st.device:2d} "
              f"({dev.name})")

    # --- serve the planned deployment (plan -> backend -> requests in one
    #     call; variable-length prompts, no padding by the caller) ---------
    llm = LLM.from_plan(cfg, cluster, workload, objective="throughput",
                        kind="sim")
    outs = llm.generate([list(range(24)), list(range(9)), list(range(40))],
                        SamplingParams(max_tokens=workload.gen_tokens))
    print("\nserved over the planned deployment (simulated):")
    for o in outs:
        print(f"  req {o.uid}: {o.n_prompt:2d} prompt -> {o.n_generated} "
              f"tokens ({o.finish_reason})")
    sim = llm.backend.sim_result()
    print(f"  simulated throughput {sim.throughput:.1f} tok/s — {llm.stats}")


if __name__ == "__main__":
    main()
