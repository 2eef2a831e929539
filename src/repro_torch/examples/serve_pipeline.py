"""End-to-end driver: serve variable-length requests through the ``LLM``
facade on the EdgeShard stage pipeline (no-bubbles decode), with the
kernels (``impl="cuda"``).

This is the paper's deployment mode on the port's runtime:
1. ``LLM.from_plan`` plans an (uneven) stage partition with the throughput
   DP and materializes it as a running ``PipelineBackend`` (every stage's
   layers and caches on the one device, the stages stepped as a ring)
   behind one serving facade,
2. ``generate()`` streams requests of *different prompt lengths* through the
   no-bubbles tick protocol — more requests than micro-batch slots, so slots
   are recycled mid-flight, and admission buckets prompts by length (no
   caller-side padding),
3. cross-check every generated token against the TensorBackend (single
   engine) serving the identical requests,
4. demo the streaming interface on the tensor engine.

On the card the pipeline's decode ticks run the contiguous-ring attention
kernel (the paged kernel on ``cache_layout="paged"``), while the tensor
backends that check and stream keep their default ``impl="ref"``, so the
check holds the kernels against the plain attention; the reduced model is
float32.
It runs on the GPU unless ``--device cpu`` is given, and raises where
there is none:
    PYTHONPATH=src python -m repro_torch.examples.serve_pipeline \
        [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.bridge import init_params
from repro_torch.configs import get_config
from repro_torch.core.devices import tpu_pod_cluster
from repro_torch.core.profile import Workload
from repro_torch.device import resolve_device
from repro_torch.serving import LLM, SamplingParams

IMPL = "cuda"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the GPU by default; 'cpu' runs the kernels' "
                         "plain versions on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("qwen3-0.6b").reduced(n_layers=8, max_d_model=256)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    n_stages = 4

    # 1. plan (paper's throughput DP over a 4-chip homogeneous "cluster"
    #    profile) -> running pipeline backend -> serving facade, one call
    llm = LLM.from_plan(cfg, tpu_pod_cluster(n_chips=n_stages),
                        Workload(dtype_bytes=2), objective="throughput",
                        kind="pipeline", params=params, max_len=64,
                        impl=IMPL, device=dev)
    print(f"stage layout (periods per stage): "
          f"{llm.backend.spec.periods_per_stage}")

    # 2. continuous batching: 8 variable-length requests over 4 micro-batch
    #    slots (admission buckets by length; nobody pads)
    n_req, gen = 8, 8
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(3, 7, n_req)]
    sp = SamplingParams(max_tokens=gen)
    t0 = time.time()
    outs = llm.generate(prompts, sp)
    dt = time.time() - t0
    total = sum(o.n_generated for o in outs)
    print(f"pipeline: {total} tokens for prompt lengths "
          f"{[o.n_prompt for o in outs]} in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {dev.type}) — {llm.stats}")

    # 3. verify against the tensor backend serving the same requests
    ref_llm = LLM.from_backend(
        runtime.TensorBackend(cfg, params, n_slots=4, max_len=64,
                              device=dev))
    refs = ref_llm.generate(prompts, sp)
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o.tokens, r.tokens)
    print("all pipeline tokens match the tensor backend — OK")

    # 4. streaming: tokens surface the step they decode, interleaved across
    #    requests
    stream_llm = LLM.from_backend(
        runtime.TensorBackend(cfg, params, n_slots=2, max_len=64,
                              device=dev))
    events = list(stream_llm.stream(prompts[:2], SamplingParams(max_tokens=4)))
    for ev in events:
        print(f"  step {ev.step} req {ev.uid} tok[{ev.index}]={ev.token}"
              + (f" <{ev.finish_reason}>" if ev.finished else ""))
    assert sum(ev.finished for ev in events) == 2


if __name__ == "__main__":
    main()
