"""Serving launcher of the port: request-lifecycle generation through the
``LLM`` facade, on the contiguous (default) or the paged KV layout.  Weights
are random, made from ``--seed``.  Two modes:

- ``--mode tp`` (default) -- :class:`~repro_torch.runtime.TensorBackend`,
  optionally with speculative decoding, the prefix cache and chunked
  prefill on the paged layout; with ``--devices N`` tensor-parallel on a
  ``(1, N)`` mesh of processes (``TensorBackend(..., mesh=...)``: each
  process its 1/N of the heads, ``ff``, RG-LRU channels and vocabulary
  and of the K/V cache and recurrent state, every process on the one
  device, the Megatron sums over gloo),
  the reference's ``--mode tp --devices N``,
- ``--mode pipeline`` -- the paper's deployment mode: ``LLM.from_plan``
  runs the throughput DP over ``tpu_pod_cluster(n_chips=--stages)`` and
  serves the (possibly uneven) stage plan as a no-bubbles pipeline on one
  device; with ``--stage-procs`` each planned stage runs in its own
  process, all at the same time, activations handed on over
  ``torch.distributed`` (gloo), the counterpart of the reference's one
  device a stage.  Greedy tokens equal ``--mode tp``'s for the same seed
  and arch in float32 (the ``--smoke`` variants).

    python -m repro_torch.launch.serve --arch llama2-7b --impl cuda \
        --batch 6 --slots 4 --prompt-len 256 --varlen --gen 32 --max-len 4096
    python -m repro_torch.launch.serve --arch llama2-7b --cache-layout paged \
        --impl cuda --batch 6 --slots 4 --prompt-len 256 --varlen --gen 32 \
        --max-len 512 --spec-k 4
    python -m repro_torch.launch.serve --arch recurrentgemma-2b --impl cuda \
        --batch 6 --slots 4 --prompt-len 256 --varlen --gen 32 --max-len 4096
    python -m repro_torch.launch.serve --arch llama2-7b --cache-layout paged \
        --impl cuda --batch 8 --slots 4 --prompt-len 1224 \
        --shared-prefix 1024 --prefix-cache --prefill-chunk 256 --gen 32 \
        --max-len 1280 --expect-prefix-hits
    python -m repro_torch.launch.serve --arch llama2-7b --impl cuda \
        --batch 4 --prompt-len 64 --varlen --gen 8 --max-len 128 \
        --devices 4 [--cache-layout paged]
    python -m repro_torch.launch.serve --arch llama2-7b --mode pipeline \
        --stages 4 --impl cuda --batch 8 --prompt-len 64 --varlen --gen 32 \
        --max-len 128 [--stage-procs]
    python -m repro_torch.launch.serve --arch llama2-7b --mode pipeline \
        --stages 4 --impl cuda --cache-layout paged --batch 8 \
        --prompt-len 96 --shared-prefix 48 --prefix-cache --prefill-chunk 16 \
        --gen 32 --max-len 128 --spec-k 4 --expect-prefix-hits
    python -m repro_torch.launch.serve --arch recurrentgemma-2b --impl cuda \
        --cache-layout paged --batch 6 --slots 4 --prompt-len 256 --varlen \
        --gen 32 --max-len 4096
    python -m repro_torch.launch.serve --arch llama2-7b --cache-layout paged \
        --impl cuda --batch 8 --slots 4 --prompt-len 64 --varlen --gen 32 \
        --max-len 128 --policy edf --ttft-slo 64 \
        --inject-faults transient@decode_step:5x2 --max-retries 3
    python -m repro_torch.launch.serve --arch musicgen-large --impl cuda \
        --batch 6 --slots 4 --prompt-len 256 --varlen --gen 16 \
        --max-len 512 [--kvint8] [--cache-layout paged]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --smoke --device cpu --impl ref --batch 4 --gen 8 [--stream]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --smoke --device cpu --mode pipeline --stages 4 --batch 4 --gen 8 \
        [--stage-procs]

It runs on the GPU unless ``--device cpu`` is given, and raises when no GPU
is present.  The hybrid recurrentgemma-2b serves on both layouts, and the
pipeline mode raises for it (its 26 layers are no whole number of 3-layer
periods).  The mixture-of-experts granite-moe-1b-a400m and kimi-k2-1t-a32b
serve in both modes; xlstm-1.3b (no attention layer) serves on both
layouts, the paged one with an empty pool, and in pipeline mode at its
full 48 layers (six 8-block periods; its 4-block ``--smoke`` stack is no
whole period, which the pipeline mode refuses, as the reference's does).  ``--spec-k``, ``--prefix-cache`` and ``--prefill-chunk`` work in
both modes: on the contiguous layout spec serves plain decode and the
prefix cache is ignored, each with a note.  ``--inject-faults`` stops the
launcher in pipeline mode: fault injection wraps the single tp-mode
backend.
``--kvint8`` stores K/V in int8 with per-(token, head) scales: on the
contiguous layout ``--impl cuda`` reads the dequantized rings with the
ring kernel; on the paged one it reads by gather (``attn_impl=ref``, with
a warning once), as the reference does.  ``--impl chunked`` runs prefill
and extend as the online softmax over key blocks.  The reference's
``--devices`` (its fake-XLA-device count) is ``--devices`` here in tp
mode, a process a device of the ``(1, N)`` mesh, and ``--stage-procs`` in
pipeline mode (one process a stage); every process runs on the one device
(processes on several cards are not built yet).

Returns ``(llm, outputs)`` when called as ``main(argv)``.
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced (tiny, float32) variant of --arch")
    ap.add_argument("--mode", default="tp", choices=["tp", "pipeline"],
                    help="the tensor backend, or the planned no-bubbles "
                         "stage pipeline (LLM.from_plan)")
    ap.add_argument("--stages", type=int, default=4,
                    help="pipeline mode: plan over a cluster of this many "
                         "chips (the DP may use fewer stages)")
    ap.add_argument("--stage-procs", action="store_true",
                    help="pipeline mode: run each planned stage in its own "
                         "process, all at the same time, activations over "
                         "torch.distributed (gloo)")
    ap.add_argument("--devices", type=int, default=0,
                    help="tp mode: tensor-parallel on a (1, N) mesh of N "
                         "processes (heads, ff and vocabulary split over "
                         "its model axis), every process on the one device")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests to serve")
    ap.add_argument("--slots", type=int, default=0,
                    help="backend slots (default: --batch for tp, the "
                         "planned stages for pipeline)")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--varlen", action="store_true",
                    help="vary prompt lengths in [prompt_len/2, prompt_len] "
                         "(bucketed admission serves them in one batch)")
    ap.add_argument("--min-bucket", type=int, default=1,
                    help="admission bucket floor (pow-2 padding; masked "
                         "prefill makes any bucket size output-identical, "
                         "so this is purely a compile-shape knob)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--kvint8", action="store_true",
                    help="int8 KV cache with per-(token, head) absmax "
                         "scales")
    ap.add_argument("--cache-layout", default="contiguous",
                    choices=["contiguous", "paged"],
                    help="KV layout: one max_len ring per slot, or block "
                         "tables over a shared pool")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="shared pool size in blocks (paged layout); 0 = "
                         "worst-case provisioning.  Smaller pools overcommit: "
                         "exhaustion preempts the youngest request")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-addressed shared-prefix KV reuse over the "
                         "paged pool (copy-on-write block adoption at "
                         "admission; requires --cache-layout paged and an "
                         "all-attention model, else silently ignored)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: stream prompts through prefill "
                         "this many tokens per scheduler quantum, "
                         "interleaved with decode (0 = monolithic)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: verify up to K tokens per "
                         "quantum (the last emitted token + K-1 drafts) in "
                         "one multi-query pass; greedy outputs stay "
                         "bit-identical.  Needs --cache-layout paged; "
                         "0/1 = off")
    ap.add_argument("--draft", default="ngram",
                    help="draft source for --spec-k: 'ngram' (prompt-lookup "
                         "self-speculation, default), 'ngram:<max>', or "
                         "'off' (verify quantum carries no drafts)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every request the same random prefix of this "
                         "many tokens (demo/validation workload for "
                         "--prefix-cache)")
    ap.add_argument("--expect-prefix-hits", action="store_true",
                    help="exit nonzero unless the run recorded at least one "
                         "prefix-cache hit (CI smoke guard)")
    ap.add_argument("--impl", default="cuda",
                    choices=["ref", "chunked", "cuda"],
                    help="attention: masked sdpa (over the ring, or the "
                         "gathered blocks), the online softmax over key "
                         "blocks for prefill (decode as ref), or the "
                         "hand-written decode and paged attention kernels "
                         "(their plain versions on --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they decode (streaming API)")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "priority", "edf"],
                    help="admission/preemption policy (serving.sched): "
                         "arrival order, service-class priority, or "
                         "earliest-deadline-first over --ttft-slo/--e2e-slo")
    ap.add_argument("--priority", type=int, default=None,
                    help="service-class priority for every request "
                         "(higher = served first under --policy priority)")
    ap.add_argument("--ttft-slo", type=int, default=None,
                    help="first-token deadline in scheduler steps from "
                         "arrival (drives --policy edf; misses are counted "
                         "in the scheduler stats)")
    ap.add_argument("--e2e-slo", type=int, default=None,
                    help="completion deadline in scheduler steps from "
                         "arrival (see --ttft-slo)")
    ap.add_argument("--inject-faults", default="",
                    help="deterministic fault schedule wrapped around the "
                         "backend (runtime.faults), e.g. "
                         "'transient@decode_step:5x2' or 'timeout@any~0.01' "
                         "-- exercises the scheduler's retry/backoff path "
                         "(tp mode only)")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="consecutive transient backend failures absorbed "
                         "with exponential backoff before the scheduler "
                         "gives up (the BackendError taxonomy)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.stage_procs and args.mode != "pipeline":
        ap.error("--stage-procs runs the planned stages one a process: "
                 "pass --mode pipeline")
    if args.devices and args.mode != "tp":
        ap.error("--devices is tp mode's mesh of processes; pipeline mode "
                 "runs its planned stages one a process with --stage-procs")
    if args.inject_faults and args.mode != "tp":
        ap.error("--inject-faults wraps the single tp-mode backend; chaos "
                 "over a multi-backend fleet is benchmarks/chaos_bench.py")

    if args.policy != "fifo" and args.priority is None \
            and args.ttft_slo is None and args.e2e_slo is None:
        ap.error(
            f"--policy {args.policy} without --priority/--ttft-slo/--e2e-slo "
            f"degenerates to FIFO (every request gets the default service "
            f"class): pass the service-class flags the policy orders by, or "
            f"drop --policy")
    if args.policy == "edf" and args.ttft_slo is None \
            and args.e2e_slo is None:
        ap.error("--policy edf orders by deadlines: pass --ttft-slo and/or "
                 "--e2e-slo (steps from arrival); --priority alone only "
                 "affects --policy priority")

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.core.devices import tpu_pod_cluster
    from repro_torch.core.profile import Workload
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime import FaultInjectionBackend, TensorBackend
    from repro_torch.serving import LLM, SamplingParams

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.kvint8:
        cfg = dataclasses.replace(cfg, kv_dtype="int8")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    rng = np.random.default_rng(args.seed)
    lens = [args.prompt_len] * args.batch
    if args.varlen:
        lens = [int(x) for x in rng.integers(
            max(args.prompt_len // 2, 1), args.prompt_len + 1, args.batch)]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    if args.shared_prefix:
        if args.shared_prefix >= min(lens):
            ap.error(f"--shared-prefix {args.shared_prefix} must be shorter "
                     f"than every prompt (min {min(lens)})")
        pre = rng.integers(0, cfg.vocab_size,
                           args.shared_prefix).astype(np.int32)
        prompts = [np.concatenate([pre, p[args.shared_prefix:]])
                   for p in prompts]

    kv_kw = dict(max_len=args.max_len, impl=args.impl,
                 cache_layout=args.cache_layout, block_size=args.block_size,
                 num_blocks=args.kv_blocks or None,
                 prefix_cache=args.prefix_cache, device=dev)
    serve_kw = dict(seed=args.seed, min_bucket=args.min_bucket,
                    prefill_chunk=args.prefill_chunk or None,
                    policy=args.policy, spec_k=args.spec_k, draft=args.draft,
                    max_retries=args.max_retries)
    if args.mode == "pipeline":
        # planner -> backend -> serving in one call: the DP chooses the
        # (possibly uneven) stage layout over a homogeneous cluster profile
        # of --stages chips; every stage runs on this one device
        llm = LLM.from_plan(
            cfg, tpu_pod_cluster(n_chips=args.stages),
            Workload(prompt_len=args.prompt_len, gen_tokens=args.gen,
                     dtype_bytes=2),
            objective="throughput", kind="pipeline", params=params,
            n_slots=args.slots or None, stage_procs=args.stage_procs,
            **kv_kw, **serve_kw)
        print(f"planned stages (periods per stage): "
              f"{llm.backend.spec.periods_per_stage}"
              + (" (one process a stage)" if args.stage_procs else ""))
    else:
        mesh = Mesh(("data", "model"), (1, args.devices)) \
            if args.devices else None
        backend = TensorBackend(cfg, params,
                                n_slots=args.slots or args.batch, mesh=mesh,
                                **kv_kw)
        if mesh is not None:
            print(f"tensor-parallel on a {mesh.shape} mesh of "
                  f"{mesh.size} processes")
        if args.inject_faults:
            backend = FaultInjectionBackend(backend, args.inject_faults,
                                            seed=args.seed)
        llm = LLM.from_backend(backend, **serve_kw)

    # every user-passed flag that ends up inert gets one explicit line
    def _inert(flag, why):
        print(f"note: {flag} has no effect on this deployment: {why}")

    info = llm.backend.info
    if args.prefix_cache and not info.prefix_caching:
        _inert("--prefix-cache",
               f"backend reports prefix_caching=False over cache_layout="
               f"{info.cache_layout!r} (needs --cache-layout paged and an "
               f"all-attention model)")
    if args.spec_k >= 2 and not info.spec_decode:
        _inert("--spec-k",
               f"backend reports spec_decode=False (cache_layout="
               f"{info.cache_layout!r}); serving plain decode")
    if args.priority is not None and args.policy == "fifo":
        _inert("--priority", "FIFO ignores service classes; pass "
                             "--policy priority")

    sp = SamplingParams(max_tokens=args.gen,
                        priority=args.priority or 0,
                        ttft_slo=args.ttft_slo, e2e_slo=args.e2e_slo)
    t0 = time.time()
    try:
        if args.stream:
            outs = {}
            for ev in llm.stream(prompts, sp):
                print(f"  step {ev.step:4d} req {ev.uid} tok[{ev.index}]="
                      f"{ev.token}" + (f" <{ev.finish_reason}>"
                                       if ev.finished else ""))
                if ev.finished:
                    outs[ev.uid] = llm.poll(ev.uid)
            outs = list(outs.values())
        else:
            outs = llm.generate(prompts, sp)
    finally:
        if args.stage_procs or args.devices:
            # the stage or mesh processes (under a fault injector's wrapper)
            getattr(llm.backend, "inner", llm.backend).close()
    dt = time.time() - t0
    total = sum(o.n_generated for o in outs)
    info = llm.backend.info
    st = llm.stats
    print(f"served {len(outs)} requests ({[o.n_prompt for o in outs]} prompt "
          f"tokens), {total} generated in {dt:.2f}s ({total / dt:.1f} tok/s) "
          f"on {dev} (attn_impl={info.attn_impl}) — {llm.stats}")
    if args.inject_faults:
        inj = llm.backend.injected
        print(f"  faults ({args.inject_faults}): injected "
              f"{ {k: v for k, v in inj.items() if v} }, "
              f"absorbed with {st.retries} retries "
              f"({st.failures} failures) — backend {llm.backend.health()}")
    if st.prefix_hits or st.prefill_chunks:
        print(f"  prefix cache: {st.prefix_hits} hits "
              f"({st.prefix_hit_tokens} prompt tokens reused); "
              f"{st.prefill_chunks} prefill chunk passes")
    if args.ttft_slo is not None or args.e2e_slo is not None:
        met = sum(1 for o in outs if o.slo_met())
        print(f"  SLO ({args.policy}): {met}/{len(outs)} met "
              f"(ttft_misses={st.ttft_misses}, e2e_misses={st.e2e_misses}, "
              f"slo_preemptions={st.slo_preemptions})")
    for o in outs[:4]:
        ttft = f"{o.timing.ttft_s:.2f}s" if o.timing.ttft_s else "-"
        print(f"  req {o.uid}: {o.finish_reason} after {o.n_generated} toks "
              f"(ttft {ttft}) {o.tokens[:10]}")
    if args.expect_prefix_hits and not st.prefix_hits:
        raise SystemExit(
            "--expect-prefix-hits: no prefix-cache hits were recorded "
            f"(prefix_caching={info.prefix_caching}); check "
            "--cache-layout paged / --prefix-cache / --shared-prefix")
    return llm, outs


if __name__ == "__main__":
    main()
