"""Serving launcher of the port: request-lifecycle generation through the
``LLM`` facade over :class:`~repro_torch.runtime.TensorBackend`, on the
contiguous (default) or the paged KV layout, optionally with speculative
decoding, the prefix cache and chunked prefill on the paged one.  Weights
are random, made from ``--seed``.

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
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --smoke --device cpu --impl ref --batch 4 --gen 8 [--stream]

It runs on the GPU unless ``--device cpu`` is given, and raises when no GPU
is present.  The hybrid recurrentgemma-2b serves on the contiguous layout
only; ``--cache-layout paged`` raises for it.  The pipeline mode, fault
injection and the SLO policies of ``repro.launch.serve`` arrive with later
slices of the port; this launcher has no flags for them.
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced (tiny, float32) variant of --arch")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests to serve")
    ap.add_argument("--slots", type=int, default=0,
                    help="backend slots (default: --batch)")
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
    ap.add_argument("--impl", default="cuda", choices=["ref", "cuda"],
                    help="decode read path: masked sdpa (over the ring, or "
                         "the gathered blocks), or the hand-written decode "
                         "and paged attention kernels (their plain versions "
                         "on --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they decode (streaming API)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.runtime import TensorBackend
    from repro_torch.serving import LLM, SamplingParams

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
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

    backend = TensorBackend(
        cfg, params, n_slots=args.slots or args.batch, max_len=args.max_len,
        impl=args.impl, cache_layout=args.cache_layout,
        block_size=args.block_size, num_blocks=args.kv_blocks or None,
        device=dev, prefix_cache=args.prefix_cache)
    info = backend.info
    if args.spec_k >= 2 and not info.spec_decode:
        print(f"note: --spec-k {args.spec_k} ignored: the backend does not "
              f"verify speculative drafts (cache_layout="
              f"{info.cache_layout!r}; speculative decoding needs "
              f"the paged layout and no sliding window); serving plain "
              f"decode")
    if args.prefix_cache and not info.prefix_caching:
        print(f"note: --prefix-cache has no effect on this deployment: "
              f"backend reports prefix_caching=False over cache_layout="
              f"{info.cache_layout!r} (needs --cache-layout paged and an "
              f"all-attention model)")
    llm = LLM.from_backend(backend, seed=args.seed,
                           min_bucket=args.min_bucket,
                           prefill_chunk=args.prefill_chunk or None,
                           spec_k=args.spec_k, draft=args.draft)
    sp = SamplingParams(max_tokens=args.gen)
    t0 = time.time()
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
    dt = time.time() - t0
    total = sum(o.n_generated for o in outs)
    info = backend.info
    st = llm.stats
    print(f"served {len(outs)} requests ({[o.n_prompt for o in outs]} prompt "
          f"tokens), {total} generated in {dt:.2f}s ({total / dt:.1f} tok/s) "
          f"on {dev} (attn_impl={info.attn_impl}) — {llm.stats}")
    if st.prefix_hits or st.prefill_chunks:
        print(f"  prefix cache: {st.prefix_hits} hits "
              f"({st.prefix_hit_tokens} prompt tokens reused); "
              f"{st.prefill_chunks} prefill chunk passes")
    for o in outs[:4]:
        ttft = f"{o.timing.ttft_s:.2f}s" if o.timing.ttft_s else "-"
        print(f"  req {o.uid}: {o.finish_reason} after {o.n_generated} toks "
              f"(ttft {ttft}) {o.tokens[:10]}")
    if args.expect_prefix_hits and not st.prefix_hits:
        raise SystemExit(
            "--expect-prefix-hits: no prefix-cache hits were recorded "
            f"(prefix_caching={info.prefix_caching}); check "
            "--cache-layout paged / --prefix-cache / --shared-prefix")


if __name__ == "__main__":
    main()
