"""Serving launcher of the port: request-lifecycle generation through the
``LLM`` facade over :class:`~repro_torch.runtime.TorchTensorBackend` on the
paged KV layout.  Weights are random, made from ``--seed``.

    python -m repro_torch.launch.serve --arch llama2-7b --cache-layout paged \
        --impl cuda --batch 6 --slots 4 --prompt-len 256 --varlen --gen 32 \
        --max-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --smoke --device cpu --impl ref --batch 4 --gen 8 [--stream]

It runs on the GPU unless ``--device cpu`` is given, and raises when no GPU
is present.  The pipeline mode, the contiguous layout, the prefix cache,
speculative decoding and the SLO policies of ``repro.launch.serve`` arrive
with later slices of the port; this launcher has no flags for them.
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
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--cache-layout", default="paged", choices=["paged"],
                    help="KV layout: block tables over a shared pool")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="shared pool size in blocks; 0 = worst-case "
                         "provisioning.  Smaller pools overcommit: exhaustion "
                         "preempts the youngest request")
    ap.add_argument("--impl", default="cuda", choices=["ref", "cuda"],
                    help="paged decode read path: gather + masked sdpa, or "
                         "the hand-written paged attention kernel (its plain "
                         "version on --device cpu)")
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
    from repro_torch.runtime import TorchTensorBackend
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

    backend = TorchTensorBackend(
        cfg, params, n_slots=args.slots or args.batch, max_len=args.max_len,
        impl=args.impl, cache_layout=args.cache_layout,
        block_size=args.block_size, num_blocks=args.kv_blocks or None,
        device=dev)
    llm = LLM.from_backend(backend, seed=args.seed)
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
    print(f"served {len(outs)} requests ({[o.n_prompt for o in outs]} prompt "
          f"tokens), {total} generated in {dt:.2f}s ({total / dt:.1f} tok/s) "
          f"on {dev} (attn_impl={info.attn_impl}) — {llm.stats}")
    for o in outs[:4]:
        ttft = f"{o.timing.ttft_s:.2f}s" if o.timing.ttft_s else "-"
        print(f"  req {o.uid}: {o.finish_reason} after {o.n_generated} toks "
              f"(ttft {ttft}) {o.tokens[:10]}")


if __name__ == "__main__":
    main()
