#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines.  A failed check raises, so the script
exits non-zero and prints no result line; no phase catches its own failure.

1. device  -- the card's name and power limit from ``nvidia-smi``, and
   torch's name for it;
2. build   -- ``nvcc`` builds every kernel of the main path from the sources
   in this checkout;
3. kernels -- each kernel against its plain PyTorch version on the card, over
   the cases of the JAX kernel tests (GQA group sizes of llama2-7b,
   qwen3-0.6b and llama2-70b, unmapped table entries, a wrapped ring with a
   window, softcap, a fully masked row, 1 and 4 query tokens per slot), in
   float32 and bfloat16; then timed at the main path's shapes beside the plain
   version, one library call and the card's bound;
4. serve   -- llama2-7b at full width and depth, random weights from a seed,
   through ``LLM.generate`` over ``TorchTensorBackend(impl="cuda")`` on the
   paged KV cache: six greedy requests over four slots, so slots recycle.
   Every kernel of the path must have launched, once per layer and decode
   step; the decode logits, fed the run's own tokens, must agree with the
   ``impl="ref"`` read path;
5. result  -- one JSON line of per-kernel numbers, then the result line.

It imports torch and the port only, never jax and nothing of ``repro``.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# kernel against its plain version.  float32: the JAX kernel tests' tolerance.
# bfloat16: both sides read the same bf16 inputs, accumulate in float32 and
# round once to bf16; they sum in another order, so a result may round to the
# neighbouring bf16 value, one step of 2**-7 relative.
TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}
# decode logits of impl="cuda" against impl="ref" over the whole bf16 model:
# the ref path rounds the probabilities to bf16 before the PV product and the
# kernel does not, and 32 layers carry that difference to the logits
LOGITS_ATOL = 0.25

ARCH = "llama2-7b"
SLOTS, MAX_LEN, BLOCK_SIZE = 4, 512, 16
PROMPT_LENS = (17, 64, 100, 128, 200, 256)
MAX_TOKENS = 32
SEED = 0
DEVICE = "cuda"

# datasheet device-memory rates (bytes/s) and dense bf16 tensor rate
MEM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12))
PEAK_BF16 = 989e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE:
        if key in name:
            return rate
    raise ValueError(f"no datasheet memory rate for card {name!r}")


# --------------------------------------------------------------------------- #
# kernels against their plain versions
# --------------------------------------------------------------------------- #

def paged_case(rng, *, b, h, kh, nbs, lens, kq, d=128, bs=BLOCK_SIZE,
               dead=(), last=None):
    """Numpy inputs of one paged attention call.  Slot i holds keys
    0..lens[i]+kq-2 (its history plus the step's own tokens, scattered
    first) and decodes from ``pos = lens[i] - 1``; table entries past its
    keys stay unmapped (-1), as the pager leaves them.  Slots in ``dead``
    hold nothing.  ``last`` wraps slot 0's ring: its keys are the ``c``
    positions up to ``last``."""
    c = nbs * bs
    n_blocks = b * nbs + 2
    pools = rng.standard_normal((2, n_blocks + 1, bs, kh, d), np.float32)
    q = rng.standard_normal((b, kq, h, d), np.float32)
    bt = rng.permutation(n_blocks)[:b * nbs].reshape(b, nbs).astype(np.int32)
    n_keys = np.asarray(lens) + kq - 1
    cols = np.arange(c)[None]
    key_pos = np.where(cols < n_keys[:, None], cols, -1).astype(np.int32)
    pos = (np.asarray(lens) - 1).astype(np.int32)
    if last is not None:
        key_pos[0] = last - (last - np.arange(c)) % c
        pos[0] = last - kq + 1
    used = -(-(key_pos.max(axis=1) + 1) // bs)
    bt[np.arange(nbs)[None] >= np.minimum(used, nbs)[:, None]] = -1
    for i in dead:
        bt[i], key_pos[i] = -1, -1
    return dict(q=q, k_pool=pools[0], v_pool=pools[1], bt=bt,
                key_pos=key_pos, pos=pos)


KERNEL_CASES = [
    # name, shapes, options
    ("llama2-7b g=1", dict(b=4, h=32, kh=32, nbs=32, lens=(512, 300, 17, 129),
                           kq=1), {}),
    ("llama2-7b g=1 KQ=4", dict(b=4, h=32, kh=32, nbs=32,
                                lens=(509, 300, 17, 129), kq=4), {}),
    ("qwen3-0.6b g=2 softcap", dict(b=3, h=16, kh=8, nbs=16,
                                    lens=(40, 25, 200), kq=1),
     dict(softcap=30.0)),
    ("qwen3-0.6b g=2 KQ=4 softcap", dict(b=3, h=16, kh=8, nbs=16,
                                         lens=(40, 25, 200), kq=4),
     dict(softcap=30.0)),
    ("llama2-70b g=8", dict(b=2, h=64, kh=8, nbs=8, lens=(100, 1), kq=1), {}),
    ("llama2-70b g=8 KQ=4", dict(b=2, h=64, kh=8, nbs=8, lens=(100, 1),
                                 kq=4), {}),
    ("wrapped ring + window", dict(b=1, h=32, kh=32, nbs=4, lens=(1,), kq=1,
                                   last=150), dict(window=40)),
    ("wrapped ring + window KQ=4", dict(b=1, h=64, kh=8, nbs=4, lens=(1,),
                                        kq=4, last=150), dict(window=40)),
    ("fully masked row", dict(b=2, h=16, kh=8, nbs=2, lens=(20, 5), kq=1,
                              dead=(1,)), {}),
    ("fully masked row KQ=4", dict(b=2, h=64, kh=8, nbs=2, lens=(20, 5),
                                   kq=4, dead=(1,)), {}),
]


def to_device(case, dtype):
    out = {}
    for k, v in case.items():
        t = torch.from_numpy(v).to(DEVICE)
        out[k] = t.to(dtype) if t.is_floating_point() else t
    if out["q"].shape[1] == 1:           # one token per slot: q [B, H, D]
        out["q"] = out["q"][:, 0].contiguous()
    return out


def check_kernels(pa):
    """Every case in float32 and bfloat16; returns the largest error."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for i, (name, shape, opts) in enumerate(KERNEL_CASES):
            case = paged_case(np.random.default_rng(100 + i), **shape)
            x = to_device(case, dtype)
            got = pa.paged_attention(**x, **opts)
            want = pa.paged_attention_plain(**x, **opts)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), **tol,
                                       msg=lambda m: f"{name} {dtype}: {m}")
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            extra = ""
            for row in shape.get("dead", ()):
                if not bool((got[row] == 0).all()):
                    raise AssertionError(f"{name}: masked row {row} is not "
                                         f"exact zeros")
                extra = ", masked row exact zeros"
            if (x["bt"] < 0).any():
                # the scratch block and unmapped entries are never read
                x["k_pool"][-1] = 1e6
                x["v_pool"][-1] = -1e6
                again = pa.paged_attention(**x, **opts)
                if not torch.equal(again, got):
                    raise AssertionError(f"{name}: output depends on the "
                                         f"scratch block")
                extra += ", scratch block never read"
            print(f"kernels: paged_attention {name} {str(dtype)[6:]}: max abs "
                  f"err {err:.3g} (rtol/atol {tol['rtol']:.3g}){extra}")
    return worst


def time_ms(fn, n_sets, iters=200):
    """Device time of one call from CUDA events over ``iters`` calls,
    rotating over ``n_sets`` input sets so the caches come cold from device
    memory, as each layer's pool does on the main path."""
    for i in range(10):
        fn(i % n_sets)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(pa, card_name):
    """paged_attention at the main path's shapes: llama2-7b, 4 slots with
    512 keys each, bf16."""
    import torch.nn.functional as F
    shape = dict(b=SLOTS, h=32, kh=32, nbs=MAX_LEN // BLOCK_SIZE,
                 lens=(MAX_LEN,) * SLOTS, kq=1)
    n_sets = 4                      # 4 x 34 MB of K/V: more than the L2
    sets = [to_device(paged_case(np.random.default_rng(200 + i), **shape),
                      torch.bfloat16) for i in range(n_sets)]
    lib = []
    for x in sets:
        b, h, d = x["q"].shape
        read = x["bt"].clamp(min=0).long()
        kh = x["k_pool"].shape[2]
        k = x["k_pool"][read].reshape(b, -1, kh, d).transpose(1, 2)
        v = x["v_pool"][read].reshape(b, -1, kh, d).transpose(1, 2)
        mask = (x["key_pos"] >= 0) & (x["key_pos"] <= x["pos"][:, None])
        lib.append((x["q"][:, :, None], k.contiguous(), v.contiguous(),
                    mask[:, None, None]))
    err = max((pa.paged_attention(**x) - pa.paged_attention_plain(**x))
              .float().abs().max().item() for x in sets)
    ms = time_ms(lambda i: pa.paged_attention(**sets[i]), n_sets)
    plain_ms = time_ms(lambda i: pa.paged_attention_plain(**sets[i]), n_sets,
                       iters=20)
    library_ms = time_ms(
        lambda i: F.scaled_dot_product_attention(
            lib[i][0], lib[i][1], lib[i][2], attn_mask=lib[i][3]), n_sets)
    # the least work: read q, each valid key and value once, the slots'
    # key_pos over their mapped blocks, the table and pos; write the output
    x = sets[0]
    b, h, d = x["q"].shape
    kh, item = x["k_pool"].shape[2], x["k_pool"].element_size()
    n_keys = int((x["key_pos"] >= 0).sum())
    n_bytes = (2 * x["q"].numel() * item + n_keys * kh * d * 2 * item
               + n_keys * 4 + x["bt"].numel() * 4 + b * 4)
    n_ops = n_keys * (h // kh) * kh * 4 * d
    bytes_ms = n_bytes / mem_rate(card_name) * 1e3
    ops_ms = n_ops / PEAK_BF16 * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms, n_bytes=n_bytes)


# --------------------------------------------------------------------------- #
# serve
# --------------------------------------------------------------------------- #

class StepClock:
    """Host-clock times of a backend's prefill and decode calls.  Each call
    ends in the logits readback, which waits for the card."""

    def __init__(self, backend):
        self.prefill_ms, self.decode_ms = [], []
        for name, log in (("prefill", self.prefill_ms),
                          ("decode_step", self.decode_ms)):
            setattr(backend, name, self._timed(getattr(backend, name), log))

    @staticmethod
    def _timed(fn, log):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            log.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def reset(self):
        self.prefill_ms.clear()
        self.decode_ms.clear()


def teacher_forced(backend, prompts, outs):
    """Decode logits [n_req, MAX_TOKENS - 1, V] with each request's own
    generated tokens fed back, waves of ``SLOTS`` requests."""
    rows = []
    for w in range(0, len(prompts), SLOTS):
        wave = list(range(w, min(w + SLOTS, len(prompts))))
        width = max(len(prompts[i]) for i in wave)
        padded = np.zeros((len(wave), width), np.int32)
        for j, i in enumerate(wave):
            padded[j, width - len(prompts[i]):] = prompts[i]
        slots = list(range(len(wave)))
        backend.prefill(slots, padded, [len(prompts[i]) for i in wave])
        steps = []
        for t in range(MAX_TOKENS - 1):
            evs = backend.decode_step({s: outs[i].tokens[t]
                                       for s, i in zip(slots, wave)})
            steps.append(np.stack([ev.logits for ev in evs]))
        rows.append(np.stack(steps, axis=1))
        for s in slots:
            backend.free_slot(s)
    return np.concatenate(rows)


def serve(pa, card):
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.runtime import TorchTensorBackend
    from repro_torch.serving import LLM, SamplingParams

    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]

    def backend(impl):
        return TorchTensorBackend(cfg, params, n_slots=SLOTS, max_len=MAX_LEN,
                                  impl=impl, cache_layout="paged",
                                  block_size=BLOCK_SIZE, device=DEVICE)

    be = backend("cuda")
    if be.info.attn_impl != "cuda":
        raise AssertionError(f"backend reports attn_impl={be.info.attn_impl}")
    print(f"serve: {ARCH} {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{be.info.param_bytes / 1e9:.2f} GB of {cfg.dtype} weights from "
          f"seed {SEED} in {init_s:.1f} s")
    clock = StepClock(be)
    llm = LLM.from_backend(be, seed=SEED)
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    llm.generate([prompts[0][:16]], SamplingParams(max_tokens=4))  # warm-up

    clock.reset()
    pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    outs = llm.generate(prompts, sp)
    wall = time.perf_counter() - t0
    launches = pa.paged_attention.launches

    for o in outs:
        if o.n_generated != MAX_TOKENS or o.finish_reason != "length" \
                or not all(0 <= t < cfg.vocab_size for t in o.tokens):
            raise AssertionError(f"request {o.uid}: {o.n_generated} tokens, "
                                 f"{o.finish_reason}")
    steps = len(clock.decode_ms)
    if launches != cfg.n_layers * steps or launches == 0:
        raise AssertionError(f"paged_attention launched {launches} times over "
                             f"{steps} decode steps of {cfg.n_layers} layers")
    total = sum(o.n_generated for o in outs)
    print(f"serve: {len(outs)} requests {list(PROMPT_LENS)} prompt tokens x "
          f"{MAX_TOKENS} greedy tokens over {SLOTS} slots: "
          f"{len(clock.prefill_ms)} prefills, {steps} decode steps, "
          f"paged_attention launches {launches} = {cfg.n_layers} layers x "
          f"{steps} steps, {llm.stats.preemptions} preemptions")
    print(f"serve: prefill ms per wave "
          f"{[round(t, 3) for t in clock.prefill_ms]}, decode ms per step "
          f"median {statistics.median(clock.decode_ms):.3f} "
          f"(min {min(clock.decode_ms):.3f}, max {max(clock.decode_ms):.3f}), "
          f"{total / wall:.1f} tokens/s over {wall:.2f} s [{card}]")
    device_share(llm, prompts, card)
    del llm, be, clock
    torch.cuda.empty_cache()

    got = {impl: teacher_forced(backend(impl), prompts, outs)
           for impl in ("cuda", "ref")}
    torch.cuda.empty_cache()
    diff = np.abs(got["cuda"] - got["ref"])
    if not np.isfinite(got["cuda"]).all() or diff.max() > LOGITS_ATOL:
        raise AssertionError(f"decode logits cuda vs ref: max abs diff "
                             f"{diff.max():.4g} > {LOGITS_ATOL}")
    agree = int((got["cuda"].argmax(-1) == got["ref"].argmax(-1)).sum())
    print(f"serve: teacher-forced decode logits {list(got['cuda'].shape)}, "
          f"impl cuda vs ref max abs diff {diff.max():.4g} (mean "
          f"{diff.mean():.3g}, |logits| max "
          f"{np.abs(got['ref']).max():.3g}; atol {LOGITS_ATOL}), argmax "
          f"agreement {agree}/{diff.shape[0] * diff.shape[1]}")
    return dict(launches=launches)


def device_share(llm, prompts, card):
    """The card's busy share over a short profiled serve (one wave of
    ``SLOTS`` requests, 8 tokens each), and the device time by kernel.  The
    profiler adds host time, so the busy share it shows is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import SamplingParams
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llm.generate(prompts[:SLOTS], SamplingParams(max_tokens=8))
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        print("serve: device busy share not measured (the profiler saw no "
              "device events)")
        return
    print(f"serve: profiled {SLOTS} requests x 8 tokens: device busy "
          f"{busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall "
          f"({busy / wall_us:.1%}) [{card}]")
    kinds = {"matrix products": ("gemm", "nvjet", "cutlass", "xmma"),
             "paged attention": ("paged_attention_kernel",)}
    shares = {kind: sum(us for n, us in by_name.items()
                        if any(k in n for k in keys)) / busy
              for kind, keys in kinds.items()}
    print("serve:   device time by kind: " + ", ".join(
        f"{kind} {share:.1%}" for kind, share in shares.items())
          + f", other {1 - sum(shares.values()):.1%}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"serve:   {us / 1e3:8.3f} ms {us / busy:6.1%}  {name[:90]}")


def main():
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        sys.exit("chip_smoke: src/repro_torch is not beside this script; run "
                 "it from the root of a checkout of the repository")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; the port's "
                 "smoke test runs on an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import paged_attention as pa

    # float32 products in full float32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    built = pa.build()
    print(f"build: {built.path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {built.seconds:.1f} s)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}")

    worst = check_kernels(pa)
    timing = time_kernels(pa, card)
    print(f"kernels: paged_attention at llama2-7b x {SLOTS} slots x "
          f"{MAX_LEN} keys bf16: kernel {timing['ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms, sdpa on the gathered cache "
          f"{timing['library_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
          f"({timing['n_bytes'] / 1e6:.2f} MB by {timing['bound_by']}) "
          f"[{card}]; worst case error {worst:.3g}")

    run = serve(pa, card)

    kernels = [dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:201",
        launches=run["launches"], max_abs_err=timing["max_abs_err"],
        ms=timing["ms"], plain_ms=timing["plain_ms"],
        bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
        library_ms=timing["library_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
