#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines.  A failed check raises, so the script
exits non-zero and prints no result line; no phase catches its own failure.

1. device  -- the card's name and power limit from ``nvidia-smi``, and
   torch's name for it;
2. build   -- ``nvcc`` builds every kernel of the main paths from the sources
   in this checkout (five: paged, contiguous-ring and flash attention, the
   RG-LRU scan, the int8 matmul), one process per source, all started
   together; each source's compile time and register and spill report;
3. kernels -- each kernel against its plain PyTorch version on the card. The
   attention kernels in float32 and bfloat16: the paged kernel over the
   cases of the JAX kernel tests (GQA group sizes of llama2-7b, qwen3-0.6b
   and llama2-70b, unmapped table entries, a wrapped ring with a window,
   softcap, a fully masked row, 1 and 4 query tokens per slot) and tables
   split across blocks (a 4096-key table with 300 valid keys, unmapped
   entries inside splits, llama2-70b's g=8 at KQ=4 in two row chunks, a
   wrapped window ring whose valid keys sit in one split, a fully masked row
   through the merge, block sizes 8 and 32, recurrentgemma-2b's g=10 at
   D=256 over a 2048-key window); each case also called twice
   (bit-identical) and with the pool rows it must not read poisoned with NaN
   (the scratch block, unmapped blocks, masked keys: never read), and its
   split count printed; then row i of a KQ=4 call against the KQ=1 call at
   pos + i, bit for bit (llama2-7b g=1, qwen3-0.6b g=2 with softcap); the
   contiguous-ring kernel over GQA groups 1, 2 and 8, C=700 with 650 valid
   keys, the contiguous serve's 4096-key ring, recurrentgemma-2b's MQA group
   of 10 at D=256 over its 2048-key window (one row wrapped), shared and
   per-row positions, the wrapped ring with a window of 50, softcap and a
   fully masked row, and rings split across blocks: splits whose keys are
   all masked, C not a multiple of the split length, a wrapped window ring
   whose valid keys sit in one split, a fully masked row through the merge,
   llama2-70b's g=8 at B=1 over 4096 keys; each case also called twice
   (bit-identical) and with its masked ring rows poisoned (never read), and
   its split count printed.  The RG-LRU scan in float32 at R = 2560 and 200
   (ragged), S = 1, 7 and 4096, with and without h0, and left-pad identity
   steps that must leave h bit for bit.  The flash-attention kernel in
   float32 and bfloat16 over the cases of the JAX kernel tests (MHA, GQA
   with a ragged S, MQA at D=128, S below one tile; windows 16, 64 and 128
   with and without softcap), and every shape a main path gives it: the
   score phases' 2 x 4096 at llama2-7b's heads and at recurrentgemma-2b's
   (H=10, KH=1, D=256, window 2048; also at a ragged S=2500), and the train
   phase's qwen3-0.6b 4 x 512 (H=16, KH=8, D=128); and the edges of its
   tiles: S = 1, 63 and 65 (window 16 at D=256), q scaled by 16; each case
   called twice, bit-identical, and in bfloat16 within one bf16 step of the
   plain version's arithmetic in float64 (``tests/flash_reference.py``); the
   timing shapes print how many key tiles the walk masks.  The int8 matmul
   in float32 and bfloat16 at the JAX int8 test's shapes (one ragged in M, K
   and N), with leading dimensions, at llama2-7b's projections (K x N
   4096 x 4096, 4096 x 11008, 11008 x 4096) at M = 4 and 8192, and at the
   bfloat16 kernel's edges (M = 1, 16, 17 and 130, K = 4104, N = 4100 and
   4096); in bfloat16 each call repeated (bit-identical) and its outputs
   beyond one bf16 step of the plain version counted.  Then each is
   timed at the main path's shapes (the pipeline's decode at one slot a
   call over 64 keys too) beside the plain version, one library
   call where there is one and the card's bound, and every timing input set
   is held against the plain version too.  Kernel and library calls are
   timed as a CUDA graph's replay, so a short kernel's time is the card's
   and not the host's launch rate.  Last, the int8 op's entry point as its
   users call it: one llama2-7b layer's seven projections, quantized, on a
   decode step and a 2 x 4096-token prefill in bf16 (one launch per
   projection, the output equal to the plain chain's);
4. serve   -- llama2-7b at full width and depth, random weights from a seed,
   six greedy requests over four slots, so slots recycle, through the
   ``LLM`` API over ``TorchTensorBackend(impl="cuda")``, three times:
   - paged: the paged kernel launches once per layer and decode step;
   - contiguous (the default layout), ``max_len`` 4096: the contiguous-ring
     kernel launches once per layer and decode step, the paged one never;
   - paged with ``spec_k=4`` and an oracle draft corrupted at 25%, so
     rollbacks run: the paged kernel launches once per layer and verify
     step, with 4 query tokens per slot;
   and each time the logits, fed the run's own tokens, must agree with the
   ``impl="ref"`` read path; then streamed admission: eight requests of a
   shared 1024-token prefix plus 16-200 tokens each, over four slots, with
   the prefix cache and 256-token chunks (``max_len`` 1280): at least four
   prefix hits, the paged kernel once per layer and decode step, and every
   request's first-token logits within 0.25 of the monolithic paged serve
   of the same prompts;
   then the score phase: ``forward(mode="train")`` over 2 x 4096 seeded
   tokens under ``torch.no_grad``, ``impl="cuda"`` (one flash launch per
   layer, no decode kernel) against ``impl="ref"``;
   then the pipeline phase, the paper's path: ``LLM.from_plan`` plans
   llama2-7b over the paper's testbed (the throughput DP: 13 uneven
   stages) and serves the plan as the no-bubbles stage pipeline on this
   card, one request of 16-48 prompt tokens per slot x 16 greedy tokens,
   ``max_len`` 64, on the contiguous layout (the contiguous-ring kernel
   once per layer and fed token) and then the paged one (the paged
   kernel likewise); each serve's logits, which chose its greedy tokens,
   within 0.25 of the contiguous ``TensorBackend``'s fed the same tokens;
   tick ms, tokens/s, the phase's wall and a profiled window; then the
   planned stages' ``pipeline_forward`` over 2 x 4096 tokens in 2
   micro-batches (the flash kernel once per layer and micro-batch)
   against ``forward(mode="train", impl="ref")``;
5. hybrid  -- the llama2 weights freed, recurrentgemma-2b at full width and
   depth (18 RG-LRU and 8 local-attention layers, window 2048), random
   weights from a seed, ``max_len`` 4096, six greedy requests over four
   slots, one prompt of 2100 tokens so its ring wraps: the scan kernel
   launches once per RG-LRU layer and prefill wave, the contiguous-ring
   kernel once per attention layer and decode step, the paged one never;
   the paged layout refuses the hybrid; teacher-forced logits, cuda
   against ref (the doubling scan and the ring sdpa); then its score
   phase at 2 x 4096 tokens (8 windowed flash launches, 18 scan launches);
6. train   -- the hybrid's weights freed, qwen3-0.6b at full width and
   depth (28 layers, bf16 weights, float32 moments): 8 AdamW steps of the
   port's ``train`` on the synthetic stream (batch 4 x 512 tokens,
   ``impl="ref"``), whose loss must fall; timed train steps; the
   evaluation loss through the flash kernel (28 launches, ``no_grad``)
   against ``impl="ref"``; a checkpoint written and restored bit for bit;
7. result  -- one JSON line of per-kernel numbers, then the result line.

It imports torch, numpy and the port only, never jax and nothing of
``repro``.
"""
import gc
import json
import statistics
import subprocess
import sys
import tempfile
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
# the RG-LRU scan against its plain version: the JAX kernel test's
# tolerance (both round a*h, then +b, in float32; only expf may differ)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
# logits of impl="cuda" against impl="ref" over the whole bf16 model: the
# ref path rounds the probabilities to bf16 before the PV product and the
# kernels do not, and 32 layers carry that difference to the logits
LOGITS_ATOL = 0.25
# the evaluation loss through the flash kernel against impl="ref" (qwen3-0.6b,
# bf16, 4 x 512 tokens; the ref path alone rounds P to bf16 before P V): set
# from readings on an H100, differences of 7.0e-5 and 2.0e-4 on two seeded
# batches (PERF.md), as ten times the larger
LOSS_ATOL = 2e-3

ARCH = "llama2-7b"
SLOTS, MAX_LEN, BLOCK_SIZE = 4, 512, 16
CONTIGUOUS_MAX_LEN = 4096           # the Llama2 context: 4 x 2 GiB of rings
PROMPT_LENS = (17, 64, 100, 128, 200, 256)
MAX_TOKENS = 32
SPEC_K, ACCEPT_PROB = 4, 0.75
SEED = 0
DEVICE = "cuda"
HYBRID = "recurrentgemma-2b"
HYBRID_MAX_LEN = 4096
HYBRID_WINDOW = 2048
HYBRID_PROMPT_LENS = (17, 64, 100, 128, 200, 2100)   # 2100: the ring wraps
SCORE_BATCH, SCORE_LEN = 2, 4096    # the score phases' train-mode forward
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LEN = 8, 4, 512
TRAIN_DATA_VOCAB = 64               # the launcher's synthetic token support
# the streamed serve: 8 requests over 4 slots, each a shared 1024-token
# prefix plus 16-200 tokens of its own, the prefix cache on, 256-token chunks
STREAM_REQUESTS, STREAM_SHARED, STREAM_TAIL = 8, 1024, (16, 200)
STREAM_CHUNK = 256
STREAM_MAX_LEN = 1280               # 1024 + 200 + 32 = 1256, in whole blocks
# the pipeline phase: LLM.from_plan over the paper's testbed (13 planned
# stages for llama2-7b), one request per slot so the ring is full, prompts
# of 16-48 tokens, 16 greedy tokens each; its microbatched forward over the
# score phase's 2 x 4096 tokens in 2 micro-batches
PIPE_PROMPT_LENS, PIPE_TOKENS, PIPE_MAX_LEN = (16, 48), 16, 64
PIPE_MICROBATCHES = 2
# the int8 matmul: the JAX kernel test's shapes (M, K, N), and llama2-7b's
# projections (K x N: q/k/v/o, gate/up, down) at a decode step of 4 slots
# and a prefill of 2 x 4096 tokens
INT8_CASES = ((128, 512, 128), (70, 300, 130), (1, 1024, 256), (256, 64, 64))
INT8_PROJ = ((4096, 4096), (4096, 11008), (11008, 4096))
INT8_M = (4, 8192)
# the bfloat16 kernel's edges: 16 rows a block up to M = 16, 128 above; K
# not a multiple of its 32-deep stage; N not a multiple of 16 (element
# loads into the tiles), or a multiple (16-byte copies with a ragged K)
INT8_EDGE = tuple((m, 4104, 4100) for m in (1, 16, 17, 130)) + (
    (1, 4104, 4096), (130, 4104, 4096))
# the JAX kernel test's _tol; float32 x sums in float64 in both the kernel and
# the plain version, bfloat16 x in float32 in the kernel
INT8_TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}

# datasheet device-memory rates (bytes/s) and dense bf16 tensor rate
MEM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12))
PEAK_BF16 = 989e12
PEAK_F32 = 67e12                    # float32 outside the tensor cores


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


def bound(n_bytes, n_ops, card, peak=PEAK_BF16):
    """The least time of a call: its bytes over the memory rate or its
    operations over the peak rate of their type, whichever is larger."""
    bytes_ms = n_bytes / mem_rate(card) * 1e3
    ops_ms = n_ops / peak * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), n_bytes=n_bytes,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


# --------------------------------------------------------------------------- #
# kernels against their plain versions
# --------------------------------------------------------------------------- #

PAGED_CASES = [
    # name, paged_case(b, h, kh, d, bs, nbs, lens, kq, seed), options
    ("llama2-7b g=1", (4, 32, 32, 128, 16, 32, (512, 300, 17, 129), 1), {}),
    ("llama2-7b g=1 KQ=4", (4, 32, 32, 128, 16, 32, (509, 300, 17, 129), 4),
     {}),
    ("qwen3-0.6b g=2 softcap", (3, 16, 8, 128, 16, 16, (40, 25, 200), 1),
     dict(softcap=30.0)),
    ("qwen3-0.6b g=2 KQ=4 softcap", (3, 16, 8, 128, 16, 16, (40, 25, 200), 4),
     dict(softcap=30.0)),
    ("llama2-70b g=8", (2, 64, 8, 128, 16, 8, (100, 1), 1), {}),
    ("llama2-70b g=8 KQ=4", (2, 64, 8, 128, 16, 8, (100, 1), 4), {}),
    ("wrapped ring + window", (1, 32, 32, 128, 16, 4, (1,), 1),
     dict(window=40)),
    ("wrapped ring + window KQ=4", (1, 64, 8, 128, 16, 4, (1,), 4),
     dict(window=40)),
    ("fully masked row", (2, 16, 8, 128, 16, 2, (20, 5), 1), {}),
    ("fully masked row KQ=4", (2, 64, 8, 128, 16, 2, (20, 5), 4), {}),
    # the table split across blocks (S > 1 on an H100's 132 SMs): splits
    # whose keys are all masked, unmapped entries inside splits (their keys'
    # positions left valid), two row chunks, a wrapped window ring whose
    # valid keys sit in one split, a fully masked row through the merge,
    # block sizes 8 and 32, the hybrid's group of 10 at D=256.  "last" and
    # "holes" are paged_case's arguments.
    ("split: 300 of 4096 keys valid, 59 of 64 splits masked",
     (1, 8, 1, 128, 16, 256, (300,), 1), {}),
    ("split: llama2-7b g=1 1024-key tables, unmapped blocks inside splits",
     (4, 32, 32, 128, 16, 64, (1000, 700, 300, 17), 1),
     dict(holes=((0, 3), (0, 21), (1, 5), (2, 9)))),
    ("split: llama2-70b g=8 KQ=4 2048-key tables, two row chunks",
     (2, 64, 8, 128, 16, 128, (2000, 900), 4), {}),
    ("split: wrapped ring + window 40, valid keys in one of 8 splits",
     (1, 10, 1, 256, 16, 32, (1,), 1), dict(window=40, last=1000)),
    ("fully masked row through the merge",
     (2, 16, 8, 128, 16, 64, (600, 5), 1), {}),
    ("split: block size 8, llama2-7b g=1",
     (4, 32, 32, 128, 8, 64, (512, 300, 17, 129), 1), {}),
    ("split: block size 32, qwen3-0.6b g=2 KQ=4 softcap",
     (3, 16, 8, 128, 32, 32, (1000, 25, 600), 4), dict(softcap=30.0)),
    (f"split: {HYBRID} g=10 D=256 window {HYBRID_WINDOW}, slot 0 wrapped",
     (4, 10, 1, 256, 16, HYBRID_WINDOW // 16, (2048, 2048, 700, 17), 1),
     dict(window=HYBRID_WINDOW, last=2130)),
]
# row i of a KQ=4 call must equal the KQ=1 call at pos + i, bit for bit
VERIFY_DECODE_CASES = ("llama2-7b g=1 KQ=4", "qwen3-0.6b g=2 KQ=4 softcap")

RING_CASES = [
    # name, ring_case(b, h, kh, d, c, valid), options
    ("llama2-7b g=1 per-row", (4, 32, 32, 128, 512, (512, 300, 17, 129)),
     {}),
    ("qwen3-0.6b g=2 per-row softcap", (3, 16, 8, 128, 256, (40, 25, 200)),
     dict(softcap=30.0)),
    ("g=8 C=700 650 valid shared", (1, 8, 1, 128, 700, 650), {}),
    ("llama2-70b g=8 C=700 per-row", (2, 64, 8, 128, 700, (650, 100)), {}),
    ("llama2-7b g=1 C=4096 per-row", (4, 32, 32, 128, 4096,
                                      (4096, 1024, 288, 17)), {}),
    ("recurrentgemma-2b g=10 D=256 C=2048 per-row, row 0 wrapped",
     (4, 10, 1, 256, HYBRID_WINDOW, (2048, 2048, 700, 17)),
     dict(window=HYBRID_WINDOW)),
    ("wrapped ring + window 50", (1, 2, 1, 32, 128, 0), dict(window=50)),
    ("fully masked row", (2, 16, 8, 128, 64, (20, 5)), {}),
    # the ring split across blocks (S > 1 on an H100's 132 SMs): splits
    # whose keys are all masked, C not a multiple of the split length, a
    # wrapped window ring whose valid keys sit in one split, a fully masked
    # row through the merge, llama2-70b's g=8 at B=1 (8 blocks unsplit)
    ("split: 300 of 1024 keys valid, 11 of 16 splits masked",
     (1, 8, 1, 128, 1024, 300), {}),
    ("split: llama2-7b g=1 C=3000 per-row (12 splits, last 184 keys)",
     (4, 32, 32, 128, 3000, (3000, 2000, 1000, 5)), {}),
    ("split: wrapped ring + window 40, valid keys in one of 8 splits",
     (1, 10, 1, 256, 512, 0), dict(window=40)),
    ("fully masked row through the merge", (2, 16, 8, 128, 1024, (600, 5)),
     {}),
    ("split: llama2-70b g=8 B=1 C=4096", (1, 64, 8, 128, 4096, 3001), {}),
]
# the ring position a case with this window has wrapped to
RING_WRAP = {50: 200, 40: 1000, HYBRID_WINDOW: 2130}


FLASH_CASES = [
    # name, (b, s, h, kh, d), options
    ("MHA", (1, 128, 4, 4, 64), {}),
    ("GQA ragged S", (2, 200, 4, 2, 64), {}),
    ("MQA D=128", (1, 384, 8, 1, 128), {}),
    ("S below a tile", (1, 96, 2, 2, 32), {}),
    *((f"window {w}{' softcap 30' if c else ''}", (1, 256, 4, 2, 64),
       dict(window=w, softcap=c)) for w in (16, 64, 128) for c in (None, 30.0)),
    # the main paths' shapes: the score phases' batch of 2, the train
    # phase's qwen3-0.6b batch (GQA group 2), and a ragged S for the hybrid
    ("llama2-7b score", (SCORE_BATCH, SCORE_LEN, 32, 32, 128), {}),
    (f"{HYBRID} score window {HYBRID_WINDOW}",
     (SCORE_BATCH, SCORE_LEN, 10, 1, 256), dict(window=HYBRID_WINDOW)),
    (f"{HYBRID} S=2500 window {HYBRID_WINDOW}",
     (SCORE_BATCH, 2500, 10, 1, 256), dict(window=HYBRID_WINDOW)),
    (f"{TRAIN_ARCH} train", (TRAIN_BATCH, TRAIN_LEN, 16, 8, 128), {}),
    # the edges of the bf16 kernel's tiles: one row, a block's last rows
    # missing, a key tile of one key, a window that ends inside a tile at
    # D=256, and q scaled by 16 so that the running max rescales often
    ("S = 1", (2, 1, 4, 2, 128), {}),
    ("S = 63", (1, 63, 8, 8, 64), {}),
    ("S = 65 D=256 window 16", (1, 65, 4, 1, 256), dict(window=16)),
    ("q x 16 window 64", (1, 300, 4, 2, 128), dict(window=64, q_scale=16.0)),
]


def to_device(case, dtype):
    out = {}
    for k, v in case.items():
        t = torch.from_numpy(np.asarray(v)).to(DEVICE)
        out[k] = t.to(dtype) if t.is_floating_point() else t
    if out["q"].dim() == 4 and out["q"].shape[1] == 1:   # q [B, H, D]
        out["q"] = out["q"][:, 0].contiguous()
    return out


def compare(name, kernel, plain, x, opts, dtype, dead=(), tol=None,
            exact=None):
    """One kernel call against its plain version; returns the largest
    error and a note of the extra checks.  ``exact``, the plain version's
    arithmetic in float64: a bfloat16 result must also lie within one bf16
    step of it."""
    tol = tol or TOL[str(dtype).split(".")[1]]
    got = kernel(**x, **opts)
    want = plain(**x, **opts)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol,
                               msg=lambda m: f"{name} {dtype}: {m}")
    extra = ""
    if exact is not None and dtype == torch.bfloat16:
        from flash_reference import bf16_steps_apart
        n = bf16_steps_apart(got, exact(**x, **opts))
        if n:
            raise AssertionError(f"{name}: {n} outputs more than one bf16 "
                                 f"step from the float64 result")
        extra = ", within one bf16 step of float64"
    for row in dead:
        if not bool((got[row] == 0).all()):
            raise AssertionError(f"{name}: masked row {row} is not exact "
                                 f"zeros")
        extra = ", masked row exact zeros"
    return got, (got.float() - want.float()).abs().max().item(), extra


def paged_inputs(i, dtype, poisoned=False):
    """PAGED_CASES[i] on the card, and its kernel options; ``poisoned``: the
    pool rows the kernel must not read set to NaN."""
    from paged_cases import paged_case, poison_unread
    name, shape, opts = PAGED_CASES[i]
    opts = dict(opts)
    case_kw = {k: opts.pop(k) for k in ("last", "holes") if k in opts}
    case_kw.setdefault("last", 150 if "window" in opts else None)
    dead = (1,) if name.startswith("fully masked") else ()
    case = paged_case(*shape, seed=100 + i, dead=dead, **case_kw)
    if poisoned:
        case = poison_unread(case, opts.get("window"))
    return to_device(case, dtype), opts, dead


def table_splits(pa, x):
    """The paged kernel's (S, L) for inputs ``x`` on this card."""
    return pa.table_split_plan(
        x["q"].shape, x["k_pool"].shape, x["key_pos"].shape[1],
        torch.cuda.get_device_properties(DEVICE).multi_processor_count)


def check_paged(pa):
    """The paged kernel over PAGED_CASES in float32 and bfloat16: against
    its plain version, bit-identical on a second call, the pool rows it
    must not read poisoned with NaN without effect (a loaded row would
    give NaN even where its key is masked); then row i of a KQ=4 call
    against the KQ=1 call at pos + i, bit for bit.  Returns the largest
    error."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for i, (name, _, _) in enumerate(PAGED_CASES):
            x, opts, dead = paged_inputs(i, dtype)
            got, err, extra = compare(name, pa.paged_attention,
                                      pa.paged_attention_plain, x, opts,
                                      dtype, dead)
            worst = max(worst, err)
            if not torch.equal(pa.paged_attention(**x, **opts), got):
                raise AssertionError(f"{name}: two calls on the same inputs "
                                     f"differ")
            bad, _, _ = paged_inputs(i, dtype, poisoned=True)
            if not torch.equal(pa.paged_attention(**bad, **opts), got):
                raise AssertionError(f"{name}: output depends on a pool row "
                                     f"that no query row may see")
            splits, split_len = table_splits(pa, x)
            print(f"kernels: paged_attention {name} {str(dtype)[6:]}: max abs "
                  f"err {err:.3g} (rtol/atol {tol['rtol']:.3g}), "
                  f"S={splits} x L={split_len}{extra}, repeat bit-identical, "
                  f"unread pool rows (scratch, unmapped, masked keys) "
                  f"poisoned with NaN without effect: never read")
        for name in VERIFY_DECODE_CASES:
            x, opts, _ = paged_inputs([n for n, _, _ in PAGED_CASES]
                                      .index(name), dtype)
            four = pa.paged_attention(**x, **opts)
            kq = x["q"].shape[1]
            for i in range(kq):
                one = pa.paged_attention(
                    x["q"][:, i].contiguous(), x["k_pool"], x["v_pool"],
                    x["bt"], x["key_pos"], x["pos"] + i, **opts)
                if not torch.equal(four[:, i], one):
                    n = int((four[:, i] != one).sum())
                    raise AssertionError(
                        f"{name} {dtype}: row {i} of the KQ={kq} call differs "
                        f"from the KQ=1 call at pos + {i} in {n} outputs")
            splits, split_len = table_splits(pa, x)
            print(f"kernels: paged_attention {name} {str(dtype)[6:]}: each "
                  f"row i of the KQ={kq} call equals the KQ=1 call at pos + "
                  f"i bit for bit (S={splits} x L={split_len} for both)")
    return worst


def ring_splits(da, x):
    """The kernel's (S, L) for ring inputs ``x`` on this card."""
    b, h, _ = x["q"].shape
    _, c, kh, _ = x["k_cache"].shape
    return da.split_plan(b, kh, h // kh, c, torch.cuda.get_device_properties(
        DEVICE).multi_processor_count)


def check_ring(da):
    """The contiguous-ring kernel over RING_CASES in float32 and bfloat16:
    against its plain version, bit-identical on a second call, masked ring
    rows never read; returns the largest error."""
    from paged_cases import ring_case
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for i, (name, shape, opts) in enumerate(RING_CASES):
            dead = (1,) if name.startswith("fully masked") else ()
            x = to_device(ring_case(*shape, seed=300 + i, dead=dead,
                                    wrap_pos=RING_WRAP.get(
                                        opts.get("window"))), dtype)
            got, err, extra = compare(name, da.decode_attention,
                                      da.decode_attention_plain, x, opts,
                                      dtype, dead)
            worst = max(worst, err)
            if not torch.equal(da.decode_attention(**x, **opts), got):
                raise AssertionError(f"{name}: two calls on the same inputs "
                                     f"differ")
            extra += ", repeat bit-identical"
            kp = x["key_pos"].expand(x["k_cache"].shape[:2])
            qpos = x["pos"].expand(kp.shape[:1])[:, None]
            masked = (kp < 0) | (kp > qpos)
            if "window" in opts:
                masked |= kp <= qpos - opts["window"]
            if masked.any():
                # masked ring rows are never read
                x["k_cache"][masked] = 1e6
                x["v_cache"][masked] = -1e6
                again = da.decode_attention(**x, **opts)
                if not torch.equal(again, got):
                    raise AssertionError(f"{name}: output depends on a "
                                         f"masked ring row")
                extra += ", masked rows never read"
            splits, split_len = ring_splits(da, x)
            print(f"kernels: decode_attention {name} {str(dtype)[6:]}: max "
                  f"abs err {err:.3g} (rtol/atol {tol['rtol']:.3g}), "
                  f"S={splits} x L={split_len}{extra}")
    return worst


def flash_inputs(b, s, h, kh, d, seed, dtype, q_scale=1.0):
    """Seeded q [B, S, H, D] (times ``q_scale``) and k, v [B, S, KH, D] on
    the card."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    x = {n: torch.randn(shape, generator=gen, device=DEVICE)
         for n, shape in (("q", (b, s, h, d)), ("k", (b, s, kh, d)),
                          ("v", (b, s, kh, d)))}
    x["q"] *= q_scale
    return {n: t.to(dtype) for n, t in x.items()}


def check_flash(fa):
    """The flash kernel against its plain version over FLASH_CASES in float32
    and bfloat16 (there also within one bf16 step of the plain version's
    arithmetic in float64, but for a scaled q, whose float32 logits put a
    few outputs of the plain version itself beyond that step: both counts
    are printed), each case called twice, bit-identical; returns the
    largest error."""
    from flash_reference import bf16_steps_apart, flash_attention_f64
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for i, (name, shape, opts) in enumerate(FLASH_CASES):
            opts = dict(opts)
            q_scale = opts.pop("q_scale", 1.0)
            x = flash_inputs(*shape, seed=700 + i, dtype=dtype,
                             q_scale=q_scale)
            got, err, extra = compare(
                name, fa.flash_attention, fa.flash_attention_plain, x, opts,
                dtype, exact=flash_attention_f64 if q_scale == 1.0 else None)
            if q_scale != 1.0 and dtype == torch.bfloat16:
                exact = flash_attention_f64(**x, **opts)
                plain = fa.flash_attention_plain(**x, **opts)
                extra = (f", beyond one bf16 step of float64: "
                         f"{bf16_steps_apart(got, exact)} outputs (the "
                         f"plain version {bf16_steps_apart(plain, exact)})")
            if not torch.equal(got, fa.flash_attention(**x, **opts)):
                raise AssertionError(f"flash_attention {name} {dtype}: a "
                                     f"second call is not bit-identical")
            worst = max(worst, err)
            print(f"kernels: flash_attention {name} {list(shape)} "
                  f"{str(dtype)[6:]}: max abs err {err:.3g} (rtol/atol "
                  f"{tol['rtol']:.3g}){extra}, a second call bit-identical")
    return worst


def scan_inputs(b, s, r, seed, h0=True):
    """Seeded scan inputs on the card: log_a = -|N(0, 1)|, b = N(0, 1)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    x = dict(log_a=-torch.randn((b, s, r), generator=gen, device=DEVICE)
             .abs(),
             b=torch.randn((b, s, r), generator=gen, device=DEVICE))
    x["h0"] = torch.randn((b, r), generator=gen, device=DEVICE) if h0 \
        else None
    return x


def check_rglru(rs):
    """The scan kernel against its plain version in float32 at the serve's
    width and a ragged one, and left-pad identity steps exact; returns the
    largest error."""
    worst = 0.0
    for i, (r, s, h0) in enumerate((r, s, h0) for r in (2560, 200)
                                   for s in (1, 7, 4096)
                                   for h0 in (True, False)):
        x = scan_inputs(4, s, r, seed=500 + i, h0=h0)
        name = f"B=4 S={s} R={r} h0={'yes' if h0 else 'none'}"
        _, err, _ = compare(name, rs.rglru_scan, rs.rglru_scan_plain, x, {},
                            torch.float32, tol=SCAN_TOL)
        worst = max(worst, err)
        print(f"kernels: rglru_scan {name}: max abs err {err:.3g} "
              f"(rtol/atol {SCAN_TOL['rtol']:.3g})")
    # a masked prefill's left pads: log_a = 0, b = 0 leave h bit for bit,
    # and the rest equals the scan of the unpadded rows from the same h0
    x = scan_inputs(4, 300, 2560, seed=520)
    pads = (0, 37, 150, 299)
    for row, p in enumerate(pads):
        x["log_a"][row, :p] = 0.0
        x["b"][row, :p] = 0.0
    _, err, _ = compare("left pads", rs.rglru_scan, rs.rglru_scan_plain, x,
                        {}, torch.float32, tol=SCAN_TOL)
    worst = max(worst, err)
    got = rs.rglru_scan(**x)
    for row, p in enumerate(pads):
        h0 = x["h0"][row:row + 1]
        rest = rs.rglru_scan(x["log_a"][row:row + 1, p:].contiguous(),
                             x["b"][row:row + 1, p:].contiguous(), h0)
        if not torch.equal(got[row, :p], h0.expand(p, -1)) \
                or not torch.equal(got[row:row + 1, p:], rest):
            raise AssertionError(f"rglru_scan: {p} left pad steps of row "
                                 f"{row} are not the identity, bit for bit")
    print(f"kernels: rglru_scan B=4 S=300 R=2560 left pads {list(pads)}: max "
          f"abs err {err:.3g}; pad steps keep h0 bit for bit and the rest "
          f"equals the unpadded scan bit for bit")
    return worst


def time_ms(fn, n_sets, iters=200, warmup=10, graph=True):
    """Device time of one call from CUDA events over ``iters`` calls,
    rotating over ``n_sets`` input sets so the caches come cold from device
    memory, as each layer's cache does on the main path.

    With ``graph`` the ``iters`` calls are captured once in a CUDA graph
    and one replay is timed, so a short call is timed on the card and not
    at the rate the host issues it.  The plain versions, which the host
    drives step by step, are timed without (``graph=False``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i % n_sets)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()

    def run():
        for i in range(iters):
            fn(i % n_sets)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        g.replay()                  # the first replay uploads the graph
        torch.cuda.synchronize()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paged_sets(kq, max_len=MAX_LEN, n_sets=4, slots=SLOTS):
    """``n_sets`` seeded bf16 inputs of paged_attention at a paged serve's
    shapes: llama2-7b, ``slots`` slots with ``max_len`` keys each, ``kq``
    query tokens per slot; by default 4 x 34 MB or more of K/V, past the
    L2."""
    from paged_cases import paged_case
    return [to_device(paged_case(slots, 32, 32, 128, BLOCK_SIZE,
                                 max_len // BLOCK_SIZE,
                                 (max_len - kq + 1,) * slots, kq,
                                 seed=200 + i), torch.bfloat16)
            for i in range(n_sets)]


def time_paged(pa, card, kq, max_len=MAX_LEN, slots=SLOTS, n_sets=4):
    """paged_attention on :func:`paged_sets`: by default the paged serve's
    4 slots x 512 keys."""
    import torch.nn.functional as F

    sets = paged_sets(kq, max_len, n_sets, slots)
    n_sets = len(sets)
    lib = []
    for x in sets:
        q4 = x["q"] if x["q"].dim() == 4 else x["q"][:, None]
        b, _, h, d = q4.shape
        read = x["bt"].clamp(min=0).long()
        kh = x["k_pool"].shape[2]
        k = x["k_pool"][read].reshape(b, -1, kh, d).transpose(1, 2)
        v = x["v_pool"][read].reshape(b, -1, kh, d).transpose(1, 2)
        qpos = x["pos"][:, None] + torch.arange(kq, device=DEVICE)
        kp = x["key_pos"][:, None]
        mask = (kp >= 0) & (kp <= qpos[..., None])           # [B, KQ, C]
        lib.append((q4.transpose(1, 2).contiguous(), k.contiguous(),
                    v.contiguous(), mask[:, None]))
    err = max(compare(f"paged_attention timing set {i} KQ={kq}",
                      pa.paged_attention, pa.paged_attention_plain, x, {},
                      torch.bfloat16)[1] for i, x in enumerate(sets))
    ms = time_ms(lambda i: pa.paged_attention(**sets[i]), n_sets)
    plain_ms = time_ms(lambda i: pa.paged_attention_plain(**sets[i]), n_sets,
                       iters=20, graph=False)
    library_ms = time_ms(
        lambda i: F.scaled_dot_product_attention(
            lib[i][0], lib[i][1], lib[i][2], attn_mask=lib[i][3]), n_sets)
    # the least work: read q, each valid key and value once, the slots'
    # key_pos, the table and pos; write the output
    x = sets[0]
    h, d = x["q"].shape[-2:]
    kh, item = x["k_pool"].shape[2], x["k_pool"].element_size()
    n_keys = int((x["key_pos"] >= 0).sum())
    n_bytes = (2 * x["q"].numel() * item + n_keys * kh * d * 2 * item
               + x["key_pos"].numel() * 4 + x["bt"].numel() * 4 + slots * 4)
    n_ops = n_keys * kq * h * 4 * d
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, splits=table_splits(pa, x),
                **bound(n_bytes, n_ops, card))


def decode_sets(n_valid, heads=(32, 32, 128), c=CONTIGUOUS_MAX_LEN,
                n_sets=3, slots=SLOTS):
    """``n_sets`` seeded bf16 inputs of decode_attention at a contiguous
    serve's shapes: ``slots`` slots with a ``c``-key ring each, ``n_valid``
    keys filled; by default 4 slots, llama2-7b's heads (H, KH, D) and
    4096-key ring."""
    from paged_cases import ring_case
    h, kh, d = heads
    return [to_device(ring_case(slots, h, kh, d, c, (n_valid,) * slots,
                                seed=400 + i), torch.bfloat16)
            for i in range(n_sets)]


def time_decode(da, card, n_valid, heads=(32, 32, 128),
                c=CONTIGUOUS_MAX_LEN, n_sets=3, slots=SLOTS):
    """decode_attention on :func:`decode_sets`; ``n_sets`` input sets
    together exceed the L2."""
    import torch.nn.functional as F

    h, kh, d = heads
    sets = decode_sets(n_valid, heads, c, n_sets, slots)
    lib = []
    for x in sets:
        kp = x["key_pos"]
        mask = (kp >= 0) & (kp <= x["pos"][:, None])             # [B, C]
        lib.append((x["q"][:, :, None], x["k_cache"].transpose(1, 2)
                    .contiguous(), x["v_cache"].transpose(1, 2).contiguous(),
                    mask[:, None, None]))
    err = max(compare(f"decode_attention timing set {i} {n_valid} keys "
                      f"H={h} KH={kh} D={d}", da.decode_attention,
                      da.decode_attention_plain, x, {}, torch.bfloat16)[1]
              for i, x in enumerate(sets))
    ms = time_ms(lambda i: da.decode_attention(**sets[i]), n_sets)
    plain_ms = time_ms(lambda i: da.decode_attention_plain(**sets[i]),
                       n_sets, iters=20, graph=False)
    library_ms = time_ms(
        lambda i: F.scaled_dot_product_attention(
            lib[i][0], lib[i][1], lib[i][2], attn_mask=lib[i][3],
            enable_gqa=kh != h), n_sets)
    # the least work: read q, each valid key and value once and key_pos;
    # write the output
    x = sets[0]
    b, h, d = x["q"].shape
    kh, item = x["k_cache"].shape[2], x["k_cache"].element_size()
    n_keys = int((x["key_pos"] >= 0).sum())
    n_bytes = (2 * x["q"].numel() * item + n_keys * kh * d * 2 * item
               + x["key_pos"].numel() * 4 + b * 4)
    n_ops = n_keys * h * 4 * d
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, splits=ring_splits(da, x),
                **bound(n_bytes, n_ops, card))


def time_rglru(rs, card, s):
    """rglru_scan at the hybrid serve's wave: 4 slots x ``s`` steps x
    R = 2560, float32.  No PyTorch call computes a linear recurrence, so
    there is no library time."""
    b, r = SLOTS, 2560
    n_sets = max(1, -(-200_000_000 // (3 * b * s * r * 4)))   # past the L2
    sets = [scan_inputs(b, s, r, seed=600 + i) for i in range(n_sets)]
    err = max(compare(f"rglru_scan timing set {i} S={s}", rs.rglru_scan,
                      rs.rglru_scan_plain, x, {}, torch.float32,
                      tol=SCAN_TOL)[1] for i, x in enumerate(sets))
    ms = time_ms(lambda i: rs.rglru_scan(**sets[i]), n_sets, iters=50)
    plain_ms = time_ms(lambda i: rs.rglru_scan_plain(**sets[i]), n_sets,
                       iters=2, warmup=1, graph=False)
    # the least work: read log_a, b and h0 once, write h; exp, * and + per
    # element
    n_bytes = (3 * b * s * r + b * r) * 4
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bound(n_bytes, 3 * b * s * r, card, PEAK_F32))


def flash_sets(b, s, heads, n_sets):
    """``n_sets`` seeded bf16 input sets of flash_attention at [B, S] and
    heads (H, KH, D)."""
    h, kh, d = heads
    return [flash_inputs(b, s, h, kh, d, seed=800 + i, dtype=torch.bfloat16)
            for i in range(n_sets)]


def time_flash(fa, card, heads=(32, 32, 128), window=None, n_sets=2, b=1,
               s=SCORE_LEN):
    """flash_attention in bf16 at [B, S] tokens, by default a score phase's
    shape per sequence (1 x 4096) and llama2-7b's heads (H, KH, D), causal.
    ``n_sets`` input sets together exceed the L2."""
    import torch.nn.functional as F
    from flash_reference import flash_attention_f64
    h, kh, d = heads
    sets = flash_sets(b, s, heads, n_sets)
    err = max(compare(f"flash_attention timing set {i} H={h} KH={kh} D={d}",
                      fa.flash_attention, fa.flash_attention_plain, x,
                      dict(window=window), torch.bfloat16,
                      exact=flash_attention_f64)[1]
              for i, x in enumerate(sets))
    lib = [{n: t.transpose(1, 2).contiguous() for n, t in x.items()}
           for x in sets]
    pos = torch.arange(s, device=DEVICE)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    ms = time_ms(lambda i: fa.flash_attention(**sets[i], window=window),
                 n_sets, iters=20, warmup=2)
    plain_ms = time_ms(
        lambda i: fa.flash_attention_plain(**sets[i], window=window), n_sets,
        iters=3, warmup=1, graph=False)
    # causal: sdpa's own causal mask; with a window: the boolean mask
    library_ms = time_ms(lambda i: F.scaled_dot_product_attention(
        lib[i]["q"], lib[i]["k"], lib[i]["v"],
        attn_mask=None if window is None else mask, is_causal=window is None,
        enable_gqa=True), n_sets, iters=20, warmup=2)
    # the least work: read q, k, v once and write the output; 4 D flops per
    # visible (query, key) pair and head, the pairs this mask shows
    x = sets[0]
    n_bytes = sum(t.numel() * t.element_size() for t in x.values()) \
        + x["q"].numel() * x["q"].element_size()
    n_pairs = int(mask.sum())
    plan = fa.tile_plan(s, window, d)
    masked = sum(len(t.masked) for t in plan.tiles)
    walked = sum(t.last - t.first + 1 for t in plan.tiles)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, tiles=(masked, walked - masked),
                tile_shape=(plan.rows, plan.keys),
                **bound(n_bytes, 4 * b * h * d * n_pairs, card))


def int8_inputs(i8, m, k, n, dtype, seed, lead=()):
    """Seeded x [*lead, m, k] in ``dtype`` and a quantized w [k, n] (N(0, 1)
    before quantization) on the card."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    x = torch.randn((*lead, m, k), generator=gen, device=DEVICE).to(dtype)
    w_q, scale = i8.quantize_int8(
        torch.randn((k, n), generator=gen, device=DEVICE))
    return dict(x=x, w_q=w_q, scale=scale)


def int8_repeat(i8, name, x, got):
    """bfloat16 only: a second call on the same inputs must give ``got``'s
    bits; returns how many outputs lie more than one bf16 step from the
    plain version's (reported, not gated beyond the 2e-2 tolerance: sums of
    thousands of terms in another order may land a near-zero output further
    off)."""
    from flash_reference import bf16_steps_apart
    again = i8.int8_matmul(**x)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"int8_matmul {name}: a second call on the same "
                             f"inputs gave other bits")
    return bf16_steps_apart(got, i8.int8_matmul_plain(**x))


def check_int8(i8):
    """The int8 kernel against its plain version in float32 and bfloat16:
    the JAX test's shapes, leading dimensions, llama2-7b's projections at
    M = 4 and 8192, and the bfloat16 kernel's edges (``INT8_EDGE``); in
    bfloat16 each call is repeated (bit-identical) and its outputs beyond
    one bf16 step of the plain version counted.  Returns the largest
    error."""
    worst = 0.0
    cases = [(f"{m}x{k}x{n}", (m, k, n), ()) for m, k, n in INT8_CASES]
    cases.append(("leading dims [2, 3, 64] x 64x32", (3, 64, 32), (2,)))
    cases += [(f"llama2-7b M={m} {k}x{n}", (m, k, n), ())
              for m in INT8_M for k, n in INT8_PROJ]
    cases += [(f"edge {m}x{k}x{n}", (m, k, n), ()) for m, k, n in INT8_EDGE]
    for dtype in (torch.float32, torch.bfloat16):
        tol = INT8_TOL[str(dtype)[6:]]
        for i, (name, shape, lead) in enumerate(cases):
            x = int8_inputs(i8, *shape, dtype, seed=900 + i, lead=lead)
            got, err, _ = compare(name, i8.int8_matmul, i8.int8_matmul_plain,
                                  x, {}, dtype, tol=tol)
            if got.shape != (*lead, shape[0], shape[2]):
                raise AssertionError(f"int8_matmul {name}: shape "
                                     f"{tuple(got.shape)}")
            worst = max(worst, err)
            extra = ""
            if dtype == torch.bfloat16:
                beyond = int8_repeat(i8, name, x, got)
                extra = (f"; repeat bit-identical; {beyond} of {got.numel()} "
                         f"outputs beyond one bf16 step of the plain version")
            print(f"kernels: int8_matmul {name} {str(dtype)[6:]}: max abs "
                  f"err {err:.3g} (rtol/atol {tol['rtol']:.3g}){extra}")
        del x, got
        torch.cuda.empty_cache()
    return worst


def time_int8(i8, card, m, k, n, dtype):
    """int8_matmul at one of llama2-7b's projections, x [m, k] in
    ``dtype``; the library call is one ``torch.matmul`` on the weight
    dequantized once to x's dtype (TF32 off)."""
    item = torch.tensor([], dtype=dtype).element_size()
    set_bytes = k * n + m * k * item
    n_sets = max(1, -(-100_000_000 // set_bytes))             # past the L2
    sets = [int8_inputs(i8, m, k, n, dtype, seed=950 + i)
            for i in range(n_sets)]
    tol = INT8_TOL[str(dtype)[6:]]
    err = max(compare(f"int8_matmul timing set {i} M={m} {k}x{n}",
                      i8.int8_matmul, i8.int8_matmul_plain, x, {}, dtype,
                      tol=tol)[1] for i, x in enumerate(sets))
    deq = [(x["w_q"].float() * x["scale"]).to(dtype) for x in sets]
    f32_outside = None
    if dtype == torch.float32:
        # why float32 x sums in float64: the float32 product summed in
        # float32 by cuBLAS, against the plain version's exact sum
        x = sets[0]
        want = i8.int8_matmul_plain(**x)
        f32 = (x["x"] @ x["w_q"].float()) * x["scale"]
        f32_outside = int(((f32 - want).abs() > tol["atol"]
                           + tol["rtol"] * want.abs()).sum())
        del want, f32
    bf16_beyond = None
    if dtype == torch.bfloat16:
        bf16_beyond = int8_repeat(i8, f"timing M={m} {k}x{n}", sets[0],
                                  i8.int8_matmul(**sets[0]))
    big = m * k * n > 1e11
    iters = (3 if dtype == torch.float32 else 10) if big else 200
    ms = time_ms(lambda i: i8.int8_matmul(**sets[i]), n_sets, iters=iters,
                 warmup=2 if big else 10)
    plain_ms = time_ms(lambda i: i8.int8_matmul_plain(**sets[i]), n_sets,
                       iters=3 if big else 20, warmup=1, graph=False)
    library_ms = time_ms(lambda i: torch.matmul(sets[i]["x"], deq[i]),
                         n_sets, iters=iters, warmup=2 if big else 10)
    # the least work: read x, w_q and scale once and write y; 2 M K N
    # operations of x's type
    n_bytes = m * k * item + k * n + n * 4 + m * n * item
    peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16
    del sets, deq
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, f32_outside=f32_outside,
                bf16_beyond=bf16_beyond,
                **bound(n_bytes, 2 * m * k * n, card, peak))


def int8_path(i8, wrappers, card):
    """The op's entry point as its users call it: one llama2-7b layer's
    seven projections quantized (weights N(0, 1/K) from SEED), applied in
    bf16 to a decode step of 4 slots ([4, 1, 4096]) and to a prefill of
    2 x 4096 tokens ([2, 4096, 4096]): q, k and v from x, o from q, and the
    SwiGLU MLP down(silu(gate(x)) * up(x)).  Each run starts with the count
    at 0 and must launch the kernel once per projection; its output equals
    the same chain through the plain version.  Returns the launches of each
    run."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    names = (("wq", 4096, 4096), ("wk", 4096, 4096), ("wv", 4096, 4096),
             ("wo", 4096, 4096), ("w_gate", 4096, 11008),
             ("w_up", 4096, 11008), ("w_down", 11008, 4096))
    w = {n: i8.quantize_int8(torch.randn((k, c), generator=gen,
                                         device=DEVICE) / k ** 0.5)
         for n, k, c in names}

    def layer(mm, x):
        q, k, v = (mm(x, *w[n]) for n in ("wq", "wk", "wv"))
        o = mm(q, *w["wo"])
        mlp = mm(torch.nn.functional.silu(mm(x, *w["w_gate"]))
                 * mm(x, *w["w_up"]), *w["w_down"])
        return torch.stack([k.float(), v.float(), o.float(), mlp.float()])

    launches = {}
    for what, shape in (("decode", (SLOTS, 1, 4096)),
                        ("prefill", (SCORE_BATCH, SCORE_LEN, 4096))):
        x = torch.randn(shape, generator=gen, device=DEVICE).bfloat16()
        for fn in wrappers.values():
            fn.launches = 0
        got = layer(i8.int8_matmul, x)
        torch.cuda.synchronize()
        counts = {n: fn.launches for n, fn in wrappers.items()}
        launches[what] = counts.pop("int8_matmul")
        want = layer(i8.int8_matmul_plain, x)
        if launches[what] != len(names) or any(counts.values()) \
                or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"int8 path {what}: {launches[what]} "
                                 f"launches for {len(names)} projections, "
                                 f"others {counts}")
        torch.testing.assert_close(got, want, **INT8_TOL["bfloat16"],
                                   msg=lambda m: f"int8 path {what}: {m}")
        err = (got - want).abs().max().item()
        print(f"int8 path {what}: llama2-7b layer projections on x "
              f"{list(shape)} bf16 through the op: int8_matmul launches "
              f"{launches[what]} = {len(names)} projections; q/k/v/o and "
              f"MLP outputs against the plain chain max abs diff {err:.3g} "
              f"(rtol/atol {INT8_TOL['bfloat16']['rtol']}) [{card}]")
    return launches


def timing_line(name, shape, t, card):
    lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
    print(f"kernels: {name} at {shape}: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, library {lib}, bound "
          f"{t['bound_ms']:.4f} ms ({t['n_bytes'] / 1e6:.2f} MB by "
          f"{t['bound_by']}), max abs err {t['max_abs_err']:.3g} [{card}]")
    if "tiles" in t:
        print(f"kernels: {name} at {shape}: blocks of {t['tile_shape'][0]} "
              f"rows walk {t['tiles'][0]} masked and {t['tiles'][1]} "
              f"unmasked key tiles of {t['tile_shape'][1]}")
    if "splits" in t:
        print(f"kernels: {name} at {shape}: each slot's keys split "
              f"S={t['splits'][0]} ways of L={t['splits'][1]} keys")
    if t.get("bf16_beyond") is not None:
        print(f"kernels: {name} at {shape}: repeat bit-identical; "
              f"{t['bf16_beyond']} outputs beyond one bf16 step of the plain "
              f"version")
    if t.get("f32_outside") is not None:
        print(f"kernels: {name} at {shape}: a float32-summed cuBLAS product "
              f"has {t['f32_outside']} outputs outside rtol/atol 3e-5 of the "
              f"exact sum")


# --------------------------------------------------------------------------- #
# serve
# --------------------------------------------------------------------------- #

class StepClock:
    """Host-clock times of a backend's prefill, prefill_chunk, decode and
    verify calls that have work (the scheduler may pass no feeds).  Each
    call ends in the logits readback, which waits for the card.
    ``verify_kq`` records the query tokens per slot of each verify call and
    ``verify_slots`` the slots it verified."""

    def __init__(self, backend):
        self.prefill_ms, self.decode_ms, self.verify_ms = [], [], []
        self.chunk_ms = []
        self.verify_kq, self.verify_slots = [], []
        for name, log in (("prefill", self.prefill_ms),
                          ("decode_step", self.decode_ms),
                          ("verify_step", self.verify_ms),
                          ("prefill_chunk", self.chunk_ms)):
            setattr(backend, name, self._timed(getattr(backend, name), log,
                                               name == "verify_step"))

    def _timed(self, fn, log, verify):
        def call(*args, **kw):
            if not len(args[0]):        # an empty quantum runs nothing
                return fn(*args, **kw)
            if verify:
                self.verify_kq.append(max(len(f) for f in args[0].values()))
                self.verify_slots.append(len(args[0]))
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            log.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def reset(self):
        for log in (self.prefill_ms, self.decode_ms, self.verify_ms,
                    self.chunk_ms, self.verify_kq, self.verify_slots):
            log.clear()

    def summary(self, what="decode"):
        ms = self.verify_ms if what == "verify" else self.decode_ms
        return (f"prefill ms per wave {[round(t, 3) for t in self.prefill_ms]}"
                f", {what} ms per step median {statistics.median(ms):.3f} "
                f"(min {min(ms):.3f}, max {max(ms):.3f})")


def waves(prompts, slots=SLOTS):
    """The requests in waves of ``slots``, left-padded per wave."""
    for w in range(0, len(prompts), slots):
        wave = list(range(w, min(w + slots, len(prompts))))
        width = max(len(prompts[i]) for i in wave)
        padded = np.zeros((len(wave), width), np.int32)
        for j, i in enumerate(wave):
            padded[j, width - len(prompts[i]):] = prompts[i]
        yield wave, padded, [len(prompts[i]) for i in wave]


def teacher_forced(backend, prompts, tokens, n_slots=SLOTS,
                   n_tokens=MAX_TOKENS, first=False):
    """Decode logits [n_req, n_tokens - 1, V] with each request's own
    generated tokens fed back, in waves of ``n_slots``; with ``first``,
    [n_req, n_tokens, V]: the prefill's logits (those that chose each
    request's first token) ahead of them."""
    rows = []
    for wave, padded, lens in waves(prompts, n_slots):
        slots = list(range(len(wave)))
        evs = {ev.slot: ev.logits
               for ev in backend.prefill(slots, padded, lens)}
        steps = [np.stack([evs[s] for s in slots])] if first else []
        for t in range(n_tokens - 1):
            evs = backend.decode_step({s: tokens[i][t]
                                       for s, i in zip(slots, wave)})
            steps.append(np.stack([ev.logits for ev in evs]))
        rows.append(np.stack(steps, axis=1))
        for s in slots:
            backend.free_slot(s)
    return np.concatenate(rows)


def teacher_forced_verify(backend, prompts, tokens):
    """Verify logits [n_req, MAX_TOKENS, V]: each request's own tokens fed
    ``SPEC_K`` at a time through ``verify_step``, all accepted."""
    rows = []
    for wave, padded, lens in waves(prompts):
        slots = list(range(len(wave)))
        backend.prefill(slots, padded, lens)
        steps = []
        for t in range(0, MAX_TOKENS, SPEC_K):
            evs = backend.verify_step({
                s: np.asarray(tokens[i][t:t + SPEC_K], np.int32)
                for s, i in zip(slots, wave)})
            backend.accept({ev.slot: len(ev.logits) for ev in evs})
            steps.append(np.stack([ev.logits for ev in evs]))
        rows.append(np.concatenate(steps, axis=1))
        for s in slots:
            backend.free_slot(s)
    return np.concatenate(rows)


def compare_logits(what, got, card, sides=("cuda", "ref")):
    """``got`` maps each of the two ``sides`` to logits of one shape; the
    first must be finite and within ``LOGITS_ATOL`` of the second."""
    (name_a, name_b), (a, b) = sides, (got[k] for k in sides)
    diff = np.abs(a - b)
    if not np.isfinite(a).all() or diff.max() > LOGITS_ATOL:
        raise AssertionError(f"{what} logits {name_a} vs {name_b}: max abs "
                             f"diff {diff.max():.4g} > {LOGITS_ATOL}")
    agree = int((a.argmax(-1) == b.argmax(-1)).sum())
    print(f"serve: teacher-forced {what} logits {list(a.shape)}, "
          f"{name_a} vs {name_b} max abs diff {diff.max():.4g} (mean "
          f"{diff.mean():.3g}, |logits| max {np.abs(b).max():.3g}; "
          f"atol {LOGITS_ATOL}), argmax agreement "
          f"{agree}/{diff.shape[0] * diff.shape[1]} [{card}]")


def run_requests(llm, prompts, sp):
    """Serve every prompt through the stepping API, request i under uid i
    (the oracle draft's keys); returns the outputs in prompt order."""
    for uid, prompt in enumerate(prompts):
        llm.submit(prompt, sp, uid=uid)
    while llm.has_work:
        llm.step()
    outs = [llm.poll(uid) for uid in range(len(prompts))]
    for o in outs:
        if o.n_generated != sp.max_tokens or o.finish_reason != "length":
            raise AssertionError(f"request {o.uid}: {o.n_generated} tokens, "
                                 f"{o.finish_reason}")
    return outs


class Model:
    """A model at full width and depth with random weights from SEED (by
    default llama2-7b), and its six requests."""

    def __init__(self, arch=ARCH, prompt_lens=PROMPT_LENS):
        from repro_torch.bridge import init_params
        from repro_torch.configs import get_config
        self.cfg = get_config(arch)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(SEED)
        t0 = time.perf_counter()
        self.params = init_params(self.cfg, gen, DEVICE)
        torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0
        rng = np.random.default_rng(SEED)
        self.prompts = [rng.integers(0, self.cfg.vocab_size, n)
                        .astype(np.int32) for n in prompt_lens]

    def backend(self, impl, layout="paged", max_len=MAX_LEN,
                prefix_cache=False, n_slots=SLOTS):
        from repro_torch.runtime import TensorBackend
        be = TensorBackend(self.cfg, self.params, n_slots=n_slots,
                           max_len=max_len, impl=impl, cache_layout=layout,
                           block_size=BLOCK_SIZE, device=DEVICE,
                           prefix_cache=prefix_cache)
        if be.info.attn_impl != impl:
            raise AssertionError(f"backend reports attn_impl="
                                 f"{be.info.attn_impl}, asked for {impl}")
        return be


def serve_paged(model, pa, card):
    """The paged layout with plain decode."""
    from repro_torch.serving import LLM, SamplingParams
    cfg = model.cfg
    be = model.backend("cuda")
    print(f"serve: {ARCH} {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{be.info.param_bytes / 1e9:.2f} GB of {cfg.dtype} weights from "
          f"seed {SEED} in {model.init_s:.1f} s")
    clock = StepClock(be)
    llm = LLM.from_backend(be, seed=SEED)
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    llm.generate([model.prompts[0][:16]], SamplingParams(max_tokens=4))

    clock.reset()
    pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    outs = llm.generate(model.prompts, sp)
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
    print(f"serve paged: {len(outs)} requests {list(PROMPT_LENS)} prompt "
          f"tokens x {MAX_TOKENS} greedy tokens over {SLOTS} slots: "
          f"{len(clock.prefill_ms)} prefills, {steps} decode steps, "
          f"paged_attention launches {launches} = {cfg.n_layers} layers x "
          f"{steps} steps, {llm.stats.preemptions} preemptions")
    print(f"serve paged: {clock.summary()}, {total / wall:.1f} tokens/s over "
          f"{wall:.2f} s [{card}]")
    device_share("serve paged", f"{SLOTS} requests x 8 tokens",
                 lambda: llm.generate(model.prompts[:SLOTS],
                                      SamplingParams(max_tokens=8)), card)
    del llm, be, clock
    torch.cuda.empty_cache()

    tokens = [o.tokens for o in outs]
    got = {}
    for impl in ("cuda", "ref"):
        got[impl] = teacher_forced(model.backend(impl), model.prompts, tokens)
        torch.cuda.empty_cache()
    compare_logits("paged decode", got, card)
    return dict(launches=launches, tokens=tokens)


def serve_contiguous(model, pa, da, card, paged_tokens):
    """The default layout: one 4096-key ring per slot and layer."""
    from repro_torch.serving import LLM, SamplingParams
    cfg = model.cfg
    be = model.backend("cuda", "contiguous", CONTIGUOUS_MAX_LEN)
    print(f"serve contiguous: max_len {CONTIGUOUS_MAX_LEN}, "
          f"{be.info.cache_bytes / 2 ** 30:.2f} GiB of rings")
    clock = StepClock(be)
    llm = LLM.from_backend(be, seed=SEED)
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    llm.generate([model.prompts[0][:16]], SamplingParams(max_tokens=4))

    clock.reset()
    da.decode_attention.launches = 0
    pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    outs = llm.generate(model.prompts, sp)
    wall = time.perf_counter() - t0
    launches = da.decode_attention.launches
    steps = len(clock.decode_ms)
    if launches != cfg.n_layers * steps or launches == 0 \
            or pa.paged_attention.launches != 0:
        raise AssertionError(f"decode_attention launched {launches} times "
                             f"and paged_attention "
                             f"{pa.paged_attention.launches} over {steps} "
                             f"decode steps of {cfg.n_layers} layers")
    tokens = [o.tokens for o in outs]
    for o in outs:
        if o.n_generated != MAX_TOKENS or o.finish_reason != "length":
            raise AssertionError(f"request {o.uid}: {o.n_generated} tokens, "
                                 f"{o.finish_reason}")
    same = sum(int(a == b) for t, u in zip(tokens, paged_tokens)
               for a, b in zip(t, u))
    total = sum(o.n_generated for o in outs)
    print(f"serve contiguous: {len(outs)} requests x {MAX_TOKENS} greedy "
          f"tokens over {SLOTS} slots: {len(clock.prefill_ms)} prefills, "
          f"{steps} decode steps, decode_attention launches {launches} = "
          f"{cfg.n_layers} layers x {steps} steps, paged_attention 0; "
          f"greedy tokens equal to the paged serve's: {same}/{total}")
    print(f"serve contiguous: {clock.summary()}, {total / wall:.1f} tokens/s "
          f"over {wall:.2f} s [{card}]")
    device_share("serve contiguous", f"{SLOTS} requests x 8 tokens",
                 lambda: llm.generate(model.prompts[:SLOTS],
                                      SamplingParams(max_tokens=8)), card)
    del llm, be, clock
    torch.cuda.empty_cache()

    got = {}
    for impl in ("cuda", "ref"):
        got[impl] = teacher_forced(
            model.backend(impl, "contiguous", CONTIGUOUS_MAX_LEN),
            model.prompts, tokens)
        torch.cuda.empty_cache()
    compare_logits("contiguous decode", got, card)
    return dict(launches=launches)


def serve_spec(model, pa, da, card, paged_tokens):
    """Paged layout with speculative decoding: ``SPEC_K`` tokens per verify
    step from an oracle of the paged serve's tokens, corrupted at
    ``1 - ACCEPT_PROB`` per token."""
    from repro_torch.serving import LLM, SamplingParams
    from repro_torch.serving.spec import OracleDraft
    cfg = model.cfg
    be = model.backend("cuda")
    if not be.info.spec_decode:
        raise AssertionError("the paged backend reports spec_decode=False")
    clock = StepClock(be)
    sp = SamplingParams(max_tokens=MAX_TOKENS)

    def llm():
        oracle = OracleDraft(dict(enumerate(paged_tokens)),
                             accept_prob=ACCEPT_PROB, seed=SEED,
                             vocab_size=cfg.vocab_size)
        return LLM.from_backend(be, seed=SEED, spec_k=SPEC_K, draft=oracle)

    run_requests(llm(), model.prompts[:1], SamplingParams(max_tokens=4))
    clock.reset()
    spec = llm()
    pa.paged_attention.launches = 0
    da.decode_attention.launches = 0
    t0 = time.perf_counter()
    outs = run_requests(spec, model.prompts, sp)
    wall = time.perf_counter() - t0
    launches = pa.paged_attention.launches
    steps = len(clock.verify_ms)
    at_k = sum(int(kq == SPEC_K) for kq in clock.verify_kq)
    if launches != cfg.n_layers * steps or not at_k or clock.decode_ms \
            or da.decode_attention.launches:
        raise AssertionError(f"paged_attention launched {launches} times over "
                             f"{steps} verify steps ({at_k} at KQ={SPEC_K}) "
                             f"and {len(clock.decode_ms)} decode steps of "
                             f"{cfg.n_layers} layers")
    st = spec.stats
    if not 0 < st.spec_accepted < st.spec_drafted:
        raise AssertionError(f"spec: {st.spec_accepted} of {st.spec_drafted} "
                             f"drafts accepted: no rollback ran")
    tokens = [o.tokens for o in outs]
    same = sum(int(a == b) for t, u in zip(tokens, paged_tokens)
               for a, b in zip(t, u))
    total = sum(o.n_generated for o in outs)
    print(f"serve spec: {len(outs)} requests x {MAX_TOKENS} greedy tokens, "
          f"spec_k {SPEC_K}, oracle accept_prob {ACCEPT_PROB}: {steps} verify "
          f"steps ({at_k} at KQ={SPEC_K}), paged_attention launches "
          f"{launches} = {cfg.n_layers} layers x {steps} steps; drafts "
          f"accepted {st.spec_accepted}/{st.spec_drafted} "
          f"({st.spec_accepted / st.spec_drafted:.1%}), "
          f"{(total - len(outs)) / sum(clock.verify_slots):.2f} tokens per "
          f"slot and verify step (the first token of each request comes "
          f"from its prefill); greedy tokens equal to the paged serve's: "
          f"{same}/{total}")
    print(f"serve spec: {clock.summary('verify')}, {total / wall:.1f} "
          f"tokens/s over {wall:.2f} s [{card}]")
    del spec, be, clock
    torch.cuda.empty_cache()

    got = {}
    for impl in ("cuda", "ref"):
        got[impl] = teacher_forced_verify(model.backend(impl), model.prompts,
                                          tokens)
        torch.cuda.empty_cache()
    compare_logits(f"verify (KQ={SPEC_K})", got, card)
    return dict(launches=launches)


class FirstLogits:
    """The first-token logits of each request, keyed by its prompt's
    tokens, from a backend's monolithic prefill or its streamed admission
    (``start_stream`` says whether the prompt hit the prefix cache)."""

    def __init__(self, backend):
        self.logits, self.hit, self._slot = {}, {}, {}
        prefill, start = backend.prefill, backend.start_stream
        chunk = backend.prefill_chunk

        def prefill_(slots, prompts, prompt_lens=None):
            evs = prefill(slots, prompts, prompt_lens)
            w = prompts.shape[1]
            for i, ev in enumerate(evs):
                n = w if prompt_lens is None else int(prompt_lens[i])
                self.logits[self.key(prompts[i, w - n:])] = ev.logits
            return evs

        def start_(slot, prompt):
            got = start(slot, prompt)
            self._slot[slot] = self.key(prompt)
            self.hit[self._slot[slot]] = got > 0
            return got

        def chunk_(slots, chunks, chunk_lens, starts, last):
            evs = chunk(slots, chunks, chunk_lens, starts, last)
            for ev in evs:
                self.logits[self._slot[ev.slot]] = ev.logits
            return evs
        backend.prefill, backend.start_stream = prefill_, start_
        backend.prefill_chunk = chunk_

    @staticmethod
    def key(prompt):
        return np.asarray(prompt, np.int32).tobytes()


def stream_prompts(cfg):
    """``STREAM_REQUESTS`` prompts from SEED + 1: one shared
    ``STREAM_SHARED``-token prefix, then 16-200 seeded tokens of each
    request's own."""
    rng = np.random.default_rng(SEED + 1)
    shared = rng.integers(0, cfg.vocab_size, STREAM_SHARED)
    tails = rng.integers(STREAM_TAIL[0], STREAM_TAIL[1] + 1, STREAM_REQUESTS)
    return [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)])
            .astype(np.int32) for n in tails]


def serve_streamed(model, wrappers, card):
    """Streamed admission on the paged layout: the prefix cache on and
    ``STREAM_CHUNK``-token chunks.  The first four requests miss and
    register the shared prefix, the next four adopt it; decode steps read
    the pool with the paged kernel, chunks by gather.  The first-token
    logits of every request agree with the monolithic paged serve's."""
    from repro_torch.serving import LLM, SamplingParams
    cfg = model.cfg
    prompts = stream_prompts(cfg)
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    firsts, outs = {}, {}
    for mode in ("monolithic", "streamed"):
        streamed = mode == "streamed"
        be = model.backend("cuda", "paged", STREAM_MAX_LEN,
                           prefix_cache=streamed)
        if streamed and not (be.info.prefix_caching
                             and be.info.supports_extend):
            raise AssertionError(f"the paged backend reports {be.info}")
        llm = LLM.from_backend(be, seed=SEED,
                               prefill_chunk=STREAM_CHUNK if streamed
                               else None)
        # warm up on a prompt that shares no block with the measured ones
        warm = np.random.default_rng(SEED + 2).integers(
            0, cfg.vocab_size, 40).astype(np.int32)
        llm.generate([warm], SamplingParams(max_tokens=4))
        clock = StepClock(be)
        first = FirstLogits(be)
        before = llm.stats.prefix_hits, llm.stats.prefix_hit_tokens
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        outs[mode] = llm.generate(prompts, sp)
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in wrappers.items()}
        firsts[mode] = dict(first.logits)
        hits = llm.stats.prefix_hits - before[0]
        hit_tokens = llm.stats.prefix_hit_tokens - before[1]
        steps = len(clock.decode_ms)
        for o in outs[mode]:
            if o.n_generated != MAX_TOKENS or o.finish_reason != "length":
                raise AssertionError(f"{mode} request {o.uid}: "
                                     f"{o.n_generated} tokens, "
                                     f"{o.finish_reason}")
        paged = launches.pop("paged_attention")
        if paged != cfg.n_layers * steps or not steps \
                or any(launches.values()):
            raise AssertionError(f"serve {mode}: paged_attention {paged} "
                                 f"launches over {steps} decode steps of "
                                 f"{cfg.n_layers} layers, other kernels "
                                 f"{launches}")
        total = sum(o.n_generated for o in outs[mode])
        if streamed:
            if hits < STREAM_REQUESTS - SLOTS or not clock.chunk_ms \
                    or clock.prefill_ms:
                raise AssertionError(f"serve streamed: {hits} prefix hits, "
                                     f"{len(clock.chunk_ms)} chunk calls, "
                                     f"{len(clock.prefill_ms)} prefills")
            ttft = {True: [], False: []}
            admit = {True: [], False: []}
            for o in outs[mode]:
                hit = first.hit[first.key(o.prompt)]
                ttft[hit].append(o.timing.ttft_s * 1e3)
                admit[hit].append((o.timing.first_token_s
                                   - o.timing.admitted_s) * 1e3)
            chunk = clock.chunk_ms
            print(f"serve streamed: {STREAM_REQUESTS} requests, a shared "
                  f"{STREAM_SHARED}-token prefix + {STREAM_TAIL[0]}-"
                  f"{STREAM_TAIL[1]} own tokens ({[o.n_prompt for o in outs[mode]]}"
                  f") x {MAX_TOKENS} greedy tokens over {SLOTS} slots, "
                  f"prefix cache on, chunks of {STREAM_CHUNK}: prefix hits "
                  f"{hits} (>= {STREAM_REQUESTS - SLOTS}), prefix_hit_tokens "
                  f"{hit_tokens}; {len(chunk)} prefill_chunk calls, "
                  f"{llm.stats.prefill_chunks} chunk passes, {steps} decode "
                  f"steps, paged_attention launches {paged} = "
                  f"{cfg.n_layers} layers x {steps} steps")
            print(f"serve streamed: prefill_chunk ms per call median "
                  f"{statistics.median(chunk):.3f} (min {min(chunk):.3f}, "
                  f"max {max(chunk):.3f}); decode ms per step median "
                  f"{statistics.median(clock.decode_ms):.3f}; time to first "
                  f"token, miss requests ({len(ttft[False])}) median "
                  f"{statistics.median(ttft[False]):.1f} ms (admission to "
                  f"first token {statistics.median(admit[False]):.1f}), hit "
                  f"requests ({len(ttft[True])}) median "
                  f"{statistics.median(ttft[True]):.1f} ms (admission to "
                  f"first token {statistics.median(admit[True]):.1f}); "
                  f"{total / wall:.1f} tokens/s over {wall:.2f} s [{card}]")
            # four more requests that hit: one chunk and 8 decode steps each
            device_share("serve streamed", f"{SLOTS} hit requests x 8 tokens",
                         lambda: llm.generate(prompts[:SLOTS],
                                              SamplingParams(max_tokens=8)),
                         card)
        else:
            print(f"serve streamed: the monolithic paged serve of the same "
                  f"prompts: {len(clock.prefill_ms)} prefills, prefill ms "
                  f"per wave {[round(t, 3) for t in clock.prefill_ms]}, "
                  f"{steps} decode steps, median decode ms "
                  f"{statistics.median(clock.decode_ms):.3f}, "
                  f"{total / wall:.1f} tokens/s over {wall:.2f} s [{card}]")
        del llm, be, clock
        torch.cuda.empty_cache()
    keys = [FirstLogits.key(p) for p in prompts]
    got = np.stack([firsts["streamed"][k] for k in keys])
    want = np.stack([firsts["monolithic"][k] for k in keys])
    diff = np.abs(got - want)
    if not np.isfinite(got).all() or diff.max() > LOGITS_ATOL:
        raise AssertionError(f"serve streamed: first-token logits against "
                             f"the monolithic serve's: max abs diff "
                             f"{diff.max():.4g} > {LOGITS_ATOL}")
    same = sum(int(a == b) for o, u in zip(outs["streamed"],
                                           outs["monolithic"])
               for a, b in zip(o.tokens, u.tokens))
    print(f"serve streamed: first-token logits of the {len(keys)} requests, "
          f"streamed vs monolithic, max abs diff {diff.max():.4g} (mean "
          f"{diff.mean():.3g}; atol {LOGITS_ATOL}), argmax agreement "
          f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/{len(keys)}; "
          f"greedy tokens equal {same}/{STREAM_REQUESTS * MAX_TOKENS} (bf16: "
          f"the two paths sum in other orders) [{card}]")
    return dict(launches=paged, hits=hits)


def serve_hybrid(model, pa, da, rs, card):
    """recurrentgemma-2b on the contiguous layout: RG-LRU state per slot
    beside windowed rings of 2048 keys."""
    from repro_torch.serving import LLM, SamplingParams
    cfg = model.cfg
    n_scan = sum(spec.kind == "rglru" for spec in cfg.layer_specs())
    n_attn = cfg.n_layers - n_scan
    try:
        model.backend("cuda", "paged", HYBRID_MAX_LEN)
    except ValueError as e:
        print(f"serve hybrid: the paged layout refuses it: {e}")
    else:
        raise AssertionError("the paged layout served a hybrid model")
    be = model.backend("cuda", "contiguous", HYBRID_MAX_LEN)
    print(f"serve hybrid: {HYBRID} {cfg.n_layers} layers ({n_scan} RG-LRU, "
          f"{n_attn} local attention, window {HYBRID_WINDOW}), d_model "
          f"{cfg.d_model}, {be.info.param_bytes / 1e9:.2f} GB of {cfg.dtype} "
          f"weights from seed {SEED} in {model.init_s:.1f} s; max_len "
          f"{HYBRID_MAX_LEN}, {be.info.cache_bytes / 2 ** 20:.1f} MiB of "
          f"rings and state")
    clock = StepClock(be)
    llm = LLM.from_backend(be, seed=SEED)
    sp = SamplingParams(max_tokens=MAX_TOKENS)
    llm.generate([model.prompts[0][:16]], SamplingParams(max_tokens=4))

    clock.reset()
    rs.rglru_scan.launches = 0
    da.decode_attention.launches = 0
    pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    outs = llm.generate(model.prompts, sp)
    wall = time.perf_counter() - t0
    scans, attends = rs.rglru_scan.launches, da.decode_attention.launches
    waves_, steps = len(clock.prefill_ms), len(clock.decode_ms)
    if scans != n_scan * waves_ or attends != n_attn * steps or not scans \
            or not attends or pa.paged_attention.launches:
        raise AssertionError(
            f"rglru_scan launched {scans} times over {waves_} prefill waves "
            f"of {n_scan} RG-LRU layers, decode_attention {attends} times "
            f"over {steps} decode steps of {n_attn} attention layers, "
            f"paged_attention {pa.paged_attention.launches} times")
    for o in outs:
        if o.n_generated != MAX_TOKENS or o.finish_reason != "length" \
                or not all(0 <= t < cfg.vocab_size for t in o.tokens):
            raise AssertionError(f"request {o.uid}: {o.n_generated} tokens, "
                                 f"{o.finish_reason}")
    total = sum(o.n_generated for o in outs)
    print(f"serve hybrid: {len(outs)} requests {list(HYBRID_PROMPT_LENS)} "
          f"prompt tokens x {MAX_TOKENS} greedy tokens over {SLOTS} slots: "
          f"{waves_} prefills, {steps} decode steps, rglru_scan launches "
          f"{scans} = {n_scan} layers x {waves_} waves, decode_attention "
          f"launches {attends} = {n_attn} layers x {steps} steps, "
          f"paged_attention 0")
    print(f"serve hybrid: {clock.summary()}, {total / wall:.1f} tokens/s over "
          f"{wall:.2f} s [{card}]")
    device_share("serve hybrid", f"{SLOTS} requests x 8 tokens",
                 lambda: llm.generate(model.prompts[:SLOTS],
                                      SamplingParams(max_tokens=8)), card)
    del llm, be, clock
    torch.cuda.empty_cache()

    tokens = [o.tokens for o in outs]
    got = {}
    for impl in ("cuda", "ref"):
        got[impl] = teacher_forced(
            model.backend(impl, "contiguous", HYBRID_MAX_LEN),
            model.prompts, tokens)
        torch.cuda.empty_cache()
    compare_logits("hybrid decode", got, card)
    return dict(scans=scans, attends=attends)


def score(model, kernels, card):
    """The train-mode forward of ``SCORE_BATCH`` x ``SCORE_LEN`` seeded tokens
    under ``torch.no_grad``: ``impl="cuda"`` launches the flash kernel once
    per attention layer and the scan once per RG-LRU layer, and no decode
    kernel; its logits agree with ``impl="ref"``'s.  ``kernels`` maps each
    kernel's name to its wrapper; returns the launches of the cuda run."""
    from repro_torch.models import transformer as T
    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SCORE_BATCH, SCORE_LEN))).to(DEVICE)
    n_scan = sum(spec.kind == "rglru" for spec in cfg.layer_specs())
    want = dict(flash_attention=cfg.n_layers - n_scan, rglru_scan=n_scan,
                decode_attention=0, paged_attention=0, int8_matmul=0)
    logits, secs = {}, {}
    with torch.no_grad():
        for impl in ("cuda", "ref"):
            for fn in kernels.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[impl], caches = T.forward(cfg, model.params, tokens,
                                             mode="train", impl=impl)
            torch.cuda.synchronize()
            secs[impl] = time.perf_counter() - t0
            if impl == "cuda":
                launches = {n: fn.launches for n, fn in kernels.items()}
    if launches != want or caches is not None:
        raise AssertionError(f"score {cfg.name}: launches {launches}, "
                             f"expected {want}")
    diff = agree = 0
    for row in range(SCORE_BATCH):           # one row at a time: V is large
        got, ref = logits["cuda"][row].float(), logits["ref"][row].float()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"score {cfg.name}: non-finite logits")
        diff = max(diff, (got - ref).abs().max().item())
        agree += int((got.argmax(-1) == ref.argmax(-1)).sum())
    if diff > LOGITS_ATOL:
        raise AssertionError(f"score {cfg.name}: logits cuda vs ref max abs "
                             f"diff {diff:.4g} > {LOGITS_ATOL}")
    print(f"score {cfg.name}: forward(mode='train') over {SCORE_BATCH} x "
          f"{SCORE_LEN} tokens, logits {list(logits['cuda'].shape)}: impl "
          f"cuda vs ref max abs diff {diff:.4g} (atol {LOGITS_ATOL}), argmax "
          f"agreement {agree}/{SCORE_BATCH * SCORE_LEN}; launches "
          f"{launches}; {secs['cuda'] * 1e3:.1f} ms cuda, "
          f"{secs['ref'] * 1e3:.1f} ms ref [{card}]")
    del logits
    torch.cuda.empty_cache()
    return launches


def pipeline_prompts(cfg, n):
    """``n`` prompts of 16-48 tokens from SEED."""
    rng = np.random.default_rng(SEED)
    lo, hi = PIPE_PROMPT_LENS
    return [rng.integers(0, cfg.vocab_size, k).astype(np.int32)
            for k in rng.integers(lo, hi + 1, n)]


def profile_ring(label, llm, prompts, sp, card):
    """The card's busy share over two turns of the ring in mid-serve: the
    pipeline serve's own requests again, profiled from the turn at which
    the shortest prompts generate and the longest are still
    teacher-forced.  Every slot is live there (the shortest request feeds
    its prompt and ``max_tokens - 1`` tokens), so every stage runs each
    tick.  The serve is dropped after the window."""
    be = llm.backend
    m = be.spec.n_stages
    shortest = min(len(p) for p in prompts)
    turn = shortest + sp.max_tokens // 2 - 2
    if turn + 2 > shortest + sp.max_tokens - 1:
        raise AssertionError(f"{label}: no full ring to profile")
    for uid, prompt in enumerate(prompts):
        llm.submit(prompt, sp, uid=len(prompts) + uid)
    t0 = be.state.tick
    while be.state.tick < t0 + turn * m:
        llm.step()
    # after a tick, buf_valid[1:] holds the validity of its stages
    # 0 .. m - 2; its last stage ran what stage m - 2 held a tick before
    live = [sum(be.state.buf_valid[1:])]

    def window():
        while be.state.tick < t0 + (turn + 2) * m:
            llm.step()
            live.append(sum(be.state.buf_valid[1:]))

    device_share(label, f"ticks {turn * m}-{(turn + 2) * m - 1} of the "
                 f"serve (prompts {shortest}+ tokens: turns {turn}, "
                 f"{turn + 1})", window, card)
    if min(live) < m - 1:
        raise AssertionError(f"{label}: a profiled tick ran {min(live) + 1} "
                             f"of {m} stages")
    print(f"{label}: profiled window {len(live) - 1} ticks, every stage "
          f"live in each")


def serve_pipeline(model, kernels, card):
    """The paper's path: ``LLM.from_plan`` plans llama2-7b over the paper's
    testbed with the port's DP (throughput objective) and serves the
    planned stages as the no-bubbles pipeline on this card, one request
    per slot, on the contiguous layout and then the paged one.  Each
    serve's decode kernel launches once per layer and fed token, the other
    never; the logits that chose each greedy token agree with the
    contiguous TensorBackend's, fed the same tokens.  Then the planned
    stages' microbatched train-mode forward (the flash kernel once per
    layer and micro-batch) against the unstaged ref path.  ``kernels`` maps
    each kernel's name to its wrapper; returns each layout's launches and
    the forward's."""
    from repro_torch.core import pipeline as PL
    from repro_torch.core.devices import paper_testbed
    from repro_torch.core.profile import Workload
    from repro_torch.models import transformer as T
    from repro_torch.serving import LLM, SamplingParams
    cfg = model.cfg
    sp = SamplingParams(max_tokens=PIPE_TOKENS)

    def plan(layout):
        return LLM.from_plan(cfg, paper_testbed(), Workload(dtype_bytes=2),
                             objective="throughput", kind="pipeline",
                             params=model.params, max_len=PIPE_MAX_LEN,
                             cache_layout=layout, block_size=BLOCK_SIZE,
                             impl="cuda", device=DEVICE, seed=SEED)

    llm = plan("contiguous")
    spec = llm.backend.spec
    periods = spec.periods_per_stage
    if spec.n_stages < 2 or max(periods) == min(periods):
        raise AssertionError(f"pipeline: planned stages {periods}: expected "
                             f"two or more, uneven")
    prompts = pipeline_prompts(cfg, spec.n_stages)
    print(f"pipeline: LLM.from_plan({cfg.name}, paper_testbed(), "
          f"objective='throughput'): {spec.n_stages} stages, periods per "
          f"stage {periods}; {spec.n_stages} requests of "
          f"{[len(p) for p in prompts]} prompt tokens x {PIPE_TOKENS} greedy "
          f"tokens, one a slot, max_len {PIPE_MAX_LEN}")
    be = model.backend("cuda", "contiguous", PIPE_MAX_LEN,
                       n_slots=spec.n_stages)
    tensor_tokens = [o.tokens for o in LLM.from_backend(be, seed=SEED)
                     .generate(prompts, sp)]
    del be
    fed = sum(len(p) + PIPE_TOKENS - 1 for p in prompts)
    out = {}
    for layout in ("contiguous", "paged"):
        t_phase = time.perf_counter()
        llm = llm or plan(layout)
        be = llm.backend
        if be.spec != spec or be.info.attn_impl != "cuda" \
                or be.n_slots != spec.n_stages:
            raise AssertionError(f"pipeline {layout}: spec {be.spec}, "
                                 f"attn_impl {be.info.attn_impl}, "
                                 f"{be.n_slots} slots")
        starts, logits = [], {}
        tick = be.decode_step

        def timed(feeds, tick=tick, llm=llm):
            """One tick, its start stamped on the host clock (no sync
            added); the logits of each completed micro-batch under its
            request."""
            starts.append(time.perf_counter())
            events = tick(feeds)
            for ev in events:
                uid = llm.batcher._slot_req[ev.slot].uid
                logits.setdefault(uid, []).append(ev.logits)
            return events

        be.decode_step = timed
        llm.generate([prompts[0][:2]], SamplingParams(max_tokens=1))
        starts.clear()
        logits.clear()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        outs = run_requests(llm, prompts, sp)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        wall = t_end - t0
        launches = {n: fn.launches for n, fn in kernels.items()}
        # a tick's time: from its start to the next tick's (the scheduler's
        # work between them included), the last one's to the serve's end
        ticks = np.diff(starts + [t_end]) * 1e3
        kernel = "decode_attention" if layout == "contiguous" \
            else "paged_attention"
        want = {n: cfg.n_layers * fed if n == kernel else 0 for n in kernels}
        if launches != want:
            raise AssertionError(f"pipeline {layout}: launches {launches}, "
                                 f"expected {want} ({fed} fed tokens)")
        tokens = [o.tokens for o in outs]
        same = sum(int(a == b) for t, u in zip(tokens, tensor_tokens)
                   for a, b in zip(t, u))
        total = sum(o.n_generated for o in outs)
        print(f"pipeline {layout}: {len(ticks)} ticks, {kernel} launches "
              f"{launches[kernel]} = {cfg.n_layers} layers x {fed} fed "
              f"tokens, the other decode kernel 0; greedy tokens equal to "
              f"the contiguous TensorBackend's: {same}/{total}; "
              f"{llm.stats.preemptions} preemptions")
        print(f"pipeline {layout}: tick ms median "
              f"{statistics.median(ticks):.3f} (min {min(ticks):.3f}, max "
              f"{max(ticks):.3f}), {total / wall:.1f} tokens/s ({fed / wall:.1f} "
              f"fed tokens/s) over {wall:.2f} s [{card}]")
        be.decode_step = tick
        profile_ring(f"pipeline {layout}", llm, prompts, sp, card)
        got = np.stack([np.stack(logits[i]) for i in range(len(prompts))])
        del llm, be, logits
        torch.cuda.empty_cache()
        tf = teacher_forced(model.backend("cuda", "contiguous", PIPE_MAX_LEN,
                                          n_slots=spec.n_stages),
                            prompts, tokens, spec.n_stages, PIPE_TOKENS,
                            first=True)
        # step 0: the logits after the whole teacher-forced prompt against
        # the TensorBackend's prefill; then each fed-back token's
        compare_logits(f"pipeline {layout} prompt",
                       {"pipeline": got[:, :1], "TensorBackend": tf[:, :1]},
                       card, sides=("pipeline", "TensorBackend"))
        compare_logits(f"pipeline {layout} decode",
                       {"pipeline": got[:, 1:], "TensorBackend": tf[:, 1:]},
                       card, sides=("pipeline", "TensorBackend"))
        print(f"pipeline {layout}: phase wall "
              f"{time.perf_counter() - t_phase:.2f} s [{card}]")
        out[layout] = launches[kernel]
        llm = None
        torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SCORE_BATCH, SCORE_LEN))).to(DEVICE)
    for fn in kernels.values():
        fn.launches = 0
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = PL.pipeline_forward(cfg, model.params, tokens, spec,
                                  PIPE_MICROBATCHES, impl="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in kernels.items()}
        ref, _ = T.forward(cfg, model.params, tokens, mode="train",
                           impl="ref")
    want = {n: cfg.n_layers * PIPE_MICROBATCHES
            if n == "flash_attention" else 0 for n in kernels}
    if launches != want:
        raise AssertionError(f"pipeline_forward: launches {launches}, "
                             f"expected {want}")
    diff = agree = 0
    for row in range(SCORE_BATCH):
        a, b = got[row].float(), ref[row].float()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("pipeline_forward: non-finite logits")
        diff = max(diff, (a - b).abs().max().item())
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
    if diff > LOGITS_ATOL:
        raise AssertionError(f"pipeline_forward: logits against the ref "
                             f"forward max abs diff {diff:.4g} > "
                             f"{LOGITS_ATOL}")
    print(f"pipeline_forward: {SCORE_BATCH} x {SCORE_LEN} tokens in "
          f"{PIPE_MICROBATCHES} micro-batches over the {spec.n_stages} "
          f"planned stages, impl cuda: {secs * 1e3:.1f} ms, flash_attention "
          f"launches {launches['flash_attention']} = {cfg.n_layers} layers x "
          f"{PIPE_MICROBATCHES} micro-batches; logits against "
          f"forward(mode='train', impl='ref') max abs diff {diff:.4g} (atol "
          f"{LOGITS_ATOL}), argmax agreement {agree}/"
          f"{SCORE_BATCH * SCORE_LEN} [{card}]")
    del got, ref
    torch.cuda.empty_cache()
    out["flash_attention"] = launches["flash_attention"]
    return out


def train_phase(fa, card):
    """qwen3-0.6b at full width and depth: the port's ``train`` (the loss
    must fall), timed train steps, the evaluation loss through the flash
    kernel against ``impl="ref"``, and a checkpoint round trip."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.training import (AdamWConfig, DataConfig, TrainConfig,
                                      adamw_init, make_dataset,
                                      make_train_step, restore_checkpoint,
                                      save_checkpoint, train)
    from repro_torch.training.adamw import tree_leaves
    cfg = get_config(TRAIN_ARCH)
    dcfg = DataConfig(vocab_size=TRAIN_DATA_VOCAB, seq_len=TRAIN_LEN,
                      batch=TRAIN_BATCH, seed=SEED)
    tcfg = TrainConfig(steps=TRAIN_STEPS, log_every=1, impl="ref",
                       optimizer=AdamWConfig(lr=1e-3, warmup_steps=1,
                                             total_steps=TRAIN_STEPS))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = train(cfg, tcfg, dcfg, device=DEVICE, seed=SEED)
    wall = time.perf_counter() - t0
    if not metrics["final_loss"] < metrics["first_loss"]:
        raise AssertionError(f"train {TRAIN_ARCH}: loss did not fall: "
                             f"{metrics}")
    print(f"train {TRAIN_ARCH}: {cfg.n_layers} layers, {cfg.dtype} weights, "
          f"float32 moments: {TRAIN_STEPS} AdamW steps of {TRAIN_BATCH} x "
          f"{TRAIN_LEN} tokens, impl ref: loss {metrics['first_loss']:.4f} -> "
          f"{metrics['final_loss']:.4f} (mean last 10 "
          f"{metrics['mean_last10']:.4f}) in {wall:.1f} s with set-up; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB [{card}]")
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device=DEVICE)
    params = init_params(cfg, gen.manual_seed(SEED), DEVICE)
    opt = adamw_init(params)
    step = make_train_step(cfg, tcfg)
    data = make_dataset(dcfg)
    step_ms = []
    for i in range(4):
        tokens, labels = (torch.from_numpy(a).to(DEVICE, torch.long)
                          for a in data.batch_at(i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, tokens, labels)
        float(m["loss"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"train {TRAIN_ARCH}: step ms {[round(t, 3) for t in step_ms]} "
          f"(host clock to the loss readback; the first warms up) [{card}]")
    tokens, labels = (torch.from_numpy(a).to(DEVICE, torch.long)
                      for a in data.batch_at(len(step_ms)))
    state = {}
    device_share(f"train {TRAIN_ARCH}", "one train step",
                 lambda: state.update(out=step(params, opt, tokens, labels)),
                 card)
    params, opt, _ = state["out"]

    tokens, labels = (torch.from_numpy(a).to(DEVICE, torch.long)
                      for a in data.batch_at(len(step_ms) + 1))
    loss = {}
    with torch.no_grad():
        for impl in ("cuda", "ref"):
            fa.flash_attention.launches = 0
            loss[impl] = float(T.train_loss(cfg, params, tokens, labels,
                                            impl=impl)[0])
            if impl == "cuda":
                launches = fa.flash_attention.launches
    if launches != cfg.n_layers or not np.isfinite(loss["cuda"]) or \
            abs(loss["cuda"] - loss["ref"]) > LOSS_ATOL:
        raise AssertionError(f"train {TRAIN_ARCH}: evaluation loss cuda "
                             f"{loss['cuda']} vs ref {loss['ref']} (atol "
                             f"{LOSS_ATOL}), {launches} flash launches")
    print(f"train {TRAIN_ARCH}: evaluation loss under no_grad, impl cuda "
          f"{loss['cuda']:.6f} vs ref {loss['ref']:.6f}: diff "
          f"{abs(loss['cuda'] - loss['ref']):.3g} (atol {LOSS_ATOL}); "
          f"flash_attention launches {launches} = {cfg.n_layers} layers "
          f"[{card}]")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        fname = save_checkpoint(tmp, cfg, params, opt, step=opt.step)
        t_save = time.perf_counter() - t0
        size = Path(fname).stat().st_size
        template = init_params(cfg, gen.manual_seed(SEED + 1), DEVICE)
        t0 = time.perf_counter()
        back, back_opt, back_step = restore_checkpoint(
            fname, cfg, template, adamw_init(template))
        t_load = time.perf_counter() - t0
    pairs = list(zip(tree_leaves((params, opt.mu, opt.nu)),
                     tree_leaves((back, back_opt.mu, back_opt.nu))))
    if back_step != opt.step or back_opt.step != opt.step or not all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"train {TRAIN_ARCH}: the checkpoint did not "
                             f"restore bit for bit")
    print(f"train {TRAIN_ARCH}: checkpoint of step {opt.step} "
          f"({size / 1e9:.2f} GB, {len(pairs)} tensors) written in "
          f"{t_save:.1f} s, restored bit for bit in {t_load:.1f} s")


def device_share(label, what, run, card):
    """The card's busy share over one profiled call of ``run`` (``what``
    says what it does), and the device time by kernel.  The profiler adds
    host time, so the busy share it shows is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        print(f"{label}: device busy share not measured (the profiler saw "
              f"no device events)")
        return
    print(f"{label}: profiled {what}: device busy {busy / 1e3:.2f} ms of "
          f"{wall_us / 1e3:.2f} ms wall ({busy / wall_us:.1%}) [{card}]")
    kinds = {"matrix products": ("gemm", "nvjet", "cutlass", "xmma"),
             "paged attention": ("paged_attention_kernel",
                                 "paged_attention_merge_kernel"),
             "decode attention": ("decode_attention_kernel",
                                  "decode_attention_merge_kernel"),
             "flash attention": ("flash_attention_kernel",),
             "rglru scan": ("rglru_scan_kernel",)}
    shares = {kind: sum(us for n, us in by_name.items()
                        if any(k in n for k in keys)) / busy
              for kind, keys in kinds.items()}
    print(f"{label}:   device time by kind: " + ", ".join(
        f"{kind} {share:.1%}" for kind, share in shares.items())
          + f", other {1 - sum(shares.values()):.1%}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"{label}:   {us / 1e3:8.3f} ms {us / busy:6.1%}  "
              f"{name[:90]}")


def main():
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        sys.exit("chip_smoke: src/repro_torch is not beside this script; run "
                 "it from the root of a checkout of the repository")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; the port's "
                 "smoke test runs on an NVIDIA GPU")
    sys.path[:0] = [str(SRC), str(ROOT / "tests")]
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rglru_scan as rs
    wrappers = dict(flash_attention=fa.flash_attention,
                    rglru_scan=rs.rglru_scan,
                    decode_attention=da.decode_attention,
                    paged_attention=pa.paged_attention,
                    int8_matmul=i8.int8_matmul)

    # float32 products in full float32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {built.path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for source, log in built.logs.items():
        print(f"build: {source}: nvcc {built.seconds[source]:.1f} s")
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"build:   {line.strip()[:140]}")

    worst = {"paged_attention": check_paged(pa),
             "decode_attention": check_ring(da)}
    worst["rglru_scan"] = check_rglru(rs)
    worst["flash_attention"] = check_flash(fa)
    worst["int8_matmul"] = check_int8(i8)
    print("kernels: worst case error " + ", ".join(
        f"{k} {v:.3g}" for k, v in worst.items()))
    timing = {
        "paged_attention": time_paged(pa, card, 1),
        "paged_verify_attention": time_paged(pa, card, SPEC_K),
        # the streamed serve's decode: contexts of up to 1256 keys
        "paged_attention streamed": time_paged(pa, card, 1, STREAM_MAX_LEN),
        "decode_attention full": time_decode(da, card, CONTIGUOUS_MAX_LEN),
        "decode_attention": time_decode(da, card, CONTIGUOUS_MAX_LEN // 4),
        # 4 x 8.4 MB of K/V per set: 8 sets exceed the L2
        "decode_attention hybrid": time_decode(
            da, card, HYBRID_WINDOW, heads=(10, 1, 256), c=HYBRID_WINDOW,
            n_sets=8),
        # the pipeline's decode: one slot a call, contexts of up to 64 keys;
        # 64 sets of 1 MB of K/V exceed the L2
        "decode_attention pipeline": time_decode(
            da, card, PIPE_MAX_LEN, c=PIPE_MAX_LEN, n_sets=64, slots=1),
        "paged_attention pipeline": time_paged(pa, card, 1, PIPE_MAX_LEN,
                                               slots=1, n_sets=64),
        "rglru_scan": time_rglru(rs, card, HYBRID_MAX_LEN),
        "rglru_scan short": time_rglru(rs, card, 256),
        "flash_attention": time_flash(fa, card),
        # 1 x 4096 x 10 x 256 bf16 q and out, 2 x 2 MB of K/V: 46 MB a set
        "flash_attention hybrid": time_flash(
            fa, card, heads=(10, 1, 256), window=HYBRID_WINDOW, n_sets=3),
    }
    shapes = {
        "paged_attention": f"llama2-7b x {SLOTS} slots x {MAX_LEN} keys bf16",
        "paged_attention streamed": f"llama2-7b x {SLOTS} slots x "
                                    f"{STREAM_MAX_LEN} keys bf16",
        "paged_verify_attention": f"llama2-7b x {SLOTS} slots x {MAX_LEN} "
                                  f"keys x KQ={SPEC_K} bf16",
        "decode_attention full": f"llama2-7b x {SLOTS} slots x "
                                 f"{CONTIGUOUS_MAX_LEN}-key ring, full, bf16",
        "decode_attention": f"llama2-7b x {SLOTS} slots x "
                            f"{CONTIGUOUS_MAX_LEN}-key ring, a quarter "
                            f"full, bf16",
        "decode_attention hybrid": f"{HYBRID} (H=10, KH=1, D=256) x {SLOTS} "
                                   f"slots x {HYBRID_WINDOW}-key window "
                                   f"ring, full, bf16",
        "decode_attention pipeline": f"llama2-7b x 1 slot x "
                                     f"{PIPE_MAX_LEN}-key ring, full, bf16",
        "paged_attention pipeline": f"llama2-7b x 1 slot x {PIPE_MAX_LEN} "
                                    f"keys bf16",
        "rglru_scan": f"{HYBRID} {SLOTS} x {HYBRID_MAX_LEN} x 2560 f32",
        "rglru_scan short": f"{HYBRID} {SLOTS} x 256 x 2560 f32",
        "flash_attention": f"llama2-7b (H=KH=32, D=128) 1 x {SCORE_LEN}, "
                           f"causal, bf16",
        "flash_attention hybrid": f"{HYBRID} (H=10, KH=1, D=256) 1 x "
                                  f"{SCORE_LEN}, window {HYBRID_WINDOW}, "
                                  f"bf16",
    }
    for m in INT8_M:
        for k, n in INT8_PROJ:
            for dtype in (torch.bfloat16, torch.float32):
                key = f"int8_matmul M={m} {k}x{n} {str(dtype)[6:]}"
                timing[key] = time_int8(i8, card, m, k, n, dtype)
                shapes[key] = (f"llama2-7b projection x [{m}, {k}] "
                               f"{str(dtype)[6:]} @ w_q [{k}, {n}] int8")
    for key, t in timing.items():
        timing_line(key.split()[0], shapes[key], t, card)

    int8_launches = int8_path(i8, wrappers, card)
    model = Model()
    paged = serve_paged(model, pa, card)
    contiguous = serve_contiguous(model, pa, da, card, paged["tokens"])
    spec = serve_spec(model, pa, da, card, paged["tokens"])
    streamed = serve_streamed(model, wrappers, card)
    scored = score(model, wrappers, card)
    pipe = serve_pipeline(model, wrappers, card)
    del model                       # 13.48 GB of llama2-7b weights
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(HYBRID, HYBRID_PROMPT_LENS)
    hybrid = serve_hybrid(model, pa, da, rs, card)
    hybrid_scored = score(model, wrappers, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    train_phase(fa, card)

    def entry(key, name, source, replaces, launches):
        t = timing[key]
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=f"src/repro/kernels/{replaces}",
                    launches=launches, max_abs_err=t["max_abs_err"],
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"])

    # library_ms of rglru_scan is null: no PyTorch call computes a linear
    # recurrence
    kernels = [
        entry("paged_attention", "paged_attention", "paged_attention.cu",
              "decode_attention.py:201", paged["launches"]),
        entry("paged_verify_attention", "paged_verify_attention",
              "paged_attention.cu", "decode_attention.py:256",
              spec["launches"]),
        entry("decode_attention", "decode_attention", "decode_attention.cu",
              "decode_attention.py:153", contiguous["launches"]),
        entry("decode_attention hybrid", f"decode_attention@{HYBRID}",
              "decode_attention.cu", "decode_attention.py:153",
              hybrid["attends"]),
        entry("rglru_scan", "rglru_scan", "rglru_scan.cu",
              "rglru_scan.py:36", hybrid["scans"]),
        entry("flash_attention", "flash_attention", "flash_attention.cu",
              "flash_attention.py:86", scored["flash_attention"]),
        entry("flash_attention hybrid", f"flash_attention@{HYBRID}",
              "flash_attention.cu", "flash_attention.py:86",
              hybrid_scored["flash_attention"]),
        entry("paged_attention streamed", "paged_attention@streamed",
              "paged_attention.cu", "decode_attention.py:201",
              streamed["launches"]),
        # the planned stage pipeline: its decode ticks and its forward (at
        # the score phase's 1 x 4096 a call, the flash row's shape)
        entry("decode_attention pipeline", "decode_attention@pipeline",
              "decode_attention.cu", "decode_attention.py:153",
              pipe["contiguous"]),
        entry("paged_attention pipeline", "paged_attention@pipeline",
              "paged_attention.cu", "decode_attention.py:201",
              pipe["paged"]),
        entry("flash_attention", "flash_attention@pipeline",
              "flash_attention.cu", "flash_attention.py:86",
              pipe["flash_attention"]),
        # the op's entry point: one llama2-7b layer's projections in bf16
        entry("int8_matmul M=4 4096x4096 bfloat16", "int8_matmul",
              "int8_matmul.cu", "int8_matmul.py:41", int8_launches["decode"]),
        entry(f"int8_matmul M={INT8_M[1]} 4096x4096 bfloat16",
              "int8_matmul@prefill", "int8_matmul.cu", "int8_matmul.py:41",
              int8_launches["prefill"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
