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
   its split count printed.  The RG-LRU scan in float32 at R = 2560, 200
   (ragged) and 199 (R % 4 != 0: the kernel's 4-byte copies), S = 1, 7 and
   4096, with and without h0, with bases one float past 16-byte alignment,
   and at S = 150 (three 48 KB stages), each with its launch plan printed;
   and left-pad identity steps that must leave h bit for bit, at R = 2560,
   199 and a misaligned base.  The flash-attention kernel in
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
   call over 64 keys, the hybrid's paged decode over its 2048-key window
   and the fleet's over 128-key tables too) beside the plain version, one
   library
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
   then, on the same weights, the int8 KV cache (``kv_dtype="int8"``;
   the six prompts x 4 tokens at ``max_len`` 512): contiguous, the ring
   kernel over dequantized rings once per layer and decode step; paged,
   paged with ``spec_k=4`` and paged streamed (a shared 256-token prefix,
   the prefix cache, 16-token chunks), each reading the pool by gather as
   the reference does (``attn_impl`` "ref", no kernel, the warning
   printed once); each serve's logits within 0.25 of the int8 config's
   ``impl="ref"``, their distance to the bf16 cache printed, the K/V
   bytes a cached token from the tensors; and ``impl="chunked"``: a
   contiguous serve within 0.25 of ref and the 1 x 4096 forward with both
   peak memories;
   then the pipeline phase, the paper's path: ``LLM.from_plan`` plans
   llama2-7b over the paper's testbed (the throughput DP: 13 uneven
   stages) and serves the plan as the no-bubbles stage pipeline on this
   card, two requests of 16-32 prompt tokens over its 13 slots x 8 greedy
   tokens, ``max_len`` 64, on the contiguous layout (the contiguous-ring
   kernel once per layer and fed token) and then the paged one (the paged
   kernel likewise); each serve's logits, which chose its greedy tokens,
   within 0.25 of the contiguous ``TensorBackend``'s fed the same tokens;
   tick ms, tokens/s, the phase's wall and a profiled window (one request
   a slot, so every stage is live); then the
   planned stages' ``pipeline_forward`` over 2 x 4096 tokens in 2
   micro-batches (the flash kernel once per layer and micro-batch)
   against ``forward(mode="train", impl="ref")``; then the paged pipeline
   with ``spec_k=4`` and an oracle of its plain serve's tokens (corrupted
   at 25%): greedy tokens bit for bit the plain paged pipeline serve's,
   drafts accepted, fewer scheduler quanta, the paged kernel once a layer
   and fed token (rejected drafts included); then its streamed admission:
   two requests sharing a 32-token prefix, x 4 greedy tokens, plain and
   then with 16-token chunks, request 0 first so that on the paged layout,
   with the prefix cache, the other adopts its prefix blocks (one hit, 32
   fewer fed tokens), on the contiguous layout with chunks alone (no
   hit); each streamed serve's tokens bit for bit its plain serve's and
   its decode kernel once a layer and fed token;
   then the pipeline-procs phase: ``LLM.from_plan`` over four chips gives
   llama2-7b four stages of 8 layers, served with each stage in its own
   process (``stage_procs=True``: the weights shared by CUDA IPC, the
   activations handed on over gloo) beside the same plan in this process,
   2 requests x 8 over 4 slots on the contiguous layout and then the paged
   one: the greedy tokens bit for bit the one-process ring's, the logits
   that chose them within 0.25, the decode kernel's launches summed over
   the stage processes 32 x the fed tokens (the other kernel's and this
   process's 0); both rings' tick ms, each stage's host, device-wait and
   hop ms a tick, the spawn; then 32 teacher-forced ticks through the
   contiguous serve's ring and a vocab-sharded ring of four processes
   (``token_ready`` equal, logits within 0.25, the vocabulary bytes a
   stage holds); then the mesh phase's ``pipeline_forward``: the same
   plan on a (2, 4) mesh of 8 processes (``MeshProcs``: the stages over
   model, each micro-batch's rows over data, the weights shared by CUDA
   IPC, activations over gloo), 4 x 4096 tokens in 2 micro-batches: 16
   flash launches in each process and none in this one, the logits within
   0.25 of the same forward in one process; the phase's ms, the spawn,
   each process's host, device-wait and hop ms and hop bytes;
   then the tp phase: llama2-7b tensor-parallel on a (1, 4) mesh of 4
   processes (``TensorBackend(..., mesh=...)``: 8 heads, 2752 ff columns
   and 8000 vocabulary rows a process, the weights held once by CUDA
   IPC, the Megatron sums over gloo in float32), 4 requests x 4 greedy
   tokens over 4 slots through ``LLM.from_backend`` on the contiguous
   layout and then the paged one beside the one-process backend: each
   process's ring or paged kernel 32 x its decode steps and none in this
   process, each process's K/V bytes a quarter of one process's, the
   logits of the first 2 tokens teacher-forced within 0.25 of one
   process's, the greedy tokens' agreement printed; then
   ``MeshProcs.forward`` over 1 x 2048 tokens on the same processes
   beside one process (32 flash launches a process, logits within 0.25); the decode medians, each process's host,
   device-wait and all-reduce ms and bytes a decode step, the spawns;
   then the fleet phase: a ``Fleet`` of two paged replicas (4 slots each)
   over the same weight tensors is fed ``bursty_trace``'s 24 requests of
   8-48 prompt tokens x 8 greedy tokens through ``replay``, fault free and
   with the second replica wrapped in ``FaultInjectionBackend`` crashing at
   its 21st decode call: one quarantine, the crashed replica's work
   recovered on the survivor, every request finished or shed with its
   reason, every token emitted before the crash step equal to the fault-free
   run's (and how many after it), the paged kernel once per layer and
   decode step, the peak device memory holding the weights once; then, the
   weights freed, ``repro_torch.launch.serve`` in this process with
   ``--policy edf --ttft-slo 64 --inject-faults transient@decode_step:5x2
   --max-retries 3``: every request finishes, two retries, no escalation;
   then the reference's dense configs, one model at a time at full width
   through the ``TensorBackend`` on both layouts (gemma2-2b at all 26
   layers, four prompts of 4200-4400 tokens over two slots so that the
   local layers' 4096-key window rings wrap, both softcaps and post-norms;
   starcoder2-7b at 16 of its 32 layers, layernorm, biases and a group of
   9, also with ``spec_k=4``: 36 verify rows a K/V head; qwen1.5-32b at
   16 of its 64 layers, qkv bias and MHA at 40 heads; pixtral-12b's
   decoder at 20 of its 40 layers on token inputs): launches exact, teacher-forced logits within
   0.25 of ``impl="ref"``, peak device memory; gemma2-2b also scored over
   1 x 4608 tokens (26 flash launches at D=256 with softcap 50, windowed
   on the local layers), pixtral-12b over 1 x 1024 of its vision stub's
   float embeddings (20 flash launches); then musicgen-large at full width
   and 24 of its 48 layers (MHA at 32 heads of 64, sinusoidal positions,
   layernorm, GELU): the six prompts on both layouts as the dense
   configs, a contiguous int8 serve (the ring kernel over dequantized
   rings), its score over 2 x 4096 frontend embeddings (24 flash
   launches), and in float32 weights its planned pipeline, whose tokens
   must be bit for bit its TensorBackend's (stage 0 adds the sinusoidal
   positions);  The kernels phase holds every kernel at these
   configs' shapes against its plain version and times it;
   then the mixers, one model at a time: granite-moe-1b-a400m at full
   width and 12 of its 24 layers (32 experts top-8) on both layouts, the
   MoE's host reads of its group sizes counted (one a layer call) and
   timed, its score (12 flash launches at D=64); the held comparisons in
   float32 weights (in bf16 the reference's expert init amplifies the two
   read paths' rounding, measured and printed): teacher-forced logits and
   the score against ``impl="ref"`` with the ref run replaying the kernel
   run's expert choices, ``train_loss``'s aux against ref's, its planned
   pipeline against the ``TensorBackend``; kimi-k2-1t-a32b at full width
   and 1 of its 61 layers, paged (64 query heads over 8, 384 experts top-8
   and the shared expert, peak memory); xlstm-1.3b at full width and 8 of
   its 48 layers (7 mLSTM blocks and 1 sLSTM, no kernel) on both layouts
   with a 2100-token prompt, the paged serve's tokens bit for bit the
   contiguous one's, its prefill wave split into mLSTM and sLSTM time, its planned
   pipeline on both layouts against ``decode_step`` at one slot, and in
   float32 at the same depth each mLSTM block's parallel form against its
   recurrence;
   then the mesh MoE: granite-moe-1b-a400m at full width and depth,
   ``forward(mode="train")`` over 2 x 512 tokens on the (2, 4) mesh of
   processes under ``use_mesh`` (a batch row a data point, every MoE
   layer on ``moe_ep``, 8 experts a process): in float32 and in bf16 at
   capacity 8.0 one ``moe_ep`` call a layer and process, nothing dropped;
   in float32 the logits within 0.25 of the one-process ``moe_ragged``
   forward with the processes' expert choices replayed, the one-process
   router's own choices changing at most 0.05% of the routings; in bf16
   the mesh's error against the float32 forward replaying its choices at
   most twice one bf16 process's (logits and changed routings), and
   within 0.25 of one process with the attention replicated; at its own
   1.25 the assignments dropped a layer and the all_to_all bytes;
5. hybrid  -- recurrentgemma-2b at full width and depth (18 RG-LRU and 8
   local-attention layers, window 2048), random weights from a seed,
   ``max_len`` 4096, six greedy requests over four slots, one prompt of
   2100 tokens so its ring wraps, on the contiguous layout and then the
   paged one (blocks of 16; the RG-LRU state stays dense beside the
   pools): the scan kernel launches once per RG-LRU layer and prefill wave,
   the contiguous-ring kernel (contiguous) or the paged kernel (paged)
   once per attention layer and decode step, the other never;
   teacher-forced logits, cuda against ref (the doubling scan and the ring
   or gathered sdpa), and the paged serve's against the contiguous
   serve's; then its score phase at 2 x 4096 tokens (8 windowed flash
   launches, 18 scan launches); then the tp recurrent phase on the same
   weights: a (1, 4) mesh of 4 processes, each its 640 of the 2560 RG-LRU
   channels, 1920 ff columns and 64,000 vocabulary rows, the attention
   whole (10 query heads over one K/V head), beside one process, four
   requests of 16-32 tokens x 4 greedy tokens over four slots at
   ``max_len`` 64, contiguous then paged: the scan once per RG-LRU layer
   and prefill wave and the ring or paged kernel once per attention layer
   and decode step in every process, none in this one; each process's K/V
   bytes one process's and its RG-LRU state a quarter; teacher-forced
   logits within 0.25 of one process's; ``MeshProcs.forward`` over 1 x
   2048 (18 scans at 640 channels and 8 flash launches a process) within
   0.25; each process's collectives a decode step and a score; then
   xlstm-1.3b at full width and 8 layers on a (1, 2) mesh (2 of its 4
   mLSTM heads and half its sLSTM's ff a process), contiguous, its logits
   against one process's printed (its random weights carry any rounding
   to about 2), each block's mixer in float32 within 2e-4 of one
   process's and the bf16 forward at most twice one process's error
   against the float64 forward;
6. train   -- the hybrid's weights freed, qwen3-0.6b at full width and
   depth (28 layers, bf16 weights, float32 moments): 8 AdamW steps of the
   port's ``train`` on the synthetic stream (batch 4 x 512 tokens,
   ``impl="ref"``), whose loss must fall; timed train steps; the
   evaluation loss through the flash kernel (28 launches, ``no_grad``)
   against ``impl="ref"``; a checkpoint written and restored bit for bit;
   then training over the mesh: qwen3-0.6b at full size in float32
   weights on a (2, 2) mesh of 4 processes (a process's 2 rows of the
   batch, 8 query and 4 K/V heads, 1536 ff columns, 75,968 vocabulary
   rows; autograd through the tensor-parallel collectives, the gradients
   averaged over data in one flat buffer), 3 AdamW steps of 4 x 512
   tokens beside the one-process step on the same weights: each step's
   loss and gradient norm within 2e-4, the parameters after the last
   within two AdamW updates, the trained shards' evaluation through the
   flash kernel (28 launches a process, 112 summed) within 2e-3 of
   ``impl="ref"``; each process's collectives (tp and data: count, bytes,
   seconds) and peak memory printed; then the multi-pod mesh:
   granite-moe-1b-a400m at full width in float32 weights on a (2, 2, 2)
   ``(pod, data, model)`` mesh of 8 processes (16 of 32 experts, 8 query
   and 4 K/V heads and one of the 4 rows a process), capacity factor 8.0,
   at the depth the port's dry run sizes before spawning (the most
   layers, up to 12, whose 8 predicted peaks and the host's trees fit in
   85% of the free card); 3 AdamW steps of 4 x 512 beside the one-process
   ``moe_ragged`` step (its load-balance term the mesh's mean over the 8
   token blocks), the processes replaying its expert choices: each
   step's loss and gradient norm within 2e-4, the parameters within two
   AdamW updates, the routings the processes' own routers would have
   chosen otherwise in the first step (the same weights) at most 0.05%,
   nothing dropped; the trained shards'
   evaluation through the flash kernel (a launch a layer and process)
   within 2e-3 of ``impl="ref"``; each process's collectives by kind (the
   data all-reduce over ``(pod, data)``, two all-to-alls a layer over
   ``model`` each way, the batch gathers) and peak memory printed;
7. dry run -- the dry runs (``launch/dryrun.py``,
   ``launch/dryrun_pipeline.py``: one mesh process's step on the ``meta``
   device, counted; no kernel, no device memory, nothing spawned) held
   against what the phases above measured: llama2-7b's decode step on the
   tp phase's (1, 4) mesh at its slots and ``max_len`` gives each
   process's collective calls and bytes a decode step exactly (both
   layouts); qwen3-0.6b's float32 step on the train mesh phase's (2, 2)
   mesh at 4 x 512 gives each process's last-step tp and data calls and
   bytes exactly, and its arguments plus its temp peak are within
   ``DRYRUN_PEAK_RTOL`` of each process's peak device memory; so does
   granite-moe's step on the multi-pod phase's (2, 2, 2) mesh, by kind
   too; the
   pipeline dry run of llama2-7b's (8, 8, 8, 8) plan gives each stage's
   hop bytes a live tick in the pipeline procs phase (both layouts) and
   the vocab-sharded ring's all-reduce and broadcast calls and bytes;
   then two production records (``run_one`` of llama2-7b's
   ``decode_32k`` on 16 x 16 and ``run_pipeline_one`` with the planner's
   layout), printed with their walls; ``torch.cuda.memory_allocated()``
   is the same before and after;
8. examples -- the port's drivers (``python -m
   repro_torch.examples.<name>``, the reference's ``examples/``) in this
   process, each holding its own asserts: ``quickstart`` and
   ``partition_plan`` (defaults, then ``--objective throughput --cloud-bw
   10``) on the host; ``serve_pipeline`` on the card (a planned 4-stage
   pipeline of reduced qwen3-0.6b in float32 with the kernels, the ring
   kernel on its decode ticks, every token equal to the tensor backend's,
   then ``stream``); ``train_tiny`` (200 steps, the loss must fall);
9. result  -- the walls of every phase, one JSON line of per-kernel
   numbers, then the result line.

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
MAX_TOKENS = 8                      # 32 until the mesh phases, 16 until
                                    # the train mesh phase took their time
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
# the train mesh phase: qwen3-0.6b in float32 weights on a (2, 2) mesh of
# processes (8 query and 4 K/V heads, 1536 ff columns, 75,968 vocabulary
# rows and 2 of the 4 rows a process), 3 AdamW steps beside one process;
# each step's loss and gradient norm held at test_torch_train.py's
# tolerance (float32 sums in another order)
TRAIN_MESH_SHAPE, TRAIN_MESH_STEPS = (2, 2), 3
TRAIN_MESH_HEADS = (16 // TRAIN_MESH_SHAPE[1], 8 // TRAIN_MESH_SHAPE[1], 128)
TRAIN_MESH_TOL = dict(rtol=2e-4, atol=2e-4)
# the multi-pod phase: granite-moe-1b-a400m at full width in float32
# weights on a (2, 2, 2) (pod, data, model) mesh of 8 processes (16 of the
# 32 experts, 8 query and 4 K/V heads and one of the 4 rows a process; its
# 49,155-word vocabulary does not split over 2 and stays whole), capacity
# factor MULTIPOD_CF so that no token can drop, TRAIN_MESH_STEPS AdamW
# steps of TRAIN_BATCH x TRAIN_LEN beside one process.  Its depth is the
# port's dry run's answer, before spawning: the most layers, up to
# MULTIPOD_MAX_LAYERS (the mixers phase's cut), whose 8 processes'
# predicted peaks (each DRYRUN_PEAK_RTOL over, and MULTIPOD_PROC_BYTES for
# a process's CUDA context) and the host's parameters and moments fit in
# MULTIPOD_MEM_SHARE of the card's free memory
MULTIPOD_SHAPE, MULTIPOD_CF, MULTIPOD_MAX_LAYERS = (2, 2, 2), 8.0, 12
MULTIPOD_HEADS = (16 // MULTIPOD_SHAPE[2], 8 // MULTIPOD_SHAPE[2], 64)
MULTIPOD_MEM_SHARE, MULTIPOD_PROC_BYTES = 0.85, 1 << 30
# the streamed serve: 8 requests over 4 slots, each a shared 1024-token
# prefix plus 16-200 tokens of its own, the prefix cache on, 256-token chunks
STREAM_REQUESTS, STREAM_SHARED, STREAM_TAIL = 8, 1024, (16, 200)
STREAM_CHUNK = 256
STREAM_MAX_LEN = 1280               # 1024 + 200 + 16 = 1240, in whole blocks
# the pipeline phase: LLM.from_plan over the paper's testbed (13 planned
# stages for llama2-7b), PIPE_REQUESTS requests over its 13 slots (13 until
# the pipeline-procs phase took their time, 6 until the mesh phases did, 4
# until the tp recurrent phase did: the serves' time follows the fed
# tokens), prompts of 16-32 tokens, 8 greedy tokens each; its profiled
# window with one request a slot, so the ring is full; its microbatched
# forward over the score phase's 2 x 4096 tokens in 2 micro-batches
# (prompts of 16-48 tokens until the train mesh phase took its time: a
# serve's ticks follow its longest prompt)
PIPE_PROMPT_LENS, PIPE_TOKENS, PIPE_MAX_LEN = (16, 32), 8, 64
PIPE_REQUESTS, PIPE_MICROBATCHES = 2, 2
# the pipeline-procs phase: llama2-7b planned over four chips, (8, 8, 8, 8),
# each stage in its own process; 2 requests of 16-32 tokens x 8 over 4
# slots (8 until the mesh phases took their time, 4 until the tp recurrent
# phase did) on both layouts, beside the same plan in one process; then 32
# teacher-forced ticks through a plain and a vocab-sharded ring
# (64 vocab-sharded ticks until the train mesh phase took its time)
PROCS_CHIPS, PROCS_REQUESTS, PROCS_VOCAB_TICKS = 4, 2, 32
# the mesh phase: a (2, 4) mesh of processes, one process a point.
# llama2-7b over four chips' plan, (8, 8, 8, 8), the stages over model:
# pipeline_forward over 4 x 4096 tokens in 2 micro-batches, each
# micro-batch's 2 rows over data (a row a process and micro-batch: 32 MiB
# a hop), against the same forward in one process.  granite-moe at full
# width and depth: forward(mode="train") over 2 x 512 tokens under
# use_mesh, every MoE layer on moe_ep (8 of its 32 experts a process), in
# float32 and bf16 at capacity factor 8.0 (no token can drop: held to
# moe_ragged in one process with the processes' routes replayed) and in
# bf16 at its own 1.25 (drops and all_to_all bytes printed)
MESH_SHAPE = (2, 4)
MESH_BATCH, MESH_MICROBATCHES = 4, 2
MESH_MOE_BATCH, MESH_MOE_LEN, MESH_MOE_CF = 2, 512, 8.0
# the share of the mesh MoE's token routings (a token and layer each) on
# which the one-process router, fed its own activations, may choose other
# experts than the mesh processes did: the heads' partial sums change the
# attention's last bits, and a top-k choice near a tie trades on them (1 of
# 24,576 read on an H100); a router or moe_ep choosing wrong experts changes
# far more
MESH_ROUTE_FLIPS = 0.0005
# bf16: the processes' partial sums of the heads round to bf16 before they
# are summed, and granite-moe's init carries such rounding to the logits
# (0.877 from one process with the routes replayed, 22.4% of the routings
# changed, on an H100); so the mesh's bf16 forward is held to the model's
# own bf16 error, at most this factor times that of one process in bf16,
# both against the float32 forward replaying the processes' choices
# (bf16_error)
MESH_BF16_FACTOR = 2
# the tp phase: llama2-7b at full width and depth, tensor-parallel on a
# (1, 4) mesh of processes (8 heads, 2752 ff columns and 8000 vocabulary
# rows a process): TP_REQUESTS requests of 16-32 tokens x TP_TOKENS greedy
# tokens over 4 slots at max_len TP_MAX_LEN, contiguous then paged, beside
# one process, and their first TP_FORCED tokens teacher-forced through both
# (a decode step over gloo is about half a second); then
# forward(mode="train") over 1 x TP_SCORE_LEN tokens on the same processes
# beside one process
# (TP_TOKENS 8 and TP_FORCED 4 until the train mesh phase took its time)
TP_SHAPE, TP_REQUESTS, TP_TOKENS, TP_FORCED = (1, 4), 4, 4, 2
TP_MAX_LEN, TP_SCORE_LEN = 64, 2048
TP_WAVE_LEN = 32                    # the bucket of the tp serves' prompts
# the dry-run phase: a train mesh process's arguments plus its temp peak on
# meta (the storages its ops create, live until their last view is
# dropped) against the process's peak device memory, which the caching
# allocator also counts (512-byte blocks, cuBLAS's workspace)
DRYRUN_PEAK_RTOL = 0.10
TP_HEADS = (32 // TP_SHAPE[1], 32 // TP_SHAPE[1], 128)   # a process's
# the tp recurrent phase: recurrentgemma-2b at full size on the tp phase's
# (1, 4) mesh (640 of the 2560 RG-LRU channels a process, its attention
# whole: 10 query heads over one K/V head of 256), the tp phase's requests,
# tokens and score; then xlstm-1.3b at full width and XLSTM_LAYERS layers
# on (1, 2) (2 of its 4 mLSTM heads and 1365 of its sLSTM's 2730 ff
# columns a process; 2730 does not split in 4), contiguous
TP_RNN = 2560 // TP_SHAPE[1]
TP_XLSTM_SHAPE = (1, 2)
# the pipeline's streamed serves: requests sharing a 32-token prefix (two
# blocks of 16; three until the mesh phases took their time: a token costs
# a turn of the 13-stage ring) plus 1-16 tokens of their own, 4 greedy
# tokens each, chunks of 16; the first request alone, then the rest, which
# adopt its prefix (3 requests x 8 tokens until the tp recurrent phase
# took their time)
PIPE_STREAM_REQUESTS, PIPE_STREAM_SHARED, PIPE_STREAM_TAIL = 2, 32, (1, 16)
PIPE_STREAM_TOKENS, PIPE_STREAM_CHUNK, PIPE_STREAM_MAX_LEN = 4, 16, 80
# the dense configs on the TensorBackend: (arch, layers served, None for
# all; prompt lengths; max_len; slots).  gemma2-2b's prompts of 4200-4400
# tokens wrap its local layers' 4096-key window, in waves of two slots (a
# prefill's [B, S, 256000] logits); qwen1.5-32b keeps 16 of its 64 layers
# (all 64 are 65 GB of bf16 weights); starcoder2-7b and pixtral-12b half
# of theirs (all until the mesh phases took their time)
DENSE_CONFIGS = (
    ("gemma2-2b", None, (4200, 4400, 4300, 4350), 4608, 2),
    ("starcoder2-7b", 16, PROMPT_LENS, MAX_LEN, SLOTS),
    ("qwen1.5-32b", 16, PROMPT_LENS, MAX_LEN, SLOTS),
    ("pixtral-12b", 20, PROMPT_LENS, MAX_LEN, SLOTS),
)
DENSE_TOKENS = 8                    # 16 until the mesh phases took their
                                    # time (starcoder2-7b's spec serve
                                    # needs more than spec_k tokens)
GEMMA_WINDOW, GEMMA_SOFTCAP, GEMMA_LEN = 4096, 50.0, 4608
# the mixers phase: granite-moe at full width and MOE_LAYERS of its 24
# layers (the llama serve's six prompts over four slots, MIXER_TOKENS
# tokens; its score; its planned pipeline, four requests of 16-32 tokens x
# 8; all 24 layers and 16 tokens until the mesh phases took their time:
# the mesh MoE runs all 24); kimi-k2 at full width and 1 of its 61
# layers (one layer's 384 experts are 34 GB of bf16, two layers would not
# leave room for a cache on an 80 GB card), four prompts of 16-256 tokens
# x 8; xlstm-1.3b at full width and XLSTM_LAYERS layers, the six prompts
# and one of 2100 tokens x MIXER_TOKENS, its planned pipeline as granite-moe's; its
# parallel prefill held to its own recurrence over a 128-token prompt
MOE_ARCH, KIMI_ARCH, XLSTM_ARCH = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                                   "xlstm-1.3b")
# (MIXER_TOKENS 8 until the train mesh phase took its time)
MIXER_TOKENS, MIXER_PIPE_REQUESTS = 4, 4
MOE_LAYERS = 12
KIMI_LAYERS, KIMI_PROMPT_LENS, KIMI_TOKENS = 1, (16, 64, 128, 256), 8
XLSTM_PROMPT_LENS = PROMPT_LENS + (2100,)
# xlstm-1.3b's depth in the mixers phase: 8 of its 48 layers (one 8-block
# period, so the pipeline keeps whole periods; 24, then 16, until the mesh
# phases took their time), a sixth of its sLSTM loops (174 s of the script
# at full depth), which keeps the script inside its time limit; its float32
# block checks at the same depth (all 48 layers until then)
XLSTM_LAYERS = 8
XLSTM_RECURRENT_LEN = 128
# the reference's own parallel-equals-recurrent tolerance
# (tests/test_models.py::test_mlstm_parallel_equals_recurrent), float32
RECURRENT_TOL = dict(rtol=2e-4, atol=2e-4)
# train_loss's load-balance aux (MOE_LAYERS layers' Switch terms, ~1 each) through
# the kernels against impl="ref", in float32 weights: the two paths'
# hidden states differ by the attention's rounding, which can move a
# token's top expert (each move shifts a layer's term by about 1/8192 of
# an expert's share); 1% of the sum
AUX_RTOL = 1e-2
# the fleet phase: two paged replicas of llama2-7b (4 slots each) over one
# set of weights, bursty_trace's 24 requests (prompts of 8-48 tokens) with
# MAX_TOKENS greedy tokens each, fault free and with a crash of the second replica
FLEET_REQUESTS, FLEET_MAX_LEN, FLEET_POLICY = 24, 128, "edf"
FLEET_CRASH = "crash@decode_step:20"
LAUNCHER_ARGV = ["--arch", ARCH, "--impl", "cuda", "--cache-layout", "paged",
                 "--batch", "8", "--slots", "4", "--prompt-len", "64",
                 "--varlen", "--gen", str(MAX_TOKENS), "--max-len", "128",
                 "--policy", "edf", "--ttft-slo", "64", "--inject-faults",
                 "transient@decode_step:5x2", "--max-retries", "3"]
# the int8 KV cache and the chunked impl on llama2-7b's loaded weights: the
# llama serve's six prompts x KV8_TOKENS tokens over 4 slots at max_len 512 on both
# layouts, the paged one also with spec and streamed (4 requests sharing a
# 256-token prefix plus 16-64 tokens of their own, the prefix cache on,
# 16-token chunks); the chunked forward over 1 x 4096
KV8_TOKENS = 4                      # 16 until the mesh phases, 8 until the
                                    # train mesh phase took their time
KV8_STREAM_REQUESTS, KV8_STREAM_SHARED, KV8_STREAM_TAIL = 4, 256, (16, 64)
KV8_STREAM_CHUNK = 16
CHUNKED_LEN = 4096
# musicgen-large at full width and MUSICGEN_LAYERS of its 48 layers (MHA
# at 32 heads of 64, a 2048-word audio vocabulary; all 48 and 16 tokens
# until the mesh phases took their time): the six prompts x
# MUSICGEN_TOKENS on both
# layouts and with the int8 cache, its score over 2 x 4096 frontend
# embeddings, its planned pipeline in float32; pixtral-12b's score over
# 1 x 1024 of its vision stub's embeddings
MUSICGEN = "musicgen-large"
# (MUSICGEN_TOKENS 8 until the train mesh phase took its time)
MUSICGEN_TOKENS, MUSICGEN_LAYERS = 4, 24
PIXTRAL_FRONTEND_LEN = 1024
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


def sets_past_l2(set_bytes):
    """Input sets of ``set_bytes`` bytes of K/V each that together exceed
    the L2 (50 MB) fourfold, so that each timed call reads its cache cold
    from device memory, as each layer does on the main path."""
    return max(4, -(-200_000_000 // set_bytes))


def d256_instances(logs):
    """Print the registers and spills of every kernel instance built with a
    template argument of 256: the flash kernel's D=256 instances (the
    paged and ring kernels take D at run time, so their D=256 calls run
    the instances the build lines above list by row count)."""
    import re
    for source, log in logs.items():
        name = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
                continue
            if name is None or "256" not in re.findall(r"Li(\d+)E", name):
                continue
            if "spill" in line or "registers" in line:
                kernel = re.search(r"\d+(\w+?_kernel)I", name)
                args = re.findall(r"Li(\d+)E", name)
                print(f"build: D=256 {source} "
                      f"{kernel.group(1) if kernel else name[:40]}"
                      f"<{', '.join(args)}>: {line.strip()}")


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
    # the dense configs' groups: starcoder2-7b's 9 query heads a K/V head
    # (9 rows at KQ=1; 36 at KQ=4, three blocks of 16, 16 and 4 rows whose
    # boundaries fall inside a draft token's group), qwen1.5-32b's MHA at
    # 40 heads, gemma2-2b's D=256 with softcap 50 over a wrapped 4096-key
    # window
    ("starcoder2-7b g=9", (4, 36, 4, 128, 16, 32, (512, 300, 17, 129), 1),
     {}),
    ("starcoder2-7b g=9 KQ=4, rows 16 + 16 + 4",
     (4, 36, 4, 128, 16, 32, (509, 300, 17, 129), 4), {}),
    ("qwen1.5-32b g=1 H=KH=40", (4, 40, 40, 128, 16, 32,
                                 (512, 300, 17, 129), 1), {}),
    (f"gemma2-2b g=2 D=256 softcap {GEMMA_SOFTCAP:g} window {GEMMA_WINDOW}, "
     f"slot 0 wrapped at {GEMMA_LEN - 8}",
     (2, 8, 4, 256, 16, GEMMA_WINDOW // 16, (4096, 700), 1),
     dict(window=GEMMA_WINDOW, softcap=GEMMA_SOFTCAP, last=GEMMA_LEN - 8)),
    # the MoE configs' groups: granite-moe's 2 query heads a K/V head at
    # D=64, kimi-k2's 64 query heads over 8 K/V heads at D=128
    ("granite-moe g=2 D=64", (4, 16, 8, 64, 16, 32, (512, 300, 17, 129), 1),
     {}),
    ("kimi-k2 g=8 H=64 D=128", (4, 64, 8, 128, 16, 32, (264, 136, 72, 24),
                                1), {}),
    # musicgen-large's MHA at 32 heads of 64: 4 slots x 512 keys
    ("musicgen-large g=1 H=KH=32 D=64",
     (4, 32, 32, 64, 16, 32, (512, 300, 17, 129), 1), {}),
]
# row i of a KQ=4 call must equal the KQ=1 call at pos + i, bit for bit
VERIFY_DECODE_CASES = ("llama2-7b g=1 KQ=4", "qwen3-0.6b g=2 KQ=4 softcap",
                       "starcoder2-7b g=9 KQ=4, rows 16 + 16 + 4")

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
    # gemma2-2b's local layers: D=256, softcap 50, a 4096-key window ring
    # wrapped by a 4600-token context (row 0)
    (f"gemma2-2b g=2 D=256 softcap {GEMMA_SOFTCAP:g} window {GEMMA_WINDOW}, "
     f"row 0 wrapped", (2, 8, 4, 256, GEMMA_WINDOW, (4096, 700)),
     dict(window=GEMMA_WINDOW, softcap=GEMMA_SOFTCAP)),
    # granite-moe's contiguous serve: g=2 at D=64 over 512-key rings
    ("granite-moe g=2 D=64 C=512 per-row",
     (4, 16, 8, 64, 512, (512, 300, 17, 129)), {}),
    # musicgen-large's contiguous serve (bf16 rings, or int8 rings
    # dequantized): MHA at 32 heads of 64 over 512-key rings
    ("musicgen-large g=1 H=KH=32 D=64 C=512 per-row",
     (4, 32, 32, 64, 512, (512, 300, 17, 129)), {}),
]
# the ring position a case with this window has wrapped to
RING_WRAP = {50: 200, 40: 1000, HYBRID_WINDOW: 2130,
             GEMMA_WINDOW: GEMMA_LEN - 8}


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
    # gemma2-2b's score: 1 x 4608 at D=256, softcap 50, on a local layer
    # (window 4096) and a global one
    *((f"gemma2-2b score {kind} softcap {GEMMA_SOFTCAP:g}",
       (1, GEMMA_LEN, 8, 4, 256), dict(window=w, softcap=GEMMA_SOFTCAP))
      for kind, w in ((f"local window {GEMMA_WINDOW}", GEMMA_WINDOW),
                      ("global", None))),
    # granite-moe's score: 2 x 4096 at D=64, GQA group 2
    ("granite-moe score D=64", (SCORE_BATCH, SCORE_LEN, 16, 8, 64), {}),
    # musicgen-large's score: MHA at 32 heads of 64, causal
    ("musicgen-large score D=64", (1, SCORE_LEN, 32, 32, 64), {}),
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

    def dead(name):
        return (1,) if name.startswith("fully masked") else ()

    def case(i):
        name, shape, opts = RING_CASES[i]
        return ring_case(*shape, seed=300 + i, dead=dead(name),
                         wrap_pos=RING_WRAP.get(opts.get("window")))
    cases = drawn(case, len(RING_CASES))     # each drawn once, for both dtypes
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for i, (name, shape, opts) in enumerate(RING_CASES):
            x = to_device(cases[i], dtype)
            got, err, extra = compare(name, da.decode_attention,
                                      da.decode_attention_plain, x, opts,
                                      dtype, dead(name))
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


def scan_inputs(b, s, r, seed, h0=True, offset=0):
    """Seeded scan inputs on the card: log_a = -|N(0, 1)|, b = N(0, 1).
    ``offset`` floats: log_a and b are contiguous views that far into a
    buffer of their own, so a base may miss 16-byte alignment."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)

    def at_offset(t):
        if not offset:
            return t
        buf = torch.empty(t.numel() + offset, device=DEVICE)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        return view
    x = dict(log_a=at_offset(-torch.randn((b, s, r), generator=gen,
                                          device=DEVICE).abs()),
             b=at_offset(torch.randn((b, s, r), generator=gen,
                                     device=DEVICE)))
    x["h0"] = torch.randn((b, r), generator=gen, device=DEVICE) if h0 \
        else None
    return x


# the scan's checks, (B, S, R, h0, offset): the serve's width, a ragged
# strip (200) and R % 4 != 0 (199: the kernel's 4-byte copies), each at
# S = 1, 7 and 4096, with and without h0; then bases one float past 16-byte
# alignment (the 4-byte copies at R % 4 == 0); last, three stages of ring
# (S = 150: 48 KB, which with the barriers needs the shared-memory opt-in)
RGLRU_CASES = [(4, s, r, h0, 0) for r in (2560, 200, 199)
               for s in (1, 7, 4096) for h0 in (True, False)] + [
    (4, 300, 2560, True, 1), (4, 4096, 2560, False, 1), (2, 33, 256, True, 1),
    (2, 150, 2560, True, 0)]
# left pads (R, offset): at the serve's width, at R % 4 != 0, and misaligned
RGLRU_PAD_CASES = [(2560, 0), (199, 0), (2560, 1)]
RGLRU_PADS = (0, 37, 150, 299)


def rglru_case_inputs(i):
    b, s, r, h0, offset = RGLRU_CASES[i]
    return scan_inputs(b, s, r, seed=500 + i, h0=h0, offset=offset)


def rglru_pad_inputs(k):
    """A masked prefill's left pads, RGLRU_PADS steps in rows 0-3 of
    4 x 300 x R (``RGLRU_PAD_CASES[k]``): log_a = 0, b = 0."""
    r, offset = RGLRU_PAD_CASES[k]
    x = scan_inputs(4, 300, r, seed=520 + 20 * k, offset=offset)
    for row, p in enumerate(RGLRU_PADS):
        x["log_a"][row, :p] = 0.0
        x["b"][row, :p] = 0.0
    return x


def plan_note(rs, x):
    """The scan kernel's plan for inputs ``x``: strips, stages and steps,
    copy width and copy warps."""
    from repro_torch.kernels._launch import sm_count
    plan = rs.scan_plan(x["log_a"].shape, x["log_a"].data_ptr() % 16 == 0
                        and x["b"].data_ptr() % 16 == 0,
                        sm_count(x["log_a"].device))
    return (f"plan {plan.grid[0]} strips x {plan.grid[1]} slots, "
            f"{plan.stages} stages of {plan.steps} steps "
            f"({plan.smem_bytes // 1024} KB), {4 * plan.vec}-byte copies "
            f"by {plan.copy_warps} copy warps")


def check_rglru(rs):
    """The scan kernel against its plain version in float32 at the serve's
    width, ragged ones and misaligned bases, and left-pad identity steps
    exact; returns the largest error."""
    worst = 0.0
    for i, (b, s, r, h0, offset) in enumerate(RGLRU_CASES):
        x = rglru_case_inputs(i)
        name = (f"B={b} S={s} R={r} h0={'yes' if h0 else 'none'}"
                + (f" base +{offset} float" if offset else ""))
        _, err, _ = compare(name, rs.rglru_scan, rs.rglru_scan_plain, x, {},
                            torch.float32, tol=SCAN_TOL)
        worst = max(worst, err)
        print(f"kernels: rglru_scan {name}: max abs err {err:.3g} "
              f"(rtol/atol {SCAN_TOL['rtol']:.3g}); {plan_note(rs, x)}")
    # a masked prefill's left pads: log_a = 0, b = 0 leave h bit for bit,
    # and the rest equals the scan of the unpadded rows from the same h0
    for k, (r, offset) in enumerate(RGLRU_PAD_CASES):
        x = rglru_pad_inputs(k)
        name = f"B=4 S=300 R={r}" + (f" base +{offset} float" if offset
                                     else "")
        _, err, _ = compare(f"left pads {name}", rs.rglru_scan,
                            rs.rglru_scan_plain, x, {}, torch.float32,
                            tol=SCAN_TOL)
        worst = max(worst, err)
        got = rs.rglru_scan(**x)
        for row, p in enumerate(RGLRU_PADS):
            h0 = x["h0"][row:row + 1]
            rest = rs.rglru_scan(x["log_a"][row:row + 1, p:].contiguous(),
                                 x["b"][row:row + 1, p:].contiguous(), h0)
            if not torch.equal(got[row, :p], h0.expand(p, -1)) \
                    or not torch.equal(got[row:row + 1, p:], rest):
                raise AssertionError(f"rglru_scan {name}: {p} left pad "
                                     f"steps of row {row} are not the "
                                     f"identity, bit for bit")
        print(f"kernels: rglru_scan {name} left pads {list(RGLRU_PADS)}: "
              f"max abs err {err:.3g}; pad steps keep h0 bit for bit and "
              f"the rest equals the unpadded scan bit for bit; "
              f"{plan_note(rs, x)}")
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


def drawn(case, n_sets):
    """``case(i)`` for i < ``n_sets``, drawn in threads: numpy's generators
    release the GIL while they fill an array, and one set of a 4096-key
    ring takes seconds on one core.  Each case seeds its own generator,
    so the sets are those of a loop."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(min(n_sets, 8)) as pool:
        return list(pool.map(case, range(n_sets)))


def paged_sets(kq, max_len=MAX_LEN, n_sets=4, slots=SLOTS,
               heads=(32, 32, 128)):
    """``n_sets`` seeded bf16 inputs of paged_attention at a paged serve's
    shapes: ``slots`` slots with ``max_len`` keys each, ``kq`` query tokens
    per slot, heads (H, KH, D); by default llama2-7b's, 4 x 34 MB or more
    of K/V, past the L2."""
    from paged_cases import paged_case
    h, kh, d = heads
    cases = drawn(lambda i: paged_case(slots, h, kh, d, BLOCK_SIZE,
                                       max_len // BLOCK_SIZE,
                                       (max_len - kq + 1,) * slots, kq,
                                       seed=200 + i), n_sets)
    return [to_device(case, torch.bfloat16) for case in cases]


def time_paged(pa, card, kq, max_len=MAX_LEN, slots=SLOTS, n_sets=4,
               heads=(32, 32, 128), window=None, softcap=None):
    """paged_attention on :func:`paged_sets`: by default the paged serve's
    4 slots x 512 keys of llama2-7b.  With a softcap sdpa, which applies
    none, is timed beside it (:func:`library_times`)."""
    import torch.nn.functional as F

    sets = paged_sets(kq, max_len, n_sets, slots, heads)
    opts = {k: v for k, v in (("window", window), ("softcap", softcap))
            if v is not None}
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
        if window is not None:
            mask &= kp > qpos[..., None] - window
        lib.append((q4.transpose(1, 2).contiguous(), k.contiguous(),
                    v.contiguous(), mask[:, None]))
    err = max(compare(f"paged_attention timing set {i} KQ={kq}",
                      pa.paged_attention, pa.paged_attention_plain, x, opts,
                      torch.bfloat16)[1] for i, x in enumerate(sets))
    ms = time_ms(lambda i: pa.paged_attention(**sets[i], **opts), n_sets)
    plain_ms = time_ms(lambda i: pa.paged_attention_plain(**sets[i], **opts),
                       n_sets, iters=20, graph=False)
    library_ms = time_ms(
        lambda i: F.scaled_dot_product_attention(
            lib[i][0], lib[i][1], lib[i][2], attn_mask=lib[i][3],
            enable_gqa=lib[i][1].shape[1] != lib[i][0].shape[1]), n_sets)
    # the least work: read q, each valid key and value once, the slots'
    # key_pos, the table and pos; write the output
    x = sets[0]
    h, d = x["q"].shape[-2:]
    kh, item = x["k_pool"].shape[2], x["k_pool"].element_size()
    n_keys = int(lib[0][3][:, :, -1].sum())   # the keys the last row sees
    n_bytes = (2 * x["q"].numel() * item + n_keys * kh * d * 2 * item
               + x["key_pos"].numel() * 4 + x["bt"].numel() * 4 + slots * 4)
    n_ops = n_keys * kq * h * 4 * d
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **library_times(library_ms, softcap),
                splits=table_splits(pa, x), **bound(n_bytes, n_ops, card))


def library_times(sdpa_ms, softcap):
    """``library_ms``: sdpa's time where it computes the kernel's function;
    with a softcap it does not (sdpa applies none), so ``library_ms`` is
    None and its time is kept as ``sdpa_no_softcap_ms``."""
    if softcap is None:
        return dict(library_ms=sdpa_ms)
    return dict(library_ms=None, sdpa_no_softcap_ms=sdpa_ms)


def decode_sets(n_valid, heads=(32, 32, 128), c=CONTIGUOUS_MAX_LEN,
                n_sets=3, slots=SLOTS, wrap_pos=None):
    """``n_sets`` seeded bf16 inputs of decode_attention at a contiguous
    serve's shapes: ``slots`` slots with a ``c``-key ring each, ``n_valid``
    keys filled; by default 4 slots, llama2-7b's heads (H, KH, D) and
    4096-key ring.  ``wrap_pos``: every slot's ring has wrapped, decoding
    at that position."""
    from paged_cases import ring_case
    h, kh, d = heads

    def case(i):
        if wrap_pos is None:
            return ring_case(slots, h, kh, d, c, (n_valid,) * slots,
                             seed=400 + i)
        case = ring_case(slots, h, kh, d, c, c, seed=400 + i,
                         wrap_pos=wrap_pos)
        case["key_pos"] = np.tile(case["key_pos"], (slots, 1))
        case["pos"] = np.full(slots, wrap_pos, np.int32)
        return case
    return [to_device(x, torch.bfloat16) for x in drawn(case, n_sets)]


def time_decode(da, card, n_valid, heads=(32, 32, 128),
                c=CONTIGUOUS_MAX_LEN, n_sets=3, slots=SLOTS, window=None,
                softcap=None, wrap_pos=None):
    """decode_attention on :func:`decode_sets`; ``n_sets`` input sets
    together exceed the L2.  With a softcap sdpa, which applies none, is
    timed beside it (:func:`library_times`)."""
    import torch.nn.functional as F

    h, kh, d = heads
    sets = decode_sets(n_valid, heads, c, n_sets, slots, wrap_pos)
    opts = {k: v for k, v in (("window", window), ("softcap", softcap))
            if v is not None}
    lib = []
    for x in sets:
        kp, qpos = x["key_pos"], x["pos"][:, None]
        mask = (kp >= 0) & (kp <= qpos)                          # [B, C]
        if window is not None:
            mask &= kp > qpos - window
        lib.append((x["q"][:, :, None], x["k_cache"].transpose(1, 2)
                    .contiguous(), x["v_cache"].transpose(1, 2).contiguous(),
                    mask[:, None, None]))
    err = max(compare(f"decode_attention timing set {i} {n_valid} keys "
                      f"H={h} KH={kh} D={d}", da.decode_attention,
                      da.decode_attention_plain, x, opts, torch.bfloat16)[1]
              for i, x in enumerate(sets))
    ms = time_ms(lambda i: da.decode_attention(**sets[i], **opts), n_sets)
    plain_ms = time_ms(lambda i: da.decode_attention_plain(**sets[i],
                                                           **opts),
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
    n_keys = int(lib[0][3].sum())           # the keys the mask lets through
    n_bytes = (2 * x["q"].numel() * item + n_keys * kh * d * 2 * item
               + x["key_pos"].numel() * 4 + b * 4)
    n_ops = n_keys * h * 4 * d
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **library_times(library_ms, softcap),
                splits=ring_splits(da, x), **bound(n_bytes, n_ops, card))


def rglru_sets(b, s, r=2560):
    """Seeded scan inputs of ``b`` slots x ``s`` steps x ``r`` that together
    exceed the L2, so each timed call reads its inputs cold."""
    n_sets = max(1, -(-200_000_000 // (3 * b * s * r * 4)))
    return [scan_inputs(b, s, r, seed=600 + i) for i in range(n_sets)]


def time_rglru(rs, card, s, b=SLOTS, r=2560):
    """rglru_scan at the hybrid serve's wave (4 slots x ``s`` steps) or its
    score (``b`` = 2 x 4096) at ``r`` channels (2560, or a tensor-parallel
    process's share), float32.  No PyTorch call computes a linear
    recurrence, so there is no library time."""
    sets = rglru_sets(b, s, r)
    n_sets = len(sets)
    err = max(compare(f"rglru_scan timing set {i} B={b} S={s}",
                      rs.rglru_scan, rs.rglru_scan_plain, x, {},
                      torch.float32, tol=SCAN_TOL)[1]
              for i, x in enumerate(sets))
    ms = time_ms(lambda i: rs.rglru_scan(**sets[i]), n_sets, iters=50)
    plain_ms = time_ms(lambda i: rs.rglru_scan_plain(**sets[i]), n_sets,
                       iters=2, warmup=1, graph=False)
    # the least work: read log_a, b and h0 once, write h; exp, * and + per
    # element
    n_bytes = (3 * b * s * r + b * r) * 4
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                plan=plan_note(rs, sets[0]),
                **bound(n_bytes, 3 * b * s * r, card, PEAK_F32))


def flash_sets(b, s, heads, n_sets, dtype=torch.bfloat16):
    """``n_sets`` seeded input sets of flash_attention in ``dtype`` at
    [B, S] and heads (H, KH, D)."""
    h, kh, d = heads
    return [flash_inputs(b, s, h, kh, d, seed=800 + i, dtype=dtype)
            for i in range(n_sets)]


def time_flash(fa, card, heads=(32, 32, 128), window=None, n_sets=2, b=1,
               s=SCORE_LEN, softcap=None, dtype=torch.bfloat16):
    """flash_attention in ``dtype`` (bf16 by default) at [B, S] tokens, by
    default a score phase's shape per sequence (1 x 4096) and llama2-7b's
    heads (H, KH, D), causal.  ``n_sets`` input sets together exceed the
    L2.  With a softcap sdpa, which applies none, is timed beside it
    (:func:`library_times`).  The float32 instance's bound takes the
    float32 peak outside the tensor cores."""
    import torch.nn.functional as F
    from flash_reference import flash_attention_f64
    h, kh, d = heads
    sets = flash_sets(b, s, heads, n_sets, dtype)
    opts = dict(window=window, softcap=softcap)
    err = max(compare(f"flash_attention timing set {i} H={h} KH={kh} D={d}",
                      fa.flash_attention, fa.flash_attention_plain, x,
                      opts, dtype, exact=flash_attention_f64)[1]
              for i, x in enumerate(sets))
    lib = [{n: t.transpose(1, 2).contiguous() for n, t in x.items()}
           for x in sets]
    pos = torch.arange(s, device=DEVICE)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    ms = time_ms(lambda i: fa.flash_attention(**sets[i], **opts),
                 n_sets, iters=20, warmup=2)
    plain_ms = time_ms(
        lambda i: fa.flash_attention_plain(**sets[i], **opts), n_sets,
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
                **library_times(library_ms, softcap),
                tiles=(masked, walked - masked),
                tile_shape=(plan.rows, plan.keys),
                **bound(n_bytes, 4 * b * h * d * n_pairs, card,
                        PEAK_F32 if dtype == torch.float32 else PEAK_BF16))


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
    if t.get("sdpa_no_softcap_ms") is not None:
        print(f"kernels: {name} at {shape}: sdpa on the same inputs without "
              f"the softcap (no library call applies one) "
              f"{t['sdpa_no_softcap_ms']:.4f} ms")
    if "tiles" in t:
        print(f"kernels: {name} at {shape}: blocks of {t['tile_shape'][0]} "
              f"rows walk {t['tiles'][0]} masked and {t['tiles'][1]} "
              f"unmasked key tiles of {t['tile_shape'][1]}")
    if "plan" in t:
        print(f"kernels: {name} at {shape}: {t['plan']}")
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


def teacher_forced_verify(backend, prompts, tokens, n_tokens=MAX_TOKENS):
    """Verify logits [n_req, n_tokens, V]: each request's own tokens fed
    ``SPEC_K`` at a time through ``verify_step``, all accepted."""
    rows = []
    for wave, padded, lens in waves(prompts):
        slots = list(range(len(wave)))
        backend.prefill(slots, padded, lens)
        steps = []
        for t in range(0, n_tokens, SPEC_K):
            evs = backend.verify_step({
                s: np.asarray(tokens[i][t:t + SPEC_K], np.int32)
                for s, i in zip(slots, wave)})
            backend.accept({ev.slot: len(ev.logits) for ev in evs})
            steps.append(np.stack([ev.logits for ev in evs]))
        rows.append(np.concatenate(steps, axis=1))
        for s in slots:
            backend.free_slot(s)
    return np.concatenate(rows)


def compare_logits(what, got, card, sides=("cuda", "ref"), held=True):
    """``got`` maps each of the two ``sides`` to logits of one shape; the
    first must be finite and within ``LOGITS_ATOL`` of the second.  With
    ``held`` False the difference is measured and printed only."""
    (name_a, name_b), (a, b) = sides, (got[k] for k in sides)
    diff = np.abs(a - b)
    if not np.isfinite(a).all() or (held and diff.max() > LOGITS_ATOL):
        raise AssertionError(f"{what} logits {name_a} vs {name_b}: max abs "
                             f"diff {diff.max():.4g} > {LOGITS_ATOL} (mean "
                             f"{diff.mean():.3g}, |logits| max "
                             f"{np.abs(b).max():.3g})")
    agree = int((a.argmax(-1) == b.argmax(-1)).sum())
    bound = f"atol {LOGITS_ATOL}" if held else "measured, not held"
    print(f"serve: teacher-forced {what} logits {list(a.shape)}, "
          f"{name_a} vs {name_b} max abs diff {diff.max():.4g} (mean "
          f"{diff.mean():.3g}, |logits| max {np.abs(b).max():.3g}; "
          f"{bound}), argmax agreement "
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
    """A model at full width with random weights from SEED (by default
    llama2-7b), at full depth or its first ``n_layers`` layers, in its
    config's dtype or ``dtype``, and its requests."""

    def __init__(self, arch=ARCH, prompt_lens=PROMPT_LENS, n_layers=None,
                 dtype=None):
        import dataclasses

        from repro_torch.bridge import init_params
        from repro_torch.configs import get_config
        self.cfg = get_config(arch)
        if n_layers is not None:
            self.cfg = dataclasses.replace(self.cfg, n_layers=n_layers)
        if dtype is not None:
            self.cfg = dataclasses.replace(self.cfg, dtype=dtype)
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
                prefix_cache=False, n_slots=SLOTS, reports=None):
        """A TensorBackend whose ``attn_impl`` must be ``reports`` (by
        default ``impl``: a paged int8 cache under ``"cuda"`` reports
        ``"ref"``, its gather)."""
        from repro_torch.runtime import TensorBackend
        be = TensorBackend(self.cfg, self.params, n_slots=n_slots,
                           max_len=max_len, impl=impl, cache_layout=layout,
                           block_size=BLOCK_SIZE, device=DEVICE,
                           prefix_cache=prefix_cache)
        if be.info.attn_impl != (reports or impl):
            raise AssertionError(f"backend reports attn_impl="
                                 f"{be.info.attn_impl}, asked for {impl}")
        return be

    def with_config(self, **changes):
        """This model's weights and prompts under a changed config (the
        same tensors: no second copy of the weights)."""
        import copy
        import dataclasses
        other = copy.copy(self)
        other.cfg = dataclasses.replace(self.cfg, **changes)
        return other


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


def serve_spec(model, pa, da, card, paged_tokens, n_tokens=MAX_TOKENS,
               label="serve spec"):
    """Paged layout with speculative decoding: ``SPEC_K`` tokens per verify
    step from an oracle of the paged serve's tokens, corrupted at
    ``1 - ACCEPT_PROB`` per token; ``n_tokens`` greedy tokens a request."""
    from repro_torch.serving import LLM, SamplingParams
    from repro_torch.serving.spec import OracleDraft
    cfg = model.cfg
    be = model.backend("cuda")
    if not be.info.spec_decode:
        raise AssertionError("the paged backend reports spec_decode=False")
    clock = StepClock(be)
    sp = SamplingParams(max_tokens=n_tokens)

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
    print(f"{label}: {len(outs)} requests x {n_tokens} greedy tokens, "
          f"spec_k {SPEC_K}, oracle accept_prob {ACCEPT_PROB}: {steps} verify "
          f"steps ({at_k} at KQ={SPEC_K}), paged_attention launches "
          f"{launches} = {cfg.n_layers} layers x {steps} steps; drafts "
          f"accepted {st.spec_accepted}/{st.spec_drafted} "
          f"({st.spec_accepted / st.spec_drafted:.1%}), "
          f"{(total - len(outs)) / sum(clock.verify_slots):.2f} tokens per "
          f"slot and verify step (the first token of each request comes "
          f"from its prefill); greedy tokens equal to the paged serve's: "
          f"{same}/{total}")
    print(f"{label}: {clock.summary('verify')}, {total / wall:.1f} "
          f"tokens/s over {wall:.2f} s [{card}]")
    del spec, be, clock
    torch.cuda.empty_cache()

    got = {}
    for impl in ("cuda", "ref"):
        got[impl] = teacher_forced_verify(model.backend(impl), model.prompts,
                                          tokens, n_tokens)
        torch.cuda.empty_cache()
    compare_logits(f"{model.cfg.name} verify (KQ={SPEC_K})", got, card)
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
    """recurrentgemma-2b on both layouts: RG-LRU state per slot beside
    windowed rings of 2048 keys, then beside the attention layers' block
    pools."""
    from repro_torch.serving import LLM, SamplingParams
    cfg = model.cfg
    n_scan = sum(spec.kind == "rglru" for spec in cfg.layer_specs())
    n_attn = cfg.n_layers - n_scan
    result = {}
    for layout in ("contiguous", "paged"):
        t_phase = time.perf_counter()
        be = model.backend("cuda", layout, HYBRID_MAX_LEN)
        info = be.info
        if layout == "contiguous":
            print(f"serve hybrid: {HYBRID} {cfg.n_layers} layers ({n_scan} "
                  f"RG-LRU, {n_attn} local attention, window "
                  f"{HYBRID_WINDOW}), d_model {cfg.d_model}, "
                  f"{info.param_bytes / 1e9:.2f} GB of {cfg.dtype} weights "
                  f"from seed {SEED} in {model.init_s:.1f} s; max_len "
                  f"{HYBRID_MAX_LEN}, {info.cache_bytes / 2 ** 20:.1f} MiB "
                  f"of rings and state")
        else:
            pools = sum(c[k].numel() * c[k].element_size()
                        for c in be.caches if "k_pool" in c
                        for k in ("k_pool", "v_pool"))
            print(f"serve hybrid paged: max_len {HYBRID_MAX_LEN}, blocks of "
                  f"{BLOCK_SIZE}: a pool of {info.total_blocks} blocks "
                  f"({info.max_ctx_blocks} a slot at most) and the scratch "
                  f"block in each of {n_attn} attention layers, "
                  f"{pools / 2 ** 20:.1f} MiB of K/V, "
                  f"{info.cache_bytes / 2 ** 20:.1f} MiB with the tables and "
                  f"the RG-LRU state; spec_decode={info.spec_decode}, "
                  f"supports_extend={info.supports_extend}, prefix_caching="
                  f"{info.prefix_caching}")
            if info.spec_decode or info.supports_extend \
                    or info.prefix_caching:
                raise AssertionError("the paged hybrid advertises spec, "
                                     "extend or the prefix cache")
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
        scans = rs.rglru_scan.launches
        ring, paged = da.decode_attention.launches, pa.paged_attention.launches
        attends, other = (ring, paged) if layout == "contiguous" \
            else (paged, ring)
        kernel = "decode_attention" if layout == "contiguous" \
            else "paged_attention"
        idle = "paged_attention" if layout == "contiguous" \
            else "decode_attention"
        waves_, steps = len(clock.prefill_ms), len(clock.decode_ms)
        if scans != n_scan * waves_ or attends != n_attn * steps \
                or not scans or not attends or other:
            raise AssertionError(
                f"{layout}: rglru_scan launched {scans} times over {waves_} "
                f"prefill waves of {n_scan} RG-LRU layers, {kernel} "
                f"{attends} times over {steps} decode steps of {n_attn} "
                f"attention layers, {idle} {other} times")
        for o in outs:
            if o.n_generated != MAX_TOKENS or o.finish_reason != "length" \
                    or not all(0 <= t < cfg.vocab_size for t in o.tokens):
                raise AssertionError(f"request {o.uid}: {o.n_generated} "
                                     f"tokens, {o.finish_reason}")
        total = sum(o.n_generated for o in outs)
        label = "serve hybrid" if layout == "contiguous" \
            else "serve hybrid paged"
        print(f"{label}: {len(outs)} requests {list(HYBRID_PROMPT_LENS)} "
              f"prompt tokens x {MAX_TOKENS} greedy tokens over {SLOTS} "
              f"slots: {waves_} prefills, {steps} decode steps, "
              f"{llm.stats.preemptions} preemptions, rglru_scan launches "
              f"{scans} = {n_scan} layers x {waves_} waves, {kernel} "
              f"launches {attends} = {n_attn} layers x {steps} steps, {idle} "
              f"0")
        print(f"{label}: {clock.summary()}, {total / wall:.1f} tokens/s over "
              f"{wall:.2f} s [{card}]")
        device_share(label, f"{SLOTS} requests x 8 tokens",
                     lambda: llm.generate(model.prompts[:SLOTS],
                                          SamplingParams(max_tokens=8)), card)
        del llm, be, clock
        torch.cuda.empty_cache()
        result[layout] = dict(scans=scans, attends=attends,
                              tokens=[o.tokens for o in outs])

        # logits fed this serve's own tokens: cuda against ref on its
        # layout, and the paged layout's against the contiguous one's
        tokens = result[layout]["tokens"]
        got = {}
        sides = (("cuda", layout), ("ref", layout)) + (
            (("cuda", "contiguous"),) if layout == "paged" else ())
        for impl, lay in sides:
            got[f"{impl} {lay}"] = teacher_forced(
                model.backend(impl, lay, HYBRID_MAX_LEN), model.prompts,
                tokens)
            torch.cuda.empty_cache()
        if layout == "contiguous":
            compare_logits("hybrid decode", got, card,
                           sides=("cuda contiguous", "ref contiguous"))
        else:
            compare_logits("hybrid paged decode", got, card,
                           sides=("cuda paged", "ref paged"))
            compare_logits("hybrid paged decode", got, card,
                           sides=("cuda paged", "cuda contiguous"))
            same = sum(int(a == b) for t, u in zip(
                tokens, result["contiguous"]["tokens"]) for a, b in zip(t, u))
            print(f"serve hybrid paged: greedy tokens equal to the contiguous "
                  f"serve's: {same}/{len(outs) * MAX_TOKENS}")
        print(f"{label}: phase wall {time.perf_counter() - t_phase:.1f} s")
    return dict(scans=result["contiguous"]["scans"],
                attends=result["contiguous"]["attends"],
                paged_scans=result["paged"]["scans"],
                paged=result["paged"]["attends"])


def serve_layouts(model, kernels, card, label, max_len, slots, n_tokens):
    """Greedy serves of ``model``'s prompts x ``n_tokens`` over ``slots``
    on the paged and the contiguous layout with ``impl="cuda"``: the paged
    kernel or the ring kernel once a layer and decode step and the other
    kernels never, and the teacher-forced logits within ``LOGITS_ATOL`` of
    ``impl="ref"``.  Returns each layout's launches and tokens."""
    from repro_torch.serving import LLM, SamplingParams
    cfg = model.cfg
    out = {}
    for layout in ("paged", "contiguous"):
        be = model.backend("cuda", layout, max_len, n_slots=slots)
        kernel = "paged_attention" if layout == "paged" \
            else "decode_attention"
        clock = StepClock(be)
        llm = LLM.from_backend(be, seed=SEED)
        sp = SamplingParams(max_tokens=n_tokens)
        llm.generate([model.prompts[0][:16]], SamplingParams(max_tokens=2))
        clock.reset()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        outs = llm.generate(model.prompts, sp)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        steps = len(clock.decode_ms)
        want = {k: cfg.n_layers * steps if k == kernel else 0
                for k in kernels}
        if launches != want or not steps:
            raise AssertionError(f"{label} {layout}: launches {launches}, "
                                 f"expected {want}")
        for o in outs:
            if o.n_generated != n_tokens \
                    or not all(0 <= t < cfg.vocab_size for t in o.tokens):
                raise AssertionError(f"{label} request {o.uid}: "
                                     f"{o.n_generated} tokens")
        total = sum(o.n_generated for o in outs)
        print(f"{label} {layout}: {len(clock.prefill_ms)} prefills, "
              f"{steps} decode steps, {kernel} launches "
              f"{launches[kernel]} = {cfg.n_layers} layers x {steps} "
              f"steps, the other kernels 0; {clock.summary()}, "
              f"{total / wall:.1f} tokens/s over {wall:.2f} s [{card}]")
        del llm, be, clock
        torch.cuda.empty_cache()
        tokens = [o.tokens for o in outs]
        got = {}
        for impl in ("cuda", "ref"):
            got[impl] = teacher_forced(
                model.backend(impl, layout, max_len, n_slots=slots),
                model.prompts, tokens, slots, n_tokens)
            torch.cuda.empty_cache()
        compare_logits(f"{label} {layout} decode", got, card)
        del got
        out[layout] = dict(launches=launches[kernel], tokens=tokens)
    return out


def serve_dense(kernels, card):
    """The reference's dense configs on the TensorBackend, one model at a
    time at full width (DENSE_CONFIGS: gemma2-2b at full depth, the others
    cut), random weights from SEED: greedy serves on the paged and
    the contiguous layout, the paged kernel or the ring kernel once a
    layer and decode step and the other never, teacher-forced logits
    within ``LOGITS_ATOL`` of ``impl="ref"``; starcoder2-7b also with
    ``spec_k=4`` (36 verify rows a K/V head), gemma2-2b also scored over
    1 x 4608 tokens through the flash kernel, pixtral-12b over 1 x 1024 of
    its vision stub's float embeddings.  Returns each config's launches by
    kernel and path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    result = {}
    for arch, n_layers, lens, max_len, slots in DENSE_CONFIGS:
        t_model = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = Model(arch, lens, n_layers)
        cfg, full = model.cfg, get_config(arch)
        g = cfg.n_heads // cfg.n_kv_heads
        windows = sorted({str(s.window) for s in cfg.layer_specs()})
        cut = "" if n_layers is None else " (cut to fit one card)" \
            if arch == "qwen1.5-32b" else " (cut for the script's time)"
        print(f"dense {arch}: {cfg.n_layers} of {full.n_layers} layers{cut}"
              f", d_model {cfg.d_model}, H={cfg.n_heads} KH={cfg.n_kv_heads} "
              f"(g={g}) D={cfg.resolved_head_dim}, windows {windows}, "
              f"softcaps {cfg.attn_logit_softcap}/{cfg.final_logit_softcap}, "
              f"norm {cfg.norm}, qkv_bias {cfg.qkv_bias}, post_norm "
              f"{cfg.post_norm}, vocab {cfg.vocab_size}; weights from seed "
              f"{SEED} in {model.init_s:.1f} s; {len(lens)} requests of "
              f"{list(lens)} tokens x {DENSE_TOKENS} over {slots} slots, "
              f"max_len {max_len}")
        out = serve_layouts(model, kernels, card, f"dense {arch}", max_len,
                            slots, DENSE_TOKENS)
        if arch == "starcoder2-7b":
            out["spec"] = serve_spec(model, pa, da, card,
                                     out["paged"]["tokens"], DENSE_TOKENS,
                                     f"dense {arch} spec")["launches"]
        if arch == "gemma2-2b":
            out["score"] = score(model, kernels, card, 1, GEMMA_LEN)[
                "flash_attention"]
        if arch == "pixtral-12b":
            out["frontend"] = score(model, kernels, card, 1,
                                    PIXTRAL_FRONTEND_LEN,
                                    frontend=True)["flash_attention"]
        same = sum(int(a == b) for t, u in zip(out["paged"]["tokens"],
                                               out["contiguous"]["tokens"])
                   for a, b in zip(t, u))
        print(f"dense {arch}: greedy tokens of the paged serve equal to the "
              f"contiguous serve's: {same}/{len(lens) * DENSE_TOKENS}; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"GB; model wall {time.perf_counter() - t_model:.1f} s [{card}]")
        result[arch] = out
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return result


# --------------------------------------------------------------------------- #
# the int8 KV cache, the chunked impl, float inputs and musicgen-large
# --------------------------------------------------------------------------- #

KV_LEAVES = ("k", "v", "k_scale", "v_scale", "k_pool", "v_pool",
             "k_scale_pool", "v_scale_pool")


def kv_bytes_per_token(backend):
    """Bytes one cached token takes over every layer, summed from the
    backend's rings or pools (k, v and an int8 cache's scales) over the
    tokens they hold."""
    first = backend.caches[0]
    held = first["k_pool"].shape[:2] if "k_pool" in first \
        else first["k"].shape[:2]
    total = sum(c[k].numel() * c[k].element_size() for c in backend.caches
                for k in KV_LEAVES if k in c)
    return total / (held[0] * held[1])


def kv8_serve(model, kernels, card, label, layout, kernel, n_tokens,
              prompts=None, impl="cuda", reports=None, **serve_kw):
    """One greedy serve of ``prompts`` (the model's by default) x
    ``n_tokens`` over ``SLOTS`` slots at ``MAX_LEN`` under ``impl``
    (``attn_impl`` must be ``reports``, by default ``impl``; ``serve_kw``
    are ``LLM.from_backend``'s, ``draft`` a factory of draft sources):
    ``kernel`` launches once a layer and decode (or verify) step and every
    other kernel never (``kernel`` None: none launches).  Returns the
    outputs, the launches and the step clock."""
    from repro_torch.serving import LLM, SamplingParams
    cfg = model.cfg
    prompts = model.prompts if prompts is None else prompts
    be = model.backend(impl, layout, MAX_LEN, reports=reports)
    clock = StepClock(be)
    draft = serve_kw.pop("draft", None)

    def make():         # a fresh draft a serve: the oracle keys by uid
        if draft is not None:
            serve_kw["draft"] = draft()
        return LLM.from_backend(be, seed=SEED, **serve_kw)

    run_requests(make(), prompts[:1], SamplingParams(max_tokens=2))
    llm = make()
    clock.reset()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = run_requests(llm, prompts, SamplingParams(max_tokens=n_tokens))
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    steps = len(clock.decode_ms) + len(clock.verify_ms)
    want = {k: cfg.n_layers * steps if k == kernel else 0 for k in kernels}
    if launches != want or not steps:
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    what = "verify" if clock.verify_ms else "decode"
    total = sum(o.n_generated for o in outs)
    counts = "no kernel launched" if kernel is None else (
        f"{kernel} launches {launches[kernel]} = {cfg.n_layers} layers x "
        f"{steps} steps, the other kernels 0")
    print(f"{label}: {len(outs)} requests x {n_tokens} greedy tokens over "
          f"{SLOTS} slots, {len(clock.prefill_ms)} prefills, {steps} {what} "
          f"steps; {counts}; "
          f"{clock.summary(what)}, {total / wall:.1f} tokens/s over "
          f"{wall:.2f} s; {kv_bytes_per_token(be):,.0f} bytes of K/V a "
          f"cached token [{card}]")
    return outs, launches, llm


def serve_kvint8(model, kernels, card):
    """The int8 KV cache on llama2-7b's loaded weights (its config with
    ``kv_dtype="int8"``: no second copy of the weights), the llama serve's
    six prompts x ``KV8_TOKENS`` over 4 slots at max_len 512: contiguous,
    where ``impl="cuda"`` runs the ring kernel over the dequantized rings,
    once a layer and decode step; paged, where it reads by gather as the
    reference does (``attn_impl`` ``"ref"``, zero paged launches, one
    warning); paged with ``spec_k=4`` and an oracle draft at 0.75; paged
    streamed (the prefix cache, 16-token chunks over a shared 256-token
    prefix, through ``extend_cache``'s int8 branch).  Each serve's
    teacher-forced logits within ``LOGITS_ATOL`` of the int8 config under
    ``impl="ref"``; their distance to the bf16 cache's printed, not held;
    bytes a cached token from the tensors beside the bf16 cache's.
    Returns the ring kernel's launches."""
    import warnings

    from repro_torch.models import attention as A
    from repro_torch.serving.spec import OracleDraft
    t_phase = time.perf_counter()
    m8 = model.with_config(kv_dtype="int8")
    cfg = m8.cfg
    out = {}
    bf16 = kv_bytes_per_token(model.backend("cuda", "contiguous", MAX_LEN))
    torch.cuda.empty_cache()
    ring8 = kv_bytes_per_token(m8.backend("cuda", "contiguous", MAX_LEN))
    torch.cuda.empty_cache()
    want8 = cfg.n_layers * 2 * cfg.n_kv_heads * (cfg.resolved_head_dim + 4)
    itemsize = getattr(torch, cfg.dtype).itemsize
    if ring8 != want8 or bf16 != cfg.n_layers * 2 * cfg.kv_dim * itemsize:
        raise AssertionError(f"kvint8: {ring8} and {bf16} bytes a token")
    print(f"kvint8 {cfg.name}: {ring8:,.0f} bytes of K/V a cached token "
          f"(int8 k/v and float32 scales, summed from the rings) against "
          f"{bf16:,.0f} in {cfg.dtype}: x{ring8 / bf16:.3f}")

    def held(label, layout, tokens, reports, n_tokens=KV8_TOKENS,
             verify=False):
        got = {}
        for side, m, impl in (("cuda", m8, "cuda"), ("ref", m8, "ref"),
                              ("bf16 cache", model, "cuda")):
            be = m.backend(impl, layout, MAX_LEN,
                           reports=reports if m is m8 and impl == "cuda"
                           else None)
            got[side] = teacher_forced_verify(be, m.prompts, tokens,
                                              n_tokens) if verify else \
                teacher_forced(be, m.prompts, tokens, SLOTS, n_tokens)
            del be
            torch.cuda.empty_cache()
        compare_logits(f"{label} int8", got, card)
        compare_logits(f"{label} int8 against the bf16 cache", got, card,
                       sides=("cuda", "bf16 cache"), held=False)

    outs, launches, _ = kv8_serve(m8, kernels, card,
                                  "kvint8 contiguous", "contiguous",
                                  "decode_attention", KV8_TOKENS)
    out["contiguous"] = launches["decode_attention"]
    held("kvint8 contiguous", "contiguous", [o.tokens for o in outs], None)

    A._INT8_CUDA_NOTED = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs, _, llm = kv8_serve(m8, kernels, card, "kvint8 paged", "paged",
                                 None, KV8_TOKENS, reports="ref")
        paged_tokens = [o.tokens for o in outs]
        pool8 = kv_bytes_per_token(llm.backend)
        del llm
        held("kvint8 paged", "paged", paged_tokens, "ref")

        def oracle():
            return OracleDraft(dict(enumerate(paged_tokens)),
                               accept_prob=ACCEPT_PROB, seed=SEED,
                               vocab_size=cfg.vocab_size)
        outs, _, llm = kv8_serve(m8, kernels, card, "kvint8 paged spec",
                                 "paged", None, KV8_TOKENS, reports="ref",
                                 spec_k=SPEC_K, draft=oracle)
        st = llm.stats
        if not 0 < st.spec_accepted < st.spec_drafted:
            raise AssertionError(f"kvint8 paged spec: drafts accepted "
                                 f"{st.spec_accepted}/{st.spec_drafted}: no "
                                 f"rollback ran")
        same = sum(int(a == b) for o, u in zip(outs, paged_tokens)
                   for a, b in zip(o.tokens, u))
        print(f"kvint8 paged spec: drafts accepted {st.spec_accepted}/"
              f"{st.spec_drafted}; greedy tokens equal to the plain paged "
              f"serve's: {same}/{len(outs) * KV8_TOKENS} (bf16 verify "
              f"rounds apart from decode)")
        del llm
        held("kvint8 paged spec", "paged", paged_tokens, "ref", verify=True)
        out["stream"] = kv8_streamed(m8, kernels, card)
    notes = [str(w.message) for w in caught
             if issubclass(w.category, RuntimeWarning)
             and "kv_dtype='int8'" in str(w.message)]
    if len(notes) != 1:
        raise AssertionError(f"kvint8: {len(notes)} gather warnings: {notes}")
    if pool8 != ring8:
        raise AssertionError(f"kvint8: the pool's {pool8} bytes a token, the "
                             f"ring's {ring8}")
    print(f"kvint8 paged: attn_impl 'ref', 0 paged_attention launches; the "
          f"warning, once: {notes[0]}")
    print(f"kvint8: phase wall {time.perf_counter() - t_phase:.1f} s")
    return out


def kv8_streamed(m8, kernels, card):
    """The int8 paged serve with streamed admission: ``KV8_STREAM_REQUESTS``
    prompts sharing a ``KV8_STREAM_SHARED``-token prefix, the prefix cache
    on and chunks of ``KV8_STREAM_CHUNK``, the first request alone so the
    others can adopt its blocks; the first-token logits (each prompt's
    last chunk) and greedy tokens under ``impl="cuda"`` and ``"ref"``."""
    rng = np.random.default_rng(SEED + 2)
    shared = rng.integers(0, m8.cfg.vocab_size, KV8_STREAM_SHARED)
    prompts = [np.concatenate([shared, rng.integers(0, m8.cfg.vocab_size, n)])
               .astype(np.int32) for n in rng.integers(
                   KV8_STREAM_TAIL[0], KV8_STREAM_TAIL[1] + 1,
                   KV8_STREAM_REQUESTS)]
    from repro_torch.serving import LLM, SamplingParams
    sp = SamplingParams(max_tokens=KV8_TOKENS)
    first, tokens = {}, {}
    for impl in ("cuda", "ref"):
        be = m8.backend(impl, "paged", MAX_LEN, prefix_cache=True,
                        reports="ref")
        seen = FirstLogits(be)
        clock = StepClock(be)
        llm = LLM.from_backend(be, seed=SEED, prefill_chunk=KV8_STREAM_CHUNK)
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        outs = llm.generate(prompts[:1], sp) + llm.generate(prompts[1:], sp)
        wall = time.perf_counter() - t0
        st = llm.stats
        if any(fn.launches for fn in kernels.values()) \
                or st.prefix_hits < KV8_STREAM_REQUESTS - 1 \
                or not st.prefill_chunks:
            counts = {k: f.launches for k, f in kernels.items()}
            raise AssertionError(f"kvint8 streamed {impl}: launches "
                                 f"{counts}, {st}")
        first[impl] = np.stack([seen.logits[seen.key(p)] for p in prompts])
        tokens[impl] = [o.tokens for o in outs]
        if impl == "cuda":
            print(f"kvint8 paged streamed: {len(prompts)} requests of "
                  f"{[len(p) for p in prompts]} tokens sharing "
                  f"{KV8_STREAM_SHARED} x {KV8_TOKENS}, the prefix cache on, "
                  f"chunks of {KV8_STREAM_CHUNK}: {st.prefix_hits} hits "
                  f"({st.prefix_hit_tokens} prompt tokens reused), "
                  f"{st.prefill_chunks} chunk passes, no kernel launched; "
                  f"ms per chunk call median "
                  f"{statistics.median(clock.chunk_ms):.3f}, "
                  f"{clock.summary()}, over {wall:.2f} s [{card}]")
        del llm, be, seen, clock
        torch.cuda.empty_cache()
    if tokens["cuda"] != tokens["ref"]:
        raise AssertionError("kvint8 streamed: cuda and ref tokens differ")
    compare_logits("kvint8 paged streamed first-token", {
        k: v[:, None] for k, v in first.items()}, card)
    return 0


def serve_chunked(model, kernels, card):
    """``impl="chunked"`` on llama2-7b's loaded weights: a contiguous serve
    of the six prompts x ``KV8_TOKENS`` (prefill by the online softmax
    over key blocks, decode by the dense sdpa: no kernel launches), its
    teacher-forced logits within ``LOGITS_ATOL`` of ``impl="ref"``; and
    ``forward(mode="train")`` over 1 x ``CHUNKED_LEN`` under both, held
    the same, with each one's peak memory and time."""
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    outs, _, llm = kv8_serve(model, kernels, card, "chunked contiguous",
                             "contiguous", None, KV8_TOKENS, impl="chunked")
    del llm
    torch.cuda.empty_cache()
    tokens = [o.tokens for o in outs]
    got = {impl: teacher_forced(model.backend(impl, "contiguous", MAX_LEN),
                                model.prompts, tokens, SLOTS, KV8_TOKENS)
           for impl in ("chunked", "ref")}
    compare_logits("chunked contiguous", got, card, sides=("chunked", "ref"))
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                      (1, CHUNKED_LEN))).to(DEVICE)
    logits, peak, secs = {}, {}, {}
    with torch.no_grad():
        for impl in ("chunked", "ref"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[impl] = T.forward(model.cfg, model.params, x,
                                     mode="train", impl=impl)[0][0].float()
            torch.cuda.synchronize()
            secs[impl] = time.perf_counter() - t0
            peak[impl] = torch.cuda.max_memory_allocated() - base
    diff = (logits["chunked"] - logits["ref"]).abs().max().item()
    if not bool(torch.isfinite(logits["chunked"]).all()) or diff > LOGITS_ATOL:
        raise AssertionError(f"chunked forward: max abs diff {diff:.4g}")
    print(f"chunked {model.cfg.name}: forward(mode='train') over 1 x "
          f"{CHUNKED_LEN}: chunked vs ref max abs diff {diff:.4g} (atol "
          f"{LOGITS_ATOL}); peak memory above the weights "
          f"{peak['chunked'] / 1e9:.2f} GB chunked, {peak['ref'] / 1e9:.2f} "
          f"GB ref; {secs['chunked'] * 1e3:.1f} ms chunked, "
          f"{secs['ref'] * 1e3:.1f} ms ref [{card}]")
    print(f"chunked: phase wall {time.perf_counter() - t_phase:.1f} s")
    del logits
    torch.cuda.empty_cache()


def serve_musicgen(kernels, card):
    """musicgen-large at full width and ``MUSICGEN_LAYERS`` of its 48
    layers, random weights from SEED:
    the six prompts (audio tokens below 2048) x ``MUSICGEN_TOKENS`` on both
    layouts (:func:`serve_layouts`), a contiguous int8 serve (the ring
    kernel over dequantized rings), the score over 2 x 4096 of its
    frontend's float embeddings (the flash kernel once a layer), then, in
    float32 weights, its planned stage pipeline, whose tokens must be bit
    for bit its TensorBackend's.  Returns the launches by path."""
    from repro_torch.training.adamw import tree_leaves
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(MUSICGEN, n_layers=MUSICGEN_LAYERS)
    cfg = model.cfg
    n_params = sum(t.numel() for t in tree_leaves(model.params))
    print(f"musicgen {MUSICGEN}: {cfg.n_layers} of 48 layers, d_model "
          f"{cfg.d_model}, H=KH={cfg.n_heads} D={cfg.resolved_head_dim}, "
          f"{cfg.pattern[0].mlp} MLP, {cfg.norm}, {cfg.pos_emb} positions, "
          f"vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B parameters "
          f"(param_count() {cfg.param_count() / 1e9:.3f} B,"
          f" which counts no layernorm bias), "
          f"{n_params * 2 / 1e9:.2f} GB of bf16 weights from seed {SEED} in "
          f"{model.init_s:.1f} s")
    out = serve_layouts(model, kernels, card, f"musicgen {MUSICGEN}",
                        MAX_LEN, SLOTS, MUSICGEN_TOKENS)
    out = {k: v["launches"] for k, v in out.items()}
    m8 = model.with_config(kv_dtype="int8")
    outs, launches, llm = kv8_serve(m8, kernels, card,
                                    f"musicgen {MUSICGEN} kvint8 contiguous",
                                    "contiguous", "decode_attention",
                                    MUSICGEN_TOKENS)
    out["kvint8"] = launches["decode_attention"]
    del llm
    got = {}
    for impl in ("cuda", "ref"):
        got[impl] = teacher_forced(m8.backend(impl, "contiguous", MAX_LEN),
                                   m8.prompts, [o.tokens for o in outs],
                                   SLOTS, MUSICGEN_TOKENS)
        torch.cuda.empty_cache()
    compare_logits(f"musicgen {MUSICGEN} kvint8 contiguous", got, card)
    out["score"] = score(model, kernels, card, frontend=True)[
        "flash_attention"]
    print(f"musicgen {MUSICGEN}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB in bf16")
    del model, m8, got
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(MUSICGEN, n_layers=MUSICGEN_LAYERS, dtype="float32")
    out["pipeline"] = mixer_pipeline(model, kernels, card,
                                     f"musicgen {MUSICGEN} float32",
                                     ("contiguous",),
                                     same_tokens=True)["contiguous"]
    print(f"musicgen {MUSICGEN}: model wall "
          f"{time.perf_counter() - t_model:.1f} s [{card}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# the mixers phase: the MoE and xLSTM configs
# --------------------------------------------------------------------------- #

class GroupSizeReads:
    """The MoE's host reads of its group sizes (``models/moe.py``'s
    ``_group_sizes``, once a layer call) while installed: the sizes read,
    and the host's wait in each on the host clock; per decode step of the
    backends it watches, how many and how long."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.own = moe, moe._group_sizes
        self.sizes, self.waits = [], []
        self.step_counts, self.step_waits = [], []

    def __enter__(self):
        self.moe._group_sizes = self._read
        return self

    def __exit__(self, *exc):
        self.moe._group_sizes = self.own

    def _read(self, ids, e):
        t0 = time.perf_counter()
        sizes = self.own(ids, e)
        self.waits.append((time.perf_counter() - t0) * 1e3)
        self.sizes.append(sizes)
        return sizes

    def watch(self, backend):
        inner = backend.decode_step

        def counted(feeds):
            n = len(self.waits)
            out = inner(feeds)
            if feeds:
                self.step_counts.append(len(self.waits) - n)
                self.step_waits.append(sum(self.waits[n:]))
            return out
        backend.decode_step = counted

    def reset(self):
        for log in (self.sizes, self.waits, self.step_counts,
                    self.step_waits):
            log.clear()

    def summary(self, step_ms):
        wait = statistics.median(self.step_waits)
        return (f"{sum(self.step_counts)} host reads of the MoE group sizes "
                f"in {len(self.step_counts)} decode steps "
                f"({sorted(set(self.step_counts))} a step), the host "
                f"waiting in them {wait:.3f} ms a step (median), "
                f"{wait / step_ms:.1%} of the step median {step_ms:.3f} ms")


def mixer_serve(model, kernels, card, label, layout, max_len, n_tokens,
                slots=SLOTS):
    """One greedy serve of ``model.prompts`` x ``n_tokens`` over ``slots``
    on ``layout`` through ``TensorBackend(impl="cuda")``: the paged or the
    ring kernel once per attention layer and decode step, every other
    kernel never (none at all for a model without attention).  Returns the
    tokens, the launches, the step clock and the MoE's reads."""
    from repro_torch.serving import LLM, SamplingParams
    cfg = model.cfg
    be = model.backend("cuda", layout, max_len, n_slots=slots)
    n_attn = sum(s.kind == "attn" for s in cfg.layer_specs())
    kernel = "paged_attention" if layout == "paged" and n_attn \
        else "decode_attention"
    clock = StepClock(be)
    llm = LLM.from_backend(be, seed=SEED)
    with GroupSizeReads() as reads:
        reads.watch(be)
        llm.generate([model.prompts[0][:16]], SamplingParams(max_tokens=2))
        clock.reset()
        reads.reset()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        outs = llm.generate(model.prompts,
                            SamplingParams(max_tokens=n_tokens))
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    steps = len(clock.decode_ms)
    want = {k: n_attn * steps if k == kernel else 0 for k in kernels}
    if launches != want or not steps:
        raise AssertionError(f"{label} {layout}: launches {launches}, "
                             f"expected {want}")
    for o in outs:
        if o.n_generated != n_tokens or o.finish_reason != "length" \
                or not all(0 <= t < cfg.vocab_size for t in o.tokens):
            raise AssertionError(f"{label} request {o.uid}: {o.n_generated}"
                                 f" tokens, {o.finish_reason}")
    total = sum(o.n_generated for o in outs)
    what = f"{kernel} launches {launches[kernel]} = {n_attn} attention " \
        f"layers x {steps} steps, the other kernels 0" if n_attn else \
        "no kernel launched (no attention layer)"
    print(f"{label} {layout}: {len(outs)} requests "
          f"{[len(p) for p in model.prompts]} prompt tokens x {n_tokens} "
          f"over {slots} slots: {len(clock.prefill_ms)} prefills, {steps} "
          f"decode steps, {what}; {clock.summary()}, {total / wall:.1f} "
          f"tokens/s over {wall:.2f} s [{card}]")
    return dict(tokens=[o.tokens for o in outs], launches=launches[kernel],
                clock=clock, reads=reads, llm=llm, be=be)


class RouteReplay:
    """The MoE router's expert choices of one run, replayed by a second.

    A top-k choice is discontinuous.  In bf16 the router's logits are
    rounded to 8 significant bits, so a token whose k-th and (k+1)-th
    logits round close trades its k-th expert on a one-ulp change upstream,
    and the kernels and ``impl="ref"`` differ upstream by their attention's
    rounding.  One trade moves the token's FFN output by an expert's share,
    and the later layers carry it to the logits.  So to hold the kernels'
    numerics to the ref path's, the second run takes the first run's
    choices, weighted by its own router's probabilities over them; the
    token routings its own choice would have changed are counted (and,
    with ``kept`` a list, its own choices kept there, a call each)."""

    def __init__(self, active=True):
        from repro_torch.models import moe
        self.moe, self.own = moe, moe.router_topk
        self.active, self.recorded, self.at = active, [], None
        self.tokens = self.changed = 0
        self.per_call = []
        self.kept = None

    def record(self):
        self.at = None

    def replay(self):
        self.at = 0

    def __enter__(self):
        if self.active:
            self.moe.router_topk = self._route
        return self

    def __exit__(self, *exc):
        self.moe.router_topk = self.own

    def _route(self, router_w, x, moe):
        probs, ids, aux = self.own(router_w, x, moe)
        if self.at is None:
            self.recorded.append(ids)
            return probs, ids, aux
        want = self.recorded[self.at]
        self.at += 1
        if want.shape != ids.shape:
            raise AssertionError(f"route replay: call {self.at} routes "
                                 f"{tuple(ids.shape)}, recorded "
                                 f"{tuple(want.shape)}")
        self.tokens += ids.shape[0]
        changed = int((ids.sort(-1).values != want.sort(-1).values)
                      .any(-1).sum())
        self.changed += changed
        self.per_call.append(changed)
        if self.kept is not None:
            self.kept.append(ids)
        full = torch.softmax((x @ router_w).float(), dim=-1)
        top = full.gather(-1, want)
        return (top / top.sum(-1, keepdim=True)).to(x.dtype), want, aux

    def summary(self):
        return (f"ref took the kernel run's expert choices: its own would "
                f"have changed {self.changed} of {self.tokens} token "
                f"routings ({self.changed / max(self.tokens, 1):.2%}; the "
                f"pad rows of left-padded waves, re-zeroed after each "
                f"block, included)")


def mixer_logits(model, card, label, layout, max_len, tokens, n_tokens,
                 slots=SLOTS, held=True):
    """Teacher-forced decode logits of ``impl="cuda"`` against
    ``impl="ref"`` on ``layout``, fed a serve's own tokens; an MoE model's
    ref run replays the cuda run's expert choices (:class:`RouteReplay`)."""
    got = {}
    moe = any(s.moe is not None for s in model.cfg.layer_specs())
    with RouteReplay(moe) as route:
        for impl in ("cuda", "ref"):
            route.record() if impl == "cuda" else route.replay()
            got[impl] = teacher_forced(model.backend(impl, layout, max_len,
                                                     n_slots=slots),
                                       model.prompts, tokens, slots,
                                       n_tokens)
            torch.cuda.empty_cache()
    compare_logits(f"{label} {layout} decode", got, card, held=held)
    if moe:
        print(f"{label} {layout}: {route.summary()}")


def mixer_pipeline(model, kernels, card, label, layouts, recurrent=False,
                   same_tokens=False):
    """``LLM.from_plan`` over the paper's testbed on each of ``layouts``:
    ``MIXER_PIPE_REQUESTS`` requests of 16-32 tokens x ``PIPE_TOKENS``; the
    decode kernel once per attention layer and fed token (none without
    attention); the logits that chose each token within ``LOGITS_ATOL`` of
    the contiguous TensorBackend's, fed the same tokens, or with
    ``recurrent`` of ``transformer.decode_step`` at one slot fed every
    token from a fresh state, the pipeline's own teacher forcing; with
    ``same_tokens``, its greedy tokens bit for bit the contiguous
    TensorBackend's serve of the same requests.  Returns each layout's
    launches."""
    from repro_torch.serving import LLM, SamplingParams
    cfg = model.cfg
    n_attn = sum(s.kind == "attn" for s in cfg.layer_specs())
    prompts = pipeline_prompts(cfg, MIXER_PIPE_REQUESTS)
    fed = sum(len(p) + PIPE_TOKENS - 1 for p in prompts)
    sp = SamplingParams(max_tokens=PIPE_TOKENS)
    out = {}
    for layout in layouts:
        t0 = time.perf_counter()
        llm = plan_pipeline(model, layout)
        be = llm.backend
        m = be.n_slots
        logits, tick = {}, be.decode_step

        def recorded(feeds, tick=tick, llm=llm):
            events = tick(feeds)
            for ev in events:
                uid = llm.batcher._slot_req[ev.slot].uid
                logits.setdefault(uid, []).append(ev.logits)
            return events

        be.decode_step = recorded
        for fn in kernels.values():
            fn.launches = 0
        ticks = be.state.tick
        t_serve = time.perf_counter()
        outs = run_requests(llm, prompts, sp)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t_serve
        ticks = be.state.tick - ticks
        launches = {n: fn.launches for n, fn in kernels.items()}
        kernel = "paged_attention" if layout == "paged" and n_attn \
            else "decode_attention"
        want = {n: n_attn * fed if n == kernel else 0 for n in kernels}
        if launches != want:
            raise AssertionError(f"{label} pipeline {layout}: launches "
                                 f"{launches}, expected {want}")
        tokens = [o.tokens for o in outs]
        got = np.stack([np.stack(logits[i]) for i in range(len(prompts))])
        print(f"{label} pipeline {layout}: LLM.from_plan(paper_testbed()) "
              f"{be.spec.n_stages} stages, periods "
              f"{be.spec.periods_per_stage}, {m} slots; "
              f"{len(prompts)} requests {[len(p) for p in prompts]} x "
              f"{PIPE_TOKENS}: {ticks} ticks in {serve_s:.2f} s "
              f"({serve_s / ticks * 1e3:.3f} ms a tick), {kernel} launches "
              f"{launches[kernel]} = {n_attn} attention layers x {fed} fed "
              f"tokens [{card}]")
        del llm, be, logits
        torch.cuda.empty_cache()
        if recurrent:
            ref = np.stack([decode_logits(model.cfg, model.params, p, t)
                            for p, t in zip(prompts, tokens)])
        else:
            ref = teacher_forced(
                model.backend("cuda", "contiguous", PIPE_MAX_LEN,
                              n_slots=len(prompts)),
                prompts, tokens, len(prompts), PIPE_TOKENS, first=True)
        other = "decode_step" if recurrent else "TensorBackend"
        compare_logits(f"{label} pipeline {layout}",
                       {"pipeline": got, other: ref}, card,
                       sides=("pipeline", other))
        if same_tokens:
            want = [o.tokens for o in run_requests(LLM.from_backend(
                model.backend("cuda", "contiguous", PIPE_MAX_LEN,
                              n_slots=len(prompts)), seed=SEED), prompts, sp)]
            if want != tokens:
                raise AssertionError(f"{label} pipeline {layout}: tokens "
                                     f"{tokens} != the TensorBackend's "
                                     f"{want}")
            print(f"{label} pipeline {layout}: greedy tokens bit for bit the "
                  f"contiguous TensorBackend's: "
                  f"{sum(map(len, tokens))}/{sum(map(len, want))}")
        print(f"{label} pipeline {layout}: phase wall "
              f"{time.perf_counter() - t0:.1f} s")
        out[layout] = launches[kernel]
        torch.cuda.empty_cache()
    return out


def serve_granite(kernels, card):
    """granite-moe-1b-a400m at full width, ``MOE_LAYERS`` of its 24
    attention layers, each with 32 experts top-8 (the MoE's host read of its group sizes once
    a layer call).  In bf16: serves on both layouts (launches, tokens, the
    reads, step times) and its score through the flash kernel at D=64,
    their logits against ``impl="ref"`` measured.  In float32 weights, the
    held checks: the teacher-forced logits and the score against
    ``impl="ref"``, ``train_loss``'s aux against ref's, and the planned
    pipeline on the contiguous layout against the TensorBackend.  In bf16
    the reference's init (an expert tensor scaled by ``1/sqrt(E)``, not by
    its fan-in) makes every layer amplify a difference upstream, and the
    kernels and the ref path differ upstream by their attention's
    rounding."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import SamplingParams
    from repro_torch.training.adamw import tree_leaves
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(MOE_ARCH, PROMPT_LENS, MOE_LAYERS)
    cfg = model.cfg
    moe = cfg.pattern[0].moe
    n_params = sum(t.numel() for t in tree_leaves(model.params))
    print(f"mixers {MOE_ARCH}: {cfg.n_layers} of 24 layers, d_model "
          f"{cfg.d_model}"
          f", H={cfg.n_heads} KH={cfg.n_kv_heads} D={cfg.resolved_head_dim},"
          f" {moe.num_experts} experts top-{moe.top_k} of width "
          f"{moe.d_expert}, vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B "
          f"parameters of {cfg.dtype} from seed {SEED} in "
          f"{model.init_s:.1f} s")
    out, served = {}, {}
    for layout in ("contiguous", "paged"):
        r = mixer_serve(model, kernels, card, f"mixers {MOE_ARCH}", layout,
                        MAX_LEN, MIXER_TOKENS)
        step = statistics.median(r["clock"].decode_ms)
        print(f"mixers {MOE_ARCH} {layout}: {r['reads'].summary(step)} "
              f"[{card}]")
        reads = r["reads"].step_counts
        if any(c != cfg.n_layers for c in reads):
            raise AssertionError(f"{MOE_ARCH}: group-size reads a step "
                                 f"{reads}, expected {cfg.n_layers}")
        if layout == "paged":
            device_share(f"mixers {MOE_ARCH} paged",
                         f"{SLOTS} requests x 8 tokens",
                         lambda llm=r["llm"]: llm.generate(
                             model.prompts[:SLOTS],
                             SamplingParams(max_tokens=8)), card)
        del r["llm"], r["be"]
        torch.cuda.empty_cache()
        mixer_logits(model, card, f"mixers {MOE_ARCH} bf16", layout, MAX_LEN,
                     r["tokens"], MIXER_TOKENS, held=False)
        out[layout] = r["launches"]
        served[layout] = r["tokens"]
    out["score"] = score(model, kernels, card, held=False)["flash_attention"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model
    gc.collect()
    torch.cuda.empty_cache()

    model = Model(MOE_ARCH, PROMPT_LENS, MOE_LAYERS, dtype="float32")
    for layout in ("contiguous", "paged"):
        mixer_logits(model, card, f"mixers {MOE_ARCH} float32", layout,
                     MAX_LEN, served[layout], MIXER_TOKENS)
    score(model, kernels, card)
    rng = np.random.default_rng(SEED + 1)
    tokens, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SCORE_BATCH, SCORE_LEN))).to(DEVICE)
        for _ in range(2))
    parts = {}
    with torch.no_grad():
        for impl in ("cuda", "ref"):
            _, parts[impl] = T.train_loss(model.cfg, model.params, tokens,
                                          labels, impl=impl)
    aux = {k: float(v["aux"]) for k, v in parts.items()}
    ce = {k: float(v["ce"]) for k, v in parts.items()}
    if not all(np.isfinite(list(aux.values()) + list(ce.values()))) \
            or abs(aux["cuda"] - aux["ref"]) > AUX_RTOL * abs(aux["ref"]):
        raise AssertionError(f"{MOE_ARCH} train_loss: aux {aux}, ce {ce}")
    print(f"mixers {MOE_ARCH} float32: train_loss over {SCORE_BATCH} x "
          f"{SCORE_LEN} tokens: aux cuda {aux['cuda']:.6g} ref "
          f"{aux['ref']:.6g} (rtol {AUX_RTOL}), ce cuda {ce['cuda']:.6g} "
          f"ref {ce['ref']:.6g} [{card}]")
    # the pipeline and the TensorBackend run other batch shapes, so no
    # run's expert choices can be replayed in the other (RouteReplay)
    out["pipeline"] = mixer_pipeline(model, kernels, card,
                                     f"mixers {MOE_ARCH} float32",
                                     ("contiguous",))["contiguous"]
    print(f"mixers {MOE_ARCH}: peak device memory {peak:.2f} GB in bf16; "
          f"model wall {time.perf_counter() - t_model:.1f} s [{card}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_kimi(kernels, card):
    """kimi-k2-1t-a32b at full width, 1 of its 61 layers: 64 query heads
    over 8 K/V heads at D=128, 384 experts top-8 beside the shared expert,
    its 163840-word vocabulary; paged, four slots."""
    from repro_torch.training.adamw import tree_leaves
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(KIMI_ARCH, KIMI_PROMPT_LENS, KIMI_LAYERS)
    cfg = model.cfg
    moe = cfg.pattern[0].moe
    n_params = sum(t.numel() for t in tree_leaves(model.params))
    print(f"mixers {KIMI_ARCH}: {cfg.n_layers} of 61 layers (one layer's "
          f"experts are {3 * moe.num_experts * cfg.d_model * moe.d_expert * 2 / 1e9:.1f}"
          f" GB of bf16), d_model {cfg.d_model}, H={cfg.n_heads} "
          f"KH={cfg.n_kv_heads} D={cfg.resolved_head_dim}, "
          f"{moe.num_experts} experts top-{moe.top_k} + "
          f"{moe.num_shared_experts} shared, vocab {cfg.vocab_size}: "
          f"{n_params / 1e9:.3f} B parameters of {cfg.dtype} from seed "
          f"{SEED} in {model.init_s:.1f} s")
    r = mixer_serve(model, kernels, card, f"mixers {KIMI_ARCH}", "paged",
                    MAX_LEN, KIMI_TOKENS)
    step = statistics.median(r["clock"].decode_ms)
    print(f"mixers {KIMI_ARCH} paged: {r['reads'].summary(step)} [{card}]")
    sizes = r["reads"].sizes
    used = [sum(1 for n in g if n) for g in sizes]
    rows = [sum(g) for g in sizes]
    print(f"mixers {KIMI_ARCH}: the dispatch over {moe.num_experts} experts: "
          f"{len(sizes)} MoE calls; experts with rows per call "
          f"{used[:6]}...{used[-2:]} for {rows[:6]}...{rows[-2:]} rows "
          f"(top-{moe.top_k} of each token); the largest group "
          f"{max(max(g) for g in sizes)} rows; the shared expert on every "
          f"row")
    del r["llm"], r["be"]
    torch.cuda.empty_cache()
    mixer_logits(model, card, f"mixers {KIMI_ARCH}", "paged", MAX_LEN,
                 r["tokens"], KIMI_TOKENS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"mixers {KIMI_ARCH}: peak device memory {peak:.2f} GB; model wall "
          f"{time.perf_counter() - t_model:.1f} s [{card}]")
    launches = r["launches"]
    del model, r
    gc.collect()
    torch.cuda.empty_cache()
    return dict(paged=launches)


def decode_logits(cfg, params, prompt, tokens=()):
    """Logits [len(tokens) + 1, V] (float32, numpy) of one slot fed
    ``prompt`` and then ``tokens[:-1]`` one ``transformer.decode_step`` a
    token from a fresh state: after the prompt's last token, then after
    each fed-back token."""
    from repro_torch.models import transformer as T
    dt = next(iter(params["final_norm"].values())).dtype
    feed = np.concatenate([prompt, np.asarray(tokens[:-1], prompt.dtype)])
    feed = torch.from_numpy(feed).to(DEVICE, torch.long)
    with torch.no_grad():
        caches = T.init_caches(cfg, 1, len(feed), dt, DEVICE)
        rows = [T.decode_step(cfg, params, feed[t:t + 1], caches)[0][0]
                for t in range(len(feed))]
    return torch.stack(rows[len(prompt) - 1:]).float().cpu().numpy()


def parallel_vs_recurrent(cfg, params, prompt):
    """The logits of ``prompt``'s parallel prefill against one recurrent
    decode step a token from a fresh state: the largest difference at the
    last position, and at every 16th position."""
    from repro_torch.models import transformer as T
    dt = next(iter(params["final_norm"].values())).dtype
    tokens = torch.from_numpy(prompt).to(DEVICE, torch.long)[None]
    with torch.no_grad():
        caches = T.init_caches(cfg, 1, len(prompt), dt, DEVICE)
        par, _ = T.forward(cfg, params, tokens, caches)
        caches = T.init_caches(cfg, 1, len(prompt), dt, DEVICE)
        rec = torch.stack([T.decode_step(cfg, params, tokens[:, t], caches)[0]
                           for t in range(len(prompt))], 1)
    diff = (par[0].float() - rec[0].float()).abs().amax(-1)
    if not bool(torch.isfinite(par).all() and torch.isfinite(rec).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    return diff[-1].item(), [round(v, 6) for v in diff[::16].tolist()]


def mlstm_blocks_parallel_vs_recurrent(cfg, params, prompt):
    """Every mLSTM block of the model on its own input (the hidden states
    the parallel forward hands it): the block's parallel form against its
    recurrence from a fresh state, token by token, within the reference's
    own ``RECURRENT_TOL`` (its ``test_mlstm_parallel_equals_recurrent``).
    Returns the blocks checked and the largest difference."""
    from repro_torch.models import kvcache as KV
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm
    from repro_torch.models.layers import apply_norm, embed_tokens
    tokens = torch.from_numpy(prompt).to(DEVICE, torch.long)[None]
    positions = torch.arange(len(prompt), dtype=torch.int32, device=DEVICE)
    worst, n = 0.0, 0
    with torch.no_grad():
        x = embed_tokens(params, cfg, tokens)
        for spec, p in zip(cfg.layer_specs(), params["layers"]):
            if spec.kind == "mlstm":
                h = apply_norm(p["norm1"], x, cfg.norm)
                par, _ = xlstm.apply_mlstm_seq(p["mixer"], cfg, h)
                state = KV.init_block_cache(cfg, spec, 1, len(prompt),
                                            h.dtype, DEVICE)
                rec = torch.cat([xlstm.apply_mlstm_decode(
                    p["mixer"], cfg, h[:, t:t + 1], state)[0]
                    for t in range(len(prompt))], 1)
                bad = (par - rec).abs() > RECURRENT_TOL["atol"] \
                    + RECURRENT_TOL["rtol"] * rec.abs()
                if bool(bad.any()) or not bool(torch.isfinite(par).all()):
                    raise AssertionError(
                        f"{cfg.name} mLSTM block {n}: parallel vs recurrent "
                        f"{int(bad.sum())} outputs beyond {RECURRENT_TOL}, "
                        f"max abs diff {(par - rec).abs().max().item():.3g}")
                worst = max(worst, (par - rec).abs().max().item())
                n += 1
            x, _ = T._apply_block(cfg, spec, p, x, positions, "train", None,
                                  "ref")
    return n, worst


def serve_xlstm(kernels, card):
    """xlstm-1.3b at full width and ``XLSTM_LAYERS`` of its 48 layers
    (one whole 8-block period: 7 mLSTM blocks and 1 sLSTM), no
    attention layer, so no kernel runs.  The contiguous serve and the paged
    one (an empty pool: the contiguous machinery), tokens bit for bit
    equal; the prefill wave's time split into mLSTM and sLSTM blocks; the
    planned pipeline on both layouts against ``decode_step`` at one slot;
    in float32 weights (the same depth) each mLSTM block's parallel form
    against its recurrence, and the whole model's parallel prefill against its
    recurrence measured in bf16 and float32."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import SamplingParams
    from repro_torch.training.adamw import tree_leaves
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(XLSTM_ARCH, XLSTM_PROMPT_LENS, XLSTM_LAYERS)
    cfg = model.cfg
    kinds = [s.kind for s in cfg.layer_specs()]
    n_params = sum(t.numel() for t in tree_leaves(model.params))
    print(f"mixers {XLSTM_ARCH}: {kinds.count('mlstm')} mLSTM and "
          f"{kinds.count('slstm')} sLSTM blocks, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, vocab {cfg.vocab_size}: "
          f"{n_params / 1e9:.3f} B parameters of {cfg.dtype} from seed "
          f"{SEED} in {model.init_s:.1f} s")
    served = {}
    for layout in ("contiguous", "paged"):
        r = mixer_serve(model, kernels, card, f"mixers {XLSTM_ARCH}", layout,
                        HYBRID_MAX_LEN, MIXER_TOKENS)
        info = r["be"].info
        if layout == "paged":
            print(f"mixers {XLSTM_ARCH} paged: BackendInfo block_size "
                  f"{info.block_size}, total_blocks {info.total_blocks}, "
                  f"max_ctx_blocks {info.max_ctx_blocks}, bytes_per_block "
                  f"{info.bytes_per_block}: an empty pool; "
                  f"{info.cache_bytes / 2 ** 20:.1f} MiB of recurrent state")
            if info.total_blocks or info.spec_decode \
                    or info.supports_extend:
                raise AssertionError(f"{XLSTM_ARCH} paged: {info}")
        served[layout] = r["tokens"]
        if layout == "contiguous":
            device_share(f"mixers {XLSTM_ARCH} contiguous",
                         f"{SLOTS} requests x 8 tokens",
                         lambda llm=r["llm"]: llm.generate(
                             model.prompts[:SLOTS],
                             SamplingParams(max_tokens=8)), card)
            be = r["be"]
            wave = [5, 6]                    # the 256- and 2100-token prompts
            width = max(len(model.prompts[i]) for i in wave)
            padded = np.zeros((len(wave), width), np.int32)
            for j, i in enumerate(wave):
                padded[j, width - len(model.prompts[i]):] = model.prompts[i]
            lens = [len(model.prompts[i]) for i in wave]
            wave_ms = max(r["clock"].prefill_ms)     # the 2100-token wave
            split = {"mlstm": 0.0, "slstm": 0.0}
            saved = dict(T._RECURRENT)

            def synced(kind, fn):
                def run(*a, **kw):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    y = fn(*a, **kw)
                    torch.cuda.synchronize()
                    split[kind] += (time.perf_counter() - t) * 1e3
                    return y
                return run

            for kind in split:
                T._RECURRENT[kind] = (synced(kind, saved[kind][0]),
                                      saved[kind][1])
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                be.prefill([0, 1], padded, lens)
                synced_ms = (time.perf_counter() - t0) * 1e3
            finally:
                T._RECURRENT.update(saved)
            print(f"mixers {XLSTM_ARCH}: the serve's prefill wave with the "
                  f"{width}-token prompt {wave_ms:.1f} ms; a wave of {lens} "
                  f"tokens (padded to {SLOTS} x {width}) with a sync "
                  f"around each block {synced_ms:.1f} ms, of which "
                  f"{kinds.count('mlstm')} mLSTM blocks {split['mlstm']:.1f} "
                  f"ms and {kinds.count('slstm')} sLSTM blocks "
                  f"{split['slstm']:.1f} ms ({width} steps each) [{card}]")
            del be
        # no cuda-against-ref logits: the model runs no kernel, so both
        # impls run the same code
        del r["llm"], r["be"]
        torch.cuda.empty_cache()
    same = sum(int(a == b) for t, u in zip(served["paged"],
                                           served["contiguous"])
               for a, b in zip(t, u))
    total = len(model.prompts) * MIXER_TOKENS
    if same != total:
        raise AssertionError(f"{XLSTM_ARCH}: the paged serve's tokens equal "
                             f"the contiguous serve's {same}/{total}")
    print(f"mixers {XLSTM_ARCH}: the paged serve's tokens equal the "
          f"contiguous serve's bit for bit: {same}/{total}")

    # the pipeline teacher-forces each prompt through the recurrence, one
    # token a tick from a fresh state: held to decode_step doing the same
    mixer_pipeline(model, kernels, card, f"mixers {XLSTM_ARCH}",
                   ("contiguous", "paged"), recurrent=True)

    # parallel prefill against the recurrence.  Held block by block on the
    # mLSTM blocks in float32, the scope of the reference's own test; over
    # the whole model measured in bf16 and float32: the reference's init
    # scales the sLSTM's recurrent tensors [h, dh, dh] by 1/sqrt(h), 11x
    # their fan-in's scale at dh=512, so its recurrence grows any
    # difference of its inputs from step to step
    prompt = model.prompts[-1][:XLSTM_RECURRENT_LEN]
    last, every16 = parallel_vs_recurrent(cfg, model.params, prompt)
    print(f"mixers {XLSTM_ARCH} bf16: the whole model's parallel prefill vs "
          f"{len(prompt)} recurrent decode steps: last logits max abs diff "
          f"{last:.4g} (measured, not held); at positions 0, 16, ...: "
          f"{every16}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(XLSTM_ARCH, XLSTM_PROMPT_LENS, XLSTM_LAYERS,
                  dtype="float32")
    n, worst = mlstm_blocks_parallel_vs_recurrent(model.cfg, model.params,
                                                  prompt)
    print(f"mixers {XLSTM_ARCH} float32: each of {n} mLSTM blocks on its "
          f"own input, parallel vs {len(prompt)} recurrent steps: max abs "
          f"diff {worst:.3g} within {RECURRENT_TOL}")
    last, every16 = parallel_vs_recurrent(model.cfg, model.params, prompt)
    print(f"mixers {XLSTM_ARCH} float32: the whole model's parallel prefill "
          f"vs recurrent decode: last logits max abs diff {last:.4g} "
          f"(measured, not held); at positions 0, 16, ...: {every16}")
    print(f"mixers {XLSTM_ARCH}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; model wall "
          f"{time.perf_counter() - t_model:.1f} s [{card}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def fleet_replicas(model, faults=""):
    """Two paged TensorBackends of the fleet phase over the same parameter
    tensors (the weights stay on the card once), each under a StepClock;
    the second wrapped in ``faults``."""
    from repro_torch.runtime import FaultInjectionBackend, TensorBackend
    inner = [TensorBackend(model.cfg, model.params, n_slots=SLOTS,
                           max_len=FLEET_MAX_LEN, impl="cuda",
                           cache_layout="paged", block_size=BLOCK_SIZE,
                           device=DEVICE) for _ in range(2)]
    clocks = [StepClock(be) for be in inner]
    outer = [inner[0], FaultInjectionBackend(inner[1], faults, seed=SEED)]
    return outer, clocks


def run_fleet(model, pa, da, card, faults=""):
    """One replay of the fleet phase's bursty trace over two replicas, the
    second under ``faults``.  Returns what the run decided, by trace
    index."""
    from repro_torch.runtime import BackendDead
    from repro_torch.serving import Fleet, replay
    from repro_torch.serving.sched import bursty_trace
    trace = bursty_trace(FLEET_REQUESTS, seed=SEED,
                         out_lens=(MAX_TOKENS, MAX_TOKENS),
                         vocab=model.cfg.vocab_size)
    backends, clocks = fleet_replicas(model, faults)
    events = []
    fleet = Fleet(backends, policy=FLEET_POLICY, seed=SEED,
                  on_token=events.append)
    crash = []
    faulty = backends[1]
    decode = faulty.decode_step

    def watched(feeds):
        try:
            return decode(feeds)
        except BackendDead:
            crash.append(fleet.step_no)     # the fleet step it died in
            raise
    faulty.decode_step = watched
    pa.paged_attention.launches = 0
    da.decode_attention.launches = 0
    t0 = time.perf_counter()
    rep = replay(fleet, trace)
    wall = time.perf_counter() - t0
    launches = pa.paged_attention.launches
    steps = sum(len(c.decode_ms) for c in clocks)
    if launches != model.cfg.n_layers * steps or not launches \
            or da.decode_attention.launches:
        raise AssertionError(
            f"fleet {faults or 'fault-free'}: paged_attention launched "
            f"{launches} times over {steps} decode steps of "
            f"{model.cfg.n_layers} layers, decode_attention "
            f"{da.decode_attention.launches} times")
    # replay numbers its requests in trace order, so uid - first uid is
    # the trace index
    uids = sorted(set(fleet.done) | set(fleet.failed))
    first = uids[0]
    if uids != list(range(first, first + FLEET_REQUESTS)):
        raise AssertionError(f"fleet: {len(uids)} of {FLEET_REQUESTS} "
                             f"requests accounted for")
    for uid, r in fleet.done.items():
        if r.finish_reason != "length" or len(r.generated) != MAX_TOKENS:
            raise AssertionError(f"fleet request {uid - first}: "
                                 f"{len(r.generated)} tokens, "
                                 f"{r.finish_reason}")
    total = sum(len(r.generated) for r in fleet.done.values())
    label = f"fleet {faults or 'fault-free'}"
    print(f"{label}: {len(fleet.done)} requests served, {len(fleet.failed)} "
          f"shed, {total} tokens in {wall:.2f} s ({total / wall:.1f} "
          f"tokens/s), {rep.steps} fleet steps, {steps} decode steps, "
          f"paged_attention launches {launches} = {model.cfg.n_layers} "
          f"layers x {steps} steps [{card}]")
    for i, c in enumerate(clocks):
        if c.decode_ms:
            print(f"{label}: replica {i}: {len(c.prefill_ms)} prefills, "
                  f"{c.summary()}")
    print(f"{label}: {rep}")
    recovered = [u - first for u in fleet.recovered_uids]
    print(f"{label}: {fleet.stats}; migrations {fleet.migrations}, "
          f"recovered requests {recovered}, health {fleet.health()}")
    for uid, reason in fleet.failed_reason.items():
        print(f"{label}: request {uid - first} shed: {reason}")
    return dict(
        tokens={uid - first: list(r.generated)
                for uid, r in fleet.done.items()},
        events={(e.uid - first, e.index): (e.token, e.step) for e in events},
        stats=fleet.stats, crash=crash[0] if crash else None,
        launches=launches, recovered=recovered,
        weights=backends[0].info.param_bytes)


def serve_fleet(model, pa, da, card):
    """The fleet phase: llama2-7b on two paged replicas over one set of
    weights, fed a seeded bursty trace through ``replay`` twice -- fault
    free, and with the second replica crashing at its 21st decode call.
    The crash is quarantined once and its work recovered on the survivor;
    every token emitted before the crash step equals the fault-free
    run's."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    clean = run_fleet(model, pa, da, card)
    st = clean["stats"]
    if st.quarantines or st.shed or len(clean["tokens"]) != FLEET_REQUESTS:
        raise AssertionError(f"fault-free fleet: {st}")
    crashed = run_fleet(model, pa, da, card, FLEET_CRASH)
    st = crashed["stats"]
    if st.quarantines != 1 or st.recovered < 1 or crashed["crash"] is None:
        raise AssertionError(f"fleet with {FLEET_CRASH}: quarantines "
                             f"{st.quarantines}, recovered {st.recovered}, "
                             f"crash step {crashed['crash']}")
    before = {k: v for k, v in crashed["events"].items()
              if v[1] < crashed["crash"]}
    differ = [k for k, v in before.items() if clean["events"].get(k) != v]
    if differ:
        raise AssertionError(f"fleet: {len(differ)} of {len(before)} tokens "
                             f"emitted before the crash step differ from "
                             f"the fault-free run's, e.g. {differ[:4]}")
    after = [(i, j) for i, toks in crashed["tokens"].items()
             for j in range(len(toks)) if (i, j) not in before]
    same = sum(crashed["tokens"][i][j] == clean["tokens"][i][j]
               for i, j in after)
    peak, weights = torch.cuda.max_memory_allocated(), clean["weights"]
    if peak > 1.5 * weights:
        raise AssertionError(f"fleet: peak {peak / 1e9:.2f} GB for "
                             f"{weights / 1e9:.2f} GB of weights: the "
                             f"replicas do not share them")
    print(f"fleet {FLEET_CRASH}: crash at fleet step {crashed['crash']}; "
          f"the {len(before)} tokens emitted before it equal the fault-free "
          f"run's; after it {same}/{len(after)} equal (a recovered request "
          f"re-prefills its keys in one wave, which in bf16 may round apart "
          f"from the decode steps that wrote them); recovered requests "
          f"{crashed['recovered']}")
    print(f"fleet: peak device memory {peak / 1e9:.2f} GB ({held / 1e9:.2f} "
          f"GB held when the phase began) with {weights / 1e9:.2f} GB of "
          f"weights shared by both replicas; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return dict(launches=clean["launches"] + crashed["launches"])


def serve_launcher(card):
    """The launcher as a user calls it, in this process: llama2-7b on the
    paged layout under EDF with a TTFT deadline, two transient decode
    failures injected and absorbed by retries."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    llm, outs = serve.main(LAUNCHER_ARGV)
    wall = time.perf_counter() - t0
    st = llm.stats
    bad = [o.uid for o in outs if o.finish_reason != "length"
           or o.n_generated != MAX_TOKENS]
    if len(outs) != 8 or bad or st.retries != 2 or st.failures != 2 \
            or llm.backend.injected["transient"] != 2 \
            or llm.backend.health() != "healthy":
        raise AssertionError(f"launcher: {len(outs)} requests, unfinished "
                             f"{bad}, {st}, injected {llm.backend.injected}, "
                             f"health {llm.backend.health()}")
    print(f"launcher: {' '.join(LAUNCHER_ARGV)}: 8 requests finished, 2 "
          f"transient failures absorbed with 2 retries, backend healthy, in "
          f"{wall:.1f} s with the weights' set-up [{card}]")


def score(model, kernels, card, batch=SCORE_BATCH, length=SCORE_LEN,
          held=True, frontend=False):
    """The train-mode forward of ``batch`` x ``length`` seeded tokens (with
    ``frontend``, the stub frontend's float embeddings from SEED) under
    ``torch.no_grad``: ``impl="cuda"`` launches the flash kernel once per
    attention layer and the scan once per RG-LRU layer, and no decode
    kernel; its logits agree with ``impl="ref"``'s (with ``held`` False the
    difference is measured only).  ``kernels`` maps each
    kernel's name to its wrapper; returns the launches of the cuda run."""
    from repro_torch.models import transformer as T
    from repro_torch.models.frontends import fake_frontend_embeddings
    cfg = model.cfg
    if frontend:
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(SEED)
        tokens = fake_frontend_embeddings(cfg, gen, batch, length, DEVICE)
    else:
        rng = np.random.default_rng(SEED)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, length))).to(DEVICE)
    n_scan = sum(spec.kind == "rglru" for spec in cfg.layer_specs())
    want = dict(flash_attention=cfg.n_layers - n_scan, rglru_scan=n_scan,
                decode_attention=0, paged_attention=0, int8_matmul=0)
    logits, secs = {}, {}
    moe = any(s.moe is not None for s in cfg.layer_specs())
    with torch.no_grad(), RouteReplay(moe) as route:
        for impl in ("cuda", "ref"):
            route.record() if impl == "cuda" else route.replay()
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
    for row in range(batch):           # one row at a time: V is large
        got, ref = logits["cuda"][row].float(), logits["ref"][row].float()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"score {cfg.name}: non-finite logits")
        diff = max(diff, (got - ref).abs().max().item())
        agree += int((got.argmax(-1) == ref.argmax(-1)).sum())
    if held and diff > LOGITS_ATOL:
        raise AssertionError(f"score {cfg.name}: logits cuda vs ref max abs "
                             f"diff {diff:.4g} > {LOGITS_ATOL}")
    bound = f"atol {LOGITS_ATOL}" if held else "measured, not held"
    what = f"{cfg.frontend} frontend embeddings" if frontend else "tokens"
    print(f"score {cfg.name} {cfg.dtype}: forward(mode='train') over "
          f"{batch} x {length} {what}, logits {list(logits['cuda'].shape)}: "
          f"impl cuda vs ref max abs diff {diff:.4g} ({bound}), argmax "
          f"agreement {agree}/{batch * length}; launches "
          f"{launches}; {secs['cuda'] * 1e3:.1f} ms cuda, "
          f"{secs['ref'] * 1e3:.1f} ms ref [{card}]")
    if moe:
        print(f"score {cfg.name}: {route.summary()}")
    del logits
    torch.cuda.empty_cache()
    return launches


def pipeline_prompts(cfg, n):
    """``n`` prompts of ``PIPE_PROMPT_LENS`` tokens from SEED."""
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
    the forward's, each layout's serve (tokens, quanta, ticks, fed tokens,
    wall, tokens/s) and the prompts."""
    from repro_torch.core import pipeline as PL
    from repro_torch.models import transformer as T
    from repro_torch.serving import LLM, SamplingParams
    cfg = model.cfg
    sp = SamplingParams(max_tokens=PIPE_TOKENS)

    def plan(layout):
        return plan_pipeline(model, layout)

    llm = plan("contiguous")
    spec = llm.backend.spec
    periods = spec.periods_per_stage
    if spec.n_stages < 2 or max(periods) == min(periods):
        raise AssertionError(f"pipeline: planned stages {periods}: expected "
                             f"two or more, uneven")
    prompts = pipeline_prompts(cfg, PIPE_REQUESTS)
    print(f"pipeline: LLM.from_plan({cfg.name}, paper_testbed(), "
          f"objective='throughput'): {spec.n_stages} stages, periods per "
          f"stage {periods}; {len(prompts)} requests of "
          f"{[len(p) for p in prompts]} prompt tokens x {PIPE_TOKENS} greedy "
          f"tokens over {spec.n_stages} slots (cut from {spec.n_stages} to "
          f"make room for the pipeline-procs phase), max_len "
          f"{PIPE_MAX_LEN}")
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
        quanta = llm.stats.decode_steps
        t0 = time.perf_counter()
        outs = run_requests(llm, prompts, sp)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        wall = t_end - t0
        launches = {n: fn.launches for n, fn in kernels.items()}
        quanta = llm.stats.decode_steps - quanta
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
        profile_ring(f"pipeline {layout}", llm,
                     pipeline_prompts(cfg, spec.n_stages), sp, card)
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
        out[f"{layout} serve"] = dict(tokens=tokens, quanta=quanta,
                                      ticks=len(ticks), fed=fed, wall=wall,
                                      tokens_s=total / wall)
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
    out["prompts"] = prompts
    return out


def plan_pipeline(model, layout, max_len=PIPE_MAX_LEN, **kw):
    """``LLM.from_plan`` of ``model`` over the paper's testbed (the
    throughput DP) on ``layout``; ``kw`` are the serving options (spec,
    prefix cache, chunks)."""
    from repro_torch.core.devices import paper_testbed
    from repro_torch.core.profile import Workload
    from repro_torch.serving import LLM
    return LLM.from_plan(model.cfg, paper_testbed(), Workload(dtype_bytes=2),
                         objective="throughput", kind="pipeline",
                         params=model.params, max_len=max_len,
                         cache_layout=layout, block_size=BLOCK_SIZE,
                         impl="cuda", device=DEVICE, seed=SEED, **kw)


class FedTicks:
    """Counts the stage pipeline's fed ticks (a tick whose stage 0 takes a
    token: one 32-layer pass of that token, one decode-kernel launch a
    layer) while in use, by wrapping ``pipeline_decode_tick``."""

    def __enter__(self):
        from repro_torch.core import pipeline as PL
        self.fed, self._pl, self._tick = 0, PL, PL.pipeline_decode_tick

        def tick(*args, feed_valid=True, **kw):
            self.fed += bool(feed_valid)
            return self._tick(*args, feed_valid=feed_valid, **kw)
        PL.pipeline_decode_tick = tick
        return self

    def __exit__(self, *exc):
        self._pl.pipeline_decode_tick = self._tick


def serve_pipeline_spec(model, kernels, card, pipe):
    """Speculative verify on the paged stage pipeline: the pipeline phase's
    prompts with ``spec_k=4`` and an oracle of its paged serve's tokens
    (corrupted at ``1 - ACCEPT_PROB``).  Each draft is one tick at the
    position a decode would have, so the greedy tokens equal the plain
    paged serve's bit for bit, in fewer scheduler quanta; the paged kernel
    launches once a layer and fed token, rejected drafts included."""
    from repro_torch.serving import SamplingParams
    from repro_torch.serving.spec import OracleDraft
    cfg = model.cfg
    plain, prompts = pipe["paged serve"], pipe["prompts"]
    sp = SamplingParams(max_tokens=PIPE_TOKENS)
    oracle = OracleDraft(dict(enumerate(plain["tokens"])),
                         accept_prob=ACCEPT_PROB, seed=SEED,
                         vocab_size=cfg.vocab_size)
    t_phase = time.perf_counter()
    llm = plan_pipeline(model, "paged", spec_k=SPEC_K, draft=oracle)
    be = llm.backend
    if not be.info.spec_decode:
        raise AssertionError("the paged pipeline reports spec_decode=False")
    clock = StepClock(be)
    llm.generate([prompts[0][:2]], SamplingParams(max_tokens=1))
    clock.reset()
    for fn in kernels.values():
        fn.launches = 0
    quanta, tick0 = llm.stats.decode_steps, be.state.tick
    with FedTicks() as fed:
        t0 = time.perf_counter()
        outs = run_requests(llm, prompts, sp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    quanta = llm.stats.decode_steps - quanta
    ticks = be.state.tick - tick0
    want = {n: cfg.n_layers * fed.fed if n == "paged_attention" else 0
            for n in kernels}
    if launches != want or not fed.fed:
        raise AssertionError(f"pipeline spec: launches {launches}, expected "
                             f"{want} ({fed.fed} fed tokens)")
    tokens = [o.tokens for o in outs]
    same = sum(int(a == b) for t, u in zip(tokens, plain["tokens"])
               for a, b in zip(t, u))
    total = sum(o.n_generated for o in outs)
    st = llm.stats
    print(f"pipeline spec: {len(outs)} requests x {PIPE_TOKENS} greedy "
          f"tokens, spec_k {SPEC_K}, oracle accept_prob {ACCEPT_PROB}: "
          f"{quanta} scheduler quanta ({len(clock.verify_ms)} verify calls) "
          f"against the plain paged serve's {plain['quanta']}, {ticks} "
          f"ticks ({plain['ticks']}), {fed.fed} fed tokens ({plain['fed']}); "
          f"drafts accepted {st.spec_accepted}/{st.spec_drafted}; "
          f"paged_attention launches {launches['paged_attention']} = "
          f"{cfg.n_layers} layers x {fed.fed} fed tokens, the other kernels "
          f"0; greedy tokens equal to the plain paged serve's: "
          f"{same}/{total}")
    v = clock.verify_ms
    print(f"pipeline spec: {wall / ticks * 1e3:.3f} ms a tick on average, "
          f"verify ms per call median {statistics.median(v):.3f} (min "
          f"{min(v):.3f}, max {max(v):.3f}), {total / wall:.1f} tokens/s "
          f"over {wall:.2f} s (the plain paged serve: "
          f"{plain['wall'] / plain['ticks'] * 1e3:.3f} ms a tick on average, "
          f"{plain['tokens_s']:.1f} tokens/s) [{card}]")
    if tokens != plain["tokens"]:
        raise AssertionError(f"pipeline spec: {total - same} greedy tokens "
                             f"differ from the plain paged serve's")
    if not st.spec_accepted or quanta >= plain["quanta"]:
        raise AssertionError(f"pipeline spec: {st.spec_accepted} drafts "
                             f"accepted, {quanta} quanta against "
                             f"{plain['quanta']}")
    print(f"pipeline spec: phase wall {time.perf_counter() - t_phase:.2f} s")
    del llm, be, clock
    torch.cuda.empty_cache()
    return launches["paged_attention"]


def plan_procs(model, layout, stage_procs):
    """``LLM.from_plan`` of ``model`` over ``PROCS_CHIPS`` chips (the
    reference launcher's pipeline plan), its stages in this process or one
    a process."""
    from repro_torch.core.devices import tpu_pod_cluster
    from repro_torch.core.profile import Workload
    from repro_torch.serving import LLM
    return LLM.from_plan(model.cfg, tpu_pod_cluster(n_chips=PROCS_CHIPS),
                         Workload(dtype_bytes=2), objective="throughput",
                         kind="pipeline", params=model.params,
                         max_len=PIPE_MAX_LEN, cache_layout=layout,
                         block_size=BLOCK_SIZE, impl="cuda", device=DEVICE,
                         seed=SEED, stage_procs=stage_procs)


def procs_serve(llm, prompts, sp, kernels):
    """One serve of ``prompts`` under uids 0.., each tick's start stamped
    on the host clock (no sync added), after a one-token warm-up serve
    and every launch count set to 0 (the stages' too).  Returns the
    tokens, each request's logits [n_tokens, V], the ticks' ms, the wall,
    this process's launches and, on processes, each stage's stats."""
    from repro_torch.serving import SamplingParams
    be = llm.backend
    procs = hasattr(be.ring, "stats")
    starts, logits = [], {}
    tick = be.decode_step

    def timed(feeds):
        starts.append(time.perf_counter())
        events = tick(feeds)
        for ev in events:
            logits.setdefault(llm.batcher._slot_req[ev.slot].uid,
                              []).append(ev.logits)
        return events

    be.decode_step = timed
    llm.generate([prompts[0][:2]], SamplingParams(max_tokens=1))
    starts.clear()
    logits.clear()
    for fn in kernels.values():
        fn.launches = 0
    if procs:
        be.ring.zero_stats()
    t0 = time.perf_counter()
    outs = run_requests(llm, prompts, sp)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    be.decode_step = tick
    return dict(tokens=[o.tokens for o in outs],
                logits=np.stack([np.stack(logits[i])
                                 for i in range(len(prompts))]),
                ticks=np.diff(starts + [t_end]) * 1e3, wall=t_end - t0,
                launches={n: fn.launches for n, fn in kernels.items()},
                stats=be.ring.stats() if procs else None)


def teacher_forced_ticks(ring, feeds):
    """Every tick fed through ``ring`` (a ring's methods: ``tick``,
    ``reset_slot``, ``state``), each slot its own row of ``feeds``
    [M, n] in turn from a reset at position 0: the completed logits
    [M, n, V] by slot and round, and ``token_ready``."""
    m, n = feeds.shape
    for slot in range(m):
        ring.reset_slot(slot)
    rounds, fed_at = [0] * m, {}
    out = np.zeros((m, n, ring.state.logits_out.shape[1]), np.float32)
    t0 = ring.state.tick
    ns = ring.spec.n_stages
    while ring.state.tick < t0 + m * n + ns - 1:
        t = ring.state.tick
        slot = t % m
        live = rounds[slot] < n
        if live:
            fed_at[t] = (slot, rounds[slot])
        done = ring.tick(int(feeds[slot, min(rounds[slot], n - 1)]), live,
                         rounds[slot])
        rounds[slot] += live
        if t - (ns - 1) in fed_at:
            s, r = fed_at.pop(t - (ns - 1))
            if done != s:
                raise AssertionError(f"tick {t}: micro-batch {done} "
                                     f"completed, {s} expected")
            out[s, r] = ring.state.logits_out[s].numpy()
    return out, ring.state.token_ready.copy()


def serve_pipeline_procs(model, kernels, card):
    """The stage ring with one process a stage: ``LLM.from_plan`` over
    four chips gives llama2-7b four stages of 8 layers, served one a
    process (weights shared by CUDA IPC, activations over gloo) beside
    the same plan in this process, on the contiguous layout and then the
    paged one.  Held: the greedy tokens bit for bit the one-process
    ring's, the logits that chose them within 0.25, and the decode
    kernel's launches summed over the stages 32 x the fed tokens (the
    other kernel's and this process's 0).  Then 32 teacher-forced ticks
    over 4 micro-batches through the contiguous serve's ring and a
    vocab-sharded ring of four processes: ``token_ready`` equal, logits
    within 0.25.  Returns each layout's summed launches, each layout's
    stage stats (``stats``), the vocab-sharded ring's (``vocab stats``)
    and the plan (``spec``), which the dry-run phase reads."""
    from repro_torch.serving import SamplingParams
    cfg = model.cfg
    sp = SamplingParams(max_tokens=PIPE_TOKENS)
    prompts = pipeline_prompts(cfg, PROCS_REQUESTS)
    fed = sum(len(p) + PIPE_TOKENS - 1 for p in prompts)
    t_phase = time.perf_counter()
    out = {}
    for layout in ("contiguous", "paged"):
        kernel = "decode_attention" if layout == "contiguous" \
            else "paged_attention"
        one = plan_procs(model, layout, False)
        spec = one.backend.spec
        print(f"pipeline procs {layout}: LLM.from_plan({cfg.name}, "
              f"tpu_pod_cluster(n_chips={PROCS_CHIPS})): periods per stage "
              f"{spec.periods_per_stage}, {one.backend.n_slots} slots; "
              f"{len(prompts)} requests of {[len(p) for p in prompts]} "
              f"prompt tokens x {PIPE_TOKENS} greedy tokens, max_len "
              f"{PIPE_MAX_LEN}")
        base = procs_serve(one, prompts, sp, kernels)
        del one
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        llm = plan_procs(model, layout, True)
        spawn_s = time.perf_counter() - t0
        be = llm.backend
        if be.spec != spec or be.info.attn_impl != "cuda":
            raise AssertionError(f"pipeline procs {layout}: spec {be.spec}, "
                                 f"attn_impl {be.info.attn_impl}")
        try:
            run = procs_serve(llm, prompts, sp, kernels)
            stats = run["stats"]
            launches = {n: sum(s["launches"][n] for s in stats)
                        for n in kernels}
            want = {n: cfg.n_layers * fed if n == kernel else 0
                    for n in kernels}
            if launches != want or any(run["launches"].values()) \
                    or base["launches"] != want:
                raise AssertionError(
                    f"pipeline procs {layout}: launches summed over the "
                    f"stages {launches}, in this process "
                    f"{run['launches']}, in the one-process ring "
                    f"{base['launches']}; expected {want} ({fed} fed "
                    f"tokens)")
            same = sum(int(a == b) for t, u in zip(run["tokens"],
                                                   base["tokens"])
                       for a, b in zip(t, u))
            diff = float(np.abs(run["logits"] - base["logits"]).max())
            total = len(prompts) * PIPE_TOKENS
            print(f"pipeline procs {layout}: {kernel} launches summed over "
                  f"the {spec.n_stages} stage processes "
                  f"{launches[kernel]} = {cfg.n_layers} layers x {fed} fed "
                  f"tokens (per stage "
                  f"{[s['launches'][kernel] for s in stats]}), the other "
                  f"kernel 0, none in this process; greedy tokens equal to "
                  f"the one-process ring's: {same}/{total}; logits max abs "
                  f"diff {diff:.4g} (atol {LOGITS_ATOL})")
            if run["tokens"] != base["tokens"] or diff > LOGITS_ATOL \
                    or not np.isfinite(run["logits"]).all():
                raise AssertionError(f"pipeline procs {layout}: "
                                     f"{total - same} tokens differ, logits "
                                     f"{diff:.4g} apart")
            for name, r in (("one process", base), ("processes", run)):
                t = r["ticks"]
                print(f"pipeline procs {layout}: {name}: {len(t)} ticks, "
                      f"tick ms median {statistics.median(t):.3f} (min "
                      f"{min(t):.3f}, max {max(t):.3f}), "
                      f"{total / r['wall']:.1f} tokens/s over "
                      f"{r['wall']:.2f} s [{card}]")
            for rank, st in enumerate(stats):
                ticks = st["ticks"]
                print(f"pipeline procs {layout}: stage {rank}: {ticks} "
                      f"ticks, {st['live']} live; ms a tick: host "
                      f"{st['host_s'] / ticks * 1e3:.3f}, device wait "
                      f"{st['device_s'] / ticks * 1e3:.3f}, hop "
                      f"{st['hop_s'] / ticks * 1e3:.3f}; hop bytes "
                      f"{st['hop_bytes']} "
                      f"({st['hop_bytes'] / max(st['live'], 1):.0f} a live "
                      f"tick)")
            print(f"pipeline procs {layout}: spawn and plan {spawn_s:.2f} s "
                  f"(the stages' start {be.ring.spawn_s:.2f} s)")
            out[layout] = launches[kernel]
            out.setdefault("stats", {})[layout] = stats
            if layout == "contiguous":
                out["vocab stats"] = vocab_ticks(model, be, spec, card)
                out["spec"] = spec
        finally:
            be.close()
        del llm, be
        torch.cuda.empty_cache()
    print(f"pipeline procs: phase wall {time.perf_counter() - t_phase:.2f} s "
          f"[{card}]")
    return out


def vocab_ticks(model, be, spec, card):
    """``PROCS_VOCAB_TICKS`` teacher-forced ticks with seeded feeds over
    ``be``'s ring (four stage processes, its serve done) and a
    vocab-sharded ring of four processes on the same weights; returns the
    vocab-sharded ring's stage stats."""
    from repro_torch.core.stage_procs import StageProcs, vocab_bytes
    cfg = model.cfg
    m = be.n_slots
    feeds = np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (m, PROCS_VOCAB_TICKS // m))
    plain, ready = teacher_forced_ticks(be.ring, feeds)
    t0 = time.perf_counter()
    ring = StageProcs(cfg, model.params, spec, n_slots=m,
                      max_len=PIPE_MAX_LEN, cache_dtype=be.cache_dtype,
                      impl="cuda", device=DEVICE, vocab_sharded=True)
    try:
        spawn_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, got_ready = teacher_forced_ticks(ring, feeds)
        secs = time.perf_counter() - t0
        stats = ring.stats()
        held = [s["vocab_bytes"] for s in stats]
    finally:
        ring.close()
    diff = float(np.abs(got - plain).max())
    agree = int((got.argmax(-1) == plain.argmax(-1)).sum())
    print(f"pipeline procs vocab-sharded: {PROCS_VOCAB_TICKS} teacher-forced "
          f"ticks over {m} micro-batches, {spec.n_stages} stage processes "
          f"(spawned in {spawn_s:.2f} s, ticks {secs:.2f} s): logits against "
          f"the plain ring's max abs diff {diff:.4g} (atol {LOGITS_ATOL}), "
          f"argmax agreement {agree}/{plain.shape[0] * plain.shape[1]}; "
          f"token_ready equal: {bool((got_ready == ready).all())}; "
          f"vocabulary weight bytes a stage {held} against "
          f"{vocab_bytes(model.params)} whole [{card}]")
    if diff > LOGITS_ATOL or not (got_ready == ready).all() \
            or not np.isfinite(got).all():
        raise AssertionError(f"pipeline procs vocab-sharded: logits "
                             f"{diff:.4g} apart, token_ready {got_ready} "
                             f"against {ready}")
    return stats


def mesh_rows(label, got, want):
    """The max abs difference of two [B, S, V] logits and their argmax
    agreement, a row at a time; raises on a non-finite logit."""
    diff = agree = 0
    for row in range(got.shape[0]):
        a, b = got[row].float(), want[row].float()
        if not bool(torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{label}: non-finite logits")
        diff = max(diff, (a - b).abs().max().item())
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
    return diff, agree


def mesh_stats(label, procs, card):
    """Each mesh process's totals a line: host, device-wait and hop ms,
    hop bytes, flash launches."""
    stats = procs.stats()
    for rank, st in enumerate(stats):
        print(f"{label}: process {rank} {procs.mesh.coords(rank)}: host "
              f"{st['host_s'] * 1e3:.3f} ms, device wait "
              f"{st['device_s'] * 1e3:.3f} ms, hop {st['hop_s'] * 1e3:.3f} "
              f"ms, hop bytes {st['hop_bytes']}, flash_attention launches "
              f"{st['launches']['flash_attention']} [{card}]")
    return stats


def mesh_pipeline(model, kernels, card):
    """The mesh phase's ``pipeline_forward``: llama2-7b's four-chip plan
    on a (2, 4) mesh of processes (stages over model, each micro-batch's
    rows over data; the weights shared by CUDA IPC, held once for the two
    data replicas of a stage; activations over gloo) against the same
    forward in one process.  Held: 16 flash launches in each process (8
    layers x 2 micro-batches), 128 summed and none in this process, and
    the logits within ``LOGITS_ATOL`` (bf16 products at one row a process
    against two rows a micro-batch in one process may round apart, as the
    score phase's kernels against ref).  Returns the summed launches."""
    from repro_torch.core import pipeline as PL
    from repro_torch.core.devices import tpu_pod_cluster
    from repro_torch.core.mesh_procs import MeshProcs
    from repro_torch.core.profile import Workload
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime.factory import plan_pipeline_spec
    cfg = model.cfg
    mesh = make_test_mesh(*MESH_SHAPE)
    spec = plan_pipeline_spec(cfg, tpu_pod_cluster(n_chips=PROCS_CHIPS),
                              PROCS_CHIPS, Workload(dtype_bytes=2))
    tokens = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab_size, (MESH_BATCH, SCORE_LEN))).to(DEVICE)
    t_phase = time.perf_counter()
    for fn in kernels.values():
        fn.launches = 0
    with torch.no_grad():
        t0 = time.perf_counter()
        want = PL.pipeline_forward(cfg, model.params, tokens, spec,
                                   MESH_MICROBATCHES, impl="cuda")
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
    one = kernels["flash_attention"].launches
    t0 = time.perf_counter()
    procs = MeshProcs(cfg, model.params, mesh, impl="cuda", device=DEVICE)
    spawn_s = time.perf_counter() - t0
    try:
        procs.pipeline_forward(tokens, spec, MESH_MICROBATCHES)   # warm-up
        procs.zero_stats()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        got = procs.pipeline_forward(tokens, spec, MESH_MICROBATCHES)
        secs = time.perf_counter() - t0
        host = {n: fn.launches for n, fn in kernels.items()}
        stats = mesh_stats("mesh pipeline_forward", procs, card)
    finally:
        procs.close()
    per = [st["launches"]["flash_attention"] for st in stats]
    each = spec.periods_per_stage[0] * cfg.period * MESH_MICROBATCHES
    if spec.periods_per_stage != (8, 8, 8, 8) or per != [each] * mesh.size \
            or any(host.values()) or one != cfg.n_layers * MESH_MICROBATCHES \
            or any(sum(st["launches"][n] for st in stats)
                   for n in kernels if n != "flash_attention"):
        raise AssertionError(f"mesh pipeline_forward: spec {spec}, flash "
                             f"launches per process {per} (expected "
                             f"{each} each), in this process {host}, in "
                             f"the one-process forward {one}")
    diff, agree = mesh_rows("mesh pipeline_forward", got, want)
    hop = [st["hop_bytes"] for st in stats]
    print(f"mesh pipeline_forward: {cfg.name} periods per stage "
          f"{spec.periods_per_stage} (tpu_pod_cluster(n_chips={PROCS_CHIPS}))"
          f" on a {mesh.shape} mesh of {mesh.size} processes: "
          f"{MESH_BATCH} x {SCORE_LEN} tokens in {MESH_MICROBATCHES} "
          f"micro-batches, {MESH_BATCH // MESH_MICROBATCHES // MESH_SHAPE[0]}"
          f" row a process and micro-batch; {secs * 1e3:.1f} ms (the "
          f"one-process forward {one_s * 1e3:.1f} ms, its first call); "
          f"spawn {spawn_s:.2f} s; flash_attention launches {per} = "
          f"{sum(per)} summed, none in this process; hop bytes {hop} "
          f"({max(hop) // MESH_MICROBATCHES} a hop); logits against the "
          f"one-process pipeline_forward max abs diff {diff:.4g} (atol "
          f"{LOGITS_ATOL}), argmax agreement {agree}/{MESH_BATCH * SCORE_LEN}"
          f" [{card}]")
    if diff > LOGITS_ATOL:
        raise AssertionError(f"mesh pipeline_forward: logits {diff:.4g} "
                             f"from the one-process forward's")
    del got, want
    torch.cuda.empty_cache()
    print(f"mesh pipeline_forward: phase wall "
          f"{time.perf_counter() - t_phase:.2f} s [{card}]")
    return sum(per)


def tp_serve(be, prompts, sp, kernels):
    """One ``LLM.from_backend`` serve of ``prompts`` over ``be``, every
    launch count set to 0 (the mesh processes' too): the tokens, the
    decode ms per step (host clock, each call ending in the logits
    readback), this process's launches and, on processes, each one's
    stats.  No warm-up serve: the processes' first step is one of seven
    decode medians."""
    from repro_torch.serving import LLM
    procs = hasattr(be, "procs")
    llm = LLM.from_backend(be, seed=SEED)
    clock = StepClock(be)
    for fn in kernels.values():
        fn.launches = 0
    if procs:
        be.zero_stats()
    t0 = time.perf_counter()
    outs = run_requests(llm, prompts, sp)
    wall = time.perf_counter() - t0
    return dict(tokens=[o.tokens for o in outs],
                decode_ms=list(clock.decode_ms), wall=wall,
                waves=len(clock.prefill_ms),
                launches={n: fn.launches for n, fn in kernels.items()},
                stats=be.stats() if procs else None)


def tp_forced(be, prompts, tokens):
    """Every prompt prefilled in one wave (one a slot), then each request's
    own first ``tokens`` fed back: the logits [n_req, TP_FORCED, V] (the
    prefill's first), the decode steps' ms and, on processes, each one's
    stats over the decode steps alone."""
    procs = hasattr(be, "procs")
    (wave, padded, lens), = waves(prompts, len(prompts))
    slots = list(range(len(wave)))
    evs = {ev.slot: ev.logits for ev in be.prefill(slots, padded, lens)}
    steps, ms = [np.stack([evs[s] for s in slots])], []
    if procs:
        be.zero_stats()
    for t in range(TP_FORCED - 1):
        t0 = time.perf_counter()
        evs = be.decode_step({s: tokens[s][t] for s in slots})
        ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(np.stack([ev.logits for ev in evs]))
    stats = be.stats() if procs else None
    for s in slots:
        be.free_slot(s)
    return np.stack(steps, axis=1), ms, stats


def serve_tp(model, kernels, card):
    """Tensor parallelism over the mesh's model axis: llama2-7b on a (1, 4)
    mesh of processes (``TensorBackend(..., mesh=...)``: each process its
    8 heads and their K/V cache, 2752 ff columns and 8000 vocabulary rows,
    views of the weights shared by CUDA IPC; the output and down
    projections and the embedding summed over gloo in float32, the head's
    columns gathered) beside the one-process ``TensorBackend``, on the
    contiguous layout and then the paged one, and its score
    (:func:`tp_phase`).  Returns the launches summed over the
    processes."""
    return tp_phase(model, kernels, card, "tp", TP_SHAPE,
                    ("contiguous", "paged"),
                    lambda procs: tp_score(model, procs, kernels, card))


def serve_tp_recurrent(model, kernels, card):
    """The recurrent mixers over the mesh's model axis (:func:`tp_phase`):
    recurrentgemma-2b at full size (``model``'s weights) on a (1, 4) mesh
    of processes, each its 640 of the 2560 RG-LRU channels (the scan
    kernel over them in every prefill wave and the score), 1920 ff
    columns and 64,000 vocabulary rows, its attention whole (10 query
    heads over one K/V head do not split), contiguous then paged and the
    score; then xlstm-1.3b at full width and ``XLSTM_LAYERS`` layers on a
    (1, 2) mesh, each process 2 of the 4 mLSTM heads and 1365 of the
    sLSTM's 2730 ff columns, contiguous, its logits printed against one
    process's and held by :func:`xlstm_tp_checks`.  Returns the launches
    summed over the processes by kernel and path."""
    label = "tp recurrent"
    out = tp_phase(model, kernels, card, label, TP_SHAPE,
                   ("contiguous", "paged"),
                   lambda procs: tp_score(model, procs, kernels, card, label))
    gc.collect()
    torch.cuda.empty_cache()
    xl = Model(XLSTM_ARCH, n_layers=XLSTM_LAYERS)
    label = f"tp recurrent {XLSTM_ARCH}"
    tp_phase(xl, kernels, card, label, TP_XLSTM_SHAPE, ("contiguous",),
             lambda procs: xlstm_tp_checks(xl, procs, card, label),
             held=False)
    del xl
    return out


def xlstm_tp_checks(model, procs, card, label):
    """xlstm-1.3b's tensor parallelism held where its rounding lets a check
    hold.  At full width its random weights carry any rounding to the
    logits (one bf16 process is about 2 from the float64 forward, as this
    check prints), so 0.25 of one process's cannot hold; instead:

    - each block's mixer on the processes (float32, every mLSTM's heads
      split, the sLSTM's ff) against one process's, on the same input,
      within the reference's parallel-equals-recurrent 2e-4;
    - the whole forward in bf16 over 2 x 32 tokens on the processes at
      most ``MESH_BF16_FACTOR`` times as far from the one-process float64
      forward as the one-process bf16 forward is."""
    import dataclasses

    import torch_mesh_ranks as ranks
    from repro_torch.models import transformer as T
    from repro_torch.training.adamw import tree_map
    cfg = model.cfg
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 6)
    x = torch.randn((2, 32, cfg.d_model), generator=gen, device=DEVICE)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    worst = 0.0
    for i, spec in enumerate(cfg.layer_specs()):
        got = procs.run(ranks.tp_block, i, x)
        mixer = {k: t.float() for k, t in
                 model.params["layers"][i]["mixer"].items()}
        with torch.no_grad():
            want = T._RECURRENT[spec.kind][0](mixer, cfg32, x)[0]
        for g in got:
            torch.testing.assert_close(g.to(DEVICE), want, **RECURRENT_TOL)
            worst = max(worst, (g.to(DEVICE) - want).abs().max().item())
    tokens = torch.from_numpy(np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, (2, 32))).to(DEVICE)
    got = procs.forward(tokens).double()
    with torch.no_grad():
        one = T.forward(cfg, model.params, tokens, mode="train")[0].double()
        wide = tree_map(lambda t: t.double(), model.params)
        ref = T.forward(dataclasses.replace(cfg, dtype="float64"), wide,
                        tokens, mode="train")[0]
        del wide
    e_tp = (got - ref).abs().max().item()
    e_one = (one - ref).abs().max().item()
    print(f"{label}: each block's mixer on the processes (float32) against "
          f"one process's: max abs diff {worst:.3g} (rtol/atol "
          f"{RECURRENT_TOL['rtol']:g}); the bf16 forward over 2 x 32 tokens "
          f"against the one-process float64 forward: the processes "
          f"{e_tp:.4g}, one process {e_one:.4g}: x{e_tp / e_one:.3f} (at "
          f"most x{MESH_BF16_FACTOR}); the processes against one bf16 "
          f"process {(got - one).abs().max().item():.4g} [{card}]")
    if not bool(torch.isfinite(got).all()) or e_tp > MESH_BF16_FACTOR * e_one:
        raise AssertionError(f"{label}: the processes' bf16 error "
                             f"{e_tp:.4g} against one process's {e_one:.4g}")
    del got, one, ref
    torch.cuda.empty_cache()
    return worst


def tp_phase(model, kernels, card, label, shape, layouts, after,
             held=True):
    """``model`` on a ``shape`` mesh of processes
    (``TensorBackend(..., mesh=...)``, the split the rules take: heads,
    ``ff``, RG-LRU channels, vocabulary) beside the one-process
    ``TensorBackend``, on each of ``layouts``; then, after the last
    layout's serve, ``after(procs)`` on its processes (:func:`tp_score`).
    Held: each process's ring or paged kernel once an attention layer and
    decode step, its scan once a RG-LRU layer and prefill wave, no other
    kernel, none in this process; each
    process's K/V bytes one process's over the heads' split, its split
    recurrent state (RG-LRU ``h`` and ``conv``, mLSTM ``C``, ``n``, ``m``)
    one process's over the model axis and the rest whole; the
    teacher-forced logits within 0.25 of one process's (with ``held``
    False measured only: ``after`` holds the model).  Printed: the
    greedy tokens' agreement (bf16 sums in another order), decode medians,
    each process's host, device-wait and all-reduce ms and bytes a decode
    step.  Returns the launches summed over the processes: the attention
    kernel by layout, the scan's (``rglru_scan serve``, both layouts),
    ``after``'s result (``score``) and each layout's teacher-forced decode
    steps and each process's stats over them (``decode stats``: the
    dry-run phase reads them)."""
    import torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime import TensorBackend
    from repro_torch.serving import SamplingParams
    from repro_torch.sharding.rules import local_config, tp_rules
    cfg, m = model.cfg, shape[1]
    mesh = Mesh(("data", "model"), shape)
    rules = tp_rules(cfg, mesh)
    local = local_config(cfg, mesh, rules)
    heads = m if rules.spec(("qkv",))[0] is not None else 1
    kinds = [s.kind for s in cfg.layer_specs()]
    n_scan, n_attn = kinds.count("rglru"), kinds.count("attn")
    vocab = cfg.vocab_size // (m if rules.spec(("vocab",))[0] else 1)
    split = (f"{local.n_heads} of {cfg.n_heads} heads, {local.d_ff} ff "
             f"columns, {vocab} vocabulary rows")
    if n_scan:
        split += f", {local.rnn_dim} of {cfg.rnn_dim} RG-LRU channels"
    if "slstm" in kinds:
        ff = "split" if rules.spec(("ff",))[0] else "whole"
        width = int(cfg.d_model * cfg.slstm_proj_factor)
        split += f", the sLSTM's ff of {width} {ff}"
    sp = SamplingParams(max_tokens=TP_TOKENS)
    prompts = pipeline_prompts(cfg, TP_REQUESTS)
    t_phase = time.perf_counter()
    out = {"rglru_scan serve": 0}
    for layout in layouts:
        kernel = "decode_attention" if layout == "contiguous" \
            else "paged_attention"
        kw = dict(n_slots=SLOTS, max_len=TP_MAX_LEN, impl="cuda",
                  cache_layout=layout, block_size=BLOCK_SIZE, device=DEVICE)
        one = TensorBackend(cfg, model.params, **kw)
        base = tp_serve(one, prompts, sp, kernels)
        kv_one = ranks.cache_kv_bytes(one.caches)
        state_one = ranks.state_bytes(one.caches, cfg)
        base_logits, base_ms, _ = tp_forced(one, prompts, base["tokens"])
        del one
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        be = TensorBackend(cfg, model.params, mesh=mesh, **kw)
        spawn_s = time.perf_counter() - t0
        try:
            if n_attn and be.info.attn_impl != "cuda":
                raise AssertionError(f"{label} {layout}: attn_impl "
                                     f"{be.info.attn_impl}")
            run = tp_serve(be, prompts, sp, kernels)
            stats = run["stats"]
            steps = [st["calls"]["decode_step"] for st in stats]
            waves = [st["calls"]["prefill"] for st in stats]
            want = [{kernel: n_attn * k, "rglru_scan": n_scan * w}
                    for k, w in zip(steps, waves)]
            got = [{n: st["launches"][n] for n in (kernel, "rglru_scan")}
                   for st in stats]
            others = {n: sum(st["launches"][n] for st in stats)
                      for n in kernels if n not in (kernel, "rglru_scan")}
            one_want = {kernel: n_attn * len(base["decode_ms"]),
                        "rglru_scan": n_scan * base["waves"]}
            if got != want or any(others.values()) \
                    or any(run["launches"].values()) \
                    or {n: base["launches"][n] for n in one_want} \
                    != one_want:
                raise AssertionError(
                    f"{label} {layout}: launches per process {got} over "
                    f"{steps} decode steps and {waves} prefill waves "
                    f"(expected {want}), other kernels {others}, in this "
                    f"process {run['launches']}, in one process "
                    f"{base['launches']} (expected {one_want})")
            kv = be.procs.run(ranks.kv_bytes)
            state = be.procs.run(ranks.recurrent_state_bytes)
            state_want = (state_one[0] // m, state_one[1])
            if kv != [kv_one // heads] * m \
                    or [st[:2] for st in state] != [state_want] * m:
                raise AssertionError(
                    f"{label} {layout}: K/V bytes a process {kv} (one "
                    f"process {kv_one}), recurrent state (split, whole) "
                    f"{[st[:2] for st in state]} (one process {state_one})")
            logits, ms, fstats = tp_forced(be, prompts, base["tokens"])
            diff = np.abs(logits - base_logits)
            agree = int((logits.argmax(-1) == base_logits.argmax(-1)).sum())
            same = sum(int(a == b) for t, u in zip(run["tokens"],
                                                   base["tokens"])
                       for a, b in zip(t, u))
            total = TP_REQUESTS * TP_TOKENS
            print(f"{label} {layout}: {cfg.name} ({cfg.n_layers} layers) on "
                  f"a {mesh.shape} mesh of {m} processes ({split} a "
                  f"process); {TP_REQUESTS} requests of "
                  f"{[len(p) for p in prompts]} prompt tokens x "
                  f"{TP_TOKENS} over {SLOTS} slots, max_len {TP_MAX_LEN}: "
                  f"launches per process {got} = {n_attn} attention layers "
                  f"x {steps} decode steps and {n_scan} RG-LRU layers x "
                  f"{waves} prefill waves, none in this process; K/V bytes "
                  f"a process {kv[0]} (one process {kv_one}); recurrent "
                  f"state a process {state[0][0]} split + {state[0][1]} "
                  f"whole bytes (one process {state_one[0]} + "
                  f"{state_one[1]}); greedy tokens equal to one process's "
                  f"{same}/{total}; teacher-forced logits "
                  f"{list(logits.shape)} max abs diff {diff.max():.4g} "
                  f"(mean {diff.mean():.3g}; "
                  f"{f'atol {LOGITS_ATOL}' if held else 'measured, not held'}"
                  f"), argmax agreement "
                  f"{agree}/{diff.shape[0] * diff.shape[1]} [{card}]")
            if not np.isfinite(logits).all() \
                    or (held and diff.max() > LOGITS_ATOL):
                raise AssertionError(f"{label} {layout}: logits "
                                     f"{diff.max():.4g} from one process's")
            for name, r in (("one process", base), ("processes", run)):
                t = r["decode_ms"]
                print(f"{label} {layout}: {name}: decode ms per step median "
                      f"{statistics.median(t):.3f} (min {min(t):.3f}, max "
                      f"{max(t):.3f}), {total / r['wall']:.1f} tokens/s "
                      f"over {r['wall']:.2f} s [{card}]")
            print(f"{label} {layout}: teacher-forced decode ms per step "
                  f"median: one process {statistics.median(base_ms):.3f}, "
                  f"processes {statistics.median(ms):.3f} [{card}]")
            n = TP_FORCED - 1
            for rank, st in enumerate(fstats):
                tp = st["tp"]
                print(f"{label} {layout}: process {rank}: ms a decode step: "
                      f"host {st['host_s'] / n * 1e3:.3f}, device wait "
                      f"{st['device_s'] / n * 1e3:.3f}, all-reduce and "
                      f"gather {tp['s'] / n * 1e3:.3f} ({tp['calls'] // n} "
                      f"calls, {tp['bytes'] // n} bytes a step) [{card}]")
            print(f"{label} {layout}: spawn {spawn_s:.2f} s (the processes' "
                  f"start {be.procs.spawn_s:.2f} s)")
            out[layout] = sum(g[kernel] for g in got)
            out["rglru_scan serve"] += sum(g["rglru_scan"] for g in got)
            out.setdefault("decode stats", {})[layout] = (n, fstats)
            if layout == layouts[-1]:
                out["score"] = after(be.procs)
        finally:
            be.close()
        del be
    # the backends' step clocks are reference cycles: free their caches
    # before the next phase measures its peak memory
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: phase wall {time.perf_counter() - t_phase:.2f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB held after it "
          f"[{card}]")
    return out


def tp_score(model, procs, kernels, card, label="tp"):
    """``MeshProcs.forward`` over 1 x TP_SCORE_LEN tokens on the tp
    processes (each its split of the model; the head's columns gathered)
    beside ``forward(mode="train")`` in one process: the flash kernel once
    an attention layer and the scan once a RG-LRU layer in each process,
    none in this one, logits within 0.25; both forwards' ms, each
    process's all-reduce ms and bytes.  Returns the launches summed over
    the processes by kernel."""
    from repro_torch.models import transformer as T
    cfg, m = model.cfg, procs.mesh.size
    n_scan = sum(s.kind == "rglru" for s in cfg.layer_specs())
    want = dict(flash_attention=cfg.n_layers - n_scan, rglru_scan=n_scan)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (1, TP_SCORE_LEN))).to(DEVICE)
    with torch.no_grad():
        T.forward(cfg, model.params, tokens, mode="train", impl="cuda")
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        one_out, _ = T.forward(cfg, model.params, tokens, mode="train",
                               impl="cuda")
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
    one = {n: kernels[n].launches for n in want}
    # no warm-up call: the processes have served (a forward over gloo is
    # seconds here, and the staging buffers' growth is milliseconds of it)
    procs.zero_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = procs.forward(tokens)
    ms = (time.perf_counter() - t0) * 1e3
    host = {n: fn.launches for n, fn in kernels.items()}
    stats = procs.stats()
    per = [{n: st["launches"][n] for n in want} for st in stats]
    others = {n: sum(st["launches"][n] for st in stats)
              for n in kernels if n not in want}
    if per != [want] * m or one != want or any(host.values()) \
            or any(others.values()):
        raise AssertionError(f"{label} score: launches per process {per} "
                             f"(expected {want}), other kernels {others}, "
                             f"in this process {host}, in one process {one}")
    diff, agree = mesh_rows(f"{label} score", got, one_out)
    print(f"{label} score: {cfg.name} forward(mode='train') over 1 x "
          f"{TP_SCORE_LEN} tokens on the {m} processes: {ms:.1f} ms (one "
          f"process {one_ms:.1f} ms); launches per process {per[0]}, none "
          f"in this process; logits max abs diff {diff:.4g} (atol "
          f"{LOGITS_ATOL}), argmax agreement {agree}/{TP_SCORE_LEN} [{card}]")
    for rank, st in enumerate(stats):
        tp = st["tp"]
        print(f"{label} score: process {rank}: host "
              f"{st['host_s'] * 1e3:.3f} ms, device wait "
              f"{st['device_s'] * 1e3:.3f} ms ({tp['wait_s'] * 1e3:.3f} of "
              f"it before the collectives); all-reduce and gather "
              f"{tp['s'] * 1e3:.3f} ms, {tp['calls']} calls, {tp['bytes']} "
              f"bytes [{card}]")
    if diff > LOGITS_ATOL:
        raise AssertionError(f"{label} score: logits {diff:.4g} from one "
                             f"process's")
    del got, one_out
    torch.cuda.empty_cache()
    return {n: sum(p[n] for p in per) for n in want}


def mesh_moe(kernels, card):
    """The mesh phase's expert-parallel MoE: granite-moe-1b-a400m at full
    width and depth, ``forward(mode="train")`` over 2 x 512 tokens on a
    (2, 4) mesh of processes under ``use_mesh`` (a batch row a data point,
    the attention tensor-parallel over model, 4 of the 16 heads a process,
    every MoE layer on ``moe_ep`` with 8 of the 32 experts a process).
    Held, in float32 and in bf16 weights at capacity factor 8.0 (no token
    can drop): every process made one ``moe_ep`` call a layer, dropping
    nothing.  In float32 the logits are within ``LOGITS_ATOL`` of the
    one-process ``moe_ragged`` forward's with the processes' expert
    choices replayed (:class:`RouteReplay`: the heads' partial sums change
    the attention's last bits, and a top-k choice can trade on them, as
    in the mixers phase), and the one-process router, fed its own
    activations, chooses the processes' experts on all but
    ``MESH_ROUTE_FLIPS`` of the token routings.  In bf16 the mesh's error
    against the float32 forward replaying its choices is held within
    ``MESH_BF16_FACTOR`` times one bf16 process's (:func:`bf16_error`),
    and within ``LOGITS_ATOL`` of one process with the attention
    replicated (:func:`replicate_attention`), which leaves the heads'
    partial sums as the only difference from one process; at the config's
    own 1.25 the tokens dropped per layer and the all_to_all bytes
    printed.  Returns each process's flash launches."""
    import dataclasses

    from repro_torch.core.mesh_procs import MeshProcs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T
    mesh = make_test_mesh(*MESH_SHAPE)
    t_phase = time.perf_counter()
    launches = None
    for dtype in ("float32", "bfloat16"):
        model = Model(MOE_ARCH, PROMPT_LENS, dtype=dtype)
        own = model.cfg
        wide = dataclasses.replace(own, pattern=tuple(
            dataclasses.replace(s, moe=dataclasses.replace(
                s.moe, capacity_factor=MESH_MOE_CF)) if s.moe else s
            for s in own.pattern))
        tokens = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
            0, own.vocab_size, (MESH_MOE_BATCH, MESH_MOE_LEN))).to(DEVICE)
        own_routes = RouteReplay()
        with own_routes, torch.no_grad():
            want, _ = T.forward(wide, model.params, tokens, mode="train",
                                impl="cuda")
        t0 = time.perf_counter()
        procs = MeshProcs(wide, model.params, mesh, impl="cuda",
                          device=DEVICE)
        spawn_s = time.perf_counter() - t0
        try:
            for cfg in ((wide, own) if dtype == "bfloat16" else (wide,)):
                cf = cfg.pattern[0].moe.capacity_factor
                label = f"mesh {MOE_ARCH} {dtype} capacity {cf:g}"
                if cfg is wide:
                    procs.run(record_routes)
                procs.zero_stats()
                t0 = time.perf_counter()
                got = procs.forward(tokens, cfg)
                secs = time.perf_counter() - t0
                routes = procs.run(collect_routes) if cfg is wide else None
                stats = procs.stats()
                calls = [len(st["moe"]) for st in stats]
                dropped = [sum(st["moe"][l]["dropped"] for st in stats)
                           for l in range(own.n_layers)]
                rows = sum(st["moe"][0]["rows"] for st in stats)
                a2a = stats[0]["moe"][0]["a2a_bytes"]
                per_rank = own.pattern[0].moe.num_experts // MESH_SHAPE[1]
                if calls != [own.n_layers] * mesh.size:
                    raise AssertionError(f"{label}: moe_ep calls per "
                                         f"process {calls}")
                print(f"{label}: forward(mode='train') over "
                      f"{MESH_MOE_BATCH} x {MESH_MOE_LEN} tokens on a "
                      f"{mesh.shape} mesh of processes, {own.n_layers} MoE "
                      f"layers on moe_ep ({per_rank} experts a process, "
                      f"capacity "
                      f"{stats[0]['moe'][0]['cap']} a process and expert): "
                      f"{secs:.2f} s (spawn {spawn_s:.2f} s); assignments "
                      f"dropped per layer {dropped} of {rows}; all_to_all "
                      f"bytes a process and layer {a2a} "
                      f"({a2a * own.n_layers * mesh.size / 1e9:.2f} GB in "
                      f"all) [{card}]")
                mesh_stats(label, procs, card)
                if cfg is not wide:
                    continue
                diff, agree = mesh_rows(label, got, want)
                print(f"{label}: logits against the one-process moe_ragged "
                      f"forward max abs diff {diff:.4g} (measured, not "
                      f"held), argmax agreement {agree}/"
                      f"{MESH_MOE_BATCH * MESH_MOE_LEN} [{card}]")
                # the processes' choices, layer by layer, their token blocks
                # in rank order (moe_ep's split of the batch)
                replay = RouteReplay()
                replay.recorded = [
                    torch.cat([r[layer] for r in routes]).to(DEVICE)
                    for layer in range(own.n_layers)]
                replay.replay()
                with replay, torch.no_grad():
                    replayed, _ = T.forward(wide, model.params, tokens,
                                            mode="train", impl="cuda")
                diff, agree = mesh_rows(label, got, replayed)
                flips = int(MESH_ROUTE_FLIPS * replay.tokens)
                print(f"{label}: logits against the one-process moe_ragged "
                      f"forward with the processes' expert choices max abs "
                      f"diff {diff:.4g}, argmax agreement {agree}/"
                      f"{MESH_MOE_BATCH * MESH_MOE_LEN}; its own would have "
                      f"changed {replay.changed} of {replay.tokens} token "
                      f"routings [{card}]")
                if any(dropped):
                    raise AssertionError(f"{label}: dropped {dropped}")
                if dtype == "float32":
                    if diff > LOGITS_ATOL or replay.changed > flips:
                        raise AssertionError(
                            f"{label}: logits {diff:.4g} apart (atol "
                            f"{LOGITS_ATOL}), {replay.changed} routings "
                            f"changed (at most {flips})")
                else:
                    bf16_error(label, model, wide, tokens, got, replayed,
                               replay, own_routes, card)
                del replayed
                launches = [st["launches"]["flash_attention"]
                            for st in stats]
            if dtype == "bfloat16":
                procs.run(replicate_attention)
                label = f"mesh {MOE_ARCH} {dtype} capacity {MESH_MOE_CF:g}"
                got = procs.forward(tokens, wide)
                diff, agree = mesh_rows(label, got, want)
                print(f"{label}, the attention replicated: logits against "
                      f"the one-process moe_ragged forward max abs diff "
                      f"{diff:.4g} (atol {LOGITS_ATOL}), argmax agreement "
                      f"{agree}/{MESH_MOE_BATCH * MESH_MOE_LEN} [{card}]")
                if diff > LOGITS_ATOL:
                    raise AssertionError(f"{label}, the attention "
                                         f"replicated: logits {diff:.4g} "
                                         f"apart")
        finally:
            procs.close()
        del model, want, got
        gc.collect()
        torch.cuda.empty_cache()
    print(f"mesh {MOE_ARCH}: phase wall {time.perf_counter() - t_phase:.2f} "
          f"s [{card}]")
    return launches


def record_routes(rank):
    """In a mesh process: record the expert ids of every ``router_topk``
    call (a :class:`RouteReplay`) until :func:`collect_routes`."""
    rank.route = RouteReplay().__enter__()


def collect_routes(rank):
    """In a mesh process: stop recording; the expert ids, a call each."""
    rank.route.__exit__(None, None, None)
    return [ids.cpu() for ids in rank.route.recorded]


def replay_routes(rank, recorded):
    """In a mesh process: replay the expert ids ``recorded`` by one process
    over the whole batch (a [T, k] tensor a ``router_topk`` call), this
    process's block of each (``moe_ep``'s split of the tokens, in rank
    order), keeping its own router's choices, until :func:`end_replay`."""
    rank.route = RouteReplay()
    rank.route.kept = []
    rank.route.recorded = [ids.chunk(rank.mesh.size)[rank.rank].to(
        rank.device) for ids in recorded]
    rank.route.replay()
    rank.route.__enter__()


def end_replay(rank):
    """In a mesh process: stop replaying; the routings its own router
    would have changed, a call each, the calls replayed, and its own
    router's choices, a call each (on the host)."""
    rank.route.__exit__(None, None, None)
    return (rank.route.per_call, rank.route.at,
            [ids.cpu() for ids in rank.route.kept])


def replicate_attention(rank):
    """In a mesh process: its view of the model with the attention whole
    (the heads' axes dropped from its rules), the rest placed as
    :func:`~repro_torch.sharding.rules.tensor_parallel` places it."""
    from repro_torch.sharding.rules import (AxisRules, default_rules,
                                            tensor_parallel)
    table = dict(default_rules().rules)
    table.update(heads=None, kv_heads=None, qkv=None)
    rank.tp_cfg, rank.tp_params, rank.rules = tensor_parallel(
        rank.cfg, rank.params, rank.mesh, AxisRules(tuple(table.items())))


def bf16_error(label, model, cfg, tokens, got, one, replay, own_routes,
               card):
    """The bf16 mesh MoE forward held to the model's own bf16 error: the
    one-process forward in float32 weights replaying the processes'
    expert choices is the yardstick; the mesh's logits (``got``) may lie
    at most ``MESH_BF16_FACTOR`` times as far from it as the one-process
    bf16 forward replaying the same choices (``one``) lies, and the
    float32 router may change at most ``MESH_BF16_FACTOR`` times as many
    of the processes' choices as of the one-process bf16 forward's own
    (``own_routes``), plus ``MESH_ROUTE_FLIPS``.  A wrong expert, head sum
    or all_to_all moves the mesh's logits by far more than rounding."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.training.adamw import tree_map
    wide32 = tree_map(lambda t: t.float(), model.params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    runs = {}
    for name, recorded in (("mesh", replay.recorded),
                           ("one", own_routes.recorded)):
        yard = RouteReplay()
        yard.recorded = recorded
        yard.replay()
        with yard, torch.no_grad():
            runs[name] = (T.forward(cfg32, wide32, tokens, mode="train",
                                    impl="cuda")[0], yard.changed,
                          yard.tokens)
    ref32, changed_mesh, n = runs["mesh"]
    changed_one = runs["one"][1]
    del runs, wide32
    e_mesh, agree_mesh = mesh_rows(label, got, ref32)
    e_one, agree_one = mesh_rows(label, one, ref32)
    del ref32
    flips = MESH_BF16_FACTOR * changed_one + int(MESH_ROUTE_FLIPS * n)
    print(f"{label}: logits against the float32 forward with the "
          f"processes' choices: the mesh {e_mesh:.4g} (argmax "
          f"{agree_mesh}/{got.shape[0] * got.shape[1]}), one process in "
          f"bf16 {e_one:.4g} ({agree_one}): x{e_mesh / e_one:.3f} (at most "
          f"x{MESH_BF16_FACTOR}); the float32 router would have changed "
          f"{changed_mesh} of the processes' {n} token routings and "
          f"{changed_one} of one bf16 process's own (at most {flips}) "
          f"[{card}]")
    if e_mesh > MESH_BF16_FACTOR * e_one or changed_mesh > flips:
        raise AssertionError(f"{label}: the mesh's bf16 error {e_mesh:.4g} "
                             f"against one process's {e_one:.4g}, "
                             f"{changed_mesh} routings changed (at most "
                             f"{flips})")


def pipe_stream_prompts(cfg):
    """``PIPE_STREAM_REQUESTS`` prompts from SEED + 2: one shared
    ``PIPE_STREAM_SHARED``-token prefix, then 1-16 seeded tokens of each
    request's own."""
    rng = np.random.default_rng(SEED + 2)
    shared = rng.integers(0, cfg.vocab_size, PIPE_STREAM_SHARED)
    tails = rng.integers(PIPE_STREAM_TAIL[0], PIPE_STREAM_TAIL[1] + 1,
                         PIPE_STREAM_REQUESTS)
    return [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)])
            .astype(np.int32) for n in tails]


def stream_serve(llm, prompts, sp, staged):
    """Serve ``prompts`` under uids 0.. and return the outputs; ``staged``:
    request 0 alone until its first token (its prompt's blocks are then
    registered), then the rest."""
    rest = list(enumerate(prompts))
    if staged:
        llm.submit(prompts[0], sp, uid=0)
        rest = rest[1:]
        while not any(ev.uid == 0 for ev in llm.step()):
            pass
    for uid, prompt in rest:
        llm.submit(prompt, sp, uid=uid)
    while llm.has_work:
        llm.step()
    return [llm.poll(uid) for uid in range(len(prompts))]


def serve_pipeline_streamed(model, kernels, card):
    """Streamed admission on the stage pipeline: prompts sharing a
    ``PIPE_STREAM_SHARED``-token prefix, served plain, then with ``prefill_chunk=16`` and (paged) the
    prefix cache, request 0 first so the rest adopt its prefix blocks.  On
    each layout the streamed serve's greedy tokens equal the plain serve's
    bit for bit (every fed token is the same tick at the same position;
    an adopted block holds the keys request 0 wrote there); the prefix
    hits cut the fed tokens, and the decode kernel launches once a layer
    and fed token."""
    from repro_torch.serving import SamplingParams
    cfg = model.cfg
    prompts = pipe_stream_prompts(cfg)
    sp = SamplingParams(max_tokens=PIPE_STREAM_TOKENS)
    n = len(prompts)
    print(f"pipeline streamed: {n} requests of {[len(p) for p in prompts]} "
          f"prompt tokens ({PIPE_STREAM_SHARED} shared) x "
          f"{PIPE_STREAM_TOKENS} greedy tokens, max_len "
          f"{PIPE_STREAM_MAX_LEN}, chunks of {PIPE_STREAM_CHUNK}")
    out = {}
    for layout in ("paged", "contiguous"):
        t_phase = time.perf_counter()
        kernel = "decode_attention" if layout == "contiguous" \
            else "paged_attention"
        runs = {}
        for kind in ("plain", "streamed"):
            kw = dict(prefix_cache=True, prefill_chunk=PIPE_STREAM_CHUNK) \
                if kind == "streamed" else {}
            llm = plan_pipeline(model, layout, PIPE_STREAM_MAX_LEN, **kw)
            info = llm.backend.info
            if kind == "streamed" and (info.prefix_caching
                                       != (layout == "paged")
                                       or not info.supports_extend):
                raise AssertionError(f"pipeline streamed {layout}: "
                                     f"prefix_caching={info.prefix_caching}, "
                                     f"supports_extend="
                                     f"{info.supports_extend}")
            tick0 = llm.backend.state.tick
            for fn in kernels.values():
                fn.launches = 0
            with FedTicks() as fed:
                t0 = time.perf_counter()
                outs = stream_serve(llm, prompts, sp, kind == "streamed")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in kernels.items()}
            want = {k: cfg.n_layers * fed.fed if k == kernel else 0
                    for k in kernels}
            if launches != want:
                raise AssertionError(f"pipeline {kind} {layout}: launches "
                                     f"{launches}, expected {want}")
            for o in outs:
                if o.n_generated != PIPE_STREAM_TOKENS:
                    raise AssertionError(f"request {o.uid}: {o.n_generated} "
                                         f"tokens")
            st = llm.stats
            ticks = llm.backend.state.tick - tick0
            ttft = [o.timing.ttft_s for o in outs]
            runs[kind] = dict(tokens=[o.tokens for o in outs], fed=fed.fed,
                              hits=st.prefix_hits,
                              hit_tokens=st.prefix_hit_tokens)
            print(f"pipeline {kind} {layout}: {fed.fed} fed tokens, "
                  f"{kernel} launches {launches[kernel]} = {cfg.n_layers} "
                  f"layers x {fed.fed}, the other kernels 0; prefix hits "
                  f"{st.prefix_hits} ({st.prefix_hit_tokens} tokens), "
                  f"{st.prefill_chunks} chunk passes, {ticks} ticks, "
                  f"{wall / ticks * 1e3:.3f} ms a tick on average, "
                  f"{n * PIPE_STREAM_TOKENS / wall:.1f} tokens/s over "
                  f"{wall:.2f} s; TTFT s request 0 {ttft[0]:.3f}, the rest "
                  f"median {statistics.median(ttft[1:]):.3f} [{card}]")
            del llm
            torch.cuda.empty_cache()
        plain, streamed = runs["plain"], runs["streamed"]
        same = sum(int(a == b) for t, u in zip(streamed["tokens"],
                                               plain["tokens"])
                   for a, b in zip(t, u))
        print(f"pipeline streamed {layout}: greedy tokens equal to the plain "
              f"serve's: {same}/{n * PIPE_STREAM_TOKENS}; phase wall "
              f"{time.perf_counter() - t_phase:.2f} s")
        if streamed["tokens"] != plain["tokens"]:
            raise AssertionError(f"pipeline streamed {layout}: tokens differ "
                                 f"from the plain serve's")
        hits = streamed["hits"]
        if layout == "paged" and (
                hits < n - 1 or streamed["fed"] != plain["fed"]
                - streamed["hit_tokens"]):
            raise AssertionError(f"pipeline streamed paged: {hits} hits "
                                 f"({streamed['hit_tokens']} tokens), "
                                 f"{streamed['fed']} fed against "
                                 f"{plain['fed']}")
        if layout == "contiguous" and (hits or streamed["fed"]
                                       != plain["fed"]):
            raise AssertionError(f"pipeline streamed contiguous: {hits} "
                                 f"hits, {streamed['fed']} fed against "
                                 f"{plain['fed']}")
        out[layout] = cfg.n_layers * streamed["fed"]
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


def train_batches():
    """``TRAIN_MESH_STEPS`` + 1 batches of ``TRAIN_BATCH`` x ``TRAIN_LEN``
    tokens of the synthetic stream, on the card: the steps' and the
    evaluation's."""
    from repro_torch.training import DataConfig, make_dataset
    data = make_dataset(DataConfig(vocab_size=TRAIN_DATA_VOCAB,
                                   seq_len=TRAIN_LEN, batch=TRAIN_BATCH,
                                   seed=SEED))
    return [tuple(torch.from_numpy(a).to(DEVICE, torch.long)
                  for a in data.batch_at(i))
            for i in range(TRAIN_MESH_STEPS + 1)]


def one_process_steps(cfg, tcfg, params, batches):
    """The one-process ``make_train_step`` over ``batches`` from a copy of
    ``params``: each step's loss and gradient norm, its ms, and the final
    parameters on the host; the copy freed, so that its memory is the
    mesh processes' before they spawn."""
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.adamw import tree_leaves, tree_map
    one_params = tree_map(lambda t: t.clone(), params)
    one_opt, one = adamw_init(one_params), make_train_step(cfg, tcfg)
    want, ms = [], []
    for tokens, labels in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_params, one_opt, m = one(one_params, one_opt, tokens, labels)
        want.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        ms.append((time.perf_counter() - t0) * 1e3)
    final = [t.detach().cpu() for t in tree_leaves(one_params)]
    del one_params, one_opt, m
    gc.collect()
    torch.cuda.empty_cache()
    return want, ms, final


def mesh_train_steps(label, step, params, opt, batches, want, card,
                     before=None):
    """The mesh step ``step`` over ``batches``, each step's loss and
    gradient norm held within ``TRAIN_MESH_TOL`` of the one process's
    (``want``); ``before(i, params, tokens)``, where given, runs ahead of
    step ``i``, untimed, on the weights it starts from.  Returns (the
    trees, each step's ms, each process's stats of the last step)."""
    procs, mesh_ms = step.procs, []
    for i, (tokens, labels) in enumerate(batches):
        if before is not None:
            before(i, params, tokens)
        if i == len(batches) - 1:
            procs.zero_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, tokens, labels)
        mesh_ms.append((time.perf_counter() - t0) * 1e3)
        got = want[i]
        print(f"{label}: step {i}: loss {m['loss']:.6f} (one process "
              f"{got['loss']:.6f}), grad norm {m['grad_norm']:.6f} "
              f"({got['grad_norm']:.6f}), lr {m['lr']:.3e} [{card}]")
        for k in ("loss", "grad_norm"):
            if abs(m[k] - got[k]) > TRAIN_MESH_TOL["atol"] \
                    + TRAIN_MESH_TOL["rtol"] * abs(got[k]):
                raise AssertionError(f"{label}: step {i} {k} {m[k]} "
                                     f"against one process's {got[k]} "
                                     f"({TRAIN_MESH_TOL})")
    return params, opt, mesh_ms, procs.stats()


def leaves_apart(params, final):
    """Each leaf's max abs difference between the trained ``params`` and
    the one process's ``final`` leaves (on the host)."""
    from repro_torch.training.adamw import tree_leaves
    with torch.no_grad():
        return [float((a.detach().cpu() - b).abs().max())
                for a, b in zip(tree_leaves(params), final)]


def mesh_evaluate(label, step, layers, card):
    """The trained shards' evaluation loss of the last batch under
    ``no_grad`` on the processes, ``impl="cuda"`` (the flash kernel, a
    launch a layer and process) within ``LOSS_ATOL`` of ``impl="ref"``'s
    (none).  Returns the flash launches summed over the processes."""
    procs = step.procs
    tokens, labels = train_batches()[-1]
    loss, launches = {}, {}
    for impl in ("cuda", "ref"):
        procs.zero_stats()
        t0 = time.perf_counter()
        loss[impl] = step.evaluate(tokens, labels, impl)
        secs = time.perf_counter() - t0
        launches[impl] = [st["launches"]["flash_attention"]
                          for st in procs.stats()]
        print(f"{label}: evaluation loss under no_grad on the processes, "
              f"impl {impl}: {loss[impl]:.6f} in {secs:.2f} s, "
              f"flash_attention launches a process {launches[impl]} "
              f"[{card}]")
    n = procs.mesh.size
    if launches["cuda"] != [layers] * n or any(launches["ref"]) \
            or not np.isfinite(loss["cuda"]) \
            or abs(loss["cuda"] - loss["ref"]) > LOSS_ATOL:
        raise AssertionError(f"{label}: evaluation loss cuda "
                             f"{loss['cuda']} vs ref {loss['ref']} (atol "
                             f"{LOSS_ATOL}), launches {launches}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: evaluation loss cuda against ref: diff "
          f"{abs(loss['cuda'] - loss['ref']):.3g} (atol {LOSS_ATOL}); "
          f"flash_attention launches {sum(launches['cuda'])} = {layers} "
          f"layers x {n} processes, none in this process; peak device "
          f"memory of this process {peak:.2f} GB [{card}]")
    return sum(launches["cuda"])


def train_mesh(card):
    """qwen3-0.6b at full width and depth in float32 weights, trained on a
    ``TRAIN_MESH_SHAPE`` (data, model) mesh of processes on the one card
    (:class:`~repro_torch.training.train_loop.MeshTrainStep`: a process's
    rows of the batch, its heads, ``ff`` columns and vocabulary rows;
    autograd through the tensor-parallel collectives; the gradients
    averaged over ``data`` in one flat buffer), beside the one-process
    ``make_train_step`` on the same weights and batches:
    ``TRAIN_MESH_STEPS`` AdamW steps of ``TRAIN_BATCH`` x ``TRAIN_LEN``
    tokens on ``impl="ref"``.  Held: each step's loss and gradient norm
    within ``TRAIN_MESH_TOL`` of one process's, the parameters after the
    last step within twice the steps' summed learning rates (two AdamW
    updates apart at most, ``train_mesh_bound``), then the trained shards'
    evaluation loss under ``no_grad`` through the flash kernel on the
    same processes (28 launches a process) within ``LOSS_ATOL`` of
    ``impl="ref"``'s.  Printed: the spawn, the steps' ms, each process's
    collectives (tensor-parallel and data, count, bytes, seconds) and
    peak memory.  Returns the flash launches summed over the processes
    (``flash``) and each process's stats of the last step (``stats``),
    which the dry-run phase reads."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.core.mesh_procs import MeshProcs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.training import AdamWConfig, TrainConfig, adamw_init
    from repro_torch.training.adamw import lr_schedule, tree_leaves
    from repro_torch.training.train_loop import MeshTrainStep
    t_phase = time.perf_counter()
    label = f"train mesh {TRAIN_ARCH}"
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
    mesh = Mesh(("data", "model"), TRAIN_MESH_SHAPE)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1,
                          total_steps=TRAIN_MESH_STEPS)
    tcfg = TrainConfig(impl="ref", optimizer=opt_cfg)
    gen = torch.Generator(device=DEVICE)
    params = init_params(cfg, gen.manual_seed(SEED), DEVICE)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batches = train_batches()[:-1]
    want, one_ms, one_final = one_process_steps(cfg, tcfg, params, batches)
    opt = adamw_init(params)
    t0 = time.perf_counter()
    procs = MeshProcs(cfg, params, mesh, impl="cuda", device=DEVICE)
    spawn_s = time.perf_counter() - t0
    try:
        step = MeshTrainStep(cfg, tcfg, procs=procs)
        params, opt, mesh_ms, stats = mesh_train_steps(
            label, step, params, opt, batches, want, card)
        bound = train_mesh_bound(opt_cfg, TRAIN_MESH_STEPS, lr_schedule)
        diffs = leaves_apart(params, one_final)
        diff = max(diffs)
        print(f"{label}: {cfg.n_layers} layers, {n_params / 1e6:.1f} M "
              f"parameters in float32 on a {mesh.shape} mesh of "
              f"{mesh.size} processes ({cfg.n_heads // mesh.shape['model']}"
              f" query and {cfg.n_kv_heads // mesh.shape['model']} K/V "
              f"heads, {cfg.d_ff // mesh.shape['model']} ff columns, "
              f"{cfg.vocab_size // mesh.shape['model']} vocabulary rows and "
              f"{TRAIN_BATCH // mesh.shape['data']} of {TRAIN_BATCH} rows a "
              f"process): {TRAIN_MESH_STEPS} AdamW steps of {TRAIN_BATCH} x "
              f"{TRAIN_LEN} tokens, impl ref; spawn {spawn_s:.2f} s; step "
              f"ms {[round(t, 1) for t in mesh_ms]} (one process "
              f"{[round(t, 1) for t in one_ms]}; host clock, the metrics "
              f"read back); parameters after step {TRAIN_MESH_STEPS} max "
              f"abs diff {diff:.4g} (bound {bound:.4g}: two AdamW updates "
              f"apart at most), {sum(d > 0 for d in diffs)} of "
              f"{len(diffs)} leaves differ [{card}]")
        for rank, st in enumerate(stats):
            tp, dp = st["tp"], st["dp"]
            print(f"{label}: process {rank} {mesh.coords(rank)}, the last "
                  f"step: tp {tp['calls']} collectives, {tp['bytes']} bytes, "
                  f"{tp['s']:.3f} s (device wait before them "
                  f"{tp['wait_s']:.3f} s); data {dp['calls']} collectives, "
                  f"{dp['bytes']} bytes, {dp['s']:.3f} s; peak device memory "
                  f"{st['peak_bytes'] / 1e9:.2f} GB [{card}]")
        if diff > bound:
            raise AssertionError(f"{label}: parameters {diff:.4g} apart "
                                 f"after {TRAIN_MESH_STEPS} steps (bound "
                                 f"{bound:.4g})")
        del one_final
        flash = mesh_evaluate(label, step, cfg.n_layers, card)
    finally:
        procs.close()
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: phase wall {time.perf_counter() - t_phase:.2f} s "
          f"[{card}]")
    return dict(flash=flash, stats=stats)


class BlockAux:
    """``router_topk`` with its expert choices recorded, and its
    load-balance term the mean of ``n`` equal token blocks' Switch terms:
    the reference's ``moe_ep`` takes ``jnp.mean`` of its devices' terms,
    each over its block of the tokens (``src/repro/models/moe.py:149-167``),
    so a mesh step's loss is that mean.  With it the one-process
    ``moe_ragged`` step computes the mesh step's function: at a capacity
    that drops nothing the two differ in the order of their sums only."""

    def __init__(self, n):
        from repro_torch.models import moe
        self.moe, self.own, self.n = moe, moe.router_topk, n
        self.recorded = []

    def __enter__(self):
        self.moe.router_topk = self._route
        return self

    def __exit__(self, *exc):
        self.moe.router_topk = self.own

    def _route(self, router_w, x, moe):
        probs, ids, _ = self.own(router_w, x, moe)
        self.recorded.append(ids.detach().cpu())
        aux = torch.stack([self.own(router_w, xb, moe)[2]
                           for xb in x.chunk(self.n)]).mean()
        return probs, ids, aux


def multipod_depth(label, base, mesh, card):
    """The multi-pod phase's depth from the port's dry run
    (``launch/dryrun.py``, a process's train step on ``meta``): the most
    layers up to ``MULTIPOD_MAX_LAYERS`` whose plan fits (the constants'
    comment); a process's predicted peak is its arguments as it holds them
    plus its temp peak.  Returns (the layers, the record at that depth)."""
    import dataclasses

    from repro_torch.launch import dryrun as D
    from repro_torch.models.config import InputShape
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    budget = MULTIPOD_MEM_SHARE * free
    shape = InputShape("multi-pod", TRAIN_LEN, TRAIN_BATCH, "train")
    plans = {}

    def need(layers):
        if layers not in plans:
            cfg = dataclasses.replace(base, n_layers=layers)
            t0 = time.perf_counter()
            rec = D.analyse(cfg, shape, mesh)
            peak = rec["process_argument_bytes"] + rec["temp_size_in_bytes"]
            host = 3 * 4 * cfg.param_count()
            total = mesh.size * (peak * (1 + DRYRUN_PEAK_RTOL)
                                 + MULTIPOD_PROC_BYTES) + host
            plans[layers] = (total, rec)
            print(f"{label}: dry run at {layers} layers: a process's peak "
                  f"{peak / 1e9:.3f} GB predicted, the plan {total / 1e9:.2f}"
                  f" GB of the budget {budget / 1e9:.2f} GB "
                  f"({MULTIPOD_MEM_SHARE:.0%} of {free / 1e9:.2f} GB free) "
                  f"({time.perf_counter() - t0:.2f} s on meta) [{card}]")
        return plans[layers][0]

    top = MULTIPOD_MAX_LAYERS
    layers = top
    if need(top) > budget:
        per_layer = (need(top) - need(1)) / (top - 1)
        layers = max(1, min(top, int(1 + (budget - need(1)) // per_layer)))
        while layers > 1 and need(layers) > budget:
            layers -= 1
    if need(layers) > budget:
        raise AssertionError(f"{label}: not one layer fits the card")
    return layers, plans[layers][1]


def multipod_phase(card):
    """granite-moe-1b-a400m at full width in float32 weights trained on a
    ``MULTIPOD_SHAPE`` (pod, data, model) mesh of 8 processes on the one
    card (:class:`~repro_torch.training.train_loop.MeshTrainStep`: a
    process's row of the batch over ``(pod, data)``, its heads over
    ``model``, every MoE layer on ``moe_ep`` with the batch gathered over
    ``(pod, data)``, its tokens split over all three axes and 16 experts
    a process; the gradients averaged over ``(pod, data)`` in one flat
    buffer, the whole leaves' shares summed over ``model``), at the depth
    the dry run sizes (:func:`multipod_depth`).  First the one-process
    ``make_train_step`` on ``impl="ref"`` (``moe_ragged``, its
    load-balance term the mesh's, :class:`BlockAux`) takes
    ``TRAIN_MESH_STEPS`` AdamW steps of ``TRAIN_BATCH`` x ``TRAIN_LEN``
    tokens; its losses, gradient norms and final parameters are kept on
    the host and it is freed; then the mesh takes the same steps, its
    processes replaying the one process's expert choices
    (:class:`RouteReplay`, each its block of the tokens): a top-k choice
    is discontinuous, and from the second step the two sides' weights
    differ within the AdamW bound, so a near-tie can trade.  Held: each
    step's loss and gradient norm within ``TRAIN_MESH_TOL`` of one
    process's, the parameters within ``train_mesh_bound``, in every step
    the routings where the processes' own routers chose otherwise than
    the one process's router on the same weights and the same replayed
    choices (its forward on the weights the mesh starts the step from,
    ahead of the step: so the two sides differ only in the mesh's partial
    sums, as the mesh phase counts them), at most ``MESH_ROUTE_FLIPS`` of
    them, every ``moe_ep`` call dropping nothing,
    then the trained shards' evaluation under ``no_grad`` through the
    flash kernel on the same processes (a launch a layer and process)
    within ``LOSS_ATOL`` of ``impl="ref"``'s.  Printed: the depth's plan,
    the spawn, the steps' ms, each process's collectives (tensor-parallel
    and data tallies, and by kind) and peak memory.  Returns the flash
    launches summed over the processes (``flash``), each process's stats
    of the last step (``stats``) and the config trained (``cfg``)."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.core.mesh_procs import MeshProcs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.training import AdamWConfig, TrainConfig, adamw_init
    from repro_torch.training.adamw import lr_schedule, tree_leaves
    from repro_torch.training.train_loop import MeshTrainStep
    t_phase = time.perf_counter()
    label = f"multi-pod {MOE_ARCH}"
    mesh = Mesh(("pod", "data", "model"), MULTIPOD_SHAPE)
    own = get_config(MOE_ARCH)
    base = dataclasses.replace(own, dtype="float32", pattern=tuple(
        dataclasses.replace(s, moe=dataclasses.replace(
            s.moe, capacity_factor=MULTIPOD_CF)) if s.moe else s
        for s in own.pattern))
    layers, _ = multipod_depth(label, base, mesh, card)
    cfg = dataclasses.replace(base, n_layers=layers)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1,
                          total_steps=TRAIN_MESH_STEPS)
    tcfg = TrainConfig(impl="ref", optimizer=opt_cfg)
    gen = torch.Generator(device=DEVICE)
    params = init_params(cfg, gen.manual_seed(SEED), DEVICE)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batches = train_batches()[:-1]
    with BlockAux(mesh.size) as one_routes:
        want, one_ms, one_final = one_process_steps(cfg, tcfg, params,
                                                    batches)
    opt = adamw_init(params)
    same = []

    def one_router(i, params, tokens):
        """Ahead of mesh step ``i``: the one process's forward on the
        weights the mesh starts the step from, replaying the choices the
        mesh processes replay in it, its own router's choices kept."""
        route = RouteReplay()
        route.recorded = [ids.to(DEVICE) for ids in
                          one_routes.recorded[i * layers:(i + 1) * layers]]
        route.kept = []
        route.replay()
        with route, torch.no_grad():
            T.forward(cfg, params, tokens, mode="train", impl="ref")
        same.extend(ids.cpu() for ids in route.kept)
        del route
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    procs = MeshProcs(cfg, params, mesh, impl="cuda", device=DEVICE)
    spawn_s = time.perf_counter() - t0
    try:
        step = MeshTrainStep(cfg, tcfg, procs=procs)
        procs.run(replay_routes, one_routes.recorded)
        params, opt, mesh_ms, stats = mesh_train_steps(
            label, step, params, opt, batches, want, card, before=one_router)
        replayed = procs.run(end_replay)
        n_calls = len(one_routes.recorded)
        if any(at != n_calls for _, at, _ in replayed) \
                or len(same) != n_calls:
            raise AssertionError(f"{label}: router calls replayed "
                                 f"{[at for _, at, _ in replayed]}, "
                                 f"recorded {n_calls}, on the mesh's "
                                 f"weights {len(same)}")
        # the processes' own choices, their token blocks in rank order
        # (moe_ep's split of the batch), against the one process's router
        # on the same weights
        mesh_own = [torch.cat([kept[c] for _, _, kept in replayed])
                    for c in range(n_calls)]
        flipped = [int((a.sort(-1).values != b.sort(-1).values).any(-1)
                       .sum()) for a, b in zip(mesh_own, same)]
        same_steps = [sum(flipped[i * layers:(i + 1) * layers])
                      for i in range(TRAIN_MESH_STEPS)]
        changed_steps = [sum(sum(c[i * layers:(i + 1) * layers])
                             for c, _, _ in replayed)
                         for i in range(TRAIN_MESH_STEPS)]
        n_routes = sum(ids.shape[0] for ids in one_routes.recorded)
        per_step = int(MESH_ROUTE_FLIPS * n_routes / TRAIN_MESH_STEPS)
        dropped = sum(c["dropped"] for st in stats for c in st["moe"])
        bound = train_mesh_bound(opt_cfg, TRAIN_MESH_STEPS, lr_schedule)
        diffs = leaves_apart(params, one_final)
        diff = max(diffs)
        experts, m = cfg.pattern[0].moe.num_experts, mesh.shape["model"]
        rows = mesh.size // m
        print(f"{label}: {layers} of {own.n_layers} layers (the dry run's "
              f"depth), {n_params / 1e6:.1f} M parameters in float32 on a "
              f"{mesh.shape} mesh of {mesh.size} processes ({experts // m} "
              f"of {experts} experts, {cfg.n_heads // m} query and "
              f"{cfg.n_kv_heads // m} K/V heads and {TRAIN_BATCH // rows} of "
              f"{TRAIN_BATCH} rows a process, the vocabulary whole), "
              f"capacity {MULTIPOD_CF:g}: "
              f"{TRAIN_MESH_STEPS} AdamW steps of {TRAIN_BATCH} x "
              f"{TRAIN_LEN} tokens, impl ref; spawn {spawn_s:.2f} s; step "
              f"ms {[round(t, 1) for t in mesh_ms]} (one process "
              f"{[round(t, 1) for t in one_ms]}; host clock, the metrics "
              f"read back); parameters after step {TRAIN_MESH_STEPS} max "
              f"abs diff {diff:.4g} (bound {bound:.4g}), "
              f"{sum(d > 0 for d in diffs)} of {len(diffs)} leaves differ; "
              f"routings where the processes' own routers chose otherwise "
              f"than the one process's router on the same weights, by "
              f"step, {same_steps} of {n_routes // TRAIN_MESH_STEPS} a "
              f"step (at most {per_step} a step); than the one process's "
              f"own trajectory's choices, replayed, {changed_steps} "
              f"(its weights differ within the bound from step 1: "
              f"measured, not held); assignments dropped {dropped} "
              f"[{card}]")
        for rank, st in enumerate(stats):
            tp, dp, kinds = st["tp"], st["dp"], st["collectives"]
            print(f"{label}: process {rank} {mesh.coords(rank)}, the last "
                  f"step: tp {tp['calls']} collectives, {tp['bytes']} bytes, "
                  f"{tp['s']:.3f} s (the shares' sum over model among them; "
                  f"device wait before them {tp['wait_s']:.3f} s); data "
                  f"over (pod, data) {dp['calls']} all-reduce, {dp['bytes']}"
                  f" bytes, {dp['s']:.3f} s; by kind: all-to-all over model "
                  f"{kinds['all-to-all']} (2 a layer forward and backward), "
                  f"all-gather {kinds['all-gather']} (the batch over (pod, "
                  f"data) and moe_ep's blocks over the mesh, a layer), "
                  f"all-reduce {kinds['all-reduce']}; peak device memory "
                  f"{st['peak_bytes'] / 1e9:.2f} GB [{card}]")
        if diff > bound or dropped or max(same_steps) > per_step:
            raise AssertionError(f"{label}: parameters {diff:.4g} apart "
                                 f"(bound {bound:.4g}), routings changed "
                                 f"on the same weights by step "
                                 f"{same_steps} (at most {per_step} a "
                                 f"step), {dropped} assignments dropped")
        del one_final, mesh_own
        flash = mesh_evaluate(label, step, layers, card)
    finally:
        procs.close()
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: phase wall {time.perf_counter() - t_phase:.2f} s "
          f"[{card}]")
    return dict(flash=flash, stats=stats, cfg=cfg)


def examples_phase(kernels, card):
    """The port's drivers as a user runs them (``repro_torch.examples``,
    the reference's ``examples/``), in this process: ``quickstart`` and
    ``partition_plan`` (its defaults and ``--objective throughput
    --cloud-bw 10``) on the host; ``serve_pipeline`` on the card (a
    planned 4-stage pipeline with the kernels, every token checked against
    the tensor backend's, then ``stream``); ``train_tiny`` on the card.
    Each holds its own asserts; the kernel launches of each are printed.
    Each ``LLM.generate`` call's launches are counted around it alone:
    ``serve_pipeline``'s pipeline must have run the ring kernel, and its
    tensor backend, the check on ``impl="ref"``, no kernel."""
    from repro_torch.examples import (partition_plan, quickstart,
                                      serve_pipeline, train_tiny)
    from repro_torch.serving import LLM
    t_phase = time.perf_counter()
    generate, served = LLM.generate, []

    def counted(llm, *args, **kwargs):
        before = {n: k.launches for n, k in kernels.items()}
        out = generate(llm, *args, **kwargs)
        served.append((type(llm.backend).__name__,
                       {n: k.launches - before[n] for n, k in kernels.items()
                        if k.launches != before[n]}))
        return out

    runs = (("quickstart", quickstart.main, ()),
            ("partition_plan", partition_plan.main, ([],)),
            ("partition_plan --objective throughput --cloud-bw 10",
             partition_plan.main,
             (["--objective", "throughput", "--cloud-bw", "10"],)),
            ("serve_pipeline", serve_pipeline.main, ([],)),
            ("train_tiny", train_tiny.main, ([],)))
    launches = {}
    for name, fn, args in runs:
        for k in kernels.values():
            k.launches = 0
        print(f"examples: python -m repro_torch.examples.{name}", flush=True)
        served.clear()
        LLM.generate = counted
        t0 = time.perf_counter()
        try:
            fn(*args)
        finally:
            LLM.generate = generate
        launches[name] = {n: k.launches for n, k in kernels.items()
                          if k.launches}
        print(f"examples: {name}: its own checks held in "
              f"{time.perf_counter() - t0:.2f} s; kernel launches "
              f"{launches[name]}; LLM.generate calls (backend, launches) "
              f"{served} [{card}]", flush=True)
        if name == "serve_pipeline":
            pipe = [got for kind, got in served if kind == "PipelineBackend"]
            check = [got for kind, got in served if kind == "TensorBackend"]
            if len(pipe) != 1 or not pipe[0].get("decode_attention") \
                    or len(check) != 1 or check[0]:
                raise AssertionError(f"examples: serve_pipeline's pipeline "
                                     f"generate must launch decode_attention"
                                     f" and its ref check none: {served}")
    print(f"examples: phase wall {time.perf_counter() - t_phase:.2f} s "
          f"[{card}]")


def train_mesh_bound(opt_cfg, steps, lr_schedule):
    """The most two AdamW trajectories from the same weights can part in
    ``steps`` steps: an update moves an element by its step's learning
    rate times |m_hat / (sqrt(v_hat) + eps)| plus the decay, and by
    Cauchy-Schwarz that ratio is at most 1.001 in the first three steps
    at b1 = 0.9, b2 = 0.95; the decay only shrinks a difference.  So
    2.002 times the summed rates, and 1e-6 for float32 rounding."""
    if steps > 3 or (opt_cfg.b1, opt_cfg.b2) != (0.9, 0.95):
        raise ValueError("train_mesh_bound holds for three steps at "
                         "b1 = 0.9, b2 = 0.95")
    return 2.002 * sum(lr_schedule(opt_cfg, t)
                       for t in range(1, steps + 1)) + 1e-6


def dryrun_phase(card, tp, train_mesh_out, procs_out, multipod_out):
    """The dry runs against the phases' measurements (phase 7 of the
    module's docstring).  Returns nothing: a miss raises."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import dryrun_pipeline as DP
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.config import InputShape
    t_phase = time.perf_counter()
    allocated = torch.cuda.memory_allocated()
    label = "dry run"

    def kinds(rec, n=1):
        return {k: dict(calls=n * rec["collective_calls"][k],
                        bytes=n * int(rec["collective_bytes"][k]))
                for k in rec["collective_calls"]}

    def short(x):
        """``x`` without its zero tallies, for the lines printed."""
        if isinstance(x, dict):
            return {k: short(v) for k, v in x.items()
                    if not (isinstance(v, dict) and not any(v.values()))}
        if isinstance(x, (tuple, list)):
            return type(x)(short(v) for v in x)
        return x

    def held(what, got, want):
        if got != want:
            raise AssertionError(f"{label}: {what}: measured {got}, dry run "
                                 f"{want}")
        print(f"{label}: {what}: measured {short(got)}, the dry run's "
              f"exactly [{card}]")

    # the tp phase's decode step, a process's collectives
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    rec = D.analyse(cfg, InputShape("tp decode", TP_MAX_LEN, SLOTS,
                                    "decode"),
                    Mesh(("data", "model"), TP_SHAPE))
    print(f"{label}: {cfg.name} decode step of {SLOTS} slots at max_len "
          f"{TP_MAX_LEN} on a {TP_SHAPE} mesh, a process: tp {rec['tp']}, "
          f"by kind {short(kinds(rec))} ({time.perf_counter() - t0:.2f} s "
          f"on meta)")
    for layout, (n, stats) in tp["decode stats"].items():
        for rank, st in enumerate(stats):
            got = {k: st["tp"][k] for k in ("calls", "bytes")}
            held(f"tp {layout} process {rank} collectives over {n} decode "
                 f"step(s)", (got, st["collectives"]),
                 ({k: n * v for k, v in rec["tp"].items()}, kinds(rec, n)))

    # the train mesh and multi-pod phases' last steps, a process's
    # collectives and peak (its arguments as it holds them: a trainer's
    # private copies hold every expert)
    for what, cfg, mesh, out in (
            ("train mesh", dataclasses.replace(get_config(TRAIN_ARCH),
                                               dtype="float32"),
             Mesh(("data", "model"), TRAIN_MESH_SHAPE), train_mesh_out),
            ("multi-pod", multipod_out["cfg"],
             Mesh(("pod", "data", "model"), MULTIPOD_SHAPE), multipod_out)):
        t0 = time.perf_counter()
        rec = D.analyse(cfg, InputShape(what, TRAIN_LEN, TRAIN_BATCH,
                                        "train"), mesh)
        peak = rec["process_argument_bytes"] + rec["temp_size_in_bytes"]
        print(f"{label}: {cfg.name} ({cfg.n_layers} layers) float32 train "
              f"step of {TRAIN_BATCH} x {TRAIN_LEN} on a {mesh.shape} mesh, "
              f"a process: tp {rec['tp']}, dp {rec['dp']}, by kind "
              f"{short(kinds(rec))}, arguments "
              f"{rec['process_argument_bytes']} + temp peak "
              f"{rec['temp_size_in_bytes']} = {peak} bytes; flops "
              f"{rec['cost_analysis']['flops']:.6g}, bytes accessed "
              f"{rec['cost_analysis']['bytes accessed']:.6g} "
              f"({time.perf_counter() - t0:.2f} s on meta)")
        for rank, st in enumerate(out["stats"]):
            got = ({k: st[t][k] for k in ("calls", "bytes")}
                   for t in ("tp", "dp"))
            held(f"{what} process {rank} last step's collectives",
                 (*got, st["collectives"]),
                 (rec["tp"], rec["dp"], kinds(rec)))
            off = st["peak_bytes"] / peak - 1
            print(f"{label}: {what} process {rank}: peak device memory "
                  f"{st['peak_bytes']} bytes against the dry run's {peak} "
                  f"({off:+.4%}; bound {DRYRUN_PEAK_RTOL:.0%}) [{card}]")
            if abs(off) > DRYRUN_PEAK_RTOL:
                raise AssertionError(f"{label}: {what} process {rank} peak "
                                     f"{st['peak_bytes']} against {peak}")

    # the pipeline procs phase: every stage's tick
    cfg = get_config(ARCH)
    spec = procs_out["spec"]
    mesh = Mesh(("data", "model"), (1, spec.n_stages))
    shape = InputShape("procs", PIPE_MAX_LEN, SLOTS, "decode")
    for vocab in (False, True):
        t0 = time.perf_counter()
        rec = DP.analyse_pipeline(cfg, shape, mesh, spec, SLOTS,
                                  vocab_sharded=vocab)
        print(f"{label}: {cfg.name} {spec.periods_per_stage} tick"
              f"{' vocab-sharded' if vocab else ''}, each stage's "
              f"collectives a tick "
              f"{[short(kinds(st)) for st in rec['stages']]} "
              f"({time.perf_counter() - t0:.2f} s on meta)")
        runs = [("vocab-sharded", procs_out["vocab stats"])] if vocab \
            else list(procs_out["stats"].items())
        for what, stats in runs:
            first, last = stats[0]["live"], stats[-1]["live"]
            for st, dry in zip(stats, rec["stages"]):
                live = st["live"]
                calls = dry["collective_calls"]
                want = {k: dict(calls=n * calls[k],
                                bytes=n * int(dry["collective_bytes"][k]))
                        for k, n in (("collective-permute", live),
                                     ("all-reduce", first),
                                     ("broadcast", last))}
                hop = int(dry["collective_bytes"]["collective-permute"])
                held(f"pipeline procs {what} stage {dry['stage']} over "
                     f"{live} live ticks: hop bytes and collectives",
                     (st["hop_bytes"], {k: st["collectives"][k]
                                        for k in want}),
                     (live * hop, want))

    # two production records
    for what, fn in (("run_one(llama2-7b, decode_32k) on 16 x 16",
                      lambda: D.run_one(ARCH, "decode_32k")),
                     ("run_pipeline_one(llama2-7b, decode_32k, layout=dp)",
                      lambda: DP.run_pipeline_one(ARCH, "decode_32k",
                                                  layout="dp"))):
        t0 = time.perf_counter()
        rec = fn()
        wall = time.perf_counter() - t0
        print(f"{label}: {what}: {wall:.2f} s wall (run_s {rec['run_s']}); "
              f"flops {rec['cost_analysis']['flops']:.6g}, bytes accessed "
              f"{rec['cost_analysis']['bytes accessed']:.6g}, arguments "
              f"{rec['argument_size_in_bytes']}, outputs "
              f"{rec['output_size_in_bytes']}, temp peak "
              f"{rec['temp_size_in_bytes']}, collective bytes "
              f"{rec['collective_bytes']['total']:.6g} "
              f"({'the largest stage' if 'stages' in rec else 'a process'})")
    after = torch.cuda.memory_allocated()
    held("device memory allocated by the phase", after - allocated, 0)
    print(f"{label}: phase wall {time.perf_counter() - t_phase:.2f} s "
          f"[{card}]")


def device_share(label, what, run, card):
    """The card's busy share over one profiled call of ``run`` (``what``
    says what it does), and the device time by kernel.  The profiler adds
    host time, so the busy share it shows is a lower bound.

    The device events are read from the profiler's raw results: building
    its Python event tree (``prof.events()``) over the host ops of a
    serve's window takes tens of seconds, and none of it is read here."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    results = prof.profiler.kineto_results
    for e in results.events() if results is not None else ():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0.0) \
                + (e.end_ns() - e.start_ns()) / 1e3
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

    t0 = t_start = time.perf_counter()
    built = build.build()
    print(f"build: {built.path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for source, log in built.logs.items():
        print(f"build: {source}: nvcc {built.seconds[source]:.1f} s")
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"build:   {line.strip()[:140]}")

    d256_instances(built.logs)
    t_kernels = time.perf_counter()

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
        # the hybrid's paged decode: 4 x 8.4 MB of K/V per set, 8 sets
        # exceed the L2
        "paged_attention hybrid": time_paged(
            pa, card, 1, HYBRID_WINDOW, heads=(10, 1, 256), n_sets=8,
            window=HYBRID_WINDOW),
        # the fleet's decode: 4 slots of up to 128 keys a replica
        "paged_attention fleet": time_paged(pa, card, 1, FLEET_MAX_LEN,
                                            n_sets=16),
        "rglru_scan": time_rglru(rs, card, HYBRID_MAX_LEN),
        "rglru_scan short": time_rglru(rs, card, 256),
        "rglru_scan score": time_rglru(rs, card, SCORE_LEN, b=SCORE_BATCH),
        "flash_attention": time_flash(fa, card),
        # 1 x 4096 x 10 x 256 bf16 q and out, 2 x 2 MB of K/V: 46 MB a set
        "flash_attention hybrid": time_flash(
            fa, card, heads=(10, 1, 256), window=HYBRID_WINDOW, n_sets=3),
        # the pipeline's streamed serves: contexts of up to 80 keys
        "decode_attention pipeline streamed": time_decode(
            da, card, PIPE_STREAM_MAX_LEN, c=PIPE_STREAM_MAX_LEN, n_sets=64,
            slots=1),
        "paged_attention pipeline streamed": time_paged(
            pa, card, 1, PIPE_STREAM_MAX_LEN, slots=1, n_sets=64),
        # the dense configs' serves: 4 slots x 512 keys at their heads;
        # gemma2-2b's 2 slots x 4608 keys (a global layer) and its local
        # layers' wrapped 4096-key window ring, softcap 50
        **{f"{kind} {arch}": timer(heads, sets_past_l2(SLOTS * MAX_LEN
                                                       * heads[1] * heads[2]
                                                       * 4))
           for arch, heads in (("starcoder2-7b", (36, 4, 128)),
                               ("qwen1.5-32b", (40, 40, 128)),
                               ("pixtral-12b", (32, 8, 128)))
           for kind, timer in (
               ("paged_attention", lambda h, n: time_paged(
                   pa, card, 1, heads=h, n_sets=n)),
               ("decode_attention", lambda h, n: time_decode(
                   da, card, MAX_LEN, heads=h, c=MAX_LEN, n_sets=n)))},
        "paged_verify_attention starcoder2-7b": time_paged(
            pa, card, SPEC_K, heads=(36, 4, 128),
            n_sets=sets_past_l2(SLOTS * MAX_LEN * 4 * 128 * 4)),
        "paged_attention gemma2-2b": time_paged(
            pa, card, 1, GEMMA_LEN, slots=2, heads=(8, 4, 256),
            softcap=GEMMA_SOFTCAP),
        "decode_attention gemma2-2b": time_decode(
            da, card, GEMMA_WINDOW, heads=(8, 4, 256), c=GEMMA_WINDOW,
            slots=2, window=GEMMA_WINDOW, softcap=GEMMA_SOFTCAP,
            wrap_pos=GEMMA_LEN - 8),
        "flash_attention gemma2-2b": time_flash(
            fa, card, heads=(8, 4, 256), window=GEMMA_WINDOW, s=GEMMA_LEN,
            softcap=GEMMA_SOFTCAP),
        "flash_attention gemma2-2b global": time_flash(
            fa, card, heads=(8, 4, 256), s=GEMMA_LEN, softcap=GEMMA_SOFTCAP),
        # the mixers phase's attention: granite-moe's 4 slots x 512 keys
        # (g=2, D=64) on both layouts and its score's 1 x 4096 at D=64;
        # kimi-k2's 4 slots x 512 keys (64 query heads over 8 K/V heads)
        "paged_attention granite-moe": time_paged(
            pa, card, 1, heads=(16, 8, 64),
            n_sets=sets_past_l2(SLOTS * MAX_LEN * 8 * 64 * 4)),
        "decode_attention granite-moe": time_decode(
            da, card, MAX_LEN, heads=(16, 8, 64), c=MAX_LEN,
            n_sets=sets_past_l2(SLOTS * MAX_LEN * 8 * 64 * 4)),
        "flash_attention granite-moe": time_flash(
            fa, card, heads=(16, 8, 64), n_sets=4),
        "paged_attention kimi-k2": time_paged(
            pa, card, 1, heads=(64, 8, 128),
            n_sets=sets_past_l2(SLOTS * MAX_LEN * 8 * 128 * 4)),
        # musicgen-large's serves (bf16 rings, or int8 rings dequantized)
        # and score: MHA at 32 heads of 64, 4 slots x 512 keys (16.8 MB of
        # K/V a set), 1 x 4096 causal
        "paged_attention musicgen-large": time_paged(
            pa, card, 1, heads=(32, 32, 64),
            n_sets=sets_past_l2(SLOTS * MAX_LEN * 32 * 64 * 4)),
        "decode_attention musicgen-large": time_decode(
            da, card, MAX_LEN, heads=(32, 32, 64), c=MAX_LEN,
            n_sets=sets_past_l2(SLOTS * MAX_LEN * 32 * 64 * 4)),
        "flash_attention musicgen-large": time_flash(
            fa, card, heads=(32, 32, 64)),
        # the int8 contiguous serve of llama2-7b: its 512-key rings
        # dequantized to bf16
        "decode_attention kvint8": time_decode(
            da, card, MAX_LEN, c=MAX_LEN,
            n_sets=sets_past_l2(SLOTS * MAX_LEN * 32 * 128 * 4)),
        # pixtral-12b's score over 1 x 1024 vision-stub embeddings
        "flash_attention pixtral-12b": time_flash(
            fa, card, heads=(32, 8, 128), s=PIXTRAL_FRONTEND_LEN, n_sets=4),
        # the tp phase: a process's 8 heads of llama2-7b, its serves' 4
        # slots x 64 keys (64 sets of 1 MB of K/V exceed the L2) and its
        # score's 1 x 2048
        "decode_attention tp": time_decode(
            da, card, TP_MAX_LEN, heads=TP_HEADS, c=TP_MAX_LEN, n_sets=64),
        "paged_attention tp": time_paged(pa, card, 1, TP_MAX_LEN,
                                         heads=TP_HEADS, n_sets=64),
        "flash_attention tp": time_flash(fa, card, heads=TP_HEADS,
                                         s=TP_SCORE_LEN, n_sets=4),
        # the tp recurrent phase: a process's 640 RG-LRU channels in a
        # prefill wave (4 slots of the 32-token bucket) and in the score
        # (1 x 2048); recurrentgemma-2b's whole attention at its serves' 4
        # slots x 64 keys and its score's 1 x 2048 in the 2048 window
        "rglru_scan tp": time_rglru(rs, card, TP_WAVE_LEN, r=TP_RNN),
        "rglru_scan tp score": time_rglru(rs, card, TP_SCORE_LEN, b=1,
                                          r=TP_RNN),
        "decode_attention tp recurrent": time_decode(
            da, card, TP_MAX_LEN, heads=(10, 1, 256), c=TP_MAX_LEN,
            n_sets=64),
        "paged_attention tp recurrent": time_paged(
            pa, card, 1, TP_MAX_LEN, heads=(10, 1, 256), n_sets=64,
            window=HYBRID_WINDOW),
        "flash_attention tp recurrent": time_flash(
            fa, card, heads=(10, 1, 256), window=HYBRID_WINDOW,
            s=TP_SCORE_LEN, n_sets=4),
        # the train mesh phase's evaluation: a process's 2 of the 4 rows x
        # 512 tokens at 8 of qwen3-0.6b's 16 query and 4 of its 8 K/V
        # heads, float32 (its weights' dtype)
        "flash_attention train mesh": time_flash(
            fa, card, heads=TRAIN_MESH_HEADS, s=TRAIN_LEN,
            b=TRAIN_BATCH // TRAIN_MESH_SHAPE[0], n_sets=4,
            dtype=torch.float32),
        # the multi-pod phase's evaluation: a process's one of the 4 rows x
        # 512 tokens at 8 of granite-moe's 16 query and 4 of its 8 K/V
        # heads of 64, float32 (3 MB a set)
        "flash_attention multi-pod": time_flash(
            fa, card, heads=MULTIPOD_HEADS, s=TRAIN_LEN,
            b=TRAIN_BATCH // (MULTIPOD_SHAPE[0] * MULTIPOD_SHAPE[1]),
            n_sets=sets_past_l2((2 * MULTIPOD_HEADS[0]
                                 + 2 * MULTIPOD_HEADS[1]) * TRAIN_LEN
                                * MULTIPOD_HEADS[2] * 4),
            dtype=torch.float32),
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
        "paged_attention hybrid": f"{HYBRID} (H=10, KH=1, D=256) x {SLOTS} "
                                  f"slots x {HYBRID_WINDOW}-key window, "
                                  f"full, bf16",
        "paged_attention fleet": f"llama2-7b x {SLOTS} slots x "
                                 f"{FLEET_MAX_LEN} keys bf16",
        "rglru_scan": f"{HYBRID} {SLOTS} x {HYBRID_MAX_LEN} x 2560 f32",
        "rglru_scan short": f"{HYBRID} {SLOTS} x 256 x 2560 f32",
        "rglru_scan score": f"{HYBRID} {SCORE_BATCH} x {SCORE_LEN} x 2560 "
                            f"f32 (the score)",
        "flash_attention": f"llama2-7b (H=KH=32, D=128) 1 x {SCORE_LEN}, "
                           f"causal, bf16",
        "flash_attention hybrid": f"{HYBRID} (H=10, KH=1, D=256) 1 x "
                                  f"{SCORE_LEN}, window {HYBRID_WINDOW}, "
                                  f"bf16",
        "decode_attention pipeline streamed": f"llama2-7b x 1 slot x "
                                              f"{PIPE_STREAM_MAX_LEN}-key "
                                              f"ring, full, bf16",
        "paged_attention pipeline streamed": f"llama2-7b x 1 slot x "
                                             f"{PIPE_STREAM_MAX_LEN} keys "
                                             f"bf16",
        **{f"{kind} {arch}": f"{arch} (H={h}, KH={kh}, D={d}) x {SLOTS} "
                             f"slots x {MAX_LEN} {what}, bf16"
           for arch, (h, kh, d) in (("starcoder2-7b", (36, 4, 128)),
                                    ("qwen1.5-32b", (40, 40, 128)),
                                    ("pixtral-12b", (32, 8, 128)))
           for kind, what in (("paged_attention", "keys"),
                              ("decode_attention", "-key ring, full"))},
        "paged_verify_attention starcoder2-7b": f"starcoder2-7b (H=36, "
                                                f"KH=4, D=128) x {SLOTS} "
                                                f"slots x {MAX_LEN} keys x "
                                                f"KQ={SPEC_K} (36 rows a "
                                                f"K/V head), bf16",
        "paged_attention gemma2-2b": f"gemma2-2b (H=8, KH=4, D=256) x 2 "
                                     f"slots x {GEMMA_LEN} keys (a global "
                                     f"layer), softcap {GEMMA_SOFTCAP:g}, "
                                     f"bf16",
        "decode_attention gemma2-2b": f"gemma2-2b (H=8, KH=4, D=256) x 2 "
                                      f"slots x {GEMMA_WINDOW}-key window "
                                      f"ring wrapped at {GEMMA_LEN - 8}, "
                                      f"softcap {GEMMA_SOFTCAP:g}, bf16",
        "flash_attention gemma2-2b": f"gemma2-2b (H=8, KH=4, D=256) 1 x "
                                     f"{GEMMA_LEN}, window {GEMMA_WINDOW} "
                                     f"(a local layer), softcap "
                                     f"{GEMMA_SOFTCAP:g}, bf16",
        "flash_attention gemma2-2b global": f"gemma2-2b (H=8, KH=4, D=256) "
                                            f"1 x {GEMMA_LEN}, causal (a "
                                            f"global layer), softcap "
                                            f"{GEMMA_SOFTCAP:g}, bf16",
        "paged_attention granite-moe": f"{MOE_ARCH} (H=16, KH=8, D=64) x "
                                       f"{SLOTS} slots x {MAX_LEN} keys bf16",
        "decode_attention granite-moe": f"{MOE_ARCH} (H=16, KH=8, D=64) x "
                                        f"{SLOTS} slots x {MAX_LEN}-key "
                                        f"ring, full, bf16",
        "flash_attention granite-moe": f"{MOE_ARCH} (H=16, KH=8, D=64) 1 x "
                                       f"{SCORE_LEN}, causal, bf16",
        "paged_attention kimi-k2": f"{KIMI_ARCH} (H=64, KH=8, D=128) x "
                                   f"{SLOTS} slots x {MAX_LEN} keys bf16",
        "paged_attention musicgen-large": f"{MUSICGEN} (H=KH=32, D=64) x "
                                          f"{SLOTS} slots x {MAX_LEN} keys "
                                          f"bf16",
        "decode_attention musicgen-large": f"{MUSICGEN} (H=KH=32, D=64) x "
                                           f"{SLOTS} slots x {MAX_LEN}-key "
                                           f"ring, full, bf16",
        "flash_attention musicgen-large": f"{MUSICGEN} (H=KH=32, D=64) 1 x "
                                          f"{SCORE_LEN}, causal, bf16",
        "decode_attention kvint8": f"llama2-7b x {SLOTS} slots x {MAX_LEN}"
                                   f"-key ring, full, bf16 (an int8 ring "
                                   f"dequantized)",
        "flash_attention pixtral-12b": f"pixtral-12b (H=32, KH=8, D=128) 1 x "
                                       f"{PIXTRAL_FRONTEND_LEN}, causal, "
                                       f"bf16",
        **{f"{kind} tp": f"llama2-7b a tp process (H=KH={TP_HEADS[0]}, "
                         f"D=128) x {SLOTS} slots x {TP_MAX_LEN} {what}, bf16"
           for kind, what in (("paged_attention", "keys"),
                              ("decode_attention", "-key ring, full"))},
        "flash_attention tp": f"llama2-7b a tp process (H=KH={TP_HEADS[0]}, "
                              f"D=128) 1 x {TP_SCORE_LEN}, causal, bf16",
        "rglru_scan tp": f"{HYBRID} a tp process {SLOTS} x {TP_WAVE_LEN} x "
                         f"{TP_RNN} f32 (a prefill wave)",
        "rglru_scan tp score": f"{HYBRID} a tp process 1 x {TP_SCORE_LEN} x "
                               f"{TP_RNN} f32 (the score)",
        "decode_attention tp recurrent": f"{HYBRID} a tp process (H=10, "
                                         f"KH=1, D=256) x {SLOTS} slots x "
                                         f"{TP_MAX_LEN}-key ring, full, "
                                         f"bf16",
        "paged_attention tp recurrent": f"{HYBRID} a tp process (H=10, "
                                        f"KH=1, D=256) x {SLOTS} slots x "
                                        f"{TP_MAX_LEN} keys, window "
                                        f"{HYBRID_WINDOW}, bf16",
        "flash_attention tp recurrent": f"{HYBRID} a tp process (H=10, "
                                        f"KH=1, D=256) 1 x {TP_SCORE_LEN}, "
                                        f"window {HYBRID_WINDOW}, bf16",
        "flash_attention train mesh": f"{TRAIN_ARCH} a train mesh process "
                                      f"(H={TRAIN_MESH_HEADS[0]}, "
                                      f"KH={TRAIN_MESH_HEADS[1]}, D=128) "
                                      f"{TRAIN_BATCH // TRAIN_MESH_SHAPE[0]}"
                                      f" x {TRAIN_LEN}, causal, float32",
        "flash_attention multi-pod": f"{MOE_ARCH} a multi-pod process "
                                     f"(H={MULTIPOD_HEADS[0]}, "
                                     f"KH={MULTIPOD_HEADS[1]}, D=64) 1 x "
                                     f"{TRAIN_LEN}, causal, float32",
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

    def done(what):
        """The script's wall so far, at the end of a phase."""
        print(f"chip_smoke: {what} done at {time.perf_counter() - t_start:.1f}"
              f" s")

    walls = {"build": t_kernels - t_start,
             "kernel checks and timings": time.perf_counter() - t_kernels}

    def phase(name, fn, *args):
        """``fn(*args)``, one phase, its wall printed and kept."""
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        print(f"chip_smoke: phase {name}: wall {walls[name]:.1f} s [{card}]")
        return out

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    done("kernel checks and timings")
    int8_launches = phase("int8 op path", int8_path, i8, wrappers, card)
    model = phase("llama2-7b weights", Model)
    paged = phase("serve paged", serve_paged, model, pa, card)
    contiguous = phase("serve contiguous", serve_contiguous, model, pa, da,
                       card, paged["tokens"])
    spec = phase("serve spec", serve_spec, model, pa, da, card,
                 paged["tokens"])
    streamed = phase("serve streamed", serve_streamed, model, wrappers, card)
    scored = phase("score", score, model, wrappers, card)
    done("the int8 op path and llama2-7b's serves and score")
    kvint8 = phase("kvint8", serve_kvint8, model, wrappers, card)
    phase("chunked", serve_chunked, model, wrappers, card)
    done("the int8 KV cache and the chunked impl")
    pipe = phase("pipeline", serve_pipeline, model, wrappers, card)
    done("the pipeline phase")
    pipe_spec = phase("pipeline spec", serve_pipeline_spec, model, wrappers,
                      card, pipe)
    pipe_streamed = phase("pipeline streamed", serve_pipeline_streamed,
                          model, wrappers, card)
    done("the pipeline's spec and streamed serves")
    pipe_procs = phase("pipeline procs", serve_pipeline_procs, model,
                       wrappers, card)
    done("the pipeline procs phase")
    mesh_pipe = phase("mesh pipeline_forward", mesh_pipeline, model,
                      wrappers, card)
    done("the mesh pipeline_forward")
    tp = phase("tp", serve_tp, model, wrappers, card)
    done("the tp phase")
    fleet = phase("fleet", serve_fleet, model, pa, da, card)
    del model                       # 13.48 GB of llama2-7b weights
    free()
    phase("launcher", serve_launcher, card)
    free()
    done("the fleet and the launcher")
    dense = phase("dense configs", serve_dense, wrappers, card)
    done("the dense configs")
    musicgen = phase(MUSICGEN, serve_musicgen, wrappers, card)
    done(MUSICGEN)
    granite = phase(f"mixers {MOE_ARCH}", serve_granite, wrappers, card)
    kimi = phase(f"mixers {KIMI_ARCH}", serve_kimi, wrappers, card)
    phase(f"mixers {XLSTM_ARCH}", serve_xlstm, wrappers, card)
    done("the mixers")
    phase("mesh MoE", mesh_moe, wrappers, card)
    done("the mesh MoE")
    model = phase("recurrentgemma-2b weights", Model, HYBRID,
                  HYBRID_PROMPT_LENS)
    hybrid = phase("hybrid serves", serve_hybrid, model, pa, da, rs, card)
    hybrid_scored = phase("hybrid score", score, model, wrappers, card)
    tp_rec = phase("tp recurrent", serve_tp_recurrent, model, wrappers, card)
    del model
    free()
    done("the hybrid")
    phase("train", train_phase, fa, card)
    free()
    train_mesh_out = phase("train mesh", train_mesh, card)
    free()
    multipod_out = phase("multi-pod", multipod_phase, card)
    done("the train phases")
    phase("dry run", dryrun_phase, card, tp, train_mesh_out, pipe_procs,
          multipod_out)
    done("the dry run")
    phase("examples", examples_phase, wrappers, card)
    done("the examples")
    print("chip_smoke: phase walls " + json.dumps(
        {k: round(v, 1) for k, v in walls.items()}))

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
        # the hybrid on the paged layout: the scan in its prefill waves, the
        # paged kernel at g=10, D=256 over the 2048-key window
        entry("rglru_scan", f"rglru_scan@{HYBRID} paged", "rglru_scan.cu",
              "rglru_scan.py:36", hybrid["paged_scans"]),
        # the hybrid's score: 2 x 4096 tokens, one scan a RG-LRU layer
        entry("rglru_scan score", f"rglru_scan@{HYBRID} score",
              "rglru_scan.cu", "rglru_scan.py:36",
              hybrid_scored["rglru_scan"]),
        entry("paged_attention hybrid", f"paged_attention@{HYBRID}",
              "paged_attention.cu", "decode_attention.py:201",
              hybrid["paged"]),
        # the fleet: both replays (fault free and with the crash)
        entry("paged_attention fleet", "paged_attention@fleet",
              "paged_attention.cu", "decode_attention.py:201",
              fleet["launches"]),
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
        # the pipeline's spec serve (one draft a tick) and its streamed
        # serves (the prefix cache and chunks on the paged layout, chunks
        # on the contiguous one)
        entry("paged_attention pipeline", "paged_attention@pipeline spec",
              "paged_attention.cu", "decode_attention.py:201", pipe_spec),
        entry("paged_attention pipeline streamed",
              "paged_attention@pipeline streamed", "paged_attention.cu",
              "decode_attention.py:201", pipe_streamed["paged"]),
        entry("decode_attention pipeline streamed",
              "decode_attention@pipeline streamed", "decode_attention.cu",
              "decode_attention.py:153", pipe_streamed["contiguous"]),
        # the planned stages one a process: launches summed over the stage
        # processes (B = 1 a call over up to 64 keys, the pipeline rows'
        # shapes)
        entry("decode_attention pipeline", "decode_attention@pipeline procs",
              "decode_attention.cu", "decode_attention.py:153",
              pipe_procs["contiguous"]),
        entry("paged_attention pipeline", "paged_attention@pipeline procs",
              "paged_attention.cu", "decode_attention.py:201",
              pipe_procs["paged"]),
        # pipeline_forward on the (2, 4) mesh of processes: launches summed
        # over the 8 processes (1 x 4096 a call, the flash row's shape)
        entry("flash_attention", "flash_attention@pipeline mesh",
              "flash_attention.cu", "flash_attention.py:86", mesh_pipe),
        # tensor parallelism on the (1, 4) mesh: launches summed over the 4
        # processes (8 heads a process), the serves' and the score's
        entry("decode_attention tp", "decode_attention@tp",
              "decode_attention.cu", "decode_attention.py:153",
              tp["contiguous"]),
        entry("paged_attention tp", "paged_attention@tp",
              "paged_attention.cu", "decode_attention.py:201", tp["paged"]),
        entry("flash_attention tp", "flash_attention@tp",
              "flash_attention.cu", "flash_attention.py:86",
              tp["score"]["flash_attention"]),
        # the recurrent mixers over the (1, 4) mesh: recurrentgemma-2b's
        # launches summed over the 4 processes, the scan at 640 channels a
        # process in both layouts' prefill waves and in the score; its
        # whole attention in the serves and the score
        entry("rglru_scan tp", "rglru_scan@tp recurrent", "rglru_scan.cu",
              "rglru_scan.py:36", tp_rec["rglru_scan serve"]),
        entry("rglru_scan tp score", "rglru_scan@tp recurrent score",
              "rglru_scan.cu", "rglru_scan.py:36",
              tp_rec["score"]["rglru_scan"]),
        entry("decode_attention tp recurrent",
              "decode_attention@tp recurrent", "decode_attention.cu",
              "decode_attention.py:153", tp_rec["contiguous"]),
        entry("paged_attention tp recurrent", "paged_attention@tp recurrent",
              "paged_attention.cu", "decode_attention.py:201",
              tp_rec["paged"]),
        entry("flash_attention tp recurrent", "flash_attention@tp recurrent",
              "flash_attention.cu", "flash_attention.py:86",
              tp_rec["score"]["flash_attention"]),
        # training over the (2, 2) mesh: the trained shards' evaluation,
        # launches summed over the 4 processes (2 x 512 tokens, 8 query
        # and 4 K/V heads a process, float32)
        entry("flash_attention train mesh", "flash_attention@train mesh",
              "flash_attention.cu", "flash_attention.py:86",
              train_mesh_out["flash"]),
        # training over the (2, 2, 2) multi-pod mesh: the trained shards'
        # evaluation, launches summed over the 8 processes (1 x 512 tokens,
        # 8 query and 4 K/V heads of 64 a process, float32)
        entry("flash_attention multi-pod", "flash_attention@multi-pod",
              "flash_attention.cu", "flash_attention.py:86",
              multipod_out["flash"]),
        # the dense configs on both layouts, starcoder2-7b's verify and
        # gemma2-2b's score
        *(entry(f"{kind} {arch}", f"{kind}@{arch}", source,
                f"decode_attention.py:{line}", dense[arch][layout]["launches"])
          for arch in ("gemma2-2b", "starcoder2-7b", "qwen1.5-32b",
                       "pixtral-12b")
          for kind, source, line, layout in (
              ("paged_attention", "paged_attention.cu", 201, "paged"),
              ("decode_attention", "decode_attention.cu", 153,
               "contiguous"))),
        entry("paged_verify_attention starcoder2-7b",
              "paged_verify_attention@starcoder2-7b", "paged_attention.cu",
              "decode_attention.py:256", dense["starcoder2-7b"]["spec"]),
        entry("flash_attention gemma2-2b", "flash_attention@gemma2-2b",
              "flash_attention.cu", "flash_attention.py:86",
              dense["gemma2-2b"]["score"]),
        # the mixers phase: granite-moe on both layouts and its score;
        # kimi-k2's paged serve (xlstm-1.3b runs none; granite-moe's
        # pipeline, in float32, is counted in its phase)
        entry("paged_attention granite-moe", f"paged_attention@{MOE_ARCH}",
              "paged_attention.cu", "decode_attention.py:201",
              granite["paged"]),
        entry("decode_attention granite-moe", f"decode_attention@{MOE_ARCH}",
              "decode_attention.cu", "decode_attention.py:153",
              granite["contiguous"]),
        entry("flash_attention granite-moe", f"flash_attention@{MOE_ARCH}",
              "flash_attention.cu", "flash_attention.py:86",
              granite["score"]),
        entry("paged_attention kimi-k2", f"paged_attention@{KIMI_ARCH}",
              "paged_attention.cu", "decode_attention.py:201",
              kimi["paged"]),
        # llama2-7b's int8 contiguous serve: the ring kernel over its
        # dequantized rings (its paged int8 serves read by gather, as the
        # reference's do: no launch)
        entry("decode_attention kvint8", "decode_attention@kvint8",
              "decode_attention.cu", "decode_attention.py:153",
              kvint8["contiguous"]),
        # musicgen-large on both layouts, its int8 contiguous serve, its
        # score over its frontend's float embeddings (its float32 pipeline
        # is counted in its phase); pixtral-12b's score over float inputs
        entry("paged_attention musicgen-large", f"paged_attention@{MUSICGEN}",
              "paged_attention.cu", "decode_attention.py:201",
              musicgen["paged"]),
        entry("decode_attention musicgen-large",
              f"decode_attention@{MUSICGEN}", "decode_attention.cu",
              "decode_attention.py:153", musicgen["contiguous"]),
        entry("decode_attention musicgen-large",
              f"decode_attention@{MUSICGEN} kvint8", "decode_attention.cu",
              "decode_attention.py:153", musicgen["kvint8"]),
        entry("flash_attention musicgen-large",
              f"flash_attention@{MUSICGEN} frontend", "flash_attention.cu",
              "flash_attention.py:86", musicgen["score"]),
        entry("flash_attention pixtral-12b", "flash_attention@pixtral-12b "
              "frontend", "flash_attention.cu", "flash_attention.py:86",
              dense["pixtral-12b"]["frontend"]),
        # the op's entry point: one llama2-7b layer's projections in bf16
        entry("int8_matmul M=4 4096x4096 bfloat16", "int8_matmul",
              "int8_matmul.cu", "int8_matmul.py:41", int8_launches["decode"]),
        entry(f"int8_matmul M={INT8_M[1]} 4096x4096 bfloat16",
              "int8_matmul@prefill", "int8_matmul.cu", "int8_matmul.py:41",
              int8_launches["prefill"]),
    ]
    print(f"chip_smoke: wall {time.perf_counter() - t_start:.1f} s, the "
          f"build included [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
