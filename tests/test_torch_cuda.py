"""The port on an NVIDIA GPU: the paged, contiguous-ring and flash attention
kernels, the RG-LRU scan kernel and the int8 matmul against their plain
versions, the wrappers' checks, the served models through the kernels
against the ref paths, with and without speculative decoding, with
streamed admission (prefix cache and chunked prefill) and for the hybrid
recurrentgemma on both layouts, the train mode (the forward through the flash kernel,
gradients on the ref path), the no-bubbles stage pipeline (its served
tokens, with spec verify and streamed admission too, and its microbatched
forward through the kernels), the dense configs' shapes (starcoder2's
group of 9, qwen1.5's 40-head MHA, gemma2's D=256 with softcap and a
wrapped 4096-key window) and the MoE configs' (granite-moe's g=2 at D=64,
kimi-k2's 64 heads over 8) in the kernels, and reduced served models of
each (xlstm-1.3b's too, which runs no kernel), and the stage ring on
two stage processes against the ring in one process.
Every test is marked ``cuda`` and skips without a GPU (a CUDA kernel has no
CPU or interpret mode).  The file imports no jax, so it runs on the GPU
machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flash_reference import bf16_steps_apart, flash_attention_f64  # noqa: E402
from paged_cases import paged_case, poison_unread, ring_case  # noqa: E402
from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import int8_matmul as I8  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import rglru_scan as RS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import (PipelineBackend, TensorBackend,  # noqa: E402
                                 TorchTensorBackend)
from repro_torch.serving import (LLM, ContinuousBatcher,  # noqa: E402
                                 Request, SamplingParams)
from repro_torch.serving.spec import OracleDraft  # noqa: E402
from repro_torch.training import TrainConfig, adamw_init  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402

pytestmark = pytest.mark.cuda

# float32: the JAX kernel tests' tolerance.  bfloat16: both sides round the
# float32 result once to bf16 after summing in another order, so a result
# may land on the neighbouring bf16 value, one step of 2**-7 relative.
TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernel has no CPU "
                    "or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(x, dev, dtype=torch.float32):
    t = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in x.items()}
    for k in ("q", "k_pool", "v_pool", "k_cache", "v_cache"):
        if k in t:
            t[k] = t[k].to(dtype)
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_gpu(gpu, dtype):
    """The CUDA kernel against its plain version on the card (GQA, KQ=4,
    unmapped tail blocks, softcap, a dead row)."""
    x = paged_case(3, 16, 8, 128, 16, 8, (40, 100, 7), 4, seed=40, dead=(2,))
    t = _on(x, gpu, getattr(torch, dtype))
    before = PA.paged_attention.launches
    got = PA.paged_attention(**t, softcap=30.0)
    want = PA.paged_attention_plain(**t, softcap=30.0)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert bool((got[2] == 0).all())


def test_wrapper_raises_on_what_the_kernel_does_not_take(gpu):
    """No fallback to the plain version: wrong dtypes, strides, devices or
    head dims raise before any launch."""
    t = _on(paged_case(2, 4, 2, 64, 16, 4, (40, 25), 1, seed=41), gpu)
    q = t["q"][:, 0]
    args = (t["k_pool"], t["v_pool"], t["bt"], t["key_pos"], t["pos"])
    before = PA.paged_attention.launches
    bad = [
        (q.half(), *args),                                   # float16
        (q, *args[:2], args[2].long(), *args[3:]),           # int64 table
        (q.transpose(1, 2).contiguous().transpose(1, 2), *args),  # strides
        (q.cpu(), *args),                                    # two devices
        (q[..., :48].contiguous(), *(a[..., :48].contiguous()
                                     for a in args[:2]), *args[2:]),  # D=48
    ]
    for call in bad:
        with pytest.raises(ValueError):
            PA.paged_attention(*call)
    assert PA.paged_attention.launches == before


# each slot's table split across blocks (S > 1 on the card): paged_case
# arguments, its keywords and the kernel options
PAGED_SPLIT_CASES = [
    # 300 of 4096 keys valid: most splits wholly masked
    ((1, 8, 1, 128, 16, 256, (300,), 1, 42), {}, {}),
    # unmapped entries inside splits, their keys' positions left valid
    ((4, 32, 32, 128, 16, 64, (1000, 700, 300, 17), 1, 43),
     dict(holes=((0, 3), (0, 21), (1, 5), (2, 9))), {}),
    # llama2-70b g=8 at KQ=4: two chunks of 16 rows
    ((2, 64, 8, 128, 16, 128, (2000, 900), 4, 44), {}, {}),
    # a wrapped window ring whose valid keys sit in one split
    ((1, 10, 1, 256, 16, 32, (1,), 1, 45), dict(last=1000),
     dict(window=40)),
    # a fully masked row through the merge
    ((2, 16, 8, 128, 16, 64, (600, 5), 1, 46), dict(dead=(1,)), {}),
    # block sizes 8 and 32
    ((4, 32, 32, 128, 8, 64, (512, 300, 17, 129), 1, 47), {}, {}),
    ((3, 16, 8, 128, 32, 32, (1000, 25, 600), 4, 48), {},
     dict(softcap=30.0)),
    # recurrentgemma-2b's g=10, D=256, window 2048, slot 0 wrapped
    ((4, 10, 1, 256, 16, 128, (2048, 2048, 700, 17), 1, 49),
     dict(last=2130), dict(window=2048)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_matches_plain_and_is_deterministic(gpu, dtype):
    """With each slot's table split across blocks and merged: the kernel
    against its plain version, a fully masked row exact zeros, two calls
    bit-identical, and the pool rows it must not read (scratch, unmapped
    blocks, masked keys), poisoned with NaN, change nothing: they are never
    read, for a loaded masked key would add 0 x NaN = NaN.  One launch
    counted per call."""
    n_sm = torch.cuda.get_device_properties(gpu).multi_processor_count
    for args, kw, opts in PAGED_SPLIT_CASES:
        x = paged_case(*args[:-1], seed=args[-1], **kw)
        t, bad = (_on(c, gpu, getattr(torch, dtype))
                  for c in (x, poison_unread(x, opts.get("window"))))
        if args[7] == 1:                       # one token a slot: q [B, H, D]
            t["q"], bad["q"] = t["q"][:, 0], bad["q"][:, 0]
        assert PA.table_split_plan(t["q"].shape, t["k_pool"].shape,
                                   t["key_pos"].shape[1], n_sm)[0] > 1
        before = PA.paged_attention.launches
        got = PA.paged_attention(**t, **opts)
        want = PA.paged_attention_plain(**t, **opts)
        torch.cuda.synchronize()
        assert PA.paged_attention.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        for row in kw.get("dead", ()):
            assert bool((got[row] == 0).all())
        assert torch.equal(PA.paged_attention(**t, **opts), got)
        assert torch.equal(PA.paged_attention(**bad, **opts), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,opts", [
    ((4, 32, 32, 128, 16, 32, (509, 300, 17, 129)), {}),        # g=1
    ((3, 16, 8, 128, 16, 16, (40, 25, 200)), dict(softcap=30.0)),  # g=2
])
def test_paged_verify_row_equals_decode_at_its_position(gpu, dtype, case,
                                                        opts):
    """Row i of a KQ=4 call gives the bits of the KQ=1 call at pos + i on
    the same pool: both take one split plan, and a row's arithmetic does
    not depend on the rows beside it."""
    t = _on(paged_case(*case, 4, seed=61), gpu, getattr(torch, dtype))
    four = PA.paged_attention(**t, **opts)
    for i in range(4):
        one = PA.paged_attention(t["q"][:, i].contiguous(), t["k_pool"],
                                 t["v_pool"], t["bt"], t["key_pos"],
                                 t["pos"] + i, **opts)
        assert torch.equal(four[:, i], one), i


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-0.6b"])
def test_served_tokens_kernel_equals_gather_path(gpu, arch):
    """Reduced model in float32 on the card: greedy tokens through
    ``LLM.generate`` are the same with the kernel (``impl="cuda"``) and the
    gather path (``impl="ref"``); the kernel launches once per layer and
    decode step."""
    cfg = get_config(arch).reduced(n_layers=3)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0), gpu)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 23, 40, 17, 9)]
    sp = SamplingParams(max_tokens=12)
    outs = {}
    for impl in ("cuda", "ref"):
        be = TorchTensorBackend(cfg, params, n_slots=3, max_len=64, impl=impl,
                                cache_layout="paged", block_size=16)
        steps = []
        decode = be.decode_step
        be.decode_step = lambda feeds: steps.append(1) or decode(feeds)
        before = PA.paged_attention.launches
        outs[impl] = [o.tokens for o in LLM.from_backend(be).generate(
            prompts, sp)]
        launched = PA.paged_attention.launches - before
        assert launched == (cfg.n_layers * len(steps) if impl == "cuda"
                            else 0)
        assert be.info.attn_impl == impl
    assert outs["cuda"] == outs["ref"]


RING_CASES = [
    # b, h, kh, d, c, valid, options
    ((1, 8, 1, 128, 700, 650, 50), {}),                      # g=8, C=700
    ((3, 16, 8, 128, 96, (96, 40, 5), 51), dict(softcap=30.0)),  # per row
    ((4, 32, 32, 128, 64, (64, 10, 1, 33), 52), {}),         # g=1
    ((1, 2, 1, 32, 128, 0, 53), dict(window=50)),            # wrapped ring
    # recurrentgemma-2b: MQA g=10, D=256, window 2048, row 0 wrapped
    ((4, 10, 1, 256, 2048, (2048, 2048, 700, 17), 55), dict(window=2048)),
]
# the ring split across blocks (S > 1 on the card; rows 1 of b > 1 are fully
# masked and go through the merge)
SPLIT_CASES = [
    ((1, 8, 1, 128, 1024, 300, 56), {}),       # 11 of 16 splits all masked
    ((4, 32, 32, 128, 3000, (3000, 2000, 1000, 5), 57), {}),   # C % L != 0
    ((1, 10, 1, 256, 512, 0, 58), dict(window=40)),  # wrapped, in one split
    ((2, 16, 8, 128, 1024, (600, 5), 59), {}),   # masked row through merge
    ((1, 64, 8, 128, 4096, 3001, 60), {}),       # llama2-70b g=8, B=1
]
RING_CASES += SPLIT_CASES
# the ring position a case with this window has wrapped to
RING_WRAP = {50: 200, 40: 1000, 2048: 2130}


def _ring(case, dev, dtype):
    (b, h, kh, d, c, valid, seed), opts = case
    x = ring_case(b, h, kh, d, c, valid, seed, dead=(1,) if b > 1 else (),
                  wrap_pos=RING_WRAP.get(opts.get("window")))
    return _on(x, dev, getattr(torch, dtype)), opts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_matches_plain_on_gpu(gpu, dtype):
    """The contiguous-ring kernel against its plain version on the card:
    GQA groups 8, 2 and 1, C=700, per-row positions, softcap, a wrapped
    ring under a window, a fully masked row (exact zeros), the hybrid's MQA
    group of 10 at D=256 over a wrapped 2048-key window, and the rings
    split across blocks (``SPLIT_CASES``).  One launch counted per call."""
    for case in RING_CASES:
        t, opts = _ring(case, gpu, dtype)
        b = t["q"].shape[0]
        before = DA.decode_attention.launches
        got = DA.decode_attention(**t, **opts)
        want = DA.decode_attention_plain(**t, **opts)
        torch.cuda.synchronize()
        assert DA.decode_attention.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        if b > 1:
            assert bool((got[1] == 0).all())
        four = DA.decode_attention(t["q"][:, None], t["k_cache"],
                                   t["v_cache"], t["key_pos"], t["pos"],
                                   **opts)
        assert torch.equal(four[:, 0], got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_is_deterministic_and_reads_no_masked_row(gpu, dtype):
    """With the ring split across blocks (S > 1) and merged: two calls on
    the same inputs give the same bits, and ring rows that no query may see,
    poisoned with +-1e6, change nothing (they are never read)."""
    n_sm = torch.cuda.get_device_properties(gpu).multi_processor_count
    for case in SPLIT_CASES:
        t, opts = _ring(case, gpu, dtype)
        (b, h, kh, d, c, _, _), _ = case
        assert DA.split_plan(b, kh, h // kh, c, n_sm)[0] > 1
        got = DA.decode_attention(**t, **opts)
        assert torch.equal(DA.decode_attention(**t, **opts), got)
        kp = t["key_pos"].expand(b, c)
        qpos = t["pos"].expand(b)[:, None]
        masked = (kp < 0) | (kp > qpos)
        if "window" in opts:
            masked |= kp <= qpos - opts["window"]
        assert masked.any()
        t["k_cache"][masked] = 1e6
        t["v_cache"][masked] = -1e6
        assert torch.equal(DA.decode_attention(**t, **opts), got)


def test_decode_wrapper_raises_on_what_the_kernel_does_not_take(gpu):
    """No fallback to the plain version: wrong dtypes, shapes, strides,
    devices or head dims raise before any launch."""
    t = _on(ring_case(2, 4, 2, 64, 40, (40, 7), seed=54), gpu)
    q, k, v, kp, pos = (t[n] for n in ("q", "k_cache", "v_cache", "key_pos",
                                       "pos"))
    before = DA.decode_attention.launches
    bad = [
        (q.half(), k, v, kp, pos),                             # float16
        (q, k, v, kp.long(), pos),                             # int64
        (q, k.transpose(0, 1).contiguous().transpose(0, 1), v, kp, pos),
        (q.cpu(), k, v, kp, pos),                              # two devices
        (q[..., :48].contiguous(), k[..., :48].contiguous(),
         v[..., :48].contiguous(), kp, pos),                   # D=48
        (torch.stack([q, q], 1), k, v, kp, pos),               # 2 tokens
        (q, k, v, kp[:, :20].contiguous(), pos),               # key_pos
    ]
    for call in bad:
        with pytest.raises(ValueError):
            DA.decode_attention(*call)
    assert DA.decode_attention.launches == before


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-0.6b"])
def test_served_tokens_contiguous_and_spec(gpu, arch):
    """Reduced model in float32 on the card, greedy tokens through
    ``LLM.generate``: the contiguous ring read by the kernel equals the
    gather path, and paged speculative decoding (``spec_k=4``, a corrupted
    oracle draft, so rollbacks run) equals plain decoding.  Each kernel
    launches once per layer and step of its path."""
    cfg = get_config(arch).reduced(n_layers=3)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0), gpu)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 23, 40, 17, 9)]
    sp = SamplingParams(max_tokens=12)

    def serve(layout, impl, **kw):
        be = TorchTensorBackend(cfg, params, n_slots=3, max_len=64,
                                impl=impl, cache_layout=layout)
        steps = []
        for name in ("decode_step", "verify_step"):
            fn = getattr(be, name)
            setattr(be, name, lambda feeds, fn=fn: steps.append(1)
                    or fn(feeds))
        da, pa = DA.decode_attention.launches, PA.paged_attention.launches
        llm = LLM.from_backend(be, **kw)
        for uid, prompt in enumerate(prompts):      # the oracle's keys
            llm.submit(prompt, sp, uid=uid)
        while llm.has_work:
            llm.step()
        toks = [llm.poll(uid).tokens for uid in range(len(prompts))]
        return toks, (DA.decode_attention.launches - da,
                      PA.paged_attention.launches - pa), len(steps), llm

    ref, launched, _, _ = serve("contiguous", "ref")
    assert launched == (0, 0)
    got, launched, steps, _ = serve("contiguous", "cuda")
    assert got == ref
    assert launched == (cfg.n_layers * steps, 0)
    oracle = OracleDraft(dict(enumerate(ref)), accept_prob=0.75, seed=1,
                         vocab_size=cfg.vocab_size)
    got, launched, steps, llm = serve("paged", "cuda", spec_k=4,
                                      draft=oracle)
    assert got == ref
    assert launched == (0, cfg.n_layers * steps)
    assert 0 < llm.stats.spec_accepted < llm.stats.spec_drafted


# (B, S, R, offset): ragged strips, S=1, R % 4 != 0 (199: the kernel's
# 4-byte copies), and contiguous inputs whose base lies ``offset`` floats
# past 16-byte alignment (the 4-byte copies at R % 4 == 0)
RGLRU_CASES = [(4, 7, 2560, 0), (2, 33, 200, 0), (3, 1, 200, 0),
               (1, 300, 128, 0), (2, 33, 199, 0), (2, 70, 256, 1),
               (4, 130, 2560, 1)]


def _at_offset(t, offset):
    """``t`` copied into a contiguous view ``offset`` floats into a buffer
    of its own."""
    if not offset:
        return t
    view = torch.empty(t.numel() + offset, device=t.device)[offset:] \
        .view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * offset % 16
    return view


@pytest.mark.parametrize("b,s,r,offset", RGLRU_CASES)
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_kernel_matches_plain_on_gpu(gpu, b, s, r, offset, with_h0):
    """The scan kernel against its plain version on the card (ragged R,
    S=1, with and without h0, R % 4 != 0, misaligned bases), and left-pad
    identity steps exact."""
    rng = np.random.default_rng(60)
    log_a = -np.abs(rng.standard_normal((b, s, r))).astype(np.float32)
    bb = rng.standard_normal((b, s, r)).astype(np.float32)
    la = _at_offset(torch.from_numpy(log_a).to(gpu), offset)
    bv = _at_offset(torch.from_numpy(bb).to(gpu), offset)
    h0 = torch.randn((b, r), device=gpu) if with_h0 else None
    before = RS.rglru_scan.launches
    got = RS.rglru_scan(la, bv, h0)
    want = RS.rglru_scan_plain(la, bv, h0)
    torch.cuda.synchronize()
    assert RS.rglru_scan.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    pad = min(3, s)
    la[:, :pad], bv[:, :pad] = 0.0, 0.0
    padded = RS.rglru_scan(la, bv, h0)
    start = torch.zeros((b, r), device=gpu) if h0 is None else h0
    assert torch.equal(padded[:, :pad], start[:, None].expand(b, pad, r))
    if s > pad:
        tail = RS.rglru_scan(_at_offset(la[:, pad:].contiguous(), offset),
                             _at_offset(bv[:, pad:].contiguous(), offset),
                             h0)
        assert torch.equal(padded[:, pad:], tail)


@pytest.mark.parametrize("r", [640, 1280])
@pytest.mark.parametrize("b,s", [(1, 2048), (4, 48)])
def test_rglru_kernel_at_a_tp_process_channels(gpu, b, s, r):
    """The scan at a tensor-parallel process's share of recurrentgemma-2b's
    2560 channels (640 on a model axis of 4, 1280 on 2): the tp score's
    1 x 2048 and a tp prefill wave of 4 slots, against its plain version
    with h0, once a call."""
    gen = torch.Generator(device=gpu).manual_seed(61)
    la = -torch.randn((b, s, r), generator=gen, device=gpu).abs()
    bv = torch.randn((b, s, r), generator=gen, device=gpu)
    h0 = torch.randn((b, r), generator=gen, device=gpu)
    before = RS.rglru_scan.launches
    got = RS.rglru_scan(la, bv, h0)
    torch.cuda.synchronize()
    assert RS.rglru_scan.launches == before + 1
    torch.testing.assert_close(got, RS.rglru_scan_plain(la, bv, h0),
                               rtol=1e-5, atol=1e-5)


def test_rglru_wrapper_raises_on_what_the_kernel_does_not_take(gpu):
    la = torch.zeros((2, 5, 64), device=gpu)
    b = torch.zeros((2, 5, 64), device=gpu)
    before = RS.rglru_scan.launches
    bad = [
        (la.bfloat16(), b.bfloat16(), None),                  # bfloat16
        (la.transpose(1, 2).contiguous().transpose(1, 2), b, None),
        (la, b, torch.zeros((2, 32), device=gpu)),            # h0 shape
        (la, b[:, :4].contiguous(), None),                    # b shape
        (la, b.cpu(), None),                                  # two devices
    ]
    for call in bad:
        with pytest.raises(ValueError):
            RS.rglru_scan(*call)
    assert RS.rglru_scan.launches == before


def test_served_hybrid_tokens_kernel_equals_ref(gpu):
    """Reduced recurrentgemma-2b (rglru, rglru, local attention, and a tail
    of two rglru) in float32 on the card: greedy tokens through
    ``LLM.generate`` on the contiguous layout are the same with the
    kernels and the ref paths (doubling scan, ring sdpa), past the window
    of 16.  The scan launches once per RG-LRU layer and prefill, the decode
    kernel once per attention layer and decode step."""
    cfg = get_config("recurrentgemma-2b").reduced(n_layers=5)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0), gpu)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 23, 40, 17, 9)]
    n_rglru = sum(s.kind == "rglru" for s in cfg.layer_specs())
    n_attn = cfg.n_layers - n_rglru
    outs = {}
    for impl in ("cuda", "ref"):
        be = TorchTensorBackend(cfg, params, n_slots=3, max_len=64,
                                impl=impl)
        calls = {"prefill": 0, "decode_step": 0}

        def counted(name, fn):
            def call(*args, **kw):
                calls[name] += 1
                return fn(*args, **kw)
            return call
        for name in calls:
            setattr(be, name, counted(name, getattr(be, name)))
        rs, da = RS.rglru_scan.launches, DA.decode_attention.launches
        outs[impl] = [o.tokens for o in LLM.from_backend(be).generate(
            prompts, SamplingParams(max_tokens=12))]
        launched = (RS.rglru_scan.launches - rs,
                    DA.decode_attention.launches - da)
        want = (n_rglru * calls["prefill"], n_attn * calls["decode_step"])
        assert launched == (want if impl == "cuda" else (0, 0))
    assert outs["cuda"] == outs["ref"]


def test_served_hybrid_paged_tokens_kernel_equals_ref(gpu):
    """The same model on the paged layout (blocks of 4, a pool small enough
    to preempt): greedy tokens with the kernels equal the ref paths' and
    the contiguous serve's.  The scan launches once per RG-LRU layer and
    prefill, the paged kernel once per attention layer and decode step,
    the contiguous-ring kernel never."""
    cfg = get_config("recurrentgemma-2b").reduced(n_layers=5)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0), gpu)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 23, 40, 17, 9)]
    n_rglru = sum(s.kind == "rglru" for s in cfg.layer_specs())
    n_attn = cfg.n_layers - n_rglru
    outs, preempted = {}, 0
    for impl, layout in (("cuda", "paged"), ("ref", "paged"),
                         ("cuda", "contiguous")):
        kw = dict(block_size=4, num_blocks=7) if layout == "paged" else {}
        be = TensorBackend(cfg, params, n_slots=3, max_len=64, impl=impl,
                           cache_layout=layout, **kw)
        calls = {"prefill": 0, "decode_step": 0}

        def counted(name, fn):
            def call(*args, **kw):
                out = fn(*args, **kw)       # a preempting call raises first
                calls[name] += bool(len(args[0]))
                return out
            return call
        for name in calls:
            setattr(be, name, counted(name, getattr(be, name)))
        before = (RS.rglru_scan.launches, PA.paged_attention.launches,
                  DA.decode_attention.launches)
        llm = LLM.from_backend(be)
        outs[impl, layout] = [o.tokens for o in llm.generate(
            prompts, SamplingParams(max_tokens=12))]
        launched = (RS.rglru_scan.launches - before[0],
                    PA.paged_attention.launches - before[1],
                    DA.decode_attention.launches - before[2])
        if impl == "cuda" and layout == "paged":
            preempted = llm.stats.preemptions
            assert launched == (n_rglru * calls["prefill"],
                                n_attn * calls["decode_step"], 0)
        elif impl == "ref":
            assert launched == (0, 0, 0)
    assert preempted > 0
    assert outs["cuda", "paged"] == outs["ref", "paged"] == \
        outs["cuda", "contiguous"]


FLASH_CASES = [
    # b, s, h, kh, d, options, q scale
    (2, 200, 4, 2, 32, {}, 1.0),
    (1, 300, 4, 4, 64, dict(window=70, softcap=20.0), 1.0),
    (1, 130, 8, 1, 128, dict(softcap=30.0), 1.0),
    (2, 257, 10, 1, 256, dict(window=64), 1.0),
    # the edges of the bf16 kernel's tiles: one row; a block's last rows
    # missing; a key tile of one key and a window ending inside a tile at
    # D=256; the hybrid's window over a ragged S; a window of 16 inside a
    # tile at D=128; q scaled by 16, so the running max rescales often
    (2, 1, 4, 2, 128, {}, 1.0),
    (1, 63, 8, 8, 64, {}, 1.0),
    (1, 65, 4, 1, 256, dict(window=16), 1.0),
    (1, 2500, 10, 1, 256, dict(window=2048), 1.0),
    (2, 300, 8, 2, 128, dict(window=16), 1.0),
    (1, 300, 4, 2, 128, dict(window=64), 16.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d,opts,q_scale", FLASH_CASES)
def test_flash_kernel_matches_plain_on_gpu(gpu, b, s, h, kh, d, opts,
                                           q_scale, dtype):
    """The flash kernel against its plain version at D = 32, 64, 128 and
    256: GQA and MQA, ragged S, window and softcap, the edges of the bf16
    kernel's tiles and a scaled q; a second call is bit-identical, and in
    bfloat16 every output lies within one bf16 step (2**-7 of its binade,
    plus 1e-6 near zero) of the plain version's arithmetic in float64 --
    but for the scaled q, whose float32 logits (the plain version's too)
    put a few outputs near zero beyond that step."""
    g = torch.Generator(device=gpu).manual_seed(70 + d)
    q, k, v = (torch.randn(shape, generator=g, device=gpu)
               for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    q, k, v = (t.to(getattr(torch, dtype)) for t in (q * q_scale, k, v))
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, **opts)
    want = FA.flash_attention_plain(q, k, v, **opts)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(FA.flash_attention(q, k, v, **opts), got)
    if dtype == "bfloat16" and q_scale == 1.0:
        assert bf16_steps_apart(got, flash_attention_f64(q, k, v,
                                                         **opts)) == 0


def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(gpu):
    """No fallback to the plain version and no silent loss of gradients:
    inputs that need a gradient under autograd, head dims the kernel is not
    built for, mixed or unsupported dtypes, strides and devices raise
    before any launch."""
    q = torch.randn((1, 40, 4, 64), device=gpu)
    k = torch.randn((1, 40, 2, 64), device=gpu)
    before = FA.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(q.clone().requires_grad_(True), k, k)
    bad = [
        (q[..., :48].contiguous(), k[..., :48].contiguous(),
         k[..., :48].contiguous()),                           # D=48
        (torch.randn((1, 40, 4, 96), device=gpu),
         torch.randn((1, 40, 2, 96), device=gpu),
         torch.randn((1, 40, 2, 96), device=gpu)),            # D=96
        (q.half(), k.half(), k.half()),                       # float16
        (q.bfloat16(), k, k),                                 # mixed dtypes
        (q.transpose(1, 2).contiguous().transpose(1, 2), k, k),  # strides
        (q, k.cpu(), k.cpu()),                                # two devices
        (q, k[:, :20].contiguous(), k[:, :20].contiguous()),  # S differs
        (q[:, :, :3].contiguous(), k, k),                     # H % KH
    ]
    for call in bad:
        with pytest.raises(ValueError):
            FA.flash_attention(*call)
    with torch.no_grad():               # no gradient needed: it launches
        FA.flash_attention(q.clone().requires_grad_(True), k, k)
    assert FA.flash_attention.launches == before + 1


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-0.6b",
                                  "recurrentgemma-2b"])
def test_train_mode_on_gpu(gpu, arch):
    """Reduced model in float32 on the card: ``forward(mode="train")``
    through the flash kernel (one launch per attention layer) equals the
    ref path at 2e-4; a train step on ``impl="ref"`` runs, and on
    ``impl="cuda"`` it raises, as the kernel has no backward."""
    cfg = get_config(arch).reduced(n_layers=5)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0), gpu)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 40))).to(gpu)
    n_attn = sum(s.kind == "attn" for s in cfg.layer_specs())
    logits = {}
    with torch.no_grad():
        for impl in ("ref", "cuda"):
            before = FA.flash_attention.launches
            logits[impl], _ = TT.forward(cfg, params, tokens, mode="train",
                                         impl=impl)
            assert FA.flash_attention.launches - before == \
                (n_attn if impl == "cuda" else 0)
    torch.testing.assert_close(logits["cuda"], logits["ref"], rtol=2e-4,
                               atol=2e-4)
    opt = adamw_init(params)
    step = make_train_step(cfg, TrainConfig())
    params, opt, metrics = step(params, opt, tokens, tokens)
    assert opt.step == 1 and bool(torch.isfinite(metrics["loss"]))
    with pytest.raises(RuntimeError, match="no backward"):
        make_train_step(cfg, TrainConfig(impl="cuda"))(params, opt, tokens,
                                                       tokens)


# tests/test_kernels.py's int8 shapes, a ragged K x N edge, llama2-7b's
# down projection at decode (split K over blocks), and the edges of the
# bfloat16 kernel's plan: 16 rows a block up to M = 16 and 128 above, K not
# a multiple of the 32-deep stage, and N not a multiple of 16 (element
# loads, not 16-byte copies)
INT8_SHAPES = [(128, 512, 128), (70, 300, 130), (1, 1024, 256),
               (256, 64, 64), (5, 7, 3), (4, 11008, 4096),
               (16, 4104, 4100), (17, 4104, 4100), (17, 4104, 4096),
               (130, 4104, 4096)]
INT8_TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_kernel_matches_plain_on_gpu(gpu, m, k, n, dtype):
    """The int8 matmul kernel against its plain version at the JAX int8
    test's tolerance, one launch per call, with leading dimensions kept."""
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((1, m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    x = x.to(gpu, getattr(torch, dtype))
    wq, sc = I8.quantize_int8(w.to(gpu))
    before = I8.int8_matmul.launches
    got = I8.int8_matmul(x, wq, sc)
    want = I8.int8_matmul_plain(x, wq, sc)
    torch.cuda.synchronize()
    assert I8.int8_matmul.launches == before + 1
    assert got.shape == (1, m, n) and got.dtype == x.dtype
    torch.testing.assert_close(got.float(), want.float(), **INT8_TOL[dtype])


@pytest.mark.parametrize("m,k,n", [(4, 4096, 4096), (17, 4104, 4100),
                                   (300, 4096, 4096)])
def test_int8_bf16_repeat_is_bit_identical(gpu, m, k, n):
    """The bfloat16 kernel sums in a fixed order (split-K reduced in index
    order, no atomics): a second call on the same inputs gives the same
    bits, at a split-K decode shape, a masked one and a 128-row one."""
    rng = np.random.default_rng(m * k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    x = x.to(gpu, torch.bfloat16)
    wq, sc = I8.quantize_int8(w.to(gpu))
    first = I8.int8_matmul(x, wq, sc)
    second = I8.int8_matmul(x, wq, sc)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_int8_wrapper_raises_on_what_the_kernel_does_not_take(gpu):
    x = torch.zeros((4, 64), device=gpu)
    wq, sc = I8.quantize_int8(torch.ones((64, 32), device=gpu))
    before = I8.int8_matmul.launches
    bad = [
        (x.half(), wq, sc),                                  # float16 x
        (x, wq.float(), sc),                                 # float w_q
        (x, wq, sc.double()),                                # float64 scale
        (x, wq, sc[0]),                                      # scale [N]
        (x[:, :32], wq, sc),                                 # K mismatch
        (x.t().contiguous().t(), wq, sc),                    # strides
        (x, wq, sc.cpu()),                                   # two devices
    ]
    for call in bad:
        with pytest.raises(ValueError):
            I8.int8_matmul(*call)
    assert I8.int8_matmul.launches == before


def test_streamed_tokens_equal_monolithic_on_gpu(gpu):
    """Reduced llama2-7b in float32 on the card: shared-prefix prompts served
    with the prefix cache and chunked prefill give the monolithic paged
    serve's greedy tokens; the paged kernel reads every decode step."""
    cfg = get_config("llama2-7b").reduced(n_layers=3)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0), gpu)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, n).astype(np.int32)]) for n in (5, 17, 3, 30, 9)]
    sp = SamplingParams(max_tokens=10)
    outs, stats = {}, {}
    for streamed in (False, True):
        be = TensorBackend(cfg, params, n_slots=2, max_len=96, impl="cuda",
                           cache_layout="paged", block_size=16,
                           prefix_cache=streamed)
        llm = LLM.from_backend(be, prefill_chunk=16 if streamed else None)
        before = PA.paged_attention.launches
        outs[streamed] = [o.tokens for o in llm.generate(prompts, sp)]
        assert PA.paged_attention.launches > before
        stats[streamed] = llm.stats
    assert outs[True] == outs[False]
    assert stats[True].prefix_hits >= 3 and stats[True].prefill_chunks > 5
    assert stats[False].prefix_hits == 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-0.6b"])
def test_pipeline_tokens_equal_tensor_backend_on_gpu(gpu, arch, layout):
    """Reduced model in float32 on the card: the no-bubbles pipeline over
    uneven stages with an empty first stage serves the contiguous
    TensorBackend's greedy tokens (a pool small enough to preempt on the
    paged layout), its layout's decode kernel launching once per layer and
    fed token and the other never."""
    cfg = get_config(arch).reduced(n_layers=4)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0), gpu)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 23, 40, 17, 9)]
    sp = SamplingParams(max_tokens=12)
    want = [o.tokens for o in LLM.from_backend(TensorBackend(
        cfg, params, n_slots=3, max_len=64, impl="cuda")).generate(
            prompts, sp)]
    be = PipelineBackend(cfg, params, PL.PipelineSpec(3, (0, 3, 1)),
                         n_slots=4, max_len=64, impl="cuda",
                         cache_layout=layout, block_size=16,
                         num_blocks=4 if layout == "paged" else None)
    assert be.info.attn_impl == "cuda"
    da, pa = DA.decode_attention.launches, PA.paged_attention.launches
    llm = LLM.from_backend(be)
    got = [o.tokens for o in llm.generate(prompts, sp)]
    assert got == want
    launched = (DA.decode_attention.launches - da,
                PA.paged_attention.launches - pa)
    if layout == "paged":
        assert llm.stats.preemptions > 0
        assert launched[0] == 0 and launched[1] > 0
    else:
        # every prompt token and every generated token but the last rides
        # the whole ring once: one launch per layer
        fed = sum(len(p) + sp.max_tokens - 1 for p in prompts)
        assert launched == (cfg.n_layers * fed, 0)


def test_pipeline_forward_on_gpu(gpu):
    """Reduced llama2-7b in float32 on the card: the microbatched forward
    through the flash kernel (one launch per layer and micro-batch) equals
    the unstaged ref path at 2e-4, over uneven stages with an empty one."""
    cfg = get_config("llama2-7b").reduced(n_layers=5)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0), gpu)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 40))).to(gpu)
    with torch.no_grad():
        want, _ = TT.forward(cfg, params, tokens, mode="train", impl="ref")
        before = FA.flash_attention.launches
        got = PL.pipeline_forward(cfg, params, tokens,
                                  PL.PipelineSpec(4, (2, 0, 2, 1)), 2,
                                  impl="cuda")
    assert FA.flash_attention.launches - before == cfg.n_layers * 2
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------- #
# the dense configs' shapes: starcoder2-7b's group of 9 (36 verify rows in
# row chunks of 16, 16 and 4), qwen1.5-32b's MHA at 40 heads, gemma2-2b's
# D=256 with softcap 50 over a wrapped 4096-key window
# --------------------------------------------------------------------------- #

DENSE_PAGED_CASES = [
    # paged_case arguments, its keywords, the kernel options
    ((4, 36, 4, 128, 16, 32, (512, 300, 17, 129), 1, 80), {}, {}),
    ((4, 36, 4, 128, 16, 32, (509, 300, 17, 129), 4, 81), {}, {}),
    ((4, 40, 40, 128, 16, 32, (512, 300, 17, 129), 1, 82), {}, {}),
    ((2, 8, 4, 256, 16, 256, (4096, 700), 1, 83), dict(last=4600),
     dict(window=4096, softcap=50.0)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("args,kw,opts", DENSE_PAGED_CASES,
                         ids=["g9", "g9-kq4", "g1-h40", "d256-softcap-window"])
def test_paged_dense_config_shapes(gpu, dtype, args, kw, opts):
    """The paged kernel at the dense configs' shapes against its plain
    version; two calls bit-identical; unread pool rows poisoned with NaN
    change nothing."""
    x = paged_case(*args[:-1], seed=args[-1], **kw)
    t, bad = (_on(c, gpu, getattr(torch, dtype))
              for c in (x, poison_unread(x, opts.get("window"))))
    if args[7] == 1:
        t["q"], bad["q"] = t["q"][:, 0], bad["q"][:, 0]
    before = PA.paged_attention.launches
    got = PA.paged_attention(**t, **opts)
    want = PA.paged_attention_plain(**t, **opts)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(PA.paged_attention(**t, **opts), got)
    assert torch.equal(PA.paged_attention(**bad, **opts), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_verify_row_equals_decode_at_g9(gpu, dtype):
    """starcoder2-7b's group of 9 at KQ=4: 36 rows a K/V head in chunks of
    16, 16 and 4, the chunk boundaries inside draft tokens' groups; row i
    gives the bits of the KQ=1 call (one block of 9 rows) at pos + i."""
    t = _on(paged_case(4, 36, 4, 128, 16, 32, (509, 300, 17, 129), 4,
                       seed=84), gpu, getattr(torch, dtype))
    four = PA.paged_attention(**t)
    for i in range(4):
        one = PA.paged_attention(t["q"][:, i].contiguous(), t["k_pool"],
                                 t["v_pool"], t["bt"], t["key_pos"],
                                 t["pos"] + i)
        assert torch.equal(four[:, i], one), i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_gemma2_shape(gpu, dtype):
    """The contiguous-ring kernel at gemma2-2b's local layers: D=256,
    softcap 50, a 4096-key window ring wrapped at 4600 (row 0), a fully
    masked row; two calls bit-identical."""
    x = ring_case(2, 8, 4, 256, 4096, (4096, 700), 85, wrap_pos=4600)
    t = _on(x, gpu, getattr(torch, dtype))
    opts = dict(window=4096, softcap=50.0)
    before = DA.decode_attention.launches
    got = DA.decode_attention(**t, **opts)
    want = DA.decode_attention_plain(**t, **opts)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(DA.decode_attention(**t, **opts), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [4096, None], ids=["local", "global"])
def test_flash_gemma2_shape(gpu, dtype, window):
    """The flash kernel at gemma2-2b's score: 1 x 4608, H=8, KH=4, D=256,
    softcap 50, a local layer's 4096 window or a global layer; in bfloat16
    within one bf16 step of the float64 arithmetic."""
    g = torch.Generator(device=gpu).manual_seed(86)
    q, k, v = (torch.randn(shape, generator=g, device=gpu).to(
        getattr(torch, dtype)) for shape in ((1, 4608, 8, 256),
                                             (1, 4608, 4, 256),
                                             (1, 4608, 4, 256)))
    opts = dict(window=window, softcap=50.0)
    got = FA.flash_attention(q, k, v, **opts)
    want = FA.flash_attention_plain(q, k, v, **opts)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(FA.flash_attention(q, k, v, **opts), got)
    if dtype == "bfloat16":
        assert bf16_steps_apart(got, flash_attention_f64(q, k, v,
                                                         **opts)) == 0


#: the dense configs reduced by hand, keeping their group and head width:
#: (query heads, K/V heads, head_dim)
DENSE_GROUPS = {"gemma2-2b": (2, 1, 256), "starcoder2-7b": (9, 1, 128),
                "qwen1.5-32b": (5, 5, 128), "pixtral-12b": (4, 1, 128)}


def _dense(arch, gpu):
    import dataclasses
    h, kh, d = DENSE_GROUPS[arch]
    cfg = dataclasses.replace(get_config(arch).reduced(n_layers=4),
                              n_heads=h, n_kv_heads=kh, head_dim=d)
    return cfg, init_params(cfg, torch.Generator(device=gpu).manual_seed(0),
                            gpu)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", sorted(DENSE_GROUPS))
def test_served_dense_config_tokens_kernel_equals_ref(gpu, arch, layout):
    """Each dense config reduced by hand, in float32 on the card, prompts
    longer than gemma2's reduced window of 16: greedy tokens through the
    kernels equal the ref path's; starcoder2 also verifies 4 drafts a step
    (36 rows) on the paged layout."""
    cfg, params = _dense(arch, gpu)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (23, 19, 26, 17, 21)]
    sp = SamplingParams(max_tokens=10)
    toks = {}
    for impl in ("ref", "cuda"):
        be = TensorBackend(cfg, params, n_slots=3, max_len=48, impl=impl,
                           cache_layout=layout, block_size=8)
        toks[impl] = [o.tokens for o in LLM.from_backend(be).generate(
            prompts, sp)]
    assert toks["cuda"] == toks["ref"]
    if arch == "starcoder2-7b" and layout == "paged":
        be = TensorBackend(cfg, params, n_slots=3, max_len=48, impl="cuda",
                           cache_layout=layout, block_size=8)
        llm = LLM.from_backend(be, spec_k=4)
        assert [o.tokens for o in llm.generate(prompts, sp)] == toks["ref"]
        assert llm.stats.spec_drafted > 0


def test_pipeline_spec_and_streamed_on_gpu(gpu):
    """Reduced llama2-7b in float32 on the card: the paged stage pipeline
    with spec_k=4 and an oracle draft, and with the prefix cache and
    chunks of 8, serves the plain pipeline's greedy tokens; the paged
    kernel launches once a layer and fed token, and the prefix hits cut
    the fed tokens by the adopted ones."""
    cfg = get_config("llama2-7b").reduced(n_layers=4)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0), gpu)
    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, n).astype(np.int32)]) for n in (5, 9, 3, 12, 7)]
    sp = SamplingParams(max_tokens=8)

    def serve(**kw):
        be = PipelineBackend(cfg, params, PL.PipelineSpec(3, (0, 3, 1)),
                             n_slots=3, max_len=64, impl="cuda",
                             cache_layout="paged", block_size=16,
                             prefix_cache=kw.pop("prefix_cache", False))
        before = PA.paged_attention.launches
        b = ContinuousBatcher(be, **kw)
        for uid, p in enumerate(prompts):
            b.submit(Request(p, sp, uid=uid))
        done = b.run()
        return ([done[u].generated for u in range(len(prompts))], b.stats,
                PA.paged_attention.launches - before)

    plain, plain_stats, plain_launches = serve()
    fed = sum(len(p) + sp.max_tokens - 1 for p in prompts)
    assert plain_launches == cfg.n_layers * fed
    oracle = OracleDraft(dict(enumerate(plain)), accept_prob=0.75, seed=0,
                         vocab_size=cfg.vocab_size)
    got, st, _ = serve(spec_k=4, draft=oracle)
    assert got == plain and st.spec_accepted > 0
    assert st.decode_steps < plain_stats.decode_steps
    got, st, launches = serve(prefix_cache=True, prefill_chunk=8)
    assert got == plain and st.prefix_hits > 0
    assert launches == cfg.n_layers * (fed - st.prefix_hit_tokens)


# --------------------------------------------------------------------------- #
# the MoE configs' attention shapes: granite-moe's 2 query heads a K/V head
# at D=64, kimi-k2's 64 query heads over 8 K/V heads at D=128; and the
# reduced MoE configs served through the kernels
# --------------------------------------------------------------------------- #

MOE_PAGED_CASES = [
    ((4, 16, 8, 64, 16, 32, (512, 300, 17, 129), 1, 90), {}, {}),
    ((4, 64, 8, 128, 16, 32, (264, 136, 72, 24), 1, 91), {}, {}),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("args,kw,opts", MOE_PAGED_CASES,
                         ids=["granite-g2-d64", "kimi-g8-h64"])
def test_paged_moe_config_shapes(gpu, dtype, args, kw, opts):
    """The paged kernel at the MoE configs' shapes, as
    ``test_paged_dense_config_shapes`` holds the dense configs'."""
    test_paged_dense_config_shapes(gpu, dtype, args, kw, opts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_granite_shape(gpu, dtype):
    """The contiguous-ring kernel at granite-moe's heads (16, 8, 64) over
    512-key rings, per-row valid lengths; two calls bit-identical."""
    t = _on(ring_case(4, 16, 8, 64, 512, (512, 300, 17, 129), 92), gpu,
            getattr(torch, dtype))
    before = DA.decode_attention.launches
    got = DA.decode_attention(**t)
    want = DA.decode_attention_plain(**t)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(DA.decode_attention(**t), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_granite_shape(gpu, dtype):
    """The flash kernel at granite-moe's score heads: 2 x 1024, H=16,
    KH=8, D=64, causal; in bfloat16 within one bf16 step of the float64
    arithmetic."""
    g = torch.Generator(device=gpu).manual_seed(93)
    q, k, v = (torch.randn(shape, generator=g, device=gpu).to(
        getattr(torch, dtype)) for shape in ((2, 1024, 16, 64),
                                             (2, 1024, 8, 64),
                                             (2, 1024, 8, 64)))
    got = FA.flash_attention(q, k, v)
    want = FA.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(FA.flash_attention(q, k, v), got)
    if dtype == "bfloat16":
        assert bf16_steps_apart(got, flash_attention_f64(q, k, v)) == 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                                  "xlstm-1.3b"])
def test_served_mixer_config_tokens_kernel_equals_ref(gpu, arch, layout):
    """The reduced MoE and xLSTM configs (xlstm at 8 layers, its sLSTM
    block kept) in float32 on the card: greedy tokens through the kernels
    equal the ref path's, and the attention kernel launches once a layer
    and decode step (none for xlstm)."""
    cfg = get_config(arch).reduced(n_layers=8 if arch == "xlstm-1.3b"
                                   else 2)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0),
                         gpu)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (23, 19, 26, 17, 21)]
    sp = SamplingParams(max_tokens=10)
    n_attn = sum(s.kind == "attn" for s in cfg.layer_specs())
    toks = {}
    for impl in ("ref", "cuda"):
        be = TensorBackend(cfg, params, n_slots=3, max_len=48, impl=impl,
                           cache_layout=layout, block_size=8)
        kernel = PA.paged_attention if layout == "paged" \
            else DA.decode_attention
        steps, step = [], be.decode_step

        def counted(feeds, step=step, steps=steps):
            steps.append(bool(feeds))
            return step(feeds)

        be.decode_step = counted
        before = kernel.launches
        toks[impl] = [o.tokens for o in LLM.from_backend(be).generate(
            prompts, sp)]
        if impl == "cuda":
            assert kernel.launches - before == n_attn * sum(steps)
    assert toks["cuda"] == toks["ref"]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_stage_procs_ring_equals_one_process_on_gpu(gpu, layout):
    """llama2-7b reduced to 4 layers in bf16 over two stage processes
    (weights shared by CUDA IPC, activations over gloo): greedy tokens bit
    for bit the ring in one process's, the decode kernel launched in the
    stage processes (once a layer and fed token) and never in this one."""
    import dataclasses
    cfg = dataclasses.replace(get_config("llama2-7b").reduced(n_layers=4),
                              dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0),
                         gpu)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (23, 19, 26, 17, 21)]
    sp = SamplingParams(max_tokens=8)
    kernel = PA.paged_attention if layout == "paged" else DA.decode_attention
    toks = {}
    for procs in (False, True):
        be = PipelineBackend(cfg, params, PL.PipelineSpec(2, (2, 2)),
                             n_slots=3, max_len=48, cache_layout=layout,
                             block_size=8, impl="cuda", stage_procs=procs)
        try:
            if procs:
                be.ring.zero_stats()
            before = kernel.launches
            toks[procs] = [o.tokens for o in LLM.from_backend(be).generate(
                prompts, sp)]
            fed = sum(len(p) + 7 for p in prompts)
            if procs:
                stats = be.ring.stats()
                assert kernel.launches == before
                assert sum(s["launches"][kernel.__name__]
                           for s in stats) == cfg.n_layers * fed
                assert stats[0]["hop_bytes"] == 2 * cfg.d_model * fed
            else:
                assert kernel.launches - before == cfg.n_layers * fed
        finally:
            be.close()
    assert toks[True] == toks[False]


# --------------------------------------------------------------------------- #
# the mesh of processes: pipeline_forward over it and the expert-parallel MoE
# --------------------------------------------------------------------------- #

def test_mesh_pipeline_forward_on_gpu(gpu):
    """Reduced llama2-7b in float32 over a (2, 2) mesh of processes on the
    card (weights shared by CUDA IPC, activations over gloo): two stages
    over model, each micro-batch's rows over data; the logits equal the
    one-process ``pipeline_forward``'s at 2e-4, and the flash kernel
    launched in the processes (a stage's layers x the micro-batches each)
    and never in this one."""
    from repro_torch.core.mesh_procs import MeshProcs
    from repro_torch.launch.mesh import make_test_mesh
    cfg = get_config("llama2-7b").reduced(n_layers=5)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0), gpu)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 40))).to(gpu)
    spec = PL.PipelineSpec(2, (3, 2))
    with torch.no_grad():
        want = PL.pipeline_forward(cfg, params, tokens, spec, 2, impl="cuda")
    procs = MeshProcs(cfg, params, make_test_mesh(2, 2), impl="cuda")
    try:
        before = FA.flash_attention.launches
        got = procs.pipeline_forward(tokens, spec, 2)
        stats = procs.stats()
    finally:
        procs.close()
    assert FA.flash_attention.launches == before
    assert [s["launches"]["flash_attention"] for s in stats] == \
        [6, 4, 6, 4]
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_mesh_moe_ep_forward_on_gpu(gpu):
    """Reduced granite-moe in float32 on a (2, 2) mesh of processes: the
    whole model's forward with both MoE layers on ``moe_ep`` (two experts
    a process, nothing dropped at the reduced config's capacity factor of
    8.0) equals the one-process ``moe_ragged`` forward at 2e-4."""
    from repro_torch.core.mesh_procs import MeshProcs
    from repro_torch.launch.mesh import make_test_mesh
    cfg = get_config("granite-moe-1b-a400m").reduced(n_layers=2)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0), gpu)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 32))).to(gpu)
    with torch.no_grad():
        want, _ = TT.forward(cfg, params, tokens, mode="train", impl="cuda")
    procs = MeshProcs(cfg, params, make_test_mesh(2, 2), impl="cuda")
    try:
        got = procs.forward(tokens)
        stats = procs.stats()
    finally:
        procs.close()
    for st in stats:
        assert [r["dropped"] for r in st["moe"]] == [0, 0]
        assert st["launches"]["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------- #
# tensor parallelism over the mesh's model axis
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_tp_serve_launches_in_the_processes_on_gpu(gpu, layout):
    """llama2-7b reduced to 4 layers in float32 on a (1, 2) mesh of
    processes (``TensorBackend(..., mesh=...)``, two of its four heads a
    process): greedy tokens those of one process, the decode (or paged)
    kernel launched once a layer and decode step in each process and
    never in this one."""
    from repro_torch.launch.mesh import Mesh
    cfg = get_config("llama2-7b").reduced(n_layers=4)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0),
                         gpu)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (23, 19, 26, 17, 21)]
    sp = SamplingParams(max_tokens=8)
    kernel = PA.paged_attention if layout == "paged" else DA.decode_attention
    kw = dict(n_slots=3, max_len=48, cache_layout=layout, block_size=8,
              impl="cuda")
    want = [o.tokens for o in LLM.from_backend(
        TensorBackend(cfg, params, **kw)).generate(prompts, sp)]
    be = TensorBackend(cfg, params, mesh=Mesh(("data", "model"), (1, 2)),
                       **kw)
    try:
        before = kernel.launches
        got = [o.tokens for o in LLM.from_backend(be).generate(prompts, sp)]
        stats = be.stats()
    finally:
        be.close()
    assert got == want
    assert kernel.launches == before
    for st in stats:
        assert st["launches"][kernel.__name__] == \
            cfg.n_layers * st["calls"]["decode_step"]
        assert st["tp"]["calls"] > 0


def test_tp_forward_on_gpu(gpu):
    """llama2-7b reduced to 4 layers in float32: ``MeshProcs.forward`` on
    a (1, 2) mesh (heads, ff and vocabulary split) equals the one-process
    forward at 2e-4, the flash kernel launched once a layer in each
    process."""
    from repro_torch.core.mesh_procs import MeshProcs
    from repro_torch.launch.mesh import Mesh
    cfg = get_config("llama2-7b").reduced(n_layers=4)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0),
                         gpu)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 64))).to(gpu)
    with torch.no_grad():
        want, _ = TT.forward(cfg, params, tokens, mode="train", impl="cuda")
    procs = MeshProcs(cfg, params, Mesh(("data", "model"), (1, 2)),
                      impl="cuda")
    try:
        got = procs.forward(tokens)
        stats = procs.stats()
    finally:
        procs.close()
    for st in stats:
        assert st["launches"]["flash_attention"] == cfg.n_layers
        assert st["tp"]["calls"] == 2 * cfg.n_layers + 2
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
