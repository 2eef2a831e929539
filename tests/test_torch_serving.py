"""Serving through the port (``LLM`` -> ``ContinuousBatcher`` ->
``TorchTensorBackend`` on the contiguous and the paged KV cache, on the
CPU) against the JAX package's ``LLM`` over ``TensorBackend(impl="pallas")``
on the same layout, with the reference's own weights in float32.

Greedy tokens must be bit-identical, with varlen prompts, fewer slots than
requests (slots recycle), a pool small enough to preempt and resume, and a
sliding window shorter than prompt + generation (the contiguous ring
wraps).  Temperature > 0 draws from torch generators, which give other
numbers than ``jax.random``: those tests check determinism per seed and the
top-k support only.
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib  # noqa: E402
import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import TensorBackend  # noqa: E402
from repro.serving import LLM as JaxLLM  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.runtime import PoolExhausted, TorchTensorBackend  # noqa: E402
from repro_torch.serving import LLM, SamplingParams  # noqa: E402
from repro_torch.serving.sampling import (request_generator,  # noqa: E402
                                          sample_logits)

torch.set_num_threads(2)

ARCH = "qwen3-0.6b"
N_LAYERS = 2


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).reduced(n_layers=N_LAYERS)
    tcfg = get_config(ARCH).reduced(n_layers=N_LAYERS)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


def _torch_llm(model, impl="cuda", **kw):
    _, tcfg, _, tparams = model
    return LLM.from_backend(TorchTensorBackend(
        tcfg, tparams, impl=impl, cache_layout="paged", device="cpu", **kw))


@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("n_slots,num_blocks,lens", [
    (4, None, (5, 17, 9, 12)),             # one wave, varlen buckets
    (2, None, (6, 9, 4, 7, 5)),            # slots < batch: slots recycle
    (3, 4, (6, 9, 4, 7, 5)),               # pool < 3 x 2 blocks: preempt
])
def test_greedy_tokens_bit_identical(model, impl, n_slots, num_blocks, lens):
    jcfg, tcfg, jparams, _ = model
    prompts = _prompts(tcfg, lens)
    jllm = JaxLLM.from_backend(TensorBackend(
        jcfg, jparams, n_slots=n_slots, max_len=32, impl="pallas",
        cache_layout="paged", num_blocks=num_blocks))
    want = jllm.generate(prompts, JaxSamplingParams(max_tokens=12))
    llm = _torch_llm(model, impl, n_slots=n_slots, max_len=32,
                     num_blocks=num_blocks)
    got = llm.generate(prompts, SamplingParams(max_tokens=12))
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, (g.uid, g.tokens, w.tokens)
        assert g.n_generated == 12
    assert llm.stats.preemptions == jllm.stats.preemptions
    assert llm.stats.resumes == jllm.stats.resumes
    if num_blocks is not None:
        assert llm.stats.preemptions > 0 and llm.stats.resumes > 0
        assert any(o.timing.preemptions for o in got)
    pager = llm.backend.pager
    assert pager.free_blocks == pager.total_blocks
    assert PA.paged_attention.launches == 0      # CPU: the plain version


def test_stream_and_stepping_match_generate(model):
    _, tcfg, _, _ = model
    prompts = _prompts(tcfg, (7, 3, 11), seed=2)
    sp = SamplingParams(max_tokens=6)
    want = [o.tokens for o in _torch_llm(model, n_slots=2, max_len=32)
            .generate(prompts, sp)]
    llm = _torch_llm(model, n_slots=2, max_len=32)
    streamed = {}
    for ev in llm.stream(prompts, sp):
        streamed.setdefault(ev.uid, []).append(ev.token)
    assert list(streamed.values()) == want
    llm = _torch_llm(model, n_slots=2, max_len=32)
    uids = [llm.submit(p, sp) for p in prompts]
    while llm.has_work:
        llm.step()
    assert [llm.poll(u).tokens for u in uids] == want


def _windowed(cfg, window):
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(s, window=window) for s in cfg.pattern))


@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("n_slots,lens,window", [
    (4, (5, 17, 9, 12), None),             # one wave, varlen buckets
    (2, (6, 9, 4, 7, 5), None),            # slots < batch: slots recycle
    (3, (6, 9, 4, 7, 5), 8),               # window 8 < prompt + gen: wraps
])
def test_contiguous_greedy_tokens_bit_identical(model, impl, n_slots, lens,
                                                window):
    """The default layout: one ring per slot, every slot decoding each
    step (idle ones too, as the reference's vmap does)."""
    jcfg, tcfg, jparams, tparams = model
    if window is not None:
        jcfg, tcfg = _windowed(jcfg, window), _windowed(tcfg, window)
    prompts = _prompts(tcfg, lens)
    want = JaxLLM.from_backend(TensorBackend(
        jcfg, jparams, n_slots=n_slots, max_len=32, impl="pallas")).generate(
        prompts, JaxSamplingParams(max_tokens=12))
    be = TorchTensorBackend(tcfg, tparams, n_slots=n_slots, max_len=32,
                            impl=impl, device="cpu")
    assert be.info.cache_layout == "contiguous"
    got = LLM.from_backend(be).generate(prompts,
                                        SamplingParams(max_tokens=12))
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, (g.uid, g.tokens, w.tokens)
        assert g.n_generated == 12
    assert DA.decode_attention.launches == 0     # CPU: the plain version


def test_backend_info_and_unported_layouts(model):
    """BackendInfo matches the JAX backend's field for field on both
    layouts, with and without the prefix cache, but for ``attn_impl``,
    which names the port's read path ("plain": the kernel's plain version on
    the CPU, where the reference says "pallas").  ``supports_extend`` and
    ``prefix_caching`` equal the reference's: on the paged layout
    ``start_stream`` and ``prefill_chunk`` serve (the prompt's first token
    logits equal a monolithic prefill's), on the contiguous one they are not
    advertised.  An unknown impl or layout still raises."""
    jcfg, tcfg, jparams, tparams = model
    prompt = _prompts(tcfg, [11])[0]
    for layout in ("contiguous", "paged"):
        for prefix in (False, True):
            want = TensorBackend(jcfg, jparams, n_slots=2, max_len=32,
                                 impl="pallas", cache_layout=layout,
                                 prefix_cache=prefix).info
            be = TorchTensorBackend(tcfg, tparams, n_slots=2, max_len=32,
                                    impl="cuda", cache_layout=layout,
                                    cache_dtype=torch.float32, device="cpu",
                                    prefix_cache=prefix)
            got = dataclasses.asdict(be.info)
            assert got.pop("attn_impl") == "plain"
            want = dataclasses.asdict(want)
            assert want.pop("attn_impl") == "pallas"
            assert got == want, (layout, prefix)
            assert got["supports_extend"] == (layout == "paged")
            assert got["prefix_caching"] == (layout == "paged" and prefix)
            assert be.info.spec_decode == (layout == "paged")
        if layout == "paged":
            mono = be.prefill([0], prompt[None])[0].logits
            assert be.start_stream(1, prompt) == 0
            evs = be.prefill_chunk([1], prompt[None, :6], [6], [0], [False])
            assert evs == []
            evs = be.prefill_chunk([1], prompt[None, 6:], [5], [6], [True])
            assert [ev.slot for ev in evs] == [1]
            np.testing.assert_allclose(evs[0].logits, mono, rtol=1e-5,
                                       atol=1e-5)
            assert np.array_equal(evs[0].logits.argmax(), mono.argmax())
    with pytest.raises(ValueError, match="unknown decode impl"):
        TorchTensorBackend(tcfg, tparams, n_slots=2, max_len=32,
                           impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="cache_layout"):
        TorchTensorBackend(tcfg, tparams, n_slots=2, max_len=32,
                           cache_layout="ring", device="cpu")


def test_pool_exhausted_before_any_mutation(model):
    """decode_step raises PoolExhausted before touching the pager or the
    caches, so the scheduler can preempt and retry."""
    _, tcfg, _, tparams = model
    be = TorchTensorBackend(tcfg, tparams, n_slots=2, max_len=32,
                            cache_layout="paged", num_blocks=2, device="cpu")
    prompts = np.stack(_prompts(tcfg, (16, 16), seed=3))
    be.prefill([0, 1], prompts)
    table = be.pager.table.copy()
    caches = [{k: v.clone() for k, v in c.items()} for c in be.caches]
    with pytest.raises(PoolExhausted):
        be.decode_step({0: 1, 1: 2})
    np.testing.assert_array_equal(be.pager.table, table)
    for c, c0 in zip(be.caches, caches):
        for k in c:
            assert torch.equal(c[k], c0[k]), k
    be.free_slot(1)
    assert len(be.decode_step({0: 1})) == 1


def test_temperature_sampling_deterministic_per_seed(model):
    _, tcfg, _, _ = model
    prompts = _prompts(tcfg, (5, 8, 3), seed=4)
    sp = SamplingParams(max_tokens=8, temperature=1.0, top_k=5)

    def run(seed, order=(0, 1, 2)):
        llm = LLM.from_backend(_torch_llm(model, n_slots=3,
                                          max_len=32).backend, seed=seed)
        for i in order:                # generators are seeded by (seed, uid)
            llm.submit(prompts[i], sp, uid=i)
        while llm.has_work:
            llm.step()
        return {i: llm.poll(i).tokens for i in order}
    a = run(0)
    assert a == run(0)
    assert a != run(1)
    # a request's draws come from its own generator: independent of order
    assert a == run(0, order=(2, 1, 0))


def test_sample_logits_top_k_support():
    r = np.random.default_rng(5)
    logits = torch.from_numpy(r.standard_normal((4, 50)).astype(np.float32))
    top = torch.topk(logits, 3, dim=-1).indices
    gen = request_generator(0, 7)
    for _ in range(50):
        tok = sample_logits(gen, logits,
                            SamplingParams(temperature=2.0, top_k=3))
        assert bool((top == tok[:, None]).any(-1).all())
    greedy = sample_logits(gen, logits, SamplingParams(temperature=0.0))
    assert torch.equal(greedy, logits.argmax(-1))
    one = sample_logits(request_generator(0, 7), logits,
                        SamplingParams(temperature=1.0))
    assert torch.equal(one, sample_logits(request_generator(0, 7), logits,
                                          SamplingParams(temperature=1.0)))


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--impl", "cuda",
          "--batch", "3", "--slots", "2", "--varlen", "--prompt-len", "10",
          "--gen", "4", "--cache-layout", "paged", "--kv-blocks", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "attn_impl=plain" in out


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_serve_launcher_layouts_and_spec(capsys, layout):
    """The default layout is contiguous; --spec-k 4 verifies drafts on the
    paged layout and prints a note, serving plain decode, on the
    contiguous one."""
    from repro_torch.launch.serve import main
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "3",
            "--slots", "2", "--prompt-len", "10", "--gen", "6",
            "--spec-k", "4"]
    if layout == "paged":
        argv += ["--cache-layout", "paged"]
    with pytest.warns(RuntimeWarning) if layout == "contiguous" else \
            contextlib.nullcontext():
        main(argv)
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert ("note: --spec-k has no effect on this deployment: backend "
            "reports spec_decode=False" in out) == (layout == "contiguous")
    assert ("spec_drafted=" in out) == (layout == "paged")
