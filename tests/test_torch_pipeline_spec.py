"""Speculative verify, the prefix cache and streamed admission on the port's
no-bubbles stage pipeline (``repro_torch.runtime.pipeline_backend``) against
the JAX package on the CPU, in float32, with the reference's own weights:
qwen3-0.6b reduced to 6 layers, and llama2-70b reduced to 6 layers with two
query heads a K/V head (GQA).

The cases mirror the reference's pipeline tests
(``tests/test_spec_decode.py::test_pipeline_spec_parity_and_host_sampling``
and ``tests/test_prefix_cache.py::test_pipeline_prefix_and_chunked_parity``)
and run in-process: each serve's greedy tokens must equal the JAX
``TensorBackend(impl="xla")``'s, bit for bit, and the scheduler's counters
must move as the features promise -- accepted drafts and fewer quanta
under spec, prefix hits and reused tokens under the prefix cache, more
chunk passes than prompts under chunked admission.  Also: uneven and empty
stages, pools small enough to preempt, ``rollback_slot`` and
``reset_slot(start > 0)`` on every layer's ring view, adopted blocks never
written, temperature > 0, and the launcher's ``--mode pipeline`` with
``--spec-k`` and ``--prefix-cache --prefill-chunk``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import TensorBackend as JaxTensorBackend  # noqa: E402
from repro.serving import LLM as JaxLLM  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.runtime import PipelineBackend  # noqa: E402
from repro_torch.serving import (LLM, ContinuousBatcher,  # noqa: E402
                                 OracleDraft, Request, SamplingParams)

torch.set_num_threads(2)
ARCHS = ["qwen3-0.6b", "llama2-70b"]
#: uneven, empty-ended and single-stage layouts of the 6-layer stacks
LAYOUTS = [(3, 3), (0, 1, 2, 3), (6,)]
MAX_LEN, BS = 48, 8


def _configs(arch, n_layers=6):
    jcfg = jax_get_config(arch).reduced(n_layers=n_layers)
    tcfg = get_config(arch).reduced(n_layers=n_layers)
    if arch == "llama2-70b":              # 70B groups 8 query heads a KV head
        jcfg = dataclasses.replace(jcfg, n_kv_heads=2)
        tcfg = dataclasses.replace(tcfg, n_kv_heads=2)
    return jcfg, tcfg


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg, tcfg = _configs(arch)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _MODELS[arch] = (jcfg, tcfg, jparams, tparams)
    return _MODELS[arch]


def _prompts(cfg, lens, seed=1, shared=0):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, cfg.vocab_size, shared).astype(np.int32)
    return [np.concatenate([pre, rng.integers(0, cfg.vocab_size, n)
                            .astype(np.int32)]) for n in lens]


_REFERENCE = {}


def _reference_tokens(arch, prompts, max_tokens, layout="paged"):
    """Greedy tokens of the JAX TensorBackend."""
    key = (arch, tuple(map(tuple, prompts)), max_tokens, layout)
    if key not in _REFERENCE:
        jcfg, _, jparams, _ = _model(arch)
        jllm = JaxLLM.from_backend(JaxTensorBackend(
            jcfg, jparams, n_slots=3, max_len=MAX_LEN, impl="xla",
            cache_layout=layout, block_size=BS))
        _REFERENCE[key] = [o.tokens for o in jllm.generate(
            prompts, JaxSamplingParams(max_tokens=max_tokens))]
    return _REFERENCE[key]


def _backend(arch, sizes, layout="paged", n_slots=None, **kw):
    _, tcfg, _, tparams = _model(arch)
    return PipelineBackend(tcfg, tparams, PL.PipelineSpec(len(sizes), sizes),
                           n_slots=n_slots or max(len(sizes), 2),
                           max_len=MAX_LEN, cache_layout=layout,
                           block_size=BS, device="cpu", impl="cuda", **kw)


def _serve(be, prompts, max_tokens, temperature=0.0, **kw):
    """(tokens by uid, stats) of one batcher serve, uid = prompt index."""
    b = ContinuousBatcher(be, **kw)
    sp = SamplingParams(max_tokens=max_tokens, temperature=temperature)
    for uid, p in enumerate(prompts):
        b.submit(Request(p, sp, uid=uid))
    done = b.run()
    return [done[u].generated for u in range(len(prompts))], b.stats


# --------------------------------------------------------------------------- #
# the core helpers
# --------------------------------------------------------------------------- #

def _paged_state(m=3):
    _, tcfg, _, _ = _model("qwen3-0.6b")
    state = PL.init_pipeline_decode_state(
        tcfg, PL.PipelineSpec(2, (3, 3)), m, 32, torch.float32, "paged",
        num_blocks=12, block_size=4, device="cpu")
    g = torch.Generator().manual_seed(0)
    for cache in state.caches:            # every row live, pools random
        cache["key_pos"].copy_(torch.arange(32, dtype=torch.int32)
                               .expand(m, 32))
        cache["pos"].fill_(20)
        for k in ("k_pool", "v_pool"):
            cache[k].copy_(torch.randn(cache[k].shape, generator=g))
    return state


def test_rollback_slot_cuts_one_slot_in_every_layer():
    state = _paged_state()
    before = [{k: t.clone() for k, t in c.items()} for c in state.caches]
    PL.rollback_slot(state, 1, 13)
    assert len(state.caches) == 6
    for c, b in zip(state.caches, before):
        row = c["key_pos"][1]
        assert torch.equal(row[:13], torch.arange(13, dtype=torch.int32))
        assert bool((row[13:] == -1).all())
        assert int(c["pos"][1]) == 13
        for s in (0, 2):                  # the other slots: untouched
            assert torch.equal(c["key_pos"][s], b["key_pos"][s])
            assert int(c["pos"][s]) == 20
        for k in ("k_pool", "v_pool", "bt"):
            assert torch.equal(c[k], b[k])


def test_reset_slot_marks_an_adopted_start_live_in_every_layer():
    state = _paged_state()
    state.logits_out.fill_(1.)
    state.token_ready[:] = True
    pools = [(c["k_pool"].clone(), c["v_pool"].clone())
             for c in state.caches]
    PL.reset_slot(state, 2, 8)
    for c, (kp, vp) in zip(state.caches, pools):
        row = c["key_pos"][2]
        assert torch.equal(row[:8], torch.arange(8, dtype=torch.int32))
        assert bool((row[8:] == -1).all())
        assert int(c["pos"][2]) == 8
        assert torch.equal(c["key_pos"][0], torch.arange(32,
                                                         dtype=torch.int32))
        assert torch.equal(c["k_pool"], kp) and torch.equal(c["v_pool"], vp)
    assert bool((state.logits_out[2] == 0).all())
    assert bool((state.logits_out[0] == 1).all())
    assert not state.token_ready[2] and state.token_ready[0]
    PL.reset_slot(state, 2)
    assert all(bool((c["key_pos"][2] == -1).all()) and int(c["pos"][2]) == 0
               for c in state.caches)


def test_reset_slot_start_needs_the_paged_layout():
    _, tcfg, _, _ = _model("qwen3-0.6b")
    state = PL.init_pipeline_decode_state(tcfg, PL.PipelineSpec(1, (6,)), 2,
                                          16, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="paged layout"):
        PL.reset_slot(state, 0, 8)


# --------------------------------------------------------------------------- #
# BackendInfo
# --------------------------------------------------------------------------- #

def test_info_reports_the_features_per_layout():
    paged = _backend("qwen3-0.6b", (3, 3), prefix_cache=True)
    assert paged.info.spec_decode and paged.info.supports_extend
    assert paged.info.prefix_caching
    plain = _backend("qwen3-0.6b", (3, 3))
    assert plain.info.spec_decode and not plain.info.prefix_caching
    contig = _backend("qwen3-0.6b", (3, 3), "contiguous", prefix_cache=True)
    assert not contig.info.spec_decode and contig.info.supports_extend
    assert not contig.info.prefix_caching
    assert contig.cached_prefix_len(np.arange(20)) == 0
    with pytest.raises(AssertionError, match="paged layout"):
        contig.verify_step({0: np.array([1, 2])})
    # a window shorter than max_len wraps the ring: no shared blocks
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    windowed = dataclasses.replace(tcfg, pattern=tuple(
        dataclasses.replace(s, window=16) for s in tcfg.pattern))
    be = PipelineBackend(windowed, tparams, PL.PipelineSpec(2, (3, 3)),
                         max_len=MAX_LEN, cache_layout="paged",
                         block_size=BS, prefix_cache=True, device="cpu")
    assert not be.info.spec_decode and not be.info.prefix_caching
    assert be.info.supports_extend


# --------------------------------------------------------------------------- #
# speculative verify
# --------------------------------------------------------------------------- #

SPEC_LENS = (5, 17, 9, 12, 3, 8, 14)


@pytest.mark.parametrize("sizes", LAYOUTS, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tokens_equal_reference(arch, sizes):
    """Drafts of an oracle that is right 3 times in 4: greedy tokens equal
    the plain serve's and the JAX TensorBackend's, some drafts are accepted
    and some rejected (rolled back), in fewer quanta than plain decode."""
    _, tcfg, _, _ = _model(arch)
    prompts = _prompts(tcfg, SPEC_LENS)
    want = _reference_tokens(arch, prompts, 10)
    plain, plain_stats = _serve(_backend(arch, sizes), prompts, 10)
    assert plain == want
    be = _backend(arch, sizes)
    oracle = OracleDraft(dict(enumerate(want)), accept_prob=0.75, seed=1,
                         vocab_size=tcfg.vocab_size)
    got, stats = _serve(be, prompts, 10, spec_k=4, draft=oracle)
    assert got == want
    assert 0 < stats.spec_accepted < stats.spec_drafted
    assert stats.decode_steps < plain_stats.decode_steps
    assert not be._pending and not be._vflight
    assert be.pager.free_blocks == be.pager.total_blocks


def test_spec_preempts_on_a_small_pool():
    arch, sizes = "qwen3-0.6b", (0, 1, 2, 3)
    _, tcfg, _, _ = _model(arch)
    prompts = _prompts(tcfg, SPEC_LENS)
    want = _reference_tokens(arch, prompts, 10)
    be = _backend(arch, sizes, n_slots=4, num_blocks=9)
    oracle = OracleDraft(dict(enumerate(want)), accept_prob=0.75, seed=1,
                         vocab_size=tcfg.vocab_size)
    got, stats = _serve(be, prompts, 10, spec_k=4, draft=oracle)
    assert got == want
    assert stats.preemptions > 0 and stats.spec_accepted > 0
    assert be.pager.free_blocks == be.pager.total_blocks


# --------------------------------------------------------------------------- #
# the prefix cache and chunked admission
# --------------------------------------------------------------------------- #

STREAM_LENS = (5, 7, 3, 9, 6, 4)
#: (layout, prefix_cache, prefill_chunk)
STREAM_CASES = [("paged", True, None), ("paged", False, 4),
                ("paged", True, 4), ("paged", True, 3),
                ("contiguous", True, 4)]


@pytest.mark.parametrize("layout,prefix,chunk", STREAM_CASES, ids=str)
@pytest.mark.parametrize("sizes", [(3, 3), (0, 1, 2, 3)], ids=str)
def test_streamed_tokens_equal_reference(sizes, layout, prefix, chunk):
    """Prompts sharing a 16-token prefix (two blocks of 8)."""
    arch = "qwen3-0.6b"
    _, tcfg, _, _ = _model(arch)
    prompts = _prompts(tcfg, STREAM_LENS, shared=16)
    want = _reference_tokens(arch, prompts, 5)
    assert len({t for ts in want for t in ts}) > 2
    be = _backend(arch, sizes, layout, num_blocks=32 if layout == "paged"
                  else None, prefix_cache=prefix)
    llm = LLM.from_backend(be, prefill_chunk=chunk)
    got = llm.generate(prompts, SamplingParams(max_tokens=5))
    assert [o.tokens for o in got] == want
    st = llm.stats
    if prefix and layout == "paged":
        assert st.prefix_hits >= 2 and st.prefix_hit_tokens >= 32, st
        assert be.info.prefix_hits == st.prefix_hits
        assert be.info.prefix_hit_tokens == st.prefix_hit_tokens
    else:
        assert st.prefix_hits == 0 and be.info.prefix_hits == 0, st
    if chunk is not None:
        assert st.prefill_chunks > len(prompts), st
    if layout == "paged":
        assert be.pager.free_blocks == be.pager.total_blocks


def test_adopted_blocks_are_never_written():
    """The blocks a hit adopts hold the first prompt's prefix keys; no later
    tick of any slot writes them."""
    arch = "qwen3-0.6b"
    _, tcfg, _, _ = _model(arch)
    prompts = _prompts(tcfg, STREAM_LENS, shared=16)
    be = _backend(arch, (3, 3), num_blocks=32, prefix_cache=True)
    llm = LLM.from_backend(be, prefill_chunk=4)
    for p in prompts:
        llm.submit(p, SamplingParams(max_tokens=5))
    shared = snap = None
    while llm.has_work:
        llm.step()
        if shared is None and llm.stats.prefix_hits:
            slot = next(s for s, b in be._base.items() if b)
            shared = be.pager.table[slot, :2].tolist()
            snap = [(c["k_pool"][shared].clone(), c["v_pool"][shared].clone())
                    for c in be.state.caches]
    assert shared is not None and llm.stats.prefix_hits >= 2
    for c, (k, v) in zip(be.state.caches, snap):
        assert torch.equal(c["k_pool"][shared], k)
        assert torch.equal(c["v_pool"][shared], v)


def test_prefix_preempts_on_a_small_pool():
    arch = "qwen3-0.6b"
    _, tcfg, _, _ = _model(arch)
    prompts = _prompts(tcfg, (12, 20, 9, 16, 14, 18), shared=16)
    want = _reference_tokens(arch, prompts, 6)
    be = _backend(arch, (0, 1, 2, 3), n_slots=4, num_blocks=10,
                  prefix_cache=True)
    llm = LLM.from_backend(be, prefill_chunk=8)
    got = llm.generate(prompts, SamplingParams(max_tokens=6))
    assert [o.tokens for o in got] == want
    assert llm.stats.preemptions > 0 and llm.stats.prefix_hits > 0
    assert be.pager.free_blocks == be.pager.total_blocks


def test_spec_prefix_and_chunks_together():
    arch, sizes = "llama2-70b", (0, 1, 2, 3)
    _, tcfg, _, _ = _model(arch)
    prompts = _prompts(tcfg, STREAM_LENS, shared=16)
    want = _reference_tokens(arch, prompts, 8)
    be = _backend(arch, sizes, num_blocks=32, prefix_cache=True)
    oracle = OracleDraft(dict(enumerate(want)), accept_prob=0.75, seed=2,
                         vocab_size=tcfg.vocab_size)
    got, stats = _serve(be, prompts, 8, spec_k=4, draft=oracle,
                        prefill_chunk=4)
    assert got == want
    assert stats.spec_accepted > 0 and stats.prefix_hits >= 2
    assert stats.prefill_chunks > len(prompts)


# --------------------------------------------------------------------------- #
# temperature > 0
# --------------------------------------------------------------------------- #

def test_temperature_is_deterministic_per_seed():
    """Each request samples from its own generator, seeded from (seed,
    uid): the same seed and uids give the same tokens."""
    arch = "qwen3-0.6b"
    _, tcfg, _, _ = _model(arch)
    prompts = _prompts(tcfg, STREAM_LENS, shared=16)
    greedy = _reference_tokens(arch, prompts, 8)

    def hot(seed):
        be = _backend(arch, (3, 3), num_blocks=32, prefix_cache=True)
        return _serve(be, prompts, 8, temperature=1.0, seed=seed,
                      prefill_chunk=4, spec_k=4)[0]

    a, b, c = hot(0), hot(0), hot(1)
    assert a == b
    assert a != c and a != greedy
    assert all(len(t) == 8 and all(0 <= x < tcfg.vocab_size for x in t)
               for t in a)


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #

def _req_lines(out):
    return [line.split(")", 1)[1] for line in out.splitlines()
            if line.startswith("  req ")]


def test_launcher_pipeline_spec_equals_tp(capsys):
    from repro_torch.launch.serve import main
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch",
            "5", "--varlen", "--prompt-len", "12", "--gen", "6", "--impl",
            "cuda", "--cache-layout", "paged", "--block-size", "4",
            "--spec-k", "4"]
    main(argv)
    tp = capsys.readouterr().out
    llm, _ = main(argv + ["--mode", "pipeline", "--stages", "4"])
    pipe = capsys.readouterr().out
    assert "planned stages (periods per stage): (0, 1, 1, 0)" in pipe
    assert "note:" not in pipe and llm.backend.info.spec_decode
    assert _req_lines(pipe) == _req_lines(tp) and len(_req_lines(tp)) == 4
    assert llm.stats.spec_drafted > 0


def test_launcher_pipeline_prefix_chunks_equal_tp(capsys):
    from repro_torch.launch.serve import main
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch",
            "6", "--prompt-len", "28", "--shared-prefix", "20", "--max-len",
            "64", "--block-size", "8", "--kv-blocks", "24",
            "--prefix-cache", "--prefill-chunk", "8", "--gen", "4",
            "--expect-prefix-hits", "--cache-layout"]
    pipeline = ["--mode", "pipeline", "--stages", "4"]
    main(argv + ["paged", "--slots", "2"])
    tp = capsys.readouterr().out
    llm, _ = main(argv + ["paged"] + pipeline)
    pipe = capsys.readouterr().out
    assert "prefix cache: 2 hits (32 prompt tokens reused)" in pipe
    assert _req_lines(pipe) == _req_lines(tp) and len(_req_lines(tp)) == 4
    assert llm.stats.prefill_chunks > 6
    # the contiguous layout: the prefix cache is ignored with a note, and
    # --expect-prefix-hits then exits non-zero
    with pytest.raises(SystemExit, match="no prefix-cache hits"):
        main(argv + ["contiguous"] + pipeline)
    out = capsys.readouterr().out
    assert "note: --prefix-cache has no effect" in out
    assert _req_lines(out) == _req_lines(tp)
