"""The hybrid recurrentgemma-2b on the paged layout: the port against the
JAX package, in float32 on the CPU.

The reduced model (one period of rglru, rglru, local attention with a
window of 16, plus a tail of two rglru blocks) serves through ``LLM`` over
``TensorBackend(cache_layout="paged")``: the attention layers page their
keys into block pools, the RG-LRU layers keep dense per-slot state beside
them.  Greedy tokens must be bit-identical to the reference's paged
``TensorBackend(impl="pallas")`` (interpret mode on the CPU) and to the
port's own contiguous serve, with prompts past the window (the ring
wraps), a pool small enough to preempt (the preemption counts equal the
reference's), and slots freed and re-admitted.  Logits are held at 2e-4,
``tests/test_torch_rglru.py``'s tolerance.  The kernels run only on a GPU:
``tests/test_torch_cuda.py``.
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
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import rglru_scan as RS  # noqa: E402
from repro_torch.models import kvcache as TKV  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import TensorBackend  # noqa: E402
from repro_torch.serving import LLM, SamplingParams  # noqa: E402

torch.set_num_threads(2)
ARCH = "recurrentgemma-2b"
TOL = dict(rtol=2e-4, atol=2e-4)
MAX_LEN = 48
GEN = 10


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).reduced(n_layers=5)
    tcfg = get_config(ARCH).reduced(n_layers=5)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


# every case passes the reduced window of 16 (the attention ring wraps at
# prefill or in decode); 5 requests over 3 slots, so slots are freed and
# re-admitted; block_size 4 with 7 blocks cannot hold 3 slots x 4 blocks
CASES = {
    "wrap": dict(lens=(18, 24, 9), n_slots=3, block_size=16,
                 num_blocks=None),
    "readmit": dict(lens=(18, 24, 9, 21, 17), n_slots=3, block_size=16,
                    num_blocks=None),
    "preempt": dict(lens=(18, 24, 9, 21, 17), n_slots=3, block_size=4,
                    num_blocks=7),
}


def _serve_jax(model, case):
    jcfg, _, jparams, _ = model
    be = JaxTensorBackend(jcfg, jparams, n_slots=case["n_slots"],
                          max_len=MAX_LEN, impl="pallas",
                          cache_layout="paged",
                          block_size=case["block_size"],
                          num_blocks=case["num_blocks"])
    llm = JaxLLM.from_backend(be)
    outs = llm.generate(_prompts(jcfg, case["lens"]),
                        JaxSamplingParams(max_tokens=GEN))
    return outs, llm.stats, be.info


def _serve(model, case, impl, layout="paged"):
    _, tcfg, _, tparams = model
    kw = dict(block_size=case["block_size"],
              num_blocks=case["num_blocks"]) if layout == "paged" else {}
    be = TensorBackend(tcfg, tparams, n_slots=case["n_slots"],
                       max_len=MAX_LEN, impl=impl, cache_layout=layout,
                       device="cpu", **kw)
    llm = LLM.from_backend(be)
    outs = llm.generate(_prompts(tcfg, case["lens"]),
                        SamplingParams(max_tokens=GEN))
    return outs, llm.stats, be


@pytest.fixture(scope="module")
def jax_runs(model):
    return {name: _serve_jax(model, case) for name, case in CASES.items()}


@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("name", list(CASES))
def test_paged_greedy_tokens_equal_reference_and_contiguous(
        model, jax_runs, name, impl):
    case = CASES[name]
    want, jstats, _ = jax_runs[name]
    RS.rglru_scan.launches = PA.paged_attention.launches = 0
    got, stats, be = _serve(model, case, impl)
    contiguous, _, _ = _serve(model, case, impl, "contiguous")
    for g, w, c in zip(got, want, contiguous):
        assert g.tokens == w.tokens == c.tokens, (g.uid, g.tokens, w.tokens,
                                                  c.tokens)
        assert g.n_generated == GEN and g.finish_reason == "length"
    assert stats.preemptions == jstats.preemptions
    assert stats.resumes == jstats.resumes
    assert stats.prefills == jstats.prefills
    if name == "preempt":
        assert stats.preemptions > 0 and stats.resumes > 0
    if name != "wrap":
        assert stats.prefills >= 2                  # slots freed, re-admitted
    assert be.info.free_blocks == be.info.total_blocks     # all released
    # on the CPU the wrappers run their plain versions, never the kernels
    assert RS.rglru_scan.launches == PA.paged_attention.launches == 0


def test_backend_info_flags_equal_reference(model, jax_runs):
    """The paged hybrid reports no speculative decoding, no streamed
    admission and no prefix cache, as the reference does; its pool and
    block accounting equal the reference's."""
    _, tcfg, _, tparams = model
    case = CASES["preempt"]
    _, _, jinfo = jax_runs["preempt"]
    be = TensorBackend(tcfg, tparams, n_slots=case["n_slots"],
                       max_len=MAX_LEN, impl="cuda", cache_layout="paged",
                       block_size=case["block_size"],
                       num_blocks=case["num_blocks"], prefix_cache=True,
                       device="cpu")
    got, want = dataclasses.asdict(be.info), dataclasses.asdict(jinfo)
    for key in ("spec_decode", "supports_extend", "prefix_caching",
                "cache_layout", "block_size", "total_blocks",
                "bytes_per_block", "max_ctx_blocks", "n_slots", "max_len"):
        assert got[key] == want[key], key
    assert not got["spec_decode"] and not got["supports_extend"] \
        and not got["prefix_caching"]
    # the pools are the attention layer's only; every RG-LRU layer is dense
    kinds = [s.kind for s in tcfg.layer_specs()]
    assert [("k_pool" in c) for c in be.caches] == [k == "attn"
                                                    for k in kinds]
    assert all(set(c) == {"h", "conv", "pos"}
               for c, k in zip(be.caches, kinds) if k == "rglru")


def test_paged_logits_with_slot_readmitted_mid_serve(model):
    """Backend level: a wave's prefill, decode steps past the window, then
    slot 1 freed and re-admitted with another prompt while slots 0 and 2
    keep decoding; every step's logits against the reference's paged
    backend, and the re-admitted slot's against a fresh backend's."""
    jcfg, tcfg, jparams, tparams = model
    kw = dict(n_slots=3, max_len=MAX_LEN, cache_layout="paged", block_size=4)
    jbe = JaxTensorBackend(jcfg, jparams, impl="pallas", **kw)
    tbe = TensorBackend(tcfg, tparams, impl="cuda", device="cpu", **kw)
    prompts = _prompts(tcfg, (18, 9, 21), seed=2)
    width = max(len(p) for p in prompts)
    padded = np.zeros((3, width), np.int32)
    for i, p in enumerate(prompts):
        padded[i, width - len(p):] = p
    lens = [len(p) for p in prompts]
    for g, w in zip(tbe.prefill([0, 1, 2], padded, lens),
                    jbe.prefill([0, 1, 2], padded, lens)):
        np.testing.assert_allclose(g.logits, w.logits, **TOL)
    rng = np.random.default_rng(3)

    def steps(n, slots):
        for _ in range(n):
            feeds = {s: int(t) for s, t in
                     zip(slots, rng.integers(0, tcfg.vocab_size, len(slots)))}
            got, want = tbe.decode_step(feeds), jbe.decode_step(feeds)
            for g, w in zip(got, want):
                assert g.slot == w.slot
                np.testing.assert_allclose(g.logits, w.logits, **TOL)
    steps(8, [0, 1, 2])
    tbe.free_slot(1)
    jbe.free_slot(1)
    steps(3, [0, 2])                     # slot 1 idle: its state is stale
    new = _prompts(tcfg, (13,), seed=4)[0]
    g, = tbe.prefill([1], new[None], [len(new)])
    w, = jbe.prefill([1], new[None], [len(new)])
    np.testing.assert_allclose(g.logits, w.logits, **TOL)
    fresh = TensorBackend(tcfg, tparams, impl="cuda", device="cpu", **kw)
    f, = fresh.prefill([1], new[None], [len(new)])
    np.testing.assert_array_equal(g.logits, f.logits)
    feeds = [int(t) for t in rng.integers(0, tcfg.vocab_size, 6)]
    for t in feeds:
        g = {e.slot: e.logits for e in tbe.decode_step({0: t, 1: t, 2: t})}
        w = {e.slot: e.logits for e in jbe.decode_step({0: t, 1: t, 2: t})}
        f, = fresh.decode_step({1: t})
        np.testing.assert_array_equal(g[1], f.logits)
        for s in (0, 1, 2):
            np.testing.assert_allclose(g[s], w[s], **TOL)
    steps(4, [0, 1, 2])


def test_dense_state_is_not_paged(model):
    """Only attention layers page: a paged cache for an RG-LRU spec is
    refused, and the paged tree builds the RG-LRU entries dense."""
    _, tcfg, _, _ = model
    with pytest.raises(ValueError, match="only attention layers page"):
        TKV.init_paged_block_cache(tcfg, tcfg.pattern[0], 2, 32, 4)
    caches = TT.init_paged_caches(tcfg, 2, 32, 4, 4, torch.float32, "cpu")
    assert caches[0]["h"].shape == (2, tcfg.rnn_dim)
    assert caches[2]["k_pool"].shape[:2] == (5, 4)


def test_serve_launcher_hybrid_paged_on_cpu(capsys):
    """``--arch recurrentgemma-2b --cache-layout paged`` serves; --spec-k
    and --prefix-cache print the reference's inert notes."""
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--impl", "cuda",
          "--batch", "5", "--slots", "3", "--varlen", "--prompt-len", "24",
          "--gen", "6", "--cache-layout", "paged", "--block-size", "4",
          "--kv-blocks", "7", "--spec-k", "4", "--prefix-cache"])
    out = capsys.readouterr().out
    assert "served 5 requests" in out and "attn_impl=plain" in out
    assert "note: --spec-k has no effect on this deployment: backend " \
        "reports spec_decode=False (cache_layout='paged')" in out
    assert "note: --prefix-cache has no effect on this deployment: backend " \
        "reports prefix_caching=False over cache_layout='paged'" in out
