"""Speculative decoding through the port (``ContinuousBatcher(spec_k=4)``
over ``TorchTensorBackend`` on the paged KV cache, on the CPU) against the
JAX package's, mirroring ``tests/test_spec_decode.py``.

Greedy tokens with a corrupted oracle draft must be bit-identical to the
JAX package's and to plain decoding (``spec_k=0``), with rollbacks, with a
pool small enough to preempt and resume, and on a windowed model, where the
backend does not verify and the batcher serves plain decode.  The draft
sources draw from numpy with the same seeds in both packages, so the
drafted and accepted counts must match too.
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import TensorBackend  # noqa: E402
from repro.serving import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving.spec import OracleDraft as JaxOracleDraft  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.runtime import PoolExhausted, TorchTensorBackend  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serving import SamplingParams  # noqa: E402
from repro_torch.serving.spec import OracleDraft  # noqa: E402

torch.set_num_threads(2)

ARCH = "qwen3-0.6b"
GEN = 10


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).reduced(n_layers=2)
    tcfg = get_config(ARCH).reduced(n_layers=2)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _windowed(cfg, window):
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(s, window=window) for s in cfg.pattern))


def _prompts(lens=(5, 9, 7), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 500, k).astype(np.int32) for k in lens]


def _serve_torch(model, prompts, *, layout="paged", impl="cuda", gen=GEN,
                 num_blocks=None, max_len=64, window=None, spec_k=0,
                 draft="ngram"):
    _, tcfg, _, tparams = model
    cfg = tcfg if window is None else _windowed(tcfg, window)
    be = TorchTensorBackend(cfg, tparams, n_slots=3, max_len=max_len,
                            impl=impl, cache_layout=layout, block_size=8,
                            num_blocks=num_blocks, device="cpu")
    b = ContinuousBatcher(be, spec_k=spec_k, draft=draft)
    for uid, p in enumerate(prompts):
        b.submit(Request(p, SamplingParams(max_tokens=gen), uid=uid))
    done = b.run()
    if be.pager is not None:
        assert be.pager.free_blocks == be.pager.total_blocks
    return {u: done[u].generated for u in range(len(prompts))}, b.stats


def _serve_jax(model, prompts, *, layout="paged", gen=GEN, num_blocks=None,
               max_len=64, window=None, spec_k=0, draft="ngram"):
    jcfg, _, jparams, _ = model
    cfg = jcfg if window is None else _windowed(jcfg, window)
    be = TensorBackend(cfg, jparams, n_slots=3, max_len=max_len,
                       impl="pallas", cache_layout=layout, block_size=8,
                       num_blocks=num_blocks)
    b = JaxBatcher(be, spec_k=spec_k, draft=draft)
    for uid, p in enumerate(prompts):
        b.submit(JaxRequest(p, JaxSamplingParams(max_tokens=gen), uid=uid))
    done = b.run()
    return {u: done[u].generated for u in range(len(prompts))}, b.stats


@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_spec_greedy_bitexact_with_corrupted_oracle(model, impl):
    """Oracle drafts at 75% per-token accept probability: every rejection
    rolls back, yet tokens equal plain decode and the JAX package's spec
    run exactly, with the same drafts accepted, in fewer quanta."""
    prompts = _prompts()
    ref, ref_stats = _serve_torch(model, prompts, impl=impl)
    oracle = OracleDraft(dict(ref), accept_prob=0.75, seed=1)
    got, stats = _serve_torch(model, prompts, impl=impl, spec_k=4,
                              draft=oracle)
    jax_oracle = JaxOracleDraft(dict(ref), accept_prob=0.75, seed=1)
    want, jstats = _serve_jax(model, prompts, spec_k=4, draft=jax_oracle)
    assert got == ref == want
    assert stats.spec_drafted > 0 and 0.0 < stats.spec_acceptance < 1.0
    assert stats.decode_steps < ref_stats.decode_steps
    assert (stats.spec_drafted, stats.spec_accepted, stats.decode_steps) \
        == (jstats.spec_drafted, jstats.spec_accepted, jstats.decode_steps)
    assert PA.paged_attention.launches == 0      # CPU: the plain version


def test_spec_rejected_kv_invalidated_under_preempt_resume(model):
    """Corrupted drafts force rollbacks AND an undersized pool forces
    preempt -> recompute-on-resume in the same run.  Exact parity with an
    uninterrupted contiguous run (and the JAX package's spec run) shows
    that no rejected draft's key survives as a valid cache key."""
    prompts = _prompts(lens=(6, 9, 4, 7, 5))
    ref, _ = _serve_torch(model, prompts, layout="contiguous", gen=12,
                          max_len=32)
    jref, _ = _serve_jax(model, prompts, layout="contiguous", gen=12,
                         max_len=32)
    assert ref == jref
    # 3 slots x (32/8)=4 worst-case blocks each; a 7-block pool must
    # overcommit, so verify quanta hit PoolExhausted mid-run
    got, stats = _serve_torch(
        model, prompts, gen=12, num_blocks=7, max_len=32, spec_k=4,
        draft=OracleDraft(dict(ref), accept_prob=0.6, seed=2))
    want, jstats = _serve_jax(
        model, prompts, gen=12, num_blocks=7, max_len=32, spec_k=4,
        draft=JaxOracleDraft(dict(ref), accept_prob=0.6, seed=2))
    assert got == ref == want
    assert stats.preemptions > 0 and stats.resumes > 0
    assert stats.spec_drafted > stats.spec_accepted > 0
    assert (stats.preemptions, stats.resumes, stats.spec_accepted) == \
        (jstats.preemptions, jstats.resumes, jstats.spec_accepted)


def test_spec_on_windowed_backend_warns_and_serves_plain(model):
    """A sliding window shorter than max_len wraps the ring, so rollback
    would not be exact: the paged backend reports spec_decode=False and the
    batcher warns and decodes plain, with the JAX package's tokens."""
    prompts = _prompts()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got, stats = _serve_torch(model, prompts, window=8, spec_k=4)
    assert any("speculative" in str(x.message) for x in w)
    assert stats.spec_drafted == 0 and all(len(t) == GEN
                                           for t in got.values())
    want, _ = _serve_jax(model, prompts, window=8)
    assert got == want


def test_verify_pool_exhausted_before_any_mutation(model):
    """verify_step raises PoolExhausted before touching the pager or the
    caches, so the scheduler can preempt and retry the quantum."""
    _, tcfg, _, tparams = model
    be = TorchTensorBackend(tcfg, tparams, n_slots=2, max_len=32,
                            cache_layout="paged", block_size=8, num_blocks=4,
                            device="cpu")
    be.prefill([0, 1], np.stack(_prompts(lens=(8, 8), seed=3)))
    feeds = {0: np.asarray([1, 2, 3, 4], np.int32),
             1: np.asarray([5, 6, 7, 8], np.int32)}
    for _ in range(2):              # positions 8..15: one more block each
        be.verify_step(feeds)
        be.accept({0: 4, 1: 4})
    assert be.pager.free_blocks == 0
    table, pos = be.pager.table.copy(), be._pos.copy()
    caches = [{k: v.clone() for k, v in c.items()} for c in be.caches]
    with pytest.raises(PoolExhausted):
        be.verify_step(feeds)       # positions 16..19 need two blocks
    np.testing.assert_array_equal(be.pager.table, table)
    np.testing.assert_array_equal(be._pos, pos)
    for c, c0 in zip(be.caches, caches):
        for k in c:
            assert torch.equal(c[k], c0[k]), k
    be.free_slot(1)
    assert len(be.verify_step({0: feeds[0]})) == 1
