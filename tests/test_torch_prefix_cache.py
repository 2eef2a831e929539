"""Streamed admission in the port (the prefix cache and chunked prefill)
against the JAX package, in float32 on the CPU with the reference's own
weights.

- The four ``PrefixCache`` scenarios of ``tests/test_prefix_cache.py`` run
  on the port's copy and on the reference's, with the same results.
- ``transformer.extend_step`` (a prompt chunk at its absolute positions
  over paged caches holding the keys before it) against the reference's,
  logits within 1e-5 and the caches equal.
- The mirror of ``test_tensor_prefix_and_chunked_parity``: prefix cache
  alone, chunked prefill alone, both, preempt-and-resume with shared
  prefixes, and the contiguous layout that ignores both.  In every mode the
  port's greedy tokens are bit-identical to the JAX ``TensorBackend``'s and
  to the monolithic serve's, and ``prefix_hits``, ``prefix_hit_tokens`` and
  ``prefill_chunks`` are equal.
- The launcher's streamed flags, and ``reprolint`` clean on the port with
  the backend named ``TensorBackend`` (RL005 checks that name for the full
  protocol).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import TensorBackend as JaxTensorBackend  # noqa: E402
from repro.runtime import base as jax_base  # noqa: E402
from repro.runtime import prefix_cache as jax_prefix  # noqa: E402
from repro.serving import LLM as JaxLLM  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import TensorBackend, TorchTensorBackend  # noqa: E402
from repro_torch.runtime import base as torch_base  # noqa: E402
from repro_torch.runtime import prefix_cache as torch_prefix  # noqa: E402
from repro_torch.serving import LLM, SamplingParams  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-0.6b"
PACKAGES = {"repro": (jax_base, jax_prefix),
            "repro_torch": (torch_base, torch_prefix)}


# --------------------------------------------------------------------------- #
# PrefixCache scenarios, on both copies
# --------------------------------------------------------------------------- #

def _chained_lookup(base, pc_mod):
    al = base.BlockAllocator(8)
    pc = pc_mod.PrefixCache(al, 4)
    toks = np.arange(12, dtype=np.int32)
    blocks = al.alloc(3)
    assert pc.register(toks, blocks) == 3
    other = np.concatenate([toks[4:8], toks[4:8]]).astype(np.int32)
    out = [blocks, pc.lookup(toks), pc.lookup(toks[:8]),
           pc.matched_tokens(toks, cap=8), pc.lookup(other),
           pc.lookup(toks[:10])]
    assert out[1] == blocks and out[2] == blocks[:2] and out[3] == 8
    assert out[4] == [] and out[5] == blocks[:2]
    return out


def _first_writer_wins(base, pc_mod):
    al = base.BlockAllocator(8)
    pc = pc_mod.PrefixCache(al, 4)
    toks = np.arange(8, dtype=np.int32)
    first, dup = al.alloc(2), al.alloc(2)
    out = [pc.register(toks, first), pc.register(toks, dup), pc.lookup(toks)]
    al.free(dup)
    out.append(al.cached_blocks)
    al.free(first)
    out += [al.cached_blocks, pc.lookup(toks)]
    assert out == [2, 0, first, 0, 2, first]
    return out


def _eviction_cascades(base, pc_mod):
    al = base.BlockAllocator(3)
    pc = pc_mod.PrefixCache(al, 4)
    toks = np.arange(12, dtype=np.int32)
    blocks = al.alloc(3)
    pc.register(toks, blocks)
    al.free(blocks)
    (b,) = al.alloc(1)
    out = [b, pc.n_indexed, pc.lookup(toks), al.cached_blocks]
    assert out == [blocks[0], 0, [], 2]
    return out


def _adopt_resurrects(base, pc_mod):
    pager = base.SlotPager(n_slots=2, num_blocks=8, block_size=4,
                           max_ctx_blocks=4)
    pc = pc_mod.PrefixCache(pager.allocator, 4)
    toks = np.arange(10, dtype=np.int32)
    pager.ensure(0, len(toks) - 1)
    held = pager.table[0, :2].tolist()
    pc.register(toks, held)
    pager.release(0)
    out = [pager.allocator.cached_blocks]
    got = pc.lookup(toks[:8])
    pager.adopt(1, got)
    out += [got, pager.allocator.cached_blocks,
            pager.allocator.refcount[held].tolist(), pager.table[1].tolist()]
    assert out[:4] == [2, held, 0, [1, 1]]
    return out


@pytest.mark.parametrize("scenario", [_chained_lookup, _first_writer_wins,
                                      _eviction_cascades, _adopt_resurrects],
                         ids=lambda f: f.__name__.strip("_"))
def test_prefix_cache_scenarios_match_reference(scenario):
    got = {name: scenario(*mods) for name, mods in PACKAGES.items()}
    assert got["repro_torch"] == got["repro"]


# --------------------------------------------------------------------------- #
# extend_step against the reference
# --------------------------------------------------------------------------- #

def _model(n_layers=None):
    jcfg = jax_get_config(ARCH).reduced(n_layers=n_layers) if n_layers \
        else jax_get_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced(n_layers=n_layers) if n_layers \
        else get_config(ARCH).reduced()
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("impl,jimpl", [("ref", "xla"), ("cuda", "pallas")])
def test_extend_step_matches_reference(impl, jimpl):
    """Two chunks over paged caches from empty: slot 0 takes 10 then 12
    tokens (the second chunk crosses a block boundary), slot 1 takes 5 then
    a left-padded 3, slot 2 stays idle (length 0, a no-op).  Logits at the
    fed columns within 1e-5, argmax equal, and key_pos, pos and the pool
    blocks equal after each chunk."""
    jcfg, tcfg, jparams, tparams = _model()
    jc = JT.init_paged_caches(jcfg, 3, 40, 8, 16, jnp.float32)
    tc = TT.init_paged_caches(tcfg, 3, 40, 8, 16, torch.float32, "cpu")
    table = np.asarray([[5, 2, -1], [0, 7, -1], [-1, -1, -1]], np.int32)
    jc["stack"]["p0"]["bt"] = jnp.broadcast_to(
        jnp.asarray(table), jc["stack"]["p0"]["bt"].shape)
    for layer in tc:
        layer["bt"].copy_(torch.from_numpy(table))
    r = np.random.default_rng(4)
    step = jax.jit(lambda p, t, c, st, ln: JT.extend_step(
        jcfg, p, t, c, st, ln, impl=jimpl))
    for starts, lens in (((0, 0, 0), (10, 5, 0)), ((10, 5, 0), (12, 3, 0))):
        tok = r.integers(0, tcfg.vocab_size, (3, 12)).astype(np.int32)
        starts = np.asarray(starts, np.int32)
        lens = np.asarray(lens, np.int32)
        jl, jc = step(jparams, jnp.asarray(tok), jc, jnp.asarray(starts),
                      jnp.asarray(lens))
        with torch.no_grad():
            tl, tc = TT.extend_step(tcfg, tparams,
                                    torch.from_numpy(tok).long(), tc,
                                    torch.from_numpy(starts),
                                    torch.from_numpy(lens), impl=impl)
        fed = np.arange(12)[None] >= (12 - lens)[:, None]
        got, want = tl.numpy()[fed], np.asarray(jl)[fed]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        for i, layer in enumerate(tc):
            jlayer = {k: np.asarray(v[i]) for k, v in jc["stack"]["p0"].items()}
            for k in ("key_pos", "pos", "bt"):
                np.testing.assert_array_equal(layer[k].numpy(), jlayer[k])
            used = table[table >= 0]                  # never the scratch
            for k in ("k_pool", "v_pool"):
                np.testing.assert_allclose(layer[k].numpy()[used],
                                           jlayer[k][used], rtol=1e-5,
                                           atol=1e-5)
    assert tc[0]["pos"].tolist() == [22, 8, 0]


def test_extend_on_a_recurrent_block_raises():
    cfg = get_config("recurrentgemma-2b").reduced()
    spec = next(s for s in cfg.layer_specs() if s.kind == "rglru")
    with pytest.raises(ValueError, match="requires attention caches"):
        TT._apply_block(cfg, spec, {}, torch.zeros((1, 2, cfg.d_model)),
                        torch.zeros((1, 2), dtype=torch.int32), "extend",
                        None, "ref")


# --------------------------------------------------------------------------- #
# served parity in every streamed mode
# --------------------------------------------------------------------------- #

def _shared_prefix_prompts(vocab, seed=0, n_shared=16, tails=(5, 7, 3, 9)):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, n_shared).astype(np.int32)
    return [np.concatenate([shared,
                            rng.integers(0, vocab, n).astype(np.int32)])
            for n in tails]


MODES = {
    "prefix": dict(prefix=True),
    "chunk": dict(chunk=4),
    "composed": dict(prefix=True, chunk=4),
    "preempt": dict(prefix=True, num_blocks=7, n_slots=3),
    "contiguous": dict(prefix=True, chunk=4, layout="contiguous"),
}


@pytest.fixture(scope="module")
def served():
    """The reduced qwen3-0.6b (2 layers) in both packages, the prompts, and
    the reference's monolithic paged serve of them."""
    jcfg, tcfg, jparams, tparams = _model(n_layers=2)
    prompts = _shared_prefix_prompts(tcfg.vocab_size)
    mono = JaxLLM.from_backend(JaxTensorBackend(
        jcfg, jparams, n_slots=2, max_len=64, cache_layout="paged",
        block_size=8, num_blocks=24)).generate(
        prompts, JaxSamplingParams(max_tokens=5))
    return jcfg, tcfg, jparams, tparams, prompts, [o.tokens for o in mono]


def _stats(llm):
    st = llm.stats
    return dict(prefix_hits=st.prefix_hits,
                prefix_hit_tokens=st.prefix_hit_tokens,
                prefill_chunks=st.prefill_chunks,
                preemptions=st.preemptions, resumes=st.resumes)


@pytest.mark.parametrize("mode", list(MODES))
def test_streamed_serve_matches_reference(served, mode):
    jcfg, tcfg, jparams, tparams, prompts, mono = served
    kw = dict(dict(prefix=False, chunk=None, num_blocks=24, n_slots=2,
                   layout="paged"), **MODES[mode])
    common = dict(n_slots=kw["n_slots"], max_len=64,
                  cache_layout=kw["layout"], block_size=8,
                  num_blocks=kw["num_blocks"], prefix_cache=kw["prefix"])
    want = JaxLLM.from_backend(JaxTensorBackend(jcfg, jparams, **common),
                               prefill_chunk=kw["chunk"])
    want_tokens = [o.tokens for o in want.generate(
        prompts, JaxSamplingParams(max_tokens=5))]
    be = TensorBackend(tcfg, tparams, impl="cuda", device="cpu", **common)
    got = LLM.from_backend(be, prefill_chunk=kw["chunk"])
    got_tokens = [o.tokens for o in got.generate(
        prompts, SamplingParams(max_tokens=5))]
    assert got_tokens == want_tokens == mono
    assert _stats(got) == _stats(want)
    assert be.info.prefix_caching == want.backend.info.prefix_caching \
        == (kw["prefix"] and kw["layout"] == "paged")
    st = got.stats
    if kw["prefix"] and kw["layout"] == "paged":
        assert st.prefix_hits >= 2 and st.prefix_hit_tokens >= 2 * 16
    if kw["chunk"] and kw["layout"] == "paged":
        assert st.prefill_chunks > len(prompts)
    if mode == "preempt":
        assert st.preemptions >= 1 and st.resumes >= 1
    if mode == "contiguous":
        assert st.prefix_hits == 0 and st.prefill_chunks == 0


def test_alias_names_the_same_class():
    assert TorchTensorBackend is TensorBackend


# --------------------------------------------------------------------------- #
# the launcher and the protocol lint
# --------------------------------------------------------------------------- #

LAUNCH = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
          "--slots", "2", "--prompt-len", "28", "--shared-prefix", "20",
          "--max-len", "64", "--block-size", "8", "--prefix-cache",
          "--prefill-chunk", "8", "--gen", "4", "--expect-prefix-hits"]


def test_serve_launcher_prefix_cache_and_chunks(capsys):
    """CI's shared-prefix smoke on the port: the paged layout records
    prefix hits and chunk passes."""
    from repro_torch.launch.serve import main
    main(LAUNCH + ["--cache-layout", "paged", "--kv-blocks", "24"])
    out = capsys.readouterr().out
    assert "served 4 requests" in out
    hits = int(out.split("prefix cache: ")[1].split(" hits")[0])
    assert hits >= 1 and "prefill chunk passes" in out


def test_serve_launcher_expect_prefix_hits_fails_without_hits(capsys):
    """On the contiguous layout the flags are ignored (a note says so), the
    serve stays exact, and --expect-prefix-hits exits non-zero."""
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit, match="no prefix-cache hits"):
        main(LAUNCH)
    out = capsys.readouterr().out
    assert "served 4 requests" in out
    assert "note: --prefix-cache has no effect" in out


def test_serve_launcher_shared_prefix_guard(capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as e:
        main(["--arch", ARCH, "--smoke", "--device", "cpu",
              "--prompt-len", "8", "--shared-prefix", "8"])
    assert e.value.code == 2
    assert "must be shorter than every prompt" in capsys.readouterr().err


def test_reprolint_clean_on_the_port():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "reprolint",
                          str(ROOT / "src" / "repro_torch")], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean" in out.stdout + out.stderr


def test_backend_info_matches_reference(served):
    """The streamed gates field for field: paged all-attention advertises
    extend (and the prefix cache when asked), the contiguous layout and a
    windowed model neither."""
    jcfg, tcfg, jparams, tparams, _, _ = served
    window = [dataclasses.replace(c, pattern=tuple(
        dataclasses.replace(s, window=8) for s in c.pattern))
        for c in (jcfg, tcfg)]
    for (jc, tc), layout in (((jcfg, tcfg), "paged"),
                             ((jcfg, tcfg), "contiguous"),
                             (tuple(window), "paged")):
        for prefix in (False, True):
            kw = dict(n_slots=2, max_len=64, cache_layout=layout,
                      block_size=8, prefix_cache=prefix)
            want = JaxTensorBackend(jc, jparams, **kw).info
            got = TensorBackend(tc, tparams, device="cpu", **kw).info
            assert (got.supports_extend, got.prefix_caching) == \
                (want.supports_extend, want.prefix_caching), (layout, prefix)
