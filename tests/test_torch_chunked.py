"""The port's ``"chunked"`` attention (the online softmax over key blocks)
against the JAX package, on the CPU, with the reference's own weights:

- ``_sdpa_chunked`` against the reference's at the four window and
  softcap cases of its own test (2e-5), and with per-row positions whose
  leading block is all pads (the explicit zero under a fully masked
  block);
- ``forward(mode="train", impl="chunked")`` against the reference's at the
  reduced gemma2-2b (3e-4, the reference's tolerance);
- ``prefill_cache`` (left-padded prefill) and ``extend_cache`` (streamed
  chunks) under ``"chunked"``: logits and caches;
- decode under ``"chunked"`` is the ``"ref"`` sdpa, bit for bit, as the
  reference's alias is;
- greedy tokens of ``TensorBackend(impl="chunked")`` equal the
  reference's on both layouts, and the launcher's ``--impl chunked``;
- a key count that is no multiple of the block raises, as the reference
  asserts.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import TensorBackend as JaxTensorBackend  # noqa: E402
from repro.serving import LLM as JaxLLM  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import TensorBackend  # noqa: E402
from repro_torch.serving import LLM, SamplingParams  # noqa: E402

torch.set_num_threads(2)
#: the reference's test_chunked_attention_matches_sdpa
SDPA_TOL = dict(rtol=2e-5, atol=2e-5)
#: the reference's test_forward_chunked_impl_matches_xla
FORWARD_TOL = dict(rtol=3e-4, atol=3e-4)
#: tests/test_torch_model.py's logits tolerance
TOL = dict(rtol=1e-4, atol=1e-4)

_MODELS = {}


def _model(arch, n_layers=2):
    if (arch, n_layers) not in _MODELS:
        jcfg = jax_get_config(arch).reduced(n_layers=n_layers)
        tcfg = get_config(arch).reduced(n_layers=n_layers)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _MODELS[arch, n_layers] = (jcfg, tcfg, jparams, tparams)
    return _MODELS[arch, n_layers]


def _qkv(cfg, b=2, s=64, seed=0):
    r = np.random.default_rng(seed)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return [r.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]


@pytest.mark.parametrize("window,softcap", [(None, None), (16, None),
                                            (None, 30.0), (16, 30.0)])
def test_sdpa_chunked_matches_reference(window, softcap):
    """Blocks of 16 over 64 keys, shared positions: the port's online
    softmax against the reference's, and against the port's dense sdpa."""
    jcfg, tcfg, _, _ = _model("qwen3-0.6b")
    jcfg, tcfg = (dataclasses.replace(c, attn_logit_softcap=softcap)
                  for c in (jcfg, tcfg))
    jspec, tspec = (dataclasses.replace(c.pattern[0], window=window)
                    for c in (jcfg, tcfg))
    q, k, v = _qkv(tcfg)
    pos = np.arange(64, dtype=np.int32)
    want = JA._sdpa_chunked(jcfg, jspec, *map(jnp.asarray, (q, k, v)),
                            jnp.asarray(pos), jnp.asarray(pos), block=16)
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, pos))
    got = TA._sdpa_chunked(tcfg, tspec, tq, tk, tv, tp, tp, block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SDPA_TOL)
    np.testing.assert_allclose(
        got.numpy(), TA._sdpa(tcfg, tspec, tq, tk, tv, tp, tp).numpy(),
        **SDPA_TOL)


def test_sdpa_chunked_fully_masked_block():
    """Per-row positions with left pads (row 1's first 20 keys, so its
    first block of 16 is all pads): real queries match the reference's
    chunked and the port's dense sdpa; no NaN anywhere."""
    jcfg, tcfg, _, _ = _model("qwen3-0.6b")
    spec = tcfg.pattern[0]
    q, k, v = _qkv(tcfg, s=48, seed=1)
    pos = np.stack([np.arange(48), np.arange(48) - 20]).astype(np.int32)
    valid = pos >= 0
    want = JA._sdpa_chunked(jcfg, jcfg.pattern[0],
                            *map(jnp.asarray, (q, k, v, pos, pos)),
                            k_valid=jnp.asarray(valid), block=16)
    tq, tk, tv, tp, tv_ = map(torch.from_numpy, (q, k, v, pos, valid))
    got = TA._sdpa_chunked(tcfg, spec, tq, tk, tv, tp, tp, k_valid=tv_,
                           block=16)
    dense = TA._sdpa(tcfg, spec, tq, tk, tv, tp, tp, k_valid=tv_)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               **SDPA_TOL)
    np.testing.assert_allclose(got.numpy()[valid], dense.numpy()[valid],
                               **SDPA_TOL)


def test_sdpa_chunked_keys_no_multiple_of_block_raise():
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    q, k, v = map(torch.from_numpy, _qkv(tcfg, s=48))
    pos = torch.arange(48)
    with pytest.raises(ValueError, match="no multiple"):
        TA._sdpa_chunked(tcfg, tcfg.pattern[0], q, k, v, pos, pos, block=32)
    # the default block of 1024: 1030 keys are one block and 6 keys
    tokens = torch.zeros((1, 1030), dtype=torch.long)
    with pytest.raises(ValueError, match="no multiple"), torch.no_grad():
        TT.forward(tcfg, tparams, tokens, mode="train", impl="chunked")


def test_forward_chunked_matches_reference():
    """The reduced gemma2-2b (a local window, softcaps) over 2 x 32
    tokens: the port's chunked forward against the reference's (one block
    of 32 keys)."""
    jcfg, tcfg, jparams, tparams = _model("gemma2-2b")
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    want, _, _ = JT.forward(jcfg, jparams, jnp.asarray(tokens), mode="train",
                            impl="chunked")
    with torch.no_grad():
        got, _ = TT.forward(tcfg, tparams, torch.from_numpy(tokens).long(),
                            mode="train", impl="chunked")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORWARD_TOL)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b"])
def test_prefill_cache_chunked_matches_reference(arch):
    """A left-padded prefill wave under ``"chunked"``: logits at real
    positions and the filled rings match the reference's."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    r = np.random.default_rng(2)
    s, lens = 12, np.asarray([12, 7, 1], np.int32)
    tokens = r.integers(0, tcfg.vocab_size, (3, s)).astype(np.int32)
    jl, jc, _ = JT.forward(jcfg, jparams, jnp.asarray(tokens), mode="prefill",
                           caches=JT.init_caches(jcfg, 3, 16, jnp.float32),
                           prompt_lens=jnp.asarray(lens), impl="chunked")
    with torch.no_grad():
        tl, tc = TT.forward(tcfg, tparams, torch.from_numpy(tokens).long(),
                            TT.init_caches(tcfg, 3, 16, torch.float32, "cpu"),
                            prompt_lens=torch.from_numpy(lens),
                            impl="chunked")
    real = np.arange(s)[None] >= (s - lens)[:, None]
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], **TOL)
    np.testing.assert_array_equal(tl.numpy()[real].argmax(-1),
                                  np.asarray(jl)[real].argmax(-1))
    for i, layer in enumerate(tc):
        r_, p = divmod(i, tcfg.period)
        want = {k: np.asarray(v[r_]) for k, v in jc["stack"][f"p{p}"].items()}
        np.testing.assert_array_equal(layer["key_pos"].numpy(),
                                      want["key_pos"])
        live = want["key_pos"] >= 0
        for k in ("k", "v"):
            np.testing.assert_allclose(layer[k].numpy()[live],
                                       want[k][live], **TOL)


def test_extend_cache_chunked_matches_reference():
    """Two streamed chunks over paged caches from empty (slot 0: 10 then
    12 tokens, slot 1: 5 then a left-padded 3, slot 2 idle) under
    ``"chunked"``: logits at the fed columns and the pool blocks."""
    jcfg, tcfg, jparams, tparams = _model("qwen3-0.6b")
    jc = JT.init_paged_caches(jcfg, 3, 40, 8, 16, jnp.float32)
    tc = TT.init_paged_caches(tcfg, 3, 40, 8, 16, torch.float32, "cpu")
    table = np.asarray([[5, 2, -1], [0, 7, -1], [-1, -1, -1]], np.int32)
    jc["stack"]["p0"]["bt"] = jnp.broadcast_to(
        jnp.asarray(table), jc["stack"]["p0"]["bt"].shape)
    for layer in tc:
        layer["bt"].copy_(torch.from_numpy(table))
    r = np.random.default_rng(4)
    for starts, lens in (((0, 0, 0), (10, 5, 0)), ((10, 5, 0), (12, 3, 0))):
        tok = r.integers(0, tcfg.vocab_size, (3, 12)).astype(np.int32)
        starts, lens = (np.asarray(a, np.int32) for a in (starts, lens))
        jl, jc = JT.extend_step(jcfg, jparams, jnp.asarray(tok), jc,
                                jnp.asarray(starts), jnp.asarray(lens),
                                impl="chunked")
        with torch.no_grad():
            tl, tc = TT.extend_step(tcfg, tparams,
                                    torch.from_numpy(tok).long(), tc,
                                    torch.from_numpy(starts),
                                    torch.from_numpy(lens), impl="chunked")
        fed = np.arange(12)[None] >= (12 - lens)[:, None]
        np.testing.assert_allclose(tl.numpy()[fed], np.asarray(jl)[fed],
                                   rtol=1e-5, atol=1e-5)
        used = table[table >= 0]
        for i, layer in enumerate(tc):
            want = {k: np.asarray(v[i]) for k, v in jc["stack"]["p0"].items()}
            for k in ("key_pos", "pos", "bt"):
                np.testing.assert_array_equal(layer[k].numpy(), want[k])
            for k in ("k_pool", "v_pool"):
                np.testing.assert_allclose(layer[k].numpy()[used],
                                           want[k][used], rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_under_chunked_is_the_ref_sdpa(layout):
    """One-token decode runs the dense sdpa under ``"chunked"``, as the
    reference's alias does: logits bit for bit ``"ref"``'s."""
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 6))).long()
    out = {}
    for impl in ("ref", "chunked"):
        if layout == "paged":
            caches = TT.init_paged_caches(tcfg, 2, 32, 4, 8, torch.float32,
                                          "cpu")
            for c in caches:
                c["bt"].copy_(torch.tensor([[0, 1, -1, -1], [2, 3, -1, -1]]))
        else:
            caches = TT.init_caches(tcfg, 2, 32, torch.float32, "cpu")
        rows = []
        with torch.no_grad():
            for t in range(6):
                logits, caches = TT.decode_step(tcfg, tparams, tokens[:, t],
                                                caches, impl=impl)
                rows.append(logits)
        out[impl] = torch.stack(rows)
    assert torch.equal(out["chunked"], out["ref"])


LENS = (6, 11, 4, 9, 13)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_backend_chunked_tokens_equal_reference(layout):
    """Five requests over three slots, six greedy tokens each, with
    ``impl="chunked"`` in both packages; ``attn_impl`` says so."""
    jcfg, tcfg, jparams, tparams = _model("qwen3-0.6b")
    r = np.random.default_rng(1)
    prompts = [r.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    jbe = JaxTensorBackend(jcfg, jparams, n_slots=3, max_len=40,
                           impl="chunked", cache_layout=layout, block_size=8)
    want = [o.tokens for o in JaxLLM.from_backend(jbe).generate(
        prompts, JaxSamplingParams(max_tokens=6))]
    be = TensorBackend(tcfg, tparams, n_slots=3, max_len=40, impl="chunked",
                       cache_layout=layout, block_size=8, device="cpu")
    assert be.info.attn_impl == jbe.info.attn_impl == "chunked"
    got = LLM.from_backend(be).generate(prompts, SamplingParams(max_tokens=6))
    assert [o.tokens for o in got] == want


def test_serve_launcher_impl_chunked(capsys):
    from repro_torch.launch.serve import main
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch",
            "5", "--slots", "3", "--varlen", "--prompt-len", "12", "--gen",
            "6"]

    def tokens(out):
        return [line.split(")", 1)[1] for line in out.splitlines()
                if line.startswith("  req ")]

    main(argv + ["--impl", "chunked"])
    chunked = capsys.readouterr().out
    assert "attn_impl=chunked" in chunked and "served 5 requests" in chunked
    main(argv + ["--impl", "ref"])
    assert tokens(chunked) == tokens(capsys.readouterr().out)
