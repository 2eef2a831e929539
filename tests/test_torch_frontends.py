"""Sinusoidal positions, float (frontend) inputs, the stub frontends and
musicgen-large against the JAX package, on the CPU, with the reference's
own weights:

- ``sinusoidal_embedding`` (1e-6, plus the angle's share of the two
  libraries' float32 ``exp`` at large positions);
- the reduced musicgen-large (sinusoidal positions, layernorm, GELU, an
  untied head): prefill logits (1e-4) and greedy tokens of the port's
  ``TensorBackend`` on both layouts equal the reference's;
- float-input ``forward`` (train and prefill) and ``decode_step`` on the
  same numpy embeddings (1e-4), for musicgen-large and pixtral-12b;
- ``frontend_embedding_spec`` and ``input_spec_for`` (meta tensors)
  against the reference's ``ShapeDtypeStruct``s; ``fake_frontend_
  embeddings`` deterministic per generator seed;
- musicgen-large's planned stage pipeline (``LLM.from_plan``) gives its
  ``TensorBackend``'s tokens on both layouts: stage 0 adds the positions
  at the fed token's position;
- the reference's own fault: its pipeline tick embeds without the
  sinusoidal positions, so its ``PipelineBackend`` and its
  ``TensorBackend`` disagree on musicgen-large.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.devices import tpu_pod_cluster as jax_tpu_pod  # noqa: E402
from repro.core.profile import Workload as JWorkload  # noqa: E402
from repro.models import frontends as JF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import TensorBackend as JaxTensorBackend  # noqa: E402
from repro.serving import LLM as JaxLLM  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.devices import tpu_pod_cluster  # noqa: E402
from repro_torch.core.profile import Workload  # noqa: E402
from repro_torch.models import frontends as TF  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import TensorBackend  # noqa: E402
from repro_torch.serving import LLM, SamplingParams  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
MUSICGEN = "musicgen-large"
LENS = (6, 11, 4, 9, 13)

_MODELS = {}


def _model(arch=MUSICGEN, n_layers=4):
    if (arch, n_layers) not in _MODELS:
        jcfg = jax_get_config(arch).reduced(n_layers=n_layers)
        tcfg = get_config(arch).reduced(n_layers=n_layers)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _MODELS[arch, n_layers] = (jcfg, tcfg, jparams, tparams)
    return _MODELS[arch, n_layers]


def _prompts(vocab, lens=LENS, seed=1):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("dim", [64, 256, 2048])
def test_sinusoidal_embedding_matches_reference(dim):
    """Positions [B, S] and [S] up to 4096 (the score's length), within
    1e-6 plus what the angle ``position * freq`` carries of the two
    libraries' float32 ``exp``: XLA's is a last-place step off the exact
    value at some frequencies (torch's at fewer), which moves the angle by
    up to ``position * 2**-23``; so each element is held at ``1e-6 +
    position * 2**-22``, which is 1e-6 at position 0."""
    pos = np.stack([np.arange(0, 4096, 13), np.arange(316) - 3]) \
        .astype(np.int32)
    want = np.asarray(JL.sinusoidal_embedding(jnp.asarray(pos), dim))
    got = TL.sinusoidal_embedding(torch.from_numpy(pos), dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 316, dim)
    bound = 1e-6 + np.abs(pos)[..., None] * 2.0 ** -22
    assert (np.abs(got.numpy() - want) <= bound).all()
    assert np.abs(got.numpy() - want)[np.abs(pos) <= 3].max() <= 1e-6
    shared = TL.sinusoidal_embedding(torch.from_numpy(pos[0]), dim)
    assert torch.equal(shared, got[0])


def test_musicgen_config_and_params_bridge():
    """The full config equals the reference's (3.23 B parameters), and the
    bridge carries the reduced model's every leaf: the layernorm scales
    and biases, the GELU MLP and the untied head."""
    cfg = get_config(MUSICGEN)
    assert dataclasses.asdict(cfg) == \
        dataclasses.asdict(jax_get_config(MUSICGEN))
    assert cfg.param_count() == jax_get_config(MUSICGEN).param_count()
    assert round(cfg.param_count() / 1e9, 2) == 3.23
    jcfg, tcfg, jparams, tparams = _model()
    assert "lm_head" in tparams and "bias" in tparams["final_norm"]
    layer = tparams["layers"][0]
    assert set(layer) == {"norm1", "mixer", "norm2", "ffn"}
    assert set(layer["norm1"]) == {"scale", "bias"}
    n_port = sum(t.numel() for t in jax.tree.leaves(
        tparams, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert n_port == sum(x.size for x in jax.tree.leaves(jparams))


@pytest.mark.parametrize("window", [None, 8])
def test_musicgen_prefill_logits_match_reference(window):
    """A left-padded prefill wave: logits at real positions (1e-4) and the
    argmax; with a window of 8 the rings are shorter than the wave."""
    jcfg, tcfg, jparams, tparams = _model()
    if window is not None:
        jcfg, tcfg = (dataclasses.replace(c, pattern=tuple(
            dataclasses.replace(s, window=window) for s in c.pattern))
            for c in (jcfg, tcfg))
    r = np.random.default_rng(2)
    s, lens = 12, np.asarray([12, 7, 1], np.int32)
    tokens = r.integers(0, tcfg.vocab_size, (3, s)).astype(np.int32)
    jl, _, _ = JT.forward(jcfg, jparams, jnp.asarray(tokens), mode="prefill",
                          caches=JT.init_caches(jcfg, 3, 16, jnp.float32),
                          prompt_lens=jnp.asarray(lens))
    with torch.no_grad():
        tl, _ = TT.forward(tcfg, tparams, torch.from_numpy(tokens).long(),
                           TT.init_caches(tcfg, 3, 16, torch.float32, "cpu"),
                           prompt_lens=torch.from_numpy(lens))
    real = np.arange(s)[None] >= (s - lens)[:, None]
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], **TOL)
    np.testing.assert_array_equal(tl.numpy()[real].argmax(-1),
                                  np.asarray(jl)[real].argmax(-1))


_REFERENCE_TOKENS = {}


def _reference_tokens(layout):
    if layout not in _REFERENCE_TOKENS:
        jcfg, _, jparams, _ = _model()
        be = JaxTensorBackend(jcfg, jparams, n_slots=3, max_len=40,
                              impl="xla", cache_layout=layout, block_size=8)
        outs = JaxLLM.from_backend(be).generate(
            _prompts(jcfg.vocab_size), JaxSamplingParams(max_tokens=6))
        _REFERENCE_TOKENS[layout] = [o.tokens for o in outs]
    return _REFERENCE_TOKENS[layout]


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_musicgen_tokens_equal_reference(layout, impl):
    """Five requests over three slots, six greedy tokens each: decode
    adds each slot's own position."""
    _, tcfg, _, tparams = _model()
    be = TensorBackend(tcfg, tparams, n_slots=3, max_len=40, impl=impl,
                       cache_layout=layout, block_size=8, device="cpu")
    got = LLM.from_backend(be).generate(_prompts(tcfg.vocab_size),
                                        SamplingParams(max_tokens=6))
    want = _reference_tokens(layout)
    assert [o.tokens for o in got] == want
    assert len({t for ts in want for t in ts}) > 4


def _embeddings(cfg, shape, seed=3):
    r = np.random.default_rng(seed)
    return (r.standard_normal((*shape, cfg.d_model)) /
            np.sqrt(cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", [MUSICGEN, "pixtral-12b"])
def test_float_inputs_forward_and_decode_match_reference(arch):
    """The same numpy embeddings into both packages: the train forward
    over [2, 10, d], a left-padded prefill over [2, 10, d], then three
    decode steps on [2, d] embeddings (1e-4)."""
    jcfg, tcfg, jparams, tparams = _model(arch, n_layers=2)
    emb = _embeddings(tcfg, (2, 10))
    want, _, _ = JT.forward(jcfg, jparams, jnp.asarray(emb), mode="train")
    with torch.no_grad():
        got, _ = TT.forward(tcfg, tparams, torch.from_numpy(emb),
                            mode="train")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    lens = np.asarray([10, 6], np.int32)
    jl, jc, _ = JT.forward(jcfg, jparams, jnp.asarray(emb), mode="prefill",
                           caches=JT.init_caches(jcfg, 2, 16, jnp.float32),
                           prompt_lens=jnp.asarray(lens))
    tc = TT.init_caches(tcfg, 2, 16, torch.float32, "cpu")
    with torch.no_grad():
        tl, tc = TT.forward(tcfg, tparams, torch.from_numpy(emb), tc,
                            prompt_lens=torch.from_numpy(lens))
    real = np.arange(10)[None] >= (10 - lens)[:, None]
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], **TOL)
    for step in range(3):
        x = _embeddings(tcfg, (2,), seed=10 + step)
        jl, jc = JT.decode_step(jcfg, jparams, jnp.asarray(x), jc)
        with torch.no_grad():
            tl, tc = TT.decode_step(tcfg, tparams, torch.from_numpy(x), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                      np.asarray(jl).argmax(-1))


@pytest.mark.parametrize("arch", [MUSICGEN, "pixtral-12b", "llama2-7b"])
def test_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)

    def same(t, j):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)

    for decode in (False, True):
        same(TF.input_spec_for(cfg, 3, 17, decode),
             JF.input_spec_for(jcfg, 3, 17, decode))
    if cfg.frontend is None:
        with pytest.raises(ValueError, match="no frontend"):
            TF.frontend_embedding_spec(cfg, 3, 17)
    else:
        same(TF.frontend_embedding_spec(cfg, 3, 17),
             JF.frontend_embedding_spec(jcfg, 3, 17))


def test_fake_frontend_embeddings_deterministic_per_seed():
    cfg = get_config(MUSICGEN)

    def draw(seed):
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed)
        return TF.fake_frontend_embeddings(cfg, gen, 2, 64, device="cpu")

    a, b, c = draw(0), draw(0), draw(1)
    assert a.dtype == torch.bfloat16 and tuple(a.shape) == (2, 64, 2048)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.float().std()) * np.sqrt(2048) - 1.0) < 0.02
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TF.fake_frontend_embeddings(cfg, torch.Generator(), 1, 4)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_musicgen_pipeline_equals_tensor_backend(layout):
    """``LLM.from_plan`` over four chips (stages of the 4-layer stack):
    the pipeline's tokens are its ``TensorBackend``'s and the reference
    ``TensorBackend``'s, so the tick's stage 0 adds the positions."""
    _, tcfg, _, tparams = _model()
    llm = LLM.from_plan(tcfg, tpu_pod_cluster(n_chips=4),
                        Workload(dtype_bytes=2), objective="throughput",
                        kind="pipeline", params=tparams, max_len=40,
                        cache_layout=layout, block_size=8, impl="cuda",
                        device="cpu")
    assert llm.backend.spec.n_stages > 1
    got = llm.generate(_prompts(tcfg.vocab_size), SamplingParams(max_tokens=6))
    assert [o.tokens for o in got] == _reference_tokens(layout)


def test_reference_pipeline_tick_skips_sinusoidal_positions():
    """The reference's fault, pinned: its pipeline tick embeds with
    ``embed_tokens`` alone (``src/repro/core/pipeline.py:436``), so on
    musicgen-large its ``PipelineBackend`` (one planned stage, which one
    CPU device holds) decodes without positions and leaves its own
    ``TensorBackend``'s tokens, which the port's pipeline keeps.  On a
    rope model the same two agree."""
    outs = {}
    for arch in (MUSICGEN, "qwen3-0.6b"):
        jcfg, _, jparams, _ = _model(arch, n_layers=2)
        prompts = _prompts(jcfg.vocab_size, LENS[:4])
        llm = JaxLLM.from_plan(jcfg, jax_tpu_pod(n_chips=1),
                               JWorkload(dtype_bytes=2),
                               objective="throughput", kind="pipeline",
                               params=jparams, max_len=40, impl="xla")
        pipe = [o.tokens for o in llm.generate(
            prompts, JaxSamplingParams(max_tokens=6))]
        be = JaxTensorBackend(jcfg, jparams, n_slots=2, max_len=40,
                              impl="xla")
        tensor = [o.tokens for o in JaxLLM.from_backend(be).generate(
            prompts, JaxSamplingParams(max_tokens=6))]
        outs[arch] = (pipe, tensor)
    pipe, tensor = outs[MUSICGEN]
    assert pipe != tensor
    assert outs["qwen3-0.6b"][0] == outs["qwen3-0.6b"][1]
    _, tcfg, _, tparams = _model(MUSICGEN, n_layers=2)
    llm = LLM.from_plan(tcfg, tpu_pod_cluster(n_chips=1),
                        Workload(dtype_bytes=2), objective="throughput",
                        kind="pipeline", params=tparams, max_len=40,
                        impl="ref", device="cpu")
    got = llm.generate(_prompts(tcfg.vocab_size, LENS[:4]),
                       SamplingParams(max_tokens=6))
    assert [o.tokens for o in got] == tensor


@pytest.mark.parametrize("mode", [[], ["--mode", "pipeline", "--stages", "4"]])
def test_serve_launcher_musicgen(capsys, mode):
    from repro_torch.launch.serve import main
    argv = ["--arch", MUSICGEN, "--smoke", "--device", "cpu", "--batch",
            "5", "--varlen", "--prompt-len", "12", "--gen", "6", "--impl",
            "cuda"]

    def tokens(out):
        return [line.split(")", 1)[1] for line in out.splitlines()
                if line.startswith("  req ")]

    main(argv)
    tp = capsys.readouterr().out
    main(argv + mode + ["--cache-layout", "paged", "--block-size", "8"])
    out = capsys.readouterr().out
    assert "served 5 requests" in out
    assert tokens(out) == tokens(tp) and len(tokens(tp)) == 4
