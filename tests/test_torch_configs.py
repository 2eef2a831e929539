"""The port's config registry and its dense configs against the JAX package.

- each config of ``repro_torch.configs`` (every one of the reference's but
  musicgen-large, whose audio frontend is not ported) and
  ``shapes.SHAPES`` equal the reference's field for field, pattern
  included; ``apply_variant`` builds the reference's variants and refuses
  unknown ones;
- each new config, reduced by hand so that it keeps its attention group and
  head width (``ModelConfig.reduced`` caps heads at 4 and makes the K/V
  heads equal to them, which would hide every group): prefill logits at
  ``tests/test_torch_model.py``'s 1e-4, and greedy tokens of the port's
  ``TensorBackend(impl="cuda")`` (the kernels' plain versions on the CPU)
  bit-identical to the JAX ``TensorBackend(impl="xla")`` on both layouts,
  with prompts longer than gemma2's local window;
- starcoder2's group of 9 verifies 4 drafts a step on the paged layout:
  36 query rows a K/V head, three row chunks of the paged kernel.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import TensorBackend as JaxTensorBackend  # noqa: E402
from repro.serving import LLM as JaxLLM  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import kvcache as TKV  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import TensorBackend  # noqa: E402
from repro_torch.serving import LLM, SamplingParams  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
NEW = ["gemma2-2b", "starcoder2-7b", "qwen1.5-32b", "pixtral-12b"]
#: the hand reductions: (query heads, K/V heads, head_dim) keep the group
#: and the head width of the full config
GROUPS = {"gemma2-2b": (2, 1, 256), "starcoder2-7b": (9, 1, 128),
          "qwen1.5-32b": (5, 5, 128), "pixtral-12b": (4, 1, 128)}
#: paged kernel rows a block (``kRowsPerBlock``, csrc/paged_attention.cu)
ROWS_PER_BLOCK = 16


@pytest.mark.parametrize("name", sorted(TC.CONFIGS))
def test_config_equals_reference(name):
    assert dataclasses.asdict(TC.get_config(name)) == \
        dataclasses.asdict(JC.get_config(name))


def test_registry_and_shapes_equal_reference():
    assert set(NEW) <= set(TC.CONFIGS) <= set(JC.CONFIGS)
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}
    assert TC.get_shape("decode_32k") == TC.SHAPES["decode_32k"]
    assert TC.SWA_WINDOW == JC.SWA_WINDOW
    assert set(TC.ASSIGNED) == set(JC.ASSIGNED) - {"musicgen-large"}
    assert set(TC.PAPER_MODELS) == set(JC.PAPER_MODELS)
    assert set(TC.CONFIGS) == set(JC.CONFIGS) - {"musicgen-large"}
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("musicgen-large")
    with pytest.raises(KeyError, match="unknown shape"):
        TC.get_shape("train_8k")


@pytest.mark.parametrize("variant", ["swa", "kvint8", "swa+kvint8"])
@pytest.mark.parametrize("name", ["qwen3-0.6b", "gemma2-2b",
                                  "recurrentgemma-2b", "starcoder2-7b",
                                  "granite-moe-1b-a400m", "xlstm-1.3b"])
def test_apply_variant_equals_reference(name, variant):
    got = TC.get_config(name, variant=variant)
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(JC.get_config(name, variant=variant))
    assert got.name == f"{name}+{variant}"


def test_unknown_variant_raises():
    with pytest.raises(KeyError, match="unknown variant"):
        TC.apply_variant(TC.get_config("qwen3-0.6b"), "int4")
    with pytest.raises(KeyError, match="unknown variant"):
        TC.get_config("qwen3-0.6b", variant="int4")


def test_kvint8_cache_raises_for_a_later_slice():
    cfg = TC.get_config("qwen3-0.6b", variant="kvint8").reduced()
    spec = cfg.layer_specs()[0]
    with pytest.raises(ValueError, match="later slice"):
        TKV.init_block_cache(cfg, spec, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="later slice"):
        TKV.init_paged_block_cache(cfg, spec, 1, 16, 4, 4, torch.float32)


# --------------------------------------------------------------------------- #
# the dense configs, reduced by hand
# --------------------------------------------------------------------------- #

def _reduce(cfg, name):
    h, kh, d = GROUPS[name]
    return dataclasses.replace(cfg.reduced(n_layers=4), n_heads=h,
                               n_kv_heads=kh, head_dim=d)


_MODELS = {}


def _model(name):
    if name not in _MODELS:
        jcfg = _reduce(JC.get_config(name), name)
        tcfg = _reduce(TC.get_config(name), name)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _MODELS[name] = (jcfg, tcfg, jparams, tparams)
    return _MODELS[name]


def test_reductions_keep_group_and_features():
    for name in NEW:
        _, cfg, _, _ = _model(name)
        full = TC.get_config(name)
        assert cfg.n_heads // cfg.n_kv_heads == \
            full.n_heads // full.n_kv_heads
        assert cfg.resolved_head_dim == full.resolved_head_dim
        for f in ("norm", "qkv_bias", "post_norm", "attn_logit_softcap",
                  "final_logit_softcap", "tie_embeddings"):
            assert getattr(cfg, f) == getattr(full, f), (name, f)
    gemma = _model("gemma2-2b")[1]
    assert [s.window for s in gemma.layer_specs()] == [16, None] * 2


#: longer than gemma2's reduced window of 16, so its local rings wrap
LENS = (23, 19, 26, 17, 21)


def _prompts(cfg, lens=LENS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("name", NEW)
def test_prefill_logits_match_reference(name):
    jcfg, tcfg, jparams, tparams = _model(name)
    tokens = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    lens = np.asarray([24, 19], np.int32)
    jl, _, _ = JT.forward(jcfg, jparams, jnp.asarray(tokens), mode="prefill",
                          caches=JT.init_caches(jcfg, 2, 32, jnp.float32),
                          prompt_lens=jnp.asarray(lens))
    with torch.no_grad():
        tl, _ = TT.forward(tcfg, tparams, torch.from_numpy(tokens).long(),
                           mode="prefill",
                           caches=TT.init_caches(tcfg, 2, 32, torch.float32,
                                                 "cpu"),
                           prompt_lens=torch.from_numpy(lens))
    jl, tl = np.asarray(jl, np.float32), tl.numpy()
    for b, n in enumerate(lens):
        np.testing.assert_allclose(tl[b, -n:], jl[b, -n:], **TOL)
        np.testing.assert_array_equal(tl[b, -n:].argmax(-1),
                                      jl[b, -n:].argmax(-1))


_REFERENCE = {}


def _reference_tokens(name, layout, max_tokens=8, max_len=40):
    key = (name, layout)
    if key not in _REFERENCE:
        jcfg, _, jparams, _ = _model(name)
        jllm = JaxLLM.from_backend(JaxTensorBackend(
            jcfg, jparams, n_slots=3, max_len=max_len, impl="xla",
            cache_layout=layout, block_size=8))
        _REFERENCE[key] = [o.tokens for o in jllm.generate(
            _prompts(jcfg), JaxSamplingParams(max_tokens=max_tokens))]
    return _REFERENCE[key]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("name", NEW)
def test_greedy_tokens_equal_reference(name, layout):
    _, tcfg, _, tparams = _model(name)
    want = _reference_tokens(name, layout)
    assert len({t for ts in want for t in ts}) > 4, "degenerate reference"
    llm = LLM.from_backend(TensorBackend(
        tcfg, tparams, n_slots=3, max_len=40, impl="cuda",
        cache_layout=layout, block_size=8, device="cpu"))
    got = llm.generate(_prompts(tcfg), SamplingParams(max_tokens=8))
    assert [o.tokens for o in got] == want


def test_starcoder2_spec_verifies_36_rows_in_three_chunks():
    _, tcfg, _, tparams = _model("starcoder2-7b")
    k = 4
    rows = k * tcfg.n_heads // tcfg.n_kv_heads
    assert rows == 36 and -(-rows // ROWS_PER_BLOCK) == 3
    want = _reference_tokens("starcoder2-7b", "paged")
    be = TensorBackend(tcfg, tparams, n_slots=3, max_len=40, impl="cuda",
                       cache_layout="paged", block_size=8, device="cpu")
    assert be.info.spec_decode
    llm = LLM.from_backend(be, spec_k=k)
    got = llm.generate(_prompts(tcfg), SamplingParams(max_tokens=8))
    assert [o.tokens for o in got] == want
    assert llm.stats.spec_drafted > 0


def test_pixtral_serves_token_inputs():
    """Pixtral's decoder takes integer tokens through ``embed_tokens``, as
    the reference's ``_embed_inputs`` does for integer inputs."""
    jcfg, tcfg, jparams, tparams = _model("pixtral-12b")
    assert tcfg.frontend == "vision"
    tokens = np.arange(6, dtype=np.int32)[None]
    jl = JT.forward(jcfg, jparams, jnp.asarray(tokens), mode="train")[0]
    with torch.no_grad():
        tl, _ = TT.forward(tcfg, tparams, torch.from_numpy(tokens).long(),
                           mode="train")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32), **TOL)
    with pytest.raises(ValueError, match="frontends.py"):
        TT.forward(tcfg, tparams, torch.zeros((1, 6, tcfg.d_model)),
                   mode="train")
