"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) and the two
MoE configs (granite-moe-1b-a400m, kimi-k2-1t-a32b) against the JAX
package, in float32 on the CPU with the reference's own weights.

- ``router_topk``: combine weights and the load-balance aux within 1e-5,
  expert ids equal as sets per token, and the reference's "aux near one
  when balanced" case;
- ``moe_ragged`` and ``apply_moe`` (with and without shared experts) within
  1e-5; every call reads the group sizes on the host once;
- the reduced granite-moe and kimi-k2 (``cfg.reduced()``: 4 experts top-2,
  kimi-k2 with its shared expert): train-mode logits within 2e-4 of the
  reference's ``xla`` path, and greedy tokens of the port's
  ``TensorBackend(impl="cuda")`` (the attention kernels' plain versions on
  the CPU) bit-identical to the reference's paged
  ``TensorBackend(impl="pallas")`` on both layouts (its contiguous one
  cannot decode an MoE block: ``ragged_dot`` under ``vmap``), with
  ``BackendInfo`` equal field for field to the reference's of the same
  layout but for ``attn_impl``.

The losses, gradients and AdamW of these models are held in
``tests/test_torch_train.py``, their stage pipeline in
``tests/test_torch_pipeline.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.runtime import TensorBackend as JaxTensorBackend  # noqa: E402
from repro.serving import LLM as JaxLLM  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402
from repro_torch.runtime import TensorBackend  # noqa: E402
from repro_torch.serving import LLM, SamplingParams  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
#: (experts, top-k, shared experts): the reduced configs' and wider ones
MOES = [(4, 2, 0), (4, 2, 1), (32, 8, 0), (16, 3, 1)]
D = 48


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _weights(e, k, shared, seed=0):
    """The reference's init_moe leaves, drawn with its ParamBuilder."""
    from repro.models.layers import ParamBuilder
    moe = JMoEConfig(num_experts=e, top_k=k, d_expert=24,
                     num_shared_experts=shared)
    cfg = dataclasses.replace(jax_get_config("granite-moe-1b-a400m"),
                              d_model=D)
    pb = ParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    JM.init_moe(pb, "ffn", cfg, moe)
    p = jax.tree.map(np.asarray, pb.params["ffn"])
    tmoe = MoEConfig(**dataclasses.asdict(moe))
    return cfg, moe, tmoe, p, {k_: _t(v) for k_, v in p.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("e,k,shared", MOES)
def test_router_topk_matches(e, k, shared):
    _, jmoe, tmoe, jp, tp = _weights(e, k, shared)
    x = _x((40, D))
    jprobs, jids, jaux = JM.router_topk(jp["router"], jnp.asarray(x), jmoe)
    tprobs, tids, taux = TM.router_topk(tp["router"], _t(x), tmoe)
    jids, tids = np.asarray(jids), tids.numpy()
    for row_j, row_t in zip(jids, tids):
        assert set(row_j) == set(row_t)
    # the combine weights, by expert id within each token
    order_j, order_t = np.argsort(jids, -1), np.argsort(tids, -1)
    np.testing.assert_allclose(
        np.take_along_axis(tprobs.numpy(), order_t, -1),
        np.take_along_axis(np.asarray(jprobs), order_j, -1), **TOL)
    np.testing.assert_array_equal(tids[:, 0], jids[:, 0])
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert tprobs.dtype == torch.float32 and taux.dtype == torch.float32


def test_moe_aux_loss_near_one_when_balanced():
    """Uniform routing -> load-balance loss ~= 1 (its minimum), as in
    ``tests/test_models.py``; equal to the reference's."""
    moe = MoEConfig(num_experts=8, top_k=2, d_expert=16)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (128, 32)))
    _, _, aux = TM.router_topk(torch.zeros((32, 8)), _t(x), moe)
    _, _, jaux = JM.router_topk(jnp.zeros((32, 8)), jnp.asarray(x),
                                JMoEConfig(num_experts=8, top_k=2,
                                           d_expert=16))
    assert 0.9 < float(aux) < 1.3
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("e,k,shared", MOES)
def test_moe_ragged_matches(e, k, shared):
    _, jmoe, tmoe, jp, tp = _weights(e, k, shared)
    x = _x((37, D), seed=2)
    jy, jaux = JM.moe_ragged(jp, jmoe, jnp.asarray(x))
    reads = []
    own = TM._group_sizes
    TM._group_sizes = lambda ids, n: reads.append(own(ids, n)) or reads[-1]
    try:
        ty, taux = TM.moe_ragged(tp, tmoe, _t(x))
    finally:
        TM._group_sizes = own
    assert len(reads) == 1 and len(reads[0]) == e
    assert sum(reads[0]) == 37 * k
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


@pytest.mark.parametrize("e,k,shared", MOES)
def test_apply_moe_matches(e, k, shared):
    """[B, S, d] in, with the shared experts where the config has them."""
    cfg, jmoe, tmoe, jp, tp = _weights(e, k, shared)
    x = _x((3, 7, D), seed=3)
    jy, jaux = JM.apply_moe(jp, cfg, jmoe, jnp.asarray(x))
    ty, taux = TM.apply_moe(tp, cfg, tmoe, _t(x))
    assert ty.shape == (3, 7, D)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert ("s_gate" in tp) == bool(shared)


def test_apply_moe_gradients_match():
    """Autograd through the grouped products and both scatters against
    ``jax.grad`` of the reference, the aux term included."""
    cfg, jmoe, tmoe, jp, tp = _weights(8, 3, 1)
    x = _x((2, 9, D), seed=4)

    def jloss(p):
        y, aux = JM.apply_moe(p, cfg, jmoe, jnp.asarray(x))
        return jnp.sum(y * y) + aux

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, jp))
    for t in tp.values():
        t.requires_grad_(True)
    y, aux = TM.apply_moe(tp, cfg, tmoe, _t(x))
    grads = torch.autograd.grad((y * y).sum() + aux, list(tp.values()))
    for (key, _), g in zip(tp.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


# --------------------------------------------------------------------------- #
# the reduced MoE configs
# --------------------------------------------------------------------------- #

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg = jax_get_config(arch).reduced()
        tcfg = get_config(arch).reduced()
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _MODELS[arch] = (jcfg, tcfg, jparams, tparams)
    return _MODELS[arch]


def test_reduced_configs_keep_their_moe():
    for arch in ARCHS:
        _, tcfg, _, tparams = _model(arch)
        moe = tcfg.pattern[0].moe
        assert (moe.num_experts, moe.top_k) == (4, 2)
        assert moe.num_shared_experts == (arch == "kimi-k2-1t-a32b")
        ffn = tparams["layers"][0]["ffn"]
        assert ffn["w_gate"].shape == (4, tcfg.d_model, moe.d_expert)
        assert ffn["w_down"].shape == (4, moe.d_expert, tcfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    tokens = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _, jaux = JT.forward(jcfg, jparams, jnp.asarray(tokens),
                             mode="train")
    with torch.no_grad():
        tl, _ = TT.forward(tcfg, tparams, torch.from_numpy(tokens).long(),
                           mode="train")
        _, taux = TT.forward_hidden(tcfg, tparams,
                                    torch.from_numpy(tokens).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert float(taux) > 0


def _prompts(cfg, lens=(6, 11, 4, 9, 13), seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


_REFERENCE = {}


def _reference_tokens(arch):
    """The reference's greedy tokens, from its paged ``TensorBackend``: its
    contiguous one vmaps the decode step over the slots, and
    ``jax.lax.ragged_dot`` has no batching rule over that axis, so it
    cannot decode an MoE model (greedy tokens do not depend on the layout:
    the port's contiguous serve is held to these, and
    ``tests/test_torch_pipeline.py`` holds both layouts to the reference's
    ``PipelineBackend``)."""
    if arch not in _REFERENCE:
        jcfg, tcfg, jparams, _ = _model(arch)
        jbe = JaxTensorBackend(jcfg, jparams, n_slots=3, max_len=40,
                               impl="pallas", cache_layout="paged",
                               block_size=8)
        _REFERENCE[arch] = [o.tokens for o in JaxLLM.from_backend(
            jbe).generate(_prompts(tcfg), JaxSamplingParams(max_tokens=8))]
    return _REFERENCE[arch]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_reference(arch, layout):
    """More requests than slots (slots recycle), left-padded admission
    waves whose pad rows are routed too (dropless: they change no real
    row), and on the paged layout the kernels' table reads."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    want_info = dataclasses.asdict(JaxTensorBackend(
        jcfg, jparams, n_slots=3, max_len=40, impl="pallas",
        cache_layout=layout, block_size=8).info)
    be = TensorBackend(tcfg, tparams, n_slots=3, max_len=40, impl="cuda",
                       cache_layout=layout, block_size=8,
                       cache_dtype=torch.float32, device="cpu")
    got_info = dataclasses.asdict(be.info)
    assert got_info.pop("attn_impl") == "plain"
    assert want_info.pop("attn_impl") == "pallas"
    assert got_info == want_info
    want = _reference_tokens(arch)
    got = LLM.from_backend(be).generate(_prompts(tcfg),
                                        SamplingParams(max_tokens=8))
    assert [o.tokens for o in got] == want
    assert len({t for ts in want for t in ts}) > 4, "degenerate tokens"


def test_reference_contiguous_backend_cannot_decode_moe():
    """Why the contiguous serve above is held to the reference's paged
    tokens: the reference's vmapped decode raises for an MoE block."""
    jcfg, tcfg, jparams, _ = _model("granite-moe-1b-a400m")
    jbe = JaxTensorBackend(jcfg, jparams, n_slots=2, max_len=40,
                           impl="pallas")
    jbe.prefill([0], _prompts(tcfg, (5,))[0][None])
    with pytest.raises(NotImplementedError, match="ragged_dot"):
        jbe.decode_step({0: 1})
