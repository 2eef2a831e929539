"""The port's layers and weight bridge against the JAX package (CPU, float32).

Inputs come from numpy with a seed and go through both sides; each function
of ``repro_torch.models.layers`` must match its JAX twin at 1e-6.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    r = _rng(1)
    x = r.standard_normal((2, 5, 32)).astype(np.float32)
    p = {"scale": r.standard_normal(32).astype(np.float32),
         "bias": r.standard_normal(32).astype(np.float32)}
    got = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), kind)
    _close(got, JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), kind))


def test_rms_norm_headwise_and_softcap():
    r = _rng(2)
    x = r.standard_normal((2, 3, 4, 16)).astype(np.float32)
    s = r.standard_normal(16).astype(np.float32)
    _close(TL.rms_norm_headwise(torch.from_numpy(s), torch.from_numpy(x)),
           JL.rms_norm_headwise(jnp.asarray(s), jnp.asarray(x)))
    y = 40 * x
    _close(TL.softcap(torch.from_numpy(y), 30.0),
           JL.softcap(jnp.asarray(y), 30.0), rtol=1e-6, atol=1e-5)
    _close(TL.softcap(torch.from_numpy(y), None), y)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope(per_row):
    r = _rng(3)
    x = r.standard_normal((2, 6, 4, 32)).astype(np.float32)
    if per_row:       # masked prefill: per-row positions, negative at pads
        pos = np.stack([np.arange(6) - 2, np.arange(6) + 100]).astype(np.int32)
    else:
        pos = np.arange(6, dtype=np.int32) + 7
    _close(TL.rope_freqs(32, 10_000.0), JL.rope_freqs(32, 10_000.0))
    # angles reach ~1e2 rad, where float32 cos/sin differ between libraries
    # in the last bits
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4),
           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "none"])
def test_apply_mlp(kind):
    r = _rng(4)
    x = r.standard_normal((2, 3, 16)).astype(np.float32)
    p = {"w_up": r.standard_normal((16, 24)).astype(np.float32) / 4,
         "w_gate": r.standard_normal((16, 24)).astype(np.float32) / 4,
         "w_down": r.standard_normal((24, 16)).astype(np.float32) / 5}
    got = TL.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), kind)
    _close(got, JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), kind), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-0.6b"])
def test_embed_and_logits(arch):
    """Untied (llama2) and tied (qwen3) heads."""
    cfg = get_config(arch).reduced()
    r = _rng(5)
    p = {"embedding": r.standard_normal((cfg.vocab_size, cfg.d_model))
         .astype(np.float32)}
    if not cfg.tie_embeddings:
        p["lm_head"] = r.standard_normal((cfg.d_model, cfg.vocab_size)) \
            .astype(np.float32)
    tok = r.integers(0, cfg.vocab_size, (2, 7))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jcfg = jax_get_config(arch).reduced()
    x = TL.embed_tokens(tp, cfg, torch.from_numpy(tok))
    _close(x, JL.embed_tokens(jp, jcfg, jnp.asarray(tok)))
    _close(TL.lm_logits(tp, cfg, x),
           JL.lm_logits(jp, jcfg, jnp.asarray(x.numpy())),
           rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-0.6b"])
def test_bridge_unstacks_reference_params(arch):
    """params_from_numpy puts layer i of the stacked tree at layers[i], and
    init_params makes the same tree with the same shapes and scales."""
    cfg = get_config(arch).reduced(n_layers=3)
    jparams, _ = JT.init_params(jax_get_config(arch).reduced(n_layers=3),
                                jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, jparams)
    tp = bridge.params_from_numpy(cfg, npp, device="cpu")
    assert len(tp["layers"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(tp["layers"][i]["mixer"]["wq"].numpy(),
                                      npp["stack"]["p0"]["mixer"]["wq"][i])
        np.testing.assert_array_equal(
            tp["layers"][i]["ffn"]["w_down"].numpy(),
            npp["stack"]["p0"]["ffn"]["w_down"][i])
    np.testing.assert_array_equal(tp["embedding"].numpy(), npp["embedding"])

    made = bridge.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)
    assert shapes(made) == shapes(tp)
    # ParamBuilder scales: 1/sqrt(fan_in) normals, d_model**-0.5 embedding,
    # unit norm scales
    wq = made["layers"][0]["mixer"]["wq"]
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1) < 0.1
    assert abs(made["embedding"].std().item() * cfg.d_model ** 0.5 - 1) < 0.1
    assert torch.equal(made["final_norm"]["scale"],
                       torch.ones(cfg.d_model))
    if cfg.qk_norm:
        assert torch.equal(made["layers"][0]["mixer"]["k_norm"],
                           torch.ones(cfg.resolved_head_dim))


def test_bridge_bfloat16_is_exact():
    """bf16 leaves go through float32 on the way: exact."""
    cfg = get_config("qwen3-0.6b").reduced()
    x = np.asarray(jnp.asarray(_rng(6).standard_normal((4, 8)), jnp.bfloat16))
    tree = {"embedding": x, "final_norm": {"scale": x[0]},
            "stack": {"p0": {"w": np.stack([x] * cfg.n_layers)}}}
    tp = bridge.params_from_numpy(cfg, tree, device="cpu")
    assert tp["embedding"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embedding"].float().numpy(),
                                  x.astype(np.float32))
    np.testing.assert_array_equal(tp["layers"][1]["w"].float().numpy(),
                                  x.astype(np.float32))
