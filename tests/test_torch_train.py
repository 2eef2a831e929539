"""The port's train mode against the JAX package, in float32 on the CPU with
the reference's own weights: the train-mode forward, the losses and their
gradients, AdamW and its schedule, the data streams, train steps with and
without gradient accumulation, checkpoints across the two packages, and
training end to end.

Models: the reduced llama2-7b (MHA, untied head) and qwen3-0.6b (GQA,
qk-norm, tied embeddings), two layers each, and the reduced
recurrentgemma-2b with five layers (one stacked period of rglru, rglru,
local attention with window 16, and a tail of two rglru blocks).  S = 24
crosses the window.  The mixture-of-experts configs (granite-moe,
kimi-k2) and xlstm-1.3b (8 layers, with its sLSTM block) are held for the
loss with its load-balance term (1e-5), its gradients and one AdamW
update.  Tolerances: 2e-4 (float32 products and sums taken in
another order by another library; the reference's RG-LRU block test's
tolerance), AdamW and its schedule 1e-6, data and checkpoints exact.
``impl="ref"`` is held against the reference's ``"xla"`` path and
``impl="cuda"`` (the flash kernel's plain version on the CPU) against
``"pallas"`` in interpret mode.  Gradients are taken on ``ref``/``xla``, as
both trainers take them: the reference cannot differentiate its Pallas
kernels.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import training as JTR  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import train_loop as JTL  # noqa: E402
from repro_torch import training as TTR  # noqa: E402
from repro_torch.bridge import (init_params, params_from_numpy,  # noqa: E402
                                params_to_numpy, reference_ndim)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import adamw as TA  # noqa: E402
from repro_torch.training import train_loop as TTL  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
ARCHS = {"llama2-7b": 2, "qwen3-0.6b": 2, "recurrentgemma-2b": 5}
IMPLS = [("ref", "xla"), ("cuda", "pallas")]
B, S = 2, 24


def _model(arch):
    n = ARCHS[arch]
    jcfg = jax_get_config(arch).reduced(n_layers=n)
    tcfg = get_config(arch).reduced(n_layers=n)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    return request.param, _model(request.param)


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return tokens, labels


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same_tree(got, want, **tol):
    """Two trees of the reference's layout, leaf by leaf."""
    ga = jax.tree_util.tree_flatten_with_path(got)[0]
    wa = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in ga] == [p for p, _ in wa]
    for (path, g), (_, w) in zip(ga, wa):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), **tol,
                                   err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------------------- #
# the train-mode forward and the losses
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_forward_train(model, impl, jimpl):
    """Logits of ``forward(mode="train")`` over the whole sequence."""
    _, (jcfg, tcfg, jparams, tparams) = model
    tokens, _ = _batch(tcfg)
    jl, jc, _ = JT.forward(jcfg, jparams, jnp.asarray(tokens), mode="train",
                           impl=jimpl)
    with torch.no_grad():
        tl, tc = TT.forward(tcfg, tparams, _t(tokens), mode="train",
                            impl=impl)
    assert jc is None and tc is None
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(_np(tl).argmax(-1),
                                  np.asarray(jl).argmax(-1))


# bfloat16 logits of the port's ref path against the reference's xla path,
# bounded by the reference's own spread (xla against chunked) in the same
# run, as max and mean abs differences.  Measured on the CPU (2 x 128
# tokens): the port's max is 0.96-1.00x the spread's and its mean 1.00x for
# the dense models; the hybrid's mean is 1.86x, because XLA keeps the fused
# RG-LRU GELU branch in float32 where torch rounds its projection to bf16
# first.  Dropping the float32 upcast of the norms gives 1.58-1.67x on the
# dense means and 1.38-1.76x on the maxima; the attention softmax in bf16
# gives 1.22x on the dense means -- each fails the dense models' bounds.
# The dense configs gemma2-2b, starcoder2-7b, qwen1.5-32b and pixtral-12b
# and the MoE configs measured 0.06-1.00x on the maxima and 0.77-1.00x on
# the means.
BF16_MAX_FACTOR = 1.5
BF16_MEAN_FACTOR = {"llama2-7b": 1.15, "qwen3-0.6b": 1.15,
                    "recurrentgemma-2b": 2.25, "gemma2-2b": 1.15,
                    "starcoder2-7b": 1.15, "qwen1.5-32b": 1.15,
                    "pixtral-12b": 1.15, "granite-moe-1b-a400m": 1.15,
                    "kimi-k2-1t-a32b": 1.15, "xlstm-1.3b": 1.15}
#: (layers, (query heads, K/V heads, head_dim) or None) of each config in
#: the bf16 test: the three models above as the file reduces them; the
#: dense configs by hand to 4 layers with their group and head width (as
#: tests/test_torch_configs.py reduces them), the MoE configs with
#: ``cfg.reduced`` to 2 layers (as the mixer tests below)
BF16_ARCHS = {**{arch: (n, None) for arch, n in ARCHS.items()},
              "gemma2-2b": (4, (2, 1, 256)),
              "starcoder2-7b": (4, (9, 1, 128)),
              "qwen1.5-32b": (4, (5, 5, 128)),
              "pixtral-12b": (4, (4, 1, 128)),
              "granite-moe-1b-a400m": (2, None),
              "kimi-k2-1t-a32b": (2, None)}


def _bf16_model(arch, n, heads=None):
    """The reference's and the port's config of ``arch`` reduced to ``n``
    layers (and ``heads``) in bfloat16, and the reference's weights in both
    packages."""
    def cfg(get):
        c = get(arch).reduced(n_layers=n)
        if heads is not None:
            h, kh, d = heads
            c = dataclasses.replace(c, n_heads=h, n_kv_heads=kh, head_dim=d)
        return dataclasses.replace(c, dtype="bfloat16")
    jcfg, tcfg = cfg(jax_get_config), cfg(get_config)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    assert tparams["embedding"].dtype == torch.bfloat16
    return jcfg, tcfg, jparams, tparams


def _port_logits(tcfg, tparams, tokens):
    with torch.no_grad():
        tl, _ = TT.forward(tcfg, tparams, _t(tokens), mode="train",
                           impl="ref")
    assert tl.dtype == torch.bfloat16
    return tl.float().numpy()


def _within(arch, port, spread):
    """``port`` (abs differences) within the factors of ``spread``."""
    assert spread.max() > 0, "the reference's two sides agree bit for bit"
    assert port.max() <= BF16_MAX_FACTOR * spread.max(), \
        (port.max(), spread.max())
    assert port.mean() <= BF16_MEAN_FACTOR[arch] * spread.mean(), \
        (port.mean(), spread.mean())


@pytest.mark.parametrize("arch", list(BF16_ARCHS))
def test_forward_train_bf16_within_reference_spread(arch):
    """The reduced models in bfloat16: train-mode logits of ``impl="ref"``
    against the reference's ``"xla"``, within the reference's own spread
    between ``"xla"`` and ``"chunked"`` (see the factors above)."""
    jcfg, tcfg, jparams, tparams = _bf16_model(arch, *BF16_ARCHS[arch])
    tokens, _ = _batch(tcfg, s=128)
    jl = {impl: np.asarray(JT.forward(jcfg, jparams, jnp.asarray(tokens),
                                      mode="train", impl=impl)[0],
                           np.float32) for impl in ("xla", "chunked")}
    port = np.abs(_port_logits(tcfg, tparams, tokens) - jl["xla"])
    _within(arch, port, np.abs(jl["chunked"] - jl["xla"]))


def test_forward_train_bf16_xlstm_within_reference_bf16_error():
    """xlstm-1.3b has no attention, so the reference's ``"xla"`` and
    ``"chunked"`` paths agree bit for bit and give no spread.  Its bf16
    logits are bounded instead by the reference's own bf16 error: the
    port's bf16 against the reference's float32 forward of the same
    weights, within the factors above of the reference's bf16 against that
    float32 forward (8 layers, the sLSTM block kept; measured on the CPU
    0.96x on the max, 0.97x on the mean)."""
    arch = "xlstm-1.3b"
    jcfg, tcfg, jparams, tparams = _bf16_model(arch, MIXER_ARCHS[arch])
    tokens, _ = _batch(tcfg, s=128)
    j32 = np.asarray(JT.forward(
        dataclasses.replace(jcfg, dtype="float32"),
        jax.tree.map(lambda a: a.astype(jnp.float32), jparams),
        jnp.asarray(tokens), mode="train", impl="xla")[0], np.float32)
    j16 = np.asarray(JT.forward(jcfg, jparams, jnp.asarray(tokens),
                                mode="train", impl="xla")[0], np.float32)
    port = np.abs(_port_logits(tcfg, tparams, tokens) - j32)
    _within(arch, port, np.abs(j16 - j32))


@pytest.mark.parametrize("xent_chunk", [None, 8])
@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_train_loss(model, impl, jimpl, xent_chunk):
    """``train_loss`` (cross entropy with z-loss over all tokens, or chunked
    over the sequence) and its parts, with a mask when unchunked."""
    _, (jcfg, tcfg, jparams, tparams) = model
    tokens, labels = _batch(tcfg, seed=1)
    mask = None if xent_chunk else \
        (np.random.default_rng(2).random((B, S)) < 0.7).astype(np.float32)
    jtot, jparts = JT.train_loss(
        jcfg, jparams, jnp.asarray(tokens), jnp.asarray(labels),
        mask=None if mask is None else jnp.asarray(mask), impl=jimpl,
        xent_chunk=xent_chunk)
    with torch.no_grad():
        ttot, tparts = TT.train_loss(
            tcfg, tparams, _t(tokens), _t(labels),
            mask=None if mask is None else torch.from_numpy(mask), impl=impl,
            xent_chunk=xent_chunk)
    np.testing.assert_allclose(float(ttot), float(jtot), **TOL)
    np.testing.assert_allclose(float(tparts["ce"]), float(jparts["ce"]),
                               **TOL)
    assert float(tparts["aux"]) == float(jparts["aux"]) == 0.0


def test_train_loss_gradients(model):
    """torch autograd of ``train_loss`` against ``jax.grad``, every leaf."""
    _, (jcfg, tcfg, jparams, tparams) = model
    tokens, labels = _batch(tcfg, seed=3)
    jgrads = jax.grad(lambda p: JT.train_loss(
        jcfg, p, jnp.asarray(tokens), jnp.asarray(labels), impl="xla")[0])(
        jparams)
    leaves = TA.tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    total, _ = TT.train_loss(tcfg, tparams, _t(tokens), _t(labels),
                             impl="ref")
    grads = torch.autograd.grad(total, leaves)
    it = iter(grads)
    tgrads = TA.tree_map(lambda _: next(it), tparams)
    _same_tree(params_to_numpy(tcfg, tgrads), jgrads, **TOL)


# --------------------------------------------------------------------------- #
# the MoE and xLSTM configs: the aux term, its gradient, AdamW on expert
# tensors
# --------------------------------------------------------------------------- #

#: reduced with ``cfg.reduced``; xlstm at 8 layers keeps its sLSTM block
MIXER_ARCHS = {"granite-moe-1b-a400m": 2, "kimi-k2-1t-a32b": 2,
               "xlstm-1.3b": 8}
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


def _mixer_model(arch):
    n = MIXER_ARCHS[arch]
    jcfg = jax_get_config(arch).reduced(n_layers=n)
    tcfg = get_config(arch).reduced(n_layers=n)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("arch", list(MIXER_ARCHS))
def test_mixer_train_loss(arch):
    """``train_loss``'s total, ``ce`` and ``aux``: the load-balance term is
    summed over the MoE layers and weighted into the total, and is 0 for
    xLSTM."""
    jcfg, tcfg, jparams, tparams = _mixer_model(arch)
    tokens, labels = _batch(tcfg, seed=5)
    jtot, jparts = JT.train_loss(jcfg, jparams, jnp.asarray(tokens),
                                 jnp.asarray(labels))
    with torch.no_grad():
        ttot, tparts = TT.train_loss(tcfg, tparams, _t(tokens), _t(labels))
    for got, want in ((ttot, jtot), (tparts["ce"], jparts["ce"]),
                      (tparts["aux"], jparts["aux"])):
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    is_moe = tcfg.pattern[0].moe is not None
    assert (float(tparts["aux"]) > 0) == is_moe
    if is_moe:
        w = tcfg.pattern[0].moe.load_balance_weight
        np.testing.assert_allclose(
            float(ttot), float(tparts["ce"]) + w * float(tparts["aux"]),
            rtol=1e-6)


@pytest.mark.parametrize("arch", list(MIXER_ARCHS))
def test_mixer_train_loss_gradients(arch):
    """torch autograd of ``train_loss`` (aux term included) against
    ``jax.grad``, every leaf: the expert tensors, the router, the mLSTM and
    sLSTM weights."""
    jcfg, tcfg, jparams, tparams = _mixer_model(arch)
    tokens, labels = _batch(tcfg, seed=6, s=12)
    jgrads = jax.grad(lambda p: JT.train_loss(
        jcfg, p, jnp.asarray(tokens), jnp.asarray(labels))[0])(jparams)
    leaves = TA.tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    total, _ = TT.train_loss(tcfg, tparams, _t(tokens), _t(labels))
    grads = torch.autograd.grad(total, leaves)
    it = iter(grads)
    _same_tree(params_to_numpy(tcfg, TA.tree_map(lambda _: next(it),
                                                 tparams)), jgrads, **TOL)


@pytest.mark.parametrize("arch", list(MIXER_ARCHS))
def test_mixer_adamw_update_matches(arch):
    """One ``adamw_update`` on the same numpy gradients: the stacked expert
    tensors (rank 4 in the reference's tree) and the sLSTM recurrent
    tensors are decayed as the reference decays them."""
    jcfg, tcfg, jparams, tparams = _mixer_model(arch)
    ndim = reference_ndim(tcfg, tparams)
    if tcfg.pattern[0].moe is not None:
        assert ndim["layers"][0]["ffn"]["w_gate"] == 4
    else:
        assert ndim["layers"][7]["mixer"]["r_i"] == 4
        assert ndim["layers"][0]["mixer"]["b_f"] == 2
    ocfg = dict(lr=1e-2, weight_decay=0.5, warmup_steps=0, total_steps=10)
    rng = np.random.default_rng(7)
    g = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32),
        jax.tree.map(np.asarray, jparams))
    jparams, jopt, _ = JTR.adamw_update(JTR.AdamWConfig(**ocfg), g,
                                        JTR.adamw_init(jparams), jparams)
    tparams, topt, _ = TA.adamw_update(
        TA.AdamWConfig(**ocfg), params_from_numpy(tcfg, g, "cpu"),
        TA.adamw_init(tparams), tparams, ndim)
    _same_tree(params_to_numpy(tcfg, tparams), jparams, **OPT_TOL)
    _same_tree(params_to_numpy(tcfg, topt.nu), jopt.nu, **OPT_TOL)


def test_forward_train_refuses_caches_and_unknown_modes():
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="no caches"):
        TT.forward(tcfg, tparams, tokens,
                   TT.init_caches(tcfg, 1, 4, torch.float32, "cpu"),
                   mode="train")
    with pytest.raises(ValueError, match="no caches"):
        TT.forward(tcfg, tparams, tokens, mode="train",
                   prompt_lens=torch.tensor([4]))
    with pytest.raises(ValueError, match="needs caches"):
        TT.forward(tcfg, tparams, tokens)
    with pytest.raises(ValueError, match="unknown mode"):
        TT.forward(tcfg, tparams, tokens, mode="decode")
    with pytest.raises(ValueError, match="unknown decode impl"):
        TT.forward(tcfg, tparams, tokens, mode="train", impl="pallas")


# --------------------------------------------------------------------------- #
# AdamW, its schedule and the data
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_update_matches(grad_clip):
    """Two ``adamw_update`` calls on the same numpy trees: parameters,
    moments, step, grad norm and learning rate.  recurrentgemma has 1-d
    leaves both in the stack (decayed by the reference, whose stacked leaf
    has rank 2) and in the tail (not decayed)."""
    jcfg, tcfg, jparams, tparams = _model("recurrentgemma-2b")
    ocfg = dict(lr=1e-2, weight_decay=0.5, warmup_steps=2, total_steps=10,
                grad_clip=grad_clip)
    rng = np.random.default_rng(4)
    jopt, topt = JTR.adamw_init(jparams), TA.adamw_init(tparams)
    for _ in range(2):
        g = jax.tree.map(
            lambda p: (3 * rng.standard_normal(p.shape)).astype(np.float32),
            jax.tree.map(np.asarray, jparams))
        jparams, jopt, jm = JTR.adamw_update(JTR.AdamWConfig(**ocfg), g,
                                             jopt, jparams)
        tparams, topt, tm = TA.adamw_update(
            TA.AdamWConfig(**ocfg), params_from_numpy(tcfg, g, "cpu"), topt,
            tparams, reference_ndim(tcfg, tparams))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), **OPT_TOL)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), **OPT_TOL)
    assert topt.step == int(jopt.step) == 2
    _same_tree(params_to_numpy(tcfg, tparams), jparams, **OPT_TOL)
    _same_tree(params_to_numpy(tcfg, topt.mu), jopt.mu, **OPT_TOL)
    _same_tree(params_to_numpy(tcfg, topt.nu), jopt.nu, **OPT_TOL)


def test_adamw_decays_matrices_only():
    params = {"w": torch.ones((4, 4)), "b": torch.ones(4)}
    grads = TA.tree_map(torch.zeros_like, params)
    cfg = TA.AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0)
    params, opt, _ = TA.adamw_update(cfg, grads, TA.adamw_init(params),
                                     params)
    assert float(params["w"][0, 0]) < 1.0
    assert float(params["b"][0]) == 1.0
    assert opt.mu["w"].dtype == torch.float32 and opt.step == 1


def test_adamw_keeps_bf16_params_with_f32_moments():
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    opt = TA.adamw_init(params)
    params, opt, _ = TA.adamw_update(
        TA.AdamWConfig(lr=0.1, warmup_steps=0),
        {"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)}, opt, params)
    assert params["w"].dtype == torch.bfloat16
    assert opt.mu["w"].dtype == opt.nu["w"].dtype == torch.float32
    assert float(params["w"][0, 0]) < 1.0


def test_lr_schedule_matches():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 250):
        want = float(JTR.adamw.lr_schedule(JTR.AdamWConfig(**cfg),
                                           jnp.asarray(step)))
        got = TA.lr_schedule(TA.AdamWConfig(**cfg), step)
        np.testing.assert_allclose(got, want, **OPT_TOL)


def test_synthetic_batches_bit_equal():
    dc = dict(vocab_size=64, seq_len=33, batch=5, seed=7)
    jd = JTR.make_dataset(JTR.DataConfig(**dc))
    td = TTR.make_dataset(TTR.DataConfig(**dc))
    for step in (0, 1, 17):
        for j, t in zip(jd.batch_at(step), td.batch_at(step)):
            assert j.dtype == t.dtype
            np.testing.assert_array_equal(t, j)


def test_byte_corpus_batches_bit_equal(tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(bytes(np.random.default_rng(8).integers(
        0, 256, 5000, dtype=np.uint8)))
    dc = dict(vocab_size=200, seq_len=40, batch=3, corpus_path=str(corpus))
    jd = JTR.make_dataset(JTR.DataConfig(**dc))
    td = TTR.make_dataset(TTR.DataConfig(**dc))
    for step in (0, 3, 90):
        for j, t in zip(jd.batch_at(step), td.batch_at(step)):
            np.testing.assert_array_equal(t, j)


# --------------------------------------------------------------------------- #
# train steps, checkpoints and training end to end
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match(grad_accum):
    """Three steps of ``make_train_step`` from the same weights on the same
    batches: the losses and the parameters after each."""
    jcfg, tcfg, jparams, tparams = _model("qwen3-0.6b")
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(JTL.make_train_step(jcfg, JTL.TrainConfig(
        grad_accum=grad_accum, optimizer=JTR.AdamWConfig(**opt))))
    tstep = TTL.make_train_step(tcfg, TTL.TrainConfig(
        grad_accum=grad_accum, optimizer=TA.AdamWConfig(**opt)))
    jopt, topt = JTR.adamw_init(jparams), TA.adamw_init(tparams)
    data = TTR.make_dataset(TTR.DataConfig(vocab_size=tcfg.vocab_size,
                                           seq_len=16, batch=4))
    for step in range(3):
        tokens, labels = data.batch_at(step)
        jparams, jopt, jm = jstep(jparams, jopt, jnp.asarray(tokens),
                                  jnp.asarray(labels))
        tparams, topt, tm = tstep(tparams, topt, _t(tokens), _t(labels))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TOL)
        _same_tree(params_to_numpy(tcfg, tparams), jparams, **TOL)
    assert topt.step == int(jopt.step) == 3


def test_grad_accum_refuses_a_batch_it_does_not_divide():
    """The reference silently drops the remainder rows when ``grad_accum``
    does not divide the batch (``mb = b // grad_accum``); the port refuses,
    before any parameter or optimizer state changes."""
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    step = TTL.make_train_step(tcfg, TTL.TrainConfig(grad_accum=3))
    opt = TA.adamw_init(tparams)
    before = [p.clone() for p in TA.tree_leaves(tparams)]
    tokens, labels = _batch(tcfg, b=4, s=8)
    with pytest.raises(ValueError, match="does not split into 3"):
        step(tparams, opt, _t(tokens), _t(labels))
    assert opt.step == 0
    assert all(torch.equal(a, b) for a, b in
               zip(before, TA.tree_leaves(tparams)))


def _trained(cfg, params, steps=1):
    """``params`` after ``steps`` AdamW steps on a synthetic batch, and the
    optimizer state (non-zero moments)."""
    step = TTL.make_train_step(cfg, TTL.TrainConfig(
        optimizer=TA.AdamWConfig(lr=1e-3, warmup_steps=1)))
    opt = TA.adamw_init(params)
    tokens, labels = _batch(cfg, seed=9)
    for _ in range(steps):
        params, opt, _ = step(params, opt, _t(tokens), _t(labels))
    return params, opt


@pytest.mark.parametrize("arch", ["llama2-7b", "recurrentgemma-2b"])
def test_checkpoint_from_jax_restores_in_the_port(arch, tmp_path):
    jcfg, tcfg, jparams, _ = _model(arch)
    jopt = JTR.adamw_init(jparams)
    g = jax.tree.map(jnp.ones_like, jparams)
    jparams, jopt, _ = JTR.adamw_update(JTR.AdamWConfig(), g, jopt, jparams)
    fname = JTR.save_checkpoint(str(tmp_path), jparams, jopt, step=5)
    assert TTR.latest_checkpoint(str(tmp_path)) == fname
    template = init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    params, opt, step = TTR.restore_checkpoint(
        fname, tcfg, template, TA.adamw_init(template))
    assert step == 5 and opt.step == int(jopt.step) == 1
    _same_tree(params_to_numpy(tcfg, params), jparams, rtol=0, atol=0)
    _same_tree(params_to_numpy(tcfg, opt.mu), jopt.mu, rtol=0, atol=0)
    _same_tree(params_to_numpy(tcfg, opt.nu), jopt.nu, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b"])
def test_checkpoint_from_the_port_restores_in_jax(arch, tmp_path):
    jcfg, tcfg, jparams, tparams = _model(arch)
    tparams, topt = _trained(tcfg, tparams)
    fname = TTR.save_checkpoint(str(tmp_path), tcfg, tparams, topt, step=7)
    assert JTR.latest_checkpoint(str(tmp_path)) == fname
    params, opt, step = JTR.restore_checkpoint(fname, jparams,
                                               JTR.adamw_init(jparams))
    assert step == 7 and int(opt.step) == topt.step == 1
    _same_tree(params, params_to_numpy(tcfg, tparams), rtol=0, atol=0)
    _same_tree(opt.mu, params_to_numpy(tcfg, topt.mu), rtol=0, atol=0)
    _same_tree(opt.nu, params_to_numpy(tcfg, topt.nu), rtol=0, atol=0)


def test_bf16_checkpoint_round_trip(tmp_path):
    """bfloat16 leaves are written as the reference writes them (raw 2-byte
    values) and restore bit for bit, in the port and from the reference."""
    jcfg, tcfg, jparams, tparams = _model("recurrentgemma-2b")
    tparams = TA.tree_map(lambda t: t.bfloat16(), tparams)
    tparams, topt = _trained(tcfg, tparams)
    fname = TTR.save_checkpoint(str(tmp_path / "port"), tcfg, tparams, topt)
    with np.load(fname) as blobs:
        assert blobs["params/embedding"].dtype == np.dtype("V2")
        assert blobs["opt/.mu/embedding"].dtype == np.float32
    template = TA.tree_map(torch.zeros_like, tparams)
    params, opt, _ = TTR.restore_checkpoint(fname, tcfg, template,
                                            TA.adamw_init(template))
    for a, b in zip(TA.tree_leaves((tparams, topt.mu, topt.nu)),
                    TA.tree_leaves((params, opt.mu, opt.nu))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jbf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    fname = JTR.save_checkpoint(str(tmp_path / "jax"), jbf)
    params, _, _ = TTR.restore_checkpoint(fname, tcfg, template)
    _same_tree(params_to_numpy(tcfg, params), jbf, rtol=0, atol=0)


def test_restore_refuses_a_checkpoint_that_does_not_fit(tmp_path):
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    fname = TTR.save_checkpoint(str(tmp_path), tcfg, tparams)
    other = get_config("llama2-7b").reduced(n_layers=2)
    with pytest.raises((KeyError, ValueError)):
        TTR.restore_checkpoint(fname, other, init_params(
            other, torch.Generator().manual_seed(0), "cpu"))


def test_train_loss_decreases():
    """The counterpart of the reference's
    ``test_training_serving.test_train_loss_decreases``."""
    cfg = get_config("qwen3-0.6b").reduced(n_layers=2)
    tc = TTR.TrainConfig(steps=25, log_every=0,
                         optimizer=TTR.AdamWConfig(lr=1e-3, warmup_steps=5,
                                                   total_steps=25))
    dc = TTR.DataConfig(vocab_size=64, seq_len=32, batch=8)
    m = TTR.train(cfg, tc, dc, device="cpu")
    assert m["final_loss"] < m["first_loss"] * 0.8


def test_train_launcher_runs_and_checkpoints(tmp_path, capsys):
    m = train_launcher.main([
        "--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu",
        "--steps", "3", "--batch", "2", "--seq-len", "24",
        "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    assert np.isfinite([m["first_loss"], m["final_loss"]]).all()
    assert "first loss" in capsys.readouterr().out
    fname = TTR.latest_checkpoint(str(tmp_path))
    assert fname.endswith("ckpt_3.npz")
    cfg = get_config("recurrentgemma-2b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    _, opt, step = TTR.restore_checkpoint(fname, cfg, params,
                                          TA.adamw_init(params))
    assert step == 3 and opt.step == 3
