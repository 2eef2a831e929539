"""The port's xLSTM blocks (``repro_torch.models.xlstm``) and xlstm-1.3b
against the JAX package, in float32 on the CPU with the reference's own
weights.

- mLSTM: ``apply_mlstm_seq`` with and without ``seq_valid`` within 2e-4 and
  its closed-form hand-off state within 1e-5, ``apply_mlstm_decode`` within
  1e-5, and the port's parallel form equal to its own recurrence within
  2e-4 (the reference's ``test_mlstm_parallel_equals_recurrent``);
- sLSTM: ``apply_slstm_seq`` (with and without ``seq_valid``) and
  ``apply_slstm_decode`` within 1e-5; pad steps leave the state bit for
  bit as it was;
- the caches' entries equal the reference's ``init_block_cache``;
- xlstm-1.3b reduced to 8 layers (seven mLSTM blocks and its sLSTM
  block): prefill and train logits within 2e-4, decode after prefill
  against the longer train forward, and greedy tokens of the port's
  ``TensorBackend`` bit-identical to the reference's on both layouts, with
  ``BackendInfo`` equal field for field (the paged layout's empty pool
  included) but for ``attn_impl``;
- the refusals of a model without attention: extend and verify raise, and
  neither backend advertises streamed admission, the prefix cache or
  speculative verify, as in the reference.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import kvcache as JKV  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.runtime import TensorBackend as JaxTensorBackend  # noqa: E402
from repro.serving import LLM as JaxLLM  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import kvcache as TKV  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.models.config import BlockSpec  # noqa: E402
from repro_torch.runtime import TensorBackend  # noqa: E402
from repro_torch.serving import LLM, SamplingParams  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
SEQ_TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "xlstm-1.3b"
B, S = 2, 10

_MODEL = {}


def _model():
    if not _MODEL:
        jcfg = jax_get_config(ARCH).reduced(n_layers=8)
        tcfg = get_config(ARCH).reduced(n_layers=8)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _MODEL["m"] = (jcfg, tcfg, jparams, tparams)
    return _MODEL["m"]


def _mixer(kind):
    """The first mLSTM (layer 0) or the sLSTM (layer 7) block's mixer."""
    jcfg, tcfg, jparams, tparams = _model()
    p = {"mlstm": 0, "slstm": 7}[kind]
    jp = jax.tree.map(lambda x: np.asarray(x)[0],
                      jparams["stack"][f"p{p}"]["mixer"])
    return jcfg, tcfg, jp, tparams["layers"][p]["mixer"]


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _valid(lens, s=S):
    return np.arange(s)[None] >= (s - np.asarray(lens))[:, None]


def _state(cfg, kind, b=B, warm=None):
    """(reference, port) states, zero or, with ``warm`` (a seed), the state
    the reference's sequence mode hands off after 6 random steps: a state
    the block reaches, with its stabilizer in step with its memory."""
    j = JKV.init_block_cache(cfg, BlockSpec(kind=kind), b, 16, jnp.float32)
    if warm is not None:
        jcfg, _, jp, _ = _mixer(kind)
        seq = {"mlstm": JX.apply_mlstm_seq, "slstm": JX.apply_slstm_seq}[kind]
        _, j = seq(jp, jcfg, jnp.asarray(_x((b, 6, cfg.d_model), warm)), j)
    j = {k: np.asarray(v) for k, v in j.items()}
    return ({k: jnp.asarray(v) for k, v in j.items()},
            {k: torch.from_numpy(v.copy()) for k, v in j.items()})


def _same_state(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **tol)


def test_cache_entries_equal_reference():
    _, cfg, _, _ = _model()
    for kind in ("mlstm", "slstm"):
        want = JKV.init_block_cache(cfg, BlockSpec(kind=kind), 3, 16,
                                    jnp.bfloat16)
        got = TKV.init_block_cache(cfg, BlockSpec(kind=kind), 3, 16,
                                   torch.bfloat16, "cpu")
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, (kind, k)
            assert str(got[k].dtype).split(".")[1] == str(want[k].dtype), \
                (kind, k)
            assert not got[k].any()
    full = get_config(ARCH)
    c = TKV.init_block_cache(full, BlockSpec(kind="mlstm"), 1, 16,
                             device="meta")
    assert tuple(c["C"].shape) == (1, 4, 1024, 1024)


# --------------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("lens", [None, (10, 6)])
def test_mlstm_seq_and_handoff_match(lens):
    jcfg, tcfg, jp, tp = _mixer("mlstm")
    x = _x((B, S, tcfg.d_model))
    valid = None if lens is None else _valid(lens)
    jstate, tstate = _state(tcfg, "mlstm")
    jy, jnew = JX.apply_mlstm_seq(
        jp, jcfg, jnp.asarray(x), jstate,
        seq_valid=None if valid is None else jnp.asarray(valid))
    with torch.no_grad():
        ty, _ = TX.apply_mlstm_seq(
            tp, tcfg, torch.from_numpy(x), tstate,
            seq_valid=None if valid is None else torch.from_numpy(valid))
    rows = np.ones((B, S), bool) if valid is None else valid
    np.testing.assert_allclose(ty.numpy()[rows], np.asarray(jy)[rows],
                               **SEQ_TOL)
    _same_state(tstate, jnew, **TOL)
    assert tstate["pos"].tolist() == ([S, S] if lens is None else list(lens))


def test_mlstm_decode_matches():
    jcfg, tcfg, jp, tp = _mixer("mlstm")
    x = _x((B, 1, tcfg.d_model), seed=2)
    jstate, tstate = _state(tcfg, "mlstm", warm=3)
    jy, jnew = JX.apply_mlstm_decode(jp, jcfg, jnp.asarray(x), jstate)
    with torch.no_grad():
        ty, _ = TX.apply_mlstm_decode(tp, tcfg, torch.from_numpy(x), tstate)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _same_state(tstate, jnew, **TOL)


def test_mlstm_parallel_equals_recurrent():
    """The port's parallel form against its own one-token recurrence, and
    the parallel pass's closed-form hand-off state against the state the
    recurrence ends in."""
    _, tcfg, _, tp = _mixer("mlstm")
    x = torch.from_numpy(_x((B, S, tcfg.d_model), seed=4))
    with torch.no_grad():
        y_par, _ = TX.apply_mlstm_seq(tp, tcfg, x)
        _, state = _state(tcfg, "mlstm")
        outs = []
        for t in range(S):
            y_t, _ = TX.apply_mlstm_decode(tp, tcfg, x[:, t:t + 1], state)
            outs.append(y_t[:, 0])
        np.testing.assert_allclose(y_par.numpy(),
                                   torch.stack(outs, 1).numpy(), **SEQ_TOL)
        _, handoff = _state(tcfg, "mlstm")
        TX.apply_mlstm_seq(tp, tcfg, x, handoff)
        _same_state(handoff, state, **SEQ_TOL)


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("lens", [None, (10, 6)])
def test_slstm_seq_matches(lens):
    jcfg, tcfg, jp, tp = _mixer("slstm")
    x = _x((B, S, tcfg.d_model), seed=5)
    valid = None if lens is None else _valid(lens)
    jstate, tstate = _state(tcfg, "slstm", warm=6)
    jy, jnew = JX.apply_slstm_seq(
        jp, jcfg, jnp.asarray(x), jstate,
        seq_valid=None if valid is None else jnp.asarray(valid))
    with torch.no_grad():
        ty, _ = TX.apply_slstm_seq(
            tp, tcfg, torch.from_numpy(x), tstate,
            seq_valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _same_state(tstate, jnew, **TOL)


def test_slstm_decode_matches():
    jcfg, tcfg, jp, tp = _mixer("slstm")
    x = _x((B, 1, tcfg.d_model), seed=7)
    jstate, tstate = _state(tcfg, "slstm", warm=8)
    jy, jnew = JX.apply_slstm_decode(jp, jcfg, jnp.asarray(x), jstate)
    with torch.no_grad():
        ty, _ = TX.apply_slstm_decode(tp, tcfg, torch.from_numpy(x), tstate)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _same_state(tstate, jnew, **TOL)


def test_slstm_pad_steps_keep_the_state_bit_for_bit():
    """Pad steps carry ``(c, n, h, m)`` through unchanged: a state run over
    pads only comes back bit for bit, and a row's left pads leave its
    zero state exactly zero until its first real token."""
    _, tcfg, _, tp = _mixer("slstm")
    _, state = _state(tcfg, "slstm", warm=9)
    before = {k: v.clone() for k, v in state.items()}
    x = torch.from_numpy(_x((B, 4, tcfg.d_model), seed=10))
    with torch.no_grad():
        TX.apply_slstm_seq(tp, tcfg, x, state,
                           seq_valid=torch.zeros((B, 4), dtype=torch.bool))
        for k in ("c", "n", "h", "m"):
            assert torch.equal(state[k], before[k]), k
        assert torch.equal(state["pos"], before["pos"])
        _, zero = _state(tcfg, "slstm")
        valid = torch.from_numpy(_valid((4, 0), s=4))
        TX.apply_slstm_seq(tp, tcfg, x, zero, seq_valid=valid)
        for k in ("c", "n", "h", "m"):
            assert not zero[k][1].any() and zero[k][0].any(), k
        assert zero["pos"].tolist() == [4, 0]


# --------------------------------------------------------------------------- #
# xlstm-1.3b reduced to 8 layers
# --------------------------------------------------------------------------- #

def test_reduced_model_keeps_its_slstm_block():
    _, tcfg, _, tparams = _model()
    assert [s.kind for s in tcfg.layer_specs()] == ["mlstm"] * 7 + ["slstm"]
    assert TKV.max_ctx_blocks(tcfg, 64) == 0
    r = tparams["layers"][7]["mixer"]["r_i"]
    assert tuple(r.shape) == (tcfg.n_heads, tcfg.d_model // tcfg.n_heads,
                              tcfg.d_model // tcfg.n_heads)


def test_prefill_and_train_logits_match_reference():
    jcfg, tcfg, jparams, tparams = _model()
    tokens = np.random.default_rng(11).integers(
        0, tcfg.vocab_size, (B, 12)).astype(np.int32)
    lens = np.asarray([12, 7], np.int32)
    jl, _, _ = JT.forward(jcfg, jparams, jnp.asarray(tokens), mode="prefill",
                          caches=JT.init_caches(jcfg, B, 32, jnp.float32),
                          prompt_lens=jnp.asarray(lens))
    jt, _, _ = JT.forward(jcfg, jparams, jnp.asarray(tokens), mode="train")
    with torch.no_grad():
        tl, _ = TT.forward(tcfg, tparams, torch.from_numpy(tokens).long(),
                           TT.init_caches(tcfg, B, 32, torch.float32, "cpu"),
                           prompt_lens=torch.from_numpy(lens))
        tt, _ = TT.forward(tcfg, tparams, torch.from_numpy(tokens).long(),
                           mode="train")
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **SEQ_TOL)
    jl, tl = np.asarray(jl), tl.numpy()
    for b, n in enumerate(lens):
        np.testing.assert_allclose(tl[b, -n:], jl[b, -n:], **SEQ_TOL)


def test_decode_matches_train_forward():
    """The reference's ``test_decode_matches_train_forward`` on the port:
    prefill of S tokens, then one decode step, against the S+1-token train
    forward."""
    _, tcfg, _, tparams = _model()
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, tcfg.vocab_size, (B, 12)))
    with torch.no_grad():
        caches = TT.init_caches(tcfg, B, 32, torch.float32, "cpu")
        lp, _ = TT.forward(tcfg, tparams, tokens, caches)
        ref, _ = TT.forward(tcfg, tparams, tokens, mode="train")
        np.testing.assert_allclose(lp.numpy(), ref.numpy(), **SEQ_TOL)
        nxt = lp[:, -1].argmax(-1)
        ld, _ = TT.decode_step(tcfg, tparams, nxt, caches)
        full, _ = TT.forward(tcfg, tparams,
                             torch.cat([tokens, nxt[:, None]], 1),
                             mode="train")
    np.testing.assert_allclose(ld.numpy(), full[:, -1].numpy(),
                               rtol=5e-3, atol=5e-3)


def _prompts(cfg, lens=(6, 11, 4, 9, 13), seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


_REFERENCE = {}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_greedy_tokens_equal_reference(layout):
    """More requests than slots; the paged layout keeps the contiguous
    machinery with an empty pool, so its tokens are the contiguous ones."""
    jcfg, tcfg, jparams, tparams = _model()
    jbe = JaxTensorBackend(jcfg, jparams, n_slots=3, max_len=40,
                           impl="pallas", cache_layout=layout, block_size=8,
                           prefix_cache=True)
    want_info = dataclasses.asdict(jbe.info)
    want = [o.tokens for o in JaxLLM.from_backend(jbe).generate(
        _prompts(tcfg), JaxSamplingParams(max_tokens=8))]
    be = TensorBackend(tcfg, tparams, n_slots=3, max_len=40, impl="cuda",
                       cache_layout=layout, block_size=8,
                       cache_dtype=torch.float32, device="cpu",
                       prefix_cache=True)
    got_info = dataclasses.asdict(be.info)
    assert got_info.pop("attn_impl") == "plain"
    assert want_info.pop("attn_impl") == "pallas"
    assert got_info == want_info
    if layout == "paged":
        assert got_info["block_size"] == 8
        assert got_info["total_blocks"] == got_info["max_ctx_blocks"] == 0
        assert got_info["bytes_per_block"] == 0
    assert not (got_info["supports_extend"] or got_info["prefix_caching"]
                or got_info["spec_decode"])
    got = LLM.from_backend(be).generate(_prompts(tcfg),
                                        SamplingParams(max_tokens=8))
    assert [o.tokens for o in got] == want
    assert len({t for ts in want for t in ts}) > 4, "degenerate tokens"
    _REFERENCE[layout] = want
    if len(_REFERENCE) == 2:
        assert _REFERENCE["paged"] == _REFERENCE["contiguous"]


@pytest.mark.parametrize("mode", ["extend", "verify"])
def test_extend_and_verify_refuse_recurrent_blocks(mode):
    """As the reference's ``_apply_block`` refuses them."""
    jcfg, tcfg, jparams, tparams = _model()
    spec = tcfg.layer_specs()[0]
    x = np.zeros((1, 2, tcfg.d_model), np.float32)
    with pytest.raises(ValueError, match="requires attention caches"):
        JT._apply_block(jcfg, spec, {}, jnp.asarray(x),
                        jnp.zeros((1, 2), jnp.int32), mode, None, "xla")
    with pytest.raises(ValueError, match="requires attention caches"):
        TT._apply_block(tcfg, spec, {}, torch.from_numpy(x),
                        torch.zeros((1, 2), dtype=torch.int32), mode, None,
                        "ref")
