"""The port's attention and dense decoder against the JAX package, on the
reduced llama2-7b (MHA, untied head) and qwen3-0.6b (GQA, qk-norm, tied
embeddings), in float32 on the CPU with the reference's own weights.

Logits are compared at real positions only, at rtol/atol 1e-4 (float32
matmuls summed in another order by another library), and their argmax must
be identical.  ``impl="ref"`` is held against the reference's ``"xla"``
path, ``impl="cuda"`` (its plain version on the CPU) against ``"pallas"``
in interpret mode.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import kvcache as JKV  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import kvcache as TKV  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["llama2-7b", "qwen3-0.6b"]
IMPLS = [("ref", "xla"), ("cuda", "pallas")]


def _model(arch, window=None):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if window is not None:
        jcfg, tcfg = [dataclasses.replace(c, pattern=tuple(
            dataclasses.replace(s, window=window) for s in c.pattern))
            for c in (jcfg, tcfg)]
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same_cache(tc, jc, valid=None):
    """Positions exactly; k/v where ``valid`` (default: every slot)."""
    for k in ("key_pos", "pos", "bt"):
        if k in jc:
            np.testing.assert_array_equal(_np(tc[k]), _np(jc[k]))
    for k in ("k", "v", "k_pool", "v_pool"):
        if k in jc:
            t, j = _np(tc[k]), _np(jc[k])
            if valid is not None:
                t, j = t[valid], j[valid]
            np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [None, 8])
def test_forward_prefill_prompt_lens(arch, window):
    """Masked left-padded prefill: logits at real positions and the ring
    caches match; with a window of 8 the ring is shorter than the wave."""
    jcfg, tcfg, jparams, tparams = _model(arch, window)
    r = np.random.default_rng(1)
    s, lens = 12, np.asarray([12, 7, 1], np.int32)
    tokens = r.integers(0, tcfg.vocab_size, (3, s)).astype(np.int32)
    jl, jc, _ = JT.forward(jcfg, jparams, jnp.asarray(tokens), mode="prefill",
                           caches=JT.init_caches(jcfg, 3, 16, jnp.float32),
                           prompt_lens=jnp.asarray(lens))
    with torch.no_grad():
        tl, tc = TT.forward(tcfg, tparams, torch.from_numpy(tokens).long(),
                            TT.init_caches(tcfg, 3, 16, torch.float32, "cpu"),
                            prompt_lens=torch.from_numpy(lens))
    real = np.arange(s)[None] >= (s - lens)[:, None]
    np.testing.assert_allclose(_np(tl)[real], _np(jl)[real], **TOL)
    np.testing.assert_array_equal(_np(tl)[real].argmax(-1),
                                  _np(jl)[real].argmax(-1))
    for i, layer in enumerate(tc):
        jlayer = {k: v[i] for k, v in jc["stack"]["p0"].items()}
        _same_cache(layer, jlayer, valid=_np(jlayer["key_pos"]) >= 0)


def _paged_pair(jcfg, tcfg, n_slots=3, max_len=40, num_blocks=8):
    jc = JT.init_paged_caches(jcfg, n_slots, max_len, num_blocks, 16,
                              jnp.float32)
    tc = TT.init_paged_caches(tcfg, n_slots, max_len, num_blocks, 16,
                              torch.float32, "cpu")
    # slot 0: two blocks, slot 1: two blocks, slot 2: idle, nothing mapped
    table = np.asarray([[5, 2, -1], [0, 7, -1], [-1, -1, -1]], np.int32)
    jc["stack"]["p0"]["bt"] = jnp.broadcast_to(
        jnp.asarray(table), jc["stack"]["p0"]["bt"].shape)
    for layer in tc:
        layer["bt"].copy_(torch.from_numpy(table))
    return jc, tc


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_paged_decode_steps(arch, impl, jimpl):
    """Paged decode over 20 steps from empty caches, with per-slot
    write_mask: slot 2 stays idle and slot 1 is frozen on some steps.  The
    idle slot's row is fully masked: the ref path gives the mean of V, as
    the reference's sdpa does, and the kernel path exact zeros, as the
    reference's kernel does -- both mirrored."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    jc, tc = _paged_pair(jcfg, tcfg)
    r = np.random.default_rng(2)
    step = jax.jit(lambda p, t, c, m: JT.decode_step(jcfg, p, t, c,
                                                     impl=jimpl, write_mask=m))
    for i in range(20):
        tok = r.integers(0, tcfg.vocab_size, 3).astype(np.int32)
        mask = np.asarray([True, i % 3 != 1, False])
        jl, jc = step(jparams, jnp.asarray(tok), jc, jnp.asarray(mask))
        with torch.no_grad():
            tl, tc = TT.decode_step(tcfg, tparams,
                                    torch.from_numpy(tok).long(), tc,
                                    impl=impl,
                                    write_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        np.testing.assert_array_equal(_np(tl).argmax(-1), _np(jl).argmax(-1))
    assert int(tc[0]["pos"][2]) == 0 and int(tc[0]["pos"][0]) == 20
    for i, layer in enumerate(tc):
        jlayer = {k: v[i] for k, v in jc["stack"]["p0"].items()}
        _same_cache(layer, jlayer)


def _attn(params, layer=0):
    return params["layers"][layer]["mixer"] if "layers" in params else \
        jax.tree.map(lambda x: x[layer], params["stack"]["p0"]["mixer"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_layer(arch):
    """prefill_cache alone: per-row positions (negative at pads) into a ring
    shorter than the wave under a window."""
    jcfg, tcfg, jparams, tparams = _model(arch, window=6)
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 10, tcfg.d_model)).astype(np.float32)
    pos = (np.arange(10)[None] - np.asarray([[0], [4]])).astype(np.int32)
    jcache0 = JKV.init_block_cache(jcfg, jcfg.pattern[0], 2, 6, jnp.float32)
    tcache0 = TKV.init_block_cache(tcfg, tcfg.pattern[0], 2, 6, torch.float32)
    jy, jcache = JA.prefill_cache(_attn(jparams), jcfg, jcfg.pattern[0],
                                  jnp.asarray(x), jnp.asarray(pos), jcache0)
    with torch.no_grad():
        ty, tcache = TA.prefill_cache(_attn(tparams), tcfg,
                                      tcfg.pattern[0], torch.from_numpy(x),
                                      torch.from_numpy(pos), tcache0)
    real = pos >= 0
    np.testing.assert_allclose(_np(ty)[real], _np(jy)[real], **TOL)
    _same_cache(tcache, jcache, valid=_np(jcache["key_pos"]) >= 0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_attend_decode_paged_write_mask(arch, impl, jimpl):
    """One paged decode call: the masked row's k/v land in the scratch
    block, its key_pos and pos stay frozen, the live row writes its block."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    spec_j, spec_t = jcfg.pattern[0], tcfg.pattern[0]
    jc = JKV.init_paged_block_cache(jcfg, spec_j, 2, 32, 4, 16, jnp.float32)
    tc = TKV.init_paged_block_cache(tcfg, spec_t, 2, 32, 4, 16, torch.float32)
    r = np.random.default_rng(4)
    table = np.asarray([[3, 1], [0, 2]], np.int32)
    kp = np.where(np.arange(32)[None] < np.asarray([[20], [9]]),
                  np.arange(32)[None], -1).astype(np.int32)
    pools = r.standard_normal((2,) + tuple(jc["k_pool"].shape)) \
        .astype(np.float32)
    jc = dict(jc, bt=jnp.asarray(table), key_pos=jnp.asarray(kp),
              pos=jnp.asarray([20, 9], jnp.int32),
              k_pool=jnp.asarray(pools[0]), v_pool=jnp.asarray(pools[1]))
    for k, v in (("bt", table), ("key_pos", kp), ("k_pool", pools[0]),
                 ("v_pool", pools[1])):
        tc[k].copy_(torch.from_numpy(v))
    tc["pos"].copy_(torch.tensor([20, 9], dtype=torch.int32))
    x = r.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    mask = np.asarray([True, False])
    jy, jnew = JA.attend_decode_paged(_attn(jparams), jcfg, spec_j,
                                      jnp.asarray(x), jc, impl=jimpl,
                                      write_mask=jnp.asarray(mask))
    with torch.no_grad():
        ty, tnew = TA.attend_decode_paged(_attn(tparams), tcfg, spec_t,
                                          torch.from_numpy(x), tc, impl=impl,
                                          write_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    _same_cache(tnew, jnew)
    assert _np(tnew["pos"]).tolist() == [21, 9]
    np.testing.assert_array_equal(_np(tnew["key_pos"])[1], kp[1])
    assert not np.array_equal(_np(tnew["k_pool"])[-1], pools[0][-1])


def test_sdpa_fully_masked_row_is_mean_of_v():
    """The reference's sdpa masks with a finite NEG_INF, so a row with no
    valid key averages V; the port mirrors that (the caller discards it)."""
    jcfg, tcfg = jax_get_config("qwen3-0.6b").reduced(), \
        get_config("qwen3-0.6b").reduced()
    r = np.random.default_rng(5)
    hd = tcfg.resolved_head_dim
    q = r.standard_normal((2, 1, tcfg.n_heads, hd)).astype(np.float32)
    k = r.standard_normal((2, 8, tcfg.n_kv_heads, hd)).astype(np.float32)
    v = r.standard_normal((2, 8, tcfg.n_kv_heads, hd)).astype(np.float32)
    q_pos = np.asarray([[7], [7]], np.int32)
    k_pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    valid = np.asarray([[True] * 8, [False] * 8])
    want = JA._sdpa(jcfg, jcfg.pattern[0], jnp.asarray(q), jnp.asarray(k),
                    jnp.asarray(v), jnp.asarray(q_pos), jnp.asarray(k_pos),
                    k_valid=jnp.asarray(valid))
    got = TA._sdpa(tcfg, tcfg.pattern[0], *(torch.from_numpy(a) for a in
                                            (q, k, v, q_pos, k_pos, valid)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    g = tcfg.n_heads // tcfg.n_kv_heads
    mean_v = np.repeat(v[1].mean(0), g, axis=0).reshape(-1)
    np.testing.assert_allclose(_np(got)[1, 0], mean_v, **TOL)


def test_unknown_impl_raises():
    jcfg, tcfg, _, tparams = _model("qwen3-0.6b")
    tc = TT.init_paged_caches(tcfg, 1, 16, 2, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="unknown decode impl"):
        TT.decode_step(tcfg, tparams, torch.zeros(1, dtype=torch.long), tc,
                       impl="pallas")
    with pytest.raises(ValueError, match="unknown decode impl"):
        TT.forward(tcfg, tparams, torch.zeros((1, 4), dtype=torch.long),
                   TT.init_caches(tcfg, 1, 4, torch.float32, "cpu"),
                   impl="xla")
