"""The port's flash attention on the CPU: the wrapper (its plain version on
CPU tensors) against the JAX package's Pallas kernel in interpret mode
(``ops.flash_attention``) and its pure-jnp oracle
(``ref.flash_attention_ref``), on the cases of ``tests/test_kernels.py``:
four shapes (MHA, GQA with a padded S, MQA at D=128, S below one block) in
float32 and bfloat16, windows by softcap, and an S that is no multiple of
128.  Inputs come from numpy with a seed and go to both packages;
bfloat16 inputs round from the same float32 values in both.  Tolerances are
those of ``tests/test_kernels.py``'s ``_tol``: 3e-5 in float32, 2e-2 in
bfloat16.  The kernel itself runs only on a GPU: ``tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

torch.set_num_threads(2)
SHAPES = [
    (1, 128, 4, 4, 64),       # MHA, exact block multiple
    (2, 200, 4, 2, 64),       # GQA, padded seq
    (1, 384, 8, 1, 128),      # MQA, d=128
    (1, 96, 2, 2, 32),        # seq < block
]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=3e-5, atol=3e-5)


def _inputs(b, s, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))]


def _both(arrays, dtype):
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _check(arrays, dtype, **opts):
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    got = FA.flash_attention(tq, tk, tv, **opts)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    torch.testing.assert_close(
        got, FA.flash_attention_plain(tq, tk, tv, **opts), rtol=0, atol=0)
    pallas = ops.flash_attention(jq, jk, jv, interpret=True, **opts)
    oracle = jnp.swapaxes(ref.flash_attention_ref(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
        jnp.swapaxes(jv, 1, 2), **opts), 1, 2)
    out = got.float().numpy()
    for want in (pallas, oracle):
        np.testing.assert_allclose(out, np.asarray(want, np.float32),
                                   **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d", SHAPES)
def test_plain_matches_pallas_and_ref(b, s, h, kh, d, dtype):
    _check(_inputs(b, s, h, kh, d, seed=0), dtype)


@pytest.mark.parametrize("window", [16, 64, 128])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_window_softcap(window, softcap):
    _check(_inputs(1, 256, 4, 2, 64, seed=1), "float32", window=window,
           softcap=softcap)


def test_ragged_sequence_with_window_and_softcap():
    """S = 300: no multiple of 128 (the JAX wrapper pads to 384 and masks the
    padded keys; the port pads nothing), MQA, window and softcap."""
    _check(_inputs(2, 300, 4, 1, 32, seed=2), "float32", window=70,
           softcap=20.0)


def test_cpu_wrapper_takes_what_the_plain_version_takes():
    """On CPU tensors the wrapper is the plain version: it refuses none of
    what the kernel refuses on the card (a head dim outside 32/64/128/256,
    float16, q and K/V in different dtypes, strided inputs, inputs that
    need gradients) and its gradients flow."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 40, 4, 2, 48, seed=3))
    cases = [
        (q, k, v),                                             # D = 48
        (q.half(), k.half(), v.half()),                        # float16
        (q.bfloat16(), k, v),                                  # mixed dtypes
        (q.transpose(1, 2).contiguous().transpose(1, 2), k, v),  # strided
        (q.clone().requires_grad_(True), k, v),                # autograd
    ]
    before = FA.flash_attention.launches
    for args in cases:
        got = FA.flash_attention(*args, window=8, softcap=30.0)
        want = FA.flash_attention_plain(*args, window=8, softcap=30.0)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    got.float().sum().backward()
    assert cases[-1][0].grad is not None
    assert FA.flash_attention.launches == before


def _tiles(mask, rows, keys):
    """Per (query tile, key tile): any and all of the pairs of the real rows
    and the tile's keys visible (a key past S is never visible)."""
    s = mask.shape[0]
    n_kt = -(-s // keys)
    cols = np.zeros((s, n_kt * keys), bool)
    cols[:, :s] = mask
    out = []
    for q0 in range(0, s, rows):
        sub = cols[q0:q0 + rows].reshape(-1, n_kt, keys)
        out.append((sub.any(axis=(0, 2)), sub.all(axis=(0, 2))))
    return out


@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16),
                                     (256, torch.bfloat16),
                                     (64, torch.float32)])
@pytest.mark.parametrize("window", [None, 16, 64, 2048])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 2500, 4096])
def test_tile_plan_matches_the_dense_mask(s, window, d, dtype):
    """The kernel's walk against the dense [S, S] mask: one query tile per
    block row; no visible pair lies outside its walk; every tile the plan
    leaves unmasked is fully visible to every real row of its query tile;
    the walk visits no key tile wholly invisible to its query tile; the
    float32 kernel masks every tile."""
    plan = FA.tile_plan(s, window, d, dtype)
    assert (plan.rows, plan.keys) == FA.BLOCK_SHAPE[dtype][d]
    assert [t.q0 for t in plan.tiles] == list(range(0, s, plan.rows))
    pos = np.arange(s)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    for t, (seen, whole) in zip(plan.tiles, _tiles(mask, plan.rows,
                                                   plan.keys)):
        walk = np.zeros_like(seen)
        walk[t.first:t.last + 1] = True
        assert not (seen & ~walk).any()          # nothing visible outside
        assert seen[walk].all()                  # no wholly invisible tile
        assert set(t.masked) <= set(range(t.first, t.last + 1))
        unmasked = [k for k in range(t.first, t.last + 1)
                    if k not in t.masked]
        assert whole[unmasked].all()
        if dtype == torch.float32:
            assert not unmasked
        else:                                    # masked only where needed
            assert not whole[list(t.masked)].any()


def test_tile_plan_at_the_score_shapes():
    """llama2-7b's causal 4096 at D = 128 walks 32 blocks of 128 rows in
    tiles of 64 keys, the diagonal's two tiles masked in each; the hybrid's
    window of 2048 at D = 256 walks 64 blocks of 64 rows in tiles of 32
    keys, no more than the window and the block's rows span, with the
    diagonal's two tiles and at most three at the window's edge masked."""
    plan = FA.tile_plan(4096, None, 128)
    assert (len(plan.tiles), plan.rows, plan.keys) == (32, 128, 64)
    assert all(len(t.masked) == 2 and t.first == 0 for t in plan.tiles)
    hybrid = FA.tile_plan(4096, 2048, 256)
    assert (len(hybrid.tiles), hybrid.rows, hybrid.keys) == (64, 64, 32)
    assert all(2 <= len(t.masked) <= 5 and
               (t.last - t.first) * 32 <= 2048 + 64 for t in hybrid.tiles)
