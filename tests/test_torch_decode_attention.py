"""The port's contiguous-ring decode attention (plain version, and its
wrapper on CPU tensors) against the JAX package's Pallas
``decode_attention_bhd`` run in interpret mode.

The cases mirror ``tests/test_kernels.py``: GQA/MQA/MHA, C=700 with 650
valid keys (the JAX wrapper pads it to its block), a wrapped ring under a
window of 50, plus per-row ``key_pos [B, C]``/``pos [B]``, softcap and a
fully masked row (exact zeros).  Tolerances are that file's ``_tol``.  The
kernel itself runs only on a GPU: ``tests/test_torch_cuda.py``; here also
the host rule that splits its ring across blocks (``split_plan``).
"""
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402

from paged_cases import ring_case  # noqa: E402

torch.set_num_threads(2)
ARGS = ("q", "k_cache", "v_cache", "key_pos", "pos")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=3e-5, atol=3e-5)


def _jax(x, dtype="float32", **opts):
    q, k, v, kp, pos = (jnp.asarray(x[n]) for n in ARGS)
    q, k, v = (a.astype(getattr(jnp, dtype)) for a in (q, k, v))
    return np.asarray(ops.decode_attention(q, k, v, kp, pos, block_c=256,
                                           interpret=True, **opts),
                      np.float32)


def _torch(fn, x, dtype="float32", **opts):
    t = {n: torch.from_numpy(np.asarray(x[n])) for n in ARGS}
    for n in ("q", "k_cache", "v_cache"):
        t[n] = t[n].to(getattr(torch, dtype))
    return fn(**t, **opts).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,d,c,valid", [
    (2, 4, 2, 64, 512, 512),
    (1, 8, 1, 128, 700, 650),     # padded cache, partially filled
    (4, 2, 2, 32, 64, 10),
])
def test_plain_matches_pallas(b, h, kh, d, c, valid, dtype):
    """Shared key_pos [C] and a scalar pos, as in the JAX kernel tests; the
    wrapper on CPU tensors is the plain version."""
    x = ring_case(b, h, kh, d, c, valid, seed=60)
    want = _jax(x, dtype)
    np.testing.assert_allclose(_torch(DA.decode_attention_plain, x, dtype),
                               want, **_tol(dtype))
    np.testing.assert_allclose(_torch(DA.decode_attention, x, dtype), want,
                               **_tol(dtype))


def test_ring_wraparound_window():
    """Ring slots hold non-monotonic positions; the window masks a strict
    subset of them."""
    x = ring_case(1, 2, 1, 32, 128, 0, seed=61, wrap_pos=200)
    inside = (x["key_pos"] > 200 - 50).sum()
    assert 0 < inside < 128, "the window must mask a strict subset"
    np.testing.assert_allclose(
        _torch(DA.decode_attention_plain, x, window=50),
        _jax(x, window=50), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_per_row_positions(softcap):
    """key_pos [B, C] and pos [B]: each row decodes at its own position,
    as after a masked, length-bucketed prefill."""
    x = ring_case(3, 8, 2, 64, 96, (96, 40, 1), seed=62)
    assert x["key_pos"].shape == (3, 96) and x["pos"].shape == (3,)
    np.testing.assert_allclose(
        _torch(DA.decode_attention_plain, x, softcap=softcap),
        _jax(x, softcap=softcap), rtol=3e-5, atol=3e-5)


def test_fully_masked_row_is_exact_zeros():
    """A row with no valid key gives exact zeros, as the Pallas kernel's
    clamped denominator does, and its neighbour is unaffected."""
    x = ring_case(2, 4, 2, 32, 64, (20, 5), seed=63, dead=(1,))
    got = _torch(DA.decode_attention_plain, x)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], np.zeros_like(got[1]))
    np.testing.assert_allclose(got, _jax(x), rtol=3e-5, atol=3e-5)


def test_query_layouts_and_shared_pos():
    """q [B, H, D] and q [B, 1, H, D] are one computation, and pos may be
    one for all rows or one per row."""
    x = ring_case(2, 4, 2, 32, 40, 30, seed=64)
    t = {n: torch.from_numpy(np.asarray(x[n])) for n in ARGS}
    three = DA.decode_attention(**t)
    four = DA.decode_attention(t["q"][:, None], *(t[n] for n in ARGS[1:]))
    assert three.shape == (2, 4, 32) and four.shape == (2, 1, 4, 32)
    torch.testing.assert_close(three, four[:, 0], rtol=0, atol=0)
    for pos in (torch.tensor(29, dtype=torch.int32),
                torch.tensor([29, 29], dtype=torch.int32)):
        torch.testing.assert_close(
            DA.decode_attention(t["q"], t["k_cache"], t["v_cache"],
                                t["key_pos"], pos), three, rtol=0, atol=0)


def test_cpu_wrapper_counts_no_launch():
    """On CPU tensors the wrapper runs the plain version and launches no
    kernel; a tensor on another device raises rather than falling back."""
    before = DA.decode_attention.launches
    x = ring_case(2, 4, 2, 32, 40, 30, seed=65)
    _torch(DA.decode_attention, x)
    assert DA.decode_attention.launches == before
    t = {n: torch.from_numpy(np.asarray(x[n])) for n in ARGS}
    t["q"] = t["q"].to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        DA.decode_attention(**t)


# B, KH, g, C: the timing shapes (llama2-7b's 4096-key ring, the hybrid's
# 2048-key window ring), llama2-70b at B=1, short and ragged rings, a card
# already full
PLAN_SHAPES = [(4, 32, 1, 4096), (4, 1, 10, 2048), (1, 8, 8, 4096),
               (4, 32, 1, 3000), (2, 8, 2, 64), (1, 1, 10, 1),
               (3, 8, 2, 700), (32, 32, 1, 256), (1, 1, 40, 100_000)]


@pytest.mark.parametrize("n_sm", [132, 114, 8])
@pytest.mark.parametrize("b,kh,g,c", PLAN_SHAPES)
def test_split_plan_covers_the_ring(b, kh, g, c, n_sm):
    """S splits of L keys cover the ring, none of them empty by length; L is
    a whole number of tiles; S is within the kernel's limit."""
    s, L = DA.split_plan(b, kh, g, c, n_sm)
    assert 1 <= s <= DA.MAX_SPLITS and L % DA.TILE_KEYS == 0
    assert s * L >= c > (s - 1) * L
    assert s <= -(-c // DA.TILE_KEYS)          # at most one split per tile


def test_split_plan_fills_the_card_from_shapes_only():
    """The hybrid's 4 blocks become 128 on an H100's 132 SMs; a card that
    B*KH already fills over a short ring is not split (the output is
    written directly, no merge); the plan takes shapes and the SM count,
    nothing of pos or key_pos, and gives the same answer every time."""
    assert DA.split_plan(4, 1, 10, 2048, 132) == (32, 64)
    assert DA.split_plan(4, 32, 1, 4096, 132) == (16, 256)
    assert DA.split_plan(1, 8, 8, 4096, 132) == (64, 64)
    for b, kh, c in ((32, 32, 256), (64, 32, 128), (8, 128, 64)):
        assert b * kh >= DA.BLOCKS_PER_SM * 132
        assert DA.split_plan(b, kh, 1, c, 132)[0] == 1
    assert list(inspect.signature(DA.split_plan).parameters) == \
        ["b", "kh", "g", "c", "n_sm"]
    assert {DA.split_plan(*s, 132) for s in [PLAN_SHAPES[1]] * 3} == \
        {(32, 64)}
