"""The port's paged attention (plain version, and its wrapper on CPU tensors)
against the JAX package's Pallas kernels run in interpret mode.

The cases mirror ``tests/test_kernels.py``: GQA/MQA/MHA with per-slot
positions, unmapped table entries, a wrapped ring under a sliding window, a
fully masked row (exact zeros), softcap, and 4 query tokens per slot
(``ops.paged_verify_attention``).  Tolerance: rtol and atol 3e-5, as there.
The kernel itself runs only on a GPU: ``tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402

from paged_cases import paged_case as _case  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=3e-5, atol=3e-5)


def _jax(x, **opts):
    args = [jnp.asarray(x[k]) for k in ("k_pool", "v_pool", "bt", "key_pos",
                                         "pos")]
    if x["q"].shape[1] == 1:
        return np.asarray(ops.paged_decode_attention(
            jnp.asarray(x["q"][:, 0]), *args, interpret=True, **opts))[:, None]
    return np.asarray(ops.paged_verify_attention(
        jnp.asarray(x["q"]), *args, interpret=True, **opts))


def _torch(fn, x, **opts):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    if x["q"].shape[1] == 1:          # one token per slot: q [B, H, D]
        return fn(t["q"][:, 0], t["k_pool"], t["v_pool"], t["bt"],
                  t["key_pos"], t["pos"], **opts)[:, None].numpy()
    return fn(t["q"], t["k_pool"], t["v_pool"], t["bt"], t["key_pos"],
              t["pos"], **opts).numpy()


CASES = {
    # b, h, kh, d, bs, nbs, lens
    "gqa": (2, 4, 2, 64, 16, 4, (40, 25)),
    "mqa": (3, 8, 1, 32, 16, 3, (45, 1, 17)),
    "mha-big-blocks": (1, 2, 2, 128, 32, 2, (33,)),
}


@pytest.mark.parametrize("kq", [1, 4])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas(case, softcap, kq):
    """Per-slot positions with unmapped tail blocks: the plain version and
    the wrapper on CPU tensors equal the interpret-mode kernels."""
    x = _case(*CASES[case], kq=kq, seed=20)
    want = _jax(x, softcap=softcap)
    np.testing.assert_allclose(
        _torch(PA.paged_attention_plain, x, softcap=softcap), want, **TOL)
    np.testing.assert_allclose(
        _torch(PA.paged_attention, x, softcap=softcap), want, **TOL)


@pytest.mark.parametrize("kq", [1, 4])
def test_ring_wraparound_window(kq):
    """A wrapped ring holds non-monotonic key_pos; the window follows each
    query row's own position pos + i."""
    x = _case(1, 4, 2, 32, 16, 4, (1,), kq, seed=21, last=150)
    mask = (x["key_pos"][0] > x["pos"][0] + kq - 1 - 40).sum()
    assert 0 < mask < 64, "the window must mask a strict subset"
    np.testing.assert_allclose(
        _torch(PA.paged_attention_plain, x, window=40),
        _jax(x, window=40), **TOL)


@pytest.mark.parametrize("kq", [1, 4])
def test_fully_masked_row_is_exact_zeros(kq):
    """An idle slot (every key_pos -1, table unmapped) gives exact zeros,
    and its live neighbour is unaffected."""
    x = _case(2, 4, 2, 32, 16, 2, (20, 5), kq, seed=22, dead=(1,))
    got = _torch(PA.paged_attention_plain, x)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], np.zeros_like(got[1]))
    np.testing.assert_allclose(got, _jax(x), **TOL)
    solo = {k: v[:1] if k not in ("k_pool", "v_pool") else v
            for k, v in x.items()}
    np.testing.assert_allclose(got[:1], _torch(PA.paged_attention_plain,
                                               solo), **TOL)


def test_unmapped_blocks_and_scratch_never_read():
    """Unmapped entries read as masked: poisoning the scratch block and
    every unmapped block's keys leaves the output unchanged."""
    x = _case(2, 4, 2, 32, 16, 3, (20, 10), 3, seed=31)
    got = _torch(PA.paged_attention_plain, x)
    bad = dict(x, k_pool=x["k_pool"].copy(), v_pool=x["v_pool"].copy())
    unused = np.setdiff1d(np.arange(bad["k_pool"].shape[0]),
                          x["bt"][x["bt"] >= 0])
    bad["k_pool"][unused] = 1e6
    bad["v_pool"][unused] = -1e6
    np.testing.assert_allclose(_torch(PA.paged_attention_plain, bad), got,
                               **TOL)


def test_kq1_equals_decode_layout():
    """q [B, H, D] and q [B, 1, H, D] are one computation."""
    x = _case(*CASES["gqa"], kq=1, seed=32)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    three = PA.paged_attention(t["q"][:, 0], t["k_pool"], t["v_pool"],
                               t["bt"], t["key_pos"], t["pos"])
    four = PA.paged_attention(t["q"], t["k_pool"], t["v_pool"], t["bt"],
                              t["key_pos"], t["pos"])
    assert three.shape == (2, 4, 64) and four.shape == (2, 1, 4, 64)
    torch.testing.assert_close(three, four[:, 0], rtol=0, atol=0)


def test_cpu_wrapper_counts_no_launch():
    """On CPU tensors the wrapper runs the plain version and launches no
    kernel; a CPU/CUDA mix raises rather than falling back."""
    before = PA.paged_attention.launches
    x = _case(*CASES["gqa"], kq=1, seed=33)
    _torch(PA.paged_attention, x)
    assert PA.paged_attention.launches == before
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    t["q"] = t["q"].to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        PA.paged_attention(t["q"][:, 0], t["k_pool"], t["v_pool"], t["bt"],
                           t["key_pos"], t["pos"])
