"""The port's int8 weight matmul against the JAX package, on the CPU: the
op's wrapper (its plain version on CPU tensors) against
``repro.kernels.ops.int8_matmul`` (the Pallas kernel in interpret mode) at
the shapes of ``tests/test_kernels.py``'s int8 tests, with leading
dimensions, and the quantizer bit for bit against ``quantize_int8``.

Inputs come from numpy with a seed and go to both packages.  Tolerances are
``tests/test_kernels.py``'s ``_tol``: 3e-5 in float32, 2e-2 in bfloat16.
The kernel itself runs only on a GPU: ``tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro.kernels.int8_matmul import quantize_int8 as jax_quantize  # noqa: E402
from repro_torch.kernels import int8_matmul as I8  # noqa: E402

torch.set_num_threads(2)

# tests/test_kernels.py's int8 shapes: (70, 300, 130) is ragged in all three
SHAPES = [(128, 512, 128), (70, 300, 130), (1, 1024, 256), (256, 64, 64)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=3e-5, atol=3e-5)


def _inputs(m, k, n, dtype, seed=7):
    """x [m, k] in ``dtype`` and w [k, n] float32, for both packages."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt),
            jnp.asarray(w), torch.from_numpy(w))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _quantize_both(w_jax, w_torch):
    """Each package's quantizer on the same weight; asserts they agree bit
    for bit and returns the torch pair."""
    jq, js = jax_quantize(w_jax)
    tq, ts = I8.quantize_int8(w_torch)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (1, w_torch.shape[1])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    return tq, ts


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_matches_pallas(m, k, n, dtype):
    jx, tx, jw, tw = _inputs(m, k, n, dtype)
    jq, js = jax_quantize(jw)
    tq, ts = _quantize_both(jw, tw)
    before = I8.int8_matmul.launches
    got = I8.int8_matmul(tx, tq, ts)
    assert I8.int8_matmul.launches == before       # CPU: the plain version
    assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
    want = ops.int8_matmul(jx, jq, js, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(ref.int8_matmul_ref(jx, jq, js)),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_bit_identical(dtype):
    """Random weights over several magnitudes, a zero column (the 1e-8
    floor) and a column whose ``w / scale`` lands on exact halves (rounded
    half to even by both)."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    w *= np.logspace(-3, 2, 40, dtype=np.float32)[None]
    w[:, 3] = 0.0                                       # zero column
    halves = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                         -126.5, 3.5], np.float32)
    w[:, 7] = 0.0
    w[:len(halves), 7] = halves                          # scale exactly 1
    jdt, tdt = DTYPES[dtype]
    jw = jnp.asarray(w).astype(jdt)
    tw = torch.from_numpy(w).to(tdt)
    tq, ts = _quantize_both(jw, tw)
    assert float(ts[0, 3]) == np.float32(1e-8) / np.float32(127.0)
    assert not tq[:, 3].any()
    assert float(ts[0, 7]) == 1.0
    assert tq[:len(halves), 7].tolist() == [127, 0, 2, 2, 0, -2, -2, 126,
                                            -126, 4]


def test_quantization_error_bounded():
    """tests/test_kernels.py: every element within half a step."""
    w = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (256, 128)).astype(np.float32))
    wq, sc = I8.quantize_int8(w)
    err = (w - wq.float() * sc).abs()
    assert bool((err <= sc / 2 + 1e-6).all())


def test_int8_matmul_leading_dims():
    """x [2, 3, 64] -> [2, 3, 32], equal to the JAX op's values."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    tq, ts = _quantize_both(jnp.asarray(w), torch.from_numpy(w))
    got = I8.int8_matmul(torch.from_numpy(x), tq, ts)
    assert tuple(got.shape) == (2, 3, 32)
    want = ops.int8_matmul(jnp.asarray(x), jnp.asarray(tq.numpy()),
                           jnp.asarray(ts.numpy()), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol("float32"))


def test_wrapper_refuses_what_is_not_on_the_cpu_or_one_card():
    """Only CPU tensors take the plain version; a tensor on another device
    (here ``meta``) raises instead of falling back, and nothing launches."""
    x = torch.zeros((4, 64))
    wq, sc = I8.quantize_int8(torch.ones((64, 32)))
    before = I8.int8_matmul.launches
    for call in ((x.to("meta"), wq, sc), (x, wq.to("meta"), sc),
                 (x, wq, sc.to("meta"))):
        with pytest.raises(ValueError, match="one CUDA device"):
            I8.int8_matmul(*call)
    assert I8.int8_matmul.launches == before
