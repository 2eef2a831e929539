"""The port's paged attention (plain version, and its wrapper on CPU tensors)
against the JAX package's Pallas kernels run in interpret mode.

The cases mirror ``tests/test_kernels.py``: GQA/MQA/MHA with per-slot
positions, unmapped table entries, a wrapped ring under a sliding window, a
fully masked row (exact zeros), softcap, and 4 query tokens per slot
(``ops.paged_verify_attention``).  Tolerance: rtol and atol 3e-5, as there.
The kernel itself runs only on a GPU: ``tests/test_torch_cuda.py``; here
also the host rule that splits each slot's table across blocks
(``table_split_plan``) and, in float64, the rule by which the kernel merges
the splits.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402

from paged_cases import paged_case as _case  # noqa: E402
from paged_cases import poison_unread  # noqa: E402

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


# B, H, KH, C: the timing shapes (llama2-7b's 512- and 1280-key tables),
# llama2-70b's g=8 and qwen3-0.6b's g=2, the hybrid's g=10 over its 2048-key
# window, a short table and a card already full
TABLE_SHAPES = [(4, 32, 32, 512), (4, 32, 32, 1280), (2, 64, 8, 2048),
                (3, 16, 8, 256), (4, 10, 1, 2048), (2, 4, 2, 48),
                (32, 32, 32, 256)]


@pytest.mark.parametrize("n_sm", [132, 114, 8])
@pytest.mark.parametrize("b,h,kh,c", TABLE_SHAPES)
def test_table_split_plan_is_decodes_plan(b, h, kh, c, n_sm):
    """The paged kernel's plan is the ring kernel's ``split_plan`` at
    g = H // KH, the same for one and for four query tokens a slot, and its
    S splits of L keys cover the table."""
    plans = {PA.table_split_plan(q_shape, (9, 16, kh, 128), c, n_sm)
             for q_shape in ((b, h, 128), (b, 1, h, 128), (b, 4, h, 128))}
    assert plans == {DA.split_plan(b, kh, h // kh, c, n_sm)}
    (s, L), = plans
    assert 1 <= s <= DA.MAX_SPLITS and L % DA.TILE_KEYS == 0
    assert s * L >= c > (s - 1) * L


def test_table_split_plan_at_the_serve_shapes():
    """llama2-7b x 4 slots on an H100's 132 SMs: 4 splits of 128 keys at
    the paged serve's 512-key tables and 5 of 256 at the streamed serve's
    1280, for decode and verify alike; the pool's block size does not
    enter."""
    for kq in (1, 4):
        for bs in (8, 16, 32):
            pool = (100, bs, 32, 128)
            assert PA.table_split_plan((4, kq, 32, 128), pool, 512, 132) \
                == (4, 128)
            assert PA.table_split_plan((4, kq, 32, 128), pool, 1280, 132) \
                == (5, 256)


def _split_merge_f64(x, splits, split_len, window=None, softcap=None):
    """The kernel's rule in float64: each split of ``split_len`` logical
    keys forms its own (m, l, acc) -- a split a row sees nothing of keeps
    m = -1e30, l = 0 -- and the splits merge with weights exp(m_s - M),
    out = sum w_s acc_s / max(sum w_s l_s, 1e-30)."""
    q = x["q"].astype(np.float64)                          # [B, KQ, H, D]
    b, kq, h, d = q.shape
    n_pool, bs, kh = x["k_pool"].shape[:3]
    g = h // kh
    c = x["key_pos"].shape[1]
    table = x["bt"][:, :c // bs]
    mapped = (table >= 0) & (table < n_pool)
    read = np.where(mapped, table, n_pool - 1)
    k = x["k_pool"][read].reshape(b, c, kh, d).astype(np.float64)
    v = x["v_pool"][read].reshape(b, c, kh, d).astype(np.float64)
    kp = x["key_pos"].astype(np.int64)
    qpos = x["pos"].astype(np.int64)[:, None] + np.arange(kq)   # [B, KQ]
    see = ((kp >= 0) & np.repeat(mapped, bs, axis=1))[:, None] \
        & (kp[:, None] <= qpos[..., None])                      # [B, KQ, C]
    if window is not None:
        see &= kp[:, None] > qpos[..., None] - window
    s = np.einsum("bikgd,bckd->bikgc", q.reshape(b, kq, kh, g, d), k) \
        / math.sqrt(d)
    if softcap is not None:
        s = softcap * np.tanh(s / softcap)
    see = np.broadcast_to(see[:, :, None, None], s.shape)
    ms, ls, accs = [], [], []
    for i in range(splits):
        lo, hi = i * split_len, min((i + 1) * split_len, c)
        vis = see[..., lo:hi]
        m = np.where(vis.any(-1),
                     np.where(vis, s[..., lo:hi], -np.inf).max(-1), -1e30)
        p = np.exp(np.where(vis, s[..., lo:hi] - m[..., None], -np.inf))
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(np.einsum("bikgc,bckd->bikgd", p, v[:, lo:hi]))
    m_all = np.max(ms, axis=0)
    w = [np.exp(m - m_all) for m in ms]
    l_all = sum(wi * li for wi, li in zip(w, ls))
    acc = sum(wi[..., None] * ai for wi, ai in zip(w, accs))
    return (acc / np.maximum(l_all, 1e-30)[..., None]).reshape(b, kq, h, d)


SPLIT_CASES = {
    # paged_case arguments but kq, and the options: S > 1 splits on 132 SMs
    "6 of 8 splits masked": ((1, 4, 2, 32, 16, 32, (100,)), {}, {}),
    "wrapped ring, window 40 in one split": (
        (1, 4, 2, 32, 16, 32, (1,)), dict(last=1000), dict(window=40)),
    "fully masked row through the merge": (
        (2, 4, 2, 32, 16, 16, (200, 5)), dict(dead=(1,)), {}),
    "block size 8, holes inside splits, softcap": (
        (2, 8, 2, 64, 8, 40, (300, 77)), dict(holes=((0, 3), (0, 12))),
        dict(softcap=30.0)),
}
SPLIT_MERGE_CASES = {**{k: (v, {}, {}) for k, v in CASES.items()},
                     **SPLIT_CASES}


@pytest.mark.parametrize("kq", [1, 4])
@pytest.mark.parametrize("case", sorted(SPLIT_MERGE_CASES))
def test_split_merge_rule_matches_plain_and_pallas(case, kq):
    """The split-and-merge rule of the kernel, in float64 at the plan the
    wrapper takes on 132 SMs, equals the plain version and the
    interpret-mode Pallas kernels, also where whole splits are masked."""
    shape, case_kw, opts = SPLIT_MERGE_CASES[case]
    x = _case(*shape, kq=kq, seed=34, **case_kw)
    splits, split_len = PA.table_split_plan(
        x["q"].shape, x["k_pool"].shape, x["key_pos"].shape[1], 132)
    if case in SPLIT_CASES:
        assert splits > 1
        if "masked" in case or "window" in case:
            assert splits >= 4
    got = _split_merge_f64(x, splits, split_len, **opts)
    plain = _torch(PA.paged_attention_plain, x, **opts)
    np.testing.assert_allclose(got, plain, **TOL)
    # the rows that the GPU tests poison (with NaN) are rows no query may
    # see: a finite poison leaves the plain version's output as it was
    np.testing.assert_array_equal(
        _torch(PA.paged_attention_plain,
               poison_unread(x, opts.get("window"), 1e6), **opts), plain)
    # the reference reads an unmapped entry's keys from the scratch block
    # and counts on key_pos to hide them; the port masks them by the table
    bs = x["k_pool"].shape[1]
    unmapped = np.repeat(x["bt"] < 0, bs, axis=1)[:, :x["key_pos"].shape[1]]
    hidden = dict(x, key_pos=np.where(unmapped, -1, x["key_pos"]))
    np.testing.assert_allclose(got, _jax(hidden, **opts), **TOL)
