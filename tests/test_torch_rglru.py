"""The port's RG-LRU slice against the JAX package, in float32 on the CPU:
the scan kernel's wrapper (its plain version on CPU tensors), the model's
doubling scan, the RG-LRU block, the reduced recurrentgemma-2b (one period
of rglru, rglru, local attention plus a tail of two rglru blocks), and
serving it through ``LLM`` on the contiguous layout.

Inputs come from numpy with a seed, or the reference's own weights bridged
with ``params_from_numpy``, and go to both packages.  Tolerances: the scan
at 1e-5 (``tests/test_kernels.py``'s scan tolerance), blocks and logits at
2e-4 (its RG-LRU block tolerance: float32 products summed in another order
by another library); greedy tokens bit-identical.  ``impl="ref"`` is held
against the reference's ``"xla"`` path, ``impl="cuda"`` against
``"pallas"`` (interpret mode on the CPU).  The kernel itself runs only on a
GPU: ``tests/test_torch_cuda.py``.
"""
import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.models import kvcache as JKV  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import TensorBackend  # noqa: E402
from repro.serving import LLM as JaxLLM  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import init_params, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import rglru_scan as RS  # noqa: E402
from repro_torch.models import kvcache as TKV  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import TorchTensorBackend  # noqa: E402
from repro_torch.serving import LLM, SamplingParams  # noqa: E402

torch.set_num_threads(2)
ARCH = "recurrentgemma-2b"
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=2e-4, atol=2e-4)
IMPLS = [("ref", "xla"), ("cuda", "pallas")]
# the shapes of tests/test_kernels.py's scan test: R=200 is ragged
SCAN_SHAPES = [(1, 16, 128), (2, 33, 200), (4, 7, 64), (1, 128, 384)]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _scan_inputs(b, s, r, seed=5):
    rng = np.random.default_rng(seed)
    log_a = -np.abs(rng.standard_normal((b, s, r))).astype(np.float32)
    bb = rng.standard_normal((b, s, r)).astype(np.float32)
    h0 = rng.standard_normal((b, r)).astype(np.float32)
    return log_a, bb, h0


# --------------------------------------------------------------------------- #
# the scan
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("b,s,r", SCAN_SHAPES)
def test_scan_wrapper_matches_pallas_and_ref(b, s, r):
    """The wrapper on CPU tensors (the plain version) against the Pallas
    kernel in interpret mode and the sequential reference."""
    log_a, bb, h0 = _scan_inputs(b, s, r)
    want = np.asarray(ops.rglru_scan(jnp.asarray(log_a), jnp.asarray(bb),
                                     jnp.asarray(h0), interpret=True))
    seq = np.asarray(ref.rglru_scan_ref(jnp.asarray(log_a), jnp.asarray(bb),
                                        jnp.asarray(h0)))
    got = _np(RS.rglru_scan(_t(log_a), _t(bb), _t(h0)))
    np.testing.assert_allclose(got, want, **SCAN_TOL)
    np.testing.assert_allclose(got, seq, **SCAN_TOL)
    assert RS.rglru_scan.launches == 0           # CPU: the plain version


@pytest.mark.parametrize("b,s,r", SCAN_SHAPES[:2])
def test_scan_without_h0_is_zeros(b, s, r):
    log_a, bb, _ = _scan_inputs(b, s, r, seed=6)
    zeros = torch.zeros((b, r))
    for fn in (RS.rglru_scan, TR.rglru_scan):
        got = fn(_t(log_a), _t(bb), None)
        torch.testing.assert_close(got, fn(_t(log_a), _t(bb), zeros),
                                   rtol=0, atol=0)
    want = np.asarray(ops.rglru_scan(jnp.asarray(log_a), jnp.asarray(bb),
                                     None, interpret=True))
    np.testing.assert_allclose(_np(RS.rglru_scan(_t(log_a), _t(bb))), want,
                               **SCAN_TOL)


@pytest.mark.parametrize("b,s,r", SCAN_SHAPES)
@pytest.mark.parametrize("with_h0", [True, False])
def test_doubling_scan_matches_reference_scan(b, s, r, with_h0):
    """The model's ``ref`` scan (log-depth doubling in torch) against the
    reference's ``jax.lax.associative_scan`` and the plain recurrence."""
    log_a, bb, h0 = _scan_inputs(b, s, r, seed=7)
    h0 = h0 if with_h0 else None
    want = np.asarray(JR.rglru_scan(jnp.asarray(log_a), jnp.asarray(bb),
                                    None if h0 is None else jnp.asarray(h0)))
    th0 = None if h0 is None else _t(h0)
    got = TR.rglru_scan(_t(log_a), _t(bb), th0)
    np.testing.assert_allclose(_np(got), want, **SCAN_TOL)
    np.testing.assert_allclose(
        _np(got), _np(RS.rglru_scan_plain(_t(log_a), _t(bb), th0)),
        **SCAN_TOL)


def test_scan_pad_steps_leave_h_exact():
    """Identity steps (log_a = 0, b = 0), as a masked prefill's left pads
    are, keep h bit for bit in the plain version and the doubling scan."""
    log_a, bb, h0 = _scan_inputs(2, 12, 64, seed=8)
    log_a[:, :5], bb[:, :5] = 0.0, 0.0
    for fn in (RS.rglru_scan_plain, TR.rglru_scan):
        h = _np(fn(_t(log_a), _t(bb), _t(h0)))
        np.testing.assert_array_equal(h[:, :5], np.repeat(h0[:, None], 5, 1))
    plain = RS.rglru_scan_plain(_t(log_a), _t(bb), _t(h0))
    tail = RS.rglru_scan_plain(_t(log_a[:, 5:]), _t(bb[:, 5:]), _t(h0))
    assert torch.equal(plain[:, 5:], tail)


# --------------------------------------------------------------------------- #
# the kernel's launch plan (shapes and alignment only)
# --------------------------------------------------------------------------- #

# chip_smoke.py's check and timing shapes (R = 199: the 4-byte copy path;
# S = 150: three 48 KB stages), tests/test_torch_cuda.py's cases, ragged
# ones (a strip of one channel, S one past a stage, R under a strip), and
# the serve's waves of 1-4 slots
PLAN_SHAPES = [(4, s, r) for r in (2560, 200, 199) for s in (1, 7, 4096)] + [
    (4, 300, 2560), (4, 256, 2560), (2, 4096, 2560), (2, 33, 256),
    (2, 150, 2560), (4, 7, 2560), (2, 33, 200), (3, 1, 200), (1, 300, 128),
    (2, 33, 199), (2, 70, 256), (4, 130, 2560), (1, 65, 33), (3, 129, 4),
    (1, 1, 1), (5, 64, 31), (1, 4096, 2560), (3, 4096, 2560),
    (64, 200, 2560)]
H100_SMS = 132
# shared memory of an H100 SM, and what the runtime reserves a block
SM_SMEM, BLOCK_RESERVED = 228 * 1024, 1024


def _kernel_source():
    return (Path(RS.__file__).parent / "csrc" / "rglru_scan.cu").read_text()


def _kernel_text(name):
    """The right-hand side of ``constexpr int <name> = ...;`` in the
    kernel source."""
    found = re.findall(rf"constexpr int {name} = ([^;]+);", _kernel_source())
    assert len(found) == 1, name
    return found[0]


def _kernel_const(name):
    return eval(_kernel_text(name), {})             # e.g. "48 * 1024"


def _smem_limits():
    """What a block may have (227 KB), what it gets without opting in (48
    KB, static and dynamic together), and the kernel's static barriers: a
    full and an empty one for each of its stages at most."""
    assert _kernel_text("kBarrierBytes") == \
        "2 * kMaxStages * (int)sizeof(uint64_t)"
    return (_kernel_const("kSmemLimit"), _kernel_const("kSmemDefault"),
            2 * _kernel_const("kMaxStages") * 8)


@pytest.mark.parametrize("b,s,r", PLAN_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_scan_plan_covers_every_slot_channel_and_step_once(b, s, r,
                                                           aligned):
    """The blocks of the grid, as the kernel reads its block index (strip
    ``r0 = x * strip``, ``min(strip, R - r0)`` channels, slot ``y``), hold
    every (slot, channel) exactly once; the stages' tiles hold every step
    once; and the copy threads' pieces hold every (step, channel) of a tile
    once, none reaching past the strip."""
    plan = RS.scan_plan((b, s, r), aligned, H100_SMS)
    assert plan.strip == RS.STRIP == 32
    seen = np.zeros((b, r), np.int64)
    for y in range(plan.grid[1]):
        for x in range(plan.grid[0]):
            r0 = x * plan.strip
            width = min(plan.strip, r - r0)
            assert width > 0
            seen[y, r0:r0 + width] += 1
    assert (seen == 1).all()
    tiles = -(-s // plan.steps)
    rows = [min(plan.steps, s - k * plan.steps) for k in range(tiles)]
    assert all(n > 0 for n in rows) and sum(rows) == s
    assert 1 <= plan.stages <= tiles
    per_row = plan.strip // plan.vec
    for width in {min(plan.strip, r - x * plan.strip)
                  for x in range(plan.grid[0])}:
        held = np.zeros((plan.steps, plan.strip), np.int64)
        for p in range(plan.steps * per_row):
            t, c = p // per_row, p % per_row * plan.vec
            if c < width:
                assert c + plan.vec <= width     # no copy past the strip
                held[t, c:c + plan.vec] += 1
        assert (held[:, :width] == 1).all() and not held[:, width:].any()


@pytest.mark.parametrize("b,s,r", PLAN_SHAPES)
def test_scan_plan_shared_memory_fits(b, s, r):
    """The ring's stages fit the 227 KB a block may have beside the
    barriers, and the grid's blocks are all resident at once, up to 4 an
    SM (the serve's B = 4 x 80 strips is 2.4)."""
    plan = RS.scan_plan((b, s, r), True, H100_SMS)
    limit, _, barriers = _smem_limits()
    assert plan.smem_bytes == plan.stages * 2 * plan.steps * plan.strip * 4
    total = plan.smem_bytes + barriers
    assert total <= limit
    blocks = plan.grid[0] * plan.grid[1]
    per_sm = min(SM_SMEM // (total + BLOCK_RESERVED),
                 2048 // (32 * (1 + plan.copy_warps)), 32)
    assert per_sm * H100_SMS >= min(blocks, 4 * H100_SMS)


def test_scan_plan_opts_in_at_48_kb_of_ring():
    """Three stages of 64 steps (S in 129..192) make exactly 48 KB of ring:
    with the static barriers beside it the block needs more than the
    default, so the entry must opt in, or the launch is refused."""
    plan = RS.scan_plan((2, 150, 2560), True, H100_SMS)
    _, default, barriers = _smem_limits()
    assert (plan.stages, plan.smem_bytes) == (3, default)
    assert plan.smem_bytes + barriers > default
    assert re.search(r"if \(smem \+ kBarrierBytes > \(size_t\)kSmemDefault\)"
                     r" \{[^\n]*\s*const cudaError_t e = "
                     r"cudaFuncSetAttribute\(", _kernel_source())


@pytest.mark.parametrize("b,s,want", [
    (4, 4096, (32, 4, 2)), (4, 1024, (32, 4, 2)), (4, 256, (32, 4, 3)),
    (3, 4096, (32, 4, 3)), (2, 4096, (64, 4, 5)), (1, 4096, (128, 3, 7))])
def test_scan_plan_by_blocks_an_sm(b, s, want):
    """At R = 2560 (80 strips) on 132 SMs: the serve's 4 slots (2.4 blocks
    an SM) over long and short waves, 3 (1.8), the score's 2 (1.2) and 1
    (0.6) take the rows of ``PLAN_TABLE`` measured best for them."""
    plan = RS.scan_plan((b, s, 2560), True, H100_SMS)
    assert (plan.steps, plan.stages, plan.copy_warps) == want


@pytest.mark.parametrize("r", [2560, 200, 199, 128, 31, 1, 6])
@pytest.mark.parametrize("aligned", [True, False])
def test_scan_plan_takes_4_byte_copies_exactly_when_rows_are_unaligned(
        r, aligned):
    plan = RS.scan_plan((2, 100, r), aligned, H100_SMS)
    assert plan.vec == (1 if r % 4 or not aligned else 4)


@pytest.mark.parametrize("b,s,r,offset", [(4, 300, 2560, 0), (2, 33, 199, 0),
                                          (4, 300, 2560, 1), (2, 70, 256, 3),
                                          (1, 1, 1, 0)])
def test_wrapper_launches_scan_plan(monkeypatch, b, s, r, offset):
    """On a (stubbed) card the wrapper passes the C entry exactly the plan
    ``scan_plan`` gives for the inputs' shape and alignment and the card's
    SM count -- a base one float past 16 bytes takes the 4-byte copies --
    and counts one launch."""
    calls = []
    monkeypatch.setattr(RS, "on_cpu", lambda name, tensors: False)
    monkeypatch.setattr(RS, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(RS, "_launch", lambda dev, *args: calls.append(args))
    monkeypatch.setattr(RS.rglru_scan, "launches", 0)
    n = b * s * r
    log_a = torch.zeros(n + offset)[offset:].view(b, s, r)
    bb = torch.zeros((b, s, r))
    assert log_a.is_contiguous()
    assert (log_a.data_ptr() % 16 == 0) == (offset % 4 == 0)
    RS.rglru_scan(log_a, bb, torch.zeros((b, r)))
    plan = RS.scan_plan((b, s, r), offset % 4 == 0, H100_SMS)
    assert plan.vec == (4 if offset % 4 == 0 and r % 4 == 0 else 1)
    (args,) = calls
    assert args[4:] == (b, s, r, plan.strip, plan.steps, plan.stages,
                        plan.vec, plan.copy_warps)
    assert RS.rglru_scan.launches == 1


def test_plan_constants_match_the_kernel_source():
    """The plan's strip is the kernel's, its stages and copy warps within
    the kernel's, and each step is a product, then a sum, never fused."""
    assert _kernel_const("kStrip") == RS.STRIP
    for _, _, steps, stages, copy_warps in RS.PLAN_TABLE:
        assert stages <= _kernel_const("kMaxStages")
        assert 1 <= copy_warps <= _kernel_const("kMaxCopyWarps")
    assert "__fadd_rn(__fmul_rn(a[t * kStrip], h), b[t * kStrip])" in \
        _kernel_source()


# --------------------------------------------------------------------------- #
# the block
# --------------------------------------------------------------------------- #

def _model(n_layers=5):
    jcfg = jax_get_config(ARCH).reduced(n_layers=n_layers)
    tcfg = get_config(ARCH).reduced(n_layers=n_layers)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def model():
    return _model()


def _same_state(tstate, jstate, tol=TOL):
    np.testing.assert_array_equal(_np(tstate["pos"]), _np(jstate["pos"]))
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(tstate[k]), _np(jstate[k]), **tol)


@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_rglru_block_seq_and_decode(model, impl, jimpl):
    """``apply_rglru_seq`` with left pads and a state, then six
    ``apply_rglru_decode`` steps, against the reference's."""
    jcfg, tcfg, jparams, tparams = model
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["p0"]["mixer"])
    tp = tparams["layers"][0]["mixer"]
    rng = np.random.default_rng(9)
    b, s = 3, 11
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    lens = np.asarray([11, 6, 1])
    valid = np.arange(s)[None] >= (s - lens)[:, None]
    x = np.where(valid[..., None], x, 0).astype(np.float32)
    spec = jcfg.pattern[0]
    jstate = JKV.init_block_cache(jcfg, spec, b, 32, jnp.float32)
    tstate = TKV.init_block_cache(tcfg, tcfg.pattern[0], b, 32,
                                  torch.float32)
    jy, jstate = JR.apply_rglru_seq(jp, jcfg, jnp.asarray(x), jstate, jimpl,
                                    seq_valid=jnp.asarray(valid))
    with torch.no_grad():
        ty, tstate = TR.apply_rglru_seq(tp, tcfg, _t(x), tstate, impl,
                                        seq_valid=_t(valid))
    np.testing.assert_allclose(_np(ty)[valid], _np(jy)[valid], **TOL)
    _same_state(tstate, jstate)
    assert _np(tstate["pos"]).tolist() == lens.tolist()
    for _ in range(6):
        xt = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jy, jstate = JR.apply_rglru_decode(jp, jcfg, jnp.asarray(xt), jstate)
        with torch.no_grad():
            ty, tstate = TR.apply_rglru_decode(tp, tcfg, _t(xt), tstate)
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
        _same_state(tstate, jstate)


def test_rglru_block_without_state(model):
    """No state: no state back, and the same output as the reference."""
    jcfg, tcfg, jparams, tparams = model
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["p1"]["mixer"])
    x = np.random.default_rng(10).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    jy, jn = JR.apply_rglru_seq(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        ty, tn = TR.apply_rglru_seq(tparams["layers"][1]["mixer"], tcfg,
                                    _t(x))
    assert jn is None and tn is None
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)


# --------------------------------------------------------------------------- #
# params and caches
# --------------------------------------------------------------------------- #

def test_params_bridge_maps_stack_and_tail(model):
    """n_layers=5: layers 0-2 from the stacked period, 3-4 from the tail;
    init_params builds the same tree with the same shapes."""
    jcfg, tcfg, jparams, tparams = model
    assert [s.kind for s in tcfg.layer_specs()] == \
        ["rglru", "rglru", "attn", "rglru", "rglru"]
    flat = {}

    def walk(t, prefix, out):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + (k,), out)
        else:
            out[prefix] = np.asarray(t)
    walk(jparams["tail"]["t1"], (), flat)
    got = {}
    walk(tparams["layers"][4], (), got)
    assert got.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(_np(got[k]), flat[k])
    mixer1 = {k: _np(v) for k, v in tparams["layers"][1]["mixer"].items()}
    for k, v in jparams["stack"]["p1"]["mixer"].items():
        np.testing.assert_array_equal(mixer1[k], np.asarray(v)[0])

    seeded = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), tparams["layers"])
    assert jax.tree.map(lambda a: tuple(a.shape), seeded["layers"]) == shapes
    lam = seeded["layers"][0]["mixer"]["lam"]
    assert 0.3 < float(lam.std()) < 0.7                  # normal, scale 0.5
    assert not seeded["layers"][0]["mixer"]["conv_b"].any()


def test_rglru_cache_matches_reference():
    """h is float32 whatever the cache dtype; conv takes the cache dtype."""
    tcfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    t = TKV.init_block_cache(tcfg, tcfg.pattern[0], 3, 32, torch.bfloat16)
    j = JKV.init_block_cache(jcfg, jcfg.pattern[0], 3, 32, jnp.bfloat16)
    assert t.keys() == j.keys()
    for k in t:
        assert tuple(t[k].shape) == j[k].shape, k
        assert str(t[k].dtype).split(".")[1] == str(j[k].dtype), k
    assert t["h"].dtype == torch.float32 and t["conv"].dtype == torch.bfloat16


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_forward_and_decode_through_window_wrap(model, impl, jimpl):
    """Masked left-padded prefill, then 14 decode steps: the reduced window
    of 16 wraps.  Logits at real positions and every layer's state match
    the reference's."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(11)
    s, lens = 12, np.asarray([12, 7, 2], np.int32)
    tokens = rng.integers(0, tcfg.vocab_size, (3, s)).astype(np.int32)
    jl, jc, _ = JT.forward(jcfg, jparams, jnp.asarray(tokens), mode="prefill",
                           caches=JT.init_caches(jcfg, 3, 32, jnp.float32),
                           prompt_lens=jnp.asarray(lens), impl=jimpl)
    with torch.no_grad():
        tl, tc = TT.forward(tcfg, tparams, _t(tokens).long(),
                            TT.init_caches(tcfg, 3, 32, torch.float32, "cpu"),
                            prompt_lens=_t(lens), impl=impl)
    real = np.arange(s)[None] >= (s - lens)[:, None]
    np.testing.assert_allclose(_np(tl)[real], _np(jl)[real], **TOL)
    np.testing.assert_array_equal(_np(tl)[real].argmax(-1),
                                  _np(jl)[real].argmax(-1))
    step = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, t, c, impl=jimpl))
    for _ in range(14):
        tok = rng.integers(0, tcfg.vocab_size, 3).astype(np.int32)
        jl, jc = step(jparams, jnp.asarray(tok), jc)
        with torch.no_grad():
            tl, tc = TT.decode_step(tcfg, tparams, _t(tok).long(), tc,
                                    impl=impl)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        np.testing.assert_array_equal(_np(tl).argmax(-1), _np(jl).argmax(-1))
    assert _np(tc[2]["pos"]).tolist() == [26, 21, 16]     # past the window
    jlayers = [jax.tree.map(lambda a: a[0], jc["stack"][f"p{i}"])
               for i in range(3)] + [jc["tail"]["t0"], jc["tail"]["t1"]]
    for i in (0, 1, 3, 4):
        _same_state(tc[i], jlayers[i])
    np.testing.assert_array_equal(_np(tc[2]["key_pos"]),
                                  _np(jlayers[2]["key_pos"]))


def test_verify_on_a_recurrent_block_raises(model):
    _, tcfg, _, tparams = model
    caches = TT.init_caches(tcfg, 1, 32, torch.float32, "cpu")
    with pytest.raises(ValueError, match="requires attention caches"):
        TT.verify_step(tcfg, tparams, torch.zeros((1, 2), dtype=torch.long),
                       caches, torch.ones(1, dtype=torch.int32))


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #

def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


# longer than the reduced window of 16: the attention ring wraps at prefill
LENS = (18, 24, 9, 21, 17)


def test_served_greedy_tokens_bit_identical(model):
    """3 slots, 5 requests: slots recycle; prompts and generation pass the
    window."""
    jcfg, tcfg, jparams, tparams = model
    prompts = _prompts(tcfg, LENS)
    want = JaxLLM.from_backend(TensorBackend(
        jcfg, jparams, n_slots=3, max_len=48, impl="pallas")).generate(
        prompts, JaxSamplingParams(max_tokens=10))
    be = TorchTensorBackend(tcfg, tparams, n_slots=3, max_len=48,
                            impl="cuda", device="cpu")
    llm = LLM.from_backend(be)
    got = llm.generate(prompts, SamplingParams(max_tokens=10))
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, (g.uid, g.tokens, w.tokens)
        assert g.n_generated == 10
    assert llm.stats.prefills >= 2                   # a second wave recycles
    assert RS.rglru_scan.launches == 0               # CPU: the plain version


def test_served_logits_match(model):
    """Random weights repeat one token per request, so the logits are held
    too: a wave's prefill (each request's first step) and 20 decode steps
    with fixed tokens, on both backends."""
    jcfg, tcfg, jparams, tparams = model
    prompts = _prompts(tcfg, LENS[:3], seed=2)
    width = max(len(p) for p in prompts)
    padded = np.zeros((3, width), np.int32)
    for i, p in enumerate(prompts):
        padded[i, width - len(p):] = p
    lens = [len(p) for p in prompts]
    jbe = TensorBackend(jcfg, jparams, n_slots=3, max_len=48, impl="pallas")
    tbe = TorchTensorBackend(tcfg, tparams, n_slots=3, max_len=48,
                             impl="cuda", device="cpu")
    want = jbe.prefill([2, 0, 1], padded, lens)
    got = tbe.prefill([2, 0, 1], padded, lens)
    for g, w in zip(got, want):
        assert g.slot == w.slot
        np.testing.assert_allclose(g.logits, w.logits, **TOL)
    rng = np.random.default_rng(3)
    for _ in range(20):
        feeds = {s: int(t) for s, t in
                 enumerate(rng.integers(0, tcfg.vocab_size, 3))}
        for g, w in zip(tbe.decode_step(feeds), jbe.decode_step(feeds)):
            np.testing.assert_allclose(g.logits, w.logits, **TOL)


def test_backend_info_and_paged_refusal(model):
    """BackendInfo matches the JAX backend's on both layouts (the port's
    read path is named "plain" on the CPU), with the recurrent state in the
    bytes per slot and no speculative decoding; in the paged layout only
    the attention layers page, so a paged cache for an RG-LRU layer is
    refused."""
    jcfg, tcfg, jparams, tparams = model
    want = dataclasses.asdict(TensorBackend(jcfg, jparams, n_slots=2,
                                            max_len=32, impl="pallas").info)
    be = TorchTensorBackend(tcfg, tparams, n_slots=2, max_len=32, impl="cuda",
                            cache_dtype=torch.float32, device="cpu")
    got = dataclasses.asdict(be.info)
    assert got.pop("attn_impl") == "plain" and want.pop("attn_impl") == \
        "pallas"
    assert got == want
    assert not be.info.spec_decode and not be.info.supports_extend
    rnn = tcfg.rnn_dim * 4 + (tcfg.conv_width - 1) * tcfg.rnn_dim * 4 + 4
    assert be.info.cache_bytes_per_slot > 4 * rnn
    want = dataclasses.asdict(TensorBackend(
        jcfg, jparams, n_slots=2, max_len=32, impl="pallas",
        cache_layout="paged").info)
    paged = TorchTensorBackend(tcfg, tparams, n_slots=2, max_len=32,
                               impl="cuda", cache_layout="paged",
                               cache_dtype=torch.float32, device="cpu")
    got = dataclasses.asdict(paged.info)
    assert got.pop("attn_impl") == "plain" and want.pop("attn_impl") == \
        "pallas"
    assert got.pop("cache_bytes_per_slot") > 4 * rnn
    want.pop("cache_bytes_per_slot")
    assert got == want
    with pytest.raises(ValueError, match="only attention layers page"):
        TKV.init_paged_block_cache(tcfg, tcfg.pattern[0], 2, 32, 4)


def test_serve_launcher_hybrid_on_cpu(capsys):
    """``--arch recurrentgemma-2b --smoke`` serves on the CPU (slots
    recycle), on the paged layout with the contiguous serve's tokens."""
    from repro_torch.launch.serve import main
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--impl", "cuda",
            "--batch", "5", "--slots", "3", "--varlen", "--prompt-len", "24",
            "--gen", "6"]
    main(argv)
    out = capsys.readouterr().out
    assert "served 5 requests" in out and "attn_impl=plain" in out
    main(argv + ["--cache-layout", "paged"])
    paged = capsys.readouterr().out
    assert "served 5 requests" in paged

    def reqs(text):
        return [line.split("(ttft")[-1].split(")", 1)[1]
                for line in text.splitlines() if line.startswith("  req ")]
    assert reqs(paged) == reqs(out) and len(reqs(out)) == 4
