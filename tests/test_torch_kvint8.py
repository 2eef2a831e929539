"""The port's int8 KV cache against the JAX package, on the CPU, with the
reference's own weights (float32 activations, int8 K/V with float32
per-(token, head) scales).

- ``_quantize_kv`` equal to the reference's bit for bit (ties at .5 round
  half to even) and the reference's round-trip property (error <=
  amax/254 + 1e-6);
- the reduced qwen3-0.6b and gemma2-2b ``+kvint8``: prefill plus four
  greedy decode steps on both layouts, logits within rtol = atol = 2e-4 of
  the reference's int8 run, greedy tokens equal, int8 leaves equal and
  really int8; and the reference's own check that the int8 cache tracks a
  float cache (rtol 0.1, atol 0.15, argmax equal);
- ``extend_step`` and ``verify_step`` over int8 pools;
- greedy tokens of the port's ``TensorBackend`` and ``PipelineBackend`` on
  both layouts equal to the reference ``TensorBackend``'s;
- ``impl="cuda"`` over a paged int8 cache reads by gather, as the
  reference's ``"pallas"`` does: ``attn_impl`` says ``"ref"``, one warning
  a process, a ``ValueError`` under ``REPRO_STRICT_IMPL``;
- the serve launcher's ``--kvint8``.
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import TensorBackend as JaxTensorBackend  # noqa: E402
from repro.serving import LLM as JaxLLM  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.devices import tpu_pod_cluster  # noqa: E402
from repro_torch.core.profile import Workload  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import TensorBackend  # noqa: E402
from repro_torch.serving import LLM, SamplingParams  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
#: the reference's test_kvint8_decode_matches_bf16
INT8_VS_FLOAT = dict(rtol=0.1, atol=0.15)
ARCHS = ["qwen3-0.6b", "gemma2-2b"]
LAYOUTS = ["contiguous", "paged"]
#: the port's read of a paged int8 cache under impl="cuda"
GATHER_WARNING = "ignore:impl='cuda' with kv_dtype='int8'"

_MODELS = {}


def _model(arch, kv_dtype="int8"):
    key = (arch, kv_dtype)
    if key not in _MODELS:
        jcfg = dataclasses.replace(jax_get_config(arch).reduced(n_layers=2),
                                   kv_dtype=kv_dtype)
        tcfg = dataclasses.replace(get_config(arch).reduced(n_layers=2),
                                   kv_dtype=kv_dtype)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _MODELS[key] = (jcfg, tcfg, jparams, tparams)
    return _MODELS[key]


# --------------------------------------------------------------------------- #
# the quantizer
# --------------------------------------------------------------------------- #

def _quant_inputs():
    r = np.random.default_rng(0)
    x = (r.standard_normal((3, 5, 4, 16)) *
         r.choice([1e-3, 0.5, 7.0, 300.0], (3, 5, 4, 1))).astype(np.float32)
    # a head vector with amax 127 has scale 1 exactly: its .5 values are
    # ties, rounded half to even (2.5 -> 2, -3.5 -> -4, 0.5 -> 0)
    x[0, 0, 0] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -2.5, 126.5, -126.5,
                  3.49, 0.0, 4.5, 5.5, -5.5, 64.5, -127.0]
    x[0, 0, 1] = 0.0                    # amax 0: the scale's 1e-6 floor
    x[0, 0, 2, :8] = 1e-9
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_equals_reference(dtype):
    x = _quant_inputs()
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(dtype)
    q8, scale = TA._quantize_kv(xt)
    jq8, jscale = JA._quantize_kv(xj)
    assert q8.dtype == torch.int8 and scale.dtype == torch.float32
    assert torch.equal(q8, torch.from_numpy(np.array(jq8)))
    assert torch.equal(scale, torch.from_numpy(np.array(jscale)))
    if dtype == "float32":
        assert q8[0, 0, 0, :9].tolist() == [127, 2, -4, 0, 0, 2, -2, 126,
                                            -126]
    back = TA._dequantize_kv(q8, scale, torch.float32)
    jback = JA._dequantize_kv(jq8, jscale, jnp.float32)
    assert torch.equal(back, torch.from_numpy(np.array(jback)))


def test_kv_quantizer_roundtrip_property():
    """The reference's property, on the port's quantizer: per-(token,
    head) absmax int8 keeps every element within amax/254 + 1e-6."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=30, deadline=None)
    @hypothesis.given(st.integers(0, 2**31 - 1), st.floats(1e-3, 1e3))
    def body(seed, scale):
        x = torch.from_numpy(
            np.random.default_rng(seed).standard_normal((2, 3, 2, 16))
            .astype(np.float32)) * scale
        q8, s = TA._quantize_kv(x)
        assert q8.dtype == torch.int8
        back = TA._dequantize_kv(q8, s, torch.float32)
        amax = x.abs().amax(dim=-1, keepdim=True)
        err = (back - x).abs()
        assert bool((err <= amax / 254 + 1e-6).all()), \
            float((err / amax).max())

    body()


# --------------------------------------------------------------------------- #
# prefill and decode
# --------------------------------------------------------------------------- #

def _prompts(vocab, lens=(8, 5), seed=1):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, n).astype(np.int32) for n in lens]


def _padded(prompts):
    width = max(len(p) for p in prompts)
    out = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        out[i, width - len(p):] = p
    return out, np.asarray([len(p) for p in prompts], np.int32)


def _backend_run(be, prompts, steps=4, after=None):
    """Prefill every prompt in one wave, then ``steps`` greedy decode
    steps: the logits [steps + 1, B, V] and the greedy tokens.  ``after``
    runs after every call."""
    padded, lens = _padded(prompts)
    slots = list(range(len(prompts)))
    evs = be.prefill(slots, padded, lens)
    rows = [np.stack([ev.logits for ev in evs])]
    for _ in range(steps):
        if after is not None:
            after()
        nxt = rows[-1].argmax(-1)
        evs = be.decode_step({s: int(nxt[s]) for s in slots})
        rows.append(np.stack([ev.logits for ev in evs]))
    if after is not None:
        after()
    logits = np.stack(rows)
    return logits, logits.argmax(-1)


def _reference_layer(caches, cfg, i, slot_axis=False):
    """Layer ``i``'s leaves of the reference's stacked caches as numpy:
    ``caches["stack"]["p<p>"]`` with a leading period axis, behind a slot
    axis and a batch axis of 1 in a contiguous ``TensorBackend``'s
    (``slot_axis``)."""
    r, p = divmod(i, cfg.period)
    tree = caches["stack"][f"p{p}"]
    if slot_axis:
        return {k: np.asarray(v)[:, r, 0] for k, v in tree.items()}
    return {k: np.asarray(v)[r] for k, v in tree.items()}


def _entry_owners(layer, key):
    """The slot and position owning each [.., ..] entry of the leading two
    axes of ``layer[key]`` (-1 where none): a ring's [slot, ring slot] by
    ``key_pos``, a pool's [block, offset] by the block table."""
    if not key.endswith("_pool"):
        kp = layer["key_pos"]
        return np.broadcast_to(np.arange(kp.shape[0])[:, None], kp.shape), kp
    nb, bs = layer[key].shape[:2]
    slot = np.full((nb, bs), -1)
    pos = np.full((nb, bs), -1)
    for b, j in np.argwhere(layer["bt"] >= 0):
        slot[layer["bt"][b, j]] = b
        pos[layer["bt"][b, j]] = j * bs + np.arange(bs)
    return slot, pos


def _hold_and_sync(port_caches, reference_layers, tally):
    """Hold the port's cache leaves to the reference's, then set them to
    the reference's, in place; return the (slot, position) of every int8
    code that differed.

    K/V that differ by float32 rounding in the last place (matmuls summed
    in another order) can land on either side of a rounding tie, one code
    apart: ``tally`` counts those codes and all codes held.  A chunk
    attends its own codes, so a code that differed moves the same call's
    later K/V of its slot by a quantization step's share: their scales
    are held at 1e-3 and their codes at one apart, every other scale at
    1e-5.  Positions and tables are held exactly.  Pad writes are copied
    but not held: a ring's entries at ``key_pos == -1`` and the pool's
    scratch block.  The copy keeps a differing code from compounding over
    the calls that follow."""
    flipped = set()
    for layer, want_layer in zip(port_caches, reference_layers):
        for k in ("k", "v", "k_pool", "v_pool"):
            if k in layer:
                slot, pos = _entry_owners(want_layer, k)
                d = np.abs(layer[k].numpy().astype(np.int32)
                           - want_layer[k]).max(axis=(2, 3))
                held = pos >= 0
                assert d[held].max() <= 1, (k, d[held].max())
                flipped |= {(int(slot[i]), int(pos[i]))
                            for i in map(tuple, np.argwhere(held & (d > 0)))}
    for layer, want_layer in zip(port_caches, reference_layers):
        assert set(layer) == set(want_layer)
        for k, t in layer.items():
            want = want_layer[k]
            if t.dtype == torch.int32:
                np.testing.assert_array_equal(t.numpy(), want)
            elif k in TA._SCALE.values():
                slot, pos = _entry_owners(want_layer, k)
                near = np.zeros(pos.shape, bool)
                for fs, fp in flipped:
                    near |= (slot == fs) & (pos >= fp)
                for mask, rtol in ((pos >= 0) & ~near, 1e-5), (near, 1e-3):
                    np.testing.assert_allclose(t.numpy()[mask], want[mask],
                                               rtol=rtol, atol=1e-9)
            elif t.dtype == torch.int8:
                slot, pos = _entry_owners(want_layer, k)
                d = t.numpy()[pos >= 0].astype(np.int32) != want[pos >= 0]
                tally[0] += int(d.sum())
                tally[1] += d.size
            t.copy_(torch.from_numpy(np.array(want)))
    return flipped


def _hold_logits(got, want, positions, flipped):
    """Logits [B, Q, V] of queries at ``positions`` [B, Q] (-1: not fed):
    argmax equal where fed; within 2e-4 where the query attends no int8
    code that differed this call (:func:`_hold_and_sync`), and within the
    reference's int8-against-float bound where it does (one code step is
    a quantization error)."""
    for b in range(got.shape[0]):
        for q in range(got.shape[1]):
            p = positions[b][q]
            if p < 0:
                continue
            np.testing.assert_array_equal(got[b, q].argmax(), want[b, q]
                                          .argmax())
            touched = any(s == b and fp <= p for s, fp in flipped)
            np.testing.assert_allclose(got[b, q], want[b, q],
                                       **(INT8_VS_FLOAT if touched else TOL))


def _lockstep(jbe, be, prompts, layout, steps=4):
    """Prefill and ``steps`` greedy decode steps on both backends, call by
    call, each call starting from the reference's cache state and its
    logits held by :func:`_hold_logits` (a prefill attends its own float
    K/V, so no int8 code touches its logits); returns the tally of int8
    codes."""
    padded, lens = _padded(prompts)
    slots = list(range(len(prompts)))
    tally = [0, 0]
    cfg = be.cfg
    pos = np.asarray(lens) - 1

    def call(run_port, run_reference, positions):
        want = np.stack([ev.logits for ev in run_reference()])[:, None]
        with torch.no_grad():
            got = np.stack([ev.logits for ev in run_port()])[:, None]
        flipped = _hold_and_sync(be.caches, [
            _reference_layer(jbe.caches, cfg, i, layout == "contiguous")
            for i in range(cfg.n_layers)], tally)
        _hold_logits(got, want, positions[:, None],
                     flipped if positions is not pos else set())
        return want[:, 0].argmax(-1)

    nxt = call(lambda: be.prefill(slots, padded, lens),
               lambda: jbe.prefill(slots, padded, lens), pos)
    for t in range(steps):
        feeds = {s: int(nxt[s]) for s in slots}
        nxt = call(lambda: be.decode_step(feeds),
                   lambda: jbe.decode_step(feeds), pos + 1 + t)
    return tally


@pytest.mark.filterwarnings(GATHER_WARNING)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_prefill_decode_matches_reference(arch, impl, layout):
    """Backends on each layout, prompts of 8 and 5 (gemma2's reduced
    local window is 16), in lockstep from the same cache state at every
    call (:func:`_lockstep`): logits at 2e-4 but where an int8 code fell
    on the other side of a rounding tie (at most one code in a thousand),
    greedy tokens equal, and the caches really int8."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    jbe = JaxTensorBackend(jcfg, jparams, n_slots=2, max_len=32, impl="xla",
                           cache_layout=layout, block_size=8)
    be = TensorBackend(tcfg, tparams, n_slots=2, max_len=32, impl=impl,
                       cache_layout=layout, block_size=8, device="cpu")
    flips, codes = _lockstep(jbe, be, _prompts(tcfg.vocab_size), layout)
    assert flips <= codes // 1000, (flips, codes)
    kv = "k_pool" if layout == "paged" else "k"
    for cache in be.caches:
        assert cache[kv].dtype == torch.int8
        assert cache[kv.replace("k", "v", 1)].dtype == torch.int8
        assert cache[TA._SCALE[kv]].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_ring_leaves_equal_reference(arch):
    """Model level: ``forward(mode="prefill")`` over int8 rings and four
    greedy decode steps, in lockstep from the reference's ring state at
    every call (:func:`_hold_and_sync`): logits at 2e-4, argmax equal, the
    rings' int8 codes, scales and positions held after every call."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    tokens = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    tally = [0, 0]

    def reference_layers():
        return [_reference_layer(jc, jcfg, i) for i in range(tcfg.n_layers)]

    jc = JT.init_caches(jcfg, 2, 32, jnp.float32)
    tc = TT.init_caches(tcfg, 2, 32, torch.float32, "cpu")
    jl, jc, _ = JT.forward(jcfg, jparams, jnp.asarray(tokens),
                           mode="prefill", caches=jc)
    with torch.no_grad():
        tl, tc = TT.forward(tcfg, tparams, torch.from_numpy(tokens).long(),
                            tc)
    _hold_and_sync(tc, reference_layers(), tally)
    # the prefill attends its own float K/V: no int8 code touches it
    _hold_logits(tl.numpy(), np.asarray(jl), np.tile(np.arange(8), (2, 1)),
                 set())
    for step in range(4):
        nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32) \
            if step == 0 else np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jc = JT.decode_step(jcfg, jparams, jnp.asarray(nxt), jc)
        with torch.no_grad():
            tl, tc = TT.decode_step(tcfg, tparams,
                                    torch.from_numpy(nxt).long(), tc)
        flipped = _hold_and_sync(tc, reference_layers(), tally)
        _hold_logits(tl.numpy()[:, None], np.asarray(jl)[:, None],
                     np.full((2, 1), 8 + step), flipped)
    assert tally[0] <= tally[1] // 1000, tally
    assert all(c["k"].dtype == torch.int8 for c in tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_tracks_float_cache(arch):
    """The reference's own check, on the port: decode logits over the int8
    cache track those over a float32 cache, argmax equal step by step."""
    _, cfg8, _, params = _model(arch)
    cfg = dataclasses.replace(cfg8, kv_dtype="bfloat16")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8))).long()

    def run(c):
        caches = TT.init_caches(c, 2, 32, torch.float32, "cpu")
        with torch.no_grad():
            logits, caches = TT.forward(c, params, tokens, caches)
            outs = [logits[:, -1]]
            for _ in range(4):
                logits, caches = TT.decode_step(c, params,
                                                outs[-1].argmax(-1), caches)
                outs.append(logits)
        return torch.stack(outs).numpy(), caches

    ref, _ = run(cfg)
    got, c8 = run(cfg8)
    assert {t.dtype for c in c8 for t in c.values()} >= {torch.int8}
    np.testing.assert_allclose(got, ref, **INT8_VS_FLOAT)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.filterwarnings(GATHER_WARNING)
@pytest.mark.parametrize("impl,jimpl", [("ref", "xla"), ("cuda", "pallas"),
                                        ("chunked", "chunked")])
def test_int8_extend_and_verify_match_reference(impl, jimpl):
    """Paged int8 pools from empty: two ``extend_step`` chunks (slot 0: 10
    then 12 tokens across a block boundary, slot 1: 5 then a left-padded
    3, slot 2 idle), then a ``verify_step`` of 3, 1 and 0 tokens, in
    lockstep from the reference's pool state at every call
    (:func:`_hold_and_sync`).  Logits at the fed columns held by
    :func:`_hold_logits` (a chunk attends its own int8 codes); int8 pool
    blocks, positions and tables held after each call."""
    jcfg, tcfg, jparams, tparams = _model("qwen3-0.6b")
    jc = JT.init_paged_caches(jcfg, 3, 40, 8, 16, jnp.float32)
    tc = TT.init_paged_caches(tcfg, 3, 40, 8, 16, torch.float32, "cpu")
    table = np.asarray([[5, 2, -1], [0, 7, -1], [-1, -1, -1]], np.int32)
    jc["stack"]["p0"]["bt"] = jnp.broadcast_to(
        jnp.asarray(table), jc["stack"]["p0"]["bt"].shape)
    for layer in tc:
        layer["bt"].copy_(torch.from_numpy(table))
    r = np.random.default_rng(4)

    tally = [0, 0]

    def check(tl, jl, positions):
        assert all(c["k_pool"].dtype == torch.int8 for c in tc)
        flipped = _hold_and_sync(tc, [_reference_layer(jc, jcfg, i)
                                      for i in range(tcfg.n_layers)], tally)
        _hold_logits(tl.numpy(), np.asarray(jl), positions, flipped)

    for starts, lens in (((0, 0, 0), (10, 5, 0)), ((10, 5, 0), (12, 3, 0))):
        tok = r.integers(0, tcfg.vocab_size, (3, 12)).astype(np.int32)
        starts, lens = (np.asarray(a, np.int32) for a in (starts, lens))
        jl, jc = JT.extend_step(jcfg, jparams, jnp.asarray(tok), jc,
                                jnp.asarray(starts), jnp.asarray(lens),
                                impl=jimpl)
        with torch.no_grad():
            tl, tc = TT.extend_step(tcfg, tparams,
                                    torch.from_numpy(tok).long(), tc,
                                    torch.from_numpy(starts),
                                    torch.from_numpy(lens), impl=impl)
        cols = np.arange(12)[None]
        check(tl, jl, np.where(cols >= (12 - lens)[:, None],
                               starts[:, None] + cols - (12 - lens)[:, None],
                               -1))
    tok = r.integers(0, tcfg.vocab_size, (3, 3)).astype(np.int32)
    lens = np.asarray([3, 1, 0], np.int32)
    jl, jc = JT.verify_step(jcfg, jparams, jnp.asarray(tok), jc,
                            jnp.asarray(lens),
                            impl=jimpl)
    with torch.no_grad():
        tl, tc = TT.verify_step(tcfg, tparams, torch.from_numpy(tok).long(),
                                tc, torch.from_numpy(lens), impl=impl)
    cols = np.arange(3)[None]
    check(tl, jl, np.where(cols < lens[:, None],
                           np.asarray([22, 8, 0])[:, None] + cols, -1))
    assert tc[0]["pos"].tolist() == [25, 9, 0]
    assert tally[0] <= tally[1] // 1000, tally


# --------------------------------------------------------------------------- #
# the backends
# --------------------------------------------------------------------------- #

LENS = (6, 11, 4, 9, 13)
_REFERENCE_TOKENS = {}


def _reference_tokens(layout):
    if layout not in _REFERENCE_TOKENS:
        jcfg, _, jparams, _ = _model("qwen3-0.6b")
        be = JaxTensorBackend(jcfg, jparams, n_slots=3, max_len=40,
                              impl="xla", cache_layout=layout, block_size=8)
        outs = JaxLLM.from_backend(be).generate(
            _prompts(jcfg.vocab_size, LENS), JaxSamplingParams(max_tokens=6))
        _REFERENCE_TOKENS[layout] = [o.tokens for o in outs]
    return _REFERENCE_TOKENS[layout]


@pytest.mark.filterwarnings(GATHER_WARNING)
@pytest.mark.parametrize("kind", ["tensor", "pipeline"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_backends_int8_tokens_equal_reference(layout, kind):
    """Five requests over three slots, six greedy tokens each: the port's
    ``TensorBackend`` and its planned stage pipeline (``LLM.from_plan``
    over four chips) give the reference ``TensorBackend``'s tokens."""
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    want = _reference_tokens(layout)
    if kind == "tensor":
        be = TensorBackend(tcfg, tparams, n_slots=3, max_len=40, impl="cuda",
                           cache_layout=layout, block_size=8, device="cpu")
        llm = LLM.from_backend(be)
    else:
        llm = LLM.from_plan(tcfg, tpu_pod_cluster(n_chips=4),
                            Workload(dtype_bytes=2), objective="throughput",
                            kind="pipeline", params=tparams, max_len=40,
                            cache_layout=layout, block_size=8, impl="cuda",
                            device="cpu")
        kv = "k_pool" if layout == "paged" else "k"
        assert all(c[kv].dtype == torch.int8 for c in llm.backend.state.caches)
    got = llm.generate(_prompts(tcfg.vocab_size, LENS),
                       SamplingParams(max_tokens=6))
    assert [o.tokens for o in got] == want
    assert llm.backend.info.attn_impl == \
        ("ref" if layout == "paged" else "plain")


def test_paged_int8_reports_ref_warns_once_and_raises_strict(monkeypatch):
    """The reference's ``"pallas"`` over an int8 pool reports ``"xla"``;
    the port's ``"cuda"`` reports ``"ref"`` (the contiguous int8 ring and a
    float pool keep the kernels: ``"plain"`` on the CPU), warns once a
    process however many steps run, and raises under
    ``REPRO_STRICT_IMPL``."""
    jcfg, tcfg, _, tparams = _model("qwen3-0.6b")
    assert JA.effective_decode_impl("pallas", jcfg) == "xla"
    assert TA.effective_decode_impl("cuda", tcfg, "cpu", "paged") == "ref"
    assert TA.effective_decode_impl("cuda", tcfg, "cpu") == "plain"
    assert TA.effective_decode_impl("ref", tcfg, "cpu", "paged") == "ref"
    assert TA.effective_decode_impl(
        "cuda", dataclasses.replace(tcfg, kv_dtype="bfloat16"), "cpu",
        "paged") == "plain"
    monkeypatch.delenv("REPRO_STRICT_IMPL", raising=False)
    monkeypatch.setattr(TA, "_INT8_CUDA_NOTED", False)
    prompts = _prompts(tcfg.vocab_size)

    def backend():
        return TensorBackend(tcfg, tparams, n_slots=2, max_len=32,
                             impl="cuda", cache_layout="paged", block_size=8,
                             device="cpu")

    be = backend()
    assert be.info.attn_impl == "ref"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.no_grad():
            _backend_run(be, prompts)
            _backend_run(backend(), prompts)
    notes = [w for w in caught if issubclass(w.category, RuntimeWarning)
             and "kv_dtype='int8'" in str(w.message)]
    assert len(notes) == 1, [str(w.message) for w in caught]
    monkeypatch.setenv("REPRO_STRICT_IMPL", "1")
    with pytest.raises(ValueError, match="REPRO_STRICT_IMPL"):
        with torch.no_grad():
            _backend_run(backend(), prompts)


@pytest.mark.filterwarnings(GATHER_WARNING)
def test_serve_launcher_kvint8(capsys):
    """``--kvint8`` serves int8 caches on both layouts with the same greedy
    tokens; the paged layout reports the gather."""
    from repro_torch.launch.serve import main
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch",
            "5", "--slots", "3", "--varlen", "--prompt-len", "12", "--gen",
            "6", "--impl", "cuda", "--kvint8"]

    def tokens(out):
        return [line.split(")", 1)[1] for line in out.splitlines()
                if line.startswith("  req ")]

    llm, _ = main(argv)
    ring = capsys.readouterr().out
    assert "served 5 requests" in ring and "attn_impl=plain" in ring
    assert llm.backend.caches[0]["k"].dtype == torch.int8
    assert llm.backend.cfg.kv_dtype == "int8"
    llm, _ = main(argv + ["--cache-layout", "paged", "--block-size", "8"])
    paged = capsys.readouterr().out
    assert "served 5 requests" in paged and "attn_impl=ref" in paged
    assert llm.backend.caches[0]["k_pool"].dtype == torch.int8
    assert tokens(paged) == tokens(ring) and len(tokens(ring)) == 4
