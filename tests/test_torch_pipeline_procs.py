"""The stage ring across processes (``repro_torch.core.stage_procs``) on
the CPU, in float32, with the reference's own weights: qwen3-0.6b (tied
embedding) and llama2-70b (untied head, two query heads a K/V head), both
reduced to 6 layers, as in ``tests/test_torch_pipeline.py``.

- tick logits of the process ring equal the ring in one process's at
  ``DECODE_TOL`` on rings of 4 stages over (1, 2, 2, 1) and (0, 1, 2, 3)
  (a stage without layers) and of 2 over (2, 4), on both cache layouts,
  through dead ticks, a killed micro-batch and a reset; each micro-batch
  fed at tick t completes at tick ``t + n_stages - 1``;
- the vocab-sharded tick, on processes and in one process, against the
  reference's ``pipeline_decode_tick(vocab_sharded=True)`` (run in a
  subprocess with four faked XLA devices) at the reference's own 2e-3, and
  against the port's plain tick at ``DECODE_TOL``; ``V % n_stages != 0``
  raises;
- faults: a stage that raises, and a stage that dies, make the host raise
  within its timeout, naming the stage; after ``close()`` no stage process
  is left.

The serves on processes are held in ``tests/test_torch_pipeline_procs_serve.py``.
Rings are spawned once a module and shared by the cases their options
allow; every wait has a timeout.
"""
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.core.stage_procs import (StageProcError,  # noqa: E402
                                          StageProcs, stage_params,
                                          vocab_bytes)

torch.set_num_threads(2)

DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
#: the reference's own tolerance for its vocab-sharded tick against its
#: plain one (tests/test_pipeline_runtime.py)
REFERENCE_TOL = dict(rtol=2e-3, atol=2e-3)
#: seconds any wait on the stages may take before the host raises
TIMEOUT = 60
M, MAX_LEN, BS = 4, 32, 4
N_BLOCKS = M * (MAX_LEN // BS)
#: (arch, periods per stage) of each tick ring
RINGS = [("qwen3-0.6b", (1, 2, 2, 1)), ("qwen3-0.6b", (0, 1, 2, 3)),
         ("llama2-70b", (2, 4))]
#: the vocab-sharded tick: llama2-70b's untied head over four stages
VOCAB_ARCH, VOCAB_SIZES, VOCAB_TICKS = "llama2-70b", (1, 2, 2, 1), 16

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg = jax_get_config(arch).reduced(n_layers=6)
        tcfg = get_config(arch).reduced(n_layers=6)
        if arch == "llama2-70b":          # 70B groups 8 query heads a K/V
            jcfg = dataclasses.replace(jcfg, n_kv_heads=2)
            tcfg = dataclasses.replace(tcfg, n_kv_heads=2)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _MODELS[arch] = (tcfg, tparams)
    return _MODELS[arch]


_RINGS = {}


def _procs(arch, sizes, layout="contiguous", vocab_sharded=False):
    """The module's process ring of these options, spawned at first use."""
    key = (arch, sizes, layout, vocab_sharded)
    if key not in _RINGS:
        tcfg, tparams = _model(arch)
        _RINGS[key] = StageProcs(
            tcfg, tparams, PL.PipelineSpec(len(sizes), sizes), n_slots=M,
            max_len=MAX_LEN, cache_dtype=torch.float32, cache_layout=layout,
            num_blocks=N_BLOCKS, block_size=BS, impl="cuda", device="cpu",
            vocab_sharded=vocab_sharded, timeout=TIMEOUT)
    return _RINGS[key]


def _local(arch, sizes, layout="contiguous", vocab_sharded=False):
    tcfg, tparams = _model(arch)
    spec = PL.PipelineSpec(len(sizes), sizes)
    return PL.StageRing(tcfg, tparams, spec, PL.init_pipeline_decode_state(
        tcfg, spec, M, MAX_LEN, torch.float32, layout, N_BLOCKS, BS, "cpu"),
        impl="cuda", vocab_sharded=vocab_sharded)


def _schedule(vocab, n_ticks, seed):
    """Per tick: the fed token and whether it is live, and the slot
    operations issued before it (a kill and a reset of slot 2 mid-run)."""
    rng = np.random.default_rng(seed)
    feeds = rng.integers(0, vocab, n_ticks)
    live = rng.random(n_ticks) > 0.2
    ops = {n_ticks // 2: [("kill_slot", 2)],
           n_ticks // 2 + 1: [("reset_slot", 2)]}
    return feeds, live, ops


def _drive(ring, feeds, live, ops, table=None):
    """Each tick's completed micro-batch and a copy of its logits."""
    if table is not None:
        ring.push_table(table)
    rounds = [0] * M
    out = []
    for t, (feed, valid) in enumerate(zip(feeds, live)):
        for name, slot in ops.get(t, ()):
            getattr(ring, name)(slot)
            if name == "reset_slot":
                rounds[slot] = 0
        slot = ring.state.tick % M
        done = ring.tick(int(feed), bool(valid), rounds[slot])
        rounds[slot] += bool(valid)
        out.append((done, None if done is None
                    else ring.state.logits_out[done].clone().numpy()))
    return out


@pytest.fixture(scope="module", autouse=True)
def reference_vocab_ticks(tmp_path_factory):
    """The reference's vocab-sharded and plain ticks over the seeded feeds,
    in a subprocess with four faked XLA devices (started with the module,
    read at the test's)."""
    out = tmp_path_factory.mktemp("reference") / "ticks.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_TICKS, VOCAB_ARCH,
         json.dumps(VOCAB_SIZES), str(VOCAB_TICKS), str(M), str(MAX_LEN),
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def result():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        return dict(np.load(out))
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


_REFERENCE_TICKS = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core import pipeline as PL
from repro.models import transformer as T
arch, sizes, n, m, max_len, out = (sys.argv[1], json.loads(sys.argv[2]),
                                   *map(int, sys.argv[3:6]), sys.argv[6])
cfg = get_config(arch).reduced(n_layers=6)
if arch == "llama2-70b":
    cfg = dataclasses.replace(cfg, n_kv_heads=2)
params, _ = T.init_params(cfg, jax.random.PRNGKey(0))
spec = PL.PipelineSpec(len(sizes), tuple(sizes))
stage_params, mask = PL.stack_stage_params(cfg, params, spec)
mesh = jax.make_mesh((1, len(sizes)), ("data", "model"))
feeds = np.random.default_rng(7).integers(0, cfg.vocab_size, n)
res = {}
with mesh:
    for vs in (False, True):
        tick = jax.jit(lambda state, feed, vs=vs: PL.pipeline_decode_tick(
            cfg, stage_params, mask, state, feed, spec, mesh,
            vocab_sharded=vs))
        state = PL.init_pipeline_decode_state(cfg, spec, m, 1, max_len,
                                              dtype=jnp.float32)
        rows = []
        for t in range(n):
            state = tick(state, jnp.asarray(feeds[t:t + 1], jnp.int32))
            done = (t - (spec.n_stages - 1)) % m
            rows.append(np.asarray(state.logits_out[done, 0], np.float32))
        res["sharded" if vs else "plain"] = np.stack(rows)
        res["ready_" + str(vs)] = np.asarray(state.token_ready)
np.savez(out, feeds=feeds, **res)
"""


# --------------------------------------------------------------------------- #
# tick logits
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch,sizes", RINGS, ids=str)
def test_tick_logits_equal_the_ring_in_one_process(arch, sizes, layout):
    """Seeded feeds with dead ticks, a killed micro-batch and a reset
    through the process ring and the ring in one process: the same
    micro-batch completes at every tick (the one fed ``n_stages - 1`` ticks
    before, when live), with logits equal at ``DECODE_TOL``."""
    tcfg, _ = _model(arch)
    ns = len(sizes)
    feeds, live, ops = _schedule(tcfg.vocab_size, 8 * M + ns, seed=len(sizes))
    table = np.arange(N_BLOCKS, dtype=np.int32).reshape(M, -1) \
        if layout == "paged" else None
    ring = _procs(arch, sizes, layout)
    got = _drive(ring, feeds, live, ops, table)
    want = _drive(_local(arch, sizes, layout), feeds, live, ops, table)
    kill = len(feeds) // 2           # slot 2's feeds still in flight die
    for t, ((done, logits), (want_done, want_logits)) in enumerate(
            zip(got, want)):
        fed = t - (ns - 1)
        killed = fed % M == 2 and kill - (ns - 1) <= fed < kill
        expect = fed % M if fed >= 0 and live[fed] and not killed else None
        assert done == want_done == expect, t
        if done is not None:
            np.testing.assert_allclose(logits, want_logits, **DECODE_TOL)
    assert sum(d is not None for d, _ in got) > 2 * M
    assert ring.state.tick == len(feeds)
    assert all(p.is_alive() for p in ring.procs)


# --------------------------------------------------------------------------- #
# the vocab-sharded tick
# --------------------------------------------------------------------------- #

def _vocab_ticks(ring, feeds):
    """Every tick fed: the completed logits row of each tick, [n, V]."""
    out = []
    rounds = [0] * M
    for t, feed in enumerate(feeds):
        slot = ring.state.tick % M
        ring.tick(int(feed), True, rounds[slot])
        rounds[slot] += 1
        done = (t - (ring.spec.n_stages - 1)) % M
        out.append(ring.state.logits_out[done].clone().numpy())
    return np.stack(out), ring.state.token_ready.copy()


def test_vocab_sharded_tick_matches_the_reference(reference_vocab_ticks):
    """The reference's vocab-sharded tick (``psum`` of masked partial rows,
    a broadcast hidden, each stage's columns) against the port's, on four
    stage processes and in one process, at the reference's 2e-3; each
    against the port's plain tick at ``DECODE_TOL``; ``token_ready``
    equal.  The shard a stage holds is a quarter of the vocabulary
    weights."""
    ref = reference_vocab_ticks()
    feeds = ref["feeds"]
    tcfg, tparams = _model(VOCAB_ARCH)
    plain, ready = _vocab_ticks(_local(VOCAB_ARCH, VOCAB_SIZES), feeds)
    procs = _procs(VOCAB_ARCH, VOCAB_SIZES, vocab_sharded=True)
    for ring in (procs, _local(VOCAB_ARCH, VOCAB_SIZES, vocab_sharded=True)):
        got, got_ready = _vocab_ticks(ring, feeds)
        np.testing.assert_array_equal(got_ready, ready)
        np.testing.assert_array_equal(got_ready, ref["ready_True"])
        np.testing.assert_allclose(got, ref["sharded"], **REFERENCE_TOL)
        np.testing.assert_allclose(got, plain, **DECODE_TOL)
    np.testing.assert_allclose(plain, ref["plain"], **REFERENCE_TOL)
    assert len(np.unique(plain[len(VOCAB_SIZES) - 1:].argmax(-1))) > 2
    whole = vocab_bytes(tparams)
    assert [s["vocab_bytes"] for s in procs.stats()] == \
        [whole // len(VOCAB_SIZES)] * len(VOCAB_SIZES)


def test_vocab_sharded_tied_embedding_in_one_process():
    """A tied embedding's head is the shard's rows transposed: qwen3-0.6b's
    vocab-sharded tick in one process equals its plain tick."""
    tcfg, tparams = _model("qwen3-0.6b")
    assert tcfg.tie_embeddings
    feeds = np.random.default_rng(3).integers(0, tcfg.vocab_size, 12)
    plain, ready = _vocab_ticks(_local("qwen3-0.6b", (1, 2, 2, 1)), feeds)
    got, got_ready = _vocab_ticks(
        _local("qwen3-0.6b", (1, 2, 2, 1), vocab_sharded=True), feeds)
    np.testing.assert_array_equal(got_ready, ready)
    np.testing.assert_allclose(got, plain, **DECODE_TOL)
    spec = PL.PipelineSpec(4, (1, 2, 2, 1))
    shards = [stage_params(tcfg, tparams, spec, s, True) for s in range(4)]
    assert all(torch.equal(p["head"], p["embedding"].T) for p in shards)
    assert sum(vocab_bytes(p) for p in shards) == vocab_bytes(tparams)


def test_vocab_sharded_needs_a_whole_shard_a_stage():
    tcfg, tparams = _model("qwen3-0.6b")
    spec = PL.PipelineSpec(3, (2, 2, 2))
    assert tcfg.vocab_size % 3
    before = set(multiprocessing.active_children())
    with pytest.raises(ValueError, match="vocab_size % n_stages"):
        StageProcs(tcfg, tparams, spec, n_slots=3, max_len=MAX_LEN,
                   cache_dtype=torch.float32, device="cpu",
                   vocab_sharded=True)
    assert set(multiprocessing.active_children()) == before
    state = PL.init_pipeline_decode_state(tcfg, spec, 3, MAX_LEN,
                                          torch.float32, device="cpu")
    with pytest.raises(ValueError, match="vocab_size % n_stages"):
        PL.pipeline_decode_tick(tcfg, tparams, state, torch.tensor([1]),
                                spec, vocab_sharded=True)


# --------------------------------------------------------------------------- #
# faults
# --------------------------------------------------------------------------- #

def test_a_stage_that_raises_raises_in_the_host():
    """Stage 0's embedding lookup of a token outside the vocabulary raises
    there: the host raises within its timeout with stage 0's traceback,
    every stage has exited, and the ring refuses further ticks."""
    tcfg, _ = _model("llama2-70b")
    ring = _procs("llama2-70b", (2, 4))
    ring.tick(5, True, 0)
    t0 = time.monotonic()
    with pytest.raises(StageProcError, match="stage process 0") as err:
        ring.tick(tcfg.vocab_size + 7, True, 0)
    assert time.monotonic() - t0 < TIMEOUT
    assert err.value.rank == 0 and "IndexError" in str(err.value)
    assert all(p.exitcode is not None for p in ring.procs)
    with pytest.raises(StageProcError, match="closed"):
        ring.tick(5, True, 0)
    ring.close()                                    # idempotent


def test_a_stage_that_dies_raises_in_the_host():
    """A stage killed between ticks: the next tick raises, naming it."""
    ring = _procs("llama2-70b", (2, 4), "paged")
    ring.procs[1].kill()
    ring.procs[1].join(TIMEOUT)
    t0 = time.monotonic()
    with pytest.raises(StageProcError, match="stage process 1") as err:
        ring.tick(0, False, 0)                       # stage 0 idles
    assert time.monotonic() - t0 < TIMEOUT and err.value.rank == 1
    assert all(p.exitcode is not None for p in ring.procs)


def test_close_leaves_no_stage_process():
    """Every ring of the module closed (twice: ``close`` is idempotent):
    no child process is left."""
    for ring in _RINGS.values():
        ring.close()
        ring.close()
    assert multiprocessing.active_children() == []
