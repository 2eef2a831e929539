"""The tensor-parallel ``TensorBackend`` (``TensorBackend(..., mesh=...)``:
one process a point of a ``(1, N)`` mesh, each serving its shard of the
heads, ``ff``, vocabulary and K/V cache) against the JAX package on the
CPU, in float32, with the reference's own weights.

- qwen3-0.6b reduced to 4 layers on (1, 2) and (1, 4) meshes, contiguous
  and paged (blocks of 8): 5 prompts of 3-13 tokens x 5 greedy tokens,
  bit for bit the reference ``TensorBackend``'s, plain and on an ``Auto``
  (1, 4) mesh (in a subprocess with 8 faked XLA devices);
- on the paged layout: a pool small enough to preempt, ``spec_k=4``, the
  prefix cache with chunked prefill -- each serve's tokens the one-process
  backend's, its preemptions, drafts and prefix hits the same;
- each process's K/V bytes 1/N of one process's, ``info``'s sums;
  processes whose slots disagree raise; a mesh with data replicas, or a
  mesh for the pipeline kind, is refused; without ``device="cpu"`` it
  raises before spawning where there is no GPU;
- the launcher's ``--devices 2`` prints the ``req`` lines of one process.

Each backend is spawned once, closed after its serves, and no child
process is left.
"""
import json
import multiprocessing
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.devices import tpu_pod_cluster  # noqa: E402
from repro_torch.core.planner import plan_deployment  # noqa: E402
from repro_torch.core.profile import Workload  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.runtime import PoolExhausted, TensorBackend  # noqa: E402
from repro_torch.runtime import from_deployment  # noqa: E402
from repro_torch.runtime.tensor import MeshTensorBackend  # noqa: E402
from repro_torch.serving import LLM, SamplingParams  # noqa: E402

torch.set_num_threads(2)
ARCH, LAYERS = "qwen3-0.6b", 4
SLOTS, MAX_LEN, BS, TOKENS = 3, 32, 8, 5
LENS = (3, 7, 13, 5, 9)
#: prompts past a shared 16-token prefix, for the prefix cache
SHARED, PAGED_LENS = 16, (4, 9, 2, 7, 5)
TIMEOUT = 60

_REFERENCE = r"""
import json, sys
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import transformer as T
from repro.runtime import TensorBackend
from repro.serving import LLM, SamplingParams
arch, layers, slots, max_len, bs, n = sys.argv[1], *map(int, sys.argv[2:7])
prompts = [np.asarray(p, np.int32) for p in json.loads(sys.argv[7])]
cfg = get_config(arch).reduced(n_layers=layers)
params, _ = T.init_params(cfg, jax.random.PRNGKey(0))
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:4])
out = {}
for layout in ("contiguous", "paged"):
    for name, m in (("plain", None), ("mesh", mesh)):
        llm = LLM.from_backend(TensorBackend(
            cfg, params, n_slots=slots, max_len=max_len, mesh=m, impl="xla",
            cache_layout=layout, block_size=bs))
        out[f"{layout}/{name}"] = [
            [int(t) for t in o.tokens]
            for o in llm.generate(prompts, SamplingParams(max_tokens=n))]
print(json.dumps(out))
"""


def _prompts(cfg, lens, shared=0, seed=1):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, cfg.vocab_size, shared).astype(np.int32)
    return [np.concatenate([pre, rng.integers(0, cfg.vocab_size, n)
                            .astype(np.int32)]) for n in lens]


_STATE = {}


def _model():
    if "model" not in _STATE:
        jcfg = jax_get_config(ARCH).reduced(n_layers=LAYERS)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tcfg = get_config(ARCH).reduced(n_layers=LAYERS)
        _STATE["model"] = (tcfg, params_from_numpy(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    return _STATE["model"]


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's greedy tokens, from a subprocess with 8 faked XLA
    devices started with the module and read at the first test that
    needs them."""
    cfg, _ = _model()
    prompts = [p.tolist() for p in _prompts(cfg, LENS)]
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, ARCH, str(LAYERS), str(SLOTS),
         str(MAX_LEN), str(BS), str(TOKENS), json.dumps(prompts)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = {}

    def result():
        if not done:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            done.update(json.loads(out.splitlines()[-1]))
        return done
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _backend(n, **kw):
    """A tensor-parallel backend on a (1, n) mesh of CPU processes."""
    cfg, params = _model()
    return TensorBackend(cfg, params, SLOTS, MAX_LEN,
                         Mesh(("data", "model"), (1, n)), device="cpu",
                         timeout=TIMEOUT, **kw)


def _serve(be, prompts, **kw):
    llm = LLM.from_backend(be, **kw)
    outs = llm.generate(prompts, SamplingParams(max_tokens=TOKENS))
    return [list(o.tokens) for o in outs], llm.stats


def _one_process(prompts, **kw):
    cfg, params = _model()
    serve_kw = {k: kw.pop(k) for k in ("spec_k", "prefill_chunk")
                if k in kw}
    return _serve(TensorBackend(cfg, params, n_slots=SLOTS, max_len=MAX_LEN,
                                device="cpu", **kw), prompts, **serve_kw)


# --------------------------------------------------------------------------- #
# the paged layout's pool, drafts and prefix cache
# --------------------------------------------------------------------------- #

def test_a_pool_that_preempts_verifies_drafts_like_one_process():
    """A pool of 6 blocks of 4 over 3 slots: the batcher preempts, the
    processes' pagers stay in step, ``spec_k=4`` verifies and rolls
    back; tokens and counters the one-process backend's.  A wave the pool
    cannot hold raises :class:`PoolExhausted` here, nothing allocated."""
    cfg, _ = _model()
    prompts = _prompts(cfg, LENS)
    kw = dict(cache_layout="paged", block_size=4, num_blocks=6)
    want, want_stats = _one_process(prompts, spec_k=4, **kw)
    be = _backend(2, **kw)
    try:
        got, stats = _serve(be, prompts, spec_k=4)
        with pytest.raises(PoolExhausted):
            be.prefill([0, 1, 2], np.zeros((3, MAX_LEN), np.int32))
        assert be.info.free_blocks == be.info.total_blocks == 6
    finally:
        be.close()
    assert got == want
    assert stats.preemptions == want_stats.preemptions > 0
    assert (stats.spec_drafted, stats.spec_accepted) == \
        (want_stats.spec_drafted, want_stats.spec_accepted)


def test_prefix_cache_and_chunks_like_one_process():
    """Prompts sharing a 16-token prefix through the prefix cache in
    chunks of 4: the same hits, chunk passes and tokens as one process."""
    cfg, _ = _model()
    prompts = _prompts(cfg, PAGED_LENS, shared=SHARED)
    kw = dict(cache_layout="paged", block_size=BS, prefix_cache=True)
    want, want_stats = _one_process(prompts, prefill_chunk=4, **kw)
    be = _backend(4, **kw)
    try:
        got, stats = _serve(be, prompts, prefill_chunk=4)
        assert be.info.prefix_hits == want_stats.prefix_hits > 0
    finally:
        be.close()
    assert got == want
    assert (stats.prefix_hits, stats.prefix_hit_tokens,
            stats.prefill_chunks) == (want_stats.prefix_hits,
                                      want_stats.prefix_hit_tokens,
                                      want_stats.prefill_chunks)


def test_processes_out_of_step_raise():
    """A process whose slot positions differ from the others' makes the
    next call raise, naming the method."""
    be = _backend(2)
    try:
        be.procs.run(ranks.shift_position, 0)
        with pytest.raises(RuntimeError, match="free_slot.*differ"):
            be.free_slot(0)
    finally:
        be.close()


# --------------------------------------------------------------------------- #
# refusals, the factory and the launcher
# --------------------------------------------------------------------------- #

def test_refusals_spawn_nothing(monkeypatch):
    """Data replicas are not served; the pipeline kind takes no mesh;
    without ``device="cpu"`` the card is the default and its absence
    raises before any process starts."""
    cfg, params = _model()
    with pytest.raises(ValueError, match=r"\(1, N\) mesh"):
        TensorBackend(cfg, params, SLOTS, MAX_LEN,
                      Mesh(("data", "model"), (2, 2)), device="cpu")
    cluster = tpu_pod_cluster(n_chips=4)
    dep = plan_deployment(cfg, cluster, Workload(dtype_bytes=2))
    with pytest.raises(ValueError, match="takes none"):
        from_deployment(dep, cluster, cfg, kind="pipeline", params=params,
                        device="cpu", mesh=Mesh(("data", "model"), (1, 2)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TensorBackend(cfg, params, SLOTS, MAX_LEN,
                      Mesh(("data", "model"), (1, 2)))
    assert multiprocessing.active_children() == []


def test_launcher_devices_prints_the_same_req_lines(capsys):
    """``--devices 2`` serves on a (1, 2) mesh of processes and prints the
    ``req`` lines of the one-process serve; its processes have exited when
    it returns; pipeline mode refuses it."""
    from repro_torch.launch.serve import main
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch",
            "5", "--slots", "3", "--varlen", "--prompt-len", "12", "--gen",
            "6", "--impl", "cuda"]

    def tokens(out):
        return [line.split(")", 1)[1] for line in out.splitlines()
                if line.startswith("  req ")]

    main(argv)
    one = capsys.readouterr().out
    llm, _ = main(argv + ["--devices", "2"])
    tp = capsys.readouterr().out
    assert "mesh of 2 processes" in tp
    assert tokens(tp) == tokens(one) and len(tokens(one)) == 4
    assert not any(p.is_alive() for p in llm.backend.procs.procs)
    with pytest.raises(SystemExit):
        main(argv + ["--devices", "2", "--mode", "pipeline"])
    assert "--devices is tp mode's" in capsys.readouterr().err
    assert multiprocessing.active_children() == []


# --------------------------------------------------------------------------- #
# the reference's tokens (last, so its subprocess has run beside the
# other tests)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_tokens_equal_the_reference(layout, n, reference):
    """Greedy tokens bit for bit the reference's ``TensorBackend``'s, plain
    and on its (1, 4) mesh; each process holds 1/n of one process's K/V
    bytes, and ``info`` sums the processes' cache bytes and counts the
    weights once.  On the paged layout the backend then serves the same
    prompts with ``spec_k=4``: the same tokens."""
    cfg, params = _model()
    prompts = _prompts(cfg, LENS)
    ref = reference()
    assert ref[f"{layout}/plain"] == ref[f"{layout}/mesh"]
    kw = dict(cache_layout=layout, block_size=BS)
    be = _backend(n, **kw)
    try:
        assert isinstance(be, MeshTensorBackend)
        got, _ = _serve(be, prompts)
        assert got == ref[f"{layout}/plain"]
        one = TensorBackend(cfg, params, n_slots=SLOTS, max_len=MAX_LEN,
                            device="cpu", **kw)
        kv = ranks.cache_kv_bytes(one.caches)
        assert be.procs.run(ranks.kv_bytes) == [kv // n] * n
        info, want = be.info, one.info
        assert info.param_bytes == want.param_bytes
        assert info.bytes_per_block == (want.bytes_per_block if layout ==
                                        "paged" else 0)
        assert info.cache_bytes_per_slot >= want.cache_bytes_per_slot
        assert (info.n_slots, info.total_blocks, info.attn_impl) == \
            (want.n_slots, want.total_blocks, want.attn_impl)
        if layout == "paged":
            spec, stats = _serve(be, prompts, spec_k=4)
            assert spec == got and stats.spec_drafted > 0
    finally:
        be.close()
    assert not any(p.is_alive() for p in be.procs.procs)


def test_factory_passes_the_mesh(reference):
    """``from_deployment(kind="tensor", mesh=...)`` builds the
    tensor-parallel backend; its tokens are the reference's."""
    cfg, params = _model()
    cluster = tpu_pod_cluster(n_chips=4)
    dep = plan_deployment(cfg, cluster, Workload(dtype_bytes=2))
    be = from_deployment(dep, cluster, cfg, kind="tensor", params=params,
                         n_slots=SLOTS, max_len=MAX_LEN, device="cpu",
                         mesh=Mesh(("data", "model"), (1, 2)))
    try:
        assert isinstance(be, MeshTensorBackend)
        got, _ = _serve(be, _prompts(cfg, LENS))
    finally:
        be.close()
    assert got == reference()["contiguous/plain"]
