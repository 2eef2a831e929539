"""Serving on the stage ring across processes (``LLM.from_plan(...,
stage_procs=True)``: one process a planned stage) against the JAX package
on the CPU, in float32, with the reference's own weights.

- qwen3-0.6b reduced to 6 layers (planned over four chips: uneven stages)
  on the contiguous layout with more requests than slots; on the paged
  layout, one ring with the prefix cache and a pool
  small enough to preempt serving prompts with a shared prefix plainly,
  with ``spec_k=4`` and an oracle draft (rollbacks), and in chunks (prefix
  hits throughout) -- each serve's greedy tokens equal to the JAX
  ``TensorBackend``'s;
- xlstm-1.3b reduced to 8 layers (recurrent state on the ring) on both
  layouts against the reference's ``PipelineBackend`` (in a subprocess with
  four faked XLA devices), and musicgen-large reduced to 2 layers
  (sinusoidal positions, stages (0, 1, 1, 0): stage 0 holds no layer, so
  the fed token's position comes from the host) against the port's
  ``TensorBackend``;
- the launcher's ``--stage-procs`` prints ``--mode tp``'s ``req`` lines.

Each backend is closed after its serves; every wait has a timeout.
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

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import TensorBackend as JaxTensorBackend  # noqa: E402
from repro.serving import LLM as JaxLLM  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.devices import tpu_pod_cluster  # noqa: E402
from repro_torch.core.profile import Workload  # noqa: E402
from repro_torch.core.stage_procs import StageProcs  # noqa: E402
from repro_torch.runtime import TensorBackend  # noqa: E402
from repro_torch.serving import (LLM, ContinuousBatcher,  # noqa: E402
                                 OracleDraft, Request, SamplingParams)

torch.set_num_threads(2)
MAX_LEN, BS = 48, 8
SERVE_LENS = (5, 17, 9, 12, 3, 8, 14)
#: prompts past a shared 16-token prefix, long enough to preempt
PAGED_LENS = (12, 20, 9, 16, 14, 18)
#: the reference's pipeline over xlstm-1.3b's one 8-block period
XLSTM, XLSTM_LAYERS, XLSTM_LENS = "xlstm-1.3b", 8, (6, 9, 4, 7, 5)
MUSICGEN = "musicgen-large"

_MODELS = {}


def _model(arch, n_layers=6):
    key = (arch, n_layers)
    if key not in _MODELS:
        jcfg = jax_get_config(arch).reduced(n_layers=n_layers)
        tcfg = get_config(arch).reduced(n_layers=n_layers)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _MODELS[key] = (jcfg, tcfg, jparams, tparams)
    return _MODELS[key]


def _prompts(cfg, lens, seed=1, shared=0):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, cfg.vocab_size, shared).astype(np.int32)
    return [np.concatenate([pre, rng.integers(0, cfg.vocab_size, n)
                            .astype(np.int32)]) for n in lens]


def _reference_tokens(arch, prompts, max_tokens, layout, n_layers=6):
    """Greedy tokens of the JAX TensorBackend."""
    jcfg, _, jparams, _ = _model(arch, n_layers)
    jllm = JaxLLM.from_backend(JaxTensorBackend(
        jcfg, jparams, n_slots=3, max_len=MAX_LEN, impl="xla",
        cache_layout=layout, block_size=BS))
    return [o.tokens for o in jllm.generate(
        prompts, JaxSamplingParams(max_tokens=max_tokens))]


def _from_plan(arch, layout, n_layers=6, **kw):
    """``LLM.from_plan`` over four chips with one process a stage."""
    _, tcfg, _, tparams = _model(arch, n_layers)
    llm = LLM.from_plan(tcfg, tpu_pod_cluster(n_chips=4),
                        Workload(dtype_bytes=2), objective="throughput",
                        kind="pipeline", params=tparams, max_len=MAX_LEN,
                        cache_layout=layout, block_size=BS, impl="cuda",
                        device="cpu", stage_procs=True, **kw)
    assert isinstance(llm.backend.ring, StageProcs)
    return llm


def _serve(be, prompts, max_tokens, **kw):
    """Greedy tokens of one batcher serve (uid = prompt index), its
    stats."""
    b = ContinuousBatcher(be, **kw)
    sp = SamplingParams(max_tokens=max_tokens)
    for uid, p in enumerate(prompts):
        b.submit(Request(p, sp, uid=uid))
    done = b.run()
    return [done[u].generated for u in range(len(prompts))], b.stats


@pytest.fixture(scope="module", autouse=True)
def reference_xlstm_pipeline(tmp_path_factory):
    """The reference's ``PipelineBackend`` under ``LLM.from_plan`` for
    xlstm-1.3b on both layouts, in a subprocess with four faked XLA devices
    (started with the module, read at the test's)."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_PIPELINE, XLSTM,
         str(XLSTM_LAYERS), json.dumps(XLSTM_LENS), str(MAX_LEN), str(BS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    result = {}

    def read():
        if not result:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            result.update(json.loads(out.splitlines()[-1]))
        return result
    yield read
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


_REFERENCE_PIPELINE = """
import json, sys
import jax, numpy as np
from repro.configs import get_config
from repro.core.devices import tpu_pod_cluster
from repro.core.profile import Workload
from repro.models import transformer as T
from repro.serving import LLM, SamplingParams
arch, n, lens, max_len, bs = (sys.argv[1], int(sys.argv[2]),
                              json.loads(sys.argv[3]), int(sys.argv[4]),
                              int(sys.argv[5]))
cfg = get_config(arch).reduced(n_layers=n)
params, _ = T.init_params(cfg, jax.random.PRNGKey(0))
rng = np.random.default_rng(1)
prompts = [rng.integers(0, cfg.vocab_size, k).astype(np.int32) for k in lens]
out = {}
for layout in ("contiguous", "paged"):
    llm = LLM.from_plan(cfg, tpu_pod_cluster(n_chips=4),
                        Workload(dtype_bytes=2), objective="throughput",
                        kind="pipeline", params=params, max_len=max_len,
                        cache_layout=layout, block_size=bs, impl="xla")
    out[layout] = {
        "tokens": [o.tokens for o in llm.generate(
            prompts, SamplingParams(max_tokens=5))],
        "stages": list(llm.backend.spec.periods_per_stage)}
print(json.dumps(out))
"""


# --------------------------------------------------------------------------- #
# qwen3-0.6b: the planned stages on both layouts
# --------------------------------------------------------------------------- #

def test_contiguous_serves_equal_tensor_backend():
    """More requests than slots: the JAX ``TensorBackend``'s tokens; each
    stage's counters follow the ticks (a hop a live tick, the last stage
    none)."""
    _, tcfg, _, _ = _model("qwen3-0.6b")
    llm = _from_plan("qwen3-0.6b", "contiguous")
    be = llm.backend
    try:
        spec = be.spec
        assert spec.n_stages == 4 and len(set(spec.periods_per_stage)) > 1
        assert be.n_slots < len(SERVE_LENS)
        prompts = _prompts(tcfg, SERVE_LENS)
        want = _reference_tokens("qwen3-0.6b", prompts, 8, "contiguous")
        got = llm.generate(prompts, SamplingParams(max_tokens=8))
        assert [o.tokens for o in got] == want
        stats = be.ring.stats()
        assert [s["ticks"] for s in stats] == [be.state.tick] * 4
        assert stats[0]["live"] > stats[0]["ticks"] // 2
        assert all(s["hop_bytes"] == s["live"] * tcfg.d_model * 4
                   for s in stats[:-1]) and stats[-1]["hop_bytes"] == 0
    finally:
        be.close()
    assert not any(p.is_alive() for p in be.ring.procs)


def test_paged_serves_preempt_verify_and_adopt_prefixes():
    """One paged ring of four stage processes with the prefix cache and a
    pool of 10 blocks of 8 (4 slots), over prompts sharing a 16-token
    prefix: a serve streamed in chunks of 8 on the fresh pool (preemptions
    and prefix hits), a plain serve, and a ``spec_k=4`` serve whose oracle
    draft is right 3 times in 4 (accepted drafts and rollbacks) -- each the
    JAX ``TensorBackend``'s tokens, every block back in the pool after
    each."""
    _, tcfg, _, _ = _model("qwen3-0.6b")
    llm = _from_plan("qwen3-0.6b", "paged", n_slots=4, num_blocks=10,
                     prefix_cache=True)
    be = llm.backend
    try:
        assert be.info.spec_decode and be.info.prefix_caching
        prompts = _prompts(tcfg, PAGED_LENS, shared=16)
        want = _reference_tokens("qwen3-0.6b", prompts, 6, "paged")
        oracle = OracleDraft(dict(enumerate(want)), accept_prob=0.75,
                             seed=1, vocab_size=tcfg.vocab_size)
        chunked, plain, spec = (
            _serve(be, prompts, 6, **kw)
            for kw in (dict(prefill_chunk=8), {},
                       dict(spec_k=4, draft=oracle)))
        for got, _ in (chunked, plain, spec):
            assert got == want
            assert be.pager.free_blocks == be.pager.total_blocks
        assert 0 < spec[1].spec_accepted < spec[1].spec_drafted
        assert spec[1].decode_steps < plain[1].decode_steps
        st = chunked[1]
        assert st.preemptions > 0 and st.prefix_hits > 0, st
        assert st.prefill_chunks > len(prompts)
    finally:
        be.close()


# --------------------------------------------------------------------------- #
# the recurrent and the sinusoidal configs
# --------------------------------------------------------------------------- #

def test_musicgen_equals_tensor_backend():
    """Stage 0 holds no layer of the 2-layer stack, so the host sends the
    fed token's position for the sinusoidal embedding: the tokens of the
    port's ``TensorBackend`` (which ``tests/test_torch_frontends.py`` holds
    to the JAX package's)."""
    _, tcfg, _, tparams = _model(MUSICGEN, 2)
    prompts = _prompts(tcfg, SERVE_LENS[:5])
    want = [o.tokens for o in LLM.from_backend(TensorBackend(
        tcfg, tparams, n_slots=3, max_len=MAX_LEN, impl="cuda",
        device="cpu")).generate(prompts, SamplingParams(max_tokens=6))]
    llm = _from_plan(MUSICGEN, "contiguous", 2)
    try:
        assert llm.backend.spec.periods_per_stage == (0, 1, 1, 0)
        got = llm.generate(prompts, SamplingParams(max_tokens=6))
        assert [o.tokens for o in got] == want
    finally:
        llm.backend.close()


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #

def test_launcher_stage_procs_equals_tp(capsys):
    """``--stage-procs`` serves the planned stages one a process and prints
    ``--mode tp``'s ``req`` lines; its stages have exited when it returns;
    without ``--mode pipeline`` it is refused."""
    from repro_torch.launch.serve import main
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch",
            "5", "--varlen", "--prompt-len", "12", "--gen", "6", "--impl",
            "cuda"]

    def tokens(out):
        return [line.split(")", 1)[1] for line in out.splitlines()
                if line.startswith("  req ")]

    main(argv)
    tp = capsys.readouterr().out
    llm, _ = main(argv + ["--mode", "pipeline", "--stages", "4",
                          "--stage-procs"])
    procs = capsys.readouterr().out
    assert "(0, 1, 1, 0) (one process a stage)" in procs
    assert tokens(procs) == tokens(tp) and len(tokens(tp)) == 4
    assert not any(p.is_alive() for p in llm.backend.ring.procs)
    with pytest.raises(SystemExit):
        main(argv + ["--stage-procs"])
    assert "--stage-procs runs the planned stages" in capsys.readouterr().err
    assert multiprocessing.active_children() == []


def test_stage_procs_is_for_the_pipeline():
    from repro_torch.runtime import from_deployment
    from repro_torch.core.planner import plan_deployment
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    cluster = tpu_pod_cluster(n_chips=4)
    dep = plan_deployment(tcfg, cluster, Workload(dtype_bytes=2))
    with pytest.raises(ValueError, match="stage_procs"):
        from_deployment(dep, cluster, tcfg, kind="tensor", params=tparams,
                        device="cpu", stage_procs=True)


def test_no_gpu_raises_before_spawning(monkeypatch):
    """Without ``device="cpu"`` the process ring raises where there is no
    GPU, as every entry point does, and starts no process."""
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLM.from_plan(tcfg, tpu_pod_cluster(n_chips=4),
                      Workload(dtype_bytes=2), kind="pipeline",
                      params=tparams, stage_procs=True)
    assert multiprocessing.active_children() == []


# --------------------------------------------------------------------------- #
# last, so the reference's subprocess has run beside the other tests
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_xlstm_equals_reference_pipeline(layout, reference_xlstm_pipeline):
    """The mLSTM and sLSTM state rows of each micro-batch live on their
    stage's process (the paged layout an empty pool): the planned stages
    and greedy tokens equal the reference's ``PipelineBackend``'s, with
    more requests than slots."""
    want = reference_xlstm_pipeline()[layout]
    _, tcfg, _, _ = _model(XLSTM, XLSTM_LAYERS)
    llm = _from_plan(XLSTM, layout, XLSTM_LAYERS)
    try:
        assert list(llm.backend.spec.periods_per_stage) == want["stages"]
        got = llm.generate(_prompts(tcfg, XLSTM_LENS),
                           SamplingParams(max_tokens=5))
        assert [o.tokens for o in got] == want["tokens"]
        assert len({t for ts in want["tokens"] for t in ts}) > 4
    finally:
        llm.backend.close()
