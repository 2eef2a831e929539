"""The pipeline dry run (``repro_torch.launch.dryrun_pipeline``: every stage
process run on the ``meta`` device for one tick or one forward, counted) and
the dry run of a tensor-parallel decode step, against gloo processes running
the same steps on the CPU, and the stage layout against the reference's.

- ``dp_pipeline_spec`` gives the reference's ``periods_per_stage`` exactly
  for every pipelineable arch that ``tests/test_partition.py`` selects (the
  reference's run in a subprocess, where its dry run's import may set its
  faked device count);
- one ``StageProcs`` turn of qwen3-0.6b (four stages of a layer over four
  slots), plain and vocab-sharded: each stage's hops, embedding all-reduces
  and broadcasts, calls and bytes, are its live ticks times the pipeline dry
  run's tick of that stage;
- one ``MeshTensorBackend`` decode step on (1, 2): each process's ``tp``
  tally and its collectives by kind are the dry run's decode step's;
- the record's keys, every stage's figures, the refusals (an MoE stage's
  ``moe_ragged``, a vocab-sharded prefill), and the command line on
  llama2-7b's ``decode_32k`` at full size with the planner's layout.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.core.stage_procs import StageProcs  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import dryrun_pipeline as DP  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.runtime import TensorBackend  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS, SLOTS, MAX_LEN, STAGES = 4, 4, 32, 4
TIMEOUT = 60

_REFERENCE = r"""
import json, sys
from repro.configs import ASSIGNED, get_config
from repro.launch.dryrun_pipeline import dp_pipeline_spec
out = {}
for arch in ASSIGNED:
    cfg = get_config(arch)
    if cfg.tail or cfg.n_full_periods < 4:
        continue
    try:
        out[arch] = list(dp_pipeline_spec(cfg, min(4, cfg.n_full_periods))
                         .periods_per_stage)
    except ValueError as e:
        out[arch] = str(e)
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
                XLA_FLAGS="--xla_force_host_platform_device_count=8",
                PYTHONPATH=os.path.join(ROOT, "src"))


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The reference's stage layouts and the command line's full-size run,
    in subprocesses started with the module."""
    tmp = tmp_path_factory.mktemp("dryrun_pipeline")
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, "-c", _REFERENCE], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "cli": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun_pipeline",
             "--arch", "llama2-7b", "--shape", "decode_32k", "--layout",
             "dp", "--out-dir", str(tmp)], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    done = {}

    def result(key):
        if key not in done:
            out, err = procs[key].communicate(timeout=600)
            done[key] = (procs[key].returncode, out, err, tmp)
        return done[key]
    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _model(arch="qwen3-0.6b"):
    cfg = get_config(arch).reduced(n_layers=LAYERS)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_dp_pipeline_spec_is_reference(started):
    """The planner's stage layout on a homogeneous pod slice: the
    reference's ``dp_pipeline_spec`` for every pipelineable arch (or its
    refusal where no plan fits)."""
    rc, out, err, _ = started("reference")
    assert rc == 0, err[-3000:]
    want = json.loads(out)
    got = {}
    for arch in ASSIGNED:
        cfg = get_config(arch)
        if cfg.tail or cfg.n_full_periods < 4:
            continue
        try:
            got[arch] = list(DP.dp_pipeline_spec(
                cfg, min(4, cfg.n_full_periods)).periods_per_stage)
        except ValueError as e:
            got[arch] = str(e)
    assert got == want
    assert sum(isinstance(v, list) for v in got.values()) >= 5


def _turn(ring, m, ns):
    """Every slot fed once from a reset, and the ring drained: the ticks
    of one turn (a tick a slot, then ``ns - 1`` to drain)."""
    for slot in range(m):
        ring.reset_slot(slot)
    for t in range(m + ns - 1):
        ring.tick(t % 7, t < m, 0)


@pytest.mark.parametrize("vocab_sharded", [False, True])
def test_tick_collectives_equal_stage_procs(vocab_sharded):
    """A ``StageProcs`` ring of four stage processes (qwen3-0.6b, a layer a
    stage, four slots): each stage's collectives by kind over a turn are
    its live ticks times the dry run's tick of that stage -- the hop of
    every stage but the last, and vocab-sharded the embedding's all-reduce
    on the ticks stage 0 runs and the hidden's broadcast on the ticks the
    last stage runs."""
    cfg, params = _model()
    spec = PL.even_pipeline_spec(cfg, STAGES)
    ring = StageProcs(cfg, params, spec, n_slots=SLOTS, max_len=MAX_LEN,
                      cache_dtype=torch.float32, device="cpu",
                      vocab_sharded=vocab_sharded, timeout=TIMEOUT)
    try:
        ring.zero_stats()
        _turn(ring, SLOTS, STAGES)
        stats = ring.stats()
    finally:
        ring.close()
    rec = DP.analyse_pipeline(
        cfg, InputShape("d", MAX_LEN, SLOTS, "decode"),
        Mesh(("data", "model"), (1, STAGES)), spec, SLOTS,
        vocab_sharded=vocab_sharded)
    assert rec["n_microbatches"] == SLOTS and rec["utilization"] == 1.0
    lives = {"collective-permute": None, "all-reduce": stats[0]["live"],
             "broadcast": stats[-1]["live"]}
    for st, dry in zip(stats, rec["stages"]):
        assert st["live"] == SLOTS
        for kind, n in lives.items():
            n = st["live"] if n is None else n
            calls = dry["collective_calls"][kind]
            assert st["collectives"][kind] == dict(
                calls=n * calls,
                bytes=n * dry["collective_bytes"][kind]), (dry["stage"], kind)
        hop = dry["collective_bytes"]["collective-permute"]
        assert st["hop_bytes"] == st["live"] * hop
        want_hop = 0 if dry["stage"] == STAGES - 1 else cfg.d_model * 4
        assert hop == want_hop
        assert dry["collective_calls"]["all-reduce"] == int(vocab_sharded)


def test_decode_step_collectives_equal_mesh_backend():
    """One ``MeshTensorBackend`` decode step on (1, 2), every slot fed:
    each process's ``tp`` tally and its collectives by kind are the dry
    run's decode step at the backend's slots and ``max_len``."""
    cfg, params = _model()
    mesh = Mesh(("data", "model"), (1, 2))
    be = TensorBackend(cfg, params, SLOTS, MAX_LEN, mesh, device="cpu",
                       timeout=TIMEOUT)
    try:
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (SLOTS, 8))
        be.prefill(list(range(SLOTS)), prompts)
        be.zero_stats()
        be.decode_step({s: 1 for s in range(SLOTS)})
        stats = be.stats()
    finally:
        be.close()
    rec = D.analyse(cfg, InputShape("d", MAX_LEN, SLOTS, "decode"), mesh)
    for rank, st in enumerate(stats):
        assert {k: st["tp"][k] for k in ("calls", "bytes")} == rec["tp"]
        assert st["collectives"] == {
            k: dict(calls=rec["collective_calls"][k],
                    bytes=rec["collective_bytes"][k])
            for k in st["collectives"]}, rank
    # the layers' attention and ff sums, the embedding's, the head's gather
    assert rec["tp"]["calls"] == 2 * LAYERS + 2


def test_record_and_refusals():
    """The reference's record keys (less the compile's), every stage's
    figures, the largest stage on top; an MoE stage and a vocab-sharded
    prefill refused."""
    cfg = get_config("llama2-7b").reduced(n_layers=LAYERS)
    mesh = Mesh(("data", "model"), (2, STAGES))
    rec = DP.run_pipeline_one("llama2-7b", "decode_32k", mesh=mesh)
    for key in ("arch", "shape", "mode", "stage_axis", "vocab_sharded",
                "utilization", "mesh", "chips", "params", "active_params",
                "phase", "n_stages", "n_microbatches", "mb",
                "periods_per_stage", "cost_analysis",
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "collective_bytes", "ok", "stages"):
        assert key in rec, key
    assert len(rec["stages"]) == STAGES and rec["n_microbatches"] == 64
    assert rec["cost_analysis"] == max(
        (s["cost_analysis"] for s in rec["stages"]),
        key=lambda c: (c["flops"], c["bytes accessed"]))
    # prefill: the most micro-batches that split over the data rows
    assert DP.prefill_microbatches(32, 16, 16) == 2
    shape = InputShape("p", 8, 4, "prefill")
    with pytest.raises(ValueError, match="vocab_sharded"):
        DP.analyse_pipeline(cfg, shape, mesh, PL.even_pipeline_spec(
            cfg, STAGES), None, vocab_sharded=True)
    moe = get_config("granite-moe-1b-a400m").reduced(n_layers=LAYERS)
    with pytest.raises(ValueError, match="moe_ragged"):
        DP.analyse_pipeline(moe, shape, mesh, PL.even_pipeline_spec(
            moe, STAGES), None)
    assert not torch.cuda.is_initialized()


def test_command_line_at_full_size(started):
    """``python -m repro_torch.launch.dryrun_pipeline --arch llama2-7b
    --shape decode_32k --layout dp`` exits 0 with the record on stdout:
    16 stages of the planner's layout, each stage's hop 4096 bf16 values
    but the last's."""
    rc, out, err, where = started("cli")
    assert rc == 0, err[-3000:]
    rec = json.loads(out)
    assert rec["ok"] and rec["mode"] == "pipeline-dp"
    assert len(rec["stages"]) == 16 == len(rec["periods_per_stage"])
    assert [s["collective_bytes"]["collective-permute"]
            for s in rec["stages"]] == [8192.0] * 15 + [0.0]
    assert rec == json.loads(
        (where / "llama2-7b+pipeline_decode_32k_pod.json").read_text())
