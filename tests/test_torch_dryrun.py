"""The dry run (``repro_torch.launch.dryrun``: one mesh process's step on the
``meta`` device, counted) against the JAX package's dry run and against a
gloo mesh of processes running the same steps, on the CPU.

- ``init_params(cfg, None, "meta")`` is the reference's
  ``jax.eval_shape(init_params)`` leaf by leaf, for every registry config at
  full size;
- on 8 faked XLA devices (a (2, 4) mesh with ``Auto`` axes) the reference's
  ``_compile_and_analyse`` records train, prefill and decode of llama2-7b,
  qwen3-0.6b, granite-moe-1b-a400m and recurrentgemma-2b
  (``reduced(n_layers=2)``, 4 x 16 tokens).  ``params``, ``active_params``
  and ``global_argument_bytes`` equal the port's exactly.  XLA's
  ``argument_size_in_bytes`` is a device's (a split and a replicated leaf
  checked), and a port process's equals it wherever the placements agree;
  where they do not, the difference is worked out from the specs
  (:data:`PLACEMENT_DIFFERS`, :func:`_listed_difference`);
- a dense prefill's flops equal 2mnk of every product it runs, counted by
  hand; the reference's (scan-corrected) XLA flops are printed beside them;
- the dry run's collective calls and bytes (``tp``, ``dp``, by kind) equal
  what a gloo mesh tallies for the same step: ``MeshProcs.forward`` of
  granite-moe on (2, 4) (``moe_ep``'s all-to-alls and gathers among them),
  and qwen3-0.6b's ``pipeline_forward`` hops and one ``MeshTrainStep``
  step on (2, 2);
- rank 0's record is the last rank's; the rule sets the port's mesh cannot
  run raise ``NotImplementedError``; a run touches no device and spawns
  nothing; the command line runs qwen3-0.6b's ``train_4k`` at full size;
- the trainers take a frontend's float embeddings, as the reference's dry
  run trains on them: a (2, 2) ``MeshTrainStep`` step against the
  one-process step, and musicgen-large's step against the reference's.

The reference runs once, in a subprocess with 8 faked XLA devices started
with the module (its dry run sets 512 devices when imported, so it is
imported there only after the 8 are up); each mesh of processes is spawned
once.
"""
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.bridge import (init_params, param_axes,  # noqa: E402
                                reference_leaves)
from repro_torch.configs import CONFIGS, get_config  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.core.mesh_procs import MeshProcs, _forward_rank  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import dryrun_pipeline as DP  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.training import adamw as TA  # noqa: E402
from repro_torch.training import train_loop as TTL  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("llama2-7b", "qwen3-0.6b", "granite-moe-1b-a400m",
         "recurrentgemma-2b")
PHASES = ("train", "prefill", "decode")
LAYERS, SEQ, BATCH = 2, 16, 4
MESH = Mesh(("data", "model"), (2, 4))
TIMEOUT = 60

#: where a port process places a leaf otherwise than the reference's
#: ``shape_aware_sharding_tree`` of its axes on a device (ROADMAP Queue 3,
#: "Where the port chose to differ"): recurrentgemma-2b's attention layer
#: (its third, the last of its one stacked period) keeps its heads whole,
#: since 1 K/V head does not split over 4, where the reference splits the
#: flattened q/k/v widths (256 and 64 columns divide by 4): a process holds
#: all of wq [256, 256], wk and wv [256, 64] and wo [256, 256], the
#: reference's device a quarter of each
PLACEMENT_DIFFERS = {
    "recurrentgemma-2b": ("stack/p2/mixer/wq", "stack/p2/mixer/wk",
                          "stack/p2/mixer/wv", "stack/p2/mixer/wo"),
}

_REFERENCE = r"""
import json, sys
import jax
jax.devices()             # the 8 faked devices up before the dry run's import
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import CONFIGS, get_config
from repro.launch import dryrun as D
from repro.models import transformer as T
from repro.models.config import InputShape
from repro.sharding.rules import default_rules

out, layers, seq, batch = sys.argv[1], *map(int, sys.argv[2:5])
archs, phases = sys.argv[5].split(","), sys.argv[6].split(",")
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
res = {}
leaf = jax.ShapeDtypeStruct((8, 16), jnp.float32)
fn = jax.jit(lambda x, y: x.sum() + y.sum(), in_shardings=(
    NamedSharding(mesh, P("data", "model")), NamedSharding(mesh, P())))
res["split_and_replicated"] = int(
    fn.lower(leaf, leaf).compile().memory_analysis().argument_size_in_bytes)
for arch in archs:
    cfg = get_config(arch).reduced(n_layers=layers)
    for phase in phases:
        shape = InputShape(phase, seq, batch, phase)
        rec = D._compile_and_analyse(cfg, shape, mesh, default_rules())
        if (arch, phase) == ("llama2-7b", "prefill"):
            rec.update(D._scan_corrected(cfg, shape, mesh, default_rules(),
                                         rec))
        rec["params"] = cfg.param_count()
        rec["active_params"] = cfg.active_param_count()
        res[arch + "/" + phase] = rec
trees = {}
for name in sorted(CONFIGS):
    shapes = jax.eval_shape(lambda k: T.init_params(CONFIGS[name], k)[0],
                            jax.random.PRNGKey(0))
    trees[name] = {jax.tree_util.keystr(p): [list(v.shape), str(v.dtype)]
                   for p, v in jax.tree_util.tree_flatten_with_path(
                       shapes)[0]}
res["trees"] = trees
with open(out, "w") as f:
    json.dump(res, f)
"""


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8", PYTHONDONTWRITEBYTECODE="1",
                PYTHONPATH=os.path.join(ROOT, "src"))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's records and parameter shapes, computed in a
    subprocess started with the module; the command line's full-size run
    started beside it."""
    tmp = tmp_path_factory.mktemp("dryrun")
    out = tmp / "reference.json"
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(out), str(LAYERS), str(SEQ),
         str(BATCH), ",".join(ARCHS), ",".join(PHASES)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-0.6b", "--shape", "train_4k", "--out-dir", str(tmp / "cli")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    done = {}

    def result(key="reference"):
        if key not in done:
            p = proc if key == "reference" else cli
            o, err = p.communicate(timeout=600)
            if key == "reference":
                assert proc.returncode == 0, err[-4000:]
                with open(out) as f:
                    done[key] = json.load(f)
            else:
                done[key] = (cli.returncode, o, err, tmp / "cli")
        return done[key]
    yield result
    for p in (proc, cli):
        if p.poll() is None:
            p.kill()
            p.communicate()


_STATE = {}


def _port(arch, phase, rank=0):
    key = (arch, phase, rank)
    if key not in _STATE:
        cfg = get_config(arch).reduced(n_layers=LAYERS)
        _STATE[key] = D.analyse(cfg, InputShape(phase, SEQ, BATCH, phase),
                                MESH, rank=rank)
    return _STATE[key]


def teardown_module(module):
    for key in [k for k in _STATE if isinstance(k, str)]:
        _STATE.pop(key).close()


# --------------------------------------------------------------------------- #
# against the reference's records
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_meta_param_tree_is_reference_eval_shape(reference, name):
    """``init_params(cfg, None, "meta")`` at full size: every leaf of the
    reference's ``eval_shape`` tree, by path, with its shape (a stacked
    path's layers stacked) and dtype; nothing drawn, no storage."""
    want = reference()["trees"][name]
    params = init_params(CONFIGS[name], None, "meta")
    assert all(t.device.type == "meta" for t in TA.tree_leaves(params))
    got = {}
    for path, leaf in reference_leaves(CONFIGS[name], params).items():
        leaves = leaf if isinstance(leaf, list) else [leaf]
        shape = ([len(leaves)] if isinstance(leaf, list) else []) \
            + list(leaves[0].shape)
        assert all(t.shape == leaves[0].shape for t in leaves), path
        key = "".join(f"['{k}']" for k in path.split("/"))
        got[key] = [shape, str(leaves[0].dtype).replace("torch.", "")]
    assert got == want


def test_init_params_needs_a_generator_off_meta():
    cfg = get_config("qwen3-0.6b").reduced(n_layers=1)
    with pytest.raises(ValueError, match="meta"):
        init_params(cfg, None, "cpu")
    with pytest.raises(ValueError, match="meta"):
        init_params(cfg, torch.Generator(), "meta")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("phase", PHASES)
def test_counts_equal_reference(reference, arch, phase):
    """``params``, ``active_params`` and ``global_argument_bytes`` of the
    whole step: the reference's exactly."""
    want = reference()[f"{arch}/{phase}"]
    cfg = get_config(arch).reduced(n_layers=LAYERS)
    got = _port(arch, phase)
    assert (cfg.param_count(), cfg.active_param_count(),
            got["global_argument_bytes"]) \
        == (want["params"], want["active_params"],
            want["global_argument_bytes"])


def _leaf_bytes(cfg, tree, specs, mesh):
    """Bytes a leaf of a parameter-shaped ``tree`` under ``specs`` (a tree
    of specs), by its path in the reference's tree."""
    out = {}
    flat = reference_leaves(cfg, tree)
    spec_flat = reference_leaves(cfg, specs)
    for path, leaf in flat.items():
        leaves = leaf if isinstance(leaf, list) else [leaf]
        sps = spec_flat[path] if isinstance(leaf, list) \
            else [spec_flat[path]]
        out[path] = sum(R.local_slice(t, sp, mesh).numel() * t.element_size()
                        for t, sp in zip(leaves, sps))
    return out


def _listed_difference(arch, phase):
    """A port process's argument bytes less the reference device's, from
    the specs: for every leaf of :data:`PLACEMENT_DIFFERS` (the
    parameters' and, to train, the two float32 moments'), its bytes under
    the port's ``_tp_specs`` less its bytes under the reference's
    ``shape_aware_sharding_tree``; to train, less the reference's int32
    AdamW step (4 bytes; the port's is a host int); to prefill, plus the
    attention caches' ``pos`` [b] int32 a layer, which the reference's
    prefill does not read (it writes the ring from position 0), so that
    ``jax.jit`` drops them from its arguments (``keep_unused=False``)."""
    cfg = get_config(arch).reduced(n_layers=LAYERS)
    at = MESH.at(0)
    params = init_params(cfg, None, "meta")
    rules = R.tp_rules(cfg, at)
    port = _leaf_bytes(cfg, params, R._tp_specs(cfg, at, rules), at)
    ref_specs = R._map(lambda sh: sh.spec, R.shape_aware_sharding_tree(
        params, param_axes(cfg), at, R.default_rules()),
        lambda t: isinstance(t, R.NamedSharding))
    ref = _leaf_bytes(cfg, params, ref_specs, at)
    differs = tuple(p for p in port if port[p] != ref[p])
    # an MoE layer's experts: the port counts E/m, as the reference places
    # them, and its processes view them whole
    has_moe = any(s.moe is not None for s in cfg.layer_specs())
    moe = tuple(p for p in differs if has_moe and "/ffn/" in p
                and p.split("/")[-1] in ("w_gate", "w_up", "w_down"))
    differs = tuple(p for p in differs if p not in moe)
    assert differs == PLACEMENT_DIFFERS.get(arch, ()), differs
    diff = 0
    for p in differs:
        per_param = port[p] - ref[p]
        itemsize = 2 if cfg.dtype == "bfloat16" else 4
        diff += per_param if phase != "train" \
            else per_param * (1 + 2 * 4 // itemsize)
    if phase == "train":
        diff -= 4
    if phase == "prefill":
        rows = BATCH // MESH.shape["data"]
        attn = sum(s.kind == "attn" for s in cfg.layer_specs())
        diff += 4 * rows * attn
    return diff


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("phase", PHASES)
def test_argument_bytes_a_process(reference, arch, phase):
    """XLA's ``argument_size_in_bytes`` is a device's (a [8, 16] float32
    leaf split over the 8 devices and one replicated: 64 + 512 bytes).  A
    port process's argument bytes equal the reference device's wherever
    the placements agree, and differ by the listed leaves' and arguments'
    bytes elsewhere (:func:`_listed_difference`)."""
    res = reference()
    assert res["split_and_replicated"] == 8 * 16 * 4 // 8 + 8 * 16 * 4
    want = res[f"{arch}/{phase}"]["argument_size_in_bytes"]
    got = _port(arch, phase)["argument_size_in_bytes"]
    assert got - want == _listed_difference(arch, phase)


def _hand_flops(cfg, rows, s):
    """2mnk of every product a process's prefill of ``rows`` x ``s`` tokens
    runs (``cfg`` its local config): q/k/v/o, QK^T and PV over every key,
    the three MLP products a layer, and the head's columns on every
    position."""
    t, d, hd = rows * s, cfg.d_model, cfg.resolved_head_dim
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    per_layer = 2 * t * d * (q + 2 * kv) + 2 * t * q * d \
        + 2 * 2 * rows * cfg.n_heads * s * s * hd \
        + 3 * 2 * t * d * cfg.d_ff
    return cfg.n_layers * per_layer + 2 * t * d * cfg.vocab_size


def test_flops_equal_a_count_by_hand(reference):
    """A dense prefill's flops (llama2-7b, a process's 2 rows x 16 tokens,
    1 of 4 heads, a quarter of ff and of the vocabulary): 2mnk of every
    product, exactly.  The reference's XLA flops (scan-corrected; XLA also
    counts elementwise work) are printed beside them."""
    cfg = get_config("llama2-7b").reduced(n_layers=LAYERS)
    at = MESH.at(0)
    rules = R.tp_rules(cfg, at)
    local = dataclasses.replace(R.local_config(cfg, at, rules),
                                vocab_size=cfg.vocab_size // 4)
    got = _port("llama2-7b", "prefill")["cost_analysis"]["flops"]
    want = _hand_flops(local, BATCH // 2, SEQ)
    ref = reference()["llama2-7b/prefill"]
    xla = ref.get("cost_analysis_corrected", ref["cost_analysis"])["flops"]
    print(f"\nllama2-7b reduced prefill, a process: flops {got:.0f} (by "
          f"hand {want}); the reference's XLA flops a device {xla:.0f} "
          f"(ratio port/XLA {got / xla:.4f})")
    assert got == want


def test_rank_zero_stands_for_every_rank():
    """Under ``tp_rules`` every process has the same shapes: rank 0's
    record is the last rank's on (2, 4), for a train step and a decode."""
    for arch, phase in (("qwen3-0.6b", "train"),
                        ("granite-moe-1b-a400m", "decode")):
        first, last = _port(arch, phase), _port(arch, phase, MESH.size - 1)
        drop = ("rank", "run_s")
        assert {k: v for k, v in first.items() if k not in drop} \
            == {k: v for k, v in last.items() if k not in drop}


@pytest.mark.parametrize("phase", ["train", "prefill"])
def test_slstm_loop_extrapolated_equals_counted(phase):
    """The sLSTM's loop over time counted at 1 and 2 steps and
    extrapolated (xlstm-1.3b reduced to one period, 12 steps, on (2, 2))
    gives every step's flops, bytes and ops exactly, the same collectives,
    and a temp peak at or above the full run's (a linear estimate)."""
    cfg = get_config("xlstm-1.3b").reduced(n_layers=8)
    shape = InputShape(phase, 12, 4, phase)
    mesh = Mesh(("data", "model"), (2, 2))

    def build():
        return D.build_step(cfg, shape, None, mesh.at(0), None, "ref")
    full = D._counted(build)
    ext = D._extrapolate(D._counted(build, 1), D._counted(build, 2), 12)
    for key in ("flops", "bytes_accessed", "ops"):
        assert ext[key] == full[key], key
    assert D.collective_bytes(ext["comm"]) \
        == D.collective_bytes(full["comm"])
    assert full["temp"] <= ext["temp"] <= 1.1 * full["temp"]
    rec = D.analyse(cfg, shape, mesh)
    assert rec["cost_analysis"]["flops"] == full["flops"]
    assert rec["loops"][0]["trips"] == 12


def test_unsupported_rules_raise():
    """Where the reference picks a rule set the port's mesh cannot run,
    the record fails naming the ROADMAP item; nothing falls back."""
    for kw, item in ((dict(shape_name="decode_32k",
                           rules_variant="decode-seq-model"), "sequence"),
                     (dict(shape_name="long_500k", variant="swa"),
                      "sequence"),
                     (dict(shape_name="train_4k", fsdp=True), "FSDP"),
                     (dict(shape_name="train_4k", fsdp_gather=True), "FSDP")):
        with pytest.raises(NotImplementedError, match=item):
            D.run_one("qwen3-0.6b", **kw)
    with pytest.raises(ValueError, match="impl"):
        D.run_one("qwen3-0.6b", "decode_32k", impl="cuda")
    assert D.resolve_impl("xla") == "ref"
    assert D.resolve_impl("chunked") == "chunked"


def test_ragged_moe_fails_its_record():
    """An MoE whose experts ``model`` does not divide runs ``moe_ragged``,
    whose group sizes are host reads: the record fails, it does not run
    another placement."""
    cfg = get_config("granite-moe-1b-a400m").reduced(n_layers=LAYERS)
    with pytest.raises(ValueError, match="moe_ragged"):
        D.analyse(cfg, InputShape("d", SEQ, 6, "decode"),
                  Mesh(("data", "model"), (2, 3)))


def test_no_device_and_no_process(tmp_path):
    """A dry run touches no device and spawns nothing; its record goes to
    ``out_dir``, and ``main`` prints it."""
    before = len(multiprocessing.active_children())
    rec = D.run_one("qwen3-0.6b", "decode_32k", out_dir=str(tmp_path))
    assert rec["ok"] and rec["per_process"] and rec["mesh"] == {
        "data": 16, "model": 16} and rec["chips"] == 256
    assert not torch.cuda.is_initialized()
    assert len(multiprocessing.active_children()) == before
    saved = json.loads((tmp_path / "qwen3-0.6b_decode_32k_pod.json")
                       .read_text())
    assert saved == rec
    # qwen3-0.6b on 16: K/V heads whole (8 do not split), ff and the
    # vocabulary split: a sum a layer and the embedding's, the head's gather
    assert rec["collective_calls"]["all-reduce"] == 29
    assert rec["collective_calls"]["all-gather"] == 1
    assert rec["state_in_place"]


def test_command_line_at_full_size(reference):
    """``python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape
    train_4k`` exits 0 with the record on stdout and in ``--out-dir``."""
    rc, out, err, where = reference("cli")
    assert rc == 0, err[-3000:]
    rec = json.loads(out)
    assert rec["ok"] and rec["phase"] == "train" and rec["dp"]["calls"] == 1
    assert rec == json.loads((where / "qwen3-0.6b_train_4k_pod.json")
                             .read_text())
    assert not any(k in rec for k in ("lower_s", "compile_s",
                                      "hlo_bytes_len"))


# --------------------------------------------------------------------------- #
# against a gloo mesh of processes
# --------------------------------------------------------------------------- #

def _model(arch, layers):
    cfg = get_config(arch).reduced(n_layers=layers)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _procs(key, arch, shape, layers=4):
    if key not in _STATE:
        cfg, params = _model(arch, layers)
        _STATE[key] = MeshProcs(cfg, params, Mesh(("data", "model"), shape),
                                device="cpu", timeout=TIMEOUT)
    return _STATE[key]


def _tallies(comm_or_stats):
    if isinstance(comm_or_stats, dict):
        st = comm_or_stats
        return ({k: st["tp"][k] for k in ("calls", "bytes")},
                {k: st["dp"][k] for k in ("calls", "bytes")},
                st["collectives"])
    c = comm_or_stats
    return ({k: c.tp[k] for k in ("calls", "bytes")},
            {k: c.dp[k] for k in ("calls", "bytes")},
            {k: dict(v) for k, v in c.collectives.items()})


def test_forward_collectives_equal_gloo_mesh():
    """``MeshProcs.forward`` of granite-moe on (2, 4) (attention and ff
    over model, every MoE layer on ``moe_ep``): each process's ``tp``
    tally and its collectives by kind are the meta run's of
    ``_forward_rank`` at the same rank."""
    procs = _procs("moe", "granite-moe-1b-a400m", (2, 4))
    cfg, mesh = procs.cfg, procs.mesh
    tokens = torch.randint(0, cfg.vocab_size, (4, 8),
                           generator=torch.Generator().manual_seed(1))
    procs.zero_stats()
    procs.forward(tokens)
    stats = procs.stats()
    meta = init_params(cfg, None, "meta")
    for rank in range(mesh.size):
        at = mesh.at(rank, D.MetaComm(mesh))
        tp_cfg, tp_params, rules = R.tensor_parallel(cfg, meta, at)
        stand_in = D._MetaRank(at, tp_params=tp_params, rules=rules,
                               impl="ref")
        _forward_rank(stand_in, cfg, tokens.to("meta"),
                      torch.empty((4, 8, cfg.vocab_size), device="meta"))
        assert _tallies(at.comm) == _tallies(stats[rank]), rank
        assert at.comm.collectives["all-to-all"]["calls"] \
            == 2 * cfg.n_layers


def test_pipeline_forward_hops_equal_gloo_mesh():
    """``MeshProcs.pipeline_forward`` of qwen3-0.6b on (2, 2), two stages
    of two layers over model, two micro-batches of a row a data row: each
    stage's hop bytes and its collectives by kind are the pipeline dry
    run's stage's (``analyse_pipeline``, prefill).  (An MoE pipeline runs
    ``moe_ragged``, whose host reads meta cannot give.)"""
    procs = _procs("train", "qwen3-0.6b", (2, 2))
    cfg, mesh = procs.cfg, procs.mesh
    spec = PL.even_pipeline_spec(cfg, 2)
    tokens = torch.randint(0, cfg.vocab_size, (4, 8),
                           generator=torch.Generator().manual_seed(2))
    procs.zero_stats()
    procs.pipeline_forward(tokens, spec, 2)
    stats = procs.stats()
    rec = DP.analyse_pipeline(cfg, InputShape("p", 8, 4, "prefill"), mesh,
                              spec, 2)
    assert rec["n_microbatches"] == 2 and rec["mb"] == 2
    for st in rec["stages"]:
        got = stats[st["rank"]]
        assert got["collectives"] == {
            k: dict(calls=st["collective_calls"][k],
                    bytes=st["collective_bytes"][k])
            for k in got["collectives"]}, st["stage"]
        assert got["hop_bytes"] == st["collective_bytes"][
            "collective-permute"]
    assert [s["collective_calls"]["collective-permute"]
            for s in rec["stages"]] == [2, 0]


def test_train_step_collectives_equal_gloo_mesh():
    """One ``MeshTrainStep`` step of qwen3-0.6b on (2, 2): each process's
    ``tp`` and ``dp`` tallies and its collectives by kind are the dry
    run's train step's (``_update_rank`` on meta), and the dry run's state
    updates in place."""
    procs = _procs("train", "qwen3-0.6b", (2, 2))
    cfg, mesh = procs.cfg, procs.mesh
    params = TA.tree_map(lambda t: t.clone(), procs.params)
    opt = TA.adamw_init(params)
    step = TTL.MeshTrainStep(cfg, TTL.TrainConfig(), procs=procs)
    step._load(params, opt)
    tokens = torch.randint(0, cfg.vocab_size, (4, 8),
                           generator=torch.Generator().manual_seed(3))
    procs.zero_stats()
    step(params, opt, tokens, tokens.roll(-1, 1))
    stats = procs.stats()
    rec = D.analyse(cfg, InputShape("t", 8, 4, "train"), mesh)
    for rank in range(mesh.size):
        tp, dp, kinds = _tallies(stats[rank])
        assert (tp, dp) == (rec["tp"], rec["dp"]), rank
        assert kinds == {k: dict(calls=rec["collective_calls"][k],
                                 bytes=rec["collective_bytes"][k])
                         for k in kinds}, rank
    assert rec["dp"]["calls"] == 1 and rec["state_in_place"]


def test_train_step_takes_frontend_embeddings():
    """A frontend's float embeddings [B, S, d] through one ``MeshTrainStep``
    step on the (2, 2) processes give the one-process step's loss and
    gradient norm (2e-4, ``tests/test_torch_train_mesh.py``'s tolerance):
    a process takes its rows as they are, where it cast them to int64
    (ROADMAP Queue 3).  The dry run of musicgen-large's train step,
    which the reference runs on its frontend's embeddings, runs too."""
    procs = _procs("train", "qwen3-0.6b", (2, 2))
    cfg = procs.cfg
    gen = torch.Generator().manual_seed(4)
    emb = torch.randn((4, 8, cfg.d_model), generator=gen) / cfg.d_model ** 0.5
    labels = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen)
    got = {}
    for name, step in (("one", TTL.make_train_step(cfg, TTL.TrainConfig())),
                       ("mesh", TTL.MeshTrainStep(cfg, TTL.TrainConfig(),
                                                  procs=procs))):
        params = TA.tree_map(lambda t: t.clone(), procs.params)
        _, _, got[name] = step(params, TA.adamw_init(params), emb, labels)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got["mesh"][key]),
                                   float(got["one"][key]),
                                   rtol=2e-4, atol=2e-4, err_msg=key)


def test_frontend_train_step_equals_reference():
    """musicgen-large (reduced, its head untied) trained one step on float
    embeddings, as the reference's dry run trains it: the port's
    ``make_train_step`` gives the reference's loss, gradient norm and
    parameters (2e-4, ``tests/test_torch_train.py``'s tolerance), the
    unread embedding's gradient zeros as ``jax.value_and_grad`` gives it
    (ROADMAP Queue 3), and the dry run of its mesh step runs."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as JT
    from repro.training import adamw as JTA
    from repro.training import train_loop as JTL
    from repro_torch.bridge import params_from_numpy, params_to_numpy
    jcfg = jax_get_config("musicgen-large").reduced(n_layers=LAYERS)
    cfg = get_config("musicgen-large").reduced(n_layers=LAYERS)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    rng = np.random.default_rng(5)
    emb = (rng.standard_normal((2, 8, cfg.d_model))
           / cfg.d_model ** 0.5).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jnew, _, jm = jax.jit(JTL.make_train_step(jcfg, JTL.TrainConfig()))(
        jparams, JTA.adamw_init(jparams), emb, labels)
    step = TTL.make_train_step(cfg, TTL.TrainConfig())
    params, _, m = step(params, TA.adamw_init(params), torch.from_numpy(emb),
                        torch.from_numpy(labels).long())
    tol = dict(rtol=2e-4, atol=2e-4)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **tol,
                                   err_msg=key)
    got = params_to_numpy(cfg, params)
    for path, want in jax.tree_util.tree_flatten_with_path(jnew)[0]:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(want, np.float32), **tol,
                                   err_msg=jax.tree_util.keystr(path))
    rec = D.analyse(cfg, InputShape("t", 8, 4, "train"),
                    Mesh(("data", "model"), (2, 2)))
    assert rec["dp"]["calls"] == 1 and rec["cost_analysis"]["flops"] > 0
