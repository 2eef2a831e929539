"""The multi-pod mesh ``(pod, data, model)``: process groups over several
mesh axes (``repro_torch.core.stage_procs.Comm.group``, built by
``repro_torch.core.mesh_procs._MeshRank``) and the port's mesh code on a
(2, 2, 2) mesh of 8 gloo processes, against the JAX package on the CPU.

- ``Comm.all_reduce`` and ``Comm.all_gather`` over each pair of axes give
  the sum and the blocks in coordinate order, worked out by hand from the
  ranks' coordinates; a tuple in another order names the same group; an
  axis the mesh lacks raises;
- ``MeshProcs.forward`` of reduced qwen3-0.6b and granite-moe-1b-a400m
  (batch rows over ``(pod, data)``, heads, ``ff``, vocabulary and experts
  over ``model``, the MoE's tokens over all three axes) within 5e-4 of the
  reference's pjit-sharded forward under ``default_rules(True)`` on an
  ``Auto`` (2, 2, 2) mesh of 8 faked XLA devices;
- one ``MeshTrainStep`` step of reduced granite-moe (the data all-reduce
  over ``(pod, data)``, the shares' sum over ``model``) against the
  reference's ``make_train_step`` under ``use_mesh`` on that mesh: loss,
  gradient norm and every parameter at 2e-4;
- ``pipeline_forward`` with its stages over ``model`` and each
  micro-batch's rows over ``(pod, data)``: each row's logits bit for bit
  one process's on the same rows;
- the dry run's multi-pod train record of reduced granite-moe: its
  collectives equal the gloo mesh's tallies call for call and byte for
  byte, its parameter count and global argument bytes the reference's
  record on that mesh; ``run_one(..., multi_pod=True)`` of qwen3-0.6b and
  granite-moe's ``train_4k`` at full size gives a record, and so does
  ``run_pipeline_one(..., multi_pod=True)`` of qwen3-0.6b's prefill and
  decode.

The reference runs once, in a subprocess with 8 faked XLA devices started
with the module; the mesh of processes is spawned once and takes each
model in turn (``torch_multipod_ranks.load_model``).
"""
import multiprocessing
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_multipod_ranks as ranks  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import (params_from_numpy,  # noqa: E402
                                params_to_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.core.mesh_procs import MeshProcs  # noqa: E402
from repro_torch.core.stage_procs import Comm  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import dryrun_pipeline as DP  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.training import adamw as TA  # noqa: E402
from repro_torch.training import train_loop as TTL  # noqa: E402
from repro_torch.training.data import DataConfig, make_dataset  # noqa: E402

torch.set_num_threads(2)

AXES = ("pod", "data", "model")
MESH = Mesh(AXES, (2, 2, 2))
PAIRS = [("pod", "data"), ("pod", "model"), ("data", "model")]
#: the reference test's: its pjit-sharded forward against its unsharded
#: one (tests/test_pipeline_runtime.py)
FORWARD_TOL = dict(rtol=5e-4, atol=5e-4)
#: test_torch_train.py's: float32 products and sums in another order
TRAIN_TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("qwen3-0.6b", "granite-moe-1b-a400m")
TRAIN_ARCH = "granite-moe-1b-a400m"
LAYERS, BATCH, SEQ = 2, 8, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=1)
TIMEOUT = 60

_REFERENCE = r"""
import sys
import jax
jax.devices()             # the 8 faked devices up before the dry run's import
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch import dryrun as D
from repro.models import transformer as T
from repro.models.config import InputShape
from repro.sharding.rules import (current_rules, default_rules,
                                  logical_constraint, param_sharding_tree,
                                  shape_aware_sharding_tree, use_mesh)
from repro.training import AdamWConfig, DataConfig, adamw_init, make_dataset
from repro.training.train_loop import TrainConfig, make_train_step
layers, b, s = map(int, sys.argv[1:4])
out, train_arch, names = sys.argv[4], sys.argv[5], sys.argv[6:]
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
rules = default_rules(True)
res = {}
for name in names:
    cfg = get_config(name).reduced(n_layers=layers)
    params, axes = T.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (b, s), 0,
                                cfg.vocab_size)
    res[name + "/tokens"] = np.asarray(tokens)
    with use_mesh(mesh, rules):
        placed = jax.device_put(params, param_sharding_tree(axes))
        fn = jax.jit(lambda p, t: T.forward(cfg, p, t, mode="train")[0])
        res[name + "/sharded"] = np.asarray(fn(placed, tokens), np.float32)
cfg = get_config(train_arch).reduced(n_layers=layers)
tokens, labels = make_dataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=s, batch=b)).batch_at(0)
with use_mesh(mesh, rules):
    params, axes = T.init_params(cfg, jax.random.PRNGKey(0))
    params = jax.device_put(params, shape_aware_sharding_tree(
        params, axes, mesh, current_rules()))

    def loss_fn(p, t, l):
        t = logical_constraint(t, "batch", None)
        l = logical_constraint(l, "batch", None)
        return T.train_loss(cfg, p, t, l)[0]
    grads = jax.jit(jax.grad(loss_fn))(params, jnp.asarray(tokens),
                                       jnp.asarray(labels))
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        res["train/grads" + jax.tree_util.keystr(path)] = np.asarray(
            leaf, np.float32)
    step_fn = jax.jit(make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=1))))
    params, _, m = step_fn(params, adamw_init(params), jnp.asarray(tokens),
                           jnp.asarray(labels))
res["train/loss"] = np.asarray(m["loss"])
res["train/grad_norm"] = np.asarray(m["grad_norm"])
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    res["train/params" + jax.tree_util.keystr(path)] = np.asarray(
        leaf, np.float32)
rec = D._compile_and_analyse(cfg, InputShape("t", s, b, "train"), mesh, rules)
res["dry/params"] = np.asarray(cfg.param_count())
res["dry/global_argument_bytes"] = np.asarray(rec["global_argument_bytes"])
np.savez(out, **res)
"""


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's forwards, train step and dry-run record, computed in
    a subprocess started with the module and read at the first test that
    needs them."""
    out = tmp_path_factory.mktemp("reference") / "multipod.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(LAYERS), str(BATCH), str(SEQ),
         str(out), TRAIN_ARCH, *ARCHS], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    done = {}

    def result():
        if not done:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            done.update(np.load(out))
        return done
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


_STATE = {}


def _model(arch):
    """(the port's config, the reference's weights as the port's: a fresh
    copy each call, as a step updates its trees in place)."""
    if arch not in _STATE:
        jcfg = jax_get_config(arch).reduced(n_layers=LAYERS)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        _STATE[arch] = jax.tree.map(np.asarray, jparams)
    cfg = get_config(arch).reduced(n_layers=LAYERS)
    return cfg, params_from_numpy(cfg, _STATE[arch], device="cpu")


def _procs(arch=None):
    """The module's (2, 2, 2) mesh of processes, holding ``arch``'s model
    (the first one's until another is asked for)."""
    if "procs" not in _STATE:
        cfg, params = _model(arch or ARCHS[0])
        _STATE["procs"] = MeshProcs(cfg, params, MESH, device="cpu",
                                    timeout=TIMEOUT)
    procs = _STATE["procs"]
    if arch is not None and procs.cfg.name != get_config(arch).reduced(
            n_layers=LAYERS).name:
        procs.cfg, procs.params = _model(arch)
        procs.run(ranks.load_model, procs.cfg, procs.params)
    return procs


# --------------------------------------------------------------------------- #
# the groups
# --------------------------------------------------------------------------- #

def _by_hand(rank, axes):
    """The ranks of ``rank``'s group over ``axes``: those whose coordinates
    equal its own off ``axes``, in the order of their coordinates over
    ``axes`` taken in the mesh's order, the first major."""
    coords = MESH.coords(rank)
    over = [a for a in AXES if a in axes]
    members = [r for r in range(MESH.size)
               if all(MESH.coords(r)[a] == coords[a]
                      for a in AXES if a not in over)]
    return sorted(members, key=lambda r: [MESH.coords(r)[a] for a in over])


@pytest.mark.parametrize("axes", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_pair_groups_sum_and_gather_in_coordinate_order(axes):
    """Over each pair of axes, in either order: the all-reduce of
    [rank, -rank] is the sum over the ranks of the group worked out by
    hand, the all-gather their blocks in coordinate order; the tuple in
    the other order gives the same group object."""
    got = _procs().run(ranks.comm_over, [axes, axes[::-1]])
    for rank, (mine, flipped) in enumerate(got):
        members = _by_hand(rank, axes)
        assert len(members) == 4
        want_sum = torch.tensor([1., -1.]) * sum(members)
        want_gather = torch.tensor([[m, -m] for m in members],
                                   dtype=torch.float32).reshape(-1)
        for total, gathered, _ in (mine, flipped):
            assert torch.equal(total, want_sum), (rank, axes)
            assert torch.equal(gathered, want_gather), (rank, axes)
        assert mine[2] == flipped[2]


def test_whole_tuple_and_single_axes():
    """The whole tuple in any order is the whole group (None); a single
    axis its own group; each sums and gathers as worked out by hand."""
    singles = [(a,) for a in AXES]
    got = _procs().run(ranks.comm_over, singles + [AXES, AXES[::-1]])
    for rank, res in enumerate(got):
        for axes, (total, gathered, _) in zip(singles, res):
            members = _by_hand(rank, axes)
            assert torch.equal(total, torch.tensor([1., -1.])
                               * sum(members))
            assert torch.equal(gathered, torch.tensor(
                [[m, -m] for m in members], dtype=torch.float32).reshape(-1))
        for total, gathered, gid in res[3:]:
            assert gid is None
            assert torch.equal(total, torch.tensor([28., -28.]))
            assert torch.equal(gathered, torch.tensor(
                [[m, -m] for m in range(8)],
                dtype=torch.float32).reshape(-1))


def test_group_names_and_refusals():
    """``Comm.group`` takes a tuple in any order and an axis by name; an
    axis the mesh lacks, an axis twice, or a tuple it was given no group
    for raises."""
    groups = {("pod", "data"): "pod-data", "model": "model",
              ("data", "model"): "data-model"}
    comm = Comm(None, torch.device("cpu"), groups, AXES)
    assert comm.group(("data", "pod")) == comm.group(("pod", "data")) \
        == "pod-data"
    assert comm.group("model") == comm.group(("model",)) == "model"
    assert comm.group(("model", "data")) == "data-model"
    assert comm.group(("model", "pod", "data")) is None
    for bad in (("pod", "stage"), "stage", ("data", "data")):
        with pytest.raises(ValueError, match="no distinct axes"):
            comm.group(bad)
    with pytest.raises(ValueError, match="no process group over"):
        comm.group(("pod", "model"))


def test_mesh_blocks_and_tuples():
    """The tuples a process builds groups for, and their blocks of ranks:
    by hand on (2, 2, 2), and on (1, 3, 2) where an axis has one point."""
    assert MESH.axis_tuples(2) == PAIRS
    assert MESH.axis_tuples() == [(a,) for a in AXES] + PAIRS
    for axes in PAIRS + [(a,) for a in AXES]:
        blocks = MESH.blocks(axes)
        assert sorted(r for b in blocks for r in b) == list(range(8))
        for block in blocks:
            assert block == _by_hand(block[0], axes)
    odd = Mesh(AXES, (1, 3, 2))
    assert odd.blocks(("pod", "data")) == [[0, 2, 4], [1, 3, 5]]
    assert odd.blocks(("data", "model")) == [list(range(6))]


def test_rule_helpers_on_three_axes():
    """The rules' helpers on (2, 2, 2), no process: ``batch`` is
    ``(pod, data)`` (4 blocks, a rank's the row-major block of its
    coordinates over them), the trainer's model axes are ``model`` alone,
    and ``tp_leaves`` splits granite-moe's heads over ``model`` only."""
    from repro_torch.sharding import rules as R
    rules = R.default_rules(True)
    batch = rules.spec(("batch",))[0]
    assert batch == ("pod", "data") and R.axis_size(MESH, batch) == 4
    assert R.batch_axes(MESH) == ("pod", "data")
    rows = torch.arange(8).reshape(8, 1)
    for rank in range(MESH.size):
        at = MESH.at(rank)
        c = MESH.coords(rank)
        block = R.local_slice(rows, (batch,), at)
        assert block.flatten().tolist() == [4 * c["pod"] + 2 * c["data"],
                                            4 * c["pod"] + 2 * c["data"] + 1]
        assert R.local_slice(rows, (AXES,), at).item() == rank
    cfg, params = _model(TRAIN_ARCH)
    tp = R.tp_rules(cfg, MESH)
    specs, split, partial = R.tp_leaves(cfg, MESH, tp, params)
    assert any(split) and any(partial)
    for spec, s in zip(specs, split):
        assert s == ("model" in R.spec_axes(spec))
        assert not {"pod", "data"} & set(R.spec_axes(spec))


# --------------------------------------------------------------------------- #
# the model code on the mesh
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_sharded_reference(arch, reference):
    """``MeshProcs.forward`` on (2, 2, 2): a process holds 2 of the 8 rows,
    half the heads, ``ff`` columns, vocabulary rows and experts; its MoE
    layers gather the batch over ``(pod, data)`` and split the tokens over
    all three axes.  Logits within 5e-4 of the reference's."""
    ref = reference()
    procs = _procs(arch)
    procs.zero_stats()
    got = procs.forward(torch.from_numpy(ref[arch + "/tokens"]).long())
    stats = procs.stats()
    np.testing.assert_allclose(got.numpy(), ref[arch + "/sharded"],
                               **FORWARD_TOL)
    cfg = procs.cfg
    if arch == TRAIN_ARCH:
        for st in stats:
            assert len(st["moe"]) == cfg.n_layers
            kinds = st["collectives"]
            assert kinds["all-to-all"]["calls"] == 2 * cfg.n_layers
            assert not any(m["dropped"] for m in st["moe"])


def _train_step():
    """One ``MeshTrainStep`` step of reduced granite-moe on the module's
    mesh, run once: (its gradients gathered whole, the metrics, the
    trained parameters, each process's stats of the step)."""
    if "train" not in _STATE:
        procs = _procs(TRAIN_ARCH)
        cfg, params = _model(TRAIN_ARCH)
        step = TTL.MeshTrainStep(cfg, TTL.TrainConfig(
            optimizer=TA.AdamWConfig(**OPT)), procs=procs)
        tokens, labels = (torch.from_numpy(a).long() for a in make_dataset(
            DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                       batch=BATCH)).batch_at(0))
        opt = TA.adamw_init(params)
        grads = step.gradients(params, opt, tokens, labels)
        procs.zero_stats()
        params, opt, m = step(params, opt, tokens, labels)
        _STATE["train"] = (grads, m, params, procs.stats())
    return _STATE["train"]


def _keyed(cfg, tree):
    """A tree of the port's layout, flattened by the reference's paths."""
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(
                params_to_numpy(cfg, tree))[0]}


def _reference_leaves(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def test_train_step_gradients_match_per_leaf(reference):
    """The step's gradients gathered whole (the whole leaves' shares
    summed over ``model``, every one averaged over ``(pod, data)``)
    against ``jax.grad`` of the reference's loss on its (2, 2, 2) mesh,
    leaf by leaf, at 2e-4."""
    cfg = get_config(TRAIN_ARCH).reduced(n_layers=LAYERS)
    got = _keyed(cfg, _train_step()[0])
    want = _reference_leaves(reference(), "train/grads")
    assert sorted(got) == sorted(want)
    for path, arr in got.items():
        np.testing.assert_allclose(arr, want[path], **TRAIN_TOL,
                                   err_msg=path)


def test_train_step_matches_the_reference(reference):
    """One step of reduced granite-moe on (2, 2, 2) against the
    reference's ``make_train_step`` under ``use_mesh`` on its (2, 2, 2)
    mesh: the loss, the gradient norm and every parameter at 2e-4.  Each
    process made one data all-reduce (over ``(pod, data)``).

    A first AdamW step moves an element by lr |g| / (|g| + eps), whose
    sign is the gradient's: where the two sides' gradients agree at 2e-4
    (:func:`test_train_step_gradients_match_per_leaf`) but lie on either
    side of zero, within float32 rounding of it, the two updates part by
    up to twice the rate, however close the gradients.  Such elements are
    counted (at most one in 10,000) and held within that bound, 2 lr +
    1e-6; every other element at 2e-4."""
    ref = reference()
    grads, m, params, stats = _train_step()
    np.testing.assert_allclose(m["loss"], ref["train/loss"], **TRAIN_TOL)
    np.testing.assert_allclose(m["grad_norm"], ref["train/grad_norm"],
                               **TRAIN_TOL)
    cfg = get_config(TRAIN_ARCH).reduced(n_layers=LAYERS)
    got, got_g = _keyed(cfg, params), _keyed(cfg, grads)
    want = _reference_leaves(ref, "train/params")
    want_g = _reference_leaves(ref, "train/grads")
    assert sorted(got) == sorted(want)
    bound = 2 * TA.lr_schedule(TA.AdamWConfig(**OPT), 1) + 1e-6
    flipped = total = 0
    for path, arr in got.items():
        sides = np.sign(got_g[path]) != np.sign(want_g[path])
        flipped += int(sides.sum())
        total += arr.size
        np.testing.assert_allclose(arr[~sides], want[path][~sides],
                                   **TRAIN_TOL, err_msg=path)
        assert np.abs(arr - want[path]).max() <= bound, path
    assert flipped <= total // 10_000, (flipped, total)
    assert all(st["dp"]["calls"] == 1 for st in stats)


def test_pipeline_forward_rows_over_pod_and_data():
    """``pipeline_forward`` on (2, 2, 2) with 2 stages over ``model`` and
    each of 2 micro-batches' 4 rows over ``(pod, data)``, a row a point:
    each row's logits bit for bit those of the one-process
    ``pipeline_forward`` over that process's rows, and within 1e-5 of the
    one-process forward over the whole batch."""
    procs = _procs(ARCHS[0])
    cfg, params = procs.cfg, procs.params
    spec = PL.even_pipeline_spec(cfg, 2)
    tokens = torch.randint(0, cfg.vocab_size, (8, SEQ),
                           generator=torch.Generator().manual_seed(2))
    procs.zero_stats()
    got = procs.pipeline_forward(tokens, spec, 2,
                                 batch_axes=("pod", "data"))
    stats = procs.stats()
    # micro-batch i is rows 4i..4i+3; row j of it sits on the (pod, data)
    # point j
    for j in range(4):
        rows = tokens.view(2, 4, SEQ)[:, j]
        one = PL.pipeline_forward(cfg, params, rows, spec, 2)
        assert torch.equal(got.view(2, 4, SEQ, -1)[:, j], one), j
    whole = PL.pipeline_forward(cfg, params, tokens, spec, 2)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)
    hop = 2 * SEQ * cfg.d_model * 4
    for rank, st in enumerate(stats):
        last = MESH.coords(rank)["model"] == 1
        assert st["hop_bytes"] == (0 if last else hop)


# --------------------------------------------------------------------------- #
# the dry run on the multi-pod mesh
# --------------------------------------------------------------------------- #

def test_dry_run_train_record_equals_gloo_mesh(reference):
    """The dry run's train step of reduced granite-moe on (2, 2, 2): each
    process's ``tp`` and ``dp`` tallies and its collectives by kind are
    the gloo mesh's for the same step exactly; the parameter count and the
    global argument bytes are the reference's record's on its (2, 2, 2)
    mesh."""
    stats = _train_step()[3]
    cfg = get_config(TRAIN_ARCH).reduced(n_layers=LAYERS)
    rec = D.analyse(cfg, InputShape("t", SEQ, BATCH, "train"), MESH)
    for rank, st in enumerate(stats):
        assert ({k: st["tp"][k] for k in ("calls", "bytes")},
                {k: st["dp"][k] for k in ("calls", "bytes")}) \
            == (rec["tp"], rec["dp"]), rank
        assert st["collectives"] == {
            k: dict(calls=rec["collective_calls"][k],
                    bytes=rec["collective_bytes"][k])
            for k in st["collectives"]}, rank
    assert rec["collective_calls"]["all-to-all"] == 4 * cfg.n_layers
    ref = reference()
    assert (cfg.param_count(), rec["global_argument_bytes"]) \
        == (int(ref["dry/params"]), int(ref["dry/global_argument_bytes"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_run_one_multi_pod_train(arch):
    """``run_one(arch, "train_4k", multi_pod=True)`` at full size on the
    production (2, 16, 16) mesh gives a record: one data all-reduce a
    process (over ``(pod, data)``, 32 rows of 256 a process)."""
    rec = D.run_one(arch, "train_4k", multi_pod=True)
    assert rec["ok"] and rec["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert rec["dp"]["calls"] == 1 and rec["chips"] == 512


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_run_pipeline_one_multi_pod(shape):
    """``run_pipeline_one(..., multi_pod=True)``: qwen3-0.6b's 16 stages
    over ``model`` of the production (2, 16, 16) mesh, the batch over
    ``(pod, data)``: a record whose every stage runs, the stages' hops
    counted."""
    rec = DP.run_pipeline_one("qwen3-0.6b", shape, multi_pod=True)
    assert rec["ok"] and rec["chips"] == 512 and rec["n_stages"] == 16
    assert len(rec["stages"]) == 16
    hops = [st["collective_calls"]["collective-permute"]
            for st in rec["stages"]]
    assert all(hops[:-1]) and hops[-1] == 0


def test_close_leaves_no_process():
    procs = _STATE.pop("procs", None)
    if procs is not None:
        procs.close()
    assert multiprocessing.active_children() == []
