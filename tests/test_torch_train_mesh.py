"""Training over a ``(data, model)`` mesh of processes
(``repro_torch.training.train_loop.MeshTrainStep``: autograd through the
tensor-parallel and expert-parallel collectives of
``repro_torch.sharding.rules``, gradients averaged over ``data`` in one
flat buffer) against the JAX package on the CPU, in float32, with the
reference's own weights.

- three steps on a (2, 4) mesh of processes against the reference's
  ``jax.jit(make_train_step)`` under ``use_mesh`` on a (2, 4) mesh of 8
  faked XLA devices with ``Auto`` axes (its parameters placed by
  ``shape_aware_sharding_tree``: as its ``train(..., mesh=)`` places them
  where every split divides, xlstm-1.3b's sLSTM ``ff`` of 341 whole):
  qwen3-0.6b (heads, ``ff`` and vocabulary split; qk-norm leaves summed
  over ``model``; tied head) with ``grad_accum`` 1 and 2, granite-moe
  (every MoE layer on ``moe_ep``, one expert a process; its loss is the
  reference's mesh loss, not its one-device one, since ``moe_ep``'s
  capacity buckets and its mean of the processes' aux losses replace
  ``moe_ragged``'s), recurrentgemma-2b (one K/V head: the attention runs
  whole; the RG-LRU's channels, ``ff`` and vocabulary split) and
  xlstm-1.3b (8 layers: the mLSTM's heads split in Megatron's form, its
  whole up-projection's gradient a share summed over ``model``; the
  sLSTM whole; one step, its parameters against the reference's own
  unsharded step: ``YARDSTICK``).  Each step's loss and gradient norm and
  every parameter after each step, at ``test_torch_train.py``'s 2e-4;
- the first step's gradients, leaf by leaf, against ``jax.grad`` of the
  reference's mesh loss: the test that names a leaf whose adjoint is
  wrong;
- a checkpoint written from the mesh is the processes' trained shards
  bit for bit, restores bit for bit into one process, and the next step
  there has the mesh's loss;
- the launcher's ``--devices 8 --mesh-model 4 --device cpu`` prints the
  losses of the same command without ``--devices``;
- no child process is left.

The reference runs once, in a subprocess with 8 faked XLA devices started
with the module; the mesh of processes is spawned once and trains every
model (each step loads the model's trees into it).
"""
import json
import multiprocessing
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import (params_from_numpy,  # noqa: E402
                                params_to_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.mesh_procs import MeshProcs  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.training import adamw as TA  # noqa: E402
from repro_torch.training import checkpoint as TC  # noqa: E402
from repro_torch.training import train_loop as TTL  # noqa: E402
from repro_torch.training.data import DataConfig, make_dataset  # noqa: E402

torch.set_num_threads(2)

#: test_torch_train.py's: float32 products and sums in another order
TOL = dict(rtol=2e-4, atol=2e-4)
LAYERS, BATCH, SEQ, STEPS = 4, 8, 16, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
#: (arch, grad_accum)
CASES = [("qwen3-0.6b", 1), ("qwen3-0.6b", 2),
         ("granite-moe-1b-a400m", 1), ("recurrentgemma-2b", 1),
         ("xlstm-1.3b", 1)]
ARCHS = ("qwen3-0.6b", "granite-moe-1b-a400m", "recurrentgemma-2b")
#: the depth of a model other than LAYERS: xlstm-1.3b's eighth block is its
#: sLSTM
DEPTH = {"xlstm-1.3b": 8}
#: models held for one step, its parameters to the reference's own
#: yardstick (:func:`_within_yardstick`), not at TOL.  A first AdamW step
#: moves an element by +-lr whatever its gradient's size, and gradients
#: near zero, summed in float32 in another order, change sign: on
#: xlstm-1.3b's random weights the reference's own unsharded and mesh
#: steps part in such elements by about lr, and from there their later
#: steps part further (gradient norms some percent apart), so its later
#: steps hold nothing.  Its first step's loss and gradient norm, and its
#: per-leaf gradients, are held at TOL as every model's
YARDSTICK = ("xlstm-1.3b",)
#: a batch whose tokens (26) the 8 processes' blocks split only after
#: padding, so that a block straddles two data rows: the expert-parallel
#: MoE's gathers then sum cotangents across data rows
PADDED = (2, 13)
TIMEOUT = 60

_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import transformer as T
from repro.sharding.rules import (current_rules, logical_constraint,
                                  shape_aware_sharding_tree, use_mesh)
from repro.training import AdamWConfig, DataConfig, adamw_init, make_dataset
from repro.training.train_loop import TrainConfig, make_train_step
layers, b, s, steps, pb, ps = map(int, sys.argv[1:7])
out, depth, yard = sys.argv[7], *map(json.loads, sys.argv[8:10])
cases = sys.argv[10:]
PADDED = (pb, ps)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)
res = {}


def keyed(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf,
                                                              np.float32)


for case in cases:
    name, accum = case.rsplit(":", 1)
    cfg = get_config(name).reduced(n_layers=depth.get(name, layers))
    data = make_dataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                   batch=b))
    with use_mesh(mesh):
        params, axes = T.init_params(cfg, jax.random.PRNGKey(0))
        params = jax.device_put(params, shape_aware_sharding_tree(
            params, axes, mesh, current_rules()))
        if accum == "1":
            def loss_fn(p, t, l):
                t = logical_constraint(t, "batch", None)
                l = logical_constraint(l, "batch", None)
                return T.train_loss(cfg, p, t, l)[0]
            grad_fn = jax.jit(jax.grad(loss_fn))
            shapes = [(b, s)] + ([PADDED] if name.startswith("granite")
                                 else [])
            for gb, gs in shapes:
                tokens, labels = make_dataset(DataConfig(
                    vocab_size=cfg.vocab_size, seq_len=gs,
                    batch=gb)).batch_at(0)
                keyed(f"{name}/{gb}x{gs}/grads", grad_fn(
                    params, jnp.asarray(tokens), jnp.asarray(labels)))
        opt = adamw_init(params)
        step_fn = jax.jit(make_train_step(cfg, TrainConfig(
            grad_accum=int(accum), optimizer=opt_cfg)))
        for i in range(steps):
            tokens, labels = data.batch_at(i)
            params, opt, m = step_fn(params, opt, jnp.asarray(tokens),
                                     jnp.asarray(labels))
            res[f"{case}/{i}/loss"] = np.asarray(m["loss"])
            res[f"{case}/{i}/grad_norm"] = np.asarray(m["grad_norm"])
            keyed(f"{case}/{i}/params", params)
    if name in yard:
        params, _ = T.init_params(cfg, jax.random.PRNGKey(0))
        tokens, labels = data.batch_at(0)
        params, _, _ = step_fn(params, adamw_init(params),
                               jnp.asarray(tokens), jnp.asarray(labels))
        keyed(f"{case}/0/plain_params", params)
np.savez(out, **res)
"""


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's mesh steps and gradients, computed in a subprocess
    a case, started with the module and read at the first test that needs
    them.  Each runs XLA on one thread, so that together they leave most
    of the machine's cores to the other test workers."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "src"))
    runs = []
    for arch, grad_accum in CASES:
        out = tmp_path_factory.mktemp("reference") / "train_mesh.npz"
        runs.append((out, subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(LAYERS), str(BATCH),
             str(SEQ), str(STEPS), *map(str, PADDED), str(out),
             json.dumps(DEPTH), json.dumps(YARDSTICK),
             f"{arch}:{grad_accum}"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    done = {}

    def result():
        if not done:
            for out, proc in runs:
                _, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-4000:]
                done.update(np.load(out))
        return done
    yield result
    for _, proc in runs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


_STATE = {}


def _model(arch):
    """(the port's config, the reference's weights as the port's: a fresh
    copy each call, as a step updates its trees in place)."""
    layers = DEPTH.get(arch, LAYERS)
    jcfg = jax_get_config(arch).reduced(n_layers=layers)
    if arch not in _STATE:
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        _STATE[arch] = jax.tree.map(np.asarray, jparams)
    cfg = get_config(arch).reduced(n_layers=layers)
    return cfg, params_from_numpy(cfg, _STATE[arch], device="cpu")


def _procs():
    """The module's (2, 4) mesh of processes."""
    if "procs" not in _STATE:
        cfg, params = _model(ARCHS[0])
        _STATE["procs"] = MeshProcs(cfg, params, make_test_mesh(2, 4),
                                    device="cpu", timeout=TIMEOUT)
    return _STATE["procs"]


def _step(cfg, grad_accum=1):
    return TTL.MeshTrainStep(cfg, TTL.TrainConfig(
        grad_accum=grad_accum, optimizer=TA.AdamWConfig(**OPT)),
        procs=_procs())


def _batch(cfg, step):
    data = make_dataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                   batch=BATCH))
    return tuple(torch.from_numpy(a).long() for a in data.batch_at(step))


def _keyed(tree):
    """A tree of the reference's layout, flattened by path."""
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same(got, ref, prefix, **tol):
    """The port's tree (its layout) against the reference's leaves under
    ``prefix``, path by path."""
    got = _keyed(params_to_numpy(got["cfg"], got["tree"]))
    want = {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}
    assert sorted(got) == sorted(want)
    for path, arr in got.items():
        np.testing.assert_allclose(arr, want[path], **tol,
                                   err_msg=prefix + path)


# --------------------------------------------------------------------------- #
# train steps and gradients against the reference's mesh step
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch, grad_accum", CASES)
def test_mesh_train_steps_match(arch, grad_accum, reference):
    """Three steps of the port's (2, 4) mesh step (one of a ``YARDSTICK``
    model's) against the reference's ``make_train_step`` under
    ``use_mesh`` on its (2, 4) mesh: the loss and the gradient norm of
    each step and every parameter after it."""
    cfg, params = _model(arch)
    ref = reference()
    step = _step(cfg, grad_accum)
    opt = TA.adamw_init(params)
    case = f"{arch}:{grad_accum}"
    steps = 1 if arch in YARDSTICK else STEPS
    for i in range(steps):
        params, opt, m = step(params, opt, *_batch(cfg, i))
        np.testing.assert_allclose(m["loss"], ref[f"{case}/{i}/loss"], **TOL)
        np.testing.assert_allclose(m["grad_norm"],
                                   ref[f"{case}/{i}/grad_norm"], **TOL)
        if arch in YARDSTICK:
            _within_yardstick(cfg, params, ref, f"{case}/{i}/")
        else:
            _same(dict(cfg=cfg, tree=params), ref, f"{case}/{i}/params",
                  **TOL)
    assert opt.step == steps


def _within_yardstick(cfg, params, ref, prefix):
    """The port's parameters after its first mesh step against the
    reference's mesh step's: no more elements beyond TOL than the
    reference's own unsharded step has (``<prefix>plain_params``), and
    none further than two first AdamW steps from the same weights can
    part: each moves an element by the step's rate times |g| / (|g| +
    eps) <= 1, plus the decay, which only shrinks a difference; so twice
    the rate, and 1e-6 for float32 rounding."""
    bound = 2 * TA.lr_schedule(TA.AdamWConfig(**OPT), 1) + 1e-6
    got = _keyed(params_to_numpy(cfg, params))
    outside = {"port": 0, "reference": 0}
    for path, arr in got.items():
        want = ref[f"{prefix}params{path}"]
        plain = ref[f"{prefix}plain_params{path}"]
        far = TOL["atol"] + TOL["rtol"] * np.abs(want)
        outside["port"] += int((np.abs(arr - want) > far).sum())
        outside["reference"] += int((np.abs(plain - want) > far).sum())
        assert np.abs(arr - want).max() <= bound, (prefix + path, bound)
    assert outside["port"] <= outside["reference"], outside


@pytest.mark.parametrize("arch, shape", [(a, (BATCH, SEQ)) for a in ARCHS]
                         + [("granite-moe-1b-a400m", PADDED),
                            ("xlstm-1.3b", (BATCH, SEQ))])
def test_mesh_gradients_match_per_leaf(arch, shape, reference):
    """The first step's gradients gathered whole (the global loss's, the
    whole leaves' shares summed over ``model``, averaged over ``data``)
    against ``jax.grad`` of the reference's mesh loss, leaf by leaf; for
    granite-moe also on a batch of 2 x 13 tokens, padded to the process
    count, whose ``moe_ep`` blocks straddle the data rows."""
    cfg, params = _model(arch)
    b, s = shape
    data = make_dataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                   batch=b))
    tokens, labels = (torch.from_numpy(a).long() for a in data.batch_at(0))
    grads = _step(cfg).gradients(params, TA.adamw_init(params), tokens,
                                 labels)
    _same(dict(cfg=cfg, tree=grads), reference(), f"{arch}/{b}x{s}/grads",
          **TOL)


def test_mesh_partial_leaves():
    """The leaves whose gradient is a process's share, by their layer's
    kind: qwen3-0.6b's qk-norm scales (its heads split), granite-moe's
    routers and experts (on ``moe_ep``), none of recurrentgemma-2b's (its
    attention whole, its RG-LRU split through and through), xlstm-1.3b's
    mLSTM up-projections (whole, feeding the split heads; its sLSTM
    whole); the split leaves are the ones placed over ``model``."""
    mesh = make_test_mesh(2, 4)
    want = {"qwen3-0.6b": {"attn/mixer/q_norm", "attn/mixer/k_norm"},
            "granite-moe-1b-a400m": {"attn/ffn/router", "attn/ffn/w_gate",
                                     "attn/ffn/w_up", "attn/ffn/w_down"},
            "recurrentgemma-2b": set(),
            "xlstm-1.3b": {"mlstm/mixer/w_up"}}
    for arch, names in want.items():
        cfg, params = _model(arch)
        specs, split, partial = R.tp_leaves(cfg, mesh, R.tp_rules(cfg, mesh),
                                            params)
        kinds = [s.kind for s in cfg.layer_specs()]
        paths = [_kind(p, kinds) for p in _paths(params)]
        assert len(paths) == len(specs) == len(TA.tree_leaves(params))
        assert {p for p, s in zip(paths, partial) if s} == names
        assert all(s for p, s in zip(paths, partial) if p in names)
        for p, s, spec in zip(paths, split, specs):
            assert s == ("model" in R.spec_axes(spec)), p
            assert not (s and p in names), p


def _kind(path, kinds):
    """A layer leaf's path with its layer's kind in place of the layer
    number (``layers/3/mixer/w_up`` -> ``mlstm/mixer/w_up``)."""
    parts = path.split("/", 2)
    if parts[0] != "layers":
        return path
    return f"{kinds[int(parts[1])]}/{parts[2]}"


def _paths(tree, prefix=""):
    """The leaves' paths, in the order of ``tree_leaves``."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + k
                                                            + "/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


# --------------------------------------------------------------------------- #
# checkpoints and the launcher
# --------------------------------------------------------------------------- #

def test_mesh_checkpoint_restores_in_one_process(tmp_path):
    """A checkpoint of the host's trees after two mesh steps holds the
    processes' trained shards bit for bit, restores bit for bit into one
    process, and the next step there has the mesh's next loss."""
    cfg, params = _model("qwen3-0.6b")
    step = _step(cfg)
    opt = TA.adamw_init(params)
    for i in range(2):
        params, opt, _ = step(params, opt, *_batch(cfg, i))
    shards = _procs().run(ranks.trained_shards)
    specs = R.tp_leaves(cfg, step.mesh, R.tp_rules(cfg, step.mesh),
                        params)[0]
    for rank, got in enumerate(shards):
        at = step.mesh.at(rank)
        for whole, trees, spec in zip(
                zip(*(TA.tree_leaves(t) for t in (params, opt.mu, opt.nu))),
                zip(*got), specs):
            for w, g in zip(whole, trees):
                assert torch.equal(R.local_slice(w, spec, at), g)
    fname = TC.save_checkpoint(str(tmp_path), cfg, params, opt, opt.step)
    template = TA.tree_map(torch.zeros_like, params)
    back, back_opt, back_step = TC.restore_checkpoint(
        fname, cfg, template, TA.adamw_init(template))
    assert back_step == back_opt.step == opt.step == 2
    for a, b in zip(TA.tree_leaves((params, opt.mu, opt.nu)),
                    TA.tree_leaves((back, back_opt.mu, back_opt.nu))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    one = TTL.make_train_step(cfg, TTL.TrainConfig(
        optimizer=TA.AdamWConfig(**OPT)))
    _, _, m_mesh = step(params, opt, *_batch(cfg, 2))
    _, _, m_one = one(back, back_opt, *_batch(cfg, 2))
    np.testing.assert_allclose(float(m_one["loss"]), m_mesh["loss"], **TOL)
    np.testing.assert_allclose(float(m_one["grad_norm"]),
                               m_mesh["grad_norm"], **TOL)


_STEP_LINE = re.compile(r"step\s+(\d+) loss (\S+) ")


def test_mesh_launcher_prints_the_losses_of_one_process(capsys):
    """``--devices 8 --mesh-model 4 --device cpu`` against the same command
    without ``--devices``: the same loss lines, to the print's 4
    decimals, and the same closing line."""
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--steps", "3", "--log-every", "1"]
    out = []
    for extra in ((), ("--devices", "8", "--mesh-model", "4")):
        train_launcher.main(argv + list(extra))
        text = capsys.readouterr().out
        out.append(([m.groups() for m in _STEP_LINE.finditer(text)],
                    [ln for ln in text.splitlines()
                     if ln.startswith("first loss")]))
    one, mesh = out
    assert len(one[0]) == 3 and len(one[1]) == 1
    assert mesh == one


def test_mesh_launcher_refusals():
    """A model axis that does not divide ``--devices`` raises; so does the
    mesh launcher without ``--device cpu`` where there is no GPU, before
    it spawns a process."""
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "1"]
    with pytest.raises(ValueError, match="does not divide"):
        train_launcher.main(argv + ["--device", "cpu", "--devices", "6",
                                    "--mesh-model", "4"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            train_launcher.main(argv + ["--devices", "8", "--mesh-model",
                                        "4"])


def test_close_leaves_no_process():
    procs = _STATE.pop("procs", None)
    if procs is not None:
        procs.close()
    assert multiprocessing.active_children() == []
