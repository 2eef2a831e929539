"""The recurrent mixers tensor-parallel over the mesh's ``model`` axis
(``repro_torch.sharding.rules.tensor_parallel``: the RG-LRU's channels by
``rnn``, the mLSTM's heads, the sLSTM's ``ff``) against the JAX package on
the CPU, in float32, with the reference's own weights.

- ``MeshProcs.forward`` on a (2, 4) mesh of processes for recurrentgemma-2b
  (``reduced(n_layers=4)``: 256 RG-LRU channels, 64 a process; 4 query
  heads over 1 K/V head, so attention whole), xlstm-1.3b
  (``reduced(n_layers=8)``: seven mLSTM blocks of 4 heads, one a process,
  and an sLSTM block whose ``ff`` of 341 stays whole) and xlstm-1.3b with
  an sLSTM ``ff`` of 384 (``slstm_proj_factor=1.5``, split), 8 x 16
  tokens from ``PRNGKey(1)``: logits within 5e-4 of the reference's
  pjit-sharded forward (``shape_aware_sharding_tree`` on a (2, 4) mesh
  with ``Auto`` axes) and of its unsharded one; each process's
  collectives counted: one for the embedding, one a RG-LRU, mLSTM or
  split sLSTM block, one a dense MLP, one for the head's gather;
- the tensor-parallel ``TensorBackend`` on (1, 2) and (1, 4): 5 left-padded
  prompts of 3-18 tokens x 5 greedy tokens over 3 slots, bit for bit the
  reference ``TensorBackend``'s (one device; ``test_torch_tp_serve.py``
  holds its mesh serve to it): recurrentgemma-2b contiguous and paged,
  xlstm-1.3b contiguous; each
  process's split recurrent state (RG-LRU ``h``, ``conv``; mLSTM ``C``,
  ``n``, ``m``) 1/N of one process's, its whole state (positions, the
  sLSTM's) one process's, ``info``'s cache bytes the processes' sum;
- the port's placements where they differ from the reference's axes: the
  mLSTM in Megatron's form (``w_up`` whole and its gradient a share), the
  sLSTM's recurrence whole;
- the serve launcher's ``--devices 2`` and the train launcher's
  ``--devices 4 --mesh-model 2`` print one process's lines for both
  models.

The reference runs once, in two subprocesses with 8 faked XLA devices
started with the module (the forwards, the serves), read after the tests
that need no reference; each mesh of processes is spawned once and closed
after its test, and no child process is left.
"""
import dataclasses
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
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.mesh_procs import MeshProcs  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_test_mesh  # noqa: E402
from repro_torch.runtime import TensorBackend  # noqa: E402
from repro_torch.runtime.tensor import MeshTensorBackend  # noqa: E402
from repro_torch.serving import LLM, SamplingParams  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402

torch.set_num_threads(2)

#: the reference test's tolerance (tests/test_pipeline_runtime.py): its
#: pjit-sharded forward against its unsharded one
FORWARD_TOL = dict(rtol=5e-4, atol=5e-4)
#: (case, arch, layers, config changes)
MODELS = {
    "recurrentgemma-2b": ("recurrentgemma-2b", 4, {}),
    "xlstm-1.3b": ("xlstm-1.3b", 8, {}),
    "xlstm-1.3b ff384": ("xlstm-1.3b", 8, dict(slstm_proj_factor=1.5)),
}
BATCH, SEQ = 8, 16
SLOTS, MAX_LEN, BS, TOKENS = 3, 32, 8, 5
LENS = (3, 18, 13, 5, 9)
#: (case, layout) the reference serves
SERVES = (("recurrentgemma-2b", "contiguous"), ("recurrentgemma-2b", "paged"),
          ("xlstm-1.3b", "contiguous"))
TIMEOUT = 60

_REFERENCE = r"""
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import transformer as T
from repro.runtime import TensorBackend
from repro.serving import LLM, SamplingParams
from repro.sharding.rules import (current_rules, shape_aware_sharding_tree,
                                  use_mesh)
b, s, slots, max_len, bs, n = map(int, sys.argv[1:7])
out, what, spec = sys.argv[7], sys.argv[8], json.loads(sys.argv[9])
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
res, tokens_out = {}, {}
for case, (arch, layers, changes) in spec["models"].items():
    cfg = dataclasses.replace(get_config(arch).reduced(n_layers=layers),
                              **changes)
    params, axes = T.init_params(cfg, jax.random.PRNGKey(0))
    if what == "forward":
        tokens = jax.random.randint(jax.random.PRNGKey(1), (b, s), 0,
                                    cfg.vocab_size)
        res[case + "/tokens"] = np.asarray(tokens)
        res[case + "/plain"] = np.asarray(
            T.forward(cfg, params, tokens, mode="train")[0], np.float32)
        with use_mesh(mesh):
            placed = jax.device_put(params, shape_aware_sharding_tree(
                params, axes, mesh, current_rules()))
            fn = jax.jit(lambda p, t: T.forward(cfg, p, t, mode="train")[0])
            res[case + "/sharded"] = np.asarray(fn(placed, tokens),
                                                np.float32)
        continue
    for served, layout in spec["serves"]:
        if served != case:
            continue
        prompts = [np.asarray(p, np.int32) for p in spec["prompts"][case]]
        llm = LLM.from_backend(TensorBackend(
            cfg, params, n_slots=slots, max_len=max_len, impl="xla",
            cache_layout=layout, block_size=bs))
        tokens_out[f"{case}/{layout}"] = [
            [int(t) for t in o.tokens]
            for o in llm.generate(prompts, SamplingParams(max_tokens=n))]
res["serves"] = np.asarray(json.dumps(tokens_out))
np.savez(out, **res)
"""


def _prompts(cfg, lens=LENS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


_STATE = {}


def _model(case):
    """(the port's config, the reference's weights as the port's)."""
    if case not in _STATE:
        arch, layers, changes = MODELS[case]
        jcfg = dataclasses.replace(
            jax_get_config(arch).reduced(n_layers=layers), **changes)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tcfg = dataclasses.replace(get_config(arch).reduced(n_layers=layers),
                                   **changes)
        _STATE[case] = (tcfg, params_from_numpy(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    return _STATE[case]


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's forwards and its greedy tokens, computed in two
    subprocesses started with the module and read at the first test that
    needs each."""
    spec = dict(models=MODELS, serves=SERVES,
                prompts={case: [p.tolist() for p in _prompts(_model(case)[0])]
                         for case, _ in SERVES})
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "src"))
    runs = {}
    for what in ("forward", "serve"):
        out = tmp_path_factory.mktemp("reference") / f"{what}.npz"
        runs[what] = (out, subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(BATCH), str(SEQ),
             str(SLOTS), str(MAX_LEN), str(BS), str(TOKENS), str(out), what,
             json.dumps(spec)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    done = {}

    def result(what):
        if what not in done:
            out, proc = runs[what]
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            got = dict(np.load(out))
            done[what] = dict(got, serves=json.loads(str(got["serves"])))
        return done[what]
    yield result
    for _, proc in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


# --------------------------------------------------------------------------- #
# the port's placements (no process)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("m, slstm_split", [(2, True), (4, False)])
def test_mlstm_megatron_form_and_slstm_whole_recurrence(m, slstm_split):
    """xlstm-1.3b at full size on (1, m): an mLSTM block's ``w_up`` whole
    (its gradient a share, summed over ``model``), its heads' q/k/v,
    gate and output-gate columns, gates and biases split by head, its
    ``w_down`` by rows; an sLSTM block's recurrent weights and input
    projections whole, its up/down-projection split by ``ff`` where its
    2730 columns divide (on 2, not on 4)."""
    cfg = get_config("xlstm-1.3b")
    mesh = Mesh(("data", "model"), (1, m))
    rules = R.tp_rules(cfg, mesh)
    specs = R._tp_specs(cfg, mesh, rules)
    mlstm, slstm = specs["layers"][0]["mixer"], specs["layers"][7]["mixer"]
    assert mlstm["w_up"] == R.P(None, None)
    for k in ("w_gate", "wq", "wk", "wv", "w_i", "w_f"):
        assert mlstm[k] == R.P(None, "model"), k
    assert mlstm["b_i"] == mlstm["b_f"] == R.P("model")
    assert mlstm["w_down"] == R.P("model", None)
    for g in "ifzo":
        assert slstm[f"r_{g}"] == R.P(None, None, None)
        assert slstm[f"w_{g}"] == R.P(None, None)
    ff = "model" if slstm_split else None
    assert slstm["w_up"] == R.P(None, ff)
    assert slstm["w_down"] == R.P(ff, None)
    local = R.local_config(cfg, mesh, rules)
    assert (local.n_heads, local.mlstm_proj_factor) == (4 // m, 2.0 / m)
    struct = R._map(lambda _: 0, specs, lambda t: isinstance(t, R.P))
    partial = R.tp_leaves(cfg, mesh, rules, struct)[2]
    kinds = [s.kind for s in cfg.layer_specs()]
    shares = [p for p, s in zip(_leaf_paths(struct), partial) if s]
    assert shares == [f"layers/{i}/mixer/w_up"
                      for i, k in enumerate(kinds) if k == "mlstm"]


# --------------------------------------------------------------------------- #
# the launchers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b"])
def test_serve_launcher_devices_prints_the_same_req_lines(arch, capsys):
    """``--devices 2`` serves on a (1, 2) mesh of processes (the RG-LRU's
    channels or the mLSTM's heads split) and prints the ``req`` lines of
    the one-process serve."""
    from repro_torch.launch.serve import main
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "4",
            "--slots", "2", "--varlen", "--prompt-len", "12", "--gen", "4",
            "--impl", "cuda"]

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


_STEP_LINE = re.compile(r"step\s+(\d+) loss (\S+) ")


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b"])
def test_train_launcher_mesh_prints_the_losses_of_one_process(arch, capsys):
    """``--devices 4 --mesh-model 2 --device cpu`` against the same command
    without ``--devices``: the same loss lines, to the print's 4
    decimals, and the same closing line."""
    from repro_torch.launch import train as train_launcher
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--log-every", "1"]
    out = []
    for extra in ((), ("--devices", "4", "--mesh-model", "2")):
        train_launcher.main(argv + list(extra))
        text = capsys.readouterr().out
        out.append(([m.groups() for m in _STEP_LINE.finditer(text)],
                    [ln for ln in text.splitlines()
                     if ln.startswith("first loss")]))
    one, mesh = out
    assert len(one[0]) == 2 and len(one[1]) == 1
    assert mesh == one


# --------------------------------------------------------------------------- #
# the whole-model forward on a (2, 4) mesh of processes
# --------------------------------------------------------------------------- #

def _expected_calls(cfg, rules):
    """Each process's collectives in a forward: the embedding's sum, one
    sum a RG-LRU block (``rnn`` split), an mLSTM block (heads split), an
    sLSTM block with its ``ff`` split, a dense MLP (``ff`` split) and an
    attention block (heads split), and the head's gather."""
    split = {a: rules.spec((a,))[0] is not None
             for a in ("rnn", "heads", "ff", "vocab")}
    calls = 2 * split["vocab"]
    for spec in cfg.layer_specs():
        calls += {"rglru": split["rnn"], "mlstm": split["heads"],
                  "slstm": split["ff"], "attn": split["heads"]}[spec.kind]
        calls += spec.kind != "slstm" and spec.mlp != "none" and split["ff"]
    return calls


@pytest.mark.parametrize("case", sorted(MODELS))
def test_forward_on_the_mesh_matches_the_sharded_reference(case, reference):
    """``MeshProcs.forward`` on a (2, 4) mesh: logits within 5e-4 of the
    reference's pjit-sharded forward and of its unsharded one; every
    process's collectives as :func:`_expected_calls` counts them, the
    recurrent leaves of its first block at the local counts."""
    cfg, params = _model(case)
    ref = reference("forward")
    procs = MeshProcs(cfg, params, make_test_mesh(2, 4), device="cpu",
                      timeout=TIMEOUT)
    try:
        procs.zero_stats()
        got = procs.forward(torch.from_numpy(ref[case + "/tokens"]).long())
        stats = procs.stats()
        views = procs.run(ranks.tp_shapes)
    finally:
        procs.close()
    np.testing.assert_allclose(got.numpy(), ref[case + "/sharded"],
                               **FORWARD_TOL)
    np.testing.assert_allclose(got.numpy(), ref[case + "/plain"],
                               **FORWARD_TOL)
    mesh = Mesh(("data", "model"), (2, 4))
    rules = R.tp_rules(cfg, mesh)
    calls = _expected_calls(cfg, rules)
    assert [st["tp"]["calls"] for st in stats] == [calls] * 8
    d = cfg.d_model
    _, leaves = views[0]
    assert all(v == views[0] for v in views)
    if cfg.layer_specs()[0].kind == "rglru":
        assert calls == 2 + 3 + 4                  # 3 RG-LRU, 4 dense MLPs
        r = cfg.rnn_dim // 4
        assert leaves["mixer/w_rnn_in"] == (d, r)
        assert leaves["mixer/conv_w"] == (cfg.conv_width, r)
        assert leaves["mixer/lam"] == (r,)
        assert leaves["mixer/w_out"] == (r, d)
    else:
        dp = int(d * cfg.mlstm_proj_factor)
        assert calls == 2 + 7 + (case == "xlstm-1.3b ff384")
        assert leaves["mixer/w_up"] == (d, dp)
        assert leaves["mixer/wq"] == (dp, dp // 4)
        assert leaves["mixer/w_i"] == (dp, 1)
        assert leaves["mixer/w_down"] == (dp // 4, d)


# --------------------------------------------------------------------------- #
# the tensor-parallel TensorBackend on (1, 2) and (1, 4)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case, layout", SERVES)
def test_tokens_equal_the_reference(case, layout, n, reference):
    """Greedy tokens of left-padded prompts bit for bit the reference
    ``TensorBackend``'s; each process holds
    1/n of one process's split recurrent state and all of its whole
    state; ``info`` sums the processes' cache bytes."""
    cfg, params = _model(case)
    prompts = _prompts(cfg)
    want = reference("serve")["serves"][f"{case}/{layout}"]
    kw = dict(cache_layout=layout, block_size=BS)
    be = TensorBackend(cfg, params, SLOTS, MAX_LEN,
                       Mesh(("data", "model"), (1, n)), device="cpu",
                       timeout=TIMEOUT, **kw)
    try:
        assert isinstance(be, MeshTensorBackend)
        llm = LLM.from_backend(be)
        got = [list(o.tokens) for o in llm.generate(
            prompts, SamplingParams(max_tokens=TOKENS))]
        states = be.procs.run(ranks.recurrent_state_bytes)
        info = be.info
    finally:
        be.close()
    assert got == want
    one = TensorBackend(cfg, params, n_slots=SLOTS, max_len=MAX_LEN,
                        device="cpu", **kw)
    split, whole = ranks.state_bytes(one.caches, cfg)
    assert split > 0
    assert [st[:2] for st in states] == [(split // n, whole)] * n
    assert info.cache_bytes_per_slot == sum(st[2] for st in states)
    assert not any(p.is_alive() for p in be.procs.procs)


def test_close_leaves_no_process():
    assert multiprocessing.active_children() == []
