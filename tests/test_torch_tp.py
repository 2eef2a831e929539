"""Tensor parallelism over the mesh's ``model`` axis
(``repro_torch.sharding.rules.tensor_parallel``, the Megatron sums of
``model_sum``, the head's ``model_gather``) against the JAX package on the
CPU, in float32, with the reference's own weights.

- ``bridge.param_axes`` equals the reference's ``init_params`` axes for
  every registry config (reduced), leaf for leaf, the stacked leaves
  without their ``"layers"`` axis;
- ``tp_rules`` keeps whole heads (recurrentgemma-2b's one K/V head of 256
  stays whole on 4 though its width divides), drops what does not divide
  (granite-moe's vocabulary of 49155, xlstm-1.3b's sLSTM ``ff`` of 2730 on
  4) and splits the RG-LRU's channels and the mLSTM's heads
  (``tests/test_torch_tp_recurrent.py`` holds their forward and serves);
- every process's parameters are views of the whole tensors, cut to its
  config's local counts, the blocks over the model axis tiling the whole;
- ``MeshProcs.forward`` on a (2, 4) mesh of processes for qwen3-0.6b,
  granite-moe-1b-a400m and gemma2-2b (``reduced(n_layers=4)``, 8 x 16
  tokens from ``PRNGKey(1)``) within the reference test's 5e-4 of its
  pjit-sharded forward (``param_sharding_tree`` on a (2, 4) mesh with
  ``Auto`` axes) and of its unsharded one; on a (1, 3) mesh, where 4 heads
  do not split, attention runs replicated and the logits hold the same;
- bf16 partials sum in float32; the head's columns gather in coordinate
  order.

The reference runs once, in a subprocess with 8 faked XLA devices started
with the module; each mesh of processes is spawned once.
"""
import multiprocessing
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro.configs import CONFIGS as JAX_CONFIGS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import (init_params, param_axes,  # noqa: E402
                                params_from_numpy)
from repro_torch.configs import CONFIGS, get_config  # noqa: E402
from repro_torch.core.mesh_procs import MeshProcs  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_test_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402

torch.set_num_threads(2)

#: the reference test's tolerance (tests/test_pipeline_runtime.py): its
#: pjit-sharded forward against its unsharded one
FORWARD_TOL = dict(rtol=5e-4, atol=5e-4)
ARCHS = ("qwen3-0.6b", "granite-moe-1b-a400m", "gemma2-2b")
LAYERS, BATCH, SEQ = 4, 8, 16
TIMEOUT = 60

_REFERENCE = r"""
import sys
import jax, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import transformer as T
from repro.sharding.rules import use_mesh, param_sharding_tree
layers, b, s = map(int, sys.argv[1:4])
out, names = sys.argv[4], sys.argv[5:]
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
res = {}
for name in names:
    cfg = get_config(name).reduced(n_layers=layers)
    params, axes = T.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (b, s), 0,
                                cfg.vocab_size)
    res[name + "/tokens"] = np.asarray(tokens)
    res[name + "/plain"] = np.asarray(
        T.forward(cfg, params, tokens, mode="train")[0], np.float32)
    with use_mesh(mesh):
        placed = jax.device_put(params, param_sharding_tree(axes))
        fn = jax.jit(lambda p, t: T.forward(cfg, p, t, mode="train")[0])
        res[name + "/sharded"] = np.asarray(fn(placed, tokens), np.float32)
np.savez(out, **res)
"""


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's forwards, computed in a subprocess started with the
    module and read at the first test that needs them."""
    out = tmp_path_factory.mktemp("reference") / "tp.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(LAYERS), str(BATCH), str(SEQ),
         str(out), *ARCHS], env=env, stdout=subprocess.PIPE,
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
    """(the port's config, the reference's weights as the port's)."""
    if arch not in _STATE:
        jcfg = jax_get_config(arch).reduced(n_layers=LAYERS)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tcfg = get_config(arch).reduced(n_layers=LAYERS)
        _STATE[arch] = (tcfg, params_from_numpy(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    return _STATE[arch]


def _procs(arch, shape):
    key = (arch, shape)
    if key not in _STATE:
        cfg, params = _model(arch)
        _STATE[key] = MeshProcs(cfg, params, make_test_mesh(*shape),
                                device="cpu", timeout=TIMEOUT)
    return _STATE[key]


def _close(key):
    procs = _STATE.pop(key, None)
    if procs is not None:
        procs.close()


# --------------------------------------------------------------------------- #
# the axes, the rules and the placement (no process)
# --------------------------------------------------------------------------- #

def _reference_axes(arch):
    """The reference's ``init_params`` axes of ``arch`` reduced, in the
    port's layout: one dict a layer, stacked leaves without ``"layers"``."""
    cfg = JAX_CONFIGS[arch].reduced()
    captured = {}

    def init(key):
        params, axes = JT.init_params(cfg, key)
        captured["axes"] = axes
        return params
    jax.eval_shape(init, jax.random.PRNGKey(0))
    axes = captured["axes"]
    is_axes = lambda t: isinstance(t, tuple)  # noqa: E731
    out = {k: v for k, v in axes.items() if k not in ("stack", "tail")}
    n_stacked = cfg.n_full_periods * cfg.period
    out["layers"] = [
        jax.tree.map(lambda t: t[1:], axes["stack"][f"p{i % cfg.period}"],
                     is_leaf=is_axes)
        if i < n_stacked else axes["tail"][f"t{i - n_stacked}"]
        for i in range(cfg.n_layers)]
    return out


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_param_axes_equal_the_reference(arch):
    assert param_axes(get_config(arch).reduced()) == _reference_axes(arch)


def _rules(arch, m, reduced=False):
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    mesh = Mesh(("data", "model"), (1, m))
    rules = R.tp_rules(cfg, mesh)
    return cfg, mesh, rules, R.local_config(cfg, mesh, rules)


@pytest.mark.parametrize("arch, m, split", [
    ("llama2-7b", 4, dict(qkv="model", ff="model", vocab="model")),
    # one K/V head of 256: its width divides, the head does not; the
    # RG-LRU's 2560 channels split
    ("recurrentgemma-2b", 4, dict(qkv=None, ff="model", vocab="model",
                                  rnn="model")),
    ("recurrentgemma-2b", 2, dict(qkv=None, ff="model", vocab="model",
                                  rnn="model")),
    # a vocabulary of 49155
    ("granite-moe-1b-a400m", 4, dict(qkv="model", vocab=None)),
    # 40 heads: whole on 16, split on 4
    ("qwen1.5-32b", 16, dict(qkv=None, ff="model", vocab="model")),
    ("qwen1.5-32b", 4, dict(qkv="model", ff="model", vocab="model")),
    # no attention layer: the mLSTM's 4 heads split; the sLSTM's ff of
    # 2730 does not divide by 4
    ("xlstm-1.3b", 4, dict(qkv="model", ff=None, vocab="model")),
])
def test_tp_rules_take_whole_heads(arch, m, split):
    """The rules split what the model takes whole, by its head counts, and
    the RG-LRU's ``rnn`` where its width divides; the local config keeps
    every head width (the mLSTM's too) and counts its local channels."""
    cfg, _, rules, local = _rules(arch, m)
    for axis, entry in split.items():
        assert rules.spec((axis,))[0] == entry, axis
    assert rules.spec(("heads",)) == rules.spec(("kv_heads",)) \
        == rules.spec(("qkv",))
    assert rules.spec(("rnn",))[0] == split.get("rnn")
    assert rules.spec(("experts",))[0] == "model"
    assert local.resolved_head_dim == cfg.resolved_head_dim
    n = m if split.get("qkv") else 1
    assert (local.n_heads * n, local.n_kv_heads * n) == \
        (cfg.n_heads, cfg.n_kv_heads)
    assert local.rnn_dim * (m if split.get("rnn") else 1) == cfg.rnn_dim
    if any(s.kind == "mlstm" for s in cfg.layer_specs()):
        assert int(local.d_model * local.mlstm_proj_factor) \
            // local.n_heads == int(cfg.d_model * cfg.mlstm_proj_factor) \
            // cfg.n_heads
    assert local.vocab_size == cfg.vocab_size
    if arch == "llama2-7b":
        assert (local.n_heads, local.n_kv_heads, local.d_ff) == (8, 8, 2752)


def _same_storage(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_placement_is_views_at_the_local_counts(arch, m):
    """Every process's leaves are views of the whole tensors at its local
    config's counts: attention projections of its heads, dense FFNs of its
    ``ff`` columns, the vocabulary rows, an RG-LRU's leaves of its
    channels, an mLSTM's q/k/v, gate and gate-bias columns and
    down-projection rows of its heads (its up-projection whole), an
    sLSTM's up/down-projection of its ``ff`` columns (its recurrence
    whole), norms and MoE FFNs whole; the model axis's blocks tile each
    whole tensor in coordinate order."""
    cfg, mesh, rules, local = _rules(arch, m, reduced=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    views = [R.tensor_parallel(cfg, params, mesh.at(r)) for r in range(m)]
    for got_cfg, _, got_rules in views:
        assert (got_cfg, got_rules) == (local, rules)
    d, vocab = cfg.d_model, cfg.vocab_size
    split_vocab = rules.spec(("vocab",))[0] is not None
    shapes = {"embedding": (vocab // m if split_vocab else vocab, d),
              "lm_head": (d, vocab // m if split_vocab else vocab)}
    for i, spec in enumerate(cfg.layer_specs()):
        if spec.kind == "attn":
            q, kv = local.q_dim, local.kv_dim
            shapes.update({f"layers/{i}/mixer/wq": (d, q),
                           f"layers/{i}/mixer/wk": (d, kv),
                           f"layers/{i}/mixer/wv": (d, kv),
                           f"layers/{i}/mixer/wo": (q, d),
                           f"layers/{i}/mixer/bq": (q,),
                           f"layers/{i}/mixer/bk": (kv,),
                           f"layers/{i}/mixer/bv": (kv,)})
        if spec.kind == "rglru":
            r = local.rnn_dim
            shapes.update({f"layers/{i}/mixer/{k}": (d, r) for k in
                           ("w_gelu", "w_rnn_in", "w_a", "w_x")})
            shapes.update({f"layers/{i}/mixer/conv_w": (cfg.conv_width, r),
                           f"layers/{i}/mixer/conv_b": (r,),
                           f"layers/{i}/mixer/lam": (r,),
                           f"layers/{i}/mixer/w_out": (r, d)})
        if spec.kind == "mlstm":
            dp, h = int(d * cfg.mlstm_proj_factor), local.n_heads
            dl = int(d * local.mlstm_proj_factor)
            shapes.update({f"layers/{i}/mixer/{k}": (dp, dl) for k in
                           ("wq", "wk", "wv")})
            shapes.update({f"layers/{i}/mixer/w_gate": (d, dl),
                           f"layers/{i}/mixer/w_i": (dp, h),
                           f"layers/{i}/mixer/w_f": (dp, h),
                           f"layers/{i}/mixer/b_i": (h,),
                           f"layers/{i}/mixer/b_f": (h,),
                           f"layers/{i}/mixer/w_down": (dl, d)})
        if spec.kind == "slstm" and rules.spec(("ff",))[0] is not None:
            f = int(d * cfg.slstm_proj_factor) // m
            shapes.update({f"layers/{i}/mixer/w_up": (d, f),
                           f"layers/{i}/mixer/w_down": (f, d)})
        if spec.moe is None and spec.mlp != "none":
            f = local.d_ff
            shapes.update({f"layers/{i}/ffn/w_gate": (d, f),
                           f"layers/{i}/ffn/w_up": (d, f),
                           f"layers/{i}/ffn/w_down": (f, d)})

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}/")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}{i}/")
        else:
            yield prefix[:-1], tree

    whole = dict(leaves(params))
    placed = [dict(leaves(p)) for _, p, _ in views]
    for path, w in whole.items():
        blocks = [p[path] for p in placed]
        assert all(_same_storage(b, w) for b in blocks), path
        want = shapes.get(path, tuple(w.shape))
        assert all(tuple(b.shape) == want for b in blocks), (path, want)
        if want != tuple(w.shape):
            dim = [a != b for a, b in zip(want, w.shape)].index(True)
            torch.testing.assert_close(torch.cat(blocks, dim), w, rtol=0,
                                       atol=0)
        else:
            assert all(b.data_ptr() == w.data_ptr() for b in blocks), path


def test_the_helpers_are_the_identity_outside_a_mesh_process():
    """Without a mesh, and under a mesh in a process that is no point of
    it (no collectives), the sums, gathers and shard offsets change
    nothing."""
    x = torch.randn(2, 3)
    for ctx in (R.use_mesh(None), R.use_mesh(make_test_mesh())):
        with ctx:
            assert R.model_sum(x, "ff") is x
            assert R.model_gather(x, "vocab") is x
            assert R.shard_start("vocab", 128) is None


def test_bf16_partials_sum_in_float32():
    """``model_sum`` of bf16 partials is their float32 sum rounded once,
    on every process; with the vocabulary whole (512 on 3) the gather is
    the identity."""
    procs = _procs("qwen3-0.6b", (1, 3))
    out = procs.run(ranks.tp_sum_and_gather, 64)
    want = sum(p.float() for p, _, _ in out).to(torch.bfloat16)
    for part, total, gathered in out:
        assert total.dtype == torch.bfloat16
        assert torch.equal(total, want)
    assert not torch.equal(sum(p for p, _, _ in out), want)
    for rank, (_, _, gathered) in enumerate(out):
        assert torch.equal(gathered, torch.full((2, 3), float(rank)))


# --------------------------------------------------------------------------- #
# the whole-model forward on meshes of processes
# --------------------------------------------------------------------------- #

def test_heads_that_do_not_split_run_replicated(reference):
    """On a (1, 3) mesh qwen3-0.6b's 4 heads do not split: every process
    holds the whole attention and its vocabulary of 512 whole, and splits
    only ``ff`` (768 = 3 x 256); the logits are within 5e-4 of the
    reference's unsharded forward, one sum a layer."""
    arch = "qwen3-0.6b"
    cfg, _ = _model(arch)
    ref = reference()
    procs = _procs(arch, (1, 3))
    procs.zero_stats()
    got = procs.forward(torch.from_numpy(ref[arch + "/tokens"]).long())
    np.testing.assert_allclose(got.numpy(), ref[arch + "/plain"],
                               **FORWARD_TOL)
    for st in procs.stats():
        assert st["tp"]["calls"] == cfg.n_layers
    for counts, leaves in procs.run(ranks.tp_shapes):
        assert counts == (cfg.n_heads, cfg.n_kv_heads, cfg.d_ff // 3)
        assert leaves["mixer/wq"] == (cfg.d_model, cfg.q_dim)
        assert leaves["embedding"] == (cfg.vocab_size, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_on_the_mesh_matches_the_sharded_reference(arch, reference):
    """``MeshProcs.forward`` on a (2, 4) mesh: each process its quarter of
    the heads, K/V heads, ``ff`` and vocabulary, a batch row's half;
    logits within 5e-4 of the reference's pjit-sharded forward and of its
    unsharded one.  Every process sums each attention and dense MLP
    layer's output and the embedding, and gathers the head: one
    collective each; a gather over ``vocab`` concatenates the blocks
    along the last dimension in model coordinate order."""
    cfg, params = _model(arch)
    ref = reference()
    procs = _procs(arch, (2, 4))
    try:
        procs.zero_stats()
        got = procs.forward(torch.from_numpy(ref[arch + "/tokens"]).long())
        stats = procs.stats()
        views = procs.run(ranks.tp_shapes)
        gathered = [g for _, _, g in procs.run(ranks.tp_sum_and_gather, 8)]
    finally:
        _close((arch, (2, 4)))
    np.testing.assert_allclose(got.numpy(), ref[arch + "/sharded"],
                               **FORWARD_TOL)
    np.testing.assert_allclose(got.numpy(), ref[arch + "/plain"],
                               **FORWARD_TOL)
    dense = sum(s.moe is None and s.mlp != "none" for s in cfg.layer_specs())
    for st in stats:
        assert st["tp"]["calls"] == cfg.n_layers + dense + 2
    order = torch.arange(4.).repeat_interleave(3).expand(2, 12)
    assert all(torch.equal(g, order) for g in gathered)
    counts, leaves = views[0]
    assert all(v == views[0] for v in views)
    d, q, kv = cfg.d_model, cfg.q_dim // 4, cfg.kv_dim // 4
    assert counts[:2] == (cfg.n_heads // 4, cfg.n_kv_heads // 4)
    assert leaves["mixer/wq"] == (d, q) and leaves["mixer/wk"] == (d, kv)
    assert leaves["mixer/wo"] == (q, d)
    assert leaves["embedding"] == (cfg.vocab_size // 4, d)
    assert leaves["norm1/scale"] == (d,)
    if cfg.layer_specs()[0].moe is None:
        assert counts[2] == cfg.d_ff // 4
        assert leaves["ffn/w_down"] == (cfg.d_ff // 4, d)
    else:
        assert leaves["ffn/w_gate"] == tuple(
            params["layers"][0]["ffn"]["w_gate"].shape)


def test_close_leaves_no_process():
    _close(("qwen3-0.6b", (1, 3)))
    for key in [k for k in _STATE if isinstance(k, tuple)]:
        _close(key)
    assert multiprocessing.active_children() == []
