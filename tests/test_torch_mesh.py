"""The port's mesh descriptions and sharding rules
(``repro_torch.launch.mesh``, ``repro_torch.sharding``) against the JAX
package's, exactly.

- ``AxisRules.spec`` of the four rule sets (default, long-context,
  decode-seq-model, FSDP), single-pod and multi-pod, over every leaf of
  the reference's parameter ``axes`` tree for every registry config at
  full size, against the reference's ``PartitionSpec``\\ s;
- ``shape_aware_sharding_tree`` on (2, 4) and (2, 3) meshes, where some
  dimensions are no multiple of the model axis (granite-moe's vocabulary
  of 49155; most widths on 3), and ``param_sharding_tree``, against the
  reference's;
- each rank's ``local_slice`` of every leaf of three reduced configs (and
  of specs over two axes at once), against the reference's
  ``addressable_shards`` on a faked (2, 4) mesh;
- the mesh descriptions, ``use_mesh``'s thread-local context, and no TPU
  constant in the port.

The reference runs once, in a subprocess with 8 faked XLA devices started
with the module; the rules themselves need no device.
"""
import json
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402

RULES = ("default", "long_context", "decode_seq_model", "fsdp")
#: reduced configs whose leaves are placed on the faked mesh
PLACED = ("qwen3-0.6b", "granite-moe-1b-a400m", "gemma2-2b")
#: specs over two axes at once, placed on a [16, 8] array
TWO_AXES = ((("data", "model"), None), (None, ("model", "data")))

_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import CONFIGS, get_config
from repro.models import transformer as T
from repro.sharding import rules as R

RULES = ("default", "long_context", "decode_seq_model", "fsdp")

def entry(e):
    return list(e) if isinstance(e, tuple) else e

def spec(p):
    return [entry(e) for e in p]

def is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)

def paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_axes)
    return ["/".join(str(k.key) for k in path) for path, _ in flat]

def axes_and_shapes(cfg):
    captured = {}
    def init(key):
        p, a = T.init_params(cfg, key)
        captured["axes"] = a
        return p
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return shapes, captured["axes"]

devices = jax.devices()
meshes = {"2x4": jax.make_mesh((2, 4), ("data", "model"),
                               devices=devices[:8]),
          "2x3": jax.make_mesh((2, 3), ("data", "model"),
                               devices=devices[:6])}
out = {"configs": {}, "placed": {}}
for name in sorted(CONFIGS):
    shapes, axes = axes_and_shapes(get_config(name))
    leaves = jax.tree.leaves(axes, is_leaf=is_axes)
    rec = {"paths": paths(axes), "axes": [list(a) for a in leaves],
           "shapes": [list(s.shape) for s in jax.tree.leaves(shapes)],
           "specs": {}, "aware": {}}
    for rules in RULES:
        for multi in (False, True):
            r = getattr(R, rules + "_rules")(multi)
            rec["specs"][f"{rules}/{multi}"] = [spec(r.spec(a))
                                                for a in leaves]
    for key, mesh in meshes.items():
        tree = R.shape_aware_sharding_tree(shapes, axes, mesh,
                                           R.default_rules())
        rec["aware"][key] = [spec(s.spec) for s in jax.tree.leaves(tree)]
    with R.use_mesh(meshes["2x4"]):
        tree = R.param_sharding_tree(axes)
    rec["param"] = [spec(s.spec) for s in jax.tree.leaves(tree)]
    out["configs"][name] = rec

mesh = meshes["2x4"]
order = list(mesh.devices.flat)

def shard_slices(arr):
    got = [None] * len(order)
    for sh in arr.addressable_shards:
        got[order.index(sh.device)] = [
            [sl.start or 0, sl.stop if sl.stop is not None else n]
            for sl, n in zip(sh.index, arr.shape)]
    return got

for name in sys.argv[2:]:
    cfg = get_config(name).reduced(n_layers=4)
    params, axes = T.init_params(cfg, jax.random.PRNGKey(0))
    tree = R.shape_aware_sharding_tree(params, axes, mesh, R.default_rules())
    placed = jax.device_put(params, tree)
    out["placed"][name] = {
        "paths": paths(axes),
        "axes": [list(a) for a in jax.tree.leaves(axes, is_leaf=is_axes)],
        "shapes": [list(x.shape) for x in jax.tree.leaves(params)],
        "specs": [spec(s.spec) for s in jax.tree.leaves(tree)],
        "slices": [shard_slices(x) for x in jax.tree.leaves(placed)]}
two = []
for s in json.loads(sys.argv[1]):
    p = P(*[tuple(e) if isinstance(e, list) else e for e in s])
    x = jax.device_put(jnp.zeros((16, 8)), NamedSharding(mesh, p))
    two.append(shard_slices(x))
out["two_axes"] = two
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's specs and placements (started with the module)."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, json.dumps(TWO_AXES), *PLACED],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out)


def _spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]


def _tree(paths, leaves):
    """A nested dict of ``leaves`` at their reference paths."""
    tree = {}
    for path, leaf in zip(paths, leaves):
        *parents, name = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = leaf
    return tree


def _flat(tree, paths):
    out = []
    for path in paths:
        node = tree
        for key in path.split("/"):
            node = node[key]
        out.append(node)
    return out


def _axes(rec):
    return [tuple(a) for a in rec["axes"]]


def _shapes(rec):
    return [SimpleNamespace(shape=tuple(s)) for s in rec["shapes"]]


# --------------------------------------------------------------------------- #
# rules
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("name", sorted(TC.CONFIGS))
def test_rule_specs_equal_the_reference(reference, name, rules):
    """Every leaf of the reference's axes tree: the port's spec under
    ``rules``, single-pod and multi-pod, is the reference's exactly."""
    rec = reference["configs"][name]
    assert len(rec["axes"]) == len(rec["shapes"]) > 0
    for multi in (False, True):
        r = getattr(R, rules + "_rules")(multi)
        assert [_spec(r.spec(a)) for a in _axes(rec)] == \
            rec["specs"][f"{rules}/{multi}"], (name, rules, multi)


@pytest.mark.parametrize("name", sorted(TC.CONFIGS))
def test_shape_aware_and_param_sharding_trees_equal_the_reference(
        reference, name):
    """``shape_aware_sharding_tree`` drops the axes the reference drops on
    a (2, 4) and a (2, 3) mesh; ``param_sharding_tree`` under the default
    rules of an installed (2, 4) mesh gives the reference's specs, and
    without a mesh a tree of None of the same structure."""
    rec = reference["configs"][name]
    axes = _tree(rec["paths"], _axes(rec))
    shapes = _tree(rec["paths"], _shapes(rec))
    for key, mesh in (("2x4", PM.make_test_mesh(2, 4)),
                      ("2x3", PM.make_test_mesh(2, 3))):
        tree = R.shape_aware_sharding_tree(shapes, axes, mesh,
                                           R.default_rules())
        got = _flat(tree, rec["paths"])
        assert all(s.mesh == mesh for s in got)
        assert [_spec(s.spec) for s in got] == rec["aware"][key], key
    with R.use_mesh(PM.make_test_mesh()):
        got = _flat(R.param_sharding_tree(axes), rec["paths"])
    assert [_spec(s.spec) for s in got] == rec["param"]
    assert _flat(R.param_sharding_tree(axes), rec["paths"]) == \
        [None] * len(rec["paths"])


def test_some_dimension_is_dropped(reference):
    """The shape-aware trees drop an axis somewhere: granite-moe's
    vocabulary of 49155 on the 4-way model axis, and more on 3."""
    rec = reference["configs"]["granite-moe-1b-a400m"]
    assert rec["aware"]["2x4"] != rec["param"]
    emb = rec["paths"].index("embedding")
    assert rec["shapes"][emb] == [49155, 1024]
    assert rec["param"][emb] == ["model", None]
    assert rec["aware"]["2x4"][emb] == [None, None]
    for r in reference["configs"].values():
        dropped = sum(a != b for a, b in zip(r["aware"]["2x3"], r["param"]))
        assert dropped > 0


# --------------------------------------------------------------------------- #
# local slices
# --------------------------------------------------------------------------- #

def _check_slices(x, spec, mesh, slices):
    for rank, want in enumerate(slices):
        got = R.local_slice(x, spec, mesh.at(rank))
        idx = tuple(slice(a, b) for a, b in want)
        assert torch.equal(got, x[idx]), (spec, rank, want)


@pytest.mark.parametrize("name", PLACED)
def test_local_slices_equal_the_reference_shards(reference, name):
    """Each rank's ``local_slice`` of every leaf of the reduced config is
    the block ``addressable_shards`` gives the device at its position of
    the faked (2, 4) mesh, under the same (shape-aware) specs."""
    rec = reference["placed"][name]
    mesh = PM.make_test_mesh()
    tree = R.shape_aware_sharding_tree(
        _tree(rec["paths"], _shapes(rec)), _tree(rec["paths"], _axes(rec)),
        mesh, R.default_rules())
    specs = _flat(tree, rec["paths"])
    assert [_spec(s.spec) for s in specs] == rec["specs"]
    sharded = 0
    for shape, s, slices in zip(rec["shapes"], specs, rec["slices"]):
        x = torch.arange(int(torch.Size(shape).numel())).reshape(shape)
        _check_slices(x, s.spec, mesh, slices)
        sharded += any(e is not None for e in s.spec)
    assert sharded > 0


def test_local_slices_over_two_axes(reference):
    """A dimension over two axes: blocks in the order of the axes' points,
    the first axis major (``("data", "model")`` and ``("model",
    "data")``)."""
    mesh = PM.make_test_mesh()
    x = torch.arange(128).reshape(16, 8)
    for spec, slices in zip(TWO_AXES, reference["two_axes"]):
        _check_slices(x, R.P(*spec), mesh, slices)


def test_local_slice_refuses_a_dimension_it_does_not_split():
    mesh = PM.make_test_mesh().at(0)
    with pytest.raises(ValueError, match="does not split"):
        R.local_slice(torch.zeros(6, 4), R.P("model"), mesh)
    with pytest.raises(ValueError, match="spec"):
        R.local_slice(torch.zeros(8), R.P("data", "model"), mesh)
    with pytest.raises(ValueError, match="host"):
        R.local_slice(torch.zeros(8), R.P("data"), PM.make_test_mesh())


# --------------------------------------------------------------------------- #
# meshes and the context
# --------------------------------------------------------------------------- #

def test_mesh_descriptions():
    """The reference's meshes, described: axes, sizes, chips, row-major
    ranks (``jax.make_mesh``'s device order)."""
    test = PM.make_test_mesh()
    assert test.axis_names == ("data", "model") and test.shape == {
        "data": 2, "model": 4} and PM.n_chips(test) == 8
    single, multi = PM.make_production_mesh(), \
        PM.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert PM.n_chips(single) == 256 and PM.n_chips(multi) == 512
    for mesh in (test, single, multi):
        for rank in range(mesh.size):
            c = mesh.coords(rank)
            assert mesh.rank_of(c) == rank
            assert list(c) == list(mesh.axis_names)
    assert test.coords(6) == {"data": 1, "model": 2}
    assert test.at(6).coords() == test.coords(6)
    assert test.at(6) != test and test.at(6, comm=object()) == test.at(6)
    for bad in ((("data",), (2, 4)), (("a", "a"), (2, 2)),
                (("data",), (0,))):
        with pytest.raises(ValueError):
            PM.Mesh(*bad)
    with pytest.raises(ValueError):
        test.at(8)


def test_the_card_constants_replace_the_tpu_ones():
    """The H100 SXM's datasheet figures stand where the reference keeps
    its TPU target's; none of those is left."""
    for tpu in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"):
        assert not hasattr(PM, tpu)
    assert PM.H100_SXM_PEAK_FLOPS_BF16 == 989e12
    assert PM.H100_SXM_PEAK_FLOPS_F32 == 67e12
    assert PM.H100_SXM_HBM_BW == 3.35e12
    assert PM.H100_SXM_NVLINK_BW == 900e9
    values = {v for k, v in vars(PM).items() if k.isupper()}
    assert not values & {197e12, 819e9, 50e9}


def test_use_mesh_is_thread_local_and_nests():
    """``use_mesh`` installs a mesh and its rules (the default ones of its
    axes unless given) for this thread only, and restores the previous
    pair on exit; ``logical_sharding`` is None without a mesh and
    ``logical_constraint`` is the identity."""
    assert R.current_mesh() is None and R.current_rules() is None
    assert R.logical_sharding(("batch",)) is None
    test, multi = PM.make_test_mesh(), PM.make_production_mesh(
        multi_pod=True)
    seen = []
    with R.use_mesh(test):
        assert R.current_rules() == R.default_rules(False)
        with R.use_mesh(multi, R.fsdp_rules(True)):
            assert R.current_mesh() is multi
            assert R.current_rules() == R.fsdp_rules(True)
            sh = R.logical_sharding(("batch", "embed", "heads"))
            assert sh == R.NamedSharding(multi, R.P(("pod", "data"),
                                                    "data", "model"))
        with R.use_mesh(multi):
            assert R.current_rules() == R.default_rules(True)
        assert R.current_mesh() is test
        t = threading.Thread(target=lambda: seen.append(
            (R.current_mesh(), R.current_rules())))
        t.start()
        t.join(10)
        x = torch.ones(3)
        assert R.logical_constraint(x, "batch") is x
    assert seen == [(None, None)] and not t.is_alive()
    assert R.current_mesh() is None and R.current_rules() is None


def test_partition_spec_normalises_as_the_reference():
    """An entry of one axis is that axis, an empty one None; two axes stay
    a tuple."""
    assert tuple(R.P(("data",), (), ("pod", "data"), None, "model")) == \
        ("data", None, ("pod", "data"), None, "model")
    assert R.P() == () and isinstance(R.P("x"), tuple)
