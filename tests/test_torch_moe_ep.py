"""The expert-parallel MoE (``repro_torch.models.moe.moe_ep``) on a (2, 4)
mesh of processes on the CPU, in float32, with the reference's own
weights: granite-moe-1b-a400m reduced to 4 layers (4 experts top-2, one a
process of the model axis), as in the reference's
``tests/test_pipeline_runtime.py``.

- ``_dispatch_buckets`` equals the reference's exactly (buckets, slot,
  keep), capacities from 1 to dropless;
- ``moe_ep`` at capacity factors 8.0 (no drop) and 1.25 (drops) against
  the reference's on ``jax.make_mesh((2, 4))`` at the reference's 2e-4,
  each process's drop mask equal to the reference's for its rows, and at
  8.0 against the port's dropless ``moe_ragged``;
- ``apply_moe`` under the mesh where T = 2 x 23 is no multiple of the 8
  processes (padded, blocks across the data rows), at the capacity factor
  1.25, where drops make the blocks matter, against the reference's;
  where ``model`` does not divide the experts, ``moe_ragged`` (no
  ``moe_ep`` call) against the reference's;
- the whole model's ``forward(mode="train")`` on the mesh (batch rows over
  data, heads and vocabulary tensor-parallel over model, every MoE layer
  on ``moe_ep``) against the reference's unsharded forward at its 5e-4;
  no child process is left.

The reference runs once, in a subprocess with 8 faked XLA devices (its
mesh's axes of type ``Auto``) started with the module; the mesh of
processes is spawned once a module.
"""
import dataclasses
import multiprocessing
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.mesh_procs import MeshProcs  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

torch.set_num_threads(2)

#: the reference's own tolerances (tests/test_pipeline_runtime.py): its
#: expert-parallel MoE against moe_ragged, its sharded forward against
#: the unsharded one
MOE_TOL = dict(rtol=2e-4, atol=2e-4)
FORWARD_TOL = dict(rtol=5e-4, atol=5e-4)
ARCH, LAYERS = "granite-moe-1b-a400m", 4
TIMEOUT = 60
N_TOKENS = 64                  # moe_ep: 8 a process
ODD = (2, 23)                  # apply_moe: 46 tokens over 8 processes
FORWARD = (8, 16)              # the whole model

_REFERENCE = r"""
import sys
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import moe as M, transformer as T
from repro.sharding.rules import use_mesh
n_tokens, b, s, fb, fs = map(int, sys.argv[1:6])
out = sys.argv[6]
cfg = get_config("granite-moe-1b-a400m").reduced(n_layers=4)
params, _ = T.init_params(cfg, jax.random.PRNGKey(0))
moe = cfg.pattern[0].moe
p0 = jax.tree.map(lambda x: x[0], params["stack"]["p0"]["ffn"])
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
res = {}
x = jax.random.normal(jax.random.PRNGKey(1), (n_tokens, cfg.d_model))
res["x"] = np.asarray(x)
res["ragged"] = np.asarray(M.moe_ragged(p0, moe, x)[0])
t_loc = n_tokens // 8
for cf in (8.0, 1.25):
    with use_mesh(mesh):
        y, aux = M.moe_ep(p0, moe, x, capacity_factor=cf)
    res[f"ep{cf}"], res[f"aux{cf}"] = np.asarray(y), np.asarray(aux)
    cap = max(1, int(-(-t_loc * moe.top_k * cf // moe.num_experts)))
    keeps = []
    for k in range(8):
        rows = x[k * t_loc:(k + 1) * t_loc]
        _, ids, _ = M.router_topk(p0["router"], rows, moe)
        flat = ids.reshape(-1)
        _, _, keep = M._dispatch_buckets(jnp.repeat(rows, moe.top_k, 0),
                                         flat, moe.num_experts, cap)
        keeps.append(np.asarray(keep))
    res[f"keep{cf}"] = np.stack(keeps)
xo = jax.random.normal(jax.random.PRNGKey(2), (b, s, cfg.d_model))
res["odd_x"] = np.asarray(xo)
tight = dataclasses.replace(moe, capacity_factor=1.25)
with use_mesh(mesh):
    y, aux = M.apply_moe(p0, cfg, tight, xo)
res["odd_y"], res["odd_aux"] = np.asarray(y), np.asarray(aux)
res["odd_ragged"] = np.asarray(
    M.moe_ragged(p0, moe, xo.reshape(b * s, -1))[0]).reshape(b, s, -1)
two = dict(p0, router=p0["router"][:, :2],
           **{k: p0[k][:2] for k in ("w_gate", "w_up", "w_down")})
pair = dataclasses.replace(moe, num_experts=2)
with use_mesh(mesh):
    y, aux = M.apply_moe(two, cfg, pair, xo)
res["two_y"], res["two_aux"] = np.asarray(y), np.asarray(aux)
tokens = jax.random.randint(jax.random.PRNGKey(3), (fb, fs), 0,
                            cfg.vocab_size)
res["tokens"] = np.asarray(tokens)
res["forward"] = np.asarray(T.forward(cfg, params, tokens,
                                      mode="train")[0], np.float32)
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's results, computed in a subprocess started with the
    module and read at the first test that needs them."""
    out = tmp_path_factory.mktemp("reference") / "moe.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(N_TOKENS), *map(str, ODD),
         *map(str, FORWARD), str(out)], env=env, stdout=subprocess.PIPE,
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


def _model():
    if "model" not in _STATE:
        jcfg = jax_get_config(ARCH).reduced(n_layers=LAYERS)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tcfg = get_config(ARCH).reduced(n_layers=LAYERS)
        _STATE["model"] = (tcfg, params_from_numpy(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    return _STATE["model"]


def _mesh():
    if "mesh" not in _STATE:
        cfg, params = _model()
        _STATE["mesh"] = MeshProcs(cfg, params, make_test_mesh(),
                                   device="cpu", timeout=TIMEOUT)
    return _STATE["mesh"]


def _by_rank(results):
    """Per-process results stacked in rank order (tokens' block order)."""
    return [np.stack([r[i] if isinstance(r[i], np.ndarray)
                      else np.asarray(r[i]) for r in results])
            for i in range(len(results[0]))]


# --------------------------------------------------------------------------- #
# the dispatch
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("cap", [1, 3, 5, 24])
def test_dispatch_buckets_equal_the_reference(cap):
    """Seeded assignments of 24 rows to 4 experts: the buckets, each
    assignment's slot and the drop mask are the reference's exactly."""
    rng = np.random.default_rng(cap)
    x = rng.standard_normal((24, 8)).astype(np.float32)
    ids = rng.integers(0, 4, 24).astype(np.int32)
    want = JM._dispatch_buckets(jnp.asarray(x), jnp.asarray(ids), 4, cap)
    got = M._dispatch_buckets(torch.from_numpy(x),
                              torch.from_numpy(ids).long(), 4, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool


# --------------------------------------------------------------------------- #
# moe_ep
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_ep_matches_the_reference(cf, reference):
    """Each process's rows of y against the reference's ``moe_ep`` at 2e-4,
    its drop mask equal to the reference's for the same rows, the aux
    loss the reference's mean; at 8.0 nothing drops and y is the dropless
    ``moe_ragged``'s, at 1.25 some assignments drop."""
    procs = _mesh()
    cfg, params = _model()
    ref = reference()
    x = torch.from_numpy(ref["x"])
    y, aux, keep = _by_rank(procs.run(ranks.moe_ep_rows, 0, x, cf))
    np.testing.assert_allclose(y.reshape(N_TOKENS, -1), ref[f"ep{cf}"],
                               **MOE_TOL)
    np.testing.assert_array_equal(keep, ref[f"keep{cf}"])
    np.testing.assert_allclose(aux, float(ref[f"aux{cf}"]), **MOE_TOL)
    if cf == 8.0:
        assert keep.all()
        np.testing.assert_allclose(y.reshape(N_TOKENS, -1), ref["ragged"],
                                   **MOE_TOL)
        local, _ = M.moe_ragged(params["layers"][0]["ffn"],
                                cfg.layer_specs()[0].moe, x)
        np.testing.assert_allclose(y.reshape(N_TOKENS, -1), local.numpy(),
                                   **MOE_TOL)
    else:
        assert not keep.all()


def test_apply_moe_pads_tokens_the_processes_do_not_divide(reference):
    """46 tokens (2 rows of 23, a row a data point) over 8 processes at the
    capacity factor 1.25: padded to 48, each process's block of 6 taken
    across the data rows as the reference takes it (drops make the blocks
    matter: the reference's y is not the dropless one); each data row's
    processes return its rows of the reference's y."""
    procs = _mesh()
    cfg, _ = _model()
    ref = reference()
    assert np.abs(ref["odd_y"] - ref["odd_ragged"]).max() > 1e-2
    tight = dataclasses.replace(cfg.layer_specs()[0].moe,
                                capacity_factor=1.25)
    out = procs.run(ranks.apply_moe_rows, 0, torch.from_numpy(ref["odd_x"]),
                    tight)
    for rank, (y, aux, calls) in enumerate(out):
        row = procs.mesh.coords(rank)["data"]
        np.testing.assert_allclose(y.numpy(), ref["odd_y"][row:row + 1],
                                   **MOE_TOL)
        np.testing.assert_allclose(aux, float(ref["odd_aux"]), **MOE_TOL)
        assert calls == 1


def test_experts_the_model_axis_does_not_divide_take_moe_ragged(reference):
    """Two experts on a model axis of 4: ``apply_moe`` takes
    ``moe_ragged`` as the reference does (no ``moe_ep`` call), with the
    reference's y."""
    procs = _mesh()
    cfg, _ = _model()
    ref = reference()
    pair = dataclasses.replace(cfg.layer_specs()[0].moe, num_experts=2)
    out = procs.run(ranks.apply_moe_rows, 0, torch.from_numpy(ref["odd_x"]),
                    pair, 2)
    for rank, (y, aux, calls) in enumerate(out):
        row = procs.mesh.coords(rank)["data"]
        np.testing.assert_allclose(y.numpy(), ref["two_y"][row:row + 1],
                                   **MOE_TOL)
        np.testing.assert_allclose(aux, float(ref["two_aux"]), **MOE_TOL)
        assert calls == 0


def test_moe_ep_needs_a_mesh_process():
    """Without an installed mesh of processes ``moe_ep`` refuses; without
    a mesh ``apply_moe`` takes ``moe_ragged``."""
    cfg, params = _model()
    ffn, moe = params["layers"][0]["ffn"], cfg.layer_specs()[0].moe
    x = torch.randn(8, cfg.d_model)
    with pytest.raises(ValueError, match="mesh process"):
        M.moe_ep(ffn, moe, x)
    y, _ = M.apply_moe(ffn, cfg, moe, x[None])
    np.testing.assert_array_equal(y[0].numpy(),
                                  M.moe_ragged(ffn, moe, x)[0].numpy())


# --------------------------------------------------------------------------- #
# the whole model
# --------------------------------------------------------------------------- #

def test_forward_on_the_mesh_matches_the_unsharded_reference(reference):
    """``forward(mode="train")`` on the mesh's processes under
    ``use_mesh``: batch rows over data, the attention's heads and the
    vocabulary split over model (one head and 128 vocabulary rows a
    process), all 4 MoE layers on ``moe_ep`` (one expert a process),
    against the reference's unsharded forward at its 5e-4 and the port's
    in one process; each process made one ``moe_ep`` call a layer, at
    the reduced config's capacity factor of 8.0, dropping nothing."""
    procs = _mesh()
    cfg, params = _model()
    ref = reference()
    tokens = torch.from_numpy(ref["tokens"]).long()
    procs.zero_stats()
    got = procs.forward(tokens)
    np.testing.assert_allclose(got.numpy(), ref["forward"], **FORWARD_TOL)
    local, _ = T.forward(cfg, params, tokens, mode="train")
    np.testing.assert_allclose(got.numpy(), local.numpy(), **FORWARD_TOL)
    for st in procs.stats():
        assert [r["dropped"] for r in st["moe"]] == [0] * LAYERS
        assert all(r["rows"] == FORWARD[0] * FORWARD[1] // 8
                   * cfg.layer_specs()[0].moe.top_k for r in st["moe"])
    with pytest.raises(ValueError, match="does not split"):
        procs.forward(tokens[:3])


def test_close_leaves_no_process():
    _mesh().close()
    _STATE.pop("mesh")
    assert multiprocessing.active_children() == []
