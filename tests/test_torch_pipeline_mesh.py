"""``pipeline_forward`` over a (2, 4) mesh of processes
(``repro_torch.core.mesh_procs.MeshProcs``) on the CPU, in float32, with
the reference's own weights: qwen3-0.6b reduced to 6 layers, as in the
reference's ``tests/test_pipeline_runtime.py``.

- against the reference's ``pipeline_forward`` on ``jax.make_mesh((2,
  4))`` (its axes of type ``Auto``: the reference's program indexes its
  ``shard_map`` output in a way the default ``Explicit`` axes of this jax
  refuse) at the reference's own 3e-4: stage layouts (1, 2, 2, 1),
  (3, 1, 1, 1), (1, 1, 1, 3) and (2, 2, 1, 1), with 2 and 4
  micro-batches; the stages over ``data`` and the rows over ``model``; a
  frontend's float embeddings in place of tokens;
- against the port's one-process ``pipeline_forward`` within 1e-5;
- what each process did: hop bytes to its next stage, none from the last;
- the ``ValueError``\\ s, raised before any process is asked; a process
  that raises makes the host raise, naming it; no child process is left.

The reference runs once, in a subprocess with 8 faked XLA devices started
with the module; the mesh is spawned once a module.
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
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.core.mesh_procs import MeshProcs  # noqa: E402
from repro_torch.core.stage_procs import StageProcError  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402

torch.set_num_threads(2)

#: the reference's own tolerance (tests/test_pipeline_runtime.py)
REFERENCE_TOL = dict(rtol=3e-4, atol=3e-4)
#: against the port in one process: the same arithmetic, the products at
#: other row counts
LOCAL_TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "qwen3-0.6b"
TIMEOUT = 60
#: (name, periods per stage, micro-batches, batch, seq, stage axis, float
#: inputs): the reference's own cases, then the other micro-batch count,
#: the stages over data and float inputs
CASES = [
    ("uneven-m4", (1, 2, 2, 1), 4, 8, 16, "model", False),
    ("uneven-m2", (1, 2, 2, 1), 2, 8, 16, "model", False),
    ("first-heavy", (3, 1, 1, 1), 2, 4, 8, "model", False),
    ("last-heavy", (1, 1, 1, 3), 2, 4, 8, "model", False),
    ("front-two", (2, 2, 1, 1), 2, 4, 8, "model", False),
    ("stages-over-data", (4, 2), 2, 8, 8, "data", False),
    ("float-inputs", (1, 2, 2, 1), 2, 8, 8, "model", True),
]
IDS = [c[0] for c in CASES]

_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.core import pipeline as PL
from repro.models import transformer as T
cases, out = json.loads(sys.argv[1]), sys.argv[2]
cfg = get_config("qwen3-0.6b").reduced(n_layers=6)
params, _ = T.init_params(cfg, jax.random.PRNGKey(0))
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
res = {}
for i, (name, sizes, m, b, s, stage_axis, floats) in enumerate(cases):
    key = jax.random.PRNGKey(100 + i)
    tokens = (jax.random.normal(key, (b, s, cfg.d_model)) if floats else
              jax.random.randint(key, (b, s), 0, cfg.vocab_size))
    spec = PL.PipelineSpec(len(sizes), tuple(sizes))
    stage_params, mask = PL.stack_stage_params(cfg, params, spec)
    other = "data" if stage_axis == "model" else "model"
    with mesh:
        logits = PL.pipeline_forward(cfg, stage_params, mask, tokens, spec,
                                     mesh, n_microbatches=m,
                                     stage_axis=stage_axis,
                                     batch_axes=(other,))
    res[name + "/inputs"] = np.asarray(tokens)
    res[name + "/logits"] = np.asarray(logits, np.float32)
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's logits of every case, computed in a subprocess
    started with the module and read at the first test that needs it."""
    out = tmp_path_factory.mktemp("reference") / "pipeline.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                             json.dumps(CASES), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
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
        jcfg = jax_get_config(ARCH).reduced(n_layers=6)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tcfg = get_config(ARCH).reduced(n_layers=6)
        _STATE["model"] = (tcfg, params_from_numpy(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    return _STATE["model"]


def _mesh():
    """The module's mesh of 8 processes over the model, spawned at first
    use (before the reference's result is read, so the two overlap)."""
    if "mesh" not in _STATE:
        cfg, params = _model()
        _STATE["mesh"] = MeshProcs(cfg, params, make_test_mesh(),
                                   impl="cuda", device="cpu",
                                   timeout=TIMEOUT)
    return _STATE["mesh"]


def _run(case, reference):
    name, sizes, m, b, s, stage_axis, floats = case
    procs = _mesh()
    inputs = torch.from_numpy(reference()[name + "/inputs"])
    spec = PL.PipelineSpec(len(sizes), sizes)
    other = ("data",) if stage_axis == "model" else ("model",)
    got = procs.pipeline_forward(inputs, spec, m, stage_axis=stage_axis,
                                 batch_axes=other)
    return inputs, spec, got


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_pipeline_forward_matches_the_reference(case, reference):
    """The process mesh's logits [B, S, V] against the reference's on its
    faked (2, 4) mesh at 3e-4, and against the port in one process at
    1e-5; the rows come back in the order of the token rows."""
    name, sizes, m = case[:3]
    cfg, params = _model()
    inputs, spec, got = _run(case, reference)
    want = reference()[name + "/logits"]
    assert got.shape == want.shape == (case[3], case[4], cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **REFERENCE_TOL)
    local = PL.pipeline_forward(cfg, params, inputs, spec, m)
    np.testing.assert_allclose(got.numpy(), local.numpy(), **LOCAL_TOL)
    assert len(np.unique(want.argmax(-1))) > 2


def test_each_process_hops_its_rows_to_its_next_stage(reference):
    """After one forward over (1, 2, 2, 1) in 4 micro-batches of 2 rows
    (one a data point): each process but the last stage's sent 4 x
    [1, 16, d] float32 activations; the last stage's sent none."""
    procs = _mesh()
    cfg, _ = _model()
    procs.zero_stats()
    _run(CASES[0], reference)
    stats = procs.stats()
    mesh = procs.mesh
    for rank, st in enumerate(stats):
        last = mesh.coords(rank)["model"] == 3
        assert st["hop_bytes"] == (0 if last else 4 * 16 * cfg.d_model * 4)
        assert st["moe"] == [] and st["host_s"] > 0
        assert not any(st["launches"].values())     # plain versions on CPU


def test_value_errors_are_raised_before_the_processes_run():
    """A batch no whole number of micro-batches, a micro-batch no whole
    number of the data axis's rows, a spec of other stages than the
    stage axis's size, and a spec that misses layers: ``ValueError`` on
    the host, the processes untouched."""
    procs = _mesh()
    spec = PL.PipelineSpec(4, (1, 2, 2, 1))
    tokens = torch.zeros((6, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="micro-batches"):
        procs.pipeline_forward(tokens, spec, 4)
    with pytest.raises(ValueError, match="does not split"):
        procs.pipeline_forward(tokens, spec, 2)       # 3 rows over 2
    with pytest.raises(ValueError, match="stages on a model axis"):
        procs.pipeline_forward(tokens[:4], PL.PipelineSpec(2, (3, 3)), 2)
    with pytest.raises(ValueError, match="covers"):
        procs.pipeline_forward(tokens[:4], PL.PipelineSpec(4, (1, 1, 1, 1)),
                               2)
    with pytest.raises(ValueError, match="micro-batches"):
        PL.pipeline_forward(*_model(), tokens, spec, 4)
    assert all(p.is_alive() for p in procs.procs)


def test_a_process_that_raises_raises_in_the_host():
    """A token outside the vocabulary fails in the stage-0 processes'
    embedding: the host raises naming one of them with its traceback,
    and every process has exited."""
    procs = _mesh()
    cfg, _ = _model()
    tokens = torch.full((4, 8), cfg.vocab_size + 3, dtype=torch.int64)
    with pytest.raises(StageProcError, match="mesh process") as err:
        procs.pipeline_forward(tokens, PL.PipelineSpec(4, (1, 2, 2, 1)), 2)
    assert procs.mesh.coords(err.value.rank)["model"] == 0
    assert "IndexError" in str(err.value)
    assert all(p.exitcode is not None for p in procs.procs)
    with pytest.raises(StageProcError, match="closed"):
        procs.stats()


def test_the_card_is_the_default_device():
    """Without ``device="cpu"`` the mesh runs on the card: with no GPU it
    raises before it spawns anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    cfg, params = _model()
    before = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshProcs(cfg, params, make_test_mesh())
    assert set(multiprocessing.active_children()) == before


def test_close_leaves_no_process():
    _mesh().close()
    _mesh().close()                                  # idempotent
    _STATE.pop("mesh")
    assert multiprocessing.active_children() == []
