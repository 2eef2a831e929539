"""The port's copies of the numpy planner layers (``repro_torch.core``'s
devices, profile, partition, simulator and planner, and
``repro_torch.runtime.sim``) against the JAX package's originals, with
exact equality: the same plans, baselines, simulations and served events.

The copies differ from the reference only in their import lines
(``test_copies_differ_only_in_imports``), so every number here must come
out bit for bit.
"""
import difflib
import re
from pathlib import Path

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import devices as JD
from repro.core import partition as JPa
from repro.core import pipeline as JPL
from repro.core import planner as JPl
from repro.core import simulator as JS
from repro.core.profile import ModelProfile as JModelProfile
from repro.core.profile import Workload as JWorkload
from repro.runtime.sim import SimBackend as JSimBackend
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.types import Request as JRequest
from repro.serving.types import SamplingParams as JSamplingParams
from repro_torch.configs import get_config
from repro_torch.core import devices as TD
from repro_torch.core import partition as TPa
from repro_torch.core import pipeline as TPL
from repro_torch.core import planner as TPl
from repro_torch.core import simulator as TS
from repro_torch.core.profile import ModelProfile, Workload
from repro_torch.runtime.sim import SimBackend
from repro_torch.serving.scheduler import ContinuousBatcher
from repro_torch.serving.types import Request, SamplingParams

ROOT = Path(__file__).resolve().parents[1]
COPIES = ["core/devices.py", "core/profile.py", "core/partition.py",
          "core/simulator.py", "core/planner.py", "runtime/sim.py"]
ARCHS = ["llama2-7b", "llama2-13b", "llama2-70b", "qwen3-0.6b"]
CLUSTERS = {"paper_testbed": lambda m: m.paper_testbed(),
            "tpu_pod_4": lambda m: m.tpu_pod_cluster(n_chips=4),
            "tpu_pod_16": lambda m: m.tpu_pod_cluster(n_chips=16)}


def _import_lines(path):
    """Indices of the lines that belong to an import statement."""
    src = path.read_text().splitlines()
    out, inside = set(), False
    for i, line in enumerate(src):
        if re.match(r"(from \S+ )?import ", line) or inside:
            out.add(i)
            inside = line.rstrip().endswith((",", "(")) or (
                "(" in line and ")" not in line) or (
                inside and not line.rstrip().endswith(")"))
    return src, out


@pytest.mark.parametrize("rel", COPIES)
def test_copies_differ_only_in_imports(rel):
    ref, ref_imp = _import_lines(ROOT / "src" / "repro" / rel)
    port, port_imp = _import_lines(ROOT / "src" / "repro_torch" / rel)
    sm = difflib.SequenceMatcher(a=ref, b=port, autojunk=False)
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        assert set(range(i1, i2)) <= ref_imp, (rel, ref[i1:i2])
        assert set(range(j1, j2)) <= port_imp, (rel, port[j1:j2])
    assert not any("repro." in port[i] and "repro_torch." not in port[i]
                   for i in port_imp), rel


def _stages(plan):
    return [(s.start, s.end, s.device) for s in plan.stages]


def _same_deployment(t, j):
    assert t.method == j.method
    assert t.ok == j.ok and t.oom == j.oom
    assert t.batch == j.batch
    assert _stages(t.plan) == _stages(j.plan)
    assert list(t.plan.assignment) == list(j.plan.assignment)
    assert t.plan.objective == j.plan.objective
    assert t.latency_ms_per_token == j.latency_ms_per_token
    assert t.throughput_tok_s == j.throughput_tok_s


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("objective", ["throughput", "latency"])
def test_plan_deployment_equals_reference(arch, cluster, objective):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    t = TPl.plan_deployment(cfg, CLUSTERS[cluster](TD),
                            Workload(dtype_bytes=2), objective=objective)
    j = JPl.plan_deployment(jcfg, CLUSTERS[cluster](JD),
                            JWorkload(dtype_bytes=2), objective=objective)
    _same_deployment(t, j)
    if t.ok:
        n = len(t.plan.stages)
        assert TPL.spec_from_plan(cfg, t.plan, n).periods_per_stage == \
            JPL.spec_from_plan(jcfg, j.plan, n).periods_per_stage


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("arch", ARCHS)
def test_baseline_suite_equals_reference(arch, cluster):
    wl = dict(prompt_len=64, gen_tokens=32, dtype_bytes=2)
    t = TPl.baseline_suite(get_config(arch), CLUSTERS[cluster](TD),
                           Workload(**wl))
    j = JPl.baseline_suite(jax_get_config(arch), CLUSTERS[cluster](JD),
                           JWorkload(**wl))
    assert list(t) == list(j)
    for key in t:
        _same_deployment(t[key], j[key])


def test_issue_plans():
    """The planner's stage layouts the pipeline must serve: uneven rings of
    13 stages and stages with no layer."""
    cases = [("llama2-7b", TD.paper_testbed(), "throughput",
              (1,) + (2,) * 11 + (9,)),
             ("llama2-7b", TD.paper_testbed(), "latency", (0, 1, 31)),
             ("llama2-7b", TD.tpu_pod_cluster(n_chips=4), "throughput",
              (8, 8, 8, 8)),
             ("qwen3-0.6b", TD.tpu_pod_cluster(n_chips=4), "throughput",
              (0, 9, 10, 9))]
    for arch, cluster, objective, want in cases:
        cfg = get_config(arch)
        dep = TPl.plan_deployment(cfg, cluster, Workload(dtype_bytes=2),
                                  objective=objective)
        spec = TPL.spec_from_plan(cfg, dep.plan, len(dep.plan.stages))
        assert spec.periods_per_stage == want, (arch, objective)


def _problem(mod, seed, tight):
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(3, 8)), int(rng.integers(2, 5))
    t_comp = rng.uniform(0.001, 0.1, size=(n, m))
    act = rng.uniform(1e3, 1e6, size=n)
    bw = rng.uniform(1e5, 1e8, size=(m, m))
    bw = (bw + bw.T) / 2
    np.fill_diagonal(bw, np.inf)
    req = rng.uniform(1.0, 4.0, size=n)
    if tight:
        mem = rng.uniform(req.max(), max(req.max() * 1.01,
                                         req.sum() / max(1, m - 1)), size=m)
    else:
        mem = np.full(m, req.sum() * 10.0)
    return mod.PartitionProblem(t_comp, act, bw, req, mem)


SOLVERS = ["solve_latency", "solve_latency_best", "solve_throughput",
           "brute_force_latency", "brute_force_throughput", "edge_solo"]


@pytest.mark.parametrize("seed", range(12))
def test_solvers_equal_reference_on_random_problems(seed):
    """Every solver of the copy gives the reference's plan on seeded random
    problems (loose and tight memory); the DPs meet the brute force's
    optimum where the reference's tests say they must."""
    tight = bool(seed % 2)
    tp, jp = _problem(TPa, 7000 + seed, tight), _problem(JPa, 7000 + seed,
                                                          tight)
    for name in SOLVERS:
        t, j = getattr(TPa, name)(tp), getattr(JPa, name)(jp)
        assert list(t.assignment) == list(j.assignment), name
        assert t.objective == j.objective, name
        assert _stages(t) == _stages(j), name
    m = tp.t_comp.shape[1]
    for cloud in range(1, m):
        tc, jc = TPa.cloud_edge_plans(tp, cloud), JPa.cloud_edge_plans(
            jp, cloud)
        assert list(tc) == list(jc)
        for key in tc:
            assert list(tc[key].assignment) == list(jc[key].assignment)
            assert tc[key].objective == jc[key].objective
    devs = [0] + list(range(2, m))
    sub_t, idx_t = TPa.restrict(tp, devs)
    sub_j, idx_j = JPa.restrict(jp, devs)
    assert idx_t == idx_j
    lt = TPa.lift_plan(TPa.solve_throughput(sub_t), idx_t)
    lj = JPa.lift_plan(JPa.solve_throughput(sub_j), idx_j)
    assert list(lt.assignment) == list(lj.assignment)
    if not tight:
        dp, bf = TPa.solve_throughput(tp), TPa.brute_force_throughput(tp)
        assert dp.objective == pytest.approx(bf.objective, rel=1e-9)
        dp, bf = TPa.solve_latency(tp), TPa.brute_force_latency(tp)
        assert dp.objective == pytest.approx(bf.objective, rel=1e-9)


def _random_plan(mod, rng, n_units):
    sizes = rng.uniform(1, 20, size=int(rng.integers(1, 9)))
    bounds = np.cumsum(sizes / sizes.sum() * n_units).astype(int)
    bounds[-1] = n_units
    assignment = np.zeros(n_units, int)
    start = 0
    for dev, end in enumerate(bounds):
        assignment[start:end] = dev
        start = end
    return mod.Plan(assignment, 1.0, "throughput")


@pytest.mark.parametrize("seed", range(8))
def test_spec_from_plan_property(seed):
    """Seeded arbitrary contiguous plans map to valid specs, equal to the
    reference's: all periods covered, n_stages respected (the property of
    ``tests/test_pipeline_runtime.py::test_spec_from_plan_property``)."""
    rng = np.random.default_rng(seed)
    for arch in ("llama2-7b", "qwen3-0.6b", "llama2-70b"):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for _ in range(6):
            sub = np.random.default_rng(rng.integers(1 << 30))
            plan_t = _random_plan(TPa, sub, cfg.n_layers + 2)
            plan_j = JPa.Plan(plan_t.assignment.copy(), 1.0, "throughput")
            n_stages = int(rng.integers(1, 17))
            spec = TPL.spec_from_plan(cfg, plan_t, n_stages)
            assert spec.periods_per_stage == JPL.spec_from_plan(
                jcfg, plan_j, n_stages).periods_per_stage
            assert spec.n_stages == n_stages
            assert spec.n_periods == cfg.n_full_periods
            assert all(p >= 0 for p in spec.periods_per_stage)
    assert TPL.even_pipeline_spec(get_config("llama2-70b"), 6) \
        .periods_per_stage == JPL.even_pipeline_spec(
            jax_get_config("llama2-70b"), 6).periods_per_stage


@pytest.mark.parametrize("schedule", ["nobubbles", "bubbles"])
@pytest.mark.parametrize("arch", ["llama2-7b", "llama2-70b"])
def test_simulations_equal_reference(arch, schedule):
    wl = dict(prompt_len=128, gen_tokens=8, dtype_bytes=2)
    t_prof = ModelProfile.from_config(get_config(arch), Workload(**wl))
    j_prof = JModelProfile.from_config(jax_get_config(arch), JWorkload(**wl))
    t_cl, j_cl = TD.paper_testbed(), JD.paper_testbed()
    t_dep = TPl.plan_deployment(get_config(arch), t_cl, Workload(**wl),
                                objective="throughput")
    j_dep = JPl.plan_deployment(jax_get_config(arch), j_cl, JWorkload(**wl),
                                objective="throughput")
    for mb in (1, 4):
        tc = TS.build_stage_costs(t_prof, t_cl, t_dep.plan, mb_batch=mb)
        jc = JS.build_stage_costs(j_prof, j_cl, j_dep.plan, mb_batch=mb)
        assert tc.return_comm == jc.return_comm
        for field in ("prefill", "decode", "comm_prefill", "comm_decode"):
            np.testing.assert_array_equal(np.asarray(getattr(tc, field)),
                                          np.asarray(getattr(jc, field)))
        ts = TS.simulate_sequential(tc, 8)
        js = JS.simulate_sequential(jc, 8)
        assert vars(ts) == vars(js)
        tp = TS.simulate_pipeline(tc, 8, 6, mb, schedule=schedule)
        jp = JS.simulate_pipeline(jc, 8, 6, mb, schedule=schedule)
        assert vars(tp) == vars(jp)


def _sim_events(batcher_cls, request_cls, sp_cls, backend, prompts):
    b = batcher_cls(backend, seed=0)
    for i, p in enumerate(prompts):
        b.submit(request_cls(prompt=p, params=sp_cls(max_tokens=5 + i % 3),
                             uid=i), at_step=i % 4)
    events = []
    while b.has_work:
        events += [(e.uid, e.step, e.index, e.token, e.finished)
                   for e in b.step()]
    return events, backend.sim_result()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_sim_backend_serve_equals_reference(layout):
    """A SimBackend serve through each package's ContinuousBatcher: the
    same events (uid, step, index, token, finished) and the same timing."""
    wl = dict(prompt_len=32, gen_tokens=8, dtype_bytes=2)
    kw = dict(n_slots=6, max_len=64, cache_layout=layout, block_size=8,
              num_blocks=12 if layout == "paged" else None)
    t_dep = TPl.plan_deployment(get_config("llama2-7b"), TD.paper_testbed(),
                                Workload(**wl), objective="throughput")
    j_dep = JPl.plan_deployment(jax_get_config("llama2-7b"),
                                JD.paper_testbed(), JWorkload(**wl),
                                objective="throughput")
    t_costs = TS.build_stage_costs(
        ModelProfile.from_config(get_config("llama2-7b"), Workload(**wl)),
        TD.paper_testbed(), t_dep.plan, mb_batch=1)
    j_costs = JS.build_stage_costs(
        JModelProfile.from_config(jax_get_config("llama2-7b"),
                                  JWorkload(**wl)),
        JD.paper_testbed(), j_dep.plan, mb_batch=1)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 32000, int(n)).astype(np.int32)
               for n in rng.integers(4, 30, 9)]
    got, t_res = _sim_events(ContinuousBatcher, Request, SamplingParams,
                             SimBackend(t_costs, **kw), prompts)
    want, j_res = _sim_events(JBatcher, JRequest, JSamplingParams,
                              JSimBackend(j_costs, **kw), prompts)
    assert got == want and len(got) > 9
    assert vars(t_res) == vars(j_res)
