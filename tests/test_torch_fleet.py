"""The Fleet, the seeded traces and the launcher's policy, SLO and fault
flags in the port (``repro_torch.serving.sched.{fleet,trace}``, copies of
the JAX package's modules) against the reference, on the CPU.

- ``poisson_trace`` and ``bursty_trace`` give the reference's items for
  seeds 0-3, and ``replay`` the reference's report, over each package's
  ``SimBackend``;
- the reference's fleet scenarios (spillover, routing by load, the SLO
  clock across a migration, actionable infeasibility errors, aggregate
  stats, EDF against FIFO, a TensorBackend beside a SimBackend) give the
  reference's tokens, routing (``where``), migrations, ``FleetStats`` and
  reports;
- the launcher refuses the reference's bad argv with the reference's
  messages, and serves with ``--policy``, the SLO flags and injected
  transients on the CPU.
"""
import dataclasses
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(2)
PKGS = ("ref", "port")


def _ns(pkg):
    if pkg == "ref":
        from repro.core.simulator import StageCosts
        from repro.runtime.sim import SimBackend
        from repro.serving import (ContinuousBatcher, Fleet, Request,
                                   SamplingParams)
        from repro.serving.sched import bursty_trace, poisson_trace, replay
    else:
        from repro_torch.core.simulator import StageCosts
        from repro_torch.runtime.sim import SimBackend
        from repro_torch.serving import (ContinuousBatcher, Fleet, Request,
                                         SamplingParams)
        from repro_torch.serving.sched import (bursty_trace, poisson_trace,
                                               replay)
    return types.SimpleNamespace(**locals())


NS = {pkg: _ns(pkg) for pkg in PKGS}


def sim(ns, n_slots=2, seed=0, **kw):
    costs = ns.StageCosts(prefill=np.full(1, 1e-3), decode=np.full(1, 1e-3),
                          comm_prefill=np.zeros(0), comm_decode=np.zeros(0),
                          return_comm=0.0)
    return ns.SimBackend(costs, n_slots=n_slots, seed=seed,
                         **{"max_len": 256, **kw})


def req(ns, plen=8, uid=None, gen=8, base=1, **params):
    return ns.Request(prompt=np.arange(base, base + plen, dtype=np.int32),
                      params=ns.SamplingParams(max_tokens=gen, **params),
                      uid=uid)


def both(scenario, *args):
    """The scenario's outcome over the port, after checking it equals the
    reference's."""
    want = scenario(NS["ref"], *args)
    got = scenario(NS["port"], *args)
    assert got == want
    return got


def outputs(done):
    return {u: dict(tokens=list(r.generated), slo_met=r.slo_met(),
                    arrival=r.timing.arrival_step,
                    queued=r.timing.queued_steps,
                    ttft=r.timing.ttft_steps, e2e=r.timing.e2e_steps)
            for u, r in done.items()}


# --------------------------------------------------------------------------- #
# traces and replay
# --------------------------------------------------------------------------- #

def items(trace):
    return [(it.at_step, it.prompt.tolist(), str(it.prompt.dtype),
             dataclasses.asdict(it.params), it.cls) for it in trace]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind,kw", [
    ("poisson_trace", {}),
    ("bursty_trace", {}),
    ("poisson_trace", dict(mean_iat=0.7, prompt_lens=(4, 9),
                           out_lens=(2, 5), shared_prefix=0.5,
                           n_prefixes=2, prefix_len=3, vocab=97)),
    ("bursty_trace", dict(mean_iat=0.5, burst_factor=4.0, p_enter=0.2,
                          p_exit=0.3, shared_prefix=1.0)),
])
def test_traces_equal_the_reference(seed, kind, kw):
    got = getattr(NS["port"], kind)(40, seed=seed, **kw)
    want = getattr(NS["ref"], kind)(40, seed=seed, **kw)
    assert items(got) == items(want) and len(got) == 40


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", ["fifo", "edf"])
def test_replay_report_equals_the_reference(seed, policy):
    def scenario(ns):
        cb = ns.ContinuousBatcher(sim(ns, n_slots=4), policy=policy)
        rep = ns.replay(cb, ns.bursty_trace(60, seed=seed, mean_iat=0.9))
        return dataclasses.asdict(rep), rep.goodput
    rep, _ = both(scenario)
    assert rep["n"] == 60


# --------------------------------------------------------------------------- #
# fleet: routing, spillover, parity
# --------------------------------------------------------------------------- #

def test_fleet_spillover_drains_and_matches_single():
    """Everything pinned to backend 0; migration drains its queue onto the
    idle backend 1, every request's tokens match the single-backend run,
    and the routing equals the reference's."""
    def scenario(ns):
        trace = ns.bursty_trace(80, seed=4, mean_iat=0.5)

        def submit_all(server, **kw):
            for i, it in enumerate(trace):
                server.submit(ns.Request(prompt=it.prompt, params=it.params,
                                         uid=i), at_step=it.at_step, **kw)
            return server.run(max_steps=100_000)
        s_done = submit_all(ns.ContinuousBatcher(sim(ns), policy="edf"))
        fleet = ns.Fleet([sim(ns), sim(ns)], policy="edf")
        f_done = submit_all(fleet, backend=0)
        return dict(single=outputs(s_done), fleet=outputs(f_done),
                    where={u: fleet.where(u) for u in f_done},
                    migrations=fleet.migrations,
                    stats=dataclasses.asdict(fleet.stats))
    o = both(scenario)
    single, fleet = o["single"], o["fleet"]
    assert o["migrations"] > 0 and set(o["where"].values()) == {0, 1}
    assert sorted(fleet) == sorted(single)
    assert all(fleet[u]["tokens"] == single[u]["tokens"] for u in single)
    assert not [u for u in single if single[u]["slo_met"] is True
                and fleet[u]["slo_met"] is False]
    assert sum(f["slo_met"] is True for f in fleet.values()) >= \
        sum(s["slo_met"] is True for s in single.values())


def test_fleet_routes_by_load():
    """Unpinned arrivals spread across backends."""
    def scenario(ns):
        fleet = ns.Fleet([sim(ns), sim(ns)])
        for i in range(8):
            fleet.submit(req(ns, uid=i, base=i + 1, gen=20))
            fleet.step()
        done = fleet.run()
        return {u: fleet.where(u) for u in range(8)}, outputs(done)
    where, _ = both(scenario)
    assert set(where.values()) == {0, 1}


def test_fleet_migration_preserves_slo_clock():
    def scenario(ns):
        fleet = ns.Fleet([sim(ns, n_slots=1), sim(ns, n_slots=1)])
        fleet.submit(req(ns, uid=1, base=1, gen=30), backend=0)
        fleet.submit(req(ns, uid=2, base=2, gen=4, e2e_slo=200), backend=0)
        done = fleet.run()
        return fleet.migrations, fleet.where(2), outputs(done)
    migrations, where, done = both(scenario)
    assert migrations >= 1 and where == 1
    assert done[2]["arrival"] == 0 and done[2]["queued"] >= 1


@pytest.mark.parametrize("case", ["sampling", "max_len", "blocks", "pinned",
                                  "empty"])
def test_fleet_infeasible_errors_are_actionable(case):
    def scenario(ns):
        with pytest.raises(ValueError) as e:
            if case == "sampling":
                ns.Fleet([sim(ns, n_slots=1)]).submit(
                    req(ns, uid=1, temperature=0.7))
            elif case == "max_len":
                ns.Fleet([sim(ns, n_slots=1)]).submit(ns.Request(
                    prompt=np.arange(1, 500, dtype=np.int32),
                    params=ns.SamplingParams(max_tokens=4), uid=2))
            elif case == "blocks":
                ns.Fleet([sim(ns, n_slots=1, cache_layout="paged",
                              num_blocks=2)]).submit(
                    req(ns, uid=3, plen=64, gen=64))
            elif case == "pinned":
                ns.Fleet([sim(ns, n_slots=1), sim(ns, n_slots=1)]).submit(
                    req(ns, uid=4, temperature=0.7), backend=1)
            else:
                ns.Fleet([])
        return str(e.value)
    msg = both(scenario)
    assert {"sampling": "logits-producing", "max_len": "max_len",
            "blocks": "KV blocks", "pinned": "pinned",
            "empty": "at least one"}[case] in msg


@pytest.mark.parametrize("seed", [2, 3])
def test_fleet_aggregate_stats_and_replay(seed):
    def scenario(ns):
        fleet = ns.Fleet([sim(ns), sim(ns)], policy="edf")
        rep = ns.replay(fleet, ns.poisson_trace(40, seed=seed, mean_iat=1.0))
        st = fleet.stats
        assert st.slot_total_steps == sum(
            b.stats.slot_total_steps for b in fleet.batchers)
        return (dataclasses.asdict(rep), dataclasses.asdict(st),
                {u: fleet.where(u) for u in fleet.done})
    rep, st, _ = both(scenario)
    assert rep["n"] == 40 and st["served"] == 40


def test_edf_goodput_beats_fifo_on_bursty():
    def scenario(ns):
        trace = ns.bursty_trace(250, seed=0, mean_iat=0.9)
        return {pol: ns.replay(ns.ContinuousBatcher(sim(ns, n_slots=4),
                                                    policy=pol),
                               trace).goodput for pol in ("fifo", "edf")}
    goodput = both(scenario)
    assert goodput["edf"] > goodput["fifo"], goodput


def test_fleet_tensor_plus_sim_parity():
    """A TensorBackend beside a SimBackend: each request's tokens equal a
    single-backend baseline of its kind and the reference's fleet of the
    same kinds (reduced qwen3-0.6b, float32, the reference's weights)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as JT
    from repro.runtime import TensorBackend as JaxTensorBackend
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.runtime import TensorBackend
    jcfg = jax_get_config("qwen3-0.6b").reduced(n_layers=2)
    tcfg = get_config("qwen3-0.6b").reduced(n_layers=2)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 7, 11)]

    def scenario(ns):
        if ns is NS["ref"]:
            tensor = lambda: JaxTensorBackend(  # noqa: E731
                jcfg, jparams, n_slots=2, max_len=64)
        else:
            tensor = lambda: TensorBackend(  # noqa: E731
                tcfg, tparams, n_slots=2, max_len=64, device="cpu")
        sp = ns.SamplingParams(max_tokens=4)
        fleet = ns.Fleet([tensor(), sim(ns)])
        for i, p in enumerate(prompts):
            fleet.submit(ns.Request(prompt=p, params=sp, uid=i),
                         backend=i % 2)
        f_done = {u: list(r.generated) for u, r in fleet.run().items()}
        base = {}
        for kind, be in ((0, tensor()), (1, sim(ns))):
            cb = ns.ContinuousBatcher(be)
            for i, p in enumerate(prompts):
                if i % 2 == kind:
                    cb.submit(ns.Request(prompt=p, params=sp, uid=i))
            base.update({u: list(r.generated) for u, r in cb.run().items()})
        assert f_done == base
        return f_done, {u: fleet.where(u) for u in f_done}
    both(scenario)


# --------------------------------------------------------------------------- #
# the launcher's policy, SLO and fault flags
# --------------------------------------------------------------------------- #

BASE_ARGV = ["--arch", "qwen3-0.6b", "--smoke"]
BAD_ARGV = {
    "faults in pipeline mode": ["--mode", "pipeline",
                                "--inject-faults", "crash@decode_step:1"],
    "edf without SLOs": ["--policy", "edf", "--priority", "1"],
    "priority without a class flag": ["--policy", "priority"],
    "edf without any flag": ["--policy", "edf"],
}


@pytest.mark.parametrize("case", list(BAD_ARGV))
def test_launcher_refuses_the_reference_argv(case, monkeypatch, capsys):
    from repro.launch.serve import main as ref_main
    from repro_torch.launch.serve import main
    argv = BASE_ARGV + BAD_ARGV[case]
    monkeypatch.setattr(sys, "argv", ["serve.py"] + argv)
    errors = []
    for run in (ref_main, lambda: main(argv)):
        with pytest.raises(SystemExit) as e:
            run()
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1]
    assert "error: --" in errors[1]


def test_launcher_serves_with_policy_slo_and_faults(capsys):
    """Two injected transients absorbed by retries under EDF: every request
    finishes, the tokens are the fault-free run's, no escalation."""
    from repro_torch.launch.serve import main
    argv = BASE_ARGV + ["--device", "cpu", "--batch", "5", "--slots", "3",
                        "--varlen", "--prompt-len", "12", "--gen", "8",
                        "--cache-layout", "paged", "--policy", "edf",
                        "--ttft-slo", "64"]
    llm, outs = main(argv + ["--inject-faults", "transient@decode_step:5x2",
                             "--max-retries", "3", "--priority", "2"])
    out = capsys.readouterr().out
    _, clean = main(argv)
    assert [o.tokens for o in outs] == [o.tokens for o in clean]
    assert len(outs) == 5 and all(o.finish_reason == "length"
                                  and o.n_generated == 8 for o in outs)
    st = llm.stats
    assert st.retries == 2 and st.failures == 2
    assert llm.backend.injected["transient"] == 2
    assert llm.backend.health() == "healthy"
    assert "faults (transient@decode_step:5x2): injected {'transient': 2}, " \
        "absorbed with 2 retries (2 failures) — backend healthy" in out
    assert "  SLO (edf): 5/5 met (ttft_misses=0" in out
    assert "note: --priority" not in out


def test_launcher_priority_note_under_fifo(capsys):
    from repro_torch.launch.serve import main
    main(BASE_ARGV + ["--device", "cpu", "--batch", "2", "--gen", "2",
                      "--priority", "1", "--e2e-slo", "40"])
    out = capsys.readouterr().out
    assert "note: --priority has no effect on this deployment: FIFO " \
        "ignores service classes; pass --policy priority" in out
    assert "  SLO (fifo): 2/2 met" in out
