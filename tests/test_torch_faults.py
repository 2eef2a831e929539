"""Fault injection and the Fleet's failure recovery in the port
(``repro_torch.runtime.faults``, ``repro_torch.serving.sched.fleet``:
copies of the JAX package's modules) against the reference, on the CPU.

Every scenario of the reference's own fault tests runs twice, once over
each package's ``SimBackend``, and each outcome (tokens, raised types,
retry waits, ``FleetStats``, recovered and shed requests with their
reasons) must equal the reference's; the reference's own assertions are
then held on the port's outcome.  Over the port's ``TensorBackend``
(reduced qwen3-0.6b, float32) a crash at every decode call of a sweep
recovers with tokens bit-identical to the fault-free run and to the
reference's fleet of JAX ``TensorBackend`` s.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(2)
PKGS = ("ref", "port")


def _ns(pkg):
    if pkg == "ref":
        from repro.core.simulator import StageCosts
        from repro.runtime.base import (BackendDead, BackendError,
                                        BackendTimeout, PoolExhausted)
        from repro.runtime.faults import (Fault, FaultInjectionBackend,
                                          parse_faults)
        from repro.runtime.sim import SimBackend
        from repro.serving import ContinuousBatcher, Request, SamplingParams
        from repro.serving.sched.fleet import Fleet
    else:
        from repro_torch.core.simulator import StageCosts
        from repro_torch.runtime.base import (BackendDead, BackendError,
                                              BackendTimeout, PoolExhausted)
        from repro_torch.runtime.faults import (Fault, FaultInjectionBackend,
                                                parse_faults)
        from repro_torch.runtime.sim import SimBackend
        from repro_torch.serving import (ContinuousBatcher, Request,
                                         SamplingParams)
        from repro_torch.serving.sched.fleet import Fleet
    return types.SimpleNamespace(**locals())


NS = {pkg: _ns(pkg) for pkg in PKGS}


def sim(ns, n_slots=2, seed=0, **kw):
    costs = ns.StageCosts(prefill=np.array([1e-3]), decode=np.array([1e-3]),
                          comm_prefill=np.array([]), comm_decode=np.array([]),
                          return_comm=0.0)
    return ns.SimBackend(costs, n_slots=n_slots, seed=seed, **kw)


def req(ns, uid, plen=6, gen=5, **params):
    prompt = (np.arange(plen, dtype=np.int32) + 7 * uid) % 97 + 1
    return ns.Request(prompt, ns.SamplingParams(max_tokens=gen, **params),
                      uid=uid)


def both(scenario, *args):
    """The scenario's outcome over the port, after checking it equals the
    reference's."""
    want = scenario(NS["ref"], *args)
    got = scenario(NS["port"], *args)
    assert got == want
    return got


# --------------------------------------------------------------------------- #
# schedule parsing + Fault validation
# --------------------------------------------------------------------------- #

SPECS = ["crash@decode_step:40", "transient@prefill:2x3", "timeout@any~0.01",
         "slow@decode_step:10*4", "crash@decode_step:9, timeout@prefill~0.5",
         "pool@verify_step:3x2", "transient@prefill_chunk~0.25",
         "slow@start_stream:1", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_faults_field_for_field(spec):
    got = [dataclasses.asdict(f) for f in NS["port"].parse_faults(spec)]
    want = [dataclasses.asdict(f) for f in NS["ref"].parse_faults(spec)]
    assert got == want
    if spec == "crash@decode_step:40":
        assert got == [dict(kind="crash", op="decode_step", at_call=40,
                            p=0.0, count=1, slow_factor=4.0)]
    ns = NS["port"]
    assert ns.parse_faults([ns.Fault("crash", "decode_step", at_call=1)]
                           )[0].op == "decode_step"


@pytest.mark.parametrize("bad", ["crash", "bogus@decode_step:1",
                                 "crash@bogus_op:1", "crash@decode_step:1x0"])
def test_bad_fault_specs_raise_the_reference_message(bad):
    def scenario(ns):
        with pytest.raises(ValueError) as e:
            ns.parse_faults(bad)
        return str(e.value)
    both(scenario)


def test_fault_needs_trigger():
    def scenario(ns):
        with pytest.raises(ValueError, match="at_call or p") as e:
            ns.Fault("transient", "decode_step")
        ns.Fault("slow", "decode_step")      # slow may be unconditional
        return str(e.value)
    both(scenario)


# --------------------------------------------------------------------------- #
# injection semantics
# --------------------------------------------------------------------------- #

def _token(ev):
    # a SimBackend samples in-backend; a TensorBackend returns logits
    return int(ev.token) if ev.logits is None else int(np.argmax(ev.logits))


def drive(ns, backend, plen=4, n_decode=8):
    """Prefill slot 0 then decode; returns (tokens, raised call indices)."""
    toks, raised = [], []
    prompt = np.arange(1, plen + 1, dtype=np.int32)[None, :]
    ev, = backend.prefill([0], prompt)
    toks.append(_token(ev))
    for k in range(n_decode):
        try:
            ev, = backend.decode_step({0: toks[-1]})
        except ns.BackendError:
            raised.append(k)
            continue
        toks.append(_token(ev))
    return toks, raised


@pytest.mark.parametrize("spec,exc", [
    ("timeout@decode_step:0", "BackendTimeout"),
    ("transient@decode_step:0", "BackendError"),
    ("pool@decode_step:0", "PoolExhausted")])
def test_typed_kinds_raise_their_types(spec, exc):
    def scenario(ns):
        fb = ns.FaultInjectionBackend(sim(ns), spec)
        fb.prefill([0], np.ones((1, 4), np.int32))
        with pytest.raises(getattr(ns, exc)) as e:
            fb.decode_step({0: 1})
        return type(e.value).__name__, str(e.value), dict(fb.injected)
    name, _, injected = both(scenario)
    assert name == exc and sum(injected.values()) == 1


def test_crash_is_permanent_and_drainable():
    def scenario(ns):
        fb = ns.FaultInjectionBackend(sim(ns), "crash@decode_step:1")
        ev, = fb.prefill([0], np.ones((1, 4), np.int32))
        fb.decode_step({0: int(ev.token)})            # call 0 survives
        with pytest.raises(ns.BackendDead):
            fb.decode_step({0: 1})
        with pytest.raises(ns.BackendDead):           # dead stays dead
            fb.prefill([0], np.ones((1, 4), np.int32))
        assert fb.info.health == fb.health()
        fb.free_slot(0)                               # draining still works
        return fb.health()
    assert both(scenario).startswith("dead:")


@pytest.mark.parametrize("seed", [0, 42])
def test_probabilistic_faults_deterministic_in_seed(seed):
    def scenario(ns):
        runs = [drive(ns, ns.FaultInjectionBackend(
            sim(ns), "transient@decode_step~0.3", seed=seed), n_decode=20)
            for _ in range(2)]
        assert runs[0] == runs[1] and runs[0][1]  # same calls failed, some
        return runs[0]
    both(scenario)


def test_slow_fault_degrades_not_fails():
    def scenario(ns):
        fb = ns.FaultInjectionBackend(sim(ns), "slow@decode_step:2*4")
        base = fb.inner.costs.decode.copy()
        toks, raised = drive(ns, fb, n_decode=6)
        np.testing.assert_allclose(fb.inner.costs.decode, base * 4)
        return toks, raised, fb.health(), dict(fb.injected)
    _, raised, health, injected = both(scenario)
    assert raised == [] and health == "degraded"
    assert injected["slow"] == 1              # scaled once, not per call


def test_injection_precedes_mutation():
    """A failed op leaves inner state untouched: a retry of the same feed
    continues the token stream of a fault-free twin."""
    def scenario(ns):
        toks_t, _ = drive(ns, sim(ns), n_decode=6)
        toks_f, raised = drive(ns, ns.FaultInjectionBackend(
            sim(ns), "transient@decode_step:1"), n_decode=7)
        assert toks_f == toks_t[:len(toks_f)] and len(toks_f) >= 6
        return toks_f, raised
    assert both(scenario)[1] == [1]


# --------------------------------------------------------------------------- #
# batcher: transient absorption, backoff, escalation, withdraw(running)
# --------------------------------------------------------------------------- #

def serve(ns, backend, reqs, **kw):
    cb = ns.ContinuousBatcher(backend, **kw)
    for r in reqs:
        cb.submit(r)
    done = cb.run()
    return {u: list(r.generated) for u, r in done.items()}, cb


def test_batcher_absorbs_transients_bit_identically():
    def scenario(ns):
        reqs = lambda: [req(ns, 1), req(ns, 2, plen=4, gen=6)]  # noqa: E731
        base, _ = serve(ns, sim(ns), reqs())
        out, cb = serve(ns, ns.FaultInjectionBackend(
            sim(ns), "transient@decode_step:2x2"), reqs())
        assert out == base                     # zero token mismatches
        return out, cb.stats.failures, cb.stats.retries
    assert both(scenario)[1:] == (2, 2)


def test_batcher_backoff_is_capped_exponential():
    def scenario(ns):
        cb = ns.ContinuousBatcher(ns.FaultInjectionBackend(
            sim(ns), "transient@decode_step:0x3"), max_retries=3)
        cb.submit(req(ns, 1, gen=3))
        waits = []
        while cb.has_work and cb.step_no < 200:
            before = cb._backoff_until
            cb.step()
            if cb._backoff_until != before:
                waits.append(cb._backoff_until - cb.step_no)
        return waits, cb.stats.retries
    assert both(scenario) == ([1, 2, 4], 3)    # 2^(k-1), capped at 8


@pytest.mark.parametrize("spec,retries,exc,failures", [
    ("transient@decode_step:0x10", 2, "BackendError", 3),
    ("crash@decode_step:1", 5, "BackendDead", 1)])
def test_batcher_escalates(spec, retries, exc, failures):
    """Past its retry budget, or at once for BackendDead (never retried)."""
    def scenario(ns):
        cb = ns.ContinuousBatcher(ns.FaultInjectionBackend(sim(ns), spec),
                                  max_retries=retries)
        cb.submit(req(ns, 1))
        with pytest.raises(getattr(ns, exc)) as e:
            cb.run()
        return type(e.value).__name__, cb.stats.failures, cb.stats.retries
    name, fails, retried = both(scenario)
    assert name == exc and fails == failures
    assert retried == (0 if exc == "BackendDead" else retries)


def test_withdraw_running_returns_resumable_prefix():
    def scenario(ns):
        base, _ = serve(ns, sim(ns, n_slots=1), [req(ns, 1, gen=8)])
        cb = ns.ContinuousBatcher(sim(ns, n_slots=1))
        cb.submit(req(ns, 1, gen=8))
        for _ in range(4):
            cb.step()
        assert cb.status(1) == "running"
        assert cb.withdraw(1) is None          # default: running off-limits
        r = cb.withdraw(1, running=True)
        assert r is not None and 0 < len(r.generated) < 8
        assert cb.running == [] and len(cb._free) == 1 and not cb.has_work
        info = cb.backend.info
        assert info.free_blocks == info.total_blocks
        cb2 = ns.ContinuousBatcher(sim(ns, n_slots=1))
        cb2.submit(r, resume=True)
        done = cb2.run()
        assert list(done[1].generated) == base[1]
        return list(r.generated), base
    both(scenario)


# --------------------------------------------------------------------------- #
# fleet: quarantine, drain, re-admission, shedding
# --------------------------------------------------------------------------- #

def fleet_of(ns, n=3, faulty=None, spec="", seed=0, **kw):
    backends = [sim(ns, n_slots=2, seed=seed) for _ in range(n)]
    if faulty is not None:
        backends[faulty] = ns.FaultInjectionBackend(backends[faulty], spec,
                                                    seed=seed)
    return ns.Fleet(backends, seed=seed, **kw)


REQS = [dict(uid=u, plen=4 + u % 3, gen=4 + u % 4) for u in range(1, 7)]


def run_fleet(ns, f):
    for kw in REQS:
        f.submit(req(ns, **kw), at_step=kw["uid"] // 2)
    done = f.run()
    return {u: list(r.generated) for u, r in done.items()}


def fleet_outcome(f, out):
    """Everything a fleet run decides: tokens, routing, stats, the recovery
    audit trail, the shed requests with their reasons, health."""
    return dict(tokens=out, where={u: f.where(u) for u in out},
                stats=dataclasses.asdict(f.stats),
                recovered=list(f.recovered_uids), failed=dict(
                    f.failed_reason), health=f.health(),
                migrations=f.migrations, step=f.step_no)


def test_fleet_crash_recovery_is_bit_identical():
    def scenario(ns):
        base = run_fleet(ns, fleet_of(ns))
        f = fleet_of(ns, faulty=1, spec="crash@decode_step:3")
        out = run_fleet(ns, f)
        assert out == base                     # zero token mismatches
        return fleet_outcome(f, out)
    o = both(scenario)
    st = o["stats"]
    assert st["quarantines"] == 1
    assert st["recovered"] == len(o["recovered"]) > 0
    assert st["shed"] == 0 and not o["failed"]
    assert o["health"][1].startswith("quarantined (BackendDead")
    assert st["tokens_recomputed"] > 0


@pytest.mark.parametrize("k", range(10))
def test_fleet_crash_at_every_step_sweep(k):
    """Kill backend 1 at decode call k: recovered outputs stay bit-identical
    to the fault-free run (the chaos gate), and equal the reference's."""
    def scenario(ns):
        base = run_fleet(ns, fleet_of(ns))
        f = fleet_of(ns, faulty=1, spec=f"crash@decode_step:{k}")
        out = run_fleet(ns, f)
        assert out == base, f"token mismatch with crash at decode call {k}"
        fired = f.batchers[1].backend.injected["crash"] > 0
        assert f.stats.quarantines == (1 if fired else 0), k
        return fleet_outcome(f, out)
    o = both(scenario)
    assert o["stats"]["recovered"] == len(o["recovered"])
    assert o["stats"]["shed"] == 0


def test_fleet_absorbs_transient_storm_without_quarantine():
    def scenario(ns):
        base = run_fleet(ns, fleet_of(ns))
        f = fleet_of(ns, faulty=1, spec="transient@decode_step:3x2")
        out = run_fleet(ns, f)
        assert out == base
        return fleet_outcome(f, out)
    st = both(scenario)["stats"]
    assert st["quarantines"] == 0 and st["retries"] >= 2 \
        and st["failures"] >= 2


def test_fleet_sheds_what_no_survivor_can_hold():
    def scenario(ns):
        big, small = sim(ns, n_slots=2), sim(ns, n_slots=2, max_len=16)
        f = ns.Fleet([ns.FaultInjectionBackend(big, "crash@decode_step:2"),
                      small])
        f.submit(req(ns, 1, plen=8, gen=20))   # only the faulty one fits
        f.submit(req(ns, 2, plen=4, gen=4))    # fits anywhere
        done = f.run()
        assert f.failed[1].finish_reason == "shed"
        return fleet_outcome(f, {u: list(r.generated)
                                 for u, r in done.items()})
    o = both(scenario)
    assert sorted(o["tokens"]) == [2]
    assert o["stats"]["quarantines"] == 1 and o["stats"]["shed"] == 1
    assert "max_len" in o["failed"][1]


def test_fleet_with_no_survivors_reraises():
    def scenario(ns):
        f = ns.Fleet([ns.FaultInjectionBackend(sim(ns),
                                               "crash@decode_step:1")])
        f.submit(req(ns, 1))
        with pytest.raises(ns.BackendDead) as e:
            f.run()
        return str(e.value), dataclasses.asdict(f.stats), \
            dict(f.failed_reason)
    _, st, failed = both(scenario)
    assert st["quarantines"] == 1 and "no surviving backend" in failed[1]


def test_fleet_deadline_admission():
    def scenario(ns):
        f = ns.Fleet([sim(ns)])
        with pytest.raises(ValueError,
                           match="infeasible.*relax e2e_slo") as e:
            f.submit(req(ns, 1, gen=50, e2e_slo=10))
        f2 = ns.Fleet([sim(ns)], deadline_admission=False)
        f2.submit(req(ns, 1, gen=50, e2e_slo=10))
        done = f2.run()
        assert len(done[1].generated) == 50 and done[1].slo_met() is False
        f.submit(req(ns, 2, gen=10, e2e_slo=40))
        return str(e.value), sorted(f.run())
    assert both(scenario)[1] == [2]


def test_fleet_stats_aggregate_failure_fields():
    def scenario(ns):
        f = fleet_of(ns, faulty=0, spec="transient@decode_step:1")
        run_fleet(ns, f)
        st = f.stats
        assert st.failures == sum(b.stats.failures for b in f.batchers) == 1
        f2 = fleet_of(ns, faulty=1, spec="crash@decode_step:2")
        run_fleet(ns, f2)
        return str(st), str(f2.stats)
    st, st2 = both(scenario)
    assert "retries=1" in st and "quarantines" not in st
    assert "quarantines=1" in st2


def test_slow_fault_over_a_tensor_backend_is_health_only():
    """Over a device backend a straggler only reports ``"degraded"``: no
    stage costs to scale, tokens unchanged."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.runtime import TensorBackend
    ns = NS["port"]
    cfg = get_config("qwen3-0.6b").reduced(n_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def backend():
        return TensorBackend(cfg, params, n_slots=1, max_len=16,
                             device="cpu")
    fb = ns.FaultInjectionBackend(backend(), "slow@decode_step:1*4")
    toks_f, raised = drive(ns, fb, n_decode=4)
    toks, _ = drive(ns, backend(), n_decode=4)
    assert toks_f == toks and raised == []
    assert fb.health() == fb.info.health == "degraded"
    assert fb.injected["slow"] == 1


# --------------------------------------------------------------------------- #
# the crash sweep over TensorBackends: reduced qwen3-0.6b, float32
# --------------------------------------------------------------------------- #

ARCH = "qwen3-0.6b"
TENSOR_REQS = [dict(uid=u, plen=5 + 3 * (u % 3), gen=4 + u % 4)
               for u in range(1, 7)]


@pytest.fixture(scope="module")
def tensor_model():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as JT
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    jcfg = jax_get_config(ARCH).reduced(n_layers=2)
    tcfg = get_config(ARCH).reduced(n_layers=2)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def tensor_fleet(pkg, model, spec=""):
    """Two paged TensorBackends of 2 slots over the same parameters, the
    second wrapped in ``spec``'s faults."""
    jcfg, tcfg, jparams, tparams = model
    ns = NS[pkg]
    if pkg == "ref":
        from repro.runtime import TensorBackend
        mk = lambda: TensorBackend(  # noqa: E731
            jcfg, jparams, n_slots=2, max_len=32, cache_layout="paged")
    else:
        from repro_torch.runtime import TensorBackend
        mk = lambda: TensorBackend(  # noqa: E731
            tcfg, tparams, n_slots=2, max_len=32, cache_layout="paged",
            device="cpu")
    f = ns.Fleet([mk(), ns.FaultInjectionBackend(mk(), spec)])
    rng = np.random.default_rng(0)
    for kw in TENSOR_REQS:
        prompt = rng.integers(1, tcfg.vocab_size, kw["plen"]).astype(np.int32)
        f.submit(ns.Request(prompt, ns.SamplingParams(max_tokens=kw["gen"]),
                            uid=kw["uid"]), at_step=kw["uid"] // 2)
    done = f.run()
    return f, {u: list(r.generated) for u, r in done.items()}


@pytest.fixture(scope="module")
def tensor_reference(tensor_model):
    """The reference's fault-free fleet and its fleet with a crash at the
    fourth decode call."""
    base_f, base = tensor_fleet("ref", tensor_model)
    crash_f, crash = tensor_fleet("ref", tensor_model, "crash@decode_step:3")
    assert crash == base
    return dict(base=fleet_outcome(base_f, base),
                crash=fleet_outcome(crash_f, crash))


@pytest.mark.parametrize("k", range(10))
def test_tensor_fleet_crash_sweep_is_bit_identical(tensor_model,
                                                   tensor_reference, k):
    want = tensor_reference["base"]
    f0, base = tensor_fleet("port", tensor_model)
    assert fleet_outcome(f0, base) == want
    f, out = tensor_fleet("port", tensor_model, f"crash@decode_step:{k}")
    assert out == base == want["tokens"], f"crash at decode call {k}"
    fired = f.batchers[1].backend.injected["crash"] > 0
    st = f.stats
    assert st.quarantines == (1 if fired else 0)
    assert st.recovered == len(f.recovered_uids) and st.shed == 0
    if fired:
        assert st.tokens_recomputed > 0 or not any(
            f.done[u].generated for u in f.recovered_uids)
    if k == 3:
        assert fleet_outcome(f, out) == tensor_reference["crash"]
