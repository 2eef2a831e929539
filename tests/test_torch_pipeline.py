"""The port's no-bubbles stage pipeline (``repro_torch.core.pipeline``,
``repro_torch.runtime.pipeline_backend``, the factory and
``LLM.from_plan``) against the JAX package on the CPU, in float32, with the
reference's own weights: qwen3-0.6b reduced to 6 layers, and llama2-70b
reduced to 6 layers with two query heads per KV head (GQA).

- ``pipeline_forward`` against JAX ``forward(mode="train")`` at the
  tolerance of the reference's own pipeline test, over uneven and
  zero-layer stage layouts, 1, 2 and 4 micro-batches, both impls;
- tick logits of diverse per-micro-batch streams against the JAX
  per-stream decode, with each micro-batch's logits completing at tick
  ``t + n_stages - 1``;
- greedy tokens of ``PipelineBackend`` under ``LLM`` bit-identical to the
  JAX ``TensorBackend``'s and the port's, on both layouts (varlen prompts,
  more requests than slots, a pool small enough to preempt);
- a free slot's caches bit for bit unchanged across dead ticks;
- ``from_deployment``'s three kinds, ``from_plan`` and the launcher's
  ``--mode pipeline``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.devices import tpu_pod_cluster as jax_tpu_pod  # noqa: E402
from repro.core.planner import plan_deployment as jax_plan  # noqa: E402
from repro.core.profile import Workload as JWorkload  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import TensorBackend as JaxTensorBackend  # noqa: E402
from repro.runtime import from_deployment as jax_from_deployment  # noqa: E402
from repro.runtime import \
    plan_pipeline_spec as jax_plan_pipeline_spec  # noqa: E402
from repro.serving import LLM as JaxLLM  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import init_params, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.core.devices import tpu_pod_cluster  # noqa: E402
from repro_torch.core.planner import plan_deployment  # noqa: E402
from repro_torch.core.profile import Workload  # noqa: E402
from repro_torch.runtime import (PipelineBackend, SimBackend,  # noqa: E402
                                 TensorBackend, from_deployment,
                                 plan_pipeline_spec)
from repro_torch.serving import LLM, SamplingParams  # noqa: E402

torch.set_num_threads(2)

#: the reference's test_pipeline_forward_matches_reference_uneven_stages
TOL = dict(rtol=3e-4, atol=3e-4)
#: per-step decode logits, as tests/test_torch_model.py holds decode steps
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
LAYOUTS = [(1, 2, 2, 1), (3, 1, 1, 1), (0, 1, 2, 3)]
ARCHS = ["qwen3-0.6b", "llama2-70b"]


def _configs(arch, n_layers=6):
    jcfg = jax_get_config(arch).reduced(n_layers=n_layers)
    tcfg = get_config(arch).reduced(n_layers=n_layers)
    if arch == "llama2-70b":              # 70B groups 8 query heads a KV head
        jcfg = dataclasses.replace(jcfg, n_kv_heads=2)
        tcfg = dataclasses.replace(tcfg, n_kv_heads=2)
    return jcfg, tcfg


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg, tcfg = _configs(arch)
        jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _MODELS[arch] = (jcfg, tcfg, jparams, tparams)
    return _MODELS[arch]


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


# --------------------------------------------------------------------------- #
# pipeline_forward
# --------------------------------------------------------------------------- #

_FORWARD = {}


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("n_mb", [1, 2, 4])
@pytest.mark.parametrize("sizes", LAYOUTS, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_forward_matches_reference(arch, sizes, n_mb, impl):
    jcfg, tcfg, jparams, tparams = _model(arch)
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, (4, 16))
    if arch not in _FORWARD:
        _FORWARD[arch] = np.asarray(JT.forward(
            jcfg, jparams, jnp.asarray(tokens), mode="train")[0], np.float32)
    want = _FORWARD[arch]
    with torch.no_grad():
        got = PL.pipeline_forward(tcfg, tparams, torch.from_numpy(tokens),
                                  PL.PipelineSpec(len(sizes), sizes), n_mb,
                                  impl=impl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pipeline_forward_equals_unstaged_forward():
    """One stage holding every layer and one micro-batch is the plain
    train-mode forward, bit for bit."""
    from repro_torch.models import transformer as T
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 12)))
    with torch.no_grad():
        got = PL.pipeline_forward(tcfg, tparams, tokens,
                                  PL.PipelineSpec(1, (6,)), 1)
        want, _ = T.forward(tcfg, tparams, tokens, mode="train")
    assert torch.equal(got, want)


# --------------------------------------------------------------------------- #
# the tick protocol
# --------------------------------------------------------------------------- #

_STREAMS = {}


def _jax_stream_logits(arch, feeds, max_len):
    """[M, gen, V]: each micro-batch's stream decoded on its own."""
    key = (arch, feeds.shape, max_len)
    if key not in _STREAMS:
        jcfg, _, jparams, _ = _model(arch)
        step = jax.jit(JT.decode_step, static_argnums=0)
        out = []
        for stream in feeds:
            caches = JT.init_caches(jcfg, batch=1,
                                    max_len=max_len, dtype=jnp.float32)
            rows = []
            for tok in stream:
                logits, caches = step(jcfg, jparams, jnp.asarray(tok), caches)
                rows.append(np.asarray(logits, np.float32)[0])
            out.append(np.stack(rows))
        _STREAMS[key] = np.stack(out)
    return _STREAMS[key]


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tick_logits_match_per_stream_decode(arch, layout, impl):
    """Externally chosen random tokens give each micro-batch its own KV
    history; every tick's completed logits equal that stream's JAX decode,
    and micro-batch ``t % M`` fed at tick t completes at tick
    ``t + n_stages - 1``."""
    _, tcfg, _, tparams = _model(arch)
    spec = PL.PipelineSpec(4, (2, 1, 2, 1))
    m, max_len, gen, bs = 4, 32, 6, 4
    feeds = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (m, gen, 1)).astype(np.int32)
    want = _jax_stream_logits(arch, feeds, max_len)
    n_blocks = m * (max_len // bs)
    state = PL.init_pipeline_decode_state(
        tcfg, spec, m, max_len, torch.float32, layout,
        num_blocks=n_blocks, block_size=bs, device="cpu")
    if layout == "paged":                 # every slot owns its whole table
        table = np.arange(n_blocks, dtype=np.int32).reshape(m, -1)
        state.caches[0]["bt"].copy_(torch.from_numpy(table))
    got = np.zeros_like(want)
    rounds = [0] * m
    with torch.no_grad():
        for t in range(m * gen + spec.n_stages - 1):
            f = t % m
            live = rounds[f] < gen
            feed = feeds[f, min(rounds[f], gen - 1)]
            rounds[f] += live
            done = PL.pipeline_decode_tick(
                tcfg, tparams, state, torch.from_numpy(feed).long(), spec,
                impl=impl, feed_valid=live)
            fed_at = t - (spec.n_stages - 1)
            assert done == (fed_at % m if fed_at >= 0 else None), t
            if done is not None:
                got[done, fed_at // m] = state.logits_out[done].numpy()
    assert state.tick == m * gen + spec.n_stages - 1
    np.testing.assert_allclose(got, want, **DECODE_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert len(np.unique(want.argmax(-1))) > 2, "degenerate reference"


def _slot_rows(backend, slot):
    """Copies of one slot's rows of every layer's cache (on the paged
    layout its table row and ring view)."""
    rows = []
    for cache in backend.state.caches:
        for key, t in cache.items():
            if key in ("k_pool", "v_pool"):
                continue
            rows.append(t[slot].clone())
    return rows


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_free_slot_caches_unchanged_across_dead_ticks(layout):
    """Slots 1 and 3 hold no request: over the ticks that serve slots 0 and
    2 (their turns are dead ticks), their cache rows -- and on the paged
    layout every pool block no live slot owns -- stay bit for bit."""
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    be = PipelineBackend(tcfg, tparams, PL.PipelineSpec(3, (0, 4, 2)),
                         n_slots=4, max_len=32, cache_layout=layout,
                         block_size=4, device="cpu", impl="cuda")
    prompts = _prompts(tcfg, (9, 5))
    be.prefill([0, 2], np.stack([np.pad(prompts[0], (0, 0)),
                                 np.pad(prompts[1], (4, 0))]), [9, 5])
    before = {s: _slot_rows(be, s) for s in (1, 3)}
    pools = [c[k].clone() for c in be.state.caches
             for k in ("k_pool", "v_pool") if k in c]
    events = 0
    for _ in range(60):
        events += len(be.decode_step({}))
    assert events == 2                   # each prompt's first-token logits
    for s in (1, 3):
        after = _slot_rows(be, s)
        assert all(torch.equal(a, b) for a, b in zip(before[s], after)), s
    if layout == "paged":                # no write outside the live blocks
        table = be.pager.table
        idle = [b for b in range(be.num_blocks + 1)
                if b not in set(table[table >= 0].tolist())]
        assert len(idle) < be.num_blocks + 1
        now = [c[k] for c in be.state.caches
               for k in ("k_pool", "v_pool") if k in c]
        assert all(torch.equal(a[idle], b[idle]) for a, b in zip(pools, now))


@pytest.mark.parametrize("n_stages", [1, 4, 6])
def test_completion_arrives_n_stages_minus_one_ticks_later(n_stages):
    """A one-token prompt fed at tick t returns its logits from the
    ``decode_step`` of tick ``t + n_stages - 1``, not before."""
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    sizes = PL.even_pipeline_spec(tcfg, n_stages).periods_per_stage
    be = PipelineBackend(tcfg, tparams, PL.PipelineSpec(n_stages, sizes),
                         n_slots=n_stages + 1, max_len=16, device="cpu")
    be.decode_step({})                   # tick 0: slot 0 has no request
    be.prefill([1], np.array([[7]], np.int32))
    ticks = []
    for t in range(1, 2 * n_stages + 2):
        for ev in be.decode_step({}):
            ticks.append(t)
            # the event owns its logits: later ticks cannot rewrite them
            assert not np.shares_memory(ev.logits,
                                        be.state.logits_out.numpy())
    assert ticks == [1 + n_stages - 1]


# --------------------------------------------------------------------------- #
# serving: PipelineBackend under LLM
# --------------------------------------------------------------------------- #

_REFERENCE = {}


def _reference_tokens(arch, layout, lens, max_tokens, max_len=40):
    """Greedy tokens of the JAX TensorBackend, equal to the port's."""
    key = (arch, layout, lens, max_tokens)
    if key not in _REFERENCE:
        jcfg, tcfg, jparams, tparams = _model(arch)
        prompts = _prompts(tcfg, lens)
        jllm = JaxLLM.from_backend(JaxTensorBackend(
            jcfg, jparams, n_slots=3, max_len=max_len, impl="xla",
            cache_layout=layout))
        want = [o.tokens for o in jllm.generate(
            prompts, JaxSamplingParams(max_tokens=max_tokens))]
        tllm = LLM.from_backend(TensorBackend(
            tcfg, tparams, n_slots=3, max_len=max_len, impl="cuda",
            cache_layout=layout, device="cpu"))
        port = [o.tokens for o in tllm.generate(
            prompts, SamplingParams(max_tokens=max_tokens))]
        assert port == want
        _REFERENCE[key] = want
    return _REFERENCE[key]


SERVE_LENS = (5, 17, 9, 12, 3, 8, 14)
SERVE_CASES = [(layout, sizes, None) for layout in ("contiguous", "paged")
               for sizes in ((1, 2, 2, 1), (0, 1, 2, 3), (6,))] + [
    ("paged", (1, 2, 2, 1), 6),          # 4 slots x 3 blocks > 6: preempt
    ("paged", (0, 1, 2, 3), 7)]


@pytest.mark.parametrize("layout,sizes,num_blocks", SERVE_CASES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_tensor_backends(arch, layout, sizes, num_blocks):
    _, tcfg, _, tparams = _model(arch)
    want = _reference_tokens(arch, layout, SERVE_LENS, 10)
    be = PipelineBackend(tcfg, tparams, PL.PipelineSpec(len(sizes), sizes),
                         n_slots=4, max_len=40, cache_layout=layout,
                         block_size=8, num_blocks=num_blocks, device="cpu",
                         impl="cuda")
    llm = LLM.from_backend(be)
    got = llm.generate(_prompts(tcfg, SERVE_LENS),
                       SamplingParams(max_tokens=10))
    assert [o.tokens for o in got] == want
    assert all(o.n_generated == 10 for o in got)
    if num_blocks is not None:
        assert llm.stats.preemptions > 0 and llm.stats.resumes > 0
        assert be.pager.free_blocks == be.pager.total_blocks
    assert be.info.spec_decode is False and be.info.prefix_caching is False
    assert be.info.attn_impl == "plain"


def test_pool_exhausted_before_any_mutation():
    """A tick whose slot cannot get its next block raises PoolExhausted
    and changes nothing: the same tick succeeds once a block is free."""
    from repro_torch.runtime import PoolExhausted
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    be = PipelineBackend(tcfg, tparams, PL.PipelineSpec(2, (3, 3)),
                         n_slots=2, max_len=32, cache_layout="paged",
                         block_size=4, num_blocks=2, device="cpu")
    prompts = _prompts(tcfg, (6, 4))
    be.prefill([0, 1], np.stack([prompts[0], np.pad(prompts[1], (2, 0))]),
               [6, 4])
    for _ in range(2):                   # slot 0 and slot 1 take a block
        be.decode_step({})
    tick, rounds = be.state.tick, dict(be._rounds)
    with pytest.raises(PoolExhausted):
        for _ in range(20):
            be.decode_step({})
    assert be.state.tick > tick
    stuck_tick, stuck_rounds = be.state.tick, dict(be._rounds)
    with pytest.raises(PoolExhausted):
        be.decode_step({})
    assert be.state.tick == stuck_tick and be._rounds == stuck_rounds
    assert rounds != stuck_rounds
    be.free_slot(1)
    be.decode_step({})
    assert be.state.tick == stuck_tick + 1


def test_unsupported_configurations_raise():
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    spec = PL.PipelineSpec(2, (3, 3))
    with pytest.raises(ValueError, match="prefix cache"):
        PipelineBackend(tcfg, tparams, spec, max_len=16, cache_layout="paged",
                        prefix_cache=True, device="cpu")
    with pytest.raises(ValueError, match="micro-batch slots"):
        PipelineBackend(tcfg, tparams, spec, n_slots=1, max_len=16,
                        device="cpu")
    be = PipelineBackend(tcfg, tparams, spec, max_len=16, device="cpu")
    for call in (lambda: be.verify_step({0: np.array([1, 2])}),
                 lambda: be.accept({0: 1}),
                 lambda: be.start_stream(0, np.array([1, 2])),
                 lambda: be.prefill_chunk([0], np.array([[1]]), [1], [0],
                                          [True])):
        with pytest.raises(NotImplementedError, match="later slice"):
            call()
    hybrid = get_config("recurrentgemma-2b").reduced(n_layers=4)
    hparams = init_params(hybrid, torch.Generator().manual_seed(0), "cpu")
    assert hybrid.n_layers % hybrid.period
    with pytest.raises(ValueError, match="n_layers % period"):
        PipelineBackend(hybrid, hparams, PL.PipelineSpec(1, (1,)),
                        max_len=16, device="cpu")


# --------------------------------------------------------------------------- #
# planner -> backend
# --------------------------------------------------------------------------- #

def test_from_deployment_three_kinds():
    jcfg, tcfg, jparams, tparams = _model("qwen3-0.6b")
    cluster, wl = tpu_pod_cluster(n_chips=4), Workload(dtype_bytes=2)
    dep = plan_deployment(tcfg, cluster, wl, objective="throughput")
    jdep = jax_plan(jcfg, jax_tpu_pod(n_chips=4), JWorkload(dtype_bytes=2),
                    objective="throughput")

    sim = from_deployment(dep, cluster, tcfg, kind="sim", workload=wl,
                          n_slots=4, max_len=64)
    jsim = jax_from_deployment(jdep, jax_tpu_pod(n_chips=4), jcfg, kind="sim",
                               workload=JWorkload(dtype_bytes=2), n_slots=4,
                               max_len=64)
    assert isinstance(sim, SimBackend)
    prompts = _prompts(tcfg, (5, 9, 3))
    got = [o.tokens for o in LLM.from_backend(sim).generate(
        prompts, SamplingParams(max_tokens=6))]
    want = [o.tokens for o in JaxLLM.from_backend(jsim).generate(
        prompts, JaxSamplingParams(max_tokens=6))]
    assert got == want

    tensor = from_deployment(dep, cluster, tcfg, kind="tensor",
                             params=tparams, max_len=32, device="cpu")
    assert isinstance(tensor, TensorBackend)
    assert tensor.n_slots == dep.batch
    assert tensor.cache_dtype == torch.float32          # the model dtype

    pipe = from_deployment(dep, cluster, tcfg, kind="pipeline",
                           params=tparams, max_len=32, device="cpu")
    assert isinstance(pipe, PipelineBackend)
    assert pipe.spec == PL.spec_from_plan(tcfg, dep.plan, len(dep.plan.stages))
    assert pipe.cache_dtype == torch.float32
    assert plan_pipeline_spec(tcfg, cluster, 4).periods_per_stage == \
        jax_plan_pipeline_spec(jcfg, jax_tpu_pod(n_chips=4), 4) \
        .periods_per_stage == pipe.spec.periods_per_stage
    with pytest.raises(ValueError, match="needs model params"):
        from_deployment(dep, cluster, tcfg, kind="pipeline")
    with pytest.raises(ValueError, match="unknown backend kind"):
        from_deployment(dep, cluster, tcfg, kind="mesh", params=tparams)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_from_plan_serves_the_planned_stages(layout):
    """``LLM.from_plan`` plans with the port's DP (uneven stages for
    qwen3's reduced stack on four chips) and serves the tensor backends'
    greedy tokens."""
    _, tcfg, _, tparams = _model("qwen3-0.6b")
    lens = (6, 11, 4, 9, 13)
    want = _reference_tokens("qwen3-0.6b", layout, lens, 8)
    llm = LLM.from_plan(tcfg, tpu_pod_cluster(n_chips=4),
                        Workload(dtype_bytes=2), objective="throughput",
                        kind="pipeline", params=tparams, max_len=40,
                        cache_layout=layout, impl="cuda", device="cpu")
    spec = llm.backend.spec
    assert llm.deployment.ok and spec.n_stages == len(
        llm.deployment.plan.stages)
    assert spec == PL.spec_from_plan(tcfg, llm.deployment.plan,
                                     spec.n_stages)
    assert spec.n_stages >= 2 and len(set(spec.periods_per_stage)) > 1
    assert [o.tokens for o in llm.generate(
        _prompts(tcfg, lens), SamplingParams(max_tokens=8))] == want


def test_serve_launcher_pipeline_equals_tp(capsys):
    from repro_torch.launch.serve import main
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch",
            "5", "--varlen", "--prompt-len", "12", "--gen", "6", "--impl",
            "cuda"]

    def tokens(out):
        return [line.split(")", 1)[1] for line in out.splitlines()
                if line.startswith("  req ")]

    main(argv)
    tp = capsys.readouterr().out
    main(argv + ["--mode", "pipeline", "--stages", "4"])
    pipe = capsys.readouterr().out
    # the 2-layer smoke stack: stages without layers at both ends
    assert "planned stages (periods per stage): (0, 1, 1, 0)" in pipe
    assert "served 5 requests" in pipe
    assert tokens(pipe) == tokens(tp) and len(tokens(tp)) == 4
    with pytest.raises(SystemExit):
        main(argv + ["--mode", "pipeline", "--spec-k", "4"])
    assert "--spec-k is not available in --mode pipeline" in \
        capsys.readouterr().err
