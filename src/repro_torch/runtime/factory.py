"""planner -> backend: turn a DP :class:`~repro_torch.core.planner.Deployment`
into a running :class:`InferenceBackend` in one call.

Port of ``repro.runtime.factory``: the seam between the paper's Fig. 3
planning stage and the serving stack.  The same ``Deployment`` object can
be materialized as

- ``kind="pipeline"`` -- the no-bubbles stage pipeline on one device
  (stage layout via :func:`repro_torch.core.pipeline.spec_from_plan`, so
  uneven planner stages are preserved), its stages in this process or,
  with ``stage_procs=True``, one process a stage,
- ``kind="tensor"``   -- the single-device tensor backend (capacity taken
  from the plan's feasible batch),
- ``kind="sim"``      -- the discrete-event cost model, for planner sweeps
  that need the serving interface without a model.

Both real kinds store the KV cache in the model dtype unless
``cache_dtype`` says otherwise (the reference defaults to float32).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.devices import ClusterSpec
from repro_torch.core.planner import Deployment
from repro_torch.core.profile import ModelProfile, Workload
from repro_torch.core.simulator import build_stage_costs
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.base import InferenceBackend
from repro_torch.runtime.sim import SimBackend


def plan_pipeline_spec(cfg: ModelConfig, cluster: ClusterSpec,
                       n_stages: int, workload: Optional[Workload] = None):
    """DP-derived (possibly uneven) stage layout from the throughput planner
    run over ``cluster``.  Raises if the plan is memory-infeasible."""
    from repro_torch.core.partition import solve_throughput
    from repro_torch.core.pipeline import spec_from_plan
    from repro_torch.core.planner import build_problem

    prob = build_problem(cfg, cluster, workload or Workload(dtype_bytes=2))
    plan = solve_throughput(prob)
    if not len(plan.assignment):
        raise ValueError(
            f"{cfg.name}: infeasible on {cluster.n} devices (memory) — "
            f"DP found no plan; use more stages/chips or quantize")
    return spec_from_plan(cfg, plan, n_stages)


def from_deployment(deployment: Deployment, cluster: ClusterSpec,
                    cfg: ModelConfig, *, kind: str = "pipeline",
                    params: Optional[Dict] = None,
                    workload: Optional[Workload] = None,
                    n_slots: Optional[int] = None, max_len: int = 256,
                    cache_dtype=None, schedule: str = "nobubbles",
                    impl: str = "ref",
                    cache_layout: str = "contiguous", block_size: int = 16,
                    num_blocks: Optional[int] = None,
                    prefix_cache: bool = False, device=None,
                    stage_procs: bool = False) -> InferenceBackend:
    """Materialize a planned deployment as a serving backend.

    ``cache_layout="paged"`` provisions a shared KV block pool (``num_blocks``
    blocks of ``block_size`` tokens; default = no overcommit) instead of
    worst-case per-slot caches -- all three kinds honour it (``sim`` keeps
    accounting only).  ``impl="cuda"`` reads the caches with the
    hand-written decode attention kernels on both real kinds (a paged int8
    cache by gather, as in the reference), ``impl="chunked"`` prefills
    with the online softmax over key blocks; ``device``
    is where they run (the GPU unless ``"cpu"`` is asked for).
    ``stage_procs=True`` runs the pipeline's stages one a process
    (:mod:`repro_torch.core.stage_procs`; close the backend when done).
    """
    assert deployment.ok, f"deployment {deployment.method} is OOM-infeasible"
    plan = deployment.plan
    n_stages = len(plan.stages)

    if kind == "sim":
        profile = ModelProfile.from_config(cfg, workload or Workload())
        mb = max(deployment.batch, 1)
        costs = build_stage_costs(profile, cluster, plan, mb_batch=mb)
        return SimBackend(costs, n_slots=n_slots or 2 * n_stages,
                          mb_batch=mb, schedule=schedule,
                          vocab_size=cfg.vocab_size, max_len=max_len,
                          cache_layout=cache_layout, block_size=block_size,
                          num_blocks=num_blocks, prefix_cache=prefix_cache)

    if params is None:
        raise ValueError(f"kind={kind!r} needs model params")
    if stage_procs and kind != "pipeline":
        raise ValueError(f"stage_procs runs the pipeline's stages one a "
                         f"process; kind={kind!r} has no stages")

    if kind == "tensor":
        from repro_torch.runtime.tensor import TensorBackend
        return TensorBackend(cfg, params,
                             n_slots=n_slots or max(deployment.batch, 1),
                             max_len=max_len, impl=impl,
                             cache_dtype=cache_dtype,
                             cache_layout=cache_layout,
                             block_size=block_size, num_blocks=num_blocks,
                             device=device, prefix_cache=prefix_cache)

    if kind == "pipeline":
        from repro_torch.core.pipeline import spec_from_plan
        from repro_torch.runtime.pipeline_backend import PipelineBackend
        spec = spec_from_plan(cfg, plan, n_stages)
        return PipelineBackend(cfg, params, spec, n_slots=n_slots,
                               max_len=max_len, cache_dtype=cache_dtype,
                               impl=impl, cache_layout=cache_layout,
                               block_size=block_size, num_blocks=num_blocks,
                               prefix_cache=prefix_cache, device=device,
                               stage_procs=stage_procs)

    raise ValueError(f"unknown backend kind {kind!r}")
