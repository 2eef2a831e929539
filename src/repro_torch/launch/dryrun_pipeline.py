"""Pipeline-mode dry run: every stage process of the EdgeShard pipeline
run on the ``meta`` device for one tick or one forward, with its flops,
bytes, memory and collective bytes counted as :mod:`repro_torch.launch.dryrun`
counts them, so the two distribution modes compare.

Port of ``repro.launch.dryrun_pipeline``.  The ``model`` axis carries the
stages and ``data`` (x ``pod``) the batch, as in the reference; the
``--layout dp`` stage layout comes from the throughput planner through
``runtime.factory.plan_pipeline_spec`` over ``core.devices.tpu_pod_cluster``
(the reference's ``dp_pipeline_spec``), ``--layout even`` from
``core.pipeline.even_pipeline_spec``.  Each stage's process runs the code a
process of the port's pipeline runs, not a copy of it:

- a decode shape: one no-bubbles tick of the stage's process of a
  :class:`~repro_torch.core.stage_procs.StageProcs` ring
  (``_Stage.tick``): its layers over one micro-batch's activation, the
  embedding on stage 0, the final norm and the head on the last, and its
  hop to the next stage; with ``--vocab-sharded`` every stage holds its
  shard of the vocabulary and the tick adds its embedding all-reduce and
  its broadcast of the last stage's hidden.  The port's ring feeds one row
  a micro-batch (a slot), so a data row's ring holds ``global_batch /
  |batch axes|`` slots unless ``--microbatches`` says otherwise, and every
  stage is live: ``utilization`` is the ring's slots over its stages;
- a prefill shape: the stage's part of ``MeshProcs.pipeline_forward``
  (``core.mesh_procs._pipeline_rank``): ``m`` micro-batches, each one's
  rows split over the batch axes, through its layers, received from and
  sent to its neighbours in the same data row, the final norm and the head
  on the last stage.  ``m`` is ``--microbatches``, else the most, up to the
  stage count, whose micro-batches split over the batch axes.

The stages differ in their layers and in the embedding and the head, so
every stage's process runs (16 on the single-pod mesh); a stage's
collectives go to its own :class:`~repro_torch.launch.dryrun.MetaComm`.  A
stage holds its own tensors only
(:func:`~repro_torch.core.stage_procs.stage_params`) and the port makes no
padded restack to the longest stage, so a stage's argument bytes are its
own layers' (with the vocabulary it holds and its caches); the ring's
``[M, V]`` logits live in the host's memory and are no argument.  A stage
runs its MoE layers on ``moe_ragged`` (no mesh is installed in a stage),
whose group sizes are host reads, so an MoE config's record fails.  The
record's top-level figures are the largest stage's (by flops, then bytes),
since that stage sets the tick; ``stages`` holds each stage's.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun_pipeline \\
        --arch starcoder2-7b --shape decode_32k [--microbatches 16] \\
        [--layout even|dp] [--tag-suffix +pipeline]
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.bridge import init_params
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import pipeline as PL
from repro_torch.core.stage_procs import COLLECTIVE_KINDS, _Stage, stage_params
from repro_torch.launch.dryrun import (META, MetaComm, _counted, _MetaRank,
                                       collective_bytes, resolve_impl,
                                       tree_bytes)
from repro_torch.launch.mesh import Mesh, make_production_mesh, n_chips
from repro_torch.models.config import InputShape, ModelConfig


def dp_pipeline_spec(cfg: ModelConfig, n_stages: int) -> PL.PipelineSpec:
    """DP-derived (possibly uneven) stage layout from the throughput planner
    run over a homogeneous n_stages-device TPU cluster profile (the runtime
    factory's planner -> spec path, which serving builds on)."""
    from repro_torch.core.devices import tpu_pod_cluster
    from repro_torch.runtime.factory import plan_pipeline_spec

    return plan_pipeline_spec(cfg, tpu_pod_cluster(n_stages), n_stages)


def prefill_microbatches(b: int, n_stages: int, n_rows: int) -> int:
    """The most micro-batches, up to ``n_stages``, into which a batch of
    ``b`` rows splits with each micro-batch a whole number of ``n_rows``
    blocks (``mesh_procs.microbatch_rows``); raises where none does."""
    for m in range(min(n_stages, b), 0, -1):
        if b % m == 0 and (b // m) % n_rows == 0:
            return m
    raise ValueError(f"a batch of {b} rows does not split over {n_rows} "
                     f"points of the batch axes")


def _tick_step(cfg, spec, shape, at, stage, m, vocab_sharded, impl):
    """Stage ``stage``'s process of a ring of ``m`` slots, every stage
    live: (``step()``, its arguments, its comm)."""
    comm = at.comm
    params = init_params(cfg, None, META)
    ns = spec.n_stages
    job = dict(cfg=cfg, spec=spec, n_slots=m, max_len=shape.seq_len,
               cache_dtype=torch.bfloat16, cache_layout="contiguous",
               num_blocks=0, block_size=16, impl=impl, device="meta",
               vocab_sharded=vocab_sharded,
               logits=torch.empty((m, cfg.vocab_size), dtype=torch.float32,
                                  device=META),
               act_dtype=params["embedding"].dtype,
               params=stage_params(cfg, params, spec, stage, vocab_sharded))
    proc = _Stage(stage, job, None, comm=comm)
    st = proc.state
    st.buf_valid = [True] * ns
    st.buf_mb = [(-r) % m for r in range(ns)]
    if stage:
        proc.held = torch.empty((1, 1, cfg.d_model), dtype=job["act_dtype"],
                                device=META)
    args = dict(params=job["params"], caches=st.caches, held=proc.held)

    def step():
        row = st.logits_out[st.buf_mb[-1]]        # the last stage's slot
        proc.tick(0, True, shape.seq_len - 1, [])
        if proc.shard is not None:
            row = row[proc.shard]
        return dict(state=st.caches, held=proc.held,
                    logits=row if proc.shard is not None or stage == ns - 1
                    else None)
    return step, args, comm


def _forward_step(cfg, spec, shape, at, stage, m, stage_axis, batch_axes,
                  impl):
    """Stage ``stage``'s process of ``pipeline_forward`` over ``m``
    micro-batches: (``step()``, its arguments, its comm)."""
    from repro_torch.core.mesh_procs import _pipeline_rank, microbatch_rows
    from repro_torch.models.frontends import input_spec_for
    from repro_torch.sharding.rules import P, axis_size, local_slice
    params = init_params(cfg, None, META)
    mine = stage_params(cfg, params, spec, stage)
    act = params["embedding"].dtype
    rank = _MetaRank(at, cfg=cfg, params=mine, impl=impl, act_dtype=act)
    b, s = shape.global_batch, shape.seq_len
    tokens = input_spec_for(cfg, b, s)
    out = torch.empty((b, s, cfg.vocab_size), dtype=act, device=META)
    mb = microbatch_rows(b, m, axis_size(at, batch_axes))
    rows = P(None, batch_axes)
    args = dict(params=mine, tokens=local_slice(
        tokens.reshape(m, mb, *tokens.shape[1:]), rows, at))
    last = stage == spec.n_stages - 1

    def step():
        _pipeline_rank(rank, tokens, spec, m, stage_axis, batch_axes, out)
        return dict(logits=local_slice(out.view(m, mb, *out.shape[1:]), rows,
                                       at) if last else None)
    return step, args, rank.comm


def analyse_pipeline(cfg: ModelConfig, shape: InputShape, mesh: Mesh,
                     spec: PL.PipelineSpec, n_microbatches: Optional[int],
                     stage_axis: str = "model", batch_axes=("data",),
                     vocab_sharded: bool = False,
                     impl: str = "ref") -> Dict[str, Any]:
    """Every stage's process of ``spec`` on ``mesh`` (stages over
    ``stage_axis``, at coordinate 0 of every other axis) under the
    counters; the record's figures: the largest stage's at the top,
    ``stages`` each one's."""
    impl = resolve_impl(impl)
    ns = mesh.shape[stage_axis]
    if spec.n_stages != ns:
        raise ValueError(f"{spec.n_stages} stages on a {stage_axis} axis of "
                         f"{ns}")
    layers = PL.stage_layers(cfg, spec)
    if any(s.moe is not None for s in cfg.layer_specs()):
        raise ValueError(f"{cfg.name}: a stage's MoE layers run moe_ragged "
                         f"(no mesh is installed in a stage), whose group "
                         f"sizes are read on the host (moe._group_sizes): "
                         f"meta tensors hold no values")
    n_batch = math.prod(mesh.shape[a] for a in batch_axes)
    if shape.phase == "decode":
        if vocab_sharded:
            PL.vocab_shard(cfg, ns, 0)           # raises where V % ns
        if n_microbatches is None and shape.global_batch % n_batch:
            raise ValueError(f"{shape.global_batch} rows do not split over "
                             f"{n_batch} rings (the batch axes)")
        m = n_microbatches or shape.global_batch // n_batch
        mb = 1
    else:
        if vocab_sharded:
            raise ValueError("vocab_sharded is the decode tick's: the "
                             "pipeline_forward of the port's mesh embeds on "
                             "its first stage and projects on its last")
        m = n_microbatches or prefill_microbatches(shape.global_batch, ns,
                                                   n_batch)
        mb = shape.global_batch // m
    stages = []
    for s in range(ns):
        comm = MetaComm(mesh)
        at = mesh.at(mesh.rank_of({a: s if a == stage_axis else 0
                                   for a in mesh.axis_names}), comm)

        def build(s=s, at=at):
            if shape.phase == "decode":
                return _tick_step(cfg, spec, shape, at, s, m, vocab_sharded,
                                  impl)
            return _forward_step(cfg, spec, shape, at, s, m, stage_axis,
                                 batch_axes, impl)
        got = _counted(build)
        comm = got["comm"]
        stages.append({
            "stage": s, "rank": at.rank,
            "layers": [layers[s].start, layers[s].stop],
            "run_s": round(got["run_s"], 3),
            "cost_analysis": {"flops": got["flops"],
                              "bytes accessed": got["bytes_accessed"]},
            "ops": got["ops"],
            "argument_size_in_bytes": int(tree_bytes(got["args"])),
            "output_size_in_bytes": int(tree_bytes(got["out"])),
            "temp_size_in_bytes": int(got["temp"]),
            "collective_bytes": collective_bytes(comm),
            "collective_calls": {k: int(comm.collectives[k]["calls"])
                                 for k in COLLECTIVE_KINDS},
            "state_in_place": got["in_place"],
        })
    top = max(stages, key=lambda r: (r["cost_analysis"]["flops"],
                                     r["cost_analysis"]["bytes accessed"]))
    rec = {k: v for k, v in top.items() if k not in ("layers", "run_s")}
    rec.update(per_process=True, n_microbatches=m, mb=mb,
               utilization=min(1.0, m / ns),
               run_s=round(sum(r["run_s"] for r in stages), 3),
               stages=stages)
    return rec


def run_pipeline_one(arch: str, shape_name: str, multi_pod: bool = False,
                     n_microbatches: Optional[int] = None,
                     layout: str = "even", out_dir: Optional[str] = None,
                     tag_suffix: str = "+pipeline",
                     mesh: Optional[Mesh] = None, stage_axis: str = "model",
                     vocab_sharded: bool = False,
                     impl: str = "ref") -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    other = "data" if stage_axis == "model" else "model"
    batch_axes = ("pod", other) if multi_pod else (other,)
    ns = mesh.shape[stage_axis]
    if layout == "dp":
        spec = dp_pipeline_spec(cfg, ns)
    elif layout == "even":
        spec = PL.even_pipeline_spec(cfg, ns)
    else:
        raise ValueError(f"layout {layout!r}: expected 'even' or 'dp'")
    rec: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape_name, "mode": f"pipeline-{layout}",
        "stage_axis": stage_axis, "vocab_sharded": vocab_sharded,
        "mesh": dict(mesh.shape), "chips": n_chips(mesh),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "phase": shape.phase, "n_stages": ns,
        "periods_per_stage": list(spec.periods_per_stage),
    }
    rec.update(analyse_pipeline(cfg, shape, mesh, spec, n_microbatches,
                                stage_axis, batch_axes, vocab_sharded, impl))
    rec["ok"] = True
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        tag = f"{cfg.name}{tag_suffix}_{shape_name}_" \
              f"{'multipod' if multi_pod else 'pod'}"
        Path(out_dir, tag.replace("/", "-") + ".json").write_text(
            json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Every stage process of the pipeline on the meta "
                    "device: flops, bytes, memory and collective bytes "
                    "(no device).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--layout", default="even", choices=["even", "dp"])
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--tag-suffix", default="+pipeline")
    ap.add_argument("--stage-axis", default="model",
                    choices=["model", "data"],
                    help="mesh axis carrying pipeline stages (batch uses "
                         "the other axis)")
    ap.add_argument("--vocab-sharded", action="store_true",
                    help="shard embed/head tables over the stage axis "
                         "(the decode tick)")
    ap.add_argument("--impl", default="ref",
                    choices=["ref", "xla", "chunked"])
    args = ap.parse_args(argv)
    rec = run_pipeline_one(args.arch, args.shape, args.multi_pod,
                           args.microbatches, args.layout, args.out_dir,
                           args.tag_suffix, stage_axis=args.stage_axis,
                           vocab_sharded=args.vocab_sharded, impl=args.impl)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
