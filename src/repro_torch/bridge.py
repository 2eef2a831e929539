"""Weight bridge: the JAX package's parameters as the port's and back, and
seeded weights made in torch with the reference's shapes and scales.

The reference keeps full pattern periods *stacked* with a leading layer
axis (``params["stack"]["p<p>"][...]``, leaf shape ``[n_periods, ...]``)
and the remainder blocks unstacked (``params["tail"]["t<t>"]``).  The port
runs a Python loop over layers, so it keeps one dict per layer in
``params["layers"]``; everything else (embedding, head, final norm, and the
per-layer tree under each block) has the reference's names and shapes.

JAX never runs beside the port on the GPU machine, so the bridge takes the
reference tree as numpy arrays (``jax.tree.map(np.asarray, params)``) and
gives it back as numpy arrays; bfloat16 leaves go through float32, which is
exact.  :func:`reference_leaves` names each of the port's leaves by its
path in the reference's tree; the checkpoints of
:mod:`repro_torch.training.checkpoint` are written under those paths.
"""
from __future__ import annotations

import math
from typing import (Any, Callable, Dict, Iterator, List, Optional, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.device import Device, resolve_device, torch_dtype
from repro_torch.models.config import BlockSpec, ModelConfig, MoEConfig


def _to_torch(tree: Any, device: torch.device,
              dtype: Optional[torch.dtype]) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
    if dtype is None:
        dtype = torch_dtype(str(arr.dtype))
    return t.to(device=device, dtype=dtype)


def _layer_tree(params: Dict, cfg: ModelConfig, i: int) -> Dict:
    """Layer ``i``'s subtree of the reference's stacked/tail layout."""
    n_stacked = cfg.n_full_periods * cfg.period
    if i < n_stacked:
        r, p = divmod(i, cfg.period)

        def pick(t):
            return {k: pick(v) for k, v in t.items()} \
                if isinstance(t, dict) else np.asarray(t)[r]
        return pick(params["stack"][f"p{p}"])
    return params["tail"][f"t{i - n_stacked}"]


def params_from_numpy(cfg: ModelConfig, params: Dict, device: Device = None,
                      dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference's parameter tree (numpy leaves) as the port's.

    ``dtype`` None keeps each leaf's own dtype."""
    dev = resolve_device(device)
    out = {k: _to_torch(v, dev, dtype) for k, v in params.items()
           if k not in ("stack", "tail")}
    out["layers"] = [_to_torch(_layer_tree(params, cfg, i), dev, dtype)
                     for i in range(cfg.n_layers)]
    return out


def _flat(tree: Any, prefix: str) -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def reference_leaves(cfg: ModelConfig, params: Dict,
                     ) -> Dict[str, Union[torch.Tensor, List[torch.Tensor]]]:
    """The port's leaves by their path in the reference's tree
    (``"embedding"``, ``"stack/p0/mixer/wq"``, ``"tail/t1/norm1/scale"``):
    a path under ``stack`` maps to the list of its layers' tensors, in the
    order of the reference's leading layer axis; every other path to one
    tensor.  The inverse of :func:`params_from_numpy`'s layout, for any
    tree with the parameters' structure (AdamW moments too)."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k != "layers":
            out.update(_flat(v, k))
    n_stacked = cfg.n_full_periods * cfg.period
    for i, layer in enumerate(params["layers"]):
        if i < n_stacked:
            for path, t in _flat(layer, f"stack/p{i % cfg.period}"):
                out.setdefault(path, []).append(t)
        else:
            out.update(_flat(layer, f"tail/t{i - n_stacked}"))
    return out


def reference_ndim(cfg: ModelConfig, params: Dict) -> Dict:
    """The rank each of the port's leaves has in the reference's tree, in
    the structure of ``params``: one more than its own for a layer under
    ``stack`` (the leading layer axis), its own elsewhere.  The reference's
    AdamW decays the leaves of rank 2 and more of that tree, so its stacked
    norm scales are decayed and its tail ones are not; the port's trainer
    follows it through this."""
    def ranks(tree: Any, extra: int) -> Any:
        if isinstance(tree, dict):
            return {k: ranks(v, extra) for k, v in tree.items()}
        return tree.dim() + extra

    n_stacked = cfg.n_full_periods * cfg.period
    out = {k: ranks(v, 0) for k, v in params.items() if k != "layers"}
    out["layers"] = [ranks(layer, int(i < n_stacked))
                     for i, layer in enumerate(params["layers"])]
    return out


def _float_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def reference_arrays(cfg: ModelConfig, params: Dict,
                     to_numpy: Callable[[torch.Tensor], np.ndarray]
                     = _float_numpy) -> Dict[str, np.ndarray]:
    """The port's leaves as numpy arrays by their path in the reference's
    tree, each ``stack`` path's layers stacked along a leading layer axis;
    ``to_numpy`` converts one tensor (by default bfloat16 to float32,
    exact)."""
    return {path: np.stack([to_numpy(t) for t in leaf])
            if isinstance(leaf, list) else to_numpy(leaf)
            for path, leaf in reference_leaves(cfg, params).items()}


def params_to_numpy(cfg: ModelConfig, params: Dict) -> Dict:
    """The port's parameters (or a tree of their structure) as the
    reference's tree of numpy arrays, ``stack`` stacked along a leading
    layer axis; the inverse of :func:`params_from_numpy`.  bfloat16 leaves
    come back as float32 (exact)."""
    tree: Dict[str, Any] = {}
    for path, arr in reference_arrays(cfg, params).items():
        *parents, name = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = arr
    return tree


def param_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of every leaf of the port's parameter tree, in its
    structure: the reference's ``init_params`` axes (its
    ``ParamBuilder.add`` calls), without the leading ``"layers"`` axis of
    its stacked leaves, since the port keeps one dict a layer."""
    def norm() -> Dict:
        out = {"scale": ("embed",)}
        if cfg.norm == "layernorm":
            out["bias"] = ("embed",)
        return out

    def attention() -> Dict:
        out = {"wq": ("embed", "qkv"), "wk": ("embed", "qkv"),
               "wv": ("embed", "qkv"), "wo": ("qkv", "embed")}
        if cfg.qkv_bias:
            out.update(bq=("qkv",), bk=("qkv",), bv=("qkv",))
        if cfg.qk_norm:
            out.update(q_norm=(None,), k_norm=(None,))
        return out

    def recurrent() -> Dict:
        rnn = ("embed", "rnn")
        return {"w_gelu": rnn, "w_rnn_in": rnn, "conv_w": (None, "rnn"),
                "conv_b": ("rnn",), "w_a": rnn, "w_x": rnn, "lam": ("rnn",),
                "w_out": ("rnn", "embed")}

    def mlstm() -> Dict:
        return {"w_up": ("embed", "heads"), "w_gate": ("embed", "heads"),
                **{k: ("heads", None) for k in ("wq", "wk", "wv", "w_i",
                                                "w_f")},
                "b_i": (None,), "b_f": (None,), "w_down": ("heads", "embed")}

    def slstm() -> Dict:
        out = {}
        for g in ("i", "f", "z", "o"):
            out.update({f"w_{g}": ("embed", None),
                        f"r_{g}": ("heads", None, None), f"b_{g}": (None,)})
        out.update(w_up=("embed", "ff"), w_down=("ff", "embed"))
        return out

    def ffn(spec: BlockSpec) -> Dict:
        if spec.moe is None:
            return {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
                    "w_down": ("ff", "embed")}
        out = {"router": ("embed", None),
               "w_gate": ("experts", "embed", None),
               "w_up": ("experts", "embed", None),
               "w_down": ("experts", None, "embed")}
        if spec.moe.num_shared_experts:
            out.update(s_gate=("embed", "ff"), s_up=("embed", "ff"),
                       s_down=("ff", "embed"))
        return out

    mixers = {"attn": attention, "rglru": recurrent, "mlstm": mlstm,
              "slstm": slstm}

    def block(spec: BlockSpec) -> Dict:
        out: Dict[str, Any] = {"norm1": norm(), "mixer": mixers[spec.kind]()}
        if cfg.post_norm:
            out["post_norm1"] = norm()
        if spec.moe is not None or spec.mlp != "none":
            out["norm2"] = norm()
            out["ffn"] = ffn(spec)
            if cfg.post_norm:
                out["post_norm2"] = norm()
        return out

    axes: Dict[str, Any] = {"embedding": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    axes["final_norm"] = norm()
    axes["layers"] = [block(spec) for spec in cfg.layer_specs()]
    return axes


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device: Device = None,
                dtype: Optional[torch.dtype] = None) -> Dict:
    """Seeded weights with the shapes and scales of the reference's
    ``ParamBuilder.add``: normal leaves scaled by ``1/sqrt(shape[0])``
    (``d_model**-0.5`` for the embedding), norm scales 1, biases 0 (the
    mLSTM and sLSTM forget-gate biases 1).  ``shape[0]`` is the fan-in of a
    matrix, but the expert count of an expert tensor ``[E, d, f]`` and the
    head count of an sLSTM recurrent tensor ``[h, dh, dh]``, as in the
    reference.  Every leaf is drawn in ``dtype`` on ``device``: a bf16
    expert tensor is never held in float32.

    ``generator`` must live on ``device`` (a CUDA generator for a CUDA
    device).  The numbers differ from ``jax.random``'s for the same seed;
    tests that compare the two packages bridge the reference's weights with
    :func:`params_from_numpy` instead.

    ``device="meta"`` gives the tree's shapes and dtypes with nothing drawn
    and no storage (the reference's ``jax.eval_shape(init_params)``);
    ``generator`` is then None.
    """
    dev = resolve_device(device)
    if (generator is None) != (dev.type == "meta"):
        raise ValueError("init_params draws from a generator on a device, "
                         "and from none on 'meta'")
    dt = dtype if dtype is not None else torch_dtype(cfg.dtype)

    def normal(*shape: int, scale: Optional[float] = None) -> torch.Tensor:
        s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        x = torch.randn(shape, generator=generator, device=dev, dtype=dt)
        return x.mul_(s)

    def ones(*shape: int) -> torch.Tensor:
        return torch.ones(shape, device=dev, dtype=dt)

    def zeros(*shape: int) -> torch.Tensor:
        return torch.zeros(shape, device=dev, dtype=dt)

    def norm() -> Dict[str, torch.Tensor]:
        out = {"scale": ones(cfg.d_model)}
        if cfg.norm == "layernorm":
            out["bias"] = zeros(cfg.d_model)
        return out

    def attention() -> Dict[str, torch.Tensor]:
        d, q, kv, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.resolved_head_dim
        mixer = {"wq": normal(d, q), "wk": normal(d, kv), "wv": normal(d, kv),
                 "wo": normal(q, d)}
        if cfg.qkv_bias:
            mixer.update(bq=zeros(q), bk=zeros(kv), bv=zeros(kv))
        if cfg.qk_norm:
            mixer.update(q_norm=ones(hd), k_norm=ones(hd))
        return mixer

    def recurrent() -> Dict[str, torch.Tensor]:
        # init_rglru_block of the reference
        d, r = cfg.d_model, cfg.rnn_dim
        return {"w_gelu": normal(d, r), "w_rnn_in": normal(d, r),
                "conv_w": normal(cfg.conv_width, r), "conv_b": zeros(r),
                "w_a": normal(d, r), "w_x": normal(d, r),
                "lam": normal(r, scale=0.5), "w_out": normal(r, d)}

    def mlstm() -> Dict[str, torch.Tensor]:
        # init_mlstm_block of the reference
        d, h = cfg.d_model, cfg.n_heads
        dp = int(d * cfg.mlstm_proj_factor)
        return {"w_up": normal(d, dp), "w_gate": normal(d, dp),
                "wq": normal(dp, dp), "wk": normal(dp, dp),
                "wv": normal(dp, dp), "w_i": normal(dp, h),
                "w_f": normal(dp, h), "b_i": zeros(h), "b_f": ones(h),
                "w_down": normal(dp, d)}

    def slstm() -> Dict[str, torch.Tensor]:
        # init_slstm_block of the reference
        d, h = cfg.d_model, cfg.n_heads
        dp = int(d * cfg.slstm_proj_factor)
        out = {}
        for g in ("i", "f", "z", "o"):
            out[f"w_{g}"] = normal(d, d)
            out[f"r_{g}"] = normal(h, d // h, d // h)
            out[f"b_{g}"] = ones(d) if g == "f" else zeros(d)
        out.update(w_up=normal(d, dp), w_down=normal(dp, d))
        return out

    def moe(m: MoEConfig) -> Dict[str, torch.Tensor]:
        # init_moe of the reference
        d, f, e = cfg.d_model, m.d_expert, m.num_experts
        out = {"router": normal(d, e), "w_gate": normal(e, d, f),
               "w_up": normal(e, d, f), "w_down": normal(e, f, d)}
        if m.num_shared_experts:
            s = m.num_shared_experts * f
            out.update(s_gate=normal(d, s), s_up=normal(d, s),
                       s_down=normal(s, d))
        return out

    mixers = {"attn": attention, "rglru": recurrent, "mlstm": mlstm,
              "slstm": slstm}

    def block(spec: BlockSpec) -> Dict:
        if spec.kind not in mixers:
            raise ValueError(f"unknown block kind {spec.kind!r}")
        d = cfg.d_model
        out: Dict[str, Any] = {"norm1": norm(), "mixer": mixers[spec.kind]()}
        if cfg.post_norm:
            out["post_norm1"] = norm()
        if spec.moe is not None or spec.mlp != "none":
            f = cfg.d_ff
            out["norm2"] = norm()
            out["ffn"] = moe(spec.moe) if spec.moe is not None else {
                "w_gate": normal(d, f), "w_up": normal(d, f),
                "w_down": normal(f, d)}
            if cfg.post_norm:
                out["post_norm2"] = norm()
        return out

    params: Dict[str, Any] = {
        "embedding": normal(cfg.vocab_size, cfg.d_model,
                            scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(cfg.d_model, cfg.vocab_size)
    params["final_norm"] = norm()
    params["layers"] = [block(spec) for spec in cfg.layer_specs()]
    return params
