"""Weight bridge: the JAX package's parameters as the port's, and seeded
weights made in torch with the reference's shapes and scales.

The reference keeps full pattern periods *stacked* with a leading layer
axis (``params["stack"]["p<p>"][...]``, leaf shape ``[n_periods, ...]``)
and the remainder blocks unstacked (``params["tail"]["t<t>"]``).  The port
runs a Python loop over layers, so it keeps one dict per layer in
``params["layers"]``; everything else (embedding, head, final norm, and the
per-layer tree under each block) has the reference's names and shapes.

JAX never runs beside the port on the GPU machine, so the bridge takes the
reference tree as numpy arrays (``jax.tree.map(np.asarray, params)``);
bfloat16 leaves go through float32, which is exact.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import Device, resolve_device, torch_dtype
from repro_torch.models.config import BlockSpec, ModelConfig


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


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Device = None,
                dtype: Optional[torch.dtype] = None) -> Dict:
    """Seeded weights with the shapes and scales of the reference's
    ``ParamBuilder.add``: normal leaves scaled by ``1/sqrt(fan_in)``
    (``d_model**-0.5`` for the embedding), norm scales 1, biases 0.

    ``generator`` must live on ``device`` (a CUDA generator for a CUDA
    device).  The numbers differ from ``jax.random``'s for the same seed;
    tests that compare the two packages bridge the reference's weights with
    :func:`params_from_numpy` instead.
    """
    dev = resolve_device(device)
    dt = dtype if dtype is not None else torch_dtype(cfg.dtype)

    def normal(*shape: int, scale: Optional[float] = None) -> torch.Tensor:
        s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        x = torch.randn(shape, generator=generator, device=dev, dtype=dt)
        return x.mul_(s)

    def ones(n: int) -> torch.Tensor:
        return torch.ones(n, device=dev, dtype=dt)

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros(n, device=dev, dtype=dt)

    def norm() -> Dict[str, torch.Tensor]:
        out = {"scale": ones(cfg.d_model)}
        if cfg.norm == "layernorm":
            out["bias"] = zeros(cfg.d_model)
        return out

    def block(spec: BlockSpec) -> Dict:
        if spec.kind != "attn" or spec.moe is not None:
            raise ValueError(f"block kind={spec.kind!r} arrives with its "
                             f"mixer in a later slice")
        d, q, kv, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.resolved_head_dim
        mixer = {"wq": normal(d, q), "wk": normal(d, kv), "wv": normal(d, kv),
                 "wo": normal(q, d)}
        if cfg.qkv_bias:
            mixer.update(bq=zeros(q), bk=zeros(kv), bv=zeros(kv))
        if cfg.qk_norm:
            mixer.update(q_norm=ones(hd), k_norm=ones(hd))
        out: Dict[str, Any] = {"norm1": norm(), "mixer": mixer}
        if cfg.post_norm:
            out["post_norm1"] = norm()
        if spec.mlp != "none":
            f = cfg.d_ff
            out["norm2"] = norm()
            out["ffn"] = {"w_gate": normal(d, f), "w_up": normal(d, f),
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
