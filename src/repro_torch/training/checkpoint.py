"""Checkpoints in the reference's format: ``<dir>/ckpt_<step>.npz`` plus
``manifest.json``.  Port of ``repro.training.checkpoint``.

The archive holds one array per leaf under ``params/<path>`` and, with an
optimizer state, ``opt/.step``, ``opt/.mu/<path>`` and ``opt/.nu/<path>``,
where ``<path>`` is the leaf's path in the reference's parameter tree
(:func:`repro_torch.bridge.reference_arrays`: ``stack`` leaves stacked
along a leading layer axis).  So a checkpoint written by either package
restores in the other.  bfloat16 leaves are stored as the reference stores
them, two raw bytes per value (numpy dtype ``V2``), and restore by their
bits.  Both files are written to a temporary name and renamed into place.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import reference_arrays, reference_leaves
from repro_torch.models.config import ModelConfig
from repro_torch.training.adamw import AdamWState

SEP = "/"
_BF16_BITS = np.dtype("V2")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def _to_torch(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype == _BF16_BITS:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _blobs(cfg: ModelConfig, tree: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return {prefix + SEP + path: arr for path, arr
            in reference_arrays(cfg, tree, _to_numpy).items()}


def save_checkpoint(path: str, cfg: ModelConfig, params: Dict,
                    opt_state: Optional[AdamWState] = None, step: int = 0,
                    extra: Optional[Dict] = None) -> str:
    """Write ``<path>/ckpt_<step>.npz`` and ``<path>/manifest.json``;
    returns the archive's path."""
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    blobs = _blobs(cfg, params, "params")
    if opt_state is not None:
        blobs[f"opt{SEP}.step"] = np.asarray(opt_state.step, np.int32)
        blobs.update(_blobs(cfg, opt_state.mu, f"opt{SEP}.mu"))
        blobs.update(_blobs(cfg, opt_state.nu, f"opt{SEP}.nu"))
    fname = out / f"ckpt_{step}.npz"
    tmp = out / f".tmp_ckpt_{step}.npz"
    np.savez(tmp, **blobs)
    os.replace(tmp, fname)
    manifest = {"step": step, "keys": sorted(blobs), "extra": extra or {}}
    tmp_manifest = out / ".tmp_manifest.json"
    tmp_manifest.write_text(json.dumps(manifest, indent=1))
    os.replace(tmp_manifest, out / "manifest.json")
    return str(fname)


def latest_checkpoint(path: str) -> Optional[str]:
    """The archive of the highest step under ``path``, or None."""
    out = Path(path)
    if not out.exists():
        return None
    ckpts = sorted(out.glob("ckpt_*.npz"),
                   key=lambda p: int(p.stem.split("_")[1]))
    return str(ckpts[-1]) if ckpts else None


def restore_checkpoint(fname: str, cfg: ModelConfig, params: Dict,
                       opt_state: Optional[AdamWState] = None,
                       ) -> Tuple[Dict, Optional[AdamWState], int]:
    """Restore ``fname`` into ``params`` (and ``opt_state``'s moments) in
    place, each leaf keeping its dtype and device; returns (params,
    optimizer state or None, step).  Raises on a missing key or a shape
    that does not fit."""
    step = int(Path(fname).stem.split("_")[1])
    with np.load(fname) as blobs:
        def fill(tree: Dict, prefix: str) -> None:
            for path, leaf in reference_leaves(cfg, tree).items():
                key = prefix + SEP + path
                if key not in blobs.files:
                    raise KeyError(f"{fname} holds no {key!r}")
                arr = blobs[key]
                leaves = leaf if isinstance(leaf, list) else [leaf]
                rows = list(arr) if isinstance(leaf, list) else [arr]
                if len(rows) != len(leaves) or any(
                        r.shape != tuple(t.shape)
                        for r, t in zip(rows, leaves)):
                    raise ValueError(f"{key}: shape {arr.shape} does not "
                                     f"fit the template")
                with torch.no_grad():
                    for r, t in zip(rows, leaves):
                        t.copy_(_to_torch(r, t))

        fill(params, "params")
        if opt_state is None:
            return params, None, step
        fill(opt_state.mu, f"opt{SEP}.mu")
        fill(opt_state.nu, f"opt{SEP}.nu")
        opt = AdamWState(int(blobs[f"opt{SEP}.step"]), opt_state.mu,
                         opt_state.nu)
    return params, opt, step
