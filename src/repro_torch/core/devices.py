"""Device / network description of a collaborative edge cluster.

Mirrors the paper's system model (§IV): M heterogeneous devices with memory
budgets ``Mem_j``, pairwise bandwidth ``B[k][j]``, and a designated *source
node* (node 0) holding the raw inputs (privacy constraint, Eq. 4).

Presets reproduce the paper's physical testbed (Table III) and provide a TPU
v5e pod description for the execution layer.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

MBPS = 1e6 / 8.0        # 1 Mbps in bytes/s
GBPS = 1e9 / 8.0        # 1 Gbps in bytes/s
GIB = 1024 ** 3


@dataclass(frozen=True)
class DeviceSpec:
    """One computing device (edge device or cloud server)."""

    name: str
    memory_bytes: float
    flops: float                   # peak FLOP/s at the serving dtype
    mem_bw: float                  # HBM/DRAM bandwidth, bytes/s
    kind: str = "edge"             # "edge" | "cloud" | "tpu"
    efficiency: float = 0.55       # fraction of peak achievable on transformer blocks

    @property
    def effective_flops(self) -> float:
        return self.flops * self.efficiency


# --------------------------------------------------------------------------- #
# Paper testbed, Table III
# --------------------------------------------------------------------------- #

def jetson_agx_orin() -> DeviceSpec:
    return DeviceSpec("jetson-agx-orin", 32 * GIB, 3.33e12, 204.8e9, "edge")


def jetson_orin_nx() -> DeviceSpec:
    return DeviceSpec("jetson-orin-nx", 16 * GIB, 1.88e12, 102.4e9, "edge")


def rtx_3090() -> DeviceSpec:
    return DeviceSpec("rtx-3090", 24 * GIB, 36.0e12, 936.0e9, "cloud")


def tpu_v5e() -> DeviceSpec:
    # target-hardware constants used throughout the roofline analysis
    return DeviceSpec("tpu-v5e", 16 * GIB, 197e12, 819e9, "tpu", efficiency=0.6)


@dataclass(frozen=True)
class ClusterSpec:
    """A set of devices + a full bandwidth matrix (bytes/s). Node 0 = source."""

    devices: Tuple[DeviceSpec, ...]
    bandwidth: np.ndarray          # [M, M] bytes/s; diagonal ignored
    source: int = 0

    def __post_init__(self):
        m = len(self.devices)
        assert self.bandwidth.shape == (m, m), "bandwidth matrix shape mismatch"

    @property
    def n(self) -> int:
        return len(self.devices)

    def mem(self, j: int) -> float:
        return self.devices[j].memory_bytes

    def type_signature(self) -> Tuple[Tuple[str, int], ...]:
        """(device-name, count) groups for symmetric-device DP collapsing."""
        sig = {}
        for d in self.devices:
            sig[d.name] = sig.get(d.name, 0) + 1
        return tuple(sorted(sig.items()))

    def with_source(self, idx: int) -> "ClusterSpec":
        """Reorder so that device ``idx`` becomes node 0 (the source)."""
        order = [idx] + [i for i in range(self.n) if i != idx]
        bw = self.bandwidth[np.ix_(order, order)]
        return ClusterSpec(tuple(self.devices[i] for i in order), bw, 0)


def uniform_bandwidth(m: int, bw: float) -> np.ndarray:
    b = np.full((m, m), bw, dtype=np.float64)
    np.fill_diagonal(b, np.inf)
    return b


def paper_testbed(cloud_bw: float = 1 * MBPS,
                  edge_bw: float = 50 * MBPS,
                  edge_bw_variance: float = 0.0,
                  source: str = "agx",
                  seed: int = 0) -> ClusterSpec:
    """The paper's 15-device testbed (§V-A).

    12x Jetson AGX Orin + 2x Orin NX + 1x RTX3090 cloud server; ``cloud_bw``
    is the source<->cloud link (swept 1..50 Mbps in Fig. 7/8), other links are
    50 Mbps with up to 20% variance.
    """
    if source == "agx":
        devices = [jetson_agx_orin()] + [jetson_agx_orin()] * 11 + \
                  [jetson_orin_nx()] * 2 + [rtx_3090()]
    elif source == "nx":
        devices = [jetson_orin_nx()] + [jetson_agx_orin()] * 12 + \
                  [jetson_orin_nx()] + [rtx_3090()]
    else:
        raise ValueError(f"unknown source {source!r}")
    m = len(devices)
    rng = np.random.default_rng(seed)
    bw = np.full((m, m), edge_bw)
    if edge_bw_variance:
        noise = 1.0 + edge_bw_variance * (2 * rng.random((m, m)) - 1)
        noise = (noise + noise.T) / 2
        bw *= noise
    cloud = m - 1  # RTX3090 is last
    bw[0, cloud] = bw[cloud, 0] = cloud_bw
    np.fill_diagonal(bw, np.inf)
    return ClusterSpec(tuple(devices), bw, source=0)


def tpu_pod_cluster(n_chips: int = 16, ici_bw: float = 50e9) -> ClusterSpec:
    """A (homogeneous) slice of a TPU pod, for planning stage assignments."""
    devices = tuple(tpu_v5e() for _ in range(n_chips))
    return ClusterSpec(devices, uniform_bandwidth(n_chips, ici_bw), source=0)
