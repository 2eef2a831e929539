"""Mesh descriptions: the reference's ``(data, model)`` and multi-pod
``(pod, data, model)`` meshes as grids of processes.

Port of ``repro.launch.mesh``.  The reference's mesh is a grid of devices
that one SPMD program spans; the port's is a grid of processes
(:class:`repro_torch.core.mesh_procs.MeshProcs` spawns one per point), and
:class:`Mesh` only describes it: its axes, their sizes and, inside a mesh
process, that process's rank.  Ranks run over the grid row-major, as
``jax.make_mesh`` lays the devices out, so rank ``r``'s coordinates are
``numpy.unravel_index(r, sizes)``.  Nothing here spawns a process or
touches a device.

The card's datasheet figures stand where the reference keeps its TPU
target's (its ``PEAK_FLOPS_BF16``, ``HBM_BW``, ``ICI_BW``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

#: NVIDIA H100 SXM (datasheet, dense): bf16 tensor-core peak, FLOP/s
H100_SXM_PEAK_FLOPS_BF16 = 989e12
#: NVIDIA H100 SXM (datasheet): float32 peak outside the tensor cores
H100_SXM_PEAK_FLOPS_F32 = 67e12
#: NVIDIA H100 SXM (datasheet): HBM3 bandwidth, bytes/s
H100_SXM_HBM_BW = 3.35e12
#: NVIDIA H100 SXM (datasheet): NVLink 4 bandwidth a card, bytes/s (both
#: directions together)
H100_SXM_NVLINK_BW = 900e9


@dataclass(frozen=True)
class Mesh:
    """A grid of processes: ``axis_names`` with their ``sizes``, and inside
    a mesh process its ``rank`` (None in the host, which is no point of
    the grid) and ``comm``, the collectives over the grid's axes that
    :mod:`repro_torch.core.mesh_procs` gives the process."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: Optional[int] = None
    comm: Any = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) \
                or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} with sizes "
                             f"{self.sizes}")
        if any(n < 1 for n in self.sizes):
            raise ValueError(f"mesh sizes {self.sizes}")
        if self.rank is not None and not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in the mesh's order (the reference's
        ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis name -> coordinate of ``rank`` (this process's by
        default), row-major."""
        r = self.rank if rank is None else rank
        if r is None:
            raise ValueError("the host is no point of the mesh: pass a rank")
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            r, out[name] = divmod(r, n)
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, coords: Mapping[str, int]) -> int:
        """The rank at ``coords`` (every axis named)."""
        r = 0
        for name, n in zip(self.axis_names, self.sizes):
            r = r * n + coords[name]
        return r

    def at(self, rank: int, comm: Any = None) -> "Mesh":
        """This mesh as seen by the process of ``rank``."""
        return dataclasses.replace(self, rank=rank, comm=comm)

    def axis_tuples(self, least: int = 1) -> List[Tuple[str, ...]]:
        """Every tuple of ``least`` or more of the mesh's axes short of all
        of them, each in the mesh's order, the shorter tuples first: the
        axes a process group can span besides the whole group."""
        n = len(self.axis_names)
        return [axes for k in range(least, n)
                for axes in itertools.combinations(self.axis_names, k)]

    def blocks(self, axes: Tuple[str, ...]) -> List[List[int]]:
        """The ranks of each process group over ``axes`` (in the mesh's
        order): one list a point of the other axes, row-major, each list
        in the order of its coordinates over ``axes``, the first axis
        major -- which is ascending rank, since ranks run row-major."""
        rest = [a for a in self.axis_names if a not in axes]
        out = []
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in rest)):
            at = dict(zip(rest, fixed))
            out.append([self.rank_of(dict(at, **dict(zip(axes, c))))
                        for c in itertools.product(*(range(self.shape[a])
                                                     for a in axes))])
        return out


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, (16, 16) over ``(data, model)`` or
    (2, 16, 16) over ``(pod, data, model)``; described, not spawned."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_test_mesh(data: int = 2, model: int = 4) -> Mesh:
    """A small ``(data, model)`` mesh for tests and the smoke run."""
    return Mesh(("data", "model"), (data, model))


def n_chips(mesh: Mesh) -> int:
    return mesh.size
