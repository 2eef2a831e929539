"""Functions that ``tests/test_torch_multipod.py`` runs in the processes of
a ``repro_torch.core.mesh_procs.MeshProcs`` (``MeshProcs.run``).  They
import torch and the port only, so a spawned process loads them
quickly."""


def load_model(rank, cfg, params):
    """Give this process another model: ``params`` whole (shared) and its
    tensor-parallel view under the mesh's default rules."""
    from repro_torch.sharding.rules import tensor_parallel
    rank.cfg, rank.params = cfg, params
    rank.act_dtype = params["embedding"].dtype
    rank.tp_cfg, rank.tp_params, rank.rules = tensor_parallel(
        cfg, params, rank.mesh)


def comm_over(rank, axes_list):
    """For each tuple of mesh axes: ``Comm.all_reduce`` and
    ``Comm.all_gather`` over it of [rank, -rank] (float32), and the
    ``id`` of the process group ``Comm.group`` gives for it (None for the
    whole group)."""
    import torch
    x = torch.tensor([float(rank.rank), -float(rank.rank)])
    out = []
    for axes in axes_list:
        group = rank.comm.group(axes)
        out.append((rank.comm.all_reduce(x, axes),
                    rank.comm.all_gather(x, axes),
                    None if group is None else id(group)))
    return out
