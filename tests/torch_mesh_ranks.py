"""Functions that tests run in the processes of a
``repro_torch.core.mesh_procs.MeshProcs`` (``MeshProcs.run``).  They import
torch and the port only, so a spawned process loads them quickly."""
from repro_torch.models import moe as M
from repro_torch.sharding.rules import (P, current_rules, local_slice,
                                        use_mesh)


def moe_ep_rows(rank, layer, x, capacity_factor):
    """``moe_ep`` on this process's block of the tokens x [T, d] (T split
    over every process): its rows of y, the aux loss and the drop mask of
    its assignments."""
    mesh = rank.mesh
    moe = rank.cfg.layer_specs()[layer].moe
    with use_mesh(mesh):
        rows = local_slice(x, P(tuple(mesh.axis_names), None), mesh)
        y, aux = M.moe_ep(rank.params["layers"][layer]["ffn"], moe,
                          rows.to(rank.device), capacity_factor)
    return y.cpu(), float(aux), rank.comm.moe_calls[-1]["keep"]


def apply_moe_rows(rank, layer, x, moe, n_experts=None):
    """``apply_moe`` under the mesh on this process's rows of the batch x
    [B, S, d] (``moe`` may carry another capacity factor; with
    ``n_experts`` the layer keeps its first ``n_experts`` experts): its
    rows of y, the aux loss and how many ``moe_ep`` calls it made."""
    mesh = rank.mesh
    params = rank.params["layers"][layer]["ffn"]
    if n_experts is not None:
        params = dict(params, router=params["router"][:, :n_experts],
                      **{k: params[k][:n_experts]
                         for k in ("w_gate", "w_up", "w_down")})
    calls = len(rank.comm.moe_calls)
    with use_mesh(mesh):
        rows = current_rules().spec(("batch",))
        y, aux = M.apply_moe(params, rank.cfg, moe,
                             local_slice(x, rows, mesh).to(rank.device))
    return y.cpu(), float(aux), len(rank.comm.moe_calls) - calls



def tp_shapes(rank):
    """This process's tensor-parallel view: its config's head, K/V head and
    ff counts, and the shapes of its first layer's leaves and its
    vocabulary weights."""
    cfg, params = rank.tp_cfg, rank.tp_params
    layer = params["layers"][0]
    leaves = {f"{part}/{k}": tuple(v.shape)
              for part in ("mixer", "ffn", "norm1")
              for k, v in layer.get(part, {}).items()}
    leaves["embedding"] = tuple(params["embedding"].shape)
    return (cfg.n_heads, cfg.n_kv_heads, cfg.d_ff), leaves


def tp_sum_and_gather(rank, n):
    """Under this process's rules: ``model_sum`` over ``ff`` of bf16
    partials [n] drawn from its model coordinate, and ``model_gather``
    over ``vocab`` of a [2, 3] block holding its coordinate; the partials,
    the sum and the gathered tensor."""
    import torch
    from repro_torch.sharding.rules import model_gather, model_sum
    coord = rank.mesh.coords()["model"]
    gen = torch.Generator().manual_seed(coord)
    part = (torch.randn(n, generator=gen) * 10).to(torch.bfloat16)
    with use_mesh(rank.mesh, rank.rules):
        total = model_sum(part, "ff")
        block = torch.full((2, 3), float(coord))
        gathered = model_gather(block, "vocab")
    return part, total, gathered


def cache_kv_bytes(caches):
    """The bytes of the K/V tensors (rings or pools) of ``caches``."""
    return sum(t.numel() * t.element_size() for c in caches
               for k, t in c.items() if k in ("k", "v", "k_pool", "v_pool"))


def kv_bytes(rank):
    """The bytes of this process's K/V tensors."""
    return cache_kv_bytes(rank.backend.caches)


def shift_position(rank, slot):
    """Move one slot's host position on process 1 only: its state then
    disagrees with the others'."""
    if rank.rank == 1:
        rank.backend._pos[slot] += 1
