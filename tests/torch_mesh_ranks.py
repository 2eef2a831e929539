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

