"""The one-node-per-rank mesh skeleton of the AltGDmin family.

Port of ``_altgdmin_mesh`` of ``src/repro/core/runtime.py``.  There the
skeleton is a ``shard_map`` body over a mesh axis of devices; here it is
an SPMD program that every rank of a
:class:`~repro_torch.distributed.mesh.NodeMesh` runs on its own node:
rank g holds node g's iterate U_g, data X_g and y_g, and per iteration
solves its local least squares (one fused ``min_grad``), applies the
program's update — whose combine crosses the wire by ``ppermute`` or
``psum`` — and retracts with a local QR.  Only the iterate crosses the
wire; X_g, y_g and B_g stay on the node.

The skeleton knows no solver: the update arrives as ``make_update(eng)
-> update(U, aux, min_grad)`` from
:func:`repro_torch.core.program.lower_mesh`.  The virtual-node tier
(``_altgdmin_virtual_mesh``) comes with a later slice of the port.
"""
from __future__ import annotations

import torch

from repro_torch.core.altgdmin import RunResult
from repro_torch.core.engine import resolve_engine
from repro_torch.core.metrics import consensus_spread, subspace_distance


def _altgdmin_mesh(U0, Xg, yg, mesh, *, eta: float, T_GD: int, make_update,
                   engine=None, backend: str | None = None, U_star=None,
                   init_aux=None) -> RunResult:
    """Run T_GD iterations on this rank's node; return the whole run's
    :class:`RunResult`, the same on every rank.

    U0 (L, d, r), Xg (L, tpn, n, d) and yg (L, tpn, n) are the stacked
    arrays; this rank keeps row ``mesh.axis_index()`` of each.
    ``make_update(eng) -> update(U, aux, min_grad)`` builds the
    per-iteration update from the resolved engine; ``min_grad(U) -> (B,
    G)`` is the node's fused min-B + gradient (one kernel launch per call
    on cuda); ``init_aux(U)`` seeds the auxiliary state (e.g. exact
    diffusion's ψ) from the node's starting iterate.

    With ``U_star`` the per-iteration metrics are kept: each node's
    SD₂(U_g, U*), and the consensus spread through one ``all_gather`` of
    the iterates per iteration.  At the end the nodes' traces, final
    iterates and final B (refit by one min-B launch on the node's data)
    are gathered, so every rank returns U_nodes (L, d, r), B_nodes
    (L, tpn, r) and sd_max / sd_mean over the nodes; without ``U_star``
    the traces are empty."""
    L, g = mesh.size, mesh.axis_index()
    if U0.shape[0] != L or Xg.shape[0] != L or Xg.ndim != 4:
        raise ValueError(f"need one node per rank and unsplit node data: "
                         f"U0 {tuple(U0.shape)}, Xg {tuple(Xg.shape)} on a "
                         f"mesh of {L}")
    eng = resolve_engine(engine, backend, device=mesh.device)
    update = make_update(eng)
    U = U0[g].to(mesh.device)
    X, y = Xg[g].to(mesh.device), yg[g].to(mesh.device)

    def mg(U_):
        B, G = eng.min_grad(U_[None], X[None], y[None], X[None], y[None],
                            same_data=True)
        return B[0], G[0]

    aux = init_aux(U) if init_aux is not None else None
    sd, spread = [], []
    for _ in range(T_GD):
        U, aux = update(U, aux, mg)
        if U_star is not None:
            sd.append(subspace_distance(U, U_star))
            spread.append(consensus_spread(mesh.all_gather(U)))
    B = eng.minimize_B(U[None], X[None], y[None])[0]
    empty = torch.zeros(0, dtype=U.dtype, device=U.device)
    sd_nodes = (mesh.all_gather(torch.stack(sd)) if sd
                else torch.zeros((L, 0), dtype=U.dtype, device=U.device))
    return RunResult(U_nodes=mesh.all_gather(U), B_nodes=mesh.all_gather(B),
                     sd_max=torch.amax(sd_nodes, dim=0),
                     sd_mean=torch.mean(sd_nodes, dim=0),
                     spread=torch.stack(spread) if spread else empty,
                     eta=eta)
