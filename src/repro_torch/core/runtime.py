"""The mesh skeletons of the AltGDmin family.

Port of ``src/repro/core/runtime.py``.  There a skeleton is a
``shard_map`` body over a mesh axis of devices; here it is an SPMD
program that every rank of a
:class:`~repro_torch.distributed.mesh.NodeMesh` runs on its own share
of the nodes:

  * :func:`_altgdmin_mesh` — one node per rank: rank g holds node g's
    iterate U_g, data X_g and y_g, and per iteration solves its local
    least squares (one fused ``min_grad``), applies the program's update
    — whose combine crosses the wire by ``ppermute`` or ``psum`` — and
    retracts with a local QR;
  * :func:`_altgdmin_virtual_mesh` — the virtual-node tier, L = D × V:
    rank g holds the contiguous block of nodes g·V … g·V+V−1 and is a
    small simulator over it (the least squares node-batched over the
    block, the QR batched), the combine mixing co-located edges on the
    device and sending the whole block once a cross-rank edge class
    (:class:`~repro_torch.distributed.consensus.VirtualTopology`).

Only the iterate (or a rule's payload) crosses the wire; X_g, y_g and
B_g stay on the rank.  Neither skeleton knows a solver: the update
arrives as ``make_update(eng) -> update(U, aux, min_grad[, x_t])`` from
:func:`repro_torch.core.program.lower_mesh` /
:func:`~repro_torch.core.program.lower_virtual_mesh`.
"""
from __future__ import annotations

import torch

from repro_torch.core.altgdmin import RunResult
from repro_torch.core.engine import resolve_engine
from repro_torch.core.metrics import consensus_spread, subspace_distance


def _rank_loop(U, aux, update, mg, *, T_GD: int, xs, U_star, gather):
    """The T_GD iterations of one rank: ``update`` with the rank's
    ``min_grad``, and with ``U_star`` the SD₂ of the rank's node(s) and
    the consensus spread of every node, ``gather(U)`` (one
    ``all_gather``) giving the (L, d, r) iterates.  → (U, sd, spread),
    the traces as lists of the iterations' tensors."""
    sd, spread = [], []
    for tau in range(T_GD):
        if xs is None:
            U, aux = update(U, aux, mg)
        else:
            U, aux = update(U, aux, mg, xs[tau])
        if U_star is not None:
            sd.append(subspace_distance(U, U_star))
            spread.append(consensus_spread(gather(U)))
    return U, sd, spread


def _altgdmin_mesh(U0, Xg, yg, mesh, *, eta: float, T_GD: int, make_update,
                   engine=None, backend: str | None = None, U_star=None,
                   init_aux=None, xs=None) -> RunResult:
    """Run T_GD iterations on this rank's node; return the whole run's
    :class:`RunResult`, the same on every rank.

    U0 (L, d, r), Xg (L, tpn, n, d) and yg (L, tpn, n) are the stacked
    arrays; this rank keeps row ``mesh.axis_index()`` of each.
    ``make_update(eng) -> update(U, aux, min_grad)`` builds the
    per-iteration update from the resolved engine; ``min_grad(U) -> (B,
    G)`` is the node's fused min-B + gradient (one kernel launch per call
    on cuda); ``init_aux(U)`` seeds the auxiliary state (e.g. exact
    diffusion's ψ, the compressed rules' public copies) from the node's
    starting iterate.  ``xs`` (T_GD, ...), when given, holds a row per
    iteration on the node's device (the masked programs' availability
    schedule, the same on every rank); iteration τ then calls
    ``update(U, aux, min_grad, xs[τ])``.

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
    U, sd, spread = _rank_loop(U, aux, update, mg, T_GD=T_GD, xs=xs,
                               U_star=U_star, gather=mesh.all_gather)
    B = eng.minimize_B(U[None], X[None], y[None])[0]
    empty = torch.zeros(0, dtype=U.dtype, device=U.device)
    sd_nodes = (mesh.all_gather(torch.stack(sd)) if sd
                else torch.zeros((L, 0), dtype=U.dtype, device=U.device))
    return RunResult(U_nodes=mesh.all_gather(U), B_nodes=mesh.all_gather(B),
                     sd_max=torch.amax(sd_nodes, dim=0),
                     sd_mean=torch.mean(sd_nodes, dim=0),
                     spread=torch.stack(spread) if spread else empty,
                     eta=eta)


def _altgdmin_virtual_mesh(U0, Xg, yg, mesh, *, vt, eta: float, T_GD: int,
                           make_update, engine=None,
                           backend: str | None = None, U_star=None,
                           init_aux=None, xs=None) -> RunResult:
    """Run T_GD iterations on this rank's block of ``vt.block`` nodes;
    return the whole run's :class:`RunResult`, the same on every rank.

    The contract of :func:`_altgdmin_mesh`, with the rank's iterate the
    (V, d, r) slab of rows [g·V, (g+1)·V) of U0, Xg and yg, and
    ``min_grad`` node-batched over it (ONE fused launch a call on cuda,
    at L = V).  ``vt`` is the mixing matrix decomposed over the mesh's
    ranks (:meth:`VirtualTopology.from_weights`); its rank count must be
    the mesh's and its node count L.  Each iteration records the SD₂ of
    each node of the block and the spread, through one ``all_gather`` of
    the block; the final B is one min-B on the block.  Every rank returns
    U_nodes (L, d, r) and B_nodes (L, tpn, r) in node order and sd_max /
    sd_mean over all L nodes."""
    D, L, g = mesh.size, U0.shape[0], mesh.axis_index()
    if vt.n_dev != D or vt.n_nodes != L:
        raise ValueError(f"VirtualTopology is {vt.n_dev} ranks × "
                         f"{vt.block} nodes but the run has {D} ranks and "
                         f"L={L}")
    if Xg.shape[0] != L or Xg.ndim != 4:
        raise ValueError(f"need unsplit node data: Xg {tuple(Xg.shape)} "
                         f"for L={L}")
    V = vt.block
    rows = slice(g * V, (g + 1) * V)
    eng = resolve_engine(engine, backend, device=mesh.device)
    update = make_update(eng)
    U = U0[rows].to(mesh.device)
    X, y = Xg[rows].to(mesh.device), yg[rows].to(mesh.device)

    def mg(U_):
        return eng.min_grad(U_, X, y, X, y, same_data=True)

    def gather(U_):
        return mesh.all_gather(U_).flatten(0, 1)      # (L, d, r)

    aux = init_aux(U) if init_aux is not None else None
    U, sd, spread = _rank_loop(U, aux, update, mg, T_GD=T_GD, xs=xs,
                               U_star=U_star, gather=gather)
    B = eng.minimize_B(U, X, y)
    empty = torch.zeros(0, dtype=U.dtype, device=U.device)
    sd_nodes = (mesh.all_gather(torch.stack(sd))       # (D, T_GD, V)
                if sd else torch.zeros((D, 0, V), dtype=U.dtype,
                                       device=U.device))
    return RunResult(U_nodes=gather(U), B_nodes=gather(B),
                     sd_max=torch.amax(sd_nodes, dim=(0, 2)),
                     sd_mean=torch.mean(sd_nodes, dim=(0, 2)),
                     spread=torch.stack(spread) if spread else empty,
                     eta=eta)
