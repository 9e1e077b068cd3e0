"""``run_experiment(spec, key) -> Trace`` — the one entry point.

Port of ``src/repro/api/runner.py``.  Materializes the spec (problem →
node view → graph/weights → spectral init → η), runs the registered
solver on the spec's substrate, and returns a :class:`Trace` with the
per-iteration metrics, the final iterates, the resolved η and the
wall-clock axis: the comm model's closed form, or, when the spec
carries a :class:`~repro_torch.api.spec.SystemSpec`, the event-driven
simulated clock of :mod:`repro_torch.core.system_clock`
(:func:`system_time_axis`).  A SystemSpec's availability schedule
(seeded host numpy, made once per run) feeds the dropout-tolerant
solvers ``dif_partial`` / ``dif_stale`` / ``dif_pushsum``; a schedule
that drops nodes on any other solver raises.

Substrates:

  * ``"simulator"`` — the single-process node-batched simulator;
  * ``"mesh"`` — the ranks of an initialized ``torch.distributed``
    process group: every rank calls :func:`run_experiment` with the same
    spec and key, materializes the same problem and runs its share of
    the nodes.  With L ranks, one node a rank, the combine crossing the
    wire by ``ppermute`` (any weight scheme: circulant weights as shared
    scalars, any other W decomposed into per-shift, per-node weights);
    with D ranks, D dividing L, the virtual-node tier: rank g holds nodes
    g·V … g·V+V−1 (V = L / D), co-located edges mix on the device and
    each cross-rank edge class sends the whole block once a round
    (:class:`~repro_torch.distributed.consensus.VirtualTopology`).  The
    dropout-tolerant solvers mix under the spec's availability schedule,
    which every rank draws alike (host numpy from the spec's seed).
    Every rank returns the same :class:`Trace`.
    :func:`run_on_mesh` is the rank function that
    :func:`repro_torch.distributed.mesh.spawn` runs for a batch of
    specs.

Device: :func:`materialize` and :func:`run_experiment` run on ``cuda``
unless the caller passes ``device="cpu"``; with no card present and no
device asked for they raise RuntimeError, never carrying on on the CPU.

Determinism: ``key`` is an integer seed.  The problem and the init draw
from CPU ``torch.Generator``s seeded from (key, 0) and (key, 1), so two
specs sharing problem/topology/init sub-specs see identical data,
graphs and starting bases, on the CPU and on the card alike.  These are
not the JAX package's draws: :func:`materialized_from_arrays` carries
that package's materialized state across instead.  The availability
masks, node speeds and clock draws are host numpy from the spec's seeds,
the reference's own, so they are the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.api.registry import SolverDef, get_solver
from repro_torch.api.spec import ExperimentSpec, SystemSpec
from repro_torch.core import comm_model as _cm
from repro_torch.core import system_clock as _sysclock
from repro_torch.core.altgdmin import RunResult, resolve_eta
from repro_torch.core.engine import resolve_engine
from repro_torch.core.problem import (MTRLProblem, generate_problem,
                                      node_view, split_samples)
from repro_torch.core.spectral import SpectralInit, decentralized_spectral_init
from repro_torch.distributed import consensus as _consensus
from repro_torch.distributed.graphs import Graph, SparseGraph
from repro_torch.distributed import mesh as _mesh
from repro_torch.distributed.mesh import NodeMesh
from repro_torch.distributed.mixing import SparseWeights
from repro_torch.kernels import _build

_COMM_MODELS = {"ethernet-1gbps": _cm.ETHERNET_1GBPS,
                "tpu-ici": _cm.TPU_ICI}


@dataclasses.dataclass(frozen=True)
class Materialized:
    """The spec's set-up, executed: everything a solver call needs, its
    tensors on one device.  On the sparse tier ``W`` is a
    :class:`SparseWeights` and ``adj`` the :class:`SparseGraph` (host
    numpy; the mixers put their edge arrays on the device once)."""
    problem: MTRLProblem
    Xg: torch.Tensor
    yg: torch.Tensor
    graph: Graph | SparseGraph
    W: torch.Tensor | SparseWeights
    adj: torch.Tensor | SparseGraph
    init: SpectralInit
    eta: float


@dataclasses.dataclass(frozen=True)
class Trace:
    """Result of one experiment run.

    ``sd_max``/``sd_mean``/``spread`` are per-iteration numpy arrays
    (length T_GD); ``U_nodes`` (L, d, r) and ``B_nodes`` (L, tpn, r)
    stay tensors on the run's device; ``time_axis`` is the cumulative
    emulated wall-clock, ``time_axis_source`` says which: the comm
    model's ``"closed_form"`` or the system layer's ``"simulated"``
    clock; ``send_frac`` the event rule's measured per-iteration send
    rate (None for the other solvers)."""
    spec: ExperimentSpec
    U_nodes: torch.Tensor
    B_nodes: torch.Tensor
    sd_max: np.ndarray
    sd_mean: np.ndarray
    spread: np.ndarray
    eta: float
    time_axis: np.ndarray
    materialized: Materialized
    time_axis_source: str = "closed_form"
    send_frac: np.ndarray | None = None

    @property
    def final_sd_max(self) -> float:
        return float(self.sd_max[-1])


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card, and raises
    RuntimeError when there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch runs on the card "
            "unless the caller asks for the CPU with device='cpu'")
    return device


def _dtype(name) -> torch.dtype:
    dt = name if isinstance(name, torch.dtype) else getattr(torch, str(name),
                                                            None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"not a floating dtype: {name!r}")
    return dt


def _seed(key) -> int:
    if key is None:
        return 0
    if isinstance(key, (int, np.integer)):
        return int(key)
    raise TypeError(f"key must be an integer seed or None, got {key!r}")


def _generator(seed: int, stream: int) -> torch.Generator:
    """A CPU generator for sub-stream ``stream`` of ``seed``."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1,
                                                                  np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def materialize(spec: ExperimentSpec, key=None, *,
                device=None) -> Materialized:
    """Run the set-up for a spec: generate the problem, build the
    topology, run the spectral init, resolve η."""
    device = resolve_device(device)
    seed = _seed(key)
    p = spec.problem
    dtype = _dtype(p.dtype)
    prob = generate_problem(_generator(seed, 0), d=p.d, T=p.T, r=p.r,
                            n=p.n, L=p.L, kappa=p.kappa,
                            noise_std=p.noise_std, dtype=dtype,
                            device=device)
    # the init sees the full unsplit data (Algorithm 2 precedes the
    # fold partition of Algorithm 3 line 4)
    Xg_init, yg_init = node_view(prob)
    if p.n_folds > 1:
        prob = split_samples(prob, p.n_folds)
    Xg, yg = node_view(prob)
    graph = spec.topology.build_graph(p.L)
    if spec.topology.use_sparse(p.L, graph):
        # the sparse tier: W a SparseWeights, the adjacency the graph
        # itself; no (L, L) array anywhere
        graph = (graph if isinstance(graph, SparseGraph)
                 else graph.to_sparse())
        W = spec.topology.build_sparse_weights(p.L, graph)
        adj = graph
    else:
        W = torch.as_tensor(spec.topology.build_weights(p.L, graph),
                            dtype=dtype, device=device)
        # reprolint: allow=RL002 — dense branch: use_sparse() declined, L below the sparse tier
        adj = torch.as_tensor(graph.adj, dtype=dtype, device=device)
    init = decentralized_spectral_init(
        _generator(seed, 1), Xg_init, yg_init, W, kappa=prob.kappa,
        mu=prob.mu, r=p.r, T_pm=spec.init.T_pm, T_con=spec.init.T_con,
        broadcast=spec.init.broadcast)
    eta = _resolve_spec_eta(spec, init)
    return Materialized(problem=prob, Xg=Xg, yg=yg, graph=graph, W=W,
                        adj=adj, init=init, eta=eta)


def materialized_from_arrays(arrays: dict, *, device,
                             dtype) -> Materialized:
    """A :class:`Materialized` built from host arrays — the JAX
    package's materialized state carried across, in place of a weight
    converter (this problem has no model weights).

    ``arrays`` holds ``Xg`` (L, tpn, n, d) or (F, L, tpn, n, d), ``yg``,
    ``W`` (L, L), ``adj`` (L, L), ``U0`` (L, d, r), ``R_diag`` (L, r),
    ``alpha`` (L,), ``U_star`` (d, r), ``B_star`` (r, T), and the
    scalars ``eta``, ``mu``, ``sigma_max``, ``sigma_min``.  Tasks are
    assigned to nodes contiguously, as :func:`node_view` does.

    A sparse-tier state carries ``W_rows``, ``W_cols``, ``W_vals``,
    ``W_diag`` and ``n`` (the reference's ``SparseWeights`` fields) in
    place of ``W`` and ``adj``: W becomes a :class:`SparseWeights` and
    the adjacency the :class:`SparseGraph` of W's off-diagonal
    pattern."""
    device = torch.device(device)
    dtype = _dtype(dtype)

    def t(name):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                               device=device)

    Xg, yg = t("Xg"), t("yg")
    L, tpn, n, d = Xg.shape[-4:]
    T = L * tpn
    lead = tuple(Xg.shape[:-4])
    prob = MTRLProblem(
        X=Xg.reshape(lead + (T, n, d)), y=yg.reshape(lead + (T, n)),
        U_star=t("U_star"), B_star=t("B_star"),
        sigma_max=float(arrays["sigma_max"]),
        sigma_min=float(arrays["sigma_min"]), mu=float(arrays["mu"]),
        tasks_per_node=np.arange(T).reshape(L, tpn))
    if "W_rows" in arrays:
        W = SparseWeights(n=int(arrays["n"]), rows=arrays["W_rows"],
                          cols=arrays["W_cols"], vals=arrays["W_vals"],
                          diag=arrays["W_diag"])
        graph = adj = SparseGraph.from_edges(W.n, W.rows, W.cols)
    else:
        W, adj = t("W"), t("adj")
        graph = SparseGraph.from_dense(np.asarray(arrays["adj"])
                                       .astype(np.int8))
    return Materialized(
        problem=prob, Xg=Xg, yg=yg, graph=graph, W=W, adj=adj,
        init=SpectralInit(U0=t("U0"), R_diag=t("R_diag"), alpha=t("alpha")),
        eta=float(arrays["eta"]))


def _resolve_spec_eta(spec: ExperimentSpec, init) -> float:
    return resolve_eta(spec.solver.eta, spec.problem.n, R_diag=init.R_diag,
                       L=spec.problem.L, c_eta=spec.solver.c_eta)


def comm_time_axis(spec: ExperimentSpec, solver: SolverDef,
                   graph: Graph | SparseGraph) -> np.ndarray:
    """Cumulative emulated wall-clock per outer iteration, priced from
    the solver's combine-rule comm signature under the spec's network
    model (one message per neighbour per round: the dense d×r iterate,
    or the compressed rules' payload)."""
    p, c = spec.problem, spec.comm
    compute = c.compute_s_per_iter
    if "local_steps" in solver.spec_kwargs:
        # beyond_central pays its local epoch: the comm savings are not
        # free local work
        compute *= spec.solver.local_steps
    # payload context: compressed rules fill entries_per_round /
    # bytes_per_entry from these, the others ignore them
    sig = solver.signature(spec.solver.T_con, d=p.d, r=p.r,
                           compression=spec.solver.compression,
                           compression_k=spec.solver.compression_k,
                           event_threshold=spec.solver.event_threshold)
    return _cm.time_axis_from_signature(
        sig, spec.solver.T_GD, p.d, p.r,
        p.L, graph.max_degree, compute,
        model=_COMM_MODELS[c.model], rng=c.rng())


def _system_model(spec: ExperimentSpec) -> _cm.NetworkModel:
    """The comm model with the SystemSpec's link overrides applied."""
    model = _COMM_MODELS[spec.comm.model]
    s = spec.system
    if s is not None and (s.latency_s is not None
                          or s.jitter_std_s is not None):
        model = dataclasses.replace(
            model,
            latency_s=(model.latency_s if s.latency_s is None
                       else s.latency_s),
            jitter_std_s=(model.jitter_std_s if s.jitter_std_s is None
                          else s.jitter_std_s))
    return model


def system_time_axis(spec: ExperimentSpec, solver: SolverDef,
                     graph: Graph | SparseGraph,
                     avail: np.ndarray | None = None,
                     send_frac: np.ndarray | None = None) -> np.ndarray:
    """Simulated wall-clock axis under the spec's :class:`SystemSpec` —
    the event-driven clock of :mod:`repro_torch.core.system_clock`
    replacing the closed-form pricing.  ``avail`` reuses a mask the
    solver run already made (one fault schedule for trajectory AND
    time); ``send_frac`` feeds the event rule's measured per-iteration
    trigger rate into the wire pricing.  Non-gossip patterns (central /
    no communication) keep the closed-form axis under the overridden
    link model: the clock simulates neighbour gossip only."""
    p, c, s = spec.problem, spec.comm, spec.system
    T_GD = spec.solver.T_GD
    compute = c.compute_s_per_iter
    if "local_steps" in solver.spec_kwargs:
        compute *= spec.solver.local_steps
    sig = solver.signature(spec.solver.T_con, d=p.d, r=p.r,
                           compression=spec.solver.compression,
                           compression_k=spec.solver.compression_k,
                           event_threshold=spec.solver.event_threshold)
    model = _system_model(spec)
    if sig.pattern in ("central", "none") or sig.rounds_per_iter == 0:
        return _cm.time_axis_from_signature(
            sig, T_GD, p.d, p.r, p.L, graph.max_degree, compute,
            model=model, rng=c.rng())
    if avail is None:
        avail = (s.availability_mask(T_GD, p.L) if solver.takes_avail
                 else np.ones((T_GD, p.L), bool))
    entries = sig.entries_per_round
    return _sysclock.simulated_time_axis(
        avail=avail, rounds_per_iter=sig.rounds_per_iter,
        neighbors=graph.neighbor_lists(), model=model,
        compute_s_per_iter=compute, speeds=s.node_speeds(p.L),
        straggler_prob=s.straggler_prob,
        straggler_factor=s.straggler_factor,
        n_entries=p.d * p.r if entries is None else entries,
        bytes_per_entry=sig.bytes_per_entry,
        rng=np.random.default_rng([c.seed, s.seed]),
        send_fraction=send_frac)


def run_experiment(spec: ExperimentSpec, key=None, *, engine=None,
                   materialized: Materialized | None = None, device=None,
                   checkpoint_every: int | None = None,
                   checkpoint_dir: str | None = None) -> Trace:
    """Materialize ``spec`` and run it end to end.

    ``engine`` optionally injects a pre-built
    :class:`~repro_torch.core.engine.AltgdminEngine` (must agree with
    ``spec.engine.backend`` if both are given).  ``materialized`` reuses
    an earlier :func:`materialize` (or :func:`materialized_from_arrays`)
    result of a spec sharing this spec's problem/topology/init sub-specs
    and key; the run then takes place on its device.  With
    ``substrate="mesh"`` every rank of the process group calls this with
    the same spec and key (see the module docstring).

    ``checkpoint_every`` (with ``checkpoint_dir``) publishes U snapshots
    for the serving side: the spectral init at step 0, then the node
    bases every that-many outer iterations (and at T_GD), each a
    crash-safe checkpoint via
    :func:`repro_torch.serving.publisher.publish_representation`.  The
    run is executed in segments of that length with the U iterate
    chained through, so a server can hot-swap to fresher U's while the
    solver keeps refining.  Solvers whose loop carries just U
    (dif/dec/dgd/centralized, partial/pushsum) give the unsegmented
    run's trajectory bit for bit; solvers carrying auxiliary state
    (exact_diffusion's ψ, the compressed rules' public copies,
    stale_gossip's queue) restart that state at segment boundaries, as
    the reference does.  Simulator substrate only;
    incompatible with ``n_folds > 1`` (the fold schedule would restart
    per segment)."""
    solver = get_solver(spec.solver.name)
    # a non-default solver knob on a solver that ignores it must raise
    # instead of silently running without it
    for field, default in (("local_steps", 1), ("compression", None),
                           ("compression_k", 0), ("event_threshold", 0.0),
                           ("consensus_gamma", 1.0)):
        value = getattr(spec.solver, field)
        if value != default and field not in solver.spec_kwargs:
            raise ValueError(
                f"solver {solver.name!r} does not consume {field} "
                f"(got {field}={value}); only solvers declaring it in "
                f"spec_kwargs honor the field")
    # availability: the SystemSpec's fault schedule feeds the
    # dropout-tolerant solvers; a faulty schedule on a solver with no
    # notion of dropped nodes must raise, not silently run fault-free
    if (spec.system is not None and not spec.system.is_always_on
            and not solver.takes_avail):
        raise ValueError(
            f"spec.system schedules node dropout but solver "
            f"{solver.name!r} cannot consume an availability mask; use "
            f"one of the dropout-tolerant solvers (dif_partial / "
            f"dif_stale / dif_pushsum)")
    avail_np = None
    if solver.takes_avail:
        sys_spec = spec.system if spec.system is not None else SystemSpec()
        avail_np = sys_spec.availability_mask(spec.solver.T_GD,
                                              spec.problem.L)
    if checkpoint_every is not None:
        if checkpoint_dir is None:
            raise ValueError("checkpoint_every needs checkpoint_dir")
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got "
                             f"{checkpoint_every}")
        if spec.substrate == "mesh":
            raise ValueError("checkpoint publishing runs on "
                             "substrate='simulator' only")
        if spec.problem.n_folds > 1:
            raise ValueError("checkpoint_every segments the run, which "
                             "would restart the n_folds sample-split "
                             "schedule; use n_folds <= 1")
    if materialized is None:
        mat = materialize(spec, key, device=device)
    else:
        mat = materialized
        if (device is not None
                and torch.device(device).type != mat.Xg.device.type):
            raise ValueError(f"device={device!r} but the materialized "
                             f"state lives on {mat.Xg.device}")
    eta = _resolve_spec_eta(spec, mat.init)
    eng = resolve_engine(engine, spec.engine.backend, device=mat.Xg.device)
    if spec.substrate == "mesh":
        result = _run_mesh(spec, solver, mat, eng, eta, avail=avail_np)
    elif checkpoint_every is not None:
        result = _run_segmented(spec, solver, mat, eng, eta,
                                avail=avail_np, every=checkpoint_every,
                                directory=checkpoint_dir)
    else:
        extra = {k: getattr(spec.solver, k) for k in solver.spec_kwargs}
        if avail_np is not None:
            extra["avail"] = avail_np
        # reprolint: allow=RL002 — Materialized.adj field: a SparseGraph on the sparse tier, dense only below the use_sparse gate
        result = solver.call(mat.init.U0, mat.Xg, mat.yg, mat.W, mat.adj,
                             eta=eta, T_GD=spec.solver.T_GD,
                             T_con=spec.solver.T_con,
                             U_star=mat.problem.U_star, engine=eng, **extra)
    rows = [result.sd_max, result.sd_mean, result.spread]
    if result.send_frac is not None:
        rows.append(result.send_frac.to(result.sd_max.dtype))
    host = torch.stack(rows).cpu().numpy()            # the one host sync
    send_frac = (host[3].astype(np.float32)
                 if result.send_frac is not None else None)
    if spec.system is not None:
        time_axis = system_time_axis(spec, solver, mat.graph,
                                     avail=avail_np, send_frac=send_frac)
        source = "simulated"
    else:
        time_axis = comm_time_axis(spec, solver, mat.graph)
        source = "closed_form"
    return Trace(spec=spec, U_nodes=result.U_nodes, B_nodes=result.B_nodes,
                 sd_max=host[0], sd_mean=host[1], spread=host[2],
                 eta=result.eta, time_axis=time_axis, materialized=mat,
                 time_axis_source=source, send_frac=send_frac)


def _run_segmented(spec: ExperimentSpec, solver: SolverDef,
                   mat: Materialized, eng, eta: float, *,
                   avail: np.ndarray | None, every: int,
                   directory: str) -> RunResult:
    """The checkpoint-publishing run: the solver in segments of
    ``every`` iterations, chaining the U iterate and publishing a
    serving checkpoint after each segment (plus the step-0 init).  The
    availability schedule is sliced per segment, so the fault sequence
    matches the unsegmented run row for row."""
    from repro_torch.serving.publisher import publish_representation
    T_GD = spec.solver.T_GD
    extra = {k: getattr(spec.solver, k) for k in solver.spec_kwargs}
    publish_representation(directory, 0, mat.init.U0)
    U_cur = mat.init.U0
    chunks = []
    done = 0
    while done < T_GD:
        seg = min(every, T_GD - done)
        kw = dict(extra)
        if avail is not None:
            kw["avail"] = avail[done:done + seg]
        # reprolint: allow=RL002 — Materialized.adj field: a SparseGraph on the sparse tier, dense only below the use_sparse gate
        res = solver.call(U_cur, mat.Xg, mat.yg, mat.W, mat.adj, eta=eta,
                          T_GD=seg, T_con=spec.solver.T_con,
                          U_star=mat.problem.U_star, engine=eng, **kw)
        done += seg
        publish_representation(directory, done, res.U_nodes)
        chunks.append(res)
        U_cur = res.U_nodes

    def cat(name):
        return torch.cat([getattr(c, name) for c in chunks])

    sfs = [c.send_frac for c in chunks]
    return RunResult(chunks[-1].U_nodes, chunks[-1].B_nodes,
                     cat("sd_max"), cat("sd_mean"), cat("spread"), eta,
                     send_frac=(torch.cat(sfs)
                                if all(s is not None for s in sfs)
                                else None))


def _run_mesh(spec: ExperimentSpec, solver: SolverDef, mat: Materialized,
              eng, eta: float, avail: np.ndarray | None = None):
    """This rank's share of a mesh run, on the materialization's device:
    node ``rank`` of the default process group when it has L ranks, the
    rank's block of the virtual-node tier when its D ranks divide L.
    ``avail`` is the masked programs' seeded schedule, host numpy drawn
    from the spec, so every rank holds the same one."""
    topo, p = spec.topology, spec.problem
    if not solver.mesh_capable:
        raise ValueError(f"solver {solver.name!r} has no mesh runtime; "
                         f"use substrate='simulator'")
    if p.n_folds > 1:
        raise ValueError("substrate='mesh' does not support sample "
                         "splitting (n_folds > 1)")
    mesh = NodeMesh(mat.Xg.device)
    kw = {k: getattr(spec.solver, k) for k in solver.spec_kwargs}
    if avail is not None:
        kw.update(avail=avail)
    if p.L != mesh.size:
        if solver.virtual_mesh_fn is not None and p.L % mesh.size == 0:
            return _run_virtual_mesh(spec, solver, mat, eng, eta, mesh, kw)
        raise ValueError(
            f"substrate='mesh' needs one rank per node or a rank count that "
            f"divides L: L={p.L} but the process group has {mesh.size} "
            f"ranks (solver {solver.name!r}, combine rule "
            f"{solver.combine!r})")
    if topo.weights == "circulant":
        # mesh-native uniform weights: each shift one ppermute
        kw.update(shifts=topo.shifts, self_weight=topo.self_weight)
    elif solver.topology == "adj":
        # the solver averages neighbours (excluding itself): the same
        # row-stochastic adj/deg matrix the simulator builds
        # reprolint: allow=RL002 — one-node-per-rank mesh tier: L == rank count, far below the sparse tier
        kw.update(W=_consensus.neighbor_average_matrix(mat.adj))
    else:
        # any weighted topology: decomposed into per-shift, per-node
        # weights by the consensus layer
        kw.update(W=mat.W)
    return solver.mesh_fn(mat.init.U0, mat.Xg, mat.yg, mesh, eta=eta,
                          T_GD=spec.solver.T_GD, T_con=spec.solver.T_con,
                          engine=eng, U_star=mat.problem.U_star, **kw)


def _run_virtual_mesh(spec: ExperimentSpec, solver: SolverDef,
                      mat: Materialized, eng, eta: float, mesh: NodeMesh,
                      kw: dict) -> RunResult:
    """The virtual-node tier: L = D × V, a contiguous block of V nodes on
    each of the D ranks.  W is the one the simulator mixes with (for
    ``"adj"`` solvers the same row-stochastic neighbour average), a
    :class:`SparseWeights` as it comes on the sparse tier, else put in
    that form (``SparseWeights.from_dense``), and decomposed over the
    ranks, so the trajectories agree with the simulator's.  ``kw`` are
    the solver's spec knobs and availability schedule."""
    if solver.topology == "adj":
        # reprolint: allow=RL002 — Materialized.adj field: a SparseGraph on the sparse tier, dense only below the use_sparse gate
        W = _consensus.neighbor_average_matrix(mat.adj)
    else:
        W = mat.W
    if not isinstance(W, SparseWeights):
        W = SparseWeights.from_dense(W.cpu().numpy())
    vt = _consensus.VirtualTopology.from_weights(W, mesh.size)
    return solver.virtual_mesh_fn(
        mat.init.U0, mat.Xg, mat.yg, mesh, vt=vt, eta=eta,
        T_GD=spec.solver.T_GD, T_con=spec.solver.T_con, engine=eng,
        U_star=mat.problem.U_star, **kw)


def run_on_mesh(device, specs, key=0, arrays=None, dtype=None) -> list:
    """One rank's share of a batch of mesh runs — the function
    :func:`repro_torch.distributed.mesh.spawn` runs on every rank.

    Materializes once, on ``device``: from the seed ``key`` and the
    first spec, or from the host ``arrays`` of
    :func:`materialized_from_arrays` (in ``dtype``).  Then runs every
    spec (``ExperimentSpec.to_dict()`` dicts sharing the problem,
    topology and init sub-specs) on substrate ``"mesh"``, each with the
    kernel launch counts set to 0 just before and read just after, on
    whichever tier the group's size gives (one node a rank, or a block a
    rank when it divides L).  Returns, per spec, a dict of host values:
    the traces (``sd_max``,
    ``sd_mean``, ``spread``, ``time_axis``), ``U_nodes``, ``B_nodes``,
    ``launches`` (this rank's, by wrapper) and ``kernel_launches`` (by
    ``__global__`` function, as the C entries report them), ``seconds``
    (the run, ended by a device synchronize), ``setup_s`` (the rank's
    materialization, shared by the batch), ``transport``,
    ``transport_s`` (this rank's
    :data:`~repro_torch.distributed.mesh.TRANSPORT` seconds of the run)
    and ``sends`` (its point-to-point sends,
    :data:`~repro_torch.distributed.mesh.SENDS`)."""
    t_setup = time.perf_counter()
    specs = [ExperimentSpec.from_dict(s) for s in specs]
    if arrays is None:
        mat = materialize(specs[0], key, device=device)
    else:
        mat = materialized_from_arrays(arrays, device=device, dtype=dtype)
    transport = NodeMesh(mat.Xg.device).transport
    setup_s = time.perf_counter() - t_setup
    out = []
    for spec in specs:
        if spec.substrate != "mesh":
            raise ValueError(f"run_on_mesh runs substrate='mesh' specs, "
                             f"got {spec.substrate!r}")
        _build.LAUNCHES.clear()
        _build.KERNEL_LAUNCHES.clear()
        _mesh.TRANSPORT.clear()
        _mesh.SENDS.clear()
        t0 = time.perf_counter()
        trace = run_experiment(spec, key, materialized=mat)
        if mat.Xg.is_cuda:
            torch.cuda.synchronize(mat.Xg.device)
        seconds = time.perf_counter() - t0
        out.append({
            "sd_max": trace.sd_max, "sd_mean": trace.sd_mean,
            "spread": trace.spread, "time_axis": trace.time_axis,
            "U_nodes": trace.U_nodes.cpu().numpy(),
            "B_nodes": trace.B_nodes.cpu().numpy(),
            "launches": dict(_build.LAUNCHES),
            "kernel_launches": dict(_build.KERNEL_LAUNCHES),
            "seconds": seconds, "setup_s": setup_s, "transport": transport,
            "transport_s": dict(_mesh.TRANSPORT),
            "sends": _mesh.SENDS["p2p"]})
    return out
