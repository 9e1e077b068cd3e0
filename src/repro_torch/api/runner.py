"""``run_experiment(spec, key) -> Trace`` — the one entry point.

Port of ``src/repro/api/runner.py`` for the simulator substrate.
Materializes the spec (problem → node view → graph/weights → spectral
init → η), runs the registered solver, and returns a :class:`Trace`
with the per-iteration metrics, the final iterates, the resolved η and
the comm-model wall-clock axis.

Device: :func:`materialize` and :func:`run_experiment` run on ``cuda``
unless the caller passes ``device="cpu"``; with no card present and no
device asked for they raise RuntimeError, never carrying on on the CPU.

Determinism: ``key`` is an integer seed.  The problem and the init draw
from CPU ``torch.Generator``s seeded from (key, 0) and (key, 1), so two
specs sharing problem/topology/init sub-specs see identical data,
graphs and starting bases, on the CPU and on the card alike.  These are
not the JAX package's draws: :func:`materialized_from_arrays` carries
that package's materialized state across instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.registry import SolverDef, get_solver
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core import comm_model as _cm
from repro_torch.core.altgdmin import resolve_eta
from repro_torch.core.engine import resolve_engine
from repro_torch.core.problem import (MTRLProblem, generate_problem,
                                      node_view, split_samples)
from repro_torch.core.spectral import SpectralInit, decentralized_spectral_init
from repro_torch.distributed.graphs import Graph, SparseGraph

_COMM_MODELS = {"ethernet-1gbps": _cm.ETHERNET_1GBPS,
                "tpu-ici": _cm.TPU_ICI}


@dataclasses.dataclass(frozen=True)
class Materialized:
    """The spec's set-up, executed: everything a solver call needs, its
    tensors on one device."""
    problem: MTRLProblem
    Xg: torch.Tensor
    yg: torch.Tensor
    graph: Graph | SparseGraph
    W: torch.Tensor
    adj: torch.Tensor
    init: SpectralInit
    eta: float


@dataclasses.dataclass(frozen=True)
class Trace:
    """Result of one experiment run.

    ``sd_max``/``sd_mean``/``spread`` are per-iteration numpy arrays
    (length T_GD); ``U_nodes`` (L, d, r) and ``B_nodes`` (L, tpn, r)
    stay tensors on the run's device; ``time_axis`` is the cumulative
    emulated wall-clock under the spec's comm model."""
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
        raise NotImplementedError(
            f"this topology takes the sparse representation (L={p.L}, "
            f"representation={spec.topology.representation!r}); the "
            f"sparse tier comes with a later slice of the port")
    W = torch.as_tensor(spec.topology.build_weights(p.L, graph), dtype=dtype,
                        device=device)
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
    assigned to nodes contiguously, as :func:`node_view` does."""
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
    adj_np = np.asarray(arrays["adj"])
    return Materialized(
        problem=prob, Xg=Xg, yg=yg,
        graph=SparseGraph.from_dense(adj_np.astype(np.int8)),
        W=t("W"), adj=t("adj"),
        init=SpectralInit(U0=t("U0"), R_diag=t("R_diag"), alpha=t("alpha")),
        eta=float(arrays["eta"]))


def _resolve_spec_eta(spec: ExperimentSpec, init) -> float:
    return resolve_eta(spec.solver.eta, spec.problem.n, R_diag=init.R_diag,
                       L=spec.problem.L, c_eta=spec.solver.c_eta)


def comm_time_axis(spec: ExperimentSpec, solver: SolverDef,
                   graph: Graph | SparseGraph) -> np.ndarray:
    """Cumulative emulated wall-clock per outer iteration, priced from
    the solver's combine-rule comm signature under the spec's network
    model (one d×r exchange per neighbour per round)."""
    p, c = spec.problem, spec.comm
    sig = solver.signature(spec.solver.T_con, d=p.d, r=p.r)
    return _cm.time_axis_from_signature(
        sig, spec.solver.T_GD, p.d, p.r,
        p.L, graph.max_degree, c.compute_s_per_iter,
        model=_COMM_MODELS[c.model], rng=c.rng())


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
    and key; the run then takes place on its device.  Checkpoint
    publishing is not ported yet and raises."""
    solver = get_solver(spec.solver.name)
    if spec.substrate != "simulator":
        raise NotImplementedError(
            f"substrate={spec.substrate!r} (the multi-device lowering over "
            f"torch.distributed) comes with a later slice of the port")
    if checkpoint_every is not None or checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpoint publishing comes with the serving slice of the port")
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
    result = solver.call(mat.init.U0, mat.Xg, mat.yg, mat.W, mat.adj,
                         eta=eta, T_GD=spec.solver.T_GD,
                         T_con=spec.solver.T_con,
                         U_star=mat.problem.U_star, engine=eng)
    sd = torch.stack([result.sd_max, result.sd_mean, result.spread])
    sd_max, sd_mean, spread = sd.cpu().numpy()       # the one host sync
    return Trace(spec=spec, U_nodes=result.U_nodes, B_nodes=result.B_nodes,
                 sd_max=sd_max, sd_mean=sd_mean, spread=spread,
                 eta=result.eta,
                 time_axis=comm_time_axis(spec, solver, mat.graph),
                 materialized=mat)
