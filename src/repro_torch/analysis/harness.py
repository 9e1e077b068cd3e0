"""Run harness: every registered program × every lowering, run and recorded.

Port of ``src/repro/analysis/harness.py``.  Torch has no trace to walk,
so where the reference ``jax.make_jaxpr``\\ s a lowering this harness RUNS
it, at the reference's tiny shape, and records what the run did:

  * **kernel launches** — :data:`repro_torch.kernels._build.LAUNCHES`,
    one a wrapper call.  On the CPU the run sits inside
    :func:`~repro_torch.kernels._build.recording`, where every wrapper
    runs its plain version in place of the launch and counts where the
    launch counts, so the ``cuda`` route's structure (``_fused_wanted``,
    the engine's fused phases) is the one taken and a CPU count is the
    card's.  On the card the real kernels launch;
  * **point-to-point sends** — rank 0's
    :data:`repro_torch.distributed.mesh.SENDS` ``["p2p"]``;
  * **ops** — every aten op's output shapes and dtypes, seen by a
    :class:`OpRecorder` (a ``TorchDispatchMode``, installed in each rank
    too), each with the source location of the port's code that issued
    it (:func:`op_location`).

Counts are per outer iteration by differencing two run lengths
(:data:`RUN_LENGTHS`): the difference of the counts is the count an
iteration, and what the shorter run has beyond that many iterations is
the count outside the loop.  Nothing depends on finding a loop.

Shape choices (the reference's, ``harness.py:11-24`` there):

  * simulator and mesh at L = 8 (one node a rank, 8 gloo ranks); the
    virtual tier at L = 24 on 8 ranks (block 3), so L, the rank count
    and the block are distinct and a dim equal to L is unambiguous;
  * d = 16, r = 2, tpn = 3, n = 12 — no dim collides with L;
  * T_con = 2, local_steps = 2, the same ER graphs and ``SPEC_KW``.

The mesh and virtual cases of a run go to ONE
:func:`repro_torch.distributed.mesh.spawn` of 8 gloo ranks, which runs
every case (:func:`spawn_cases`); the ranks fork from a forkserver
that imported torch once (:func:`warm_ranks`).  The sparse-tier cases
run the simulator at L = :data:`L_SPARSE` on a Barabási–Albert graph
(m = 3), just above the sparse tier's ``SPARSE_MIN_NODES``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import sys
import time

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

# Run-time constants — see module docstring for why each value.
D, R, TPN, N = 16, 2, 3, 12
RUN_LENGTHS = (3, 4)      # two T_GD values: their difference is one iteration
T_CON, LOCAL_STEPS = 2, 2
L_SIM = 8                 # simulator + mesh node count (== rank count)
L_VIRT = 24               # virtual tier: 8 ranks × block 3
N_DEV = 8
L_SPARSE = 520            # sparse tier: just above SPARSE_MIN_NODES = 512
BA_M = 3
SPAWN_TIMEOUT = 300.0
# spawn_cases' ranks fork from one forkserver that imported these once,
# where eight fresh interpreters would each import torch at once on the
# host's few cores (most of a spawn's start on the card's host).  torch
# comes first: the server skips, silently, a module it cannot import,
# and a server whose Python does not take the caller's sys.path (the
# card's host) cannot import the port's (the ranks then do, a small part
# of the cost)
_RANK_PRELOAD = ("torch", "torch.distributed", "numpy",
                 "repro_torch.analysis.harness", "repro_torch.core.program",
                 "repro_torch.distributed.consensus",
                 "repro_torch.distributed.mesh")

SUBSTRATES = ("simulator", "mesh", "virtual")
# the three, and the sparse tier's simulator at L_SPARSE (JX002 only)
ALL_SUBSTRATES = SUBSTRATES + ("sparse",)

# The non-default spec knobs per program (the reference's SPEC_KW: the
# compressed and local-epoch paths the defaults skip).
SPEC_KW = {
    "beyond_central": dict(local_steps=LOCAL_STEPS),
    "dif_topk": dict(compression_k=3),
    "dif_quantized": dict(compression="int8_stochastic"),
    "dif_event": dict(event_threshold=0.05),
}

_MARKER = "/src/repro_torch/"
_EXCLUDED = ("src/repro_torch/analysis/",)
_NARROW = (torch.float32, torch.bfloat16, torch.float16)


# ----------------------------------------------------------------------
# op recording
# ----------------------------------------------------------------------

def op_location(frame=None) -> tuple[str, str, int]:
    """(repo-relative path, function, line) of the innermost stack frame
    in the port's sources (``src/repro_torch/``) outside ``analysis/``,
    from ``frame`` outwards (default: the caller's), or ('', '', 0)."""
    f = frame if frame is not None else sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        if _MARKER in name:
            rel = "src/repro_torch/" + name.split(_MARKER, 1)[1]
            if not rel.startswith(_EXCLUDED):
                return rel, f.f_code.co_name, f.f_lineno
        f = f.f_back
    return "", "", 0


@dataclasses.dataclass(frozen=True)
class Op:
    """One recorded op that a run rule looks at: the aten op, where the
    port issued it, the output shape that drew the recorder's eye and
    the dtypes involved."""
    op: str
    path: str
    func: str
    line: int
    shape: tuple
    dtypes: str          # "in->out", e.g. "float64->float32"


def _n_dims_equal(shape, L: int) -> int:
    return sum(1 for dim in shape if dim == L)


class OpRecorder(TorchDispatchMode):
    """Sees every aten op of the ``with`` body and keeps two kinds, once
    per (location, op):

      * ``births`` — an output with two dims equal to ``L`` while no
        tensor input has two (an (L, L) buffer born here; pass-throughs
        of an existing (L, L) operand are not births);
      * ``narrowings`` — a float64 tensor input and a float32 / bfloat16
        / float16 output.

    ``n_ops`` counts every op seen."""

    def __init__(self, L: int):
        super().__init__()
        self.L = L
        self.births: dict = {}
        self.narrowings: dict = {}
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.n_ops += 1
        ins = [t for t in _pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in _pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        born = [t for t in outs if _n_dims_equal(t.shape, self.L) >= 2]
        if born and not any(_n_dims_equal(t.shape, self.L) >= 2
                            for t in ins):
            self._keep(self.births, func, tuple(born[0].shape),
                       f"{ins[0].dtype if ins else ''}->{born[0].dtype}")
        if any(t.dtype == torch.float64 for t in ins):
            narrow = [t for t in outs if t.dtype in _NARROW]
            if narrow:
                self._keep(self.narrowings, func, tuple(narrow[0].shape),
                           f"float64->{str(narrow[0].dtype)[6:]}")
        return out

    def _keep(self, table, func, shape, dtypes):
        path, fn, line = op_location(sys._getframe(2))
        key = (path, fn, line, str(func))
        if key not in table:
            table[key] = Op(op=str(func), path=path, func=fn, line=line,
                            shape=shape, dtypes=dtypes)


# ----------------------------------------------------------------------
# cases
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Case:
    """One (program, substrate, dtype, device) run pair and what the
    budgets are priced against.  ``launches`` / ``sends`` are (per outer
    iteration, outside the loop), None where the case ran one length
    only; ``launches_by_kernel`` is per iteration, by wrapper.  ``births``
    and ``narrowings`` are the :class:`OpRecorder`'s, of every rank;
    ``seconds`` the host seconds of the runs (on the card ended by a
    synchronize), from ``started``, the host's wall clock."""
    program: str
    substrate: str            # simulator | mesh | virtual | sparse
    dtype: str
    device: str
    L: int
    rounds: int               # R — CommSignature.rounds_per_iter at T_con
    n_shifts: int             # K — shift classes (0 on the simulator)
    local_steps: int
    launches: tuple | None
    sends: tuple | None
    launches_by_kernel: dict
    births: tuple = ()
    narrowings: tuple = ()
    seconds: float = 0.0
    started: float = 0.0


def resolve_program(ref):
    """A :class:`~repro_torch.core.program.SolverProgram` from a
    registered name, a ``"module:attr"`` reference (what a spawned rank
    can import: a program that is not registered) or the object."""
    from repro_torch.core.program import SolverProgram, get_program
    if isinstance(ref, SolverProgram):
        return ref
    if ":" in ref:
        module, attr = ref.split(":", 1)
        return getattr(importlib.import_module(module), attr)
    return get_program(ref)


def _orthonormal(rng, shape):
    return np.linalg.qr(rng.standard_normal(shape))[0]


@functools.lru_cache(maxsize=8)
def _host_setup(L: int):
    """Host arrays for node count L (float64; the run casts): the
    reference's draws, the ER graphs of its harness, Metropolis W and
    the neighbour average."""
    from repro_torch.distributed import graphs, mixing
    from repro_torch.distributed.consensus import neighbor_average_matrix

    rng = np.random.default_rng(7)
    g = (graphs.erdos_renyi(L, 0.6, seed=2) if L == L_SIM
         else graphs.erdos_renyi(L, 0.4, seed=3))
    # reprolint: allow=RL002 — the harness's toy graphs, L <= L_VIRT = 24
    adj = np.asarray(g.adj, dtype=np.float64)
    W = np.asarray(mixing.metropolis_weights(g), dtype=np.float64)
    Madj = neighbor_average_matrix(torch.as_tensor(adj)).numpy()
    U0 = _orthonormal(rng, (L, D, R))
    Xg = rng.standard_normal((L, TPN, N, D))
    yg = rng.standard_normal((L, TPN, N))
    avail = rng.random((max(RUN_LENGTHS), L)) > 0.3
    return dict(adj=adj, W=W, Madj=Madj, U0=U0, Xg=Xg, yg=yg, avail=avail)


@functools.lru_cache(maxsize=2)
def _sparse_setup():
    """The sparse tier's inputs at L_SPARSE: a BA graph (m = 3), its
    Metropolis :class:`SparseWeights`, and draws as for the dense
    setups.  No (L, L) array is made."""
    from repro_torch.distributed import graphs, mixing

    rng = np.random.default_rng(7)
    g = graphs.barabasi_albert(L_SPARSE, BA_M, seed=3)
    return dict(graph=g, W=mixing.metropolis_weights_sparse(g),
                U0=_orthonormal(rng, (L_SPARSE, D, R)),
                Xg=rng.standard_normal((L_SPARSE, TPN, N, D)),
                yg=rng.standard_normal((L_SPARSE, TPN, N)),
                avail=rng.random((max(RUN_LENGTHS), L_SPARSE)) > 0.3)


def _tensors(pb, dtype, device):
    def t(name):        # a copy: the cached host arrays stay as drawn
        return torch.tensor(pb[name], dtype=dtype, device=device)
    return t("U0"), t("Xg"), t("yg")


def _rounds(program) -> int:
    from repro_torch.distributed.consensus import get_rule
    return int(get_rule(program.combine).signature(T_CON).rounds_per_iter)


def _runner(program, substrate: str, dtype, device, mesh=None):
    """``(run(T_GD), L, K)`` for one lowering of ``program``."""
    from repro_torch.core.program import (lower_mesh, lower_simulator,
                                          lower_virtual_mesh)
    from repro_torch.distributed.consensus import (VirtualTopology,
                                                   mesh_weights_from_matrix)
    from repro_torch.distributed.mixing import SparseWeights

    spec_kw = SPEC_KW.get(program.name, {})
    if substrate == "sparse":
        pb = _sparse_setup()
        topo = pb["graph"] if program.topology == "adj" else pb["W"]
    else:
        pb = _host_setup(L_VIRT if substrate == "virtual" else L_SIM)
    U0, Xg, yg = _tensors(pb, dtype, device)
    L = U0.shape[0]

    def kw(T):
        out = dict(eta=0.01, T_GD=T, U_star=U0[0], backend="cuda", **spec_kw)
        if program.takes_avail:
            out["avail"] = pb["avail"][:T]
        return out

    if substrate in ("simulator", "sparse"):
        run = lower_simulator(program)
        if substrate == "simulator":
            topo = torch.tensor(
                pb["adj"] if program.topology == "adj" else pb["W"],
                dtype=dtype, device=device)
        if program.topology == "none":
            return (lambda T: run(U0[0], Xg, yg, **kw(T))), L, 0
        if program.topology == "adj":
            return (lambda T: run(U0, Xg, yg, topo, **kw(T))), L, 0
        return (lambda T: run(U0, Xg, yg, topo, T_con=T_CON, **kw(T))), L, 0
    # as run_on_mesh passes it: a tensor in the run's dtype
    W = torch.tensor(pb["Madj"] if program.topology == "adj" else pb["W"],
                     dtype=dtype, device=device)
    if substrate == "mesh":
        run = lower_mesh(program)
        K = len(mesh_weights_from_matrix(W)[0])
        return (lambda T: run(U0, Xg, yg, mesh, T_con=T_CON, W=W,
                              **kw(T))), L, K
    if substrate == "virtual":
        run = lower_virtual_mesh(program)
        vt = VirtualTopology.from_weights(
            SparseWeights.from_dense(W.cpu().numpy()), N_DEV)
        return (lambda T: run(U0, Xg, yg, mesh, vt=vt, T_con=T_CON,
                              **kw(T))), L, len(vt.dev_shifts)
    raise ValueError(f"unknown substrate {substrate!r}; expected one of "
                     f"{ALL_SUBSTRATES}")


def _per_iter(totals: list, lengths) -> tuple:
    """(per iteration, outside the loop) from the totals of the runs of
    ``lengths`` iterations (the first two)."""
    per = (totals[1] - totals[0]) // (lengths[1] - lengths[0])
    return per, totals[0] - lengths[0] * per


def run_case(program, substrate: str, dtype: str = "float32", *,
             device: str = "cpu", mesh=None, lengths=RUN_LENGTHS,
             record_ops: bool | None = None) -> Case:
    """Run one lowering of ``program`` at each of ``lengths`` iterations
    and return its :class:`Case`.  On the CPU the runs sit inside
    ``_build.recording()`` (the ``cuda`` route, plain versions in place
    of launches); on a CUDA ``device`` the real kernels launch.
    ``record_ops`` (default: on the CPU) installs an :class:`OpRecorder`
    for the first run.  The mesh and virtual substrates need ``mesh``, a
    :class:`~repro_torch.distributed.mesh.NodeMesh` of :data:`N_DEV`
    ranks (this function then runs on every rank)."""
    from repro_torch.distributed import mesh as mesh_mod
    from repro_torch.kernels import _build

    program = resolve_program(program)
    torch_dtype = getattr(torch, dtype)
    run, L, K = _runner(program, substrate, torch_dtype, device, mesh)
    on_cpu = torch.device(device).type == "cpu"
    record_ops = on_cpu if record_ops is None else record_ops
    recorder = OpRecorder(L) if record_ops else None
    launches, sends, by_kernel = [], [], []
    started, t0 = time.time(), time.perf_counter()
    for i, T in enumerate(lengths):
        _build.LAUNCHES.clear()
        mesh_mod.SENDS.clear()
        with contextlib.ExitStack() as stack:
            if on_cpu:
                stack.enter_context(_build.recording())
            if recorder is not None and i == 0:
                stack.enter_context(recorder)
            run(T)
        if not on_cpu:
            torch.cuda.synchronize(device)
        launches.append(sum(_build.LAUNCHES.values()))
        by_kernel.append(dict(_build.LAUNCHES))
        sends.append(mesh_mod.SENDS["p2p"])
    two = len(lengths) >= 2
    per_kernel = {}
    if two:
        for name in set(by_kernel[0]) | set(by_kernel[1]):
            per_kernel[name] = _per_iter(
                [by_kernel[0].get(name, 0), by_kernel[1].get(name, 0)],
                lengths)[0]
    return Case(
        program=program.name, substrate=substrate, dtype=dtype,
        device=str(device), L=L, rounds=_rounds(program), n_shifts=K,
        local_steps=int(SPEC_KW.get(program.name, {}).get("local_steps", 1)),
        launches=_per_iter(launches, lengths) if two else None,
        sends=_per_iter(sends, lengths) if two else None,
        launches_by_kernel=per_kernel,
        births=tuple(recorder.births.values()) if recorder else (),
        narrowings=tuple(recorder.narrowings.values()) if recorder else (),
        seconds=time.perf_counter() - t0, started=started)


def _lengths(dtype: str, lengths=RUN_LENGTHS):
    """Counts come from the f32 runs; an f64 case is one run, for its
    ops (the precision rule)."""
    return lengths if dtype == "float32" else lengths[:1]


def rank_cases(specs, lengths=RUN_LENGTHS, record_ops=None) -> list:
    """A spawned rank's share of :func:`spawn_cases`: every spec
    ``(program, substrate, dtype, device)`` of the mesh or virtual
    substrate, in order, on this rank.  Returns the rank's
    :class:`Case` list."""
    from repro_torch.distributed.mesh import NodeMesh

    meshes: dict = {}
    out = []
    for program, substrate, dtype, device in specs:
        mesh = meshes.get(device)
        if mesh is None:
            mesh = meshes[device] = NodeMesh(device)
        out.append(run_case(program, substrate, dtype, device=device,
                            mesh=mesh, lengths=_lengths(dtype, lengths),
                            record_ops=record_ops))
    return out


def warm_ranks() -> None:
    """Start the forkserver that :func:`spawn_cases`' ranks fork from,
    with torch and the port's modules preloaded (none touches the card),
    and return at once: its imports overlap the caller's work.  Once
    started, a later call changes nothing."""
    from repro_torch.distributed.mesh import warm_forkserver
    warm_forkserver(_RANK_PRELOAD)


def spawn_cases(specs, *, device: str = "cpu", lengths=RUN_LENGTHS,
                timeout: float = SPAWN_TIMEOUT,
                record_ops: bool | None = None) -> list[Case]:
    """Run every mesh / virtual spec in ONE spawn of :data:`N_DEV` gloo
    ranks (``device`` the ranks' device: ``"cuda"`` puts every rank on
    the card), each f32 case at ``lengths``; ``record_ops`` as for
    :func:`run_case` (False: counts only).  Each returned
    :class:`Case` has rank 0's counts and the births and narrowings of
    every rank."""
    from repro_torch.distributed.mesh import spawn

    specs = [tuple(s) for s in specs]
    if not specs:
        return []
    warm_ranks()
    ranks = spawn(rank_cases, N_DEV,
                  args=(specs, tuple(lengths), record_ops),
                  backend="gloo", device=device, timeout=timeout,
                  start_method="forkserver")
    merged = []
    for i, case in enumerate(ranks[0]):
        births = {(o.path, o.func, o.line, o.op): o
                  for r in ranks for o in r[i].births}
        narrowings = {(o.path, o.func, o.line, o.op): o
                      for r in ranks for o in r[i].narrowings}
        merged.append(dataclasses.replace(
            case, births=tuple(births.values()),
            narrowings=tuple(narrowings.values())))
    return merged


def run_cases(programs, substrates=ALL_SUBSTRATES, *,
              dtypes=("float32", "float64"), device: str = "cpu",
              timeout: float = SPAWN_TIMEOUT) -> list[Case]:
    """Every (program, substrate, dtype) case: the simulator in this
    process, the mesh and virtual substrates in one spawn, and the
    sparse tier (one f32 run, for its ops) in this process."""
    cases, remote = [], []
    for name in programs:
        for substrate in substrates:
            if substrate == "sparse":
                cases.append(run_case(name, "sparse", "float32",
                                      device=device,
                                      lengths=RUN_LENGTHS[:1]))
                continue
            for dtype in dtypes:
                if substrate == "simulator":
                    cases.append(run_case(name, substrate, dtype,
                                          device=device,
                                          lengths=_lengths(dtype)))
                else:
                    remote.append((name, substrate, dtype, device))
    return cases + spawn_cases(remote, device=device, timeout=timeout)
