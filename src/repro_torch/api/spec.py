"""Declarative experiment specs — the single description of a Dec-MTRL run.

Port of ``src/repro/api/spec.py``, field for field, so a spec
round-trips between the two packages through ``to_dict`` / ``from_dict``
(or JSON).  An :class:`ExperimentSpec` is one nested frozen dataclass of
plain int/float/str/tuple fields, hashable, diffable and exactly
round-trippable.

The sub-specs mirror the run's stages:

  * :class:`ProblemSpec`  — the synthetic Dec-MTRL instance (paper Sec. II);
  * :class:`TopologySpec` — graph family + mixing-weight scheme (Sec. III);
  * :class:`InitSpec`     — Algorithm 2's spectral initialization;
  * :class:`SolverSpec`   — which algorithm, η (None = Theorem-1 auto),
                            T_GD and the solver's own T_con;
  * :class:`EngineSpec`   — backend for the iteration engine;
  * :class:`CommSpec`     — the emulated wall-clock axis.

plus :class:`SystemSpec`, the fault-injection and simulated-clock
layer.  ``substrate="mesh"`` runs every solver on the ranks of a
``torch.distributed`` process group (:mod:`repro_torch.api.runner`):
one node a rank when there are L ranks, a block of L / D nodes a rank
(the virtual-node tier) when the D ranks divide L; any other rank count
raises ValueError.  ``TopologySpec.representation`` picks the dense
(L, L) mixing matrix or the sparse tier's :class:`SparseWeights`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import numpy as np

from repro_torch.distributed import graphs as _graphs
from repro_torch.distributed import mixing as _mixing


GRAPH_FAMILIES = ("erdos_renyi", "ring", "path", "torus2d", "hypercube",
                  "complete", "star", "circulant", "barabasi_albert",
                  "hierarchical", "cluster_cliques")
WEIGHT_SCHEMES = ("metropolis", "equal_neighbor", "lazy", "circulant")
REPRESENTATIONS = ("auto", "dense", "sparse")
SUBSTRATES = ("simulator", "mesh")
COMM_MODELS = ("ethernet-1gbps", "tpu-ici")
AVAILABILITY_KINDS = ("always", "bernoulli", "markov")


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """The synthetic multi-task linear-regression instance (paper Sec. II)."""
    d: int = 100            # feature dimension
    T: int = 64             # tasks (L must divide T)
    r: int = 4              # subspace rank
    n: int = 30             # samples per task
    L: int = 8              # nodes
    kappa: float = 1.0      # condition number of Σ*
    noise_std: float = 0.0
    dtype: str = "float64"
    n_folds: int = 0        # >1 → Algorithm 3 sample splitting

    def __post_init__(self):
        if self.T % self.L:
            raise ValueError(f"L must divide T, got T={self.T}, L={self.L}")


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Graph family + mixing-weight scheme.

    ``family`` fields are union-style: ``p``/``seed`` apply to
    ``erdos_renyi``, ``rows``/``cols`` to ``torus2d``, ``dim`` to
    ``hypercube``; the rest need only L (taken from the problem).
    ``weights="circulant"`` is the mesh-native scheme (each shift = one
    collective-permute, uniform weights shared by every device); the
    other schemes run on the mesh too — the consensus layer decomposes
    their W into per-shift, per-device weights (one permute per distinct
    cyclic shift of the sparsity pattern).

    The scale families: ``barabasi_albert`` (``ba_m`` attachments per
    new node), ``hierarchical`` (``branching``-ary tree), and
    ``cluster_cliques`` (pods of ``clique`` nodes on a bridge ring) are
    sparse-born — no (L, L) allocation at any size.  ``representation``
    picks the mixing-matrix lowering: ``"auto"`` (default) takes the
    sparse path above the consensus layer's node-count/density cutoff,
    ``"sparse"``/``"dense"`` force it (the parity tests force both on
    the same small graph).
    """
    family: str = "erdos_renyi"
    p: float = 0.5
    seed: int = 0
    rows: int = 0
    cols: int = 0
    dim: int = 0
    ba_m: int = 2                          # barabasi_albert attachments
    branching: int = 4                     # hierarchical tree arity
    clique: int = 8                        # cluster_cliques pod size
    weights: str = "metropolis"
    beta: float = 0.5                      # lazy weights
    shifts: tuple = (-1, 1)                # circulant weights
    self_weight: Optional[float] = None    # circulant weights
    representation: str = "auto"

    def __post_init__(self):
        if self.family not in GRAPH_FAMILIES:
            raise ValueError(f"unknown graph family {self.family!r}; "
                             f"expected one of {GRAPH_FAMILIES}")
        if self.weights not in WEIGHT_SCHEMES:
            raise ValueError(f"unknown weight scheme {self.weights!r}; "
                             f"expected one of {WEIGHT_SCHEMES}")
        if self.representation not in REPRESENTATIONS:
            raise ValueError(f"unknown representation "
                             f"{self.representation!r}; expected one of "
                             f"{REPRESENTATIONS}")
        # JSON round-trips tuples as lists; normalize back.
        object.__setattr__(self, "shifts", tuple(self.shifts))
        # Circulant weights gossip over the circulant graph of `shifts`;
        # reject family/weights combinations that would make the stored
        # graph and the mixing matrix describe different topologies.
        if self.weights == "circulant":
            if self.family == "ring" and set(self.shifts) != {-1, 1}:
                raise ValueError(
                    f"family='ring' is the circulant graph of shifts "
                    f"(-1, 1); got shifts={self.shifts} — use "
                    f"family='circulant'")
            if self.family not in ("ring", "circulant"):
                raise ValueError(
                    f"weights='circulant' mixes over the circulant graph "
                    f"of its shifts; family={self.family!r} would "
                    f"disagree — use family='ring' or 'circulant'")

    def build_graph(self, L: int) -> _graphs.Graph:
        if self.family == "erdos_renyi":
            return _graphs.erdos_renyi(L, self.p, seed=self.seed)
        if self.family == "ring":
            return _graphs.ring(L)
        if self.family == "path":
            return _graphs.path_graph(L)
        if self.family == "torus2d":
            if self.rows * self.cols != L:
                raise ValueError(f"torus2d rows*cols={self.rows * self.cols} "
                                 f"!= L={L}")
            return _graphs.torus2d(self.rows, self.cols)
        if self.family == "hypercube":
            if (1 << self.dim) != L:
                raise ValueError(f"hypercube 2^dim={1 << self.dim} != L={L}")
            return _graphs.hypercube(self.dim)
        if self.family == "complete":
            return _graphs.complete(L)
        if self.family == "circulant":
            return _graphs.circulant(L, self.shifts)
        if self.family == "barabasi_albert":
            return _graphs.barabasi_albert(L, m=self.ba_m, seed=self.seed)
        if self.family == "hierarchical":
            return _graphs.hierarchical(L, branching=self.branching)
        if self.family == "cluster_cliques":
            return _graphs.cluster_of_cliques(L, clique=self.clique,
                                              seed=self.seed)
        return _graphs.star(L)

    def use_sparse(self, L: int, graph=None) -> bool:
        """Whether this topology takes the sparse consensus lowering:
        forced by ``representation``, or (auto) the consensus layer's
        node-count/density cutoff."""
        from repro_torch.distributed.consensus import (
            SPARSE_DENSITY_THRESHOLD, SPARSE_MIN_NODES)
        if self.representation != "auto":
            return self.representation == "sparse"
        g = graph if graph is not None else self.build_graph(L)
        return L >= SPARSE_MIN_NODES and g.density <= SPARSE_DENSITY_THRESHOLD

    def build_weights(self, L: int,
                      graph: _graphs.Graph | None = None) -> np.ndarray:
        """The dense (L, L) mixing matrix W for the AGREE protocol."""
        if self.weights == "circulant":
            return _mixing.circulant_weights(L, self.shifts, self.self_weight)
        g = graph if graph is not None else self.build_graph(L)
        if isinstance(g, _graphs.SparseGraph):
            # reprolint: allow=RL002 — dense-weights branch; to_dense raises above DENSE_MATERIALIZE_MAX
            g = g.to_dense()
        if self.weights == "metropolis":
            return _mixing.metropolis_weights(g)
        if self.weights == "equal_neighbor":
            return _mixing.equal_neighbor_weights(g)
        return _mixing.lazy_weights(g, self.beta)

    def build_sparse_weights(self, L: int, graph=None
                             ) -> _mixing.SparseWeights:
        """The same mixing matrix in :class:`SparseWeights` form: the
        O(E) path, never allocating (L, L)."""
        if self.weights == "circulant":
            return _mixing.circulant_weights_sparse(L, self.shifts,
                                                    self.self_weight)
        g = graph if graph is not None else self.build_graph(L)
        if self.weights == "metropolis":
            return _mixing.metropolis_weights_sparse(g)
        if self.weights == "equal_neighbor":
            return _mixing.equal_neighbor_weights_sparse(g)
        return _mixing.lazy_weights_sparse(g, self.beta)


@dataclasses.dataclass(frozen=True)
class InitSpec:
    """Algorithm 2 — decentralized truncated spectral initialization."""
    T_pm: int = 30          # power-method iterations
    T_con: int = 10         # AGREE rounds inside the init
    broadcast: bool = True  # paper lines 14-15 (node-0 basis broadcast)


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Which algorithm, with its step size and iteration budget.

    ``eta=None`` resolves via Theorem 1's η = c_η/(n σ*max²), estimating
    σ*max from the spectral init's R diagonal (the paper's recipe).
    The tail fields are consumed only by solvers that declare them in
    their registry ``spec_kwargs`` (a non-default value on any other
    solver is rejected at run time):

      * ``local_steps``      — ``beyond_central``: local adapt steps per
        single gossip round;
      * ``compression``      — ``dif_quantized``: wire format, one of
        ``"bf16"`` (None → default) / ``"int8"`` / ``"int8_stochastic"``;
      * ``compression_k``    — ``dif_topk``: rows kept per gossip round
        (0 → d/4);
      * ``event_threshold``  — ``dif_event``: relative-change trigger θ
        (0 → always send, i.e. dense gossip);
      * ``consensus_gamma``  — compressed rules: the CHOCO consensus
        step size γ ∈ (0, 1] relaxing each round toward the combined
        value, ``Z ← Z + γ(combine(Z) − Z)`` — γ < 1 keeps ``dif_topk``
        stable at aggressive compression (k ≪ d/4); γ = 1 is the
        historical full step (bit-identical to pre-γ trajectories).
    """
    name: str = "dif_altgdmin"
    T_GD: int = 250
    T_con: int = 10
    eta: Optional[float] = None
    c_eta: float = 0.4
    local_steps: int = 1
    compression: Optional[str] = None
    compression_k: int = 0
    event_threshold: float = 0.0
    consensus_gamma: float = 1.0

    def __post_init__(self):
        if self.local_steps < 1:
            raise ValueError(f"local_steps must be >= 1, got "
                             f"{self.local_steps}")
        if self.compression_k < 0:
            raise ValueError(f"compression_k must be >= 0 (0 = the rule's "
                             f"d/4 default), got {self.compression_k}")
        if self.event_threshold < 0:
            raise ValueError(f"event_threshold must be >= 0, got "
                             f"{self.event_threshold}")
        if not 0.0 < self.consensus_gamma <= 1.0:
            raise ValueError(f"consensus_gamma must be in (0, 1] (1 = the "
                             f"full CHOCO step), got {self.consensus_gamma}")


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Iteration-engine backend (see :mod:`repro_torch.core.engine`):
    ``"cuda"`` | ``"torch-ref"``, or None for env/device selection.
    ``blk_d`` is the JAX package's d-tile; the CUDA kernels stream d
    whole and ignore it (kept so specs round-trip)."""
    backend: Optional[str] = None
    blk_d: int = 256


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Network model for the emulated wall-clock axis (paper Sec. V)."""
    model: str = "ethernet-1gbps"
    compute_s_per_iter: float = 1e-3
    seed: int = 0

    def __post_init__(self):
        if self.model not in COMM_MODELS:
            raise ValueError(f"unknown comm model {self.model!r}; "
                             f"expected one of {COMM_MODELS}")

    def rng(self) -> np.random.Generator:
        """The ONE seeded generator every priced or simulated time axis
        draws its jitter from — two runs of the same spec produce
        identical axes."""
        return np.random.default_rng(self.seed)


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """Fault-injection and simulated-time model — the system-realism
    layer.  When an :class:`ExperimentSpec` carries one, the runner (a)
    samples a per-iteration node availability mask from the seeded
    process below (consumed by the dropout-tolerant ``dif_partial`` /
    ``dif_stale`` / ``dif_pushsum`` solvers — all ``T_con`` gossip
    rounds of one outer iteration share the iteration's mask), and (b)
    REPLACES the closed-form comm-model pricing with the event-driven
    clock of :mod:`repro_torch.core.system_clock`, so ``Trace.time_axis``
    becomes measured simulated seconds.

    Availability process (``availability``):

      * ``"always"``    — every node live every iteration (the
        degenerate anchor: trajectories must match dense gossip
        bit-for-bit);
      * ``"bernoulli"`` — node g is live at iteration τ iid with
        probability ``p_on``;
      * ``"markov"``    — 2-state on/off chain per node (start on):
        P(on→off) = ``p_drop``, P(off→on) = ``p_return``.

    Heterogeneous compute: per-node speed multipliers drawn once from
    U[1, 1+``speed_spread``], plus a straggler tail — each (iteration,
    node) compute independently slows by ``straggler_factor`` with
    probability ``straggler_prob``.  ``latency_s``/``jitter_std_s``
    override the CommSpec network model's link distribution when set
    (``None`` keeps the model's own).  All draws derive from ``seed``
    (masks and speeds) or the CommSpec seed (clock jitter), so the layer
    is reproducible from the spec alone.
    """
    availability: str = "always"
    p_on: float = 1.0
    p_drop: float = 0.0
    p_return: float = 1.0
    speed_spread: float = 0.0
    straggler_prob: float = 0.0
    straggler_factor: float = 1.0
    latency_s: Optional[float] = None
    jitter_std_s: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        if self.availability not in AVAILABILITY_KINDS:
            raise ValueError(f"unknown availability kind "
                             f"{self.availability!r}; expected one of "
                             f"{AVAILABILITY_KINDS}")
        for field in ("p_on", "p_drop", "p_return", "straggler_prob"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{field} must be a probability in "
                                 f"[0, 1], got {v}")
        if self.speed_spread < 0:
            raise ValueError(f"speed_spread must be >= 0, got "
                             f"{self.speed_spread}")
        if self.straggler_factor < 1:
            raise ValueError(f"straggler_factor multiplies compute time "
                             f"and must be >= 1, got "
                             f"{self.straggler_factor}")
        for field in ("latency_s", "jitter_std_s"):
            v = getattr(self, field)
            if v is not None and v < 0:
                raise ValueError(f"{field} must be >= 0 (or None for the "
                                 f"comm model's own), got {v}")

    @property
    def is_always_on(self) -> bool:
        """True when the availability process can never drop a node —
        the regime every solver (not just the dropout-tolerant three)
        may run under."""
        return (self.availability == "always"
                or (self.availability == "bernoulli" and self.p_on == 1.0)
                or (self.availability == "markov" and self.p_drop == 0.0))

    def availability_mask(self, T_GD: int, L: int) -> np.ndarray:
        """The seeded (T_GD, L) bool mask — True = node live.  Host
        numpy, generated ONCE by the runner and fed identically to the
        simulator scan and the mesh runtime (substrate determinism)."""
        if self.is_always_on:
            return np.ones((T_GD, L), dtype=bool)
        rng = np.random.default_rng([self.seed, 0])
        if self.availability == "bernoulli":
            return rng.random((T_GD, L)) < self.p_on
        mask = np.empty((T_GD, L), dtype=bool)
        state = np.ones(L, dtype=bool)              # markov: start on
        for t in range(T_GD):
            u = rng.random(L)
            state = np.where(state, u >= self.p_drop, u < self.p_return)
            mask[t] = state
        return mask

    def node_speeds(self, L: int) -> np.ndarray:
        """Per-node compute-time multipliers in [1, 1+speed_spread]."""
        if self.speed_spread == 0:
            return np.ones(L)
        rng = np.random.default_rng([self.seed, 1])
        return 1.0 + self.speed_spread * rng.random(L)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One fully-specified Dec-MTRL experiment cell."""
    problem: ProblemSpec = ProblemSpec()
    topology: TopologySpec = TopologySpec()
    init: InitSpec = InitSpec()
    solver: SolverSpec = SolverSpec()
    engine: EngineSpec = EngineSpec()
    comm: CommSpec = CommSpec()
    system: Optional[SystemSpec] = None
    substrate: str = "simulator"
    name: str = ""

    def __post_init__(self):
        if self.substrate not in SUBSTRATES:
            raise ValueError(f"unknown substrate {self.substrate!r}; "
                             f"expected one of {SUBSTRATES}")

    # ------------------------------------------------- JSON round-trip

    def to_dict(self) -> dict:
        """Plain-JSON-types dict (tuples become lists)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "ExperimentSpec":
        return _from_dict(cls, data)

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))


def _from_dict(cls, data):
    """Reconstruct a (nested) spec dataclass, rejecting unknown keys so a
    mistyped sweep field fails loudly instead of silently defaulting."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown field(s) {sorted(unknown)}")
    kwargs = {}
    for key, value in data.items():
        sub = _SUBSPEC_TYPES.get((cls, key))
        # optional sub-specs (system) round-trip None as None
        kwargs[key] = (_from_dict(sub, value)
                       if sub is not None and value is not None else value)
    return cls(**kwargs)


_SUBSPEC_TYPES = {
    (ExperimentSpec, "problem"): ProblemSpec,
    (ExperimentSpec, "topology"): TopologySpec,
    (ExperimentSpec, "init"): InitSpec,
    (ExperimentSpec, "solver"): SolverSpec,
    (ExperimentSpec, "engine"): EngineSpec,
    (ExperimentSpec, "comm"): CommSpec,
    (ExperimentSpec, "system"): SystemSpec,
}
