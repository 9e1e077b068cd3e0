# Declarative experiment API: build an ExperimentSpec, call
# run_experiment, get a Trace.
from repro_torch.api.spec import (
    ExperimentSpec, ProblemSpec, TopologySpec, InitSpec, SolverSpec,
    EngineSpec, CommSpec, SystemSpec, GRAPH_FAMILIES, WEIGHT_SCHEMES,
    SUBSTRATES, AVAILABILITY_KINDS,
)
from repro_torch.api.registry import (
    SOLVERS, SolverDef, register_solver, get_solver, solver_names,
)
from repro_torch.api.runner import (
    Trace, Materialized, run_experiment, materialize,
    materialized_from_arrays, comm_time_axis, system_time_axis,
)
