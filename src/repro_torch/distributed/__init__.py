# The topologies, the mixing weights, the consensus layer, gossip, the
# trainer's aggregation strategies and the mesh over torch.distributed:
# every name of the reference's repro.distributed, with mesh_gossip in
# place of its shard_map_gossip.
from repro_torch.distributed.graphs import (
    Graph, erdos_renyi, ring, torus2d, hypercube, complete, star,
    path_graph, circulant,
)
from repro_torch.distributed.mixing import (
    metropolis_weights, equal_neighbor_weights, lazy_weights, gamma,
    circulant_weights,
)
from repro_torch.distributed.consensus import (
    CombineRule, CommSignature, COMBINE_RULES, register_rule, get_rule,
    rule_names, combine_blocks, mesh_weights_from_matrix,
    neighbor_average_matrix, node_mean,
)
from repro_torch.distributed.gossip import (
    roll_gossip, mesh_gossip, ring_weights, torus_shifts, axis_mean,
)
from repro_torch.distributed.aggregation import (
    AggregationConfig, aggregate_gradients, aggregate_params,
    comm_bytes_per_step, STRATEGIES,
)
from repro_torch.distributed.mesh import NodeMesh, spawn
