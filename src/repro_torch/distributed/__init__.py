# The consensus layer, the mesh over torch.distributed and gossip.
from repro_torch.distributed.consensus import (
    COMBINE_RULES, CombineRule, combine_blocks, get_rule,
    mesh_weights_from_matrix, neighbor_average_matrix, node_mean,
)
from repro_torch.distributed.gossip import roll_gossip
from repro_torch.distributed.mesh import NodeMesh, spawn
