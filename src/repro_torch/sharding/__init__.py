"""Logical-axis sharding rules on ``DeviceMesh``/DTensor (the port of
``repro.sharding``)."""

from repro_torch.sharding.rules import (
    DEFAULT_RULES, LONG_DECODE_RULES, NamedSharding, P, PartitionSpec,
    Rules, axis_rules, constrain, current_rules, full, is_dtensor,
    local_call, logical, map_logical, mesh_shape, mesh_size, place,
    place_tree, placements_for, spec_for, tree_shardings, tree_specs)

__all__ = ["DEFAULT_RULES", "LONG_DECODE_RULES", "NamedSharding", "P",
           "PartitionSpec", "Rules", "axis_rules", "constrain",
           "current_rules", "full", "is_dtensor", "local_call", "logical",
           "map_logical", "mesh_shape", "mesh_size", "place", "place_tree",
           "placements_for", "spec_for", "tree_shardings", "tree_specs"]
