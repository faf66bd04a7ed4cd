"""Multi-GPU placement: the mesh descriptor, the parameter and input
sharding resolver, and each rank's packed shard of a flat vector."""
