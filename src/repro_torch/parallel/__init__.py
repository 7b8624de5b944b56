# Distribution: the reference's sharding rules as DTensor placements on a
# DeviceMesh (`sharding`) and the GPipe schedule over a "stage" axis
# (`pipeline`). Importing it starts no process group.
