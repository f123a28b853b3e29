"""World: voxel grid, procedural scenes, lights and the march tables."""
