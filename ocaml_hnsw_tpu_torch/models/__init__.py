"""Graph state, flat scan, bulk constructor, seed entry and the packed
query engine of the torch port."""
