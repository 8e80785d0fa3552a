"""Hand-written CUDA kernels of the routing round and their plain versions."""
