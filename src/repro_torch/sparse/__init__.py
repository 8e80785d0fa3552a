"""CSR graphs, datasets, oracles and the TaskProgram runtime."""
