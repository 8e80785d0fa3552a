"""Model layers of the port: the MoE layer and its helpers."""
