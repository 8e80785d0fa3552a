"""Model layers of the port: the decoder LMs (dense, MoE, VLM), their
attention, MLP and MoE layers, and the helpers they share."""
