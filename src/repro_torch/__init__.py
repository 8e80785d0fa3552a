"""PyTorch/CUDA port of the DCRA owner-routed runtime (see README)."""
