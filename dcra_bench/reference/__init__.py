"""Plain references: straightforward PyTorch over the benchmark's own
inputs, in float32 or float64, importing nothing of the port. They only
read the port's outputs to judge them."""
