"""Runtime primitives of the port (failure injection, retries)."""
