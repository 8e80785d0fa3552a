"""Optimiser and data-parallel gradient compression of the port."""
