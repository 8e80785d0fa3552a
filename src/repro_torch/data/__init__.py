"""Synthetic data pipelines of the port."""
