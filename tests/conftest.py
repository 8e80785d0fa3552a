"""Test-tier bootstrap: make ``import hypothesis`` always work.

Must run before test modules are collected — conftest import order
guarantees that. See tests/_hypothesis_compat.py for the fallback
semantics when real hypothesis isn't installed.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import _hypothesis_compat  # noqa: E402,F401


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the PyTorch port's kernels); "
        "skips without one")
