"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, bound with ``ctypes``.

Nothing here runs at import. :func:`library` compiles
``csrc/route.cu`` for ``sm_90a`` at first use into ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``), named by the
hash of the source so an edited kernel is rebuilt, and loads it once
per process.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {
    "dcra_rank_tile": (),
    "dcra_bucket_rank": (_P, _P, _I64, _I64, _I32, _P, _P, _P),
    "dcra_bucket_scatter": (_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32,
                            _I32, _I64, _P, _P, _P, _P, _P),
    "dcra_reduce_received": (_P, _P, _I64, _I64, _I64, _I32, _P, _P),
}

_LIB = {}                 # loaded library + build record, filled on first use


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def build() -> dict:
    """Compile ``csrc/route.cu`` unless a library of the same source hash
    exists. Returns ``{"path", "seconds"}`` (``seconds`` 0.0 when the
    library was already built)."""
    src = CSRC / "route.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if out.exists():
        return {"path": out, "seconds": 0.0}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return {"path": out, "seconds": time.perf_counter() - t0}


def library() -> ctypes.CDLL:
    """The loaded route kernel library (built on first call)."""
    if "lib" not in _LIB:
        rec = build()
        lib = ctypes.CDLL(str(rec["path"]))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _LIB["lib"], _LIB["build"] = lib, rec
    return _LIB["lib"]


def build_record() -> dict:
    """How the loaded library was obtained (path, build seconds); builds
    it if that has not happened yet."""
    library()
    return dict(_LIB["build"])
