"""Build and load the port's CUDA kernels: one ``nvcc`` per source into a
shared library with a plain C interface, bound with ``ctypes``.

Nothing here runs at import. :func:`library` builds every
``csrc/*.cu`` for ``sm_90a`` at first use, all ``nvcc`` processes
started together, into ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``), each named by the hash of its source and
of every shared header ``csrc/*.cuh``, so an edited kernel or header is
rebuilt, and loads each library once per process. ``nvcc`` runs with
``-Xptxas -v``; its output (each kernel's registers, spills and shared
memory) is kept beside the library as ``lib<name>_<hash>.log``.

The TMA kernels reach the driver's ``cuTensorMapEncodeTiled`` through
the runtime's ``cudaGetDriverEntryPoint`` (``csrc/sm90.cuh``), so no
library is linked beyond the CUDA runtime.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_F32 = ctypes.c_float
#: C entry points of each source (``csrc/<name>.cu``) and their arguments
_SIGNATURES = {
    "route": {
        "dcra_bucket_rank": (_P, _P, _I64, _I64, _I32, _P, _P, _P, _P),
        "dcra_bucket_scatter": (_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32,
                                _I32, _I64, _P, _P, _P, _P, _P, _P, _P),
        "dcra_reduce_received": (_P, _P, _I64, _I64, _I64, _I32, _P, _P,
                                 _P),
    },
    "histogram": {
        "dcra_histogram": (_P, _I64, _I32, _P, _P),
    },
    "spmv": {
        "dcra_bsr_spmv": (_P, _P, _P, _I64, _I64, _I32, _I64, _P, _P, _P,
                          _P),
    },
    "gmm": {
        "dcra_gmm": (_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32,
                     _P, _P),
    },
    "flash_attention": {
        "dcra_flash_attention": (_P, _P, _P, _P, _I64, _I32, _I32, _F32,
                                 _I32, _I32, _P, _P),
    },
}

_LIBS = {}                # name -> loaded library, filled on first use
_BUILD = {}     # name -> {"path", "log", "seconds"}, filled by build()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by the hash of that source
    and of every ``csrc/*.cuh`` (any of which it may include)."""
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build() -> dict:
    """Compile every source in :data:`_SIGNATURES` whose library of the
    same source hash is missing, one ``nvcc`` each, all at once. Returns
    ``{name: {"path", "log", "seconds"}}``: ``log`` is nvcc's output
    (``-Xptxas -v``), ``seconds`` 0.0 for a library that was already
    built, otherwise the wall time of the parallel build."""
    if len(_BUILD) == len(_SIGNATURES):
        return dict(_BUILD)
    todo = {}
    for name in _SIGNATURES:
        out = _target(name)
        if out.exists():
            _BUILD[name] = {"path": out, "log": out.with_suffix(".log"),
                            "seconds": 0.0}
        else:
            todo[name] = out
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        nvcc, procs = _nvcc(), {}
        for name, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = tmp.with_suffix(".log")
            with open(log, "w") as err:     # a file: no pipe fills up
                procs[name] = (tmp, log, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=subprocess.DEVNULL, stderr=err))
        errors = []
        for name, (tmp, log, proc) in procs.items():
            if proc.wait() != 0:
                errors.append(f"nvcc failed on {name}.cu:\n{log.read_text()}")
                log.unlink()
        if errors:
            raise RuntimeError("\n".join(errors))
        seconds = time.perf_counter() - t0
        for name, (tmp, log, _) in procs.items():
            out = todo[name]
            os.replace(log, out.with_suffix(".log"))
            os.replace(tmp, out)
            _BUILD[name] = {"path": out, "log": out.with_suffix(".log"),
                            "seconds": seconds}
    return dict(_BUILD)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library of ``csrc/<name>.cu`` (every library is
    built on the first call)."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build()[name]["path"]))
        for fn_name, args in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]

