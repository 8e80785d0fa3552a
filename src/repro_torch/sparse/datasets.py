"""Seeded graph generators (counterpart of ``repro/sparse/datasets.py``).

Numpy only, and byte-identical to the JAX package's generators for the
same arguments: the same generator calls in the same order.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .csr import CSR, from_edges

# Graph500 RMAT parameters
A, B, C = 0.57, 0.19, 0.19
_PAIR_CHUNK = 1 << 20


def _rmat_pairs(scale: int, E: int, rng, chunk: int = _PAIR_CHUNK) -> tuple:
    """``E`` raw RMAT (src, dst) pairs from ``rng`` (the quadrant walk).

    Bit ``b`` of pair ``i`` comes from draw ``b * E + i`` of ``rng``, as
    in the reference, which draws the ``scale`` blocks of ``E`` one after
    another. Here the pairs are built ``chunk`` at a time on a few
    threads, each chunk from a copy of the bit generator advanced to its
    draws (a PCG64 double is one 64-bit draw), so the working set stays
    in cache; ``rng`` is left where the reference leaves it. Same pairs,
    byte for byte."""
    state = rng.bit_generator.state
    src = np.empty(E, np.int64)
    dst = np.empty(E, np.int64)

    def build(lo):
        hi = min(E, lo + chunk)
        s = np.zeros(hi - lo, np.int64)
        d = np.zeros(hi - lo, np.int64)
        u = np.empty(hi - lo)
        for bit in range(scale):
            bg = type(rng.bit_generator)()
            bg.state = state
            bg.advance(bit * E + lo)
            np.random.Generator(bg).random(out=u)
            s <<= 1
            s |= u >= A + B                                 # BL or BR
            d <<= 1
            d |= ((u >= A) & (u < A + B)) | (u >= A + B + C)  # TR or BR
        src[lo:hi], dst[lo:hi] = s, d

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(build, range(0, E, chunk)))
    rng.bit_generator.advance(scale * E)
    return src, dst


def rmat(scale: int, edge_factor: int = 16, seed: int = 1,
         undirected: bool = True) -> CSR:
    """RMAT-<scale>: 2**scale vertices, edge_factor * V edges drawn,
    self-loops dropped, mirrored when ``undirected``, deduplicated."""
    rng = np.random.default_rng(seed)
    V = 1 << scale
    E = V * edge_factor
    src, dst = _rmat_pairs(scale, E, rng)
    perm = rng.permutation(V)              # break the RMAT ordering artefact
    src, dst = perm[src], perm[dst]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    # the reference keeps the first of each duplicate (src, dst) in key
    # order; the sorted distinct keys are the same pairs (a plain sort:
    # np.unique may hash, which is slow when nearly every key is distinct)
    key = np.sort(src * V + dst)
    first = np.ones(len(key), bool)
    first[1:] = key[1:] != key[:-1]
    key = key[first]
    src, dst = key // V, key % V
    w = (rng.integers(1, 256, len(src))).astype(np.float32)
    return from_edges(V, src, dst, w)


def erdos_renyi(n: int, avg_degree: float = 8.0, seed: int = 5,
                undirected: bool = True) -> CSR:
    """G(n, p) with p = avg_degree / n."""
    rng = np.random.default_rng(seed)
    E = int(n * avg_degree)
    src = rng.integers(0, n, E)
    dst = rng.integers(0, n, E)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if undirected:
        # weight per undirected edge (w(a,b) == w(b,a)), then mirror
        a, b = np.minimum(src, dst), np.maximum(src, dst)
        _, idx = np.unique(a * n + b, return_index=True)
        a, b = a[idx], b[idx]
        w = rng.integers(1, 256, len(a)).astype(np.float32)
        return from_edges(n, np.concatenate([a, b]), np.concatenate([b, a]),
                          np.concatenate([w, w]))
    _, idx = np.unique(src * n + dst, return_index=True)
    src, dst = src[idx], dst[idx]
    w = rng.integers(1, 256, len(src)).astype(np.float32)
    return from_edges(n, src, dst, w)


def disconnected_pair(n_each: int = 128, avg_degree: float = 6.0,
                      seed: int = 11) -> CSR:
    """Two ER components with no edge between them."""
    a = erdos_renyi(n_each, avg_degree, seed=seed)
    b = erdos_renyi(n_each, avg_degree, seed=seed + 1)
    src = np.concatenate([a.row_of(), b.row_of() + n_each])
    dst = np.concatenate([a.col_idx.astype(np.int64),
                          b.col_idx.astype(np.int64) + n_each])
    w = np.concatenate([a.values, b.values])
    return from_edges(2 * n_each, src, dst, w)


def wiki_like(n_vertices: int = 4096, avg_degree: int = 25,
              seed: int = 7) -> CSR:
    """Wikipedia-like: Zipf in/out degree, directed."""
    rng = np.random.default_rng(seed)
    E = n_vertices * avg_degree
    ranks = np.arange(1, n_vertices + 1)
    p_dst = 1.0 / ranks ** 0.9
    p_dst /= p_dst.sum()
    p_src = 1.0 / ranks ** 0.6
    p_src /= p_src.sum()
    src = rng.choice(n_vertices, E, p=p_src)
    dst = rng.choice(n_vertices, E, p=p_dst)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    _, idx = np.unique(src.astype(np.int64) * n_vertices + dst,
                       return_index=True)
    src, dst = src[idx], dst[idx]
    w = rng.integers(1, 256, len(src)).astype(np.float32)
    return from_edges(n_vertices, src.astype(np.int64), dst.astype(np.int64),
                      w)
