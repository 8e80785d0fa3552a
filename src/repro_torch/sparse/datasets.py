"""Seeded graph generators (counterpart of ``repro/sparse/datasets.py``).

Numpy, and byte-identical to the JAX package's generators for the same
arguments: the same generator calls in the same order. The chunk-seeded
ingest (:func:`rmat_edge_chunk`, :func:`ingest_edges`) lets each process
of a distributed fabric draw only its share of an RMAT edge stream.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.fabric import balanced_slice
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


# ---------------------------------------------------------------------------
# chunk-seeded ingest: no process draws the whole edge list
# ---------------------------------------------------------------------------

def rmat_edge_chunk(scale: int, chunk_id: int, n_chunks: int,
                    edge_factor: int = 16, seed: int = 1) -> tuple:
    """Chunk ``chunk_id`` of ``n_chunks`` of an RMAT-<scale> edge stream:
    directed ``(src, dst, w)`` (``repro/sparse/datasets.py:66-93``). Each
    chunk draws from its own ``SeedSequence((seed, chunk_id))``, so the
    union over chunks depends on ``(scale, edge_factor, seed, n_chunks)``
    only, not on which process draws which chunk; the Graph500 vertex
    permutation comes from ``seed`` alone, the same for every chunk.
    Self-loops are dropped; duplicates are kept (a multigraph)."""
    V = 1 << scale
    E = V * edge_factor
    lo, hi = (chunk_id * E) // n_chunks, ((chunk_id + 1) * E) // n_chunks
    rng = np.random.default_rng(np.random.SeedSequence((seed, chunk_id)))
    src, dst = _rmat_pairs(scale, hi - lo, rng)
    perm = np.random.default_rng(seed).permutation(V)
    src, dst = perm[src], perm[dst]
    w = rng.integers(1, 256, len(src)).astype(np.float32)
    keep = src != dst
    return src[keep], dst[keep], w[keep]


def ingest_edges(scale: int, edge_factor: int = 16, seed: int = 1, *,
                 n_chunks: int = 16, fabric=None,
                 rank: Optional[int] = None, world: Optional[int] = None,
                 undirected: bool = True) -> tuple:
    """This process's share of a chunked RMAT edge stream ``(src, dst,
    w)``: the contiguous run of chunks ``fabric.host_slice(n_chunks)``
    gives it (``rank`` / ``world`` stand in for the fabric's; with
    neither, the whole stream). ``undirected`` mirrors the local chunks,
    so the union over processes is still independent of the split."""
    if fabric is not None:
        lo, hi = fabric.host_slice(n_chunks, rank=rank, world=world)
    else:
        lo, hi = balanced_slice(n_chunks, int(rank or 0), int(world or 1))
    parts = [rmat_edge_chunk(scale, c, n_chunks, edge_factor, seed)
             for c in range(lo, hi)]
    if parts:
        src, dst, w = (np.concatenate(a) for a in zip(*parts))
    else:                                   # more processes than chunks
        src, dst = np.zeros(0, np.int64), np.zeros(0, np.int64)
        w = np.zeros(0, np.float32)
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    return src, dst, w


def ingest_graph(scale: int, edge_factor: int = 16, seed: int = 1, *,
                 n_chunks: int = 16, undirected: bool = True) -> CSR:
    """The whole chunked stream as one multigraph CSR (parallel edges
    accumulate), on one process: what the per-process shares add up to."""
    src, dst, w = ingest_edges(scale, edge_factor, seed, n_chunks=n_chunks,
                               undirected=undirected)
    return from_edges(1 << scale, src, dst, w)


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


@dataclass(frozen=True)
class DatasetInfo:
    """Analytic footprint of one of the paper's full-scale datasets
    (§IV-A)."""
    name: str
    vertices: int
    edges: int

    @property
    def footprint_bytes(self) -> float:
        # CSR: row_ptr (8 B/V) + col_idx (4 B/E) + values (4 B/E) + output
        # (4 B/V)
        return 12.0 * self.vertices + 8.0 * self.edges


PAPER_DATASETS = {
    "R22": DatasetInfo("RMAT-22", 1 << 22, int(1 << 22) * 32),
    "R25": DatasetInfo("RMAT-25", 1 << 25, int(1 << 25) * 32),
    "R26": DatasetInfo("RMAT-26", 1 << 26, int(1.3e9)),
    "WK": DatasetInfo("Wikipedia", 4_200_000, 101_000_000),
}


def histogram_data(n: int = 1 << 16, n_bins: int = 1 << 12,
                   seed: int = 3) -> np.ndarray:
    """Element stream of the histogram app: normal around the middle bin
    (sigma ``n_bins / 6``), clipped to ``[0, n_bins)``, int64."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(n_bins / 2, n_bins / 6, n)
    return np.clip(vals, 0, n_bins - 1).astype(np.int64)
