"""The GAP Benchmark Suite's ``kron`` graph (Beamer, Asanovic, Patterson,
arXiv:1508.03619), made on the device from a seed: Graph500's Kronecker
generator, ``degree * 2**scale`` edges, each bit of a pair drawn from the
initiator ``(A, B, C, 1 - A - B - C)`` by one uniform number (the quadrant
walk), vertex labels permuted, self-loops and duplicate edges dropped,
made undirected, integer weights uniform in ``[1, 255]`` on each
undirected edge, both directions stored in a CSR sorted by (row, col).
"""
from __future__ import annotations

from dataclasses import dataclass

from .seeds import generator

TAG_EDGES, TAG_PERM, TAG_WEIGHTS, TAG_ROOTS = 101, 102, 103, 104


@dataclass
class Graph:
    """A CSR on the device: ``row_ptr [n + 1]`` int64, ``col_idx [nnz]``
    int32, ``values [nnz]`` float32."""
    n: int
    row_ptr: object
    col_idx: object
    values: object

    @property
    def nnz(self) -> int:
        return int(self.col_idx.numel())

    def degrees(self):
        return self.row_ptr[1:] - self.row_ptr[:-1]

    def rows(self):
        """The source vertex of each stored edge, int64."""
        import torch
        return torch.repeat_interleave(
            torch.arange(self.n, device=self.row_ptr.device), self.degrees(),
            output_size=self.nnz)

    def host(self):
        """``(row_ptr, col_idx, values)`` as numpy arrays."""
        return (self.row_ptr.cpu().numpy(), self.col_idx.cpu().numpy(),
                self.values.cpu().numpy())


def kron(scale: int, degree: int, initiator, seed: int, device,
         weights=(1, 255)) -> Graph:
    import torch
    a, b, c = (float(p) for p in initiator)
    n = 1 << int(scale)
    m = n * int(degree)
    gen = generator(seed, TAG_EDGES, device)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    u = torch.empty(m, dtype=torch.float32, device=device)
    for _ in range(int(scale)):
        u.uniform_(generator=gen)
        src.mul_(2).add_(u >= a + b)                        # C or D
        dst.mul_(2).add_(((u >= a) & (u < a + b)) | (u >= a + b + c))
    del u
    perm = torch.randperm(n, generator=generator(seed, TAG_PERM, device),
                          device=device)
    src, dst = perm[src], perm[dst]
    del perm
    keep = src != dst
    lo = torch.minimum(src, dst)[keep]
    hi = torch.maximum(src, dst)[keep]
    del src, dst, keep
    key = torch.unique(lo * n + hi)                         # sorted
    del lo, hi
    lo, hi = key // n, key % n
    w = torch.randint(int(weights[0]), int(weights[1]) + 1, (key.numel(),),
                      generator=generator(seed, TAG_WEIGHTS, device),
                      device=device).to(torch.float32)
    del key
    rows = torch.cat([lo, hi])
    cols = torch.cat([hi, lo])
    w = torch.cat([w, w])
    del lo, hi
    order = torch.argsort(rows * n + cols)
    rows, cols, w = rows[order], cols[order].to(torch.int32), w[order]
    del order
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    row_ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return Graph(n=n, row_ptr=row_ptr, col_idx=cols, values=w)


def roots(graph: Graph, count: int, seed: int) -> list:
    """``count`` distinct vertices of non-zero degree, drawn from the seed
    (GAP draws its 64 sources so), in the order the window uses them."""
    import torch
    dev = graph.row_ptr.device
    cand = torch.nonzero(graph.degrees() > 0).reshape(-1)
    pick = torch.randperm(cand.numel(),
                          generator=generator(seed, TAG_ROOTS, dev),
                          device=dev)[:int(count)]
    return [int(v) for v in cand[pick].cpu().tolist()]
