"""RCV1-shaped sparse TF-IDF rows, made on the device from a seed.

The distribution is that of the port's ``bench.scale.rcv1_like_corpus``
(RCV1-v2: Lewis et al., JMLR 5, 2004), written in PyTorch so that the
800k rows a stream cell needs take a second on the card instead of minutes
of NumPy on the host:

  - term ranks 0 .. ``terms - 1`` drawn with weight ``(rank + offset) **
    -zipf_s`` (a flatter document-frequency curve than web text);
  - document lengths log-normal around ``median_terms`` (``sigma``),
    clipped to ``[min_terms, max_terms]``; a term drawn twice in one row
    counts once;
  - ln-TF.IDF values ``(1 + ln tf) * ln(2 + rank)`` with ``tf = 1 + Exp(1)``,
    each row L2-normalised;
  - ``dup_rate`` of the rows copy an earlier row exactly (pairs at 1.0);
  - ``near_rate`` of the rows are near-duplicates of an earlier row: the
    unit vector ``c * a + sqrt(1 - c**2) * b``, renormalised, where ``a``
    is the earlier row's original (a near-duplicate of a copy is one of
    the original), ``b`` the row's own draw and ``c`` uniform in
    ``near_cos``.  Two draws share few terms, so the cosine to the source
    is about ``c``: pairs fall on both sides of a threshold inside it.

Rows are made in blocks of ``BLOCK``, each from its own generator seeded by
``(seed, block)``, and a row's content depends only on the seed and the
rows before it: a corpus of ``n`` rows is the first ``n`` rows of any
longer one, so a stream continues the index's sequence.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["BLOCK", "Corpus", "make_corpus", "take_rows"]

BLOCK = 1 << 16
_MASK64 = (1 << 64) - 1


def _block_seed(seed: int, block: int) -> int:
    """A 63-bit generator seed for one block (splitmix64 of both)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (block + 1) * 0xD1B54A32D192ED03)
    x &= _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x & ((1 << 63) - 1)


@dataclasses.dataclass
class Corpus:
    """CSR rows on the device: ``indptr`` int64 ``[n_rows + 1]``,
    ``indices`` int64 term ranks (sorted within a row), ``data`` float64;
    ``terms`` is the number of term ranks, ``vector_dim`` the width of the
    vectors handed to the program."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    terms: int
    vector_dim: int

    @property
    def n_rows(self) -> int:
        return self.indptr.numel() - 1

    def host(self, r0: int = 0, r1: int | None = None):
        """Rows ``[r0, r1)`` as host NumPy ``(indptr, indices int32, data
        float64)``."""
        r1 = self.n_rows if r1 is None else r1
        ptr = self.indptr[r0:r1 + 1]
        s, e = int(ptr[0]), int(ptr[-1])
        return ((ptr - s).cpu().numpy(),
                self.indices[s:e].to(torch.int32).cpu().numpy(),
                self.data[s:e].cpu().numpy())

    def distinct_terms(self, min_df: int = 1) -> int:
        """Term ranks that ``min_df`` rows or more use."""
        df = torch.bincount(self.indices, minlength=self.terms)
        return int((df >= min_df).sum())


def _raw_block(p: dict, block: int, seed: int, cdf: torch.Tensor,
               dev: torch.device):
    """One block of rows before duplication: (counts, indices, data,
    dup_dst, dup_src, near_dst, near_src, near_cos), the rows as global
    indices."""
    g = torch.Generator(device=dev)
    g.manual_seed(_block_seed(seed, block))
    n, terms = BLOCK, int(p["terms"])
    f64 = torch.float64
    ln = torch.randn(n, generator=g, device=dev, dtype=f64)
    nnz = (ln * p["sigma"] + math.log(p["median_terms"])).exp()
    nnz = nnz.clamp(p["min_terms"], p["max_terms"]).long()
    u = torch.rand(int(nnz.sum()), generator=g, device=dev, dtype=f64)
    ranks = torch.searchsorted(cdf, u).clamp_(max=terms - 1)
    row = torch.repeat_interleave(torch.arange(n, device=dev), nnz)
    key = torch.unique(row * terms + ranks)  # sorted by (row, rank)
    row, ranks = key // terms, key % terms
    tf = 1.0 + torch.empty(key.numel(), device=dev, dtype=f64).exponential_(
        generator=g)
    vals = (1.0 + tf.log()) * (2.0 + ranks.to(f64)).log()
    sq = torch.zeros(n, device=dev, dtype=f64).index_add_(0, row, vals * vals)
    vals = vals / sq.sqrt()[row]
    counts = torch.bincount(row, minlength=n)
    b0 = block * BLOCK
    n_dup = int(round(n * p["dup_rate"]))
    n_near = int(round(n * p.get("near_rate", 0.0)))
    first = 1 if block == 0 else 0  # row 0 has nothing before it
    dst = b0 + first + torch.randperm(n - first, generator=g, device=dev)[
        :n_dup + n_near]
    src = (torch.rand(dst.numel(), generator=g, device=dev, dtype=f64)
           * dst.to(f64)).long().clamp_(max=dst - 1)
    lo, hi = p.get("near_cos", (1.0, 1.0))
    cos = lo + (hi - lo) * torch.rand(n_near, generator=g, device=dev,
                                      dtype=f64)
    return (counts, ranks, vals, dst[:n_dup], src[:n_dup], dst[n_dup:],
            src[n_dup:], cos)


def _follow(link: torch.Tensor) -> torch.Tensor:
    """Each row's end of the chain of links (a row that links to itself
    ends one)."""
    while True:
        nxt = link[link]
        if torch.equal(nxt, link):
            return link
        link = nxt


def _gather(ptr: torch.Tensor, rows: torch.Tensor):
    """``(owner, position)`` of every entry of the CSR rows ``rows``:
    ``owner`` indexes ``rows``."""
    cnt = ptr[rows + 1] - ptr[rows]
    owner = torch.repeat_interleave(
        torch.arange(rows.numel(), device=rows.device), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    pos = torch.arange(int(cnt.sum()), device=rows.device) - start[owner]
    return owner, ptr[rows][owner] + pos


def _blend(ptr, indices, data, rows, roots, cos, terms: int):
    """The near-duplicate rows ``rows``: ``cos * root + sqrt(1 - cos**2) *
    own draw``, renormalised, as CSR ``(counts, indices, data)``."""
    oa, pa = _gather(ptr, roots)
    ob, pb = _gather(ptr, rows)
    owner = torch.cat([oa, ob])
    rank = torch.cat([indices[pa], indices[pb]])
    val = torch.cat([data[pa] * cos[oa],
                     data[pb] * (1.0 - cos[ob] ** 2).clamp_(min=0).sqrt()])
    key, inv = torch.unique(owner * terms + rank, return_inverse=True)
    val = torch.zeros(key.numel(), device=val.device,
                      dtype=val.dtype).index_add_(0, inv, val)
    owner, rank = key // terms, key % terms
    keep = val != 0
    owner, rank, val = owner[keep], rank[keep], val[keep]
    sq = torch.zeros(rows.numel(), device=val.device,
                     dtype=val.dtype).index_add_(0, owner, val * val)
    return (torch.bincount(owner, minlength=rows.numel()), rank,
            val / sq.sqrt()[owner])


def make_corpus(params: dict, n_rows: int, seed: int,
                device: torch.device | str) -> Corpus:
    """The first ``n_rows`` rows of the corpus of ``params`` (a
    configuration's ``corpus`` group) for ``seed``, on ``device``."""
    dev = torch.device(device)
    terms = int(params["terms"])
    w = (torch.arange(terms, device=dev, dtype=torch.float64)
         + params["zipf_offset"]) ** -params["zipf_s"]
    cdf = torch.cumsum(w / w.sum(), 0)
    n_blocks = -(-n_rows // BLOCK)
    parts = [_raw_block(params, b, seed, cdf, dev) for b in range(n_blocks)]
    counts, indices, data = (torch.cat([q[k] for q in parts])
                             for k in range(3))
    dup_dst, dup_src, near_dst, near_src, cos = (
        torch.cat([q[k] for q in parts]) for k in range(3, 8))
    raw_ptr = torch.zeros(counts.numel() + 1, device=dev, dtype=torch.long)
    torch.cumsum(counts, 0, out=raw_ptr[1:])
    # a copy copies its source as it ends up; a near-duplicate blends the
    # original at the end of every link before it
    src_of = torch.arange(n_blocks * BLOCK, device=dev)
    src_of[dup_dst] = dup_src
    root = src_of.clone()
    root[near_dst] = near_src
    src_of, root = _follow(src_of[:n_rows]), _follow(root[:n_rows])
    near = near_dst < n_rows
    near_dst, cos = near_dst[near], cos[near]
    if near_dst.numel():
        nc, ni, nd = _blend(raw_ptr, indices, data, near_dst,
                            root[near_dst], cos, terms)
        # the blended rows are stored after the raw ones
        start = raw_ptr[:-1].clone()
        start[near_dst] = raw_ptr[-1] + torch.cumsum(nc, 0) - nc
        counts = counts.clone()
        counts[near_dst] = nc
        indices, data = torch.cat([indices, ni]), torch.cat([data, nd])
    else:
        start = raw_ptr[:-1]
    c = counts[src_of]
    indptr = torch.zeros(n_rows + 1, device=dev, dtype=torch.long)
    torch.cumsum(c, 0, out=indptr[1:])
    rows = torch.repeat_interleave(torch.arange(n_rows, device=dev), c)
    pos = torch.arange(int(indptr[-1]), device=dev) - indptr[:-1][rows]
    src_pos = start[src_of][rows] + pos
    return Corpus(indptr, indices[src_pos], data[src_pos], terms,
                  int(params["vector_dim"]))


def take_rows(c: Corpus, rows) -> Corpus:
    """The rows ``rows`` (any order, repeats allowed) of ``c``."""
    rows = torch.as_tensor(np.asarray(rows), device=c.indptr.device).long()
    cnt = c.indptr[rows + 1] - c.indptr[rows]
    indptr = torch.zeros(rows.numel() + 1, device=rows.device,
                         dtype=torch.long)
    torch.cumsum(cnt, 0, out=indptr[1:])
    r = torch.repeat_interleave(torch.arange(rows.numel(),
                                             device=rows.device), cnt)
    pos = torch.arange(int(indptr[-1]), device=rows.device) - indptr[:-1][r]
    src = c.indptr[rows][r] + pos
    return Corpus(indptr, c.indices[src], c.data[src], c.terms,
                  c.vector_dim)
