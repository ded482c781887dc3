"""Dense-index device ops as torch ops (counterpart of
``apsim_tpu/ops/score.py``, the parts the batch join uses).

The index is a dense ``[row_cap, dim_cap]`` matrix over compact columns (see
``index/compact.py``) that lives on an explicit device.  Sparse rows reach it
as the flat packed COO of ``vector.batch.pack_coo_i32``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["new_index_matrix", "scatter_coo", "capb_for", "MIN_TAU_EFF"]

# floor for the device threshold: keeps all-zero (padded/invalid) rows out of
# the candidate set without any index arithmetic in the score epilogue
MIN_TAU_EFF = 1e-30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def capb_for(cap: int, group: int) -> int:
    """Level-1 group capacity implied by a pair cap (the JAX package's
    formula, kept for the streaming paths' fixed-capacity buffers)."""
    return max(cap // group, 1024)


def new_index_matrix(
    row_cap: int, dim_cap: int, dtype: str, device: torch.device | str
) -> torch.Tensor:
    return torch.zeros((row_cap, dim_cap), dtype=_DTYPES[dtype], device=device)


def scatter_coo(x: torch.Tensor, coo: np.ndarray) -> torch.Tensor:
    """Write the entries of ONE packed ``[3, ecap]`` int32 COO array (rows /
    cols / fp32 value bits) into ``x`` in place and return it.

    Padding entries carry ``row == row_cap``: XLA's scatter drops them
    silently, torch's ``index_put_`` raises on out-of-bounds indices, so they
    are filtered first.  The caller guarantees unique (row, col) entries that
    land on zeros (a fresh index), so a plain assignment equals the JAX
    package's ``.add(unique_indices=True)``."""
    c = torch.from_numpy(coo).to(x.device)
    keep = c[0] < x.shape[0]
    rows = c[0][keep].long()
    cols = c[1][keep].long()
    vals = c[2][keep].view(torch.float32).to(x.dtype)
    x.index_put_((rows, cols), vals)
    return x
