"""MFU (model-FLOPs-utilization) accounting for the int8 join kernels on
the card (the counterpart of ``apsim_tpu/bench/mfu.py``).

Every throughput record carries ``int8_ops``, ``seconds`` and ``mfu_pct``
so its efficiency is auditable, not inferred.

Convention: the join semantically decides every padded pair once.  The
upper-triangle kernels do padded_rows^2/2 pair-dot products of length
``dim_cap`` at 2 ops (multiply+add) per int8 MAC, so

    int8_ops = padded_rows^2 * dim_cap          (the 1/2 and the 2 cancel)

The peak is the card's own, looked up by its name
(``torch.cuda.get_device_name``) in ``PEAKS``: dense rates without
sparsity from the vendor's data sheet, at the card's full power limit.  A
card the table does not know raises; there is no default peak.  MFU over a
wall time that includes compaction, D2H and the fp64 rescore is
END-TO-END utilization, not the kernel's alone.
"""

from __future__ import annotations

__all__ = ["H100_SXM", "PEAKS", "card_peaks", "int8_join_ops", "mfu_pct"]

# NVIDIA H100 SXM (data sheet, dense): int8 ops/s, bf16 flop/s, fp32 flop/s
# outside the tensor cores, HBM bytes/s
H100_SXM = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12}
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def card_peaks(name: str | None = None) -> dict:
    """The peak rates of the card called ``name`` (default: CUDA device 0's
    name).  Raises ``KeyError`` for a card ``PEAKS`` does not list."""
    if name is None:
        import torch

        name = torch.cuda.get_device_name(0)
    try:
        return PEAKS[name]
    except KeyError:
        raise KeyError(
            f"no peak rates known for {name!r} (known: {sorted(PEAKS)})"
        ) from None


def int8_join_ops(padded_rows: int, dim_cap: int) -> float:
    """int8 op count of one upper-triangle all-pairs join at padded size."""
    return float(padded_rows) * float(padded_rows) * float(dim_cap)


def mfu_pct(ops: float, seconds: float, peak: float) -> float:
    """Utilization of ``peak`` (ops/s, e.g. ``card_peaks()["int8"]``), as a
    percentage."""
    if seconds <= 0:
        return 0.0
    return 100.0 * ops / seconds / peak
