"""Data-sheet peaks of the cards the benchmark knows, keyed by the name
``torch.cuda.get_device_name`` gives.

NVIDIA H100 SXM, dense rates without sparsity, at the full 700 W power
limit: int8 ops/s, bf16 flop/s, fp64 flop/s on the tensor cores, fp32
flop/s outside them, HBM bytes/s.  A card the table does not list raises:
there is no default peak.
"""

from __future__ import annotations

__all__ = ["PEAKS", "card_peaks"]

H100_SXM = {"int8": 1979e12, "bf16": 989e12, "fp64": 67e12, "fp32": 67e12,
            "hbm": 3.35e12}
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def card_peaks(name: str) -> dict:
    """The peak rates of the card called ``name``; ``KeyError`` for a card
    ``PEAKS`` does not list."""
    try:
        return PEAKS[name]
    except KeyError:
        raise KeyError(
            f"no peak rates known for {name!r} (known: {sorted(PEAKS)})"
        ) from None
