"""Kernel 3's share of its roofline in one traced join.

The least time is the join's int8 operations over the card's int8 peak:
n(n-1)/2 pairs x the term ranks two rows or more use x 2 (a multiply and
an add), a count fixed by the inputs and not by tiles, padding or panels.
The kernel time is the summed device time of kernel 3's ``__global__``
(``ring_kernel`` with the int8 score job, ``csrc/score_bits.cu``) in the
traced join.  The card's power limit stands beside it in ``device``.
"""

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "join_pairs_per_s"
WORKLOADS = ["rcv1_join_200k"]


def kernel3_seconds(kernels_s: dict) -> float:
    return sum(v for k, v in kernels_s.items()
               if "ring_kernel" in k and "Int8Op" in k)


def read(records: dict):
    prof, peaks = records.get("profile"), records.get("peaks")
    if not prof or not peaks:
        return None
    t = kernel3_seconds(prof["kernels_s"])
    if t <= 0:
        return None
    n = records["n_rows"]
    ops = n * (n - 1) / 2 * records["terms_used"] * 2
    return 100.0 * ops / peaks["int8"] / t
