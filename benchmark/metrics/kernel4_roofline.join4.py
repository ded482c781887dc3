"""Kernel 4's share of its roofline in one traced join of the sharded
index.

The least time is the join's int8 operations over the card's int8 peak:
n(n-1)/2 pairs x the term ranks two rows or more use x 2 (a multiply and
an add), the count ``kernel3_roofline`` takes, fixed by the inputs and not
by tiles, padding, panels or shards.  The kernel time is kernel 4's device
time summed over the cards (``ring_kernel`` instantiated with the matmul
job, ``csrc/score_bits.cu``; never kernel 3's score job), so the share is
of the four cards' peaks together.  The cards' power limit stands beside
it in ``device``.
"""

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "join_pairs_per_s"
WORKLOADS = ["rcv1_join_500k_mesh4"]


def kernel4_seconds(kernels_s: dict) -> float:
    return sum(v for k, v in kernels_s.items()
               if "ring_kernel" in k and "MatmulJob" in k)


def read(records: dict):
    prof, peaks = records.get("profile"), records.get("peaks")
    if not prof or not peaks:
        return None
    t = kernel4_seconds(prof["kernels_s"])
    if t <= 0:
        return None
    n = records["n_rows"]
    ops = n * (n - 1) / 2 * records["terms_used"] * 2
    return 100.0 * ops / peaks["int8"] / t
