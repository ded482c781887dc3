"""Kernel 5's share of the HBM bandwidth in one traced join of the sharded
index.

Each card runs kernel 5 once a panel pair over its row slice of the
pair's ``rb x rb`` rectangle (the slices cover the ``rb`` rows once).  It
reads its rows of every shard's int32 partial and the aux rows (its
slice's α, α·L1(q), nnz and the whole column side's, f32 x 3 each), and
writes the group bits (one byte a column per 8 rows), the super bits (one
a column per 64 rows) and three int64 counts.  Over the cards and the
join's pairs those bytes, over the card's HBM peak, over kernel 5's device
time summed over the cards (``pair_bits_kernel`` with the int8 bound; not
kernel 6's threshold) give the share.
"""

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "join_pairs_per_s"
WORKLOADS = ["rcv1_join_500k_mesh4"]


def kernel5_seconds(kernels_s: dict) -> float:
    return sum(v for k, v in kernels_s.items()
               if "pair_bits_kernel" in k and "BoundAdmit" in k)


def pair_bytes(rb: int, shards: int, cards: int) -> int:
    """Kernel 5's bytes over every card for one ``rb``-row panel pair."""
    partials = 4 * shards * rb * rb
    aux = 12 * rb + 12 * rb * cards
    bits = rb * rb // 8 + rb * rb // 64 + 24 * cards
    return partials + aux + bits


def read(records: dict):
    prof, peaks = records.get("profile"), records.get("peaks")
    if not prof or not peaks or not records.get("panel_rows"):
        return None
    t = kernel5_seconds(prof["kernels_s"])
    if t <= 0:
        return None
    b = records["panel_pairs"] * pair_bytes(
        records["panel_rows"], records["n_shards"], records["n_cards"])
    return 100.0 * b / peaks["hbm"] / t
