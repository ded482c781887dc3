"""The share of the traced join's time in the engine's ``compact``
sections (``ops/tri_score.compact_bits``, one call a panel pair)."""

from benchmark.metrics._read import section_pct

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine"
MOVES = "join_pairs_per_s"
WORKLOADS = ["rcv1_join_200k"]


def read(records: dict):
    prof = records.get("profile")
    if not prof:
        return None
    return section_pct(prof["sections_s"], ["compact"], prof["window_s"])
