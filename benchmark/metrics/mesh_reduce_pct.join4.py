"""The share of the traced join's time in the engine's ``reduce`` sections:
each card receiving its row slice of the other cards' int32 partials
(``collectives.gather_rows``, one call a panel pair)."""

from benchmark.metrics._read import section_pct

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine"
MOVES = "join_pairs_per_s"
WORKLOADS = ["rcv1_join_500k_mesh4"]


def read(records: dict):
    prof = records.get("profile")
    if not prof:
        return None
    return section_pct(prof["sections_s"], ["reduce"], prof["window_s"])
