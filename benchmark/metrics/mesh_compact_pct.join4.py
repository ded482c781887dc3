"""The share of the traced join's time in the engine's ``compact``
sections: kernel 7 on every card over its row slice, then the lists
crossing to the lead card (``ops/panel_mesh.pair_candidates``, one a
panel pair)."""

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
    return section_pct(prof["sections_s"], ["compact"], prof["window_s"])
