"""The share of the window the engine spent in the streaming match's
``product`` and ``slabs`` sections (the batch's products against the index,
and the slabs they read densified)."""

from benchmark.metrics._read import section_pct

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine"
MOVES = "insert_vectors_per_s"
WORKLOADS = ["rcv1_ingest_440k_over"]


def read(records: dict):
    return section_pct(records.get("sections", {}), ["product", "slabs"],
                       records.get("window_s", 0.0))
