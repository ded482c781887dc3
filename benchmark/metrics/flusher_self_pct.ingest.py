"""The share of the window the server's flusher spent on its own work:
its ``coalesce`` sections (queue pop, coalescing, cap slicing) and its
``emit`` sections (results to the sinks).  Summed, not taken as ``drain``
less ``insert``: a window's totals cut a drain and the insert inside it at
different edges, by up to one insert, more than this share itself.
Nothing to read from a program whose flusher is not timed."""

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "serve"
MOVES = "insert_vectors_per_s"
WORKLOADS = ["rcv1_ingest_440k_over"]


def read(records: dict):
    sec, window = records.get("sections", {}), records.get("window_s", 0.0)
    if window <= 0 or sec.get("drain", 0.0) <= 0 or "coalesce" not in sec:
        return None
    return 100.0 * (sec["coalesce"] + sec.get("emit", 0.0)) / window
