"""The share of the window the engine spent on capacity steps (``grow``
sections: the entry buffers' doubling with their host mirror, and the
resident match stack's re-allocation when the row capacity steps); 0 when
the window's flushes (``drain`` sections) inserted (``insert``) and none
stepped.  Nothing to read from a program whose flusher is not timed."""

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine"
MOVES = "insert_vectors_per_s"
WORKLOADS = ["rcv1_ingest_440k_over"]


def read(records: dict):
    sec, window = records.get("sections", {}), records.get("window_s", 0.0)
    if window <= 0 or sec.get("drain", 0.0) <= 0 or sec.get("insert",
                                                             0.0) <= 0:
        return None
    return 100.0 * sec.get("grow", 0.0) / window
