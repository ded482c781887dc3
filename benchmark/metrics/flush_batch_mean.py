"""Vectors a flush hands the engine, on average over the window
(``stats["vectors_indexed"]`` over ``stats["insert_batches"]``)."""

UNIT = "vectors"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "serve"
MOVES = "insert_vectors_per_s"
WORKLOADS = ["rcv1_ingest_440k_over"]


def read(records: dict):
    if records.get("batches", 0) <= 0:
        return None
    return records["vectors"] / records["batches"]
