"""The device's idle share of a traced stretch of the ingest traffic
(``trace_s`` seconds after the window)."""

from benchmark.metrics._read import idle_pct

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "insert_vectors_per_s"
WORKLOADS = ["rcv1_ingest_440k_over"]
read = idle_pct
