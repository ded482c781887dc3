"""The device's idle share of one traced join."""

from benchmark.metrics._read import idle_pct

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "join_pairs_per_s"
WORKLOADS = ["rcv1_join_200k"]
read = idle_pct
