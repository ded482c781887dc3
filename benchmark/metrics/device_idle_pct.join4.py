"""The cards' mean idle share of one traced join of the sharded index
(``profile_cards``: ``busy_s`` is the mean of the cards' busy times)."""

from benchmark.metrics._read import idle_pct

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "join_pairs_per_s"
WORKLOADS = ["rcv1_join_500k_mesh4"]
read = idle_pct
