"""The share of the traced join's time that compaction spends on the host:
the ``compact`` sections less the ``compact_sync`` calls nested in them
(each returns only once the device has caught up: the counts' ``tolist``
and every ``torch.nonzero`` of ``ops/tri_score.compact_bits``).  Nothing
to read from a program without ``compact_sync`` spans."""

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine"
MOVES = "join_pairs_per_s"
WORKLOADS = ["rcv1_join_200k"]


def read(records: dict):
    prof = records.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    sec = prof["sections_s"]
    if "compact" not in sec or "compact_sync" not in sec:
        return None
    return 100.0 * (sec["compact"] - sec["compact_sync"]) / prof["window_s"]
