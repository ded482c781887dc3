"""Pairs found over the candidates the int8 bound handed to the float64
rescore (``stats["candidates_scored"]``), over the window's joins: how
much of the candidate list was useful."""

UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "rescore"
MOVES = "join_pairs_per_s"
WORKLOADS = ["rcv1_join_200k"]


def read(records: dict):
    if records.get("candidates", 0) <= 0:
        return None
    return 100.0 * records["pairs"] / records["candidates"]
