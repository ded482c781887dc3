"""Per-layer metrics: ``<metric>.py`` reads the metric of that name.

Each file declares ``UNIT``, ``BETTER``, ``SOURCE``, ``LAYER`` (as
PERF.md's list of layers names it), ``MOVES`` (the one end-to-end metric it
should move) and ``WORKLOADS`` (the cells in which it finds something to
read), and ``read(records)``: the value from the run's records, or None
when there is nothing to read (the harness then leaves it out).
"""
