"""The per-layer metrics that read the program's flusher, capacity-step
and compaction-wait spans, each on hand-made records: a number where the
spans are there, nothing where the program lacks them."""

import pytest

from benchmark import harness


def read(metric, records):
    return harness.load_module("metrics", metric).read(records)


def join_records(sections, window_s=2.0):
    return {"profile": {"window_s": window_s, "busy_s": 1.0,
                        "sections_s": sections}}


def test_compact_host_is_compact_less_its_waits():
    rec = join_records({"all_pairs": 2.0, "compact": 0.8,
                        "compact_sync": 0.5, "kernel": 1.0})
    assert read("compact_host_pct.join", rec) == pytest.approx(15.0)
    # a program without compact_sync spans, or an untraced run
    assert read("compact_host_pct.join",
                join_records({"compact": 0.8})) is None
    assert read("compact_host_pct.join", {"profile": None}) is None


def test_grow_share_of_the_window():
    sec = {"tick_wait": 1.0, "drain": 8.0, "insert": 7.0, "grow": 0.25}
    rec = {"window_s": 10.0, "sections": sec}
    assert read("grow_pct.ingest", rec) == pytest.approx(2.5)
    del sec["grow"]  # inserts, and no capacity step in the window
    assert read("grow_pct.ingest", rec) == 0.0
    # a program whose flusher is not timed
    assert read("grow_pct.ingest", {"window_s": 10.0,
                                    "sections": {"insert": 7.0}}) is None
    assert read("grow_pct.ingest", {"window_s": 10.0,
                                    "sections": {"drain": 1.0}}) is None


def test_flusher_self_is_its_own_spans():
    rec = {"window_s": 10.0,
           "sections": {"drain": 8.0, "insert": 7.9, "coalesce": 0.2,
                        "emit": 0.3}}
    assert read("flusher_self_pct.ingest", rec) == pytest.approx(5.0)
    # a program whose flusher is not timed
    assert read("flusher_self_pct.ingest",
                {"window_s": 10.0, "sections": {"insert": 7.0}}) is None
    assert read("flusher_self_pct.ingest",
                {"window_s": 0.0, "sections": {"drain": 1.0,
                                               "coalesce": 0.1}}) is None
