"""The rate and tail arithmetic on hand-made samples."""

import math

import numpy as np
import pytest

from benchmark.stats import lateness, percentile, rate


def test_rate_is_all_work_over_all_time():
    assert rate(300, 2.0) == 150.0
    with pytest.raises(ValueError):
        rate(1, 0.0)


def test_percentile_matches_numpy_linear():
    a = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0]
    for q in (0, 25, 50, 95, 100):
        assert percentile(a, q) == pytest.approx(np.percentile(a, q))


def test_missing_samples_count_in_the_tail():
    a = [1.0] * 90 + [float("inf")] * 10
    assert math.isinf(percentile(a, 95))
    assert percentile(a, 50) == 1.0
    b = [1.0] * 99 + [float("inf")]
    assert percentile(b, 95) == 1.0


def test_lateness_in_ms():
    out = lateness([0.001, 0.002, 0.010])
    assert out["max_ms"] == pytest.approx(10.0)
    assert out["sends"] == 3
    assert lateness([])["sends"] == 0


def test_open_loop_holds_at_the_backlog_bound():
    """With ``room``, sends wait while it is 0, never exceed it, and their
    lateness counts from the end of the hold; without it, from due."""
    import threading
    import time

    from benchmark.harness import now
    from benchmark.traffic._stream import OpenLoop, schedule

    due = schedule(10, 10.0, now() + 0.02, 0.3)  # 1,000/s for 0.3 s
    sent, lock = [], threading.Lock()
    limit = {"free": 0}

    def send(batch):
        with lock:
            sent.extend(batch)
            limit["free"] -= len(batch)

    gen = OpenLoop(due, lambda i, j: list(range(i, j)), send,
                   lambda: limit["free"])
    gen.start()
    time.sleep(0.15)
    assert gen.sent == 0 and gen.holds == 1
    t_open = now()
    limit["free"] = 40
    time.sleep(0.05)
    assert gen.sent == 40
    limit["free"] = 10 ** 6
    gen.join(5.0)
    assert sent == list(range(due.size))
    late = gen.lateness(0, 40)
    assert (late >= 0).all() and late.max() < t_open - due[0]
    free = OpenLoop(due, lambda i, j: [], lambda b: None)
    assert np.array_equal(free.ready_at, due)
