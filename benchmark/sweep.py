"""Find a stream cell's knee: offered rates rising, one set-up.

    python3 benchmark/sweep.py --workload <stream cell> --seed <n>
        --children 100,150,200 [--seconds 15]

For each children count, builds the cell's served index anew, offers
``children x 1000 / period_ms`` fresh vectors/s open loop, with no hold on
the backlog, for ``--seconds`` and drains.  Each phase prints one JSON
line: the offered and served rates, the backlog (sent less indexed) once a
second, the drain after the last send, flush sizes and how late the
generator ran.  A phase kept up when its drain took under 15 % of its
length.  Nothing is checked against the reference: the cells do that.
"""

from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path
               if os.path.abspath(p or os.getcwd()) != _HERE]
sys.path.insert(0, os.path.dirname(_HERE))

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.harness import now  # noqa: E402
from benchmark.stats import lateness  # noqa: E402
from benchmark.traffic._stream import (OpenLoop, Served, schedule,  # noqa
                                       sleep_until, snapshot)


def _phase(sv, children, period_ms, seconds, make):
    due = schedule(children, period_ms, now() + 0.05, seconds)
    gen = OpenLoop(due, make, sv.srv.insert_new_vectors)
    n_out0 = len(sv.sink.sizes)
    s0 = snapshot(sv.eng)
    gen.start()
    backlog = []
    while gen.is_alive():
        time.sleep(1.0)
        backlog.append(gen.sent - (int(sv.eng.n_rows) - s0["n_rows"]))
    gen.join()
    t_last = now()
    sv.srv.flush()
    t_done = now()
    s1 = snapshot(sv.eng)
    sizes = sv.sink.sizes[n_out0:]
    rec = {
        "children": children, "offered_per_s": children * 1e3 / period_ms,
        "seconds": seconds, "sends": int(due.size),
        "drain_s": t_done - t_last,
        "served_per_s": due.size / (t_done - s0["t"]),
        "kept_up": bool(t_done - t_last < 0.15 * seconds),
        "backlog_each_s": backlog,
        "outputs": len(sizes),
        "output_size_mean": float(np.mean(sizes)) if sizes else 0.0,
        "output_size_max": int(max(sizes)) if sizes else 0,
        "generator_late": lateness(gen.lateness(0, due.size)),
    }
    b = s1["stats"]["insert_batches"] - s0["stats"]["insert_batches"]
    v = s1["stats"]["vectors_indexed"] - s0["stats"]["vectors_indexed"]
    rec.update(flush_batch_mean=v / max(b, 1),
               indexed_per_s=(s1["n_rows"] - s0["n_rows"])
               / (t_done - s0["t"]))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--children", required=True,
                    help="children counts, comma separated")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    _, cell, config = harness.load_cell(spec, args.workload)
    ctx = harness.Ctx(args.workload, cell, config, args.seed, args.seconds,
                      False, "cuda")
    p = cell["params"]
    counts = [int(c) for c in args.children.split(",")]
    period = float(p["period_ms"])
    cap = int(config["max_flush_batch"])
    n_index = int(config["index_rows"])
    print(json.dumps({"device": harness.device_record(ctx, 1, 0)}),
          flush=True)
    for children in counts:
        t0 = now()
        n_fresh = 2 * cap + int(children * 1e3 / period * args.seconds) + 1
        sv = Served(ctx, n_index + n_fresh)
        vecs = sv.vectors(range(n_index, n_index + n_fresh))
        sent = sv.warm(lambda k: f"f{k}", vecs, cap)
        set_up = now() - t0

        def make(i, j, base=sent):
            return [(f"f{base + k}", vecs[base + k]) for k in range(i, j)]

        rec = _phase(sv, children, period, args.seconds, make)
        rec.update(peak_bytes=ctx.memory_peak(), setup_s=set_up)
        sv.close()
        del sv, vecs
        ctx.free()
        print(json.dumps(rec), flush=True)
        sleep_until(now() + 1.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
