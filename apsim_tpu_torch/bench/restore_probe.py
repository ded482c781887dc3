"""Stage-timed chunked checkpoint save and restore at out-of-core scale.

The chunked engine checkpoints a host mirror of its per-chunk entry
buffers (the ``chunk_*`` arrays of ``ChunkedAllPairs._extra_npz``), so
``restore`` places the saved layout directly (read + host-to-device copy)
instead of re-running the unique / df-sort / remap / bucketing build
passes.  This probe times every stage (``gen``, ``build``, ``save``,
``restore``, ``spot_topk``) and asserts that (a) the fast path ran (the
restored engine's ``build`` raises) and (b) the restored engine answers a
spot top-k query identically to the built one; it prints one JSON line.

Usage:
    python -m apsim_tpu_torch.bench.restore_probe [n_rows] [--device cpu]

``n_rows`` defaults to 500,000; the device to the card (``cuda``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time


def main(argv=None) -> dict:
    import torch

    from ..config import AllPairsConfig
    from ..engine.chunked import ChunkedAllPairs
    from .scale import synthetic_corpus

    ap = argparse.ArgumentParser(prog="restore_probe")
    ap.add_argument("n_rows", type=int, nargs="?", default=500_000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    n_rows = args.n_rows
    stages = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        stages[name] = time.perf_counter() - t0
        print(f"{name:18s} {stages[name]:10.3f} s", flush=True)
        return out

    csr = stage("gen", lambda: synthetic_corpus(n_rows))
    eng = ChunkedAllPairs(AllPairsConfig(), dev)
    stage("build", lambda: eng.build(csr))
    q = [("q0", csr.row(0)), ("q1", csr.row(n_rows // 2))]
    want = eng.topk(q, 5)
    td = tempfile.mkdtemp(prefix="restore_probe_")
    try:
        ck = os.path.join(td, "ck")
        stage("save", lambda: eng.save(ck))
        npz_bytes = os.path.getsize(os.path.join(ck, "index.npz"))
        del eng
        e2 = ChunkedAllPairs(AllPairsConfig(), dev)

        def _no_rebuild(*a, **k):  # restore must take the fast path
            raise AssertionError("restore fell back to a full rebuild")

        e2.build = _no_rebuild
        stage("restore", lambda: e2.restore(ck))
    finally:
        shutil.rmtree(td, ignore_errors=True)
    assert e2._ent_host is not None and e2.n_rows == n_rows
    got = stage("spot_topk", lambda: e2.topk(q, 5))
    parity = {
        k: [i for i, _ in want[k]] == [i for i, _ in got[k]] for k in want
    }
    report = {
        "n_rows": n_rows,
        "device": str(dev),
        "stages_s": stages,
        "restore_over_build": stages["restore"] / stages["build"],
        "npz_bytes": npz_bytes,
        "fast_path": True,  # e2.build raises, so the placement ran
        "spot_parity": all(parity.values()),
    }
    print(json.dumps(report), flush=True)
    assert report["spot_parity"], parity
    return report


if __name__ == "__main__":
    main()
