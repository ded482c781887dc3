"""The comparison that decides ``correct``.

Answers are keyed entries: an int64 key (one query's answer about one
corpus row) and a similarity.  The reference gives every entry at or above
``tau - band`` with its float64 value.  Against it:

  - ``missing``: reference entries at or above ``tau + band`` (and marked
    required) that the answers lack;
  - ``extra``: answers the reference does not hold, or holds below ``tau -
    band``, and answers given twice;
  - ``sim_gap``: the widest gap between an answer's similarity and the
    reference's.

Entries within ``band`` of ``tau`` may go either way: there two float64
sums in different orders can fall on either side of the threshold.
"""

from __future__ import annotations

import numpy as np

__all__ = ["compare", "LIMITS"]

# The limit of each number compared (PERF.md gives the readings each was
# set from): the pair counts are exact comparisons; the similarity gap
# lies between the port's float64 rescore and the float32 control.
LIMITS = {"missing": 0, "extra": 0, "sim_gap": 1e-10}
BAND = LIMITS["sim_gap"]


def compare(got_keys, got_sims, ref_keys, ref_sims, tau: float,
            band: float = BAND, required=None) -> dict:
    got_keys = np.asarray(got_keys, np.int64)
    got_sims = np.asarray(got_sims, np.float64)
    ref_keys = np.asarray(ref_keys, np.int64)
    ref_sims = np.asarray(ref_sims, np.float64)
    req = (np.ones(ref_keys.size, bool) if required is None
           else np.asarray(required, bool))
    order = np.argsort(ref_keys, kind="stable")
    rk, rs, rq = ref_keys[order], ref_sims[order], req[order]
    uniq, first = np.unique(got_keys, return_index=True)
    twice = got_keys.size - uniq.size
    gs = got_sims[first]
    if rk.size:
        pos = np.clip(np.searchsorted(rk, uniq), 0, rk.size - 1)
        found = rk[pos] == uniq
    else:
        pos = np.zeros(uniq.size, np.int64)
        found = np.zeros(uniq.size, bool)
    low = found & (rs[pos] < tau - band) if rk.size else found
    extra = int((~found).sum() + low.sum()) + int(twice)
    hit = np.zeros(rk.size, bool)
    hit[pos[found]] = True
    missing = int((~hit & rq & (rs >= tau + band)).sum())
    gap = (float(np.abs(gs[found] - rs[pos[found]]).max())
           if found.any() else 0.0)
    return {"missing": missing, "extra": extra, "sim_gap": gap,
            "answers": int(got_keys.size), "reference": int(rk.size)}
