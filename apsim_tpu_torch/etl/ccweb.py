"""CC_WEB_VIDEO feature-file parser.

Reference parity: ``CCWEBVideoLoadGenerator.lineParser``
(core/.../benchmark/CCWEBVideoLoadGenerator.scala:10-29): lines of the form
``(videoId,size,[v1,v2,...])`` where the bracketed list is a dense feature
vector; zero components are stripped to produce a sparse vector.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..vector.sparse import SparseVector

__all__ = ["parse_ccweb_line", "load_ccweb_file"]


def parse_ccweb_line(line: str) -> Tuple[str, SparseVector]:
    cleaned = (
        line.replace("(", "").replace(")", "").replace("[", "").replace("]", "")
    )
    parts = cleaned.split(",")
    video_id = parts[0]
    size = int(parts[1])
    feats = parts[2:]  # positional, not parts[-size:]: a list shorter than
    # ``size`` must fail loudly instead of pulling the id/size fields into
    # the float parse (and size=0 made parts[-0:] the WHOLE line)
    if len(feats) == 1 and feats[0] == "":
        feats = []
    if len(feats) != size:
        raise ValueError(
            f"ccweb line declares {size} features, carries {len(feats)}: "
            f"{line[:80]!r}"
        )
    values = np.array([float(x) for x in feats], dtype=np.float64)
    nz = np.nonzero(values)[0].astype(np.int32)
    return video_id, SparseVector(size, nz, values[nz])


def load_ccweb_file(path: str) -> List[Tuple[str, SparseVector]]:
    out: List[Tuple[str, SparseVector]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(parse_ccweb_line(line))
    return out
