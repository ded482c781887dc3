"""Throttled, verified file transfer — the HDFSUploader analog.

The reference ships a distcp-style Spark job (etl/.../HDFSUploader.scala):
throttled copy at a bandwidth cap (:26, 8 MB/s), length + checksum
verification (:124-139), and an atomic final rename (:171-176).  The
rebuild's storage is local/NFS directories, so this is a plain threaded
copier with the same three guarantees.
"""

from __future__ import annotations

import hashlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

__all__ = ["throttled_copy", "copy_tree"]

_CHUNK = 1 << 20  # 1 MiB


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def throttled_copy(
    src: str, dst: str, max_bytes_per_sec: float = 8 * 1024 * 1024
) -> None:
    """Copy one file with a bandwidth cap, verify length + checksum, then
    atomically rename into place (HDFSUploader.scala:26,124-139,171-176)."""
    tmp = dst + "._COPYING_"
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    t0 = time.monotonic()
    copied = 0
    try:
        with open(src, "rb") as fin, open(tmp, "wb") as fout:
            while True:
                chunk = fin.read(_CHUNK)
                if not chunk:
                    break
                fout.write(chunk)
                copied += len(chunk)
                if max_bytes_per_sec > 0:
                    expected = copied / max_bytes_per_sec
                    elapsed = time.monotonic() - t0
                    if expected > elapsed:
                        time.sleep(expected - elapsed)
        if os.path.getsize(tmp) != os.path.getsize(src):
            raise IOError(f"length mismatch copying {src}")
        if _sha256(tmp) != _sha256(src):
            raise IOError(f"checksum mismatch copying {src}")
    except BaseException:
        # disk-full / read error / interrupt: never leave the partial
        # ._COPYING_ file behind (repeated failing runs would accumulate)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, dst)  # atomic


def copy_tree(
    src_root: str,
    dst_root: str,
    max_bytes_per_sec: float = 8 * 1024 * 1024,
    parallelism: int = 4,
) -> List[Tuple[str, str]]:
    """Parallel throttled copy of a directory tree (per-file cap).
    Returns the (src, dst) pairs copied."""
    jobs: List[Tuple[str, str]] = []
    for dirpath, _, filenames in os.walk(src_root):
        for name in filenames:
            s = os.path.join(dirpath, name)
            d = os.path.join(dst_root, os.path.relpath(s, src_root))
            jobs.append((s, d))
    with ThreadPoolExecutor(max_workers=parallelism) as pool:
        list(pool.map(lambda j: throttled_copy(*j, max_bytes_per_sec), jobs))
    return jobs
