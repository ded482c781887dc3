"""Build a shared library from one source file, once per source content.

The package's compiled pieces (the host C++ rescore library and the CUDA
kernels) are built at first use into ``build/apsim_tpu_torch/`` beside the
package, named by a hash of the source and the compile command, so an edited
source or flag set rebuilds and an unchanged one loads at once.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

__all__ = ["build_dir", "build_shared_lib"]


def build_dir() -> str:
    """``<checkout>/build/apsim_tpu_torch`` (created on demand)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = os.path.join(os.path.dirname(pkg), "build", "apsim_tpu_torch")
    os.makedirs(out, exist_ok=True)
    return out


def build_shared_lib(
    src: str, cmd: list[str], timeout: float = 600.0
) -> tuple[str, str]:
    """Compile ``src`` with ``cmd + [src, "-o", <so>]`` unless a library
    built from the same source and command exists.  Returns ``(so_path,
    compiler_output)``; the output of a fresh build is also kept beside the
    library as ``<so>.log``.  Raises ``RuntimeError`` with the compiler's
    output when the build fails."""
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(cmd).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(build_dir(), f"{stem}_{h.hexdigest()[:16]}.so")
    # one build at a time across processes (the ranks of a multi-process
    # run start together): the others wait, then load what it built
    with open(os.path.join(build_dir(), ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_once(src, cmd, so, timeout)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_once(src: str, cmd: list[str], so: str,
                timeout: float) -> tuple[str, str]:
    log = so + ".log"
    if os.path.exists(so):
        if os.path.exists(log):
            with open(log, "r", encoding="utf-8") as f:
                return so, f.read()
        return so, ""
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(
        cmd + [src, "-o", tmp], capture_output=True, text=True,
        timeout=timeout,
    )
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"build of {src} failed ({' '.join(cmd)}):\n{out}"
        )
    with open(log, "w", encoding="utf-8") as f:
        f.write(out)
    os.replace(tmp, so)
    return so, out
