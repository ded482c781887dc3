"""Corpus walking and document loading.

Reference parity: ``etl/src/main/scala/cpslab/etl/Utils.scala:10-23`` (recursive
file listing with ``.DS_Store`` skip) and
``PreprocessWithTFIDF.mapEachFileToSingleLine``
(PreprocessWithTFIDF.scala:21-43): each file becomes one whitespace-joined
string.  The reference's reader appends a literal ``"null "`` token at EOF (a
Scala while-loop quirk); we do NOT reproduce that (documented deviation — our
ETL output is the oracle input, so no bit-parity with Spark is required).
"""

from __future__ import annotations

import os
from typing import Iterator, List

__all__ = ["list_corpus_files", "read_document", "iter_documents"]


def list_corpus_files(root: str) -> List[str]:
    """Recursively list files under ``root``, skipping ``.DS_Store``
    (Utils.scala:10-23). Sorted for determinism (the reference's HDFS listing
    order is unspecified; we pin it)."""
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            if ".DS_Store" in name:
                continue
            out.append(os.path.join(dirpath, name))
    return out


def read_document(path: str) -> str:
    """One file -> one single-line string (PreprocessWithTFIDF.scala:21-43)."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return " ".join(line.rstrip("\n") for line in f)


def iter_documents(root: str) -> Iterator[tuple[str, str]]:
    """Yield (relative_path, single_line_content) for every corpus file."""
    for path in list_corpus_files(root):
        yield os.path.relpath(path, root), read_document(path)
