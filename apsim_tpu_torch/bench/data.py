"""Benchmark corpus loading with on-disk caching.

The Enron ``maildir_small`` slice shipped with the reference
(data/maildir_small, 8,586 docs — mounted by docker/bin/start-cluster.sh) is
the benchmark corpus.  TF-IDF featurization is cached as npz (under the
repository's ``build/`` directory) so bench runs don't re-tokenize.  A copy
of ``apsim_tpu/bench/data.py`` without its default corpus path: the corpus
is not in the repository, so the caller names its root.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..etl.corpus import iter_documents
from ..etl.tfidf import tfidf_pipeline
from ..utils.build import build_dir
from ..vector.batch import CSRMatrix

__all__ = ["load_enron_tfidf"]


def load_enron_tfidf(
    corpus_root: str,
    cache_dir: str | None = None,
    normalize: bool = True,
) -> Tuple[CSRMatrix, List[str]]:
    cache_dir = cache_dir or os.path.join(build_dir(), "apsim_bench")
    os.makedirs(cache_dir, exist_ok=True)
    tag = corpus_root.strip("/").replace("/", "_") + (
        "_norm" if normalize else "_raw"
    )
    path = os.path.join(cache_dir, f"tfidf_{tag}.npz")
    if os.path.exists(path):
        z = np.load(path, allow_pickle=False)
        ids = [s for s in z["ids"].tolist()]
        csr = CSRMatrix(
            int(z["shape"][0]), int(z["shape"][1]),
            z["indptr"], z["indices"], z["data"],
        )
        return csr, ids
    ids: List[str] = []
    docs: List[str] = []
    for relpath, content in iter_documents(corpus_root):
        ids.append(relpath)
        docs.append(content)
    csr = tfidf_pipeline(docs, normalize=normalize)
    # tmp + os.replace: an interrupted run must not leave a truncated npz
    # that poisons every later load (same pattern as etl/store.py)
    tmp = path + ".tmp.npz"  # .npz suffix: savez would append it otherwise
    np.savez_compressed(
        tmp,
        indptr=csr.indptr,
        indices=csr.indices,
        data=csr.data,
        shape=np.array([csr.n_rows, csr.n_cols], np.int64),
        ids=np.array(ids),
    )
    os.replace(tmp, path)
    return csr, ids
