"""The port's ETL (``apsim_tpu_torch.etl``) on the CPU: the ten cases of
``tests/test_etl.py`` on the port's modules, then the port against the JAX
package's ``apsim_tpu.etl`` on the same seeded documents: ``hashing_tf``,
``tfidf_pipeline`` and ``top_dim_filter`` on both hashing paths (the native
tokenizer and the pure-Python one), and vector-store tables written by
either package read by the other.

Tolerances: none; every array equals the JAX package's exactly.
"""

import os

import numpy as np
import pytest

import apsim_tpu.etl as jetl
import apsim_tpu.native as jnative
import apsim_tpu_torch.native as pnative
from apsim_tpu.vector.batch import CSRMatrix as JaxCSR
from apsim_tpu_torch.etl.ccweb import parse_ccweb_line
from apsim_tpu_torch.etl.corpus import (iter_documents, list_corpus_files,
                                        read_document)
from apsim_tpu_torch.etl.store import (VectorStore, load_text_vectors,
                                       save_text_vectors, split_load_range)
from apsim_tpu_torch.etl.tfidf import (apply_idf, hashing_tf, idf_weights,
                                       tfidf_pipeline, top_dim_filter)
from apsim_tpu_torch.etl.transfer import copy_tree
from apsim_tpu_torch.vector.batch import CSRMatrix
from apsim_tpu_torch.vector.sparse import Vectors

import apsim_tpu_torch.etl as petl


@pytest.fixture
def corpus_dir(tmp_path):
    (tmp_path / "a" / "inbox").mkdir(parents=True)
    (tmp_path / "b").mkdir()
    (tmp_path / "a" / "inbox" / "1.").write_text("hello world\nsecond line")
    (tmp_path / "a" / "inbox" / ".DS_Store").write_text("junk")
    (tmp_path / "b" / "2.").write_text("hello again")
    return str(tmp_path)


# ------------------------------------------- the cases of tests/test_etl.py
def test_corpus_walk(corpus_dir):
    files = list_corpus_files(corpus_dir)
    assert len(files) == 2  # .DS_Store skipped (Utils.scala:19)
    assert all(".DS_Store" not in f for f in files)
    doc = read_document(files[0])
    assert doc == "hello world second line"  # one line per file
    docs = dict(iter_documents(corpus_dir))
    assert set(docs) == {os.path.join("a", "inbox", "1."),
                         os.path.join("b", "2.")}


def test_hashing_tf_counts():
    tf = hashing_tf(["a b a", "b c"], num_features=1 << 12)
    assert tf.n_rows == 2
    assert sorted(tf.row(0).values.tolist()) == [1.0, 2.0]
    assert tf.row(1).nnz == 2


def test_idf_formula():
    tf = hashing_tf(["a", "a b"], num_features=1 << 12)
    idf = idf_weights(tf)
    # df(a)=2, df(b)=1, m=2 -> idf(a)=log(3/3)=0, idf(b)=log(3/2)
    vals = apply_idf(tf, idf)
    nonzero = vals.data[vals.data > 0]
    np.testing.assert_allclose(nonzero, [np.log(3.0 / 2.0)])


def test_tfidf_pipeline_normalized():
    csr = tfidf_pipeline(["x y z", "x q"], num_features=1 << 12)
    for n in csr.row_norms():
        assert n == pytest.approx(1.0) or n == 0.0


def test_top_dim_filter():
    csr = CSRMatrix.from_vectors(
        [Vectors.sparse(6, [0, 1], [5.0, 1.0]),
         Vectors.sparse(6, [1, 2], [2.0, 9.0])], 6,
    )
    f = top_dim_filter(csr, 2)  # dim2 (9) and dim0 (5)
    assert set(f.indices.tolist()) == {0, 2}
    assert f.n_rows == 2
    assert top_dim_filter(csr, 100) is csr


def test_text_store_roundtrip(tmp_path):
    csr = CSRMatrix.from_vectors(
        [Vectors.sparse(8, [1, 5], [0.25, 1.5]),
         Vectors.sparse(8, [0], [2.0])], 8
    )
    p = str(tmp_path / "vecs.txt")
    save_text_vectors(p, csr)
    back = load_text_vectors(p)
    assert back.n_rows == 2
    np.testing.assert_allclose(back.data, csr.data)
    np.testing.assert_array_equal(back.indices, csr.indices)


def test_vector_store(tmp_path):
    store = VectorStore(str(tmp_path / "store"))
    csr = CSRMatrix.from_vectors(
        [Vectors.sparse(8, [i], [float(i + 1)]) for i in range(5)], 8
    )
    store.write("SMALL_DATA", csr, ids=[f"v{i}" for i in range(5)])
    assert store.tables() == ["SMALL_DATA"]
    full, ids = store.read("SMALL_DATA")
    assert full.n_rows == 5 and ids[3] == "v3"
    part, pids = store.load_range("SMALL_DATA", 1, 3)  # inclusive
    assert part.n_rows == 3 and pids == ["v1", "v2", "v3"]
    np.testing.assert_array_equal(part.row(0).indices, [1])
    assert store.max_weights("SMALL_DATA")[4] == 5.0
    empty, eids = store.load_range("SMALL_DATA", 4, 2)
    assert empty.n_rows == 0 and eids == []


def test_split_load_range():
    ranges = split_load_range(0, 9, 3)
    assert ranges[0] == (0, 2)
    assert ranges[-1][1] == 9
    covered = [x for s, e in ranges for x in range(s, e + 1)]
    assert covered == list(range(10))
    assert split_load_range(0, 1, 5) == [(0, 0), (1, 1)]


def test_ccweb_parser():
    vid, vec = parse_ccweb_line("(773,4,[0.0,1.5,0.0,2.5])")
    assert vid == "773"
    assert vec.size == 4
    np.testing.assert_array_equal(vec.indices, [1, 3])
    np.testing.assert_allclose(vec.values, [1.5, 2.5])


def test_run_mode_debug_text_tables(tmp_path):
    vecs = [Vectors.sparse(10, [1, 3], [0.6, 0.8]),
            Vectors.sparse(10, [2], [1.0])]
    csr = CSRMatrix.from_vectors(vecs, 10)
    st = VectorStore(str(tmp_path / "dbg"), run_mode="DEBUG")
    st.write("t", csr)
    assert (tmp_path / "dbg" / "t" / "vectors.txt").exists()
    st2 = VectorStore(str(tmp_path / "prod"), run_mode="PRODUCT")
    st2.write("t", csr)
    assert not (tmp_path / "prod" / "t" / "vectors.txt").exists()
    d = tmp_path / "dbg" / "hand"
    os.makedirs(d)
    (d / "vectors.txt").write_text("(10,[1,3],[0.6,0.8])\n(10,[2],[1.0])\n")
    got, ids = st.read("hand")
    assert got.n_rows == 2 and ids == ["0", "1"]
    sub, sids = st.load_range("hand", 1, 1)
    assert sub.n_rows == 1 and sids == ["1"]


# ------------------------------------------- the port against the JAX package
WORDS = [f"w{i}" for i in range(400)] + ["naïve", "café", "x\ty", ""]


def documents(n=300, seed=5):
    """Seeded documents: Zipf-ish words, mixed whitespace, some unicode,
    a few empty documents and exact duplicates."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        k = int(rng.integers(0, 60))
        idx = np.minimum(rng.zipf(1.3, size=k) - 1, len(WORDS) - 1)
        seps = rng.choice([" ", "  ", "\n", "\t"], size=k)
        docs.append("".join(WORDS[j] + s for j, s in zip(idx, seps)))
    docs += docs[:10]
    return docs


def assert_csr_equal(p, j):
    assert (p.n_rows, p.n_cols) == (j.n_rows, j.n_cols)
    for a, b in ((p.indptr, j.indptr), (p.indices, j.indices),
                 (p.data, j.data)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(params=["native", "python"])
def hashing_path(request, monkeypatch):
    """Both packages on one hashing path: the native tokenizer, or (its
    library hidden) the pure-Python one."""
    if request.param == "native":
        assert pnative.hash_corpus(["a b"], 16) is not None
        assert jnative.hash_corpus(["a b"], 16) is not None
    else:
        monkeypatch.setattr(pnative, "hash_corpus", lambda *a: None)
        monkeypatch.setattr(jnative, "hash_corpus", lambda *a: None)
    return request.param


@pytest.mark.parametrize("nf", [1 << 10, 1 << 20])
def test_hashing_and_tfidf_equal_jax(hashing_path, nf):
    docs = documents()
    assert_csr_equal(hashing_tf(docs, nf), jetl.hashing_tf(docs, nf))
    for norm in (True, False):
        p = tfidf_pipeline(docs, nf, normalize=norm)
        j = jetl.tfidf_pipeline(docs, nf, normalize=norm)
        assert_csr_equal(p, j)
    for keep in (0, 5, 60, nf):
        assert_csr_equal(top_dim_filter(p, keep),
                         jetl.top_dim_filter(j, keep))


def test_native_and_python_paths_agree(monkeypatch):
    docs = documents(seed=9)
    native = hashing_tf(docs, 1 << 16)
    monkeypatch.setattr(pnative, "hash_corpus", lambda *a: None)
    assert_csr_equal(hashing_tf(docs, 1 << 16), native)
    for blob in (b"", b"abc", "naïve".encode(), bytes(range(256))):
        import zlib

        assert pnative.crc32(blob) == zlib.crc32(blob) == jnative.crc32(blob)


@pytest.mark.parametrize("run_mode", ["DEBUG", "PRODUCT"])
@pytest.mark.parametrize("writer", ["pt", "jax"])
def test_store_tables_read_across_packages(tmp_path, writer, run_mode):
    """A table written by either package reads in the other: the same CSR,
    ids, ``_MAX`` statistic and row ranges, and the same text mirror."""
    docs = documents(seed=3)
    ids = [f"doc/{i}" for i in range(len(docs))]
    csr = jetl.tfidf_pipeline(docs, 1 << 12)
    w_store = (VectorStore if writer == "pt" else jetl.VectorStore)(
        str(tmp_path), run_mode=run_mode)
    if writer == "pt":
        w_store.write("T", CSRMatrix(csr.n_rows, csr.n_cols, csr.indptr,
                                     csr.indices, csr.data), ids)
    else:
        w_store.write("T", csr, ids)
    p_store = VectorStore(str(tmp_path), run_mode=run_mode)
    j_store = jetl.VectorStore(str(tmp_path), run_mode=run_mode)
    (pc, pids), (jc, jids) = p_store.read("T"), j_store.read("T")
    assert pids == jids == ids
    assert_csr_equal(pc, jc)
    assert_csr_equal(pc, csr)
    assert np.array_equal(p_store.max_weights("T"), j_store.max_weights("T"))
    for s, e in ((0, 9), (17, 40), (len(docs) - 3, len(docs) + 5)):
        (pp, pi), (jp, ji) = p_store.load_range("T", s, e), j_store.load_range(
            "T", s, e)
        assert pi == ji
        assert_csr_equal(pp, jp)
    if run_mode == "DEBUG":
        path = str(tmp_path / "T" / "vectors.txt")
        assert_csr_equal(load_text_vectors(path), jetl.load_text_vectors(path))
        other = str(tmp_path / "other.txt")
        save_text_vectors(other, pc)
        jetl.save_text_vectors(str(tmp_path / "j.txt"), jc)
        with open(path) as a, open(other) as b, open(
                str(tmp_path / "j.txt")) as c:
            assert a.read() == b.read() == c.read()


def test_copy_tree_and_package_exports(tmp_path, corpus_dir):
    pairs = copy_tree(corpus_dir, str(tmp_path / "copy"), 0, 2)
    assert len(pairs) == 3
    for s, d in pairs:
        with open(s, "rb") as a, open(d, "rb") as b:
            assert a.read() == b.read()
    assert set(petl.__dict__) >= {"VectorStore", "tfidf_pipeline",
                                  "iter_documents", "load_ccweb_file"}
    assert isinstance(jetl.hashing_tf(["a"], 8), JaxCSR)
