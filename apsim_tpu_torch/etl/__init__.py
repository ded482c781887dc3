"""Host-only ETL (copies of ``apsim_tpu/etl/``): corpus walking, hashing
TF-IDF, the directory-backed vector store, the CC_WEB_VIDEO parser and the
throttled file transfer."""

from .corpus import iter_documents, list_corpus_files, read_document
from .tfidf import (DEFAULT_NUM_FEATURES, apply_idf, hashing_tf, idf_weights,
                    tfidf_pipeline, top_dim_filter)
from .store import VectorStore, load_text_vectors, save_text_vectors, split_load_range
from .ccweb import load_ccweb_file, parse_ccweb_line
