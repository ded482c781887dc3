from .sparse import DenseVector, SparseVector, Vectors, format_vector, parse_vector
from .batch import CSRMatrix, round_up
