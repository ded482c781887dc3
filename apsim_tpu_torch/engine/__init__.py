from .chunked import ChunkedAllPairs
from .engine import Engine, PendingInsert
from .output import OutputBatcher, PairResult, SimilarityOutput
