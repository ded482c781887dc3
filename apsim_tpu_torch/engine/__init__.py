from .engine import Engine
from .output import PairResult, SimilarityOutput
