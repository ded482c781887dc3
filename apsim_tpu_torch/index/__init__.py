from .compact import CompactSpace
