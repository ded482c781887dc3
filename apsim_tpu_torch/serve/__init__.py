"""The serving stack on the PyTorch port: the in-process
``SimilarityServer`` (ingest queue, flusher, checkpoints), its
newline-JSON TCP front end ``RpcServer``, and the client library."""

from .server import SimilarityServer
from .rpc import RpcServer
from .client import ClientConnection, InteractiveClient
