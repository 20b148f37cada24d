from .httpd import VCPRequestHandler, create_server, serve_forever
from .batching import BatchingQueue

__all__ = ["VCPRequestHandler", "create_server", "serve_forever", "BatchingQueue"]
