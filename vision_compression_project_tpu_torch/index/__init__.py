from .multivector import MultiVectorIndex
from .store import IndexStore, get_default_store
from .vector_index import VectorIndex

__all__ = ["IndexStore", "MultiVectorIndex", "VectorIndex", "get_default_store"]
