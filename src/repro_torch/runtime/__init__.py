from .kv_cache import PagedKVCache
from .engine import ServingEngine, Request, RequestMetrics

__all__ = ["PagedKVCache", "ServingEngine", "Request", "RequestMetrics"]
