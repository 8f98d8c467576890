from .kv_cache import BlockPool, HostSpillTier
from .prefix_cache import PrefixCache
from .serving import (Request, RequestTrace, ServingConfig, ServingEngine,
                      ServingMetrics, model_draft_fn, repeated_traffic,
                      shared_prefix_traffic, synthetic_traffic)

__all__ = ["BlockPool", "HostSpillTier", "PrefixCache", "Request",
           "RequestTrace", "ServingConfig", "ServingEngine",
           "ServingMetrics", "model_draft_fn", "repeated_traffic",
           "shared_prefix_traffic", "synthetic_traffic"]
