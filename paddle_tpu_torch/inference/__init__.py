from .kv_cache import BlockPool
from .serving import (Request, RequestTrace, ServingConfig, ServingEngine,
                      ServingMetrics, synthetic_traffic)

__all__ = ["BlockPool", "Request", "RequestTrace", "ServingConfig",
           "ServingEngine", "ServingMetrics", "synthetic_traffic"]
