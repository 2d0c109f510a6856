from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                                     registry)
from repro_torch.obs.trace import (Span, Tracer, disable, enable, enabled,
                                   get_tracer, span)

__all__ = [
    "Span", "Tracer", "span", "enable", "disable", "enabled", "get_tracer",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
]
