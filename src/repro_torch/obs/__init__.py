from repro_torch.obs.metrics import Counter, Gauge, MetricsRegistry, registry
from repro_torch.obs.trace import (Span, Tracer, disable, enable, enabled,
                                   get_tracer, span)
