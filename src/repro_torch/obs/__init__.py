# Observability (port of ``repro/obs``): the process tracer (a no-op until
# enabled) with its Chrome/Perfetto export, the metrics registry behind the
# serve engine's stats(), the controller's SearchReport, whose decision digest
# and provenance ride the v6 PolicyArtifact, and the cost-model calibration
# ratios the serve engine reports against an artifact's predictions.
from . import calibration, metrics, search, trace  # noqa: F401
from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .search import SearchReport, search_trace_report  # noqa: F401
from .trace import (NOOP_SPAN, Tracer, get_tracer,  # noqa: F401
                    validate_chrome_trace)
