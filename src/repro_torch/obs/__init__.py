"""The flight recorder's two pieces that the control plane runs:
``metrics.Metrics`` (counters, gauges and histograms keyed by node) and
``trace.Tracer`` (causal event tracing, off by default). Both files are
verbatim copies of the JAX package's, held to them by a test; its
exporters, schema, probes and forensics CLI are not copied."""

from .metrics import Metrics
from .trace import Tracer

__all__ = ["Metrics", "Tracer"]
