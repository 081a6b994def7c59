"""The flight recorder, copied from the JAX package: ``trace.Tracer``
(causal event tracing, off by default), ``metrics.Metrics`` (counters,
gauges and histograms keyed by node, and the derived per-run series),
``export`` and ``schema`` (JSONL and Chrome trace dumps, the schema
validator), ``probes`` (offline invariant passes over traces) and
``explain`` (the forensics CLI, ``python -m repro_torch.obs.explain
<trace.jsonl>``). Every module is a verbatim copy of the JAX package's,
held to it by a test; this package exports what the JAX one does."""

from .metrics import Metrics, derive_headline_series
from .probes import at_most_one_lease_holder
from .schema import SCHEMA_VERSION, validate_events, validate_jsonl
from .trace import Tracer

__all__ = [
    "Tracer", "Metrics", "derive_headline_series",
    "at_most_one_lease_holder", "SCHEMA_VERSION",
    "validate_events", "validate_jsonl",
]
