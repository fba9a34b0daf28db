"""The port's observability layer (the JAX package's ``obs/``, one-shot
half): one instrumentation spine for the merge pipeline.

- :mod:`~semantic_merge_tpu_torch.obs.spans` — nestable, thread-safe
  spans and events, emitted as ``.semmerge-events.jsonl`` and summarized
  into ``.semmerge-trace.json`` by the CLI ``Tracer``
  (:mod:`semantic_merge_tpu_torch.runtime.trace`);
- :mod:`~semantic_merge_tpu_torch.obs.metrics` — process-global
  counters, gauges and histograms; Prometheus text and JSON;
  ``SEMMERGE_METRICS=path`` exit dump;
- :mod:`~semantic_merge_tpu_torch.obs.device` — the device block: the
  card the merge ran on, transfers, allocated bytes, kernel builds;
- :mod:`~semantic_merge_tpu_torch.obs.flight` — the always-on span ring
  and its ``.semmerge-postmortem/<trace_id>.json`` bundles;
- :mod:`~semantic_merge_tpu_torch.obs.anomaly` — ``phase_diff`` for
  ``trace diff``.

The merge service's modules (OTLP export, sampling, aggregation, SLOs,
the perf sentinel) come with the service. Importing ``obs`` is stdlib
only: no torch, so every layer imports it at module top.
"""
from . import device, flight, metrics, spans  # noqa: F401
from .metrics import REGISTRY, registry  # noqa: F401
from .spans import (SpanRecorder, activate, activated, active,  # noqa: F401
                    current, deactivate, event, record, request_scope, span,
                    trace_id)
