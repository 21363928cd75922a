"""Observability (``ewdml_tpu/obs``): the clock, span tracing and metrics.

- ``clock``     the one monotonic clock of timers and trace timestamps
- ``trace``     span/instant/counter events in a preallocated ring buffer,
                flushed as one JSON-lines shard per process; a no-op unless
                ``--trace-dir`` (or ``EWDML_TRACE_DIR``) is set
- ``hist``      the fixed-log-bucket quantile histogram (p50/p95/p99)
- ``registry``  counters, gauges and histograms behind one ``snapshot()``
- ``health``    the run-health watchdog (NaN, spike, gradient explosion,
                stall), its ``health.jsonl`` and the abort exit code 76
- ``serve``     the live ``/metrics`` (Prometheus text) and
                ``/metrics.json`` endpoint of one owner's registry; a no-op
                unless ``--metrics-port`` (or ``EWDML_METRICS_PORT``) is set
- ``merge``     cross-process shard alignment onto one timeline
- ``export``    shards -> Chrome-trace/Perfetto JSON with causal flows
- ``rounds``    the round critical-path analyzer (gating worker, segments)
- ``report``    ``python -m ewdml_tpu_torch.cli obs {report,export,rounds}``

The shard format is the JAX package's, so either package's ``merge``,
``export``, ``rounds`` and ``report`` read a port shard and a JAX shard
alike and give the same results.
"""
