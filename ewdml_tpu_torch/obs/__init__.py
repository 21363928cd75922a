"""Observability (``ewdml_tpu/obs``): the clock, span tracing and metrics.

- ``clock``     the one monotonic clock of timers and trace timestamps
- ``trace``     span/instant/counter events in a preallocated ring buffer,
                flushed as one JSON-lines shard per process; a no-op unless
                ``--trace-dir`` (or ``EWDML_TRACE_DIR``) is set
- ``hist``      the fixed-log-bucket quantile histogram (p50/p95/p99)
- ``registry``  counters, gauges and histograms behind one ``snapshot()``
- ``health``    the run-health watchdog (NaN, spike, gradient explosion,
                stall), its ``health.jsonl`` and the abort exit code 76

The shard format is the JAX package's, so ``ewdml_tpu/obs/merge.py`` puts a
port shard and a JAX shard on one timeline. Live export, merge and reports
are later slices.
"""
