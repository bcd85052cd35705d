"""Observability of the port: stats and /metrics, spans, query profiles,
the fragment heat map, kernel statistics and the telemetry sampler.

Trimmed copies of pilosa_tpu/utils/ (each module names its original); the
port imports nothing of pilosa_tpu, so what it needs lives here.
"""
