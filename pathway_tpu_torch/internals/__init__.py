"""Host-side internals of the port: the OpenMetrics text of the metrics
registry, the global error log and the backoff retry strategy."""
