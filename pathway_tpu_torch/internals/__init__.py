"""Host-side internals of the port: the OpenMetrics text of the metrics
registry."""
