"""Host-side utilities of the port: the metric stream and input prefetch."""
