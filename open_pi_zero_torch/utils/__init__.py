"""Metrics and monitoring helpers (counterpart of the JAX package's
``utils/metric.py`` and ``utils/monitor.py``)."""
