"""Metrics, monitoring, rotation, image helpers and module specs
(counterparts of the JAX package's ``utils/metric.py``,
``utils/monitor.py``, ``utils/geometry.py`` and ``utils/spec.py``, and of
the OpenCV resize its env adapters call)."""
