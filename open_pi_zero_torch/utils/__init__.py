"""Metrics, monitoring, rotation and image helpers (counterparts of the JAX
package's ``utils/metric.py``, ``utils/monitor.py`` and
``utils/geometry.py``, and of the OpenCV resize its env adapters call)."""
