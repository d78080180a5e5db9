"""Agents: the training workspace (counterpart of the JAX package's
``agents/train.py``)."""
