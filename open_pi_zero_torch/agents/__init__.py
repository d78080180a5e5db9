"""Agents: the training workspace and closed-loop evaluation, with its env
adapters (counterparts of the JAX package's ``agents/train.py``,
``agents/eval.py`` and ``agents/env_adapter.py``)."""
