"""Data helpers (counterpart of the JAX package's ``data/``): the dataset
statistics reader. The TF-free RLDS pipeline waits in ROADMAP.md queue 1,
item 10."""
