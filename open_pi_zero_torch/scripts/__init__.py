"""Command-line entry points of the port (``python -m
open_pi_zero_torch.scripts.<name>``)."""
