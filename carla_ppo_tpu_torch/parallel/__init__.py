"""Data parallel over torch.distributed (see the package docstring)."""
