"""Torch twins of the repository's ``examples/``: run each as
``python -m repro_torch.examples.<name> [--device cpu]`` (default: the
card)."""
