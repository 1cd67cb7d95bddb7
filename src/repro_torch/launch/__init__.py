"""Entry points of the PyTorch port (``python -m repro_torch.launch.serve``)."""
