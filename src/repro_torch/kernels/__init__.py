"""Hand-written Hopper kernels of the PyTorch port, each beside its plain
PyTorch version in ``plain`` (re-exported by ``repro_torch.models.layers``).
``ops`` holds the one dispatch point per kernel; ``ref`` the oracles of
the JAX package's ``kernels/ref.py`` that the slice needs; ``build``
compiles ``csrc/`` on first use. Importing this package builds nothing."""
