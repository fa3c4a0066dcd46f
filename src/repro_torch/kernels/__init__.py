"""Hand-written Hopper kernels, their plain PyTorch versions and the
dispatch that chooses between them by device (see :mod:`.ops`)."""
