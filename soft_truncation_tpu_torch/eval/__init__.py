"""Evaluation of the PyTorch port: the likelihood loops and sample I/O."""
