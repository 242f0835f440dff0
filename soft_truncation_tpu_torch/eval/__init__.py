"""Sample I/O of the PyTorch port."""
