"""engine of the PyTorch port."""
