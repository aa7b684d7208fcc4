"""nn of the PyTorch port."""
