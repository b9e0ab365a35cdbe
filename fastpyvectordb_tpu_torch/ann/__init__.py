"""ann layer of the PyTorch port."""
