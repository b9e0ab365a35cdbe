"""persist layer of the PyTorch port."""
