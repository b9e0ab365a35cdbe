"""quant layer of the PyTorch port."""
