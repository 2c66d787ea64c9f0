"""Program IR, op registry, interpreter and executor of the PyTorch port."""
