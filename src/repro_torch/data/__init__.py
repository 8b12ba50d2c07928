"""Data generators of the PyTorch port."""
