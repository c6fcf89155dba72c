"""Weight tools for the PyTorch port."""
