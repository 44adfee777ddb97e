"""Lock-step serving of the PyTorch port."""
