"""Model layers of the PyTorch port (counterparts of ``repro.models``)."""
