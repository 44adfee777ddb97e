"""SkipGPT routing, KV reuse and routed blocks of the PyTorch port."""
