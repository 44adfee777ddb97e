"""The paged §4.4 KV store of the PyTorch port: the store-once entry stream
(``paged``) and its cross-layer history indirection (``history``)."""
