"""The port's Hopper kernels, each beside its plain PyTorch version.

``build`` compiles ``csrc/*.cu`` at first use; ``ops`` holds the public
wrappers that dispatch on the tensor's device.  Importing this package
builds nothing and needs no CUDA.
"""
