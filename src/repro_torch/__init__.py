"""PyTorch/CUDA port of the SkipOPU reproduction (``src/repro`` is the JAX
reference it is held against).

Subpackages mirror the reference's names: ``configs``, ``kernels`` (hand-written
Hopper kernels with their plain PyTorch versions), ``models``, ``core``,
``serve`` and ``launch``.  Entry points run on ``cuda`` unless the caller asks
for ``cpu``; a CPU tensor takes each kernel's plain version, a CUDA tensor
takes the kernel.
"""
