"""repro_torch: the PyTorch and CUDA port of the GoFFish reproduction.

Subpackages mirror the JAX package's layout: ``gofs`` (graph containers,
generators, partitioners), ``core`` (graph blocks, programs, the engine),
``kernels`` (hand-written Hopper kernels with their plain versions) and
``algorithms`` (the paper's algorithms). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
