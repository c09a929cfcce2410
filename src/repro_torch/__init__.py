"""PyTorch/CUDA port of the SFS serving stack.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and numpy, never JAX and nothing of ``repro``.  Its entry points
run on the CUDA card unless the caller asks for the CPU.
"""
