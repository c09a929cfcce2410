"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``<name>/ref.py`` (plain), ``<name>/kernel.py`` (launch wrapper
of ``csrc/<name>.cu``) and ``<name>/ops.py`` (dispatch on the tensor's
device)."""
