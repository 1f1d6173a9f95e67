"""Kernels of the port: the SplitQuant dequant-matmul and the two slot-cache
attention kernels, each a CUDA kernel for Hopper beside its plain PyTorch
version. Importing this package builds nothing (see ``build``)."""
