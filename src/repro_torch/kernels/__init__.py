"""Kernels of the port: the SplitQuant dequant-matmul, the two slot-cache
attention kernels with the KV quantize epilogue, the chunked RWKV6 WKV
and the two activation split-quantize kernels, each a CUDA kernel for
Hopper beside its plain PyTorch version. Importing this package builds
nothing (see ``build``)."""
