"""SplitQuant core of the port: quantizer, k-means and split tensors.
Model-level application lives in :mod:`repro_torch.core.apply` (it packs
for the kernels, so it is not imported here)."""
from .quantize import QuantConfig, dequantize, qparams, quantize, value_range
from .kmeans import kmeans_1d
from .splitquant import (SplitQuantTensor, activation_chunk_bounds,
                         assign_and_quantize, baseline_quant_tensor,
                         fit_centroids, splitquant_tensor)

__all__ = ["QuantConfig", "dequantize", "qparams", "quantize", "value_range",
           "kmeans_1d", "SplitQuantTensor", "activation_chunk_bounds",
           "assign_and_quantize", "baseline_quant_tensor", "fit_centroids",
           "splitquant_tensor"]
