"""Quantized-linear entry point of the port (``repro.kernels.ops``).

A quantized weight is packed ONCE, when it is quantized or loaded, into
the layout the CUDA kernel reads (:class:`PackedWeight`): the JAX package
re-packs inside every call (``ops.py:98``), which per decode step would
move more bytes than the matmul itself. :func:`linear` dispatches on the
leaf type; :func:`~repro_torch.kernels.splitquant_matmul.splitquant_matmul`
then dispatches on the tensor's device (plain version on the CPU, the
CUDA kernel on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from ..core.quantize import dequantize
from ..core.splitquant import SplitQuantTensor, select_per_element
from .packing import pack_cids, pack_codes, unpack_cids, unpack_codes
from .splitquant_matmul import splitquant_matmul


@dataclasses.dataclass
class PackedWeight:
    """A (K, N) SplitQuant weight in the kernel's layout.

    ``qp`` (K·bits/8, N) uint8 codes packed along K, ``cp`` (K/4, N) uint8
    cluster ids, ``recip``/``shift`` (k, N) fp32 with ŵ = q·recip + shift.
    ``scale``/``zero`` (k,), or (k, N) per output column, are kept for
    the exact eq. (4) dequantization
    (:meth:`dequantize`), which is what the JAX package's
    ``dequantize_tree`` returns."""

    qp: torch.Tensor
    cp: torch.Tensor
    recip: torch.Tensor
    shift: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    k: int
    shape: tuple
    orig_dtype: torch.dtype

    def to(self, device) -> "PackedWeight":
        mv = {f: getattr(self, f).to(device)
              for f in ("qp", "cp", "recip", "shift", "scale", "zero")}
        return dataclasses.replace(self, **mv)

    def dequantize(self) -> torch.Tensor:
        q = unpack_codes(self.qp, self.bits)
        c = unpack_cids(self.cp)
        return dequantize(q, select_per_element(self.scale, c),
                          select_per_element(self.zero, c), self.orig_dtype)

    def unpack(self) -> SplitQuantTensor:
        """The SplitQuantTensor this weight was packed from: int8 codes and
        uint8 cluster ids of the original (K, N) shape, with its scales
        and zeros (what a checkpoint stores)."""
        return SplitQuantTensor(q=unpack_codes(self.qp, self.bits),
                                cid=unpack_cids(self.cp), scale=self.scale,
                                zero=self.zero, bits=self.bits, k=self.k,
                                orig_dtype=self.orig_dtype)

    def nbytes_packed(self) -> int:
        """Bytes the kernel layout holds on the device: packed codes, K/4
        cluster-id bytes (even at k = 1) and fp32 (k, N) ``recip`` /
        ``shift``. Not the deployed bytes a quantization report and the
        allocation count, which are the JAX package's
        (:meth:`SplitQuantTensor.nbytes_deployed`)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.qp, self.cp, self.recip, self.shift))


def dequant_constants(scale: torch.Tensor, zero: torch.Tensor, N: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster (k,) scale/zero, broadcast over the N columns, or
    per (cluster, column) (k, N) → (k, N) recip = 1/scale and
    shift = -zero/scale, so ŵ = q·recip + shift (the kernel reads (k, N)
    either way)."""
    if scale.dim() == 1:
        scale = scale.float()[:, None].expand(-1, N)
        zero = zero.float()[:, None].expand(-1, N)
    scale, zero = scale.float(), zero.float()
    return (1.0 / scale).contiguous(), (-zero / scale).contiguous()


def pack_for_kernel(sqt: SplitQuantTensor) -> PackedWeight:
    """Pack a 2-D SplitQuantTensor into the kernel layout (once)."""
    if sqt.q.ndim != 2:
        raise ValueError(f"kernel weights are 2-D (K, N), got {sqt.shape}")
    recip, shift = dequant_constants(sqt.scale, sqt.zero, sqt.q.shape[1])
    return PackedWeight(qp=pack_codes(sqt.q, sqt.bits).contiguous(),
                        cp=pack_cids(sqt.cid).contiguous(),
                        recip=recip, shift=shift,
                        scale=sqt.scale.float(), zero=sqt.zero.float(),
                        bits=sqt.bits, k=sqt.k, shape=tuple(sqt.q.shape),
                        orig_dtype=sqt.orig_dtype)


def linear(x: torch.Tensor, w: Union[torch.Tensor, PackedWeight], b=None):
    """Dense layer with transparent SplitQuant dispatch. x: (..., K)."""
    if isinstance(w, PackedWeight):
        lead = x.shape[:-1]
        y = splitquant_matmul(x.reshape(-1, x.shape[-1]), w.qp, w.cp,
                              w.recip, w.shift, bits=w.bits, k=w.k)
        y = y.reshape(*lead, w.shape[1])
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y
