"""Quantized-linear entry point of the port (``repro.kernels.ops``).

A quantized weight is packed ONCE, when it is quantized or loaded, into
the layout the CUDA kernel reads (:class:`PackedWeight`): the JAX package
re-packs inside every call (``ops.py:98``), which per decode step would
move more bytes than the matmul itself. :func:`linear` dispatches on the
leaf type; :func:`~repro_torch.kernels.splitquant_matmul.splitquant_matmul`
then dispatches on the tensor's device (plain version on the CPU, the
CUDA kernel on the card). A MoE layer's experts are one stacked
``PackedWeight`` of E matrices, and :func:`grouped_linear` multiplies
each expert's rows by its matrix in one launch.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from ..core.quantize import dequantize
from ..core.splitquant import SplitQuantTensor, select_per_element
from .packing import pack_cids, pack_codes, unpack_cids, unpack_codes
from .splitquant_matmul import grouped_splitquant_matmul, splitquant_matmul


@dataclasses.dataclass
class PackedWeight:
    """A (K, N) SplitQuant weight in the kernel's layout, or a stack of E
    of them (E, K, N), quantized one by one (a MoE layer's experts).

    ``qp`` (K·bits/8, N) uint8 codes packed along K, ``cp`` (K/4, N) uint8
    cluster ids, ``recip``/``shift`` (k, N) fp32 with ŵ = q·recip + shift.
    ``scale``/``zero`` (k,), or (k, N) per output column, are kept for
    the exact eq. (4) dequantization
    (:meth:`dequantize`), which is what the JAX package's
    ``dequantize_tree`` returns. A stack puts E in front of each field;
    ``shape`` is then (E, K, N)."""

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

    @property
    def stack_dims(self) -> int:
        """1 for a stack of E matrices, else 0."""
        return len(self.shape) - 2

    def dequantize(self) -> torch.Tensor:
        q = unpack_codes(self.qp, self.bits)
        c = unpack_cids(self.cp)
        sd = self.stack_dims
        return dequantize(q, select_per_element(self.scale, c, sd),
                          select_per_element(self.zero, c, sd),
                          self.orig_dtype)

    def unpack(self) -> SplitQuantTensor:
        """The SplitQuantTensor this weight was packed from: int8 codes and
        uint8 cluster ids of the original (K, N) (or (E, K, N)) shape, with
        its scales and zeros (what a checkpoint stores)."""
        return SplitQuantTensor(q=unpack_codes(self.qp, self.bits),
                                cid=unpack_cids(self.cp), scale=self.scale,
                                zero=self.zero, bits=self.bits, k=self.k,
                                orig_dtype=self.orig_dtype,
                                stack_dims=self.stack_dims)

    def nbytes_packed(self) -> int:
        """Bytes the kernel layout holds on the device: packed codes, K/4
        cluster-id bytes (even at k = 1) and fp32 (k, N) ``recip`` /
        ``shift``. Not the deployed bytes a quantization report and the
        allocation count, which are the JAX package's
        (:meth:`SplitQuantTensor.nbytes_deployed`)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.qp, self.cp, self.recip, self.shift))


def dequant_constants(scale: torch.Tensor, zero: torch.Tensor, N: int,
                      stack_dims: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster (*stack, k) scale/zero, broadcast over the N columns,
    or per (cluster, column) (*stack, k, N) → (*stack, k, N)
    recip = 1/scale and shift = -zero/scale, so ŵ = q·recip + shift (the
    kernel reads (k, N) either way)."""
    if scale.dim() - stack_dims == 1:
        scale = scale.float()[..., None].expand(*scale.shape, N)
        zero = zero.float()[..., None].expand(*zero.shape, N)
    scale, zero = scale.float(), zero.float()
    return (1.0 / scale).contiguous(), (-zero / scale).contiguous()


def pack_for_kernel(sqt: SplitQuantTensor) -> PackedWeight:
    """Pack a 2-D SplitQuantTensor, or a stack of them (E, K, N), into the
    kernel layout (once)."""
    if sqt.q.ndim != 2 + sqt.stack_dims or sqt.stack_dims > 1:
        raise ValueError(f"kernel weights are (K, N) or a stack (E, K, N), "
                         f"got {sqt.shape} with {sqt.stack_dims} stack dims")
    recip, shift = dequant_constants(sqt.scale, sqt.zero, sqt.q.shape[-1],
                                     sqt.stack_dims)
    return PackedWeight(qp=pack_codes(sqt.q, sqt.bits).contiguous(),
                        cp=pack_cids(sqt.cid).contiguous(),
                        recip=recip, shift=shift,
                        scale=sqt.scale.float(), zero=sqt.zero.float(),
                        bits=sqt.bits, k=sqt.k, shape=tuple(sqt.q.shape),
                        orig_dtype=sqt.orig_dtype)


def linear(x: torch.Tensor, w: Union[torch.Tensor, PackedWeight], b=None):
    """Dense layer with transparent SplitQuant dispatch. x: (..., K); ``b``
    a tensor or a quantized bias (a 1-D :class:`SplitQuantTensor`, added
    dequantized, as the JAX package's ``ops.linear``)."""
    if isinstance(w, PackedWeight):
        lead = x.shape[:-1]
        y = splitquant_matmul(x.reshape(-1, x.shape[-1]), w.qp, w.cp,
                              w.recip, w.shift, bits=w.bits, k=w.k)
        y = y.reshape(*lead, w.shape[1])
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        if isinstance(b, SplitQuantTensor):     # a quantized bias: eq. (4)
            b = b.dequantize()
        y = y + b.to(y.dtype)
    return y


def grouped_linear(x_sorted: torch.Tensor, offsets: torch.Tensor,
                   w: PackedWeight) -> torch.Tensor:
    """Each expert's rows times its matrix: ``y[r] = x_sorted[r] · Ŵ_e``
    for r in ``[offsets[e], offsets[e+1])``. x_sorted (R, K) with the rows
    grouped by expert; offsets (E+1,) int32 on x's device (no host copy);
    ``w`` a stack (E, K, N). Returns (R, N) in x's dtype: the grouped
    kernel on the card, its plain version on the CPU."""
    if w.stack_dims != 1:
        raise ValueError(f"grouped_linear takes a stack of expert weights "
                         f"(E, K, N), got {w.shape}")
    return grouped_splitquant_matmul(x_sorted, offsets, w.qp, w.cp, w.recip,
                                     w.shift, bits=w.bits, k=w.k)
