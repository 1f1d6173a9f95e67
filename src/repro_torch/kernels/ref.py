"""Plain PyTorch versions of the fused SplitQuant dequant-matmul (port of
``repro.kernels.ref``): what the CUDA kernel computes, written with
whole-tensor ops. The CPU path runs these; on the card they are only the
yardstick the kernel is held to."""
from __future__ import annotations

import torch

from .packing import unpack_cids, unpack_codes


def dequant_weight_ref(q_packed, cid_packed, recip, shift, bits: int,
                       dtype=torch.float32) -> torch.Tensor:
    """Ŵ[k, n] = q[k, n] * recip[cid[k, n], n] + shift[cid[k, n], n],
    computed in fp32 (a separate multiply and add) and rounded to
    ``dtype``."""
    q = unpack_codes(q_packed, bits).float()                    # (K, N)
    cid = unpack_cids(cid_packed).long()                        # (K, N)
    w = q * torch.gather(recip, 0, cid) + torch.gather(shift, 0, cid)
    return w.to(dtype)


def splitquant_matmul_ref(x, q_packed, cid_packed, recip, shift,
                          bits: int) -> torch.Tensor:
    """Fused form: y = x · Ŵ with Ŵ rounded to x.dtype, accumulated in
    fp32, returned in x.dtype. x: (M, K)."""
    w = dequant_weight_ref(q_packed, cid_packed, recip, shift, bits,
                           dtype=x.dtype)
    if x.dtype == torch.float32:
        return x @ w
    return (x.float() @ w.float()).to(x.dtype)
