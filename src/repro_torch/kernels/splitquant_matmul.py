"""Fused SplitQuant dequant-matmul: the wrapper of the CUDA kernel
``csrc/splitquant_matmul.cu`` (which replaces the Pallas TPU kernel
``repro/kernels/splitquant_matmul.py:_kernel``) and its dispatch.

On a CPU tensor the wrapper runs the plain version
(:func:`~repro_torch.kernels.ref.splitquant_matmul_ref`); on a CUDA
tensor it launches the kernel or raises. ``splitquant_matmul.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from . import build
from .ref import splitquant_matmul_ref

#: fp32 partial-sum splits of K are added only when the (M, N) grid alone
#: would give fewer blocks than this many per SM
_BLOCKS_PER_SM = 2
_BM, _BN, _BK = 8, 128, 64


def k_splits(M: int, K: int, N: int, sms: int) -> int:
    """How many K slices the kernel's grid uses for an (M, K, N) product."""
    blocks = -(-M // _BM) * -(-N // _BN)
    want = -(-_BLOCKS_PER_SM * sms // blocks)
    return max(1, min(want, -(-K // _BK)))


def splitquant_matmul(x: torch.Tensor, q_packed: torch.Tensor,
                      cid_packed: torch.Tensor, recip: torch.Tensor,
                      shift: torch.Tensor, *, bits: int, k: int = 3
                      ) -> torch.Tensor:
    """y = x · Ŵ. x: (M, K) bf16/fp32; q_packed (K·bits/8, N) uint8;
    cid_packed (K/4, N) uint8; recip/shift (k, N) fp32. Returns (M, N) in
    x.dtype."""
    if x.device.type == "cpu":
        return splitquant_matmul_ref(x, q_packed, cid_packed, recip, shift,
                                     bits)
    M, K = x.shape
    N = q_packed.shape[1]
    per = 8 // bits
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if K % 4 or q_packed.shape[0] * per != K or \
            cid_packed.shape != (K // 4, N):
        raise ValueError(f"packed weight {tuple(q_packed.shape)}/"
                         f"{tuple(cid_packed.shape)} does not match K={K}")
    if recip.shape != (k, N) or shift.shape != (k, N) or not 1 <= k <= 4:
        raise ValueError(f"recip/shift must be (k<=4, N), got "
                         f"{tuple(recip.shape)}")
    build.check_cuda_operands(x, q_packed, cid_packed, recip, shift)
    if q_packed.dtype != torch.uint8 or cid_packed.dtype != torch.uint8 \
            or recip.dtype != torch.float32 or shift.dtype != torch.float32:
        raise TypeError("packed codes/cids must be uint8, recip/shift fp32")
    x = x.contiguous()
    tensors = [t.contiguous() for t in (q_packed, cid_packed, recip, shift)]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    splits = k_splits(M, K, N, build.sm_count(x.device.index or 0))
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else y)
    lib = build.library()
    err = lib.splitquant_matmul(
        x.data_ptr(), *(t.data_ptr() for t in tensors), y.data_ptr(),
        ws.data_ptr(), M, K, N, bits, k, int(x.dtype == torch.bfloat16),
        splits, build.stream_of(x))
    build.check(lib, err, "splitquant_matmul")
    splitquant_matmul.launches += 1
    return y


splitquant_matmul.launches = 0
