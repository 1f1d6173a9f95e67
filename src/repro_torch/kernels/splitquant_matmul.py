"""Fused SplitQuant dequant-matmul: the wrapper of the CUDA kernels in
``csrc/splitquant_matmul.cu`` (which replace the Pallas TPU kernel
``repro/kernels/splitquant_matmul.py:_kernel``) and their dispatch.

On a CPU tensor the wrapper runs the plain version
(:func:`~repro_torch.kernels.ref.splitquant_matmul_ref`); on a CUDA
tensor it launches a kernel or raises. The variant follows x's dtype:
bf16 goes to the tensor-core kernel (``"bf16_wgmma"``), fp32 to the
CUDA-core kernel (``"fp32_cuda_core"``), which keeps the fp32 numbers
(the tensor cores would round them to TF32). :func:`plan` picks the
tiles and the K splits. :func:`grouped_splitquant_matmul` is the grouped
form of both kernels (a MoE layer's experts: each expert's rows times its
matrix, one launch for all experts), counted as the variant
``"grouped"``. ``splitquant_matmul.launches`` counts kernel launches in
all, ``splitquant_matmul.variant_launches`` by variant and
``splitquant_matmul.bits_launches`` by the weight's bit-width.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import build
from .ref import splitquant_matmul_ref

TENSOR_CORE = "bf16_wgmma"
CUDA_CORE = "fp32_cuda_core"
GROUPED = "grouped"
_BK = 64


def blocks_per_sm(variant: str, M: int) -> int:
    """Blocks per SM that a K split aims at when the (M, N) grid alone has
    fewer. The tensor-core kernel keeps two blocks on an SM; on the
    serving shapes (``python -m repro_torch.launch.matmul_sweep``,
    PERF.md) about 1.5 waves of them were fastest at M <= 64 and M > 128,
    and one wave at M = 96, where the fp32 workspace of more splits cost
    more than the fuller grid gained."""
    if variant == CUDA_CORE:
        return 2
    return 2 if 64 < M <= 128 else 3


class Plan(NamedTuple):
    """How one (M, K, N) product is cut: ``bm`` x ``bn`` output tiles,
    each block walking ``k_per_split`` rows of K (a multiple of ``bk``)
    in ``splits`` slices, none of them empty."""
    variant: str
    bm: int
    bn: int
    bk: int
    splits: int
    k_per_split: int


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, dtype: torch.dtype, sms: int) -> Plan:
    """The launch plan of an (M, K) x (K, N) product in ``dtype`` on a
    card with ``sms`` SMs: bf16 to the tensor-core kernel in tiles of
    64 x 128 (M <= 64) or 128 x 128, fp32 to the CUDA-core kernel in tiles
    of 8 x 128. When the (M, N) grid alone has fewer blocks than
    :func:`blocks_per_sm` per SM, K is split to come near that many."""
    if dtype == torch.bfloat16:
        variant, bm = TENSOR_CORE, (64 if M <= 64 else 128)
    elif dtype == torch.float32:
        variant, bm = CUDA_CORE, 8
    else:
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    bn, target = 128, blocks_per_sm(variant, M) * sms
    tiles = -(-K // _BK)
    blocks = -(-M // bm) * -(-N // bn)
    want = min(-(-target // blocks), tiles)
    per = -(-tiles // want)
    return Plan(variant, bm, bn, _BK, -(-tiles // per), per * _BK)


def splitquant_matmul(x: torch.Tensor, q_packed: torch.Tensor,
                      cid_packed: torch.Tensor, recip: torch.Tensor,
                      shift: torch.Tensor, *, bits: int, k: int = 3
                      ) -> torch.Tensor:
    """y = x · Ŵ. x: (M, K) bf16/fp32; q_packed (K·bits/8, N) uint8;
    cid_packed (K/4, N) uint8; recip/shift (k, N) fp32. Returns (M, N) in
    x.dtype. On the card one launch, or one a slab of rows past
    :data:`MAX_OUTPUTS` outputs (:func:`row_slabs`)."""
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
    for r0, r1 in row_slabs(M, N):
        _launch(x[r0:r1], tensors, y[r0:r1], bits, k)
    return y


#: the most outputs one launch writes (the kernel indexes them in int32)
MAX_OUTPUTS = 0x7fffffff


def row_slabs(M: int, N: int) -> list[tuple[int, int]]:
    """The [r0, r1) row ranges an (M, N) product is launched in: one, or,
    past :data:`MAX_OUTPUTS` outputs (a long prefill's vocab head, e.g.
    4 x 2400 rows x 256000), as many slabs of whole rows as it takes."""
    step = max(1, MAX_OUTPUTS // N)
    return [(r0, min(M, r0 + step)) for r0 in range(0, M, step)]


def _launch(x, tensors, y, bits: int, k: int) -> None:
    """One launch of the kernel the plan picks: y (M, N) = x (M, K) · Ŵ."""
    (M, K), N = x.shape, y.shape[1]
    p = plan(M, K, N, x.dtype, build.sm_count(x.device.index or 0))
    ws = (torch.empty((p.splits, M, N), dtype=torch.float32, device=x.device)
          if p.splits > 1 else y)
    lib = build.library()
    err = lib.splitquant_matmul(
        x.data_ptr(), *(t.data_ptr() for t in tensors), y.data_ptr(),
        ws.data_ptr(), M, K, N, bits, k, int(x.dtype == torch.bfloat16),
        p.bm, p.splits, p.k_per_split, build.stream_of(x))
    build.check(lib, err, "splitquant_matmul")
    splitquant_matmul.launches += 1
    splitquant_matmul.variant_launches[p.variant] += 1
    splitquant_matmul.bits_launches[bits] += 1


def grouped_splitquant_matmul_ref(x, offsets, q_packed, cid_packed, recip,
                                  shift, bits: int) -> torch.Tensor:
    """Plain version of the grouped product: :func:`splitquant_matmul_ref`
    of each expert's rows ``x[offsets[e]:offsets[e+1]]`` with its packed
    matrix (the offsets are read on the host)."""
    off = offsets.tolist()
    y = x.new_zeros((x.shape[0], q_packed.shape[-1]))
    for e in range(q_packed.shape[0]):
        if off[e + 1] > off[e]:
            y[off[e]:off[e + 1]] = splitquant_matmul_ref(
                x[off[e]:off[e + 1]], q_packed[e], cid_packed[e], recip[e],
                shift[e], bits)
    return y


def grouped_splitquant_matmul(x: torch.Tensor, offsets: torch.Tensor,
                              q_packed: torch.Tensor,
                              cid_packed: torch.Tensor, recip: torch.Tensor,
                              shift: torch.Tensor, *, bits: int, k: int = 3
                              ) -> torch.Tensor:
    """y[r] = x[r] · Ŵ_e for r in [offsets[e], offsets[e+1]). x: (R, K)
    bf16/fp32, rows grouped by expert; offsets (E+1,) int32 on x's device,
    from 0 to R; q_packed (E, K·bits/8, N), cid_packed (E, K/4, N) uint8;
    recip/shift (E, k, N) fp32. Returns (R, N) in x.dtype: one launch of
    the grouped kernel (bf16 on the tensor cores, fp32 on the CUDA cores)
    whose blocks read their expert's rows from ``offsets`` on the card, so
    the host never waits for the routing."""
    if x.device.type == "cpu":
        return grouped_splitquant_matmul_ref(x, offsets, q_packed,
                                             cid_packed, recip, shift, bits)
    R, K = x.shape
    E, _, N = q_packed.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if K % 4 or q_packed.shape[1] * (8 // bits) != K or \
            cid_packed.shape != (E, K // 4, N):
        raise ValueError(f"packed stack {tuple(q_packed.shape)}/"
                         f"{tuple(cid_packed.shape)} does not match K={K}")
    if recip.shape != (E, k, N) or shift.shape != (E, k, N) or \
            not 1 <= k <= 4:
        raise ValueError(f"recip/shift must be (E, k<=4, N), got "
                         f"{tuple(recip.shape)}")
    if offsets.shape != (E + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be ({E + 1},) int32, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    build.check_cuda_operands(x, offsets, q_packed, cid_packed, recip, shift)
    if q_packed.dtype != torch.uint8 or cid_packed.dtype != torch.uint8 \
            or recip.dtype != torch.float32 or shift.dtype != torch.float32:
        raise TypeError("packed codes/cids must be uint8, recip/shift fp32")
    y = torch.empty((R, N), dtype=x.dtype, device=x.device)
    if R == 0:
        return y
    x = x.contiguous()
    tensors = [t.contiguous() for t in (q_packed, cid_packed, recip, shift)]
    bm = 64 if x.dtype == torch.bfloat16 else 8
    lib = build.library()
    err = lib.grouped_splitquant_matmul(
        x.data_ptr(), *(t.data_ptr() for t in tensors),
        offsets.contiguous().data_ptr(), y.data_ptr(), R, K, N, E,
        -(-R // bm), bits, k, int(x.dtype == torch.bfloat16),
        build.stream_of(x))
    build.check(lib, err, "grouped_splitquant_matmul")
    splitquant_matmul.launches += 1
    splitquant_matmul.variant_launches[GROUPED] += 1
    splitquant_matmul.bits_launches[bits] += 1
    return y


def reset_counts() -> None:
    """Set the total, the per-variant and the per-bit-width launch counts
    to 0."""
    splitquant_matmul.launches = 0
    for counts in (splitquant_matmul.variant_launches,
                   splitquant_matmul.bits_launches):
        for key in counts:
            counts[key] = 0


splitquant_matmul.launches = 0
splitquant_matmul.variant_launches = {TENSOR_CORE: 0, CUDA_CORE: 0,
                                      GROUPED: 0}
splitquant_matmul.bits_launches = {2: 0, 4: 0, 8: 0}
