"""Activation split-quantization (paper §4.2): the wrappers of the CUDA
kernels in ``csrc/act_quant.cu`` (which replace the Pallas TPU kernels
``repro/kernels/act_quant.py:_kernel`` and ``:_static_kernel``) and their
plain PyTorch versions.

Dynamic (:func:`act_split_quantize`): each row's width is split into
``n_chunks`` equal chunks, each quantized with its own runtime (β, α) →
(S, Z) by eqs. 1-3, so an outlier widens only its own chunk's step.
Static (:func:`act_split_quantize_static`): precomputed per-chunk (S, Z)
over ``array_split`` chunks (even or not), with the fractional zero
folded into the rounding: ``clip(rint(S·x + Z))``.

The plain versions compute what the TPU kernels compute, bit for bit. In
one corner the TPU kernel and the JAX package's own oracle
(``act_split_quantize_ref``, through ``core.quantize.qparams``) differ: a
constant (row, chunk) gets zero 0 from the kernel and
``-2^(b-1) - rint(S·β)`` from the oracle. Both dequantize it exactly;
the port follows the kernel.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor
they launch the kernels or raise. ``act_split_quantize.launches`` and
``act_split_quantize_static.launches`` count kernel launches. No serving
path runs them yet; they are the port's counterparts of the JAX
package's public act-quant entry points.

Quality observation: :func:`set_quality_probe` installs a module-level
probe (``obs.ActQuantProbe``, ``obs.RegistryQuantProbe``) that
:func:`act_split_quantize_observed` and
:func:`act_split_quantize_static_observed` feed with the codes (and the
dynamic scales) copied to the host after the launch, as the JAX package's
wrappers do; with no probe installed they add nothing to the launch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.splitquant import activation_chunk_bounds
from . import build


#: the dynamic kernel's 16-byte vectors a lane (at most; each takes 16
#: bytes of a block's shared memory a thread) and warps a (row, chunk) (at
#: most; a block holds eight warps)
DYN_MAX_VECS = 8
DYN_MAX_WARPS = 8


def dynamic_plan(cw: int, itemsize: int) -> tuple[int, int]:
    """(warps a (row, chunk), 16-byte vectors a lane) of the dynamic
    kernel for chunks of ``cw`` columns of ``itemsize`` bytes: the fewest
    warps (a power of two up to 8) whose lanes take every whole vector of
    the chunk with at most :data:`DYN_MAX_VECS` each, then the fewest
    vectors a lane (a power of two) that do. A chunk has at most
    ``cw * itemsize // 16`` whole vectors, whatever its alignment; one
    wider than 8 warps x 8 vectors a lane takes rounds (the kernel reads
    it twice). :mod:`repro_torch.launch.act_quant_sweep` times all 16
    plans the launcher takes."""
    nv = cw * itemsize // 16
    warps = 1
    while warps < DYN_MAX_WARPS and nv > 32 * warps * DYN_MAX_VECS:
        warps *= 2
    need = -(-nv // (32 * warps))
    vecs = 1
    while vecs < min(need, DYN_MAX_VECS):
        vecs *= 2
    return warps, vecs


def _check_bits(bits: int) -> None:
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")


def act_split_quantize_ref(x: torch.Tensor, *, bits: int = 8,
                           n_chunks: int = 3):
    """x (R, N), N % n_chunks == 0 → (q int8 (R, N), scale (R, n_chunks),
    zero (R, n_chunks)) fp32, per-row per-chunk ranges."""
    _check_bits(bits)
    R, N = x.shape
    xc = x.float().reshape(R, n_chunks, N // n_chunks)
    beta, alpha = xc.amin(-1), xc.amax(-1)
    span = alpha - beta
    one = torch.ones_like(span)
    amax = torch.maximum(beta.abs(), alpha.abs())
    degenerate = torch.where(amax > 0, one / torch.where(amax > 0, amax, one),
                             one)
    # a tensor numerator: ``float / tensor`` multiplies by a reciprocal
    levels = torch.full_like(span, float(2 ** bits - 1))
    scale = torch.where(span > 0, levels / torch.where(span > 0, span, one),
                        degenerate)
    zero = torch.where(span > 0, -float(2 ** (bits - 1)) -
                       torch.round(scale * beta), 0.0)
    q = torch.round(scale[..., None] * xc) + zero[..., None]
    q = torch.clamp(q, -(2 ** (bits - 1)), 2 ** (bits - 1) - 1)
    return q.to(torch.int8).reshape(R, N), scale, zero


def act_split_quantize(x: torch.Tensor, *, bits: int = 8,
                       n_chunks: int = 3):
    """Dynamic split quantization (see :func:`act_split_quantize_ref`);
    the CUDA kernel on the card, the plain version on the CPU."""
    R, N = x.shape
    if n_chunks < 1 or N % n_chunks:
        raise ValueError(f"width {N} does not split into {n_chunks} "
                         f"equal chunks")
    if x.device.type == "cpu":
        return act_split_quantize_ref(x, bits=bits, n_chunks=n_chunks)
    _check_bits(bits)
    build.check_cuda_operands(x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    return launch_dynamic(x, bits, n_chunks,
                          dynamic_plan(N // n_chunks, x.element_size()))


def launch_dynamic(x: torch.Tensor, bits: int, n_chunks: int,
                   plan: tuple[int, int]):
    """The dynamic kernel's launch at ``plan`` (warps a (row, chunk),
    16-byte vectors a lane) on a contiguous CUDA ``x`` whose arguments
    :func:`act_split_quantize` has checked; ``launch.act_quant_sweep``
    times every plan through it."""
    R, N = x.shape
    q = torch.empty((R, N), dtype=torch.int8, device=x.device)
    scale = torch.empty((R, n_chunks), dtype=torch.float32, device=x.device)
    zero = torch.empty_like(scale)
    if R:
        lib = build.library()
        warps, vecs = plan
        err = lib.act_quant_dynamic(x.data_ptr(), q.data_ptr(),
                                    scale.data_ptr(), zero.data_ptr(), R, N,
                                    n_chunks, bits,
                                    int(x.dtype == torch.bfloat16), warps,
                                    vecs, build.stream_of(x))
        build.check(lib, err, "act_split_quantize")
        act_split_quantize.launches += 1
    return q, scale, zero


act_split_quantize.launches = 0


def chunk_id_map(n: int, n_chunks: int) -> np.ndarray:
    """(n,) int32 chunk id per column of a width-``n`` axis split into
    ``n_chunks`` contiguous ``array_split`` chunks."""
    bounds = activation_chunk_bounds(n, n_chunks)
    return np.repeat(np.arange(n_chunks), np.diff(bounds)).astype(np.int32)


def act_split_quantize_static_ref(x: torch.Tensor, scale: torch.Tensor,
                                  zero: torch.Tensor, *, bits: int = 8):
    """x (R, N), scale/zero (n_chunks,) → q int8 (R, N) =
    clip(rint(S·x + Z)) with each column's chunk's (S, Z); the multiply
    and the add are rounded on their own (no fused multiply-add)."""
    _check_bits(bits)
    R, N = x.shape
    cid = torch.from_numpy(chunk_id_map(N, scale.shape[-1])).to(
        x.device).long()
    s_row = scale.float().reshape(-1)[cid]
    z_row = zero.float().reshape(-1)[cid]
    q = torch.round(s_row * x.float() + z_row)
    return torch.clamp(q, -(2 ** (bits - 1)),
                       2 ** (bits - 1) - 1).to(torch.int8)


def act_split_quantize_static(x: torch.Tensor, scale: torch.Tensor,
                              zero: torch.Tensor, *, bits: int = 8):
    """Static split quantization (see
    :func:`act_split_quantize_static_ref`); the CUDA kernel on the card,
    the plain version on the CPU."""
    R, N = x.shape
    n_chunks = scale.shape[-1]
    if scale.shape != (n_chunks,) or zero.shape != (n_chunks,) or \
            not 1 <= n_chunks <= N:
        raise ValueError(f"scale/zero must be (n_chunks,) with n_chunks <= "
                         f"{N}, got {tuple(scale.shape)}/{tuple(zero.shape)}")
    if x.device.type == "cpu":
        return act_split_quantize_static_ref(x, scale, zero, bits=bits)
    _check_bits(bits)
    build.check_cuda_operands(x, scale, zero)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if scale.dtype != torch.float32 or zero.dtype != torch.float32:
        raise TypeError("scale and zero must be float32")
    x, scale, zero = x.contiguous(), scale.contiguous(), zero.contiguous()
    q = torch.empty((R, N), dtype=torch.int8, device=x.device)
    if R:
        lib = build.library()
        err = lib.act_quant_static(x.data_ptr(), scale.data_ptr(),
                                   zero.data_ptr(), q.data_ptr(), R, N,
                                   n_chunks, bits,
                                   int(x.dtype == torch.bfloat16),
                                   build.stream_of(x))
        build.check(lib, err, "act_split_quantize_static")
        act_split_quantize_static.launches += 1
    return q


act_split_quantize_static.launches = 0


#: the probe the ``*_observed`` wrappers feed; None = observation off
_QUALITY_PROBE = None


def set_quality_probe(probe) -> None:
    """Install the module-level quality probe (None or a falsy probe
    clears it). It sees every :func:`act_split_quantize_observed` and
    :func:`act_split_quantize_static_observed` call's codes and dynamic
    scales."""
    global _QUALITY_PROBE
    _QUALITY_PROBE = probe if probe else None


def act_split_quantize_observed(x: torch.Tensor, *, layer=None, **kw):
    """:func:`act_split_quantize` and, with a probe installed, its codes
    and scales copied to the host for the probe. Same returns."""
    q, scale, zero = act_split_quantize(x, **kw)
    probe = _QUALITY_PROBE
    if probe is not None:
        probe.observe(q.cpu().numpy(), scale.cpu().numpy(), layer=layer)
    return q, scale, zero


def act_split_quantize_static_observed(x: torch.Tensor, scale: torch.Tensor,
                                       zero: torch.Tensor, *, layer=None,
                                       **kw):
    """:func:`act_split_quantize_static` and, with a probe installed, its
    codes copied to the host for the probe (static scales carry no range
    of the call: clip fraction and code occupancy only)."""
    q = act_split_quantize_static(x, scale, zero, **kw)
    probe = _QUALITY_PROBE
    if probe is not None:
        probe.observe(q.cpu().numpy(), layer=layer)
    return q


def dequantize_act(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """(q − Z) / S for both layouts: dynamic per-row (R, n_chunks) and
    static (n_chunks,) over even or uneven chunks."""
    R, N = q.shape
    n_chunks = scale.shape[-1]
    if N % n_chunks:
        if scale.dim() != 1:
            raise ValueError("uneven chunks require static (1-D) scales")
        cid = torch.from_numpy(chunk_id_map(N, n_chunks)).to(q.device).long()
        return ((q.float() - zero.float()[cid]) /
                scale.float()[cid]).to(dtype)
    if scale.dim() == 1:
        scale, zero = scale[None], zero[None]
    qc = q.float().reshape(R, n_chunks, N // n_chunks)
    x = (qc - zero.float()[..., None]) / scale.float()[..., None]
    return x.reshape(R, N).to(dtype)
