"""Chunked RWKV6 WKV (data-dependent-decay linear attention): the wrapper
of the CUDA kernel ``csrc/wkv_chunked.cu`` (which replaces the Pallas TPU
kernel ``repro/kernels/wkv_chunked.py:_kernel``) and its plain PyTorch
versions.

Recurrence (per head; key dim i, value dim j):
    S_t[i,j] = w_t[i]·S_{t-1}[i,j] + k_t[i]·v_t[j]
    y_t[j]   = Σ_i r_t[i]·(S_{t-1}[i,j] + u[i]·k_t[i]·v_t[j])

:func:`wkv_chunked_ref` is the chunked form the model runs
(``wkv_chunked_jnp``): chunk length L, in-chunk log-decays c (inclusive
cumsum, ≤ 0) and cp = c − log w, every exponent a difference of them.
:func:`wkv_step_ref` is the recurrence step by step (``wkv_ref``), the
oracle and the model's branch for lengths that are not a multiple of 16.

On a CPU tensor :func:`wkv_chunked` runs the plain chunked version; on a
CUDA tensor it launches the kernel or raises. ``wkv_chunked.launches``
counts kernel launches.

The gradient: :func:`wkv_chunked` goes through :class:`WkvChunked`, a
``torch.autograd.Function`` on both devices whose backward is
:func:`wkv_chunked_bwd`, the wrapper of ``csrc/wkv_chunked_bwd.cu`` (no
TPU kernel: the JAX package differentiates ``wkv_chunked_jnp``), with its
plain version :func:`wkv_chunked_bwd_ref` on a CPU tensor.
``wkv_chunked_bwd.launches`` counts its launches. Per head, with dS_t the
gradient on the state after step t (dS_T = S̄) and ȳ the gradient on y:

    dS_{t-1} = w_t ⊙ dS_t + r_t ȳ_tᵀ,   ds0 = dS_0
    dr_t = S_{t-1} ȳ_t + (u ⊙ k_t)(v_t · ȳ_t)
    dk_t = dS_t v_t + (u ⊙ r_t)(v_t · ȳ_t)
    dv_t = dS_tᵀ k_t + (r_t · (u ⊙ k_t)) ȳ_t
    du   = Σ_t r_t ⊙ k_t (v_t · ȳ_t)
    dw_t[i] = Σ_j S_{t-1}[i,j] dS_t[i,j], and 0 where the chunked form
              clamps (w ≤ 1e-30: log max(w, 1e-30) is constant there)

The states are recomputed (with w clamped as the forward clamps it) and
never recovered by dividing by w, which underflows.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import build

#: the kernel's chunk length (the rounding of the chunked form depends on
#: it, so it is not a tuning knob)
CHUNK = 16
#: the clamp of the chunked form's log-decay, log(max(w, W_MIN))
W_MIN = 1e-30


def wkv_chunked_ref(r, k, v, w, u, *, chunk: int = CHUNK, s0=None):
    """r, k, w (BH, T, K); v (BH, T, V); u (BH, K); s0 (BH, K, V) or None.
    T % chunk == 0. Returns (y (BH, T, V) in r.dtype, S_final (BH, K, V)
    fp32). All arithmetic in fp32."""
    BH, T, K = r.shape
    V = v.shape[-1]
    n = T // chunk
    rc, kc, wc = (a.float().reshape(BH, n, chunk, K) for a in (r, k, w))
    vc = v.float().reshape(BH, n, chunk, V)
    lw = torch.log(torch.clamp(wc, min=1e-30))
    c = torch.cumsum(lw, dim=2)
    cp = c - lw
    D = cp[:, :, :, None, :] - c[:, :, None, :, :]          # (BH,n,L,L,K)
    idx = torch.arange(chunk, device=r.device)
    mask = idx[:, None] > idx[None, :]
    E = torch.where(mask[None, None, :, :, None], torch.exp(D), 0.0)
    att = torch.einsum("bntk,bnsk,bntsk->bnts", rc, kc, E)
    diag = torch.einsum("bntk,bntk->bnt", rc * u.float()[:, None, None, :],
                        kc)
    att = att + torch.eye(chunk, device=r.device)[None, None] * diag[..., None]
    y_intra = torch.einsum("bnts,bnsv->bntv", att, vc)

    k_dec = kc * torch.exp(c[:, :, -1:, :] - c)              # (BH,n,L,K)
    s_updates = torch.einsum("bntk,bntv->bnkv", k_dec, vc)
    chunk_decay = torch.exp(c[:, :, -1, :])                  # (BH,n,K)
    r_exp = rc * torch.exp(cp)                               # (BH,n,L,K)
    S = (torch.zeros((BH, K, V), device=r.device) if s0 is None
         else s0.float())
    y_inter = []
    for i in range(n):
        y_inter.append(torch.einsum("btk,bkv->btv", r_exp[:, i], S))
        S = chunk_decay[:, i, :, None] * S + s_updates[:, i]
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(BH, T, V).to(r.dtype), S


def wkv_step_ref(r, k, v, w, u, *, s0=None):
    """The recurrence one token at a time. Shapes as
    :func:`wkv_chunked_ref` (any T). Returns (y (BH, T, V) in r.dtype,
    S_final (BH, K, V) fp32); pass fp32 r to keep y in fp32."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[..., None]                                # (BH, K, 1)
    BH, T, K = r.shape
    S = (torch.zeros((BH, K, v.shape[-1]), device=r.device) if s0 is None
         else s0.float())
    ys = []
    for t in range(T):
        kv = kf[:, t, :, None] * vf[:, t, None, :]           # (BH, K, V)
        ys.append(torch.einsum("bi,bij->bj", rf[:, t], S + uf * kv))
        S = wf[:, t, :, None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S


#: the kernel's shape: a cluster of two blocks a (head, slab), each block
#: four warps over half the keys (padded to 64 or 128), a warp per 16
#: columns of a slab of at most 64
THREADS = 128
BLOCKS_PER_SLAB = 2
COLS_PER_WARP = 16
MAX_SLAB = 64


class WkvPlan(NamedTuple):
    """Launch plan of the chunked WKV kernel: ``vs`` value columns a
    cluster of two blocks (grid (BH, 2·ceil(V / vs))), ``threads`` a
    block and ``smem`` bytes of dynamic shared memory a block."""
    vs: int
    threads: int
    smem: int


def _smem(K: int, itemsize: int) -> int:
    """Bytes of a block's shared memory (``smem_bytes`` in the source),
    with KH = 32 or 64 keys a block: two sets (by chunk parity) of r, k,
    cp, c (16, KH + 4), r·exp(cp), k·exp(c_last − c) (16, KH + 8) and
    exp(c_last) (KH) in fp32; att's two TF32 parts (16, 20), the peer's
    share of y (2 x 128 x 4) and u (KH); one buffer of the next chunk's
    r, k (input type) and w (fp32) (16, KH), two of the v slab (16, 64)."""
    kh = 32 if K <= 64 else 64
    pset = 4 * CHUNK * (kh + 4) + 2 * CHUNK * (kh + 8) + kh
    f32 = 2 * pset + 2 * CHUNK * 20 + 2 * 4 * 32 * 4 + kh
    return (4 * f32 + 2 * CHUNK * kh * itemsize + CHUNK * kh * 4 +
            2 * CHUNK * 64 * itemsize)


@functools.lru_cache(maxsize=None)
def wkv_plan(BH: int, K: int, V: int, sms: int, itemsize: int = 2) -> WkvPlan:
    """The value slab of the kernel's clusters: of the slabs that cut V
    into 1, 2, 3, ... parts of at most :data:`MAX_SLAB` columns (rounded
    up to whole warps of 16), the one that puts the fewest blocks on the
    busiest SM, the widest of those. A block's time is set by its 16
    dependent chunks, and a narrower slab recomputes the exponent terms
    and att, so more blocks an SM only cost; with 2·BH blocks of the
    whole slab at BH = 320 or 1280 heads the busiest SM of an H100 has
    within 1.1x of the mean."""
    if not (0 < K <= 128 and 0 < V <= 128 and BH > 0 and sms > 0):
        raise ValueError(f"no plan for BH={BH}, K={K}, V={V}, sms={sms}")
    cpw = COLS_PER_WARP
    cands = []
    for n in range(1, V + 1):
        per = -(-V // n)                            # ceil(V / n)
        vs = min(V, -(-per // cpw) * cpw)           # whole warps of columns
        if -(-V // vs) != n:
            continue
        if vs <= MAX_SLAB:
            cands.append(vs)
        if vs <= cpw:
            break
    busiest = lambda vs: -(-BLOCKS_PER_SLAB * BH * -(-V // vs) // sms)
    vs = min(cands, key=lambda c: (busiest(c), -c))
    return WkvPlan(vs, THREADS, _smem(K, itemsize))


def _check_operands(r, k, v, w, u, s0) -> None:
    """The kernels' operands: r, k, w (BH, T, K) and v (BH, T, V) on one
    card, T % 16 == 0, K and V at most 128; r/k/v in one of
    float32/bfloat16, w/u/s0 in float32."""
    build.check_cuda_operands(r, k, v, w, u, s0)
    if r.dim() != 3 or k.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"r, k, w must be (BH, T, K) alike, got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(w.shape)}")
    BH, T, K = r.shape
    V = v.shape[-1]
    if v.dim() != 3 or v.shape[:2] != (BH, T) or u.shape != (BH, K):
        raise ValueError(f"v must be (BH, T, V) and u (BH, K), got "
                         f"{tuple(v.shape)}, {tuple(u.shape)}")
    if s0 is not None and s0.shape != (BH, K, V):
        raise ValueError(f"s0 must be (BH, K, V), got {tuple(s0.shape)}")
    if T % CHUNK:
        raise ValueError(f"the kernel runs chunk {CHUNK} over T % {CHUNK} "
                         f"== 0, got T {T}")
    if not (0 < K <= 128 and 0 < V <= 128):
        raise ValueError(f"K and V must be at most 128, got {K}, {V}")
    if r.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("r, k, v must share one of float32, bfloat16")
    if any(t is not None and t.dtype != torch.float32 for t in (w, u, s0)):
        raise TypeError("w, u and s0 must be float32")


def _forward(r, k, v, w, u, s0):
    """The forward of :func:`wkv_chunked`: the plain chunked version on a
    CPU tensor, the kernel on a CUDA tensor."""
    if r.device.type == "cpu":
        return wkv_chunked_ref(r, k, v, w, u, s0=s0)
    _check_operands(r, k, v, w, u, s0)
    BH, T, K = r.shape
    V = v.shape[-1]
    r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
    s0 = s0.contiguous() if s0 is not None else None
    y = torch.empty((BH, T, V), dtype=r.dtype, device=r.device)
    s_out = torch.empty((BH, K, V), dtype=torch.float32, device=r.device)
    vs = wkv_plan(BH, K, V, build.sm_count(r.device.index or 0),
                  r.element_size()).vs
    lib = build.library()
    err = lib.wkv_chunked(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          w.data_ptr(), u.data_ptr(),
                          s0.data_ptr() if s0 is not None else None,
                          y.data_ptr(), s_out.data_ptr(), BH, T, K, V, vs,
                          int(r.dtype == torch.bfloat16), build.stream_of(r))
    build.check(lib, err, "wkv_chunked")
    wkv_chunked.launches += 1
    return y, s_out


def wkv_chunked_bwd_ref(r, k, v, w, u, s0, y_bar, S_bar):
    """The gradient of :func:`wkv_chunked_ref` (the formulas of the module
    docstring) in fp32, in the kernel's scheme: a forward sweep keeps the
    state entering each chunk, then the chunks are walked backwards, each
    one's states recomputed from its entering state, and the steps of the
    chunk taken in reverse. ``s0`` and ``S_bar`` may be ``None`` (zero).
    Returns (dr, dk, dv) in r's type, (dw, du) fp32 and ds0 fp32, or
    ``None`` when s0 is."""
    rf, kf, vf, yb, wf = (a.float() for a in (r, k, v, y_bar, w))
    uf = u.float()
    we = torch.clamp(wf, min=W_MIN)
    BH, T, K = r.shape
    V = v.shape[-1]
    zero = torch.zeros((BH, K, V), device=r.device)
    step = lambda S, t: we[:, t, :, None] * S + \
        kf[:, t, :, None] * vf[:, t, None, :]
    S = zero if s0 is None else s0.float()
    entering = []
    for t in range(T):
        if t % CHUNK == 0:
            entering.append(S)
        S = step(S, t)
    vy = (vf * yb).sum(-1)                                   # (BH, T)
    ruk = (rf * uf[:, None, :] * kf).sum(-1)                 # (BH, T)
    dS = zero if S_bar is None else S_bar.float()
    dr, dk, dv, dw = ([None] * T for _ in range(4))
    for n in reversed(range(len(entering))):
        steps = range(n * CHUNK, min((n + 1) * CHUNK, T))
        S, pre = entering[n], []
        for t in steps:
            pre.append(S)                                    # S_{t-1}
            S = step(S, t)
        for t, P in zip(reversed(steps), reversed(pre)):     # dS is dS_t
            dr[t] = torch.einsum("bij,bj->bi", P, yb[:, t]) + \
                uf * kf[:, t] * vy[:, t, None]
            dk[t] = torch.einsum("bij,bj->bi", dS, vf[:, t]) + \
                uf * rf[:, t] * vy[:, t, None]
            dv[t] = torch.einsum("bij,bi->bj", dS, kf[:, t]) + \
                yb[:, t] * ruk[:, t, None]
            dw[t] = torch.where(wf[:, t] > W_MIN, (P * dS).sum(-1), 0.0)
            dS = we[:, t, :, None] * dS + rf[:, t, :, None] * yb[:, t, None, :]
    du = (rf * kf * vy[..., None]).sum(1)
    st = lambda xs, dt: torch.stack(xs, dim=1).to(dt)
    return (st(dr, r.dtype), st(dk, k.dtype), st(dv, v.dtype),
            st(dw, torch.float32), du, None if s0 is None else dS)


#: the backward kernel's block: 512 threads over at most 1024 state
#: elements (K keys x a slab of VS value columns, two a thread)
BWD_ELEMS = 1024


def wkv_bwd_slab(K: int, V: int) -> int:
    """Value columns a block of the backward kernel takes: as many as fit
    K x VS <= :data:`BWD_ELEMS` (16 at K = 64, so rwkv6-3b's 64 columns
    are four blocks a head)."""
    return max(1, min(V, BWD_ELEMS // K))


def wkv_chunked_bwd(r, k, v, w, u, s0, y_bar, S_bar):
    """The gradient of :func:`wkv_chunked` given ȳ (``y_bar``, y's type)
    and S̄ (``S_bar``, fp32 or ``None``): (dr, dk, dv) in r's type, (dw,
    du, ds0) fp32, ds0 ``None`` when s0 is. The plain version on a CPU
    tensor; on a CUDA tensor the kernel (operands as the forward's) or an
    error."""
    if r.device.type == "cpu":
        return wkv_chunked_bwd_ref(r, k, v, w, u, s0, y_bar, S_bar)
    _check_operands(r, k, v, w, u, s0)
    build.check_cuda_operands(r, y_bar, S_bar)
    BH, T, K = r.shape
    V = v.shape[-1]
    if y_bar.shape != (BH, T, V) or y_bar.dtype != r.dtype:
        raise ValueError(f"y_bar must be (BH, T, V) in r's type, got "
                         f"{tuple(y_bar.shape)} {y_bar.dtype}")
    if S_bar is not None and (S_bar.shape != (BH, K, V) or
                              S_bar.dtype != torch.float32):
        raise ValueError(f"S_bar must be (BH, K, V) float32, got "
                         f"{tuple(S_bar.shape)} {S_bar.dtype}")
    r, k, v, w, u, y_bar = (t.contiguous() for t in (r, k, v, w, u, y_bar))
    s0, S_bar = (t.contiguous() if t is not None else None
                 for t in (s0, S_bar))
    vs = wkv_bwd_slab(K, V)
    ns = -(-V // vs)
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dw = torch.empty((BH, T, K), **f32)
    du = torch.empty((BH, K), **f32)
    ds0 = torch.empty((BH, K, V), **f32) if s0 is not None else None
    # scratch: each chunk's entering state, and the slabs' partial sums of
    # dr, dk, dw and du, added in slab order by the second pass
    s_chunk = torch.empty((BH, T // CHUNK, K, V), **f32)
    part = torch.empty((3, BH, ns, T, K), **f32)
    part_u = torch.empty((BH, ns, K), **f32)
    ptr = lambda t: t.data_ptr() if t is not None else None
    lib = build.library()
    err = lib.wkv_chunked_bwd(
        *(ptr(t) for t in (r, k, v, w, u, s0, y_bar, S_bar, dr, dk, dv, dw,
                           du, ds0, s_chunk, part, part_u)),
        BH, T, K, V, vs, int(r.dtype == torch.bfloat16), build.stream_of(r))
    build.check(lib, err, "wkv_chunked_bwd")
    wkv_chunked_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


wkv_chunked_bwd.launches = 0


class WkvChunked(torch.autograd.Function):
    """:func:`wkv_chunked` with its gradient: the forward of
    :func:`wkv_chunked` and the backward :func:`wkv_chunked_bwd`, on both
    devices. The inputs are kept for the backward (the states are
    recomputed there); under ``torch.no_grad`` nothing is kept."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        return _forward(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, y_bar, S_bar):
        return wkv_chunked_bwd(*ctx.saved_tensors, y_bar, S_bar)


def wkv_chunked(r, k, v, w, u, *, s0=None):
    """Chunked WKV (chunk :data:`CHUNK`) with carry-in ``s0`` → (y,
    S_final); see :func:`wkv_chunked_ref`. Differentiable through
    :class:`WkvChunked`. The CUDA kernels take r/k/v in one of
    float32/bfloat16, w/u/s0 in float32, T % 16 == 0, and K, V at most
    128."""
    return WkvChunked.apply(r, k, v, w, u, s0)


wkv_chunked.launches = 0
