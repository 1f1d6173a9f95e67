"""Port parity, activation split-quantization: the port's dynamic and
static act-quant entry points (the CPU path runs their plain versions)
against the JAX package's Pallas kernels in interpret mode and its
oracles, on seeded numpy inputs.

Tolerances: codes, scales and zeros bit-identical; ``dequantize_act``
within one fp32 rounding (rtol 2^-23); ``chunk_id_map`` and the chunk
bounds equal.

Two corners where the JAX package's kernel and its oracle disagree, and
what the port follows:
- a constant (row, chunk) gets zero 0 from the dynamic kernel and
  ``-2^(b-1) - rint(S·β)`` from ``act_split_quantize_ref``; the port
  follows the kernel, and both dequantize such a chunk exactly;
- for the static form, XLA on the CPU contracts the interpret-mode
  kernel's ``S·x + Z`` into a fused multiply-add, which moves the
  rounding of a few values in millions; the port rounds the multiply
  and the add on their own, as ``act_split_quantize_static_ref`` does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.splitquant import activation_chunk_bounds as j_bounds
from repro.kernels import act_quant as ja

from repro_torch.core.splitquant import activation_chunk_bounds as t_bounds
from repro_torch.kernels import act_quant as ta

from test_torch_cuda import fma_tie_inputs, inside_share, static_qparams

R = 256                                     # one JAX row block


def _x(N, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((R, N)) * 2).astype(np.float32)
    x[0, 0] = 50.0                          # outlier in chunk 0
    x[1] = 1.5                              # constant row
    x[2] = 0.0                              # all-zero row
    x[3, :N // 4] = -2.25                   # one constant chunk
    return x


def _np(a):
    return np.asarray(a)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("N,n_chunks", [(96, 3), (128, 4), (128, 1)])
def test_dynamic_bit_identical_to_jax(bits, N, n_chunks):
    x = _x(N, bits * N + n_chunks)
    jk = [_np(a) for a in ja.act_split_quantize(
        jnp.asarray(x), bits=bits, n_chunks=n_chunks, interpret=True)]
    jr = [_np(a) for a in ja.act_split_quantize_ref(
        jnp.asarray(x), bits=bits, n_chunks=n_chunks)]
    tx = torch.from_numpy(x)
    for port in (ta.act_split_quantize(tx, bits=bits, n_chunks=n_chunks),
                 ta.act_split_quantize_ref(tx, bits=bits,
                                           n_chunks=n_chunks)):
        q, s, z = (a.numpy() for a in port)
        assert q.dtype == np.int8 and s.dtype == z.dtype == np.float32
        for a, b in zip((q, s, z), jk):
            np.testing.assert_array_equal(a, b)
        # the oracle: equal wherever the (row, chunk) range is not
        # degenerate; there, the same scale and an exact dequantization
        xc = x.reshape(R, n_chunks, N // n_chunks)
        live = xc.max(-1) > xc.min(-1)
        np.testing.assert_array_equal(s, jr[1])
        np.testing.assert_array_equal(z[live], jr[2][live])
        qc, jqc = q.reshape(xc.shape), jr[0].reshape(xc.shape)
        np.testing.assert_array_equal(qc[live], jqc[live])
        np.testing.assert_array_equal(
            ta.dequantize_act(*port).numpy(),
            _np(ja.dequantize_act(*(jnp.asarray(a) for a in jr))))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("N,n_chunks", [(96, 3), (97, 3), (128, 3),
                                        (128, 4)])
def test_static_bit_identical_to_jax(bits, N, n_chunks):
    x = _x(N, bits + N)
    gen = torch.Generator().manual_seed(bits + N + n_chunks)
    scale, zero = (a.numpy() for a in static_qparams(torch.from_numpy(x),
                                                     n_chunks, bits, gen))
    jargs = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(zero))
    jk = _np(ja.act_split_quantize_static(*jargs, bits=bits, interpret=True))
    jr = _np(ja.act_split_quantize_static_ref(*jargs, bits=bits))
    targs = (torch.from_numpy(x), torch.from_numpy(scale),
             torch.from_numpy(zero))
    for port in (ta.act_split_quantize_static(*targs, bits=bits),
                 ta.act_split_quantize_static_ref(*targs, bits=bits)):
        assert port.dtype == torch.int8 and inside_share(port, bits) > 0.5
        np.testing.assert_array_equal(port.numpy(), jk)
        np.testing.assert_array_equal(port.numpy(), jr)


def test_static_rounds_multiply_and_add_separately():
    xs, S, Z = fma_tie_inputs()
    fused = np.rint((np.float64(S) * xs.astype(np.float64) +
                     np.float64(Z)).astype(np.float32))
    separate = np.rint(S * xs + Z)
    assert xs.size > 0 and not np.array_equal(fused, separate)
    x = np.tile(xs, (8, 1))
    jr = _np(ja.act_split_quantize_static_ref(
        jnp.asarray(x), jnp.asarray([S]), jnp.asarray([Z])))
    got = ta.act_split_quantize_static(
        torch.from_numpy(x), torch.tensor([S]), torch.tensor([Z])).numpy()
    np.testing.assert_array_equal(got, jr)
    np.testing.assert_array_equal(
        got[0], np.clip(separate, -128, 127).astype(np.int8))


@pytest.mark.parametrize("n,n_chunks", [(96, 3), (97, 3), (128, 4), (130, 3),
                                        (2560, 3), (8960, 3), (2, 3)])
def test_chunk_maps_equal_jax(n, n_chunks):
    assert t_bounds(n, n_chunks) == j_bounds(n, n_chunks)
    if n_chunks <= n:
        np.testing.assert_array_equal(ta.chunk_id_map(n, n_chunks),
                                      ja.chunk_id_map(n, n_chunks))


@pytest.mark.parametrize("layout", ["dynamic", "static even",
                                    "static uneven"])
def test_dequantize_act_matches_jax(layout):
    rng = np.random.default_rng(3)
    N, n_chunks = (97, 3) if layout == "static uneven" else (96, 3)
    q = rng.integers(-128, 128, (R, N)).astype(np.int8)
    shape = (R, n_chunks) if layout == "dynamic" else (n_chunks,)
    scale = rng.uniform(0.5, 40, shape).astype(np.float32)
    zero = rng.uniform(-3, 3, shape).astype(np.float32)
    got = ta.dequantize_act(torch.from_numpy(q), torch.from_numpy(scale),
                            torch.from_numpy(zero)).numpy()
    want = _np(ja.dequantize_act(jnp.asarray(q), jnp.asarray(scale),
                                 jnp.asarray(zero)))
    np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0)


def test_wrappers_reject_bad_shapes():
    x = torch.zeros((4, 10))
    with pytest.raises(ValueError):
        ta.act_split_quantize(x, n_chunks=3)           # 10 % 3
    with pytest.raises(ValueError):
        ta.act_split_quantize(x, bits=1, n_chunks=2)
    with pytest.raises(ValueError):
        ta.act_split_quantize_static(x, torch.ones(3), torch.zeros(2))
    with pytest.raises(ValueError):
        ta.act_split_quantize_static(x, torch.ones(11), torch.zeros(11))
