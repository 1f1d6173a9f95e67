"""Port parity, quantization side: the PyTorch port (``repro_torch``)
against the JAX package on the same numpy inputs.

* qparams / quantize codes bit-identical (bits 2-8, symmetric and
  asymmetric, degenerate ranges);
* pack / unpack bytes bit-identical;
* SplitQuant cid / q / scale / zero identical given JAX's centroids
  (strided sample, first-index argmin ties);
* the port's own k-means: sorted centroids, cost within 1e-3 relative of
  JAX's;
* the bridge: JAX ``quantize_tree`` → numpy → port equals JAX
  ``dequantize_tree`` exactly, for stacked and unstacked leaves.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core.apply import QuantPolicy as JPolicy
from repro.core.apply import dequantize_tree as j_dequantize_tree
from repro.core.apply import quantize_tree as j_quantize_tree
from repro.core.kmeans import kmeans_1d as j_kmeans
from repro.core.splitquant import SplitQuantTensor as JSQT
from repro.core.splitquant import splitquant_tensor as j_splitquant
from repro.kernels import packing as jpack
from repro.models import get_model

from repro_torch import bridge
from repro_torch.core.kmeans import kmeans_1d as t_kmeans
from repro_torch.core.splitquant import (assign_and_quantize,
                                         strided_sample)
from repro_torch.kernels import packing as tpack

# the packages re-export a ``quantize`` function that shadows the module
jq = importlib.import_module("repro.core.quantize")
tq = importlib.import_module("repro_torch.core.quantize")


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed, degenerate):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((6, 40)) * 3).astype(np.float32)
    if degenerate:
        x[0] = 0.0                       # all-zero range → S = 1
        x[1] = -2.5                      # single negative value → S = 1/|v|
        x[2] = 0.75                      # single positive value
    return x


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("degenerate", [False, True])
def test_qparams_and_codes_bit_identical(bits, symmetric, degenerate):
    x = _inputs(bits, degenerate)
    jc = jq.QuantConfig(bits=bits, symmetric=symmetric)
    tc = tq.QuantConfig(bits=bits, symmetric=symmetric)
    jb, ja = jq.value_range(jnp.asarray(x), axis=1)
    tb, ta = tq.value_range(_t(x), dim=1)
    np.testing.assert_array_equal(_np(jb), tb.numpy())
    np.testing.assert_array_equal(_np(ja), ta.numpy())
    js, jz = jq.qparams(jb, ja, jc)
    ts, tz = tq.qparams(tb, ta, tc)
    np.testing.assert_array_equal(_np(js), ts.numpy())
    np.testing.assert_array_equal(_np(jz), tz.numpy())
    jcodes = jq.quantize(jnp.asarray(x), js[:, None], jz[:, None], jc)
    tcodes = tq.quantize(_t(x), ts[:, None], tz[:, None], tc)
    np.testing.assert_array_equal(_np(jcodes), tcodes.numpy())
    np.testing.assert_array_equal(
        _np(jq.dequantize(jcodes, js[:, None], jz[:, None])),
        tq.dequantize(tcodes, ts[:, None], tz[:, None]).numpy())


def test_round_half_to_even():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32)
    cfg_j, cfg_t = jq.QuantConfig(bits=8), tq.QuantConfig(bits=8)
    jcodes = jq.quantize(jnp.asarray(x), 1.0, 0.0, cfg_j)
    tcodes = tq.quantize(_t(x), 1.0, 0.0, cfg_t)
    np.testing.assert_array_equal(_np(jcodes), tcodes.numpy())
    np.testing.assert_array_equal(tcodes.numpy(), [0, 2, 2, 0, -2, -2])


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_pack_unpack_bit_identical(bits):
    rng = np.random.default_rng(bits)
    K, N = 48, 20
    q = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1), size=(K, N),
                     dtype=np.int8)
    cid = rng.integers(0, 3, size=(K, N), dtype=np.uint8)
    jp = _np(jpack.pack_codes(jnp.asarray(q), bits))
    tp = tpack.pack_codes(_t(q), bits)
    np.testing.assert_array_equal(jp, tp.numpy())
    np.testing.assert_array_equal(tpack.unpack_codes(tp, bits).numpy(), q)
    jc = _np(jpack.pack_cids(jnp.asarray(cid)))
    tc = tpack.pack_cids(_t(cid))
    np.testing.assert_array_equal(jc, tc.numpy())
    np.testing.assert_array_equal(tpack.unpack_cids(tc).numpy(), cid)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(64, 96), (300,)])
def test_splitquant_identical_given_jax_centroids(bits, shape):
    rng = np.random.default_rng(7)
    w = rng.standard_normal(shape).astype(np.float32)
    w.reshape(-1)[::17] *= 6.0                         # outliers
    w.reshape(-1)[5] = w.reshape(-1)[6]                # exact duplicates
    sample_size = 256                                  # < size: strided
    key = jax.random.PRNGKey(3)
    cfg = jq.QuantConfig(bits=bits)
    sq = j_splitquant(key, jnp.asarray(w), cfg, k=3, sample_size=sample_size)
    flat = jnp.asarray(w).reshape(-1)
    stride = flat.shape[0] // sample_size
    j_sample = flat[::stride][:sample_size]
    np.testing.assert_array_equal(
        _np(j_sample), strided_sample(_t(w).reshape(-1), sample_size).numpy())
    cents = j_kmeans(key, j_sample, k=3, iters=25).centroids
    got = assign_and_quantize(_t(w), _t(cents), tq.QuantConfig(bits=bits))
    np.testing.assert_array_equal(_np(sq.cid), got.cid.numpy())
    np.testing.assert_array_equal(_np(sq.q), got.q.numpy())
    np.testing.assert_array_equal(_np(sq.scale), got.scale.numpy())
    np.testing.assert_array_equal(_np(sq.zero), got.zero.numpy())
    np.testing.assert_array_equal(_np(sq.dequantize()),
                                  got.dequantize().numpy())


def test_argmin_tie_takes_first_centroid():
    # a value exactly between two centroids goes to the lower one
    w = np.array([0.0, 1.0, 2.0, 0.5, 1.5], np.float32)
    got = assign_and_quantize(_t(w), torch.tensor([0.0, 1.0, 2.0]),
                              tq.QuantConfig(bits=4))
    np.testing.assert_array_equal(got.cid.numpy(), [0, 1, 2, 0, 1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_sorted_and_cost_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(4096).astype(np.float32)
    j = j_kmeans(jax.random.PRNGKey(seed), jnp.asarray(x), k=3, iters=25)
    t = t_kmeans(torch.Generator().manual_seed(seed), _t(x), k=3, iters=25)
    c = t.centroids.numpy()
    assert np.all(np.diff(c) > 0), c
    jc, tc = float(j.cost), float(t.cost)
    assert abs(tc - jc) <= 1e-3 * jc, (tc, jc)


def test_kmeans_all_equal_points():
    t = t_kmeans(torch.Generator().manual_seed(0), torch.full((50,), 2.0),
                 k=3)
    np.testing.assert_array_equal(t.centroids.numpy(), [2.0, 2.0, 2.0])
    assert float(t.cost) == 0.0


def _to_numpy_tree(tree):
    """The test side of the bridge: JAX tree → nested dicts of numpy."""
    if isinstance(tree, JSQT):
        return {"q": _np(tree.q), "cid": _np(tree.cid),
                "scale": _np(tree.scale), "zero": _np(tree.zero),
                "bits": tree.bits, "k": tree.k,
                "orig_shape": tuple(tree.orig_shape)}
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    return _np(tree)


def test_bridge_round_trip_exact():
    cfg = get_arch("stablelm-1.6b").reduced()
    params = get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    jpol = JPolicy(cfg=jq.QuantConfig(bits=4))
    qtree, report = j_quantize_tree(jax.random.PRNGKey(1), params, jpol)
    assert "lm_head" in report["quantized"]
    assert "layers/attn/wq" in report["quantized"]
    deq = j_dequantize_tree(qtree)
    port = bridge.from_jax_tree(_to_numpy_tree(qtree), dtype=torch.float32,
                                device="cpu")
    # unstacked lm_head
    np.testing.assert_array_equal(_np(deq["lm_head"]),
                                  port["lm_head"].dequantize().numpy())
    # stacked (L, K, N) leaves → per-layer packed weights
    assert len(port["layers"]) == cfg.n_layers
    for name in ("wq", "wk", "wv", "wo"):
        for i in range(cfg.n_layers):
            np.testing.assert_array_equal(
                _np(deq["layers"]["attn"][name][i]),
                port["layers"][i]["attn"][name].dequantize().numpy())
    for name in ("w_gate", "w_up", "w_down"):
        for i in range(cfg.n_layers):
            np.testing.assert_array_equal(
                _np(deq["layers"]["ffn"][name][i]),
                port["layers"][i]["ffn"][name].dequantize().numpy())
    # unquantized leaves pass through unchanged
    np.testing.assert_array_equal(_np(qtree["embed"]),
                                  port["embed"].numpy())
    np.testing.assert_array_equal(
        _np(qtree["layers"]["ln1"]["norm_scale"][1]),
        port["layers"][1]["ln1"]["norm_scale"].numpy())
