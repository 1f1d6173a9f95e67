"""Port parity, the quantizer's percentile and per-channel options against
the JAX package on the same seeded numpy inputs: ``value_range``,
``fake_quant`` and ``quant_error``; the k=1 percentile branch per tensor
and per channel; per-channel SplitQuant given JAX's centroids;
``resolve_policy``; ``quantize_tree`` with per-path overrides and
``report["per_path"]``; the bridge and the plain matmul on a per-channel
tree; the activation split; and the percentile of a tensor above 2^24
elements, which ``torch.quantile`` refuses.

Tolerances: min/max ranges, codes, scales and zeros bit-identical. A
percentile is the two neighbouring sorted values a, b weighted in fp32,
a (1 - w) + b w: the port rounds the two products and the sum on their
own, XLA on the CPU contracts one product and the sum into an FMA, so a
percentile may differ by the rounding of one product, at most an ulp of
max(|a|, |b|) (2^-23 relative to it); everything computed from it is
held to what that can move: scales rtol 1e-6, zeros within 1, codes
within 1 and all but 1% identical, fake-quantized values within 1e-5 of
their magnitude but where a code moved (a step).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch
from repro.core.apply import QuantPolicy as JPolicy
from repro.core.apply import quantize_tree as j_quantize_tree
from repro.core.apply import resolve_policy as j_resolve
from repro.core.kmeans import kmeans_1d as j_kmeans
from repro.core.splitquant import baseline_quant_tensor as j_baseline
from repro.core.splitquant import effective_scales as j_effective
from repro.core.splitquant import split_activation_fake_quant as j_split_act
from repro.core.splitquant import splitquant_tensor as j_splitquant
from repro.kernels.ref import splitquant_matmul_ref as j_matmul_ref
from repro.kernels.ops import pack_for_kernel as j_pack
from repro.models import get_model as j_model

from repro_torch import bridge
from repro_torch.core import apply as tapply
from repro_torch.core.splitquant import (assign_and_quantize,
                                         baseline_quant_tensor,
                                         effective_scales,
                                         split_activation_fake_quant,
                                         strided_sample)
from repro_torch.kernels.ref import splitquant_matmul_ref

from test_torch_quant import _to_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

FAST_COMPILE = {"xla_backend_optimization_level": 0}
jq = importlib.import_module("repro.core.quantize")
tq = importlib.import_module("repro_torch.core.quantize")


def _np(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(shape, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w.reshape(-1)[::17] *= 6.0                         # outliers
    return w


@functools.cache
def _stablelm():
    """JAX's seeded fp32 stablelm-1.6b ``.reduced()`` weights and the
    port's, through the bridge."""
    cfg = j_arch("stablelm-1.6b").reduced()
    params = j_model(cfg).init(jax.random.PRNGKey(0), cfg)
    return params, bridge.from_jax_tree(_to_numpy_tree(params),
                                        dtype=torch.float32, device="cpu")


def _jax_quantized(overrides=None, per_channel=False):
    """JAX's INT4 ``quantize_tree`` of :func:`_stablelm`'s weights,
    jitted (same codes as eager, compiled faster), and its report."""
    jparams, _ = _stablelm()
    rep = {}

    def run(key, params):
        tree, r = j_quantize_tree(key, params, JPolicy(cfg=jq.QuantConfig(
            bits=4, per_channel=per_channel)), overrides=overrides)
        rep.update(r)
        return tree
    tree = jax.jit(run, compiler_options=FAST_COMPILE)(jax.random.PRNGKey(1),
                                                       jparams)
    return tree, rep


def _within_fma(got, want, x):
    """A percentile as JAX's, but for the rounding of one product: an
    ulp of the largest value it interpolates between (bounded by
    max |x|), and most of them identical."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want)
    assert d.max() <= 2.0 ** -23 * float(np.abs(x).max())
    assert (d == 0).mean() >= 0.5


# ---------------------------------------------------- ranges and config ---
def test_quant_config_checks_like_jax():
    for kw in (dict(percentile=0.5), dict(percentile=1.01),
               dict(bits=1)):
        with pytest.raises(ValueError):
            jq.QuantConfig(**kw)
        with pytest.raises(ValueError):
            tq.QuantConfig(**kw)
    assert tq.QuantConfig(percentile=1.0, per_channel=True).per_channel


@pytest.mark.parametrize("shape,dim", [((997,), None), ((64, 48), None),
                                       ((64, 48), (0,)), ((6, 8, 10), (1, 2))])
@pytest.mark.parametrize("p", [None, 0.99, 0.999, 1.0])
def test_value_range_matches_jax(shape, dim, p):
    x = _weights(shape, seed=len(shape))
    jb, ja = jq.value_range(jnp.asarray(x), p, axis=dim)
    tb, ta = tq.value_range(_t(x), p, dim=dim)
    for got, want in ((tb, jb), (ta, ja)):
        assert got.shape == tuple(np.shape(want))
        if p is None or p == 1.0:
            np.testing.assert_array_equal(got.numpy(), _np(want))
        else:           # the fused product and sum of XLA's CPU code
            _within_fma(got.numpy(), want, x)


@pytest.mark.parametrize("cfg_kw", [dict(bits=4), dict(bits=8, symmetric=True),
                                    dict(bits=4, percentile=0.99),
                                    dict(bits=2, per_channel=True),
                                    dict(bits=4, per_channel=True,
                                         percentile=0.999)])
def test_fake_quant_and_quant_error_match_jax(cfg_kw):
    x = _weights((48, 40), seed=3)
    jcfg, tcfg = jq.QuantConfig(**cfg_kw), tq.QuantConfig(**cfg_kw)
    want = _np(jq.fake_quant(jnp.asarray(x), jcfg))
    got = tq.fake_quant(_t(x), tcfg).numpy()
    werr = float(jq.quant_error(jnp.asarray(x), jcfg))
    gerr = float(tq.quant_error(_t(x), tcfg))
    if "percentile" not in cfg_kw:
        np.testing.assert_array_equal(got, want)
        assert gerr == pytest.approx(werr, rel=1e-6)
    else:
        # the scale moves by ~1e-7 relative: values by as much, a code
        # by one step where S·x sits on a rounding tie
        step = float(np.abs(x).max()) * 2 / (2 ** cfg_kw["bits"] - 1)
        d = np.abs(got - want)
        assert d.max() <= step * 1.01
        assert (d <= 1e-5 * np.maximum(1, np.abs(want))).mean() >= 0.99
        assert gerr == pytest.approx(werr, rel=1e-3)


# --------------------------------------------------- the k=1 branches ---
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("p", [0.99, 0.999])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_percentile_baseline_matches_jax(bits, p, per_channel):
    """k=1 with a percentile, per tensor (scale (1,)) and per channel
    ((1, out)): scales within the ulp the range may differ by, codes
    identical except where S·x sits within that of a rounding tie."""
    w = _weights((96, 40), seed=bits)
    kw = dict(bits=bits, percentile=p, per_channel=per_channel)
    sq = j_baseline(jnp.asarray(w), jq.QuantConfig(**kw))
    got = baseline_quant_tensor(_t(w), tq.QuantConfig(**kw))
    assert got.scale.shape == _np(sq.scale).shape == \
        ((1, 40) if per_channel else (1,))
    assert got.k == 1 and not got.cid.any()
    np.testing.assert_allclose(got.scale.numpy(), _np(sq.scale), rtol=1e-6)
    assert np.abs(got.zero.numpy() - _np(sq.zero)).max() <= 1
    dq = np.abs(got.q.numpy().astype(int) - _np(sq.q).astype(int))
    assert dq.max() <= 1 and (dq > 0).mean() < 0.01
    # the clip is real: some codes sit on the ends of the range
    assert (np.abs(got.q.numpy()) >= 2 ** (bits - 1) - 1).any()


@pytest.mark.parametrize("bits,shape", [(2, (128, 48)), (4, (40, 33))])
def test_per_channel_splitquant_identical_given_jax_centroids(bits, shape):
    w = _weights(shape, seed=7)
    sample_size = 256
    key = jax.random.PRNGKey(3)
    cfg = dict(bits=bits, per_channel=True)
    sq = j_splitquant(key, jnp.asarray(w), jq.QuantConfig(**cfg), k=3,
                      sample_size=sample_size)
    flat = jnp.asarray(w).reshape(-1)
    j_sample = flat[::flat.shape[0] // sample_size][:sample_size]
    np.testing.assert_array_equal(
        _np(j_sample), strided_sample(_t(w).reshape(-1), sample_size).numpy())
    cents = j_kmeans(key, j_sample, k=3, iters=25).centroids
    got = assign_and_quantize(_t(w), _t(cents), tq.QuantConfig(**cfg))
    assert got.per_channel and got.scale.shape == (3, shape[1])
    for a, b in ((got.cid, sq.cid), (got.q, sq.q), (got.scale, sq.scale),
                 (got.zero, sq.zero), (got.dequantize(), sq.dequantize())):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for a, b in zip(got.split_layers(), sq.split_layers()):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    assert got.nbytes_deployed() == sq.nbytes_deployed()
    np.testing.assert_array_equal(effective_scales(got).numpy(),
                                  _np(j_effective(sq)))


@pytest.mark.parametrize("n,n_chunks", [(96, 3), (100, 3), (7, 4)])
def test_split_activation_fake_quant_matches_jax(n, n_chunks):
    x = _weights((5, n), seed=n)
    cfg = dict(bits=4)
    want = j_split_act(jnp.asarray(x), jq.QuantConfig(**cfg), n_chunks)
    got = split_activation_fake_quant(_t(x), tq.QuantConfig(**cfg), n_chunks)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_percentile_above_two_to_the_24_matches_jax():
    """torch.quantile refuses this many elements; the port's sort and
    fp32 rank (n itself rounds in fp32 here) give JAX's value. The
    values come sorted, so that both sorts take seconds, not ten."""
    n = (1 << 24) + 4097
    x = np.sort(np.random.default_rng(9).standard_normal(n)
                .astype(np.float32))
    with pytest.raises(RuntimeError):
        torch.quantile(_t(x), 0.99)
    want = jnp.percentile(jnp.asarray(x), 99.0)
    got = tq.linear_percentile(_t(x), 99.0)
    _within_fma(got.numpy()[None], _np(want)[None], x)


# ------------------------------------------------------------ policies ---
@pytest.mark.parametrize("method", ["splitquant", "baseline", "percentile",
                                    "none"])
@pytest.mark.parametrize("override", [None, {"percentile": 0.995},
                                      {"bits": 2, "k": 1},
                                      {"method": "percentile"}])
def test_resolve_policy_matches_jax(method, override):
    jp = j_resolve(JPolicy(cfg=jq.QuantConfig(bits=4), method=method),
                   override)
    tp = tapply.resolve_policy(tapply.QuantPolicy(
        cfg=tq.QuantConfig(bits=4), method=method), override)
    assert (tp.method, tp.k, tp.cfg.bits, tp.cfg.percentile) == \
        (jp.method, jp.k, jp.cfg.bits, jp.cfg.percentile)
    with pytest.raises(ValueError, match="unknown override"):
        tapply.resolve_policy(tapply.QuantPolicy(), {"gamma": 1})


def test_quantize_tree_overrides_match_jax():
    """Overrides by the JAX package's paths on the stablelm-1.6b tree:
    per_path's bits, k and method as JAX's, a ``none`` leaf left in fp,
    a percentile leaf's scales as JAX's, an unmatched path raising."""
    jparams, tparams = _stablelm()
    overrides = {"layers/attn/wq": {"bits": 2, "k": 1},
                 "layers/ffn/w_down": {"method": "none"},
                 "layers/attn/wo": {"method": "percentile",
                                    "percentile": 0.995},
                 "lm_head": {"method": "baseline", "bits": 8}}
    _, jrep = _jax_quantized(overrides)
    tq_tree, trep = tapply.quantize_tree(
        tparams, tapply.QuantPolicy(cfg=tq.QuantConfig(bits=4)),
        overrides=overrides)
    # bits, k, method and deployed bytes, counted as JAX counts them
    assert trep["per_path"] == jrep["per_path"]
    for key in ("deployed_bytes", "orig_bytes"):
        assert trep[key] == jrep[key], key
    lay = tq_tree["layers"][0]
    assert isinstance(lay["ffn"]["w_down"], torch.Tensor)
    assert lay["attn"]["wq"].bits == 2 and lay["attn"]["wq"].k == 1
    # the percentile leaf of every layer, against JAX's baseline of it
    for i, layer in enumerate(tq_tree["layers"]):
        w = _np(jparams["layers"]["attn"]["wo"][i])
        sq = j_baseline(jnp.asarray(w), jq.QuantConfig(bits=4,
                                                       percentile=0.995))
        np.testing.assert_allclose(layer["attn"]["wo"].scale.numpy(),
                                   _np(sq.scale), rtol=1e-6)
    for bad in ({"layers/attn/nope": {"bits": 2}},
                {"layers/0/attn/wq": {"bits": 2}}):
        with pytest.raises(ValueError, match="matched no"):
            tapply.quantize_tree(tparams, tapply.QuantPolicy(),
                                 overrides=bad)


@pytest.mark.parametrize("method,per_channel", [
    ("splitquant", True), ("baseline", False), ("baseline", True),
    ("percentile", False), ("percentile", True)])
def test_quantize_tree_report_bytes_match_jax(method, per_channel):
    """The report's per-path and total bytes are JAX's count (packed codes,
    2-bit cids only when k > 1, the (k,) or (k, N) scales), not the kernel
    layout's, for every method and layout (per-tensor SplitQuant: the
    overrides test). SplitQuant per channel: the JAX tree's own report
    against its leaves through the bridge."""
    jparams, tparams = _stablelm()
    if method == "splitquant" and per_channel:
        qtree, jrep = _jax_quantized(per_channel=True)
        port = bridge.from_jax_tree(_to_numpy_tree(qtree),
                                    dtype=torch.float32, device="cpu")
        per_path = {}
        for layer in port["layers"]:
            for grp in ("attn", "ffn"):
                for name, w in layer[grp].items():
                    per_path[f"layers/{grp}/{name}"] = per_path.get(
                        f"layers/{grp}/{name}", 0) + w.unpack().nbytes_deployed()
        per_path["lm_head"] = port["lm_head"].unpack().nbytes_deployed()
        assert per_path == {p: e["bytes"] for p, e in jrep["per_path"].items()}
        assert sum(per_path.values()) == jrep["deployed_bytes"]
        return
    jcfg = jq.QuantConfig(bits=2, per_channel=per_channel)
    _, jrep = j_quantize_tree(jax.random.PRNGKey(1), jparams,
                              JPolicy(cfg=jcfg, method=method))
    _, trep = tapply.quantize_tree(tparams, tapply.QuantPolicy(
        cfg=tq.QuantConfig(bits=2, per_channel=per_channel), method=method))
    assert trep["per_path"] == jrep["per_path"]
    for key in ("deployed_bytes", "orig_bytes"):
        assert trep[key] == jrep[key], key


# ------------------------------------------- per-channel through the port ---
def test_bridge_and_plain_matmul_on_a_per_channel_tree():
    """A JAX per-channel INT4 tree through the bridge: dequantized
    weights as JAX's, and the plain matmul as JAX's
    ``ref.splitquant_matmul_ref`` on the same packed operands."""
    qtree, _ = _jax_quantized(per_channel=True)
    port = bridge.from_jax_tree(_to_numpy_tree(qtree), dtype=torch.float32,
                                device="cpu")
    jw = jax.tree_util.tree_map(lambda a: a[0], qtree["layers"]["attn"]["wq"])
    tw = port["layers"][0]["attn"]["wq"]
    assert tuple(tw.scale.shape) == (3, tw.shape[1])
    np.testing.assert_array_equal(tw.dequantize().numpy(),
                                  _np(jw.dequantize()))
    x = np.random.default_rng(2).standard_normal(
        (5, tw.shape[0])).astype(np.float32)
    qp, cp, recip, shift = j_pack(jw)
    for a, b in ((tw.recip, recip), (tw.shift, shift)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    want = j_matmul_ref(jnp.asarray(x), qp, cp, recip, shift, bits=4)
    got = splitquant_matmul_ref(_t(x), tw.qp, tw.cp, tw.recip, tw.shift, 4)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))
