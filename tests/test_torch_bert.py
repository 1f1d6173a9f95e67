"""Port parity, bert-tiny (the encoder family) and quantized biases: the
Table 1 datasets, ``bert_tiny.init/forward/loss_fn/accuracy``, the §4.2
activation fake-quant, ``collect_act_stats``, ``quantize_tree`` with the
biases, the bridge, ``dense`` over a quantized tree, checkpoints of one,
``layer_sensitivity`` over the bias groups and ``launch.table1`` at a tiny
size, against the JAX package on the same seeded weights (JAX's
``bert_tiny.init`` through the bridge).

Tolerances: datasets and batches, codes, cluster ids, scales, zeros,
deployed bytes and checkpoint arrays identical;
logits within 1e-5 x their scale (the two packages sum the products in
another order), with the same argmax; loss and gradients within 1e-5
relative (each gradient leaf against its largest entry); activation
statistics within 1e-5 relative (they reduce each package's own
activations, some ulps apart after two layers); sensitivity mse/kl within 1e-3 relative
plus 2e-7 (the fp32 log-softmax's rounding). JAX references are shared through ``functools.cache``; torch
runs on one intra-op thread.
"""
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.calib import collect_act_stats as j_collect_act
from repro.calib import layer_sensitivity as j_sensitivity
from repro.checkpoint import ckpt as jck
from repro.configs import get_arch
from repro.core import QuantConfig, QuantPolicy, quantize_tree
from repro.core.apply import dequantize_tree as j_dequantize_tree
from repro.core.kmeans import kmeans_1d as j_kmeans
from repro.data import classification as jcls
from repro.models import bert_tiny as jbert

from repro_torch import bridge, calib
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import apply as tapply
from repro_torch.core.quantize import QuantConfig as TQuantConfig
from repro_torch.core import splitquant as tsq
from repro_torch.core.splitquant import SplitQuantTensor
from repro_torch.data import classification as tcls
from repro_torch.kernels.ops import PackedWeight
from repro_torch.launch import table1
from repro_torch.models import bert_tiny as tbert
from repro_torch.models import get_model as t_get_model

from test_torch_quant import _to_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
S = 24
N_CLASSES = 6
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _np(a):
    return np.asarray(a)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


@functools.cache
def _jax_bert():
    """JAX's seeded bert-tiny (6 classes, 24 positions) with non-zero
    biases (a trained model's are not zero), and the port's copy."""
    cfg = get_arch("bert-tiny")
    params = jax.jit(jbert.init, static_argnums=(1, 2),
                     static_argnames="max_len",
                     compiler_options=FAST_COMPILE)(KEY, cfg, N_CLASSES,
                                                    max_len=S)
    rng = np.random.default_rng(11)

    def nudge(path, x):
        name = jax.tree_util.keystr(path)
        if x.ndim >= 1 and ("'b" in name and "norm" not in name):
            return x + jnp.asarray(
                rng.standard_normal(x.shape).astype(np.float32) * 0.1)
        return x
    params = jax.tree_util.tree_map_with_path(nudge, params)
    port = bridge.from_jax_tree(_to_numpy_tree(params), device="cpu")
    return types.SimpleNamespace(cfg=cfg, tcfg=t_arch("bert-tiny"),
                                 jparams=params, port=port)


def _batch(pad: bool, B: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(100, 30522, size=(B, S)).astype(np.int32)
    toks[:, 0] = 101
    mask = np.ones((B, S), np.int32)
    if pad:
        for b, L in enumerate((S, 5, 13, 20)[:B]):
            mask[b, L:] = 0
            toks[b, L:] = 0
    labels = rng.integers(0, N_CLASSES, size=B).astype(np.int32)
    return {"tokens": toks, "mask": mask, "labels": labels}


def _t(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_forward():
    cfg = _jax_bert().cfg
    return jax.jit(lambda p, b: jbert.forward(p, cfg, b),
                   compiler_options=FAST_COMPILE)


# ------------------------------------------------------------- datasets ---
@pytest.mark.parametrize("maker", ["emotion_like", "spam_like"])
def test_datasets_are_bit_identical(maker):
    want = getattr(jcls, maker)(n_samples=120, seq_len=32, seed=3)
    got = getattr(tcls, maker)(n_samples=120, seq_len=32, seed=3)
    assert (got.name, got.n_classes, got.seq_len) == \
        (want.name, want.n_classes, want.seq_len)
    for f in ("tokens", "labels", "mask"):
        assert getattr(got, f).dtype == getattr(want, f).dtype
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("train,epochs", [(True, 2), (False, 1)])
def test_batches_are_bit_identical(train, epochs):
    ds = jcls.spam_like(n_samples=100, seq_len=16)
    tds = tcls.spam_like(n_samples=100, seq_len=16)
    want = list(jcls.batches(ds, 32, seed=5, train=train, epochs=epochs))
    got = list(tcls.batches(tds, 32, seed=5, train=train, epochs=epochs,
                            device="cpu"))
    assert len(got) == len(want) == 3 * epochs
    for g, w in zip(got, want):
        for k in ("tokens", "labels", "mask"):
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_split_takes_the_first_n_and_the_rest():
    ds = tcls.emotion_like(n_samples=50, seq_len=16)
    tr, te = tcls.split(ds, 40)
    assert tr.tokens.shape == (40, 16) and te.labels.shape == (10,)
    np.testing.assert_array_equal(te.mask, ds.mask[40:])


# ----------------------------------------------------------------- model ---
def test_config_and_get_model():
    t, j = t_arch("bert-tiny"), get_arch("bert-tiny")
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_ff", "vocab", "norm_type", "ffn_type", "bias",
              "param_dtype", "head_dim"):
        assert getattr(t, f) == getattr(j, f), f
    assert t_get_model(t) is tbert


def test_init_shapes_match_jax():
    s = _jax_bert()
    port = tbert.init(s.tcfg, N_CLASSES, max_len=S, seed=1, device="cpu")
    want = jax.tree_util.tree_map(lambda x: x.shape, s.jparams)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):               # the layer stack
            inner = [shapes(v) for v in tree]
            return jax.tree_util.tree_map(lambda x: (len(tree), *x),
                                          inner[0],
                                          is_leaf=lambda x: isinstance(
                                              x, tuple))
        return tuple(tree.shape)
    assert shapes(port) == want
    assert port["layers"][0]["attn"]["bq"].abs().sum() == 0


@pytest.mark.parametrize("pad", [False, True])
def test_forward_matches_jax(pad):
    s = _jax_bert()
    b = _batch(pad)
    want = _np(_jax_forward()(s.jparams, _j(b)))
    with torch.no_grad():
        got = tbert.forward(s.port, s.tcfg, _t(b))
    assert got.dtype == torch.float32 and got.shape == (4, N_CLASSES)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    if pad:     # padding keys are never attended: changing them changes
        b2 = dict(b)                     # nothing
        b2["tokens"] = np.where(b["mask"] > 0, b["tokens"], 777)
        with torch.no_grad():
            again = tbert.forward(s.port, s.tcfg, _t(b2))
        _close(again.numpy(), got.numpy(), 1e-6)


@pytest.mark.parametrize("chunks", [1, 3])
def test_forward_with_activation_fake_quant_matches_jax(chunks, monkeypatch):
    """§4.2 fake-quant at 8 bits in the forward. Each site's input differs
    from JAX's by the ulps of another summation order, so a code exactly
    on a rounding tie can land one step apart: JAX's forward runs site by
    site with the port's quantized activation put in its place, after its
    own quantization of its own input was checked to be the port's but
    for such one-step ties (at most 0.1% of a site's elements). The
    logits then agree within 1e-5 x their scale."""
    import repro.core as jcore
    s = _jax_bert()
    b = _batch(True)
    sites = []
    port_fq = tbert.split_activation_fake_quant

    def record(h, cfg, n_chunks):
        sites.append(port_fq(h, cfg, n_chunks=n_chunks))
        return sites[-1]
    monkeypatch.setattr(tbert, "split_activation_fake_quant", record)
    with torch.no_grad():
        got = tbert.forward(s.port, s.tcfg, _t(b),
                            act_quant=TQuantConfig(bits=8),
                            act_chunks=chunks)
        plain = tbert.forward(s.port, s.tcfg, _t(b))
    assert len(sites) == 4 * s.cfg.n_layers
    assert not torch.equal(got, plain)
    port_sites = iter(sites)
    jax_fq = jcore.split_activation_fake_quant
    seen = []

    def swap(h, own):
        """(JAX's input, JAX's own fake-quant of it) in, the port's out."""
        seen.append((np.asarray(h), np.asarray(own),
                     next(port_sites).numpy()))
        return seen[-1][2]

    def forced(h, cfg, n_chunks):
        own = jax_fq(h, cfg, n_chunks=n_chunks)
        return jax.pure_callback(swap, jax.ShapeDtypeStruct(h.shape,
                                                            h.dtype), h, own)
    monkeypatch.setattr(jcore, "split_activation_fake_quant", forced)
    want = _np(jax.jit(lambda p, bb: jbert.forward(
        p, s.cfg, bb, act_quant=QuantConfig(bits=8), act_chunks=chunks),
        compiler_options=FAST_COMPILE)(s.jparams, _j(b)))
    assert len(seen) == len(sites)
    for hn, own, theirs in seen:
        step = float(hn.max() - hn.min()) / (2 ** 8 - 1)
        off = np.abs(own - theirs) > 1e-6 * max(1.0, float(np.abs(
            hn).max()))
        assert off.mean() <= 1e-3, off.mean()
        assert np.all(np.abs(own - theirs)[off] <= 1.001 * step)
    _close(got.numpy(), want)


def _flat(tree, prefix=""):
    """{path: numpy array} of a tree, a layer stack stacked on axis 0 (the
    JAX layout); ``fn`` of each torch leaf."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        per = [_flat(v, prefix) for v in tree]
        return {k: np.stack([p[k] for p in per]) for k in per[0]}
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().numpy()}
    return {prefix[:-1]: np.asarray(tree)}


def _leaves_close(got: dict, want: dict, rel=1e-5):
    """Every leaf within ``rel`` of its largest entry, or of 1% of the
    tree's largest for a leaf that vanishes in exact arithmetic (the key
    bias's gradient: softmax ignores a shift shared by every key)."""
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        assert err <= rel * max(float(np.abs(w).max()), 1e-2 * top), \
            (k, err)


def _with_grad(tree, leaves):
    if isinstance(tree, dict):
        return {k: _with_grad(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_grad(v, leaves) for v in tree]
    t = tree.detach().clone().requires_grad_(True)
    leaves.append(t)
    return t


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return tree.grad


def test_loss_and_grads_match_jax():
    s = _jax_bert()
    b = _batch(True)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jbert.loss_fn(p, s.cfg, _j(b)), has_aux=True),
        compiler_options=FAST_COMPILE)(s.jparams)
    port = _with_grad(s.port, [])
    loss, metrics = tbert.loss_fn(port, s.tcfg, _t(b))
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(metrics["acc"]) == float(jm["acc"])
    _leaves_close(_flat(_grads(port)), _flat(_to_numpy_tree(jg)))
    acc = tbert.accuracy(s.port, s.tcfg, _t(b))
    assert float(acc) == float(jbert.accuracy(s.jparams, s.cfg, _j(b)))


# ------------------------------------------------------ activation stats ---
@functools.cache
def _jax_act_stats():
    s = _jax_bert()
    b1, b2 = _batch(True, seed=1), _batch(False, seed=2)
    batches = [{k: v for k, v in b.items() if k != "labels"}
               for b in (b1, b2)]
    return j_collect_act(s.cfg, s.jparams, batches, n_chunks=3), batches


def test_collect_act_stats_matches_jax():
    s = _jax_bert()
    want, batches = _jax_act_stats()
    got = calib.collect_act_stats(s.tcfg, s.port, batches, n_chunks=3)
    assert (got.n_chunks, got.percentile, got.n_batches) == \
        (want.n_chunks, want.percentile, want.n_batches)
    assert set(got.sites) == set(want.sites) == set(tbert.ACT_SITES)
    for site, d in want.sites.items():
        for k, v in d.items():
            g = got.sites[site][k]
            assert g.shape == v.shape and g.dtype == v.dtype, (site, k)
            np.testing.assert_allclose(g, v, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{site} {k}")


def test_static_act_scales_from_port_stats():
    """``act_static_scales`` of the port's statistics: per (layer, chunk),
    finite, and the reconstruction of an activation inside the calibrated
    range bounded by a step (the CPU side of the card's kernel test)."""
    s = _jax_bert()
    _, batches = _jax_act_stats()
    stats = calib.collect_act_stats(s.tcfg, s.port, batches, n_chunks=3)
    scales = calib.act_static_scales(stats)["ffn_in"]
    assert scales["scale"].shape == (s.cfg.n_layers, 3)
    from repro_torch.kernels.act_quant import (act_split_quantize_static,
                                               dequantize_act)
    sc = torch.from_numpy(scales["scale"][0])
    zr = torch.from_numpy(scales["zero"][0])
    x = torch.randn((64, s.cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    xd = dequantize_act(act_split_quantize_static(x, sc, zr, bits=8),
                        sc, zr)
    bounds = tsq.activation_chunk_bounds(s.cfg.d_model, 3)
    for c, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        inside = x[:, lo:hi].abs() < 2.0
        err = (xd[:, lo:hi] - x[:, lo:hi]).abs()[inside]
        assert float(err.max()) <= 1.0 / float(sc[c]) + 1e-5


# ------------------------------------------------------ quantized trees ---
@functools.cache
def _jax_quantized(bits, method):
    """JAX's quantize_tree of the bert weights, jitted once."""
    s = _jax_bert()
    rep = {}

    def run(key, p):
        tree, r = quantize_tree(key, p, QuantPolicy(
            cfg=QuantConfig(bits=bits), method=method, k=3))
        rep.update(r)
        return tree
    qtree = jax.jit(run, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(1), s.jparams)
    return qtree, rep


BIAS_PATHS = {"layers/attn/bq", "layers/attn/bk", "layers/attn/bv",
              "layers/attn/bo", "layers/ffn/b_up", "layers/ffn/b_down",
              "pooler/b"}


@pytest.mark.parametrize("bits,method", [(2, "splitquant"), (2, "baseline"),
                                         (8, "splitquant"), (8, "baseline")])
def test_jax_quantized_tree_through_the_bridge(bits, method):
    """JAX's quantize_tree (biases included) carried by the bridge: the
    port's forward through ``dense`` (packed matrices, quantized biases
    dequantized) against JAX's forward on ``dequantize_tree``."""
    s = _jax_bert()
    qtree, rep = _jax_quantized(bits, method)
    assert BIAS_PATHS <= set(rep["quantized"])
    assert "classifier/b" in rep["skipped"]
    port = bridge.from_jax_tree(_to_numpy_tree(qtree), device="cpu")
    assert isinstance(port["layers"][1]["attn"]["wq"], PackedWeight)
    bq = port["layers"][1]["attn"]["bq"]
    assert isinstance(bq, SplitQuantTensor) and bq.shape == (128,)
    np.testing.assert_array_equal(bq.dequantize().numpy(),
                                  _np(qtree["layers"]["attn"]["bq"]
                                      .dequantize())[1])
    assert isinstance(port["classifier"]["b"], torch.Tensor)
    b = _batch(True)
    want = _np(_jax_forward()(j_dequantize_tree(qtree), _j(b)))
    with torch.no_grad():
        got = tbert.forward(port, s.tcfg, _t(b))
        deq = tbert.forward(tapply.dequantize_tree(port), s.tcfg, _t(b))
    _close(got.numpy(), want)
    _close(deq.numpy(), want)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


@functools.cache
def _jax_bias_centroids():
    """{bytes of one layer's bias: the centroids JAX's k-means draws for
    it in quantize_tree} (a key a leaf in flatten order; a stack's layers
    vmapped). The bits do not enter k-means."""
    s = _jax_bert()
    flat, _ = jax.tree_util.tree_flatten_with_path(s.jparams)
    keys = jax.random.split(jax.random.PRNGKey(1), len(flat))
    fit = lambda kk, m: j_kmeans(kk, m, k=3, iters=25).centroids  # noqa
    fit = jax.jit(fit, compiler_options=FAST_COMPILE)
    cents = {}
    for (path, leaf), k in zip(flat, keys):
        name = "/".join(str(p.key) for p in path)
        if name not in BIAS_PATHS:
            continue
        if name.startswith("layers/"):
            c = jax.vmap(fit)(jax.random.split(k, leaf.shape[0]), leaf)
            pairs = zip(leaf, c)
        else:
            pairs = [(leaf, fit(k, leaf))]
        for m, cc in pairs:
            cents[np.asarray(m, np.float32).tobytes()] = np.asarray(cc)
    return cents


@pytest.mark.parametrize("bits", [2, 8])
def test_port_quantize_tree_biases_match_jax_given_its_centroids(
        bits, monkeypatch):
    """The port's own quantize_tree of the same weights, each bias given
    the centroids JAX's k-means drew (the matrices take the port's own):
    every bias's codes, cluster ids, scales and zeros as JAX's, and the
    report's paths and deployed bytes as JAX's report."""
    s = _jax_bert()
    qtree, rep = _jax_quantized(bits, "splitquant")
    cents = _jax_bias_centroids()
    port_fit = tsq.fit_centroids

    def fit(gen, w, *a, **kw):
        key = w.numpy().astype(np.float32).tobytes()
        if key in cents:
            return torch.from_numpy(cents[key].copy())
        return port_fit(gen, w, *a, **kw)
    monkeypatch.setattr(tsq, "fit_centroids", fit)
    got, trep = tapply.quantize_tree(
        s.port, tapply.QuantPolicy(cfg=TQuantConfig(bits=bits)))
    assert trep["per_path"] == rep["per_path"]
    assert trep["deployed_bytes"] == rep["deployed_bytes"]
    assert trep["orig_bytes"] == rep["orig_bytes"]
    assert len(cents) == 2 * 6 + 1
    for path in sorted(BIAS_PATHS):
        parts = path.split("/")
        want = functools.reduce(lambda t, k: t[k], parts, qtree)
        if parts[0] == "layers":
            leaves = [got["layers"][i][parts[1]][parts[2]]
                      for i in range(s.cfg.n_layers)]
        else:
            leaves = [got[parts[0]][parts[1]]]
        for i, leaf in enumerate(leaves):
            assert isinstance(leaf, SplitQuantTensor), path
            for f in ("q", "cid", "scale", "zero"):
                w = _np(getattr(want, f))
                w = w[i] if parts[0] == "layers" else w
                np.testing.assert_array_equal(getattr(leaf, f).numpy(), w,
                                              err_msg=f"{path} {f}")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_with_quantized_biases_both_ways(writer, tmp_path):
    s = _jax_bert()
    qtree, _ = _jax_quantized(2, "splitquant")
    port = bridge.from_jax_tree(_to_numpy_tree(qtree), device="cpu")
    d = str(tmp_path)
    if writer == "jax":
        jck.save(d, 3, qtree)
        got, step = ckpt.restore(d, s.port)
    else:
        ckpt.save(d, 3, port)
        jgot, step = jck.restore(d, s.jparams)
        got = bridge.from_jax_tree(_to_numpy_tree(jgot), device="cpu")
    assert step == 3
    with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
        man = json.load(f)
    meta = man["quant_meta"]["['layers']['attn']['bq']"]
    assert meta["orig_shape"] == [128] and meta["bits"] == 2
    assert man["shapes"]["['layers']['attn']['bq'].q"] == [2, 128]
    assert man["shapes"]["['pooler']['b'].scale"] == [3]
    bq = got["layers"][0]["attn"]["bq"]
    assert isinstance(bq, SplitQuantTensor)
    for f in ("q", "cid", "scale", "zero"):
        assert torch.equal(getattr(bq, f),
                           getattr(port["layers"][0]["attn"]["bq"], f)), f
    assert isinstance(got["layers"][1]["ffn"]["w_up"], PackedWeight)
    b = _t(_batch(True))
    with torch.no_grad():
        assert torch.equal(tbert.forward(got, s.tcfg, b),
                           tbert.forward(port, s.tcfg, b))


def test_quantized_bias_moves_with_tree_to():
    s = _jax_bert()
    qtree, _ = _jax_quantized(2, "splitquant")
    port = bridge.from_jax_tree(_to_numpy_tree(qtree), device="cpu")
    moved = tapply.tree_to(port, "cpu")
    bq = moved["pooler"]["b"]
    assert isinstance(bq, SplitQuantTensor) and bq.q.device.type == "cpu"


def _scored(path: str) -> bool:
    """The groups the sensitivity test scores: the biases and the
    classifier (the matrices' groups are stablelm's test's); ``path`` with
    or without a layer index."""
    path = "/".join(p for p in path.split("/") if not p.isdigit())
    return path in BIAS_PATHS or path == "classifier/w"


def test_layer_sensitivity_takes_the_bias_groups_as_jax():
    from repro.core.apply import _quantizable as j_quantizable
    s = _jax_bert()
    b = {k: v for k, v in _batch(True).items() if k != "labels"}
    want = j_sensitivity(KEY, s.cfg, s.jparams,
                         lambda p, bb: jbert.forward(p, s.cfg, bb), b,
                         policy=QuantPolicy(method="baseline"),
                         bits_list=(2, 8),
                         is_quantizable=lambda p, leaf, pol: _scored(p) and
                         j_quantizable(p, leaf, pol))
    got = calib.layer_sensitivity(
        0, s.tcfg, s.port, lambda p, bb: tbert.forward(p, s.tcfg, bb), b,
        policy=tapply.QuantPolicy(method="baseline"), bits_list=(2, 8),
        is_quantizable=lambda p, leaf, stack: _scored(p) and
        tapply._quantizable(p, leaf, stack))
    assert set(want) == BIAS_PATHS | {"classifier/w"}
    assert list(got) == list(want)
    _, jrep = _jax_quantized(2, "splitquant")
    groups = calib.quantizable_groups(s.port)
    assert [g for g, _ in groups] == sorted(jrep["per_path"],
                                             key=lambda p: p.split("/"))
    for path, row in want.items():
        assert (got[path]["size"], got[path]["orig_bytes"]) == \
            (row["size"], row["orig_bytes"])
        for bits, r in row["per_bits"].items():
            g = got[path]["per_bits"][bits]
            assert g["bytes"] == r["bytes"], (path, bits)
            for m in ("mse", "kl"):      # + the fp32 log-softmax's ulps
                assert abs(g[m] - r[m]) <= 1e-3 * abs(r[m]) + 2e-7, \
                    (path, bits, m, g[m], r[m])


# --------------------------------------------------------------- table 1 ---
def test_table1_at_a_tiny_size_on_the_cpu(capsys):
    """The CLI end to end: two tasks of 500 examples, one epoch; the
    quantized evaluations run the packed tree through the plain matmul,
    and INT8 SplitQuant stays within 5%p of FP32."""
    res = table1.main(["--device", "cpu", "--epochs", "1", "--samples",
                       "500"])
    out = capsys.readouterr().out
    assert "| emotion |" in out and "| spam |" in out
    assert set(res) == {"emotion", "spam"}
    for row in res.values():
        assert set(row) == {"fp32"} | {f"int{b}_{m}" for b in (2, 4, 8)
                                       for m in ("baseline", "splitquant")}
        assert all(0.0 <= v <= 1.0 for v in row.values())
        assert abs(row["int8_splitquant"] - row["fp32"]) <= 0.05


def test_table1_trains_like_jax_for_a_few_steps():
    """``train_bert``'s first steps from JAX's weights and batches: the
    trained params equal JAX's within 1e-5 x their scale (its
    ``benchmarks/table1.py`` loop, two steps)."""
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw as tadamw
    from repro_torch.runtime.train_loop import make_train_step
    s = _jax_bert()
    ds = jcls.emotion_like(n_samples=64, seq_len=S, seed=2)
    ocfg = dict(lr=3e-4, total_steps=4, warmup_steps=50, weight_decay=0.01)
    jo = jadamw.OptConfig(**ocfg)
    jp, js = s.jparams, jadamw.init(jo, s.jparams)

    @jax.jit
    def jstep(p, o, b):
        (l, _), g = jax.value_and_grad(
            lambda pp: jbert.loss_fn(pp, s.cfg, b), has_aux=True)(p)
        p, o, _ = jadamw.update(jo, o, p, g)
        return p, o, l
    to = tadamw.OptConfig(**ocfg)
    tp, ts = s.port, tadamw.init(to, s.port)
    tstep = make_train_step(lambda p, b: tbert.loss_fn(p, s.tcfg, b), to)
    tds = tcls.emotion_like(n_samples=64, seq_len=S, seed=2)
    for jb, tb in zip(jcls.batches(ds, 32, seed=0, epochs=1),
                      tcls.batches(tds, 32, seed=0, epochs=1,
                                   device="cpu")):
        jp, js, jl = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in jb.items()})
        tp, ts, m = tstep(tp, ts, tb)
        assert abs(float(m["loss"]) - float(jl)) <= 1e-5 * float(jl)
    got, want = _flat(tp), _flat(_to_numpy_tree(jp))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
