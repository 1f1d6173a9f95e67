"""Port parity, calibration recipes and checkpoints: the integrity
primitives, ``checkpoint.ckpt``, ``calib.QuantRecipe``, the activation
stats' merge and static scales, ``layer_sensitivity``, the greedy
allocation, ``load_draft_params`` and ``launch.serve``'s recipe flags,
against the JAX package on the same seeded weights (reduced stablelm-1.6b
and chatglm3-6b; bert-tiny for the activation stats).

Each package must read what the other writes. Tolerances: checksums,
manifests, recipe files, codes, scales, dense leaves, allocations and
greedy tokens identical; logits through restored weights bit-identical
to those through the bridge's; ``layer_sensitivity``'s ``mse``/``kl``
within 1e-3 relative of JAX's in fp32 (the same quantized weights; the
two forwards sum in another order), its ``bytes`` exact. JAX set-ups are
shared through ``functools.cache``: one jitted ``quantize_tree`` an arch
and layout.
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

from repro.calib import QuantRecipe as JRecipe
from repro.calib import act_static_scales as j_act_scales
from repro.calib import best_uniform_within as j_best_uniform
from repro.calib import collect_act_stats as j_collect_act
from repro.calib import collect_kv_stats as j_collect_kv
from repro.calib import greedy_allocate as j_greedy
from repro.calib import kv_static_scales as j_kv_scales
from repro.calib import layer_sensitivity as j_sensitivity
from repro.calib import uniform_bytes as j_uniform_bytes
from repro.calib.stats import _merge as j_merge
from repro.checkpoint import ckpt as jck
from repro.configs import get_arch
from repro.core import QuantConfig, QuantPolicy, quantize_tree
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.engine.recovery import array_checksum as j_checksum
from repro.engine.recovery import checksum_arrays as j_checksum_arrays
from repro.launch.serve import load_recipe_params as j_load_recipe
from repro.models import bert_tiny, get_model

from repro_torch import bridge, calib
from repro_torch.calib import stats as tstats
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_arch as t_arch
from repro_torch.core import apply as tapply
from repro_torch.engine import Engine, EngineConfig
from repro_torch.engine.recovery import (IntegrityError, array_checksum,
                                         checksum_arrays)
from repro_torch.engine.spec import load_draft_params
from repro_torch.kernels.ops import PackedWeight
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt

from test_torch_quant import _to_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["stablelm-1.6b", "chatglm3-6b"]
FAST_COMPILE = {"xla_backend_optimization_level": 0}
KEY = jax.random.PRNGKey(0)
SQT_FIELDS = ("q", "cid", "scale", "zero")


def _np(a):
    return np.asarray(a)


def _subtree(tree):
    """The attention's wq of every layer and the lm_head."""
    return {"layers": {"attn": {"wq": tree["layers"]["attn"]["wq"]}},
            "lm_head": tree["lm_head"]}


@functools.cache
def _jax(arch, per_channel=False):
    """JAX's seeded fp32 reduced ``arch``, its INT2 ``quantize_tree``
    (jitted once) and report, and both through the bridge. Per channel,
    only :func:`_subtree` (one compile of each leaf shape is the cost)."""
    cfg = get_arch(arch).reduced()
    params = get_model(cfg).init(KEY, cfg)
    if per_channel:
        params = _subtree(params)
    rep = {}

    def run(key, p):
        tree, r = quantize_tree(key, p, QuantPolicy(cfg=QuantConfig(
            bits=2, per_channel=per_channel)))
        rep.update(r)
        return tree
    qtree = jax.jit(run, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(1), params)
    port = lambda t: bridge.from_jax_tree(_to_numpy_tree(t),  # noqa: E731
                                          device="cpu")
    return types.SimpleNamespace(
        cfg=cfg, tcfg=t_arch(arch).reduced(), jparams=params, jq=qtree,
        jrep=rep, dense=port(params), packed=port(qtree))


def _assert_packed_equal(a: PackedWeight, b: PackedWeight):
    assert (a.bits, a.k, a.shape, a.orig_dtype) == \
        (b.bits, b.k, b.shape, b.orig_dtype)
    for f in ("qp", "cp", "recip", "shift", "scale", "zero"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    elif isinstance(want, PackedWeight):
        assert isinstance(got, PackedWeight)
        _assert_packed_equal(got, want)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


def _logits(cfg, params, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 12))
    with torch.no_grad():
        return tt.forward(params, cfg, {"tokens": torch.from_numpy(toks)})[0]


def _manifest(d, step=0):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


# ------------------------------------------------------------ checksums ---
CHECKSUM_ARRAYS = {
    "f32": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
    "scalar": np.float32(3.5),
    "empty": np.zeros((0, 3), np.int8),
    "strided": np.arange(24, dtype=np.int16).reshape(4, 6)[:, ::2].T,
    "bool": np.array([True, False, True]),
    "u64": np.arange(5, dtype=np.uint64) << np.uint64(40),
}


@pytest.mark.parametrize("name", sorted(CHECKSUM_ARRAYS))
def test_array_checksum_matches_jax(name):
    a = CHECKSUM_ARRAYS[name]
    assert array_checksum(a) == j_checksum(a)
    assert checksum_arrays({name: a}) == j_checksum_arrays({name: a})


# ---------------------------------------------------------- checkpoints ---
@pytest.mark.parametrize("like", ["dense", "packed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_in_the_port(arch, like, tmp_path):
    """JAX saves its INT2 tree; the port restores it into a dense tree of
    its own seeded init (the quantized leaves come back packed, meta from
    the manifest, no k-means) or into the bridge's packed tree: weights
    as the bridge gives them, logits bit-identical."""
    s = _jax(arch)
    jck.save(str(tmp_path), 3, s.jq)
    like_tree = (tt.init(s.tcfg, seed=5, device="cpu") if like == "dense"
                 else s.packed)
    got, step = ckpt.restore(str(tmp_path), like_tree)
    assert step == 3
    _assert_trees_equal(got, s.packed)
    np.testing.assert_array_equal(_logits(s.tcfg, got).numpy(),
                                  _logits(s.tcfg, s.packed).numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_jax(arch, tmp_path):
    """The port saves the bridged INT2 tree: its manifest equals the one
    JAX writes for the same tree (keys, shapes, dtypes, quant_meta,
    checksums, treedef), and JAX's restore into its dense init gives the
    same q / cid / scale / zero and dense leaves."""
    s = _jax(arch)
    ckpt.save(str(tmp_path / "t"), 0, s.packed)
    jck.save(str(tmp_path / "j"), 0, s.jq)
    assert _manifest(tmp_path / "t") == _manifest(tmp_path / "j")
    restored, _ = jck.restore(str(tmp_path / "t"), s.jparams)
    jflat = jax.tree_util.tree_leaves_with_path(s.jq)
    rflat = jax.tree_util.tree_leaves_with_path(restored)
    assert [p for p, _ in jflat] == [p for p, _ in rflat]
    for (_, a), (_, b) in zip(jflat, rflat):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_per_channel_checkpoint_both_ways(writer, tmp_path):
    """Per-channel scales (L, k, N) on disk: either package's checkpoint
    restores in the other with identical leaves."""
    s = _jax("stablelm-1.6b", per_channel=True)
    d = str(tmp_path)
    assert s.packed["layers"][0]["attn"]["wq"].scale.shape == (3, 128)
    if writer == "jax":
        jck.save(d, 0, s.jq)
        like = tt.init(s.tcfg, seed=1, device="cpu")
        like = {"layers": [{"attn": {"wq": lay["attn"]["wq"]}}
                           for lay in like["layers"]],
                "lm_head": like["lm_head"]}
        got, _ = ckpt.restore(d, like)
        _assert_trees_equal(got, s.packed)
    else:
        ckpt.save(d, 0, s.packed)
        got, _ = jck.restore(d, s.jparams)
        wq = got["layers"]["attn"]["wq"]
        assert wq.scale.shape == (s.cfg.n_layers, 3, 128)
        for f in SQT_FIELDS:
            np.testing.assert_array_equal(
                _np(getattr(wq, f)),
                _np(getattr(s.jq["layers"]["attn"]["wq"], f)))


def test_bf16_leaves_widen_on_disk_and_come_back_bf16(tmp_path):
    """A bf16 tree (dense leaves and a quantized leaf of orig_dtype bf16):
    fp32 in the npz with ``dtypes`` "bfloat16", restored as bf16 by both
    packages, values exact."""
    s = _jax("stablelm-1.6b")
    tree = tapply.tree_to(s.dense, "cpu")
    tree = {"embed": tree["embed"].to(torch.bfloat16),
            "layers": [{"attn": {"wq": lay["attn"]["wq"].to(torch.bfloat16)},
                        "ln1": {"norm_scale": lay["ln1"]["norm_scale"]
                                .to(torch.bfloat16)}}
                       for lay in tree["layers"]]}
    qtree, _ = tapply.quantize_tree(tree, tapply.QuantPolicy(
        cfg=tapply.QuantConfig(bits=4)))
    ckpt.save(str(tmp_path), 1, qtree)
    man = _manifest(tmp_path, 1)
    assert man["dtypes"]["['embed']"] == "bfloat16"
    assert man["quant_meta"]["['layers']['attn']['wq']"]["orig_dtype"] == \
        "bfloat16"
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        assert z["['embed']"].dtype == np.float32
    got, _ = ckpt.restore(str(tmp_path), tree)
    _assert_trees_equal(got, qtree)
    jlike = {"embed": jnp.zeros((512, 128), jnp.bfloat16),
             "layers": {"attn": {"wq": jnp.zeros((2, 128, 128), jnp.bfloat16)},
                        "ln1": {"norm_scale": jnp.zeros((2, 128),
                                                        jnp.bfloat16)}}}
    jgot, _ = jck.restore(str(tmp_path), jlike)
    assert jgot["embed"].dtype == jnp.bfloat16
    assert jgot["layers"]["attn"]["wq"].orig_dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        _np(jgot["embed"]).astype(np.float32),
        tree["embed"].float().numpy())


def test_tuple_like_reads_the_params_half(tmp_path):
    """A JAX training checkpoint of (params, opt_state): ``(params, None)``
    as ``like`` restores the params half (keys ``[0]...``) and leaves the
    optimizer state unread, as JAX's ``--ckpt-dir`` does."""
    s = _jax("stablelm-1.6b")
    opt = {"mu": jax.tree_util.tree_map(jnp.zeros_like, s.jparams),
           "step": jnp.asarray(7)}
    jck.save(str(tmp_path), 5, (s.jparams, opt))
    like = (tt.init(s.tcfg, seed=3, device="cpu"), None)
    (params, rest), step = ckpt.restore(str(tmp_path), like)
    assert step == 5 and rest is None
    _assert_trees_equal(params, s.dense)
    assert _manifest(tmp_path, 5)["keys"][0].startswith("[0]")


def test_ckpt_retention(tmp_path):
    tree = {"a": torch.zeros(2)}
    for step in range(6):
        ckpt.save(str(tmp_path), step, tree, retain=2)
    assert len(os.listdir(tmp_path)) == 2
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert jck.latest_step(str(tmp_path)) == 5


def test_ckpt_tmp_dir_ignored(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2)})
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"a": torch.zeros(2)})


def test_ckpt_non_blocking_save(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    ckpt.save(str(tmp_path), 7, tree, blocking=False)
    ckpt.wait_for_async()
    got, step = ckpt.restore(str(tmp_path), tree)
    assert step == 7 and got["b"]["c"].dtype == torch.bfloat16
    _assert_trees_equal(got, tree)


def test_ckpt_corruption_raises_checksum_then_code_range(tmp_path):
    """A flipped code byte fails the checksum; with checksums re-stamped
    over the corrupt arrays, the INT2 code range still trips."""
    s = _jax("stablelm-1.6b")
    cdir = str(tmp_path)
    jck.save(cdir, 0, s.jq)
    npz = os.path.join(cdir, "step_00000000", "arrays.npz")
    data = dict(np.load(npz))
    qkey = next(k for k in data if k.endswith(".q"))
    data[qkey] = data[qkey] ^ np.int8(1)
    np.savez(npz, **data)
    with pytest.raises(IntegrityError) as ei:
        ckpt.restore(cdir, s.dense)
    assert ei.value.reason == "checksum"
    mpath = os.path.join(cdir, "step_00000000", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    data[qkey] = np.full_like(data[qkey], 100)
    np.savez(npz, **data)
    manifest["checksums"] = checksum_arrays(data)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(IntegrityError) as ei:
        ckpt.restore(cdir, s.dense)
    assert ei.value.reason == "code_range"
    del data[qkey]
    np.savez(npz, **data)
    with pytest.raises(IntegrityError) as ei:
        ckpt.restore(cdir, s.dense)
    assert ei.value.reason == "missing_array"


# --------------------------------------------------------------- recipes ---
def _recipe_inputs(s):
    scales = j_kv_scales(j_collect_kv(
        s.cfg, s.jparams, [np.random.default_rng(4).integers(
            0, s.cfg.vocab, (2, 24))], qchunks=4))
    act = {"attn_in": {"scale": np.linspace(1, 2, 6, dtype=np.float32)
                       .reshape(2, 3),
                       "zero": np.zeros((2, 3), np.float32)}}
    return dict(name="r", arch=s.cfg.name,
                policies={p: {"bits": d["bits"], "k": d["k"],
                              "method": d["method"]}
                          for p, d in s.jrep["per_path"].items()},
                kv_scales=scales, kv_qchunks=4, act_scales=act,
                ckpt_dir="ckpt", meta={"reduced": True, "budget": 1.5})


@functools.cache
def _kv_recipe_inputs():
    return _recipe_inputs(_jax("stablelm-1.6b"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recipe_written_by_either_loads_in_the_other(writer, tmp_path):
    kw = _kv_recipe_inputs()
    d = str(tmp_path)
    (JRecipe if writer == "jax" else calib.QuantRecipe)(**kw).save(d)
    got = (calib.QuantRecipe if writer == "jax" else JRecipe).load(d)
    for f in ("name", "arch", "policies", "kv_qchunks", "ckpt_dir", "meta"):
        assert getattr(got, f) == kw[f], f
    for k, v in kw["kv_scales"].items():
        np.testing.assert_array_equal(got.kv_scales[k], _np(v))
    np.testing.assert_array_equal(got.act_scales["attn_in"]["scale"],
                                  kw["act_scales"]["attn_in"]["scale"])
    assert got.resolve_ckpt_dir(d) == os.path.join(d, "ckpt")


def test_recipe_json_is_identical_text(tmp_path):
    kw = _kv_recipe_inputs()
    JRecipe(**kw).save(str(tmp_path / "j"))
    calib.QuantRecipe(**kw).save(str(tmp_path / "t"))
    text = [(tmp_path / w / "recipe.json").read_text() for w in "jt"]
    assert text[0] == text[1]
    z = [dict(np.load(tmp_path / w / "scales.npz")) for w in "jt"]
    assert z[0].keys() == z[1].keys()
    for k in z[0]:
        np.testing.assert_array_equal(z[0][k], z[1][k])


def _tamper_npz(path, key, fn):
    data = dict(np.load(path))
    data[key] = fn(data[key])
    np.savez(path, **data)


def test_recipe_validation(tmp_path):
    """Tampered scales fail the checksum; a nonpositive KV scale and a
    non-finite act scale fail even when their checksums were recorded
    over the bad arrays."""
    kw = _kv_recipe_inputs()
    rdir = str(tmp_path / "rec")
    calib.QuantRecipe(**kw).save(rdir)
    _tamper_npz(os.path.join(rdir, "scales.npz"), "kv/k_scale",
                lambda a: a + 1.0)
    with pytest.raises(IntegrityError) as ei:
        calib.QuantRecipe.load(rdir)
    assert ei.value.reason == "checksum"
    bad = {k: _np(v).copy() for k, v in kw["kv_scales"].items()}
    bad["v_scale"].reshape(-1)[0] = -1.0
    for name, kv, act, reason in (
            ("neg", bad, None, "nonpositive_scale"),
            ("nan", kw["kv_scales"], {"s": {"scale": np.array([np.nan]),
                                            "zero": np.zeros(1)}},
             "nonfinite")):
        d = str(tmp_path / name)
        calib.QuantRecipe(name="r", kv_scales=kv, act_scales=act).save(d)
        for loader in (calib.QuantRecipe, JRecipe):
            with pytest.raises(Exception) as ei:
                loader.load(d)
            assert ei.value.reason == reason
    with pytest.raises(ValueError, match="missing"):
        calib.QuantRecipe(kv_scales={"k_scale": 1}).save(str(tmp_path / "x"))


# ------------------------------------------------------ activation stats ---
@functools.cache
def _bert_stats():
    cfg = get_arch("bert-tiny")
    params = bert_tiny.init(KEY, cfg, n_classes=4, max_len=24)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, cfg.vocab, size=(8, 24),
                                    dtype=np.int32),
             "mask": np.ones((8, 24), np.int32)}
    half = {k: v[:4] for k, v in batch.items()}
    return j_collect_act(cfg, params, [half, batch], n_chunks=3)


@pytest.mark.parametrize("bits,use_percentile", [(8, False), (8, True),
                                                 (4, False)])
def test_act_static_scales_match_jax(bits, use_percentile):
    js = _bert_stats()
    ts = tstats.ActStats(sites=js.sites, n_chunks=js.n_chunks,
                         percentile=js.percentile, n_batches=js.n_batches)
    want = j_act_scales(js, bits=bits, use_percentile=use_percentile)
    got = calib.act_static_scales(ts, bits=bits,
                                  use_percentile=use_percentile)
    assert got.keys() == want.keys() == set(bert_tiny.ACT_SITES)
    for site in want:
        for f in ("scale", "zero"):
            assert got[site][f].dtype == want[site][f].dtype
            np.testing.assert_array_equal(got[site][f], want[site][f])


def test_act_stats_merge_matches_jax():
    sites = _bert_stats().sites
    other = {s: {k: v * 1.5 - 0.25 for k, v in d.items()}
             for s, d in sites.items()}
    for acc, n in ((None, 0), (sites, 1), (sites, 3)):
        want = j_merge(acc, other, n)
        got = tstats._merge(acc, other, n)
        for s in want:
            for k in want[s]:
                np.testing.assert_array_equal(got[s][k], want[s][k])


# --------------------------------------------- sensitivity and allocation ---
def _calib_batch(cfg):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, cfg.vocab, size=(2, 16),
                                   dtype=np.int32)}


def _attn_or_head(path: str) -> bool:
    """The groups the sensitivity tests score: the attention's four
    projections and the lm_head (two leaf shapes: JAX compiles its eager
    quantizer once a shape and bit-width)."""
    return "/attn/" in path or path.startswith("lm_head")


@functools.cache
def _jax_table():
    s = _jax("stablelm-1.6b")
    model = get_model(s.cfg)
    from repro.core.apply import _quantizable as j_quantizable
    return j_sensitivity(KEY, s.cfg, s.jparams,
                         lambda p, b: model.forward(p, s.cfg, b)[0],
                         _calib_batch(s.cfg),
                         policy=QuantPolicy(method="baseline"),
                         bits_list=(2, 8),
                         is_quantizable=lambda p, leaf, pol: _attn_or_head(
                             p) and j_quantizable(p, leaf, pol))


def _port_table(method, bits_list):
    s = _jax("stablelm-1.6b")
    return calib.layer_sensitivity(
        0, s.tcfg, s.dense, lambda p, b: tt.forward(p, s.tcfg, b)[0],
        _calib_batch(s.cfg), policy=tapply.QuantPolicy(method=method),
        bits_list=bits_list,
        is_quantizable=lambda p, leaf, stack: _attn_or_head(p) and
        tapply._quantizable(p, leaf, stack))


def test_layer_sensitivity_baseline_matches_jax():
    want = _jax_table()
    got = _port_table("baseline", (2, 8))
    assert list(got) == list(want)
    for path, row in want.items():
        assert (got[path]["size"], got[path]["orig_bytes"]) == \
            (row["size"], row["orig_bytes"])
        for bits, r in row["per_bits"].items():
            g = got[path]["per_bits"][bits]
            assert g["bytes"] == r["bytes"], (path, bits)
            for m in ("mse", "kl"):
                assert abs(g[m] - r[m]) <= 1e-3 * abs(r[m]), (path, bits, m)


def test_layer_sensitivity_splitquant_bytes_and_summary():
    """SplitQuant k=3: bytes as JAX counts them (its INT2 report's
    per-path bytes), errors finite, INT8 better than INT2; the summary
    ranks by INT2 kl; the caller's tree is left as it was."""
    s = _jax("stablelm-1.6b")
    before = s.dense["layers"][0]["attn"]["wq"]
    table = _port_table("splitquant", (2, 8))
    assert s.dense["layers"][0]["attn"]["wq"] is before
    assert {p: r["per_bits"][2]["bytes"] for p, r in table.items()} == \
        {p: d["bytes"] for p, d in s.jrep["per_path"].items()
         if _attn_or_head(p)}
    for row in table.values():
        lo, hi = row["per_bits"][2], row["per_bits"][8]
        assert np.isfinite([lo["mse"], lo["kl"], hi["mse"], hi["kl"]]).all()
        assert hi["mse"] < lo["mse"]
    summary = calib.sensitivity_summary(table, bits=2)
    assert [k for k, _ in summary] == sorted(
        table, key=lambda p: -table[p]["per_bits"][2]["kl"])
    groups = calib.quantizable_groups(s.dense)
    assert [g for g, _ in groups] == sorted(s.jrep["per_path"],
                                             key=lambda p: p.split("/"))
    assert [g for g, _ in groups if _attn_or_head(g)] == list(table)
    assert len(groups[0][1]) == s.cfg.n_layers


@pytest.mark.parametrize("where", ["lo", "mid", "hi", "broke", "zero_metric"])
def test_allocation_matches_jax(where):
    table = _jax_table()
    lo, hi = j_uniform_bytes(table, 2), j_uniform_bytes(table, 8)
    assert (calib.uniform_bytes(table, 2), calib.uniform_bytes(table, 8)) \
        == (lo, hi)
    budget = {"lo": lo, "mid": (lo + hi) // 2, "hi": hi, "broke": lo - 1,
              "zero_metric": (lo + hi) // 2}[where]
    kw = {"metric": "mse", "k": 1, "method": "baseline"} \
        if where == "zero_metric" else {}
    assert calib.greedy_allocate(table, budget, **kw) == \
        j_greedy(table, budget, **kw)
    assert calib.best_uniform_within(table, budget) == \
        j_best_uniform(table, budget)


def test_allocation_quantizes_as_assigned():
    """A mixed allocation's overrides through the port's quantize_tree:
    per-path bits as assigned, bytes within the budget."""
    table = _jax_table()
    lo, hi = calib.uniform_bytes(table, 2), calib.uniform_bytes(table, 8)
    alloc = calib.greedy_allocate(table, (lo + hi) // 2, k=1,
                                  method="baseline")
    assert len(set(alloc["assignment"].values())) == 2
    s = _jax("stablelm-1.6b")
    ffn = {p: {"method": "none"} for p in s.jrep["per_path"]
           if not _attn_or_head(p)}
    _, rep = tapply.quantize_tree(s.dense, tapply.QuantPolicy(),
                                  overrides={**alloc["overrides"], **ffn})
    assert {p: d["bits"] for p, d in rep["per_path"].items()} == \
        alloc["assignment"]
    assert rep["deployed_bytes"] == alloc["total_bytes"] <= (lo + hi) // 2


# ------------------------------------------------- serving from a recipe ---
def _no_kmeans(monkeypatch):
    import repro_torch.core.kmeans as kmeans_mod
    import repro_torch.core.splitquant as splitquant_mod

    def boom(*a, **kw):
        raise AssertionError("k-means ran during recipe serving")
    monkeypatch.setattr(kmeans_mod, "kmeans_1d", boom)
    monkeypatch.setattr(splitquant_mod, "kmeans_1d", boom)


@functools.cache
def _jax_recipe_serving(recipe_dir):
    s = _jax("stablelm-1.6b")
    params, _, scales = j_load_recipe(recipe_dir, s.jparams)
    eng = JEngine(s.cfg, params, JEngineConfig(
        **_serve_kw(), flight=False, metrics=False), kv_scales=scales)
    for p in _prompts(s.cfg):
        eng.submit(p)
    return [r.out for r in eng.drain()]


def _serve_kw():
    return dict(n_slots=2, max_len=48, max_new_tokens=5, prefill_bucket=8,
                prefill_chunk=16, kv_mode="int8")


def _prompts(cfg):
    rng = np.random.default_rng(8)
    return [rng.integers(0, cfg.vocab, size=int(n)) for n in (5, 13, 9)]


@pytest.fixture(scope="module")
def jax_recipe(tmp_path_factory):
    """JAX's INT2 checkpoint and a recipe with its static KV scales."""
    s = _jax("stablelm-1.6b")
    d = str(tmp_path_factory.mktemp("jax_recipe"))
    jck.save(os.path.join(d, "ckpt"), 0, s.jq)
    kw = dict(_kv_recipe_inputs(), act_scales=None,
              kv_scales=j_kv_scales(j_collect_kv(
                  s.cfg, s.jq, [np.random.default_rng(0).integers(
                      0, s.cfg.vocab, (4, 48))], qchunks=4)))
    JRecipe(**kw).save(d)
    return d


def test_serve_from_recipe_matches_jax_without_kmeans(jax_recipe,
                                                      monkeypatch):
    s = _jax("stablelm-1.6b")
    _no_kmeans(monkeypatch)
    params, rec, scales = tserve.load_recipe_params(
        jax_recipe, tt.init(s.tcfg, seed=9, device="cpu"),
        arch="stablelm-1.6b", reduced=True)
    _assert_trees_equal(params, s.packed)
    eng = Engine(s.tcfg, params, EngineConfig(**_serve_kw()), device="cpu",
                 kv_scales=scales)
    assert eng.cache.static
    for p in _prompts(s.cfg):
        eng.submit(p)
    assert [r.out for r in eng.drain()] == _jax_recipe_serving(jax_recipe)


def test_load_recipe_params_checks_provenance(jax_recipe, tmp_path):
    s = _jax("stablelm-1.6b")
    with pytest.raises(ValueError, match="calibrated for arch"):
        tserve.load_recipe_params(jax_recipe, s.dense, arch="chatglm3-6b")
    with pytest.raises(ValueError, match="reduced=True"):
        tserve.load_recipe_params(jax_recipe, s.dense, reduced=False)
    # policies only: the recipe's overrides quantize the dense tree
    d = str(tmp_path)
    calib.QuantRecipe(arch="stablelm-1.6b",
                      policies={"lm_head": {"bits": 8, "method": "baseline",
                                            "k": 1}}).save(d)
    params, rec, scales = tserve.load_recipe_params(d, s.dense)
    assert scales is None and params["lm_head"].bits == 8
    assert params["layers"][0]["attn"]["wq"].bits == 8


def test_load_draft_params_matches_jax_and_refuses(jax_recipe, tmp_path,
                                                   monkeypatch):
    s = _jax("stablelm-1.6b")
    _no_kmeans(monkeypatch)
    _assert_trees_equal(load_draft_params(jax_recipe, s.dense, s.tcfg),
                        s.packed)
    wrong = t_arch("chatglm3-6b").reduced()
    with pytest.raises(ValueError, match="calibrated for arch"):
        load_draft_params(jax_recipe, s.dense, wrong)
    d = str(tmp_path)
    calib.QuantRecipe(arch="stablelm-1.6b").save(d)
    with pytest.raises(ValueError, match="nothing to draft with"):
        load_draft_params(d, s.dense, s.tcfg)


def test_serve_cli_saves_and_serves_a_recipe(tmp_path, capsys):
    """``--save-recipe`` then ``--recipe`` and ``--draft-recipe`` on the
    CPU; the port's recipe and checkpoint load in the JAX package."""
    d = str(tmp_path / "rec")
    base = ["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu"]
    tserve.main(base + ["--bits", "2", "--save-recipe", d])
    rec = JRecipe.load(d)
    assert rec.meta["reduced"] is True and rec.kv_scales is not None
    assert {p["bits"] for p in rec.policies.values()} == {2}
    s = _jax("stablelm-1.6b")
    jtree, _ = jck.restore(rec.resolve_ckpt_dir(d), s.jparams)
    assert jtree["lm_head"].bits == 2
    capsys.readouterr()
    tserve.main(base + ["--recipe", d, "--requests", "2",
                        "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "no k-means" in out and "2 requests, 6 tokens" in out
    tserve.main(base + ["--spec-k", "2", "--draft-recipe", d, "--requests",
                        "2", "--max-new-tokens", "3"])
    assert "speculative steps" in capsys.readouterr().out
    with pytest.raises(ValueError, match="--spec-k"):
        tserve.main(base + ["--draft-recipe", d])


def test_serve_cli_restores_a_training_checkpoint(tmp_path, capsys):
    s = _jax("stablelm-1.6b")
    jck.save(str(tmp_path), 2, (s.jparams, {"step": jnp.asarray(2)}))
    tserve.main(["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path), "--requests", "1",
                 "--max-new-tokens", "2"])
    assert "restored step 2" in capsys.readouterr().out
