"""Port parity, whisper-tiny (the audio family): ``attention_block``
bidirectional and over an encoder's K/V, ``encode``, ``forward``,
``prefill``, ``decode_step`` and ``loss_fn`` of the port against the JAX
package's on the same seeded weights (JAX's ``whisper.init``, its biases
nudged off zero, through the bridge), as ``tests/test_models.py`` drives
the JAX model: reduced whisper-tiny (2 encoder and 2 decoder layers,
d_model 128, 4 heads of 32, enc_seq 32) in fp32, stub frames
(B, enc_seq, d); and its SplitQuant INT4 tree, quantized biases
included, through the bridge.

Tolerances: encoder states, logits and caches atol 1e-5 x max(1, the
reference's largest magnitude) in fp32 (the products sum in another
order); slot positions, codes and dequantized biases exact; decode
against the full-context forward 1e-3, as the JAX test holds it; the
loss within 1e-5 relative and each gradient leaf within 1e-4 of its
largest entry. JAX references are jitted and shared through
``functools.cache``.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch
from repro.core import QuantConfig, QuantPolicy, quantize_tree
from repro.models import attention as ja
from repro.models import whisper as jw

from repro_torch import bridge
from repro_torch.configs import get_arch as t_arch
from repro_torch.core.splitquant import SplitQuantTensor
from repro_torch.kernels.ops import PackedWeight
from repro_torch.models import attention as ta
from repro_torch.models import get_model
from repro_torch.models import whisper as tw

from test_torch_bert import _flat, _grads, _with_grad
from test_torch_quant import _to_numpy_tree
from torch_threads import one_torch_thread  # noqa: F401

FAST_COMPILE = {"xla_backend_optimization_level": 0}
B, S0, S1 = 2, 8, 12


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float64)
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _nudged(params, seed):
    """Every bias off zero (a trained model's are not zero)."""
    rng = np.random.default_rng(seed)

    def nudge(path, x):
        name = jax.tree_util.keystr(path)
        if "'b" in name and "norm" not in name:
            return x + jnp.asarray(
                rng.standard_normal(x.shape).astype(np.float32) * 0.1)
        return x
    return jax.tree_util.tree_map_with_path(nudge, params)


@functools.cache
def _setup():
    jcfg = j_arch("whisper-tiny").reduced()
    jp = _nudged(jax.jit(jw.init, static_argnums=1,
                         compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(0), jcfg), 1)
    rng = np.random.default_rng(2)
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=t_arch("whisper-tiny").reduced(), jp=jp,
        port=bridge.from_jax_tree(_to_numpy_tree(jp), device="cpu"),
        frames=rng.standard_normal((B, jcfg.enc_seq, jcfg.d_model)).astype(
            np.float32),
        toks=rng.integers(0, jcfg.vocab, (B, S1)).astype(np.int32))


def _t(a):
    a = torch.from_numpy(np.asarray(a))
    return a.long() if a.dtype == torch.int32 else a


@functools.cache
def _jax_refs():
    """JAX's encoder states, full-context logits, and the prefill of S0
    tokens into S1 rows followed by a decode step per remaining token."""
    s = _setup()
    fwd = jax.jit(lambda p, b: jw.forward(p, s.jcfg, b)[0],
                  compiler_options=FAST_COMPILE)
    pre = jax.jit(lambda p, b: jw.prefill(p, s.jcfg, b, max_len=S1),
                  compiler_options=FAST_COMPILE)
    dec = jax.jit(lambda p, c, t, pos: jw.decode_step(p, s.jcfg, c, t, pos),
                  compiler_options=FAST_COMPILE)
    enc = jax.jit(lambda p, f: jw.encode(p, s.jcfg, f),
                  compiler_options=FAST_COMPILE)(s.jp, s.frames)
    full = fwd(s.jp, {"tokens": s.toks, "frames": s.frames})
    steps = [pre(s.jp, {"tokens": s.toks[:, :S0], "frames": s.frames})]
    for t in range(S0, S1):
        steps.append(dec(s.jp, steps[-1][1], s.toks[:, t:t + 1],
                         jnp.int32(t)))
    return enc, full, steps


def test_config_init_and_get_model():
    full = t_arch("whisper-tiny")
    assert (full.family, full.n_enc_layers, full.n_layers, full.d_model,
            full.n_heads, full.head_dim, full.enc_seq, full.vocab,
            full.rope_variant, full.tie_embeddings) == (
        "audio", 4, 4, 384, 6, 64, 1500, 51865, "none", True)
    s = _setup()
    assert get_model(s.cfg) is tw
    own = tw.init(s.cfg, seed=0, device="cpu")
    shapes = lambda t: {k: tuple(v.shape) for k, v in _flat(t).items()}
    assert shapes(own) == shapes(s.port) == {
        k: v.shape for k, v in _flat(_to_numpy_tree(s.jp)).items()}
    assert own["dec_pos"].shape == (tw.DEC_POS_ROWS, s.cfg.d_model)


def test_encode_matches_jax():
    s = _setup()
    with torch.no_grad():
        got = tw.encode(s.port, s.cfg, _t(s.frames))
    _close(got, _jax_refs()[0])


def test_forward_matches_jax():
    s = _setup()
    with torch.no_grad():
        got, cache = tw.forward(s.port, s.cfg, {"tokens": _t(s.toks),
                                                "frames": _t(s.frames)})
    assert cache is None and got.shape == (B, S1, s.cfg.vocab)
    _close(got, _jax_refs()[1])


def test_prefill_and_decode_match_jax():
    """The prefill of S0 tokens padded to S1 rows (slot_pos -1 past S0),
    its cross K/V, then a decode step per remaining token: each step's
    logits and cache equal JAX's, and the last equal the full-context
    forward's (1e-3, as the JAX model test)."""
    s = _setup()
    _, full, steps = _jax_refs()
    with torch.no_grad():
        logits, cache = tw.prefill(s.port, s.cfg, {
            "tokens": _t(s.toks[:, :S0]), "frames": _t(s.frames)},
            max_len=S1)
        # decode writes the self-attention rows in place: keep copies
        copy = lambda c: tw.WhisperCache(*(x.clone() for x in c))
        outs = [(logits, copy(cache))]
        for t in range(S0, S1):
            lg, cache = tw.decode_step(s.port, s.cfg, cache,
                                       _t(s.toks[:, t:t + 1]), t)
            outs.append((lg, copy(cache)))
    assert outs[0][1].slot_pos[0].tolist() == list(range(S0)) + [-1] * 4
    for (lg, c), (jl, jc) in zip(outs, steps):
        _close(lg, jl)
        for name, a, b in zip(tw.WhisperCache._fields, c, jc):
            if name == "slot_pos":
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                _close(a, b)
    for i, t in enumerate(range(S0, S1)):
        err = float((outs[i + 1][0][:, 0] - _t(np.asarray(full[:, t])))
                    .abs().max())
        assert err < 1e-3


def _attn_params(rng, d, Hq, Hkv, D):
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
    return {"wq": f(d, Hq * D), "bq": f(Hq * D), "wk": f(d, Hkv * D),
            "bk": f(Hkv * D), "wv": f(d, Hkv * D), "bv": f(Hkv * D),
            "wo": f(Hq * D, d), "bo": f(d)}


@pytest.mark.parametrize("mode", ["bidirectional", "cross"])
def test_attention_block_bidirectional_and_cross(mode):
    """``attention_block(causal=False)`` (the encoder) and with
    ``cross_kv`` (the decoder's cross-attention: q and the output
    projected with their biases, K/V given) against JAX's."""
    cfg, jcfg = _setup().cfg, _setup().jcfg
    rng = np.random.default_rng(7)
    p = _attn_params(rng, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.head_dim)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    pos = np.arange(3, 8, dtype=np.int32)
    kw, tkw = {}, {}
    if mode == "cross":
        k, v = (rng.standard_normal((B, 9, cfg.n_kv_heads, cfg.head_dim))
                .astype(np.float32) for _ in range(2))
        kv_pos = np.arange(9, dtype=np.int32)
        kw = dict(cross_kv=(k, v, kv_pos))
        tkw = dict(cross_kv=(_t(k), _t(v), _t(kv_pos)))
    want, _ = ja.attention_block(p, x, jcfg, pos, causal=False, **kw)
    got, kv = ta.attention_block({n: _t(a) for n, a in p.items()}, _t(x),
                                 cfg, _t(pos), causal=False, **tkw)
    assert kv is None
    _close(got, want)
    causal, _ = ta.attention_block({n: _t(a) for n, a in p.items()}, _t(x),
                                   cfg, _t(pos), **tkw)
    assert not torch.allclose(causal, got)      # the flag is honored


@functools.cache
def _jax_int4():
    s = _setup()
    rep = {}

    def run(key, p):
        tree, r = quantize_tree(key, p, QuantPolicy(cfg=QuantConfig(bits=4)))
        rep.update(r)
        return tree
    qtree = jax.jit(run, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(1), s.jp)
    want = jax.jit(lambda p, b: jw.forward(p, s.jcfg, b)[0],
                   compiler_options=FAST_COMPILE)(
        qtree, {"tokens": s.toks, "frames": s.frames})
    return qtree, rep, want


BIASES = ("bq", "bk", "bv", "bo")


def test_int4_tree_with_biases_through_the_bridge():
    """JAX's INT4 tree: every attention and FFN bias quantized and kept a
    SplitQuantTensor (dequantized bit-identical to JAX's), the matrices
    packed, the tables left alone; the forward within tolerance of JAX's
    over the same tree."""
    s = _setup()
    qtree, rep, want = _jax_int4()
    q = set(rep["quantized"])
    for stack, blocks in (("enc_layers", ("attn",)),
                          ("dec_layers", ("attn", "cross"))):
        for blk in blocks:
            assert {f"{stack}/{blk}/{b}" for b in BIASES} <= q
        assert {f"{stack}/ffn/b_up", f"{stack}/ffn/b_down"} <= q
    assert not q & {"embed", "enc_pos", "dec_pos"}
    port = bridge.from_jax_tree(_to_numpy_tree(qtree), device="cpu")
    for stack, blk in (("enc_layers", "attn"), ("dec_layers", "cross")):
        for i in range(2):
            lp = port[stack][i]
            assert isinstance(lp[blk]["wq"], PackedWeight)
            for b in BIASES:
                assert isinstance(lp[blk][b], SplitQuantTensor)
                np.testing.assert_array_equal(
                    lp[blk][b].dequantize().numpy(),
                    np.asarray(qtree[stack][blk][b].dequantize())[i])
    assert isinstance(port["embed"], torch.Tensor)
    with torch.no_grad():
        got, _ = tw.forward(port, s.cfg, {"tokens": _t(s.toks),
                                          "frames": _t(s.frames)})
    _close(got, want)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))


def test_loss_and_grads_match_jax():
    s = _setup()
    labels = np.roll(s.toks, -1, axis=1)
    labels[1, -4:] = -1
    batch = {"tokens": s.toks, "frames": s.frames, "labels": labels}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jw.loss_fn(p, s.jcfg, batch), has_aux=True),
        compiler_options=FAST_COMPILE)(s.jp)
    tp = _with_grad(s.port, [])
    loss, _ = tw.loss_fn(tp, s.cfg, {k: _t(v) for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    got, want = _flat(_grads(tp)), _flat(_to_numpy_tree(jg))
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        # the key bias's gradient vanishes in exact arithmetic (softmax
        # ignores a shift shared by every key): held to 1% of the top
        scale = max(float(np.abs(w).max()), 1e-2 * top)
        assert float(np.abs(got[k] - w).max()) <= 1e-4 * scale, k


def test_refusals():
    """The JAX package's refusals, word for word (pad_mask, moe_blocks,
    speculative decoding), and the launchers': whisper does not serve
    (JAX's wave Server passes no frames) and does not train on the LM
    batch (no frames either)."""
    s = _setup()
    jb = {"tokens": s.toks[:, :4], "frames": s.frames}
    tb = {k: _t(v) for k, v in jb.items()}
    pad = np.zeros((B, 4), bool)
    pairs = [(lambda: jw.prefill(s.jp, s.jcfg, jb, pad_mask=pad),
              lambda: tw.prefill(s.port, s.cfg, tb,
                                 pad_mask=torch.from_numpy(pad))),
             (lambda: jw.prefill(s.jp, s.jcfg, jb, moe_blocks=2),
              lambda: tw.prefill(s.port, s.cfg, tb, moe_blocks=2)),
             (jw.verify_step_slots, tw.verify_step_slots)]
    for jfn, tfn in pairs:
        with pytest.raises(NotImplementedError) as want:
            jfn()
        with pytest.raises(NotImplementedError) as got:
            tfn()
        assert str(got.value) == str(want.value)
    from repro_torch.launch import serve, train
    with pytest.raises(NotImplementedError, match="frames"):
        serve.main(["--arch", "whisper-tiny", "--reduced", "--device",
                    "cpu"])
    with pytest.raises(NotImplementedError, match="frames"):
        train.main(["--arch", "whisper-tiny", "--reduced", "--device",
                    "cpu"])
