"""Port parity, the dense forward and wave loop: the port's ``attend``,
``_mask``, ``forward``, ``prefill``, ``decode_step`` and wave ``Server``
against the JAX package's, on the four reduced dense archs
(stablelm-1.6b: MHA + half RoPE; chatglm3-6b: GQA Hkv=2 + half RoPE;
llama3-405b: full RoPE at θ=5e5; mistral-large-123b: full RoPE at θ=1e6)
in fp32, with the JAX package's seeded ``init`` weights, carried over by
the bridge. stablelm-1.6b, the arch served on the card, is also run
quantized by the JAX package's ``quantize_tree`` (SplitQuant INT4 k=3):
its prefill and decode steps use those weights, the other archs' their
fp32 ones.

The JAX references of an arch are computed once (a module-scoped
cache: one jitted function for the forwards and the prefill, one for a
decode step); the JAX ``Server`` runs once an arch and weight type, two
waves padded to one length with its prefill jitted, so it compiles one
prefill and one decode step.

``assemble_cache``'s windowed ring (griffin's local attention) is held
to JAX's: the last ``window`` positions in ring order, with and without
a pad mask.

Tolerances: logits and caches atol 1e-4 × max(1, the reference's
largest magnitude) (fp32, summation order differs); ``slot_pos`` and
masks exactly; greedy tokens identical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch
from repro.core import QuantConfig, QuantPolicy, quantize_tree
from repro.models import attention as ja
from repro.models import get_model as j_model
from repro.models import transformer as jt
from repro.runtime import serve_loop as jsl

from repro_torch import bridge
from repro_torch.configs import get_arch as t_arch
from repro_torch.models import attention as ta
from repro_torch.models import transformer as tt
from repro_torch.runtime import serve_loop as tsl

from test_torch_quant import _to_numpy_tree

ARCHS = ["stablelm-1.6b", "chatglm3-6b", "llama3-405b", "mistral-large-123b"]
#: archs also run with SplitQuant INT4 k=3 weights: the one served on the
#: card (quantize_tree and the plain CPU matmul's dequantization are the
#: slow part of this file)
INT4_ARCHS = ("stablelm-1.6b",)
FAST_COMPILE = {"xla_backend_optimization_level": 0}
B, S, MAX_LEN, STEPS = 3, 12, 20, 3
PAD = [0, 5, 11]                 # left pads of the three rows


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _pad_mask():
    pad = np.zeros((B, S), bool)
    for j, n in enumerate(PAD):
        pad[j, :n] = True
    return pad


def _forwards(weights, cfg, toks, pad):
    """JAX's logits of ``forward`` without and with the left pad mask for
    each weight type, the prefill into MAX_LEN rows with the last weight
    type (int4 where the arch has it: its logits are the padded int4
    forward's), and an unpadded fp32 prefill of 5 tokens into 8 rows with
    one decode step after it."""
    batch = {"tokens": toks}
    chain = weights[-1]
    logits, cache = jt.prefill(chain, cfg, batch, max_len=MAX_LEN,
                               pad_mask=pad)
    # unpadded: shared slot_pos (L, T), then one step at position 5
    _, shared = jt.prefill(weights[0], cfg, {"tokens": toks[:, :5]},
                           max_len=8)
    step = jt.decode_step(weights[0], cfg, shared,
                          jnp.zeros((B, 1), jnp.int32), jnp.int32(5))
    fwds = [jt.forward(p, cfg, batch)[0] for p in weights]
    return (fwds, [jt.forward(p, cfg, batch, pad_mask=pad)[0]
                   for p in weights[:-1]] + [logits],
            (logits, cache), (shared, step))


@pytest.fixture
def arch(request):
    return _references(request.param)


@functools.cache
def _references(name):
    """(JAX cfg, port cfg, {"fp32"[, "int4"]: (JAX params, port params)},
    JAX references of the forwards, and of the prefill (int4 where the
    arch is quantized) followed by STEPS greedy decode steps with every
    step's cache), computed once an arch: one jitted function for the
    forwards and the prefill, one for a decode step."""
    jcfg = j_arch(name).reduced()
    trees = {"fp32": j_model(jcfg).init(jax.random.PRNGKey(0), jcfg)}
    if name in INT4_ARCHS:
        # one jitted quantize_tree compiles faster than its eager ops
        # (same codes, scales and shifts)
        trees["int4"] = jax.jit(
            lambda k, p: quantize_tree(
                k, p, QuantPolicy(cfg=QuantConfig(bits=4)))[0],
            compiler_options=FAST_COMPILE)(jax.random.PRNGKey(1),
                                           trees["fp32"])
    weights = {q: (p, bridge.from_jax_tree(_to_numpy_tree(p),
                                           dtype=torch.float32,
                                           device="cpu"))
               for q, p in trees.items()}
    rng = np.random.default_rng(len(name))
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    pad = _pad_mask()
    fwd = jax.jit(lambda w, t, m: _forwards(w, jcfg, t, m),
                  compiler_options=FAST_COMPILE)
    plain, padded, step, shared = fwd(list(trees.values()), toks, pad)
    forwards = {q: (plain[i], padded[i]) for i, q in enumerate(trees)}
    decode = jax.jit(lambda q, c, t, pos: jt.decode_step(q, jcfg, c, t, pos),
                     compiler_options=FAST_COMPILE)
    chain = list(trees.values())[-1]
    steps = [step]
    for i in range(STEPS):
        nxt = jnp.argmax(step[0][:, -1], -1)[:, None].astype(jnp.int32)
        step = decode(chain, step[1], nxt, jnp.int32(S + i))
        steps.append(step)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jcfg=jcfg, cfg=t_arch(name).reduced(), weights=weights,
                chain=list(trees)[-1], toks=toks, pad=pad,
                forwards=np_(forwards), steps=np_(steps),
                shared=np_(shared))


@pytest.mark.parametrize("arch,quant", [(a, q) for a in ARCHS for q in (
    ("fp32", "int4") if a in INT4_ARCHS else ("fp32",))], indirect=["arch"])
@pytest.mark.parametrize("padded", [False, True])
def test_forward_matches_jax(arch, quant, padded):
    cfg, (_, port) = arch["cfg"], arch["weights"][quant]
    batch = {"tokens": torch.from_numpy(arch["toks"]).long()}
    kw = {"pad_mask": torch.from_numpy(arch["pad"])} if padded else {}
    logits, cache = tt.forward(port, cfg, batch, **kw)
    assert cache is None and logits.dtype == torch.float32
    _close(logits, arch["forwards"][quant][int(padded)])


@pytest.mark.parametrize("arch", ARCHS, indirect=True)
def test_prefill_cache_and_decode_steps_match_jax(arch):
    """The prefill's logits and (k, v, slot_pos), then STEPS decode steps
    from it, each step's logits and whole cache (updated in place)."""
    cfg, (_, port) = arch["cfg"], arch["weights"][arch["chain"]]
    logits, cache = tt.prefill(port, cfg,
                               {"tokens": torch.from_numpy(arch["toks"])},
                               max_len=MAX_LEN,
                               pad_mask=torch.from_numpy(arch["pad"]))
    assert isinstance(cache, ta.KVCache)
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    assert cache.k.shape == (L, B, MAX_LEN, Hkv, D)
    assert cache.slot_pos.shape == (L, B, MAX_LEN)
    for i, (jl, jc) in enumerate(arch["steps"]):
        if i:
            nxt = torch.from_numpy(np.argmax(arch["steps"][i - 1][0][:, -1],
                                             -1)[:, None])
            logits, cache2 = tt.decode_step(port, cfg, cache, nxt, S + i - 1)
            assert cache2 is cache
        _close(logits, jl)
        _close(cache.k, jc.k)
        _close(cache.v, jc.v)
        np.testing.assert_array_equal(cache.slot_pos.numpy(), jc.slot_pos)
    # row j's pads and the rows past the last step stay empty
    sp = cache.slot_pos[0].numpy()
    for j, n in enumerate(PAD):
        assert (sp[j, :n] == -1).all() and (sp[j, n:S + STEPS] >= 0).all()
    assert (sp[:, S + STEPS:] == -1).all()


@pytest.mark.parametrize("arch", ARCHS, indirect=True)
def test_unpadded_prefill_has_shared_positions(arch):
    cfg, (_, port) = arch["cfg"], arch["weights"]["fp32"]
    jc, (jl, jc2) = arch["shared"]
    _, tc = tt.prefill(port, cfg,
                       {"tokens": torch.from_numpy(arch["toks"][:, :5])},
                       max_len=8)
    assert tc.slot_pos.shape == (cfg.n_layers, 8)
    np.testing.assert_array_equal(tc.slot_pos.numpy(), jc.slot_pos)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    # a decode step over the shared positions writes row 5 of every layer
    logits, tc = tt.decode_step(port, cfg, tc,
                                torch.zeros((B, 1), dtype=torch.long), 5)
    _close(logits, jl)
    _close(tc.k, jc2.k)
    np.testing.assert_array_equal(tc.slot_pos.numpy(), jc2.slot_pos)
    assert tc.slot_pos[:, :6].min() == 0 and (tc.slot_pos[:, 6:] == -1).all()


def _serve(srv, req_cls, prompts, budgets):
    reqs = [req_cls(i, p, b) for i, (p, b) in
            enumerate(zip(prompts, budgets))]
    srv.serve(reqs)
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("arch", ARCHS, indirect=True)
def test_server_tokens_match_jax(arch, monkeypatch):
    """Two left-padded waves of four, both padded to 12 tokens, with
    budgets 0, 1 and mixed, and an eos_id that the port's run without
    one emits mid-stream: the port's tokens equal the JAX ``Server``'s
    (its prefill jitted, so both waves share one compile), and equal the
    run without eos cut before each request's first eos. Unquantized
    weights on every arch, and the int4 ones on stablelm-1.6b (the arch
    served on the card; the plain CPU matmul's dequantization makes them
    slow here)."""
    jcfg, cfg = arch["jcfg"], arch["cfg"]
    rng = np.random.default_rng(3)
    lens = [12, 3, 7, 1, 9, 12, 5, 10]
    budgets = [None, 0, 1, 4, None, 1, 0, 6]
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in lens]
    scfg = dict(max_batch=4, max_new_tokens=6, max_len=24)
    monkeypatch.setattr(jt, "prefill", jax.jit(
        jt.prefill, static_argnames=("cfg", "max_len"),
        compiler_options=FAST_COMPILE))
    for jp, port in arch["weights"].values():
        srv = tsl.Server(cfg, port, tsl.ServeConfig(**scfg), device="cpu")
        free = _serve(srv, tsl.Request, prompts, budgets)
        assert [len(o) for o in free] == [6, 0, 1, 4, 6, 1, 0, 6]
        assert len(srv.wave_prefill_s) == 2 and len(srv.decode_step_s) == 10
        eos = free[0][2]
        jouts = _serve(jsl.Server(jcfg, jp, jsl.ServeConfig(**scfg,
                                                            eos_id=eos)),
                       jsl.Request, prompts, budgets)
        touts = _serve(tsl.Server(cfg, port, tsl.ServeConfig(**scfg,
                                                             eos_id=eos),
                                  device="cpu"), tsl.Request, prompts,
                       budgets)
        assert touts == jouts
        assert touts == [o[:o.index(eos)] if eos in o else o for o in free]
        assert len(touts[0]) <= 2


# ------------------------------------------------------ attend / _mask ---
def _positions(rng, shape, lo, hi, empty=0.2):
    pos = rng.integers(lo, hi, size=shape).astype(np.int32)
    pos[rng.random(shape) < empty] = -1
    return pos


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5), (False, 3)])
@pytest.mark.parametrize("batched", [False, True])
def test_mask_matches_jax(causal, window, batched):
    rng = np.random.default_rng(int(causal) + 2 * (window or 0))
    q = rng.integers(0, 16, size=(2, 6) if batched else (6,)).astype(
        np.int32)
    kv = _positions(rng, (2, 16) if batched else (16,), 0, 16)
    want = np.asarray(ja._mask(jnp.asarray(q), jnp.asarray(kv), causal,
                               window))
    got = ta._mask(torch.from_numpy(q), torch.from_numpy(kv), causal, window)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("Hq,Hkv,window,kv_chunk", [
    (4, 4, None, None), (4, 2, None, 8), (6, 1, 6, None), (4, 2, 6, 4),
    (6, 1, None, 8), (4, 4, 6, None)])
def test_attend_matches_jax(Hq, Hkv, window, kv_chunk):
    """Seeded q, k, v and per-request positions with -1 entries, and a
    query row with no valid key (all -1), which must stay finite."""
    rng = np.random.default_rng(Hq * 7 + Hkv + (window or 0) + (kv_chunk or 0))
    Bq, Sq, T, D = 2, 5, 16, 8
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(Bq, Sq, Hq, D), f(Bq, T, Hkv, D), f(Bq, T, Hkv, D)
    q_pos = np.tile(np.arange(11, 11 + Sq, dtype=np.int32), (Bq, 1))
    kv_pos = _positions(rng, (Bq, T), 0, 16)
    kv_pos[1] = -1                                 # a row with no valid key
    ref = jax.jit(lambda *a: ja.attend(*a, window=window, kv_chunk=kv_chunk),
                  compiler_options=FAST_COMPILE)
    want = np.asarray(ref(*map(jnp.asarray, (q, k, v, q_pos, kv_pos))))
    got = ta.attend(*map(torch.from_numpy, (q, k, v, q_pos, kv_pos)),
                    window=window, kv_chunk=kv_chunk)
    assert bool(torch.isfinite(got).all())
    _close(got, want)


def test_attend_keeps_bf16_products_in_fp32():
    """bf16 operands: scores and p·v summed in fp32 (JAX's
    preferred_element_type), output rounded to bf16 once."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 3, 2, 64)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(3, dtype=np.int32)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    ref = jax.jit(ja.attend, compiler_options=FAST_COMPILE)
    want = np.asarray(ref(bf(q), bf(k), bf(v), jnp.asarray(pos),
                          jnp.asarray(pos)).astype(jnp.float32))
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = ta.attend(tb(q), tb(k), tb(v), torch.from_numpy(pos),
                    torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-2)


def test_assemble_cache_refuses_a_window_ring():
    """Once a refusal, now the ring of griffin's local attention, held to
    JAX's ``assemble_cache``: S=24 at window 16 keeps the last 16
    positions in ring order (slot_pos [16..23, 8..15]), per request with
    a pad mask; within the window the global layout applies."""
    cfg = dataclasses.replace(t_arch("stablelm-1.6b").reduced(), window=16)
    jcfg = dataclasses.replace(j_arch("stablelm-1.6b").reduced(), window=16)
    rng = np.random.default_rng(0)
    kvs = [tuple(rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
                 for _ in range(2)) for _ in range(3)]
    pos = np.arange(24, dtype=np.int32)
    pad = np.zeros((2, 24), bool)
    pad[1, :10] = True
    for pm in (None, pad):
        want = jt.assemble_cache(
            jcfg, [tuple(jnp.asarray(a)[None] for a in kv) for kv in kvs],
            jnp.asarray(pos), max_len=64,
            pad_mask=None if pm is None else jnp.asarray(pm))
        got = tt.assemble_cache(
            cfg, [tuple(map(torch.from_numpy, kv)) for kv in kvs],
            torch.from_numpy(pos), max_len=64,
            pad_mask=None if pm is None else torch.from_numpy(pm))
        np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
        np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
        np.testing.assert_array_equal(got.slot_pos.numpy(),
                                      np.asarray(want.slot_pos))
    assert got.slot_pos[0, 0].tolist() == list(range(16, 24)) + \
        list(range(8, 16))
    assert got.slot_pos[0, 1].tolist()[8:10] == [-1, -1]
    # within the window the global layout still applies, as in JAX
    kv = (torch.zeros(1, 8, 4, 32), torch.zeros(1, 8, 4, 32))
    kv = (kv[0][:, :4], kv[1][:, :4])
    c = tt.assemble_cache(cfg, [kv], torch.arange(4, dtype=torch.int32),
                          max_len=6)
    assert c.k.shape == (1, 1, 6, 4, 32)
    assert c.slot_pos.tolist() == [[0, 1, 2, 3, -1, -1]]


def test_init_cache_and_serve_cli(capsys):
    cfg = t_arch("mistral-large-123b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.rope_theta) == (88, 12288, 96, 8, 128, 1e6)
    c = tt.init_cache(cfg.reduced(), 2, 10, device="cpu")
    assert c.k.shape == (2, 2, 10, 4, 32) and c.k.dtype == torch.bfloat16
    assert (c.slot_pos == -1).all() and c.slot_pos.shape == (2, 10)
    from repro_torch.launch.serve import main
    main(["--arch", "stablelm-1.6b", "--reduced", "--wave", "--method",
          "none", "--requests", "3", "--max-new-tokens", "4", "--device",
          "cpu"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "slot-cache" not in out
    assert "1 waves, 3 decode steps" in out


def test_slot_attention_refuses_a_window():
    """The engine's slot-cache branches take no window (as in JAX)."""
    q = torch.zeros(1, 1, 4, 32)
    with pytest.raises(NotImplementedError, match="no window"):
        ta._slot_attention(object(), 0, q, q, q,
                           torch.zeros(1, 1, dtype=torch.int32), None, False,
                           window=4)
