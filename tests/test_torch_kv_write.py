"""Port parity, the K/V cache write: the port's ``slot_layer_write`` and
``slot_chunk_prefill`` (on the CPU: ``write_kv_rows_ref``, the plain
version of the one-launch write kernel, then the attention's plain
version, which in verify mode reads the window back from the rows just
written) against the JAX package's ``slot_layer_write`` and
``slot_chunk_prefill``, on reduced stablelm-1.6b (MHA) and chatglm3-6b
(GQA), in fp, int8-dynamic and int8-static cache modes.

One seeded sequence of decode writes, chunks and verify windows runs
through both packages; JAX's cache state and outputs after every step are
computed once per (arch, mode) by a module-scoped fixture, jitted, and
each test replays the port up to its step. Jitted, XLA may contract the
static quantizer's S·x + Z into one FMA, which moves a code by one at a
tie (``test_torch_static_kv.py`` counts those); the port rounds the
product and the sum apart, as JAX does op by op, so the static cases
also hold every code the jitted reference wrote to JAX's quantizer
evaluated op by op on the same row.

Tolerances: the whole cache state (``k``, ``v``, the four scale arrays and
``kv_pos``) bit-identical after every step. Attention outputs of chunks
and verify windows atol 1e-5 (fp32 summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.calib import kv_static_scales
from repro.configs import get_arch
from repro.engine import kvcache as jkv

from repro_torch.engine import kvcache as tkv
from repro_torch.kernels import prefill_attention as pa

ARCHS = ["stablelm-1.6b", "chatglm3-6b"]
MODES = ["fp", "dynamic", "static"]
ATOL = 1e-5
N_SLOTS, T = 3, 24
#: the references are tiny: XLA's optimization level 0 compiles them
#: faster than the default
FAST_COMPILE = {"xla_backend_optimization_level": 0}

#: the sequence: ("decode", positions per slot) writes every layer;
#: ("chunk" / "verify", slot, pos_start, Sq, length) one layer. The last
#: slot's rows end the allocation, so its steps past T probe the drop.
STEPS = [
    ("chunk", 2, 0, 8, 8),
    # a bucket-padded chunk: rows 13..15 marked -1
    ("chunk", 2, 8, 8, 5),
    # distinct per-slot positions; slot 1's 30 lands on row 30 % T
    ("decode", [3, 30, 13]),
    # a verify window over the slot's 14 earlier rows
    ("verify", 2, 14, 8, 4),
    # a padded chunk sticking out past T: rows 24..26 dropped
    ("chunk", 0, 19, 8, 3),
    # a verify window padded past T, its length ending at T (the engine's
    # window near max_len)
    ("verify", 2, 22, 8, 2),
    # a verify window whose length reaches past T: rows 24, 25 are
    # dropped from the cache but attended, as in JAX
    ("verify", 0, 22, 8, 4),
]


def _np(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _static_scales(cfg):
    rng = np.random.default_rng(3)
    shape = (cfg.n_layers, cfg.n_kv_heads, 4)
    lo = -rng.uniform(1.5, 3.5, shape).astype(np.float32)
    hi = rng.uniform(1.5, 3.5, shape).astype(np.float32)
    return kv_static_scales({"k_min": lo, "k_max": hi, "v_min": lo * 0.8,
                             "v_max": hi * 1.1})


def _inputs(cfg, mode):
    """The seeded inputs of every step: (k, v) of each layer for a
    decode write, (q, k, v) for a chunk or window."""
    rng = np.random.default_rng(17 + MODES.index(mode))
    Hq, H, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = []
    for step in STEPS:
        if step[0] == "decode":
            out.append(rng.standard_normal(
                (cfg.n_layers, 2, N_SLOTS, 1, H, D)).astype(np.float32))
        else:
            Sq = step[3]
            out.append((rng.standard_normal((Sq, Hq, D)).astype(np.float32),
                        *rng.standard_normal((2, Sq, H, D)).astype(
                            np.float32)))
    return out


def _layer_of(cfg, i):
    return i % cfg.n_layers


def _state(c):
    return {f: np.array(getattr(c, f)) for f in ("k", "v", "kv_pos") +
            tkv.SCALE_KEYS}


def _decode_all(jc, k, v, pos):
    """JAX's decode write of every layer (k, v (L, N, 1, Hkv, D))."""
    for layer in range(k.shape[0]):
        jl = jax.tree_util.tree_map(lambda a: a[layer], jc)
        jl = jkv.slot_layer_write(jl, k[layer], v[layer], pos)
        jc = jax.tree_util.tree_map(
            lambda full, part: full.at[layer].set(part), jc, jl)
    return jc


def _chunk_on(jc, layer, q, k, v, slot, pos_start, length, *, verify):
    """JAX's chunk or verify window on one layer."""
    jl = jax.tree_util.tree_map(lambda a: a[layer], jc)
    o, jl = jkv.slot_chunk_prefill(jl, q, k, v, slot, pos_start, length,
                                   verify=verify)
    return o, jax.tree_util.tree_map(
        lambda full, part: full.at[layer].set(part), jc, jl)


@pytest.fixture(scope="module", params=[(a, m) for a in ARCHS for m in MODES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def jax_ref(request):
    """JAX's cache state and output after every step of :data:`STEPS`,
    jitted (one compile a step kind)."""
    arch, mode = request.param
    cfg = get_arch(arch).reduced()
    sc = _static_scales(cfg) if mode == "static" else None
    kv_mode = "fp" if mode == "fp" else "int8"
    jc = jkv.init_slot_cache(cfg, N_SLOTS, T, mode=kv_mode, kv_scales=sc)
    inputs = _inputs(cfg, mode)
    decode = jax.jit(_decode_all, compiler_options=FAST_COMPILE)
    chunk = jax.jit(_chunk_on, static_argnames="verify",
                    compiler_options=FAST_COMPILE)
    states, outs = [], []
    for i, (step, x) in enumerate(zip(STEPS, inputs)):
        o = None
        if step[0] == "decode":
            pos = np.asarray(step[1], np.int32)[:, None]
            jc = decode(jc, *map(jnp.asarray, x.swapaxes(0, 1)),
                        jnp.asarray(pos))
        else:
            _, slot, pos_start, _, length = step
            o, jc = chunk(jc, _layer_of(cfg, i), *map(jnp.asarray, x), slot,
                          pos_start, length, verify=step[0] == "verify")
            o = _np(o)
        states.append(_state(jc))
        outs.append(o)
    return dict(cfg=cfg, mode=mode, kv_mode=kv_mode, scales=sc,
                inputs=inputs, states=states, outs=outs)


@pytest.mark.parametrize("upto", range(len(STEPS)),
                         ids=[f"{i}-{s[0]}" for i, s in enumerate(STEPS)])
def test_cache_state_matches_jax(jax_ref, upto):
    """The port's cache state after step ``upto`` (and that step's output)
    equals JAX's."""
    cfg = jax_ref["cfg"]
    tc = tkv.init_slot_cache(cfg, N_SLOTS, T, mode=jax_ref["kv_mode"],
                             kv_scales=jax_ref["scales"], device="cpu")
    for i in range(upto + 1):
        step, x = STEPS[i], jax_ref["inputs"][i]
        if step[0] == "decode":
            pos = _t(np.asarray(step[1], np.int32)[:, None])
            for layer in range(cfg.n_layers):
                tkv.slot_layer_write(tc, layer, *map(_t, x[layer]), pos)
        else:
            _, slot, pos_start, _, length = step
            o = tkv.slot_chunk_prefill(tc, _layer_of(cfg, i), *map(_t, x),
                                       slot, pos_start, length,
                                       verify=step[0] == "verify")
    if STEPS[upto][0] != "decode":
        np.testing.assert_allclose(o.numpy(), jax_ref["outs"][upto],
                                   atol=ATOL, rtol=0)
    for f, want in jax_ref["states"][upto].items():
        np.testing.assert_array_equal(getattr(tc, f).numpy(), want,
                                      err_msg=f)
    assert tc.static == (jax_ref["mode"] == "static")
    if tc.static:
        _assert_op_by_op(jax_ref, upto)


def _assert_op_by_op(jax_ref, i):
    """Every code the jitted JAX reference wrote at step ``i`` equals
    JAX's static quantizer evaluated op by op on the same K/V row (no FMA
    tie), so the static state the port is held to is JAX's op by op."""
    cfg = jax_ref["cfg"]
    step, x, st = STEPS[i], jax_ref["inputs"][i], jax_ref["states"][i]
    sc = jax_ref["scales"]
    if step[0] == "decode":
        writes = [(layer, n, step[1][n] % T, x[layer, kv, n, 0], kv)
                  for layer in range(cfg.n_layers) for kv in range(2)
                  for n in range(N_SLOTS)]
    else:
        _, slot, pos_start, Sq, _ = step
        writes = [(_layer_of(cfg, i), slot, pos_start + r, x[1 + kv][r], kv)
                  for kv in range(2) for r in range(min(Sq, T - pos_start))]
    assert writes
    with jax.disable_jit():
        for layer, n, t, row, kv in writes:
            f = "kv"[kv]
            want = jkv.quantize_kv_static(
                jnp.asarray(row), jnp.asarray(sc[f"{f}_scale"][layer]),
                jnp.asarray(sc[f"{f}_zero"][layer]))
            np.testing.assert_array_equal(st[f][layer, n, t], _np(want))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_write_plain_version_equals_the_quantizers(arch, mode):
    """write_kv_rows (plain on the CPU) stores what the standalone
    quantizers give for the same rows, at the rows its map says, and
    drops the rows at or past T."""
    cfg = get_arch(arch).reduced()
    tc = tkv.init_slot_cache(cfg, N_SLOTS, T,
                             mode="fp" if mode == "fp" else "int8",
                             kv_scales=_static_scales(cfg)
                             if mode == "static" else None, device="cpu")
    rng = np.random.default_rng(11)
    H, D = cfg.n_kv_heads, cfg.head_dim
    k, v = map(_t, rng.standard_normal((2, 5, H, D)).astype(np.float32))
    tkv.slot_chunk_prefill(tc, 1, torch.zeros((5, cfg.n_heads, D)), k, v, 0,
                           T - 3, 2)
    rows = slice(T - 3, T)
    assert tc.kv_pos[1, 0, rows].tolist() == [T - 3, T - 2, -1]
    assert (tc.kv_pos[1, 0, :T - 3] == -1).all()
    if mode == "fp":
        assert torch.equal(tc.k[1, 0, rows], k[:3])
    elif mode == "static":
        ks, kz, _, _ = tc.layer_scales(1)
        assert torch.equal(tc.k[1, 0, rows],
                           pa.quantize_kv_static(k[:3], ks, kz))
    else:
        qv, vs, vz = pa.quantize_kv(v[:3], 4)
        assert torch.equal(tc.v[1, 0, rows], qv)
        assert torch.equal(tc.v_scale[1, 0, rows], vs)
        assert torch.equal(tc.v_zero[1, 0, rows], vz)


