"""Port parity, RWKV6: the chunked WKV, the model and the wave server of
the port against the JAX package's, on seeded numpy inputs.

- WKV: the port's ``wkv_chunked_ref`` (what the CPU path of
  ``wkv_chunked`` runs) against ``wkv_chunked_jnp`` for y and the final
  state, with and without a carry-in state, and against the Pallas kernel
  in interpret mode and the sequential oracle ``wkv_ref``; the port's
  ``wkv_step_ref`` against ``wkv_ref``.
- Model: the reduced rwkv6-3b with INT4 SplitQuant weights quantized by
  the JAX package and loaded through ``bridge.from_jax_tree``: prefill
  logits and every part of ``RWKVState`` for T a multiple of 16 (the
  chunked branch) and not (the step branch), then decode steps.
- Serving: the port's wave ``Server`` against the JAX ``Server`` over
  waves of mixed prompt lengths (left-padded with token 0, the pads
  folded into the state, as the JAX package does).

Tolerances: WKV y and state, logits and state atol 1e-4 × max(1, the
reference's largest magnitude) in fp32 (summation order differs); the
extreme-decay case 1e-3, as tests/test_wkv_kernel.py holds it; greedy
tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch
from repro.core import QuantConfig, QuantPolicy, quantize_tree
from repro.kernels.wkv_chunked import wkv_chunked as j_wkv_pallas
from repro.kernels.wkv_chunked import wkv_chunked_jnp, wkv_ref
from repro.models import rwkv6 as jr
from repro.runtime import serve_loop as jsl

from repro_torch import bridge
from repro_torch.configs import get_arch as t_arch
from repro_torch.kernels import wkv_chunked as tw
from repro_torch.models import get_model, rwkv6 as tr, transformer
from repro_torch.runtime import serve_loop as tsl

from test_torch_quant import _to_numpy_tree


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _wkv_inputs(BH, T, K, V, seed, decay_scale=2.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = f(BH, T, K), f(BH, T, K), f(BH, T, V)
    w = np.exp(-np.exp(f(BH, T, K) * decay_scale - 1)).astype(np.float32)
    u = f(BH, K) * 0.5
    s0 = f(BH, K, V)
    return r, k, v, w, u, s0


SHAPES = [(2, 32, 16, 16), (4, 64, 32, 32), (1, 128, 64, 64)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_chunked_ref_matches_jnp(shape, with_s0):
    r, k, v, w, u, s0 = _wkv_inputs(*shape, seed=sum(shape))
    s0 = s0 if with_s0 else None
    jy, jS = wkv_chunked_jnp(*map(jnp.asarray, (r, k, v, w, u)), chunk=16,
                             s0=None if s0 is None else jnp.asarray(s0))
    t = lambda a: None if a is None else torch.from_numpy(a)
    for fn in (tw.wkv_chunked_ref, tw.wkv_chunked):
        ty, tS = fn(*map(t, (r, k, v, w, u)), s0=t(s0))
        assert ty.dtype == torch.float32 and tS.dtype == torch.float32
        _close(ty, jy)
        _close(tS, jS)


@pytest.mark.parametrize("shape", SHAPES)
def test_wkv_matches_pallas_interpret_and_oracle(shape):
    r, k, v, w, u, _ = _wkv_inputs(*shape, seed=sum(shape) + 1)
    jargs = tuple(map(jnp.asarray, (r, k, v, w, u)))
    targs = tuple(map(torch.from_numpy, (r, k, v, w, u)))
    pallas = j_wkv_pallas(*jargs, chunk=16, interpret=True)
    oracle = wkv_ref(*jargs)
    ty, tS = tw.wkv_chunked(*targs)
    _close(ty, pallas)
    _close(ty, oracle)
    sy, sS = tw.wkv_step_ref(*targs)
    _close(sy, oracle)
    _close(sS, tS)


def test_wkv_extreme_decay_stays_finite():
    r, k, v, _, u, s0 = _wkv_inputs(2, 32, 16, 16, seed=5)
    w = np.full(r.shape, 1e-45, np.float32)    # denormal, flushed to 0
    oracle = wkv_ref(*map(jnp.asarray, (r, k, v, w, u)))
    targs = tuple(map(torch.from_numpy, (r, k, v, w, u)))
    for y, S in (tw.wkv_chunked(*targs), tw.wkv_step_ref(*targs),
                 tw.wkv_chunked(*targs, s0=torch.from_numpy(s0))):
        assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(S).all())
    _close(tw.wkv_chunked(*targs)[0], oracle, rel=1e-3)


def test_wkv_state_carry_equals_contiguous():
    r, k, v, w, u, _ = _wkv_inputs(2, 64, 16, 16, seed=6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    y, S = tw.wkv_chunked(*map(t, (r, k, v, w, u)))
    h = 32
    y1, S1 = tw.wkv_chunked(*map(t, (r[:, :h], k[:, :h], v[:, :h],
                                     w[:, :h], u)))
    y2, S2 = tw.wkv_chunked(*map(t, (r[:, h:], k[:, h:], v[:, h:],
                                     w[:, h:], u)), s0=S1)
    _close(torch.cat([y1, y2], 1), y.numpy())
    _close(S2, S.numpy())


# -------------------------------------------------------------- model ---
@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, port cfg, JAX INT4 params, the port's bridged params)."""
    jcfg = j_arch("rwkv6-3b").reduced()
    params = jr.init(jax.random.PRNGKey(0), jcfg)
    # give the zero-initialised μ, u and decay parameters values, so the
    # token shift, the bonus and the decay LoRA all take part
    rng = np.random.default_rng(11)
    att = params["layers"]["att"]
    for name in ("time_mu_x", "time_mu_w", "time_mu_k", "time_mu_v",
                 "time_mu_r", "time_mu_g", "time_faaaa", "time_decay"):
        att[name] = att[name] + jnp.asarray(
            rng.standard_normal(att[name].shape).astype(np.float32) * 0.3)
    ffn = params["layers"]["ffn"]
    for name in ("time_mu_k", "time_mu_r"):
        ffn[name] = ffn[name] + jnp.asarray(
            rng.uniform(0, 1, ffn[name].shape).astype(np.float32))
    qtree, report = quantize_tree(jax.random.PRNGKey(1), params,
                                  QuantPolicy(cfg=QuantConfig(bits=4)))
    port = bridge.from_jax_tree(_to_numpy_tree(qtree), dtype=torch.float32,
                                device="cpu")
    return jcfg, t_arch("rwkv6-3b").reduced(), qtree, port, report


def test_bridge_loads_the_rwkv_tree(pair):
    jcfg, cfg, qtree, port, report = pair
    assert sorted(report["quantized"]) == sorted(
        [f"layers/{b}/{w}" for b, ws in (("att", "wr wk wv wg wo"),
                                         ("ffn", "wr wk wv"))
         for w in ws.split()] + ["lm_head"])
    lp = port["layers"][1]
    assert len(port["layers"]) == cfg.n_layers
    assert lp["att"]["time_w2"].shape == (5, tr.LORA_MU, cfg.d_model)
    for name in ("time_w2", "time_decay", "time_faaaa", "ln_x_scale"):
        assert isinstance(lp["att"][name], torch.Tensor)
        np.testing.assert_array_equal(
            lp["att"][name].numpy(),
            np.asarray(qtree["layers"]["att"][name][1]))
    assert isinstance(lp["ln1"]["norm_scale"], torch.Tensor)


@pytest.mark.parametrize("T", [32, 13])
def test_prefill_and_decode_match_jax(pair, T):
    """T=32 runs the chunked WKV branch, T=13 the step branch; then three
    decode steps (step branch) from the prefilled state."""
    jcfg, cfg, qtree, port, _ = pair
    rng = np.random.default_rng(T)
    toks = rng.integers(0, cfg.vocab, (3, T))
    jl, js = jr.prefill(qtree, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, ts = tr.prefill(port, cfg, {"tokens": torch.from_numpy(toks)})
    assert isinstance(ts, tr.RWKVState)
    _close(tl, jl)
    for a, b in zip(ts, js):
        _close(a, b)
    for _ in range(3):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None]
        jl, js = jr.decode_step(qtree, jcfg, js,
                                jnp.asarray(nxt, jnp.int32))
        tl, ts = tr.decode_step(port, cfg, ts, torch.from_numpy(nxt))
        _close(tl, jl)
        for a, b in zip(ts, js):
            _close(a, b)


def test_chunked_branch_takes_the_wkv_wrapper(pair, monkeypatch):
    _, cfg, _, port, _ = pair
    calls = []
    real = tr.wkv_chunked
    monkeypatch.setattr(tr, "wkv_chunked",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    toks = torch.zeros((2, 48), dtype=torch.long)
    tr.prefill(port, cfg, {"tokens": toks})
    H = cfg.d_model // cfg.rwkv_head_dim
    assert calls == [(2 * H, 48, cfg.rwkv_head_dim)] * cfg.n_layers
    calls.clear()
    tr.prefill(port, cfg, {"tokens": toks[:, :47]})
    tr.decode_step(port, cfg, tr.init_state(cfg, 2, device="cpu"),
                   toks[:, :1])
    assert calls == []


@pytest.mark.parametrize("max_batch,budgets", [
    (3, [None] * 7),
    (4, [None, 3, None, 0, 5, None, 1]),
])
def test_wave_server_matches_jax(pair, max_batch, budgets):
    """Waves of mixed prompt lengths: padded lengths 16 and 32 (chunked
    WKV), 40 and 4 (step recurrence); per-request budgets, 0 included."""
    jcfg, cfg, qtree, port, _ = pair
    rng = np.random.default_rng(max_batch)
    lens = [16, 5, 9, 40, 3, 32, 4]
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in lens]
    jreqs = [jsl.Request(i, p.astype(np.int32), b)
             for i, (p, b) in enumerate(zip(prompts, budgets))]
    treqs = [tsl.Request(i, p, b)
             for i, (p, b) in enumerate(zip(prompts, budgets))]
    jsl.Server(jcfg, qtree, jsl.ServeConfig(
        max_batch=max_batch, max_new_tokens=6)).serve(jreqs)
    srv = tsl.Server(cfg, port, tsl.ServeConfig(max_batch=max_batch,
                                                max_new_tokens=6),
                     device="cpu")
    srv.serve(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done for r in treqs)
    assert len(srv.wave_prefill_s) == -(-len(lens) // max_batch)


def test_get_model_and_unported_paths_raise(pair):
    jcfg, cfg, qtree, port, _ = pair
    dense = t_arch("stablelm-1.6b").reduced()
    assert get_model(dense) is transformer and get_model(cfg) is tr
    # the dense family is served by the wave loop too
    srv = tsl.Server(dense, transformer.init(dense, seed=0, device="cpu"),
                     tsl.ServeConfig(max_batch=2, max_new_tokens=2),
                     device="cpu")
    reqs = srv.serve([tsl.Request(i, np.arange(1, n)) for i, n in
                      enumerate((3, 6, 2))])
    assert [len(r.out) for r in reqs] == [2, 2, 2]
    assert len(srv.wave_prefill_s) == 2
    # both families serve at a temperature too: every budget met
    for c, p in ((dense, transformer.init(dense, seed=0, device="cpu")),
                 (cfg, port)):
        reqs = tsl.Server(c, p, tsl.ServeConfig(
            max_batch=2, max_new_tokens=3, temperature=0.7),
            device="cpu").serve([tsl.Request(i, np.arange(1, n)) for i, n
                                 in enumerate((3, 6, 2))])
        assert [len(r.out) for r in reqs] == [3, 3, 3]
        assert all(0 <= t < c.vocab for r in reqs for t in r.out)
    toks = {"tokens": torch.zeros((1, 16), dtype=torch.long)}
    # the MoE family is served by the transformer module
    assert get_model(dataclasses.replace(cfg, family="moe")) is transformer
    calls = [
        lambda: tr.prefill(port, cfg, toks, pad_mask=torch.ones(1, 16)),
        lambda: tr.prefill(port, cfg, toks, moe_blocks=2),
        lambda: tr.verify_step_slots(),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError):
            call()


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = t_arch("rwkv6-3b").reduced()
    for call in (lambda: tr.init(cfg), lambda: tr.init_state(cfg, 1),
                 lambda: tsl.Server(cfg, {}, tsl.ServeConfig())):
        with pytest.raises(RuntimeError):
            call()


def test_serve_cli_and_smoke_workload(capsys):
    from repro_torch.launch.serve import main, rwkv_smoke_workload
    main(["--arch", "rwkv6-3b", "--reduced", "--requests", "3",
          "--max-new-tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "wave loop" in out and "3 requests, 12 tokens" in out
    cfg, scfg, quant, warmup, prompts = rwkv_smoke_workload()
    assert (cfg.name, cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab,
            cfg.rwkv_head_dim) == ("rwkv6-3b", 32, 2560, 8960, 65536, 64)
    assert scfg.max_batch == 8 and scfg.max_new_tokens == 32
    assert quant == dict(bits=4, method="splitquant", seed=0)
    assert len(prompts) == 16 and len(warmup) == 8
    assert all(len(p) % 16 == 0 and 64 <= len(p) <= 256 for p in prompts)
