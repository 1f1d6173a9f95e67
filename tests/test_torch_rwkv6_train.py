"""Port parity, rwkv6 training: the WKV gradient, rwkv6's ``loss_fn`` and
AdamW steps of the reduced model against the JAX package, on seeded
numpy inputs.

- The WKV gradient: the port's plain backward ``wkv_chunked_bwd_ref``
  (what ``WkvChunked.backward`` runs on a CPU tensor) against ``jax.vjp``
  of ``wkv_chunked_jnp``, of the sequential oracle ``wkv_ref`` and of
  the same recurrence from s0 with a cotangent on S, and against ``torch.autograd`` of the port's plain forward; the slabs of
  value columns the CUDA kernel splits a head into, added up; extreme
  decays.
- The model: reduced rwkv6-3b (2 layers, d 128, 4 heads of 32, vocab
  512) from JAX's seeded ``init`` with its μ and u parameters nudged off
  zero, through ``bridge.from_jax_tree``: the loss and every leaf's
  gradient against ``jax.value_and_grad(rwkv6.loss_fn)`` at S = 32 (the
  chunked branch, through ``WkvChunked``) and S = 12 (the step branch),
  with and without remat; three AdamW steps against JAX's.

Tolerances: the WKV gradients within 1e-4 x each output's largest
magnitude (fp32, sums in another order), dw compared as dw ⊙ w (the
log-decay's gradient: dw itself is that over w, huge where w is small)
and as dw where w > 1e-3; the loss within 1e-5 relative and the
gradients within 1e-4 x the largest gradient entry, as
test_torch_train.py holds the transformer's; remat on and off identical;
the losses of three AdamW steps within 1e-5 relative.

JAX's gradient of the chunked form is not finite wherever a chunk's
summed log-decay falls below about -88: the masked-out exponentials of
the pairwise decays (s >= t) overflow to inf, and ``where``'s gradient
multiplies them by 0. The default inputs (decay scale 2) reach that, so
dw is held to JAX's chunked VJP where that is finite and to the VJP of
a step form (no exponentials) everywhere: ``wkv_ref`` without a state,
the same recurrence from s0 with a cotangent on S written in the test;
the port's gradient is finite everywhere.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch
from repro.data import DataConfig as JDataConfig
from repro.data import synthetic_lm_batch as j_lm_batch
from repro.kernels.wkv_chunked import wkv_chunked_jnp, wkv_ref
from repro.models import rwkv6 as jr
from repro.optim import adamw as jadamw

from repro_torch import bridge
from repro_torch.configs import get_arch as t_arch
from repro_torch.kernels import wkv_chunked as tw
from repro_torch.models import rwkv6 as tr
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop

from test_torch_bert import _flat, _grads, _with_grad
from test_torch_quant import _to_numpy_tree
from test_torch_rwkv6 import SHAPES, _wkv_inputs
from torch_threads import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
FAST_COMPILE = {"xla_backend_optimization_level": 0}
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cotangents(shape, seed):
    BH, T, K, V = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, T, V)).astype(np.float32),
            rng.standard_normal((BH, K, V)).astype(np.float32))


def _port_bwd(inputs, with_s0, y_bar, S_bar):
    r, k, v, w, u, s0 = map(torch.from_numpy, inputs)
    out = tw.wkv_chunked_bwd(r, k, v, w, u, s0 if with_s0 else None,
                             torch.from_numpy(y_bar),
                             None if S_bar is None else torch.from_numpy(S_bar))
    return [None if g is None else g.numpy() for g in out]


# --------------------------------------------------------- WKV gradient ---
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_bwd_ref_matches_jax_vjp(shape, with_s0):
    """Cotangents on y and on the final state."""
    inputs = _wkv_inputs(*shape, seed=sum(shape))
    y_bar, S_bar = _cotangents(shape, sum(shape) + 1)
    w = inputs[3]
    args = tuple(map(jnp.asarray, inputs[:5] + (inputs[5],) * with_s0))
    _, vjp = jax.vjp(
        lambda *a: wkv_chunked_jnp(*a[:5], chunk=16,
                                   s0=a[5] if with_s0 else None), *args)
    want = [np.asarray(g) for g in vjp((jnp.asarray(y_bar),
                                        jnp.asarray(S_bar)))]
    got = _port_bwd(inputs, with_s0, y_bar, S_bar)
    assert (got[5] is None) == (not with_s0)
    for name, g, j in zip(NAMES, got, want):
        assert g.dtype == np.float32 and g.shape == j.shape, name
        assert np.isfinite(g).all(), name
        if name == "dw":
            fin = np.isfinite(j)
            assert fin.mean() > 0.5
            g, j = (g * w)[fin], (j * w)[fin]
        assert _rel_err(g, j) <= 1e-4, (name, _rel_err(g, j))


@pytest.mark.parametrize("shape", SHAPES)
def test_wkv_bwd_ref_matches_the_step_oracle_vjp(shape):
    """The sequential oracle has no exponentials, so its gradient is
    finite at every decay: dw ⊙ w everywhere, and dw where w > 1e-3."""
    r, k, v, w, u, _ = inputs = _wkv_inputs(*shape, seed=sum(shape))
    y_bar, _ = _cotangents(shape, sum(shape) + 2)
    _, vjp = jax.vjp(wkv_ref, *map(jnp.asarray, (r, k, v, w, u)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(y_bar))]
    got = _port_bwd(inputs, False, y_bar, None)
    for name, g, j in zip(NAMES, got, want):
        assert np.isfinite(j).all()
        if name == "dw":
            big = w > 1e-3
            assert _rel_err(g[big], j[big]) <= 1e-4
            g, j = g * w, j * w
        assert _rel_err(g, j) <= 1e-4, (name, _rel_err(g, j))


def _wkv_steps_jnp(r, k, v, w, u, s0):
    """``wkv_ref``'s recurrence from the carry-in state ``s0``, returning
    (y, S) as ``wkv_chunked_jnp`` does, with its decay clamped as the
    chunked form's log clamps it: a step form with no exponentials."""
    w = jnp.maximum(w, 1e-30)

    def step(S, xs):
        r_t, k_t, v_t, w_t = xs
        kv = k_t[..., :, None] * v_t[..., None, :]
        y = jnp.einsum("bi,bij->bj", r_t, S + u[..., None] * kv)
        return w_t[..., None] * S + kv, y
    S, ys = jax.lax.scan(step, s0, tuple(a.transpose(1, 0, 2)
                                         for a in (r, k, v, w)))
    return ys.transpose(1, 0, 2), S


@pytest.mark.parametrize("shape", SHAPES)
def test_wkv_bwd_ref_with_state_matches_a_step_vjp(shape):
    """With s0 and a cotangent on S, against ``jax.vjp`` of the step form
    from s0: finite at every decay, so every output is held everywhere,
    dw as dw ⊙ w and as dw where w > 1e-3."""
    r, k, v, w, u, s0 = inputs = _wkv_inputs(*shape, seed=sum(shape))
    y_bar, S_bar = _cotangents(shape, sum(shape) + 4)
    _, vjp = jax.vjp(_wkv_steps_jnp, *map(jnp.asarray, inputs))
    want = [np.asarray(g) for g in vjp((jnp.asarray(y_bar),
                                        jnp.asarray(S_bar)))]
    got = _port_bwd(inputs, True, y_bar, S_bar)
    for name, g, j in zip(NAMES, got, want):
        assert np.isfinite(j).all(), name
        if name == "dw":
            big = w > 1e-3
            assert _rel_err(g[big], j[big]) <= 1e-4
            g, j = g * w, j * w
        assert _rel_err(g, j) <= 1e-4, (name, _rel_err(g, j))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_s0", [False, True])
def test_function_matches_autograd_of_the_plain_forward(shape, with_s0):
    """``wkv_chunked`` (through ``WkvChunked``) against torch.autograd of
    ``wkv_chunked_ref``, both with a loss on y and on the final state."""
    inputs = _wkv_inputs(*shape, seed=sum(shape))
    y_bar, S_bar = map(torch.from_numpy, _cotangents(shape, sum(shape) + 3))
    w = torch.from_numpy(inputs[3])

    def grads(fn):
        xs = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
        y, S = fn(*xs[:5], s0=xs[5] if with_s0 else None)
        ((y * y_bar).sum() + (S * S_bar).sum()).backward()
        return [x.grad for x in xs]
    got, want = grads(tw.wkv_chunked), grads(tw.wkv_chunked_ref)
    for name, g, j in zip(NAMES, got, want):
        if name == "ds0" and not with_s0:
            assert g is None and j is None
            continue
        assert bool(torch.isfinite(g).all()), name
        if name == "dw":
            fin = torch.isfinite(j)
            g, j = (g * w)[fin], (j * w)[fin]
        assert _rel_err(g.numpy(), j.numpy()) <= 1e-4, name


@pytest.mark.parametrize("w_kind", ["zero", "denormal", "mixed"])
def test_extreme_decay_gradients_are_finite_and_clamped(w_kind):
    """Decays that underflow: every gradient finite and dw = 0 where the
    chunked form clamps (w <= 1e-30); dr, dk, dv, du and ds0 within 1e-4
    of JAX's chunked VJP, dw ⊙ w of the oracle's."""
    shape = (2, 32, 16, 16)
    r, k, v, w, u, s0 = _wkv_inputs(*shape, seed=5)
    if w_kind == "zero":
        w = np.zeros_like(w)
    elif w_kind == "denormal":
        w = np.full_like(w, 1e-45)
    else:
        w = np.where(np.random.default_rng(6).random(w.shape) < 0.4,
                     np.float32(0), w).astype(np.float32)
    y_bar, S_bar = _cotangents(shape, 9)
    inputs = (r, k, v, w, u, s0)
    got = _port_bwd(inputs, True, y_bar, S_bar)
    assert all(np.isfinite(g).all() for g in got)
    assert (got[3][w <= 1e-30] == 0).all()
    assert (got[3][w > 1e-30] != 0).any() == (w_kind == "mixed")
    _, vjp = jax.vjp(lambda *a: wkv_chunked_jnp(*a[:5], chunk=16, s0=a[5]),
                     *map(jnp.asarray, inputs))
    want = [np.asarray(g) for g in vjp((jnp.asarray(y_bar),
                                        jnp.asarray(S_bar)))]
    for name, g, j in zip(NAMES, got, want):
        if name != "dw":
            assert _rel_err(g, j) <= 1e-4, name
    _, ovjp = jax.vjp(wkv_ref, *map(jnp.asarray, inputs[:5]))
    oracle_dw = np.asarray(ovjp(jnp.asarray(y_bar))[3])
    no_s = _port_bwd(inputs, False, y_bar, None)[3]
    assert _rel_err(no_s * w, oracle_dw * w) <= 1e-4


def test_value_slabs_add_up_to_the_gradient():
    """The CUDA kernel splits a head's value columns into slabs of
    ``wkv_bwd_slab`` columns (16 at K = 64) and adds the slabs' partial dr,
    dk, dw and du in slab order: the plain backward over each slab's
    columns gives exactly those partials, and they add up to the whole
    head's gradient; dv and ds0 are the slabs' side by side."""
    shape = (2, 48, 64, 64)
    r, k, v, w, u, s0 = _wkv_inputs(*shape, seed=11)
    y_bar, S_bar = _cotangents(shape, 12)
    vs = tw.wkv_bwd_slab(64, 64)
    assert vs == 16
    full = _port_bwd((r, k, v, w, u, s0), True, y_bar, S_bar)
    parts = [_port_bwd((r, k, v[..., j:j + vs], w, u, s0[..., j:j + vs]),
                       True, y_bar[..., j:j + vs], S_bar[..., j:j + vs])
             for j in range(0, 64, vs)]
    for i in (0, 1, 3, 4):                      # dr, dk, dw, du
        total = functools.reduce(np.add, (p[i] for p in parts))
        assert _rel_err(total, full[i]) <= 1e-5, NAMES[i]
    for i in (2, 5):                            # dv, ds0
        np.testing.assert_allclose(
            np.concatenate([p[i] for p in parts], axis=-1), full[i],
            rtol=0, atol=1e-5 * np.abs(full[i]).max())


@pytest.mark.parametrize("K,V,vs", [(64, 64, 16), (128, 128, 8), (32, 32, 32),
                                    (16, 64, 64), (20, 20, 20), (128, 8, 8)])
def test_backward_slab_fits_the_block(K, V, vs):
    """A block of the backward kernel holds at most 1024 state elements."""
    got = tw.wkv_bwd_slab(K, V)
    assert got == vs and K * got <= tw.BWD_ELEMS and got <= V


def test_no_grad_keeps_nothing_and_the_cpu_launches_no_kernel():
    r, k, v, w, u, s0 = (torch.from_numpy(a).requires_grad_(True)
                         for a in _wkv_inputs(2, 32, 16, 16, seed=13))
    before = (tw.wkv_chunked.launches, tw.wkv_chunked_bwd.launches)
    with torch.no_grad():
        y, S = tw.wkv_chunked(r, k, v, w, u, s0=s0)
    assert y.grad_fn is None and S.grad_fn is None
    y, S = tw.wkv_chunked(r, k, v, w, u, s0=s0)
    assert type(y.grad_fn).__name__ == "WkvChunkedBackward"
    (y.sum() + S.sum()).backward()
    assert before == (tw.wkv_chunked.launches, tw.wkv_chunked_bwd.launches)


# ------------------------------------------------------ the rwkv6 model ---
@functools.cache
def _jax_params():
    """JAX's seeded reduced rwkv6 with the μ (token-shift mixes) and u
    parameters, which init at zero, nudged to seeded values so every term
    of the gradient is exercised: μ ~ U(0, 0.5), u ~ N(0, 0.1²). With u
    ~ N(0, 0.5²) the embedding's gradient is ill-conditioned in fp32:
    both packages' fp32 gradients then lie ~1.2e-4 x the largest entry
    from the float64 gradient (JAX's, with jax_enable_x64), at S = 12 as
    at 32, and so ~1e-4 from each other; here both lie within 1e-5 of
    it."""
    cfg = j_arch("rwkv6-3b").reduced()
    params = _to_numpy_tree(jax.jit(jr.init, static_argnums=1,
                                    compiler_options=FAST_COMPILE)(KEY, cfg))
    rng = np.random.default_rng(0)
    for blk in ("att", "ffn"):
        for name, a in params["layers"][blk].items():
            if name.startswith("time_mu_"):
                params["layers"][blk][name] = rng.uniform(
                    0, 0.5, a.shape).astype(np.float32)
    faaaa = params["layers"]["att"]["time_faaaa"]
    params["layers"]["att"]["time_faaaa"] = (
        rng.standard_normal(faaaa.shape) * 0.1).astype(np.float32)
    return cfg, params


def _batch(cfg, S, step=0, B=2):
    dc = JDataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0)
    return {k: np.array(v) for k, v in j_lm_batch(dc, step).items()}


@functools.cache
def _jax_grad_fn():
    cfg, _ = _jax_params()
    return jax.jit(jax.value_and_grad(
        lambda p, b: jr.loss_fn(p, cfg, b), has_aux=True),
        compiler_options=FAST_COMPILE)


def _jax_loss_and_grads(params, b):
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (loss, _), g = _jax_grad_fn()(jax.tree_util.tree_map(jnp.asarray,
                                                         params), jb)
    return float(loss), g


def _port_loss(params, cfg, b, remat):
    p = _with_grad(bridge.from_jax_tree(params, device="cpu"), [])
    loss, aux = tr.loss_fn(p, cfg, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, remat=remat)
    assert aux["loss"] is loss
    loss.backward()
    return float(loss.detach()), _grads(p)


@pytest.mark.parametrize("S", [32, 12])
def test_loss_and_grads_match_jax(S, monkeypatch):
    """S = 32 runs the chunked WKV through ``WkvChunked`` (its forward's
    plain version twice a layer under remat, its backward once), S = 12
    the step form (neither)."""
    jcfg, params = _jax_params()
    cfg = t_arch("rwkv6-3b").reduced()
    b = _batch(jcfg, S)
    jl, jg = _jax_loss_and_grads(params, b)
    calls = {"wkv_chunked_ref": 0, "wkv_chunked_bwd_ref": 0}
    for name in calls:
        def counting(*a, _fn=getattr(tw, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tw, name, counting)
    loss, grads = _port_loss(params, cfg, b, remat=True)
    chunked = S % tw.CHUNK == 0
    assert calls == {"wkv_chunked_ref": 2 * cfg.n_layers * chunked,
                     "wkv_chunked_bwd_ref": cfg.n_layers * chunked}
    assert abs(loss - jl) <= 1e-5 * abs(jl)
    got, want = _flat(grads), _flat(_to_numpy_tree(jg))
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = np.abs(got[k] - want[k]).max()
        assert err <= 1e-4 * top, (k, err, top)
    # remat recomputes each layer in the backward pass: the same numbers
    loss2, grads2 = _port_loss(params, cfg, b, remat=False)
    assert loss2 == loss
    g2 = _flat(grads2)
    for k in got:
        np.testing.assert_array_equal(g2[k], got[k], err_msg=k)


def test_three_adamw_steps_match_jax():
    """Three AdamW steps from JAX's weights on the same batches (S = 32),
    each package taking its own gradients: the losses within 1e-5
    relative. (The params are not held entry by entry: free-running, the
    two trajectories part at the ulps of gradient entries near eps = 1e-8,
    which Adam's normalization turns into steps of up to lr; see
    test_torch_train.py::test_adamw_over_five_bert_steps_matches_jax.)"""
    jcfg, params = _jax_params()
    cfg = t_arch("rwkv6-3b").reduced()
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    joc, oc = jadamw.OptConfig(**kw), adamw.OptConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = jadamw.init(joc, jp)
    update = jax.jit(functools.partial(jadamw.update, joc),
                     compiler_options=FAST_COMPILE)
    tp = bridge.from_jax_tree(params, device="cpu")
    topt = adamw.init(oc, tp)
    step = train_loop.make_train_step(
        lambda p, bb: tr.loss_fn(p, cfg, bb, remat=True), oc)
    jls, tls = [], []
    for s in range(3):
        b = _batch(jcfg, 32, step=s)
        jl, jg = _jax_loss_and_grads(_to_numpy_tree(jp), b)
        jp, jopt, _ = update(jopt, jp, jg)
        tp, topt, m = step(tp, topt, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        jls.append(jl)
        tls.append(float(m["loss"]))
    assert all(abs(t - j) <= 1e-5 * abs(j) for t, j in zip(tls, jls)), \
        (tls, jls)
    assert tls[-1] != tls[0] and int(topt.step) == int(jopt.step) == 3
