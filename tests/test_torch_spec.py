"""Port parity, self-speculative decoding: the accept rule, the verify
pass against sequential decode, the port's speculative engine against
its own greedy engine and against the JAX speculative engine (tokens and
the scheduler's proposed / accepted counts), over fp, int8 and
int8-static caches with an INT2 SplitQuant draft that rejects most
proposals, plus rollback, eos and the loud failures.

Weights: the JAX package's seeded reduced stablelm-1.6b in fp32 as the
target and its INT2 SplitQuant quantization as the draft, carried over by
the bridge. Tolerances: tokens, counts, codes and kv_pos are compared
exactly; the fp32 K/V that a verify writes into an fp cache match those
of sequential decode steps at atol 1e-5 (fp32 summation order).
"""
import jax
import numpy as np
import pytest
import torch

from repro.calib import collect_kv_stats as j_collect
from repro.calib import kv_static_scales as j_kv_scales
from repro.configs import get_arch
from repro.core import QuantConfig, QuantPolicy, quantize_tree
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.models import get_model

from repro_torch import bridge
from repro_torch.engine import Engine, EngineConfig, kvcache as tkv
from repro_torch.engine.spec import accept_length, verify_argmax
from repro_torch.models import transformer as tt

from test_torch_quant import _to_numpy_tree

MAX_LEN = 48
MODES = ["fp", "int8", "int8-static"]


@pytest.fixture(scope="module")
def setup():
    cfg = get_arch("stablelm-1.6b").reduced()
    key = jax.random.PRNGKey(0)
    params = get_model(cfg).init(key, cfg)
    draft, _ = quantize_tree(key, params, QuantPolicy(cfg=QuantConfig(bits=2)))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(3, 14)))
               for _ in range(5)]
    calib = [rng.integers(0, cfg.vocab, size=(2, MAX_LEN)) for _ in range(2)]
    scales = j_kv_scales(j_collect(cfg, params, calib, qchunks=4))
    port = lambda t: bridge.from_jax_tree(_to_numpy_tree(t),  # noqa: E731
                                          device="cpu")
    return dict(cfg=cfg, jparams=params, jdraft=draft, params=port(params),
                draft=port(draft), prompts=prompts, scales=scales)


BUDGETS = [6, 3, 6, 1, 5]


def _ecfg(kv_mode, spec_k, eos=-1, tokens=6):
    return dict(n_slots=3, max_len=MAX_LEN, max_new_tokens=tokens,
                eos_id=eos, prefill_bucket=8, prefill_chunk=16,
                kv_mode="int8" if kv_mode.startswith("int8") else "fp",
                spec_k=spec_k)


def run_port(s, kv_mode, spec_k, draft=None, eos=-1, budgets=BUDGETS):
    eng = Engine(s["cfg"], s["params"], EngineConfig(**_ecfg(kv_mode, spec_k,
                                                             eos)),
                 device="cpu", draft_params=draft,
                 kv_scales=s["scales"] if kv_mode == "int8-static" else None)
    for p, b in zip(s["prompts"], budgets):
        eng.submit(p, b)
    return [r.out for r in eng.drain()], eng


# ------------------------------------------------------ accept rule ------
def test_accept_length_rule():
    assert accept_length([5, 6, 7], [5, 6, 7, 9], 4) == 3    # all accepted
    assert accept_length([5, 6, 7], [5, 9, 7, 1], 4) == 1    # stop at first
    assert accept_length([5, 6, 7], [1, 6, 7, 1], 4) == 0    # miss
    assert accept_length([5], [9], 1) == 0                   # w=1: non-spec
    assert accept_length([5, 6], [5, 6, 1, 1], 3) == 2


# ------------------------------------- engine-level token identity -------
@pytest.fixture(scope="module")
def jax_spec_runs(setup):
    """The JAX speculative engine over chunked prefill, once per mode."""
    runs = {}

    def get(kv_mode):
        if kv_mode not in runs:
            s = setup
            eng = JEngine(s["cfg"], s["jparams"], JEngineConfig(
                **_ecfg(kv_mode, 3), flight=False, metrics=False),
                draft_params=s["jdraft"],
                kv_scales=s["scales"] if kv_mode == "int8-static" else None)
            for p, b in zip(s["prompts"], BUDGETS):
                eng.submit(p, max_new_tokens=b)
            runs[kv_mode] = ([r.out for r in eng.drain()],
                             eng.sched.spec_proposed, eng.sched.spec_accepted)
        return runs[kv_mode]
    return get


@pytest.mark.parametrize("kv_mode", MODES)
def test_spec_tokens_equal_greedy_and_jax(setup, jax_spec_runs, kv_mode):
    base, _ = run_port(setup, kv_mode, 0)
    spec, eng = run_port(setup, kv_mode, 3, draft=setup["draft"])
    assert spec == base
    j_out, j_prop, j_acc = jax_spec_runs(kv_mode)
    assert spec == j_out
    s = eng.sched
    assert (s.spec_proposed, s.spec_accepted) == (j_prop, j_acc)
    # the INT2 draft was rejected somewhere: rollback ran
    assert eng.n_verify_calls > 0 and s.spec_accepted < s.spec_proposed
    assert sum(s.accept_hist) == s.spec_accepted
    assert len(s.accept_hist) == eng.n_verify_calls
    assert sum(p for p, _ in s.spec_by_slot) == s.spec_proposed
    assert s.acceptance_rate() == s.spec_accepted / s.spec_proposed
    # every token but each request's first came through a verify window
    assert eng.n_spec_commit_tokens == sum(len(o) for o in spec) - len(spec)
    assert eng.n_spec_commit_tokens <= eng.n_verify_tokens


def test_spec_self_draft_accepts_everything(setup):
    base, _ = run_port(setup, "fp", 0)
    spec, eng = run_port(setup, "fp", 3)
    assert spec == base
    assert eng.sched.acceptance_rate() == 1.0
    assert eng.n_spec_steps < sum(len(o) for o in base)


def test_spec_with_eos_mid_window(setup):
    base, _ = run_port(setup, "int8", 0)
    eos = base[0][3]
    base_e, _ = run_port(setup, "int8", 0, eos=eos)
    spec_e, _ = run_port(setup, "int8", 3, eos=eos)
    assert spec_e == base_e
    assert all(eos not in o for o in spec_e)


def test_spec_retire_clears_both_caches(setup):
    _, eng = run_port(setup, "int8", 3, draft=setup["draft"])
    for cache in (eng.cache, eng._spec.cache):
        assert int((cache.kv_pos[:, :, 1:] >= 0).sum()) == 0


# ------------------------------------ verify == sequential decode --------
@pytest.mark.parametrize("kv_mode", MODES)
def test_verify_rows_match_sequential_decode(setup, kv_mode):
    """Each verify row's argmax is the token a plain decode step produces
    from the same prefix, and the verify writes the decode steps' codes
    (an fp cache: the same K/V within fp32 summation order, atol 1e-5)."""
    s, cfg, W = setup, setup["cfg"], 4
    prompt = s["prompts"][0]
    S = len(prompt)
    mode = "fp" if kv_mode == "fp" else "int8"
    scales = s["scales"] if kv_mode == "int8-static" else None

    def fresh():
        cache = tkv.init_slot_cache(cfg, 1, MAX_LEN, mode=mode,
                                    kv_scales=scales, device="cpu")
        lg = tt.prefill_chunk_slots(s["params"], cfg, cache,
                                    torch.from_numpy(prompt[None]), 0, 0, S)
        return cache, int(torch.argmax(lg[0]))

    cache, first = fresh()
    window, seq = [first], []
    for j in range(W):
        lg = tt.decode_step_slots(s["params"], cfg, cache,
                                  torch.tensor([[window[j]]]),
                                  torch.tensor([S + j]))
        seq.append(int(torch.argmax(lg[0, -1])))
        window.append(seq[-1])
    vcache, _ = fresh()
    got = verify_argmax(s["params"], cfg, vcache, torch.tensor([window[:W]]),
                        0, S, W)
    assert got.tolist() == seq
    assert torch.equal(vcache.kv_pos, cache.kv_pos)
    valid = (cache.kv_pos >= 0)[..., None, None]
    for f in ("k", "v"):
        got = torch.where(valid, getattr(vcache, f), 0)
        want = torch.where(valid, getattr(cache, f), 0)
        if mode == "fp":
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        else:
            assert torch.equal(got, want)


# --------------------------------------------- rollback bit-exactness ----
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("prefix,window,accept,extra", [
    (1, 1, 0, 0), (5, 4, 0, 3), (9, 6, 5, 1), (16, 3, 1, 2), (3, 6, 2, 0)])
def test_rollback_then_redecode_bitexact(setup, static, prefix, window,
                                         accept, extra):
    """A cache that wrote a window (true rows up to the accepted point,
    junk after), rolled back and wrote the true continuation holds the
    same codes, scales and kv_pos as one that never speculated."""
    cfg = setup["cfg"]
    L, H, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    scales = setup["scales"] if static else None

    def write(cache, t, seed):
        kv = np.random.default_rng(seed).standard_normal(
            (2, L, 1, 1, H, D)).astype(np.float32)
        for layer in range(L):
            tkv.slot_layer_write(cache, layer, torch.from_numpy(kv[0, layer]),
                                 torch.from_numpy(kv[1, layer]),
                                 torch.tensor([[t]]))

    fresh = lambda: tkv.init_slot_cache(  # noqa: E731
        cfg, 1, 32, mode="int8", kv_scales=scales, device="cpu")
    ref = fresh()
    for t in range(prefix + accept + extra):
        write(ref, t, t)
    spec = fresh()
    for t in range(prefix):
        write(spec, t, t)
    for j in range(window):
        write(spec, prefix + j, prefix + j if j < accept else 7_000 + j)
    tkv.rollback_slot(spec, 0, prefix + accept)
    for j in range(extra):
        write(spec, prefix + accept + j, prefix + accept + j)
    assert torch.equal(spec.kv_pos, ref.kv_pos)
    valid = (ref.kv_pos[:, 0] >= 0)[..., None, None]
    for f in ("k", "v") + (() if static else tkv.SCALE_KEYS):
        assert torch.equal(torch.where(valid, getattr(spec, f)[:, 0], 0),
                           torch.where(valid, getattr(ref, f)[:, 0], 0)), f


def test_rollback_noop_and_full(setup):
    cache = tkv.init_slot_cache(setup["cfg"], 2, 16, mode="int8",
                                device="cpu")
    cache.kv_pos[:, 0, :5] = torch.arange(5, dtype=torch.int32)
    cache.kv_pos[:, 1, :3] = torch.arange(3, dtype=torch.int32)
    before = cache.kv_pos.clone()
    tkv.rollback_slot(cache, 0, 5)
    assert torch.equal(cache.kv_pos, before)
    tkv.rollback_slot(cache, 0, 0)
    assert int(cache.kv_pos[:, 0].max()) == -1
    assert torch.equal(cache.kv_pos[:, 1], before[:, 1])


# -------------------------------------------------- loud failures --------
def test_spec_requires_greedy(setup):
    with pytest.raises(NotImplementedError, match="greedy"):
        Engine(setup["cfg"], setup["params"], EngineConfig(
            n_slots=1, max_len=16, spec_k=2, temperature=0.7), device="cpu")


def test_spec_refuses_other_families():
    from repro_torch.configs import get_arch as t_arch
    with pytest.raises(NotImplementedError, match="spec_k"):
        Engine(t_arch("rwkv6-3b").reduced(), {}, EngineConfig(
            n_slots=1, max_len=16, spec_k=2), device="cpu")


def test_draft_recipe_not_ported(setup, tmp_path, monkeypatch):
    """``draft_recipe`` serves: a recipe pointing at the JAX package's
    INT2 checkpoint of the draft mints, with no k-means, the same draft
    as ``draft_params=``: the same tokens and the same proposed and
    accepted counts, as the JAX engine's."""
    from repro.calib import QuantRecipe as JRecipe
    from repro.checkpoint import ckpt as jck
    import repro_torch.core.splitquant as splitquant_mod

    jck.save(str(tmp_path / "ckpt"), 0, setup["jdraft"])
    JRecipe(arch=setup["cfg"].name, ckpt_dir="ckpt").save(str(tmp_path))

    def boom(*a, **kw):
        raise AssertionError("k-means ran while minting the draft")
    monkeypatch.setattr(splitquant_mod, "kmeans_1d", boom)
    want, weng = run_port(setup, "int8", 3, draft=setup["draft"])
    eng = Engine(setup["cfg"], setup["params"], EngineConfig(
        **_ecfg("int8", 3), draft_recipe=str(tmp_path)), device="cpu")
    for p, b in zip(setup["prompts"], BUDGETS):
        eng.submit(p, b)
    assert [r.out for r in eng.drain()] == want
    assert (eng.sched.spec_proposed, eng.sched.spec_accepted) == \
        (weng.sched.spec_proposed, weng.sched.spec_accepted)
    assert eng.sched.spec_accepted < eng.sched.spec_proposed
