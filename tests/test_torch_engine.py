"""Port parity, engine side: the port's continuous-batching engine gives
greedy tokens identical to the JAX ``Engine`` on one seeded
mixed-length workload, for fp and int8 KV caches and for prefill chunks
of 96 (prompts fit one chunk) and 7 (every prompt spans chunks, and
decode runs while later prompts stream in). Weights: the JAX package's
INT4 SplitQuant quantization, carried over by the bridge. Also the
engine's device policy and the scheduler's lifecycle.
"""
import jax
import numpy as np
import pytest
import torch

from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig

from repro_torch.engine import (Engine, EngineConfig, EngineRequest,
                                Scheduler, SubmitError)

from test_torch_models import quantized_pair

CONFIGS = [(kv, chunk) for kv in ("fp", "int8") for chunk in (96, 7)]
N_SLOTS, MAX_LEN, NEW = 3, 64, 6


@pytest.fixture(scope="module")
def workload():
    cfg, jparams, tparams = quantized_pair("stablelm-1.6b")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(3, 41)))
               for _ in range(7)]
    return cfg, jparams, tparams, prompts


@pytest.fixture(scope="module")
def jax_runs(workload):
    """One JAX engine run per (kv mode, chunk), built once per module."""
    cfg, jparams, _, prompts = workload
    runs = {}

    def get(kv_mode, chunk):
        if (kv_mode, chunk) not in runs:
            eng = JEngine(cfg, jparams, JEngineConfig(
                n_slots=N_SLOTS, max_len=MAX_LEN, max_new_tokens=NEW,
                kv_mode=kv_mode, prefill_chunk=chunk, flight=False,
                metrics=False))
            for p in prompts:
                eng.submit(p)
            runs[(kv_mode, chunk)] = [r.out for r in eng.drain()]
        return runs[(kv_mode, chunk)]
    return get


@pytest.mark.parametrize("kv_mode,chunk", CONFIGS)
def test_engine_greedy_tokens_match_jax(workload, jax_runs, kv_mode, chunk):
    cfg, _, tparams, prompts = workload
    eng = Engine(cfg, tparams, EngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, max_new_tokens=NEW,
        kv_mode=kv_mode, prefill_chunk=chunk), device="cpu")
    for p in prompts:
        eng.submit(p)
    fin = eng.drain()
    assert [r.finish_reason for r in fin] == ["budget"] * len(prompts)
    assert [r.out for r in fin] == jax_runs(kv_mode, chunk)
    assert all(r.t_first_token is not None for r in fin)
    # every slot retired: no row of the cache is still marked valid
    # beyond the idle ride-along mark at row 0
    assert int((eng.cache.kv_pos[:, :, 1:] >= 0).sum()) == 0


def test_engine_stops_at_eos(workload):
    """A request whose next token is eos_id retires with reason "eos"
    and without emitting it; the others are untouched."""
    cfg, _, tparams, prompts = workload

    def run(eos_id):
        eng = Engine(cfg, tparams, EngineConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, max_new_tokens=NEW,
            eos_id=eos_id, prefill_chunk=7), device="cpu")
        for p in prompts[:4]:
            eng.submit(p)
        return eng.drain()

    base = run(-1)
    eos = base[1].out[2]
    fin = run(eos)
    for r, b in zip(fin, base):
        if eos in b.out:
            cut = b.out.index(eos)
            assert r.out == b.out[:cut] and r.finish_reason == "eos"
        else:
            assert r.out == b.out and r.finish_reason == "budget"


def test_engine_needs_card_or_explicit_cpu(workload):
    cfg, _, tparams, _ = workload
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, tparams, EngineConfig(n_slots=1, max_len=32))


def test_submit_validation(workload):
    cfg, _, tparams, _ = workload
    eng = Engine(cfg, tparams, EngineConfig(n_slots=1, max_len=16),
                 device="cpu")
    for prompt, budget, code in (([], 4, "empty_prompt"),
                                 ([1, 2], -1, "bad_budget"),
                                 ([1] * 12, 8, "too_long")):
        with pytest.raises(SubmitError) as e:
            eng.submit(prompt, budget)
        assert e.value.code == code
    uid = eng.submit([1, 2, 3], 0)
    (req,) = eng.drain()
    assert req.uid == uid and req.out == [] \
        and req.finish_reason == "zero_budget"


def test_scheduler_fcfs_and_prefill_states():
    s = Scheduler(n_slots=2, clock=lambda: 0.0)
    reqs = [s.submit(EngineRequest(uid=i, prompt=[0])) for i in range(4)]
    placed = s.admit()
    assert [(slot, r.uid) for slot, r in placed] == [(0, 0), (1, 1)]
    s.begin_prefill(1)
    assert s.active_slots() == [0] and s.prefill_slots() == [1]
    s.finish_prefill(1)
    assert s.active_slots() == [0, 1]
    s.retire(0, "budget")
    assert reqs[0].done and reqs[0].finish_reason == "budget"
    assert [(slot, r.uid) for slot, r in s.admit()] == [(0, 2)]
    assert not s.idle
