"""Port parity, fault tolerance (DESIGN.md §12): the fault spec and the
seeded injector, the degradation ladder, admission control and its
overload policies, the trace validator and the metrics registry against
the JAX package on the same inputs; then the engine under a seeded fault
storm, deadlines, cancel, the drain watchdog and the ladder, run by both
packages on reduced stablelm-1.6b (JAX's seeded ``init``, carried over by
the bridge) at the JAX tests' sizes: MAX_LEN 48, 7 prompts of 3-13
tokens.

Tolerances: none. Draw sequences, rungs, shed uids, validator messages,
registry snapshots and Prometheus text are equal; finished lists (uid,
reason, tokens), retry, quarantine and injection counts are equal; the
registry's counters and gauges after an engine run are equal (its
wall-time histograms are not compared).
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_arch as j_get_arch
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import faults as jfaults
from repro.engine import scheduler as jsched
from repro.models import get_model
from repro.obs import metrics as jmetrics
from repro.obs import schema as jschema

from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.engine import (DegradationLadder, Engine, EngineConfig,
                                EngineRequest, FaultInjector, FaultSpec,
                                Scheduler, SubmitError, admission_set_point,
                                occupied_slots)
from repro_torch.engine import faults as tfaults
from repro_torch.engine import scheduler as tsched
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import schema as tschema
from repro_torch.obs.schema import RETIRE_REASONS

from test_torch_quant import _to_numpy_tree

MAX_LEN = 48
NORMAL_REASONS = ("eos", "budget", "max_len", "zero_budget")
BUDGETS = [6, 1, 6, 4, 3, 6, 5]
#: the JAX package's chaos spec (tests/test_faults.py)
CHAOS = dict(seed=5, step_exception_rate=0.15, nan_logits_rate=0.10,
             slow_step_rate=0.05, slow_step_s=0.0005, poison_rate=0.25,
             max_faults=60)
#: histograms of wall time: the only registry entries not compared
WALL_HISTOGRAMS = ("engine_step_seconds", "engine_decode_step_seconds",
                   "sched_admit_latency_seconds", "spec_draft_pass_seconds",
                   "engine_restore_duration_s")


@functools.cache
def workload():
    """(cfg, JAX params, the port's params, prompts, static scales as
    numpy): the JAX fixtures' workload."""
    from repro.calib import collect_kv_stats, kv_static_scales
    jcfg = j_get_arch("stablelm-1.6b").reduced()
    params = get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_jax_tree(_to_numpy_tree(params), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab, size=int(rng.integers(3, 14)))
               for _ in range(7)]
    rng = np.random.default_rng(0)
    calib = [rng.integers(0, jcfg.vocab, size=(4, MAX_LEN))
             for _ in range(4)]
    scales = {k: np.asarray(v) for k, v in kv_static_scales(
        collect_kv_stats(jcfg, params, calib, qchunks=4)).items()}
    return get_arch("stablelm-1.6b").reduced(), params, tparams, prompts, \
        scales


def registry_values(snap: dict) -> dict:
    return {k: v for k, v in snap.items() if k not in WALL_HISTOGRAMS}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ======================================================= spec / injector
@pytest.mark.parametrize("spec", [
    "exception=0.1,nan=0.05,seed=3,max=7,slow=0.2,slow_s=0.001,poison=0.5",
    "crash=0.25,crash_kill=1,seed=2,max=1", "crash=0.1", "", " seed=4 , ",
    "bogus=1", "exception"])
def test_fault_spec_parse_matches_jax(spec):
    try:
        want = jfaults.FaultSpec.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            FaultSpec.parse(spec)
        assert str(got.value) == str(e)
        return
    got = FaultSpec.parse(spec)
    assert got.__dict__ == want.__dict__


def _storm(mod, spec_kw):
    inj = mod.FaultInjector(mod.FaultSpec(**spec_kw))
    marks = [inj.note_submit(u) for u in range(8)]
    out = []
    toks = np.arange(4, dtype=np.int64)
    for i in range(40):
        if i % 4 == 0:
            out.append(("crash", inj.draw_crash()))
        out.append(("step", inj.draw_step()))
        if i % 3 == 0:
            out.append(("tok", inj.corrupt_tokens(
                toks, [0, 1, 2, 3], {s: s for s in range(4)}).tolist(),
                list(inj.last_corrupted_uids)))
    return marks, out, inj.counts(), sorted(inj.poison_uids), \
        inj.injected_total()


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_injector_draws_match_jax(seed):
    """The same spec draws the same storm in both packages: poison marks,
    step faults, crashes, corrupted tokens and their victims, in order,
    with and without a fault budget."""
    for kw in (dict(step_exception_rate=0.3, slow_step_rate=0.2,
                    nan_logits_rate=0.5, poison_rate=0.4, crash_rate=0.1),
               dict(step_exception_rate=0.5, nan_logits_rate=0.3,
                    crash_rate=0.2, max_faults=9)):
        want = _storm(jfaults, dict(kw, seed=seed))
        assert _storm(tfaults, dict(kw, seed=seed)) == want
    assert tfaults.POISON_TOKEN == jfaults.POISON_TOKEN


def test_crash_draw_preserves_other_streams():
    """crash_rate=0 consumes no draw: adding the crash class cannot move
    the seeded streams of other specs."""
    a = FaultInjector(FaultSpec(seed=5, step_exception_rate=0.3,
                                max_faults=100))
    b = FaultInjector(FaultSpec(seed=5, step_exception_rate=0.3,
                                max_faults=100, crash_rate=0.0))
    draws_b = []
    for _ in range(20):
        assert b.draw_crash() is False
        draws_b.append(b.draw_step())
    assert [a.draw_step() for _ in range(20)] == draws_b


@pytest.mark.parametrize("thresholds,patience", [
    ((2, 4, 8), 2), ((1, 2, 3), 1), ((3, 5, 9), 3)])
def test_ladder_matches_jax(thresholds, patience):
    rng = np.random.default_rng(sum(thresholds))
    pressure = np.concatenate([rng.integers(0, 12, 60),
                               np.zeros(12, np.int64)]).tolist()
    j = jfaults.DegradationLadder(thresholds, patience=patience)
    t = DegradationLadder(thresholds, patience=patience)
    assert [t.update(p) for p in pressure] == \
        [j.update(p) for p in pressure]
    assert t.n_transitions == j.n_transitions > 0
    for bad in ((3, 2, 1), (1, 1, 2), (1, 2)):
        with pytest.raises(ValueError) as e:
            DegradationLadder(bad)
        with pytest.raises(ValueError) as w:
            jfaults.DegradationLadder(bad)
        assert str(e.value) == str(w.value)


# ===================================================== admission control
def _sched_run(mod, req_cls, policy, max_queue, classes):
    s = mod.Scheduler(n_slots=1, clock=lambda: 0.0, max_queue=max_queue,
                      overload_policy=policy)
    for u, c in enumerate(classes):
        s.submit(req_cls(uid=u, prompt=[0], max_new_tokens=4, cls=c))
    return ([r.uid for r in s.queue],
            [(r.uid, r.finish_reason) for r in s.finished], s.n_shed)


@pytest.mark.parametrize("policy", ["reject-new", "shed-oldest",
                                    "shed-by-class"])
@pytest.mark.parametrize("max_queue", [0, 2, 3])
def test_overload_policies_match_jax(policy, max_queue):
    classes = ["interactive", "batch", "batch", "interactive",
               "interactive", None, "batch", "interactive"]
    want = _sched_run(jsched, jsched.EngineRequest, policy, max_queue,
                      classes)
    assert _sched_run(tsched, EngineRequest, policy, max_queue,
                      classes) == want
    with pytest.raises(ValueError):
        Scheduler(n_slots=1, overload_policy="drop-all")


def test_shed_queued_to_and_defer_match_jax():
    def run(mod, req_cls):
        s = mod.Scheduler(n_slots=2, clock=lambda: 0.0)
        for u, c in enumerate(["interactive", "batch", "interactive",
                               "batch", "batch", "interactive"]):
            s.submit(req_cls(uid=u, prompt=[0], cls=c))
        placed = [r.uid for _, r in s.admit(defer=("batch",))]
        n = s.shed_queued_to(1)
        rest = [r.uid for _, r in s.admit()]
        return placed, n, [r.uid for r in s.queue], rest, \
            sorted(r.uid for r in s.finished)
    assert run(tsched, EngineRequest) == run(jsched, jsched.EngineRequest)


@pytest.mark.parametrize("ol", [
    {"knee": {"last_ok_offered_rps": 14.0},
     "points": [{"offered_rps": 7.0, "queue_depth_at_submit_p95": 1.0},
                {"offered_rps": 14.0, "queue_depth_at_submit_p95": 3.2}]},
    None, {"knee": None, "points": []},
    {"knee": {"last_ok_offered_rps": None}},
    {"knee": {"last_ok_offered_rps": 2.0}, "points": [{"offered_rps": 2.0}]},
])
def test_admission_set_point_matches_jax(ol):
    for kw in ({}, {"slack": 1.0}, {"slack": 0.1, "floor": 2}):
        assert admission_set_point(ol, **kw) == \
            jsched.admission_set_point(ol, **kw)


# ===================================================== schema + registry
def test_validate_events_matches_jax():
    good = [{"kind": "header", "schema": 1, "journal": True},
            {"kind": "event", "name": "submit", "ts": 0.1, "uid": 0},
            {"kind": "event", "name": "retire", "ts": 0.2, "uid": 0,
             "reason": "failed"},
            {"kind": "event", "name": "snapshot", "ts": 0.3, "step": 2},
            {"kind": "span", "name": "decode", "ts": 0.4, "dur": 0.01,
             "dispatch_s": 0.001},
            {"kind": "counter", "name": "kv", "ts": 0.5,
             "value": {"a": 1, "b": None, "c": [1]}}]
    broken = [[], [{"kind": "event", "name": "submit", "ts": 0}],
              [{"kind": "header", "schema": 2}],
              good[:1] + [{"kind": "event", "name": "retire", "ts": 1,
                           "uid": 3, "reason": "boom"}],
              good[:1] + [{"kind": "event", "name": "admit", "ts": -1,
                           "uid": "x"}],
              good[:1] + [{"kind": "span", "name": "nope", "ts": 0,
                           "dur": -1, "wait_s": -2}],
              good[:1] + [{"kind": "mystery"}, good[0]],
              good[:1] + [{"kind": "counter", "name": "c", "ts": 0,
                           "value": {"a": {}}}]]
    assert tschema.validate_events(good) == [] == \
        jschema.validate_events(good)
    for recs in broken:
        got = tschema.validate_events(recs)
        assert got and got == jschema.validate_events(recs)
    assert (tschema.PHASES, tschema.LIFECYCLE, tschema.RETIRE_REASONS,
            tschema.KINDS) == (jschema.PHASES, jschema.LIFECYCLE,
                               jschema.RETIRE_REASONS, jschema.KINDS)


def _registry_calls(mod):
    r = mod.MetricsRegistry()
    c = r.counter("requests", "all requests")
    c.inc()
    c.inc(2.5)
    g = r.gauge("depth", "queue depth")
    r.gauge("unset", "never set")
    g.set(3)
    g.dec(0.5)
    h = r.histogram("lat_s", "latency")
    for v in (5e-5, 1e-3, 0.3, 0.3, 42.0):
        h.observe(v)
    d = r.histogram("depth_hist", buckets=mod.DEPTH_BUCKETS)
    for v in (0, 1, 3, 300):
        d.observe(v)
    rs = r.histogram("restore", buckets=mod.RESTORE_BUCKETS_S)
    rs.observe(0.2)
    assert r.counter("requests") is c
    with pytest.raises(TypeError):
        r.gauge("requests")
    with pytest.raises(ValueError):
        c.inc(-1)
    return (r.snapshot(), r.to_prometheus(), r.names(), len(r),
            [h.percentile(q) for q in (0, 50, 95, 100)],
            mod.LATENCY_BUCKETS_S, mod.DEPTH_BUCKETS, mod.RESTORE_BUCKETS_S)


def test_registry_matches_jax():
    assert _registry_calls(tmetrics) == _registry_calls(jmetrics)
    assert tmetrics.default_registry() is tmetrics.default_registry()


# ============================================================ the engine
def _ecfg(mod, **kw):
    base = dict(n_slots=3, max_len=MAX_LEN, prefill_bucket=8,
                prefill_chunk=8)
    base.update(kw)
    if mod is JEngineConfig:
        base["flight"] = False
    return mod(**base)


def _run_pair(kv_mode, fault=None, budgets=BUDGETS, **kw):
    """(JAX engine, its finished list; port engine, its finished list) for
    one configuration over the workload, each drained."""
    cfg, params, tparams, prompts, scales = workload()
    mode = "int8" if kv_mode.startswith("int8") else "fp"
    sc = scales if kv_mode == "int8-static" else None
    out = []
    for Eng, Cfg, p, spec_mod, extra in (
            (JEngine, JEngineConfig, params, jfaults, {}),
            (Engine, EngineConfig, tparams, tfaults, {"device": "cpu"})):
        fs = spec_mod.FaultSpec(**fault) if fault else None
        eng = Eng(cfg, p, _ecfg(Cfg, kv_mode=mode, fault_spec=fs, **kw),
                  kv_scales=sc, **extra)
        for pr, b in zip(prompts, budgets):
            eng.submit(pr, max_new_tokens=b)
        out += [eng, [(r.uid, r.finish_reason, list(r.out))
                      for r in eng.drain()]]
    return out


@functools.cache
def _unfaulted(kv_mode):
    return _run_pair(kv_mode)[1]


@pytest.mark.parametrize("kv_mode", ["fp", "int8", "int8-static"])
def test_chaos_matches_jax(kv_mode):
    """Under the JAX package's chaos spec both engines finish the same
    list — uid, reason and tokens — with the same retries, quarantines
    and injected faults; the port's survivors equal its unfaulted run, it
    leaks no slot, and its registry equals JAX's."""
    jeng, jfin, teng, tfin = _run_pair(kv_mode, fault=CHAOS)
    assert tfin == jfin
    assert sorted(u for u, _, _ in tfin) == list(range(7))
    assert all(r in RETIRE_REASONS for _, r, _ in tfin)
    jm, tm = jeng.metrics(), teng.metrics()
    for k in ("step_retries", "quarantined", "faults_injected",
              "retire_reasons", "decode_steps", "prefill_chunks"):
        assert tm[k] == jm[k], k
    assert tm["step_retries"] > 0 and tm["quarantined"] > 0
    assert registry_values(tm["registry"]) == \
        registry_values(jm["registry"])
    ref = {u: out for u, _, out in _unfaulted(kv_mode)}
    survivors = [(u, out) for u, r, out in tfin if r in NORMAL_REASONS]
    assert survivors and all(out == ref[u] for u, out in survivors)
    probe = FaultInjector(FaultSpec(**CHAOS))
    poisoned = [u for u in range(7) if probe.note_submit(u)]
    assert poisoned and {u for u in poisoned if BUDGETS[u] > 1} <= \
        {u for u, r, _ in tfin if r == "failed"}
    assert teng.sched.idle and not teng.sched.prefill_slots()
    assert occupied_slots(teng.cache) == []


def test_poisoned_requests_quarantined_match_jax():
    """poison_rate=1: every request corrupts every attempt; all end
    "failed" after max_retries=1, as in JAX, and nothing leaks."""
    jeng, jfin, teng, tfin = _run_pair(
        "fp", fault=dict(seed=0, poison_rate=1.0), budgets=[6, 6, 6],
        max_retries=1, n_slots=2)
    assert tfin == jfin
    assert [r for _, r, _ in tfin] == ["failed"] * 3
    assert teng.metrics()["quarantined"] == jeng.metrics()["quarantined"]
    assert occupied_slots(teng.cache) == []


def test_submit_validation():
    cfg, _, tparams, prompts, _ = workload()
    eng = Engine(cfg, tparams, _ecfg(EngineConfig, n_slots=2), device="cpu")
    for prompt, budget, code in ((np.zeros(0, np.int64), 4, "empty_prompt"),
                                 (prompts[0], -1, "bad_budget"),
                                 (prompts[0], MAX_LEN, "too_long")):
        with pytest.raises(SubmitError) as e:
            eng.submit(prompt, max_new_tokens=budget)
        assert e.value.code == code
    assert eng.sched.n_submitted == 0 and not eng.sched.queue
    eng.submit(prompts[0], max_new_tokens=4)
    assert len(eng.drain()) == 1


def _finished(eng):
    return [(r.uid, r.finish_reason, list(r.out))
            for r in sorted(eng.sched.finished, key=lambda r: r.uid)]


def _both(**kw):
    cfg, params, tparams, prompts, _ = workload()
    clocks = (FakeClock(), FakeClock())
    engs = (JEngine(cfg, params, _ecfg(JEngineConfig, **kw),
                    clock=clocks[0]),
            Engine(cfg, tparams, _ecfg(EngineConfig, **kw), device="cpu",
                   clock=clocks[1]))
    return engs, clocks, prompts


def test_cancel_queued_and_slotted_match_jax():
    (j, t), _, prompts = _both(n_slots=2, max_new_tokens=8, prefill_chunk=0)
    res = []
    for eng in (j, t):
        uids = [eng.submit(p) for p in prompts[:5]]
        eng.step()                      # uids 0, 1 slotted; 2-4 queued
        res.append([eng.cancel(uids[3]), eng.cancel(uids[0]),
                    eng.cancel(999), eng.cancel(uids[3])])
        eng.drain()
    assert res[1] == res[0] == [True, True, False, False]
    assert _finished(t) == _finished(j)
    assert t.metrics()["requests_cancelled"] == 2
    assert registry_values(t.registry.snapshot()) == \
        registry_values(j.registry.snapshot())
    assert occupied_slots(t.cache) == []


def test_cancel_mid_chunked_prefill_matches_jax():
    """Cancelling a slot mid-chunked-prefill frees the slot, its cache
    rows and the prefill bookkeeping; the freed slot serves new work."""
    (j, t), _, prompts = _both(n_slots=2, max_new_tokens=8)
    long_prompt = np.random.default_rng(9).integers(0, 512, size=40)
    for eng in (j, t):
        eng.submit(prompts[1])
        uid = eng.submit(long_prompt)
        eng.step()
        assert eng.sched.prefill_slots(), "precondition: mid-prefill"
        slot = eng.sched.prefill_slots()[0]
        assert eng.cancel(uid) is True
        assert not eng.sched.prefill_slots()
        assert eng.sched.slots[slot] is None
        eng.submit(prompts[0], max_new_tokens=4)
        eng.drain()
    assert _finished(t) == _finished(j)
    assert _finished(t)[1][1] == "cancelled"
    assert occupied_slots(t.cache) == []


def test_deadlines_match_jax():
    """Total deadline of a slotted request, TTFT deadline of a queued one
    (a fake clock), in both packages."""
    (j, t), clocks, prompts = _both(n_slots=1, max_new_tokens=12)
    for eng, clk in zip((j, t), clocks):
        eng.submit(prompts[0], ttft_deadline_s=2.0)     # first token in time
        eng.submit(prompts[1], ttft_deadline_s=2.0)     # waits in the queue
        eng.submit(prompts[2], deadline_s=5.0)
        eng.step()
        clk.t = 3.0
        eng.step()
        clk.t = 9.0
        eng.drain()
    assert _finished(t) == _finished(j)
    assert [r for _, r, _ in _finished(t)] == \
        ["budget", "deadline_exceeded", "deadline_exceeded"]
    assert t.metrics()["retire_reasons"] == j.metrics()["retire_reasons"]
    assert registry_values(t.registry.snapshot()) == \
        registry_values(j.registry.snapshot())


def test_drain_watchdog_stall_and_timeout():
    cfg, _, tparams, prompts, _ = workload()
    eng = Engine(cfg, tparams, _ecfg(EngineConfig, n_slots=2), device="cpu")
    uids = [eng.submit(p, max_new_tokens=4) for p in prompts[:3]]
    eng.step = lambda: []                           # wedged engine
    fin = eng.drain(stall_steps=3)
    assert sorted(r.uid for r in fin) == uids
    assert all(r.finish_reason == "failed" for r in fin)
    assert eng.sched.idle and occupied_slots(eng.cache) == []
    clk = FakeClock()
    eng = Engine(cfg, tparams, _ecfg(EngineConfig, n_slots=2), device="cpu",
                 clock=clk)
    uid = eng.submit(prompts[0], max_new_tokens=4)

    def wedged_step():
        clk.t += 1.0
        return []

    eng.step = wedged_step
    fin = eng.drain(timeout_s=2.5)
    assert [(r.uid, r.finish_reason) for r in fin] == [(uid, "failed")]


def test_degrade_ladder_matches_jax():
    """The speculative engine pushed through the whole ladder (spec off,
    defer batch, shed): the same finished list, rung transitions,
    suspended spec steps and registry as JAX, and its normal finishes
    equal the ladder-free run's."""
    cfg, params, tparams, prompts, _ = workload()
    budgets = [6, 4, 6, 3, 6, 4, 5]

    def run(Eng, Cfg, p, degrade, **extra):
        eng = Eng(cfg, p, _ecfg(Cfg, n_slots=2, prefill_chunk=96,
                                spec_k=2, degrade=degrade,
                                degrade_thresholds=(1, 2, 3),
                                degrade_patience=1), draft_params=p, **extra)
        for i, (pr, b) in enumerate(zip(prompts, budgets)):
            eng.submit(pr, max_new_tokens=b,
                       cls="batch" if i % 2 else "interactive")
        return eng, _finished_after(eng)

    def _finished_after(eng):
        eng.drain()
        return _finished(eng)

    j, jfin = run(JEngine, JEngineConfig, params, True)
    t, tfin = run(Engine, EngineConfig, tparams, True, device="cpu")
    assert tfin == jfin
    jm, tm = j.metrics(), t.metrics()
    for k in ("degradation_transitions", "requests_shed",
              "spec_suspended_steps", "spec_steps", "verify_calls",
              "draft_steps", "draft_proposed", "draft_accepted",
              "accept_hist", "acceptance_ewma"):
        assert tm[k] == jm[k], k
    assert tm["degradation_transitions"] > 0 and tm["requests_shed"] > 0
    assert tm["spec_suspended_steps"] > 0
    assert registry_values(tm["registry"]) == \
        registry_values(jm["registry"])
    _, base = run(Engine, EngineConfig, tparams, False, device="cpu")
    base = {u: out for u, _, out in base}
    assert all(out == base[u] for u, r, out in tfin if r in NORMAL_REASONS)
    assert occupied_slots(t.cache) == [] == occupied_slots(t._spec.cache)


def test_robustness_metrics_exported():
    """The §12 counters reach the Prometheus text (the rung gauge even at
    rung 0), with JAX's values."""
    (j, t), clocks, prompts = _both(n_slots=1, max_new_tokens=4,
                                    prefill_chunk=96, max_queue=2,
                                    degrade=True)
    for eng, clk in zip((j, t), clocks):
        uids = [eng.submit(p, deadline_s=50.0) for p in prompts[:4]]
        eng.step()
        eng.cancel(uids[1])
        clk.t = 100.0
        eng.step()
        eng.drain()
    text = t.registry.to_prometheus()
    for name in ("repro_sched_requests_shed_total",
                 "repro_sched_requests_cancelled_total",
                 "repro_engine_deadline_exceeded_total",
                 "repro_engine_step_retries_total",
                 "repro_engine_degradation_rung"):
        assert name in text, name
    snap = t.registry.snapshot()
    assert snap["sched_requests_shed"] >= 1
    assert snap["sched_requests_cancelled"] == 1
    assert snap["engine_deadline_exceeded"] >= 1
    assert snap["engine_degradation_rung"] == 0
    assert registry_values(snap) == registry_values(j.registry.snapshot())
    assert _finished(t) == _finished(j)


def test_metrics_off_and_shared_registry():
    """metrics=False leaves the engine without a registry; an explicit
    registry is shared (counts add up across engines)."""
    cfg, _, tparams, prompts, _ = workload()
    eng = Engine(cfg, tparams, _ecfg(EngineConfig, metrics=False),
                 device="cpu")
    eng.submit(prompts[0], max_new_tokens=2)
    eng.drain()
    assert eng.registry is None and "registry" not in eng.metrics()
    reg = tmetrics.MetricsRegistry()
    for _ in range(2):
        eng = Engine(cfg, tparams, _ecfg(EngineConfig, metrics=False),
                     device="cpu", registry=reg)
        eng.submit(prompts[0], max_new_tokens=2)
        eng.drain()
    assert reg.snapshot()["sched_requests_retired"] == 2
    with pytest.raises(NotImplementedError, match="spec_k=0"):
        Engine(cfg, tparams, _ecfg(EngineConfig, spec_k=2,
                                   fault_spec=FaultSpec(seed=0)),
               device="cpu")
