"""Port parity, observability (DESIGN.md §10): the tracer's ring buffer
and exporters, the quality counters, the trace aggregation,
``kv_quality_counters`` and the traced engine, each against the JAX
package on the same inputs; the traces each package writes are read by
the other; ``launch.serve``'s trace and incident flags.

Tolerances: tracer records, Chrome traces, quality and report dicts are
equal (the same fake clock drives both tracers; the quality functions
run the same numpy code). ``kv_quality_counters`` on one cache's arrays:
integer fields identical, float fields within 1e-6 relative. Traced
engines: the (kind, name, uid, slot) sequence of every record is equal
to JAX's and times are left out; tokens are identical traced and
untraced. No test here reads a wall clock.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_arch as j_get_arch
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import FaultSpec as JFaultSpec
from repro.engine import kvcache as jkv
from repro.models import get_model
from repro.obs import quality as jquality

from repro_torch import bridge
from repro_torch import obs as tobs
from repro_torch.configs import get_arch
from repro_torch.engine import Engine, EngineConfig, FaultSpec
from repro_torch.engine import kvcache as tkv
from repro_torch.launch import serve
from repro_torch.obs import quality as tquality

from test_torch_quant import _to_numpy_tree

ROOT = Path(__file__).resolve().parents[1]
MAX_LEN = 48
BUDGETS = [6, 1, 6, 4, 3]
#: the JAX package's chaos spec (tests/test_faults.py)
CHAOS = dict(seed=5, step_exception_rate=0.15, nan_logits_rate=0.10,
             slow_step_rate=0.05, slow_step_s=0.0005, poison_rate=0.25,
             max_faults=60)


class FakeClock:
    """Deterministic monotonic clock: every call advances by ``tick``."""

    def __init__(self, tick=0.001):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _both(fn):
    """fn(obs module) on the port's obs and on JAX's: (port, jax)."""
    return fn(tobs), fn(jobs)


# --------------------------------------------------------------- tracer ---
def test_tracer_disabled_is_falsy_and_records_nothing():
    def run(mod):
        tr = mod.Tracer(enabled=False, clock=FakeClock())
        tr.span_end("decode", tr.begin())
        tr.event("submit", uid=0)
        tr.counter("kv_quality", 1.0)
        return bool(tr), len(tr.events), tr.dropped
    got, want = _both(run)
    assert got == want == (False, 0, 0)


def test_tracer_ring_buffer_drops_oldest():
    def run(mod):
        tr = mod.Tracer(capacity=4, clock=FakeClock())
        for i in range(7):
            tr.event("submit", uid=i)
        return list(tr.events), tr.dropped, tr.header()
    got, want = _both(run)
    assert got == want
    assert [r["uid"] for r in got[0]] == [3, 4, 5, 6] and got[1] == 3
    assert got[2]["dropped"] == 3


def test_tracer_span_fields_and_timebase():
    def run(mod):
        tr = mod.Tracer(clock=FakeClock(tick=0.5))      # t0 = 0.5
        tr.span_end("decode", tr.begin(), slots=3, dispatch_s=0.1,
                    wait_s=0.2)
        return tr.events[0]
    got, want = _both(run)
    assert got == want
    assert got["kind"] == "span" and got["name"] == "decode"
    assert got["ts"] == pytest.approx(0.5) and got["dur"] == \
        pytest.approx(0.5)
    assert got["slots"] == 3 and got["dispatch_s"] == 0.1


def test_tracer_span_contextmanager_records_on_exception():
    def run(mod):
        tr = mod.Tracer(clock=FakeClock())
        with pytest.raises(RuntimeError):
            with tr.span("decode", slot=1):
                raise RuntimeError("boom")
        return list(tr.events)
    got, want = _both(run)
    assert got == want and len(got) == 1 and got[0]["name"] == "decode"


def test_tracer_jsonl_roundtrip_read_by_both_packages(tmp_path):
    """Each package's JSONL is loaded by the other's ``load_jsonl`` and
    validates under both ``validate_events``; the files are the same
    text."""
    def run(mod):
        tr = mod.Tracer(clock=FakeClock(), meta={"arch": "t"})
        tr.event("submit", uid=0, prompt_len=5, budget=8)
        tr.span_end("step", tr.begin())
        tr.counter("kv_quality", {"k_clip_frac": 0.1, "hist": [1, 2]})
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        return tr.to_jsonl(path), path
    (n_t, p_t), (n_j, p_j) = _both(run)
    assert n_t == n_j == 4
    assert open(p_t).read() == open(p_j).read()
    for path in (p_t, p_j):
        for mod in (tobs, jobs):
            recs = mod.load_jsonl(path)
            assert recs[0]["kind"] == "header"
            assert recs[0]["schema"] == tobs.SCHEMA_VERSION
            assert recs[0]["arch"] == "t"
            assert mod.validate_events(recs) == []


def _chrome_records(mod, slots):
    tr = mod.Tracer(clock=FakeClock())
    for s in slots:
        tr.span_end("decode", tr.begin(), slot=s)
    tr.span_end("draft", tr.begin())           # un-slotted -> phase track
    tr.event("submit", uid=0)
    tr.counter("kv_quality", {"k_clip_frac": 0.1, "hist": [1, 2]})
    return mod.chrome_trace(list(tr.records()))


def test_chrome_trace_tracks():
    got, want = _both(lambda mod: _chrome_records(mod, [2]))
    assert got == want
    evs = got["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"decode", "draft"}
    assert next(e for e in xs if e["name"] == "decode")["tid"] == 3
    counter = next(e for e in evs if e["ph"] == "C")
    assert counter["args"] == {"k_clip_frac": 0.1}     # list filtered out
    names = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"slot 2", "requests", "counters", "phase:draft"} <= names


def test_chrome_trace_tid_shift_above_wide_slot_range():
    """Slots >= 59 would alias the fixed tracks: both packages shift the
    non-slot tids above the widest slot, the same way."""
    got, want = _both(lambda mod: _chrome_records(mod, [59, 70]))
    assert got == want
    evs = got["traceEvents"]
    slot_tids = {e["tid"] for e in evs
                 if e["ph"] == "X" and e["args"].get("slot") is not None}
    assert slot_tids == {60, 71}
    other = {next(e["tid"] for e in evs if e["ph"] == p) for p in "iC"}
    assert min(other) > 71 and not slot_tids & other


def test_tracer_ring_wraparound_mixed_kinds(tmp_path):
    def run(mod):
        tr = mod.Tracer(capacity=6, clock=FakeClock())
        for i in range(4):
            tr.span_end("decode", tr.begin(), slot=i % 2, step=i)
            tr.event("submit", uid=i)
            tr.counter("kv_quality", {"k_clip_frac": i / 10})
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        return (list(tr.events), tr.dropped, tr.to_jsonl(path),
                mod.chrome_trace(mod.load_jsonl(path)))
    got, want = _both(run)
    assert got == want
    assert [r["kind"] for r in got[0]] == ["span", "event", "counter"] * 2
    assert got[1] == 6 and got[2] == 7


# -------------------------------------------------------------- quality ---
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quality_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-128, 128, size=(37, 16)).astype(np.int8)
    q[rng.random(q.shape) < 0.1] = 127
    for bits in (8, 4):
        qq = np.clip(q, -(2 ** (bits - 1)), 2 ** (bits - 1) - 1)
        assert tquality.code_stats(qq, bits) == \
            jquality.code_stats(qq, bits)
    assert tquality.code_stats(np.zeros(0, np.int8)) == \
        jquality.code_stats(np.zeros(0, np.int8))
    spans = rng.lognormal(0.0, 1.5, size=200)
    spans[::17] = 0.0
    spans[::23] = np.inf
    ref = rng.lognormal(0.0, 1.0, size=200)
    for args in ((spans,), (spans, ref), (spans, np.array([2.0])),
                 (spans[:0],), (spans, ref[:10])):
        assert tquality.span_stats(*args) == jquality.span_stats(*args)
    scale = rng.random(50) * 100
    scale[::7] = 0.0
    for bits in (8, 4):
        np.testing.assert_array_equal(tquality.scale_to_span(scale, bits),
                                      jquality.scale_to_span(scale, bits))


def test_act_quant_probe_matches_jax():
    rng = np.random.default_rng(4)
    calls = [(rng.integers(-128, 128, size=n).astype(np.int8),
              None if i % 2 else rng.random(5) * 50 + 1)
             for i, n in enumerate((3, 64, 17, 0, 100))]

    def run(mod):
        tr = mod.Tracer(clock=FakeClock())
        probe = mod.ActQuantProbe(tracer=tr, bits=8)
        obs = [probe.observe(q, s, layer=i)
               for i, (q, s) in enumerate(calls)]
        return obs, probe.summary(), list(tr.events)
    got, want = _both(run)
    assert got == want
    assert got[1]["calls"] == 5 and len(got[2]) == 5
    assert tobs.validate_events(
        [{"kind": "header", "schema": 1}] + got[2]) == []


# --------------------------------------------------------------- report ---
def _synthetic_trace(seed):
    """A seeded trace of steps, phases and request lifecycles."""
    rng = np.random.default_rng(seed)
    recs = [{"kind": "header", "schema": 1}]
    t = 0.0
    for step in range(12):
        dur = float(rng.random()) + 0.1
        for name in ("prefill_chunk", "decode", "accept_commit"):
            if rng.random() < 0.7:
                d = float(rng.random()) * dur / 3
                recs.append({"kind": "span", "name": name, "ts": t,
                             "dur": d, "dispatch_s": d * 0.6,
                             "wait_s": d * 0.3})
        recs.append({"kind": "span", "name": "step", "ts": t, "dur": dur})
        t += dur
    for uid in range(6):
        t0 = float(rng.random())
        recs.append({"kind": "event", "name": "submit", "ts": t0,
                     "uid": uid, "prompt_len": 5, "budget": 4})
        if uid < 5:
            recs.append({"kind": "event", "name": "admit",
                         "ts": t0 + 0.1, "uid": uid, "slot": uid % 2})
        if uid < 4:
            recs.append({"kind": "event", "name": "first_token",
                         "ts": t0 + 0.3, "uid": uid, "slot": uid % 2})
            recs.append({"kind": "event", "name": "retire", "ts": t0 + 0.9,
                         "uid": uid, "slot": uid % 2,
                         "reason": ("budget", "eos")[uid % 2],
                         "n_out": 4})
    return recs


@pytest.mark.parametrize("seed", [0, 1])
def test_report_functions_match_jax(seed):
    recs = _synthetic_trace(seed)
    for fn in ("phase_breakdown", "request_waterfalls",
               "lifecycle_summary"):
        assert getattr(tobs, fn)(recs) == getattr(jobs, fn)(recs), fn
    assert tobs.report.spans(recs, "decode") == \
        jobs.report.spans(recs, "decode")
    pb = tobs.phase_breakdown(recs)
    assert pb["steps"] == 12 and "step" not in pb["phases"]
    assert tobs.phase_breakdown([]) == jobs.phase_breakdown([])


# ------------------------------------------------- kv_quality_counters ---
def _caches(static, rows, seed=0):
    """(port cache, JAX cache) on the same arrays: an int8 cache of the
    reduced stablelm shapes with ``rows`` valid rows a (layer, slot)
    prefix and random codes and scales elsewhere (stale bytes)."""
    cfg = get_arch("stablelm-1.6b").reduced()
    rng = np.random.default_rng(seed)
    L, N, T, H, D, C = cfg.n_layers, 3, 16, cfg.n_kv_heads, cfg.head_dim, 4
    arrays = {
        "k": rng.integers(-128, 128, (L, N, T, H, D)).astype(np.int8),
        "v": rng.integers(-128, 128, (L, N, T, H, D)).astype(np.int8)}
    pos = np.full((L, N, T), -1, np.int32)
    for n, r in enumerate(rows):
        pos[:, n, :r] = np.arange(r)
    arrays["kv_pos"] = pos
    sshape = (L, 1, 1, H, C) if static else (L, N, T, H, C)
    for f in ("k_scale", "v_scale"):
        arrays[f] = (rng.lognormal(3.0, 1.0, sshape)).astype(np.float32)
    for f in ("k_zero", "v_zero"):
        arrays[f] = rng.normal(0, 5, sshape).astype(np.float32)
    port = tkv.SlotKVCache(**{k: torch.from_numpy(v.copy())
                              for k, v in arrays.items()},
                           mode="int8", qchunks=C, static=static)
    jc = jkv.SlotKVCache(**{k: jnp.asarray(getattr(port, k).numpy())
                            for k in tkv.CACHE_DATA_FIELDS},
                         mode="int8", qchunks=C, static=static)
    return port, jc


def _assert_counters_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-6), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("rows,max_rows", [
    ((5, 0, 16), 4096), ((5, 0, 16), 7), ((16, 16, 16), 100),
    ((0, 0, 0), 4096)])
def test_kv_quality_counters_match_jax(static, rows, max_rows):
    port, jc = _caches(static, rows)
    got = tkv.kv_quality_counters(port, max_rows=max_rows)
    want = jkv.kv_quality_counters(jc, max_rows=max_rows)
    _assert_counters_equal(got, want)
    assert got["valid_rows"] == port.kv_pos.shape[0] * sum(rows)


def test_kv_quality_counters_ref_scales_match_jax():
    port, jc = _caches(False, (9, 3, 0), seed=2)
    L, H = port.k.shape[0], port.k.shape[3]
    rng = np.random.default_rng(5)
    ref = {f"{n}_scale": rng.lognormal(3.0, 0.5, (L, H, 4))
           for n in ("k", "v")}
    got = tkv.kv_quality_counters(port, max_rows=31, ref_scales=ref)
    want = jkv.kv_quality_counters(jc, max_rows=31, ref_scales=ref)
    _assert_counters_equal(got, want)
    assert got["k_occupancy_vs_ref"] is not None
    got_t = tkv.kv_quality_counters(port, max_rows=31, ref_scales={
        k: torch.from_numpy(v) for k, v in ref.items()})
    _assert_counters_equal(got_t, want)


def test_kv_quality_counters_refuse_a_non_int8_cache():
    cfg = get_arch("stablelm-1.6b").reduced()
    for dtype in (torch.float32, torch.bfloat16):
        fp = tkv.init_slot_cache(cfg, 1, 4, mode="fp", dtype=dtype,
                                 device="cpu")
        with pytest.raises(ValueError, match="int8"):
            tkv.kv_quality_counters(fp)
    with pytest.raises(ValueError, match="int8"):
        jkv.kv_quality_counters(jkv.init_slot_cache(
            j_get_arch("stablelm-1.6b").reduced(), 1, 4, mode="fp"))


# ------------------------------------------------------ traced engines ---
@functools.cache
def workload():
    """(cfg, JAX params, the port's params, prompts): the JAX flight
    tests' workload (reduced stablelm-1.6b, 5 prompts of 3-13 tokens)."""
    jcfg = j_get_arch("stablelm-1.6b").reduced()
    params = get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_jax_tree(_to_numpy_tree(params), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab, size=int(rng.integers(3, 14)))
               for _ in range(5)]
    return get_arch("stablelm-1.6b").reduced(), params, tparams, prompts


CONFIGS = {
    "int8": dict(kv_mode="int8", trace_kv_every=2, metrics_kv_every=2),
    "fp-oneshot": dict(kv_mode="fp", prefill_chunk=0),
    "spec": dict(kv_mode="int8", spec_k=2),
    "chaos-degrade": dict(kv_mode="fp", chaos=True, degrade=True,
                          degrade_thresholds=(1, 2, 3)),
}


def _record_key(r):
    return (r["kind"], r.get("name"), r.get("uid"), r.get("slot"))


def _serve(which, name, trace=True):
    """One drained engine of package ``which`` ("jax" | "port") over the
    workload in configuration ``name``: (engine, [(uid, reason, out)])."""
    cfg, params, tparams, prompts = workload()
    kw = dict(CONFIGS[name])
    chaos = kw.pop("chaos", False)
    if which == "jax":
        Eng, Cfg, p, extra = JEngine, JEngineConfig, params, {}
        spec = JFaultSpec(**CHAOS) if chaos else None
        reg = jobs.MetricsRegistry()
    else:
        Eng, Cfg, p, extra = Engine, EngineConfig, tparams, {"device": "cpu"}
        spec = FaultSpec(**CHAOS) if chaos else None
        reg = tobs.MetricsRegistry()
    eng = Eng(cfg, p, Cfg(n_slots=2, max_len=MAX_LEN, prefill_bucket=8,
                          prefill_chunk=kw.pop("prefill_chunk", 8),
                          trace=trace, fault_spec=spec, **kw),
              clock=FakeClock(), registry=reg, **extra)
    for pr, b in zip(prompts, BUDGETS):
        eng.submit(pr, max_new_tokens=b)
    fin = eng.drain()
    return eng, [(r.uid, r.finish_reason, list(r.out)) for r in fin]


@functools.cache
def _jax_run(name):
    eng, fin = _serve("jax", name)
    return ([_record_key(r) for r in eng.tracer.events],
            [r for r in eng.tracer.events if r["kind"] == "counter"],
            fin, eng.metrics())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_traced_engine_matches_jax(name):
    """The port's traced engine records the same lifecycle events, spans
    and counters, in the same order and with the same uid and slot, as
    JAX's on the same workload; its trace validates; tracing changes no
    token; the phase attribution has JAX's keys and phases."""
    keys, jcounters, jfin, jm = _jax_run(name)
    eng, fin = _serve("port", name)
    assert [_record_key(r) for r in eng.tracer.events] == keys
    assert fin == jfin
    assert tobs.validate_events(list(eng.tracer.records())) == []
    assert jobs.validate_events(list(eng.tracer.records())) == []
    counters = [r for r in eng.tracer.events if r["kind"] == "counter"]
    for c, jc in zip(counters, jcounters):
        assert c["value"].keys() == jc["value"].keys()
        for k in ("valid_rows", "sampled_rows", "static", "qchunks"):
            assert c["value"].get(k) == jc["value"].get(k), k
    _, plain = _serve("port", name, trace=False)
    assert plain == fin
    m = eng.metrics()
    pa, jpa = m["phase_attribution"], jm["phase_attribution"]
    assert pa.keys() == jpa.keys() and pa["phases"].keys() == \
        jpa["phases"].keys()
    assert pa["steps"] == jpa["steps"] == len(eng.step_s)
    assert m["trace_records"] == jm["trace_records"]
    assert m["trace_dropped"] == 0
    if CONFIGS[name].get("metrics_kv_every"):
        for side in ("k", "v"):
            assert f"kv_{side}_clip_frac" in m["registry"]
            assert f"kv_{side}_clip_frac" in jm["registry"]


def test_untraced_engine_has_no_tracer_and_an_explicit_one_wins():
    cfg, _, tparams, prompts = workload()
    eng = Engine(cfg, tparams, EngineConfig(n_slots=2, max_len=MAX_LEN,
                                            prefill_bucket=8),
                 device="cpu", registry=tobs.MetricsRegistry())
    assert eng.tracer is None and eng.sched.tracer is None
    assert "phase_attribution" not in eng.metrics()
    tr = tobs.Tracer(capacity=8, clock=FakeClock())
    eng = Engine(cfg, tparams, EngineConfig(n_slots=2, max_len=MAX_LEN,
                                            prefill_bucket=8),
                 device="cpu", tracer=tr, registry=tobs.MetricsRegistry())
    assert eng.tracer is tr and eng.sched.tracer is tr
    eng.submit(prompts[0], max_new_tokens=3)
    eng.drain()
    assert tr.dropped > 0 and len(tr.events) == 8
    off = tobs.Tracer(enabled=False)
    eng = Engine(cfg, tparams, EngineConfig(n_slots=2, max_len=MAX_LEN,
                                            prefill_bucket=8, trace=True),
                 device="cpu", tracer=off, registry=tobs.MetricsRegistry())
    assert eng.tracer is None


def test_cancel_events_match_jax():
    cfg, params, tparams, prompts = workload()
    keys = []
    for Eng, Cfg, p, extra, mod in (
            (JEngine, JEngineConfig, params, {}, jobs),
            (Engine, EngineConfig, tparams, {"device": "cpu"}, tobs)):
        eng = Eng(cfg, p, Cfg(n_slots=1, max_len=MAX_LEN, prefill_bucket=8,
                              prefill_chunk=8, trace=True),
                  clock=FakeClock(), registry=mod.MetricsRegistry(),
                  **extra)
        for pr in prompts[:3]:
            eng.submit(pr, max_new_tokens=4)
        eng.step()
        assert eng.cancel(2) and eng.cancel(0) and not eng.cancel(0)
        eng.drain()
        keys.append([_record_key(r) for r in eng.tracer.events])
    assert keys[0] == keys[1]
    assert ("event", "cancel", 2, -1) in keys[1]
    assert ("event", "cancel", 0, 0) in keys[1]


# ------------------------------------------------------------ launcher ---
def test_serve_refuses_trace_flags_as_jax_does():
    base = ["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu"]
    for extra in (["--trace-chrome", "x.json"], ["--trace-kv-every", "2"]):
        with pytest.raises(ValueError, match="require --trace"):
            serve.main(base + extra)
    for extra in (["--trace", "t.jsonl"], ["--incident-dir", "inc"]):
        with pytest.raises(NotImplementedError, match="engine features"):
            serve.main(base + ["--wave"] + extra)
        with pytest.raises(NotImplementedError, match="engine features"):
            serve.main(["--arch", "rwkv6-3b", "--reduced", "--device",
                        "cpu"] + extra)


def test_serve_cli_trace_and_incidents(tmp_path):
    """``launch.serve --device cpu`` with a trace, a Chrome trace, KV
    samples, an incident dir and a supervised crash: the trace validates
    under both packages, the Chrome trace loads, the crashed engine's
    ``injected_crash`` bundle and the storm's bundles load under both
    packages, and both ``incident_report --validate`` exit 0 on each."""
    from repro.launch.incident_report import main as j_report
    from repro_torch.launch.incident_report import main as t_report
    t, chrome, inc = (str(tmp_path / n)
                      for n in ("t.jsonl", "t.json", "inc"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "stablelm-1.6b", "--reduced", "--device", "cpu", "--requests", "4",
         "--max-new-tokens", "6", "--trace", t, "--trace-chrome", chrome,
         "--trace-kv-every", "2", "--incident-dir", inc,
         "--faults", "exception=0.2,nan=0.1,crash=0.1,seed=3,max=4",
         "--journal", str(tmp_path / "j.jsonl"), "--snapshot",
         str(tmp_path / "snap"), "--snapshot-every", "2",
         "--supervise", "1"],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "supervisor: engine crashed" in res.stdout
    assert "trace  : phase coverage" in res.stdout
    for mod in (tobs, jobs):
        recs = mod.load_jsonl(t)
        assert mod.validate_events(recs) == []
    assert any(r["kind"] == "counter" for r in tobs.load_jsonl(t))
    assert json.load(open(chrome))["traceEvents"]
    bundles = sorted(os.listdir(inc))
    assert bundles[0] == "incident-000-injected_crash" and len(bundles) >= 2
    for b in bundles:
        path = os.path.join(inc, b)
        for mod in (tobs, jobs):
            trig = mod.load_incident_bundle(path)["trigger.json"]["trigger"]
            assert trig["detector"] in jobs.DETECTORS
        assert t_report([path, "--validate", "--trace", t]) == 0
        assert j_report([path, "--validate"]) == 0
