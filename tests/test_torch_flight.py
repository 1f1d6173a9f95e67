"""Port parity, the flight recorder, anomaly detectors and incident
bundles (DESIGN.md §14): the ring, the detector catalog on synthetic
record streams, the bundle format (each package loads and validates the
other's bundles), and the engine integrations of the JAX package's
``tests/test_flight.py`` run by both packages side by side on reduced
stablelm-1.6b (JAX's seeded ``init``, carried over by the bridge).

Tolerances: none. Flight records are equal field for field except the
time fields (``ts``, ``step_s``, ``decode_s``, ``draft_s``); firings,
bundle names and triggers are equal. The wall-clock detector is driven by
a fake engine clock, never by the host's clock.
"""
import functools
import json
import os

import jax
import numpy as np
import pytest

from repro import obs as jobs
from repro.configs import get_arch as j_get_arch
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import FaultSpec as JFaultSpec
from repro.engine import InjectedCrash as JInjectedCrash
from repro.launch.incident_report import main as j_report
from repro.models import get_model
from repro.obs import detect as jdetect
from repro.obs import flight as jflight

from repro_torch import bridge
from repro_torch import obs as tobs
from repro_torch.configs import get_arch
from repro_torch.engine import (Engine, EngineConfig, FaultSpec,
                                InjectedCrash, IntegrityError)
from repro_torch.launch.incident_report import main as t_report
from repro_torch.obs import detect as tdetect
from repro_torch.obs import flight as tflight

from test_torch_quant import _to_numpy_tree

MAX_LEN = 48
TIME_FIELDS = ("ts", "step_s", "decode_s", "draft_s")
#: the JAX package's chaos spec (tests/test_faults.py)
CHAOS = dict(seed=5, step_exception_rate=0.15, nan_logits_rate=0.10,
             slow_step_rate=0.05, slow_step_s=0.0005, poison_rate=0.25,
             max_faults=60)


class FakeClock:
    def __init__(self, tick=0.001):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


# ====================================================== flight recorder
def test_flight_ring_matches_jax():
    def run(mod):
        fr = mod.FlightRecorder(capacity=4, clock=FakeClock(),
                                meta={"arch": "t"})
        recs = [fr.record(step=i, step_s=0.01, uids=[i]) for i in range(7)]
        return recs, fr.window(), fr.header(), fr.dropped
    got, want = run(tflight), run(jflight)
    assert got == want
    assert [r["step"] for r in got[1]] == [3, 4, 5, 6] and got[3] == 3
    assert got[2]["recorded"] == 7 and got[2]["capacity"] == 4
    assert tflight.FLIGHT_SCHEMA == jflight.FLIGHT_SCHEMA
    assert tflight.BUNDLE_SCHEMA == jflight.BUNDLE_SCHEMA
    assert tflight.BUNDLE_FILES == jflight.BUNDLE_FILES
    for mod in (tflight, jflight):
        with pytest.raises(ValueError):
            mod.FlightRecorder(capacity=0)


def test_tail_lines_matches_jax(tmp_path):
    p = str(tmp_path / "j.jsonl")
    with open(p, "w") as f:
        f.writelines(f"line{i}\n" for i in range(10))
    for n in (3, 0, 20, -1):
        assert tflight.tail_lines(p, n) == jflight.tail_lines(p, n)
    assert tflight.tail_lines(p, 3) == ["line7", "line8", "line9"]
    assert tflight.tail_lines(str(tmp_path / "absent")) == []


# ==================================================== anomaly detectors
def _sweep_all(mod, stream, notes=(), **kw):
    """Firings (as dicts) of ``mod``'s detector over a record stream;
    ``notes``: (index, detector, fields) posted before record ``index``."""
    det = mod.AnomalyDetector(**kw)
    out = []
    for i, rec in enumerate(stream):
        for j, name, fields in notes:
            if j == i:
                det.note(name, **fields)
        out.append([f.to_dict() for f in det.sweep(rec)])
    out.append([f.to_dict() for f in det.drain()])
    return out, det.n_fired


def _random_stream(seed, n=200):
    rng = np.random.default_rng(seed)
    stream = []
    for step in range(n):
        rec = {"step": step,
               "step_s": float(rng.lognormal(-4, 1.2)),
               "queue": int(rng.integers(0, 12)),
               "rung": int(rng.integers(0, 4)) if rng.random() < 0.3 else 0}
        if rng.random() < 0.5:
            rec["accept"] = float(rng.random())
        if rng.random() < 0.3:
            rec["clip_frac"] = float(rng.random() * 0.7)
        stream.append(rec)
    return stream


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("cooldown", [1, 7, 50])
def test_detectors_match_jax_on_seeded_streams(seed, cooldown):
    stream = _random_stream(seed)
    notes = [(i, ("step_retry", "quarantine", "integrity_error")[i % 3],
              {"reason": f"r{i}", "uid": i % 5})
             for i in range(0, 200, 13)]
    kw = dict(cooldown_steps=cooldown, queue_set_point=8)
    got = _sweep_all(tdetect, stream, notes, **kw)
    assert got == _sweep_all(jdetect, stream, notes, **kw)
    fired = {f["detector"] for batch in got[0] for f in batch}
    assert {"step_latency_spike", "queue_runaway", "rung_ascent",
            "kv_clip_spike", "step_retry"} <= fired


def test_detector_units_match_jax():
    """The JAX unit cases: latency warm-up and cooldown, the derived
    detectors, the clip jump, posted events and drain."""
    lat = [{"step": 0, "step_s": 5.0}] + \
        [{"step": s, "step_s": 0.01} for s in range(1, 4)] + \
        [{"step": 4, "step_s": 50.0}, {"step": 5, "step_s": 500.0}] + \
        [{"step": s, "step_s": 0.01} for s in range(6, 9)] + \
        [{"step": 9, "step_s": 500.0}]
    derived = [{"step": 0, "rung": 2, "queue": 6},
               {"step": 1, "rung": 0, "queue": 2},
               {"step": 2, "accept": 0.1}, {"step": 3, "accept": 0.9},
               {"step": 4, "accept": 0.05}, {"step": 5, "clip_frac": 0.8}]
    jump = [{"step": 0, "clip_frac": 0.05}, {"step": 1, "clip_frac": 0.4}]
    notes = [(0, "step_retry", {"reason": "nan", "uid": 7}),
             (1, "step_retry", {"reason": "again", "uid": 7}),
             (1, "injected_crash", {"reason": "boom", "step": 50})]
    for stream, nts, kw in (
            (lat, (), dict(cooldown_steps=5, warmup_steps=3)),
            (derived, (), dict(cooldown_steps=100, warmup_steps=99,
                               queue_set_point=4)),
            (jump, (), dict(cooldown_steps=1)),
            ([{"step": 0, "step_s": 0.01}, {"step": 1, "step_s": 0.01}],
             notes, dict(cooldown_steps=3))):
        got = _sweep_all(tdetect, stream, nts, **kw)
        assert got == _sweep_all(jdetect, stream, nts, **kw)
    assert [f["detector"] for f in got[0][0]] == ["step_retry"]
    assert tdetect.DETECTORS == jdetect.DETECTORS
    assert tdetect.EVENT_DETECTORS == jdetect.EVENT_DETECTORS
    for mod in (tdetect, jdetect):
        with pytest.raises(ValueError, match="unknown detector"):
            mod.AnomalyDetector().note("gremlin")
        with pytest.raises(ValueError):
            mod.AnomalyDetector(cooldown_steps=0)


# ===================================================== incident bundles
def _docs():
    return {
        "trigger.json": {"schema": 1, "step": 3, "trigger": {
            "detector": "step_retry", "step": 3, "reason": "nan",
            "uid": 1, "value": None}, "firings": [
            {"detector": "step_retry", "step": 3, "reason": "nan",
             "uid": 1, "value": None}]},
        "flight.json": {"header": {"schema": 1, "capacity": 8,
                                   "recorded": 4, "dropped": 0},
                        "records": [{"step": s, "ts": s * 0.1,
                                     "step_s": 0.01, "uids": [1]}
                                    for s in range(4)]},
        "metrics.json": {},
        "fingerprint.json": {"arch": "t"},
        "provenance.json": {},
        "requests.json": {"active": [], "queued": [], "poison_uids": []},
        "journal_tail.jsonl": [json.dumps({"kind": "header"})],
    }


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bundle_roundtrip_across_packages(tmp_path, writer):
    """A bundle either package writes is the same files, and both
    loaders and both ``incident_report --validate`` accept it."""
    mod = tflight if writer == "port" else jflight
    path = mod.write_incident_bundle(str(tmp_path / "inc"),
                                     "incident-000-step_retry", _docs())
    other = (jflight if writer == "port" else tflight).write_incident_bundle(
        str(tmp_path / "other"), "incident-000-step_retry", _docs())
    for f in os.listdir(path):
        assert open(os.path.join(path, f)).read() == \
            open(os.path.join(other, f)).read(), f
    assert not os.path.exists(path + ".tmp")
    for loader in (tflight, jflight):
        b = loader.load_incident_bundle(path)
        assert b["MANIFEST.json"]["name"] == "incident-000-step_retry"
        assert b["journal_tail.jsonl"] == [{"kind": "header"}]
    assert tflight.load_incident_bundle(path) == \
        jflight.load_incident_bundle(path)
    assert t_report([path, "--validate"]) == 0
    assert j_report([path, "--validate"]) == 0


@pytest.mark.parametrize("corrupt", [
    lambda p: os.remove(os.path.join(p, "MANIFEST.json")),
    lambda p: open(os.path.join(p, "MANIFEST.json"), "w").write("{nope"),
    lambda p: os.remove(os.path.join(p, "metrics.json")),
    lambda p: open(os.path.join(p, "flight.json"), "w").write("]["),
    lambda p: open(os.path.join(p, "MANIFEST.json"), "w").write(
        json.dumps({"schema": 9, "files": []})),
])
def test_load_bundle_rejects_corruption(tmp_path, corrupt):
    path = tflight.write_incident_bundle(str(tmp_path / "inc"),
                                         "incident-000-step_retry", _docs())
    corrupt(path)
    for mod in (tflight, jflight):
        with pytest.raises(ValueError):
            mod.load_incident_bundle(path)
    assert t_report([path, "--validate"]) == 1
    assert j_report([path, "--validate"]) == 1


def test_bundle_missing_required_file_and_bad_trigger(tmp_path):
    docs = _docs()
    del docs["requests.json"]
    path = tflight.write_incident_bundle(str(tmp_path / "a"), "i", docs)
    with pytest.raises(ValueError, match="requests.json"):
        tflight.load_incident_bundle(path)
    docs = _docs()
    docs["trigger.json"]["trigger"]["detector"] = "gremlin"
    path = tflight.write_incident_bundle(str(tmp_path / "b"), "i", docs)
    assert t_report([path, "--validate"]) == 1
    assert j_report([path, "--validate"]) == 1


# ============================================ engine integration (§14)
@functools.cache
def setup():
    """(cfg, JAX params, the port's params, prompts): the JAX flight
    tests' fixture (reduced stablelm-1.6b, 5 prompts of 3-13 tokens)."""
    jcfg = j_get_arch("stablelm-1.6b").reduced()
    params = get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_jax_tree(_to_numpy_tree(params), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab, size=int(rng.integers(3, 14)))
               for _ in range(5)]
    return get_arch("stablelm-1.6b").reduced(), params, tparams, prompts


def _spy_victims(eng):
    """The injector's corruption victims, accumulated across attempts."""
    victims = []
    orig = eng._faults.corrupt_tokens

    def spy(toks, active, uid_of):
        out = orig(toks, active, uid_of)
        victims.extend(u for u in eng._faults.last_corrupted_uids
                       if u not in victims)
        return out

    eng._faults.corrupt_tokens = spy
    return victims


def _engine(which, inc, fault=None, clock=None, **kw):
    """An engine of package ``which`` over the fixture with the 5 prompts
    submitted (budget 6), a fresh registry and its own clock."""
    cfg, params, tparams, prompts = setup()
    if which == "jax":
        Eng, Cfg, p, mod, extra = JEngine, JEngineConfig, params, jobs, {}
        spec = JFaultSpec(**fault) if fault else None
    else:
        Eng, Cfg, p, mod, extra = (Engine, EngineConfig, tparams, tobs,
                                   {"device": "cpu"})
        spec = FaultSpec(**fault) if fault else None
    eng = Eng(cfg, p, Cfg(n_slots=2, max_len=MAX_LEN, prefill_bucket=8,
                          fault_spec=spec, incident_dir=inc, **kw),
              clock=clock or FakeClock(), registry=mod.MetricsRegistry(),
              **extra)
    for pr in prompts:
        eng.submit(pr, max_new_tokens=6)
    return eng


def _triggers(paths):
    out = []
    for p in paths:
        t = tflight.load_incident_bundle(p)["trigger.json"]
        out.append((os.path.basename(p), t["trigger"]["detector"],
                    t["trigger"]["step"], t["trigger"]["uid"],
                    t["trigger"]["reason"],
                    [(f["detector"], f["step"], f["uid"])
                     for f in t["firings"]]))
    return out


@pytest.mark.parametrize("fault", ["nan", "exception"])
def test_fault_yields_one_bundle_like_jax(tmp_path, fault):
    """One injected fault → one step_retry bundle, the same as JAX's:
    the trigger names the corrupted slot's uid (nan) or none
    (exception), the flight window covers it, the report validates."""
    spec = ({"seed": 5, "nan_logits_rate": 1.0, "max_faults": 1}
            if fault == "nan" else
            {"seed": 0, "step_exception_rate": 1.0, "max_faults": 1})
    got = {}
    for which in ("jax", "port"):
        inc = str(tmp_path / which)
        eng = _engine(which, inc, spec)
        victims = _spy_victims(eng)
        eng.drain()
        assert eng.metrics()["step_retries"] == 1
        assert eng.incidents == [os.path.join(inc, b)
                                 for b in sorted(os.listdir(inc))]
        got[which] = _triggers(eng.incidents), victims
    assert got["port"] == got["jax"]
    (trig, victims) = got["port"]
    assert len(trig) == 1 and trig[0][1] == "step_retry"
    assert trig[0][3] == (victims[0] if fault == "nan" else None)
    path = os.path.join(str(tmp_path / "port"), trig[0][0])
    bundle = tflight.load_incident_bundle(path)
    if fault == "nan":
        assert any(trig[0][3] in r["uids"]
                   for r in bundle["flight.json"]["records"])
    assert t_report([path, "--validate"]) == 0
    assert j_report([path, "--validate"]) == 0


def test_crash_dump_incident_like_jax(tmp_path):
    """An injected crash ends the step loop before the sweep, so the
    crashed engine's ``dump_incident`` writes the bundle (the serve
    supervisor's path); its trigger and flight window equal JAX's."""
    got = {}
    for which, exc in (("jax", JInjectedCrash), ("port", InjectedCrash)):
        eng = _engine(which, str(tmp_path / which),
                      {"seed": 2, "crash_rate": 1.0, "max_faults": 1})
        with pytest.raises(exc) as e:
            eng.drain()
        path = eng.dump_incident("injected_crash", reason=str(e.value))
        b = tflight.load_incident_bundle(path)
        got[which] = (_triggers([path]), [
            {k: v for k, v in r.items() if k not in TIME_FIELDS}
            for r in b["flight.json"]["records"]],
            b["requests.json"], b["fingerprint.json"]["arch"])
        assert t_report([path, "--validate"]) == 0
        assert j_report([path, "--validate"]) == 0
    assert got["port"] == got["jax"]
    assert got["port"][0][0][1] == "injected_crash"


def test_clean_run_yields_zero_bundles(tmp_path):
    """The false-positive gate: an unfaulted run writes nothing — the
    incident dir is never created — and records every step."""
    for which in ("jax", "port"):
        inc = str(tmp_path / which)
        eng = _engine(which, inc)
        assert len(eng.drain()) == 5
        m = eng.metrics()
        assert eng.incidents == [] and not os.path.exists(inc)
        assert m["anomalies_fired"] == 0 and m["incidents"] == []
        assert m["flight_recorded"] == len(eng.step_s) > 0


def test_bundle_seq_survives_restart(tmp_path):
    """A second engine on the same incident dir numbers its bundle after
    the first's (the sequence comes from disk), as JAX's does."""
    inc = str(tmp_path / "inc")
    spec = {"seed": 5, "nan_logits_rate": 1.0, "max_faults": 1}
    for which in ("port", "jax"):
        _engine(which, inc, spec).drain()
    names = sorted(os.listdir(inc))
    assert [n[:13] for n in names] == ["incident-000-", "incident-001-"]
    for n in names:
        assert t_report([os.path.join(inc, n), "--validate"]) == 0


def test_global_cooldown_one_bundle_per_storm(tmp_path):
    """poison_rate=1 faults every attempt of every request; the global
    cooldown collapses the storm into one bundle, as in JAX."""
    got = {}
    for which in ("jax", "port"):
        inc = str(tmp_path / which)
        eng = _engine(which, inc, {"seed": 0, "poison_rate": 1.0},
                      max_retries=1)
        eng.drain()
        m = eng.metrics()
        assert m["step_retries"] > 1 and m["quarantined"] == 5
        got[which] = _triggers(eng.incidents), m["anomalies_fired"]
    assert got["port"] == got["jax"] and len(got["port"][0]) == 1


def test_chaos_flight_records_match_jax(tmp_path):
    """Under the JAX chaos spec (with the ladder), the flight records'
    non-time fields equal JAX's record for record, and so do the
    detector firings and the bundles' triggers (the wall-clock detector
    reads the fake engine clock)."""
    got = {}
    for which in ("jax", "port"):
        inc = str(tmp_path / which)
        eng = _engine(which, inc, CHAOS, degrade=True,
                      degrade_thresholds=(1, 2, 3), incident_cooldown=4)
        eng.drain()
        recs = [{k: v for k, v in r.items() if k not in TIME_FIELDS}
                for r in eng._flight.window()]
        got[which] = recs, _triggers(eng.incidents), \
            eng.metrics()["anomalies_fired"], eng._flight.header()
    assert got["port"] == got["jax"]
    recs = got["port"][0]
    assert recs[-1]["retries"] > 0 and recs[-1]["quarantined"] > 0
    assert any(r["rung"] > 0 for r in recs)
    assert len(got["port"][1]) > 1


class StepClock:
    """A fake engine clock that advances only when told: every decode
    dispatch adds ``dt`` (``spike`` at dispatch ``at``)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_step_latency_spike_on_a_fake_clock(tmp_path):
    """``step_latency_spike`` driven by the engine's clock: one decode
    dispatch 100x slower than the rest fires it, in both packages at the
    same step with the same bundle."""
    got = {}
    for which in ("jax", "port"):
        clock = StepClock()
        eng = _engine(which, str(tmp_path / which), clock=clock)
        n = [0]
        dispatch = eng._dispatch_decode

        def slow(*a, dispatch=dispatch, clock=clock, n=n):
            n[0] += 1
            clock.t += 1.0 if n[0] == 12 else 0.01
            return dispatch(*a)

        eng._dispatch_decode = slow
        eng.drain()
        got[which] = _triggers(eng.incidents)
    assert got["port"] == got["jax"]
    assert [t[1] for t in got["port"]] == ["step_latency_spike"]


def test_integrity_error_dumps_a_bundle(tmp_path):
    """A snapshot refused on restore captures an ``integrity_error``
    bundle before the error propagates."""
    eng = _engine("port", None)
    for _ in range(3):
        eng.step()
    snap = str(tmp_path / "snap")
    eng.snapshot(snap)
    mpath = os.path.join(snap, "manifest.json")
    with open(mpath) as f:
        man = json.load(f)
    first = next(iter(man["checksums"]))
    man["checksums"][first] = "crc32:00000000"
    with open(mpath, "w") as f:
        json.dump(man, f)
    cfg, _, tparams, _ = setup()
    inc = str(tmp_path / "inc")
    other = Engine(cfg, tparams, EngineConfig(
        n_slots=2, max_len=MAX_LEN, prefill_bucket=8, incident_dir=inc),
        device="cpu", registry=tobs.MetricsRegistry())
    with pytest.raises(IntegrityError):
        other.restore(snap)
    [name] = os.listdir(inc)
    assert name == "incident-000-integrity_error"
    assert t_report([os.path.join(inc, name), "--validate"]) == 0


def test_incident_report_timeline_and_hints(tmp_path, capsys):
    """The report's text: the timeline marks the trigger step, the hints
    name the cause, and the journal resolves the victim's story."""
    journal = str(tmp_path / "j.jsonl")
    inc = str(tmp_path / "inc")
    eng = _engine("port", inc, {"seed": 5, "nan_logits_rate": 1.0,
                                "max_faults": 1}, journal_path=journal)
    victims = _spy_victims(eng)
    eng.drain()
    [name] = os.listdir(inc)
    capsys.readouterr()
    assert t_report([os.path.join(inc, name), "--journal", journal]) == 0
    out = capsys.readouterr().out
    assert "trigger step_retry" in out and "<< step_retry" in out
    assert "root-cause hints" in out and f"uid {victims[0]}" in out
