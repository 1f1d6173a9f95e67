"""Port parity, the rest of observability: ``RegistryQuantProbe`` and the
act-quant ``*_observed`` wrappers, ``SnapshotWriter`` / ``load_snapshots``
(each package reads the other's files) and ``launch.trace_report``
against the JAX package's, on the same inputs; ``launch.serve
--metrics-snapshot``.

Tolerances: none — registry snapshots, snapshot files, Chrome exports and
the trace report's phase table, coverage and dispatch / wait split are
equal (the same fake clock drives both packages; the report functions
run the same arithmetic). No test here reads a wall clock.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.launch import trace_report as jreport

from repro_torch import obs as tobs
from repro_torch.configs import get_arch
from repro_torch.engine import Engine, EngineConfig
from repro_torch.kernels import act_quant as aq
from repro_torch.launch import serve
from repro_torch.launch import trace_report as treport
from repro_torch.models import transformer as tt


class FakeClock:
    """Deterministic monotonic clock: every call advances by ``tick``."""

    def __init__(self, tick=0.001):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _both(fn):
    return fn(tobs), fn(jobs)


# ------------------------------------------------------------ the probe ---
def test_registry_quant_probe_matches_jax():
    """The same codes through each package's probe: the same returns and
    the same counter and gauges (an empty call leaves the gauges)."""
    rng = np.random.default_rng(2)
    calls = [rng.integers(-128, 128, size=n).astype(np.int8)
             for n in (64, 0, 17, 300)]

    def run(mod):
        reg = mod.MetricsRegistry()
        probe = mod.RegistryQuantProbe(reg)
        assert bool(probe)
        outs = [probe.observe(q, layer=i) for i, q in enumerate(calls)]
        return outs, reg.snapshot(), reg.to_prometheus()
    got, want = _both(run)
    assert got == want
    assert got[1]["act_quant_observations_total"] == 4.0
    assert got[1]["act_quant_clip_frac"] == \
        tobs.code_stats(calls[-1])["clip_frac"]


@pytest.mark.parametrize("static", [False, True])
def test_observed_wrappers_feed_the_installed_probe(static):
    """With a probe installed the observed wrappers return the plain
    wrappers' results and the probe's gauges are ``code_stats`` of the
    codes; with none (or after clearing) nothing is observed."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (6, 24)).astype(np.float32) * 3)
    scale = torch.tensor([9.0, 11.0, 7.0])
    zero = torch.tensor([0.5, -1.0, 2.0])

    def call():
        if static:
            return aq.act_split_quantize_static_observed(
                x, scale, zero, bits=8, layer=1)
        return aq.act_split_quantize_observed(x, bits=4, n_chunks=3,
                                              layer=1)
    plain = (aq.act_split_quantize_static(x, scale, zero, bits=8) if static
             else aq.act_split_quantize(x, bits=4, n_chunks=3))
    reg = tobs.MetricsRegistry()
    aq.set_quality_probe(tobs.RegistryQuantProbe(reg))
    try:
        got = call()
    finally:
        aq.set_quality_probe(None)
    got, plain = (got,) if static else got, (plain,) if static else plain
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    cs = tobs.code_stats(got[0].numpy())
    snap = reg.snapshot()
    assert (snap["act_quant_observations_total"], snap["act_quant_clip_frac"],
            snap["act_quant_occupancy"]) == (1.0, cs["clip_frac"],
                                             cs["occupancy"])
    call()                                 # no probe: nothing observed
    assert reg.snapshot()["act_quant_observations_total"] == 1.0


# ------------------------------------------------------------ snapshots ---
def _fill(reg):
    reg.counter("engine_steps", "steps").inc(3)
    reg.gauge("engine_slot_occupancy").set(0.5)
    h = reg.histogram("engine_step_seconds", "step wall")
    for v in (0.001, 0.02, 0.3):
        h.observe(v)


def test_snapshot_files_are_read_by_both_packages(tmp_path):
    """Each package's ``SnapshotWriter`` over the same registry, clock and
    provenance writes the same text; each ``load_snapshots`` reads both
    files to the same header and records; ``maybe_write`` keeps the rate
    limit."""
    def run(mod):
        reg = mod.MetricsRegistry()
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        w = mod.SnapshotWriter(path, reg, interval_s=0.0025,
                               clock=FakeClock(), provenance={"seed": 0})
        _fill(reg)
        wrote = [w.maybe_write() for _ in range(5)]
        w.write()
        return path, wrote, w.seq
    (tp, tw, tseq), (jp, jw, jseq) = _both(run)
    assert (tw, tseq) == (jw, jseq) and tw[0] and not all(tw)
    assert open(tp).read() == open(jp).read()
    for path in (tp, jp):
        th, ts = tobs.load_snapshots(path)
        jh, js = jobs.load_snapshots(path)
        assert (th, ts) == (jh, js)
        assert th["provenance"] == {"seed": 0}
        assert [r["seq"] for r in ts] == list(range(tseq))
        assert ts[-1]["metrics"]["engine_steps"] == 3.0
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "snapshot"}\n')
    for mod in (tobs, jobs):
        with pytest.raises(ValueError, match="header"):
            mod.load_snapshots(str(bad))


def test_serve_cli_metrics_snapshot(tmp_path, capsys):
    """``launch.serve --metrics-snapshot`` on reduced moonshot (the MoE
    family through the engine; k=1 weights: no k-means): snapshots written during the run and at
    the drain, read by both packages, the last one counting every token;
    the act-quant probe's counter registered; the JAX launcher's checks
    against ``--no-metrics`` and ``--wave``."""
    path = str(tmp_path / "m.jsonl")
    try:
        serve.main(["--arch", "moonshot-v1-16b-a3b", "--reduced", "--device",
                    "cpu", "--method", "baseline", "--requests", "3",
                    "--max-new-tokens", "4", "--metrics-snapshot", path,
                    "--metrics-interval", "0"])
    finally:
        aq.set_quality_probe(None)
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "snapshots ->" in out
    th, ts = tobs.load_snapshots(path)
    assert (th, ts) == jobs.load_snapshots(path)
    assert len(ts) >= 3
    last = ts[-1]["metrics"]
    assert last["engine_tokens_generated"] == 12.0
    assert last["act_quant_observations_total"] == 0.0
    base = ["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu",
            "--metrics-snapshot", path]
    with pytest.raises(ValueError, match="drop one side"):
        serve.main(base + ["--no-metrics"])
    with pytest.raises(NotImplementedError, match="engine features"):
        serve.main(base + ["--wave"])


# --------------------------------------------------------- trace_report ---
def _port_trace(tmp_path):
    """A traced engine run of the port on reduced stablelm-1.6b (its own
    seeded weights, a fake clock), written as JSONL."""
    cfg = get_arch("stablelm-1.6b").reduced()
    params = tt.init(cfg, seed=0, device="cpu")
    eng = Engine(cfg, params, EngineConfig(
        n_slots=2, max_len=48, prefill_bucket=8, prefill_chunk=8,
        trace=True), device="cpu", clock=FakeClock())
    rng = np.random.default_rng(3)
    for b in (5, 2, 4):
        eng.submit(rng.integers(0, cfg.vocab, size=int(rng.integers(3, 14))),
                   max_new_tokens=b)
    eng.drain()
    path = str(tmp_path / "t.jsonl")
    eng.tracer.to_jsonl(path)
    return path


def _report(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


#: the two attribution labels that name each package's own mechanism
LABELS = ("  host dispatch (", "  device wait (")


def _same_report(got: str, want: str):
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if a.startswith(LABELS):
            a, b = a.split(":", 1)[1], b.split(":", 1)[1]
        assert a == b


def test_trace_report_matches_jax(tmp_path):
    """Both packages' ``trace_report`` on one trace: the same phase
    table, coverage, dispatch / wait split, lifecycle and waterfalls,
    ``--validate`` 0, and the same Chrome export."""
    path = _port_trace(tmp_path)
    outs = {}
    for name, main in (("port", treport.main), ("jax", jreport.main)):
        chrome = str(tmp_path / f"{name}.json")
        rc, out = _report(main, [path, "--validate", "--chrome", chrome])
        assert rc == 0, out
        outs[name] = out.replace(chrome, "<chrome>")
    _same_report(outs["port"], outs["jax"])
    assert "schema validation: ok" in outs["port"]
    assert "coverage:" in outs["port"] and "waterfalls" in outs["port"]
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        assert json.load(f) == json.load(g)


def test_trace_report_validate_fails_and_hlo_is_not_ported(tmp_path):
    """A broken record fails ``--validate`` (exit 1) in both packages, a
    dropped-records header warns in both; ``--hlo`` raises, naming its
    ROADMAP item."""
    path = tmp_path / "bad.jsonl"
    recs = [{"kind": "header", "schema": 1, "dropped": 3, "capacity": 8},
            {"kind": "span", "name": "decode", "ts": 0.0},
            {"kind": "event", "name": "submit", "ts": 0.1}]
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    got = {}
    for name, main in (("port", treport.main), ("jax", jreport.main)):
        got[name] = _report(main, [str(path), "--validate"])
        assert got[name][0] == 1
        assert "3 trace records DROPPED" in got[name][1]
    _same_report(got["port"][1], got["jax"][1])
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        treport.main([str(path), "--hlo", "x.txt"])
