"""Port parity, crash safety (DESIGN.md §13): the request journal, engine
snapshots and crash recovery, against the JAX package on reduced
stablelm-1.6b (JAX's seeded ``init``, carried over by the bridge) at the
JAX tests' sizes: MAX_LEN 48, 7 prompts of 3-13 tokens.

- The port's journal equals JAX's record for record (``ts`` aside), both
  validators pass it, and ``compact_journal`` gives the same file in
  both packages.
- A port snapshot passes JAX's ``read_snapshot`` and a JAX engine
  restored from it drains to the port's tokens; a JAX snapshot restores
  into the port the same way (greedy engines, dynamic and static int8).
  A flipped byte, a bad ``kv_pos``, a non-positive scale, a wrong schema
  and a wrong geometry raise ``IntegrityError`` with JAX's reason in both.
- A crashed port engine recovered from snapshot + journal, and one
  recovered from the journal alone, finish every request exactly once
  with the uncrashed run's tokens — which are JAX's.

Tolerances: none (tokens, records, bytes and reasons are equal).
"""
import dataclasses
import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import recovery as jrec
from repro.obs import schema as jschema

from repro_torch.engine import (Engine, EngineConfig, FaultSpec,
                                InjectedCrash, IntegrityError,
                                RequestJournal, compact_journal,
                                occupied_slots, read_snapshot)
from repro_torch.engine import recovery as trec
from repro_torch.engine.kvcache import CACHE_DATA_FIELDS
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs.schema import validate_events

from test_torch_faults import BUDGETS, MAX_LEN, workload

#: (kv_mode, static scales) — every crash property holds in all three
KV_MODES = [("fp", False), ("int8", False), ("int8", True)]
IDS = ["fp", "int8", "int8-static"]


def _ecfg(mod, **kw):
    base = dict(n_slots=3, max_len=MAX_LEN, prefill_bucket=8,
                prefill_chunk=8)
    base.update(kw)
    if mod is JEngineConfig:
        base["flight"] = False
    return mod(**base)


def port_engine(kv_mode="int8", static=False, **kw):
    cfg, _, tparams, _, scales = workload()
    return Engine(cfg, tparams, _ecfg(EngineConfig, kv_mode=kv_mode, **kw),
                  device="cpu", kv_scales=scales if static else None)


def jax_engine(kv_mode="int8", static=False, **kw):
    cfg, params, _, _, scales = workload()
    return JEngine(cfg, params, _ecfg(JEngineConfig, kv_mode=kv_mode, **kw),
                   kv_scales=scales if static else None)


def submit_all(eng):
    for p, b in zip(workload()[3], BUDGETS):
        eng.submit(p, max_new_tokens=b)


def outs(fin):
    return {r.uid: list(r.out) for r in fin}


@functools.cache
def reference(kv_mode, static):
    """The uncrashed port run's tokens, held equal to JAX's."""
    t = port_engine(kv_mode, static)
    submit_all(t)
    got = outs(t.drain())
    j = jax_engine(kv_mode, static)
    submit_all(j)
    assert got == outs(j.drain())
    return got


# ================================================================ journal
def _strip_ts(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def test_journal_matches_jax(tmp_path):
    """Every lifecycle record, in order and field for field (``ts``
    aside), with a snapshot mark in the middle; both validators pass."""
    paths = {}
    for name, mk in (("jax", jax_engine), ("port", port_engine)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        eng = mk(journal_path=paths[name],
                 snapshot_path=str(tmp_path / f"{name}_snap"),
                 snapshot_every=4)
        submit_all(eng)
        eng.drain()
    want = jrec.load_journal(paths["jax"])
    got = trec.load_journal(paths["port"])
    assert _strip_ts(got) == _strip_ts(want)
    assert validate_events(got) == [] == jschema.validate_events(got)
    names = [r.get("name") for r in got]
    assert {"submit", "admit", "first_token", "retire",
            "snapshot"} <= set(names)
    submitted, retired = trec.replay_journal(got)
    assert sorted(retired) == list(range(7))
    assert outs_from(retired) == reference("int8", False)
    assert submitted[2]["prompt"] == [int(t) for t in workload()[3][2]]


def outs_from(retired):
    return {u: rec["out"] for u, rec in retired.items()}


def test_compact_journal_matches_jax(tmp_path):
    """Both compactors turn the same journal into the same file; it stays
    valid, replays the same retires, and a second pass changes nothing."""
    src = str(tmp_path / "j.jsonl")
    eng = port_engine(journal_path=src)
    submit_all(eng)
    for _ in range(5):
        eng.step()
    eng.journal.sync()
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    shutil.copy(src, a)
    shutil.copy(src, b)
    na = compact_journal(a)
    nb = jrec.compact_journal(b)
    assert na == nb and na[1] < na[0]
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()
    recs = trec.load_journal(a)
    assert validate_events(recs) == []
    assert trec.replay_journal(recs)[1] == \
        trec.replay_journal(trec.load_journal(src))[1]
    assert compact_journal(a) == (na[1], na[1])


def test_journal_resume_single_header(tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    j1 = RequestJournal(jpath, meta={"arch": "t"})
    j1.event("submit", uid=0, prompt=[1], budget=1, cls="interactive",
             ttft_deadline_s=None, deadline_s=None)
    j1.close()
    j2 = RequestJournal(jpath, resume=True)
    j2.event("retire", uid=0, slot=0, reason="budget", n_out=1, out=[5])
    j2.close()
    records = trec.load_journal(jpath)
    assert validate_events(records) == []
    assert sum(r["kind"] == "header" for r in records) == 1
    submitted, retired = trec.replay_journal(records)
    assert list(submitted) == [0] and retired[0]["out"] == [5]
    RequestJournal(jpath, resume=False).close()      # a new run truncates
    assert trec.replay_journal(trec.load_journal(jpath)) == ({}, {})


# ============================================================== integrity
def test_validate_cache_arrays_matches_jax():
    pos = np.full((1, 2, 4), -1, np.int32)
    pos[0, 0, :2] = [0, 1]
    good = {"cache/kv_pos": pos,
            "cache/k": np.array([-128, 127], np.int8),
            "cache/v": np.array([0], np.int8),
            "cache/k_scale": np.ones(3, np.float32),
            "cache/v_scale": np.ones(3, np.float32),
            "cache/k_zero": np.zeros(3, np.float32),
            "cache/v_zero": np.zeros(3, np.float32)}
    bad_pos = pos.copy()
    bad_pos[0, 1, 3] = 1
    cases = [dict(good, **{"cache/kv_pos": bad_pos}),
             dict(good, **{"cache/k_scale": np.array([1, 0], np.float32)}),
             dict(good, **{"cache/v_zero": np.array([np.nan], np.float32)})]
    for mode in ("fp", "int8"):
        trec.validate_cache_arrays(good, mode)
        jrec.validate_cache_arrays(good, mode)
    for arrays in cases:
        with pytest.raises(IntegrityError) as t:
            trec.validate_cache_arrays(arrays, "int8", context="c")
        with pytest.raises(jrec.IntegrityError) as j:
            jrec.validate_cache_arrays(arrays, "int8", context="c")
        assert (t.value.reason, str(t.value)) == \
            (j.value.reason, str(j.value))


# ================================================ snapshots across packages
def _snapshot_mid_run(eng, path, n_steps=3):
    submit_all(eng)
    for _ in range(n_steps):
        eng.step()
    eng.snapshot(path)
    return {r.uid for r in eng.sched.finished}


@pytest.mark.parametrize("static", [False, True], ids=["int8", "static"])
def test_port_snapshot_restores_in_jax(tmp_path, static):
    """A port snapshot passes JAX's reader (checksums, invariants,
    dtypes) and a JAX engine restored from it drains to the port's
    tokens."""
    spath = str(tmp_path / "snap")
    t = port_engine(static=static)
    done = _snapshot_mid_run(t, spath)
    manifest, arrays = jrec.read_snapshot(spath)
    assert manifest["dtypes"]["cache/k"] == "int8"
    assert manifest["dtypes"]["cache/kv_pos"] == "int32"
    assert manifest["dtypes"]["host/last_tok"] == "int32"
    j = jax_engine(static=static)
    j.restore(spath)
    got = outs(j.drain())
    want = reference("int8", static)
    assert got and all(got[u] == want[u] for u in got)
    assert set(got) == set(range(7)) - done
    t2 = port_engine(static=static)
    t2.restore(spath)
    assert outs(t2.drain()) == got


@pytest.mark.parametrize("static", [False, True], ids=["int8", "static"])
def test_jax_snapshot_restores_in_port(tmp_path, static):
    spath = str(tmp_path / "snap")
    j = jax_engine(static=static)
    done = _snapshot_mid_run(j, spath, n_steps=4)
    manifest, _ = read_snapshot(spath)
    assert manifest["dtypes"]["host/rng"] == "uint32"
    t = port_engine(static=static)
    t.restore(spath)
    got = outs(t.drain())
    want = reference("int8", static)
    assert set(got) == set(range(7)) - done
    assert all(got[u] == want[u] for u in got)
    # a JAX key is no torch.Generator state: a sampling engine refuses it
    s = port_engine(static=static, temperature=0.7)
    with pytest.raises(IntegrityError) as e:
        s.restore(spath)
    assert e.value.reason == "config_mismatch"


def _tamper(spath, key, mutate, restamp):
    npz = os.path.join(spath, "arrays.npz")
    data = dict(np.load(npz))
    data[key] = mutate(data[key].copy())
    np.savez(npz, **data)
    if restamp:
        mpath = os.path.join(spath, "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        manifest["checksums"] = trec.checksum_arrays(data)
        with open(mpath, "w") as f:
            json.dump(manifest, f)


def _flip(a):
    return a ^ np.int8(1)


def _bad_pos(a):
    a[0, 0, -1] = 1
    return a


def _zero_scale(a):
    a.reshape(-1)[0] = 0.0
    return a


@pytest.mark.parametrize("key,mutate,restamp,reason", [
    ("cache/k", _flip, False, "checksum"),
    ("cache/kv_pos", _bad_pos, True, "kv_pos_invalid"),
    ("cache/k_scale", _zero_scale, True, "nonpositive_scale")],
    ids=["flipped-byte", "kv-pos", "scale"])
def test_corrupt_snapshot_rejected_like_jax(tmp_path, key, mutate, restamp,
                                            reason):
    spath = str(tmp_path / "snap")
    _snapshot_mid_run(port_engine(), spath)
    _tamper(spath, key, mutate, restamp)
    with pytest.raises(IntegrityError) as t:
        read_snapshot(spath)
    with pytest.raises(jrec.IntegrityError) as j:
        jrec.read_snapshot(spath)
    assert t.value.reason == j.value.reason == reason
    with pytest.raises(IntegrityError):
        port_engine().restore(spath)


def test_snapshot_schema_and_geometry_rejected_like_jax(tmp_path):
    spath = str(tmp_path / "snap")
    _snapshot_mid_run(port_engine(), spath)
    for kw in (dict(n_slots=2), dict(kv_mode="fp"), dict(max_len=40)):
        with pytest.raises(IntegrityError) as t:
            port_engine(**kw).restore(spath)
        with pytest.raises(jrec.IntegrityError) as j:
            jax_engine(**kw).restore(spath)
        assert t.value.reason == j.value.reason == "config_mismatch"
    mpath = os.path.join(spath, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["schema"] = 99
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    for path in (spath, spath + "_nonexistent"):
        with pytest.raises(IntegrityError) as t:
            read_snapshot(path)
        with pytest.raises(jrec.IntegrityError) as j:
            jrec.read_snapshot(path)
        assert t.value.reason == j.value.reason == "schema"


# ================================================ snapshot round trip
def _assert_state_equal(x, y):
    for name in CACHE_DATA_FIELDS:
        assert torch.equal(getattr(x.cache, name), getattr(y.cache, name)), \
            name
    for f in ("_last_tok", "_pos", "_prefill_prog", "_fail_streak"):
        np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert [r and r.uid for r in x.sched.slots] == \
        [r and r.uid for r in y.sched.slots]
    assert [r.uid for r in x.sched.queue] == [r.uid for r in y.sched.queue]
    assert x.sched._prefilling == y.sched._prefilling


@pytest.mark.parametrize("kv_mode,static", KV_MODES, ids=IDS)
@pytest.mark.parametrize("n_steps", [0, 2, 6])
def test_snapshot_restore_roundtrip(tmp_path, kv_mode, static, n_steps):
    """Snapshot mid-prefill (0, 2 steps) or mid-decode with retires (6),
    restore into a fresh engine: every tensor and the host state equal,
    and one more step equal on both sides."""
    a = port_engine(kv_mode, static)
    submit_all(a)
    for _ in range(n_steps):
        a.step()
    spath = str(tmp_path / "snap")
    a.snapshot(spath)
    b = port_engine(kv_mode, static)
    b.restore(spath)
    _assert_state_equal(a, b)
    na, nb = len(a.sched.finished), len(b.sched.finished)
    a.step()
    b.step()
    _assert_state_equal(a, b)
    assert [(r.uid, r.out) for r in a.sched.finished[na:]] == \
        [(r.uid, r.out) for r in b.sched.finished[nb:]]


def test_sampling_engine_resumes_its_draws(tmp_path):
    """A temperature engine's snapshot carries its generator's state: the
    restored engine draws the tokens the original goes on to draw."""
    a = port_engine(temperature=0.7)
    spath = str(tmp_path / "snap")
    before = _snapshot_mid_run(a, spath)
    b = port_engine(temperature=0.7)
    b.restore(spath)
    want = {r.uid: list(r.out) for r in a.drain() if r.uid not in before}
    got = outs(b.drain())
    assert got == want and len(got) > 0


# ================================================ crash recovery
@pytest.mark.parametrize("kv_mode,static", KV_MODES, ids=IDS)
def test_crash_recovery_token_identity(tmp_path, kv_mode, static):
    """A seeded crash at a step boundary after a snapshot, a fresh engine
    recovered from snapshot + journal: every request retires exactly
    once with the uncrashed run's tokens (JAX's), nothing leaks, the
    merged journal is one valid trace, and the registry counts the
    restore and the replayed requests."""
    jpath = str(tmp_path / "journal.jsonl")
    spath = str(tmp_path / "snap")
    eng = port_engine(kv_mode, static, journal_path=jpath,
                      snapshot_path=spath, snapshot_every=3,
                      fault_spec=FaultSpec(seed=2, crash_rate=0.25,
                                           max_faults=1))
    submit_all(eng)
    with pytest.raises(InjectedCrash):
        eng.drain()
    assert eng.sched.slots != [None] * 3           # crashed mid-flight
    reg = eng.registry
    assert reg.snapshot()["engine_snapshots"] >= 1
    del eng

    eng2 = port_engine(kv_mode, static, journal_path=jpath,
                       journal_resume=True, snapshot_path=spath)
    info = eng2.recover(spath, jpath)
    assert info["manifest"] is not None and info["n_restored"] > 0
    done = {u: rec["out"] for u, rec in info["retired"].items()}
    for r in eng2.drain():
        assert r.uid not in done, f"uid {r.uid} retired twice"
        done[r.uid] = list(r.out)
    assert done == reference(kv_mode, static)
    assert occupied_slots(eng2.cache) == []
    records = trec.load_journal(jpath)
    assert validate_events(records) == [] == jschema.validate_events(records)
    names = {r.get("name") for r in records if r.get("kind") == "event"}
    assert {"snapshot", "restore"} <= names
    prom = eng2.registry.to_prometheus()
    for name in ("repro_engine_snapshots_total", "repro_engine_restore_total",
                 "repro_engine_journal_replayed_requests_total",
                 "repro_engine_restore_duration_s_bucket"):
        assert name in prom, name
    snap = eng2.registry.snapshot()
    assert snap["engine_restore"] == 1
    assert snap["engine_journal_replayed_requests"] == \
        info["n_restored"] + info["n_requeued"]


def test_journal_only_recovery(tmp_path):
    """No snapshot (a crash before the first): every un-retired request
    re-prefills from its submit record and matches the reference."""
    jpath = str(tmp_path / "journal.jsonl")
    eng = port_engine("fp", journal_path=jpath)
    submit_all(eng)
    for _ in range(4):
        eng.step()
    pre = outs(eng.sched.finished)
    del eng
    eng2 = port_engine("fp", journal_path=jpath, journal_resume=True)
    info = eng2.recover(None, jpath)
    assert info["manifest"] is None and info["n_restored"] == 0
    assert info["n_requeued"] == 7 - len(pre)
    assert set(info["retired"]) == set(pre)
    done = {u: rec["out"] for u, rec in info["retired"].items()}
    done.update(outs(eng2.drain()))
    assert done == reference("fp", False)
    assert eng2._uid == 7


def test_registry_carried_over_a_restart(tmp_path):
    """A supervisor passes the crashed engine's registry to the new one:
    counts add up across incarnations."""
    reg = tmetrics.MetricsRegistry()
    jpath = str(tmp_path / "j.jsonl")
    cfg, _, tparams, _, _ = workload()
    eng = Engine(cfg, tparams, _ecfg(EngineConfig, kv_mode="int8",
                                     journal_path=jpath), device="cpu",
                 registry=reg)
    submit_all(eng)
    for _ in range(3):
        eng.step()
    eng.journal.sync()
    steps = reg.snapshot()["engine_steps"]
    eng2 = Engine(cfg, tparams, dataclasses.replace(
        eng.ecfg, journal_resume=True), device="cpu", registry=reg)
    info = eng2.recover(None, jpath)
    eng2.drain()
    snap = reg.snapshot()
    assert snap["engine_steps"] > steps
    assert snap["engine_journal_replayed_requests"] == info["n_requeued"]
    assert snap["engine_restore"] == 0


# ================================================ launch.serve
def _serve(args, cwd):
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # one thread: the reduced model gains nothing from more, and beside
    # the other test workers more threads only contend for the cores
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "stablelm-1.6b", "--reduced", "--device", "cpu", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _reported(out):
    """uid → tokens of every ``req`` line."""
    got = {}
    for line in out.splitlines():
        if line.startswith("req "):
            uid = int(line.split(":")[0][4:])
            assert uid not in got, f"uid {uid} reported twice"
            got[uid] = line.split("→ ")[1].split("]")[0] + "]"
    return got


def test_serve_cli_supervised_and_killed_crash_recovery(tmp_path, capsys):
    """``--supervise 1`` recovers an injected crash in-process; a SIGKILL
    crash (``crash_kill=1``) is recovered by ``--recover-from`` in a
    fresh process. Both exit 0 and report every request once with the
    uncrashed run's tokens."""
    from repro_torch.launch.serve import main
    main(["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu"])
    want = _reported(capsys.readouterr().out)
    assert sorted(want) == [0, 1, 2, 3]
    crash = "crash=0.2,seed=7,max=1"       # fires at the 7th step boundary
    keep = ["--journal", "j.jsonl", "--snapshot", "snap",
            "--snapshot-every", "2"]
    res = _serve(["--faults", crash, *keep, "--supervise", "1"], tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "supervisor: engine crashed" in res.stdout
    assert _reported(res.stdout) == want
    d = tmp_path / "kill"
    d.mkdir()
    res = _serve(["--faults", crash + ",crash_kill=1", *keep], d)
    assert res.returncode == -9, res.stdout + res.stderr
    res = _serve(["--journal", "j.jsonl", "--snapshot", "snap",
                  "--recover-from", "snap"], d)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "live requests restored from snapshot" in res.stdout
    assert _reported(res.stdout) == want
