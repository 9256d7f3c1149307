"""The port's linkmap (``tpu_perf_torch.linkmap``, ``linkmap``, ``linkmap
report``) against the JAX package's on the CPU.

The planner's schedules equal JAX's link for link; the grader, the
renderers and the cross-sweep diff give JAX's verdicts and text on the
same measurements; a seeded ``--synthetic`` sweep through both CLIs, with
and without faults, writes the same probe, verdict and health records
(byte for byte once ``job_id``, ``host`` and the file's timestamp are set
aside), prints the same report and exits alike; real probes on 8 sim CPU
ranks give the outputs of JAX's chained ``ppermute`` on its 8 CPU devices
exactly (a copy: no tolerance), with the same record count and shape; the
default roofline follows JAX's rule with the card's NVLink rate in a
multi-process world on cards and none in the sim world; and a gloo world
of 3 processes grades alike on every rank while rank 0 alone writes.
"""

import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_perf import cli as jcli
from tpu_perf import linkmap as jlm
from tpu_perf.faults import FaultInjector as JInjector
from tpu_perf.faults import FaultSpec as JFaultSpec

from tpu_perf_torch import cli
from tpu_perf_torch.faults import FaultInjector, FaultSpec
from tpu_perf_torch.linkmap import (
    GradeConfig, LinkmapRecord, LinkProber, ProbeResult, all_links,
    diff_linkmaps, grade, heatmap, linkdiff_summary, linkdiff_to_markdown,
    linkmap_to_json, linkmap_to_markdown, load_linkmap_artifact,
    plan_all_pairs, plan_mesh_links, probe_op_name, read_linkmap,
    summary_line, verdicts_to_markdown,
)
from tpu_perf_torch.linkmap.grade import mad_robust_z
from tpu_perf_torch.linkmap.plan import _round_robin_rounds
from tpu_perf_torch.linkmap.probe import LinkMapResult
from tpu_perf_torch.parallel import make_mesh
from tpu_perf_torch.world import DistWorld, SimWorld

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
WORKER_TIMEOUT_S = 240


def _plan_fields(schedules):
    return [(s.name, [(p.src, p.dst, p.src_coords, p.dst_coords, p.axis,
                       p.shift, p.op) for p in s.probes]) for s in schedules]


# --- the planner: JAX's schedules, link for link -------------------------


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("shape,axes", [
    ((8,), ()), ((2, 4), ()), ((2, 2, 2), ()), ((4,), ("x",)),
    ((1, 4), ("dcn", "ici")), ((2, 4), ("dcn", "ici")), ((3, 3), ())])
def test_neighbor_plans_are_jaxs(shape, axes, wrap):
    ours = plan_mesh_links(shape, axes, wrap=wrap)
    theirs = jlm.plan_mesh_links(shape, axes, wrap=wrap)
    assert _plan_fields(ours) == _plan_fields(theirs)
    assert [s.perm() for s in ours] == [s.perm() for s in theirs]


@pytest.mark.parametrize("n", range(2, 9))
def test_all_pairs_plans_are_jaxs(n):
    from tpu_perf.linkmap.plan import _round_robin_rounds as jrounds

    assert _round_robin_rounds(n) == jrounds(n)
    ours = plan_all_pairs(n)
    assert _plan_fields(ours) == _plan_fields(jlm.plan_all_pairs(n))
    seen = [(p.src, p.dst) for p in all_links(ours)]
    assert len(seen) == len(set(seen))
    assert set(seen) == {(i, j) for i in range(n) for j in range(n) if i != j}


@pytest.mark.parametrize("shape", [(8,), (2, 4), (2, 2, 2)])
def test_plan_covers_every_directed_neighbor_link_once(shape):
    schedules = plan_mesh_links(shape)
    for s in schedules:
        links = [(p.src, p.dst) for p in s.probes]
        assert len({a for a, _ in links}) == len({b for _, b in links}) \
            == len(links), s.name
    seen = [(p.src, p.dst) for p in all_links(schedules)]
    assert len(seen) == len(set(seen))
    n = math.prod(shape)
    assert len(seen) == sum(n * (1 if s == 2 else 2) for s in shape if s >= 2)
    p = all_links(schedules)[0]
    assert p.op == probe_op_name(p.src_coords, p.dst_coords)


def test_plan_edges_and_refusals_are_jaxs():
    (fwd, back) = plan_mesh_links((4,), ("x",))
    assert {(p.src, p.dst) for p in fwd.probes} == {(0, 1), (1, 2), (2, 3),
                                                   (3, 0)}
    assert fwd.name == "x[+1]" and back.name == "x[-1]"
    assert {s.name for s in plan_mesh_links((1, 4), ("dcn", "ici"))} == {
        "ici[+1]", "ici[-1]"}
    for bad, match in ((((),), "bad mesh shape"),
                       (((2, 4), ("x",)), "length mismatch")):
        with pytest.raises(ValueError, match=match):
            plan_mesh_links(*bad)
        with pytest.raises(ValueError, match=match):
            jlm.plan_mesh_links(*bad)
    with pytest.raises(ValueError, match=">= 2"):
        plan_all_pairs(1)


# --- the grader on crafted measurements, against JAX's --------------------


def _results(times, *, shape=(2, 4), axes=(), dead=(), nbytes=1024):
    """The same measurements as the port's and JAX's LinkMapResult: each
    link of the 2 x 4 neighbor plan with its samples (a dead link has
    none)."""
    out = []
    for mod in ("jax", "torch"):
        plan = (jlm.plan_mesh_links(shape, axes) if mod == "jax"
                else plan_mesh_links(shape, axes))
        PR = jlm.ProbeResult if mod == "jax" else ProbeResult
        LR = jlm.LinkMapResult if mod == "jax" else LinkMapResult
        probes = []
        for i, p in enumerate(all_links(plan) if mod == "torch"
                              else jlm.all_links(plan)):
            samples = [] if (p.src, p.dst) in dead else times(i, p)
            probes.append(PR(probe=p, rank=0, host="h", samples=samples,
                             dropped=3 if not samples else 0, first_run=1,
                             last_run=1, iters=1, nbytes=nbytes))
        out.append(LR(n=math.prod(shape), shape=shape,
                      axes=axes or ("ax0", "ax1"), nbytes=nbytes, iters=1,
                      runs=3, fence="block", concurrent=False,
                      synthetic=True, probes=probes))
    return out


def _noise(i):
    return 1e-4 * (1.0 + 1e-3 * ((i * 7919) % 13 - 6))


def _slow(links, factor):
    def times(i, p):
        t = _noise(i) * (factor if (p.src, p.dst) in links else 1.0)
        return [t, t * 1.0005, t * 0.9995]
    return times


def _spike(i, p):
    s = [1e-4] * 5
    if (p.src, p.dst) == (6, 7):
        s[2] = 30e-4
    return s


def _dcn(factor):
    def times(i, p):
        t = _noise(i) * (10.0 if p.axis == "dcn" else 1.0)
        return [t * (factor if (p.src, p.dst) == (1, 5) else 1.0)]
    return times


@pytest.mark.parametrize("times,kw,cfg", [
    (_slow((), 1.0), {}, {}),
    (_slow({(1, 2)}, 4.0), {}, {}),
    (_slow({(5, 6)}, 50.0), {"dead": {(2, 3)}}, {}),
    (_spike, {}, {}),
    (_dcn(1.0), {"axes": ("dcn", "ici")}, {}),
    (_dcn(4.0), {"axes": ("dcn", "ici")}, {}),
    (_slow((), 1.0), {}, {"roofline_gbps": 45.0}),
    (_slow((), 1.0), {"axes": ("dcn", "ici")},
     {"roofline_gbps": 0.02, "roofline_axes": ("ici",)}),
    (_dcn(1.0), {"axes": ("dcn", "ici")},
     {"roofline_gbps": 0.02, "dcn_roofline_gbps": 0.01}),
    (_slow({(0, 1)}, 1.6), {}, {"mad_z": 3.0, "rel_threshold": 0.1}),
], ids=["clean", "slow", "dead", "spike", "dcn-clean", "dcn-slow",
        "roofline", "roofline-axes", "dcn-roofline", "thresholds"])
def test_verdicts_are_jaxs(times, kw, cfg):
    theirs, ours = _results(times, **kw)
    want = [v.to_record().data for v in jlm.grade(theirs,
                                                  jlm.GradeConfig(**cfg))]
    got = [v.to_record().data for v in grade(ours, GradeConfig(**cfg))]
    assert got == want
    assert [r.to_record().data for r in ours.probes] == \
        [r.to_record().data for r in theirs.probes]
    assert ours.latency_matrix() == theirs.latency_matrix()
    assert ours.bandwidth_matrix() == theirs.bandwidth_matrix()


def test_grade_localizes_and_kills_as_jaxs_tests_say():
    _, ours = _results(_slow({(1, 2)}, 4.0))
    (v,) = [v for v in grade(ours) if v.verdict != "ok"]
    assert (v.src, v.dst, v.verdict, v.op) == (1, 2, "slow",
                                              "link:(0,1)>(0,2)")
    assert v.rel == pytest.approx(3.0, rel=0.05)
    _, ours = _results(_slow({(5, 6)}, 50.0), dead={(2, 3)})
    by = {(v.src, v.dst): v for v in grade(ours)}
    assert by[(2, 3)].verdict == "dead"
    assert by[(2, 3)].baseline_us == pytest.approx(100.0, rel=0.01)
    assert "dead ratio" in by[(5, 6)].detail


def test_mad_robust_z_is_jaxs():
    from tpu_perf.linkmap.grade import mad_robust_z as jz

    rng = np.random.default_rng(7)
    for _ in range(20):
        pop = list(rng.lognormal(0.0, 0.3, size=int(rng.integers(1, 12))))
        t = float(rng.lognormal(0.0, 0.6))
        assert mad_robust_z(t, pop, rel_threshold=0.25) == \
            jz(t, pop, rel_threshold=0.25)
    assert mad_robust_z(1.0, [], rel_threshold=0.25) == (None, None, None)
    assert mad_robust_z(2.0, [1.0, 1.0], rel_threshold=0.25)[0] == math.inf


@pytest.mark.parametrize("kw,match", [
    (dict(roofline_floor=1.5), "roofline_floor"),
    (dict(dead_ratio=0.5), "dead_ratio"),
    (dict(roofline_gbps=-1.0), "roofline_gbps"),
    (dict(dcn_roofline_gbps=-1.0), "dcn_roofline_gbps"),
    (dict(mad_z=0.0), "positive"),
])
def test_grade_config_refuses_as_jaxs(kw, match):
    with pytest.raises(ValueError, match=match):
        GradeConfig(**kw)
    with pytest.raises(ValueError, match=match):
        jlm.GradeConfig(**kw)


# --- records and rendering -------------------------------------------------


def test_linkmap_record_round_trip():
    rec = LinkmapRecord(record="probe", op="link:(0)>(1)", src=0, dst=1)
    assert LinkmapRecord.from_json(rec.to_csv()).data == rec.data
    assert rec.to_csv() == jlm.LinkmapRecord(**rec.data).to_csv()
    with pytest.raises(ValueError, match="discriminator"):
        LinkmapRecord(op="x")
    with pytest.raises(ValueError, match="not a linkmap record"):
        LinkmapRecord.from_json('{"op": "x"}')


def test_read_linkmap_replays_the_newest_sweep(tmp_path, capsys):
    import time as _time

    a = tmp_path / "linkmap-u-0-a.log"
    a.write_text(json.dumps({"record": "meta", "job_id": "x", "n": 2}) + "\n"
                 + json.dumps({"record": "verdict", "src": 0, "dst": 1,
                               "verdict": "ok"}) + "\n")
    b = tmp_path / "linkmap-u-0-b.log"
    b.write_text(json.dumps({"record": "meta", "job_id": "y", "n": 4}) + "\n"
                 + json.dumps({"record": "verdict", "src": 2, "dst": 3,
                               "verdict": "slow"}) + "\n")
    t = _time.time()
    os.utime(a, (t - 100, t - 100))
    os.utime(b, (t, t))
    got = read_linkmap([str(a), str(b)])
    assert got == jlm.read_linkmap([str(a), str(b)])
    assert got[0]["job_id"] == "y"
    assert "replaying the newest (job y)" in capsys.readouterr().err
    c = tmp_path / "linkmap-u-0-c.log"
    c.write_text(json.dumps({"record": "meta", "job_id": "z", "n": 2}) + "\n"
                 + json.dumps({"record": "meta", "job_id": "z", "n": 8})
                 + "\n")
    with pytest.raises(ValueError, match="disagreeing meta records"):
        read_linkmap([str(c)])
    with pytest.raises(ValueError, match="no meta record"):
        read_linkmap([])


def test_renderings_are_jaxs():
    theirs, ours = _results(_slow({(1, 2)}, 4.0), dead={(3, 0)})
    meta = jlm.meta_record(theirs, job_id="j", config=jlm.GradeConfig()).data
    verdicts = [v.to_record().data for v in grade(ours)]
    probes = [r.to_record().data for r in ours.probes]
    assert heatmap(8, verdicts) == jlm.heatmap(8, verdicts)
    assert verdicts_to_markdown(verdicts) == jlm.verdicts_to_markdown(verdicts)
    assert summary_line(verdicts) == jlm.summary_line(verdicts)
    assert linkmap_to_markdown(meta, verdicts) == \
        jlm.linkmap_to_markdown(meta, verdicts)
    assert linkmap_to_json(meta, probes, verdicts, diff={"x": 1}) == \
        jlm.linkmap_to_json(meta, probes, verdicts, diff={"x": 1})
    from tpu_perf_torch.linkmap import meta_record

    assert meta_record(ours, job_id="j", config=GradeConfig()).data == meta


def _verdict(src, dst, lat_us, verdict="ok", axis="ici"):
    return {"op": f"link:(0,{src})>(0,{dst})", "axis": axis, "src": src,
            "dst": dst, "lat_us": lat_us, "verdict": verdict}


@pytest.mark.parametrize("base,new,threshold", [
    ([_verdict(0, 1, 100.0), _verdict(1, 2, 100.0), _verdict(2, 3, 100.0),
      _verdict(3, 4, 100.0)],
     [_verdict(0, 1, 101.0), _verdict(1, 2, 140.0), _verdict(2, 3, 60.0),
      _verdict(3, 4, None, "dead")], 30.0),
    ([_verdict(0, 1, 100.0), _verdict(1, 2, 100.0)],
     [_verdict(1, 2, 100.0), _verdict(2, 3, 100.0)], 30.0),
    ([_verdict(0, 1, None, "dead"), _verdict(1, 2, 100.0, axis="dcn")],
     [_verdict(0, 1, 50.0), _verdict(1, 2, 111.0, axis="dcn")], 10.0),
], ids=["gate", "coverage", "incomparable"])
def test_link_diffs_are_jaxs(base, new, threshold):
    got = diff_linkmaps(base, new, threshold_pct=threshold)
    assert got == jlm.diff_linkmaps(base, new, threshold_pct=threshold)
    assert linkdiff_to_markdown(got) == jlm.linkdiff_to_markdown(got)
    assert linkdiff_summary(got, threshold) == \
        jlm.linkdiff_summary(got, threshold)


def test_diff_gate_and_artifact_loader(tmp_path):
    base = [_verdict(0, 1, 100.0), _verdict(3, 4, 100.0)]
    new = [_verdict(0, 1, 140.0), _verdict(3, 4, None, "dead")]
    by = {(d["src"], d["dst"]): d for d in diff_linkmaps(base, new)}
    assert by[(0, 1)]["diff"] == "degraded"
    assert by[(0, 1)]["delta_pct"] == pytest.approx(40.0)
    assert "died" in by[(3, 4)]["detail"]
    with pytest.raises(ValueError, match="positive"):
        diff_linkmaps(base, new, threshold_pct=0)
    p = tmp_path / "foreign.json"
    p.write_text('{"not": "a linkmap artifact"}')
    with pytest.raises(ValueError, match="artifact"):
        load_linkmap_artifact(str(p))


# --- the synthetic prober ---------------------------------------------------


def _pair(faults=(), seed=7, n=8, **kw):
    """The port's and JAX's synthetic probers on the same schedule."""
    kw.setdefault("nbytes", 65536)
    kw.setdefault("iters", 2)
    kw.setdefault("runs", 3)
    ours = LinkProber(None, injector=FaultInjector(
        [FaultSpec(**f) for f in faults], seed=seed, synthetic_s=1e-3),
        n_devices=n, **kw)
    theirs = jlm.LinkProber(None, injector=JInjector(
        [JFaultSpec(**f) for f in faults], seed=seed, synthetic_s=1e-3),
        n_devices=n, **kw)
    return ours, theirs


def _records(result):
    return [{k: v for k, v in r.to_record().data.items() if k != "host"}
            for r in result.probes]


@pytest.mark.parametrize("faults,plan", [
    ((), "mesh"),
    (({"kind": "delay", "op": "link:(1,2)>(1,3)", "rank": 0,
       "magnitude": 3.0},), "mesh"),
    (({"kind": "delay", "op": "link:(1,2)>(1,3)", "rank": 3,
       "magnitude": 3.0},), "mesh"),
    (({"kind": "drop_run", "op": "link:(0,0)>(0,1)"},), "mesh"),
    (({"kind": "spike", "op": "link:(2)>(5)", "magnitude": 30.0},), "pairs"),
    (({"kind": "jitter", "magnitude": 0.2, "shape": "pareto"},), "pairs"),
], ids=["clean", "rank0", "rank3", "drop", "spike-pair", "jitter"])
def test_synthetic_sweeps_are_jaxs(faults, plan):
    ours, theirs = _pair(faults)
    sched = plan_mesh_links((2, 4)) if plan == "mesh" else plan_all_pairs(8)
    jsched = (jlm.plan_mesh_links((2, 4)) if plan == "mesh"
              else jlm.plan_all_pairs(8))
    got, want = ours.probe(sched), theirs.probe(jsched)
    assert _records(got) == _records(want)
    assert [v.to_record().data for v in grade(got)] == \
        [v.to_record().data for v in jlm.grade(want)]


def test_synthetic_prober_is_deterministic_and_localizes():
    plan = plan_mesh_links((2, 4))
    a, _ = _pair()
    b, _ = _pair()
    c, _ = _pair(seed=8)
    ra, rb, rc = a.probe(plan), b.probe(plan), c.probe(plan)
    assert len(ra.probes) == 24 and all(len(r.samples) == 3
                                        for r in ra.probes)
    assert [r.samples for r in ra.probes] == [r.samples for r in rb.probes]
    assert [r.samples for r in ra.probes] != [r.samples for r in rc.probes]
    r0 = ra.probes[0]
    assert ra.latency_matrix()[r0.probe.src][r0.probe.dst] == \
        pytest.approx(sum(r0.samples) / 3 / 2)
    target = probe_op_name((1, 2), (1, 3))
    ours, _ = _pair([{"kind": "delay", "op": target, "rank": 0,
                      "magnitude": 3.0}])
    sick = [v for v in grade(ours.probe(plan)) if v.verdict != "ok"]
    assert [(v.op, v.verdict, v.rank) for v in sick] == [(target, "slow", 0)]


def test_probe_nbytes_rounding_is_consistent_everywhere():
    target = probe_op_name((0,), (1,))
    ours, _ = _pair([{"kind": "delay", "op": target, "nbytes": 16,
                      "magnitude": 3.0}], nbytes=9, dtype="float64")
    result = ours.probe(plan_mesh_links((8,)))
    assert result.nbytes == 16 and all(r.nbytes == 16 for r in result.probes)
    assert [v.op for v in grade(result) if v.verdict != "ok"] == [target]


def test_prober_refusals_are_jaxs():
    with pytest.raises(ValueError, match="n_devices"):
        LinkProber(None, injector=FaultInjector([], synthetic_s=1e-3),
                   nbytes=1024)
    with pytest.raises(ValueError, match="world is required"):
        LinkProber(None, nbytes=1024, n_devices=8)
    for kw, match in ((dict(fence="slope"), "fence"), (dict(runs=0), "runs"),
                      (dict(iters=0), "iters"),
                      (dict(precompile=-1), "precompile")):
        with pytest.raises(ValueError, match=match):
            _pair(**kw)
    with pytest.raises(ValueError, match="dtype"):
        _pair(dtype="nonsense")
    with pytest.raises(ValueError, match="dtype"):
        LinkProber(SimWorld(8, CPU), nbytes=1024, dtype="float64")


# --- real probes: the sim world's ppermute against JAX's ------------------


@pytest.mark.parametrize("perm,iters,dtype", [
    ([(1, 2)], 1, "float32"),
    ([(1, 2)], 3, "float32"),
    ([(5, 5)], 4, "int32"),
    ("x[+1]", 3, "float32"),
    ("x[-1]", 2, "bfloat16"),
    ("pairs[0]", 2, "float32"),
    ("pairs[3]", 1, "int32"),
])
def test_real_probe_outputs_are_jaxs(perm, iters, dtype, eight_devices):
    import jax.numpy as jnp

    from tpu_perf.parallel import make_mesh as jmesh
    from tpu_perf_torch.world import from_world

    if isinstance(perm, str):
        plans = {s.name: s.perm() for s in (plan_mesh_links((8,), ("x",))
                                            + plan_all_pairs(8))}
        perm = plans[perm]
    ours = LinkProber(SimWorld(8, CPU), nbytes=1000, iters=iters,
                      dtype=dtype)
    theirs = jlm.LinkProber(jmesh((8,), ("x",)), nbytes=1000, iters=iters,
                            dtype=dtype)
    step = theirs._build_step(perm)
    want = np.asarray(step(theirs._example).astype(jnp.float32))
    got = from_world(ours.step(perm)(ours.example_input()))
    np.testing.assert_array_equal(got, want)
    assert ours.nbytes == theirs.nbytes


def test_a_real_sweep_has_jaxs_records_and_shape(eight_devices):
    from tpu_perf.parallel import make_mesh as jmesh

    plan = plan_mesh_links((2, 4), ("a", "b"))
    world = SimWorld(8, CPU, make_mesh((2, 4), ("a", "b"), n=8))
    got = LinkProber(world, nbytes=1024, iters=1, runs=2).probe(plan)
    want = jlm.LinkProber(jmesh((2, 4), ("a", "b")), nbytes=1024, iters=1,
                          runs=2).probe(jlm.plan_mesh_links((2, 4),
                                                            ("a", "b")))
    assert (got.shape, got.axes, got.n, len(got.probes)) == \
        (want.shape, want.axes, want.n, len(want.probes)) == \
        ((2, 4), ("a", "b"), 8, 24)
    for g, w in zip(got.probes, want.probes):
        assert g.probe == w.probe or g.probe.op == w.probe.op
        assert len(g.samples) == len(w.samples) == 2
        assert all(t > 0 for t in g.samples)
        assert sorted(g.to_record().data) == sorted(w.to_record().data)
    cfg = GradeConfig(mad_z=1e9, rel_threshold=1e6, dead_ratio=1e9)
    assert all(v.verdict == "ok" for v in grade(got, cfg))


def test_a_concurrent_sweep_attributes_each_batch_to_its_schedule():
    world = SimWorld(8, CPU)
    result = LinkProber(world, nbytes=1024, iters=1, runs=2).probe(
        plan_mesh_links((8,), ("x",)), concurrent=True)
    assert result.concurrent and len(result.probes) == 16
    by_sched: dict[int, set] = {}
    for r in result.probes:
        by_sched.setdefault(r.probe.shift, set()).add(tuple(r.samples))
    assert all(len(v) == 1 for v in by_sched.values())


def test_bisection_re_probes_the_flagged_link_serially():
    target = probe_op_name((3,), (5,))
    prober = LinkProber(SimWorld(8, CPU), nbytes=1024, iters=1, runs=3,
                        injector=FaultInjector([FaultSpec(
                            kind="delay", op=target, magnitude=99.0)]))
    plan = plan_all_pairs(8)
    result = prober.probe(plan, concurrent=True)
    batch_end = 3 * len(plan)
    merged, flagged = prober.bisect_flagged(result)
    assert flagged >= 1 and merged.concurrent
    by = {r.probe.op: r for r in merged.probes}
    assert by[target].first_run > batch_end and len(by[target].samples) == 3
    assert {v.op: v.verdict for v in grade(merged)}[target] == "dead"
    # a serial result and a clean one are left alone
    assert prober.bisect_flagged(prober.probe(plan[:1]))[1] == 0


class _BatchBound(LinkProber):
    """A prober on a loaded host: a concurrent batch's wall is 20 times a
    serial probe's (the batch moves its links one after another on
    shared engines, and the host is busy)."""

    _batch = False

    def _probe_concurrent(self, *args, **kw):
        self._batch = True
        try:
            return super()._probe_concurrent(*args, **kw)
        finally:
            self._batch = False

    def _timed(self, step) -> float:
        step(self.example_input())
        return 20e-6 if self._batch else 1e-6


@pytest.mark.parametrize("n,link", [(2, (1, 0)), (3, (1, 2)), (8, (3, 5))])
def test_bisection_grades_the_re_probed_link_against_serial_peers(n, link):
    """The planted 100x link, re-probed serially, is graded against peers
    re-probed the same way: dead, where its serial samples against the
    peers' batch bounds (20x a serial probe) would read 5x, slow."""
    target = probe_op_name((link[0],), (link[1],))
    prober = _BatchBound(SimWorld(n, CPU), nbytes=64, iters=1, runs=3,
                         injector=FaultInjector([FaultSpec(
                             kind="delay", op=target, magnitude=99.0)]))
    plan = plan_all_pairs(n)
    result = prober.probe(plan, concurrent=True)
    merged, flagged = prober.bisect_flagged(result)
    assert flagged == 1
    verdicts = {(v.src, v.dst): v.verdict for v in grade(merged)}
    assert verdicts.pop(link) == "dead"
    assert set(verdicts.values()) == {"ok"}
    serial = {(r.probe.src, r.probe.dst) for r in merged.probes
              if r.first_run > 3 * len(plan)}
    from tpu_perf_torch.linkmap.grade import peer_links
    assert serial == {link} | peer_links(result, {link})
    assert len(serial) < len(merged.probes) or n < 4
    # batch bounds alone under the re-probed link: it reads 5x, slow
    only = dataclasses.replace(merged, probes=[
        r if (r.probe.src, r.probe.dst) == link else
        next(q for q in result.probes if q.probe == r.probe)
        for r in merged.probes])
    assert {(v.src, v.dst): v.verdict for v in grade(only)}[link] == "slow"


class _Ramp(LinkProber):
    """A prober whose steps ramp like a new gloo or NCCL channel: each
    step's first three exchanges take 50x the steady time."""

    def _timed(self, step) -> float:
        step(self.example_input())
        self._calls[id(step)] = self._calls.get(id(step), 0) + 1
        return 50e-6 if self._calls[id(step)] <= 3 else 1e-6


def test_each_probe_warms_up_past_the_channels_ramp():
    prober = _Ramp(SimWorld(4, CPU), nbytes=64, iters=1, runs=3)
    prober._calls = {}
    result = prober.probe(plan_all_pairs(4))
    assert {t for r in result.probes for t in r.samples} == {1e-6}
    assert {v.verdict for v in grade(result)} == {"ok"}


def test_precompile_walks_the_serial_order_on_host_halves():
    plan = plan_mesh_links((2, 4))
    world = SimWorld(8, CPU)
    serial = LinkProber(world, nbytes=256, iters=2, runs=2).probe(plan)
    piped = LinkProber(world, nbytes=256, iters=2, runs=2,
                       precompile=3).probe(plan)
    assert [(r.probe.op, r.first_run, r.last_run, len(r.samples))
            for r in piped.probes] == \
        [(r.probe.op, r.first_run, r.last_run, len(r.samples))
         for r in serial.probes]
    conc = LinkProber(world, nbytes=256, iters=2, runs=2,
                      precompile=2).probe(plan, concurrent=True)
    assert len(conc.probes) == 24


# --- the CLI twins ---------------------------------------------------------


def _sweep(main, folder, extra, capsys):
    rc = main(["linkmap", "--mesh", "2x4", "--synthetic", "0.001", "--seed",
               "7", "-b", "64K", "-l", str(folder), *extra])
    return rc, capsys.readouterr().out


def _logs(folder, prefix, drop=("job_id", "host", "timestamp")):
    out = []
    for p in sorted(folder.glob(f"{prefix}-*.log")):
        for ln in p.read_text().splitlines():
            out.append({k: v for k, v in json.loads(ln).items()
                        if k not in drop})
    return out


FAULT_JSON = {"faults": [{"kind": "spike", "op": "link:(1,2)>(1,3)",
                          "rank": 0, "magnitude": 30.0}]}


@pytest.mark.parametrize("extra,rc", [
    ([], 0),
    (["--faults", "@spec"], 6),
    (["--fault", "drop_run:link:(0,1)>(0,2)"], 6),
    (["--fault", "spike:link:(1,2)>(1,3):0:1-:30"], 6),
    (["--all-pairs"], 0),
    (["--all-pairs", "--fault", "delay:link:(2)>(6)::1-:3.0"], 6),
    (["--concurrent", "--format", "json"], 0),
    (["--no-wrap", "--roofline-gbps", "0"], 0),
    (["--roofline-gbps", "100"], 6),
    (["--axes", "dcn,ici", "--dcn-roofline-gbps", "0.001",
      "--rel-threshold", "0.5", "--mad-z", "4", "--dead-ratio", "3"], 0),
    (["--format", "json", "--fault", "delay:link:(0,0)>(1,0)::4-9:11"], 6),
], ids=["clean", "spec", "drop", "inline", "pairs", "pairs-delay",
        "concurrent", "no-wrap", "roofline", "knobs", "json-window"])
def test_synthetic_sweeps_match_jaxs_cli(tmp_path, capsys, extra, rc):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(FAULT_JSON))
    extra = [str(spec) if a == "@spec" else a for a in extra]
    jrc, jout = _sweep(jcli.main, tmp_path / "jax", extra, capsys)
    trc, tout = _sweep(cli.main, tmp_path / "torch", extra, capsys)
    assert trc == jrc == rc
    assert tout == jout.replace(
        json.loads(jout)["meta"]["job_id"] if "--format" in extra else "\0",
        json.loads(tout)["meta"]["job_id"] if "--format" in extra else "\0")
    for prefix in ("linkmap", "health"):
        assert _logs(tmp_path / "torch", prefix) == \
            _logs(tmp_path / "jax", prefix)
    if rc == 6:
        assert _logs(tmp_path / "torch", "health")
    # the replay renders what the live sweep printed, exit code and all
    for fmt in ("markdown", "json"):
        assert cli.main(["linkmap", "report", str(tmp_path / "torch"),
                         "--format", fmt]) == rc
        mine = capsys.readouterr().out
        assert jcli.main(["linkmap", "report", str(tmp_path / "torch"),
                          "--format", fmt]) == rc
        assert mine == capsys.readouterr().out


def test_report_diff_and_refusals_match_jaxs(tmp_path, capsys):
    rc, out = _sweep(cli.main, tmp_path / "base", ["--format", "json"],
                     capsys)
    base = tmp_path / "base.json"
    base.write_text(out)
    _sweep(cli.main, tmp_path / "new",
           ["--fault", "delay:link:(1,1)>(1,2)::1-:0.5"], capsys)
    for main in (cli.main, jcli.main):
        for fmt in ("markdown", "json"):
            assert main(["linkmap", "report", str(tmp_path / "new"),
                         "--diff", str(base), "--format", fmt]) == 6
        assert main(["linkmap", "report", str(tmp_path / "new"), "--diff",
                     str(tmp_path / "none.json")]) == 2
        assert main(["linkmap", "report", str(tmp_path / "empty")]) == 1
        assert main(["linkmap", "--mesh", "2x4", "--synthetic", "0.001",
                     "--roofline-gbps", "-5"]) == 2
        assert main(["linkmap", "--synthetic", "0.001"]) == 2
        assert main(["linkmap", "--mesh", "2x2", "--synthetic", "0.001",
                     "--spans"]) == 2
    err = capsys.readouterr().err
    assert "--mesh" in err and "--roofline-gbps" in err
    (tmp_path / "torn").mkdir()
    (tmp_path / "torn" / "linkmap-u-0-a.log.open").write_text(
        json.dumps({"record": "meta", "job_id": "x", "n": 8}) + "\n"
        + json.dumps({"record": "probe", "src": 0, "dst": 1}) + "\n")
    assert cli.main(["linkmap", "report", str(tmp_path / "torn")]) == 1
    assert "no verdict records" in capsys.readouterr().err


def test_a_skew_fault_is_refused_as_jax_refuses_it(tmp_path, capsys):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"faults": [{"kind": "skew"}]}))
    for main in (cli.main, jcli.main):
        assert main(["linkmap", "--mesh", "2x4", "--synthetic", "0.001",
                     "--faults", str(spec)]) == 2
        assert "skew faults apply to the run loop" in \
            capsys.readouterr().err


def test_a_multi_sweep_folder_replays_the_newest(tmp_path, capsys):
    import time as _time

    _sweep(cli.main, tmp_path / "logs", [], capsys)
    _sweep(cli.main, tmp_path / "logs",
           ["--fault", "drop_run:link:(0,1)>(0,2)"], capsys)
    logs = sorted((tmp_path / "logs").glob("linkmap-*.log"),
                  key=lambda p: p.stat().st_mtime)
    t = _time.time()
    os.utime(logs[0], (t - 100, t - 100))
    os.utime(logs[1], (t, t))
    assert cli.main(["linkmap", "report", str(tmp_path / "logs")]) == 6
    cap = capsys.readouterr()
    assert "1 dead" in cap.out
    assert "2 linkmap sweeps found; replaying the newest" in cap.err


def test_traced_sweeps_join_their_schedule_spans(tmp_path, capsys):
    from tpu_perf_torch.spans import read_span_records

    for main, sub in ((cli.main, "t"), (jcli.main, "j")):
        assert main(["linkmap", "--mesh", "2x2", "--synthetic", "0.001",
                     "--seed", "7", "-b", "4K", "-l", str(tmp_path / sub),
                     "--spans", "--fault",
                     "drop_run:link:(0,0)>(0,1)"]) == 6
    (slog,) = (tmp_path / "t").glob("spans-*.log")
    scheds = {s["span_id"] for s in read_span_records([str(slog)])
              if s["kind"] == "probe_schedule"}
    probes = [r for r in _logs(tmp_path / "t", "linkmap")
              if r["record"] == "probe"]
    assert scheds and all(p["span_id"] in scheds for p in probes)
    assert _logs(tmp_path / "t", "linkmap") == _logs(tmp_path / "j",
                                                     "linkmap")
    (event,) = _logs(tmp_path / "t", "health")
    assert event["span_id"] in scheds
    assert cli.main(["linkmap", "--mesh", "2x2", "--synthetic", "0.001",
                     "-l", str(tmp_path / "plain")]) == 0
    assert all("span_id" not in r for r in _logs(tmp_path / "plain",
                                                 "linkmap"))


# --- real sweeps through the CLI, the default roofline, the ingest ---------


def test_a_real_cpu_sweep_grades_by_its_peers(tmp_path, capsys):
    rc = cli.main(["linkmap", "--mesh", "2x4", "-b", "4K", "-i", "2", "-r",
                   "2", "--device", "cpu", "--precompile", "2", "-l",
                   str(tmp_path), "--format", "json"])
    cap = capsys.readouterr()
    data = json.loads(cap.out)
    assert rc == (6 if any(v["verdict"] != "ok" for v in data["verdicts"])
                  else 0)
    assert len(data["probes"]) == 24 and len(data["verdicts"]) == 24
    assert data["meta"]["roofline_gbps"] is None
    assert data["meta"]["synthetic"] is False
    assert "no default roofline" in cap.err
    assert len(list(tmp_path.glob("linkmap-*.log"))) == 1


def _roofline(argv, world):
    from tpu_perf_torch.cli import _linkmap_roofline, build_parser

    args = build_parser().parse_args(["linkmap", *argv])
    axes = world.mesh.axis_names if world is not None else ("x",)
    return _linkmap_roofline(args, world, axes)


def test_the_default_roofline_follows_jaxs_rule(monkeypatch, capsys):
    from tpu_perf_torch import chips

    monkeypatch.setattr(chips, "detected_name",
                        lambda: "NVIDIA H100 80GB HBM3")
    gpu = torch.device("cuda", 0)

    def dist(shape=(4,), axes=("x",)):
        return DistWorld(rank=0, n=math.prod(shape), local_rank=0,
                         device=gpu, mesh=make_mesh(shape, axes,
                                                    n=math.prod(shape)))

    assert _roofline([], dist()) == (450.0, None)
    assert _roofline([], dist((2, 2), ("dcn", "ici"))) == (450.0, ("ici",))
    assert _roofline([], dist((2, 2), ("dcn", "dcn2"))) == (None, None)
    assert _roofline(["--all-pairs"], dist()) == (None, None)
    assert _roofline(["--roofline-gbps", "0"], dist()) == (None, None)
    assert _roofline(["--roofline-gbps", "12"], dist()) == (12.0, None)
    assert _roofline([], None) == (None, None)  # synthetic: no world
    capsys.readouterr()
    assert _roofline([], SimWorld(8, CPU, make_mesh(n=8))) == (None, None)
    assert "memory copy" in capsys.readouterr().err
    monkeypatch.setattr(chips, "detected_name", lambda: "NVIDIA A100")
    with pytest.raises(chips.UnknownCardError):
        _roofline([], dist())
    assert chips.CARDS["h100-sxm"].nvlink_gbps == 450.0
    assert all(c.nvlink_gbps for c in chips.CARDS.values())


def test_the_families_route_as_jaxs(tmp_path):
    from tpu_perf.ingest import pipeline as jpl
    from tpu_perf.push.sinks import PUSH_ROUTES as JROUTES
    from tpu_perf.schema import ALL_PREFIXES as JALL
    from tpu_perf.schema import FLEET_PREFIX as JF
    from tpu_perf.schema import LINKMAP_PREFIX as JL
    from tpu_perf.schema import TUNE_PREFIX as JT
    from tpu_perf_torch.ingest import pipeline as pl
    from tpu_perf_torch.push.sinks import PUSH_ROUTES
    from tpu_perf_torch.schema import (
        ALL_PREFIXES, FLEET_PREFIX, LINKMAP_PREFIX, TUNE_PREFIX,
    )

    assert (LINKMAP_PREFIX, TUNE_PREFIX, FLEET_PREFIX) == (JL, JT, JF)
    assert ALL_PREFIXES == JALL  # the fleet family included
    assert (pl.LINKMAP_TABLE, pl.TUNE_TABLE, pl.FLEET_TABLE) == (
        jpl.LINKMAP_TABLE, jpl.TUNE_TABLE, jpl.FLEET_TABLE)
    assert PUSH_ROUTES[LINKMAP_PREFIX] == pl.LINKMAP_TABLE
    assert PUSH_ROUTES[TUNE_PREFIX] == pl.TUNE_TABLE
    assert PUSH_ROUTES == JROUTES

    class Spy:
        def __init__(self):
            self.paths = []

        def ingest(self, path):
            self.paths.append(path)

    for name in ("linkmap-u-0-a.log", "tune-u-0-a.log", "fleet-u-0-a.log"):
        (tmp_path / name).write_text('{"record": "meta"}\n')
    (tmp_path / "linkmap-u-0-b.log.open").write_text('{"record": "meta"}\n')
    spy = Spy()
    assert pl.run_all_ingest_passes(str(tmp_path), skip_newest=5,
                                    backend=spy) == 3
    assert sorted(p.split("/")[-1] for p in spy.paths) == [
        "fleet-u-0-a.log", "linkmap-u-0-a.log", "tune-u-0-a.log"]


def test_a_link_event_is_jaxs(tmp_path):
    from tpu_perf.health import HealthConfig as JConfig
    from tpu_perf.health import HealthMonitor as JMonitor
    from tpu_perf_torch.health import HealthConfig, HealthMonitor

    import io

    got = HealthMonitor(HealthConfig(), job_id="j", dtype="float32",
                        err=io.StringIO()).observe_link(
        "link:(0)>(1)", 4096, 7, 2e-3, 1e-4, severity="critical", rank=3,
        span_id="s1")
    want = JMonitor(JConfig(), job_id="j", dtype="float32",
                    err=io.StringIO()).observe_link(
        "link:(0)>(1)", 4096, 7, 2e-3, 1e-4, severity="critical", rank=3,
        span_id="s1")
    drop = lambda e: {k: v for k, v in json.loads(e.to_csv()).items()
                      if k != "timestamp"}
    assert [drop(e) for e in got] == [drop(e) for e in want]
    assert got[0].kind == "link_degraded" and got[0].rank == 3


# --- a gloo world of 3 processes ------------------------------------------

#: each sample 20 chained 4 KiB messages (~2-3 ms on gloo, longer than a
#: loaded host's scheduling stalls), 5 a link
RUNS = 5
_WORKER = f"""
import sys
from tpu_perf_torch import cli
sys.exit(cli.main(["linkmap", "--distributed", "--device", "cpu",
                   "--all-pairs", "-b", "4K", "-i", "20", "-r", "{RUNS}",
                   "--concurrent", "-l", sys.argv[1], "--fault",
                   f"delay:{{sys.argv[2]}}::1-:99"]))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tails(procs, outs) -> str:
    """Every rank's exit code and the tail of its stderr, for a failure."""
    return "\n".join(f"rank {r} rc {p.returncode}:\n{err[-2000:]}"
                     for r, (p, (_, err)) in enumerate(zip(procs, outs)))


@pytest.mark.parametrize("n,link", [(2, (1, 0)), (3, (1, 2))])
def test_a_gloo_world_grades_alike_and_rank_0_writes(tmp_path, n, link):
    """Two or three processes, every ordered pair a link (at three each
    round leaves one rank out, which posts nothing and still meets the
    reduction); a planted delay on one link: every rank exits 6, rank 0
    alone prints and writes the sweep's records and the link's event, and
    the link, re-probed serially after the concurrent rounds, is graded
    dead with its owner's rank."""
    logs = tmp_path / "logs"
    op = probe_op_name((link[0],), (link[1],))
    port = _free_port()
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(logs), op], cwd=REPO,
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [6] * n, _tails(procs, outs)
    assert all(out == "" for out, _ in outs[1:])  # rank 0 alone prints
    files = sorted(p.name for p in logs.iterdir())
    assert all(f.split("-")[-3] == "0" for f in files), files
    recs = _logs(logs, "linkmap", drop=())
    meta = [r for r in recs if r["record"] == "meta"]
    verdicts = {(v["src"], v["dst"]): v for v in recs
                if v["record"] == "verdict"}
    assert len(meta) == 1 and meta[0]["concurrent"] and meta[0]["n"] == n
    assert sorted(verdicts) == [(i, j) for i in range(n) for j in range(n)
                                if i != j]
    probes = [r for r in recs if r["record"] == "probe"]
    evidence = json.dumps({"verdicts": list(verdicts.values()),
                           "probes": probes}, indent=1)
    assert verdicts[link]["verdict"] == "dead", evidence
    assert verdicts[link]["rank"] == 1 and verdicts[link]["host"] == "rank1"
    probe = next(r for r in probes if (r["src"], r["dst"]) == link)
    assert probe["first_run"] > RUNS * len(plan_all_pairs(n)), evidence
    events = _logs(logs, "health", drop=())
    assert [(e["op"], e["rank"], e["severity"]) for e in events
            if e["op"] == op] == [(op, 1, "critical")]
