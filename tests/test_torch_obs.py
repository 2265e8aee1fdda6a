"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``, on the CPU.

Under test: the metrics registry (counters, gauges, log-bucketed
histograms, Prometheus text, snapshots, export/restore, watermarks), the
sinks, the phase profiler, the lifecycle spans, the hub, and an observed
``FleetServer``.  Both copies are fed the same operations, with the same
values and timestamps made from a seed; every export must be equal.
Where a value is wall-clock (a span or phase timed on the host, a sink
write's timestamp) it is masked and only its count compared.  An observed
server publishes states bit-identical to an unobserved one.

The program spans (``obs.span``, the port's own): nothing recorded and
the shared no-op timer without a profiler; under a CPU profiler nested
spans with their parents and counts, on the profiler's clock (a span
brackets the operator it holds), no dispatcher operator run, a cap; a
CPU census records one ``fleet.run`` with its chunks and the same carry.
"""
import json
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import HookConfig as JHookConfig
from repro.core import Mechanism as JMechanism
from repro.core import prepare as jprepare
from repro.core import programs as jprograms
from repro.obs import ObsHub as JObsHub
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import make_sink as jmake_sink
from repro.obs.metrics import _bucket_index as j_bucket_index
from repro.obs.metrics import _bucket_upper as j_bucket_upper
from repro.obs.profiler import PhaseProfiler as JPhaseProfiler
from repro.obs.spans import SpanTracker as JSpanTracker
from repro.sched import PolicyScheduler as JPolicyScheduler
from repro.sched import TenantBudget as JTenantBudget
from repro.serve.fleet_server import FleetServer as JFleetServer

from repro_torch import obs
from repro_torch.core import HookConfig, Mechanism, prepare, programs
from repro_torch.core import fleet, runtime
from repro_torch.kernels.megastep import ops as mops
from repro_torch.obs import (NULL_TIMER, PHASES, MetricsRegistry, ObsHub,
                             make_sink, now, phase as obs_phase)
from repro_torch.obs.metrics import (JsonlSink, MemorySink, PromFileSink,
                                     _bucket_index, _bucket_upper)
from repro_torch.obs.profiler import PhaseProfiler
from repro_torch.obs.spans import SpanTracker
from repro_torch.sched import PolicyScheduler, TenantBudget
from repro_torch.serve.fleet_server import FleetServer

FUEL = 25_000
SEEDS = [0, 1, 2]


def _feed_registry(reg, seed):
    """One operation sequence from ``seed``: counter and gauge series
    with labels, histogram observations over 12 decades."""
    rng = np.random.default_rng(seed)
    for i in range(300):
        op = int(rng.integers(3))
        labels = {} if rng.random() < 0.3 else {
            "tenant": ["a", "b", 'q"x'][int(rng.integers(3))]}
        if op == 0:
            reg.counter(f"c{int(rng.integers(3))}_total", "a counter").inc(
                int(rng.integers(1, 5)), **labels)
        elif op == 1:
            reg.gauge(f"g{int(rng.integers(2))}", "a gauge").set(
                float(rng.normal()), **labels)
        else:
            reg.histogram(f"h{int(rng.integers(2))}_seconds", "").observe(
                float(10 ** rng.uniform(-9, 3)), **labels)
    return reg


@pytest.mark.parametrize("seed", SEEDS)
def test_registry_exports_match_jax(seed):
    """Prometheus text, the JSON snapshot, the full export, the counter
    watermark and a restore round trip: equal to the JAX package's."""
    j = _feed_registry(JMetricsRegistry(), seed)
    t = _feed_registry(MetricsRegistry(), seed)
    assert j.render_prometheus() == t.render_prometheus()
    assert j.snapshot() == t.snapshot()
    assert j.export() == t.export()
    assert j.counter_watermark() == t.counter_watermark()
    jb, tb = JMetricsRegistry(), MetricsRegistry()
    jb.restore(j.export())
    tb.restore(t.export())
    assert jb.render_prometheus() == tb.render_prometheus() \
        == t.render_prometheus()
    # a low registry raised to the watermark, series it never saw included
    jl = _feed_registry(JMetricsRegistry(), seed + 100)
    tl = _feed_registry(MetricsRegistry(), seed + 100)
    jl.apply_watermark(j.counter_watermark())
    tl.apply_watermark(t.counter_watermark())
    assert jl.render_prometheus() == tl.render_prometheus()


def test_histogram_buckets_and_quantiles_match_jax():
    vals = np.concatenate([[0.0, 1e-7, 1.5e-7], 10 ** np.linspace(-9, 6, 97)])
    for v in vals:
        assert _bucket_index(float(v)) == j_bucket_index(float(v))
    for i in range(0, 352, 7):
        assert _bucket_upper(i) == j_bucket_upper(i)
    j, t = JMetricsRegistry(), MetricsRegistry()
    for v in vals:
        j.histogram("lat", "").observe(float(v))
        t.histogram("lat", "").observe(float(v))
    assert j.histogram("lat").summary() == t.histogram("lat").summary()
    s = t.histogram("lat").summary()
    assert s["p50"] <= s["p95"] <= s["p99"] <= s["max"]


def test_kind_conflict_raises():
    reg = MetricsRegistry()
    reg.counter("x_total")
    with pytest.raises(TypeError):
        reg.gauge("x_total")


def test_profiler_and_spans_match_jax():
    """The profiler and the span tracker fed the same durations and
    timestamps: breakdowns, summaries, exports and the registry they
    write are equal."""
    rng = np.random.default_rng(7)
    jreg, treg = JMetricsRegistry(), MetricsRegistry()
    jp, tp = JPhaseProfiler(jreg), PhaseProfiler(treg)
    js, ts = JSpanTracker(jreg), SpanTracker(treg)
    for _ in range(50):
        dt = float(rng.uniform(1e-5, 1e-2))
        name = PHASES[int(rng.integers(len(PHASES)))]
        jp.record(name, dt)
        tp.record(name, dt)
        if rng.random() < 0.2:
            jp.record_generation(dt * 4)
            tp.record_generation(dt * 4)
    assert jp.breakdown() == tp.breakdown()
    assert jp.export() == tp.export()
    t0 = 1000.0
    events = ["admit", "preempt", "resume", "c3_readmit", "complete"]
    for rid in range(12):
        tenant = ["a", "b"][rid % 2]
        t = t0 + rid
        js.submit(str(rid), tenant, t)
        ts.submit(str(rid), tenant, t)
        for ev in events[: 1 + rid % 5]:
            t += float(rng.uniform(0.01, 1.0))
            js.event(str(rid), ev, tenant, t)
            ts.event(str(rid), ev, tenant, t)
        if rid % 4 == 0:        # at-least-once: a duplicate complete
            js.event(str(rid), "complete", tenant, t + 5)
            ts.event(str(rid), "complete", tenant, t + 5)
    js.event("99", "shed", "a", t0)
    ts.event("99", "shed", "a", t0)
    assert js.summary() == ts.summary()
    assert js.open_count == ts.open_count
    assert jreg.render_prometheus() == treg.render_prometheus()
    ex_j, ex_t = js.export(), ts.export()
    assert ex_j["done"] == ex_t["done"]
    assert sorted(ex_j["open"]) == sorted(ex_t["open"])


def test_hub_phase_timer_and_null_path():
    hub = ObsHub()
    with pytest.raises(RuntimeError):
        with hub.phase("harvest"):
            raise RuntimeError("boom")
    assert hub.profiler.counts["harvest"] == 1
    with hub.phase("snapshot_write"):
        assert hub.profiler.export()["counts"]["snapshot_write"] == 1
    assert obs_phase(None, "harvest") is obs_phase(None, "dispatch")
    wm = hub.watermark()
    back = ObsHub()
    back.apply_watermark(wm)
    assert back.profiler.counts["harvest"] == 1
    assert set(back.export()) == set(JObsHub().export())
    assert set(wm) == set(JObsHub().watermark())


def _mask_prom(text):
    """Prometheus text with the wall-clock histograms reduced to their
    counts (bucket and sum lines dropped)."""
    return [ln for ln in text.splitlines()
            if not re.match(r"\w+_seconds_(bucket|sum)", ln)]


def test_sinks_write_what_jax_writes(tmp_path):
    j = _feed_registry(JMetricsRegistry(), 3)
    t = _feed_registry(MetricsRegistry(), 3)
    for name in ("a", "b"):
        for reg, pkg in ((j, "jax"), (t, "torch")):
            sink = (jmake_sink if pkg == "jax" else make_sink)(
                f"jsonl:{tmp_path / pkg / name}.jsonl")
            sink.write(reg, 1.5)
            sink.write(reg, 2.5)
            psink = (jmake_sink if pkg == "jax" else make_sink)(
                f"prom:{tmp_path / pkg / name}.prom")
            psink.write(reg, 1.5)
    for ext in ("jsonl", "prom"):
        a = (tmp_path / "jax" / f"a.{ext}").read_text()
        assert a == (tmp_path / "torch" / f"a.{ext}").read_text()
    mem = MemorySink(cap=2)
    for i in range(4):
        mem.write(t, float(i))
    assert [s["ts"] for s in mem.snapshots] == [2.0, 3.0]
    assert isinstance(make_sink("x.jsonl"), JsonlSink)
    assert isinstance(make_sink("prom:x.prom"), PromFileSink)
    assert make_sink("") is None
    with pytest.raises(ValueError, match="carrier-pigeon"):
        make_sink("carrier-pigeon")


# -- the observed server ------------------------------------------------------

def _serve(FleetServer_, HookConfig_, prepare_, programs_, Mechanism_,
           PolicyScheduler_, TenantBudget_, obs, **kw):
    """A traced, scheduled server: two tenants, a budget that evicts,
    one C3 request; returns (server, results in publication order)."""
    getpid = prepare_(programs_.getpid_loop_param(), Mechanism_.ASC,
                      virtualize=True)
    storm = prepare_(programs_.syscall_storm_param(), Mechanism_.ASC,
                     virtualize=True)
    srv = FleetServer_(pool=2, gen_steps=40, chunk=8, fuel=FUEL, trace=True,
                       cfg=HookConfig_(obs_enabled=obs, trace_enabled=True),
                       scheduler=PolicyScheduler_(
                           budgets={"b": TenantBudget_(max_svc=6)}), **kw)
    for i in range(2):
        srv.submit(getpid, regs={19: 2 + i}, tenant="a")
        srv.submit(storm, regs={19: 4, 20: 2, 21: 2}, tenant="b")
    srv.submit(lambda: programs_.indirect_svc(2), virtualize=True,
               tenant="a")
    return srv, srv.run(max_generations=2000)


def _serve_port(obs):
    return _serve(FleetServer, HookConfig, prepare, programs, Mechanism,
                  PolicyScheduler, TenantBudget, obs, device="cpu")


def _serve_jax(obs):
    return _serve(JFleetServer, JHookConfig, jprepare, jprograms,
                  JMechanism, JPolicyScheduler, JTenantBudget, obs)


def test_observed_server_matches_unobserved_and_jax():
    """Observed and unobserved port servers publish the same results bit
    for bit; the observed port server's metrics equal the observed JAX
    server's, wall-clock values masked."""
    srv_on, on = _serve_port(True)
    _, off = _serve_port(False)
    assert [(r.rid, r.completed_gen) for r in on] == \
        [(r.rid, r.completed_gen) for r in off]
    for a, b in zip(on, off):
        for x, y in zip(a.state, b.state):
            assert x.dtype == y.dtype and bool((x == y).all())
    jsrv, jon = _serve_jax(True)
    assert [(r.rid, r.completed_gen) for r in jon] == \
        [(r.rid, r.completed_gen) for r in on]
    tm, jm = srv_on.metrics(), jsrv.metrics()
    assert _mask_prom(srv_on.metrics("prometheus")) == \
        _mask_prom(jsrv.metrics("prometheus"))
    for part in ("counters", "gauges"):
        assert tm[part] == jm[part]
    assert {k: {s: v["count"] for s, v in h.items()}
            for k, h in tm["histograms"].items()} == \
        {k: {s: v["count"] for s, v in h.items()}
         for k, h in jm["histograms"].items()}
    assert {k: v["count"] for k, v in tm["phases"].items()} == \
        {k: v["count"] for k, v in jm["phases"].items()}
    assert tm["generation"]["count"] == jm["generation"]["count"] \
        == srv_on.generation
    assert tm["spans"]["events"] == jm["spans"]["events"]
    assert tm["spans"]["open"] == 0 and tm["spans"]["completed"] == 5
    assert tm["counters"]["sched_decisions_total"][
        '{decision="budget_exhausted"}'] >= 1
    assert tm["spans"]["events"].get("c3_readmit", 0) == 1
    assert 0.5 <= tm["phase_coverage"] <= 1.05
    for name in ("dispatch", "harvest", "admission", "rebucket",
                 "sched_pass", "device_sync"):
        assert tm["phases"][name]["count"] >= 1


def test_disabled_server_allocates_no_registry():
    before = MetricsRegistry.created_total
    srv = FleetServer(pool=1, gen_steps=40, chunk=8, fuel=FUEL, device="cpu")
    srv.submit(prepare(programs.getpid_loop_param(), Mechanism.ASC,
                       virtualize=True), regs={19: 2})
    srv.run()
    assert MetricsRegistry.created_total == before
    assert srv.metrics() == {} and srv.metrics("prometheus") == ""
    assert srv.stats()["obs_enabled"] is False


def test_server_sink_and_fmt_validation(tmp_path):
    jpath = tmp_path / "srv.jsonl"
    srv = FleetServer(pool=1, gen_steps=40, chunk=8, fuel=FUEL, device="cpu",
                      cfg=HookConfig(obs_enabled=True,
                                     obs_sink=f"jsonl:{jpath}"))
    srv.submit(prepare(programs.getpid_loop_param(), Mechanism.ASC,
                       virtualize=True), regs={19: 2})
    srv.run()
    assert not jpath.exists()            # interval 0: never due
    srv._obs.maybe_snapshot(force=True)
    line = json.loads(jpath.read_text())
    assert line["gauges"]["server_completed"]["_"] == 1
    assert srv.metrics()["sink_writes"] == 1
    with pytest.raises(ValueError, match="csv"):
        srv.metrics(fmt="csv")
    with pytest.raises(ValueError, match="carrier-pigeon"):
        FleetServer(pool=1, device="cpu", cfg=HookConfig(
            obs_enabled=True, obs_sink="carrier-pigeon"))
    assert isinstance(now(), float)


# -- program spans ------------------------------------------------------------

class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_without_a_profiler_is_the_null_timer():
    obs.RECORDER.clear()
    assert not obs.recording()
    with obs.span("a") as a, obs.span("b", device=True) as b:
        obs.count("n", 3)
    assert a is NULL_TIMER and b is NULL_TIMER
    assert obs.recorded() == [] and obs.RECORDER.dropped == 0


def test_nested_spans_record_parents_and_counts():
    obs.RECORDER.clear()
    with _cpu_profile():
        assert obs.recording()
        with obs.span("root"):
            obs.count("chunks", 2)
            with obs.span("child"):
                obs.count("n")
                obs.count("n", 4)
            with obs.span("sibling", device=True):
                with obs.span("leaf"):
                    pass
            obs.count("chunks")
    got = obs.recorded()
    assert [s.name for s in got] == ["root", "child", "sibling", "leaf"]
    assert [s.parent for s in got] == [None, 0, 0, 2]
    assert [s.counts for s in got] == [{"chunks": 3}, {"n": 5}, {}, {}]
    assert all(s.device_ms is None for s in got)     # no card in use
    assert got[0].start <= got[1].start <= got[1].end <= got[2].start
    assert got[2].start <= got[3].start <= got[3].end <= got[2].end \
        <= got[0].end
    obs.RECORDER.clear()


ALIGN_S = 1e-6


def test_span_brackets_the_profilers_operator_event():
    """The spans' clock is the profiler's: a span around ``x.add(1)``
    holds kineto's ``aten::add`` event (but for the clocks' alignment:
    one offset between two clocks read a few hundred ns apart, in
    seconds since 1970 that a float resolves to 0.24 us), within 20 us
    on each side (the tightest of five, as a thread the scheduler stops
    inside a span widens it; the profiler's first events run slow)."""
    x = torch.ones(8)
    obs.RECORDER.clear()
    with _cpu_profile() as prof:
        for _ in range(5):
            with obs.span("add"):
                x.add(1)
    spans = obs.recorded()
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::add"]
    assert len(spans) == len(evs) == 5
    before, after = [], []
    for sp, ev in zip(spans, evs):
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        before.append(start - sp.start)
        after.append(sp.end - end)
    assert min(before + after) >= -ALIGN_S
    assert min(before) <= 20e-6 and min(after) <= 20e-6
    obs.RECORDER.clear()


def test_recorder_runs_no_dispatcher_operator():
    """Spans, device spans and counts are invisible to a dispatch mode
    (``record_function`` would be two operators a span)."""
    obs.RECORDER.clear()
    with _cpu_profile(), _CountOps() as mode:
        with obs.span("a"):
            with obs.span("b", device=True):
                obs.count("n")
    assert mode.ops == []
    assert [s.name for s in obs.recorded()] == ["a", "b"]
    with _cpu_profile(), _CountOps() as mode:
        with torch.profiler.record_function("c"):
            pass
    assert len(mode.ops) == 2
    obs.RECORDER.clear()


def test_recorder_keeps_at_most_its_cap():
    rec = obs.SpanRecorder(cap=2)
    with _cpu_profile():
        for name in "abc":
            with rec.span(name):
                pass
        with rec.span("d") as d:
            pass
    assert d is NULL_TIMER
    assert [s.name for s in rec.recorded()] == ["a", "b"]
    assert rec.dropped == 2
    rec.clear()
    assert rec.recorded() == [] and rec.dropped == 0


def _tiny_fleet():
    pps = [prepare(programs.getpid_loop(n), Mechanism.ASC, virtualize=True)
           for n in (2, 3, 4)]
    return runtime.pack_fleet(pps, fuel=FUEL, device="cpu")


def test_run_fleet_records_its_chunks_and_the_same_carry(monkeypatch):
    imgs, ids, s = _tiny_fleet()
    seen = {"chunks": 0}
    chunk = mops._chunk

    def counted(*a, **kw):
        seen["chunks"] += 1
        return chunk(*a, **kw)

    monkeypatch.setattr(mops, "_chunk", counted)
    obs.RECORDER.clear()
    off = fleet.run_fleet(imgs, type(s)(*(x.clone() for x in s)), ids,
                          chunk=8, device="cpu")
    assert obs.recorded() == []
    n_off, seen["chunks"] = seen["chunks"], 0
    with _cpu_profile():
        on = fleet.run_fleet(imgs, type(s)(*(x.clone() for x in s)), ids,
                             chunk=8, device="cpu")
    assert seen["chunks"] == n_off > 1
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    got = obs.recorded()
    (run,) = [sp for sp in got if sp.name == "fleet.run"]
    assert run.counts == {"chunks": n_off}
    names = [sp.name for sp in got]
    assert names[:4] == ["fleet.run", "fleet.inputs", "fleet.check",
                         "fleet.args"]
    assert names[-1] == "fleet.patch_fuel"
    assert names.count("fleet.launch") == n_off
    assert names.count("fleet.alive") == n_off + 1
    assert all(sp.parent == 0 for sp in got[1:])
    obs.RECORDER.clear()
