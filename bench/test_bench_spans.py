"""The readers of the program's spans (``bench/spans.py`` and the six
metrics on it) on made-up device profiles and spans with known answers,
on the CPU; on the card, the spans' clock against the device trace's and
the six metrics in the tiny traced cells."""
from __future__ import annotations

import pytest

from bench import common, run, spans as bspans
from bench.conftest import TINY_CENSUS, TINY_TRAIN, tiny_spec
from bench.trace import Interval, Trace, busy_s

CENSUS_METRICS = ("census.chunk_idle_us", "census.setup_idle_us")
TRAIN_METRICS = ("train.forward_idle_ms", "train.backward_idle_ms",
                 "train.optimizer_ms", "hook.self_us_per_op")
MAIN, OTHER = 7, 8


def _spans(rows):
    """Spans from (name, start, end, parent, counts[, thread[, ms]])."""
    from repro_torch.obs import Span
    out = []
    for r in rows:
        name, s, e, parent, counts = r[:5]
        thread = r[5] if len(r) > 5 else MAIN
        ms = r[6] if len(r) > 6 else None
        out.append(Span(name, s, e, parent, counts, thread, ms))
    return out


def _read(name, ctx, monkeypatch, spans):
    monkeypatch.setattr(bspans, "recorded", lambda: spans)
    return common.metric_reader(name)(ctx)


# A census profile: device intervals 10.0-15.75 s, idle gaps
#   g1 10.5-11.0 (mid 10.75: fleet.check), g2 12.0-12.5 (fleet.alive),
#   g3 12.75-13.0 (fleet.launch), g4 14.0-14.5 (fleet.alive),
#   g5 14.75-15.0 (fleet.run itself), g6 15.25-15.5 (outside every span
#   of the main thread; another thread's span there does not count).
CENSUS_DEVICE = [Interval("Memcpy DtoD", 10.0, 10.5),
                 Interval("megastep_kernel", 11.0, 12.0),
                 Interval("aten_any", 12.5, 12.75),
                 Interval("megastep_kernel", 13.0, 14.0),
                 Interval("where", 14.5, 14.75),
                 Interval("Memcpy DtoD", 15.0, 15.25),
                 Interval("Memcpy DtoD", 15.5, 15.75)]
CENSUS_SPANS = [
    ("fleet.run", 5.0, 6.0, None, {"chunks": 9}),      # before the range
    ("fleet.alive", 5.1, 5.2, 0, {}),
    ("fleet.run", 10.6, 15.1, None, {"chunks": 2}),
    ("fleet.inputs", 10.6, 10.65, 2, {}),
    ("fleet.check", 10.7, 10.8, 2, {}),
    ("fleet.args", 10.8, 10.82, 2, {}),
    ("fleet.alive", 10.85, 10.9, 2, {}),
    ("fleet.launch", 10.9, 11.05, 2, {}),
    ("fleet.alive", 12.1, 12.6, 2, {}),
    ("fleet.launch", 12.8, 13.1, 2, {}),
    ("fleet.alive", 14.1, 14.3, 2, {}),
    ("fleet.patch_fuel", 14.4, 14.6, 2, {}),
    ("fleet.alive", 15.2, 15.6, None, {}, OTHER),
    ("fleet.run", 20.0, 21.0, None, {"chunks": 5}),    # the labelled one
    ("fleet.launch", 20.1, 20.9, 13, {}),
]


def _census_ctx():
    return {"trace": Trace(6.0, CENSUS_DEVICE, []), "units": 1}


def test_census_span_readers_on_a_made_up_trace(monkeypatch):
    spans = _spans(CENSUS_SPANS)
    ctx = _census_ctx()
    # (g2 + g3 + g4) over the 2 chunks of the one fleet.run in range
    assert _read("census.chunk_idle_us", ctx, monkeypatch, spans) == \
        pytest.approx((0.5 + 0.25 + 0.5) / 2 * 1e6)
    # g1 (fleet.check) + g5 (fleet.run) over one census
    assert _read("census.setup_idle_us", ctx, monkeypatch, spans) == \
        pytest.approx((0.5 + 0.25) * 1e6)


def test_idle_by_span_sums_to_the_profiles_idle(monkeypatch):
    spans = _spans(CENSUS_SPANS)
    tr = _census_ctx()["trace"]
    monkeypatch.setattr(bspans, "recorded", lambda: spans)
    sel = bspans.window({"trace": tr})
    # the spans before the range and the labelled profile's are left out
    assert [s.start for s in sel if s.name == "fleet.run"] == [10.6]
    assert len(sel) == 11
    by = bspans.idle_by_span(tr, sel, "fleet.run")
    assert by == pytest.approx({"fleet.check": 0.5, "fleet.alive": 1.0,
                                "fleet.launch": 0.25, "fleet.run": 0.25,
                                "host idle": 0.25})
    lo, hi = bspans.device_range(tr)
    assert sum(by.values()) == pytest.approx(hi - lo - busy_s(tr))


# A train profile of two steps, 0-10.25 s: in each step the hook's span
# holds train.step, which holds the three passes; each step has one gap in
# the forward and two in the backward; the gap at its end falls in the
# first step's hook.mode and after the second's; the optimizer's
# CUDA-event times are 0.75 and 1.25 ms.
def _train_step(t0, mode_i, mode_end=4.9):
    return [
        ("hook.mode", t0, t0 + mode_end, None,
         {"dispatched": 1000, "self_ns": 2_000_000 + mode_i * 1_000_000}),
        ("train.step", t0 + 0.1, t0 + 4.8, mode_i, {}),
        ("train.forward", t0 + 0.1, t0 + 1.5, mode_i + 1, {}, MAIN),
        ("train.backward", t0 + 1.5, t0 + 3.5, mode_i + 1, {}, MAIN),
        ("train.optimizer", t0 + 3.5, t0 + 4.7, mode_i + 1, {}, MAIN,
         0.75 + 0.5 * (mode_i > 0)),
    ]


def _train_device(t0):
    # gaps: 0.5-0.75 (forward), 2.0-2.25 and 3.0-3.5 (backward),
    # 4.75-5.0 (past train.step)
    return [Interval("k", t0 + 0.0, t0 + 0.5),
            Interval("k", t0 + 0.75, t0 + 2.0),
            Interval("k", t0 + 2.25, t0 + 3.0),
            Interval("k", t0 + 3.5, t0 + 4.75)]


def _train_ctx():
    return {"trace": Trace(10.0, _train_device(0.0) + _train_device(5.0)
                           + [Interval("k", 10.0, 10.25)], []),
            "units": 2}


def test_train_span_readers_on_a_made_up_trace(monkeypatch):
    rows = _train_step(0.0, 0) + _train_step(5.0, 5, mode_end=4.8)
    rows += [("hook.mode", 30.0, 31.0, None, {"dispatched": 7,
                                              "self_ns": 7e9})]
    spans = _spans(rows)
    ctx = _train_ctx()
    assert _read("train.forward_idle_ms", ctx, monkeypatch, spans) == \
        pytest.approx(0.25 * 1e3)
    assert _read("train.backward_idle_ms", ctx, monkeypatch, spans) == \
        pytest.approx(0.75 * 1e3)
    assert _read("train.optimizer_ms", ctx, monkeypatch, spans) == \
        pytest.approx((0.75 + 1.25) / 2)
    # 2e6 + 7e6 ns over 2,000 operators; the later span left out
    assert _read("hook.self_us_per_op", ctx, monkeypatch, spans) == \
        pytest.approx((2e6 + 7e6) / 2000 * 1e-3)
    by = bspans.idle_by_span(ctx["trace"], bspans.window(ctx), "train.step")
    lo, hi = bspans.device_range(ctx["trace"])
    assert sum(by.values()) == pytest.approx(hi - lo - busy_s(ctx["trace"]))
    assert by == pytest.approx({"train.forward": 0.5,
                                "train.backward": 1.5, "hook.mode": 0.25,
                                "host idle": 0.25})


@pytest.mark.parametrize("name", CENSUS_METRICS + TRAIN_METRICS)
def test_span_readers_read_nothing_without_spans_or_device(monkeypatch,
                                                          name):
    spans = _spans(CENSUS_SPANS + _train_step(0.0, 0))
    no_device = {"trace": Trace(10.0, [], []), "units": 2}
    assert _read(name, no_device, monkeypatch, spans) is None
    for ctx in (_census_ctx(), _train_ctx()):
        assert _read(name, ctx, monkeypatch, []) is None


def test_recorded_reads_the_programs_recorder():
    from repro_torch import obs
    obs.RECORDER.clear()
    assert bspans.recorded() == []


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_spans_share_the_device_traces_clock(card):
    """A tiny census under a profile of the card alone: every megastep
    kernel starts after the start of the ``fleet.launch`` span that
    launched it, and the ``fleet.alive`` span after it ends after the
    kernel ends."""
    from torch.profiler import ProfilerActivity, profile

    from bench.conftest import tiny_census_config
    from bench.drivers.census import Cell
    from bench.trace import _events
    from repro_torch import obs
    cell = Cell({"params": {"sample_per_cell": 1}}, tiny_census_config(), 5,
                str(card))
    cell.setup()
    obs.RECORDER.clear()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    for _ in range(3):
        cell.unit()
    prof.stop()
    device, _ = _events(prof)
    kernels = sorted((iv for iv in device
                      if iv.name.startswith("megastep_kernel")),
                     key=lambda iv: iv.start)
    spans = obs.recorded()
    launches = [s for s in spans if s.name == "fleet.launch"]
    assert len(kernels) == len(launches) > 3
    for k, sp in zip(kernels, launches):
        after = next(s for s in spans
                     if s.name == "fleet.alive" and s.start >= sp.end)
        assert sp.start <= k.start and k.end <= after.end, (k, sp, after)
    obs.RECORDER.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("cell,names", [(TINY_CENSUS, CENSUS_METRICS),
                                        (TINY_TRAIN, TRAIN_METRICS)])
def test_tiny_traced_cell_reports_the_span_metrics(card, tiny_root, cell,
                                                   names):
    res, checks = run.run_cell(cell, 2**31 + 79, 0.5, True,
                               device=str(card), spec=tiny_spec(),
                               root=tiny_root, trace_seconds=0.1)
    assert res["correct"], checks
    for n in names:
        assert res["metrics"][n]["value"] >= 0, n
