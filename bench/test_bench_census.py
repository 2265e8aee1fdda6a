"""The census cell at a tiny size on the CPU (the port's plain step):
the run is correct, its control and every fault it can have are not,
and the frozen reference equals the port lane for lane."""
from __future__ import annotations

import pytest
import torch

from bench import calibrate, common, faults, run, traffic
from bench.conftest import TINY_CENSUS, tiny_census_config, tiny_spec


def test_tiny_census_run_is_correct(tiny_root):
    res, checks = run.run_cell(TINY_CENSUS, 2**31 + 99, 0.0, False,
                               device="cpu", spec=tiny_spec(), root=tiny_root)
    assert res["correct"], checks
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"census_lane_steps_per_s",
                                   "census_p95_ms", "setup_s"}
    assert [c["name"] for c in checks] == ["census.mismatched_leaves",
                                           "census.runs_off_lane_steps"]


def test_census_layer_readers_on_a_made_up_trace():
    """The readers' arithmetic on a trace of known intervals: a device
    profile of 10 s over two censuses, two chunk launches of 1 s and one
    decode-table kernel of 0.5 s, a copy of 0.5 s; two censuses whose
    bytes need 0.25 s each; an untraced remainder of four censuses in
    20 s."""
    from types import SimpleNamespace
    from bench.trace import Interval, Trace, breakdown, busy_s
    tr = Trace(10.0,
               [Interval("Memcpy DtoD", 0.0, 0.5),
                Interval("megastep_decode_kernel", 1.0, 1.5),
                Interval("megastep_kernel(MegastepArgs)", 2.0, 3.0),
                Interval("megastep_kernel(MegastepArgs)", 5.0, 6.0)],
               [Interval("bench.census.run_fleet", 0.0, 7.0),
                Interval("aten::item", 3.0, 4.9)], (0.0, 10.0))
    cell = SimpleNamespace(least_s=lambda: 0.25, counters={"pack_s": 1.25})
    ctx = {"trace": tr, "units": 2, "cell": cell, "rest_units": 4,
           "rest_s": 20.0}
    read = {m: common.metric_reader(m) for m in (
        "census.pack_s", "census.host_gap_us_per_chunk",
        "census.megastep_roofline", "census.device_idle")}
    assert busy_s(tr) == 3.0
    assert read["census.pack_s"](ctx) == 1.25
    # a census: 5 s of wall, 1.25 s of megastep kernels, one launch
    assert read["census.host_gap_us_per_chunk"](ctx) == (5 - 1.25) * 1e6
    assert read["census.megastep_roofline"](ctx) == 0.5 / 2.5 * 100
    # a census: 1.5 s busy of 5 s
    assert read["census.device_idle"](ctx) == pytest.approx(70.0)
    assert read["census.device_idle"](dict(ctx, rest_units=0)) is None
    gaps = dict(breakdown(tr, tr)["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(2.0)
    assert gaps["bench.census.run_fleet"] == pytest.approx(1.0)
    assert gaps["host idle"] == pytest.approx(4.0)


@pytest.mark.parametrize("fault", faults.CENSUS)
def test_each_fault_is_caught(tiny_root, fault):
    got = calibrate.readings(TINY_CENSUS, 17, fault=fault, device="cpu",
                             root=tiny_root)
    assert got["census.mismatched_leaves"] > 0, got


def test_the_control_is_not_correct(tiny_root):
    """Emulation off in the program: the churn lanes' syscalls fail."""
    got = calibrate.readings(TINY_CENSUS, 23, control="emul_off",
                             device="cpu", root=tiny_root)
    assert got["census.mismatched_leaves"] > 0, got


def test_reference_equals_the_port_lane_for_lane():
    """Every lane of a tiny census, all 34 leaves, the port's run_fleet
    on the CPU against the frozen reference."""
    from bench.drivers.census import Cell
    cfg = tiny_census_config()
    wl = {"params": {"sample_per_cell": cfg["copies"]
                     * len(cfg["scales"])}}
    cell = Cell(wl, cfg, 41, "cpu")
    assert cell.sample == list(range(len(cell.lanes)))
    cell.setup()
    out = cell.work[0]
    ref = cell.reference()
    for name, a, b in zip(type(out)._fields, out, ref):
        assert torch.equal(a, b), name
    assert all(int(h) == 1 for h in ref.halted)   # HALT_EXIT


def test_sample_covers_every_cell():
    cfg = tiny_census_config()
    lanes = traffic.census_lanes(cfg, 8)
    s = traffic.census_sample(cfg, lanes, 8, 1)
    assert {(lanes[i].mechanism, lanes[i].program) for i in s} == {
        (m, p) for m, _, p in traffic.census_cells(cfg)}
