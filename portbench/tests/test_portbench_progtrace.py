"""The reading of the program's own tracer (``portbench/progtrace.py`` and
the readers of the program's metrics) on hand-made profiler events and a
hand-worked run: the program's annotations change no number the probe
gives, each kernel goes to the innermost program span that launched it,
and each reader's arithmetic."""

import pytest
from torch.autograd import DeviceType

from portbench import probe, progtrace, readers
from portbench.system import Run

US = 1000  # ns


class Ev:
    def __init__(self, name, t0_us, t1_us, dev=DeviceType.CPU, corr=0, linked=0, tid=1):
        self._n, self._t0, self._t1, self._dev = name, t0_us * US, t1_us * US, dev
        self._corr, self._linked, self._tid = corr, linked, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._t1 - self._t0

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def start_thread_id(self):
        return self._tid


class Prof:
    def __init__(self, events):
        self.profiler = self.kineto_results = self
        self._events = events

    def events(self):
        return self._events


CUDA = DeviceType.CUDA
HOST = [
    Ev("portbench.clock", 0, 1),
    Ev("cerebro.verify", 10, 100, corr=1),
    Ev("cerebro.verify.ransac", 20, 50, corr=2),
    Ev("aten::mul", 55, 65, corr=3),
    Ev("cerebro.solve", 200, 300, corr=4),
    Ev("cerebro.drain", 150, 160, corr=5, tid=2),  # another thread
    Ev("cudaLaunchKernel", 25, 26, corr=101, linked=2),
    Ev("cudaLaunchKernel", 60, 61, corr=102, linked=3),
    Ev("cudaLaunchKernel", 210, 211, corr=103, linked=4),
    Ev("cudaMemcpyAsync", 400, 401, corr=104),
]
KERNELS = [
    # a device event shares its launch call's correlation id and links to
    # the host op the call ran under, as the profiler reports them
    Ev("stereo_bm_kernel", 30, 40, CUDA, corr=101, linked=2),
    Ev("void at::native::mul_kernel", 70, 90, CUDA, corr=102, linked=3),
    Ev("gemm", 220, 260, CUDA, corr=103, linked=104),  # a linked id that is also a call's
    Ev("Memcpy DtoH", 410, 420, CUDA, corr=104, linked=0),
]
# the program's annotations as the profiler lays them on the device's timeline
ANNOTATIONS = [Ev("cerebro.verify", 30, 90, CUDA), Ev("cerebro.solve", 220, 260, CUDA)]


def bench_spans():
    s = probe.Spans(trace=True)
    s.calls = {"verify": [(5e-6, 150e-6, 3)], "solve": [(190e-6, 310e-6, None)]}
    s.launches = {"K3": [(30e-6, (8, 480, 752, 64))]}
    return s


def reduced(events, reduce):
    # t_mark 0: the benchmark's clock is the trace's
    return reduce(Prof(events), 0.0, 500e-6, bench_spans())


def test_program_annotations_change_no_number_of_the_probe():
    plain = reduced(HOST + KERNELS, probe.reduce_trace)
    traced = reduced(HOST + KERNELS + ANNOTATIONS, progtrace.reduce_trace)
    for key in ("busy_s", "window_s", "device_events", "device_ops"):
        assert traced[key] == plain[key], key
    assert [s for _, s in traced["idle_gaps"]] == [s for _, s in plain["idle_gaps"]]
    # counted as device work, the annotations would have moved the idle share
    assert reduced(HOST + KERNELS + ANNOTATIONS, probe.reduce_trace)["busy_s"] > plain["busy_s"]
    for name in ("device_idle.relocalize", "k3_roofline.relocalize"):
        got = []
        for tr in (plain, traced):
            run = Run(trace=tr, trace_t=(0.0, 500e-6), spans=bench_spans())
            got.append(readers.load(name).read(readers.Context(run=run, describe_flops=0.0, width=0)))
        assert got[0] is not None and got[0] == got[1], name


def test_kernels_go_to_the_innermost_span_that_launched_them():
    tr = reduced(HOST + KERNELS + ANNOTATIONS, progtrace.reduce_trace)
    assert tr["device_spans"] == [("verify", "verify.ransac"), ("verify",), ("solve",), ()]
    by = dict(tr["device_by_span"])
    assert by == pytest.approx({"cerebro.verify.ransac": 10e-6, "cerebro.verify": 20e-6,
                                "cerebro.solve": 40e-6, progtrace.OUTSIDE: 10e-6})
    assert tr["device_attributed_share"] == pytest.approx(70 / 80)
    # each gap by the spans open at its start: 260-410 us under both
    # solves, 90-220 us under both verifies, 40-70 us inside the RANSAC
    gaps = {n: s for n, s in tr["idle_gaps"]}
    assert gaps == pytest.approx({"solve/cerebro.solve": 150e-6, "verify/cerebro.verify": 130e-6,
                                  "verify/cerebro.verify.ransac": 30e-6})


def test_a_launch_without_a_known_thread_takes_the_latest_span_open_anywhere():
    host = [e for e in HOST if e.name() != "cudaLaunchKernel"]
    host += [Ev("cudaLaunchKernel", 155, 156, corr=105, linked=999)]
    tr = reduced(host + [Ev("k", 157, 158, CUDA, corr=105, linked=999)], progtrace.reduce_trace)
    assert tr["device_spans"] == [("drain",)]


def hand_run():
    """A window of 10 s (100-110) holding two solves and four detection
    read-backs; a profiled slice (102-104) holding a verify span of 1 s."""
    run = Run(window_t0=100.0, window_t1=110.0, trace_t=(102.0, 104.0))
    span = {"name": "verify_tier1", "t0": 102.5, "t1": 103.5, "id": 1, "parent": 0, "attrs": {}}
    group = {"name": "verify", "t0": 102.6, "t1": 103.4, "id": 2, "parent": 1, "attrs": {}}
    c0 = {"solve.cg_iters": 40, "edges.accepted": 1, "rejected.ransac": 2,
          "detections.read_back": 3}
    t0 = {"optimize": {"total_s": 4.0, "count": 1}, "solve.cg": {"total_s": 2.0, "count": 25},
          "drain": {"total_s": 0.3, "count": 3}}
    c1 = {"solve.cg_iters": 40, "edges.accepted": 3, "rejected.ransac": 4,
          "detections.read_back": 3, "pairs.verified.tier1": 5}
    c2 = {"solve.cg_iters": 440, "edges.accepted": 5, "rejected.ransac": 6, "rejected.consistency": 1,
          "detections.read_back": 7, "pairs.verified.tier1": 8, "pairs.verified.tier2": 2}
    t2 = {"optimize": {"total_s": 12.0, "count": 3}, "solve.cg": {"total_s": 6.0, "count": 75},
          "drain": {"total_s": 0.7, "count": 7}}
    run.program = {"spans": [span, group],
                   "snapshots": [(99.0, c0, t0), (101.5, c1, t0), (104.0, c2, t2), (120.0, c2, t2)]}
    run.trace = {"device_events": [(1.0, 1.2, "k"), (1.1, 1.3, "k"), (1.5, 1.6, "gemm")],
                 "device_spans": [("verify_tier1", "verify", "verify.depth"),
                                  ("verify_tier1", "verify"), ("solve",)]}
    return readers.Context(run=run, describe_flops=0.0, width=0)


@pytest.mark.parametrize("metric, want", [
    # in the slice: 2 launches under verify spans over the passes verified
    # from the snapshot at 101.5 (tier 1: 5) to the one at 104 (8 + 2)
    ("verify_launches_per_pair.relocalize", 2 / 5),
    # their union 1.0-1.3 s over the verify span's 0.8 s
    ("verify_device_share.relocalize", 100.0 * 0.3 / 0.8),
    # the window: snapshots at 99 and 120: 400 iterations over 2 solves
    ("solve_cg_iters", 200.0),
    ("solve_ms_per_cg_iter", 1e3 * 4.0 / 400),
    ("drain_ms_per_batch.relocalize", 1e3 * 0.4 / 4),
])
def test_reader_on_a_hand_worked_run(metric, want):
    assert readers.load(metric).read(hand_run()) == pytest.approx(want)


@pytest.mark.parametrize("metric", progtrace.METRICS)
def test_reader_reads_nothing_from_a_run_without_the_program_tracer(metric):
    ctx = hand_run()
    del ctx.run.program
    ctx.run.trace = {"device_events": ctx.run.trace["device_events"]}  # probe.reduce_trace's keys
    assert readers.load(metric).read(ctx) is None


def test_delta_takes_the_nearest_snapshots_that_hold_the_interval():
    run = Run()
    run.program = {"spans": [], "snapshots": [(1.0, {"n": 1}, {}), (2.0, {"n": 3}, {}), (3.0, {"n": 6}, {})]}
    assert progtrace.delta(run, 1.5, 2.5)[0] == {"n": 5}  # from 1.0 to 3.0
    assert progtrace.delta(run, 2.0, 2.0)[0] == {"n": 0}
    assert progtrace.delta(run, 0.5, 2.0) is None  # nothing taken before the start
    assert progtrace.delta(run, 1.0, 3.5) is None  # nothing taken after the end


def test_program_launches_in_the_slice_with_their_shapes():
    ctx = hand_run()
    k3 = lambda t0, shape: {"name": "kernel.stereo_bm_launch", "t0": t0, "t1": t0 + 1e-4, "id": 9,
                             "parent": 2, "attrs": {"shape": shape}}
    ctx.run.program["spans"] += [k3(101.0, (4, 480, 752, 64, 21)), k3(102.7, (4, 480, 752, 64, 21)),
                                 k3(103.1, (2, 480, 752, 64, 21)), k3(104.5, (4, 480, 752, 64, 21))]
    got = readers.program_launches(ctx)
    assert got == {"stereo_bm_launch": [(4, 480, 752, 64, 21), (2, 480, 752, 64, 21)]}
    # a roofline over the program's launches: the mean bound over the mean device time a call
    ctx.run.trace["device_events"] = [(1.0, 1.0 + 2e-3, "stereo_bm_kernel"),
                                      (1.1, 1.1 + 1e-3, "stereo_bm_kernel")]
    share = readers.launches_roofline(ctx, [s[:4] for s in got["stereo_bm_launch"]], ("stereo_bm_kernel",),
                                      readers.k3_bound)
    want = 100.0 * (readers.k3_bound(4, 480, 752, 64) + readers.k3_bound(2, 480, 752, 64)) / 2 / 1.5e-3
    assert share == pytest.approx(want)
    del ctx.run.program
    assert readers.program_launches(ctx) == {}


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_holds_the_program_over_the_window(trace, monkeypatch, capsys):
    """A small CPU run of the relocalize cell: the program's snapshots are
    taken at the window's ends (and the slice's, traced), its spans only
    where the run is traced, and the program's readers read them."""
    import json

    import torch

    from portbench import run as run_mod
    from portbench import system
    from portbench.tests.test_portbench_faults import small_config, small_relocalize

    torch.set_num_threads(4)
    runs = []
    real = system.closed_loop
    monkeypatch.setattr(system, "closed_loop", lambda *a, **k: runs.append(real(*a, **k)) or runs[-1])
    rc = run_mod.main(["--workload", "bench_e2e_top3.relocalize", "--seed", "4294967311", "--seconds", "0.1",
                       "--trace", str(trace)], device="cpu", traffic_override=small_relocalize,
                      config_override=small_config)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    r = runs[0]
    times = [s[0] for s in r.program["snapshots"]]
    assert times == sorted(times) and r.window_t0 in times and r.window_t1 in times
    counters, totals = progtrace.delta(r, r.window_t0, r.window_t1)
    # the window's keyframes, each described once, and its solves
    assert counters["keyframes.described"] == r.keyframes_done > 0
    assert totals["optimize"][1] == r.notes["rounds"]
    spans = r.program["spans"]
    if not trace:
        assert spans == [] and r.trace is None
        return
    # the slice's start snapshot is taken just before the profiler starts
    before = [t for t in times if t <= r.trace_t[0]]
    assert r.trace_t[1] in times and before and r.trace_t[0] - before[-1] < 1.0
    assert progtrace.delta(r, *r.trace_t) is not None
    inside = [s for s in spans if r.window_t0 <= s["t0"] and s["t1"] <= r.window_t1]
    assert {"describe", "detect", "drain", "solve", "solve.cg"} <= {s["name"] for s in inside}
    cg = sum(s["attrs"]["iters"] for s in inside if s["name"] == "solve.cg")
    assert line["metrics"]["solve_cg_iters"]["value"] == cg / r.notes["rounds"] == \
        counters["solve.cg_iters"] / r.notes["rounds"]
    assert "drain_ms_per_batch.relocalize" in line["metrics"]
