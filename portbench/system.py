"""The system under test, driven as its users drive it.

This is the only module of the benchmark that imports the system
(``cerebro_tpu_torch``). ``open_loop`` feeds ``CerebroService``'s push API
from a producer thread on the stream's due schedule; ``closed_loop`` drives
``CerebroPipeline`` offline (``ingest_frame`` in batches, ``verify_pending``
after each, ``optimize_trajectory`` every ``solve_every_batches``, or, at 0,
nowhere in the window). Both
return a ``Run``: the timings the end-to-end and per-layer readers take, and
the system's outputs that the judge compares with the reference.

In a traced run (``trace``) the program's own tracer (``pipe.timer``) is on
from the end of ``warmup()``: its spans, and snapshots of its counters and
stage totals at the window's and the profiled slice's ends, are
``Run.program`` (``portbench/progtrace.py`` reads them), and the slice is
reduced with the program's spans (``progtrace.reduce_trace``). Untraced
runs leave the tracer off.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from portbench import probe, progtrace
from portbench import route as R
from portbench import world as W
from portbench import yardstick as Y

NS = 1_000_000_000


@dataclasses.dataclass
class Run:
    setup_s: float = 0.0
    window_t0: float = 0.0
    window_t1: float = 0.0
    attempted: int = 0
    failed: int = 0
    keyframe_ms: list = dataclasses.field(default_factory=list)
    decision_ms: list = dataclasses.field(default_factory=list)
    keyframes_done: int = 0
    backlog: list = dataclasses.field(default_factory=list)
    spans: Optional[probe.Spans] = None
    trace: Optional[dict] = None
    trace_t: tuple = (0.0, 0.0)
    timer_stats: dict = dataclasses.field(default_factory=dict)
    # the program's spans and snapshots of its counters (progtrace.program)
    program: Optional[dict] = None
    memory_peak_bytes: int = 0
    notes: dict = dataclasses.field(default_factory=dict)
    # the system's outputs, read once the window has closed
    out: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window_t1 - self.window_t0


def make_config(overrides: dict):
    from cerebro_tpu_torch import config as C

    kinds = {f.name: f.type for f in dataclasses.fields(C.CerebroConfig)}
    parts = {}
    for name, fields in overrides.items():
        cls = getattr(C, kinds[name]) if isinstance(kinds[name], str) else kinds[name]
        vals = {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
        parts[name] = cls(**vals)
    return C.CerebroConfig(**parts)


def make_pipeline(cfg_file: dict, weights, seed: int, device):
    """The pipeline of the configuration, its describe net's weights read
    from ``weights`` (the directory the net module names, which the
    reference reads too)."""
    from cerebro_tpu_torch.geometry.stereo import RectifiedRig
    from cerebro_tpu_torch.runtime import CerebroPipeline

    overrides = dict(cfg_file["cerebro_config"])
    overrides["descriptor"] = {**overrides["descriptor"], "artifact_dir": str(weights)}
    cfg = make_config(overrides)
    rig = RectifiedRig(R0=np.eye(3, dtype=np.float32), R1=np.eye(3, dtype=np.float32),
                       **W.rig_params(cfg_file["rig"]))
    pipe = CerebroPipeline(cfg, rig=rig, body_T_cam=W.body_T_cam(), seed=seed % (2**31),
                           device=str(device))
    return pipe


def snapshot(pipe) -> tuple:
    """(perf_counter seconds, the program's counters, its stage totals)."""
    return time.perf_counter(), pipe.timer.counters(), pipe.timer.totals()


def _stop_profiler(prof, run: Run, pipe, snaps: list):
    """End the profiled slice: snapshot the program, then stop the
    profiler. The slice ends at the snapshot, as the profiler stops
    recording: the stop itself, which processes the slice's events (6-15 s
    for a relocalize slice on the H100), records nothing and is not part of
    it. Its seconds go to the notes."""
    snaps.append(snapshot(pipe))
    prof.stop()
    run.trace_t = (run.trace_t[0], snaps[-1][0])
    run.notes["profiler_stop_s"] = time.perf_counter() - snaps[-1][0]


def instrument(pipe, spans: probe.Spans, svc=None) -> Rejections:
    """Spans around the calls into each layer, and kernel launch shapes.
    Returns the pipeline's rejection count."""
    from cerebro_tpu_torch.ops.similarity import K1, K2
    from cerebro_tpu_torch.ops.stereo_kernel import K3

    rejections = Rejections(pipe)

    def decided(args, before, out):
        n = len(pipe.loop_edges) + rejections.total()
        return n if out is probe.BEFORE else n - before

    def graph_size(args, before, out):
        if out is probe.BEFORE:
            return (pipe.store.size, len(pipe.loop_edges))
        return {"in": before, "out": out}

    def n_valid(args, before, out):  # (real queries, DB rows filled)
        return None if out is probe.BEFORE else (int(args[2]), int(pipe.db.total))

    spans.wrap(pipe, "verify_pending", "verify", extra=decided)
    spans.wrap(pipe, "optimize_trajectory", "solve", extra=graph_size)
    spans.wrap(pipe, "describe_fn", "describe", sync=True)
    spans.wrap(pipe, "_detect", "detect", extra=n_valid, sync=True)

    def raised(args, before, out):
        if out is probe.BEFORE:
            return len(pipe._candidates)
        return [(c.idx_curr, c.idx_prev) for c in pipe._candidates[before:]]

    spans.wrap(pipe, "_drain_detections", "drain")
    spans.wrap(pipe, "_drain_detections_locked", "raise", extra=raised)
    if svc is not None:
        spans.wrap(svc.ingest, "pump", "pump")
    if spans.trace:
        # Q, N, D, KB, K, and the DB rows filled when the search ran
        spans.wrap_launch(K1, "K1", slice(9, 14), fill=lambda: pipe.db.total)
        spans.wrap_launch(K2, "K2", slice(9, 14), fill=lambda: pipe.db.total)
        spans.wrap_launch(K3, "K3", slice(4, 8))  # B, H, W, num_disp
    return rejections


class Rejections:
    """Rejections so far: the pipeline's list keeps its newest 256, so the
    count walks back from the list's end to the last rejection it saw."""

    def __init__(self, pipe):
        self.pipe, self.n, self.last = pipe, 0, None

    def total(self) -> int:
        rej = self.pipe.rejected_candidates
        k = len(rej) - 1
        while k >= 0 and rej[k] is not self.last:
            self.n += 1
            k -= 1
        if rej:
            self.last = rej[-1]
        return self.n


def _frames(stream, device, world_params, rig: dict, n_frames: Optional[int] = None):
    """The stream's first ``n_frames`` stereo pairs (all without it)."""
    W.check_period(stream.xy[:n_frames], world_params, rig)
    tex, mask, tex_m, built = W.load_world(world_params)
    ren = W.Renderer(tex, mask, tex_m, device, rig)
    left, right = ren.stereo_frames(stream.xy[:n_frames])
    del ren
    return left, right, built


def _check_capacity(cfg_file: dict, stream, n_frames: int):
    """The DB holds every keyframe the run can write: the judge reads rows
    by id, so a DB that wrapped could not be judged."""
    cap = int(cfg_file["cerebro_config"]["loop"]["db_capacity"])
    n_kf = int(stream.is_keyframe[:n_frames].sum())
    if n_kf > cap:
        raise ValueError(f"the traffic writes up to {n_kf} keyframes, the DB holds {cap}")


def _check_first_visit(cfg_file: dict, traffic: dict, stream, frames):
    """A ``first_visit`` mix's ``frames`` see no ground that a keyframe
    beyond the detector's exclusion window saw: no two footprints, both
    cameras', overlap."""
    if traffic.get("first_visit"):
        exclusion = make_config(cfg_file["cerebro_config"]).loop.exclusion_window
        R.check_first_visit(stream, frames, exclusion, W.union_footprint(cfg_file["rig"]))


# ---------------------------------------------------------------------------
# Open loop: the live node at camera rate
# ---------------------------------------------------------------------------


def open_loop(cfg_file: dict, weights, traffic: dict, stream, seed: int, seconds: float,
              trace: bool, device, t_process: float) -> Run:
    from cerebro_tpu_torch.runtime import CerebroService

    run = Run()
    _check_capacity(cfg_file, stream, len(stream.xy))
    _check_first_visit(cfg_file, traffic, stream, stream.index("window"))
    left, right, built = _frames(stream, device, traffic["world"], cfg_file["rig"])
    run.notes["world_built"] = built
    pipe = make_pipeline(cfg_file, weights, seed, device)
    warm = pipe.warmup(**{k: tuple(v) for k, v in cfg_file.get("warmup", {}).items()})
    run.notes["warmup_s"] = warm
    pipe.timer.trace = trace
    snaps = []
    svc = CerebroService(pipe, **cfg_file.get("service", {}))
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else None
    spans = probe.Spans(trace, sync)
    run.spans = spans
    rejections = instrument(pipe, spans, svc)
    if trace:
        pipe.timer.sync = True
    rate = float(traffic["rate_hz"])
    pre, win, tail = stream.index("prefill"), stream.index("window"), stream.index("tail")
    need = int(round(seconds * rate))
    if len(win) < need:
        raise ValueError(f"the traffic's window holds {len(win)} frames, {seconds} s at {rate} Hz "
                         f"needs {need}")
    win, tail = win[:need], np.concatenate([win[need:], tail])

    def push(i):
        ns = int(round(stream.stamps[i] * NS))
        svc.push_image(ns, left[i])
        svc.push_image(ns, right[i], is_right=True)
        svc.push_pose(ns, stream.odom_poses[i])
        svc.push_tracking(ns, int(stream.n_tracked[i]), is_keyframe=bool(stream.is_keyframe[i]))

    poller = probe.Poller(pipe)
    behind_s = 0.0
    svc.start()
    poller.start()
    try:
        # prefill: the map the window revisits, as fast as the service takes it
        for i in pre:
            push(i)
        # the frames inside the ingest hold wait for the window's first pushes
        n_held = int(np.ceil(float(cfg_file.get("service", {}).get("hold_s", 0.2)) * rate)) + 1
        n_pre = int(stream.is_keyframe[pre[:-n_held]].sum())
        deadline = time.perf_counter() + 120.0
        while len(poller.drained_at) < n_pre:
            if time.perf_counter() > deadline:
                raise RuntimeError(f"the prefill did not drain: {len(poller.drained_at)} of {n_pre}")
            time.sleep(0.02)
        snaps.append(snapshot(pipe))
        t0 = snaps[-1][0]
        run.setup_s = t0 - t_process
        run.window_t0 = t0
        due = {int(i): t0 + k / rate for k, i in enumerate(np.concatenate([win, tail]))}
        prof = None
        t_trace = (t0 + float(traffic.get("trace_at_s", 15.0)),
                   t0 + float(traffic.get("trace_at_s", 15.0)) + float(traffic.get("trace_s", 4.0)))
        win_kf = [int(i) for i in win if stream.is_keyframe[i]]
        stamp_to_frame = {round(float(s), 6): k for k, s in enumerate(stream.stamps)}

        def completed() -> int:
            """Window keyframes described and drained so far."""
            drained = len(poller.drained_at)
            g2s = pipe.db_gid_to_store
            st = pipe.store.stamps
            done = 0
            for g in range(min(drained, len(g2s))):
                f = stamp_to_frame.get(round(float(st[g2s[g]]), 6))
                if f is not None and f >= win_kf[0]:
                    done += 1
            return done

        t1 = t0 + seconds
        snapped = False  # the program's snapshot at the window's end
        for i in np.concatenate([win, tail]):
            now = time.perf_counter()
            if trace and prof is None and now >= t_trace[0] and now < t_trace[1]:
                snaps.append(snapshot(pipe))
                prof, t_mark = probe.start_profiler()
                run.trace_t = (t_mark, None)
            if prof is not None and run.trace_t[1] is None and now >= t_trace[1]:
                _stop_profiler(prof, run, pipe, snaps)
            target = due[int(i)]
            if target > now:
                time.sleep(target - now)
            else:
                behind_s = max(behind_s, now - target)
            if not snapped and time.perf_counter() >= t1:
                snaps.append(snapshot(pipe))
                snapped = True
            push(i)
            if stream.part[i] == "tail" and completed() >= len(win_kf):
                break
        if not snapped:
            snaps.append(snapshot(pipe))
        if prof is not None and run.trace_t[1] is None:
            _stop_profiler(prof, run, pipe, snaps)
        run.window_t1 = t1
        deadline = time.perf_counter() + 60.0
        while completed() < len(win_kf) and time.perf_counter() < deadline:
            time.sleep(0.02)
    finally:
        poller.stop()
    run.notes["producer_behind_s"] = behind_s
    run.backlog = [(t, n) for t, n in poller.backlog if run.window_t0 <= t <= run.window_t1]
    q = (run.window_t1 - run.window_t0) / 4
    run.notes["backlog_max_by_quarter"] = [
        max([n for t, n in run.backlog if run.window_t0 + k * q <= t < run.window_t0 + (k + 1) * q],
            default=0) for k in range(4)]
    svc.stop()
    _collect(run, pipe, stream, spans, rejections, snaps)
    run.out["left"] = left

    run.attempted = len(win_kf)
    run.keyframe_ms, run.failed = Y.keyframe_latencies(win_kf, due, run.out["gid_frame"],
                                                       poller.drained_at)
    run.decision_ms = Y.decision_latencies(run.out["candidates"], run.out["store_frame"], set(win_kf),
                                           due, poller.decided, run.window_t1)
    if trace and prof is not None:
        run.trace = progtrace.reduce_trace(prof, run.trace_t[0], run.trace_t[1] - run.trace_t[0], spans)
    run.timer_stats = run.out.pop("timer_stats")
    run.memory_peak_bytes = run.out.pop("memory_peak_bytes")
    return run


# ---------------------------------------------------------------------------
# Closed loop: offline relocalization through the cascade and the solve
# ---------------------------------------------------------------------------


def closed_loop(cfg_file: dict, weights, traffic: dict, stream, seed: int, seconds: float,
                trace: bool, device, t_process: float) -> Run:
    """The window is a fixed amount of work: whole rounds of
    ``solve_every_batches`` batches of keyframes, each batch verified, each
    round ended by a solve; the fewest whole rounds that fill ``seconds``
    at the traffic's ``nominal_keyframes_per_s`` (the parent's rate).
    ``solve_every_batches`` 0 solves nowhere in the window: a round is then
    one batch. A ``first_visit`` mix is refused where its window would see
    ground twice (``route.check_first_visit``)."""
    run = Run()
    B = int(cfg_file["cerebro_config"]["runtime"]["descriptor_batch"])
    solve_every = int(traffic["solve_every_batches"])
    per_round = B * max(solve_every, 1)
    rounds = max(1, math.ceil(seconds * float(traffic["nominal_keyframes_per_s"]) / per_round))
    win_all = stream.index("window")
    kf_win = win_all[stream.is_keyframe[win_all]]
    if len(kf_win) < rounds * per_round:
        raise ValueError(f"the traffic's window holds {len(kf_win)} keyframes; {rounds} rounds "
                         f"need {rounds * per_round}")
    last = int(kf_win[rounds * per_round - 1])
    win = [int(i) for i in win_all if i <= last]
    _check_capacity(cfg_file, stream, last + 1)
    _check_first_visit(cfg_file, traffic, stream, win)
    left, right, built = _frames(stream, device, traffic["world"], cfg_file["rig"], last + 1)
    run.notes["world_built"] = built
    pipe = make_pipeline(cfg_file, weights, seed, device)
    warm = pipe.warmup(**{k: tuple(v) for k, v in cfg_file.get("warmup", {}).items()})
    run.notes["warmup_s"] = warm
    pipe.timer.trace = trace
    snaps = []
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else None
    spans = probe.Spans(trace, sync)
    run.spans = spans
    rejections = instrument(pipe, spans)
    if trace:
        pipe.timer.sync = True

    def ingest(i):
        pipe.ingest_frame(float(stream.stamps[i]), left[i], n_tracked=int(stream.n_tracked[i]),
                          pose=stream.odom_poses[i] if stream.has_pose[i] else None,
                          right_img=right[i], is_keyframe=bool(stream.is_keyframe[i]))

    for i in stream.index("prefill"):
        ingest(i)
    pipe.flush_descriptors()
    pipe.verify_pending()
    pipe.optimize_trajectory()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    snaps.append(snapshot(pipe))
    t0 = snaps[-1][0]
    run.setup_s = t0 - t_process
    run.window_t0 = t0
    t_trace = (float(traffic.get("trace_at_s", 10.0)), float(traffic.get("trace_s", 4.0)))
    prof = None
    pos = 0
    for _ in range(rounds):
        for _ in range(max(solve_every, 1)):
            kf = 0
            while kf < B:
                i = win[pos]
                pos += 1
                ingest(i)
                kf += int(stream.is_keyframe[i])
            pipe.verify_pending()
            now = time.perf_counter() - t0
            if trace and prof is None and now >= t_trace[0]:
                snaps.append(snapshot(pipe))
                prof, t_mark = probe.start_profiler()
                run.trace_t = (t_mark, None)
            elif prof is not None and run.trace_t[1] is None and now >= t_trace[0] + t_trace[1]:
                _stop_profiler(prof, run, pipe, snaps)
        if solve_every:
            pipe.optimize_trajectory()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    snaps.append(snapshot(pipe))
    run.window_t1 = snaps[-1][0]
    if prof is not None and run.trace_t[1] is None:
        _stop_profiler(prof, run, pipe, snaps)
    run.keyframes_done = rounds * per_round
    run.attempted = run.keyframes_done
    run.notes["rounds"] = rounds
    run.notes["solves_in_window"] = len(spans.between("solve", run.window_t0, run.window_t1))
    run.notes["window_frames_used"] = pos
    _collect(run, pipe, stream, spans, rejections, snaps)
    run.out["left"] = left
    if trace and prof is not None:
        run.trace = progtrace.reduce_trace(prof, run.trace_t[0], run.trace_t[1] - run.trace_t[0], spans)
    run.timer_stats = run.out.pop("timer_stats")
    run.memory_peak_bytes = run.out.pop("memory_peak_bytes")
    return run


# ---------------------------------------------------------------------------
# The outputs, read once the window has closed; then the system is freed
# ---------------------------------------------------------------------------


def _collect(run: Run, pipe, stream, spans: probe.Spans, rejections: Rejections, snaps: list):
    if pipe.device.type == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    else:
        peak = 0
    stamp_to_frame = {round(float(s), 6): k for k, s in enumerate(stream.stamps)}
    n = pipe.store.size
    store_frame = [stamp_to_frame.get(round(float(s), 6), -1) for s in pipe.store.stamps[:n]]
    db = pipe.db
    total = db.total
    if total > db.capacity:
        raise RuntimeError("the DB wrapped: the judge reads rows by gid = row")
    gids = db.global_ids[:total].cpu().numpy()
    rows = db.vectors[:total, : db.dim].float().cpu().numpy()
    solves = [c for c in spans.calls.get("solve", []) if c[2]["out"] is not None]
    last = solves[-1] if solves else None
    scores = list(pipe.score_history)  # drains the last detections, so their candidates are recorded
    run.program = {"spans": progtrace.spans_as_dicts(pipe.timer.export()), "snapshots": snaps}
    run.out = {
        "memory_peak_bytes": peak,
        "timer_stats": pipe.timer.stats(),
        "store_frame": store_frame,
        "store_world": pipe.store.world_id[:n].copy(),
        "store_pose_valid": pipe.store.pose_valid[:n].copy(),
        "gid_store": list(pipe.db_gid_to_store),
        "gid_frame": [store_frame[s] for s in pipe.db_gid_to_store],
        "db_rows": rows, "db_gids": gids, "scores": scores,
        "candidates": [k for c in spans.calls.get("raise", []) for k in c[2]],
        "edges": [(e.idx_prev, e.idx_curr, np.asarray(e.T_prev_curr, np.float64)) for e in pipe.loop_edges],
        "rejected_total": rejections.total(),
        "solve": None if last is None else {"size": last[2]["in"][0], "n_edges": last[2]["in"][1],
                                            "traj": np.asarray(last[2]["out"], np.float64)},
        "loop_cfg": pipe.cfg.loop, "pg_cfg": pipe.cfg.posegraph,
    }
    pipe.close()
