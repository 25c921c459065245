"""The port's tracer (``cerebro_tpu_torch/utils/timing.py``) on the CPU:
spans, counters and ids, with tracing off and on.

- off: no span is kept and ``record_function`` is never called; the
  counters count all the same;
- on: spans nest per thread, the bounded list counts what it drops,
  ``warmup()`` keeps ``trace`` on its throwaway timer, and a profiler's
  ``cerebro.*`` events enclose the ops launched inside them;
- a pipeline run (a stub verifier, so hundreds of pairs take a second)
  whose counters outlast the capped rejection list and match
  ``loop_edges``, ``escalated_to_tier2`` and ``tier2_accepted``; every
  candidate id is raised once and decided once;
- the CG-iteration counter against a count of ``_cg``'s matvec calls;
- the verifier's spans around one real pair.
"""

import dataclasses
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from cerebro_tpu_torch import config as C
from cerebro_tpu_torch.posegraph import optimizer
from cerebro_tpu_torch.runtime import pipeline as P
from cerebro_tpu_torch.utils import timing
from cerebro_tpu_torch.verify.geometric import GRAPH_COUNTERS, VerifiedLoop

D = 64
PLACES = 120
REVISITS = 5  # laps over the same places after the first
HW = (8, 8)


def _spans(timer, name=None):
    f = timer.export()["span_fields"]
    spans = [dict(zip(f, s)) for s in timer.export()["spans"]]
    return [s for s in spans if name is None or s["name"] == name]


def test_spans_nest_per_thread():
    t = timing.StageTimer(trace=True)
    both_inside = threading.Barrier(2, timeout=10)

    def work(tag):
        with t.stage("outer", tag=tag):
            with t.stage("inner", tag=tag):
                both_inside.wait()

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    outer = {s["attrs"]["tag"]: s for s in _spans(t, "outer")}
    inner = {s["attrs"]["tag"]: s for s in _spans(t, "inner")}
    assert outer.keys() == inner.keys() == {0, 1}
    for k in (0, 1):
        assert outer[k]["parent"] == 0 and inner[k]["parent"] == outer[k]["id"]
        assert inner[k]["thread"] == outer[k]["thread"]
        assert outer[k]["t0_ns"] <= inner[k]["t0_ns"] <= inner[k]["t1_ns"] <= outer[k]["t1_ns"]
    assert outer[0]["thread"] != outer[1]["thread"]
    assert t.export()["totals"]["inner"]["count"] == 2


def test_bounded_span_list_counts_drops():
    t = timing.StageTimer(trace=True)
    t.capacity = 3
    for k in range(5):
        t.event("e", k=k)
    ex = t.export()
    assert [s[6]["k"] for s in ex["spans"]] == [0, 1, 2]
    assert ex["counters"]["spans_dropped"] == 2


def test_spans_enclose_the_ops_they_launch_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    t = timing.StageTimer(trace=True)
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.bind(), t.stage("outer"):
            with timing.span("inner"):
                (x * 2).sum()
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    outer, inner, mul = ev["cerebro.outer"], ev["cerebro.inner"], ev["aten::mul"]
    for a, b in ((outer, inner), (inner, mul)):
        assert a.start_thread_id() == b.start_thread_id()
        assert a.start_ns() <= b.start_ns() and b.end_ns() <= a.end_ns()


# ---------------------------------------------------------------------------
# A pipeline whose descriptors name places and whose verifier is a stub
# ---------------------------------------------------------------------------


def _config(tmp_path):
    return C.CerebroConfig(
        descriptor=C.DescriptorConfig(image_hw=HW, kind="gist"),
        loop=C.LoopConfig(db_capacity=1024, exclusion_window=6),
        posegraph=C.PoseGraphConfig(max_gn_iters=2, cg_iters=8),
        runtime=C.RuntimeConfig(descriptor_batch=16, stash_dir=str(tmp_path / "stash"),
                                image_ram_window_s=1e9),
    )


def _frame(k: int, place: int) -> np.ndarray:
    img = np.zeros(HW, np.uint8)
    img[0, :4] = (k // 256, k % 256, place // 256, place % 256)
    return img


def _stub_verify(cfg, generator, left_a, right_a, left_b, right_b, rig, sample_idx=None,
                 graphs=None):
    """By the current frame's number k: k % 4 == 0 accepted; 1 too few
    matches (tier 2, the gather matcher, accepts where k % 8 == 1); 2 a
    RANSAC option fails; 3 the poses disagree."""
    out = []
    for img in left_b:
        k = int(img[0, 0]) * 256 + int(img[0, 1])
        tier2 = cfg.matcher == "gather"
        n = 10 if k % 4 == 1 and not (tier2 and k % 8 == 1) else 1000
        ok = [True, k % 4 != 2, True]
        consistent = n == 1000 and all(ok) and k % 4 != 3
        out.append(VerifiedLoop(
            T_b_a=torch.eye(4), poses=torch.eye(4).expand(3, 4, 4),
            option_success=torch.tensor(ok), confidences=torch.full((3,), 0.5),
            n_matches=torch.tensor(n, dtype=torch.int32), consistent=torch.tensor(consistent),
            accepted=torch.tensor(consistent and n > cfg.min_matches_accept),
        ))
    return VerifiedLoop(**{f.name: torch.stack([getattr(r, f.name) for r in out])
                           for f in dataclasses.fields(VerifiedLoop)})


def _run(tmp_path, trace: bool, monkeypatch):
    """Map PLACES places, revisit them REVISITS times, verify, solve."""
    monkeypatch.setattr(P, "verify_pair_batch", _stub_verify)
    table = torch.nn.functional.normalize(
        torch.randn(PLACES, D, generator=torch.Generator().manual_seed(0)), dim=1)

    def describe(imgs):
        return table[imgs[:, 0, 2, 0].long() * 256 + imgs[:, 0, 3, 0].long()]

    rig = P.stereo.RectifiedRig(R0=np.eye(3), R1=np.eye(3), fx=10.0, fy=10.0, cx=4.0, cy=4.0,
                                baseline=0.1)
    pipe = P.CerebroPipeline(_config(tmp_path), rig=rig, describe_fn=describe, describe_dim=D,
                             device="cpu")
    pipe.timer.trace = trace
    k = 0
    for lap in range(1 + REVISITS):
        for place in range(PLACES):
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = 0.1 * place
            img = _frame(k, place)
            pipe.ingest_frame(1000.0 * lap + place, img, n_tracked=100, pose=pose, right_img=img)
            k += 1
    pipe.flush_descriptors()
    assert pipe.status()["undrained_batches"] > 0
    pipe.verify_pending()
    pipe.optimize_trajectory()
    return pipe


def _no_record_function(*a, **kw):
    raise AssertionError("record_function called with tracing off")


def test_pipeline_counters_ids_and_status(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _no_record_function)
    off = _run(tmp_path / "off", False, monkeypatch)
    monkeypatch.undo()
    on = _run(tmp_path / "on", True, monkeypatch)

    assert off.timer.export()["spans"] == []
    c = on.timer.counters()
    assert off.timer.counters() == c
    rejected = sum(v for k, v in c.items() if k.startswith("rejected."))
    # the capped list stops at its newest 256; the counters go on
    assert rejected > 256 == len(on.rejected_candidates) == on._max_rejected
    assert c["edges.accepted"] == len(on.loop_edges) > 0
    assert c["pairs.escalated"] == c["pairs.verified.tier2"] == on.escalated_to_tier2 > 0
    assert c["pairs.verified.tier1"] == c["candidates.raised"] == rejected + len(on.loop_edges)
    assert c["keyframes.ingested"] == c["keyframes.described"] == PLACES * (1 + REVISITS)
    assert c["detections.queued"] == c["detections.read_back"] > 0
    assert c["solve.gn_steps"] == 2 and 0 < c["solve.cg_iters"] <= 16
    st = on.status()
    assert st["verify_queue"] == st["undrained_batches"] == st["pending_candidates"] == 0
    # status() also shows the three verification-graph counts, 0 on the CPU
    assert st["counters"] == {**dict.fromkeys(GRAPH_COUNTERS, 0), **c}

    # every candidate id: raised once, decided once; tier 2's accepts
    raised = Counter(s["attrs"]["cid"] for s in _spans(on.timer, "cand.raised"))
    decided = {}
    for s in _spans(on.timer, "cand.decided"):
        assert s["attrs"]["cid"] not in decided
        decided[s["attrs"]["cid"]] = s["attrs"]["outcome"]
    assert set(raised.values()) == {1} and raised.keys() == decided.keys()
    assert len(raised) == c["candidates.raised"]
    groups = {s["id"]: s for s in _spans(on.timer, "verify")}
    tier2 = {s["attrs"]["cid"] for s in _spans(on.timer, "cand.verified")
             if s["attrs"]["tier"] == 2 and groups[s["attrs"]["group"]]["attrs"]["tier"] == 2}
    assert len(tier2) == on.escalated_to_tier2
    assert sum(decided[cid] == "accepted" for cid in tier2) == on.tier2_accepted > 0
    # the verify_queue gauge returns to 0; each keyframe is drained once
    assert _spans(on.timer, "verify_queue")[-1]["attrs"]["value"] == 0
    drained = Counter(s["attrs"]["kf"] for s in _spans(on.timer, "kf.drained"))
    assert set(drained.values()) == {1} and len(drained) == PLACES * (1 + REVISITS)
    # the drain's two parts sit inside it, the solve's steps inside it
    by_id = {s["id"]: s for s in _spans(on.timer)}
    for name, parent in (("drain.readback", "drain"), ("drain.gate", "drain"),
                         ("solve.assemble", "solve"), ("solve.cg", "solve.gn")):
        assert {by_id[s["parent"]]["name"] for s in _spans(on.timer, name)} == {parent}
    for p in (off, on):
        p.close()


def test_warmup_keeps_trace(tmp_path):
    pipe = P.CerebroPipeline(_config(tmp_path), describe_fn=lambda imgs: torch.ones(
        (imgs.shape[0], D)) / D**0.5, describe_dim=D, device="cpu")
    pipe.timer.trace = True
    real, seen = pipe._run_method, []

    def run_method(*a):
        seen.append(timing._CURRENT.get())
        return real(*a)

    pipe._run_method = run_method
    timer = pipe.timer
    pipe.warmup()
    assert len(seen) == 1 and seen[0] is not timer and seen[0].trace
    assert pipe.timer is timer and timer.trace and timer.export()["spans"] == []
    pipe.close()


def test_cg_iteration_counter_matches_matvec_calls(monkeypatch):
    rng = np.random.default_rng(3)
    n = 12
    x = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    odo_i = torch.arange(n, dtype=torch.int64)
    graph = optimizer.PoseGraph(
        xyzyaw=x, node_valid=torch.ones(n, dtype=torch.bool),
        odo_i=odo_i, odo_j=(odo_i + 1).clamp(max=n - 1),
        odo_meas=torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32)),
        odo_valid=odo_i < n - 1,
        loop_i=torch.tensor([0, 2]), loop_j=torch.tensor([9, 11]),
        loop_meas=torch.zeros(2, 4), loop_valid=torch.tensor([True, True]),
    )
    calls, real = [], optimizer._cg

    def cg(matvec, b, maxiter):
        def counted(v):
            calls.append(1)
            return matvec(v)

        return real(counted, b, maxiter)

    monkeypatch.setattr(optimizer, "_cg", cg)
    t = timing.StageTimer(trace=True)
    with t.bind():
        optimizer.optimize(graph, C.PoseGraphConfig(max_gn_iters=3, cg_iters=40))
    c = t.counters()
    assert c["solve.gn_steps"] == 3 and c["solve.cg_iters"] == len(calls) > 3
    assert sum(s["attrs"]["iters"] for s in _spans(t, "solve.cg")) == len(calls)


def test_verifier_spans_around_one_pair():
    from cerebro_tpu_torch import run_synthetic as rs
    from cerebro_tpu_torch.pretrain_synthetic import fractal_texture
    from cerebro_tpu_torch.verify.geometric import verify_pair_batch

    tex = fractal_texture(np.random.default_rng(rs.TEXTURE_SEED))
    crop = (slice(0, 96), slice(0, 128))
    a, b = (rs.stereo_pair(tex, rs.cam_pose(i)) for i in (0, 1))
    la, ra, lb, rb = (torch.from_numpy(im[crop].astype(np.float32))[None] for im in (*a, *b))
    rig = P.stereo.RectifiedRig(R0=np.eye(3), R1=np.eye(3), fx=rs.FX, fy=rs.FX, cx=rs.CX,
                                cy=rs.CY, baseline=rs.BASE)
    cfg = dataclasses.replace(C.VerifyConfig(), max_features=128, ransac_hypotheses=16,
                              num_disparities=16)
    t = timing.StageTimer(trace=True)
    with t.bind(), t.stage("verify"):
        verify_pair_batch(cfg, torch.Generator().manual_seed(0), la, ra, lb, rb, rig)
    names = [(s["name"], s["attrs"].get("option")) for s in _spans(t) if s["name"] != "verify"]
    assert names == [("verify.depth", None), ("verify.match", None), ("verify.ransac", "A"),
                     ("verify.ransac", "B"), ("verify.ransac", "C"), ("verify.gates", None)]
    top = _spans(t, "verify")[0]["id"]
    assert {s["parent"] for s in _spans(t) if s["name"] != "verify"} == {top}
