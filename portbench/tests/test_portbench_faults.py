"""The harness on the CPU at a small size, its chip check skipped: a sound
run of each cell comes out correct, and each fault the cell can have,
planted in the system's timed path, and the control come out not correct.

Faults: a step that returns its state unchanged (the DB append writes no
row), half of the batch left out (the describe call's second half repeats
its first), a search that skips half the DB or finds nothing (detect), an
answer altered where it is produced (every accepted edge recorded against
the frame ten frames before its own), and a solve that returns its input.
The cells run on one chip, so there is no exchange between chips to leave
out. ``plant("edge_inverted", ...)`` (every accepted edge's pose replaced
by its inverse) is read on the chip at the cell's size only: the small
run's accepted pairs lie too close together for an inversion to show.
"""

import json

import numpy as np
import pytest
import torch

from portbench import run

RIG_SMALL = {"image_hw": [240, 320], "fx": 300.0, "fy": 300.0, "cx": 160.0, "cy": 120.0,
             "baseline": 0.11}


def small_relocalize(t):
    t = json.loads(json.dumps(t))
    t["tracks"]["main"]["lap_s"] = 4.0
    t["segments"] = [{"track": "main", "s": 4.0, "part": "prefill"},
                     {"track": "main", "kidnap": {"frames": 35, "jump_laps": 0.3}},
                     {"track": "main", "s": 8.0}]
    t["solve_every_batches"] = 2
    t["trace_at_s"] = 0.0
    return t


def small_revisit(t):
    t = json.loads(json.dumps(t))
    t["tracks"] = {"seen": {"radius_m": 14.0, "lap_s": 4.0, "start": 0.0, "arc": 0.5},
                   "new": {"radius_m": 14.0, "lap_s": 20.0, "start": 0.6, "arc": 0.3}}
    t["segments"] = [{"track": "seen", "s": 2.0, "part": "prefill"},
                     {"repeat": 3, "segments": [{"track": "seen", "s": 1.0}, {"track": "new", "s": 1.0}]},
                     {"track": "seen", "s": 3.0, "part": "tail"}]
    t["trace_at_s"] = 0.5
    t["trace_s"] = 1.0
    return t


def small_config(c):
    c = json.loads(json.dumps(c))
    cc = c["cerebro_config"]
    cc["loop"].update(db_capacity=512, exclusion_window=4, candidates_per_query=1)
    cc["runtime"]["descriptor_batch"] = 4
    # a small rig, 1,024 features and the gate rescaled to them, for the CPU
    c["rig"] = RIG_SMALL
    cc["descriptor"]["image_hw"] = RIG_SMALL["image_hw"]
    cc["verify"].update(max_features=1024, max_matches=1024, gms_factor=4.0, min_matches_accept=200,
                        min_pair_dt_s=1.0)
    if "posegraph" in cc:
        cc["posegraph"] = {"node_bucket_floor": 128, "loop_bucket_floor": 32}
    if "service" in c:
        c["service"]["optimize_every_s"] = 2.0
    c["warmup"] = {}
    return c


def with_live_cell(bench):
    """The benchmark with the live node's revisit cell, which it measured
    but does not list (PERF.md, Open questions): its open-loop path stays
    rehearsed for the later PR that lists it."""
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({"name": "flagship_top1_live", "file": "portbench/configs/flagship_top1_live.json"})
    bench["workloads"].append({"name": "flagship_top1_live.revisit", "config": "flagship_top1_live",
                               "traffic": "revisit", "chips": 1})
    for name, unit in [("decision_p90_ms", "ms"), ("keyframe_p95_ms", "ms")]:
        bench["end_to_end"].append({"name": name, "unit": unit, "source": "host_clock",
                                    "workloads": ["flagship_top1_live.revisit"]})
    return bench


CELLS = {
    "bench_e2e_top3.relocalize": (small_relocalize, "0.1"),
    "flagship_top1_live.revisit": (small_revisit, "4.0"),
}
FAULTS = [None, "state_unchanged", "half_batch_left_out", "search_skips_half", "search_finds_nothing",
          "edge_altered", "solve_returns_input", "control"]
# the live cell does not judge its solve (PERF.md, Open questions)
CASES = [(cell, f) for cell in sorted(CELLS) for f in FAULTS
         if not (cell == "flagship_top1_live.revisit" and f == "solve_returns_input")]


def plant(name, monkeypatch):
    import cerebro_tpu_torch.models.mobilenet as mn
    from cerebro_tpu_torch.db import descriptors as ddb
    from cerebro_tpu_torch.runtime import pipeline as P

    if name == "state_unchanged":
        real = ddb.append

        def append(db, descs, n_new):  # every step but the row write
            saved = db.vectors.clone()
            real(db, descs, n_new)
            db.vectors.copy_(saved)
            return db

        monkeypatch.setattr(ddb, "append", append)
    elif name == "half_batch_left_out":
        real = mn.ported_forward

        def forward(params, imgs, **kw):
            h = imgs.shape[0] // 2
            return real(params, torch.cat([imgs[:h], imgs[:h]]), **kw)

        monkeypatch.setattr(mn, "ported_forward", forward)
    elif name == "edge_altered":
        import dataclasses

        real = P.CerebroPipeline._emit_edges

        def emit(self, cands, res, **kw):
            n0 = len(self.loop_edges)
            n = real(self, cands, res, **kw)
            for k in range(n0, len(self.loop_edges)):
                e = self.loop_edges[k]
                self.loop_edges[k] = dataclasses.replace(e, idx_prev=max(e.idx_prev - 10, 0))
            return n

        monkeypatch.setattr(P.CerebroPipeline, "_emit_edges", emit)
    elif name in ("search_skips_half", "search_finds_nothing"):
        from cerebro_tpu_torch.ops import similarity as S

        def cut(limits):
            return limits // 2 if name == "search_skips_half" else torch.zeros_like(limits)

        real_max, real_topk = S.max_and_argmax, S.search_topk

        def max_and_argmax(q, db, limits, *a, **kw):
            return real_max(q, db, cut(limits), *a, **kw)

        def search_topk(q, db, limits, *a, **kw):
            return real_topk(q, db, cut(limits), *a, **kw)

        monkeypatch.setattr(S, "max_and_argmax", max_and_argmax)
        monkeypatch.setattr(S, "search_topk", search_topk)
    elif name == "edge_inverted":
        import dataclasses

        real = P.CerebroPipeline._emit_edges

        def emit(self, cands, res, **kw):
            n0 = len(self.loop_edges)
            n = real(self, cands, res, **kw)
            for k in range(n0, len(self.loop_edges)):
                e = self.loop_edges[k]
                T = np.linalg.inv(e.T_prev_curr).astype(e.T_prev_curr.dtype)
                self.loop_edges[k] = dataclasses.replace(e, T_prev_curr=T)
            return n

        monkeypatch.setattr(P.CerebroPipeline, "_emit_edges", emit)
    elif name == "solve_returns_input":
        def optimize(graph, cfg):
            return graph.xyzyaw, None, None

        monkeypatch.setattr(P, "optimize", optimize)


def one_run(capsys, cell, *extra):
    traffic, seconds = CELLS[cell]
    torch.manual_seed(0)
    rc = run.main(["--workload", cell, "--seed", "4294967311", "--seconds", seconds, "--trace", "0",
                   *extra], device="cpu", traffic_override=traffic, config_override=small_config,
                  bench_override=with_live_cell)
    assert rc == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    sanity = next(json.loads(x.split("sanity ", 1)[1]) for x in err.splitlines() if "portbench: sanity" in x)
    return line, sanity


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_is_caught(cell, fault, monkeypatch, capsys):
    torch.set_num_threads(4)
    if fault not in (None, "control"):
        plant(fault, monkeypatch)
    line, sanity = one_run(capsys, cell, *(["--control", "1"] if fault == "control" else []))
    cmp = {k: v["value"] for k, v in line["compared"].items()}
    if fault is None:
        assert line["correct"], cmp
        # the small run raises, verifies, accepts and solves: every layer is judged
        assert line["attempted"] > 0 and sanity["candidates"] > 0 and sanity["edges"] > 0, sanity
    else:
        assert not line["correct"], cmp
