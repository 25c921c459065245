"""What a first-visit mapping mix needs of the harness: the spiral track,
the world built in bands, the period and first-visit guards, the describe
readers, and a small CPU rehearsal of a survey (no solve in its window)
beside the relocalize cell's (a solve ending each round).

No traffic file holds a survey yet: ``SURVEY`` is the mix that sized the
room on the H100 (PERF.md), kept here as the tests' example."""

import hashlib
import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import readers, route, run, system
from portbench import world as W
from portbench.tests.test_portbench_faults import small_config, small_relocalize

PB = Path(__file__).resolve().parents[1]
BIG_SEED = 2**31 + 12345
SEEDS = (BIG_SEED, 7, 4294967311)


# an outward spiral over fresh ground: rings 12 m apart from 10 m out, at the
# relocalize track's ground speed (2 pi 14 m a 28.5714 s lap); 286 keyframes
# of prefill and 2,048 in the window, in the 122.88 m world
SURVEY = {
    "loop": "closed", "dt_s": 0.1, "keyframe_every": 1, "solve_every_batches": 0,
    "nominal_keyframes_per_s": 40.0, "first_visit": True,
    "world": {"seed": 0, "n": 12288, "tex_m": 100.0, "n_sectors": 9, "cell_m": 2.0, "r_max_m": 77.0},
    "tracks": {"spiral": {"spiral": {"r0_m": 10.0, "pitch_m": 12.0}, "speed_m_s": 3.0788}},
    "segments": [{"track": "spiral", "s": 28.6, "part": "prefill"}, {"track": "spiral", "s": 210.0}],
    "trace_at_s": 8.0, "trace_s": 4.0,
}


def traffic(mix):
    if mix == "survey":
        return json.loads(json.dumps(SURVEY))
    return json.loads((PB / "traffic" / f"{mix}.json").read_text())


def rig(config):
    return json.loads((PB / "configs" / f"{config}.json").read_text())["rig"]


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# The spiral
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_spiral_flies_at_its_speed_and_pitch(seed):
    t = traffic("survey")
    tr = t["tracks"]["spiral"]
    s = route.generate(t, seed)
    xy = s.xy.astype(np.float64)
    step = np.linalg.norm(np.diff(xy, axis=0), axis=1)
    assert step.max() <= tr["speed_m_s"] * t["dt_s"] * 1.01
    assert step.min() >= tr["speed_m_s"] * t["dt_s"] * 0.99  # continuous, no teleport
    # r = r0 + pitch theta / 2 pi, theta the angle turned since the inner end
    theta = np.unwrap(np.arctan2(xy[:, 1], xy[:, 0]))
    theta -= theta[0]
    r = np.linalg.norm(xy, axis=1)
    assert r[0] == pytest.approx(tr["spiral"]["r0_m"], abs=1e-4)
    assert theta[-1] > 6 * np.pi  # several rings
    np.testing.assert_allclose(r, tr["spiral"]["r0_m"] + tr["spiral"]["pitch_m"] * theta / (2 * np.pi),
                               atol=1e-4)


def test_spiral_keeps_its_phase_between_segments():
    tracks = {"s": {"spiral": {"r0_m": 10.0, "pitch_m": 12.0}, "speed_m_s": 3.0},
              "c": {"radius_m": 14.0, "lap_s": 20.0}}
    one = {"dt_s": 0.1, "tracks": tracks, "segments": [{"track": "s", "s": 6.0}]}
    split = {"dt_s": 0.1, "tracks": tracks,
             "segments": [{"track": "s", "s": 2.0}, {"track": "c", "s": 1.0}, {"track": "s", "s": 4.0}]}
    a, b = route.generate(one, 3), route.generate(split, 3)
    on_s = b.track == "s"
    assert np.array_equal(a.xy, b.xy[on_s])
    with pytest.raises(ValueError, match="spiral"):
        route.generate({"dt_s": 0.1, "tracks": tracks,
                        "segments": [{"track": "s", "kidnap": {"frames": 5, "jump_laps": 0.3}}]}, 3)


# hashes of the streams and world as commit c1323a7 made them, before the spiral
# track and the banded build
BEFORE_ROUTES = {
    ("relocalize", BIG_SEED): ("3b0a76493f186487", "e7f99ed37d428f97"),
    ("relocalize", 7): ("2ae972c0cbe587fc", "49a6b611c974d7dc"),
    ("revisit", BIG_SEED): ("37d3a33651aef445", "30cf6a4693bc4404"),
    ("revisit", 7): ("efde95d117180bf2", "d03e13a355925225"),
}
BEFORE_WORLD_4096 = ("42d2ca76bd9397dd", "8d03e460be14dad2")


@pytest.mark.parametrize("mix, seed", sorted(BEFORE_ROUTES))
def test_circle_and_arc_routes_are_unchanged(mix, seed):
    s = route.generate(traffic(mix), seed)
    assert (sha(s.xy), sha(s.gt_poses, s.odom_poses)) == BEFORE_ROUTES[(mix, seed)]


# ---------------------------------------------------------------------------
# The world, in bands
# ---------------------------------------------------------------------------


def whole_world(seed, n, tex_m, n_sectors, cell_m, r_max_m):
    """The world as the whole-array build made it, every array n x n at once."""
    rng = np.random.default_rng(seed)
    with np.load(W.PHOTOS_NPZ) as z:
        photos = [z[f"photo_{k}"] for k in range(len(z.files))]
    cell_px = int(cell_m * tex_m)
    ax = (np.arange(n, dtype=np.float32) - n / 2) / tex_m
    wx, wy = np.meshgrid(ax, ax)
    r = np.hypot(wx, wy)
    phi = np.mod(np.arctan2(wy, wx), 2 * np.pi)
    sector_phi = 2 * np.pi / n_sectors
    sector = np.minimum((phi / sector_phi).astype(np.int32), n_sectors - 1)
    cell_phi = cell_m / (r_max_m / 1.4)
    cell_phi = sector_phi / max(int(round(sector_phi / cell_phi)), 1)
    ci = (phi / cell_phi).astype(np.int64)
    rj = (r / cell_m).astype(np.int64)
    u = (phi / cell_phi - ci).astype(np.float32)
    v = (r / cell_m - rj).astype(np.float32)
    tex = np.zeros((n, n), np.float32)
    for k in range(n_sectors):
        m = sector == k
        if not m.any():
            continue
        ph = photos[k]
        ph_h, ph_w = ph.shape
        sh, sw = min(cell_px, ph_h - 1), min(cell_px, ph_w - 1)
        cid = ci[m] * 100003 + rj[m] * 193
        oy = (((cid * 2654435761 + seed) & 0xFFFFFFFF) % max(ph_h - sh, 1)).astype(np.int64)
        ox = (((cid * 40503 + 9176 + seed) & 0xFFFFFFFF) % max(ph_w - sw, 1)).astype(np.int64)
        tex[m] = ph[oy + np.minimum((v[m] * sh).astype(np.int64), sh - 1),
                    ox + np.minimum((u[m] * sw).astype(np.int64), sw - 1)]
    tex = np.clip(tex + 0.05 * rng.standard_normal((n, n)).astype(np.float32), 0, 1)
    out = np.zeros((n, n), np.float32)
    for scale in (128, 256):
        big = np.kron(rng.normal(size=(n // scale, n // scale)).astype(np.float32),
                      np.ones((scale, scale), np.float32))
        for _ in range(3):
            big = 0.25 * (np.roll(big, 1, 0) + np.roll(big, -1, 0) + np.roll(big, 1, 1) + np.roll(big, -1, 1))
        out += 1.0 * big
    return tex, (out - out.min()) / (out.max() - out.min()) > 0.62


@pytest.mark.parametrize("params", [
    dict(seed=0, n=512, tex_m=20.0, n_sectors=9, cell_m=2.0, r_max_m=12.0),
    dict(seed=3, n=768, tex_m=25.0, n_sectors=7, cell_m=1.5, r_max_m=30.0),
    dict(seed=11, n=1024, tex_m=100.0, n_sectors=9, cell_m=2.0, r_max_m=77.0),
])
def test_banded_world_equals_the_whole_one(params, monkeypatch):
    tex, mask = whole_world(**params)
    for band in (1, 7, 100, params["n"], 5000):
        monkeypatch.setattr(W, "BAND_ROWS", band)
        t, m = W.build_world(**params)
        assert t.dtype == tex.dtype and m.dtype == mask.dtype
        assert np.array_equal(t, tex) and np.array_equal(m, mask), band


def test_relocalize_world_is_unchanged():
    tex, mask = W.build_world(**traffic("relocalize")["world"])
    assert (sha(tex), sha(mask)) == BEFORE_WORLD_4096


# ---------------------------------------------------------------------------
# The guards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mix", ["relocalize", "revisit", "survey"])
@pytest.mark.parametrize("config", ["bench_e2e_top3", "flagship_top1_live"])
def test_period_guard_passes_every_mix(mix, config):
    t = traffic(mix)
    for seed in SEEDS:
        W.check_period(route.generate(t, seed).xy, t["world"], rig(config))


def test_period_guard_refuses_ground_past_the_period():
    t = traffic("relocalize")
    t["tracks"]["main"]["radius_m"] = 16.0  # 16 + 5.14 m of footprint > 20.48
    with pytest.raises(ValueError, match="period of 40.96 m"):
        W.check_period(route.generate(t, 7).xy, t["world"], rig("bench_e2e_top3"))
    s = traffic("survey")
    s["world"] = traffic("relocalize")["world"]  # the spiral in the 40.96 m world
    with pytest.raises(ValueError, match="period of 40.96 m"):
        W.check_period(route.generate(s, 7).xy, s["world"], rig("bench_e2e_top3"))


def test_footprint_of_the_euroc_rig():
    x0, x1, y0, y1 = W.ground_footprint(rig("bench_e2e_top3"))
    assert x1 - x0 == pytest.approx(6.0 * 752 / 458.654)
    assert y1 - y0 == pytest.approx(6.0 * 480 / 457.296)
    u0, u1, v0, v1 = W.union_footprint(rig("bench_e2e_top3"))
    assert (u0, v0, v1) == (x0, y0, y1) and u1 == pytest.approx(x1 + 0.11)
    assert (u1 - u0, v1 - v0) == (pytest.approx(9.9475, abs=1e-4), pytest.approx(6.2979, abs=1e-4))


def first_visit(t, seed, config="bench_e2e_top3"):
    cfg = json.loads((PB / "configs" / f"{config}.json").read_text())
    s = route.generate(t, seed)
    system._check_first_visit(cfg, t, s, s.index("window"))


@pytest.mark.parametrize("seed", SEEDS)
def test_first_visit_guard_passes_the_survey(seed):
    first_visit(traffic("survey"), seed)


@pytest.mark.parametrize("mix", ["relocalize", "revisit"])
def test_first_visit_guard_refuses_a_revisiting_mix(mix):
    t = traffic(mix)
    first_visit(t, 7, "flagship_top1_live")  # not a first-visit mix: no guard
    t["first_visit"] = True
    with pytest.raises(ValueError, match="sees ground twice"):
        first_visit(t, 7, "flagship_top1_live")


def test_first_visit_guard_refuses_rings_closer_than_the_footprint():
    t = traffic("survey")
    t["tracks"]["spiral"]["spiral"]["pitch_m"] = 9.0  # under the footprint's 9.95 m along x
    with pytest.raises(ValueError, match="9.95 x 6.30 m footprints overlap"):
        first_visit(t, 7)


@pytest.mark.parametrize("dx, dy, overlap", [
    (9.5, 4.5, True),  # 10.51 m apart on a diagonal: over the long side, yet the footprints overlap
    (-9.5, -4.5, True),
    (9.9, 0.0, True),
    (0.0, 6.2, True),
    (10.0, 0.0, False),
    (0.0, 6.4, False),
    (9.5, 6.5, False),
])
def test_first_visit_guard_refuses_footprints_that_overlap(dx, dy, overlap):
    # keyframe 0 at the origin, 51 more far off and apart, then one beside keyframe 0
    xy = np.array([(0.0, 0.0)] + [(1000.0 + 20.0 * k, 1000.0) for k in range(51)] + [(dx, dy)])
    s = SimpleNamespace(xy=xy, is_keyframe=np.ones(len(xy), bool))
    fp = W.union_footprint(rig("bench_e2e_top3"))
    if overlap:
        with pytest.raises(ValueError, match="keyframe 52 lies .* from keyframe 0, 52 keyframes before it"):
            route.check_first_visit(s, range(len(xy)), 50, fp)
    else:
        route.check_first_visit(s, range(len(xy)), 50, fp)
    route.check_first_visit(s, range(len(xy)), 52, fp)  # within the exclusion window: not a revisit


# ---------------------------------------------------------------------------
# The describe readers
# ---------------------------------------------------------------------------


class Ctx:
    def __init__(self, run_):
        self.run, self.describe_flops, self.width = run_, 4e9, 8192


def test_describe_readers_arithmetic():
    run_ = system.Run(window_t0=10.0, window_t1=20.0)
    totals = lambda s, n: {"describe": {"total_s": s, "count": n}}  # noqa: E731
    run_.program = {"spans": [], "snapshots": [
        (10.0, {"keyframes.described": 0}, totals(0.0, 0)),
        (12.0, {"keyframes.described": 32}, totals(0.5, 2)),
        (14.0, {"keyframes.described": 64}, totals(1.0, 4)),
        (20.0, {"keyframes.described": 160}, totals(2.5, 10))]}
    assert readers.load("describe_share.survey").read(Ctx(run_)) == pytest.approx(25.0)
    mfu = readers.load("describe_mfu.survey")
    assert mfu.read(Ctx(run_)) is None  # no trace
    run_.trace_t = (12.0, 14.0)
    run_.trace = {"device_events": [(12.1, 12.1 + 1e-3, "conv"), (12.2, 12.2 + 3e-3, "conv"),
                                    (12.3, 12.4, "gemm")],
                  "device_spans": [("describe",), ("assemble", "describe"), ("verify",)]}
    # 32 frames x 4 GFLOP over 4 ms of the describe spans' device time
    assert mfu.read(Ctx(run_)) == pytest.approx(100.0 * 32 * 4e9 / 4e-3 / 989e12)
    run_.trace["device_spans"] = [("verify",)] * 3
    assert mfu.read(Ctx(run_)) is None


# ---------------------------------------------------------------------------
# CPU rehearsals: the survey's window holds no solve; the relocalize cell's
# rounds each end in one
# ---------------------------------------------------------------------------


RELOCALIZE = "bench_e2e_top3.relocalize"


def with_describe_readers(bench: dict) -> dict:
    """The benchmark with the two describe readers listed for the relocalize
    cell, which the rehearsal below drives over a survey."""
    bench = json.loads(json.dumps(bench))
    for name, source, better in [("describe_share.survey", "program_span", "lower"),
                                 ("describe_mfu.survey", "device_trace", "higher")]:
        bench["per_layer"].append({"name": name, "unit": "%", "better": better, "source": source,
                                   "layer": "describe", "moves": "keyframes_per_s", "workloads": [RELOCALIZE]})
    return bench


def small_survey(_):
    t = traffic("survey")
    t["world"] = traffic("relocalize")["world"]
    # rings 8.5 m apart, over the small rig's 6.51 x 4.80 m footprint's diagonal,
    # 1.4 m a keyframe: beyond an exclusion window of 10 keyframes (15.4 m of
    # track) no ground is seen twice, and the 60 keyframes stay in the 40.96 m world
    t["tracks"]["spiral"] = {"spiral": {"r0_m": 6.0, "pitch_m": 8.5}, "speed_m_s": 14.0}
    t["segments"] = [{"track": "spiral", "s": 2.0, "part": "prefill"}, {"track": "spiral", "s": 4.5}]
    t["trace_at_s"] = 0.0
    t["trace_s"] = 1.0
    return t


def small_survey_config(c):
    c = small_config(c)
    c["cerebro_config"]["loop"]["exclusion_window"] = 10
    return c


def counted_solves(monkeypatch) -> list:
    from cerebro_tpu_torch.runtime import pipeline as P

    calls = []
    real = P.CerebroPipeline.optimize_trajectory

    def optimize_trajectory(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(P.CerebroPipeline, "optimize_trajectory", optimize_trajectory)
    return calls


def rehearse(capsys, cell, traffic_override, config_override, seconds, trace):
    torch.manual_seed(0)
    rc = run.main(["--workload", cell, "--seed", "4294967311", "--seconds", seconds, "--trace", trace],
                  device="cpu", traffic_override=traffic_override, config_override=config_override,
                  bench_override=with_describe_readers)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_survey_rehearsal_solves_nowhere_in_its_window(monkeypatch, capsys):
    torch.set_num_threads(4)
    solves = counted_solves(monkeypatch)
    # the relocalize cell's configuration, limits and readers over a small survey
    line = rehearse(capsys, RELOCALIZE, small_survey, small_survey_config, "1.0", "1")
    assert line["correct"], line["compared"]
    notes = line["notes"]["setup_detail"]
    # 1.0 s at 40 keyframes/s: 10 batches of 4, each verified; the one solve is set-up's
    assert line["attempted"] == 40 and notes["rounds"] == 10
    assert len(solves) == 1 and notes["solves_in_window"] == 0
    assert line["notes"]["window_stages"]["solve"] == [0.0, 0]
    assert line["notes"]["window_stages"]["verify_tier1"][1] == 10
    share = line["metrics"]["describe_share.survey"]
    assert share["unit"] == "%" and 0.0 < share["value"] <= 100.0


def test_relocalize_rehearsal_ends_each_round_in_a_solve(monkeypatch, capsys):
    torch.set_num_threads(4)
    solves = counted_solves(monkeypatch)
    seconds = "0.1"
    line = rehearse(capsys, RELOCALIZE, small_relocalize, small_config, seconds, "0")
    assert line["correct"], line["compared"]
    t = small_relocalize(traffic("relocalize"))
    rounds = max(1, math.ceil(float(seconds) * t["nominal_keyframes_per_s"] / (4 * t["solve_every_batches"])))
    notes = line["notes"]["setup_detail"]
    assert notes["rounds"] == rounds and notes["solves_in_window"] == rounds
    assert len(solves) == 1 + rounds
    assert line["notes"]["window_stages"]["solve"][1] == rounds
