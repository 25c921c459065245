"""A small CPU rehearsal of the route generator on every traffic mix."""

import json
import math
from pathlib import Path

import numpy as np
import pytest

from portbench import route
from portbench import world as W

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))
BIG_SEED = 2**31 + 12345  # beyond 32 signed bits, as a run's seed may be


def load(mix):
    return json.loads((TRAFFIC / f"{mix}.json").read_text())


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_stream_other_seed_same_work(mix):
    t = load(mix)
    a, b, c = route.generate(t, BIG_SEED), route.generate(t, BIG_SEED), route.generate(t, 7)
    assert np.array_equal(a.xy, b.xy) and np.array_equal(a.odom_poses, b.odom_poses)
    assert not np.array_equal(a.xy, c.xy)
    # another seed flies other ground with the same sizes and arrivals
    for f in ("stamps", "is_keyframe", "has_pose", "n_tracked", "part", "track"):
        assert np.array_equal(getattr(a, f), getattr(c, f)), f


@pytest.mark.parametrize("mix", MIXES)
def test_frames_stay_on_their_tracks(mix):
    t = load(mix)
    s = route.generate(t, BIG_SEED)
    for name, tr in t["tracks"].items():
        r = np.linalg.norm(s.xy[s.track == name], axis=1)
        assert np.allclose(r, tr["radius_m"], atol=1e-3)
    assert np.allclose(np.diff(s.stamps), t["dt_s"])
    kf = np.nonzero(s.is_keyframe)[0]
    assert np.all(np.diff(kf) >= t.get("keyframe_every", 1))


def test_revisit_share_of_the_live_window():
    t = load("revisit")
    s = route.generate(t, BIG_SEED)
    win = [i for i in s.index("window") if s.is_keyframe[i]]
    seen = [i for i in win if s.track[i] == "seen"]
    assert len(seen) / len(win) == pytest.approx(t["revisit_share"], abs=0.02)
    # the window's revisiting keyframes fly ground the prefill covered
    pre = s.xy[s.index("prefill")]
    d = np.min(np.linalg.norm(s.xy[seen][:, None] - pre[None], axis=-1), axis=1)
    assert d.max() < 0.5
    # the others fly ground that no keyframe more than 10 s older saw
    for i in [i for i in win if s.track[i] == "new"]:
        older = [j for j in range(i) if s.stamps[i] - s.stamps[j] > 10.0]
        if older:
            assert np.min(np.linalg.norm(s.xy[older] - s.xy[i], axis=1)) > 5.0


def test_relocalize_window_holds_the_rounds_of_a_long_run():
    t = load("relocalize")
    s = route.generate(t, BIG_SEED)
    win = s.index("window")
    per_round = 16 * t["solve_every_batches"]
    rounds = math.ceil(51 * t["nominal_keyframes_per_s"] / per_round)
    assert rounds == 4  # the rounds measured: 54-75 s at the parent's ~6 keyframes/s
    assert s.is_keyframe[win].sum() >= 2 * rounds * per_round


def test_relocalize_kidnap_opens_a_world():
    s = route.generate(load("relocalize"), BIG_SEED)
    lost = np.nonzero(~s.has_pose)[0]
    assert len(lost) == 35 and np.all(np.diff(lost) == 1)
    assert not s.is_keyframe[lost].any() and np.all(s.n_tracked[lost] < 15)
    assert set(s.world[: lost[0]]) == {0} and set(s.world[lost[-1] + 1:]) == {1}
    # the new world's odometry restarts at its own origin
    assert np.allclose(s.odom_poses[lost[-1] + 1][:3, 3], 0.0)
    assert route.revisit_truth(s)[lost[-1] + 1:].mean() > 0.9


@pytest.mark.parametrize("hw", [(240, 320), (480, 752)])
def test_renderer_small_world(hw):
    tex, mask = W.build_world(seed=0, n=512, tex_m=20.0, n_sectors=9, cell_m=2.0, r_max_m=12.0)
    rig = {"image_hw": list(hw), "fx": hw[1] * 0.61, "fy": hw[1] * 0.61, "cx": hw[1] / 2,
           "cy": hw[0] / 2, "baseline": 0.11}
    ren = W.Renderer(tex, mask, 20.0, "cpu", rig)
    left, right = ren.stereo_frames(np.array([[3.0, 1.0], [-2.0, 0.5]], np.float32))
    assert left.shape == (2, *hw) and left.dtype == np.uint8
    assert left.std() > 5 and not np.array_equal(left, right)
    # a frame depends on its position alone
    again, _ = ren.stereo_frames(np.array([[3.0, 1.0]], np.float32))
    assert np.array_equal(again[0], left[0])
