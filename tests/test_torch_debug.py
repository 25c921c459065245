"""The end-of-run debug dump of the port (CerebroPipeline.render_scores and
dump_debug) against the JAX package's, on tests/test_pipeline.py's stereo
stream with the same loop edges and rejections put into both pipelines
(verification itself is compared in tests/test_torch_pipeline.py):

- render_scores: the same bytes for the same score history and marks;
- dump_debug: the JAX package's file set, loop_edges.json and
  rejections.json equal to its own, status.json's counts;
- every PNG the port writes (its own encoder, utils/plot.encode_png)
  decodes, with the port's decoder and with PIL, to the .npy beside it."""

import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from cerebro_tpu.runtime import CerebroPipeline as JPipeline
from cerebro_tpu.runtime.pipeline import LoopEdge as JLoopEdge
from cerebro_tpu.runtime.pipeline import RejectedCandidate as JRejected
from cerebro_tpu_torch.io.euroc import decode_png
from cerebro_tpu_torch.runtime import CerebroPipeline, LoopEdge
from cerebro_tpu_torch.runtime.pipeline import RejectedCandidate

from test_pipeline import camera_pose, small_config
from test_torch_pipeline import TRIG, _feed, _port_config
from test_verify import make_rig


def _edges_and_rejections(make_edge, make_rejected):
    """One revisit edge (frame 14 revisits frame 2; the same view, so the
    identity) and two rejections, one with a gate reason per kind."""
    edge = make_edge(
        stamp_curr=20.0, stamp_prev=2.0, idx_curr=14, idx_prev=2,
        T_prev_curr=np.eye(4, dtype=np.float64), weight=0.75, n_matches=321,
    )
    rejected = [
        make_rejected(idx_curr=15, idx_prev=3, score=0.97, reason="too few matches (12 < 150 attempt gate)", n_matches=12),
        make_rejected(idx_curr=16, idx_prev=9, score=0.91, reason="match count 180 <= 200 accept gate", n_matches=180),
    ]
    return [edge], rejected


@pytest.fixture(scope="module")
def dumps(tmp_path_factory, stream_frames):
    root = tmp_path_factory.mktemp("dump")
    jcfg = small_config(root / "cfg_j")
    jp = JPipeline(jcfg, rig=make_rig())
    tp = CerebroPipeline(_port_config(jcfg), rig=TRIG, device="cpu")
    _feed(jp, stream_frames)
    _feed(tp, stream_frames)
    np.testing.assert_allclose(tp.score_history, jp.score_history, atol=1e-4)
    assert tp.detection_marks == jp.detection_marks
    jp.loop_edges, jp.rejected_candidates = _edges_and_rejections(JLoopEdge, JRejected)
    tp.loop_edges, tp.rejected_candidates = _edges_and_rejections(LoopEdge, RejectedCandidate)
    jp.dump_debug(str(root / "jax"))
    tp.dump_debug(str(root / "torch"))
    yield jp, tp, root / "jax", root / "torch"
    tp.close()


@pytest.fixture(scope="module")
def stream_frames():
    from test_pipeline import stereo_images
    from test_verify import big_texture

    tex = big_texture(np.random.default_rng(11), n=4096)
    frames = [stereo_images(tex, camera_pose(i)) for i in range(14)]
    out = [(float(i), frames[i], camera_pose(i)) for i in range(14)]
    out += [(20.0 + k, frames[i], camera_pose(14 + k)) for k, i in enumerate(range(2, 6))]
    return out


def test_render_scores_bytes_equal_jax(dumps):
    jp, tp, _, _ = dumps
    # the same history in both (the two only agree within 1e-4 otherwise)
    tp._score_history = list(jp.score_history)
    img_t, img_j = tp.render_scores(), np.asarray(jp.render_scores())
    assert img_t.dtype == img_j.dtype == np.uint8
    assert img_t.tobytes() == img_j.tobytes()
    assert len(tp.detection_marks) >= 1  # the marks are drawn


def _has_cv2():
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def test_dump_debug_writes_jax_files(dumps):
    _, tp, jdir, tdir = dumps
    jfiles, tfiles = set(os.listdir(jdir)), set(os.listdir(tdir))
    if not _has_cv2():  # the JAX package writes PNGs only through OpenCV
        jfiles |= {f[:-4] + ".png" for f in jfiles if f.endswith(".npy") and f != "trajectory.npy"}
    assert tfiles == jfiles
    assert {"score_curve.png", "trajectory_render.png", "pair_0000.png", "reject_0001.png"} <= tfiles
    for name in ("loop_edges.json", "rejections.json"):
        with open(jdir / name) as fj, open(tdir / name) as ft:
            assert json.load(ft) == json.load(fj), name
    with open(jdir / "status.json") as fj, open(tdir / "status.json") as ft:
        sj, st = json.load(fj), json.load(ft)
    for key in ("frames", "keyframes", "described", "loop_edges", "rejected_candidates"):
        assert st[key] == sj[key], key
    traj_t, traj_j = np.load(tdir / "trajectory.npy"), np.load(jdir / "trajectory.npy")
    assert traj_t.shape == traj_j.shape == (tp.store.size, 4, 4)


def test_dump_debug_pngs_decode_to_their_npy(dumps):
    _, _, _, tdir = dumps
    pngs = sorted(f for f in os.listdir(tdir) if f.endswith(".png"))
    assert len(pngs) == 5  # score curve, trajectory, one edge, two rejections
    for name in pngs:
        want = np.load(tdir / (name[:-4] + ".npy"))
        data = (tdir / name).read_bytes()
        np.testing.assert_array_equal(decode_png(data), want)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), want)
