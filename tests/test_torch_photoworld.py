"""The port's photo world against the JAX package's: the bundled photos
(artifacts/photoworld_photos.npz) equal ``load_photos()``, and the world,
its rendered stereo frames and its survey sequence are identical."""

import numpy as np
import pytest

from cerebro_tpu import photoworld as jpw
from cerebro_tpu import synthworld as jsw
from cerebro_tpu_torch import photoworld as tpw
from cerebro_tpu_torch import synthworld as tsw


def test_bundled_photos_equal_load_photos():
    want = jpw.load_photos()
    got = tpw.load_photos()
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def worlds():
    return jpw.PhotoWorld.create(seed=0), tpw.PhotoWorld.create(seed=0)


def test_world_identical(worlds):
    jw, tw = worlds
    np.testing.assert_array_equal(tw.tex, jw.tex)
    np.testing.assert_array_equal(tw.mask, jw.mask)
    assert tw.tex_m == jw.tex_m
    assert tpw.PHOTO_RADIUS_M == jpw.PHOTO_RADIUS_M


def test_rendered_frames_identical(worlds):
    jw, tw = worlds
    jr, tr = jsw.Renderer(jw), tsw.Renderer(tw)
    r = tpw.PHOTO_RADIUS_M
    for th in np.linspace(0.0, 2 * np.pi, 5, endpoint=False):
        x, y = r * np.cos(th), r * np.sin(th)
        for a, b in zip(tr.stereo(x, y), jr.stereo(x, y)):
            assert a.dtype == np.uint8 and a.std() > 10  # real texture
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tr.depth(x, y), jr.depth(x, y))


@pytest.mark.parametrize("n_frames,laps", [(400, 1.4), (1000, 3.5)])
def test_photo_sequence_identical(n_frames, laps):
    js = jpw.make_photo_sequence(n_frames=n_frames, laps=laps)
    ts = tpw.make_photo_sequence(n_frames=n_frames, laps=laps)
    assert ts.kidnap_span == js.kidnap_span
    for name in ("xy", "stamps", "gt_poses", "odom_poses", "n_tracked", "is_keyframe"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    np.testing.assert_array_equal(tsw.revisit_ground_truth(ts), jsw.revisit_ground_truth(js))
