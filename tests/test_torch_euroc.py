"""The port's EuRoC loader, its PNG decoder and its one-command entry point
(cerebro_tpu_torch/io/euroc.py, cerebro_tpu_torch/run_euroc.py) against the
JAX package's.

- decode_png_gray equals PIL bit for bit on 8-bit grayscale PNGs written
  here with zlib, one per row filter (None, Sub, Up, Average, Paeth), one
  mixing all five, and one written by PIL; it raises ValueError on RGB,
  16-bit and interlaced files;
- EurocSequence on tests/test_euroc_loader.py's mini ASL folder: the same
  stamps, right-image association, poses (1e-6) and stride behaviour;
- ``python -m cerebro_tpu_torch.run_euroc <mini mav0> --cpu --descriptor
  gist --stride 1 --ate --odom-drift 0.05 --config <mini rig> --trace DIR``
  as a subprocess: exit 0, report.json with the JAX script's keys,
  n_frames == 8, ate_before > 0, ate_after set, a Chrome trace in DIR, the
  trajectory files; ``--descriptor netvlad`` through both packages'
  run_euroc: the same report keys, frames, found loops and edges;
- utils/plot.py's three renderers give the JAX package's images."""

import dataclasses
import io
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from cerebro_tpu.eval import RunReport as JRunReport
from cerebro_tpu.io.euroc import EurocSequence as JSequence
from cerebro_tpu_torch.io.euroc import EurocSequence, decode_png_gray

from test_euroc_loader import _write_mini_rig, make_mini_euroc

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _chunk(ctype: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + ctype + data + struct.pack(">I", zlib.crc32(ctype + data))


def _png(img: np.ndarray, filters, depth=8, color=0, interlace=0) -> bytes:
    """An 8-bit grayscale PNG of ``img`` whose row r uses filter
    filters[r % len(filters)] (the reference encoder of the PNG spec)."""
    H, W = img.shape
    x = img.astype(np.int16)
    rows = []
    for r in range(H):
        f = filters[r % len(filters)]
        up = x[r - 1] if r > 0 else np.zeros(W, np.int16)
        left = np.concatenate([[0], x[r, :-1]])
        upleft = np.concatenate([[0], up[:-1]])
        if f == 0:
            pred = np.zeros(W, np.int16)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        rows.append(bytes([f]) + ((x[r] - pred) & 0xFF).astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, interlace)
    return (
        b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b"")
    )


@pytest.mark.parametrize(
    "filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4], [4, 1, 3, 2]],
    ids=["none", "sub", "up", "average", "paeth", "all_five", "mixed"],
)
def test_png_decoder_equals_pil(filters, rng):
    img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    img[5:15, 10:30] = 200  # flat patches: equal predictor distances (ties)
    data = _png(img, filters)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    out = decode_png_gray(data)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, pil)
    np.testing.assert_array_equal(out, img)


def test_png_decoder_reads_pil_written_file(rng):
    img = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png_gray(buf.getvalue()), img)


@pytest.mark.parametrize("kind", ["rgb", "16bit", "interlaced", "pil_rgb"])
def test_png_decoder_rejects_other_kinds(kind, rng):
    img = rng.integers(0, 256, (8, 12), dtype=np.uint8)
    if kind == "rgb":
        data = _png(img, [0], color=2)
    elif kind == "16bit":
        data = _png(img, [0], depth=16)
    elif kind == "interlaced":
        data = _png(img, [0], interlace=1)
    else:
        buf = io.BytesIO()
        Image.fromarray(np.stack([img] * 3, -1)).save(buf, format="PNG")
        data = buf.getvalue()
    with pytest.raises(ValueError):
        decode_png_gray(data)


def test_png_decoder_rejects_a_corrupt_chunk(rng):
    data = bytearray(_png(rng.integers(0, 256, (8, 12), dtype=np.uint8), [4]))
    data[40] ^= 0xFF  # inside the IDAT payload: its CRC no longer matches
    with pytest.raises(ValueError, match="corrupt"):
        decode_png_gray(bytes(data))


@pytest.mark.parametrize("right,gt", [(True, True), (False, False)])
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_sequence_matches_jax(tmp_path, right, gt, stride):
    mav0 = make_mini_euroc(str(tmp_path), n=7, with_right=right, with_gt=gt)
    js, ts = JSequence(mav0), EurocSequence(mav0)
    assert len(ts) == len(js) == 7
    jf, tf = list(js.frames(stride=stride)), list(ts.frames(stride=stride))
    assert len(tf) == len(jf) == len(range(0, 7, stride))
    for a, b in zip(tf, jf):
        assert a.stamp == b.stamp
        assert (a.left_path, a.right_path) == (b.left_path, b.right_path)
        np.testing.assert_array_equal(a.left(), b.left())
        if right:
            np.testing.assert_array_equal(a.right(), b.right())
        else:
            assert a.right() is None and b.right() is None
        if gt:
            assert a.pose.dtype == np.float32
            np.testing.assert_allclose(a.pose, b.pose, atol=1e-6, rtol=0)
        else:
            assert a.pose is None and b.pose is None


def test_sequence_tolerances_match_jax(tmp_path):
    """A right image 1.5 ms off and a pose 30 ms off are not associated;
    0.9 ms and 19 ms are (the ±1 ms and 20 ms rules)."""
    mav0 = make_mini_euroc(str(tmp_path), n=4)
    with open(os.path.join(mav0, "cam1", "data.csv")) as f:
        lines = f.read().splitlines()
    ns = [1_000_000_000 + 900_000, 2_000_000_000 + 1_500_000, 3_000_000_000, 4_000_000_000]
    with open(os.path.join(mav0, "cam1", "data.csv"), "w") as f:
        f.write(lines[0] + "\n")
        for line, n in zip(lines[1:], ns):
            f.write(f"{n},{line.split(',')[1]}\n")
    gt = os.path.join(mav0, "state_groundtruth_estimate0", "data.csv")
    with open(gt, "w") as f:
        f.write("#timestamp\n")
        for i, off in enumerate([19_000_000, 30_000_000, 0, 0]):
            f.write(f"{(i + 1) * 1_000_000_000 + off},{i},0,0,0.7071068,0.7071068,0,0\n")
    jf, tf = list(JSequence(mav0).frames()), list(EurocSequence(mav0).frames())
    assert [f.right_path is None for f in tf] == [f.right_path is None for f in jf]
    assert [f.pose is None for f in tf] == [f.pose is None for f in jf] == [False, True, False, False]
    assert tf[0].right_path is not None and tf[1].right_path is None
    for a, b in zip(tf, jf):
        if b.pose is not None:
            np.testing.assert_allclose(a.pose, b.pose, atol=1e-6, rtol=0)


def _run_euroc(tmp_path, *extra):
    mav0 = make_mini_euroc(str(tmp_path), n=8)
    cfg = _write_mini_rig(str(tmp_path))
    out = str(tmp_path / "out")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "cerebro_tpu_torch.run_euroc", mav0, "--out", out, "--cpu",
         "--stride", "1", "--ate", "--odom-drift", "0.05", "--config", cfg, *extra],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path), env=env,
    )
    return r, out


@pytest.fixture(scope="module")
def gist_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("run_euroc")
    trace = str(tmp / "trace")
    r, out = _run_euroc(tmp, "--descriptor", "gist", "--trace", trace)
    return r, out, trace


def _jax_status_keys(tmp_path):
    from cerebro_tpu.config import CerebroConfig, DescriptorConfig, RuntimeConfig
    from cerebro_tpu.runtime import CerebroPipeline

    cfg = CerebroConfig(
        descriptor=DescriptorConfig(image_hw=(48, 64), kind="gist", num_clusters=1, trunk_dim=32),
        runtime=RuntimeConfig(stash_dir=str(tmp_path / "stash")),
    )
    return set(CerebroPipeline(cfg).status())


def test_run_euroc_report_has_the_jax_keys(gist_run, tmp_path):
    r, out, _ = gist_run
    assert r.returncode == 0, r.stderr[-3000:]
    with open(os.path.join(out, "report.json")) as f:
        doc = json.load(f)
    assert set(doc) == {"report", "status", "loop_edges", "found_loops"}
    rep = doc["report"]
    assert set(rep) == {f.name for f in dataclasses.fields(JRunReport)}
    assert set(doc["status"]) >= _jax_status_keys(tmp_path)
    assert rep["n_frames"] == 8
    assert rep["ate_before"] is not None and rep["ate_before"] > 0.0
    assert rep["ate_after"] is not None
    # the stdout line is the report itself
    assert json.loads(r.stdout.strip().splitlines()[-1]) == rep
    traj = np.load(os.path.join(out, "trajectory.npy"))
    assert traj.shape == (8, 4, 4) and np.isfinite(traj).all()
    render = np.load(os.path.join(out, "trajectory_render.npy"))
    assert render.shape == (480, 480, 3) and render.dtype == np.uint8


def test_run_euroc_trace_writes_a_trace_file(gist_run):
    r, _, trace = gist_run
    assert r.returncode == 0, r.stderr[-3000:]
    files = [f for f in os.listdir(trace) if ".trace" in f]
    assert files, os.listdir(trace)
    with open(os.path.join(trace, files[0])) as f:
        assert json.load(f)["traceEvents"]


def test_run_euroc_trace_writes_the_programs_spans(gist_run):
    """Beside the Chrome trace: the timer's export, with the pipeline's
    stages as nested spans, the keyframe events and its counters."""
    r, _, trace = gist_run
    assert r.returncode == 0, r.stderr[-3000:]
    files = [f for f in os.listdir(trace) if f.endswith(".spans.json")]
    assert len(files) == 1, os.listdir(trace)
    with open(os.path.join(trace, files[0])) as f:
        ex = json.load(f)
    spans = [dict(zip(ex["span_fields"], s)) for s in ex["spans"]]
    names = {s["name"] for s in spans}
    assert {"describe", "detect", "kf.queued", "kf.described"} <= names, names
    ids = {s["id"] for s in spans}
    assert all(s["parent"] == 0 or s["parent"] in ids for s in spans)
    assert all(s["t0_ns"] <= s["t1_ns"] for s in spans)
    described = [s for s in spans if s["name"] == "kf.described"]
    assert ex["counters"]["keyframes.described"] == len(described) > 0


def test_run_euroc_netvlad_names_its_roadmap_item(tmp_path):
    """``--descriptor netvlad`` (the seeded in-framework net, once a
    ROADMAP item, now ported) through both packages' run_euroc on the mini
    folder: exit 0, the same report keys, frames, found loops and edges."""
    r, out = _run_euroc(tmp_path / "port", "--descriptor", "netvlad")
    assert r.returncode == 0, r.stderr[-3000:]
    mav0 = make_mini_euroc(str(tmp_path / "jax"), n=8)
    cfg = _write_mini_rig(str(tmp_path / "jax"))
    jout = str(tmp_path / "jax" / "out")
    jr = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "run_euroc.py"), mav0, "--out", jout,
         "--cpu", "--descriptor", "netvlad", "--stride", "1", "--ate", "--odom-drift", "0.05",
         "--config", cfg],
        capture_output=True, text=True, timeout=600,
    )
    assert jr.returncode == 0, jr.stderr[-3000:]
    docs = []
    for d in (out, jout):
        with open(os.path.join(d, "report.json")) as f:
            docs.append(json.load(f))
    doc, jdoc = docs
    assert set(doc) == set(jdoc) and set(doc["report"]) == set(jdoc["report"])
    assert doc["report"]["n_frames"] == jdoc["report"]["n_frames"] == 8
    assert doc["status"]["described"] == jdoc["status"]["described"]
    assert doc["found_loops"] == jdoc["found_loops"]
    assert [(e["idx0"], e["idx1"]) for e in doc["loop_edges"]] == [
        (e["idx0"], e["idx1"]) for e in jdoc["loop_edges"]
    ]


@pytest.mark.parametrize("name", ["plot_scores", "side_by_side_matches", "trajectory_topdown"])
def test_plot_renderers_match_jax(name, rng):
    """utils/plot.py, which run_euroc draws trajectory_render.npy with:
    the same images as the JAX package's, byte for byte."""
    from cerebro_tpu.utils import plot as jplot
    from cerebro_tpu_torch.utils import plot as tplot

    if name == "plot_scores":
        args = (np.cos(np.linspace(0, 9, 300)), [10, 150, 299])
        kw = {"threshold": 0.85}
    elif name == "side_by_side_matches":
        a, b = rng.integers(0, 256, (48, 64), dtype=np.uint8), rng.random((40, 64)).astype(np.float32)
        xy = rng.uniform(0, 40, (30, 2))
        args = (a, b, xy, xy + 3.0, rng.random(30) > 0.3)
        kw = {"accepted": False}
    else:
        t = np.linspace(0, 6, 120)
        poses = np.tile(np.eye(4, dtype=np.float32), (120, 1, 1))
        poses[:, 0, 3], poses[:, 1, 3] = 8 * np.cos(t), 8 * np.sin(t)
        args = (poses,)
        kw = {"world_id": (np.arange(120) > 60).astype(np.int32), "loop_pairs": [(5, 100), (20, 110)]}
    np.testing.assert_array_equal(getattr(tplot, name)(*args, **kw), getattr(jplot, name)(*args, **kw))
