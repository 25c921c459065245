"""The live node of the port (runtime/service.py, StreamIngestor) on the
CPU, against the JAX package where both can run the same feed:

- StreamIngestor: a threaded producer through the native engine into the
  pipeline, in both packages: the same frames, poses and descriptors;
- CerebroService in both packages on tests/test_pipeline.py's 18-frame
  stereo stream, verification held back to stop()'s drain: the same
  frames, candidates, edges and rejection gates, edge poses within 0.5 deg
  / 2 cm (tests/test_torch_pipeline.py's tolerance);
- the live loop with live verification (tests/test_native_ingest.py's
  assertions), through start()/stop(save_dir=) and through run_inline;
- a 2,000-frame soak at gist 32x32 that sheds (tests/test_service_soak.py's
  invariants);
- an exception on the worker or the optimizer thread surfaces from stop()."""

import os
import threading
import time

import numpy as np
import pytest

from cerebro_tpu.runtime import CerebroPipeline as JPipeline
from cerebro_tpu.runtime import CerebroService as JService
from cerebro_tpu.runtime import StreamIngestor as JStreamIngestor
from cerebro_tpu_torch import config as tcfg
from cerebro_tpu_torch.io import load_pipeline_state
from cerebro_tpu_torch.runtime import CerebroPipeline, CerebroService, LoopEdge, StreamIngestor

from test_pipeline import camera_pose, small_config, stereo_images
from test_torch_pipeline import TRIG, _port_config
from test_verify import big_texture, make_rig

NS = 1_000_000_000


@pytest.fixture(scope="module")
def frames():
    tex = big_texture(np.random.default_rng(11), n=4096)
    return [stereo_images(tex, camera_pose(i)) for i in range(14)]


def _stream(frames):
    """(stamp_ns, (left, right), pose): 14 frames at 1 Hz, then frames 2..5
    revisited from t = 30 s (tests/test_native_ingest.py's live stream)."""
    out = [((1 + i) * NS, frames[i], camera_pose(i)) for i in range(14)]
    out += [((30 + k) * NS, frames[i], camera_pose(14 + k)) for k, i in enumerate(range(2, 6))]
    return out


def _push(svc, stream, sleep_s=0.0):
    for ns, (la, ra), pose in stream:
        svc.push_image(ns, la)
        svc.push_image(ns, ra, is_right=True)
        svc.push_pose(ns + 100_000, pose.astype(np.float64))
        svc.push_tracking(ns - 100_000, 100)
        time.sleep(sleep_s)
    # advance the horizon so the hold window releases the last frames
    svc.push_image(60 * NS, np.zeros_like(stream[0][1][0]))


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def test_stream_ingestor_feeds_pipeline_like_jax(tmp_path):
    """Threaded producer -> native association -> pipeline consumer, in
    both packages on the same feed (tests/test_native_ingest.py:140-170)."""
    jcfg = small_config(tmp_path / "j")
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (240, 320)).astype(np.uint8) for _ in range(20)]
    poses = [np.eye(4) for _ in range(20)]
    for i, T in enumerate(poses):
        T[0, 3] = 0.1 * i

    def run(pipe, ingestor_cls):
        ing = ingestor_cls(pipe, hold_s=0.05)

        def producer():
            for i in range(20):
                s = (i + 1) * NS
                ing.push_image(s, imgs[i])
                ing.push_pose(s + 100_000, poses[i])
                ing.push_tracking(s - 100_000, 100, True)

        th = threading.Thread(target=producer)
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
        ing.push_image(30 * NS, np.zeros((240, 320), np.uint8))  # advance horizon
        assert ing.pump() == 20
        pipe.flush_descriptors()
        st = pipe.status()
        assert st["frames"] == 20 and st["described"] == 20
        assert pipe.store.pose_valid[:20].all()
        return ing

    jp = JPipeline(jcfg)
    ing_j = run(jp, JStreamIngestor)
    pipe = CerebroPipeline(_port_config(jcfg), device="cpu")
    ing_t = run(pipe, StreamIngestor)
    np.testing.assert_array_equal(pipe.store.stamps[:20], jp.store.stamps[:20])
    np.testing.assert_array_equal(pipe.store.poses[:20], jp.store.poses[:20])
    # gist of the same pixels: bf16 rows within one bf16 step
    np.testing.assert_allclose(
        pipe.db.vectors[:20].float().numpy(), np.asarray(jp.db.vectors[:20]).astype(np.float32),
        atol=2e-2,
    )
    assert ing_t.pixels_dropped == ing_j.pixels_dropped == 0
    assert len(ing_t._left) == 1  # the horizon frame, still held
    pipe.close()


def _spy_candidates(pipe):
    """Record the candidate (curr, prev) pairs each verify_pending call
    consumes."""
    seen, real = [], pipe.verify_pending

    def verify_pending(*a, **kw):
        seen.append([(c.idx_curr, c.idx_prev) for c in pipe.candidates])
        return real(*a, **kw)

    pipe.verify_pending = verify_pending
    return seen


def test_service_matches_jax(tmp_path, frames):
    """Both services, all 18 frames pushed before start(); verification
    only in stop()'s drain (verify_every_s past any clock), the default
    cascade. Same frames, candidates, edges and rejection gates."""
    from cerebro_tpu.geometry import se3 as jse3
    import jax.numpy as jnp

    jcfg = small_config(tmp_path / "j")
    stream = _stream(frames)
    results = {}
    for name, pipe, svc_cls in (
        ("jax", JPipeline(jcfg, rig=make_rig()), JService),
        ("torch", CerebroPipeline(_port_config(jcfg), rig=TRIG, device="cpu"), CerebroService),
    ):
        svc = svc_cls(pipe, verify_every_s=1e12, optimize_every_s=1e12, hold_s=0.05)
        seen = _spy_candidates(pipe)
        _push(svc, stream)
        svc.start()
        _wait(lambda: pipe.store.size == 18, 60, "the worker to ingest 18 frames")
        svc.stop()
        st = svc.status()
        assert st["frames"] == 18 and st["described"] == 18 and st["ingest_dropped"] == 0
        assert len(seen) == 1  # only the drain verified
        results[name] = (pipe, seen[0], st)
    (jp, jc, _), (tp, tc, tst) = results["jax"], results["torch"]
    np.testing.assert_array_equal(tp.store.stamps[:18], jp.store.stamps[:18])
    assert tc == jc and len(tc) >= 1
    je = {(e.idx_curr, e.idx_prev): e for e in jp.loop_edges}
    te = {(e.idx_curr, e.idx_prev): e for e in tp.loop_edges}
    assert te.keys() == je.keys() and len(te) >= 1
    for k, e in te.items():
        ang, tr = jse3.pose_delta_metrics(
            jnp.asarray(je[k].T_prev_curr, jnp.float32), jnp.asarray(e.T_prev_curr, jnp.float32)
        )
        assert float(ang) < 0.5 and float(tr) < 0.02, (k, float(ang), float(tr))

    def gates(pipe):
        return [(r.idx_curr, r.idx_prev, r.reason.split(" (")[0]) for r in pipe.rejected_candidates]

    assert gates(tp) == gates(jp)
    assert tst["pixel_buffers"] == 1  # the horizon frame
    tp.close()


@pytest.mark.parametrize("mode", ["threads", "inline"])
def test_service_live_loop(tmp_path, frames, mode):
    """Producers push while the worker processes and verifies live
    (tests/test_native_ingest.py:173-226): through start()/stop(save_dir=)
    or through run_inline, then stop(save_dir=)."""
    cfg = _port_config(small_config(tmp_path))
    pipe = CerebroPipeline(cfg, rig=TRIG, device="cpu")
    svc = CerebroService(pipe, verify_every_s=0.1, optimize_every_s=0.5, hold_s=0.05)
    th = threading.Thread(target=_push, args=(svc, _stream(frames), 0.01))
    if mode == "threads":
        svc.start()
        th.start()
        th.join(timeout=60)
        # an edge while the service runs, from the worker's live verify
        _wait(lambda: len(pipe.loop_edges) >= 1, 120, "a live loop edge")
    else:
        th.start()
        deadline = time.monotonic() + 120
        svc.run_inline(
            until=lambda: (not th.is_alive() and len(pipe.loop_edges) >= 1)
            or time.monotonic() > deadline
        )
        assert len(pipe.loop_edges) >= 1, "run_inline verified no edge live"
    assert not th.is_alive()
    svc.stop(save_dir=str(tmp_path / "svc_state"))

    st = svc.status()
    assert st["frames"] >= 18
    assert st["loop_edges"] >= 1, st
    assert not st["service_running"]
    assert svc.latest_trajectory is not None
    assert os.path.exists(tmp_path / "svc_state" / "manifest.json")
    assert pipe.timer.stats()["tick"]["count"] >= 1
    loaded = load_pipeline_state(str(tmp_path / "svc_state"), cfg=cfg, rig=TRIG, device="cpu")
    assert loaded.store.size == pipe.store.size
    assert [(e.idx_curr, e.idx_prev) for e in loaded.loop_edges] == [
        (e.idx_curr, e.idx_prev) for e in pipe.loop_edges
    ]
    loaded.close()
    pipe.close()


N_SOAK = 2_000


def test_service_soak_sheds_and_stays_bounded(tmp_path):
    """2,000 frames at 100 Hz stamps, every one an eligible keyframe, with
    a tiny shed bound (tests/test_service_soak.py's invariants)."""
    cfg = tcfg.CerebroConfig(
        descriptor=tcfg.DescriptorConfig(image_hw=(32, 32), trunk_dim=32, num_clusters=4, kind="gist"),
        loop=tcfg.LoopConfig(db_capacity=4096, exclusion_window=50),
        runtime=tcfg.RuntimeConfig(
            descriptor_batch=32, stash_dir=str(tmp_path / "stash"), image_ram_window_s=5.0,
            shed_backlog=64,
        ),
    )
    pipe = CerebroPipeline(cfg, device="cpu")  # no rig: detection only
    svc = CerebroService(pipe, hold_s=0.05, ingest_capacity=16384)
    svc.start()
    pool = [np.random.default_rng(k).integers(0, 255, (32, 32), np.uint8) for k in range(64)]
    max_pixel_buffers = 0
    progress = []

    def producer():
        for i in range(N_SOAK):
            ns = int((1.0 + i / 100.0) * NS)
            svc.push_image(ns, pool[i % len(pool)])
            svc.push_tracking(ns, 100, is_keyframe=True)
        svc.push_image(10**6 * NS, np.zeros((32, 32), np.uint8))  # flush the horizon

    th = threading.Thread(target=producer)
    th.start()
    while th.is_alive():
        max_pixel_buffers = max(max_pixel_buffers, len(svc.ingest._left) + len(svc.ingest._right))
        progress.append(len(pipe.db_gid_to_store) + pipe.shed_descriptors)
        time.sleep(0.005)
    th.join(timeout=60)
    _wait(lambda: pipe.store.size >= N_SOAK, 120, "the worker to ingest every frame")
    progress.append(len(pipe.db_gid_to_store) + pipe.shed_descriptors)
    svc.stop()
    st = svc.status()

    assert st["ingest_dropped"] == 0, st
    assert st["frames"] == N_SOAK, st
    assert st["described"] + st["shed_descriptors"] == N_SOAK, st
    assert st["shed_descriptors"] > 0, st  # the backlog bound engaged
    assert st["described"] >= N_SOAK // 100, st
    assert progress[-1] > progress[0]
    assert max_pixel_buffers <= 16384 + 512, max_pixel_buffers
    assert st["pixel_buffers"] <= 2, st
    assert st["ingest_pending"] <= 1, st
    assert st["pending_descriptors"] == 0, st
    pipe.close()


@pytest.mark.parametrize("where", ["worker", "optimizer"])
def test_thread_exception_surfaces_from_stop(tmp_path, where):
    cfg = _port_config(small_config(tmp_path))
    pipe = CerebroPipeline(cfg, device="cpu")
    svc = CerebroService(pipe, optimize_every_s=0.05, hold_s=0.05)

    def boom(*a, **kw):
        raise ValueError(f"fault in the {where}")

    if where == "worker":
        svc.ingest.pump = boom
    else:
        pipe.optimize_trajectory = boom
        pipe.loop_edges.append(
            LoopEdge(stamp_curr=1.0, stamp_prev=0.0, idx_curr=1, idx_prev=0,
                     T_prev_curr=np.eye(4, dtype=np.float32), weight=1.0, n_matches=300)
        )
    svc.start()
    _wait(lambda: not svc._running.is_set(), 30, "the thread to fail")
    with pytest.raises(ValueError, match=f"fault in the {where}"):
        svc.stop()
    assert svc._worker is None and svc._optimizer is None
    pipe.close()


def test_stamped_pixels_under_thread_stress():
    """Eight producer threads add while a consumer pops and prunes, with a
    tiny switch interval: every stamp comes out exactly once (popped or
    pruned), and the sorted key list always matches the dict."""
    import sys

    from cerebro_tpu_torch.runtime.pipeline import _StampedPixels

    buf = _StampedPixels()
    n_threads, per = 8, 400
    popped, pruned = [], [0]
    done = threading.Event()

    def producer(t):
        for i in range(per):
            buf.add((i * n_threads + t) * 10_000_000, t)

    def consumer():
        s = 0
        while not done.is_set() or len(buf):
            if buf.pop_near(s * 10_000_000, tol_ns=0) is not None:
                popped.append(s)
            s = (s + 1) % (n_threads * per)
            if s % 97 == 0:
                pruned[0] += buf.prune_older(s * 10_000_000 - 500 * 10_000_000)
            with buf._mu:
                assert buf._keys == sorted(buf._d)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        producers = [threading.Thread(target=producer, args=(t,)) for t in range(n_threads)]
        cons = threading.Thread(target=consumer)
        cons.start()
        for th in producers:
            th.start()
        for th in producers:
            th.join(timeout=60)
        done.set()
        cons.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not cons.is_alive() and not any(th.is_alive() for th in producers)
    assert len(popped) == len(set(popped))
    assert len(popped) + pruned[0] == n_threads * per
    assert len(buf) == 0
