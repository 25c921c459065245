"""The port's native ingest engine (cerebro_tpu_torch/native): the JAX
package's native tests on the port's engine, the same random feeds through
the port's NativeIngest, the port's PyIngest and cerebro_tpu.native's
NativeIngest (identical frames and counters), and no fallback when the
engine cannot be built."""

import threading

import numpy as np
import pytest

from cerebro_tpu.native import NativeIngest as JNativeIngest
from cerebro_tpu_torch import native
from cerebro_tpu_torch.native import NativeIngest, PyIngest, make_ingest

NS = int(1e9)


def test_basic_association():
    ing = NativeIngest(tol_s=1e-3, hold_s=0.1)
    T = np.eye(4)
    T[0, 3] = 1.5
    ing.push_image(1 * NS)
    ing.push_image(1 * NS + 200_000, is_right=True)  # 0.2 ms off -> same frame
    ing.push_pose(1 * NS + 500_000, T)  # 0.5 ms off -> associates
    ing.push_tracking(1 * NS - 300_000, 42, True)
    ing.push_image(2 * NS)  # advances newest past hold
    out = ing.drain()
    assert len(out) == 1
    f = out[0]
    assert f["has_left"] and f["has_right"] and f["has_tracking"]
    assert f["pose"] is not None and abs(f["pose"][0, 3] - 1.5) < 1e-12
    assert f["n_tracked"] == 42 and f["is_keyframe"]
    assert ing.pending == 1  # the 2 s frame still held


def test_out_of_order_and_late_pose():
    ing = NativeIngest(hold_s=0.5)
    for s in [3, 1, 2]:
        ing.push_image(s * NS)
    for s in [1, 2, 3]:
        T = np.eye(4)
        T[1, 3] = s
        ing.push_pose(s * NS + 100_000, T)
    ing.push_image(10 * NS)
    out = ing.drain()
    assert [f["stamp_ns"] for f in out] == [1 * NS, 2 * NS, 3 * NS]
    for k, f in enumerate(out):
        assert f["pose"][1, 3] == k + 1


def test_gap_counter():
    ing = NativeIngest(gap_s=1.0)
    ing.push_image(1 * NS)
    ing.push_image(int(1.1 * NS))
    assert ing.gap_count == 0
    ing.push_image(5 * NS)  # 3.9 s gap
    assert ing.gap_count == 1


def test_threaded_feeds():
    ing = NativeIngest(hold_s=0.0, capacity=100000)
    n_per = 500

    def feed_images():
        for i in range(n_per):
            ing.push_image((i + 1) * NS)

    def feed_poses():
        for i in range(n_per):
            ing.push_pose((i + 1) * NS + 100, np.eye(4))

    threads = [threading.Thread(target=feed_images), threading.Thread(target=feed_poses)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    total = []
    while True:
        got = ing.drain(max_out=256)
        if not got:
            break
        total += got
    assert len(total) >= n_per - 1  # the last may be held
    assert ing.dropped == 0


def test_make_ingest_returns_the_native_engine():
    ing = make_ingest()
    assert isinstance(ing, NativeIngest)
    ing.push_image(NS)
    assert ing.pending == 1


def _random_ops(seed, n=200):
    """Interleaved, shuffled image/pose/tracking feeds with jitter; some
    images stereo, some poses and tracking counts far from any image."""
    rng = np.random.default_rng(seed)
    stamps = np.sort(rng.integers(0, 10 * NS, n))
    ops = []
    for s in stamps:
        s = int(s)
        jitter = int(rng.integers(-500_000, 500_000))
        ops.append(("img", s, False))
        if rng.random() < 0.3:
            ops.append(("img", s + int(rng.integers(-300_000, 300_000)), True))
        if rng.random() < 0.8:
            T = np.eye(4)
            T[0, 3] = s * 1e-9
            T[1, 3] = float(rng.normal())
            ops.append(("pose", s + jitter, T))
        if rng.random() < 0.7:
            ops.append(("trk", s + jitter, int(rng.integers(0, 200)), bool(rng.random() < 0.5)))
        if rng.random() < 0.05:  # an orphan, nowhere near an image
            ops.append(("pose", s + 5_000_000, np.eye(4)))
    rng.shuffle(ops)
    return ops


def _counters(ing):
    return (ing.pending, ing.dropped, ing.gap_count, ing.emit_horizon, ing.oldest_pending)


@pytest.mark.parametrize(
    "seed,kw",
    [(0, {}), (1, {"hold_s": 0.5}), (2, {"capacity": 64, "gap_s": 0.05})],
    ids=["default", "long_hold", "small_capacity"],
)
def test_three_engines_agree(seed, kw):
    """The same feed, pushed and drained in the same steps, through the
    port's native engine, its Python model and the JAX package's native
    engine: identical frames (stamps, poses, flags, counts) and counters
    after every drain."""
    engines = [NativeIngest(**kw), PyIngest(**kw), JNativeIngest(**kw)]
    ops = _random_ops(seed)
    drained = [[] for _ in engines]
    step = 37
    for i in range(0, len(ops), step):
        for op in ops[i : i + step]:
            for eng in engines:
                if op[0] == "img":
                    eng.push_image(op[1], op[2])
                elif op[0] == "pose":
                    eng.push_pose(op[1], op[2])
                else:
                    eng.push_tracking(op[1], op[2], op[3])
        for eng, out in zip(engines, drained):
            out.extend(eng.drain(max_out=16))
        ref = _counters(engines[0])
        assert _counters(engines[1]) == ref and _counters(engines[2]) == ref
    for eng, out in zip(engines, drained):
        while got := eng.drain(max_out=500):
            out.extend(got)
    assert len(drained[0]) > 20
    for other in drained[1:]:
        assert len(other) == len(drained[0])
        for fa, fb in zip(drained[0], other):
            assert {k: v for k, v in fa.items() if k != "pose"} == {
                k: v for k, v in fb.items() if k != "pose"
            }
            assert (fa["pose"] is None) == (fb["pose"] is None)
            if fa["pose"] is not None:
                np.testing.assert_array_equal(fa["pose"], fb["pose"])
    assert all(_counters(e) == _counters(engines[0]) for e in engines[1:])


def test_make_ingest_raises_without_a_compiler(tmp_path, monkeypatch):
    """A broken compiler path fails loudly with the command; nothing falls
    back to the Python model."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib_handle", None)
    with pytest.raises(RuntimeError, match="no-such-g"):
        make_ingest()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").glob("*.so"))


def test_compile_error_carries_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "ingest.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib_handle", None)
    with pytest.raises(RuntimeError, match="error"):
        make_ingest()


def test_library_is_built_from_the_ports_source_into_build():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build" and native.BUILD_DIR.parent.name == "cerebro_tpu_torch"
    assert native.SRC.parent.parent.name == "native"
    assert native.SRC.parent.parent.parent.name == "cerebro_tpu_torch"
    NativeIngest()  # builds (or finds) it
    assert path.exists()
