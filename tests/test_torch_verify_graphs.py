"""The verification graph's host side on the CPU: which pairs it serves, the
counters a pipeline exposes, and the edits that keep the per-pair body free
of host-to-device copies (a number stays a number; constants live on the
device). The capture and the replay run only on the card:
``tests/test_torch_kernels_cuda.py`` holds them against eager calls there."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from cerebro_tpu_torch import config as tcfg
from cerebro_tpu_torch.geometry import se3
from cerebro_tpu_torch.geometry.stereo import RectifiedRig
from cerebro_tpu_torch.ops import features, steerable
from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline, RawCandidate
from cerebro_tpu_torch.verify import geometric as G

from test_pipeline import camera_pose, stereo_images
from test_verify import BASELINE, CX, CY, FX, FY, H, W, big_texture

TRIG = RectifiedRig(R0=np.eye(3), R1=np.eye(3), fx=FX, fy=FY, cx=CX, cy=CY, baseline=BASELINE)
# a small verification: the point is the control flow, not the pose
VCFG = dataclasses.replace(tcfg.VerifyConfig(), max_features=256, max_matches=256,
                           ransac_hypotheses=32, gms_factor=4.0, min_matches_accept=40,
                           min_matches_attempt=20)


@pytest.fixture(scope="module")
def frames():
    tex = big_texture(np.random.default_rng(3), n=2048)
    return [stereo_images(tex, camera_pose(i)) for i in (0, 1)]


def _pipeline(tmp_path):
    cfg = tcfg.CerebroConfig(
        descriptor=tcfg.DescriptorConfig(image_hw=(H, W), trunk_dim=4, num_clusters=4, kind="gist"),
        loop=tcfg.LoopConfig(db_capacity=64),
        verify=VCFG,
        runtime=tcfg.RuntimeConfig(descriptor_batch=2, stash_dir=str(tmp_path / "stash"),
                                   image_ram_window_s=1e9),
    )
    unit = np.full((2, 16), 0.25, np.float32)  # the candidate is injected
    return CerebroPipeline(cfg, rig=TRIG, describe_fn=lambda _: torch.from_numpy(unit),
                           describe_dim=16, device="cpu")


def test_cpu_pipeline_captures_nothing(tmp_path, frames):
    """A CPU pipeline verifies eagerly: no graph is captured and no pair is
    counted under the three graph counters, which ``status()`` exposes at 0
    from the start (they count CUDA pairs only)."""
    pipe = _pipeline(tmp_path)
    assert {k: pipe.status()["counters"][k] for k in G.GRAPH_COUNTERS} == dict.fromkeys(
        G.GRAPH_COUNTERS, 0)
    for t, (left, right) in enumerate(frames):
        pipe.ingest_frame(30.0 * t, left, n_tracked=100, pose=camera_pose(t), right_img=right)
    pipe.flush_descriptors()
    pipe._drain_detections()
    pipe._candidates = [RawCandidate(idx_curr=1, idx_prev=0, score=0.9)]
    pipe.verify_pending(cascade=False)
    counters = pipe.status()["counters"]
    assert counters["pairs.verified.tier1"] == 1
    assert {k: counters[k] for k in G.GRAPH_COUNTERS} == dict.fromkeys(G.GRAPH_COUNTERS, 0)
    assert pipe._verify_graphs._graphs == {}
    assert len(pipe.loop_edges) + len(pipe.rejected_candidates) == 1
    pipe.close()


def test_verify_pair_batch_on_the_cpu_ignores_graphs(frames):
    """Given graphs, CPU pairs run the eager body: the same results and the
    same generator state as without, and nothing captured."""
    (la, ra), (lb, rb) = ([torch.from_numpy(np.asarray(x, np.float32))[None] for x in f] for f in frames)
    results, states = [], []
    for use_graphs in (False, True):
        gen = torch.Generator().manual_seed(5)
        graphs = G.VerifyGraphs(gen)
        results.append(G.verify_pair_batch(VCFG, gen, la, ra, lb, rb, TRIG,
                                           graphs=graphs if use_graphs else None))
        states.append(gen.get_state())
        assert graphs._graphs == {}
    for f in dataclasses.fields(G.VerifiedLoop):
        assert torch.equal(getattr(results[0], f.name), getattr(results[1], f.name)), f.name
    assert torch.equal(*states)


def test_graphs_engage_on_cuda_pairs_sampled_from_their_generator():
    """The path is decided by the input: CUDA tensors, the graphs' own
    generator, and no caller-supplied samples (the tests' JAX samples run
    eagerly)."""
    gen = torch.Generator()
    graphs = G.VerifyGraphs(gen)
    on_card = types.SimpleNamespace(is_cuda=True)
    none3 = (None, None, None)
    assert graphs.engages(gen, on_card, none3)
    assert not graphs.engages(gen, torch.zeros(1), none3)
    assert not graphs.engages(torch.Generator(), on_card, none3)
    assert not graphs.engages(None, on_card, none3)
    assert not graphs.engages(gen, on_card, (torch.zeros((4, 6), dtype=torch.int64), None, None))


def test_steer_by_a_number_equals_steer_by_a_tensor():
    """A Python angle stays on the host (no copy to the device inside a
    capture) and rotates the coefficients exactly as the same angle as a
    float32 tensor."""
    c = torch.randn(5, 8, 8, 2, generator=torch.Generator().manual_seed(0))
    for theta in (0.2617993877991494, -0.2617993877991494, 1.0):
        want = steerable.steer(c, torch.tensor(theta, dtype=torch.float32))
        assert torch.equal(steerable.steer(c, theta), want)


def test_oriented_patches_scale_number_equals_tensor():
    """A Python sampling spacing stays on the host and samples exactly as the
    same spacing as a float32 tensor."""
    g = torch.Generator().manual_seed(1)
    img = torch.rand(60, 80, generator=g)
    xy = torch.rand(7, 2, generator=g) * torch.tensor([79.0, 59.0])
    theta = torch.rand(7, generator=g)
    for scale in (2.0, 1.5):
        want = features._extract_oriented_patches(img, xy, theta, 16,
                                                   scale=torch.tensor(scale, dtype=torch.float32))
        assert torch.equal(features._extract_oriented_patches(img, xy, theta, 16, scale=scale), want)


def test_make_pose_bottom_row_and_broadcast():
    R = torch.eye(3).expand(4, 3, 3)
    t = torch.arange(3, dtype=torch.float32)
    T = se3.make_pose(R, t)
    assert T.shape == (4, 4, 4)
    assert torch.equal(T[:, 3], torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(4, 4))
    assert torch.equal(T[:, :3, 3], t.expand(4, 3))


def test_kernel_counts_captured_and_replayed_launches(monkeypatch):
    """A launch under ``captured_launches`` is tallied as recorded into a
    graph, ``replay_launches`` adds the tally once per replay, and
    ``Kernel.runs`` counts eager launches and replays, not captures. The
    launch function is a stand-in: the bookkeeping is the host's."""
    from cerebro_tpu_torch.ops import _cuda

    k = _cuda.Kernel("small_eig.cu", {"f": []})
    k._lib = types.SimpleNamespace(f=lambda stream: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=None))
    k.launch("f")
    with _cuda.captured_launches() as tally:
        k.launch("f")
        k.launch("f")
    assert tally == {k: 2}
    for _ in range(5):
        _cuda.replay_launches(tally)
    k.launch("f")  # outside the capture again
    assert (k.launches, k.captured, k.replayed, k.runs) == (4, 2, 10, 12)
    k.reset()
    assert (k.launches, k.captured, k.replayed, k.runs) == (0, 0, 0, 0)
