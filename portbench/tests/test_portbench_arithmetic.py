"""The yardstick's arithmetic, and the flagship net module's FLOP rule and
width, against hand-worked numbers."""

import json
import math

import pytest

from portbench import nets
from portbench import yardstick as Y
from portbench.run import PB, ROOT


def flagship():
    """The net module and weights of the listed configuration."""
    cfg = json.loads((PB / "configs" / "bench_e2e_top3.json").read_text())
    net = nets.load(cfg["net"])
    return net, net.weights_dir(cfg, PB / "_cache")


def test_percentile_nearest_rank():
    v = list(range(1, 101))  # 1..100
    assert Y.percentile(v, 0.90) == 90
    assert Y.percentile(v, 0.95) == 95
    assert Y.percentile([5.0], 0.9) == 5.0
    assert Y.percentile([], 0.9) is None
    assert Y.percentile([3, 1, 2], 0.5) == 2


@pytest.mark.parametrize("n, want", [(100, 90), (200, 180), (80, 70), (11, 1), (10, None)])
def test_tail_keeps_ten_samples_beyond_it(n, want):
    # 1..n: p90 where ten or more lie beyond it, else the sample with ten beyond
    assert Y.tail(list(range(1, n + 1)), 0.90, beyond=10) == want


def test_spread_is_interquartile_over_median():
    # statistics.quantiles(n=4) of 1..9 (exclusive method): 2.5, 5, 7.5
    assert Y.spread(list(range(1, 10))) == pytest.approx((7.5 - 2.5) / 5)


def test_keyframe_latencies_count_lost_keyframes():
    due = {10: 1.0, 12: 1.1, 14: 1.2}
    # DB ids 0, 1 hold frames 10, 12; frame 14 was never described
    samples, lost = Y.keyframe_latencies([10, 12, 14], due, [10, 12], [1.5, 2.1])
    assert samples[:2] == pytest.approx([500.0, 1000.0])
    assert math.isinf(samples[2]) and lost == 1
    assert Y.percentile(samples, 0.95) == math.inf


def test_decisions_undecided_count_at_their_age_at_the_window_end():
    due = {100: 10.0, 102: 10.1, 104: 10.2}
    frame_of = {7: 100, 8: 102, 9: 104, 1: 50}
    cands = [(7, 1), (8, 1), (9, 1), (9, 1)]
    decided = {(7, 1): 11.0, (8, 1): 25.0}  # (8, 1) decided after the window ended at 20
    out = Y.decision_latencies(cands, frame_of, {100, 102, 104}, due, decided, 20.0)
    assert out == pytest.approx([1000.0, 9800.0, 9900.0])  # (9, 1) once, at its age


def test_candidates_of_keyframes_outside_the_window_are_not_counted():
    out = Y.decision_latencies([(1, 0)], {1: 5}, {100}, {100: 1.0}, {}, 2.0)
    assert out == []


def test_describe_flops_hand_worked():
    net, weights = flagship()
    assert weights == ROOT / "artifacts" / "descriptor_ported"
    # 240x320 -> conv1 s2 (120x160x32, 3x3x3) -> blocks 1..7 (stride 2 at dw 2, 4, 6)
    hand = 2 * 120 * 160 * 32 * 27
    for (h, w), c_in, c_out in [((120, 160), 32, 64), ((60, 80), 64, 128), ((60, 80), 128, 128),
                                ((30, 40), 128, 256), ((30, 40), 256, 256), ((15, 20), 256, 512),
                                ((15, 20), 512, 512)]:
        hand += 2 * h * w * c_in * 9 + 2 * h * w * c_in * c_out
    hand += 2 * 300 * 512 * 16 * 2  # NetVLAD assignment and aggregation
    assert net.describe_flops(weights, (240, 320)) == hand
    assert 0.85e9 < hand < 0.9e9  # 0.87 GFLOP a frame
    assert net.width(weights) == 16 * 512


def test_describe_flops_at_the_euroc_rig():
    net, weights = flagship()
    # 480x752 -> conv1 s2 240x376 -> /4 120x188 -> /8 60x94 -> /16 30x47
    hand = 2 * 240 * 376 * 32 * 27
    for (h, w), c_in, c_out in [((240, 376), 32, 64), ((120, 188), 64, 128), ((120, 188), 128, 128),
                                ((60, 94), 128, 256), ((60, 94), 256, 256), ((30, 47), 256, 512),
                                ((30, 47), 512, 512)]:
        hand += 2 * h * w * c_in * 9 + 2 * h * w * c_in * c_out
    hand += 2 * 30 * 47 * 512 * 16 * 2
    assert net.describe_flops(weights, (480, 752)) == hand
    assert 4.0e9 < hand < 4.2e9  # the 4.09 GFLOP a frame that step_mfu counts


def test_search_bound_counts_the_filled_rows():
    from portbench.readers import score_topk_bound

    full = score_topk_bound(16, 1024, 8192, 128, 1, 1024)
    assert score_topk_bound(16, 1024, 8192, 128, 1, 512) == pytest.approx(full / 2, rel=0.02)
    assert score_topk_bound(16, 1024, 8192, 128, 1, 4096) == full


def test_score_topk_cost_hand_worked():
    flops, nbytes = Y.score_topk_cost(16, 29184, 8192, 1)
    assert flops == 2 * 16 * 29184 * 8192
    assert nbytes == 2 * 29184 * 8192 + 2 * 16 * 8192 + 4 * 29184 + 4 * 16 + 8 * 16
    # the DB read dominates: 478 MB at 3.35 TB/s, ~0.143 ms
    assert Y.bound_s(flops, nbytes, Y.BF16_FLOPS) == pytest.approx(0.1428e-3, rel=2e-3)


def test_k3_cost_hand_worked():
    ops, nbytes = Y.k3_cost(16, 240, 320, 64)
    assert ops == 16 * 240 * 320 * (8 * 64 + 16)
    assert nbytes == 16 * 240 * 320 * 13
    assert Y.bound_s(ops, nbytes, Y.F32_FLOPS) == pytest.approx(ops / 67e12)


def test_union_seconds():
    busy, gaps = Y.union_seconds([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)])
    assert busy == pytest.approx(3.0) and gaps == [(2.0, 3.0)]
