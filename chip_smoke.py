#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cerebro_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its wall time (stage times of
the pipeline phases are means without each stage's first call, which is
also reported):

  device    card name and power limit (nvidia-smi), torch/CUDA versions and
            the seconds the kernels took to build (one nvcc per source, all
            started together, into cerebro_tpu_torch/_build/);
  k1        kernel K1 (csrc/score_argmax.cu) against its plain PyTorch
            version at the detector's shape, Q=8 x N=29,184 x D=8,192 bf16,
            and at Q=64: ring-wrapped gids, planted rows, a masked decoy, an
            exact tie and an all-masked query. Gids must agree exactly, max
            scores within 1e-3;
  k2        kernel K2 (csrc/score_argmax_banned.cu) against its plain
            PyTorch version at Q=8 and Q=64 x N=29,184 x D=8,192 bf16 with
            banned lists of k=3 and k=5 gids (k1's construction; one list
            bans a planted row, the others hold absent gids and inert -1
            slots): gids exact, max within 1e-3. Then search_topk on CUDA
            tensors (k K2 passes and the dense filler order) against the
            plain dense top-k on every slot, with queries that have fewer
            than k matchable rows. Times per launch and per top-k call; the
            library yardstick per call is a bf16 torch.matmul plus a masked
            torch.topk;
  k3        kernel K3 (csrc/stereo_bm.cu) against the plain block_match on
            8 rendered 240x320 images at 64 disparities and a 21x21 block:
            masks agree on >= 99.9% of pixels and |disparity difference| <=
            1e-3 where both are valid;
  pipeline  the port's CerebroPipeline (ported MobileNet + NetVLAD
            descriptor, default 29,184-row DB, 8-frame descriptor batches,
            default VerifyConfig except cascade=False and the accept gate
            rescaled to this world) fed a rendered stereo survey with a
            revisit lap, then verify_pending. Accepted edges are held
            against the ground-truth relative pose, and the line says how
            many would also pass the default accept gate. K1 must launch
            once per detect batch, K3 at least once, and at least one loop
            edge must be accepted;
  pipeline_topk  the same pipeline with Method A at candidates_per_query=3
            and the camera mount (body_T_cam), fed a 2-lap survey with the
            default kidnap (no pose inside it), then verify_pending and
            optimize_trajectory: candidate precision and recall against
            ground truth (as bench_e2e.py computes them), accepted and
            cross-world edges and their error, world-0 ATE before and
            after, overall ATE after, the optimize time. K2 must launch 3
            times per detect batch and K1 never; at least one accepted
            edge, every one within 5 deg / 0.5 m of ground truth, at least
            one across the worlds, and world-0 ATE must fall;
  methods   that run's descriptors replayed through detection alone for
            Methods B, C and D (as bench_e2e.py compares methods):
            candidates, precision and recall; K2 must launch top_k times
            per detect batch;
  profile   one describe, Method-A detect, top-k detect and verify call of
            the pipelines under torch.profiler, and one optimize_trajectory
            call: host and device ms, device idle share, device operations
            per call, top operators;
  kernels   one entry per kernel: launches in the main-path runs (K1 in
            pipeline, K2 in pipeline_topk, K3 in both), error against its
            plain version, kernel / plain / library times and the bound.

Then the nvidia-smi line, and last ``{"ok": true, "device": {...}}``. Any
failed check raises; the script exits non-zero without CUDA.

Times are CUDA-event times over repeated launches after a warm-up.
``bound_ms`` is the larger of (bytes each input read once and each output
written once) / 3.35 TB/s and operations / the H100's peak rate for their
type (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32), NVIDIA's published
H100 SXM figures.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
FRAMES, LAPS = 400, 2.0  # the pipeline stream: lap 2 revisits lap 1
TOPK_FRAMES = 400  # the top-k stream: 2 laps with a kidnap


_last_emit = time.perf_counter()


def emit(obj: dict):
    """Print one JSON line; a phase line also gets ``wall_s``, the seconds
    since the previous line (the phase's own wall time, set-up included)."""
    global _last_emit
    now = time.perf_counter()
    if "phase" in obj:
        obj["wall_s"] = now - _last_emit
    _last_emit = now
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# K1: masked score + max/argmax
# ---------------------------------------------------------------------------


def ring_gids(n: int, total: int, device) -> torch.Tensor:
    """Global ids of a ring of ``n`` rows after ``total`` appends: gid g
    sits at row g % n, for g in [total - n, total)."""
    first = total - n
    r = torch.arange(n, device=device, dtype=torch.int64)
    return (first + (r - first) % n).to(torch.int32)


def k1_case(Q: int, N: int, D: int, device, seed: int):
    """Queries, DB, limits, gids, the expected gids and the all-masked
    queries of a Q-query case (Q >= 8). Query q is a copy of DB row
    rows[q]: rows 0, 511, 512, N/2 and N-1 (the tile edges bench.py plants),
    then random rows. Query 5's row also sits, as an exact copy, at the
    newest gid, which its limit masks; query 6's row also sits at row N-2,
    unmasked, so the exact tie goes to the lower row. Queries 7, 39, ...
    see no row at all and must give (NEG_INF, gids[0])."""
    g = torch.Generator(device=device).manual_seed(seed)
    db = torch.nn.functional.normalize(
        torch.randn((N, D), generator=g, device=device), dim=1
    ).to(torch.bfloat16)
    total = N + 7001  # the ring has wrapped: row != gid
    gids = ring_gids(N, total, device)
    decoy, twin = (total - 1) % N, N - 2
    fixed = [0, 511, 512, N // 2, N - 1]
    special = set(fixed) | {decoy, twin}
    perm = torch.randperm(N, generator=g, device=device).tolist()
    rows = fixed + [r for r in perm if r not in special][: Q - len(fixed)]
    expect = [int(gids[r]) for r in rows]
    limits = torch.full((Q,), total, dtype=torch.int32, device=device)
    db[decoy] = db[rows[5]]
    limits[5] = expect[5] + 1
    db[twin] = db[rows[6]]
    masked = list(range(7, Q, 32))
    for q in masked:
        limits[q] = total - N
        expect[q] = int(gids[0])
    queries = db[rows].float()
    return queries, db, limits, gids, torch.tensor(expect, dtype=torch.int32), masked


def phase_k1(device, N: int = 29184, D: int = 8192) -> dict:
    from cerebro_tpu_torch.ops import similarity as sim

    out = {"phase": "k1", "N": N, "D": D, "shapes": []}
    for Q, seed in ((8, 0), (64, 1)):
        q, db, lim, gids, expect, masked = k1_case(Q, N, D, device, seed)
        km, kg = sim.max_and_argmax_cuda(q, db, lim, gids)
        pm, pg = sim.max_and_argmax_plain(q, db, lim, gids)
        torch.cuda.synchronize()
        err = float((km - pm).abs().max())
        if not torch.equal(kg.cpu(), expect) or not torch.equal(pg.cpu(), expect):
            raise AssertionError(
                f"K1 gids at Q={Q}: kernel {kg.tolist()} plain {pg.tolist()} "
                f"expected {expect.tolist()}"
            )
        if err > 1e-3:
            raise AssertionError(f"K1 max scores at Q={Q} differ by {err}")
        if not bool((km[masked] == sim.NEG_INF).all()):
            raise AssertionError("K1: an all-masked query did not score NEG_INF")

        q16 = q.to(torch.bfloat16)
        valid_rows = gids[None, :] < lim[:, None]

        def library():
            s = torch.matmul(q16, db.T).float()
            s = torch.where(valid_rows, s, torch.full_like(s, sim.NEG_INF))
            return s.max(dim=1)

        nbytes = N * D * 2 + Q * D * 2 + Q * 4 + N * 4 + Q * 8
        b_ms, b_by = bound(nbytes, 2.0 * Q * N * D, BF16_OPS_PER_S)
        row = {
            "Q": Q,
            "max_abs_err": err,
            "gids_exact": True,
            "kernel_ms": cuda_ms(lambda: sim.max_and_argmax_cuda(q, db, lim, gids), 20),
            "plain_ms": cuda_ms(lambda: sim.max_and_argmax_plain(q, db, lim, gids), 5),
            "library_ms": cuda_ms(library, 20),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        out["shapes"].append(row)
        del q, db, lim, gids
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# K2: masked score + max/argmax with banned gids, k passes for exact top-k
# ---------------------------------------------------------------------------


def k2_banned(gids, limits, expect, k: int):
    """(Q, k) banned lists: query 0 bans its planted gid (the next best must
    win), every other query bans gids absent from the DB in slot 0 and
    holds inert -1 slots after it."""
    Q = limits.shape[0]
    banned = torch.full((Q, k), -1, dtype=torch.int32, device=gids.device)
    banned[0, 0] = int(expect[0])
    banned[1:, 0] = int(limits.max()) + 10  # above every gid
    return banned


def phase_k2(device, N: int = 29184, D: int = 8192) -> dict:
    from cerebro_tpu_torch.ops import similarity as sim

    out = {"phase": "k2", "N": N, "D": D, "shapes": []}
    for Q, seed in ((8, 2), (64, 3)):
        q, db, lim, gids, expect, masked = k1_case(Q, N, D, device, seed)
        # short windows: queries 2 and 3 see 1 and 2 rows (the ring's
        # oldest gids), fewer than k, so search_topk fills slots
        first = int(gids.min())
        lim[2], lim[3] = first + 1, first + 2
        q16 = q.to(torch.bfloat16)
        for k in (3, 5):
            banned = k2_banned(gids, lim, expect, k)
            km, kg = sim.max_and_argmax_banned_cuda(q, db, lim, gids, banned)
            pm, pg = sim.max_and_argmax_banned_plain(q, db, lim, gids, banned)
            torch.cuda.synchronize()
            err = float((km - pm).abs().max())
            if not torch.equal(kg, pg):
                raise AssertionError(f"K2 gids at Q={Q}, k={k}: kernel {kg.tolist()} plain {pg.tolist()}")
            if err > 1e-3:
                raise AssertionError(f"K2 max scores at Q={Q}, k={k} differ by {err}")
            if int(kg[0]) == int(expect[0]) or not bool((km[masked] == sim.NEG_INF).all()):
                raise AssertionError("K2 returned a banned gid or scored an all-masked query")
            tv, ti = sim.search_topk_cuda(q, db, lim, gids, k=k)
            pv, pi = sim.search_topk_plain(q, db, lim, gids, k=k)
            torch.cuda.synchronize()
            topk_err = float((tv - pv).abs().max())
            if not torch.equal(ti, pi) or topk_err > 1e-3:
                raise AssertionError(f"search_topk on CUDA differs from plain at Q={Q}, k={k}")
            n_filler = int((tv <= sim.NEG_INF / 2).sum())
            if n_filler == 0:
                raise AssertionError("the top-k case has no filler slot")

            valid_rows = gids[None, :] < lim[:, None]
            ban_rows = (gids[None, :, None] == banned[:, None, :]).any(-1)

            def library_launch():
                s = torch.matmul(q16, db.T).float()
                s = torch.where(valid_rows & ~ban_rows, s, torch.full_like(s, sim.NEG_INF))
                return s.max(dim=1)

            def library_call():
                s = torch.matmul(q16, db.T).float()
                s = torch.where(valid_rows, s, torch.full_like(s, sim.NEG_INF))
                return torch.topk(s, k, dim=1)

            nbytes = N * D * 2 + Q * D * 2 + Q * 4 + N * 4 + Q * k * 4 + Q * 8
            b_ms, b_by = bound(nbytes, 2.0 * Q * N * D, BF16_OPS_PER_S)
            out["shapes"].append({
                "Q": Q, "k": k,
                "max_abs_err": max(err, topk_err),
                "gids_exact": True, "topk_all_slots_exact": True, "topk_filler_slots": n_filler,
                "kernel_ms": cuda_ms(lambda: sim.max_and_argmax_banned_cuda(q, db, lim, gids, banned), 20),
                "plain_ms": cuda_ms(lambda: sim.max_and_argmax_banned_plain(q, db, lim, gids, banned), 5),
                "library_ms": cuda_ms(library_launch, 20),
                "bound_ms": b_ms, "bound_by": b_by,
                # one search_topk call: k passes and the filler fill
                "call_ms": cuda_ms(lambda: sim.search_topk_cuda(q, db, lim, gids, k=k), 10),
                "call_plain_ms": cuda_ms(lambda: sim.search_topk_plain(q, db, lim, gids, k=k), 5),
                "call_library_ms": cuda_ms(library_call, 20),
                # k passes as designed, and a single pass over the DB
                "call_bound_ms": k * b_ms,
            })
        del q, db, lim, gids
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# K3: stereo block matching
# ---------------------------------------------------------------------------


def k3_ops(B: int, H: int, W: int, num_disp: int) -> float:
    """The fewest operations block matching needs, whatever the kernel does:
    per pixel and disparity |L - R| (2), running vertical and horizontal box
    sums (an add and a subtract each: 4) and the winner and second-best
    compares (2); per pixel the texture term and its running sums (6) and
    the parabola and validity tests (~10). No halo, no block-size term."""
    return float(B) * H * W * (8.0 * num_disp + 16.0)


def compare_disparity(d_k, v_k, d_p, v_p) -> dict:
    both = v_k & v_p
    return {
        "mask_agree": float((v_k == v_p).float().mean()),
        "max_abs_err": float((d_k - d_p).abs()[both].max()) if bool(both.any()) else 0.0,
        "valid_kernel": int(v_k.sum()),
        "valid_plain": int(v_p.sum()),
    }


def phase_k3(device, world) -> dict:
    from cerebro_tpu_torch import synthworld as sw
    from cerebro_tpu_torch.geometry import stereo
    from cerebro_tpu_torch.ops import stereo_kernel

    ren = sw.Renderer(world)
    angles = np.linspace(0.0, 2 * np.pi, 8, endpoint=False)
    pairs = [ren.stereo(8.0 * np.cos(a), 8.0 * np.sin(a)) for a in angles]
    L = torch.from_numpy(np.stack([p[0] for p in pairs]).astype(np.float32)).to(device)
    R = torch.from_numpy(np.stack([p[1] for p in pairs]).astype(np.float32)).to(device)
    B, H, W = L.shape
    nd, blk = 64, 21
    d_k, v_k = stereo_kernel.block_match_cuda(L, R, num_disp=nd, block=blk)
    d_p, v_p = stereo.block_match(L, R, num_disp=nd, block=blk)
    torch.cuda.synchronize()
    cmp = compare_disparity(d_k, v_k, d_p, v_p)
    if cmp["mask_agree"] < 0.999 or cmp["max_abs_err"] > 1e-3:
        raise AssertionError(f"K3 disagrees with block_match: {cmp}")
    if cmp["valid_kernel"] == 0:
        raise AssertionError("K3 found no valid disparity on a textured scene")
    nbytes = 2 * B * H * W * 4 + B * H * W * (4 + 1)
    b_ms, b_by = bound(nbytes, k3_ops(B, H, W, nd), F32_OPS_PER_S)
    return {
        "phase": "k3", "B": B, "H": H, "W": W, "num_disp": nd, "block": blk, **cmp,
        "kernel_ms": cuda_ms(lambda: stereo_kernel.block_match_cuda(L, R, nd, blk), 20),
        "plain_ms": cuda_ms(lambda: stereo.block_match(L, R, nd, blk), 5),
        "library_ms": None,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


# ---------------------------------------------------------------------------
# The live loop
# ---------------------------------------------------------------------------


def phase_pipeline(device, world, n_frames: int, laps: float) -> dict:
    from cerebro_tpu_torch import config as C
    from cerebro_tpu_torch import synthworld as sw
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

    # Default settings, but for two verification changes. The tier-2
    # cascade is not ported. The accept gate of 800 matches assumes the
    # reference's 5000 ORB features at 752x480; at 1024 features on this
    # 240x320 world no pair reaches it, so the gate takes the value the
    # repo's end-to-end bench rescales it to for this world (bench_e2e.py).
    cfg = C.CerebroConfig(
        descriptor=C.DescriptorConfig(kind="ported"),
        verify=C.VerifyConfig(cascade=False, min_matches_accept=200),
    )
    # no kidnap: one world, so every revisit is a loop within it
    seq = sw.make_sequence(n_frames=n_frames, laps=laps, kidnap_at=1.0)
    ren = sw.Renderer(world)
    frames = [ren.stereo(float(x), float(y)) for x, y in seq.xy]

    pipe = CerebroPipeline(cfg, rig=ren.rig(), device=device)
    pipe.timer.sync = True  # attribute device time to each stage
    t0 = time.perf_counter()
    for i, (left, right) in enumerate(frames):
        pipe.ingest_frame(
            float(seq.stamps[i]), left, n_tracked=int(seq.n_tracked[i]),
            pose=seq.odom_poses[i], right_img=right,
        )
    pipe.flush_descriptors()
    cands = list(pipe.candidates)
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    accepted = pipe.verify_pending(cascade=False)
    torch.cuda.synchronize()
    t_verify = time.perf_counter() - t0

    n = pipe.db.count
    rows = pipe.db.vectors[:n].float()
    norms = rows.norm(dim=1)
    errs = edge_errors(pipe, seq)
    reasons: dict = {}
    for r in pipe.rejected_candidates:
        key = "accept gate" if r.reason.startswith("match count") else r.reason.split(" (")[0]
        reasons[key] = reasons.get(key, 0) + 1
    stats = pipe.timer.stats()
    steady = pipe.timer.stats(skip_first=1)
    stages = [k for k in ("assemble", "describe", "detect", "drain", "verify") if k in stats]
    out = {
        "phase": "pipeline",
        "frames": n_frames,
        "verify_min_matches_accept": cfg.verify.min_matches_accept,
        "described": len(pipe.db_gid_to_store),
        "db_rows": pipe.db.capacity,
        "descriptor_dim": pipe.db.dim,
        "candidates": len(cands),
        "edges_accepted": accepted,
        "edges_rejected": len(pipe.rejected_candidates),
        # the default gate (800) assumes 5000 features at 752x480
        "edges_over_default_gate": sum(
            e.n_matches > C.VerifyConfig().min_matches_accept for e in pipe.loop_edges
        ),
        "n_matches_max": max(
            [e.n_matches for e in pipe.loop_edges]
            + [r.n_matches for r in pipe.rejected_candidates],
            default=0,
        ),
        "reject_reasons": reasons,
        "detect_batches": stats["detect"]["count"],
        "edge_rot_err_deg_max": max((a for a, _ in errs), default=None),
        "edge_trans_err_m_max": max((t for _, t in errs), default=None),
        "desc_finite": bool(torch.isfinite(rows).all()),
        "desc_norm_min": float(norms.min()),
        "desc_norm_max": float(norms.max()),
        "ingest_s": t_ingest,
        "verify_s": t_verify,
        # means without each stage's first call (one-time set-up), and
        # that first call on its own
        "stage_mean_ms": {k: steady[k]["mean_ms"] for k in stages},
        "stage_first_ms": {k: steady[k].get("first_ms") for k in stages},
    }
    return out, pipe, cands


def edge_errors(pipe, seq) -> list:
    """(rotation deg, translation m) of each accepted edge against the
    ground-truth relative pose of curr in prev's frame."""
    from cerebro_tpu_torch.geometry import se3

    errs = []
    for e in pipe.loop_edges:
        gt = np.linalg.inv(seq.gt_poses[e.idx_prev]) @ seq.gt_poses[e.idx_curr]
        ang, tr = se3.pose_delta_metrics(
            torch.from_numpy(gt.astype(np.float32)), torch.from_numpy(e.T_prev_curr.astype(np.float32))
        )
        errs.append((float(ang), float(tr)))
    return errs


def candidate_quality(pipe, seq, cands) -> dict:
    """Candidate precision and recall against ground truth, as bench_e2e.py
    computes them: a candidate is right when its frames lie within 1.5 m;
    recall counts the frames with a genuine revisit that got one."""
    from cerebro_tpu_torch import synthworld as sw

    pairs = [(c.idx_curr, c.idx_prev) for c in cands]
    correct = [(a, b) for a, b in pairs if np.linalg.norm(seq.xy[a] - seq.xy[b]) < 1.5]
    gt_revisit = sw.revisit_ground_truth(seq)
    found = {a for a, _ in correct} & set(np.nonzero(gt_revisit)[0].tolist())
    return {
        "candidates": len(pairs),
        "candidate_precision": len(correct) / max(len(pairs), 1),
        "candidate_recall": len(found) / max(int(gt_revisit.sum()), 1),
        "revisit_opportunities": int(gt_revisit.sum()),
    }


def feed_survey(pipe, seq, frames):
    """bench_e2e.py's stream: no pose inside the kidnap span."""
    k0, k1 = seq.kidnap_span
    for i, (left, right) in enumerate(frames):
        pipe.ingest_frame(
            float(seq.stamps[i]), left, n_tracked=int(seq.n_tracked[i]),
            pose=None if k0 <= i < k1 else seq.odom_poses[i], right_img=right,
            is_keyframe=bool(seq.is_keyframe[i]),
        )
    pipe.flush_descriptors()


def topk_config(**loop):
    from cerebro_tpu_torch import config as C

    # the pipeline phase's verification settings (see there)
    return C.CerebroConfig(
        descriptor=C.DescriptorConfig(kind="ported"),
        loop=C.LoopConfig(**loop),
        verify=C.VerifyConfig(cascade=False, min_matches_accept=200),
    )


def phase_pipeline_topk(device, world, n_frames: int, laps: float):
    from cerebro_tpu_torch import synthworld as sw
    from cerebro_tpu_torch.eval import ate_rmse
    from cerebro_tpu_torch.ops.similarity import K1, K2
    from cerebro_tpu_torch.ops.stereo_kernel import K3
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

    cfg = topk_config(candidates_per_query=3)
    seq = sw.make_sequence(n_frames=n_frames, laps=laps)  # default kidnap at 0.55
    ren = sw.Renderer(world)
    frames = [ren.stereo(float(x), float(y)) for x, y in seq.xy]

    pipe = CerebroPipeline(cfg, rig=ren.rig(), body_T_cam=sw.body_T_cam(), device=device)
    pipe.timer.sync = True
    K1.launches = K2.launches = K3.launches = 0
    t0 = time.perf_counter()
    feed_survey(pipe, seq, frames)
    cands = list(pipe.candidates)
    t_ingest = time.perf_counter() - t0
    k2_detect = K2.launches
    t0 = time.perf_counter()
    accepted = pipe.verify_pending(cascade=False)
    torch.cuda.synchronize()
    t_verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    opt = pipe.optimize_trajectory()
    t_opt = time.perf_counter() - t0
    launches = {"k1_launches": K1.launches, "k2_launches": K2.launches, "k3_launches": K3.launches}

    kf = np.nonzero(pipe.store.pose_valid[: pipe.store.size])[0]
    world_id = pipe.store.world_id[kf]
    gt_pos = seq.gt_poses[kf][:, :3, 3]
    odo_pos = pipe.store.poses[kf][:, :3, 3]
    w0 = world_id == 0
    errs = edge_errors(pipe, seq)
    wid = pipe.store.world_id
    stats = pipe.timer.stats()
    steady = pipe.timer.stats(skip_first=1)
    stages = [k for k in ("describe", "detect", "drain", "verify", "optimize") if k in stats]
    out = {
        "phase": "pipeline_topk",
        "frames": n_frames,
        "candidates_per_query": cfg.loop.candidates_per_query,
        "kidnap_span": list(seq.kidnap_span),
        "worlds": int(pipe.kidnap.world_id) + 1,
        "described": len(pipe.db_gid_to_store),
        **candidate_quality(pipe, seq, cands),
        "edges_accepted": accepted,
        "edges_rejected": len(pipe.rejected_candidates),
        "edges_cross_world": sum(int(wid[e.idx_curr] != wid[e.idx_prev]) for e in pipe.loop_edges),
        "edge_precision": sum(
            np.linalg.norm(seq.xy[e.idx_curr] - seq.xy[e.idx_prev]) < 1.0 for e in pipe.loop_edges
        ) / max(len(pipe.loop_edges), 1),
        "edge_rot_err_deg_max": max((a for a, _ in errs), default=None),
        "edge_trans_err_m_max": max((t for _, t in errs), default=None),
        "ate_before_m_world0": ate_rmse(odo_pos[w0], gt_pos[w0]),
        "ate_after_m_world0": ate_rmse(opt[w0][:, :3, 3], gt_pos[w0]),
        "ate_after_m_all": ate_rmse(opt[:, :3, 3], gt_pos),
        "optimize_s": t_opt,
        "optimize_nodes": int(len(kf)),
        "ingest_s": t_ingest,
        "verify_s": t_verify,
        "detect_batches": stats["detect"]["count"],
        "k2_launches_detect": k2_detect,
        **launches,
        "stage_mean_ms": {k: steady[k]["mean_ms"] for k in stages if "mean_ms" in steady[k]},
        "stage_first_ms": {k: steady[k].get("first_ms") for k in stages},
    }
    return out, pipe, cands, seq


def phase_methods(device, topk_pipe, seq, frames_n: int) -> dict:
    """Methods B, C and D over pipeline_topk's own descriptors: a describe_fn
    replays the DB rows batch by batch (the last batch zero-padded, as the
    pipeline pads), so only detection differs between the runs."""
    from cerebro_tpu_torch.ops.similarity import K2
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

    B = topk_pipe.cfg.runtime.descriptor_batch
    rows = topk_pipe.db.vectors[: len(topk_pipe.db_gid_to_store)].float()
    batches = [rows[i : i + B] for i in range(0, len(rows), B)]
    batches[-1] = torch.cat([batches[-1], batches[-1].new_zeros(B - len(batches[-1]), rows.shape[1])])
    # 1x1 stand-in images: describe_fn ignores what the batch assembles
    frames = [(np.zeros((1, 1), np.uint8), None)] * frames_n
    out = {"phase": "methods"}
    for method in ("B", "C", "D"):
        replay = iter(batches)
        pipe = CerebroPipeline(
            topk_config(method=method), describe_fn=lambda _imgs: next(replay),
            describe_dim=rows.shape[1], device=device,
        )
        K2.launches = 0
        t0 = time.perf_counter()
        feed_survey(pipe, seq, frames)
        cands = list(pipe.candidates)
        out[method] = {
            **candidate_quality(pipe, seq, cands),
            "detect_batches": pipe.timer.stats()["detect"]["count"],
            "k2_launches": K2.launches,
            "top_k": pipe.cfg.loop.top_k,
            "stream_s": time.perf_counter() - t0,
        }
        pipe.close()
    return out


def phase_profile(pipe, cands, topk_pipe, reps: int = 3) -> dict:
    """One describe batch, one Method-A detect batch, one top-k detect batch
    and one verify dispatch of the pipelines, each repeated under
    torch.profiler after a warm-up, and one optimize_trajectory call of the
    top-k pipeline: host milliseconds per call (ending in a synchronize),
    device milliseconds (kernels, copies and memsets summed), device
    operations launched per call, and the operators with the most device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cerebro_tpu_torch.db import descriptors as ddb
    from cerebro_tpu_torch.loop import detector
    from cerebro_tpu_torch.ops import similarity
    from cerebro_tpu_torch.verify.geometric import verify_pair_batch

    dev = pipe.device
    B = pipe.cfg.runtime.descriptor_batch
    imgs = np.stack([pipe.images.get("left", c.idx_curr) for c in cands[:B]])[..., None]
    imgs = torch.from_numpy(imgs).to(dev)
    descs = pipe.describe_fn(imgs)
    gidx = torch.arange(pipe.db.total - B, pipe.db.total, dtype=torch.int32, device=dev)
    qvalid = torch.ones(B, dtype=torch.bool, device=dev)
    P = 4  # verify_pending's default device_batch
    pairs = [pipe._load_pair(c) for c in cands[:P]]
    la, ra, lb, rb = (
        torch.from_numpy(np.stack([p[j] for p in pairs])).to(dev) for j in range(4)
    )
    lcfg = topk_pipe.cfg.loop

    def detect_topk():
        # _run_method's Method-A top-k branch, on a copy of the carry
        limits = ddb.query_limits(topk_pipe.db, gidx, lcfg.exclusion_window)
        vals, idx = similarity.search_topk(
            descs, topk_pipe.db.vectors, limits, topk_pipe.db.global_ids, k=lcfg.candidates_per_query
        )
        return detector.temporal_consistency_topk(
            lcfg, topk_pipe.topk_state, vals, idx, gidx, (limits > 0) & qvalid, qvalid
        )

    regions = {
        "describe": (reps, lambda: pipe.describe_fn(imgs)),
        "detect": (reps, lambda: detector.detect_batch(
            pipe.cfg.loop, pipe.db, pipe.det_state, descs, gidx, qvalid
        )),
        "detect_topk": (reps, detect_topk),
        "verify": (reps, lambda: verify_pair_batch(
            pipe.cfg.verify, pipe._generator, lb, rb, la, ra, pipe.rig
        )),
        "optimize": (1, topk_pipe.optimize_trajectory),
    }
    out = {"phase": "profile", "reps": reps, "verify_pairs": P}
    for name, (n, fn) in regions.items():
        fn()
        torch.cuda.synchronize()
        # A solve launches ~190k small ops; with its host-side operators
        # traced too, the phase took ~3 minutes, nearly all after the
        # solve. Its top list is by device kernel instead of by operator.
        host_ops = name != "optimize"
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3 / n
        if host_ops:
            by = (e for e in prof.key_averages() if e.device_type == DeviceType.CPU)
            top = {e.key: e.self_device_time_total for e in by}
        else:
            top = {}
            for e in ops:
                top[e.name[:80]] = top.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
        out[name] = {
            "calls": n,
            "host_ms": wall_ms,
            "device_ms": dev_ms,
            "device_idle_share": 1.0 - dev_ms / wall_ms,
            "device_ops_per_call": len(ops) / n,
            "top_device_ms_by": "operator" if host_ops else "kernel",
            "top_self_device_ms": {
                k: v / 1e3 / n for k, v in sorted(top.items(), key=lambda kv: -kv[1])[:8]
            },
        }
    return out


def check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


def kernel_entry(name, source, replaces, launches, err, t: dict) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1

    from cerebro_tpu_torch import synthworld as sw
    from cerebro_tpu_torch.ops._cuda import build_all
    from cerebro_tpu_torch.ops.similarity import K1, K2
    from cerebro_tpu_torch.ops.stereo_kernel import K3

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    smi = nvidia_smi()
    build_s = build_all([K1, K2, K3])
    for k in (K1, K2, K3):
        print(f"--- nvcc {k.source.name} ---\n{k.build_log}", file=sys.stderr)
    emit({
        "phase": "device",
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(0),
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "kernel_build_s": build_s,
    })

    world = sw.CircuitWorld.create(seed=0)
    k1 = phase_k1(device)
    emit(k1)
    k2 = phase_k2(device)
    emit(k2)
    k3 = phase_k3(device, world)
    emit(k3)

    # Main-path runs. Launches made above to compare and time the kernels
    # do not count: every count is set to 0 just before a run.
    K1.launches = K2.launches = K3.launches = 0
    run, engine, cands = phase_pipeline(device, world, FRAMES, LAPS)
    run["k1_launches"], run["k2_launches"], run["k3_launches"] = K1.launches, K2.launches, K3.launches
    emit(run)
    check(run["k1_launches"] == run["detect_batches"],
          f"K1 launched {run['k1_launches']} times for {run['detect_batches']} detect batches")
    check(run["k2_launches"] == 0, "Method A top-1 launched K2")
    check(run["k3_launches"] > 0, "the pipeline run never launched K3")
    check(run["edges_accepted"] >= 1, "the pipeline accepted no loop edge")
    # an edge this far from the ground-truth relative pose is a wrong loop
    check(run["edge_rot_err_deg_max"] <= 5.0 and run["edge_trans_err_m_max"] <= 0.5,
          "an accepted loop edge is far from ground truth")
    check(run["desc_finite"] and abs(run["desc_norm_min"] - 1) <= 1e-2
          and abs(run["desc_norm_max"] - 1) <= 1e-2, "descriptors are not finite unit vectors")

    topk, topk_engine, _, seq = phase_pipeline_topk(device, world, TOPK_FRAMES, LAPS)
    emit(topk)
    k = topk["candidates_per_query"]
    check(topk["k2_launches"] == k * topk["detect_batches"],
          f"K2 launched {topk['k2_launches']} times for {topk['detect_batches']} top-{k} detect batches")
    check(topk["k1_launches"] == 0, "the top-k run launched K1")
    check(topk["k3_launches"] > 0, "the top-k run never launched K3")
    check(topk["edges_accepted"] >= 1, "the top-k run accepted no loop edge")
    check(topk["edge_rot_err_deg_max"] <= 5.0 and topk["edge_trans_err_m_max"] <= 0.5,
          "an accepted top-k loop edge is far from ground truth")
    check(topk["worlds"] == 2 and topk["edges_cross_world"] >= 1,
          "the top-k run accepted no edge across the kidnap's two worlds")
    check(topk["ate_after_m_world0"] < topk["ate_before_m_world0"],
          "optimize_trajectory did not lower world 0's ATE")

    methods = phase_methods(device, topk_engine, seq, TOPK_FRAMES)
    emit(methods)
    for m in ("B", "C", "D"):
        r = methods[m]
        check(r["k2_launches"] == r["top_k"] * r["detect_batches"],
              f"method {m}: K2 launched {r['k2_launches']} times for {r['detect_batches']} batches")

    emit(phase_profile(engine, cands, topk_engine))
    engine.close()
    topk_engine.close()

    main_k1 = k1["shapes"][0]
    main_k2 = next(x for x in k2["shapes"] if x["Q"] == 8 and x["k"] == k)
    emit({"kernels": [
        kernel_entry("K1 score_argmax", "cerebro_tpu_torch/csrc/score_argmax.cu",
                     "cerebro_tpu/ops/similarity.py:98", run["k1_launches"],
                     max(x["max_abs_err"] for x in k1["shapes"]), main_k1),
        kernel_entry("K2 score_argmax_banned", "cerebro_tpu_torch/csrc/score_argmax_banned.cu",
                     "cerebro_tpu/ops/similarity.py:286", topk["k2_launches"],
                     max(x["max_abs_err"] for x in k2["shapes"]), main_k2),
        kernel_entry("K3 stereo_bm", "cerebro_tpu_torch/csrc/stereo_bm.cu",
                     "cerebro_tpu/ops/stereo_pallas.py:53",
                     run["k3_launches"] + topk["k3_launches"], k3["max_abs_err"], k3),
    ]})
    print(smi, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
