#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cerebro_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line (stage times of the pipeline phase
are means without each stage's first call, which is also reported):

  device    card name and power limit (nvidia-smi), torch/CUDA versions and
            the seconds the kernels took to build (one nvcc per source, all
            started together, into cerebro_tpu_torch/_build/);
  k1        kernel K1 (csrc/score_argmax.cu) against its plain PyTorch
            version at the detector's shape, Q=8 x N=29,184 x D=8,192 bf16,
            and at Q=64: ring-wrapped gids, planted rows, a masked decoy, an
            exact tie and an all-masked query. Gids must agree exactly, max
            scores within 1e-3;
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
  profile   one describe, detect and verify call of the pipeline under
            torch.profiler: host and device ms, device idle share, device
            operations per call, top operators;
  kernels   one entry per kernel: launches in the pipeline run, error
            against its plain version, kernel / plain / library times and
            the bound.

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


def emit(obj: dict):
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
    from cerebro_tpu_torch.geometry import se3
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
    # edges against ground truth: relative pose of curr in prev's frame
    errs = []
    for e in pipe.loop_edges:
        gt = np.linalg.inv(seq.gt_poses[e.idx_prev]) @ seq.gt_poses[e.idx_curr]
        ang, tr = se3.pose_delta_metrics(
            torch.from_numpy(gt.astype(np.float32)), torch.from_numpy(e.T_prev_curr.astype(np.float32))
        )
        errs.append((float(ang), float(tr)))
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


def phase_profile(pipe, cands, reps: int = 3) -> dict:
    """One describe batch, one detect batch and one verify dispatch of the
    pipeline, each repeated under torch.profiler after a warm-up: host
    milliseconds per call (ending in a synchronize), device milliseconds
    (kernels, copies and memsets summed), device operations launched per
    call, and the operators with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cerebro_tpu_torch.loop import detector
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
    regions = {
        "describe": lambda: pipe.describe_fn(imgs),
        "detect": lambda: detector.detect_batch(
            pipe.cfg.loop, pipe.db, pipe.det_state, descs, gidx, qvalid
        ),
        "verify": lambda: verify_pair_batch(
            pipe.cfg.verify, pipe._generator, lb, rb, la, ra, pipe.rig
        ),
    }
    out = {"phase": "profile", "reps": reps, "verify_pairs": P}
    for name, fn in regions.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3 / reps
        top = sorted(
            (e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
            key=lambda e: e.self_device_time_total, reverse=True,
        )[:8]
        out[name] = {
            "host_ms": wall_ms,
            "device_ms": dev_ms,
            "device_idle_share": 1.0 - dev_ms / wall_ms,
            "device_ops_per_call": len(ops) / reps,
            "top_self_device_ms": {
                e.key: e.self_device_time_total / 1e3 / reps for e in top
            },
        }
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1

    from cerebro_tpu_torch import synthworld as sw
    from cerebro_tpu_torch.ops._cuda import build_all
    from cerebro_tpu_torch.ops.similarity import K1
    from cerebro_tpu_torch.ops.stereo_kernel import K3

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    smi = nvidia_smi()
    build_s = build_all([K1, K3])
    for k in (K1, K3):
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
    k3 = phase_k3(device, world)
    emit(k3)
    # launches made above to compare and time the kernels do not count
    K1.launches = K3.launches = 0
    run, engine, cands = phase_pipeline(device, world, FRAMES, LAPS)
    run["k1_launches"], run["k3_launches"] = K1.launches, K3.launches
    emit(run)
    emit(phase_profile(engine, cands))
    engine.close()
    if run["k1_launches"] != run["detect_batches"]:
        raise AssertionError(
            f"K1 launched {run['k1_launches']} times for "
            f"{run['detect_batches']} detect batches"
        )
    if run["k3_launches"] == 0:
        raise AssertionError("the pipeline run never launched K3")
    if run["edges_accepted"] < 1:
        raise AssertionError("the pipeline accepted no loop edge")
    # an edge this far from the ground-truth relative pose is a wrong loop
    if run["edge_rot_err_deg_max"] > 5.0 or run["edge_trans_err_m_max"] > 0.5:
        raise AssertionError("an accepted loop edge is far from ground truth")
    if not run["desc_finite"] or abs(run["desc_norm_min"] - 1) > 1e-2 or abs(
        run["desc_norm_max"] - 1
    ) > 1e-2:
        raise AssertionError("descriptors are not finite unit vectors")
    main_k1 = k1["shapes"][0]
    emit({"kernels": [
        {
            "name": "K1 score_argmax", "route": "cuda",
            "source": "cerebro_tpu_torch/csrc/score_argmax.cu",
            "replaces": "cerebro_tpu/ops/similarity.py:98",
            "launches": run["k1_launches"],
            "max_abs_err": max(s["max_abs_err"] for s in k1["shapes"]),
            "ms": main_k1["kernel_ms"], "plain_ms": main_k1["plain_ms"],
            "bound_ms": main_k1["bound_ms"], "bound_by": main_k1["bound_by"],
            "library_ms": main_k1["library_ms"],
        },
        {
            "name": "K3 stereo_bm", "route": "cuda",
            "source": "cerebro_tpu_torch/csrc/stereo_bm.cu",
            "replaces": "cerebro_tpu/ops/stereo_pallas.py:53",
            "launches": run["k3_launches"],
            "max_abs_err": k3["max_abs_err"],
            "ms": k3["kernel_ms"], "plain_ms": k3["plain_ms"],
            "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
            "library_ms": None,
        },
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
