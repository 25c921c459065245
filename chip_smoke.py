#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cerebro_tpu_torch``) on one GPU.

    python3 chip_smoke.py               # every phase: the run that counts
    python3 chip_smoke.py --phase k3    # K3 alone, an iteration aid
    python3 chip_smoke.py --phase photo # the 1,000-frame photo-world run
    python3 chip_smoke.py --phase euroc # the EuRoC entry point's phase alone
    python3 chip_smoke.py --phase live  # the live node alone, on a 60 s stream
    python3 chip_smoke.py --phase netvlad  # the netvlad kind and the int8 DB alone
    python3 chip_smoke.py --phase train    # the training path alone
    python3 chip_smoke.py --phase synthetic,mesh,calib  # any of the three alone

Phases, each printed as one JSON line with its wall time (stage times of
the pipeline phases are means without each stage's first call, which is
also reported):

  device    card name and power limit (nvidia-smi), torch/CUDA versions and
            the seconds the kernels took to build (one nvcc per source, all
            started together, into cerebro_tpu_torch/_build/);
  k1        kernel K1 (csrc/score_topk.cu at K=1) against its plain
            PyTorch version at the detector's shape, Q=8 x N=29,184 x
            D=8,192 bf16, and at Q=64: ring-wrapped gids, planted rows, a
            masked decoy, an exact tie and an all-masked query. Gids must
            agree exactly, max scores within 1e-3;
  k2        kernel K2 (csrc/score_topk.cu) at Q=8 and Q=64 x N=29,184 x
            D=8,192 bf16, and at pipeline_photo's Q=16 x N=1,024 (its DB
            sized to 400 frames), for k = 1, 3, 5 and 8: the banned argmax (K=1)
            with a list of k banned gids (k1's construction; one list bans
            a planted row, the others hold absent gids and inert -1 slots)
            against its plain version, gids exact, max within 1e-3; then
            search_topk on CUDA tensors (one K2 launch per call:
            ``launches_per_call`` must be 1) against the plain dense top-k
            on every slot, with queries that have fewer than k matchable
            rows. Times per launch and per top-k call, and the one-pass
            bound of a call; the library yardstick per call is a bf16
            torch.matmul plus a masked torch.topk;
  k3        kernel K3 (csrc/stereo_bm.cu) against the plain block_match on
            8 rendered 240x320 images at 64 disparities and a 21x21 block:
            masks agree on >= 99.9% of pixels and |disparity difference| <=
            1e-3 where both are valid; its time by CUDA events over back-
            to-back calls and, from a torch.profiler trace, the kernel's own
            device time; then one depth_pipeline_rectified call over the
            8 pairs, verification's entry to K3, which must launch it once;
  pipeline  the port's CerebroPipeline (ported MobileNet + NetVLAD
            descriptor, default 29,184-row DB, 8-frame descriptor batches,
            default VerifyConfig except cascade=False and the accept gate
            rescaled to this world) fed a rendered stereo survey with a
            revisit lap, then verify_pending. Accepted edges are held
            against the ground-truth relative pose, and the line says how
            many would also pass the default accept gate. K1 must launch
            once per detect batch, K3 at least once, and at least one loop
            edge must be accepted;
  int8      the int8 DB: max_and_argmax_int8 on CUDA tensors (one
            torch._int_mm) against its plain exact product on the card at
            Q=8 and Q=64 x N=29,184 x D=8,192 and 4,096, on k1_case's
            planted DB quantized: gids equal and the planted ones, maxima
            within 1e-6, its time (CUDA events; and its device time and
            largest device operations under torch.profiler) beside K1's on
            the bf16 DB and the int8 DB's one-read bound; the pipeline run's stream again with
            loop.quantized=True (detection only): one int8 product per
            detect batch, no K1, its candidates against the float run's
            (every pair only one run emits, with both runs' max score of
            its query); a quantized teach (lap 1) / save / load / repeat
            (lap 2): the loaded DB equal to the saved one, candidates into
            the taught map;
  pipeline_topk  the same pipeline with Method A at candidates_per_query=3
            and the camera mount (body_T_cam), fed a 2-lap survey with the
            default kidnap (no pose inside it), then verify_pending and
            optimize_trajectory: candidate precision and recall against
            ground truth (as bench_e2e.py computes them), accepted and
            cross-world edges and their error, world-0 ATE before and
            after, overall ATE after, the optimize time. The solve runs
            twice and both results must be the same bits. K2 must launch
            once per detect batch and K1 never; at least one accepted
            edge, every one within 5 deg / 0.5 m of ground truth, at least
            one across the worlds, and world-0 ATE must fall;
  methods   that run's descriptors replayed through detection alone for
            Methods B, C and D (as bench_e2e.py compares methods):
            candidates, precision and recall; K2 must launch once per
            detect batch;
  pipeline_photo  the default configuration end to end on the photo world
            (cerebro_tpu_torch/photoworld.py), 400 frames over 1.4 laps
            (the 1,000-frame, 3.5-lap run's spacing) with the default
            kidnap and the camera mount, at bench_e2e.py's settings for
            this world (1,024 features, 128 RANSAC hypotheses, GMS factor
            4, accept gate 200, descriptor batches of 16, DB sized to the
            run), Method A top-3 and the default verification cascade
            (steerable tier 1, gather-bank tier 2 for match-count
            failures), then optimize_trajectory: candidate precision and
            recall, edges, edge precision, cross-world edges, pairs
            escalated to tier 2 and accepted there, worlds merged, world-0
            ATE, the seconds of each tier and of the solve. K2 must launch
            once per detect batch, K1 never, K3 at least once; at least one
            edge, every one within 5 deg / 0.5 m of ground truth, at least
            one pair escalated and one accepted by tier 2 (the pipeline's
            own counts and verify_tier1 / verify_tier2 stages), every
            world merged and a finite solve. The verification graphs: the
            pipeline's three verify.graph counters (no warmup here, so each
            tier's first pair is eager and captures: 2 captured, 2 eager,
            the other pairs replayed) and graph against eager on the run's
            first 8 pairs, each tier (a fresh VerifyGraphs and an eager
            call from the same generator state: every output field and the
            generator's state after each pair equal);
  profile   one describe, Method-A detect, top-k detect, tier-1 verify and
            tier-2 verify call of the pipelines under torch.profiler, and
            one optimize_trajectory call: host and device ms, device idle
            share, device operations per call, top operators;
  euroc     the EuRoC entry point on an ASL folder this script writes from
            the photo world (400 frames over 2 laps, no kidnap, low-passed
            by a 1-px Gaussian; PNGs from its own encoder; a pinhole rig
            yaml at the world's intrinsics with EuRoC cam0's radtan
            distortion, 0.11 m baseline; raw images made by running
            rectification backwards), in three runs: (1)
            cerebro_tpu_torch.run_euroc.main with the default config and
            stride (every 2nd frame), --descriptor ported --ate
            --odom-drift 0.05 --trace: exit 0, the report's keys and frame
            count, K1 once per detect batch, K3 launched, one trace file
            holding one kernel event per K1 and K3 launch, a finite
            ate_after (edges printed, not gated: the default accept gate
            of 800 accepts nothing at 240x320); (2) teach and repeat at
            pipeline_photo's settings: lap 1 through rig_config,
            StereoRectifier, EurocSequence and eval.run_sequence, saved
            with save_pipeline_state, loaded into a fresh pipeline, lap 2
            run against it: at least one edge into the loaded map, every
            edge within 5 deg / 0.5 m of ground truth, K2 once per detect
            batch, K3 launched, the rectified frames within 3 grey levels
            per pixel (mean) of the images they were made from, 16-pixel
            border left out; host ms per frame of PNG decoding,
            rectification and the pipeline; (3) both laps at stride 2,
            detection only, with kind="gist" (K2 once per batch, and one
            top-3 call on its DB, D = 4,096, against the plain top-k),
            then with a WPCA to 191 dimensions (WPCA_AB.json's width)
            fitted on lap 1's ported descriptors and Method A top-1 (K1
            once per batch on 192-wide rows): finite unit descriptors, a
            DB of 191 logical columns. Then K1 (at run 1's 29,184 x 8,192
            DB shape, filled with the taught rows), K2 (a top-3 call on
            the repeat DB), K3 (four verified pairs) and K1 at D=191
            against their plain versions: gids exact, scores within 1e-3,
            with their times;
  live      the live node as users run it (runtime/service.py): the
            photo world at 20 Hz, a lap every 15 s, no kidnap, 30 s of
            stream (600 frames), rendered before the clock starts, at
            scripts/soak_live_rate.py's settings (the ported descriptor at
            240x320, batches of 16, 1,024 features, 128 hypotheses, GMS
            factor 4, accept gate 200, hold 0.05 s, a partial batch
            described after 0.9 s, live verification every 1.5 s with
            cascade=False, one pose-graph shape for the run) but the
            default 29,184-row DB, Method A top-1 (K1). warmup() on the
            main thread (its seconds and detail printed), then
            CerebroService.start(): a producer thread pushes left and right
            images, odometry poses and tracking counts of 100 in real time,
            every 2nd frame a keyframe, while the worker and optimizer
            threads run; a monitor samples host counters only (backlog,
            edges) every 0.1 s; then stop(save_dir=) drains (the cascade
            on) and saves. Printed: the realtime factor, frames, described,
            shed, ingest_dropped, max and p50 backlog, edges live and
            final, verify lag at stream end, whether the optimizer solved
            during the stream, each edge's error against ground truth and
            edge precision, K1/K2/K3 launches of the stream and of the
            drain, the worker's stage stats (first call excluded), the
            producer's push and sleep-overrun seconds, the edges beyond
            2 deg / 0.2 m, each re-verified 8 times with fresh draws.
            Checks: every pushed frame ingested, described + shed ==
            eligible keyframes, nothing dropped, an edge during the
            stream, the edges' stored images are the frames pushed, every
            edge within 5 deg / 0.5 m (the other phases' wrong-loop
            bound; see EDGE_DEG), the saved state reloads, K1 once per
            detect batch and K2 never, K3 launched; then K1 on the live
            DB's own rows and K3 on up to 8 live pairs' images (a live
            verify group's 16 frames) against their plain versions (gids
            exact; disparity as in k3). Realtime factor, shedding and
            backlog are measurements, not gates;
  depth     the depth-camera rig: the photo world, 200 frames over 2
            laps (a keyframe every 0.15 s, so a lap takes 15 s), no kidnap,
            at photo_config's settings (top-3, K2), each frame fed with
            Renderer.depth and no right image, then verify_pending (one
            call per pair, no cascade) and optimize_trajectory. Checks: an
            edge, every edge within 2 deg / 0.2 m, no K3 launch (the depth
            is measured), K2 once per detect batch, K1 never, a finite
            solve;
  netvlad   the default descriptor kind, the in-framework net: (a) its
            mobile (the default, 16 x 256 = 4,096-d), vgg16 and ghost (2
            ghost clusters) variants, seeded, on a batch of 8 at 240x320 in
            bf16 and f32 on the card against the same params on the CPU
            (f32 within NETVLAD_F32_ATOL, bf16 to a cosine of
            NETVLAD_BF16_COS), describe ms per batch (CUDA events) and its
            device ms under torch.profiler; (b) CerebroPipeline
            at the default CerebroConfig() (seeded net, 29,184-row DB,
            default verification and cascade) on a 200-frame, 2-lap
            synthworld survey: the weights are untrained, so candidates and
            edges are printed without a target; (c) the trained synth net
            (artifacts/descriptor_synth_npz, 4 x 64 = 256-d) on the photo
            world, 400 frames over 1.4 laps with the kidnap, photo_config's
            gates, Method A top-1 on a 29,184-row DB: candidate precision
            and recall, edges and their worst error. Checks in (b) and (c):
            K1 once per detect batch, no K2, K3 launched, every accepted
            edge within 5 deg / 0.5 m of ground truth;
  train     the training path: (a) python -m
            cerebro_tpu_torch.pretrain_synthetic's main at the shipped
            artifact's settings (150 steps, 32 places x 4 views, batches of
            8 places, bf16, Adam at 5e-4): ms per step (CUDA events, the
            first step apart), the loss at the first and last step, the
            same-place and cross-place similarity and their margin beside
            the JAX-trained artifact's (its meta.json) and the untrained
            net's; the loss must fall and the margin exceed 0.2 and the
            untrained margin by 0.1; one step at the script's batch of 32
            profiled (device ms, idle share, the FLOP bound: 3x the
            forward's FLOPs at the bf16 peak); then the written npz through
            load_descriptor_params in CerebroPipeline(params=...) on the
            netvlad (c) stream shortened to 200 frames: candidates, edges,
            every edge within 5 deg / 0.5 m, K1 once per detect batch, K3
            launched, then K1 on its DB and K3 on up to 8 of its verified
            pairs against their plain versions; (b) one train step of
            CerebroConfig().descriptor (the 4,096-d net) at a batch of 32,
            profiled alike; (c) the keypoint model at its defaults (desc
            128, width 32, bf16): 300 train steps on synthetic_corner_batch
            of 16, ms per step, loss first and last (last < 0.6 x first),
            a step profiled; tests/test_keypoints.py's held-out corner
            hits (>= 0.6); match_image_pair_learned at max_kp 512 on a
            240x320 photo-world frame and its (8, 8) roll (>= 0.7 of the
            valid matches within 1 px of the shift), detect_keypoints ms
            per frame; (d) float32 gradients of both train losses on the
            card, with the caller's TF32 flags on, against the CPU: the
            loss within 1e-4 relative, each gradient tensor within 1e-4 of
            its norm (plus 1e-6 of the whole gradient's) or within twice
            the change a 1e-7 relative move of the input makes on the CPU
            (the gradient's own rounding sensitivity) where that is larger,
            and within 1e-5 of the card's own with the caller's TF32 off:
            the descriptor at the CPU parity tests' 64x64, trunk 16 and at
            the artifact's 240x320, trunk 64 (whose untrained shallow
            layers move by ~2e-3 under such a move), and the keypoint model
            at its defaults;
  synthetic python -m cerebro_tpu_torch.run_synthetic's main at its
            defaults (14 frames, then the kidnap and 4 revisits): it must
            print OK; its edges and session-2 ATE beside the JAX script's
            --cpu run (4 edges, 0.0016 m); K1 once per detect batch, no K2,
            K3 launched; K1 against its plain version at the run's D = 256
            over 1,024 rows;
  mesh      the mesh at world size 1 (NCCL over a localhost TCP store):
            (a) sharded_max_and_argmax, sharded_topk (k = 1, 3, 5) and
            sharded_max_and_argmax_int8 at Q=8 x N=29,184 x D=8,192 equal to
            the unsharded calls (gids and scores exact), with both times;
            (b) K1, K2 and the int8 search on 4 row blocks of that DB,
            merged by merge_argmax / merge_topk, equal to one call; (c) the
            pipeline phase's settings on its stream at 200 frames over the
            2 laps, with and without mesh=: the same candidates and edges,
            K1 once per detect batch; (d) optimize_sharded bit-equal to
            optimize on pipeline_topk's 365-keyframe graph, both timed; (e)
            the data-parallel train step of the 4,096-d net at a batch of
            32 against the plain step (loss and gradient within 1e-4);
  calib     calibrate_planar for the pinhole, Kannala-Brandt, Mei and
            Scaramuzza models (tests/test_calibration.py's boards) on the
            card against the CPU: the paraxial focal within 2% of the
            truth, the card within 5e-5 (focal) and 0.01 px (centre) of the
            CPU; detect_chessboard on 4 rendered boards, card against CPU:
            the same corners in the same order (or, where the two
            orientations' fits tie, the half turn); then calibrate_planar
            from the card's corners on 5 views through a distorted pinhole:
            fx, fy within 2%;
  kernels   one entry per kernel: launches in the main-path runs (K1 in
            pipeline, euroc, live, synthetic and mesh's pipeline, K2 in
            pipeline_topk, pipeline_photo, euroc and depth, K3 in pipeline,
            pipeline_topk, pipeline_photo, euroc, live, synthetic and mesh's
            pipeline), error against its
            plain version (the largest over every shape it was held at),
            kernel / plain / library times and the bound; K2's also
            carries the top-3 search_topk call's times and its one-pass
            bound, and the gist run's call at D = 4,096 (gist_call_*);
            then k1_d191, K1 at D=191 with the euroc runs' launches, and
            k1_d4096 and k1_d256, K1 on the netvlad runs' own DBs (rows as
            queries, Q = the run's descriptor batch) with those runs'
            launches (K3's count includes them); k1_train_d256, K1 on the
            train phase's run of the weights it trained, with that run's
            launches (K3's count includes that run's too); small_eig, the
            small-matrix kernel (csrc/small_eig.cu: a 12x12 symmetric
            smallest eigenvector, 3x3 SVDs, a 6x6 SPD solve), with
            pipeline_photo's runs on the device as ``launches`` (eager
            launches and each graph replay's recorded ones) and its host
            launches (eager pairs and captures) as ``host_launches``, its
            error against
            torch.linalg on the card (eigenvector up to sign, the callers'
            rotation U diag(1, 1, d) Vt, the solve) and its and
            torch.linalg's times at the main path's batch sizes: 256 3x3
            SVDs (ICP's hypotheses), one 12x12, one 6x6.

Then the nvidia-smi line, and last ``{"ok": true, "device": {...}}``. Any
failed check raises; the script exits non-zero without CUDA.

``--phase k3`` builds only csrc/stereo_bm.cu and runs the ``device`` and
``k3`` phases, then a ``kernels`` line holding K3 alone (its launches those
of the depth_pipeline_rectified call) and the same last two lines. It is
for iterating on K3 and for timing K3 of two trees in one call; it drives
no main-path run, so its result does not replace the full run's.

``--phase euroc`` builds every kernel and runs the ``device`` and ``euroc``
phases, then a kernels line of the euroc runs alone (K1, K2, K3 and
k1_d191, with the euroc phase's checks and launches) and the last two
lines.

``--phase live`` builds every kernel and runs the ``device`` phase and
``live`` on a 60 s stream (1,200 frames, 4 laps: SOAK_LIVE.json's length),
then a kernels line of K1 and K3 from that run alone, and the last two
lines.

``--phase netvlad`` builds every kernel and runs the ``device``,
``netvlad`` and ``int8`` phases (int8 with its own float detection run of
the pipeline phase's stream), then a kernels line of k1_d4096 and k1_d256
and the last two lines.

``--phase train`` builds every kernel and runs the ``device`` and ``train``
phases, then a kernels line of k1_train_d256 and K3 from the train run and
the last two lines.

``--phase synthetic,mesh,calib`` (one, two or all three) builds every
kernel and runs the ``device``, ``k1``, ``k2`` and ``k3`` phases, the
phases named (mesh after a ``pipeline_topk`` run, whose graph it solves),
a kernels line of K1 and K3 with those phases' launches (none for calib
alone) and the last two lines.

``--phase photo`` builds every kernel and runs the ``device`` phase, the
``k2`` checks with the photo shape at this run's 2,048-row DB, and
``pipeline_photo`` at 1,000 frames over 3.5 laps (bench_e2e.py's photo
run, whose BENCH_E2E.json sets the accuracy targets), then the last two
lines; no kernels line.

Every phase runs with cuDNN's and matmul's TF32 off (set once at start),
so the numbers stay comparable across versions of the port.

Times are CUDA-event times over repeated launches after a warm-up.
``bound_ms`` is the larger of (bytes each input read once and each output
written once) / 3.35 TB/s and operations / the H100's peak rate for their
type (989 TFLOP/s bf16 tensor cores, 1,979 TOP/s int8, 67 TFLOP/s f32),
NVIDIA's published H100 SXM figures.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
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
PHOTO_FRAMES, PHOTO_LAPS = 400, 1.4  # the 1,000-frame, 3.5-lap spacing
PHOTO_FULL_FRAMES, PHOTO_FULL_LAPS = 1000, 3.5  # bench_e2e.py's photo run
EUROC_FRAMES, EUROC_LAPS = 400, 2.0  # the EuRoC fixture: lap 2 revisits lap 1
ROUNDTRIP_LIMIT = 3.0  # grey levels per pixel, rectified against the image it came from
# small_eig against torch.linalg on the card at the small_eig phase's inputs
# (H100, 700 W: 1.1e-6, 3.6e-7 and a relative 1.2e-7), with ten times room
# or more: the rotation U diag(1, 1, d) Vt and the eigenvector (up to sign)
# absolute, the solve relative to its largest entry.
SMALL_EIG_TOL = {"svd3": 1e-5, "sym12": 1e-5, "spd6_rel": 1e-4}
LIVE_RATE_HZ, LIVE_LAP_S = 20.0, 15.0  # the live stream: 20 Hz, a lap every 15 s
LIVE_S, LIVE_PHASE_S = 30.0, 60.0  # its length in the default run and under --phase live
# Edge error against ground truth: every depth edge within 2 deg / 0.2 m;
# every live edge within the wrong-loop bound the other phases use, 5 deg /
# 0.5 m, its edges beyond 2 deg / 0.2 m counted and each re-verified. On the
# photo world's nadir view at 6 m the 30 s stream's first live edge, a
# marginal pair (203 matches against the accept gate of 200), comes out of
# verification on an H100 at 2.8 deg / 0.30 m: a tilt traded for a shift
# (0.30 m / 0.049 rad = 6.1 m, the flight height), inside the
# verification's own 5 deg / 0.2 m three-way gate.
EDGE_DEG, EDGE_M = 2.0, 0.2
WRONG_LOOP_DEG, WRONG_LOOP_M = 5.0, 0.5
DEPTH_FRAMES, DEPTH_LAPS, DEPTH_DT_S = 200, 2.0, 0.15  # the depth-camera stream
NETVLAD_FRAMES, NETVLAD_LAPS = 200, 2.0  # the default config's survey, shortened
# the seeded net on the card against the CPU: the CPU parity tests' f32
# tolerance (tests/test_torch_netvlad.py), and a per-descriptor cosine for
# bf16 (cuDNN's bf16 convolutions round each layer's output as the CPU's f32
# convolution of rounded operands does, but sum in another order)
NETVLAD_F32_ATOL, NETVLAD_BF16_COS = 1e-4, 0.995
SYNTH_NPZ = "artifacts/descriptor_synth_npz"  # the trained synth net, 4 x 64
INT8_OPS_PER_S = 1979e12
# the train phase: pretrain_synthetic at the shipped artifact's settings
# (artifacts/descriptor_synth_npz/meta.json: 150 steps, 32 places; the JAX
# script's 4 views and batches of 8 places), its net's run shortened to 200
# photo frames; the keypoint model trained as tests/test_keypoints.py does,
# longer, and held to that test's checks
PRETRAIN_ARGS = ["--steps", "150", "--places", "32", "--views", "4", "--batch-places", "8"]
TRAIN_FRAMES, TRAIN_LAPS = 200, 1.4
TRAIN_MARGIN_MIN, TRAIN_MARGIN_GAIN = 0.2, 0.1  # separation margin, and over the untrained net's
KP_STEPS, KP_BATCH = 300, 16
KP_LOSS_RATIO, KP_HITS_MIN, KP_SHIFT_INLIERS = 0.6, 0.6, 0.7
TRAIN_GRAD_TOL = 1e-4  # f32 card against CPU: loss and each gradient, relative
TRAIN_TF32_TOL = 1e-5  # the card with the caller's TF32 on against off
SENS_SEEDS = (0, 1, 2)  # 1e-7 input moves whose change of the CPU's gradient is recorded
# (d)'s cases (train_grad_case). The first two are the CPU parity tests'
# batches, where a 1e-7 relative move of the input moves the CPU's own
# gradient by 1e-6 to 4e-6: held within TRAIN_GRAD_TOL. At the artifact's
# 240x320 the gradient moves by 3e-4 under such a move even for the
# trained net on views of its training world (by 1e-3 to 2e-3 for the
# untrained net on noise), so two correct float32 computations differ by
# as much: there each tensor is held within twice that sensitivity, at
# least TRAIN_GRAD_TOL and at most TRAIN_GRAD_CAP.
TRAIN_GRAD_CASES = ("descriptor_64x64_trunk16_batch8_seeded", "keypoints_default_batch2_seeded",
                    "descriptor_240x320_trunk64_batch8_synth_npz_places")
TRAIN_GRAD_CAP = 1e-3


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
    fixed = list(dict.fromkeys([0, 511, 512, N // 2, N - 1]))
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
# K2: the banned argmax, and exact top-k in one pass
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


def phase_k2(device, N: int = 29184, D: int = 8192, photo_N: int = 1024) -> dict:
    """The detector's shapes at N rows, and pipeline_photo's top-3 detect
    (batches of 16 over its photo_N-row DB)."""
    from cerebro_tpu_torch.ops import similarity as sim

    out = {"phase": "k2", "N": N, "D": D, "shapes": []}
    for Q, N, seed in ((8, N, 2), (64, N, 3), (16, photo_N, 4)):
        q, db, lim, gids, expect, masked = k1_case(Q, N, D, device, seed)
        # short windows: queries 2 and 3 see 1 and 2 rows (the ring's
        # oldest gids), fewer than k, so search_topk fills slots
        first = int(gids.min())
        lim[2], lim[3] = first + 1, first + 2
        q16 = q.to(torch.bfloat16)
        valid_rows = gids[None, :] < lim[:, None]
        for k in (1, 3, 5, 8):
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
            before = sim.K2.launches
            tv, ti = sim.search_topk_cuda(q, db, lim, gids, k=k)
            launches_per_call = sim.K2.launches - before
            pv, pi = sim.search_topk_plain(q, db, lim, gids, k=k)
            torch.cuda.synchronize()
            topk_err = float((tv - pv).abs().max())
            if not torch.equal(ti, pi) or topk_err > 1e-3:
                raise AssertionError(f"search_topk on CUDA differs from plain at Q={Q}, k={k}")
            if launches_per_call != 1:
                raise AssertionError(f"a search_topk call launched K2 {launches_per_call} times")
            n_filler = int((tv <= sim.NEG_INF / 2).sum())
            if n_filler == 0:
                raise AssertionError("the top-k case has no filler slot")

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
            call_bytes = N * D * 2 + Q * D * 2 + Q * 4 + N * 4 + Q * k * 8
            call_b_ms, _ = bound(call_bytes, 2.0 * Q * N * D, BF16_OPS_PER_S)
            out["shapes"].append({
                "Q": Q, "N": N, "k": k,
                "max_abs_err": max(err, topk_err),
                "gids_exact": True, "topk_all_slots_exact": True, "topk_filler_slots": n_filler,
                "launches_per_call": launches_per_call,
                # the banned argmax with k banned gids
                "kernel_ms": cuda_ms(lambda: sim.max_and_argmax_banned_cuda(q, db, lim, gids, banned), 20),
                "plain_ms": cuda_ms(lambda: sim.max_and_argmax_banned_plain(q, db, lim, gids, banned), 5),
                "library_ms": cuda_ms(library_launch, 20),
                "bound_ms": b_ms, "bound_by": b_by,
                # one search_topk call: one pass over the DB
                "call_ms": cuda_ms(lambda: sim.search_topk_cuda(q, db, lim, gids, k=k), 20),
                "call_plain_ms": cuda_ms(lambda: sim.search_topk_plain(q, db, lim, gids, k=k), 5),
                "call_library_ms": cuda_ms(library_call, 20),
                "call_bound_ms": call_b_ms,
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
    out = {"phase": "k3", "B": B, "H": H, "W": W, "num_disp": nd, "block": blk,
           **k3_measure(L, R, nd, blk)}
    stereo_kernel.K3.launches = 0
    pts, ok, _ = stereo.depth_pipeline_rectified(L, R, ren.rig(), num_disp=nd, block=blk)
    torch.cuda.synchronize()
    out["depth_pipeline_launches"] = stereo_kernel.K3.launches
    if out["depth_pipeline_launches"] != 1 or not bool(torch.isfinite(pts[ok]).all()):
        raise AssertionError(f"depth_pipeline_rectified: {out['depth_pipeline_launches']} K3 launches")
    return out


def k3_measure(L, R, nd: int = 64, blk: int = 21) -> dict:
    """K3 on the (B, H, W) pair stacks L, R against the plain block_match
    (masks agree on >= 99.9% of pixels, |disparity difference| <= 1e-3
    where both are valid), its CUDA-event and profiler times, the plain
    time and the bound."""
    from cerebro_tpu_torch.geometry import stereo
    from cerebro_tpu_torch.ops import stereo_kernel

    B, H, W = L.shape
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
    out = {
        **cmp,
        "kernel_ms": cuda_ms(lambda: stereo_kernel.block_match_cuda(L, R, nd, blk), 50),
        "plain_ms": cuda_ms(lambda: stereo.block_match(L, R, nd, blk), 5),
        "library_ms": None,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "kernel_device_ms": profiled_kernel_ms(
            lambda: stereo_kernel.block_match_cuda(L, R, nd, blk), "stereo_bm", 20
        ),
    }
    return out


def profiled_cycle(fn, reps: int) -> list:
    """(name, device us) of every kernel, copy and memset on the card in
    ``reps`` calls of ``fn`` under torch.profiler. A session can miss the
    first kernels it should record: late in a process, after long traces
    (run_euroc's ``--trace``, the profile phase), more than ``reps`` + 1
    launches of K3 at the start of a schedule's active cycle, and 1-3 of
    190 per op name of a float32 describe. So the session records 5 x
    ``reps`` calls, a marker kernel (``torch.cuda._sleep``) and the
    ``reps`` calls whose device events, those that start after the marker
    ends, are kept. The calls launch the same operations each time, so each
    operation must appear a multiple of ``reps`` times; a cycle that lost
    events raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5 * reps):
            fn()
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [e.time_range.end for e in dev if "spin_kernel" in e.name]
    if not marks:
        raise AssertionError("the trace lost its marker kernel")
    events = [(e.name, e.time_range.elapsed_us()) for e in dev if e.time_range.start >= max(marks)]
    counts: dict = {}
    for name, _ in events:
        counts[name] = counts.get(name, 0) + 1
    short = {k[:80]: n for k, n in counts.items() if n % reps}
    if not events or short:
        raise AssertionError(f"the trace of {reps} calls lost device events: {short or 'none recorded'}")
    return events


def profiled_kernel_ms(fn, name: str, reps: int) -> float:
    """Mean device time of the kernels whose name contains ``name`` over
    ``reps`` calls of ``fn`` (profiled_cycle): the kernel alone, with no
    host gap between launches; one such kernel per call."""
    times = [us for n, us in profiled_cycle(fn, reps) if name in n]
    if len(times) != reps:
        raise AssertionError(f"the trace holds {len(times)} {name} kernels for {reps} calls")
    return sum(times) / len(times) / 1e3


def profiled_device_ms(fn, reps: int) -> dict:
    """Device time per call of ``fn`` (profiled_cycle: every kernel, copy
    and memset the call runs), and the call's three largest device
    operations."""
    per: dict = {}
    for name, us in profiled_cycle(fn, reps):
        per[name] = per.get(name, 0.0) + us / reps / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    return {"device_ms": sum(per.values()), "top_device_ms": {k[:80]: v for k, v in top}}


# ---------------------------------------------------------------------------
# The live loop
# ---------------------------------------------------------------------------


def phase_pipeline(device, world, n_frames: int, laps: float) -> tuple:
    from cerebro_tpu_torch import config as C
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
    survey = synth_survey(world, n_frames, laps)
    seq, ren, frames = survey

    pipe = CerebroPipeline(cfg, rig=ren.rig(), device=device)
    pipe.timer.sync = True  # attribute device time to each stage
    t0 = time.perf_counter()
    feed_frames(pipe, *survey)
    cands = list(pipe.candidates)
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    accepted = pipe.verify_pending(cascade=False)
    torch.cuda.synchronize()
    t_verify = time.perf_counter() - t0

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
        **desc_stats(pipe),
        "ingest_s": t_ingest,
        "verify_s": t_verify,
        # means without each stage's first call (one-time set-up), and
        # that first call on its own
        "stage_mean_ms": {k: steady[k]["mean_ms"] for k in stages},
        "stage_first_ms": {k: steady[k].get("first_ms") for k in stages},
    }
    return out, pipe, cands, survey


def synth_survey(world, n_frames: int, laps: float):
    """(sequence, renderer, stereo frames) of a synthworld survey with no
    kidnap: one world, so every revisit is a loop within it."""
    from cerebro_tpu_torch import synthworld as sw

    seq = sw.make_sequence(n_frames=n_frames, laps=laps, kidnap_at=1.0)
    ren = sw.Renderer(world)
    return seq, ren, [ren.stereo(float(x), float(y)) for x, y in seq.xy]


def feed_frames(pipe, seq, ren, frames):
    """Every frame a stereo keyframe with its odometry pose, then a flush."""
    for i, (left, right) in enumerate(frames):
        pipe.ingest_frame(
            float(seq.stamps[i]), left, n_tracked=int(seq.n_tracked[i]),
            pose=seq.odom_poses[i], right_img=right,
        )
    pipe.flush_descriptors()


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
    opt_again = pipe.optimize_trajectory()  # the same input: the same bits

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
        "ate_after_m_world0_second_solve": ate_rmse(opt_again[w0][:, :3, 3], gt_pos[w0]),
        "second_solve_bit_equal": bool(np.array_equal(opt, opt_again)),
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


def photo_config(n_frames: int):
    """bench_e2e.py::make_config's settings for the photo world
    (bench_e2e.py:40-72), written out: the ported descriptor, Method A with
    3 candidates per query, the DB sized to the run (a multiple of 512 rows
    with one spare), descriptor batches of 16, 1,024 features, 128 RANSAC
    hypotheses, GMS factor 4, and the accept gate rescaled from 800 to 200
    for 240x320 images; every other setting the default (the verification
    cascade on, the steerable tier 1)."""
    from cerebro_tpu_torch import config as C

    cap = ((n_frames + 511) // 512 + 1) * 512
    return C.CerebroConfig(
        descriptor=C.DescriptorConfig(kind="ported"),
        loop=C.LoopConfig(db_capacity=cap, candidates_per_query=3),
        runtime=C.RuntimeConfig(descriptor_batch=16, stash_dir=""),
        verify=C.VerifyConfig(
            max_features=1024, ransac_hypotheses=128, gms_factor=4.0, min_matches_accept=200
        ),
    )


def worlds_merged(pipe) -> int:
    """Worlds joined to world 0 by accepted loop edges (transitively)."""
    wid = pipe.store.world_id
    root = list(range(int(pipe.kidnap.world_id) + 1))

    def find(w):
        while root[w] != w:
            w = root[w]
        return w

    for e in pipe.loop_edges:
        root[find(int(wid[e.idx_curr]))] = find(int(wid[e.idx_prev]))
    return sum(find(w) == find(0) for w in range(len(root)))


def phase_pipeline_photo(device, n_frames: int, laps: float):
    """The default configuration end to end on the photo world."""
    from cerebro_tpu_torch import photoworld as pw
    from cerebro_tpu_torch import synthworld as sw
    from cerebro_tpu_torch.eval import ate_rmse
    from cerebro_tpu_torch.ops import small_eig
    from cerebro_tpu_torch.ops.similarity import K1, K2
    from cerebro_tpu_torch.ops.stereo_kernel import K3
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline
    from cerebro_tpu_torch.verify.geometric import GRAPH_COUNTERS

    t0 = time.perf_counter()
    world = pw.PhotoWorld.create(seed=0)
    seq = pw.make_photo_sequence(n_frames=n_frames, laps=laps)  # default kidnap
    ren = sw.Renderer(world)
    frames = [ren.stereo(float(x), float(y)) for x, y in seq.xy]
    t_world = time.perf_counter() - t0
    cfg = photo_config(n_frames)
    pipe = CerebroPipeline(cfg, rig=ren.rig(), body_T_cam=sw.body_T_cam(), device=device)
    pipe.timer.sync = True
    K1.launches = K2.launches = K3.launches = 0
    for k in small_eig.KERNELS:
        k.reset()
    t0 = time.perf_counter()
    feed_survey(pipe, seq, frames)
    cands = list(pipe.candidates)
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    accepted = pipe.verify_pending()
    torch.cuda.synchronize()
    t_verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    opt = pipe.optimize_trajectory()
    t_opt = time.perf_counter() - t0
    launches = {"k1_launches": K1.launches, "k2_launches": K2.launches, "k3_launches": K3.launches,
                "small_eig_runs": sum(k.runs for k in small_eig.KERNELS),
                "small_eig_host_launches": sum(k.launches for k in small_eig.KERNELS)}

    kf = np.nonzero(pipe.store.pose_valid[: pipe.store.size])[0]
    w0 = pipe.store.world_id[kf] == 0
    gt_pos = seq.gt_poses[kf][:, :3, 3]
    odo_pos = pipe.store.poses[kf][:, :3, 3]
    errs = edge_errors(pipe, seq)
    wid = pipe.store.world_id
    reasons: dict = {}
    for r in pipe.rejected_candidates:
        key = "accept gate" if r.reason.startswith("match count") else r.reason.split(" (")[0]
        reasons[key] = reasons.get(key, 0) + 1
    status = pipe.status()
    stats = pipe.timer.stats()
    steady = pipe.timer.stats(skip_first=1)
    stages = [k for k in ("describe", "detect", "drain", "verify", "optimize") if k in stats]
    out = {
        "phase": "pipeline_photo",
        "frames": n_frames,
        "laps": laps,
        "world": "photo",
        "settings": "bench_e2e.py make_config: 1024 features, 128 hypotheses, GMS factor 4, "
                    "accept gate 200 (rescaled from 800 for 240x320), batch 16, "
                    f"DB {cfg.loop.db_capacity} rows; Method A top-3; default cascade",
        "candidates_per_query": cfg.loop.candidates_per_query,
        "kidnap_span": list(seq.kidnap_span),
        "worlds": int(pipe.kidnap.world_id) + 1,
        "worlds_merged": worlds_merged(pipe),
        "described": len(pipe.db_gid_to_store),
        **candidate_quality(pipe, seq, cands),
        "edges_accepted": accepted,
        "edges_rejected": len(pipe.rejected_candidates),
        "reject_reasons": reasons,
        "edges_cross_world": sum(int(wid[e.idx_curr] != wid[e.idx_prev]) for e in pipe.loop_edges),
        "edge_precision": sum(
            np.linalg.norm(seq.xy[e.idx_curr] - seq.xy[e.idx_prev]) < 1.0 for e in pipe.loop_edges
        ) / max(len(pipe.loop_edges), 1),
        "edge_rot_err_deg_max": max((a for a, _ in errs), default=None),
        "edge_trans_err_m_max": max((t for _, t in errs), default=None),
        "tier1_pairs": len(cands),
        "tier1_accepted": accepted - status["tier2_accepted"],
        "escalated_to_tier2": status["escalated_to_tier2"],
        "tier2_accepted": status["tier2_accepted"],
        # verify_pending runs each tier once: a stage's one sample
        "verify_tier1_s": stats["verify_tier1"]["last_ms"] / 1e3,
        "verify_tier2_s": stats["verify_tier2"]["last_ms"] / 1e3 if "verify_tier2" in stats else 0.0,
        "ate_before_m_world0": ate_rmse(odo_pos[w0], gt_pos[w0]),
        "ate_after_m_world0": ate_rmse(opt[w0][:, :3, 3], gt_pos[w0]),
        "ate_after_m_all": ate_rmse(opt[:, :3, 3], gt_pos),
        "optimize_s": t_opt,
        "optimize_nodes": int(len(kf)),
        "world_and_render_s": t_world,
        "ingest_s": t_ingest,
        "verify_s": t_verify,
        "detect_batches": stats["detect"]["count"],
        **launches,
        "verify_graph_counters": {k: status["counters"][k] for k in GRAPH_COUNTERS},
        "pairs_verified": sum(status["counters"].get(f"pairs.verified.tier{t}", 0) for t in (1, 2)),
        "graph_vs_eager": graph_vs_eager(pipe, cands),
        "stage_mean_ms": {k: steady[k]["mean_ms"] for k in stages if "mean_ms" in steady[k]},
        "stage_first_ms": {k: steady[k].get("first_ms") for k in stages},
    }
    return out, pipe


def graph_vs_eager(pipe, cands, n: int = 8) -> dict:
    """Replayed against eager verification on the run's first ``n``
    candidate pairs, each cascade tier: a fresh ``VerifyGraphs`` and an
    eager call from generators in the same state, pair by pair (the first
    pair captures). Per tier: pairs, those whose outputs differ in any
    field, and whether the generators' states stayed equal."""
    from cerebro_tpu_torch.verify import geometric as G

    vcfg = pipe.cfg.verify
    pairs = [p for p in (pipe._load_pair(c) for c in cands[:n]) if p is not None]
    out = {}
    for tier, cfg_t in ((1, vcfg), (2, dataclasses.replace(vcfg, matcher="gather"))):
        gen_g = torch.Generator(device=pipe.device).manual_seed(1000 + tier)
        gen_e = torch.Generator(device=pipe.device).manual_seed(1000 + tier)
        graphs = G.VerifyGraphs(gen_g)
        differ, same_state = 0, True
        for _, la, ra, lb, rb in pairs:
            imgs = [torch.from_numpy(x)[None].to(pipe.device) for x in (lb, rb, la, ra)]
            got = G.verify_pair_batch(cfg_t, gen_g, *imgs, pipe.rig, graphs=graphs)
            want = G.verify_pair_batch(cfg_t, gen_e, *imgs, pipe.rig)
            differ += not all(torch.equal(getattr(got, f.name), getattr(want, f.name))
                              for f in dataclasses.fields(G.VerifiedLoop))
            same_state &= bool(torch.equal(gen_g.get_state(), gen_e.get_state()))
        out[f"tier{tier}"] = {"pairs": len(pairs), "differ": differ,
                              "generator_state_equal": same_state}
    return out


def check_photo(run: dict):
    check(run["k2_launches"] == run["detect_batches"],
          f"K2 launched {run['k2_launches']} times for {run['detect_batches']} photo detect batches")
    check(run["k1_launches"] == 0, "the photo run launched K1")
    check(run["k3_launches"] > 0, "the photo run never launched K3")
    check(run["edges_accepted"] >= 1, "the photo run accepted no loop edge")
    check(run["escalated_to_tier2"] > 0 and run["tier2_accepted"] > 0,
          "the photo run's cascade escalated no pair or tier 2 accepted none")
    check(run["edge_rot_err_deg_max"] <= 5.0 and run["edge_trans_err_m_max"] <= 0.5,
          "an accepted photo-world loop edge is far from ground truth")
    check(run["worlds_merged"] == run["worlds"], "the photo run left a world unmerged")
    g = run["verify_graph_counters"]
    check(g["verify.graph.captured"] == 2 and g["verify.graph.eager"] == 2
          and g["verify.graph.replayed"] + g["verify.graph.eager"] == run["pairs_verified"],
          f"the photo run's verification graphs: {g} for {run['pairs_verified']} pairs")
    # the replays run small_eig from the graphs: more runs than host launches
    check(0 < run["small_eig_host_launches"] < run["small_eig_runs"],
          f"the photo run's small_eig: {run['small_eig_runs']} runs on the device, "
          f"{run['small_eig_host_launches']} host launches, for {g}")
    check(all(t["pairs"] > 0 and t["differ"] == 0 and t["generator_state_equal"]
              for t in run["graph_vs_eager"].values()),
          f"replayed verification differs from eager: {run['graph_vs_eager']}")
    # no ATE check: at 400 frames over 1.4 laps every revisit lies across
    # the kidnap (lap 2 starts after it), so world 0 gets no loop of its own
    check(np.isfinite(run["ate_after_m_all"]), "the photo run's solve is not finite")


def phase_small_eig(device) -> dict:
    """The small-matrix kernel (csrc/small_eig.cu) against torch.linalg on
    the card at the main path's batch sizes: 256 3x3 SVDs (ICP's
    hypotheses), one 12x12 smallest eigenvector (a PnP refit), one 6x6
    solve (a Gauss-Newton step). Errors: the callers' rotation U diag(1, 1,
    sign det(U Vt)) Vt, the eigenvector up to sign, the solve. Times: each
    entry's and torch.linalg's (which reads its error code back to the host
    on every call), and the bound of each (bytes: the matrices in, the
    factors out)."""
    from cerebro_tpu_torch.ops import small_eig

    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=(256, 3, 3)).astype(np.float32)).to(device)
    X = rng.normal(size=(40, 12))
    M = torch.from_numpy((X.T @ X).astype(np.float32))[None].to(device)
    J = rng.normal(size=(200, 6))
    H = torch.from_numpy((J.T @ J + 1e-6 * np.eye(6)).astype(np.float32))[None].to(device)
    g = torch.from_numpy(rng.normal(size=(1, 6)).astype(np.float32)).to(device)

    def rotation(U, Vt):
        d = torch.sign(torch.linalg.det(U @ Vt))
        return U @ torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)) @ Vt

    v, vl = small_eig.smallest_eigvec(M)[0], torch.linalg.eigh(M)[1][0, :, 0]
    x, xl = small_eig.spd_solve(H, g), torch.linalg.solve(H, g)
    errs = {
        "svd3": float((rotation(*small_eig.svd3(A)[::2]) - rotation(*torch.linalg.svd(A)[::2]))
                      .abs().max()),
        "sym12": float(torch.minimum((v - vl).abs().max(), (v + vl).abs().max())),
        "spd6": float((x - xl).abs().max()),
    }
    errs["spd6_rel"] = errs["spd6"] / float(xl.abs().max())
    for name, tol in SMALL_EIG_TOL.items():
        check(errs[name] <= tol, f"small_eig {name}: {errs[name]} against torch.linalg, over {tol}")
    calls = {
        "svd3": (lambda: small_eig.svd3(A), lambda: torch.linalg.svd(A), 256 * (9 + 21) * 4),
        "sym12": (lambda: small_eig.smallest_eigvec(M), lambda: torch.linalg.eigh(M),
                  (144 + 12) * 4),
        "spd6": (lambda: small_eig.spd_solve(H, g), lambda: torch.linalg.solve(H, g),
                 (36 + 6 + 6) * 4),
    }
    out = {"phase": "small_eig", "max_abs_err": max(errs["svd3"], errs["sym12"], errs["spd6"]),
           "errors": errs, "tolerances": SMALL_EIG_TOL,
           "plain": "torch.linalg, the CPU path's calls, on the card"}
    for name, (kern, lib, nbytes) in calls.items():
        out[name] = {"kernel_ms": cuda_ms(kern, 200), "library_ms": cuda_ms(lib, 50),
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    for key in ("kernel_ms", "library_ms", "bound_ms"):
        out[key] = sum(out[name][key] for name in calls)
    out["plain_ms"] = out["library_ms"]
    out["bound_by"] = "bytes"
    return out


def phase_profile(pipe, cands, topk_pipe, reps: int = 3) -> dict:
    """One describe batch, one Method-A detect batch, one top-k detect batch
    and one verify dispatch of the pipelines, each repeated under
    torch.profiler after a warm-up, one tier-2 verify dispatch (the gather
    matcher with the scale banks) of the same pairs, and one
    optimize_trajectory call of the top-k pipeline: host milliseconds per call (ending in a synchronize),
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
    pairs = [pipe._load_pair(c)[1:] for c in cands[:P]]  # (la, ra, lb, rb)
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
        # what an escalation runs: the gather matcher with the scale banks
        "verify_tier2": (1, lambda: verify_pair_batch(
            dataclasses.replace(pipe.cfg.verify, matcher="gather"), pipe._generator,
            lb, rb, la, ra, pipe.rig,
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
        counting = count_cg_matvecs() if name == "optimize" else contextlib.nullcontext([0])
        with counting as matvecs, profile(activities=acts) as prof:
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
        if name == "optimize":
            # CG iterations (one J^T J v each) of the traced solve
            out["optimize_cg_iterations"] = matvecs[0]
            out["optimize_device_ops_per_cg_iteration"] = len(ops) / max(matvecs[0], 1)
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


@contextlib.contextmanager
def count_cg_matvecs():
    """Yields a one-element list counting the pose-graph CG's matrix-vector
    products inside the block (the optimizer's ``_cg`` wrapped, then put
    back)."""
    from cerebro_tpu_torch.posegraph import optimizer

    count, real = [0], optimizer._cg

    def cg(matvec, b, maxiter):
        def counted(v):
            count[0] += 1
            return matvec(v)

        return real(counted, b, maxiter)

    optimizer._cg = cg
    try:
        yield count
    finally:
        optimizer._cg = real


# ---------------------------------------------------------------------------
# The EuRoC entry point: an ASL folder written from the photo world
# ---------------------------------------------------------------------------

# EuRoC cam0's radtan coefficients (configs/euroc/cam0_pinhole.yaml), put on
# the photo world's pinhole so rectification has real distortion to undo
EUROC_RADTAN = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
EUROC_STAMP0_NS = 1_403_636_579_763_555_584  # MH_01_easy's first cam0 stamp


def png_gray(img: np.ndarray, paeth: bool = False) -> bytes:
    """A minimal 8-bit grayscale PNG: row 0 filtered None, the others Up
    (or, with ``paeth``, every row Paeth: the filter whose decoding is
    sequential along a row)."""
    import struct
    import zlib

    H, W = img.shape
    rows = np.empty((H, W + 1), np.uint8)
    rows[:, 0] = 2
    rows[0, 0] = 0
    rows[:, 1:] = img
    rows[1:, 1:] -= img[:-1]  # Up: wraps mod 256
    if paeth:
        x = np.pad(img.astype(np.int16), ((1, 0), (1, 0)))
        a, b, c = x[1:, :-1], x[:-1, 1:], x[:-1, :-1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        rows[:, 0] = 4
        rows[:, 1:] = (img - pred).astype(np.uint8)

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + ctype + data + struct.pack(">I", zlib.crc32(ctype + data))

    return (
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b"")
    )


def _opencv_matrix(name: str, T: np.ndarray) -> str:
    data = ", ".join(f"{v:.9g}" for v in np.asarray(T, np.float64).reshape(-1))
    return f"{name}: !!opencv-matrix\n   rows: 4\n   cols: 4\n   dt: d\n   data: [{data}]\n"


def low_pass(img: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """``img`` (float32) through a separable Gaussian, edges reflected."""
    r = int(np.ceil(3 * sigma))
    k = np.exp(-np.arange(-r, r + 1) ** 2 / (2 * sigma * sigma))
    k /= k.sum()
    H, W = img.shape
    x = np.pad(img.astype(np.float32), r, mode="reflect")
    x = sum(w * x[:, i : i + W] for i, w in enumerate(k))
    return sum(w * x[i : i + H] for i, w in enumerate(k)).astype(np.float32)


def write_euroc_fixture(root: str, n_frames: int, laps: float):
    """An ASL folder (cam0, cam1, their data.csv, state_groundtruth_estimate0)
    and a rig yaml for the photo world: ``n_frames`` frames over ``laps``
    laps with no kidnap. The rig is a pinhole at the world's intrinsics
    (fx = fy = 300, 240x320) with EuRoC cam0's radtan distortion, cam1
    0.11 m along x and not rotated. The raw images are rectification run
    backwards: each raw pixel is lifted through the distorted camera,
    projected by the rectified pinhole and sampled (bilinear) from the
    rendered frame, low-passed first (a Gaussian of sigma 1 px: the photo
    world's texture aliases, and sampling it twice, raw then rectified,
    would alone put ~11 grey levels per pixel between exact maps' output
    and the frame). The ground truth is the body pose (gravity-aligned,
    the camera mount removed), as EuRoC's is. Returns (mav0, rig yaml,
    sequence, the low-passed rendered frames)."""
    import os

    from cerebro_tpu_torch import photoworld as pw
    from cerebro_tpu_torch import synthworld as sw
    from cerebro_tpu_torch.geometry import cameras, se3
    from cerebro_tpu_torch.geometry.stereo import remap_bilinear

    world = pw.PhotoWorld.create(seed=0)
    seq = pw.make_photo_sequence(n_frames=n_frames, laps=laps, kidnap_at=1.0)
    ren = sw.Renderer(world)
    frames = [tuple(low_pass(im) for im in ren.stereo(float(x), float(y))) for x, y in seq.xy]
    H, W, f, cx, cy = sw.IMG_H, sw.IMG_W, sw.FX, sw.CX, sw.CY

    cam = cameras.make_pinhole(f, f, cx, cy, EUROC_RADTAN, width=W, height=H)
    vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    ray = cameras.lift(cam, torch.stack([uu, vv], -1))
    src = torch.stack([f * ray[..., 0] / ray[..., 2] + cx, f * ray[..., 1] / ray[..., 2] + cy], -1)

    def raw(img):
        out = remap_bilinear(torch.from_numpy(img), src)
        return np.clip(np.rint(out.numpy()), 0, 255).astype(np.uint8)

    mav0 = os.path.join(root, "mav0")
    ns = [EUROC_STAMP0_NS + int(round(float(t) * 1e9)) for t in seq.stamps]
    for c in (0, 1):
        d = os.path.join(mav0, f"cam{c}", "data")
        os.makedirs(d)
        with open(os.path.join(mav0, f"cam{c}", "data.csv"), "w") as fh:
            fh.write("#timestamp [ns],filename\n")
            for i, stamp in enumerate(ns):
                fh.write(f"{stamp},{stamp}.png\n")
                with open(os.path.join(d, f"{stamp}.png"), "wb") as img_fh:
                    img_fh.write(png_gray(raw(frames[i][c])))
    gt_dir = os.path.join(mav0, "state_groundtruth_estimate0")
    os.makedirs(gt_dir)
    w_T_body = seq.gt_poses @ np.linalg.inv(sw.body_T_cam())[None]
    q = se3.rot_to_quat(torch.from_numpy(w_T_body[:, :3, :3].astype(np.float32))).numpy()
    with open(os.path.join(gt_dir, "data.csv"), "w") as fh:
        fh.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                 "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
        for i, stamp in enumerate(ns):
            p = w_T_body[i, :3, 3]
            fh.write(f"{stamp},{p[0]:.9g},{p[1]:.9g},{p[2]:.9g},"
                     + ",".join(f"{v:.9g}" for v in q[i]) + "\n")

    for c in (0, 1):
        with open(os.path.join(root, f"cam{c}.yaml"), "w") as fh:
            fh.write(
                "%YAML:1.0\n---\nmodel_type: PINHOLE\n"
                f"camera_name: cam{c}\nimage_width: {W}\nimage_height: {H}\n"
                "distortion_parameters:\n"
                + "".join(f"   {k}: {v:.9g}\n" for k, v in zip(("k1", "k2", "p1", "p2"), EUROC_RADTAN))
                + f"projection_parameters:\n   fx: {f}\n   fy: {f}\n   cx: {cx}\n   cy: {cy}\n"
            )
    b_T_c1 = np.eye(4)
    b_T_c1[0, 3] = sw.BASELINE
    rig = os.path.join(root, "rig.yaml")
    with open(rig, "w") as fh:
        fh.write(
            "%YAML:1.0\nnum_of_cam: 2\n"
            'cam0_calib: "cam0.yaml"\ncam1_calib: "cam1.yaml"\n'
            f"image_width: {W}\nimage_height: {H}\n"
            + _opencv_matrix("body_T_cam0", np.eye(4)) + _opencv_matrix("body_T_cam1", b_T_c1)
        )
    return mav0, rig, seq, frames


def new_times() -> dict:
    return {"decode_s": 0.0, "rectify_s": 0.0, "frames": 0, "roundtrip_err": []}


def rectified_frames(frames, rect, times: dict, rendered=None, border: int = 16):
    """Loader frames decoded and rectified, the seconds of each summed into
    ``times``; with ``rendered`` (stamp -> the image the fixture made the
    raw left image from) every 10th frame's rectified left is held against
    that image away from a ``border``-pixel margin: the mean grey-level
    difference per pixel goes to ``roundtrip_err``."""
    from cerebro_tpu_torch.run_euroc import RectFrame

    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        left_raw, right_raw = f.left(), f.right()
        t1 = time.perf_counter()
        left, right = rect.rectify(left_raw, right_raw)
        t2 = time.perf_counter()
        times["decode_s"] += t1 - t0
        times["rectify_s"] += t2 - t1
        times["frames"] += 1
        if rendered is not None and i % 10 == 0:
            b = border
            times["roundtrip_err"].append(float(np.abs(left - rendered(f.stamp))[b:-b, b:-b].mean()))
        yield RectFrame(f.stamp, f.pose, left, right)


def k1_measure(q_k, db_k, q_p, db_p, lim, gids) -> dict:
    """K1 on (q_k, db_k) against its plain version on (q_p, db_p) (the same
    rows unpadded, or the same tensors): gids exact, max within 1e-3; the
    kernel, plain and library times and the bound of the call as made."""
    from cerebro_tpu_torch.ops import similarity as sim

    km, kg = sim.max_and_argmax_cuda(q_k, db_k, lim, gids)
    pm, pg = sim.max_and_argmax_plain(q_p, db_p, lim, gids)
    torch.cuda.synchronize()
    err = float((km - pm).abs().max())
    if not torch.equal(kg, pg) or err > 1e-3:
        raise AssertionError(f"K1 at D={db_p.shape[1]}: gids {kg.tolist()} vs {pg.tolist()}, err {err}")
    Q, D = q_k.shape
    N = db_k.shape[0]
    q16 = q_k.to(torch.bfloat16)
    valid = gids[None, :] < lim[:, None]

    def library():
        s = torch.matmul(q16, db_k.T).float()
        return torch.where(valid, s, torch.full_like(s, sim.NEG_INF)).max(dim=1)

    b_ms, b_by = bound(N * D * 2 + Q * D * 2 + Q * 4 + N * 4 + Q * 8,
                       2.0 * Q * N * db_p.shape[1], BF16_OPS_PER_S)
    return {
        "Q": Q, "N": N, "D": db_p.shape[1], "row_width": D, "max_abs_err": err, "gids_exact": True,
        "kernel_ms": cuda_ms(lambda: sim.max_and_argmax_cuda(q_k, db_k, lim, gids), 20),
        "plain_ms": cuda_ms(lambda: sim.max_and_argmax_plain(q_p, db_p, lim, gids), 5),
        "library_ms": cuda_ms(library, 20),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def k2_measure(q, db, lim, gids, k: int) -> dict:
    """One top-k search_topk call on K2 against the plain dense top-k on
    every slot: gids exact, values within 1e-3; call times and bound."""
    from cerebro_tpu_torch.ops import similarity as sim

    kv, ki = sim.search_topk_cuda(q, db, lim, gids, k=k)
    pv, pi = sim.search_topk_plain(q, db, lim, gids, k=k)
    torch.cuda.synchronize()
    err = float((kv - pv).abs().max())
    if not torch.equal(ki, pi) or err > 1e-3:
        raise AssertionError(f"K2 top-{k} differs from plain: err {err}")
    Q, D = q.shape
    N = db.shape[0]
    q16 = q.to(torch.bfloat16)
    valid = gids[None, :] < lim[:, None]

    def library():
        s = torch.matmul(q16, db.T).float()
        return torch.topk(torch.where(valid, s, torch.full_like(s, sim.NEG_INF)), k, dim=1)

    b_ms, b_by = bound(N * D * 2 + Q * D * 2 + Q * 4 + N * 4 + Q * k * 8,
                       2.0 * Q * N * D, BF16_OPS_PER_S)
    return {
        "Q": Q, "N": N, "D": D, "k": k, "max_abs_err": err, "topk_all_slots_exact": True,
        "kernel_ms": cuda_ms(lambda: sim.search_topk_cuda(q, db, lim, gids, k=k), 20),
        "plain_ms": cuda_ms(lambda: sim.search_topk_plain(q, db, lim, gids, k=k), 5),
        "library_ms": cuda_ms(library, 20),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def db_queries(pipe, n: int, seed: int):
    """``n`` rows of the pipeline's DB as queries (logical width, f32) with
    limits at the DB's total: (queries, padded queries, limits)."""
    from cerebro_tpu_torch.db import descriptors as ddb

    g = torch.Generator().manual_seed(seed)
    rows = torch.randperm(pipe.db.count, generator=g)[:n].to(pipe.device)
    q = pipe.db.vectors[rows, : pipe.db.dim].float()
    lim = torch.full((n,), pipe.db.total, dtype=torch.int32, device=pipe.device)
    return q, ddb.pad_queries(pipe.db, q), lim


def desc_stats(pipe) -> dict:
    rows = pipe.db.vectors[: pipe.db.count].float()
    norms = rows.norm(dim=1)
    return {
        "desc_finite": bool(torch.isfinite(rows).all()),
        "desc_norm_min": float(norms.min()),
        "desc_norm_max": float(norms.max()),
    }


def check_unit_descriptors(r: dict, what: str):
    check(r["desc_finite"] and abs(r["desc_norm_min"] - 1) <= 1e-2
          and abs(r["desc_norm_max"] - 1) <= 1e-2, f"{what}: descriptors are not finite unit vectors")


def trace_kernel_counts(path: str, names) -> dict:
    """Kernel events in a Chrome trace whose name contains each of ``names``."""
    import json as _json

    with open(path) as fh:
        events = _json.load(fh)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {n: sum(n in k for k in kernels) for n in names}


def euroc_one_command(mav0, rig_yaml, tmp, n_frames) -> dict:
    """Run 1: ``run_euroc.main`` on the fixture with the default config and
    stride, ``--descriptor ported --ate --odom-drift 0.05 --trace``; the
    trace must hold one kernel event per launch of K1 and K3."""
    import json as _json
    import os

    from cerebro_tpu_torch import run_euroc
    from cerebro_tpu_torch.ops.similarity import K1, K2
    from cerebro_tpu_torch.ops.stereo_kernel import K3

    trace_dir, report_dir = os.path.join(tmp, "trace"), os.path.join(tmp, "out")
    argv = [mav0, "--out", report_dir, "--config", rig_yaml, "--descriptor", "ported",
            "--ate", "--odom-drift", "0.05", "--trace", trace_dir]
    stride = run_euroc.parse_args(argv).stride
    K1.launches = K2.launches = K3.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # stdout: one JSON object per line
        rc = run_euroc.main(argv)
    wall = time.perf_counter() - t0
    with open(os.path.join(report_dir, "report.json")) as fh:
        doc = _json.load(fh)
    rep, st = doc["report"], doc["status"]
    traces = [os.path.join(trace_dir, x) for x in os.listdir(trace_dir) if x.endswith(".trace.json")]
    run = {
        "exit": rc, "stride": stride, "wall_s": wall, "report_keys": sorted(doc),
        "n_frames": rep["n_frames"],
        # verify_pending consumed every candidate: the pairs it verified
        "verified_pairs": st["loop_edges"] + st["rejected_candidates"],
        # the default accept gate (800) accepts nothing at 240x320 (ROADMAP Queue 3 item 3)
        "edges": rep["n_loop_edges"], "escalated_to_tier2": st["escalated_to_tier2"],
        "ate_before": rep["ate_before"], "ate_after": rep["ate_after"],
        "detect_batches": st["timings_ms"]["detect"]["count"],
        "k1_launches": K1.launches, "k2_launches": K2.launches, "k3_launches": K3.launches,
        "trace_files": len(traces),
        "trace_mb": sum(os.path.getsize(x) for x in traces) / 2**20,
        "timings_ms": {k: v["mean_ms"] for k, v in rep["timings"].items()},
    }
    check(rc == 0, f"run_euroc exited {rc}")
    check(set(doc) == {"report", "status", "loop_edges", "found_loops"}, f"report.json keys {sorted(doc)}")
    check(rep["n_frames"] == len(range(0, n_frames, stride)), f"run_euroc read {rep['n_frames']} frames")
    check(K1.launches == run["detect_batches"] and K2.launches == 0,
          f"run_euroc: K1 launched {K1.launches} times for {run['detect_batches']} detect batches")
    check(K3.launches > 0, "run_euroc never launched K3")
    check(len(traces) == 1, f"run_euroc --trace wrote {traces}")
    # each K1 launch is one score_topk_partial and one score_topk_merge kernel
    t0 = time.perf_counter()
    run["trace_kernels"] = trace_kernel_counts(traces[0], ("score_topk_partial", "stereo_bm"))
    run["trace_read_s"] = time.perf_counter() - t0
    check(run["trace_kernels"] == {"score_topk_partial": K1.launches, "stereo_bm": K3.launches},
          f"the trace holds {run['trace_kernels']} for {K1.launches} K1 and {K3.launches} K3 launches")
    check(rep["ate_after"] is not None and np.isfinite(rep["ate_after"]), "run_euroc: no finite ate_after")
    return run


def phase_euroc(device):
    """The EuRoC entry point on an ASL folder written from the photo world,
    in three runs. Returns (the phase line, kernel checks at the runs'
    shapes, each kernel's launches in the runs)."""
    import itertools
    import os
    import tempfile

    from cerebro_tpu_torch.config import CerebroConfig
    from cerebro_tpu_torch.db import descriptors as ddb
    from cerebro_tpu_torch.eval import run_sequence
    from cerebro_tpu_torch.geometry.stereo import StereoRectifier
    from cerebro_tpu_torch.io import load_pipeline_state, save_pipeline_state
    from cerebro_tpu_torch.io.euroc import EurocSequence, decode_png_gray
    from cerebro_tpu_torch.io.rig_config import load_rig_config
    from cerebro_tpu_torch.models.wpca import fit_wpca, save_wpca
    from cerebro_tpu_torch.ops.similarity import K1, K2
    from cerebro_tpu_torch.ops.stereo_kernel import K3
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

    n_frames, laps = EUROC_FRAMES, EUROC_LAPS
    out = {"phase": "euroc", "frames": n_frames, "laps": laps}
    launches = {"K1": 0, "K2": 0, "K1_d191": 0, "K3": 0}
    checks = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_euroc_") as tmp:
        t0 = time.perf_counter()
        mav0, rig_yaml, seq, rendered = write_euroc_fixture(tmp, n_frames, laps)
        out["fixture_s"] = time.perf_counter() - t0
        lap = int(round(n_frames / laps))  # frames per lap

        # 1. the one-command path, as the JAX script runs it
        run1 = euroc_one_command(mav0, rig_yaml, tmp, n_frames)
        out["one_command"] = run1
        launches["K1"] += run1["k1_launches"]
        launches["K3"] += run1["k3_launches"]

        # 2. teach (lap 1), save, load, repeat (lap 2) at bench_e2e.py's settings
        spec = load_rig_config(rig_yaml)
        rect = StereoRectifier(spec.cam0, spec.cam1, spec.c1_T_c0.astype(np.float32),
                               out_hw=spec.image_hw, device=device)
        euroc = EurocSequence(mav0)
        index_of = {f.stamp: i for i, f in enumerate(euroc.frames())}
        times = new_times()
        cfg = photo_config(n_frames)
        ckpt = os.path.join(tmp, "teach_state")
        K1.launches = K2.launches = K3.launches = 0
        teach = CerebroPipeline(cfg, rig=rect.rig, device=device)
        t0 = time.perf_counter()
        teach_rep = run_sequence(teach, rectified_frames(
            itertools.islice(euroc.frames(), lap), rect, times,
            rendered=lambda stamp: rendered[index_of[stamp]][0]))
        save_pipeline_state(teach, ckpt)
        t_teach = time.perf_counter() - t0
        repeat = load_pipeline_state(ckpt, cfg=cfg, rig=rect.rig, device=device)
        loaded = repeat.store.size
        t0 = time.perf_counter()
        repeat_rep = run_sequence(repeat, rectified_frames(
            itertools.islice(euroc.frames(), lap, None), rect, times))
        t_repeat = time.perf_counter() - t0
        errs = edge_errors(repeat, seq)
        detect_batches = (teach.timer.stats()["detect"]["count"]
                          + repeat.timer.stats()["detect"]["count"])
        n_repeat = repeat_rep.n_frames - loaded
        run2 = {
            "teach_frames": teach_rep.n_frames, "loaded_keyframes": loaded, "repeat_frames": n_repeat,
            # verify_pending consumed every candidate: the pairs it verified
            "verified_pairs": len(repeat.loop_edges) + len(repeat.rejected_candidates),
            "edges": len(repeat.loop_edges),
            "edges_to_loaded_map": sum(e.idx_prev < loaded <= e.idx_curr for e in repeat.loop_edges),
            "escalated_to_tier2": repeat.escalated_to_tier2, "tier2_accepted": repeat.tier2_accepted,
            "edge_rot_err_deg_max": max((a for a, _ in errs), default=None),
            "edge_trans_err_m_max": max((t for _, t in errs), default=None),
            "rectify_roundtrip_err_mean": float(np.mean(times["roundtrip_err"])),
            "rectify_roundtrip_frames": len(times["roundtrip_err"]),
            # host ms per stereo frame: both PNGs decoded, both images
            # rectified, the pipeline's ingest (describe and detect amortized)
            "png_decode_ms_per_frame": 1e3 * times["decode_s"] / times["frames"],
            "rectify_ms_per_frame": 1e3 * times["rectify_s"] / times["frames"],
            "pipeline_ms_per_frame": (teach_rep.timings["ingest"]["mean_ms"] * teach_rep.n_frames
                                      + repeat_rep.timings["ingest"]["mean_ms"] * n_repeat)
                                     / (teach_rep.n_frames + n_repeat),
            "teach_s": t_teach, "repeat_s": t_repeat,
            "repeat_verify_s": repeat_rep.timings["verify"]["mean_ms"] / 1e3,
            "detect_batches": detect_batches,
            "k1_launches": K1.launches, "k2_launches": K2.launches, "k3_launches": K3.launches,
        }
        out["teach_repeat"] = run2
        launches["K2"] += K2.launches
        launches["K3"] += K3.launches
        check(run2["edges_to_loaded_map"] >= 1, "repeat: no edge from lap 2 into the loaded map")
        check(run2["edge_rot_err_deg_max"] <= 5.0 and run2["edge_trans_err_m_max"] <= 0.5,
              "repeat: an accepted edge is far from the ground-truth relative pose")
        check(K2.launches == detect_batches and K1.launches == 0,
              f"teach/repeat: K2 launched {K2.launches} times for {detect_batches} detect batches")
        check(K3.launches > 0, "teach/repeat never launched K3")
        check(run2["rectify_roundtrip_err_mean"] <= ROUNDTRIP_LIMIT,
              f"rectified frames differ from the rendered ones by {run2['rectify_roundtrip_err_mean']} "
              "grey levels")

        # the decoder on a EuRoC-sized frame (480x752), Up- and Paeth-filtered
        big_frame = np.tile(np.rint(rendered[0][0]).astype(np.uint8), (2, 3))[:480, :752]
        for name, data in (("up", png_gray(big_frame)), ("paeth", png_gray(big_frame, paeth=True))):
            check(np.array_equal(decode_png_gray(data), big_frame), f"PNG decoder ({name}) is not exact")
            t0 = time.perf_counter()
            for _ in range(5):
                decode_png_gray(data)
            run2[f"png_decode_ms_480x752_{name}"] = (time.perf_counter() - t0) * 1e3 / 5

        # each kernel against its plain version at the shapes runs 1 and 2
        # gave it: K2 on the repeat DB, K3 on four pairs' rectified images,
        # K1 on a DB of run 1's default shape holding the taught rows
        q, _, lim = db_queries(teach, cfg.runtime.descriptor_batch, seed=1)
        checks["K2"] = k2_measure(q, repeat.db.vectors, lim, repeat.db.global_ids,
                                  k=cfg.loop.candidates_per_query)
        pairs = [repeat._load_pair(c)[1:] for c in (repeat.loop_edges + repeat.rejected_candidates)[:4]]
        L = torch.from_numpy(np.stack([p[j] for p in pairs for j in (0, 2)])).to(device)
        R = torch.from_numpy(np.stack([p[j] for p in pairs for j in (1, 3)])).to(device)
        checks["K3"] = {"B": L.shape[0], **k3_measure(L, R)}
        cap = CerebroConfig().loop.db_capacity  # run 1's DB
        taught = teach.db.vectors[: teach.db.count]
        big = taught.repeat(-(-cap // taught.shape[0]), 1)[:cap].contiguous()
        gids = torch.arange(cap, dtype=torch.int32, device=device)
        lim8 = torch.full((8,), cap, dtype=torch.int32, device=device)
        checks["K1"] = k1_measure(q[:8], big, q[:8], big, lim8, gids)
        del big

        # 3. gist, then WPCA to the records' width (WPCA_AB.json: 191) fitted
        # on lap 1's ported descriptors; detection only, both laps at stride 2
        wpca_path = os.path.join(tmp, "wpca.npz")
        wp = fit_wpca(teach.db.vectors[:lap, : teach.db.dim].float().cpu().numpy(), out_dim=191)
        save_wpca(wp, wpca_path)
        teach.close()
        repeat.close()
        configs = {
            "gist": dataclasses.replace(cfg, descriptor=dataclasses.replace(cfg.descriptor, kind="gist")),
            # Method A top-1, so K1 runs at D=191
            "wpca": dataclasses.replace(
                cfg, descriptor=dataclasses.replace(cfg.descriptor, wpca_artifact=wpca_path),
                loop=dataclasses.replace(cfg.loop, candidates_per_query=1),
            ),
        }
        run3 = {"wpca_out_dim": wp.out_dim}
        for name, c in configs.items():
            K1.launches = K2.launches = 0
            pipe = CerebroPipeline(c, rig=rect.rig, device=device)
            r = run_sequence(pipe, rectified_frames(euroc.frames(stride=2), rect, new_times()),
                             verify=False)
            stats = pipe.timer.stats()
            describe = pipe.timer.stats(skip_first=1)["describe"]
            res = run3[name] = {
                "frames": r.n_frames, "descriptor_dim": pipe.db.dim,
                "row_width": pipe.db.vectors.shape[1], "candidates": r.n_candidates,
                "detect_batches": stats["detect"]["count"],
                # launch cost per batch (no device sync), and the first
                # batch's (gist draws its projection then)
                "describe_ms": describe["mean_ms"], "describe_first_ms": describe.get("first_ms"),
                "k1_launches": K1.launches, "k2_launches": K2.launches, **desc_stats(pipe),
            }
            check_unit_descriptors(res, name)
            if name == "gist":
                launches["K2"] += K2.launches
                check(K2.launches == res["detect_batches"] and K1.launches == 0,
                      f"gist: K2 launched {K2.launches} times for {res['detect_batches']} batches")
                # K2 at the gist run's own shape (D = 4,096)
                q, _, lim = db_queries(pipe, c.runtime.descriptor_batch, seed=2)
                checks["K2_gist"] = k2_measure(q, pipe.db.vectors, lim, pipe.db.global_ids,
                                               k=c.loop.candidates_per_query)
            else:
                launches["K1_d191"] += K1.launches
                check(res["descriptor_dim"] == 191 and res["row_width"] == ddb.row_width(191, device),
                      f"wpca: {res['descriptor_dim']} logical / {res['row_width']} stored columns")
                check(K1.launches == res["detect_batches"] and K2.launches == 0,
                      f"wpca: K1 launched {K1.launches} times for {res['detect_batches']} batches")
                q, qp, lim = db_queries(pipe, c.runtime.descriptor_batch, seed=3)
                checks["K1_d191"] = k1_measure(qp, pipe.db.vectors, q, pipe.db.vectors[:, :191],
                                               lim, pipe.db.global_ids)
            pipe.close()
        out["gist_wpca"] = run3
    out["kernel_checks"] = checks
    return out, checks, launches


# ---------------------------------------------------------------------------
# The live node, and the depth-camera rig
# ---------------------------------------------------------------------------


def live_config(n_frames: int):
    """scripts/soak_live_rate.py's settings (:74-118) at the port's default
    29,184-row DB: the ported descriptor at 240x320, descriptor batches of
    16, images kept in RAM for 10 s, one pose-graph shape for the whole
    run (node floor past the stream's frames, loop floor 256), 1,024
    features, 128 RANSAC hypotheses, GMS factor 4, accept gate 200; Method
    A top-1 (K1). Returns (config, node floor)."""
    from cerebro_tpu_torch import config as C

    node_floor = 512
    while node_floor < n_frames + 2:
        node_floor *= 2
    cfg = C.CerebroConfig(
        descriptor=C.DescriptorConfig(image_hw=(240, 320), kind="ported"),
        runtime=C.RuntimeConfig(descriptor_batch=16, stash_dir="", image_ram_window_s=10.0),
        posegraph=C.PoseGraphConfig(node_bucket_floor=node_floor, loop_bucket_floor=256),
        verify=C.VerifyConfig(
            max_features=1024, ransac_hypotheses=128, gms_factor=4.0, min_matches_accept=200
        ),
    )
    return cfg, node_floor


def edge_precision(pipe, seq) -> float:
    return sum(
        np.linalg.norm(seq.xy[e.idx_curr] - seq.xy[e.idx_prev]) < 1.0 for e in pipe.loop_edges
    ) / max(len(pipe.loop_edges), 1)


def phase_live(device, stream_s: float):
    """The live node as users run it: a 20 Hz stereo stream of the photo
    world (a lap every LIVE_LAP_S seconds, no kidnap) pushed in real time
    by a producer thread into CerebroService's worker and optimizer
    threads, after CerebroPipeline.warmup on this thread; then
    stop(save_dir=). Returns (the phase line, the kernel checks, the K1 /
    K2 / K3 launches of the stream and the drain)."""
    import os
    import tempfile
    import threading

    from cerebro_tpu_torch import photoworld as pw
    from cerebro_tpu_torch import synthworld as sw
    from cerebro_tpu_torch.io import load_pipeline_state
    from cerebro_tpu_torch.ops.similarity import K1, K2
    from cerebro_tpu_torch.ops.stereo_kernel import K3
    from cerebro_tpu_torch.runtime import CerebroPipeline, CerebroService

    ns_per_s = 1_000_000_000
    n_frames = int(stream_s * LIVE_RATE_HZ)
    t0 = time.perf_counter()
    world = pw.PhotoWorld.create(seed=0)
    seq = pw.make_photo_sequence(
        n_frames=n_frames, laps=stream_s / LIVE_LAP_S, kidnap_frames=0, teleport_phase=0.0
    )
    ren = sw.Renderer(world)
    frames = [ren.stereo(float(x), float(y)) for x, y in seq.xy]  # rendered before the clock
    t_world = time.perf_counter() - t0
    cfg, node_floor = live_config(n_frames)
    pipe = CerebroPipeline(cfg, rig=ren.rig(), body_T_cam=sw.body_T_cam(), device=device)

    t0 = time.perf_counter()
    warm = pipe.warmup(
        verify_device_batches=(8,), optimize_node_buckets=(node_floor,), optimize_loop_buckets=(256,)
    )
    warm_s = time.perf_counter() - t0

    svc = CerebroService(pipe, hold_s=0.05, flush_interval_s=0.9, verify_every_s=1.5)
    backlog, edges_timeline = [], []
    push = {"total_s": 0.0, "max_s": 0.0, "sleep_overrun_s": 0.0}

    def producer():
        for i in range(n_frames):
            target = t_start + i / LIVE_RATE_HZ
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
                overrun = time.perf_counter() - target
                if overrun > 0.05:
                    push["sleep_overrun_s"] += overrun
            ns = int((1.0 + i / LIVE_RATE_HZ) * ns_per_s)
            t_push = time.perf_counter()
            svc.push_image(ns, frames[i][0])
            svc.push_image(ns, frames[i][1], is_right=True)
            svc.push_pose(ns, seq.odom_poses[i])
            svc.push_tracking(ns, 100, is_keyframe=(i % 2 == 0))
            dt = time.perf_counter() - t_push
            push["total_s"] += dt
            push["max_s"] = max(push["max_s"], dt)
        svc.push_image(10**6 * ns_per_s, np.zeros_like(frames[0][0]))  # release the hold window

    def monitor():
        # host counters only
        while th.is_alive():
            backlog.append(svc.ingest.engine.pending + len(pipe._pending_desc))
            edges_timeline.append(len(pipe.loop_edges))
            time.sleep(0.1)

    th = threading.Thread(target=producer)
    mon = threading.Thread(target=monitor)
    K1.launches = K2.launches = K3.launches = 0
    t_start = time.perf_counter()
    svc.start()
    th.start()
    mon.start()
    th.join()
    mon.join()
    wall = time.perf_counter() - t_start
    stream_launches = {"K1": K1.launches, "K2": K2.launches, "K3": K3.launches}
    edges_at_stream_end = len(pipe.loop_edges)
    edges_live = max(edges_timeline, default=0)
    optimized_live = svc.latest_trajectory is not None
    verify_lag = len(pipe.candidates)  # the 1 Hz consumer's queue at stream end
    with tempfile.TemporaryDirectory(prefix="chip_smoke_live_") as tmp:
        t0 = time.perf_counter()
        svc.stop(save_dir=os.path.join(tmp, "state"))
        torch.cuda.synchronize()
        stop_s = time.perf_counter() - t0
        drain_launches = {k: K.launches - stream_launches[k]
                          for k, K in (("K1", K1), ("K2", K2), ("K3", K3))}
        reloaded = load_pipeline_state(os.path.join(tmp, "state"), cfg=cfg, rig=ren.rig(),
                                       device=device)
        reload_ok = (reloaded.store.size == pipe.store.size and reloaded.db.total == pipe.db.total
                     and len(reloaded.loop_edges) == len(pipe.loop_edges))
        reloaded.close()
    st = svc.status()
    errs = edge_errors(pipe, seq)
    # the pixels the engine handed over are the frames pushed at those stamps
    ends = {i for e in pipe.loop_edges for i in (e.idx_curr, e.idx_prev)}
    pixels_intact = all(
        np.array_equal(pipe.images.get("left", i), frames[i][0])
        and np.array_equal(pipe.images.get("right", i), frames[i][1]) for i in ends
    )
    eligible = int(sum(i % 2 == 0 for i in range(n_frames)))  # keyframes with 100 tracked
    stats = pipe.timer.stats()
    out = {
        "phase": "live",
        "stream_s": stream_s, "rate_hz": LIVE_RATE_HZ, "laps": stream_s / LIVE_LAP_S,
        "settings": "scripts/soak_live_rate.py: ported descriptor 240x320, batch 16, 1024 "
                    "features, 128 hypotheses, GMS factor 4, accept gate 200, hold 0.05 s, "
                    f"flush 0.9 s, verify every 1.5 s; DB {cfg.loop.db_capacity} rows; Method A top-1",
        "world_and_render_s": t_world,
        "warmup_s": warm_s, "warmup_detail_s": warm,
        "wall_s_stream": wall, "realtime_factor": stream_s / wall,
        "frames_pushed": n_frames, "frames": st["frames"],
        "eligible_keyframes": eligible, "described": st["described"],
        "shed": st["shed_descriptors"], "ingest_dropped": st["ingest_dropped"],
        "pixels_dropped": st["pixels_dropped"],
        "max_backlog_frames": int(max(backlog, default=0)),
        "p50_backlog_frames": float(np.median(backlog)) if backlog else 0.0,
        "loop_edges_live": int(edges_live), "loop_edges_final": st["loop_edges"],
        "rejected_final": st["rejected_candidates"],
        "verify_lag_pairs_at_stream_end": verify_lag,
        "optimized_during_stream": optimized_live,
        # per edge: prev, curr, matches, verified during the stream, error
        "edges": [[e.idx_prev, e.idx_curr, e.n_matches, k < edges_at_stream_end, a, t]
                  for k, (e, (a, t)) in enumerate(zip(pipe.loop_edges, errs))],
        "edge_pixels_intact": pixels_intact,
        "edge_rot_err_deg_max": max((a for a, _ in errs), default=None),
        "edge_trans_err_m_max": max((t for _, t in errs), default=None),
        "edge_precision": edge_precision(pipe, seq),
        "detect_batches": stats["detect"]["count"],
        "stream_launches": stream_launches, "drain_launches": drain_launches,
        "stop_s": stop_s, "saved_state_reloads": reload_ok,
        "producer_push": push,
        "worker_stage_ms": pipe.timer.stats(skip_first=1),
    }
    far = [e for e, (a, t) in zip(pipe.loop_edges, errs) if a > EDGE_DEG or t > EDGE_M]
    out["edges_beyond_2deg_0p2m"] = len(far)
    out["reverify_far_edges"] = reverify(pipe, seq, far)
    # each kernel on this run's own data: K1 on the live DB's rows, K3 on
    # the images of up to 8 verified pairs (a live verify group's shape)
    q, _, lim = db_queries(pipe, cfg.runtime.descriptor_batch, seed=5)
    checks = {"K1": k1_measure(q, pipe.db.vectors, q, pipe.db.vectors, lim, pipe.db.global_ids)}
    check(pipe.loop_edges, "live: no loop edge")
    pairs = [pipe._load_pair(e)[1:] for e in pipe.loop_edges[:8]]
    L = torch.from_numpy(np.stack([p[j] for p in pairs for j in (2, 0)])).to(device)
    R = torch.from_numpy(np.stack([p[j] for p in pairs for j in (3, 1)])).to(device)
    checks["K3"] = {"B": L.shape[0], **k3_measure(L, R)}
    out["kernel_checks"] = checks
    pipe.close()
    launches = {k: stream_launches[k] + drain_launches[k] for k in stream_launches}
    return out, checks, launches


def reverify(pipe, seq, edges, n: int = 8) -> list:
    """Each edge's pair verified ``n`` more times as the live tier does it
    (cascade=False), each time with a fresh generator: how many accept, and
    each accepted pose's error against ground truth."""
    from cerebro_tpu_torch.geometry import se3
    from cerebro_tpu_torch.verify.geometric import verify_pair

    out = []
    for e in edges:
        _, la, ra, lb, rb = pipe._load_pair(e)
        imgs = [torch.from_numpy(x).to(pipe.device) for x in (lb, rb, la, ra)]
        gt = torch.from_numpy((np.linalg.inv(seq.gt_poses[e.idx_prev]) @ seq.gt_poses[e.idx_curr])
                              .astype(np.float32))
        errs = []
        for k in range(n):
            g = torch.Generator(device=pipe.device).manual_seed(1000 + k)
            r = verify_pair(pipe.cfg.verify, g, *imgs, pipe.rig)
            if bool(r.accepted):
                ang, tr = se3.pose_delta_metrics(gt, torch.linalg.inv(r.T_b_a.float()).cpu())
                errs.append([float(ang), float(tr)])
        out.append({"prev": e.idx_prev, "curr": e.idx_curr, "tries": n, "accepted": len(errs),
                    "errors": errs})
    return out


def check_live(run: dict, launches: dict):
    check(run["frames"] == run["frames_pushed"], f"live: {run['frames']} of {run['frames_pushed']} frames")
    check(run["described"] + run["shed"] == run["eligible_keyframes"],
          f"live: described {run['described']} + shed {run['shed']} != {run['eligible_keyframes']}")
    check(run["ingest_dropped"] == 0, f"live: the ingest engine dropped {run['ingest_dropped']}")
    check(run["loop_edges_live"] >= 1, "live: no loop edge while the stream ran")
    check(run["edge_pixels_intact"], "live: an edge's stored images are not the frames pushed")
    check(run["edge_rot_err_deg_max"] <= WRONG_LOOP_DEG and run["edge_trans_err_m_max"] <= WRONG_LOOP_M,
          f"live: an edge is more than {WRONG_LOOP_DEG} deg / {WRONG_LOOP_M} m from ground truth")
    check(run["saved_state_reloads"], "live: the saved state does not reload")
    check(launches["K1"] == run["detect_batches"] and launches["K2"] == 0,
          f"live: K1 launched {launches['K1']} times for {run['detect_batches']} detect batches")
    check(launches["K3"] > 0, "live: K3 never launched")


def phase_depth(device, n_frames: int, laps: float) -> dict:
    """The depth-camera rig: the photo world at photo_config's settings
    (top-3, K2), every keyframe fed with Renderer.depth and no right
    image, then verify_pending (one call per pair, no cascade) and
    optimize_trajectory."""
    from cerebro_tpu_torch import photoworld as pw
    from cerebro_tpu_torch import synthworld as sw
    from cerebro_tpu_torch.ops.similarity import K1, K2
    from cerebro_tpu_torch.ops.stereo_kernel import K3
    from cerebro_tpu_torch.runtime import CerebroPipeline

    t0 = time.perf_counter()
    world = pw.PhotoWorld.create(seed=0)
    # a keyframe every DEPTH_DT_S: a lap takes 15 s, as the live stream's
    # do, past the 10 s pair gate (VerifyConfig.min_pair_dt_s)
    seq = pw.make_photo_sequence(n_frames=n_frames, laps=laps, kidnap_frames=0,
                                 teleport_phase=0.0, dt=DEPTH_DT_S)
    ren = sw.Renderer(world)
    views = [(ren.render(float(x), float(y)), ren.depth(float(x), float(y))) for x, y in seq.xy]
    t_world = time.perf_counter() - t0
    cfg = photo_config(n_frames)
    pipe = CerebroPipeline(cfg, rig=ren.rig(), body_T_cam=sw.body_T_cam(), device=device)
    pipe.timer.sync = True
    K1.launches = K2.launches = K3.launches = 0
    t0 = time.perf_counter()
    for i, (left, depth) in enumerate(views):
        pipe.ingest_frame(float(seq.stamps[i]), left, n_tracked=int(seq.n_tracked[i]),
                          pose=seq.odom_poses[i], depth_img=depth,
                          is_keyframe=bool(seq.is_keyframe[i]))
    pipe.flush_descriptors()
    cands = list(pipe.candidates)
    t_ingest = time.perf_counter() - t0
    k3_before_verify = K3.launches
    t0 = time.perf_counter()
    accepted = pipe.verify_pending()
    torch.cuda.synchronize()
    t_verify = time.perf_counter() - t0
    k3_verify = K3.launches - k3_before_verify
    t0 = time.perf_counter()
    opt = pipe.optimize_trajectory()
    t_opt = time.perf_counter() - t0
    errs = edge_errors(pipe, seq)
    stats = pipe.timer.stats()
    steady = pipe.timer.stats(skip_first=1)
    reasons: dict = {}
    for r in pipe.rejected_candidates:
        key = "accept gate" if r.reason.startswith("match count") else r.reason.split(" (")[0]
        reasons[key] = reasons.get(key, 0) + 1
    out = {
        "phase": "depth",
        "frames": n_frames, "laps": laps,
        "settings": f"photo_config: top-3, DB {cfg.loop.db_capacity} rows, batch 16, 1024 "
                    "features, accept gate 200; depth images, no right images",
        **candidate_quality(pipe, seq, cands),
        "edges_accepted": accepted, "edges_rejected": len(pipe.rejected_candidates),
        "reject_reasons": reasons, "escalated_to_tier2": pipe.escalated_to_tier2,
        "edge_precision": edge_precision(pipe, seq),
        "edge_rot_err_deg_max": max((a for a, _ in errs), default=None),
        "edge_trans_err_m_max": max((t for _, t in errs), default=None),
        "optimize_finite": opt is not None and bool(np.isfinite(opt).all()),
        "world_and_render_s": t_world, "ingest_s": t_ingest, "verify_s": t_verify,
        "verify_ms_per_pair": 1e3 * t_verify / max(len(cands), 1),
        "optimize_s": t_opt,
        "detect_batches": stats["detect"]["count"],
        "k1_launches": K1.launches, "k2_launches": K2.launches, "k3_launches": K3.launches,
        "k3_launches_verify": k3_verify,
        "stage_mean_ms": {k: steady[k]["mean_ms"] for k in ("describe", "detect", "verify") if k in steady},
    }
    pipe.close()
    return out


def check_depth(out: dict):
    check(out["edges_accepted"] >= 1, "depth: no loop edge")
    check(out["edge_rot_err_deg_max"] <= EDGE_DEG and out["edge_trans_err_m_max"] <= EDGE_M,
          f"depth: an edge is more than {EDGE_DEG} deg / {EDGE_M} m from ground truth")
    check(out["k3_launches"] == 0, f"depth: K3 launched {out['k3_launches']} times")
    check(out["k2_launches"] == out["detect_batches"] and out["k1_launches"] == 0,
          f"depth: K2 launched {out['k2_launches']} times for {out['detect_batches']} detect batches")
    check(out["optimize_finite"], "depth: the solve is not finite")


# ---------------------------------------------------------------------------
# The in-framework descriptor net (the default kind) and the int8 DB
# ---------------------------------------------------------------------------


def describe_check(device, variant: str, dtype: str, reps: int = 10) -> dict:
    """The seeded DescriptorNet of ``variant`` at the default config's
    240x320 on a batch of 8 on the card, against the same params on the
    CPU: float32 within NETVLAD_F32_ATOL, bfloat16 to a per-descriptor
    cosine of at least NETVLAD_BF16_COS; describe ms per batch. The card
    runs with TF32 allowed for cuDNN and matmul (cuDNN's is PyTorch's
    default), so a float32 net is held and timed as a user runs it: it
    must keep itself off TF32."""
    from cerebro_tpu_torch import config as C
    from cerebro_tpu_torch.models.descriptor import create_descriptor_model, describe_batch

    kw = {"mobile": {}, "vgg16": {"backbone": "vgg16"}, "ghost": {"num_ghost": 2}}[variant]
    cfg = C.DescriptorConfig(dtype=dtype, **kw)
    net, params = create_descriptor_model(cfg, seed=0, device="cpu")
    imgs = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (8, *cfg.image_hw, 1), dtype=np.uint8)
    )
    want = describe_batch(net, params, imgs)
    net = net.to(device)
    params = {k: v.to(device) for k, v in params.items()}
    imgs_dev = imgs.to(device)
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = describe_batch(net, params, imgs_dev)
        torch.cuda.synchronize()
        got = got.cpu()
        err = float((got - want).abs().max())
        cos = float((got * want).sum(dim=1).min())
        ok = err <= NETVLAD_F32_ATOL if dtype == "float32" else cos >= NETVLAD_BF16_COS
        check(ok, f"netvlad {variant} {dtype}: card against CPU max err {err}, min cosine {cos}")
        return {
            "variant": variant, "dtype": dtype, "batch": 8, "image_hw": list(cfg.image_hw),
            "tf32_allowed": True, "descriptor_dim": net.descriptor_dim,
            "max_abs_err_vs_cpu": err, "min_cosine_vs_cpu": cos,
            "describe_ms_per_batch": cuda_ms(lambda: describe_batch(net, params, imgs_dev), reps),
            # 5 calls: the profiler records 31 and its host cost grows with them
            **profiled_device_ms(lambda: describe_batch(net, params, imgs_dev), 5),
        }
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def run_stream(pipe, seq, frames, verify: bool = True) -> dict:
    """Feed a survey (bench_e2e.py's stream: no pose in the kidnap span),
    then verify_pending: the counts and edge errors of a run."""
    from cerebro_tpu_torch.ops.similarity import INT8_MM, K1, K2
    from cerebro_tpu_torch.ops.stereo_kernel import K3

    K1.launches = K2.launches = K3.launches = INT8_MM.launches = 0
    t0 = time.perf_counter()
    feed_survey(pipe, seq, frames)
    cands = list(pipe.candidates)
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    accepted = pipe.verify_pending() if verify else 0
    torch.cuda.synchronize()
    t_verify = time.perf_counter() - t0
    errs = edge_errors(pipe, seq)
    stats = pipe.timer.stats()
    steady = pipe.timer.stats(skip_first=1)
    return {
        **candidate_quality(pipe, seq, cands),
        "edges_accepted": accepted,
        "edges_rejected": len(pipe.rejected_candidates),
        "edge_precision": edge_precision(pipe, seq),
        "edge_rot_err_deg_max": max((a for a, _ in errs), default=None),
        "edge_trans_err_m_max": max((t for _, t in errs), default=None),
        "descriptor_dim": pipe.db.dim, "db_rows": pipe.db.capacity,
        "detect_batches": stats["detect"]["count"],
        "k1_launches": K1.launches, "k2_launches": K2.launches, "k3_launches": K3.launches,
        "int8_mm_launches": INT8_MM.launches,
        "ingest_s": t_ingest, "verify_s": t_verify,
        "stage_mean_ms": {k: steady[k]["mean_ms"] for k in ("describe", "detect") if k in steady},
    }, cands


def check_netvlad_run(r: dict, what: str):
    check(r["k1_launches"] == r["detect_batches"],
          f"{what}: K1 launched {r['k1_launches']} times for {r['detect_batches']} detect batches")
    check(r["k2_launches"] == 0, f"{what}: Method A top-1 launched K2")
    check(r["k3_launches"] > 0, f"{what}: verification never launched K3")
    check(r["edges_accepted"] == 0 or (r["edge_rot_err_deg_max"] <= WRONG_LOOP_DEG
                                       and r["edge_trans_err_m_max"] <= WRONG_LOOP_M),
          f"{what}: an accepted loop edge is more than {WRONG_LOOP_DEG} deg / {WRONG_LOOP_M} m "
          "from ground truth")


def trained_photo_run(device, npz_dir: str, n_frames: int, laps: float) -> tuple:
    """A trained descriptor (``npz_dir``: params.npz and meta.json, as
    load_descriptor_params reads them) in CerebroPipeline(params=...) on the
    photo world, ``n_frames`` over ``laps`` with the kidnap, photo_config's
    gates and batches, Method A top-1 on the default 29,184-row DB (K1),
    the default cascade: (run_stream's line, the pipeline)."""
    from cerebro_tpu_torch import config as C
    from cerebro_tpu_torch import photoworld as pw
    from cerebro_tpu_torch import synthworld as sw
    from cerebro_tpu_torch.models.descriptor import load_descriptor_params
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

    pworld = pw.PhotoWorld.create(seed=0)
    pseq = pw.make_photo_sequence(n_frames=n_frames, laps=laps)
    pren = sw.Renderer(pworld)
    pframes = [pren.stereo(float(x), float(y)) for x, y in pseq.xy]
    base = photo_config(n_frames)
    with open(f"{npz_dir}/meta.json") as fh:
        mc = json.load(fh)["config"]
    dcfg = C.DescriptorConfig(kind="netvlad", image_hw=tuple(mc["image_hw"]),
                              trunk_dim=mc["trunk_dim"], num_clusters=mc["num_clusters"])
    cfg = dataclasses.replace(base, descriptor=dcfg, loop=C.LoopConfig())
    _, params = load_descriptor_params(npz_dir, dcfg, device=device)
    tpipe = CerebroPipeline(cfg, rig=pren.rig(), params=params, body_T_cam=sw.body_T_cam(),
                            device=device)
    tpipe.timer.sync = True
    trained, _ = run_stream(tpipe, pseq, pframes)
    trained.update({"frames": n_frames, "laps": laps, "world": "photo",
                    "settings": f"{npz_dir} ({mc['num_clusters']} x {mc['trunk_dim']}), "
                                "photo_config's gates and batches of 16, Method A top-1, "
                                "29,184-row DB, default cascade",
                    "escalated_to_tier2": tpipe.escalated_to_tier2,
                    "tier2_accepted": tpipe.tier2_accepted})
    return trained, tpipe


def phase_netvlad(device, world) -> tuple:
    """The default descriptor kind: the seeded net's three variants on the
    card against the CPU; CerebroPipeline at the default CerebroConfig() on
    a shortened synthworld survey; the trained synth net (256-d) on the
    photo world. Returns (line, {D: (pipe, launches)})."""
    from cerebro_tpu_torch import config as C
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

    out = {"phase": "netvlad", "describe": [
        describe_check(device, v, d) for v in ("mobile", "vgg16", "ghost")
        for d in ("bfloat16", "float32")
    ]}

    # (b) the default config, seeded weights (untrained: no target)
    cfg = C.CerebroConfig()
    seq, ren, frames = synth_survey(world, NETVLAD_FRAMES, NETVLAD_LAPS)
    pipe = CerebroPipeline(cfg, rig=ren.rig(), device=device)
    pipe.timer.sync = True
    default, _ = run_stream(pipe, seq, frames)
    default.update({"frames": NETVLAD_FRAMES, "laps": NETVLAD_LAPS,
                    "settings": "CerebroConfig() (the seeded 4,096-d net, 29,184-row DB, "
                                "batches of 8, default verification and cascade)",
                    "escalated_to_tier2": pipe.escalated_to_tier2,
                    "tier2_accepted": pipe.tier2_accepted})
    out["default_config"] = default
    check_netvlad_run(default, "netvlad default config")
    runs = {pipe.db.dim: (pipe, default["k1_launches"])}

    # (c) the trained synth net on the photo world at photo_config's gates, top-1
    trained, tpipe = trained_photo_run(device, SYNTH_NPZ, PHOTO_FRAMES, PHOTO_LAPS)
    out["trained_synth_photo"] = trained
    check_netvlad_run(trained, "netvlad trained synth")
    runs[tpipe.db.dim] = (tpipe, trained["k1_launches"])
    for r in (default, trained):
        check(r["descriptor_dim"] in (4096, 256), f"netvlad: descriptor width {r['descriptor_dim']}")
    return out, runs


def netvlad_kernel_entries(runs: dict) -> list:
    """K1 at the netvlad runs' widths (D = 4,096 and 256) and batch sizes
    (each run's descriptor_batch, which picks the kernel's instantiation),
    held on each run's own DB rows against the plain version, with the
    run's launches and Q; then the runs' pipelines are closed."""
    entries = []
    for D, (pipe, launches) in sorted(runs.items(), reverse=True):
        q, qp, lim = db_queries(pipe, pipe.cfg.runtime.descriptor_batch, seed=D)
        t = k1_measure(qp, pipe.db.vectors, q, pipe.db.vectors[:, : pipe.db.dim], lim,
                       pipe.db.global_ids)
        entries.append({**kernel_entry(f"k1_d{D}", "cerebro_tpu_torch/csrc/score_topk.cu",
                                       "cerebro_tpu/ops/similarity.py:98", launches,
                                       t["max_abs_err"], t), "Q": t["Q"]})
        pipe.close()
    check(all(e["launches"] > 0 for e in entries), "a netvlad run never launched K1")
    return entries


def int8_measure(device, Q: int, N: int, D: int, seed: int) -> dict:
    """The int8 search (one torch._int_mm) against the plain exact product
    on the card, on k1_case's planted DB quantized: gids equal (and the
    planted ones), maxima within 1e-6; its time beside K1's on the bf16 DB
    and the int8 DB's one-read bound."""
    from cerebro_tpu_torch.ops import similarity as sim

    q, db, lim, gids, expect, _ = k1_case(Q, N, D, device, seed)
    dbq, dbs = sim.quantize_rows(db.float())
    km, kg = sim.max_and_argmax_int8_cuda(q, dbq, dbs, lim, gids)
    pm, pg = sim.max_and_argmax_int8_plain(q, dbq, dbs, lim, gids)
    torch.cuda.synchronize()
    err = float((km - pm).abs().max())
    check(torch.equal(kg, pg) and torch.equal(kg.cpu(), expect),
          f"int8 at Q={Q} D={D}: gids {kg.tolist()} plain {pg.tolist()} expected {expect.tolist()}")
    check(err <= 1e-6, f"int8 at Q={Q} D={D}: maxima differ by {err}")
    nbytes = N * D + N * 4 + N * 4 + Q * D * 4 + Q * 4 + Q * 8
    b_ms, b_by = bound(nbytes, 2.0 * Q * N * D, INT8_OPS_PER_S)
    out = {
        "Q": Q, "N": N, "D": D, "max_abs_err": err, "gids_exact": True,
        "int8_ms": cuda_ms(lambda: sim.max_and_argmax_int8_cuda(q, dbq, dbs, lim, gids), 20),
        "int8_plain_ms": cuda_ms(lambda: sim.max_and_argmax_int8_plain(q, dbq, dbs, lim, gids), 3),
        "k1_ms": cuda_ms(lambda: sim.max_and_argmax_cuda(q, db, lim, gids), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        **profiled_device_ms(lambda: sim.max_and_argmax_int8_cuda(q, dbq, dbs, lim, gids), 20),
    }
    del q, db, dbq
    torch.cuda.empty_cache()
    return out


def phase_int8(device, world, float_run=None, N: int = 29184, dims=(8192, 4096)) -> dict:
    """The int8 DB: the search against its plain version at the detector's
    shapes; the pipeline phase's run with loop.quantized=True (detection)
    against the float run's candidates; a quantized teach / save / load /
    repeat round trip. ``float_run``: (survey, candidates, score history)
    of the pipeline phase; None runs its detection here."""
    import tempfile

    from cerebro_tpu_torch import config as C
    from cerebro_tpu_torch.io import load_pipeline_state, save_pipeline_state
    from cerebro_tpu_torch.ops.similarity import INT8_MM, K1
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

    out = {"phase": "int8", "search": [
        int8_measure(device, Q, N, D, seed) for D in dims
        for Q, seed in ((8, 10), (64, 11))
    ]}
    fcfg = C.CerebroConfig(
        descriptor=C.DescriptorConfig(kind="ported"),
        verify=C.VerifyConfig(cascade=False, min_matches_accept=200),
    )
    qcfg = dataclasses.replace(fcfg, loop=dataclasses.replace(fcfg.loop, quantized=True))
    if float_run is None:
        survey = synth_survey(world, FRAMES, LAPS)
        fpipe = CerebroPipeline(fcfg, rig=survey[1].rig(), device=device)
        feed_frames(fpipe, *survey)
        fcands, fhist = list(fpipe.candidates), fpipe.score_history
        fpipe.close()
    else:
        survey, fcands, fhist = float_run
    seq, ren, frames = survey

    pipe = CerebroPipeline(qcfg, rig=ren.rig(), device=device)
    pipe.timer.sync = True
    K1.launches = INT8_MM.launches = 0
    feed_frames(pipe, *survey)
    qcands = list(pipe.candidates)
    stats = pipe.timer.stats()
    qhist = pipe.score_history
    f = {(c.idx_curr, c.idx_prev): c.score for c in fcands}
    q = {(c.idx_curr, c.idx_prev): c.score for c in qcands}
    # a pair only one run emits, with both runs' max score of its query
    # (every frame is described, so query = store index)
    differing = [
        {"curr": a, "prev": b, "emitted_by": "float" if (a, b) in f else "quantized",
         "score_float": fhist[a], "score_quantized": qhist[a]}
        for a, b in sorted(f.keys() ^ q.keys())
    ]
    out["quantized_run"] = {
        "frames": len(frames), "db_rows": pipe.db.capacity, "descriptor_dim": pipe.db.dim,
        "detect_batches": stats["detect"]["count"],
        "int8_mm_launches": INT8_MM.launches, "k1_launches": K1.launches,
        "candidates_float": len(f), "candidates_quantized": len(q),
        "same_pairs": f.keys() == q.keys(), "differing_pairs": differing,
        "score_max_abs_diff": max((abs(f[k] - q[k]) for k in f.keys() & q.keys()), default=None),
        "detect_ms_mean": pipe.timer.stats(skip_first=1)["detect"]["mean_ms"],
        **candidate_quality(pipe, seq, qcands),
    }
    check(INT8_MM.launches == stats["detect"]["count"] and K1.launches == 0,
          f"int8 run: {INT8_MM.launches} int8 products, {K1.launches} K1 launches for "
          f"{stats['detect']['count']} detect batches")
    check(len(q) > 0, "the quantized run found no candidate")
    pipe.close()

    # teach lap 1, save, load, repeat lap 2 against the int8 map
    half = len(frames) // 2
    teach = CerebroPipeline(qcfg, rig=ren.rig(), device=device)
    feed_frames(teach, seq, ren, frames[:half])
    with tempfile.TemporaryDirectory() as tmp:
        save_pipeline_state(teach, tmp)
        with open(f"{tmp}/manifest.json") as fh:
            manifest = json.load(fh)
        repeat = load_pipeline_state(tmp, cfg=qcfg, rig=ren.rig(), device=device)
    same_db = all(torch.equal(getattr(repeat.db, k), getattr(teach.db, k))
                  for k in ("values", "scales", "global_ids"))
    n_taught = repeat.store.size  # store index n_taught + j is frame half + j
    described = len(repeat.db_gid_to_store)
    INT8_MM.launches = 0
    for i in range(half, len(frames)):
        left, right = frames[i]
        repeat.ingest_frame(1e4 + float(seq.stamps[i]), left, n_tracked=int(seq.n_tracked[i]),
                            pose=None, right_img=right)
    repeat.flush_descriptors()
    into_map = [(c.idx_curr, c.idx_prev) for c in repeat.candidates if c.idx_prev < n_taught]
    right_place = sum(np.linalg.norm(seq.xy[half + a - n_taught] - seq.xy[b]) < 1.5
                      for a, b in into_map)
    out["teach_repeat"] = {
        "taught": n_taught, "described": described, "db_quantized": manifest["db_quantized"], "loaded_db_equal": same_db,
        "repeat_candidates_into_map": len(into_map), "into_map_within_1p5m": int(right_place),
        "repeat_int8_mm_launches": INT8_MM.launches,
    }
    check(manifest["db_quantized"] and same_db, "int8 teach/repeat: the loaded DB differs")
    check(len(into_map) > 0, "int8 teach/repeat: no candidate into the taught map")
    teach.close()
    repeat.close()
    return out


# ---------------------------------------------------------------------------
# The training path
# ---------------------------------------------------------------------------


def place_batch(hw, places: int, views: int, seed: int) -> tuple:
    """(places * views, H, W, 1) uint8 images, each place's views near
    copies of one noise image, and their int32 place labels."""
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for p in range(places):
        base = rng.integers(0, 256, (*hw, 1)).astype(np.int32)
        for _ in range(views):
            imgs.append(np.clip(base + rng.integers(-12, 13, base.shape), 0, 255).astype(np.uint8))
            labels.append(p)
    return np.stack(imgs), np.asarray(labels, np.int32)


def forward_flops(net, x) -> float:
    """Multiply-adds x 2 of one forward of ``net`` on ``x``: every
    convolution (``backbones.Conv``, counted from its output and kernel) and
    NetVLAD's two products (assignment and aggregation)."""
    from cerebro_tpu_torch.models.backbones import Conv
    from cerebro_tpu_torch.models.netvlad import NetVLAD

    total = [0.0]

    def conv_hook(mod, inp, out):
        total[0] += 2.0 * out.numel() * mod.weight.shape[1] * mod.k * mod.k

    def vlad_hook(mod, inp, out):
        B, C, H, W = inp[0].shape
        K = mod.num_clusters
        total[0] += 2.0 * B * H * W * C * (K + mod.num_ghost) + 2.0 * B * K * H * W * C

    hooks = [m.register_forward_hook(conv_hook) for m in net.modules() if isinstance(m, Conv)]
    hooks += [m.register_forward_hook(vlad_hook) for m in net.modules() if isinstance(m, NetVLAD)]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def step_profile(step, fwd_flops: float, reps: int = 2) -> dict:
    """One train step, repeated: ms per step by CUDA events over back-to-back
    steps, its device ms under torch.profiler (profiled_device_ms), the
    device's idle share, and the step's bound: forward and backward, 3x the
    forward's FLOPs, at the H100's dense bf16 peak."""
    ms = cuda_ms(step, 5)
    prof = profiled_device_ms(step, reps)
    return {
        "step_ms": ms, **prof, "device_idle_share": 1.0 - prof["device_ms"] / ms,
        "forward_gflop": fwd_flops / 1e9, "step_gflop": 3 * fwd_flops / 1e9,
        "bound_ms": 3 * fwd_flops / BF16_OPS_PER_S * 1e3, "bound_by": "operations (bf16)",
    }


def grad_rel_err(got: dict, want: dict) -> float:
    """The largest, over gradient tensors, of |got - want| / (|want| +
    0.01 |whole gradient|), so that a bound of 1e-4 on it holds each tensor
    within 1e-4 of its norm plus 1e-6 of the whole gradient's: a tensor
    whose gradient is rounding noise (the stem GroupNorm's scale, whose
    effect the next per-channel GroupNorm normalizes away) is held at the
    whole gradient's scale."""
    floor = 0.01 * float(torch.cat([g.reshape(-1) for g in want.values()]).norm())
    return max(float((got[k].cpu() - g).norm()) / (float(g.norm()) + floor) for k, g in want.items())


def grads_card_vs_cpu(device, net, params, loss_fn, x, y, conditioned: bool = True) -> dict:
    """``value_and_grad`` of ``loss_fn(net, params, x, y)`` (a float32 net):
    on the CPU; on the CPU with ``x`` moved by 1e-7 relative, once per
    SENS_SEEDS draw (the gradient's own sensitivity to rounding); on the
    card with the caller's TF32 flags on for cuDNN and matmul, and off.
    Returns the loss's relative error on the card, grad_rel_err of the card
    against the CPU, the sensitivity (the largest over the draws, and
    each), the card with the caller's TF32 on against off (the step holds
    TF32 off over the forward and the backward, so only the card's
    nondeterministic sums differ), and the gradient's bound,
    ``grad_limit``: 1e-4 where the gradient is ``conditioned``, else twice
    the sensitivity, at least 1e-4 and at most 1e-3. The flags must come
    back as they were."""
    from cerebro_tpu_torch.train.optim import value_and_grad

    def grads(n, p, x_, y_):
        loss, g = value_and_grad(lambda q: loss_fn(n, q, x_, y_), p)
        return float(loss[0] if isinstance(loss, tuple) else loss), g

    loss_c, grads_c = grads(net, params, x, y)
    sens = []
    for seed in SENS_SEEDS:
        gen = torch.Generator().manual_seed(seed)
        xp = x.float() * (1 + 1e-7 * torch.randn(x.shape, generator=gen))
        sens.append(grad_rel_err(grads(net, params, xp, y)[1], grads_c))
    net_g = net.to(device)
    params_g = {k: v.to(device) for k, v in params.items()}
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    card = {}
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            card[tf32] = grads(net_g, params_g, x.to(device), y.to(device))
            check((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
                  == (tf32, tf32), "a train step left the caller's TF32 flags changed")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    net.to("cpu")
    loss_g, grads_g = card[True]
    return {"loss_rel_err": abs(loss_g - loss_c) / abs(loss_c),
            "grad_rel_err_max": grad_rel_err(grads_g, grads_c),
            "cpu_sensitivity_1e-7": max(sens), "cpu_sensitivity_1e-7_per_seed": sens,
            "tf32_on_vs_off": grad_rel_err(grads_g, {k: v.cpu() for k, v in card[False][1].items()}),
            "grad_limit": TRAIN_GRAD_TOL if conditioned
            else min(TRAIN_GRAD_CAP, max(TRAIN_GRAD_TOL, 2 * max(sens)))}


def train_grad_case(name: str) -> tuple:
    """One of (d)'s TRAIN_GRAD_CASES: (float32 net on the CPU, its params,
    loss_fn(net, params, x, y), x, y, whether the gradient is
    conditioned)."""
    from cerebro_tpu_torch import config as C
    from cerebro_tpu_torch import pretrain_synthetic as ps
    from cerebro_tpu_torch.models import keypoints as kp
    from cerebro_tpu_torch.models.descriptor import create_descriptor_model, load_descriptor_params
    from cerebro_tpu_torch.train.trainer import descriptor_loss

    def kp_loss(n, p, x_, y_):
        return kp.train_loss(n, p, x_, y_)[0]

    if name == "descriptor_64x64_trunk16_batch8_seeded":
        cfg = C.DescriptorConfig(image_hw=(64, 64), trunk_dim=16, num_clusters=4, dtype="float32")
        net, params = create_descriptor_model(cfg, seed=0, device="cpu")
        x, y = parity_batch()
        return net, params, descriptor_loss, torch.from_numpy(x), torch.from_numpy(y), True
    if name == "keypoints_default_batch2_seeded":
        # the full-width model (desc 128, width 32) on tests/test_torch_keypoints.py's batch
        _, params = kp.create_keypoint_model(seed=0, device="cpu")
        x, y = kp.synthetic_corner_batch(np.random.default_rng(3), 2)
        return (kp.KeypointNet(dtype=torch.float32), params, kp_loss,
                torch.from_numpy(x), torch.from_numpy(y), True)
    if name == "descriptor_240x320_trunk64_batch8_synth_npz_places":
        # the shipped synth net on 4 places x 2 views of its training world
        cfg = C.DescriptorConfig(image_hw=(ps.H, ps.W), trunk_dim=ps.TRUNK_DIM,
                                 num_clusters=ps.NUM_CLUSTERS, dtype="float32")
        net, params = load_descriptor_params(SYNTH_NPZ, cfg, device="cpu")
        tex = ps.fractal_texture(np.random.default_rng(3), n=4096)
        x, y = ps.render_places(np.random.default_rng(11), tex, 4, 2)
        return net, params, descriptor_loss, torch.from_numpy(x), torch.from_numpy(y), False
    raise ValueError(name)


def parity_batch() -> tuple:
    """tests/test_torch_train.py's batch: 8 uint8 64x64 noise images, the
    views of one place near copies, and their labels."""
    labels = np.asarray([0, 0, 1, 1, 1, 2, 2, 3], np.int32)
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 255, size=(8, 64, 64, 1)).astype(np.uint8)
    for i in range(1, 8):
        if labels[i] == labels[i - 1]:
            imgs[i] = np.clip(imgs[i - 1].astype(np.int32) + rng.integers(-8, 8, (64, 64, 1)),
                              0, 255).astype(np.uint8)
    return imgs, labels


def phase_train(device) -> tuple:
    """The training path: (a) python -m cerebro_tpu_torch.pretrain_synthetic
    at the shipped artifact's settings, its weights in CerebroPipeline on
    the photo world; (b) one step of the default 4,096-d net at a batch of
    32; (c) the keypoint model's self-supervised training, held-out corner
    hits and learned matching of a photo frame against its (8, 8) roll; (d)
    float32 train steps on the card against the CPU. Returns (line, kernel
    checks, launches) as phase_live does."""
    import os
    import tempfile

    from cerebro_tpu_torch import config as C
    from cerebro_tpu_torch import photoworld as pw
    from cerebro_tpu_torch import pretrain_synthetic
    from cerebro_tpu_torch import synthworld as sw
    from cerebro_tpu_torch.models import keypoints as kp
    from cerebro_tpu_torch.models.descriptor import create_descriptor_model
    from cerebro_tpu_torch.train import create_train_state, train_step

    out = {"phase": "train"}
    with open(f"{SYNTH_NPZ}/meta.json") as fh:
        jax_meta = json.load(fh)

    # (a) the descriptor, as the shipped artifact was trained
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        npz_dir = os.path.join(tmp, "descriptor_synth")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # stdout: one JSON object per line
            summ = pretrain_synthetic.main(["--out", npz_dir, *PRETRAIN_ARGS])
        wall = time.perf_counter() - t0
        losses = summ["losses"]
        margin = summ["same_place_sim"] - summ["cross_place_sim"]
        untrained = summ["untrained_same_place_sim"] - summ["untrained_cross_place_sim"]
        a = {
            "args": PRETRAIN_ARGS, "images": summ["images"], "wall_s": wall,
            "first_step_ms": summ["step_ms"][0],
            "step_ms_mean": float(np.mean(summ["step_ms"][1:])),
            "step_ms_min": float(np.min(summ["step_ms"][1:])),
            "loss_first": losses[0], "loss_last": losses[-1],
            "same_place_sim": summ["same_place_sim"], "cross_place_sim": summ["cross_place_sim"],
            "margin": margin, "untrained_margin": untrained,
            "jax_same_place_sim": jax_meta["same_place_sim"],
            "jax_cross_place_sim": jax_meta["cross_place_sim"],
            "jax_margin": jax_meta["same_place_sim"] - jax_meta["cross_place_sim"],
        }
        check(losses[-1] < losses[0], f"train (a): the loss did not fall ({losses[0]} -> {losses[-1]})")
        check(margin > TRAIN_MARGIN_MIN and margin > untrained + TRAIN_MARGIN_GAIN,
              f"train (a): separation margin {margin} (untrained {untrained})")
        cfg = C.DescriptorConfig(image_hw=(pretrain_synthetic.H, pretrain_synthetic.W),
                                 trunk_dim=pretrain_synthetic.TRUNK_DIM,
                                 num_clusters=pretrain_synthetic.NUM_CLUSTERS)
        net, params = create_descriptor_model(cfg, seed=0, device=device)
        state, tx = create_train_state(params, lr=pretrain_synthetic.LR)
        x, y = (torch.from_numpy(v).to(device) for v in place_batch(cfg.image_hw, 8, 4, seed=1))
        # the forward's FLOPs: the net's, and the all-pairs loss's (32 x 32 x D)
        a["profile"] = step_profile(lambda: train_step(net, tx, state, x, y),
                                    forward_flops(net, x) + 2.0 * 32 * 32 * net.descriptor_dim)
        # the written weights in the pipeline: the netvlad (c) stream, shortened
        run, pipe = trained_photo_run(device, npz_dir, TRAIN_FRAMES, TRAIN_LAPS)
    check_netvlad_run(run, "train: the trained net's run")
    a["run"] = run
    out["descriptor"] = a
    launches = {"K1": run["k1_launches"], "K3": run["k3_launches"]}
    q, qp, lim = db_queries(pipe, pipe.cfg.runtime.descriptor_batch, seed=256)
    checks = {"K1": k1_measure(qp, pipe.db.vectors, q, pipe.db.vectors[:, : pipe.db.dim], lim,
                               pipe.db.global_ids)}
    cands = list(pipe.loop_edges) + list(pipe.rejected_candidates)
    check(cands, "train: the trained net's run verified no pair")
    pairs = [pipe._load_pair(c)[1:] for c in cands[:8]]
    L = torch.from_numpy(np.stack([p[j] for p in pairs for j in (2, 0)])).to(device)
    R = torch.from_numpy(np.stack([p[j] for p in pairs for j in (3, 1)])).to(device)
    checks["K3"] = {"B": L.shape[0], **k3_measure(L, R)}
    pipe.close()
    # the shipped synth net (JAX-trained, artifacts/descriptor_synth_npz) on
    # the same frames: what the same run makes of JAX's weights
    shipped, spipe = trained_photo_run(device, SYNTH_NPZ, TRAIN_FRAMES, TRAIN_LAPS)
    spipe.close()
    check_netvlad_run(shipped, "train: the shipped net's run on the same frames")
    a["shipped_run"] = shipped

    # (b) the default net at full width: one step at a batch of 32
    cfg = C.CerebroConfig().descriptor
    net, params = create_descriptor_model(cfg, seed=0, device=device)
    state, tx = create_train_state(params, lr=pretrain_synthetic.LR)
    x, y = (torch.from_numpy(v).to(device) for v in place_batch(cfg.image_hw, 8, 4, seed=2))
    out["full_width"] = {
        "config": "CerebroConfig().descriptor", "descriptor_dim": net.descriptor_dim, "batch": 32,
        **step_profile(lambda: train_step(net, tx, state, x, y),
                       forward_flops(net, x) + 2.0 * 32 * 32 * net.descriptor_dim),
    }

    # (c) the keypoint model at its defaults, self-supervised
    knet, kparams = kp.create_keypoint_model(device=device)
    opt = kp.make_optimizer_state(kparams)
    rng = np.random.default_rng(0)
    klosses, marks = [], []
    for _ in range(KP_STEPS):
        imgs, labels = kp.synthetic_corner_batch(rng, KP_BATCH)
        xi, yi = torch.from_numpy(imgs).to(device), torch.from_numpy(labels).to(device)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        kparams, opt, loss, _, _ = kp.train_step(knet, kparams, opt, xi, yi)
        klosses.append(loss)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    kms = [a_.elapsed_time(b_) for a_, b_ in zip(marks, marks[1:])]
    klosses = [float(v) for v in klosses]
    c = {"desc_dim": knet.desc_dim, "width": knet.width, "dtype": str(knet.dtype), "batch": KP_BATCH,
         "steps": KP_STEPS, "first_step_ms": kms[0], "step_ms_mean": float(np.mean(kms[1:])),
         "loss_first": klosses[0], "loss_last": klosses[-1],
         "loss_last_over_first": klosses[-1] / klosses[0]}
    check(klosses[-1] < KP_LOSS_RATIO * klosses[0],
          f"train (c): keypoint loss {klosses[0]} -> {klosses[-1]}")
    # two views through the net, and InfoNCE's (64 cells)^2 x D products per image
    c["profile"] = step_profile(lambda: kp.train_step(knet, kparams, opt, xi, yi),
                                2 * forward_flops(knet, xi * 2.0 - 1.0)
                                + 2.0 * KP_BATCH * 64 * 64 * knet.desc_dim)
    # held-out corners (tests/test_keypoints.py's check)
    hrng = np.random.default_rng(123)
    hits = total = 0
    for _ in range(6):
        imgs, labels = kp.synthetic_corner_batch(hrng, 1)
        gt_cells = np.argwhere(labels[0] != 64)
        if len(gt_cells) == 0:
            continue
        kps, _ = kp.detect_keypoints(knet, kparams, torch.from_numpy(imgs[0, :, :, 0]).to(device),
                                     max_kp=32, border=2, min_prob=0.01)
        xy = kps.xy[kps.valid].cpu().numpy()
        for cy, cx in gt_cells:
            lab = labels[0, cy, cx]
            total += 1
            hits += int(bool(len(xy)) and np.min(np.linalg.norm(
                xy - [cx * 8 + lab % 8, cy * 8 + lab // 8], axis=-1)) <= 3.0)
    c.update({"heldout_corners": total, "heldout_hits": hits, "heldout_hit_rate": hits / max(total, 1)})
    check(total >= 5 and hits / total >= KP_HITS_MIN, f"train (c): held-out hits {hits}/{total}")
    # learned matching: a photo-world frame against its (8, 8) roll
    ren = sw.Renderer(pw.PhotoWorld.create(seed=0))
    pseq = pw.make_photo_sequence(n_frames=PHOTO_FRAMES, laps=PHOTO_LAPS)
    frame = torch.from_numpy(ren.render(*map(float, pseq.xy[0])).astype(np.float32) / 255.0).to(device)
    rolled = torch.roll(frame, (8, 8), dims=(0, 1))
    m = kp.match_image_pair_learned(knet, kparams, frame, rolled, max_kp=512)
    d = (m.xy_b - m.xy_a)[m.valid]
    inl = (d - torch.tensor([8.0, 8.0], device=device)).norm(dim=-1) <= 1.0
    n_valid = int(m.valid.sum())
    c.update({"match_image_hw": list(frame.shape), "match_valid": n_valid,
              "match_shift_inliers": int(inl.sum()),
              "match_shift_inlier_share": float(inl.float().mean()) if n_valid else 0.0,
              "detect_ms_per_frame": cuda_ms(lambda: kp.detect_keypoints(knet, kparams, frame), 10)})
    check(n_valid >= 4 and c["match_shift_inlier_share"] >= KP_SHIFT_INLIERS,
          f"train (c): {int(inl.sum())} of {n_valid} matches on the (8, 8) shift")
    out["keypoints"] = c

    # (d) float32 gradients on the card against the CPU (check_train holds
    # them)
    d = {}
    for name in TRAIN_GRAD_CASES:
        net, params, loss_fn, x, y, conditioned = train_grad_case(name)
        d[name] = grads_card_vs_cpu(device, net, params, loss_fn, x, y, conditioned)
    out["f32_card_vs_cpu"] = d
    out["kernel_checks"] = checks
    return out, checks, launches


def train_grads_hold(r: dict) -> bool:
    """A grads_card_vs_cpu result against (d)'s bounds: the loss on the card
    within 1e-4 relative of the CPU's; each gradient tensor within its
    ``grad_limit`` (grad_rel_err); the caller's TF32 flag changing nothing
    beyond 1e-5 (a leak would show at ~1e-3)."""
    return (r["loss_rel_err"] <= TRAIN_GRAD_TOL and r["grad_rel_err_max"] <= r["grad_limit"]
            and r["tf32_on_vs_off"] <= TRAIN_TF32_TOL)


def check_train(out: dict):
    """(d): every case within train_grads_hold's bounds."""
    for what, r in out["f32_card_vs_cpu"].items():
        check(train_grads_hold(r), f"train (d): {what} f32 gradient on the card against the CPU: {r}")


def train_kernel_entries(checks: dict, launches: dict) -> list:
    """The kernels line of ``--phase train``: K1 on the trained net's DB
    (D = 256, its own batch) and K3 on its verified pairs, with the run's
    launches."""
    entries = [
        {**kernel_entry("k1_train_d256", "cerebro_tpu_torch/csrc/score_topk.cu",
                        "cerebro_tpu/ops/similarity.py:98", launches["K1"],
                        checks["K1"]["max_abs_err"], checks["K1"]), "Q": checks["K1"]["Q"]},
        k3_entry(checks["K3"], launches["K3"]),
    ]
    check(all(e["launches"] > 0 for e in entries), "a kernel of the train run never launched")
    return entries


# ---------------------------------------------------------------------------
# synthetic, mesh and calib: run_synthetic, the mesh (parallel/,
# posegraph/distributed.py, mesh= in the pipeline and the train step) and
# the calibration tools
# ---------------------------------------------------------------------------

# the JAX script's own run (scripts/run_synthetic.py --cpu at its 14
# frames, on an 8-core Intel Xeon), printed beside the card's
SYNTH_JAX_CPU = {"verified_edges": 4, "session2_merged_ate_m": 0.0016}
MESH_FRAMES, MESH_LAPS = 200, 2.0  # the pipeline stream, 200 frames over its 2 laps
MESH_BLOCKS = 4  # the row blocks of the one-process n-shard merge
MESH_SEARCH = (8, 29184, 8192)  # Q x N x D of the sharded searches (the k1 phase's main shape)
CALIB_REL = 0.02  # tests/test_calibration.py's 2% of ground truth
CALIB_PX, CALIB_FOCAL_REL = 0.01, 5e-5  # card against CPU (tests/test_torch_calibration.py)


def phase_synthetic(device) -> tuple:
    """python -m cerebro_tpu_torch.run_synthetic at its defaults on the
    card: it must print OK; K1 once per detect batch, no K2, K3 launched;
    then K1 against its plain version at the run's width (D = 256) over a
    DB of the run's 1,024 rows."""
    import tempfile

    from cerebro_tpu_torch import run_synthetic
    from cerebro_tpu_torch.ops.similarity import K1, K2
    from cerebro_tpu_torch.ops.stereo_kernel import K3

    K1.launches = K2.launches = K3.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_synthetic_") as tmp:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # its report: stdout keeps one JSON object a line
            r = run_synthetic.main(["--out", tmp])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        debug = sorted(os.listdir(os.path.join(tmp, "debug")))
    launches = {"K1": K1.launches, "K2": K2.launches, "K3": K3.launches}
    st = r["status"]
    out = {
        "phase": "synthetic", "seconds": secs, "ok": r["ok"],
        "verified_edges": r["verified_edges"], "session2_merged_ate_m": r["session2_merged_ate_m"],
        "jax_script_cpu": SYNTH_JAX_CPU,
        "keyframes": st["keyframes"], "described": st["described"], "loop_edges": st["loop_edges"],
        "rejected_candidates": st["rejected_candidates"], "worlds": st["kidnap"]["world_id"] + 1,
        "detect_batches": st["timings_ms"]["detect"]["count"],
        "k1_launches": launches["K1"], "k2_launches": launches["K2"], "k3_launches": launches["K3"],
        "debug_files": len(debug),
    }
    check(r["ok"], "run_synthetic printed DEGRADED")
    check(launches["K1"] == out["detect_batches"],
          f"run_synthetic: K1 launched {launches['K1']} times for {out['detect_batches']} detect batches")
    check(launches["K2"] == 0 and launches["K3"] >= 1, f"run_synthetic: launches {launches}")
    q, db, lim, gids, _, _ = k1_case(8, 1024, 256, device, seed=11)
    out["k1_check"] = k1_measure(q, db, q, db, lim, gids)
    return out, launches


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _block_merge_checks(q, db, lim, gids, dbq, dbs) -> dict:
    """K1, K2 (k = 1, 3, 5) and the int8 search on MESH_BLOCKS row blocks
    of one DB, merged by the mesh's merge functions, against the unsharded
    calls: gids exact, scores equal."""
    from cerebro_tpu_torch import parallel as par
    from cerebro_tpu_torch.ops import similarity as sim

    rows = db.shape[0] // MESH_BLOCKS
    blocks = [slice(i * rows, (i + 1) * rows) for i in range(MESH_BLOCKS)]
    out = {"blocks": MESH_BLOCKS, "rows_per_block": rows}

    def stack(parts):
        return [torch.stack(x) for x in zip(*parts)]

    m, a = par.merge_argmax(*stack([sim.max_and_argmax_cuda(q, db[b], lim, gids[b]) for b in blocks]))
    pm, pa = sim.max_and_argmax_cuda(q, db, lim, gids)
    check(torch.equal(a, pa) and torch.equal(m, pm), "K1 on 4 blocks, merged, differs from one call")
    for k in (1, 3, 5):
        v, g = par.merge_topk(*stack([sim.search_topk_cuda(q, db[b], lim, gids[b], k=k) for b in blocks]), k)
        pv, pg = sim.search_topk_cuda(q, db, lim, gids, k=k)
        check(torch.equal(g, pg) and torch.equal(v, pv), f"K2 top-{k} on 4 blocks, merged, differs")
    m, a = par.merge_argmax(*stack([sim.max_and_argmax_int8_cuda(q, dbq[b], dbs[b], lim, gids[b])
                                    for b in blocks]))
    pm, pa = sim.max_and_argmax_int8_cuda(q, dbq, dbs, lim, gids)
    check(torch.equal(a, pa) and torch.equal(m, pm), "int8 on 4 blocks, merged, differs")
    out["k1_k2_int8_gids_exact"] = True
    return out


def _mesh_pipeline_runs(device, world, mesh) -> dict:
    """The pipeline phase's settings on its stream at MESH_FRAMES frames
    over MESH_LAPS laps, without a mesh and with one: the same candidates
    and edges (pairs and poses), and the mesh run's launches."""
    from cerebro_tpu_torch import config as C
    from cerebro_tpu_torch.ops.similarity import K1, K2
    from cerebro_tpu_torch.ops.stereo_kernel import K3
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

    cfg = C.CerebroConfig(descriptor=C.DescriptorConfig(kind="ported"),
                          verify=C.VerifyConfig(cascade=False, min_matches_accept=200))
    survey = synth_survey(world, MESH_FRAMES, MESH_LAPS)
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        pipe = CerebroPipeline(cfg, rig=survey[1].rig(), mesh=m, device=device)
        K1.launches = K2.launches = K3.launches = 0
        t0 = time.perf_counter()
        feed_frames(pipe, *survey)
        cands = sorted((c.idx_curr, c.idx_prev) for c in pipe.candidates)
        accepted = pipe.verify_pending(cascade=False)
        torch.cuda.synchronize()
        runs[name] = {
            "seconds": time.perf_counter() - t0, "candidates": cands, "edges_accepted": accepted,
            "edges": sorted((e.idx_curr, e.idx_prev, e.T_prev_curr.tobytes()) for e in pipe.loop_edges),
            "detect_batches": pipe.timer.stats()["detect"]["count"],
            "launches": {"K1": K1.launches, "K2": K2.launches, "K3": K3.launches},
            "db_local_rows": pipe.db.local_rows,
        }
        pipe.close()
    plain, sharded = runs["plain"], runs["mesh"]
    check(sharded["candidates"] == plain["candidates"] and len(plain["candidates"]) >= 1,
          "the mesh pipeline's candidates differ from the plain run's")
    check(sharded["edges"] == plain["edges"] and plain["edges_accepted"] >= 1,
          "the mesh pipeline's edges differ from the plain run's")
    check(sharded["launches"]["K1"] == sharded["detect_batches"] and sharded["launches"]["K3"] > 0,
          f"the mesh pipeline's launches {sharded['launches']}")
    return {
        "frames": MESH_FRAMES, "laps": MESH_LAPS, "candidates": len(plain["candidates"]),
        "edges_accepted": plain["edges_accepted"], "same_candidates_and_edges": True,
        "plain_s": plain["seconds"], "mesh_s": sharded["seconds"],
        "detect_batches": sharded["detect_batches"], "mesh_launches": sharded["launches"],
        "mesh_db_local_rows": sharded["db_local_rows"],
    }


def _timed_s(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def phase_mesh(device, world, topk_pipe) -> tuple:
    """The mesh at world size 1 (NCCL over a localhost TCP store; one card
    takes one rank): the sharded K1 / K2 / int8 searches at Q = 8 x N =
    29,184 x D = 8,192 against the unsharded calls, and the same DB's
    4-block merge; the pipeline with and without mesh=; optimize_sharded
    against optimize on pipeline_topk's graph; the data-parallel train step
    at a batch of 32 against the plain step."""
    import torch.distributed as dist

    from cerebro_tpu_torch import config as C
    from cerebro_tpu_torch import parallel as par
    from cerebro_tpu_torch.models.descriptor import create_descriptor_model
    from cerebro_tpu_torch.ops import similarity as sim
    from cerebro_tpu_torch.parallel.multihost import host_info, init_multihost
    from cerebro_tpu_torch.posegraph import optimize, optimize_sharded, pad_graph
    from cerebro_tpu_torch.train import create_train_state, train_step

    init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, device=device.type)
    try:
        mesh = par.make_mesh()
        out = {"phase": "mesh", "backend": dist.get_backend(), "host_info": host_info(),
               "mesh_shape": mesh.shape}
        # (a) the sharded searches at world size 1 against the unsharded calls
        Q, N, D = MESH_SEARCH
        q, db, lim, gids, expect, _ = k1_case(Q, N, D, device, seed=21)
        mx, ar = par.sharded_max_and_argmax(q, db, lim, gids, mesh)
        pm, pa = sim.max_and_argmax_cuda(q, db, lim, gids)
        check(torch.equal(ar, pa) and torch.equal(mx, pm) and torch.equal(ar.cpu(), expect),
              "sharded_max_and_argmax differs from K1")
        search = {"Q": Q, "N": N, "D": D,
                  "k1_mesh_ms": cuda_ms(lambda: par.sharded_max_and_argmax(q, db, lim, gids, mesh), 20),
                  "k1_plain_call_ms": cuda_ms(lambda: sim.max_and_argmax_cuda(q, db, lim, gids), 20)}
        for k in (1, 3, 5):
            v, g = par.sharded_topk(q, db, lim, gids, mesh, k=k)
            pv, pg = sim.search_topk_cuda(q, db, lim, gids, k=k)
            check(torch.equal(g, pg) and torch.equal(v, pv), f"sharded_topk k={k} differs from K2")
        search["k2_top3_mesh_ms"] = cuda_ms(lambda: par.sharded_topk(q, db, lim, gids, mesh, k=3), 20)
        search["k2_top3_plain_call_ms"] = cuda_ms(lambda: sim.search_topk_cuda(q, db, lim, gids, k=3), 20)
        dbq, dbs = sim.quantize_rows(db.float())
        im, ia = par.sharded_max_and_argmax_int8(q, dbq, dbs, lim, gids, mesh)
        pm, pa = sim.max_and_argmax_int8_cuda(q, dbq, dbs, lim, gids)
        check(torch.equal(ia, pa) and torch.equal(im, pm), "sharded int8 differs from the int8 call")
        search["int8_mesh_ms"] = cuda_ms(
            lambda: par.sharded_max_and_argmax_int8(q, dbq, dbs, lim, gids, mesh), 20)
        search["int8_plain_call_ms"] = cuda_ms(lambda: sim.max_and_argmax_int8_cuda(q, dbq, dbs, lim, gids), 20)
        search["world_size_1_gids_exact"] = True
        out["search"] = search
        # (b) the n-shard merge in one process
        out["block_merge"] = _block_merge_checks(q, db, lim, gids, dbq, dbs)
        del q, db, dbq, dbs
        torch.cuda.empty_cache()
        # (c) the pipeline with mesh= against without
        out["pipeline"] = _mesh_pipeline_runs(device, world, mesh)
        # (d) optimize_sharded against optimize on pipeline_topk's graph
        graph, n_nodes = topk_pipe.pose_graph()
        pcfg = topk_pipe.cfg.posegraph
        (x1, s1, c1), t_plain = _timed_s(lambda: optimize(graph, pcfg))
        (x2, s2, c2), t_mesh = _timed_s(lambda: optimize_sharded(pad_graph(graph, 1), pcfg, mesh))
        check(torch.equal(x1, x2) and torch.equal(s1, s2) and torch.equal(c1, c2),
              "optimize_sharded at one rank differs from optimize")
        out["posegraph"] = {"nodes": n_nodes, "padded_nodes": int(graph.xyzyaw.shape[0]),
                            "loop_edges": int(graph.loop_valid.sum()), "optimize_s": t_plain,
                            "optimize_sharded_s": t_mesh, "bit_equal": True}
        # (e) the data-parallel train step at a batch of 32
        dcfg = C.CerebroConfig().descriptor
        net, params = create_descriptor_model(dcfg, seed=0, device=device)
        state, tx = create_train_state(params, lr=5e-4)
        x, y = (torch.from_numpy(v).to(device) for v in place_batch(dcfg.image_hw, 8, 4, seed=2))
        (plain, l_plain), t_plain = _timed_s(lambda: train_step(net, tx, state, x, y))
        (dp, l_dp), t_dp = _timed_s(lambda: train_step(net, tx, state, x, y, mesh=mesh))
        # mu = 0.1 x the gradient
        err = grad_rel_err(dp.opt_state.mu, {k: v.cpu() for k, v in plain.opt_state.mu.items()})
        loss_err = abs(float(l_dp) - float(l_plain)) / abs(float(l_plain))
        check(loss_err <= TRAIN_GRAD_TOL and err <= TRAIN_GRAD_TOL,
              f"the data-parallel step differs from the plain step: loss {loss_err}, gradient {err}")
        out["train"] = {"batch": 32, "descriptor_dim": net.descriptor_dim, "loss": float(l_plain),
                        "loss_rel_err": loss_err, "grad_rel_err": err,
                        "plain_step_s": t_plain, "mesh_step_s": t_dp,
                        "plain_step_ms": cuda_ms(lambda: train_step(net, tx, state, x, y), 3, 1),
                        "mesh_step_ms": cuda_ms(lambda: train_step(net, tx, state, x, y, mesh=mesh), 3, 1)}
    finally:
        dist.destroy_process_group()
    launches = out["pipeline"]["mesh_launches"]
    return out, launches


def _checker(xb, yb, square: float, soft: float, rows: int, cols: int):
    """tests/test_chessboard.py's antialiased board colour at board
    coordinates; inner corner (i, j) at ((j + 1) sq, (i + 1) sq)."""
    def softsq(t):
        return 0.5 * (1.0 + np.tanh(np.sin(np.pi * t) / soft))

    cx, cy = softsq(xb / square), softsq(yb / square)
    col = cx * cy + (1 - cx) * (1 - cy)
    inside = (xb > 0) & (xb < (cols + 1) * square) & (yb > 0) & (yb < (rows + 1) * square)
    return np.where(inside, col, 0.5)


def _render_homography(Hm, rows: int, cols: int, hw=(240, 320)):
    H, W = hw
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    p = np.stack([u, v, np.ones_like(u)], axis=-1) @ np.linalg.inv(Hm).T
    scale = np.abs(Hm[0, 0]) + np.abs(Hm[1, 1])
    img = _checker(p[..., 0] / p[..., 2], p[..., 1] / p[..., 2], 1.0, 2.0 / max(scale, 1e-6), rows, cols)
    return img.astype(np.float32)


def _render_camera_view(cam, c_T_board, rows: int, cols: int, square: float, hw=(240, 320)):
    """The board through a (distorted) camera: each pixel's ray, lifted on
    the CPU, meets the board plane."""
    from cerebro_tpu_torch.geometry import cameras

    H, W = hw
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    rays = cameras.lift(cam, torch.from_numpy(np.stack([u, v], -1).reshape(-1, 2))).numpy()
    Rt, t = c_T_board[:3, :3].T, c_T_board[:3, 3]
    denom = rays @ Rt[2]
    denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    s = (Rt[2] @ t) / denom
    Xb = (s[:, None] * rays - t) @ Rt.T
    img = np.where(s <= 0, 0.5, _checker(Xb[:, 0], Xb[:, 1], square, 0.06, rows, cols))
    return img.reshape(H, W).astype(np.float32)


def _calib_views(cam, board, rng, n_views: int, angle_deg: float, z):
    """tests/test_calibration.py's views: random poses, projected on the
    CPU, 0.1 px of noise."""
    from cerebro_tpu_torch.geometry import cameras, se3

    board3 = np.concatenate([board, np.zeros((len(board), 1), np.float32)], -1)
    obs = []
    for _ in range(n_views):
        ypr = np.deg2rad(rng.uniform(-angle_deg, angle_deg, 3)).astype(np.float32)
        R = se3.ypr_to_rot(torch.from_numpy(ypr)).numpy()
        t = np.array([rng.uniform(-0.1, 0.1) - 0.3, rng.uniform(-0.1, 0.1) - 0.2, rng.uniform(*z)],
                     np.float32)
        uv = cameras.project(cam, torch.from_numpy(board3 @ R.T + t)).numpy()
        obs.append((uv + rng.normal(0, 0.1, uv.shape)).astype(np.float32))
    return np.stack(obs)


def _same_grid(got, want) -> str:
    """'same' or 'reversed': the two orientations of a half-turn-symmetric
    grid whose fits tie (tests/test_torch_calibration.py's _same_grid)."""
    if np.allclose(got, want, atol=1e-3, rtol=0):
        return "same"
    check(np.allclose(got, want[::-1], atol=1e-3, rtol=0), "the card's corner grid differs from the CPU's")
    return "reversed"


def phase_calib(device) -> dict:
    """calibrate_planar for the four camera models on synthetic boards,
    and detect_chessboard on rendered boards, on the card against the CPU;
    then calibration from the card's detected corners. Checks: intrinsics
    within 2% of ground truth, the card within CALIB_PX / CALIB_FOCAL_REL of
    the CPU, RMS < 0.5 px, the same corners in the same order."""
    from cerebro_tpu_torch.geometry import calibration as cal
    from cerebro_tpu_torch.geometry import cameras, chessboard as cb, se3

    out = {"phase": "calib", "models": {}, "boards": {}}
    board = np.stack(np.mgrid[0:6, 0:8][::-1], -1).reshape(-1, 2).astype(np.float32) * 0.08
    models = {
        cameras.PINHOLE: (cameras.make_pinhole(460.0, 455.0, 370.0, 245.0, (-0.25, 0.06, 0.0, 0.0)),
                          25, (0.6, 1.2), 460.0),
        cameras.KANNALA_BRANDT: (cameras.make_kannala_brandt(380.0, 375.0, 370.0, 245.0,
                                                             (-0.01, 0.02, -0.008, 0.001)), 30, (0.35, 0.7), 380.0),
        cameras.MEI: (cameras.make_mei(720.0, 710.0, 370.0, 245.0, xi=0.9, dist=(-0.1, 0.02, 0.0, 0.0)),
                      30, (0.35, 0.7), 720.0 / 1.9),
        cameras.SCARAMUZZA: (cameras.make_scaramuzza(1.0, 370.0, 245.0, poly=(420.0, -6e-4, 1e-7, 0.0)),
                             30, (0.35, 0.7), 420.0),
    }

    def focal(model, cam):  # what the views pin down: the paraxial focal
        if model == cameras.MEI:
            return float(cam.fx) / (1.0 + float(cam.xi))
        return float(cam.dist[0]) if model == cameras.SCARAMUZZA else float(cam.fx)

    for model, (gt, angle, z, f_gt) in models.items():
        obs = _calib_views(gt, board, np.random.default_rng(0), 10, angle, z)
        r_cpu, t_cpu = _timed_s(lambda: cal.calibrate_planar(board, obs, model=model, device="cpu"))
        r_gpu, t_gpu = _timed_s(lambda: cal.calibrate_planar(board, obs, model=model, device=str(device)))
        f_c, f_g = focal(model, r_cpu.camera), focal(model, r_gpu.camera)
        rec = {"focal": f_g, "focal_cpu": f_c, "focal_truth": f_gt, "rms_px": float(r_gpu.rms_px),
               "rms_px_cpu": float(r_cpu.rms_px), "cx": float(r_gpu.camera.cx), "cy": float(r_gpu.camera.cy),
               "success": r_gpu.success, "card_s": t_gpu, "cpu_s": t_cpu}
        check(r_gpu.success and r_cpu.success and rec["rms_px"] < 0.5, f"calib {model}: {rec}")
        check(abs(f_g - f_gt) / f_gt < CALIB_REL, f"calib {model}: focal {f_g} against {f_gt}")
        check(abs(f_g - f_c) <= CALIB_FOCAL_REL * abs(f_c)
              and abs(rec["cx"] - float(r_cpu.camera.cx)) < CALIB_PX
              and abs(rec["cy"] - float(r_cpu.camera.cy)) < CALIB_PX,
              f"calib {model}: the card's intrinsics differ from the CPU's: {rec}")
        out["models"][model] = rec

    rows, cols = 5, 7
    rng = np.random.default_rng(3)
    boards = {"axis_aligned": np.array([[28.0, 0, 30.0], [0, 28.0, 25.0], [0, 0, 1.0]])}
    for t in range(3):
        th = rng.uniform(-0.3, 0.3)
        Hm = np.eye(3)
        Hm[:2, :2] = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]) * 26.0
        Hm[:2, 2] = [60.0 + 10 * t, 50.0]
        Hm[2, :2] = rng.uniform(-6e-4, 6e-4, size=2)
        boards[f"perspective{t}"] = Hm
    for name, Hm in boards.items():
        img = _render_homography(Hm, rows, cols)
        (c_g, f_g), t_gpu = _timed_s(lambda: cb.detect_chessboard(img, (rows, cols), device=str(device)))
        c_c, f_c = cb.detect_chessboard(img, (rows, cols), device="cpu")
        check(f_g and f_c, f"detect_chessboard {name}: found {f_g} on the card, {f_c} on the CPU")
        out["boards"][name] = {"order": _same_grid(c_g, c_c), "card_s": t_gpu}

    # calibration from the card's detections of a distorted camera's views
    gt = cameras.make_pinhole(300.0, 310.0, 160.0, 120.0, (-0.12, 0.05, 0.0, 0.0), width=320, height=240)
    sq = 0.04
    obs = []
    for rx, ry, rz in [(0.0, 0.0, 0.0), (0.35, 0.1, 0.2), (-0.3, 0.25, -0.15), (0.1, -0.35, 0.3),
                       (-0.2, -0.2, -0.3)]:
        R = se3.so3_exp(torch.tensor([rx, ry, rz], dtype=torch.float32)).numpy()
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = -R @ np.array([(cols + 1) * sq / 2, (rows + 1) * sq / 2, 0.0], np.float32) + [0, 0, 0.55]
        corners, found = cb.detect_chessboard(_render_camera_view(gt, T, rows, cols, sq), (rows, cols),
                                              device=str(device))
        check(found, "detect_chessboard missed a rendered camera view")
        obs.append(corners)
    res = cal.calibrate_planar(cb.board_points((rows, cols), sq), np.stack(obs), image_size=(320, 240),
                               iters=30, device=str(device))
    out["from_images"] = {"fx": float(res.camera.fx), "fy": float(res.camera.fy), "rms_px": float(res.rms_px),
                          "success": res.success}
    check(res.success and float(res.rms_px) < 0.5 and abs(float(res.camera.fx) - 300.0) / 300.0 < CALIB_REL
          and abs(float(res.camera.fy) - 310.0) / 310.0 < CALIB_REL, f"calib from images: {out['from_images']}")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--phase", default="all",
                    help="all: every phase (default); k3: build and check K3 alone; "
                         "photo: pipeline_photo at 1,000 frames over 3.5 laps; "
                         "euroc: the EuRoC entry point's phase and its kernels line; "
                         "live: the live node's phase alone on a 60 s stream, and its kernels line; "
                         "netvlad: the netvlad and int8 phases and K1 at their widths; "
                         "train: the training path's phase and its kernels line; "
                         "synthetic, mesh, calib (one or more, comma-separated): those phases, "
                         "the k1 / k2 / k3 checks and a kernels line of K1 and K3")
    args = ap.parse_args(argv)
    last = args.phase.split(",")
    if args.phase not in ("all", "k3", "photo", "euroc", "live", "netvlad", "train") and not (
            set(last) <= set(LAST_PHASES)):
        ap.error(f"unknown --phase {args.phase!r}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1

    from cerebro_tpu_torch import synthworld as sw
    from cerebro_tpu_torch.ops import small_eig
    from cerebro_tpu_torch.ops._cuda import build_all
    from cerebro_tpu_torch.ops.similarity import K1, K2
    from cerebro_tpu_torch.ops.stereo_kernel import K3

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    smi = nvidia_smi()
    kernels = [K3] if args.phase == "k3" else [K1, K2, K3, *small_eig.KERNELS]
    build_s = build_all(kernels)
    for k in {k.source: k for k in kernels}.values():  # handles may share a source
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

    if args.phase == "photo":
        emit(phase_k2(device, photo_N=photo_config(PHOTO_FULL_FRAMES).loop.db_capacity))
        photo, photo_engine = phase_pipeline_photo(device, PHOTO_FULL_FRAMES, PHOTO_FULL_LAPS)
        emit(photo)
        check_photo(photo)
        photo_engine.close()
        return finish(smi)

    if args.phase == "euroc":
        euroc, checks, launches = phase_euroc(device)
        emit(euroc)
        emit({"kernels": euroc_kernel_entries(checks, launches)})
        return finish(smi)

    if args.phase == "live":
        live, checks, launches = phase_live(device, LIVE_PHASE_S)
        emit(live)
        check_live(live, launches)
        emit({"kernels": live_kernel_entries(checks, launches)})
        return finish(smi)

    if args.phase == "train":
        train, checks, launches = phase_train(device)
        emit(train)
        check_train(train)
        emit({"kernels": train_kernel_entries(checks, launches)})
        return finish(smi)

    world = sw.CircuitWorld.create(seed=0)
    if set(last) <= set(LAST_PHASES):
        return run_last_phases(device, world, [p for p in LAST_PHASES if p in last], smi)

    if args.phase == "netvlad":
        netvlad, runs = phase_netvlad(device, world)
        emit(netvlad)
        emit(phase_int8(device, world))
        emit({"kernels": netvlad_kernel_entries(runs)})
        return finish(smi)

    if args.phase == "k3":
        k3 = phase_k3(device, world)
        emit(k3)
        emit({"kernels": [k3_entry(k3, k3["depth_pipeline_launches"])]})
        return finish(smi)

    k1 = phase_k1(device)
    emit(k1)
    k2 = phase_k2(device, photo_N=photo_config(PHOTO_FRAMES).loop.db_capacity)
    emit(k2)
    k3 = phase_k3(device, world)
    emit(k3)
    eig = phase_small_eig(device)
    emit(eig)

    # Main-path runs. Launches made above to compare and time the kernels
    # do not count: every count is set to 0 just before a run.
    K1.launches = K2.launches = K3.launches = 0
    run, engine, cands, survey = phase_pipeline(device, world, FRAMES, LAPS)
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
    check_unit_descriptors(run, "pipeline")
    emit(phase_int8(device, world, float_run=(survey, cands, engine.score_history)))

    topk, topk_engine, _, seq = phase_pipeline_topk(device, world, TOPK_FRAMES, LAPS)
    emit(topk)
    k = topk["candidates_per_query"]
    check(topk["k2_launches"] == topk["detect_batches"],
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
    check(topk["second_solve_bit_equal"], "two solves of one pose graph differ")

    methods = phase_methods(device, topk_engine, seq, TOPK_FRAMES)
    emit(methods)
    for m in ("B", "C", "D"):
        r = methods[m]
        check(r["k2_launches"] == r["detect_batches"],
              f"method {m}: K2 launched {r['k2_launches']} times for {r['detect_batches']} batches")

    photo, photo_engine = phase_pipeline_photo(device, PHOTO_FRAMES, PHOTO_LAPS)
    emit(photo)
    check_photo(photo)

    emit(phase_profile(engine, cands, topk_engine))
    engine.close()
    photo_engine.close()

    synthetic, synth_launches = phase_synthetic(device)
    emit(synthetic)
    mesh, mesh_launches = phase_mesh(device, world, topk_engine)
    emit(mesh)
    topk_engine.close()
    emit(phase_calib(device))

    euroc, euroc_checks, euroc_launches = phase_euroc(device)
    emit(euroc)

    live, live_checks, live_launches = phase_live(device, LIVE_S)
    emit(live)
    check_live(live, live_launches)
    depth = phase_depth(device, DEPTH_FRAMES, DEPTH_LAPS)
    emit(depth)
    check_depth(depth)
    netvlad, netvlad_runs = phase_netvlad(device, world)
    emit(netvlad)
    train, train_checks, train_launches = phase_train(device)
    emit(train)
    check_train(train)

    main_k1 = k1["shapes"][0]
    main_k2 = next(x for x in k2["shapes"] if x["Q"] == 8 and x["N"] == k2["N"] and x["k"] == k)
    k2_entry = kernel_entry("K2 score_topk (banned argmax; top-k call)",
                            "cerebro_tpu_torch/csrc/score_topk.cu",
                            "cerebro_tpu/ops/similarity.py:286",
                            topk["k2_launches"] + photo["k2_launches"] + euroc_launches["K2"]
                            + depth["k2_launches"],
                            max(x["max_abs_err"] for x in k2["shapes"]), main_k2)
    # the main path's K2 launch is a top-3 search_topk call
    k2_entry.update({key: main_k2[key] for key in (
        "k", "call_ms", "call_plain_ms", "call_library_ms", "call_bound_ms")})
    k3_main = k3_entry(k3, run["k3_launches"] + topk["k3_launches"] + photo["k3_launches"]
                       + euroc_launches["K3"] + live_launches["K3"] + depth["k3_launches"]
                       + netvlad["default_config"]["k3_launches"]
                       + netvlad["trained_synth_photo"]["k3_launches"] + train_launches["K3"]
                       + synth_launches["K3"] + mesh_launches["K3"])
    k3_main["max_abs_err"] = max(k3_main["max_abs_err"], euroc_checks["K3"]["max_abs_err"],
                                 live_checks["K3"]["max_abs_err"], train_checks["K3"]["max_abs_err"])
    kernels = [
        kernel_entry("K1 score_topk (K=1)", "cerebro_tpu_torch/csrc/score_topk.cu",
                     "cerebro_tpu/ops/similarity.py:98",
                     run["k1_launches"] + euroc_launches["K1"] + live_launches["K1"]
                     + synth_launches["K1"] + mesh_launches["K1"],
                     max([x["max_abs_err"] for x in k1["shapes"]]
                         + [euroc_checks["K1"]["max_abs_err"], live_checks["K1"]["max_abs_err"],
                            synthetic["k1_check"]["max_abs_err"]]),
                     main_k1),
        k2_euroc_entry(k2_entry, euroc_checks),
        k3_main,
        euroc_kernel_entries(euroc_checks, euroc_launches)[-1],  # K1 at D=191
        *netvlad_kernel_entries(netvlad_runs),  # K1 at D=4,096 and D=256
        train_kernel_entries(train_checks, train_launches)[0],  # K1 on the run of trained weights
        {**kernel_entry("small_eig (svd3 x256, sym12 x1, spd6 x1)",
                        "cerebro_tpu_torch/csrc/small_eig.cu",
                        "none: jnp.linalg in the JAX package", photo["small_eig_runs"],
                        eig["max_abs_err"], eig),
         "host_launches": photo["small_eig_host_launches"],
         **{name: eig[name] for name in ("svd3", "sym12", "spd6")}},
    ]
    check(all(e["launches"] > 0 for e in kernels), "a kernel of the main path never launched")
    emit({"kernels": kernels})
    return finish(smi)


LAST_PHASES = ("synthetic", "mesh", "calib")


def run_last_phases(device, world, phases, smi: str) -> int:
    """``--phase synthetic,mesh,calib`` (any of them): the k1, k2 and k3
    checks, the phases asked for (mesh after a pipeline_topk run, whose
    graph it solves), and a kernels line of K1 and K3 with those phases'
    launches (K2 is not on their paths: Method A top-1)."""
    from cerebro_tpu_torch.ops.similarity import K1, K2
    from cerebro_tpu_torch.ops.stereo_kernel import K3

    k1 = phase_k1(device)
    emit(k1)
    emit(phase_k2(device, photo_N=photo_config(PHOTO_FRAMES).loop.db_capacity))
    k3 = phase_k3(device, world)
    emit(k3)
    launches = {"K1": 0, "K3": 0}
    errs = [x["max_abs_err"] for x in k1["shapes"]]
    if "synthetic" in phases:
        synthetic, got = phase_synthetic(device)
        emit(synthetic)
        errs.append(synthetic["k1_check"]["max_abs_err"])
        launches = {k: launches[k] + got[k] for k in launches}
    if "mesh" in phases:
        K1.launches = K2.launches = K3.launches = 0
        topk, topk_engine, _, _ = phase_pipeline_topk(device, world, TOPK_FRAMES, LAPS)
        emit(topk)
        mesh, got = phase_mesh(device, world, topk_engine)
        topk_engine.close()
        emit(mesh)
        launches = {k: launches[k] + got[k] for k in launches}
    if "calib" in phases:
        emit(phase_calib(device))
    entries = [kernel_entry("K1 score_topk (K=1)", "cerebro_tpu_torch/csrc/score_topk.cu",
                            "cerebro_tpu/ops/similarity.py:98", launches["K1"], max(errs), k1["shapes"][0]),
               k3_entry(k3, launches["K3"])]
    if phases != ["calib"]:  # the calibration tools launch no kernel
        check(all(e["launches"] > 0 for e in entries), "a kernel of these phases never launched")
        emit({"kernels": entries})
    return finish(smi)


def euroc_kernel_entries(checks: dict, launches: dict) -> list:
    """The kernels line of the euroc phase: K1, K2, K3 at the shapes its
    runs gave them, and K1 at D=191 (rows padded to 192), last."""
    entries = [
        kernel_entry("K1 score_topk (K=1)", "cerebro_tpu_torch/csrc/score_topk.cu",
                     "cerebro_tpu/ops/similarity.py:98", launches["K1"],
                     checks["K1"]["max_abs_err"], checks["K1"]),
        k2_euroc_entry(kernel_entry(
            "K2 score_topk (top-k call)", "cerebro_tpu_torch/csrc/score_topk.cu",
            "cerebro_tpu/ops/similarity.py:286", launches["K2"], 0.0, checks["K2"]), checks),
        k3_entry(checks["K3"], launches["K3"]),
        kernel_entry("k1_d191", "cerebro_tpu_torch/csrc/score_topk.cu",
                     "cerebro_tpu/ops/similarity.py:98", launches["K1_d191"],
                     checks["K1_d191"]["max_abs_err"], checks["K1_d191"]),
    ]
    check(all(e["launches"] > 0 for e in entries), "a kernel of the euroc runs never launched")
    return entries


def live_kernel_entries(checks: dict, launches: dict) -> list:
    """The kernels line of ``--phase live``: K1 and K3 held and timed on
    the live run's own data, with the stream's and the drain's launches.
    K2 is not on this path (Method A top-1)."""
    entries = [
        kernel_entry("K1 score_topk (K=1)", "cerebro_tpu_torch/csrc/score_topk.cu",
                     "cerebro_tpu/ops/similarity.py:98", launches["K1"],
                     checks["K1"]["max_abs_err"], checks["K1"]),
        k3_entry(checks["K3"], launches["K3"]),
    ]
    check(all(e["launches"] > 0 for e in entries), "a kernel of the live run never launched")
    return entries


def k2_euroc_entry(entry: dict, checks: dict) -> dict:
    """K2's kernels-line entry with the euroc runs' two K2 shapes folded in:
    its error the largest of the entry's and theirs, and the gist run's
    top-3 call (D = 4,096) beside the repeat DB's (D = 8,192)."""
    entry["max_abs_err"] = max(entry["max_abs_err"], checks["K2"]["max_abs_err"],
                               checks["K2_gist"]["max_abs_err"])
    g = checks["K2_gist"]
    entry.update({"gist_D": g["D"], "gist_call_ms": g["kernel_ms"], "gist_call_plain_ms": g["plain_ms"],
                  "gist_call_library_ms": g["library_ms"], "gist_call_bound_ms": g["bound_ms"]})
    return entry


def k3_entry(k3: dict, launches: int) -> dict:
    entry = kernel_entry("K3 stereo_bm", "cerebro_tpu_torch/csrc/stereo_bm.cu",
                         "cerebro_tpu/ops/stereo_pallas.py:53", launches, k3["max_abs_err"], k3)
    if "kernel_device_ms" in k3:
        entry["device_ms"] = k3["kernel_device_ms"]
    return entry


def finish(smi: str) -> int:
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
