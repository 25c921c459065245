"""Pretrain the NetVLAD descriptor on synthetic rendered places (counterpart
of scripts/pretrain_synthetic.py).

The reference ships weights trained out of its repo (cartwheel_train, ref
README.md:155). This entry point makes them in the package: it renders
many distinct places of the synthetic fractal world with per-place
viewpoint jitter, trains the descriptor net with the all-pairs margin loss,
checks the place separation it reached, and writes ``params.npz`` (flax
paths, the layout ``models.descriptor.load_descriptor_params`` reads) and
``meta.json``:

    python -m cerebro_tpu_torch.pretrain_synthetic --out DIR \\
        [--cpu] [--steps 300] [--places 32] [--views 4] [--batch-places 8]

It runs on the CUDA device; ``--cpu`` runs on the CPU. It draws its world,
views and batches from ``numpy.random.default_rng(3)`` in the JAX script's
order, so both render the same places and train on the same batches; its
net is ``DescriptorConfig(image_hw=(240, 320), trunk_dim=64,
num_clusters=4)`` (bf16) from seed 0, with Adam at 5e-4. Then
``CerebroPipeline(params=...)`` or ``run_euroc --descriptor netvlad`` use
the weights (see ``load_descriptor_params``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

H, W, FX = 240, 320, 300.0
CX, CY = W / 2, H / 2
Z_NEAR, Z_FAR, X_SPLIT = 4.0, 7.0, 0.0
TRUNK_DIM, NUM_CLUSTERS, LR, SEED = 64, 4, 5e-4, 0
DESCRIBE_BATCH = 32


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Pretrain the NetVLAD descriptor on synthetic places.")
    # no default: the JAX script's (artifacts/descriptor_synth) is the
    # reference's own artifact
    ap.add_argument("--out", required=True, help="directory for params.npz and meta.json")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA device")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--places", type=int, default=32)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--batch-places", type=int, default=8)
    return ap.parse_args(argv)


def fractal_texture(rng: np.random.Generator, n: int = 4096) -> np.ndarray:
    """The synthetic world's (n, n) texture in [0, 1]: three octaves of
    smoothed block noise (scripts/run_synthetic.py's, bit for bit)."""
    out = np.zeros((n, n), np.float32)
    for scale, amp in [(4, 0.5), (16, 1.0), (64, 2.0)]:
        small = rng.normal(size=(n // scale, n // scale)).astype(np.float32)
        big = np.kron(small, np.ones((scale, scale), np.float32))
        for _ in range(3):
            big = 0.25 * (
                np.roll(big, 1, 0) + np.roll(big, -1, 0)
                + np.roll(big, 1, 1) + np.roll(big, -1, 1)
            )
        out += amp * big
    return (out - out.min()) / (out.max() - out.min())


def _bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, img.shape[1] - 1.0)
    y = np.clip(y, 0.0, img.shape[0] - 1.0)
    x0 = np.floor(x).astype(np.int32)
    y0 = np.floor(y).astype(np.int32)
    x1 = np.minimum(x0 + 1, img.shape[1] - 1)
    y1 = np.minimum(y0 + 1, img.shape[0] - 1)
    wx, wy = x - x0, y - y0
    return (
        img[y0, x0] * (1 - wx) * (1 - wy)
        + img[y0, x1] * wx * (1 - wy)
        + img[y1, x0] * (1 - wx) * wy
        + img[y1, x1] * wx * wy
    )


def render(tex: np.ndarray, w_T_c: np.ndarray) -> np.ndarray:
    """(H, W) uint8 view of the two-plane world (near plane left of
    X_SPLIT, far plane right of it) from camera pose ``w_T_c``, in numpy."""
    R, tv = w_T_c[:3, :3], w_T_c[:3, 3]
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    rays = np.stack([(u - CX) / FX, (v - CY) / FX, np.ones_like(u)], -1)
    dirs = rays @ R.T
    s_near = (Z_NEAR - tv[2]) / dirs[..., 2]
    p_near = tv[None, None] + s_near[..., None] * dirs
    s = np.where(p_near[..., 0] < X_SPLIT, s_near, (Z_FAR - tv[2]) / dirs[..., 2])
    p = tv[None, None] + s[..., None] * dirs
    tx = p[..., 0] * 150.0 + tex.shape[1] / 2
    ty = p[..., 1] * 150.0 + tex.shape[0] / 2
    img = _bilinear(tex, tx, ty)
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def render_places(rng: np.random.Generator, tex: np.ndarray, places: int, views: int):
    """(places * views, H, W, 1) uint8 views and their (N,) int32 place
    labels: each place a base pose, each view jittered around it."""
    imgs, labels = [], []
    for p in range(places):
        base_x = rng.uniform(-10, 10)
        base_y = rng.uniform(-3, 3)
        base_yaw = rng.uniform(-0.3, 0.3)
        for _ in range(views):
            yaw = base_yaw + rng.uniform(-0.05, 0.05)
            c, sn = np.cos(yaw), np.sin(yaw)
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]], np.float32)
            T[:3, 3] = [
                base_x + rng.uniform(-0.15, 0.15),
                base_y + rng.uniform(-0.15, 0.15),
                rng.uniform(-0.1, 0.1),
            ]
            imgs.append(render(tex, T)[..., None])
            labels.append(p)
    return np.stack(imgs), np.asarray(labels, np.int32)


def separation(net, params, imgs: np.ndarray, labels: np.ndarray, device) -> tuple:
    """(mean same-place, mean cross-place) cosine similarity of the views'
    descriptors (a view against itself left out)."""
    import torch

    from cerebro_tpu_torch.models.descriptor import describe_batch

    d = np.concatenate([
        describe_batch(net, params, torch.from_numpy(imgs[i : i + DESCRIBE_BATCH]).to(device)).cpu().numpy()
        for i in range(0, len(imgs), DESCRIBE_BATCH)
    ])
    s = d @ d.T
    same_label = labels[:, None] == labels[None, :]
    same = same_label & ~np.eye(len(labels), dtype=bool)
    return float(s[same].mean()), float(s[~same_label].mean())


def main(argv=None) -> dict:
    """Render, train, check and write; returns a summary: the losses of
    every step, each step's milliseconds (CUDA events on the card, the host
    clock on the CPU), the separation before and after training, the
    output directory."""
    args = parse_args(argv)
    import torch

    from cerebro_tpu_torch.config import DescriptorConfig
    from cerebro_tpu_torch.models.descriptor import create_descriptor_model, export_params
    from cerebro_tpu_torch.train import create_train_state, train_step

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise RuntimeError("pretrain_synthetic runs on the CUDA device and none is available; "
                           "pass --cpu to run on the CPU")

    # --- the place dataset (the world generator of run_synthetic) ---
    rng = np.random.default_rng(3)
    tex = fractal_texture(rng, n=4096)
    print(f"rendering {args.places} places x {args.views} views...", flush=True)
    imgs, labels = render_places(rng, tex, args.places, args.views)

    # --- train ---
    cfg = DescriptorConfig(image_hw=(H, W), trunk_dim=TRUNK_DIM, num_clusters=NUM_CLUSTERS)
    net, params = create_descriptor_model(cfg, seed=SEED, device=device)
    untrained = separation(net, params, imgs, labels, device)
    state, tx = create_train_state(params, lr=LR)

    bp = args.batch_places
    losses, marks = [], []
    for step in range(args.steps):
        pl_idx = rng.choice(args.places, bp, replace=False)
        sel = np.concatenate([np.nonzero(labels == p)[0] for p in pl_idx])
        x = torch.from_numpy(imgs[sel]).to(device)
        y = torch.from_numpy(labels[sel]).to(device)
        marks.append(_mark(device))
        state, loss = train_step(net, tx, state, x, y)
        losses.append(loss)
        if step % 25 == 0:
            print(f"step {step}: loss {float(loss):.4f}", flush=True)
    marks.append(_mark(device))
    if device.type == "cuda":
        torch.cuda.synchronize()
    step_ms = [_elapsed_ms(a, b) for a, b in zip(marks, marks[1:])]

    # --- place separation ---
    pos, neg = separation(net, state.params, imgs, labels, device)
    print(f"separation: same-place {pos:.3f} vs cross-place {neg:.3f} (margin {pos-neg:.3f})")

    os.makedirs(os.path.abspath(args.out), exist_ok=True)
    np.savez(os.path.join(args.out, "params.npz"), **export_params(state.params, cfg))
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(
            {
                "config": {"image_hw": [H, W], "trunk_dim": TRUNK_DIM, "num_clusters": NUM_CLUSTERS},
                "steps": args.steps,
                "places": args.places,
                "same_place_sim": pos,
                "cross_place_sim": neg,
            },
            f, indent=2,
        )
    print(f"saved to {args.out}", flush=True)
    return {
        "out": args.out, "device": str(device), "steps": args.steps, "images": len(imgs),
        "losses": [float(v) for v in losses], "step_ms": step_ms,
        "same_place_sim": pos, "cross_place_sim": neg,
        "untrained_same_place_sim": untrained[0], "untrained_cross_place_sim": untrained[1],
    }


def _mark(device):
    """A point on the device's timeline: a recorded CUDA event, or the host
    clock (CPU work is done when the call returns)."""
    import torch

    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _elapsed_ms(a, b) -> float:
    return a.elapsed_time(b) if hasattr(a, "elapsed_time") else (b - a) * 1e3


if __name__ == "__main__":
    main()
