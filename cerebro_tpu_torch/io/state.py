"""Checkpoint / resume: the teach-and-repeat mechanism (counterpart of
cerebro_tpu/io/state.py).

Parity target: DataManager::saveStateToDisk / loadStateFromDisk
(src/DataManager.cpp:1098-1353) + ImageDataManager::stashAll. A reloaded
pipeline's DB is pre-populated, so the new run's frames retrieve against
the taught map at once (relocalization; ref src/Cerebro.cpp:138-161).

A checkpoint directory holds

  * ``descriptor_db.npz``: ``vectors`` (a bf16 DB as its raw 16-bit
    pattern, ``vectors_dtype`` naming the dtype; the logical width, no
    padding), ``global_ids``, ``count`` and ``total`` (the JAX package
    writes an orbax checkpoint here, which the port does not read);
  * ``keyframes.npz``, the v2 ``manifest.json`` and ``images/``, written as
    the JAX package writes them.

The int8 DB is not ported (ROADMAP Queue 1 item 7): a quantized manifest
raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from cerebro_tpu_torch.db.images import ImageStore
from cerebro_tpu_torch.db.keyframes import KeyframeStore
from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline, LoopEdge

_DB_FILE = "descriptor_db.npz"


def _db_arrays(db) -> dict:
    vectors = db.vectors[:, : db.dim].cpu()
    if vectors.dtype == torch.bfloat16:
        bits = vectors.view(torch.int16).numpy().view(np.uint16)
    else:
        bits = vectors.numpy()
    return {
        "vectors": bits,
        "vectors_dtype": np.asarray(str(vectors.dtype).removeprefix("torch.")),
        "global_ids": db.global_ids.cpu().numpy(),
        "count": np.asarray(db.count, np.int64),
        "total": np.asarray(db.total, np.int64),
    }


def _restore_db(db, z) -> None:
    """Write a saved DB into ``db`` (a fresh one of the same capacity and
    width) in place."""
    dtype = getattr(torch, str(z["vectors_dtype"]))
    vec = z["vectors"]
    if dtype == torch.bfloat16:
        vectors = torch.from_numpy(vec.view(np.int16)).view(torch.bfloat16)
    else:
        vectors = torch.from_numpy(vec).to(dtype)
    if vectors.shape != (db.capacity, db.dim):
        raise ValueError(
            f"checkpoint DB is {tuple(vectors.shape)}, the pipeline's is "
            f"({db.capacity}, {db.dim})"
        )
    db.vectors[:, : db.dim] = vectors.to(device=db.vectors.device, dtype=db.vectors.dtype)
    db.global_ids.copy_(torch.from_numpy(z["global_ids"]))
    db.count = int(z["count"])
    db.total = int(z["total"])


def save_pipeline_state(pipe: CerebroPipeline, directory: str) -> None:
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, _DB_FILE), **_db_arrays(pipe.db))
    np.savez_compressed(
        os.path.join(directory, "keyframes.npz"), **pipe.store.to_state_dict()
    )
    manifest = {
        "format_version": 2,  # v2: ring DB (global_ids + total)
        "db_gid_to_store": pipe.db_gid_to_store,
        "kidnap": pipe.kidnap.info(),
        "loop_edges": [e.as_json() for e in pipe.loop_edges],
        "descriptor_dim": int(pipe.db.dim),
        "db_capacity": int(pipe.db.capacity),
        "db_quantized": False,
    }
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    pipe.images.save_to(os.path.join(directory, "images"))


def load_pipeline_state(
    directory: str,
    cfg=None,
    rig=None,
    describe_fn=None,
    describe_dim: Optional[int] = None,
    stash_dir: Optional[str] = None,
    device: Optional[str] = None,
) -> CerebroPipeline:
    """A pipeline built from ``cfg`` on ``device`` (the CUDA device unless
    the caller passes ``device="cpu"``) with the checkpoint's map loaded."""
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    version = manifest.get("format_version", 0)
    if version != 2:
        raise ValueError(
            f"checkpoint format v{version} unsupported (this build reads v2; "
            "v1 ring-less checkpoints predate the released format)"
        )
    if manifest.get("db_quantized", False):
        raise NotImplementedError(
            "a quantized checkpoint needs the int8 DB, which is not ported yet "
            "(ROADMAP Queue 1: item 7, the int8 DB)"
        )

    pipe = CerebroPipeline(
        cfg=cfg, rig=rig, describe_fn=describe_fn, describe_dim=describe_dim, device=device
    )
    if pipe.db.dim != manifest["descriptor_dim"]:
        pipe.close()
        raise ValueError(
            f"descriptor dim mismatch: checkpoint {manifest['descriptor_dim']} vs "
            f"config {pipe.db.dim}"
        )
    with np.load(os.path.join(directory, _DB_FILE)) as z:
        _restore_db(pipe.db, z)
    with np.load(os.path.join(directory, "keyframes.npz")) as z:
        pipe.store = KeyframeStore.from_state_dict({k: z[k] for k in z.files})

    pipe.db_gid_to_store = [int(i) for i in manifest["db_gid_to_store"]]
    kid = manifest["kidnap"]
    pipe.kidnap.world_id = int(kid["world_id"])
    pipe.kidnap.intervals = [list(iv) for iv in kid["intervals"]]
    pipe.loop_edges = [
        LoopEdge(
            stamp_curr=e["timestamp1"],
            stamp_prev=e["timestamp0"],
            idx_curr=e["idx1"],
            idx_prev=e["idx0"],
            T_prev_curr=np.asarray(e["pose_1T0"], np.float32),
            weight=e["weight"],
            n_matches=e["n_matches"],
            description=e.get("description", ""),
        )
        for e in manifest["loop_edges"]
    ]

    img_dir = os.path.join(directory, "images")
    if os.path.isdir(img_dir):
        pipe.images.close()  # the fresh pipeline's empty store
        pipe.images = ImageStore.load_from(
            img_dir,
            stash_dir=stash_dir or pipe.cfg.runtime.stash_dir,
            cache_ttl=pipe.cfg.runtime.image_cache_ttl,
        )
    return pipe
