"""Checkpoint / resume: the teach-and-repeat mechanism (counterpart of
cerebro_tpu/io/state.py).

Parity target: DataManager::saveStateToDisk / loadStateFromDisk
(src/DataManager.cpp:1098-1353) + ImageDataManager::stashAll. A reloaded
pipeline's DB is pre-populated, so the new run's frames retrieve against
the taught map at once (relocalization; ref src/Cerebro.cpp:138-161).

A checkpoint directory holds

  * ``descriptor_db.npz``: ``vectors`` (a bf16 DB as its raw 16-bit
    pattern, ``vectors_dtype`` naming the dtype; the logical width, no
    padding), or for the int8 DB ``values`` (int8, the logical width) and
    ``scales``; then ``global_ids``, ``count`` and ``total`` (the JAX
    package writes an orbax checkpoint here, which the port does not read);
  * ``keyframes.npz``, the v2 ``manifest.json`` and ``images/``, written as
    the JAX package writes them; ``db_quantized`` says which DB it holds.

A quantized checkpoint loads only into a config with ``loop.quantized``,
and a float one only into a config without it.

A mesh pipeline's ring is sharded over its ranks. Every rank calls
``save_pipeline_state``; the blocks are gathered and rank 0 writes the
whole ring once, in the unsharded format. ``load_pipeline_state(...,
mesh=)`` gives each rank its block of a saved ring, whatever the number of
ranks that saved it.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from cerebro_tpu_torch.config import CerebroConfig
from cerebro_tpu_torch.db import descriptors as ddb
from cerebro_tpu_torch.db.images import ImageStore
from cerebro_tpu_torch.db.keyframes import KeyframeStore
from cerebro_tpu_torch.parallel.sharded_search import gather_db
from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline, LoopEdge

_DB_FILE = "descriptor_db.npz"


def _db_arrays(db) -> dict:
    ring = {
        "global_ids": db.global_ids.cpu().numpy(),
        "count": np.asarray(db.count, np.int64),
        "total": np.asarray(db.total, np.int64),
    }
    if isinstance(db, ddb.QuantizedDB):
        return {
            "values": db.values[:, : db.dim].cpu().numpy(),
            "scales": db.scales.cpu().numpy(),
            **ring,
        }
    vectors = db.vectors[:, : db.dim].cpu()
    if vectors.dtype == torch.bfloat16:
        bits = vectors.view(torch.int16).numpy().view(np.uint16)
    else:
        bits = vectors.numpy()
    return {
        "vectors": bits,
        "vectors_dtype": np.asarray(str(vectors.dtype).removeprefix("torch.")),
        **ring,
    }


def _saved_vectors(z) -> torch.Tensor:
    dtype = getattr(torch, str(z["vectors_dtype"]))
    vec = z["vectors"]
    if dtype == torch.bfloat16:
        return torch.from_numpy(vec.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(vec).to(dtype)


def _restore_db(db, z) -> None:
    """Write a saved DB into ``db`` (a fresh one of the same kind, capacity
    and width; on a mesh, this rank's block of one) in place."""
    quantized = isinstance(db, ddb.QuantizedDB)
    rows = torch.from_numpy(z["values"]) if quantized else _saved_vectors(z)
    if rows.shape != (db.capacity, db.dim):
        raise ValueError(
            f"checkpoint DB is {tuple(rows.shape)}, the pipeline's is ({db.capacity}, {db.dim})"
        )
    block = slice(db.row0, db.row0 + db.local_rows)
    target = db.values if quantized else db.vectors
    target[:, : db.dim] = rows[block].to(device=target.device, dtype=target.dtype)
    if quantized:
        db.scales.copy_(torch.from_numpy(z["scales"][block]))
    db.global_ids.copy_(torch.from_numpy(z["global_ids"][block]))
    db.count = int(z["count"])
    db.total = int(z["total"])


def save_pipeline_state(pipe: CerebroPipeline, directory: str) -> None:
    """Write the pipeline's map to ``directory``. On a mesh every rank
    calls it; rank 0 writes, and no rank returns before the files are
    written."""
    db = pipe.db
    if pipe.mesh is not None:
        axis = pipe.cfg.mesh.axis_db
        db = gather_db(db, pipe.mesh, axis)
        if torch.distributed.get_rank() != 0:
            torch.distributed.barrier()
            return
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, _DB_FILE), **_db_arrays(db))
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
        "db_quantized": isinstance(pipe.db, ddb.QuantizedDB),
    }
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    pipe.images.save_to(os.path.join(directory, "images"))
    if pipe.mesh is not None:
        torch.distributed.barrier()


def load_pipeline_state(
    directory: str,
    cfg=None,
    rig=None,
    describe_fn=None,
    params=None,
    describe_dim: Optional[int] = None,
    stash_dir: Optional[str] = None,
    device: Optional[str] = None,
    mesh=None,
) -> CerebroPipeline:
    """A pipeline built from ``cfg`` on ``device`` (the CUDA device unless
    the caller passes ``device="cpu"``) with the checkpoint's map loaded.
    ``params``: the descriptor net's weights (kind "netvlad"), as
    ``CerebroPipeline`` takes them; ``mesh``: a mesh pipeline, each rank
    loading its block of the ring. Raises ValueError when the checkpoint's
    DB (int8 or float) is not the kind ``cfg.loop.quantized`` asks for."""
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    version = manifest.get("format_version", 0)
    if version != 2:
        raise ValueError(
            f"checkpoint format v{version} unsupported (this build reads v2; "
            "v1 ring-less checkpoints predate the released format)"
        )
    quantized = bool(manifest.get("db_quantized", False))
    want = (cfg or CerebroConfig()).loop.quantized
    if quantized != want:
        raise ValueError(
            "checkpoint is quantized; set LoopConfig.quantized=True" if quantized
            else "checkpoint is not quantized; set LoopConfig.quantized=False"
        )

    pipe = CerebroPipeline(
        cfg=cfg, rig=rig, params=params, describe_fn=describe_fn, describe_dim=describe_dim,
        device=device, mesh=mesh,
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
