#!/usr/bin/env python
"""Write the trained synth descriptor weights for the PyTorch port.

``artifacts/descriptor_synth`` holds the NetVLAD net that
scripts/pretrain_synthetic.py trained (mobile trunk, 64 channels, 4
clusters, 240x320 gray) as an orbax checkpoint, which the port cannot read
without JAX. This script restores it through
``cerebro_tpu.models.descriptor.load_descriptor_params`` and writes every
array under its flax path:

    python scripts/export_descriptor_synth.py
    # writes artifacts/descriptor_synth_npz/params.npz and meta.json

The npz's keys are the flax paths without the ``params`` level
(``MobileTrunk_0/Conv_0/kernel``, ..., ``NetVLAD_0/centers``), float32, as
``cerebro_tpu_torch.models.descriptor.load_descriptor_params`` reads them;
``meta.json`` is copied unchanged. tests/test_torch_netvlad.py holds the
npz equal to the checkpoint.
"""

import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SRC = os.path.join(REPO, "artifacts", "descriptor_synth")
OUT = os.path.join(REPO, "artifacts", "descriptor_synth_npz")


def synth_config():
    """The JAX package's DescriptorConfig of the trained artifact."""
    from cerebro_tpu.config import DescriptorConfig

    with open(os.path.join(SRC, "meta.json")) as fh:
        c = json.load(fh)["config"]
    return DescriptorConfig(
        image_hw=tuple(c["image_hw"]), trunk_dim=c["trunk_dim"], num_clusters=c["num_clusters"]
    )


def flat_params(params) -> dict:
    """flax params -> {"a/b/name": float32 array}, the ``params`` level
    dropped."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = [p.key for p in path]
        if names[0] == "params":
            names = names[1:]
        out["/".join(names)] = np.asarray(leaf, np.float32)
    return out


def main() -> int:
    from cerebro_tpu.models.descriptor import load_descriptor_params

    _, params = load_descriptor_params(SRC, synth_config())
    arrays = flat_params(params)
    os.makedirs(OUT, exist_ok=True)
    np.savez_compressed(os.path.join(OUT, "params.npz"), **arrays)
    shutil.copyfile(os.path.join(SRC, "meta.json"), os.path.join(OUT, "meta.json"))
    size = os.path.getsize(os.path.join(OUT, "params.npz"))
    print(f"wrote {len(arrays)} arrays to {OUT}/params.npz ({size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
