"""The describe nets the benchmark's configurations name, one module each.

A configuration file's ``"net": "<name>"`` is found as ``<name>.py`` in the
first directory of ``DIRS`` that holds one (``portbench/nets/``). A net
module gives, for the benchmark's plain reference of that net:

* ``weights_dir(cfg_file, cache_dir) -> Path``: the directory whose
  ``params.npz`` both the system (``descriptor.artifact_dir``) and the
  reference read. A net with published weights returns its artifact; one
  with seeded weights writes them once into ``cache_dir`` from a seed fixed
  in the configuration file, never from ``--seed``;
* ``load(directory, device)`` and ``describe_all(weights, frames_u8,
  device, control=False, block=64)``: the float32 reference of a host stack
  of (B, H, W) uint8 frames, computed in blocks with TF32 off, importing
  nothing of the system, ``jax`` or the JAX package; ``control`` is the same
  net one precision below the configuration's;
* ``describe_flops(directory, hw)`` and ``width(directory)``: the FLOPs of
  one frame and the descriptor's width.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

NETS = Path(__file__).resolve().parent
DIRS = [NETS]
FUNCTIONS = ("weights_dir", "load", "describe_all", "describe_flops", "width")


def load(name: str):
    for d in DIRS:
        path = Path(d) / f"{name}.py"
        if path.exists():
            break
    else:
        raise FileNotFoundError(f"no net module {name!r} in {[str(d) for d in DIRS]}")
    spec = importlib.util.spec_from_file_location(f"portbench.nets.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [f for f in FUNCTIONS if not callable(getattr(mod, f, None))]
    if missing:
        raise AttributeError(f"the net module {path} lacks {missing}")
    return mod
