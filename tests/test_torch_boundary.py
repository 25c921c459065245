"""The port's import boundary and config drift.

cerebro_tpu_torch must import neither JAX nor anything of cerebro_tpu (it
keeps its own copies of what it needs), and its config tree must carry the
same defaults as the JAX package's."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import pytest

import cerebro_tpu.config as jcfg
import cerebro_tpu_torch.config as tcfg

REPO = os.path.join(os.path.dirname(__file__), "..")

_PROBE = """
import json, sys
import cerebro_tpu_torch
import cerebro_tpu_torch.runtime.pipeline
import cerebro_tpu_torch.ops.stereo_kernel
import cerebro_tpu_torch.synthworld
import cerebro_tpu_torch.eval
import cerebro_tpu_torch.posegraph
import cerebro_tpu_torch.loop.hypothesis
import cerebro_tpu_torch.loop.topk_methods
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "cerebro_tpu" or m.startswith("cerebro_tpu."))
print(json.dumps(bad))
"""


def test_import_pulls_in_no_jax_and_no_reference_package():
    # a subprocess: this test process already imported jax (conftest.py)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _port_sources():
    root = os.path.join(REPO, "cerebro_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+cerebro_tpu(\.|\s|$)|from\s+cerebro_tpu(\.|\s))",
    re.M,
)


def test_sources_import_no_jax_or_reference_package():
    hits = []
    for path in _port_sources():
        with open(path) as fh:
            for m in _FORBIDDEN.finditer(fh.read()):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not hits, hits


@pytest.mark.parametrize(
    "name",
    ["DescriptorConfig", "LoopConfig", "VerifyConfig", "KidnapConfig",
     "PoseGraphConfig", "RuntimeConfig", "MeshConfig", "CerebroConfig"],
)
def test_config_defaults_match_reference(name):
    assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(
        getattr(jcfg, name)()
    )
