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
import cerebro_tpu_torch.photoworld
import cerebro_tpu_torch.utils.jaxrand
import cerebro_tpu_torch.geometry.cameras
import cerebro_tpu_torch.io
import cerebro_tpu_torch.io.euroc
import cerebro_tpu_torch.io.rig_config
import cerebro_tpu_torch.models
import cerebro_tpu_torch.models.backbones
import cerebro_tpu_torch.models.netvlad
import cerebro_tpu_torch.models.descriptor
import cerebro_tpu_torch.models.gist
import cerebro_tpu_torch.models.wpca
import cerebro_tpu_torch.utils.plot
import cerebro_tpu_torch.run_euroc
import cerebro_tpu_torch.runtime
import cerebro_tpu_torch.runtime.service
import cerebro_tpu_torch.native
import cerebro_tpu_torch.train
import cerebro_tpu_torch.train.loss
import cerebro_tpu_torch.train.trainer
import cerebro_tpu_torch.train.optim
import cerebro_tpu_torch.utils.precision
import cerebro_tpu_torch.models.keypoints
import cerebro_tpu_torch.pretrain_synthetic
import cerebro_tpu_torch.run_synthetic
import cerebro_tpu_torch.parallel
import cerebro_tpu_torch.parallel.mesh
import cerebro_tpu_torch.parallel.multihost
import cerebro_tpu_torch.parallel.sharded_search
import cerebro_tpu_torch.posegraph.distributed
import cerebro_tpu_torch.geometry.calibration
import cerebro_tpu_torch.geometry.chessboard
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


_PHOTO_PROBE = """
import json, sys
from cerebro_tpu_torch import photoworld
photos = photoworld.load_photos()
assert len(photos) == 9
print(json.dumps(sorted(m for m in ("cv2", "sklearn", "matplotlib", "jax", "cerebro_tpu")
                        if m in sys.modules)))
"""


def test_photoworld_reads_only_the_bundled_photos():
    """The port's photo world needs neither OpenCV, scikit-learn nor
    matplotlib (the machine with the card has none of them)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _PHOTO_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _port_sources(suffixes=(".py",)):
    root = os.path.join(REPO, "cerebro_tpu_torch")
    for dirpath, _, files in os.walk(root):
        if "_build" in dirpath.split(os.sep):
            continue
        for f in files:
            if f.endswith(suffixes):
                yield os.path.join(dirpath, f)
    if ".py" in suffixes:
        yield os.path.join(REPO, "chip_smoke.py")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+cerebro_tpu(\.|\s|$)|from\s+cerebro_tpu(\.|\s))",
    re.M,
)
# a C++/CUDA source that includes or names a file of the JAX package
_FORBIDDEN_NATIVE = re.compile(r"^\s*#\s*include\s*[\"<][^\">]*cerebro_tpu/|cerebro_tpu/native", re.M)


def test_sources_import_no_jax_or_reference_package():
    hits = []
    for path in _port_sources():
        with open(path) as fh:
            for m in _FORBIDDEN.finditer(fh.read()):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not hits, hits
    sources = [os.path.relpath(p, REPO) for p in _port_sources()]
    for mod in (("native", "__init__.py"), ("train", "loss.py"), ("train", "trainer.py"),
                ("train", "optim.py"), ("utils", "precision.py"), ("models", "keypoints.py"),
                ("pretrain_synthetic.py",), ("run_synthetic.py",), ("parallel", "mesh.py"),
                ("parallel", "multihost.py"), ("parallel", "sharded_search.py"),
                ("posegraph", "distributed.py"), ("geometry", "calibration.py"),
                ("geometry", "chessboard.py")):
        assert os.path.join("cerebro_tpu_torch", *mod) in sources


def test_native_sources_are_the_ports_own():
    paths = list(_port_sources((".cpp", ".cu", ".h")))
    rel = [os.path.relpath(p, REPO) for p in paths]
    assert os.path.join("cerebro_tpu_torch", "native", "src", "ingest.cpp") in rel
    hits = []
    for path in paths:
        with open(path) as fh:
            for m in _FORBIDDEN_NATIVE.finditer(fh.read()):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not hits, hits


_NATIVE_PROBE = """
import json, sys
from cerebro_tpu_torch.native import make_ingest, library_path
ing = make_ingest()
ing.push_image(10**9)
with open("/proc/self/maps") as f:
    libs = sorted({line.split()[-1] for line in f if "cerebro_ingest" in line})
print(json.dumps({"libs": libs, "expected": str(library_path()),
                  "modules": sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "cerebro_tpu.")) or m == "cerebro_tpu")}))
"""


def test_make_ingest_loads_only_the_ports_library():
    """The engine make_ingest loads is the port's build under
    cerebro_tpu_torch/_build/, never cerebro_tpu/native's library."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _NATIVE_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["modules"] == []
    assert [os.path.realpath(p) for p in got["libs"]] == [os.path.realpath(got["expected"])]
    assert os.sep + os.path.join("cerebro_tpu_torch", "_build") + os.sep in got["expected"]


@pytest.mark.parametrize(
    "name",
    ["DescriptorConfig", "LoopConfig", "VerifyConfig", "KidnapConfig",
     "PoseGraphConfig", "RuntimeConfig", "MeshConfig", "CerebroConfig"],
)
def test_config_defaults_match_reference(name):
    assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(
        getattr(jcfg, name)()
    )


def test_every_module_of_the_jax_package_has_a_counterpart():
    """The port's module list is complete: every module of cerebro_tpu has
    one of the same path under cerebro_tpu_torch (the Pallas K3's is
    ops/stereo_kernel.py, the CUDA kernel's wrapper), except
    runtime/compile_cache.py (eager PyTorch compiles nothing)."""
    def modules(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, files in os.walk(root) if "_build" not in d for f in files if f.endswith(".py")}

    renamed = {os.path.join("ops", "stereo_pallas.py"): os.path.join("ops", "stereo_kernel.py")}
    port = modules("cerebro_tpu_torch")
    missing = {m for m in modules("cerebro_tpu") if renamed.get(m, m) not in port}
    assert missing == {os.path.join("runtime", "compile_cache.py")}, missing


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="checks the no-CUDA path")
def test_entry_points_need_cuda_or_the_cpu(tmp_path):
    """Without CUDA, an entry point raises unless asked for the CPU: no
    fallback hides the device."""
    import numpy as np

    from cerebro_tpu_torch import run_synthetic
    from cerebro_tpu_torch.geometry import calibration, cameras, chessboard, stereo
    from cerebro_tpu_torch.parallel.multihost import init_multihost

    with pytest.raises(RuntimeError, match="--cpu|device='cpu'"):
        run_synthetic.main(["--out", str(tmp_path / "rs")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_multihost("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chessboard.detect_chessboard(np.zeros((64, 64), np.float32), (3, 3))
    board = np.zeros((4, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibration.calibrate_planar(board, np.zeros((3, 4, 2), np.float32))
    cam = cameras.make_pinhole(300.0, 300.0, 32.0, 24.0)
    rig = stereo.RectifiedRig(R0=np.eye(3), R1=np.eye(3), fx=300.0, fy=300.0, cx=32.0, cy=24.0,
                              baseline=0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stereo.rectify_map(cam, np.eye(3), rig, (48, 64))
