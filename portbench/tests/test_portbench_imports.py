"""Nothing the benchmark imports is jax, jaxlib, flax or the JAX package
(top-level names compared whole: ``cerebro_tpu_torch`` is not
``cerebro_tpu``)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import sys
import portbench.run, portbench.system, portbench.check, portbench.readers, portbench.probe
import portbench.route, portbench.world, portbench.yardstick, portbench.__main__
from portbench.reference import judge, posegraph
from portbench import nets, readers
import json, pathlib
for m in json.loads(pathlib.Path("BENCHMARK.json").read_text())["per_layer"]:
    readers.load(m["name"])
for p in pathlib.Path("portbench/nets").glob("*.py"):
    if p.stem != "__init__":
        nets.load(p.stem)
import cerebro_tpu_torch.runtime, cerebro_tpu_torch.ops.similarity, cerebro_tpu_torch.ops.stereo_kernel
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_in_the_benchmarks_process():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr
    top = set(out.stdout.split())
    assert "portbench" in top and "cerebro_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "cerebro_tpu"}, top & {"jax", "jaxlib", "flax", "cerebro_tpu"}


def test_the_check_catches_a_loaded_jax_package(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "cerebro_tpu.config", object())
    assert run.loaded_forbidden() == ["cerebro_tpu"]
    monkeypatch.delitem(sys.modules, "cerebro_tpu.config")
    monkeypatch.setitem(sys.modules, "cerebro_tpu_torch_probe", object())
    assert "cerebro_tpu" not in run.loaded_forbidden()


def test_no_result_without_a_card_or_outside_a_checkout(tmp_path):
    # here there is no CUDA device: exit 2 and no result line
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "bench_e2e_top3.relocalize",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    import torch

    if not torch.cuda.is_available():
        assert out.returncode == 2 and out.stdout.strip() == ""
    # a directory with only BENCHMARK.json and portbench/ has no system to run
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "bench_e2e_top3.relocalize",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
