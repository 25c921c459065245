"""On the card only: one short run of each cell through the command, with a
result line that the benchmark's rules accept. Run on the chip with
``python -m pytest portbench/tests -m cuda``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", cell, "--seed", "2147483659",
                          "--seconds", "12", "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(line)[-1] == "compared"
    for m in line["metrics"].values():
        assert m["value"] == m["value"] and (m["unit"] != "%" or m["value"] <= 105.0)
