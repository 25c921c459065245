"""A second describe net goes in as new files only: a net module and a
configuration in a directory the finder is pointed at, with nothing of the
harness edited. The repo's conv_pw_6 checkpoint (``centeredinput-m1to1``:
its pixels enter as (p - 128) 2 / 255) runs through the system in a small
CPU run of the relocalize cell; its own module judges it correct, and the
flagship's module, which feeds raw pixels, judges the same run not
correct."""

import json

import pytest
import torch

from portbench import nets, run
from portbench.tests.test_portbench_faults import small_config, small_relocalize

CONV6_MODULE = '''"""MobileNetV1 cut after conv_pw_6 + NetVLAD K = 16 on m1to1 input: the
flagship's reference and FLOP rule, fed the June2019 checkpoint's pixels,
(p - 128) 2 / 255."""
import numpy as np

from portbench.nets import mobilenet_v1_netvlad as flagship

weights_dir, load, describe_flops, width = (flagship.weights_dir, flagship.load,
                                            flagship.describe_flops, flagship.width)


def describe_all(weights, frames_u8, device, control=False, block=64):
    m1to1 = (frames_u8.astype(np.float32) - 128.0) * (2.0 / 255.0)
    return flagship.describe_all(weights, m1to1, device, control, block)
'''


@pytest.fixture
def conv6(tmp_path, monkeypatch):
    """The new files: ``mobilenet_conv6_m1to1.py`` and a configuration that
    names it and the checkpoint; returns a writer of that configuration
    under another net's name."""
    (tmp_path / "mobilenet_conv6_m1to1.py").write_text(CONV6_MODULE)
    monkeypatch.setattr(nets, "DIRS", [tmp_path, *nets.DIRS])
    cfg = json.loads((run.PB / "configs" / "bench_e2e_top3.json").read_text())
    cfg["weights"] = "artifacts/descriptor_ported_conv6_m1to1"

    def config(net):
        path = tmp_path / f"conv6_judged_by_{net}.json"
        path.write_text(json.dumps({**cfg, "net": net}))
        return path

    return config


def judged(capsys, cfg_path):
    def bench(b):
        b = json.loads(json.dumps(b))
        next(c for c in b["configs"] if c["name"] == "bench_e2e_top3")["file"] = str(cfg_path)
        return b

    torch.manual_seed(0)
    rc = run.main(["--workload", "bench_e2e_top3.relocalize", "--seed", "4294967311", "--seconds", "0.1",
                   "--trace", "0"], device="cpu", traffic_override=small_relocalize,
                  config_override=small_config, bench_override=bench)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_finder_takes_a_net_from_a_new_directory(conv6):
    mod = nets.load("mobilenet_conv6_m1to1")
    cfg = json.loads(conv6("mobilenet_conv6_m1to1").read_text())
    weights = mod.weights_dir(cfg, run.PB / "_cache")
    assert weights == run.ROOT / "artifacts" / "descriptor_ported_conv6_m1to1"
    assert mod.width(weights) == 16 * 512
    # one conv_pw block fewer than the flagship: conv_pw_7's 512 x 512 at 30x47 less
    flagship = nets.load("mobilenet_v1_netvlad")
    full = flagship.weights_dir({"weights": "artifacts/descriptor_ported"}, run.PB / "_cache")
    cut = 2 * 30 * 47 * 512 * 9 + 2 * 30 * 47 * 512 * 512
    assert mod.describe_flops(weights, (480, 752)) == flagship.describe_flops(full, (480, 752)) - cut


def test_a_net_module_lacking_a_function_is_refused(tmp_path, monkeypatch):
    (tmp_path / "half_a_net.py").write_text("def load(directory, device):\n    return {}\n")
    monkeypatch.setattr(nets, "DIRS", [tmp_path])
    with pytest.raises(AttributeError, match="weights_dir"):
        nets.load("half_a_net")
    with pytest.raises(FileNotFoundError, match="no_such_net"):
        nets.load("no_such_net")


def test_second_net_judged_by_its_own_module_and_not_by_the_flagships(conv6, capsys):
    torch.set_num_threads(4)
    own = judged(capsys, conv6("mobilenet_conv6_m1to1"))
    gap = own["compared"]["desc_gap"]
    assert own["correct"], own["compared"]
    other = judged(capsys, conv6("mobilenet_v1_netvlad"))
    assert not other["correct"]
    # the same system and run: only the reference differs
    assert other["compared"]["desc_gap"]["value"] > gap["limit"] > gap["value"]
    assert other["compared"]["stream_mismatch"]["value"] == own["compared"]["stream_mismatch"]["value"] == 0
