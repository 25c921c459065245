"""One run of one cell of the benchmark.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are found by name: the cell in
``BENCHMARK.json``, the configuration in the file it names, its describe
net (weights, reference, FLOPs and width) in ``portbench/nets/<net>.py``,
the traffic mix in ``portbench/traffic/<traffic>.json``, the limits of the
comparison in ``portbench/limits/<cell>.json``, and every metric's reader
in ``portbench/metrics/<metric>.py``. With ``--trace 0`` the line holds the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, the
device's busy and window seconds from a profiler slice, and a breakdown.

Exit codes: 0 with a result line; 2 without the CUDA devices the cell asks
for; 3 when jax, jaxlib, flax or the JAX package is loaded once the window
has closed. ``--control 1`` (never in the benchmark's own runs) judges the
reference one precision below the configuration in the system's place.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

PB = Path(__file__).resolve().parent
ROOT = PB.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cerebro_tpu")


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find(bench: dict, workload: str) -> tuple:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no cell {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, config


def metric_names(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones
    (listed for the cell, or unlisted and moving one of its end-to-end
    metrics)."""
    def applies(m):
        return cell in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    if not trace:
        return [(m["name"], m["unit"]) for m in e2e]
    names = {m["name"] for m in e2e}
    return [(m["name"], m["unit"]) for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None, t_process: float | None = None, device=None, traffic_override=None,
         config_override=None, bench_override=None) -> int:
    """``device`` and the overrides are for the benchmark's own tests
    (a CPU rehearsal at a small size, or of a cell the benchmark does not
    list yet); a run on the chip takes none of them."""
    t_process = time.perf_counter() if t_process is None else t_process
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    if bench_override is not None:
        bench = bench_override(bench)
    cell, config = find(bench, args.workload)
    cfg_file = load_json(ROOT / config["file"])
    traffic = load_json(PB / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(PB / "limits" / f"{cell['name']}.json")["limits"]
    if traffic_override is not None:
        traffic = traffic_override(traffic)
    if config_override is not None:
        cfg_file = config_override(cfg_file)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: the cell needs {cell['chips']} CUDA device(s), found {n}", file=sys.stderr)
            return 2
        device = "cuda"
        torch.cuda.reset_peak_memory_stats()

    from portbench import check, nets, progtrace, readers, route, system

    net = nets.load(cfg_file["net"])
    weights = net.weights_dir(cfg_file, PB / "_cache")
    stream = route.generate(traffic, args.seed)
    drive = {"open": system.open_loop, "closed": system.closed_loop}[traffic["loop"]]
    run = drive(cfg_file, weights, traffic, stream, args.seed, args.seconds, bool(args.trace), device,
                t_process)

    found = loaded_forbidden()
    if found:
        print(f"portbench: the process holds {found} once the window has closed", file=sys.stderr)
        return 3

    hw = tuple(cfg_file["cerebro_config"]["descriptor"]["image_hw"])
    ctx = readers.Context(run=run, describe_flops=net.describe_flops(weights, hw),
                          width=int(net.width(weights)))
    metrics = {}
    sources = {m["name"]: m["source"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name, unit in metric_names(bench, cell["name"], bool(args.trace)):
        if device != "cuda" and (sources[name] == "device_trace" or "mfu" in name):
            continue  # a CPU rehearsal gives no device metric
        v = readers.load(name).read(ctx)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": unit}

    nums = check.numbers(run.out, stream, device, net, weights)
    if args.control:
        print("portbench: the system's numbers " + json.dumps(nums), file=sys.stderr)
        nums = check.numbers(run.out, stream, device, net, weights, control=True)
        print("portbench: control run: the numbers below are the reference's one precision "
              "below the configuration, in the system's place", file=sys.stderr)
    from portbench.reference.judge import compare

    correct, rows = compare(nums, limits)
    rest = {k: v for k, v in nums.items() if k not in limits}
    if rest:
        print("portbench: not compared in this cell " + json.dumps(rest), file=sys.stderr)
    sanity(run, stream, cell)
    smi = power_limit() if device == "cuda" else "cpu"
    dev = {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(run.memory_peak_bytes),
        "name_and_power_limit": smi,
    }
    line = {"correct": bool(correct), "attempted": int(run.attempted), "failed": int(run.failed),
            "metrics": metrics, "device": dev}
    if args.trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        line["breakdown"] = {"device_ops": run.trace["device_ops"], "idle_gaps": run.trace["idle_gaps"]}
    stages = progtrace.delta(run, run.window_t0, run.window_t1)
    line["notes"] = {"window_s": run.window_s, "setup_detail": run.notes,
                     "samples": {"decisions": len(run.decision_ms), "keyframes": len(run.keyframe_ms)},
                     # the program's host seconds and calls by stage in the window (its totals())
                     "window_stages": stages[1] if stages is not None else None}
    if args.trace and run.trace is not None:
        line["notes"]["device_by_span"] = run.trace.get("device_by_span")
        ev = run.trace["device_events"]
        # from the first device operation's start to the last one's end
        line["notes"]["device_extent_s"] = max(e[1] for e in ev) - min(e[0] for e in ev) if ev else None
        line["notes"]["program_launches"] = {
            k: len(v) for k, v in readers.program_launches(ctx).items()}
        line["notes"]["program_counters"] = {
            part: (d[0] if d is not None else None) for part, d in (
                ("window", progtrace.delta(run, run.window_t0, run.window_t1)),
                ("slice", progtrace.delta(run, *run.trace_t)))}
    line["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"portbench: compared {k} = {v!r} against limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, default=_plain), flush=True)
    return 0


def _plain(x):
    if hasattr(x, "item"):
        return x.item()
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    raise TypeError(type(x))


def _quartiles(values: list) -> list:
    import numpy as np

    return [float(v) for v in np.quantile(values, [0.25, 0.5, 0.75])] if len(values) else []


def sanity(run, stream, cell: dict):
    """Candidate precision and recall and edge precision on an earlier
    stderr line: properties of the algorithm, not metrics. The system's
    photo-world record (1,000 frames, 3.5 laps, top-3): candidate precision
    0.991, recall 0.937, edge precision 1.0."""
    from portbench.route import revisit_truth

    sf = run.out["store_frame"]
    pairs = [(sf[c], sf[p]) for c, p in run.out["candidates"]]
    good = [(a, b) for a, b in pairs if a >= 0 and b >= 0
            and math.dist(stream.xy[a], stream.xy[b]) < 1.5]
    stored = [f for f in sf if f >= 0 and stream.is_keyframe[f]]
    truth = revisit_truth(stream)
    held = set(stored)
    truth = truth & [i in held for i in range(len(truth))]
    found = {a for a, _ in good} & set(map(int, truth.nonzero()[0]))
    edges = [(sf[p], sf[c]) for p, c, _ in run.out["edges"]]
    right = sum(math.dist(stream.xy[a], stream.xy[b]) < 1.0 for a, b in edges)
    print("portbench: sanity " + json.dumps({
        "cell": cell["name"], "candidates": len(pairs),
        "candidate_precision": len(good) / max(len(pairs), 1),
        "candidate_recall": len(found) / max(int(truth.sum()), 1),
        "edges": len(edges), "edge_precision": right / max(len(edges), 1),
        "rejected": run.out["rejected_total"],
        # how far apart the candidates' places lie (m), and the rank-0 scores the system
        # logged against Method A's threshold: ground that looks alike far apart is aliasing
        "candidate_dist_m_q": _quartiles([math.dist(stream.xy[a], stream.xy[b]) for a, b in pairs
                                          if a >= 0 and b >= 0]),
        "rank0_score_q": _quartiles([s for s in run.out["scores"] if s > -1.0]),
        "rank0_over_threshold": int(sum(s >= float(run.out["loop_cfg"].dot_threshold)
                                        for s in run.out["scores"])),
        "system_record_top3_photo": {"candidate_precision": 0.991, "candidate_recall": 0.937,
                                     "edge_precision": 1.0},
    }), file=sys.stderr)
