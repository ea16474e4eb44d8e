"""What every cell shares: finding a cell's files by name, the card check,
the isolation check, the statistics of a window, and the result line.

A cell is an entry of `workloads` in BENCHMARK.json. Its configuration is
the JSON file that BENCHMARK.json names for it, its traffic mix is
`traffic/<traffic>.json`, whose `kind` names the general driver
`drivers/<kind>.py`, and each of its per-layer metrics is read by
`metrics/<metric>.py`. A new configuration, mix or metric is a new file and
a new entry; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gnerf_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: str = "cuda"


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload`, with its configuration, mix and metrics."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"benchmark: no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, workload)])


def driver(kind: str):
    """The general driver of a traffic kind: `drivers/<kind>.py`."""
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(metric: str, root: Path = ROOT):
    """The `read(r)` function of `metrics/<metric>.py`."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_loaded(modules=None) -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    each compared whole (`gnerf_tpu_torch` is not `gnerf_tpu`)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat field 22)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q of all at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def latency_p95_ms(latencies_s, failed_s) -> float:
    """p95 over every request due in the window, in ms. A refused or failed
    request counts as missing: its latency is `failed_s`, the time from its
    due time until the run stopped waiting, longer than any served one."""
    return 1e3 * percentile(list(latencies_s) + list(failed_s), 0.95)


def card(chips: int) -> dict:
    """The card's description, or exit: a run needs `chips` CUDA devices."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("benchmark: torch.cuda.is_available() is false; this run needs a card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"benchmark: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} are visible")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them, or why not."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"nvidia-smi unavailable ({err!r})"


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list, breakdown=None) -> str:
    """The last line of standard output; `checks` ([name, value, limit]) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return json.dumps(out)
