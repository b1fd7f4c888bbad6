"""Run one cell of the benchmark and print its result as the last line.

    python -m ptbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration and a traffic
mix, and the mix names its loop kind (`loops/<loop>.py`), which builds the
scene from the seed and the configuration, warms every shape, and drives
the program for `--seconds`; the loop's `check` then holds what the window
produced against the plain reference.
With `--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, each read by `metrics/<name>.py` from
the profiled window.

The program's build cache (`TPU_PATHTRACER_CACHE_DIR`, its nvcc and g++
builds) and Python's bytecode (`__main__`) are kept in `ptbench/.cache/`, so
only the first run in a checkout compiles.  A run needs as many CUDA
devices as the cell asks for, and prints no result without them; nor does
it print one if the process has loaded JAX or the JAX package.

For the benchmark's own checks only: `--control bfloat16` puts the
reference computed in bfloat16 in the program's place, and `--fault
<name>` plants one of `faults.FAULTS` under the timed path (the loop's
`fault`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_pathtracer")


class Run:
    """What a loop needs: the cell, the seed, the clock and the device."""

    def __init__(self, cell, seed: int, seconds: float, tracer, device, t0: float):
        import torch

        import tpu_pathtracer_torch as pt

        self.cell, self.seconds, self.tracer, self.device, self.t0 = cell, seconds, tracer, device, t0
        self.seed_key = seed % (1 << 63)
        self.pt, self.torch = pt, torch
        self._marks = [("start", t0)]

    def sync(self):
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.synchronize()

    @staticmethod
    def log(line: str):
        print(line, file=sys.stderr, flush=True)

    def mark(self, phase: str) -> float:
        """End a phase of set-up: log its seconds; returns the seconds since
        the start."""
        now = time.perf_counter()
        self.log(f"set-up: {phase} {now - self._marks[-1][1]:.3f} s")
        self._marks.append((phase, now))
        return now - self.t0


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole (the port's name only begins with the package's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def set_cache_dirs():
    os.environ["TPU_PATHTRACER_CACHE_DIR"] = str(CACHE / "build")


def card() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, t0: float, *,
             device="cuda", control=None, fault=None, bench: Path = HERE, overrides=None):
    """Run the cell; returns (result dict, {check: (value, limit)})."""
    from . import faults, manifest, tracing

    cell = manifest.cell(root, workload, bench)
    for key, value in (overrides or {}).items():  # the tests' small sizes
        getattr(cell, key).update(value)
    loop = manifest.loop(cell.traffic["loop"], bench)
    run = Run(cell, seed, seconds, tracing.Tracer(trace, cuda=device != "cpu"), device, t0)
    torch = run.torch
    with faults.planted(loop.fault(fault) if fault else None):
        outcome = loop.run(run)
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)) if cuda else 0}
    metrics, breakdown = {}, None
    counts = outcome.counts
    if trace:
        summary = run.tracer.summary()
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        for entry in cell.per_layer:
            value = manifest.reader(entry["name"], bench)(summary, counts)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        breakdown = summary.breakdown()
    else:
        for entry in cell.end_to_end:
            metrics[entry["name"]] = {"value": outcome.end_to_end[entry["name"]],
                                      "unit": entry["unit"]}
    if cuda:  # the program's tensors died with the loop: give the reference their memory
        torch.cuda.empty_cache()
    numbers = loop.check(cell.config, cell.traffic, outcome.answers, run.seed_key, device,
                         control=control)
    checks = {k: (float(v), cell.limits[k]) for k, v in numbers.items()}
    failed = sum(1 for v, limit in checks.values() if not v <= limit)
    result = {"correct": failed == 0,
              "attempted": counts.get("frames", counts.get("steps")),
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    return result, checks


def main(argv=None, t0=None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(prog="python -m ptbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bfloat16",))
    p.add_argument("--fault")
    args = p.parse_args(argv)
    root = HERE.parent
    set_cache_dirs()
    from . import manifest

    chips = manifest.cell(root, args.workload).chips
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ptbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, checks = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), t0,
                              control=args.control, fault=args.fault)
    found = forbidden_modules()
    if found:
        print(f"ptbench: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(f"card: {card()}", file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
