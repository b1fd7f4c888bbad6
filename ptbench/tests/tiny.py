"""Small sizes at which the CPU tests drive whole runs of the benchmark's
cells (the program's kernels then run their plain versions)."""

import time
from pathlib import Path

from ptbench import run

ROOT = Path(__file__).resolve().parents[2]
SIZES = {
    "progressive": {"width": 32, "height": 32, "frames_per_view": 6, "warm_frames": 1,
                    "check_images": 3, "check_blocks": 2, "check_block": 8},
    "invert": {"width": 48, "height": 48, "steps_per_episode": 5},
}
CELLS = {"default_scene.interactive": "progressive", "default_scene.invert": "invert"}


def run_tiny(workload, seed=20251018, trace=False, root=ROOT, bench=None, **kw):
    """One run of the cell on the CPU at its loop's small size, for half a
    second: (result, checks)."""
    loop = CELLS.get(workload, kw.pop("loop", None))
    extra = {} if bench is None else {"bench": bench}
    return run.run_cell(root, workload, seed, 0.5, trace, time.perf_counter(), device="cpu",
                        overrides={"traffic": SIZES[loop]}, **extra, **kw)
