"""Share of its roofline that the denoise kernel (csrc/denoise.cu) reaches:
the least time of one denoise of the displayed image on an H100 SXM (the
larger of FP32 operations over 67 TFLOP/s and bytes over 3.35 TB/s, from the
shape by `roofline.denoise_work`; at 512^2 the operations bind) over the
kernel's mean time in the device trace, in percent."""

import re

from ptbench import roofline

DENOISE = re.compile(r"\bdenoise_(fixed|any)_kernel\b")


def read(trace, counts):
    runs = [op.end_us - op.start_us for op in trace.ops
            if op.kind == "kernel" and DENOISE.search(op.name)]
    if not runs or "display" not in counts:
        return None
    least, _ = roofline.bound_s(*roofline.denoise_work(*counts["display"]))
    return 100.0 * least / (sum(runs) / len(runs) / 1e6)
