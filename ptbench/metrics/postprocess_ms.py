"""Milliseconds a frame of `postprocess` (resize, denoise, tone map) inside
`Renderer.display()`, by the CUDA events of the program's timed
`postprocess` spans over the frames of the traced window: `display_ms`
without the readback (post layer)."""

from ptbench import program_spans


def read(trace, counts):
    return program_spans.per(program_spans.device_ms(trace, "postprocess"), counts.get("frames"))
