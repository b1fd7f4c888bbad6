"""Host milliseconds a frame of shading (`bounce_shade_t`, `bounce_shade`,
`replay_hit`): the self time of the program's `shade` spans over the
frames of the traced window (frame layer)."""

from ptbench import program_spans


def read(trace, counts):
    return program_spans.per(program_spans.self_ms(trace, "shade"), counts.get("frames"))
