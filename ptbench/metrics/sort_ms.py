"""Host milliseconds a frame of the binning sort (`_coherence_key`,
`_windowed_sort` and the permutation gathers): the self time of the
program's `sort` spans over the frames of the traced window (frame
layer)."""

from ptbench import program_spans


def read(trace, counts):
    return program_spans.per(program_spans.self_ms(trace, "sort"), counts.get("frames"))
