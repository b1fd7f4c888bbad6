"""Percent of the traced window of optimiser steps in which no device
operation ran: 100 x (1 - busy union / window)."""


def read(trace, counts):
    if not counts.get("steps") or not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
