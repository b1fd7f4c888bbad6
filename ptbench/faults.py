"""Faults planted under the timed path, to show that the correctness check
catches them (`--fault <name>`; the tests under `tests/` plant each one).

Each loop kind's `fault(name)` (`loops/<loop>.py`) says where its timed
path produces the result the fault spoils; `planted` patches it there and
restores it when the window has closed:

  * frozen_state: a step that returns its state unchanged;
  * half_batch: half of the batch left out, the mean taken over the rest
    (every odd row of each rendered frame is a copy of the row below it);
  * altered_answer: an answer altered where it is produced.
"""

from __future__ import annotations

import contextlib

FAULTS = ("frozen_state", "half_batch", "altered_answer")


def half(img):
    """`img` with every odd row a copy of the even row below it."""
    out = img.clone()
    out[1::2] = img[0:-1:2] if img.shape[0] % 2 else img[0::2]
    return out


@contextlib.contextmanager
def planted(patches):
    """Apply `patches` ([(object, attribute, replacement factory(original))],
    none if None) for the duration of the block."""
    saved = []
    try:
        for obj, attr, make in patches or ():
            orig = getattr(obj, attr)
            saved.append((obj, attr, orig))
            setattr(obj, attr, make(orig))
        yield
    finally:
        for obj, attr, orig in reversed(saved):
            setattr(obj, attr, orig)
