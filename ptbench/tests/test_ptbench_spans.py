"""The readers of the program's spans and counters: each keeps the records
inside the traced window, takes self time where it reads self time, and
gives None when the program has no recorder."""

import types

import pytest

from ptbench import manifest, program_spans
from tpu_pathtracer_torch.utils.spans import Count, Span

WINDOW = (1000.0, 2000.0)
SPANS = [  # name, start, end, parent, frame, device ms
    ("frame", 1100, 1900, -1, 0, None),
    ("bounce", 1150, 1800, 0, 0, None),
    ("sync", 1150, 1160, 1, 0, None),
    ("walk", 1160, 1500, 1, 0, None),
    ("walk.prep", 1160, 1300, 3, 0, None),
    ("walk.precull", 1200, 1250, 4, 0, None),
    ("walk.prep", 1300, 1320, 3, 0, None),
    ("walk.launch", 1320, 1330, 3, 0, None),
    ("shade", 1500, 1600, 1, 0, None),
    ("sort", 1600, 1700, 1, 0, None),
    ("postprocess", 1910, 1990, -1, 0, 0.05),
    # outside the window: before it, and a frame that ends after it
    ("sync", 500, 900, -1, -1, None),
    ("postprocess", 600, 700, -1, -1, 9.0),
    ("frame", 1950, 2900, -1, 1, None),
    ("walk", 1960, 2500, 13, 1, None),
    ("walk.prep", 1960, 2400, 14, 1, None),
    ("walk.precull", 1970, 2300, 15, 1, None),
    ("shade", 2500, 2600, 13, 1, None),
    ("sort", 2600, 2700, 13, 1, None),
]
COUNTS = [("syncs", 1155, 0, 3), ("walk.pairs", 1400, 0, 1000), ("walk.lanes", 1400, 0, 10),
          ("syncs", 900, -1, 50), ("walk.pairs", 2100, 1, 99999), ("walk.lanes", 2100, 1, 1)]
EXPECT = {  # per frame, or per step for walk_host_ms.step
    "walk_prep_ms": (0.090 + 0.020) / 2,
    "precull_ms": 0.050 / 2,
    "shade_ms": 0.100 / 2,
    "sort_ms": 0.100 / 2,
    "sync_ms": 0.010 / 2,
    "syncs_per_frame": 3 / 2,
    "walk_pairs_per_ray": 1000 / 10,
    "postprocess_ms": 0.05 / 2,
    "walk_host_ms.step": 0.340 / 2,
}


@pytest.fixture
def trace():
    return types.SimpleNamespace(window_us=WINDOW)


def _fake(monkeypatch, recorded, counts):
    fake = types.SimpleNamespace(recorded=lambda: [Span(*s) for s in recorded],
                                 counters=lambda: [Count(*c) for c in counts])
    monkeypatch.setattr(program_spans, "recorder", lambda: fake)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_keeps_the_window(monkeypatch, trace, name):
    _fake(monkeypatch, SPANS, COUNTS)
    counts = {"steps": 2} if name.endswith(".step") else {"frames": 2}
    assert manifest.reader(name)(trace, counts) == pytest.approx(EXPECT[name], rel=1e-9)
    if name != "walk_pairs_per_ray":  # a ratio of two counters
        assert manifest.reader(name)(trace, {}) is None


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_without_records_gives_none(monkeypatch, trace, name):
    counts = {"steps": 2, "frames": 2}
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    assert manifest.reader(name)(trace, counts) is None
    outside = [(n, a, b, -1, f, d) for n, a, b, _, f, d in SPANS[11:]]
    _fake(monkeypatch, outside, COUNTS[3:])
    assert manifest.reader(name)(trace, counts) is None
