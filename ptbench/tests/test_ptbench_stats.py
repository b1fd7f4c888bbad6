"""The benchmark's arithmetic on synthetic inputs."""

import math

import pytest

from ptbench import roofline, stats, tracing
from ptbench.reference import post


def test_p95_and_its_sample_count():
    xs = list(range(1, 201))  # 200 samples: the 190th is the 95th percentile
    assert stats.percentile(xs, 95) == 190
    assert stats.beyond(xs, 95) == 10
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(xs[::-1], 50) == 100


def test_idle_share_from_overlapping_intervals():
    ops = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8), (9.0, 12.0)]
    assert stats.union(ops) == [(0.0, 3.0), (5.0, 6.0), (9.0, 12.0)]
    assert stats.covered(ops, 0.0, 10.0) == pytest.approx(5.0)  # 3 + 1 + 1
    assert stats.gaps(ops, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert stats.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_breakdown_names_idle_gaps_by_the_innermost_span():
    ops = [tracing.DeviceOp("k1", 0.0, 10.0, "kernel"), tracing.DeviceOp("k2", 30.0, 40.0, "kernel"),
           tracing.DeviceOp("Memcpy DtoH", 60.0, 65.0, "memcpy")]
    spans = {"window": [(0.0, 100.0)], "render": [(0.0, 25.0)], "display": [(25.0, 80.0)],
             "readback": [(45.0, 70.0)]}
    tr = tracing.Trace(ops, 25e-6, 100e-6, (0.0, 100.0), spans, {})
    got = tr.breakdown()
    idle = dict(got["idle_gaps"])
    # gaps 10-30 (render), 40-60 (readback, inside display), 65-100 (no span)
    assert idle == pytest.approx({"render": 20e-6, "readback": 20e-6, "other": 35e-6})
    assert got["device_ops"][0] == ["k1", pytest.approx(10e-6)]


def test_denoise_work_from_the_shape():
    taps = post.taps()
    blends = sum(1 for _, dy, _ in taps if dy != math.floor(dy))
    ops, nbytes = roofline.denoise_work(512, 512)
    assert ops == 512 * 512 * (3 + 17 * len(taps) + 9 * blends)
    assert nbytes == 2 * 512 * 512 * 3 * 4
    least, what = roofline.bound_s(ops, nbytes)
    assert what == "operations" and least == pytest.approx(ops / 67e12)
    assert 0.006e-3 < least < 0.008e-3  # the smoke script's 0.0071 ms at 512^2
    assert post.RADIUS == 5 and max(abs(dx) for dx, _, _ in taps) == 5
