"""The correctness check fails what it must: the control (the reference in
bfloat16 in the program's place) and each fault planted under the timed
path, at the tests' small size on the CPU, while a sound run passes.  The
same runs at the cells' own sizes on the card are `test_ptbench_card.py`."""

import pytest

from ptbench import faults
from tiny import CELLS, run_tiny


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    result, checks = run_tiny(workload, seed=7)
    assert result["correct"], checks


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("bad", ["control", *faults.FAULTS])
def test_control_and_faults_are_not_correct(workload, bad):
    kw = {"control": "bfloat16"} if bad == "control" else {"fault": bad}
    result, checks = run_tiny(workload, seed=7, **kw)
    assert not result["correct"], checks


def test_judged_displays_hold_a_view_end_and_a_first_frame():
    import numpy as np

    from ptbench import manifest

    progressive = manifest.loop("progressive")
    mix = {"frames_per_view": 8, "check_images": 3}
    kept = [(v, f, None) for v in range(4) for f in (1, 5, 8)]
    for seed in range(20):
        picks = progressive._choose(kept, mix, np.random.default_rng(seed))
        assert [p[1] for p in picks[:2]] == [8, 1] and len(picks) == 3
        assert len({id(p) for p in picks}) == 3
