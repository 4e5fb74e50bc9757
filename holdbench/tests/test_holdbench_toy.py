"""Each entry kind end to end on the CPU at toy widths: the comparison
passes, and fails once the timed path is broken underneath (a step that
leaves the state unchanged, half the batch left out with the mean over the
rest, a hand's pose gradient scaled, the sampler's proposal query off on
one ray in ten, a rendered answer altered where it is made)."""

import pytest

from holdbench import faults


def test_train_passes(toy_root, run_cell):
    rc, res = run_cell("toy_train")
    assert rc == 0 and res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_rays_per_s", "peak_gib", "setup_s"}
    assert list(res)[-1] == "checks"


def test_render_passes(toy_root, run_cell):
    rc, res = run_cell("toy_render")
    assert rc == 0 and res["correct"], res["checks"]
    assert res["metrics"]["render_rays_per_s"]["value"] > 0


@pytest.mark.parametrize("cell,fault", [("toy_train", "unchanged"), ("toy_train", "half_batch"),
                                        ("toy_train", "pose_grad"),
                                        ("toy_train", "proposal_offset"),
                                        ("toy_render", "altered_answer")])
def test_fault_fails(toy_root, run_cell, cell, fault):
    with faults.planted(fault):
        rc, res = run_cell(cell)
    assert rc == 0 and not res["correct"], res["checks"]
