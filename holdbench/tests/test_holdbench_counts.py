"""holdbench/counts.py against hand-worked arithmetic at one shape."""

import pytest

from holdbench import counts


def test_per_point_macs():
    assert counts.TRUNK_MACS == 7 * 65536 + 256 == 459008
    # trunk 459,008 + reverse 458,752 + feature head 65,536 + colour
    # 262 * 256 + 3 * 65,536 + 768
    assert counts.RENDER_MACS == 459008 + 458752 + 65536 + 67072 + 196608 + 768 == 1247744
    assert counts.SHADE_BWD_MACS == 2 * 1247744


def test_row7_bound_at_the_top_shape():
    # 20,480 rays x 98 samples x 2 nodes: 4,014,080 points of 2 x 2,495,488 MACs
    pts = 20480 * 98 * 2
    s = counts.row7_bwd_bound_s(pts)
    assert s == pytest.approx(2 * 2495488 * pts / 989e12)
    assert s == pytest.approx(0.020256, rel=1e-4)
    # bytes would take 124 B x 4,014,080 / 3.35e12 = 0.149 ms: operations bound it
    assert counts.bound_s(0, 0, 124 * pts)[0] == pytest.approx(1.4857e-4, rel=1e-3)


def test_train_step_flops_by_hand():
    f = counts.train_step_flops(rays=10, nodes=2, samples=98, sampler_points=640,
                                prop_macs=10752, bg_samples=32, bg_mac=1000)
    shade = 2 * 10 * 98 * 3 * 1247744
    sampler = 2 * 10 * 640 * 10752
    bg = 3 * 10 * 32 * 1000
    assert f == 2.0 * (shade + sampler + bg)
    assert counts.proposal_macs([39, 64, 64, 64, 1]) == 39 * 64 + 2 * 64 * 64 + 64 == 10752


def test_knn_needed():
    assert counts.knn_needed(1, 778, 16) == 9 * 15 + 15 * 34 + 16
    assert counts.knn_needed(2, 10, 16) == 2 * (9 * 10 + 15 * 34 + 16)
