"""The count functions at the published widths, worked by hand."""

import pytest

from benchmark.harness import spec


def test_ring_distance_per_pair():
    ring = spec.load_module("counts", "ring_distance")
    # 2 patches x 2 ops x 40,960 filters x 4,096 pixels x 8 bins
    assert ring.flops(1, 40960, 4096, 8) == 5_368_709_120
    assert ring.flops(8192, 40960, 4096, 8) == pytest.approx(4.398e13,
                                                              rel=1e-3)
    # bank 671 MB once, 2 x 4,096 patch bytes and 5,120 f32 a pair
    assert ring.bytes_moved(8192, 40960, 4096, 5120) == (
        40960 * 4096 * 4 + 8192 * (2 * 4096 + 4 * 5120))


def test_pj_step_and_validation():
    step = spec.load_module("counts", "pj_step")
    val = spec.load_module("counts", "pj_validate")
    assert step.ns_flops(45, 544, 24) == 45 * 49 * 2 * 544 ** 3
    assert step.ns_flops(45, 544, 24) == pytest.approx(7.10e11, rel=1e-3)
    assert step.batch_flops(45, 544, 200) == 45 * 4 * 2 * 200 * 544 ** 2
    assert step.flops(45, 544, 24, 200) == (step.ns_flops(45, 544, 24)
                                            + step.batch_flops(45, 544, 200))
    # the F = 608 width: 1.40x the Newton-Schulz work of 544
    assert step.ns_flops(45, 608, 24) / step.ns_flops(45, 544, 24) == \
        pytest.approx(1.396, rel=1e-3)
    assert val.flops(45, 544, 50000, 50000) == 45 * 2 * 100000 * 544 ** 2


def test_peaks():
    p = spec.peaks()
    assert p["flops"] == {"f32": 165e12, "bf16": 989e12}
    assert p["hbm_bytes_per_s"] == 3.35e12
