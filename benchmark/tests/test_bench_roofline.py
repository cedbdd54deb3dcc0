"""The frozen roofline arithmetic against the bounds the port's kernel
table records (PERF.md, "Every TPU kernel")."""

import numpy as np
import pytest

from benchmark.gen import ba_scene
from benchmark.roofline import bounds


def test_gram_bound_ba1000():
    ms, by = bounds.gram_bound(6, 200000, 1000, np.full(200000, 6))
    assert by == "bytes"
    assert ms == pytest.approx(0.0709, abs=5e-5)


def test_gram_bound_ba300():
    lengths = ba_scene.ba300_lengths(13409, 128, 755822)
    ms, by = bounds.gram_bound(128, 13409, 300, lengths)
    assert by == "operations"
    assert ms == pytest.approx(0.0905, abs=5e-5)


@pytest.mark.parametrize("C,want", [(1000, 0.04309), (300, 0.003899)])
def test_pcg_bound(C, want):
    ms, by = bounds.pcg_bound(C)
    assert by == "bytes"
    assert ms == pytest.approx(want, rel=2e-4)


def test_match_bound():
    ms, by = bounds.match_bound(64, 8192, 8192)
    assert by == "operations"
    assert ms == pytest.approx(0.5556, abs=5e-5)
    ms2, _ = bounds.match_bound_pairs([(8192, 8192)] * 64)
    assert ms2 == pytest.approx(ms)
