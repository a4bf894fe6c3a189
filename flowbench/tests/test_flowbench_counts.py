"""The frozen counts against the kernel table's (``PERF.md``): K1, K3 and
K2's bytes at the training geometry (B·N = 28,520: batch 10 on the 46x62
grid of 368x496 frames, radius 4, four levels), and the FLOPs of a pair."""

from __future__ import annotations

import numpy as np
import pytest

from flowbench import counts

BASIC = {"small": False, "hidden_dim": 128, "context_dim": 128,
         "fnet_dim": 256, "corr_levels": 4, "corr_radius": 4}
SMALL = {"small": True, "hidden_dim": 96, "context_dim": 64, "fnet_dim": 128,
         "corr_levels": 4, "corr_radius": 3}
GRID = (46, 62)


def test_scatter_and_gru_bytes_match_the_table():
    assert counts.scatter_cost(10, GRID, 4, 4)[0] / 1e6 == pytest.approx(
        466.70, abs=0.005)
    assert counts.gates_cost(10, 128, GRID)[0] / 1e6 == pytest.approx(
        73.01, abs=0.005)
    assert counts.blend_cost(10, 128, GRID)[0] / 1e6 == pytest.approx(
        58.41, abs=0.005)


def test_lookup_bytes_match_the_table_on_its_field():
    """The table's 58.71 MB counted the in-range windows of its queries:
    the grid plus 12 px of Gaussian flow, a tenth of them 150 px out. The
    same field drawn here counts the same bytes within its sampling
    spread (0.1%)."""
    rng = np.random.default_rng(7)
    ys, xs = np.meshgrid(np.arange(46.0), np.arange(62.0), indexing="ij")
    grid = np.stack([xs, ys], -1)[None].repeat(10, 0)
    got = []
    for _ in range(8):
        c = grid + 12.0 * rng.standard_normal(grid.shape)
        far = rng.random((10, 46, 62, 1)) < 0.1
        c = np.where(far, c + 150.0 * np.sign(rng.standard_normal(
            grid.shape)), c)
        got.append(counts.lookup_cost(10, GRID, 4, 4, c)[0] / 1e6)
    assert np.mean(got) == pytest.approx(58.71, rel=2e-3)


def test_lookup_bytes_at_zero_flow():
    """With no coords the queries look where they stand: every window is
    in range but at the edges, so more bytes than a field that scatters
    them, and a level whose windows cover it whole reads it whole."""
    nbytes, ops = counts.lookup_cost(10, GRID, 4, 4)
    assert nbytes / 1e6 == pytest.approx(67.40308, abs=1e-5)
    assert ops == 28520 * 4 * 81 * 9
    one, _ = counts.lookup_cost(1, GRID, 4, 4)
    assert nbytes == pytest.approx(10 * one)


def test_pair_flops():
    """~1.09 TFLOP a Sintel pair through basic at iters 20 (encoders 0.18,
    volume 0.03, the update steps 0.88), a quarter of that through small
    at KITTI's size; training three times the forward."""
    basic = counts.forward_flops(BASIC, (440, 1024), 20)
    assert basic / 1e12 == pytest.approx(1.0872, abs=1e-4)
    assert counts.update_flops(BASIC, (55, 128)) / 1e9 == pytest.approx(
        43.906, abs=1e-3)
    assert 2 * 7040 ** 2 * 256 / 1e9 == pytest.approx(25.38, abs=0.01)
    small = counts.forward_flops(SMALL, (376, 1248), 20)
    assert small / 1e12 == pytest.approx(0.2794, abs=1e-4)
    assert counts.train_flops(BASIC, (368, 496), 12) == 3 * \
        counts.forward_flops(BASIC, (368, 496), 12)


def test_scatter_kernel_writes_the_lookups_taps():
    """K3 alone (the fill is a kernel of its own) writes what K1 reads."""
    k1 = counts.lookup_cost(8, GRID, 4, 4)
    k3 = counts.scatter_kernel_cost(8, GRID, 4, 4)
    assert k3[0] == k1[0]
    assert k3[0] < counts.scatter_cost(8, GRID, 4, 4)[0] / 5
    assert k3[1] == 8 * 46 * 62 * 4 * 100 * 8


def test_bound_is_the_larger_of_bytes_and_operations():
    assert counts.bound_s((3.35e12, 0.0), 1e12) == pytest.approx(1.0)
    assert counts.bound_s((0.0, 2e12), 1e12) == pytest.approx(2.0)
