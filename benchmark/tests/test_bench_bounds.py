"""The copied bound arithmetic against PERF.md's kernel rows, and the trace
reduction on a hand-made event list."""

import types

import pytest

from benchmark import yardstick


def test_k4_bound_on_the_ring():
    # PERF.md's K4 row: the ring's 28 pairs of K = 4000 valid rows at 8
    # words, both directions: 0.2318 ms, bound by the tensor cores.
    ii = [i for i in range(8) for j in range(i + 1, 8)]
    jj = [j for i in range(8) for j in range(i + 1, 8)]
    b = yardstick.k4_bound(4000, 8, [4000] * 8, ii, jj)
    assert b["n_dist"] == 2 * 28 * 4000 * 4000
    assert b["bound_ms"] == pytest.approx(0.2318, abs=5e-5)
    assert b["bound_ms"] == b["tensor_ms"] > b["t_bytes"]


def test_k5_bound_on_the_ring():
    # PERF.md's K5 row: the bucket of 8 rects 3x576x1024, 5 bands, of
    # StitchConfig() on data/synth.py's DEFAULT_RING (its offsets and
    # accumulators as the stitch passed them on the H100): 0.0451 ms.
    offs = [(0, 0), (224, 0), (576, 0), (896, 0), (1248, 0), (1568, 0),
            (1920, 0), (2048, 0)]
    acc_hw = [(576 >> b, 3072 >> b) for b in range(6)]
    ms = yardstick.k5_bound_ms((8, 576, 1024), offs, acc_hw, 5)
    assert ms == pytest.approx(0.0451, abs=5e-5)


def test_bound_picks_the_larger():
    assert yardstick.bound(3.35e9, 0.0) == (pytest.approx(1.0), "bytes")
    assert yardstick.bound(0.0, 67e9) == (pytest.approx(1.0), "operations")


def test_k5_union_counts_each_window_once():
    # Two identical rects cover one window: the rects in, the window in
    # every band read and written once.
    one = yardstick.k5_union_bytes((1, 64, 64), [(0, 0)], [(64, 64),
                                                          (32, 32)], 1)
    two = yardstick.k5_union_bytes((2, 64, 64), [(0, 0), (0, 0)],
                                   [(64, 64), (32, 32)], 1)
    assert one == 16 * 64 * 64 + 32 * (64 * 64 + 32 * 32)
    assert two - one == 16 * 64 * 64
    # A window past the accumulator is clamped inside it.
    assert yardstick.band_offsets((60, 60), [(64, 64)], 16, 16) == [(48, 48)]


def _ev(name, start, end, device):
    import torch
    dt = (torch.autograd.DeviceType.CUDA if device
          else torch.autograd.DeviceType.CPU)
    return types.SimpleNamespace(
        name=name, device_type=dt, is_user_annotation=False,
        time_range=types.SimpleNamespace(
            start=start, end=end, elapsed_us=lambda: end - start))


def test_trace_summary():
    events = [_ev("Finding features", 0, 600, False),
              _ev("Compositing", 600, 1000, False),
              _ev("cudaLaunchKernel", 10, 11, False),
              _ev("cudaLaunchKernel", 700, 701, False),
              _ev("hamming_wgmma_kernel", 100, 300, True),
              _ev("copy", 250, 400, True),
              _ev("pyr_down_batch_kernel", 800, 900, True)]
    t = yardstick.TraceSummary(events, 2, 0, 1000,
                               ["Finding features", "Compositing"])
    assert t.busy_s == pytest.approx(400e-6)
    assert t.window_s == pytest.approx(1e-3)
    assert t.launches == 2
    assert t.kernel_seconds(yardstick.K4_KERNELS) == pytest.approx(200e-6)
    b = t.breakdown()
    assert b["idle_gaps"][0] == ["Finding features", pytest.approx(400e-6)]
    assert b["device_ops"][0] == ["hamming_wgmma_kernel",
                                  pytest.approx(200e-6)]
