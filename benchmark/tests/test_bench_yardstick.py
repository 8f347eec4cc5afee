"""The roofline yardstick on a hand-counted sweep, and the reading of a
synthetic profiler trace."""

import pytest
import torch

from harness import roofline
from harness.profiling import SPAN_ITER, Readings


def test_in_range_pairs_hand_counted():
    # two rays along x at heights 0 and 1; beams along z crossing x = 0.5
    a0 = torch.tensor([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    a1 = torch.tensor([[1.0, 0.0, 0.0], [1.0, 1.0, 0.0]])
    # beam heights 0.05 (near ray 0), 0.5 (near none at width 0.2),
    # 0.9 (near ray 1), and one at x = 3 (beyond both segments' ends)
    b0 = torch.tensor([[0.5, 0.05, -1.0], [0.5, 0.5, -1.0],
                       [0.5, 0.9, -1.0], [3.0, 0.0, -1.0]])
    b1 = b0 + torch.tensor([0.0, 0.0, 2.0])
    width = torch.full((4,), 0.2)
    assert roofline.in_range_pairs(a0, a1, b0, b1, width) == 2
    # a width of 0.6 reaches the middle beam from both rays
    assert roofline.in_range_pairs(a0, a1, b0, b1, width * 3) == 4


def test_sweep_work_and_least_time():
    a0 = torch.tensor([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
    a1 = torch.tensor([[1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    medium = torch.tensor([0, 0, -1])  # the third ray is in no medium
    beams = dict(start=torch.tensor([[0.5, 0.05, -1.0]]),
                 end=torch.tensor([[0.5, 0.05, 1.0]]),
                 radius=torch.tensor([0.1]))
    ops, n_bytes, pairs = roofline.sweep_work(a0, a1, medium, 0.1, beams,
                                              hetero=False)
    assert pairs == 1
    assert ops == roofline.GEOM_OPS + roofline.FWD_IN_OPS == 112
    assert n_bytes == 4 * (2 * roofline.RAY_FLOATS + roofline.BEAM_FLOATS)
    het_ops, _, _ = roofline.sweep_work(a0, a1, medium, 0.1, beams,
                                        hetero=True)
    assert het_ops == roofline.GEOM_OPS + 91
    assert roofline.least_seconds(67e12, 1.0) == pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)


def test_sampled_count_scales_by_rays():
    """With more rays than the sample, the count is the sample's scaled by
    rays / sampled rays."""
    n = 4 * roofline.SAMPLE_RAYS
    a0 = torch.zeros((n, 3))
    a1 = torch.zeros((n, 3))
    a1[:, 0] = 1.0
    beams = dict(start=torch.tensor([[0.5, 0.0, -1.0]]),
                 end=torch.tensor([[0.5, 0.0, 1.0]]),
                 radius=torch.tensor([0.1]))
    _, _, pairs = roofline.sweep_work(a0, a1, torch.zeros(n, dtype=torch.long),
                                      0.1, beams, hetero=False)
    assert pairs == n


def _ev(cat, name, ts, dur, corr=None):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)
    if corr is not None:
        e["args"] = dict(correlation=corr)
    return e


def test_readings_of_a_synthetic_trace():
    ev = [
        _ev("user_annotation", SPAN_ITER, 0, 100),
        _ev("user_annotation", "trace_photon_beams", 0, 30),
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 2, corr=1),
        _ev("kernel", "void walk_kernel(float*)", 10, 40, corr=1),
        _ev("user_annotation", "camera_pass", 40, 60),
        _ev("cuda_runtime", "cudaLaunchKernel", 45, 2, corr=2),
        _ev("kernel", "void gather_dense_kernel<false>(float const*)", 60,
            20, corr=2),
        _ev("cuda_runtime", "cudaStreamSynchronize", 85, 3),
        _ev("cuda_runtime", "cudaMemcpyAsync", 88, 1),
        _ev("gpu_user_annotation", "camera_pass", 40, 60),
        _ev("user_annotation", SPAN_ITER, 100, 50),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 120, 1),
        # outside the profiled iterations: not counted
        _ev("cuda_runtime", "cudaStreamSynchronize", 400, 1),
        _ev("kernel", "void late(float*)", 400, 10),
    ]
    rd = Readings(ev, [])
    assert rd.n_iterations == 2
    assert rd.window_s == pytest.approx(150e-6)
    # device busy: [10, 50] and [60, 80]; gpu annotations are not work
    assert rd.busy_s == pytest.approx(60e-6)
    # the walk's span ends at its kernel's end (50), not its host end (30)
    assert rd.span_s("trace_photon_beams") == pytest.approx(50e-6)
    assert rd.span_s("camera_pass") == pytest.approx(60e-6)
    assert rd.span_s("no_such_span") is None
    assert rd.device_s(("gather_dense_kernel",)) == pytest.approx(20e-6)
    assert rd.device_s(("absent",)) is None
    assert rd.host_syncs() == 2
    bd = rd.breakdown()
    assert bd["device_ops"][0] == ["walk_kernel", pytest.approx(40e-6)]
    assert len(bd["idle_gaps"]) >= 1
