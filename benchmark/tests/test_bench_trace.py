"""The trace reader on a made-up event list."""

import pytest

from benchmark.trace import Ev, kernel_class, summarize


def test_kernel_classes():
    assert kernel_class("void down2x_kernel<float, true>(...)") == "fir2x"
    assert kernel_class("pair_conv3x3_kernel") == "pair_conv3x3"
    assert kernel_class("sm90_xmma_fprop_implicit_gemm_bf16") == "convolution"
    assert kernel_class("cutlass_80_tensorop_s1688gemm") == "matmul"
    assert kernel_class("void at::native::reduce_kernel<512, 1>") == "reduction/norm/softmax"
    assert kernel_class("void at::native::vectorized_elementwise_kernel") == \
        "elementwise/copy/other"


def test_summary_and_breakdown():
    events = [
        # host: a step span with a conv call that launches, then a copy
        Ev("bench.train_step", False, 0, 100),
        Ev("aten::conv2d", False, 5, 30),
        Ev("cudaLaunchKernel", False, 8, 9),
        Ev("aten::add", False, 40, 60),
        Ev("cudaLaunchKernel", False, 45, 46),
        Ev("cudaLaunchKernel", False, 70, 71),
        # device: two overlapping kernels, a gap while the host is in add, one more
        Ev("sm90_xmma_fprop_implicit_gemm", True, 20, 35),
        Ev("down2x_kernel", True, 30, 38),
        Ev("elementwise_kernel", True, 62, 80),
    ]
    s = summarize(events, window_s=100e-6, units=2)
    assert s.busy_s == pytest.approx(36e-6)  # [20, 38] and [62, 80]
    assert s.idle_share == pytest.approx(0.64)
    assert s.launches == 3
    assert s.class_s["convolution"] == pytest.approx(15e-6)
    assert s.class_n == {"convolution": 1, "fir2x": 1, "elementwise/copy/other": 1}
    # gaps: [0, 20] (midpoint 10, in the conv call) and [38, 62] (midpoint 50, in add)
    assert s.gap_s == {"aten::conv2d": pytest.approx(20e-6), "aten::add": pytest.approx(24e-6)}
    b = s.breakdown()
    assert b["device_ops"][0] == ["elementwise_kernel", pytest.approx(18e-6)]
    assert [k for k, _ in b["idle_gaps"]] == ["aten::add", "aten::conv2d"]
