"""The profiler reduction: kernel classes by name, the busy union, the
idle gaps named by the host's events."""
import pytest

from portbench import profiling
from portbench.profiling import Activity, Window


@pytest.mark.parametrize("name, cls", [
    ("void nstep_short_kernel(float const*, unsigned char const*)", profiling.K1),
    ("void vtrace_short_kernel(float const*)", profiling.K2),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw", profiling.CONV),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<float, float>", profiling.CONV),
    ("void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3>", profiling.CONV),
    ("void wgrad_alg0_engine_NHWC<float, 128, 5, 5, 3, 3, 3, false>", profiling.CONV),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8", profiling.GEMM),
    ("nvjet_tst_64x8_64x16_2x1_v_bz_TNT", profiling.GEMM),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nn_align1>", profiling.GEMM),
    ("Memcpy DtoD (Device -> Device)", profiling.COPY),
    ("Memset (Device)", profiling.COPY),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor>",
     profiling.ELEMENTWISE),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>",
     profiling.ELEMENTWISE),
])
def test_kernel_class(name, cls):
    assert profiling.kernel_class(name) == cls


def test_merge():
    assert profiling.merge([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == [
        [0, 2.5], [3, 4]]


def test_window_busy_counts_and_gaps():
    dev = [Activity("conv_a", 0.0, 1.0), Activity("conv_a", 0.5, 1.5),
           Activity("nstep_kernel", 2.0, 2.5), Activity("add", 4.0, 5.0)]
    host = [Activity("aten::item", 1.4, 1.9),  # covers the first gap's middle
            Activity("cudaStreamSynchronize", 1.6, 1.8),
            Activity("aten::conv2d", 2.6, 2.8)]  # before the second's middle
    w = Window(2, 10.0, dev, host)
    assert w.busy_s == pytest.approx(1.5 + 0.5 + 1.0)
    assert w.by_name["conv_a"] == [pytest.approx(2.0), 2]
    assert w.class_count(profiling.CONV) == 2
    assert w.class_seconds(profiling.K1) == pytest.approx(0.5)
    assert w.top_ops(2) == [["conv_a", pytest.approx(2.0)],
                            ["add", pytest.approx(1.0)]]
    gaps = dict((k, v) for k, v in w.idle_gaps())
    # 1.5-2.0 (middle 1.75: the latest-starting event over it) and
    # 2.5-4.0 (middle 3.25: no host event over it)
    assert gaps == {"cudaStreamSynchronize": pytest.approx(0.5),
                    "host between events": pytest.approx(1.5)}


def test_empty_window():
    w = Window(1, 1.0, [], [])
    assert w.busy_s == 0 and w.top_ops() == [] and w.idle_gaps() == []
