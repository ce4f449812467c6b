"""The reduction of a device trace: kernel names, the busy union, the
idle gaps and the sums by name."""
import pytest

from perfbench.trace import Activity, kernel_base_name


@pytest.mark.parametrize('raw, base', [
    ('void (anonymous namespace)::syrk_kernel<true, false>(CUtensorMap_st, '
     'float*, unsigned int*, xmca::SyrkSched)', 'syrk_kernel'),
    ('sign_field_kernel(signed char*, int*, int, int, int, int, unsigned '
     'int, unsigned int)', 'sign_field_kernel'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::'
     'FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::'
     'FillFunctor<float>, std::array<char*, 1ul>)',
     'vectorized_elementwise_kernel'),
    ('void kernel<getrf_wo_pivot_params_<float2, 0, 256, 1, 64, 64, 68, 8, '
     '1, 1> >(int, int, void*, int, void*, int, int, int, int, int, int*)',
     'kernel<getrf_wo_pivot_params_>'),
    ('void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>('
     'cutlass_80_simt_sgemm_256x128_8x4_nn_align1::Params)',
     'Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>'),
    ('sm80_xmma_gemm_f32f32_f32f32_f32_tn_n', 'sm80_xmma_gemm_f32f32_f32f32_f32_tn_n'),
])
def test_kernel_base_names(raw, base):
    assert kernel_base_name(raw) == base


def _events():
    def ev(cat, name, ts, dur):
        return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}
    return [ev('kernel', 'void a<1>(int)', 0.0, 10.0),
            ev('kernel', 'b(float*)', 5.0, 10.0),      # overlaps a
            ev('gpu_memcpy', 'Memcpy DtoH', 30.0, 5.0),
            ev('kernel', 'void a<2>(int)', 50.0, 20.0),
            ev('cpu_op', 'aten::mm', 0.0, 100.0),        # not the device's
            {'ph': 'i', 'cat': 'kernel', 'name': 'x', 'ts': 0.0}]


def test_busy_is_the_union_of_device_intervals():
    act = Activity.from_trace_events(_events())
    assert act.launches() == 3
    assert act.busy_s() == pytest.approx((15 + 5 + 20) * 1e-6)
    assert act.kernel_s(('a',)) == pytest.approx(30e-6)
    assert act.kernel_s(exclude=('a',)) == pytest.approx(10e-6)
    assert act.top_kernels() == [['a', pytest.approx(30e-6)],
                                 ['b', pytest.approx(10e-6)]]


def test_idle_gaps_are_named_by_the_operations_around_them():
    act = Activity.from_trace_events(_events())
    # b ends at 15, the copy runs 30-35, a starts at 50: the gaps are the
    # idle time the busy share leaves, 70 - 40 us
    assert act.idle_gaps() == [['b -> Memcpy DtoH', pytest.approx(15e-6)],
                               ['Memcpy DtoH -> a', pytest.approx(15e-6)]]
    total = sum(v for _, v in act.idle_gaps())
    assert total == pytest.approx(70e-6 - act.busy_s())


def _ctx(kernels, units=2, window_s=1e-3):
    events = [{'ph': 'X', 'cat': 'kernel', 'name': n, 'ts': ts, 'dur': d}
              for n, ts, d in kernels]
    return {'activity': Activity.from_trace_events(events),
            'window_s': window_s, 'units': units, 'spans': {'rotate': [1, 3]},
            'config': {'n_obs': 2000, 'n_lat': 250, 'n_lon': 400}}


def test_readers_over_a_trace():
    from perfbench import readers
    from perfbench.roofline import pm1_gram_least_s
    least = pm1_gram_least_s(2000, 100000) * 1e6          # us a Gram
    ctx = _ctx([('syrk_kernel(int)', 0.0, 4 * least),   # two runs' Grams
                ('syrk_kernel(int)', 5000.0, 4 * least),
                ('sign_field_kernel(int)', 12000.0, 50.0),
                ('void at::reduce_kernel<1>(int)', 19000.0, 100.0)],
               window_s=0.1)
    assert readers.launches_per_run(ctx) == 2.0
    assert readers.algebra_ms_per_run(ctx) == pytest.approx(0.05)
    # K1 took twice the least time of the four Grams it computed
    assert readers.syrk_roofline(ctx) == pytest.approx(50.0)
    busy = (8 * least + 150.0) * 1e-6
    assert readers.device_idle(ctx) == pytest.approx(100 * (1 - busy / 0.1))
    assert readers.span_mean(ctx, 'rotate') == 2
    assert readers.span_mean(ctx, 'ingest') is None


def test_readers_with_nothing_to_read_return_nothing():
    from perfbench import readers
    ctx = _ctx([], units=0)
    for fn in (readers.launches_per_run, readers.algebra_ms_per_run,
               readers.syrk_roofline, readers.device_idle):
        assert fn(ctx) is None
