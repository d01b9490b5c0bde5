"""The bound arithmetic, the FLOP and attention counts and the trace's
reductions against hand counts."""

import importlib

import pytest
import torch

from portbench import harness, roofline, trace


def test_attention_kernels_hand_count():
    work = roofline.attention_kernels((1, 1, 4, 4, 2))
    # pairs 16; q and k tensors 1*1*4*2*2 bytes = 16 each; lse 4 fp32 = 16 bytes
    assert work["fwd"] == (128.0, 80, 16.0)
    assert work["dq"] == (192.0, 112, 16.0)
    assert work["dkv"] == (256.0, 128, 16.0)


def test_bound_takes_the_longest_term():
    assert roofline.EX2_PER_S == 16 * 132 * 1.98e9
    assert roofline.bound_s(989e12, 0.0) == (1.0, "operations")
    assert roofline.bound_s(0.0, 2 * 3.35e12) == (2.0, "bytes")
    assert roofline.bound_s(1.0, 1.0, 3 * roofline.EX2_PER_S) == (3.0, "exponentials")
    site = (2, 4, 2304, 2304, 32)
    want = sum(roofline.bound_s(*w)[0] for w in roofline.attention_kernels(site).values())
    assert roofline.attention_bound_s([site, site]) == pytest.approx(2 * want, rel=1e-12)


def test_discriminator_flops_by_hand():
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.models import PatchDiscriminator

    with torch.device("meta"):
        d = PatchDiscriminator(num_channels=64, num_layers_d=3)
        x = torch.zeros(1, 32, 32, 32, 1)
        with FlopCounterMode(display=False) as counter:
            d(x)
    want, n = 0, 32
    for cin, cout, stride in ((1, 64, 2), (64, 128, 2), (128, 256, 2), (256, 512, 1), (512, 1, 1)):
        n = (n + 2 - 4) // stride + 1
        want += 2 * cin * cout * 4 ** 3 * n ** 3
    assert counter.get_total_flops() == want


def test_step_work_scales_with_the_batch_and_finds_every_attention():
    task = importlib.import_module("portbench.tasks.flagship")
    counts = []
    for batch in (1, 2):
        _, cfg, _ = harness.cell_parts("flagship.train.b4", {"volume": [32, 32, 32], "batch": batch})
        flops, sites = harness.count_work(task, cfg)
        counts.append(flops)
        # 2 transformers down, 1 in the middle, 3 up at the coarsest level (4^3 tokens, 128 channels, 4 heads)
        assert sites == [(1, 4, 64, 64, 32)] * (6 * batch)
    assert counts[1] == 2 * counts[0] > 0


def test_profile_union_gaps_and_kinds():
    p = trace.Profile(kernels=[("flash_fwd_bf16_kernel", 1.0, 2.0), ("sm90_xmma_fprop_implicit_gemm", 1.5, 3.0),
                               ("ncclDevKernel_AllReduce", 5.0, 6.0), ("Memcpy", 0.0, 0.0)],
                      window=(0.5, 7.0), spans=[("portbench.step", 0.0, 4.0), ("portbench.metric_read", 3.5, 7.0)],
                      steps=2)
    assert p.busy_intervals() == [(1.0, 3.0), (5.0, 6.0)]
    assert p.busy_s() == 3.0 and p.window_s == 6.5
    # gaps [0.5, 1), [3, 5), [6, 7), each named by the span that overlaps it most
    assert p.idle_gaps() == [("portbench.metric_read", 2.0), ("portbench.metric_read", 1.0), ("portbench.step", 0.5)]
    kinds = p.seconds_by_kind()
    assert kinds["attention"] == 1.0 and kinds["convolution"] == 1.5 and kinds["collective"] == 1.0


def test_markers_place_the_window_and_the_host_spans():
    from types import SimpleNamespace

    def ev(name, start_s, dur_s, device="DeviceType.CUDA", annotation=False):
        return SimpleNamespace(name=lambda: name, start_ns=lambda: int(start_s * 1e9),
                               duration_ns=lambda: int(dur_s * 1e9), device_type=lambda: device,
                               is_user_annotation=lambda: annotation)

    events = [ev("void at::cuda::spin_kernel(long)", 100.0, 0.001), ev("fprop_kernel", 100.5, 1.0),
              ev("Memcpy HtoD (Pinned -> Device)", 101.0, 0.5), ev("portbench.step", 100.0, 3.0, annotation=True),
              ev("cudaLaunchKernel", 100.2, 0.1, device="DeviceType.CPU"),
              ev("void at::cuda::spin_kernel(long)", 102.999, 0.001)]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    spans = [("portbench.loader_next", 10.0, 11.5), ("portbench.step", 11.5, 13.0)]
    p = trace.from_profiler(prof, 2, spans, (10.0, 13.0))
    assert [k[0] for k in p.kernels] == ["fprop_kernel"]
    assert abs(p.window_s - 3.0) < 1e-6 and abs(p.busy_s() - 1.0) < 1e-6
    # on the device's clock the loader's span is [100, 101.5), holding the gap before the kernel;
    # the step's span holds the longer one after it
    assert [name for name, _ in p.idle_gaps()] == ["portbench.step", "portbench.loader_next"]
    assert p.markers == 2

    def profiled(evs):
        return trace.from_profiler(SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: evs))), 2, spans, (10.0, 13.0))

    # the closing marker missing from the records: the window ends with the last kernel
    p = profiled(events[:3])
    assert p.markers == 1 and p.window == (100.0, 101.5) and abs(p.busy_s() - 1.0) < 1e-6
    # the opening one missing: the window starts with the first kernel, which places the spans
    p = profiled(events[1:])
    assert p.markers == 1 and abs(p.window[0] - 100.5) < 1e-9 and abs(p.window[1] - 103.0) < 1e-9
    assert abs(p.spans[0][1] - 100.5) < 1e-9 and p.busy_s() <= p.window_s
    # markers and no kernel: nothing to read
    assert profiled([events[0], events[-1]]) is None
