"""The port's spans and counters (`cips_tpu_torch.profiling`) on the CPU, and
their clock and device times on a card (marked ``cuda``).

  * recording off: `span` hands out one shared null context and allocates
    nothing, no span is kept, and the counters still count;
  * a flagship and a causal train step at the dry run's tiny sizes, recorded:
    every documented span, nested under ``step``, one sequence number a step,
    self times not negative and summing to the root's duration;
  * `BatchLoader` -> `device_prefetch` with a 50 ms sleep in the consumer's
    loop: no data or prefetch span holds the sleep, and the byte counters hold
    the batches' exact bytes;
  * spans recorded while a torch profiler runs, one recorder a profiler
    session, and `trace` writing them, and what each counter added, into
    ``trace.json`` on the profiler's clock.
"""

import itertools
import json
import time
import tracemalloc

import numpy as np
import pytest
import torch

from cips_tpu_torch.data.dataset import BatchLoader, PackedDataset
from cips_tpu_torch.parallel import dryrun
from cips_tpu_torch.parallel.mesh import Mesh, device_prefetch
from cips_tpu_torch import profiling
from cips_tpu_torch.training import causal_task, unet_synthesis
from cips_tpu_torch.training.profiling import SPAN_TRACK, trace

PHASES = ["step.g_forward", "step.g_backward", "step.guard", "step.g_optimizer", "step.d_forward",
          "step.d_backward", "step.d_optimizer"]


def _named(rec, *names):
    return [s for s in rec.spans if s.name in names]


def _self_ns(rec):
    """Each span's duration less its children's."""
    out = [s.ns for s in rec.spans]
    for s in rec.spans:
        if s.parent is not None:
            out[s.parent] -= s.ns
    return out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for this module (tiny tensors; the suite runs workers in parallel)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _packed(n=6, shape=(4, 6, 4), k=5, seed=0) -> PackedDataset:
    """A packed store held in memory (the arrays `PackedDataset` maps from disk)."""
    rng = np.random.default_rng(seed)
    packed = PackedDataset.__new__(PackedDataset)
    packed.volumes = rng.random((n, 2, *shape), dtype=np.float32).astype(np.float16)
    packed.covariates = rng.random((n, k), dtype=np.float32)
    packed.need_values, packed.index = list(range(k)), []
    return packed


def _step(task: str, device: torch.device):
    """A tiny fp32 train step of ``task`` with ``nan_guard`` on, and its batch."""
    cfg = dryrun.TINY_CAUSAL if task == "causal" else dryrun.TINY_FLAGSHIP
    if device.type == "cuda":  # the flash kernels take heads of 32 channels: every network 32 wide on a card
        cfg = json.loads(json.dumps(cfg))
        nets = [cfg.get("atten_unet_def"), cfg.get("pet_decoder_def"), *cfg.get("t1_autoencoder_def", {}).values()]
        for d in filter(None, nets):
            d["num_channels"] = [32, 32]
            if "num_head_channels" in d:
                d["num_head_channels"] = [0, 32]
    state, _, _ = dryrun._build(task, cfg, torch.float32, device, None, 2, dryrun.TINY_CROP[0])
    batch = {k: v.to(device) for k, v in dryrun.global_batch(2, dryrun.TINY_CROP, seed=3).items()}
    if task == "causal":
        step = causal_task.make_train_step(cfg["training"], nan_guard=True, batch_size=2)
        rng = torch.Generator(device).manual_seed(1)
        return (lambda: step(state, batch, rng)), state
    step = unet_synthesis.make_train_step(cfg["training"], nan_guard=True)
    return (lambda: step(state, batch)), state


def test_recording_off_keeps_no_span_and_still_counts():
    assert profiling.span("a") is profiling.span("b", 3, torch.device("cpu"))  # the shared null context
    tracemalloc.start()
    try:
        for _ in itertools.repeat(None, 100):
            with profiling.span("step.g_forward", None, torch.device("cpu")):
                pass
        tracemalloc.reset_peak()
        before = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, 10_000):
            with profiling.span("step.g_forward", None, torch.device("cpu")):
                pass
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert now == before and peak - before < 1024  # nothing kept, nothing allocated a call
    kept = profiling.profiled()
    kept = len(kept.spans) if kept is not None else 0
    packed = _packed()
    read = profiling.COUNTERS["data.bytes_read"]
    batches = list(BatchLoader(packed, 2, seed=1).epoch(0))
    assert profiling.COUNTERS["data.bytes_read"] - read == packed.volumes.nbytes + packed.covariates.nbytes
    step, _ = _step("flagship", torch.device("cpu"))
    step()
    assert len(batches) == 3 and (len(profiling.profiled().spans) if profiling.profiled() else 0) == kept
    with profiling.recording() as rec:
        pass
    assert rec.spans == []


@pytest.mark.parametrize("task", ["flagship", "causal"])
def test_a_recorded_train_step_has_every_phase_nested_under_step(task):
    step, state = _step(task, torch.device("cpu"))
    with profiling.recording() as rec:
        for _ in range(2):
            step()
    rec.resolve()
    roots = [i for i, s in enumerate(rec.spans) if s.parent is None]
    assert [rec.spans[i].name for i in roots] == ["step", "step"]
    assert [rec.spans[i].seq for i in roots] == [0, 1] and state.step == 2
    self_ns = _self_ns(rec)
    for i in roots:
        children = [s for s in rec.spans if s.parent == i]
        assert [s.name for s in children] == PHASES
        assert all(s.seq == rec.spans[i].seq for s in children)
        assert all(s.device_ms == pytest.approx(s.ns / 1e6) for s in children if s.name != "step.guard")
        subtree = [i] + [j for j, s in enumerate(rec.spans) if s.parent == i]
        assert all(self_ns[j] >= 0 for j in subtree)
        assert sum(self_ns[j] for j in subtree) == rec.spans[i].ns
        assert rec.spans[i].start_ns <= children[0].start_ns and children[-1].end_ns <= rec.spans[i].end_ns


def test_loader_and_prefetch_spans_leave_out_the_consumer():
    packed = _packed(n=8)
    loader = BatchLoader(packed, 2, seed=4, random_crop_size=(3, 4, 3))
    start = dict(profiling.COUNTERS)
    sleeps, batches = [], []
    with profiling.recording() as rec:
        for batch in device_prefetch(loader.epoch(0), Mesh(), depth=2):
            t0 = rec.now_ns()
            time.sleep(0.05)
            sleeps.append((t0, rec.now_ns()))
            batches.append(batch)
    assert len(batches) == 4
    spans = _named(rec, "data.gather", "data.widen", "prefetch.pin")
    assert sorted(s.name for s in spans) == ["data.gather"] * 4 + ["data.widen"] * 4 + ["prefetch.pin"] * 4
    assert [s.seq for s in _named(rec, "data.gather")] == [0, 1, 2, 3]
    for s in spans:
        assert s.parent is None
        assert all(s.end_ns <= a or b <= s.start_ns for a, b in sleeps), s  # the sleep is in no span
    grew = {k: profiling.COUNTERS[k] - start.get(k, 0) for k in profiling.COUNTERS}
    # each batch: its 2 rows of both float16 volumes and 5 fp32 covariates read; widened and cropped to fp32
    assert grew["data.bytes_read"] == 4 * (2 * 2 * 4 * 6 * 4 * 2 + 2 * 5 * 4)
    assert grew["data.bytes_widened"] == sum(b["t1"].nbytes + b["pet"].nbytes for b in batches) == 4 * 2 * 2 * 36 * 4
    # nothing is pinned or copied on the CPU
    assert grew.get("prefetch.bytes_copied", 0) == 0


def test_spans_are_recorded_while_a_torch_profiler_runs():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("step", 5):
            with profiling.span("step.g_forward", device=torch.device("cpu")):
                torch.ones(4).sum()
    first = profiling.profiled()
    with profiling.span("step", 6):  # the profiler is off: not recorded, and the session is over
        pass
    assert profiling.profiled() is first
    assert [(s.name, s.seq, s.parent) for s in first.spans] == [("step", 5, None), ("step.g_forward", 5, 0)]
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("step", 7):
            pass
    # a new session: the last one's spans are dropped, not kept beside it
    assert profiling.profiled() is not first
    assert [(s.name, s.seq, s.parent) for s in profiling.profiled().spans] == [("step", 7, None)]
    with profiling.recording() as rec, profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("step", 8):
            pass
    # an open recording() takes the spans, whatever profiler runs
    assert [s.seq for s in rec.spans] == [8] and [s.seq for s in profiling.profiled().spans] == [7]


def test_trace_writes_the_spans_on_the_profilers_clock(tmp_path):
    with trace(str(tmp_path / "prof")):
        with profiling.span("outer", 7):
            with profiling.span("inner"):
                torch.nn.functional.conv3d(torch.ones(1, 1, 8, 8, 8), torch.ones(2, 1, 3, 3, 3))
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    track = [e["pid"] for e in events if e.get("ph") == "M" and e.get("args", {}).get("name") == SPAN_TRACK]
    assert len(track) == 1
    spans = {e["name"]: e for e in events if e.get("pid") == track[0] and e.get("ph") == "X"}
    assert set(spans) == {"outer", "inner"}
    assert spans["outer"]["args"] == {"id": 0, "parent": None, "seq": 7, "device_ms": None}
    assert spans["inner"]["args"]["parent"] == 0 and spans["inner"]["args"]["seq"] == 7
    # the profiler's record of the op inside "inner" lies inside it (to 1 ms: the profiler converts its own
    # clock to Unix time approximately); another clock base would put it seconds or years away
    conv = next(e for e in events if e.get("name") == "aten::conv3d")
    inner = spans["inner"]
    assert inner["ts"] - 1e3 <= conv["ts"] and conv["ts"] + conv["dur"] <= inner["ts"] + inner["dur"] + 1e3


def test_trace_writes_what_each_counter_added(tmp_path):
    packed = _packed(n=4)
    profiling.COUNTERS["data.bytes_read"] += 1  # counts from before the block are not the block's
    with trace(str(tmp_path / "prof")):
        batches = list(device_prefetch(BatchLoader(packed, 2, seed=4).epoch(0), Mesh()))
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    track = next(e["pid"] for e in events if e.get("ph") == "M" and e.get("args", {}).get("name") == SPAN_TRACK)
    counts = {}
    for e in events:
        if e.get("pid") == track and e.get("ph") == "C":
            counts.setdefault(e["name"], []).append((e["ts"], e["args"]["value"]))
    assert set(counts) == {"data.bytes_read", "data.bytes_widened"}  # what grew in the block, no more
    assert counts["data.bytes_read"][1][1] == packed.volumes.nbytes + packed.covariates.nbytes
    assert counts["data.bytes_widened"][1][1] == sum(b["t1"].nbytes + b["pet"].nbytes for b in batches)
    spans = [e for e in events if e.get("pid") == track and e.get("ph") == "X"]
    for samples in counts.values():  # a step from 0 at the block's start to the count at its end, around its spans
        (t0, v0), (t1, _) = samples
        assert v0 == 0 and t0 <= min(e["ts"] for e in spans) and max(e["ts"] + e["dur"] for e in spans) <= t1


# --- on a card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA events, pinned copies and the profiler's device records")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_span_clock_holds_a_marker_kernel_on_card(cuda_device):
    # The profiler's host record of each marker kernel's launch lies inside the span around it (the
    # same clock), and the kernel starts on the idle, synchronised card after the span opens, by
    # the launch latency.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling.recording() as rec:
            for _ in range(5):
                torch.cuda.synchronize()
                time.sleep(0.01)
                with profiling.span("mark"):
                    torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        time.sleep(0.05)
    events = list(prof.profiler.kineto_results.events())
    on_card = [ev for ev in events if "cuda" in str(ev.device_type()).lower()]
    kernels = sorted(ev.start_ns() for ev in on_card if "spin_kernel" in ev.name())
    launches = sorted(ev.start_ns() for ev in events if ev not in on_card and ev.name().startswith("cudaLaunchKernel"))
    found = [(min(launches, key=lambda t: abs(t - s.start_ns)), k, s) for s, k in zip(rec.spans, kernels)]
    print("marker: launch record less span start, span end less launch record, kernel start less span start "
          "and less span end, ns:", [(t - s.start_ns, s.end_ns - t, k - s.start_ns, k - s.end_ns) for t, k, s in found])
    assert len(kernels) == 5
    for t, k, s in found:
        assert s.start_ns - 20_000 <= t <= s.end_ns + 20_000, (s, t)
        assert s.start_ns - 20_000 <= k <= s.end_ns + 1_000_000, (s, k)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["flagship", "causal"])
def test_recorded_phases_have_device_times_on_card(cuda_device, task):
    step, _ = _step(task, cuda_device)
    step()
    torch.cuda.synchronize()
    with profiling.recording() as rec:
        step()
    torch.cuda.synchronize()
    rec.resolve()
    phases = [s for s in rec.spans if s.parent is not None and s.name != "step.guard"]
    assert [s.name for s in phases] == [p for p in PHASES if p != "step.guard"]
    assert all(s.device_ms is not None and s.device_ms > 0 and s.events is None for s in phases)


@pytest.mark.cuda
def test_prefetch_counts_the_bytes_it_pins_and_copies_on_card(cuda_device):
    packed = _packed(n=8)
    start = dict(profiling.COUNTERS)
    with profiling.recording() as rec:
        batches = list(device_prefetch(BatchLoader(packed, 2, seed=4).epoch(0), Mesh(device=cuda_device)))
    grew = {k: profiling.COUNTERS[k] - start.get(k, 0) for k in profiling.COUNTERS}
    nbytes = sum(t.nbytes for b in batches for t in b.values())
    assert grew["prefetch.bytes_copied"] == nbytes
    assert [s.name for s in _named(rec, "prefetch.pin", "prefetch.copy")] == ["prefetch.pin", "prefetch.copy"] * 4
