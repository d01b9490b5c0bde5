"""The program's own spans (`cips_tpu_torch.profiling`), as the span metrics
read them: the program records its spans while a torch profiler runs, one
recorder a profiler session, and the newest session is the run's profiled
steps, since the harness runs the program with no profiler before them. So
the span metrics cover those steps, which the profiler slows, and not the
window. A program that records no spans (before it had them) gives None."""


def spans(run):
    """The program's spans of the profiled steps (see above), or None (no
    profiled steps, or a program without spans)."""
    if not run.profiles or not run.profiles[0].steps:
        return None
    try:
        from cips_tpu_torch.profiling import profiled
    except ImportError:
        return None
    rec = profiled()
    if rec is None:
        return None
    rec.resolve()
    return rec.spans


def host_ms_per_step(run, *names):
    """Host milliseconds in the spans named ``names``, a profiled step."""
    found = [s for s in spans(run) or [] if s.name in names]
    if not found:
        return None
    return sum(s.ns for s in found) / 1e6 / run.profiles[0].steps


def device_ms_per_step(run, *names):
    """The device's milliseconds from start to end of the spans named
    ``names`` (on a card, a pair of CUDA events on the compute stream), a
    profiled step. Where the host paces the card, the card idles inside these
    intervals while it waits for the launching thread, and that idle time is
    counted."""
    found = [s for s in spans(run) or [] if s.name in names and s.device_ms is not None]
    if not found:
        return None
    return sum(s.device_ms for s in found) / run.profiles[0].steps
