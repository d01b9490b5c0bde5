"""One reader a per-layer metric, named as in BENCHMARK.json: ``UNIT`` and
``read(run)``, which returns the metric's value from the traced run, or None
where the run has nothing for it to read (the harness then leaves it out).

``run`` holds: ``steps`` and ``window_s`` of the measured window, ``waits``
(host seconds in each step's ``next()`` on the prefetch iterator),
``flops_per_step`` and ``sites`` (the step's model FLOPs and self-attention
shapes for rank 0's rows, counted on the reference), ``element_bytes`` of the compute dtype, and
``profiles``, one `portbench.trace.Profile` of the profiled steps a rank
(rank 0's first).
"""
