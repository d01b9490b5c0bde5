"""Published H100 SXM peaks and the least time of attention work.

The constants are NVIDIA's data sheet for the H100 SXM at 700 W (dense rates)
and the CUDA C Programming Guide's arithmetic throughput table for compute
capability 9.0, at the published boost clock: frozen here so that no program
change and no card's measured clock moves a bound.
"""

from __future__ import annotations

from typing import Iterable, Tuple

BF16_FLOPS = 989e12  # dense tensor-core peak, bf16
HBM_BYTES_PER_S = 3.35e12
SMS = 132
BOOST_CLOCK_HZ = 1.98e9
EX2_PER_CLOCK_PER_SM = 16  # exponentials a clock an SM on the special-function units
EX2_PER_S = EX2_PER_CLOCK_PER_SM * SMS * BOOST_CLOCK_HZ

Site = Tuple[int, int, int, int, int]  # (B, H, Lq, Lk, Dh) of one self-attention


def bound_s(flops: float, nbytes: float, exps: float = 0.0) -> Tuple[float, str]:
    """Least seconds of a kernel: its operations at the bf16 peak, its bytes
    (each input read once, each output written once) at the memory rate, or its
    exponentials on the special-function units, whichever is longest; and which."""
    terms = {"operations": flops / BF16_FLOPS, "bytes": nbytes / HBM_BYTES_PER_S, "exponentials": exps / EX2_PER_S}
    by = max(terms, key=terms.get)
    return terms[by], by


def attention_kernels(site: Site, element_bytes: int = 2) -> dict:
    """{"fwd" | "dq" | "dkv": (operations, bytes, exponentials)} of one attention's
    forward and backward. Forward: 4 B H Lq Lk Dh operations; reads q, k, v,
    writes out and the fp32 log-sum-exp; one exponential a score. dQ: 6 B H Lq
    Lk Dh; dK/dV: 8; each reads q, k, v, dO and the fp32 lse and delta, writes
    its gradients, and recomputes one exponential a score."""
    b, h, lq, lk, d = site
    pairs = b * h * lq * lk
    rows_q, rows_k, stat = b * h * lq * d * element_bytes, b * h * lk * d * element_bytes, b * h * lq * 4
    return {
        "fwd": (4.0 * pairs * d, 2 * rows_q + 2 * rows_k + stat, float(pairs)),
        "dq": (6.0 * pairs * d, 3 * rows_q + 2 * rows_k + 2 * stat, float(pairs)),
        "dkv": (8.0 * pairs * d, 2 * rows_q + 4 * rows_k + 2 * stat, float(pairs)),
    }


def attention_bound_s(sites: Iterable[Site], element_bytes: int = 2) -> float:
    """The least seconds of every site's forward and backward kernels, each kernel bounded by itself."""
    return sum(bound_s(*work)[0] for site in sites for work in attention_kernels(site, element_bytes).values())
