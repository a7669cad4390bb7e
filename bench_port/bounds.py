"""The card's peaks and the least bytes and operations of the two hand kernels.

Peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet): HBM3
at 3.35 TB/s and 67 TFLOP/s in float32 outside the tensor cores.  A
kernel's bound is the larger of its bytes over the bandwidth and its
operations over the float32 rate; each input byte is counted read once and
each output byte written once, whatever the kernel reads again.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def fit_moments_cost(narch: int, shape) -> tuple[int, int]:
    """(bytes, float32 operations) of one ``fused_fit_moments`` launch over
    ``narch`` archives of ``shape = (nsub, nchan, nbin)``: the cube read and
    the centred cube written (4 B an element each), the weights and the three
    maps (4 B a profile each), the validity mask (1 B a profile), a template
    per archive, the bin scale and a ``<t,t>`` per archive; 12 operations an
    element (the fit's multiply and add; weight, subtract, scale and weight
    the residual; sum, max, min; centre, square, add)."""
    nsub, nchan, nbin = (int(v) for v in shape)
    n, p = narch * nsub * nchan * nbin, narch * nsub * nchan
    return 8 * n + 16 * p + p + 4 * narch * nbin + 4 * nbin + 4 * narch, 12 * n


def template_cost(shape, narch: int = 1, reads: int | None = None) -> tuple[int, int]:
    """(bytes, float32 operations) of one ``ordered_template`` launch over
    ``narch`` archives of ``shape``: the cube read ``reads`` times (once per
    archive by default; once for the threshold sweep's pairs, which share one
    cube), the weights (4 B a profile and archive) and the templates written
    (4 B a bin and archive); a multiply and an add per element and archive."""
    nsub, nchan, nbin = (int(v) for v in shape)
    n, p = nsub * nchan * nbin, nsub * nchan
    reads = narch if reads is None else reads
    return 4 * n * reads + 4 * p * narch + 4 * nbin * narch, 2 * n * narch


COSTS = {"fused_fit_moments": fit_moments_cost, "ordered_template": template_cost}


def bound_s(kernel: str, **launch) -> float:
    """The least time one launch of ``kernel`` can take on the card."""
    nbytes, ops = COSTS[kernel](**launch)
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS)
