"""The stencil product's share of its roofline: the least time it needs
(the bytes of the unit's Jacobian's needed nonzero coefficients in f32,
x read once and y written once, over the card's published HBM
bandwidth; ``harness.roofline``) over its mean device time per launch
in the traced window, in percent.  Launches are matched by kernel name.
"""

from harness import roofline


def read(run):
    s = run.trace_summary
    launches = [(n, t) for name, (n, t) in s["kernels"].items()
                if "stencil_matvec" in name]
    count = sum(n for n, _ in launches)
    nbytes = run.spans.counts.get("stencil_bytes")
    if not count or not nbytes:
        return None
    least = nbytes[-1] / roofline.HBM_BYTES_PER_S
    return 100.0 * least / (sum(t for _, t in launches) / count)
