"""K3, the fused ResBlock trio, as a share of its roofline, in %: over the
window's launches, the sum of each launch's bound time over the sum of its
device time.

A launch is a ``sovits::resblock_trio`` operator range in the trace; its
input x is [B, T, C] and the stage's three ResBlock1s (kernel sizes k, each
with three dilated and three plain convs, C to C) are the configuration's.
Its device time is that of the kernels launched inside the range. The bound
(``peaks.bound_s``) is the larger of its operations and its bytes at the
chip's peaks: each input, weight and output byte once."""


from portbench import harness, peaks


def trio_flops(b: int, t: int, c: int, kernel_sizes) -> float:
    """2 B T C^2 k for each of the 6 convs of each kernel size k."""
    return 2.0 * b * t * c * c * 6 * sum(kernel_sizes)


def trio_bytes(b: int, t: int, c: int, kernel_sizes, itemsize: int = 4) -> float:
    """x and the output [B, T, C], 6 weights [k, C, C] and 6 biases [C] per kernel size."""
    return itemsize * (2 * b * t * c + 6 * c * c * sum(kernel_sizes) + 6 * len(kernel_sizes) * c)


def read(run):
    events = run.trace_events
    if not events:
        return None
    ops = harness.host_ranges(events, "sovits::resblock_trio", "cpu_op")
    if not ops:
        return None
    ks = run.cfg["model"]["resblock_kernel_sizes"]
    launched = harness.launched_within(events, [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in ops])
    bound = device = 0.0
    for op, kernels in zip(ops, launched):
        dims = op.get("args", {}).get("Input Dims")
        if not kernels or not dims or len(dims[0]) != 3:
            return None
        b, t, c = dims[0]
        bound += peaks.bound_s(trio_flops(b, t, c, ks), trio_bytes(b, t, c, ks), run.cfg["precision"])
        device += sum(k["dur"] for k in kernels) * 1e-6
    return 100.0 * bound / device if device else None
