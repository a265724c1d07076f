"""Device milliseconds per step of the kernels launched inside PyTorch's
own ``Optimizer.step#AdamW.step`` ranges (both nets' AdamW updates)."""

from portbench import harness


def read(run):
    events, steps = run.trace_events, run.layer.get("steps")
    if not events or not steps:
        return None
    ranges = [(e["tid"], e["ts"], e["ts"] + e["dur"])
              for e in harness.host_ranges(events, "Optimizer.step#AdamW.step")]
    launched = harness.launched_within(events, ranges)
    total_us = sum(k["dur"] for ks in launched for k in ks)
    if not total_us:
        return None
    return 1e-3 * total_us / steps
