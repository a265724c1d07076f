"""Share of the traced window, in %, in which no kernel, copy or fill ran on the card."""

from portbench import harness


def read(run):
    if not run.trace_events or not run.window_s:
        return None
    return 100.0 * (1.0 - harness.busy_s(run.trace_events) / run.window_s)
