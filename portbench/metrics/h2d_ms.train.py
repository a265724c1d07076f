"""Host milliseconds per step in the program's ``train.to_device`` spans
(``trainer._to_device``: each batch's arrays copied to the card). Host
ranges only (``user_annotation``), never their device-side copies."""

from portbench import harness


def read(run):
    steps = run.layer.get("steps")
    spans = harness.host_ranges(run.trace_events or [], "train.to_device", "user_annotation")
    if not spans or not steps:
        return None
    return 1e-3 * sum(e["dur"] for e in spans) / steps
