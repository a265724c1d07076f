"""Host milliseconds in the program's ``svc.f0`` spans (the f0 predictor's
``compute_f0_uv``: DIO on the host in the cells), per second of audio
converted. Host ranges only (``user_annotation``), never their device-side
copies."""

from portbench import harness


def read(run):
    audio = run.layer.get("audio_s")
    spans = harness.host_ranges(run.trace_events or [], "svc.f0", "user_annotation")
    if not spans or not audio:
        return None
    return 1e-3 * sum(e["dur"] for e in spans) / audio
