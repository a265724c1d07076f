"""Host milliseconds in the program's ``svc.units_wait`` spans: the host
blocked on the speech encoder's units (their copy back waits for the
encoder on the card), per second of audio converted. Host ranges only
(``user_annotation``), never their device-side copies."""

from portbench import harness


def read(run):
    audio = run.layer.get("audio_s")
    spans = harness.host_ranges(run.trace_events or [], "svc.units_wait", "user_annotation")
    if not spans or not audio:
        return None
    return 1e-3 * sum(e["dur"] for e in spans) / audio
