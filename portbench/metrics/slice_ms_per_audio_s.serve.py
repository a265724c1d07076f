"""Host milliseconds in the program's ``svc.slice`` spans (the slicer's cut at
silences and its chunks), per second of audio converted. The spans are
``record_function`` ranges on the trace's host timeline; their device-side
copies (``gpu_user_annotation``) are not counted."""

from portbench import harness


def read(run):
    audio = run.layer.get("audio_s")
    spans = harness.host_ranges(run.trace_events or [], "svc.slice", "user_annotation")
    if not spans or not audio:
        return None
    return 1e-3 * sum(e["dur"] for e in spans) / audio
