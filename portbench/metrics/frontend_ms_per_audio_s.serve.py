"""Host milliseconds inside ``Svc._prepare_chunk`` (resample, f0, units,
volume), timed between synchronises, per second of audio converted."""


def read(run):
    spans, audio = run.layer.get("spans"), run.layer.get("audio_s")
    if not spans or not audio or not spans.get("frontend"):
        return None
    return 1e3 * spans["frontend"] / audio
