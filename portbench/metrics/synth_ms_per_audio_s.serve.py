"""Host milliseconds inside ``Svc._run_synth_batch`` (every dispatch of the
synthesizer and the audio's copy back), timed between synchronises, per
second of audio converted."""


def read(run):
    spans, audio = run.layer.get("spans"), run.layer.get("audio_s")
    if not spans or not audio or not spans.get("synth"):
        return None
    return 1e3 * spans["synth"] / audio
