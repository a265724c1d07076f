"""Padded frames over synthesized frames, in %: the frames of every
dispatch the synthesizer ran (rows times bucket length, the padded rows
of a power-of-two batch included) against the chunks' own frames, as the
window's ``Svc._run_synth_batch`` calls received them."""


def read(run):
    real, synth = run.layer.get("real_frames"), run.layer.get("synth_frames")
    if not synth:
        return None
    return 100.0 * (1.0 - real / synth)
