"""The whole request's share of the chip's peak, in %: the model FLOPs the
window's takes need (the speech encoder and the synthesizer over every
chunk's own frames, not the padding; ``flops.serving_flops``) over the
window's length times the peak of the configuration's precision."""

from portbench import peaks


def read(run):
    flops = run.layer.get("model_flops")
    if not flops or not run.window_s:
        return None
    return 100.0 * flops / (run.window_s * peaks.FLOPS[run.cfg["precision"]])
