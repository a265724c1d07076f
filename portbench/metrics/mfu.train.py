"""The whole step's share of the chip's peak, in %: the model FLOPs of the
window's steps (G and D forward and backward; ``flops.training_flops``)
over the window's length times the peak of the configuration's precision."""

from portbench import peaks


def read(run):
    flops = run.layer.get("model_flops")
    if not flops or not run.window_s:
        return None
    return 100.0 * flops / (run.window_s * peaks.FLOPS[run.cfg["precision"]])
