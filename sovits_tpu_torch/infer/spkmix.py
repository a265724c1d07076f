"""Dynamic speaker-mix timelines (counterpart of ``sovits_tpu/infer/spkmix.py``;
so-vits-svc's spkmix.py + infer_tool.py:390-442).

A mix map is {speaker_id: [[begin, end, start_value, end_value], ...]} with
begin/end as fractions of the whole clip. This builds the per-frame weight
matrix with linear ramps, validates continuity, and renormalizes each frame
to a convex combination (all-zero frames fall back to uniform weights).
"""

from __future__ import annotations

import numpy as np

# Example timeline, mirroring the reference's spkmix.py:7-11 schema.
EXAMPLE_SPK_MIX_MAP = {
    0: [[0.0, 0.5, 1.0, 0.5], [0.5, 1.0, 0.5, 1.0]],
    1: [[0.0, 0.35, 1.0, 0.5], [0.35, 0.75, 0.75, 1.0], [0.75, 1.0, 0.45, 1.0]],
}


def build_spk_mix_frames(
    spk_mix_map: dict, n_frames: int, n_speakers: int
) -> np.ndarray:
    """-> [n_frames, n_speakers] convex per-frame speaker weights."""
    if len(spk_mix_map) > n_speakers:
        raise ValueError("mix map has more speakers than the model")
    weights = np.zeros((n_speakers, n_frames), np.float64)
    for spk_id, ramps in spk_mix_map.items():
        last_end = None
        for begin_r, end_r, v0, v1 in ramps:
            if v0 < 0 or v1 < 0:
                raise ValueError("mix value must be non-negative")
            begin = int(n_frames * begin_r)
            end = int(n_frames * end_r)
            if end - begin <= 0:
                raise ValueError("begin must be lower than end")
            if last_end is not None and last_end != begin:
                raise ValueError("ramp i's end time must equal ramp i+1's begin time")
            last_end = end
            weights[int(spk_id), begin:end] = np.linspace(v0, v1, end - begin)

    totals = weights.sum(axis=0)
    zero = totals == 0.0
    if zero.any():
        weights[:, zero] = 1.0 / max(len(spk_mix_map), 1)
        totals = weights.sum(axis=0)
    weights = weights / totals
    if not np.allclose(weights.sum(axis=0), 1.0, atol=1e-4):
        raise ValueError("mix weights failed to normalize")
    return weights.T.astype(np.float32)
