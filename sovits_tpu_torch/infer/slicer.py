"""Silence-based audio slicer (counterpart of ``sovits_tpu/infer/slicer.py``;
so-vits-svc's inference/slicer.py:6-142 semantics).

RMS-threshold silence detection over ~20 ms hops; long-enough silences are
cut at their quietest frame, leading/trailing silence handled specially.
Returns the reference's chunk-dict format ({id: {"slice": bool,
"split_time": "start,end"}}) so downstream tooling is drop-in compatible.
"""

from __future__ import annotations

import numpy as np

from ..dsp.audio import rms_envelope


class Slicer:
    def __init__(
        self,
        sr: int,
        threshold: float = -40.0,
        min_length: int = 5000,
        min_interval: int = 300,
        hop_size: int = 20,
        max_sil_kept: int = 5000,
    ):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("need min_length >= min_interval >= hop_size")
        if not max_sil_kept >= hop_size:
            raise ValueError("need max_sil_kept >= hop_size")
        min_interval_samples = sr * min_interval / 1000
        self.threshold = 10 ** (threshold / 20.0)
        self.hop_size = round(sr * hop_size / 1000)
        self.win_size = min(round(min_interval_samples), 4 * self.hop_size)
        self.min_length = round(sr * min_length / 1000 / self.hop_size)
        self.min_interval = round(min_interval_samples / self.hop_size)
        self.max_sil_kept = round(sr * max_sil_kept / 1000 / self.hop_size)

    def _silence_tags(self, rms: np.ndarray) -> list[tuple[int, int]]:
        """Scan the RMS track for cuttable silences (argmin-positioned)."""
        tags: list[tuple[int, int]] = []
        sil_start: int | None = None
        clip_start = 0
        for i, r in enumerate(rms):
            if r < self.threshold:
                if sil_start is None:
                    sil_start = i
                continue
            if sil_start is None:
                continue
            leading = sil_start == 0 and i > self.max_sil_kept
            mid_cut = (
                i - sil_start >= self.min_interval and i - clip_start >= self.min_length
            )
            if not leading and not mid_cut:
                sil_start = None
                continue
            span = i - sil_start
            if span <= self.max_sil_kept:
                pos = int(rms[sil_start : i + 1].argmin()) + sil_start
                tags.append((0, pos) if sil_start == 0 else (pos, pos))
                clip_start = pos
            elif span <= self.max_sil_kept * 2:
                pos = (
                    int(
                        rms[i - self.max_sil_kept : sil_start + self.max_sil_kept + 1].argmin()
                    )
                    + i
                    - self.max_sil_kept
                )
                pos_l = (
                    int(rms[sil_start : sil_start + self.max_sil_kept + 1].argmin())
                    + sil_start
                )
                pos_r = (
                    int(rms[i - self.max_sil_kept : i + 1].argmin()) + i - self.max_sil_kept
                )
                if sil_start == 0:
                    tags.append((0, pos_r))
                    clip_start = pos_r
                else:
                    tags.append((min(pos_l, pos), max(pos_r, pos)))
                    clip_start = max(pos_r, pos)
            else:
                pos_l = (
                    int(rms[sil_start : sil_start + self.max_sil_kept + 1].argmin())
                    + sil_start
                )
                pos_r = (
                    int(rms[i - self.max_sil_kept : i + 1].argmin()) + i - self.max_sil_kept
                )
                tags.append((0, pos_r) if sil_start == 0 else (pos_l, pos_r))
                clip_start = pos_r
            sil_start = None

        total = len(rms)
        if sil_start is not None and total - sil_start >= self.min_interval:
            sil_end = min(total, sil_start + self.max_sil_kept)
            pos = int(rms[sil_start : sil_end + 1].argmin()) + sil_start
            tags.append((pos, total + 1))
        return tags

    def slice(self, waveform: np.ndarray) -> dict:
        samples = waveform.mean(axis=0) if waveform.ndim > 1 else waveform
        if samples.shape[0] <= self.min_length:
            return {"0": {"slice": False, "split_time": f"0,{len(samples)}"}}
        rms = rms_envelope(samples, self.win_size, self.hop_size)
        tags = self._silence_tags(rms)
        if not tags:
            return {"0": {"slice": False, "split_time": f"0,{len(samples)}"}}

        n = len(samples)
        chunks = []
        if tags[0][0]:
            chunks.append(
                {"slice": False, "split_time": f"0,{min(n, tags[0][0] * self.hop_size)}"}
            )
        for i, (s, e) in enumerate(tags):
            if i:
                chunks.append(
                    {
                        "slice": False,
                        "split_time": f"{tags[i - 1][1] * self.hop_size},{min(n, s * self.hop_size)}",
                    }
                )
            chunks.append(
                {
                    "slice": True,
                    "split_time": f"{s * self.hop_size},{min(n, e * self.hop_size)}",
                }
            )
        if tags[-1][1] * self.hop_size < n:
            chunks.append(
                {"slice": False, "split_time": f"{tags[-1][1] * self.hop_size},{n}"}
            )
        return {str(i): c for i, c in enumerate(chunks)}


def cut(audio: np.ndarray, sr: int, db_thresh: float = -30, min_len: int = 5000) -> dict:
    """slicer.cut equivalent on an in-memory waveform."""
    return Slicer(sr=sr, threshold=db_thresh, min_length=min_len).slice(audio)


def chunks2audio(audio: np.ndarray, chunks: dict):
    """Split a waveform by a chunk dict -> [(is_silence, segment), ...]."""
    if audio.ndim > 1:
        audio = audio.mean(axis=0)
    result = []
    for v in chunks.values():
        start, end = (int(x) for x in v["split_time"].split(","))
        if start != end:
            result.append((v["slice"], audio[start:end]))
    return result
