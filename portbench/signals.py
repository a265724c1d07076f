"""The benchmark's audio: sung vocal takes, and a preprocessed training corpus.

A take or an utterance is 44.1 kHz mono: phrases of a harmonic voice (three
partials at 1, 0.25, 0.1 of the fundamental's amplitude) with vibrato,
each at its own pitch, with 20 ms fades, over a noise floor at -54 dBFS
(below the slicer's -40 dB threshold). This is ``bench.py``'s test signal
(a vibrato sine, phase-integrated, plus noise) made into phrases.

Sizes and arrivals do not depend on the seed: every take's length and its
phrases' places come from ``STRUCTURE_SEED``, so every seed converts the
same audio seconds in the same chunks. The seed draws the content (pitch,
vibrato, level, partial phases, noise, speaker) and the order of the takes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

STRUCTURE_SEED = 20260101
# with stronger upper partials (1, 0.5, 0.3, 0.2) DIO at so-vits-svc's
# settings marks a fifth to a quarter of voiced frames unvoiced, in the
# program's fast path and its full-rate one alike (PERF.md)
PARTIALS = (1.0, 0.25, 0.1)
NOISE_FLOOR = 0.002


@dataclass
class Phrase:
    start: int  # sample
    length: int
    base_hz: float
    depth: float  # vibrato depth, semitones
    rate: float  # vibrato rate, Hz
    phase: float  # vibrato phase, radians

    def f0(self, t: np.ndarray) -> np.ndarray:
        """Pitch in Hz at ``t`` seconds from the phrase's start."""
        return self.base_hz * 2.0 ** (self.depth / 12 * np.sin(2 * np.pi * self.rate * t + self.phase))


@dataclass
class Clip:
    audio: np.ndarray  # float32 [L]
    phrases: list[Phrase]
    speaker: int

    def f0_at(self, sample: np.ndarray, margin: int) -> np.ndarray:
        """True pitch (Hz) at each sample index, NaN outside a phrase or
        within ``margin`` samples of its edges."""
        out = np.full(sample.shape, np.nan)
        for p in self.phrases:
            inside = (sample >= p.start + margin) & (sample < p.start + p.length - margin)
            out[inside] = p.f0((sample[inside] - p.start) / SR)
        return out


SR = 44100


def take_layouts(n: int, lo_s: float, hi_s: float, phrase_s=(1.5, 8.0), gap_s=(0.4, 1.2)):
    """``n`` (length, [(phrase start, phrase length)]) in samples, from
    STRUCTURE_SEED: lengths log-uniform in [lo_s, hi_s], phrases and gaps
    uniform in their ranges, a gap before the first phrase."""
    rng = np.random.default_rng(STRUCTURE_SEED)
    out = []
    for _ in range(n):
        total = int(math.exp(rng.uniform(math.log(lo_s), math.log(hi_s))) * SR)
        pos, phrases = int(rng.uniform(*gap_s) * SR), []
        while True:
            length = int(rng.uniform(*phrase_s) * SR)
            if pos + length > total - int(0.3 * SR):
                length = total - int(0.3 * SR) - pos
                if length >= int(phrase_s[0] * SR):
                    phrases.append((pos, length))
                break
            phrases.append((pos, length))
            pos += length + int(rng.uniform(*gap_s) * SR)
        if not phrases:  # a take shorter than one phrase: one phrase over most of it
            phrases = [(int(0.2 * SR), total - int(0.5 * SR))]
        out.append((total, phrases))
    return out


def synthesize(layouts, seed: int, device, n_speakers: int, pitch_hz=(120.0, 400.0)) -> list[Clip]:
    """The clips of ``layouts``, their content drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_phr = sum(len(p) for _, p in layouts)
    u = torch.rand(n_phr, 5, generator=gen, device=device, dtype=torch.float64).cpu().numpy()
    spk = torch.randint(0, n_speakers, (len(layouts),), generator=gen, device=device).cpu().numpy()
    lo, hi = math.log(pitch_hz[0]), math.log(pitch_hz[1])
    clips, k = [], 0
    total = sum(n for n, _ in layouts)
    f0 = torch.zeros(total, dtype=torch.float64, device=device)
    amp = torch.zeros(total, dtype=torch.float64, device=device)
    offset = 0
    fade = int(0.02 * SR)
    ramp = 0.5 - 0.5 * torch.cos(torch.linspace(0, math.pi, fade, dtype=torch.float64, device=device))
    for (n, places), s in zip(layouts, spk):
        phrases = []
        for start, length in places:
            p = Phrase(start, length, math.exp(lo + (hi - lo) * u[k, 0]), 0.3 + 0.5 * u[k, 1],
                       4.5 + 2.0 * u[k, 2], 2 * math.pi * u[k, 3])
            t = torch.arange(length, dtype=torch.float64, device=device) / SR
            f0[offset + start: offset + start + length] = p.base_hz * 2.0 ** (
                p.depth / 12 * torch.sin(2 * math.pi * p.rate * t + p.phase))
            env = torch.full((length,), 0.1 + 0.2 * u[k, 4], dtype=torch.float64, device=device)
            env[:fade] *= ramp
            env[-fade:] *= ramp.flip(0)
            amp[offset + start: offset + start + length] = env
            phrases.append(p)
            k += 1
        clips.append(Clip(None, phrases, int(s)))
        offset += n
    phase = torch.cumsum(2 * math.pi * f0 / SR, 0)
    part_phase = torch.rand(len(PARTIALS), generator=gen, device=device, dtype=torch.float64) * 2 * math.pi
    wave = sum(a * torch.sin(h * phase + part_phase[h - 1]) for h, a in enumerate(PARTIALS, 1))
    noise = torch.randn(total, generator=gen, device=device, dtype=torch.float64) * NOISE_FLOOR
    audio = (amp * wave + noise).float().cpu().numpy()
    offset = 0
    for clip, (n, _) in zip(clips, layouts):
        clip.audio = audio[offset: offset + n]
        offset += n
    return clips


def order(n: int, seed: int) -> list[int]:
    """The seed's order of ``n`` clips."""
    return [int(i) for i in np.random.default_rng(seed).permutation(n)]
