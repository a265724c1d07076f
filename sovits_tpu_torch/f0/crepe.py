"""CREPE pitch estimation (counterpart of ``sovits_tpu/f0/crepe.py``; the
torchcrepe net that so-vits-svc's crepe predictor runs).

1024-sample frames at 16 kHz, one per hop, each normalised on the host ->
six convs (conv 1 of width 512 and stride 4, the others of width 64), each
followed by ReLU, BatchNorm and a (2, 1) max pool -> Linear(2048 -> 360) ->
sigmoid salience -> the weighted-average-cents decode on the host. The
modules carry torchcrepe's names and shapes (``conv{i}``, ``conv{i}_BN``,
``classifier``; the convs as Conv2d with (width, 1) kernels), so a
torchcrepe ``full.pth`` / ``tiny.pth`` state_dict loads strictly. The
convs are cuDNN's: the JAX package has no kernel here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dsp.audio import resample
from .base import F0Predictor, load_net

CENTS_PER_BIN = 20.0
CENTS_OFFSET = 1997.3794084376191
PITCH_BINS = 360
SAMPLE_RATE = 16000
WINDOW_SIZE = 1024


class CrepeNet(nn.Module):
    """torchcrepe's topology, "full" or "tiny" (channels / 8): normalised
    frames [B, 1024] -> salience [B, 360]."""

    def __init__(self, capacity: str = "full"):
        super().__init__()
        mult = 1 if capacity == "full" else 8
        channels = [c // mult for c in (1024, 128, 128, 128, 256, 512)]
        widths = (512, 64, 64, 64, 64, 64)
        in_ch = [1] + channels[:-1]
        for i in range(6):
            setattr(self, f"conv{i + 1}", nn.Conv2d(in_ch[i], channels[i], (widths[i], 1),
                                                     (4 if i == 0 else 1, 1)))
            # the JAX package's epsilon (torchcrepe's is 1e-3; ROADMAP.md section 3)
            setattr(self, f"conv{i + 1}_BN", nn.BatchNorm2d(channels[i], eps=1e-5))
        self.classifier = nn.Linear(channels[-1] * 4, PITCH_BINS)

    @torch.no_grad()
    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames[:, None, :, None]
        for i in range(1, 7):
            x = F.pad(x, (0, 0, 254, 254) if i == 1 else (0, 0, 31, 32))
            x = getattr(self, f"conv{i}_BN")(F.relu(getattr(self, f"conv{i}")(x)))
            x = F.max_pool2d(x, (2, 1), (2, 1))
        x = x.permute(0, 2, 1, 3).reshape(x.shape[0], -1)  # time-major, as torchcrepe
        return torch.sigmoid(self.classifier(x))


def decode_salience(salience: np.ndarray, threshold: float = 0.05):
    """salience [T, 360] -> (f0 [T], periodicity [T]): the salience-weighted
    mean bin over the argmax and the 8 bins above it (fewer at the top);
    periodicity is each frame's peak, and f0 is 0 where it is below
    ``threshold``."""
    t = salience.shape[0]
    center = salience.argmax(axis=1)
    periodicity = salience[np.arange(t), center]
    lo = np.maximum(center - 4, 0)
    f0 = np.zeros(t)
    for i in range(t):
        s = slice(lo[i], min(lo[i] + 9, PITCH_BINS))
        w = salience[i, s]
        bins = np.arange(s.start, s.stop)
        cents = CENTS_OFFSET + CENTS_PER_BIN * float((w * bins).sum() / (w.sum() + 1e-12))
        f0[i] = 10.0 * 2.0 ** (cents / 1200.0)
    f0[periodicity < threshold] = 0.0
    return f0, periodicity


def crepe_frames(wav16k: np.ndarray, p_len: int, hop16: int) -> np.ndarray:
    """One 1024-sample frame per output frame (zero padding, centred), each
    minus its mean over its std (numpy's, biased) + 1e-10; float32 [p_len, 1024]."""
    half = WINDOW_SIZE // 2
    xp = np.pad(np.asarray(wav16k, np.float32), (half, half + WINDOW_SIZE))
    idx = np.minimum(np.arange(p_len)[:, None] * hop16 + np.arange(WINDOW_SIZE)[None, :], len(xp) - 1)
    frames = xp[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)
    return frames / (frames.std(axis=1, keepdims=True) + 1e-10)


class CrepeF0Predictor(F0Predictor):
    """The CREPE predictor; the net runs on ``device`` in float32 over all
    ``p_len`` frames in one call, the decode on the host."""

    name = "crepe"

    def __init__(self, *args, weights: dict | None = None, threshold: float = 0.05,
                 capacity: str = "full", device: torch.device | str = "cuda", **kwargs):
        super().__init__(*args, **kwargs)
        self.device = torch.device(device)
        self.net = load_net(CrepeNet(capacity), weights, self.device, "CREPE")
        self.threshold = threshold

    def salience(self, wav: np.ndarray, p_len: int) -> np.ndarray:
        """Model-rate audio -> salience [p_len, 360]."""
        wav16 = resample(np.asarray(wav, np.float32), self.sampling_rate, SAMPLE_RATE)
        hop16 = int(round(self.hop_length * SAMPLE_RATE / self.sampling_rate))
        frames = torch.from_numpy(crepe_frames(wav16, p_len, hop16)).to(self.device)
        return self.net(frames).cpu().numpy()

    def raw_f0(self, wav: np.ndarray, p_len: int) -> np.ndarray:
        return decode_salience(self.salience(wav, p_len), self.threshold)[0]
