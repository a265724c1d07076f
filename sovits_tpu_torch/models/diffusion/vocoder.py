"""The diffusion vocoder: a mel-driven NSF-HiFiGAN (counterpart of
``sovits_tpu/models/diffusion/vocoder.py``; so-vits-svc
``diffusion/vocoder.py`` and ``vdecoder/nsf_hifigan``).

``extract`` computes mels at the vocoder's rate with nvSTFT's contract
(keyshift, asymmetric padding, a 1e-9 magnitude floor, log clamp 1e-5;
nvSTFT.py:71-125); ``infer`` decodes mel + f0 with the port's
``Generator`` without a speaker input (so no ``cond`` conv), its stages of
width 16-128 through the fused ResBlock trio (K3), as ``Svc`` builds its
synthesizer. The vocoder computes in float32.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ...dsp.audio import resample
from ...dsp.mel import mel_filterbank
from ...dsp.stft import hann_window
from ..nsf_hifigan import Generator


def nv_mel_spectrogram(y: torch.Tensor, sample_rate: int = 44100, n_fft: int = 2048,
                       n_mels: int = 128, hop_length: int = 512, win_length: int = 2048,
                       fmin: float = 40.0, fmax: float = 16000.0,
                       keyshift: float = 0.0) -> torch.Tensor:
    """nvSTFT.get_mel: audio [B, L] -> log-mel [B, T, M] (float32).

    keyshift scales the analysis window by 2^(keyshift/12) and renormalises
    the bins (pitch augmentation for diffusion training)."""
    factor = 2 ** (keyshift / 12.0)
    n_fft_new = int(np.round(n_fft * factor))
    win_new = int(np.round(win_length * factor))
    hop_new = int(np.round(hop_length * factor))

    y = y.float()
    pad_left = (win_new - hop_new) // 2
    pad_right = max((win_new - hop_new + 1) // 2, win_new - y.shape[-1] - pad_left)
    mode = "reflect" if pad_right < y.shape[-1] else "constant"
    y = F.pad(y[:, None], (pad_left, pad_right), mode=mode)[:, 0]

    frames = y.unfold(-1, win_new, hop_new) * hann_window(win_new, y.device)  # [B, T, win_new]
    spec = torch.fft.rfft(frames, n=n_fft_new, dim=-1)
    mag = torch.sqrt(spec.real**2 + spec.imag**2 + 1e-9)
    if keyshift != 0:
        size = n_fft // 2 + 1
        if mag.shape[-1] < size:
            mag = F.pad(mag, (0, size - mag.shape[-1]))
        mag = mag[..., :size] * (win_length / win_new)
    fbank = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)).to(y.device)
    return torch.log(torch.clamp(mag @ fbank, min=1e-5))


DEFAULT_NSF_CONFIG = {
    # the published 44.1 kHz community nsf_hifigan checkpoint's config
    "sampling_rate": 44100,
    "num_mels": 128,
    "n_fft": 2048,
    "win_size": 2048,
    "hop_size": 512,
    "fmin": 40,
    "fmax": 16000,
    "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "upsample_rates": [8, 8, 2, 2, 2],
    "upsample_initial_channel": 512,
    "upsample_kernel_sizes": [16, 16, 4, 4, 4],
}


def build_generator(h: dict, device) -> Generator:
    """The mel -> wav NSF-HiFiGAN of config ``h``, without a speaker input,
    with the fused tail."""
    return Generator(
        sampling_rate=h["sampling_rate"], inter_channels=h["num_mels"],
        resblock_kernel_sizes=h["resblock_kernel_sizes"],
        resblock_dilation_sizes=h["resblock_dilation_sizes"],
        upsample_rates=h["upsample_rates"], upsample_initial_channel=h["upsample_initial_channel"],
        upsample_kernel_sizes=h["upsample_kernel_sizes"], gin_channels=0, fused_tail=True,
        resblock=str(h["resblock"]),
    ).to(device).eval()


class NsfHifiGANVocoder:
    """A pretrained mel -> wav NSF-HiFiGAN (vocoder.type 'nsf-hifigan').

    ``ckpt_path`` is a so-vits-svc vocoder checkpoint ({"generator":
    state_dict}); a ``config.json`` beside it overrides the defaults, and
    ``config`` overrides both (vdecoder/nsf_hifigan/models.py:17-36). The
    weights load on first use: ``extract`` needs only the config. A missing
    checkpoint raises FileNotFoundError, as in so-vits-svc (the JAX package
    falls back to a fresh init instead), unless ``weights`` is False: the
    mel analysis alone, for preprocessing, which needs no weights file."""

    def __init__(self, ckpt_path: str | None, config: dict | None = None,
                 device: torch.device | str = "cuda", weights: bool = True):
        if weights and (not ckpt_path or not Path(ckpt_path).is_file()):
            raise FileNotFoundError(f"no vocoder checkpoint at {ckpt_path}")
        self.h = dict(DEFAULT_NSF_CONFIG)
        cfg = Path(ckpt_path).parent / "config.json" if ckpt_path else None
        if cfg is not None and cfg.exists():
            self.h.update(json.loads(cfg.read_text()))
        if config:
            self.h.update(config)
        self.device = torch.device(device)
        self._ckpt_path = ckpt_path
        self._net: Generator | None = None

    @property
    def net(self) -> Generator:
        if self._net is None:
            net = build_generator(self.h, self.device)
            ckpt = torch.load(self._ckpt_path, map_location="cpu", weights_only=False)
            net.load_state_dict({k: v.float() for k, v in ckpt["generator"].items()}, strict=True)
            self._net = net
        return self._net

    @property
    def sample_rate(self) -> int:
        return self.h["sampling_rate"]

    @property
    def hop_size(self) -> int:
        return self.h["hop_size"]

    @property
    def dimension(self) -> int:
        return self.h["num_mels"]

    def extract(self, audio: np.ndarray, sample_rate: int, keyshift: float = 0.0) -> torch.Tensor:
        """audio [B, L] at ``sample_rate`` -> log-mel [B, T, M] at the
        vocoder's rate, on the vocoder's device."""
        audio = np.asarray(audio, np.float32)
        if sample_rate != self.sample_rate:
            audio = resample(audio, sample_rate, self.sample_rate)
        h = self.h
        return nv_mel_spectrogram(torch.from_numpy(audio).to(self.device), self.sample_rate,
                                  h["n_fft"], h["num_mels"], h["hop_size"], h["win_size"],
                                  h["fmin"], h["fmax"], keyshift)

    @torch.no_grad()
    def infer(self, mel: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        """mel [B, T, M] + f0 [B, T] Hz -> wav [B, 1, T * hop] (float32)."""
        return self.net(mel.float().transpose(1, 2), f0[:, : mel.shape[1]].float())
