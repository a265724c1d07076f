"""NSF-HiFiGAN output enhancer (counterpart of ``sovits_tpu/infer/enhancer.py``;
so-vits-svc ``modules/enhancer.py``).

Re-vocodes the synthesizer's output through the mel vocoder: the mel is
taken at an adaptively shifted rate (``adaptive_key`` shifts the formants
by 2^(-key/12)), decoded with the true f0, and resampled back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.audio import resample
from ..models.diffusion.vocoder import NsfHifiGANVocoder


class Enhancer:
    def __init__(self, enhancer_type: str = "nsf-hifigan", ckpt: str | None = None,
                 config: dict | None = None, device: torch.device | str = "cuda"):
        if enhancer_type != "nsf-hifigan":
            raise ValueError(f"unknown enhancer: {enhancer_type}")
        self.vocoder = NsfHifiGANVocoder(ckpt, config=config, device=device)

    def enhance(self, audio: np.ndarray, sample_rate: int, f0: np.ndarray, hop_size: int,
                adaptive_key: float = 0, silence_front: float = 0) -> tuple[np.ndarray, int]:
        """audio [L] at ``sample_rate`` with its f0 [n_frames] at
        ``hop_size`` -> (enhanced audio, the vocoder's rate)."""
        enh_sr = self.vocoder.sample_rate
        enh_hop = self.vocoder.hop_size

        start_frame = int(silence_front * sample_rate / hop_size)
        real_silence_front = start_frame * hop_size / sample_rate
        audio = audio[int(np.round(real_silence_front * sample_rate)):]
        f0 = np.asarray(f0, np.float64)[start_frame:]

        adaptive_factor = 2.0 ** (-adaptive_key / 12.0)
        adaptive_sr = 100 * int(np.round(enh_sr / adaptive_factor / 100))
        real_factor = enh_sr / adaptive_sr

        audio_res = audio if sample_rate == adaptive_sr else resample(audio, sample_rate, adaptive_sr)
        n_frames = int(len(audio_res) // enh_hop + 1)

        f0_scaled = f0 * real_factor
        time_org = (hop_size / sample_rate) * np.arange(len(f0_scaled)) / real_factor
        time_frame = (enh_hop / enh_sr) * np.arange(n_frames)
        f0_res = np.interp(time_frame, time_org, f0_scaled, left=f0_scaled[0],
                           right=f0_scaled[-1]).astype(np.float32)

        # The adaptive-rate audio is analysed AS IF at the enhancer's rate:
        # that mismatch is the formant shift (enhancer.py:80-105), so no
        # resample happens here.
        mel = self.vocoder.extract(audio_res[None], self.vocoder.sample_rate)
        out = self.vocoder.infer(mel, torch.from_numpy(f0_res[None]).to(self.vocoder.device))
        enhanced = out[0, 0].cpu().numpy()

        if adaptive_sr != enh_sr:
            enhanced = resample(enhanced, adaptive_sr, enh_sr)
        if start_frame > 0:
            enhanced = np.pad(enhanced, (int(np.round(enh_sr * real_silence_front)), 0))
        return enhanced, enh_sr
