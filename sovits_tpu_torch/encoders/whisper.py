"""Whisper-PPG speech encoder (counterpart of ``sovits_tpu/encoders/whisper.py``):
openai-whisper's audio encoder with its checkpoint's parameter names, so the
``encoder.*`` entries of a ``medium.pt`` / ``large-v2.pt`` ``model_state_dict``
load directly.

16 kHz audio, padded or trimmed to 30 s -> whisper's log-mel [B, 3000, 80]
(reflect pad 200, periodic hann 400, hop 160, power spectrum with the last
frame dropped, librosa's Slaney filterbank, log10 with a floor 8 below the
maximum) -> two exact-GELU convs (the second stride 2) -> + sinusoidal
positions -> N pre-LN blocks -> ``ln_post`` -> [B, 1500, d]. The PPG is that
output cut to ``len(wav) // 320`` frames. Attention is PyTorch's
``scaled_dot_product_attention``: the JAX package has no kernel here.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dsp.mel import mel_filterbank
from ..dsp.stft import hann_window
from .factory import SpeechEncoder
from .wav2vec2 import LayerNorm

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_SAMPLES = 30 * SAMPLE_RATE


@dataclasses.dataclass(frozen=True)
class WhisperDims:
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 1024
    n_audio_head: int = 16
    n_audio_layer: int = 24


WHISPER_CONFIGS = {
    "whisper-ppg": WhisperDims(),  # medium
    "whisper-ppg-large": WhisperDims(n_audio_state=1280, n_audio_head=20, n_audio_layer=32),
    "whisper-ppg-small": WhisperDims(n_audio_state=768, n_audio_head=12, n_audio_layer=12),
}


def log_mel_spectrogram(audio: torch.Tensor) -> torch.Tensor:
    """whisper's audio.py: [B, L] -> [B, L // 160, 80] (float32)."""
    y = F.pad(audio.float()[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = y.unfold(-1, N_FFT, HOP) * hann_window(N_FFT, y.device)
    spec = torch.fft.rfft(frames, n=N_FFT, dim=-1)
    power = (spec.real**2 + spec.imag**2)[:, :-1]  # whisper drops the last frame
    fbank = torch.from_numpy(mel_filterbank(SAMPLE_RATE, N_FFT, 80, 0.0, SAMPLE_RATE / 2)).to(y.device)
    log_spec = torch.log10(torch.clamp(power @ fbank, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


class MultiHeadAttention(nn.Module):
    """q and k each scaled by head**-0.25; ``key`` has no bias."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        head = d // self.n_head
        scale = head**-0.25
        q, k, v = (proj(x).view(b, t, self.n_head, head).transpose(1, 2)
                   for proj in (self.query, self.key, self.value))
        out = F.scaled_dot_product_attention(q * scale, k * scale, v, scale=1.0)
        return self.out(out.transpose(1, 2).reshape(b, t, d))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN (eps 1e-5): attention, then the exact-GELU MLP."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head)
        self.attn_ln = LayerNorm(n_state, eps=1e-5)
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state), nn.GELU(),
                                 nn.Linear(4 * n_state, n_state))
        self.mlp_ln = LayerNorm(n_state, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_ln(x))
        return x + self.mlp(self.mlp_ln(x))


class AudioEncoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims.n_audio_state
        self.conv1 = nn.Conv1d(dims.n_mels, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        # recomputed, not loaded: the checkpoint's copy is ignored, as the
        # JAX loader ignores it
        self.register_buffer("positional_embedding",
                             torch.from_numpy(sinusoids(dims.n_audio_ctx, d)), persistent=False)
        self.blocks = nn.ModuleList(ResidualAttentionBlock(d, dims.n_audio_head)
                                    for _ in range(dims.n_audio_layer))
        self.ln_post = LayerNorm(d, eps=1e-5)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, n_mels] -> [B, T // 2, d]."""
        x = F.gelu(self.conv1(mel.transpose(1, 2)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.positional_embedding[: x.shape[1]]
        for block in self.blocks:
            x = block(x)
        return self.ln_post(x)


class WhisperEncoder(nn.Module):
    """30 s of 16 kHz audio [B, N_SAMPLES] -> [B, 1500, d]; the module
    tree is openai-whisper's ``Whisper`` with the encoder alone."""

    def __init__(self, dims: WhisperDims):
        super().__init__()
        self.dims = dims
        self.hidden_dim = dims.n_audio_state
        self.encoder = AudioEncoder(dims)

    @torch.no_grad()
    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.encoder(log_mel_spectrogram(wav))


class WhisperPPGEncoder(SpeechEncoder):
    """so-vits-svc's WhisperPPG: pad or trim to 30 s, keep ``len // 320``
    frames (at most 1500: a longer clip is trimmed, as in the JAX package)."""

    def prepare(self, wav: np.ndarray) -> tuple[np.ndarray, int]:
        n_frames = len(wav) // 320
        wav = wav[:N_SAMPLES]
        return np.pad(wav, (0, N_SAMPLES - len(wav))), n_frames


def load_whisper_encoder(name: str, path: str | Path,
                         device: torch.device | str = "cuda") -> WhisperPPGEncoder:
    """An openai-whisper checkpoint ({"dims", "model_state_dict"}): the
    encoder's entries load strictly; the decoder's are ignored."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    dims = WhisperDims(**{f.name: ckpt["dims"][f.name] for f in dataclasses.fields(WhisperDims)})
    net = WhisperEncoder(dims)
    sd = ckpt["model_state_dict"]
    net.load_state_dict({k: sd[k].float() for k in net.state_dict() if k in sd}, strict=True)
    return WhisperPPGEncoder(name, net, device)
