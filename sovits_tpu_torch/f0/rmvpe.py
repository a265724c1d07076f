"""RMVPE pitch estimation (counterpart of ``sovits_tpu/f0/rmvpe.py``;
so-vits-svc ``modules/F0Predictor/rmvpe``).

HTK log-mel (128 bins, 30 Hz to 8 kHz, hop 160 at 16 kHz) -> residual conv
U-Net (5 encoder levels with 2x2 average pools, 4 intermediate levels, 5
decoder levels through 3x3 stride-2 transposed convs) -> a 3-channel conv ->
BiGRU(384 -> 2 x 256) -> Linear(512 -> 360) -> sigmoid salience -> the
local-average-cents decode on the host. The modules carry the names of the
published ``rmvpe.pt`` (``E2E0``), so its state_dict loads strictly.
The convs and the GRU are cuDNN's: the JAX package has no kernel here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dsp.audio import resample
from ..dsp.mel import mel_filterbank
from ..dsp.stft import hann_window
from .base import F0Predictor, load_net

SAMPLE_RATE = 16000
N_CLASS = 360
N_MELS = 128
MEL_FMIN = 30
MEL_FMAX = SAMPLE_RATE // 2
WINDOW_LENGTH = 1024
HOP = 160
CENTS_CONST = 1997.3794084376191


def rmvpe_mel(audio: torch.Tensor) -> torch.Tensor:
    """16 kHz audio [B, L] -> log-mel [B, T, 128] (float32): reflect pad,
    periodic Hann 1024, hop 160, |rfft| as sqrt(re^2 + im^2), HTK mel."""
    y = F.pad(audio.float()[:, None], (WINDOW_LENGTH // 2, WINDOW_LENGTH // 2), mode="reflect")[:, 0]
    frames = y.unfold(-1, WINDOW_LENGTH, HOP) * hann_window(WINDOW_LENGTH, y.device)
    spec = torch.fft.rfft(frames, dim=-1)
    mag = torch.sqrt(spec.real**2 + spec.imag**2)
    fbank = mel_filterbank(SAMPLE_RATE, WINDOW_LENGTH, N_MELS, MEL_FMIN, MEL_FMAX, htk=True)
    return torch.log(torch.clamp(mag @ torch.from_numpy(fbank).to(y.device), min=1e-5))


class ConvBlockRes(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(),
        )
        self.shortcut = nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) + (x if self.shortcut is None else self.shortcut(x))


class ResEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_blocks: int, pool: bool):
        super().__init__()
        self.conv = nn.ModuleList(ConvBlockRes(in_channels if i == 0 else out_channels, out_channels)
                                  for i in range(n_blocks))
        self.pool = pool

    def forward(self, x: torch.Tensor):
        for block in self.conv:
            x = block(x)
        return (x, F.avg_pool2d(x, 2)) if self.pool else x


class ResDecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_blocks: int):
        super().__init__()
        # an exact 2x upsampling: k 3, stride 2, padding 1, output padding 1
        self.conv1 = nn.Sequential(
            nn.ConvTranspose2d(in_channels, out_channels, 3, stride=2, padding=1, output_padding=1,
                               bias=False),
            nn.BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(),
        )
        self.conv2 = nn.ModuleList(ConvBlockRes(2 * out_channels if i == 0 else out_channels,
                                                out_channels) for i in range(n_blocks))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = torch.cat([self.conv1(x), skip], dim=1)
        for block in self.conv2:
            x = block(x)
        return x


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Encoder(_Layers):
    def __init__(self, layers, in_channels: int):
        super().__init__(layers)
        self.bn = nn.BatchNorm2d(in_channels, eps=1e-5)


class DeepUnet(nn.Module):
    def __init__(self, n_blocks: int, en_de_layers: int, inter_layers: int, en_out_channels: int):
        super().__init__()
        chans = [1] + [en_out_channels << i for i in range(en_de_layers + 1)]
        self.encoder = Encoder([ResEncoderBlock(chans[i], chans[i + 1], n_blocks, True)
                                for i in range(en_de_layers)], 1)
        top = chans[en_de_layers + 1]
        self.intermediate = _Layers([ResEncoderBlock(chans[en_de_layers] if i == 0 else top, top,
                                                     n_blocks, False) for i in range(inter_layers)])
        self.decoder = _Layers([ResDecoderBlock(chans[i + 1], chans[i], n_blocks)
                                for i in range(en_de_layers, 0, -1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.encoder.bn(x)
        skips = []
        for layer in self.encoder.layers:
            skip, x = layer(x)
            skips.append(skip)
        for layer in self.intermediate.layers:
            x = layer(x)
        for layer, skip in zip(self.decoder.layers, reversed(skips)):
            x = layer(x, skip)
        return x


class BiGRU(nn.Module):
    def __init__(self, input_features: int, hidden_features: int):
        super().__init__()
        self.gru = nn.GRU(input_features, hidden_features, batch_first=True, bidirectional=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gru(x)[0]


class RmvpeNet(nn.Module):
    """E2E0(4, 1, (2, 2)): log-mel [B, T, 128] (T a multiple of 32) ->
    salience [B, T, 360]."""

    def __init__(self, n_blocks: int = 4, en_de_layers: int = 5, inter_layers: int = 4,
                 en_out_channels: int = 16, gru_hidden: int = 256):
        super().__init__()
        self.unet = DeepUnet(n_blocks, en_de_layers, inter_layers, en_out_channels)
        self.cnn = nn.Conv2d(en_out_channels, 3, 3, padding=1)
        self.fc = nn.Sequential(BiGRU(3 * N_MELS, gru_hidden), nn.Linear(2 * gru_hidden, N_CLASS),
                                nn.Dropout(0.25), nn.Sigmoid())

    @torch.no_grad()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.cnn(self.unet(mel[:, None]))  # [B, 3, T, 128]
        return self.fc(x.transpose(1, 2).flatten(-2))


def to_local_average_cents(salience: np.ndarray, thred: float = 0.05) -> np.ndarray:
    """salience [T, 360] -> cents [T]: the salience-weighted mean over the
    9 bins around each frame's peak (rmvpe/utils.py:64-88); 0 where the
    peak is at most ``thred``."""
    mapping = 20.0 * np.arange(N_CLASS) + CENTS_CONST
    t = salience.shape[0]
    center = salience.argmax(axis=1)
    starts = np.clip(center - 4, 0, N_CLASS - 9)
    idx = starts[:, None] + np.arange(9)[None, :]
    window = salience[np.arange(t)[:, None], idx]
    cents = (window * mapping[idx]).sum(axis=1) / (window.sum(axis=1) + 1e-12)
    cents[salience.max(axis=1) <= thred] = 0.0
    return cents


class RmvpeF0Predictor(F0Predictor):
    """The RMVPE predictor (RMVPEF0Predictor.py:12-107 contract); the net runs
    on ``device`` in float32, the decode on the host."""

    name = "rmvpe"

    def __init__(self, *args, weights: dict | None = None, threshold: float = 0.03,
                 device: torch.device | str = "cuda", **kwargs):
        super().__init__(*args, **kwargs)
        self.device = torch.device(device)
        self.net = load_net(RmvpeNet(), weights, self.device, "RMVPE")
        self.threshold = threshold

    def salience(self, wav16k: np.ndarray) -> np.ndarray:
        """16 kHz audio -> salience [T, 360] on the 10 ms grid; the log-mel
        is zero-padded (in the log domain) to a multiple of 32 frames."""
        mel = rmvpe_mel(torch.from_numpy(np.asarray(wav16k, np.float32)[None]).to(self.device))
        n_frames = mel.shape[1]
        mel = F.pad(mel, (0, 0, 0, -n_frames % 32))
        return self.net(mel)[0, :n_frames].cpu().numpy()

    def raw_f0(self, wav: np.ndarray, p_len: int) -> np.ndarray:
        salience = self.salience(resample(np.asarray(wav, np.float32), self.sampling_rate, SAMPLE_RATE))
        cents = to_local_average_cents(salience, self.threshold)
        f0 = np.where(cents > 0, 10.0 * 2.0 ** (cents / 1200.0), 0.0)
        # from the 10 ms grid onto hop frames, with the voiced track
        t_rm = np.arange(len(f0)) * HOP / SAMPLE_RATE
        t_out = np.arange(p_len) * self.hop_length / self.sampling_rate
        out = np.interp(t_out, t_rm, f0)
        out[np.interp(t_out, t_rm, (f0 > 0).astype(np.float64)) < 0.5] = 0.0
        return out
