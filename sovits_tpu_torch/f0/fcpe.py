"""FCPE pitch estimation (counterpart of ``sovits_tpu/f0/fcpe.py``;
so-vits-svc ``modules/F0Predictor/fcpe``).

nvSTFT log-mel at 16 kHz (128 bins, hop 160) -> conv stack (conv, GroupNorm(4),
leaky ReLU, conv) -> PCmer layers (performer softmax-kernel linear attention
and a conformer conv module) -> LayerNorm -> weight-normed Linear(360) ->
sigmoid salience -> the local-argmax cents decode on the host. The modules
carry the names of the published ``fcpe.pt`` (``FCPE``), its performer
projection matrices and cent-table buffers included, so its state_dict
loads strictly. Matmuls and convs are cuBLAS's and cuDNN's: the JAX package
has no kernel here.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dsp.audio import resample
from ..nn.conv import WeightNormed
from .base import F0Predictor, load_net

SAMPLE_RATE = 16000
HOP = 160


def softmax_kernel(data: torch.Tensor, projection: torch.Tensor, is_query: bool,
                   eps: float = 1e-4) -> torch.Tensor:
    """Performer FAVOR+ feature map (pcmer.py:12-45): the query map takes
    each row's max out of the exponent, the key map adds ``eps`` inside it."""
    normalizer = data.shape[-1] ** -0.25
    ratio = projection.shape[0] ** -0.5
    data_dash = torch.einsum("...id,jd->...ij", normalizer * data, projection)
    diag = (data**2).sum(-1, keepdim=True) / 2.0 * normalizer**2
    if is_query:
        return ratio * (torch.exp(data_dash - diag - data_dash.amax(-1, keepdim=True)) + eps)
    return ratio * torch.exp(data_dash - diag + eps)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal linear attention (pcmer.py:209-224)."""
    d_inv = 1.0 / (torch.einsum("...nd,...d->...n", q, k.sum(-2)) + 1e-8)
    context = torch.einsum("...nd,...ne->...de", k, v)
    return torch.einsum("...de,...nd,...n->...ne", context, q, d_inv)


class FastAttention(nn.Module):
    def __init__(self, dim_head: int):
        super().__init__()
        nb_features = int(dim_head * math.log(dim_head))
        self.register_buffer("projection_matrix", torch.randn(nb_features, dim_head))


class FastSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.fast_attention = FastAttention(dim_head)
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        q, k, v = (proj(x).view(b, t, self.heads, self.dim_head).transpose(1, 2)
                   for proj in (self.to_q, self.to_k, self.to_v))
        projection = self.fast_attention.projection_matrix
        out = linear_attention(softmax_kernel(q, projection, is_query=True),
                               softmax_kernel(k, projection, is_query=False), v)
        return self.to_out(out.transpose(1, 2).reshape(b, t, -1))


class _Transpose(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2)


class _GatedLinear(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = x.chunk(2, dim=1)
        return a * torch.sigmoid(gate)


class DepthWiseConv1d(nn.Module):
    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, kernel_size, padding=kernel_size // 2,
                              groups=channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ConformerConvModule(nn.Module):
    """LayerNorm, pointwise conv to 2 x inner, GLU, depthwise conv (k 31),
    swish, pointwise conv back; ``net`` indices as the checkpoint's."""

    def __init__(self, dim: int, expansion: int = 2, kernel_size: int = 31):
        super().__init__()
        inner = dim * expansion
        self.net = nn.Sequential(nn.LayerNorm(dim, eps=1e-5), _Transpose(), nn.Conv1d(dim, 2 * inner, 1),
                                 _GatedLinear(), DepthWiseConv1d(inner, kernel_size), nn.SiLU(),
                                 nn.Conv1d(inner, dim, 1), _Transpose())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class PCmerLayer(nn.Module):
    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = FastSelfAttention(dim, heads)
        self.conformer = ConformerConvModule(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm(x))
        return x + self.conformer(x)


class PCmer(nn.Module):
    def __init__(self, n_layers: int, dim: int):
        super().__init__()
        self._layers = nn.ModuleList(PCmerLayer(dim) for _ in range(n_layers))


class WNLinear(WeightNormed):
    """weight_norm(nn.Linear): weight_g [out, 1] over weight_v [out, in]."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__((out_features, in_features), out_features, True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.effective_weight(), self.bias)


def cent_table(f0_min: float, f0_max: float, out_dims: int) -> np.ndarray:
    """The bins' cents, evenly from f0_min to f0_max (float64 ends, float32)."""
    lo, hi = (1200.0 * np.log2(f / 10.0) for f in (f0_min, f0_max))
    return np.linspace(lo, hi, out_dims).astype(np.float32)


class FcpeNet(nn.Module):
    """log-mel [B, T, 128] -> salience [B, T, out_dims]."""

    def __init__(self, input_channel: int = 128, out_dims: int = 360, n_layers: int = 12,
                 n_chans: int = 512, f0_min: float = 32.70, f0_max: float = 1975.5):
        super().__init__()
        self.f0_min, self.f0_max = f0_min, f0_max
        # the reference's buffers, kept for the checkpoint's keys. They follow
        # f0_min and f0_max: a loaded state_dict cannot put back a table for
        # other limits (the JAX package computes its table from the
        # arguments and never reads the checkpoint's)
        self.register_buffer("cent_table", torch.empty(out_dims))
        self.register_buffer("gaussian_blurred_cent_mask", torch.empty(()))
        self._set_range_buffers()
        self.register_load_state_dict_post_hook(lambda module, _keys: module._set_range_buffers())
        self.stack = nn.Sequential(nn.Conv1d(input_channel, n_chans, 3, padding=1),
                                   nn.GroupNorm(4, n_chans, eps=1e-5), nn.LeakyReLU(0.01),
                                   nn.Conv1d(n_chans, n_chans, 3, padding=1))
        self.decoder = PCmer(n_layers, n_chans)
        self.norm = nn.LayerNorm(n_chans, eps=1e-5)
        self.dense_out = WNLinear(n_chans, out_dims)

    @torch.no_grad()
    def _set_range_buffers(self) -> None:
        self.cent_table.copy_(torch.from_numpy(cent_table(self.f0_min, self.f0_max,
                                                          self.cent_table.shape[0])))
        self.gaussian_blurred_cent_mask.fill_(1200.0 * math.log2(self.f0_max / 10.0))

    @torch.no_grad()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.stack(mel.transpose(1, 2)).transpose(1, 2)
        for layer in self.decoder._layers:
            x = layer(x)
        return torch.sigmoid(self.dense_out(self.norm(x)))


def cents_local_decoder(y: np.ndarray, table: np.ndarray, threshold: float = 0.05) -> np.ndarray:
    """salience [T, N] -> f0 [T] (model.py:135-152): the weighted mean of
    the cents over the argmax +- 4 bins; 0 where the peak is at most
    ``threshold``."""
    t, n = y.shape
    center = y.argmax(axis=1)
    idx = np.clip(center[:, None] + np.arange(-4, 5)[None, :], 0, n - 1)
    sal = y[np.arange(t)[:, None], idx]
    cents = (table[idx] * sal).sum(1) / (sal.sum(1) + 1e-12)
    f0 = 10.0 * 2.0 ** (cents / 1200.0)
    f0[y.max(axis=1) <= threshold] = 0.0
    return f0


def fcpe_mel(audio16k: torch.Tensor) -> torch.Tensor:
    """16 kHz audio [B, L] -> the nvSTFT log-mel [B, T, 128] (n_fft and
    window 1024, hop 160, 0 to 8 kHz)."""
    from ..models.diffusion.vocoder import nv_mel_spectrogram

    return nv_mel_spectrogram(audio16k, SAMPLE_RATE, 1024, 128, HOP, 1024, 0.0, 8000.0)


class FcpeF0Predictor(F0Predictor):
    """The FCPE predictor (FCPEF0Predictor.py:12-108 contract); the net runs
    on ``device`` in float32, the decode on the host."""

    name = "fcpe"

    def __init__(self, *args, weights: dict | None = None, threshold: float = 0.05,
                 f0_min_model: float = 32.70, f0_max_model: float = 1975.5,
                 device: torch.device | str = "cuda", **kwargs):
        super().__init__(*args, **kwargs)
        self.device = torch.device(device)
        self.net = load_net(FcpeNet(f0_min=f0_min_model, f0_max=f0_max_model), weights,
                            self.device, "FCPE")
        self.threshold = threshold
        self.table = self.net.cent_table.cpu().numpy()

    def salience(self, wav16k: np.ndarray) -> np.ndarray:
        """16 kHz audio -> salience [T, 360] on the 10 ms grid."""
        mel = fcpe_mel(torch.from_numpy(np.asarray(wav16k, np.float32)[None]).to(self.device))
        return self.net(mel)[0].cpu().numpy()

    def raw_f0(self, wav: np.ndarray, p_len: int) -> np.ndarray:
        salience = self.salience(resample(np.asarray(wav, np.float32), self.sampling_rate, SAMPLE_RATE))
        f0 = cents_local_decoder(salience, self.table, self.threshold)
        t_in = np.arange(len(f0)) * HOP / SAMPLE_RATE
        t_out = np.arange(p_len) * self.hop_length / self.sampling_rate
        out = np.interp(t_out, t_in, f0)
        out[np.interp(t_out, t_in, (f0 > 0).astype(np.float64)) < 0.5] = 0.0
        return out
