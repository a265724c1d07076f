"""Speech-encoder factory (counterpart of ``sovits_tpu/encoders/factory.py``).

Encoders expose ``encode(wav16k: np.ndarray [L]) -> np.ndarray [T, H]`` at
16 kHz and a 320-sample hop, and ``encode_async`` which launches the work
and returns a zero-argument function that waits for the result. The four
wav2vec2-family encoders share one topology (``wav2vec2.py``): vec768l12,
vec256l9 (9 layers and a 256-wide final projection), hubertsoft (bshall's
checkpoint layout, a 256-wide projection, 40 samples of padding either
side) and cnhubertlarge (d 1024, 24 layers, 16 heads, FFN 4096). The
other families have a module each: ``whisper.py`` (whisper-ppg, medium;
whisper-ppg-large, large-v2), ``wavlm.py`` (wavlmbase+) and ``dphubert.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from .convert import from_bshall_hubert
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder

CONFIGS = {
    "vec768l12": Wav2Vec2Config(output_layer=12),
    "vec256l9": Wav2Vec2Config(output_layer=9, final_proj_dim=256),
    "hubertsoft": Wav2Vec2Config(final_proj_dim=256),
    "cnhubertlarge": Wav2Vec2Config(d_model=1024, n_layers=24, n_heads=16, ffn_dim=4096),
}
BSHALL = {"hubertsoft"}  # checkpoints in bshall's HuBERT-soft layout; the rest are fairseq's
INPUT_PAD = {"hubertsoft": (400 - 320) // 2}  # samples either side (hubert_model.py:70)
CHECKPOINTS = {
    "vec768l12": "pretrain/checkpoint_best_legacy_500.pt",
    "vec256l9": "pretrain/checkpoint_best_legacy_500.pt",
    "hubertsoft": "pretrain/hubert-soft-0d54a1f4.pt",
    "cnhubertlarge": "pretrain/chinese-hubert-large-fairseq-ckpt.pt",
    "whisper-ppg": "pretrain/medium.pt",
    "whisper-ppg-large": "pretrain/large-v2.pt",
    "wavlmbase+": "pretrain/WavLM-Base+.pt",
    "dphubert": "pretrain/DPHuBERT-sp0.75.pth",
}


class SpeechEncoder:
    """``net`` on ``device``; ``pad`` zero samples go on either side of the
    16 kHz input before it is bucketed. ``net.hidden_dim`` is the units'
    width."""

    def __init__(self, name: str, net: nn.Module, device: torch.device | str, pad: int = 0):
        self.name = name
        self.device = torch.device(device)
        self.net = net.to(self.device).eval()
        self.hidden_dim = net.hidden_dim
        self.pad = pad

    def prepare(self, wav: np.ndarray) -> tuple[np.ndarray, int]:
        """The net's input for a float32 16 kHz clip, and the frames to keep."""
        wav = np.pad(wav, self.pad)
        n_frames = (len(wav) - 400) // 320 + 1
        # pad to a whole number of seconds, as the JAX package buckets: the
        # padding is part of what the group norm and attention see, so the
        # units only match with the same padding
        bucket = int(np.ceil(len(wav) / 16000)) * 16000
        return np.pad(wav, (0, bucket - len(wav))), n_frames

    def encode_async(self, wav16k: np.ndarray):
        wav, n_frames = self.prepare(np.asarray(wav16k, dtype=np.float32))
        with torch.no_grad():
            out = self.net(torch.from_numpy(wav[None]).to(self.device))
        return lambda: out[0, :n_frames].float().cpu().numpy()

    def encode(self, wav16k: np.ndarray) -> np.ndarray:
        return self.encode_async(wav16k)()


def load_fairseq_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """The model state_dict of a fairseq checkpoint ({'model': ...}) or of a
    plain one, float32, without a ``module.`` prefix."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict):
        ckpt = ckpt["model"]
    return {k.removeprefix("module."): v.float() for k, v in ckpt.items() if torch.is_tensor(v)}


def get_speech_encoder(name: str, checkpoint_path: str | Path | None = None,
                       device: torch.device | str = "cuda") -> SpeechEncoder:
    """Build ``name`` from its checkpoint (``CHECKPOINTS[name]`` when None),
    every encoder the JAX package builds: the wav2vec2 family (fairseq's
    layout, or bshall's for hubertsoft), whisper-ppg and whisper-ppg-large
    (openai-whisper's), wavlmbase+ (WavLM's) and dphubert (DPHuBERT's).

    The checkpoint's keys that the encoder does not use (``mask_emb``,
    ``label_embs_concat``, an unused ``final_proj``, deeper layers, whisper's
    decoder) are ignored; every key the encoder has must be present. A
    missing file raises FileNotFoundError, an ``-onnx`` variant
    NotImplementedError and an unknown name ValueError, as in the JAX
    package.
    """
    if name.endswith("-onnx"):
        raise NotImplementedError(f"onnx encoder variants are not supported; use "
                                  f"'{name.removesuffix('-onnx')}'")
    if name not in CHECKPOINTS:
        raise ValueError(f"unknown speech encoder {name!r} (available: {sorted(CHECKPOINTS)})")
    checkpoint_path = Path(checkpoint_path or CHECKPOINTS[name])
    if not checkpoint_path.exists():
        raise FileNotFoundError(f"speech-encoder checkpoint not found: {checkpoint_path}")
    if name.startswith("whisper-ppg"):
        from .whisper import load_whisper_encoder

        return load_whisper_encoder(name, checkpoint_path, device)
    if name == "wavlmbase+":
        from .wavlm import load_wavlm_encoder

        return load_wavlm_encoder(checkpoint_path, device)
    if name == "dphubert":
        from .dphubert import load_dphubert_encoder

        return load_dphubert_encoder(checkpoint_path, device)
    net = Wav2Vec2Encoder(CONFIGS[name])
    sd = load_fairseq_state_dict(checkpoint_path)
    if name in BSHALL:
        sd = from_bshall_hubert(sd)
    net.load_state_dict({k: sd[k] for k in net.state_dict() if k in sd}, strict=True)
    return SpeechEncoder(name, net, device, INPUT_PAD.get(name, 0))
