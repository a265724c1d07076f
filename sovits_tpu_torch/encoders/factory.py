"""Speech-encoder factory (counterpart of ``sovits_tpu/encoders/factory.py``).

Encoders expose ``encode(wav16k: np.ndarray [L]) -> np.ndarray [T, H]`` at
16 kHz and a 320-sample hop, and ``encode_async`` which launches the work
and returns a zero-argument function that waits for the result.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder

CONFIGS = {"vec768l12": Wav2Vec2Config(output_layer=12)}


class SpeechEncoder:
    def __init__(self, name: str, net: Wav2Vec2Encoder, device: torch.device | str):
        self.name = name
        self.device = torch.device(device)
        self.net = net.to(self.device).eval()
        self.hidden_dim = net.cfg.final_proj_dim or net.cfg.d_model

    def encode_async(self, wav16k: np.ndarray):
        wav = np.asarray(wav16k, dtype=np.float32)
        n_frames = (len(wav) - 400) // 320 + 1
        # pad to a whole number of seconds, as the JAX package buckets: the
        # padding is part of what the group norm and attention see, so the
        # units only match with the same padding
        bucket = int(np.ceil(len(wav) / 16000)) * 16000
        wav = np.pad(wav, (0, bucket - len(wav)))
        out = self.net(torch.from_numpy(wav[None]).to(self.device))
        return lambda: out[0, :n_frames].float().cpu().numpy()

    def encode(self, wav16k: np.ndarray) -> np.ndarray:
        return self.encode_async(wav16k)()


def load_fairseq_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """The model state_dict of a fairseq checkpoint ({'model': ...})."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict):
        ckpt = ckpt["model"]
    return {k.removeprefix("module."): v.float() for k, v in ckpt.items() if torch.is_tensor(v)}


def get_speech_encoder(name: str, checkpoint_path: str | Path | None = None,
                       device: torch.device | str = "cuda") -> SpeechEncoder:
    """Build ``name`` from a fairseq HuBERT/ContentVec checkpoint.

    The checkpoint's keys that the encoder does not use (``mask_emb``,
    ``label_embs_concat``, ``final_proj``, deeper layers) are ignored;
    every key the encoder has must be present.
    """
    if name not in CONFIGS:
        raise NotImplementedError(f"speech encoder {name!r} is not supported by the port "
                                  f"(available: {sorted(CONFIGS)})")
    checkpoint_path = Path(checkpoint_path or "pretrain/checkpoint_best_legacy_500.pt")
    if not checkpoint_path.exists():
        raise FileNotFoundError(f"speech-encoder checkpoint not found: {checkpoint_path}")
    net = Wav2Vec2Encoder(CONFIGS[name])
    sd = load_fairseq_state_dict(checkpoint_path)
    net.load_state_dict({k: sd[k] for k in net.state_dict() if k in sd}, strict=True)
    return SpeechEncoder(name, net, device)
