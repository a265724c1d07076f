"""Configuration: so-vits-svc's JSON schema with attribute access (the
port's copy of ``sovits_tpu/config.py``).

A reference user's config.json loads unchanged. ``synthesizer_kwargs`` maps
a config to the JAX package's Synthesizer keyword names; the port's
factory picks out what it builds.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any


class HParams:
    """Recursive attribute-access dict (utils.py:514-547 equivalent)."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if isinstance(v, dict):
                v = HParams(**v)
            self.__dict__[k] = v

    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def values(self):
        return self.__dict__.values()

    def get(self, key, default=None):
        return self.__dict__.get(key, default)

    def __getitem__(self, key):
        return self.__dict__[key]

    def __setitem__(self, key, value):
        self.__dict__[key] = value

    def __contains__(self, key):
        return key in self.__dict__

    def __len__(self):
        return len(self.__dict__)

    def __repr__(self):
        return repr(self.__dict__)

    def __getattr__(self, key):
        # missing keys resolve to None (InferHParams back-compat semantics,
        # utils.py:549-557)
        return None

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.__dict__.items():
            out[k] = v.to_dict() if isinstance(v, HParams) else v
        return out


# Default training/model config — same schema and values as the reference's
# configs_template/config_template.json.
DEFAULT_CONFIG: dict[str, Any] = {
    "train": {
        "log_interval": 200,
        "eval_interval": 800,
        "seed": 1234,
        "epochs": 10000,
        "learning_rate": 1e-4,
        "betas": [0.8, 0.99],
        "eps": 1e-9,
        "batch_size": 6,
        "fp16_run": False,
        "half_type": "bf16",
        "lr_decay": 0.999875,
        "segment_size": 10240,
        "init_lr_ratio": 1,
        "warmup_epochs": 0,
        "c_mel": 45,
        "c_kl": 1.0,
        "use_sr": True,
        "max_speclen": 512,
        "port": "8001",
        "keep_ckpts": 3,
        "all_in_mem": False,
        "vol_aug": False,
    },
    "data": {
        "training_files": "filelists/train.txt",
        "validation_files": "filelists/val.txt",
        "max_wav_value": 32768.0,
        "sampling_rate": 44100,
        "filter_length": 2048,
        "hop_length": 512,
        "win_length": 2048,
        "n_mel_channels": 80,
        "mel_fmin": 0.0,
        "mel_fmax": 22050,
        "unit_interpolate_mode": "nearest",
        # fixed padded frame length per training batch (static shapes)
        "pad_to_frames": 800,
    },
    "model": {
        "inter_channels": 192,
        "hidden_channels": 192,
        "filter_channels": 768,
        "n_heads": 2,
        "n_layers": 6,
        "kernel_size": 3,
        "p_dropout": 0.1,
        "resblock": "1",
        "resblock_kernel_sizes": [3, 7, 11],
        "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
        "upsample_rates": [8, 8, 2, 2, 2],
        "upsample_initial_channel": 512,
        "upsample_kernel_sizes": [16, 16, 4, 4, 4],
        "n_layers_q": 3,
        "n_layers_trans_flow": 3,
        "n_flow_layer": 4,
        "use_spectral_norm": False,
        "gin_channels": 768,
        "ssl_dim": 768,
        "n_speakers": 200,
        "vocoder_name": "nsf-hifigan",
        "speech_encoder": "vec768l12",
        "speaker_embedding": False,
        "vol_embedding": False,
        "use_depthwise_conv": False,
        "flow_share_parameter": False,
        "use_automatic_f0_prediction": True,
        "use_transformer_flow": False,
    },
    "spk": {},
}

# encoder name -> (ssl_dim, gin override) wiring mirror of
# preprocess_flist_config.py:96-107
ENCODER_DIMS = {
    "vec768l12": 768,
    "vec256l9": 256,
    "hubertsoft": 256,
    "whisper-ppg": 1024,
    "cnhubertlarge": 1024,
    "dphubert": 768,
    "whisper-ppg-large": 1280,
    "wavlmbase+": 768,
}


def default_config(**overrides) -> HParams:
    cfg = json.loads(json.dumps(DEFAULT_CONFIG))  # deep copy
    for dotted, value in overrides.items():
        node = cfg
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value
    return HParams(**cfg)


def load_config(path: str | Path) -> HParams:
    with open(path) as f:
        return HParams(**json.load(f))


def save_config(hps: HParams, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(hps.to_dict(), f, indent=2)


def tiny_config(**overrides) -> HParams:
    """The 'tiny' variant (so-vits-svc's config_tiny_template.json): filter
    512, upsample_initial 400, depthwise convs, shared flow parameters."""
    cfg = default_config(**overrides)
    cfg.model["filter_channels"] = 512
    cfg.model["upsample_initial_channel"] = 400
    cfg.model["use_depthwise_conv"] = True
    cfg.model["flow_share_parameter"] = True
    return cfg


def synthesizer_kwargs(hps: HParams) -> dict:
    """Map a config to Synthesizer constructor kwargs."""
    m = hps.model
    d = hps.data
    return dict(
        spec_channels=d.filter_length // 2 + 1,
        segment_size=hps.train.segment_size // d.hop_length,
        inter_channels=m.inter_channels,
        hidden_channels=m.hidden_channels,
        filter_channels=m.filter_channels,
        n_heads=m.n_heads,
        n_layers=m.n_layers,
        kernel_size=m.kernel_size,
        p_dropout=m.p_dropout,
        resblock=m.resblock,
        resblock_kernel_sizes=tuple(m.resblock_kernel_sizes),
        resblock_dilation_sizes=tuple(map(tuple, m.resblock_dilation_sizes)),
        upsample_rates=tuple(m.upsample_rates),
        upsample_initial_channel=m.upsample_initial_channel,
        upsample_kernel_sizes=tuple(m.upsample_kernel_sizes),
        gin_channels=m.gin_channels,
        ssl_dim=m.ssl_dim,
        n_speakers=m.n_speakers,
        sampling_rate=d.sampling_rate,
        vol_embedding=bool(m.vol_embedding),
        use_depthwise_conv=bool(m.use_depthwise_conv),
        use_automatic_f0_prediction=bool(m.use_automatic_f0_prediction),
        flow_share_parameter=bool(m.flow_share_parameter),
        n_flow_layer=m.n_flow_layer,
        n_layers_trans_flow=m.n_layers_trans_flow,
        use_transformer_flow=bool(m.use_transformer_flow),
        n_layers_q=m.get("n_layers_posterior", 16),
        vocoder_name=m.vocoder_name or "nsf-hifigan",
    )
