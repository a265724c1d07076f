"""The diffusion model's configuration and loading (counterpart of the
loading half of ``sovits_tpu/train/diffusion.py``; so-vits-svc
``diffusion/unit2mel.py::load_model_vocoder``).

The config schema is so-vits-svc's ``configs_template/diffusion_template
.yaml``, merged over :data:`DIFFUSION_DEFAULTS`. A model loads from a
so-vits-svc checkpoint ({"model": state_dict}) or from the ``.npz`` of
flattened flax params that the JAX package's diffusion trainer writes.
The diffusion trainer itself is not ported yet.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import torch

from ..config import HParams
from ..models.diffusion import Unit2Mel

DIFFUSION_DEFAULTS = {
    "data": {
        "sampling_rate": 44100,
        "block_size": 512,
        "duration": 2,
        "encoder": "vec768l12",
        "encoder_sample_rate": 16000,
        "encoder_hop_size": 320,
        "encoder_out_channels": 768,
        "training_files": "filelists/train.txt",
        "validation_files": "filelists/val.txt",
        "unit_interpolate_mode": "nearest",
    },
    "model": {
        "type": "Diffusion",
        "n_layers": 20,
        "n_chans": 512,
        "n_hidden": 256,
        "use_pitch_aug": True,
        "timesteps": 1000,
        "k_step_max": 0,
        "n_spk": 1,
    },
    "vocoder": {"type": "nsf-hifigan", "ckpt": "pretrain/nsf_hifigan/model"},
    "infer": {"speedup": 10, "method": "dpm-solver++"},
    "env": {"expdir": "logs/44k/diffusion"},
    "train": {
        "batch_size": 48,
        "epochs": 100000,
        "interval_log": 10,
        "interval_val": 2000,
        "interval_force_save": 5000,
        "lr": 1e-4,
        "decay_step": 100000,
        "gamma": 0.5,
        "weight_decay": 0,
        "cache_all_data": True,
    },
    "spk": {},
}


def load_diffusion_config(path: str | Path) -> HParams:
    """A diffusion config merged over the defaults. JSON text (valid YAML)
    is read with ``json``; other YAML needs PyYAML, and without it this
    raises ImportError."""
    text = Path(path).read_text()
    try:
        loaded = json.loads(text)
    except json.JSONDecodeError:
        import yaml

        loaded = yaml.safe_load(text)
    cfg = copy.deepcopy(DIFFUSION_DEFAULTS)

    def merge(dst, src):
        for k, v in (src or {}).items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v

    merge(cfg, loaded)
    return HParams(**cfg)


def build_unit2mel(args: HParams, vocoder_dim: int = 128,
                   device: torch.device | str = "cuda") -> Unit2Mel:
    m = args.model
    model = Unit2Mel(
        input_channel=args.data.encoder_out_channels,
        n_spk=m.n_spk,
        use_pitch_aug=bool(m.use_pitch_aug),
        out_dims=vocoder_dim,
        n_layers=m.n_layers,
        n_chans=m.n_chans,
        n_hidden=m.n_hidden,
        timesteps=m.timesteps or 1000,
        k_step_max=m.k_step_max or 0,
    )
    return model.to(device).eval()


def load_torch_unit2mel(path: str | Path, args: HParams, vocoder_dim: int = 128,
                        device: torch.device | str = "cuda") -> Unit2Mel:
    """A so-vits-svc diffusion checkpoint ({"model": state_dict}), loaded
    strictly apart from GaussianDiffusion's schedule buffers
    (``decoder.betas``, ``decoder.spec_min`` ...), which the port recomputes
    from the config."""
    model = build_unit2mel(args, vocoder_dim, device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.float() for k, v in ckpt["model"].items()
          if not k.startswith("decoder.") or k.startswith("decoder.denoise_fn.")}
    model.load_state_dict(sd, strict=True)
    return model


def load_npz_unit2mel(path: str | Path, args: HParams, vocoder_dim: int = 128,
                      device: torch.device | str = "cuda") -> Unit2Mel:
    """The JAX diffusion trainer's ``model_<step>.npz`` (flattened flax
    params), through the weight bridge."""
    from ..convert import from_jax

    model = build_unit2mel(args, vocoder_dim, device)
    tree = from_jax.unflatten_params(dict(np.load(path)))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in from_jax.unit2mel(tree).items()},
                          strict=True)
    return model
