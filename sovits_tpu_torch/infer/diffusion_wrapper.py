"""Shallow-diffusion refinement for ``Svc`` (counterpart of
``sovits_tpu/infer/diffusion_wrapper.py``; so-vits-svc infer_tool.py:299-328).

The mel of the VITS output (or, with ``only_diffusion``, of the input) is
taken at the vocoder's rate, noised to ``k_step`` and denoised by Unit2Mel
conditioned on the units, f0, volume and speaker, then decoded by the mel
vocoder. The refiner computes in float32 whatever the synthesizer's type.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..dsp.audio import repeat_expand, resample
from ..dsp.stft import energy
from ..models.diffusion import NsfHifiGANVocoder
from ..train.diffusion import load_diffusion_config, load_npz_unit2mel, load_torch_unit2mel


class DiffusionRefiner:
    def __init__(self, model_path: str, config_path: str | None = None,
                 device: torch.device | str = "cuda"):
        """``model_path``: a so-vits-svc diffusion checkpoint or the JAX
        trainer's ``.npz``; ``config_path``: its diffusion config
        (``config.yaml`` beside the model when None). The vocoder is the
        config's ``vocoder.ckpt``, and FileNotFoundError is raised when that
        file is missing."""
        config_path = config_path or str(Path(model_path).parent / "config.yaml")
        self.args = load_diffusion_config(config_path)
        vocoder_cfg = self.args.vocoder.config.to_dict() if self.args.vocoder.config else None
        self.vocoder = NsfHifiGANVocoder(str(self.args.vocoder.ckpt), config=vocoder_cfg,
                                         device=device)
        load = load_npz_unit2mel if str(model_path).endswith(".npz") else load_torch_unit2mel
        self.model = load(model_path, self.args, self.vocoder.dimension, device)

    @torch.no_grad()
    def refine(self, svc, audio: np.ndarray, units: np.ndarray, f0: np.ndarray, vol,
               spk, k_step: int, second_encoding: bool = False,
               seed: int = 52468) -> np.ndarray:
        """audio [L] at ``svc``'s rate, units [T, C], f0 [T], volume [T] or
        [1, T] (None: the audio's own), ``spk`` an integer id array or mix
        weights ([1, S] or [1, T, S]) -> the refined audio [n * hop]
        (float32), n the frames that every input covers. The q-sample noise
        comes from a CPU generator seeded with ``seed``."""
        device = self.vocoder.device
        if second_encoding:
            units = svc.encoder.encode(resample(audio, svc.target_sample, 16000))
            units = repeat_expand(torch.from_numpy(units), len(f0), svc.unit_interpolate_mode).numpy()
        if vol is None:
            vol = energy(torch.from_numpy(np.asarray(audio, np.float32)[None]), svc.hop_size).numpy()

        gt_mel = self.vocoder.extract(audio[None], svc.target_sample)
        n = min(gt_mel.shape[1], len(f0), units.shape[0], vol.shape[-1])

        def dev(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        spk = np.asarray(spk)
        if np.issubdtype(spk.dtype, np.integer):
            spk_id = dev(spk.reshape(-1), np.int64)
        else:
            spk_id = dev(spk[:, :n] if spk.ndim == 3 else spk)
        f0_n = dev(f0[None, :n])
        mel = self.model(dev(units[None, :n]), f0_n, dev(np.reshape(vol, (1, -1))[:, :n]),
                         spk_id=spk_id, gt_spec=gt_mel[:, :n], infer=True,
                         infer_speedup=self.args.infer.speedup, method=self.args.infer.method,
                         k_step=k_step, generator=torch.Generator().manual_seed(seed))
        return self.vocoder.infer(mel, f0_n)[0, 0].cpu().numpy()
