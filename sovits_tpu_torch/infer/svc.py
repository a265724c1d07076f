"""Svc -- one voice conversion (counterpart of ``sovits_tpu/infer/svc.py``).

Per clip: resample to the model rate -> launch the speech encoder on the
16 kHz copy -> f0 on the host while the card works (``f0_predictor``: pm, the
JAX package's default, or dio) -> units stretched to the f0 frames -> synthesizer (prior, flow, NSF-HiFiGAN) -> audio.
Inputs are padded to the same length buckets as the JAX package's, and
same-bucket chunks run as one batch padded to a power of two, so the two
packages see identical tensors.

Not ported here: cluster / feature retrieval, shallow diffusion, the
enhancer, the loudness envelope, ``slice_inference``,
``infer_seq_parallel`` and ``RealTimeVC``. Asking for them raises.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import config as scfg

from ..dsp.audio import repeat_expand, resample
from ..f0.base import get_f0_predictor
from ..models import factory

BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)


class F0FilterException(Exception):
    pass


class Svc:
    def __init__(self, net_g_path: str, config_path: str, encoder=None,
                 device: torch.device | str = "cuda", dtype: torch.dtype = torch.float32):
        """Build the synthesizer from ``config_path`` on ``device`` and load
        ``net_g_path``: a so-vits-svc ``G_*.pth`` ({"model": state_dict}) or
        an ``.npz`` of the JAX package's flattened params. ``encoder`` is a
        speech encoder (``encoders.factory``); when None, the config's
        encoder is loaded from its default checkpoint on first use.
        ``dtype`` is the synthesizer's compute type (float32 or bfloat16);
        only the synthesizer takes it, as in the JAX package, and the audio
        comes back float32."""
        self.device = torch.device(device)
        self.hps = scfg.load_config(config_path)
        self.target_sample = self.hps.data.sampling_rate
        self.hop_size = self.hps.data.hop_length
        self.spk2id = dict(self.hps.spk.items()) if self.hps.spk else {}
        self.unit_interpolate_mode = self.hps.data.unit_interpolate_mode or "left"
        self.model = factory.build_synthesizer(self.hps, self.device, fused_tail=True, dtype=dtype)
        self.model.load_state_dict(self._load_state_dict(net_g_path), strict=True)
        self.f0_predictor_object = None
        self._encoder = encoder
        self._encoder_name = self.hps.model.speech_encoder or "vec768l12"

    @property
    def encoder(self):
        if self._encoder is None:
            from ..encoders.factory import get_speech_encoder

            self._encoder = get_speech_encoder(self._encoder_name, device=self.device)
        return self._encoder

    def _load_state_dict(self, path: str) -> dict:
        p = Path(path)
        if p.suffix == ".npz":
            from ..convert import from_jax

            flat = dict(np.load(p))
            tree: dict = {}
            for key, value in flat.items():  # "a/b/c" -> nested, as cli/tools.py writes
                node = tree
                *parents, leaf = key.split("/")
                for part in parents:
                    node = node.setdefault(part, {})
                node[leaf] = value
            sd = {k: torch.from_numpy(v) for k, v in from_jax.synthesizer(tree, self.hps).items()}
            # a compressed release model drops enc_q, which inference never runs
            fresh = {k: v for k, v in self.model.state_dict().items() if k.startswith("enc_q.")}
            return {**fresh, **sd}
        ckpt = torch.load(p, map_location="cpu", weights_only=False)
        return {k: v.float() for k, v in ckpt["model"].items()}

    # ------------------------------------------------------------------
    def get_unit_f0(self, wav: np.ndarray, tran: int, cluster_infer_ratio: float, speaker,
                    f0_filter: bool = False, f0_predictor: str = "pm", cr_threshold: float = 0.05):
        """f0 + units aligned to the f0 frames."""
        if cluster_infer_ratio != 0:
            raise NotImplementedError("cluster / feature retrieval is not supported by the port")
        if self.f0_predictor_object is None or self.f0_predictor_object.name != f0_predictor:
            self.f0_predictor_object = get_f0_predictor(
                f0_predictor, hop_length=self.hop_size, sampling_rate=self.target_sample,
                threshold=cr_threshold,
            )
        # launch the encoder first; the f0 predictor's host work then overlaps the card's
        wav16k = resample(wav, self.target_sample, 16000)
        pending = self.encoder.encode_async(wav16k)
        f0, uv = self.f0_predictor_object.compute_f0_uv(wav)
        if f0_filter and float(np.sum(f0)) == 0.0:
            raise F0FilterException("No voice detected")
        f0 = f0 * 2 ** (tran / 12)
        units = torch.from_numpy(pending())
        units = repeat_expand(units, len(f0), self.unit_interpolate_mode).numpy()
        return units, f0, uv

    def _prepare_chunk(self, speaker, tran, wav, sr, cluster_infer_ratio, f0_filter,
                       f0_predictor, cr_threshold, spk_mix_frames=None) -> dict:
        """Host-side front end for one chunk: resample, f0, units, speaker."""
        if sr is not None and sr != self.target_sample:
            wav = resample(wav, sr, self.target_sample)
        wav = np.asarray(wav, dtype=np.float32)
        c, f0, uv = self.get_unit_f0(
            wav, tran, cluster_infer_ratio, speaker, f0_filter, f0_predictor, cr_threshold
        )
        n_frames = len(f0)
        if spk_mix_frames is not None:
            spk = ("mix", np.asarray(spk_mix_frames[:n_frames], np.float32))
        else:
            spk_id = self.spk2id.get(speaker)
            if spk_id is None and isinstance(speaker, int):
                spk_id = speaker
            if spk_id is None:
                raise RuntimeError("The name you entered is not in the speaker list!")
            spk = ("id", int(spk_id))
        return dict(wav=wav, c=c, f0=f0, uv=uv, vol=None, n_frames=n_frames, spk=spk)

    def _run_synth_batch(self, items: list, noice_scale: float, auto_predict_f0: bool,
                         seed: int, max_batch: int = 8, sample_noise: bool = True) -> list:
        """Run the synthesizer over prepared chunks, one batch per (bucket,
        speaker kind), padded to a power of two. Returns audio per item."""
        out: list = [None] * len(items)
        groups: dict = {}
        for idx, it in enumerate(items):
            bucket = next((b for b in BUCKETS if b >= it["n_frames"]), it["n_frames"])
            groups.setdefault((bucket, it["spk"][0]), []).append(idx)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        for (bucket, spk_kind), idxs in sorted(groups.items()):
            for start in range(0, len(idxs), max_batch):
                sub = idxs[start : start + max_batch]
                b_pad = 1 << (len(sub) - 1).bit_length()
                rows = sub + [sub[-1]] * (b_pad - len(sub))

                def stack(values, dtype=np.float32):
                    arrs = [np.asarray(v, dtype) for v in values]
                    arrs = [np.pad(a, [(0, bucket - a.shape[0])] + [(0, 0)] * (a.ndim - 1)) for a in arrs]
                    return torch.from_numpy(np.stack(arrs)).to(self.device)

                if spk_kind == "mix":
                    spk = stack([items[i]["spk"][1] for i in rows])
                else:
                    spk = torch.tensor([items[i]["spk"][1] for i in rows], device=self.device)
                lengths = torch.tensor([items[i]["n_frames"] for i in rows], device=self.device)
                audio, _f0 = self.model.infer(
                    stack([items[i]["c"] for i in rows]), stack([items[i]["f0"] for i in rows]),
                    stack([items[i]["uv"] for i in rows]), spk, noise_scale=noice_scale,
                    predict_f0=bool(auto_predict_f0), sample_noise=sample_noise,
                    lengths=lengths, generator=generator,
                )
                audio = audio.float().cpu().numpy()
                for row, i in enumerate(sub):
                    out[i] = audio[row, : items[i]["n_frames"] * self.hop_size, 0]
        return out

    def infer(self, speaker, tran: int, wav: np.ndarray, sr: int | None = None,
              cluster_infer_ratio: float = 0.0, auto_predict_f0: bool = False,
              noice_scale: float = 0.4, f0_filter: bool = False, f0_predictor: str = "pm",
              cr_threshold: float = 0.05, k_step: int = 100, second_encoding: bool = False,
              loudness_envelope_adjustment: float = 1.0, seed: int = 52468,
              spk_mix_frames: np.ndarray | None = None, enhancer_adaptive_key: float = 0):
        """Convert one clip; returns (audio, n_samples, n_frames).

        ``k_step``, ``second_encoding`` and ``enhancer_adaptive_key`` only
        steer diffusion and the enhancer, which this port does not run.
        """
        if loudness_envelope_adjustment != 1:
            raise NotImplementedError("the loudness envelope is not supported by the port")
        item = self._prepare_chunk(speaker, tran, wav, sr, cluster_infer_ratio, f0_filter,
                                   f0_predictor, cr_threshold, spk_mix_frames)
        audio = self._run_synth_batch([item], noice_scale, auto_predict_f0, seed)[0]
        return audio, audio.shape[-1], item["n_frames"]
