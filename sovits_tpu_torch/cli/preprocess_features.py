"""Featurise the dataset (counterpart of
``sovits_tpu/cli/preprocess_features.py``; so-vits-svc
``preprocess_hubert_f0.py``):

    python -m sovits_tpu_torch.cli.preprocess_features -c configs/config.json --use_diff

For each wav of the config's filelists it writes

- ``<wav>.soft.npy`` [H, T_units], the speech encoder's units of the
  16 kHz audio;
- ``<wav>.f0.npy`` (f0, uv) from the chosen f0 predictor at hop frames;
- ``<wav>.spec.npy`` [F, T], the linear magnitude spectrogram;
- ``<wav>.vol.npy`` [T], the RMS volume;
- with ``--use_diff``: ``<wav>.mel.npy`` [T, M] in the diffusion vocoder's
  mel contract, and the volume- and key-shifted ``<wav>.aug_mel.npy``
  (mel, keyshift) and ``<wav>.aug_vol.npy`` drawn from ``default_rng(0)``
  (preprocess_hubert_f0.py:84-103).

An artifact that exists is kept. The host f0 predictors (dio, harvest, pm,
yin) can run in a process pool (``--workers``); units, spectrograms,
volumes and mels are computed on the device (``--device``, default cuda)
in the main process. The mel needs only the vocoder's mel config
(``vocoder.config``, else the config.json beside ``vocoder.ckpt``, else the
44.1 kHz NSF-HiFiGAN's), not its weights.
"""

from __future__ import annotations

import argparse
import multiprocessing
import time
from pathlib import Path

import numpy as np
import torch

from .. import config as scfg
from ..dsp import stft as dsp_stft
from ..dsp.audio import resample
from ..f0.base import get_f0_predictor
from ..train.data import load_filelist, load_wav

KINDS = ("units", "f0", "spec", "vol", "mel", "aug")


def process_one(path: str, hps, encoder, f0_predictor, use_diff: bool = False, rng=None,
                mel_extractor=None, device: torch.device | str = "cuda") -> dict[str, float]:
    """Write ``path``'s missing artifacts. Returns the seconds each kind
    took (each ends in a copy to the host)."""
    wav, sr = load_wav(path)
    if sr != hps.data.sampling_rate:
        raise ValueError(f"{path}: {sr} Hz, the config says {hps.data.sampling_rate}")
    hop = hps.data.hop_length
    seconds = dict.fromkeys(KINDS, 0.0)
    clock = time.perf_counter()

    def tick(kind):
        nonlocal clock
        now = time.perf_counter()
        seconds[kind] += now - clock
        clock = now

    soft_path = Path(path + ".soft.npy")
    if not soft_path.exists():
        units = np.asarray(encoder.encode(resample(wav, sr, 16000)))  # [T, H]
        np.save(soft_path, units.T.astype(np.float32))  # stored [H, T]
        tick("units")

    f0_path = Path(path + ".f0.npy")
    if not f0_path.exists():
        f0, uv = f0_predictor.compute_f0_uv(wav)
        np.save(f0_path, np.array([f0, uv], dtype=object), allow_pickle=True)
        tick("f0")

    spec_path = Path(path + ".spec.npy")
    wav_dev = None
    if not spec_path.exists():
        wav_dev = torch.from_numpy(wav[None]).to(device)
        spec = dsp_stft.spectrogram(wav_dev, hps.data.filter_length, hop, hps.data.win_length)[0]
        np.save(spec_path, spec.T.cpu().numpy())  # stored [F, T]
        tick("spec")

    vol_path = Path(path + ".vol.npy")
    if not vol_path.exists():
        wav_dev = torch.from_numpy(wav[None]).to(device) if wav_dev is None else wav_dev
        np.save(vol_path, dsp_stft.energy(wav_dev, hop)[0].cpu().numpy())
        tick("vol")

    if use_diff and mel_extractor is not None:
        # the vocoder's mel contract, keyshift applied to the aug mel
        # (preprocess_hubert_f0.py:84-103); Unit2Mel's out_dims is its width
        mel_path = Path(path + ".mel.npy")
        if not mel_path.exists():
            np.save(mel_path, mel_extractor.extract(wav[None], sr)[0].cpu().numpy())  # [T, M]
            tick("mel")
        aug_path = Path(path + ".aug_mel.npy")
        if not aug_path.exists() and rng is not None:
            max_amp = float(np.abs(wav).max()) + 1e-5
            max_shift = min(1.0, np.log10(1.0 / max_amp))
            log10_vol_shift = rng.uniform(-1.0, max_shift)
            keyshift = rng.uniform(-5, 5)
            aug_wav = wav * (10.0**log10_vol_shift)
            aug_mel = mel_extractor.extract(aug_wav[None], sr, keyshift=keyshift)[0].cpu().numpy()
            np.save(aug_path, np.array([aug_mel.astype(np.float32), keyshift], dtype=object),
                    allow_pickle=True)
            # the RMS volume is linear in the gain
            vol = np.load(vol_path)
            np.save(path + ".aug_vol.npy", (vol * 10.0**log10_vol_shift).astype(np.float32))
            tick("aug")
    return seconds


_POOL_F0P = None


def _f0_pool_init(name: str, hop: int, sr: int):
    """A worker's host f0 predictor."""
    global _POOL_F0P
    _POOL_F0P = get_f0_predictor(name, hop_length=hop, sampling_rate=sr)


def _f0_pool_job(path: str) -> str:
    f0_path = Path(path + ".f0.npy")
    if not f0_path.exists():
        wav, _sr = load_wav(path)
        f0, uv = _POOL_F0P.compute_f0_uv(wav)
        np.save(f0_path, np.array([f0, uv], dtype=object), allow_pickle=True)
    return path


# host predictors that run in worker processes (numpy, scipy, the native
# WORLD library); the nets stay on the device in the main process
_POOL_SAFE_F0 = {"dio", "harvest", "pm", "yin"}


def main(argv=None) -> dict[str, float]:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", default="./configs/config.json")
    parser.add_argument("--diffusion_config", default="./configs/diffusion.yaml")
    parser.add_argument("--f0_predictor", default="dio")
    parser.add_argument("--use_diff", action="store_true")
    parser.add_argument("--encoder_checkpoint", default=None)
    parser.add_argument("--filelists", nargs="*", default=None)
    parser.add_argument("--workers", type=int, default=1,
                        help="process pool for the host f0 pass; the device work stays in "
                             "the main process")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    hps = scfg.load_config(args.config)
    mel_extractor = None
    if args.use_diff:
        from ..models.diffusion.vocoder import NsfHifiGANVocoder
        from ..train.diffusion import load_diffusion_config

        voc = load_diffusion_config(args.diffusion_config).vocoder
        mel_extractor = NsfHifiGANVocoder(str(voc.ckpt), voc.config.to_dict() if voc.config else None,
                                          args.device, weights=False)
    from ..encoders.factory import get_speech_encoder

    encoder = get_speech_encoder(hps.model.speech_encoder or "vec768l12", args.encoder_checkpoint,
                                 device=args.device)
    f0p = get_f0_predictor(args.f0_predictor, hop_length=hps.data.hop_length,
                           sampling_rate=hps.data.sampling_rate, device=args.device)
    filelists = args.filelists or [hps.data.training_files, hps.data.validation_files]
    rng = np.random.default_rng(0)
    paths = [p for fl in filelists for p in load_filelist(fl)]
    seconds = dict.fromkeys(KINDS, 0.0)

    if args.workers > 1 and args.f0_predictor in _POOL_SAFE_F0:
        from concurrent.futures import ProcessPoolExecutor

        from .. import native

        if args.f0_predictor in ("dio", "harvest"):
            native.load()  # build the WORLD library once, before the workers load it
        t0 = time.perf_counter()
        # spawned workers: a forked copy of a process that holds a CUDA
        # context or torch's thread pools can hang
        with ProcessPoolExecutor(max_workers=args.workers,
                                 mp_context=multiprocessing.get_context("spawn"),
                                 initializer=_f0_pool_init,
                                 initargs=(args.f0_predictor, hps.data.hop_length,
                                           hps.data.sampling_rate)) as pool:
            for i, _ in enumerate(pool.map(_f0_pool_job, paths)):
                if (i + 1) % 50 == 0:
                    print(f"f0 {i + 1}/{len(paths)}")
        seconds["f0"] += time.perf_counter() - t0

    for i, p in enumerate(paths):
        for kind, s in process_one(p, hps, encoder, f0p, args.use_diff, rng, mel_extractor,
                                   args.device).items():
            seconds[kind] += s
        if (i + 1) % 20 == 0:
            print(f"{i + 1}/{len(paths)}")
    print(f"featurized {len(paths)} files; seconds per kind: "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    return seconds


if __name__ == "__main__":
    main()
