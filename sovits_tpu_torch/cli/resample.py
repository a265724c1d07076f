"""Resample the raw dataset to the training rate (counterpart of
``sovits_tpu/cli/resample.py``; so-vits-svc ``resample.py``):

    python -m sovits_tpu_torch.cli.resample --sr2 44100

``dataset_raw/<speaker>/*.wav`` -> ``dataset/44k/<speaker>/*.wav``, mono,
peak-normalised to 0.98 (so-vits-svc's path without loudness
normalisation), 16-bit, a process pool over the files. The work is host
numpy/scipy (``dsp.audio.resample``), so the tool takes no device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import multiprocessing
from pathlib import Path

import numpy as np
from scipy.io import wavfile

from ..dsp.audio import resample
from ..train.data import load_wav


def process_one(in_path: Path, out_path: Path, target_sr: int) -> None:
    wav, sr = load_wav(str(in_path))
    wav = resample(wav, sr, target_sr)
    peak = np.abs(wav).max()
    if peak > 0:
        wav = 0.98 * wav / peak
    out_path.parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(out_path, target_sr, (wav * 32767.0).astype(np.int16))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Resample dataset_raw -> dataset/<sr>")
    parser.add_argument("--sr2", type=int, default=44100)
    parser.add_argument("--in_dir", type=str, default="./dataset_raw")
    parser.add_argument("--out_dir2", type=str, default="./dataset/44k")
    parser.add_argument("--workers", type=int, default=4)
    args = parser.parse_args(argv)

    in_dir, out_dir = Path(args.in_dir), Path(args.out_dir2)
    jobs = [(wav_path, out_dir / spk_dir.name / wav_path.name)
            for spk_dir in sorted(p for p in in_dir.iterdir() if p.is_dir())
            for wav_path in sorted(spk_dir.glob("*.wav"))]
    # spawned workers: a forked copy of a process that holds a CUDA context
    # or torch's thread pools can hang
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=args.workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        for f in [pool.submit(process_one, i, o, args.sr2) for i, o in jobs]:
            f.result()
    print(f"resampled {len(jobs)} files -> {out_dir}")
    return len(jobs)


if __name__ == "__main__":
    main()
