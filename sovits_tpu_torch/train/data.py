"""Training data: preprocessed features -> fixed-shape batches (counterpart
of ``sovits_tpu/train/data.py``; so-vits-svc ``data_utils.py``).

Per wav, the reference layout: ``<wav>.soft.npy`` [H, T_units] units,
``<wav>.f0.npy`` (f0, uv), ``<wav>.spec.npy`` [F, T], ``<wav>.vol.npy`` [T].
Every batch is cropped or padded to ``data.pad_to_frames`` frames (default
800, so-vits-svc's crop length), with volume augmentation and random
cropping on the host in numpy. A background thread prefetches batches.
"""

from __future__ import annotations

import queue
import threading
import time
from pathlib import Path

import numpy as np
import torch
from scipy.io import wavfile

from ..dsp.audio import repeat_expand
from ..dsp.stft import spectrogram
from ..utils import annotate, count


def load_filelist(path: str) -> list[str]:
    with open(path, encoding="utf-8") as f:
        return [line.strip().split("|")[0] for line in f if line.strip()]


def load_wav(path: str) -> tuple[np.ndarray, int]:
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, sr


class FeatureDataset:
    """One utterance's aligned features per index. ``spk_map`` (speaker
    directory -> id) and ``vol_aug`` override the config's."""

    def __init__(self, filelist: str, hps, spk_map: dict[str, int] | None = None,
                 vol_aug: bool | None = None):
        self.paths = load_filelist(filelist)
        self.hps = hps
        self.hop = hps.data.hop_length
        self.spk_map = spk_map if spk_map is not None else dict(hps.spk.items())
        self.vol_aug = hps.train.vol_aug if vol_aug is None else vol_aug
        self.pad_frames = hps.data.pad_to_frames or 800
        self.interp_mode = hps.data.unit_interpolate_mode or "nearest"
        self._cache = [self.load_utterance(p) for p in self.paths] if hps.train.all_in_mem else None

    def __len__(self):
        return len(self.paths)

    def load_utterance(self, path: str) -> dict:
        wav, sr = load_wav(path)
        if sr != self.hps.data.sampling_rate:
            raise ValueError(f"{path}: {sr} Hz, the config says {self.hps.data.sampling_rate}")
        f0_uv = np.load(path + ".f0.npy", allow_pickle=True)
        f0 = np.asarray(f0_uv[0], dtype=np.float32)
        uv = np.asarray(f0_uv[1], dtype=np.float32)
        spec = np.asarray(np.load(path + ".spec.npy"), dtype=np.float32)
        if spec.shape[0] == self.hps.data.filter_length // 2 + 1:  # stored [F, T]
            spec = spec.T
        units = np.asarray(np.load(path + ".soft.npy"), dtype=np.float32)
        if units.ndim == 3:  # [1, H, T]
            units = units[0]
        units = units.T  # [T_units, H]
        if units.shape[0] != f0.shape[0]:
            units = repeat_expand(torch.from_numpy(units), f0.shape[0], self.interp_mode).numpy()
        vol_path = Path(path + ".vol.npy")
        volume = np.load(vol_path).astype(np.float32) if vol_path.exists() else None
        if abs(units.shape[0] - spec.shape[0]) >= 3:
            raise ValueError(f"{path}: units {units.shape} and spec {spec.shape} disagree")
        n = min(units.shape[0], spec.shape[0], f0.shape[0])
        return {
            "c": units[:n], "f0": f0[:n], "uv": uv[:n], "spec": spec[:n],
            "wav": wav[: n * self.hop], "spk": self.spk_map.get(Path(path).parent.name, 0),
            "volume": volume[:n] if volume is not None else None,
        }

    def _augment_and_crop(self, item: dict, rng: np.random.Generator) -> dict:
        if self.vol_aug and item["volume"] is not None and rng.random() < 0.5:
            max_amp = float(np.max(np.abs(item["wav"]))) + 1e-5
            gain = 10.0 ** rng.uniform(-1.0, min(1.0, np.log10(1.0 / max_amp)))
            item = dict(item, wav=item["wav"] * gain, volume=item["volume"] * gain)
            d = self.hps.data
            spec = spectrogram(torch.from_numpy(item["wav"])[None], d.filter_length, self.hop,
                               d.win_length)[0].numpy()
            item["spec"] = spec[: item["f0"].shape[0]]
        t = item["f0"].shape[0]
        if t > self.pad_frames:  # random crop
            start = int(rng.integers(0, t - self.pad_frames + 1))
            end = start + self.pad_frames
            item = dict(item)
            for k in ("c", "f0", "uv", "spec"):
                item[k] = item[k][start:end]
            item["wav"] = item["wav"][start * self.hop : end * self.hop]
            if item["volume"] is not None:
                item["volume"] = item["volume"][start:end]
        return item

    def padded_example(self, index: int, rng: np.random.Generator) -> dict:
        base = self._cache[index] if self._cache is not None else self.load_utterance(self.paths[index])
        item = self._augment_and_crop(base, rng)
        t = item["f0"].shape[0]
        pad_t = self.pad_frames

        def pad(x, target):
            if x.shape[0] >= target:
                return x[:target]
            return np.pad(x, [(0, target - x.shape[0])] + [(0, 0)] * (x.ndim - 1))

        volume = item["volume"] if item["volume"] is not None else np.zeros(t, np.float32)
        return {
            "c": pad(item["c"], pad_t), "f0": pad(item["f0"], pad_t), "uv": pad(item["uv"], pad_t),
            "spec": pad(item["spec"], pad_t), "wav": pad(item["wav"], pad_t * self.hop)[:, None],
            "spk": np.int64(item["spk"]), "lengths": np.int64(min(t, pad_t)),
            "volume": pad(volume, pad_t),
        }


PREFETCH = 4  # batches the producer thread keeps ready


def batch_iterator(dataset: FeatureDataset, batch_size: int, seed: int = 1234):
    """Infinite shuffled epochs of numpy batches, prefetched by a thread.
    Closing the generator stops the thread; an error in the thread is
    raised here. While a profiler window is open, each batch taken counts
    ``train.feed_batches``, its build seconds in the thread
    (``train.feed_build_s``) and whether the queue was empty when asked
    (``train.feed_empty``); the wait is the ``train.data_wait`` span."""
    q: queue.Queue = queue.Queue(maxsize=PREFETCH)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            rng = np.random.default_rng(seed)
            while True:
                order = rng.permutation(len(dataset))
                if len(order) < batch_size:  # tiny datasets: sample with replacement
                    order = rng.choice(len(dataset), batch_size, replace=True)
                for i in range(0, len(order) - batch_size + 1, batch_size):
                    t0 = time.perf_counter()
                    examples = [dataset.padded_example(j, rng) for j in order[i : i + batch_size]]
                    batch = {k: np.stack([e[k] for e in examples]) for k in examples[0]}
                    if not put((batch, time.perf_counter() - t0)):
                        return
        except Exception as exc:  # handed to the consumer, which raises it
            put(exc)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            with annotate("train.data_wait"):
                empty = q.empty()
                item = q.get()
            if isinstance(item, Exception):
                raise item
            batch, build_s = item
            count("train.feed_batches")
            count("train.feed_build_s", build_s)
            count("train.feed_empty", empty)
            yield batch
    finally:
        stop.set()
        thread.join()
