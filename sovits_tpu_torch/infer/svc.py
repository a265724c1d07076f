"""Svc -- voice conversion (counterpart of ``sovits_tpu/infer/svc.py``).

Per clip: resample to the model rate -> launch the speech encoder on the
16 kHz copy -> f0 (``f0_predictor``: pm, the JAX package's default, dio,
harvest or yin on the host while the card works; the nets crepe, rmvpe and
fcpe on the card in float32, from the weights of a predictor the caller
sets as ``f0_predictor_object``) -> units stretched to the f0
frames -> synthesizer (prior, flow, NSF-HiFiGAN) -> audio -> optional
loudness-envelope mix. Inputs are padded to the same length buckets as the
JAX package's, and same-bucket chunks run as one batch padded to a power of
two, so the two packages see identical tensors.

``slice_inference`` converts a whole song: the slicer cuts it at silences
(long pieces into forced clips with a crossfade), every chunk's front end
runs on the host, then one batched synthesizer pass covers all chunks, and
the pieces are joined again; a speaker-mix timeline spans the whole song.
``RealTimeVC`` converts a stream chunk by chunk with a crossfade.

Each chunk's post stage refines the synthesizer's audio by shallow
diffusion (``shallow_diffusion``: Unit2Mel from the audio's mel at
``k_step``, then the mel vocoder) or re-vocodes it through the NSF-HiFiGAN
enhancer (``nsf_hifigan_enhance``), then mixes in the input's loudness
envelope; ``only_diffusion`` skips the synthesizer and diffuses from the
input's own mel.

With a cluster model (``cluster_model_path``) and a ``cluster_infer_ratio``
other than 0, the units are blended toward the speaker's k-means centers or,
with ``feature_retrieval``, toward their nearest stored features, on the
Svc's device.

``infer_seq_parallel`` converts a whole song in one dispatch: one
prior/flow pass over every frame, then the vocoder decode time-sharded
over the ranks of a process group (``parallel/sequence.py``), or over one
rank without one.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import config as scfg

from ..dsp.audio import change_rms, repeat_expand, resample
from ..dsp.stft import energy
from ..f0.base import get_f0_predictor
from ..models import factory
from ..utils import annotate, annotated, count
from . import slicer as slicer_mod
from .spkmix import build_spk_mix_frames

BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)


class F0FilterException(Exception):
    pass


def pad_array(arr: np.ndarray, target_length: int) -> np.ndarray:
    """Centre-pad with zeros, or centre-crop, to ``target_length``."""
    n = len(arr)
    if n >= target_length:
        start = (n - target_length) // 2
        return arr[start : start + target_length]
    pad = target_length - n
    return np.pad(arr, (pad // 2, pad - pad // 2))


def split_list_by_n(data, n: int, pre: int = 0):
    """Pieces of ``n`` items, each after the first starting ``pre`` items early."""
    for i in range(0, len(data), n):
        yield data[max(i - pre, 0) if i - pre >= 0 else i : i + n]


def crossfade(a: np.ndarray, b: np.ndarray, fade_len: int) -> np.ndarray:
    """Join a's tail into b's head with a linear crossfade of ``fade_len``."""
    fade = np.linspace(0, 1, fade_len)
    mixed = a[-fade_len:] * (1 - fade) + b[:fade_len] * fade
    return np.concatenate([a[:-fade_len], mixed, b[fade_len:]])


class Svc:
    def __init__(self, net_g_path: str, config_path: str, encoder=None,
                 cluster_model_path: str | None = None, feature_retrieval: bool = False,
                 shallow_diffusion: bool = False, only_diffusion: bool = False,
                 diffusion_model_path: str | None = None,
                 diffusion_config_path: str | None = None, nsf_hifigan_enhance: bool = False,
                 enhancer_ckpt: str | None = "pretrain/nsf_hifigan/model",
                 device: torch.device | str = "cuda", dtype: torch.dtype = torch.float32):
        """Build the synthesizer from ``config_path`` on ``device`` and load
        ``net_g_path``: a so-vits-svc ``G_*.pth`` ({"model": state_dict}) or
        an ``.npz`` of the JAX package's flattened params. ``encoder`` is a
        speech encoder (``encoders.factory``); when None, the config's
        encoder is loaded from its default checkpoint on first use.
        ``dtype`` is the synthesizer's compute type (float32 or bfloat16);
        only the synthesizer takes it, as in the JAX package, and the audio
        comes back float32.

        The arguments between ``encoder`` and ``device`` are the JAX
        package's. ``shallow_diffusion`` or ``only_diffusion`` with a
        ``diffusion_model_path`` (a so-vits-svc diffusion checkpoint or the
        JAX trainer's ``.npz``, its config at ``diffusion_config_path``)
        builds the refiner; ``only_diffusion`` without one raises
        FileNotFoundError. ``nsf_hifigan_enhance`` builds the enhancer from
        ``enhancer_ckpt`` unless shallow diffusion supersedes it. The refiner
        and the enhancer compute in float32 whatever ``dtype`` is. An
        existing ``cluster_model_path`` (an ``.npz`` of either package or
        so-vits-svc's ``kmeans_10000.pt``) loads the cluster model onto
        ``device``; one that does not exist is ignored, as the JAX package
        ignores it. ``feature_retrieval`` blends by retrieval in place of
        the nearest centers."""
        self.device = torch.device(device)
        self.hps = scfg.load_config(config_path)
        self.target_sample = self.hps.data.sampling_rate
        self.hop_size = self.hps.data.hop_length
        self.spk2id = dict(self.hps.spk.items()) if self.hps.spk else {}
        self.unit_interpolate_mode = self.hps.data.unit_interpolate_mode or "left"
        self.vol_embedding = bool(self.hps.model.vol_embedding)
        self.model = factory.build_synthesizer(self.hps, self.device, fused_tail=True, dtype=dtype)
        self.model.load_state_dict(self._load_state_dict(net_g_path), strict=True)
        self.f0_predictor_object = None
        self._encoder = encoder
        self._encoder_name = self.hps.model.speech_encoder or "vec768l12"

        self.cluster = None
        self.feature_retrieval = feature_retrieval
        if cluster_model_path and Path(cluster_model_path).exists():
            from ..cluster import load_cluster_model

            self.cluster = load_cluster_model(cluster_model_path, feature_retrieval, self.device)

        self.diffusion = None
        self.only_diffusion = only_diffusion
        if (shallow_diffusion or only_diffusion) and diffusion_model_path:
            from .diffusion_wrapper import DiffusionRefiner

            self.diffusion = DiffusionRefiner(diffusion_model_path, diffusion_config_path,
                                              device=self.device)
        if only_diffusion and self.diffusion is None:
            raise FileNotFoundError("only_diffusion requires a diffusion model")
        # shallow diffusion supersedes the enhancer (infer_tool.py:183-184)
        self.enhancer = None
        if nsf_hifigan_enhance and not shallow_diffusion:
            from .enhancer import Enhancer

            self.enhancer = Enhancer("nsf-hifigan", enhancer_ckpt, device=self.device)

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

            tree = from_jax.unflatten_params(dict(np.load(p)))
            sd = {k: torch.from_numpy(v) for k, v in from_jax.synthesizer(tree, self.hps).items()}
        else:
            sd = {k: v.float() for k, v in torch.load(p, map_location="cpu", weights_only=False)["model"].items()}
        # a compressed release model (either package's tools) drops enc_q,
        # which inference never runs
        fresh = {k: v for k, v in self.model.state_dict().items() if k.startswith("enc_q.")}
        return {**fresh, **sd}

    # ------------------------------------------------------------------
    def get_unit_f0(self, wav: np.ndarray, tran: int, cluster_infer_ratio: float, speaker,
                    f0_filter: bool = False, f0_predictor: str = "pm", cr_threshold: float = 0.05):
        """f0 + units aligned to the f0 frames; with a cluster model and a
        ratio other than 0 the units are blended (in float32 on the Svc's
        device, whatever the synthesizer's dtype); without a model the
        ratio is ignored, as in the JAX package."""
        if self.f0_predictor_object is None or self.f0_predictor_object.name != f0_predictor:
            # an f0 net without weights raises FileNotFoundError here, as in
            # the JAX package: a caller with weights sets f0_predictor_object
            self.f0_predictor_object = get_f0_predictor(
                f0_predictor, hop_length=self.hop_size, sampling_rate=self.target_sample,
                threshold=cr_threshold, device=self.device,
            )
        # launch the encoder first; the f0 predictor's host work then overlaps the card's
        with annotate("svc.resample"):
            wav16k = resample(wav, self.target_sample, 16000)
        with annotate("svc.encode"):
            pending = self.encoder.encode_async(wav16k)
        with annotate("svc.f0"):
            f0, uv = self.f0_predictor_object.compute_f0_uv(wav)
        if f0_filter and float(np.sum(f0)) == 0.0:
            raise F0FilterException("No voice detected")
        f0 = f0 * 2 ** (tran / 12)
        with annotate("svc.units_wait"):
            units = torch.from_numpy(pending())
        units = repeat_expand(units, len(f0), self.unit_interpolate_mode).numpy()
        if cluster_infer_ratio != 0 and self.cluster is not None:
            units = self.cluster.blend(units, speaker, cluster_infer_ratio, self.spk2id,
                                       retrieval=self.feature_retrieval)
        return units, f0, uv

    @annotated("svc.frontend")
    def _prepare_chunk(self, speaker, tran, wav, sr, cluster_infer_ratio, f0_filter,
                       f0_predictor, cr_threshold, spk_mix_frames=None) -> dict:
        """Host-side front end for one chunk: resample, f0, units, volume
        (the per-frame RMS, for a ``vol_embedding`` model or
        ``only_diffusion``), speaker."""
        count("svc.chunks")
        if sr is not None and sr != self.target_sample:
            with annotate("svc.resample"):
                wav = resample(wav, sr, self.target_sample)
        wav = np.asarray(wav, dtype=np.float32)
        c, f0, uv = self.get_unit_f0(
            wav, tran, cluster_infer_ratio, speaker, f0_filter, f0_predictor, cr_threshold
        )
        n_frames = len(f0)
        vol = None
        with annotate("svc.volume"):
            if self.vol_embedding or self.only_diffusion:
                vol = energy(torch.from_numpy(wav[None, : n_frames * self.hop_size]),
                             self.hop_size)[0].numpy()
        if spk_mix_frames is not None:
            spk = ("mix", np.asarray(spk_mix_frames[:n_frames], np.float32))
        else:
            spk_id = self.spk2id.get(speaker)
            if spk_id is None and isinstance(speaker, int):
                spk_id = speaker
            if spk_id is None:
                raise RuntimeError("The name you entered is not in the speaker list!")
            spk = ("id", int(spk_id))
        return dict(wav=wav, c=c, f0=f0, uv=uv, vol=vol, n_frames=n_frames, spk=spk)

    def _run_synth_batch(self, items: list, noice_scale: float, auto_predict_f0: bool,
                         seed: int, max_batch: int = 8, sample_noise: bool = True) -> list:
        """Run the synthesizer over prepared chunks, one batch per (bucket,
        speaker kind), padded to a power of two. Returns audio per item."""
        count("svc.real_frames", sum(int(it["n_frames"]) for it in items))
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
                count("svc.dispatches")
                count("svc.dispatch_rows", b_pad)
                count("svc.synth_frames", b_pad * bucket)

                def stack(values, dtype=np.float32):
                    arrs = [np.asarray(v, dtype) for v in values]
                    arrs = [np.pad(a, [(0, bucket - a.shape[0])] + [(0, 0)] * (a.ndim - 1)) for a in arrs]
                    return torch.from_numpy(np.stack(arrs)).to(self.device)

                with annotate("svc.dispatch"):
                    with annotate("svc.stack"):
                        if spk_kind == "mix":
                            spk = stack([items[i]["spk"][1] for i in rows])
                        else:
                            spk = torch.tensor([items[i]["spk"][1] for i in rows], device=self.device)
                        lengths = torch.tensor([items[i]["n_frames"] for i in rows], device=self.device)
                        vol = stack([items[i]["vol"] for i in rows]) if self.vol_embedding else None
                        c, f0, uv = (stack([items[i][k] for i in rows]) for k in ("c", "f0", "uv"))
                    with annotate("svc.synth"):
                        audio, _f0 = self.model.infer(
                            c, f0, uv, spk, noise_scale=noice_scale,
                            predict_f0=bool(auto_predict_f0), sample_noise=sample_noise,
                            lengths=lengths, generator=generator, vol=vol,
                        )
                    with annotate("svc.fetch"):
                        audio = audio.float().cpu().numpy()
                for row, i in enumerate(sub):
                    out[i] = audio[row, : items[i]["n_frames"] * self.hop_size, 0]
        return out

    @staticmethod
    def _spk_array(item: dict) -> np.ndarray:
        """The chunk's speaker for the refiner: [id] or mix weights [1, T, S]."""
        kind, value = item["spk"]
        return np.asarray([value]) if kind == "id" else np.asarray(value)[None]

    def infer_only_diffusion(self, item: dict, k_step: int, second_encoding: bool,
                             loudness_envelope_adjustment: float, seed: int = 52468) -> np.ndarray:
        """The only_diffusion branch (infer_tool.py:300-328): diffuse from the
        input audio's mel, with its volume, and vocode; no VITS pass."""
        wav, n_frames = item["wav"], item["n_frames"]
        audio = self.diffusion.refine(self, wav[: n_frames * self.hop_size], item["c"], item["f0"],
                                      item["vol"], self._spk_array(item), k_step, second_encoding,
                                      seed)
        return self._loudness(item, audio, loudness_envelope_adjustment)

    def _post_chunk(self, item: dict, audio: np.ndarray, k_step: int, second_encoding: bool,
                    loudness_envelope_adjustment: float, enhancer_adaptive_key: float) -> np.ndarray:
        """Per-chunk post stages (infer_tool.py:299-337): shallow diffusion
        from the synthesizer's audio (the refiner's own seed, 52468) or the
        enhancer, then the loudness-envelope mix toward the input's."""
        if self.diffusion is not None:
            audio = self.diffusion.refine(self, audio, item["c"], item["f0"], item["vol"],
                                          self._spk_array(item), k_step, second_encoding)
        elif self.enhancer is not None:
            audio, _ = self.enhancer.enhance(audio, self.target_sample, item["f0"][: item["n_frames"]],
                                             self.hop_size, adaptive_key=enhancer_adaptive_key)
        return self._loudness(item, audio, loudness_envelope_adjustment)

    def _loudness(self, item: dict, audio: np.ndarray, adjustment: float) -> np.ndarray:
        """The loudness-envelope mix of ``audio`` toward the chunk's input."""
        if adjustment != 1:
            audio = change_rms(item["wav"], self.target_sample, audio, self.target_sample, adjustment)
        return audio

    @annotated("svc.infer")
    def infer(self, speaker, tran: int, wav: np.ndarray, sr: int | None = None,
              cluster_infer_ratio: float = 0.0, auto_predict_f0: bool = False,
              noice_scale: float = 0.4, f0_filter: bool = False, f0_predictor: str = "pm",
              cr_threshold: float = 0.05, k_step: int = 100, second_encoding: bool = False,
              loudness_envelope_adjustment: float = 1.0, seed: int = 52468,
              spk_mix_frames: np.ndarray | None = None, enhancer_adaptive_key: float = 0):
        """Convert one clip; returns (audio, n_samples, n_frames).

        ``k_step`` and ``second_encoding`` steer the diffusion refiner,
        ``enhancer_adaptive_key`` the enhancer.
        """
        count("svc.takes")
        item = self._prepare_chunk(speaker, tran, wav, sr, cluster_infer_ratio, f0_filter,
                                   f0_predictor, cr_threshold, spk_mix_frames)
        if self.only_diffusion:
            audio = self.infer_only_diffusion(item, k_step, second_encoding,
                                              loudness_envelope_adjustment, seed)
            return audio, audio.shape[-1], item["n_frames"]
        audio = self._run_synth_batch([item], noice_scale, auto_predict_f0, seed)[0]
        audio = self._post_chunk(item, audio, k_step, second_encoding,
                                 loudness_envelope_adjustment, enhancer_adaptive_key)
        return audio, audio.shape[-1], item["n_frames"]

    # ------------------------------------------------------------------
    @annotated("svc.slice_inference")
    def slice_inference(self, raw_audio: np.ndarray, sr: int, spk, tran: int,
                        slice_db: float = -40, cluster_infer_ratio: float = 0.0,
                        auto_predict_f0: bool = False, noice_scale: float = 0.4,
                        pad_seconds: float = 0.5, clip_seconds: float = 0.0,
                        lg_num: float = 0.0, lgr_num: float = 0.75, f0_predictor: str = "pm",
                        cr_threshold: float = 0.05, k_step: int = 100,
                        second_encoding: bool = False, loudness_envelope_adjustment: float = 1.0,
                        use_spk_mix: bool = False, enhancer_adaptive_key: float = 0) -> np.ndarray:
        """Silence-sliced conversion of a whole song at the model rate.

        The slicer cuts ``raw_audio`` at silences quieter than ``slice_db``;
        silences come back as zeros. Each voiced piece gets ``pad_seconds``
        of zeros on both sides, and with ``clip_seconds`` it is cut into
        forced clips that overlap by ``lg_num`` seconds, of which the share
        ``lgr_num`` is crossfaded. With ``use_spk_mix``, ``spk`` is a mix
        timeline ({speaker_id: [[begin, end, v0, v1], ...]}, begin and end
        as fractions of the song) and per-frame weights span the whole
        output. Every chunk's front end runs first, then one batched
        synthesizer pass (seed 52468, as the JAX package), then each chunk's
        post stage (shallow diffusion or the enhancer, and the loudness mix);
        with ``only_diffusion`` each chunk is diffused from its input instead.
        """
        count("svc.takes")
        with annotate("svc.slice"):
            chunks = slicer_mod.cut(raw_audio, sr, db_thresh=slice_db)
            audio_data = slicer_mod.chunks2audio(raw_audio, chunks)
        per_size = int(clip_seconds * sr)
        pad_len = int(sr * pad_seconds)

        mix_weights = None
        if use_spk_mix:
            # frames of the whole output: silences at the model rate, voiced
            # pieces with their padding, as the JAX package counts them
            total_frames = sum(
                int(np.ceil(len(d) / sr * self.target_sample)) // self.hop_size
                + (0 if tag else 2 * int(self.target_sample * pad_seconds) // self.hop_size)
                for tag, d in audio_data
            )
            mix_weights = build_spk_mix_frames(spk, total_frames, self.hps.model.n_speakers)
        # forced clips overlap by overlap_len samples; the central fade_len
        # of the overlap is crossfaded, the margins either side dropped
        overlap_len = int(lg_num * sr)
        fade_len = int(overlap_len * lgr_num)
        keep_left = (overlap_len - fade_len) // 2
        keep_right = overlap_len - fade_len - keep_left
        fade_ramp = np.linspace(0, 1, fade_len)

        # pass 1: every chunk's host front end
        plan: list[tuple] = []  # ("sil", length) | ("chunk", item index, per_length, k)
        items: list[dict] = []
        global_frame = 0
        for slice_tag, data in audio_data:
            length = int(np.ceil(len(data) / sr * self.target_sample))
            if slice_tag:
                plan.append(("sil", length))
                global_frame += length // self.hop_size
                continue
            datas = list(split_list_by_n(data, per_size, overlap_len)) if per_size else [data]
            for k, dat in enumerate(datas):
                with annotate("svc.pad"):
                    per_length = int(np.ceil(len(dat) / sr * self.target_sample)) if clip_seconds else length
                    dat = np.concatenate([np.zeros(pad_len), dat, np.zeros(pad_len)]).astype(np.float32)
                    chunk_mix = None
                    if mix_weights is not None:
                        n_chunk = int(np.ceil(len(dat) / sr * self.target_sample)) // self.hop_size
                        idx = np.minimum(np.arange(global_frame, global_frame + n_chunk),
                                         len(mix_weights) - 1)
                        chunk_mix = mix_weights[idx]
                item = self._prepare_chunk(None if mix_weights is not None else spk, tran, dat, sr,
                                           cluster_infer_ratio, False, f0_predictor, cr_threshold,
                                           spk_mix_frames=chunk_mix)
                global_frame += item["n_frames"]
                plan.append(("chunk", len(items), per_length, k))
                items.append(item)

        # pass 2: one batched synthesizer pass over all chunks, then each chunk's post stage
        if self.only_diffusion:
            outs = [self.infer_only_diffusion(it, k_step, second_encoding, loudness_envelope_adjustment)
                    for it in items]
        else:
            outs = self._run_synth_batch(items, noice_scale, auto_predict_f0, 52468)
            outs = [self._post_chunk(it, out, k_step, second_encoding, loudness_envelope_adjustment,
                                     enhancer_adaptive_key) for it, out in zip(items, outs)]
        with annotate("svc.join"):
            pieces: list[np.ndarray] = []
            out_pad = int(self.target_sample * pad_seconds)
            for entry in plan:
                if entry[0] == "sil":
                    pieces.append(np.zeros(entry[1]))
                    continue
                _, item_idx, per_length, k = entry
                _audio = pad_array(np.asarray(outs[item_idx])[out_pad:-out_pad], per_length)
                if overlap_len and k != 0:
                    # blend the assembled tail into the new clip's head over the
                    # fade window; the previous clip's last keep_right samples and
                    # the new clip's first keep_left are dropped (with lgr_num 1
                    # both margins are empty and the whole overlap is blended)
                    head = np.concatenate(pieces)
                    n = len(head)
                    blended = (head[n - fade_len - keep_right : n - keep_right] * (1 - fade_ramp)
                               + _audio[keep_left : keep_left + fade_len] * fade_ramp)
                    pieces = [head[: n - fade_len - keep_right], blended]
                    _audio = _audio[keep_left + fade_len :]
                pieces.append(_audio)
            if not pieces:
                return np.zeros(0, np.float32)
            return np.concatenate(pieces).astype(np.float32)

    # ------------------------------------------------------------------
    def infer_seq_parallel(self, speaker, tran: int, wav: np.ndarray, sr: int | None = None,
                           n_shards: int | None = None, cluster_infer_ratio: float = 0.0,
                           auto_predict_f0: bool = False, noice_scale: float = 0.4,
                           f0_predictor: str = "pm", cr_threshold: float = 0.05,
                           seed: int = 52468, sample_noise: bool = True, group=None):
        """Whole-song inference in one dispatch, the vocoder decode
        time-sharded over ``n_shards`` ranks of ``group`` (the default
        process group when None; one rank without one), as the JAX
        package's ``--seq_shard`` shards it over its devices. Every rank
        calls it with the same song and runs the prior and the flow over
        every frame with the same ``seed``; each decodes its shard with a
        halo exchange and a gathered sine-phase prefix, and every rank
        gets the whole result. ``n_shards`` is cut to the ranks there are
        and so that each shard holds at least the decoder's halo; frames
        are padded to a multiple of it.

        ``sample_noise`` draws the prior's noise from a generator seeded
        with ``seed`` and the source's noise and random phases
        counter-based per absolute frame, so the result does not depend on
        the shard count. A speaker mix is refused (g must be one vector).
        Within ``required_halo_frames`` of the song's edges the audio may
        differ slightly from the monolithic decode (the edge-zone contract
        of ``parallel/sequence.py``). Returns (audio, n_samples, n_frames)
        like ``infer``."""
        import torch.distributed as dist

        from ..parallel.sequence import gather_time, required_halo_frames, sharded_decode

        if isinstance(speaker, dict):
            raise ValueError("seq-parallel inference does not support spk mix")
        item = self._prepare_chunk(speaker, tran, wav, sr, cluster_infer_ratio, False,
                                   f0_predictor, cr_threshold, None)
        if item["spk"][0] == "mix":
            raise ValueError("seq-parallel inference does not support spk mix")
        n_frames = item["n_frames"]
        dec = self.model.dec
        halo = required_halo_frames(dec)
        distributed = dist.is_initialized()
        group = (group or dist.group.WORLD) if distributed else None
        world = dist.get_world_size(group) if distributed else 1
        rank = dist.get_rank(group) if distributed else 0
        n = min(n_shards or world, world)
        # each shard must hold at least the halo (a short clip, a large n_shards)
        n = max(1, min(n, n_frames // max(halo, 1)))
        t_pad = -(-n_frames // n) * n

        def pad_t(x):
            x = np.asarray(x, np.float32)
            x = np.pad(x, [(0, t_pad - x.shape[0])] + [(0, 0)] * (x.ndim - 1))
            return torch.from_numpy(x)[None].to(self.device)

        vol = pad_t(item["vol"]) if self.vol_embedding else None
        generator = torch.Generator(device=self.device).manual_seed(seed)
        z, f0, g = self.model.infer_pre(
            pad_t(item["c"]), pad_t(item["f0"]), pad_t(item["uv"]),
            torch.tensor([item["spk"][1]], device=self.device), noise_scale=noice_scale,
            predict_f0=bool(auto_predict_f0), sample_noise=sample_noise,
            lengths=torch.tensor([n_frames], device=self.device), generator=generator, vol=vol)
        shards = self._shard_group(n, group, world)
        t_local = t_pad // n
        if rank < n:
            with torch.no_grad():
                local = sharded_decode(dec, z[..., rank * t_local : (rank + 1) * t_local],
                                       f0[:, rank * t_local : (rank + 1) * t_local], g, group=shards,
                                       halo=halo, seed=seed if sample_noise else None)
            out = gather_time(local, shards)
        else:
            out = torch.empty((1, 1, t_pad * dec.upp), dtype=z.dtype, device=self.device)
        if n < world:  # the ranks without a shard take the song from the first
            dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
        audio = out[0, 0, : n_frames * self.hop_size].float().cpu().numpy()
        return audio, audio.shape[-1], n_frames

    def _shard_group(self, n: int, group, world: int):
        """The process group of ``group``'s first ``n`` ranks (``group``
        itself when it has ``n``, None without a process group); made once
        per ``n`` by every rank of the world, as ``new_group`` requires."""
        import torch.distributed as dist

        if group is None or n == world:
            return group
        cache = self.__dict__.setdefault("_seq_groups", {})
        key = (id(group), n)
        if key not in cache:
            cache[key] = dist.new_group([dist.get_global_rank(group, r) for r in range(n)])
        return cache[key]


class RealTimeVC:
    """Streaming conversion: each chunk is converted with the previous
    chunk's last ``pre_len`` samples in front, and crossfaded into the
    previous output."""

    def __init__(self, chunk_len: int = 16000, pre_len: int = 3840):
        self.last_chunk: np.ndarray | None = None
        self.last_o: np.ndarray | None = None
        self.chunk_len = chunk_len
        self.pre_len = pre_len

    def process(self, svc_model: Svc, speaker_id, f_pitch_change, audio: np.ndarray,
                sr: int, **kwargs) -> np.ndarray:
        if self.last_chunk is None:
            out, _, _ = svc_model.infer(speaker_id, f_pitch_change, audio, sr=sr, **kwargs)
            self.last_chunk = out[-self.pre_len :]
            self.last_o = out
            return out[-self.chunk_len :]
        aud = np.concatenate([self.last_chunk, audio])
        out, _, _ = svc_model.infer(speaker_id, f_pitch_change, aud, sr=sr, **kwargs)
        ret = crossfade(self.last_o, out, self.pre_len)
        self.last_chunk = out[-self.pre_len :]
        self.last_o = out
        return ret[self.chunk_len : 2 * self.chunk_len]
