"""The port's whisper-ppg, whisper-ppg-large, wavlmbase+ and dphubert
speech encoders vs the JAX package (CPU).

No published checkpoint is in the repository: each is written here from
seeds at a tiny width in its own layout (``chip_smoke.write_ppg_checkpoint``:
openai-whisper's {"dims", "model_state_dict"}, WavLM's {"cfg", "model"},
DPHuBERT's {"config", "state_dict"}), and the same file goes through both
packages' ``get_speech_encoder``; both read the widths from the file.
Whisper keeps its 30 s window (it is the function); WavLM keeps the
512-wide conv stack that both packages build whatever the checkpoint says,
so its clips are short; DPHuBERT is the JAX tests' pruned small config
(a layer without attention, one without its FFN), post-norm and pre-norm.

(a) Whisper's log-mel against the JAX one (max-abs <= 1e-4); the WavLM
    bucket table bit-equal.
(b) Units from one checkpoint file in both packages (atol UNITS_ATOL).
(c) ``from_jax.{whisper,wavlm,dphubert}``: the JAX tree -> from_jax -> the
    JAX converter is the tree exactly, and loads strictly into the port.
(d) The factory: FileNotFoundError without a checkpoint, NotImplementedError
    for an ``-onnx`` variant, ValueError for an unknown name, in both.
(e) A Svc whose config names the encoder builds it from its default path.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sovits_tpu.encoders import dphubert as jdph  # noqa: E402
from sovits_tpu.encoders import factory as jfactory  # noqa: E402
from sovits_tpu.encoders import wavlm as jwavlm  # noqa: E402
from sovits_tpu.encoders import whisper as jwhisper  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.encoders import dphubert as tdph  # noqa: E402
from sovits_tpu_torch.encoders import factory as tfactory  # noqa: E402
from sovits_tpu_torch.encoders import wavlm as twavlm  # noqa: E402
from sovits_tpu_torch.encoders import whisper as twhisper  # noqa: E402
from chip_smoke import write_ppg_checkpoint  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

UNITS_ATOL = 1e-4  # fp32 on both sides (the units' bar of test_torch_encoders.py)
LOG_MEL_ATOL = 1e-4
DPH_SMALL = dict(  # tests/test_dphubert.py's SMALL_CFG, without aux_num_out
    extractor_mode="group_norm",
    extractor_conv_layer_config=[(64, 10, 5), (64, 3, 2), (64, 2, 2)],
    extractor_conv_bias=False, encoder_embed_dim=48, encoder_projection_dropout=0.0,
    encoder_pos_conv_kernel=16, encoder_pos_conv_groups=4, encoder_num_layers=3,
    encoder_use_attention=[True, False, True], encoder_use_feed_forward=[True, True, False],
    encoder_num_heads=[4, 0, 2], encoder_head_dim=12, encoder_attention_dropout=0.0,
    encoder_ff_interm_features=[96, 64, 0], encoder_ff_interm_dropout=0.0, encoder_dropout=0.0,
    encoder_layer_norm_first=False, encoder_layer_drop=0.0, normalize_waveform=False,
)
# case -> (encoder name, the tiny widths written into its checkpoint)
TINY = {
    "whisper-ppg": ("whisper-ppg", twhisper.WhisperDims(n_audio_state=64, n_audio_head=4, n_audio_layer=2)),
    "whisper-ppg-large": ("whisper-ppg-large",
                          twhisper.WhisperDims(n_audio_state=80, n_audio_head=5, n_audio_layer=3)),
    "wavlmbase+": ("wavlmbase+", twavlm.WavLMDims(d_model=64, n_layers=2, n_heads=4, ffn_dim=128,
                                                   num_buckets=32, max_distance=64)),
    "wavlmbase+-normalized": ("wavlmbase+", twavlm.WavLMDims(d_model=64, n_layers=2, n_heads=4,
                                                              ffn_dim=128, num_buckets=32,
                                                              max_distance=64, normalize_input=True)),
    "dphubert": ("dphubert", DPH_SMALL),
    "dphubert-prenorm": ("dphubert", dict(DPH_SMALL, encoder_layer_norm_first=True)),
}
NEW_ENCODERS = ["whisper-ppg", "whisper-ppg-large", "wavlmbase+", "dphubert"]


def _width(dims) -> int:
    if isinstance(dims, twhisper.WhisperDims):
        return dims.n_audio_state
    return dims.d_model if isinstance(dims, twavlm.WavLMDims) else dims["encoder_embed_dim"]


def _wav(seconds: float, seed: int) -> np.ndarray:
    return 0.3 * np.random.default_rng(seed).standard_normal(int(16000 * seconds)).astype(np.float32)


# -------------------------------------------------------------- (a) front
def test_log_mel_matches_jax():
    audio = np.zeros((1, twhisper.N_SAMPLES), np.float32)
    audio[0, :24000] = _wav(1.5, 0)  # a clip padded to 30 s, as encode pads it
    want = np.asarray(jwhisper.log_mel_spectrogram(jnp.asarray(audio)))
    got = twhisper.log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (1, 3000, 80)
    assert np.abs(got - want).max() <= LOG_MEL_ATOL


@pytest.mark.parametrize("t,num_buckets,max_distance", [(74, 32, 64), (499, 320, 800), (1501, 320, 800)])
def test_wavlm_bucket_table_equals_jax(t, num_buckets, max_distance):
    got = twavlm.relative_position_buckets(t, num_buckets, max_distance)
    want = jwavlm.relative_position_buckets(t, num_buckets, max_distance)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() <= num_buckets - 1


# -------------------------------------------------------------- (b) units
@pytest.mark.parametrize("case", list(TINY))
def test_units_match_jax_from_one_checkpoint(tmp_path, case):
    name, dims = TINY[case]
    path = tmp_path / f"{case}.pt"
    write_ppg_checkpoint(name, path, dims=dims)
    jenc = jfactory.get_speech_encoder(name, str(path))
    tenc = tfactory.get_speech_encoder(name, path, device="cpu")
    assert tenc.name == jenc.name == name
    assert tenc.hidden_dim == jenc.hidden_dim == _width(dims)
    wav = _wav(1.3, 6) + 0.1  # an offset, which WavLM's normalisation removes
    want, got = jenc.encode(wav), tenc.encode(wav)
    frames = len(wav) // 320 if name.startswith("whisper") else (len(wav) - 400) // 320 + 1
    assert got.shape == want.shape == (frames, _width(dims))
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=UNITS_ATOL)


def test_whisper_trims_past_30_s_as_jax(tmp_path):
    """A clip over 30 s: both ask for len // 320 frames and get the 1500 of
    the trimmed window."""
    name, dims = TINY["whisper-ppg"]
    write_ppg_checkpoint(name, tmp_path / "w.pt", dims=dims)
    wav = _wav(31.0, 8)
    want = jfactory.get_speech_encoder(name, str(tmp_path / "w.pt")).encode(wav)
    got = tfactory.get_speech_encoder(name, tmp_path / "w.pt", device="cpu").encode(wav)
    assert got.shape == want.shape == (1500, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=UNITS_ATOL)


# -------------------------------------------------------- (c) round trips
def _jax_tree(module, shape):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(shape))["params"]
    rng = np.random.default_rng(5)
    return jax.tree.map(lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32), shapes)


def _round_trip_whisper():
    dims = TINY["whisper-ppg"][1]
    tree = _jax_tree(jwhisper.WhisperAudioEncoder(jwhisper.WhisperDims(**dataclasses.asdict(dims))),
                     (1, 20, 80))
    sd = from_jax.whisper(tree)
    return tree, sd, jwhisper.convert_whisper_encoder(sd, dims.n_audio_layer), twhisper.WhisperEncoder(dims)


def _round_trip_wavlm():
    dims = TINY["wavlmbase+"][1]
    jdims = jwavlm.WavLMDims(**dataclasses.asdict(dims))
    tree = _jax_tree(jwavlm.WavLMEncoder(jdims), (1, 16000))
    sd = from_jax.wavlm(tree, dims)
    return tree, sd, jwavlm.convert_wavlm_state_dict(sd, jdims), twavlm.WavLMEncoder(dims)


def _round_trip_dphubert():
    tree = _jax_tree(jdph.DPHubertEncoder(DPH_SMALL), (1, 4000))
    sd = from_jax.dphubert(tree, DPH_SMALL)
    return tree, sd, jdph.convert_dphubert_state_dict(sd, DPH_SMALL), tdph.DPHubertEncoder(DPH_SMALL)


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("kind", ["whisper", "wavlm", "dphubert"])
def test_from_jax_round_trip_is_exact(kind):
    """A JAX tree with the JAX module's own structure (from eval_shape),
    filled with seeded values -> from_jax -> the JAX package's converter:
    the same tree; and from_jax's state_dict is exactly the port's keys."""
    tree, sd, back, net = globals()[f"_round_trip_{kind}"]()
    _assert_trees_equal(back, tree)
    assert set(sd) == set(net.state_dict()), set(sd) ^ set(net.state_dict())
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)


# ------------------------------------------------------------ (d) factory
@pytest.mark.parametrize("name", NEW_ENCODERS)
def test_factory_refuses_as_jax(tmp_path, monkeypatch, name):
    monkeypatch.chdir(tmp_path)  # no pretrain/ here: the default paths do not exist
    for get in (jfactory.get_speech_encoder, tfactory.get_speech_encoder):
        with pytest.raises(FileNotFoundError):
            get(name)
        with pytest.raises(NotImplementedError, match="onnx"):
            get(f"{name}-onnx")
    with pytest.raises(FileNotFoundError):
        tfactory.get_speech_encoder(name, tmp_path / "none.pt", device="cpu")


def test_unknown_encoder_raises_value_error_as_jax():
    for get in (jfactory.get_speech_encoder, tfactory.get_speech_encoder):
        with pytest.raises(ValueError, match="unknown speech encoder"):
            get("hubert-huge")


# ---------------------------------------------------------------- (e) Svc
@pytest.mark.parametrize("name", NEW_ENCODERS)
def test_svc_builds_the_configs_encoder(tmp_path, monkeypatch, name):
    """A config naming the encoder and its ssl_dim: Svc loads the encoder
    from its default checkpoint path and converts a clip."""
    from sovits_tpu_torch import config as tcfg
    from sovits_tpu_torch.infer.svc import Svc
    from sovits_tpu_torch.models import factory
    from tests.tiny import TINY_OVERRIDES

    dims = TINY[name][1]
    hps = tcfg.default_config(**dict(TINY_OVERRIDES, **{"model.ssl_dim": _width(dims),
                                                         "model.speech_encoder": name}))
    tcfg.save_config(hps, tmp_path / "config.json")
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True),
                                 torch.Generator().manual_seed(3))
    torch.save({"model": model.state_dict(), "iteration": 0}, tmp_path / "G_0.pth")
    write_ppg_checkpoint(name, tmp_path / tfactory.CHECKPOINTS[name], dims=dims)
    monkeypatch.chdir(tmp_path)
    svc = Svc("G_0.pth", "config.json", device="cpu")
    sr = svc.target_sample
    wav = (0.3 * np.sin(2 * np.pi * 200 * np.arange(sr) / sr)).astype(np.float32)
    audio, n_samples, n_frames = svc.infer(0, 0, wav, sr=sr, f0_predictor="yin")
    assert svc.encoder.name == name and svc.encoder.hidden_dim == _width(dims)
    assert svc.model.pre.in_channels == _width(dims)
    assert n_samples == n_frames * svc.hop_size == len(wav) // svc.hop_size * svc.hop_size
    assert np.isfinite(audio).all() and np.abs(audio).max() > 1e-4
    assert Path(tfactory.CHECKPOINTS[name]).exists()
