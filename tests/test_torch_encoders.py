"""The port's vec256l9, hubertsoft and cnhubertlarge speech encoders vs the
JAX package (CPU).

No encoder checkpoint is in the repository: each encoder's checkpoint is
written here from seeds at a tiny width in its own layout (fairseq's for
vec256l9 and cnhubertlarge, bshall's HuBERT-soft for hubertsoft), and the
same file goes through both packages' ``get_speech_encoder``, their
configurations patched to the tiny widths. Each tiny configuration keeps
what sets its encoder apart: vec256l9 taps an earlier layer and projects
to a narrower width, hubertsoft projects too and pads its input by 40
samples either side, cnhubertlarge is wider, deeper and has more heads.

(a) Units from the same checkpoint file in both packages (atol UNITS_ATOL).
(b) The bshall key map: the JAX package's ``from_bshall_hubert`` then
    ``from_jax.wav2vec2`` gives the port's ``from_bshall_hubert`` exactly;
    the final projection survives the fairseq round trip.
(c) FileNotFoundError without a checkpoint, in both packages.
(d) A Svc whose config names the encoder builds it from its default
    checkpoint path, and its width reaches the synthesizer.
"""

from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from sovits_tpu.encoders import convert as jconvert  # noqa: E402
from sovits_tpu.encoders import factory as jfactory  # noqa: E402
from sovits_tpu.encoders import wav2vec2 as jw2v  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.encoders import convert as tconvert  # noqa: E402
from sovits_tpu_torch.encoders import factory as tfactory  # noqa: E402
from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config  # noqa: E402
from chip_smoke import to_bshall_hubert  # noqa: E402
from tests.fairseq_fixture import make_fairseq_hubert_sd, save_as_torch_ckpt  # noqa: E402
from tests.test_torch_modules import TINY_W2V  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

UNITS_ATOL = 1e-4  # fp32 on both sides (the units' bar in test_torch_slice.py)
CONVS = [(32, 1, 10)] + [(32, 32, 3)] * 4 + [(32, 32, 2)] * 2
# name -> (the tiny config's fields, the checkpoint fixture's arguments)
TINY = {
    "vec256l9": (dict(TINY_W2V, output_layer=1, final_proj_dim=16), dict(final_proj_dim=16)),
    "hubertsoft": (dict(TINY_W2V, final_proj_dim=16), dict(final_proj_dim=16)),
    "cnhubertlarge": (dict(TINY_W2V, d_model=96, n_layers=3, n_heads=6, ffn_dim=192),
                      dict(d_model=96, n_layers=3, ffn_dim=192)),
}


def _fairseq_sd(name: str, seed: int = 0) -> dict:
    fields, fixture = TINY[name]
    return make_fairseq_hubert_sd(d_model=fixture.get("d_model", 64), n_layers=fixture.get("n_layers", 2),
                                  ffn_dim=fixture.get("ffn_dim", 128), conv_specs=CONVS,
                                  pos_conv_kernel=16, pos_conv_groups=4,
                                  final_proj_dim=fixture.get("final_proj_dim"), seed=seed)


def _bshall_sd(sd: dict) -> dict:
    """A fairseq fixture's weights under bshall's HuBERT-soft names (the
    smoke's writer, which the JAX package's converter checks here), with
    the label and mask embeddings that the encoder does not use."""
    out = to_bshall_hubert({k: v for k, v in sd.items() if "." in k})
    out["masked_spec_embed"], out["label_embedding.weight"] = sd["mask_emb"], sd["label_embs_concat"]
    return out


def _checkpoint(tmp_path, name: str) -> tuple[str, dict]:
    sd = _fairseq_sd(name)
    path = tmp_path / f"{name}.pt"
    if name in tfactory.BSHALL:
        sd = _bshall_sd(sd)
        torch.save({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, path)
    else:
        save_as_torch_ckpt(sd, str(path))
    return str(path), sd


@pytest.fixture
def tiny_configs(monkeypatch):
    """Both packages' encoder configurations at the tiny widths."""
    for name, (fields, _) in TINY.items():
        _, pad, fmt = jfactory.CONFIGS[name]
        monkeypatch.setitem(jfactory.CONFIGS, name, (jw2v.Wav2Vec2Config(**fields), pad, fmt))
        monkeypatch.setitem(tfactory.CONFIGS, name, Wav2Vec2Config(**fields))


# ---------------------------------------------------------------- (a) units
@pytest.mark.parametrize("name", list(TINY))
def test_units_match_jax_from_one_checkpoint(tmp_path, tiny_configs, name):
    path, _ = _checkpoint(tmp_path, name)
    jenc = jfactory.get_speech_encoder(name, path)
    tenc = tfactory.get_speech_encoder(name, path, device="cpu")
    fields = TINY[name][0]
    width = fields.get("final_proj_dim") or fields["d_model"]
    assert tenc.hidden_dim == jenc.hidden_dim == width
    wav = 0.3 * np.random.default_rng(6).standard_normal(19200).astype(np.float32)  # 1.2 s
    pad = 40 if name == "hubertsoft" else 0
    want, got = jenc.encode(wav), tenc.encode(wav)
    assert got.shape == want.shape == ((len(wav) + 2 * pad - 400) // 320 + 1, width)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=UNITS_ATOL)


# ------------------------------------------------------------ (b) key maps
def test_bshall_key_map_matches_jax(tmp_path):
    sd = _bshall_sd(_fairseq_sd("hubertsoft"))
    params = jconvert.from_bshall_hubert(sd, n_layers=2, n_heads=TINY_W2V["n_heads"])
    want = from_jax.wav2vec2(jax.tree.map(np.asarray, params), Wav2Vec2Config(**TINY["hubertsoft"][0]))
    got = tconvert.from_bshall_hubert({k: torch.from_numpy(v) for k, v in sd.items()})
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_final_proj_round_trip_is_exact():
    sd = _fairseq_sd("vec256l9")
    params = jconvert.from_fairseq_hubert(sd, n_layers=2, n_heads=TINY_W2V["n_heads"], final_proj=True)
    back = from_jax.wav2vec2(params, Wav2Vec2Config(**TINY["vec256l9"][0]))
    assert "final_proj.weight" in back
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)


# ------------------------------------------------------ (c) missing files
@pytest.mark.parametrize("name", list(TINY))
def test_missing_checkpoint_raises_as_jax(tmp_path, monkeypatch, name):
    monkeypatch.chdir(tmp_path)  # no pretrain/ here: the default paths do not exist
    with pytest.raises(FileNotFoundError):
        jfactory.get_speech_encoder(name)
    with pytest.raises(FileNotFoundError):
        tfactory.get_speech_encoder(name, device="cpu")
    with pytest.raises(FileNotFoundError):
        tfactory.get_speech_encoder(name, tmp_path / "none.pt", device="cpu")


# ------------------------------------------------------------------ (d) Svc
@pytest.mark.parametrize("name", list(TINY))
def test_svc_builds_the_configs_encoder(tmp_path, tiny_configs, monkeypatch, name):
    """A config naming the encoder and its ssl_dim: Svc loads the encoder
    from its default path and converts a clip."""
    from sovits_tpu_torch import config as tcfg
    from sovits_tpu_torch.infer.svc import Svc
    from sovits_tpu_torch.models import factory
    from tests.tiny import TINY_OVERRIDES

    fields = TINY[name][0]
    ssl_dim = fields.get("final_proj_dim") or fields["d_model"]
    hps = tcfg.default_config(**dict(TINY_OVERRIDES, **{"model.ssl_dim": ssl_dim,
                                                         "model.speech_encoder": name}))
    tcfg.save_config(hps, tmp_path / "config.json")
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True),
                                 torch.Generator().manual_seed(3))
    torch.save({"model": model.state_dict(), "iteration": 0}, tmp_path / "G_0.pth")
    path, _ = _checkpoint(tmp_path, name)
    default = tmp_path / tfactory.CHECKPOINTS[name]
    default.parent.mkdir(exist_ok=True)
    default.write_bytes(Path(path).read_bytes())
    monkeypatch.chdir(tmp_path)
    svc = Svc("G_0.pth", "config.json", device="cpu")
    sr = svc.target_sample
    wav = (0.3 * np.sin(2 * np.pi * 200 * np.arange(sr) / sr)).astype(np.float32)
    audio, n_samples, n_frames = svc.infer(0, 0, wav, sr=sr, f0_predictor="yin")
    assert svc.encoder.name == name and svc.encoder.hidden_dim == ssl_dim
    assert svc.model.pre.in_channels == ssl_dim
    assert n_samples == n_frames * svc.hop_size == len(wav) // svc.hop_size * svc.hop_size
    assert np.isfinite(audio).all() and np.abs(audio).max() > 1e-4
