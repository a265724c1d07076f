"""from_jax is the exact inverse of the JAX package's torch converters, and
what it writes loads strictly into the port (CPU)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from sovits_tpu.convert import from_torch  # noqa: E402
from sovits_tpu.encoders.convert import from_fairseq_hubert  # noqa: E402
from sovits_tpu.models import factory as jfactory  # noqa: E402
from sovits_tpu_torch.convert import from_jax  # noqa: E402
from sovits_tpu_torch.encoders.factory import get_speech_encoder  # noqa: E402
from sovits_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from tests.fairseq_fixture import make_fairseq_hubert_sd, save_as_torch_ckpt  # noqa: E402
from tests.test_torch_configs import _fill  # noqa: E402
from tests.test_torch_modules import TINY_W2V  # noqa: E402
from tests.tiny import tiny_hps  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.fixture(scope="module")
def tiny_params():
    """The tiny synthesizer's params: the tree init_synthesizer_params makes,
    from its shapes (no init program compiled), seeded by ``_fill``."""
    hps = tiny_hps()
    module = jfactory.build_synthesizer(hps)
    shapes = jax.eval_shape(lambda: jfactory.init_synthesizer_params(module, jax.random.PRNGKey(0), hps,
                                                                     t_frames=16))
    return hps, _fill(shapes, np.random.default_rng(0))


def test_synthesizer_round_trip_is_exact(tiny_params):
    hps, params = tiny_params
    assert "f0_decoder" in params and "enc_q" in params
    m = hps.model
    back = from_torch.synthesizer(
        from_jax.synthesizer(params, hps), n_upsamples=len(m.upsample_rates),
        n_resblock_kernels=len(m.resblock_kernel_sizes), resblock_type=m.resblock,
    )
    _assert_trees_equal(back, params)


def test_synthesizer_state_dict_loads_strictly(tiny_params):
    hps, params = tiny_params
    sd = from_jax.synthesizer(params, hps)
    model = factory.build_synthesizer(hps, "cpu", fused_tail=True)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    # weight norm is folded at load: the effective kernel is g * v / ||v||
    conv = model.dec.conv_pre
    v = sd["dec.conv_pre.weight_v"]
    want = sd["dec.conv_pre.weight_g"] * v / np.sqrt((v**2).sum(axis=(1, 2), keepdims=True))
    np.testing.assert_allclose(conv.weight.numpy(), want, rtol=1e-6, atol=1e-7)


def test_svc_loads_a_compressed_jax_npz(tiny_params, tmp_path):
    """cli/tools.py's compressed release model: flattened params, no enc_q."""
    from sovits_tpu import config as scfg
    from sovits_tpu.cli.tools import flatten_params
    from sovits_tpu_torch.infer.svc import Svc

    hps, params = tiny_params
    scfg.save_config(hps, tmp_path / "config.json")
    released = {k: v for k, v in params.items() if k != "enc_q"}
    np.savez(tmp_path / "model.npz", **flatten_params(released))
    svc = Svc(str(tmp_path / "model.npz"), str(tmp_path / "config.json"), encoder=None, device="cpu")
    got = svc.model.state_dict()
    for k, v in from_jax.synthesizer(released, hps).items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _tiny_fairseq_sd():
    convs = [(32, 1, 10)] + [(32, 32, 3)] * 4 + [(32, 32, 2)] * 2
    return make_fairseq_hubert_sd(d_model=64, n_layers=2, ffn_dim=128, conv_specs=convs,
                                  pos_conv_kernel=16, pos_conv_groups=4)


def test_wav2vec2_round_trip_is_exact():
    sd = _tiny_fairseq_sd()
    params = from_fairseq_hubert(sd, n_layers=2, n_heads=4)
    back_sd = from_jax.wav2vec2(params, Wav2Vec2Config(**TINY_W2V))
    _assert_trees_equal(from_fairseq_hubert(back_sd, n_layers=2, n_heads=4), params)
    for k, v in back_sd.items():  # and every key it writes is the fairseq one
        np.testing.assert_array_equal(v, sd[k], err_msg=k)


def test_get_speech_encoder_loads_a_fairseq_checkpoint(tmp_path, monkeypatch):
    from sovits_tpu_torch.encoders import factory as enc_factory

    sd = _tiny_fairseq_sd()
    path = tmp_path / "tiny_hubert.pt"
    save_as_torch_ckpt(sd, str(path))
    monkeypatch.setitem(enc_factory.CONFIGS, "vec768l12", Wav2Vec2Config(**TINY_W2V))
    enc = get_speech_encoder("vec768l12", path, device="cpu")
    for k, v in enc.net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    units = enc.encode(np.zeros(12000, np.float32))
    assert units.shape == ((12000 - 400) // 320 + 1, 64)
