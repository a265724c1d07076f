"""The port's serving surfaces vs the JAX package's (CPU).

(a) api's parse_multipart, wav_bytes_to_array and array_to_wav_bytes on
    the same bytes as the JAX package's: equal.
(b) The two endpoints over a live socket with a tiny CPU Svc (DIO f0, a
    seeded stand-in encoder), against the port's direct calls with the
    noise off: /voiceChangeModel raw and through RealTimeVC (two chunks,
    resampled to another DAW rate), /wav2wav; equal bytes. Their parity
    with the JAX package is held by test_torch_infer.py. A wrong path
    answers 404, a bad body 500, and the server goes on.
(c) tts: the voice catalogue, detect_language and pick_voice over inputs
    and seeds, equal to the JAX package's; synthesize without edge_tts.
(d) webui through tests/gradio_stub.py: the tab and button surface of the
    JAX app, load / convert / unload, compress, and a scan equal to the
    JAX package's on the same tree.
"""

import functools
import http.client
import io
import sys
import threading

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402
from scipy.io import wavfile  # noqa: E402

import tests.gradio_stub as gradio_stub  # noqa: E402

sys.modules.setdefault("gradio", gradio_stub)

from sovits_tpu.serving import api as japi  # noqa: E402
from sovits_tpu.serving import tts as jtts  # noqa: E402
from sovits_tpu.serving import webui as jwebui  # noqa: E402
from sovits_tpu_torch import config as pcfg  # noqa: E402
from sovits_tpu_torch.infer import svc as tsvc_mod  # noqa: E402
from sovits_tpu_torch.models import factory  # noqa: E402
from sovits_tpu_torch.serving import api  # noqa: E402
from sovits_tpu_torch.serving import tts  # noqa: E402
from sovits_tpu_torch.serving import webui  # noqa: E402
from tests.test_torch_slice import _voiced  # noqa: E402
from tests.tiny import TINY_OVERRIDES  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

SR = 8000


class SeededEncoder:
    """A stand-in speech encoder: seeded units at 50 frames/s."""

    name = "fake"
    hidden_dim = TINY_OVERRIDES["model.ssl_dim"]

    def encode_async(self, wav16k):
        n = max((len(wav16k) - 400) // 320 + 1, 1)
        units = np.random.default_rng(len(wav16k)).standard_normal((n, self.hidden_dim))
        return lambda: (0.3 * units).astype(np.float32)


def _write_model(root):
    hps = pcfg.default_config(**TINY_OVERRIDES)
    hps["spk"] = pcfg.HParams(alto=0, tenor=1)
    pcfg.save_config(hps, root / "config.json")
    model = factory.init_random_(factory.build_synthesizer(hps, "cpu", fused_tail=True),
                                 torch.Generator().manual_seed(3))
    torch.save({"model": model.state_dict(), "iteration": 0}, root / "G_0.pth")
    return str(root / "G_0.pth"), str(root / "config.json")


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    return _write_model(tmp_path_factory.mktemp("serving"))


@pytest.fixture
def svc(model_files, monkeypatch):
    """A CPU Svc whose synthesizer dispatch runs with the noise off."""
    monkeypatch.setattr(tsvc_mod.Svc, "_run_synth_batch",
                        functools.partialmethod(tsvc_mod.Svc._run_synth_batch, sample_noise=False))
    return tsvc_mod.Svc(*model_files, encoder=SeededEncoder(), device="cpu")


def _wav_bytes(wav, sr, dtype=np.int16, channels=1):
    buf = io.BytesIO()
    data = np.stack([wav] * channels, axis=1) if channels > 1 else wav
    if dtype == np.int16:
        data = (data * 32767).astype(np.int16)
    elif dtype == np.int32:
        data = (data * 2147483647).astype(np.int32)
    wavfile.write(buf, sr, data.astype(dtype))
    return buf.getvalue()


def _multipart(fields: dict) -> tuple[bytes, str]:
    boundary = "portboundary42"
    parts = []
    for name, value in fields.items():
        parts.append(f"--{boundary}\r\n".encode())
        if isinstance(value, bytes):
            parts.append(f'Content-Disposition: form-data; name="{name}"; filename="f.wav"\r\n'
                         "Content-Type: audio/wav\r\n\r\n".encode())
            parts.append(value)
        else:
            parts.append(f'Content-Disposition: form-data; name="{name}"\r\n\r\n'.encode())
            parts.append(str(value).encode())
        parts.append(b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


# ------------------------------------------------------------- (a) helpers
_MULTIPART_EDGES = {
    # a preamble and an epilogue, a quoted boundary, an unquoted name, a
    # filename holding "name=", a lower-case header, a payload holding CRLFs
    # and a near-delimiter, a part without a name
    "edges": ('multipart/form-data; boundary="a b:c"',
              b'preamble\r\n--a b:c\r\nContent-Disposition: form-data; name=x\r\n\r\n1\r\n--a b:c\r\n'
              b'content-disposition: form-data; filename="name=y.wav"; name="sample"\r\n'
              b'Content-Type: audio/wav\r\n\r\n\x00\r\n\r\n--a b\r\nz\n\r\n--a b:c\r\n'
              b'Content-Type: text/plain\r\n\r\nno name\r\n--a b:c--\r\nepilogue'),
    # a parameter after the boundary, an empty field, no CRLF after the close
    "empty-field": ("multipart/form-data; boundary=xyz; charset=utf-8",
                    b'--xyz\r\nContent-Disposition: form-data; name="e"\r\n\r\n\r\n--xyz\r\n'
                    b'Content-Disposition: form-data; name="f"\r\n\r\nv\r\n--xyz--'),
}


@pytest.mark.parametrize("case", sorted(_MULTIPART_EDGES))
def test_parse_multipart_edges_match_jax(case):
    ctype, body = _MULTIPART_EDGES[case]
    fields = api.parse_multipart({"Content-Type": ctype}, body)
    assert fields == japi.parse_multipart({"Content-Type": ctype}, body)
    assert len(fields) == 2


@pytest.mark.parametrize("dtype,channels", [(np.int16, 1), (np.int32, 1), (np.float32, 2)],
                         ids=["int16", "int32", "float32-stereo"])
def test_wav_helpers_match_jax(dtype, channels):
    wav = 0.5 * _voiced(0.3, SR, 0)
    data = _wav_bytes(wav, SR, dtype, channels)
    body, ctype = _multipart({"sample": data, "fPitchChange": 2.5, "sSpeakId": "alto"})
    fields = api.parse_multipart({"Content-Type": ctype}, body)
    assert fields == japi.parse_multipart({"Content-Type": ctype}, body)
    assert fields["sample"] == data and fields["sSpeakId"] == b"alto"
    got, sr = api.wav_bytes_to_array(fields["sample"])
    want, jsr = japi.wav_bytes_to_array(fields["sample"])
    assert sr == jsr == SR and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    loud = np.concatenate([got, [1.5, -1.5]]).astype(np.float32)  # clipped
    assert api.array_to_wav_bytes(loud, 22050) == japi.array_to_wav_bytes(loud, 22050)


# ----------------------------------------------------------- (b) endpoints
@pytest.fixture
def server(svc):
    servers = []

    def start(**defaults):
        srv = api.make_server(svc, "127.0.0.1", 0, **defaults)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return srv.server_address[1]

    start.servers = servers
    yield start
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _post(port, path, fields):
    body, ctype = _multipart(fields)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, body, {"Content-Type": ctype})
    resp = conn.getresponse()
    out = resp.status, resp.read()
    conn.close()
    return out


def test_voice_change_endpoint_matches_direct(svc, server, monkeypatch):
    daw = 16000
    clips = [_voiced(2.5, SR, 1), _voiced(2.0, SR, 2)]  # RealTimeVC answers 16000-sample chunks
    threads = []  # the thread of every Svc.infer call off the main thread
    infer = svc.infer

    def recorded(*args, **kwargs):
        if threading.current_thread() is not threading.main_thread():
            threads.append(threading.current_thread())
        return infer(*args, **kwargs)

    monkeypatch.setattr(svc, "infer", recorded)
    port_raw = server(raw_infer=True, f0_predictor="dio")
    port_rt = server(raw_infer=False, f0_predictor="dio")
    realtime = tsvc_mod.RealTimeVC()
    for clip in clips:
        data = _wav_bytes(clip, SR)
        wav, _ = api.wav_bytes_to_array(data)
        fields = {"sample": data, "fPitchChange": 2, "sampleRate": daw, "sSpeakId": "tenor"}
        status, got = _post(port_raw, "/voiceChangeModel", fields)
        assert status == 200, got[:200]
        out, _, _ = svc.infer("tenor", 2, wav, sr=SR, f0_predictor="dio")
        assert got == api.array_to_wav_bytes(api.resample(out, SR, daw), daw)
        status, got = _post(port_rt, "/voiceChangeModel", fields)
        assert status == 200, got[:200]
        out = realtime.process(svc, "tenor", 2, wav, SR, f0_predictor="dio")
        assert got == api.array_to_wav_bytes(api.resample(out, SR, daw), daw)
    # each server ran its conversions on its one worker thread
    assert len(threads) >= 2 * len(clips) and len(set(threads)) == 2
    assert all(t.name.startswith("sovits-convert") for t in threads)
    # each server timed every stage of both its requests
    for srv in server.servers:
        stages = srv.timer.summary()
        assert set(stages) == {"read", "parse", "decode", "wait", "convert", "resample", "encode", "send"}
        assert {v["count"] for v in stages.values()} == {len(clips)}
        samples, sr = api.wav_bytes_to_array(got)
        assert sr == daw and len(samples) > 0 and np.abs(samples).max() > 1e-3


def test_wav2wav_endpoint_matches_direct(svc, server):
    rng = np.random.default_rng(4)
    song = np.concatenate([_voiced(1.5, SR, 3), 1e-4 * rng.standard_normal(SR).astype(np.float32),
                           _voiced(1.0, SR, 4)])
    port = server(f0_predictor="dio")
    data = _wav_bytes(song, SR)
    status, got = _post(port, "/wav2wav", {"audio": data, "tran": -3, "spk": 1})
    assert status == 200, got[:200]
    wav, _ = api.wav_bytes_to_array(data)
    out = svc.slice_inference(wav, SR, 1, -3, slice_db=-40, f0_predictor="dio")
    assert got == api.array_to_wav_bytes(out, SR)
    # a wrong path answers 404 and a request that fails 500; the server goes on
    assert _post(port, "/nowhere", {"audio": data})[0] == 404
    status, body = _post(port, "/wav2wav", {"audio": b"not a wav"})
    assert status == 500 and b"error" in body
    assert _post(port, "/wav2wav", {"audio": data, "tran": -3, "spk": 1}) == (200, got)


# ------------------------------------------------------------------ (c) tts
def test_tts_catalogue_and_language_pick_match_jax():
    assert tts.VOICES_BY_LOCALE == jtts.VOICES_BY_LOCALE
    assert tts.SUPPORTED_VOICES == jtts.SUPPORTED_VOICES
    assert tts._LANG_TO_LOCALE == jtts._LANG_TO_LOCALE
    texts = ["こんにちは", "你好", "안녕", "hello world", "Привет", "مرحبا", "", "ok 123"]
    assert [tts.detect_language(s) for s in texts] == [jtts.detect_language(s) for s in texts]
    langs = ["zh-cn", "ja", "ko", "en", "de-DE", "fr-FR", "pt", "xx-unknown", "es-419", "EN",
             "en-US-GuyNeural", "zh-TW"]
    for lang in langs:
        for seed in (None, 0, 1, 7):
            if seed is None and lang not in tts.SUPPORTED_VOICES:
                continue  # an unseeded pick is random in either package
            assert tts.pick_voice(lang, seed=seed) == jtts.pick_voice(lang, seed=seed), (lang, seed)
    with pytest.raises(ImportError):
        tts.synthesize("hello", "out.wav")


# ---------------------------------------------------------------- (d) webui
@pytest.fixture
def app(svc, model_files, monkeypatch):
    """The port's app with its Svc on the CPU with the stand-in encoder."""
    real = tsvc_mod.Svc
    monkeypatch.setattr(tsvc_mod, "Svc", lambda ckpt, cfg, **kw: real(
        ckpt, cfg, encoder=SeededEncoder(), **kw))
    return webui.build_app(device="cpu")


def test_webui_surface_matches_jax(app):
    japp = jwebui.build_app()
    assert app.tabs() == japp.tabs() == ["Inference", "Text-to-Speech", "Model compression",
                                         "Local models"]
    assert [c["label"] for c in app.clicks] == [c["label"] for c in japp.clicks]


def test_webui_load_convert_unload_compress(app, svc, model_files, tmp_path):
    ckpt, cfg = model_files
    out, status = app.click_fn("Convert")((SR, np.zeros(800, np.int16)), "alto", 0, "dio", False,
                                          0.0, -40, 0.4)
    assert out is None and "load" in status
    assert app.click_fn("Load")(ckpt, cfg) == f"loaded {ckpt} (speakers: alto, tenor)"
    wav = (_voiced(1.0, SR, 5) * 32767).astype(np.int16)
    (out_sr, got), status = app.click_fn("Convert")((SR, wav), "alto", 2, "dio", False, 0.0, -40, 0.0)
    assert status == "ok" and out_sr == SR and got.dtype == np.int16
    want = svc.slice_inference(wav / 32768.0, SR, "alto", 2, slice_db=-40, noice_scale=0.0,
                               f0_predictor="dio")
    np.testing.assert_array_equal(got, (np.clip(want, -1, 1) * 32767).astype(np.int16))
    assert app.click_fn("Unload")() == "unloaded"

    status = app.click_fn("Compress")(ckpt, str(tmp_path / "release.pth"), False)
    assert status.startswith("wrote")
    release = torch.load(tmp_path / "release.pth", weights_only=False)["model"]
    assert release and not any(k.startswith("enc_q.") for k in release)


def test_webui_scan_matches_jax(app, tmp_path):
    root = tmp_path / "logs"
    for sub, files in {"44k": ["G_0.pth", "G_800.pth", "release.npz", "D_0.pth"],
                       "44k/other": ["model.npz"], "empty": []}.items():
        d = root / sub
        d.mkdir(parents=True)
        (d / "config.json").write_text("{}")
        for f in files:
            (d / f).write_bytes(b"x")
    found = app.click_fn("Scan")(str(root))
    assert sorted(found) == sorted(jwebui.scan_local_models(str(root)))
    assert len(found) == 4
