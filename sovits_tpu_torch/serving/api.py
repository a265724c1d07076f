"""HTTP voice-conversion API (counterpart of ``sovits_tpu/serving/api.py``;
so-vits-svc flask_api.py + flask_api_full_song.py).

Stdlib ``ThreadingHTTPServer``, with the reference's endpoints and form
fields, so the VST plugin and existing clients work unchanged:

- POST /voiceChangeModel   multipart: sample (wav bytes), fPitchChange,
  sampleRate, sSpeakId  -> ``Svc.infer`` (``raw_infer``, the default) or
  the streaming ``RealTimeVC.process``, resampled to the DAW rate
- POST /wav2wav            multipart: audio (wav), tran, spk
  -> ``Svc.slice_inference`` of the whole song

The ``Svc`` it serves runs on the CUDA card by default (``-d`` names
another device). The server takes connections on threads, which read and
parse the bodies; the conversions, which share one model, one f0 predictor
and one ``RealTimeVC`` state, run one at a time on a single long-lived
worker thread. One thread keeps what PyTorch caches per thread warm (cuDNN's
execution plans): a conversion on a thread of its own redoes them at every
request. ``server.timer`` (a :class:`~sovits_tpu_torch.utils.StageTimer`)
accumulates each request's host seconds by stage: read, parse, wait (for
the worker), decode, convert, resample, encode and send.

    python -m sovits_tpu_torch.serving.api -m logs/44k/G_0.pth -c configs/config.json
"""

from __future__ import annotations

import io
import json
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
from scipy.io import wavfile

from ..dsp.audio import resample
from ..infer.svc import RealTimeVC, Svc
from ..utils import StageTimer

_BOUNDARY = re.compile(r'boundary=(?:"([^"]+)"|([^;\s]+))', re.I)
_NAME = re.compile(rb'(?:^|;)\s*name=(?:"([^"]*)"|([^;\s]*))', re.I)


def parse_multipart(headers: dict, body: bytes) -> dict:
    """multipart/form-data -> {field name: payload bytes} (RFC 7578): the body
    split on its boundary, in place, without the stdlib email machinery,
    which takes tenths of a second for a song's megabytes. A part's payload
    is what lies between its headers' blank line and the CRLF before the
    next delimiter; a part without a Content-Disposition name is skipped.
    Content-Transfer-Encoding is not applied (RFC 7578 4.7: senders do not
    use it)."""
    content_type = headers.get("Content-Type", headers.get("content-type", ""))
    m = _BOUNDARY.search(content_type)
    if m is None:
        raise ValueError(f"not multipart/form-data with a boundary: {content_type!r}")
    delimiter = b"\r\n--" + (m.group(1) or m.group(2)).encode()
    fields = {}
    for part in (b"\r\n" + body).split(delimiter)[1:]:  # [0] is the preamble
        if part.startswith(b"--"):  # the close delimiter
            break
        head, sep, payload = part.partition(b"\r\n\r\n")
        if not sep:
            continue
        for line in head.split(b"\r\n")[1:]:  # [0] ends the delimiter line
            key, _, value = line.partition(b":")
            if key.strip().lower() == b"content-disposition":
                name = _NAME.search(value)
                if name is not None:
                    fields[(name.group(1) if name.group(1) is not None else name.group(2)).decode()] = payload
    return fields


def wav_bytes_to_array(data: bytes) -> tuple[np.ndarray, int]:
    """A wav file's bytes -> (mono float32 samples in [-1, 1), rate)."""
    sr, wav = wavfile.read(io.BytesIO(data))
    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32768.0
    elif wav.dtype == np.int32:
        wav = wav.astype(np.float32) / 2147483648.0
    else:
        wav = wav.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    return wav, sr


def array_to_wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """Samples -> int16 wav bytes (clipped to [-1, 1], scaled by 32767)."""
    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    return buf.getvalue()


def _speaker(raw: bytes):
    speaker = raw.decode()
    return int(speaker) if speaker.isdigit() else speaker


def make_handler(svc: Svc, realtime: RealTimeVC | None, defaults: dict, timer: StageTimer,
                 worker: ThreadPoolExecutor):
    """The request handler class; ``defaults`` holds ``raw_infer`` (True),
    ``f0_predictor`` ("dio") and ``slice_db`` (-40). ``timer`` accumulates
    the host seconds of each request's stages; ``worker`` (one thread) runs
    the conversions."""
    f0_predictor = defaults.get("f0_predictor", "dio")

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str = "audio/wav"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            with timer.stage("read"):
                body = self.rfile.read(length)
            try:
                with timer.stage("parse"):
                    fields = parse_multipart(dict(self.headers), body)
                if self.path == "/voiceChangeModel":
                    route = self._voice_change
                elif self.path == "/wav2wav":
                    route = self._wav2wav
                else:
                    self._send(404, b"not found", "text/plain")
                    return
                started = threading.Event()

                def convert():
                    started.set()
                    return route(fields)

                done = worker.submit(convert)
                with timer.stage("wait"):
                    started.wait()
                out = done.result()
                with timer.stage("send"):
                    self._send(200, out)
            except Exception as e:  # a failed request answers 500; the server goes on
                self._send(500, json.dumps({"error": str(e)}).encode(), "application/json")

        def _voice_change(self, fields) -> bytes:
            with timer.stage("decode"):
                wav, sr = wav_bytes_to_array(fields["sample"])
            pitch = int(float(fields.get("fPitchChange", b"0")))
            daw_sample = int(fields.get("sampleRate", str(sr).encode()))
            speaker = _speaker(fields.get("sSpeakId", b"0"))
            with timer.stage("convert"):
                if defaults.get("raw_infer", True):
                    out, _, _ = svc.infer(speaker, pitch, wav, sr=sr, f0_predictor=f0_predictor)
                else:
                    out = realtime.process(svc, speaker, pitch, wav, sr, f0_predictor=f0_predictor)
            with timer.stage("resample"):
                out = resample(np.asarray(out), svc.target_sample, daw_sample)
            with timer.stage("encode"):
                return array_to_wav_bytes(out, daw_sample)

        def _wav2wav(self, fields) -> bytes:
            with timer.stage("decode"):
                wav, sr = wav_bytes_to_array(fields["audio"])
            tran = int(float(fields.get("tran", b"0")))
            speaker = _speaker(fields.get("spk", b"0"))
            with timer.stage("convert"):
                out = svc.slice_inference(wav, sr, speaker, tran, slice_db=defaults.get("slice_db", -40),
                                          f0_predictor=f0_predictor)
            with timer.stage("encode"):
                return array_to_wav_bytes(out, svc.target_sample)

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def make_server(svc: Svc, host: str = "0.0.0.0", port: int = 6842, **defaults) -> ThreadingHTTPServer:
    """A server bound to (host, port), not yet serving; port 0 takes a free
    one (``server.server_address[1]``). ``server.timer`` holds its requests'
    stage seconds."""
    return _Server(svc, host, port, defaults)


class _Server(ThreadingHTTPServer):
    """The HTTP server with its stage timer and its conversion worker, which
    ``server_close`` stops."""

    def __init__(self, svc: Svc, host: str, port: int, defaults: dict):
        self.timer = StageTimer()
        self.worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sovits-convert")
        super().__init__((host, port), make_handler(svc, RealTimeVC(), defaults, self.timer, self.worker))

    def server_close(self):
        super().server_close()
        self.worker.shutdown()


def serve(svc: Svc, host: str = "0.0.0.0", port: int = 6842, **defaults):
    server = make_server(svc, host, port, **defaults)
    print(f"sovits_tpu_torch API listening on {host}:{server.server_address[1]}")
    server.serve_forever()


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="sovits_tpu_torch HTTP API")
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("-c", "--config_path", default="configs/config.json")
    parser.add_argument("--port", type=int, default=6842)
    parser.add_argument("--f0_predictor", default="dio")
    parser.add_argument("-d", "--device", default="cuda")
    args = parser.parse_args(argv)
    svc = Svc(args.model_path, args.config_path, device=args.device)
    serve(svc, port=args.port, f0_predictor=args.f0_predictor)


if __name__ == "__main__":
    main()
