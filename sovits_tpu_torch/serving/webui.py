"""Gradio web UI (counterpart of ``sovits_tpu/serving/webui.py``; so-vits-svc
webUI.py): model load/unload, conversion, text-to-speech, model compression
and local model scanning. gradio is imported only when the app is built,
and a clear ImportError says so when it is absent.

    python -m sovits_tpu_torch.serving.webui
"""

from __future__ import annotations

import glob
from pathlib import Path

import numpy as np


def scan_local_models(root: str = "logs/44k"):
    """webUI.py:255-265: the (checkpoint, config) pairs under ``root`` that
    ``Svc`` loads: a ``G_*.pth`` or an ``.npz`` beside a config.json."""
    candidates = []
    for cfg in glob.glob(f"{root}/**/config.json", recursive=True):
        d = Path(cfg).parent
        for ckpt in sorted(d.glob("*.npz")) + sorted(d.glob("G_*.pth")):
            candidates.append((str(ckpt), cfg))
    return candidates


def _mono_float(wav) -> np.ndarray:
    """Audio as gradio hands it (int16 or float, mono or [N, ch]) -> mono float32."""
    wav = np.asarray(wav)
    out = wav.astype(np.float32)
    if wav.dtype.kind == "i":
        out = out / 32768.0
    return out.mean(axis=1) if out.ndim > 1 else out


def _int16(wav: np.ndarray) -> np.ndarray:
    return (np.clip(wav, -1, 1) * 32767).astype(np.int16)


def build_app(device: str = "cuda"):
    """The Blocks app; its models load on ``device``."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed in this environment; install gradio to use the web UI, "
            "or use sovits_tpu_torch.cli.infer / serving.api"
        ) from e

    from ..infer import svc as svc_mod

    state = {"svc": None}

    def load_model(ckpt, cfg):
        state["svc"] = svc_mod.Svc(ckpt, cfg, device=device)
        spks = ", ".join(map(str, state["svc"].spk2id))
        return f"loaded {ckpt} (speakers: {spks})"

    def unload_model():
        state["svc"] = None
        return "unloaded"

    def convert(audio, speaker, tran, f0_predictor, auto_f0, cluster_ratio, slice_db, noise_scale):
        if state["svc"] is None:
            return None, "load a model first"
        sr, wav = audio
        out = state["svc"].slice_inference(
            _mono_float(wav), sr, speaker, int(tran), slice_db=slice_db,
            cluster_infer_ratio=cluster_ratio, auto_predict_f0=auto_f0,
            noice_scale=noise_scale, f0_predictor=f0_predictor,
        )
        return (state["svc"].target_sample, _int16(out)), "ok"

    with gr.Blocks(title="sovits_tpu_torch") as app:
        gr.Markdown("## sovits_tpu_torch — singing voice conversion on CUDA")
        with gr.Tab("Inference"):
            ckpt = gr.Textbox(label="checkpoint", value="logs/44k/G_0.pth")
            cfg = gr.Textbox(label="config", value="configs/config.json")
            status = gr.Textbox(label="status")
            with gr.Row():
                gr.Button("Load").click(load_model, [ckpt, cfg], status)
                gr.Button("Unload").click(unload_model, [], status)
            audio = gr.Audio(label="input audio")
            speaker = gr.Textbox(label="speaker", value="0")
            tran = gr.Number(label="transpose (semitones)", value=0)
            f0p = gr.Dropdown(["pm", "dio", "harvest", "yin", "crepe", "rmvpe", "fcpe"], value="dio",
                              label="f0 predictor")
            auto_f0 = gr.Checkbox(label="auto predict f0")
            cluster_ratio = gr.Slider(0, 1, 0, label="cluster ratio")
            slice_db = gr.Slider(-80, -20, -40, label="slice db")
            noise_scale = gr.Slider(0, 1, 0.4, label="noise scale")
            out_audio = gr.Audio(label="output")
            gr.Button("Convert").click(
                convert,
                [audio, speaker, tran, f0p, auto_f0, cluster_ratio, slice_db, noise_scale],
                [out_audio, status],
            )
        with gr.Tab("Text-to-Speech"):
            # webUI.py:216-242: edge-TTS text input -> SVC conversion
            from .tts import VOICES_BY_LOCALE

            tts_text = gr.Textbox(label="text")
            tts_lang = gr.Dropdown(["Auto"] + sorted(VOICES_BY_LOCALE), value="Auto", label="language")
            tts_gender = gr.Radio(["Male", "Female"], value="Female", label="gender")
            tts_rate = gr.Slider(-100, 100, 0, label="rate (%)")
            tts_volume = gr.Slider(-100, 100, 0, label="volume (%)")
            tts_speaker = gr.Textbox(label="target speaker", value="0")
            tts_tran = gr.Number(label="transpose (semitones)", value=0)
            tts_out = gr.Audio(label="output")
            tts_status = gr.Textbox(label="status")

            def tts_convert(text, lang, gender, rate, volume, speaker, tran):
                if state["svc"] is None:
                    return None, "load a model first"
                import tempfile

                from scipy.io import wavfile

                from .tts import synthesize

                rate_s = f"+{int(rate)}%" if rate >= 0 else f"{int(rate)}%"
                vol_s = f"+{int(volume)}%" if volume >= 0 else f"{int(volume)}%"
                with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                    synthesize(text, f.name, lang=lang, gender=gender, rate=rate_s, volume=vol_s)
                    sr, wav = wavfile.read(f.name)
                out = state["svc"].slice_inference(_mono_float(wav), sr, speaker, int(tran))
                return (state["svc"].target_sample, _int16(out)), "ok"

            gr.Button("Synthesize + Convert").click(
                tts_convert,
                [tts_text, tts_lang, tts_gender, tts_rate, tts_volume, tts_speaker, tts_tran],
                [tts_out, tts_status],
            )
        with gr.Tab("Model compression"):
            # webUI.py:244-253: drop the optimizer and enc_q for a release model
            comp_in = gr.Textbox(label="checkpoint (G_*.pth)")
            comp_out = gr.Textbox(label="output .pth", value="logs/44k/release.pth")
            comp_half = gr.Checkbox(label="bfloat16")
            comp_status = gr.Textbox(label="status")

            def do_compress(ckpt, out_path, half):
                from ..cli.tools import compress

                compress(["-i", ckpt, "-o", out_path] + (["--half"] if half else []))
                size = Path(out_path).stat().st_size // 1024
                return f"wrote {out_path} ({size} KiB)"

            gr.Button("Compress").click(do_compress, [comp_in, comp_out, comp_half], [comp_status])
        with gr.Tab("Local models"):
            # webUI.py:255-265: scan logs/ for loadable (checkpoint, config) pairs
            scan_root = gr.Textbox(label="scan root", value="logs/44k")
            found = gr.Dataframe(headers=["checkpoint", "config"], label="models")
            gr.Button("Scan").click(scan_local_models, [scan_root], [found])
    return app


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="sovits_tpu_torch web UI")
    parser.add_argument("-d", "--device", default="cuda")
    args = parser.parse_args(argv)
    build_app(args.device).launch()


if __name__ == "__main__":
    main()
