"""A cell at test size for the CPU tests: narrow widths, a pool of three
short takes, a corpus of six utterances."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def tiny_config(name: str = "sovits41-default") -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg["name"] = name
    m = cfg["model"]
    m.update(inter_channels=16, hidden_channels=16, filter_channels=32, n_layers=2, gin_channels=16,
             ssl_dim=32, n_speakers=4, upsample_initial_channel=64, n_flow_layer=2,
             n_layers_trans_flow=1)
    cfg["speech_encoder"].update(d_model=32, n_layers=2, n_heads=2, ffn_dim=64, output_layer=2,
                                 conv_layers=[[32, 10, 5]] + [[32, 3, 2]] * 4 + [[32, 2, 2]] * 2,
                                 pos_conv_kernel=16, pos_conv_groups=4)
    return cfg


def tiny_traffic(kind: str) -> dict:
    t = json.loads((HERE / "traffic" / ("takes.json" if kind == "serve" else "steps-b24.json")).read_text())
    if kind == "serve":
        t.update(pool=3, take_seconds=[11, 16], check_takes=2, trace_seconds=2)
    else:
        t.update(batch=2, frames=64, utterances=6, utterance_seconds=[1, 2], trace_seconds=2)
    return t


def tiny_run(kind: str, seed: int = 7, seconds: float = 2.0, trace: bool = False, config: str | None = None,
             limits: dict | None = None):
    from portbench import harness

    cfg = tiny_config(config or "sovits41-default")
    name = f"{kind}.tiny"
    return harness.Run({"name": name, "config": cfg["name"], "traffic": kind, "chips": 1}, cfg,
                       tiny_traffic(kind), copy.deepcopy(limits) if limits is not None else {}, seed, seconds,
                       trace, "cpu")
