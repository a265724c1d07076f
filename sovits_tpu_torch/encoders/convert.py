"""Speech-encoder checkpoint layouts (counterpart of
``sovits_tpu/encoders/convert.py``).

The port's encoder carries fairseq HuBERT names, so a fairseq checkpoint
(ContentVec vec768l12 / vec256l9, chinese-hubert-large) loads as it is.
``from_bshall_hubert`` renames a bshall HuBERT-soft state_dict (the
hubertsoft checkpoint, vencoder/hubert/hubert_model.py) onto those names.

The other layouts need no renaming, only filtering: ``whisper.py``,
``wavlm.py`` and ``dphubert.py`` carry openai-whisper's, WavLM's and
torchaudio's names, and their loaders take the entries the encoder has
from ``model_state_dict``, ``model`` and ``state_dict``. What they leave:
whisper's decoder and its stored ``encoder.positional_embedding`` (both
packages recompute it), WavLM's ``mask_emb`` and the like, DPHuBERT's
auxiliary head.
"""

from __future__ import annotations

import torch

_BSHALL_LAYER = {"linear1": "fc1", "linear2": "fc2", "norm1": "self_attn_layer_norm",
                 "norm2": "final_layer_norm", "self_attn.out_proj": "self_attn.out_proj"}
_BSHALL_TOP = {"feature_extractor.norm0": "feature_extractor.conv_layers.0.2",
               "feature_projection.norm": "layer_norm",
               "feature_projection.projection": "post_extract_proj",
               "positional_embedding.conv": "encoder.pos_conv.0", "norm": "encoder.layer_norm",
               "proj": "final_proj"}


def from_bshall_hubert(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """bshall HubertSoft state_dict -> fairseq-style names: ``conv{i}`` to
    ``conv_layers.{i}.0``, ``norm0`` to the first conv's group norm, the
    feature projection's norm and linear, the positional conv, ``norm`` to
    the encoder norm, each layer's packed ``in_proj`` split into q/k/v,
    ``linear1``/``linear2`` to ``fc1``/``fc2``, ``norm1``/``norm2`` to the
    attention and final layer norms, ``proj`` to ``final_proj``. Keys the
    encoder does not use (the label embedding, the mask embedding) are
    dropped."""
    out: dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        stem, _, leaf = key.rpartition(".")
        parts = stem.split(".")
        if stem.startswith("feature_extractor.conv"):
            out[f"feature_extractor.conv_layers.{stem[len('feature_extractor.conv'):]}.0.{leaf}"] = value
        elif stem in _BSHALL_TOP:
            out[f"{_BSHALL_TOP[stem]}.{leaf}"] = value
        elif stem.startswith("encoder.layers."):
            pre, rest = ".".join(parts[:3]), ".".join(parts[3:])
            if rest == "self_attn" and leaf.startswith("in_proj_"):
                for name, part in zip(("q_proj", "k_proj", "v_proj"), value.chunk(3, dim=0)):
                    out[f"{pre}.self_attn.{name}.{leaf[len('in_proj_'):]}"] = part
            elif rest in _BSHALL_LAYER:
                out[f"{pre}.{_BSHALL_LAYER[rest]}.{leaf}"] = value
    return out
