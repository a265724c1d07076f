"""Sequence masks (counterpart of ``sovits_tpu/dsp/sequence.py``)."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] lengths -> [B, max_length] float mask."""
    x = torch.arange(max_length, device=lengths.device)
    return (x[None, :] < lengths[:, None]).float()
