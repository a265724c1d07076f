"""The shallow-diffusion stack: Unit2Mel with its schedule and samplers,
and the mel vocoder (counterpart of ``sovits_tpu/models/diffusion``)."""

from .gaussian import DiffusionSchedule
from .unit2mel import Unit2Mel
from .vocoder import NsfHifiGANVocoder, nv_mel_spectrogram
from .wavenet import DiffusionWaveNet

__all__ = ["DiffusionSchedule", "DiffusionWaveNet", "NsfHifiGANVocoder", "Unit2Mel",
           "nv_mel_spectrogram"]
