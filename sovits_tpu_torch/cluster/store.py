"""Cluster and retrieval models: storage and the inference-time blend
(counterpart of ``sovits_tpu/cluster/store.py``).

File format, shared with the JAX package (each reads the other's): one
``.npz`` holding ``bank_<speaker>`` arrays (k-means centers, or a retrieval
bank of features) and ``retrieval``. so-vits-svc's ``kmeans_10000.pt`` (a
torch dict ``{speaker: {"cluster_centers_": ...}}``) loads too. A model's
banks live on one device as float32 tensors, and the blend runs there.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .kmeans import _sq_dists, kmeans_fit, nearest_centers


class ClusterModel:
    def __init__(self, per_speaker: dict[str, torch.Tensor], retrieval: bool):
        self.per_speaker = per_speaker  # speaker name or id -> centers or feature bank
        self.retrieval = retrieval

    def _bank(self, speaker, spk2id: dict) -> torch.Tensor:
        key = str(speaker)
        if key in self.per_speaker:
            return self.per_speaker[key]
        if speaker in spk2id and str(spk2id[speaker]) in self.per_speaker:
            return self.per_speaker[str(spk2id[speaker])]
        raise KeyError(f"speaker {speaker!r} not in cluster model")

    def blend(self, units: np.ndarray, speaker, ratio: float, spk2id: dict,
              retrieval: bool | None = None) -> np.ndarray:
        """units [T, H] -> ``ratio`` x their replacement + (1 - ratio) x
        units, in float32 on the banks' device (so-vits-svc's
        infer_tool.py). The replacement is the retrieval blend or the
        nearest centers (``retrieval``; the model's own kind when None)."""
        bank = self._bank(speaker, spk2id)
        u = torch.from_numpy(np.asarray(units, np.float32)).to(bank.device)
        use_retrieval = self.retrieval if retrieval is None else retrieval
        replaced = blend_retrieval(u, bank) if use_retrieval else nearest_centers(u, bank)
        return (ratio * replaced + (1.0 - ratio) * u).cpu().numpy()


def blend_retrieval(units: torch.Tensor, bank: torch.Tensor, k: int = 8) -> torch.Tensor:
    """The k nearest bank rows of each unit, weighted by 1 / max(d, 1e-8)^2
    and normalised (so-vits-svc's infer_tool.py), by brute force: one matmul
    and a top-k."""
    b = bank.float()
    neg_d, idx = torch.topk(-_sq_dists(units.float(), b), k, dim=1)  # [T, k]
    weight = 1.0 / torch.square(torch.clamp(-neg_d, min=1e-8))
    weight = weight / weight.sum(1, keepdim=True)
    return (b[idx] * weight[..., None]).sum(1)


def train_cluster_model(features_per_speaker: dict[str, np.ndarray], n_clusters: int = 10000,
                        retrieval: bool = False,
                        device: torch.device | str = "cuda") -> ClusterModel:
    """Per-speaker k-means with ``n_clusters`` centers (so-vits-svc's
    cluster/train_cluster.py), or retrieval banks of the raw features, a
    bank of more than 2e5 rows compacted to 10 000 by k-means (utils.train_index)."""
    per = {}
    for spk, feats in features_per_speaker.items():
        x = torch.from_numpy(np.asarray(feats, np.float32)).to(device)
        if retrieval:
            per[str(spk)] = kmeans_fit(x, 10000) if x.shape[0] > 2e5 else x
        else:
            per[str(spk)] = kmeans_fit(x, n_clusters)
    return ClusterModel(per, retrieval)


def save_cluster_model(model: ClusterModel, path: str | Path) -> None:
    arrays = {f"bank_{k}": v.cpu().numpy() for k, v in model.per_speaker.items()}
    np.savez(path, retrieval=np.asarray(model.retrieval), **arrays)


def load_cluster_model(path: str | Path, feature_retrieval: bool = False,
                       device: torch.device | str = "cuda") -> ClusterModel:
    """An ``.npz`` of either package, or so-vits-svc's ``kmeans_10000.pt``
    dict (whose kind is ``feature_retrieval``); the banks go to ``device``."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as data:
            per = {k.removeprefix("bank_"): torch.from_numpy(data[k].astype(np.float32)).to(device)
                   for k in data.files if k.startswith("bank_")}
            return ClusterModel(per, bool(data["retrieval"]))
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    per = {str(spk): torch.as_tensor(np.asarray(attrs["cluster_centers_"], np.float32)).to(device)
           for spk, attrs in ckpt.items()}
    return ClusterModel(per, feature_retrieval)


def train_retrieval_index(features_per_speaker: dict[str, np.ndarray],
                          device: torch.device | str = "cuda") -> ClusterModel:
    """so-vits-svc's utils.train_index: retrieval banks, brute force."""
    return train_cluster_model(features_per_speaker, retrieval=True, device=device)
