"""Timbre-leakage mitigation: k-means clustering and feature retrieval
(counterpart of ``sovits_tpu/cluster``; so-vits-svc's cluster/ and
``utils.train_index``).

- per-speaker k-means over content units (kmeans++ seeding, Lloyd steps),
  every distance one [N, D] x [D, K] matmul on the tensors' device;
- nearest-center replacement at inference;
- feature retrieval: the 8 nearest stored features blended with
  inverse-square-distance weights, by brute force (one matmul and a top-k)
  in place of a faiss index.
"""

from .kmeans import kmeans_fit, kmeans_predict, nearest_centers
from .store import (
    ClusterModel,
    blend_retrieval,
    load_cluster_model,
    train_cluster_model,
    train_retrieval_index,
)
