"""Train per-speaker k-means centers or retrieval banks (counterpart of
``sovits_tpu/cli/train_cluster.py``; so-vits-svc's cluster/train_cluster.py
and train_index.py):

  python -m sovits_tpu_torch.cli.train_cluster --dataset dataset/44k \\
      --output logs/44k/kmeans_10000.npz

Reads every ``<speaker>/*.soft.npy`` ([H, T] units) under ``--dataset``,
fits on ``--device`` (the CUDA card by default) and writes one ``.npz``
that both packages' ``load_cluster_model`` read.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..cluster import train_cluster_model
from ..cluster.store import save_cluster_model


def load_speaker_features(dataset: Path) -> dict[str, np.ndarray]:
    """{speaker directory: its units [N, H]}, the files in name order."""
    feats = {}
    for spk_dir in sorted(p for p in dataset.iterdir() if p.is_dir()):
        arrays = [np.load(f).T for f in sorted(spk_dir.glob("*.soft.npy"))]
        if arrays:
            feats[spk_dir.name] = np.concatenate(arrays, axis=0)
    return feats


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=Path, default=Path("./dataset/44k"))
    parser.add_argument("--output", type=Path, default=Path("logs/44k/kmeans_10000.npz"))
    parser.add_argument("--n_clusters", type=int, default=10000)
    parser.add_argument("--retrieval", action="store_true",
                        help="store feature banks for retrieval instead of k-means centers")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    feats = load_speaker_features(args.dataset)
    if not feats:
        raise SystemExit("no .soft.npy features found; run preprocess_features first")
    model = train_cluster_model(feats, n_clusters=args.n_clusters, retrieval=args.retrieval,
                                device=args.device)
    args.output.parent.mkdir(parents=True, exist_ok=True)
    save_cluster_model(model, args.output)
    print(f"wrote {args.output} ({len(feats)} speakers)")


if __name__ == "__main__":
    main()
