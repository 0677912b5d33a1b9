"""Visual input-pipeline check — the inspect_input.ipynb equivalent; a
copy of resnet_tpu.analysis.inspect_input (numpy, and matplotlib when a
grid is drawn).

The reference notebook loads a dumped batch fixture, re-adds the per-channel
ImageNet means that build_training_shards.c subtracted (:115-131)
and renders the images with their labels (cells 4-8). Same here, as a CLI
that writes a PNG grid.

Usage (once the shard reader is ported, ROADMAP.md queue A item A11):
  python -m resnet_tpu_torch.analysis.inspect_input --shard-dir D --out batch.png
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..config import ROADMAP_DATA, not_ported

IMAGENET_MEANS = (123.68, 116.78, 103.94)  # RGB, build_training_shards.c:115


def unnormalize(images: np.ndarray, layout: str = "NHWC") -> np.ndarray:
    """Re-add channel means, clip to [0,255] uint8."""
    means = np.asarray(IMAGENET_MEANS, dtype=np.float32)
    if layout == "NCHW":
        images = images.transpose(0, 2, 3, 1)
    return np.clip(images + means, 0, 255).astype(np.uint8)


def save_batch_grid(
    images: np.ndarray,
    labels: Optional[np.ndarray] = None,
    *,
    layout: str = "NHWC",
    label_names: Optional[Sequence[str]] = None,
    out_path: str = "batch.png",
    cols: int = 4,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    imgs = unnormalize(images, layout)
    n = len(imgs)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
    axes = np.atleast_1d(axes).ravel()
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            ax.imshow(imgs[i])
            if labels is not None:
                lab = int(labels[i])
                title = label_names[lab] if label_names else str(lab)
                ax.set_title(title, fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shard-dir", required=True)
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--layout", default="NCHW")
    ap.add_argument("--metadata-dir", default="")
    ap.add_argument("--out", default="batch.png")
    ap.parse_args(argv)
    # the shards are read by resnet_tpu.data.ShardDataset, which the port
    # does not have yet
    raise not_ported("reading training shards", ROADMAP_DATA)


if __name__ == "__main__":
    main()
