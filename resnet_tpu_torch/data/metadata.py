"""Class metadata loader: a copy of resnet_tpu.data.metadata.

The reference ships three 1000-line mapping files read by
populate_class_info/text_file_to_buffer (resnet.cu:1331-1381):
id_to_label_mapping.txt (human label per class), id_to_synset_mapping.txt
(WordNet synset), id_to_img_count_mapping.txt (train-image count). Total
image count = sum of counts = 1,281,167.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List


@dataclass
class ClassMetadata:
    labels: List[str]
    synsets: List[str]
    counts: List[int]

    @property
    def num_classes(self) -> int:
        return len(self.labels)

    @property
    def total_images(self) -> int:
        return sum(self.counts)


def _read_lines(path: str) -> List[str]:
    with open(path, "r") as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def load_class_metadata(
    directory: str,
    *,
    labels_file: str = "id_to_label_mapping.txt",
    synsets_file: str = "id_to_synset_mapping.txt",
    counts_file: str = "id_to_img_count_mapping.txt",
) -> ClassMetadata:
    labels = _read_lines(os.path.join(directory, labels_file))
    synsets = _read_lines(os.path.join(directory, synsets_file))
    counts = [int(c) for c in _read_lines(os.path.join(directory, counts_file))]
    if not (len(labels) == len(synsets) == len(counts)):
        raise ValueError(
            f"metadata files disagree: {len(labels)} labels, "
            f"{len(synsets)} synsets, {len(counts)} counts"
        )
    return ClassMetadata(labels=labels, synsets=synsets, counts=counts)
