"""Split-file parsing (a copy of ``video_graph_ssl_tpu/data/records.py``).

Reference format (lib/data/datasets/dataset.py:9-24,68-69): one video per
line, ``<relative/path> <num_frames> <label>`` separated by spaces.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class VideoRecord:
    path: str
    num_frames: int
    label: int


def parse_split(list_file: str) -> List[VideoRecord]:
    records = []
    with open(list_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(" ")
            records.append(VideoRecord(parts[0], int(parts[1]), int(parts[2])))
    return records
