"""Offline shard-store builder: JPEG frame folders -> pre-resized binary
shards (counterpart of ``tools/build_shards.py``; the store it writes is
the JAX package's layout, read by either package).

    python -m video_graph_ssl_tpu_torch.build_shards \\
        --cfg configs/visual_moco.yaml --out <store> \\
        DATASET.VISUAL_ROOT_DIR <frames> DATASET.TRAIN_SPLIT <list>

Decoding needs cv2 or PIL (``INPUT.PRE_LOAD native``: g++ and libjpeg), so
build the store where those exist; training from it needs neither:

    ... DATASET.VISUAL_ROOT_DIR <store> INPUT.PRE_LOAD shard
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .config import cfg as default_cfg
from .data.build import _canvas_hw, _img_tmpl
from .data.shards import write_shard_store


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--out", required=True, help="output store directory")
    ap.add_argument("--shard-mb", type=int, default=512)
    ap.add_argument("opts", nargs="*", help="config overrides: KEY VALUE ...")
    args = ap.parse_intermixed_args(argv)

    cfg = default_cfg.clone()
    cfg.merge_from_file(args.cfg)
    cfg.merge_from_list(list(args.opts))

    # the validation split joins when it names a file (its default is "./")
    list_files = [cfg.DATASET.TRAIN_SPLIT]
    if os.path.isfile(cfg.DATASET.VALIDATION_SPLIT):
        list_files.append(cfg.DATASET.VALIDATION_SPLIT)

    t0 = time.time()
    meta = write_shard_store(
        root_path=cfg.DATASET.VISUAL_ROOT_DIR,
        list_files=list_files,
        out_dir=args.out,
        canvas_hw=_canvas_hw(cfg),
        image_tmpl=_img_tmpl(cfg),
        modality=cfg.INPUT.MODALITY,
        pre_load=cfg.INPUT.PRE_LOAD,
        shard_bytes=args.shard_mb << 20,
    )
    n_frames = sum(v[2] for v in meta["videos"].values())
    print(f"wrote {len(meta['videos'])} videos / {n_frames} frames "
          f"in {meta['num_shards']} shard(s) to {args.out} "
          f"({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
