"""Dataset preparation: raw videos -> frame folders -> split files
(counterpart of ``tools/prepare_data.py``).

The frame-folder datasets (``data/datasets.py``) read split files of
``<path> <num_frames> <label>`` lines and 1-based ``img_{:05d}.jpg``
frames (``INPUT.IMG_TMP``); this tool makes both from videos::

    # 1. decode every video under --video_root into JPEG frame folders
    python -m video_graph_ssl_tpu_torch.prepare_data extract \
        --video_root /data/ucf101_videos --out_root /data/ucf101_frames \
        --short_side 256 --workers 8

    # 2. scan the frame folders into split files (+ class index)
    python -m video_graph_ssl_tpu_torch.prepare_data split \
        --frame_root /data/ucf101_frames --out_dir /data/ucf101_lists \
        --val_frac 0.1

Layout (UCF101/HMDB51/Kinetics style): one directory level of class names,
one sub-directory per video::

    frame_root/<class_name>/<video_name>/img_00001.jpg ...

``split --official_list`` converts an official list file (UCF101's
``trainlist01.txt`` / ``testlist01.txt``: ``<class>/<video>.avi [label]``
per line) with the scanned class index's 0-based labels.  Decoding is
``data/video_io.py``'s (cv2); the resize and the JPEG writes use cv2 or,
without it, PIL.  It runs on the host only: there is no ``--device``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .data.video_io import load_video

VIDEO_EXTS = (".mp4", ".avi", ".mkv", ".webm", ".mov", ".m4v", ".mpg",
              ".mpeg", ".wmv")


# ---------------------------------------------------------------- extract

def _resize_short_side(frames: np.ndarray, short_side: int) -> np.ndarray:
    """Resize (T,H,W,C) so min(H,W) == short_side, cv2.INTER_LINEAR (the
    same interpolation family the transform stack assumes)."""
    t, h, w, _ = frames.shape
    if min(h, w) == short_side:
        return frames
    scale = short_side / float(min(h, w))
    nh, nw = int(round(h * scale)), int(round(w * scale))
    try:
        import cv2

        return np.stack(
            [cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR)
             for f in frames], axis=0)
    except ImportError:
        from PIL import Image

        return np.stack(
            [np.asarray(Image.fromarray(f).resize((nw, nh), Image.BILINEAR))
             for f in frames], axis=0)


def _write_jpeg(path: str, rgb: np.ndarray, quality: int) -> None:
    try:
        import cv2

        ok = cv2.imwrite(path, rgb[..., ::-1],
                         [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
        if not ok:
            raise IOError(f"cv2.imwrite failed: {path}")
    except ImportError:
        from PIL import Image

        Image.fromarray(rgb).save(path, quality=int(quality))


def extract_video(video_path: str, out_dir: str, tmpl: str,
                  short_side: int, quality: int) -> int:
    """Decode one video into ``out_dir`` as 1-based JPEG frames; returns the
    frame count (0 = decode failure, reported but not fatal)."""
    frames, _fps = load_video(video_path)
    if frames is None or len(frames) == 0:
        return 0
    if short_side:
        frames = _resize_short_side(frames, int(short_side))
    os.makedirs(out_dir, exist_ok=True)
    for i, frame in enumerate(frames, start=1):  # 1-based like the reference
        _write_jpeg(os.path.join(out_dir, tmpl.format(i)), frame, quality)
    return len(frames)


def cmd_extract(args) -> int:
    videos = []
    for root, _dirs, files in os.walk(args.video_root):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in VIDEO_EXTS:
                videos.append(os.path.join(root, f))
    videos.sort()
    if not videos:
        print(f"no videos under {args.video_root}", file=sys.stderr)
        return 1

    def job(vp: str):
        rel = os.path.relpath(vp, args.video_root)
        out_dir = os.path.join(args.out_root, os.path.splitext(rel)[0])
        if (args.skip_existing and os.path.isdir(out_dir)
                and any(e.endswith(".jpg") for e in os.listdir(out_dir))):
            return rel, -1
        n = extract_video(vp, out_dir, args.tmpl, args.short_side,
                          args.quality)
        return rel, n

    done = skipped = failed = 0
    with ThreadPoolExecutor(max_workers=max(1, args.workers)) as pool:
        for rel, n in pool.map(job, videos):
            if n == 0:
                failed += 1
                print(f"FAILED {rel}", file=sys.stderr)
            elif n < 0:
                skipped += 1
            else:
                done += 1
            if (done + failed + skipped) % 200 == 0:
                print(f"  {done + failed + skipped}/{len(videos)}...",
                      flush=True)
    print(f"extracted {done} videos -> {args.out_root} "
          f"({skipped} skipped, {failed} failed)")
    return 1 if failed and not done else 0


# ------------------------------------------------------------------ split

def _tmpl_regex(tmpl: str) -> "re.Pattern":
    """'img_{:05d}.jpg' -> a fullmatch regex accepting any frame number."""
    field = re.search(r"\{:0?\d*d\}", tmpl)
    if not field:
        raise ValueError(f"template has no integer field: {tmpl!r}")
    head, tail = tmpl[:field.start()], tmpl[field.end():]
    return re.compile(re.escape(head) + r"\d+" + re.escape(tail))


def count_frames(video_dir: str, tmpl: str) -> int:
    rx = _tmpl_regex(tmpl)
    return sum(1 for e in os.listdir(video_dir) if rx.fullmatch(e))


def scan_frame_root(frame_root: str, tmpl: str):
    """-> (classes, rows) with rows = [(relpath, num_frames, label)],
    classes sorted by name -> 0-based labels (the reference's convention:
    split-file labels index the classifier head directly)."""
    classes = sorted(
        d for d in os.listdir(frame_root)
        if os.path.isdir(os.path.join(frame_root, d)))
    rows = []
    for label, cls in enumerate(classes):
        cdir = os.path.join(frame_root, cls)
        for vid in sorted(os.listdir(cdir)):
            vdir = os.path.join(cdir, vid)
            if not os.path.isdir(vdir):
                continue
            n = count_frames(vdir, tmpl)
            if n > 0:
                rows.append((f"{cls}/{vid}", n, label))
    return classes, rows


def _write_split(path: str, rows) -> None:
    with open(path, "w") as f:
        for rel, n, label in rows:
            f.write(f"{rel} {n} {label}\n")
    print(f"wrote {path} ({len(rows)} videos)")


def cmd_split(args) -> int:
    classes, rows = scan_frame_root(args.frame_root, args.tmpl)
    if not rows:
        print(f"no frame folders under {args.frame_root}", file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "class_ind.txt"), "w") as f:
        for i, c in enumerate(classes):
            f.write(f"{i} {c}\n")

    by_rel = {rel: (rel, n, label) for rel, n, label in rows}
    if args.official_list:
        # UCF-style official lists: '<class>/<video>.avi [label]' per line.
        missing = 0
        picked = []
        for line in open(args.official_list):
            name = line.strip().split()[0] if line.strip() else ""
            if not name:
                continue
            rel = os.path.splitext(name)[0]
            if rel in by_rel:
                picked.append(by_rel[rel])
            else:
                missing += 1
        if missing:
            print(f"warning: {missing} entries of {args.official_list} "
                  "have no extracted frames", file=sys.stderr)
        out = os.path.join(
            args.out_dir,
            os.path.splitext(os.path.basename(args.official_list))[0]
            + "_frames.txt")
        _write_split(out, picked)
        return 0

    if not args.val_frac:
        _write_split(os.path.join(args.out_dir, "all.txt"), rows)
        return 0

    # deterministic per-class split so both splits cover every class
    rng = np.random.default_rng(args.seed)
    train, val = [], []
    for label in range(len(classes)):
        cls_rows = [r for r in rows if r[2] == label]
        order = rng.permutation(len(cls_rows))
        n_val = max(1, int(round(len(cls_rows) * args.val_frac))) \
            if len(cls_rows) > 1 else 0
        for j, k in enumerate(order):
            (val if j < n_val else train).append(cls_rows[k])
    train.sort()
    val.sort()
    _write_split(os.path.join(args.out_dir, "train.txt"), train)
    _write_split(os.path.join(args.out_dir, "val.txt"), val)
    return 0


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("extract", help="videos -> JPEG frame folders")
    e.add_argument("--video_root", required=True)
    e.add_argument("--out_root", required=True)
    e.add_argument("--tmpl", default="img_{:05d}.jpg",
                   help="frame filename template (INPUT.IMG_TMP)")
    e.add_argument("--short_side", type=int, default=0,
                   help="resize so min(H,W)==this (0 = keep native)")
    e.add_argument("--quality", type=int, default=90)
    e.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    e.add_argument("--skip_existing", action="store_true",
                   help="skip videos whose frame folder already has JPEGs")
    e.set_defaults(fn=cmd_extract)

    s = sub.add_parser("split", help="frame folders -> split files")
    s.add_argument("--frame_root", required=True)
    s.add_argument("--out_dir", required=True)
    s.add_argument("--tmpl", default="img_{:05d}.jpg")
    s.add_argument("--val_frac", type=float, default=0.0,
                   help="per-class validation fraction (0 = single all.txt)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--official_list", default="",
                   help="convert an official UCF-style list instead of "
                        "splitting (one '<class>/<video>.ext' per line)")
    s.set_defaults(fn=cmd_split)
    return p


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
