"""Whole-video host IO and result caching (counterpart of
``video_graph_ssl_tpu/data/video_io.py``; reference
lib/data/datasets/utils.py:16-88 and :141-156).

cv2 is the codec; the ffmpeg and ffprobe binaries, where installed, are
used as subprocesses (``write_video`` prefers ffmpeg, ``video_info``
ffprobe), as in the JAX package.  All of them are looked up inside the
functions, so the package imports where none exists; a function that needs
one raises then (``load_video`` reports and returns ``(None, None)``).
Everything here is host-side uint8 numpy.
"""

from __future__ import annotations

import functools
import json
import os
import pickle
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def video_info(path: str) -> dict:
    """Container metadata: ``{"width", "height", "fps", "num_frames"}``
    (ffprobe's video stream where ffprobe is installed, else cv2's)."""
    ffprobe = shutil.which("ffprobe")
    if ffprobe is not None:
        out = subprocess.run(
            [ffprobe, "-v", "quiet", "-print_format", "json",
             "-show_streams", "-select_streams", "v:0", path],
            capture_output=True, check=True).stdout
        stream = json.loads(out)["streams"][0]
        num, den = (stream.get("avg_frame_rate") or "0/1").split("/")
        fps = float(num) / float(den) if float(den) else 0.0
        return {"width": int(stream["width"]), "height": int(stream["height"]),
                "fps": fps, "num_frames": int(stream.get("nb_frames", 0) or 0)}
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("video_info needs cv2 or ffprobe")
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise IOError(f"failed to open video {path}")
        return {"width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                "fps": float(cap.get(cv2.CAP_PROP_FPS)),
                "num_frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
    finally:
        cap.release()


def load_video(path: str) -> Tuple[Optional[np.ndarray], Optional[float]]:
    """Decode a whole video -> ((N, H, W, 3) RGB uint8, fps), or prints why
    and returns ``(None, None)`` (the reference ffmpeg loader's contract);
    decoding stops at the end of the stream."""
    try:
        cv2 = _cv2()
        if cv2 is None:
            raise RuntimeError("cv2 unavailable")
        cap = cv2.VideoCapture(path)
        try:
            if not cap.isOpened():
                raise IOError(f"failed to open video {path}")
            fps = float(cap.get(cv2.CAP_PROP_FPS))
            frames = []
            while True:
                ret, frame = cap.read()
                if not ret or frame is None:
                    break
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            if not frames:
                raise IOError(f"no frames decoded from {path}")
            return np.stack(frames, axis=0), fps
        finally:
            cap.release()
    except Exception as e:
        print(f"failed to load video {path}")
        print(e)
        return None, None


def _as_uint8_video(video) -> np.ndarray:
    """uint8 [0, 255] as it is, float [0, 1] scaled by 255 and clipped;
    (N, H, W, 3); numpy or torch (CPU) input."""
    video = np.asarray(video)
    if video.dtype != np.uint8:
        video = np.clip(video * 255.0, 0, 255).astype(np.uint8)
    assert video.ndim == 4 and video.shape[-1] == 3, video.shape
    return video


def write_video(video, path: str, fps: float = 25.0) -> None:
    """Encode (N, H, W, 3) RGB to ``path``: the ffmpeg binary where
    installed (yuv420p, 5000k), else cv2's writer (MJPG for .avi, mp4v
    otherwise)."""
    video = _as_uint8_video(video)
    n, h, w, _ = video.shape
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is not None:
        proc = subprocess.Popen(
            [ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
             "-s", f"{w}x{h}", "-r", str(fps), "-i", "pipe:",
             "-pix_fmt", "yuv420p", "-b:v", "5000k", path],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        proc.stdin.write(video.tobytes())
        proc.stdin.close()
        proc.wait()
    else:
        cv2 = _cv2()
        if cv2 is None:
            raise RuntimeError("write_video needs cv2 or ffmpeg")
        ext = os.path.splitext(path)[1].lower()
        fourcc = cv2.VideoWriter_fourcc(*("MJPG" if ext == ".avi" else "mp4v"))
        out = cv2.VideoWriter(path, fourcc, fps, (w, h))
        try:
            assert out.isOpened(), f"failed to open writer for {path}"
            for frame in video:
                out.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        finally:
            out.release()
    print("saved video to " + path)


def cache(cache_file: str):
    """Decorator caching a function's result in ``cache_file`` (pickle):
    the first call computes and saves, later calls load it, whatever their
    arguments (reference utils.py:141-156)."""
    def cache_decorator(fn):
        @functools.wraps(fn)
        def newf(*args, **kwargs):
            if os.path.exists(cache_file):
                print(f"Loading cached result from '{cache_file}'")
                with open(cache_file, "rb") as f:
                    return pickle.load(f)
            res = fn(*args, **kwargs)
            print(f"Saving result to cache '{cache_file}'")
            with open(cache_file, "wb") as f:
                pickle.dump(res, f)
            return res
        return newf
    return cache_decorator
