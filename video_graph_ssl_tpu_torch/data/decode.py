"""Host-side frame decoding (counterpart of ``video_graph_ssl_tpu/data/decode.py``).

JPEG -> RGB uint8 -> bilinear resize to a fixed canvas; everything after
(crops, jitter, normalisation) runs on the device
(``data/transforms_device.py``).  cv2 and PIL are imported inside the
functions that use them, so the package imports where neither is
installed (a shard store needs no codec, ``data/shards.py``); asking for a
JPEG path there raises an ``ImportError`` that names them.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _no_codec() -> ImportError:
    return ImportError("decoding JPEG frames needs cv2 (opencv-python) or PIL "
                       "(Pillow), and neither is installed; build a shard store "
                       "where one is (python -m video_graph_ssl_tpu_torch."
                       "build_shards) and train with INPUT.PRE_LOAD shard")


def opencv_loader(path: str) -> np.ndarray:
    """JPEG -> RGB uint8 HWC (reference: utils.py:123-129)."""
    cv2 = _cv2()
    if cv2 is None:
        raise _no_codec()
    img = cv2.imread(path)
    assert img is not None, f"failed to read {path}"
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def pil_loader(path: str) -> np.ndarray:
    """PIL loader (reference: utils.py:91-112)."""
    Image = _pil_image()
    if Image is None:
        raise _no_codec()
    with open(path, "rb") as f:
        img = Image.open(f)
        return np.asarray(img.convert("RGB"))


_NATIVE_POOL = None


def _native_pool():
    """Lazy per-process singleton of the C++ decode pool; raises with the
    build error when g++ or libjpeg is missing."""
    global _NATIVE_POOL
    if _NATIVE_POOL is None:
        from .native import NativeJpegPool

        _NATIVE_POOL = NativeJpegPool()
    return _NATIVE_POOL


def load_image(path: str, pre_load: str = "cv2") -> np.ndarray:
    """One frame: cv2 when asked for and installed, else PIL (as the JAX
    package).  ``native`` without a canvas decodes one frame at a time,
    which is cv2's job there too."""
    if pre_load == "native":
        pre_load = "cv2"
    if pre_load == "cv2" and _cv2() is not None:
        return opencv_loader(path)
    return pil_loader(path)


def load_flow_pair(directory: str, tmpl: str, idx: int,
                   pre_load: str = "cv2") -> List[np.ndarray]:
    """Flow modality: x/y channel images (reference: dataset.py:58-66)."""
    x_img = load_image(os.path.join(directory, tmpl.format("x", idx)), pre_load)
    y_img = load_image(os.path.join(directory, tmpl.format("y", idx)), pre_load)
    if x_img.ndim == 3:
        x_img = x_img[..., 0]
    if y_img.ndim == 3:
        y_img = y_img[..., 0]
    return [x_img, y_img]


def resize_frame(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize to (H, W) on the host (cv2, else PIL)."""
    h, w = size_hw
    if img.shape[0] == h and img.shape[1] == w:
        return img
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    Image = _pil_image()
    if Image is None:
        raise _no_codec()
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


def load_clip(
    directory: str,
    image_tmpl: str,
    indices: Sequence[int],
    pre_load: str = "cv2",
    canvas_hw: Optional[Tuple[int, int]] = None,
    modality: str = "RGB",
    new_length: int = 1,
    num_frames: Optional[int] = None,
) -> np.ndarray:
    """Decode the frames at 1-based ``indices`` -> (T, H, W, C*new_length) uint8.

    For each sampled index, ``new_length`` consecutive frames are loaded and
    stacked along the channel axis, saturating at ``num_frames`` (reference:
    dataset.py:178-191).  Flow stacks ``2*new_length`` channels, RGB and
    RGBDiff ``3*new_length``.  ``pre_load='native'`` with a canvas decodes
    the whole clip in one call on the C++ pool (``data/native``).
    """
    L = max(1, int(new_length))
    if pre_load == "native" and modality in ("RGB", "RGBDiff") \
            and canvas_hw is not None:
        paths = []
        for idx in indices:
            p = int(idx)
            for _ in range(L):
                paths.append(os.path.join(directory, image_tmpl.format(p)))
                if num_frames is None or p < int(num_frames):
                    p += 1
        arr = _native_pool().decode_batch(paths, *canvas_hw)
        t = len(indices)
        if L == 1:
            return arr
        arr = arr.reshape(t, L, *arr.shape[1:])        # (T, L, H, W, 3)
        return np.ascontiguousarray(
            arr.transpose(0, 2, 3, 1, 4)).reshape(
                t, arr.shape[2], arr.shape[3], L * 3)

    frames = []
    for idx in indices:
        p = int(idx)
        steps = []
        for _ in range(L):
            if modality == "Flow":
                img = np.stack(load_flow_pair(directory, image_tmpl, p, pre_load),
                               axis=-1)
            else:
                img = load_image(
                    os.path.join(directory, image_tmpl.format(p)), pre_load)
            if canvas_hw is not None:
                img = resize_frame(img, canvas_hw)
            if img.ndim == 2:
                img = img[..., None]
            steps.append(img)
            if num_frames is None or p < int(num_frames):
                p += 1
        frames.append(steps[0] if len(steps) == 1
                      else np.concatenate(steps, axis=-1))
    return np.stack(frames, axis=0)
