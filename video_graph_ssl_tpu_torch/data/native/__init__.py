"""Native (C++) host components: the GIL-free libjpeg decode pool of the
frame-folder path (``INPUT.PRE_LOAD native``)."""

from .jpeg_pool import NativeJpegPool, native_jpeg_available

__all__ = ["NativeJpegPool", "native_jpeg_available"]
