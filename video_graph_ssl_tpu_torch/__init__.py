"""video_graph_ssl_tpu_torch -- the PyTorch/CUDA port of video_graph_ssl_tpu.

The JAX package beside it is the reference this port is held against.
Module paths copy the JAX package's.  The hand-written Hopper kernels live
in ``csrc/`` and are built at first use by ``ops/_build.py``.
"""

__version__ = "0.1.0"
