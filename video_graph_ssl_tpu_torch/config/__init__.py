"""Config package: ``from video_graph_ssl_tpu_torch.config import cfg``.

The JAX package's schema (``video_graph_ssl_tpu/config``), copied so the
port imports nothing of that package: the same YAML files and ``KEY VALUE``
overrides work unchanged.
"""

from .defaults import cfg
from .node import CfgNode

__all__ = ["cfg", "CfgNode"]
