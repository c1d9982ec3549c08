"""Hand-written kernels and the temporal-graph block.

Importing the package registers K1's and K2's forwards, the max-pool
forward and the stems' convolution forward as the operators
``vgs_torch::graph_adjacency``, ``vgs_torch::gcn_propagate``,
``vgs_torch::max_pool3d_fwd`` and ``vgs_torch::stem_conv3d_fwd``, which a
graph exported by ``export_model.py`` calls."""

from . import gcn_propagate, graph_kernel, maxpool, stem_conv  # noqa: F401  (registers the operators)
