"""Hand-written kernels and the temporal-graph block.

Importing the package registers K1's and K2's forwards and the max-pool
forward as the operators ``vgs_torch::graph_adjacency``,
``vgs_torch::gcn_propagate`` and ``vgs_torch::max_pool3d_fwd``, which a
graph exported by ``export_model.py`` calls."""

from . import gcn_propagate, graph_kernel, maxpool  # noqa: F401  (registers the operators)
