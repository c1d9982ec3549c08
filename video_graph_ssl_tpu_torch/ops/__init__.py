"""Hand-written kernels and the temporal-graph block.

Importing the package registers K1's and K2's forwards as the operators
``vgs_torch::graph_adjacency`` and ``vgs_torch::gcn_propagate``, which a
graph exported by ``export_model.py`` calls."""

from . import gcn_propagate, graph_kernel  # noqa: F401  (registers the operators)
