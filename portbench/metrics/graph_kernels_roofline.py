"""K1 and K2 (``csrc/graph_adjacency.cu``, ``csrc/gcn_propagate.cu``):
percent of their roofline.  The least time every K1 and K2 call of a step
could take (inputs read once, outputs written once, or the bf16 operations,
whichever is longer) over the device time of the kernels named K1 and K2,
per step."""

from ._classes import K1, K2
from ._rooflines import graph_bound_s


def read(summary):
    ms = summary["class_ms"].get(K1, 0.0) + summary["class_ms"].get(K2, 0.0)
    if not ms:
        return None
    passes = summary["passes"]
    bound = graph_bound_s(summary["settings"], passes["forward"], passes["backward"],
                          summary["ranks"])
    return 100.0 * bound * 1e3 / ms
