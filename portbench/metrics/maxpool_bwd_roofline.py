"""K3/K4 (``csrc/maxpool_bwd.cu``): percent of their roofline.  The least
time every max-pool backward of a step could take (x and dy read once, dx
written once, at the HBM rate) over the device time of the kernels named
K3/K4, per step."""

from ._classes import K34
from ._rooflines import maxpool_bwd_bound_s


def read(summary):
    ms = summary["class_ms"].get(K34)
    if not ms:
        return None
    bound = maxpool_bwd_bound_s(summary["settings"], summary["passes"]["backward"],
                                summary["ranks"])
    return 100.0 * bound * 1e3 / ms
