"""Multi-GPU training: process groups, per-rank batch rows, cross-rank
collectives (``dist``), global-batch BN (``sync_bn``), ShuffleBN
(``shuffle_bn``) and the graph block's frame-axis ring (``sequence``); the
counterpart of ``video_graph_ssl_tpu/parallel``'s mesh, ShuffleBN and
sequence modules.  The ring's five functions are exported under JAX's
names."""

_SEQUENCE = ("ring_similarity", "ring_propagate", "rowfold_bernoulli_sample",
             "sp_graph_aug_apply", "graph_aug_sequence_parallel")
__all__ = list(_SEQUENCE)


def __getattr__(name):
    # imported on first use: ``sequence`` imports the ops, which import the
    # models' layers, which import this package's ``dist`` and ``sync_bn``
    if name in _SEQUENCE:
        from . import sequence

        return getattr(sequence, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
