"""Multi-GPU training: process groups, per-rank batch rows, cross-rank
collectives (``dist``), global-batch BN (``sync_bn``) and ShuffleBN
(``shuffle_bn``); the counterpart of ``video_graph_ssl_tpu/parallel``'s
mesh and ShuffleBN modules."""
