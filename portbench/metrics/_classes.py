"""Kernel-name patterns -> class, first match wins: a frozen copy of
``video_graph_ssl_tpu_torch/profile_step.py:CLASSES``.  The rooflines find
the hand-written kernels by these names; a kernel renamed in the program
leaves its roofline unread until a benchmark change points it at the new
name."""

CLASSES = (
    ("K1 adjacency", r"sim_partial_kernel|adjacency_epilogue_kernel"),
    ("K2 propagate", r"propagate_tc_kernel|propagate_simt_kernel"),
    ("K3/K4 max-pool backward", r"maxpool_bwd_kernel"),
    ("K5 sepconv backward", r"conv_taps_kernel|wgrad_taps_kernel|bn_sums_kernel|bn_means_kernel|"
                            r"bn_bwd_kernel|bn_bwd_vec_kernel|split_sum_kernel|"
                            r"sep_prep_kernel|sep_tc_p[1-6]_"),
    ("batch norm", r"batch_norm|batchnorm|bn_fw|bn_bw|bn_"),
    ("conv (cuDNN/cutlass)", r"conv|cudnn|xmma|implicit|dgrad|wgrad|fprop|sm90_|cutlass|nhwc"),
    ("gemm", r"gemm|cublas|matmul"),
    ("max pool", r"max_pool|maxpool|pool"),
    ("reduce", r"reduce"),
    ("copy / layout", r"copy|transpose|permute|cat|fill|index"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)
K1, K2, K34 = "K1 adjacency", "K2 propagate", "K3/K4 max-pool backward"
