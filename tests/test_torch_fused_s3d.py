"""S3D with ``TPU.SEPCONV_FUSED`` (the 18 Mixed-block branch SepConvs on
the fused pair of ``ops/fused_sepconv.py``) against the JAX package's
``S3D(fused_sepconv=True)`` on the CPU, set up as in
``tests/test_torch_models.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_util import np_tree, rel_l2
from test_torch_models import TRAIN_AUG, jax_train_apply, s3d_cfg, s3d_setup
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.models.layers import SepConv3d
from video_graph_ssl_tpu_torch.utils.jax_weights import (
    load_pretrain_weights, pretrain_state_dict)

torch.set_num_threads(1)


def test_s3d_fused_matches_jax_float64():
    """S3D + graph (stage 5) with TPU.SEPCONV_FUSED against JAX
    S3D(fused_sepconv=True), train mode, as tests/test_torch_models.py runs
    it: output, running statistics and parameter gradients.

    Tolerance.  The 18 fused pairs normalise in fp32 in both packages
    (flax's fast-variance path casts to fp32) while the rest runs in
    float64, and train-mode BN over 2-16 values per channel in the deep
    stages amplifies fp32 rounding, as it does between JAX's own fused and
    unfused models.  On these inputs the port sits 3.8e-4 from JAX (output,
    rel-L2) and at most 1.1e-2 (a parameter gradient), so the output is held
    to 2e-3 and each gradient to 5e-2; a wrong gradient formula is off by
    O(1), and each pair is held to 2e-4 by test_torch_fused_sepconv.py."""
    x, gout, params, stats = s3d_setup(aug=TRAIN_AUG)
    cfg = s3d_cfg("float64", TRAIN_AUG)
    cfg.TPU.SEPCONV_FUSED = True
    with jax.enable_x64():
        jmodel, _ = jax_create(cfg)

        def loss(p, xx):
            out, new_stats = jax_train_apply(jmodel, p, stats, xx)
            return jnp.sum(out * gout), (out, new_stats)

        (_, (out_ref, new_stats)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(params, jnp.asarray(x, jnp.float64))
        out_ref, new_stats, grads = np.asarray(out_ref), np_tree(new_stats), np_tree(grads)

    model, _ = create_visual_model(cfg)
    seps = [m for m in model.modules() if isinstance(m, SepConv3d)]
    assert sum(m.fused for m in seps) == 18 and len(seps) == 20
    load_pretrain_weights(model, params, stats, "S3D")
    model.train()
    out = model(torch.from_numpy(x).double())
    (out * torch.from_numpy(gout)).sum().backward()
    assert rel_l2(out.detach().numpy(), out_ref) < 2e-3

    ref_sd = pretrain_state_dict(params, new_stats, "S3D")
    for name, buf in model.named_buffers():
        assert rel_l2(buf.numpy(), ref_sd[name]) < 1e-4, name
    ref = pretrain_state_dict(grads, stats, "S3D")
    named = dict(model.named_parameters())
    # as in test_torch_models_grads.py: a gradient below 1e-9 of the largest
    # one is cancellation noise and is held to that floor
    floor = 1e-9 * max(np.linalg.norm(ref[n]) for n in named)
    for name, p in named.items():
        diff = np.linalg.norm(p.grad.numpy().astype(np.float64) - ref[name])
        assert diff < 5e-2 * max(np.linalg.norm(ref[name]), floor), name
