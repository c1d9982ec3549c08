"""The port's S3D + graph under ``TPU.REMAT`` against the JAX package's
under the same setting (``nn.remat``, and ``save_only_these_names
("conv_out")`` for ``conv_saved``), train mode, float64, on the same
weights: the set-up, tolerances and gradient floor of
``tests/test_torch_models_grads.py`` (output 1e-4 rel-L2, each parameter
gradient 1e-4 of its norm, the BN running statistics 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import np_tree, rel_l2
from test_torch_models import TRAIN_AUG, jax_train_apply, s3d_cfg, s3d_setup
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.utils.jax_weights import (load_pretrain_weights,
                                                         pretrain_state_dict)

torch.set_num_threads(1)


@pytest.mark.parametrize("policy", ["block", "conv_saved"])
def test_s3d_remat_matches_jax_remat(policy):
    x, gout, params, stats = s3d_setup(aug=TRAIN_AUG)
    cfg = s3d_cfg("float64", TRAIN_AUG)
    cfg.TPU.REMAT = True
    cfg.TPU.REMAT_POLICY = policy
    with jax.enable_x64():
        jmodel, _ = jax_create(cfg)
        assert jmodel.encoder_cfg["remat"] == (True if policy == "block" else policy)

        def loss(p, xx):
            out, new_stats = jax_train_apply(jmodel, p, stats, xx)
            return jnp.sum(out * gout), (out, new_stats)

        (_, (out_ref, new_stats)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(params, jnp.asarray(x, jnp.float64))
        out_ref, new_stats, grads = np.asarray(out_ref), np_tree(new_stats), np_tree(grads)

    model, _ = create_visual_model(cfg)
    assert model.model.encoder.base_model.remat == jmodel.encoder_cfg["remat"]
    load_pretrain_weights(model, params, stats, "S3D")
    model.train()
    out = model(torch.from_numpy(x).double())
    (out * torch.from_numpy(gout)).sum().backward()
    assert rel_l2(out.detach().numpy(), out_ref) < 1e-4

    ref_sd = pretrain_state_dict(params, new_stats, "S3D")
    for name, buf in model.named_buffers():
        assert rel_l2(buf.numpy(), ref_sd[name]) < 1e-4, name
    ref = pretrain_state_dict(grads, stats, "S3D")
    named = dict(model.named_parameters())
    floor = 1e-9 * max(np.linalg.norm(ref[n]) for n in named)
    for name, p in named.items():
        diff = np.linalg.norm(p.grad.numpy().astype(np.float64) - ref[name])
        assert diff < 1e-4 * max(np.linalg.norm(ref[name]), floor), name
