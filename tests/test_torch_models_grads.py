"""Parameter gradients of the port's S3D + graph model against ``jax.grad``
of the JAX package (train mode, float64, graph block at stage 5; see
test_torch_models.py for the set-up and the precision choices)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_util import np_tree, rel_l2
from test_torch_models import (TRAIN_AUG, jax_train_apply, port_model, s3d_cfg,
                               s3d_setup)
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu_torch.utils.jax_weights import pretrain_state_dict

torch.set_num_threads(1)


def test_s3d_graph_param_grads_match_jax():
    x, gout, params, stats = s3d_setup(aug=TRAIN_AUG)
    with jax.enable_x64():
        jmodel, _ = jax_create(s3d_cfg("float64", TRAIN_AUG))

        def loss(p, xx):
            out, _ = jax_train_apply(jmodel, p, stats, xx)
            return jnp.sum(out * gout), out

        (_, out_ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params, jnp.asarray(x, jnp.float64))
        out_ref, grads = np.asarray(out_ref), np_tree(grads)

    model = port_model("float64", params, stats, TRAIN_AUG).train()
    out = model(torch.from_numpy(x).double())
    (out * torch.from_numpy(gout)).sum().backward()
    assert rel_l2(out.detach().numpy(), out_ref) < 1e-4

    ref = pretrain_state_dict(grads, stats, "S3D")
    named = dict(model.named_parameters())
    assert len(named) == len([k for k in ref if "running" not in k])
    # A gradient below 1e-9 of the largest one is cancellation noise in
    # both packages (e.g. BN biases whose effect the next train-mode BN
    # removes); it is held to that floor instead of its own norm.
    floor = 1e-9 * max(np.linalg.norm(ref[n]) for n in named)
    for name, p in named.items():
        assert p.grad is not None, name
        diff = np.linalg.norm(p.grad.numpy().astype(np.float64) - ref[name])
        assert diff < 1e-4 * max(np.linalg.norm(ref[name]), floor), name
