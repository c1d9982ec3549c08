"""The 2D branch's steps against the JAX package on the CPU.

* ``temporal_aggregate`` avg and max against JAX's, and ``MODEL.POOLING_TYPE
  max`` through the whole encoder; ``layers.avg_pool3x3`` against the
  library pool's own gradient (and, on the card, against the CPU).
* ``resnet18``: one partial-BN fine-tune step (fp32; only the stem's BN
  statistics move) and one MoCo step (float64) in lockstep with JAX.
* A reference-named file loads strictly through ``MODEL.PRETRAIN_PATH``
  into the pretrain trainer's two encoders and into ``train_ds``
  (ResNet-18, BN-Inception, Inception-v3), and ResNet-18 takes a step in
  each.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_resnet_util import (downstream_lockstep, eval_parity, make_cfg, moco_lockstep,
                                reference_state_dict, rel_l2)
from video_graph_ssl_tpu.ops.pooling import temporal_aggregate as jax_aggregate
from video_graph_ssl_tpu.utils import torch_interop
from video_graph_ssl_tpu_torch import train_ds
from video_graph_ssl_tpu_torch import train_video_contrast_dis as train
from video_graph_ssl_tpu_torch.models import layers
from video_graph_ssl_tpu_torch.ops.pooling import temporal_aggregate
from video_graph_ssl_tpu_torch.utils.torch_names import port_backbone_names

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURE_DIMS = {"resnet18": 512, "resnet34": 512, "resnet50": 2048, "resnet101": 2048,
                "resnet152": 2048, "bninception": 1024, "inception_v3": 2048}
DEPTHS = {"resnet18": 18, "resnet34": 34, "resnet50": 50, "resnet101": 101, "resnet152": 152}


def cfg2d(name, dtype="float32", **kw):
    return make_cfg(name, "2D", dtype, **kw)


@pytest.mark.parametrize("mode", ["avg", "max"])
def test_temporal_aggregate_matches_jax(mode):
    x = np.random.default_rng(3).standard_normal((3, 5, 7)).astype(np.float32)
    for axis in (1, 2):
        ref = np.asarray(jax_aggregate(jnp.asarray(x), mode, axis))
        np.testing.assert_allclose(temporal_aggregate(torch.from_numpy(x), mode, axis).numpy(),
                                   ref, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="aggregation"):
        temporal_aggregate(torch.from_numpy(x), "sum")


@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last])
def test_avg_pool3x3_backward_is_the_library_pools_gradient(layout):
    """``layers.avg_pool3x3`` (the 2D nets' branch pools) against
    ``F.avg_pool2d``'s own autograd on the CPU, float64, both layouts and a
    cotangent in either: the box average is its own adjoint."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(3, 5, 9, 7, dtype=torch.float64, generator=g).contiguous(
        memory_format=layout)
    gy = torch.randn(3, 5, 9, 7, dtype=torch.float64, generator=g)
    got_x, ref_x = x.clone().requires_grad_(), x.clone().requires_grad_()
    y = layers.avg_pool3x3(got_x)
    ref = F.avg_pool2d(ref_x, 3, 1, 1)
    assert torch.equal(y, ref)
    (y * gy).sum().backward()
    (ref * gy).sum().backward()
    torch.testing.assert_close(got_x.grad, ref_x.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_avg_pool3x3_on_card_equals_cpu():
    """On the card the 3x3/1 average pool's gradient equals the CPU's for a
    channels-last input and a contiguous cotangent, where PyTorch's own
    CUDA backward of ``avg_pool2d`` is wrong (``chip_smoke.py`` phase 14
    (b) prints its error)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(10)
    x = torch.randn(64, 32, 17, 16, generator=g).contiguous(memory_format=torch.channels_last)
    gy = torch.randn(64, 32, 17, 16, generator=g)
    grads = []
    for dev in ("cpu", "cuda"):
        xd = x.to(dev).requires_grad_()
        (layers.avg_pool3x3(xd) * gy.to(dev)).sum().backward()
        grads.append(xd.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-6)


def test_max_pooling_type_matches_jax():
    feat, feat_ref, _, _, _ = eval_parity(cfg2d("resnet18", pooling="max"), (2, 3, 64, 64, 3))
    assert rel_l2(feat, feat_ref) < 1e-5


def test_resnet18_partial_bn_finetune_step_matches_jax():
    c = cfg2d("resnet18")
    c.DATASET.NUM_CLASS = 8
    c.MODEL.NO_PARTIALBN = False
    moved = downstream_lockstep(c, (2, 3, 64, 64, 3))
    assert moved == ["base_model.bn1.running_mean", "base_model.bn1.running_var"]


def test_resnet18_moco_step_lockstep_with_jax(monkeypatch):
    c = cfg2d("resnet18", "float64")
    c.CROSS.FEAT_DIM = 32
    c.CONTRAST.NCE_K = 16
    # At NCE_T 0.07 a random-init ResNet's loss saturates (3.2e-4): the BN
    # biases' updates (~5e-5) are the cancelling remainder of the fp32
    # feature rounding both packages share, and differ by ~2e-9 (1e-4 of
    # them).  At NCE_T 1.0 the same ~2e-9 sits on updates 100x larger.
    c.CONTRAST.NCE_T = 1.0
    moco_lockstep(c, (4, 2, 2, 64, 64, 3), monkeypatch)


# --------------------------------------------------------------------------- #
# the reference's names
# --------------------------------------------------------------------------- #
def _manifest_and_converter(name):
    if name in DEPTHS:
        return (torch_interop.reference_resnet_shape_manifest(DEPTHS[name], 2),
                lambda sd: torch_interop.convert_torch_resnet(sd, 2))
    if name == "bninception":
        return (torch_interop.reference_bninception_shape_manifest(),
                torch_interop.convert_torch_bninception)
    return (torch_interop.reference_inception_v3_shape_manifest(),
            torch_interop.convert_torch_inception_v3)


TINY = ["MODEL.AUG_FLAG", "True", "MODEL.BACKBONE_TYPE", "2D", "DATASET.SOURCE", "synthetic",
        "DATASET.NUM_CLASS", "4", "DATALOADER.BATCH_SIZE", "2", "DATALOADER.NUM_WORKERS", "1",
        "TEST.BATCH_SIZE", "2", "INPUT.VIDEO_LENGTH", "2", "INPUT.SCALE_SIZE", "[36, 36]",
        "INPUT.BASE_SIZE", "[32, 32]", "INPUT.CROP_SIZE", "[32, 32]", "CONTRAST.NCE_K", "8",
        "CROSS.FEAT_DIM", "16", "TPU.COMPUTE_DTYPE", "float32", "CHECKPOINT.PRINT_FREQ", "1"]


@pytest.mark.parametrize("name", ["resnet18", "bninception", "inception_v3"])
def test_reference_state_dict_loads_through_pretrain_path(name, tmp_path):
    """A reference-named file (classifier, BN counters and conv biases
    included, wrapped as the reference saves it) warm-starts both encoders
    of the pretrain trainer and train_ds's backbone, strictly; ResNet-18
    then takes a step in each (the Inception nets need larger frames)."""
    manifest, _ = _manifest_and_converter(name)
    ref = reference_state_dict(manifest)
    sd = {f"module.{k}": torch.from_numpy(v) for k, v in ref.items()}
    sd.update({k.rsplit(".", 1)[0] + ".num_batches_tracked": torch.tensor(5)
               for k in sd if k.endswith("running_mean")})
    sd["module.fc.weight"] = torch.zeros(10, FEATURE_DIMS[name])
    sd["module.fc.bias"] = torch.zeros(10)
    path = str(tmp_path / "reference.pth")
    torch.save({"state_dict": sd}, path)
    want = port_backbone_names({k: torch.from_numpy(v) for k, v in ref.items()})
    opts = TINY + ["MODEL.BACKBONE", name, "MODEL.PRETRAINED", "True",
                   "MODEL.PRETRAIN_PATH", path]
    trainer = train.Trainer(train.load_config(os.path.join(REPO, "configs", "visual_moco.yaml"),
                                              opts),
                            max_steps=1, device="cpu", run_dir=str(tmp_path / "run"))
    for model in (trainer.state.model, trainer.state.ema_model):
        got = model.model.encoder.base_model.state_dict()
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    ds = train_ds.Trainer(train.load_config(os.path.join(REPO, "configs", "smoke_ds.yaml"),
                                            opts), max_steps=1, device="cpu",
                          run_dir=str(tmp_path / "ds"))
    got = ds.state.model.base_model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    if name == "resnet18":
        trainer.train(0)
        ds.training(0)
        assert all(np.isfinite(p.detach().numpy()).all() for p in ds.state.model.parameters())
