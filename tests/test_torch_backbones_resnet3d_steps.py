"""The 3D ResNets' steps against the JAX package on the CPU, and
``kernel_times``' tables for them.

* ``resnet3d_10`` + graph blocks at 2, 3, 4: one partial-BN fine-tune step
  (fp32, sampler none; only the stem's BN statistics move; B = 2, T = 16,
  32x32: under partial BN the deep stages are affine) and one GCA MoCo
  step (float64, the JAX BN pin lifted, JAX's relaxed-Bernoulli draws
  injected; B = 4, T = 16, 48x48, so stage 4 sees 2x2 frames:
  ``test_torch_backbones_resnet3d.py`` says why) in lockstep with JAX.
* A reference-named state_dict of ``resnet3d_10``, ``resnet_i3d_18`` and
  ``resnet2p1d_10`` (classifier and BN counters included, wrapped as the
  reference saves it) loads strictly through ``MODEL.PRETRAIN_PATH`` into
  both encoders of the pretrain trainer and into ``train_ds``, and both
  take a step (graph off: a reference backbone holds no graph block).
* ``kernel_times.geometry(backbone=)``: K2's inputs at the aug points and
  the stem pool's input of R3D-18 and R3D-50 (bottleneck widths) against
  the shapes of the JAX ``ResNet3D``'s ``jax.eval_shape`` at 112x112 and
  224x224; ``step_calls``: K1/K2 at three blocks, K4 once per backward, K3
  and K5 none; a 2D backbone none of the five.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_resnet_util import downstream_lockstep, make_cfg, moco_lockstep, reference_state_dict
from video_graph_ssl_tpu.models import resnet3d as jax_resnet3d
from video_graph_ssl_tpu.utils import torch_interop as ti
from video_graph_ssl_tpu_torch import train_ds
from video_graph_ssl_tpu_torch import train_video_contrast_dis as train
from video_graph_ssl_tpu_torch.kernel_times import geometry, step_calls
from video_graph_ssl_tpu_torch.utils.torch_names import port_backbone_names

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG = (2, 3, 4)


def test_resnet3d_partial_bn_finetune_step_matches_jax():
    c = make_cfg("resnet3d_10", aug=AUG)
    c.DATASET.NUM_CLASS = 8
    c.MODEL.NO_PARTIALBN = False
    moved = downstream_lockstep(c, (2, 16, 32, 32, 3))
    assert moved == ["base_model.bn1.running_mean", "base_model.bn1.running_var"]


def test_resnet3d_gca_moco_step_lockstep_with_jax(monkeypatch):
    c = make_cfg("resnet3d_10", dtype="float64", aug=AUG, sampler="relaxed_bernoulli")
    c.CROSS.FEAT_DIM = 32
    c.CONTRAST.NCE_K = 16
    # NCE_T 1.0: see test_torch_backbones_2d_steps.py's MoCo step
    c.CONTRAST.NCE_T = 1.0
    drawn = moco_lockstep(c, (4, 2, 16, 48, 48, 3), monkeypatch)
    assert sorted(drawn) == [2, 4, 8]


TINY = ["MODEL.AUG_FLAG", "False", "DATASET.SOURCE", "synthetic", "DATASET.NUM_CLASS", "4",
        "DATALOADER.BATCH_SIZE", "2", "DATALOADER.NUM_WORKERS", "1", "TEST.BATCH_SIZE", "2",
        "INPUT.VIDEO_LENGTH", "8", "INPUT.SCALE_SIZE", "[36, 36]", "INPUT.BASE_SIZE",
        "[32, 32]", "INPUT.CROP_SIZE", "[32, 32]", "CONTRAST.NCE_K", "8", "CROSS.FEAT_DIM",
        "16", "TPU.COMPUTE_DTYPE", "float32", "CHECKPOINT.PRINT_FREQ", "1"]
MANIFESTS = {"resnet3d_10": lambda: ti.reference_resnet_shape_manifest(10, 3, num_classes=10),
             "resnet_i3d_18": lambda: ti.reference_resnet_i3d_shape_manifest(18, 10),
             "resnet2p1d_10": lambda: ti.reference_resnet2p1d_shape_manifest(10, 10)}


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_reference_state_dict_loads_through_pretrain_path(name, tmp_path):
    ref = reference_state_dict(MANIFESTS[name]())
    assert "fc.weight" in ref
    sd = {f"module.{k}": torch.from_numpy(v) for k, v in ref.items()}
    sd.update({k.rsplit(".", 1)[0] + ".num_batches_tracked": torch.tensor(5)
               for k in sd if k.endswith("running_mean")})
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
    trainer.train(0)
    ds = train_ds.Trainer(train.load_config(os.path.join(REPO, "configs", "smoke_ds.yaml"),
                                            opts), max_steps=1, device="cpu",
                          run_dir=str(tmp_path / "ds"))
    got = ds.state.model.base_model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    ds.training(0)
    assert all(np.isfinite(p.detach().numpy()).all() for p in ds.state.model.parameters())


def _jax_resnet3d_shapes(name, size, batch):
    """(K2's inputs at stages 2, 3, 4; the stem pool's input) from the JAX
    ResNet3D's ``eval_shape`` with its modules' outputs captured: a stage's
    input is the previous stage's last block's output."""
    block, layers = {"resnet3d_18": ("basic", (2, 2, 2, 2)),
                     "resnet3d_50": ("bottleneck", (3, 4, 6, 3))}[name]
    model = jax_resnet3d.ResNet3D(block=block, layers=layers, dtype=jnp.bfloat16)
    x = jax.ShapeDtypeStruct((batch, 16, size, size, 3), jnp.float32)
    variables = jax.eval_shape(lambda v: model.init({"params": jax.random.key(0)}, v), x)
    _, inter = jax.eval_shape(lambda v, xx: model.apply(
        v, xx, capture_intermediates=True, mutable=["intermediates"]), variables, x)
    inter = inter["intermediates"]
    k2 = [tuple(inter[f"layer{s - 1}_{layers[s - 2] - 1}"]["__call__"][0].shape)
          for s in (2, 3, 4)]
    stem = tuple(inter["conv1"]["__call__"][0].shape)
    return k2, stem


@pytest.mark.parametrize("name", ["resnet3d_18", "resnet3d_50"])
@pytest.mark.parametrize("size,batch", [(112, 128), (224, 32)])
def test_kernel_times_resnet3d_tables_match_jax(name, size, batch):
    k1, k2, pools, seps = geometry(size, batch, name)
    k2_ref, stem_ref = _jax_resnet3d_shapes(name, size, batch)
    assert [tuple(s) for s in k2] == k2_ref
    assert [s[2] for s in k1] == [(h // 2) * (w // 2) * (c // 2) for _, _, h, w, c in k2_ref]
    assert seps == []
    (_, kn, shape, k, s, p), = pools
    assert (kn, shape, k, s, p) == ("K4", stem_ref, (3, 3, 3), (2, 2, 2), (1, 1, 1))


def test_step_calls_of_the_new_backbones():
    assert step_calls("moco", backbone="resnet3d_18") == {
        "graph_adjacency": 6, "gcn_propagate": 9, "maxpool_bwd_s1": 0,
        "maxpool_bwd_strided": 1, "sepconv_bwd": 0}
    assert step_calls("finetune", partial_bn=True, backbone="resnet2p1d_50") == {
        "graph_adjacency": 3, "gcn_propagate": 6, "maxpool_bwd_s1": 0,
        "maxpool_bwd_strided": 1, "sepconv_bwd": 0}
    for name in ("resnet101", "bninception", "inception_v3"):
        assert set(step_calls("moco", fused=True, backbone=name).values()) == {0}
        assert geometry(224, 16, name) == ([], [], [], [])
