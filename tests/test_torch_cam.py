"""The port's Grad-CAM (``video_graph_ssl_tpu_torch/cam.py``) on the CPU.

* ``build_cam_fn`` against the JAX tool's own (``tools/cam.py``, imported
  from its file) on the same weights and uint8 canvases, fp32: tiny3d with
  its graph block at 1, and a micro S3D (T 8, 64x64, so that ``mixed_5c``
  is 1x2x2 and its map not constant; graph blocks at 5 and 9); CAMs
  within 1e-4, the logits within 1e-5 (rel-L2), both head self-checks
  below 1e-4; a chosen class gives another map.
* A backbone without a head recompute is refused with JAX's message, and an
  unknown layer with JAX's.
* The CLI end to end from a downstream checkpoint (``--device cpu``):
  ``cam_*.npz`` with the cam in [0, 1] at (T, H, W) and the frames.
"""

import glob
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import rel_l2
from video_graph_ssl_tpu.engine import create_downstream_state as jax_ds_state
from video_graph_ssl_tpu.models import create_video_model as jax_video_model
from video_graph_ssl_tpu_torch import cam
from video_graph_ssl_tpu_torch.engine.build import create_downstream_state
from video_graph_ssl_tpu_torch.models.build import create_video_model
from video_graph_ssl_tpu_torch.utils.checkpoint import save_checkpoint_state
from video_graph_ssl_tpu_torch.utils.jax_weights import load_downstream_weights

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cam():
    spec = importlib.util.spec_from_file_location("jax_tool_cam",
                                                  os.path.join(REPO, "tools", "cam.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(tiny_cfg, backbone):
    c = tiny_cfg.clone()
    if backbone == "S3D":
        c.MODEL.BACKBONE = "S3D"
        c.GRAPH.AUG_POINTS = (5, 9)
        c.INPUT.VIDEO_LENGTH = 8
        c.INPUT.BASE_SIZE = c.INPUT.CROP_SIZE = [64, 64]
        c.INPUT.SCALE_SIZE = [72, 72]
        c.TPU.PACK_POINTWISE = False
    return c


def _raw(c, n=2):
    t = int(c.INPUT.VIDEO_LENGTH)
    hw = (int(c.INPUT.SCALE_SIZE[0]), int(c.INPUT.SCALE_SIZE[1]))
    return np.random.default_rng(0).integers(0, 256, (n, t, *hw, 3), dtype=np.uint8)


def _models(c):
    """The JAX state and the port's classifier on its weights."""
    jmodel, _ = jax_video_model(c)
    t, base = int(c.INPUT.VIDEO_LENGTH), tuple(int(s) for s in c.INPUT.CROP_SIZE)
    state, _ = jax_ds_state(c, jmodel, np.zeros((2, t, *base, 3), np.float32))
    model, _ = create_video_model(c)
    load_downstream_weights(model, state.params, state.batch_stats, c.MODEL.BACKBONE)
    return jmodel, state, model


@pytest.mark.parametrize("backbone", ["tiny3d", "S3D"])
def test_cam_matches_jax(tiny_cfg, backbone):
    c = _cfg(tiny_cfg, backbone)
    jmodel, state, model = _models(c)
    tool = _jax_cam()
    layer = tool._HEADS[backbone][1]
    assert cam.HEADS[backbone][1] == layer
    t, base = int(c.INPUT.VIDEO_LENGTH), tuple(int(s) for s in c.INPUT.CROP_SIZE)
    jfn = tool.build_cam_fn(c, jmodel, backbone, layer, (t, *base))
    fn = cam.build_cam_fn(c, model, backbone, layer, (t, *base))
    raw = _raw(c)
    maps = {}
    for class_id in (-1, 2):
        want, wlogits, werr = (np.asarray(v) for v in jfn(state, jnp.asarray(raw), class_id))
        got, logits, err = fn(model, torch.from_numpy(raw), class_id)
        assert float(werr) < 1e-4 and err < 1e-4
        assert rel_l2(logits.numpy(), wlogits) < 1e-5
        assert got.shape == want.shape == (raw.shape[0], t, *base)
        assert float(np.abs(got.numpy() - want).max()) < 1e-4
        maps[class_id] = got
    assert not torch.allclose(maps[-1], maps[2])


def test_refusals_match_jax(tiny_cfg):
    jax_msg = (f"Grad-CAM head recompute supports {sorted(_jax_cam()._HEADS)}, "
               "got I3D")
    with pytest.raises(ValueError) as e:
        cam.check_backbone("I3D")
    assert str(e.value) == jax_msg
    c = _cfg(tiny_cfg, "tiny3d")
    model, _ = create_video_model(c)
    with pytest.raises(ValueError, match="layer 'mixed_5c' not found in the backbone"):
        cam.build_cam_fn(c, model, "tiny3d", "mixed_5c", (4, 16, 16))


def test_cli_on_cpu(tiny_cfg, tmp_path):
    c = _cfg(tiny_cfg, "tiny3d")
    model, _ = create_video_model(c)
    ckpt = str(tmp_path / "model_best_state.pth.tar")
    save_checkpoint_state(ckpt, create_downstream_state(c, model, "cpu"), epoch=1)
    out = tmp_path / "cams"
    opts = ["MODEL.BACKBONE", "tiny3d", "MODEL.BACKBONE_TYPE", "3D", "MODEL.AUG_FLAG", "True",
            "DATASET.SOURCE", "synthetic", "DATASET.NUM_CLASS", "8", "TEST.BATCH_SIZE", "2",
            "INPUT.VIDEO_LENGTH", "4", "INPUT.SCALE_SIZE", "[20, 20]",
            "INPUT.BASE_SIZE", "[16, 16]", "INPUT.CROP_SIZE", "[16, 16]",
            "TPU.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", "0"]
    n = cam.main(["--checkpoint", ckpt, "--out_dir", str(out), "--max_videos", "3",
                  "--device", "cpu", *opts])
    files = sorted(glob.glob(str(out / "cam_*.npz")))
    assert n == 3 and len(files) == 3
    with np.load(files[0]) as z:
        assert z["cam"].shape == (4, 16, 16) and z["frames"].shape == (4, 16, 16, 3)
        assert z["cam"].min() >= 0.0 and z["cam"].max() <= 1.0 + 1e-6
        assert int(z["class_id"]) == int(z["pred"])
