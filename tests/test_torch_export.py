"""The port's model export (``video_graph_ssl_tpu_torch/export_model.py``) and
K1's and K2's registered operators, on the CPU.

* ``torch.library.opcheck`` on ``vgs_torch::graph_adjacency`` (unsampled,
  with given noise, with a rank's rows), ``vgs_torch::gcn_propagate``
  (both directions) and ``vgs_torch::max_pool3d_fwd`` (symmetric pads,
  "SAME" pads through ``ceil_mode`` and through the -inf copy): schema,
  fake tensors, dispatch.
* A module that calls both operators exports, saves and loads in a fresh
  process that imports torch and the port's ops alone; the graph keeps
  both operators.
* The encoder export round trip (tiny3d, graph block at 1) at a fixed batch
  and with ``--poly``: the manifest's keys, the live check, a fresh
  process loading the artifact (at batch 3 under ``--poly``), and its
  features against the JAX tool's ``build_infer_fn`` on the same weights
  (1e-5, rel-L2); ``--what classifier`` from a downstream checkpoint.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import rel_l2
from video_graph_ssl_tpu.engine import create_pretrain_state as jax_pt_state
from video_graph_ssl_tpu.models import create_visual_model as jax_visual_model
from video_graph_ssl_tpu.utils import save_checkpoint_state as jax_save
from video_graph_ssl_tpu_torch import export_model
from video_graph_ssl_tpu_torch.engine.build import create_downstream_state, create_pretrain_state
from video_graph_ssl_tpu_torch.models.build import create_video_model, create_visual_model
from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
from video_graph_ssl_tpu_torch.ops import maxpool as mp
from video_graph_ssl_tpu_torch.utils.checkpoint import save_checkpoint_state
from video_graph_ssl_tpu_torch.utils.jax_weights import load_pretrain_weights

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST_KEYS = {"what", "input", "output", "device", "backbone", "checkpoint",
                 "torch_version", "bytes"}
TINY = ["MODEL.BACKBONE", "tiny3d", "MODEL.BACKBONE_TYPE", "3D", "MODEL.AUG_FLAG", "True",
        "INPUT.VIDEO_LENGTH", "4", "INPUT.SCALE_SIZE", "[20, 20]", "INPUT.BASE_SIZE", "[16, 16]",
        "INPUT.CROP_SIZE", "[16, 16]", "TPU.COMPUTE_DTYPE", "float32", "CONTRAST.MEM_TYPE",
        "moco", "CONTRAST.NCE_K", "16", "CROSS.FEAT_DIM", "32", "DATASET.NUM_CLASS", "8",
        "MODEL.DROPOUT", "0.0"]

# a fresh interpreter: torch and the port's operators, then the artifact
LOAD = """
import sys, numpy as np, torch
import video_graph_ssl_tpu_torch.ops
fn = torch.export.load(sys.argv[1]).module()
raw = torch.from_numpy(np.load(sys.argv[2]))
np.save(sys.argv[3], fn(*([raw] if raw.dtype == torch.uint8 else [raw, raw])).detach().numpy())
"""


def _fresh(path, x, tmp_path) -> np.ndarray:
    np.save(tmp_path / "in.npy", x)
    out = tmp_path / "out.npy"
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", LOAD, str(path), str(tmp_path / "in.npy"), str(out)],
                   check=True, env=env, timeout=240)
    return np.load(out)


def _qk(seed=0, b=3, t=5, d=12):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, t, d, generator=g), torch.randn(b, t, d, generator=g)


OP_CASES = [(False, None, False), (True, "given", False), (True, None, True)]


@pytest.mark.parametrize("sample,noise,rows", OP_CASES, ids=["plain", "given_u", "rows"])
def test_opcheck_graph_adjacency(sample, noise, rows):
    q, k = _qk()
    theta = torch.rand(5, 5, generator=torch.Generator().manual_seed(1))
    u = (torch.rand(3, 5, 5, generator=torch.Generator().manual_seed(2)) * 0.9 + 0.05
         if noise else None)
    clip0, clips = (3, 8) if rows else (0, 0)
    args = (q, k, theta, u, gk._signed64(2 ** 63 + 5), 0.7, sample, 0, clip0, clips)
    torch.library.opcheck(torch.ops.vgs_torch.graph_adjacency.default, args)
    got = gk.adjacency_fwd_op(q, k, theta, u, 2 ** 63 + 5, 0.7, sample, 0,
                              (clip0, clips) if rows else None)
    want = gk._adjacency_fwd_plain(q, k, theta, u, 2 ** 63 + 5, 0.7, sample, 0,
                                   (clip0, clips) if rows else None)
    assert got.shape == (3, 3, 5, 5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("transpose", [False, True])
def test_opcheck_gcn_propagate(transpose):
    g = torch.Generator().manual_seed(0)
    adj, x = torch.rand(2, 4, 4, generator=g), torch.randn(2, 4, 3, 3, 6, generator=g)
    torch.library.opcheck(torch.ops.vgs_torch.gcn_propagate.default, (adj, x, transpose))
    assert torch.equal(gp.propagate_op(adj, x, transpose),
                       gp.propagate_plain(adj, x, transpose))


POOL_CASES = [((3, 3, 3), (1, 1, 1), (1, 1, 1, 1, 1, 1)),    # symmetric: F.max_pool3d
              ((1, 3, 3), (1, 2, 2), (0, 0, 0, 1, 0, 1)),    # SAME, ceil_mode's windows
              ((2, 2, 2), (1, 1, 1), (0, 1, 0, 1, 0, 1))]    # SAME at stride 1: the -inf copy


@pytest.mark.parametrize("k,s,pads", POOL_CASES, ids=["symmetric", "ceil_mode", "copy"])
def test_opcheck_max_pool3d_fwd(k, s, pads):
    x = torch.randn(2, 6, 5, 9, 7, generator=torch.Generator().manual_seed(0))
    torch.library.opcheck(torch.ops.vgs_torch.max_pool3d_fwd.default,
                          (x, list(k), list(s), list(pads)))
    y = mp.max_pool3d_fwd_op(x, k, s, pads)
    assert y.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(y, mp.pool_forward(x, k, s, mp._pairs(pads)))


class _Both(torch.nn.Module):
    def forward(self, q, x):
        theta = torch.ones(q.shape[1], q.shape[1])
        adj = gk.adjacency_fwd_op(q, q, theta, None, 0, 1.0, False, 0)[0]
        return gp.propagate_op(adj, x, False)


def test_the_operators_export_and_load_in_a_fresh_process(tmp_path):
    q, _ = _qk(b=2, t=4, d=6)
    program = torch.export.export(_Both(), (q, q), dynamic_shapes=(
        {0: torch.export.Dim("b")}, {0: torch.export.Dim("b")}))
    targets = {str(n.target) for n in program.graph.nodes}
    assert {"vgs_torch.graph_adjacency.default", "vgs_torch.gcn_propagate.default"} <= targets
    path = tmp_path / "both.pt2"
    torch.export.save(program, path)
    q3, _ = _qk(seed=4, b=3, t=4, d=6)
    got = _fresh(path, q3.numpy(), tmp_path)
    np.testing.assert_array_equal(got, _Both()(q3, q3).numpy())


def _jax_export_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_export_model", os.path.join(REPO, "tools", "export_model.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A JAX pretrain state's .msgpack, the port's checkpoint on its weights,
    3 uint8 canvases and the JAX tool's features of them."""
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    d = tmp_path_factory.mktemp("ckpt")
    c = load_config("", TINY)
    jmodel, _ = jax_visual_model(c)
    state, _ = jax_pt_state(c, jmodel, jnp.zeros((2, 4, 16, 16, 3)), n_data=8)
    jax_path = str(d / "jax.msgpack")
    jax_save(jax_path, state, epoch=1)
    model, _ = create_visual_model(c)
    load_pretrain_weights(model, state.params, state.batch_stats, "tiny3d")
    port_path = str(d / "checkpoint_1.pth.tar")
    save_checkpoint_state(port_path, create_pretrain_state(c, model, "cpu"), epoch=1)
    raw = np.random.default_rng(5).integers(0, 256, (3, 4, 20, 20, 3), dtype=np.uint8)
    jc = c.clone()
    jc.defrost()
    jc.CHECKPOINT.RESUME = jax_path
    fn, variables, feat_dim, name = _jax_export_tool().build_infer_fn(jc, "encoder")
    assert feat_dim == 64 and name == "features"
    return port_path, raw, np.asarray(fn(variables, jnp.asarray(raw)))


@pytest.mark.parametrize("shape", [["--batch", "2"], ["--poly"]], ids=["batch2", "poly"])
def test_encoder_export_matches_jax(checkpoints, shape, tmp_path):
    port_path, raw, want = checkpoints
    out = tmp_path / "export"
    manifest = export_model.main(["--checkpoint", port_path, "--what", "encoder",
                                  "--output", str(out), "--device", "cpu", *shape, *TINY])
    assert manifest["validate_err"] == 0.0
    with open(out / "encoder.manifest.json") as f:
        written = json.load(f)
    assert set(written) == MANIFEST_KEYS and written["device"] == "cpu"
    assert written["input"]["shape"] == ["b" if shape == ["--poly"] else 2, 4, 20, 20, 3]
    assert written["output"] == {"name": "features", "dim": 64, "dtype": "float32"}

    b = 3 if shape == ["--poly"] else 2
    got = _fresh(out / "encoder.pt2", raw[:b], tmp_path)
    assert got.shape == (b, 64)
    assert rel_l2(got, want[:b]) < 1e-5


def test_classifier_export(tmp_path):
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    c = load_config("", TINY)
    model, _ = create_video_model(c)
    ckpt = str(tmp_path / "model_best_state.pth.tar")
    save_checkpoint_state(ckpt, create_downstream_state(c, model, "cpu"), epoch=2)
    manifest = export_model.main(["--checkpoint", ckpt, "--what", "classifier", "--output",
                                  str(tmp_path), "--device", "cpu", *TINY])
    assert manifest["output"] == {"name": "logits", "dim": 8, "dtype": "float32"}
    assert manifest["validate_err"] == 0.0
