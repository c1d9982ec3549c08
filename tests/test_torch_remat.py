"""``TPU.REMAT`` on the port's MoCo step (CPU, float64): the recompute
changes where activations live, never the step.

* S3D + graph blocks at 5, 9 and 14 (T 8, 64x64, the smallest input that
  keeps a block at 14, B 2): two steps under ``block`` and ``conv_saved``,
  and under ``block`` with ``TPU.SEPCONV_FUSED``, give the loss, every
  gradient, the parameters, the BN running statistics, the queue and the
  EMA encoder of the same steps without remat, bit for bit.  Every stage
  but the four pools is recomputed once per backward; the graph blocks run
  once per pass, outside the recomputed units.
* ``block`` on ``resnet3d_10``, ``resnet2p1d_10`` (each residual block a
  unit) and I3D (its stages): the same.
* A BN inside a recomputed unit runs twice in the backward's step and takes
  one momentum update.
* The units run plainly in eval mode and under ``torch.no_grad()``.
"""

import pytest
import torch

from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
from video_graph_ssl_tpu_torch.engine.pretrain import make_moco_step
from video_graph_ssl_tpu_torch.models import remat
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug
from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

torch.set_num_threads(1)
LRS = (0.1, 0.05)
# backbone -> (T, H = W, graph points); 64x64 keeps S3D's and I3D's block
# at 14 on a 2x2 map
GEOMETRY = {"S3D": (8, 64, (5, 9, 14)), "I3D": (8, 64, (5, 9, 14)),
            "resnet3d_10": (16, 32, (2, 3, 4)), "resnet2p1d_10": (16, 32, (2, 3, 4))}
# recomputed units per backward: S3D's and I3D's 16 stages less 4 pools,
# the 4 residual blocks of a depth-10 ResNet
UNITS = {"S3D": 12, "I3D": 12, "resnet3d_10": 4, "resnet2p1d_10": 4}


def _cfg(backbone="S3D", policy=None, fused=False):
    t, hw, aug = GEOMETRY[backbone]
    return load_config("", [
        "MODEL.BACKBONE", backbone, "MODEL.BACKBONE_TYPE", "3D", "MODEL.AUG_FLAG", "True",
        "GRAPH.AUG_POINTS", list(aug),
        "TPU.COMPUTE_DTYPE", "float64", "CONTRAST.MEM_TYPE", "moco", "CONTRAST.NCE_K", "16",
        "CROSS.FEAT_DIM", "32", "INPUT.VIDEO_LENGTH", str(t), "INPUT.BASE_SIZE", [hw, hw],
        "TPU.SEPCONV_FUSED", str(fused), "TPU.REMAT", str(policy is not None),
        "TPU.REMAT_POLICY", policy or "block"])


def _clips(backbone):
    t, hw, _ = GEOMETRY[backbone]
    g = torch.Generator().manual_seed(7)
    return torch.randn(2, 2, t, hw, hw, 3, generator=g, dtype=torch.float64)


def _steps(c, clips, monkeypatch):
    """len(LRS) MoCo steps from the seeded state: each step's loss and
    gradients, then the state; with the recompute scopes and the graph
    blocks' forwards counted."""
    counts = {"recompute": 0, "graph": 0}
    scope = remat._recompute_scope

    def counted():
        counts["recompute"] += 1
        return scope()

    monkeypatch.setattr(remat, "_recompute_scope", counted)
    model, _ = create_visual_model(c)
    state = create_pretrain_state(c, model, "cpu")
    for net in (state.model, state.ema_model):
        for m in net.modules():
            if isinstance(m, TemporalGraphAug):
                m.register_forward_hook(lambda *a: counts.__setitem__("graph", counts["graph"] + 1))
    step = make_moco_step(float(c.CONTRAST.NCE_T), float(c.CONTRAST.ALPHA))
    losses, grads = [], []
    for lr in LRS:
        losses.append(step(state, clips, lr)["loss"].clone())
        grads.append({n: p.grad.clone() for n, p in state.model.named_parameters()})
    final = {**{f"model.{k}": v.clone() for k, v in state.model.state_dict().items()},
             **{f"ema.{k}": v.clone() for k, v in state.ema_model.state_dict().items()},
             "queue": state.contrast.queue.clone(), "ptr": torch.tensor(state.contrast.ptr)}
    return losses, grads, final, dict(counts)


def _assert_equal(got, want) -> None:
    (gl, gg, gs, _), (wl, wg, ws, _) = got, want
    for i, (a, b) in enumerate(zip(gl, wl)):
        assert torch.equal(a, b), f"loss {i}: {float(a)} != {float(b)}"
    for i, (a, b) in enumerate(zip(gg, wg)):
        assert a.keys() == b.keys()
        for n in a:
            assert torch.equal(a[n], b[n]), f"step {i} gradient {n}"
    assert gs.keys() == ws.keys()
    for n in gs:
        assert torch.equal(gs[n], ws[n]), n


_OFF = {}


def _off(backbone, fused, monkeypatch):
    key = (backbone, fused)
    if key not in _OFF:
        _OFF[key] = _steps(_cfg(backbone, None, fused), _clips(backbone), monkeypatch)
    return _OFF[key]


CASES = [("S3D", "block", False), ("S3D", "conv_saved", False), ("S3D", "block", True),
         ("resnet3d_10", "block", False), ("resnet2p1d_10", "block", False),
         ("I3D", "block", False)]


@pytest.mark.parametrize("backbone,policy,fused", CASES,
                         ids=[f"{b}-{p}{'-fused' if f else ''}" for b, p, f in CASES])
def test_remat_step_equals_the_step_without_it(backbone, policy, fused, monkeypatch):
    off = _off(backbone, fused, monkeypatch)
    assert off[3]["recompute"] == 0
    got = _steps(_cfg(backbone, policy, fused), _clips(backbone), monkeypatch)
    model, _ = create_visual_model(_cfg(backbone, policy, fused))
    assert model.model.encoder.base_model.remat == (True if policy == "block" else policy)
    # one recompute per unit per backward (the key pass takes none); the
    # graph blocks run once per pass, 2 passes per step
    assert got[3]["recompute"] == UNITS[backbone] * len(LRS)
    assert got[3]["graph"] == off[3]["graph"] == 2 * 3 * len(LRS)
    _assert_equal(got, off)


def test_running_stats_take_one_momentum_update():
    """stem_0's spatial BN in a ``block`` step: the query pass runs it once
    in the forward and once in the backward's recompute, and its running
    statistics are one flax-momentum update of the forward's batch
    statistics."""
    c = _cfg("S3D", "block")
    model, _ = create_visual_model(c)
    model.train()
    bn = model.model.encoder.base_model.base[0].bn_s
    seen = []
    bn.register_forward_hook(lambda m, args, out: seen.append(args[0].detach().clone()))
    mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
    out = model(_clips("S3D")[:, 0])
    assert len(seen) == 1
    out.square().sum().backward()
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    x = seen[0]
    m = bn.momentum
    want_mean = m * mean0 + (1 - m) * x.mean(dim=(0, 2, 3, 4)).float()
    want_var = m * var0 + (1 - m) * x.var(dim=(0, 2, 3, 4), unbiased=False).float()
    torch.testing.assert_close(bn.running_mean, want_mean, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(bn.running_var, want_var, rtol=1e-6, atol=1e-9)
    twice_mean = m * want_mean + (1 - m) * x.mean(dim=(0, 2, 3, 4)).float()
    assert not torch.allclose(bn.running_mean, twice_mean, rtol=1e-6, atol=1e-9)


def test_units_run_plainly_without_a_graph(monkeypatch):
    calls = []
    monkeypatch.setattr(remat, "checkpoint", lambda *a, **k: calls.append(1))
    model, _ = create_visual_model(_cfg("S3D", "conv_saved"))
    x = _clips("S3D")[:, 0]
    with torch.no_grad():
        model.train()(x)
    model.eval()(x)
    assert calls == []
    with pytest.raises(ValueError, match="remat must be one of"):
        remat.check_policy("everything")
