"""SlowFast-R50 8x8 (``MODEL.BACKBONE slowfast_r50``, the port's own
backbone) on the CPU: the pathways' frames, every stage's widths and the
2304-wide feature; the port against the benchmark's plain float32
reference (``portbench/reference/slowfast.py``) in float64 on seeded
weights at 32 frames of 32x32, where every graph block sees T = 32:
features, every parameter's gradient and the BN running statistics; the
options it refuses; ``TPU.REMAT`` block; one MoCo step of the trainer.
``portbench/tests/test_portbench_slowfast.py`` holds the benchmark's side."""

import os

import pytest
import torch

from portbench.reference.models import build_model, make_weights, weight_specs
from video_graph_ssl_tpu_torch import train_video_contrast_dis as train
from video_graph_ssl_tpu_torch.models import build
from video_graph_ssl_tpu_torch.models.slowfast import SlowFast, slow_frames
from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug

torch.set_num_threads(1)
NAME = "slowfast_r50"
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                      "visual_moco.yaml")
BASE = ["MODEL.BACKBONE", NAME, "MODEL.BACKBONE_TYPE", "3D", "MODEL.AUG_FLAG", "True",
        "DATASET.NUM_CLASS", "4", "INPUT.VIDEO_LENGTH", "32", "INPUT.SCALE_SIZE", "[36, 36]",
        "INPUT.BASE_SIZE", "[32, 32]", "CONTRAST.NCE_K", "16", "CROSS.FEAT_DIM", "32",
        "DATALOADER.BATCH_SIZE", "2", "DATASET.SOURCE", "synthetic"]


def _cfg(*extra):
    return train.load_config(CONFIG, BASE + list(extra))


def _base(model):
    return model.model.encoder.base_model


def test_frames_widths_and_feature():
    assert slow_frames(32) == (0, 4, 8, 13, 17, 22, 26, 31)
    ctor, dim, aug = build.BACKBONES_3D[NAME]
    assert (dim, aug) == (2304, (2, 3, 4))
    model, feat_dim = build.create_visual_model(_cfg("TPU.COMPUTE_DTYPE", "float32"))
    base = _base(model)
    assert feat_dim == base.feature_dim == 2304
    stems = (base.slow_conv1, base.fast_conv1)
    assert [(c.out_channels, c.kernel_size, c.stride, c.padding) for c in stems] == [
        (64, (1, 7, 7), (1, 2, 2), (0, 3, 3)), (8, (5, 7, 7), (1, 2, 2), (2, 3, 3))]
    fuses = [getattr(base, f"fuse{i}").conv for i in range(4)]
    assert [(c.in_channels, c.out_channels, c.kernel_size, c.stride, c.padding)
            for c in fuses] == [(c, 2 * c, (7, 1, 1), (4, 1, 1), (3, 0, 0))
                                for c in (8, 32, 64, 128)]
    for path, cins, inner, outs, tks in (
            ("slow", (80, 320, 640, 1280), (64, 128, 256, 512), (256, 512, 1024, 2048),
             (1, 1, 3, 3)),
            ("fast", (8, 32, 64, 128), (8, 16, 32, 64), (32, 64, 128, 256), (3, 3, 3, 3))):
        for stage, n in enumerate((3, 4, 6, 3), start=1):
            layer = getattr(base, f"{path}_layer{stage}")
            graph = path == "fast" and stage in (2, 3, 4)
            assert isinstance(layer[0], TemporalGraphAug) == graph
            blocks = layer[1] if graph else layer
            assert len(blocks) == n
            b0 = blocks[0]
            s = 1 if stage == 1 else 2
            assert b0.conv1.in_channels == cins[stage - 1]
            assert b0.conv1.kernel_size == (tks[stage - 1], 1, 1)
            assert b0.conv1.padding == (tks[stage - 1] // 2, 0, 0)
            assert b0.conv2.out_channels == inner[stage - 1]
            assert b0.conv2.stride == (1, s, s) and b0.conv3.out_channels == outs[stage - 1]
            assert b0.downsample[0].stride == (1, s, s) and b0.non_local is None
    seen = []
    for m in base.modules():
        if isinstance(m, TemporalGraphAug):
            m.register_forward_hook(lambda mod, inp, out: seen.append(tuple(inp[0].shape)))
    x = torch.randn(1, 32, 32, 32, 3)
    with torch.no_grad():
        assert base.eval()(x).shape == (1, 2304)
    assert seen == [(1, 32, 8, 8, 32), (1, 32, 4, 4, 64), (1, 32, 2, 2, 128)]


def _seeded_pair():
    """The port's model and the plain reference in float64 on the benchmark's
    seeded weights (train mode)."""
    prog = build.create_visual_model(_cfg("TPU.COMPUTE_DTYPE", "float64"))[0]
    ref = build_model(NAME, (2, 3, 4), 32).double()
    w0 = make_weights(weight_specs(ref), 5, "cpu")
    with torch.no_grad():
        for m in (prog, ref):
            for n, p in m.named_parameters():
                p.copy_(w0[n])
    return prog.train(), ref.train()


def _close(a, b):
    return torch.allclose(a.double(), b.double(), rtol=1e-5, atol=1e-6)


def _close_to_scale(a, b):
    """Within 1e-5 of ``b``'s largest magnitude, plus 1e-6: rtol 1e-5 taken
    over the tensor.  The program's graph block rounds its similarity and its
    propagation to fp32 even in float64, and train-mode BN carries that
    rounding (about 1e-7) into every gradient at about 2e-6 of its norm, so
    an element near 0 beside large ones is off by more than 1e-5 of itself
    (worst reading 3.1e-6 of the tensor's largest)."""
    return float((a.double() - b.double()).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-6


def test_matches_the_plain_reference_in_float64():
    prog, ref = _seeded_pair()
    x = torch.randn(2, 32, 32, 32, 3, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    fp = _base(prog)(x, graph_seed=11)
    fr = ref.model.encoder(x, 11)
    assert _close(fp, fr)
    dy = torch.randn(fr.shape, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    (fp * dy).sum().backward()
    (fr * dy).sum().backward()
    grads = dict(ref.named_parameters())
    for n, p in prog.named_parameters():
        if n.startswith("model.proj_head"):
            continue
        assert p.grad is not None and _close_to_scale(p.grad, grads[n].grad), n
    bufs = dict(ref.named_buffers())
    for n, b in prog.named_buffers():
        assert _close(b, bufs[n]), n


def test_remat_block_gives_the_same_gradients():
    x = torch.randn(2, 32, 32, 32, 3, generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    grads = []
    for extra in ([], ["TPU.REMAT", "True", "TPU.REMAT_POLICY", "block"]):
        model = build.create_visual_model(_cfg("TPU.COMPUTE_DTYPE", "float64", *extra))[0]
        _base(model).train()(x, graph_seed=5).square().sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        assert torch.allclose(grads[0][n], grads[1][n], rtol=1e-10, atol=1e-12), n


@pytest.mark.parametrize("extra, option", [
    (["TPU.STEM_S2D", "full"], "TPU.STEM_S2D"),
    (["TPU.SEPCONV_FUSED", "True"], "TPU.SEPCONV_FUSED"),
    (["TPU.REMAT", "True", "TPU.REMAT_POLICY", "conv_saved"], "TPU.REMAT_POLICY"),
])
def test_options_it_does_not_take_raise(extra, option):
    with pytest.raises(ValueError, match=option):
        build.create_visual_model(_cfg(*extra))


def test_partial_bn_raises():
    with pytest.raises(ValueError, match="partial_bn"):
        build.create_video_model(_cfg("MODEL.NO_PARTIALBN", "False"))
    model, dim = build.create_video_model(_cfg("MODEL.NO_PARTIALBN", "True"))
    assert dim == 2304


def test_one_moco_step_of_the_trainer(tmp_path):
    c = _cfg("TPU.COMPUTE_DTYPE", "float32")
    trainer = train.Trainer(c, max_steps=1, device="cpu", run_dir=str(tmp_path / "run"))
    assert isinstance(_base(trainer.state.model), SlowFast)
    raw = torch.randint(0, 256, (2, 2, 32, 36, 36, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(6))
    before = {n: p.detach().clone() for n, p in trainer.state.model.named_parameters()}
    metrics = trainer.train_step(raw, trainer.lr_fn(trainer.start_epoch))
    assert torch.isfinite(torch.as_tensor(metrics["loss"])).all()
    moved = [n for n, p in trainer.state.model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    assert any(".fast_layer2.0." in n for n in moved)      # the graph block trains
    assert any(".fuse3." in n for n in moved) and any(".slow_conv1." in n for n in moved)
    assert trainer.state.contrast.queue.shape == (16, 32)
    trainer.writer.close()
