"""Ranks for the PyTorch port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_ddp_step.py).

:func:`run_ranks` starts ``world`` processes (``spawn``), each joining a gloo
group at a ``file://`` rendezvous in the test's directory, runs one of the
worker functions below as that rank, and returns each rank's result.  A
rank that fails writes its traceback beside the results; every process has
a timeout.  This module imports torch and the port only (no JAX), so the
ranks start quickly.
"""

import os
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

TIMEOUT_S = 240
# the bank's rows in the regime tests (the JAX states are built with it too)
N_DATA = 32


def run_ranks(fn, world: int, directory, *args, timeout: float = TIMEOUT_S):
    """[fn(rank, world, *args) for each rank], each in its own process."""
    directory = str(directory)
    init = "file://" + os.path.join(directory, f"rendezvous_{fn.__name__}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, init, directory, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errors = []
    for r in range(world):
        path = os.path.join(directory, f"{fn.__name__}_error_{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    assert not alive, f"{len(alive)} ranks still running after {timeout} s\n" + "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), (
        f"exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [torch.load(os.path.join(directory, f"{fn.__name__}_out_{r}.pt"),
                       weights_only=False) for r in range(world)]


def _entry(fn, rank, world, init, directory, args):
    torch.set_num_threads(1)
    try:
        tdist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                                 timeout=timedelta(seconds=TIMEOUT_S))
        try:
            out = fn(rank, world, *args)
        finally:
            tdist.destroy_process_group()
        torch.save(out, os.path.join(directory, f"{fn.__name__}_out_{rank}.pt"))
    except BaseException:
        with open(os.path.join(directory, f"{fn.__name__}_error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def rows(rank, world, n):
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def port_cfg(opts=()):
    """The tiny3d configuration of tests/conftest.py:tiny_cfg in the port's
    schema (MoCo, fp32), plus ``opts``."""
    from video_graph_ssl_tpu_torch.config import cfg

    c = cfg.clone()
    c.merge_from_list([
        "MODEL.BACKBONE", "tiny3d", "MODEL.BACKBONE_TYPE", "3D", "MODEL.AUG_FLAG", True,
        "MODEL.DROPOUT", 0.0, "INPUT.BASE_SIZE", [16, 16], "INPUT.CROP_SIZE", [16, 16],
        "INPUT.SCALE_SIZE", [20, 20], "INPUT.VIDEO_LENGTH", 4, "DATASET.NUM_CLASS", 8,
        "DATASET.SOURCE", "synthetic", "DATALOADER.BATCH_SIZE", 4, "TEST.BATCH_SIZE", 4,
        "DATALOADER.NUM_WORKERS", 2, "CONTRAST.NCE_K", 16, "CROSS.FEAT_DIM", 32,
        "TPU.COMPUTE_DTYPE", "float32", "CONTRAST.MEM_TYPE", "moco", *opts])
    return c


def state_arrays(state) -> dict:
    """The pretrain state as numpy arrays: params and buffers, the EMA (MoCo),
    the queue and pointer (MoCo) or the bank's memory (CMC: both queues and
    the pointer, or both memories), the step."""
    out = {f"model.{k}": v.detach().cpu().numpy().copy()
           for k, v in state.model.state_dict().items()}
    if state.ema_model is not None:
        out.update({f"ema.{k}": v.detach().cpu().numpy().copy()
                    for k, v in state.ema_model.state_dict().items()})
    if state.contrast is not None:
        from video_graph_ssl_tpu_torch.memory.build import contrast_fields

        for name, v in contrast_fields(state.contrast).items():
            out[name] = (v.cpu().numpy().copy() if isinstance(v, torch.Tensor)
                         else np.asarray(v))
    out["step"] = np.asarray(state.step)
    return out


# --------------------------------------------------------------------------- #
# workers: fn(rank, world, *args) -> a picklable result
# --------------------------------------------------------------------------- #
def bn_worker(rank, world, x, g, channel_dim, weight, bias):
    """One rank's train-mode BN forward and backward on its rows of ``x``
    (float64), cotangent ``g``."""
    from video_graph_ssl_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(x.shape[channel_dim], momentum=0.9, eps=1e-3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    r = rows(rank, world, x.shape[0])
    xr = torch.from_numpy(x[r]).requires_grad_()
    y = bn(xr, channel_dim=channel_dim)
    (y * torch.from_numpy(g[r])).sum().backward()
    return {"y": y.detach().numpy(), "dx": xr.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def _model(opts, state_dict):
    from video_graph_ssl_tpu_torch.models.build import create_visual_model

    model, _ = create_visual_model(port_cfg(opts))
    if state_dict is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    return model


def shuffle_worker(rank, world, opts, state_dict, x, perm, seed):
    """ShuffleBN's key pass on this rank's rows of ``x`` with ``perm``."""
    from video_graph_ssl_tpu_torch.parallel.shuffle_bn import shuffle_bn_keys

    model = _model(opts, state_dict).train()
    r = rows(rank, world, x.shape[0])
    keys = shuffle_bn_keys(model, torch.from_numpy(x[r]), seed, torch.from_numpy(perm))
    return {"keys": keys.numpy(), "state": {k: v.numpy().copy()
                                            for k, v in model.state_dict().items()}}


def step_worker(rank, world, opts, state_dict, queue, clips, lrs, fused, perm=None,
                bn_mode=None):
    """``len(lrs)`` pretrain steps of this rank on its rows of ``clips``:
    ``make_fused_pretrain_step`` on raw uint8 clips when ``fused``, else
    ``make_moco_step`` on pre-augmented ones (ShuffleBN with ``perm`` when
    given); ``bn_mode`` (a ``sync_bn`` mode) is entered on the query and EMA
    models for the steps.  Returns the metrics of each step, the state
    after the first step (``after_1``) and the final state."""
    import contextlib

    from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
    from video_graph_ssl_tpu_torch.engine.pretrain import (make_fused_pretrain_step,
                                                           make_moco_step)

    c = port_cfg(opts)
    state = create_pretrain_state(c, _model(opts, state_dict), "cpu")
    if queue is not None:
        state.contrast.queue.copy_(torch.from_numpy(queue))
    if fused:
        step = make_fused_pretrain_step(c)
    else:
        step = make_moco_step(float(c.CONTRAST.NCE_T), float(c.CONTRAST.ALPHA),
                              shuffle_bn=perm is not None,
                              permutation=lambda s, n: torch.from_numpy(perm))
    local = torch.from_numpy(clips[rows(rank, world, clips.shape[0])])
    metrics, after_1 = [], None
    with contextlib.ExitStack() as modes:
        if bn_mode is not None:
            for m in (state.model, state.ema_model):
                modes.enter_context(bn_mode(m))
        for lr in lrs:
            metrics.append({k: float(v) for k, v in step(state, local, lr).items()})
            after_1 = after_1 or state_arrays(state)
    return {"metrics": metrics, "state": state_arrays(state), "after_1": after_1}


def regime_worker(rank, world, opts, state_dict, memory, clips, index, lrs, draws=None,
                  fused=False):
    """``len(lrs)`` steps of the regime of ``opts`` (``CONTRAST.MEM_TYPE``
    simsiam or bank) on this rank's rows of ``clips`` and ``index``:
    ``make_pretrain_step`` on pre-augmented clips, or
    ``make_fused_pretrain_step`` on raw uint8 ones when ``fused``.  The bank
    starts from ``memory`` where given and takes its rows of the global
    negative draw ``draws[step]`` where given.  Returns each step's metrics
    and the final state."""
    from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
    from video_graph_ssl_tpu_torch.engine.pretrain import (make_bank_step,
                                                           make_fused_pretrain_step,
                                                           make_pretrain_step)
    from video_graph_ssl_tpu_torch.solver.build import grad_clip_norm

    c = port_cfg(opts)
    state = create_pretrain_state(c, _model(opts, state_dict), "cpu", n_data=N_DATA)
    if memory is not None:
        state.contrast.memory.copy_(torch.from_numpy(memory))
    if fused:
        step = make_fused_pretrain_step(c)
    elif draws is not None:
        def draw(st, device, n, b, K, rows):
            return torch.from_numpy(draws[st.step])[rows[0]:rows[0] + b]

        step = make_bank_step(int(c.CONTRAST.NCE_K), float(c.CONTRAST.NCE_T),
                              float(c.CONTRAST.NCE_M), c.CROSS.CRITERION,
                              grad_clip_norm(c), draw=draw)
    else:
        step = make_pretrain_step(c)
    r = rows(rank, world, clips.shape[0])
    local, idx = torch.from_numpy(clips[r]), torch.from_numpy(index[r])
    metrics = [{k: float(v) for k, v in step(state, local, lr, idx).items()} for lr in lrs]
    return {"metrics": metrics, "state": state_arrays(state)}


def cmc_worker(rank, world, opts, clips, index, lrs):
    """``len(lrs)`` fused CMC steps (``CROSS.MODALITY cross`` with ``opts``)
    of this rank on its rows of the raw uint8 ``clips`` and ``index``, from
    the seeded initial state; the bank's negatives drawn by the step
    (``engine.pretrain.bank_draw``) and recorded.  Returns each step's
    metrics, the final state and the draws."""
    from video_graph_ssl_tpu_torch.engine import pretrain
    from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
    from video_graph_ssl_tpu_torch.models.build import create_visual_model

    c = port_cfg(["CROSS.MODALITY", "cross", *opts])
    state = create_pretrain_state(c, create_visual_model(c)[0], "cpu", n_data=N_DATA)
    draws, bank_draw = [], pretrain.bank_draw

    def recorded(*a):
        draws.append(bank_draw(*a).numpy().copy())
        return torch.from_numpy(draws[-1])

    pretrain.bank_draw = recorded
    try:
        step = pretrain.make_fused_pretrain_step(c)
    finally:
        pretrain.bank_draw = bank_draw
    r = rows(rank, world, clips.shape[0])
    local, idx = torch.from_numpy(clips[r]), torch.from_numpy(index[r])
    metrics = [{k: float(v) for k, v in step(state, local, lr, idx).items()} for lr in lrs]
    return {"metrics": metrics, "state": state_arrays(state), "draws": draws}


def fused_guard_worker(rank, world):
    """TPU.SEPCONV_FUSED at this world size: the step builder's and the
    fused SepConv's errors (None where nothing raised), and the pair's
    output, input gradient and running mean after one train-mode step on
    this rank's rows of a global batch of 2 * world clips."""
    from video_graph_ssl_tpu_torch.engine.pretrain import make_fused_pretrain_step
    from video_graph_ssl_tpu_torch.models.layers import SepConv3d

    out = {}
    try:
        make_fused_pretrain_step(port_cfg(["TPU.SEPCONV_FUSED", True]))
        out["builder"] = None
    except NotImplementedError as e:
        out["builder"] = str(e)
    torch.manual_seed(0)
    layer = SepConv3d(8, 8, 3, 1, 1, dtype=torch.float32, fused_bwd=True).train()
    x = torch.randn(2 * world, 8, 4, 6, 6)[rows(rank, world, 2 * world)].requires_grad_()
    try:
        y = layer(x)
        y.square().sum().backward()
        out["layer"] = None
        out["y"], out["dx"] = y.detach().numpy(), x.grad.numpy()
    except NotImplementedError as e:
        out["layer"] = str(e)
    out["running_mean"] = layer.bn_s.running_mean.numpy().copy()
    return out


def _pair_layer(args):
    """SepConv3d(C, F, 3, 1, 1) with TPU.SEPCONV_FUSED, fp32, holding the
    JAX-layout numpy weights ``args[1:]`` (ws, wt, g1, b1, g2, b2)."""
    from video_graph_ssl_tpu_torch.models.layers import SepConv3d

    _, ws, wt, g1, b1, g2, b2 = args
    layer = SepConv3d(ws.shape[-2], ws.shape[-1], 3, 1, 1, dtype=torch.float32,
                      fused_bwd=True).train()
    with torch.no_grad():
        for conv, k in ((layer.conv_s, ws), (layer.conv_t, wt)):
            conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
                np.transpose(k, (4, 3, 0, 1, 2)))))
        for bn, g, b in ((layer.bn_s, g1, b1), (layer.bn_t, g2, b2)):
            bn.weight.copy_(torch.from_numpy(g))
            bn.bias.copy_(torch.from_numpy(b))
    return layer


def fused_pair_run(layer, x, gout, bn_mode=None):
    """One train-mode pass of the fused pair ``layer`` on JAX-layout clips
    ``x`` (b, T, H, W, C) and, when ``gout`` is given, its backward: the
    output, running statistics and gradients as JAX-layout numpy
    arrays.  ``bn_mode``: a ``sync_bn`` mode entered for the pass (without
    ``gout``, under ``no_grad``, as ShuffleBN's key pass)."""
    import contextlib

    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 4, 1, 2, 3))))
    xt.requires_grad_(gout is not None)
    with bn_mode(layer) if bn_mode else contextlib.nullcontext(), \
            torch.set_grad_enabled(gout is not None):
        y = layer(xt)
    out = {"y": np.transpose(y.detach().numpy(), (0, 2, 3, 4, 1)),
           "stats": [b.numpy().copy() for bn in (layer.bn_s, layer.bn_t)
                     for b in (bn.running_mean, bn.running_var)]}
    if gout is not None:
        (y * torch.from_numpy(np.ascontiguousarray(np.transpose(gout, (0, 4, 1, 2, 3))))
         ).sum().backward()
        out["dx"] = np.transpose(xt.grad.numpy(), (0, 2, 3, 4, 1))
        out["dws"] = np.transpose(layer.conv_s.weight.grad.numpy(), (2, 3, 4, 1, 0))
        out["dwt"] = np.transpose(layer.conv_t.weight.grad.numpy(), (2, 3, 4, 1, 0))
        out["dbn"] = [p.grad.numpy().copy() for bn in (layer.bn_s, layer.bn_t)
                      for p in (bn.weight, bn.bias)]
    return out


def fused_pair_worker(rank, world, args, gout, per_rank=False):
    """The fused pair of ``args`` (JAX-layout numpy: x, ws, wt, g1, b1, g2,
    b2) on this rank's rows of x and of the cotangent ``gout``;
    ``per_rank``: a no-grad pass under ``sync_bn.per_rank_bn`` instead."""
    from video_graph_ssl_tpu_torch.parallel import sync_bn

    r = rows(rank, world, args[0].shape[0])
    if per_rank:
        return fused_pair_run(_pair_layer(args), args[0][r], None, sync_bn.per_rank_bn)
    return fused_pair_run(_pair_layer(args), args[0][r], gout[r])


def several_worker(rank, world, calls):
    """[fn(rank, world, *args) for fn, args in calls]: several workers' runs
    in one spawn of the ranks."""
    return [fn(rank, world, *args) for fn, args in calls]


def ds_step_worker(rank, world, opts, state_dict, clips, labels, lrs, fused, bn_mode=None):
    """``len(lrs)`` downstream train steps of this rank on its rows of
    ``clips`` and ``labels``: ``make_fused_downstream_step`` on raw uint8
    clips when ``fused`` (then also this rank's augmented clips of the first
    step), else ``make_downstream_train_step`` on pre-augmented ones.  The
    ``VideoModel`` of ``port_cfg(opts)`` starts from ``state_dict`` where
    given, else from ``MODEL.SEED``; ``bn_mode`` (a ``sync_bn`` mode) is
    entered on it for the steps.  Returns each step's metrics, the final
    state and whether the state is in ``DistributedDataParallel``."""
    import contextlib

    from video_graph_ssl_tpu_torch.data.transforms_device import make_batch_augment_fn
    from video_graph_ssl_tpu_torch.engine.build import create_downstream_state
    from video_graph_ssl_tpu_torch.engine.downstream import (TRAIN_AUGMENT_STREAM,
                                                             make_downstream_train_step,
                                                             make_fused_downstream_step)
    from video_graph_ssl_tpu_torch.models.build import create_video_model
    from video_graph_ssl_tpu_torch.train_ds import bn_train_of

    c = port_cfg(opts)
    model, _ = create_video_model(c)
    if state_dict is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    state = create_downstream_state(c, model, "cpu")
    bn_train = bn_train_of(c)
    r = rows(rank, world, clips.shape[0])
    local, y = torch.from_numpy(clips[r]), torch.from_numpy(labels[r])
    augmented = None
    if fused:
        step = make_fused_downstream_step(c, bn_train)
        gen = torch.Generator().manual_seed(state.step_seed(TRAIN_AUGMENT_STREAM))
        augmented = make_batch_augment_fn(c, "train")(gen, local,
                                                     (r.start, clips.shape[0])).numpy()
    else:
        step = make_downstream_train_step(bn_train)
    with bn_mode(state.model) if bn_mode else contextlib.nullcontext():
        metrics = [{k: float(v) for k, v in step(state, local, y, lr).items()} for lr in lrs]
    return {"metrics": metrics, "state": state_arrays(state), "augmented": augmented,
            "ddp": state.ddp is not None}


def ds_validation_worker(rank, world, opts, run_dir):
    """``train_ds``'s Trainer on ``port_cfg(opts)`` as this rank: the
    validation logits and labels (``val_logits``), then a validation whose
    top-1 writes ``model_best_state`` (rank 0 only)."""
    import glob

    from video_graph_ssl_tpu_torch.train_ds import Trainer

    trainer = Trainer(port_cfg(opts), device="cpu", run_dir=run_dir)
    logits, labels = trainer.val_logits(0)
    trainer.best_pred = -1.0
    top1 = trainer.validation(0)
    trainer.writer.close()
    return {"logits": logits, "labels": labels, "top1": top1,
            "experiment_dir": trainer.saver.experiment_dir,
            "written": sorted(glob.glob(os.path.join(run_dir, "**", "*.pth.tar"),
                                        recursive=True))}


def seq_worker(rank, world, module_kw, state_dict, runs):
    """The graph block's frame-axis ring (``parallel/sequence.py``) as this
    rank: for each run ``{"x", "kw", ["gout"], ["noise"], ["float64"]}`` on
    the global clip ``x``, this rank's frames of the output, the bytes it
    sent and, with a cotangent ``gout``, the gradient of its frames of
    ``x`` and the weight gradients summed over the ranks; ``noise`` (B, T,
    T) is a draw whose rows of this rank are injected; ``float64`` runs the
    block in float64.  A ValueError is returned as ``{"error": message}``."""
    from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug
    from video_graph_ssl_tpu_torch.parallel import sequence

    results = []
    for run in runs:
        dtype = torch.float64 if run.get("float64") else module_kw["dtype"]
        module = TemporalGraphAug(**{**module_kw, "dtype": dtype}).to(dtype)
        module.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
        x = torch.from_numpy(run["x"]).requires_grad_("gout" in run)
        tl = x.shape[1] // world
        frames = slice(rank * tl, (rank + 1) * tl)
        kw = dict(run.get("kw", {}))
        if "noise" in run:
            kw["noise"] = torch.from_numpy(run["noise"][:, frames])
        sequence.sent_bytes = 0
        try:
            y = sequence.graph_aug_sequence_parallel(module, x, **kw)
        except ValueError as e:
            results.append({"error": str(e)})
            continue
        res = {"y": y.detach().numpy()}
        if "gout" in run:
            (y * torch.from_numpy(run["gout"][:, frames])).sum().backward()
            res["dx"] = x.grad[:, frames].numpy()
            grads = {}
            for name, p in module.named_parameters():
                g = p.grad.clone()
                tdist.all_reduce(g)
                grads[name] = g.numpy()
            res["grads"] = grads
        res["sent"] = sequence.sent_bytes
        results.append(res)
    return results


def dcp_worker(rank, world, directory, clips, load_only=False):
    """The sharded checkpoint backend as this rank: one fused MoCo step on
    its rows of ``clips``, then every rank writes ``directory`` together
    (``save_checkpoint_orbax``); or, with ``load_only``, a fresh state of
    another seed loaded from it.  Returns the state's arrays."""
    from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
    from video_graph_ssl_tpu_torch.engine.pretrain import make_fused_pretrain_step
    from video_graph_ssl_tpu_torch.utils.checkpoint import (load_checkpoint_any,
                                                            save_checkpoint_orbax)

    c = port_cfg()
    state = create_pretrain_state(c, _model((), None) if not load_only else
                                  _seeded_model(c, 99), "cpu")
    if load_only:
        meta = load_checkpoint_any(directory, state)
        return {"state": state_arrays(state), "meta": meta}
    make_fused_pretrain_step(c)(state, torch.from_numpy(clips[rows(rank, world,
                                                                   clips.shape[0])]), 0.1)
    save_checkpoint_orbax(directory, state, epoch=2, best_pred=0.5)
    return {"state": state_arrays(state)}


def async_save_worker(rank, world, config_file, opts, run_dir):
    """The pretrain ``Trainer`` as this rank, run to its end under the
    config ``opts`` (the tests' give ``TPU.CKPT_BACKEND orbax`` with
    ``TPU.ASYNC_CKPT``: a directory saved after each epoch, the first still
    in flight while the next epoch's steps run their collectives).
    Returns the final state's arrays, the experiment directory and the
    number of saves still in flight after the run."""
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config
    from video_graph_ssl_tpu_torch.utils import checkpoint

    trainer = Trainer(load_config(config_file, opts), device="cpu", run_dir=run_dir)
    trainer.run()
    return {"state": state_arrays(trainer.state), "in_flight": len(checkpoint._ASYNC_SAVES),
            "experiment_dir": trainer.saver.experiment_dir, "step": trainer.state.step}


def _seeded_model(c, seed):
    from video_graph_ssl_tpu_torch.models.build import create_visual_model

    return create_visual_model(c, seed=seed)[0]
