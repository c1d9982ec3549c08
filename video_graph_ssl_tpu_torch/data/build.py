"""Data loader factories (a copy of ``video_graph_ssl_tpu/data/build.py``).

Counterpart of lib/data/build.py: ``make_data_loader`` (:7-33, downstream
train/val — fixing the reference's nonexistent ``cfg.DATASET.ROOT_DIR``
latent bug by using VISUAL_ROOT_DIR) and ``build_video_contrastive_loader``
(:35-54).  Batch sizes are GLOBAL, as in the JAX package.

``batch_slice`` (``parallel.dist.process_batch_slice``) gives a rank its
rows of every global batch of the pretrain loader and of the downstream
train loader; the validation and test loaders keep full host batches, which
the eval tools share out over the ranks (``parallel.dist.eval_over_ranks``).

``cfg.DATASET.SOURCE = 'synthetic'`` swaps in the deterministic synthetic
sources so every entry point runs without a frames-on-disk dataset.
"""

from __future__ import annotations

from typing import Tuple

from .datasets import ContrastiveDataset, FrameDataset
from .pipeline import Loader
from .synthetic import SyntheticContrastiveDataset, SyntheticFrameDataset


def _canvas_hw(cfg) -> Tuple[int, int]:
    return (int(cfg.INPUT.SCALE_SIZE[0]), int(cfg.INPUT.SCALE_SIZE[1]))


def _img_tmpl(cfg) -> str:
    """Flow uses the two-placeholder template (reference dataset.py:58-66)."""
    return (cfg.INPUT.FLOW_TMP if cfg.INPUT.MODALITY == "Flow"
            else cfg.INPUT.IMG_TMP)


def resolve_new_length(cfg) -> int:
    """INPUT.NEW_LENGTH, or the reference's by-modality default when -1:
    1 for RGB, 5 otherwise (model_wrappers.py:41-45).  This is the
    *pre*-RGBDiff value — datasets add the +1 themselves."""
    nl = int(cfg.INPUT.NEW_LENGTH)
    if nl <= 0:
        nl = 1 if cfg.INPUT.MODALITY == "RGB" else 5
    return nl


def build_video_contrastive_loader(cfg, batch_slice=None) -> Tuple[Loader, int]:
    """SSL pretrain loader; returns (loader, n_data)
    (reference: lib/data/build.py:35-54).  ``batch_slice``: this rank's
    rows of each global batch -- the DistributedSampler role."""
    if cfg.DATASET.SOURCE == "synthetic":
        ds = SyntheticContrastiveDataset(
            n_data=int(cfg.DATASET.NUM_CLASS) * 4,
            video_length=int(cfg.INPUT.VIDEO_LENGTH),
            canvas_hw=_canvas_hw(cfg),
            num_classes=int(cfg.DATASET.NUM_CLASS),
            seed=int(cfg.MODEL.SEED),
        )
    else:
        ds = ContrastiveDataset(
            root_path=cfg.DATASET.VISUAL_ROOT_DIR,
            list_file=cfg.DATASET.TRAIN_SPLIT,
            video_length=int(cfg.INPUT.VIDEO_LENGTH),
            frame_interval=int(cfg.INPUT.SAMPLE_RATE),
            sample_type=cfg.INPUT.SAMPLE_TYPE,
            modality=cfg.INPUT.MODALITY,
            image_tmpl=_img_tmpl(cfg),
            pre_load=cfg.INPUT.PRE_LOAD,
            canvas_hw=_canvas_hw(cfg),
            temporal_jitter=bool(cfg.INPUT.TEMPORAL_JITTER),
            new_length=resolve_new_length(cfg),
        )
    loader = Loader(
        ds,
        batch_size=int(cfg.DATALOADER.BATCH_SIZE),
        shuffle=True,
        drop_last=True,
        num_workers=int(cfg.DATALOADER.NUM_WORKERS),
        seed=int(cfg.MODEL.SEED),
        prefetch=int(cfg.TPU.PREFETCH),
        batch_slice=batch_slice,
    )
    return loader, len(ds)


def make_data_loader(cfg, is_train: bool = True, batch_slice=None) -> Loader:
    """Downstream train/val loader (reference: lib/data/build.py:7-33).
    ``batch_slice``: this rank's rows of each global train batch (the
    validation loader, which keeps its ragged tail, takes none)."""
    if cfg.DATASET.SOURCE == "synthetic":
        ds = SyntheticFrameDataset(
            n_data=int(cfg.DATASET.NUM_CLASS) * 4,
            video_length=int(cfg.INPUT.VIDEO_LENGTH),
            canvas_hw=_canvas_hw(cfg),
            num_classes=int(cfg.DATASET.NUM_CLASS),
            seed=int(cfg.MODEL.SEED),
        )
    else:
        ds = FrameDataset(
            root_path=cfg.DATASET.VISUAL_ROOT_DIR,
            list_file=(cfg.DATASET.TRAIN_SPLIT if is_train
                       else cfg.DATASET.VALIDATION_SPLIT),
            video_length=int(cfg.INPUT.VIDEO_LENGTH),
            sample_type=cfg.INPUT.SAMPLE_TYPE,
            sample_rate=int(cfg.INPUT.SAMPLE_RATE),
            modality=cfg.INPUT.MODALITY,
            image_tmpl=_img_tmpl(cfg),
            pre_load=cfg.INPUT.PRE_LOAD,
            canvas_hw=_canvas_hw(cfg),
            random_shift=is_train,
            test_mode=False,
            new_length=resolve_new_length(cfg),
        )
    return Loader(
        ds,
        batch_size=int(cfg.DATALOADER.BATCH_SIZE if is_train
                       else cfg.TEST.BATCH_SIZE),
        shuffle=is_train,
        drop_last=is_train,
        num_workers=int(cfg.DATALOADER.NUM_WORKERS),
        seed=int(cfg.MODEL.SEED),
        prefetch=int(cfg.TPU.PREFETCH),
        batch_slice=batch_slice,
    )


def make_test_loader(cfg, num_clips: int = 10) -> Loader:
    """Video-level multi-clip test loader (reference: tools/test_ds.py:95-131)."""
    if cfg.DATASET.SOURCE == "synthetic":
        ds = SyntheticFrameDataset(
            n_data=int(cfg.DATASET.NUM_CLASS) * 2,
            video_length=int(cfg.INPUT.VIDEO_LENGTH),
            canvas_hw=_canvas_hw(cfg),
            num_classes=int(cfg.DATASET.NUM_CLASS),
            test_mode=True,
            num_clips=num_clips,
            seed=int(cfg.MODEL.SEED),
        )
    else:
        ds = FrameDataset(
            root_path=cfg.DATASET.VISUAL_ROOT_DIR,
            list_file=cfg.DATASET.VALIDATION_SPLIT,
            video_length=int(cfg.INPUT.VIDEO_LENGTH),
            sample_type=cfg.INPUT.SAMPLE_TYPE,
            sample_rate=int(cfg.INPUT.SAMPLE_RATE),
            modality=cfg.INPUT.MODALITY,
            image_tmpl=_img_tmpl(cfg),
            pre_load=cfg.INPUT.PRE_LOAD,
            canvas_hw=_canvas_hw(cfg),
            test_mode=True,
            num_clips=num_clips,
            new_length=resolve_new_length(cfg),
        )
    return Loader(
        ds,
        batch_size=int(cfg.TEST.BATCH_SIZE),
        shuffle=False,
        drop_last=False,
        num_workers=int(cfg.DATALOADER.NUM_WORKERS),
        seed=int(cfg.MODEL.SEED),
        prefetch=int(cfg.TPU.PREFETCH),
    )
