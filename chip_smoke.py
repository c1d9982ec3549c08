#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. device and set-up: needs ``torch.cuda.is_available()``; prints the
   card's name and power limit, the torch and CUDA versions; builds the
   kernels from ``video_graph_ssl_tpu_torch/csrc`` with nvcc (sm_90a), one
   nvcc per source, in parallel.
2. K1 (graph adjacency) against its plain PyTorch version at the three S3D
   aug-point shapes of the bs-128 16x112x112 step, fp32 and bf16 inputs:
   unsampled, sampled with given noise, the in-kernel Philox draw, and the
   closed-form backward against autograd of the plain version; the same
   checks (untimed) at the three aug-point shapes of the 16x224x224 bs-32
   step (phase 6c, phase 9 (b)) and of the 16x112x112 bs-32 step (phase
   10), whose splits of D follow the batch; then T = 32 at the first aug point's D, a
   ragged D and a D below one split, two calls bit-equal; a rank's rows
   (``rows=(clip0, B)``, clip0 = r * B / W for W = 2 and 4): the in-kernel
   draw equals the full batch's rows bit for bit; kernel and plain times,
   and in bf16 the kernels' device-only time (``torch.profiler``) and the
   wrapper's host time per call (``video_graph_ssl_tpu_torch/kernel_times.py``).
3. K2 (GCN propagation) likewise, at the three steps' shapes: forward,
   transpose mode (each twice, bit-equal), autograd dx and dadj; T = 32,
   F ragged to 64 and to 8, adj in fp32; then kernel, plain, ``torch.bmm``,
   device-only and host times (112x112 shapes).
4. K3/K4 (max-pool backward) at the shape of every pool of one S3D pass,
   fp32 and bf16: against the plain version (exact), against torch's own
   max_pool3d backward (random cotangent; ones cotangent on inputs that
   tie), then kernel, plain and torch times beside each launch's shared
   memory per block and block count; then every pool geometry at ragged
   shapes (C not a multiple of 8, odd H and W, T = 1) against the plain
   version (exact); then every pool of the 16x224x224 and 16x112x112
   steps at bs 32 against the plain version (exact), each with its plan (strips of dx
   rows where a slab exceeds a block), the strip plans timed.  Then the
   pool forward kernel (``csrc/maxpool_fwd.cu``) against the library's
   pool on the card, bit for bit (NaN where the library has NaN), at every
   pool of S3D's steps (bs 128 and 32, 16x112x112 and 16x224x224), of
   I3D's (TF "SAME") and of I3D-R50-NL's, fp32 and bf16, on inputs with
   NaNs and on tie-rich inputs (-1, -0, +0, 1); its device ms per pool of
   the bs-128 S3D pass and of I3D-R50-NL against the library and the byte
   bound (x read once, y written once).
5. K5 (SepConv pair backward) against its plain version on all seven
   outputs at five Mixed-block shapes, one small ragged shape (the simt
   route in both dtypes) and one small aligned shape (128-row tiles that
   straddle clip edges), fp32 and bf16, each with its route (bf16 with C
   and F multiples of 8 takes the tensor-core route); the same seven
   outputs (rel-L2, untimed) at all 18 pairs of the 16x112x112 bs-32 step,
   whose row-tile counts and wgrad row splits differ; two calls bit-equal;
   then kernel, plain and unfused-backward times at all 18 fused SepConvs
   of a pass, each with its launch plan, and the wrapper's host time per
   call.
6. the slice: a small S3D+graph step on the card against the same step on
   the CPU; the port's trainer at full S3D width (configs/visual_moco.yaml,
   graph on, bs 128, 16x112x112, NCE_K 16384, bf16 compute) for 2 warm-up
   and 3 timed steps, with the kernels' launch counts read around exactly
   those steps; then the same with ``TPU.SEPCONV_FUSED True`` (small step
   card vs CPU, then the full-width trainer); then the default step at
   16x224x224 (``INPUT.BASE_SIZE [224, 224]``, ``SCALE_SIZE [256, 256]``)
   at bs 32, whose stem and Mixed_3b/3c pools run K3/K4 in strips.  The
   trainers draw their synthetic batches through the port's ``Loader``.
7. the trainer from an on-disk shard store: the port's
   ``write_shard_store`` writes 384 videos of 64 seeded frames at the
   128x128 canvas (1.1 GiB, three batches of 128 per epoch) into a
   temporary directory; a ``Trainer`` (``DATASET.SOURCE frames``,
   ``INPUT.PRE_LOAD shard``, the full-width geometry of phase 6a) runs
   epoch 0 (3 steps), saves through its ``Saver``, and a second ``Trainer``
   resumes from that checkpoint (``CHECKPOINT.RESUME``): its state must
   equal the saved one bit for bit.  Both then run epoch 1's 2 steps with
   ``cudnn.deterministic`` and must agree bit for bit, state and losses
   (else the differing entries are named and the run fails).  Per step: the
   host time, the data wait on the loader, the pin and copy to the card,
   the loss; the launch counts of
   the 5 straight steps (K1 30, K2 45, K3 45, K4 20), finite losses, the
   queue pointer and EMA != params; the mean of steps 2-3 beside phase
   6a's synthetic step time.
8. the step across ranks (3 steps each, full S3D width, 16x112x112):
   (a) one rank in an NCCL group against the trainer without a group
   (bs 128, bf16, ``cudnn.deterministic``): losses and the whole state bit
   for bit, the same kernel counts; (b) under ``cudnn.deterministic``, two
   rank processes sharing the card over gloo (16 or 64 rows each) against
   one process on the same global batches, in fp32 at global bs 32 (TF32
   off) and in bf16 at bs 128: the one process takes its BN statistics
   through the ranks' own function (``sync_bn.sum_form_bn``) and must
   repeat itself bit for bit; the two ranks' states bit-equal, each rank's
   K1-K4 counts, step host times and peak memory; the keys each step put
   in the queue, each step's loss, the parameter update after steps 1 and
   3 and the EMA encoder's BN statistics within ``TOL_RANKS`` of the one
   process's; then a control, the same ranks with BN per rank, must exceed
   at least one of those bounds; where the host has two or more cards,
   bf16 (b) again with one rank per card over NCCL; (c) the same two ranks
   with ``TPU.SHUFFLE_BN True``: finite losses, bit-equal ranks; (d) then a
   ``Trainer`` with ``TPU.SEPCONV_FUSED True`` on those ranks must build
   (phase 15 trains it).
9. the SimSiam (GCA-S) and memory-bank regimes: (a) a small SimSiam step
   and a small bank step (one negative draw made on the CPU) on the card
   against the same steps on the CPU, at 8 clips; three readings of the
   SimSiam loss's spread at 4 clips (card vs CPU with and without the
   graph, CPU fp32 vs a float64 backbone), printed; (b) the trainer on
   ``configs/visual_simsiam.yaml`` with the graph on (full S3D, 16x224x224,
   FEAT_DIM 1024, bf16) at bs 32, one rank's rows of the shipped 256 over 8
   ranks; (c) the trainer at the ``configs/visual_moco.yaml`` geometry
   (bs 128, 16x112x112) with ``CONTRAST.MEM_TYPE bank``, the schema's NCE_K
   65536 and a 240,000 x 128 bank (Kinetics-400's clip count: the synthetic
   source holds ``DATASET.NUM_CLASS`` x 4 clips); each for 2 warm-up and 3
   timed steps, with the K1-K4 counts of exactly those steps held to
   ``kernel_times.step_calls`` (SimSiam runs both views' backwards: K3 18
   and K4 8 per step), finite losses, the bank's moved rows, step host ms
   and ``max_memory_allocated``; (d) for each regime one NCCL rank against
   no group, bit for bit, then two rank processes sharing the card over
   gloo running both regimes: bit-equal states (the bank included), each
   rank's counts, step host ms and peak memory.
10. downstream training and evaluation through the port's ``train_ds``,
   ``test_ds`` and ``video_retrieval``: (a) a small S3D+graph fine-tune
   step and eval forward (fp32, partial BN) on the card against the CPU,
   the parameter update within ``TOL_DS_UPDATE``;
   (b) ``train_ds``'s Trainer on ``configs/action_fine_tune.yaml`` (S3D,
   bs 32, 16x112x112, 101 classes, DROPOUT 0.7, partial BN, bf16) from a
   checkpoint that the port's MoCo trainer writes in the phase: 2 warm-up
   and 3 timed steps (K3 9 and K4 4 per step, K1, K2 and K5 none), a
   validation and ``model_best_state``; (c) the linear probe
   (``configs/action_linear_probe.yaml``) under ``PROBE_BN eval`` and
   ``reference``: the encoder's parameters bit for bit unchanged,
   ``new_fc`` moved, ``stem_0``'s BN statistics alone moved under
   ``reference``, K3/K4 none; (d) ``MODEL.AUG_FLAG True``: 3 steps and an
   eval batch, K1/K2 as ``kernel_times.step_calls``; (e) ``MODEL.NO_PARTIALBN
   True TPU.SEPCONV_FUSED True``: 3 steps, K5 18 per step; (f) ``test_ds`` on
   (b)'s best checkpoint, 16 videos x 10 clips x 3 crops: finite scores
   that equal the mean of the logits computed one crop at a time within
   ``TOL_BATCHING_BF16``, the eval forward's clips/s and peak memory; (g)
   ``video_retrieval`` on the phase's pretrain checkpoint, 32 videos per
   split: finite features, R@k and videos/s.  Each run prints its step
   host ms, clips/s, losses, peak memory and kernel counts, and the phase
   ends with a ``downstream_launches`` JSON line.
11. the graph-benefit A/B (``graph_benefit.py``; tiny3d at its full width,
   fp32, T 8, 16x16, bs 16): (a) K1, K2 and K4 against their plain versions
   at the A/B's shapes (``AB_K1``, ``AB_K2``, ``AB_POOL``); (b) one A/B pair
   through ``graph_benefit.run_one`` (moco, ``temporal_shortcut_clips``,
   seed 0, 150 epochs, both arms): before, after, the losses, the margin and
   the seconds per arm, beside the committed artifact's seed-0 record; the
   K1-K5 calls of exactly that pair held to ``kernel_times.step_calls(...,
   backbone="tiny3d")`` and the shapes each kernel saw to the tables; it
   fails when an arm does not train or the margin is below ``AB_MARGIN``.
12. downstream across ranks, ``train_ds`` from a graph-on MoCo checkpoint
   that the phase writes, ``MODEL.AUG_FLAG True``, 3 steps per run: (a) the
   fine-tune (``configs/action_fine_tune.yaml``: S3D, bs 32, 16x112x112, 101
   classes, DROPOUT 0.7, partial BN, bf16) as one rank in an NCCL group
   against no group, bit for bit, with the step's kernel counts; (b) two
   rank processes sharing the card over gloo, 16 rows each: the fine-tune
   and the linear probe (``configs/action_linear_probe.yaml``) under
   ``PROBE_BN reference`` and ``eval`` in bf16 (bit-equal ranks, each
   rank's K1-K4 counts held to ``kernel_times.step_calls``, step host ms,
   peak memory), then the fine-tune and the reference probe in fp32 against
   one process (sum-form BN, repeated bit for bit) within ``TOL_DS_RANKS``,
   beside the same ranks with BN per rank, which must exceed a bound; (c)
   ``test_ds`` (202 videos in batches of 45) and ``video_retrieval`` (15
   videos per split in batches of 5) through their ``main`` on the same two
   ranks, bf16 and fp32: rank 0 alone prints the report and writes, and its
   scores and features equal one process's within ``TOL["fp32"]``; (d) K1,
   K2 and K3/K4 against their plain versions at a rank's shapes (bs 16,
   16x112x112, bf16), K1's draw at clip 16 equal to those rows of the draw
   over 32 clips, bit for bit.
13. the reference's exported 3D backbones S3DG, I3D and InceptionI3d
   (``models/s3d.py`` with ``temporal_bias``, ``models/i3d.py``; I3D pads
   TF "SAME", so every strided pool pads one more on its high side and
   stage 13 leaves 4x4): (a) K3/K4 at every I3D pool of the bs-128
   16x112x112 step and of the bs-32 16x224x224 step (the stem pool there in
   strips), fp32 and bf16, against the plain version (exact) and torch's
   own backward of the same pool (``ceil_mode`` with the low pads), then
   at ragged SAME shapes (odd and even T, H, W; C not a multiple of 8),
   exact; the kernel, plain, torch and bound times of the pool shapes that
   S3D's step does not have; K1 and K2 against their plain versions at
   I3D's aug point 14 (q/k (128, 2, 1664), x (128, 2, 4, 4, 832)), with
   times; (b) a small I3D+graph and a small S3DG+graph MoCo step on the
   card against the CPU; (c) the trainer on ``configs/visual_moco.yaml``
   with ``MODEL.BACKBONE I3D``, then ``S3DG``, graph on (bs 128,
   16x112x112, NCE_K 16384, bf16), 2 warm-up and 3 timed steps, the K1-K5
   counts of exactly those steps held to ``kernel_times.step_calls`` (K1
   30, K2 45, K3 45, K4 20, K5 0), ms/step, clips/s, finite losses, peak
   memory; ``InceptionI3d``: I3D's parameter names and one step; (d)
   ``train_ds`` on ``configs/action_fine_tune.yaml`` with I3D (partial BN,
   the checkpoint's graph blocks kept) from (c)'s I3D checkpoint, 3 steps
   (K3 9, K4 4, K1 3, K2 6 per step), a validation and ``test_ds`` over 8
   videos; (e) ``MODEL.PRETRAIN_PATH``: an I3D and
   an S3DG state_dict under the reference's names, with seeded values,
   load strictly into both encoders of the pretrain trainer, which takes a
   step (graph off); the I3D file into ``train_ds`` too.  The phase ends
   with a ``backbones`` JSON line.
14. the 2D backbones (``MODEL.BACKBONE_TYPE 2D``: ResNet-18 .. 152,
   BN-Inception, Inception-v3; frames folded into the batch, features
   averaged over T) and the 3D ResNets (R3D, ``resnet_i3d``, R(2+1)D; graph
   blocks on the inputs of stages 2, 3, 4, the 3x3x3 / 2 stem pool on K4):
   (a) K1, K2 and K4 against their plain versions (``kernel_checks``), fp32
   and bf16, at R3D-18's aug points (x (128, 8, 28, 28, 64), (128, 4, 14,
   14, 128), (128, 2, 7, 7, 256)), at R3D-50's (256, 512, 1024 channels)
   and at the stem pool, x (128, 16, 56, 56, 64) and, in strips, (32, 16,
   112, 112, 64), bit for bit; then per call in bf16 the kernel's CUDA-event
   ms, the bound, the plain version's and the library call's ms
   (``torch.bmm``, torch's pool backward), as a ``resnet_kernels`` JSON
   line; (b) the 3x3/1 average pool's backward on the card against the
   CPU (the library's printed, ``layers.avg_pool3x3``'s held), then small
   MoCo steps on the card against
   the CPU for ``resnet3d_18``, ``resnet_i3d_18``, ``resnet2p1d_18``,
   ``resnet18``, ``bninception`` and ``inception_v3`` (80x80); (c) GCA
   MoCo through the trainer on ``configs/visual_moco.yaml`` with
   ``MODEL.AUG_FLAG True``: R3D-18 at bs 128, 16x112x112 (K1 30, K2 45,
   K4 5 over the 5 steps, 3 graph blocks), then ResNet-101 2D at bs 16,
   16x224x224 (256 frames per view; no kernel, no graph block): ms/step,
   clips/s, peak memory; (d) ``train_ds`` (partial BN) with R3D-18 from
   (c)'s checkpoint (K1 3, K2 6, K4 1 per step) and with ResNet-50 2D (no
   kernel), its validation and ``test_ds`` on its best checkpoint; (e) a
   reference-named file per family (R3D, resnet_i3d, R(2+1)D, ResNet 2D,
   BN-Inception, Inception-v3) loads strictly through
   ``MODEL.PRETRAIN_PATH`` into both pretrain encoders and into
   ``train_ds``, each taking a step.  The phase ends with a ``resnets``
   JSON line.
15. K5 across ranks, the solver options and the input modalities: (a) the
   staged K5 (the wrapper's three C entries, ``vgs_sepconv_bwd_stage1..3``)
   against the one C call of all three stages (``vgs_sepconv_bwd``), bit
   for bit, and against the plain version within ``TOL_K5``, at the 18
   pairs of the bs-128 and bs-32 16x112x112 steps, fp32 and bf16; both per
   encoder pass in bf16 at bs 128 (CUDA events, device time, wrapper host
   time), and the memory the pass's outputs hold (the one call's outputs are views
   of its scratch); (b) two rank processes sharing the card over gloo, 16
   rows each of a bs-32 batch, at the stage-5, 9 and 14 pairs, fp32 and
   bf16: each rank's dx rows, and the sums over the ranks of dWs, dWt and
   the BN sums, within ``TOL_K5`` of one process's K5 over the whole batch,
   two reductions per call; (c) the fused GCA MoCo step (``TPU.SEPCONV_FUSED
   True``, S3D, graph on, 3 steps): one NCCL rank against no group, bit for
   bit (bs 128, bf16, ``cudnn.deterministic``); two gloo ranks bit-equal,
   K1-K5 at their per-step counts (K5 18), host ms and peak memory per
   rank, in fp32 at bs 32 within ``TOL_RANKS_FUSED`` of one process (sum-form BN)
   with a per-rank-BN control above a bound, and in bf16 at bs 128; (d) the
   fine-tune with ``MODEL.NO_PARTIALBN True TPU.SEPCONV_FUSED True`` from a
   pretrain checkpoint on the same two ranks (K5 18 per step), bf16, and
   fp32 within ``TOL_FUSED_FT`` of one process with its control; (e) three
   fine-tune steps (S3D, bs 32, 16x112x112, bf16, graph on) for SGD with
   and without ``SOLVER.USE_TRICK``, Adam, AdamW, LARS with and without the
   trick, and Adam with ``SOLVER.CLIP_GRADIENT``, finite losses and K1-K4
   counts, then one update of each from fixed gradients on the card against
   the CPU within 1e-6 (rel-L2); (f) Flow (``NEW_LENGTH 5``, 10 channels)
   and RGBDiff (18 channels in, 15 after the difference) fine-tune steps at
   full S3D width through the fused downstream step, K1-K4 at S3D's counts;
   the stem's forward and backward at 3 and 10 input channels (CUDA
   events); an RGB pretrain state inflated by ``inflate_first_conv`` loads
   strictly into the Flow model.
16. CMC (``CROSS.MODALITY cross``: two full S3D stacks with graph blocks at
   5, 9, 14, ``model_2`` on the clips' temporal differences): (a) K1-K4
   against their plain versions at the inputs ``model_2`` gives them (its
   forward and backward on the temporal differences of 128 augmented
   synthetic clips at 16x112x112, each call's inputs recorded), fp32 and
   bf16: K1's draw and closed-form backward and K2 both ways within phases
   2-3's bounds, K3/K4 exact; (b) small CMC MoCo and bank steps (S3D, graph
   at 5 and 9, 8 clips of 8x32x32, fp32) card against CPU within phase 9's
   bounds; (c) the trainer at full width: CMC MoCo (bs 128, bf16, NCE_K
   16384) 5 steps with a checkpoint, 3 steps with ``TPU.SEPCONV_FUSED
   True``, the CMC bank (K 65536 over 240,000 rows per modality) 5 steps:
   ms/step, peak memory, the per-step kernel calls against
   ``kernel_times.step_calls(cmc=True)`` and, for MoCo, the recorded
   prediction (K1 12, K2 18, K3 18, K4 8; K5 36 fused), both memories'
   rows written; (d) CMC MoCo on one NCCL rank against no group, bit for
   bit, and on two gloo ranks sharing the card (fp32, bs 32) against one
   process within phase 8's bounds beside a per-rank-BN control; (e)
   ``train_ds`` from (c)'s checkpoint: the surgery takes ``model_1``'s
   encoder bit for bit, 3 fine-tune steps at the fine-tune's kernel counts.
17. ``i3d_res50_nonlocal``, the text-video ``S3DGText`` and the
   reference-checkpoint converter (``phase_nonlocal_text``).
18. ``TPU.REMAT``, the export and Grad-CAM (``phase_remat_export_cam``):
   (a) 3 GCA MoCo steps of the trainer (S3D, graph at 5, 9, 14, bs 8,
   16x112x112, fp32, cuDNN deterministic) under ``block`` and
   ``conv_saved``, and ``block`` with ``TPU.SEPCONV_FUSED``, against the
   same steps without remat, bit for bit (losses, gradients, parameters, BN
   statistics, queue, EMA), K1-K5 at their exact counts (a recompute
   reruns forwards, not the backward kernels); (b) the trainer at the main
   path's geometry (bs 128, bf16) under off, ``block`` and ``conv_saved``:
   ms/step and peak memory, both recompute peaks below off's; (c) the GCA
   S3D encoder of (a)'s checkpoint exported by ``export_model`` at batch 2
   and with a symbolic batch (fp32): K1/K2 against their plain versions at
   the export's shapes, each artifact against the live model (< 1e-4) with
   K1 3 and K2 3 launches per call, then both loaded in a fresh process
   that imports torch and the port's ops alone, bit for bit; K1's and K2's
   forwards through the launcher, the registered operator and the wrapper
   (CUDA events, host us); (d) Grad-CAM of an S3D classifier (fp32) on the
   card against the CPU, within 1e-3, head self-check below 1e-4.

19. the space-to-depth stem, the frame-axis ring and the sharded
   checkpoint backend (``phase_s2d_ring_ckpt``): (a) K1-K4 against their
   plain versions at the bs-128 step's shapes (bf16); the trainer (S3D +
   graph, bs 128, 16x112x112, bf16) under ``TPU.STEM_S2D`` off, full and
   spatial, 2 warm-up and 3 timed steps each: ms/step, peak memory, kernel
   counts; each stem's forward + backward device ms (profiler); one fp32
   forward + backward (bs 8, eval-mode BN, TF32 off, cuDNN deterministic)
   of the standard model and of each S2D model on the fold of its
   weights, with the clip and the stem's kernels on a grid where every
   fp32 sum of the stem is exact: the stem's output, the features, the
   loss and every gradient outside the stem within 1e-5 rel-L2, and each
   stem gradient within 1e-5 of the standard stem's through the fold's
   adjoint (``stem_same_function``); (b) the
   graph block at base.5's width (192 channels, 28x28, B 8, T 64) through
   ``parallel/sequence.py`` on two gloo ranks sharing the card (Tl 32),
   fp32 and bf16, forward and backward with an injected draw: output, dx
   and the summed weight gradients in fp32 within 1e-4 rel-L2 of one CPU
   process (plain versions) with the q/k kernels scaled off the saturated
   softmax; at the init's own scale, the steps before the propagation in
   float64 on the card within 1e-9 of the CPU's, and the card's fp32
   output, dx and each weight gradient no further from a float64 CPU run
   than 4x the CPU fp32 run's own distance times how much further the
   card's fp32 similarity is from float64; K2 4 launches per pass per rank, host ms and
   bytes sent per rank; K2 at the ring's block shape against its plain
   version; one NCCL rank at T 32 against the single-device module; (c)
   (a)'s step with ``TPU.CKPT_BACKEND orbax`` and ``TPU.ASYNC_CKPT``: save
   after step 2, steps 3-4, a fresh model loads the directory bit for bit
   and its step 3's loss matches the uninterrupted run's no worse than a
   control from the same state in memory; the directory's bytes, the
   save's blocking time async and sync, the load time.

20. SlowFast-R50 8x8's kernels at its cell's size, bs 64, 32x224x224
   (``phase_slowfast``): K1 at T = 32 (its tile-8 route) and K2 on its
   tensor-core route with kpad 32 at the Fast pathway's three graph
   blocks, and K4 at the two 1x3x3 / (1, 2, 2) stem pools (64 and 8
   channels), against their plain versions in fp32 and bf16; the pool
   forward kernel bit for bit against the library there; the largest
   |kernel - plain| beside PERF.md's K1 and K2 rows; K1, K2 and K4 times.

21. The stems' convolution forward (``phase_stem``, ``csrc/stem_conv_fwd.cu``,
   row S of PERF.md's kernel table) against its plain version
   (``stem_conv3d_plain``: ``F.conv3d`` on the bf16 NCDHW clip, cuDNN here)
   at every stem of the benchmark's cells (S3D's and I3D-R50-NL's at bs 256,
   16x112x112; SlowFast's Slow, on its frame table, and Fast at bs 64,
   32x224x224) and at I3D's, R3D's and the 2-channel Flow stem's at bs 128:
   the bf16 clip in the layout it reaches the stem in (contiguous after
   S3D's and I3D's cast, else a view of the augmentation's output with each
   frame's channel planes apart), outputs within one bf16 ulp of the
   largest output; each call's event ms, its bound (x read once and y
   written once, or its bf16 operations), ``F.conv3d``'s ms and the ms of
   the library's tensor-core path (C zero-padded to 8 in one copy of the
   clip, then cuDNN's bf16 channels-last convolution); the instantiations
   the build reports.  S3D's stem gives row S of the kernel record, whose
   launches are phase 6's (one stem in each of MoCo's two passes).

``python3 chip_smoke.py --only phase_fused_ranks`` (development) runs the
build and the named phase functions alone, without the kernel record and
the result line.

Each phase prints its wall seconds.  Times are CUDA events around one
call, the median of 20 calls (10 for K5; ``kernel_times.event_ms``).  ``bound``
is the least time the card could take: the larger of the bytes the
function must move over 3.35 TB/s and its operations over the peak rate
of its type (989 TFLOP/s bf16, 67 TFLOP/s fp32), for the published H100
SXM at 700 W.

The line before the last is the per-kernel JSON record: ``launches`` is
the kernel's wrapper-call count over the 5 steps of the 112x112 trainer run
that uses it, ``max_abs_err`` the largest kernel-vs-plain difference of its
checks, and ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` the
kernel's, its plain version's, its bound's and the library call's times
summed over the shapes of one encoder pass in bf16.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import itertools
import json
import math
import os
import shutil
import sys
import tempfile
import time

import torch

# kernel timing shared with the script that times older trees; K1_SHAPES
# (B, T, D) of K1's q/k and K2_SHAPES (B, T, H, W, C) of K2's input at S3D
# aug points 5, 9 and 14 of the bs-128, 16x112x112 step; POOLS every max
# pool and SEPCONVS every fused SepConv pair of one S3D pass there
# step_calls: each kernel's wrapper calls per step of a regime; geometry:
# the same tables for another frame size and batch
from video_graph_ssl_tpu_torch.kernel_times import (BACKBONE_CALLS, K1_SHAPES, K2_SHAPES,
                                                    PATTERNS, POOLS, REGIME_PASSES, SEPCONVS,
                                                    device_us, event_ms, geometry, gpu_line,
                                                    host_us, sepconv_inputs, step_calls)
from video_graph_ssl_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "visual_moco.yaml")
# the trainers' experiment directories (checkpoints, metrics.jsonl), removed
# at exit
RUN_DIR = None

# K1 edges: T = 32 at the first aug point's D (many splits), ragged D
# (scalar loads), D below one split
K1_EDGE = [(4, 32, 7 * 7 * 96), (5, 8, 37), (64, 8, 3)]

# Tolerances, as max|kernel - plain| / max(1, max|plain|) unless noted.
# fp32: the kernels sum in another order than cuBLAS -> ~1e-6 relative.
# bf16 outputs: one bf16 ulp (2^-8 relative) where rounding flips.
TOL = {"fp32": 1e-5, "bf16": 8e-3}
TOL_SAMPLED = 1e-4   # logit(p) amplifies p's rounding by 1/(p(1-p))
TOL_GRAD = {"fp32": 1e-4, "bf16": 1e-2}   # relative to max|grad|
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
CL = torch.channels_last_3d

# H100 SXM published peaks at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}

# K1's, K2's and the pools' shapes in the 16x224x224 step at bs 32 (phase
# 6c and SimSiam's phase 9 (b)), whose activations are the size of the
# bs-128 112x112 step's
K1_224, K2_224, POOLS_224, _ = geometry(224, 32)
# every kernel's shapes in the 16x112x112 step at bs 32 (phase 10's
# fine-tune, graph and fused runs): K1's splits of D follow B, and K5's
# BN tile and wgrad row splits follow the row count, so these launch plans
# differ from the bs-128 step's; checked, not timed
K1_112_32, K2_112_32, POOLS_112_32, SEPCONVS_112_32 = geometry(112, 32)
# phase 11's shapes: the graph-benefit A/B (graph_benefit.py; tiny3d at its
# full width, 16/32/64 channels, fp32, clips (16, 8, 16, 16, 3), the graph
# block at aug point 1, models/tiny.py).  stage0 takes T 8 -> 4 and 16x16
# -> 8x8 at 16 channels; the block's embeddings halve the channels (8) and
# pool 8x8 -> 4x4, so D = 4 * 4 * 8.  B is 16 in a step and 48 (every clip)
# in the eval-mode encodes before and after training.
#   K1: q, k (B, 4, 128) -> adj (B, 4, 4)
#   K2: adj (B, 4, 4), x (B, 4, 8, 8, 16) (F = 1024); transposed in the backward
#   K4: the (1, 2, 2) / (1, 2, 2) pool after stage1: x (16, 2, 4, 4, 32)
#       (B, T, H, W, C), dy (16, 32, 2, 2, 2) -> dx (16, 32, 2, 4, 4); backward only
AB_K1 = [(16, 4, 128), (48, 4, 128)]
AB_K2 = [(16, 4, 8, 8, 16), (48, 4, 8, 8, 16)]
AB_POOL = ((16, 2, 4, 4, 32), (1, 2, 2), (1, 2, 2), (0, 0, 0))
# K5 checks: four branch-1 shapes, one narrow branch-2 shape, a small
# ragged one (C, F not multiples of 8: the simt route in both dtypes; 64-row
# tiles straddle clip edges) and a small aligned one (the tensor-core route
# in bf16 on 128-row tiles that straddle clip edges, N below a tile)
K5_CHECKS = ["3b b1", "3c b1", "4f b1", "5c b1", "4c b2"]
K5_SMALL = ("small", (2, 4, 6, 6), 5, 7)
K5_ALIGNED = ("small aligned", (2, 4, 6, 6), 16, 24)
# two calls bit-equal (no atomics): an S3D shape and both small shapes
K5_DETERMINISM = ["4f b1", "small aligned", "small"]
# K5 tolerances, per output.  The function is discontinuous: dz = [z > 0] g
# at both ReLUs.  The kernel sums in another order than cuDNN, so a
# pre-activation within rounding of 0 can land on the other side of its
# ReLU (fp32: a few of 25M elements; bf16, whose y1/y2 rounding step is
# 2^-8: many more).  One flip moves its channel's BN sums by about
# 1/sqrt(elements per channel) relative, and through the BN mean terms every
# element of dy, dx and dW a little, so at bs 128 two fp32 summation orders
# of this function differ by far more than fp32 rounding.  Each output is
# held to a rel-L2 bound, and the small shape, where a flip is improbable,
# to the fp32 summation-order bound.
TOL_K5 = {"fp32": 1e-2, "bf16": 2e-2}
TOL_K5_SMALL = 1e-4
# torch's own pool backward: fp32 sums in another order; bf16 accumulates in
# bf16 (atomics), several bf16 steps off the kernel's fp32 sums
TOL_POOL_LIB = {"fp32": 1e-5, "bf16": 5e-2}
# ragged pool shapes (B, T, H, W, C): C 12 (bf16) or 6 (fp32) takes the
# kernel's scalar path; odd H, W; T = 1 where the window fits
POOL_RAGGED = [(2, 5, 9, 7, None), (2, 1, 9, 9, None), (3, 4, 7, 5, 40)]


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol and math.isfinite(err)
    print(f"  {name:<52s} err {err:.3e}  tol {tol:.0e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: error {err:.3e} above {tol:.0e}")


def bound(nbytes: float, flops: float, dn: str):
    """(ms, "bytes" or "operations"): the larger of the two floors."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[dn] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _bound_by(bys) -> str:
    return "operations" if "operations" in bys else "bytes"


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def pool_key(shape, k, s, p) -> tuple:
    """A pool's (x (B, T, H, W, C), window, stride, (lo, hi) pads), whatever
    form its padding was given in (the wrappers pass (lo, hi) pairs)."""
    from video_graph_ssl_tpu_torch.ops.maxpool import resolve_padding
    return tuple(shape), tuple(k), tuple(s), resolve_padding(p, shape[1:4], k, s)


# --------------------------------------------------------------------------- #
def phase_k1(dev) -> dict:
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.ops.temporal_graph import hop_weight_matrix

    print("phase 2: K1 graph adjacency vs plain")
    worst, ms, plain_ms, bound_ms = 0.0, 0.0, 0.0, 0.0
    bys = set()
    g = torch.Generator(device=dev).manual_seed(0)
    timings = []
    # the 112x112 step's shapes (timed), then the 224x224 and 112x112 bs-32
    # steps', whose splits of D and tile counts differ
    for (b, t, d), timed in [(x, True) for x in K1_SHAPES] + [
            (x, False) for x in K1_224 + K1_112_32]:
        theta = torch.from_numpy(hop_weight_matrix(t, 3, 0.5)).to(dev)
        for dn, dt in DTYPES.items():
            q = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(dt)
            k = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(dt)
            u = torch.rand(b, t, t, device=dev, generator=g) * (1 - 2e-6) + 1e-6
            plan = gk.adjacency_plan(b, t, d, dt)
            tag = f"({b},{t},{d}) {dn}" + ("" if timed else f" [{plan.splits} splits]")
            a_k = gk.adjacency_fwd_kernel(q, k, theta, None, 0, 1.0, False, 0)
            a_p = gk._adjacency_fwd_plain(q, k, theta, None, 0, 1.0, False, 0)
            for name, x, y in zip(("adj", "S", "p"), a_k, a_p):
                check(f"K1 {tag} sample=False {name}", rel_err(x, y), TOL["fp32"])
                worst = max(worst, max_abs(x, y))
            s_k = gk.adjacency_fwd_kernel(q, k, theta, u, 0, 1.0, True, 0)[0]
            s_p = gk._adjacency_fwd_plain(q, k, theta, u, 0, 1.0, True, 0)[0]
            check(f"K1 {tag} sample=True, given u", rel_err(s_k, s_p), TOL_SAMPLED)
            worst = max(worst, max_abs(s_k, s_p))

            # in-kernel Philox: range, determinism, seed dependence
            a1 = gk.adjacency_fwd_kernel(q, k, theta, None, 1234, 1.0, True, 0)[0]
            a2 = gk.adjacency_fwd_kernel(q, k, theta, None, 1234, 1.0, True, 0)[0]
            a3 = gk.adjacency_fwd_kernel(q, k, theta, None, 1235, 1.0, True, 0)[0]
            torch.cuda.synchronize()
            if not (float(a1.min()) >= 0.0 and float(a1.max()) <= 1.0):
                raise RuntimeError("K1 Philox adj outside [0, 1]")
            if not torch.equal(a1, a2):
                raise RuntimeError("K1 Philox: same seed, different adj")
            if torch.equal(a1, a3):
                raise RuntimeError("K1 Philox: different seed, same adj")

            # closed-form backward (kernel forward) vs autograd of the plain
            gout = torch.randn(b, t, t, device=dev, generator=g)
            for sample in (False, True):
                qa, ka = q.clone().requires_grad_(), k.clone().requires_grad_()
                adj = gk.GraphAdjacencyFn.apply(gk.adjacency_fwd_kernel, qa, ka,
                                                theta, u, 0, 1.0, sample, 0)
                dq_k, dk_k = torch.autograd.grad((adj * gout).sum(), (qa, ka))
                qb, kb = q.clone().requires_grad_(), k.clone().requires_grad_()
                adj = gk.graph_adjacency_plain(qb, kb, theta, 0, 1.0, sample, u)
                dq_p, dk_p = torch.autograd.grad((adj * gout).sum(), (qb, kb))
                for name, x, y in (("dq", dq_k, dq_p), ("dk", dk_k, dk_p)):
                    err = float((x.float() - y.float()).abs().max()
                                / y.float().abs().max().clamp_min(1e-30))
                    check(f"K1 {tag} sample={sample} {name} (rel)", err, TOL_GRAD[dn])
            if not timed:
                continue
            fwd = lambda: gk.adjacency_fwd_kernel(q, k, theta, None, 7, 1.0, True, 0)
            tk = event_ms(fwd)
            tp = event_ms(lambda: gk._adjacency_fwd_plain(
                q, k, theta, None, 7, 1.0, True, 0))
            # reads q, k, theta; writes adj, S, p (fp32); q.k^T dominates
            bm, by = bound(2 * q.numel() * q.element_size() + 4 * t * t + 3 * 4 * b * t * t,
                           2 * b * t * t * d, dn)
            dev_us = host = None
            if dn == "bf16":
                dev_us, host = device_us(fwd, PATTERNS["K1"]), host_us(fwd)
            timings.append((tag, tk, tp, bm, by, dev_us, host))
            if dn == "bf16":
                bys.add(by)
                ms += tk
                plain_ms += tp
                bound_ms += bm
    # Philox moments on 4096 x 32 x 32 draws: std of the mean ~1.4e-4
    b, t, d = 4096, 32, 8
    q = torch.randn(b, t, d, device=dev, generator=g)
    theta = torch.from_numpy(hop_weight_matrix(t, 3, 0.5)).to(dev)
    u_out = torch.empty(b, t, t, device=dev)
    a_k = gk.adjacency_fwd_kernel(q, q, theta, None, 99, 1.0, True, 0, u_out=u_out)[0]
    a_p = gk._adjacency_fwd_plain(q, q, theta, u_out, 99, 1.0, True, 0)[0]
    check("K1 (4096,32,8) fp32 Philox draw, adj vs plain on u_out",
          rel_err(a_k, a_p), TOL_SAMPLED)
    a_k = gk.adjacency_fwd_kernel(q, q, theta, None, 0, 1.0, False, 3)[0]
    a_p = gk._adjacency_fwd_plain(q, q, theta, None, 0, 1.0, False, 3)[0]
    check("K1 (4096,32,8) fp32 band mask nei_size=3", rel_err(a_k, a_p), TOL["fp32"])
    check("K1 Philox (4096,32,32) |mean(u) - 1/2|", abs(float(u_out.mean()) - 0.5), 2e-3)
    check("K1 Philox (4096,32,32) |var(u) - 1/12|", abs(float(u_out.var()) - 1 / 12), 1e-3)
    # the draw is clamped to [eps, 1 - eps] in fp32; allow one fp32 ulp
    u_min, u_max = float(u_out.min()), float(u_out.max())
    print(f"  K1 Philox u range [{u_min!r}, {u_max!r}]")
    if not (0.99e-6 <= u_min and u_max <= 1.0 - 0.99e-6):
        raise RuntimeError(f"K1 Philox u range [{u_min!r}, {u_max!r}] "
                           "outside [1e-6, 1 - 1e-6]")
    # a rank's rows: clip0 = r * B / W places the local clips in the global
    # batch, and the draw on them is the global draw's rows, bit for bit
    for b, t, d in K1_SHAPES:
        theta = torch.from_numpy(hop_weight_matrix(t, 3, 0.5)).to(dev)
        q = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(torch.bfloat16)
        k = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(torch.bfloat16)
        u_full = torch.empty(b, t, t, device=dev)
        a_full = gk.adjacency_fwd_kernel(q, k, theta, None, 31, 1.0, True, 0, u_out=u_full)[0]
        for w in (2, 4):
            for r in range(w):
                lo, hi = r * b // w, (r + 1) * b // w
                u_r = torch.empty(hi - lo, t, t, device=dev)
                a_r = gk.adjacency_fwd_kernel(q[lo:hi], k[lo:hi], theta, None, 31, 1.0, True,
                                              0, u_out=u_r, rows=(lo, b))[0]
                if not torch.equal(u_r, u_full[lo:hi]):
                    raise RuntimeError(f"K1 ({b},{t},{d}) rows [{lo}, {hi}) of {w} ranks: "
                                       "the draw differs from the full batch's rows")
                # the similarity's splits of D depend on the clip count
                check(f"K1 ({b},{t},{d}) bf16 rank {r} of {w}: adj vs full rows",
                      rel_err(a_r, a_full[lo:hi]), TOL_SAMPLED)
        print(f"  K1 ({b},{t},{d}) in-kernel draw with clip0 = r*B/W, W = 2 and 4: "
              "equal to the full batch's rows, bit for bit")
    # T = 32 at a step-sized D, ragged D (scalar loads), D below one split
    for b, t, d in K1_EDGE:
        theta = torch.from_numpy(hop_weight_matrix(t, 3, 0.5)).to(dev)
        for dn, dt in DTYPES.items():
            q = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(dt)
            k = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(dt)
            plan = gk.adjacency_plan(b, t, d, dt)
            tag = f"K1 ({b},{t},{d}) {dn} [{plan.splits} splits, {plan.vec}-element loads]"
            for name, x, y in zip(("adj", "S", "p"),
                                  gk.adjacency_fwd_kernel(q, k, theta, None, 0, 1.0, False, 0),
                                  gk._adjacency_fwd_plain(q, k, theta, None, 0, 1.0, False, 0)):
                check(f"{tag} {name}", rel_err(x, y), TOL["fp32"])
                worst = max(worst, max_abs(x, y))
            first = gk.adjacency_fwd_kernel(q, k, theta, None, 5, 1.0, True, 0)
            second = gk.adjacency_fwd_kernel(q, k, theta, None, 5, 1.0, True, 0)
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                raise RuntimeError(f"{tag}: two calls with one seed differ")
    for tag, tk, tp, bm, by, dev_us, host in timings:
        print(f"  K1 {tag} sampled fwd: kernel {tk:.4f} ms  plain {tp:.4f} ms  "
              f"bound {bm:.4f} ms ({by})  library: no single call"
              + (f"  device-only {dev_us:.2f} us, wrapper host {host:.1f} us per call"
                 if dev_us is not None else ""))
    return {"name": "graph_adjacency", "route": "cuda",
            "source": "video_graph_ssl_tpu_torch/csrc/graph_adjacency.cu",
            "replaces": "video_graph_ssl_tpu/ops/pallas/graph_kernel.py:75",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": _bound_by(bys), "library_ms": None}


def phase_k2(dev) -> dict:
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp

    print("phase 3: K2 GCN propagation vs plain")
    worst, ms, plain_ms, bound_ms, lib_ms = 0.0, 0.0, 0.0, 0.0, 0.0
    bys = set()
    g = torch.Generator(device=dev).manual_seed(1)
    timings = []
    # the 112x112 step's shapes (timed), then the 224x224 and 112x112 bs-32
    # steps'
    for shape, timed in [(x, True) for x in K2_SHAPES] + [
            (x, False) for x in K2_224 + K2_112_32]:
        b, t = shape[:2]
        for dn, dt in DTYPES.items():
            x = torch.randn(shape, device=dev, generator=g).to(dt)
            adj = torch.rand(b, t, t, device=dev, generator=g).to(dt)
            plan = gp.propagate_plan(b, t, x.numel() // (b * t), dt)
            tag = f"{shape} {dn}" + ("" if timed else f" [{plan.route}, {plan.blocks} blocks]")
            for tr in (False, True):
                y_k = gp._launch(adj, x, transpose=tr)
                y_p = gp.propagate_plain(adj, x, transpose=tr)
                check(f"K2 {tag} transpose={tr}", rel_err(y_k, y_p), TOL[dn])
                worst = max(worst, max_abs(y_k, y_p))
                if not torch.equal(y_k, gp._launch(adj, x, transpose=tr)):
                    raise RuntimeError(f"K2 {tag} transpose={tr}: two calls differ")
            gout = torch.randn(shape, device=dev, generator=g).to(dt)
            xa, aa = x.clone().requires_grad_(), adj.clone().requires_grad_()
            dx_k, da_k = torch.autograd.grad(
                (gp._GcnPropagate.apply(aa, xa).float() * gout.float()).sum(), (xa, aa))
            xb, ab = x.clone().requires_grad_(), adj.clone().requires_grad_()
            dx_p, da_p = torch.autograd.grad(
                (gp.propagate_plain(ab, xb).float() * gout.float()).sum(), (xb, ab))
            check(f"K2 {tag} dx", rel_err(dx_k, dx_p), TOL[dn])
            err = float((da_k.float() - da_p.float()).abs().max()
                        / da_p.float().abs().max())
            check(f"K2 {tag} dadj (rel)", err, TOL_GRAD[dn])
            if not timed:
                continue
            fwd = lambda: gp._launch(adj, x, transpose=False)
            tk = event_ms(fwd)
            tp = event_ms(lambda: gp.propagate_plain(adj, x))
            tl = event_ms(lambda: torch.bmm(adj, x.view(b, t, -1)))
            # reads x and adj, writes out; 2 T FLOPs per output element
            bm, by = bound((2 * x.numel() + adj.numel()) * x.element_size(),
                           2 * t * x.numel(), dn)
            dev_us = host = None
            if dn == "bf16":
                dev_us, host = device_us(fwd, PATTERNS["K2"]), host_us(fwd)
            timings.append((tag, tk, tp, tl, bm, by, dev_us, host, plan))
            if dn == "bf16":
                bys.add(by)
                ms += tk
                plain_ms += tp
                lib_ms += tl
                bound_ms += bm
    # edge shapes: T = 32 (T padded to 32 on the tensor cores; dynamic shared
    # memory above 48 KB), F not a multiple of 64 (a part-full last slice),
    # F not a multiple of 8 (CUDA cores), adj in fp32 (rounded in the kernel)
    for shape in ((4, 32, 4, 4, 64), (3, 32, 3, 3, 40), (2, 3, 3, 5, 7)):
        for (dn, dt), adj_dt in itertools.product(DTYPES.items(), (None, torch.float32)):
            x = torch.randn(shape, device=dev, generator=g).to(dt)
            adj = torch.rand(shape[0], shape[1], shape[1], device=dev, generator=g).to(
                adj_dt or dt)
            route = gp.propagate_plan(shape[0], shape[1], x.numel() // (shape[0] * shape[1]),
                                      dt).route
            for tr in (False, True):
                y_k = gp._launch(adj, x, transpose=tr)
                check(f"K2 {shape} {dn} adj {str(adj.dtype)[6:]} ({route}) transpose={tr}",
                      rel_err(y_k, gp.propagate_plain(adj, x, transpose=tr)), TOL[dn])
                if not torch.equal(y_k, gp._launch(adj, x, transpose=tr)):
                    raise RuntimeError(f"K2 {shape} {dn}: two calls differ")
    for tag, tk, tp, tl, bm, by, dev_us, host, plan in timings:
        print(f"  K2 {tag} fwd ({plan.route}, {plan.blocks} blocks): kernel {tk:.4f} ms  "
              f"plain {tp:.4f} ms  torch.bmm {tl:.4f} ms  bound {bm:.4f} ms ({by})"
              + (f"  device-only {dev_us:.2f} us, wrapper host {host:.1f} us per call"
                 if dev_us is not None else ""))
    return {"name": "gcn_propagate", "route": "cuda",
            "source": "video_graph_ssl_tpu_torch/csrc/gcn_propagate.cu",
            "replaces": "video_graph_ssl_tpu/ops/pallas/gcn_propagate.py:74",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": _bound_by(bys), "library_ms": lib_ms}



def _ncdhw(shape_bthwc, dev, dt, g, fill=None) -> torch.Tensor:
    """A (B, C, T, H, W) channels_last_3d tensor for a (B, T, H, W, C) shape."""
    b, t, h, w, c = shape_bthwc
    x = (torch.randn((b, c, t, h, w), device=dev, generator=g) if fill is None
         else fill((b, c, t, h, w)))
    return x.to(dt).contiguous(memory_format=CL)


def phase_pools(dev) -> list:
    from video_graph_ssl_tpu_torch.ops import maxpool as mp
    import torch.nn.functional as F

    print("phase 4: K3/K4 max-pool backward vs plain and torch")
    g = torch.Generator(device=dev).manual_seed(2)
    worst = {"K3": 0.0, "K4": 0.0}
    sums = {kn: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0) for kn in worst}
    rows = []
    for name, kn, shape, k, s, p in POOLS:
        for dn, dt in DTYPES.items():
            x = _ncdhw(shape, dev, dt, g)
            y, idx = F.max_pool3d(x, k, s, p, return_indices=True)
            y = y.contiguous(memory_format=CL)
            dy = torch.randn(y.shape, device=dev, generator=g).to(dt).contiguous(
                memory_format=CL)
            tag = f"{kn} {name} {shape} {dn}"
            dx_k = mp._launch(x, y, dy, k, s, p)
            dx_p = mp.max_pool3d_bwd_plain(x, y, dy, k, s, p)
            check(f"{tag} vs plain (max abs)", max_abs(dx_k, dx_p), 0.0)
            worst[kn] = max(worst[kn], max_abs(dx_k, dx_p))
            dx_l = torch.ops.aten.max_pool3d_with_indices_backward(
                dy, x, list(k), list(s), list(p), [1, 1, 1], False, idx)
            check(f"{tag} vs torch", rel_err(dx_k, dx_l), TOL_POOL_LIB[dn])
            if dn == "bf16":   # few levels: most windows tie
                xt = _ncdhw(shape, dev, dt, g, fill=lambda sh: torch.randint(
                    0, 4, sh, device=dev, generator=g).float())
                yt, it = F.max_pool3d(xt, k, s, p, return_indices=True)
                yt = yt.contiguous(memory_format=CL)
                ones = torch.ones_like(yt)
                tied = mp._launch(xt, yt, ones, k, s, p)
                ref = torch.ops.aten.max_pool3d_with_indices_backward(
                    ones, xt, list(k), list(s), list(p), [1, 1, 1], False, it)
                check(f"{tag} ties, ones cotangent vs torch (max abs)",
                      max_abs(tied, ref), 0.0)
            tk = event_ms(lambda: mp._launch(x, y, dy, k, s, p))
            tp = event_ms(lambda: mp.max_pool3d_bwd_plain(x, y, dy, k, s, p))
            tl = event_ms(lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                dy, x, list(k), list(s), list(p), [1, 1, 1], False, idx))
            # what the function needs: read x, y and dy, write dx
            bm, by = bound(2 * (x.numel() + y.numel()) * x.element_size(), 0, dn)
            plan = mp.bwd_plan(x.shape, k, s, p, dt)
            rows.append((tag, tk, tp, tl, bm, by, plan))
            if dn == "bf16":
                for key, v in zip(("ms", "plain_ms", "library_ms", "bound_ms"),
                                  (tk, tp, tl, bm)):
                    sums[kn][key] += v
            del x, y, idx, dy, dx_k, dx_p, dx_l
    for tag, tk, tp, tl, bm, by, plan in rows:
        print(f"  {tag}: kernel {tk:.4f} ms  plain {tp:.4f} ms  torch {tl:.4f} ms  "
              f"bound {bm:.4f} ms ({by})  [{plan.slab} slabs, {plan.group}-channel "
              f"groups, {plan.smem_bytes} B shared memory per block, {plan.blocks} "
              f"blocks of {plan.threads} threads]")
    geoms = sorted({(k, s, p) for _, _, _, k, s, p in POOLS})
    for (k, s, p), shape, (dn, dt) in itertools.product(geoms, POOL_RAGGED,
                                                         DTYPES.items()):
        shape = shape[:4] + (shape[4] or (12 if dn == "bf16" else 6),)
        if shape[1] + 2 * p[0] < k[0]:
            continue
        kn = "K3" if s == (1, 1, 1) else "K4"
        x = _ncdhw(shape, dev, dt, g)
        y = F.max_pool3d(x, k, s, p).contiguous(memory_format=CL)
        dy = torch.randn(y.shape, device=dev, generator=g).to(dt).contiguous(
            memory_format=CL)
        err = max_abs(mp._launch(x, y, dy, k, s, p), mp.max_pool3d_bwd_plain(x, y, dy, k, s, p))
        check(f"{kn} k{k} s{s} p{p} {shape} {dn} vs plain (max abs)", err, 0.0)
        worst[kn] = max(worst[kn], err)
    # every pool of the 16x224x224 and 16x112x112 steps at bs 32, exact; the
    # slabs above one block's shared memory run in strips of dx rows with
    # halos
    print("  K3/K4 at 16x224x224 and 16x112x112, bs 32 (strips where a slab exceeds a "
          "block):")
    for name, kn, shape, k, s, p in POOLS_224 + POOLS_112_32:
        for dn, dt in DTYPES.items():
            x = _ncdhw(shape, dev, dt, g)
            y = F.max_pool3d(x, k, s, p).contiguous(memory_format=CL)
            dy = torch.randn(y.shape, device=dev, generator=g).to(dt).contiguous(
                memory_format=CL)
            plan = mp.bwd_plan(x.shape, k, s, p, dt)
            strips = plan.t_strips * plan.h_strips
            tag = (f"{kn} {name} {shape} {dn} [{strips} strip(s) of {plan.t_strip} frames x "
                   f"{plan.h_strip} rows, {plan.blocks} blocks, {plan.smem_bytes} B]")
            err = max_abs(mp._launch(x, y, dy, k, s, p), mp.max_pool3d_bwd_plain(x, y, dy, k, s, p))
            check(f"{tag} vs plain (max abs)", err, 0.0)
            worst[kn] = max(worst[kn], err)
            if dn == "bf16" and strips > 1:
                idx = F.max_pool3d(x, k, s, p, return_indices=True)[1]
                tk = event_ms(lambda: mp._launch(x, y, dy, k, s, p))
                tl = event_ms(lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                    dy, x, list(k), list(s), list(p), [1, 1, 1], False, idx))
                bm, by = bound(2 * (x.numel() + y.numel()) * x.element_size(), 0, dn)
                print(f"  {kn} {name} {shape} bf16 in strips: kernel {tk:.4f} ms  torch "
                      f"{tl:.4f} ms  bound {bm:.4f} ms ({by})")
                del idx
            del x, y, dy
    src = "video_graph_ssl_tpu_torch/csrc/maxpool_bwd.cu"
    return [{"name": "maxpool_bwd_s1", "route": "cuda", "source": src,
             "replaces": "video_graph_ssl_tpu/ops/pallas/maxpool_kernel.py:130",
             "max_abs_err": worst["K3"], "bound_by": "bytes", **sums["K3"]},
            {"name": "maxpool_bwd_strided", "route": "cuda", "source": src,
             "replaces": "video_graph_ssl_tpu/ops/pallas/maxpool_kernel.py:259",
             "max_abs_err": worst["K4"], "bound_by": "bytes", **sums["K4"]},
            pool_fwd_checks(dev, g)]


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of ``a`` whose bits differ from ``b``'s, counting NaN as
    one value: NaN where ``b`` has NaN, every other value bit for bit (the
    sign of a tied zero included)."""
    a, b = a.contiguous(), b.contiguous()
    nan = torch.isnan(b)
    itype = torch.int16 if b.dtype == torch.bfloat16 else torch.int32
    return int((torch.isnan(a) != nan).sum()) + int(
        (a.view(itype)[~nan] != b.view(itype)[~nan]).sum())


def pool_fwd_bits(dev, g, shape, k, s, p, dn: str) -> tuple:
    """The pool forward kernel, through its operator, against the library
    (``maxpool.pool_forward``) at one pool (x (B, T, H, W, C) ``shape``): x
    with a few NaNs in ``dn``, and in bf16 tie-rich x (-1, -0, +0, 1) too.
    Returns (elements whose bits differ, x, the (lo, hi) pads, the flat
    pads)."""
    from video_graph_ssl_tpu_torch.ops import maxpool as mp

    dt = DTYPES[dn]
    x = _ncdhw(shape, dev, dt, g)
    x.as_strided((x.numel(),), (1,))[torch.randint(
        0, x.numel(), (max(1, x.numel() // 4096),), device=dev,
        generator=g)] = float("nan")
    pads = mp.resolve_padding(p, x.shape[2:], k, s)
    flat = [v for pair in pads for v in pair]
    n = bits_differ(mp.max_pool3d_fwd_op(x, k, s, flat), mp.pool_forward(x, k, s, pads))
    if dn == "bf16":
        levels = torch.tensor([-1.0, -0.0, 0.0, 1.0], device=dev)
        xt = _ncdhw(shape, dev, dt, g, fill=lambda sh: levels[torch.randint(
            0, 4, sh, device=dev, generator=g)])
        n += bits_differ(mp.max_pool3d_fwd_op(xt, k, s, flat), mp.pool_forward(xt, k, s, pads))
    return n, x, pads, flat


def pool_fwd_checks(dev, g) -> dict:
    """The pool forward kernel, through its operator, against the library
    (``maxpool.pool_forward``) at every pool geometry the card drives (S3D's
    at bs 256, 128 and 32, 16x112x112 and 16x224x224; I3D's TF "SAME"
    pools; I3D-R50-NL's two at bs 256 and 128): x with a few NaNs in fp32 and
    bf16, and tie-rich bf16 x (-1, -0, +0, 1), bit for bit (NaN where the
    library has NaN); device ms per pool at the bs-128 S3D pass and the
    I3D-R50-NL pools against the library and the byte bound (x read once, y
    written once)."""
    from video_graph_ssl_tpu_torch.kernel_times import I3DNON
    from video_graph_ssl_tpu_torch.ops import maxpool as mp

    print("phase 4 (fwd): the max-pool forward kernel vs the library (bit for bit)")
    timed = {"S3D": POOLS, I3DNON: geometry(112, 128, I3DNON)[2]}
    sets = {**timed, "S3D bs256": geometry(112, 256, "S3D")[2],
            f"{I3DNON} bs256": geometry(112, 256, I3DNON)[2],
            "S3D 224 bs32": POOLS_224, "S3D 112 bs32": POOLS_112_32,
            "I3D": geometry(112, 128, "I3D")[2], "I3D 224 bs32": geometry(224, 32, "I3D")[2],
            f"{I3DNON} 224 bs32": geometry(224, 32, I3DNON)[2]}
    sums = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    worst = 0
    for label, pools in sets.items():
        for name, _, shape, k, s, p in pools:
            for dn, dt in DTYPES.items():
                n, x, pads, flat = pool_fwd_bits(dev, g, shape, k, s, p, dn)
                check(f"fwd {label} {name} {shape} {dn} vs library (bits differing)", n, 0)
                worst = max(worst, n)
                if dn == "bf16" and label in timed:
                    b, c = shape[0], shape[4]
                    y_numel = b * c * math.prod(mp.out_sizes(x.shape[2:], k, s, pads))
                    tk = event_ms(lambda: mp.max_pool3d_fwd_op(x, k, s, flat))
                    tl = event_ms(lambda: mp.pool_forward(x, k, s, pads))
                    bm, _ = bound((x.numel() + y_numel) * x.element_size(), 0, dn)
                    plan = mp.fwd_plan(x.shape, k, s, p, dt)
                    print(f"  fwd {label} {name} {shape} bf16: kernel {tk:.4f} ms  library "
                          f"{tl:.4f} ms  bound {bm:.4f} ms ({100 * bm / tk:.1f}%)  [{plan.slab} "
                          f"slabs, strips {plan.t_strip}x{plan.h_strip} of y, {plan.group}-"
                          f"channel groups, {plan.smem_bytes} B, {plan.blocks} blocks]")
                    if label == "S3D":
                        for key, v in zip(sums, (tk, tl, tl, bm)):
                            sums[key] += v
                del x
    print(f"  fwd S3D pass (13 pools, bs 128, bf16): kernel {sums['ms']:.4f} ms  library "
          f"{sums['library_ms']:.4f} ms  bound {sums['bound_ms']:.4f} ms")
    # the plain version of the forward is the library's pool itself
    return {"name": "maxpool_fwd", "route": "cuda",
            "source": "video_graph_ssl_tpu_torch/csrc/maxpool_fwd.cu",
            "replaces": "video_graph_ssl_tpu/ops/pallas/maxpool_kernel.py:59 (never launched "
                        "there)", "max_abs_err": float(worst), "bound_by": "bytes", **sums}


def _sep_bound(bthwc, dn):
    """Six conv-sized products (y1, y2, da, dx, dWt, dWs) against reading x
    and g and writing dx."""
    b, t, h, w, c, f = bthwc
    rows = b * t * h * w
    flops = 3 * 2 * rows * 9 * c * f + 3 * 2 * rows * 3 * f * f
    isz = 2 if dn == "bf16" else 4
    nbytes = rows * (2 * c + f) * isz + (9 * c * f + 3 * f * f) * (isz + 4)
    return bound(nbytes, flops, dn)


def _sep_plan_str(p) -> str:
    """One line of a K5 launch plan (ops/sepconv_bwd.py:plan)."""
    if p.route == "simt":
        return "simt, 64x64x16 fp32 tiles"
    p1, p5 = p.product("P1 y1"), p.product("P5 dx")
    wg = ", ".join(f"{q.name.split()[1]} {q.tile[0]}x{q.tile[1]}x{q.shared_taps} taps, "
                   f"{q.splits} splits" for q in (p.product("P4 dWt"), p.product("P6 dWs")))
    return (f"tc, conv 128x{p1.tile[1]} (F) / 128x{p5.tile[1]} (C), "
            f"{p1.smem_bytes}/{p5.smem_bytes} B smem, {p.mtiles} row tiles; {wg}")


def _unfused_bwd(args, dev):
    """The pair's backward through the path the default step runs: autograd
    of SepConv3d(fused_bwd=False) (cuDNN conv + BN) with the same weights,
    input and cotangent; returns a function that runs it once."""
    from video_graph_ssl_tpu_torch.models.layers import SepConv3d

    x, ws, wt, g1, b1, g2, b2, _, _, _, _, gy, dt = args
    f, c = ws.shape[:2]
    m = SepConv3d(c, f, 3, 1, 1, dtype=dt).to(dev).train()
    with torch.no_grad():
        for prm, v in zip((m.conv_s.weight, m.conv_t.weight, m.bn_s.weight, m.bn_s.bias,
                           m.bn_t.weight, m.bn_t.bias), (ws, wt, g1, b1, g2, b2)):
            prm.copy_(v)
    xr = x.detach().requires_grad_()
    out = m(xr)
    leaves = [xr, *m.parameters()]
    return lambda: torch.autograd.grad(out, leaves, gy, retain_graph=True)


def phase_k5(dev) -> dict:
    from video_graph_ssl_tpu_torch.ops import fused_sepconv as fs
    from video_graph_ssl_tpu_torch.ops import sepconv_bwd as sb

    print("phase 5: K5 SepConv pair backward vs plain (cudnn.allow_tf32 False)")
    g = torch.Generator(device=dev).manual_seed(3)
    names = ["dx", "dWs", "dWt", "dg1", "db1", "dg2", "db2"]
    by_name = {n: (bthw, c, f) for n, bthw, c, f in SEPCONVS + [K5_SMALL, K5_ALIGNED]}
    worst = 0.0
    for name in K5_CHECKS + [K5_SMALL[0], K5_ALIGNED[0]]:
        bthw, c, f = by_name[name]
        for dn, dt in DTYPES.items():
            args = sepconv_inputs((*bthw, c, f), dev, dt, g)
            route = sb.plan(*bthw, c, f, dt).route
            got = sb.sepconv_bwd(*args)
            want = fs.bwd_reference(*args)
            for n, a, r in zip(names, got, want):
                tag = f"K5 {name} {bthw} {c}->{f} {dn} ({route}) {n}"
                worst = max(worst, max_abs(a, r))
                mx = float((a.float() - r.float()).abs().max()
                           / r.float().abs().max().clamp_min(1e-30))
                print(f"  {tag}: max rel {mx:.3e}")
                check(f"{tag} (rel-L2)", rel_l2(a, r), TOL_K5[dn])
                if name == K5_SMALL[0] and dn == "fp32":
                    check(f"{tag} (max rel)", mx, TOL_K5_SMALL)
            del args, got, want
    # the 18 pairs of the 16x112x112 step at bs 32: other row-tile counts and
    # wgrad row splits than the bs-128 step's
    for name, bthw, c, f in SEPCONVS_112_32:
        for dn, dt in DTYPES.items():
            args = sepconv_inputs((*bthw, c, f), dev, dt, g)
            plan = _sep_plan_str(sb.plan(*bthw, c, f, dt))
            got = sb.sepconv_bwd(*args)
            want = fs.bwd_reference(*args)
            errs = [rel_l2(a, r) for a, r in zip(got, want)]
            print(f"  K5 {name} {bthw} {c}->{f} {dn} [{plan}]: rel-L2 "
                  + " ".join(f"{n} {e:.2e}" for n, e in zip(names, errs)))
            for n, a, r, e in zip(names, got, want, errs):
                worst = max(worst, max_abs(a, r))
                check(f"K5 {name} {bthw} {c}->{f} {dn} {n} (rel-L2)", e, TOL_K5[dn])
            del args, got, want
    for name in K5_DETERMINISM:
        bthw, c, f = by_name[name]
        for dn, dt in DTYPES.items():
            args = sepconv_inputs((*bthw, c, f), dev, dt, g)
            first, second = sb.sepconv_bwd(*args), sb.sepconv_bwd(*args)
            same = all(torch.equal(a, b) for a, b in zip(first, second))
            route = sb.plan(*bthw, c, f, dt).route
            print(f"  K5 {name} {dn} ({route}): two calls bit-equal: {same}")
            if not same:
                raise RuntimeError(f"K5 {name} {dn}: two calls differ")
            del args, first, second
    rows, sums, bys = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, unfused_ms=0.0), set()
    # the kernels' device time per pass, the staged call (the wrapper) and
    # the one call of all three stages: here, before any process group,
    # since torch.profiler drops device events after those phases
    dev_ms = {"staged": 0.0, "one call": 0.0}
    for name, bthw, c, f in SEPCONVS:
        args = sepconv_inputs((*bthw, c, f), dev, torch.bfloat16, g)
        unfused = _unfused_bwd(args, dev)
        tk = event_ms(lambda: sb.sepconv_bwd(*args), iters=10)
        for key, fn in (("staged", sb.sepconv_bwd), ("one call", sb.sepconv_bwd_one_call)):
            dev_ms[key] += device_us(lambda: fn(*args), PATTERNS["K5"], iters=10) / 1e3
        tp = event_ms(lambda: fs.bwd_reference(*args), iters=10)
        tu = event_ms(unfused, iters=10)
        bm, by = _sep_bound((*bthw, c, f), "bf16")
        rows.append((name, bthw, c, f, tk, tp, tu, bm, by,
                     _sep_plan_str(sb.plan(*bthw, c, f, torch.bfloat16))))
        for key, v in zip(("ms", "plain_ms", "unfused_ms", "bound_ms"), (tk, tp, tu, bm)):
            sums[key] += v
        bys.add(by)
        del args, unfused
    for name, bthw, c, f, tk, tp, tu, bm, by, plan in rows:
        print(f"  K5 {name} {bthw} {c}->{f} bf16: kernel {tk:.4f} ms  plain {tp:.3f} ms  "
              f"unfused {tu:.4f} ms  bound {bm:.4f} ms ({by})  library: no single call  "
              f"[{plan}]")
    print(f"  K5 all 18 SepConvs of a pass, bf16: kernel {sums['ms']:.3f} ms  "
          f"plain {sums['plain_ms']:.2f} ms  unfused {sums['unfused_ms']:.3f} ms  "
          f"bound {sums['bound_ms']:.3f} ms")
    print(f"  K5 all 18 SepConvs of a pass, bf16, device (torch.profiler, mean of 10 "
          f"calls per pair): staged {dev_ms['staged']:.3f} ms, one call "
          f"{dev_ms['one call']:.3f} ms")
    # the wrapper's host time: 100 calls at 5b b2 without a sync
    name, bthw, c, f = next(r for r in SEPCONVS if r[0] == "5b b2")
    args = sepconv_inputs((*bthw, c, f), dev, torch.bfloat16, g)
    for _ in range(3):
        sb.sepconv_bwd(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        sb.sepconv_bwd(*args)
    host_us = (time.perf_counter() - t0) * 1e4
    torch.cuda.synchronize()
    print(f"  K5 wrapper host time per call at {name} {bthw} {c}->{f} bf16: {host_us:.1f} us "
          "(100 calls, no sync)")
    del args
    sums.pop("unfused_ms")
    return {"name": "sepconv_bwd", "route": "cuda",
            "source": "video_graph_ssl_tpu_torch/csrc/sepconv_bwd.cu",
            "replaces": "video_graph_ssl_tpu/ops/pallas/sepconv_bwd.py:307 and "
                        "video_graph_ssl_tpu/ops/pallas/sepconv_bwd_grid.py:314",
            "max_abs_err": worst, "bound_by": _bound_by(bys), "library_ms": None,
            **sums}

# --------------------------------------------------------------------------- #
def small_step_parity(dev, fused: bool, backbone: str = "S3D", opts=(),
                      size: int = 64) -> None:
    """One MoCo step of a small ``backbone``+graph model (its default graph
    blocks, none for a 2D backbone; fp32; sampler none; TPU.SEPCONV_FUSED
    as given; ``opts``) on 4 clips of 16 x size x size from one initial
    state and one batch: the card (kernels) against the CPU (plain
    versions)."""
    from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
    from video_graph_ssl_tpu_torch.engine.pretrain import make_moco_step
    from video_graph_ssl_tpu_torch.models.build import create_visual_model
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    print(f"  small {backbone}+graph MoCo step (4x16x{size}x{size}, fp32, SEPCONV_FUSED "
          f"{fused}), card vs CPU")
    c = load_config(CONFIG, [
        "MODEL.BACKBONE", backbone, "MODEL.AUG_FLAG", "True", "GRAPH.SAMPLER", "none",
        "TPU.COMPUTE_DTYPE", "float32", "CONTRAST.NCE_K", "64",
        "CONTRAST.NCE_T", "1.0", "TPU.SEPCONV_FUSED", str(fused), *opts])
    clips = torch.randn(4, 2, 16, size, size, 3,
                        generator=torch.Generator().manual_seed(3))
    runs = {}
    for name, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
        model, _ = create_visual_model(c)
        state = create_pretrain_state(c, model, d)
        p0 = [p.detach().cpu().double() for p in state.model.parameters()]
        step = make_moco_step(float(c.CONTRAST.NCE_T), float(c.CONTRAST.ALPHA))
        loss = float(step(state, clips.to(d), 0.06)["loss"])
        delta = torch.cat([(p.detach().cpu().double() - q).flatten()
                           for p, q in zip(state.model.parameters(), p0)])
        runs[name] = (loss, state.contrast.queue.cpu(), delta)
    (lc, qc, dc), (lg, qg, dg) = runs["cpu"], runs["gpu"]
    tag = f"slice small ({backbone}, fused {fused})"
    check(f"{tag}: loss", abs(lc - lg) / max(1.0, abs(lc)), 1e-4)
    # Train-mode BN over 4 clips amplifies rounding in the deep stages: the
    # keys of fp32 and fp64 runs on the CPU already differ by 8e-5.
    check(f"{tag}: queue (keys of the EMA pass)", rel_err(qg, qc), 1e-3)
    # At init the features of all clips nearly coincide, so the gradient
    # through the L2 normalisation cancels: fp32 against fp64 on the CPU
    # already differs by 3e-2 (rel-L2 of the whole update).
    check(f"{tag}: parameter update (rel-L2)",
          float((dg - dc).norm() / dc.norm()), 1e-1)


def _kernel_modules():
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.ops import maxpool as mp
    from video_graph_ssl_tpu_torch.ops import sepconv_bwd as sb
    return gk, gp, mp, sb


def reset_counts() -> None:
    tracing.reset_counters()


def read_counts() -> dict:
    """Each kernel's wrapper calls since :func:`reset_counts`."""
    n = tracing.counters()
    return {k: n[k] for k in ("graph_adjacency", "gcn_propagate", "maxpool_bwd_s1",
                              "maxpool_bwd_strided", "sepconv_bwd", "maxpool_fwd")}


def run_trainer(dev, gpu: str, fused: bool, bsz: int = 128, size: int = 112,
                backbone: str = "S3D", save: bool = False, opts=()) -> dict:
    """5 trainer steps at full ``backbone`` width (2 warm-up, 3 timed), bs
    ``bsz``, 16 x size x size (224: INPUT.BASE_SIZE [224, 224], SCALE_SIZE
    [256, 256]) from synthetic clips through the Loader, with config
    overrides ``opts``; returns the launch
    counts of exactly those steps (``counts``), the mean ms of the timed
    steps (``ms``), the peak memory (``peak_gib``) and, with ``save``, the
    path of a checkpoint that the trainer's Saver writes after the steps
    (``ckpt``)."""
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config

    _, _, mp, sb = _kernel_modules()
    print(f"  trainer at full {backbone} width, bs {bsz}, 16x{size}x{size}, "
          f"SEPCONV_FUSED {fused}")
    frames = [] if size == 112 else ["INPUT.BASE_SIZE", f"[{size}, {size}]",
                                     "INPUT.SCALE_SIZE", f"[{size * 8 // 7}, {size * 8 // 7}]"]
    c = load_config(CONFIG, ["MODEL.BACKBONE", backbone, "MODEL.AUG_FLAG", "True",
                             "DATASET.SOURCE", "synthetic", "DATALOADER.BATCH_SIZE", str(bsz),
                             "TPU.SEPCONV_FUSED", str(fused)] + frames + list(opts))
    if list(c.INPUT.BASE_SIZE) != [size, size]:
        raise RuntimeError(f"INPUT.BASE_SIZE {c.INPUT.BASE_SIZE}, want {size}")
    if int(c.CONTRAST.NCE_K) != 16384 or c.TPU.COMPUTE_DTYPE != "bfloat16":
        raise RuntimeError("configs/visual_moco.yaml no longer gives NCE_K 16384 "
                           "with bf16 compute")
    trainer = Trainer(c, max_steps=5, device=str(dev), run_dir=RUN_DIR)
    t0 = time.perf_counter()
    epoch = trainer.train_loader.epoch(0)
    batches = [trainer.to_device(bt) for bt in itertools.islice(epoch, 5)]
    epoch.close()
    print(f"  5 synthetic batches made in {time.perf_counter() - t0:.1f} s")
    lr = trainer.lr_fn(0)
    state = trainer.state
    # record the shapes the kernels see, to hold them to the tables above
    seen_pools, seen_seps = set(), set()
    pool_launch, sep_launch = mp._launch, sb.sepconv_bwd

    def pool_rec(x, y, dy, k, s, p):
        b, cc, t, h, w = x.shape
        seen_pools.add(pool_key((b, t, h, w, cc), k, s, p))
        return pool_launch(x, y, dy, k, s, p)

    def sep_rec(x, ws, *rest):
        b, cc, t, h, w = x.shape
        seen_seps.add(((b, t, h, w), cc, ws.shape[0]))
        return sep_launch(x, ws, *rest)

    mp._launch, sb.sepconv_bwd = pool_rec, sep_rec
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        step_ms, losses, ptrs = [], [], []
        for clips in batches:
            ptr0 = state.contrast.ptr
            t0 = time.perf_counter()
            metrics = trainer.train_step(clips, lr)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            ptrs.append((ptr0, state.contrast.ptr))
        counts = read_counts()
        n = tracing.counters()
        copies = (n["maxpool_dy_copies"], n["sepconv_g_copies"])
        tc_calls = n["sepconv_bwd_tc"]
        stem_calls = n["stem_conv_fwd"]
    finally:
        mp._launch, sb.sepconv_bwd = pool_launch, sep_launch
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (ms, loss) in enumerate(zip(step_ms, losses)):
        print(f"  step {i} ({'warm-up' if i < 2 else 'timed'}): {ms:.1f} ms, loss {loss:.4f}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    K = int(c.CONTRAST.NCE_K)
    for p0, p1 in ptrs:
        if p1 != (p0 + bsz) % K:
            raise RuntimeError(f"queue pointer {p0} -> {p1}, want +{bsz}")
    diff = max(float((e - p).detach().abs().max()) for e, p in zip(
        state.ema_model.parameters(), state.model.parameters()))
    if not diff > 0.0:
        raise RuntimeError("EMA params equal the params after 5 steps")
    print(f"  EMA vs params max |diff| {diff:.3e}; queue ptr {state.contrast.ptr}")
    n = len(batches)
    # K3/K4/K5 run in the query pass's backward only (the key pass takes no
    # gradient)
    want = _want_counts(n, fused=fused, backbone=backbone, remat=bool(c.TPU.REMAT))
    print(f"  kernel calls in the 5 steps: {counts} (want {want})")
    print(f"  cotangents copied to channels_last_3d in the 5 steps: pool dy "
          f"{copies[0]}, SepConv g {copies[1]}")
    print(f"  K5 calls on the tensor-core route: {tc_calls} (want {want['sepconv_bwd']})")
    print(f"  stem convolution kernel calls: {stem_calls}")
    if counts != want:
        raise RuntimeError(f"kernel call counts {counts} != {want}")
    if tc_calls != want["sepconv_bwd"] or copies[1] != 0:
        raise RuntimeError(f"K5: {tc_calls} tensor-core calls of {want['sepconv_bwd']}, "
                           f"{copies[1]} cotangent copies (want 0)")
    want_pools = {pool_key(shape, k, s, p)
                  for _, _, shape, k, s, p in geometry(size, bsz, backbone)[2]}
    if seen_pools != want_pools:
        raise RuntimeError(f"pool shapes {sorted(seen_pools)} != {sorted(want_pools)}")
    want_seps = {(bthw, c_, f) for _, bthw, c_, f in SEPCONVS} if fused else set()
    if seen_seps != want_seps:
        raise RuntimeError(f"SepConv shapes {sorted(seen_seps)} != {sorted(want_seps)}")
    timed = step_ms[2:]
    mean_ms = sum(timed) / len(timed)
    from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug
    graph_blocks = sum(isinstance(m, TemporalGraphAug) for m in state.model.modules())
    nonlocal_blocks = sum(type(m).__name__ == "NonLocalBlock3D" for m in state.model.modules())
    print(f"slice ({backbone}, SEPCONV_FUSED {fused}, 16x{size}x{size}): {mean_ms:.1f} "
          f"ms/step, {bsz / mean_ms * 1e3:.1f} clips/s (mean of 3 timed steps, bs {bsz}, "
          f"peak {peak:.1f} GiB) on {gpu}")
    ckpt = (trainer.saver.save_checkpoint(state, 1, filename="checkpoint_1.pth.tar")
            if save else None)
    del trainer, state, batches, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "ms": mean_ms, "peak_gib": peak, "ckpt": ckpt,
            "graph_blocks": graph_blocks, "nonlocal_blocks": nonlocal_blocks,
            "steps": n, "stem_calls": stem_calls}


def phase_slice(dev, gpu: str) -> dict:
    """The default GCA step, then the TPU.SEPCONV_FUSED step, then the
    default step at 16x224x224; each kernel's count comes from the 112x112
    run of the path that uses it (the stems' kernel: S3D's one stem in each
    of MoCo's two passes)."""
    print("phase 6a: the GCA step")
    small_step_parity(dev, fused=False)
    run = run_trainer(dev, gpu, fused=False)
    counts, synthetic_ms = run["counts"], run["ms"]
    want_stems = REGIME_PASSES["moco"][0] * run["steps"]
    if run["stem_calls"] != want_stems:
        raise RuntimeError(f"stem convolution kernel calls {run['stem_calls']} != {want_stems}")
    counts["stem_conv_fwd"] = run["stem_calls"]
    print("phase 6b: the GCA step with TPU.SEPCONV_FUSED True")
    small_step_parity(dev, fused=True)
    counts["sepconv_bwd"] = run_trainer(dev, gpu, fused=True)["counts"]["sepconv_bwd"]
    print("phase 6c: the GCA step at 16x224x224, bs 32 (K3/K4 in strips)")
    big = run_trainer(dev, gpu, fused=False, bsz=32, size=224)["counts"]
    if not all(big[n] > 0 for n in ("graph_adjacency", "gcn_propagate", "maxpool_bwd_s1",
                                    "maxpool_bwd_strided")):
        raise RuntimeError(f"224x224 step: a kernel was not launched: {big}")
    return counts, synthetic_ms


# --------------------------------------------------------------------------- #
# phase 7: a shard store of STORE_VIDEOS videos of STORE_FRAMES frames at the
# 128x128 canvas (1.2 GB): dense sampling at SAMPLE_RATE 4 takes 64 frames,
# and three batches of 128 make an epoch, so step 3 ends one
STORE_VIDEOS, STORE_FRAMES, CANVAS = 384, 64, 128


def write_store(root: str):
    """A shard store written by the port from a seeded frame source, and
    its split file; returns (store dir, split file)."""
    import numpy as np

    from video_graph_ssl_tpu_torch.data.shards import write_shard_store

    split = os.path.join(root, "train_split.txt")
    with open(split, "w") as f:
        for v in range(STORE_VIDEOS):
            f.write(f"video_{v:04d} {STORE_FRAMES} {v % 400}\n")

    def frame_source(directory, idx):
        v = int(os.path.basename(directory).split("_")[1])
        return np.random.default_rng((7, v, idx)).integers(
            0, 256, (CANVAS, CANVAS, 3), dtype=np.uint8)

    store = os.path.join(root, "store")
    t0 = time.perf_counter()
    meta = write_shard_store(os.path.join(root, "frames"), [split], store,
                             (CANVAS, CANVAS), frame_source=frame_source)
    size = sum(os.path.getsize(os.path.join(store, n)) for n in os.listdir(store))
    print(f"  shard store: {len(meta['videos'])} videos x {STORE_FRAMES} frames at "
          f"{CANVAS}x{CANVAS}, {meta['num_shards']} shards, {size / 2 ** 30:.2f} GiB, "
          f"written in {time.perf_counter() - t0:.1f} s")
    return store, split


def _step_lines(trainer, first: int) -> None:
    """One line per step of ``trainer.history``, numbered from ``first``."""
    for n, h in enumerate(trainer.history, start=first):
        compute = h["step"] - h["data"] - h["feed"]
        print(f"  step {n} (epoch {h['epoch']}, batch {h['i']}): {h['step'] * 1e3:.1f} ms, "
              f"data wait {h['data'] * 1e3:.1f} ms, pin + copy {h['feed'] * 1e3:.1f} ms, "
              f"rest {compute * 1e3:.1f} ms, loss {h['loss']:.4f}")


def phase_store(dev, gpu: str, synthetic_ms: float) -> None:
    """The trainer from an on-disk shard store at full S3D width: 3 steps
    (epoch 0), a checkpoint through the Saver, a second Trainer resumed from
    it (loaded state bit for bit the saved one), then 2 more steps on each
    (epoch 1), bit for bit with cudnn.deterministic."""
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config
    from video_graph_ssl_tpu_torch.utils.checkpoint import checkpoint_payload, mismatches

    print("phase 7: the GCA step trained from an on-disk shard store, checkpoint, resume")
    root = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        store, split = write_store(root)
        opts = ["MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "frames",
                "INPUT.PRE_LOAD", "shard", "DATASET.VISUAL_ROOT_DIR", store,
                "DATASET.TRAIN_SPLIT", split, "DATALOADER.BATCH_SIZE", "128",
                "CHECKPOINT.PRINT_FREQ", "1"]
        c = load_config(CONFIG, opts)
        if list(c.INPUT.SCALE_SIZE) != [CANVAS, CANVAS] or int(c.CONTRAST.NCE_K) != 16384:
            raise RuntimeError("configs/visual_moco.yaml no longer gives a 128x128 "
                               "canvas with NCE_K 16384")
        print(f"  loader: {c.DATALOADER.NUM_WORKERS} threads, prefetch {c.TPU.PREFETCH}, "
              f"sample {c.INPUT.SAMPLE_TYPE} at rate {c.INPUT.SAMPLE_RATE}, "
              f"temporal jitter {c.INPUT.TEMPORAL_JITTER}")
        run_dir = os.path.join(root, "run")
        straight = Trainer(c, max_steps=5, device="cuda", run_dir=run_dir)
        if len(straight.train_loader) != 3:
            raise RuntimeError(f"{len(straight.train_loader)} batches per epoch, want 3")
        state = straight.state
        ptr0 = state.contrast.ptr
        torch.cuda.synchronize()
        reset_counts()
        straight.train(0)
        if state.step != 3 or state.contrast.ptr != (ptr0 + 3 * 128) % 16384:
            raise RuntimeError(f"after epoch 0: step {state.step}, ptr {state.contrast.ptr}")
        ckpt = straight.saver.save_checkpoint(state, 1, filename="checkpoint_step3.pth.tar")
        saved = torch.load(ckpt, map_location=dev, weights_only=True)
        print(f"  checkpoint after step 3: {os.path.getsize(ckpt) / 2 ** 20:.1f} MiB")

        resumed = Trainer(load_config(CONFIG, opts + ["CHECKPOINT.RESUME", ckpt]),
                          max_steps=5, device="cuda", run_dir=run_dir)
        bad = mismatches(checkpoint_payload(resumed.state, 1), {
            k: v for k, v in saved.items() if k != "meta"})
        n_tensors = (len(saved["state_dict"]) + len(saved["model_ema"])
                     + len(saved["optimizer"]["state"]) + 1)
        print(f"  round trip: {n_tensors} tensors (params, buffers, EMA, momentum "
              f"buffers, queue), ptr, step, seed; {len(bad)} differ (want 0, bit for bit)")
        if bad or resumed.start_epoch != 1:
            raise RuntimeError(f"round trip: start epoch {resumed.start_epoch}, "
                               f"differs at {bad[:10]}")

        torch.backends.cudnn.deterministic = True
        try:
            straight.train(1)
            counts = read_counts()
            resumed.run()
        finally:
            torch.backends.cudnn.deterministic = False
        _step_lines(straight, 1)
        print("  resumed run:")
        _step_lines(resumed, 4)
        check_steps(straight, 5, counts)
        steps = straight.history
        timed = steps[1:3]
        mean_ms = sum(h["step"] for h in timed) / len(timed) * 1e3
        wait_ms = sum(h["data"] for h in timed) / len(timed) * 1e3
        feed_ms = sum(h["feed"] for h in timed) / len(timed) * 1e3
        print(f"slice from the shard store: {mean_ms:.1f} ms/step (steps 2-3, host "
              f"clock, data wait {wait_ms:.1f} ms/step, pin + copy {feed_ms:.1f} "
              f"ms/step) against {synthetic_ms:.1f} ms/step from device-resident "
              f"synthetic batches (phase 6a) on {gpu}")
        compare_resumed(straight, resumed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def check_steps(trainer, n: int, counts: dict) -> None:
    """Launch counts of n steps of the default step, finite losses, the
    queue pointer, EMA != params."""
    state = trainer.state
    losses = [h["loss"] for h in trainer.history]
    if len(losses) != n or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"losses {losses}, want {n} finite")
    if state.step != n or state.contrast.ptr != (n * 128) % 16384:
        raise RuntimeError(f"step {state.step}, queue ptr {state.contrast.ptr}")
    diff = max(float((e - p).detach().abs().max()) for e, p in zip(
        state.ema_model.parameters(), state.model.parameters()))
    if not diff > 0.0:
        raise RuntimeError("EMA params equal the params")
    want = _want_counts(n)
    print(f"  kernel calls in the {n} steps: {counts} (want {want}); EMA vs params "
          f"max |diff| {diff:.3e}; queue ptr {state.contrast.ptr}")
    if counts != want:
        raise RuntimeError(f"kernel call counts {counts} != {want}")


def compare_resumed(straight, resumed) -> None:
    """Steps 4-5 of the straight run against the resumed run: bit for bit
    on the whole state (params, buffers, EMA, momentum buffers, queue, ptr,
    step, seed) and on the losses; raises naming the entries that differ."""
    from video_graph_ssl_tpu_torch.utils.checkpoint import checkpoint_payload, mismatches

    a, b = (checkpoint_payload(t.state, 2) for t in (straight, resumed))
    la = [h["loss"] for h in straight.history[3:]]
    lb = [h["loss"] for h in resumed.history]
    bad = mismatches(a, b)
    print(f"  resumed vs straight, steps 4-5 (cudnn.deterministic): losses {lb} vs {la}; "
          f"{len(bad)} state entries differ (want 0, bit for bit)")
    if bad or la != lb:
        raise RuntimeError(f"resumed run differs from the straight run: losses {lb} vs "
                           f"{la}, state entries {bad}")


# --------------------------------------------------------------------------- #
# phase 8: the GCA step across ranks.  Two ranks share the one card over
# gloo (NCCL refuses two ranks on one device); NCCL runs at world size 1.
RANK_STEPS = 3
# Two ranks against one process on the same global batches, under
# cudnn.deterministic.  The one process takes its BN statistics through the
# ranks' own function (``sync_bn.sum_form_bn``, flax's E[x^2] - E[x]^2), so
# the two differ only in the order of their sums: BN's over two halves, the
# gradient as the mean of two halves', cuDNN at half the batch.  Run twice,
# the one process must repeat bit for bit, so the floor of every error is 0,
# and the ranks repeat bit for bit too.  Every error is gated, and a control
# (the same ranks with BN per rank, ``sync_bn.per_rank_bn``) must exceed at
# least one bound.  The errors (``rank_errors``): rel-L2 of the keys step i
# put in the queue (keys_i), the relative error of step i's loss (loss_i),
# rel-L2 of the parameter update after step 1 and after step 3 and the
# relative error of its norm (update_i, update_i_norm; a gradient summed
# where it should be averaged gives update_1_norm 1), and the EMA encoder's
# BN statistics (ema_bn).
# At initialisation the step amplifies rounding: the clips' features nearly
# coincide, and train-mode BN and the L2 normalisation blow up their small
# differences.  In fp32 the sums' order alone moves step 1's keys by 8.9e-5
# and its update by 2.7e-2, while per-rank BN moves them by 0.56 and 1.15;
# the bounds sit about 10x above the ranks' readings at step 1 and 3-4x at
# step 3.  In bf16 a difference in the last fp32 bit flips a bf16 rounding
# now and then, each flip 2^16 times larger than its cause, and within a few
# layers the two runs differ by bf16 rounding noise: step 1's keys by 0.165
# against per-rank BN's 0.486.  So in bf16 the keys and ema_bn bounds sit
# between the two (the control exceeds keys_1..3 and ema_bn), and the
# losses and updates, which rounding alone moves as far as per-rank BN does,
# are held only against a blow-up.  Readings on an H100 80GB HBM3 (700 W),
# ranks / control:
#   fp32 keys 8.9e-5, 4.8e-3, 8.6e-2 / 0.56, 0.55, 0.56; losses 1.6e-5,
#   2.2e-2, 4.3e-2 / 4.6e-2, 1.8e-2, 3.0e-2; update_1 2.7e-2 / 1.15,
#   update_1_norm 7.8e-3 / 0.49, update_3 0.97 / 1.27, update_3_norm 5.8e-2
#   / 0.30; ema_bn 1.3e-2 / 0.16;
#   bf16 keys 0.165, 0.265, 0.294 / 0.486, 0.518, 0.484; losses 3.3e-2,
#   1.5e-2, 9.1e-3 / 4.1e-2, 2.0e-4, 8.3e-3; update_1 1.17 / 1.10,
#   update_1_norm 0.25 / 0.40, update_3 1.23 / 1.23, update_3_norm 0.16 /
#   0.24; ema_bn 9.9e-3 / 5.4e-2.
TOL_RANKS = {
    "float32": {"keys_1": 1e-3, "keys_2": 5e-2, "keys_3": 0.3, "loss_1": 2e-4,
                "loss_2": 0.1, "loss_3": 0.15, "update_1": 0.2, "update_1_norm": 5e-2,
                "update_3": 1.5, "update_3_norm": 0.2, "ema_bn": 5e-2},
    "bfloat16": {"keys_1": 0.3, "keys_2": 0.4, "keys_3": 0.4, "loss_1": 5e-2,
                 "loss_2": 5e-2, "loss_3": 5e-2, "update_1": 2.0, "update_1_norm": 0.5,
                 "update_3": 2.0, "update_3_norm": 0.5, "ema_bn": 2.5e-2}}

SHARED = "two ranks sharing one card, gloo"


def rank_opts(bsz: int, dtype: str, shuffle: bool = False) -> list:
    return ["MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "synthetic",
            "DATALOADER.BATCH_SIZE", str(bsz), "TPU.COMPUTE_DTYPE", dtype,
            "TPU.SHUFFLE_BN", str(shuffle)]


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _stepper(trainer):
    """(feed, step) of a pretrain or a ``train_ds`` Trainer: feed(host batch)
    -> the step's device inputs, step(inputs, lr) -> metrics."""
    if hasattr(trainer, "batch_to_device"):   # train_ds: (clips, labels)
        return trainer.batch_to_device, lambda x, lr: trainer.train_step(*x, lr)
    return (lambda b: (trainer.to_device(b), trainer.index_of(b)),
            lambda x, lr: trainer.train_step(x[0], lr, x[1]))


def drive_steps(trainer, n: int = RANK_STEPS, bn_mode=None) -> dict:
    """n steps of ``trainer`` (the pretrain trainer's or ``train_ds``'s) on
    its first n batches (its rows of them under a group), the kernel counts
    read around exactly those steps; the parameters before the steps and
    after the first, and the state after them, on the CPU.  ``bn_mode``
    (``sync_bn.sum_form_bn`` or ``per_rank_bn``) is entered on the query and
    EMA models for the steps."""
    from video_graph_ssl_tpu_torch.utils.checkpoint import checkpoint_payload

    feed, step = _stepper(trainer)
    epoch = trainer.train_loader.epoch(0)
    batches = [feed(b) for b in itertools.islice(epoch, n)]
    epoch.close()
    init = _cpu(trainer.state.model.state_dict())
    lr = trainer.lr_fn(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, losses, after_1 = [], [], None
    with contextlib.ExitStack() as modes:
        if bn_mode is not None:
            for m in (trainer.state.model, trainer.state.ema_model):
                if m is not None:
                    modes.enter_context(bn_mode(m))
        for inputs in batches:
            t0 = time.perf_counter()
            metrics = step(inputs, lr)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            if after_1 is None:
                after_1 = _cpu(trainer.state.model.state_dict())
    counts = read_counts()
    return {"losses": losses, "ms": ms, "counts": counts, "init": init, "after_1": after_1,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "state": _cpu(checkpoint_payload(trainer.state, 0))}


def _want_counts(n: int = RANK_STEPS, mem_type: str = "moco", fused: bool = False,
                 remat: bool = False, **kw) -> dict:
    """Each kernel's wrapper calls in n steps of ``mem_type`` (``kw``:
    ``step_calls``'s ``partial_bn``, ``graph``, ``backbone`` and ``cmc``);
    under ``remat`` (``TPU.REMAT``) each backward recomputes its units, and
    with them the Inception blocks' branch pools (the stage pools are no
    unit)."""
    want = {k: v * n for k, v in step_calls(mem_type, fused, **kw).items()}
    if remat:
        pools_s1 = BACKBONE_CALLS[kw.get("backbone", "S3D")][1]
        want["maxpool_fwd"] += pools_s1 * REGIME_PASSES[mem_type][1] * n
    return want


def rank_run(opts: list, config: str = CONFIG, per_rank: bool = False,
             try_fused: bool = False, ssl: str = None) -> dict:
    """One run of a rank process: RANK_STEPS steps of the trainer on
    ``config`` + ``opts`` (``train_ds``'s from the pretrain checkpoint
    ``ssl`` where one is given, else the pretrain trainer's); ``per_rank``:
    the control, BN per rank; ``try_fused``: then build a
    ``TPU.SEPCONV_FUSED True`` trainer, which builds at world size 2 (phase
    15 trains it)."""
    return {"config": config, "opts": opts, "per_rank": per_rank, "try_fused": try_fused,
            "ssl": ssl}


def make_trainer(run: dict, device: str, run_dir: str):
    """The trainer of a ``rank_run``: ``train_ds``'s when it names an
    ``ssl`` checkpoint, else the pretrain trainer."""
    from video_graph_ssl_tpu_torch import train_ds
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config

    c = load_config(run["config"], run["opts"])
    if run["ssl"] is not None:
        return train_ds.Trainer(c, ssl_checkpoint=run["ssl"], max_steps=RANK_STEPS,
                                device=device, run_dir=run_dir)
    return Trainer(c, max_steps=RANK_STEPS, device=device, run_dir=run_dir)


def _rank_main(rank: int, world: int, backend: str, init: str, out: str, runs: list,
               run_dir: str) -> None:
    """One rank of phase 8, 9 (d), 12 or 15, in its own process (on cuda:0
    over gloo, on cuda:rank over NCCL): each of ``runs`` in turn, each a
    ``rank_run`` on a new trainer, ``{"eval_tools": (best, ssl, dtype)}``
    for phase 12 (c)'s ``eval_tools``, or ``{"k5_pairs": dtype}`` for phase
    15 (b)'s ``k5_rank_pairs``."""
    from video_graph_ssl_tpu_torch.parallel import dist, sync_bn
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = f"cuda:{rank if backend == 'nccl' else 0}"
    torch.cuda.set_device(device)
    dist.init_distributed(backend, init, world, rank)
    try:
        results = []
        for run in runs:
            if "eval_tools" in run:
                results.append(eval_tools(device, run_dir, f"rank{rank}", *run["eval_tools"]))
                continue
            if "k5_pairs" in run:
                results.append(k5_rank_pairs(device, rank, world, run["k5_pairs"]))
                continue
            trainer = make_trainer(run, device, run_dir)
            res = drive_steps(trainer,
                              bn_mode=sync_bn.per_rank_bn if run["per_rank"] else None)
            res["rows"] = trainer.batch_slice
            res["ddp"] = trainer.state.ddp is not None
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            if run["try_fused"]:   # 8 (d): the fused step at world size 2 builds
                res["fused_error"] = None
                try:
                    fused = Trainer(load_config(run["config"],
                                                run["opts"] + ["TPU.SEPCONV_FUSED", "True"]),
                                    device=device, run_dir=run_dir)
                    del fused
                except NotImplementedError as e:
                    res["fused_error"] = str(e)
            results.append(res)
        torch.save(results, out)
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(runs: list, world: int = 2, backend: str = "gloo", target=None) -> list:
    """``world`` rank processes (gloo: all on cuda:0; NCCL: one per card),
    each making ``runs`` in turn (``target``: the rank's function,
    ``_rank_main`` by default); for each run, the ranks' results."""
    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="ranks_", dir=RUN_DIR)
    init = "file://" + os.path.join(work, "rendezvous")
    outs = [os.path.join(work, f"rank{r}.pt") for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target or _rank_main,
                         args=(r, world, backend, init, outs[r], runs, RUN_DIR))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"rank processes exited with {codes}")
    print(f"  {world} rank processes ({backend}), {len(runs)} run(s) each: "
          f"{time.perf_counter() - t0:.1f} s from spawn to exit")
    per_rank = [torch.load(o, weights_only=False) for o in outs]
    return [list(ranks) for ranks in zip(*per_rank)]


def _update(res, after: str = "state") -> torch.Tensor:
    sd = res["after_1"] if after == "after_1" else res["state"]["state_dict"]
    return torch.cat([(sd[k].double() - v.double()).flatten() for k, v in res["init"].items()
                      if v.is_floating_point() and "running" not in k])


def hold_ranks(tag: str, ranks: list, gpu: str, layout: str, want: dict = None) -> None:
    """All ranks: bit-equal states and losses, K1-K4 launched at the step's
    counts (``want``, default the MoCo step's); their step host times and
    peak memory."""
    from video_graph_ssl_tpu_torch.utils.checkpoint import mismatches

    want = want or _want_counts()
    for r in range(1, len(ranks)):
        bad = mismatches(ranks[0]["state"], ranks[r]["state"])
        print(f"  {tag}: rank 0 vs rank {r} state: {len(bad)} entries differ (want 0, bit "
              f"for bit); losses {ranks[0]['losses']} / {ranks[r]['losses']}")
        if bad or ranks[0]["losses"] != ranks[r]["losses"]:
            raise RuntimeError(f"{tag}: ranks 0 and {r} differ at {bad[:10]}")
    for r, res in enumerate(ranks):
        print(f"  {tag}: rank {r} rows {res['rows']}, DDP {res['ddp']}: kernel calls "
              f"{res['counts']}; step host ms {[round(x, 1) for x in res['ms']]} ({layout}); "
              f"max_memory_allocated {res['peak_gib']:.2f} GiB on {gpu}")
        if res["counts"] != want:
            raise RuntimeError(f"{tag}: rank {r} kernel calls {res['counts']} != {want}")
        if not all(math.isfinite(x) for x in res["losses"]):
            raise RuntimeError(f"{tag}: non-finite loss {res['losses']}")


def rank_errors(got: dict, ref: dict, bsz: int) -> dict:
    """Errors of ``got`` against ``ref``, one process's run on the same
    global batches: rel-L2 of the keys each step put in the queue, the
    relative error of each step's loss, rel-L2 of the parameter update after
    step 1 and after the last step and the relative error of its norm, and
    the largest rel-L2 of the EMA encoder's BN statistics."""
    def keys(res, i):   # CMC: both streams' keys, queue_1's rows then queue_2's
        c = res["state"]["contrast"]
        return torch.cat([c[q][i * bsz:(i + 1) * bsz]
                          for q in ("queue", "queue_1", "queue_2") if q in c])

    errs = {f"keys_{i + 1}": rel_l2(keys(got, i), keys(ref, i)) for i in range(RANK_STEPS)}
    errs.update({f"loss_{i + 1}": abs(a - b) / abs(b)
                 for i, (a, b) in enumerate(zip(got["losses"], ref["losses"]))})
    for step, after in ((1, "after_1"), (RANK_STEPS, "state")):
        u, v = _update(got, after), _update(ref, after)
        errs[f"update_{step}"] = rel_l2(u, v)
        errs[f"update_{step}_norm"] = abs(float(u.norm() / v.norm()) - 1.0)
    errs["ema_bn"] = max(rel_l2(v, ref["state"]["model_ema"][k])
                         for k, v in got["state"]["model_ema"].items() if "running_" in k)
    return errs


def _over(tag: str, errs: dict, tol: dict) -> list:
    """Prints each error beside its bound; the keys above their bounds."""
    over = [k for k, err in errs.items() if not err <= tol[k]]
    for k, err in errs.items():
        print(f"  {tag}: {k:<14s} err {err:.3e}  tol {tol[k]:.2g}  "
              f"{'above' if k in over else 'within'}")
    return over


def hold_to_one_process(tag: str, ranks: list, one: dict, bsz: int, tol: dict) -> dict:
    """The ranks against one process on the same global batches: every
    error within ``tol``."""
    errs = rank_errors(ranks[0], one, bsz)
    print(f"  {tag} vs one process: losses {ranks[0]['losses']} vs {one['losses']}")
    over = _over(f"{tag} vs one process", errs, tol)
    if over:
        raise RuntimeError(f"{tag}: {over} above their bounds against one process")
    ptr = (ranks[0]["state"]["contrast"]["ptr"], one["state"]["contrast"]["ptr"])
    if ptr[0] != ptr[1] or ranks[0]["state"]["step"] != one["state"]["step"]:
        raise RuntimeError(f"{tag}: queue pointer {ptr}, step {ranks[0]['state']['step']} "
                           f"vs {one['state']['step']}")
    return errs


def control_fails(tag: str, control: list, one: dict, bsz: int, tol: dict) -> dict:
    """The control (the same ranks with BN per rank) against one process: it
    must exceed at least one of the bounds that the ranks' step meets."""
    errs = rank_errors(control[0], one, bsz)
    over = _over(f"{tag}, control with BN per rank, vs one process", errs, tol)
    if not over:
        raise RuntimeError(f"{tag}: per-rank BN meets every bound; the bounds catch nothing")
    return errs


def one_process_twice(opts: list, tag: str, gpu: str, config: str = CONFIG,
                      ssl: str = None) -> dict:
    """The one-process trainer's run of phase 8 or 12 (``rank_run``'s
    arguments) with the ranks' BN function, twice: the second run must
    repeat the first bit for bit."""
    from video_graph_ssl_tpu_torch.parallel import sync_bn
    from video_graph_ssl_tpu_torch.utils.checkpoint import mismatches

    one, again = (drive_steps(make_trainer(rank_run(opts, config, ssl=ssl), "cuda", RUN_DIR),
                              bn_mode=sync_bn.sum_form_bn) for _ in range(2))
    bad = mismatches(one["state"], again["state"])
    print(f"  {tag}: one process (sum-form BN): step host ms "
          f"{[round(x, 1) for x in one['ms']]}, max_memory_allocated {one['peak_gib']:.2f} GiB "
          f"on {gpu}; run again: {len(bad)} state entries differ (want 0, bit for bit)")
    if bad or one["losses"] != again["losses"]:
        raise RuntimeError(f"{tag}: the one-process reference does not repeat: losses "
                           f"{one['losses']} vs {again['losses']}, {bad[:10]}")
    return one


def nccl_ranks(gpu: str, opts: list, one: dict) -> dict:
    """Phase 8 (b) in bf16 at bs 128 with one rank per visible card over
    NCCL, against one process (``one``)."""
    cards = torch.cuda.device_count()
    tag = f"(b) {cards} ranks, bfloat16, global bs 128, NCCL"
    print(f"  {tag}: {128 // cards} rows per rank, one card each")
    ranks, = spawn_ranks([rank_run(opts)], cards, "nccl")
    hold_ranks(tag, ranks, gpu, f"{cards} ranks, one card each, NCCL")
    return hold_to_one_process(tag, ranks, one, 128, TOL_RANKS["bfloat16"])


def phase_ranks(dev, gpu: str) -> None:
    from video_graph_ssl_tpu_torch.parallel import dist
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import (Trainer, _free_port,
                                                                    load_config)
    from video_graph_ssl_tpu_torch.utils.checkpoint import mismatches

    print("phase 8: the GCA step across ranks")
    # (a) one rank in an NCCL group against no group, bit for bit
    print("  (a) NCCL at world size 1 against no group: bs 128, 16x112x112, bf16, "
          f"{RANK_STEPS} steps, cudnn.deterministic")
    c = load_config(CONFIG, rank_opts(128, "bfloat16"))
    torch.backends.cudnn.deterministic = True
    try:
        alone = drive_steps(Trainer(c, max_steps=RANK_STEPS, device="cuda", run_dir=RUN_DIR))
        gc.collect()
        torch.cuda.empty_cache()
        dist.init_distributed("nccl", f"tcp://localhost:{_free_port()}", 1, 0)
        try:
            trainer = Trainer(c, max_steps=RANK_STEPS, device="cuda:0", run_dir=RUN_DIR)
            if trainer.state.ddp is None or torch.distributed.get_backend() != "nccl":
                raise RuntimeError("the one-rank trainer is not in an NCCL DDP group")
            grouped = drive_steps(trainer)
            del trainer
        finally:
            torch.distributed.destroy_process_group()
        bad = mismatches(alone["state"], grouped["state"])
        print(f"  (a) losses {grouped['losses']} vs {alone['losses']}; {len(bad)} state "
              f"entries differ (want 0, bit for bit); kernel calls {grouped['counts']} vs "
              f"{alone['counts']}")
        if bad or grouped["losses"] != alone["losses"]:
            raise RuntimeError(f"NCCL world size 1 differs from no group: {bad[:10]}")
        if grouped["counts"] != alone["counts"] or alone["counts"] != _want_counts():
            raise RuntimeError(f"kernel calls {grouped['counts']} / {alone['counts']} != "
                               f"{_want_counts()}")
        del alone, grouped
        # (b) two ranks on one card against one process: fp32 at bs 32, bf16
        # at bs 128, each then with BN per rank (the control) in the same
        # rank processes; in bf16 the processes then run (c) and (d)
        errors = {}
        for dtype, bsz in (("float32", 32), ("bfloat16", 128)):
            tag = f"(b) two ranks, {dtype}, global bs {bsz}"
            print(f"  {tag}: {bsz // 2} rows per rank, 16x112x112, {RANK_STEPS} steps, "
                  "TF32 off, cudnn.deterministic")
            opts = rank_opts(bsz, dtype)
            one = one_process_twice(opts, tag, gpu)
            runs = [rank_run(opts), rank_run(opts, per_rank=True)]
            if dtype == "bfloat16":
                runs.append(rank_run(rank_opts(128, "bfloat16", shuffle=True), try_fused=True))
            ranks, control, *shuffled = spawn_ranks(runs)
            hold_ranks(tag, ranks, gpu, SHARED)
            errors[dtype] = hold_to_one_process(tag, ranks, one, bsz, TOL_RANKS[dtype])
            errors[f"{dtype} control"] = control_fails(tag, control, one, bsz,
                                                       TOL_RANKS[dtype])
            del ranks, control
        # (b) again where the host has several cards: one rank per card, NCCL
        if torch.cuda.device_count() >= 2:
            errors["bfloat16 nccl"] = nccl_ranks(gpu, opts, one)
        del one
    finally:
        torch.backends.cudnn.deterministic = False
    # (c) ShuffleBN, and (d) the fused step's trainer builds at world size 2
    tag = "(c) two ranks, ShuffleBN, bfloat16, global bs 128"
    print(f"  {tag}: 64 rows per rank, {RANK_STEPS} steps")
    ranks, = shuffled
    hold_ranks(tag, ranks, gpu, SHARED)
    for r, res in enumerate(ranks):
        msg = res["fused_error"]
        print(f"  (d) rank {r}: the TPU.SEPCONV_FUSED True trainer at world size 2 "
              f"{'builds' if msg is None else 'raised: ' + msg} (phase 15 trains it)")
        if msg is not None:
            raise RuntimeError(f"TPU.SEPCONV_FUSED True at world size 2 raised: {msg}")
    print("phase 8 errors against one process: " + json.dumps(errors))


# --------------------------------------------------------------------------- #
# phase 9: the SimSiam (GCA-S) and memory-bank regimes.  SimSiam at the
# shipped configs/visual_simsiam.yaml geometry (S3D, 16x224x224, FEAT_DIM
# 1024, bf16) at bs 32, one rank's rows of the shipped 256 over 8 ranks (two
# gradient passes of the shipped bs 256 do not fit on one card); the bank at
# the configs/visual_moco.yaml geometry (bs 128, 16x112x112) with the
# schema's NCE_K 65536 and crossentropy, over Kinetics-400's 240,000 clips:
# the synthetic source holds DATASET.NUM_CLASS x 4 clips, so NUM_CLASS 60000
# gives n_data 240,000 and a 240,000 x 128 bank.
SIMSIAM_CONFIG = os.path.join(REPO, "configs", "visual_simsiam.yaml")
KINETICS_CLIPS = 240_000
REGIMES = {
    "simsiam": (SIMSIAM_CONFIG, ["MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "synthetic",
                                 "DATALOADER.BATCH_SIZE", "32"]),
    "bank": (CONFIG, ["MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "synthetic",
                      "CONTRAST.MEM_TYPE", "bank", "CONTRAST.NCE_K", "65536",
                      "DATASET.NUM_CLASS", str(KINETICS_CLIPS // 4),
                      "DATALOADER.BATCH_SIZE", "128"]),
}


def small_regime_step(mem_type: str, d, b: int, opts: tuple = ()) -> tuple:
    """One step of ``mem_type`` on a small S3D+graph model (graph blocks at
    5, 9, 14; fp32; sampler none; ``opts`` on top) on device ``d`` from the
    seeded initial state and a seeded batch of ``b`` clips; the bank takes
    one negative draw, made on the CPU.  (loss, bank memory or None,
    parameter update, the batch's indices.)"""
    from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
    from video_graph_ssl_tpu_torch.engine.pretrain import make_bank_step, make_pretrain_step
    from video_graph_ssl_tpu_torch.models.build import create_visual_model
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    n_data, K = 64, 64
    c = load_config(CONFIG, [
        "MODEL.AUG_FLAG", "True", "GRAPH.SAMPLER", "none", "TPU.COMPUTE_DTYPE", "float32",
        "CONTRAST.MEM_TYPE", mem_type, "CONTRAST.NCE_K", str(K), "CONTRAST.NCE_T", "1.0",
        *opts])
    g = torch.Generator().manual_seed(3)
    clips = torch.randn(b, 2, 16, 64, 64, 3, generator=g)
    index = torch.randperm(n_data, generator=g)[:b]
    idx = torch.randint(0, n_data, (b, K + 1), generator=g)
    model, _ = create_visual_model(c)
    state = create_pretrain_state(c, model, d, n_data=n_data)
    p0 = [p.detach().cpu().double() for p in state.model.parameters()]
    if mem_type == "bank":
        step = make_bank_step(K, 1.0, float(c.CONTRAST.NCE_M), "crossentropy",
                              draw=lambda *a: idx.to(d))
    else:
        step = make_pretrain_step(c)
    loss = float(step(state, clips.to(d), 0.06, index.to(d))["loss"])
    delta = torch.cat([(p.detach().cpu().double() - q).flatten()
                       for p, q in zip(state.model.parameters(), p0)])
    memory = state.contrast.memory.cpu() if mem_type == "bank" else None
    return loss, memory, delta, index


def small_regime_parity(dev, mem_type: str, b: int = 8) -> None:
    """The small step of ``mem_type`` (``small_regime_step``): the card
    (kernels) against the CPU (plain versions)."""
    print(f"  small S3D+graph {mem_type} step ({b}x16x64x64, fp32), card vs CPU")
    lc, mc, dc, index = small_regime_step(mem_type, torch.device("cpu"), b)
    lg, mg, dg, _ = small_regime_step(mem_type, dev, b)
    tag = f"slice small ({mem_type})"
    check(f"{tag}: loss", abs(lc - lg) / max(1.0, abs(lc)), 1e-4)
    if mem_type == "bank":
        # the clips' rows took the features; train-mode BN over 8 clips
        # amplifies rounding, as phase 6's keys
        check(f"{tag}: bank rows of the batch", rel_err(mg[index], mc[index]), 1e-3)
    # at init the update cancels through the normalisations (phase 6)
    check(f"{tag}: parameter update (rel-L2)", float((dg - dc).norm() / dc.norm()), 1e-1)


def simsiam_four_clips(dev) -> None:
    """Why (a) holds SimSiam at 8 clips and not 4: three readings of the
    loss difference of the small step at 4 clips, printed, not gated: card
    vs CPU with the graph (K1/K2 in the forward), card vs CPU without it (no
    kernel in the forward; K3/K4 run in the backward only), and on the CPU
    fp32 against a float64 backbone (no kernel)."""
    cpu = torch.device("cpu")
    print("  SimSiam small step at 4 clips (the loss difference, absolute):")
    for what, opts, a, b in (
            ("card vs CPU, graph on (K1/K2 in the forward)", (), dev, cpu),
            ("card vs CPU, graph off (no kernel in the forward)",
             ("MODEL.AUG_FLAG", "False"), dev, cpu),
            ("CPU fp32 vs CPU float64 backbone, graph on (no kernel)", (), cpu, "float64")):
        la = small_regime_step("simsiam", a, 4, opts)[0]
        lb = (small_regime_step("simsiam", cpu, 4, ("TPU.COMPUTE_DTYPE", "float64"))[0]
              if b == "float64" else small_regime_step("simsiam", b, 4, opts)[0])
        print(f"  reading: {what}: {la!r} vs {lb!r}, |diff| {abs(la - lb):.3e}")


def run_regime(gpu: str, mem_type: str, n: int = 5) -> dict:
    """n trainer steps of ``mem_type`` at the full width of REGIMES (2
    warm-up, the rest timed) from synthetic clips through the Loader; the
    K1-K4 counts of exactly those steps held to ``kernel_times.step_calls``,
    finite losses, the memory, step host ms and peak memory."""
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config

    config, opts = REGIMES[mem_type]
    c = load_config(config, opts)
    trainer = Trainer(c, max_steps=n, device="cuda", run_dir=RUN_DIR)
    state = trainer.state
    size = list(c.INPUT.BASE_SIZE)
    geometry = (f"bs {c.DATALOADER.BATCH_SIZE}, 16x{size[0]}x{size[1]}, FEAT_DIM "
                f"{c.CROSS.FEAT_DIM}, {c.TPU.COMPUTE_DTYPE}")
    print(f"  trainer, {mem_type}, full S3D width: {geometry}")
    if mem_type == "simsiam":
        if size != [224, 224] or int(c.CROSS.FEAT_DIM) != 1024 or c.TPU.COMPUTE_DTYPE != "bfloat16":
            raise RuntimeError("configs/visual_simsiam.yaml no longer gives 224x224, "
                               "FEAT_DIM 1024 with bf16 compute")
        if state.ema_model is not None or state.contrast is not None:
            raise RuntimeError("the SimSiam state holds an EMA encoder or a memory")
    else:
        shape = tuple(state.contrast.memory.shape)
        print(f"  bank: n_data {trainer.n_data} (synthetic, DATASET.NUM_CLASS x 4), memory "
              f"{shape} fp32, NCE_K {c.CONTRAST.NCE_K}, criterion {c.CROSS.CRITERION}")
        if shape != (KINETICS_CLIPS, 128) or state.ema_model is not None:
            raise RuntimeError(f"bank memory {shape}, EMA {state.ema_model is not None}")
        memory0 = state.contrast.memory.clone()
    t0 = time.perf_counter()
    epoch = trainer.train_loader.epoch(0)
    batches = [(trainer.to_device(b), trainer.index_of(b))
               for b in itertools.islice(epoch, n)]
    epoch.close()
    print(f"  {n} synthetic batches made in {time.perf_counter() - t0:.1f} s")
    lr = trainer.lr_fn(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms, losses = [], []
    for clips, index in batches:
        t0 = time.perf_counter()
        metrics = trainer.train_step(clips, lr, index)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (ms, loss) in enumerate(zip(step_ms, losses)):
        print(f"  step {i} ({'warm-up' if i < 2 else 'timed'}): {ms:.1f} ms, loss {loss:.4f}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{mem_type}: non-finite loss {losses}")
    want = _want_counts(n, mem_type)
    print(f"  kernel calls in the {n} steps: {counts} (want {want})")
    if counts != want:
        raise RuntimeError(f"{mem_type}: kernel call counts {counts} != {want}")
    if mem_type == "bank":
        rows = torch.cat([i for _, i in batches]).unique()
        moved = (state.contrast.memory != memory0).any(dim=1).nonzero().flatten()
        norms = state.contrast.memory[rows].norm(dim=1)
        print(f"  bank: {moved.numel()} rows moved, {rows.numel()} rows in the batches; "
              f"their norms in [{float(norms.min()):.6f}, {float(norms.max()):.6f}]")
        if not torch.equal(moved, rows.sort().values) or float((norms - 1).abs().max()) > 1e-5:
            raise RuntimeError("bank: the rows that moved are not the batches' rows, or "
                               "are not unit vectors")
        del memory0
    timed = step_ms[2:]
    mean_ms = sum(timed) / len(timed)
    bsz = int(c.DATALOADER.BATCH_SIZE)
    print(f"slice {mem_type} ({geometry}): {mean_ms:.1f} ms/step, {bsz / mean_ms * 1e3:.1f} "
          f"clips/s (mean of {len(timed)} timed steps), max_memory_allocated {peak:.2f} GiB "
          f"on {gpu}")
    del trainer, state, batches, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": mean_ms, "peak_gib": peak, "counts": counts}


def regime_ranks(gpu: str) -> None:
    """(d) two rank processes sharing the card over gloo, both regimes in
    each: bit-equal states (the bank included), K1-K4 counts, finite
    losses, step host ms and peak memory per rank."""
    from video_graph_ssl_tpu_torch.utils.checkpoint import mismatches

    results = spawn_ranks([rank_run(opts, config) for config, opts in REGIMES.values()])
    for mem_type, (a, b) in zip(REGIMES, results):
        bad = mismatches(a["state"], b["state"])
        what = "the bank memory included" if mem_type == "bank" else "no memory"
        print(f"  (d) {mem_type}: rank 0 vs rank 1 state ({what}): {len(bad)} entries differ "
              f"(want 0, bit for bit); losses {a['losses']} / {b['losses']}")
        if bad or a["losses"] != b["losses"]:
            raise RuntimeError(f"(d) {mem_type}: ranks differ at {bad[:10]}")
        want = _want_counts(mem_type=mem_type)
        for r, res in enumerate((a, b)):
            print(f"  (d) {mem_type}: rank {r} rows {res['rows']}, DDP {res['ddp']}: kernel "
                  f"calls {res['counts']}; step host ms {[round(x, 1) for x in res['ms']]} "
                  f"({SHARED}); max_memory_allocated {res['peak_gib']:.2f} GiB on {gpu}")
            if res["counts"] != want:
                raise RuntimeError(f"(d) {mem_type}: rank {r} kernel calls {res['counts']} "
                                   f"!= {want}")
            if not all(math.isfinite(x) for x in res["losses"]):
                raise RuntimeError(f"(d) {mem_type}: non-finite loss {res['losses']}")


def nccl_one_rank(tag: str, run: dict) -> dict:
    """One rank in an NCCL group against the trainer without a group, the
    ``rank_run`` ``run``, RANK_STEPS steps under cudnn.deterministic: bit
    for bit; the grouped run's results."""
    from video_graph_ssl_tpu_torch.parallel import dist
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import _free_port
    from video_graph_ssl_tpu_torch.utils.checkpoint import mismatches

    torch.backends.cudnn.deterministic = True
    try:
        alone = drive_steps(make_trainer(run, "cuda", RUN_DIR))
        _free()
        dist.init_distributed("nccl", f"tcp://localhost:{_free_port()}", 1, 0)
        try:
            trainer = make_trainer(run, "cuda:0", RUN_DIR)
            if trainer.state.ddp is None or torch.distributed.get_backend() != "nccl":
                raise RuntimeError(f"{tag}: the one-rank trainer is not in an NCCL DDP group")
            grouped = drive_steps(trainer)
            del trainer
        finally:
            torch.distributed.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = False
    bad = mismatches(alone["state"], grouped["state"])
    print(f"  {tag}, NCCL at world size 1 against no group: losses {grouped['losses']} vs "
          f"{alone['losses']}; {len(bad)} state entries differ (want 0, bit for bit); kernel "
          f"calls {grouped['counts']} vs {alone['counts']}")
    if bad or grouped["losses"] != alone["losses"] or grouped["counts"] != alone["counts"]:
        raise RuntimeError(f"{tag}: NCCL world size 1 differs from no group: {bad[:10]}")
    del alone
    _free()
    return grouped


def regime_nccl_one_rank(gpu: str, mem_type: str) -> None:
    """(d) one rank in an NCCL group against the trainer without a group."""
    config, opts = REGIMES[mem_type]
    nccl_one_rank(f"(d) {mem_type}", rank_run(opts, config))


def phase_regimes(dev, gpu: str) -> None:
    print("phase 9: the SimSiam (GCA-S) and memory-bank regimes")
    print("  (a) small steps, card vs CPU")
    for mem_type in REGIMES:
        small_regime_parity(dev, mem_type)
    simsiam_four_clips(dev)
    print("  (b) SimSiam (GCA-S) on configs/visual_simsiam.yaml")
    run_regime(gpu, "simsiam")
    print("  (c) the memory bank at the configs/visual_moco.yaml geometry")
    run_regime(gpu, "bank")
    print(f"  (d) across ranks, {RANK_STEPS} steps each")
    for mem_type in REGIMES:
        regime_nccl_one_rank(gpu, mem_type)
    regime_ranks(gpu)


# --------------------------------------------------------------------------- #
# phase 10: downstream training and evaluation through the port's train_ds,
# test_ds and video_retrieval, at the shipped configs/action_fine_tune.yaml
# geometry (S3D, bs 32, 16x112x112, 101 classes, DROPOUT 0.7, partial BN,
# bf16) and configs/action_linear_probe.yaml, on synthetic clips.
FT_CONFIG = os.path.join(REPO, "configs", "action_fine_tune.yaml")
PROBE_CONFIG = os.path.join(REPO, "configs", "action_linear_probe.yaml")
SYNTHETIC = ["DATASET.SOURCE", "synthetic"]
DS_STEPS = 5          # (b): 2 warm-up, 3 timed
DS_SHORT = 3          # (c)-(e)
# (a): the small fine-tune step's parameter update, card against CPU,
# rel-L2.  With the deep BNs frozen, train-mode BN no longer amplifies
# rounding over 4 clips as in phase 6 (reading 1.5e-4 on an H100 80GB HBM3,
# 700 W), so a backward that is a few percent off fails
TOL_DS_UPDATE = 1e-3
# (f): the bf16 network's logits over one batch of 480 crops against the
# same crops 16 at a time (other cuDNN algorithms, the same rounding of
# every activation to bf16), rel-L2 (reading 4.2e-4 on an H100 80GB HBM3,
# 700 W).  Both sides take their crops from test_ds.crops_of, so this holds
# the batching; the crops' placement is held against JAX's multi_crop_eval
# by the CPU tests
TOL_BATCHING_BF16 = 5e-3
STEM_0 = "base_model.base.0."


def small_downstream_parity(dev) -> None:
    """(a) one fine-tune step (graph blocks at 5, 9, 14, sampler none, fp32,
    DROPOUT 0, partial BN) and one eval forward of a small S3D on 4 clips
    of 16x64x64, from one initial state: the card against the CPU."""
    from video_graph_ssl_tpu_torch.engine.build import create_downstream_state
    from video_graph_ssl_tpu_torch.engine.downstream import (make_downstream_train_step,
                                                             make_eval_step,
                                                             make_feature_step)
    from video_graph_ssl_tpu_torch.models.build import create_video_model
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    print("  (a) small S3D+graph fine-tune step and eval forward (4x16x64x64, fp32, "
          "partial BN), card vs CPU")
    c = load_config(FT_CONFIG, ["MODEL.AUG_FLAG", "True", "GRAPH.SAMPLER", "none",
                                "TPU.COMPUTE_DTYPE", "float32", "MODEL.DROPOUT", "0.0",
                                "DATASET.NUM_CLASS", "16"])
    g = torch.Generator().manual_seed(5)
    clips = torch.randn(4, 16, 64, 64, 3, generator=g)
    labels = torch.randint(0, 16, (4,), generator=g)
    runs = {}
    for name, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
        model, _ = create_video_model(c)
        state = create_downstream_state(c, model, d)
        x = clips.to(d)
        logits = make_eval_step()(state.model, x).cpu()
        feats = make_feature_step()(state.model, x).cpu()
        p0 = [p.detach().cpu().double() for p in state.model.parameters()]
        loss = float(make_downstream_train_step(True)(state, x, labels.to(d), 0.06)["loss"])
        delta = torch.cat([(p.detach().cpu().double() - q).flatten()
                           for p, q in zip(state.model.parameters(), p0)])
        runs[name] = (loss, logits, feats, delta)
    (lc, gc_, fc, dc), (lg, gg, fg, dg) = runs["cpu"], runs["gpu"]
    check("downstream small: loss", abs(lc - lg) / max(1.0, abs(lc)), 1e-4)
    check("downstream small: eval features (rel-L2)", rel_l2(fg, fc), 1e-3)
    check("downstream small: eval logits (rel-L2)", rel_l2(gg, gc_), 1e-3)
    check("downstream small: parameter update (rel-L2)",
          float((dg - dc).norm() / dc.norm()), TOL_DS_UPDATE)


def write_pretrain_checkpoint(dev, name: str = "phase10_pretrain", opts=()) -> str:
    """One MoCo step of the port's pretrain trainer at full S3D width
    (configs/visual_moco.yaml geometry, bs 8, NCE_K 64, + ``opts``) and its
    checkpoint through the trainer's Saver under CHECKNAME ``name``; returns
    the path."""
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config

    c = load_config(CONFIG, SYNTHETIC + ["DATALOADER.BATCH_SIZE", "8", "CONTRAST.NCE_K", "64",
                                         "CHECKPOINT.CHECKNAME", name, *opts])
    trainer = Trainer(c, max_steps=1, device=str(dev), run_dir=RUN_DIR)
    epoch = trainer.train_loader.epoch(0)
    batch = next(epoch)
    epoch.close()
    loss = float(trainer.train_step(trainer.to_device(batch), trainer.lr_fn(0))["loss"])
    path = trainer.saver.save_checkpoint(trainer.state, 1, filename="checkpoint_1.pth.tar")
    print(f"  pretrain checkpoint (MoCo{' '.join(['', *opts])}, 1 step, loss {loss:.4f}): "
          f"{path}")
    if not math.isfinite(loss):
        raise RuntimeError(f"pretrain step: non-finite loss {loss}")
    del trainer
    return path


def run_downstream(dev, gpu: str, config: str, opts: list, n: int, ssl: str = "") -> dict:
    """n steps of train_ds's Trainer on ``config`` + ``opts`` from synthetic
    batches (the first 2 warm-up), the K1-K5 counts of exactly those steps;
    the trainer, its state before the steps (on the CPU), step host ms,
    losses and peak memory."""
    from video_graph_ssl_tpu_torch.train_ds import Trainer
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    c = load_config(config, SYNTHETIC + opts)
    trainer = Trainer(c, ssl_checkpoint=ssl, max_steps=n, device=str(dev), run_dir=RUN_DIR)
    epoch = trainer.train_loader.epoch(0)
    batches = [trainer.batch_to_device(b) for b in itertools.islice(epoch, n)]
    epoch.close()
    before = _cpu(trainer.state.model.state_dict())
    lr = trainer.lr_fn(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, losses = [], []
    for clips, labels in batches:
        t0 = time.perf_counter()
        metrics = trainer.train_step(clips, labels, lr)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed = ms[2:] if len(ms) > 2 else ms[1:]
    mean_ms = sum(timed) / len(timed)
    bsz = int(c.DATALOADER.BATCH_SIZE)
    print(f"  {os.path.basename(config)} {' '.join(opts)}: step host ms "
          f"{[round(x, 1) for x in ms]}, losses {[round(x, 4) for x in losses]}; mean of "
          f"{len(timed)} timed steps {mean_ms:.1f} ms, {bsz / mean_ms * 1e3:.1f} clips/s "
          f"(bs {bsz}), max_memory_allocated {peak:.2f} GiB on {gpu}; kernel calls {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"downstream: non-finite loss {losses}")
    return {"trainer": trainer, "before": before, "counts": counts, "ms": mean_ms,
            "peak_gib": peak, "batches": batches}


def _hold_counts(tag: str, counts: dict, want: dict) -> None:
    if counts != want:
        raise RuntimeError(f"{tag}: kernel call counts {counts} != {want}")


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def probe_run(dev, gpu: str, probe_bn: str) -> dict:
    """(c) the linear probe under ``probe_bn``: the encoder's parameters bit
    for bit unchanged, new_fc moved, and the BN statistics: stem_0's alone
    moved under ``reference``, none under ``eval``."""
    r = run_downstream(dev, gpu, PROBE_CONFIG, ["MODEL.PROBE_BN", probe_bn], DS_SHORT)
    model = r["trainer"].state.model
    after = _cpu(model.state_dict())
    params = {n for n, _ in model.named_parameters()}
    moved = sorted(k for k, v in r["before"].items() if not torch.equal(v, after[k]))
    enc_moved = [k for k in moved if k in params and not k.startswith("new_fc.")]
    stats_moved = [k for k in moved if "running" in k]
    want_stats = sorted(k for k in after if "running" in k and k.startswith(STEM_0)) \
        if probe_bn == "reference" else []
    print(f"  (c) probe, PROBE_BN {probe_bn}: encoder parameters moved {len(enc_moved)} "
          f"(want 0, bit for bit), new_fc moved {'new_fc.weight' in moved}; BN statistics "
          f"moved {stats_moved} (want {want_stats})")
    if enc_moved or "new_fc.weight" not in moved or stats_moved != want_stats:
        raise RuntimeError(f"(c) probe {probe_bn}: encoder {enc_moved[:5]}, statistics "
                           f"{stats_moved}")
    _hold_counts(f"(c) probe {probe_bn}", r["counts"], _want_counts(
        DS_SHORT, "probe", partial_bn=True, graph=False))
    return r


def downstream_test_ds(dev, gpu: str, best: str) -> None:
    """(f) test_ds on (b)'s best checkpoint over 16 videos x 10 clips x 3
    crops: its scores finite and, within TOL_BATCHING_BF16, the mean of the
    logits computed one (clip, crop) at a time; the eval forward's clips/s
    and peak memory."""
    import numpy as np
    from video_graph_ssl_tpu_torch import test_ds
    from video_graph_ssl_tpu_torch.data.build import make_test_loader
    from video_graph_ssl_tpu_torch.data.pipeline import to_device
    from video_graph_ssl_tpu_torch.engine.build import create_downstream_state
    from video_graph_ssl_tpu_torch.engine.downstream import make_eval_step
    from video_graph_ssl_tpu_torch.models.build import create_video_model
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config
    from video_graph_ssl_tpu_torch.utils.checkpoint import load_checkpoint_state

    n_videos, n_clips, n_crops = 16, 10, 3
    opts = SYNTHETIC + ["TEST.BATCH_SIZE", str(n_videos)]
    scores_path = os.path.join(RUN_DIR, "phase10_scores.npz")
    t0 = time.perf_counter()
    rep = test_ds.main(["--device", str(dev), "--config_file", FT_CONFIG, "--checkpoint", best,
                        "--test_crops",
                        str(n_crops), "--test_clips", str(n_clips), "--max_videos",
                        str(n_videos), "--save_scores", scores_path, *opts])
    print(f"  (f) test_ds: {time.perf_counter() - t0:.1f} s, top-1 {rep['top1']:.2f}%, "
          f"mean class accuracy {rep['mean_class_acc']:.2f}%")
    scores = torch.from_numpy(np.load(scores_path)["scores"])
    c = load_config(FT_CONFIG, opts)
    model, _ = create_video_model(c)
    state = create_downstream_state(c, model, dev)
    load_checkpoint_state(best, state)
    epoch = make_test_loader(c, num_clips=n_clips).epoch(0)
    raw = to_device(next(epoch)["clips"], dev)
    epoch.close()
    eval_fn = test_ds.build_eval_fn(c, n_crops)
    eval_fn(state.model, raw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = eval_fn(state.model, raw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = raw.shape[0] * n_clips * n_crops
    step = make_eval_step()
    crops = test_ds.crops_of(raw, c, n_crops)
    x = crops.reshape(raw.shape[0], n_clips * n_crops, *crops.shape[1:])
    one_at_a_time = torch.stack([step(state.model, x[:, j]).float()
                                 for j in range(x.shape[1])], dim=1).mean(dim=1).cpu()
    print(f"  (f) eval forward (resize, {n_crops} crops, one forward): {n} clips of "
          f"{tuple(x.shape[2:5])} in {sec * 1e3:.1f} ms, {n / sec:.1f} clips/s, "
          f"max_memory_allocated {peak:.2f} GiB on {gpu}")
    if tuple(scores.shape) != (raw.shape[0], int(c.DATASET.NUM_CLASS)) \
            or not torch.isfinite(scores).all():
        raise RuntimeError(f"(f) test_ds scores {tuple(scores.shape)}, finite "
                           f"{bool(torch.isfinite(scores).all())}")
    check("(f) test_ds scores vs its eval_fn again (rel-L2)",
          rel_l2(again.float().cpu(), scores), TOL_BATCHING_BF16)
    check("(f) scores vs the mean of one crop at a time (rel-L2)",
          rel_l2(scores, one_at_a_time), TOL_BATCHING_BF16)


def downstream_retrieval(dev, gpu: str, ssl: str) -> None:
    """(g) video_retrieval on the phase's pretrain checkpoint: features of
    32 videos x 10 clips per split, finite; R@k and videos/s."""
    import pickle

    import numpy as np
    from video_graph_ssl_tpu_torch import video_retrieval

    n_videos = 32
    feature_dir = os.path.join(RUN_DIR, "phase10_features")
    t0 = time.perf_counter()
    recalls = video_retrieval.main([
        "--device", str(dev), "--config_file", CONFIG, "--checkpoint", ssl, "--extract_feature",
        "--feature_dir", feature_dir, "--test_clips", "10", "--max_videos", str(n_videos),
        *SYNTHETIC, "TEST.BATCH_SIZE", str(n_videos)])
    sec = time.perf_counter() - t0
    for split in ("train", "val"):
        with open(os.path.join(feature_dir, f"{split}_features.pkl"), "rb") as f:
            feats = pickle.load(f)["features"]
        if feats.shape != (n_videos, 1024) or not np.isfinite(feats).all():
            raise RuntimeError(f"(g) {split} features {feats.shape}, finite "
                               f"{bool(np.isfinite(feats).all())}")
    print(f"  (g) video_retrieval: R@k {recalls}; {2 * n_videos} videos x 10 clips in "
          f"{sec:.1f} s ({2 * n_videos / sec:.1f} videos/s, model set-up included) on {gpu}")


def phase_downstream(dev, gpu: str) -> tuple:
    print("phase 10: downstream training and evaluation (train_ds, test_ds, video_retrieval)")
    small_downstream_parity(dev)
    _free()
    print("  (b) train_ds on configs/action_fine_tune.yaml from the port's MoCo checkpoint")
    ssl = write_pretrain_checkpoint(dev)
    _free()
    r = run_downstream(dev, gpu, FT_CONFIG, [], DS_STEPS, ssl=ssl)
    trainer = r["trainer"]
    c = trainer.cfg
    if (int(c.DATALOADER.BATCH_SIZE), int(c.INPUT.VIDEO_LENGTH), list(c.INPUT.BASE_SIZE),
            int(c.DATASET.NUM_CLASS), float(c.MODEL.DROPOUT), bool(c.MODEL.NO_PARTIALBN),
            c.TPU.COMPUTE_DTYPE) != (32, 16, [112, 112], 101, 0.7, False, "bfloat16"):
        raise RuntimeError("configs/action_fine_tune.yaml no longer gives S3D bs 32, "
                           "16x112x112, 101 classes, DROPOUT 0.7, partial BN, bf16")
    _hold_counts("(b) fine-tune", r["counts"], _want_counts(
        DS_STEPS, "finetune", partial_bn=True, graph=False))
    ds_counts = {"finetune": r["counts"]}
    # the first validation writes model_best_state whatever its top-1
    trainer.best_pred = -1.0
    t0 = time.perf_counter()
    top1 = trainer.validation(0)
    best = os.path.join(trainer.saver.experiment_dir, "model_best_state.pth.tar")
    print(f"  (b) validation over {len(trainer.val_loader.dataset)} videos: top-1 "
          f"{top1:.2f}% in {time.perf_counter() - t0:.1f} s; {best} written "
          f"{os.path.exists(best)}")
    if not os.path.exists(best):
        raise RuntimeError("(b) model_best_state.pth.tar was not written")
    del trainer, r
    _free()
    for probe_bn in ("eval", "reference"):
        p = probe_run(dev, gpu, probe_bn)
        ds_counts[f"probe {probe_bn}"] = p["counts"]
        del p
        _free()
    print("  (d) MODEL.AUG_FLAG True: 3 fine-tune steps, then one eval batch")
    r = run_downstream(dev, gpu, FT_CONFIG, ["MODEL.AUG_FLAG", "True"], DS_SHORT)
    _hold_counts("(d) fine-tune with the graph", r["counts"], _want_counts(
        DS_SHORT, "finetune", partial_bn=True, graph=True))
    trainer = r["trainer"]
    reset_counts()
    logits = trainer.eval_fn(trainer.state.model, r["batches"][0][0])
    torch.cuda.synchronize()
    eval_counts = read_counts()
    print(f"  (d) eval batch: logits {tuple(logits.shape)}, kernel calls {eval_counts}")
    _hold_counts("(d) eval with the graph", eval_counts, _want_counts(1, "eval", graph=True))
    if not torch.isfinite(logits).all():
        raise RuntimeError("(d) non-finite eval logits")
    ds_counts["finetune graph"], ds_counts["eval graph"] = r["counts"], eval_counts
    del trainer, r, logits
    _free()
    print("  (e) MODEL.NO_PARTIALBN True TPU.SEPCONV_FUSED True: 3 fine-tune steps")
    r = run_downstream(dev, gpu, FT_CONFIG, ["MODEL.NO_PARTIALBN", "True",
                                        "TPU.SEPCONV_FUSED", "True"], DS_SHORT)
    _hold_counts("(e) fused, no partial BN", r["counts"], _want_counts(
        DS_SHORT, "finetune", fused=True, partial_bn=False, graph=False))
    ds_counts["finetune fused"] = r["counts"]
    del r
    _free()
    downstream_test_ds(dev, gpu, best)
    _free()
    downstream_retrieval(dev, gpu, ssl)
    _free()
    print(json.dumps({"downstream_launches": ds_counts}))
    return ssl, best

# --------------------------------------------------------------------------- #
# phase 11: the graph-benefit A/B (graph_benefit.py, the counterpart of the
# JAX package's perf/graph_benefit_lab.py): moco on temporal_shortcut_clips,
# seed 0, AB_EPOCHS epochs of 3 steps, both arms (MODEL.AUG_FLAG True and
# False), lr 0.3; the shapes are AB_K1, AB_K2 and AB_POOL above.  Each arm
# must train (loss_last below AB_TRAINS of loss_first) and the graph arm must
# beat the ablation's retrieval top-1 by AB_MARGIN.  The run repeats bit for
# bit on one card and software stack (graph_benefit.reproducible_fp32); on
# an H100 at 700 W it reads margin +0.104 (0.708 against 0.604), and under
# cuDNN's default algorithms four runs read +0.063 to +0.250, so the gate
# sits at 0.05 (JAX's live gate, 0.08, was tuned on the TPU;
# tests/test_torch_learning.py).  The pair is printed beside the committed
# artifact's seed-0 record, which it equals where the stack is the same.
AB_EPOCHS, AB_TRAINS, AB_MARGIN = 150, 0.75, 0.05
AB_ARTIFACT = os.path.join(REPO, "video_graph_ssl_tpu_torch", "evidence",
                           "GRAPH_BENEFIT_h100.jsonl")
AB_KW = dict(regime="moco", seed=0, epochs=AB_EPOCHS, t=8, hw=16, per_class=12, lr=0.3,
             dataset="shortcut")


def kernel_checks(dev, tag: str, k1_shapes, k2_shapes, pools, dn: str,
                  clip0: int = 0) -> None:
    """K1, K2 and K3/K4 against their plain versions at one path's shapes
    in ``dn``: K1 unsampled, with given noise, with its own draw and its
    closed-form backward, the draw at clip offset ``clip0`` (a rank's
    clips) equal bit for bit to those rows of the draw over clip0 + B
    clips; K2 both ways and its autograd; each pool (``POOLS``' rows) exact
    and against torch's own pool backward.  Returns each kernel's largest
    |kernel - plain| (K1: its adjacency on given and on drawn noise)."""
    import torch.nn.functional as F
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.ops import maxpool as mp
    from video_graph_ssl_tpu_torch.ops.temporal_graph import hop_weight_matrix

    dt = DTYPES[dn]
    g = torch.Generator(device=dev).manual_seed(11)
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    for b, t, d in k1_shapes:
        kt = f"{tag} K1 ({b},{t},{d}) {dn}"
        theta = torch.from_numpy(hop_weight_matrix(t, 3, 0.5)).to(dev)
        q = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(dt)
        k = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(dt)
        u = torch.rand(b, t, t, device=dev, generator=g) * (1 - 2e-6) + 1e-6
        for name, x, y in zip(("adj", "S", "p"),
                              gk.adjacency_fwd_kernel(q, k, theta, None, 0, 1.0, False, 0),
                              gk._adjacency_fwd_plain(q, k, theta, None, 0, 1.0, False, 0)):
            check(f"{kt} sample=False {name}", rel_err(x, y), TOL["fp32"])
        given = (gk.adjacency_fwd_kernel(q, k, theta, u, 0, 1.0, True, 0)[0],
                 gk._adjacency_fwd_plain(q, k, theta, u, 0, 1.0, True, 0)[0])
        check(f"{kt} sample=True, given u", rel_err(*given), TOL_SAMPLED)
        rows = (clip0, clip0 + b) if clip0 else None
        u_out = torch.empty(b, t, t, device=dev)
        drawn = gk.adjacency_fwd_kernel(q, k, theta, None, 7, 1.0, True, 0, u_out=u_out,
                                        rows=rows)[0]
        plain = gk._adjacency_fwd_plain(q, k, theta, u_out, 7, 1.0, True, 0)[0]
        check(f"{kt} Philox draw at clip {clip0}, adj vs plain on u_out",
              rel_err(drawn, plain), TOL_SAMPLED)
        worst["K1"] = max(worst["K1"], max_abs(*given), max_abs(drawn, plain))
        if clip0:
            # the draw over clip0 + b clips, of which these are the last b
            qf, kf = (torch.cat([x.new_zeros(clip0, t, d), x]) for x in (q, k))
            u_full = torch.empty(clip0 + b, t, t, device=dev)
            gk.adjacency_fwd_kernel(qf, kf, theta, None, 7, 1.0, True, 0, u_out=u_full)
            if not torch.equal(u_out, u_full[clip0:]):
                raise RuntimeError(f"{kt}: the draw at clip {clip0} differs from the rows of "
                                   f"the draw over {clip0 + b} clips")
            print(f"  {kt}: the draw at clip {clip0} equals rows [{clip0}, {clip0 + b}) of "
                  f"the draw over {clip0 + b} clips, bit for bit")
        gout = torch.randn(b, t, t, device=dev, generator=g)
        for sample in (False, True):
            qa, ka = q.clone().requires_grad_(), k.clone().requires_grad_()
            adj = gk.GraphAdjacencyFn.apply(gk.adjacency_fwd_kernel, qa, ka, theta, u, 0, 1.0,
                                            sample, 0)
            got = torch.autograd.grad((adj * gout).sum(), (qa, ka))
            qb, kb = q.clone().requires_grad_(), k.clone().requires_grad_()
            adj = gk.graph_adjacency_plain(qb, kb, theta, 0, 1.0, sample, u)
            want = torch.autograd.grad((adj * gout).sum(), (qb, kb))
            for name, x, y in zip(("dq", "dk"), got, want):
                check(f"{kt} sample={sample} {name} (rel)",
                      float((x.float() - y.float()).abs().max()
                            / y.float().abs().max().clamp_min(1e-30)), TOL_GRAD[dn])
    for shape in k2_shapes:
        b, t = shape[:2]
        kt = f"{tag} K2 {shape} {dn}"
        x = torch.randn(shape, device=dev, generator=g).to(dt)
        adj = torch.rand(b, t, t, device=dev, generator=g).to(dt)
        for tr in (False, True):
            out, ref = gp._launch(adj, x, transpose=tr), gp.propagate_plain(adj, x, transpose=tr)
            check(f"{kt} transpose={tr}", rel_err(out, ref), TOL[dn])
            worst["K2"] = max(worst["K2"], max_abs(out, ref))
        gout = torch.randn(shape, device=dev, generator=g).to(dt)
        xa, aa = x.clone().requires_grad_(), adj.clone().requires_grad_()
        dx_k, da_k = torch.autograd.grad(
            (gp._GcnPropagate.apply(aa, xa).float() * gout.float()).sum(), (xa, aa))
        xb, ab = x.clone().requires_grad_(), adj.clone().requires_grad_()
        dx_p, da_p = torch.autograd.grad(
            (gp.propagate_plain(ab, xb).float() * gout.float()).sum(), (xb, ab))
        check(f"{kt} dx", rel_err(dx_k, dx_p), TOL[dn])
        check(f"{kt} dadj (rel)", float((da_k.float() - da_p.float()).abs().max()
                                        / da_p.float().abs().max()), TOL_GRAD[dn])
    for name, kn, shape, k, s, p in pools:
        x = _ncdhw(shape, dev, dt, g)
        y, idx = F.max_pool3d(x, k, s, p, return_indices=True)
        y = y.contiguous(memory_format=CL)
        dy = torch.randn(y.shape, device=dev, generator=g).to(dt).contiguous(memory_format=CL)
        dx = mp._launch(x, y, dy, k, s, p)
        kt = f"{tag} {kn} {name} {shape} {dn}"
        err = max_abs(dx, mp.max_pool3d_bwd_plain(x, y, dy, k, s, p))
        check(f"{kt} vs plain (max abs)", err, 0.0)
        worst[kn] = max(worst[kn], err)
        check(f"{kt} vs torch", rel_err(dx, torch.ops.aten.max_pool3d_with_indices_backward(
            dy, x, list(k), list(s), list(p), [1, 1, 1], False, idx)), TOL_POOL_LIB[dn])
        del x, y, idx, dy, dx
    return worst


def phase_ab(dev, gpu: str) -> None:
    """(a) the kernels at the A/B's shapes, then (b) one A/B pair through
    ``graph_benefit.run_one``, with each kernel's calls and the shapes it
    saw over exactly that pair."""
    from video_graph_ssl_tpu_torch import graph_benefit as gb
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.ops import maxpool as mp

    print("phase 11: the graph-benefit A/B (tiny3d, moco, temporal_shortcut_clips, seed 0)")
    kernel_checks(dev, "(a)", AB_K1, AB_K2, [("A/B pool", "K4", *AB_POOL)], "fp32")
    seen = {"K1": set(), "K2": set(), "K4": set()}
    k1, k2, k4 = gk.adjacency_fwd_kernel, gp._launch, mp._launch

    def k1_rec(q, *a, **kw):
        seen["K1"].add(tuple(q.shape))
        return k1(q, *a, **kw)

    def k2_rec(adj, x, transpose):
        seen["K2"].add(tuple(x.shape))
        return k2(adj, x, transpose)

    def k4_rec(x, y, dy, k, s, p):
        b, c, t, h, w = x.shape
        seen["K4"].add(pool_key((b, t, h, w, c), k, s, p))
        return k4(x, y, dy, k, s, p)

    arms = {}
    gk.adjacency_fwd_kernel, gp._launch, mp._launch = k1_rec, k2_rec, k4_rec
    try:
        torch.cuda.synchronize()
        reset_counts()
        for aug in (True, False):
            t0 = time.perf_counter()
            arms[aug] = gb.run_one(aug=aug, device=str(dev), **AB_KW)
            arms[aug]["sec"] = time.perf_counter() - t0
        counts = read_counts()
    finally:
        gk.adjacency_fwd_kernel, gp._launch, mp._launch = k1, k2, k4
    steps = AB_EPOCHS * (4 * AB_KW["per_class"] // 16)
    want = {}
    for graph in (True, False):
        for name, n in (("moco", steps), ("eval", 2)):   # the steps, before and after
            for key, v in step_calls(name, graph=graph, backbone="tiny3d").items():
                want[key] = want.get(key, 0) + v * n
    for aug, r in arms.items():
        print(f"  (b) {'graph' if aug else 'nograph'} arm: before {r['before']!r}, after "
              f"{r['after']!r}, loss_first {r['loss_first']!r}, loss_last {r['loss_last']!r}, "
              f"{r['sec']:.2f} s ({steps} steps, set-up and encodes included) on {gpu}")
    margin = arms[True]["after"] - arms[False]["after"]
    print(f"  (b) margin {margin:+.4f} (gate {AB_MARGIN:+.3f}); kernel calls {counts} "
          f"(want {want}); shapes seen {json.dumps({k: sorted(v) for k, v in seen.items()})}")
    with open(AB_ARTIFACT) as f:
        rec = next(r for r in map(json.loads, f) if r["regime"] == "moco"
                   and r["dataset"] == "shortcut" and r["seed"] == AB_KW["seed"])
    same = all(rec[name][key] == arms[aug][key] for name, aug in (("graph", True),
                                                                  ("nograph", False))
               for key in ("before", "after", "loss_first", "loss_last"))
    print(f"  (b) the artifact's seed-0 record ({rec['device']}): graph after "
          f"{rec['graph']['after']!r}, nograph after {rec['nograph']['after']!r}, margin "
          f"{rec['margin']:+.4f}; this run equals it bit for bit: {same}")
    _hold_counts("(b) the A/B pair", counts, want)
    if seen != {"K1": set(AB_K1), "K2": set(AB_K2), "K4": {pool_key(*AB_POOL)}}:
        raise RuntimeError(f"(b) the kernels saw {seen}, not AB_K1, AB_K2, AB_POOL")
    for aug, r in arms.items():
        if not r["loss_last"] < AB_TRAINS * r["loss_first"]:
            raise RuntimeError(f"(b) the {'graph' if aug else 'nograph'} arm did not train: {r}")
    if not margin >= AB_MARGIN:
        raise RuntimeError(f"(b) margin {margin:+.4f} below the gate {AB_MARGIN:+.3f}")


# --------------------------------------------------------------------------- #
# phase 12: downstream across ranks.  train_ds's Trainer from phase 10's
# pretrain checkpoint, RANK_STEPS steps, graph on (MODEL.AUG_FLAG True, so
# K1/K2 run): the fine-tune at the shipped configs/action_fine_tune.yaml
# geometry (S3D, bs 32, 16x112x112, 101 classes, DROPOUT 0.7, partial BN)
# and the linear probe (configs/action_linear_probe.yaml) under PROBE_BN
# reference and eval.  Two ranks share the card over gloo, 16 rows each.
DS_RANK_RUNS = {"finetune": (FT_CONFIG, []),
                "probe reference": (PROBE_CONFIG, ["MODEL.PROBE_BN", "reference"]),
                "probe eval": (PROBE_CONFIG, ["MODEL.PROBE_BN", "eval"])}
# The fp32 runs (TF32 off, cudnn.deterministic) against one process on the
# same global batches that takes its BN statistics through the ranks' own
# function (sync_bn.sum_form_bn) and repeats itself bit for bit, as in phase
# 8: the errors of ds_rank_errors (each step's loss, the parameter update
# after steps 1 and 3 and its norm, the BN statistics).  Under partial BN only
# stem_0's and the graph blocks' BNs are live; the control (BN per rank)
# must exceed at least one bound, so the bounds see whether those BNs are
# the global batch's.  At initialisation the logits are near 0 and every
# loss near ln 101 whatever the update, so the losses are held only against
# a blow-up.  Readings on an H100 80GB HBM3 (700 W), ranks / control:
#   fine-tune: losses 0, 0, 0 / 3.1e-7, 2.1e-7, 9.3e-7; update_1 4.7e-4 /
#   7.7e-3, update_1_norm 3.2e-9 / 9.1e-5, update_3 2.7e-4 / 6.6e-3,
#   update_3_norm 4.4e-8 / 2.0e-5; bn 7.4e-8 / 2.5e-3;
#   probe reference: losses 1.0e-7, 0, 0 / 1.0e-7, 1.0e-7, 3.1e-7; update_1
#   1.9e-6 / 3.0e-3, update_1_norm 3.2e-8 / 3.6e-5, update_3 1.3e-6 / 3.0e-3,
#   update_3_norm 2.0e-9 / 1.8e-5; bn 8.4e-8 / 2.5e-3.
# The update and bn bounds sit 6x (the fine-tune's updates) to 100x above the
# ranks' readings and below the control's, which exceeds them all.
TOL_DS_RANKS = {
    "finetune": {"loss_1": 1e-5, "loss_2": 1e-5, "loss_3": 1e-5, "update_1": 3e-3,
                 "update_1_norm": 1e-5, "update_3": 3e-3, "update_3_norm": 1e-5, "bn": 1e-5},
    "probe reference": {"loss_1": 1e-5, "loss_2": 1e-5, "loss_3": 1e-5, "update_1": 1e-4,
                        "update_1_norm": 5e-6, "update_3": 1e-4, "update_3_norm": 5e-6,
                        "bn": 1e-5}}
# (c): test_ds over the 202 videos of the 101-class synthetic test set in
# batches of 45 (each padded to 46 for two ranks; the last batch holds 22), 2
# clips x 3 crops; video_retrieval over 15 videos per split in batches of 5
# (each padded to 6), 2 clips; bf16 and fp32, each held to TOL["fp32"]
# rel-L2 against one process (an H100 80GB HBM3 at 700 W read them equal bit
# for bit in both dtypes).
TEST_VIDEOS, TEST_DS_BATCH, RETRIEVAL_VIDEOS, RETRIEVAL_BATCH = 202, 45, 15, 5


def ds_run(name: str, dtype: str, ssl: str, per_rank: bool = False) -> dict:
    config, opts = DS_RANK_RUNS[name]
    return rank_run(SYNTHETIC + ["MODEL.AUG_FLAG", "True", "TPU.COMPUTE_DTYPE", dtype, *opts],
                    config, per_rank=per_rank, ssl=ssl)


def ds_want(name: str) -> dict:
    """K1-K5 calls of RANK_STEPS steps of the run ``name``, partial BN, graph on."""
    return _want_counts(RANK_STEPS, "finetune" if name == "finetune" else "probe",
                        partial_bn=True, graph=True)


def ds_rank_errors(got: dict, ref: dict) -> dict:
    """Errors of a downstream run against one process's on the same global
    batches: the relative error of each step's loss, rel-L2 of the
    parameter update after step 1 and after the last step and the relative
    error of its norm, and the largest rel-L2 of the BN statistics."""
    errs = {f"loss_{i + 1}": abs(a - b) / abs(b)
            for i, (a, b) in enumerate(zip(got["losses"], ref["losses"]))}
    for step, after in ((1, "after_1"), (RANK_STEPS, "state")):
        u, v = _update(got, after), _update(ref, after)
        errs[f"update_{step}"] = rel_l2(u, v)
        errs[f"update_{step}_norm"] = abs(float(u.norm() / v.norm()) - 1.0)
    ref_sd = ref["state"]["state_dict"]
    errs["bn"] = max(rel_l2(v, ref_sd[k]) for k, v in got["state"]["state_dict"].items()
                     if "running_" in k)
    return errs


def hold_ds_to_one_process(tag: str, ranks: list, control: list, one: dict,
                           tol: dict) -> dict:
    """The fp32 ranks within ``tol`` of one process; the control (BN per
    rank) above at least one bound."""
    errs = ds_rank_errors(ranks[0], one)
    print(f"  {tag} vs one process: losses {ranks[0]['losses']} vs {one['losses']}")
    over = _over(f"{tag} vs one process", errs, tol)
    if over or ranks[0]["state"]["step"] != one["state"]["step"]:
        raise RuntimeError(f"{tag}: {over} above their bounds against one process")
    cerrs = ds_rank_errors(control[0], one)
    if not _over(f"{tag}, control with BN per rank, vs one process", cerrs, tol):
        raise RuntimeError(f"{tag}: per-rank BN meets every bound; the bounds catch nothing")
    return {"ranks": errs, "control": cerrs}


def eval_tools(device: str, run_dir: str, tag: str, best: str, ssl: str, dtype: str) -> dict:
    """(c) ``test_ds`` on ``best`` and ``video_retrieval`` on ``ssl`` through
    their ``main`` in this process (as a rank where a group is joined), at
    ``dtype``, their standard output captured: the report lines each
    printed, whether this process wrote the scores and the features (paths
    of its own, ``tag``), the scores and features it wrote, the seconds."""
    import io
    import pickle

    import numpy as np
    from video_graph_ssl_tpu_torch import test_ds, video_retrieval

    scores = os.path.join(run_dir, f"phase12_scores_{dtype}_{tag}.npz")
    feats = os.path.join(run_dir, f"phase12_features_{dtype}_{tag}")
    opts = [*SYNTHETIC, "TPU.COMPUTE_DTYPE", dtype]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        test_ds.main(["--device", device, "--config_file", FT_CONFIG, "--checkpoint", best,
                      "--test_crops", "3", "--test_clips", "2", "--save_scores", scores, *opts,
                      "TEST.BATCH_SIZE", str(TEST_DS_BATCH)])
        t1 = time.perf_counter()
        video_retrieval.main([
            "--device", device, "--config_file", CONFIG, "--checkpoint", ssl,
            "--extract_feature", "--feature_dir", feats, "--test_clips", "2", "--max_videos",
            str(RETRIEVAL_VIDEOS), *opts, "TEST.BATCH_SIZE", str(RETRIEVAL_BATCH)])
    printed = out.getvalue()
    res = {"reports": printed.count("Accuracy Prec@1"), "recalls": printed.count("R@1:"),
           "seconds": (t1 - t0, time.perf_counter() - t1),
           "wrote": [p for p in (scores, feats) if os.path.exists(p)]}
    if os.path.exists(scores):
        with np.load(scores) as z:
            res["scores"], res["labels"] = z["scores"], z["labels"]
    if os.path.exists(feats):
        for split in ("train", "val"):
            with open(os.path.join(feats, f"{split}_features.pkl"), "rb") as f:
                res[split] = pickle.load(f)
    return res


def hold_eval_tools(dtype: str, ranks: list, one: dict, gpu: str) -> None:
    """(c) the ranks' test_ds and video_retrieval against one process: rank
    0 alone printed and wrote; its scores and features within TOL["fp32"]
    of one process's (bit-equal or not is printed)."""
    import numpy as np

    r0, r1 = ranks
    print(f"  (c) {dtype}: report lines printed by rank 0, rank 1: test_ds {r0['reports']}, "
          f"{r1['reports']}; retrieval R@1 {r0['recalls']}, {r1['recalls']}; files written "
          f"{len(r0['wrote'])}, {len(r1['wrote'])}; seconds (test_ds, retrieval) rank 0 "
          f"{[round(x, 1) for x in r0['seconds']]}, one process "
          f"{[round(x, 1) for x in one['seconds']]} on {gpu}")
    if (r0["reports"], r1["reports"], r0["recalls"] > 0, r1["recalls"]) != (1, 0, True, 0) \
            or len(r0["wrote"]) != 2 or r1["wrote"]:
        raise RuntimeError(f"(c) {dtype}: the report or the files are not rank 0's alone")
    if not r0["scores"].shape == one["scores"].shape == (TEST_VIDEOS, 101) \
            or not np.array_equal(r0["labels"], one["labels"]):
        raise RuntimeError(f"(c) {dtype}: scores {r0['scores'].shape}, one process's "
                           f"{one['scores'].shape}, want ({TEST_VIDEOS}, 101)")
    pairs = [("test_ds scores", r0["scores"], one["scores"])] + [
        (f"retrieval {split} features", r0[split]["features"], one[split]["features"])
        for split in ("train", "val")]
    for what, got, ref in pairs:
        same = bool(np.array_equal(got, ref))
        check(f"(c) {dtype} {what} {tuple(got.shape)}, two ranks vs one (rel-L2; bit for "
              f"bit {same})", rel_l2(torch.from_numpy(got), torch.from_numpy(ref)),
              TOL["fp32"])
    for split in ("train", "val"):
        f = r0[split]["features"]
        if f.shape[0] != RETRIEVAL_VIDEOS or not np.isfinite(f).all():
            raise RuntimeError(f"(c) {dtype}: {split} features {f.shape}, finite "
                               f"{bool(np.isfinite(f).all())}")


def phase_ds_ranks(dev, gpu: str, ssl: str, best: str) -> None:
    """(a)-(c) from a pretrain checkpoint with the graph on (the runs' own,
    as its encoder holds the graph blocks) and (c) on phase 10's
    checkpoints: its pretrain checkpoint ``ssl`` and its ``best``."""
    print("phase 12: downstream across ranks (train_ds, test_ds, video_retrieval)")
    ssl_graph = write_pretrain_checkpoint(dev, "phase12_pretrain", ["MODEL.AUG_FLAG", "True"])
    _free()
    print(f"  (a) NCCL at world size 1 against no group: the fine-tune, bs 32, 16x112x112, "
          f"bf16, graph on, {RANK_STEPS} steps, cudnn.deterministic")
    grouped = nccl_one_rank("(a) fine-tune", ds_run("finetune", "bfloat16", ssl_graph))
    _hold_counts("(a) fine-tune", grouped["counts"], ds_want("finetune"))
    del grouped
    print("  (b), (c) two ranks sharing the card (gloo), 16 rows each of the global 32: "
          "bf16 runs, fp32 runs with their per-rank-BN controls, then test_ds and "
          "video_retrieval in bf16 and fp32")
    fp32 = ("finetune", "probe reference")
    runs = [ds_run(name, "bfloat16", ssl_graph) for name in DS_RANK_RUNS]
    for name in fp32:
        runs += [ds_run(name, "float32", ssl_graph),
                 ds_run(name, "float32", ssl_graph, per_rank=True)]
    runs += [{"eval_tools": (best, ssl, dtype)} for dtype in ("bfloat16", "float32")]
    results = spawn_ranks(runs)
    for name, ranks in zip(DS_RANK_RUNS, results):
        hold_ranks(f"(b) {name}, bfloat16", ranks, gpu, SHARED, ds_want(name))
    errors = {}
    torch.backends.cudnn.deterministic = True
    try:
        for i, name in enumerate(fp32):
            tag = f"(b) {name}, float32, global bs 32"
            ranks, control = results[len(DS_RANK_RUNS) + 2 * i:len(DS_RANK_RUNS) + 2 * i + 2]
            hold_ranks(tag, ranks, gpu, SHARED, ds_want(name))
            config, opts = DS_RANK_RUNS[name]
            one = one_process_twice(SYNTHETIC + ["MODEL.AUG_FLAG", "True", "TPU.COMPUTE_DTYPE",
                                                 "float32", *opts], tag, gpu, config,
                                   ssl_graph)
            errors[name] = hold_ds_to_one_process(tag, ranks, control, one, TOL_DS_RANKS[name])
            del one
            _free()
        for dtype, ranks in zip(("bfloat16", "float32"), results[-2:]):
            hold_eval_tools(dtype, ranks, eval_tools("cuda", RUN_DIR, "one", best, ssl, dtype),
                            gpu)
            _free()
    finally:
        torch.backends.cudnn.deterministic = False
    print("phase 12 errors against one process: " + json.dumps(errors))
    # (d) K1-K4 at a rank's shapes of (b): bs 16, 16x112x112, bf16, K1 at clip 16
    k1s, k2s, pools, _ = geometry(112, 16)
    print("  (d) K1-K4 vs plain at a rank's shapes: bs 16, 16x112x112, bf16, K1 at clip 16")
    kernel_checks(dev, "(d)", k1s, k2s, pools, "bf16", clip0=16)


# --------------------------------------------------------------------------- #
# phase 13: the reference's exported 3D backbones S3DG, I3D and InceptionI3d
# (models/s3d.py with temporal_bias, models/i3d.py).  I3D pads TF "SAME":
# every strided pool pads one more on its high side than on its low side,
# and stage 13 leaves 4x4 where S3D's pool leaves 3x3, so the graph block at
# 14 sees x (128, 2, 4, 4, 832) and K1's q/k (128, 2, 1664)
I3D_K1, I3D_K2, I3D_POOLS, _ = geometry(112, 128, "I3D")
_, _, I3D_POOLS_224, _ = geometry(224, 32, "I3D")
# ragged TF "SAME" shapes (B, T, H, W, C) at each I3D pool geometry: odd and
# even T, H and W (a high pad one more than the low, and equal to it); C 12
# (bf16) or 6 (fp32), the kernel's scalar path, or 40
SAME_RAGGED = [(2, 5, 9, 7, None), (2, 8, 10, 10, None), (3, 4, 7, 6, 40)]
I3D_OPTS = ["MODEL.BACKBONE", "I3D"]


def i3d_pool_checks(dev) -> dict:
    """(a) K3/K4 at every I3D pool of the bs-128 16x112x112 step and of the
    bs-32 16x224x224 step (each with its plan; strips where a slab exceeds
    a block), fp32 and bf16: against the plain version, exactly, and
    against torch's own backward of the same pool (``ceil_mode`` with the
    low pads: the same windows); then the ragged SAME shapes, exactly; the
    kernel, plain, torch and bound times of the pool shapes S3D's step does
    not have.  Returns the largest kernel-vs-plain difference per kernel."""
    from video_graph_ssl_tpu_torch.ops import maxpool as mp

    g = torch.Generator(device=dev).manual_seed(13)
    worst = {"K3": 0.0, "K4": 0.0}
    s3d = {pool_key(shape, k, s_, p) for _, _, shape, k, s_, p in POOLS}
    rows = []
    for (name, kn, shape, k, s_, pads), dn in itertools.product(I3D_POOLS + I3D_POOLS_224,
                                                               DTYPES):
        dt = DTYPES[dn]
        lo = [p[0] for p in pads]
        ceil = any(a != b for a, b in pads)
        x = _ncdhw(shape, dev, dt, g)
        y, idx = mp.pool_forward(x, k, s_, pads, return_indices=True)
        y = y.contiguous(memory_format=CL)
        dy = torch.randn(y.shape, device=dev, generator=g).to(dt).contiguous(memory_format=CL)
        plan = mp.bwd_plan(x.shape, k, s_, pads, dt)
        tag = (f"{kn} I3D {name} {shape} pads {pads} {dn} [{plan.t_strips * plan.h_strips} "
               f"strip(s), {plan.blocks} blocks, {plan.smem_bytes} B]")
        dx = mp._launch(x, y, dy, k, s_, pads)
        err = max_abs(dx, mp.max_pool3d_bwd_plain(x, y, dy, k, s_, pads))
        check(f"{tag} vs plain (max abs)", err, 0.0)
        worst[kn] = max(worst[kn], err)

        def lib():
            return torch.ops.aten.max_pool3d_with_indices_backward(
                dy, x, list(k), list(s_), lo, [1, 1, 1], ceil, idx)

        check(f"{tag} vs torch (ceil_mode {ceil})", rel_err(dx, lib()), TOL_POOL_LIB[dn])
        if dn == "bf16" and shape[0] == 128 and pool_key(shape, k, s_, pads) not in s3d:
            tk = event_ms(lambda: mp._launch(x, y, dy, k, s_, pads))
            tp = event_ms(lambda: mp.max_pool3d_bwd_plain(x, y, dy, k, s_, pads))
            tl = event_ms(lib)
            bm, by = bound(2 * (x.numel() + y.numel()) * x.element_size(), 0, dn)
            rows.append(f"  {kn} I3D {name} {shape} pads {pads} bf16: kernel {tk:.4f} ms  "
                        f"plain {tp:.4f} ms  torch {tl:.4f} ms  bound {bm:.4f} ms ({by})  "
                        f"[{plan.slab} slabs, {plan.group}-channel groups, {plan.smem_bytes} B "
                        f"shared memory per block, {plan.blocks} blocks of {plan.threads} "
                        f"threads]")
        del x, y, idx, dy, dx
    print("  (a) the I3D pool shapes that S3D's step does not have (bs 128, 16x112x112):")
    for row in rows:
        print(row)
    geoms = sorted({(k, s_) for _, _, _, k, s_, _ in I3D_POOLS})
    for (k, s_), shape, dn in itertools.product(geoms, SAME_RAGGED, DTYPES):
        dt = DTYPES[dn]
        shape = shape[:4] + (shape[4] or (12 if dn == "bf16" else 6),)
        kn = "K3" if s_ == (1, 1, 1) else "K4"
        pads = mp.same_padding(shape[1:4], k, s_)
        x = _ncdhw(shape, dev, dt, g)
        y = mp.pool_forward(x, k, s_, pads).contiguous(memory_format=CL)
        dy = torch.randn(y.shape, device=dev, generator=g).to(dt).contiguous(memory_format=CL)
        err = max_abs(mp._launch(x, y, dy, k, s_, "SAME"),
                      mp.max_pool3d_bwd_plain(x, y, dy, k, s_, pads))
        check(f"{kn} SAME k{k} s{s_} {shape} pads {pads} {dn} vs plain (max abs)", err, 0.0)
        worst[kn] = max(worst[kn], err)
    return worst


def i3d_graph_checks(dev, gpu: str) -> None:
    """(a) K1 and K2 against their plain versions at I3D's aug point 14
    (x (128, 2, 4, 4, 832), q/k (128, 2, 1664)), fp32 and bf16, with the
    kernel and plain times in bf16."""
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.ops.temporal_graph import hop_weight_matrix

    for dn in DTYPES:
        kernel_checks(dev, "(a) I3D point 14", [I3D_K1[2]], [I3D_K2[2]], [], dn)
    g = torch.Generator(device=dev).manual_seed(14)
    b, t, d = I3D_K1[2]
    q, k = (torch.randn(b, t, d, device=dev, generator=g).to(torch.bfloat16) for _ in "qk")
    theta = torch.from_numpy(hop_weight_matrix(t, 3, 0.5)).to(dev)
    x = torch.randn(I3D_K2[2], device=dev, generator=g).to(torch.bfloat16)
    adj = torch.rand(b, t, t, device=dev, generator=g).to(torch.bfloat16)
    times_ = {
        "K1": (event_ms(lambda: gk.adjacency_fwd_kernel(q, k, theta, None, 7, 1.0, True, 0)),
               event_ms(lambda: gk._adjacency_fwd_plain(q, k, theta, None, 7, 1.0, True, 0))),
        "K2": (event_ms(lambda: gp._launch(adj, x, transpose=False)),
               event_ms(lambda: gp.propagate_plain(adj, x, transpose=False)))}
    for kn, (tk, tp) in times_.items():
        shape = I3D_K1[2] if kn == "K1" else I3D_K2[2]
        print(f"  (a) {kn} I3D point 14 {shape} bf16: kernel {tk:.4f} ms  plain {tp:.4f} ms "
              f"on {gpu}")


def inception_i3d_step(dev) -> None:
    """(c) ``InceptionI3d``: I3D's network under I3D's parameter names, one
    trainer step at full width (bs 128, 16x112x112)."""
    from video_graph_ssl_tpu_torch.models.build import create_visual_model
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config

    opts = ["MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "synthetic", "DATALOADER.BATCH_SIZE", "128"]
    c = load_config(CONFIG, opts + ["MODEL.BACKBONE", "InceptionI3d"])
    trainer = Trainer(c, max_steps=1, device=str(dev), run_dir=RUN_DIR)
    names = sorted(trainer.state.model.state_dict())
    i3d, _ = create_visual_model(load_config(CONFIG, opts + I3D_OPTS))
    if names != sorted(i3d.state_dict()):
        raise RuntimeError("InceptionI3d's parameter names differ from I3D's")
    epoch = trainer.train_loader.epoch(0)
    batch = next(epoch)
    epoch.close()
    reset_counts()
    loss = float(trainer.train_step(trainer.to_device(batch), trainer.lr_fn(0))["loss"])
    counts = read_counts()
    print(f"  (c) InceptionI3d: {len(names)} entries, I3D's names; one step at bs "
          f"{c.DATALOADER.BATCH_SIZE}, loss {loss:.4f}, kernel calls {counts}")
    if not math.isfinite(loss):
        raise RuntimeError(f"InceptionI3d step: non-finite loss {loss}")
    _hold_counts("(c) InceptionI3d", counts, _want_counts(1, backbone="InceptionI3d"))
    del trainer, i3d
    _free()


def i3d_downstream(dev, gpu: str, ssl: str, backbone: str = "I3D",
                   phase: str = "phase13") -> None:
    """(d) train_ds on configs/action_fine_tune.yaml with ``backbone`` (I3D;
    partial BN) from (c)'s checkpoint, whose graph blocks it keeps
    (``MODEL.AUG_FLAG True``): 3 steps (I3D: K3 9, K4 4, K1 3, K2 6 per
    step; ``kernel_times.step_calls``), a validation, then test_ds on its
    best checkpoint over 8 videos."""
    import numpy as np
    from video_graph_ssl_tpu_torch import test_ds

    opts = ["MODEL.BACKBONE", backbone, "MODEL.AUG_FLAG", "True"]
    r = run_downstream(dev, gpu, FT_CONFIG, opts, DS_SHORT, ssl=ssl)
    _hold_counts(f"(d) {backbone} fine-tune", r["counts"], _want_counts(
        DS_SHORT, "finetune", partial_bn=True, graph=True, backbone=backbone))
    trainer = r["trainer"]
    trainer.best_pred = -1.0
    top1 = trainer.validation(0)
    best = os.path.join(trainer.saver.experiment_dir, "model_best_state.pth.tar")
    print(f"  (d) validation: top-1 {top1:.2f}%; {best} written {os.path.exists(best)}")
    if not os.path.exists(best):
        raise RuntimeError("(d) model_best_state.pth.tar was not written")
    del trainer, r
    _free()
    scores_path = os.path.join(RUN_DIR, f"{phase}_scores.npz")
    t0 = time.perf_counter()
    rep = test_ds.main(["--device", str(dev), "--config_file", FT_CONFIG, "--checkpoint", best,
                        "--test_crops", "3", "--test_clips", "2", "--max_videos", "8",
                        "--save_scores", scores_path, *SYNTHETIC, "TEST.BATCH_SIZE", "8",
                        *opts])
    scores = np.load(scores_path)["scores"]
    print(f"  (d) test_ds ({backbone}, 8 videos x 2 clips x 3 crops): "
          f"{time.perf_counter() - t0:.1f} s, "
          f"top-1 {rep['top1']:.2f}%, scores {scores.shape}")
    if scores.shape != (8, 101) or not np.isfinite(scores).all():
        raise RuntimeError(f"(d) test_ds scores {scores.shape}, finite "
                           f"{bool(np.isfinite(scores).all())}")


# phase 13 (e): (backbone, the reference's layout, its classifier, its
# classifier's weight shape, config overrides)
REFERENCE_FILES_13 = [("I3D", "i3d", "conv3d_0c_1x1.conv3d", (400, 1024, 1, 1, 1), []),
                      ("S3DG", "s3dg", "features.18", (400, 1024, 1, 1, 1), [])]


def reference_pretrain_path(dev, gpu: str, files=REFERENCE_FILES_13,
                            ds_backbones=("I3D",), tag: str = "(e)") -> None:
    """``MODEL.PRETRAIN_PATH``: for each of ``files`` (phase 13: I3D and
    S3DG), a state_dict under the reference's names
    (``utils/torch_names.reference_backbone_names``; the classifier and
    torch BN's ``num_batches_tracked`` included, as the reference saves
    them, wrapped in ``module.``) with seeded values loads strictly into
    both of the pretrain trainer's encoders, which then take one step (bs
    32, graph off: a reference backbone holds no graph block); the files of
    ``ds_backbones`` load into ``train_ds``'s backbone too, one step."""
    from video_graph_ssl_tpu_torch.models.build import create_visual_model
    from video_graph_ssl_tpu_torch.train_ds import Trainer as DsTrainer
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config
    from video_graph_ssl_tpu_torch.utils.torch_names import reference_backbone_names

    for backbone, layout, head, head_shape, extra in files:
        opts = SYNTHETIC + ["MODEL.BACKBONE", backbone, "MODEL.AUG_FLAG", "False",
                            "DATALOADER.BATCH_SIZE", "32", *extra]
        own = create_visual_model(load_config(CONFIG, opts))[0].model.encoder.base_model
        gen = torch.Generator().manual_seed(17)
        values = {k: (torch.rand(v.shape, generator=gen) + 0.5 if "running_var" in k
                      else 0.1 * torch.randn(v.shape, generator=gen))
                  for k, v in own.state_dict().items()}
        sd = reference_backbone_names(values, layout)
        sd.update({k.rsplit(".", 1)[0] + ".num_batches_tracked": torch.tensor(10)
                   for k in list(sd) if k.endswith("running_mean")})
        sd[head + ".weight"] = torch.zeros(head_shape)
        sd[head + ".bias"] = torch.zeros(head_shape[0])
        path = os.path.join(RUN_DIR, f"reference_{backbone}.pth")
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
        c = load_config(CONFIG, opts + ["MODEL.PRETRAINED", "True", "MODEL.PRETRAIN_PATH", path])
        trainer = Trainer(c, max_steps=1, device=str(dev), run_dir=RUN_DIR)
        for model in (trainer.state.model, trainer.state.ema_model):
            got = model.model.encoder.base_model.state_dict()
            if sorted(got) != sorted(values) or not all(
                    torch.equal(got[k].cpu(), v) for k, v in values.items()):
                raise RuntimeError(f"{tag} {backbone}: the reference-named file did not load "
                                   "as written")
        epoch = trainer.train_loader.epoch(0)
        batch = next(epoch)
        epoch.close()
        loss = float(trainer.train_step(trainer.to_device(batch), trainer.lr_fn(0))["loss"])
        print(f"  {tag} {backbone}: {len(sd)} reference-named entries ({head} and the BN "
              f"counters dropped) loaded strictly into both encoders; one step, loss "
              f"{loss:.4f}")
        if not math.isfinite(loss):
            raise RuntimeError(f"{tag} {backbone}: non-finite loss {loss}")
        del trainer
        _free()
        if backbone in ds_backbones:
            ds = DsTrainer(load_config(FT_CONFIG, SYNTHETIC + [
                "MODEL.BACKBONE", backbone, *extra, "MODEL.PRETRAIN_PATH", path]),
                max_steps=1, device=str(dev), run_dir=RUN_DIR)
            got = ds.state.model.base_model.state_dict()
            if not all(torch.equal(got[k].cpu(), v) for k, v in values.items()):
                raise RuntimeError(f"{tag} train_ds: the reference-named {backbone} file did "
                                   "not load")
            epoch = ds.train_loader.epoch(0)
            clips, labels = ds.batch_to_device(next(epoch))
            epoch.close()
            loss = float(ds.train_step(clips, labels, ds.lr_fn(0))["loss"])
            print(f"  {tag} train_ds from the reference-named {backbone} file: one step, "
                  f"loss {loss:.4f}")
            if not math.isfinite(loss):
                raise RuntimeError(f"{tag} train_ds: non-finite loss {loss}")
            del ds
            _free()


def phase_backbones(dev, gpu: str) -> dict:
    print("phase 13: the reference's exported 3D backbones S3DG, I3D and InceptionI3d")
    worst = i3d_pool_checks(dev)
    _free()
    i3d_graph_checks(dev, gpu)
    _free()
    print("  (b) small steps, card vs CPU")
    for backbone in ("I3D", "S3DG"):
        small_step_parity(dev, fused=False, backbone=backbone)
        _free()
    print("  (c) the trainer at full width, configs/visual_moco.yaml, graph on")
    runs = {}
    for backbone in ("I3D", "S3DG"):
        runs[backbone] = run_trainer(dev, gpu, fused=False, backbone=backbone,
                                     save=backbone == "I3D")
    inception_i3d_step(dev)
    print("  (d) train_ds with I3D from (c)'s checkpoint")
    i3d_downstream(dev, gpu, runs["I3D"]["ckpt"])
    _free()
    print("  (e) MODEL.PRETRAIN_PATH with reference-named state_dicts")
    reference_pretrain_path(dev, gpu)
    print(json.dumps({"backbones": {b: {"ms_per_step": r["ms"], "clips_per_s": 128e3 / r["ms"],
                                        "peak_gib": r["peak_gib"], "launches": r["counts"]}
                                    for b, r in runs.items()}, "gpu": gpu}))
    return worst


# --------------------------------------------------------------------------- #
# phase 14: the 2D backbones and the 3D ResNets
# --------------------------------------------------------------------------- #
# K1/K2 at the inputs of stages 2-4 and K4 at the stem pool of R3D-18 and
# R3D-50 (bottleneck widths) in the bs-128 16x112x112 step; the stem pool
# of the bs-32 16x224x224 step (in strips)
R3D18_K1, R3D18_K2, R3D_POOLS, _ = geometry(112, 128, "resnet3d_18")
R3D50_K1, R3D50_K2, _, _ = geometry(112, 128, "resnet3d_50")
_, _, R3D_POOLS_224, _ = geometry(224, 32, "resnet3d_18")
OPTS_2D = ["MODEL.BACKBONE_TYPE", "2D"]
# (b): (backbone, overrides, frame size; Inception-v3's least is 75)
SMALL_14 = [("resnet3d_18", [], 64), ("resnet_i3d_18", [], 64), ("resnet2p1d_18", [], 64),
            ("resnet18", OPTS_2D, 64), ("bninception", OPTS_2D, 64),
            ("inception_v3", OPTS_2D, 80)]
# (e): one reference-named file per family, as in phase 13 (e)
REFERENCE_FILES_14 = [
    ("resnet3d_18", "resnet", "fc", (400, 512), []),
    ("resnet_i3d_18", "resnet", "fc", (400, 512), []),
    ("resnet2p1d_18", "resnet", "fc", (400, 512), []),
    ("resnet18", "resnet", "fc", (400, 512), OPTS_2D),
    # BN-Inception needs an even extent at inception4e: 224x224 (at 112x112
    # its branches disagree there, 4x4 against 3x3, in JAX as here)
    ("bninception", "bninception", "fc", (400, 1024),
     OPTS_2D + ["DATALOADER.BATCH_SIZE", "8", "INPUT.BASE_SIZE", "[224, 224]",
                "INPUT.SCALE_SIZE", "[256, 256]", "INPUT.CROP_SIZE", "[224, 224]"]),
    ("inception_v3", "inception_v3", "fc", (400, 2048), OPTS_2D)]
R101_BATCH = 16   # 16 clips of 16 frames: 256 frames of 224x224 per view


def resnet_kernel_times(dev, gpu: str, k1_shapes=None, k2_shapes=None, pools=None,
                        key: str = "resnet_kernels") -> None:
    """(a) times in bf16 at R3D-18's and R3D-50's shapes (or the shapes
    given, under ``key``): per call, the
    CUDA-event ms (median of 20), the bound, the plain version's ms and the
    library call's (K2: ``torch.bmm``; K4: torch's own pool backward; K1:
    none).  The kernels' device-only time at these shapes is
    ``kernel_times.py --backbone resnet3d_18`` (or ``resnet3d_50``): after
    the phases that run process groups, ``torch.profiler`` in this process
    drops device events."""
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.ops import maxpool as mp
    from video_graph_ssl_tpu_torch.ops.temporal_graph import hop_weight_matrix

    g = torch.Generator(device=dev).manual_seed(15)
    bf = torch.bfloat16
    rows = []

    def row(kn, shape, fn, plain, lib, nbytes, flops, extra=""):
        tk, tp = event_ms(fn), event_ms(plain)
        tl = event_ms(lib) if lib is not None else None
        bm, by = bound(nbytes, flops, "bf16")
        rows.append({"kernel": kn, "shape": list(shape), "ms": tk, "bound_ms": bm,
                     "bound_by": by, "plain_ms": tp, "library_ms": tl})
        print(f"  (a) {kn} {shape} bf16{extra}: kernel {tk:.4f} ms  plain {tp:.4f} ms  "
              f"library {'%.4f ms' % tl if tl is not None else 'none'}  "
              f"bound {bm:.4f} ms ({by}) on {gpu}")

    if k1_shapes is None:
        k1_shapes, k2_shapes = R3D18_K1 + R3D50_K1, R3D18_K2 + R3D50_K2
        pools = R3D_POOLS + R3D_POOLS_224
    for b, t, d in k1_shapes:
        theta = torch.from_numpy(hop_weight_matrix(t, 3, 0.5)).to(dev)
        q, k = ((torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(bf)
                for _ in "qk")
        row("K1", (b, t, d), lambda: gk.adjacency_fwd_kernel(q, k, theta, None, 7, 1.0, True, 0),
            lambda: gk._adjacency_fwd_plain(q, k, theta, None, 7, 1.0, True, 0), None,
            2 * q.numel() * 2 + 4 * t * t + 3 * 4 * b * t * t, 2 * b * t * t * d)
    for shape in k2_shapes:
        b, t = shape[:2]
        x = torch.randn(shape, device=dev, generator=g).to(bf)
        adj = torch.rand(b, t, t, device=dev, generator=g).to(bf)
        row("K2", shape, lambda: gp._launch(adj, x, transpose=False),
            lambda: gp.propagate_plain(adj, x), lambda: torch.bmm(adj, x.view(b, t, -1)),
            (2 * x.numel() + adj.numel()) * 2, 2 * t * x.numel())
        del x, adj
    for name, kn, shape, k, s_, p in pools:
        import torch.nn.functional as F
        x = _ncdhw(shape, dev, bf, g)
        y, idx = F.max_pool3d(x, k, s_, p, return_indices=True)
        y = y.contiguous(memory_format=CL)
        dy = torch.randn(y.shape, device=dev, generator=g).to(bf).contiguous(memory_format=CL)
        plan = mp.bwd_plan(x.shape, k, s_, p, bf)
        row("K4", shape, lambda: mp._launch(x, y, dy, k, s_, p),
            lambda: mp.max_pool3d_bwd_plain(x, y, dy, k, s_, p),
            lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                dy, x, list(k), list(s_), list(p), [1, 1, 1], False, idx),
            2 * (x.numel() + y.numel()) * 2, 0,
            f" {name} [{plan.t_strips} x {plan.h_strips} strips of {plan.t_strip} frames x "
            f"{plan.h_strip} rows, {plan.blocks} blocks, {plan.smem_bytes} B]")
        del x, y, idx, dy
        _free()
    print(json.dumps({key: rows, "gpu": gpu}))


def avg_pool_check(dev) -> None:
    """(b) the 2D Inception nets' 3x3/1 average pool on the card, a
    channels-last input and a contiguous cotangent: the library's own CUDA
    backward and ``layers.avg_pool3x3``'s (its forward both ways), each
    against the CPU's; the first is printed, the second held to
    ``TOL["fp32"]``."""
    import torch.nn.functional as F
    from video_graph_ssl_tpu_torch.models.layers import avg_pool3x3

    g = torch.Generator().manual_seed(16)
    x = torch.randn(64, 32, 17, 16, generator=g).contiguous(memory_format=torch.channels_last)
    gy = torch.randn(64, 32, 17, 16, generator=g)

    def grad(fn, d):
        xd = x.to(d).detach().requires_grad_()
        (fn(xd) * gy.to(d)).sum().backward()
        return xd.grad.cpu()

    def lib(t):
        return F.avg_pool2d(t, 3, 1, 1)

    ref = grad(lib, "cpu")
    print(f"  (b) F.avg_pool2d(x, 3, 1, 1)'s own backward on the card (channels-last x): "
          f"rel-L2 {rel_l2(grad(lib, dev), ref):.3e} against the CPU's")
    check("(b) layers.avg_pool3x3 backward, card vs CPU (rel-L2)",
          rel_l2(grad(avg_pool3x3, dev), ref), TOL["fp32"])


def resnet_downstream(dev, gpu: str, r3d_ckpt: str) -> None:
    """(d) train_ds on configs/action_fine_tune.yaml (partial BN, bs 32,
    16x112x112, bf16): R3D-18 from (c)'s checkpoint with its graph blocks
    (K1 3, K2 6, K4 1 per step), then ResNet-50 2D (no kernel), 3 steps
    each; ResNet-50's validation and best checkpoint, and test_ds's eval
    forward on it over 8 videos."""
    import numpy as np
    from video_graph_ssl_tpu_torch import test_ds

    opts = ["MODEL.BACKBONE", "resnet3d_18", "MODEL.AUG_FLAG", "True"]
    r = run_downstream(dev, gpu, FT_CONFIG, opts, DS_SHORT, ssl=r3d_ckpt)
    _hold_counts("(d) R3D-18 fine-tune", r["counts"], _want_counts(
        DS_SHORT, "finetune", partial_bn=True, graph=True, backbone="resnet3d_18"))
    del r
    _free()
    opts = ["MODEL.BACKBONE", "resnet50", *OPTS_2D]
    r = run_downstream(dev, gpu, FT_CONFIG, opts, DS_SHORT)
    _hold_counts("(d) ResNet-50 2D fine-tune", r["counts"], _want_counts(
        DS_SHORT, "finetune", partial_bn=True, backbone="resnet50"))
    trainer = r["trainer"]
    trainer.best_pred = -1.0
    top1 = trainer.validation(0)
    best = os.path.join(trainer.saver.experiment_dir, "model_best_state.pth.tar")
    print(f"  (d) ResNet-50 2D validation: top-1 {top1:.2f}%; {best} written "
          f"{os.path.exists(best)}")
    if not os.path.exists(best):
        raise RuntimeError("(d) model_best_state.pth.tar was not written")
    del trainer, r
    _free()
    scores_path = os.path.join(RUN_DIR, "phase14_scores.npz")
    t0 = time.perf_counter()
    rep = test_ds.main(["--device", str(dev), "--config_file", FT_CONFIG, "--checkpoint", best,
                        "--test_crops", "3", "--test_clips", "2", "--max_videos", "8",
                        "--save_scores", scores_path, *SYNTHETIC, "TEST.BATCH_SIZE", "8",
                        *opts])
    scores = np.load(scores_path)["scores"]
    print(f"  (d) test_ds (ResNet-50 2D, 8 videos x 2 clips x 3 crops): "
          f"{time.perf_counter() - t0:.1f} s, top-1 {rep['top1']:.2f}%, scores {scores.shape}")
    if scores.shape != (8, 101) or not np.isfinite(scores).all():
        raise RuntimeError(f"(d) test_ds scores {scores.shape}, finite "
                           f"{bool(np.isfinite(scores).all())}")


def phase_resnets(dev, gpu: str) -> None:
    print("phase 14: the 2D backbones and the 3D ResNets")
    for dn in DTYPES:
        kernel_checks(dev, "(a) R3D-18", R3D18_K1, R3D18_K2, R3D_POOLS + R3D_POOLS_224, dn)
        _free()
        kernel_checks(dev, "(a) R3D-50", R3D50_K1, R3D50_K2, [], dn)
        _free()
    resnet_kernel_times(dev, gpu)
    _free()
    print("  (b) small steps, card vs CPU")
    avg_pool_check(dev)
    for backbone, opts, size in SMALL_14:
        small_step_parity(dev, fused=False, backbone=backbone, opts=opts, size=size)
        _free()
    print("  (c) GCA MoCo through the trainer, configs/visual_moco.yaml, MODEL.AUG_FLAG True")
    runs = {"resnet3d_18": run_trainer(dev, gpu, fused=False, backbone="resnet3d_18",
                                       save=True),
            "resnet101": run_trainer(dev, gpu, fused=False, bsz=R101_BATCH, size=224,
                                     backbone="resnet101", opts=OPTS_2D)}
    if runs["resnet3d_18"]["graph_blocks"] != 3 or runs["resnet101"]["graph_blocks"] != 0:
        raise RuntimeError(f"graph blocks: R3D-18 {runs['resnet3d_18']['graph_blocks']} "
                           f"(want 3), ResNet-101 2D {runs['resnet101']['graph_blocks']} "
                           "(want 0)")
    print("  (d) train_ds and test_ds")
    resnet_downstream(dev, gpu, runs["resnet3d_18"]["ckpt"])
    _free()
    print("  (e) MODEL.PRETRAIN_PATH with reference-named state_dicts, one per family")
    reference_pretrain_path(dev, gpu, REFERENCE_FILES_14,
                            ds_backbones=[f[0] for f in REFERENCE_FILES_14])
    bsz = {"resnet3d_18": 128, "resnet101": R101_BATCH}
    print(json.dumps({"resnets": {b: {"ms_per_step": r["ms"],
                                      "clips_per_s": bsz[b] * 1e3 / r["ms"],
                                      "peak_gib": r["peak_gib"], "launches": r["counts"]}
                                  for b, r in runs.items()}, "gpu": gpu}))


# --------------------------------------------------------------------------- #
# phase 15: K5 across ranks (its BN sums summed over the ranks between its
# three stages), the solver options and the input modalities.
FUSED = ["TPU.SEPCONV_FUSED", "True"]
# the pairs of stages 5, 9 and 14 (Mixed_3b, 4c, 5b) in the bs-32 step
K5_RANK_PAIRS = [row for row in SEPCONVS_112_32 if row[0].split()[0] in ("3b", "4c", "5b")]
# (c): the fused MoCo step's fp32 run on two ranks against one process is
# held to phase 8's bounds but for step 3's update norm: by step 3 the
# amplified rounding has grown further along the fused pairs' fp32
# statistics than along cuDNN's BN.  Readings on an H100 80GB HBM3 (700 W),
# deterministic: keys 1.1e-4, 4.8e-3, 0.139; losses 3.3e-5, 2.6e-2, 2.2e-2;
# update_1 2.5e-2, update_1_norm 6.1e-3, update_3 0.913, update_3_norm
# 0.254; ema_bn 7.9e-3 (phase 8's unfused step: 8.9e-5 .. 5.8e-2 and 0.97
# at update_3).
TOL_RANKS_FUSED = {**TOL_RANKS["float32"], "update_3_norm": 0.5}
# (d): the fused fine-tune (every pair's BNs live) in fp32 on two ranks
# against one process (sum-form BN); at initialisation all BNs live amplify
# the summation order as in phase 8's MoCo step, so the bounds are phase 8's
# fp32 ones for the updates and BN statistics and a blow-up bound for the
# losses, which sit near ln 101 whatever the update.  Readings on an H100
# 80GB HBM3 (700 W), ranks / control: losses 2.1e-7, 3.2e-4, 2.2e-4 /
# 4.9e-4, 2.8e-4, 3.8e-4; update_1 0.101 / 1.52, update_1_norm 1.4e-2 /
# 9.9e-2, update_3 0.803 / 1.51, update_3_norm 0.132 / 6.0e-2; bn 1.7e-2 /
# 5.3e-2.  The same fine-tune without K5 reads update_1 9.9e-2, update_3
# 0.844, bn 1.6e-2 (printed beside it): the amplification is BN's, not K5's.
TOL_FUSED_FT = {"loss_1": 1e-4, "loss_2": 1e-2, "loss_3": 1e-2, "update_1": 0.2,
                "update_1_norm": 5e-2, "update_3": 1.5, "update_3_norm": 0.2, "bn": 5e-2}
# (e): SOLVER.OPTIMIZER_NAME, USE_TRICK, CLIP_GRADIENT (and BASE_LR for Adam)
SOLVER_RUNS = [("SGD", False, None), ("SGD", True, None), ("Adam", False, None),
               ("AdamW", False, None), ("LARS", False, None), ("LARS", True, None),
               ("Adam", False, 1.0)]
TOL_UPDATE = 1e-6
# (f): stacked frames per time step and the clips' channels
MODALITY_RUNS = [("Flow", 5, 10), ("RGBDiff", 5, 18)]


def k5_rank_pairs(device: str, rank: int, world: int, dn: str) -> list:
    """15 (b): the staged K5 on this rank's rows of each pair of
    ``K5_RANK_PAIRS`` (inputs of the global batch drawn from one seed on
    every rank), its BN sums summed over the ranks between the stages;
    per pair (dx, dWs, dWt, dgamma1, dbeta1, dgamma2, dbeta2) on the CPU and
    the reductions the calls made."""
    from video_graph_ssl_tpu_torch.ops import sepconv_bwd as sb
    from video_graph_ssl_tpu_torch.parallel import sync_bn

    out = []
    for i, (_, bthw, c, f) in enumerate(K5_RANK_PAIRS):
        g = torch.Generator(device=device).manual_seed(1500 + i)
        x, ws, wt, g1, b1, g2, b2, mu1, var1, mu2, var2, gy, dt = sepconv_inputs(
            (*bthw, c, f), device, DTYPES[dn], g)
        b = bthw[0]
        rows = slice(rank * b // world, (rank + 1) * b // world)
        count = torch.full((f,), float(math.prod(bthw)), device=device)
        local = (x[rows], ws, wt, g1, b1, g2, b2, mu1, var1, mu2, var2, gy[rows], dt)
        r0 = tracing.counters()["sepconv_reduces"]
        got = sb.sepconv_bwd(*local, count=count, reduce=sync_bn.all_reduce_sums)
        res = {"grads": _cpu(got), "reduces": tracing.counters()["sepconv_reduces"] - r0}
        if dn == "bf16":   # every rank makes the same calls, so the collectives pair up

            def call():
                sb.sepconv_bwd(*local, count=count, reduce=sync_bn.all_reduce_sums)

            # CUDA events only: torch.profiler in a rank process sharing the
            # card records no kernel on some runs
            res["ms"] = event_ms(call, iters=10)
        out.append(res)
    return out


def staged_k5(dev) -> None:
    """15 (a): the staged call (the wrapper's three C entries) against the
    one call of all three stages, bit for bit, and against the plain
    version, at the 18 pairs of the bs-128 and bs-32 16x112x112 steps in
    both dtypes; the two per encoder pass (bs 128, bf16): CUDA-event ms and
    the memory the pass's gradients hold."""
    from video_graph_ssl_tpu_torch.ops import fused_sepconv as fs
    from video_graph_ssl_tpu_torch.ops import sepconv_bwd as sb

    names = ["dx", "dWs", "dWt", "dg1", "db1", "dg2", "db2"]
    g = torch.Generator(device=dev).manual_seed(15)
    equal, worst = 0, {dn: 0.0 for dn in DTYPES}
    for tag, pairs in (("bs 128", SEPCONVS), ("bs 32", SEPCONVS_112_32)):
        for (name, bthw, c, f), (dn, dt) in itertools.product(pairs, DTYPES.items()):
            args = sepconv_inputs((*bthw, c, f), dev, dt, g)
            s0 = tracing.counters()["sepconv_stage_calls"]
            staged = sb.sepconv_bwd(*args)
            calls = tracing.counters()["sepconv_stage_calls"] - s0
            if calls != 3:
                raise RuntimeError(f"K5 {name}: {calls} stage calls, want 3")
            one = sb.sepconv_bwd_one_call(*args)
            bad = [n for n, a, b in zip(names, staged, one) if not torch.equal(a, b)]
            if bad:
                raise RuntimeError(f"K5 {tag} {name} {dn}: staged != one call at {bad}")
            equal += 1
            want = fs.bwd_reference(*args)
            for n, a, r in zip(names, staged, want):
                err = rel_l2(a, r)
                worst[dn] = max(worst[dn], err)
                if not err <= TOL_K5[dn]:
                    raise RuntimeError(f"K5 {tag} {name} {dn} {n}: rel-L2 {err:.3e} above "
                                       f"{TOL_K5[dn]}")
            del args, staged, one, want
    print(f"  (a) staged K5 == one call, bit for bit, at {equal} pair x dtype x batch cases "
          f"(18 pairs, bs 128 and 32, fp32 and bf16); against the plain version worst "
          f"rel-L2 fp32 {worst['fp32']:.3e} (tol {TOL_K5['fp32']}), bf16 "
          f"{worst['bf16']:.3e} (tol {TOL_K5['bf16']})")
    args = [sepconv_inputs((*bthw, c, f), dev, torch.bfloat16, g)
            for _, bthw, c, f in SEPCONVS]
    ms = {"staged": 0.0, "one call": 0.0}
    for a in args:
        for key, fn in (("staged", sb.sepconv_bwd), ("one call", sb.sepconv_bwd_one_call)):
            ms[key] += event_ms(lambda: fn(*a), iters=10)
    host = {key: host_us(lambda: fn(*args[0])) for key, fn in
            (("staged", sb.sepconv_bwd), ("one call", sb.sepconv_bwd_one_call))}
    held = {}
    for key, fn in (("one call", sb.sepconv_bwd_one_call), ("staged", sb.sepconv_bwd)):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = [fn(*a) for a in args]
        torch.cuda.synchronize()
        held[key] = ((torch.cuda.max_memory_allocated() - base) / 2 ** 20,
                     (torch.cuda.memory_allocated() - base) / 2 ** 20)
        del grads
    print(f"  (a) K5 per encoder pass (18 pairs, bs 128, 16x112x112, bf16; CUDA events, "
          f"median of 10 per pair): staged {ms['staged']:.3f} ms, one call "
          f"{ms['one call']:.3f} ms (device time: phase 5); wrapper host time per call at "
          f"{SEPCONVS[0][0]}: "
          f"staged {host['staged']:.1f} us, one call {host['one call']:.1f} us")
    for key, (peak, kept) in held.items():
        print(f"  (a) K5 memory over one pass, {key}: peak {peak:.1f} MiB above the inputs, "
              f"{kept:.1f} MiB held by the 18 calls' outputs")
    if not held["staged"][1] < held["one call"][1]:
        raise RuntimeError(f"K5: the staged outputs hold {held['staged'][1]:.1f} MiB, the "
                           f"one call's {held['one call'][1]:.1f} MiB (its scratch)")
    del args


def hold_k5_ranks(dev, results: list) -> None:
    """15 (b): each rank's dx rows, and the sums over the ranks of dWs, dWt
    and the BN sums, against one process's staged K5 over the whole batch."""
    from video_graph_ssl_tpu_torch.ops import sepconv_bwd as sb

    names = ["dx", "dWs", "dWt", "dg1", "db1", "dg2", "db2"]
    for dn, ranks in zip(DTYPES, results):
        for i, (name, bthw, c, f) in enumerate(K5_RANK_PAIRS):
            g = torch.Generator(device=dev).manual_seed(1500 + i)
            one = _cpu(sb.sepconv_bwd(*sepconv_inputs((*bthw, c, f), dev, DTYPES[dn], g)))
            b, world = bthw[0], len(ranks)
            errs = {}
            for j, n in enumerate(names):
                if n == "dx":
                    errs[n] = max(rel_l2(r[i]["grads"][0], one[0][k * b // world:
                                                                  (k + 1) * b // world])
                                  for k, r in enumerate(ranks))
                else:
                    errs[n] = rel_l2(sum(r[i]["grads"][j].double() for r in ranks), one[j])
            reduces = [r[i]["reduces"] for r in ranks]
            if dn == "bf16":
                whole = sepconv_inputs((*bthw, c, f), dev, DTYPES[dn],
                                       torch.Generator(device=dev).manual_seed(1500 + i))
                one_ms = event_ms(lambda: sb.sepconv_bwd(*whole), iters=10)
                print(f"  (b) K5 {name} bf16 per call: ranks " + ", ".join(
                    f"{r[i]['ms']:.4f} ms" for r in ranks)
                      + f"; one process over the whole batch {one_ms:.4f} ms")
                del whole
            print(f"  (b) K5 {name} {bthw} {c}->{f} {dn}, {world} ranks of {b // world} rows: "
                  + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
                  + f"; reductions per rank {reduces}")
            if reduces != [2] * world:
                raise RuntimeError(f"K5 {name}: reductions {reduces}, want 2 per rank")
            for n, e in errs.items():
                check(f"(b) K5 {name} {dn} {n} ranks vs one process (rel-L2)", e, TOL_K5[dn])


def solver_update(dev, c) -> float:
    """15 (e): one optimizer update of ``c``'s S3D VideoModel from fixed
    gradients, on the card and on the CPU from the same weights and
    gradients (the trainers' order: clip, lr, step): rel-L2 of the card's
    update against the CPU's."""
    from video_graph_ssl_tpu_torch.models.build import create_video_model
    from video_graph_ssl_tpu_torch.models.layers import place
    from video_graph_ssl_tpu_torch.solver.build import (clip_by_global_norm_, grad_clip_norm,
                                                        make_optimizer, set_learning_rate)

    updates = []
    for d in (torch.device("cpu"), dev):
        model = place(create_video_model(c)[0], d)
        p0 = [p.detach().cpu().double() for p in model.parameters()]
        g = torch.Generator().manual_seed(7)
        for p in model.parameters():
            p.grad = torch.empty_like(p).copy_(torch.randn(p.shape, generator=g).to(d))
        opt = make_optimizer(c, model)
        if grad_clip_norm(c) is not None:
            clip_by_global_norm_(model.parameters(), grad_clip_norm(c))
        set_learning_rate(opt, float(c.SOLVER.BASE_LR))
        opt.step()
        updates.append(torch.cat([(p.detach().cpu().double() - q).flatten()
                                  for p, q in zip(model.parameters(), p0)]))
        del model, opt
    return rel_l2(updates[1], updates[0])


def solver_options(dev, gpu: str, ssl: str) -> None:
    """15 (e): three fine-tune steps per solver option (S3D, bs 32,
    16x112x112, bf16, graph on), and its update on the card against the
    CPU."""
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    for name, trick, clip in SOLVER_RUNS:
        opts = ["MODEL.AUG_FLAG", "True", "SOLVER.OPTIMIZER_NAME", name,
                "SOLVER.USE_TRICK", str(trick),
                "SOLVER.CLIP_GRADIENT", "none" if clip is None else str(clip)]
        if name in ("Adam", "AdamW"):
            opts += ["SOLVER.BASE_LR", "0.001"]
        r = run_downstream(dev, gpu, FT_CONFIG, opts, DS_SHORT, ssl)
        _hold_counts(f"(e) {name}", r["counts"], _want_counts(DS_SHORT, "finetune",
                                                              partial_bn=True, graph=True))
        opt = r["trainer"].state.optimizer
        labels = sorted({g_.get("label", "") for g_ in opt.param_groups})
        del r
        _free()
        err = solver_update(dev, load_config(FT_CONFIG, SYNTHETIC + opts))
        check(f"(e) {name} trick {trick} clip {clip}: card update vs CPU (rel-L2)", err,
              TOL_UPDATE)
        print(f"  (e) {name} ({type(opt).__name__}), groups {labels}")
        _free()


def modality_steps(dev, gpu: str) -> None:
    """15 (f): Flow and RGBDiff fine-tune steps at full S3D width (graph on,
    bs 32, 16x112x112, bf16) through the fused downstream step on uint8
    clips of their channel counts; an inflated RGB pretrain state in the
    Flow model; the stem's time at 10 input channels against 3."""
    from video_graph_ssl_tpu_torch.engine.build import create_downstream_state
    from video_graph_ssl_tpu_torch.engine.downstream import make_fused_downstream_step
    from video_graph_ssl_tpu_torch.models.build import create_video_model, create_visual_model
    from video_graph_ssl_tpu_torch.train_ds import bn_train_of
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config
    from video_graph_ssl_tpu_torch.utils.inflate import inflate_first_conv

    want = _want_counts(DS_SHORT, "finetune", partial_bn=True, graph=True)
    stems = {}
    for modality, nl, chans in MODALITY_RUNS:
        c = load_config(FT_CONFIG, SYNTHETIC + ["MODEL.AUG_FLAG", "True", "INPUT.MODALITY",
                                                modality, "INPUT.NEW_LENGTH", str(nl)])
        state = create_downstream_state(c, create_video_model(c)[0], dev)
        step = make_fused_downstream_step(c, bn_train_of(c))
        canvas = [int(s) for s in c.INPUT.SCALE_SIZE]
        g = torch.Generator(device=dev).manual_seed(16)
        clips = torch.randint(0, 256, (32, 16, *canvas, chans), generator=g, device=dev,
                              dtype=torch.uint8)
        labels = torch.randint(0, int(c.DATASET.NUM_CLASS), (32,), generator=g, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ms, losses = [], []
        for _ in range(DS_SHORT):
            t0 = time.perf_counter()
            losses.append(float(step(state, clips, labels, 0.01)["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        stem = state.model.base_model.base[0]
        print(f"  (f) {modality} NEW_LENGTH {nl} ({chans} channels per clip, stem "
              f"{tuple(stem.conv_s.weight.shape)}): step host ms {[round(x, 1) for x in ms]}, "
              f"losses {[round(x, 4) for x in losses]}, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {gpu}; kernel "
              f"calls {counts}")
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"(f) {modality}: non-finite loss {losses}")
        _hold_counts(f"(f) {modality}", counts, want)
        stems[stem.conv_s.weight.shape[1]] = stem
        del state, step, clips
        _free()
    # the stem (SepConv3d 7x7x7 / 2, 64 channels, in the compute dtype) at 3
    # input channels and at Flow's 10: forward and backward, CUDA events
    rgb = load_config(FT_CONFIG, SYNTHETIC + ["MODEL.AUG_FLAG", "True"])
    stems[3] = create_video_model(rgb)[0].base_model.base[0]
    for cin in (3, 10):
        stem = stems[cin].to(dev).train()
        x = torch.randn(32, cin, 16, 112, 112, device=dev).contiguous(memory_format=CL)

        def fwd_bwd():
            stem.zero_grad(set_to_none=True)
            stem(x).float().sum().backward()

        print(f"  (f) stem at {cin} input channels (bs 32, 16x112x112, "
              f"{str(stem.dtype).split('.')[-1]}): forward + backward "
              f"{event_ms(fwd_bwd, iters=10):.3f} ms (CUDA events) on {gpu}")
        del x
    # an RGB pretrain state, inflated, loads strictly into the Flow model
    flow = load_config(CONFIG, SYNTHETIC + ["MODEL.AUG_FLAG", "True", "INPUT.MODALITY", "Flow",
                                            "INPUT.NEW_LENGTH", "5"])
    rgb_sd = create_visual_model(load_config(CONFIG, SYNTHETIC + ["MODEL.AUG_FLAG", "True"])
                                 )[0].state_dict()
    model, _ = create_visual_model(flow)
    model.load_state_dict(inflate_first_conv(rgb_sd, 10), strict=True)
    print("  (f) an RGB S3D pretrain state inflated to 10 input channels loads strictly into "
          "the Flow model")


def phase_fused_ranks(dev, gpu: str) -> None:
    """Phase 15 (a)-(f)."""
    print("phase 15: K5 across ranks, the solver options, the input modalities")
    staged_k5(dev)
    _free()
    ssl = write_pretrain_checkpoint(dev, "phase15_pretrain", ["MODEL.AUG_FLAG", "True"])
    _free()
    moco_fp32 = rank_opts(32, "float32") + FUSED
    moco_bf16 = rank_opts(128, "bfloat16") + FUSED
    ft = SYNTHETIC + ["MODEL.AUG_FLAG", "True", "MODEL.NO_PARTIALBN", "True", *FUSED]
    ft_want = _want_counts(RANK_STEPS, "finetune", fused=True, partial_bn=False, graph=True)
    # (d)'s fp32 comparison without K5, for reference (not gated)
    ft_unfused = SYNTHETIC + ["MODEL.AUG_FLAG", "True", "MODEL.NO_PARTIALBN", "True",
                              "TPU.COMPUTE_DTYPE", "float32"]
    print(f"  (c) NCCL at world size 1 against no group: the fused MoCo step, bs 128, "
          f"16x112x112, bf16, graph on, {RANK_STEPS} steps, cudnn.deterministic")
    grouped = nccl_one_rank("(c) fused MoCo", rank_run(moco_bf16))
    _hold_counts("(c) fused MoCo", grouped["counts"], _want_counts(fused=True))
    del grouped
    _free()
    print("  (b)-(d) two ranks sharing the card (gloo): K5 at the stage-5, 9 and 14 pairs "
          "(bs 32, 16 rows each); the fused MoCo step (fp32 bs 32 with its per-rank-BN "
          "control, bf16 bs 128); the fused fine-tune with MODEL.NO_PARTIALBN (bf16, then "
          "fp32 with its control)")
    runs = [{"k5_pairs": dn} for dn in DTYPES]
    runs += [rank_run(moco_fp32), rank_run(moco_fp32, per_rank=True), rank_run(moco_bf16),
             rank_run(ft + ["TPU.COMPUTE_DTYPE", "bfloat16"], FT_CONFIG, ssl=ssl),
             rank_run(ft + ["TPU.COMPUTE_DTYPE", "float32"], FT_CONFIG, ssl=ssl),
             rank_run(ft + ["TPU.COMPUTE_DTYPE", "float32"], FT_CONFIG, per_rank=True,
                      ssl=ssl),
             rank_run(ft_unfused, FT_CONFIG, ssl=ssl)]
    results = spawn_ranks(runs)
    hold_k5_ranks(dev, results[:2])
    errors = {}
    torch.backends.cudnn.deterministic = True
    try:
        tag = "(c) two ranks, fused MoCo, float32, global bs 32"
        ranks, control, bf16 = results[2:5]
        hold_ranks(tag, ranks, gpu, SHARED, _want_counts(fused=True))
        one = one_process_twice(moco_fp32, tag, gpu)
        errors["moco float32"] = hold_to_one_process(tag, ranks, one, 32, TOL_RANKS_FUSED)
        errors["moco float32 control"] = control_fails(tag, control, one, 32,
                                                       TOL_RANKS_FUSED)
        del one
        _free()
        hold_ranks("(c) two ranks, fused MoCo, bfloat16, global bs 128", bf16, gpu, SHARED,
                   _want_counts(fused=True))
        ft_bf16, ft_fp32, ft_control = results[5:8]
        hold_ranks("(d) two ranks, fused fine-tune, bfloat16, global bs 32", ft_bf16, gpu,
                   SHARED, ft_want)
        tag = "(d) two ranks, fused fine-tune, float32, global bs 32"
        hold_ranks(tag, ft_fp32, gpu, SHARED, ft_want)
        one = one_process_twice(ft + ["TPU.COMPUTE_DTYPE", "float32"], tag, gpu, FT_CONFIG,
                                ssl)
        errors["finetune float32"] = hold_ds_to_one_process(tag, ft_fp32, ft_control, one,
                                                            TOL_FUSED_FT)
        del one
        _free()
        one = one_process_twice(ft_unfused, "(d) the same without TPU.SEPCONV_FUSED", gpu,
                                FT_CONFIG, ssl)
        unfused = ds_rank_errors(results[8][0], one)
        errors["finetune float32 without K5"] = unfused
        print("  (d) the same fp32 fine-tune without TPU.SEPCONV_FUSED, ranks vs one process "
              "(for reference): " + ", ".join(f"{k} {v:.3e}" for k, v in unfused.items()))
        del one
    finally:
        torch.backends.cudnn.deterministic = False
    del results
    _free()
    print("phase 15 errors against one process: " + json.dumps(errors))
    solver_options(dev, gpu, ssl)
    modality_steps(dev, gpu)


# --------------------------------------------------------------------------- #
# phase 16: CMC (CROSS.MODALITY cross), two-modality MoCo and bank: two full
# S3D stacks with graph blocks at 5, 9, 14, model_2 on the clips' temporal
# differences, at the configs/visual_moco.yaml geometry (bs 128,
# 16x112x112, bf16, NCE_K 16384); the bank at phase 9's (K 65536 over
# 240,000 rows per modality, crossentropy).
CMC_OPTS = ["MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "synthetic", "CROSS.MODALITY", "cross"]
CMC_RUNS = {
    "moco": CMC_OPTS + ["DATALOADER.BATCH_SIZE", "128"],
    "bank": CMC_OPTS + ["CONTRAST.MEM_TYPE", "bank", "CONTRAST.NCE_K", "65536",
                        "DATASET.NUM_CLASS", str(KINETICS_CLIPS // 4),
                        "DATALOADER.BATCH_SIZE", "128"],
}
# the launches per step recorded before the first chip run (PERF.md §6):
# twice the visual MoCo step's, one encoder stack each
CMC_PREDICTED = {"graph_adjacency": 12, "gcn_propagate": 18, "maxpool_bwd_s1": 18,
                 "maxpool_bwd_strided": 8, "sepconv_bwd": 0,
                 "maxpool_fwd": 52}   # the pool forward's kernel, added with it
CMC_PREDICTED_FUSED = {**CMC_PREDICTED, "sepconv_bwd": 36}
CMC_STEPS = 5          # (c): 2 warm-up, 3 timed


def model2_kernel_inputs(dev, dn: str) -> list:
    """model_2 of a full-width CMC model (dn compute) forward and backward on
    the temporal differences of one augmented synthetic batch of 128 clips
    (view 1, as the query pass sees it), every K1, K2 and K3/K4 call's
    inputs recorded: [(kernel, args)]."""
    from video_graph_ssl_tpu_torch.data.build import build_video_contrastive_loader
    from video_graph_ssl_tpu_torch.data.pipeline import to_device
    from video_graph_ssl_tpu_torch.data.transforms_device import make_batch_augment_fn
    from video_graph_ssl_tpu_torch.models.build import create_visual_model
    from video_graph_ssl_tpu_torch.models.layers import place
    from video_graph_ssl_tpu_torch.models.wrappers import temporal_diff
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    gk, gp, mp, _ = _kernel_modules()
    dtype = {"fp32": "float32", "bf16": "bfloat16"}[dn]
    c = load_config(CONFIG, CMC_RUNS["moco"] + ["TPU.COMPUTE_DTYPE", dtype])
    loader, _ = build_video_contrastive_loader(c)
    epoch = loader.epoch(0)
    raw = to_device(next(epoch)["clips"], dev)
    epoch.close()
    gen = torch.Generator(device=dev).manual_seed(5)
    with torch.no_grad():
        x = temporal_diff(make_batch_augment_fn(c, "ssl")(gen, raw)[:, 0])
    xf = x.float()
    print(f"  (a) {dn}: model_2's input, the temporal differences of 128 augmented clips "
          f"{tuple(x.shape)} {x.dtype}: mean {float(xf.mean()):+.4f}, std "
          f"{float(xf.std()):.4f}, share below 0 {float((xf < 0).float().mean()):.3f}")
    model = place(create_visual_model(c)[0], dev).train()
    records = []
    k1, k2, pool = gk.adjacency_fwd_kernel, gp._launch, mp._launch

    def rec_k1(q, k, theta, u, seed, temperature, sample, nei_size, u_out=None, rows=None):
        records.append(("K1", (q.detach().clone(), k.detach().clone(), theta, u, seed,
                               temperature, sample, nei_size, rows)))
        return k1(q, k, theta, u, seed, temperature, sample, nei_size, u_out=u_out, rows=rows)

    def rec_k2(adj, xx, transpose):
        records.append(("K2", (adj.detach().clone(), xx.detach().clone(), transpose)))
        return k2(adj, xx, transpose)

    def rec_pool(xx, y, dy, k, s_, p):
        kn = "K3" if tuple(s_) == (1, 1, 1) else "K4"
        records.append((kn, (xx.detach().clone(), y.detach().clone(), dy.detach().clone(),
                             k, s_, p)))
        return pool(xx, y, dy, k, s_, p)

    gk.adjacency_fwd_kernel, gp._launch, mp._launch = rec_k1, rec_k2, rec_pool
    try:
        f2 = model.model_2(x, graph_seed=17)
        g = torch.randn(f2.shape, device=dev, generator=gen)
        (f2.float() * g).sum().backward()
        torch.cuda.synchronize()
    finally:
        gk.adjacency_fwd_kernel, gp._launch, mp._launch = k1, k2, pool
    del model, f2, raw, x, xf
    return records


def cmc_kernel_checks(dev) -> dict:
    """(a) K1-K4 against their plain versions at the inputs model_2 gives
    them (``model2_kernel_inputs``), fp32 and bf16: K1's draw and its
    closed-form backward within phase 2's bounds, K2 both ways within phase
    3's, K3/K4 exact.  Returns each kernel's largest |kernel - plain|."""
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.ops import maxpool as mp

    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    for dn in DTYPES:
        records = model2_kernel_inputs(dev, dn)
        n = {kn: sum(r[0] == kn for r in records) for kn in worst}
        print(f"  (a) {dn}: model_2's kernel calls in one forward + backward: {n} (want K1 3, "
              f"K2 6, K3 9, K4 4)")
        if n != {"K1": 3, "K2": 6, "K3": 9, "K4": 4}:
            raise RuntimeError(f"(a) {dn}: model_2 called the kernels {n} times")
        g = torch.Generator(device=dev).manual_seed(13)
        for kn, args in records:
            if kn == "K1":
                q, k, theta, _, seed, temp, sample, nei, rows = args
                tag = f"(a) model_2 K1 {tuple(q.shape)} {dn}"
                u_out = torch.empty(q.shape[0], q.shape[1], q.shape[1], device=dev)
                adj = gk.adjacency_fwd_kernel(q, k, theta, None, seed, temp, sample, nei,
                                              u_out=u_out, rows=rows)[0]
                ref = gk._adjacency_fwd_plain(q, k, theta, u_out, seed, temp, sample, nei)[0]
                check(f"{tag} Philox draw, adj vs plain on u_out", rel_err(adj, ref),
                      TOL_SAMPLED)
                worst["K1"] = max(worst["K1"], max_abs(adj, ref))
                gout = torch.randn(adj.shape, device=dev, generator=g)
                qa, ka = q.clone().requires_grad_(), k.clone().requires_grad_()
                got = torch.autograd.grad((gk.GraphAdjacencyFn.apply(
                    gk.adjacency_fwd_kernel, qa, ka, theta, u_out, seed, temp, sample,
                    nei) * gout).sum(), (qa, ka))
                qb, kb = q.clone().requires_grad_(), k.clone().requires_grad_()
                want = torch.autograd.grad((gk.graph_adjacency_plain(
                    qb, kb, theta, seed, temp, sample, u_out, nei) * gout).sum(), (qb, kb))
                for name, a, b in zip(("dq", "dk"), got, want):
                    check(f"{tag} {name} (rel)", float((a.float() - b.float()).abs().max()
                                                       / b.float().abs().max().clamp_min(1e-30)),
                          TOL_GRAD[dn])
            elif kn == "K2":
                adj, x, tr = args
                out, ref = gp._launch(adj, x, tr), gp.propagate_plain(adj, x, transpose=tr)
                check(f"(a) model_2 K2 {tuple(x.shape)} transpose={tr} {dn}", rel_err(out, ref),
                      TOL[dn])
                worst["K2"] = max(worst["K2"], max_abs(out, ref))
            else:
                x, y, dy, k, s_, p = args
                err = max_abs(mp._launch(x, y, dy, k, s_, p),
                              mp.max_pool3d_bwd_plain(x, y, dy, k, s_, p))
                b_, c_, t, h, w = x.shape
                check(f"(a) model_2 {kn} {(b_, t, h, w, c_)} k{tuple(k)} s{tuple(s_)} {dn} "
                      "(max abs)", err, 0.0)
                worst[kn] = max(worst[kn], err)
        del records
        _free()
    return worst


def small_cmc_step(mem_type: str, d, b: int = 8) -> tuple:
    """One CMC step of ``mem_type`` on a small S3D model (graph blocks at 5
    and 9, fp32, sampler none, 8x32x32 clips; at 32x32 stage 14 sees 1x1
    frames) on device ``d`` from the seeded initial state and a seeded
    batch of ``b`` clips; the bank takes one negative draw, made on the CPU.
    (loss, the memories' rows the step wrote, the parameter update.)"""
    from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
    from video_graph_ssl_tpu_torch.engine.pretrain import make_cmc_bank_step, make_pretrain_step
    from video_graph_ssl_tpu_torch.models.build import create_visual_model
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    n_data, K = 64, 64
    c = load_config(CONFIG, CMC_OPTS + [
        "GRAPH.AUG_POINTS", "[5, 9]", "GRAPH.SAMPLER", "none", "TPU.COMPUTE_DTYPE", "float32",
        "CONTRAST.MEM_TYPE", mem_type, "CONTRAST.NCE_K", str(K), "CONTRAST.NCE_T", "1.0"])
    g = torch.Generator().manual_seed(3)
    clips = torch.randn(b, 2, 8, 32, 32, 3, generator=g)
    index = torch.randperm(n_data, generator=g)[:b]
    idx = torch.randint(0, n_data, (b, K + 1), generator=g)
    model, _ = create_visual_model(c)
    state = create_pretrain_state(c, model, d, n_data=n_data)
    p0 = [p.detach().cpu().double() for p in state.model.parameters()]
    if mem_type == "bank":
        step = make_cmc_bank_step(K, 1.0, float(c.CONTRAST.NCE_M), "crossentropy",
                                  draw=lambda *a: idx.to(d))
    else:
        step = make_pretrain_step(c)
    loss = float(step(state, clips.to(d), 0.06, index.to(d))["loss"])
    delta = torch.cat([(p.detach().cpu().double() - q).flatten()
                       for p, q in zip(state.model.parameters(), p0)])
    rows = index if mem_type == "bank" else torch.arange(b)
    names = ("memory_1", "memory_2") if mem_type == "bank" else ("queue_1", "queue_2")
    written = torch.cat([getattr(state.contrast, n).cpu()[rows] for n in names])
    return loss, written, delta


def small_cmc_parity(dev) -> None:
    """(b) the small CMC steps, card (kernels) against CPU (plain versions),
    within phase 9's bounds."""
    for mem_type in ("moco", "bank"):
        print(f"  (b) small S3D+graph CMC {mem_type} step (8x8x32x32, fp32), card vs CPU")
        lc, wc, dc = small_cmc_step(mem_type, torch.device("cpu"))
        lg, wg, dg = small_cmc_step(mem_type, dev)
        tag = f"(b) small CMC {mem_type}"
        check(f"{tag}: loss", abs(lc - lg) / max(1.0, abs(lc)), 1e-4)
        what = "both banks' rows of the batch" if mem_type == "bank" else "both queues' keys"
        check(f"{tag}: {what}", rel_err(wg, wc), 1e-3)
        check(f"{tag}: parameter update (rel-L2)", float((dg - dc).norm() / dc.norm()), 1e-1)


def run_cmc(gpu: str, mem_type: str, n: int = CMC_STEPS, opts=(), save: bool = False) -> dict:
    """n CMC trainer steps of ``mem_type`` at full width (CMC_RUNS + ``opts``;
    2 warm-up, the rest timed) from synthetic clips through the Loader: the
    K1-K5 counts of exactly those steps against the recorded prediction and
    ``kernel_times.step_calls``, finite losses, both memories, ms/step and
    peak memory; with ``save`` a checkpoint through the trainer's Saver."""
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config

    c = load_config(CONFIG, CMC_RUNS[mem_type] + list(opts))
    fused = bool(c.TPU.SEPCONV_FUSED)
    trainer = Trainer(c, max_steps=n, device="cuda", run_dir=RUN_DIR)
    state = trainer.state
    geometry = (f"bs {c.DATALOADER.BATCH_SIZE}, 16x{c.INPUT.BASE_SIZE[0]}x"
                f"{c.INPUT.BASE_SIZE[1]}, {c.TPU.COMPUTE_DTYPE}, NCE_K {c.CONTRAST.NCE_K}, "
                f"SEPCONV_FUSED {fused}")
    names = ("queue_1", "queue_2") if mem_type == "moco" else ("memory_1", "memory_2")
    shapes = [tuple(getattr(state.contrast, m).shape) for m in names]
    print(f"  (c) CMC {mem_type} trainer, two full S3D stacks: {geometry}; memories {names} "
          f"{shapes}")
    before = [getattr(state.contrast, m).clone() for m in names]
    epoch = trainer.train_loader.epoch(0)
    batches = [(trainer.to_device(b), trainer.index_of(b)) for b in itertools.islice(epoch, n)]
    epoch.close()
    n = len(batches)
    lr = trainer.lr_fn(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms, losses = [], []
    for clips, index in batches:
        t0 = time.perf_counter()
        metrics = trainer.train_step(clips, lr, index)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (ms, loss) in enumerate(zip(step_ms, losses)):
        print(f"  step {i} ({'warm-up' if i < 2 else 'timed'}): {ms:.1f} ms, loss {loss:.4f}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"CMC {mem_type}: non-finite loss {losses}")
    want = step_calls(mem_type, fused, cmc=True)
    per_step = {k: v // n for k, v in counts.items()}
    print(f"  (c) kernel calls in the {n} steps: {counts}; per step {per_step} "
          f"(kernel_times.step_calls {want})")
    if counts != {k: v * n for k, v in want.items()}:
        raise RuntimeError(f"CMC {mem_type}: kernel calls {counts} != {n} x {want}")
    if mem_type == "moco":
        predicted = CMC_PREDICTED_FUSED if fused else CMC_PREDICTED
        if per_step != predicted:
            raise RuntimeError(f"CMC MoCo: kernel calls per step {per_step} != the recorded "
                               f"prediction {predicted}")
        print(f"  (c) per step equal to the recorded prediction {predicted}")
    for m, b in zip(names, before):
        moved = int((getattr(state.contrast, m) != b).any(dim=1).sum())
        print(f"  (c) {m}: {moved} rows written in {n} steps")
        if moved != n * int(c.DATALOADER.BATCH_SIZE):
            raise RuntimeError(f"CMC {mem_type}: {m} took {moved} rows in {n} steps")
    timed = step_ms[2:]
    mean_ms = sum(timed) / len(timed)
    bsz = int(c.DATALOADER.BATCH_SIZE)
    print(f"slice CMC {mem_type} ({geometry}): {mean_ms:.1f} ms/step, "
          f"{bsz / mean_ms * 1e3:.1f} clips/s (mean of {len(timed)} timed steps), "
          f"max_memory_allocated {peak:.2f} GiB on {gpu}")
    ckpt = (trainer.saver.save_checkpoint(state, 1, filename="checkpoint_1.pth.tar")
            if save else None)
    del trainer, state, batches, metrics, before
    _free()
    return {"ms": mean_ms, "peak_gib": peak, "counts": per_step, "ckpt": ckpt}


def cmc_ranks(gpu: str) -> None:
    """(d) CMC MoCo across ranks: one NCCL rank against no group, bit for
    bit (bs 128, bf16); two gloo rank processes sharing the card (fp32, bs
    32: both streams' keys, losses, updates and the EMA stacks' BN against
    one process with the ranks' BN function, every error within phase 8's
    bounds) beside a per-rank-BN control that must exceed one of them."""
    nccl_one_rank("(d) CMC MoCo", rank_run(CMC_RUNS["moco"]))
    tag = "(d) two ranks, CMC MoCo, float32, global bs 32"
    opts = rank_opts(32, "float32") + ["CROSS.MODALITY", "cross"]
    print(f"  {tag}: 16 rows per rank, 16x112x112, {RANK_STEPS} steps, TF32 off, "
          "cudnn.deterministic")
    torch.backends.cudnn.deterministic = True
    try:
        one = one_process_twice(opts, tag, gpu)
        ranks, control = spawn_ranks([rank_run(opts), rank_run(opts, per_rank=True)])
    finally:
        torch.backends.cudnn.deterministic = False
    hold_ranks(tag, ranks, gpu, SHARED, _want_counts(cmc=True))
    errors = {"float32": hold_to_one_process(tag, ranks, one, 32, TOL_RANKS["float32"]),
              "float32 control": control_fails(tag, control, one, 32, TOL_RANKS["float32"])}
    print("phase 16 (d) errors against one process: " + json.dumps(errors))
    del one, ranks, control
    _free()


def cmc_fine_tune(dev, gpu: str, ckpt: str) -> None:
    """(e) train_ds from the CMC checkpoint just written: the surgery puts
    model_1's encoder into the fine-tune model (bit for bit), which takes
    DS_SHORT steps with K1-K4 at the fine-tune's counts."""
    r = run_downstream(dev, gpu, FT_CONFIG, ["MODEL.AUG_FLAG", "True"], DS_SHORT, ssl=ckpt)
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)["state_dict"]
    enc = {k[len("base_model."):]: v for k, v in r["before"].items()
           if k.startswith("base_model.")}
    bad = [k for k, v in enc.items()
           if not torch.equal(v, sd[f"model_1.model.encoder.base_model.{k}"])]
    print(f"  (e) fine-tune from the CMC checkpoint: {len(enc)} encoder tensors, {len(bad)} "
          "differ from model_1's (want 0, bit for bit)")
    if bad:
        raise RuntimeError(f"(e) the surgery did not take model_1's encoder: {bad[:5]}")
    _hold_counts("(e) CMC fine-tune", r["counts"],
                 _want_counts(DS_SHORT, "finetune", partial_bn=True))
    del r
    _free()


def phase_cmc(dev, gpu: str) -> dict:
    print("phase 16: CMC (CROSS.MODALITY cross), two-modality MoCo and bank")

    def part(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        print(f"  ({name}: {time.perf_counter() - t0:.1f} s)")
        return out

    worst = part("a", cmc_kernel_checks, dev)
    part("b", small_cmc_parity, dev)
    moco = part("c moco", run_cmc, gpu, "moco", save=True)
    part("c moco fused", run_cmc, gpu, "moco", n=3, opts=FUSED)
    part("c bank", run_cmc, gpu, "bank")
    part("d", cmc_ranks, gpu)
    part("e", cmc_fine_tune, dev, gpu, moco["ckpt"])
    return worst


# --------------------------------------------------------------------------- #
# phase 17: i3d_res50_nonlocal (GCA MoCo with K1, K2 and K4), the text-video
# S3DGText (K3 and K4 in its video tower) and the reference-checkpoint
# converter.  i3d_res50_nonlocal at bs 128, 16x112x112: T = 2 at all three
# graph blocks (x (128, 2, 28, 28, 256), (128, 2, 14, 14, 512), (128, 2, 7,
# 7, 1024)), the stem pool on (128, 8, 56, 56, 64) and the temporal pool
# (3, 1, 1) / (2, 1, 1) on layer1's (128, 4, 28, 28, 256)
I3DNON = "i3d_res50_nonlocal"
I3DNON_K1, I3DNON_K2, I3DNON_POOLS, _ = geometry(112, 128, I3DNON)
# S3DGText at full width on its own input: 32 frames of 224x224, the S2D
# stem, embd 512, 66,250 words of 300 dims, 16 words a sentence
TEXT_FRAMES, TEXT_SIZE, TEXT_EMBD, TEXT_VOCAB, TEXT_WORDS = 32, 224, 512, 66250, 16
TEXT_BATCH = 8          # clips per video-tower call
TEXT_SENTENCES = 4096   # sentences per text-tower call
TEXT_ITERS = 5


def text_state_dict(seed: int = 19) -> dict:
    """A MIL-NCE-named S3DGText state dict (the manifest's names and shapes,
    seeded values; ``module.`` and BN counters, as torch saves one)."""
    from video_graph_ssl_tpu_torch.models.s3dg_text import reference_s3dg_text_shape_manifest

    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, shape in reference_s3dg_text_shape_manifest(TEXT_EMBD, True, TEXT_VOCAB).items():
        if k.endswith("running_var") or (k.endswith(".weight") and len(shape) == 1):
            v = torch.rand(shape, generator=gen) + 0.5
        elif len(shape) >= 2:
            v = torch.randn(shape, generator=gen) / math.sqrt(math.prod(shape[1:]))
        else:
            v = 0.05 * torch.randn(shape, generator=gen)
        sd[f"module.{k}"] = v
        if k.endswith("running_mean"):
            sd[f"module.{k[:-len('running_mean')]}num_batches_tracked"] = torch.tensor(7)
    return sd


def text_model(dtype: torch.dtype, sd: dict):
    """S3DGText (S2D stem, embd 512, 66,250 words) in compute ``dtype`` on
    the CPU with ``sd`` loaded strictly (``milnce_names``)."""
    from video_graph_ssl_tpu_torch.models.s3dg_text import S3DGText, milnce_names

    model = S3DGText(TEXT_EMBD, num_text_embeddings=TEXT_VOCAB, dtype=dtype)
    model.load_state_dict(milnce_names(sd), strict=True)
    return model


def text_kernel_checks(dev, sd: dict) -> dict:
    """(a) K3 and K4 at S3DGText's pools on its own input: the video tower's
    train-mode forward and backward on TEXT_BATCH clips of 32x224x224, fp32
    and bf16, every K3/K4 call's inputs recorded (9 branch pools, 4 TF
    "SAME" stage pools), each call against the plain version, exactly.
    Returns the largest difference per kernel."""
    from video_graph_ssl_tpu_torch.models.layers import place
    from video_graph_ssl_tpu_torch.ops import maxpool as mp

    worst = {"K3": 0.0, "K4": 0.0}
    launch = mp._launch
    for dn, dt in DTYPES.items():
        model = place(text_model(dt, sd), dev).train()
        g = torch.Generator(device=dev).manual_seed(21)
        x = torch.randn(TEXT_BATCH, TEXT_FRAMES, TEXT_SIZE, TEXT_SIZE, 3, device=dev,
                        generator=g)
        records = []

        def rec(xx, y, dy, k, s_, p):
            kn = "K3" if tuple(s_) == (1, 1, 1) else "K4"
            records.append((kn, xx.detach().clone(), y.detach().clone(), dy.detach().clone(),
                            k, s_, p))
            return launch(xx, y, dy, k, s_, p)

        mp._launch = rec
        try:
            emb = model.encode_video(x)
            (emb * torch.randn(emb.shape, device=dev, generator=g)).sum().backward()
            torch.cuda.synchronize()
        finally:
            mp._launch = launch
        n = {kn: sum(r[0] == kn for r in records) for kn in worst}
        print(f"  (a) S3DGText video tower {dn}, {TEXT_BATCH}x{TEXT_FRAMES}x{TEXT_SIZE}x"
              f"{TEXT_SIZE}: K3/K4 calls in one backward {n} (want K3 9, K4 4)")
        if n != {"K3": 9, "K4": 4}:
            raise RuntimeError(f"(a) S3DGText {dn}: K3/K4 calls {n}")
        del model, emb, x
        for kn, xx, y, dy, k, s_, p in records:
            err = max_abs(launch(xx, y, dy, k, s_, p), mp.max_pool3d_bwd_plain(xx, y, dy, k, s_, p))
            b_, c_, t, h, w = xx.shape
            check(f"(a) S3DGText {kn} {(b_, t, h, w, c_)} k{tuple(k)} s{tuple(s_)} {dn} "
                  "(max abs)", err, 0.0)
            worst[kn] = max(worst[kn], err)
        del records
        _free()
    return worst


def nonlocal_kernel_checks(dev, gpu: str) -> dict:
    """(a) K1, K2 and K4 against their plain versions at i3d_res50_nonlocal's
    graph blocks and pools (bs 128, 16x112x112), fp32 and bf16, within
    phases 2-4's bounds; their times in bf16."""
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    for dn in DTYPES:
        w = kernel_checks(dev, f"(a) {I3DNON}", I3DNON_K1, I3DNON_K2, I3DNON_POOLS, dn)
        worst = {k: max(v, w[k]) for k, v in worst.items()}
        _free()
    resnet_kernel_times(dev, gpu, I3DNON_K1, I3DNON_K2, I3DNON_POOLS, key="i3dnon_kernels")
    _free()
    return worst


def nonlocal_trainer(dev, gpu: str) -> dict:
    """(c) GCA MoCo with i3d_res50_nonlocal through the trainer
    (configs/visual_moco.yaml, MODEL.AUG_FLAG True: bs 128, 16x112x112,
    bf16, NCE_K 16384, graph blocks at 2, 3, 4): 3 graph blocks and 2
    non-local blocks built, the launches of the 5 steps exactly
    ``step_calls``' (K1 6, K2 9, K3 0, K4 2 a step); a checkpoint for (d)."""
    run = run_trainer(dev, gpu, fused=False, backbone=I3DNON, save=True)
    print(f"  (c) {I3DNON}: {run['graph_blocks']} graph blocks, {run['nonlocal_blocks']} "
          f"non-local blocks; launches in 5 steps {run['counts']}")
    if (run["graph_blocks"], run["nonlocal_blocks"]) != (3, 2):
        raise RuntimeError(f"(c) {I3DNON}: {run['graph_blocks']} graph blocks, "
                           f"{run['nonlocal_blocks']} non-local blocks (want 3, 2)")
    _hold_counts(f"(c) {I3DNON}", run["counts"], _want_counts(5, "moco", backbone=I3DNON))
    return run


def text_run(dev, gpu: str, sd: dict) -> dict:
    """(e) S3DGText at full width from the MIL-NCE-named state dict: the
    eval video embeddings of TEXT_BATCH clips of 32x224x224 (bf16) in
    clips/s, the text embeddings of TEXT_SENTENCES sentences in
    sentences/s; then both towers in fp32 on the card against the CPU on a
    small input (2 clips of 16x64x64, 4 sentences)."""
    from video_graph_ssl_tpu_torch.models.layers import place

    model = place(text_model(torch.bfloat16, sd), dev).eval()
    g = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn(TEXT_BATCH, TEXT_FRAMES, TEXT_SIZE, TEXT_SIZE, 3, device=dev, generator=g)
    ids = torch.randint(1, TEXT_VOCAB, (TEXT_SENTENCES, TEXT_WORDS), device=dev, generator=g)
    ids[:, TEXT_WORDS // 2:] *= (torch.rand(TEXT_SENTENCES, 1, device=dev, generator=g)
                                 < 0.5).long()    # half the sentences padded at 8 words

    def per_s(fn, n):
        with torch.no_grad():
            for _ in range(2):
                out = fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TEXT_ITERS):
                out = fn()
            torch.cuda.synchronize()
        return n * TEXT_ITERS / (time.perf_counter() - t0), out

    clips_s, emb = per_s(lambda: model.encode_video(x), TEXT_BATCH)
    sent_s, temb = per_s(lambda: model.text_module(ids), TEXT_SENTENCES)
    print(f"  (e) S3DGText eval, bf16: video tower {clips_s:.1f} clips/s ({TEXT_BATCH} clips of "
          f"{TEXT_FRAMES}x{TEXT_SIZE}x{TEXT_SIZE} a call), text tower {sent_s:.0f} sentences/s "
          f"({TEXT_SENTENCES} of {TEXT_WORDS} words a call) on {gpu}")
    for name, e, n in (("video", emb, TEXT_BATCH), ("text", temb, TEXT_SENTENCES)):
        if tuple(e.shape) != (n, TEXT_EMBD) or not bool(torch.isfinite(e).all()):
            raise RuntimeError(f"(e) S3DGText {name} embeddings {tuple(e.shape)}, finite "
                               f"{bool(torch.isfinite(e).all())}")
    del model, x, emb, temb
    _free()
    cpu = text_model(torch.float32, sd).eval()
    card = place(text_model(torch.float32, sd), dev).eval()
    small = torch.randn(2, 16, 64, 64, 3, generator=torch.Generator().manual_seed(23))
    small_ids = torch.tensor([[5, 9, 1, 0], [7, 0, 0, 0], [3, 3, 3, 3], [0, 0, 0, 0]])
    with torch.no_grad():
        want = cpu(small, small_ids)
        got = card(small.to(dev), small_ids.to(dev))
    for key in ("video_embedding", "text_embedding"):
        check(f"(e) S3DGText fp32 {key}, card vs CPU (rel-L2)",
              rel_l2(got[key].cpu(), want[key]), 1e-4)
    del cpu, card
    _free()
    return {"video_clips_per_s": clips_s, "text_sentences_per_s": sent_s}


def converter_on_card(dev, gpu: str) -> None:
    """(f) ``convert_checkpoint`` on the card: a reference S3D MoCo payload
    built in the run (the reference's ``GraphWrapper`` names with seeded
    values, ``module.``, BN counters and the classifier, a 16,384-row
    memory, epoch 5) becomes a port checkpoint on the card; train_ds takes
    2 fine-tune steps from it, its encoder bit for bit the payload's; the
    export back to the reference's names equals the payload, bit for
    bit."""
    import torch.nn.functional as F
    from video_graph_ssl_tpu_torch import convert_checkpoint as cc
    from video_graph_ssl_tpu_torch.models.build import create_visual_model
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config
    from video_graph_ssl_tpu_torch.utils.checkpoint import META_KEYS, mismatches

    opts = SYNTHETIC + ["MODEL.AUG_FLAG", "False"]
    c = load_config(CONFIG, opts)
    names = create_visual_model(c)[0].state_dict()
    gen = torch.Generator().manual_seed(24)
    sd = {k: (torch.rand(v.shape, generator=gen) + 0.5 if "running_var" in k
              else 0.1 * torch.randn(v.shape, generator=gen)) for k, v in names.items()}
    extra = {k[:-len("running_mean")] + "num_batches_tracked": torch.tensor(9)
             for k in sd if k.endswith("running_mean")}
    extra["model.encoder.base_model.fc.0.weight"] = torch.zeros(400, 1024, 1, 1, 1)
    extra["model.encoder.base_model.fc.0.bias"] = torch.zeros(400)
    queue = F.normalize(torch.randn(int(c.CONTRAST.NCE_K), int(c.CROSS.FEAT_DIM),
                                    generator=gen), dim=1)
    src = os.path.join(RUN_DIR, "reference_s3d_moco.pth.tar")
    torch.save({"epoch": 5, "state_dict": {f"module.{k}": v for k, v in {**sd, **extra}.items()},
                "contrast": {"memory": queue}, "optimizer": {"state": {}}}, src)
    t0 = time.perf_counter()
    out = cc.main(["--config_file", CONFIG, *opts, "--torch_ckpt", src])
    print(f"  (f) converted on the card in {time.perf_counter() - t0:.1f} s: {out}")
    payload = torch.load(out, map_location="cpu", weights_only=True)
    bad = mismatches(payload["state_dict"], sd) + mismatches(payload["model_ema"], sd)
    if bad or not torch.equal(payload["contrast"]["queue"], queue) or payload["epoch"] != 5:
        raise RuntimeError(f"(f) the converted checkpoint differs from the payload: {bad[:5]}")
    print(f"  (f) {len(sd)} tensors ({len(extra)} counters and classifier entries dropped), "
          f"the EMA copy and the {tuple(queue.shape)} queue equal the payload's, epoch 5; "
          f"notes {json.dumps({k: v for k, v in payload['meta'].items() if k not in META_KEYS})}")
    r = run_downstream(dev, gpu, FT_CONFIG, ["MODEL.AUG_FLAG", "False"], 2, ssl=out)
    enc = {k[len("base_model."):]: v for k, v in r["before"].items()
           if k.startswith("base_model.")}
    diff = [k for k, v in enc.items() if not torch.equal(v, sd[f"model.encoder.base_model.{k}"])]
    print(f"  (f) train_ds from the converted checkpoint: {len(enc)} encoder tensors, "
          f"{len(diff)} differ from the payload's (want 0, bit for bit)")
    if diff:
        raise RuntimeError(f"(f) train_ds did not take the converted encoder: {diff[:5]}")
    del r
    _free()
    back = cc.main(["--config_file", CONFIG, *opts, "--checkpoint", out, "--to_torch",
                    os.path.join(RUN_DIR, "reference_s3d_moco_back.pth.tar")])
    ref = torch.load(back, map_location="cpu", weights_only=True)
    bad = mismatches(ref["state_dict"], sd) + mismatches(ref["model_ema"], sd)
    if bad or not torch.equal(ref["contrast"]["memory"], queue) or ref["epoch"] != 5:
        raise RuntimeError(f"(f) the export back differs from the payload: {bad[:5]}")
    print(f"  (f) exported back to the reference's names: state_dict, model_ema and memory "
          "equal the payload's, bit for bit")


def phase_nonlocal_text(dev, gpu: str) -> dict:
    print("phase 17: i3d_res50_nonlocal, the text-video S3DGText and the reference-checkpoint "
          "converter")

    def part(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        print(f"  ({name}: {time.perf_counter() - t0:.1f} s)")
        return out

    worst = part("a i3d_res50_nonlocal", nonlocal_kernel_checks, dev, gpu)
    sd = text_state_dict()
    for kn, v in part("a S3DGText", text_kernel_checks, dev, sd).items():
        worst[kn] = max(worst[kn], v)
    print("  (b) small steps, card vs CPU")
    part("b", small_step_parity, dev, fused=False, backbone=I3DNON)
    print("  (c) GCA MoCo through the trainer, configs/visual_moco.yaml, MODEL.AUG_FLAG True")
    run = part("c", nonlocal_trainer, dev, gpu)
    print(f"  (d) train_ds and test_ds with {I3DNON} from (c)'s checkpoint")
    part("d", i3d_downstream, dev, gpu, run["ckpt"], backbone=I3DNON, phase="phase17")
    _free()
    print(f"  (e) S3DGText at full width ({sum(not k.endswith('num_batches_tracked') for k in sd)}"
          " MIL-NCE-named tensors loaded strictly)")
    text = part("e", text_run, dev, gpu, sd)
    print("  (f) the reference-checkpoint converter on the card")
    part("f", converter_on_card, dev, gpu)
    print(json.dumps({"nonlocal_text": {
        I3DNON: {"ms_per_step": run["ms"], "clips_per_s": 128e3 / run["ms"],
                 "peak_gib": run["peak_gib"], "launches": run["counts"]},
        "S3DGText": text}, "worst": worst, "gpu": gpu}))
    return worst


REMAT = {"off": [], "block": ["TPU.REMAT", "True", "TPU.REMAT_POLICY", "block"],
         "conv_saved": ["TPU.REMAT", "True", "TPU.REMAT_POLICY", "conv_saved"]}
REMAT_STEPS = 3
REMAT_SMALL_BS = 8
EXPORT_BATCH = 2
CAM_VIDEOS = 2
TOL_CAM = 1e-3
TOL_HEAD = 1e-4
TOL_EXPORT = 1e-4   # the JAX tool's live-against-artifact bound
# a fresh interpreter loads artifacts with torch and the port's ops alone
# (TF32 off and cuDNN deterministic, as in this process) and writes each
# one's features and K1, K2 and pool forward launches (arguments: path,
# input, output, ...)
EXPORT_LOAD = """
import json, sys, numpy as np, torch
import video_graph_ssl_tpu_torch.ops  # noqa: F401  (registers the port's operators)
from video_graph_ssl_tpu_torch.utils import tracing
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
for path, raw_in, feats_out in zip(*[iter(sys.argv[1:])] * 3):
    fn = torch.export.load(path).module()
    raw = torch.from_numpy(np.load(raw_in)).cuda()
    with torch.no_grad():
        fn(raw)
        torch.cuda.synchronize()
        tracing.reset_counters()
        out = fn(raw)
        torch.cuda.synchronize()
    np.save(feats_out, out.cpu().numpy())
    n = tracing.counters()
    print(json.dumps({"graph_adjacency": n["graph_adjacency"],
                      "gcn_propagate": n["gcn_propagate"], "maxpool_fwd": n["maxpool_fwd"]}))
"""


def remat_small_run(policy: str, fused: bool, ckpt: str = None) -> dict:
    """REMAT_STEPS GCA MoCo steps of the trainer (S3D, graph at 5, 9, 14,
    16x112x112, bs REMAT_SMALL_BS, fp32) under ``policy``; ``drive_steps``'
    record plus the gradients of the last step, and with ``ckpt`` the
    checkpoint the Saver writes after the steps."""
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config

    c = load_config(CONFIG, ["MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "synthetic",
                             "DATALOADER.BATCH_SIZE", str(REMAT_SMALL_BS),
                             "TPU.COMPUTE_DTYPE", "float32", "TPU.SEPCONV_FUSED", str(fused),
                             *REMAT[policy]])
    trainer = Trainer(c, max_steps=REMAT_STEPS, device="cuda", run_dir=RUN_DIR)
    run = drive_steps(trainer, REMAT_STEPS)
    run["grads"] = {n: p.grad.detach().cpu().clone()
                    for n, p in trainer.state.model.named_parameters()}
    if ckpt:
        run["ckpt"] = trainer.saver.save_checkpoint(trainer.state, 1, filename=ckpt)
    del trainer
    _free()
    return run


def remat_same_step(gpu: str) -> str:
    """(a): off, block and conv_saved, and block with TPU.SEPCONV_FUSED
    against off with it, bit for bit (losses, parameters after step 1 and
    3, BN running statistics, queue and pointer, EMA encoder, last
    gradients), K1-K5 at their exact counts; returns the path of off's
    checkpoint."""
    from video_graph_ssl_tpu_torch.graph_benefit import reproducible_fp32
    from video_graph_ssl_tpu_torch.utils.checkpoint import mismatches

    with reproducible_fp32():
        for fused, policies in ((False, ("off", "block", "conv_saved")), (True, ("off", "block"))):
            runs = {}
            for policy in policies:
                save = "phase18_off.pth.tar" if (policy, fused) == ("off", False) else None
                run = runs[policy] = remat_small_run(policy, fused, save)
                tag = f"phase 18 (a) {policy}, SEPCONV_FUSED {fused}"
                _hold_counts(tag, run["counts"], _want_counts(REMAT_STEPS, fused=fused,
                                                              remat=policy != "off"))
                print(f"  {tag}: losses {run['losses']}, host ms {[f'{m:.1f}' for m in run['ms']]}"
                      f", peak {run['peak_gib']:.2f} GiB, kernel calls {run['counts']}")
                if policy == "off":
                    continue
                off = runs["off"]
                bad = (([] if run["losses"] == off["losses"] else ["losses"])
                       + mismatches(run["after_1"], off["after_1"], "after_1")
                       + mismatches(run["state"], off["state"], "state")
                       + mismatches(run["grads"], off["grads"], "grads"))
                if bad:
                    raise RuntimeError(f"{tag} differs from off at {bad[:8]}")
                print(f"  {tag}: losses, gradients, parameters, BN statistics, queue and EMA "
                      "equal off's bit for bit")
            if not fused:
                ckpt = runs["off"]["ckpt"]
    return ckpt


def remat_full_width(dev, gpu: str) -> dict:
    """(b): the trainer at the main path's geometry (S3D + graph, bs 128,
    16x112x112, bf16) under off, block and conv_saved: ms/step and peak
    memory; both recomputes must hold less."""
    runs = {p: run_trainer(dev, gpu, fused=False, opts=REMAT[p]) for p in REMAT}
    out = {p: {"ms_per_step": r["ms"], "peak_gib": r["peak_gib"]} for p, r in runs.items()}
    for p in ("block", "conv_saved"):
        print(f"  REMAT {p}: {out[p]['ms_per_step']:.1f} ms/step against "
              f"{out['off']['ms_per_step']:.1f}, peak {out[p]['peak_gib']:.2f} GiB against "
              f"{out['off']['peak_gib']:.2f} GiB on {gpu}")
        if not out[p]["peak_gib"] < out["off"]["peak_gib"]:
            raise RuntimeError(f"REMAT {p}: peak {out[p]['peak_gib']:.2f} GiB is not below "
                               f"off's {out['off']['peak_gib']:.2f} GiB")
    return out


def op_dispatch_times(dev, gpu: str) -> dict:
    """K1's and K2's forwards at the step's shapes (bf16, K1 sampled) three
    ways: the launcher, the registered operator and the module-level
    wrapper (the training path: the operator inside the autograd
    function), CUDA-event ms and host us per call."""
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk

    g = torch.Generator(device=dev).manual_seed(5)
    bf, out = torch.bfloat16, {}
    for b, t, d in K1_SHAPES:
        q = torch.randn(b, t, d, device=dev, generator=g).to(bf)
        k = torch.randn(b, t, d, device=dev, generator=g).to(bf)
        theta = torch.rand(t, t, device=dev, generator=g)
        ways = {"launcher": lambda: gk.adjacency_fwd_kernel(q, k, theta, None, 7, 1.0, True, 0),
                "operator": lambda: gk.adjacency_fwd_op(q, k, theta, None, 7, 1.0, True, 0),
                "wrapper": lambda: gk.graph_adjacency(q, k, theta, 7, 1.0, True)}
        out[f"K1 {(b, t, d)}"] = {w: {"ms": event_ms(f), "host_us": host_us(f)}
                                  for w, f in ways.items()}
    for shape in K2_SHAPES:
        b, t = shape[:2]
        x = torch.randn(shape, device=dev, generator=g).to(bf)
        adj = torch.rand(b, t, t, device=dev, generator=g).to(bf)
        ways = {"launcher": lambda: gp._launch(adj, x, False),
                "operator": lambda: gp.propagate_op(adj, x, False),
                "wrapper": lambda: gp.gcn_propagate(adj, x)}
        out[f"K2 {tuple(shape)}"] = {w: {"ms": event_ms(f), "host_us": host_us(f)}
                                     for w, f in ways.items()}
    for key, ways in out.items():
        print(f"  {key}: " + ", ".join(f"{w} {v['ms']:.4f} ms ({v['host_us']:.1f} us host)"
                                       for w, v in ways.items()) + f" on {gpu}")
    return out


def export_on_card(dev, gpu: str, ckpt: str) -> dict:
    """(c): the GCA S3D encoder of ``ckpt`` exported by the tool at --batch
    2 and with --poly (fp32): K1/K2 against their plain versions at the
    export's shapes; each artifact loaded here against the live model
    (< TOL_EXPORT) with one call's K1/K2 launches; then both loaded in one
    fresh process, whose launches and features must equal this process's
    bit for bit."""
    import subprocess

    import numpy as np
    from video_graph_ssl_tpu_torch import export_model
    from video_graph_ssl_tpu_torch.graph_benefit import reproducible_fp32
    from video_graph_ssl_tpu_torch.kernel_times import geometry
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    k1_shapes, k2_shapes = geometry(112, EXPORT_BATCH)[:2]
    worst = kernel_checks(dev, "phase 18 (c)", k1_shapes, k2_shapes, [], "fp32")
    # one pass: K1 and K2 at the three graph blocks, the 13 pools' forwards
    want = {"graph_adjacency": 3, "gcn_propagate": 3, "maxpool_fwd": 13}
    opts = ["MODEL.AUG_FLAG", "True", "TPU.COMPUTE_DTYPE", "float32"]
    live, _, _ = export_model.build_infer_fn(load_config(CONFIG, opts), "encoder", ckpt, dev)
    out, fresh_args, here = {}, [], {}
    for name, shape in (("batch2", ["--batch", str(EXPORT_BATCH)]), ("poly", ["--poly"])):
        directory = os.path.join(RUN_DIR, f"export_{name}")
        t0 = time.perf_counter()
        manifest = export_model.main(["--config_file", CONFIG, "--checkpoint", ckpt,
                                      "--output", directory, "--skip_validate", *shape, *opts])
        seconds = time.perf_counter() - t0
        path = os.path.join(directory, "encoder.pt2")
        b = EXPORT_BATCH + (1 if name == "poly" else 0)
        raw = torch.randint(0, 256, (b, *manifest["input"]["shape"][1:]), dtype=torch.uint8,
                            generator=torch.Generator().manual_seed(9))
        with reproducible_fp32(), torch.no_grad():
            fn = torch.export.load(path).module()
            fn(raw.to(dev))
            torch.cuda.synchronize()
            reset_counts()
            here[name] = fn(raw.to(dev)).cpu()
            torch.cuda.synchronize()
            counts = {k: read_counts()[k] for k in want}
            err = max_abs(here[name], live(raw.to(dev)).cpu())
        _hold_counts(f"phase 18 (c) {name}: one artifact call", counts, want)
        check(f"phase 18 (c) {name}: max|live - artifact|", err, TOL_EXPORT)
        if not (here[name].shape == (b, manifest["output"]["dim"])
                and bool(here[name].isfinite().all())):
            raise RuntimeError(f"phase 18 (c) {name}: features {tuple(here[name].shape)}")
        np.save(os.path.join(directory, "raw.npy"), raw.numpy())
        fresh_args += [path, os.path.join(directory, "raw.npy"),
                       os.path.join(directory, "fresh.npy")]
        print(f"  (c) {name}: exported in {seconds:.1f} s, {manifest['bytes'] / 1e6:.1f} MB; "
              f"batch {b}: K1 {counts['graph_adjacency']}, K2 {counts['gcn_propagate']}, "
              f"pool forward {counts['maxpool_fwd']} launches per artifact call")
        out[name] = {"live_err": err, "bytes": manifest["bytes"], "export_s": seconds}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_LOAD, *fresh_args], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 18 (c): the fresh process failed:\n{proc.stderr}")
    lines = proc.stdout.strip().splitlines()[-2:]
    for name, line in zip(("batch2", "poly"), lines):
        _hold_counts(f"phase 18 (c) {name}: the fresh process's call", json.loads(line), want)
        fresh = torch.from_numpy(np.load(os.path.join(RUN_DIR, f"export_{name}", "fresh.npy")))
        if not torch.equal(fresh, here[name]):
            raise RuntimeError(f"phase 18 (c) {name}: the fresh process's features differ by "
                               f"{max_abs(fresh, here[name]):.3e}")
    print(f"  (c) a fresh process ({time.perf_counter() - t0:.1f} s) loads both artifacts "
          f"with torch and the port's ops alone: {lines}, features equal this process's "
          "bit for bit")
    return {"worst": worst, **out}


def cam_on_card(dev, gpu: str) -> dict:
    """(d): Grad-CAM of an S3D classifier (graph at 5, 9, 14, 112x112,
    fp32) on the card and on the CPU from the same weights and clips."""
    import copy

    from video_graph_ssl_tpu_torch import cam
    from video_graph_ssl_tpu_torch.graph_benefit import reproducible_fp32
    from video_graph_ssl_tpu_torch.models.build import create_video_model
    from video_graph_ssl_tpu_torch.models.layers import place
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    c = load_config(FT_CONFIG, ["TPU.COMPUTE_DTYPE", "float32", "MODEL.AUG_FLAG", "True",
                                *SYNTHETIC])
    model, _ = create_video_model(c)
    t, crop = int(c.INPUT.VIDEO_LENGTH), tuple(int(s) for s in c.INPUT.CROP_SIZE)
    scale = tuple(int(s) for s in c.INPUT.SCALE_SIZE)
    raw = torch.randint(0, 256, (CAM_VIDEOS, t, *scale, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(12))
    got, on_cpu = {}, copy.deepcopy(model)
    for name, d, m in (("cpu", torch.device("cpu"), on_cpu), ("gpu", dev, place(model, dev))):
        fn = cam.build_cam_fn(c, m, "S3D", "mixed_5c", (t, *crop))
        with reproducible_fp32():
            t0 = time.perf_counter()
            maps, logits, head_err = fn(m, raw.to(d), 1)
            got[name] = (maps.cpu(), logits.cpu(), head_err, time.perf_counter() - t0)
        check(f"phase 18 (d) {name} head_err", head_err, TOL_HEAD)
    (cm, cl, _, cs), (gm, gl, gerr, gs) = got["cpu"], got["gpu"]
    err = max_abs(gm, cm)
    check("phase 18 (d) max|cam_gpu - cam_cpu|", err, TOL_CAM)
    if not (gm.shape == (CAM_VIDEOS, t, *crop) and float(gm.min()) >= 0.0
            and float(gm.max()) <= 1.0 + 1e-6):
        raise RuntimeError(f"phase 18 (d): CAM {tuple(gm.shape)} in [{float(gm.min())}, "
                           f"{float(gm.max())}]")
    print(f"  (d) CAMs of {CAM_VIDEOS} videos at {t}x{crop[0]}x{crop[1]}: card against CPU "
          f"{err:.3e} (<= {TOL_CAM}), logits {rel_err(gl, cl):.3e}, head_err {gerr:.3e}; "
          f"{gs:.2f} s on the card, {cs:.2f} s on the CPU")
    return {"cam_err": err, "head_err": gerr}


def phase_remat_export_cam(dev, gpu: str) -> dict:
    print("phase 18: TPU.REMAT on the GCA MoCo step, the model export and Grad-CAM")

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"  ({name}: {time.perf_counter() - t0:.1f} s)")
        return out

    print(f"  (a) the same step: {REMAT_STEPS} steps at bs {REMAT_SMALL_BS}, 16x112x112, fp32, "
          "cuDNN deterministic")
    ckpt = part("a", remat_same_step, gpu)
    print("  (b) REMAT at full width (S3D + graph, bs 128, 16x112x112, bf16)")
    full = part("b", remat_full_width, dev, gpu)
    print("  (c) the GCA S3D encoder exported (configs/visual_moco.yaml, MODEL.AUG_FLAG True, "
          "(a)'s weights, fp32), and K1/K2 through their operators")
    exported = part("c", export_on_card, dev, gpu, ckpt)
    dispatch = part("c dispatch", op_dispatch_times, dev, gpu)
    print("  (d) Grad-CAM, S3D classifier, card against CPU")
    cams = part("d", cam_on_card, dev, gpu)
    print(json.dumps({"remat_export_cam": {"remat": full, "export": exported,
                                           "dispatch": dispatch, "cam": cams, "gpu": gpu}}))
    return exported["worst"]


STEM = {"off": [], "full": ["TPU.STEM_S2D", "full"], "spatial": ["TPU.STEM_S2D", "spatial"]}
STEM_SMALL_BS = 8
# the fold is exact; only the order of summation differs
TOL_STEM = 1e-5
# the fp32 equality's grids: the clip in quarters, the stem's kernels in
# 64ths, so that each of the stem's fp32 sums is exact in any order
CLIP_GRID, STEM_GRID = 2.0 ** -2, 2.0 ** -6
# the ring's q/k kernels times this in its tight comparison: at the init's
# scale a block's similarities reach the hundreds, its softmax is
# saturated and the relaxed-Bernoulli draw amplifies the last fp32 bit of
# p by 1 / p
EMBED_SCALE = 0.03
# at the init's scale: the card's fp32 distance from float64 within this
# many times the CPU fp32 run's (scaled by their similarities' distances),
# and the card's float64 steps before the propagation within TOL_F64 of
# the CPU's
RING_CONTROL = 4.0
TOL_F64 = 1e-9
# the graph block at S3D's base.5 input of the 16x112x112 step: 192
# channels at 28x28, inter 96, one GCN layer; B clips of RING_T frames
RING_B, RING_T, RING_HW, RING_C = 8, 64, 28, 192
RING_ITERS = 3
TOL_RING = 1e-4
CKPT_STEPS = 4


def stem_device_ms(dev, gpu: str) -> dict:
    """Each stem's forward + backward (train mode, bf16) on the step's
    input, bs 128 x 3 x 16 x 112 x 112: device ms per pass from the
    profiler (``kernel_times.device_us``, every kernel of the pass)."""
    from video_graph_ssl_tpu_torch.models.layers import (SepConv3d, SepConvS2D, init_params_,
                                                         place)

    g = torch.Generator(device=dev).manual_seed(19)
    x = torch.randn(128, 3, 16, 112, 112, device=dev, generator=g).to(torch.bfloat16)
    x = x.contiguous(memory_format=CL)
    gout = torch.randn(128, 64, 8, 56, 56, device=dev, generator=g).to(torch.bfloat16)
    out = {}
    for mode in STEM:
        stem = (SepConv3d(3, 64, 7, 2, 3) if mode == "off"
                else SepConvS2D(3, 64, temporal_s2d=mode == "full"))
        init_params_(stem, torch.Generator().manual_seed(3))
        stem = place(stem, dev).train()
        out[mode] = device_us(lambda: stem(x).backward(gout), ".", iters=20) / 1e3
        print(f"  (a) stem {mode}: {out[mode]:.3f} device ms per forward + backward at bs 128 "
              f"on {gpu}")
        del stem
    return out


STEM_CHECKS = {"stem_output": "the stem's output (rel-L2)", "features": "features (rel-L2)",
               "loss": "loss (relative)", "outside_worst": "each gradient outside the stem",
               "stem_grads_worst": "each stem gradient, fold's adjoint"}


def fold_adjoint(grad: torch.Tensor, shape, axes: str) -> torch.Tensor:
    """The adjoint of the stem's fold (``fold_stem_weight``) applied to a
    folded kernel's gradient: each standard tap's gradient is the sum of
    the gradients of the folded entries that copy it (the fold of the
    taps' 1-based indices says which; 0 marks the zero taps)."""
    from video_graph_ssl_tpu_torch.models.layers import fold_stem_weight

    n = math.prod(shape)
    idx = fold_stem_weight(torch.arange(1, n + 1, dtype=torch.float64).reshape(shape), axes)
    out = torch.zeros(n + 1, dtype=torch.float64)
    out.index_add_(0, idx.long().flatten(), grad.double().flatten().cpu())
    return out[1:].reshape(shape)


def stem_same_function(dev) -> dict:
    """One fp32 forward + backward of the GCA MoCo model (S3D, graph at 5,
    9, 14, bs STEM_SMALL_BS, 16x112x112, eval-mode BN, TF32 off, cuDNN
    deterministic) with the standard stem, then with each S2D stem on the
    fold of the same weights.  The weights are the init's, except that
    the stem's two kernels are rounded to STEM_GRID and bn_s's running
    variance is 1 - eps (so bn_s maps its input to itself); the clip is on
    CLIP_GRID.  Then every product and partial sum of the stem's convs is
    exact in fp32, the summation order cannot matter, and no ReLU or
    max-pool downstream can flip on a rounding difference.  Held within
    TOL_STEM rel-L2: the stem's output, the features, the loss, every
    gradient outside the stem (each on its own), and each stem gradient
    against the standard stem's through the fold's adjoint."""
    from video_graph_ssl_tpu_torch.graph_benefit import reproducible_fp32
    from video_graph_ssl_tpu_torch.models.build import create_visual_model
    from video_graph_ssl_tpu_torch.models.layers import place
    from video_graph_ssl_tpu_torch.models.s3d import stem_params_to_s2d
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    g = torch.Generator().manual_seed(23)
    x = torch.randn(STEM_SMALL_BS, 16, 112, 112, 3, generator=g).div(CLIP_GRID).round() \
        .mul(CLIP_GRID)
    w = torch.randn(STEM_SMALL_BS, 128, generator=g)
    stem = "model.encoder.base_model.base.0."
    runs, base = {}, None
    with reproducible_fp32():
        for mode in STEM:
            model, _ = create_visual_model(load_config(CONFIG, [
                "MODEL.AUG_FLAG", "True", "TPU.COMPUTE_DTYPE", "float32", *STEM[mode]]))
            if base is None:
                eps = model.get_submodule(stem + "bn_s").eps
                base = dict(model.state_dict())
                for k in (stem + "conv_s.weight", stem + "conv_t.weight"):
                    base[k] = base[k].div(STEM_GRID).round().mul(STEM_GRID)
                var = base[stem + "bn_s.running_var"]
                base[stem + "bn_s.running_var"] = torch.full_like(var, 1 - eps)
                if float(base[stem + "bn_s.running_var"][0] + torch.tensor(eps)) != 1.0:
                    raise RuntimeError("phase 19 (a): bn_s's running variance + eps is not 1")
            model.load_state_dict(base if mode == "off" else stem_params_to_s2d(base, mode),
                                  strict=True)
            model = place(model, dev).eval()
            got = {}
            hook = model.get_submodule(stem[:-1]).register_forward_hook(
                lambda m, i, o: got.update(stem=o.detach().float().cpu()))
            feat = model(x.to(dev))
            (feat - w.to(dev)).square().mean().backward()
            hook.remove()
            runs[mode] = dict(stem=got["stem"], feat=feat.detach().float().cpu(),
                              grads={n: p.grad.detach().double().cpu()
                                     for n, p in model.named_parameters()})
            del model, feat
    ref = runs["off"]
    loss0 = float((ref["feat"] - w).square().mean())
    out = {}
    for mode in ("full", "spatial"):
        run = runs[mode]
        folded = {"conv_s": "hw", "conv_t": "t"} if mode == "full" else {"conv_s": "hw"}
        outside, inside = {}, {}
        for n, g0 in ref["grads"].items():
            g1 = run["grads"][n]
            if not n.startswith(stem):
                outside[n] = rel_l2(g1, g0)
                continue
            part = n[len(stem):].split(".")[0]
            if part in folded and n.endswith(".weight"):
                g1 = fold_adjoint(g1, g0.shape, folded[part])
            inside[n[len(stem):]] = rel_l2(g1, g0)
        errs = {"stem_output": rel_l2(run["stem"], ref["stem"]),
                "features": rel_l2(run["feat"], ref["feat"]),
                "loss": abs(float((run["feat"] - w).square().mean()) - loss0) / loss0,
                "outside_worst": max(outside.values()),
                "stem_grads_worst": max(inside.values())}
        worst = max(outside, key=outside.get)
        for k, v in errs.items():
            check(f"phase 19 (a) {mode}: {STEM_CHECKS[k]}", v, TOL_STEM)
        out[mode] = {**errs, "stem_output_bit_equal": bool(torch.equal(run["stem"], ref["stem"])),
                     "outside_worst_name": worst, "stem_grads": inside}
        print(f"  (a) {mode}: stem output {errs['stem_output']:.2e} (bit for bit: "
              f"{out[mode]['stem_output_bit_equal']}), features {errs['features']:.2e}, loss "
              f"{errs['loss']:.2e}; the {len(outside)} gradients outside the stem: worst "
              f"{errs['outside_worst']:.2e} ({worst}); the stem's through the fold's adjoint: "
              + ", ".join(f"{k} {v:.2e}" for k, v in inside.items()))
    return out


def s2d_full_width(dev, gpu: str) -> dict:
    """(a): the S2D stems at the shipped geometry: K1-K4 against their
    plain versions at the step's shapes (the stem leaves every later shape
    as it is), the trainer (bs 128, bf16) under off, full and spatial:
    ms/step, peak memory and the kernel counts (run_trainer holds them);
    the stems' device ms; the fp32 equality of the function."""
    k1_shapes, k2_shapes, pools = geometry(112, 128)[:3]
    worst = kernel_checks(dev, "phase 19 (a)", k1_shapes, k2_shapes, pools, "bf16")
    runs = {m: run_trainer(dev, gpu, fused=False, opts=STEM[m]) for m in STEM}
    out = {m: {"ms_per_step": r["ms"], "peak_gib": r["peak_gib"]} for m, r in runs.items()}
    for m in ("full", "spatial"):
        print(f"  (a) STEM_S2D {m}: {out[m]['ms_per_step']:.1f} ms/step against off's "
              f"{out['off']['ms_per_step']:.1f}, peak {out[m]['peak_gib']:.2f} GiB against "
              f"{out['off']['peak_gib']:.2f} GiB on {gpu}")
    _free()
    stem_ms = stem_device_ms(dev, gpu)
    _free()
    same = stem_same_function(dev)
    _free()
    return {"worst": worst, "trainer": out, "stem_device_ms": stem_ms, "same_function": same}


def ring_inputs(t: int, seed: int = 29, scale: float = EMBED_SCALE) -> tuple:
    """(state_dict, x, cotangent, noise) on the CPU: the graph block at
    base.5's width (fan-in init from ``seed``, the q/k kernels times
    ``scale``: at the init's own scale, 1, the similarities over D = 18,816
    saturate the softmax, and the relaxed-Bernoulli draw then amplifies the
    last fp32 bit of p by 1 / p), RING_B clips of ``t`` frames, and a
    U(eps, 1 - eps) draw of (RING_B, t, t)."""
    from video_graph_ssl_tpu_torch.models.layers import init_params_
    from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug

    module = TemporalGraphAug(RING_C, dtype=torch.float32)
    init_params_(module, torch.Generator().manual_seed(seed))
    with torch.no_grad():   # off the saturated softmax, as in stem_same_function
        for embed in (module.g_q, module.g_k):
            embed[0].weight.mul_(scale)
    g = torch.Generator().manual_seed(seed + 1)
    shape = (RING_B, t, RING_HW, RING_HW, RING_C)
    x, gout = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    noise = torch.rand(RING_B, t, t, generator=g) * (1 - 2e-6) + 1e-6
    return module.state_dict(), x, gout, noise


def ring_run(device: str, rank: int, world: int, dn: str, t: int, alone: bool = False,
             scale: float = EMBED_SCALE) -> dict:
    """This rank's frames of ``ring_inputs(t, scale=scale)`` through the ring
    (``sp_graph_aug_apply``, relaxed-Bernoulli with the injected draw) in
    ``dn``: a warm-up, then RING_ITERS forward + backward passes, each
    timed on the host; the output, dx, the weight gradients summed over the
    ranks, K2's launches and the bytes sent per pass.  ``alone`` (one
    rank): the module's own forward with the same draw beside it."""
    from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug
    from video_graph_ssl_tpu_torch.parallel import sequence

    sd, x, gout, noise = ring_inputs(t, scale=scale)
    dt = DTYPES[dn]
    module = TemporalGraphAug(RING_C, dtype=dt)
    module.load_state_dict(sd)
    module = module.to(device).train()
    tl = t // world
    frames = slice(rank * tl, (rank + 1) * tl)
    x_local = x[:, frames].to(device).to(dt)
    g_local = gout[:, frames].to(device).to(dt)
    kw = dict(tem_len=t, sampler="relaxed_bernoulli", noise=noise[:, frames].to(device))

    def pass_():
        module.zero_grad()
        xl = x_local.clone().requires_grad_()
        y = sequence.sp_graph_aug_apply(module, xl, **kw)
        y.backward(g_local)
        return y, xl.grad

    pass_()
    torch.cuda.synchronize()
    torch.distributed.barrier()
    tracing.reset_counters()
    sequence.sent_bytes = 0
    ms = []
    for _ in range(RING_ITERS):
        t0 = time.perf_counter()
        y, dx = pass_()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    res = {"y": y.detach().float().cpu(), "dx": dx.float().cpu(), "ms": ms,
           "k2": tracing.counters()["gcn_propagate"] / RING_ITERS,
           "sent": sequence.sent_bytes / RING_ITERS}
    grads = {}
    for n, p in module.named_parameters():
        grads[n] = p.grad.detach().float().cpu()
        if world > 1:
            torch.distributed.all_reduce(grads[n])
    res["grads"] = grads
    if alone:
        with torch.no_grad():
            ref = module(x_local, noise=kw["noise"])
        res["module_err"] = rel_l2(y.detach().float(), ref.float())
    return res


def _ring_rank_main(rank: int, world: int, backend: str, init: str, out: str, runs: list,
                    run_dir: str) -> None:
    """One rank of phase 19 (b) (on cuda:0 over gloo, cuda:rank over
    NCCL): ``ring_run`` for each of ``runs``."""
    from video_graph_ssl_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = f"cuda:{rank if backend == 'nccl' else 0}"
    torch.cuda.set_device(device)
    dist.init_distributed(backend, init, world, rank)
    try:
        torch.save([ring_run(device, rank, world, **run) for run in runs], out)
    finally:
        torch.distributed.destroy_process_group()


def graph_rows(module, x: torch.Tensor, noise: torch.Tensor, tl: int) -> dict:
    """The ring's steps before the propagation, in one process on ``x``'s
    device in ``module``'s dtype: the q embedding, the similarity q . k
    from the ring's (B, tl, D) x (B, D, tl) block products (summed in that
    dtype), the adjacency (softmax times the hop weights) and its
    relaxed-Bernoulli sample on ``noise``."""
    from video_graph_ssl_tpu_torch.ops.graph_kernel import relaxed_bernoulli
    from video_graph_ssl_tpu_torch.ops.temporal_graph import _theta

    b, t = x.shape[:2]
    with torch.no_grad():
        q = module._embed_apply(module.g_q, x).reshape(b, t, -1)
        k = module._embed_apply(module.g_k, x).reshape(b, t, -1)
        sim = torch.cat([torch.cat([torch.bmm(q[:, i:i + tl], k[:, j:j + tl].transpose(1, 2))
                                    for j in range(0, t, tl)], dim=2)
                         for i in range(0, t, tl)], dim=1)
        theta = _theta(t, module.max_hop, float(module.alpha), str(x.device))
        adj = torch.softmax(sim, dim=-1) * theta.to(sim.dtype)[None]
        sampled = relaxed_bernoulli(adj, noise.to(adj), module.temperature)
    return {"q": q, "sim": sim, "adj": adj, "sampled": sampled}


def ring_at_init_scale(dev, run: list, on_cpu, gpu: str) -> dict:
    """(b) at the init's own q/k scale, where a row's similarities reach
    the thousands and the softmax is saturated.  (1) The steps before the
    propagation (``graph_rows``) in float64 on the card against float64 on
    the CPU, within TOL_F64: the same function.  (2) The two gloo ranks'
    fp32 output, dx and summed weight gradients (``run``) and one CPU fp32
    process (``on_cpu``), each against a float64 CPU process: the card's
    distance within RING_CONTROL times the CPU's, times how much further
    the card's fp32 similarity is from float64 than the CPU's (the
    saturated softmax carries that error to everything after it)."""
    from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug

    sd, x, _, noise = ring_inputs(RING_T, scale=1.0)
    stages = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        for dtype in (torch.float32, torch.float64):
            module = TemporalGraphAug(RING_C, dtype=dtype).to(dtype)
            module.load_state_dict(sd)
            got = graph_rows(module.to(device), x.to(device, dtype), noise.to(device),
                             RING_T // 2)
            stages[(where, str(dtype)[6:])] = {k: v.cpu() for k, v in got.items()}
            del module, got
    ref = stages[("cpu", "float64")]
    rows = {f"{w} {d}": {k: rel_l2(v, ref[k]) for k, v in got.items()}
            for (w, d), got in stages.items() if (w, d) != ("cpu", "float64")}
    print("  (b) init scale, the steps before the propagation (the ring's block products, "
          "one process, T 64) against float64 on the CPU (rel-L2): " + "; ".join(
              f"{name}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              for name, errs in rows.items()) + f" on {gpu}")
    for k, v in rows["card float64"].items():
        check(f"phase 19 (b) init scale, {k}: card float64 against the CPU's", v, TOL_F64)
    sim_ratio = max(1.0, rows["card float32"]["sim"] / rows["cpu float32"]["sim"])
    y64, dx64, g64 = on_cpu(torch.float64, 1.0)
    y32, dx32, g32 = on_cpu(torch.float32, 1.0)
    card = {"y": torch.cat([r["y"] for r in run], dim=1),
            "dx": torch.cat([r["dx"] for r in run], dim=1), **run[0]["grads"]}
    cpu = {"y": y32, "dx": dx32, **g32}
    want = {"y": y64, "dx": dx64, **g64}
    out = {"before_propagation": rows, "sim_ratio": sim_ratio}
    for k, ref in want.items():
        out[k] = {"card_vs_f64": rel_l2(card[k], ref), "cpu_fp32_vs_f64": rel_l2(cpu[k], ref),
                  "card_vs_cpu_fp32": rel_l2(card[k], cpu[k])}
    print("  (b) init scale, fp32, two gloo ranks on the card and one CPU process, each "
          "against float64 on the CPU (rel-L2): " + "; ".join(
              f"{k} card {out[k]['card_vs_f64']:.2e}, CPU {out[k]['cpu_fp32_vs_f64']:.2e}"
              for k in want) + f"; the card's fp32 similarity {sim_ratio:.1f} x as far from "
          f"float64 as the CPU's on {gpu}")
    for k in want:
        check(f"phase 19 (b) init scale, {k}: card from float64, "
              f"{RING_CONTROL:g} x {sim_ratio:.1f} x CPU fp32's", out[k]["card_vs_f64"],
              RING_CONTROL * sim_ratio * out[k]["cpu_fp32_vs_f64"])
    return out


def ring_on_card(dev, gpu: str) -> dict:
    """(b): the ring on two gloo ranks sharing the card (Tl = 32, K2's
    limit) in fp32 and bf16 against one CPU process (the plain versions),
    the q/k kernels times EMBED_SCALE; at the init's own scale, the card's
    fp32 ring and the CPU's fp32 process each against a float64 CPU
    process (``ring_at_init_scale``); K2 at the ring's block shape; one
    NCCL rank at T = 32 against the module."""
    from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug
    from video_graph_ssl_tpu_torch.parallel import sequence

    tl = RING_T // 2
    worst = kernel_checks(dev, "phase 19 (b) ring block", [],
                          [(RING_B, tl, RING_HW, RING_HW, RING_C)], [], "fp32")
    def on_cpu(dtype, scale):
        sd, x, gout, noise = ring_inputs(RING_T, scale=scale)
        module = TemporalGraphAug(RING_C, dtype=dtype).to(dtype)
        module.load_state_dict(sd)
        xr = x.to(dtype).requires_grad_()
        t0 = time.perf_counter()
        y = sequence.graph_aug_sequence_parallel(module.train(), xr, sampler="relaxed_bernoulli",
                                                 noise=noise)
        y.backward(gout.to(dtype))
        print(f"  (b) one CPU process (plain versions, {str(dtype)[6:]}, q/k scale {scale:g}): "
              f"{time.perf_counter() - t0:.1f} s")
        return y.detach(), xr.grad, {n: p.grad for n, p in module.named_parameters()}

    y_ref, dx_ref, grads_ref = on_cpu(torch.float32, EMBED_SCALE)
    ranks = spawn_ranks([dict(dn="fp32", t=RING_T), dict(dn="bf16", t=RING_T),
                         dict(dn="fp32", t=RING_T, scale=1.0)], 2, "gloo",
                        target=_ring_rank_main)
    out = {}
    for dn, run in zip(("fp32", "bf16"), ranks):
        y = torch.cat([r["y"] for r in run], dim=1)
        dx = torch.cat([r["dx"] for r in run], dim=1)
        errs = {"y": rel_l2(y, y_ref), "dx": rel_l2(dx, dx_ref),
                "grads": max(rel_l2(run[0]["grads"][n], v) for n, v in grads_ref.items())}
        if not (bool(y.isfinite().all()) and bool(dx.isfinite().all())):
            raise RuntimeError(f"phase 19 (b) {dn}: non-finite output or dx")
        for r in run:
            if r["k2"] != 2 * 2:
                raise RuntimeError(f"phase 19 (b) {dn}: {r['k2']} K2 launches per pass, "
                                   "want 4 (2 ring steps forward, 2 backward)")
        if dn == "fp32":
            for k, v in errs.items():
                check(f"phase 19 (b) two gloo ranks, fp32, {k} against one CPU process", v,
                      TOL_RING)
        ms = [sorted(r["ms"])[len(r["ms"]) // 2] for r in run]
        out[dn] = {"errors": errs, "host_ms": ms, "sent_bytes": run[0]["sent"],
                   "k2_per_pass": run[0]["k2"]}
        print(f"  (b) {dn}, 2 gloo ranks on one card, B {RING_B} x T {RING_T} (Tl {tl}) x "
              f"{RING_HW}x{RING_HW}x{RING_C}: host ms per forward + backward per rank "
              f"{[f'{m:.1f}' for m in ms]}, {run[0]['sent'] / 1e6:.2f} MB sent per rank per "
              f"pass, K2 {run[0]['k2']:.0f} launches per pass; against one CPU process: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (rel-L2) on {gpu}")
    out["init_scale"] = ring_at_init_scale(dev, ranks[2], on_cpu, gpu)
    one = spawn_ranks([dict(dn="fp32", t=tl, alone=True)], 1, "nccl",
                      target=_ring_rank_main)[0][0]
    check("phase 19 (b) one NCCL rank, T 32: ring against the module (rel-L2)",
          one["module_err"], TOL["fp32"])
    print(f"  (b) one NCCL rank, T {tl}: the ring's output against the single-device "
          f"TemporalGraphAug with the same draw {one['module_err']:.2e} (rel-L2), "
          f"K2 {one['k2']:.0f} launches per pass")
    out["nccl_one_rank"] = {"module_err": one["module_err"], "k2_per_pass": one["k2"]}
    return {"worst": worst, **out}


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def sharded_backend(dev, gpu: str) -> dict:
    """(c): the (a) step (STEM_S2D full, bs 128, bf16, cuDNN deterministic)
    under TPU.CKPT_BACKEND orbax with TPU.ASYNC_CKPT: steps 1-2, an async
    save, steps 3-4; a fresh model (another seed) loads the directory and
    must hold the saved state bit for bit, then runs step 3; a control
    reruns step 3 from the saved state restored in memory; the sync save's
    and the load's times."""
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config
    from video_graph_ssl_tpu_torch.utils import checkpoint as ckpt

    opts = ["MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "synthetic", "TPU.CKPT_BACKEND",
            "orbax", "TPU.ASYNC_CKPT", "True", *STEM["full"]]

    def trainer(seed=None):
        c = load_config(CONFIG, opts + ([] if seed is None else ["MODEL.SEED", str(seed)]))
        return Trainer(c, max_steps=CKPT_STEPS, device=str(dev), run_dir=RUN_DIR)

    torch.backends.cudnn.deterministic = True
    try:
        a = trainer()
        feed, step = _stepper(a)
        epoch = a.train_loader.epoch(0)
        batches = [feed(b) for b in itertools.islice(epoch, CKPT_STEPS)]
        epoch.close()
        lr = a.lr_fn(0)
        losses = [float(step(batches[i], lr)["loss"]) for i in range(2)]
        torch.cuda.synchronize()
        saved = _cpu(ckpt.checkpoint_payload(a.state, 1))
        t0 = time.perf_counter()
        path = a.saver.save_checkpoint(a.state, 1, filename="checkpoint_2.pth.tar")
        blocking_async = time.perf_counter() - t0
        losses += [float(step(batches[i], lr)["loss"]) for i in range(2, CKPT_STEPS)]
        t0 = time.perf_counter()
        ckpt.wait_for_async_checkpoints()
        drain = time.perf_counter() - t0
        del a
        _free()
        b = trainer(seed=77)
        t0 = time.perf_counter()
        meta = ckpt.load_checkpoint_state(path, b.state)
        load_s = time.perf_counter() - t0
        bad = ckpt.mismatches(_cpu(ckpt.checkpoint_payload(b.state, 1)), saved)
        if bad or meta["step"] != 2:
            raise RuntimeError(f"phase 19 (c): the loaded state differs at {bad[:8]}")
        resumed = float(_stepper(b)[1](batches[2], lr)["loss"])
        sync_path = path.replace(".dcp", "_sync.dcp")
        t0 = time.perf_counter()
        ckpt.save_checkpoint_orbax(sync_path, b.state, 1)
        blocking_sync = time.perf_counter() - t0
        del b
        _free()
        c = trainer(seed=78)
        ckpt.restore_payload(c.state, saved, "the saved state in memory")
        control = float(_stepper(c)[1](batches[2], lr)["loss"])
        del c, batches
        _free()
    finally:
        torch.backends.cudnn.deterministic = False
    err, floor = abs(resumed - losses[2]), abs(control - losses[2])
    if err > floor:
        raise RuntimeError(f"phase 19 (c): the resumed step 3's loss {resumed!r} is "
                           f"{err:.3e} from the uninterrupted {losses[2]!r}, the control "
                           f"{control!r} {floor:.3e}")
    out = {"bytes": _dir_bytes(path), "blocking_async_s": blocking_async,
           "drain_s": drain, "blocking_sync_s": blocking_sync, "load_s": load_s,
           "losses": losses, "resumed_loss_3": resumed, "control_loss_3": control}
    print(f"  (c) {os.path.basename(path)}: {out['bytes'] / 1e6:.1f} MB in "
          f"{len(os.listdir(path))} files; save blocks {blocking_async * 1e3:.1f} ms async "
          f"(drained {drain * 1e3:.1f} ms later, after steps 3-4), "
          f"{blocking_sync * 1e3:.1f} ms sync; load {load_s * 1e3:.1f} ms; every parameter, "
          f"buffer, optimizer slot, queue and EMA entry equal bit for bit; step 3's loss "
          f"uninterrupted {losses[2]!r}, resumed {resumed!r}, control {control!r} on {gpu}")
    return out


def phase_s2d_ring_ckpt(dev, gpu: str) -> dict:
    print("phase 19: the space-to-depth stem, the frame-axis ring and the sharded "
          "checkpoint backend")

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"  ({name}: {time.perf_counter() - t0:.1f} s)")
        return out

    print("  (a) TPU.STEM_S2D full and spatial on the GCA MoCo step (S3D + graph at 5, 9, 14, "
          "bs 128, 16x112x112, bf16, NCE_K 16384)")
    s2d = part("a", s2d_full_width, dev, gpu)
    print(f"  (b) the graph block's ring over the frame axis (base.5's width, B {RING_B}, "
          f"T {RING_T})")
    ring = part("b", ring_on_card, dev, gpu)
    print("  (c) TPU.CKPT_BACKEND orbax with TPU.ASYNC_CKPT on (a)'s step")
    sharded = part("c", sharded_backend, dev, gpu)
    print(json.dumps({"s2d_ring_ckpt": {"s2d": s2d, "ring": ring, "ckpt": sharded,
                                        "gpu": gpu}}))
    return {k: max(s2d["worst"].get(k, 0.0), ring["worst"].get(k, 0.0))
            for k in ("K1", "K2", "K3", "K4")}


# SlowFast-R50 8x8 at its cell's size (bs 64, 32x224x224): K2's input at
# the Fast pathway's graph blocks (the inputs of res3-res5; T = 32 at each,
# K1's tile-8 route and K2's route with kpad 32), K1's q/k from them, and the
# two 1x3x3 / (1, 2, 2) stem pools (Slow 64 channels at 8 frames, Fast 8 at
# 32).  K1 is held to PERF.md's K1 row (the largest |kernel - plain| the
# S3D step's shapes read in bf16); K2 in bf16 to one bf16 ulp of the largest
# |plain| output: a sum over 32 frames is larger than over 8, so one rounding
# there is larger than PERF.md's K2 row, read at T <= 8 (in fp32 K2 is held
# to ``TOL`` by ``kernel_checks``)
SLOWFAST = "slowfast_r50"
SLOWFAST_K2 = [(64, 32, 56, 56, 32), (64, 32, 28, 28, 64), (64, 32, 14, 14, 128)]
SLOWFAST_POOLS = [("slow stem", "K4", (64, 8, 112, 112, 64), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
                  ("fast stem", "K4", (64, 32, 112, 112, 8), (1, 3, 3), (1, 2, 2), (0, 1, 1))]
PERF_ROW_K1_MAX_ABS = 6.6e-5


def ulp_of_largest(y: torch.Tensor) -> float:
    """The spacing of ``y``'s dtype at its largest magnitude."""
    top = float(y.float().abs().max())
    return torch.finfo(y.dtype).eps * 2.0 ** math.floor(math.log2(top)) if top else 0.0


def k2_within_an_ulp(dev, shapes) -> None:
    """K2 both ways at ``shapes`` in bf16: largest |kernel - plain| no more
    than one ulp of the largest |plain|."""
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp

    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(21)
    for shape in shapes:
        b, t = shape[:2]
        x = torch.randn(shape, device=dev, generator=g).to(dt)
        adj = torch.rand(b, t, t, device=dev, generator=g).to(dt)
        for tr in (False, True):
            out, ref = gp._launch(adj, x, transpose=tr), gp.propagate_plain(adj, x, transpose=tr)
            check(f"(a) K2 {shape} bf16 transpose={tr} |kernel - plain| (1 ulp)",
                  max_abs(out, ref), ulp_of_largest(ref))
            del out, ref
        _free()


def phase_slowfast(dev, gpu: str) -> dict:
    """Phase 20: K1, K2 and K4 against their plain versions at SlowFast's
    shapes, fp32 and bf16 (``kernel_checks``: K1 at T = 32 on its tile-8
    route, K2 both ways on its tensor-core route with kpad 32); the pool
    forward kernel bit for bit against the library at the two stem pools
    (``pool_fwd_bits``); K1's largest |kernel - plain| within PERF.md's K1
    row and K2's in bf16 within one ulp of its largest output
    (``k2_within_an_ulp``); K1, K2 and K4 times in bf16
    (``resnet_kernel_times``)."""
    from video_graph_ssl_tpu_torch.kernel_times import k1_shape
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk

    print("phase 20: SlowFast-R50 8x8's kernels at bs 64, 32x224x224")
    k1 = [k1_shape(s_) for s_ in SLOWFAST_K2]
    for b, t, d in k1:
        plan = gk._cached_plan(b, t, d, torch.bfloat16, True)
        print(f"  K1 ({b},{t},{d}) bf16: tile {plan.tile}, {plan.splits} splits")
    for shape in SLOWFAST_K2:
        b, t, h, w, c = shape
        plan = gp._cached_plan(b, t, h * w * c, torch.bfloat16, True)
        print(f"  K2 {shape} bf16: route {plan.route}, kpad {plan.kpad}")
        if (plan.route, plan.kpad) != ("tc", 32):
            raise RuntimeError(f"K2 {shape}: route {plan.route} kpad {plan.kpad} (want tc 32)")
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    for dn in DTYPES:
        w = kernel_checks(dev, f"(a) {SLOWFAST}", k1, SLOWFAST_K2, SLOWFAST_POOLS, dn)
        check(f"(a) K1 {dn} largest |kernel - plain| (PERF.md's row)", w["K1"],
              PERF_ROW_K1_MAX_ABS)
        worst = {k: max(v, w[k]) for k, v in worst.items()}
        _free()
    k2_within_an_ulp(dev, SLOWFAST_K2)
    g = torch.Generator(device=dev).manual_seed(20)
    for name, _, shape, k, s_, p in SLOWFAST_POOLS:
        for dn in DTYPES:
            n = pool_fwd_bits(dev, g, shape, k, s_, p, dn)[0]
            check(f"(b) fwd {name} {shape} {dn} vs library (bits differing)", n, 0)
            _free()
    resnet_kernel_times(dev, gpu, k1, SLOWFAST_K2, SLOWFAST_POOLS, key="slowfast_kernels")
    _free()
    print(json.dumps({"slowfast": {"worst": worst, "gpu": gpu}}))
    return worst


# the stems of the benchmark's cells and the other 3D backbones' (x (B, T, H,
# W, C), weight (F, C, kt, kh, kw), stride, (lo, hi) pads, Slow frames, the
# layout the stem meets: "cl" a contiguous bf16 clip (S3D's and I3D's
# StagedBackbone casts it), "planar" a view of the augmentation's bf16 output,
# one of two views, each frame's channel planes apart with H fastest)
STEM_SHAPES = {
    "S3D conv_s bs256": ((256, 16, 112, 112, 3), (64, 3, 1, 7, 7), (1, 2, 2),
                         ((0, 0), (3, 3), (3, 3)), None, "cl"),
    "I3D-R50-NL conv1 bs256": ((256, 16, 112, 112, 3), (64, 3, 5, 7, 7), (2, 2, 2),
                               ((2, 2), (3, 3), (3, 3)), None, "planar"),
    "SlowFast Slow bs64": ((64, 32, 224, 224, 3), (64, 3, 1, 7, 7), (1, 2, 2),
                           ((0, 0), (3, 3), (3, 3)), (0, 4, 8, 13, 17, 22, 26, 31), "planar"),
    "SlowFast Fast bs64": ((64, 32, 224, 224, 3), (8, 3, 5, 7, 7), (1, 2, 2),
                           ((2, 2), (3, 3), (3, 3)), None, "planar"),
    "I3D conv3d_1a bs128": ((128, 16, 112, 112, 3), (64, 3, 7, 7, 7), (2, 2, 2),
                            ((2, 3), (2, 3), (2, 3)), None, "cl"),
    "R3D conv1 bs128": ((128, 16, 112, 112, 3), (64, 3, 7, 7, 7), (1, 2, 2),
                        ((3, 3), (3, 3), (3, 3)), None, "planar"),
    "CMC Flow conv_s bs128": ((128, 16, 112, 112, 2), (64, 2, 1, 7, 7), (1, 2, 2),
                              ((0, 0), (3, 3), (3, 3)), None, "planar"),
}


def stem_input(xs, layout: str, g, dev) -> torch.Tensor:
    """A bf16 clip (B, T, H, W, C) as the stem meets it (``STEM_SHAPES``)."""
    b, t, h, w, c = xs
    if layout == "cl":
        return torch.randn(xs, generator=g, device=dev).to(torch.bfloat16)
    two = torch.randn((b, 2, t, c, w, h), generator=g, device=dev).to(torch.bfloat16)
    return two.permute(0, 1, 2, 5, 4, 3)[:, 1]


def phase_stem(dev, gpu: str, shapes=None) -> dict:
    """Phase 21: the stems' convolution kernel through its operator against
    its plain version (``F.conv3d`` on the bf16 NCDHW clip) at
    ``STEM_SHAPES``, the bf16 clip as the stem meets it: the largest
    |kernel - plain| within one bf16 ulp of the plain version's largest
    output; each call's event ms beside its bound, ``F.conv3d``'s ms (the
    plain version, which is the library path the stems took before the
    kernel) and the ms of the library's tensor-core path for the same
    convolution: C zero-padded to 8 in one copy of the clip, then cuDNN's
    bf16 channels-last convolution, with cuDNN's own choice and its
    fastest (``cudnn.benchmark``), and that convolution alone.  Returns
    the kernel record (row S) from S3D's stem."""
    import torch.nn.functional as F

    from video_graph_ssl_tpu_torch.ops import stem_conv as sc

    print(f"phase 21: the stems' convolution forward vs F.conv3d ({gpu})")
    variants = sc.kernel_variants(True)
    print("  instantiations (index, NT, MT, warps, blocks an SM, registers; bf16 x): "
          + ", ".join(str(tuple(v)) for v in variants))
    g = torch.Generator(device=dev).manual_seed(21)
    out = {}
    for name, (xs, ws, stride, pads, frames, layout) in (shapes or STEM_SHAPES).items():
        x = stem_input(xs, layout, g, dev)
        w = (torch.randn(ws, generator=g, device=dev) / math.sqrt(math.prod(ws[1:]))).to(
            torch.bfloat16)
        fr = None if frames is None else torch.tensor(frames, dtype=torch.int64, device=dev)
        flat = [v for pair in pads for v in pair]
        tsel = xs[1] if fr is None else len(fr)
        plan = sc.plan(xs, tsel, ws, stride, pads, variants)
        c = xs[4]
        wp = F.pad(w, (0, 0, 0, 0, 0, 0, 0, 8 - c)).contiguous(
            memory_format=torch.channels_last_3d)
        sym = all(lo == hi for lo, hi in pads)
        conv_pad = [lo for lo, _ in pads] if sym else 0

        def kern():
            return sc.stem_conv3d_fwd_op(x, w, None, list(stride), flat, fr)

        def plain():
            return sc.stem_conv3d_plain(x, w, None, stride, flat, fr)

        def c8():
            """x's frames with C zero-padded to 8 (and the asymmetric pads),
            contiguous: (B, C, T, H, W) in channels_last_3d."""
            xf = x if fr is None else x.index_select(1, fr)
            spatial = () if sym else (*pads[2], *pads[1], *pads[0])
            return F.pad(xf, (0, 8 - c, *spatial)).permute(0, 4, 1, 2, 3)

        def padded():
            return F.conv3d(c8(), wp, None, stride, conv_pad)

        y, want = kern(), plain()
        torch.cuda.synchronize()
        big = float(want.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(big)) - 7)
        err = max_abs(y, want)
        check(f"{name} vs F.conv3d (max abs, 1 bf16 ulp of {big:.3f})", err, ulp)
        if not y.is_contiguous(memory_format=torch.channels_last_3d) or y.shape != want.shape:
            raise RuntimeError(f"{name}: y {tuple(y.shape)} not {tuple(want.shape)} "
                               "in channels_last_3d")
        padded_err = max_abs(padded(), want)
        del y, want
        tk, tl, tp = event_ms(kern), event_ms(plain), event_ms(padded)
        x8 = c8()
        tc = event_ms(lambda: F.conv3d(x8, wp, None, stride, conv_pad))
        torch.backends.cudnn.benchmark = True
        try:
            padded()
            tpb = event_ms(padded)
        finally:
            torch.backends.cudnn.benchmark = False
        del x8
        b, f = xs[0], ws[0]
        m = b * math.prod(plan.out)
        nbytes = b * tsel * math.prod(xs[2:]) * x.element_size() + m * f * 2
        flops = 2 * m * f * math.prod(ws[1:])
        bm, by = bound(nbytes, flops, "bf16")
        print(f"  {name} ({layout}): kernel {tk:.4f} ms  bound {bm:.4f} ms ({by}, "
              f"{100 * bm / tk:.1f}%)  F.conv3d {tl:.4f} ms  C padded to 8: {tp:.4f} ms "
              f"(cuDNN's fastest {tpb:.4f}, the convolution alone {tc:.4f}; max abs "
              f"{padded_err:.3e})  [strip {plan.rh} rows, {plan.warps} warps, {plan.smem} B, "
              f"{plan.units} units, variant {plan.variant}]")
        out[name] = {"ms": tk, "bound_ms": bm, "bound_by": by, "library_ms": tl,
                     "padded_ms": tp, "padded_fastest_ms": tpb, "padded_conv_ms": tc,
                     "max_abs_err": err, "ulp": ulp, "padded_max_abs_err": padded_err}
        del x
        _free()
    print(json.dumps({"stem": {"calls": out, "gpu": gpu}}))
    s3d = out.get("S3D conv_s bs256", next(iter(out.values())))
    # the plain version of the forward is the library's convolution itself
    return {"name": "stem_conv_fwd", "route": "cuda",
            "source": "video_graph_ssl_tpu_torch/csrc/stem_conv_fwd.cu",
            "replaces": "none (the JAX package leaves the stems to XLA)",
            "max_abs_err": max(v["max_abs_err"] for v in out.values()),
            "ms": s3d["ms"], "plain_ms": s3d["library_ms"], "bound_ms": s3d["bound_ms"],
            "bound_by": s3d["bound_by"], "library_ms": s3d["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from video_graph_ssl_tpu_torch.ops import _build

    gpu = gpu_line()
    print(gpu)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    global RUN_DIR
    RUN_DIR = tempfile.mkdtemp(prefix="chip_smoke_run_")
    atexit.register(shutil.rmtree, RUN_DIR, True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"-> {_build.library_path().name}")

    def timed(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"  ({fn.__name__}: {time.perf_counter() - t:.1f} s)")
        return out

    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        # development: the named phase functions alone (e.g. --only
        # phase_fused_ranks); no kernel record and no result line
        for name in sys.argv[2].split(","):
            timed(globals()[name], dev, gpu)
        print(f"phases {sys.argv[2]}: {time.perf_counter() - t0:.1f} s")
        return 0

    kernels = [timed(phase_k1, dev), timed(phase_k2, dev), *timed(phase_pools, dev),
               timed(phase_k5, dev)]
    counts, synthetic_ms = timed(phase_slice, dev, gpu)
    timed(phase_store, dev, gpu, synthetic_ms)
    timed(phase_ranks, dev, gpu)
    timed(phase_regimes, dev, gpu)
    ssl, best = timed(phase_downstream, dev, gpu)
    timed(phase_ab, dev, gpu)
    timed(phase_ds_ranks, dev, gpu, ssl, best)
    worst = timed(phase_backbones, dev, gpu)
    timed(phase_resnets, dev, gpu)
    timed(phase_fused_ranks, dev, gpu)
    cmc = timed(phase_cmc, dev, gpu)
    nonlocal_text = timed(phase_nonlocal_text, dev, gpu)
    exported = timed(phase_remat_export_cam, dev, gpu)
    s2d_ring = timed(phase_s2d_ring_ckpt, dev, gpu)
    slowfast = timed(phase_slowfast, dev, gpu)
    kernels.append(timed(phase_stem, dev, gpu))
    for k in kernels:   # the I3D pools', model_2's, phase 17's to 20's checks join the kernels'
        kn = {"graph_adjacency": "K1", "gcn_propagate": "K2", "maxpool_bwd_s1": "K3",
              "maxpool_bwd_strided": "K4"}.get(k["name"])
        if kn:
            k["max_abs_err"] = max(k["max_abs_err"], worst.get(kn, 0.0), cmc[kn],
                                   nonlocal_text[kn], exported[kn], s2d_ring[kn],
                                   slowfast[kn])
    print(f"all phases: {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
