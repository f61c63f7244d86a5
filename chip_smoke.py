#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100): ``python3 chip_smoke.py``.

Drives the paths of ``radardistill_tpu_torch`` through the entry points
a user calls, ``data.synthetic.make_batch`` (scenes, collation,
``HostPrecompute``) -> ``build_network`` -> ``PillarNet.forward``, and for
training ``train.optim.build_optimizer`` -> ``train.train_step.make_train_step``,
at full width and the full 1440² grid, with random weights from a seeded
``torch.Generator``:

  - the radar-only serving path (``radar_distill_val.yaml``, batch 1);
  - the distillation forward (``radar_distill_train.yaml`` in eval mode, batch
    2, 160 000 lidar points and 3000 radar returns per scene): the frozen
    LiDAR teacher with its static int8 stage 1 beside the radar student;
  - the distillation train step on the same batch: teacher forward without
    gradients, student forward in train mode, targets, head + AFD/PFD losses,
    backward, clip, AdamW with the one-cycle schedules;
  - the distillation forward under two deeper configurations of the teacher,
    built from the same yaml with ``BACKBONE_3D`` overrides: ``INT8_STAGES: 5``
    (the int8 chain through every stage) and ``FP_STAGES: 5`` (stages 2-5 as
    fused float links); and one train step with the ``INT8_STAGES: 5`` teacher;
  - the dense-input route through the CLIs: the LiDAR teacher of
    ``pillarnet.yaml`` trained on its own and evaluated, its checkpoint
    loaded into the distillation model, and the radar-only baseline of
    ``pillarnet_radar.yaml`` initialized from it, trained and evaluated;
  - the space-to-depth teacher trained: on its own through the CLIs
    (``pillarnet.yaml`` with the S2D backbone), and beside the student with
    ``FREEZE_PIPELINE: []``; its ``INT8: static`` eval on the dense-input,
    linear-order-table and ``_S2D2`` routes; the two accuracy gates, cut;
  - the last modules: the anchor family (``pointpillar_smoke.yaml``) through
    the CLIs and at full size, ``adam`` and ``sgd``, ``MODEL.REMAT`` on the
    radar baseline, the tile-sparse radar backbone, and the tools' last
    flags.

It imports only ``torch`` and ``radardistill_tpu_torch``. Phases:

  1. card: ``torch.cuda.is_available()`` (otherwise exit 2, no result) and the
     card's name and power limit from ``nvidia-smi``;
  2. build: one nvcc per ``radardistill_tpu_torch/csrc/*.cu``, all started
     together, for sm_90a; g++ builds the host library at first use;
  3. K5 ``expand_rows`` vs its plain version, bit-equal, at the shapes the two
     paths give it: the conv4 handoff (table 8193 x 256 per sample, 180²
     cells, bfloat16 and float32; batch 1 and 2) and the teacher's entry (int8
     table 2 x 163841 rows of 32 bytes into 2 x 1440² cells);
  4. K2 ``dcn_sample`` vs its plain version at the three CMA sites
     (180²->90², 90²->45², 180²->90², C 256, clamp R = 5), batch 1, 2 and 8
     (the radar baseline's): float32 within 1e-5 x max|ref| (summation
     order), bfloat16 within 1e-2 x max|ref| (one bfloat16 rounding of the
     same float32 sum); then with NaN offsets (NaN taps read exactly 0, as in
     the plain version). K3 ``dcn_offset_grad`` and K4 ``dcn_input_grad`` at
     the same three sites, batch 2 and 8, the same tolerances, offsets 3 x
     randn (a tenth on the clamp),
     K4 on its tile route and bit-equal over two calls; one unclamped float32
     case at 64² on K4's atomic route; NaN offsets on both routes (NaNs
     compared as equal); the four gradients of ``modulated_deform_conv`` vs
     autograd through ``dcn_sample_plain`` (float32, within 1e-4 x max|ref|).
     Each of K2, K3, K4 timed at batch 2 as the wrapper, as the bare launch, as the
     plain version, and beside them, as an aside that is not the same
     function (NCHW, no mask), ``F.grid_sample`` (K2) and
     ``grid_sampler_2d_backward`` with the mask folded into the cotangent
     (K4: its input gradient, K3: its grid gradient);
  5. K1 ``conv_block`` vs its plain version at the teacher's stage-1 link,
     x (2, 720, 720, 128) int8, kernel (3, 3, 128, 128), 4 mask phases: a
     chain's first link (zero 0, no residual) and a later one (zero 127, with
     residual), on the route the dispatch rule gives it (the ``wgmma`` conv
     mainloop, its counter moved); every int8 code equal, and equal to the
     old resident ``mma.sync`` variant's; the bfloat16 output within 1e-2 x
     max|ref|; the wrapper, the bare launch, the resident variant and the
     plain version timed in one run;
  6. val path, bfloat16: launch counts reset just before one forward and read
     just after (K5 x 1, K2 x 3); outputs finite and of the expected shapes,
     ``as_overflow == 0``; p50 latency over 20 synced runs;
  7. val path, float32 with TF32 off: the kernel path on the card vs the plain
     path (the same model on the CPU, where every wrapper takes its plain
     version), ``radar_preds`` rel-L2 <= 1e-4 per head;
  8. distillation forward, bfloat16: counts reset and read the same way
     (K1 x 4, all four on the ``wgmma`` route; K5 x 2: the teacher's entry and
     the student's handoff, K2 x 3);
     every output finite, ``as_overflow == 0``; p50 over 10 synced runs;
  9. distillation forward, float32 with TF32 off, kernel path on the card vs
     plain path on the CPU. The plain K1 on a CPU at 720² x 2 is far too slow,
     so this comparison runs at grid 512 (20 000 lidar points and 400 radar
     returns per scene, the full-size densities): teacher features and
     ``lidar_preds`` rel-L2 <= 1e-3 (the int8 chain: a code may flip where the
     card and the CPU round a scale differently), ``radar_preds`` <= 1e-4;
 10. train step, bfloat16, 1440², batch 2: counts reset, one warm step, counts
     read (K1 x 4 on ``wgmma``, K5 x 2, K2 x 3, K3 x 3, K4 x 3 per step, all
     three on K4's tile route), then 10 timed
     steps with one synchronize each; the loss finite on every step,
     ``as_overflow == 0``, every trainable parameter changed and every frozen
     parameter and statistic bit-equal afterwards; p50, samples/s, peak memory;
 11. train step, float32 with TF32 off, grid 512: 2 steps on the card
     (kernels) against the same 2 steps on the CPU (plain versions): loss
     within 1e-4 relative; every element of every trained parameter within
     2.1 x sum(lr) of the CPU's (each side moves an element by at most about
     lr per step); every trained parameter within 5e-3 rel-L2 and
     its update's cosine with the CPU's at least 0.9. Why not tighter: with
     random weights the float32 gradient of this loss carries about 1e-2 of
     summation-order noise (the heatmap gradient nearly cancels in the
     train-mode BatchNorm backward), and Adam's first updates are
     lr x sign(g) per element, so an element whose gradient lies inside the
     noise goes either way (measured: 1.6e-3 rel-L2). A bias that feeds a
     train-mode BatchNorm (and two more leaves, ``ZERO_GRAD``) has a true
     gradient of zero, all noise, and is held to the elementwise bound only.

Phases 12-19, the deep chains of the teacher:

 12. K1 vs its plain version at every link shape of the ``INT8_STAGES: 5``
     chain beyond stage 1, each on the route the dispatch gives it (printed;
     14 links on ``wgmma``, the five Co-64 links on the resident ``mma.sync``
     variant): every int8 code equal; each timed as the wrapper and on the
     device alone, the ``wgmma`` links also on their ``mma.sync`` variant;
 13. K7 ``chain_conv`` vs its plain version at the conv5 link, pre-padded
     (2, 91, 90, 1024) x (2, 2, 1024, 256) with an all-ones lane mask, and at a
     3x3 (90², 256 -> 256) link with a 60% per-channel mask and a residual, on
     the route the dispatch gives them (``chain_route_of``: the ``wgmma`` conv
     mainloop, its counter moved): every code equal, equal to the streamed
     ``mma.sync`` kernel's, and on an all-ones mask to K1's on the same link;
     the wrapper (and its device time), the bare launch beside K1's bare
     launch of the same product with a mask word a pixel, the streamed
     kernel's wrapper and the plain version timed in one run;
 14. K6 ``conv_block_fp`` vs its plain version at the seven link shapes of the
     ``FP_STAGES: 5`` chain in bfloat16 (within 1e-2 x max|ref|: one bfloat16
     rounding of a differently ordered float32 sum), with and without a
     residual, on both bfloat16 routes, each forced and its counter checked:
     ``wgmma`` (the conv mainloop of ``csrc/conv3x3_wgmma.cu``; the Co-64
     links on its transposed kernel), where the dispatch sends every one of
     them, and ``mma.sync``; the ``wgmma`` route's bare launch equal to its
     wrapper's output; wrapper, launch alone, the ``mma.sync`` route, the
     plain version and, as an aside that is not the same function, cuDNN's
     bfloat16 conv of the same products timed in one run; then float32 (the
     FFMA kernel) at two of them (within 1e-5 x max|ref|), 2- and 4-phase
     masks and odd grids on both bfloat16 routes;
 15. K9 ``conv3x3_wide`` at (2, 180, 180, 256) -> 256, bfloat16 (the TMA +
     ``wgmma`` conv mainloop of ``csrc/conv3x3_wgmma.cu``) and float32 (the
     float link's kernel): forward and both gradients vs autograd through
     ``F.conv2d`` (TF32 off), the same tolerances; y + dx timed as the wrapper
     runs them (weights prepared from the float32 parameter) and as the two
     bare launches on prepared weights and preallocated outputs, whose
     results must equal the wrapper's; ``F.conv2d``'s time as its library
     call;
 16. distillation forward, bfloat16, 1440², ``INT8_STAGES: 5``: K1 x 23
     (18 on ``wgmma``, 5 on ``mma.sync``), K7 x 1 (on ``wgmma``), K6 x 0, K5 x
     2, K2 x 3;
     finite outputs, p50;
 17. the same with ``INT8_STAGES: 1`` + ``FP_STAGES: 5``: K1 x 4 (``wgmma``), K6 x 19
     (all on its ``wgmma`` route), K7 x 0, K5 x 2, K2 x 3;
 18. both configurations in float32 at grid 512, card vs CPU (teacher features
     1e-3, ``radar_preds`` 1e-4; under ``INT8_STAGES: 5`` the teacher's bound
     is 5e-2, see below), and the ``INT8_STAGES: 5`` teacher once more with
     ``CONV_BLOCK_V1=1`` (every link through K7, 18 on its ``wgmma`` route):
     features bit-equal; then the
     ``FP_STAGES: 5`` teacher in bfloat16 against the card's own float32
     forward of the same batch and weights at grid 512: the rel-L2 of
     ``x_conv4``, ``x_conv5`` and ``spatial_features_2d``, at most 1.5 x what
     the same comparison read with every K6 link on ``mma.sync``
     (``FP_TEACHER_BF16_REL_BEFORE``);
 19. one warm and three timed train steps with the ``INT8_STAGES: 5`` teacher:
     finite losses, K1 x 23 (18 + 5), K3 x 3 and K4 x 3 per step as before.

Phases 20-24, the route without host tables and the last three kernels:

 20. device-built tables at full width, val yaml (batch 1) and train yaml
     (batch 2), from ``make_batch(..., host_precompute=False)``: ``uids``,
     ``slot``, ``count`` of each VFE and every table of ``hp_as`` bit-equal to
     what ``HostPrecompute`` ships for the same scenes; float32 (TF32 off)
     ``radar_preds`` and ``radar_x_conv4`` of the two routes within 1e-4
     rel-L2 (only the cluster means differ, by summation order); bfloat16
     finite, ``as_overflow == 0``, the host route's launch counts; p50 of 10
     synced forwards of each route and of the device build alone;
 21. one train step in float32 through each route from the same weights:
     losses within 1e-4 relative;
 22. ``DENSE_FROM: 3`` against 5 on the raw val batch, float32, one set of
     parameters loaded into both: ``radar_preds`` within 1e-4 rel-L2, peak
     memory of each;
 23. K8 ``gather_rows_windowed`` on the seven tap tables of the batch-2 train
     batch, forward (``nb``) and backward (``inv``), bfloat16: the least
     ``n_win`` without overflow per table, wrapper == bare launch == plain
     windowed version == unwindowed gather and count 0; each gather timed in
     turns as the wrapper, the bare launch alone (host hidden), the plain
     version and ``index_select``; one table with ``n_win`` one too small:
     rows and count equal to the plain version's, count > 0;
 24. P2 ``mma_rate`` (two routes, three types) and P1 ``conv_probe`` (three
     modes on two routes, ``mma.sync`` and the ``wgmma`` conv mainloop, five
     shapes): each case within tolerance of its plain version
     (bfloat16 1e-2, TF32 1e-3 x max|ref|, int8 equal), then its rate beside
     the library call's (P2 at every ``MMA_CASES`` row on both routes); P1's
     ``wgmma`` route also by its launch alone; then P2's bfloat16 (2048, 512,
     512) case on ``wgmma`` and ``torch.bmm`` in turns, 20 times each (mean,
     min, max). (They run first, right after the build.)

Phase 25, the runtime around the step (after phase 23), through the functions
of the CLIs as a user runs them, at full width on
``tools/cfgs/synthetic/production_cert.yaml`` (the shipped model and optimizer,
``SyntheticDataset`` of 160 000 lidar points, 3000 radar returns and 60 boxes a
scene) with ``--set DATA_CONFIG.NUM_SAMPLES 6``, batch 2, bf16, 2 loader
workers, a log line a step, checkpoints under ``output/`` (removed after):
``tools/torch_train.py::main`` for one epoch (3 steps from the loader:
forked workers, ``HostPrecompute`` on the prefetch thread, pinned copies on a
copy stream), again with ``--epochs 2`` (it must resume at epoch 1 and take
3 more), then ``tools/torch_test.py::eval_ckpt`` with a fresh model restored
from the last checkpoint over the eval loader (3 batches, tables built on the
card) and ``SyntheticDataset.evaluation``. Counts reset before the first run
and read after the eval: 6 x the train step's (K1 x 4 on ``wgmma``, K5 x 2,
K2 x 3, K3 x 3, K4 x 3 on its tile route) + 3 x the eval forward's (K1 x 4,
K5 x 2, K2 x 3), nothing else; every logged loss finite; the restored model's
every ``state_dict`` tensor, Adam's moments and the update count bit-equal
to the trained ones; the restored model's detections on one eval batch equal
to the trained model's (the near-tie rule of ``tests/test_torch_slice.py``).
It prints t_iter and t_data p50 over the 6 steps (read from the train logs,
1 ms resolution), the loader's seconds a batch alone (serial, then 2 workers,
which must give the same batches),
the checkpoint's size, save and load seconds, and eval samples/s.

Phase 26, nuScenes at full width (after phase 25): ``tools/torch_nuscenes_tree.py``
writes a nuScenes-layout tree in a temporary directory at nuScenes' widths (8
train and 4 val samples; a 34 720-point key lidar frame of 5 float32 features
and 9 sweeps, about 157 000 points of a sample in range; 5 radar channels x 6
sweeps of about 100 returns in binary .pcd; 40-60 boxes a sample over the 10
classes; the info pkls written directly); the port's
``create_groundtruth_database`` on it; one epoch of ``tools/torch_train.py``
on ``radar_distill_train.yaml`` (bs2, bf16, 2 workers, GT sampling on: the
hook's ``NUM_LAST_EPOCHS`` set to 0), ``DATA_PATH`` and the info paths by
``--set``; then ``tools/torch_test.py`` on ``radar_distill_val.yaml`` with its
checkpoint over the val infos (bs1), which reaches the fallback metric where
the nuScenes devkit is not installed. Counts reset before the train run and read
after the eval: 4 x the train step's + 4 x the val forward's (K5 x 1, K2 x 3),
nothing else; every logged loss finite; the model on the card. It prints
t_iter and t_data p50, the loader's seconds a batch, the items' point counts,
eval samples/s. The tree is written once (``make_nuscenes_tree``) for phases
26 and 28-30, and phase 26 trains from phase 28's teacher, loaded with
``--pretrained_model``: every one of the distillation model's teacher entries
must load (``TrainState.loaded``) and, frozen, still equal the file's after
training.

Phase 27, data-parallel on the card (``tools/torch_ddp_check.py``): the DDP +
synchronized-BN step at world size 1 on NCCL against the unwrapped step of
the same weights, 1440², bs2, bf16 (loss rel <= 1e-6, every parameter after
one step within 1e-6 rel-L2 but the leaves whose true gradient is zero,
within 2.1·lr), then 10 steps of each in turns (the DDP steps'
launches counted: 11 x the train step's), and the host time of one BN's
all-reduce on the NCCL group (the step makes none at world size 1); two ranks on the one card over gloo,
bs1 each, against one process on the bs2 batch in float32 (TF32 off):
``sync_bn=True`` loss rel <= 1e-4 and the parameters by the rule of
``tests/torch_train_case.py``, ``sync_bn=False`` running statistics equal to
the mean of the ranks' local updates, each rank's steps with the train step's
launches; and a 2-rank ``tools/torch_test.py`` (gloo) over phase 26's val set
whose merged detections equal the 1-process eval's entry by entry (near-tie
rule). It prints the DDP step's p50 beside the unwrapped step's.

Phase 28, the teacher's pretraining (before phase 26, on its tree): one epoch
of ``tools/torch_train.py`` on ``nuscenes_models/pillarnet.yaml`` at full
width (1440², bs4, ``MAX_LIDAR_POINTS`` 180 000, bf16, 2 workers, 2 steps, GT
sampling on), its checkpoint, then ``tools/torch_test_teacher.py`` on it over
the 4 val samples (bs1). Counts reset before the one and read after the
other: K5 x 1 per step and per val forward (the dense VFE's densify), nothing
else; losses finite; every ``backbone_3d`` kernel moved from the CLI's initial
draw (seed 666). Phase 29, the radar-only baseline: ``pillarnet_radar.yaml``,
bs8, 1440², 2 epochs of one step, ``--init_from_teacher`` with phase 28's
checkpoint (the log's count of copied parameters must be every radar
parameter with a teacher twin of its shape: backbone, neck, head, and the VFE
but its first linear), then ``tools/torch_test.py`` over the val samples:
K5 x 1 and K2 x 3 per forward, K3 x 3 and K4 x 3 (tile route) per step.
Both print t_iter and t_data p50 (train log), the resident step's p50 and
peak memory (5 steps on one device-resident batch of the yaml's loader after
the CLI), the CLI train's peak memory, and the eval's inference p50. Phase
30, the hand-off at float32 (TF32 off): phase 28's checkpoint in the dense
teacher and in ``radar_distill_train.yaml``'s S2D teacher with ``INT8:
False`` (every entry loaded in both); their ``x_conv4`` / ``x_conv5`` on the
distillation batch within 1e-4 rel-L2. Phase 32: ``synthetic/smoke.yaml``
(grid 256) and ``pillarnet.yaml`` with an ``_AS`` teacher (1440², bs2) built
and run forward in bf16 (the reference's initializers from a seed), outputs
finite, no overflow.
Phase 31 (before the tree): K5 at the
dense VFE's shapes, bs4 LiDAR (a table of 180 001 rows of 32 bfloat16 a
sample, 100 000 occupied pillars) and bs8 radar (8193 rows, 3000 pillars),
onto 1440², bit-equal to plain, timed beside ``index_select``.

Phases 33-38, the space-to-depth teacher. Phase 33 (after phase 32, on the
tree): one epoch of ``tools/torch_train.py`` on ``pillarnet.yaml`` with
``--set MODEL.BACKBONE_3D.NAME PillarRes18BackBone8x_S2D`` (the dense VFE's
grid into the S2D backbone, trained), bs4, 1440², as phase 28, then
``tools/torch_test_teacher.py`` on it: K5 x 1 per step and per val forward,
nothing else; every ``backbone_3d`` kernel moved; its resident step's p50 and
peak printed beside phase 28's. Its checkpoint then goes through phase 30's
hand-off (every teacher entry into the dense teacher and into
``radar_distill_train.yaml``'s, x_conv4 / x_conv5 within 1e-4). Phase 34: one
float32 train step of that trained S2D backbone and of the dense one on the
same grid (``phase_s2d_dense_step`` states its bounds). Phase 35 (after phase
19's deep chains): ``radar_distill_train.yaml`` with ``FREEZE_PIPELINE: []``,
bs2, 1440², bf16: 1 warm + 5 timed steps, per step K5 x 2, K2 x 3, K3 x 3, K4
x 3 (tile), K1 x 0 (train mode is float), every parameter changed, the
teacher's included (its head, which does not run while a student trains, by
weight decay only), p50 and peak; then one eval forward of the same model,
K1 x 4. Phase 36: the ``INT8: static`` distillation forward on the other
routes of the S2D teacher (``S2D_ROUTES``), bf16, bs2, 1440², with their
launches (K1 x 4, x 4, x 8 with K5 x 2, K2 x 3), then each in float32 at grid
512 on the card against the CPU (teacher 1e-3, ``radar_preds`` 1e-4). Phase 37:
K1 at the ``_S2D2`` packed stage-2 links, (2, 360, 360, 256) x (3, 3, 256,
256) with 4 mask phases, with and without a residual, every code equal to
plain; the wrapper, the bare launch and plain timed. K5 in the two packed
densifies at the 163 840-row table, bs2: rows, masks and the table's
gradient bit-equal to the CPU, float32 and int8 tables; K5 alone at that shape
against plain and ``index_select``. Phase 38: ``tools/torch_overfit_check.py``
(``OVERFIT_STEPS`` at grid 256, it must converge) and
``tools/torch_quality_gate.py --variant int8 --scenes 1`` with 30 + 30 steps,
each printing its result lines; the gate also with ``--variant fp`` and
``--variant dcn_r8``. K1's record carries ``packed_stage2`` (the
sums over the four stage-2 links of a ``_S2D2`` forward), K5's
``packed_densify``; ``launches_s2d_teacher_pretrain``,
``launches_teacher_unfrozen`` (one step) and ``launches_static_*`` (one
forward of each route) count phases 33, 35 and 36.

The last modules (``phase_*`` docstrings hold the bounds). Phase 0, after
phase 4: K2, K3 and K4 at the clamp R = 8 (``DCN_R=8``) against their plain
versions at the CMA sites, K4's tile window's shared memory at R = 5 and 8
(and at stride 1, where a clamp of 20 sends K4 to its atomic route by rule),
K4's time at R = 8 beside R = 5 in turns (K4's record: ``r5_ms_in_turns``,
``r8_ms_in_turns``). Phases 42-43, on the tree of phase 26: the radar
baseline's step (``pillarnet_radar.yaml``, bs8, 1440², bf16) with
``MODEL.REMAT`` beside one without (running statistics against a repeat of
the plain leg, gradients, p50, peak GiB, K2 x 6 a remat step); and the
tile-sparse radar backbone in eval (active tiles and overflow at ``MAX_TILES``
512, float32 against the dense backbone where nothing overflows, the bf16
forward's p50 beside the dense one). Phases 39-41, after phase 38: the anchor
family, ``pointpillar_smoke.yaml`` through ``tools/torch_train.py`` (with
``--profile_dir``) and ``tools/torch_test.py`` (with ``--bev_similarity``),
``tools/torch_demo.py`` and ``tools/torch_calc_caps.py``; its MODEL at full
size on ``pillarnet.yaml``'s 1440² grid, bs4, 160 000 points and 64 boxes a
scene, with the dense VFE (K5 x 1 a forward) and with ``PillarVFE`` (no
kernel); ``OPTIMIZER: adam`` and ``sgd`` on the card against the CPU.
``launches_anchor_cli``, ``launches_anchor_step``, ``launches_remat`` (5
steps) and ``launches_tile_sparse_forward`` count them.

The reference-checkpoint import, phase 44, after phase 41
(``phase_pcdet_import``): a synthetic full-width pcdet checkpoint through
``tools/torch_convert_ckpt.py``; every entry of ``radar_distill_train.yaml``'s
model loaded from the file on the card, equal to the in-memory conversion;
the bf16 distillation eval forward at 1440², bs2 on those weights (K5 x 2, K1
x 4, K2 x 3), finite and bit-equal to the forward on the in-memory
conversion; ``tools/torch_test.py --ckpt`` on ``radar_distill_val.yaml`` over
a synthetic nuScenes tree of 2 samples (every entry loaded, K5 x 1 and K2 x 3
a forward). ``launches_pcdet`` counts the forward and the CLI.

The cost count, phase 45, after phase 44 (``phase_cost``):
``utils/profiler.py::cost_analysis``, the port of the JAX tool's
``--cal_params``. (a) The val eval step at 1440², bs1, float32, on
``make_batch()``'s batch: 24 911 999 parameters and flops within 5% of XLA's
696.868 G for the JAX step on the same batch (``tools/xla_cost_reference.py``
on the CPU, printed beside it with its 15.774 G bytes), K5 x 1 and K2 x 3
counted through their formulas; then ``tools/torch_test.py --cal_params`` on
``radar_distill_val.yaml`` over a synthetic tree of 2 val samples, its log
line printed. (b) The same step at grid 256, float32, TF32 off, counted on
the card (K5, K2 launched) and on the CPU (their plain versions): flops equal
within 1e-4, bytes within 1e-2, every aten op whose bytes differ named. (c)
The bfloat16 distillation eval forward at 1440², bs2, and one distillation
train step: the hook's per-kernel tallies equal to the dispatchers' own
launch counts (K1 x 4, K5 x 2, K2 x 3; and K3 x 3, K4 x 3).

The restore of the JAX package's checkpoints, phase 46, after phase 45
(``phase_jax_ckpt``), on the committed fixture ``tests/fixtures/jax_run`` (two
epochs of ``radar_distill_train.yaml``'s full-width ``TrainState``, written
by the JAX package's ``CheckpointManager``; ``tools/make_jax_ckpt_fixture.py``).
(a) Both epochs read by ``train/jax_ckpt.py`` on this machine's host, every
tensor bit-equal to ``utils/testing.py::jax_ckpt_leaf``, with the read's
seconds (``tools/torch_jax_ckpt_read.py::read_rate``). (b)
``CheckpointManager.restore`` into the train yaml's bf16 ``TrainState`` on
the card: the newest epoch, 652 of 652 model entries and the moments of
every trainable parameter equal to the generated tree's, ``step`` the
fixture's count. (c) The distillation eval forward at 1440², bs2 (K5 x 2, K1
x 4, K2 x 3), finite and bit-equal to the same forward after
``load_jax_variables``' mapping of the generated tree. (d) One train step
(K3 x 3, K4 x 3 more): its update bit-equal to the update of an optimizer set
in memory from the generated tree on the same gradients, the step count one
more. (e) ``tools/torch_train.py`` for one step in a copy of the run directory
with ``--max_ckpt_save_num 1``: it resumes at epoch 2, writes its file and
removes the JAX directories. (f) ``tools/torch_test.py --ckpt`` the JAX
directory on ``radar_distill_val.yaml`` over 2 synthetic samples (K5 x 1,
K2 x 3 a forward). ``launches_jaxckpt`` counts (c)-(f).

Why 5e-2 under ``INT8_STAGES: 5``: the card and the CPU round the chain's
float32 scales alike, but not every stock op around it (the VFE's sums); one
flipped input code flips a few percent of the 9 x Co codes it reaches in the
next link, and from stage 2 on a code is a coarse step (the BN bound is many
times the activations), so two correct runs drift apart with depth (measured
6e-3 to 1e-2). The kernels themselves are held code for code in phases 12
and 13.

Kernel times are CUDA-event means over repeated launches on warm inputs,
measured plain, kernel, kernel, plain. ``bound_ms`` is the least time the card
could take: the larger of the bytes the function must move (each input read
once, each output written once) over 3.35 TB/s and its operations over the
peak rate of their type (K1, K7: int8 tensor cores, 1979 TOP/s; K6, K9:
bfloat16 tensor cores, 989 TFLOP/s; K2: nine float32
operations per sampled value at 67 TFLOP/s; K3 and K4: 2 x 9 x 4 x C float32
operations per output site; K5 copies and does none). K4's bound counts what
the function reads (dsampled, offsets, mask) and writes (dx).
``library_ms`` times the one PyTorch call that computes the same function
where there is one (``index_select`` for K5, ``F.conv2d`` for K9); the port
never calls it. In the
kernels record each time is the sum over that kernel's launches in one
train step (K5, K2 and K1 launch as often there as in one distillation
forward), and ``launches`` is the count of one train step; for K7 and K6 it
is one forward of their configuration (``INT8_STAGES: 5``, ``FP_STAGES: 5``),
for K9, which no model calls, one forward and backward of ``conv3x3_wide``;
for K8 one pass over its 14 gathers (times summed), for P1 the ``conv`` mode at
(2, 720, 720, 128) -> 128 on the ``wgmma`` route and for P2 the bfloat16 (2048, 512, 512) product on
the ``wgmma`` route, with ``launches`` counting every case of their tables
(bound of P1, P2: operations at the bfloat16 peak). ``launch_ms`` (K1, K2,
K3, K4, K6, K7, K8, K9 and P1; null for the others) is the time of the bare launches
on prepared inputs and preallocated outputs, ``ms`` that of the wrapper.
``aside_ms`` (K2, K3, K4) is the time of the asides of phase 4 (K6: cuDNN's
bfloat16 conv of its 19 links' products, phase 14), ``k4_route`` the route
K4 takes on the main path and ``repeats_bitwise`` whether its dx repeated
bit for bit. K6's ``teacher_bf16_rel_l2`` is the figure of phase 18; P2's
``alternating_ms`` and ``alternating_library_ms`` are (mean, min, max) of P2
and ``torch.bmm`` timed in turns, 20 times each (phase 24).
``mma`` names the tensor-core instruction of a kernel that has one (K1, K6,
K7: their routes at the links of their configuration; K7's conv5 link on
``wgmma``). K1's, K6's and K7's records also
carry ``old_route_ms``, their links on the ``mma.sync`` kernel in the same
run (K7: its streamed kernel); K1's also ``deep_*``, the
sums over the 19 deeper links of ``INT8_STAGES: 5`` on their routes
(``deep_old_route_ms``: all 19 on ``mma.sync``; ``deep_device_*``: their
device time with the host's enqueue hidden, as the wrappers of the links
below 720² cost the host more than the card); K7's ``device_ms`` is its
wrapper's device time, the same way. ``launches_runtime`` is each
kernel's count over phase 25, ``launches_nuscenes`` over phase 26,
``launches_ddp`` over the DDP steps of phase 27, ``launches_teacher_pretrain``
over phase 28 and ``launches_radar_baseline`` over phase 29; K5's
``dense_vfe`` holds phase 31's records. Any failed phase exits
non-zero. The line before the
last is the kernels record ``{"kernels": [{"name", "route", "mma", "source",
"replaces", "launches", "max_abs_err", "ms", "launch_ms", "plain_ms",
"bound_ms", "bound_by", "library_ms", ...}]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# published dense peaks of one H100 SXM: bytes/s of HBM, int8 operations/s of
# the tensor cores, float32 operations/s outside them (a multiply-add is two
# operations)
PEAK_BYTES = 3.35e12
PEAK_INT8_OPS = 1979e12
PEAK_BF16_OPS = 989e12
PEAK_F32_OPS = 67e12

# the link shapes of the teacher's deep chains at the 1440² grid, batch 2:
# (H = W, C, Co, kh, launches without a residual, launches with one)
INT8_DEEP_LINKS = ((720, 128, 64, 2, 1, 0), (720, 64, 64, 3, 2, 2), (360, 256, 128, 2, 1, 0),
                   (360, 128, 128, 3, 2, 2), (180, 512, 256, 2, 1, 0), (180, 256, 256, 3, 2, 2),
                   (90, 256, 256, 3, 2, 2))  # + 4 stage-1 links, + K7 into conv5: 23 + 1
# the tensor-core instruction of each kernel that has one (K1: its route at
# the stage-1 links; the Co-64 links of INT8_STAGES: 5 stay on mma.sync)
MMA_ROUTES = {"conv_block": "wgmma", "conv3x3_wide": "wgmma", "conv_probe": "wgmma",
              "mma_rate": "wgmma", "conv_block_fp": "wgmma", "chain_conv": "wgmma"}
# K1's launches in one distillation forward: the four stage-1 links, all on
# the wgmma route
K1_STAGE1 = {"conv_block": 4, "conv_block.wgmma": 4, "conv_block.mma_sync": 0}
# the CMA's backward in one train step: K3 x 3, K4 x 3 on its tile route
DCN_BACKWARD = {"dcn_offset_grad": 3, "dcn_input_grad": 3, "dcn_input_grad.tile": 3}
# rel-L2 of the FP_STAGES: 5 teacher's features, bfloat16 against the card's
# float32 forward at grid 512 (phase_fp_teacher_bf16), read on an H100 with
# every K6 link on the mma.sync kernel, before the wgmma route existed
# (tools/torch_fp_teacher_rel.py on that tree); the wgmma route may not be
# more than 1.5 x this
FP_TEACHER_BF16_REL_BEFORE = {"x_conv4": 1.0093e-02, "x_conv5": 8.4639e-03,
                              "spatial_features_2d": 1.6576e-02}
FP_LINKS = ((720, 64, 64, 3, 2, 2), (360, 256, 128, 2, 1, 0), (360, 128, 128, 3, 2, 2),
            (180, 512, 256, 2, 1, 0), (180, 256, 256, 3, 2, 2), (90, 1024, 256, 2, 1, 0),
            (90, 256, 256, 3, 2, 2))  # 19 launches


def bound_of(rec):
    """Close a kernel's record: ``bound_ms`` is the larger of its summed
    ``bytes_ms`` and ``ops_ms``, ``bound_by`` says which."""
    bytes_ms, ops_ms = rec.pop("bytes_ms"), rec.pop("ops_ms")
    rec["bound_ms"] = max(bytes_ms, ops_ms)
    rec["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return rec


def cuda_ms(torch, fn, iters):
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Mean device time of one ``fn()`` with the host's enqueue hidden: the
    stream sleeps first (about 30 ms) while the host enqueues all ``iters``
    calls, so the events time the device's work back to back. A wrapper whose
    launches cost the host more than its kernels cost the card reads its
    device time here and its host time in :func:`cuda_ms`."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(60_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(torch, kernel_fn, plain_fn, iters=100, plain_iters=None, timer=cuda_ms):
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    plain_iters = plain_iters or iters
    p1 = timer(torch, plain_fn, plain_iters)
    k1 = timer(torch, kernel_fn, iters)
    k2 = timer(torch, kernel_fn, iters)
    p2 = timer(torch, plain_fn, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_l2(torch, got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return (torch.linalg.norm(got - want) / torch.linalg.norm(want).clamp_min(1e-30)).item()


def check_expand(torch, name, table, inv, iters=100):
    """One K5 shape: bit-equal to the plain version; (kernel, plain, library,
    bound) ms. The library call is a row ``index_select``: ``inv`` addresses
    rows of the table only (absent sites point at its zero row)."""
    from radardistill_tpu_torch.ops.expand import expand_rows, expand_rows_plain, expand_rows_work

    got, want = expand_rows(table, inv), expand_rows_plain(table, inv)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError(f"K5 {name}: kernel and plain version differ")
    idx = inv.long()
    if not torch.equal(torch.index_select(table, 0, idx), want):
        raise RuntimeError(f"K5 {name}: index_select is not the same function here")
    ms, plain_ms = paired_ms(torch, lambda: expand_rows(table, inv),
                             lambda: expand_rows_plain(table, inv), iters)
    lib_ms = cuda_ms(torch, lambda: torch.index_select(table, 0, idx), iters)
    nbytes = expand_rows_work(table, inv)[1]
    bound = nbytes / PEAK_BYTES * 1e3
    print(f"K5 expand_rows {name} {str(table.dtype)[6:]} table {tuple(table.shape)} inv "
          f"{tuple(inv.shape)}: bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_select {lib_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bytes_ms": bound}


def phase_k5(torch, dev):
    """The conv4 handoff at batch 1 (val path) and 2, and the teacher's entry.
    Returns the sums over the distillation forward's two launches."""
    from radardistill_tpu_torch.ops.active_site import site_index_grid

    gen = torch.Generator().manual_seed(5)

    def site_table(b, cap, hw, n_active):
        uids = torch.full((b, cap), hw, dtype=torch.int32)
        for i in range(b):
            uids[i, :n_active] = torch.sort(
                torch.randperm(hw, generator=gen)[:n_active]).values.to(torch.int32)
        inv = site_index_grid(uids, hw, cap)
        flat = inv + (torch.arange(b, dtype=torch.int32) * (cap + 1))[:, None]
        return flat.reshape(-1).to(dev), uids

    recs = {}
    for b in (1, 2):
        cap, hw, c = 8192, 180 * 180, 256  # conv4 handoff at the 1440² grid
        inv, _ = site_table(b, cap, hw, 4096)
        for dtype in (torch.bfloat16, torch.float32):
            table = torch.randn(b, cap + 1, c, generator=gen).to(dev, dtype)
            table[:, cap] = 0
            rec = check_expand(torch, f"handoff bs{b}", table.reshape(-1, c), inv)
            if dtype == torch.bfloat16:  # the main paths' dtype
                recs[f"handoff{b}"] = rec
    cap, hw = 163840, 1440 * 1440  # the teacher's entry: int8 rows of 32 bytes
    inv, _ = site_table(2, cap, hw, 120000)
    table = torch.randint(-127, 128, (2, cap + 1, 32), generator=gen, dtype=torch.int8).to(dev)
    table[:, cap] = 0
    recs["entry"] = check_expand(torch, "teacher entry bs2", table.reshape(-1, 32), inv, iters=20)
    out = {k: recs["handoff2"][k] + recs["entry"][k]
           for k in ("ms", "plain_ms", "library_ms", "bytes_ms")}
    return bound_of(dict(out, ops_ms=0.0, max_abs_err=0.0))  # a copy: no arithmetic


def nan_equal_within(torch, got, want, tol):
    """(error, limit, ok): NaN exactly where the reference has NaN, the rest
    within tol x max|ref|."""
    got, want = got.float(), want.float()
    nan = torch.isnan(want)
    err = (got[~nan] - want[~nan]).abs().max().item()
    lim = tol * want[~nan].abs().max().item()
    return err, lim, bool(torch.equal(torch.isnan(got), nan)) and err <= lim


def with_nans(torch, off):
    """The offsets with a NaN in every 7th dy and every 11th dx (of 18)."""
    off = off.clone()
    flat = off.view(-1, 18)
    flat[::7, 0::2] = float("nan")
    flat[::11, 1::2] = float("nan")
    return off


def grid_of(torch, off, h, ho, max_offset):
    """``F.grid_sample``'s grid (align_corners=True) of the clamped sample
    positions: (B, Ho, 9·Wo, 2), x before y, tap k of site wo at 9·wo + k."""
    b = off.shape[0]
    k = torch.arange(9, device=off.device)
    base = torch.arange(ho, device=off.device) * 2 - 1
    d = off.view(b, ho, ho, 9, 2).clamp(-max_offset, max_offset)
    ph = (base[:, None, None] + (k // 3)).float() + d[..., 0]
    pw = (base[None, :, None] + (k % 3)).float() + d[..., 1]
    g = torch.stack([2 * pw / (h - 1) - 1, 2 * ph / (h - 1) - 1], dim=-1)
    return g.reshape(b, ho, ho * 9, 2).contiguous()


def phase_k2(torch, dev):
    """The three CMA sites at batch 1 (val path), 2 (distillation forward)
    and 8 (the radar baseline's forward, checked, not timed), then NaN
    offsets; returns the batch-2 sums. Timed: the wrapper, the bare
    launch into a preallocated output, the plain version, and as an aside
    ``F.grid_sample`` of the same samples (NCHW, no mask: not the same
    function)."""
    import torch.nn.functional as F

    from radardistill_tpu_torch.ops import dcn_sample as ds_mod
    from radardistill_tpu_torch.ops.dcn import DCN_MAX_OFFSET, shapes_supported
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample, dcn_sample_plain, dcn_sample_work

    gen = torch.Generator().manual_seed(2)
    sites = ((180, 90), (90, 45), (180, 90))  # the CMA's three downsamples at 1440²
    R = DCN_MAX_OFFSET
    recs = {}
    for b in (1, 2, 8):
        rec = dict.fromkeys(("max_abs_err", "ms", "launch_ms", "plain_ms", "aside_ms",
                             "bytes_ms", "ops_ms"), 0.0)
        for h, ho in sites:
            x32 = torch.randn(b, h, h, 256, generator=gen)
            if not shapes_supported(x32.shape, (b, ho, ho, 18), 2, 1, 3):
                raise RuntimeError(f"K2: the shape gate should clamp at {h}²")
            off = (3.0 * torch.randn(b, ho, ho, 18, generator=gen)).to(dev)
            msk = (torch.rand(b, ho, ho, 9, generator=gen) * 0.9 + 0.05).to(dev)
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
                x = x32.to(dev, dtype)
                got = dcn_sample(x, off, msk, 2, 1, 3, R)
                want = dcn_sample_plain(x, off, msk, 2, 1, 3, R)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ref = want.float().abs().max().item()
                print(f"K2 dcn_sample {str(dtype)[6:]} x {tuple(x.shape)} -> {tuple(got.shape)}: "
                      f"max_abs_err {err:.3e} (limit {tol * ref:.3e})")
                if not err <= tol * ref:
                    raise RuntimeError(f"K2 {dtype} bs{b} at {h}²: error {err} over {tol} x "
                                       f"{ref}")
                if dtype != torch.bfloat16 or b == 8:
                    continue
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                out = torch.empty_like(got)
                alone = lambda: ds_mod.launch(x, off, msk, out, 2, 1, R)  # noqa: E731
                alone()
                torch.cuda.synchronize()
                if not torch.equal(out, got):
                    raise RuntimeError("K2: the bare launch differs from the wrapper's result")
                ms, plain_ms = paired_ms(
                    torch, lambda: dcn_sample(x, off, msk, 2, 1, 3, R),
                    lambda: dcn_sample_plain(x, off, msk, 2, 1, 3, R), iters=10)
                launch_ms = (cuda_ms(torch, alone, 20) + cuda_ms(torch, alone, 20)) / 2
                xn = x.permute(0, 3, 1, 2).contiguous()
                grid = grid_of(torch, off, h, ho, R).to(dtype)
                aside_ms = cuda_ms(torch, lambda: F.grid_sample(
                    xn, grid, mode="bilinear", padding_mode="zeros", align_corners=True), 20)
                # per output value: four corner multiply-adds and the mask
                # multiply, in float32 outside the tensor cores
                ops, nbytes = dcn_sample_work(x, off, msk, 2, 1, 3, R)
                bytes_ms = nbytes / PEAK_BYTES * 1e3
                ops_ms = ops / PEAK_F32_OPS * 1e3
                print(f"K2 dcn_sample bfloat16 bs{b} at {h}²->{ho}²: wrapper {ms:.4f} ms, launch "
                      f"alone {launch_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, {nbytes / 1e6:.1f} "
                      f"MB; operations {ops_ms:.4f}); aside, not the same function (no mask, "
                      f"NCHW): F.grid_sample {aside_ms:.4f} ms")
                for key, v in (("ms", ms), ("launch_ms", launch_ms), ("plain_ms", plain_ms),
                               ("aside_ms", aside_ms), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                    rec[key] += v
        recs[b] = rec

    # NaN offsets: the clamp keeps them, their taps read exactly zeros
    b, h, ho = 2, 90, 45
    x32 = torch.randn(b, h, h, 256, generator=gen)
    off = with_nans(torch, (3.0 * torch.randn(b, ho, ho, 18, generator=gen)).to(dev))
    msk = (torch.rand(b, ho, ho, 9, generator=gen) * 0.9 + 0.05).to(dev)
    tap_nan = torch.isnan(off.view(b, ho, ho, 9, 2)).any(-1)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        x = x32.to(dev, dtype)
        got = dcn_sample(x, off, msk, 2, 1, 3, R)
        want = dcn_sample_plain(x, off, msk, 2, 1, 3, R)
        err, lim, ok = nan_equal_within(torch, got, want, tol)
        zero = bool((got.view(b, ho, ho, 9, 256)[tap_nan] == 0).all())
        print(f"K2 dcn_sample {str(dtype)[6:]} bs{b} {h}² with {int(tap_nan.sum())} NaN taps: "
              f"max_abs_err {err:.3e} (limit {lim:.3e}), NaN taps read 0: {zero}, finite: "
              f"{bool(torch.isfinite(got.float()).all())}")
        if not (ok and zero and torch.isfinite(got.float()).all()):
            raise RuntimeError(f"K2 {dtype}: NaN offsets are not handled as the plain version")
    return bound_of(dict(recs[2], library_ms=None))


def phase_k34(torch, dev):
    """K3 and K4 at the three CMA sites, batch 2 (and checked, not timed, at
    batch 8, the radar baseline's): kernel vs plain (K4 on the
    route the dispatch gives it, counted; the tile route twice, bit for bit),
    the bare launches timed beside the wrappers, and as asides the grid
    gradient (K3) and the input gradient (K4) of ``grid_sampler_2d_backward``
    with the mask folded into the cotangent; then NaN offsets on both K4
    routes, and the whole DCN backward against autograd through the plain
    sampling. Returns the two records (sums over the three sites,
    bfloat16)."""
    from radardistill_tpu_torch.ops import dcn_grad
    from radardistill_tpu_torch.ops.dcn import (DCN_MAX_OFFSET, modulated_deform_conv,
                                                shapes_supported)
    from radardistill_tpu_torch.ops.dcn_grad import (dcn_input_grad, dcn_input_grad_plain,
                                                     dcn_input_grad_work, dcn_offset_grad,
                                                     dcn_offset_grad_plain, dcn_offset_grad_work,
                                                     input_grad_route)
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample_plain

    gen = torch.Generator().manual_seed(3)
    b, c = 2, 256
    zero = lambda: dict.fromkeys(("max_abs_err", "ms", "launch_ms", "plain_ms",  # noqa: E731
                                  "aside_ms", "bytes_ms", "ops_ms"), 0.0)
    k3, k4 = zero(), zero()
    k4["repeats_bitwise"] = True

    def check(tag, got, want, tol):
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        if not err <= tol * ref:
            raise RuntimeError(f"{tag}: error {err} over {tol} x {ref}")
        return err, ref

    def at_batch_8():
        """The radar baseline's CMA (``pillarnet_radar.yaml``, batch 8): K3
        and K4 against their plain versions at the three sites, both dtypes,
        K4 on the tile route."""
        for h, ho, max_offset in cases[:3]:
            x32 = torch.randn(8, h, h, c, generator=gen)
            ds32 = torch.randn(8, ho, ho, 9 * c, generator=gen)
            off = (3.0 * torch.randn(8, ho, ho, 18, generator=gen)).to(dev)
            msk = (torch.rand(8, ho, ho, 9, generator=gen) * 0.9 + 0.05).to(dev)
            geo = (2, 1, 3, max_offset)
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
                x, ds = x32.to(dev, dtype), ds32.to(dev, dtype)
                g18, dm9 = dcn_offset_grad(x, off, ds, msk, *geo)
                dx, route = routed(ds, off, msk, h, geo)
                g18_p, dm9_p = dcn_offset_grad_plain(x, off, ds, msk, *geo)
                dx_p = dcn_input_grad_plain(ds, off, msk, h, h, *geo)
                torch.cuda.synchronize()
                tag = f"{str(dtype)[6:]} bs8 {h}²->{ho}² clamp {max_offset}"
                errs = [check(f"{name} {tag}", g, p, tol) for name, g, p in (
                    ("K3 g18", g18, g18_p), ("K3 dm9", dm9, dm9_p), ("K4 dx", dx, dx_p))]
                if route != "tile":
                    raise RuntimeError(f"K4: the clamped CMA site at bs8 took the {route} route")
                print(f"K3/K4 {tag}: g18 / dm9 / dx ({route} route) max_abs_err "
                      + " / ".join(f"{e:.3e} (limit {tol * r:.3e})" for e, r in errs))
                del x, ds, g18, dm9, dx, g18_p, dm9_p, dx_p

    def routed(ds, off, msk, h, geo):
        """dx through the wrapper, and the route it was counted on."""
        before = dict(dcn_input_grad.route_launches)
        dx = dcn_input_grad(ds, off, msk, h, h, *geo)
        moved = [r for r, n in dcn_input_grad.route_launches.items() if n != before[r]]
        if len(moved) != 1 or moved[0] != input_grad_route(geo[3], 2, 1, c, ds.dtype):
            raise RuntimeError(f"K4: counted on {moved}")
        return dx, moved[0]

    cases = [(180, 90, DCN_MAX_OFFSET), (90, 45, DCN_MAX_OFFSET), (180, 90, DCN_MAX_OFFSET),
             (64, 32, None)]  # the last: outside the gate, no clamp (float32 only)
    for h, ho, max_offset in cases:
        if shapes_supported((b, h, h, c), (b, ho, ho, 18), 2, 1, 3) != (max_offset is not None):
            raise RuntimeError(f"K3/K4: the shape gate at {h}² is not what this phase assumes")
        x32 = torch.randn(b, h, h, c, generator=gen)
        ds32 = torch.randn(b, ho, ho, 9 * c, generator=gen)
        off = (3.0 * torch.randn(b, ho, ho, 18, generator=gen)).to(dev)
        msk = (torch.rand(b, ho, ho, 9, generator=gen) * 0.9 + 0.05).to(dev)
        sat = (off.abs() >= DCN_MAX_OFFSET).float().mean().item()
        geo = (2, 1, 3, max_offset)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            if max_offset is None and dtype != torch.float32:
                continue
            x, ds = x32.to(dev, dtype), ds32.to(dev, dtype)
            g18, dm9 = dcn_offset_grad(x, off, ds, msk, *geo)
            dx, route = routed(ds, off, msk, h, geo)
            g18_p, dm9_p = dcn_offset_grad_plain(x, off, ds, msk, *geo)
            dx_p = dcn_input_grad_plain(ds, off, msk, h, h, *geo)
            torch.cuda.synchronize()
            tag = f"{str(dtype)[6:]} bs{b} {h}²->{ho}² clamp {max_offset}"
            e_g, r_g = check(f"K3 g18 {tag}", g18, g18_p, tol)
            e_m, r_m = check(f"K3 dm9 {tag}", dm9, dm9_p, tol)
            e_x, r_x = check(f"K4 dx {tag}", dx, dx_p, tol)
            again = torch.equal(dx, dcn_input_grad(ds, off, msk, h, h, *geo))
            if route == "tile":
                k4["repeats_bitwise"] &= again
            print(f"K3 dcn_offset_grad {tag} ({100 * sat:.1f}% of offsets at or beyond the "
                  f"clamp): g18 max_abs_err {e_g:.3e} (limit {tol * r_g:.3e}), dm9 {e_m:.3e} "
                  f"(limit {tol * r_m:.3e}); K4 dcn_input_grad, {route} route: dx {e_x:.3e} "
                  f"(limit {tol * r_x:.3e}), a second call bit-equal: {again}")
            if dtype != torch.bfloat16:
                continue
            if route != "tile":
                raise RuntimeError(f"K4: a clamped CMA site took the {route} route")
            k3["max_abs_err"] = max(k3["max_abs_err"], e_g, e_m)
            k4["max_abs_err"] = max(k4["max_abs_err"], e_x)
            # the bare launches: preallocated outputs, K4's window table made
            g18_o, dm9_o, dx_o = torch.empty_like(g18), torch.empty_like(dm9), torch.empty_like(dx)
            plan = dcn_grad.tile_plan(h, h)
            win = dcn_grad.tile_windows(h, h, ho, ho, *geo[:3], max_offset, *plan[:2], dev)
            k3_alone = lambda: dcn_grad.launch_offset_grad(  # noqa: E731
                x, off, msk, ds, g18_o, dm9_o, 2, 1, max_offset)
            k4_alone = lambda: dcn_grad.launch_tile(  # noqa: E731
                ds, off, msk, win, dx_o, 2, 1, max_offset, plan)
            k3_alone()
            k4_alone()
            torch.cuda.synchronize()
            if not (torch.equal(g18_o, g18) and torch.equal(dm9_o, dm9)
                    and torch.equal(dx_o, dx)):
                raise RuntimeError("K3/K4: the bare launches differ from the wrappers' results")
            # asides, not the same functions: the input and the grid gradient
            # of grid_sample (NCHW) with the mask folded into the cotangent
            xn = x.permute(0, 3, 1, 2).contiguous()
            grid = grid_of(torch, off, h, ho, max_offset).to(dtype)
            cot = (ds.view(b, ho, ho, 9, c) * msk[..., None].to(dtype)).permute(0, 4, 1, 2, 3)
            cot = cot.reshape(b, c, ho, ho * 9).contiguous()
            bwd = torch.ops.aten.grid_sampler_2d_backward
            for rec, name, kern, alone, plain, work, aside in (
                    (k3, "K3 dcn_offset_grad", lambda: dcn_offset_grad(x, off, ds, msk, *geo),
                     k3_alone, lambda: dcn_offset_grad_plain(x, off, ds, msk, *geo),
                     dcn_offset_grad_work(x, off, ds, msk, *geo),
                     lambda: bwd(cot, xn, grid, 0, 0, True, [False, True])),
                    (k4, "K4 dcn_input_grad", lambda: dcn_input_grad(ds, off, msk, h, h, *geo),
                     k4_alone, lambda: dcn_input_grad_plain(ds, off, msk, h, h, *geo),
                     dcn_input_grad_work(ds, off, msk, h, h, *geo),
                     lambda: bwd(cot, xn, grid, 0, 0, True, [True, False]))):
                ops, nbytes = work
                ops_ms = ops / PEAK_F32_OPS * 1e3
                ms, plain_ms = paired_ms(torch, kern, plain, iters=10)
                launch_ms = (cuda_ms(torch, alone, 20) + cuda_ms(torch, alone, 20)) / 2
                aside_ms = cuda_ms(torch, aside, 10)
                bytes_ms = nbytes / PEAK_BYTES * 1e3
                print(f"{name} bfloat16 bs{b} at {h}²->{ho}²: wrapper {ms:.4f} ms, launch alone "
                      f"{launch_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, {nbytes / 1e6:.1f} "
                      f"MB; operations {ops_ms:.4f}); aside, not the same function: "
                      f"grid_sampler_2d_backward {aside_ms:.4f} ms")
                for key, v in (("ms", ms), ("launch_ms", launch_ms), ("plain_ms", plain_ms),
                               ("aside_ms", aside_ms), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                    rec[key] += v

        # NaN offsets through K3 and K4 (the same route), NaNs compared as equal
        off_n = with_nans(torch, off)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            if (max_offset is None and dtype != torch.float32) or h == 180:
                continue
            x, ds = x32.to(dev, dtype), ds32.to(dev, dtype)
            g18, dm9 = dcn_offset_grad(x, off_n, ds, msk, *geo)
            dx, route = routed(ds, off_n, msk, h, geo)
            g18_p, dm9_p = dcn_offset_grad_plain(x, off_n, ds, msk, *geo)
            dx_p = dcn_input_grad_plain(ds, off_n, msk, h, h, *geo)
            res = [nan_equal_within(torch, g, p, tol)
                   for g, p in ((g18, g18_p), (dm9, dm9_p), (dx, dx_p))]
            print(f"K3/K4 {str(dtype)[6:]} bs{b} {h}² clamp {max_offset} with NaN offsets: "
                  f"g18 / dm9 / dx (K4 {route} route) max_abs_err "
                  + " / ".join(f"{e:.3e} (limit {lim:.3e})" for e, lim, _ in res)
                  + f"; NaNs in g18 {int(torch.isnan(g18_p).sum())}, in dx "
                  f"{int(torch.isnan(dx_p.float()).sum())}, placed as the plain version's")
            if not all(ok for _, _, ok in res):
                raise RuntimeError(f"K3/K4 {dtype} at {h}²: NaN offsets differ from plain")

        # the whole backward: the kernels against autograd through the plain sampling
        w = torch.randn(3, 3, c, c, generator=gen) / (9 * c) ** 0.5
        cot = torch.randn(b, ho, ho, c, generator=gen).to(dev)
        leaves = [t.to(dev).requires_grad_() for t in (x32, off.cpu(), msk.cpu(), w)]
        got = torch.autograd.grad(modulated_deform_conv(*leaves, stride=2, padding=1),
                                  leaves, cot)
        y_plain = torch.matmul(dcn_sample_plain(*leaves[:3], 2, 1, 3, max_offset),
                               leaves[3].reshape(9 * c, c))
        want = torch.autograd.grad(y_plain, leaves, cot)
        torch.cuda.synchronize()
        errs = [check(f"DCN backward d{n} at {h}² clamp {max_offset}", g, r, 1e-4)[0]
                for n, g, r in zip(("x", "offset", "mask", "weight"), got, want)]
        if max_offset is not None and not bool(
                (got[1][leaves[1].abs() > max_offset] == 0).all()):
            raise RuntimeError("DCN backward: an offset beyond the clamp got a gradient")
        print(f"DCN backward float32 bs{b} {h}²->{ho}² clamp {max_offset}: kernels vs autograd "
              f"through the plain sampling, max_abs_err dx {errs[0]:.3e}, doffset {errs[1]:.3e}, "
              f"dmask {errs[2]:.3e}, dweight {errs[3]:.3e} (each within 1e-4 x max|ref|)")
    if not k4["repeats_bitwise"]:
        raise RuntimeError("K4: the tile route did not repeat bit for bit")
    at_batch_8()
    return (bound_of(dict(k3, library_ms=None)),
            bound_of(dict(k4, library_ms=None, k4_route="tile")))


def int8_link(torch, dev, gen, b, h, w, c, co, kh, nph, zero, with_res):
    """Random operands of one int8 link; the weight scale shrinks with C so
    that the output codes spread over the range at every width."""
    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    per_ch = lambda lo, hi: (torch.rand(co, generator=gen) * (hi - lo) + lo).to(dev)  # noqa: E731
    return dict(
        xc=(codes(b, h, w, c), torch.tensor(4.0, device=dev), zero), kq=codes(kh, kh, c, co),
        sw=per_ch(2e-4, 6e-4) * (128.0 / c) / (2.0 if zero else 1.0),
        bias=per_ch(-0.1, 0.1), gt=per_ch(0.75, 1.25), sh=per_ch(-0.5, 0.5),
        bound=torch.tensor(6.0, device=dev),
        mask_c=(torch.rand(b, h, w, nph, generator=gen) < 0.6).to(torch.int8).to(dev),
        res=(codes(b, h, w, co), torch.tensor(3.0, device=dev), 127.0) if with_res else None)


def int8_link_bound(link, mask_q=None):
    """(operations ms, bytes ms) of one int8 link: K1's formula
    (``conv_block_work``: the multiply-adds over the real taps and the
    epilogue), or with a per-channel ``mask_q`` K7's (``chain_conv_work``)."""
    import torch

    from radardistill_tpu_torch.ops.conv_block import conv_block_work
    from radardistill_tpu_torch.ops.int8_conv import chain_conv_work

    xq, kq, res = link["xc"][0], link["kq"], link["res"]
    b, h, w, c = xq.shape
    kh, co = kq.shape[0], kq.shape[3]
    ab = torch.empty((8, co), dtype=torch.float32, device="meta")
    r = None if res is None else res[0]
    if mask_q is None:
        ops, nbytes = conv_block_work(xq, kq, ab, link["mask_c"], r)
    else:
        xp = torch.empty((b, h + kh - 1, w, c), dtype=torch.int8, device="meta")
        ops, nbytes = chain_conv_work(xp, kq, ab, mask_q, r)
    return ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3


def phase_k1(torch, dev):
    """K1 at the teacher's stage-1 link on the route the dispatch gives it
    (the ``wgmma`` conv mainloop), both link kinds: every int8 code equal to
    the plain version, and to the old resident ``mma.sync`` variant's on the
    same operands; the bfloat16 output within 1e-2 x max|ref|. Timed: the
    wrapper, the bare launch on prepared operands, the resident variant and
    the plain version, in one run."""
    from radardistill_tpu_torch.ops import conv3x3_wgmma
    from radardistill_tpu_torch.ops.conv_block import (conv_block, conv_block_plain,
                                                       int8_block_conv_v2, link_constants,
                                                       route_of, tap_sums)

    rec = {"max_abs_err": 0.0, "ms": 0.0, "launch_ms": 0.0, "old_route_ms": 0.0,
           "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    gen = torch.Generator().manual_seed(1)
    resident = lambda *a, **k: conv_block(*a, variant="resident", **k)  # noqa: E731
    if route_of(3, 128, 128, 4, torch.int8) != "wgmma":
        raise RuntimeError("K1: the stage-1 link is not dispatched to the wgmma route")
    # the teacher's stage-1 shape: a chain's first link (zero 0, no residual)
    # and a later one (zero 127, with a residual carry)
    for zero, with_res in ((0.0, False), (127.0, True)):
        link = int8_link(torch, dev, gen, 2, 720, 720, 128, 128, 3, 4, zero, with_res)
        run = lambda block, **kw: int8_block_conv_v2(block=block, **link, **kw)  # noqa: E731
        read = reset_launches()
        got = run(conv_block)[0]
        routes = read()
        old, want = run(resident)[0], run(conv_block_plain)[0]
        torch.cuda.synchronize()
        if routes["conv_block.wgmma"] != 1 or routes["conv_block.mma_sync"] != 0:
            raise RuntimeError(f"K1: the stage-1 link ran on {routes}")
        diff = (got.int() - want.int()).abs()
        n_bad, err, n_old = int((diff != 0).sum()), int(diff.max()), int((old != want).sum())
        spread = [int((want == v).sum()) for v in (-127, 127)]
        got_bf = run(conv_block, deq_out=torch.bfloat16)
        want_bf = run(conv_block_plain, deq_out=torch.bfloat16)
        torch.cuda.synchronize()
        err_bf = (got_bf.float() - want_bf.float()).abs().max().item()
        ref_bf = want_bf.float().abs().max().item()
        n_bf = int((got_bf != want_bf).sum())
        # the bare launch on prepared operands and a preallocated output
        xq, kq, res = link["xc"][0], link["kq"], link["res"]
        ab = link_constants(link["xc"], kq, link["sw"], link["bias"], link["gt"], link["sh"],
                            link["bound"], res)[0]
        wk, wsum, out = conv3x3_wgmma.wgmma_taps(kq), tap_sums(kq), torch.empty_like(got)
        alone = lambda: conv3x3_wgmma.launch_link(  # noqa: E731
            xq, wk, ab, link["mask_c"], None if res is None else res[0], wsum, out, -int(zero))
        alone()
        torch.cuda.synchronize()
        if not torch.equal(out, got):
            raise RuntimeError("K1: the bare launch differs from the wrapper's codes")
        bound_ops, bound_bytes = int8_link_bound(link)
        ms, old_ms = paired_ms(torch, lambda: run(conv_block), lambda: run(resident), iters=20)
        launch_ms = (cuda_ms(torch, alone, 20) + cuda_ms(torch, alone, 20)) / 2
        plain_ms = cuda_ms(torch, lambda: run(conv_block_plain), 2)
        print(f"K1 conv_block (wgmma) x {tuple(xq.shape)} k {tuple(kq.shape)} zero {zero:.0f} "
              f"res {res is not None}: {n_bad} of {got.numel()} codes differ from plain (max "
              f"{err}), resident mma.sync variant {n_old}; codes at -127/127: {spread}; bfloat16 "
              f"out: max_abs_err {err_bf:.3e} (limit {1e-2 * ref_bf:.3e}), {n_bf} values differ; "
              f"wrapper {ms:.4f} ms, launch alone {launch_ms:.4f} ms "
              f"({bound_ops * PEAK_INT8_OPS / 1e12 / launch_ms:.1f} TOP/s), resident mma.sync "
              f"{old_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{max(bound_ops, bound_bytes):.4f} ms (operations {bound_ops:.4f}, bytes "
              f"{bound_bytes:.4f})")
        if n_bad or n_old or not err_bf <= 1e-2 * ref_bf:
            raise RuntimeError(f"K1: {n_bad} codes differ from plain, {n_old} from the resident "
                               f"variant; bfloat16 error {err_bf}")
        rec["max_abs_err"] = max(rec["max_abs_err"], float(err))
        # one forward runs two links of each kind
        for key, v in (("ms", ms), ("launch_ms", launch_ms), ("old_route_ms", old_ms),
                       ("plain_ms", plain_ms), ("bytes_ms", bound_bytes), ("ops_ms", bound_ops)):
            rec[key] += 2 * v
    rec["library_ms"] = None
    return bound_of(rec)


def phase_k1_deep(torch, dev):
    """K1 at the link shapes of the ``INT8_STAGES: 5`` chain beyond stage 1,
    each on the route the dispatch gives it (``wgmma`` where C and Co are
    multiples of 128, else the ``mma.sync`` kernel, resident or streamed);
    every code equal to the plain version's on that route and on the
    ``mma.sync`` variant (resident where the weight fits, else streamed), and
    the links on ``wgmma`` are timed against that variant too. Returns the
    sums over those 19 launches."""
    from radardistill_tpu_torch.ops.conv_block import (conv_block, conv_block_plain,
                                                       int8_block_conv_v2, resident_fits, route_of)

    gen = torch.Generator().manual_seed(6)
    tot = dict.fromkeys(("ms", "old_route_ms", "device_ms", "device_old_route_ms", "plain_ms",
                         "bound_ms", "wgmma_device_ms", "mma_sync_device_ms"), 0.0)
    for hw, c, co, kh, n_plain, n_res in INT8_DEEP_LINKS:
        route = route_of(kh, c, co, 1, torch.int8)
        old_route = "resident" if resident_fits(kh, c, co, 1) else "streamed"
        old = lambda *a, **k: conv_block(*a, variant=old_route, **k)  # noqa: E731
        for with_res, count in ((False, n_plain), (True, n_res)):
            if not count:
                continue
            link = int8_link(torch, dev, gen, 2, hw, hw, c, co, kh, 1, 127.0, with_res)
            run = lambda block: int8_block_conv_v2(block=block, **link)  # noqa: E731
            read = reset_launches()
            got = run(conv_block)[0]
            moved = read()
            want, got_old = run(conv_block_plain)[0], run(old)[0]
            torch.cuda.synchronize()
            n_bad, n_old = int((got != want).sum()), int((got_old != want).sum())
            ops_ms, bytes_ms = int8_link_bound(link)
            # the wrapper as a caller meets it (host-bound below 720²), and its
            # device time; the wgmma links on their mma.sync variant too
            new_fn, old_fn = lambda: run(conv_block), lambda: run(old)  # noqa: E731
            if route == "wgmma":
                ms, old_ms = paired_ms(torch, new_fn, old_fn, iters=10)
                dev_ms, dev_old_ms = paired_ms(torch, new_fn, old_fn, iters=10, timer=device_ms)
            else:
                ms = old_ms = (cuda_ms(torch, new_fn, 10) + cuda_ms(torch, new_fn, 10)) / 2
                dev_ms = dev_old_ms = device_ms(torch, new_fn, 10)
            plain_ms = cuda_ms(torch, lambda: run(conv_block_plain), 2)
            print(f"K1 conv_block ({route}) x (2, {hw}, {hw}, {c}) k ({kh}, {kh}, {c}, {co}) "
                  f"res {with_res}: {n_bad} of {got.numel()} codes differ, {n_old} on the "
                  f"{old_route} mma.sync variant; "
                  f"{100 * float((want > -127).float().mean()):.0f}% of codes above -127; wrapper "
                  f"{ms:.4f} ms, device {dev_ms:.4f} ms ({old_route} mma.sync {old_ms:.4f}, "
                  f"device {dev_old_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
                  f"{max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f}, bytes "
                  f"{bytes_ms:.4f})")
            if (n_bad or n_old
                    or moved[f"conv_block.{'wgmma' if route == 'wgmma' else 'mma_sync'}"] != 1):
                raise RuntimeError(f"K1 at {hw}² C {c}: {n_bad} codes differ from plain, {n_old} "
                                   f"on the {old_route} variant; launches {moved} (route {route})")
            for key, v in (("ms", ms), ("old_route_ms", old_ms), ("device_ms", dev_ms),
                           ("device_old_route_ms", dev_old_ms), ("plain_ms", plain_ms),
                           ("bound_ms", max(ops_ms, bytes_ms)),
                           (f"{'wgmma' if route == 'wgmma' else 'mma_sync'}_device_ms", dev_ms)):
                tot[key] += count * v
    print(f"K1 over the 19 links of the INT8_STAGES: 5 chain beyond stage 1: wrapper "
          f"{tot['ms']:.4f} ms (all 19 on mma.sync {tot['old_route_ms']:.4f}); device "
          f"{tot['device_ms']:.4f} ms (wgmma links {tot['wgmma_device_ms']:.4f}, mma.sync links "
          f"{tot['mma_sync_device_ms']:.4f}; all 19 on mma.sync {tot['device_old_route_ms']:.4f}), "
          f"plain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
    return tot


def phase_k7(torch, dev):
    """K7 at the conv5 link of the ``INT8_STAGES: 5`` chain and at a 3x3 link
    with a per-channel mask and a residual, on the route the dispatch gives
    them (``wgmma``): equal to plain, to the streamed kernel and, on an
    all-ones mask, to K1. Timed in one run: the wrapper (and its device
    time), the bare launch on prepared operands beside K1's on the same
    product with its one-word mask, the streamed kernel's wrapper, the plain
    version. The record is the conv5 link's, the main path's launch."""
    import torch.nn.functional as F

    from radardistill_tpu_torch.ops import conv3x3_wgmma
    from radardistill_tpu_torch.ops.conv_block import (conv_block, int8_block_conv_v2,
                                                       link_constants, tap_sums)
    from radardistill_tpu_torch.ops.int8_conv import (chain_conv, chain_conv_plain,
                                                      chain_route_of, int8_block_conv)

    gen = torch.Generator().manual_seed(7)
    streamed = lambda *a, **k: chain_conv(*a, variant="streamed", **k)  # noqa: E731
    rec = None
    for name, (h, c, co, kh, with_res) in (("conv5 link", (90, 1024, 256, 2, False)),
                                           ("3x3 link", (90, 256, 256, 3, True))):
        route = chain_route_of(kh, c, co)
        if route != "wgmma":
            raise RuntimeError(f"K7 {name}: dispatched to {route}, not wgmma")
        link = int8_link(torch, dev, gen, 2, h, h, c, co, kh, 1, 127.0, with_res)
        args = {k: v for k, v in link.items() if k != "mask_c"}
        if with_res:  # a mask that differs from channel to channel
            mq = (torch.rand(2, h, h, co, generator=gen) < 0.6).to(torch.int8).to(dev)
        else:
            mq = torch.ones((2, h, h, co), dtype=torch.int8, device=dev)
        run = lambda block: int8_block_conv(mask_q=mq, block=block, **args)[0]  # noqa: E731
        read = reset_launches()
        got = run(chain_conv)
        moved = read()
        want, old = run(chain_conv_plain), run(streamed)
        # K1 on the same link: a lane mask it can take is constant per pixel
        ones = torch.ones((2, h, h, co), dtype=torch.int8, device=dev)
        k7_ones = int8_block_conv(mask_q=ones, **args)[0]
        k1_ones = int8_block_conv_v2(mask_c=ones[..., :1].contiguous(), block=conv_block,
                                     **args)[0]
        torch.cuda.synchronize()
        if moved["chain_conv.wgmma"] != 1 or moved["chain_conv.streamed"] != 0:
            raise RuntimeError(f"K7 {name}: launches {moved}")
        n_bad, n_old = int((got != want).sum()), int((old != want).sum())
        n_k1 = int((k7_ones != k1_ones).sum())
        # the bare launch on prepared operands and a preallocated output
        xq, kq, res = link["xc"][0], link["kq"], link["res"]
        ab = link_constants(link["xc"], kq, link["sw"], link["bias"], link["gt"], link["sh"],
                            link["bound"], res)[0]
        xp = F.pad(xq, (0, 0, 0, 0, 1, kh - 2), value=-127)
        wk, wsum, out = conv3x3_wgmma.wgmma_taps(kq), tap_sums(kq), torch.empty_like(got)
        alone = lambda: conv3x3_wgmma.launch_chain(  # noqa: E731
            xp, wk, ab, mq, None if res is None else res[0], wsum, out, -127)
        alone()
        torch.cuda.synchronize()
        if not torch.equal(out, got):
            raise RuntimeError(f"K7 {name}: the bare launch differs from the wrapper's codes")
        # K1's bare launch of the same product, its mask a word a pixel
        ones_c, out1 = ones[..., :1].contiguous(), torch.empty_like(got)
        k1_alone = lambda: conv3x3_wgmma.launch_link(  # noqa: E731
            xq, wk, ab, ones_c, None if res is None else res[0], wsum, out1, -127)
        ops_ms, bytes_ms = int8_link_bound(link, mq)
        ms, old_ms = paired_ms(torch, lambda: run(chain_conv), lambda: run(streamed), iters=20)
        # the wrapper costs the host more than the card: its device time too
        dev_ms = device_ms(torch, lambda: run(chain_conv), 20)
        launch_ms, k1_ms = paired_ms(torch, alone, k1_alone, iters=20)
        plain_ms = cuda_ms(torch, lambda: run(chain_conv_plain), 2)
        print(f"K7 chain_conv ({route}) {name} x (2, {h + kh - 1}, {h}, {c}) pre-padded, k ({kh}, "
              f"{kh}, {c}, {co}), lane mask {tuple(mq.shape)}, res {with_res}: {n_bad} of "
              f"{got.numel()} codes differ from plain, {n_old} on the streamed mma.sync kernel, "
              f"{n_k1} from K1 on an all-ones mask; "
              f"{100 * float((want > -127).float().mean()):.0f}% of codes above -127; wrapper "
              f"{ms:.4f} ms (device {dev_ms:.4f} ms), launch alone {launch_ms:.4f} ms "
              f"({ops_ms * PEAK_INT8_OPS / 1e12 / launch_ms:.1f} TOP/s; K1's bare launch with a "
              f"mask word a pixel {k1_ms:.4f} ms), streamed mma.sync "
              f"wrapper {old_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f}, bytes {bytes_ms:.4f})")
        if n_bad or n_old or n_k1:
            raise RuntimeError(f"K7 {name}: {n_bad} codes differ from plain, {n_old} on the "
                               f"streamed kernel, {n_k1} from K1")
        if rec is None:  # the main path's launch
            rec = bound_of({"max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
                            "launch_ms": launch_ms, "old_route_ms": old_ms, "plain_ms": plain_ms,
                            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "library_ms": None})
    return rec


def fp_link(torch, dev, gen, dtype, b, h, w, c, co, kh, nph, with_res):
    return dict(
        x=torch.randn(b, h, w, c, generator=gen).to(dev, dtype),
        kernel=(torch.randn(kh, kh, c, co, generator=gen) / (kh * kh * c) ** 0.5).to(dev),
        bias=(torch.randn(co, generator=gen) * 0.1).to(dev),
        gt=(torch.rand(co, generator=gen) + 0.5).to(dev),
        sh=(torch.randn(co, generator=gen) * 0.1).to(dev),
        mask_c=(torch.rand(b, h, w, nph, generator=gen) < 0.6).to(torch.int8).to(dev),
        res=torch.randn(b, h, w, co, generator=gen).to(dev, dtype) if with_res else None)


def phase_k6(torch, dev):
    """K6 at the link shapes of the ``FP_STAGES: 5`` chain on both bfloat16
    routes, each forced: every link held against the plain version, the
    launch counted on the route forced; the wgmma route's bare launch on the
    prepared taps equal to its wrapper's output. Timed in one run: the plain
    version, the ``wgmma`` route (wrapper and launch alone), the ``mma.sync``
    route, and as an aside that is not the same function (no affine,
    residual, relu or mask) cuDNN's bfloat16 ``F.conv2d`` of the same
    products, channels-last (a 2x2 link on its input padded once outside the
    timing). Then float32 (the FFMA route) at two of the shapes, and 2- and
    4-phase masks and odd grids on both bfloat16 routes. Returns the sums
    over the 19 launches (bfloat16)."""
    import torch.nn.functional as F

    from radardistill_tpu_torch.ops import conv3x3_wgmma
    from radardistill_tpu_torch.ops.conv_block import (conv_block_fp, conv_block_fp_plain,
                                                       conv_block_fp_work, fp_block_conv,
                                                       fp_route_of)

    gen = torch.Generator().manual_seed(8)
    rec = dict.fromkeys(("max_abs_err", "ms", "launch_ms", "old_route_ms", "plain_ms",
                         "aside_ms", "bytes_ms", "ops_ms"), 0.0)
    forced = {r: (lambda *a, r=r: conv_block_fp(*a, variant=r)) for r in ("wgmma", "mma_sync")}

    def check(link, tag, tol, routes):
        want = fp_block_conv(block=conv_block_fp_plain, **link)
        ref = want.float().abs().max().item()
        got, errs = {}, {}
        for route in routes:
            before = dict(conv_block_fp.route_launches)
            got[route] = fp_block_conv(block=forced.get(route, conv_block_fp), **link)
            torch.cuda.synchronize()
            moved = [r for r, n in conv_block_fp.route_launches.items() if n != before[r]]
            if moved != [route]:
                raise RuntimeError(f"K6 {tag}: a launch forced on {route} counted on {moved}")
            errs[route] = (got[route].float() - want.float()).abs().max().item()
            if not errs[route] <= tol * ref:
                raise RuntimeError(f"K6 {tag} ({route}): error {errs[route]} over {tol} x {ref}")
        print(f"K6 conv_block_fp {tag}: max_abs_err "
              + ", ".join(f"{r} {e:.3e}" for r, e in errs.items()) + f" (limit {tol * ref:.3e})")
        return errs.get("wgmma", 0.0), got

    for hw, c, co, kh, n_plain, n_res in FP_LINKS:
        for with_res, count in ((False, n_plain), (True, n_res)):
            if not count:
                continue
            link = fp_link(torch, dev, gen, torch.bfloat16, 2, hw, hw, c, co, kh, 1, with_res)
            tag = f"bfloat16 x (2, {hw}, {hw}, {c}) k ({kh}, {kh}, {c}, {co}) res {with_res}"
            if fp_route_of(c, co, 1, torch.bfloat16) != "wgmma":
                raise RuntimeError(f"K6 {tag}: the dispatch does not send it to wgmma")
            err, got = check(link, tag, 1e-2, ("wgmma", "mma_sync"))
            # the bare launch on prepared operands, as the wrapper prepares them
            wk = conv3x3_wgmma.wgmma_taps(link["kernel"].to(torch.bfloat16))
            ab = torch.stack([link["gt"], link["bias"] * link["gt"] + link["sh"]]).float()
            out = torch.empty_like(got["wgmma"])
            alone = lambda: conv3x3_wgmma.launch_fp_link(  # noqa: E731
                link["x"], wk, ab, link["mask_c"], link["res"], out)
            alone()
            torch.cuda.synchronize()
            if not torch.equal(out, got["wgmma"]):
                raise RuntimeError(f"K6 {tag}: the bare launch differs from the wrapper's output")
            xn = link["x"].permute(0, 3, 1, 2)
            if kh == 2:
                xn = F.pad(xn, (1, 0, 1, 0))
            wn = link["kernel"].to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            old1 = cuda_ms(torch, lambda: fp_block_conv(block=forced["mma_sync"], **link), 10)
            ms, plain_ms = paired_ms(torch, lambda: fp_block_conv(block=conv_block_fp, **link),
                                     lambda: fp_block_conv(block=conv_block_fp_plain, **link),
                                     iters=10, plain_iters=2)
            old2 = cuda_ms(torch, lambda: fp_block_conv(block=forced["mma_sync"], **link), 10)
            launch_ms = (cuda_ms(torch, alone, 10) + cuda_ms(torch, alone, 10)) / 2
            aside_ms = cuda_ms(torch, lambda: F.conv2d(xn, wn, None, 1, 1 if kh == 3 else 0), 10)
            ops, nbytes = conv_block_fp_work(link["x"], link["kernel"].to(torch.bfloat16), ab,
                                             link["mask_c"], link["res"])
            ops_ms = ops / PEAK_BF16_OPS * 1e3
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            print(f"  x {count}: wgmma wrapper {ms:.4f} ms, launch alone {launch_ms:.4f} ms "
                  f"({ops_ms * PEAK_BF16_OPS / 1e12 / launch_ms:.0f} TFLOP/s) [mma.sync "
                  f"{(old1 + old2) / 2:.4f} ms], plain {plain_ms:.4f} ms, bound "
                  f"{max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f}, bytes "
                  f"{bytes_ms:.4f}, {nbytes / 1e6:.1f} MB); aside, conv only: cuDNN bf16 "
                  f"F.conv2d {aside_ms:.4f} ms")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            for key, v in (("ms", ms), ("launch_ms", launch_ms),
                           ("old_route_ms", (old1 + old2) / 2), ("plain_ms", plain_ms),
                           ("aside_ms", aside_ms), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                rec[key] += count * v
    print(f"K6 conv_block_fp, the 19 links of FP_STAGES: 5 summed: wgmma wrapper {rec['ms']:.4f} "
          f"ms, launch alone {rec['launch_ms']:.4f} ms [mma.sync {rec['old_route_ms']:.4f} ms]; "
          f"aside, conv only: cuDNN bf16 F.conv2d {rec['aside_ms']:.4f} ms")
    # float32 at two of the shapes, 2- and 4-phase masks, odd grids
    for dtype, tol, (b, h, w, c, co, kh, nph, with_res) in (
            (torch.float32, 1e-5, (2, 180, 180, 256, 256, 3, 1, True)),
            (torch.float32, 1e-5, (2, 90, 90, 1024, 256, 2, 1, False)),
            (torch.bfloat16, 1e-2, (2, 90, 90, 256, 256, 3, 4, True)),
            (torch.bfloat16, 1e-2, (1, 45, 77, 128, 128, 3, 2, True)),
            (torch.bfloat16, 1e-2, (1, 45, 77, 64, 64, 3, 2, True)),
            (torch.bfloat16, 1e-2, (1, 19, 37, 64, 64, 2, 4, True)),
            (torch.float32, 1e-5, (1, 45, 77, 128, 128, 3, 2, False))):
        link = fp_link(torch, dev, gen, dtype, b, h, w, c, co, kh, nph, with_res)
        tag = (f"{str(dtype)[6:]} x ({b}, {h}, {w}, {c}) k ({kh}, {kh}, {c}, {co}) nph {nph} "
               f"res {with_res}")
        check(link, tag, tol, ("ffma",) if dtype == torch.float32 else ("wgmma", "mma_sync"))
    rec["library_ms"] = None  # no single PyTorch call fuses the conv with this epilogue
    return bound_of(rec)


def phase_fp_teacher_bf16(torch, dev, small):
    """The ``FP_STAGES: 5`` teacher in bfloat16 against the card's own float32
    forward of the same batch and weights (TF32 off), grid 512: rel-L2 of the
    teacher's features (``tools/torch_fp_teacher_rel.py``). Both forwards run
    the port's kernels (bfloat16: K6 on its routes; float32: K6's FFMA
    kernel), so the figure is what bfloat16 costs the chain. Returns it."""
    from tools.torch_fp_teacher_rel import report, teacher_rel

    rel, launches = teacher_rel(torch, dev, small)
    report(rel, launches)
    return rel


def phase_k9(torch, dev):
    """K9 at (2, 180, 180, 256) -> 256: forward and both gradients against
    autograd through ``F.conv2d`` (TF32 off). The record is one forward and
    backward in bfloat16: two launches of the kernel (y and dx); the library
    call is ``F.conv2d`` on the same operands, for y and for dx."""
    import torch.nn.functional as F

    from radardistill_tpu_torch.ops import conv3x3_wgmma
    from radardistill_tpu_torch.ops.wide_conv import (conv3x3_wide, conv3x3_wide_plain, conv_or_dx,
                                                      conv_or_dx_work, wgmma_weights)

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(9)
    b, hw, c = 2, 180, 256
    rec = None
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        x = torch.randn(b, hw, hw, c, generator=gen).to(dev, dtype).requires_grad_()
        k = (torch.randn(3, 3, c, c, generator=gen) / (9 * c) ** 0.5).to(dev).requires_grad_()
        ct = torch.randn(b, hw, hw, c, generator=gen).to(dev, dtype)
        conv3x3_wide.launches = 0
        y = conv3x3_wide(x, k)
        got = (y, *torch.autograd.grad(y, (x, k), ct))
        launches = conv3x3_wide.launches
        yr = F.conv2d(x.permute(0, 3, 1, 2), k.to(dtype).permute(3, 2, 0, 1),
                      padding=1).permute(0, 2, 3, 1)
        want = (yr, *torch.autograd.grad(yr, (x, k), ct))
        torch.cuda.synchronize()
        errs = []
        for name, g, r in zip(("y", "dx", "dW"), got, want):
            err = (g.float() - r.float()).abs().max().item()
            ref = r.float().abs().max().item()
            errs.append(f"{name} {err:.3e} (limit {tol * ref:.3e})")
            if not err <= tol * ref or g.dtype != r.dtype:
                raise RuntimeError(f"K9 {dtype} {name}: error {err} over {tol} x {ref}")
        print(f"K9 conv3x3_wide {str(dtype)[6:]} x (2, {hw}, {hw}, {c}) k (3, 3, {c}, {c}), "
              f"{launches} launches for forward + backward: max_abs_err " + ", ".join(errs))
        if launches != 2:
            raise RuntimeError(f"K9: {launches} launches for one forward and backward, not 2")
        if dtype != torch.bfloat16:
            continue
        # y and dx as the autograd wrapper runs them, from the float32 parameter
        xd, kd = x.detach(), k.detach()
        kt = kd.flip(0, 1).transpose(2, 3)
        kern = lambda: (conv_or_dx(xd, kd), conv_or_dx(ct, kd, backward=True))  # noqa: E731
        plain = lambda: (conv3x3_wide_plain(xd, kd), conv3x3_wide_plain(ct, kt))  # noqa: E731
        # the launches alone: prepared K-major weights, preallocated outputs
        wf, wb = wgmma_weights(kd), wgmma_weights(kd, backward=True)
        yo, dxo = torch.empty_like(xd), torch.empty_like(ct)
        alone = lambda: (conv3x3_wgmma.launch(xd, wf, yo, "conv", padded=False),  # noqa: E731
                         conv3x3_wgmma.launch(ct, wb, dxo, "conv", padded=False, flip=True))
        alone()
        if not (torch.equal(yo, got[0]) and torch.equal(dxo, got[1])):
            raise RuntimeError("K9: the bare launches differ from the wrapper's y and dx")
        xn, cn = (t.permute(0, 3, 1, 2) for t in (xd, ct))
        wn, wtn = (t.to(dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                   for t in (kd, kt))
        ms, plain_ms = paired_ms(torch, kern, plain, iters=20, plain_iters=2)
        launch_ms = (cuda_ms(torch, alone, 20) + cuda_ms(torch, alone, 20)) / 2
        lib_ms = cuda_ms(torch, lambda: (F.conv2d(xn, wn, padding=1),
                                         F.conv2d(cn, wtn, padding=1)), 20)
        # y and dx, each on a bfloat16 operand, as the wrapper launches them
        y_work = conv_or_dx_work(xd, kd)
        dx_work = conv_or_dx_work(ct, kd, backward=True)
        ops_ms = (y_work[0] + dx_work[0]) / PEAK_BF16_OPS * 1e3
        bytes_ms = (y_work[1] + dx_work[1]) / PEAK_BYTES * 1e3
        print(f"K9 conv3x3_wide bfloat16, y and dx (TMA + wgmma mainloop): wrapper {ms:.4f} ms, "
              f"launches alone {launch_ms:.4f} ms, plain {plain_ms:.4f} ms, F.conv2d "
              f"{lib_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f}, "
              f"bytes {bytes_ms:.4f}); {ops_ms * PEAK_BF16_OPS / 1e12 / launch_ms:.1f} TFLOP/s "
              "launched alone")
        rec = bound_of({"max_abs_err": max((g.float() - r.float()).abs().max().item()
                                           for g, r in zip(got[:2], want[:2])),
                        "ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
                        "bytes_ms": bytes_ms, "ops_ms": ops_ms, "library_ms": lib_ms})
    torch.backends.cudnn.allow_tf32 = True
    return rec, launches


def reset_launches():
    """Set every kernel wrapper's count to 0; returns a reader of the counts."""
    from radardistill_tpu_torch.ops.conv_block import conv_block, conv_block_fp
    from radardistill_tpu_torch.ops.dcn_grad import dcn_input_grad, dcn_offset_grad
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample
    from radardistill_tpu_torch.ops.expand import expand_rows, gather_rows_windowed
    from radardistill_tpu_torch.ops.int8_conv import chain_conv
    from radardistill_tpu_torch.ops.probes import conv_probe, mma_rate
    from radardistill_tpu_torch.ops.wide_conv import conv3x3_wide

    fns = {"expand_rows": expand_rows, "dcn_sample": dcn_sample, "conv_block": conv_block,
           "dcn_offset_grad": dcn_offset_grad, "dcn_input_grad": dcn_input_grad,
           "chain_conv": chain_conv, "conv_block_fp": conv_block_fp,
           "conv3x3_wide": conv3x3_wide, "gather_rows_windowed": gather_rows_windowed,
           "conv_probe": conv_probe, "mma_rate": mma_rate}
    for fn in fns.values():
        fn.launches = 0
    routes, dx_routes = conv_block.route_launches, dcn_input_grad.route_launches
    fp_routes, chain_routes = conv_block_fp.route_launches, chain_conv.route_launches
    for r in (routes, dx_routes, fp_routes, chain_routes):
        for k in r:
            r[k] = 0

    def read():
        # K1 also by route: the wgmma conv mainloop, or the mma.sync kernel
        # (resident and streamed variants); K6 by route: wgmma, mma.sync or
        # ffma; K7 by route: wgmma or streamed; K4 by route: tile or atomic
        return {**{k: fn.launches for k, fn in fns.items()},
                "conv_block.wgmma": routes["wgmma"],
                "conv_block.mma_sync": routes["resident"] + routes["streamed"],
                **{f"conv_block_fp.{k}": n for k, n in fp_routes.items()},
                **{f"chain_conv.{k}": n for k, n in chain_routes.items()},
                **{f"dcn_input_grad.{k}": n for k, n in dx_routes.items()}}

    return read


def all_finite(torch, tree):
    if isinstance(tree, dict):
        return all(all_finite(torch, v) for v in tree.values())
    return not tree.is_floating_point() or bool(torch.isfinite(tree).all())


def phase_forward_bf16(torch, dev, name, cfg, info, batch, expect_launches, runs):
    """One path in bfloat16 on the kernel path: launch counts of one forward,
    finite outputs of the expected shapes, no overflow, p50 of synced runs."""
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_

    model = init_random_(build_network(cfg, info, compute_dtype=torch.bfloat16),
                         torch.Generator().manual_seed(0))
    bdev = batch_to_torch(batch)
    if next(model.parameters()).device != dev or bdev["gt_boxes"].device != dev:
        raise RuntimeError("the entry points did not default to the card")
    model(bdev)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    read = reset_launches()
    out = model(bdev)
    torch.cuda.synchronize()
    launches = read()
    print(f"{name} bf16 launches in one forward: {launches}")
    expect_launches = {**dict.fromkeys(launches, 0), **expect_launches}
    if launches != expect_launches:
        raise RuntimeError(f"{name}: main path launches {launches}, expected {expect_launches}")

    g, b = info["grid_size"][0], bdev["gt_boxes"].shape[0]
    fmap = (b, g // 8, g // 8, 256)
    expect = {"radar_x_conv4": fmap, "radar_spatial_features_2d": fmap}
    heads = ["radar_preds"]
    if model.has_teacher:
        expect.update({"x_conv4": fmap, "x_conv5": (b, g // 16, g // 16, 256),
                       "spatial_features_2d": fmap, "spatial_features_2d_8x": fmap})
        heads.append("lidar_preds")
    for k, shape in expect.items():
        if tuple(out[k].shape) != shape:
            raise RuntimeError(f"{name} {k}: shape {tuple(out[k].shape)} (want {shape})")
    n_heads = model.head_spec.num_heads
    for head in heads:
        for k, v in out[head].items():
            if tuple(v.shape[:4]) != (b, g // 8, g // 8, n_heads):
                raise RuntimeError(f"{name} {head}[{k}]: shape {tuple(v.shape)}")
    fin = out.pop("final_box_dicts")
    if not all_finite(torch, out):
        raise RuntimeError(f"{name}: an output is not finite")
    n_valid = int(fin["valid"].sum())
    if tuple(fin["boxes"].shape) != (b, n_heads * 83, 9) or not torch.isfinite(
            fin["boxes"][fin["valid"]]).all() or n_valid == 0:
        raise RuntimeError(f"{name}: final boxes {tuple(fin['boxes'].shape)}, {n_valid} valid")
    if int(out["as_overflow"]) != 0:
        raise RuntimeError(f"{name}: as_overflow {int(out['as_overflow'])}")
    print(f"{name} bf16 outputs: finite, expected shapes, as_overflow 0, {n_valid} valid boxes")

    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        model(bdev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    p50 = (times[(runs - 1) // 2] + times[runs // 2]) / 2 * 1e3
    print(f"{name} bf16 forward latency p50 {p50:.3f} ms over {runs} synced runs "
          f"(min {times[0] * 1e3:.3f}, max {times[-1] * 1e3:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_forward_f32(torch, dev, name, cfg, info, batch, tol, v1_equal=()):
    """One path in float32 with TF32 off: the kernel path on the card against
    the plain path (the same model on the CPU). ``tol`` maps an output key to
    its rel-L2 limit; a key naming a dict of predictions holds each head. The
    keys of ``v1_equal`` must come out bit-equal when the same model runs on
    the card once more with ``CONV_BLOCK_V1=1`` (every int8 link through the
    first-generation kernel)."""
    import os

    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = init_random_(build_network(cfg, info, compute_dtype=torch.float32, device="cpu"),
                         torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    ref = model(batch_to_torch(batch, "cpu"))  # plain versions
    t_cpu = time.perf_counter() - t0
    read = reset_launches()
    got = model.to(dev)(batch_to_torch(batch, dev))  # kernels
    torch.cuda.synchronize()
    errs = {}
    for key, limit in tol.items():
        if isinstance(ref[key], dict):
            errs.update({f"{key}.{k}": (rel_l2(torch, got[key][k], v), limit)
                         for k, v in ref[key].items()})
        else:
            errs[key] = (rel_l2(torch, got[key], ref[key]), limit)
    print(f"{name} f32 (TF32 off), grid {info['grid_size'][0]}: card (kernels, launches {read()}) "
          f"vs CPU (plain, {t_cpu:.1f} s) rel-L2: "
          + ", ".join(f"{k} {v:.3e}" for k, (v, _) in errs.items()))
    bad = {k: v for k, (v, limit) in errs.items() if not v <= limit}
    if bad or int(got["as_overflow"]) != int(ref["as_overflow"]):
        raise RuntimeError(f"{name} f32 kernel path vs plain: {bad}, as_overflow "
                           f"{int(got['as_overflow'])} vs {int(ref['as_overflow'])}")
    if v1_equal:
        v2_launches = read()
        os.environ["CONV_BLOCK_V1"] = "1"
        try:
            read = reset_launches()
            got_v1 = model(batch_to_torch(batch, dev))
            torch.cuda.synchronize()
        finally:
            del os.environ["CONV_BLOCK_V1"]
        v1_launches = read()
        differ = [k for k in v1_equal if not torch.equal(got_v1[k], got[k])]
        print(f"{name} f32 with CONV_BLOCK_V1=1: conv_block x {v1_launches['conv_block']}, "
              f"chain_conv x {v1_launches['chain_conv']} ({v1_launches['chain_conv.wgmma']} on "
              f"wgmma, {v1_launches['chain_conv.streamed']} streamed) (v2 route: "
              f"{v2_launches['conv_block']}, {v2_launches['chain_conv']}); "
              f"{', '.join(v1_equal)} bit-equal to the v2 route's: {not differ}")
        links = v2_launches["conv_block"] + v2_launches["chain_conv"]
        if differ or v1_launches["conv_block"] != 0 or v1_launches["chain_conv"] != links:
            raise RuntimeError(f"{name}: v1 route differs in {differ}, launches {v1_launches}")


def build_trainer(torch, yaml_name, cfg, info, dtype, device):
    """Model with seeded random weights, its optimizer and its train step, as
    a user builds them (1000 total steps, as the reference's benchmark)."""
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.layers import init_random_
    from radardistill_tpu_torch.train.optim import build_optimizer
    from radardistill_tpu_torch.train.train_step import make_train_step
    from radardistill_tpu_torch.utils.production import production_cfg

    full, _ = production_cfg(yaml_name, grid=info["grid_size"][0])
    kwargs = {} if device is None else {"device": device}  # None: the entry point's default
    model = init_random_(build_network(cfg, info, compute_dtype=dtype, **kwargs),
                         torch.Generator().manual_seed(0))
    opt, lr_sched = build_optimizer(full.OPTIMIZATION, model, 1000, model.frozen)
    step = make_train_step(model, opt, cfg, info["class_names"], info["voxel_size"],
                           info["point_cloud_range"])
    return model, step, lr_sched


def phase_train_bf16(torch, dev, yaml_name, cfg, info, batch, expect_launches, runs,
                     eval_launches=None):
    """The train step in bfloat16 at full size: launch counts of one step,
    finite losses, no overflow, trained parameters moved and frozen ones
    untouched, p50 of synced steps; with ``eval_launches``, one eval forward
    of the trained model after them, whose counts must be those. Returns
    (launches, p50 ms)."""
    from radardistill_tpu_torch.models.detector import batch_to_torch

    model, step, _ = build_trainer(torch, yaml_name, cfg, info, torch.bfloat16, None)
    bdev = batch_to_torch(batch)
    if next(model.parameters()).device != dev or bdev["gt_boxes"].device != dev:
        raise RuntimeError("the entry points did not default to the card")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    torch.cuda.reset_peak_memory_stats()

    read = reset_launches()
    losses = [step(bdev)]  # warm step: cuDNN picks its algorithms
    torch.cuda.synchronize()
    launches = read()
    print(f"train step bf16 launches in one step: {launches}")
    expect_launches = {**dict.fromkeys(launches, 0), **expect_launches}
    if launches != expect_launches:
        raise RuntimeError(f"train step: launches {launches}, expected {expect_launches}")

    read = reset_launches()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        losses.append(step(bdev))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if read() != {k: runs * v for k, v in expect_launches.items()}:
        raise RuntimeError(f"train step: launches over {runs} steps {read()}")
    vals = [float(m["loss"]) for m in losses]
    print("train step bf16 loss per step: " + ", ".join(f"{v:.4f}" for v in vals))
    last = losses[-1]
    print(f"  last step: rpn_loss {float(last['rpn_loss']):.4f}, distll_loss "
          f"{float(last['distll_loss']):.4f}, grad_norm "
          f"{float(step.state.optimizer.grad_norm):.4f}, "
          f"dcn_offset_sat {float(last['dcn_offset_sat']):.4f}")
    if not all(v == v and abs(v) != float("inf") for v in vals):
        raise RuntimeError("train step: a loss is not finite")
    if any(int(m["as_overflow"]) != 0 for m in losses):
        raise RuntimeError("train step: as_overflow is not 0")

    after = model.state_dict()
    frozen_scopes = tuple(model.frozen)
    stuck = [n for n in trainable if torch.equal(after[n], before[n])]
    moved = [n for n in after if n not in trainable and not torch.equal(after[n], before[n])
             and (n.split(".", 1)[0] in frozen_scopes or n.endswith("down_bias"))]
    # the teacher's head does not run while a student trains (as in the
    # reference), so its statistics stay where they were
    idle = frozen_scopes + (("dense_head",) if model.has_radar else ())
    stats = [n for n in after if n not in trainable and n.split(".", 1)[0] not in idle
             and not n.endswith("down_bias") and torch.equal(after[n], before[n])]
    if stuck or moved or stats or not all_finite(torch, dict(after)):
        raise RuntimeError(f"train step: trainable parameters unchanged {stuck[:5]}, frozen "
                           f"entries changed {moved[:5]}, BN statistics unchanged {stats[:5]}")
    n_frozen = sum(1 for n in after if n.split(".", 1)[0] in frozen_scopes)
    print(f"train step bf16: {len(trainable)} trainable parameters all changed, "
          f"{n_frozen} frozen parameters and statistics (and the DCN down_bias) bit-equal, "
          f"the student's BN statistics all updated, as_overflow 0")

    times.sort()
    p50 = (times[(runs - 1) // 2] + times[runs // 2]) / 2 * 1e3
    print(f"train step bf16, 1440², bs2: p50 {p50:.3f} ms over {runs} synced steps "
          f"(min {times[0] * 1e3:.3f}, max {times[-1] * 1e3:.3f}); "
          f"{bdev['gt_boxes'].shape[0] / p50 * 1e3:.3f} samples/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if eval_launches is not None:
        read = reset_launches()
        with torch.no_grad():
            out = model.eval()(bdev)
        torch.cuda.synchronize()
        got = read()
        want = {**dict.fromkeys(got, 0), **eval_launches}
        print(f"  then one eval forward of the trained model: launches {got}")
        if got != want or not all_finite(torch, out):
            raise RuntimeError(f"eval forward after training: launches {got}, expected {want}, "
                               f"finite {all_finite(torch, out)}")
    return launches, p50


# leaves of the student whose true gradient is zero in train mode: the conv
# biases that feed a BatchNorm directly, and encoder_3_1's last bias and GRN
# beta (a constant shift into agg_2's 1x1 conv, which its BatchNorm removes);
# see phase 11 of the module docstring
ZERO_GRAD = re.compile(
    r"radar_backbone_3d\.conv\d_\d\.conv[12]\.conv\.bias"
    r"|radar_cma\.(decoder_\d\.deconv|agg_\d\.conv\.conv)\.bias"
    r"|radar_cma\.encoder_3_1\.(pwconv2\.bias|grn\.beta)"
    r"|radar_dense_head\.(shared_conv|\w+\.conv_0)\.conv\.bias")


def phase_train_f32(torch, dev, yaml_name, cfg, info, batch, steps=2):
    """``steps`` train steps in float32 with TF32 off: the kernel path on the
    card against the plain path on the CPU, from the same weights."""
    from radardistill_tpu_torch.models.detector import batch_to_torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for name, device in (("cpu", "cpu"), ("card", dev)):
        model, step, lr_sched = build_trainer(torch, yaml_name, cfg, info, torch.float32, device)
        trained = lambda: {n: p.detach().cpu().clone()  # noqa: E731
                           for n, p in model.named_parameters() if p.requires_grad}
        b = batch_to_torch(batch, device)
        before = trained()
        t0 = time.perf_counter()
        read = reset_launches()
        losses = [float(step(b)["loss"]) for _ in range(steps)]
        runs[name] = (losses, trained(), read(), time.perf_counter() - t0)
    (l_cpu, p_cpu, _, t_cpu), (l_card, p_card, launches, _) = runs["cpu"], runs["card"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    reach = 2.1 * sum(lr_sched(t) for t in range(steps))
    far = max((p_card[n] - p_cpu[n]).abs().max().item() for n in p_cpu)
    judged = [n for n in p_cpu if not ZERO_GRAD.fullmatch(n)]
    errs = {n: rel_l2(torch, p_card[n], p_cpu[n]) for n in judged}

    def cosine(n):
        a, c = ((p[n] - before[n]).flatten().double() for p in (p_card, p_cpu))
        return (a @ c / (a.norm() * c.norm())).item()

    cos = {n: cosine(n) for n in judged}
    worst, least = max(errs, key=errs.get), min(cos, key=cos.get)
    print(f"train step f32 (TF32 off), grid {info['grid_size'][0]}, {steps} steps: card (kernels, "
          f"launches {launches}) vs CPU (plain, {t_cpu:.1f} s): loss {l_card} vs {l_cpu}, "
          f"rel {loss_err:.3e}; over {len(p_cpu)} trained tensors the largest elementwise "
          f"difference is {far:.3e} (limit {reach:.3e}); over the {len(judged)} with a gradient: "
          f"rel-L2 max {errs[worst]:.3e} ({worst}), least cosine of the updates "
          f"{cos[least]:.4f} ({least})")
    if (not loss_err <= 1e-4 or not far <= reach or not errs[worst] <= 5e-3
            or not cos[least] >= 0.9):
        bad = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
        raise RuntimeError(f"train step f32: loss rel {loss_err}, elementwise {far} (limit "
                           f"{reach}), rel-L2 {bad}, cosine {cos[least]} at {least}")


def p50_ms(torch, fn, runs):
    """p50 of ``runs`` host-clock times of ``fn()`` + synchronize, in ms."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    return (times[(runs - 1) // 2] + times[runs // 2]) / 2 * 1e3


def equal_tree(torch, got, want):
    """Bit-equality of two tables or tuples of tables, after a cast to the
    wider integer type (the host may ship narrower indices)."""
    if isinstance(want, (tuple, list)):
        return len(got) == len(want) and all(equal_tree(torch, g, w) for g, w in zip(got, want))
    if got.dtype != want.dtype:
        got, want = got.long(), want.long()
    return got.shape == want.shape and torch.equal(got, want)


def phase_device_tables(torch, dev, name, cfg, info, host_batch, raw_batch, expect_launches,
                        runs=10):
    """The route with no host tables: the same scenes collated with and without
    ``HostPrecompute`` through one model. Device-built tables bit-equal to the
    host's; float32 outputs of the two routes within 1e-4 rel-L2; bfloat16
    finite, no overflow, the host route's launch counts; p50 of both routes and
    of the device build alone. Returns (launches, device-built tables)."""
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_

    if any(k.startswith("hp_") for k in raw_batch):
        raise RuntimeError(f"{name}: the raw batch carries host tables")
    bh, br = batch_to_torch(host_batch), batch_to_torch(raw_batch)
    model = init_random_(build_network(cfg, info, compute_dtype=torch.float32),
                         torch.Generator().manual_seed(0))
    rkey = "radar_points" if "radar_points" in br else "points"
    vfes = [(model.radar_vfe, rkey, "hp_radar")]
    if model.has_teacher:
        vfes.append((model.vfe, "points", "hp_lidar"))

    def build():
        built = {}
        for vfe, key, hp in vfes:
            built[hp] = vfe.sort_and_compact(br[key], br[f"{key}_mask"])[1]
        built["hp_as"] = model.radar_backbone_3d.build_tables(built["hp_radar"]["uids"])
        return built

    with torch.no_grad():
        built = build()
        torch.cuda.synchronize()
        checked = []
        for _, _, hp in vfes:
            for k in ("uids", "slot", "count"):
                if not equal_tree(torch, built[hp][k], bh[hp][k]):
                    raise RuntimeError(f"{name}: device-built {hp}.{k} differs from the host's")
                checked.append(f"{hp}.{k}")
        if set(built["hp_as"]) != set(bh["hp_as"]):
            raise RuntimeError(f"{name}: device tables {sorted(built['hp_as'])}, host tables "
                               f"{sorted(bh['hp_as'])}")
        for k, want in bh["hp_as"].items():
            if not equal_tree(torch, built["hp_as"][k], want):
                raise RuntimeError(f"{name}: device-built hp_as.{k} differs from the host's")
            checked.append(k)
        build_ms = p50_ms(torch, build, runs)
        print(f"{name} device-built tables bit-equal to the host's: {', '.join(checked)}; the "
              f"build alone p50 {build_ms:.3f} ms over {runs} synced runs")

        # float32, TF32 off: the two routes differ only in the cluster means
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        out_h, out_d = model(bh), model(br)
        torch.cuda.synchronize()
        errs = {f"radar_preds.{k}": rel_l2(torch, out_d["radar_preds"][k], v)
                for k, v in out_h["radar_preds"].items()}
        errs["radar_x_conv4"] = rel_l2(torch, out_d["radar_x_conv4"], out_h["radar_x_conv4"])
        print(f"{name} f32 (TF32 off), device route vs host route on the card, rel-L2: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        bad = {k: v for k, v in errs.items() if not v <= 1e-4}
        if bad or int(out_d["as_overflow"]) != int(out_h["as_overflow"]):
            raise RuntimeError(f"{name}: device route vs host route {bad}, as_overflow "
                               f"{int(out_d['as_overflow'])} vs {int(out_h['as_overflow'])}")
        torch.backends.cudnn.allow_tf32 = True
        del out_h, out_d

        model = init_random_(build_network(cfg, info, compute_dtype=torch.bfloat16),
                             torch.Generator().manual_seed(0))
        model(br)  # warm-up
        read = reset_launches()
        out = model(br)
        torch.cuda.synchronize()
        launches = read()
        want = {**dict.fromkeys(launches, 0), **expect_launches}
        fin = out.pop("final_box_dicts")
        if launches != want or not all_finite(torch, out) or int(out["as_overflow"]) != 0 \
                or int(fin["valid"].sum()) == 0:
            raise RuntimeError(f"{name} device route bf16: launches {launches} (want {want}), "
                               f"finite {all_finite(torch, out)}, as_overflow "
                               f"{int(out['as_overflow'])}, {int(fin['valid'].sum())} boxes")
        t_host = p50_ms(torch, lambda: model(bh), runs)
        t_dev = p50_ms(torch, lambda: model(br), runs)
        t_host2 = p50_ms(torch, lambda: model(bh), runs)
        print(f"{name} bf16: launches {launches}, finite, as_overflow 0; forward p50 over {runs} "
              f"synced runs: host tables {t_host:.3f} ms, device-built {t_dev:.3f} ms, host "
              f"tables again {t_host2:.3f} ms")
    return launches, built


def phase_device_train(torch, dev, yaml_name, cfg, info, host_batch, raw_batch):
    """One train step in float32 (TF32 off) through each route from the same
    weights: the losses agree to 1e-4 relative."""
    from radardistill_tpu_torch.models.detector import batch_to_torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    losses = {}
    for route, batch in (("host", host_batch), ("device", raw_batch)):
        model, step, _ = build_trainer(torch, yaml_name, cfg, info, torch.float32, None)
        metrics = step(batch_to_torch(batch))
        torch.cuda.synchronize()
        losses[route] = float(metrics["loss"])
        if int(metrics["as_overflow"]) != 0:
            raise RuntimeError(f"train step, {route} route: as_overflow {metrics['as_overflow']}")
        del model, step
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    rel = abs(losses["device"] - losses["host"]) / abs(losses["host"])
    print(f"train step f32 (TF32 off), 1440², bs2, one step from the same weights: loss "
          f"{losses['device']:.6f} through the device-built tables, {losses['host']:.6f} through "
          f"the host's, rel {rel:.3e} (limit 1e-4)")
    if not rel <= 1e-4 or losses["device"] != losses["device"]:
        raise RuntimeError(f"train step: device route loss {losses['device']} vs host route "
                           f"{losses['host']}")


# the step and the eval forward of the distillation yaml, per call: K1 x 4
# (wgmma), K5 x 2, K2 x 3; the step adds K3 x 3 and K4 x 3 (tile route)
EVAL_FORWARD = {"expand_rows": 2, "dcn_sample": 3, "conv_block": 4, "conv_block.wgmma": 4}
TRAIN_STEP = {**EVAL_FORWARD, "dcn_offset_grad": 3, "dcn_input_grad": 3,
              "dcn_input_grad.tile": 3}


def same_detections(torch, got, want, tol):
    """Equal validity; each valid entry of ``got`` equals the same entry of
    ``want`` (label exactly, box and score within ``tol``) or, where two
    candidates scored within ``tol`` traded places, another unused one
    (the near-tie rule of ``tests/test_torch_slice.py``)."""
    if not torch.equal(got["valid"], want["valid"]):
        return False
    for b in range(want["valid"].shape[0]):
        idx = torch.nonzero(want["valid"][b]).flatten()
        row = lambda d: torch.cat([d["boxes"][b, idx], d["scores"][b, idx, None]],  # noqa: E731
                                  1).double()
        g, w = row(got), row(want)
        gl, wl = got["labels"][b, idx], want["labels"][b, idx]
        used = torch.zeros(len(idx), dtype=torch.bool, device=g.device)
        for i in range(len(idx)):
            ok = (~used & (wl == gl[i]) & ((w - g[i]).abs().amax(1) <= tol)
                  & ((w[:, -1] - w[i, -1]).abs() <= tol))
            if not ok.any():
                return False
            used[i if ok[i] else torch.nonzero(ok)[0, 0]] = True
    return True


def loader_pass(loader):
    """(the batches of one pass, seconds a batch)."""
    t0 = time.perf_counter()
    batches = [b for b, _ in loader]
    return batches, (time.perf_counter() - t0) / len(batches)


def same_numpy_tree(got, want):
    if isinstance(want, dict):
        return sorted(got) == sorted(want) and all(same_numpy_tree(got[k], want[k]) for k in want)
    if isinstance(want, (tuple, list)):
        return len(got) == len(want) and all(same_numpy_tree(g, w) for g, w in zip(got, want))
    return got.dtype == want.dtype and got.shape == want.shape and (got == want).all()


def phase_runtime(torch, dev, smi, step_p50):
    """The runtime around the step at full width, through the functions of
    the CLIs: ``tools/torch_train.py`` on ``production_cert.yaml`` (bs2,
    bf16, 2 workers, a log line a step, ``NUM_SAMPLES`` 6: 3 steps an epoch)
    for one epoch, then again with ``--epochs 2`` (it must resume at epoch 1),
    then ``tools/torch_test.py::eval_ckpt`` over the eval loader with the
    restored model and ``SyntheticDataset.evaluation``. Launch counts over
    the three are steps x the step's + eval batches x the eval forward's;
    every logged loss finite; the restored model and optimizer bit-equal to
    the trained ones; the restored model's detections on one batch equal the
    trained model's. Prints t_iter and t_data p50 over the steps, the
    loader's seconds a batch alone (serial and 2 workers), the checkpoint's
    size and its save and load seconds, eval samples/s, beside ``step_p50``,
    the device-resident step's p50 of phase 10 in the same call. Returns the
    launch counts."""
    import argparse
    import shutil

    from radardistill_tpu_torch.data.loader import build_dataloader
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.train.checkpoint import CheckpointManager
    from radardistill_tpu_torch.train.train_step import create_train_state, make_eval_step
    from radardistill_tpu_torch.train.trainer import read_log
    from tools import torch_test, torch_train

    tag = "chip_smoke_runtime"
    argv = ["--cfg_file", str(ROOT / "tools/cfgs/synthetic/production_cert.yaml"),
            "--batch_size", "2", "--workers", "2", "--log_interval", "1", "--extra_tag", tag,
            "--num_epochs_to_eval", "0", "--set", "DATA_CONFIG.NUM_SAMPLES", "6"]
    _, cfg = torch_train.parse_config(argv)
    out = Path("output") / cfg.TAG / tag
    shutil.rmtree(out, ignore_errors=True)
    t_start = time.perf_counter()

    read = reset_launches()
    trained = torch_train.main(["--epochs", "1"] + argv)
    (log1,) = out.glob("log_train_*.txt")
    time.sleep(1.0)  # the second run's log file is named by the second
    trained = torch_train.main(["--epochs", "2"] + argv)
    log2 = [p for p in out.glob("log_train_*.txt") if p != log1]
    if next(trained.model.parameters()).device != dev:
        raise RuntimeError("runtime: the train CLI did not default to the card")
    first, second = read_log(log1), read_log(log2[0])
    resumed = "resumed from epoch 1 it 3" in log2[0].read_text()
    steps = first + second
    print(f"runtime: train CLI, production_cert.yaml, bs2, bf16, 2 workers: epoch 0 "
          f"{[(r[2], r[4]) for r in first]}; again with --epochs 2: resumed at epoch 1 "
          f"{resumed}, {[(r[0], r[2], r[4]) for r in second]} (epoch, it, loss)")
    if ([r[:4] for r in first] != [(0, 1, i, 3) for i in range(3)]
            or [r[:4] for r in second] != [(1, 2, i, 3) for i in range(3)] or not resumed
            or trained.step != 6):
        raise RuntimeError(f"runtime: logged steps {first} then {second}, resumed {resumed}, "
                           f"{trained.step} updates")
    if not all(r[4] == r[4] and abs(r[4]) != float("inf") for r in steps):
        raise RuntimeError(f"runtime: a logged loss is not finite: {[r[4] for r in steps]}")

    # the checkpoint: a fresh model and optimizer restored bit-equal
    info = {"grid_size": trained.model.grid_size, "voxel_size": trained.model.voxel_size,
            "point_cloud_range": trained.model.point_cloud_range,
            "class_names": tuple(cfg.CLASS_NAMES)}
    fresh, _ = create_train_state(
        build_network(cfg.MODEL, info, compute_dtype=torch.bfloat16), cfg.OPTIMIZATION, 6,
        torch.Generator().manual_seed(1))
    mgr = CheckpointManager(out / "ckpt")
    path = out / "ckpt" / "checkpoint_epoch_2"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = mgr.restore(fresh)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.save(trained, epoch=2)
    t_save = time.perf_counter() - t0
    a, b = fresh.model.state_dict(), trained.model.state_dict()
    differ = [k for k in b if not torch.equal(a[k], b[k])]
    ma, mb = fresh.optimizer.inner.state_dict()["state"], trained.optimizer.inner.state_dict()[
        "state"]
    differ += [f"adam {i}.{k}" for i in mb for k in mb[i] if not torch.equal(ma[i][k], mb[i][k])]
    if (restored is None or restored[1:] != (2, 6) or fresh.step != 6 or differ
            or len(ma) != len(mb)):
        raise RuntimeError(f"runtime: restore {restored and restored[1:]}, count {fresh.step}, "
                           f"differs in {differ[:5]}")
    print(f"runtime: checkpoint {path.stat().st_size / 2**20:.3f} MiB, save {t_save:.3f} s, "
          f"load {t_load:.3f} s; the restored model ({len(b)} tensors) and optimizer "
          f"({len(mb)} parameters' moments, count {fresh.step}) bit-equal to the trained ones")

    # evaluation of the restored model over the eval loader
    test_set, test_loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2,
                                             training=False)
    from radardistill_tpu_torch.utils.common import create_logger

    logger = create_logger()
    t0 = time.perf_counter()
    result = torch_test.eval_ckpt(argparse.Namespace(cal_params=False, infer_time=True), cfg,
                                  fresh, test_set, test_loader, logger, out / "eval", "epoch_2")
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    launches = read()
    n_eval = len(test_loader)
    want = {**dict.fromkeys(launches, 0),
            **{k: 6 * v + n_eval * EVAL_FORWARD.get(k, 0) for k, v in TRAIN_STEP.items()}}
    print(f"runtime launches over 6 steps and {n_eval} eval batches: {launches}")
    if launches != want or not 0 <= result["mAP"] <= 1:
        raise RuntimeError(f"runtime: launches {launches}, expected {want}; result {result}")

    # the restored model's detections equal the trained model's
    batch = batch_to_torch(next(iter(test_loader))[0])
    got = make_eval_step(fresh.model)(batch)["final_box_dicts"]
    ref = make_eval_step(trained.model)(batch)["final_box_dicts"]
    if not same_detections(torch, got, ref, 1e-4) or int(ref["valid"].sum()) == 0:
        raise RuntimeError("runtime: the restored model's detections differ from the trained "
                           "model's")

    # the loader alone: serial, then 2 workers forked with CUDA up; the same
    # batches
    _, ld = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=0,
                             model_cfg=cfg.MODEL)
    by_serial, serial = loader_pass(ld)
    ld.workers = 2
    by_workers, workers = loader_pass(ld)
    if not same_numpy_tree(by_workers, by_serial):
        raise RuntimeError("runtime: the loader's batches with 2 workers differ from serial")
    med = lambda v: sorted(v)[(len(v) - 1) // 2] / 2 + sorted(v)[len(v) // 2] / 2  # noqa: E731
    shutil.rmtree(out, ignore_errors=True)
    t_iter = med([r[5] for r in steps]) * 1e3
    print(f"runtime on {smi}: t_iter p50 {t_iter:.1f} ms, t_data p50 "
          f"{med([r[6] for r in steps]) * 1e3:.1f} ms over the 6 steps (the log's ms; t_iter "
          f"{[r[5] for r in steps]}, t_data {[r[6] for r in steps]} s), the device-resident "
          f"step p50 {step_p50:.3f} ms (phase 10): {t_iter / step_p50:.3f} x; loader alone (the "
          f"same batches both ways), bs2 with HostPrecompute: serial "
          f"{serial:.4f} s/batch, 2 workers {workers:.4f} s/batch; eval {len(test_set)} samples "
          f"({n_eval} batches) in {t_eval:.3f} s: {len(test_set) / t_eval:.3f} samples/s, mAP "
          f"{result['mAP']:.4f}; the phase {time.perf_counter() - t_start:.1f} s")
    return launches


VAL_FORWARD = {"expand_rows": 1, "dcn_sample": 3}


def make_nuscenes_tree(work):
    """The nuScenes-layout tree of phases 26 and 28-30 (module docstring) and
    its GT database. Returns (root, train infos, val infos, database s)."""
    from radardistill_tpu_torch.data.nuscenes.info_gen import create_groundtruth_database
    from tools.torch_nuscenes_tree import make_tree

    root = work / "nuscenes"
    train_infos, val_infos = make_tree(root, 8, 4)
    t0 = time.perf_counter()
    create_groundtruth_database(root, max_sweeps=10)
    return root, train_infos, val_infos, time.perf_counter() - t0


def tree_sets(root):
    """``--set`` arguments that point a shipped yaml at the tree."""
    return ["DATA_CONFIG.DATA_PATH", str(root),
            "DATA_CONFIG.INFO_PATH.train", "[nuscenes_infos_6radar_10sweeps_train.pkl]",
            "DATA_CONFIG.INFO_PATH.test", "[nuscenes_infos_6radar_10sweeps_val.pkl]"]


TEACHER_SCOPES = ("vfe.", "backbone_3d.", "backbone_2d.", "dense_head.")


def phase_nuscenes(torch, dev, smi, tree, step_p50=None, teacher_ckpt=None):
    """Phase 26, nuScenes at full width (module docstring); ``tree`` from
    :func:`make_nuscenes_tree`; ``step_p50``, the device-resident step's p50
    of phase 10 in the same call, to compare t_iter with; ``teacher_ckpt``,
    phase 28's checkpoint, loaded as ``--pretrained_model``, whose every
    teacher entry must load. Returns (launch counts, the val set's
    detections file, the argv of the eval, seconds)."""
    import shutil

    import numpy as np

    from radardistill_tpu_torch.data.loader import build_dataloader
    from radardistill_tpu_torch.train.trainer import read_log
    from tools import torch_test, torch_train

    t_start = time.perf_counter()
    root, train_infos, val_infos, t_db = tree
    tag = "chip_smoke_nuscenes"
    sets = tree_sets(root)
    # one epoch: the hook's last 10 epochs would turn GT sampling off
    train_argv = ["--cfg_file", str(ROOT / "tools/cfgs/radar_distill/radar_distill_train.yaml"),
                  "--batch_size", "2", "--epochs", "1", "--workers", "2", "--log_interval", "1",
                  "--extra_tag", tag, "--num_epochs_to_eval", "0"]
    if teacher_ckpt is not None:
        train_argv += ["--pretrained_model", str(teacher_ckpt)]
    train_argv += ["--set", *sets, "HOOK.DisableAugmentationHook.NUM_LAST_EPOCHS", "0"]
    _, cfg = torch_train.parse_config(train_argv)
    out = Path("output") / cfg.TAG / tag
    eval_out = Path("output") / "radar_distill_val" / tag
    for d in (out, eval_out):
        shutil.rmtree(d, ignore_errors=True)
    test_argv = ["--cfg_file", str(ROOT / "tools/cfgs/radar_distill/radar_distill_val.yaml"),
                 "--batch_size", "1", "--ckpt", str(out / "ckpt" / "checkpoint_epoch_1"),
                 "--infer_time", "--set", *sets]

    read = reset_launches()
    state = torch_train.main(train_argv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = torch_test.main(["--extra_tag", tag] + test_argv)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    launches = read()

    steps = read_log(next(out.glob("log_train_*.txt")))
    n_steps, n_val = len(train_infos) // 2, len(val_infos)
    want = {**dict.fromkeys(launches, 0),
            **{k: n_steps * v + n_val * VAL_FORWARD.get(k, 0) for k, v in TRAIN_STEP.items()}}
    print(f"nuscenes launches over {n_steps} train steps and {n_val} val forwards: {launches}")
    if launches != want:
        raise RuntimeError(f"nuscenes: launches {launches}, expected {want}")
    if next(state.model.parameters()).device != dev or state.step != n_steps:
        raise RuntimeError(f"nuscenes: model on {next(state.model.parameters()).device}, "
                           f"{state.step} updates")
    if len(steps) != n_steps or not all(r[4] == r[4] and abs(r[4]) != float("inf")
                                        for r in steps):
        raise RuntimeError(f"nuscenes: logged steps {steps}")
    if not 0 <= result["mAP"] <= 1:
        raise RuntimeError(f"nuscenes: eval result {result}")
    handoff = ""
    if teacher_ckpt is not None:
        # the recipe's hand-off: every teacher entry of the distillation model
        # came from the checkpoint and, frozen, still equals it
        teacher = [k for k in state.model.state_dict() if k.startswith(TEACHER_SCOPES)]
        src = torch.load(teacher_ckpt, map_location="cpu", weights_only=True)["model_state"]
        now = state.model.state_dict()
        same = sum(torch.equal(now[k].cpu(), src[k]) for k in teacher if k in src)
        if state.loaded != len(teacher) or same != len(teacher):
            raise RuntimeError(f"nuscenes: --pretrained_model loaded {state.loaded} entries and "
                               f"{same} teacher entries equal the file, of {len(teacher)}")
        handoff = (f"; --pretrained_model: all {len(teacher)} teacher entries of the "
                   f"distillation model loaded from the dense teacher's checkpoint and equal to "
                   f"it after training")
    (eval_log,) = eval_out.glob("eval/log_eval_*.txt")
    infer = re.search(r"inference p50: ([\d.]+) ms/batch", eval_log.read_text())
    if "devkit absent" not in eval_log.read_text():
        raise RuntimeError("nuscenes: the eval did not reach the fallback metric")

    # the loader alone over one epoch, and the items' point counts
    ds, ld = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, root_path=str(root),
                              workers=2, training=True, model_cfg=cfg.MODEL)
    _, per_batch = loader_pass(ld)
    np.random.seed(0)
    raw = [len(ds.get_item_raw(i)["points"]) for i in range(len(ds))]
    kept = [len(ds[i]["points"]) for i in range(len(ds))]
    radar = [len(ds.get_item_raw(i)["radar_points"]) for i in range(len(ds))]
    med = lambda v: sorted(v)[(len(v) - 1) // 2] / 2 + sorted(v)[len(v) // 2] / 2  # noqa: E731
    print(f"nuscenes on {smi}: tree of {len(train_infos)} train + {len(val_infos)} val samples, "
          f"GT database {t_db:.2f} s; train CLI on radar_distill_train.yaml, bs2, bf16, 2 "
          f"workers, GT sampling on: losses {[round(r[4], 4) for r in steps]}, t_iter p50 "
          f"{med([r[5] for r in steps]) * 1e3:.1f} ms, t_data p50 "
          f"{med([r[6] for r in steps]) * 1e3:.1f} ms"
          + (f" ({med([r[5] for r in steps]) * 1e3 / step_p50:.3f} x the device-resident step "
             f"p50 {step_p50:.3f} ms)" if step_p50 else "")
          + f"; loader alone {per_batch:.4f} s/batch; "
          f"lidar points a train item: {raw} raw, {kept} in range after augmentation; radar "
          f"returns {radar}; eval CLI on radar_distill_val.yaml, bs1: {n_val} samples in "
          f"{t_eval:.3f} s (CLI start, build and checkpoint load included): "
          f"{n_val / t_eval:.3f} samples/s, inference p50 "
          f"{infer and float(infer[1]):.1f} ms/batch: {1e3 / float(infer[1]):.3f} samples/s, "
          f"mAP {result['mAP']:.4f} (fallback metric){handoff}; the phase "
          f"{time.perf_counter() - t_start:.1f} s")
    result_pkl = eval_out / "eval" / "eval_checkpoint_epoch_1" / "result.pkl"
    return launches, result_pkl, test_argv, time.perf_counter() - t_start


def same_annos(torch, got, want, tol):
    """Two detection lists (``generate_prediction_dicts``' dicts) of the same
    frames, entry by entry under the near-tie rule of ``same_detections``."""
    got = {d["frame_id"]: d for d in got}
    if sorted(got) != sorted(d["frame_id"] for d in want):
        return False
    for w in want:
        g = got[w["frame_id"]]
        if len(g["pred_scores"]) != len(w["pred_scores"]):
            return False
        as_dict = lambda d: {  # noqa: E731
            "boxes": torch.as_tensor(d["pred_boxes"])[None],
            "scores": torch.as_tensor(d["pred_scores"])[None],
            "labels": torch.as_tensor(d["pred_labels"])[None],
            "valid": torch.ones(1, len(d["pred_scores"]), dtype=torch.bool)}
        if not same_detections(torch, as_dict(g), as_dict(w), tol):
            return False
    return True


def phase_ddp(torch, dev, smi, work, result_pkl, test_argv):
    """Phase 27, data-parallel on the card (module docstring). Returns (the
    DDP step's launch counts, seconds)."""
    import os
    import pickle
    from collections import Counter

    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.utils.production import TRAIN_YAML
    from tools import torch_ddp_check as ddp

    t_start = time.perf_counter()
    cfg, info, batch = make_batch(TRAIN_YAML)
    counts = Counter()

    def counted(fn):
        read = reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts.update(read())
        return out

    runs = 10
    one = ddp.world1_nccl(torch, dev, cfg, info, batch, runs, on_step=counted)
    launches = {k: counts[k] for k in reset_launches()()}
    want = {**dict.fromkeys(launches, 0), **{k: (1 + runs) * v for k, v in TRAIN_STEP.items()}}
    if launches != want:
        raise RuntimeError(f"DDP step: launches {launches}, expected {want}")
    print(f"ddp, world size 1 on NCCL, bf16, 1440², bs2, on {smi}: loss {one['loss']:.6f}, "
          f"rel {one['loss_rel']:.3e} from the unwrapped step, worst of {one['params']} "
          f"parameters after one step rel-L2 {one['worst_param_rel_l2']:.3e} (the zero-gradient "
          f"leaves within {one['zero_grad_max_abs']:.3e} of 2.1 lr = {2.1 * one['lr']:.3e}); "
          f"p50 over "
          f"{runs} steps in turns: DDP + synchronized BN {one['ddp_p50_ms']:.3f} ms, unwrapped "
          f"{one['plain_p50_ms']:.3f} ms ({one['ddp_p50_ms'] / one['plain_p50_ms']:.3f} x); "
          f"one BN's all-reduce on the NCCL group (2 x 256 + 1 floats, paid twice a step by "
          f"each train-mode BN at world sizes above 1) {one['allreduce_us']:.1f} us of host "
          f"time; "
          f"launches over its {1 + runs} steps {launches}")
    step = {k: TRAIN_STEP[k] for k in ("expand_rows", "dcn_sample", "conv_block",
                                       "dcn_offset_grad", "dcn_input_grad")}
    two = ddp.two_ranks(torch, dev, cfg, info, batch, work / "ddp", step)
    print(f"ddp, 2 ranks on one card over gloo, f32, bs1 each against bs2 on {smi}: "
          f"sync_bn=True loss {two['loss']:.6f} against {two['loss_one_process']:.6f} (rel "
          f"{two['loss_rel']:.3e}), parameters worst rel-L2 {two['worst_param_rel_l2']:.3e}, "
          f"least update cosine {two['least_update_cos']:.4f}; sync_bn=False loss "
          f"{two['local_loss']:.6f}, its {two['stats']} running statistics within rel-L2 "
          f"{two['stats_rel_l2']:.3e} of the mean of the ranks' local updates; the ranks "
          f"{two['ranks_s']:.1f} s")
    del batch
    torch.cuda.empty_cache()

    # a 2-rank eval through tools/torch_test.py against the 1-process one
    port = ddp.free_port()
    t0 = time.perf_counter()
    tag = "chip_smoke_nuscenes_2ranks"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tools/torch_test.py"), "--extra_tag", tag, *test_argv],
        env=dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"2-rank eval, rank {r} failed:\n{outs[r][-4000:]}")
    t_eval = time.perf_counter() - t0
    got = pickle.loads((Path("output") / "radar_distill_val" / tag / "eval"
                        / "eval_checkpoint_epoch_1" / "result.pkl").read_bytes())
    want = pickle.loads(result_pkl.read_bytes())
    if len(got) != len(want) or not same_annos(torch, got, want, 1e-4):
        raise RuntimeError("2-rank eval: the merged detections differ from the 1-process eval's")
    print(f"ddp: tools/torch_test.py on 2 ranks (gloo, one card) over the {len(want)} val "
          f"samples: merged detections ({sum(len(d['pred_scores']) for d in got)} boxes, rank "
          f"order {[d['frame_id'] for d in got]}) equal the 1-process eval's entry by entry; "
          f"{t_eval:.1f} s with the processes' start; the phase "
          f"{time.perf_counter() - t_start:.1f} s")
    return launches, time.perf_counter() - t_start


TEACHER_YAML = ROOT / "tools/cfgs/nuscenes_models/pillarnet.yaml"
RADAR_YAML = ROOT / "tools/cfgs/nuscenes_models/pillarnet_radar.yaml"
# the dense-input paths' launches: the dense VFE's densify (K5) in every
# forward; the radar baseline's CMA adds K2 x 3, and K3 x 3, K4 x 3 (tile
# route) in its backward
DENSE_TEACHER = {"expand_rows": 1}
RADAR_BASELINE_FORWARD = {"expand_rows": 1, "dcn_sample": 3}
RADAR_BASELINE_STEP = {**RADAR_BASELINE_FORWARD, "dcn_offset_grad": 3, "dcn_input_grad": 3,
                       "dcn_input_grad.tile": 3}


def phase_k5_dense(torch, dev):
    """Phase 31: K5 at the dense VFE's shapes, bs4 LiDAR (a table of one row
    per point, 180 000 + 1 rows of 32 bfloat16 a sample) and bs8 radar (8192 +
    1 rows), each onto the 1440² grid. Returns one record per shape."""
    from radardistill_tpu_torch.ops.active_site import site_index_grid

    gen = torch.Generator().manual_seed(31)
    hw, recs = 1440 * 1440, {}
    for name, b, cap, n_active in (("teacher_bs4", 4, 180000, 100000),
                                   ("radar_bs8", 8, 8192, 3000)):
        uids = torch.full((b, cap), hw, dtype=torch.int32)
        for i in range(b):
            uids[i, :n_active] = torch.sort(
                torch.randperm(hw, generator=gen)[:n_active]).values.to(torch.int32)
        inv = site_index_grid(uids, hw, cap)
        flat = (inv + (torch.arange(b, dtype=torch.int32) * (cap + 1))[:, None]).reshape(-1)
        table = torch.randn(b, cap + 1, 32, generator=gen).to(dev, torch.bfloat16)
        table[:, cap] = 0
        rec = check_expand(torch, f"dense VFE {name} ({n_active} pillars a sample)",
                           table.reshape(-1, 32), flat.to(dev), iters=20)
        recs[name] = bound_of(dict(rec, ops_ms=0.0))
        del table, flat
        torch.cuda.empty_cache()
    return recs


def resident_step(torch, dev, state, cfg, batch_size, runs=5):
    """(p50 ms, peak GiB) of the train step on one device-resident batch of
    the yaml's train loader, with the CLI's trained model and optimizer."""
    from radardistill_tpu_torch.data.loader import build_dataloader
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.train.train_step import make_train_step

    ds, ld = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                              root_path=cfg.DATA_CONFIG.DATA_PATH, workers=0, training=True,
                              model_cfg=cfg.MODEL)
    batch, _ = next(iter(ld))
    bdev = batch_to_torch(batch, dev)
    step = make_train_step(state.model, state.optimizer, cfg.MODEL, tuple(cfg.CLASS_NAMES),
                           tuple(ds.voxel_size), tuple(ds.point_cloud_range))
    torch.cuda.reset_peak_memory_stats()
    step(bdev)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        step(bdev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return (times[(runs - 1) // 2] + times[runs // 2]) / 2, \
        torch.cuda.max_memory_allocated() / 2**30


def phase_dense_cli(torch, dev, smi, tree, name, yaml, batch_size, epochs, step_launches,
                    forward_launches, evaluate, train_extra=(), extra_sets=()):
    """Phases 28, 29 and 33: ``tools/torch_train.py`` on ``yaml`` over the tree
    at full width (``extra_sets``: more ``--set`` pairs), then
    ``evaluate(ckpt, tag, sets)`` (an eval CLI) over its val samples, the
    counts reset before the one and read after the other; then the resident
    step. Returns (launches, state, cfg, checkpoint, the train log's text, a
    line of numbers, the resident step's (p50 ms, peak GiB))."""
    import shutil

    from radardistill_tpu_torch.train.trainer import read_log
    from tools import torch_train

    root, train_infos, val_infos, _ = tree
    tag = f"chip_smoke_{name}"
    sets = tree_sets(root) + list(extra_sets)
    train_argv = ["--cfg_file", str(yaml), "--batch_size", str(batch_size), "--epochs",
                  str(epochs), "--workers", "2", "--log_interval", "1", "--extra_tag", tag,
                  "--num_epochs_to_eval", "0", *train_extra, "--set", *sets]
    _, cfg = torch_train.parse_config(train_argv)
    out = Path("output") / cfg.TAG / tag
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    read = reset_launches()
    state = torch_train.main(train_argv)
    torch.cuda.synchronize()
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    ckpt = out / "ckpt" / f"checkpoint_epoch_{epochs}"
    t0 = time.perf_counter()
    result = evaluate(ckpt, tag, sets)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    launches = read()

    n_steps, n_val = len(train_infos) // batch_size * epochs, len(val_infos)
    want = {**dict.fromkeys(launches, 0),
            **{k: n_steps * step_launches.get(k, 0) + n_val * forward_launches.get(k, 0)
               for k in {**step_launches, **forward_launches}}}
    print(f"{name} launches over {n_steps} train steps and {n_val} val forwards: {launches}")
    if launches != want:
        raise RuntimeError(f"{name}: launches {launches}, expected {want}")
    (log,) = out.glob("log_train_*.txt")
    steps = read_log(log)
    if next(state.model.parameters()).device != dev or state.step != n_steps:
        raise RuntimeError(f"{name}: model on {next(state.model.parameters()).device}, "
                           f"{state.step} updates")
    if len(steps) != n_steps or not all(r[4] == r[4] and abs(r[4]) != float("inf")
                                        for r in steps):
        raise RuntimeError(f"{name}: logged steps {steps}")
    (eval_log,) = out.glob("eval/log_eval_*.txt")
    text = eval_log.read_text()
    if not 0 <= result["mAP"] <= 1 or "devkit absent" not in text:
        raise RuntimeError(f"{name}: eval result {result}")
    infer = float(re.search(r"inference p50: ([\d.]+) ms/batch", text)[1])
    if cfg.DATA_CONFIG.CAPACITIES.get("MAX_LIDAR_POINTS", 180000) != 180000 or \
            tuple(state.model.grid_size) != (1440, 1440):
        raise RuntimeError(f"{name}: not at full width")
    med = lambda v: sorted(v)[(len(v) - 1) // 2] / 2 + sorted(v)[len(v) // 2] / 2  # noqa: E731
    t_iter, t_data = med([r[5] for r in steps]) * 1e3, med([r[6] for r in steps]) * 1e3
    p50, peak_step = resident_step(torch, dev, state, cfg, batch_size)
    numbers = (f"{yaml.name}, bs{batch_size}, 1440², bf16, {n_steps} steps: losses "
               f"{[round(r[4], 4) for r in steps]}, t_iter p50 {t_iter:.1f} ms, t_data p50 "
               f"{t_data:.1f} ms (steps' t_iter {[round(r[5] * 1e3, 1) for r in steps]} ms, "
               f"t_data {[round(r[6] * 1e3, 1) for r in steps]} ms); the resident step p50 "
               f"{p50:.3f} ms ({batch_size / p50 * 1e3:.3f} "
               f"samples/s), peak {peak_step:.2f} GiB (the CLI's train {peak_train:.2f} GiB); "
               f"eval CLI bs1: {n_val} samples in {t_eval:.3f} s, inference p50 {infer:.1f} "
               f"ms/batch, mAP {result['mAP']:.4f} (fallback metric), on {smi}")
    return launches, state, cfg, ckpt, log.read_text(), numbers, (p50, peak_step)


def phase_teacher_pretrain(torch, dev, smi, tree):
    """Phase 28: stage 1 of the recipe, the LiDAR teacher trained on its own
    (module docstring). Returns (launches, its checkpoint, seconds, the
    resident step's (p50 ms, peak GiB))."""
    from tools import torch_test_teacher

    t_start = time.perf_counter()

    def evaluate(ckpt, tag, sets):
        return torch_test_teacher.main(["--teacher_ckpt", str(ckpt), "--extra_tag", tag,
                                        "--infer_time", "--set", *sets])

    launches, state, cfg, ckpt, _, numbers, resident = phase_dense_cli(
        torch, dev, smi, tree, "teacher", TEACHER_YAML, 4, 1, DENSE_TEACHER, DENSE_TEACHER,
        evaluate)
    moved, backbone, kernels = backbone_moved(torch, dev, state, cfg)
    print(f"teacher pretraining: {numbers}; backbone_3d: {moved} of {backbone} "
          f"parameters moved, all {kernels} kernels among them; the phase "
          f"{time.perf_counter() - t_start:.1f} s")
    return launches, ckpt, time.perf_counter() - t_start, resident


def backbone_moved(torch, dev, state, cfg):
    """(moved, parameters, kernels) of the CLI-trained teacher's
    ``backbone_3d``, against the CLI's initial draw (seed 666); raises unless
    every kernel moved and every parameter trains."""
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.train.train_step import create_train_state

    m = state.model
    info = {"grid_size": m.grid_size, "voxel_size": m.voxel_size,
            "point_cloud_range": m.point_cloud_range, "class_names": tuple(cfg.CLASS_NAMES)}
    init, _ = create_train_state(build_network(cfg.MODEL, info, torch.bfloat16, device=dev),
                                 cfg.OPTIMIZATION, 1, torch.Generator().manual_seed(666))
    before = dict(init.model.named_parameters())
    backbone = [(n, p) for n, p in m.named_parameters() if n.startswith("backbone_3d.")]
    moved = [n for n, p in backbone if not torch.equal(p, before[n])]
    kernels = [n for n, p in backbone if p.dim() >= 2]
    if not set(kernels) <= set(moved) or not all(p.requires_grad for _, p in backbone):
        raise RuntimeError(f"teacher: backbone_3d kernels unmoved "
                           f"{sorted(set(kernels) - set(moved))[:5]}")
    return len(moved), len(backbone), len(kernels)


def phase_radar_baseline(torch, dev, smi, tree, teacher_ckpt):
    """Phase 29: the radar-only baseline, initialized from the teacher
    (module docstring). Returns (launches, seconds)."""
    from tools import torch_test

    t_start = time.perf_counter()

    def evaluate(ckpt, tag, sets):
        return torch_test.main(["--cfg_file", str(RADAR_YAML), "--batch_size", "1", "--ckpt",
                                str(ckpt), "--extra_tag", tag, "--infer_time", "--set", *sets])

    launches, state, _, _, log, numbers, _ = phase_dense_cli(
        torch, dev, smi, tree, "radar_baseline", RADAR_YAML, 8, 2, RADAR_BASELINE_STEP,
        RADAR_BASELINE_FORWARD, evaluate, ("--init_from_teacher", str(teacher_ckpt)))
    # --init_from_teacher: every radar parameter with a teacher twin of its
    # shape, which is all of the backbone, neck and head and the VFE but its
    # first linear (6 radar features against 5)
    names = [n for n, _ in state.model.named_parameters()]
    want = [n for n in names if n.startswith(("radar_backbone_3d.", "radar_neck.",
                                              "radar_dense_head.", "radar_vfe."))
            and n != "radar_vfe.pfn_0.linear.weight"]
    got = re.search(r"duplicated teacher weights into radar branch \((\d+) parameters\)", log)
    if got is None or int(got[1]) != len(want):
        raise RuntimeError(f"radar baseline: --init_from_teacher copied "
                           f"{got and got[1]} parameters, expected {len(want)}")
    print(f"radar baseline: {numbers}; --init_from_teacher copied {len(want)} parameters "
          f"(backbone, neck, head, VFE but its first linear); the phase "
          f"{time.perf_counter() - t_start:.1f} s")
    return launches, time.perf_counter() - t_start


def phase_teacher_handoff(torch, dev, smi, teacher_ckpt):
    """Phase 30: the teacher's checkpoint in both teachers at float32 (TF32
    off): the dense one of ``pillarnet.yaml`` and the table-input S2D one of
    ``radar_distill_train.yaml`` with ``INT8: False`` (beside its random
    student), each loading every teacher entry; their ``x_conv4`` /
    ``x_conv5`` on the distillation batch within 1e-4 rel-L2."""
    from radardistill_tpu_torch.config import ConfigDict, cfg_from_yaml_file
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_
    from radardistill_tpu_torch.train.checkpoint import CheckpointManager
    from radardistill_tpu_torch.train.train_step import TrainState
    from radardistill_tpu_torch.utils.production import TRAIN_YAML

    s2d_cfg, info, batch = make_batch(TRAIN_YAML, backbone_3d={"INT8": False})
    dense = ConfigDict()
    cfg_from_yaml_file(str(TEACHER_YAML), dense)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    feats, loaded = {}, {}
    for name, mcfg in (("dense", dense.MODEL), ("s2d", s2d_cfg)):
        model = build_network(mcfg, info, compute_dtype=torch.float32, device=dev)
        if name == "s2d":  # the student beside it: random, not compared
            init_random_(model, torch.Generator().manual_seed(30))
        state = TrainState(model, None)  # no optimizer: the teacher comes from the file
        CheckpointManager(teacher_ckpt.parent).load_params_from_file(state, teacher_ckpt)
        teacher = [k for k in model.state_dict() if k.startswith(TEACHER_SCOPES)]
        loaded[name] = (state.loaded, len(teacher))
        with torch.no_grad():
            out = model.eval()(batch_to_torch(batch, dev))
        feats[name] = {k: out[k].float() for k in ("x_conv4", "x_conv5")}
        del model, state, out
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    rel = {k: rel_l2(torch, feats["s2d"][k], feats["dense"][k]) for k in feats["dense"]}
    print(f"teacher hand-off, f32 at 1440², bs2, TF32 off: entries loaded (of the teacher's) "
          f"{loaded}; S2D teacher vs dense teacher rel-L2 {rel}")
    if any(n != total for n, total in loaded.values()) or not all(v <= 1e-4 for v in rel.values()):
        raise RuntimeError(f"teacher hand-off: loaded {loaded}, rel-L2 {rel}")
    torch.cuda.empty_cache()


def phase_other_dense_topologies(torch, dev, smi):
    """Phase 32: the two other topologies of the dense-input route on the
    card, one bf16 eval forward each from ``build_network`` with the reference's
    initializers drawn from a seed:
    ``synthetic/smoke.yaml`` (a dense teacher beside a dense radar branch) at
    its own range (grid 256), and ``pillarnet.yaml`` with an ``_AS`` teacher
    backbone at 1440² (bs2, 160 000 lidar points a scene, its pillar and tap
    tables from ``HostPrecompute``). Outputs finite, no site over a capacity."""
    from radardistill_tpu_torch.config import ConfigDict, cfg_from_yaml_file
    from radardistill_tpu_torch.data.collate import collate_batch
    from radardistill_tpu_torch.data.host_precompute import HostPrecompute
    from radardistill_tpu_torch.data.synthetic import make_scene
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch

    smoke, teacher = ConfigDict(), ConfigDict()
    cfg_from_yaml_file(str(ROOT / "tools/cfgs/synthetic/smoke.yaml"), smoke)
    cfg_from_yaml_file(str(TEACHER_YAML), teacher)
    teacher.MODEL.BACKBONE_3D = ConfigDict(NAME="PillarRes18BackBone8x_AS",
                                           MAX_ACTIVE=[262144, 196608, 131072, 65536],
                                           DENSE_FROM=3)
    cases = (("smoke.yaml", smoke, 3000, 300, 4096), ("pillarnet.yaml _AS teacher", teacher,
                                                      160000, 0, 160000))
    for name, full, n_lidar, n_radar, cap in cases:
        pc = [float(v) for v in full.DATA_CONFIG.POINT_CLOUD_RANGE]
        info = {"grid_size": (round((pc[3] - pc[0]) / 0.075),) * 2,
                "voxel_size": (0.075, 0.075, 0.2), "point_cloud_range": tuple(pc),
                "class_names": tuple(full.CLASS_NAMES)}
        scenes = [make_scene(i, num_lidar=n_lidar, num_radar=max(n_radar, 1), num_boxes=20,
                             pc_range=pc) for i in range(2)]
        batch = collate_batch(scenes, {"MAX_LIDAR_POINTS": cap, "MAX_RADAR_POINTS": 512,
                                       "NUM_MAX_OBJS": 64})
        batch.pop("_host", None)
        batch = HostPrecompute(full.MODEL, info["grid_size"], info["voxel_size"],
                               info["point_cloud_range"])(batch)
        model = build_network(full.MODEL, info, compute_dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(32))
        read = reset_launches()
        with torch.no_grad():
            out = model(batch_to_torch(batch))
        torch.cuda.synchronize()
        launches = {k: v for k, v in read().items() if v}
        if not all_finite(torch, out) or int(out.get("as_overflow", 0)) != 0:
            raise RuntimeError(f"{name}: finite {all_finite(torch, out)}, as_overflow "
                               f"{int(out.get('as_overflow', 0))}")
        print(f"{name}, bs2, grid {info['grid_size'][0]}, bf16 eval forward on {smi}: "
              f"{type(model.backbone_3d).__name__} teacher"
              + (f" beside {type(model.radar_backbone_3d).__name__}" if model.has_radar else "")
              + f", outputs finite, launches {launches}, "
              f"{int(out['final_box_dicts']['valid'].sum())} boxes")
        del model, out
    torch.cuda.empty_cache()


# ----------------------------------------------- phases 33-38: the S2D teacher

S2D_SETS = ("MODEL.BACKBONE_3D.NAME", "PillarRes18BackBone8x_S2D")
# INT8: static eval of the distillation forward on each input route of the
# S2D teacher (make_batch's BACKBONE_3D overrides), and its launches: the
# dense VFE's densify or the teacher's packed densify (K5 x 1) beside the
# student's (K5 x 1, K2 x 3); K1 at the four stage-1 links, and under _S2D2
# at the four packed stage-2 links as well
S2D_ROUTES = {
    "TABLE_INPUT: false": ({"TABLE_INPUT": False}, K1_STAGE1),
    "PACKED_TABLE: false": ({"PACKED_TABLE": False}, K1_STAGE1),
    "_S2D2": ({"NAME": "PillarRes18BackBone8x_S2D2"},
              {"conv_block": 8, "conv_block.wgmma": 8, "conv_block.mma_sync": 0}),
}
# overfit_check steps at grid 256 on the card: the reference's default 600.
# On an H100 a 300-step run (its one-cycle schedule over 300 steps) brought the
# loss from 891.3 to 0.939 but the scene's AP only to 0.188; 600 steps read
# 1.000 (0.2 s a step, host-bound)
OVERFIT_STEPS = 600


def phase_s2d_pretrain(torch, dev, smi, tree, dense_resident):
    """Phase 33: the space-to-depth teacher trained on its own through the
    CLIs, ``pillarnet.yaml`` with ``--set MODEL.BACKBONE_3D.NAME
    PillarRes18BackBone8x_S2D`` (the dense VFE's grid into the S2D backbone),
    as phase 28 trains the dense one. Returns (launches, checkpoint, seconds,
    the trained backbone's ``state_dict`` on the host)."""
    from radardistill_tpu_torch.models.backbone_s2d import PillarRes18BackBone8xS2D
    from tools import torch_test_teacher

    t_start = time.perf_counter()

    def evaluate(ckpt, tag, sets):
        return torch_test_teacher.main(["--teacher_ckpt", str(ckpt), "--extra_tag", tag,
                                        "--infer_time", "--set", *sets])

    launches, state, cfg, ckpt, _, numbers, (p50, peak) = phase_dense_cli(
        torch, dev, smi, tree, "s2d_teacher", TEACHER_YAML, 4, 1, DENSE_TEACHER, DENSE_TEACHER,
        evaluate, extra_sets=S2D_SETS)
    bb = state.model.backbone_3d
    if not isinstance(bb, PillarRes18BackBone8xS2D) or bb.table_input:
        raise RuntimeError(f"S2D teacher: the CLI built {type(bb).__name__}")
    moved, backbone, kernels = backbone_moved(torch, dev, state, cfg)
    print(f"S2D teacher pretraining: {numbers}; backbone_3d: {moved} of {backbone} parameters "
          f"moved, all {kernels} kernels among them; resident step p50 {p50:.3f} ms, peak "
          f"{peak:.2f} GiB against the dense teacher's {dense_resident[0]:.3f} ms, "
          f"{dense_resident[1]:.2f} GiB (phase 28, this run); the phase "
          f"{time.perf_counter() - t_start:.1f} s")
    weights = {k: v.detach().float().cpu() for k, v in bb.state_dict().items()}
    return launches, ckpt, time.perf_counter() - t_start, weights


def phase_s2d_dense_step(torch, dev, smi, weights):
    """Phase 34: one float32 train step (TF32 off) of the S2D backbone on the
    dense VFE's route and one of the dense ``PillarRes18BackBone8x``, from the
    same weights (phase 33's trained backbone) and one batch: the occupancy
    of the distillation batch's two scenes at 1440² under seeded features.
    The loss is a fixed weighted sum of x_conv1..5. Outputs within 1e-5 rel-L2
    of each other, every running statistic within 1e-5 of the largest. The
    gradients of the input and of the parameters (one vector) part by float32
    summation order through twenty train-mode BatchNorms, so their distance is
    held to what the order alone makes of it: the dense step once more with
    cuDNN off (PyTorch's own convolutions, another order of the same sums);
    the S2D step's gradient may be at most 3 x as far from the dense one's as
    that run's is, plus 1e-6. A conv bias that feeds a train-mode BatchNorm
    has a true gradient of zero, rounding noise on every side, held to 1e-5 of
    the largest gradient element. Returns (outputs' rel-L2, the gradient's
    rel-L2 to the dense step, that of the dense step without cuDNN)."""
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models.backbone_s2d import PillarRes18BackBone8xS2D
    from radardistill_tpu_torch.models.backbone_sparse2d import PillarRes18BackBone8x
    from radardistill_tpu_torch.utils.production import TRAIN_YAML

    _, _, batch = make_batch(TRAIN_YAML)
    g, hw = 1440, 1440 * 1440
    uids = torch.from_numpy(batch["hp_lidar"]["uids"]).long()
    mask = torch.zeros(2 * hw, dtype=torch.bool)
    mask[(uids + torch.arange(2)[:, None] * hw)[uids < hw]] = True
    mask = mask.view(2, g, g).to(dev)
    gen = torch.Generator().manual_seed(34)
    bev = (torch.rand(2, g, g, 32, generator=gen) * 2.0).to(dev) * mask[..., None]
    keys = ("x_conv1", "x_conv2", "x_conv3", "x_conv4", "x_conv5")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.enabled)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    runs, cot = {}, None
    for name, model in (
            ("s2d", PillarRes18BackBone8xS2D((g, g), table_input=False, unpack_outputs=True)),
            ("dense", PillarRes18BackBone8x()), ("dense_no_cudnn", PillarRes18BackBone8x())):
        torch.backends.cudnn.enabled = name != "dense_no_cudnn"
        model.load_state_dict(weights)
        model = model.to(dev).train()
        x = bev.clone().requires_grad_()
        out = model(x, mask)
        if cot is None:
            cot = {k: torch.randn(out[k].shape, generator=gen).to(dev) for k in keys}
        sum((out[k] * cot[k]).sum() for k in keys).backward()
        runs[name] = ({k: out[k].detach() for k in keys}, x.grad,
                      {n: p.grad for n, p in model.named_parameters()},
                      {n: b for n, b in model.named_buffers() if "running_" in n})
        del model, out, x
        torch.cuda.empty_cache()
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.enabled) = saved
    (so, sx, sg, ss), (do, dx, dg, ds), (_, nx, ng, _) = (runs[k] for k in (
        "s2d", "dense", "dense_no_cudnn"))
    out_err = {k: rel_l2(torch, so[k], do[k]) for k in keys}
    stat_err = max(float((ss[n] - ds[n]).abs().max() / ds[n].abs().max()) for n in ds)
    top = max(float(v.abs().max()) for v in dg.values())
    zero = {n for n in dg if re.fullmatch(r"conv\d_\d\.conv[12]\.conv\.bias", n)}
    live = [n for n in dg if n not in zero]

    def flat(x, grads):
        return torch.cat([x.reshape(-1)] + [grads[n].reshape(-1) for n in live])

    ref = flat(dx, dg)
    err = {k: rel_l2(torch, flat(x, gr), ref) for k, (x, gr) in (("s2d", (sx, sg)),
                                                                 ("no_cudnn", (nx, ng)))}
    leaf = {k: max(rel_l2(torch, gr[n], dg[n]) for n in live)
            for k, gr in (("s2d", sg), ("no_cudnn", ng))}
    zero_max = max(max(float(sg[n].abs().max()), float(dg[n].abs().max())) for n in zero) / top
    print(f"S2D vs dense backbone, one f32 train step (TF32 off), 1440², bs2, "
          f"{int(mask.sum())} occupied pillars, on {smi}: outputs rel-L2 "
          + ", ".join(f"{k} {v:.2e}" for k, v in out_err.items())
          + f"; running statistics max rel {stat_err:.2e} over {len(ds)}; gradient (input and "
          f"{len(live)} parameters) rel-L2 to the dense step's: S2D {err['s2d']:.2e}, the "
          f"dense step without cuDNN {err['no_cudnn']:.2e} (worst leaf {leaf['s2d']:.2e} / "
          f"{leaf['no_cudnn']:.2e}); the {len(zero)} zero-true-gradient biases at most "
          f"{zero_max:.2e} of the largest gradient element")
    if not (max(out_err.values()) <= 1e-5 and stat_err <= 1e-5 and zero_max <= 1e-5
            and err["s2d"] <= 3 * err["no_cudnn"] + 1e-6):
        raise RuntimeError("S2D vs dense train step: outside the stated bounds")
    torch.cuda.empty_cache()
    return max(out_err.values()), err["s2d"], err["no_cudnn"]


def phase_s2d_routes(torch, dev, small):
    """Phase 36: ``INT8: static`` eval on each input route of the S2D teacher
    (``S2D_ROUTES``): the distillation forward in bf16 at 1440², bs2, with its
    launch counts, finite outputs, p50 of 3 runs; then in float32 at grid 512
    on the card against the CPU (teacher <= 1e-3, ``radar_preds`` <= 1e-4).
    Returns each route's launches."""
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.utils.production import TRAIN_YAML

    launches = {}
    teacher = ("x_conv4", "x_conv5", "spatial_features_2d", "spatial_features_2d_8x",
               "lidar_preds")
    for name, (over, k1) in S2D_ROUTES.items():
        cfg, info, batch = make_batch(TRAIN_YAML, backbone_3d=over)
        launches[name] = phase_forward_bf16(
            torch, dev, f"distillation forward {name}", cfg, info, batch,
            {"expand_rows": 2, "dcn_sample": 3, **k1}, 3)
        del batch
        torch.cuda.empty_cache()
        cfg, info, batch = make_batch(TRAIN_YAML, backbone_3d=over, **small)
        phase_forward_f32(torch, dev, f"distillation forward {name}", cfg, info, batch,
                          {**{k: 1e-3 for k in teacher}, "radar_preds": 1e-4})
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    return launches


def phase_k1_s2d2(torch, dev):
    """Phase 37: K1 at the ``_S2D2`` packed stage-2 links, x (2, 360, 360, 256)
    int8, kernel (3, 3, 256, 256), 4 mask phases (64 channels a phase), a
    chain's first link (zero 0, no residual) and a later one (zero 127, with
    residual), on the route the dispatch gives it (``wgmma``): every int8 code
    equal to the plain version; the wrapper, the bare launch and the plain
    version timed. Returns the sums over the four links of a forward."""
    from radardistill_tpu_torch.ops import conv3x3_wgmma
    from radardistill_tpu_torch.ops.conv_block import (conv_block, conv_block_plain,
                                                       int8_block_conv_v2, link_constants,
                                                       route_of, tap_sums)

    rec = {"max_abs_err": 0.0, "ms": 0.0, "launch_ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0,
           "ops_ms": 0.0}
    gen = torch.Generator().manual_seed(36)
    route = route_of(3, 256, 256, 4, torch.int8)
    if route != "wgmma":
        raise RuntimeError(f"K1: the packed stage-2 link is dispatched to {route}")
    for zero, with_res in ((0.0, False), (127.0, True)):
        link = int8_link(torch, dev, gen, 2, 360, 360, 256, 256, 3, 4, zero, with_res)
        run = lambda block: int8_block_conv_v2(block=block, **link)  # noqa: E731
        read = reset_launches()
        got = run(conv_block)[0]
        routes = read()
        want = run(conv_block_plain)[0]
        torch.cuda.synchronize()
        if routes["conv_block.wgmma"] != 1:
            raise RuntimeError(f"K1 packed stage 2: ran on {routes}")
        diff = (got.int() - want.int()).abs()
        n_bad, err = int((diff != 0).sum()), int(diff.max())
        spread = [int((want == v).sum()) for v in (-127, 127)]
        xq, kq, res = link["xc"][0], link["kq"], link["res"]
        ab = link_constants(link["xc"], kq, link["sw"], link["bias"], link["gt"], link["sh"],
                            link["bound"], res)[0]
        wk, wsum, out = conv3x3_wgmma.wgmma_taps(kq), tap_sums(kq), torch.empty_like(got)
        alone = lambda: conv3x3_wgmma.launch_link(  # noqa: E731
            xq, wk, ab, link["mask_c"], None if res is None else res[0], wsum, out, -int(zero))
        alone()
        torch.cuda.synchronize()
        if not torch.equal(out, got):
            raise RuntimeError("K1 packed stage 2: the bare launch differs from the wrapper")
        bound_ops, bound_bytes = int8_link_bound(link)
        ms, plain_ms = paired_ms(torch, lambda: run(conv_block), lambda: run(conv_block_plain),
                                 iters=20, plain_iters=2)
        launch_ms = (cuda_ms(torch, alone, 20) + cuda_ms(torch, alone, 20)) / 2
        print(f"K1 conv_block (wgmma) packed stage 2 x {tuple(xq.shape)} k {tuple(kq.shape)} "
              f"nph 4 zero {zero:.0f} res {res is not None}: {n_bad} of {got.numel()} codes "
              f"differ from plain (max {err}); codes at -127/127: {spread}; wrapper {ms:.4f} "
              f"ms, launch alone {launch_ms:.4f} ms "
              f"({bound_ops * PEAK_INT8_OPS / 1e12 / launch_ms:.1f} TOP/s), plain "
              f"{plain_ms:.4f} ms, bound {max(bound_ops, bound_bytes):.4f} ms (operations "
              f"{bound_ops:.4f}, bytes {bound_bytes:.4f})")
        if n_bad:
            raise RuntimeError(f"K1 packed stage 2: {n_bad} codes differ from plain")
        rec["max_abs_err"] = max(rec["max_abs_err"], float(err))
        for key, v in (("ms", ms), ("launch_ms", launch_ms), ("plain_ms", plain_ms),
                       ("bytes_ms", bound_bytes), ("ops_ms", bound_ops)):
            rec[key] += 2 * v  # two links of each kind in a forward
        del link, got, want, out
    torch.cuda.empty_cache()
    return bound_of(dict(rec, library_ms=None))


def phase_k5_packed(torch, dev):
    """Phase 37, K5: the two packed densifies of the S2D teacher, the
    linear-order table's (``densify_packed_batch``) and the packed-order one's
    (``densify_packed_direct_batch``), at the teacher's 163 840-row table,
    bs2, 1440², 150 000 occupied pillars a scene: a float32 table with its
    backward (the row gather of the cotangent), and the int8 table of the
    static route; every output and gradient bit-equal to the same function
    on the CPU (plain versions), one K5 launch a densify. Times: the forward
    and the backward on the card."""
    from radardistill_tpu_torch.ops import active_site as asx

    gen = torch.Generator().manual_seed(37)
    g, hw, cap, n = 1440, 1440 * 1440, 163840, 150000
    lin = torch.full((2, cap), hw, dtype=torch.int32)
    for i in range(2):
        lin[i, :n] = torch.sort(torch.randperm(hw, generator=gen)[:n]).values.to(torch.int32)
    addr = asx.packed_addr(lin, g, g)
    packed = torch.gather(lin, 1, torch.argsort(addr, dim=1))
    table = torch.randn(2, cap, 32, generator=gen) * (lin < hw)[..., None]
    recs = {}
    for name, fn, uids in (("linear", asx.densify_packed_batch, lin),
                           ("packed", asx.densify_packed_direct_batch, packed)):
        cot = torch.randn(2, g // 2, g // 2, 128, generator=gen)
        t_cpu = table.clone().requires_grad_()
        want, want_m = fn(t_cpu, uids, (g, g))
        want.backward(cot)
        t_dev = table.to(dev).requires_grad_()
        u_dev, c_dev = uids.to(dev), cot.to(dev)
        read = reset_launches()
        got, got_m = fn(t_dev, u_dev, (g, g))
        n_fwd = read()["expand_rows"]
        got.backward(c_dev)
        torch.cuda.synchronize()
        q = torch.round(table * 40).clamp(-127, 127).to(torch.int8)
        q_equal = torch.equal(fn(q.to(dev), u_dev, (g, g))[0].cpu(), fn(q, uids, (g, g))[0])
        equal = (torch.equal(got.detach().cpu(), want.detach()) and
                 torch.equal(got_m.cpu(), want_m) and torch.equal(t_dev.grad.cpu(), t_cpu.grad))

        def fwd():
            with torch.no_grad():
                fn(t_dev, u_dev, (g, g))

        def fwd_bwd():
            t_dev.grad = None
            fn(t_dev, u_dev, (g, g))[0].backward(c_dev)

        ms = cuda_ms(torch, fwd, 20)
        bwd_ms = cuda_ms(torch, fwd_bwd, 10) - ms
        print(f"K5 in the {name}-order packed densify, bs2, {cap}-row tables, {n} pillars a "
              f"scene, 1440²: launches {n_fwd}, rows, mask and table gradient bit-equal to the "
              f"CPU: {equal}, int8 table bit-equal: {q_equal}; the densify's forward {ms:.4f} "
              f"ms (the index build and K5), its backward {bwd_ms:.4f} ms")
        if not (equal and q_equal) or n_fwd != 1:
            raise RuntimeError(f"K5 {name}-order packed densify: equal {equal}, int8 {q_equal}, "
                               f"launches {n_fwd}")
        # K5 alone on the flat table and rows this densify hands it
        seen, real = {}, asx.expand_rows
        asx.expand_rows = lambda t, i: seen.update(t=t, i=i) or real(t, i)  # noqa: E731
        try:
            fwd()
        finally:
            asx.expand_rows = real
        rec = check_expand(torch, f"{name}-order packed densify", seen["t"], seen["i"], 20)
        recs[name] = bound_of(dict(rec, densify_ms=ms, backward_ms=bwd_ms, ops_ms=0.0))
        del t_dev, got, c_dev
        torch.cuda.empty_cache()
    return recs


def phase_gates(torch, dev, smi):
    """Phase 38: the two accuracy gates, cut: ``tools/torch_overfit_check.py``
    at grid 256 for ``OVERFIT_STEPS`` steps (it raises unless the loss halves
    and the scene's AP passes 0.25), and ``tools/torch_quality_gate.py
    --scenes 1`` with 30 + 30 steps for each variant, ``int8``, ``fp`` (the
    ``FP_STAGES: 5`` teacher, K6 x 19 a forward) and ``dcn_r8`` (K2, K3, K4
    at R = 8): one scene gives no error bar, so each ``RESULT`` line is
    printed, not judged. Returns the overfit AP."""
    from tools import torch_overfit_check, torch_quality_gate

    t0 = time.perf_counter()
    res = torch_overfit_check.main([str(OVERFIT_STEPS), "256"])
    t1 = time.perf_counter()
    gates = {}
    for variant in ("int8", "fp", "dcn_r8"):
        t = time.perf_counter()
        gate = torch_quality_gate.main(["--variant", variant, "--scenes", "1", "--steps_a", "30",
                                        "--steps_b", "30"])
        gates[variant] = (time.perf_counter() - t, gate["d_loss"], gate["d_ap"])
    print(f"gates on {smi}: overfit check {OVERFIT_STEPS} steps at grid 256 in {t1 - t0:.1f} s "
          f"(AP {res['ap']:.3f}); quality gate --scenes 1, 30 + 30 steps: "
          + "; ".join(f"--variant {v} in {t:.1f} s (d_loss {dl}, d_ap {da})"
                      for v, (t, dl, da) in gates.items()))
    torch.cuda.empty_cache()
    return res["ap"]


def phase_dense_from(torch, dev, yaml_name, dense_from=3):
    """``DENSE_FROM: dense_from`` against the shipped 5 on one raw val batch in
    float32 (TF32 off): the table stages and the masked-dense stages are the
    same function, and share their parameters."""
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    outs, peaks = {}, {}
    state = None
    for df in (5, dense_from):
        cfg, info, batch = make_batch(yaml_name, radar_backbone_3d={"DENSE_FROM": df},
                                      host_precompute=False)
        model = build_network(cfg, info, compute_dtype=torch.float32)
        if state is None:
            state = init_random_(model, torch.Generator().manual_seed(0)).state_dict()
        else:
            model.load_state_dict(state, strict=True)
        b = batch_to_torch(batch)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            outs[df] = model(b)
        torch.cuda.synchronize()
        peaks[df] = torch.cuda.max_memory_allocated() / 2**30
    torch.backends.cudnn.allow_tf32 = True
    errs = {k: rel_l2(torch, outs[dense_from]["radar_preds"][k], v)
            for k, v in outs[5]["radar_preds"].items()}
    print(f"val path f32 (TF32 off), 1440², DENSE_FROM {dense_from} vs 5 (same parameters, "
          f"device-built tables), radar_preds rel-L2: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; peak device memory {peaks[dense_from]:.2f} GiB vs {peaks[5]:.2f} GiB")
    bad = {k: v for k, v in errs.items() if not v <= 1e-4}
    if bad or int(outs[dense_from]["as_overflow"]) != 0:
        raise RuntimeError(f"DENSE_FROM {dense_from} vs 5: {bad}")


def phase_k8(torch, dev, tables, smi):
    """K8 on the student's tap tables of the bs2 train batch, as the
    active-site convs would use it (``ops/gather_bench.py``): forward (rows of
    the feature table at ``nb``) and backward (rows of the cotangent at
    ``inv``), bfloat16. Per table the least window without overflow, then
    wrapper == bare launch == plain windowed == unwindowed gather and count
    0; each gather timed as the wrapper, the bare launch alone, the plain
    version and ``index_select``, in turns; one table with the window one too
    small. Returns the record summed over the 14 gathers."""
    from radardistill_tpu_torch.ops import gather_bench
    from radardistill_tpu_torch.ops.expand import (gather_rows_windowed,
                                                   gather_rows_windowed_plain)

    cases = gather_bench.tap_gathers(tables, torch.Generator().manual_seed(18))
    rec = {"max_abs_err": 0.0, "ms": 0.0, "launch_ms": 0.0, "cold_launch_ms": 0.0,
           "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for case in cases:
        gather_bench.check_case(case)
        ms = gather_bench.time_case(case)
        print(f"K8 gather_rows_windowed {gather_bench.describe(case)}: wrapper == bare launch == "
              f"plain == unwindowed gather, overflow 0; wrapper {ms['wrapper']:.4f} ms, alone "
              f"{ms['alone']:.4f} ms, alone with L2 emptied {ms['cold']:.4f} ms, plain "
              f"{ms['plain']:.4f} ms, index_select (no window) {ms['index_select']:.4f} ms, "
              f"bound {ms['bound']:.4f} ms ({gather_bench.bound_bytes(case) / 1e6:.1f} MB) on "
              f"{smi}")
        for key, v in (("ms", "wrapper"), ("launch_ms", "alone"), ("cold_launch_ms", "cold"),
                       ("plain_ms", "plain"), ("library_ms", "index_select"),
                       ("bytes_ms", "bound")):
            rec[key] += ms[v]
    small = next((c for c in cases if c["n_win"] > 1), None)
    if small is None:
        raise RuntimeError("K8: no tap table needs a window above one block")
    table, idx, n_win = small["table"], small["idx"], small["n_win"] - 1
    got, over = gather_rows_windowed(table, idx, n_win)
    want, over_p = gather_rows_windowed_plain(table, idx, n_win)
    torch.cuda.synchronize()
    zeroed = int((got == 0).all(dim=1).sum())
    print(f"K8 {small['name']} {small['direction']} with n_win {n_win}, one too small: kernel "
          f"rows == plain rows {torch.equal(got, want)}, {zeroed} zero rows, overflow count "
          f"kernel {int(over)}, plain {int(over_p)}")
    if not torch.equal(got, want) or int(over) != int(over_p) or int(over) <= 0:
        raise RuntimeError("K8: the too-small window differs from the plain version")
    print(f"K8, the 14 gathers summed: wrapper {rec['ms']:.4f} ms, alone {rec['launch_ms']:.4f} "
          f"ms, alone with L2 emptied {rec['cold_launch_ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
          f"ms, index_select {rec['library_ms']:.4f} ms, bound {rec['bytes_ms']:.4f} ms on {smi}")
    read = reset_launches()
    for case in cases:
        gather_rows_windowed(case["table"], case["idx"], case["n_win"])
    torch.cuda.synchronize()
    return bound_of(rec), read()["gather_rows_windowed"]


def phase_probes(torch, dev):
    """P2 then P1: every case against its plain version, then its rate. The
    records of the kernels line: the bfloat16 (2048, 512, 512) product on the
    ``wgmma`` route, and the ``conv`` mode at (2, 720, 720, 128) -> 128 on the
    ``wgmma`` route (the TMA + ``wgmma`` conv mainloop)."""
    from radardistill_tpu_torch.ops.probe_bench import (conv_probe_table,
                                                         mma_rate_against_library,
                                                         mma_rate_table)

    read = reset_launches()
    rates = mma_rate_table(dev, target_ops=4e11)
    convs = conv_probe_table(dev, iters=3)
    launches = read()
    # P2 and torch.bmm in turns, 20 times each: the table's single reading of
    # each moves more between calls than the two differ
    alt = mma_rate_against_library(dev)
    spread = {name: (sum(v) / len(v), min(v), max(v)) for name, v in zip(("P2", "bmm"), alt)}
    print("P2 mma_rate bfloat16 (2048, 512, 512), 8 products, wgmma, and torch.bmm in turns, "
          f"{len(alt[0])} times each: " + "; ".join(
              f"{n} mean {m:.4f} ms (min {lo:.4f}, max {hi:.4f})"
              for n, (m, lo, hi) in spread.items()))
    p2 = next(r for r in rates if r["shape"] == (2048, 512, 512) and r["type"] == "bfloat16"
              and r["route"] == "wgmma")
    p1 = next(r for r in convs if r["shape"] == (2, 720, 720, 128, 128) and r["mode"] == "conv"
              and r["route"] == "wgmma")
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")
    return (bound_of({"launch_ms": p1["launch_ms"], **{k: p1[k] for k in keys}}),
            launches["conv_probe"],
            bound_of({**{k: p2[k] for k in keys}, "alternating_ms": list(spread["P2"]),
                      "alternating_library_ms": list(spread["bmm"])}), launches["mma_rate"])


def cudnn_bf16_conv_aside(torch, dev):
    """Labelled aside, not a yardstick of K1 (another type, no epilogue): a
    cuDNN bfloat16 3x3 conv of the link's shape."""
    x = torch.randn(2, 128, 720, 720, device=dev, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(128, 128, 3, 3, device=dev, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    ms = cuda_ms(torch, lambda: torch.nn.functional.conv2d(x, w, None, 1, 1), 10)
    print(f"aside: cuDNN bf16 conv2d (2, 720, 720, 128) x (3, 3, 128, 128), no epilogue: {ms:.4f} ms")


# ------------------------------------------------------------------------
# The DCN kernels at R = 8 (phase 0), and the modules that
# close the port (phases 39-43): the anchor family, adam and sgd, remat, the
# tile-sparse backbone, the tools' last flags.

ANCHOR_YAML = ROOT / "tools/cfgs/synthetic/pointpillar_smoke.yaml"
ANCHOR_FORWARD = {"expand_rows": 1}  # the dense VFE's densify, once a forward
# the radar baseline's step under MODEL.REMAT: the CMA's forward runs again
# in the backward, so K2 twice
REMAT_STEP = {**RADAR_BASELINE_STEP, "dcn_sample": 6}


def check_launches(name, got, want):
    """Raise unless the counts ``got`` are ``want`` (absent keys 0)."""
    want = {**dict.fromkeys(got, 0), **want}
    if got != want:
        raise RuntimeError(f"{name}: launches {got}, expected {want}")


def median(v):
    v = sorted(v)
    return (v[(len(v) - 1) // 2] + v[len(v) // 2]) / 2


def phase_dcn_r8(torch, dev):
    """Phase 0: K2, K3 and K4 at the clamp R = 8 (``DCN_R=8``, the quality
    gate's ``dcn_r8`` variant) at the CMA's three sites, bs2, float32 and
    bfloat16, against their plain versions (the tolerances of R = 5); K4 on
    its ``tile`` route by rule, its window's shared memory printed beside R =
    5's, and its time at R = 8 beside R = 5, in turns (bf16, the three
    sites); then stride 1 at 90² at R = 8 (its window fits: the tile route)
    and at a clamp of 20 (it does not: the atomic route by rule). Returns K4's
    (ms at R = 5, ms at R = 8) over the three sites."""
    from radardistill_tpu_torch.ops import dcn_grad
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample, dcn_sample_plain

    gen = torch.Generator().manual_seed(16)
    b, c = 2, 256
    ms = {5.0: 0.0, 8.0: 0.0}
    for h, ho, stride in ((180, 90, 2), (90, 45, 2), (180, 90, 2), (90, 90, 1)):
        x32 = torch.randn(b, h, h, c, generator=gen)
        ds32 = torch.randn(b, ho, ho, 9 * c, generator=gen)
        off = (4.0 * torch.randn(b, ho, ho, 18, generator=gen)).to(dev)
        msk = (torch.rand(b, ho, ho, 9, generator=gen) * 0.9 + 0.05).to(dev)
        for r in (5.0, 8.0) if stride == 2 else (8.0, 20.0):
            geo = (stride, 1, 3, r)
            th, tw, _ = dcn_grad.tile_plan(h, h)
            cap = dcn_grad.tile_windows(h, h, ho, ho, stride, 1, 3, r, th, tw, dev)[1]
            smem = dcn_grad.tile_smem_bytes(cap, th, tw)
            route = dcn_grad.input_grad_route(r, stride, 1, c, torch.bfloat16, (h, h, ho, ho, 3))
            if route != ("tile" if smem <= dcn_grad.TILE_SMEM_LIMIT else "atomic"):
                raise RuntimeError(f"K4 at R {r}, stride {stride}: route {route}")
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
                x, ds = x32.to(dev, dtype), ds32.to(dev, dtype)
                before = dict(dcn_grad.dcn_input_grad.route_launches)
                y = dcn_sample(x, off, msk, *geo)
                g18, dm9 = dcn_grad.dcn_offset_grad(x, off, ds, msk, *geo)
                dx = dcn_grad.dcn_input_grad(ds, off, msk, h, h, *geo)
                torch.cuda.synchronize()
                moved = [k for k, n in dcn_grad.dcn_input_grad.route_launches.items()
                         if n != before[k]]
                if moved != [route]:
                    raise RuntimeError(f"K4 at R {r}: counted on {moved}, not {route}")
                errs = []
                g18_p, dm9_p = dcn_grad.dcn_offset_grad_plain(x, off, ds, msk, *geo)
                for name, got, want in (
                        ("K2 y", y, dcn_sample_plain(x, off, msk, *geo)),
                        ("K3 g18", g18, g18_p), ("K3 dm9", dm9, dm9_p),
                        ("K4 dx", dx, dcn_grad.dcn_input_grad_plain(ds, off, msk, h, h, *geo))):
                    err = (got.float() - want.float()).abs().max().item()
                    ref = want.float().abs().max().item()
                    if not err <= tol * ref:
                        raise RuntimeError(f"{name} {dtype} R {r} at {h}²: error {err} over "
                                           f"{tol} x {ref}")
                    errs.append(f"{name} {err:.3e} (limit {tol * ref:.3e})")
                sat = (off.abs() >= r).float().mean().item()
                print(f"DCN R {r:g} stride {stride} {str(dtype)[6:]} bs{b} {h}²->{ho}² "
                      f"({100 * sat:.1f}% of offsets at or beyond the clamp): {', '.join(errs)}; "
                      f"K4 on its {route} route, the tile window {cap} (site, tap) pairs = "
                      f"{smem} B of shared memory (limit {dcn_grad.TILE_SMEM_LIMIT})")
        if stride != 2:
            continue
        ds = ds32.to(dev, torch.bfloat16)
        t = {r: lambda r=r: dcn_grad.dcn_input_grad(ds, off, msk, h, h, 2, 1, 3, r)
             for r in (5.0, 8.0)}
        t5, t8 = paired_ms(torch, t[5.0], t[8.0], iters=10)
        ms[5.0] += t5
        ms[8.0] += t8
        print(f"K4 dcn_input_grad bfloat16 bs{b} {h}²->{ho}² tile route: R 5 {t5:.4f} ms, R 8 "
              f"{t8:.4f} ms (in turns)")
    print(f"K4 over the three CMA sites, bfloat16 bs{b}: R 5 {ms[5.0]:.4f} ms, R 8 "
          f"{ms[8.0]:.4f} ms")
    return ms[5.0], ms[8.0]


def anchor_cfg(grid=None):
    """``pointpillar_smoke.yaml`` (the port's config), and its dataset info;
    with ``grid`` 1440 on ``pillarnet.yaml``'s range and voxel: [-54, 54] m
    at 0.075 m."""
    from radardistill_tpu_torch.config import ConfigDict, cfg_from_yaml_file

    cfg = ConfigDict()
    cfg_from_yaml_file(str(ANCHOR_YAML), cfg)
    pcr = [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0] if grid else [-9.6, -9.6, -5.0, 9.6, 9.6, 3.0]
    vs = (0.075, 0.075, 8.0) if grid else (0.15, 0.15, 8.0)
    n = int(round((pcr[3] - pcr[0]) / vs[0]))
    return cfg, {"grid_size": (n, n), "voxel_size": vs, "point_cloud_range": tuple(pcr),
                 "class_names": tuple(cfg.CLASS_NAMES)}


def anchor_batch(info, batch_size, num_lidar, num_boxes, seed=0):
    """Synthetic scenes over ``info``'s range as the anchor family's batch:
    points (B, N, 5), their mask, and GT boxes of the two classes (1-based,
    0 padding)."""
    import numpy as np

    from radardistill_tpu_torch.data.collate import collate_batch
    from radardistill_tpu_torch.data.synthetic import make_scene

    scenes = [make_scene(seed + i, num_lidar=num_lidar, num_radar=10, num_boxes=num_boxes,
                         pc_range=np.asarray(info["point_cloud_range"], np.float32))
              for i in range(batch_size)]
    for s in scenes:
        del s["radar_points"]
    batch = collate_batch(scenes, {"MAX_LIDAR_POINTS": num_lidar, "NUM_MAX_OBJS": num_boxes})
    batch.pop("_host", None)
    gt = batch["gt_boxes"]
    gt[..., -1] = np.where(gt[..., -1] > 0, 1 + gt[..., -1] % 2, 0)
    batch["gt_boxes"] = gt[..., [0, 1, 2, 3, 4, 5, 6, -1]]
    return batch


def voxel_batch(batch, info, max_points=32):
    """The fixed voxels of ``PillarVFE`` from a points batch, as the data
    processor's ``transform_points_to_voxels`` makes them (points sorted by
    voxel, stable; the first ``max_points`` of a voxel kept; coords (z, y,
    x)), every voxel of a sample kept and padded to the batch's most, -1
    coords on the padding."""
    import numpy as np

    nx, ny = info["grid_size"]
    lo = np.asarray(info["point_cloud_range"][:3], np.float32)
    vs = np.asarray(info["voxel_size"], np.float32)
    per = []
    for pts, m in zip(batch["points"], batch["points_mask"]):
        p = pts[m]
        c = np.floor((p[:, :3] - lo) / vs).astype(np.int64)
        ok = (c[:, 0] >= 0) & (c[:, 0] < nx) & (c[:, 1] >= 0) & (c[:, 1] < ny) & (c[:, 2] == 0)
        p, c = p[ok], c[ok]
        key = c[:, 1] * nx + c[:, 0]
        order = np.argsort(key, kind="stable")
        p, key = p[order], key[order]
        uniq, start, count = np.unique(key, return_index=True, return_counts=True)
        rank = np.arange(len(key)) - np.repeat(start, count)
        keep = rank < max_points
        per.append((p[keep], np.repeat(np.arange(len(uniq)), count)[keep], rank[keep], uniq,
                    np.minimum(count, max_points)))
    v = max(len(u) for *_, u, _ in per)
    b, f = len(per), batch["points"].shape[-1]
    voxels = np.zeros((b, v, max_points, f), np.float32)
    nums = np.zeros((b, v), np.int32)
    coords = np.full((b, v, 3), -1, np.int32)
    for i, (p, vid, rank, uniq, cnt) in enumerate(per):
        voxels[i, vid, rank] = p
        nums[i, :len(uniq)] = cnt
        coords[i, :len(uniq)] = np.stack([np.zeros_like(uniq), uniq // nx, uniq % nx], -1)
    return {"voxels": voxels, "voxel_num_points": nums, "voxel_coords": coords,
            "gt_boxes": batch["gt_boxes"]}


def phase_anchor_cli(torch, dev, smi, work):
    """Phase 39: the anchor family's shipped config through the CLIs and the
    tools' last flags: ``tools/torch_train.py`` on ``pointpillar_smoke.yaml``
    (1 epoch, bs2, ``--profile_dir``: one warm and 3 traced steps first),
    ``tools/torch_test.py`` on its checkpoint with ``--bev_similarity
    spatial_features_2d``, ``tools/torch_demo.py`` and
    ``tools/torch_calc_caps.py``; K5 once a forward. Returns (launches,
    seconds)."""
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.train.trainer import read_log
    from radardistill_tpu_torch.train.train_step import make_eval_step
    from tools import torch_calc_caps, torch_demo, torch_test, torch_train

    t_start = time.perf_counter()
    tag = "chip_smoke_anchor"
    out = Path("output") / "pointpillar_smoke" / tag
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    prof = work / "prof"
    common = ["--cfg_file", str(ANCHOR_YAML), "--batch_size", "2", "--extra_tag", tag]
    read = reset_launches()
    state = torch_train.main(common + ["--epochs", "1", "--workers", "2", "--log_interval", "1",
                                       "--num_epochs_to_eval", "0", "--profile_dir", str(prof)])
    result = torch_test.main(common + ["--infer_time", "--bev_similarity", "spatial_features_2d"])
    torch.cuda.synchronize()
    launches = read()
    n_train = len(read_log(next(out.glob("log_train_*.txt"))))
    n_steps = 1 + torch_train.PROFILE_STEPS + n_train
    check_launches("anchor family CLIs", launches,
                   {"expand_rows": n_steps + 4})  # 8 val samples at bs2: 4 forwards
    losses = [r[4] for r in read_log(next(out.glob("log_train_*.txt")))]
    traces = list(prof.glob("trace_*.json"))
    sim = out / "eval" / "similarity" / "spatial_features_2d"
    if not (all(abs(v) < float("inf") for v in losses) and traces
            and (sim / "cosine.csv").is_file() and 0 <= result["mAP"] <= 1):
        raise RuntimeError(f"anchor CLIs: losses {losses}, traces {traces}, result {result}")
    from radardistill_tpu_torch.data.loader import build_dataloader

    cfg, _ = anchor_cfg()
    _, ld = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, training=False)
    fbd = make_eval_step(state.model)(batch_to_torch(next(iter(ld))[0], dev))["final_box_dicts"]
    shapes = {k: tuple(v.shape) for k, v in fbd.items()}
    if shapes != {"boxes": (2, 50, 7), "scores": (2, 50), "labels": (2, 50), "valid": (2, 50)} \
            or not all_finite(torch, fbd):
        raise RuntimeError(f"anchor eval: final_box_dicts {shapes}")
    png = torch_demo.main(["--cfg_file", str(ANCHOR_YAML), "--ckpt_dir", str(out / "ckpt"),
                           "--out", str(work / "demo.png")])
    caps = torch_calc_caps.main(["--n_samples", "4"])
    print(f"anchor family CLIs on {smi}: pointpillar_smoke.yaml, 1 epoch of {n_train} steps at "
          f"bs2 (losses {[round(v, 4) for v in losses]}), --profile_dir: "
          f"{torch_train.PROFILE_STEPS} steps traced into {traces[0].name} "
          f"({traces[0].stat().st_size / 1e6:.1f} MB); eval mAP {result['mAP']:.4f}, "
          f"final_box_dicts {shapes}, --bev_similarity wrote {sorted(p.name for p in sim.iterdir())}; "
          f"torch_demo wrote {Path(png).stat().st_size} B; torch_calc_caps: {caps}; "
          f"launches {launches}; {time.perf_counter() - t_start:.1f} s")
    return launches, time.perf_counter() - t_start


def phase_anchor_full(torch, dev, smi, batch_size=4, num_lidar=160000, grid=1440, runs=10):
    """Phase 40: the anchor family's model at full size: ``pointpillar_smoke.yaml``'s
    MODEL on ``pillarnet.yaml``'s 1440² grid (720² x 4 = 2 073 600 anchors),
    bs4, scenes of 160 000 LiDAR points and 64 boxes, bf16: the resident train
    step (p50 of ``runs``, peak GiB, K5 x 1 a step) and the eval forward (p50,
    K5 x 1, the detections' shapes), with the dense VFE; then the same with
    ``VFE.NAME: PillarVFE`` on fixed voxels (no K5; 20 points a voxel, the
    ``MAX_POINTS_PER_VOXEL`` of OpenPCDet's nuScenes PointPillars, and every
    voxel kept). Returns the dense VFE's launches per step."""
    import copy

    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.train.optim import build_optimizer
    from radardistill_tpu_torch.train.train_step import make_eval_step, make_train_step

    cfg, info = anchor_cfg(grid)
    t0 = time.perf_counter()
    points = anchor_batch(info, batch_size, num_lidar, 64)
    t_batch = time.perf_counter() - t0
    step_launches = None
    for vfe in ("DynamicPillarVFESimple2D", "PillarVFE"):
        t0 = time.perf_counter()
        host = points if vfe != "PillarVFE" else voxel_batch(points, info, max_points=20)
        t_vox = time.perf_counter() - t0
        model_cfg = copy.deepcopy(cfg.MODEL)
        model_cfg.VFE.NAME = vfe
        model = build_network(model_cfg, info, compute_dtype=torch.bfloat16, device=dev,
                              generator=torch.Generator().manual_seed(40))
        opt, _ = build_optimizer(cfg.OPTIMIZATION, model, 1000, model.frozen)
        step = make_train_step(model, opt, model_cfg, info["class_names"], info["voxel_size"],
                               info["point_cloud_range"])
        batch = batch_to_torch(host, dev)
        want = ANCHOR_FORWARD if vfe != "PillarVFE" else {}
        torch.cuda.reset_peak_memory_stats()
        metrics = step(batch)
        torch.cuda.synchronize()
        read = reset_launches()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            metrics = step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = read()
        check_launches(f"anchor {vfe} train", launches, {k: runs * n for k, n in want.items()})
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all_finite(torch, metrics):
            raise RuntimeError(f"anchor {vfe}: metrics {metrics}")
        eval_step = make_eval_step(model)
        out = eval_step(batch)
        torch.cuda.synchronize()
        read = reset_launches()
        etimes = []
        for _ in range(runs):
            t0 = time.perf_counter()
            out = eval_step(batch)
            torch.cuda.synchronize()
            etimes.append((time.perf_counter() - t0) * 1e3)
        check_launches(f"anchor {vfe} eval", read(), {k: runs * n for k, n in want.items()})
        shapes = {k: tuple(v.shape) for k, v in out["final_box_dicts"].items()}
        if shapes["boxes"] != (batch_size, 50, 7) or not all_finite(torch,
                                                                    out["final_box_dicts"]):
            raise RuntimeError(f"anchor {vfe} eval: {shapes}")
        extra = (f"; {host['voxels'].shape[1]} voxels a sample at most, made on the host in "
                 f"{t_vox:.1f} s" if vfe == "PillarVFE" else "")
        print(f"anchor family at full size, VFE {vfe}, {info['grid_size'][0]}², "
              f"{model.anchors_flat.shape[0]} anchors, bs{batch_size}, bf16, on {smi}: resident "
              f"train step p50 {median(times):.3f} ms ({batch_size / median(times) * 1e3:.3f} "
              f"samples/s; loss {float(metrics['loss']):.4f}), peak {peak:.2f} GiB; eval "
              f"forward p50 {median(etimes):.3f} ms, {int(out['final_box_dicts']['valid'].sum())} "
              f"valid detections of {shapes['valid']}; launches per {runs} steps {launches}"
              f"{extra}; batch made in {t_batch:.1f} s")
        if vfe != "PillarVFE":
            step_launches = {k: v // runs for k, v in launches.items()}
        del model, opt, step, batch, out, eval_step
        torch.cuda.empty_cache()
    return step_launches


def phase_optimizers(torch, dev, smi, steps=2):
    """Phase 41: ``OPTIMIZER: adam`` and ``sgd`` on ``pointpillar_smoke.yaml``,
    float32 (TF32 off), ``steps`` steps on one loader batch at bs2 on the card
    and on the CPU from the same weights, held to the bounds phase 20 and the
    port's CPU train tests state (``tests/torch_train_case.py``): the first
    loss within 1e-4, the loss falling on both, and after the steps every
    parameter within 2 x sum(lr) of the CPU's (Adam's first updates are
    sign-like, so float32 noise in a near-zero gradient moves a parameter by
    up to lr), the parameters' rel-L2 <= 5e-3 and the updates' cosine >= 0.9."""
    from radardistill_tpu_torch.data.loader import build_dataloader
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.train.optim import build_optimizer
    from radardistill_tpu_torch.train.train_step import make_train_step

    cfg, info = anchor_cfg()
    _, ld = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, training=True)
    host = next(iter(ld))[0]
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for name in ("adam", "sgd"):
        ocfg = dict(cfg.OPTIMIZATION, OPTIMIZER=name)
        runs = []
        for where in (dev, torch.device("cpu")):
            model = build_network(cfg.MODEL, info, device=where,
                                  generator=torch.Generator().manual_seed(41))
            init = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
            opt, lr_sched = build_optimizer(ocfg, model, 100, model.frozen)
            step = make_train_step(model, opt, cfg.MODEL, info["class_names"],
                                   info["voxel_size"], info["point_cloud_range"])
            batch = batch_to_torch(host, where)
            losses = [float(step(batch)["loss"]) for _ in range(steps)]
            runs.append((losses, {k: v.detach().cpu() for k, v in model.named_parameters()},
                         init))
        lr_sum = sum(lr_sched(i) for i in range(steps))
        (lc, pc, init), (lh, ph, _) = runs
        worst = max((pc[k] - ph[k]).abs().max().item() for k in pc)
        flat = lambda p: torch.cat([p[k].reshape(-1) for k in pc])  # noqa: E731
        params_rel = rel_l2(torch, flat(pc), flat(ph))
        du_c, du_h = flat(pc) - flat(init), flat(ph) - flat(init)
        cosine = float((du_c.double() @ du_h.double()) / (du_c.double().norm()
                                                         * du_h.double().norm()))
        print(f"OPTIMIZER {name} on {smi}: {steps} steps, f32, losses card "
              f"{[round(v, 5) for v in lc]}, CPU {[round(v, 5) for v in lh]}; parameters "
              f"card vs CPU max |diff| {worst:.3e} (limit 2 x sum(lr) = {2 * lr_sum:.3e}), "
              f"rel-L2 {params_rel:.3e} (limit 5e-3), the updates' cosine {cosine:.5f} "
              f"(limit 0.9)")
        if not (abs(lc[0] - lh[0]) <= 1e-4 * abs(lh[0]) and lc[-1] < lc[0] and lh[-1] < lh[0]
                and worst <= 2 * lr_sum and params_rel <= 5e-3 and cosine >= 0.9):
            raise RuntimeError(f"OPTIMIZER {name}: card and CPU disagree or the loss rose")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def radar_batch(torch, dev, tree, batch_size=8, sets=()):
    """(cfg, dataset info, device batch) of ``pillarnet_radar.yaml`` over the
    tree (``sets``: more ``--set`` pairs), the first train batch at
    ``batch_size``."""
    from radardistill_tpu_torch.data.loader import build_dataloader
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from tools import torch_train

    _, cfg = torch_train.parse_config(["--cfg_file", str(RADAR_YAML), "--set",
                                       *tree_sets(tree[0]), *sets])
    ds, ld = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                              root_path=cfg.DATA_CONFIG.DATA_PATH, workers=0, training=True,
                              model_cfg=cfg.MODEL)
    info = {"grid_size": tuple(int(x) for x in ds.grid_size[:2]),
            "voxel_size": tuple(float(x) for x in ds.voxel_size),
            "point_cloud_range": tuple(float(x) for x in ds.point_cloud_range),
            "class_names": tuple(cfg.CLASS_NAMES)}
    return cfg, info, batch_to_torch(next(iter(ld))[0], dev)


def phase_remat(torch, dev, smi, tree, runs=5, sets=()):
    """Phase 42: ``MODEL.REMAT`` on the radar baseline (``pillarnet_radar.yaml``,
    bs8, 1440², bf16): one model, its weights and statistics restored before
    each leg. A forward + backward without remat, again without (the
    repeatability floor), and with remat: the running statistics bit-equal to
    the first leg's, and the gradients' rel-L2 beside the floor's; then the
    train step's p50 and peak GiB both ways, the launches read per step (K2
    x 3 without, x 6 with: the CMA's forward runs again in the backward).
    Returns the launches of a remat step."""
    import copy

    from radardistill_tpu_torch.models import build_network, compute_training_loss
    from radardistill_tpu_torch.train.optim import build_optimizer
    from radardistill_tpu_torch.train.train_step import make_train_step

    cfg, info, batch = radar_batch(torch, dev, tree, sets=sets)
    model = build_network(cfg.MODEL, info, compute_dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator().manual_seed(42))
    start = copy.deepcopy(model.state_dict())
    legs = {}
    for leg, remat in (("plain", False), ("again", False), ("remat", True)):
        model.load_state_dict(start)
        model.remat = remat
        model.train()
        model.zero_grad(set_to_none=True)
        out = model(batch)
        loss, _ = compute_training_loss(cfg.MODEL, out, info["class_names"],
                                        info["voxel_size"], info["point_cloud_range"])
        loss.backward()
        torch.cuda.synchronize()
        legs[leg] = ({k: v.clone() for k, v in model.named_buffers() if "running" in k},
                     torch.cat([p.grad.float().reshape(-1) for p in model.parameters()
                                if p.grad is not None]), loss.detach().item())
        del out, loss
    (b0, g0, l0), (b1, g1, l1), (b2, g2, l2) = legs["plain"], legs["again"], legs["remat"]
    worst = {leg: max((b0[k].float() - b[k].float()).abs().max().item() for k in b0)
             for leg, b in (("again", b1), ("remat", b2))}
    g_floor, g_remat = rel_l2(torch, g1, g0), rel_l2(torch, g2, g0)
    print(f"remat, radar baseline bs8 1440² bf16 on {smi}: losses {l0:.6f} / {l1:.6f} / "
          f"{l2:.6f} (plain / again / remat); running statistics of {len(b0)} buffers, max "
          f"|diff| to the plain leg: again {worst['again']:.3e}, remat {worst['remat']:.3e} "
          f"(bit-equal: {worst['remat'] == 0}); gradients rel-L2 to the plain leg: again "
          f"{g_floor:.3e}, remat {g_remat:.3e} (limit max(1e-2, 10 x the floor))")
    # a second update of the statistics would move them by a momentum step,
    # far beyond the repeatability floor
    if worst["remat"] > 10 * worst["again"] or g_remat > max(1e-2, 10 * g_floor):
        raise RuntimeError("remat: running statistics or gradients differ")
    del legs, g0, g1, g2
    numbers = {}
    for remat in (False, True):
        model.load_state_dict(start)
        model.remat = remat
        opt, _ = build_optimizer(cfg.OPTIMIZATION, model, 1000, model.frozen)
        step = make_train_step(model, opt, cfg.MODEL, info["class_names"], info["voxel_size"],
                               info["point_cloud_range"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step(batch)
        torch.cuda.synchronize()
        read = reset_launches()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = read()
        want = REMAT_STEP if remat else RADAR_BASELINE_STEP
        check_launches(f"radar baseline step, remat {remat}", launches,
                       {k: runs * n for k, n in want.items()})
        numbers[remat] = (median(times), torch.cuda.max_memory_allocated() / 2**30,
                          {k: v // runs for k, v in launches.items() if v})
        del opt, step
    print(f"radar baseline train step bs8 1440² bf16 on {smi}: without remat p50 "
          f"{numbers[False][0]:.3f} ms, peak {numbers[False][1]:.2f} GiB, launches a step "
          f"{numbers[False][2]}; with remat p50 {numbers[True][0]:.3f} ms, peak "
          f"{numbers[True][1]:.2f} GiB, launches a step {numbers[True][2]}")
    del model, batch, start
    torch.cuda.empty_cache()
    return {k: v * runs for k, v in numbers[True][2].items()}


def phase_tile_sparse(torch, dev, smi, tree, runs=3, sets=()):
    """Phase 43: ``Radar_PillarRes18BackBone8x_TileSparse`` in place of the
    radar baseline's backbone (``pillarnet_radar.yaml``, eval, bs8, 1440²),
    the dense model's weights carried across
    (``backbone_tile_sparse.state_from_dense``): the active tiles and the
    overflow flag of each stage at the JAX defaults (``TILE`` 32,
    ``MAX_TILES`` 512); where they overflow, again at a ``MAX_TILES`` that
    holds every active tile; there float32 (TF32 off) outputs against the
    dense backbone's (rel-L2 <= 1e-4), and the bf16 forward's p50 beside the
    dense model's, in turns. Returns the eval forward's launches."""
    import copy

    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.backbone_tile_sparse import state_from_dense

    cfg, info, batch = radar_batch(torch, dev, tree, sets=sets)
    dense = build_network(cfg.MODEL, info, compute_dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator().manual_seed(43))

    def tile_model(max_tiles, dtype):
        mcfg = copy.deepcopy(cfg.MODEL)
        mcfg.RADAR_BACKBONE_3D.NAME = "Radar_PillarRes18BackBone8x_TileSparse"
        if max_tiles:
            mcfg.RADAR_BACKBONE_3D.MAX_TILES = max_tiles
        m = build_network(mcfg, info, compute_dtype=dtype, device=dev)
        state = {k: v for k, v in dense.state_dict().items()
                 if not k.startswith("radar_backbone_3d.")}
        state.update({f"radar_backbone_3d.{k}": v for k, v in state_from_dense(
            m.radar_backbone_3d, {k[18:]: v for k, v in dense.state_dict().items()
                                  if k.startswith("radar_backbone_3d.")}).items()})
        m.load_state_dict(state)
        return m

    tile = tile_model(None, torch.bfloat16)
    with torch.no_grad():
        tile(batch)
    stats = {k: (int(v["active"]), bool(v["overflow"]), v["tile"])
             for k, v in tile.radar_backbone_3d.tile_stats().items()}
    overflow = any(o for _, o, _ in stats.values())
    need = max(a for a, _, _ in stats.values())
    print(f"tile-sparse radar backbone, bs8 1440², MAX_TILES 512 (the JAX default): per stage "
          f"(active tiles, overflow, tile) {stats}" + (
              f"; it overflows, so again at MAX_TILES {need}" if overflow else ""))
    max_tiles = need if overflow else None
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t32 = tile_model(max_tiles, torch.float32)
    d32 = build_network(cfg.MODEL, info, device=dev)
    d32.load_state_dict(dense.state_dict())
    with torch.no_grad():
        ot, od = t32(batch), d32(batch)
    errs = {k: rel_l2(torch, ot[k].float(), od[k].float())
            for k in ("radar_x_conv4", "radar_spatial_features_2d")}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if any(bool(v["overflow"]) for v in t32.radar_backbone_3d.tile_stats().values()) or \
            not all(e <= 1e-4 for e in errs.values()):
        raise RuntimeError(f"tile-sparse backbone: rel-L2 to the dense one {errs}")
    del t32, d32, ot, od
    tile = tile_model(max_tiles, torch.bfloat16)
    for m in (tile, dense):
        m.eval()
    fwd = {name: (lambda m=m: m(batch)) for name, m in (("tile", tile), ("dense", dense))}
    read = reset_launches()
    fwd["tile"]()
    torch.cuda.synchronize()
    launches = read()
    check_launches("tile-sparse radar forward", launches, RADAR_BASELINE_FORWARD)
    t_tile, t_dense = paired_ms(torch, fwd["tile"], fwd["dense"], iters=runs)
    print(f"tile-sparse radar backbone on {smi}: float32 against the dense backbone rel-L2 "
          f"{errs} (limit 1e-4); eval forward bs8 bf16 p50-of-turns: tile-sparse "
          f"{t_tile:.3f} ms, dense {t_dense:.3f} ms (MAX_TILES {max_tiles or 512}); launches "
          f"a forward {launches}")
    del tile, dense, batch
    torch.cuda.empty_cache()
    return launches


def tensor_leaves(tree, prefix=""):
    """{dotted key: tensor} of the floating and integer tensors of a nested
    output dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tensor_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree} if hasattr(tree, "dtype") else {}


def phase_pcdet_import(torch, dev, smi, work):
    """Phase 44, the reference-checkpoint import. (a) A pcdet-layout
    ``model_state`` of the RadarDistill topology at full width
    (``utils/testing.py::reference_state_dict`` with fan-in-scaled values),
    saved as the reference saves a checkpoint, through
    ``tools/torch_convert_ckpt.py``. (b) The converted file into the shipped
    ``radar_distill_train.yaml`` model on the card
    (``CheckpointManager.load_params_from_file``): every entry must load and
    equal the in-memory ``pcdet_convert`` of the same state dict; the bf16
    distillation eval forward at 1440², bs2 (K5 x 2, K1 x 4 under ``INT8:
    static``, K2 x 3) on the file's weights, finite, and bit-equal to the
    same forward with the in-memory conversion loaded (and to a repeat of
    itself). (c) ``tools/torch_test.py`` on ``radar_distill_val.yaml`` with
    ``--ckpt`` the converted file, on a synthetic nuScenes tree of 2 val
    samples, bs1: every entry of the radar model loaded (its log's line), K5 x
    1 and K2 x 3 a forward. Returns the launches of (b)'s forward and (c)."""
    import numpy as np

    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.pcdet_convert import pcdet_convert
    from radardistill_tpu_torch.train.checkpoint import CheckpointManager
    from radardistill_tpu_torch.train.train_step import TrainState
    from radardistill_tpu_torch.utils.production import TRAIN_YAML
    from radardistill_tpu_torch.utils.testing import reference_state_dict
    from tools import torch_convert_ckpt, torch_test
    from tools.torch_nuscenes_tree import make_tree

    t_start = time.perf_counter()
    sd = reference_state_dict(np.random.RandomState(44), scale="fan_in")
    src, dst = work / "pillarnet_reference.pth", work / "pillarnet_converted.pth"
    torch.save({"model_state": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "optimizer_state": None, "epoch": 20, "it": 0, "version": "pcdet+synthetic"}, src)
    t0 = time.perf_counter()
    torch_convert_ckpt.main(["--src", str(src), "--dst", str(dst)])
    t_convert = time.perf_counter() - t0
    memory, unmapped = pcdet_convert(sd)
    if unmapped:
        raise RuntimeError(f"pcdet import: unmapped {unmapped[:5]}")

    cfg, info, batch = make_batch(TRAIN_YAML)
    model = build_network(cfg, info, compute_dtype=torch.bfloat16)
    state = CheckpointManager(work / "pcdet_ckpt").load_params_from_file(
        TrainState(model, None), dst)
    entries = model.state_dict()
    differ = [k for k, v in entries.items() if not torch.equal(v.cpu(), memory[k].to(v.dtype))]
    print(f"pcdet import: {len(sd)} pcdet tensors converted by tools/torch_convert_ckpt.py in "
          f"{t_convert:.2f} s; loaded {state.loaded} of {len(entries)} model entries of "
          f"radar_distill_train.yaml from the file; {len(differ)} differ from the in-memory "
          f"conversion")
    if state.loaded != len(entries) or differ:
        raise RuntimeError(f"pcdet import: loaded {state.loaded} of {len(entries)}, differing "
                           f"{differ[:5]}")
    if next(model.parameters()).device != dev:
        raise RuntimeError("pcdet import: the model is not on the card")
    bdev = batch_to_torch(batch)
    with torch.no_grad():
        model(bdev)  # warm-up
        torch.cuda.synchronize()
        read = reset_launches()
        got = tensor_leaves(model(bdev))
        torch.cuda.synchronize()
        fwd_launches = read()
        again = tensor_leaves(model(bdev))
        model.load_state_dict(memory, strict=True)
        want = tensor_leaves(model(bdev))
        torch.cuda.synchronize()
    check_launches("pcdet import forward", fwd_launches,
                   {"expand_rows": 2, "dcn_sample": 3, **K1_STAGE1})
    finite = all(not v.is_floating_point() or bool(torch.isfinite(v).all())
                 for k, v in got.items() if not k.startswith("final_box_dicts."))
    boxes = got["final_box_dicts.boxes"][got["final_box_dicts.valid"]]
    same = [k for k in want if torch.equal(got[k], want[k])]
    repeat = [k for k in want if torch.equal(got[k], again[k])]
    print(f"pcdet import: distillation eval forward bf16, 1440², bs2, on the file's weights: "
          f"launches {fwd_launches}; finite {finite}, {boxes.shape[0]} valid boxes (finite "
          f"{bool(torch.isfinite(boxes).all())}); {len(same)} of {len(want)} outputs bit-equal "
          f"to the forward on the in-memory conversion, {len(repeat)} to a repeat")
    if not finite or not bool(torch.isfinite(boxes).all()) or len(same) != len(want):
        raise RuntimeError(f"pcdet import: finite {finite}, outputs differing from the in-memory "
                           f"conversion's {sorted(set(want) - set(same))[:8]}")
    del model, state, bdev, batch, got, again, want
    torch.cuda.empty_cache()

    root = work / "nuscenes_pcdet"
    _, val_infos = make_tree(root, 2, 2)
    tag = "chip_smoke_pcdet"
    read = reset_launches()
    result = torch_test.main(["--cfg_file", str(ROOT / "tools/cfgs/radar_distill/radar_distill_val.yaml"),
                              "--batch_size", "1", "--ckpt", str(dst), "--extra_tag", tag,
                              "--set", *tree_sets(root)])
    torch.cuda.synchronize()
    cli_launches = read()
    check_launches("pcdet import val CLI", cli_launches,
                   {k: len(val_infos) * v for k, v in VAL_FORWARD.items()})
    (log,) = (Path("output") / "radar_distill_val" / tag / "eval").glob("log_eval_*.txt")
    line = re.search(r"loaded (\d+) of (\d+) model entries from .*", log.read_text())
    print(f"pcdet import: tools/torch_test.py --cfg_file radar_distill_val.yaml --ckpt "
          f"{dst.name}, {len(val_infos)} synthetic nuScenes samples, bs1: "
          f"\"{line and line[0]}\"; launches {cli_launches}; mAP {result['mAP']:.4f} "
          f"(fallback metric); the phase {time.perf_counter() - t_start:.1f} s on {smi}")
    if not line or line[1] != line[2] or not 0 <= result["mAP"] <= 1:
        raise RuntimeError(f"pcdet import val CLI: {line and line[0]}, result {result}")
    return {k: fwd_launches[k] + cli_launches[k] for k in fwd_launches}


# XLA's cost analysis of the JAX val eval step at 1440², bs1, float32, on
# make_batch()'s batch (tools/xla_cost_reference.py, the JAX tool's count, on
# the CPU): flops, bytes accessed, parameters
XLA_VAL_1440 = {"flops": 696.868e9, "bytes_accessed": 15.774e9, "params": 24_911_999}


def phase_cost(torch, dev, smi, work):
    """Phase 45, the cost count (see the module docstring). Returns the
    launches of (c)'s forward and train step."""
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_
    from radardistill_tpu_torch.train.train_step import make_eval_step
    from radardistill_tpu_torch.utils.production import TRAIN_YAML
    from radardistill_tpu_torch.utils.profiler import cost_analysis
    from tools import torch_test
    from tools.torch_nuscenes_tree import make_tree

    t_start = time.perf_counter()
    g = lambda x: f"{x / 1e9:.3f} G"  # noqa: E731

    def model_of(cfg, info, dtype=torch.float32, device=dev):
        return init_random_(build_network(cfg, info, compute_dtype=dtype, device=device),
                            torch.Generator().manual_seed(45))

    def count_checked(name, fn, arg, expect):
        """Count ``fn(arg)``; the hook's tallies must equal the launches."""
        read = reset_launches()
        ca = cost_analysis(fn, arg)
        torch.cuda.synchronize()
        launches = read()
        tallies = {k: ca["kernels"].get(k, 0) for k in launches if "." not in k}
        check_launches(name, {k: launches[k] for k in tallies}, expect)
        if tallies != {k: launches[k] for k in tallies}:
            raise RuntimeError(f"{name}: the hook's tallies {ca['kernels']} are not the "
                               f"launches {launches}")
        split = ", ".join(f"{k} {g(v)}" for k, v in ca["split"].items())
        print(f"cost {name}: flops {g(ca['flops'])} ({split}), bytes "
              f"{g(ca['bytes_accessed'])}; kernels {ca['kernels']} = launches")
        return ca, launches

    # (a) the val step at 1440², float32, against the JAX tool's reading
    cfg, info, batch = make_batch()
    model = model_of(cfg, info)
    n_params = sum(p.numel() for p in model.parameters())
    val = {"expand_rows": 1, "dcn_sample": 3}
    ca, _ = count_checked("val eval step float32 1440² bs1", make_eval_step(model),
                    batch_to_torch(batch), val)
    rel = ca["flops"] / XLA_VAL_1440["flops"] - 1
    print(f"cost val 1440²: params {n_params} (JAX {XLA_VAL_1440['params']}), flops "
          f"{ca['flops']:.0f} against XLA's {XLA_VAL_1440['flops']:.0f} ({100 * rel:+.2f}%), "
          f"bytes {ca['bytes_accessed']:.0f} (XLA after fusion {XLA_VAL_1440['bytes_accessed']:.0f})")
    if n_params != XLA_VAL_1440["params"] or not abs(rel) <= 0.05:
        raise RuntimeError(f"cost val 1440²: params {n_params}, flops {100 * rel:+.2f}% off XLA")
    ckpt = work / "val_random.pth"
    torch.save({"model_state": {k: v.cpu() for k, v in model.state_dict().items()}}, ckpt)
    del model
    root = work / "nuscenes_cost"
    _, val_infos = make_tree(root, 2, 2)
    tag = "chip_smoke_cost"
    read = reset_launches()
    torch_test.main(["--cfg_file", str(ROOT / "tools/cfgs/radar_distill/radar_distill_val.yaml"),
                     "--batch_size", "1", "--ckpt", str(ckpt), "--extra_tag", tag,
                     "--cal_params", "--set", *tree_sets(root)])
    torch.cuda.synchronize()
    cli = read()
    # the count's forward runs the kernels too: one forward more than the eval's
    check_launches("cost val CLI", cli,
                   {k: (len(val_infos) + 1) * v for k, v in VAL_FORWARD.items()})
    (log,) = (Path("output") / "radar_distill_val" / tag / "eval").glob("log_eval_*.txt")
    line = re.search(r"params: \S+M  flops/batch: \S+ G  bytes: \S+ G", log.read_text())
    print(f"cost: tools/torch_test.py --cfg_file radar_distill_val.yaml --cal_params, "
          f"{len(val_infos)} synthetic nuScenes samples, bs1: \"{line and line[0]}\"; "
          f"launches {cli} (the count's forward and the eval's)")
    if not line:
        raise RuntimeError("cost val CLI: no --cal_params line in the log")

    # (b) grid 256, float32: the card (kernels) against the CPU (plain versions)
    cfg, info, batch = make_batch(grid=256)
    cpu_model = model_of(cfg, info, device="cpu")
    card_model = model_of(cfg, info)
    card_model.load_state_dict(cpu_model.state_dict())
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        on_card, _ = count_checked("val eval step float32 grid 256 on the card",
                             make_eval_step(card_model), batch_to_torch(batch), val)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    on_cpu = cost_analysis(make_eval_step(cpu_model), batch_to_torch(batch, "cpu"))
    d_flops = abs(on_card["flops"] / on_cpu["flops"] - 1)
    d_bytes = abs(on_card["bytes_accessed"] / on_cpu["bytes_accessed"] - 1)
    differ = {k: (on_card["op_bytes"].get(k, 0), on_cpu["op_bytes"].get(k, 0))
              for k in set(on_card["op_bytes"]) | set(on_cpu["op_bytes"])
              if on_card["op_bytes"].get(k, 0) != on_cpu["op_bytes"].get(k, 0)}
    print(f"cost val grid 256: card flops {on_card['flops']:.0f}, CPU {on_cpu['flops']:.0f} "
          f"(rel {d_flops:.2e}, limit 1e-4); card bytes {on_card['bytes_accessed']:.0f}, CPU "
          f"{on_cpu['bytes_accessed']:.0f} (rel {d_bytes:.2e}, limit 1e-2); kernels card "
          f"{on_card['kernels']}, CPU {on_cpu['kernels']}; aten ops whose bytes differ (card, "
          f"CPU): {differ}")
    if not (d_flops <= 1e-4 and d_bytes <= 1e-2) or on_card["kernels"] != on_cpu["kernels"]:
        raise RuntimeError(f"cost grid 256: card and CPU counts differ (flops {d_flops}, bytes "
                           f"{d_bytes})")
    del cpu_model, card_model

    # (c) the distillation eval forward and train step, bfloat16, 1440², bs2
    cfg, info, batch = make_batch(TRAIN_YAML)
    bdev = batch_to_torch(batch)
    model, step, _ = build_trainer(torch, TRAIN_YAML, cfg, info, torch.bfloat16, dev)
    fwd = {"expand_rows": 2, "dcn_sample": 3, "conv_block": 4}
    _, fwd_launches = count_checked("distillation eval forward bf16 1440² bs2",
                              make_eval_step(model), bdev, fwd)
    model.train()
    _, step_launches = count_checked("distillation train step bf16 1440² bs2", step, bdev,
                                {**fwd, "dcn_offset_grad": 3, "dcn_input_grad": 3})
    print(f"phase 45 (the cost count): {time.perf_counter() - t_start:.1f} s on {smi}")
    return {k: fwd_launches[k] + step_launches[k] for k in fwd_launches}


def _tensor_paths(tree, path=()):
    """{key path: leaf} of the arrays of a JAX checkpoint's tree (tensors as
    the reader gives them, numpy arrays as the generator does)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _tensor_paths(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _tensor_paths(sub, path + (str(i),)).items()}
    return {path: tree} if hasattr(tree, "shape") else {}


def _generated(tree, epoch, path=()):
    """``tree`` with each tensor replaced by the generator's value of its path
    (``utils/testing.py::jax_ckpt_leaf``, numpy): the fixture made in memory."""
    from radardistill_tpu_torch.utils.testing import jax_ckpt_leaf

    if isinstance(tree, dict):
        return {k: _generated(v, epoch, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_generated(v, epoch, path + (str(i),)) for i, v in enumerate(tree)]
    if hasattr(tree, "shape"):
        return jax_ckpt_leaf(path, tuple(tree.shape), tree.numpy().dtype, epoch)
    return tree


def phase_jax_ckpt(torch, dev, smi, work):
    """Phase 46, the restore of the JAX package's checkpoints (module
    docstring). Returns the launches of (c)'s forward, (d)'s step and the two
    CLIs of (e) and (f)."""
    import shutil

    from radardistill_tpu_torch.convert import (load_jax_variables, optimizer_state_from_jax,
                                                 state_dict_from_jax)
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.train.checkpoint import CheckpointManager
    from radardistill_tpu_torch.train.optim import build_optimizer
    from radardistill_tpu_torch.utils.production import TRAIN_YAML, production_cfg
    from radardistill_tpu_torch.utils.testing import jax_ckpt_count
    from tools import torch_test, torch_train
    from tools.torch_jax_ckpt_read import cpu_name, read_rate
    from tools.torch_nuscenes_tree import make_tree

    t_start = time.perf_counter()
    fixture = ROOT / "tests" / "fixtures" / "jax_run"
    count = jax_ckpt_count(2)

    # (a) the fixture read on this machine, equal to its generator
    for epoch in (1, 2):
        r = read_rate(fixture / f"checkpoint_epoch_{epoch}", repeat=epoch + 1)
        got = _tensor_paths(r["tree"])
        generated = _generated(r["tree"], epoch)
        want = _tensor_paths(generated)
        differ = [k for k in want if got[k].numpy().tobytes() != want[k].tobytes()]
        print(f"jax ckpt: checkpoint_epoch_{epoch} ({r['disk_bytes']} bytes on disk) through "
              f"train/jax_ckpt.py: {r['tensors']} tensors of {r['tensor_bytes']} bytes in "
              f"{', '.join(f'{x:.4f}' for x in r['seconds'])} s, {r['s_per_gb']:.4f} s per GB "
              f"(host CPU {cpu_name()}; {smi}); {len(want) - len(differ)} of {len(want)} "
              f"bit-equal to the generator")
        if differ or len(want) != r["tensors"]:
            raise RuntimeError(f"jax ckpt: epoch {epoch} differs from the generator in "
                               f"{differ[:5]}")
    generated = generated["state"]  # epoch 2's
    del r, got, want
    t_read = time.perf_counter()

    # (b) CheckpointManager.restore into the full-width train-yaml TrainState
    cfg, info, batch = make_batch(TRAIN_YAML)
    model, step_fn, _ = build_trainer(torch, TRAIN_YAML, cfg, info, torch.bfloat16, dev)
    state = step_fn.state
    restored = CheckpointManager(fixture).restore(state)
    memory = state_dict_from_jax(model, generated)
    entries = model.state_dict()
    same = [k for k, v in entries.items() if torch.equal(v.cpu(), memory[k].to(v.dtype))]
    full, _ = production_cfg(TRAIN_YAML)
    in_memory, _ = build_optimizer(full.OPTIMIZATION, model, 1000, model.frozen)
    in_memory.load_state_dict(optimizer_state_from_jax(model, in_memory, generated["opt_state"]))
    moments = [p for p in state.optimizer.params if all(torch.equal(
        state.optimizer.inner.state[p][k], in_memory.inner.state[p][k])
        for k in ("exp_avg", "exp_avg_sq", "step"))]
    print(f"jax ckpt: CheckpointManager.restore of the run directory into "
          f"radar_distill_train.yaml's TrainState on the card: epoch, it "
          f"{restored and restored[1:]}, step {state.step} (the fixture's count {count}); "
          f"{len(same)} of {len(entries)} model entries and the moments of {len(moments)} of "
          f"{len(state.optimizer.params)} trainable parameters equal to the generated tree's")
    if (restored is None or restored[1:] != (2, count) or state.step != count
            or len(same) != len(entries) or len(moments) != len(state.optimizer.params)
            or next(model.parameters()).device != dev):
        raise RuntimeError(f"jax ckpt: restore {restored and restored[1:]}, step {state.step}, "
                           f"entries {len(same)}, moments {len(moments)}")

    # (c) the bf16 distillation eval forward on the restored weights, then on
    # the generated tree's (load_jax_variables' mapping)
    bdev = batch_to_torch(batch)
    model.eval()
    with torch.no_grad():
        model(bdev)  # warm-up
        torch.cuda.synchronize()
        read = reset_launches()
        got = tensor_leaves(model(bdev))
        torch.cuda.synchronize()
        fwd_launches = read()
        load_jax_variables(model, generated)
        want = tensor_leaves(model(bdev))
    check_launches("jax ckpt forward", fwd_launches,
                   {"expand_rows": 2, "dcn_sample": 3, **K1_STAGE1})
    finite = all(not v.is_floating_point() or bool(torch.isfinite(v).all())
                 for k, v in got.items() if not k.startswith("final_box_dicts."))
    equal = [k for k in want if torch.equal(got[k], want[k])]
    print(f"jax ckpt: distillation eval forward bf16, 1440², bs2, on the restored weights: "
          f"launches {fwd_launches}; finite {finite}; {len(equal)} of {len(want)} outputs "
          f"bit-equal to the forward after load_jax_variables of the generated tree")
    if not finite or len(equal) != len(want):
        raise RuntimeError(f"jax ckpt forward: finite {finite}, differing "
                           f"{sorted(set(want) - set(equal))[:8]}")
    del got, want

    # (d) one train step from the restored optimizer; the same update from the
    # optimizer set in memory on the same gradients (the backward's atomics
    # need not repeat bit for bit, the update must)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grads = []
    optimizer, step_method = state.optimizer, state.optimizer.step

    def capture():
        grads[:] = [None if p.grad is None else p.grad.clone() for p in optimizer.params]
        return step_method()

    optimizer.step = capture
    read = reset_launches()
    metrics = step_fn(bdev)
    torch.cuda.synchronize()
    step_launches = read()
    del optimizer.step
    check_launches("jax ckpt train step", step_launches, TRAIN_STEP)
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.load_state_dict(before)
    for p, g in zip(in_memory.params, grads):
        p.grad = g
    in_memory.step()
    differ = [n for n, p in model.named_parameters() if not torch.equal(p.detach(), after[n])]
    moved = sum(not torch.equal(after[n], before[n]) for n, p in model.named_parameters()
                if p.requires_grad)
    loss = float(metrics["loss"])
    print(f"jax ckpt: one train step bf16, 1440², bs2, from the restored optimizer: launches "
          f"{step_launches}; loss {loss:.6f}; step {state.step}; {moved} of "
          f"{len(optimizer.params)} trained parameters moved; the same update from the "
          f"optimizer set in memory (count {in_memory.count}): {len(after) - len(differ)} of "
          f"{len(after)} parameters bit-equal")
    if (differ or loss != loss or state.step != count + 1 or in_memory.count != count + 1
            or moved != len(optimizer.params)):
        raise RuntimeError(f"jax ckpt train step: differing {differ[:5]}, loss {loss}, step "
                           f"{state.step}, moved {moved}")
    del model, step_fn, state, optimizer, in_memory, grads, before, after, memory, bdev, batch
    del generated, metrics
    torch.cuda.empty_cache()
    t_step = time.perf_counter()

    # (e) the train CLI resumes in a copy of the run directory for one step
    tag = "chip_smoke_jax_ckpt"
    argv = ["--cfg_file", str(ROOT / "tools/cfgs/synthetic/production_cert.yaml"),
            "--batch_size", "2", "--workers", "0", "--epochs", "3", "--extra_tag", tag,
            "--max_ckpt_save_num", "1", "--num_epochs_to_eval", "0",
            "--set", "DATA_CONFIG.NUM_SAMPLES", "2"]
    out = Path("output") / torch_train.parse_config(argv)[1].TAG / tag
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(fixture, out / "ckpt")
    read = reset_launches()
    trained = torch_train.main(argv)
    torch.cuda.synchronize()
    train_launches = read()
    check_launches("jax ckpt train CLI", train_launches, TRAIN_STEP)
    left = sorted(p.name for p in (out / "ckpt").iterdir())
    (log,) = out.glob("log_train_*.txt")
    resumed = f"resumed from epoch 2 it {count}" in log.read_text()
    print(f"jax ckpt: tools/torch_train.py --max_ckpt_save_num 1 in a copy of the run "
          f"directory: resumed {resumed}, step {trained.step}, the directory now {left} "
          f"(a file: {(out / 'ckpt' / 'checkpoint_epoch_3').is_file()})")
    if (not resumed or trained.step != count + 1 or left != ["checkpoint_epoch_3"]
            or not (out / "ckpt" / "checkpoint_epoch_3").is_file()):
        raise RuntimeError(f"jax ckpt train CLI: resumed {resumed}, step {trained.step}, {left}")
    del trained
    torch.cuda.empty_cache()
    t_train = time.perf_counter()

    # (f) the eval CLI with --ckpt the JAX directory, on the val yaml
    root = work / "nuscenes_jax_ckpt"
    _, val_infos = make_tree(root, 2, 2)
    read = reset_launches()
    result = torch_test.main(["--cfg_file", str(ROOT / "tools/cfgs/radar_distill/radar_distill_val.yaml"),
                              "--batch_size", "1", "--ckpt", str(fixture / "checkpoint_epoch_2"),
                              "--extra_tag", tag, "--set", *tree_sets(root)])
    torch.cuda.synchronize()
    test_launches = read()
    check_launches("jax ckpt val CLI", test_launches,
                   {k: len(val_infos) * v for k, v in VAL_FORWARD.items()})
    (log,) = (Path("output") / "radar_distill_val" / tag / "eval").glob("log_eval_*.txt")
    line = re.search(r"loaded (\d+) of (\d+) model entries from .*", log.read_text())
    print(f"jax ckpt: tools/torch_test.py --cfg_file radar_distill_val.yaml --ckpt "
          f"checkpoint_epoch_2/, {len(val_infos)} synthetic nuScenes samples, bs1: "
          f"\"{line and line[0]}\"; launches {test_launches}; mAP {result['mAP']:.4f}; the "
          f"phase {time.perf_counter() - t_start:.1f} s on {smi}: (a) {t_read - t_start:.1f} s, (b)-(d) "
          f"{t_step - t_read:.1f} s, (e) {t_train - t_step:.1f} s, (f) "
          f"{time.perf_counter() - t_train:.1f} s")
    if not line or line[1] != line[2] or not 0 <= result["mAP"] <= 1:
        raise RuntimeError(f"jax ckpt val CLI: {line and line[0]}, result {result}")
    return {k: fwd_launches[k] + step_launches[k] + train_launches[k] + test_launches[k]
            for k in fwd_launches}


def main() -> int:
    if not (ROOT / "radardistill_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from radardistill_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    ptxas = cuda_lib.build(ptxas_verbose=True)
    print(f"build: nvcc {' '.join(cuda_lib.NVCC_FLAGS)} x {len(cuda_lib.SOURCES)} sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in ptxas.splitlines():
        # registers, and any wgmma pipeline ptxas had to serialize (C7513)
        if "Used" in line or "Performance Loss" in line:
            print(f"  {line.strip()}")

    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.utils.production import TRAIN_YAML, VAL_YAML

    p1, p1_launches, p2, p2_launches = phase_probes(torch, dev)
    k5 = phase_k5(torch, dev)
    k2 = phase_k2(torch, dev)
    k3, k4 = phase_k34(torch, dev)
    k4["r5_ms_in_turns"], k4["r8_ms_in_turns"] = phase_dcn_r8(torch, dev)
    k1 = phase_k1(torch, dev)
    cudnn_bf16_conv_aside(torch, dev)
    k1_deep = phase_k1_deep(torch, dev)
    k7 = phase_k7(torch, dev)
    k6 = phase_k6(torch, dev)
    k9, k9_launches = phase_k9(torch, dev)

    cfg, info, batch = make_batch()
    none = {"dcn_offset_grad": 0, "dcn_input_grad": 0}  # no backward in a forward
    val_launches = phase_forward_bf16(
        torch, dev, "val path", cfg, info, batch,
        {"expand_rows": 1, "dcn_sample": 3, "conv_block": 0, **none}, 20)
    phase_forward_f32(torch, dev, "val path", cfg, info, batch,
                      {"radar_preds": 1e-4, "radar_x_conv4": 1e-4})
    torch.backends.cudnn.allow_tf32 = True
    raw = make_batch(host_precompute=False)[2]  # the same scene, no host tables
    phase_device_tables(torch, dev, "val path", cfg, info, batch, raw,
                        {"expand_rows": 1, "dcn_sample": 3})
    phase_dense_from(torch, dev, VAL_YAML)

    t0 = time.perf_counter()
    cfg, info, batch = make_batch(TRAIN_YAML)
    print(f"distillation batch (2 x 160000 lidar points, host precompute): "
          f"{time.perf_counter() - t0:.1f} s on the host")
    fwd_launches = phase_forward_bf16(
        torch, dev, "distillation forward", cfg, info, batch,
        {"expand_rows": 2, "dcn_sample": 3, **K1_STAGE1, **none}, 10)
    launches, step_p50 = phase_train_bf16(
        torch, dev, TRAIN_YAML, cfg, info, batch,
        {"expand_rows": 2, "dcn_sample": 3, **K1_STAGE1, **DCN_BACKWARD}, 10)
    raw = make_batch(TRAIN_YAML, host_precompute=False)[2]
    dev_launches, built = phase_device_tables(
        torch, dev, "distillation forward", cfg, info, batch, raw,
        {"expand_rows": 2, "dcn_sample": 3, **K1_STAGE1})
    phase_device_train(torch, dev, TRAIN_YAML, cfg, info, batch, raw)
    k8, k8_launches = phase_k8(torch, dev, built["hp_as"], smi)
    del batch, raw, built
    torch.cuda.empty_cache()
    runtime_launches = phase_runtime(torch, dev, smi, step_p50)
    torch.cuda.empty_cache()
    import tempfile

    k5_dense = phase_k5_dense(torch, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        tree = make_nuscenes_tree(Path(work))
        teacher_launches, teacher_ckpt, t_teacher, dense_resident = phase_teacher_pretrain(
            torch, dev, smi, tree)
        torch.cuda.empty_cache()
        nusc_launches, result_pkl, test_argv, t_nusc = phase_nuscenes(
            torch, dev, smi, tree, step_p50, teacher_ckpt)
        torch.cuda.empty_cache()
        radar_launches, t_radar = phase_radar_baseline(torch, dev, smi, tree, teacher_ckpt)
        torch.cuda.empty_cache()
        phase_teacher_handoff(torch, dev, smi, teacher_ckpt)
        phase_other_dense_topologies(torch, dev, smi)
        t0 = time.perf_counter()
        s2d_launches, s2d_ckpt, _, s2d_weights = phase_s2d_pretrain(torch, dev, smi, tree,
                                                                    dense_resident)
        torch.cuda.empty_cache()
        phase_teacher_handoff(torch, dev, smi, s2d_ckpt)  # the S2D teacher's checkpoint
        phase_s2d_dense_step(torch, dev, smi, s2d_weights)
        t_s2d = time.perf_counter() - t0
        ddp_launches, t_ddp = phase_ddp(torch, dev, smi, Path(work), result_pkl, test_argv)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        remat_launches = phase_remat(torch, dev, smi, tree)
        tile_launches = phase_tile_sparse(torch, dev, smi, tree)
        t_remat_tile = time.perf_counter() - t0
    print(f"phases 26-30, 33-34 (nuScenes, teacher, radar baseline, data-parallel, S2D "
          f"teacher): {t_nusc:.1f} + {t_teacher:.1f} + {t_radar:.1f} + {t_ddp:.1f} + "
          f"{t_s2d:.1f} s")
    torch.cuda.empty_cache()
    k5["dense_vfe"] = k5_dense

    # the teacher's deep chains: the same yaml with BACKBONE_3D overrides
    deep = {"int8_stages5": {"INT8_STAGES": 5}, "fp_stages5": {"INT8_STAGES": 1, "FP_STAGES": 5}}
    chain_expect = {
        "int8_stages5": {"expand_rows": 2, "dcn_sample": 3, "conv_block": 23,
                         "conv_block.wgmma": 18, "conv_block.mma_sync": 5, "chain_conv": 1,
                         "chain_conv.wgmma": 1},
        "fp_stages5": {"expand_rows": 2, "dcn_sample": 3, **K1_STAGE1, "conv_block_fp": 19,
                       "conv_block_fp.wgmma": 19}}
    chain_launches = {}
    for name, over in deep.items():
        cfg, info, batch = make_batch(TRAIN_YAML, backbone_3d=over)
        chain_launches[name] = phase_forward_bf16(
            torch, dev, f"distillation forward {over}", cfg, info, batch, chain_expect[name], 5)
        if name == "int8_stages5":
            phase_train_bf16(torch, dev, TRAIN_YAML, cfg, info, batch,
                             {**chain_expect[name], **DCN_BACKWARD}, 3)
        del batch
        torch.cuda.empty_cache()

    small = dict(grid=512, num_lidar=20000, num_radar=400, num_boxes=10)
    cfg, info, batch = make_batch(TRAIN_YAML, **small)
    teacher = ("x_conv4", "x_conv5", "spatial_features_2d", "spatial_features_2d_8x",
               "lidar_preds")
    phase_forward_f32(torch, dev, "distillation forward", cfg, info, batch,
                      {**{k: 1e-3 for k in teacher}, "radar_preds": 1e-4})
    phase_train_f32(torch, dev, TRAIN_YAML, cfg, info, batch)
    for name, over in deep.items():
        cfg, info, batch = make_batch(TRAIN_YAML, backbone_3d=over, **small)
        t_tol = 5e-2 if name == "int8_stages5" else 1e-3  # see the module docstring
        phase_forward_f32(torch, dev, f"distillation forward {over}", cfg, info, batch,
                          {**{k: t_tol for k in teacher}, "radar_preds": 1e-4},
                          v1_equal=teacher[:4] if name == "int8_stages5" else ())
    fp_rel = phase_fp_teacher_bf16(torch, dev, small)
    worse = {k: v for k, v in fp_rel.items() if not v <= 1.5 * FP_TEACHER_BF16_REL_BEFORE[k]}
    if worse:
        raise RuntimeError(f"FP_STAGES: 5 bf16 teacher: rel-L2 {worse}, more than 1.5 x the "
                           f"mma.sync route's {FP_TEACHER_BF16_REL_BEFORE}")
    k6["teacher_bf16_rel_l2"] = fp_rel

    # the S2D teacher: trained beside the student, its INT8: static routes,
    # K1 at the packed stage 2, K5 in the packed densifies, the gates
    t0 = time.perf_counter()
    cfg, info, batch = make_batch(TRAIN_YAML)
    cfg.FREEZE_PIPELINE = []
    unfrozen_launches, _ = phase_train_bf16(
        torch, dev, TRAIN_YAML, cfg, info, batch,
        {"expand_rows": 2, "dcn_sample": 3, **DCN_BACKWARD}, 5,
        eval_launches={"expand_rows": 2, "dcn_sample": 3, **K1_STAGE1})
    del batch
    torch.cuda.empty_cache()
    route_launches = phase_s2d_routes(torch, dev, small)
    k1["packed_stage2"] = phase_k1_s2d2(torch, dev)
    k5["packed_densify"] = phase_k5_packed(torch, dev)
    phase_gates(torch, dev, smi)
    print(f"phases 35-38 (unfrozen teacher, INT8: static routes, K1 and K5 at the S2D shapes, "
          f"gates): {time.perf_counter() - t0:.1f} s")

    # the last modules: the anchor family, adam and sgd, remat and the
    # tile-sparse backbone (phases 42-43, run above on the tree), the tools
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        anchor_cli_launches, _ = phase_anchor_cli(torch, dev, smi, Path(work))
    anchor_launches = phase_anchor_full(torch, dev, smi)
    phase_optimizers(torch, dev, smi)
    print(f"phases 39-41 (the anchor family's CLIs and tools, at full size, adam and sgd): "
          f"{time.perf_counter() - t0:.1f} s; phases 42-43 (remat, tile-sparse): "
          f"{t_remat_tile:.1f} s")

    # the reference-checkpoint import: a pcdet .pth converted, loaded, run
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        pcdet_launches = phase_pcdet_import(torch, dev, smi, Path(work))
    torch.cuda.empty_cache()
    print(f"phase 44 (the reference-checkpoint import): {time.perf_counter() - t0:.1f} s")

    # the cost count of the eval step and the train step, the kernels' formulas included
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        cost_launches = phase_cost(torch, dev, smi, Path(work))
    torch.cuda.empty_cache()

    # a JAX run's checkpoint: read, restored, run, resumed and evaluated
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        jax_ckpt_launches = phase_jax_ckpt(torch, dev, smi, Path(work))
    torch.cuda.empty_cache()
    print(f"phase 46 (the JAX checkpoint restore): {time.perf_counter() - t0:.1f} s")

    dcn_py = "radardistill_tpu/ops/pallas_dcn.py"
    block_py = "radardistill_tpu/ops/pallas_conv_block.py"
    table = [
        ("expand_rows", "expand.cu", "radardistill_tpu/ops/pallas_expand.py:39", k5),
        ("dcn_sample", "dcn_sample.cu", f"{dcn_py}:213", k2),
        ("conv_block", "conv3x3_wgmma.cu", f"{block_py}:81", k1),
        ("dcn_offset_grad", "dcn_offset_grad.cu", f"{dcn_py}:283", k3),
        ("dcn_input_grad", "dcn_input_grad.cu", f"{dcn_py}:378", k4),
        ("conv_block_fp", "conv3x3_wgmma.cu", f"{block_py}:81", k6),
        ("chain_conv", "conv3x3_wgmma.cu", "radardistill_tpu/ops/pallas_int8_conv.py:64", k7),
        ("conv3x3_wide", "conv3x3_wgmma.cu", "radardistill_tpu/ops/pallas_wide_conv.py:57", k9),
        ("gather_rows_windowed", "gather_win.cu", "radardistill_tpu/ops/pallas_expand.py:130", k8),
        ("conv_probe", "conv3x3_wgmma.cu", "tools/pallas_conv_proto.py:65", p1),
        ("mma_rate", "mma_rate.cu", "tools/mxu_rate.py:53", p2),
    ]
    # `launches`: the train step for the first five; one forward of its own
    # configuration for K6 and K7; one forward + backward of the wrapper for
    # K9; for K8, P1 and P2, which no model calls, the launches of their phase
    # (K8: one pass over the 14 tap gathers; P1, P2: every case of the tables)
    own = {"conv_block_fp": chain_launches["fp_stages5"]["conv_block_fp"],
           "chain_conv": chain_launches["int8_stages5"]["chain_conv"],
           "conv3x3_wide": k9_launches, "gather_rows_windowed": k8_launches,
           "conv_probe": p1_launches, "mma_rate": p2_launches}
    kernels = [{"name": name, "route": "cuda", "source": f"radardistill_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": own.get(name, launches[name]),
                "launches_val": val_launches[name], "launches_forward": fwd_launches[name],
                "launches_int8_stages5": chain_launches["int8_stages5"][name],
                "launches_fp_stages5": chain_launches["fp_stages5"][name],
                "launches_device_tables": dev_launches[name],
                "launches_runtime": runtime_launches[name],
                "launches_nuscenes": nusc_launches[name], "launches_ddp": ddp_launches[name],
                "launches_teacher_pretrain": teacher_launches[name],
                "launches_radar_baseline": radar_launches[name],
                "launches_s2d_teacher_pretrain": s2d_launches[name],
                "launches_teacher_unfrozen": unfrozen_launches[name],
                "launches_anchor_cli": anchor_cli_launches[name],
                "launches_anchor_step": anchor_launches[name],
                "launches_remat": remat_launches.get(name, 0),
                "launches_tile_sparse_forward": tile_launches[name],
                "launches_pcdet": pcdet_launches[name],
                "launches_cost": cost_launches[name],
                "launches_jaxckpt": jax_ckpt_launches[name],
                **{f"launches_static_{r}": route_launches[k][name] for r, k in (
                    ("dense_input", "TABLE_INPUT: false"), ("linear_table", "PACKED_TABLE: false"),
                    ("s2d2", "_S2D2"))},
                "launch_ms": None,
                "mma": MMA_ROUTES.get(name), **rec}
               for name, src, replaces, rec in table]
    # K1: the stage-1 links' time on the old resident mma.sync variant, and
    # the 19 deeper links of INT8_STAGES: 5 on their routes
    kernels[2].update({f"deep_{k}": v for k, v in k1_deep.items()})
    if any(k["launches"] < 1 for k in kernels):
        raise RuntimeError("a kernel was launched on no path: "
                           + str([k["name"] for k in kernels if k["launches"] < 1]))
    keys = ("name", "route", "mma", "source", "replaces", "launches", "launches_val",
            "launches_forward", "launches_int8_stages5", "launches_fp_stages5",
            "launches_device_tables", "launches_runtime", "launches_nuscenes",
            "launches_ddp", "launches_teacher_pretrain", "launches_radar_baseline",
            "launches_s2d_teacher_pretrain", "launches_teacher_unfrozen",
            "launches_static_dense_input", "launches_static_linear_table",
            "launches_static_s2d2", "launches_anchor_cli", "launches_anchor_step",
            "launches_remat", "launches_tile_sparse_forward", "launches_pcdet",
            "launches_cost", "launches_jaxckpt", "max_abs_err",
            "ms", "launch_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "aside_ms",
            "teacher_bf16_rel_l2", "alternating_ms", "alternating_library_ms",
            "k4_route", "repeats_bitwise", "r5_ms_in_turns", "r8_ms_in_turns", "old_route_ms",
            "device_ms",
            "deep_ms", "deep_old_route_ms", "deep_device_ms", "deep_device_old_route_ms",
            "deep_plain_ms", "deep_bound_ms", "dense_vfe", "packed_stage2", "packed_densify")
    print(f"chip_smoke.py: every phase passed; {time.perf_counter() - t_start:.1f} s in all, the "
          f"build included, on {smi}")
    print(json.dumps({"kernels": [{k: kern.get(k) for k in keys} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
