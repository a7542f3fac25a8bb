"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
1. device: needs CUDA; prints torch's version and the card's name and
   power limit (nvidia-smi).
2. build: compiles the seven kernel sources of csrc/ with nvcc, in
   parallel: the fused conv3x3+BN+ReLU (K4), the conv3x3 weight gradient
   (K1's dW), the 2x2 max pool / unpool / phase gather (K3, K2; K3 also
   on int8), the shallow H-pair conv3x3+BN+ReLU (K5), the six layout
   probes (M1-M6), the f32 conv3x3 forward and weight gradient (K4's and
   K1's f32 instances) and the int8 quantized block (``conv3x3_int8``);
   prints ptxas's register and spill lines. Then checks that
   the built libraries choose the same kernel path (K4/K1 fwd and dx, and
   dW: wgmma, packed or narrow) as the wrappers' rules
   (``fused_conv.conv_path``, ``conv_train.wgrad_path``) at every (Cin,
   Cout) the phases below run, that the int8 library picks the wrapper's
   path (``fused_conv_int8.int8_path``), pixel stride and packed K at
   each Cin from -1 to 149, that the
   f32 dW library's tile counts are
   its split rule's (``conv_train.wgrad_f32_*``), that the f32 library
   picks the wrappers' f32 routes ("f32", wgmma; "f32_packed", wgmma with
   9 taps x the narrow side's channels packed; or "f32_narrow") and
   forward tile N, that K5 f32's shared-memory plan at every Cout is
   ``fused_conv_pair.tile_plan``'s, that the K4 narrow path's and the
   narrow dW's plans are ``fused_conv.narrow_fwd_plan``'s and
   ``conv_train.wgrad_narrow_plan``'s, and that a step's launches per path
   are ``PATH_TABLE``'s (and ``path_table(net, dtype=torch.float32)``'s).
3. K4 vs plain: the kernel against its plain PyTorch version in bf16 at
   every distinct conv block shape of UNet and SegNet at 360x480, batch 8:
   error, both times and cuDNN's conv alone (CUDA events); then at
   ``EDGE_SHAPES`` (ragged tiles, a part chunk, Cin 1024, the head tile
   at N = 16 and 24, an input past 2**31 elements; on the packed path a
   ragged stem, a ragged Cin 12, Cin 20 (K 180), a partial Cout tile and
   an output past 2**31 elements; on the narrow path 64->28, a 150-class
   head 64->150, 36->12, 256->12 and 3->36). Then the narrow path at UNet
   9/16's seven narrow blocks (b8) and their dx (b24, ``narrow_timings``):
   each against plain, its device-busy ms beside its bound, plain's and
   the library call's, after ``narrow_checks``: those shapes, the narrow
   edge shapes' forward and dx and ``NARROW_NO_TILE`` (a plan with no
   tile: the first design, the .cu's ``mma_sync``, takes the forward) at
   2x45x61, aligned and on views x[1:], each call's kernel as the C entry
   reports it. Then K1's narrow dW (``csrc/conv3x3_wgrad.cu`` namespace
   ``narrow``): ``narrow_wgrad_checks`` at 2x45x61, aligned and on views,
   at UNet 9/16's narrow dW shapes and ``WGRAD_NARROW_EXTRA`` (64->150,
   64->28, 3->12, 350->12, 72->100 and 100->72 in two M channel tiles,
   340->340 copied as pixel runs), each launched twice bit-equal;
   ``narrow_wgrad_timings`` at UNet 9/16's seven dW at b24 and 64->150:
   device-busy ms beside the bound, plain and cuDNN bf16 wgrad (and the
   first design's reading from before the redesign, printed only), the
   seven summed against ``WGRAD_NARROW_AIM_MS``.
4. K1 vs plain at each model's block shapes at its training batch (UNet
   24, SegNet 32): forward and dx (K4's kernel, unit affine, no ReLU; dx
   reads the weights tap-reversed in place) against F.conv2d and
   torch.nn.grad.conv2d_input, dW against the f32 plain version; kernel,
   plain and cuDNN-bf16-wgrad times, and dx's library time as autograd
   runs it (``conv_train.conv3x3_dgrad_library``: convolution_backward
   with the real channels-last input); the stem's and the head's dW (the
   packed dW path) beside their bounds, cuDNN's bf16 wgrad and the narrow
   path's time before it (``WGRAD_NARROW_MS``); then the three pieces at
   ``EDGE_SHAPES`` (dW on all three paths: the stems, 12->64, 3->24, 64->12
   and the 4.4 GB stem, 64->20 (M 180) on the packed one, 64->28 on the
   narrow one); then
   batch views that start off a 16-byte boundary (``x[1:]`` at 45x61,
   ``misaligned_checks``): K4, K1's three pieces on the packed, wgmma and
   narrow paths and a full-width UNet's eval forward and train step, against
   their plain versions. Then, per model, K4's and K1's times summed over
   its blocks beside their bounds. Then UNet at width 9/16
   (``odd_width_train``): one bf16 training step at b24 from He-scaled
   weights, each K1 call held to plain on its own inputs, K1's launches
   per path (fwd 7, dx 6 and dW 7 narrow; none on K4's first, mma.sync,
   kernel), the loss against the plain path's step; then 10 timed steps
   after 3 warm-ups, printed beside the step before the narrow dW's
   redesign (``ODD_STEP_BEFORE_MS``).
5. UNet serving: a full-width UNet (random He-scaled weights from a seed)
   saved as a reference-named .pth, loaded by ``Predictor.from_checkpoint``
   and serving three requests (8 images, 13 images, 8 images at 480x640
   that are resized on the device). Checks the class maps, that every
   forward launched K4 once per conv block, the logits of the kernel path
   against the plain path, and measures serving throughput. Each forward
   runs 22 blocks on the wgmma path and the stem on the packed one.
6. UNet training: full-width UNet, batch 24, 360x480, bf16, synthetic
   uint8 data resident on the card, the port's ``make_train_step`` with
   the default augmentation, AdamW and OneCycle. One step on the kernel
   path and one on the plain path from the same state: loss, per-leaf
   gradients (norm and difference) and BN running stats must agree
   (``train_parity``); the kernel step must launch 23 forward, 22 dx and
   23 dW kernels, of them 22, 21 and 21 on the wgmma path (the stem's
   forward, the head's dx and the stem's and the head's dW on the packed
   ones). Then 20 timed steps (img/s, step ms,
   MFU, peak memory)
   with a finite loss throughout.
7. K3 and K2 vs plain at SegNet's five pool shapes (K3 at batch 8, K2 at
   batch 32, bf16): pool, unpool and phase gather must equal their plain
   versions bit for bit; also ties on odd sizes (45x61 -> 22x30 -> 45x61,
   bf16 and f32, vector and scalar channel counts) and NaN in a window.
   Kernel, plain and library-call times and the share of the byte bound.
8. SegNet serving: as phase 5 with a full-width SegNet; every forward
   launches K4 26 times (25 on the wgmma path, 1 on the packed one) and
   the K3 pool and unpool 5 times each.
9. SegNet training: as phase 6 at batch 32; the kernel step launches K1
   26/25/26 times (25/24/24 on the wgmma path, 1/1/2 on the packed ones,
   none on the narrow ones), the K2 pool 5, the phase
   unpool 10 (5 unpools and 5 pool backwards) and the phase gather 5
   times. Then SegNet under 32 rows (``segnet_small_checks``, b2, its
   biases and BN stats drawn from the seed): at 24x32 (the fifth pool's
   output empty) and 12x40 (the fourth's too: the fifth stage's blocks on
   an empty map) the bf16 eval logits kernel vs plain within
   ``LOGITS_TOL`` and a train step within phase 9's limits (BN stats NaN
   on both paths where the map is empty), each kernel call against its
   plain version; the launches of the blocks and pools with a pixel only
   (``small_counts``: K4 26 / 20, K3 4 / 3; K1 26/25/26 / 20/19/20, K2
   4/8/4 / 3/6/3).
10. K5 and the per-shape probe: K5 against its plain version in bf16 at
   perf_probe's ``shallow64`` shapes at batch 24 (360x480, 64->64 and
   128->64, with ReLU), the raw ``conv3x3_pair`` with a bias at 64->64,
   five ragged shapes (W not a multiple of 8 or of the 64-column tile,
   Cin 48 and Cout 32, Cin = Cout = 16, Cin 80 and Cout 48) and a
   2.2e9-element input; at each 360x480 shape also against K4 on the same
   inputs, with K5, K4, plain and cuDNN-conv-alone times beside the bound
   and the first design's K5 time (PERF.md).
   Then it drives the slice's entry point, ``python -m
   pytorch_camvid_tpu_torch.perf_probe --pair --shapes shallow64 --k 10``
   (through ``perf_probe.main``): K5 must launch once per probe call and
   no row may exceed its roofline unflagged. Then K5's f32 instance
   (``csrc/conv3x3_f32.cu`` namespace ``k5``, ``pair_f32_checks``): at
   ``PAIR_F32_CHECKS`` (both shallow64 shapes, JAX's test shapes, a ragged
   46x61 and Cin 80 -> 48) at b2, err(K5 f32) and err(K4 f32) on the same
   inputs under phase 14's rule against float64 on the card, beside
   err(plain f32, TF32 off), K5 twice bit-equal, the raw ``conv3x3_pair``
   with a bias at 64->64; K5 f32, K4 f32, plain f32 and cuDNN f32 (TF32
   off; on as a note) at b24 at both 360x480 shapes beside the bound (the
   split product at a third of the TF32 peak); then
   ``perf_probe.probe_shape(pair=True, dtype=torch.float32)`` at both
   shapes: K5 f32 launched once per probe call.
11. Layout probes: drives ``python -m pytorch_camvid_tpu_torch.mosaic_probes``
   (through ``mosaic_probes.main``, the port of ``tools/mosaic_probes.py``):
   all seven probes OK, each kernel launched once per call of its probe
   (the checked call and the tool's timed ones). Then each of the six
   kernels (M1-M6) against its plain version on the tool's inputs and at
   ragged shapes, M6 also at a conv stage (360x488x64 f32): bit for bit,
   M4 (the split-TF32 tensor-core product) within the tool's rtol 1e-3 /
   atol 5e-2, and M4 twice on the same inputs: bit-equal, one launch a
   call; kernel, plain and library device-busy times (the profiler,
   as ``perf_probe`` takes them: at the tool's shapes CUDA events time the
   host's launches), M1-M3 and M5 beside rows_kernel's readings before its
   redesign (``ROWS_BEFORE_MS``); M6's conv-stage time beside its byte
   bound.
12. The training run through the port's entry points (UNet, full width,
   360x480, bf16): CamVid split caches (``data/camvid.py``'s files) from
   ``synthetic_arrays``, 40 train and 13 val images (a ragged last eval
   batch); run A through the train CLI's ``main`` (``-b 10 -e 2 -quiet``,
   8 steps): epochs, steps, the checkpoint files against the cadence rule
   for its mIoUs, K1's launches (8 x 23/22/23, per path as ``PATH_TABLE``)
   and K4's in the eval passes (23 per batch, 2 batches, 2 passes); run B
   through ``loop.run_training`` stopped after 6 batches (``1-preempt``),
   then the train CLI's ``-resume``: step 8 and every leaf of the final
   checkpoint (weights, BN stats, moments, step, generator) equal to run
   A's bit for bit; the eval CLI on A's checkpoint prints A's last mIoU
   and equals the mIoU of the 13 maps computed here;
   ``Predictor.from_checkpoint`` on A's ``.ckpt.npz`` agrees with those
   maps on ``PREDICT_AGREE`` of the pixels; run C, A's configuration
   through ``loop.run_training`` without the CLI's logger, bit-equal to
   A; the epoch wall times of A and C and their img/s beside
   ``bench.measure_train`` at b10, and their eval passes' ms; then
   ``bench.main`` once: its keys, finite rows, each with the card.
   ``chip_faults.py`` plants four faults under these checks.
13. The data side and the LR finder, at 360x480: (1) the LR finder's
   recipe (rotation p 0.5, RandomScale, blur, flip, brightness) and the
   full jitter (brightness, contrast, saturation and hue in a random
   order) at b10 on one set of draws, on the card and on the CPU port:
   masks equal on ``AUG_MASK_EQUAL`` of the pixels, images within the
   recipe's ``AUG_IMAGE_TOL``; ms a batch of each op. (2) The LR finder
   CLI's sweep (``lr_finder.sweep`` on its own argument parsing, no plot)
   on phase 12's CamVid caches, ``-net unet -b 10 -num_it 12`` and ``-net
   segnet -b 10 -num_it 4``: the recorded lrs are the sweep's after each
   step, the losses finite, the end (num_it or the NaN stop) printed, K1's
   and K2's launches a step's times the steps; s/iteration. The sweep
   again with every K1 and K2 call of every step held against its plain
   version on the same inputs (``shadowed_kernels``), its first two steps
   also taken on the plain path from the same state and draws at their
   pool choices: raw losses within ``TRAIN_LOSS_TOL``. (3) VOC caches (40 train, 13 val, 21 classes, letterbox
   rows of 255): ``train -dataset voc2012 -net unet -b 10 -e 1`` with
   every K1 call held against plain on the step's data and each step's
   loss against ``F.cross_entropy`` over the non-255 pixels; the 64->21
   head's forward on the wgmma path's N = 24 head tile, its dx (Cin 21)
   and dW (Cout 21) on the packed ones (once a step each, K4 once an eval
   batch; none on the narrow ones: ``path_counts(net, steps, 21)``);
   ``eval -dataset voc2012`` on its checkpoint prints the loop's mIoU.
   (4) Run A again with ``-loader host``: all 347 leaves bit-equal to run
   A's, every gather native; both runs' epoch img/s and the gather's ms a
   batch; run C's configuration with the host loader through
   ``loop.run_training`` as well, bit-equal, its epochs beside run C's. (5)
   The 64->21 head's K1 fwd, dx and dW at b10 and b24 against cuDNN's bf16
   calls and their bounds, beside the narrow paths' times before
   (``HEAD_NARROW_MS``).
   ``chip_faults.py`` plants faults under (1)-(4).
   Phases 12 and 13 pass ``-dtype bfloat16`` to the CLIs (their default
   is float32, as the JAX CLIs').
14. f32 on the card, the JAX CLIs' default numerics: (1) K4 and K1's
   forward, dx and dW at float32 (``csrc/conv3x3_f32.cu``, split-TF32
   products: the wgmma route "f32"; the packed route "f32_packed" for the
   stem's forward and dW and VOC's 21-channel dx and dW; the mma.sync
   route "f32_narrow" for what neither takes, no model's) at every
   distinct block shape of both models at b2, at ``F32_EDGE`` (64->21,
   ragged 45x61 tiles, the stem, the head, and 23->64 and 3->21 on
   "f32_narrow"), on a misaligned view ``x[1:]`` and (K4) on an input
   past 2**31 elements: err(kernel) <= max(4 err(plain f32, TF32 off),
   2e-6 max|f64|), err the max distance to the same function in float64
   on the card; the f32 dW bit-equal on two launches; then their times at
   b10 beside the plain f32 version, the library call with TF32 off and
   on, the bound (the FLOPs at a third of the TF32 peak, or the f32
   bytes) and, for a piece on "f32_packed", the narrow kernel's time on
   the same inputs, summed per model, with each piece's route; VOC's
   64->21 head timed too (``F32_EXTRA_TIMED``). (2) The train CLI with no
   -dtype (float32), UNet and SegNet, b10, one epoch of 4 steps on phase
   12's caches: every K1 and K2 call against plain on its inputs
   (``F32_SHADOW_TOL``), the first step also on the plain f32 path from
   the same state and draws (``F32_TRAIN_*``), launches per step all on
   the f32 kernels (23/22/23, 26/25/26, of them 1/0/1 on "f32_packed",
   none on "f32_narrow"; K2 5/10/5); run B stopped after 2 batches and
   resumed with ``-resume``: every leaf equal to run A's; VOC's train and
   eval CLIs at f32 (``voc_checks`` at float32: the head's dx and dW on
   "f32_packed", none on "f32_narrow"). (3) The eval
   CLI at its default on A's checkpoint: the loop's mIoU; K4 at f32 23
   (UNet) or 26 (SegNet, with K3's pool and unpool 5 each) times a batch.
   (4) ``predict.main`` at its default (f32) on a val image with UNet's
   checkpoint (cv2 stood in by ``Cv2Stand``: the card's host has none):
   its map against the plain f32 path's on ``PREDICT_AGREE`` of the
   pixels. (5) The LR finder at its default, UNet, 4 iterations: finite
   losses, K1's launches at f32. (6) UNet's b10 f32 train step, kernel
   against plain (TF32 off): ms, img/s, peak memory.
   ``chip_faults.py`` plants six faults under (1).
15. Stage rematerialization and the data-side CLIs: (1) for UNet b24 and
   SegNet b32 (bf16, 360x480, He-scaled, the bench step) one step without
   remat and one with (``make_train_step(remat=True)``: each stage's conv
   blocks recomputed in the backward) from one state on one batch: loss,
   every gradient leaf and every buffer bit for bit, each BN count
   advanced by exactly one; the remat step launches K1's forward twice a
   block (46/22/23 and 52/25/26, ``remat_path_counts``) and K2 5/10/5, and
   each of its kernel calls, the recompute's included, is held against its
   plain version (``shadowed_kernels``, phase 9's limits). (2) Both steps
   through ``bench.measure_train(remat=)``: the median of 5 steps after 2
   warm-ups and ``torch.cuda.max_memory_allocated``; the remat peak at
   most ``REMAT_PEAK_RATIO`` (0.75) of the other. (3) The train CLI with
   ``-remat`` at its default (f32), phase 14's UNet arguments and data:
   its per-step losses equal phase 14's run's bit for bit, K1's launches
   on "f32" and "f32_packed" only. (4) ``benchmark -synthetic`` (125
   epochs) and ``batch_sweep -net unet -batches 24 -steps 3 -remat``
   through their ``main``s: JAX's line format and sample counts; one
   sweep row with the card, then the same sweep skipped as recorded.
   ``chip_faults.py`` plants a recompute that updates the BN stats again
   under (1).
16. int8 serving (``ops/quant.py``, ``csrc/conv3x3_int8.cu``): (1) the
   int8 build's ptxas warnings on a line of their own (no C7519, an
   injected warpgroup.arrive, may remain; each C7512 with its instance);
   conv3x3_int8 against its plain version, bit for bit in its int8, bf16
   and f32 output modes, at every block shape that UNet and SegNet
   quantize (Cout >= 64) at 360x480, b8, at ``INT8_EDGE`` (the 12- and
   21-class heads in int8, Cout 24 and 200, Cin 192), at ``INT8_CIN48``
   (a width-3/4 model's Cin 48 and 96, which the wgmma path takes with
   TMA's zeros past Cin) and on the batch views of ``INT8_VIEW`` (the
   stem's 45x61 ``x[1:]`` off a 16-byte boundary); at ``INT8_ODD`` (Cin
   33, 36, 40, 72 and 100: x at the padded pixel stride), there also with
   the channels past Cin set to 1 in x's buffer and in the packed weights
   (``poisoned``), their launches on the wgmma path, and the packed
   weights' zero columns (``padded_weights_ok``); a Cin 0 raises; the
   padded route's cost at ``INT8_ODD_TIMED`` (device-busy: the kernel on
   a padded x, from a contiguous one with the wrapper's copy pass, the
   copy alone, K4 bf16; none under its bound, ``within_bound``); per
   shape the kernel's ms in the int8 and bf16 output modes
   (CUDA events), the plain version's, the bound (operations at 1,979
   TOPS or bytes), K4 bf16, cuDNN's bf16 conv and ``torch._int_mm`` on a
   prebuilt im2col matrix (the GEMM alone); sums over each model's
   quantized blocks in their output modes; the input quantize kernel
   (bf16 and f32 in, int8 out) bit for bit at ``INT8_QUANTIZE`` (its
   (N,H,W,C) results at the block's pixel stride) and a
   batch view, ties planted, and timed over each model's quantized inputs
   beside stock ops and its byte bound. (2) K3's pool and unpool on
   int8 values with ties at SegNet's five pool shapes and at C 40, bit for
   bit; at the five stages the int8 and the bf16 pair's device-busy ms
   (``perf_probe.time_op``, over inputs that read cold from HBM,
   ``cold_inputs``; none under the byte bound) beside the wrapper's
   CUDA-events ms, the plain pair's, the library's and the byte bound, per
   stage and summed.
   (3) Full-width UNet and SegNet
   (``he_model``, seed 0) in a b8 Predictor, ``quantize_int8`` on 8
   frames, ``predict`` on 24: conv3x3_int8 once per quantized block a
   forward (22 and 25; the stem on the packed path), K4 once (the float
   head), K3's flat pair 5 times (SegNet, on int8), each int8 launch
   bit-equal to plain on its own input (``shadowed_int8``; the blocks'
   input quantize kernel, once for each block whose input comes float,
   13 and 1 a forward, inside the same check), the kernel
   path's logits within ``LOGITS_TOL`` of the plain path's; ms a forward
   and img/s beside the bf16 Predictor's, and the share of pixels where
   the two class maps agree (printed, not held: random weights). (3b)
   SegNet at width 5/8 and UNet at 9/16 (``INT8_ODD_WIDTH``) the same
   way on 8 frames (``odd_width_slice``): their blocks of Cin 40, 36 and
   72 on the wgmma path, every int8 launch bit-equal to plain and every
   K4 launch within ``KERNEL_TOL`` of plain on its own inputs
   (``shadowed_k4``), the logits and the Predictor's maps bit-equal to
   the path whose int8 pieces run plain (the all-plain path printed
   beside), the int8 and bf16 forwards' ms. (4) The
   eval CLI's ``-int8`` at its f32 default and the serve CLI's ``-int8``
   on phase 12's caches and run A's checkpoint: finite figures, the int8
   mIoU beside the float one, launches, every eval int8 launch bit-equal
   to plain; and phase 12's ``bench.main`` int8 keys.
   ``chip_faults.py`` plants nine faults under (1) and (2). The quantize
   kernel's sums also time the library's call,
   ``torch.quantize_per_tensor`` (on an f32 copy), and print the share of
   its bytes equal to the kernel's.
17. Multi-GPU (``parallel/``): (a) two ranks sharing cuda:0 (gloo,
   spawned by ``parallel/launch.py::spawn``) take the data-parallel step
   (``parallel.jit_train_step``: sync-BN, the global loss, one summed f32
   gradient bucket) of full-width UNet at b24 and SegNet at b32, each
   rank on its half, from the He-scaled state on the same images and
   draws as the one-process step here: loss within ``TRAIN_LOSS_TOL``,
   the all-reduced gradients within phase 6's limits (UNet; SegNet's
   printed, as phase 9), BN stats within ``TRAIN_STAT_TOL``; the same
   with 255 over half of the first rank's rows, where the ranks' loss
   denominators differ (the grad norms within ``DP_UNEVEN_GRAD_TOL``),
   and at float32 on ``DP_F32_BATCH`` images with and without those rows
   under phase 14's f32 limits (``DP_STEPS``); the ranks' every leaf
   bit-equal after two steps (SHA-256), K1 23/22/23 and 26/25/26 a rank on ``PATH_TABLE``'s paths,
   K2 5/10/5 with every SegNet kernel call held against its plain version
   (``shadowed_kernels``); each rank's step ms, its gradient all-reduce
   alone and its peak memory. (b) A one-rank NCCL group: the data-parallel
   UNet step bit-equal to the step without, and both timed in turns. (c)
   Where two cards are visible, (a) over NCCL on both; else one line
   says it was not run. (d) ``python -m pytorch_camvid_tpu_torch.train
   -multihost`` in two processes set up by ``PCT_*`` on the one card
   (gloo; a card each and NCCL where there are two), UNet b10 on phase
   12's data for an epoch and its eval pass: rank 1 prints no
   epoch line, one run folder, the ranks' states bit-equal (the loop's
   check), mIoU within 0.02 and the parameter checksum within rtol 1e-3 of
   the same run in one process, and the two-rank checkpoint resumed on one
   rank with its step and every leaf as saved. (e) UNet's first encoder
   stage (3->64->64, pool) at b8, H split over the two ranks of (a)
   (``parallel/spatial.py``, a halo of two rows each side, K4): bit-equal
   to the unsharded stage on K4, or within ``KERNEL_TOL``. (f)
   ``Predictor(devices=["cuda:0", "cuda:0"])`` at b8, UNet and SegNet:
   class maps bit-equal to one device's, K4 (and K3) launched once a block
   (pool) by each replica on its half of every batch.
   ``chip_faults.py`` plants four faults in the ranks of (a) and (e).
18. Export (``Predictor.export_program``, ``ops/library.py``'s ``camvid::``
   ops, ``torch.export``), full width, 360x480, He-scaled weights from
   seed 0: (a) a bf16 UNet Predictor at b8 that has not predicted exports
   its program (seconds, MB; op nodes: K4 23 and no library conv or pool),
   then predicts: its maps bit-equal to a second Predictor's that never
   exported; the program loaded here: one run launches K4 23 times (22
   wgmma, 1 packed), its maps bit-equal to the live ones, its forward ms
   beside the live ``_forward``'s. (b) SegNet bf16 b8: K4 26 (25, 1), K3's
   pool and unpool 5 each. (c) The int8 UNet (``quantize_int8`` on 8
   frames, as phase 16): 22 int8 blocks, 13 quantizes, K4 once (the head).
   (d) The f32 UNet at b4 (K4 on "f32" 22, "f32_packed" 1). Then one
   process that imports ``ops.library`` and nothing of the models, the
   Predictor or jax loads the four programs on the card: each run's
   launches as above and maps bit-equal to the live Predictor's. (e) (a)'s
   program loaded on the CPU runs the plain versions: its maps agree with
   the card's on ``EXPORT_CPU_AGREE`` of the pixels. (f) ``dump_program``
   of UNet's train-mode forward at b10 bf16 (seconds; K1's forward op 23
   times, no launch, no state moved); ``python -m
   pytorch_camvid_tpu_torch.export_program`` on run A's checkpoint prints
   "roundtrip verified" at 100.00%; ``export_torch`` writes a ``.pth``
   equal to the checkpoint's weights that loads strictly; run A's
   ``program_unet.txt`` names K1's forward op 23 times (phase 12's resume
   ran with the dump in both runs). (g) In (a), the eager forward's ms
   through the launchers (the route eager calls take) and through the op,
   in turns. ``chip_faults.py`` plants three faults under (a) and (c).
In phases 8 and 9 the plain path replays the kernel path's pool choices
(``recorded_choices``, ``replayed_choices``): a 1-ulp difference between
the two paths' convs would otherwise flip the choice of near-tied windows
and move values across the unpool. So the two paths differ only by the
convs' rounding, and logits, loss and BN stats are held to UNet's limits.
In phases 6 and 9 every kernel call of the kernel step is also held
against its plain version on the same inputs (``shadowed_kernels``); that
is SegNet's gradient check (``GRADS_END_TO_END``). ``chip_faults.py``
plants faults that these checks must catch.

The last line is {"ok": true, "device": {...}}; the line before it names
the card and its power limit; the line before that is the per-kernel JSON
(23 entries: K4, K1's three pieces, the five pool kernels, K5 and its f32
instance (64->64's readings, 128->64's under ``128_64``), M1-M6, the
f32 instances of K4 and K1's three pieces, conv3x3_int8 with its
yardsticks and SegNet's sums, and the input quantize kernel; K3's flat
pair also gives its int8 times,
``int8``; K4's and K1's also give
their launches on each path, ``path_launches``; K1's also the 64->21
head's times, ``head_64_21``; the f32 ones the library call's time with
TF32 on, ``library_tf32_ms``, and their launches on each f32 route,
``path_launches``; K1's pieces their launches on each path in phase 15's
UNet remat step, ``remat_path_launches``, and each rank's launches in
phase 17 (a), ``dp_rank_launches``; the quantize kernel its
``library_ms`` and ``library_equal``; K4, its f32 instance, K3's flat
pair, conv3x3_int8 and the quantize kernel the launches of one run of each
phase-18 program that holds them in the loader process,
``program_launches``).
Imports neither jax nor cv2.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import glob
import importlib
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_camvid_tpu_torch import (batch_sweep, bench, f32_variants,
                                     lr_finder, mosaic_probes, parallel,
                                     perf_probe)
from pytorch_camvid_tpu_torch import benchmark as benchmark_cli
from pytorch_camvid_tpu_torch import eval as eval_cli
from pytorch_camvid_tpu_torch import export_program as export_program_cli
from pytorch_camvid_tpu_torch import export_torch as export_torch_cli
from pytorch_camvid_tpu_torch import predict as predict_cli
from pytorch_camvid_tpu_torch import serve as serve_cli
from pytorch_camvid_tpu_torch import train as train_mod
from pytorch_camvid_tpu_torch.config import settings
from pytorch_camvid_tpu_torch.data import augment, camvid, native, voc2012
from pytorch_camvid_tpu_torch.data.normalize import to_tensor_normalize
from pytorch_camvid_tpu_torch.data.synthetic import synthetic_arrays
from pytorch_camvid_tpu_torch.models import get_model, spec_from_state_dict
from pytorch_camvid_tpu_torch.models.common import halvings
from pytorch_camvid_tpu_torch.models.segnet import segnet_spec
from pytorch_camvid_tpu_torch.models import unet as unet_model
from pytorch_camvid_tpu_torch.ops import (conv_train, cuda_build, fused_conv,
                                          fused_conv_int8, fused_conv_pair,
                                          fused_pool, pooling, quant)
from pytorch_camvid_tpu_torch.ops import conv as conv_ops
from pytorch_camvid_tpu_torch.ops import layout_probes as lp
from pytorch_camvid_tpu_torch.ops import library
from pytorch_camvid_tpu_torch.ops.metrics import (confusion_matrix,
                                                  iou_from_confusion)
from pytorch_camvid_tpu_torch.parallel import launch, multihost, spatial
from pytorch_camvid_tpu_torch.serving import Predictor
from pytorch_camvid_tpu_torch.train import TrainState, loop
from pytorch_camvid_tpu_torch.train import checkpoint as ckpt
from pytorch_camvid_tpu_torch.train import steps as steps_mod
from pytorch_camvid_tpu_torch.utils import summary

train_cli = importlib.import_module("pytorch_camvid_tpu_torch.train.__main__")

KERNEL_TOL = 2e-2   # max|kernel - plain| / max|plain|, one bf16 block
LOGITS_TOL = 5e-2   # max|kernel - plain| / max|plain| logits, 23-26 blocks
K1_TOL = {"fwd": 2e-2, "dx": 2e-2, "wgrad": 1e-2}  # / max|plain|, per shape
# training, kernel path vs plain path after one step from the same state
# (both bf16, SegNet's pools at the same choices; the two differ in
# accumulation order and so in bf16 roundings, compounded through 23-26
# blocks forward and back). Each limit is set from the H100 readings in
# PERF.md, where planted faults fail them (chip_faults.py).
TRAIN_LOSS_TOL = 1e-4        # |loss_k - loss_p| / loss_p
TRAIN_GRAD_TOL = 5e-2        # per leaf |norm(g_k) - norm(g_p)| / norm(g_p)
# per leaf norm(g_k - g_p) / norm(g_p): catches a permuted or flipped dW,
# whose norm is right; BN-parameter gradients (sums that cancel) carry up
# to 0.17 of rounding noise, so this limit is only ~3x the reading
TRAIN_GRAD_DIFF_TOL = 5e-1
TRAIN_STAT_TOL = 1e-3        # per BN buffer max|k - p| / max|p|
# whether the per-leaf gradient limits apply end to end. SegNet's do not:
# with no skip connection, the two paths' 1-ulp differences grow through
# its backward (PERF.md: a conv weight's |grad diff| reads 0.006 at the
# head, 0.35 six blocks back, 0.62 at the stem), so its gradients are held
# call by call on the step's own data (``shadowed_kernels``) instead
GRADS_END_TO_END = {"unet": True, "segnet": False}
BATCH, HW = 8, (360, 480)
TRAIN_BATCH = {"unet": 24, "segnet": 32}   # bench.py's headline batches
TRAIN_STEPS = 20
SEED = 0
POOLS = {"unet": 0, "segnet": 5}   # K3 / K2 pools per forward
# K5 (phase 10): perf_probe's shallow64 family at its default batch; then
# ragged shapes: W = 61 (not a multiple of 8, a last tile of 61 columns),
# 30 (one partial tile), H % 4 == 2 (a last tile of one pair) and Cin 48
# (a part patch stage) with Cout 32; an input past 2**31 elements (64-bit
# offsets); the contract's minimum, Cin = Cout = 16 (TMA's zero fill past
# Cin, the store's clipping past Cout); Cin 80, past one 64-channel weight
# tile and not a multiple of it, with a partial Cout tile (48)
PAIR_BATCH = 24
PAIR_SHAPES = ((360, 480, 64, 64), (360, 480, 128, 64))
PAIR_EXTRA = ((1, 46, 61, 64, 64), (2, 22, 30, 128, 64), (1, 46, 61, 48, 32),
              (100, 360, 480, 128, 64), (2, 46, 61, 16, 16),
              (2, 22, 30, 80, 48))
# K5's first design (mma.sync, cp.async) at PAIR_SHAPES, b24, ms, on an
# NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6): printed beside this run's
PAIR_FIRST_MS = {64: 1.262, 128: 2.625}
PAIR_PROBE_K = 10
# phases 3 and 4: both conv sources at ragged and edge shapes, (N, H, W,
# Cin, Cout): partial tiles (H 45, W 61), 44x60 and 22x30, a part chunk
# (Cin 48) with Cout 32, Cin 1024, the head tile at N = 16 (Cout 12 and
# 16; the dx, Cin 12 into 64, takes the packed path) and N = 24 (Cout 24,
# and 64->20, whose dx, Cin 20 into 64, takes the packed path at K = 180),
# an input past 2**31 elements (64-bit offsets); the packed path at a
# ragged stem, a ragged Cin 12 forward, a partial Cout tile and an output
# past 2**31 elements; 64->28, whose forward, dx and dW stay on the narrow
# paths; on the narrow path a 150-class head (64->150: N split in two
# tiles of 80; its dx 150->64 in two of 32), UNet 9/16's head 36->12 (its
# dx 12->36), 256->12 (Cin past the head tile's 128) and 3->36 (UNet
# 9/16's stem). dW: the stems, 12->64, 3->24, 64->12, 64->20 (M = 180),
# 256->12 and the 4.4 GB stem on the packed path, 64->28, 64->150, 36->12
# and 3->36 on the narrow one, the rest on the wgmma one
EDGE_SHAPES = ((2, 45, 61, 64, 64), (2, 44, 60, 512, 256),
               (2, 22, 30, 512, 512), (2, 46, 61, 48, 32),
               (2, 22, 30, 1024, 512), (2, 45, 61, 64, 12),
               (2, 45, 61, 64, 16), (2, 45, 61, 64, 24),
               (100, 360, 480, 128, 64), (2, 45, 61, 3, 64),
               (2, 45, 61, 12, 64), (2, 45, 61, 3, 24),
               (200, 360, 480, 3, 64), (2, 45, 61, 64, 20),
               (2, 45, 61, 64, 28), (2, 45, 61, 64, 150),
               (2, 45, 61, 36, 12), (2, 45, 61, 256, 12),
               (2, 45, 61, 3, 36))
# K4/K1 launches per path of one forward ("fwd") and one training step
# (``path_table``): the body's blocks on the wgmma paths; the stem's
# forward and dW on the packed ones (no dx: its input is the image); the
# head's pieces by its class count (``HEAD_PATHS``): 12 classes (CamVid)
# put its forward on the wgmma path's head tile (N = 16) and its dx (Cin
# 12) and dW on the packed ones; 21 (VOC) likewise, its forward at N = 24
# and its dx (Cin 21, K = 189) and dW (M = 189) within the packed paths'
# 192
N_BLOCKS = {"unet": 23, "segnet": 26}
HEAD_PATHS = {12: {"fwd": "wgmma", "dgrad": "packed", "wgrad": "packed"},
              21: {"fwd": "wgmma", "dgrad": "packed", "wgrad": "packed"}}
# at float32 the body's blocks take the f32 wgmma route ("f32"), the
# stem's forward and dW (Cin 3) the packed one ("f32_packed"), the head's
# pieces by its class count: 12 all three on "f32" (the forward's N tile
# 16, the dx's Cin 12, the dW's N tile 16), 21 its forward on "f32" (N
# tile 24) and its dx (Cin 21, K 189 of 192) and dW (Cout 21) on
# "f32_packed"; no model path takes "f32_narrow"
F32_HEAD_ROUTES = {12: {"fwd": "f32", "dgrad": "f32", "wgrad": "f32"},
                   21: {"fwd": "f32", "dgrad": "f32_packed",
                        "wgrad": "f32_packed"}}


def path_table(net: str, classes: int = 12,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """K4/K1 launches per path of one forward and one training step at
    ``dtype``, as the comments above say: the body's blocks on the wgmma
    path (bf16) or route (f32), the stem's forward and dW on the packed
    path or route (its dx is not taken), the head's by its class
    count."""
    nb = N_BLOCKS[net]
    f32 = dtype == torch.float32
    body, stem = ("f32", "f32_packed") if f32 else ("wgmma", "packed")
    table = {piece: dict.fromkeys(fused_conv.ROUTES, 0)
             for piece in ("fwd", "dgrad", "wgrad")}
    for piece in table:
        table[piece][body] = nb - 2
    table["fwd"][stem] += 1
    table["wgrad"][stem] += 1
    for piece, path in (F32_HEAD_ROUTES if f32 else HEAD_PATHS)[
            classes].items():
        table[piece][path] += 1
    return table


PATH_TABLE = {net: path_table(net) for net in N_BLOCKS}
# the stem's and the head's dW on the narrow path before the packed one
# (UNet b24, 360x480, ms; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md),
# printed beside this run's
WGRAD_NARROW_MS = {("unet", 3, 64): 0.549, ("unet", 64, 12): 1.576}
# VOC's 64->21 head on the narrow paths before the head tile and the
# packed paths took it ({piece: {batch: ms}} at 360x480; NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md), printed beside this run's
HEAD_NARROW_MS = {"fwd": {10: 0.978, 24: 2.305},
                  "dx": {10: 0.975, 24: 2.315},
                  "wgrad": {10: 1.082, 24: 2.485}}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


bound_ms, conv_bound = bench.bound_ms, bench.conv_bound


def all_block_shapes():
    """Every distinct conv block shape of both models at HW."""
    return list(dict.fromkeys(bench.block_shapes("unet", HW)
                              + bench.block_shapes("segnet", HW)))


def phase_kernels(gen: torch.Generator):
    """K4 vs plain at each distinct block shape; returns per shape
    (err, kernel ms, plain ms, cuDNN conv ms)."""
    dev = torch.device("cuda")
    res = {}
    for shape in all_block_shapes():
        h, w, cin, cout = shape
        x, wt = conv_inputs(gen, BATCH, h, w, cin, cout)
        a = torch.rand(cout, generator=gen, device=dev) + 0.5
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        got = fused_conv.conv3x3_bn_relu(x, wt, a, b)
        ref = fused_conv.conv3x3_bn_relu_plain(x, wt, a, b)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        ms = cuda_ms(lambda: fused_conv.conv3x3_bn_relu(x, wt, a, b))
        plain_ms = cuda_ms(
            lambda: fused_conv.conv3x3_bn_relu_plain(x, wt, a, b))
        # the plain version's cuDNN conv alone, without its epilogue
        xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
        conv_ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=1))
        tflops = 2 * 9 * BATCH * h * w * cin * cout / ms / 1e9
        print(f"kernel {BATCH}x{h}x{w} {cin}->{cout}: max|err| {err:.4g} "
              f"/ max|ref| {scale:.4g} = {err / scale:.3g} "
              f"(tol {KERNEL_TOL}); kernel {ms:.4f} ms "
              f"({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms "
              f"(its cuDNN conv alone {conv_ms:.4f} ms)", flush=True)
        check(err <= KERNEL_TOL * scale, f"kernel vs plain at {shape}")
        res[shape] = (err, ms, plain_ms, conv_ms)
    for n, h, w, cin, cout in EDGE_SHAPES:
        x, wt = conv_inputs(gen, n, h, w, cin, cout)
        a = torch.rand(cout, generator=gen, device=dev) + 0.5
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        err, scale = _rel_err(fused_conv.conv3x3_bn_relu(x, wt, a, b),
                              fused_conv.conv3x3_bn_relu_plain(x, wt, a, b))
        print(f"kernel {n}x{h}x{w} {cin}->{cout} "
              f"({fused_conv.conv_path(cin, cout)} path): max|err| "
              f"{err:.4g} / max|ref| {scale:.4g} = {err / scale:.3g} (tol "
              f"{KERNEL_TOL})", flush=True)
        check(err <= KERNEL_TOL * scale,
              f"kernel vs plain at {(n, h, w, cin, cout)}")
        del x, wt
        torch.cuda.empty_cache()
    return res


def conv_inputs(gen: torch.Generator, n, h, w, cin, cout) -> tuple:
    """x (n,h,w,cin) and He-scaled HWIO weights, bf16 on the card."""
    x = torch.randn(n, h, w, cin, generator=gen, device="cuda").to(
        torch.bfloat16)
    wt = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda")
          * (2.0 / (9 * cin)) ** 0.5).to(torch.bfloat16)
    return x, wt


def k1_edge_checks(gen: torch.Generator) -> None:
    """K1's forward, dx and dW against their plain versions at
    ``EDGE_SHAPES`` (K1_TOL)."""
    for n, h, w, cin, cout in EDGE_SHAPES:
        x, wt = conv_inputs(gen, n, h, w, cin, cout)
        g = torch.randn(n, h, w, cout, generator=gen, device="cuda").to(
            torch.bfloat16)
        line = [f"K1 {n}x{h}x{w} {cin}->{cout}:"]
        for name, kern, plain, path in (
                ("fwd", lambda: conv_train.conv3x3_fwd(x, wt),
                 lambda: conv_train.conv3x3_train_plain(x, wt),
                 fused_conv.conv_path(cin, cout)),
                ("dx", lambda: conv_train.conv3x3_dgrad(g, wt),
                 lambda: conv_train.conv3x3_dgrad_plain(g, wt),
                 fused_conv.conv_path(cout, cin)),
                ("wgrad", lambda: conv_train.conv3x3_wgrad(x, g),
                 lambda: conv_train.conv3x3_wgrad_plain(x, g),
                 conv_train.wgrad_path(cin, cout))):
            err, scale = _rel_err(kern(), plain())
            line.append(f"{name} ({path}) {err / scale:.3g} (tol "
                        f"{K1_TOL[name]});")
            check(err <= K1_TOL[name] * scale,
                  f"K1 {name} at {(n, h, w, cin, cout)}")
        print(" ".join(line), flush=True)
        del x, wt, g
        torch.cuda.empty_cache()


def misaligned_checks(gen: torch.Generator) -> None:
    """Batch views ``x[1:]`` at 45x61 whose data starts off a 16-byte
    boundary (a Cin = 3 bf16 sample is 16,470 bytes): the wrappers realign
    them with a copy. K4 and K1's pieces on the packed path (3->64), the
    wgmma path (64->64) and the narrow path (36->36, UNet 9/16's) against
    their plain versions, then a full-width
    UNet: its eval logits (LOGITS_TOL) and a train step's loss (finite)
    and launches."""
    for cin, cout in ((3, 64), (64, 64), (36, 36)):
        x, wt = conv_inputs(gen, 3, 45, 61, cin, cout)
        g = torch.randn(3, 45, 61, cout, generator=gen, device="cuda").to(
            torch.bfloat16)
        xv, gv = x[1:], g[1:]
        if cin in (3, 36):
            check(xv.data_ptr() % 16 != 0, f"the Cin {cin} view is misaligned")
        a = torch.rand(cout, generator=gen, device="cuda") + 0.5
        b = torch.randn(cout, generator=gen, device="cuda") * 0.1
        line = [f"misaligned x[1:] 2x45x61 {cin}->{cout}:"]
        for name, kern, plain, tol in (
                ("K4", lambda: fused_conv.conv3x3_bn_relu(xv, wt, a, b),
                 lambda: fused_conv.conv3x3_bn_relu_plain(xv, wt, a, b),
                 KERNEL_TOL),
                ("K1 fwd", lambda: conv_train.conv3x3_fwd(xv, wt),
                 lambda: conv_train.conv3x3_train_plain(xv, wt),
                 K1_TOL["fwd"]),
                ("K1 dx", lambda: conv_train.conv3x3_dgrad(gv, wt),
                 lambda: conv_train.conv3x3_dgrad_plain(gv, wt),
                 K1_TOL["dx"]),
                ("K1 dW", lambda: conv_train.conv3x3_wgrad(xv, gv),
                 lambda: conv_train.conv3x3_wgrad_plain(xv, gv),
                 K1_TOL["wgrad"])):
            err, scale = _rel_err(kern(), plain())
            line.append(f"{name} {err / scale:.3g} (tol {tol});")
            check(err <= tol * scale, f"{name} on x[1:] at {cin}->{cout}")
        print(" ".join(line), flush=True)
    model = bench.he_model("unet", torch.Generator().manual_seed(SEED)).cuda()
    x = torch.randint(0, 256, (3, 45, 61, 3), generator=gen, device="cuda",
                      dtype=torch.uint8)
    xn = to_tensor_normalize(x, settings.MEAN, settings.STD,
                             torch.bfloat16)[1:]
    check(xn.data_ptr() % 16 != 0, "the model's input view is misaligned")
    model.eval()
    with torch.inference_mode():
        err, scale = _rel_err(model(xn), model(xn, plain=True))
    model.train()
    reset_counts()
    loss = model(xn).float().square().mean()
    loss.backward()
    torch.cuda.synchronize()
    counts = conv_train.launches()
    print(f"misaligned x[1:] UNet 2x45x61: eval logits {err / scale:.3g} "
          f"(tol {LOGITS_TOL}); train step loss {loss.item():.4g}, K1 "
          f"launches {counts}", flush=True)
    check(err <= LOGITS_TOL * scale, "UNet logits on x[1:]")
    check(bool(torch.isfinite(loss)), "UNet train loss on x[1:]")
    check(counts == {"fwd": 23, "dgrad": 22, "wgrad": 23},
          "UNet train step launches on x[1:]")
    del model
    torch.cuda.empty_cache()


def phase_k1(gen: torch.Generator):
    """K1's three pieces vs their plain versions at each model's distinct
    block shapes at its training batch; returns {net: {shape: {piece:
    (err, ms, plain_ms)}}}, each shape also with cuDNN's bf16 wgrad ms."""
    dev = torch.device("cuda")
    res = {net: {} for net in TRAIN_BATCH}
    for net, shape in ((net, s) for net in TRAIN_BATCH
                       for s in dict.fromkeys(bench.block_shapes(net, HW))):
        h, w, cin, cout = shape
        n = TRAIN_BATCH[net]
        x, wt = conv_inputs(gen, n, h, w, cin, cout)
        g = torch.randn(n, h, w, cout, generator=gen, device=dev
                        ).to(torch.bfloat16)
        pieces = {
            "fwd": (lambda: conv_train.conv3x3_fwd(x, wt),
                    lambda: conv_train.conv3x3_train_plain(x, wt)),
            "wgrad": (lambda: conv_train.conv3x3_wgrad(x, g),
                      lambda: conv_train.conv3x3_wgrad_plain(x, g)),
        }
        if cin != 3:  # the stem's input is the image: no dx on the path
            pieces["dx"] = (lambda: conv_train.conv3x3_dgrad(g, wt),
                            lambda: conv_train.conv3x3_dgrad_plain(g, wt))
        res[net][shape] = got_shape = {}
        line = [f"K1 {n}x{h}x{w} {cin}->{cout}:"]
        for name, (kern, plain) in pieces.items():
            got, ref = kern().float(), plain().float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            ms = cuda_ms(kern, iters=10)
            plain_ms = cuda_ms(plain, iters=10)
            line.append(f"{name} err {err:.4g}/{scale:.4g}={err / scale:.3g}"
                        f" (tol {K1_TOL[name]}) {ms:.4f} ms, plain "
                        f"{plain_ms:.4f} ms;")
            check(err <= K1_TOL[name] * scale, f"K1 {name} at {shape}")
            got_shape[name] = (err, ms, plain_ms)
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        cudnn_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
            xc, (cout, cin, 3, 3), gc, padding=1), iters=10)
        line.append(f"cuDNN bf16 wgrad {cudnn_ms:.4f} ms")
        got_shape["cudnn_wgrad_ms"] = cudnn_ms
        if "dx" in pieces:   # dx as autograd runs it (the library yardstick)
            lib = lambda: conv_train.conv3x3_dgrad_library(g, wt, x)
            err, scale = _rel_err(lib(), pieces["dx"][1]())
            check(err <= K1_TOL["dx"] * scale, f"dx library call at {shape}")
            got_shape["cudnn_dgrad_ms"] = cuda_ms(lib, iters=10)
            line.append(f"cuDNN bf16 dgrad (convolution_backward, real "
                        f"input) {got_shape['cudnn_dgrad_ms']:.4f} ms")
        print(" ".join(line), flush=True)
    packed_wgrad_lines(res)
    k1_edge_checks(gen)
    misaligned_checks(gen)
    return res


def packed_wgrad_lines(res: dict) -> None:
    """Phase 4's stem and head dW, each model's, on the packed path: time
    beside the bound, cuDNN's bf16 wgrad and the narrow path's time before
    it (``WGRAD_NARROW_MS``, UNet's)."""
    for net, shapes in res.items():
        n = TRAIN_BATCH[net]
        for (h, w, cin, cout), got in shapes.items():
            if conv_train.wgrad_path(cin, cout) != "packed":
                continue
            err, ms, _ = got["wgrad"]
            bound, by = conv_bound(n, h, w, cin, cout, "wgrad")
            before = WGRAD_NARROW_MS.get((net, cin, cout))
            print(f"K1 dW {net} b{n} {h}x{w} {cin}->{cout} on the packed "
                  f"path: {ms:.4f} ms, bound {bound:.4f} by {by} "
                  f"({bound / ms:.2f} of it), cuDNN bf16 wgrad "
                  f"{got['cudnn_wgrad_ms']:.4f} ms "
                  f"({got['cudnn_wgrad_ms'] / ms:.2f}x), narrow path before "
                  + (f"{before} ms" if before else "not measured")
                  + f" ({bench.card()})", flush=True)


# -------------------------------------------------------------- pools (7)

# UNet at width 9/16 (``INT8_ODD_WIDTH``'s): the seven blocks of its
# forward on K4's narrow path (Cin or Cout 36, off 16-byte strides: the
# stem, 36->36 x2, 72->36 x2, 36->72 at half resolution, the head) and the
# dx of each but the stem (flip: 36->36 x2, 36->72 x2, 72->36, 12->36)
ODD_WIDTH = 0.5625
ODD_TRAIN_BATCH = 24
# the first (mma_sync) design at 8x360x480 36->36, device-busy ms, when
# it took the call (PERF.md §6, NVIDIA H100 80GB HBM3 at 700.00 W)
NARROW_BEFORE_MS = {(BATCH, 360, 480, 36, 36, False): 1.1890}
# the narrow dW before its redesign (the first, mma.sync, design),
# device-busy ms on cold inputs at b24 (the tree before the redesign, on
# an NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md §6), printed beside this
# run's and kept out of the kernels line
WGRAD_NARROW_BEFORE_MS = {(360, 480, 3, 36): 2.2728,
                          (360, 480, 36, 36): 4.5632,
                          (180, 240, 36, 72): 1.0811,
                          (360, 480, 72, 36): 6.2818,
                          (360, 480, 36, 12): 2.9473,
                          (360, 480, 64, 150): 12.1311}
# the narrow dW's aim for UNet 9/16's seven launches summed at b24 (ms),
# about 0.39 of their 1.174 ms bound
WGRAD_NARROW_AIM_MS = 3.0
# UNet 9/16's b24 bf16 step before the narrow dW's redesign (ms, 10 steps
# after 3 warm-ups, ``bench.measure_train``; the same card), printed only
ODD_STEP_BEFORE_MS = 212.906


def odd_width_shapes() -> list:
    """(H, W, Cin, Cout) of each conv block of UNet at ``ODD_WIDTH``."""
    return bench.block_shapes("unet", HW,
                              unet_model.scaled_spec(3, 12, ODD_WIDTH))


def narrow_cases() -> list:
    """(n, h, w, cin, cout, flip, blocks): UNet 9/16's distinct narrow
    forwards at b8 and their dx at ``ODD_TRAIN_BATCH``, with the number of
    its blocks of each."""
    return bench.narrow_cases(ODD_WIDTH, BATCH, ODD_TRAIN_BATCH, HW)


def narrow_wgrad_cases() -> list:
    """(n, h, w, cin, cout, blocks): UNet 9/16's distinct dW on the narrow
    dW path at ``ODD_TRAIN_BATCH``, then a 150-class head's 64->150 (no
    block of UNet 9/16; timed, not summed)."""
    return (bench.narrow_wgrad_cases(ODD_WIDTH, ODD_TRAIN_BATCH, HW)
            + [(ODD_TRAIN_BATCH, 360, 480, 64, 150, 0)])


def narrow_wgrad_timings(gen: torch.Generator) -> dict:
    """The narrow dW at ``narrow_wgrad_cases()``: per case the kernel
    against plain (``K1_TOL["wgrad"]``), its device-busy ms on inputs
    spanning ``COLD_SPAN`` beside the byte or FLOP bound, the plain
    version's and cuDNN's bf16 wgrad on channels-last tensors, all from
    this run, printed beside the first design's reading from before the
    redesign (``WGRAD_NARROW_BEFORE_MS``, not returned); then the sum over
    UNet 9/16's seven dW beside ``WGRAD_NARROW_AIM_MS``. Returns
    {...sums, "shapes": {...}, "head_64_150": {...}}."""
    dev = torch.device("cuda")
    out, before = {"shapes": {}}, 0.0
    for n, h, w, cin, cout, blocks in narrow_wgrad_cases():
        def make():
            return (torch.randn(n, h, w, cin, generator=gen, device=dev).to(
                        torch.bfloat16),
                    torch.randn(n, h, w, cout, generator=gen, device=dev).to(
                        torch.bfloat16))
        ins = cold_inputs(make, 2 * n * h * w * (cin + cout))
        x, g = ins[0]
        err, scale = _rel_err(conv_train.conv3x3_wgrad(x, g),
                              conv_train.conv3x3_wgrad_plain(x, g))
        check(err <= K1_TOL["wgrad"] * scale,
              f"narrow dW vs plain at {(n, h, w, cin, cout)}")
        bound, by = conv_bound(n, h, w, cin, cout, "wgrad")
        t = {"blocks": blocks, "max_abs_err": err / scale,
             "bound_ms": bound, "bound_by": by}
        t["ms"] = device_ms(rotated([functools.partial(
            conv_train.conv3x3_wgrad, *i) for i in ins]), bound)
        t["plain_ms"] = device_ms(rotated([functools.partial(
            conv_train.conv3x3_wgrad_plain, *i) for i in ins[:2]]))
        t["library_ms"] = library_device_ms(rotated([functools.partial(
            torch.nn.grad.conv2d_weight, i[0].permute(0, 3, 1, 2),
            (cout, cin, 3, 3), i[1].permute(0, 3, 1, 2), padding=1)
            for i in ins]))
        within_bound(t["ms"], bound, f"narrow dW {(n, h, w, cin, cout)}")
        print(f"narrow dW b{n} {h}x{w} {cin}->{cout} x{blocks}: err "
              f"{err / scale:.3g} (tol {K1_TOL['wgrad']}); device-busy "
              f"{t['ms']:.4f} ms, bound {bound:.4f} by {by} "
              f"({bound / t['ms']:.2f} of it), plain {t['plain_ms']:.4f}, "
              f"cuDNN bf16 wgrad {t['library_ms']:.4f}; the first design "
              f"{WGRAD_NARROW_BEFORE_MS[(h, w, cin, cout)]:.4f} before the "
              f"redesign (not this run's) on {bench.card()}", flush=True)
        key = f"{n}x{h}x{w} {cin}->{cout}"
        before += WGRAD_NARROW_BEFORE_MS[(h, w, cin, cout)] * blocks
        if blocks:
            out["shapes"][key] = t
        else:
            out["head_64_150"] = t
        del ins, x, g
        torch.cuda.empty_cache()
    shapes = out["shapes"].values()
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        out[key] = sum(t[key] * t["blocks"] for t in shapes)
    out["max_abs_err"] = max(t["max_abs_err"] for t in shapes)
    out["blocks"] = sum(t["blocks"] for t in shapes)
    out["bound_by"] = "bytes"
    print(f"narrow dW, UNet 9/16's {out['blocks']} dW summed: "
          f"{out['ms']:.4f} ms (bound {out['bound_ms']:.4f}, "
          f"{out['bound_ms'] / out['ms']:.2f} of it; plain "
          f"{out['plain_ms']:.4f}, cuDNN bf16 {out['library_ms']:.4f}; the "
          f"first design {before:.4f} before the redesign, not this run's); "
          f"aim {WGRAD_NARROW_AIM_MS} "
          f"ms: {'met' if out['ms'] <= WGRAD_NARROW_AIM_MS else 'missed'}",
          flush=True)
    return out


def narrow_timings(gen: torch.Generator) -> dict:
    """The narrow path at ``narrow_cases()``: per case the kernel against
    plain (``KERNEL_TOL``), its device-busy ms on inputs spanning
    ``COLD_SPAN`` (``cold_inputs``: each call reads x from HBM) beside the
    byte or FLOP bound, the plain version's and one library call's
    (cuDNN's bf16 conv on channels-last tensors, of w or under flip of its
    tap-reversed transpose); then the sums over UNet 9/16's seven forward
    blocks and its six dx (``blocks``) beside the design's aims; then the
    narrow dW (``narrow_wgrad_timings``). Returns {"fwd" | "dx" | "wgrad":
    {...sums, "shapes": {...}}}."""
    dev = torch.device("cuda")
    out = {"fwd": {"shapes": {}}, "dx": {"shapes": {}}}
    for n, h, w, cin, cout, flip, blocks in narrow_cases():
        def make():
            x = torch.randn(n, h, w, cin, generator=gen, device=dev).to(
                torch.bfloat16)
            shape = (3, 3, cout, cin) if flip else (3, 3, cin, cout)
            wt = (torch.randn(*shape, generator=gen, device=dev)
                  * (2.0 / (9 * cin)) ** 0.5).to(torch.bfloat16)
            return x, wt
        a = torch.rand(cout, generator=gen, device=dev) + 0.5
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        ins = cold_inputs(make, 2 * n * h * w * cin)
        x, wt = ins[0]
        err, scale = _rel_err(
            fused_conv.conv3x3_bn_relu(x, wt, a, b, True, flip),
            fused_conv.conv3x3_bn_relu_plain(x, wt, a, b, True, flip))
        check(err <= KERNEL_TOL * scale,
              f"narrow path vs plain at {(n, h, w, cin, cout, flip)}")
        bound, by = conv_bound(n, h, w, cin, cout)
        conv = fused_conv.flipped(wt) if flip else wt
        t = {"blocks": blocks, "max_abs_err": err / scale,
             "bound_ms": bound, "bound_by": by}
        for key, fn in (
                ("ms", lambda x, wt: fused_conv.conv3x3_bn_relu(
                    x, wt, a, b, True, flip)),
                ("plain_ms", lambda x, wt: fused_conv.conv3x3_bn_relu_plain(
                    x, wt, a, b, True, flip))):
            t[key] = device_ms(rotated([functools.partial(fn, *i)
                                        for i in ins]),
                               bound if key != "plain_ms" else 0.0)
        wl = conv.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        t["library_ms"] = library_device_ms(rotated([
            functools.partial(F.conv2d, i[0].permute(0, 3, 1, 2), wl,
                              padding=1) for i in ins]))
        within_bound(t["ms"], bound, f"narrow {(n, h, w, cin, cout, flip)}")
        before = NARROW_BEFORE_MS.get((n, h, w, cin, cout, flip))
        print(f"narrow path b{n} {h}x{w} {cin}->{cout}"
              f"{' (flip)' if flip else ''} x{blocks}: err {err / scale:.3g}"
              f" (tol {KERNEL_TOL}); device-busy {t['ms']:.4f} ms, bound "
              f"{bound:.4f} by {by} ({bound / t['ms']:.2f} of it), plain "
              f"{t['plain_ms']:.4f}, cuDNN bf16 {t['library_ms']:.4f}"
              + (f" (the first design's reading when it took the call "
                 f"{before:.4f})"
                 if before else "")
              + f" on {bench.card()}", flush=True)
        out["dx" if flip else "fwd"]["shapes"][
            f"{n}x{h}x{w} {cin}->{cout}"] = t
        del ins, x, wt
        torch.cuda.empty_cache()
    for piece, aim in (("fwd", NARROW_AIM_MS), ("dx", None)):
        shapes = out[piece]["shapes"].values()
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            out[piece][key] = sum(t[key] * t["blocks"] for t in shapes)
        out[piece]["max_abs_err"] = max(t["max_abs_err"] for t in shapes)
        out[piece]["blocks"] = sum(t["blocks"] for t in shapes)
        o = out[piece]
        print(f"narrow path, UNet 9/16's {o['blocks']} {piece} blocks "
              f"summed: {o['ms']:.4f} ms (bound {o['bound_ms']:.4f}, "
              f"{o['bound_ms'] / o['ms']:.2f} of it; plain "
              f"{o['plain_ms']:.4f}, cuDNN bf16 {o['library_ms']:.4f})"
              + (f"; aim {aim} ms: {'met' if o['ms'] <= aim else 'missed'}"
                 if aim else ""), flush=True)
    out["wgrad"] = narrow_wgrad_timings(gen)
    return out


def narrow_checks(gen: torch.Generator) -> dict:
    """The narrow path against plain (``KERNEL_TOL``) at 45x61 (ragged
    tiles at both image edges; odd row runs of 16-byte chunks) for UNet
    9/16's narrow forwards and dx (``narrow_cases``), the narrow
    ``EDGE_SHAPES`` and ``NARROW_NO_TILE`` and their narrow dx, each on an
    aligned batch x[:2] and on the view x[1:]. Each call's kernel, as the
    C entry reports it, is the first design (``mma_sync_launches``) where
    ``narrow_fwd_plan`` holds no tile and the new one elsewhere. Returns
    {(Cin, Cout, flip): worst error}."""
    dev = torch.device("cuda")
    cases = {(cin, cout, flip) for *_, cin, cout, flip, _ in narrow_cases()}
    for *_, cin, cout in EDGE_SHAPES + NARROW_NO_TILE:
        if fused_conv.conv_path(cin, cout) == "narrow":
            cases.add((cin, cout, False))
        if fused_conv.conv_path(cout, cin) == "narrow":
            cases.add((cout, cin, True))
    errs, routes = {}, {}
    for cin, cout, flip in sorted(cases):
        x = torch.randn(3, 45, 61, cin, generator=gen, device=dev).to(
            torch.bfloat16)
        shape = (3, 3, cout, cin) if flip else (3, 3, cin, cout)
        wt = (torch.randn(*shape, generator=gen, device=dev)
              * (2.0 / (9 * cin)) ** 0.5).to(torch.bfloat16)
        a = torch.rand(cout, generator=gen, device=dev) + 0.5
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        for xv in (x[:2], x[1:]):
            reset_counts()
            got = fused_conv.conv3x3_bn_relu(xv, wt, a, b, True, flip)
            k4 = fused_conv.conv3x3_bn_relu
            routes.setdefault((cin, cout, flip), set()).add(
                (k4.path_launches["narrow"], k4.mma_sync_launches))
            err, scale = _rel_err(
                got,
                fused_conv.conv3x3_bn_relu_plain(xv, wt, a, b, True, flip))
            _note(errs, (cin, cout, flip), err / scale)
    line = ", ".join(f"{ci}->{co}{' flip' if f else ''} {e:.3g}"
                     + (" (mma_sync)" if fused_conv.narrow_fwd_plan(ci, co)
                        is None else "")
                     for (ci, co, f), e in sorted(errs.items()))
    print(f"narrow path at 2x45x61, aligned and x[1:], max|kernel - plain| "
          f"/ max|plain|: {line} (tol {KERNEL_TOL})", flush=True)
    for case, e in errs.items():
        check(e <= KERNEL_TOL, f"narrow path vs plain at {case}: {e:.3g}")
    for (cin, cout, flip), seen in routes.items():
        want = (1, int(fused_conv.narrow_fwd_plan(cin, cout) is None))
        check(seen == {want}, f"narrow rule at {(cin, cout, flip)}: launches "
                              f"(narrow, of them mma_sync) {seen}, expected "
                              f"{want}")
    check(any(fused_conv.narrow_fwd_plan(ci, co) is None
              for ci, co, _ in routes), "a narrow shape with no tile ran")
    errs.update(narrow_wgrad_checks(gen))
    return errs


# the narrow dW's check shapes beyond UNet 9/16's: a 150-class head, 64->28,
# 3->12, 350->12 (N in three tiles of 128), 72->100 and 100->72 (both
# sides past 64 channels: M in two channel tiles of 36, on x and on g) and
# 340->340 (whole rows pass shared memory: each pixel's run of a tile's
# channels copied, six M tiles of 57, nine N tiles of 40)
WGRAD_NARROW_EXTRA = ((64, 150), (64, 28), (3, 12), (350, 12), (72, 100),
                      (100, 72), (340, 340))


def narrow_wgrad_checks(gen: torch.Generator) -> dict:
    """The narrow dW against plain (``K1_TOL["wgrad"]``) at 2x45x61 at UNet
    9/16's narrow dW shapes and ``WGRAD_NARROW_EXTRA``, on an aligned batch
    and on the views x[1:], g[1:], one narrow launch a call; the kernel
    launched twice on the same inputs gives equal bits; the shapes take
    both sides, M channel tiles and pixel runs. Returns {("dW", Cin,
    Cout): worst error}."""
    dev = torch.device("cuda")
    cases = sorted({(ci, co) for *_, ci, co, _ in narrow_wgrad_cases()}
                   | set(WGRAD_NARROW_EXTRA))
    errs, routes = {}, {}
    for cin, cout in cases:
        check(conv_train.wgrad_path(cin, cout) == "narrow",
              f"{cin}->{cout} on the narrow dW path")
        x = torch.randn(3, 45, 61, cin, generator=gen, device=dev).to(
            torch.bfloat16)
        g = torch.randn(3, 45, 61, cout, generator=gen, device=dev).to(
            torch.bfloat16)
        for xv, gv in ((x[:2], g[:2]), (x[1:], g[1:])):
            reset_counts()
            got = conv_train.conv3x3_wgrad(xv, gv)
            k1 = conv_train.conv3x3_wgrad
            routes.setdefault((cin, cout), set()).add(
                k1.path_launches["narrow"])
            err, scale = _rel_err(got, conv_train.conv3x3_wgrad_plain(xv, gv))
            _note(errs, ("dW", cin, cout), err / scale)
            again = conv_train.conv3x3_wgrad(xv, gv)
            check(torch.equal(got, again),
                  f"narrow dW twice on the same inputs at {cin}->{cout}: "
                  f"bits differ")
    plans = {pr: conv_train.wgrad_narrow_plan(*pr) for pr in routes}
    line = ", ".join(f"{ci}->{co} {e:.3g} ({plans[ci, co]['side']}, "
                     f"{plans[ci, co]['tiles_m']}x{plans[ci, co]['tiles_n']}"
                     f"{' runs' if plans[ci, co]['runs'] else ''})"
                     for (_, ci, co), e in sorted(errs.items()))
    print(f"narrow dW at 2x45x61, aligned and x[1:], max|kernel - plain| / "
          f"max|plain|: {line} (tol {K1_TOL['wgrad']}); each launched twice "
          f"bit-equal", flush=True)
    for case, e in errs.items():
        check(e <= K1_TOL["wgrad"], f"narrow dW vs plain at {case}: {e:.3g}")
    for (cin, cout), seen in routes.items():
        check(seen == {1}, f"narrow dW rule at {(cin, cout)}: narrow "
                           f"launches a call {seen}, expected 1")
    for what, ran in (("x side", any(p["side"] == "x" for p in plans.values())),
                      ("g side", any(p["side"] == "g" for p in plans.values())),
                      ("M tiles", any(p["tiles_m"] > 1 and not p["runs"]
                                      for p in plans.values())),
                      ("runs", any(p["runs"] for p in plans.values()))):
        check(ran, f"narrow dW checks: no shape with {what}")
    return errs


# the design's aim for the seven forward launches' sum at b8 (ms): a
# quarter of the sum of their bounds
NARROW_AIM_MS = 1.6
# a narrow shape whose plan holds no tile (a tile's patch rows and resident
# weights pass a block's shared memory past Cin ~330): the first design,
# the .cu's mma_sync, takes its forward; its dx 12->350 has a tile
NARROW_NO_TILE = ((2, 45, 61, 350, 12),)


def odd_width_train(cpu_gen: torch.Generator) -> dict:
    """UNet at ``ODD_WIDTH`` (He-scaled, seed 0), one bf16 training step at
    ``ODD_TRAIN_BATCH`` on the kernel path with every K1 call held to its
    plain version on its own inputs (``shadowed_kernels``, per piece and
    (Cin, Cout)), its K1 launches per path (``conv_train.
    step_path_launches``: the forward 7, dx 6 and dW 7 on the narrow
    paths) and none on K4's first (``mma_sync``) kernel (the dW's first
    design is no longer in its library); one step on the plain path from the same state: the loss within
    ``TRAIN_LOSS_TOL``; then 10 timed steps after 3 warm-ups
    (``bench.measure_train``). Returns the launches per path and the step
    ms."""
    dev = torch.device("cuda")
    model = bench.he_model("unet", cpu_gen, ODD_WIDTH).to(dev)
    batch = bench.resident_batch(ODD_TRAIN_BATCH, HW, SEED, dev)
    losses, paths, by_shape, errs = {}, None, {}, {}
    for plain in (False, True):
        m = copy.deepcopy(model)
        opt, step = bench.make_bench_step(10, plain=plain)
        state = TrainState.create(m, opt, seed=SEED)
        torch.cuda.synchronize()
        reset_counts()
        with contextlib.ExitStack() as stack:
            if not plain:
                stack.enter_context(shadowed_kernels(errs, by_shape))
            state, met = step(state, batch)
        torch.cuda.synchronize()
        losses[plain] = float(met["loss"])
        if not plain:
            paths = conv_train.path_launches()
            mma_sync = fused_conv.conv3x3_bn_relu.mma_sync_launches
        del m, state, step
        torch.cuda.empty_cache()
    want = conv_train.step_path_launches(odd_width_shapes())
    loss_err = abs(losses[False] - losses[True]) / abs(losses[True])
    line = ", ".join(f"{k[0]} {k[1]}->{k[2]} {v:.3g}"
                     for k, v in sorted(by_shape.items()))
    print(f"unet at width {ODD_WIDTH} train step b{ODD_TRAIN_BATCH}: loss "
          f"kernel {losses[False]:.6f} plain {losses[True]:.6f} (rel "
          f"{loss_err:.3g}, tol {TRAIN_LOSS_TOL}); K1 launches per path "
          f"{paths} (expected {want}); on K4's mma_sync {mma_sync}; each "
          f"K1 call against plain on its inputs: {line}", flush=True)
    check(paths == want, "unet 9/16 K1 launches per path")
    check((paths["fwd"]["narrow"], paths["dgrad"]["narrow"],
           paths["wgrad"]["narrow"]) == (7, 6, 7),
          "unet 9/16: 7 forward, 6 dx and 7 dW launches narrow")
    check(mma_sync == 0, "unet 9/16: no launch on mma_sync")
    for (piece, _, _), e in by_shape.items():
        check(e <= SHADOW_TOL[piece], f"unet 9/16 {piece} on the step's "
                                      f"data: {e:.3g}")
    check(np.isfinite(losses[False]) and loss_err <= TRAIN_LOSS_TOL,
          "unet 9/16 train loss kernel vs plain")
    del batch
    torch.cuda.empty_cache()
    timed = bench.measure_train(model, ODD_TRAIN_BATCH, steps=10, warmup=3)
    check(timed["finite"], "unet 9/16 timed steps: a loss not finite")
    print(f"unet at width {ODD_WIDTH} b{ODD_TRAIN_BATCH} bf16 step: "
          f"{timed['step_ms']:.3f} ms (median {timed['step_ms_median']:.3f}; "
          f"10 steps after 3 warm-ups; before the narrow dW's redesign "
          f"{ODD_STEP_BEFORE_MS}, not this run's) on {bench.card()}",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return {"path_launches": paths, "loss_rel": loss_err,
            "step_ms": timed["step_ms"],
            "worst": {p: max(e for (q, _, _), e in by_shape.items()
                             if q == p) for p in ("K1 fwd", "K1 dx", "K1 dW")}}


def pool_stages():
    """(H, W, C) entering each of SegNet's five pools at HW."""
    spec = segnet_spec(3, 12)
    return [size + (spec[k][1][-1][1],)
            for k, size in enumerate(halvings(HW, 5))]


def bit_equal(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(equal bit for bit, NaN where NaN; max |got - ref| elsewhere)."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return False, float("inf")
    if not got.dtype.is_floating_point:
        return torch.equal(got, ref), float(
            (got.long() - ref.long()).abs().max()) if got.numel() else 0.0
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan):
        return False, float("inf")
    as_int = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    same = torch.equal(got.view(as_int[got.dtype])[~nan],
                       ref.view(as_int[ref.dtype])[~nan])
    diff = (got.float() - ref.float())[~nan].abs()
    return same, float(diff.max()) if diff.numel() else 0.0


def check_pool_pair(x: torch.Tensor, what: str, g=None) -> dict:
    """Every pool function of both pairs on ``x`` against its plain
    version; returns {kernel name: max abs error}."""
    hw = (x.shape[1], x.shape[2])
    p, idx = pooling.max_pool_2x2_with_argmax(x)
    pp_, k = pooling.max_pool_2x2_argmax_phase(x)
    if g is None:
        g = torch.randn(x.shape, generator=torch.Generator(
            device=x.device).manual_seed(1), device=x.device).to(x.dtype)
    cases = {
        "maxpool2x2.pool_flat": (fused_pool.max_pool_2x2_argmax(x),
                                 (p, idx)),
        "maxpool2x2.unpool_flat": (fused_pool.max_unpool_2x2(p, idx, hw),
                                   pooling.max_unpool_2x2(p, idx, hw)),
        "maxpool2x2.pool_phase": (fused_pool.max_pool_2x2_phase(x),
                                  (pp_, k)),
        "maxpool2x2.unpool_phase": (
            fused_pool.max_unpool_2x2_phase(pp_, k, hw),
            pooling.max_unpool_2x2_from_phase(pp_, k, hw)),
        "maxpool2x2.phase_gather": (fused_pool.gather_phase(g, k),
                                    pooling.gather_phase(g, k)),
    }
    torch.cuda.synchronize()
    errs = {}
    for name, (got, ref) in cases.items():
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        results = [bit_equal(a, b) for a, b in zip(got, ref)]
        check(all(r[0] for r in results), f"{name} bit equality ({what})")
        errs[name] = max(r[1] for r in results)
    return errs


def pool_bytes(n, h, w, c, item):
    """Least bytes of each function: inputs read once, outputs written
    once (flat index int32, phase int8)."""
    x, s = n * h * w * c, n * (h // 2) * (w // 2) * c
    return {"maxpool2x2.pool_flat": x * item + s * (item + 4),
            "maxpool2x2.unpool_flat": s * (item + 4) + x * item,
            "maxpool2x2.pool_phase": x * item + s * (item + 1),
            "maxpool2x2.unpool_phase": s * (item + 1) + x * item,
            "maxpool2x2.phase_gather": x * item + s * 1 + s * item}


def phase_pools(gen: torch.Generator) -> dict:
    """K3 and K2 against their plain versions, bit for bit, at SegNet's
    pool shapes (K3 at batch 8, K2 at batch 32), plus ties on odd sizes and
    NaN; per kernel: max error and summed kernel, plain, library and bound
    times over the five stages."""
    dev = torch.device("cuda")
    out = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "library_ms": 0.0, "bound_ms": 0.0}
           for name in fused_pool.KERNELS}
    for h, w, c in pool_stages():
        for n, names in ((BATCH, ("maxpool2x2.pool_flat",
                                  "maxpool2x2.unpool_flat")),
                         (TRAIN_BATCH["segnet"], (
                             "maxpool2x2.pool_phase",
                             "maxpool2x2.unpool_phase",
                             "maxpool2x2.phase_gather"))):
            x = torch.randn(n, h, w, c, generator=gen, device=dev
                            ).to(torch.bfloat16)
            g = torch.randn(n, h, w, c, generator=gen, device=dev
                            ).to(torch.bfloat16)
            errs = check_pool_pair(x, f"{n}x{h}x{w}x{c}", g)
            hw = (h, w)
            p, idx = pooling.max_pool_2x2_with_argmax(x)
            _, k = pooling.max_pool_2x2_argmax_phase(x)
            nchw = (lambda t: t.permute(0, 3, 1, 2))
            xc, pc = nchw(x), nchw(p)
            idx64 = nchw(idx).long()
            idx64_nhwc = idx.long().reshape(n, -1, c)
            fns = {
                "maxpool2x2.pool_flat": (
                    lambda: fused_pool.max_pool_2x2_argmax(x),
                    lambda: pooling.max_pool_2x2_with_argmax(x),
                    lambda: F.max_pool2d(xc, 2, 2, return_indices=True)),
                "maxpool2x2.unpool_flat": (
                    lambda: fused_pool.max_unpool_2x2(p, idx, hw),
                    lambda: pooling.max_unpool_2x2(p, idx, hw),
                    lambda: F.max_unpool2d(pc, idx64, 2, 2,
                                           output_size=hw)),
                "maxpool2x2.pool_phase": (
                    lambda: fused_pool.max_pool_2x2_phase(x),
                    lambda: pooling.max_pool_2x2_argmax_phase(x),
                    lambda: F.max_pool2d(xc, 2, 2, return_indices=True)),
                "maxpool2x2.unpool_phase": (
                    lambda: fused_pool.max_unpool_2x2_phase(p, k, hw),
                    lambda: pooling.max_unpool_2x2_from_phase(p, k, hw),
                    lambda: F.max_unpool2d(pc, idx64, 2, 2,
                                           output_size=hw)),
                "maxpool2x2.phase_gather": (
                    lambda: fused_pool.gather_phase(g, k),
                    lambda: pooling.gather_phase(g, k),
                    lambda: torch.gather(g.reshape(n, h * w, c), 1,
                                         idx64_nhwc)),
            }
            nbytes = pool_bytes(n, h, w, c, 2)
            line = [f"pools {n}x{h}x{w}x{c}:"]
            for name in names:
                kern, plain, lib = fns[name]
                t = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
                     "library_ms": cuda_ms(lib),
                     "bound_ms": nbytes[name] / bench.H100_HBM_RATE * 1e3}
                for key, v in t.items():
                    out[name][key] += v
                out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                               errs[name])
                line.append(f"{name.split('.')[1]} {t['ms']:.4f} ms (plain "
                            f"{t['plain_ms']:.4f}, library "
                            f"{t['library_ms']:.4f}, bound "
                            f"{t['bound_ms']:.4f}: "
                            f"{t['bound_ms'] / t['ms']:.2f} of it);")
            if n == TRAIN_BATCH["segnet"]:   # autograd's pool backward
                bwd_ms = cuda_ms(
                    lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                        pc, xc, [2, 2], [2, 2], [0, 0], [1, 1], False,
                        idx64))
                line.append(f"autograd pool backward {bwd_ms:.4f} ms")
            print(" ".join(line), flush=True)
            del x, g
    # ties (a grid of five values) on odd sizes, both dtypes, vector and
    # scalar channel counts; then NaN in a window
    for dtype in (torch.bfloat16, torch.float32):
        for c in (64, 3):
            x = (torch.randint(-2, 3, (2, 45, 61, c), generator=gen,
                               device=dev) * 0.5).to(dtype)
            errs = check_pool_pair(x, f"ties 45x61x{c} {dtype}")
            check(max(errs.values()) == 0, "ties: nonzero error")
    x = torch.randn(2, 8, 10, 16, generator=gen, device=dev
                    ).to(torch.bfloat16)
    x[0, 1, 0, 3] = float("nan")                  # phase 2 of window (0,0)
    x[1, 2, 5, 7] = x[1, 3, 5, 7] = float("nan")  # two NaNs: the last wins
    errs = check_pool_pair(x, "NaN")
    check(torch.isnan(fused_pool.max_pool_2x2_argmax(x)[0]).sum() == 2,
          "NaN pooled")
    print(f"pools: bit-equal to the plain versions at SegNet's 5 pool "
          f"shapes, on ties at 45x61 (bf16 and f32, C 64 and 3) and with "
          f"NaN in a window; max error {max(errs.values())}", flush=True)
    return out


# ----------------------------------------------------- models and slices

def n_blocks(net: str) -> int:
    return len(bench.block_shapes(net, HW))


def reset_counts() -> None:
    fused_conv.reset_launches()
    fused_conv_pair.reset_launches()
    conv_train.reset_launches()
    fused_pool.reset_launches()
    lp.reset_launches()
    fused_conv_int8.reset_launches()


def train_counts() -> dict:
    return {**conv_train.launches(), **fused_pool.launches()}


def path_counts(net: str, steps: int, classes: int = 12,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """K1's launches on each path in ``steps`` kernel-path steps of ``net``
    with a ``classes``-class head at ``dtype`` ({piece: {path: launches}},
    ``path_table``); a forward's K4 launches are the "fwd" entry's."""
    return {piece: {p: k * steps for p, k in paths.items()}
            for piece, paths in path_table(net, classes, dtype).items()}


def expected_train_counts(net: str, steps: int) -> dict:
    """Launches of ``steps`` kernel-path steps, in all (the head's class
    count moves its launches between paths, ``path_counts``, not their
    number)."""
    nb, pools = n_blocks(net), POOLS[net]
    return {"fwd": nb * steps, "dgrad": (nb - 1) * steps,
            "wgrad": nb * steps, "maxpool2x2.pool_flat": 0,
            "maxpool2x2.unpool_flat": 0,
            "maxpool2x2.pool_phase": pools * steps,
            "maxpool2x2.unpool_phase": 2 * pools * steps,
            "maxpool2x2.phase_gather": pools * steps}


def train_setup(net: str, cpu_gen: torch.Generator,
                dev=torch.device("cuda")):
    """The He-scaled full-width model on the card and one uint8 batch
    gathered on the card from resident synthetic data."""
    return (bench.he_model(net, cpu_gen).to(dev),
            bench.resident_batch(TRAIN_BATCH[net], HW, SEED, dev))


# ------------------------------------------------- shared pool choices

@contextlib.contextmanager
def recorded_choices(model):
    """Yields a list that holds, after the block, the index each of the
    model's pools chose in it: the plain version of the mode's pool (flat
    in eval mode, phase in train mode) applied to the pool's input, its
    encoder stage's output. The kernel's own index is not read, so a
    kernel that chose otherwise makes the two paths differ. Empty for a
    model without pools."""
    inputs, choices = [], []
    hooks = [stage.register_forward_hook(
        lambda _m, _args, y: inputs.append(y.detach()))
        for name, stage in model.named_children()
        if name.startswith("encoder")]
    try:
        yield choices
    finally:
        for hook in hooks:
            hook.remove()
    pool = (pooling.max_pool_2x2_argmax_phase if model.training
            else pooling.max_pool_2x2_with_argmax)
    choices.extend(pool(x)[1] for x in inputs)


def _pool_at_flat(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (N,H,W,C) at the flat indices idx (N,H2,W2,C) of its planes."""
    n, c = x.shape[0], x.shape[3]
    return x.reshape(n, -1, c).gather(
        1, idx.reshape(n, -1, c).long()).reshape(idx.shape)


@contextlib.contextmanager
def replayed_choices(choices: list):
    """Inside the block the plain pools take ``choices`` in turn (from
    ``recorded_choices``) instead of choosing: each returns x at the given
    index and that index, so the plain path pools, unpools and routes the
    pool's gradient (autograd of the gather) where the kernel path did."""
    left = iter(choices)
    saved = (pooling.max_pool_2x2_with_argmax,
             pooling.max_pool_2x2_argmax_phase)

    def flat(x):
        idx = next(left)
        return _pool_at_flat(x, idx), idx

    def phase(x):
        k = next(left)
        return pooling.gather_phase(x, k), k

    (pooling.max_pool_2x2_with_argmax,
     pooling.max_pool_2x2_argmax_phase) = flat, phase
    try:
        yield
    finally:
        (pooling.max_pool_2x2_with_argmax,
         pooling.max_pool_2x2_argmax_phase) = saved
    check(next(left, None) is None, "a recorded pool choice was not used")


# ------------------------------------------- kernels on the step's data

# per piece: max|kernel - plain| / max|plain| on one call (K2: bit equality)
SHADOW_TOL = {"K1 fwd": K1_TOL["fwd"], "K1 dx": K1_TOL["dx"],
              "K1 dW": K1_TOL["wgrad"], "K2 pool": 0.0,
              "K2 pool backward": 0.0, "K2 unpool": 0.0,
              "K2 unpool backward": 0.0}


def _note(errs: dict, piece: str, err: float) -> None:
    """errs[piece] becomes the worse of it and ``err``; NaN is worst."""
    old = errs.get(piece, 0.0)
    errs[piece] = err if err != err or err > old else old


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape:
        return float("inf")
    if want.numel() == 0:   # an empty map (SegNet under 32 rows)
        return 0.0
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def _bits(got: torch.Tensor, want: torch.Tensor) -> float:
    """0 when bit-equal; else the max error, or inf if that is 0."""
    same, err = bit_equal(got, want)
    return 0.0 if same else (err or float("inf"))


def _plain_grad(fn, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d<fn(x), g>/dx by autograd of a plain version."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        return torch.autograd.grad(fn(xr), xr, g)[0]


@contextlib.contextmanager
def shadowed_kernels(errs: dict, by_shape: dict = None):
    """Inside the block every call of the kernel path's autograd Functions
    is held, forward and backward, against plain versions on the same
    inputs, and ``errs`` gets each piece's worst error (``SHADOW_TOL``;
    ``by_shape``, when given, K1's per (piece, Cin, Cout) as well):
    K1's conv (``conv_train._Conv3x3Train``) against F.conv2d,
    ``conv2d_input`` and the f32 wgrad; K2's pool and unpool
    (``fused_pool._PoolPhaseTrain``, ``_UnpoolPhaseTrain``) against their
    plain versions and autograd's derivatives of those. A wrong kernel, or
    a Function that wires a right kernel wrongly, shows here on the step's
    own data, however much the model compounds the two paths' roundings.
    The plain versions launch no counted kernel."""
    conv_cls = conv_train._Conv3x3Train
    pool_cls, unpool_cls = fused_pool._PoolPhaseTrain, \
        fused_pool._UnpoolPhaseTrain
    saved = [(cls, name, cls.__dict__[name])
             for cls in (conv_cls, pool_cls, unpool_cls)
             for name in ("forward", "backward")]
    conv_fwd, conv_bwd = conv_cls.forward, conv_cls.backward
    pool_fwd, pool_bwd = pool_cls.forward, pool_cls.backward
    unpool_fwd, unpool_bwd = unpool_cls.forward, unpool_cls.backward

    def note_conv(piece, w, err):
        _note(errs, piece, err)
        if by_shape is not None:
            _note(by_shape, (piece, w.shape[2], w.shape[3]), err)

    def conv_forward(ctx, x, w):
        y = conv_fwd(ctx, x, w)
        note_conv("K1 fwd", w, _rel(y, conv_train.conv3x3_train_plain(x, w)))
        # kept beside the saved tensors: under a remat checkpoint those may
        # be unpacked once only, by the Function's own backward
        ctx.shadow = (x.detach(), w.detach())
        return y

    def conv_backward(ctx, g):
        dx, dw = conv_bwd(ctx, g)
        x, w = ctx.shadow
        g = g.to(x.dtype).contiguous()
        if dx is not None:
            note_conv("K1 dx", w,
                      _rel(dx, conv_train.conv3x3_dgrad_plain(g, w)))
        note_conv("K1 dW", w,
                  _rel(dw, conv_train.conv3x3_wgrad_plain(x, g)))
        return dx, dw

    def pool_forward(ctx, x):
        pooled, k = pool_fwd(ctx, x)
        want = pooling.max_pool_2x2_argmax_phase(x)
        _note(errs, "K2 pool", max(_bits(pooled, want[0]),
                                   _bits(k, want[1])))
        ctx.shadow_x = x.detach()
        return pooled, k

    def pool_backward(ctx, g, gk):
        dx = pool_bwd(ctx, g, gk)
        want = _plain_grad(
            lambda t: pooling.max_pool_2x2_argmax_phase(t)[0],
            ctx.shadow_x, g)
        _note(errs, "K2 pool backward", _bits(dx, want))
        return dx

    def unpool_forward(ctx, x, k, out_hw):
        out = unpool_fwd(ctx, x, k, out_hw)
        _note(errs, "K2 unpool", _bits(
            out, pooling.max_unpool_2x2_from_phase(x, k, out_hw)))
        ctx.shadow = (x.detach(), k, out_hw)
        return out

    def unpool_backward(ctx, g):
        dx, dk, dhw = unpool_bwd(ctx, g)
        x, k, out_hw = ctx.shadow
        want = _plain_grad(
            lambda t: pooling.max_unpool_2x2_from_phase(t, k, out_hw),
            x, g)
        _note(errs, "K2 unpool backward", _bits(dx, want))
        return dx, dk, dhw

    for cls, fwd, bwd in ((conv_cls, conv_forward, conv_backward),
                          (pool_cls, pool_forward, pool_backward),
                          (unpool_cls, unpool_forward, unpool_backward)):
        cls.forward, cls.backward = staticmethod(fwd), staticmethod(bwd)
    try:
        yield errs
    finally:
        for cls, name, attr in saved:
            setattr(cls, name, attr)


# --------------------------------------------------- parity of the paths

def _worst(errs: dict):
    name = max(errs, key=errs.get)
    median = sorted(errs.values())[len(errs) // 2]
    return name, errs[name], median


def one_step(model, batch, plain: bool, choices=None) -> dict:
    """One bench step from ``model``'s state on a copy: loss, launches,
    per-leaf gradients and BN running stats after it; on the kernel path
    also the step's pool choices and its kernels' errors on the step's data
    (``shadowed_kernels``). ``choices`` (the plain path): replayed."""
    m = copy.deepcopy(model)
    opt, step = bench.make_bench_step(TRAIN_STEPS + 10, plain=plain)
    state = TrainState.create(m, opt, seed=SEED)
    shadow, made = {}, choices
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.ExitStack() as stack:
        if choices is None:
            made = stack.enter_context(recorded_choices(m))
            stack.enter_context(shadowed_kernels(shadow))
        else:
            stack.enter_context(replayed_choices(choices))
        state, met = step(state, batch)
    torch.cuda.synchronize()
    counts = train_counts()
    paths = conv_train.path_launches()
    # AdamW's first moment after one update from zero is (1 - beta1) g
    out = {"loss": float(met["loss"]), "counts": counts, "paths": paths,
           "shadow": shadow,
           "choices": made,
           "grads": {k: v / (1.0 - met["beta1"])
                     for k, v in state.opt_state["m"].items()},
           "stats": {k: v.float().clone() for k, v in m.state_dict().items()
                     if "running" in k}}
    del m, state, step
    torch.cuda.empty_cache()
    return out


def grad_errors(model, got: dict, want: dict) -> tuple:
    """Per leaf |norm(got) - norm(want)| and norm(got - want), over
    norm(want). A conv bias feeds train-mode BN, which removes the batch
    mean, so its exact gradient is zero and every path holds rounding
    noise there: it is held against its conv weight's gradient norm."""
    norm = {n: torch.linalg.vector_norm(g).item() for n, g in want.items()}
    conv_weight = {}   # conv bias name -> its conv weight's name
    for stage, pairs in model.spec:
        for i in range(len(pairs)):
            names = model.block_names(stage, i)
            conv_weight[names["b"]] = names["w"]

    def scale_of(n):
        return max(norm[conv_weight.get(n, n)], 1e-30)
    norm_errs = {n: abs(torch.linalg.vector_norm(got[n]).item() - norm[n])
                 / scale_of(n) for n in norm}
    diff_errs = {n: torch.linalg.vector_norm(got[n] - g).item()
                 / scale_of(n) for n, g in want.items()}
    return norm_errs, diff_errs


def train_parity(net: str, model, batch) -> dict:
    """One step on the kernel path and one on the plain path from the same
    state, the plain path at the kernel path's pool choices: loss and BN
    running stats must agree, and so must the per-leaf gradients where
    ``GRADS_END_TO_END``; every kernel call of the kernel step must agree
    with its plain version on the same inputs (``shadowed_kernels``).
    Returns the kernel path's launches and K1's on each path."""
    k = one_step(model, batch, plain=False)
    p = one_step(model, batch, plain=True, choices=k["choices"])
    print(f"{net} train step b{TRAIN_BATCH[net]}: loss kernel "
          f"{k['loss']:.6f} plain {p['loss']:.6f} (plain path at the kernel "
          f"path's {len(k['choices'])} pool choices); launches kernel path "
          f"{k['counts']}, plain path {p['counts']}; K1 on each path "
          f"{k['paths']}", flush=True)
    loss_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    norm_errs, diff_errs = grad_errors(model, k["grads"], p["grads"])
    stat_errs = {n: ((k["stats"][n] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30)).item()
                 for n, v in p["stats"].items()}
    worst_n, worst_d, worst_s = (_worst(e) for e in
                                 (norm_errs, diff_errs, stat_errs))
    print(f"{net} train step kernel vs plain: loss rel {loss_err:.3g} (tol "
          f"{TRAIN_LOSS_TOL}); per leaf, grad norm rel max {worst_n[1]:.3g} "
          f"at {worst_n[0]}, median {worst_n[2]:.3g} (tol "
          f"{TRAIN_GRAD_TOL}); |grad diff| rel max {worst_d[1]:.3g} at "
          f"{worst_d[0]}, median {worst_d[2]:.3g} (tol "
          f"{TRAIN_GRAD_DIFF_TOL}); BN stats rel max {worst_s[1]:.3g} at "
          f"{worst_s[0]}, median {worst_s[2]:.3g} (tol {TRAIN_STAT_TOL})",
          flush=True)
    weights = [model.block_names(stage, i)["w"]
               for stage, pairs in model.spec for i in range(len(pairs))]
    print(f"{net} train step kernel vs plain, |grad diff| rel of each conv "
          f"weight in forward order: "
          f"{' '.join(f'{diff_errs[w]:.3g}' for w in weights)}", flush=True)
    print(f"{net} train step, each kernel call against its plain version "
          f"on the same inputs, worst per piece: " + "; ".join(
              f"{piece} {e:.3g} (tol {SHADOW_TOL[piece]})"
              for piece, e in k["shadow"].items()), flush=True)
    check(k["counts"] == expected_train_counts(net, 1),
          f"{net} launches per step")
    check(k["paths"] == path_counts(net, 1), f"{net} K1 launches per path")
    want = [p for p in SHADOW_TOL if POOLS[net] or p.startswith("K1")]
    check(sorted(k["shadow"]) == sorted(want), f"{net} kernel pieces seen")
    for piece, e in k["shadow"].items():
        check(e <= SHADOW_TOL[piece], f"{net} {piece} on the step's data")
    check(set(p["counts"].values()) == {0}, "plain path launched a kernel")
    check(np.isfinite(k["loss"]) and loss_err <= TRAIN_LOSS_TOL,
          "train loss kernel vs plain")
    check(worst_s[1] <= TRAIN_STAT_TOL, "BN stats kernel vs plain")
    if GRADS_END_TO_END[net]:
        check(worst_n[1] <= TRAIN_GRAD_TOL, "grad norms kernel vs plain")
        check(worst_d[1] <= TRAIN_GRAD_DIFF_TOL, "grads kernel vs plain")
    return k["counts"], k["paths"]


def phase_train(net: str, cpu_gen: torch.Generator):
    """One step on each path from the same state, then the timed run."""
    model, batch = train_setup(net, cpu_gen)
    counts, paths = train_parity(net, model, batch)
    b = TRAIN_BATCH[net]
    for plain in (False, True):
        m = copy.deepcopy(model)
        reset_counts()
        r = bench.measure_train(m, b, TRAIN_STEPS, hw=HW, plain=plain,
                                seed=SEED)
        r["counts"] = train_counts()
        r["paths"] = conv_train.path_launches()
        print(f"{net} train {'plain' if plain else 'kernel'} path: "
              f"{r['images_per_sec']:.2f} img/s, step {r['step_ms']:.2f} ms, "
              f"MFU {r['mfu']:.4f}, peak memory "
              f"{r['max_memory_allocated'] / 2 ** 30:.2f} GiB, losses "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}, launches "
              f"{r['counts']} ({TRAIN_STEPS} steps + 3 warm-up, batch "
              f"{b}, {HW[0]}x{HW[1]}; K1 on each path {r['paths']}) on "
              f"{bench.card()}", flush=True)
        check(r["finite"], "non-finite training loss")
        steps = 0 if plain else TRAIN_STEPS + 3
        check(r["counts"] == expected_train_counts(net, steps),
              f"{net} launches in the timed run")
        check(r["paths"] == path_counts(net, steps),
              f"{net} K1 launches per path in the timed run")
        del m
        torch.cuda.empty_cache()
    del model, batch
    torch.cuda.empty_cache()
    return counts, paths


# SegNet under 32 rows or columns (after phase 9): at 24x32 its fifth
# pool's output is empty (24 -> 12, 6, 3, 1, 0) and the decoder starts from
# the unpool's zeros; at 12x40 its fourth pool's too, and the fifth
# stage's six blocks run on an empty map (BN stats NaN, as JAX's)
SMALL_HW = ((24, 32), (12, 40))
SMALL_BATCH = 2


def small_counts(hw) -> dict:
    """SegNet's launches at ``hw``: K4 (eval) and K1 (train) for the blocks
    whose map has a pixel, K3 and K2 for each pool whose output has one
    (its unpool's input), none for the empty results."""
    sizes = halvings(hw, 6)
    level = {k: sizes[k - 1][0] * sizes[k - 1][1] > 0 for k in range(1, 6)}
    blocks = sum(len(pairs) for name, pairs in segnet_spec(3, 12)
                 if level[int(name[7:])])
    pools = sum(sizes[k][0] * sizes[k][1] > 0 for k in range(1, 6))
    return {"k4": blocks, "k3": pools,
            "train": {"fwd": blocks, "dgrad": blocks - 1, "wgrad": blocks,
                      "maxpool2x2.pool_flat": 0,
                      "maxpool2x2.unpool_flat": 0,
                      "maxpool2x2.pool_phase": pools,
                      "maxpool2x2.unpool_phase": 2 * pools,
                      "maxpool2x2.phase_gather": pools}}


def segnet_small_checks(cpu_gen: torch.Generator) -> dict:
    """A full-width SegNet (He-scaled) at each of ``SMALL_HW``, batch
    ``SMALL_BATCH``, its biases and BN running stats drawn from
    ``cpu_gen``: the bf16 eval forward's logits on the kernel path
    against the plain path (LOGITS_TOL) and its K4 and K3 launches; one
    bench train step on each path from the same state at the kernel
    path's pool choices: loss (TRAIN_LOSS_TOL), BN stats (TRAIN_STAT_TOL,
    NaN where the map is empty on both paths), every kernel call against
    its plain version (``shadowed_kernels``) and the launches
    (``small_counts``). Returns {hw: launches}."""
    model = bench.he_model("segnet", cpu_gen)
    # the decoder starts from the unpool's zeros: conv and BN biases and
    # running stats drawn from the seed, so that its maps are not zero
    with torch.no_grad():
        for blk in model.blocks():
            conv, bn = blk.conv_bn()
            for t in (conv.bias, bn.bias, bn.running_mean):
                t.copy_(torch.randn(t.shape, generator=cpu_gen) * 0.1)
            bn.running_var.copy_(
                torch.rand(bn.running_var.shape, generator=cpu_gen) + 0.5)
    model = model.to(DEVICE)
    out = {}
    for hw in SMALL_HW:
        want = small_counts(hw)
        images, labels = bench.resident_batch(SMALL_BATCH, hw, SEED, DEVICE)
        m = copy.deepcopy(model).eval()
        m.prepare(torch.bfloat16)
        reset_counts()
        with torch.inference_mode():
            xn = to_tensor_normalize(images, settings.MEAN, settings.STD,
                                     torch.bfloat16)
            with recorded_choices(m) as choices:
                got = m(xn)
            counts = {"k4": fused_conv.conv3x3_bn_relu.launches,
                      "k3": fused_pool.max_pool_2x2_argmax.launches,
                      "k3 unpool": fused_pool.max_unpool_2x2.launches}
            with replayed_choices(choices):
                ref = m(xn, plain=True)
        err, scale = _rel_err(got, ref)
        k = one_step(model, (images, labels), plain=False)
        p = one_step(model, (images, labels), plain=True,
                     choices=k["choices"])
        loss_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
        nan_equal = all(torch.equal(torch.isnan(k["stats"][n]),
                                    torch.isnan(v))
                        for n, v in p["stats"].items())
        stat_err = max((torch.nan_to_num(k["stats"][n] - v).abs().max()
                        / torch.nan_to_num(v).abs().max().clamp_min(1e-30)
                        ).item() for n, v in p["stats"].items())
        stale = sum(bool(torch.isnan(v).any()) for v in p["stats"].values())
        print(f"segnet {SMALL_BATCH}x{hw[0]}x{hw[1]} (pools to "
              f"{halvings(hw, 6)[1:]}): eval logits {tuple(got.shape)} max"
              f"|kernel - plain| {err:.4g} / max|plain| {scale:.4g} (tol "
              f"{LOGITS_TOL}), launches {counts} (expected K4 {want['k4']}, "
              f"K3 {want['k3']} each); train step loss kernel "
              f"{k['loss']:.6f} plain {p['loss']:.6f} (rel {loss_err:.3g}, "
              f"tol {TRAIN_LOSS_TOL}), BN stats rel max {stat_err:.3g} (tol "
              f"{TRAIN_STAT_TOL}; {stale} NaN buffers on both paths: "
              f"{nan_equal}), launches {k['counts']}, kernel calls vs plain "
              f"{k['shadow']}", flush=True)
        check(bool(torch.isfinite(got).all()) and got.shape[1:3] == hw
              and err <= LOGITS_TOL * scale,
              f"segnet eval logits at {hw}, kernel vs plain")
        check(counts == {"k4": want["k4"], "k3": want["k3"],
                         "k3 unpool": want["k3"]},
              f"segnet eval launches at {hw}")
        check(np.isfinite(k["loss"]) and loss_err <= TRAIN_LOSS_TOL,
              f"segnet train loss at {hw}, kernel vs plain")
        check(nan_equal and stat_err <= TRAIN_STAT_TOL
              and (stale > 0) == (min(hw) < 16),
              f"segnet BN stats at {hw}, kernel vs plain")
        check(k["counts"] == want["train"]
              and set(p["counts"].values()) == {0},
              f"segnet train launches at {hw}")
        for piece, e in k["shadow"].items():
            check(e <= SHADOW_TOL[piece],
                  f"segnet {piece} on the step's data at {hw}")
        out[f"{hw[0]}x{hw[1]}"] = {"eval": counts, "train": k["counts"]}
        del m, images, labels, xn, got, ref
    del model
    torch.cuda.empty_cache()
    return out


def logits_parity(net: str, model, x_u8: torch.Tensor) -> torch.Tensor:
    """The eval-mode model's logits for one uint8 batch on the kernel path
    and on the plain path (at the kernel path's pool choices): within
    LOGITS_TOL of max|plain|. Returns the normalized batch."""
    with torch.inference_mode():
        xn = to_tensor_normalize(x_u8, settings.MEAN, settings.STD,
                                 torch.bfloat16)
        with recorded_choices(model) as choices:
            got = model(xn)
        with replayed_choices(choices):
            ref = model(xn, plain=True)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        finite = bool(torch.isfinite(got).all())
    print(f"{net} serving logits: max|kernel - plain| {err:.4g} / "
          f"max|plain| {scale:.4g} = {err / scale:.3g} (tol {LOGITS_TOL}; "
          f"plain path at the kernel path's {len(choices)} pool choices); "
          f"argmax agreement {agree:.4f} (information only)", flush=True)
    check(finite, "non-finite logits")
    check(err <= LOGITS_TOL * scale, f"{net} logits kernel vs plain")
    return xn


def phase_slice(net: str, cpu_gen: torch.Generator,
                rng: np.random.Generator):
    """Serve three requests through ``Predictor``; returns the launches of
    those requests."""
    nb, pools = n_blocks(net), POOLS[net]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{net}_he.pth")
        torch.save(bench.he_model(net, cpu_gen).state_dict(), path)
        predictor = Predictor.from_checkpoint(net, path, batch_size=BATCH,
                                              image_hw=HW)
    with predictor:
        requests = [
            rng.integers(0, 256, (8,) + HW + (3,), dtype=np.uint8),
            rng.integers(0, 256, (13,) + HW + (3,), dtype=np.uint8),
            rng.integers(0, 256, (8, 480, 640, 3), dtype=np.uint8),
        ]
        forwards = sum(-(-len(r) // BATCH) for r in requests)
        torch.cuda.synchronize()
        reset_counts()
        outs = [predictor.predict(r) for r in requests]
        torch.cuda.synchronize()
        launches = {"conv3x3_bn_relu": fused_conv.conv3x3_bn_relu.launches,
                    **fused_pool.launches()}
        paths = dict(fused_conv.conv3x3_bn_relu.path_launches)
        want_paths = path_counts(net, forwards)["fwd"]
        want = {"conv3x3_bn_relu": nb * forwards,
                "maxpool2x2.pool_flat": pools * forwards,
                "maxpool2x2.unpool_flat": pools * forwards,
                "maxpool2x2.pool_phase": 0, "maxpool2x2.unpool_phase": 0,
                "maxpool2x2.phase_gather": 0}
        print(f"{net} serving: {[len(r) for r in requests]} images in "
              f"{forwards} forwards; launches {launches} (expected "
              f"{want}); K4 on each path {paths} (expected {want_paths})",
              flush=True)
        for r, o in zip(requests, outs):
            check(o.shape == (len(r),) + HW and o.dtype == np.uint8,
                  f"class map shape {o.shape} {o.dtype}")
            check(int(o.max()) < 12, "class index >= 12")
        check(launches == want, f"{net} launches per forward")
        check(paths == want_paths, f"{net} K4 launches per path")
        launches["conv3x3_bn_relu_paths"] = paths

        # kernel path vs plain path on one batch, same normalized input
        xn = logits_parity(net, predictor.model,
                           torch.from_numpy(requests[0]).cuda())
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: predictor.model(xn), iters=10)
            fwd_plain_ms = cuda_ms(lambda: predictor.model(xn, plain=True),
                                   iters=10)
        print(f"{net} model forward b{BATCH}: kernel path {fwd_ms:.3f} ms, "
              f"plain path {fwd_plain_ms:.3f} ms", flush=True)

        # serving throughput at the working size (warm), three repeats
        imgs = rng.integers(0, 256, (8 * BATCH,) + HW + (3,), dtype=np.uint8)
        predictor.predict(imgs[:BATCH])
        rates = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictor.predict(imgs)
            torch.cuda.synchronize()
            rates.append(len(imgs) / (time.perf_counter() - t0))
        print(f"{net} serving throughput: median {sorted(rates)[1]:.2f} "
              f"img/s of {', '.join(f'{r:.2f}' for r in rates)} "
              f"({len(imgs)} images {HW[0]}x{HW[1]}, batch {BATCH}, "
              f"predict() end to end) on {bench.card()}", flush=True)
    return launches


# ------------------------------------------------------- K5 and the probe

def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max|got - ref|, max|ref|)."""
    return ((got.float() - ref.float()).abs().max().item(),
            ref.float().abs().max().item())


def pair_checks(gen: torch.Generator, timed: bool = False) -> dict:
    """K5 against its plain version within KERNEL_TOL at the shallow64
    shapes (batch 24) and ``PAIR_EXTRA``; at each 360x480 shape also
    against K4 and, at 64->64, the raw form with a bias. ``timed``: K5, K4,
    plain and cuDNN-conv-alone times at those shapes. Returns {shape: {err,
    scale, and the times}}."""
    dev = torch.device("cuda")
    out = {}
    cases = [(PAIR_BATCH,) + s for s in PAIR_SHAPES] + list(PAIR_EXTRA)
    for shape in cases:
        n, h, w, cin, cout = shape
        x = torch.randn(n, h, w, cin, generator=gen, device=dev
                        ).to(torch.bfloat16)
        wt = (torch.randn(3, 3, cin, cout, generator=gen, device=dev)
              * (2.0 / (9 * cin)) ** 0.5).to(torch.bfloat16)
        a = torch.rand(cout, generator=gen, device=dev) + 0.5
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        got = fused_conv_pair.conv3x3_pair_bn_relu(x, wt, a, b)
        ref = fused_conv_pair.conv3x3_pair_bn_relu_plain(x, wt, a, b)
        torch.cuda.synchronize()
        err, scale = _rel_err(got, ref)
        r = out[shape] = {"err": err, "scale": scale}
        line = [f"K5 {n}x{h}x{w} {cin}->{cout}: vs plain max|err| {err:.4g}"
                f" / max|plain| {scale:.4g} = {err / scale:.3g} (tol "
                f"{KERNEL_TOL})"]
        checks = [(err <= KERNEL_TOL * scale, f"K5 vs plain at {shape}")]
        full = shape[1:] in PAIR_SHAPES
        if full:
            k4_err, _ = _rel_err(got, fused_conv.conv3x3_bn_relu(x, wt, a, b))
            line.append(f"vs K4 {k4_err / scale:.3g}")
            checks.append((k4_err <= KERNEL_TOL * scale,
                           f"K5 vs K4 at {shape}"))
        if full and cin == 64:
            ones = torch.ones(cout, device=dev)
            raw_err, raw_scale = _rel_err(
                fused_conv_pair.conv3x3_pair(x, wt, b),
                fused_conv_pair.conv3x3_pair_bn_relu_plain(
                    x, wt, ones, b, relu=False))
            line.append(f"raw conv3x3_pair + bias vs plain "
                        f"{raw_err / raw_scale:.3g}")
            checks.append((raw_err <= KERNEL_TOL * raw_scale,
                           f"raw K5 vs plain at {shape}"))
        print("; ".join(line), flush=True)
        for ok, what in checks:
            check(ok, what)
        if full and timed:
            xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
            r.update(
                ms=cuda_ms(lambda: fused_conv_pair.conv3x3_pair_bn_relu(
                    x, wt, a, b), iters=10),
                k4_ms=cuda_ms(lambda: fused_conv.conv3x3_bn_relu(
                    x, wt, a, b), iters=10),
                plain_ms=cuda_ms(
                    lambda: fused_conv_pair.conv3x3_pair_bn_relu_plain(
                        x, wt, a, b), iters=10),
                library_ms=cuda_ms(lambda: F.conv2d(xc, wc, padding=1),
                                   iters=10))
            r["bound_ms"], r["bound_by"] = conv_bound(n, h, w, cin, cout)
            first = (f" (first design {PAIR_FIRST_MS[cin]})"
                     if n == PAIR_BATCH else "")
            print(f"K5 {n}x{h}x{w} {cin}->{cout}: K5 {r['ms']:.4f} ms{first}, "
                  f"K4 {r['k4_ms']:.4f}, plain "
                  f"{r['plain_ms']:.4f}, cuDNN conv alone "
                  f"{r['library_ms']:.4f}; bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}: K5 at {r['bound_ms'] / r['ms']:.3f} of "
                  f"it, K4 at {r['bound_ms'] / r['k4_ms']:.3f} (on "
                  f"{bench.card()})", flush=True)
        del x, got, ref
    torch.cuda.empty_cache()
    return out


def phase_pair_probe() -> int:
    """The slice's path: ``perf_probe --pair --shapes shallow64`` through
    its entry point. Returns K5's launches in that run."""
    torch.cuda.synchronize()
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = perf_probe.main(["--pair", "--shapes", "shallow64", "--k",
                              str(PAIR_PROBE_K)])
    torch.cuda.synchronize()
    launches = fused_conv_pair.conv3x3_pair_bn_relu.launches
    print(buf.getvalue(), end="", flush=True)
    rows = [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]
    want = sum(r["calls"] for r in rows)
    print(f"perf_probe --pair --shapes shallow64: {len(rows)} rows, K5 "
          f"launches {launches} (expected {want})", flush=True)
    check(rc == 0, "perf_probe exit code")
    check(sorted(tuple(r["shape"]) for r in rows)
          == sorted((PAIR_BATCH,) + s for s in PAIR_SHAPES)
          and all(r["impl"] == "pair" and r["multiplicity"] == 2
                  for r in rows), "perf_probe shallow64 rows")
    check(launches == want, "K5 launches in the probe run")
    for r in rows:
        check(np.isfinite(r["ms"]) and r["ms"] > 0
              and (r["tflops"] <= r["roofline_tflops"] or "suspect" in r),
              f"perf_probe row {r['shape']} over its roofline unflagged")
    return launches


# K5's f32 instance (phase 10): the error rule of phase 14 at
# ``F32_CHECK_BATCH`` on the shallow64 shapes, JAX's test shapes
# (tests/test_pallas_conv_pair.py: 12x30 8->8, 8x15 16->8, 20x24 8->16), a
# ragged 46x61 64->64 and Cin 80 -> 48 (a part chunk, a part tile of
# Cout), as (H, W, Cin, Cout); then the times at PAIR_BATCH
PAIR_F32_CHECKS = ((360, 480, 64, 64), (360, 480, 128, 64), (12, 30, 8, 8),
                   (8, 15, 16, 8), (20, 24, 8, 16), (46, 61, 64, 64),
                   (6, 11, 80, 48))


def pair_f32_checks(gen: torch.Generator, timed: bool = False) -> dict:
    """K5's f32 instance at ``PAIR_F32_CHECKS``: err(K5), err(K4 f32) and
    err(plain f32, TF32 off) against the same function in float64 on the
    card, K5 and K4 each under phase 14's rule; K5 twice on the same
    inputs bit-equal; at 64->64 the raw ``conv3x3_pair`` with a bias too.
    ``timed``: K5 f32, K4 f32, plain f32 and the library call (cuDNN's
    conv, TF32 off; TF32 on as a note) at PAIR_BATCH beside the bound, at
    each 360x480 shape. Prints each line before its checks; returns
    {(h, w, cin, cout): readings}."""
    out = {}
    for h, w, cin, cout in PAIR_F32_CHECKS:
        x, wt, _, a, b = f32_inputs(gen, F32_CHECK_BATCH, h, w, cin, cout)
        label = f"{F32_CHECK_BATCH}x{h}x{w} {cin}->{cout}"
        got = fused_conv_pair.conv3x3_pair_bn_relu(x, wt, a, b)
        again = fused_conv_pair.conv3x3_pair_bn_relu(x, wt, a, b)
        ref = torch.relu(conv64(x, wt) * a.double() + b.double())
        ek, ep, scale, limit = f32_variants.error_rule(
            got, fused_conv_pair.conv3x3_pair_bn_relu_plain(x, wt, a, b),
            ref)
        e4 = f32_variants.error_rule(fused_conv.conv3x3_bn_relu(x, wt, a, b),
                                     got, ref)[0]
        same = torch.equal(got, again)
        r = out[(h, w, cin, cout)] = {"err": ek, "plain_err": ep,
                                      "k4_err": e4, "scale": scale,
                                      "limit": limit}
        line = [f"K5 f32 {label}: {ek:.3g} (plain {ep:.3g}, K4 f32 "
                f"{e4:.3g}, max|f64| {scale:.4g}, limit {limit:.3g}); "
                f"twice bit-equal {same}"]
        checks = [(ek <= limit, f"K5 f32 error rule at {label}"),
                  (e4 <= limit, f"K4 f32 error rule at {label} (K5's "
                                f"inputs)"),
                  (same, f"K5 f32 bit-equal on two launches at {label}")]
        if (h, w, cin) == (360, 480, 64):
            ones = torch.ones(cout, device="cuda")
            raw = f32_variants.error_rule(
                fused_conv_pair.conv3x3_pair(x, wt, b),
                fused_conv_pair.conv3x3_pair_bn_relu_plain(
                    x, wt, ones, b, relu=False),
                conv64(x, wt) + b.double())
            line.append(f"raw conv3x3_pair + bias {raw[0]:.3g} (plain "
                        f"{raw[1]:.3g}, limit {raw[3]:.3g})")
            checks.append((raw[0] <= raw[3],
                           f"raw K5 f32 error rule at {label}"))
        print("; ".join(line), flush=True)
        for ok, what in checks:
            check(ok, what)
        del x, got, again, ref
        if timed and (h, w) == HW:
            x, wt, _, a, b = f32_inputs(gen, PAIR_BATCH, h, w, cin, cout)
            xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
            r.update(
                ms=cuda_ms(lambda: fused_conv_pair.conv3x3_pair_bn_relu(
                    x, wt, a, b), iters=10),
                k4_ms=cuda_ms(lambda: fused_conv.conv3x3_bn_relu(
                    x, wt, a, b), iters=10),
                plain_ms=cuda_ms(
                    lambda: fused_conv_pair.conv3x3_pair_bn_relu_plain(
                        x, wt, a, b), iters=10),
                library_ms=cuda_ms(lambda: F.conv2d(xc, wc, padding=1),
                                   iters=10))
            with tf32_convs():
                r["library_tf32_ms"] = cuda_ms(
                    lambda: F.conv2d(xc, wc, padding=1), iters=10)
            r["bound_ms"], r["bound_by"] = f32_bound(PAIR_BATCH, h, w, cin,
                                                     cout)
            print(f"K5 f32 {PAIR_BATCH}x{h}x{w} {cin}->{cout}: K5 "
                  f"{r['ms']:.4f} ms, K4 f32 {r['k4_ms']:.4f}, plain f32 "
                  f"{r['plain_ms']:.4f}, cuDNN f32 (TF32 off) "
                  f"{r['library_ms']:.4f}, TF32 on {r['library_tf32_ms']:.4f}"
                  f"; bound {r['bound_ms']:.4f} by {r['bound_by']} (the split "
                  f"product at {F32_SPLIT_RATE / 1e12:.1f} TFLOP/s): K5 at "
                  f"{r['bound_ms'] / r['ms']:.3f} of it, K4 at "
                  f"{r['bound_ms'] / r['k4_ms']:.3f} (on {bench.card()})",
                  flush=True)
            del x
        torch.cuda.empty_cache()
    return out


def pair_f32_entry(checks: dict, launches: int) -> dict:
    """The JSON entry of K5's f32 instance: 64->64's readings at the top
    level, 128->64's under ``"128_64"``; launches from the probe run."""
    def keys(r):
        return {"max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "library_tf32_ms": r["library_tf32_ms"],
                "k4_f32_ms": r["k4_ms"]}
    return {"name": "conv3x3_pair_bn_relu_f32", "route": "cuda",
            "source": "pytorch_camvid_tpu_torch/csrc/conv3x3_f32.cu",
            "replaces": "pytorch_camvid_tpu/ops/pallas_conv_pair.py:229",
            "launches": launches, **keys(checks[PAIR_SHAPES[0]]),
            "128_64": keys(checks[PAIR_SHAPES[1]])}


def phase_pair_f32_probe() -> dict:
    """K5's f32 instance on the slice's path: ``perf_probe.probe_shape(...,
    pair=True, dtype=torch.float32)`` at both shallow64 shapes, b24.
    Returns its rows and K5's f32 launches in them."""
    torch.cuda.synchronize()
    reset_counts()
    rows = [perf_probe.probe_shape(PAIR_BATCH, *s, k=PAIR_PROBE_K,
                                   pair=True, dtype=torch.float32)
            for s in PAIR_SHAPES]
    torch.cuda.synchronize()
    launches = fused_conv_pair.conv3x3_pair_bn_relu.dtype_launches["f32"]
    want = sum(r["calls"] for r in rows)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(f"perf_probe.probe_shape(pair=True, dtype=float32) at "
          f"shallow64: {len(rows)} rows, K5 f32 launches {launches} "
          f"(expected {want}; bf16 "
          f"{fused_conv_pair.conv3x3_pair_bn_relu.dtype_launches['bf16']})",
          flush=True)
    check(launches == want and fused_conv_pair.conv3x3_pair_bn_relu.launches
          == want, "K5 f32 launches in the probe run")
    for r in rows:
        check(r["impl"] == "pair" and r["dtype"] == "float32"
              and np.isfinite(r["ms"]) and r["ms"] > 0
              and (r["tflops"] <= r["roofline_tflops"] or "suspect" in r),
              f"perf_probe f32 row {r['shape']}")
    return {"rows": rows, "launches": launches}


# ----------------------------------------------------- layout probes (11)

_KEYS = [key for key, _, _ in mosaic_probes.PROBES]
# (JSON name, the tool's probes it covers, its pallas_call line)
PROBE_SITES = (("layout_probes.row_slice_f32", _KEYS[0:1], 59),
               ("layout_probes.row_slice_bf16", _KEYS[1:2], 70),
               ("layout_probes.row_slice_dynamic", _KEYS[2:3], 82),
               ("layout_probes.row_slice_matmul", _KEYS[3:4], 98),
               ("layout_probes.roll_rows", _KEYS[4:6], 113),
               ("layout_probes.sum_width_shifts", _KEYS[6:7], 137))
# each wrapper's launches per run of the tool, in probes
PROBE_WRAPPER_RUNS = {"layout_probes.row_slice": 2,
                      "layout_probes.row_slice_dynamic": 1,
                      "layout_probes.row_slice_matmul": 1,
                      "layout_probes.roll_rows": 2,
                      "layout_probes.sum_width_shifts": 1}
M4_RTOL, M4_ATOL = (mosaic_probes.M4_TOL[k] for k in ("rtol", "atol"))
# rows_kernel's device-busy ms per call before its redesign (one block per
# 64 rows x 512 bytes; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), printed
# beside this run's
ROWS_BEFORE_MS = {"layout_probes.row_slice_f32": 0.00206,
                  "layout_probes.row_slice_bf16": 0.00205,
                  "layout_probes.row_slice_dynamic": 0.00218,
                  "layout_probes.roll_rows": 0.00553}
# M6 at a conv stage (xp (H, W + 8, C), w = W: 360x480x64 f32) and at a
# ragged shape (H odd, w = 201 = 3 tiles of 64 columns + 9)
M6_SHAPES = ((360, 488, 64, 480), (45, 203, 64, 201))


def _within(got: torch.Tensor, ref: torch.Tensor, rtol: float,
            atol: float) -> bool:
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


def probe_cases(t: dict) -> dict:
    """Per probe of the tool, on its inputs ``t`` (``mosaic_probes.inputs``):
    (kernel, plain version, library call, FLOPs, least bytes, FLOP rate).
    The bytes are what the function must move: the rows or columns it
    reads, once, and its output, once."""
    x32, x16, w, xp, s = (t[k] for k in ("x32", "x16", "w", "xp", "s"))
    n, dw = mosaic_probes.N, mosaic_probes.D_W
    rows, cols = x32.shape
    k, m = w.shape
    h, _, c = xp.shape
    kern = mosaic_probes.probes(t)
    bf16 = bench.H100_BF16_PEAK
    return {
        _KEYS[0]: (kern[_KEYS[0]], lambda: lp.row_slice_plain(x32, 1, n),
                   lambda: x32[1:1 + n].clone(), 0, 2 * n * cols * 4, bf16),
        _KEYS[1]: (kern[_KEYS[1]], lambda: lp.row_slice_plain(x16, 1, n),
                   lambda: x16[1:1 + n].clone(), 0, 2 * n * cols * 2, bf16),
        _KEYS[2]: (kern[_KEYS[2]],
                   lambda: lp.row_slice_dynamic_plain(x32, s, n),
                   lambda: x32[mosaic_probes.DYN_START:
                               mosaic_probes.DYN_START + n].clone(),
                   0, 2 * n * cols * 4 + 4, bf16),
        _KEYS[3]: (kern[_KEYS[3]],
                   lambda: lp.row_slice_matmul_plain(x32, w, 1, n),
                   lambda: torch.matmul(x32[1:1 + n], w), 2 * n * k * m,
                   4 * (n * k + k * m + n * m), bench.H100_F32_PEAK),
        _KEYS[4]: (kern[_KEYS[4]], lambda: lp.roll_rows_plain(x32, 1),
                   lambda: torch.roll(x32, 1, 0), 0, 2 * rows * cols * 4,
                   bf16),
        _KEYS[5]: (kern[_KEYS[5]], lambda: lp.roll_rows_plain(x16, 1),
                   lambda: torch.roll(x16, 1, 0), 0, 2 * rows * cols * 2,
                   bf16),
        _KEYS[6]: (kern[_KEYS[6]], lambda: lp.sum_width_shifts_plain(xp, dw),
                   lambda: xp.unfold(1, 3, 1)[:, :dw].sum(-1), 0,
                   4 * h * c * (2 * dw + 2), bf16),
    }


def _probe_err(key: str, got: torch.Tensor, ref: torch.Tensor,
               what: str) -> float:
    """Bit equality, or M4's tolerance; returns max |got - ref|."""
    if key == _KEYS[3]:
        err, scale = _rel_err(got, ref)
        print(f"M4 {what}: max|kernel - plain| {err:.4g} / max|plain| "
              f"{scale:.4g} = {err / scale:.3g} (rtol {M4_RTOL}, atol "
              f"{M4_ATOL})", flush=True)
        check(_within(got, ref, M4_RTOL, M4_ATOL), f"M4 vs plain ({what})")
        return err
    same, err = bit_equal(got, ref)
    check(same, f"{key} bit equality ({what}): max|err| {err:.4g}")
    return err


def probe_checks(gen: torch.Generator) -> dict:
    """Each layout-probe kernel against its plain version on the tool's
    inputs (bit for bit, M4 within the tool's tolerance), then at ragged
    shapes: several row blocks and column tiles, offsets clamped below 0
    and past the end, a roll by 77, a matmul with ragged K, N and rows, and
    M6 at ``M6_SHAPES``. Returns {probe key: max abs error}."""
    dev = torch.device("cuda")
    t = mosaic_probes.inputs(dev)
    errs = {}
    for key, (kern, plain, *_rest) in probe_cases(t).items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        errs[key] = _probe_err(key, got, ref, "the tool's inputs")
    x = torch.randn(300, 200, generator=gen, device=dev)
    xb = x.to(torch.bfloat16)
    wm = torch.randn(132, 68, generator=gen, device=dev)
    xm = torch.randn(100, 132, generator=gen, device=dev)
    ragged = [(_KEYS[0], "300x200 f32 rows 5..155",
               lp.row_slice(x, 5, 150), lp.row_slice_plain(x, 5, 150)),
              (_KEYS[1], "300x200 bf16 rows 9..300",
               lp.row_slice(xb, 9, 291), lp.row_slice_plain(xb, 9, 291)),
              (_KEYS[4], "300x200 bf16 roll 77",
               lp.roll_rows(xb, 77), lp.roll_rows_plain(xb, 77)),
              (_KEYS[3], "100x132 @ 132x68 rows 7..77",
               lp.row_slice_matmul(xm, wm, 7, 70),
               lp.row_slice_matmul_plain(xm, wm, 7, 70))]
    for s in (-4, 1000, 131):
        sd = torch.tensor([s], dtype=torch.int32, device=dev)
        ragged.append((_KEYS[2], f"300x200 f32 offset {s}, 100 rows",
                       lp.row_slice_dynamic(x, sd, 100),
                       lp.row_slice_dynamic_plain(x, sd, 100)))
    for h, wp, c, w in M6_SHAPES:
        xp = torch.randn(h, wp, c, generator=gen, device=dev)
        ragged.append((_KEYS[6], f"xp {h}x{wp}x{c}, w {w}",
                       lp.sum_width_shifts(xp, w),
                       lp.sum_width_shifts_plain(xp, w)))
    # M4 twice on the same inputs: one launch a call, the same bits
    before = lp.row_slice_matmul.launches
    twice = [lp.row_slice_matmul(xm, wm, 7, 70) for _ in range(2)]
    torch.cuda.synchronize()
    for key, what, got, ref in ragged:
        errs[key] = max(errs[key], _probe_err(key, got, ref, what))
    check(lp.row_slice_matmul.launches - before == 2,
          "M4: one launch per call")
    same, diff = bit_equal(twice[0], twice[1])
    check(same, f"M4: two calls on the same inputs differ by {diff:.4g}")
    print("M4: two calls on the same inputs are bit-equal, one launch each",
          flush=True)
    print(f"layout probes: every kernel equals its plain version on the "
          f"tool's inputs and at {len(ragged)} other shapes (bit for bit; "
          f"M4 within rtol {M4_RTOL}, atol {M4_ATOL})", flush=True)
    return errs


def device_ms(fn, bound: float = 0.0) -> float:
    """Device-busy ms per call over ``mosaic_probes.ITERS`` calls after a
    warm-up (``perf_probe.time_op``, as the probe tool times its kernels);
    a trace busy for less than ``bound`` ms a call (the least time the card
    could take) is taken again."""
    return perf_probe.time_op(fn, mosaic_probes.ITERS,
                              torch.device("cuda"), bound)[1]


def within_bound(ms: float, bound: float, what: str) -> None:
    """Fails unless the reading ``ms`` takes at least the least time the
    card could take, ``bound`` (a reading under it lost records)."""
    check(bound <= ms, f"{what}: {ms:.5f} ms at or above its bound "
                       f"{bound:.5f} ms")


def m6_conv_stage() -> None:
    """M6 at the conv stage of ``M6_SHAPES``: kernel, plain and library
    device times beside the byte bound, and the kernel's by CUDA events."""
    h, wp, c, w = M6_SHAPES[0]
    xp = torch.randn(h, wp, c, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    bound = bound_ms(0, 4 * h * c * (2 * w + 2))[0]
    r = {"ms": device_ms(lambda: lp.sum_width_shifts(xp, w), bound),
         "events_ms": cuda_ms(lambda: lp.sum_width_shifts(xp, w)),
         "plain_ms": device_ms(lambda: lp.sum_width_shifts_plain(xp, w),
                               bound),
         "library_ms": device_ms(
             lambda: xp.unfold(1, 3, 1)[:, :w].sum(-1), bound),
         "bound_ms": bound}
    print(f"M6 sum_width_shifts at xp {h}x{wp}x{c} -> {h}x{w}x{c} f32, "
          f"device-busy ms per call: kernel {r['ms']:.5f} "
          f"({r['events_ms']:.5f} by events), plain {r['plain_ms']:.5f}, "
          f"library "
          f"{r['library_ms']:.5f}, byte bound {r['bound_ms']:.5f}: kernel "
          f"at {r['bound_ms'] / r['ms']:.3f} of it ({bench.card()})",
          flush=True)


def probe_launches_ok(launches: int, runs: int) -> bool:
    """``runs`` probe runs' launches: each run one launch for the checked
    call and each warm-up call, and ``mosaic_probes.ITERS`` for each
    profiler trace ``perf_probe.time_op`` took (1 to ``TRACE_TRIES``: it
    takes a trace again when one holds no device records)."""
    extra = launches - runs * mosaic_probes.calls_per_probe("cuda")
    return (extra >= 0 and extra % mosaic_probes.ITERS == 0 and extra
            <= runs * (perf_probe.TRACE_TRIES - 1) * mosaic_probes.ITERS)


def phase_probes(gen: torch.Generator) -> list:
    """Phase 11: the slice's entry point, ``python -m
    pytorch_camvid_tpu_torch.mosaic_probes`` (through
    ``mosaic_probes.main``), with each probe's launches counted; then the
    kernels against their plain versions (``probe_checks``), the plain and
    library times and M6 at a conv stage. Returns the JSON entries."""
    torch.cuda.synchronize()
    reset_counts()
    records = []
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mosaic_probes.main([], records)
    torch.cuda.synchronize()
    counts = lp.launches()
    print(buf.getvalue(), end="", flush=True)
    per = mosaic_probes.calls_per_probe("cuda")
    print(f"mosaic_probes: launches {counts} ({per} per probe: the checked "
          f"call, {perf_probe.WARMUP} warm-up and {mosaic_probes.ITERS} "
          f"timed)", flush=True)
    check(rc == 0, "mosaic_probes exit code")
    check([r["key"] for r in records] == _KEYS
          and all(r["ok"] and probe_launches_ok(r["launches"], 1)
                  for r in records),
          "mosaic_probes: a probe failed or its kernel launched other than "
          "once per call")
    check(set(counts) == set(PROBE_WRAPPER_RUNS)
          and all(probe_launches_ok(counts[k], n)
                  for k, n in PROBE_WRAPPER_RUNS.items())
          and sum(counts.values()) == sum(r["launches"] for r in records),
          "layout probe launches in the tool's run")
    errs = probe_checks(gen)
    rec = {r["key"]: r for r in records}
    cases = probe_cases(mosaic_probes.inputs("cuda"))
    entries = []
    for name, keys, line in PROBE_SITES:
        e = {"name": name, "route": "cuda",
             "source": "pytorch_camvid_tpu_torch/csrc/layout_probes.cu",
             "replaces": f"tools/mosaic_probes.py:{line}",
             "launches": sum(rec[k]["launches"] for k in keys),
             "max_abs_err": max(errs[k] for k in keys),
             "ms": sum(rec[k]["ms"] for k in keys),
             "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
             "library_ms": 0.0}
        for k in keys:
            _, plain, lib, flops, nbytes, peak = cases[k]
            e["plain_ms"] += device_ms(plain)
            e["library_ms"] += device_ms(lib)
            b, e["bound_by"] = bound_ms(flops, nbytes, peak)
            e["bound_ms"] += b
        gross = sum(rec[k]["ms_gross"] for k in keys)
        before = ROWS_BEFORE_MS.get(name)
        print(f"{name} ({'+'.join(keys)}), device-busy ms per call: kernel "
              f"{e['ms']:.5f} ({gross:.5f} by events), plain "
              f"{e['plain_ms']:.5f}, library {e['library_ms']:.5f} "
              f"({e['ms'] / e['library_ms']:.2f}x it), bound "
              f"{e['bound_ms']:.3g} by {e['bound_by']}"
              + (f"; before rows_kernel's redesign {before}" if before
                 else ""), flush=True)
        entries.append(e)
    m6_conv_stage()
    return entries


# ------------------------------------------------- the training run (12)

RUN_BATCH, RUN_EPOCHS = 10, 2
RUN_SPLITS = {"train": (40, 1), "val": (13, 2)}   # images, seed
RUN_STOP = 6   # run B's preemption point: batch 2 of epoch 2
# a step's K1 launches and a forward's K4 launches of UNet
UNET_STEP = {"fwd": 23, "dgrad": 22, "wgrad": 23}
PREDICT_AGREE = 0.999   # Predictor's maps vs the eval pass's argmax


def write_training_data(root: str) -> str:
    """The CamVid split caches that ``data/camvid.py`` reads at 360x480,
    from ``synthetic_arrays`` with fixed seeds (the card's host has no cv2
    to decode a tree; the cache is what later runs of a real one read)."""
    for split, (n, seed) in RUN_SPLITS.items():
        images, labels = synthetic_arrays(n, HW, seed=seed)
        camvid.write_cache(camvid.cache_path(root, split, HW[::-1]), images,
                           labels, [f"{split}{i:03d}.png" for i in range(n)])
    return root


def run_argv(data: str) -> list:
    """Run A's arguments: one process (``-dp 1``) on the first card."""
    return ["-net", "unet", "-b", str(RUN_BATCH), "-e", str(RUN_EPOCHS),
            "-dtype", "bfloat16", "-quiet", "-data", data, "-image_size",
            str(HW[1]), str(HW[0]), "-dp", "1"]


def cadence(history, epochs: int, save_epoch: int) -> list:
    """The checkpoint names the loop's rule gives for ``history``'s mIoUs:
    best past epochs // 2 when the mIoU beats every earlier one, which
    skips the regular save; regular every ``save_epoch``."""
    names, best = [], 0.0
    for h in history:
        if best < h["miou"] and h["epoch"] > epochs // 2:
            best = h["miou"]
            names.append(f"{h['epoch']}-best.ckpt.npz")
        elif not h["epoch"] % save_epoch:
            names.append(f"{h['epoch']}-regular.ckpt.npz")
    return names


def leaves(path: str) -> dict:
    """A port checkpoint's leaves by name."""
    z = np.load(path, allow_pickle=False)
    payload = json.loads(str(z["__payload__"]))
    names = [n for n, _ in json.loads(payload["treedef"][len("torch:"):])]
    return {n: z[f"leaf_{i}"] for i, n in enumerate(names)}


def run_dir(workdir: str) -> str:
    (name,) = os.listdir(os.path.join(workdir, "checkpoints"))
    return os.path.join(workdir, "checkpoints", name)


def training_run_a(workdir: str, data: str) -> dict:
    """Run A through the train CLI: UNet, 2 epochs of 4 steps at batch 10,
    bf16, quiet, with the loop's eval pass (13 images, a ragged last batch
    of 3) after each epoch. Checks the epochs, the steps (the NaN guard
    reads every step's loss), the checkpoint files against the cadence,
    K1's launches (8 steps) and K4's (2 eval batches a pass, 2 passes)."""
    os.makedirs(workdir)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(workdir):
        history = train_cli.main(run_argv(data))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, paths = conv_train.launches(), conv_train.path_launches()
    k4 = (fused_conv.conv3x3_bn_relu.launches - counts["fwd"]
          - counts["dgrad"])
    k4_paths = {p: fused_conv.conv3x3_bn_relu.path_launches[p]
                - paths["fwd"][p] - paths["dgrad"][p]
                for p in fused_conv.ROUTES}
    steps = RUN_EPOCHS * RUN_SPLITS["train"][0] // RUN_BATCH
    evals = RUN_EPOCHS * -(-RUN_SPLITS["val"][0] // RUN_BATCH)
    files = sorted(os.listdir(run_dir(workdir)))
    want = cadence(history, RUN_EPOCHS, settings.SAVE_EPOCH)
    print(f"training run A (train CLI, UNet b{RUN_BATCH}, {RUN_EPOCHS} "
          f"epochs, {HW[0]}x{HW[1]}, bf16): mIoU "
          f"{[round(h['miou'], 4) for h in history]}, checkpoints {files} "
          f"(cadence {want}); K1 launches {counts} on each path {paths}; "
          f"K4 launches in the eval passes {k4} on each path {k4_paths}; "
          f"{wall:.2f} s in all", flush=True)
    check([h["epoch"] for h in history] == [1, 2], "run A's epochs")
    check(all(np.isfinite(h["miou"]) for h in history), "run A's mIoU")
    check(bool(want) and files == sorted(want), "run A's checkpoints")
    final = os.path.join(run_dir(workdir), want[-1])
    check(int(leaves(final)["step"]) == steps, "run A's steps")
    check(counts == {k: v * steps for k, v in UNET_STEP.items()},
          "run A's K1 launches")
    check(paths == path_counts("unet", steps), "run A's K1 paths")
    check(k4 == UNET_STEP["fwd"] * evals, "run A's K4 launches")
    check(k4_paths == path_counts("unet", evals)["fwd"], "run A's K4 paths")
    return {"history": history, "ckpt": final, "wall_s": wall}


def splits(data: str) -> tuple:
    """The train and val splits of ``write_training_data``."""
    return tuple(camvid.CamVid(data, image_set=s, image_size=HW[::-1])
                 for s in ("train", "val"))


def loop_config(checkpoint_dir: str, **kw) -> loop.TrainConfig:
    """Run A's configuration as ``loop.run_training`` takes it (``kw``
    sets or overrides fields)."""
    return loop.TrainConfig(**{
        **dict(net="unet", batch_size=RUN_BATCH, epochs=RUN_EPOCHS,
               compute_dtype="bfloat16", quiet=True,
               checkpoint_dir=checkpoint_dir, save_epoch=settings.SAVE_EPOCH),
        **kw})


def loop_run(workdir: str, data: str, a: dict) -> dict:
    """Run C: run A's configuration through ``loop.run_training`` without
    the CLI's logger (``utils/tb.py``, which writes each step's scalars),
    in a process that has run the loop. Its final state must equal run
    A's bit for bit; its epochs time the loop without the logging."""
    ckpt_dir = os.path.join(workdir, "checkpoints", "c")
    _, history = loop.run_training(loop_config(ckpt_dir), *splits(data))
    (name,) = cadence(history, RUN_EPOCHS, settings.SAVE_EPOCH)
    got, want = leaves(os.path.join(ckpt_dir, name)), leaves(a["ckpt"])
    unequal = [n for n in want if not np.array_equal(got[n], want[n])]
    print(f"training run C (loop.run_training, no logger): mIoU "
          f"{[round(h['miou'], 4) for h in history]}; leaves unequal to run "
          f"A's: {len(unequal)} of {len(want)}", flush=True)
    check(not unequal, "run C bit-equal to run A")
    return {"history": history}


def resume_checks(workdir: str, data: str, a: dict) -> None:
    """Run B: ``run_training`` stopped after ``RUN_STOP`` batches (the JAX
    CLI has no flag for it either) must save ``1-preempt``; then the train
    CLI's ``-resume`` in B's directory finishes at step 8, and B's final
    state (weights, BN stats, moments, step, generator) must equal run A's
    bit for bit."""
    preempted = os.path.join(workdir, "checkpoints", "preempted")
    state, _ = loop.run_training(loop_config(preempted,
                                             stop_after_batches=RUN_STOP),
                                 *splits(data))
    files = sorted(os.listdir(preempted))
    print(f"training run B: stopped at step {state.step}, checkpoints "
          f"{files}", flush=True)
    check(state.step == RUN_STOP and files == ["1-preempt.ckpt.npz"],
          "run B's preemption checkpoint")
    del state
    with contextlib.chdir(workdir):
        history = train_cli.main(run_argv(data) + ["-resume"])
    check([h["epoch"] for h in history] == [2], "the resumed run's epochs")
    (name,) = cadence(history, RUN_EPOCHS, settings.SAVE_EPOCH)
    got = leaves(os.path.join(workdir, "checkpoints",
                              settings.TIME_NOW, name))
    want = leaves(a["ckpt"])
    unequal = sorted(n for n in want if not np.array_equal(got[n], want[n]))
    worst = max((float(np.abs(got[n].astype(np.float64)
                              - want[n].astype(np.float64)).max())
                 for n in unequal), default=0.0)
    print(f"training run B resumed (train CLI -resume): step "
          f"{int(got['step'])}, mIoU {history[0]['miou']:.4f} (A's "
          f"{a['history'][-1]['miou']:.4f}); leaves unequal to run A's: "
          f"{len(unequal)} of {len(want)} {unequal[:6]}, max |diff| "
          f"{worst:.4g}", flush=True)
    check(int(got["step"]) == RUN_EPOCHS * 4, "the resumed run's step")
    check(not unequal, "preemption + resume bit-equal to run A")


def eval_checks(data: str, a: dict) -> np.ndarray:
    """The eval CLI on run A's last checkpoint must print the mIoU of A's
    last epoch (4 decimals), and equal the mIoU of the class maps of the
    13 val images computed here from the same weights (the eval pass's
    argmax, batches of 10); K4 launches once per block and batch. Returns
    those maps."""
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        got = eval_cli.main(["-weight", a["ckpt"], "-net", "unet", "-b",
                             str(RUN_BATCH), "-dtype", "bfloat16", "-data",
                             data, "-image_size", str(HW[1]), str(HW[0])])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4 = fused_conv.conv3x3_bn_relu.launches
    sd = ckpt.load_weights(a["ckpt"], "unet")
    model = get_model("unet", spec=spec_from_state_dict("unet", sd))
    model.load_state_dict(sd)
    model = model.cuda().eval()
    val = camvid.CamVid(data, image_set="val", image_size=HW[::-1])
    maps = []
    with torch.inference_mode():
        for lo in range(0, len(val), RUN_BATCH):
            x = torch.from_numpy(val.images[lo: lo + RUN_BATCH]).cuda()
            maps.append(model(to_tensor_normalize(
                x, settings.MEAN, settings.STD, torch.bfloat16)).argmax(-1))
    maps = torch.cat(maps)
    cm = confusion_matrix(maps, torch.from_numpy(val.labels).cuda(), 12,
                          val.ignore_index).double().cpu()
    keep = [i for i in range(12) if i != val.ignore_index]
    ref = float(np.nanmean(iou_from_confusion(cm).numpy()[keep]))
    want_line = f"miou: {a['history'][-1]['miou']:.4f}"
    print(f"eval CLI on run A's {os.path.basename(a['ckpt'])}: "
          f"{' | '.join(out.getvalue().splitlines()[1:])}; A's last epoch "
          f"{want_line}; mIoU of the maps computed here {ref:.6f} (CLI "
          f"{got['miou']:.6f}); K4 launches {k4}; {wall:.2f} s", flush=True)
    check(want_line in out.getvalue().splitlines(),
          "eval CLI prints run A's mIoU")
    check(abs(got["miou"] - ref) <= 1e-9, "eval CLI's mIoU over all 13 "
          "val images")
    check(k4 == UNET_STEP["fwd"] * -(-len(val) // RUN_BATCH),
          "eval CLI's K4 launches")
    return maps.cpu().numpy()


def predictor_checks(data: str, a: dict, maps: np.ndarray) -> None:
    """``Predictor.from_checkpoint`` on run A's ``.ckpt.npz`` serves the
    13 val images; its maps must agree with the eval pass's argmax on at
    least PREDICT_AGREE of the pixels."""
    val = camvid.CamVid(data, image_set="val", image_size=HW[::-1])
    with Predictor.from_checkpoint("unet", a["ckpt"], batch_size=BATCH,
                                   image_hw=HW) as p:
        got = p.predict(val.images)
    agree = float((got == maps).mean())
    print(f"Predictor.from_checkpoint(run A's .ckpt.npz) on the 13 val "
          f"images: agrees with the eval pass's argmax on {agree:.6f} of "
          f"the pixels (limit {PREDICT_AGREE})", flush=True)
    check(got.shape == maps.shape and agree >= PREDICT_AGREE,
          "Predictor's maps vs the eval pass")


def finite_rows(obj) -> bool:
    if isinstance(obj, dict):
        return all(finite_rows(v) for v in obj.values())
    if isinstance(obj, float):
        return bool(np.isfinite(obj))
    return True


def phase_training_run(tmp: str) -> dict:
    """Phase 12: the training run through the port's entry points (module
    docstring), its files under ``tmp``; returns the bench JSON object
    ("bench"), the CamVid caches' root ("data") and run A ("a")."""
    data = write_training_data(os.path.join(tmp, "data"))
    a = training_run_a(os.path.join(tmp, "a"), data)
    resume_checks(os.path.join(tmp, "b"), data, a)
    maps = eval_checks(data, a)
    predictor_checks(data, a, maps)
    c = loop_run(os.path.join(tmp, "c"), data, a)
    torch.cuda.empty_cache()
    model = bench.he_model("unet", torch.Generator().manual_seed(SEED))
    r = bench.measure_train(model.cuda(), RUN_BATCH, seed=SEED)
    del model
    torch.cuda.empty_cache()
    n = RUN_SPLITS["train"][0]
    steps = n // RUN_BATCH
    for name, h in [("A", h) for h in a["history"]] + [
            ("C", h) for h in c["history"]]:
        print(f"training run {name} epoch {h['epoch']}: "
              f"{h['train_s'] * 1e3:.1f} "
              f"ms for its {steps} steps ({n / h['train_s']:.2f} img/s) "
              f"against {steps} x measure_train's b{RUN_BATCH} step "
              f"{r['step_ms']:.2f} ms = {steps * r['step_ms']:.1f} ms "
              f"({r['images_per_sec']:.2f} img/s); its eval pass "
              f"{h['eval_s'] * 1e3:.1f} ms ({RUN_SPLITS['val'][0]} images) "
              f"on {bench.card()}", flush=True)
    out = bench.main([])
    print(f"bench: {json.dumps(out)}", flush=True)
    check(set(out) == {"metric", "value", "unit", "vs_baseline", "mfu",
                       "extra"}
          and out["metric"] == "camvid_unet_360x480_train_images_per_sec"
                               "_per_chip"
          and set(out["extra"]) == {"unet_train", "segnet_train",
                                    "unet_serving_fwd", "segnet_serving_fwd"},
          "bench's keys")
    check(finite_rows(out) and all("card" in row
                                   for row in out["extra"].values()),
          "bench's rows")
    return {"bench": out, "data": data, "a": a, "c": c}


# ------------------------------------------- the data side and LR finder (13)

AUG_BATCH = 10
AUG_MASK_EQUAL = 0.9999   # masks, CUDA vs the CPU port: equal but at ties
# images, CUDA vs the CPU port, on the 0-255 scale, per recipe: the warps'
# cos, sin and the blur's exp differ by ulps between the devices, so a
# value at a rounding tie of the blur or the brightness LUT moves by one
# (the LR finder's recipe); the saturation's and hue's uint8 HSV round
# trip can widen that, a hue unit moving a channel by up to 6 (the full
# jitter)
AUG_IMAGE_TOL = {"lr_finder": 2.0, "full_jitter": 7.0}
AUG_RECIPES = {
    "lr_finder": dict(rotation_p=0.5, rotation_angle=10, random_scale=True),
    "full_jitter": dict(jitter_p=0.2, jitter_brightness=0.4,
                        jitter_contrast=0.4, jitter_saturation=0.4,
                        jitter_hue=0.1),
}
LR_SWEEPS = (("unet", 12), ("segnet", 4))   # (net, -num_it) at -b 10
LR_PLAIN_STEPS = 2   # the first steps held against the plain path
VOC_CLASSES, VOC_PAD = 21, 30   # letterbox rows of 255 at top and bottom
LOSS_RECOMPUTE_TOL = 1e-5   # the step's loss vs F.cross_entropy, f32
HEAD_BATCHES = (10, 24)
DEVICE = torch.device("cuda")   # phases 13 and 17 (a rehearsal sets the CPU)


def aug_config(name: str) -> augment.AugmentConfig:
    return augment.AugmentConfig(mean=settings.MEAN, std=settings.STD,
                                 rotation_fill=11, scale_fill=11,
                                 **AUG_RECIPES[name])


def augment_checks() -> dict:
    """Part 1: each recipe at b10, 360x480, on one fixed set of draws, on
    CUDA and on the CPU port: masks equal on AUG_MASK_EQUAL of the pixels
    (all but warp ties), images within the recipe's AUG_IMAGE_TOL; ms a
    batch of each op on the card. Returns {op: ms}."""
    images, labels = synthetic_arrays(AUG_BATCH, HW, seed=SEED + 3)
    x_cpu, m_cpu = torch.from_numpy(images), torch.from_numpy(labels)
    x, m = x_cpu.to(DEVICE), m_cpu.to(DEVICE)
    for name in AUG_RECIPES:
        cfg = aug_config(name)
        draws = augment.sample_draws(torch.Generator().manual_seed(SEED),
                                     AUG_BATCH, cfg, "cpu")
        got_x, got_m = augment.augment_with_draws(
            cfg, x, m, {k: v.to(DEVICE) for k, v in draws.items()})
        want_x, want_m = augment.augment_with_draws(cfg, x_cpu, m_cpu, draws)
        scale = torch.tensor(cfg.std) * 255.0
        err = ((got_x.cpu() - want_x).abs() * scale).max().item()
        equal = (got_m.cpu() == want_m).double().mean().item()
        print(f"augment {name} b{AUG_BATCH} {HW[0]}x{HW[1]}, CUDA vs the "
              f"CPU port on one set of draws: masks equal on {equal:.6f} "
              f"of the pixels (limit {AUG_MASK_EQUAL}), images max |err| "
              f"{err:.4g} on the 0-255 scale (limit "
              f"{AUG_IMAGE_TOL[name]})", flush=True)
        check(equal >= AUG_MASK_EQUAL, f"augment {name}: masks CUDA vs CPU")
        check(err <= AUG_IMAGE_TOL[name],
              f"augment {name}: images CUDA vs CPU")
    cfg = augment.AugmentConfig(**{**aug_config("lr_finder")._asdict(),
                                   **AUG_RECIPES["full_jitter"]})
    d = augment.sample_draws(torch.Generator(DEVICE).manual_seed(SEED),
                             AUG_BATCH, cfg, DEVICE)
    xf = x.float()
    jit = {k: d[k] for k in ("brightness", "contrast", "saturation", "hue")}
    ops = {
        "rotation": lambda: augment.rotate(xf, m, d["rotation_angle"], 11),
        "scale_pad_crop": lambda: augment.scale_pad_crop(
            xf, m, d["scale_s"], d["scale_uy"], d["scale_ux"], 11),
        "blur": lambda: augment.gaussian_blur(xf, d["blur_sigma"],
                                              d["blur_apply"]),
        "hflip": lambda: augment.hflip(xf, m, d["flip"]),
        "brightness": lambda: augment.adjust_brightness(xf, jit["brightness"]),
        "contrast": lambda: augment.adjust_contrast(xf, jit["contrast"]),
        "saturation": lambda: augment.adjust_saturation(xf,
                                                        jit["saturation"]),
        "hue": lambda: augment.adjust_hue(xf, jit["hue"]),
        "jitter (4 ops, random order)": lambda: augment.color_jitter(
            xf, jit, d["jitter_perm"]),
        "normalize": lambda: to_tensor_normalize(xf, settings.MEAN,
                                                 settings.STD,
                                                 torch.bfloat16)}
    for name in AUG_RECIPES:
        c = aug_config(name)
        dd = augment.sample_draws(torch.Generator(DEVICE).manual_seed(SEED),
                                  AUG_BATCH, c, DEVICE)
        ops[f"recipe {name}"] = (
            lambda c=c, dd=dd: augment.augment_with_draws(
                c, x, m, dd, torch.bfloat16))
    times = {k: cuda_ms(fn, iters=10) for k, fn in ops.items()}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops["jitter (4 ops, random order)"]()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    print(f"augment ms a batch (b{AUG_BATCH}, {HW[0]}x{HW[1]}, f32): "
          + "; ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; the 4-op jitter's peak memory {peak:.0f} MiB above its "
          f"input on {bench.card()}", flush=True)
    return times


def copied_state(state: TrainState) -> TrainState:
    """A copy of ``state`` that a step can take without touching it."""
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return TrainState(model=copy.deepcopy(state.model),
                      opt_state=copy.deepcopy(state.opt_state),
                      step=state.step, generator=gen)


def step_result(state: TrainState, met: dict) -> dict:
    """A first step's per-leaf gradients (AdamW's first moment after one
    update from zero is (1 - beta1) g) and the BN running stats after it,
    copied."""
    b1 = float(met["beta1"])
    return {"grads": {k: v / (1.0 - b1)
                      for k, v in state.opt_state["m"].items()},
            "stats": {k: v.float().clone()
                      for k, v in state.model.state_dict().items()
                      if "running" in k}}


@contextlib.contextmanager
def checked_sweep(out: dict, owner=lr_finder,
                  plain_steps: int = LR_PLAIN_STEPS):
    """Inside the block every train step that ``owner`` (a module calling
    its ``make_train_step``: the LR finder, or the training loop) builds
    runs under ``shadowed_kernels``: a step's errors join out["shadow"]
    when its loss is finite (the LR finder's NaN stop's step is left out
    of the checks as it is of the curve), and its raw loss (before any
    smoothing) is appended to out["raw"]. Each of the first
    ``plain_steps`` steps is also taken on the plain path from a copy of
    the state before it, on the same batch and draws, at the kernel step's
    pool choices (``recorded_choices``, ``replayed_choices``):
    out["plain"] gets its raw loss, out["choices"] counts the choices
    replayed and out["plain_launches"] the kernel launches of the plain
    steps; out["first"] holds both paths' ``step_result`` of the first
    step and out["model"] the kernel path's model."""
    saved = owner.make_train_step
    out.update(raw=[], plain=[], shadow={}, choices=0, plain_launches=0)

    def make(*args, **kw):
        step = saved(*args, **kw)
        plain_step = saved(*args, **{**kw, "plain": True})

        def run(state, batch):
            errs = {}
            before = (copied_state(state)
                      if len(out["raw"]) < plain_steps else None)
            with shadowed_kernels(errs), \
                    recorded_choices(state.model) as choices:
                state, met = step(state, batch)
            out["raw"].append(float(met["loss"]))
            if np.isfinite(out["raw"][-1]):
                for piece, e in errs.items():
                    _note(out["shadow"], piece, e)
            if before is not None:
                launched = sum(train_counts().values())
                with replayed_choices(choices):
                    after, plain_met = plain_step(before, batch)
                out["plain"].append(float(plain_met["loss"]))
                out["choices"] += len(choices)
                out["plain_launches"] += (sum(train_counts().values())
                                          - launched)
                if "first" not in out:
                    out["first"] = {"kernel": step_result(state, met),
                                    "plain": step_result(after, plain_met)}
                    out["model"] = state.model
                del after
            return state, met
        return run

    owner.make_train_step = make
    try:
        yield out
    finally:
        owner.make_train_step = saved


def lr_finder_checks(data: str) -> dict:
    """Part 2: the LR finder CLI's sweep (its own argument parsing, no
    plot) on phase 12's CamVid caches, UNet 12 and SegNet 4 iterations at
    b10: the recorded lrs are the sweep's at 1..k, every loss finite, the
    sweep ends at num_it or its NaN stop, and K1's and K2's launches are a
    step's times the steps taken. The sweep again with every kernel call
    of every step held against its plain version on the same inputs
    (``shadowed_kernels``, SHADOW_TOL), and each of its first
    LR_PLAIN_STEPS steps also taken on the plain path from the same state
    and draws (``checked_sweep``): their raw losses agree within
    TRAIN_LOSS_TOL. Returns {net: s per iteration} of the first sweep."""
    out = {}
    for net, num_it in LR_SWEEPS:
        args = lr_finder.parser().parse_args(
            ["-net", net, "-b", str(RUN_BATCH), "-num_it", str(num_it),
             "-dtype", "bfloat16", "-data", data, "-image_size", str(HW[1]),
             str(HW[0])])
        torch.cuda.synchronize()
        reset_counts()
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            losses, lrs = lr_finder.sweep(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, paths = train_counts(), conv_train.path_launches()
        diverged = "diverged" in log.getvalue()
        steps = len(lrs) + diverged   # the NaN step ran, unrecorded
        c = {}
        with contextlib.redirect_stdout(io.StringIO()), checked_sweep(c):
            lr_finder.sweep(args)
        torch.cuda.synchronize()
        raw, plain_raw, shadow = c["raw"], c["plain"], c["shadow"]
        check(c["plain_launches"] == 0,
              f"lr_finder {net}: the plain path launched a kernel")
        sweep = lr_finder.exponential_sweep_lr(args.start_lr, args.end_lr,
                                               num_it)
        want_lrs = [sweep(i) for i in range(1, len(lrs) + 1)]
        k = min(LR_PLAIN_STEPS, len(raw), len(plain_raw))
        errs = [abs(raw[i] - plain_raw[i]) / abs(plain_raw[i])
                for i in range(k)]
        print(f"lr_finder -net {net} -b {RUN_BATCH} -num_it {num_it}: "
              f"{len(lrs)} iterations recorded, ended by "
              f"{'its NaN stop' if diverged else 'num_it'}; losses "
              f"{[round(float(v), 4) for v in losses]}; lrs "
              f"{[float(f'{v:.4g}') for v in lrs]}; launches {counts}, K1 "
              f"on each path {paths}; {wall / steps:.3f} s/iteration "
              f"({wall:.2f} s for {steps}, the first step's set-up "
              f"included) on {bench.card()}; again with each kernel call "
              f"against its plain version on the same inputs, worst per "
              f"piece over {len(raw)} steps: " + "; ".join(
                  f"{piece} {e:.3g} (tol {SHADOW_TOL[piece]})"
                  for piece, e in shadow.items())
              + f"; the first {k} raw losses vs the plain path's from the "
              f"same state and draws at the kernel steps' {c['choices']} "
              f"pool choices {[f'{e:.3g}' for e in errs]} (tol "
              f"{TRAIN_LOSS_TOL})",
              flush=True)
        check(list(lrs) == want_lrs, f"lr_finder {net}: the recorded lrs")
        check(bool(np.isfinite(losses).all()), f"lr_finder {net}: losses")
        check(len(lrs) == num_it or (diverged and len(lrs) < num_it),
              f"lr_finder {net}: the sweep's end")
        check(counts == expected_train_counts(net, steps),
              f"lr_finder {net}: launches")
        check(paths == path_counts(net, steps), f"lr_finder {net}: paths")
        want = [p for p in SHADOW_TOL if POOLS[net] or p.startswith("K1")]
        check(len(raw) == steps and sorted(shadow) == sorted(want),
              f"lr_finder {net}: kernel pieces seen")
        for piece, e in shadow.items():
            check(e <= SHADOW_TOL[piece],
                  f"lr_finder {net} {piece} on the step's data")
        check(k == LR_PLAIN_STEPS and max(errs) <= TRAIN_LOSS_TOL,
              f"lr_finder {net}: the first raw losses vs the plain path")
        out[net] = wall / steps
        del c
        torch.cuda.empty_cache()
    return out


def write_voc_data(root: str) -> str:
    """VOC split caches (``data/voc2012.py``'s files) at 360x480 from
    ``synthetic_arrays`` with 21 classes and the letterbox's rows (image
    0, label 255) at the top and the bottom."""
    for split, (n, seed) in RUN_SPLITS.items():
        images, labels = synthetic_arrays(n, HW, VOC_CLASSES, seed=seed)
        for rows in (slice(0, VOC_PAD), slice(-VOC_PAD, None)):
            images[:, rows], labels[:, rows] = 0, 255
        voc2012.write_cache(voc2012.cache_path(root, split, HW[::-1]),
                            images, labels, [f"{split}{i}" for i in range(n)])
    return root


@contextlib.contextmanager
def recomputed_losses(out: list):
    """Inside the block each training loss (logits that need a gradient)
    is also computed plainly, ``F.cross_entropy`` over the pixels whose
    label is not 255: ``out`` gets (loss, recomputed) pairs."""
    saved = steps_mod.cross_entropy_loss

    def loss_fn(logits, labels, *args, **kw):
        loss = saved(logits, labels, *args, **kw)
        if logits.requires_grad:
            with torch.no_grad():
                want = F.cross_entropy(
                    logits.detach().float().permute(0, 3, 1, 2),
                    labels.long(), ignore_index=255)
            out.append((loss.detach(), want))
        return loss

    steps_mod.cross_entropy_loss = loss_fn
    try:
        yield out
    finally:
        steps_mod.cross_entropy_loss = saved


def voc_checks(tmp: str, dtype: str = "bfloat16") -> None:
    """Part 3: ``train -dataset voc2012 -net unet -b 10 -e 1 -dtype
    <dtype>`` on VOC caches of 40 train and 13 val images, then ``eval
    -dataset voc2012`` on its checkpoint: the eval's mIoU is the loop's;
    the 64->21 head runs K1 once a step on each of its paths (bf16: fwd on
    wgmma, dx and dW on packed; float32, phase 14: fwd on "f32", dx and dW
    on "f32_packed") and K4 once an eval batch, held against plain on the
    step's data (``shadowed_kernels``; ``SHADOW_TOL``, at float32
    ``F32_SHADOW_TOL``); each step's loss is F.cross_entropy's over the
    non-255 pixels."""
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = F32_SHADOW_TOL if tdtype == torch.float32 else SHADOW_TOL
    data = write_voc_data(os.path.join(tmp, "voc"))
    workdir = os.path.join(tmp, "voc_run")
    os.makedirs(workdir)
    argv = ["-dataset", "voc2012", "-net", "unet", "-b", str(RUN_BATCH),
            "-e", "1", "-dtype", dtype, "-quiet", "-data", data,
            "-image_size", str(HW[1]), str(HW[0]), "-dp", "1"]
    shadow, by_shape, losses = {}, {}, []
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.chdir(workdir), shadowed_kernels(shadow, by_shape), \
            recomputed_losses(losses):
        history = train_cli.main(argv)
    torch.cuda.synchronize()
    counts, paths = conv_train.launches(), conv_train.path_launches()
    k4_paths = {p: fused_conv.conv3x3_bn_relu.path_launches[p]
                - paths["fwd"][p] - paths["dgrad"][p]
                for p in fused_conv.ROUTES}
    steps = RUN_SPLITS["train"][0] // RUN_BATCH
    evals = -(-RUN_SPLITS["val"][0] // RUN_BATCH)
    head = {piece: by_shape.get((piece, 64, VOC_CLASSES))
            for piece in ("K1 fwd", "K1 dx", "K1 dW")}
    loss_errs = [abs(a.item() - b.item()) / abs(b.item()) for a, b in losses]
    print(f"VOC train CLI (UNet b{RUN_BATCH}, 1 epoch, {VOC_CLASSES} "
          f"classes, {HW[0]}x{HW[1]}, {dtype}): mIoU "
          f"{history[0]['miou']:.4f}; "
          f"K1 launches {counts} on each path {paths}; K4 in the eval pass "
          f"on each path {k4_paths}; the 64->{VOC_CLASSES} head against "
          f"plain on the steps' data: " + ", ".join(
              f"{p} {e:.3g}" for p, e in head.items() if e is not None)
          + f" (tol {tol}); every conv: {shadow}; each step's loss vs "
          f"F.cross_entropy over the non-255 pixels "
          f"{[f'{e:.3g}' for e in loss_errs]} (tol {LOSS_RECOMPUTE_TOL})",
          flush=True)
    check(counts == {k: v * steps for k, v in UNET_STEP.items()},
          "VOC training's K1 launches")
    check(paths == path_counts("unet", steps, VOC_CLASSES, tdtype),
          f"VOC {dtype} training's K1 paths (the head on wgmma, packed, "
          f"packed; at float32 f32, f32_packed, f32_packed)")
    check(k4_paths == path_counts("unet", evals, VOC_CLASSES, tdtype)["fwd"],
          f"VOC {dtype} eval pass's K4 paths")
    check(all(e is not None for e in head.values()), "VOC head's pieces")
    for piece, e in shadow.items():
        check(e <= tol[piece], f"VOC {dtype} {piece} on the step's data")
    check(len(losses) == steps and max(loss_errs) <= LOSS_RECOMPUTE_TOL,
          "VOC loss over the non-255 pixels")
    ckpts = sorted(os.listdir(run_dir(workdir)))
    check(len(ckpts) == 1, f"VOC run's checkpoint ({ckpts})")
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = eval_cli.main(["-weight", os.path.join(run_dir(workdir),
                                                     ckpts[0]),
                             "-dataset", "voc2012", "-net", "unet", "-b",
                             str(RUN_BATCH), "-dtype", dtype, "-data",
                             data, "-image_size", str(HW[1]), str(HW[0])])
    torch.cuda.synchronize()
    k4 = dict(fused_conv.conv3x3_bn_relu.path_launches)
    print(f"VOC eval CLI on {ckpts[0]}: mIoU {got['miou']:.6f} (the loop's "
          f"{history[0]['miou']:.6f}), loss {got['loss']:.4f}; K4 on each "
          f"path {k4}", flush=True)
    check(abs(got["miou"] - history[0]["miou"]) <= 1e-9,
          "VOC eval CLI's mIoU is the loop's")
    check(k4 == path_counts("unet", evals, VOC_CLASSES, tdtype)["fwd"],
          f"VOC {dtype} eval CLI's K4 paths")


@contextlib.contextmanager
def recorded_host_loaders(made: list):
    """Inside the block the loop's HostLoaders are kept in ``made``."""
    cls = loop.HostLoader

    def make(*args, **kw):
        made.append(cls(*args, **kw))
        return made[-1]

    loop.HostLoader = make
    try:
        yield made
    finally:
        loop.HostLoader = cls


def host_loader_checks(tmp: str, data: str, a: dict, c: dict = None
                       ) -> None:
    """Part 4: phase 12's run A again with ``-loader host``: every leaf of
    its final checkpoint bit-equal to run A's, through the native gather.
    Given run C (``c``), also run C's configuration with the host loader
    through ``loop.run_training``: bit-equal too, and its epochs' img/s
    beside run C's (the loop alone, without the CLI's logger)."""
    n = RUN_SPLITS["train"][0]

    def img_s(history):
        return ", ".join(f"{n / h['train_s']:.2f}" for h in history)

    workdir = os.path.join(tmp, "host")
    os.makedirs(workdir)
    made = []
    with contextlib.chdir(workdir), recorded_host_loaders(made):
        history = train_cli.main(run_argv(data) + ["-loader", "host"])
    (name,) = cadence(history, RUN_EPOCHS, settings.SAVE_EPOCH)
    want = leaves(a["ckpt"])
    runs = {"train CLI": (os.path.join(run_dir(workdir), name), history,
                          a["history"], "run A's")}
    if c is not None:
        ckpt_dir = os.path.join(workdir, "loop")
        with recorded_host_loaders(made):
            _, loop_history = loop.run_training(
                loop_config(ckpt_dir, loader="host"), *splits(data))
        runs["loop.run_training"] = (os.path.join(ckpt_dir, name),
                                     loop_history, c["history"], "run C's")
    gathers = sum(ld.gathers for ld in made)
    native_gathers = sum(ld.native_gathers for ld in made)
    gather_ms = sum(ld.gather_s for ld in made) / max(gathers, 1) * 1e3
    for what, (path, got_history, ref_history, ref) in runs.items():
        got = leaves(path)
        unequal = [k for k in want if not np.array_equal(got[k], want[k])]
        print(f"-loader host ({what}, run A's configuration): leaves "
              f"unequal to run A's: {len(unequal)} of {len(want)}; epoch "
              f"img/s {img_s(got_history)} against the device loader's "
              f"{img_s(ref_history)} ({ref}) on {bench.card()}", flush=True)
        check(not unequal, f"-loader host ({what}) bit-equal to run A")
    print(f"-loader host: {native_gathers} of {gathers} gathers native "
          f"({native.build_error() or 'built'}), {gather_ms:.3f} ms a batch "
          f"on the host (images and labels, b{RUN_BATCH})", flush=True)
    check(len(made) == 2 * len(runs) and gathers > 0
          and native_gathers == gathers,
          "-loader host took the native gather")


def head_timings() -> dict:
    """Part 5: the 64->21 head's K1 fwd, dx and dW at b10 and b24,
    360x480, against their plain versions (F.conv2d, conv2d_input, the f32
    wgrad), cuDNN's bf16 calls (F.conv2d; convolution_backward with the
    real input; the bf16 wgrad) and their bounds, beside the narrow paths'
    times before (``HEAD_NARROW_MS``). Returns {piece: {batch: {ms,
    plain_ms, library_ms, bound_ms, bound_by, max_abs_err, path}}}."""
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    h, w = HW
    out = {"fwd": {}, "dx": {}, "wgrad": {}}
    for n in HEAD_BATCHES:
        x, wt = conv_inputs(gen, n, h, w, 64, VOC_CLASSES)
        g = torch.randn(n, h, w, VOC_CLASSES, generator=gen,
                        device=DEVICE).to(torch.bfloat16)
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        wc = wt.permute(3, 2, 0, 1)
        pieces = {
            "fwd": (lambda: conv_train.conv3x3_fwd(x, wt),
                    lambda: conv_train.conv3x3_train_plain(x, wt),
                    lambda: F.conv2d(xc, wc, padding=1)),
            "dx": (lambda: conv_train.conv3x3_dgrad(g, wt),
                   lambda: conv_train.conv3x3_dgrad_plain(g, wt),
                   lambda: conv_train.conv3x3_dgrad_library(g, wt, x)),
            "wgrad": (lambda: conv_train.conv3x3_wgrad(x, g),
                      lambda: conv_train.conv3x3_wgrad_plain(x, g),
                      lambda: torch.nn.grad.conv2d_weight(
                          xc, (VOC_CLASSES, 64, 3, 3), gc, padding=1))}
        line = [f"head 64->{VOC_CLASSES} b{n} {h}x{w}:"]
        for piece, (kern, plain, lib) in pieces.items():
            path = (conv_train.wgrad_path(64, VOC_CLASSES) if piece ==
                    "wgrad" else fused_conv.conv_path(
                        *((VOC_CLASSES, 64) if piece == "dx"
                          else (64, VOC_CLASSES))))
            err, scale = _rel_err(kern(), plain())
            check(err <= K1_TOL[piece] * scale,
                  f"head {piece} b{n} vs plain")
            ms, lib_ms = cuda_ms(kern, iters=10), cuda_ms(lib, iters=10)
            plain_ms = cuda_ms(plain, iters=10)
            bound, by = conv_bound(n, h, w, 64, VOC_CLASSES, piece)
            out[piece][n] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "bound_ms": bound,
                             "bound_by": by, "max_abs_err": err,
                             "path": path}
            line.append(f"{piece} ({path}) {ms:.4f} ms, plain "
                        f"{plain_ms:.4f} ms, cuDNN bf16 {lib_ms:.4f} ms "
                        f"({ms / lib_ms:.2f}x), bound {bound:.4f} by {by} "
                        f"({bound / ms:.2f} of it), narrow path before "
                        f"{HEAD_NARROW_MS[piece][n]} ms, err "
                        f"{err / scale:.3g};")
        print(" ".join(line) + f" on {bench.card()}", flush=True)
        del x, wt, g, xc, gc, wc
        torch.cuda.empty_cache()
    return out


def phase_data_side(tmp: str, run: dict) -> dict:
    """Phase 13 (module docstring); returns the head's timings."""
    t0 = time.perf_counter()
    augment_checks()
    lr_finder_checks(run["data"])
    voc_checks(tmp)
    host_loader_checks(tmp, run["data"], run["a"], run["c"])
    head = head_timings()
    print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)
    return head


# ---------------------------------------------------- f32 on the card (14)

# the error rule of the f32 kernels at every shape: with err(t) = max|t -
# f64|, where f64 is the same function in float64 on the card, err(kernel)
# <= max(4 err(plain f32, TF32 off), 2e-6 max|f64|)
# (``f32_variants.error_rule``)
F32_CHECK_BATCH, F32_TIME_BATCH, F32_TIME_ITERS = 2, 10, 5
# the split product's rate: three TF32 products a term
F32_SPLIT_RATE = bench.H100_TF32_PEAK / 3
# edge shapes (N, H, W, Cin, Cout) beside the models' blocks: VOC's 64->21
# head (its forward on the wgmma route's N tile 24; its dx, Cin 21, and
# dW, Cout 21, on the packed route: raw chunks of 84-byte pixel rows),
# ragged 45x61 tiles at 64->64, the stem (packed) and the head; 23->64
# (9 x 23 > 192: forward and dW on "f32_narrow") and 3->21 (both sides
# narrow: dW on "f32_narrow"; its forward and dx on the packed route at
# Cout 21 and 3, with direct stores); a batch view x[1:] of the stem
# whose data starts off a 16-byte boundary; a forward input past 2**31
# elements, checked on its last image
F32_EDGE = ((2, 360, 480, 64, 21), (2, 45, 61, 64, 64), (2, 45, 61, 3, 64),
            (2, 45, 61, 64, 12), (2, 45, 61, 23, 64), (2, 45, 61, 3, 21))
F32_VIEW = (3, 45, 61, 3, 64)
# timed beside the blocks, in no model sum: VOC's 64->21 head at 360x480
# (its forward on the wgmma route with N tile 24, its dx and dW on the
# packed one)
F32_EXTRA_TIMED = ((360, 480, 64, 21),)
F32_BIG = (100, 360, 480, 128, 64)
# the f32 training CLI runs against the plain f32 path (TF32 off): each
# kernel call on the step's data (max|kernel - plain| / max|plain|; the
# plain f32 dW, cuDNN's, carries ~1e-4 of rounding over a b10 step's
# pixels), and the first step from the same state and draws (each 10x
# tighter than its bf16 counterpart above)
F32_SHADOW_TOL = {"K1 fwd": 1e-5, "K1 dx": 1e-5, "K1 dW": 2e-3,
                  "K2 pool": 0.0, "K2 pool backward": 0.0,
                  "K2 unpool": 0.0, "K2 unpool backward": 0.0}
F32_TRAIN_LOSS_TOL = 1e-5
F32_TRAIN_GRAD_TOL = 5e-3
F32_TRAIN_GRAD_DIFF_TOL = 5e-2
F32_TRAIN_STAT_TOL = 1e-4
F32_RUN_STOP = 2   # run B's preemption point in the 4-step epoch
F32_LR_ITERS = 4
F32_TIME_STEPS = 10
F32_PIECES = ("k4", "fwd", "dx", "wgrad")


def conv64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv3x3 pad 1 of NHWC x and HWIO w in float64 on the card."""
    return F.conv2d(x.double().permute(0, 3, 1, 2),
                    w.double().permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def wgrad64(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW (3,3,Cin,Cout) of conv3x3 pad 1 in float64 on the card."""
    dw = torch.nn.grad.conv2d_weight(
        x.double().permute(0, 3, 1, 2), (g.shape[3], x.shape[3], 3, 3),
        g.double().permute(0, 3, 1, 2), padding=1)
    return dw.permute(2, 3, 1, 0)


@contextlib.contextmanager
def tf32_convs():
    """cuDNN's f32 convolutions in TF32 inside the block (PyTorch's
    default; ``start`` turns it off for the plain versions)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def f32_inputs(gen: torch.Generator, n, h, w, cin, cout) -> tuple:
    """f32 x (n,h,w,cin), He-scaled HWIO weights, a cotangent g
    (n,h,w,cout) and a BN fold (a, b), on the card."""
    dev = torch.device("cuda")
    x = torch.randn(n, h, w, cin, generator=gen, device=dev)
    wt = (torch.randn(3, 3, cin, cout, generator=gen, device=dev)
          * (2.0 / (9 * cin)) ** 0.5)
    g = torch.randn(n, h, w, cout, generator=gen, device=dev)
    a = torch.rand(cout, generator=gen, device=dev) + 0.5
    b = torch.randn(cout, generator=gen, device=dev) * 0.1
    return x, wt, g, a, b


def f32_pieces(x, wt, g, a, b) -> dict:
    """{piece: (kernel, plain f32, float64)} calls at one shape: K4 (BN
    fold and ReLU), K1's forward, dx and dW."""
    return {
        "k4": (lambda: fused_conv.conv3x3_bn_relu(x, wt, a, b),
               lambda: fused_conv.conv3x3_bn_relu_plain(x, wt, a, b),
               lambda: torch.relu(conv64(x, wt) * a.double() + b.double())),
        "fwd": (lambda: conv_train.conv3x3_fwd(x, wt),
                lambda: conv_train.conv3x3_train_plain(x, wt),
                lambda: conv64(x, wt)),
        "dx": (lambda: conv_train.conv3x3_dgrad(g, wt),
               lambda: conv_train.conv3x3_dgrad_plain(g, wt),
               lambda: conv64(g, fused_conv.flipped(wt))),
        "wgrad": (lambda: conv_train.conv3x3_wgrad(x, g),
                  lambda: conv_train.conv3x3_wgrad_plain(x, g),
                  lambda: wgrad64(x, g))}


def f32_shape_checks(label: str, x, wt, g, a, b) -> dict:
    """The error rule for each piece at one shape, and the f32 dW launched
    twice on the same inputs: equal bits. Prints one line (also when a
    check fails: the readings under a planted fault), then fails at the
    first check missed; returns {piece: err(kernel)}."""
    line, errs, missed = [f"f32 {label}:"], {}, []
    for piece, (kern, plain, ref) in f32_pieces(x, wt, g, a, b).items():
        got = kern()
        ek, ep, scale, limit = f32_variants.error_rule(got, plain(), ref())
        line.append(f"{piece} {ek:.3g} (plain {ep:.3g}, max|f64| "
                    f"{scale:.4g}, limit {limit:.3g});")
        if not ek <= limit:
            missed.append(f"f32 {piece} error rule at {label}")
        errs[piece] = ek
        if piece == "wgrad":
            same = torch.equal(got, kern())
            line.append(f"dW twice bit-equal {same}")
            if not same:
                missed.append(f"f32 dW bit-equal on two launches at {label}")
        del got
    print(" ".join(line), flush=True)
    for what in missed:
        check(False, what)
    return errs


def f32_kernel_checks(gen: torch.Generator) -> dict:
    """Phase 14 (1), the checks: the error rule and the dW's determinism
    at every distinct block shape of both models at F32_CHECK_BATCH, at
    ``F32_EDGE``, on the misaligned view ``F32_VIEW`` and (K4) past 2**31
    input elements. Returns {(h, w, cin, cout): {piece: err}} of the
    blocks."""
    out = {}
    for h, w, cin, cout in all_block_shapes():
        shape = (F32_CHECK_BATCH, h, w, cin, cout)
        out[(h, w, cin, cout)] = f32_shape_checks(
            f"{F32_CHECK_BATCH}x{h}x{w} {cin}->{cout}", *f32_inputs(gen,
                                                                    *shape))
    for n, h, w, cin, cout in F32_EDGE:
        f32_shape_checks(f"{n}x{h}x{w} {cin}->{cout} (edge)",
                         *f32_inputs(gen, n, h, w, cin, cout))
    n, h, w, cin, cout = F32_VIEW
    x, wt, g, a, b = f32_inputs(gen, n, h, w, cin, cout)
    check(x[1:].data_ptr() % 16 != 0, "the f32 view x[1:] is misaligned")
    f32_shape_checks(f"x[1:] {n - 1}x{h}x{w} {cin}->{cout}", x[1:], wt,
                     g[1:], a, b)
    del x, g
    torch.cuda.empty_cache()
    n, h, w, cin, cout = F32_BIG
    x, wt, _, a, b = f32_inputs(gen, 1, h, w, cin, cout)
    x = torch.randn(n, h, w, cin, generator=gen, device="cuda")
    check(x[-1:].storage_offset() >= 2 ** 31,
          "the big input's last image lies past 2**31 elements")
    got = fused_conv.conv3x3_bn_relu(x, wt, a, b)[-1:].clone()
    tail = x[-1:].clone()
    del x
    torch.cuda.empty_cache()
    ek, ep, scale, limit = f32_variants.error_rule(
        got, fused_conv.conv3x3_bn_relu_plain(tail, wt, a, b),
        torch.relu(conv64(tail, wt) * a.double() + b.double()))
    print(f"f32 K4 {n}x{h}x{w} {cin}->{cout} (input past 2**31 elements), "
          f"its last image: {ek:.3g} (plain {ep:.3g}, max|f64| "
          f"{scale:.4g}, limit {limit:.3g})", flush=True)
    check(ek <= limit, "f32 K4 error rule past 2**31 input elements")
    del got, tail
    torch.cuda.empty_cache()
    return out


def f32_bound(n, h, w, cin, cout) -> tuple:
    """Bound of one f32 conv3x3 pass (fwd, dx and dW alike): the FLOPs at
    the split product's rate or each f32 tensor moved once at the memory
    rate, whichever is larger."""
    flops = 2.0 * 9 * n * h * w * cin * cout
    nbytes = 4 * (n * h * w * (cin + cout) + 9 * cin * cout)
    return bound_ms(flops, nbytes, F32_SPLIT_RATE)


def f32_narrow_call(piece: str, x, wt, g, a, b):
    """``piece`` (f32_pieces' keys) on the narrow route's kernels (the
    first mma.sync design; the library's ``*_narrow`` entries) on the
    same inputs, whatever route the shape takes: timed beside the packed
    route's kernels."""
    lib = fused_conv.f32_library()
    stream = torch.cuda.current_stream().cuda_stream
    n, h, w, cin = x.shape
    cout = g.shape[3]
    if piece == "wgrad":
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = conv_train.wgrad_f32_splits(n, h, w, cin, cout, sms,
                                             "f32_narrow")
        ws = torch.empty(splits, 3, 3, cin, cout, device="cuda")

        def dw():
            out = torch.empty(3, 3, cin, cout, device="cuda")
            err = lib.conv3x3_wgrad_f32_narrow(
                x.data_ptr(), g.data_ptr(), out.data_ptr(), ws.data_ptr(),
                n, h, w, cin, cout, splits, stream)
            check(err == 0, f"the narrow f32 dW launch: CUDA error {err}")
            return out
        return dw
    src, cin_, cout_, flip = ((g, cout, cin, 1) if piece == "dx"
                              else (x, cin, cout, 0))
    scale, shift = (a, b) if piece == "k4" else conv_train._unit_affine(
        cout_, x.device)

    def fwd():
        out = torch.empty(n, h, w, cout_, device="cuda")
        err = lib.conv3x3_bn_relu_f32_narrow(
            src.data_ptr(), wt.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), out.data_ptr(), n, h, w, cin_, cout_,
            int(piece == "k4"), flip, stream)
        check(err == 0, f"the narrow f32 forward launch: CUDA error {err}")
        return out
    return fwd


def f32_timings(gen: torch.Generator) -> dict:
    """Phase 14 (1), the times at F32_TIME_BATCH, per distinct block shape
    and piece (CUDA events): the kernel, the plain f32 version (TF32 off),
    the library call with TF32 off (``F.conv2d`` for K4, whose plain
    version adds the fold; ``convolution_backward`` with the real input for
    dx; the plain version itself for K1's forward and dW) and with TF32
    on; a piece on "f32_packed" also on the narrow route's kernel
    (``f32_narrow_call``). The stem has no dx on the path. Also at
    ``F32_EXTRA_TIMED``. Returns {(h, w, cin, cout): {piece: {ms,
    plain_ms, library_ms, library_tf32_ms, route[, narrow_ms]}}}."""
    res, n = {}, F32_TIME_BATCH
    for shape in list(all_block_shapes()) + list(F32_EXTRA_TIMED):
        h, w, cin, cout = shape
        x, wt, g, a, b = f32_inputs(gen, n, h, w, cin, cout)
        xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
        pieces = f32_pieces(x, wt, g, a, b)
        library = {
            "k4": lambda: F.conv2d(xc, wc, padding=1),
            "fwd": pieces["fwd"][1],
            "dx": lambda: conv_train.conv3x3_dgrad_library(g, wt, x),
            "wgrad": pieces["wgrad"][1]}
        res[shape] = got = {}
        line = [f"f32 b{n} {h}x{w} {cin}->{cout}:"]
        for piece, (kern, plain, _) in pieces.items():
            if piece == "dx" and cin == 3:
                continue
            t = {"ms": cuda_ms(kern, F32_TIME_ITERS, 2),
                 "plain_ms": cuda_ms(plain, F32_TIME_ITERS, 2)}
            t["library_ms"] = (t["plain_ms"] if library[piece] is plain
                               else cuda_ms(library[piece], F32_TIME_ITERS, 2))
            with tf32_convs():
                t["library_tf32_ms"] = cuda_ms(library[piece],
                                               F32_TIME_ITERS, 2)
            t["route"] = (conv_train.wgrad_f32_route(cin, cout)
                          if piece == "wgrad" else
                          fused_conv.f32_route(cout, cin) if piece == "dx"
                          else fused_conv.f32_route(cin, cout))
            narrow = ""
            if t["route"] == "f32_packed":
                t["narrow_ms"] = cuda_ms(
                    f32_narrow_call(piece, x, wt, g, a, b), F32_TIME_ITERS,
                    2)
                narrow = f", narrow route {t['narrow_ms']:.4f}"
            got[piece] = t
            line.append(f"{piece} {t['ms']:.4f} ms on {t['route']} (plain "
                        f"{t['plain_ms']:.3f}, library "
                        f"{t['library_ms']:.4f}, TF32 "
                        f"{t['library_tf32_ms']:.4f}{narrow});")
        bound, by = f32_bound(n, h, w, cin, cout)
        print(" ".join(line) + f" bound {bound:.4f} ms by {by} on "
              f"{bench.card()}", flush=True)
        del x, wt, g, xc, wc, pieces, library
        torch.cuda.empty_cache()
    return res


def f32_sums(times: dict, errs: dict) -> dict:
    """Per model and piece, the f32 times summed over the model's blocks
    at F32_TIME_BATCH (K4 one forward, K1 one step: no dx at the stem),
    beside the summed bound (the FFMA peak's time too) and the worst
    error at F32_CHECK_BATCH: {net: {piece: {max_abs_err, ms, plain_ms,
    library_ms, library_tf32_ms, bound_ms, bound_by}}}, printed."""
    sums, n = {}, F32_TIME_BATCH
    for net in TRAIN_BATCH:
        shapes = bench.block_shapes(net, HW)
        sums[net] = {}
        for piece in F32_PIECES:
            on = shapes[1:] if piece == "dx" else shapes
            by = {}
            for s in on:
                t, kind = f32_bound(n, *s)
                by[kind] = by.get(kind, 0.0) + t
            row = {"max_abs_err": max(errs[s][piece] for s in on)}
            for key in ("ms", "plain_ms", "library_ms", "library_tf32_ms"):
                row[key] = sum(times[s][piece][key] for s in on)
            row.update(bound_ms=sum(by.values()), bound_by=max(by, key=by.get))
            sums[net][piece] = row
        ffma = {piece: sum(2.0 * 9 * n * s[0] * s[1] * s[2] * s[3]
                           for s in (shapes[1:] if piece == "dx" else shapes))
                / bench.H100_F32_PEAK * 1e3 for piece in F32_PIECES}
        print(f"{net} f32 sums over its {len(shapes)} blocks at b{n}: "
              + "; ".join(
                  f"{p} {t['ms']:.3f} ms (plain {t['plain_ms']:.3f}, "
                  f"library {t['library_ms']:.3f}, TF32 "
                  f"{t['library_tf32_ms']:.3f}; bound {t['bound_ms']:.3f} "
                  f"by {t['bound_by']}: {t['bound_ms'] / t['ms']:.2f} of "
                  f"it; the FFMA peak's time {ffma[p]:.3f}; max err "
                  f"{t['max_abs_err']:.3g})" for p, t in sums[net].items())
              + f" on {bench.card()}", flush=True)
    return sums


def f32_argv(net: str, data: str) -> list:
    """The train CLI at JAX's defaults (no -dtype: float32), one epoch, one
    process."""
    return ["-net", net, "-b", str(RUN_BATCH), "-e", "1", "-quiet", "-data",
            data, "-image_size", str(HW[1]), str(HW[0]), "-dp", "1"]


def f32_first_step(net: str, c: dict) -> None:
    """The first step of the f32 CLI run against the plain f32 path from
    the same state and draws (``checked_sweep``): loss, per-leaf gradients
    (norm and difference) and BN running stats within the F32_TRAIN_*
    limits."""
    k, p = c["first"]["kernel"], c["first"]["plain"]
    loss_err = abs(c["raw"][0] - c["plain"][0]) / abs(c["plain"][0])
    norm_errs, diff_errs = grad_errors(c["model"], k["grads"], p["grads"])
    stat_errs = {n: ((k["stats"][n] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30)).item()
                 for n, v in p["stats"].items()}
    worst_n, worst_d, worst_s = (_worst(e) for e in
                                 (norm_errs, diff_errs, stat_errs))
    print(f"{net} f32 first step, kernel vs plain f32 path (TF32 off) from "
          f"the same state and draws at {c['choices']} pool choices: loss "
          f"{c['raw'][0]:.6f} vs {c['plain'][0]:.6f}, rel {loss_err:.3g} "
          f"(tol {F32_TRAIN_LOSS_TOL}); per leaf, grad norm rel max "
          f"{worst_n[1]:.3g} at {worst_n[0]}, median {worst_n[2]:.3g} (tol "
          f"{F32_TRAIN_GRAD_TOL}); |grad diff| rel max {worst_d[1]:.3g} at "
          f"{worst_d[0]}, median {worst_d[2]:.3g} (tol "
          f"{F32_TRAIN_GRAD_DIFF_TOL}); BN stats rel max {worst_s[1]:.3g} "
          f"at {worst_s[0]} (tol {F32_TRAIN_STAT_TOL})", flush=True)
    check(c["plain_launches"] == 0, f"{net} f32: the plain step launched")
    check(np.isfinite(c["raw"][0]) and loss_err <= F32_TRAIN_LOSS_TOL,
          f"{net} f32 first step's loss vs plain")
    check(worst_n[1] <= F32_TRAIN_GRAD_TOL, f"{net} f32 grad norms vs plain")
    check(worst_d[1] <= F32_TRAIN_GRAD_DIFF_TOL, f"{net} f32 grads vs plain")
    check(worst_s[1] <= F32_TRAIN_STAT_TOL, f"{net} f32 BN stats vs plain")


def f32_training_run(tmp: str, data: str, net: str) -> dict:
    """Phase 14 (2) and (3) for ``net``: the train CLI at its defaults
    (f32) for one epoch of 4 steps on phase 12's caches, every K1 and K2
    call held against plain and the first step against the plain path;
    launches per step on the f32 kernels; run B stopped after
    F32_RUN_STOP batches and resumed through the CLI, bit-equal to A; the
    eval CLI at its default on A's checkpoint: the loop's mIoU, K4 (and
    K3) at f32. Returns A's history, checkpoint and launches."""
    workdir = os.path.join(tmp, f"f32_{net}")
    os.makedirs(workdir)
    c = {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(workdir), checked_sweep(c, loop, 1):
        history = train_cli.main(f32_argv(net, data))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, paths = train_counts(), conv_train.path_launches()
    steps = RUN_SPLITS["train"][0] // RUN_BATCH
    evals = -(-RUN_SPLITS["val"][0] // RUN_BATCH)
    k4_paths = {p: fused_conv.conv3x3_bn_relu.path_launches[p]
                - paths["fwd"][p] - paths["dgrad"][p]
                for p in fused_conv.ROUTES}
    want = expected_train_counts(net, steps)
    for key in ("maxpool2x2.pool_flat", "maxpool2x2.unpool_flat"):
        want[key] = POOLS[net] * evals   # K3 in the eval pass
    files = sorted(os.listdir(run_dir(workdir)))
    names = cadence(history, 1, settings.SAVE_EPOCH)
    print(f"{net} f32 train CLI (no -dtype; b{RUN_BATCH}, 1 epoch, "
          f"{HW[0]}x{HW[1]}): mIoU {history[-1]['miou']:.4f}, checkpoints "
          f"{files}; launches {counts}, K1 on each path {paths}; K4 in the "
          f"eval pass on each path {k4_paths}; every kernel call against "
          f"its plain version on the same inputs, worst per piece over "
          f"{len(c['raw'])} steps: " + "; ".join(
              f"{piece} {e:.3g} (tol {F32_SHADOW_TOL[piece]})"
              for piece, e in c["shadow"].items())
          + f"; {wall:.2f} s in all on {bench.card()}", flush=True)
    check([h["epoch"] for h in history] == [1], f"{net} f32 run's epoch")
    check(bool(names) and files == sorted(names), f"{net} f32 checkpoints")
    final = os.path.join(run_dir(workdir), names[-1])
    check(int(leaves(final)["step"]) == steps, f"{net} f32 run's steps")
    check(counts == want, f"{net} f32 launches")
    check(paths == path_counts(net, steps, dtype=torch.float32),
          f"{net} f32 K1 launches per path")
    check(k4_paths == path_counts(net, evals, dtype=torch.float32)["fwd"],
          f"{net} f32 eval pass's K4 launches")
    pieces = [p for p in F32_SHADOW_TOL if POOLS[net] or p.startswith("K1")]
    check(len(c["raw"]) == steps and sorted(c["shadow"]) == sorted(pieces),
          f"{net} f32 kernel pieces seen")
    for piece, e in c["shadow"].items():
        check(e <= F32_SHADOW_TOL[piece], f"{net} f32 {piece} vs plain")
    f32_first_step(net, c)
    raw = c["raw"]
    del c
    torch.cuda.empty_cache()

    # run B: stopped after F32_RUN_STOP batches, resumed by the CLI
    work_b = os.path.join(tmp, f"f32_{net}_b")
    preempted = os.path.join(work_b, "checkpoints", "preempted")
    state, _ = loop.run_training(
        loop_config(preempted, net=net, epochs=1, compute_dtype="float32",
                    stop_after_batches=F32_RUN_STOP), *splits(data))
    check(state.step == F32_RUN_STOP
          and sorted(os.listdir(preempted)) == ["0-preempt.ckpt.npz"],
          f"{net} f32 run B's preemption checkpoint")
    del state
    with contextlib.chdir(work_b):
        resumed = train_cli.main(f32_argv(net, data) + ["-resume"])
    (name,) = cadence(resumed, 1, settings.SAVE_EPOCH)
    got = leaves(os.path.join(work_b, "checkpoints", settings.TIME_NOW,
                              name))
    ref = leaves(final)
    unequal = sorted(k for k in ref if not np.array_equal(got[k], ref[k]))
    print(f"{net} f32 run B resumed (train CLI -resume after "
          f"{F32_RUN_STOP} batches): step {int(got['step'])}; leaves "
          f"unequal to run A's: {len(unequal)} of {len(ref)} "
          f"{unequal[:6]}", flush=True)
    check(int(got["step"]) == steps and not unequal,
          f"{net} f32 preemption + resume bit-equal to run A")

    # the eval CLI at its default dtype on A's checkpoint
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        ev = eval_cli.main(["-weight", final, "-net", net, "-b",
                            str(RUN_BATCH), "-data", data, "-image_size",
                            str(HW[1]), str(HW[0])])
    torch.cuda.synchronize()
    k4 = dict(fused_conv.conv3x3_bn_relu.path_launches)
    k3 = {k: v for k, v in fused_pool.launches().items() if v}
    want_k3 = ({"maxpool2x2.pool_flat": POOLS[net] * evals,
                "maxpool2x2.unpool_flat": POOLS[net] * evals}
               if POOLS[net] else {})
    line = f"miou: {history[-1]['miou']:.4f}"
    print(f"{net} f32 eval CLI (no -dtype) on {os.path.basename(final)}: "
          f"mIoU {ev['miou']:.6f} (the loop's {history[-1]['miou']:.6f}); "
          f"K4 on each path {k4}; K3 {k3}", flush=True)
    check(line in out.getvalue().splitlines()
          and abs(ev["miou"] - history[-1]["miou"]) <= 1e-9,
          f"{net} f32 eval CLI's mIoU is the loop's")
    check(k4 == path_counts(net, evals, dtype=torch.float32)["fwd"],
          f"{net} f32 eval CLI's K4 launches")
    check(k3 == want_k3, f"{net} f32 eval CLI's K3 launches")
    return {"history": history, "ckpt": final, "counts": counts,
            "paths": paths, "k4": sum(k4.values()), "k4_paths": k4,
            "raw": raw}


class Cv2Stand:
    """The cv2 calls of ``predict.main``, for a host without cv2 (the
    card's): ``imread`` reads a .npy, ``resize`` takes only sizes the
    image already has (the image is written at the working size, so both
    of predict's resizes are the identity), ``imwrite`` keeps the
    arrays."""
    INTER_NEAREST = 0

    def __init__(self):
        self.written = {}

    @staticmethod
    def imread(path):
        return np.load(path)

    @staticmethod
    def resize(img, size, interpolation=None):
        check(tuple(img.shape[1::-1]) == tuple(size),
              f"predict resized {img.shape} to {size}")
        return img

    def imwrite(self, name, img):
        self.written[name] = img
        return True


def f32_predict_checks(tmp: str, data: str, weight: str) -> None:
    """Phase 14 (4): ``predict.main`` at its default (f32 on the card) on
    a val image with UNet's f32 checkpoint: 23 K4 launches on the f32
    kernel, and its map agrees with the plain f32 path's on PREDICT_AGREE
    of the pixels."""
    val = camvid.CamVid(data, image_set="val", image_size=HW[::-1])
    path = os.path.join(tmp, "predict_src.npy")
    np.save(path, val.images[0])
    stand = Cv2Stand()
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = stand
    reset_counts()
    try:
        with contextlib.chdir(tmp), contextlib.redirect_stdout(io.StringIO()):
            got = predict_cli.main(["-img", path, "-weight", weight])
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved
    torch.cuda.synchronize()
    k4 = dict(fused_conv.conv3x3_bn_relu.path_launches)
    sd = ckpt.load_weights(weight, "unet")
    model = get_model("unet", spec=spec_from_state_dict("unet", sd))
    model.load_state_dict(sd)
    model = model.cuda().eval()
    with torch.inference_mode():
        x = torch.from_numpy(val.images[:1]).cuda()
        want = model(to_tensor_normalize(x, settings.MEAN, settings.STD,
                                         torch.float32), plain=True)
    want = want.argmax(-1)[0].to(torch.uint8).cpu().numpy()
    agree = float((got == want).mean())
    print(f"predict CLI (no -dtype: f32) on a val image with UNet's f32 "
          f"checkpoint: agrees with the plain f32 path on {agree:.6f} of the "
          f"pixels (limit {PREDICT_AGREE}); K4 on each path {k4}; wrote "
          f"{sorted(stand.written)}", flush=True)
    check(got.shape == HW and agree >= PREDICT_AGREE,
          "f32 predict vs the plain f32 path")
    check(k4 == path_counts("unet", 1, dtype=torch.float32)["fwd"],
          "f32 predict's K4 launches")


def f32_lr_finder_checks(data: str) -> None:
    """Phase 14 (5): the LR finder at its default dtype (f32), UNet,
    F32_LR_ITERS iterations at b10: finite losses, K1's launches on the
    f32 kernels."""
    args = lr_finder.parser().parse_args(
        ["-net", "unet", "-b", str(RUN_BATCH), "-num_it", str(F32_LR_ITERS),
         "-data", data, "-image_size", str(HW[1]), str(HW[0])])
    torch.cuda.synchronize()
    reset_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        losses, lrs = lr_finder.sweep(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, paths = train_counts(), conv_train.path_launches()
    diverged = "diverged" in log.getvalue()
    steps = len(lrs) + diverged
    print(f"lr_finder -net unet -b {RUN_BATCH} -num_it {F32_LR_ITERS} "
          f"(-dtype {args.dtype}): losses "
          f"{[round(float(v), 4) for v in losses]}; launches {counts}, K1 "
          f"on each path {paths}; {wall / max(steps, 1):.3f} s/iteration on "
          f"{bench.card()}", flush=True)
    check(args.dtype == "float32", "the LR finder's default dtype")
    check(bool(np.isfinite(losses).all())
          and (len(lrs) == F32_LR_ITERS
               or (diverged and len(lrs) < F32_LR_ITERS)),
          "f32 lr_finder's losses and end")
    check(counts == expected_train_counts("unet", steps)
          and paths == path_counts("unet", steps, dtype=torch.float32),
          "f32 lr_finder's launches")


def f32_step_timing() -> dict:
    """Phase 14 (6): UNet's b10 f32 train step, kernel path and plain f32
    path (TF32 off): ms, img/s and peak memory (``bench.measure_train``,
    F32_TIME_STEPS steps after 3 warm-ups)."""
    out = {}
    for plain in (False, True):
        model = bench.he_model("unet", torch.Generator().manual_seed(SEED))
        r = bench.measure_train(model.cuda(), RUN_BATCH, F32_TIME_STEPS,
                                hw=HW, plain=plain, seed=SEED,
                                compute_dtype=torch.float32)
        out["plain" if plain else "kernel"] = r
        print(f"unet f32 train {'plain (TF32 off)' if plain else 'kernel'} "
              f"path b{RUN_BATCH}: step {r['step_ms']:.2f} ms, "
              f"{r['images_per_sec']:.2f} img/s, peak memory "
              f"{r['max_memory_allocated'] / 2 ** 30:.2f} GiB, losses "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} on "
              f"{bench.card()}", flush=True)
        check(r["finite"], "f32 timed step's losses")
        del model
        torch.cuda.empty_cache()
    return out


def phase_f32(tmp: str, data: str) -> dict:
    """Phase 14 (module docstring). Returns UNet's f32 sums and the main
    paths' launches for the JSON entries, and the f32 train CLI run's raw
    losses for UNet ("unet_raw", phase 15's reference)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = f32_kernel_checks(gen)
    sums = f32_sums(f32_timings(gen), errs)
    runs = {net: f32_training_run(tmp, data, net) for net in TRAIN_BATCH}
    voc_checks(os.path.join(tmp, "f32_voc"), "float32")
    f32_predict_checks(tmp, data, runs["unet"]["ckpt"])
    f32_lr_finder_checks(data)
    f32_step_timing()
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"sums": sums["unet"], "k4": runs["unet"]["k4"],
            "k1": runs["unet"]["counts"], "k4_paths": runs["unet"]["k4_paths"],
            "k1_paths": runs["unet"]["paths"],
            "unet_raw": runs["unet"]["raw"]}


def f32_entries(f32: dict) -> list:
    """The JSON entries of the four f32 instances: UNet's sums at b10 over
    its blocks (``f32_sums``), launches from the f32 eval CLI (K4) and the
    f32 train CLI run (K1), in all and on each f32 route."""
    src = "pytorch_camvid_tpu_torch/csrc/conv3x3_f32.cu"
    out = []
    for piece, name, replaces, key in (
            ("k4", "conv3x3_bn_relu_f32",
             "pytorch_camvid_tpu/ops/pallas_conv.py:230", None),
            ("fwd", "conv3x3_train_f32.fwd",
             "pytorch_camvid_tpu/ops/pallas_conv.py:230", "fwd"),
            ("dx", "conv3x3_train_f32.dgrad",
             "pytorch_camvid_tpu/ops/pallas_conv.py:230", "dgrad"),
            ("wgrad", "conv3x3_train_f32.wgrad",
             "pytorch_camvid_tpu/ops/pallas_conv_train.py:172", "wgrad")):
        launches = f32["k4"] if key is None else f32["k1"][key]
        by_route = f32["k4_paths"] if key is None else f32["k1_paths"][key]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches,
                    **f32["sums"][piece],
                    "path_launches": {r: by_route[r]
                                      for r in ("f32", "f32_packed",
                                                "f32_narrow")}})
    return out


# ------------------------------------- remat and the data-side CLIs (15)

REMAT_TIME_STEPS, REMAT_WARMUP = 5, 2
REMAT_PEAK_RATIO = 0.75   # the remat step's peak memory / the step's without
BENCHMARK_EPOCHS = 125    # 64 synthetic images at b8: 8000 samples
BENCHMARK_LINE = re.compile(
    r"total (\d+) samples, total \d+\.\d\ds, average \d+ samples/sec")


def remat_path_counts(net: str, steps: int,
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    """K1's launches on each path in ``steps`` remat steps: every block's
    forward twice (the recompute), dx and dW once."""
    out = path_counts(net, steps, dtype=dtype)
    out["fwd"] = {p: 2 * k for p, k in out["fwd"].items()}
    return out


def expected_remat_counts(net: str, steps: int) -> dict:
    """Launches of ``steps`` remat steps: the pools (K2) stay outside the
    recomputed stages, so only K1's forward doubles."""
    out = expected_train_counts(net, steps)
    out["fwd"] *= 2
    return out


@contextlib.contextmanager
def recorded_grads(out: list):
    """Inside the block each ``loss_and_grads`` of a train step appends a
    copy of its (loss, {name: gradient})."""
    saved = steps_mod.loss_and_grads

    def record(*args, **kw):
        loss, grads = saved(*args, **kw)
        out.append((loss.clone(), {k: g.clone() for k, g in grads.items()}))
        return loss, grads

    steps_mod.loss_and_grads = record
    try:
        yield out
    finally:
        steps_mod.loss_and_grads = saved


def remat_step(model, batch, remat: bool) -> dict:
    """One bench step (bf16) from ``model``'s state on a copy, with or
    without ``remat``: its loss and gradients, the model's buffers after it
    (BN running stats and counts), its launches, K1's on each path, and
    every kernel call against its plain version (``shadowed_kernels``)."""
    m = copy.deepcopy(model)
    opt, step = bench.make_bench_step(TRAIN_STEPS + 10, remat=remat)
    state = TrainState.create(m, opt, seed=SEED)
    shadow, seen = {}, []
    torch.cuda.synchronize()
    reset_counts()
    with shadowed_kernels(shadow), recorded_grads(seen):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    (loss, grads), = seen
    out = {"loss": loss, "grads": grads, "shadow": shadow,
           "buffers": {k: v.clone() for k, v in m.named_buffers()},
           "counts": train_counts(), "paths": conv_train.path_launches()}
    del m, state, step
    torch.cuda.empty_cache()
    return out


def remat_parity(net: str, model, batch) -> dict:
    """Phase 15 (1): the step without remat and the remat step from one
    state on one batch: the loss, every gradient leaf and every buffer
    bit for bit, each BN count advanced by exactly one; each step's
    launches (the remat step's forwards twice, ``remat_path_counts``) and
    every kernel call of the remat step, the recompute's included, against
    its plain version (phase 9's limits). Returns the remat step's
    launches and K1's on each path."""
    p, r = remat_step(model, batch, False), remat_step(model, batch, True)
    grads_off = sorted(k for k in p["grads"]
                       if not torch.equal(p["grads"][k], r["grads"][k]))
    bufs_off = sorted(k for k in p["buffers"]
                      if not torch.equal(p["buffers"][k], r["buffers"][k]))
    counts = {int(v) for k, v in r["buffers"].items()
              if k.endswith("num_batches_tracked")}
    print(f"{net} remat step b{TRAIN_BATCH[net]} (bf16) against the step "
          f"without remat from one state: loss {p['loss'].item():.6f} / "
          f"{r['loss'].item():.6f}, bit-equal "
          f"{torch.equal(p['loss'], r['loss'])}; gradient leaves unequal "
          f"{len(grads_off)} of {len(p['grads'])} {grads_off[:4]}; buffers "
          f"unequal {len(bufs_off)} of {len(p['buffers'])} {bufs_off[:4]}; "
          f"BN counts after it {sorted(counts)}; launches {r['counts']} "
          f"(without remat {p['counts']}); K1 on each path {r['paths']}; "
          f"each kernel call against its plain version, worst per piece: "
          + "; ".join(f"{piece} {e:.3g} (tol {SHADOW_TOL[piece]})"
                      for piece, e in r["shadow"].items()), flush=True)
    check(p["counts"] == expected_train_counts(net, 1)
          and p["paths"] == path_counts(net, 1),
          f"{net} launches of the step without remat")
    check(r["counts"] == expected_remat_counts(net, 1)
          and r["paths"] == remat_path_counts(net, 1),
          f"{net} launches of the remat step")
    want = [piece for piece in SHADOW_TOL
            if POOLS[net] or piece.startswith("K1")]
    check(sorted(r["shadow"]) == sorted(want),
          f"{net} remat step's kernel pieces seen")
    for piece, e in r["shadow"].items():
        check(e <= SHADOW_TOL[piece], f"{net} remat step's {piece}")
    check(counts == {1}, f"{net} remat step's BN counts advanced by one")
    check(torch.equal(p["loss"], r["loss"]) and not grads_off
          and not bufs_off, f"{net} remat step bit-equal to the step "
          f"without remat")
    return {"counts": r["counts"], "paths": r["paths"]}


def remat_timings(net: str, model) -> dict:
    """Phase 15 (2): ``measure_train`` without and with remat from one
    state: the median of REMAT_TIME_STEPS steps after REMAT_WARMUP, the
    peak memory (the remat one at most REMAT_PEAK_RATIO of the other's)
    and the launches."""
    b, out = TRAIN_BATCH[net], {}
    for remat in (False, True):
        m = copy.deepcopy(model)
        torch.cuda.empty_cache()
        reset_counts()
        r = bench.measure_train(m, b, REMAT_TIME_STEPS, REMAT_WARMUP, hw=HW,
                                seed=SEED, remat=remat)
        counts, paths = train_counts(), conv_train.path_launches()
        steps = REMAT_TIME_STEPS + REMAT_WARMUP
        print(f"{net} train b{b} bf16 {'remat' if remat else 'without remat'}"
              f": step median {r['step_ms_median']:.2f} ms (each "
              f"{' '.join(f'{t:.2f}' for t in r['step_ms_each'])}), peak "
              f"memory {r['max_memory_allocated'] / 2 ** 30:.3f} GiB "
              f"({r['max_memory_allocated']} B), losses "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; launches "
              f"{counts}, K1 on each path {paths} ({steps} steps) on "
              f"{bench.card()}", flush=True)
        check(r["finite"], f"{net} remat timing's losses")
        want = ((expected_remat_counts(net, steps),
                 remat_path_counts(net, steps)) if remat else
                (expected_train_counts(net, steps), path_counts(net, steps)))
        check((counts, paths) == want, f"{net} launches in the timed run "
              f"(remat {remat})")
        out["remat" if remat else "plain"] = r
        del m
        torch.cuda.empty_cache()
    ratio = (out["remat"]["max_memory_allocated"]
             / out["plain"]["max_memory_allocated"])
    speed = out["remat"]["step_ms_median"] / out["plain"]["step_ms_median"]
    print(f"{net} remat against without: peak memory x{ratio:.3f} (limit "
          f"{REMAT_PEAK_RATIO}), step median x{speed:.3f} on {bench.card()}",
          flush=True)
    check(ratio <= REMAT_PEAK_RATIO, f"{net} remat peak memory")
    return out


@contextlib.contextmanager
def recorded_losses(out: list):
    """Inside the block each train step that the training loop builds
    appends its raw loss to ``out``."""
    saved = loop.make_train_step

    def make(*args, **kw):
        step = saved(*args, **kw)

        def run(state, batch):
            state, met = step(state, batch)
            out.append(float(met["loss"]))
            return state, met
        return run

    loop.make_train_step = make
    try:
        yield out
    finally:
        loop.make_train_step = saved


def remat_cli_run(tmp: str, data: str, want: list) -> dict:
    """Phase 15 (3): the train CLI with ``-remat`` at its default (f32),
    phase 14's UNet arguments and data: its per-step losses are phase
    14's run's (``want``) bit for bit, its K1 launches on "f32" and
    "f32_packed" only, every forward twice."""
    workdir = os.path.join(tmp, "remat_unet")
    os.makedirs(workdir)
    raw = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(workdir), recorded_losses(raw):
        history = train_cli.main(f32_argv("unet", data) + ["-remat"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths = conv_train.path_launches()
    steps = RUN_SPLITS["train"][0] // RUN_BATCH
    print(f"unet train CLI -remat (no -dtype: f32; b{RUN_BATCH}, 1 epoch): "
          f"losses {raw} against phase 14's {want}; K1 on each path "
          f"{paths}; {wall:.2f} s in all on {bench.card()}", flush=True)
    check([h["epoch"] for h in history] == [1], "remat CLI run's epoch")
    check(paths == remat_path_counts("unet", steps, torch.float32),
          "remat CLI run's K1 launches on the f32 routes")
    check(len(raw) == steps and raw == want,
          "remat CLI run's losses bit-equal to phase 14's")
    return {"paths": paths}


def data_cli_checks(tmp: str) -> None:
    """Phase 15 (4): ``python -m pytorch_camvid_tpu_torch.benchmark
    -synthetic`` (BENCHMARK_EPOCHS epochs) and ``batch_sweep -net unet
    -batches 24 -steps 3 -remat`` through their ``main``s on the card:
    the benchmark's lines in JAX's format with JAX's sample counts, after
    the card's; one sweep row with the card and no error, and the same
    sweep again skipped as recorded."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        n = benchmark_cli.main(["-synthetic", "-epochs",
                                str(BENCHMARK_EPOCHS)])
    lines = out.getvalue().splitlines()
    print("benchmark -synthetic: " + " | ".join(lines), flush=True)
    counts = [int(m.group(1)) for m in map(BENCHMARK_LINE.fullmatch,
                                           lines[1:]) if m]
    check(lines[0] == f"device: {bench.card()}"
          and len(counts) == len(lines) - 1
          and counts == list(range(1000, n + 1, 1000)) + [n]
          and n == BENCHMARK_EPOCHS * 64, "benchmark's lines and counts")
    path = os.path.join(tmp, "sweep.jsonl")
    argv = ["-net", "unet", "-batches", "24", "-steps", "3", "-remat",
            "-out", path]
    rows = batch_sweep.main(argv)
    print(f"batch_sweep: {json.dumps(rows)}", flush=True)
    check(len(rows) == 1 and "error" not in rows[0]
          and rows[0]["card"] == bench.card() and rows[0]["remat"]
          and finite_rows(rows[0]), "batch_sweep's row")
    with contextlib.redirect_stdout(io.StringIO()):
        again = batch_sweep.main(argv)
    check(again == [], "batch_sweep skips a recorded row")


def phase_remat(tmp: str, data: str, f32_raw: list) -> dict:
    """Phase 15 (module docstring). Returns UNet's remat launches (the
    bf16 step's K1 on each path) for the JSON entries."""
    t0 = time.perf_counter()
    out = {}
    for net in TRAIN_BATCH:
        model, batch = train_setup(net, torch.Generator().manual_seed(SEED))
        out[net] = remat_parity(net, model, batch)
        remat_timings(net, model)
        del model, batch
        torch.cuda.empty_cache()
    remat_cli_run(tmp, data, f32_raw)
    data_cli_checks(tmp)
    check("jax" not in sys.modules, "jax was imported")
    print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)
    return out["unet"]


# ------------------------------------------------------------------ main

# ------------------------------------------------- int8 serving (phase 16)

INT8_MIN_COUT = 64   # quant.quantize_model's default: the heads stay float
# edges: the 12- and 21-class heads in int8 (min_cout=0), a Cout that is no
# tile multiple
INT8_EDGE = ((BATCH, 360, 480, 64, 12), (BATCH, 360, 480, 64, 21),
             (BATCH, 360, 480, 64, 24), (2, 45, 61, 192, 200))
# batch views x[1:] at 45x61: the stem's starts off a 16-byte boundary
INT8_VIEW = ((3, 45, 61, 3, 64), (3, 45, 61, 64, 64))
# a width-3/4 model's channels: Cin 48 (the 64-byte box, its last k32 step
# half TMA's zeros) into 48 and 96, and 96 (the 128-byte box) into 64
INT8_CIN48 = ((BATCH, 90, 120, 48, 48), (BATCH, 90, 120, 48, 96),
              (BATCH, 90, 120, 96, 64))
# Cin from 32 that is no multiple of 16: the wgmma path over x's padded
# layout (pixel stride 16 * ceil(Cin / 16)); Cin 40 (first: the planted
# faults of that layout are caught there) is SegNet's at 5/8, 36 and 72
# UNet's at 9/16; 40 -> 12 copies its int8 rows out by element
INT8_ODD = ((BATCH, 90, 120, 40, 40), (2, 45, 61, 33, 64),
            (2, 45, 61, 36, 36), (2, 45, 61, 72, 72),
            (2, 45, 61, 100, 128), (2, 23, 31, 40, 12))
# the padded route's cost at the stage sizes of those widths (b8), beside
# the wgmma path at Cin 48 and 80 and K4 bf16 on the same shapes
INT8_ODD_TIMED = ((360, 480, 36, 36), (360, 480, 40, 40),
                  (180, 240, 72, 72), (360, 480, 48, 48),
                  (180, 240, 80, 80))
# the widths the JAX package serves in int8 whose block Cin are no
# multiple of 16: SegNet 3, 40, 80, ...; UNet 3, 36, 72, 144, ...
INT8_ODD_WIDTH = {"segnet": 0.625, "unet": 0.5625}
INT8_FRAMES = {"calib": 8, "served": 24}
# the input quantize kernel: (N, H, W, C, dtype): UNet's largest stage
# entry, the stem, an f32 input (eval's default), a ragged element count;
# and a batch view off a 16-byte boundary
INT8_QUANTIZE = ((BATCH, 360, 480, 128, torch.bfloat16),
                 (BATCH, 360, 480, 3, torch.bfloat16),
                 (2, 45, 61, 64, torch.float32), (1, 7, 9, 5, torch.bfloat16),
                 # written at the padded pixel stride
                 (2, 45, 61, 36, torch.bfloat16),
                 (2, 45, 61, 40, torch.float32),
                 (1, 7, 9, 33, torch.bfloat16))
INT8_QUANTIZE_VIEW = (3, 45, 61, 3, torch.float32)
INT8_MODES = (torch.int8, torch.bfloat16, torch.float32)


def int8_block_shapes(net: str, spec=None) -> list:
    """(H, W, Cin, Cout) of each block ``quantize_model`` quantizes at its
    default ``min_cout``, in spec order (``spec``: the model's, default
    full width)."""
    return [s for s in bench.block_shapes(net, HW, spec)
            if s[3] >= INT8_MIN_COUT]


def int8_inputs(gen: torch.Generator, n, h, w, cin, cout) -> dict:
    """A quantized block's operands on the card: int8 x and w_q uniform in
    [-127, 127] (a product's rms 73.3^2), scales that keep acc * s_x * s_w
    of order 1 at every pixel (rms 0.5-1.5 by channel), so the int8 output
    spreads over its range as a real block's does, and the packed
    weights."""
    dev = torch.device("cuda")
    x = torch.randint(-127, 128, (n, h, w, cin), generator=gen, device=dev,
                      dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen,
                       device=dev, dtype=torch.int8)
    s_w = (torch.rand(cout, generator=gen, device=dev) + 0.5) \
        / (73.3 * (9 * cin) ** 0.5)
    return {"x": x, "w_q": wq, "s_w": s_w,
            "s_x": torch.tensor(1 / 127, device=dev),
            "b_eff": torch.randn(cout, generator=gen, device=dev) * 0.5,
            "s_out": torch.tensor(4 / 127, device=dev),
            "packed": fused_conv_int8.pack_weights(wq)}


def int8_call(t: dict, mode: torch.dtype, plain: bool = False):
    """One call of the quantized block in output ``mode`` (int8: with
    ``s_out``) on the kernel or its plain version."""
    s_out = t["s_out"] if mode == torch.int8 else None
    args = (t["x"], t["w_q"], t["s_w"], t["s_x"], t["b_eff"], s_out, mode)
    if plain:
        return fused_conv_int8.conv3x3_int8_block_plain(*args)
    return fused_conv_int8.conv3x3_int8_block(*args, packed=t["packed"])


def int8_modes_equal(t: dict, what: str) -> None:
    """The kernel equals its plain version bit for bit in all three output
    modes (one exact int32 accumulator for the three plain epilogues)."""
    got = [int8_call(t, m) for m in INT8_MODES]
    torch.cuda.synchronize()
    acc = fused_conv_int8.conv2d_int8(t["x"], t["w_q"])
    for m, g in zip(INT8_MODES, got):
        want = fused_conv_int8.int8_epilogue(
            acc, t["s_w"], t["s_x"], t["b_eff"],
            t["s_out"] if m == torch.int8 else None, m)
        same, err = bit_equal(g, want)
        check(same, f"conv3x3_int8 bit-equal to plain at {what} "
                    f"({str(m)[6:]} out; max|diff| {err})")


def padded_weights_ok(packed: torch.Tensor, w_q: torch.Tensor) -> bool:
    """``pack_weights``' wgmma layout: (9, Cout, Cs), below Cin the K-major
    bytes of ``w_q``, zeros past it."""
    cin, cout = w_q.shape[2], w_q.shape[3]
    cs = fused_conv_int8.pixel_stride(cin)
    return (tuple(packed.shape) == (9, cout, cs)
            and torch.equal(packed[..., :cin],
                            w_q.reshape(9, cin, cout).transpose(1, 2))
            and not bool(packed[..., cin:].any()))


def poisoned(t: dict) -> dict:
    """``t`` with x in the padded layout (``empty_block_input``'s) and the
    channels past Cin set to 1, both in x's buffer and in the packed
    weights: x's tensor map stops at Cin, so the result must not move."""
    n, h, w, cin = t["x"].shape
    buf = torch.ones((n, h, w, fused_conv_int8.pixel_stride(cin)),
                     dtype=torch.int8, device=t["x"].device)
    buf[..., :cin] = t["x"]
    packed = t["packed"].clone()
    packed[..., cin:] = 1
    return dict(t, x=buf[..., :cin], packed=packed)


def refused(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def quantize_inputs(gen: torch.Generator, n, h, w, c, dtype) -> tuple:
    """(x, s): x normal in ``dtype`` with a quarter of its values put on
    the half-integers of x / s, where the rounding's tie rule and the
    division's last bit decide; s an f32 scalar on the card."""
    dev = torch.device("cuda")
    s = torch.tensor(0.0123, device=dev)
    x = torch.randn(n, h, w, c, generator=gen, device=dev)
    k = torch.randint(-130, 131, x.shape, generator=gen, device=dev)
    ties = torch.rand(x.shape, generator=gen, device=dev) < 0.25
    x = torch.where(ties, (k + 0.5) * s, x).to(dtype)
    return x, s


def quantize_equal(x: torch.Tensor, s: torch.Tensor, what: str) -> None:
    """The quantize kernel bit-equal to plain, its (N,H,W,C) result in the
    int8 block's layout (padded where C >= 32 is no multiple of 16)."""
    got = fused_conv_int8.quantize(x, s)
    torch.cuda.synchronize()
    same, err = bit_equal(got, fused_conv_int8.quantize_plain(x, s))
    check(same, f"the quantize kernel bit-equal to plain at {what} "
                f"(max|diff| {err})")
    check(got.stride() == fused_conv_int8.block_strides(*got.shape),
          f"the quantize kernel's result in the block layout at {what}: "
          f"strides {got.stride()}")


def int8_bound(n, h, w, cin, cout, out_bytes: int) -> tuple:
    """(ms, by) of one quantized block: its operations at the int8 peak,
    or its bytes: int8 x and w read once, the output written once."""
    ops = 2.0 * 9 * n * h * w * cin * cout
    nbytes = n * h * w * cin + 9 * cin * cout + n * h * w * cout * out_bytes
    return bound_ms(ops, nbytes, bench.H100_INT8_PEAK)


def im2col_int8(x: torch.Tensor) -> torch.Tensor:
    """(N*H*W, 9*Cin) int8, the conv's patches, K zero-padded to a
    multiple of 8 (``torch._int_mm``'s rule)."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                        for dx in range(3)], dim=3).reshape(n * h * w, 9 * c)
    return F.pad(cols, (0, -(-9 * c // 8) * 8 - 9 * c)).contiguous()


def int8_yardsticks(t: dict, n, h, w, cin, cout) -> dict:
    """K4 and cuDNN's conv in bf16 on the same shape, and cuBLASLt's int8
    GEMM (``torch._int_mm``) on a prebuilt im2col matrix, the GEMM alone
    (None where it refuses the shape)."""
    dev = torch.device("cuda")
    xb = t["x"].to(torch.bfloat16)
    wb = t["w_q"].to(torch.bfloat16)
    a = torch.ones(cout, device=dev)
    out = {"k4_ms": cuda_ms(lambda: fused_conv.conv3x3_bn_relu(
        xb, wb, a, t["b_eff"]))}
    xc, wc = xb.permute(0, 3, 1, 2), wb.permute(3, 2, 0, 1)
    out["cudnn_ms"] = cuda_ms(lambda: F.conv2d(xc, wc, padding=1))
    del xb, wb, xc, wc
    out["int_mm_ms"] = None
    if cout % 8 == 0:
        cols = im2col_int8(t["x"])
        wm = F.pad(t["w_q"].reshape(9 * cin, cout),
                   (0, 0, 0, cols.shape[1] - 9 * cin)).contiguous()
        try:
            out["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(cols, wm))
        except RuntimeError as e:
            print(f"torch._int_mm refused {tuple(cols.shape)} x "
                  f"{tuple(wm.shape)}: {str(e).splitlines()[0]}", flush=True)
        del cols, wm
    return out


PTXAS_WARNING = re.compile(r"\((C75\d\d)\).*?function '[^']*?"
                           r"conv3x3_int8_(wgmma|packed)_kernelI(\w*?)EEv")


def int8_build_warnings() -> dict:
    """{ptxas code: [kernel instance, e.g. "wgmma<128,0,128>"]} of the
    int8 build's performance warnings (C7519: a warpgroup.arrive injected
    to let a wgmma use its registers; C7512: wgmmas serialized for want of
    registers), from its nvcc log."""
    _, _, log = cuda_build.build(fused_conv_int8.SOURCE)
    out = {"C7519": [], "C7512": []}
    for code, kind, args in PTXAS_WARNING.findall(log):
        vals = ",".join(v for _, v in re.findall(r"L([ib])(\d+)E", args + "E"))
        out.setdefault(code, []).append(f"{kind}<{vals}>")
    return out


def int8_kernel_checks(gen: torch.Generator, timed: bool = True) -> dict:
    """Phase 16 (1): the int8 build's ptxas warnings (no C7519); then
    conv3x3_int8 against its plain version, bit for bit in all three
    output modes, at every quantized block shape of both models at b8
    (``int8_block_shapes``), at ``INT8_EDGE``, at ``INT8_CIN48`` (on the
    wgmma path: its launches counted there) and on the views of
    ``INT8_VIEW``; at ``INT8_ODD`` (Cin 33-100, no multiple of 16: their
    launches counted on the wgmma path) also with the channels past Cin
    poisoned (``poisoned``), and the packed weights' zero columns
    (``padded_weights_ok``); Cin 0 refused; with ``timed``, per shape: the
    kernel in the int8 and the bf16 output mode, the plain version, the
    bounds and the yardsticks. Returns {shape: timings}."""
    warn = int8_build_warnings()
    print(f"int8 build ptxas: C7519 {len(warn['C7519'])}, C7512 "
          f"{len(warn['C7512'])} {sorted(set(warn['C7512']))}", flush=True)
    check(not warn["C7519"], f"no C7519 in the int8 build: {warn['C7519']}")
    res = {}
    shapes = list(dict.fromkeys(int8_block_shapes("unet")
                                + int8_block_shapes("segnet")))
    for h, w, cin, cout in shapes:
        t = int8_inputs(gen, BATCH, h, w, cin, cout)
        what = f"{BATCH}x{h}x{w} {cin}->{cout}"
        int8_modes_equal(t, what)
        if not timed:
            continue
        r = {"ms_int8": cuda_ms(lambda: int8_call(t, torch.int8)),
             "ms_bf16": cuda_ms(lambda: int8_call(t, torch.bfloat16)),
             "plain_ms": cuda_ms(lambda: int8_call(t, torch.bfloat16, True),
                                 iters=3, warmup=1),
             "bound_int8": int8_bound(BATCH, h, w, cin, cout, 1),
             "bound_bf16": int8_bound(BATCH, h, w, cin, cout, 2),
             **int8_yardsticks(t, BATCH, h, w, cin, cout)}
        res[(h, w, cin, cout)] = r
        mm = r["int_mm_ms"]
        print(f"int8 {what} ({fused_conv_int8.int8_path(cin)}): bit-equal "
              f"in 3 modes; kernel {r['ms_int8']:.4f} ms int8 out (bound "
              f"{r['bound_int8'][0]:.4f} by {r['bound_int8'][1]}: "
              f"{r['bound_int8'][0] / r['ms_int8']:.2f} of it), "
              f"{r['ms_bf16']:.4f} ms bf16 out (bound "
              f"{r['bound_bf16'][0]:.4f}); plain {r['plain_ms']:.3f}; K4 "
              f"bf16 {r['k4_ms']:.4f}, cuDNN bf16 {r['cudnn_ms']:.4f}, "
              f"_int_mm on im2col "
              f"{'n/a' if mm is None else f'{mm:.4f}'} ms", flush=True)
        del t
    for n, h, w, cin, cout in INT8_EDGE:
        int8_modes_equal(int8_inputs(gen, n, h, w, cin, cout),
                         f"{n}x{h}x{w} {cin}->{cout}")
    for n, h, w, cin, cout in INT8_VIEW:
        t = int8_inputs(gen, n, h, w, cin, cout)
        t["x"] = t["x"][1:]
        int8_modes_equal(t, f"the view x[1:] of {n}x{h}x{w} {cin}->{cout} "
                            f"(data offset {t['x'].data_ptr() % 16} mod 16)")
    fused_conv_int8.reset_launches()
    for n, h, w, cin, cout in INT8_CIN48:
        int8_modes_equal(int8_inputs(gen, n, h, w, cin, cout),
                         f"{n}x{h}x{w} {cin}->{cout}")
    paths = dict(fused_conv_int8.conv3x3_int8_block.path_launches)
    check(paths == {"wgmma": 3 * len(INT8_CIN48), "packed": 0},
          f"Cin 48 and 96 on the wgmma path: {paths}")
    fused_conv_int8.reset_launches()
    for n, h, w, cin, cout in INT8_ODD:
        t = int8_inputs(gen, n, h, w, cin, cout)
        what = f"{n}x{h}x{w} {cin}->{cout}"
        check(padded_weights_ok(t["packed"], t["w_q"]),
              f"pack_weights at Cin {cin}: (9, Cout, "
              f"{fused_conv_int8.pixel_stride(cin)}), zero columns past Cin")
        int8_modes_equal(t, what)
        int8_modes_equal(poisoned(t), f"{what}, the channels past Cin of "
                                      f"x's buffer and the weights 1")
        del t
    paths = dict(fused_conv_int8.conv3x3_int8_block.path_launches)
    check(paths == {"wgmma": 6 * len(INT8_ODD), "packed": 0},
          f"Cin 33-100 on the wgmma path: {paths}")
    dev = torch.device("cuda")
    check(refused(lambda: fused_conv_int8.conv3x3_int8_block(
        torch.zeros((1, 8, 8, 0), dtype=torch.int8, device=dev),
        torch.zeros((3, 3, 0, 64), dtype=torch.int8, device=dev),
        torch.ones(64, device=dev), torch.tensor(1.0, device=dev),
        torch.zeros(64, device=dev))), "conv3x3_int8 refuses Cin 0")
    for *shape, dtype in INT8_QUANTIZE:
        quantize_equal(*quantize_inputs(gen, *shape, dtype),
                       f"{'x'.join(map(str, shape))} {str(dtype)[6:]}")
    *shape, dtype = INT8_QUANTIZE_VIEW
    x, s = quantize_inputs(gen, *shape, dtype)
    quantize_equal(x[1:], s, f"the view x[1:] of {'x'.join(map(str, shape))} "
                             f"(data offset {x[1:].data_ptr() % 16} mod 16)")
    torch.cuda.empty_cache()
    print(f"int8: conv3x3_int8 bit-equal to plain in the int8, bf16 and f32 "
          f"output modes at {len(shapes)} block shapes, {len(INT8_EDGE)} "
          f"edge shapes, {len(INT8_CIN48)} Cin 48/96 shapes, "
          f"{len(INT8_VIEW)} batch views and {len(INT8_ODD)} shapes of Cin "
          f"33-100 on the padded layout (also poisoned past Cin), Cin 0 "
          f"refused; the quantize kernel at {len(INT8_QUANTIZE) + 1} "
          f"inputs, ties planted", flush=True)
    return res


def pool_pair_fns(x: torch.Tensor) -> dict:
    """K3's pool and unpool on ``x`` as {name: (kernel, plain, library)}
    closures (library: ``F.max_pool2d`` / ``max_unpool2d``, which may have
    no instance for x's dtype)."""
    hw = (x.shape[1], x.shape[2])
    p, idx = pooling.max_pool_2x2_with_argmax(x)
    xc, pc = x.permute(0, 3, 1, 2), p.permute(0, 3, 1, 2)
    idx64 = idx.permute(0, 3, 1, 2).long()
    return {"maxpool2x2.pool_flat": (
                lambda: fused_pool.max_pool_2x2_argmax(x),
                lambda: pooling.max_pool_2x2_with_argmax(x),
                lambda: F.max_pool2d(xc, 2, 2, return_indices=True)),
            "maxpool2x2.unpool_flat": (
                lambda: fused_pool.max_unpool_2x2(p, idx, hw),
                lambda: pooling.max_unpool_2x2(p, idx, hw),
                lambda: F.max_unpool2d(pc, idx64, 2, 2, output_size=hw))}


def library_device_ms(fn, bound: float = 0.0):
    """``device_ms`` of a library call, None where torch has no instance
    for its dtype."""
    try:
        return device_ms(fn, bound)
    except (RuntimeError, NotImplementedError):
        return None


# bytes of inputs a timed rotation spans: four times the H100's 50 MB L2,
# so that each call reads its input from HBM as the byte bound assumes (on
# one input repeated, SegNet's 45x60x512 bf16 pool ran under that bound
# from L2)
COLD_SPAN = 200_000_000


def cold_inputs(make, nbytes: int, first: torch.Tensor = None) -> list:
    """``first``, where given, and ``make()``'s tensors, of ``nbytes``
    each, enough of them (2 to ``mosaic_probes.ITERS``) to span
    ``COLD_SPAN``."""
    n = min(mosaic_probes.ITERS, max(2, -(-COLD_SPAN // nbytes)))
    xs = [] if first is None else [first]
    return xs + [make() for _ in range(n - len(xs))]


def rotated(fns: list):
    """One closure that calls ``fns`` in turn."""
    turn = itertools.cycle(fns)
    return lambda: next(turn)()


def k3_device_times(xs: list) -> dict:
    """K3's pool and unpool timed over the inputs ``xs`` in turn
    (``cold_inputs``): per function the kernel's device-busy ms
    (``device_ms``, held to the byte bound), the wrapper's CUDA-events ms
    (``cuda_ms``: host time included), the plain pair's and the library's
    device-busy ms and the byte bound."""
    x = xs[0]
    nbytes = pool_bytes(*x.shape, x.element_size())
    pairs = [pool_pair_fns(t) for t in xs]
    out = {}
    for name in pairs[0]:
        kern, plain, lib = (rotated([f[name][i] for f in pairs])
                            for i in range(3))
        bound = nbytes[name] / bench.H100_HBM_RATE * 1e3
        out[name] = {"ms": device_ms(kern, bound),
                     "wrapper_events_ms": cuda_ms(kern),
                     "plain_ms": device_ms(plain, bound),
                     "library_ms": library_device_ms(lib, bound),
                     "bound_ms": bound}
        within_bound(out[name]["ms"], bound,
                     f"K3 {name} device-busy at {tuple(x.shape)} "
                     f"{x.dtype}")
    return out


def add_times(into: dict, t: dict) -> None:
    """Adds ``t``'s figures to ``into``'s (a None stays None)."""
    for key, v in t.items():
        if v is None or into.get(key, 0.0) is None:
            into[key] = None
        else:
            into[key] = into.get(key, 0.0) + v


def int8_pool_checks(gen: torch.Generator, timed: bool = True) -> dict:
    """Phase 16 (2): K3's int8 pool and unpool against their plain pair at
    SegNet's five pool shapes (b8) and at C = 40 (SegNet 5/8's first
    pool: V = 1 channel a thread, as below C % 16), on int8 values in
    [-3, 3] (most windows tie), bit for bit; with ``timed``, at each of
    the five stages ``k3_device_times`` of the int8 pair and of the bf16
    pair on the same shapes, over inputs that read cold, printed per stage
    and summed: {"int8": {name: sums}, "bf16": {name: sums}, "stages":
    [...]}."""
    dev = torch.device("cuda")
    out = {"int8": {}, "bf16": {}, "stages": []}
    for h, w, c in pool_stages() + [HW + (40,)]:
        x = torch.randint(-3, 4, (BATCH, h, w, c), generator=gen,
                          device=dev, dtype=torch.int8)
        hw = (h, w)
        p, idx = pooling.max_pool_2x2_with_argmax(x)
        got = fused_pool.max_pool_2x2_argmax(x)
        unp = fused_pool.max_unpool_2x2(p, idx, hw)
        torch.cuda.synchronize()
        check(got[0].dtype == torch.int8 and torch.equal(got[0], p)
              and torch.equal(got[1], idx),
              f"K3 int8 pool bit-equal at {BATCH}x{h}x{w}x{c}")
        check(torch.equal(unp, pooling.max_unpool_2x2(p, idx, hw)),
              f"K3 int8 unpool bit-equal at {BATCH}x{h}x{w}x{c}")
        del p, idx, got, unp
        if not timed or c == 40:
            continue
        xs = cold_inputs(
            lambda: torch.randint(-3, 4, x.shape, generator=gen, device=dev,
                                  dtype=torch.int8), x.numel(), x)
        xbs = cold_inputs(lambda: torch.randn(
            x.shape, generator=gen, device=dev).to(torch.bfloat16),
            2 * x.numel())
        stage = {"shape": (BATCH, h, w, c), "int8": k3_device_times(xs),
                 "bf16": k3_device_times(xbs)}
        out["stages"].append(stage)
        line = [f"K3 {BATCH}x{h}x{w}x{c}, device-busy ms:"]
        for dt in ("int8", "bf16"):
            for name, t in stage[dt].items():
                add_times(out[dt].setdefault(name, {}), t)
                lib = t["library_ms"]
                line.append(
                    f"{dt} {name.split('.')[1]} {t['ms']:.5f} (wrapper by "
                    f"events {t['wrapper_events_ms']:.5f}; plain "
                    f"{t['plain_ms']:.5f}, library "
                    f"{'n/a' if lib is None else f'{lib:.5f}'}, bound "
                    f"{t['bound_ms']:.5f}: {t['bound_ms'] / t['ms']:.2f} of "
                    f"it);")
        print(" ".join(line), flush=True)
        del x, xs, xbs
    for dt in ("int8", "bf16") if timed else ():
        for name, t in out[dt].items():
            print(f"K3 {dt} {name} over SegNet's 5 b{BATCH} pools: "
                  f"device-busy {t['ms']:.5f} ms (the wrapper by events "
                  f"{t['wrapper_events_ms']:.5f}), bound {t['bound_ms']:.5f}:"
                  f" {t['bound_ms'] / t['ms']:.3f} of it; plain "
                  f"{t['plain_ms']:.5f} ({bench.card()})", flush=True)
    print("K3 int8: pool and unpool bit-equal to the plain pair at SegNet's "
          "5 pool shapes and at C 40, with ties", flush=True)
    return out


def int8_odd_timings(gen: torch.Generator) -> dict:
    """The padded route's cost at ``INT8_ODD_TIMED`` (b8), device-busy ms:
    the kernel on an x already in the padded layout (as the quantize
    kernel writes it) in the int8 and bf16 output modes, the same from a
    contiguous x (the wrapper's one copy pass included), the copy pass
    alone, K4 bf16 on the same shape, and the bound: {shape: {...}}. Each
    reading is held to its bound (``within_bound``)."""
    dev = torch.device("cuda")
    res = {}
    for h, w, cin, cout in INT8_ODD_TIMED:
        t = int8_inputs(gen, BATCH, h, w, cin, cout)
        laid = dict(t, x=fused_conv_int8.block_input(t["x"]))
        xb = t["x"].to(torch.bfloat16)
        wb = t["w_q"].to(torch.bfloat16)
        a = torch.ones(cout, device=dev)
        copied = laid["x"].data_ptr() != t["x"].data_ptr()
        bounds = {"int8_ms": int8_bound(BATCH, h, w, cin, cout, 1)[0],
                  "bf16_ms": int8_bound(BATCH, h, w, cin, cout, 2)[0],
                  "int8_from_contiguous_ms":
                      int8_bound(BATCH, h, w, cin, cout, 1)[0],
                  "copy_ms": (2 * BATCH * h * w * cin / bench.H100_HBM_RATE
                              * 1e3 if copied else 0.0),
                  "k4_bf16_ms": conv_bound(BATCH, h, w, cin, cout)[0]}
        fns = {"int8_ms": lambda: int8_call(laid, torch.int8),
               "bf16_ms": lambda: int8_call(laid, torch.bfloat16),
               "int8_from_contiguous_ms": lambda: int8_call(t, torch.int8),
               "copy_ms": lambda: fused_conv_int8.block_input(t["x"]),
               "k4_bf16_ms": lambda: fused_conv.conv3x3_bn_relu(
                   xb, wb, a, t["b_eff"])}
        r = {key: (device_ms(fn, bounds[key])
                   if key != "copy_ms" or copied else 0.0)
             for key, fn in fns.items()}
        for key, bound in bounds.items():
            within_bound(r[key], bound, f"padded route {key} at b{BATCH} "
                                        f"{h}x{w} {cin}->{cout}")
        r["bound_int8"] = int8_bound(BATCH, h, w, cin, cout, 1)
        res[(h, w, cin, cout)] = r
        print(f"int8 padded route b{BATCH} {h}x{w} {cin}->{cout} (Cs "
              f"{fused_conv_int8.pixel_stride(cin)}), device-busy ms: "
              f"kernel on the padded x {r['int8_ms']:.5f} int8 out, "
              f"{r['bf16_ms']:.5f} bf16 out; from a contiguous x "
              f"{r['int8_from_contiguous_ms']:.5f} (the copy pass "
              f"{r['copy_ms']:.5f}); K4 bf16 {r['k4_bf16_ms']:.5f}; bound "
              f"{r['bound_int8'][0]:.5f} by {r['bound_int8'][1]} "
              f"({bench.card()})", flush=True)
        del t, laid, xb, wb
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def shadowed_int8(errs: dict, quantized: list = None):
    """Inside the block every quantized block of the main path
    (``quant.quantized_block_apply``, the int8 blocks' one caller of
    conv3x3_int8 and of the quantize kernel) is held against its plain
    version on its own input; ``errs`` gets, per (Cin, Cout, output
    dtype), 0 when bit-equal, else the max difference; ``quantized``, when
    given, the (shape, dtype) of each input the block quantized. The plain
    version launches no counted kernel."""
    real = quant.quantized_block_apply

    def shadow(params_q, x, compute_dtype=torch.bfloat16, plain=False):
        out = real(params_q, x, compute_dtype, plain)
        if not plain:
            want = real(params_q, x, compute_dtype, True)
            _note(errs, (x.shape[3], params_q["w_q"].shape[3],
                         str(out.dtype)[6:]), _bits(out, want))
            if quantized is not None and x.dtype != torch.int8:
                quantized.append((tuple(x.shape), x.dtype))
        return out
    quant.quantized_block_apply = shadow
    try:
        yield errs
    finally:
        quant.quantized_block_apply = real


@contextlib.contextmanager
def shadowed_k4(errs: dict):
    """Inside the block every eval-mode K4 call of the main path
    (``ops/conv.py``'s ``conv3x3_bn_relu``, its one caller) is held
    against ``conv3x3_bn_relu_plain`` on its own inputs; ``errs`` gets, per
    (Cin, Cout, K4 path), the worst max|kernel - plain| / max|plain|, to be
    held to ``KERNEL_TOL``. The plain version launches no counted
    kernel."""
    real = conv_ops.conv3x3_bn_relu

    def shadow(x, w, a, b, *args, **kw):
        out = real(x, w, a, b, *args, **kw)
        want = fused_conv.conv3x3_bn_relu_plain(x, w, a, b, *args, **kw)
        cin, cout = x.shape[3], out.shape[3]
        _note(errs, (cin, cout, fused_conv.conv_path(cin, cout)),
              _rel(out, want))
        return out
    conv_ops.conv3x3_bn_relu = shadow
    try:
        yield errs
    finally:
        conv_ops.conv3x3_bn_relu = real


def int8_counts() -> dict:
    return {"conv3x3_int8": fused_conv_int8.conv3x3_int8_block.launches,
            "quantize": fused_conv_int8.quantize.launches,
            "conv3x3_int8_paths":
                dict(fused_conv_int8.conv3x3_int8_block.path_launches),
            "conv3x3_bn_relu": fused_conv.conv3x3_bn_relu.launches,
            **fused_pool.launches()}


def int8_expected(net: str, forwards: int, fused: int, spec=None) -> dict:
    """Launches of ``forwards`` int8 forwards: conv3x3_int8 on each
    quantized block (the stem on the packed path), the quantize kernel on
    each one whose input comes float (all but the ``fused`` ones, whose
    producer emits int8), K4 on the float head, K3's flat pair on SegNet's
    pools (``spec``: the model's, default full width)."""
    shapes = int8_block_shapes(net, spec)
    packed = sum(fused_conv_int8.int8_path(s[2]) == "packed" for s in shapes)
    pools = POOLS[net] * forwards
    return {"conv3x3_int8": len(shapes) * forwards,
            "quantize": (len(shapes) - fused) * forwards,
            "conv3x3_int8_paths": {"wgmma": (len(shapes) - packed) * forwards,
                                   "packed": packed * forwards},
            "conv3x3_bn_relu": (n_blocks(net) - len(shapes)) * forwards,
            "maxpool2x2.pool_flat": pools, "maxpool2x2.unpool_flat": pools,
            "maxpool2x2.pool_phase": 0, "maxpool2x2.unpool_phase": 0,
            "maxpool2x2.phase_gather": 0}


def int8_slice(net: str, rng: np.random.Generator) -> dict:
    """Phase 16 (3): full-width ``he_model(net)`` (seed 0) in a Predictor
    at b8, quantized by ``quantize_int8`` on 8 frames, then ``predict`` on
    24: launches per forward, every int8 launch against plain on its own
    inputs, the kernel path's logits against the plain path's; ms a
    forward and img/s beside the bf16 Predictor's, and the share of
    pixels on which the two class maps agree (information only: random
    weights). Returns the counts, the modes of the blocks and the times."""
    sd = bench.he_model(net, torch.Generator().manual_seed(SEED)).state_dict()
    calib = rng.integers(0, 256, (INT8_FRAMES["calib"],) + HW + (3,),
                         dtype=np.uint8)
    frames = rng.integers(0, 256, (INT8_FRAMES["served"],) + HW + (3,),
                          dtype=np.uint8)
    out = {}
    with Predictor(net, sd, batch_size=BATCH, image_hw=HW) as p8, \
            Predictor(net, sd, batch_size=BATCH, image_hw=HW) as pf:
        p8.quantize_int8(calib)
        qb = quant.quantized_blocks(p8.model)
        out["modes"] = ["int8" if b.s_out is not None else "bf16" for b in qb]
        check(len(qb) == len(int8_block_shapes(net)),
              f"{net}: the quantized blocks")
        if net == "unet":
            check(all(b.s_out is None for b in (
                p8.model.stage_blocks(s)[-1] for s, _ in p8.model.spec)
                if b.quantized), "unet: a stage-final block emits int8")
        forwards = -(-len(frames) // BATCH)
        errs, quantized = {}, []
        torch.cuda.synchronize()
        reset_counts()
        with shadowed_int8(errs, quantized):
            maps8 = p8.predict(frames)
        torch.cuda.synchronize()
        counts = int8_counts()
        want = int8_expected(net, forwards,
                             sum(b.s_out is not None for b in qb))
        out["quantized"] = quantized[: len(quantized) // forwards]
        print(f"{net} int8 serving: {len(frames)} images in {forwards} "
              f"forwards; launches {counts} (expected {want}); each int8 "
              f"launch against plain on its inputs: "
              f"{'bit-equal' if not any(errs.values()) else errs} over "
              f"{len(errs)} (Cin, Cout, out) kinds", flush=True)
        check(counts == want, f"{net} int8 launches per forward")
        check(errs and not any(errs.values()),
              f"{net} int8 launches bit-equal to plain on their inputs")
        check(maps8.shape == (len(frames),) + HW and int(maps8.max()) < 12,
              f"{net} int8 class maps")
        out["launches"] = counts
        xn = logits_parity(f"{net} int8", p8.model,
                           torch.from_numpy(frames[:BATCH]).cuda())
        mapsf = pf.predict(frames)
        out["agree"] = float((maps8 == mapsf).mean())
        with torch.inference_mode():
            out["fwd_ms"] = cuda_ms(lambda: p8.model(xn), iters=10)
            out["fwd_ms_bf16"] = cuda_ms(lambda: pf.model(xn), iters=10)
        imgs = rng.integers(0, 256, (8 * BATCH,) + HW + (3,), dtype=np.uint8)
        for key, p in (("ips", p8), ("ips_bf16", pf)):
            p.predict(imgs[:BATCH])
            rates = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p.predict(imgs)
                torch.cuda.synchronize()
                rates.append(len(imgs) / (time.perf_counter() - t0))
            out[key] = sorted(rates)[1]
            out[key + "_all"] = rates
    print(f"{net} int8 serving b{BATCH}: forward {out['fwd_ms']:.3f} ms "
          f"(bf16 {out['fwd_ms_bf16']:.3f} ms); predict() end to end "
          f"median {out['ips']:.2f} img/s of "
          f"{', '.join(f'{r:.2f}' for r in out['ips_all'])} (bf16 "
          f"{out['ips_bf16']:.2f} of "
          f"{', '.join(f'{r:.2f}' for r in out['ips_bf16_all'])}); int8 and "
          f"bf16 class maps agree on {out['agree']:.4f} of the pixels "
          f"(random weights; information only) on {bench.card()}",
          flush=True)
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_int8_pieces(model):
    """Inside the block ``model``'s kernel path runs the plain version of
    every piece but its float convs: each quantized block and its input
    quantize (``quant.quantized_block_apply`` with ``plain``) and SegNet's
    pools; the float blocks stay on K4. Its result differs from the kernel
    path's only where an int8 kernel or K3 differs from its plain
    version."""
    real = quant.quantized_block_apply

    def plain_apply(params_q, x, compute_dtype=torch.bfloat16, plain=False):
        return real(params_q, x, compute_dtype, True)
    quant.quantized_block_apply = plain_apply
    pools = type(model).__dict__.get("_pools")
    if pools is not None:
        model._pools = lambda plain: pools(model, True)
    try:
        yield
    finally:
        quant.quantized_block_apply = real
        if pools is not None:
            del model._pools


# the b8 forwards at INT8_ODD_WIDTH before the narrow path's design (ms,
# CUDA events; PERF.md §5, NVIDIA H100 80GB HBM3 at 700.00 W)
ODD_FWD_BEFORE_MS = {"unet": {"bf16": 11.332, "int8": 10.651},
                   "segnet": {"bf16": 3.130, "int8": 2.543}}


def odd_width_slice(net: str, rng: np.random.Generator) -> dict:
    """Phase 16 (3b): ``he_model(net)`` at ``INT8_ODD_WIDTH`` (seed 0; its
    blocks of Cin 40, or 36 and 72, on the wgmma path over the padded
    layout) in a b8 Predictor, ``quantize_int8`` on 8 frames, ``predict``
    on 8: launches per forward, every int8 launch bit-equal to plain on
    its own inputs (``shadowed_int8``), every K4 launch of its float
    blocks within ``KERNEL_TOL`` of plain on its own inputs
    (``shadowed_k4``), K4's launches per path in the int8 and the bf16
    forward (UNet's seven narrow blocks on the narrow path, six of them
    float in int8; none on ``mma_sync``), the packed weights' zero
    columns, the Predictor's
    class maps and the model's logits bit-equal to those of the path whose
    int8 pieces all run plain (``plain_int8_pieces``). The all-plain path
    is printed beside, not held: at these widths the blocks of Cout < 64
    stay float (K4 against cuDNN: bf16 roundings), and the next block's
    quantize turns a rounding into an int8 step that random weights carry
    on (0.0707 of max|plain| in SegNet 5/8's logits on the H100), so the
    witnesses are the per-call checks of both kernels. The int8 forward's
    ms beside a bf16 Predictor's on the same weights."""
    width = INT8_ODD_WIDTH[net]
    base = bench.he_model(net, torch.Generator().manual_seed(SEED), width)
    spec, sd = base.spec, base.state_dict()
    calib = rng.integers(0, 256, (INT8_FRAMES["calib"],) + HW + (3,),
                         dtype=np.uint8)
    frames = rng.integers(0, 256, (BATCH,) + HW + (3,), dtype=np.uint8)
    out = {"width": width}
    with Predictor(net, sd, batch_size=BATCH, image_hw=HW) as p8, \
            Predictor(net, sd, batch_size=BATCH, image_hw=HW) as pf:
        p8.quantize_int8(calib)
        qb = quant.quantized_blocks(p8.model)
        check(len(qb) == len(int8_block_shapes(net, spec)),
              f"{net} {width}: the quantized blocks")
        odd = sorted({b.w_q.shape[2] for b in qb
                      if b.w_q.shape[2] >= 32 and b.w_q.shape[2] % 16})
        check(odd == ([40] if net == "segnet" else [36, 72]),
              f"{net} {width}: blocks of Cin {odd} off 16-byte strides")
        check(all(padded_weights_ok(b.w_k, b.w_q) for b in qb
                  if fused_conv_int8.int8_path(b.w_q.shape[2]) == "wgmma"),
              f"{net} {width}: the packed weights' zero columns")
        errs, k4_errs = {}, {}
        torch.cuda.synchronize()
        reset_counts()
        with shadowed_int8(errs), shadowed_k4(k4_errs):
            maps8 = p8.predict(frames)
        torch.cuda.synchronize()
        counts = int8_counts()
        k4_int8 = dict(fused_conv.conv3x3_bn_relu.path_launches)
        mma_sync = fused_conv.conv3x3_bn_relu.mma_sync_launches
        want = int8_expected(net, 1, sum(b.s_out is not None for b in qb),
                             spec)
        check(counts == want, f"{net} {width} int8 launches per forward: "
                              f"{counts}, expected {want}")
        check(errs and not any(errs.values()),
              f"{net} {width} int8 launches bit-equal to plain: {errs}")
        k4_worst = max(k4_errs.values(), default=float("inf"))
        k4_line = ", ".join(f"{k}: {v:.3g}" for k, v in sorted(
            k4_errs.items()))
        print(f"{net} at width {width}: each K4 launch against plain on "
              f"its inputs, max|kernel - plain| / max|plain| by (Cin, "
              f"Cout, path): {k4_line} (tol {KERNEL_TOL})", flush=True)
        check(len(k4_errs) > 0 and k4_worst <= KERNEL_TOL,
              f"{net} {width} K4 launches within KERNEL_TOL of plain on "
              f"their inputs: worst {k4_worst:.3g}")
        with torch.inference_mode():
            xn = to_tensor_normalize(torch.from_numpy(frames).cuda(),
                                     settings.MEAN, settings.STD,
                                     torch.bfloat16)
            got = p8.model(xn)
            with plain_int8_pieces(p8.model):
                ref = p8.model(xn)
            with recorded_choices(p8.model) as choices:
                p8.model(xn)
            with replayed_choices(choices):
                full = p8.model(xn, plain=True)
            torch.cuda.synchronize()
            same = bool(torch.equal(torch.from_numpy(maps8).cuda(),
                                    ref.argmax(-1).to(torch.uint8)))
            err = (got - full).abs().max().item() / full.abs().max().item()
            agree = (got.argmax(-1) == full.argmax(-1)).float().mean().item()
            out["fwd_ms"] = cuda_ms(lambda: p8.model(xn), iters=10)
            out["fwd_ms_bf16"] = cuda_ms(lambda: pf.model(xn), iters=10)
            reset_counts()
            pf.model(xn)
            k4_bf16 = dict(fused_conv.conv3x3_bn_relu.path_launches)
            mma_sync += fused_conv.conv3x3_bn_relu.mma_sync_launches
        shapes = bench.block_shapes(net, HW, spec)
        floats = [s for s in shapes if s[3] < INT8_MIN_COUT]
        want_bf16 = conv_train.step_path_launches(shapes)["fwd"]
        want_int8 = conv_train.step_path_launches(floats)["fwd"]
        out.update(launches=counts, all_plain_err=err, all_plain_agree=agree,
                   odd_cin=odd, k4_paths_bf16=k4_bf16, k4_paths_int8=k4_int8,
                   k4_mma_sync=mma_sync, k4_worst=k4_worst)
        before = ODD_FWD_BEFORE_MS[net]
        print(f"{net} at width {width}: K4 launches by path, bf16 forward "
              f"{k4_bf16} (expected {want_bf16}), int8 forward's float "
              f"blocks {k4_int8} (expected {want_int8}); on mma_sync "
              f"{mma_sync}; b{BATCH} forward {out['fwd_ms_bf16']:.3f} ms "
              f"bf16 (before: {before['bf16']}), {out['fwd_ms']:.3f} ms int8 "
              f"(before: {before['int8']})", flush=True)
        check(k4_bf16 == want_bf16 and k4_int8 == want_int8,
              f"{net} {width} K4 launches per path")
        check(mma_sync == 0, f"{net} {width}: no K4 launch on mma_sync")
        print(f"{net} at width {width} int8 serving b{BATCH}: launches "
              f"{counts}; each int8 launch bit-equal to plain over "
              f"{len(errs)} (Cin, Cout, out) kinds; logits bit-equal to "
              f"the int8-plain path's: {bool(torch.equal(got, ref))}, the "
              f"Predictor's class maps equal to its: {same}; the all-plain "
              f"path (not held): max|diff| / max|plain| {err:.3g}, argmax "
              f"agreement {agree:.4f}; forward {out['fwd_ms']:.3f} ms int8, "
              f"{out['fwd_ms_bf16']:.3f} ms bf16 (its K4 launches by path "
              f"{k4_bf16}) ({bench.card()})", flush=True)
        check(bool(torch.isfinite(got).all()), f"{net} {width} logits")
        check(torch.equal(got, ref), f"{net} {width} logits bit-equal to "
                                     f"the int8-plain path's")
        check(same, f"{net} {width} class maps equal to the int8-plain "
                    f"path's")
    torch.cuda.empty_cache()
    return out


def library_quantize(x: torch.Tensor, s: float) -> torch.Tensor:
    """The library's one call for the quantize: ``quantize_per_tensor``
    (zero point 0, qint8) on an f32 copy of x (it takes f32), its int8
    values."""
    return torch.quantize_per_tensor(x.float(), s, 0,
                                     torch.qint8).int_repr()


def quantize_sums(gen: torch.Generator, slices: dict) -> dict:
    """Per model, the quantize kernel over the inputs one b8 forward
    quantizes (recorded in ``int8_slice``) beside its plain version, its
    byte bound (x read once, int8 written once) and the library's call
    (``library_quantize``, which may multiply by 1/s where the kernel
    divides: the share of its bytes equal to the kernel's is printed):
    {net: {...}}."""
    sums = {}
    for net, sl in slices.items():
        s = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
             "calls": len(sl["quantized"])}
        same = total = 0
        for shape, dtype in sl["quantized"]:
            x, sc = quantize_inputs(gen, *shape, dtype)
            s["ms"] += cuda_ms(lambda: fused_conv_int8.quantize(x, sc))
            s["plain_ms"] += cuda_ms(
                lambda: fused_conv_int8.quantize_plain(x, sc))
            sf = float(sc)
            s["library_ms"] += cuda_ms(lambda: library_quantize(x, sf))
            s["bound_ms"] += (x.numel() * (x.element_size() + 1)
                              / bench.H100_HBM_RATE * 1e3)
            same += int((library_quantize(x, sf)
                         == fused_conv_int8.quantize(x, sc)).sum())
            total += x.numel()
            del x
        s["library_equal"] = same / total
        sums[net] = s
        print(f"{net} quantize kernel over the {s['calls']} inputs a b{BATCH} "
              f"int8 forward quantizes: {s['ms']:.3f} ms (plain "
              f"{s['plain_ms']:.3f}, bound {s['bound_ms']:.3f} by bytes: "
              f"{s['bound_ms'] / s['ms']:.2f} of it; library "
              f"quantize_per_tensor on an f32 copy {s['library_ms']:.3f} ms, "
              f"its bytes equal to the kernel's on {s['library_equal']:.6f} "
              f"of {total})", flush=True)
    torch.cuda.empty_cache()
    return sums


def int8_sums(per_shape: dict, slices: dict) -> dict:
    """Per model, conv3x3_int8 over its quantized blocks of one b8 forward
    (each block in its output mode) beside the bound, the plain version
    and the yardsticks on the same shapes: {net: {...}}, printed."""
    sums = {}
    for net, sl in slices.items():
        shapes = int8_block_shapes(net)
        s = {"ms": 0.0, "plain_ms": 0.0, "k4_bf16_ms": 0.0,
             "cudnn_bf16_ms": 0.0, "int_mm_im2col_ms": 0.0}
        by = {}
        for shape, mode in zip(shapes, sl["modes"]):
            r = per_shape[shape]
            s["ms"] += r["ms_" + mode]
            s["plain_ms"] += r["plain_ms"]
            s["k4_bf16_ms"] += r["k4_ms"]
            s["cudnn_bf16_ms"] += r["cudnn_ms"]
            s["int_mm_im2col_ms"] += r["int_mm_ms"]
            t, kind = r["bound_" + mode]
            by[kind] = by.get(kind, 0.0) + t
        s["bound_ms"] = sum(by.values())
        s["bound_by"] = max(by, key=by.get)
        s["blocks"] = len(shapes)
        sums[net] = s
        print(f"{net} int8 conv sums over its {len(shapes)} quantized blocks "
              f"(b{BATCH}, each in its output mode): conv3x3_int8 "
              f"{s['ms']:.3f} ms (bound {s['bound_ms']:.3f} by "
              f"{s['bound_by']}: {s['bound_ms'] / s['ms']:.2f} of it; plain "
              f"{s['plain_ms']:.3f}); K4 bf16 {s['k4_bf16_ms']:.3f}, cuDNN "
              f"bf16 {s['cudnn_bf16_ms']:.3f}, _int_mm on im2col "
              f"{s['int_mm_im2col_ms']:.3f} ms", flush=True)
    return sums


def int8_cli_checks(tmp: str, run: dict) -> dict:
    """Phase 16 (4): ``eval -int8`` (its f32 default) and ``serve -int8``
    on phase 12's caches and run A's checkpoint. Every int8 launch of the
    eval pass equals plain on its inputs; eval's int8 mIoU beside the
    float eval's; serve's masks and launches."""
    data, a = run["data"], run["a"]
    argv = ["-weight", a["ckpt"], "-net", "unet", "-b", str(RUN_BATCH),
            "-data", data, "-image_size", str(HW[1]), str(HW[0])]
    with contextlib.redirect_stdout(io.StringIO()):
        flt = eval_cli.main(argv)
    errs = {}
    reset_counts()
    t0 = time.perf_counter()
    with shadowed_int8(errs), contextlib.redirect_stdout(io.StringIO()):
        got = eval_cli.main(argv + ["-int8"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = int8_counts()
    batches = -(-RUN_SPLITS["val"][0] // RUN_BATCH)
    n8 = len(int8_block_shapes("unet"))
    print(f"eval -int8 (f32) on run A's checkpoint: miou {got['miou']:.6f} "
          f"(float eval {flt['miou']:.6f}), loss {got['loss']:.4f} (float "
          f"{flt['loss']:.4f}); conv3x3_int8 launches "
          f"{counts['conv3x3_int8']} on {counts['conv3x3_int8_paths']} "
          f"(expected {n8 * batches}), each bit-equal to plain: "
          f"{not any(errs.values())}; K4 f32 launches "
          f"{counts['conv3x3_bn_relu']} (calibration's float forwards and "
          f"the head); {wall:.2f} s", flush=True)
    check(all(np.isfinite(v) for v in got.values()), "eval -int8 figures")
    check(counts["conv3x3_int8"] == n8 * batches, "eval -int8 launches")
    check(errs and not any(errs.values()),
          "eval -int8 launches bit-equal to plain")
    check(set(e[2] for e in errs) <= {"int8", "float32"},
          "eval -int8 emits int8 or f32")
    val = camvid.CamVid(data, image_set="val", image_size=HW[::-1])
    src = os.path.join(tmp, "serve_in")
    os.makedirs(src, exist_ok=True)
    for i in range(3):
        with open(os.path.join(src, f"{i}.png"), "wb") as f:
            np.save(f, val.images[i])
    stand = Cv2Stand()
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = stand
    reset_counts()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as said:
            serve_cli.main(["-weight", a["ckpt"], "-input", src, "-output",
                            os.path.join(tmp, "serve_out"), "-b", "2",
                            "-int8"])
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved
    torch.cuda.synchronize()
    counts = int8_counts()
    masks = [v for k, v in sorted(stand.written.items())]
    print(f"serve -int8 on 3 val images: {said.getvalue().strip()}; "
          f"conv3x3_int8 launches {counts['conv3x3_int8']} (expected "
          f"{n8 * 2}); {len(masks)} masks", flush=True)
    check(len(masks) == 3 and all(m.shape == HW and m.max() < 12
                                  for m in masks), "serve -int8 masks")
    check(counts["conv3x3_int8"] == n8 * 2, "serve -int8 launches")
    for net in ("unet", "segnet"):
        row = run["bench"]["extra"][f"{net}_serving_fwd"]
        keys = {k: row[k] for k in ("images_per_sec_int8",
                                    "images_per_sec_compute_only_int8",
                                    "mfu_compute_only_int8", "int8_speedup")}
        print(f"bench {net}_serving_fwd int8 keys (phase 12's bench.main): "
              f"{json.dumps(keys)}; bf16 compute-only "
              f"{row['images_per_sec_compute_only']:.2f} img/s on "
              f"{row['card']}", flush=True)
        check(all(np.isfinite(v) for v in keys.values()),
              f"bench {net} int8 keys")
    return {"miou_int8": got["miou"], "miou_float": flt["miou"]}


def phase_int8(tmp: str, run: dict) -> dict:
    """Phase 16: int8 serving (module docstring)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    per_shape = int8_kernel_checks(gen)
    odd = int8_odd_timings(gen)
    pools = int8_pool_checks(gen)
    rng = np.random.default_rng(SEED)
    slices = {net: int8_slice(net, rng) for net in ("unet", "segnet")}
    odd_slices = {net: odd_width_slice(net, rng) for net in INT8_ODD_WIDTH}
    sums = int8_sums(per_shape, slices)
    qsums = quantize_sums(gen, slices)
    clis = int8_cli_checks(tmp, run)
    return {"sums": sums, "quantize": qsums, "pools": pools,
            "slices": slices, "odd_slices": odd_slices, "odd": odd,
            "cli": clis}


def int8_entries(r: dict) -> list:
    """The JSON entries of conv3x3_int8 and the quantize kernel: UNet's
    sums over its quantized blocks (its quantized inputs), launches from
    UNet's int8 slice; SegNet's sums beside. No single PyTorch call
    computes the conv (no int8 conv on CUDA), so its ``library_ms`` is
    null and its yardsticks are keys of their own; the quantize's is
    ``quantize_per_tensor`` (``library_quantize``), with the share of its
    bytes equal to the kernel's, ``library_equal``."""
    u, s = r["sums"]["unet"], r["sums"]["segnet"]
    launches = r["slices"]["unet"]["launches"]
    qu, qs = r["quantize"]["unet"], r["quantize"]["segnet"]
    quantize = {
        "name": "conv3x3_int8.quantize", "route": "cuda",
        "source": "pytorch_camvid_tpu_torch/csrc/conv3x3_int8.cu",
        "replaces": "pytorch_camvid_tpu/ops/quant.py:275",
        "launches": launches["quantize"], "max_abs_err": 0.0,
        "ms": qu["ms"], "plain_ms": qu["plain_ms"],
        "bound_ms": qu["bound_ms"], "bound_by": "bytes",
        "library_ms": qu["library_ms"], "library_equal": qu["library_equal"],
        "segnet": {**qs, "launches":
                   r["slices"]["segnet"]["launches"]["quantize"]}}
    return [{"name": "conv3x3_int8", "route": "cuda",
            "source": "pytorch_camvid_tpu_torch/csrc/conv3x3_int8.cu",
            "replaces": "pytorch_camvid_tpu/ops/quant.py:246",
            "launches": launches["conv3x3_int8"], "max_abs_err": 0.0,
            "ms": u["ms"], "plain_ms": u["plain_ms"],
            "bound_ms": u["bound_ms"], "bound_by": u["bound_by"],
            "library_ms": None, "k4_bf16_ms": u["k4_bf16_ms"],
            "cudnn_bf16_ms": u["cudnn_bf16_ms"],
            "int_mm_im2col_ms": u["int_mm_im2col_ms"],
            "path_launches": launches["conv3x3_int8_paths"],
            "segnet": {**s, "launches":
                       r["slices"]["segnet"]["launches"]["conv3x3_int8"]},
            "odd_widths": {
                net: {"width": o["width"], "odd_cin": o["odd_cin"],
                      "path_launches": o["launches"]["conv3x3_int8_paths"],
                      "fwd_ms": o["fwd_ms"], "fwd_ms_bf16": o["fwd_ms_bf16"],
                      "k4_worst_rel_err": o["k4_worst"],
                      "k4_path_launches_bf16": o["k4_paths_bf16"],
                      "k4_path_launches_int8": o["k4_paths_int8"],
                      "k4_mma_sync_launches": o["k4_mma_sync"]}
                for net, o in r["odd_slices"].items()},
            "padded_route": {f"{h}x{w} {ci}->{co}": {
                k: v for k, v in t.items() if k != "bound_int8"}
                for (h, w, ci, co), t in r["odd"].items()}},
            quantize]


# --------------------------------------------------- phase 17: multi-GPU

DP_RANKS = 2
DP_TIMED = 3          # timed steps of each rank after its two checked ones
MH_BATCH = 10         # (d): the train CLI's global batch
HALO_BATCH = 8
MH_MIOU_TOL, MH_CHECKSUM_RTOL = 0.02, 1e-3   # JAX's tests/test_multihost.py
DP_TIMEOUT_S = 300
# (a)'s limits against the one-process step (loss, per-leaf grad norm,
# grad difference, BN stats): phase 6's in bf16; the steps with 255 over
# half of the first rank's rows (``uneven_steps``) in bf16 at
# ``DP_UNEVEN_GRAD_TOL`` for the grad norms, and at float32, on
# ``DP_F32_BATCH`` images (an f32 UNet step at b24 would not fit the card
# beside its one-process reference), with and without them, at phase 14's
# f32 limits. On an H100 the bf16 255 step's worst grad norm read 0.0554
# (the stem's weight; 0.0178 without the 255 rows), the f32 steps' 0.000597
# and 0.000523: at f32 the 255 rows move nothing, so the bf16 gap is bf16
# rounding, held at about twice its reading (PERF.md)
DP_F32_BATCH = 8
DP_UNEVEN_GRAD_TOL = 1e-1
DP_LIMITS = (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_GRAD_DIFF_TOL,
             TRAIN_STAT_TOL)
F32_DP_LIMITS = (F32_TRAIN_LOSS_TOL, F32_TRAIN_GRAD_TOL,
                 F32_TRAIN_GRAD_DIFF_TOL, F32_TRAIN_STAT_TOL)
# {key: (dtype, batch (None: (a)'s), 255 rows, limits)}
DP_STEPS = {
    "bf16_255": (torch.bfloat16, None, True,
                 (TRAIN_LOSS_TOL, DP_UNEVEN_GRAD_TOL, TRAIN_GRAD_DIFF_TOL,
                  TRAIN_STAT_TOL)),
    "f32": (torch.float32, DP_F32_BATCH, False, F32_DP_LIMITS),
    "f32_255": (torch.float32, DP_F32_BATCH, True, F32_DP_LIMITS)}
DP_255 = ", 255 over half of the first rank's rows"


def dp_batch(net: str, dev, uneven: bool = False, n: int = None) -> tuple:
    """(a)'s global batch, phase 6's / 9's (or ``n`` images); ``uneven``:
    with 255 (kept out of the loss) over the top half of the first rank's
    images, so the ranks' loss denominators differ."""
    n = n or TRAIN_BATCH[net]
    images, labels = bench.resident_batch(n, HW, SEED, dev)
    if uneven:
        labels = labels.clone()
        labels[: n // DP_RANKS, : HW[0] // 2] = 255
    return images, labels


def first_step(model, opt, step, batch, grads: bool) -> dict:
    """``dp_result`` of one ``step`` from a copy of ``model``'s state on
    ``batch``."""
    state, met = step(TrainState.create(copy.deepcopy(model), opt,
                                        seed=SEED), batch)
    return dp_result(state, met, grads)


def dp_step_fn(dtype: torch.dtype = torch.bfloat16):
    """bench's step (default augmentation, OneCycle, AdamW; bf16, or
    ``dtype``) with 255 kept out of the loss. Returns (optimizer,
    step_fn)."""
    total = TRAIN_STEPS + 10
    opt = train_mod.adamw(weight_decay=0.0)
    return opt, steps_mod.make_train_step(
        opt, train_mod.onecycle_lr(bench.MAX_LR, total),
        train_mod.onecycle_beta1(total), ignore_index=255,
        augment_fn=augment.make_train_augment(augment.AugmentConfig(
            mean=settings.MEAN, std=settings.STD), dtype),
        compute_dtype=dtype, log_grad_norms=False)


def uneven_steps(net: str, model, step_of, dev,
                 rows=lambda n: slice(None), grads: bool = True) -> dict:
    """The steps of ``DP_STEPS`` from a copy of ``model``: with 255 over
    half of the first rank's rows in bf16 on (a)'s batch ("bf16_255"),
    and at float32 on ``DP_F32_BATCH`` images without and with them
    ("f32", "f32_255"); ``step_of(dtype)`` gives (optimizer, step),
    ``rows(n)`` this rank's rows of a batch of n. Each ``dp_result`` with
    ``grads``."""
    out = {}
    for key, (dtype, n, uneven, _) in DP_STEPS.items():
        opt, step = step_of(dtype)
        images, labels = dp_batch(net, dev, uneven, n)
        r = rows(len(images))
        out[key] = first_step(model, opt, step, (images[r], labels[r]),
                              grads)
        del images, labels
        torch.cuda.empty_cache()
    return out


def dp_result(state: TrainState, met: dict, grads: bool) -> dict:
    """A first step's loss, BN running stats and (``grads``) the gradients
    (AdamW's first moment after one update from zero is (1 - beta1) g), on
    the host."""
    out = {"loss": float(met["loss"]),
           "stats": {k: v.float().cpu().numpy().copy() for k, v in
                     state.model.state_dict().items() if "running" in k}}
    if grads:
        out["grads"] = {k: (v / (1.0 - met["beta1"])).cpu().numpy()
                        for k, v in state.opt_state["m"].items()}
    return out


def dp_reference(net: str) -> dict:
    """The one-process step of (a) from the He-scaled state on the global
    batch: loss, gradients, BN stats, launches; then ``DP_TIMED`` steps'
    median ms; then ``uneven_steps`` from the same state."""
    model = bench.he_model(net, torch.Generator().manual_seed(SEED)).to(
        DEVICE)
    start = copy.deepcopy(model)
    batch = dp_batch(net, DEVICE)
    opt, step = dp_step_fn()
    state = TrainState.create(model, opt, seed=SEED)
    torch.cuda.synchronize()
    reset_counts()
    state, met = step(state, batch)
    torch.cuda.synchronize()
    out = dp_result(state, met, True)
    out["counts"], out["paths"] = train_counts(), conv_train.path_launches()
    out["step_ms"] = timed_steps(step, state, batch, DP_TIMED)
    del model, state, batch
    torch.cuda.empty_cache()
    out["uneven"] = uneven_steps(net, start, dp_step_fn, DEVICE)
    del start
    torch.cuda.empty_cache()
    return out


def timed_steps(step, state, batch, n: int) -> float:
    """Median ms of ``n`` steps on the host clock, each ended by a
    synchronize."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def dp_rank_net(mesh, net: str) -> dict:
    """(a) on one rank: the step of ``dp_reference`` as one rank of
    ``mesh`` (``parallel.jit_train_step``) on its rows of the same batch
    and draws, the first step's launches (SegNet's calls against their
    plain versions, ``shadowed_kernels``), a second step and the SHA-256
    of every leaf after it, then ``DP_TIMED`` timed steps, the gradient
    all-reduce alone and the peak memory; then ``uneven_steps`` from the
    same state on its rows."""
    dev = mesh.device
    model = bench.he_model(net, torch.Generator().manual_seed(SEED)).to(dev)
    start = copy.deepcopy(model)
    images, labels = dp_batch(net, dev)
    rows = mesh.rows(len(images))
    batch = (images[rows], labels[rows])
    opt, step = dp_step_fn()
    step = parallel.jit_train_step(step, mesh)
    state = TrainState.create(model, opt, seed=SEED)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    shadow = {}
    with (shadowed_kernels(shadow) if POOLS[net]
          else contextlib.nullcontext()):
        state, met = step(state, batch)
    torch.cuda.synchronize(dev)
    out = dp_result(state, met, mesh.rank == 0)
    out.update(counts=train_counts(), paths=conv_train.path_launches(),
               shadow=shadow)
    state, _ = step(state, batch)
    out["sha256"] = multihost.state_sha256(state)
    out["step_ms"] = timed_steps(step, state, batch, DP_TIMED)
    grads = {k: torch.ones_like(p) for k, p in state.params().items()}
    ms = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        mesh.reduce_grads(grads, mean=False)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = float(np.median(ms))
    out["allreduce_mb"] = sum(g.numel() for g in grads.values()) * 4 / 1e6
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del state, grads, model, images, labels, batch
    torch.cuda.empty_cache()

    def step_of(dtype):
        opt, step = dp_step_fn(dtype)
        return opt, parallel.jit_train_step(step, mesh)
    out["uneven"] = uneven_steps(net, start, step_of, dev, mesh.rows,
                                 mesh.rank == 0)
    del start
    torch.cuda.empty_cache()
    return out


def halo_inputs(dev) -> tuple:
    """(e)'s inputs: UNet's first encoder stage (3->64->64) from the
    He-scaled model in eval mode on K4 (bf16), and a normalized b8 input at
    360x480."""
    model = bench.he_model("unet", torch.Generator().manual_seed(SEED))
    blocks = [b.to(dev).eval() for b in model.stage_blocks("down1")]
    images, _ = synthetic_arrays(HALO_BATCH, HW, seed=SEED + 17)
    mean, std = (torch.tensor(v, device=dev) for v in (settings.MEAN,
                                                       settings.STD))
    x = to_tensor_normalize(torch.from_numpy(images).to(dev), mean, std,
                            torch.bfloat16)
    return blocks, x


def halo_rank(mesh) -> dict:
    """(e) on one rank: its rows of the H-sharded stage (its halo rows
    exchanged with its neighbour), K4's launches, and the stage's ms."""
    blocks, x = halo_inputs(mesh.device)
    local = spatial.shard_height(x, mesh)
    with torch.no_grad():
        reset_counts()
        y = spatial.encoder_stage_halo(blocks, local, mesh)
        torch.cuda.synchronize(mesh.device)
        launches = fused_conv.conv3x3_bn_relu.launches
        t0 = time.perf_counter()
        spatial.encoder_stage_halo(blocks, local, mesh)
        torch.cuda.synchronize(mesh.device)
    return {"rows": y.float().cpu().numpy(), "launches": launches,
            "ms": (time.perf_counter() - t0) * 1e3}


def dp_rank(mesh, nets, rank_setup=None, halo=True) -> dict:
    """A rank of (a), (c) and (e): ``rank_setup`` (a planted fault of
    ``chip_faults.py``) first, then each net's step and the halo stage."""
    if rank_setup is not None:
        rank_setup()
    out = {net: dp_rank_net(mesh, net) for net in nets}
    if halo:
        out["halo"] = halo_rank(mesh)
    out["backend"] = torch.distributed.get_backend()
    return out


def dp_step_errors(model, ref: dict, got: list) -> dict:
    """One step's DP results (``got``, a ``dp_result`` a rank, rank 0's
    with the gradients) against the one-process step's (``ref``): the
    loss's and the BN stats' largest relative error over the ranks, and
    the worst per-leaf gradient norm and difference (``grad_errors``)."""
    norm_errs, diff_errs = grad_errors(
        model, {k: torch.from_numpy(v) for k, v in got[0]["grads"].items()},
        {k: torch.from_numpy(v) for k, v in ref["grads"].items()})
    return {
        "loss": max(abs(g["loss"] - ref["loss"]) / abs(ref["loss"])
                    for g in got),
        "stats": max(float(np.abs(g["stats"][k] - v).max()
                           / max(np.abs(v).max(), 1e-30))
                     for g in got for k, v in ref["stats"].items()),
        "norm": _worst(norm_errs), "diff": _worst(diff_errs)}


def dp_step_line(e: dict, limits: tuple) -> str:
    """``dp_step_errors``' readings beside ``limits`` (loss, grad norm,
    grad difference, BN stats)."""
    lo, gn, gd, st = limits
    return (f"loss rel {e['loss']:.3g} (tol {lo}); grads: norm rel max "
            f"{e['norm'][1]:.3g} at {e['norm'][0]} (tol {gn}), |diff| rel "
            f"max {e['diff'][1]:.3g} at {e['diff'][0]}, median "
            f"{e['diff'][2]:.3g} (tol {gd}); BN stats rel max "
            f"{e['stats']:.3g} (tol {st})")


def dp_step_checks(e: dict, limits: tuple, what: str, grads: bool) -> None:
    lo, gn, gd, st = limits
    check(np.isfinite(e["loss"]) and e["loss"] <= lo, f"{what}: loss")
    check(e["stats"] <= st, f"{what}: BN stats")
    if grads:
        check(e["norm"][1] <= gn, f"{what}: grad norms")
        check(e["diff"][1] <= gd, f"{what}: grads")


def dp_checks(refs: dict, ranks: list, label: str) -> dict:
    """Hold each rank's results to the one-process step's (``refs``) and
    the ranks to each other: the step on (a)'s batch, and the steps with
    255 over half of the first rank's rows in bf16 and, with and without
    them, at float32 (``uneven_steps``); returns each net's readings."""
    out = {}
    for net, ref in refs.items():
        got = [r[net] for r in ranks]
        n = TRAIN_BATCH[net]
        model = get_model(net, 3, 12)
        steps = {"bf16": dp_step_errors(model, ref, got)}
        for key in DP_STEPS:
            steps[key] = dp_step_errors(
                model, ref["uneven"][key], [g["uneven"][key] for g in got])
        equal = len({g["sha256"] for g in got}) == 1
        per_rank = {"fwd": n_blocks(net), "dgrad": n_blocks(net) - 1,
                    "wgrad": n_blocks(net)}
        print(f"{label} {net} b{n} over {len(got)} ranks of b"
              f"{n // len(got)}: loss {[round(g['loss'], 6) for g in got]} "
              f"vs one process {ref['loss']:.6f}; "
              f"{dp_step_line(steps['bf16'], DP_LIMITS)}; after 2 steps "
              f"every leaf bit-equal across the ranks: {equal}; launches "
              f"per rank {[g['counts'] for g in got]}, K1 on each path "
              f"{[g['paths'] for g in got]}; kernel calls vs plain "
              f"{[g['shadow'] for g in got]}", flush=True)
        for key, (dtype, batch, uneven, limits) in DP_STEPS.items():
            print(f"{label} {net} {str(dtype)[6:]} b{batch or n}"
                  f"{DP_255 if uneven else ''}: loss "
                  f"{[round(g['uneven'][key]['loss'], 6) for g in got]} vs "
                  f"one process {ref['uneven'][key]['loss']:.6f}; "
                  f"{dp_step_line(steps[key], limits)}", flush=True)
        print(f"{label} {net}: DP step {[round(g['step_ms'], 3) for g in got]}"
              f" ms per rank (one process at b{n}: {ref['step_ms']:.3f} ms); "
              f"gradient all-reduce of {got[0]['allreduce_mb']:.1f} MB "
              f"{[round(g['allreduce_ms'], 3) for g in got]} ms; peak "
              f"memory per rank {[round(g['peak_gib'], 3) for g in got]} "
              f"GiB; backend {ranks[0]['backend']}; {bench.card()}",
              flush=True)
        dp_step_checks(steps["bf16"], DP_LIMITS, f"{label} {net} vs one "
                       f"process", GRADS_END_TO_END[net])
        for key, (dtype, _, uneven, limits) in DP_STEPS.items():
            dp_step_checks(steps[key], limits, f"{label} {net} vs one "
                           f"process, {str(dtype)[6:]}"
                           f"{DP_255 if uneven else ''}",
                           GRADS_END_TO_END[net])
        check(equal, f"{label} {net}: the ranks' leaves bit-equal")
        want = expected_train_counts(net, 1)
        for g in got:
            check({k: g["counts"][k] for k in per_rank} == per_rank
                  and g["counts"] == want,
                  f"{label} {net} launches per rank")
            check(g["paths"] == path_counts(net, 1),
                  f"{label} {net} K1 launches per path per rank")
            if POOLS[net]:
                check(sorted(g["shadow"]) == sorted(SHADOW_TOL),
                      f"{label} {net} kernel pieces seen")
                for piece, e in g["shadow"].items():
                    check(e <= SHADOW_TOL[piece], f"{label} {net} {piece} "
                          f"on the rank's data (K2: bit for bit)")
        out[net] = {"launches": [g["counts"] for g in got],
                    "step_ms": [g["step_ms"] for g in got],
                    "allreduce_ms": [g["allreduce_ms"] for g in got],
                    "peak_gib": [g["peak_gib"] for g in got],
                    "one_process_step_ms": ref["step_ms"],
                    "steps": {k: {"loss": e["loss"], "stats": e["stats"],
                                  "grad_norm": e["norm"][1],
                                  "grad_diff": e["diff"][1]}
                              for k, e in steps.items()}}
    return out


def halo_checks(ranks: list) -> dict:
    """(e): the ranks' rows of the H-sharded stage joined, against the
    unsharded stage on K4 in this process: bit-equal, or within K4's
    limit of max|plain|."""
    blocks, x = halo_inputs(DEVICE)
    with torch.no_grad():
        y = x
        for blk in blocks:
            y = blk(y)
        want = pooling.max_pool_2x2(y).float()
    got = torch.from_numpy(np.concatenate([r["halo"]["rows"] for r in ranks],
                                          axis=1)).to(DEVICE)
    same = bool(torch.equal(got, want))
    err = _rel(got, want)
    launches = [r["halo"]["launches"] for r in ranks]
    print(f"phase 17 (e) H-sharded stage (UNet down1, 3->64->64 + pool, "
          f"b{HALO_BATCH}, {HW[0]}x{HW[1]} over {len(ranks)} ranks of "
          f"{HW[0] // len(ranks)} rows, K4): "
          f"{'bit-equal' if same else f'max err {err:.3g} of max|plain| (tol {KERNEL_TOL})'}"
          f" to the unsharded stage on K4; K4 launches per rank "
          f"{launches}; stage ms per rank "
          f"{[round(r['halo']['ms'], 3) for r in ranks]}; {bench.card()}",
          flush=True)
    check(got.shape == want.shape and (same or err <= KERNEL_TOL),
          "phase 17 (e) the H-sharded stage vs the unsharded one")
    check(launches == [len(blocks)] * len(ranks),
          "phase 17 (e) K4 launches per rank")
    return {"bit_equal": same, "max_err": err, "launches": launches}


def dp_phase(nets=("unet", "segnet"), rank_setup=None, devices=None,
             label: str = "phase 17 (a)") -> dict:
    """(a) (or (c) on ``devices``) and (e): the one-process references,
    then one spawn of the ranks, then the checks."""
    refs = {net: dp_reference(net) for net in nets}
    devices = devices or [str(DEVICE)] * DP_RANKS
    ranks = launch.spawn(dp_rank, len(devices), nets, rank_setup,
                         devices=devices, timeout=DP_TIMEOUT_S)
    out = dp_checks(refs, ranks, label)
    out["halo"] = halo_checks(ranks)
    out["backend"] = ranks[0]["backend"]
    return out


def nccl_world1(tmp: str) -> dict:
    """(b): a one-rank NCCL group on cuda:0. The data-parallel step
    (``parallel.jit_train_step``, every collective over the group) and the
    step without it from one state on one batch: every leaf bit-equal;
    then their ms in turns (plain, DP, DP, plain)."""
    multihost.init_distributed(f"file://{tmp}/nccl_rendezvous", 1, 0,
                               "cuda:0")
    try:
        check(torch.distributed.get_backend() == "nccl",
              "phase 17 (b) one rank on one card takes NCCL")
        mesh = parallel.make_mesh()
        dev = mesh.device
        model = bench.he_model("unet", torch.Generator().manual_seed(SEED))
        batch = dp_batch("unet", dev)
        opt, plain_step = dp_step_fn()
        dp_step = parallel.jit_train_step(plain_step, mesh)
        states = [TrainState.create(copy.deepcopy(model).to(dev), opt,
                                    seed=SEED) for _ in range(2)]
        losses = []
        for i, step in enumerate((plain_step, dp_step)):
            states[i], met = step(states[i], batch)
            losses.append(float(met["loss"]))
        same = (multihost.state_sha256(states[0])
                == multihost.state_sha256(states[1]))
        ms = {"plain": [], "dp": []}
        for name in ("plain", "dp", "dp", "plain"):
            i = 0 if name == "plain" else 1
            step = plain_step if name == "plain" else dp_step
            ms[name].append(timed_steps(step, states[i], batch, DP_TIMED))
        plain_ms, dp_ms = (float(np.mean(v)) for v in ms.values())
        print(f"phase 17 (b) one-rank NCCL group: UNet b"
              f"{TRAIN_BATCH['unet']} DP step vs the step without DP: loss "
              f"{losses}, every leaf bit-equal: {same}; step {plain_ms:.3f} "
              f"ms without, {dp_ms:.3f} ms with the NCCL wrapper (overhead "
              f"{dp_ms - plain_ms:.3f} ms; plain, DP, DP, plain: {ms}); "
              f"{bench.card()}", flush=True)
        check(same and losses[0] == losses[1],
              "phase 17 (b) the NCCL world-1 step bit-equal to the step "
              "without DP")
        del states, model, batch
        torch.cuda.empty_cache()
        return {"bit_equal": same, "plain_ms": plain_ms, "dp_ms": dp_ms}
    finally:
        multihost.shutdown()


def checksum(path: str) -> float:
    """Sum of |float leaf| over a checkpoint's model tensors."""
    return float(sum(np.abs(v.numpy()).astype(np.float64).sum()
                     for v in ckpt.load_weights(path, "unet").values()
                     if v.is_floating_point()))


def multihost_checks(tmp: str, data: str) -> dict:
    """(d): ``python -m pytorch_camvid_tpu_torch.train -multihost`` in two
    processes set up by ``PCT_*``, both on the one card (gloo; on two
    cards, a card each and NCCL), UNet at
    global b10 on phase 12's data for one epoch and its eval pass; then the
    same arguments in this process on one rank; then the two-rank
    checkpoint resumed on one rank."""
    argv = ["-net", "unet", "-b", str(MH_BATCH), "-e", "1", "-dtype",
            "bfloat16", "-data", data, "-image_size", str(HW[1]),
            str(HW[0]), "-device", DEVICE.type]
    mh, one = os.path.join(tmp, "mh"), os.path.join(tmp, "mh_one")
    os.makedirs(mh)
    os.makedirs(one)
    env = dict(os.environ, PCT_COORDINATOR=f"file://{tmp}/mh_rendezvous",
               PCT_NUM_PROCS=str(DP_RANKS), PCT_INIT_TIMEOUT=str(
                   DP_TIMEOUT_S))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pytorch_camvid_tpu_torch.train",
         "-multihost"] + argv, cwd=mh, env=dict(env, PCT_PROC_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DP_RANKS)]
    try:
        outs = [p.communicate(timeout=DP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode:
            print(f"phase 17 (d) rank {r} exited {p.returncode}:\n"
                  f"{o[-3000:]}", flush=True)
    check(all(p.returncode == 0 for p in procs),
          "phase 17 (d) the -multihost ranks exit 0")
    with contextlib.chdir(one):
        history = train_cli.main(argv + ["-dp", "1"])
    mh_runs = os.listdir(os.path.join(mh, "checkpoints"))
    miou = [float(m) for m in re.findall(r"Mean_iou ([\d.]+)", outs[0])]
    got_ckpt = os.path.join(run_dir(mh), sorted(os.listdir(run_dir(mh)))[-1])
    want_ckpt = os.path.join(run_dir(one),
                             sorted(os.listdir(run_dir(one)))[-1])
    sums = checksum(got_ckpt), checksum(want_ckpt)
    cfg = loop_config(os.path.join(mh, "checkpoints", "resumed"),
                      batch_size=MH_BATCH, epochs=1, resume=True,
                      device=DEVICE.type)
    state, resumed = loop.run_training(cfg, *splits(data))
    saved = leaves(got_ckpt)
    unequal = [n for n, (_, a) in zip(saved, ckpt.port_leaves(state))
               if not np.array_equal(a, saved[n])]
    steps = RUN_SPLITS["train"][0] // MH_BATCH
    # each takes the card of its place on the host: one card is shared
    backend = ("gloo (ranks share a card)"
               if torch.cuda.device_count() < DP_RANKS
               else "nccl (one card per rank)")
    print(f"phase 17 (d) train CLI -multihost, {DP_RANKS} processes, "
          f"backend {backend}, UNet b{MH_BATCH}, 1 epoch + eval, bf16: "
          f"{wall:.1f} s; "
          f"rank 0 epoch lines "
          f"{outs[0].count('Training Epoch:')}, rank 1 "
          f"{outs[1].count('Training Epoch:')}; run folders written "
          f"{mh_runs}; mIoU {miou} vs one process "
          f"{[round(h['miou'], 4) for h in history]} (tol {MH_MIOU_TOL}); "
          f"parameter checksum {sums[0]:.6f} vs {sums[1]:.6f} (rtol "
          f"{MH_CHECKSUM_RTOL}); resumed on one rank: step {state.step}, "
          f"leaves unequal to the checkpoint {len(unequal)} of "
          f"{len(saved)}; {bench.card()}", flush=True)
    check(f"backend {backend}" in outs[0],
          f"phase 17 (d) the ranks take {backend}")
    check(outs[0].count("Training Epoch:") == steps
          and "Training Epoch:" not in outs[1],
          "phase 17 (d) rank 0 alone prints the epoch's lines")
    check(len(mh_runs) == 1 and len(os.listdir(os.path.join(mh, "runs")))
          == 1, "phase 17 (d) one writer of checkpoints and logs")
    check(f"the {DP_RANKS} ranks' states agree bit for bit" in outs[0],
          "phase 17 (d) the ranks' final leaves bit-equal")
    check(len(miou) == 1 and abs(miou[0] - history[-1]["miou"])
          <= MH_MIOU_TOL, "phase 17 (d) mIoU vs one process")
    check(abs(sums[0] - sums[1]) <= MH_CHECKSUM_RTOL * abs(sums[1]),
          "phase 17 (d) parameter checksum vs one process")
    check(resumed == [] and state.step == steps and not unequal,
          "phase 17 (d) the two-rank checkpoint resumed on one rank")
    return {"wall_s": wall, "miou": miou, "one_miou": history[-1]["miou"],
            "checksums": sums}


def replica_checks() -> dict:
    """(f): ``Predictor(devices=["cuda:0", "cuda:0"])`` at b8, UNet and
    SegNet, against the one-device Predictor on 16 images: class maps
    bit-equal; K4 (and SegNet's K3) launched by each replica on its half
    of every batch."""
    images, _ = synthetic_arrays(2 * BATCH, HW, seed=SEED + 5)
    out = {}
    for net in ("unet", "segnet"):
        sd = bench.he_model(net, torch.Generator().manual_seed(
            SEED)).state_dict()
        maps, counts = [], []
        for devices in ([str(DEVICE)], [str(DEVICE)] * DP_RANKS):
            with Predictor(net, sd, batch_size=BATCH,
                           devices=devices) as p:
                p.predict(images[:BATCH])   # warm-up
                torch.cuda.synchronize()
                reset_counts()
                maps.append(p.predict(images))
                torch.cuda.synchronize()
                counts.append({"conv3x3_bn_relu":
                               fused_conv.conv3x3_bn_relu.launches,
                               **{k: v for k, v in
                                  fused_pool.launches().items()
                                  if k.endswith("flat")}})
        same = bool(np.array_equal(maps[0], maps[1]))
        want = {k: v * DP_RANKS for k, v in counts[0].items()}
        print(f"phase 17 (f) {net} Predictor, {DP_RANKS} replicas on "
              f"{DEVICE} vs one device, b{BATCH}, {len(images)} images: class "
              f"maps bit-equal {same}; launches one device {counts[0]}, "
              f"replicas {counts[1]}", flush=True)
        check(same, f"phase 17 (f) {net} replicas' maps vs one device")
        check(counts[1] == want and counts[0]["conv3x3_bn_relu"]
              == 2 * n_blocks(net), f"phase 17 (f) {net} launches per "
              f"replica")
        out[net] = {"bit_equal": same, "launches": counts[1]}
    return out


def phase_multi_gpu(tmp: str, data: str) -> dict:
    """Phase 17: (a) and (e) on two ranks sharing cuda:0 (gloo), (b) a
    one-rank NCCL group, (c) two cards over NCCL where there are two, (d)
    the train CLI's -multihost, (f) the Predictor's replicas."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    secs = {}

    def part(name, fn, *args, **kw):
        t = time.perf_counter()
        out[name] = fn(*args, **kw)
        secs[name] = round(time.perf_counter() - t, 1)

    out = {}
    part("a", dp_phase)
    if torch.cuda.device_count() >= 2:
        part("c", dp_phase, devices=["cuda:0", "cuda:1"],
             label="phase 17 (c)")
        check(out["c"]["backend"] == "nccl",
              "phase 17 (c) one card per rank takes NCCL")
    else:
        print(f"phase 17 (c) not run: {torch.cuda.device_count()} card "
              f"visible, two-card NCCL needs two", flush=True)
    part("b", nccl_world1, tmp)
    part("d", multihost_checks, tmp, data)
    part("f", replica_checks)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s (by part {secs})",
          flush=True)
    return out


# ------------------------------------------------------ phase 18: export

EXPORT_CPU_AGREE = 0.99   # the card's program run on the CPU (JAX's rule)
EXPORT_F32_BATCH = 4
LIBRARY_NODES = ("aten::convolution", "aten::conv2d", "aten::_convolution",
                 "aten::cudnn_convolution", "aten::max_pool2d_with_indices",
                 "aten::max_unpool2d")
ROOT = os.path.dirname(os.path.abspath(__file__))
# a process that imports ops.library and nothing of the models, the
# Predictor or jax: loads each program on the card, runs it once on its
# images and writes its maps and launches (program_counts' keys)
PROGRAM_LOADER = r"""
import json, sys, time
import numpy as np
import torch
from pytorch_camvid_tpu_torch.ops import (fused_conv, fused_conv_int8,
                                          fused_pool, library)

def foreign():
    return sorted(m for m in sys.modules if m.split(".")[0] == "jax"
                  or m == "pytorch_camvid_tpu"
                  or m.startswith(("pytorch_camvid_tpu.",
                                   "pytorch_camvid_tpu_torch.models",
                                   "pytorch_camvid_tpu_torch.serving")))

out = {}
for job in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    program = library.load_program(job["path"], "cuda:0")
    load_s = time.perf_counter() - t0
    x = torch.from_numpy(np.load(job["images"])).cuda()
    for m in (fused_conv, fused_conv_int8, fused_pool):
        m.reset_launches()
    with torch.inference_mode():
        maps = program(x).cpu().numpy()
    np.save(job["maps"], maps)
    out[job["name"]] = {"load_s": load_s, "counts": {
        "conv3x3_int8": fused_conv_int8.conv3x3_int8_block.launches,
        "quantize": fused_conv_int8.quantize.launches,
        "conv3x3_int8_paths":
            dict(fused_conv_int8.conv3x3_int8_block.path_launches),
        "conv3x3_bn_relu": fused_conv.conv3x3_bn_relu.launches,
        **fused_pool.launches(),
        "conv3x3_bn_relu_paths":
            dict(fused_conv.conv3x3_bn_relu.path_launches)}}
    del program
out["foreign"] = foreign()
print(json.dumps(out))
"""


def checked(fn, what: str):
    """``fn()``; an exception from it fails the check ``what``."""
    try:
        return fn()
    except Exception as e:   # e.g. a traced tensor reaching an eager call
        check(False, f"{what}: {type(e).__name__}: {e}")


def program_counts() -> dict:
    return {**int8_counts(), "conv3x3_bn_relu_paths":
            dict(fused_conv.conv3x3_bn_relu.path_launches)}


def program_expected(net: str, dtype: torch.dtype = torch.bfloat16,
                     fused=None) -> tuple:
    """(camvid:: op nodes, ``program_counts`` of one run) of ``net``'s
    serving program: K4 per float block, SegNet's K3 pair per pool; an int8
    model (``fused``: its blocks that emit int8) the int8 block per
    quantized block, the quantize per one whose input comes float and K4
    only on the float head."""
    nb, pools = n_blocks(net), POOLS[net]
    if fused is None:
        launches = {"conv3x3_int8": 0, "quantize": 0,
                    "conv3x3_int8_paths": {"wgmma": 0, "packed": 0},
                    "conv3x3_bn_relu": nb,
                    "maxpool2x2.pool_flat": pools,
                    "maxpool2x2.unpool_flat": pools,
                    "maxpool2x2.pool_phase": 0, "maxpool2x2.unpool_phase": 0,
                    "maxpool2x2.phase_gather": 0,
                    "conv3x3_bn_relu_paths":
                        path_counts(net, 1, dtype=dtype)["fwd"]}
        nodes = {"camvid::conv3x3_bn_relu": nb}
    else:
        nq = len(int8_block_shapes(net))
        head = dict.fromkeys(fused_conv.ROUTES, 0)
        head[fused_conv.conv_path(64, 12)] = nb - nq
        launches = {**int8_expected(net, 1, fused),
                    "conv3x3_bn_relu_paths": head}
        nodes = {"camvid::conv3x3_bn_relu": nb - nq,
                 "camvid::conv3x3_int8_block": nq,
                 "camvid::quantize_int8": nq - fused}
    if pools:
        nodes |= {"camvid::max_pool_2x2_argmax": pools,
                  "camvid::max_unpool_2x2": pools}
    return nodes, launches


def export_case(label: str, p: Predictor, images: np.ndarray, tmp: str,
                want: tuple, never: Predictor = None) -> dict:
    """``p.export_program`` (seconds, MB, its op nodes: ``want[0]``, no
    library conv or pool), then ``p.predict`` after the export (bit-equal
    to the maps of ``never``, a Predictor that never exported, where
    given: it predicts after the export, so a cache that the trace filled
    reaches both), then the program loaded here on the card: one run's
    launches (``want[1]``) and maps (bit-equal to the live ones); its
    forward's ms beside the live ``_forward``'s (CUDA events)."""
    path = os.path.join(tmp, f"{label}.pt2")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    program = checked(lambda: p.export_program(path), f"{label} export")
    secs = time.perf_counter() - t0
    nodes = library.op_counts(program.graph)
    ops = {k: v for k, v in nodes.items() if k.startswith("camvid::")}
    lib = {k: nodes[k] for k in LIBRARY_NODES if nodes[k]}
    mb = os.path.getsize(path) / 1e6
    print(f"export {label}: {secs:.2f} s, {mb:.1f} MB; op nodes {ops} "
          f"(expected {want[0]}); library conv or pool nodes {lib}",
          flush=True)
    check(ops == want[0], f"{label}: the program's op nodes")
    check(not lib, f"{label}: a library conv or pool in the program")
    live = checked(lambda: p.predict(images),
                   f"{label}: the Predictor's predict after its export")
    if never is not None:
        same = np.array_equal(live, checked(
            lambda: never.predict(images),
            f"{label}: a Predictor that never exported"))
        print(f"export {label}: the exporting Predictor's maps "
              f"{'bit-equal to' if same else 'DIFFER from'} those of one "
              f"that never exported", flush=True)
        check(same, f"{label}: the maps after the export")
    x = torch.from_numpy(images).cuda()
    loaded = library.load_program(path, "cuda")
    torch.cuda.synchronize()
    reset_counts()
    maps = checked(lambda: loaded(x).cpu().numpy(),
                   f"{label}: the loaded program's run")
    counts = program_counts()
    check(counts == want[1], f"{label}: the loaded program's launches "
          f"{counts} (expected {want[1]})")
    check(np.array_equal(maps, live), f"{label}: the loaded program's "
          f"maps against the live Predictor's")
    with torch.inference_mode():
        prog_ms = cuda_ms(lambda: loaded(x), iters=10)
        live_ms = cuda_ms(lambda: p._forward(x), iters=10)
    print(f"export {label}: the program loaded on the card, one run: "
          f"launches {counts}, maps bit-equal to the live Predictor's; "
          f"forward {prog_ms:.3f} ms (live _forward {live_ms:.3f} ms) on "
          f"{bench.card()}", flush=True)
    return {"path": path, "s": secs, "mb": mb, "maps": live,
            "launches": counts, "program_ms": prog_ms, "live_ms": live_ms}


def eager_op_ms(p: Predictor, x: torch.Tensor) -> dict:
    """(g) ``p._forward(x)``'s ms with each block's K4 call as eager calls
    take it (the launcher) and through the op ``camvid::conv3x3_bn_relu``
    (``ops/conv.py``'s name patched), in turns direct, op, op, direct, 20
    forwards each (CUDA events); the op route's launches a forward."""
    direct = conv_ops.conv3x3_bn_relu
    op = torch.ops.camvid.conv3x3_bn_relu

    def via_op(x, w, a, b, relu=True, flip=False):
        return op(x, w, a, b, relu, flip)

    times = {"direct": [], "op": []}
    try:
        for route in ("direct", "op", "op", "direct"):
            conv_ops.conv3x3_bn_relu = via_op if route == "op" else direct
            times[route].append(cuda_ms(lambda: p._forward(x), iters=20))
        conv_ops.conv3x3_bn_relu = via_op
        reset_counts()
        p._forward(x)
        torch.cuda.synchronize()
        launches = fused_conv.conv3x3_bn_relu.launches
    finally:
        conv_ops.conv3x3_bn_relu = direct
    out = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"export (g): UNet b{BATCH} bf16 eager forward "
          f"{out['direct']:.3f} ms through the launchers (the route eager "
          f"calls take), {out['op']:.3f} ms through the op "
          f"({out['op'] / out['direct'] - 1:+.2%}; runs {times}); the op "
          f"route launched K4 {launches} times a forward on "
          f"{bench.card()}", flush=True)
    check(launches == n_blocks("unet"), "(g) K4 through the op")
    return {**out, "runs": times}


def dump_checks(tmp: str) -> dict:
    """The loop's program dump on the card: a full-width UNet's
    train-mode forward at run A's batch, bf16: one trace, no launch, the
    model's parameters, BN stats and counts unchanged."""
    model = bench.he_model("unet", torch.Generator().manual_seed(SEED)
                           ).cuda()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.zeros((RUN_BATCH,) + HW + (3,), dtype=torch.bfloat16,
                    device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    path = summary.dump_program(model, (x,), os.path.join(
        tmp, "program_unet_b10.txt"))
    secs = time.perf_counter() - t0
    text = open(path).read()
    nodes = text.count("torch.ops.camvid.conv3x3_bn_relu.default(")
    moved = sum(not torch.equal(v, before[k])
                for k, v in model.state_dict().items())
    launches = sum(conv_train.launches().values()) + \
        fused_conv.conv3x3_bn_relu.launches
    print(f"export (f): dump_program of UNet's train-mode forward at "
          f"b{RUN_BATCH} bf16: {secs:.2f} s, {len(text)} characters, K1's "
          f"forward op {nodes} times, {launches} launches, {moved} of "
          f"{len(before)} state tensors moved", flush=True)
    check(nodes == n_blocks("unet") and launches == 0 and moved == 0,
          "the program dump")
    return {"s": secs}


def cli_checks(tmp: str, run: dict, run_root: str) -> dict:
    """(f) ``export_program`` and ``export_torch`` through their ``main``s
    on run A's checkpoint, and run A's ``program_unet.txt`` (run A's
    working directory is ``run_root``/a)."""
    ckpt_path = run["a"]["ckpt"]
    out = os.path.join(tmp, "cli_unet.pt2")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        export_program_cli.main(["-weight", ckpt_path, "-net", "unet",
                                 "-b", str(BATCH), "-out", out])
    secs = time.perf_counter() - t0
    line = buf.getvalue().strip()
    print(f"export (f): export_program on run A's checkpoint ({secs:.1f} "
          f"s): {line}", flush=True)
    check("roundtrip verified" in line
          and "(100.00% pixel agreement)" in line,
          "export_program's roundtrip")
    pth = os.path.join(tmp, "cli_unet.pth")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        export_torch_cli.main(["-weight", ckpt_path, "-net", "unet",
                               "-out", pth])
    got = torch.load(pth, weights_only=True)
    want = ckpt.load_weights(ckpt_path, "unet")
    equal = sorted(got) == sorted(want) and all(
        torch.equal(got[k], v) for k, v in want.items())
    get_model("unet", spec=spec_from_state_dict("unet", got)
              ).load_state_dict(got, strict=True)
    print(f"export (f): {buf.getvalue().strip()}; every tensor "
          f"{'equal to' if equal else 'DIFFERS from'} the checkpoint's, "
          f"loads strictly into the port's UNet", flush=True)
    check(equal, "export_torch's state_dict")
    (program,) = glob.glob(os.path.join(run_root, "a", "runs", "*",
                                        "program_unet.txt"))
    n = open(program).read().count(
        "torch.ops.camvid.conv3x3_bn_relu.default(")
    print(f"export (f): run A wrote {os.path.relpath(program, run_root)}, "
          f"K1's forward op {n} times (run A's resume above bit-equal "
          f"with the dump in both runs)", flush=True)
    check(n == n_blocks("unet"), "run A's program dump")
    return {"cli_s": secs}


def export_checks(tmp: str) -> dict:
    """(a) and (c), as chip_faults.py runs them: the bf16 UNet Predictor,
    fresh, exported; the int8 UNet Predictor exported."""
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (BATCH,) + HW + (3,), dtype=np.uint8)
    sd = bench.he_model("unet", torch.Generator().manual_seed(SEED)
                        ).state_dict()
    out = {"images": images}
    with Predictor("unet", sd, batch_size=BATCH, image_hw=HW) as p, \
            Predictor("unet", sd, batch_size=BATCH, image_hw=HW) as q:
        out["unet_bf16"] = export_case("unet_bf16", p, images, tmp,
                                       program_expected("unet"), q)
        out["eager"] = eager_op_ms(p, torch.from_numpy(images).cuda())
    calib = rng.integers(0, 256, (INT8_FRAMES["calib"],) + HW + (3,),
                         dtype=np.uint8)
    with Predictor("unet", sd, batch_size=BATCH, image_hw=HW) as p8:
        p8.quantize_int8(calib)
        fused = sum(b.s_out is not None for b in quant.quantized_blocks(
            p8.model))
        out["unet_int8"] = export_case("unet_int8", p8, images, tmp,
                                       program_expected("unet",
                                                        fused=fused))
    torch.cuda.empty_cache()
    return out


def phase_export(tmp: str, run: dict) -> dict:
    """Phase 18 (module docstring): (a)-(d) exported, (a)-(d) loaded in a
    process without the model code, (e) (a) on the CPU, (f) the CLIs and
    the dump, (g) in (a)."""
    t0 = time.perf_counter()
    root, tmp = tmp, os.path.join(tmp, "export")
    os.makedirs(tmp, exist_ok=True)
    out = export_checks(tmp)
    images = out["images"]
    for net, label, kw in (("segnet", "segnet_bf16", {}),
                           ("unet", "unet_f32",
                            {"compute_dtype": torch.float32,
                             "batch_size": EXPORT_F32_BATCH})):
        sd = bench.he_model(net, torch.Generator().manual_seed(SEED)
                            ).state_dict()
        imgs = images[:kw.get("batch_size", BATCH)]
        with Predictor(net, sd, **{"batch_size": BATCH, "image_hw": HW,
                                   **kw}) as p:
            out[label] = export_case(label, p, imgs, tmp,
                                     program_expected(net, kw.get(
                                         "compute_dtype", torch.bfloat16)))
        torch.cuda.empty_cache()
    labels = ("unet_bf16", "segnet_bf16", "unet_int8", "unet_f32")
    jobs = []
    for label in labels:
        n = len(out[label]["maps"])
        path = os.path.join(tmp, f"images_{n}.npy")
        np.save(path, images[:n])
        jobs.append({"name": label, "path": out[label]["path"],
                     "images": path,
                     "maps": os.path.join(tmp, f"{label}_maps.npy")})
    t = time.perf_counter()
    logs = [os.path.join(tmp, f"loader.{k}") for k in ("out", "err")]
    with open(logs[0], "w") as fo, open(logs[1], "w") as fe:
        loader = subprocess.Popen(
            [sys.executable, "-c", PROGRAM_LOADER, json.dumps(jobs)],
            cwd=ROOT, stdout=fo, stderr=fe,
            env=dict(os.environ, PYTHONPATH=ROOT))
        try:
            # (e) (a)'s program on the CPU (the plain versions), while the
            # loader process runs the four on the card
            cpu = library.load_program(out["unet_bf16"]["path"], "cpu")
            with torch.inference_mode():
                cpu_maps = cpu(torch.from_numpy(images)).numpy()
            cpu_s = time.perf_counter() - t
            loader.wait(timeout=600)
        finally:
            if loader.poll() is None:
                loader.kill()
                loader.wait()
    child_s = time.perf_counter() - t
    stdout, stderr = (open(path).read() for path in logs)
    check(loader.returncode == 0, f"the loader process: {stderr[-2000:]}")
    child = json.loads(stdout.strip().splitlines()[-1])
    print(f"export (a)-(d): a process that imports ops.library only "
          f"({child_s:.1f} s, beside (e); modules of the models, the "
          f"Predictor or jax in it: {child['foreign']}) loaded the four "
          f"programs on the card", flush=True)
    check(not child["foreign"], "the loader process imported model code")
    for job in jobs:
        label, res = job["name"], child[job["name"]]
        maps = np.load(job["maps"])
        same = np.array_equal(maps, out[label]["maps"])
        print(f"export {label} in the loader process: load "
              f"{res['load_s']:.2f} s, launches {res['counts']}, maps "
              f"{'bit-equal to' if same else 'DIFFER from'} the live "
              f"Predictor's", flush=True)
        check(res["counts"] == out[label]["launches"],
              f"{label}: launches in the loader process")
        check(same, f"{label}: maps in the loader process")
        out[label]["child"] = res
    agree = float((cpu_maps == out["unet_bf16"]["maps"]).mean())
    print(f"export (e): unet_bf16's program loaded and run on the CPU "
          f"({cpu_s:.1f} s, the plain versions, while the loader process "
          f"ran): its maps agree with the "
          f"card's on {agree:.6f} of the pixels (limit {EXPORT_CPU_AGREE})",
          flush=True)
    check(agree >= EXPORT_CPU_AGREE, "(e) the program on the CPU")
    out["cpu"] = {"s": cpu_s, "agree": agree}
    out["dump"] = dump_checks(tmp)
    out["cli"] = cli_checks(tmp, run, root)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def summed_bound(n: int, piece: str, shapes) -> tuple:
    """Bound of one pass over ``shapes`` (one per block), named by what
    bounds most of it."""
    by = {}
    for s in shapes:
        t, kind = conv_bound(n, *s, piece=piece)
        by[kind] = by.get(kind, 0.0) + t
    return sum(by.values()), max(by, key=by.get)


def conv_sums(per_shape, k1) -> dict:
    """Per model, K4 over the blocks of one batch-8 forward ("k4") and
    K1's pieces over the blocks of one training step at the model's
    batch: {net: {piece: {max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by}}}, printed. Library: cuDNN's conv alone for K4 (there is no
    fused conv+BN+ReLU call), the plain version for K1's fwd (cuDNN's call
    itself), ``convolution_backward`` with the real input for dx (what
    autograd runs; the plain version, ``conv2d_input``, passes a
    zero-stride stand-in), cuDNN's bf16 wgrad for dW (the plain one is
    f32)."""
    sums = {}
    for net, n in TRAIN_BATCH.items():
        shapes = bench.block_shapes(net, HW)
        b, by = summed_bound(BATCH, "fwd", shapes)
        sums[net] = {"k4": {
            "max_abs_err": max(per_shape[s][0] for s in shapes),
            "ms": sum(per_shape[s][1] for s in shapes),
            "plain_ms": sum(per_shape[s][2] for s in shapes),
            "library_ms": sum(per_shape[s][3] for s in shapes),
            "bound_ms": b, "bound_by": by}}
        for piece in ("fwd", "dx", "wgrad"):
            on_path = [s for s in shapes if piece in k1[net][s]]
            b, by = summed_bound(n, piece, on_path)
            sums[net][piece] = {
                "max_abs_err": max(k1[net][s][piece][0] for s in on_path),
                "ms": sum(k1[net][s][piece][1] for s in on_path),
                "plain_ms": sum(k1[net][s][piece][2] for s in on_path),
                "library_ms": sum(k1[net][s]["cudnn_wgrad_ms"]
                                  if piece == "wgrad" else
                                  k1[net][s]["cudnn_dgrad_ms"]
                                  if piece == "dx" else
                                  k1[net][s][piece][2] for s in on_path),
                "bound_ms": b, "bound_by": by}
        label = {"k4": f"K4 b{BATCH}", "fwd": f"K1 fwd b{n}",
                 "dx": f"K1 dx b{n}", "wgrad": f"K1 dW b{n}"}
        print(f"{net} conv sums over its {len(shapes)} blocks: " + "; ".join(
            f"{label[p]} {t['ms']:.3f} ms (plain {t['plain_ms']:.3f}, library "
            f"{t['library_ms']:.3f}, bound {t['bound_ms']:.3f} by "
            f"{t['bound_by']}: {t['bound_ms'] / t['ms']:.2f} of it)"
            for p, t in sums[net].items()), flush=True)
    return sums


def conv_entries(unet_sums, serve, k1):
    """The JSON entries of K4 and K1's three pieces: UNet's sums, as in
    earlier runs (``conv_sums``); launches from the main paths, in all and
    on each kernel path (``serve``: UNet serving's launches; ``k1``: UNet's
    training step's (counts, per-path counts))."""
    src = "pytorch_camvid_tpu_torch/csrc/"
    counts, paths = k1
    entries = []
    for piece, name, source, replaces, launches, by_path in (
            ("k4", "conv3x3_bn_relu", "conv3x3_bn_relu.cu",
             "pytorch_camvid_tpu/ops/pallas_conv.py:230",
             serve["conv3x3_bn_relu"], serve["conv3x3_bn_relu_paths"]),
            ("fwd", "conv3x3_train.fwd", "conv3x3_bn_relu.cu",
             "pytorch_camvid_tpu/ops/pallas_conv.py:230", counts["fwd"],
             paths["fwd"]),
            ("dx", "conv3x3_train.dgrad", "conv3x3_bn_relu.cu",
             "pytorch_camvid_tpu/ops/pallas_conv.py:230", counts["dgrad"],
             paths["dgrad"]),
            ("wgrad", "conv3x3_train.wgrad", "conv3x3_wgrad.cu",
             "pytorch_camvid_tpu/ops/pallas_conv_train.py:172",
             counts["wgrad"], paths["wgrad"])):
        entries.append({"name": name, "route": "cuda",
                        "source": src + source, "replaces": replaces,
                        "launches": launches, **unet_sums[piece],
                        "path_launches": by_path})
    return entries


POOL_REPLACES = {
    "maxpool2x2.pool_flat": "pytorch_camvid_tpu/ops/pallas_pool.py:100",
    "maxpool2x2.unpool_flat": "pytorch_camvid_tpu/ops/pallas_pool.py:558",
    "maxpool2x2.pool_phase": "pytorch_camvid_tpu/ops/pallas_pool.py:400; "
                             "pytorch_camvid_tpu/ops/pallas_pool.py:177",
    "maxpool2x2.unpool_phase": "pytorch_camvid_tpu/ops/pallas_pool.py:313; "
                               "pytorch_camvid_tpu/ops/pallas_pool.py:222",
    "maxpool2x2.phase_gather": "pytorch_camvid_tpu/ops/pallas_pool.py:452; "
                               "pytorch_camvid_tpu/ops/pallas_pool.py:262",
}


def start() -> None:
    """Phases 1 and 2: the device, then the seven kernel sources built in
    parallel; TF32 off for the plain versions."""
    print(f"device: torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"{bench.card()}", flush=True)
    sources = (fused_conv.SOURCE, conv_train.WGRAD_SOURCE, fused_pool.SOURCE,
               fused_conv_pair.SOURCE, lp.SOURCE, fused_conv.F32_SOURCE,
               fused_conv_int8.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(cuda_build.build, sources))
    for path, secs, log in builds:
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln
                or "Performance" in ln]
        print(f"build: {path.name} in {secs:.1f} s; ptxas: "
              f"{' | '.join(regs)}", flush=True)
    pairs = {(cin, cout) for net in TRAIN_BATCH
             for _, _, cin, cout in bench.block_shapes(net, HW)}
    pairs |= {(cin, cout)
              for *_, cin, cout in EDGE_SHAPES + NARROW_NO_TILE}
    pairs |= set(WGRAD_NARROW_EXTRA)
    pairs |= {(cin, cout) for *_, cin, cout in odd_width_shapes()}
    pairs |= {(cout, cin) for cin, cout in pairs}   # the dx calls
    for cin, cout in sorted(pairs):
        check(fused_conv.kernel_path(cin, cout)
              == fused_conv.conv_path(cin, cout)
              and conv_train.wgrad_kernel_path(cin, cout)
              == conv_train.wgrad_path(cin, cout),
              f"kernel path rule of the libraries at {cin}->{cout}")
    print(f"paths: the libraries and the wrappers choose alike at "
          f"{len(pairs)} (Cin, Cout) pairs", flush=True)
    # the narrow path's plan (N tile, channel tiles, patch stages, shared
    # memory; zeros where no tile fits and ``mma_sync`` takes the call)
    plans = sorted({pr for pr in pairs if fused_conv.conv_path(*pr)
                    == "narrow"} | {(c, 12) for c in range(1, 420, 7)}
                   | {(36, c) for c in range(1, 420, 11)})
    for cin, cout in plans:
        p = fused_conv.narrow_fwd_plan(cin, cout)
        want = (p["bn"], p["tiles_n"], p["stages"], p["bytes"]) if p \
            else (0, 0, 0, 0)
        check(fused_conv.kernel_narrow_plan(cin, cout) == want,
              f"the narrow plan of the library at {cin}->{cout}")
    print(f"narrow: the library's and the wrapper's plans agree at "
          f"{len(plans)} (Cin, Cout) pairs", flush=True)
    # the narrow dW's plan (M side, m64 tiles a warpgroup, N tile, N and M
    # channel tiles, pixel rows, runs, stages, shared memory), with both
    # sides wide enough for M tiles and runs
    dw_plans = sorted({pr for pr in pairs if conv_train.wgrad_path(*pr)
                       == "narrow"} | set(WGRAD_NARROW_EXTRA)
                      | {(c, 36) for c in range(1, 400, 7)}
                      | {(36, c) for c in range(1, 400, 9)}
                      | {(c, c + 3) for c in range(61, 700, 17)})
    for cin, cout in dw_plans:
        check(conv_train.wgrad_kernel_narrow_plan(cin, cout)
              == conv_train.narrow_plan_key(
                  conv_train.wgrad_narrow_plan(cin, cout)),
              f"the narrow dW plan of the library at {cin}->{cout}")
    print(f"narrow dW: the library's and the wrapper's plans agree at "
          f"{len(dw_plans)} (Cin, Cout) pairs", flush=True)
    int8_cins = sorted({cin for _, _, cin, _ in all_block_shapes()}
                       | {cin for *_, cin, _ in INT8_EDGE + INT8_VIEW
                          + INT8_CIN48 + INT8_ODD}
                       | set(range(-1, 150)) | {288, 576})
    for cin in int8_cins:
        check(fused_conv_int8.kernel_path(cin)
              == fused_conv_int8.int8_path(cin)
              and fused_conv_int8.kernel_pixel_stride(cin)
              == fused_conv_int8.pixel_stride(cin)
              and (fused_conv_int8.int8_path(cin) != "packed"
                   or fused_conv_int8.kernel_packed_k(cin)
                   == fused_conv_int8.packed_k(cin)),
              f"int8 path rule, pixel stride and packed K of the library "
              f"at Cin {cin}")
    print(f"int8: the library's and the wrapper's path, pixel stride and "
          f"packed K rules agree at {len(int8_cins)} Cin",
          flush=True)
    f32 = fused_conv.f32_library()
    f32_pairs = sorted(pairs | {(cin, cout) for *_, cin, cout in F32_EDGE}
                       | {(cout, cin) for *_, cin, cout in F32_EDGE})
    for cin, cout in f32_pairs:
        check(fused_conv.f32_kernel_route(cin, cout)
              == fused_conv.f32_route(cin, cout)
              and fused_conv.f32_kernel_route(cin, cout, wgrad=True)
              == conv_train.wgrad_f32_route(cin, cout)
              and f32.conv3x3_f32_tile_n(cout) == fused_conv.f32_tile_n(cout)
              and f32.conv3x3_wgrad_f32_out_tiles(cin, cout)
              == conv_train.wgrad_f32_out_tiles(cin, cout),
              f"f32 routes, tile N and dW output tiles of the library at "
              f"{cin}->{cout}")
    sizes = {(n, h, w) for h, w, _, _ in all_block_shapes()
             for n in (F32_CHECK_BATCH, F32_TIME_BATCH)}
    sizes |= {(n, h, w) for n, h, w, *_ in F32_EDGE + (F32_VIEW,)}
    for n, h, w in sorted(sizes):
        for cin, cout in f32_pairs:
            check(f32.conv3x3_wgrad_f32_pixel_tiles(n, h, w, cin, cout)
                  == conv_train.wgrad_f32_pixel_tiles(n, h, w, cin, cout),
                  f"f32 dW pixel tiles of the library at {n}x{h}x{w} "
                  f"{cin}->{cout}")
    print(f"f32: the library's and the wrappers' routes, tile N and dW "
          f"tile counts agree at {len(f32_pairs)} (Cin, Cout) pairs and "
          f"{len(sizes)} sizes", flush=True)
    couts = range(4, fused_conv_pair.MAX_COUT + 1, 4)
    for cout in couts:
        check(f32.conv3x3_pair_f32_smem(cout) == fused_conv_pair.tile_plan(
            fused_conv_pair.MAX_CIN, torch.float32, cout)["bytes"],
              f"K5 f32's shared-memory plan of the library at Cout {cout}")
    print(f"K5 f32: the library's and the wrapper's shared-memory plans "
          f"agree at {len(couts)} Cout", flush=True)
    for net in TRAIN_BATCH:
        shapes = bench.block_shapes(net, HW)
        rule = conv_train.step_path_launches(shapes)
        check(rule == PATH_TABLE[net],
              f"{net} launches per path of a step by the rules: {rule}")
        check(conv_train.step_path_launches(shapes, torch.float32)
              == path_table(net, dtype=torch.float32),
              f"{net} f32 launches per path of a step by the rules")
    torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    start()
    per_shape = phase_kernels(
        torch.Generator(device="cuda").manual_seed(SEED))
    k1 = phase_k1(torch.Generator(device="cuda").manual_seed(SEED))
    sums = conv_sums(per_shape, k1)
    narrow_checks(torch.Generator(device="cuda").manual_seed(SEED))
    narrow = narrow_timings(torch.Generator(device="cuda").manual_seed(SEED))
    unet_serve = phase_slice("unet", torch.Generator().manual_seed(SEED),
                             np.random.default_rng(SEED))
    unet_train = phase_train("unet", torch.Generator().manual_seed(SEED))
    odd_train = odd_width_train(torch.Generator().manual_seed(SEED))
    pools = phase_pools(torch.Generator(device="cuda").manual_seed(SEED))
    seg_serve = phase_slice("segnet", torch.Generator().manual_seed(SEED),
                            np.random.default_rng(SEED))
    seg_train = phase_train("segnet", torch.Generator().manual_seed(SEED))
    segnet_small_checks(torch.Generator().manual_seed(SEED))
    pair = pair_checks(torch.Generator(device="cuda").manual_seed(SEED),
                       timed=True)[(PAIR_BATCH,) + PAIR_SHAPES[0]]
    pair_launches = phase_pair_probe()
    pair_f32 = pair_f32_checks(
        torch.Generator(device="cuda").manual_seed(SEED), timed=True)
    pair_f32_launches = phase_pair_f32_probe()["launches"]
    probe_entries = phase_probes(
        torch.Generator(device="cuda").manual_seed(SEED))
    with tempfile.TemporaryDirectory() as tmp:
        run = phase_training_run(tmp)
        head = phase_data_side(tmp, run)
        f32 = phase_f32(tmp, run["data"])
        remat = phase_remat(tmp, run["data"], f32["unet_raw"])
        t16 = time.perf_counter()
        int8 = phase_int8(tmp, run)
        print(f"phase 16: {time.perf_counter() - t16:.1f} s", flush=True)
        dp = phase_multi_gpu(tmp, run["data"])
        export = phase_export(tmp, run)
    check("jax" not in sys.modules, "jax was imported")

    kernels = conv_entries(sums["unet"], unet_serve, unet_train)
    # each loaded program's launches in the loader process (phase 18)
    ran = {label: export[label]["child"]["counts"] for label in
           ("unet_bf16", "segnet_bf16", "unet_int8", "unet_f32")}
    kernels[0]["program_launches"] = {
        label: ran[label]["conv3x3_bn_relu"]
        for label in ("unet_bf16", "segnet_bf16", "unet_int8")}
    # the narrow path at UNet 9/16's blocks (phase 3), with the narrow
    # launches counted in its b8 bf16 serving forward (phase 16) and its
    # training step's dx (phase 6), and its training step's launches per
    # path
    kernels[0]["narrow_unet_9_16"] = {
        **narrow["fwd"], "launches": int8["odd_slices"]["unet"][
            "k4_paths_bf16"]["narrow"]}
    kernels[2]["narrow_unet_9_16"] = {
        **narrow["dx"],
        "launches": odd_train["path_launches"]["dgrad"]["narrow"]}
    # the narrow dW at UNet 9/16's seven dW (phase 3), with the narrow dW
    # launches of its training step (phase 6) and its step's ms
    kernels[3]["narrow_unet_9_16"] = {
        **narrow["wgrad"],
        "launches": odd_train["path_launches"]["wgrad"]["narrow"],
        "step_ms": odd_train["step_ms"]}
    for entry, piece, key in zip(kernels[1:], ("fwd", "dx", "wgrad"),
                                 ("fwd", "dgrad", "wgrad")):
        entry["unet_9_16_step_path_launches"] = odd_train[
            "path_launches"][key]
        entry["head_64_21"] = head[piece]
        entry["remat_path_launches"] = remat["paths"][key]
        entry["dp_rank_launches"] = {
            net: [c[key] for c in dp["a"][net]["launches"]]
            for net in ("unet", "segnet")}
    for name, t in pools.items():
        launches = (seg_serve if name.endswith("flat")
                    else seg_train[0])[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pytorch_camvid_tpu_torch/csrc/maxpool2x2.cu",
            "replaces": POOL_REPLACES[name], "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"]})
        if name in int8["pools"]["int8"]:
            # phase 16's device-busy sums over the five b8 pools: int8,
            # and bf16 at the same shapes
            kernels[-1]["int8"] = {**int8["pools"]["int8"][name],
                                   "max_abs_err": 0.0, "launches":
                                   int8["slices"]["segnet"]["launches"][name]}
            kernels[-1]["device_busy"] = int8["pools"]["bf16"][name]
            kernels[-1]["program_launches"] = {
                "segnet_bf16": ran["segnet_bf16"][name]}
    kernels.append({
        "name": "conv3x3_pair_bn_relu", "route": "cuda",
        "source": "pytorch_camvid_tpu_torch/csrc/conv3x3_pair_bn_relu.cu",
        "replaces": "pytorch_camvid_tpu/ops/pallas_conv_pair.py:229",
        "launches": pair_launches, "max_abs_err": pair["err"],
        "ms": pair["ms"], "plain_ms": pair["plain_ms"],
        "bound_ms": pair["bound_ms"], "bound_by": pair["bound_by"],
        "library_ms": pair["library_ms"]})
    kernels.append(pair_f32_entry(pair_f32, pair_f32_launches))
    kernels += probe_entries
    kernels += f32_entries(f32)
    kernels += int8_entries(int8)
    by_name = {k["name"]: k for k in kernels}
    by_name["conv3x3_bn_relu_f32"]["program_launches"] = {
        "unet_f32": ran["unet_f32"]["conv3x3_bn_relu"]}
    for name, key in (("conv3x3_int8", "conv3x3_int8"),
                      ("conv3x3_int8.quantize", "quantize")):
        by_name[name]["program_launches"] = {
            "unet_int8": ran["unet_int8"][key]}
    check(len(by_name) == len(kernels) == 23,
          "one JSON entry per ported kernel")
    print(json.dumps({"kernels": kernels}))
    print(bench.card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
