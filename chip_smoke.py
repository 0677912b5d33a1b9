#!/usr/bin/env python3
"""Smoke test of the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels conv2d,matmul_bwd   (phases 1-3 only)
    python3 chip_smoke.py --phases presets,bf16_engines   (phases 1, 2, 11, 12)

Phases, each printing one JSON line:
  1. environment: torch, CUDA and nvcc versions, the card's name and power
     limit (as nvidia-smi prints them);
  2. build: nvcc compiles resnet_tpu_torch/kernels/csrc into a library;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     ResNet-50 serving and training shapes, TF32 off, within 1e-4 of
     max|plain| (the fused conv's halo case bit for bit; the split-K GEMMs
     of the conv forward, dx and dW, the fused conv and the whole-block
     kernel, the FC backward and the BN statistics and backward run twice
     and held to the same bits), with its time, the plain version's, a library call's
     where one computes the same function, the device time of the kernel
     and of the library call (torch.profiler, with its split by kernel
     name), the host time per call (host_us: 200 calls enqueued back to
     back, checks.host_us), the least time the card could take, and for the
     conv forward, the whole-block kernel, the FC backward (fp32 and bf16),
     K1's bf16 forward and dW and K8-bf16 the launch plan (tiles and K
     splits; da and db blocks; the bf16 forward's A loader, K chunk, units
     and persistent blocks; dW's route, its 64-pixel box and slices); then the
     whole-block kernel's weight split (split_tf32) at
     the shapes of K10's twelve weights, bit for bit against its plain
     version;
  4. serving: a seeded ResNet-50 (random weights, non-trivial BN running
     statistics) is exported, saved (a torch.export artifact), loaded by
     resnet_tpu_torch.serve and
     asked for batches of 1, 3 and 8 over HTTP; the launch counters must
     show 53 conv, 16 add_relu and 1 matmul launches per forward, and the
     logits must match the plain path (cuDNN/cuBLAS, TF32 off) within 1e-3
     of max|logits|; then the batch-8 forward is timed on both paths;
  5. train: the reference "resnet" variant (ResNet-50, 224^2, batch 32, Adam
     lr 1e-4) with every hand kernel on (conv, BN statistics, join, FC,
     fused Adam): 5 steps on one synthetic batch, the counters read after
     each step (53 conv, 52 dx, 53 dW, 53 moments, 16 add_relu, 16 masks,
     1 + 1 matmul, 1 adam), the loss after the last update below the first;
     then one step from the same state on the kernel path and on the plain
     path (cuDNN/cuBLAS and torch ops, per-tensor Adam) compared leaf by
     leaf, once with batch statistics and once with BN frozen at the initial
     running statistics (the well-conditioned check, Adam's updates also
     element by element); step times of both paths in turns (plain, kernel,
     kernel, plain) with host_step_ms (the host clock from a step's start
     to train_step's return, before the synchronize, the median per path
     over the timed steps; likewise in phases 6 and 7), peak memory, and a
     torch.profiler breakdown of one kernel-path step;
  6. fused train: the same variant under the fused engine
     (kernels='fused', fused Adam): 5 steps on the batch, the counters read
     after each (52 fused_conv, 16 fused_join, 1 bias_act, 1 moments,
     1 adam, and nothing else), the loss after the last update below the
     first; one step from one state against the plain standard path
     (kernels='xla', per-tensor Adam): summed loss, training-forward logits,
     every layer's batch mean and var, the running statistics and every
     gradient leaf (the rule of phase 5). The fused engine normalizes with
     the batch's statistics only (bn_mode='batch'), so phase 5's frozen-BN
     tight check has no counterpart here. Then one step each of 'hybrid'
     (16 fused_join, 1 bias_act, 1 moments, 1 adam: every conv site on the
     torch-ops chain) and 'fusedxla' (1 adam: no hand kernel but Adam), each
     loss within 1e-4 of the plain path's; step times in turns (plain,
     fusedxla, fused, fused, fusedxla, plain), peak memory of one step of
     each, and a torch.profiler breakdown of one fused step;
  7. blockfused train: the same variant under the whole-block engine
     (kernels='blockfused', fused Adam): 5 steps on the batch, the counters
     read after each (12 block_fused, one per stride-1 identity block, and
     1 adam, nothing else: the stem, the 4 projection blocks and the FC are
     plain), the loss after the last update below the first; one step
     against the plain standard path by the rules of phase 6; one step with
     conv_kernels='pallas' (12 block_fused, 17 conv2d, 16 conv2d_dx, 17
     conv2d_dw, 1 adam), its loss within 1e-4 of the plain path's; step
     times in turns (plain, blockfused, fused, fused, blockfused, plain),
     peak memory of one step of each, a torch.profiler breakdown of one
     blockfused step;
  8. batch_norm_act: the public BN(+ReLU) entry point of the kernels package
     (no model path calls it), forward and backward at the stem's shape with
     and without ReLU: 1 moments, 1 bias_act (the apply) and 1 bn_bwd launch
     per call, its outputs and gradients within 1e-4 of the plain torch ops;
  9. remat train: the reference "clean" variant (ResNet-50, 224^2, batch
     224, Adam lr 1e-4, kernels='pallas', remat='block') with
     conv_kernels='pallas' and fused Adam: 5 steps on one synthetic batch,
     the counters read after each (105 conv: 53 and the 52 the backward
     reruns, 52 dx, 53 dW, 105 moments, 32 add_relu, 16 masks, 1 + 1
     matmul, 1 adam), the loss after the last update below the first; then
     from one state one step each of remat 'block', 'stage' (the same
     counts) and 'elementwise' (the standard step's counts but 32 add_relu:
     the joins rerun, the convs and statistics are kept) against the
     'none' step: counters, summed loss and batch and running statistics
     within 1e-6 of max|.|, every gradient leaf within 1e-5 of its max
     (the count of leaves equal bit for bit printed), parameters within
     2 lr + 1e-6, the step's peak memory below the 'none' step's; the same
     for kernels='blockfused' under block remat (24 block_fused, 1 adam)
     and for the "lowmem" variant (plain path, block remat) at its batch of
     192, whose cuDNN backward adds in no fixed order: there a gradient
     leaf passes within 1e-5 of its max or within 4 times the no-remat
     path's own change between two runs; one ghost-BN step at batch 32 (bn_stats_batch=16: no K4 launch)
     and ghost BN's closed-form VJP against autograd of the sliced moments
     within 1e-5 of max at the stem's and stage 1's shapes; step times of
     'none' and 'block' in turns (none, block, block, none) with
     host_step_ms, peak memory and device busy time of one step each;
 10. trainer: the port's trainer from disk. 3 shards of 64 procedural 224^2
     images (ProceduralDataset, 100 classes, seed 1234) written NCHW with
     write_shard; the in-process Trainer on the "resnet" variant with
     conv_kernels='pallas', fused Adam, async dumps every 2 steps and the
     finite check: 6 steps through the prefetcher, the counters read after
     each (the standard step's counts), the prefetch queue's depth, the step
     times (host clock ending in a synchronize), its async dump at step 4
     against a sync run's within 1e-5 of max per leaf, a dump's snapshot
     timed alone, and a Trainer with no dumps and no finite check: run(8)
     against 8 bare train_steps on a staged batch, in turns; then the CLI
     (python -m resnet_tpu_torch.train.cli, batch 32, every hand kernel,
     dumps every 4 steps), each run a subprocess that fails if JAX was
     imported: an uninterrupted run U of 24 steps (4 epochs; dumps 0-20 and
     77777777, 24 metrics lines, the final cursor as its loader reports it,
     the loss on step 0's batch after the last update below the first), a
     run K with async dumps killed by SIGKILL once a dump >= 4 is
     published, K resumed from its latest dump to step 24 (R: its final
     dump against U's, each leaf within 1e-5 of max, the bit-equal leaves
     counted, the checkpoint fields equal, its losses within 1e-5 relative),
     --evaluate on U's latest dump (a finite eval line) and --export (the
     artifact's logits on one shard batch within 1e-3 of max|logits| of the
     eval forward on the restored state); U beside K, then R beside eval
     and export, with the wall time of each.
 11. presets: at full width (ResNet-50, 224^2, one SyntheticDataset batch at
     seed 1234): the "resnet" variant in bf16 with every standard-path hand
     kernel (conv_kernels='pallas', fused Adam) at batch 32: 5 steps, the
     counters read after each (53 conv, 52 dx, 53 dW, 53 moments, 16 + 16
     join, 1 + 1 matmul, all on the bf16 entry points, and 1 adam; no fp32
     counter moves), the loss after the last update below the first, the
     parameters fp32; one step from one state held to the plain bf16 step
     (cuDNN bf16): the loss and the running statistics within 2x that step's
     own gap to the plain fp32 step (max|bf16 - fp32| over max|bf16|, the
     largest over the leaves of each), each gradient leaf within 2x its own
     gap, that gap at least 2^-8 (bf16's unit roundoff), or GRAD_SENS x the
     plain bf16 step's change under a 1 +- 2^-8 image scaling; the three
     steps' gradients again with BN frozen at the initial running statistics,
     by the same rule (with batch statistics bf16's rounding alone moves half
     the leaves by more than their max, so that step checks little; the
     frozen step is the tight one). Then "fast" at 192 (the plain path in
     bf16, cap 10, TF32 allowed: no hand kernel moves) and "nchw" at 192
     (NCHW cuDNN): 5 steps each, the loss falling, step ms (median of 5),
     host ms and peak GiB; one nchw step held to the NHWC plain step on the
     transposed images: loss and statistics within 1e-4, gradients within
     1e-5 of max or GRAD_SENS x the larger of the NHWC step's own run-to-run
     change (cuDNN's backward adds in no fixed order) and its change under
     the 1 +- 2^-20 image scaling (cuDNN takes other algorithms for NCHW: 4x
     the run-to-run change alone holds none of the 160 leaves on the H100);
     then the witness that this gap is the order of sums and not the layout:
     both steps again with cuDNN off, both layouts convolving by PyTorch's
     own im2col and GEMM on the same NCHW values, each gradient leaf within
     phase 5's rule, and with BN frozen at the initial running statistics,
     within 1e-5 of its max. Then NCHW on the hand kernels at 32: 5 steps
     with the standard counts but 0 moments (K4 is NHWC-only, as in JAX),
     held to the NHWC kernel step (loss and statistics within 1e-4, gradients
     by phase 5's rule: the statistics differ, K4's sums against the plain
     ones; parameters within 2 lr + 1e-6). Last, the served forward at batch
     8 from bf16 weights (export_inference(..., weights_dtype='bfloat16')) on
     the bf16 hand kernels, NHWC and NCHW (53 conv, 16 join, 1 matmul on the
     bf16 entries each): fp32 logits within 2x the plain bf16 path's own gap
     to the plain fp32 logits, each forward then timed as phase 4 times its
     batch 8 (batch8_ms, batch8_device_ms). The bf16 kernel step is also profiled
     (torch.profiler, one step), with the device time and busy share of
     K1's bf16 dW, forward and dx and of the K8/K10 bf16 GEMM kernels
     (``profile_split``).
 12. bf16 engines: the fused and whole-block engines in bf16 at full width
     (ResNet-50, 224^2, batch 32, lr 1e-4, fused Adam): 'fused', 'hybrid',
     'fusedxla' and 'blockfused' with bf16 compute and fp32 parameters,
     'fused' and 'blockfused' with bf16 parameters too, and 'blockfused'
     with conv_kernels='pallas': 5 steps each, the counters read after
     each (fused 52 fused_conv, 16 fused_join, 1 bias_act, 1 moments;
     hybrid 16 / 1 / 1; blockfused 12 block_fused, with conv_kernels='pallas'
     also 17 conv2d, 16 conv2d_dx, 17 conv2d_dw; all on the bf16 entries;
     fusedxla none; 1 adam each), the loss after the last update below the
     first, the parameters' dtype kept; one step from the same state held
     to the plain bf16 standard step (kernels='xla', per-tensor Adam, the
     same parameter dtype): the loss and the running statistics within 2x
     their pooled gap to the plain fp32-compute step, each gradient leaf by
     phase 11's batch-statistics rule (2x its own gap, at least 2^-8, or 4x
     its change under a 1 +- 2^-8 image scaling); batch_norm_act on bf16
     (1 moments, 1 bias_act, 1 bn_bwd on the bf16 entries; y and dx within
     one bf16 ulp + 1e-5 of max of the plain versions, the fp32 statistics,
     dgamma and dbeta within 1e-5); step times in turns of the bf16
     standard step on its hand kernels and each engine's bf16 and fp32
     steps, their peak memory, and a torch.profiler table of one fused and
     one blockfused bf16 step, each with phase 11's split of its busy time
     by bf16 GEMM kernel, and the blockfused step's K10-bf16 by part (its
     GEMMs with their split sums, its rows kernels, its join; K10_PARTS),
     the fused step's K9-bf16 join; last, from one state, the output hashes
     of the 12 K10 calls of one blockfused bf16 step and of the 16 K9 calls
     of one fused bf16 step, so that two trees run in turns are held to the
     same bits there too. Each run also prints a ``bf16_engine_run`` line,
     so a failing run still shows the runs before it.
 13. int8 serve: the W8A8 serving path (resnet_tpu_torch.quantize,
     export_quantized_inference) on ResNet-50 at 224 with phase 4's seeded
     weights and running statistics, calibrated on one seeded batch of 8 at
     pixel scale, saved, loaded by resnet_tpu_torch.serve and asked for
     batches of 1, 3 and 8 over HTTP: each request moves the counters by
     exactly 54 qconv (Q1) and 54 quant_act (Q2) launches and no other; the
     served logits at each request's bucket equal the plain int8 forward on
     the card (the kernels' plain versions on the same qparams and scales)
     bit for bit. Printed: the Pearson correlation and top-1 agreement with
     the fp32 folded forward, the int8 and the bf16 hand-kernel served
     forwards at batches 8 and 128 in turns, and the device time of one
     batch-128 int8 forward split into Q1, Q3 (none here), Q2 and the rest.
 14. configs: what JAX runs that the phases above do not, at full width.
     ResNeXt-50 32x4d at 224, batch 32, on the hand kernels (its 16
     grouped 3x3s on the plain conv, as JAX sends them to XLA): 5 fp32
     steps with the counters read after each (37 conv, 36 dx, 37 dW, 53
     moments, 16 + 16 join, 1 + 1 matmul, 1 adam), one held to the plain
     step by phase 6's rule and the frozen-BN gradients by phase 5's; 5
     bf16 steps (the same counts on the bf16 entries), one held to the plain
     bf16 step by phase 11's rule. ResNeXt-50 served in int8 over HTTP as
     phase 13 serves ResNet-50: each request exactly 38 Q1, 16 Q3 (the
     grouped int8 conv) and 54 Q2, the logits the plain int8 forward's bit
     for bit, the Pearson correlation with the fp32 folded forward; at
     batch 128 the int8 and the bf16 hand-kernel forwards in turns and one
     int8 forward's device time split into Q1, Q3, Q2 and the rest. ResNet-50
     at JAX's headline configuration (BENCH_r05.json: batch 256, bf16, the
     standard topology, grad_accum 2, space_to_depth) on the hand kernels: 5
     steps with the counters read after each (two microbatches, the folded
     stem on the plain conv: 104 conv, 104 dx, 104 dW, 106 moments, 32 + 32
     join, 2 + 2 matmul on the bf16 entries, 1 adam), one held to the plain
     s2d step by phase 11's rule; an fp32 s2d stem against the 7x7 stem at
     that batch within JAX's tolerances for the two (outputs rtol 1e-4,
     gradients 1e-3). Each path's steps timed (median of 5).
 15. artifact: three self-contained serving artifacts. Phase 4's seeded
     ResNet-50 at 224 under kernels='pallas', conv_kernels='pallas' (fp32),
     phase 13's int8 ResNet-50 and phase 14's int8 ResNeXt-50 32x4d, each
     exported by export.save_inference (a torch.export program over a
     symbolic batch that calls the hand kernels as the resnet_tpu_torch::
     custom ops), then loaded by resnet_tpu_torch.serve in a fresh process
     in which resnet_tpu_torch.models, .quantize and .train cannot be
     imported, and asked for batches of 1, 3 and 8 over HTTP: each request
     moves that process's counters as the eager model's forward moves them
     here (53 K1, 16 K2, 1 K3; 54 Q1, 54 Q2; 38 Q1, 16 Q3, 54 Q2); the
     served logits equal the eager model's bit for bit in int8 and lie
     within 1e-3 of max|logits| in fp32 (the bit equality printed); the
     export's seconds, the file's bytes and the server's start printed.
 16. converge: python -m resnet_tpu_torch.tools.convergence in this process
     on the hand kernels (kernels='pallas', conv_kernels='pallas', bf16)
     with CONVERGE_ARGS (resnet18 on the procedural classes at 32^2, batch
     32, lr 0.02, warmup 50, 1600 steps, a resume halfway): the resume exact, the
     training loss finite and falling, fp top-1 at least CONVERGE_TOP1, and
     Q1 and Q2 launched by its int8 evaluation; fp and int8 top-1 printed.
 17. parallel: data parallelism (resnet_tpu_torch.parallel) on the "resnet"
     variant at full width (ResNet-50, 224^2, conv_kernels='pallas', fused
     Adam): two ranks of tools.distributed_worker share this card under
     gloo, 16 images each, global batch 32 (phase 5's synthetic batch and
     seeded state). 'auto' (BN statistics of the global batch, K4 in its
     raw-sums mode): each rank's step moves its counters by exactly phase
     5's counts; against this process's one-process step at 32 by phase 5's
     rule (loss and batch statistics within 1e-4, each gradient leaf within
     1e-3 of its max or 4x its change under the 1 +- 2^-20 image nudge): the
     summed gradient of a forward and backward beside the step, and the
     counted step's own Adam moments (after one step from zero, (1 - b1)
     times the gradient the step reduced), loss, running statistics and
     parameters (within 2 lr + 1e-6); the same with BN frozen at the initial
     running statistics (the tight one: at most 1% of the Adam updates off
     by lr / 100); 'shard_map' (local BN) against the sum of the
     one-process gradients of each rank's 16 images, by the same rule, the
     step's moments too, its running statistics the mean of the two halves'
     merges within 1e-4; ZeRO (parameters and Adam moments sharded, fused
     Adam on the shards) against the replicated step bit for bit, each
     rank's persistent state bytes beside the replicated state's; the
     engines whose statistics come from their own kernels ('fused',
     'hybrid', 'fusedxla', 'blockfused', fp32 and bf16) and ghost BN (k = 8,
     inside rank 0's rows, and k = 24, across both) under 'auto', the
     statistics summed over the ranks (``_engine_checks``): each rank's
     counts the engine's (K10 on its stage entries, four a block), the
     ranks' statistics equal bit for bit, the side path against the
     one-process step of the same engine at 32 by phase 5's rule (bf16 by
     phase 11's 2x gap to the engine's fp32 step); the composite step on
     four ranks (a 2 x 2 grid, the FC split in two: K3 on (16, 2048) @
     (2048, 500)) against the one-process step (``_composite_checks``); the
     data x spatial steps (A13's item 3: each image's height split over the
     spatial ranks, halo rows exchanged at the seams, K1 on each rank's
     haloed tile with JAX's explicit padding) on a 1 x 2 grid in the two
     ranks' start and a 2 x 2 grid in the four ranks' start, at the global
     batch of 32, on ResNet-50 at 224 and full width cut to one block a
     stage (``SPATIAL_DEPTH``; since PR 27, for the script's time): the
     'pallas' path with conv_kernels='pallas' in fp32 and
     bf16 and the plain path in fp32, each rank's counts phase 5's (on the
     bf16 entries in bf16; Adam alone on the plain path), and (A13b) the
     fused engines ('fused' in fp32 and bf16, 'hybrid' and 'fusedxla' in
     fp32: K8 on the haloed tile of each site's raw input, K4, K5 at the
     stem and K9 on the rank's rows; each rank's counts the engine's) and
     the s2d stem on the 'pallas' path in bf16 (the fold and its 4x4/s1 conv
     on the rank's rows: 52 conv, 52 dx, 52 dW, 53 moments, 16 + 16 join,
     1 + 1 matmul, 1 adam), the ranks' metrics and statistics equal, each
     held to the one-process step of its config by phase 5's rule, bf16 by
     phase 11's (``_spatial_checks``); NCCL
     in a world of one in this process: the data-parallel step equal to the step
     without a group bit for bit, and both timed in turns; where the machine
     has two cards or more, ``parallel_nccl`` (also run alone by --phases
     parallel_nccl): one NCCL rank a card (at most 4) at the global batch of
     32, 'auto' and frozen BN against the one-process step as above, each
     rank's counts phase 5's, ZeRO the replicated step's bits, 'fused' and
     'blockfused' in fp32 and bf16, the composite step on a 2 x (cards /
     2) grid and the spatial 'pallas' and 'fused' fp32 steps on 1 x cards
     and 2 x (cards / 2) grids held as above, the step times of all of them, of 'shard_map'
     (no statistics' sums) and of one card at 32 and at a rank's rows, then the CLI under torchrun on those cards
     (NCCL, synthetic batches, 2 steps), its first loss that of one process;
     the Trainer from 2 shards of 64 procedural images, a dump every 2
     steps: an uninterrupted run U of 4 steps, the CLI as a user starts it
     (``python -m torch.distributed.run --nproc-per-node 2 -m
     resnet_tpu_torch.train.cli ... --dist-backend gloo``), one metrics line
     a step; a run K of the worker's Trainer on the config the CLI builds
     from U's flags, killed by SIGKILL after 3, K resumed from its latest
     dump to step 4 (R): R's final dump against U's by phase 10's rule (so R
     read U's rows on each rank), the ranks' rows differing. Step times of
     the one-process step at 32 and of each two-rank layout: two ranks on
     one card, each all-reduce through host memory (gloo), so they are no
     scaling figure.
Phase 3 includes the clean variant's batch-224 shapes of K1 (the stem's
forward, dx and dW), K2, K2b and K4 (the stem and stage 1), K1's tiles
under spatial partitioning in fp32 and bf16, forward, dx and dW
(``kernels.checks.TILE_CASES``: ResNet-50's at 224 on 2 and 4 ranks, JAX's
explicit padding; the kernels line sums them apart as ``tiles``), and the bf16
entry points' cases (``<name>_bf16`` in kernels.checks.KERNELS: ResNet-50's
batch-8 serving and batch-32 training shapes, the stem, a 3x3/s2
projection, a 1x1 expand, the four joins and the FC among them; for K5,
K6, K8, K9 and K10 the engines' batch-32 shapes: the 23 distinct shapes of
the 52 fused-conv sites, the four joins, the stem's BN apply and the four
shapes of the 12 identity blocks), each bf16 element within one bf16 ulp
of the plain value plus 1e-5 of max|plain|, the fp32 results (K4's
statistics, K8's and K10's sums, K10's rows, K6's dgamma and dbeta)
within 1e-5 of max, the GEMMs, K4, K6, K8 and K10 twice to the same bits,
K8's halo case bit for bit; every bf16 case line and each case of the
fp32 join, K10, K4, K5 and K6 with ``out_hash``, a digest of the kernel's
outputs' bits, so that two trees run in turns are held to the same bits by
their lines; K10 in bf16 stage by stage, each stage's plain
version on the kernel's own inputs to it (an intermediate one bf16 ulp
apart moves the next stage by that ulp times the following BN's scale).
Phase 3 also holds Q3 bit for bit to its plain version at every distinct
grouped site of both ResNeXt presets at batch 8 and ResNeXt-50's at 128, a
capped site and a ragged one (no yardstick: no one PyTorch call computes a
grouped int8 conv), each line with Q3's plan and layout (build.q3_plan,
build.q3_geometry), and the other int8 kernels bit for bit to their plain
versions (max_abs_err 0): Q1 at every distinct conv shape of ResNet-50 at batch 8
with its site's epilogue, the FC with fp32 logits, a capped site, a 1x1/s2
projection, a ragged one (Cin 3, Cout 33) and, reported apart, stage 4's
3x3 at batch 1, twice to the same bits, each line with Q1's launch plan
(tile, slices, K splits, units, persistent blocks, A loader); Q2 on the
images, bf16 activations, the pooled features, an odd misaligned size and
exact .5 ties; their bound at 1,979 TOP/s int8, Q1's yardstick
torch._int_mm (the integer product alone) on every case it takes (M > 16,
N a multiple of 8; an im2col of x made outside the timed call, K padded
to a multiple of 8).
Then a JSON line of the kernels (launches: the counts of the main paths of
phases 4 to 17 together, every kernel launched on at least one of them; ms,
host_us, plain_ms, bound_ms, library_ms and the device times summed over
each kernel's phase-3 cases; where the yardstick takes only some cases,
``library_covered`` sums those; Q1's ``apart`` and ``rest`` sum its batch-1
case and the others),
the nvidia-smi line, and the final line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no final
line. It needs a CUDA device and the resnet_tpu_torch package beside it; it
never falls back to the CPU and imports nothing of JAX.

With --kernels NAMES (comma-separated names of kernels.checks.KERNELS) it
runs phases 1-3 for those kernels only, without the launch plans and the
weight split, and prints no final line: copied with kernels/checks.py into another tree of
the package, it times that tree's kernels on this tree's cases. With
--phases NAMES (serve, train, fused_train, blockfused_train,
batch_norm_act, remat_train, trainer, presets, bf16_engines, int8_serve,
configs, artifact, converge, parallel; parallel_nccl alone) it runs
phases 1-2 and those phases only, with no final line: copied into another
tree, it times and profiles that tree's steps the way this one does.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 1234
CSRC = "resnet_tpu_torch/kernels/csrc/"
# kernel -> (source, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "conv2d": (CSRC + "conv.cu", "resnet_tpu/kernels/conv.py:42"),
    # dx is the same Pallas conv kernel on the dilated gradient (conv.py:150)
    "conv2d_dx": (CSRC + "conv.cu", "resnet_tpu/kernels/conv.py:42"),
    # dW is the Pallas matmul per tap (conv.py:172-196)
    "conv2d_dw": (CSRC + "conv.cu", "resnet_tpu/kernels/matmul.py:26"),
    "add_relu": (CSRC + "add_relu.cu", "resnet_tpu/kernels/fused.py:26"),
    "add_relu_mask": (CSRC + "add_relu.cu", "resnet_tpu/kernels/fused.py:32"),
    "matmul": (CSRC + "matmul.cu", "resnet_tpu/kernels/matmul.py:26"),
    "matmul_bwd": (CSRC + "matmul.cu", "resnet_tpu/kernels/matmul.py:26"),
    "moments": (CSRC + "moments.cu", "resnet_tpu/kernels/bn.py:72"),
    "adam": (CSRC + "adam.cu", "resnet_tpu/kernels/adam.py:25"),
    "fused_conv": (CSRC + "fused_conv.cu", "resnet_tpu/kernels/fused_conv.py:45"),
    "fused_join": (CSRC + "fused_conv.cu", "resnet_tpu/kernels/fused_conv.py:505"),
    # K5, the BN apply, reached through bias_act (kernels/fused.py:90)
    "bias_act": (CSRC + "bn.cu", "resnet_tpu/kernels/bn.py:134"),
    # K6, the reduce kernel and the dx kernel (bn.py:188) of _bn_bwd_impl
    "bn_bwd": (CSRC + "bn.cu", "resnet_tpu/kernels/bn.py:166"),
    "block_fused": (CSRC + "block_fused.cu", "resnet_tpu/kernels/block_fused.py:60"),
}
# the bf16 entry points replace the same Pallas kernels for bf16 inputs
KERNEL_SOURCES.update({f"{name}_bf16": KERNEL_SOURCES[name] for name in (
    "conv2d", "conv2d_dx", "conv2d_dw", "add_relu", "add_relu_mask", "matmul", "matmul_bwd",
    "moments", "fused_conv", "fused_join", "bias_act", "bn_bwd", "block_fused")})
# the int8 serving kernels have no Pallas counterpart: they replace the XLA
# ops of quantize.py's _qconv (with _qsite's and the FC's dequantization)
# and _quant_act
KERNEL_SOURCES.update({
    "qconv": (CSRC + "qconv.cu", "resnet_tpu/quantize.py:218"),
    # Q3: _qconv with feature_group_count (quantize.py:218-238)
    "qconv_grouped": (CSRC + "qconv.cu", "resnet_tpu/quantize.py:218"),
    "quant_act": (CSRC + "qconv.cu", "resnet_tpu/quantize.py:213"),
})
# launches of each kernel in one ResNet-50 forward: 1 stem + 16*3 block
# convs + 4 projections; one join per block; the FC
PER_FORWARD = {"conv2d": 53, "add_relu": 16, "matmul": 1}
# ... and in one int8 (W8A8) forward: one Q1 and one Q2 per quantization
# site, the 53 convs and the FC (the reduce and the projection of a block
# each quantize its input)
INT8_PER_FORWARD = {"qconv": 54, "quant_act": 54}
# the int8 phase's timed batches
INT8_TIMED_BATCHES = (8, 128)
# phase 14: ResNeXt-50 32x4d, whose 16 grouped 3x3s run the plain conv
# under conv_kernels='pallas' (as JAX sends them to XLA) and Q3 in int8
RESNEXT = "resnext50_32x4d"
RESNEXT_INT8_PER_FORWARD = {"qconv": 54 - 16, "qconv_grouped": 16, "quant_act": 54}
# ... and ResNet-50 at JAX's headline configuration (BENCH_r05.json): batch
# 256 in grad_accum 2 microbatches, bf16, the standard topology, s2d
S2D_BATCH, S2D_ACCUM = 256, 2
# ... and in one training step: no dx for the stem (the images need none);
# one BN per conv; the FC's da and db in one launch; one Adam launch over
# all tensors
PER_STEP = {"conv2d": 53, "conv2d_dx": 52, "conv2d_dw": 53, "moments": 53,
            "add_relu": 16, "add_relu_mask": 16, "matmul": 1, "matmul_bwd": 1,
            "adam": 1}
# ... and in one fused-engine step: every block conv (16 * 3 + 4
# projections) and every join; the stem's statistics and its BN apply; the
# stem conv, the FC and the gradient convs are plain
FUSED_PER_STEP = {"fused_conv": 52, "fused_join": 16, "bias_act": 1, "moments": 1,
                  "adam": 1}
# 'hybrid' with the empty site table: every conv site on the torch-ops chain
HYBRID_PER_STEP = {"fused_join": 16, "bias_act": 1, "moments": 1, "adam": 1}
FUSEDXLA_PER_STEP = {"adam": 1}
# ... and in one whole-block-engine step: the 12 stride-1 identity blocks;
# the stem, the 4 projection blocks and the FC are plain
BLOCKFUSED_PER_STEP = {"block_fused": 12, "adam": 1}
# ... and with conv_kernels='pallas': K1 for the stem and the projection
# blocks' 16 convs (the stem takes no dx)
BLOCKFUSED_PALLAS_PER_STEP = {"block_fused": 12, "conv2d": 17, "conv2d_dx": 16,
                              "conv2d_dw": 17, "adam": 1}
# one batch_norm_act forward and backward
BN_ENTRY_PER_CALL = {"moments": 1, "bias_act": 1, "bn_bwd": 1}
# ... and in one step of the clean variant (batch 224) with every hand
# kernel under remat='block' or 'stage': the backward reruns the 16 blocks'
# 52 convs, their 52 BN statistics and 16 joins; the stem and the FC run once
REMAT_PER_STEP = {"conv2d": 53 + 52, "conv2d_dx": 52, "conv2d_dw": 53, "moments": 53 + 52,
                  "add_relu": 16 + 16, "add_relu_mask": 16, "matmul": 1, "matmul_bwd": 1,
                  "adam": 1}
# ... under remat='elementwise': the conv outputs and the statistics are
# kept, the BN applies and the joins rerun (models/resnet.py), so only the
# 16 joins launch again
ELEMENTWISE_PER_STEP = dict(PER_STEP, add_relu=16 + 16)
# ... the whole-block engine under remat='block': its 12 blocks rerun
BLOCKFUSED_REMAT_PER_STEP = {"block_fused": 12 + 12, "adam": 1}
# ... ghost BN: its statistics are plain torch ops, K4 is never reached
GHOST_PER_STEP = {k: v for k, v in PER_STEP.items() if k != "moments"}
# ... ResNeXt-50's step: its 16 grouped 3x3s take no K1 launch
RESNEXT_PER_STEP = dict(PER_STEP, conv2d=53 - 16, conv2d_dx=52 - 16, conv2d_dw=53 - 16)


def _on_bf16(counts):
    """The same counts on the bf16 entry points; Adam stays fp32 (bf16
    parameters, if any, are cast around it)."""
    return {k if k == "adam" else f"{k}_bf16": v for k, v in counts.items()}


# ... the standard step in bf16
BF16_PER_STEP = _on_bf16(PER_STEP)
# ... under NCHW on the hand kernels: the convs through a transpose, no K4
# (NHWC-only, resnet_tpu/ops/dispatch.py:58)
NCHW_PER_STEP = GHOST_PER_STEP
# ... one served bf16 forward
BF16_PER_FORWARD = _on_bf16(PER_FORWARD)
# ... a step at JAX's headline configuration (phase 14): each of the
# S2D_ACCUM microbatches runs a forward and a backward; the folded stem is
# the plain conv, so the stem takes no K1 forward and no dW
S2D_PER_STEP = _on_bf16({k: v if k == "adam" else
                         (v - (k in ("conv2d", "conv2d_dw"))) * S2D_ACCUM
                         for k, v in PER_STEP.items()})
# phase 12: the engines' steps in bf16, the same counts on the bf16 entries
# (fusedxla: Adam only); batch_norm_act on bf16 tensors
FUSED_BF16_PER_STEP = _on_bf16(FUSED_PER_STEP)
HYBRID_BF16_PER_STEP = _on_bf16(HYBRID_PER_STEP)
BLOCKFUSED_BF16_PER_STEP = _on_bf16(BLOCKFUSED_PER_STEP)
BLOCKFUSED_PALLAS_BF16_PER_STEP = _on_bf16(BLOCKFUSED_PALLAS_PER_STEP)
# phase 11: a bf16 step's gradient leaf is held to the plain bf16 step within
# 2x its own gap to the plain fp32 step, that gap at least bf16's unit
# roundoff (one rounding moves a value by up to 2^-8 of itself), or within
# GRAD_SENS x the plain bf16 step's change under a 1 +- 2^-8 image scaling
# (2^-20 vanishes in the cast to bf16 at the stem)
BF16_UNIT = 2.0 ** -8
# phase 11: the fast and nchw presets at their batch
PRESET_BATCH = 192
# the NCHW steps against the NHWC ones: summed loss and statistics
LAYOUT_TOL = 1e-4
# a remat step against the no-remat step from one state: loss, batch and
# running statistics within REMAT_STAT_TOL of max|.|, each gradient leaf
# within REMAT_GRAD_TOL of its max, the parameters within 2 lr + 1e-6
REMAT_STAT_TOL = 1e-6
REMAT_GRAD_TOL = 1e-5
# ghost BN's closed-form VJP against autograd of the sliced moments
GHOST_TOL = 1e-5
GHOST_BATCH, GHOST_STATS = 32, 16
LOGIT_TOL = 1e-3
# kernel path against the plain path after one training step
LOSS_TOL = 1e-4  # relative
# A gradient leaf passes within GRAD_TOL of its max|g|, or within GRAD_SENS
# times the plain path's own change when the images are scaled by
# 1 +- 2^-20. The ResNet-50 gradient is that sensitive: with batch-statistics
# BN this ~8-ulp change alone moves most leaves by 4-15% of their max, at
# random init, after the main path's steps, and with BN frozen at the batch's
# own statistics alike (the phase prints each). With BN frozen at the
# initial running statistics (mean 0, var 1) it moves them by at most ~2e-3:
# that step is the tight check, the kernel path within GRAD_SENS times that.
GRAD_TOL = 1e-3
GRAD_SENS = 4.0
IMAGE_NUDGE = 2.0 ** -20
# Adam's updates p - p0 of the frozen step: at most UPDATE_SHARE of all
# elements may differ by more than lr / 100 + 4 ulp of p0 (a gradient within
# its error of 0 can flip the sign of its update, 2 lr; a kernel that never
# wrote p would miss nearly every element)
UPDATE_SHARE = 1e-2
STAT_TOL = 1e-4  # of max(1, |running statistic|)
# batch_norm_act against plain torch ops, per output, of its max|plain|
ENTRY_TOL = 1e-4
TRAIN_STEPS = 5
# phase 10, the trainer: 3 shards of 64 procedural images, batch 32 (6 steps
# an epoch), a CLI run of 24 steps dumping every 4, the in-process Trainer
# 6 steps dumping every 2
SHARDS, SHARD_IMAGES, CLI_STEPS, CLI_EVERY, TRAINER_STEPS = 3, 64, 24, 4, 6
# a resumed run's final dump against the uninterrupted run's, and an async
# dump against a sync one: each leaf within RESUME_TOL of its max|.|; the
# per-step losses within RESUME_TOL relative
RESUME_TOL = 1e-5
# the cursor after 24 batches, as each loader reports it (data/native.py)
FINAL_CURSOR = {"native": (0, 0, 4), "python": (2, 2, 3)}
# the port's CLI as `python -m resnet_tpu_torch.train.cli ARGS` runs it,
# failing if anything imported JAX
CLI_MAIN = ("import runpy, sys\n"
            "runpy.run_module('resnet_tpu_torch.train.cli', run_name='__main__', "
            "alter_sys=True)\n"
            "sys.exit('jax was imported' if 'jax' in sys.modules else 0)\n")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_env(torch, build):
    nvcc = build.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True, timeout=60).stdout
    try:
        import triton  # noqa: F401  (recorded, never used by the port)
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc_version.strip().splitlines()[-1],
          "ninja": shutil.which("ninja") is not None,
          "triton": triton_version, "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})
    return smi


def phase_build(build):
    t0 = time.perf_counter()
    lib = build.build()
    seconds = time.perf_counter() - t0
    build.load()
    log = lib.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.is_file() else []
    emit({"phase": "build", "seconds": seconds, "library": str(lib.relative_to(ROOT)),
          "ptxas": ptxas})


class Counters:
    """The launch counters of the kernel modules, by kernel name."""

    def __init__(self, checks):
        self.where = {name: (mod, attr) for name, (mod, attr, *_) in checks.KERNELS.items()}

    def zero(self):
        for mod, attr in self.where.values():
            setattr(mod, attr, 0)

    def read(self):
        return {name: getattr(mod, attr) for name, (mod, attr) in self.where.items()}


def _moved(before, after):
    """The counters that moved between two readings, by how much."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _plan(build, name, case):
    """The launch plan of a case of a kernel that has one (None for the
    others): tile, tiles and K splits (build.tc_split, build.wgb_split);
    the bf16 forward's A loader and dW's route; da and db blocks
    (build.matmul_bwd_plan, build.matmul_bwd_plan_bf16)."""
    if name.startswith("conv2d"):  # a case's geometry: square, or a tile's rows
        from resnet_tpu_torch.kernels import checks

        n, (h, wd), cin, cout, k, s, pad, offset, (ho, wo) = checks.conv_case(case)
        flat = pad is None or pad == ((0, 0), (0, 0))  # conv._flat at 1x1/s1
    if name == "conv2d":
        m, bn = n * ho * wo, build.tc_tile_n(cout)
        return {"tile": [build.TC_BM, bn], "tiles": -(-m // build.TC_BM) * -(-cout // bn),
                "splits": build.tc_split(m, cout, k * k * cin)}
    if name == "matmul_bwd":
        _, m, k, n, _, need_a, need_b = case
        return dict(zip(("da_blocks", "db_blocks"),
                        build.matmul_bwd_plan(m, k, n, need_a, need_b)))
    if name in ("block_fused", "block_fused_bf16"):
        _, (n, h, w, c4), c, _ = case
        m = n * h * w
        gemms = ((c, c4), (c, 9 * c), (c4, c))  # (Cout, K): reduce, 3x3, expand
        bf16 = name.endswith("_bf16")
        tile_n, split = ((build.wgb_tile_n, build.wgb_split) if bf16
                         else (build.wg_tile_n, build.wg_split))
        tiles = [tile_n(cout) for cout, _ in gemms]
        plan = {"tile_n": tiles,
                "tiles": [-(-m // build.WG_BM) * -(-cout // bn)
                          for (cout, _), bn in zip(gemms, tiles)],
                "splits": [split(m, cout, k) for cout, k in gemms]}
        if bf16:  # the persistent loop's units and blocks per stage
            plan["units"] = [t * sp for t, sp in zip(plan["tiles"], plan["splits"])]
            plan["blocks"] = [min(u, 132) for u in plan["units"]]
        return plan
    if name == "conv2d_dw_bf16":  # the route, and on the wgmma core its slices
        from resnet_tpu_torch.kernels.conv import DW_NARROW, dw_bf16_route

        route = dw_bf16_route(cin, cout, s, hw=(h, wd))
        if route == "mma":
            return {"route": route, "splits": build.tc_split(k * k * cin, cout, n * ho * wo)}
        cin = max(cin, DW_NARROW)
        slices = build.dw_slices(n, ho, wo, k, s, flat)
        return {"route": route, "box": build.dw_box(ho, wo), "slices": slices,
                "tiles": -(-k * k * cin // build.WGB_BM) * -(-cout // build.wgb_tile_n(cout)),
                "splits": build.wgb_split(k * k * cin, cout, build.WGB_BK * slices)}
    if name == "fused_conv_bf16":  # a square case or a tile's rows
        from resnet_tpu_torch.kernels import checks

        n, _, cin, cout, k, s, *_, (ho, wo) = checks.fused_conv_case(case)
        m, bn = n * ho * wo, build.wgb_tile_n(cout)
        return {"tile": [build.WGB_BM, bn], "tiles": -(-m // build.WGB_BM) * -(-cout // bn),
                "splits": build.wgb_split(m, cout, k * k * cin)}
    if name == "conv2d_bf16":  # the A loader, K splits and units of the persistent kernel
        from resnet_tpu_torch.kernels.conv import fwd_bf16_route

        m, bn = n * ho * wo, build.wgb_tile_n(cout)
        splits = build.tc_split(m, cout, k * k * cin)
        units = -(-m // build.WGB_BM) * -(-cout // bn) * splits
        left = None if pad is None else pad[1][0]
        return {"a": fwd_bf16_route(m, cin, cout, k, s, offset % 8 == 0, splits, left, flat),
                "tile": [build.WGB_BM, bn], "splits": splits,
                "chunk": build.k_chunk(k * k * cin, splits, 16), "units": units,
                "blocks": min(units, 132)}
    if name == "conv2d_dx_bf16":  # the loaders, phases, K splits and units of the persistent kernel
        from resnet_tpu_torch.kernels import conv

        m, bn = n * h * wd, build.wgb_tile_n(cin)
        splits = conv.dx_splits(m, cin, cout, k, s)
        units = -(-n * -(-h // s) * -(-wd // s) // build.WGB_BM) * -(-cin // bn) * splits * s * s
        return {"route": conv.dx_bf16_route(m, cin, cout, k, s, True, flat),
                "tile": [build.WGB_BM, bn],
                "splits": splits, "chunk": build.k_chunk(k * k * cout, splits, 16) if s == 1
                else None, "phases": s * s, "units": units, "blocks": min(units, 132)}
    if name == "matmul_bf16":  # the loaders, tile, K splits and units of the persistent kernel
        from resnet_tpu_torch.kernels.matmul import fwd_bf16_route, fwd_splits

        _, m, k, n, offset = case
        route, splits = fwd_bf16_route(m, n, k, offset % 8 == 0), fwd_splits(m, n, k)
        swap = route.startswith("swap")
        tile = ([build.WGB_BM, 8 if m <= 8 else 16 if m <= 16 else 32] if swap
                else [build.WGB_BM, build.wgb_tile_n(n)])  # (columns of N, M) when swapped
        units = -(-n // tile[0]) if swap else -(-m // tile[0]) * -(-n // tile[1])
        units *= splits
        return {"route": route, "tile": tile, "splits": splits,
                "chunk": build.k_chunk(k, splits, 16), "units": units, "blocks": min(units, 132)}
    if name == "qconv":  # Q1's tile, K splits, units, persistent blocks and A loader
        from resnet_tpu_torch.kernels import quant

        _, n, h, cin, cout, k, s, *_ = case
        m = n * (h // s) ** 2
        kk = quant.packed_k((k, k, cin))
        bn, splits = build.qconv_plan(m, cout, kk)
        units = -(-m // build.QC_BM) * -(-cout // bn) * splits
        return {"tile": [build.QC_BM, bn], "slices": -(-kk // build.QC_SLICE),
                "splits": splits, "units": units, "blocks": min(units, 132),
                "a": "cp.async 16 bytes" if cin % 16 == 0 else "kernel-row runs"}
    if name == "qconv_grouped":  # Q3's plan and the layout it gives
        _, n, h, cin, cout, k, s, _, _, out, g = case
        ho = h // s
        plan = build.q3_plan(n, cin, cout, g, k, k, s, ho, ho, out == "f32", True)
        geo = build.q3_geometry(n, cin, cout, g, k, k, s, ho, ho, out == "f32", True, *plan)
        return {"plan": list(plan), **{key: geo[key] for key in (
            "loads", "nb", "ks", "spans", "tiles", "tile_pixels", "halo_pixels", "smem")}}
    if name == "matmul_bwd_bf16":
        _, m, k, n, _, need_a, need_b = case
        return dict(zip(("da_blocks", "db_blocks"),
                        build.matmul_bwd_plan_bf16(m, k, n, need_a, need_b)))
    return None


def phase_kernels(checks, names, build=None):
    """Each case of the named kernels against its plain version; with
    ``build``, each line also carries the case's launch plan."""
    results = {name: [] for name in names}
    for name in names:
        for case in checks.KERNELS[name][-1]:
            r = checks.check_case(name, case, seed=SEED)
            plan = _plan(build, name, case) if build is not None else None
            emit({"phase": "kernel", **r, **({"plan": plan} if plan else {})})
            results[name].append(r)
    if build is not None and "block_fused" in names:
        for case in checks.SPLIT_CASES:  # K10's weight split, bit for bit
            emit({"phase": "kernel", **checks.check_split(case, seed=SEED)})
    return results


def _post(addr, x):
    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        conn.request("POST", "/predict", body=x.tobytes(),
                     headers={"X-Shape": ",".join(map(str, x.shape))})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _serving_state(torch, mcfg):
    """Seeded parameters of ``mcfg`` on the card and non-trivial BN running
    statistics (means ~0.1, variances in [0.5, 2]): what the serving phases
    export."""
    from resnet_tpu_torch.models import init_bn_state, init_params

    gen = torch.Generator().manual_seed(SEED)
    params = init_params(gen, mcfg, device="cuda")
    bn_state = init_bn_state(mcfg, device="cuda")
    for layer in [bn_state["init_bn"], *[b for blk in bn_state["blocks"]
                                          for b in blk.values()]]:
        c = layer["mean"].numel()
        layer["mean"] = (torch.randn(c, generator=gen) * 0.1).to("cuda")
        layer["var"] = (0.5 + 1.5 * torch.rand(c, generator=gen)).to("cuda")
    return params, bn_state


def phase_serve(torch, checks, counters):
    from resnet_tpu_torch.config import ExecutionConfig, model_config
    from resnet_tpu_torch.export import export_inference, save_inference
    from resnet_tpu_torch.serve import bucketed_call, serve

    mcfg = model_config("resnet50")
    kernel_cfg = ExecutionConfig(kernels="pallas", conv_kernels="pallas")
    params, bn_state = _serving_state(torch, mcfg)
    rng = np.random.default_rng(SEED)
    d = mcfg.input_dim
    # pixel-scale inputs, as mean-subtracted images are: at unit scale the
    # random network's logits barely depend on the image
    batches = [rng.normal(0, 50, (n, d, d, 3)).astype(np.float32) for n in (1, 3, 8)]

    with tempfile.TemporaryDirectory() as tmp:
        path = save_inference(os.path.join(tmp, "resnet50.pt"),
                              export_inference(params, mcfg, bn_state=bn_state,
                                               ecfg=kernel_cfg))
        httpd = serve(path, port=0, device="cuda")
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            conn = http.client.HTTPConnection(*httpd.server_address, timeout=60)
            conn.request("GET", "/healthz")
            require(json.loads(conn.getresponse().read()) == {"ok": True},
                    "/healthz did not answer ok")
            conn.close()
            # the main path: counters from 0, three requests, counters read
            counters.zero()
            replies, deltas = [], []
            for x in batches:
                before = counters.read()
                status, out = _post(httpd.server_address, x)
                require(status == 200, f"/predict answered {status}: {out}")
                deltas.append(_moved(before, counters.read()))
                replies.append(out)
            launches = {k: v for k, v in counters.read().items() if v}
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
        require(not thread.is_alive(), "server thread did not stop")
    served = httpd.served

    for x, out, delta in zip(batches, replies, deltas):
        require(out["logits_shape"] == [x.shape[0], mcfg.num_classes],
                f"logits_shape {out['logits_shape']} for batch {x.shape[0]}")
        require(delta == PER_FORWARD,
                f"batch {x.shape[0]} moved the counters by {delta}, "
                f"expected {PER_FORWARD}")
    require(launches == {k: v * len(batches) for k, v in PER_FORWARD.items()},
            f"launch counts {launches}")

    plain = export_inference(params, mcfg, bn_state=bn_state,
                             ecfg=ExecutionConfig(), device="cuda")
    compare = []
    for x, out in zip(batches, replies):
        got = bucketed_call(served, x)
        want = plain.call(x).cpu().numpy()
        require(np.isfinite(got).all(), "non-finite kernel-path logits")
        require(out["top1"] == got.argmax(-1).tolist(),
                "HTTP top1 differs from the served model's logits")
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        require(scale > 0 and err <= LOGIT_TOL * scale,
                f"batch {x.shape[0]}: max|kernel - plain| logits = {err} "
                f"> {LOGIT_TOL} * {scale}")
        top2 = np.sort(want, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL * scale
        agree = got.argmax(-1) == want.argmax(-1)
        require(bool(agree[decided].all()),
                f"batch {x.shape[0]}: top1 differs where the plain top-2 gap "
                f"exceeds {LOGIT_TOL} of max|logits|")
        compare.append({"batch": int(x.shape[0]), "max_abs_err": err,
                        "max_abs_logit": scale, "top1": out["top1"],
                        "top1_agree": int(agree.sum()),
                        "latency_ms": out["latency_ms"]})

    x8 = torch.from_numpy(batches[2]).cuda()
    kernel_ms = checks.median_ms(lambda: served.call(x8), reps=10)
    plain_ms = checks.median_ms(lambda: plain.call(x8), reps=10)
    emit({"phase": "serve", "model": mcfg.name, "requests": len(replies),
          "launches": launches, "per_request": deltas, "compare": compare,
          "batch8_ms": kernel_ms, "batch8_img_s": 8e3 / kernel_ms,
          "plain_batch8_ms": plain_ms, "plain_batch8_img_s": 8e3 / plain_ms})
    return launches


def _int8_http(torch, counters, mcfg, per_forward):
    """The W8A8 serving path of ``mcfg`` at full width: phase 4's seeded
    weights and running statistics calibrated on one seeded batch of 8 at
    pixel scale (export_quantized_inference), saved, loaded by
    resnet_tpu_torch.serve and asked for batches of 1, 3 and 8 over HTTP:
    each request must move the counters by exactly ``per_forward`` and no
    other; the served logits at each request's bucket must equal the plain
    int8 forward on the card (the kernels' plain versions, the same qparams
    and scales) bit for bit, and the HTTP top1 be their argmax. Also the
    int8 logits' Pearson correlation and top-1 agreement with the port's
    fp32 folded forward at batch 8 (printed, held only to be finite).
    Returns (the served model, the line's fields, the launches, (params,
    bn_state), the batch of 8 on the card, the generator)."""
    import types

    from resnet_tpu_torch.export import export_quantized_inference, save_inference
    from resnet_tpu_torch.quantize import fold_bn_inference, folded_forward, forward_sites
    from resnet_tpu_torch.serve import bucketed_call, serve

    params, bn_state = _serving_state(torch, mcfg)
    rng = np.random.default_rng(SEED)
    d = mcfg.input_dim
    calib = rng.normal(0, 50, (8, d, d, 3)).astype(np.float32)
    batches = [rng.normal(0, 50, (n, d, d, 3)).astype(np.float32) for n in (1, 3, 8)]
    t0 = time.perf_counter()
    model = export_quantized_inference(params, mcfg, calib, bn_state=bn_state)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        path = save_inference(os.path.join(tmp, f"{mcfg.name}_int8.pt"), model)
        file_bytes = os.path.getsize(path)
        httpd = serve(path, port=0, device="cuda")
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            conn = http.client.HTTPConnection(*httpd.server_address, timeout=60)
            conn.request("GET", "/healthz")
            require(json.loads(conn.getresponse().read()) == {"ok": True},
                    "/healthz did not answer ok")
            conn.close()
            # the main path: counters from 0, three requests, counters read
            counters.zero()
            replies, deltas = [], []
            for x in batches:
                before = counters.read()
                status, out = _post(httpd.server_address, x)
                require(status == 200, f"/predict answered {status}: {out}")
                deltas.append(_moved(before, counters.read()))
                replies.append(out)
            launches = {k: v for k, v in counters.read().items() if v}
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
        require(not thread.is_alive(), "server thread did not stop")
    served = httpd.served
    require(served.kind == "int8" and served.meta["scales"] == model.scales,
            "the loaded artifact's scales differ from the export's")
    for x, out, delta in zip(batches, replies, deltas):
        require(out["logits_shape"] == [x.shape[0], mcfg.num_classes],
                f"logits_shape {out['logits_shape']} for batch {x.shape[0]}")
        require(delta == per_forward,
                f"{mcfg.name} int8 batch {x.shape[0]} moved the counters by {delta}, "
                f"expected {per_forward}")
    require(launches == {k: v * len(batches) for k, v in per_forward.items()},
            f"{mcfg.name} int8 launch counts {launches}")

    # the served logits against the plain int8 forward at the same buckets
    def plain_call(a):
        x = torch.from_numpy(np.asarray(a, dtype=np.float32)).cuda()
        with torch.inference_mode():
            return forward_sites(model.sites(), x, model.mcfg, relu_cap=model.relu_cap,
                                 plain=True)

    plain = types.SimpleNamespace(call=plain_call)
    compare = []
    for x, out in zip(batches, replies):
        got, want = bucketed_call(served, x), bucketed_call(plain, x)
        require(np.isfinite(got).all(), f"int8 batch {x.shape[0]}: non-finite logits")
        require(got.shape == want.shape and got.tobytes() == want.tobytes(), f"int8 batch {x.shape[0]}: served logits differ from "
                f"the plain int8 forward by {float(np.abs(got - want).max())}")
        require(out["top1"] == got.argmax(-1).tolist(),
                "HTTP top1 differs from the served model's logits")
        compare.append({"batch": int(x.shape[0]), "bit_equal_to_plain": True,
                        "max_abs_logit": float(np.abs(got).max()), "top1": out["top1"],
                        "latency_ms": out["latency_ms"]})

    # how close int8 comes to the fp32 folded model (printed, not gated)
    x8 = torch.from_numpy(batches[2]).cuda()
    fp = folded_forward(fold_bn_inference(params, bn_state, mcfg), x8, mcfg).cpu().numpy()
    q8 = served.call(x8).cpu().numpy()
    pearson = float(np.corrcoef(fp.ravel(), q8.ravel())[0, 1])
    agree = int((fp.argmax(-1) == q8.argmax(-1)).sum())
    require(np.isfinite(pearson), "int8 vs fp32: correlation not finite")
    fields = {"model": mcfg.name, "export_s": export_s, "file_bytes": file_bytes,
              "requests": len(replies), "launches": launches, "per_request": deltas,
              "compare": compare,
              "vs_fp32_folded_batch8": {"pearson": pearson, "top1_agree": agree, "of": 8}}
    return served, fields, launches, (params, bn_state), x8, rng


def phase_int8_serve(torch, checks, counters):
    """The W8A8 serving path at full width on ResNet-50 at 224
    (``_int8_http``: each request exactly 54 Q1 and 54 Q2 launches and no
    other, the served logits the plain int8 forward's bit for bit, the
    Pearson correlation with the fp32 folded forward); then the int8 and
    the bf16 hand-kernel served forwards (``_int8_vs_bf16``) at batches 8
    and 128."""
    from resnet_tpu_torch.config import model_config

    mcfg = model_config("resnet50")
    served, fields, launches, state, x8, rng = _int8_http(torch, counters, mcfg,
                                                          INT8_PER_FORWARD)
    timed = _int8_vs_bf16(torch, checks, served, mcfg, state, x8, rng, INT8_TIMED_BATCHES)
    emit({"phase": "int8_serve", **fields, "timed": timed})
    return launches


def _int8_split(rows):
    """One int8 forward's device ms by kernel: Q1 (every qconv kernel but
    Q3's), Q3 (qconv_grouped_kernel), Q2 (quant_act) and the rest."""
    q3 = sum(v for k, v in rows.items() if "qconv_grouped" in k)
    q1 = sum(v for k, v in rows.items() if "qconv" in k) - q3
    q2 = sum(v for k, v in rows.items() if "quant_act" in k)
    total = sum(rows.values())
    return {"qconv": q1, "qconv_grouped": q3, "quant_act": q2, "rest": total - q1 - q2 - q3,
            "total": total}


def _int8_vs_bf16(torch, checks, served, mcfg, state, x8, rng, batches):
    """The int8 served forward and the bf16 hand-kernel one (bf16 weights,
    every bf16 kernel) timed by CUDA events (median of 10) at each batch, in
    turns (int8, bf16, bf16, int8); at the largest, one int8 forward's
    device time split by kernel (``_int8_split``, torch.profiler) beside the
    bf16 forward's."""
    from resnet_tpu_torch.config import ExecutionConfig
    from resnet_tpu_torch.export import export_inference

    params, bn_state = state
    d = mcfg.input_dim
    bf16 = export_inference(params, mcfg, bn_state=bn_state, weights_dtype="bfloat16",
                            ecfg=ExecutionConfig(compute_dtype="bfloat16", kernels="pallas",
                                                 conv_kernels="pallas"), device="cuda")
    timed = {}
    for n in batches:
        x = x8 if n == 8 else torch.from_numpy(
            rng.normal(0, 50, (n, d, d, 3)).astype(np.float32)).cuda()
        turns = {"int8": [], "bf16": []}
        for which in ("int8", "bf16", "bf16", "int8"):
            m = served if which == "int8" else bf16
            turns[which].append(checks.median_ms(lambda: m.call(x), reps=10))
        timed[f"batch{n}"] = {
            **{f"{k}_ms": v for k, v in turns.items()},
            **{f"{k}_img_s": n * 2e3 / sum(v) for k, v in turns.items()}}
        if n == max(batches):
            rows = checks.device_profile(lambda: served.call(x), reps=3)
            require(rows is not None, "the int8 forward's profile recorded no device time")
            timed[f"batch{n}"]["int8_device_ms"] = _int8_split(rows)
            timed[f"batch{n}"]["bf16_device_ms"] = checks.device_ms(lambda: bf16.call(x),
                                                                    reps=3)
        del x
    for n, t in timed.items():
        require(all(np.isfinite(v) for k in ("int8_ms", "bf16_ms") for v in t[k]),
                f"int8 timing: a non-finite time at {n}")
    del bf16
    torch.cuda.empty_cache()
    return timed


def _clone(tree):
    """A deep copy of a state tree (NamedTuples, dicts, lists, tensors)."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _leaf_errors(got, want, what, rel, floor=0.0, sens=None):
    """max|got - want| over each leaf pair, against rel * max(floor, max|want|)
    or, where ``sens`` (path -> the plain path's own change) is given,
    GRAD_SENS times that change if larger; raises on a leaf beyond both.
    Returns the largest ratio to max|want|, the largest to the sensitivity,
    and the leaf nearest its limit with the limit applied there."""
    from resnet_tpu_torch.bridge import flatten

    worst, worst_sens, nearest, nearest_ratio = 0.0, 0.0, None, -1.0
    for (path, g), (_, w) in zip(flatten(got), flatten(want), strict=True):
        err = (g - w).abs().max().item()
        scale = max(floor, w.abs().max().item())
        limit = rel * scale
        if sens is not None:
            limit = max(limit, GRAD_SENS * sens[path])
            worst_sens = max(worst_sens, err / sens[path] if sens[path] else 0.0)
        require(err <= limit,
                f"{what} {path}: max|kernel - plain| = {err} > {limit}")
        worst = max(worst, err / scale if scale else err)
        ratio = err / limit if limit else 0.0
        if ratio > nearest_ratio:
            nearest_ratio = ratio
            nearest = {"leaf": path, "err": err, "limit": limit, "max_abs": scale}
    return worst, worst_sens, nearest


def _update_share(got, want, p0, lr):
    """The share of all elements whose update got - p0 differs from
    want - p0 by more than lr / 100 + 4 ulp of p0."""
    from resnet_tpu_torch.bridge import leaves

    bad = total = 0
    for a, b, z in zip(leaves(got), leaves(want), leaves(p0), strict=True):
        limit = lr / 100 + 4 * 2.0 ** -23 * z.abs()
        bad += int((((a - z) - (b - z)).abs() > limit).sum().item())
        total += z.numel()
    return bad / total


def _as_running(bn_stats):
    """aux["bn_stats"] ((mean, var) per layer) as a bn_state tree."""
    def leaf(mv):
        return {"mean": mv[0].clone(), "var": mv[1].clone()}

    return {"init_bn": leaf(bn_stats["init_bn"]),
            "blocks": [{k: leaf(v) for k, v in b.items()} for b in bn_stats["blocks"]]}


def _nudge_sensitivity(batch, params, bn_state, pc, pg, nudge=IMAGE_NUDGE):
    """Per gradient leaf, the plain path's own largest change when the
    images are scaled by 1 +- ``nudge`` (pg: its gradient at the images)."""
    from resnet_tpu_torch.bridge import flatten, leaves
    from resnet_tpu_torch.train import loss_and_grads

    sens = {}
    for factor in (1 + nudge, 1 - nudge):
        nudged = dict(batch, images=batch["images"] * factor)
        qg = loss_and_grads(params, nudged, bn_state, pc)[3]
        for (path, a), b in zip(flatten(qg), leaves(pg), strict=True):
            sens[path] = max(sens.get(path, 0.0), (a - b).abs().max().item())
        del qg
    return sens


def _train_main_path(torch, counters, step, cfg, state0, batch, expect, what):
    """A training path's main run: the counters from 0, TRAIN_STEPS steps on
    one batch, each required to move the counters by exactly ``expect``, and
    the loss after the last update required below the first. Returns (state,
    losses, per-step counts, the counters after the steps, that loss)."""
    from resnet_tpu_torch.models import forward
    from resnet_tpu_torch.ops import cross_entropy

    counters.zero()
    state, losses, per_step = _clone(state0), [], []
    for _ in range(TRAIN_STEPS):
        before = counters.read()
        state, metrics = step(state, batch)
        per_step.append(_moved(before, counters.read()))
        losses.append(metrics["loss"].item())
    launches = counters.read()
    for i, delta in enumerate(per_step):
        require(delta == expect, f"{what} step {i} moved the counters by {delta}, "
                f"expected {expect}")
    with torch.no_grad():
        logits, _ = forward(state.params, batch["images"], cfg.model, cfg.execution,
                            train=True, bn_state=state.bn_state)
        final_loss = cross_entropy(logits, batch["labels"], reduction="mean").item()
    require(all(np.isfinite(losses)) and np.isfinite(final_loss), f"losses {losses}")
    require(final_loss < losses[0], f"{what}: loss after {TRAIN_STEPS} steps "
            f"{final_loss} is not below the first {losses[0]}")
    return state, losses, per_step, launches, final_loss


def _timed_steps(torch, step, state, batch, n=5):
    """(state, median ms, host ms of each step) of n steps, each timed on the
    host clock around work that ends in a synchronize; the host ms run from
    the step's start to its return, before that synchronize."""
    times, host = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return state, float(np.median(times)), host


def _profile(torch, step):
    """Device time of one call of step() by kernel name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        ms = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms > 0 and getattr(e, "self_cpu_time_total", 0) == 0:
            rows.append({"kernel": e.key[:90], "calls": e.count, "ms": ms})
    rows.sort(key=lambda r: -r["ms"])
    return rows


def phase_train(torch, checks, counters, smi):
    import dataclasses

    from resnet_tpu_torch.bridge import flatten, leaves
    from resnet_tpu_torch.config import ExecutionConfig, variant_config
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.train import init_train_state, loss_and_grads, make_train_step

    base = variant_config("resnet")  # ResNet-50, kernels='pallas', lr 1e-4, batch 32
    kcfg = dataclasses.replace(
        base, execution=dataclasses.replace(base.execution, conv_kernels="pallas"),
        optimizer=dataclasses.replace(base.optimizer, fused=True))
    pcfg = dataclasses.replace(
        base, execution=ExecutionConfig(),
        optimizer=dataclasses.replace(base.optimizer, fused=False))
    batch_n = base.data.batch_size
    lr = base.optimizer.learning_rate
    state0 = init_train_state(kcfg, torch.Generator().manual_seed(SEED), device="cuda")
    data = next(SyntheticDataset(batch_n, image_dim=base.model.input_dim,
                                 num_classes=base.model.num_classes, seed=SEED))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    kstep, pstep = make_train_step(kcfg), make_train_step(pcfg)

    state, losses, per_step, launches, final_loss = _train_main_path(
        torch, counters, kstep, kcfg, state0, batch, PER_STEP, "train")

    def grads_pair(params, bn_state, kc, pc):
        """Kernel-path and plain-path gradients from one state, and the plain
        path's own change per leaf when the images are scaled by 1 +- 2^-20."""
        kl, _, _, kg = loss_and_grads(params, batch, bn_state, kc)
        pl, _, paux, pg = loss_and_grads(params, batch, bn_state, pc)
        sens = _nudge_sensitivity(batch, params, bn_state, pc, pg)
        require(abs(kl.item() - pl.item()) <= LOSS_TOL * abs(pl.item()),
                f"summed loss {kl.item()} vs plain {pl.item()}")
        return kg, pg, sens, paux

    def max_rel(errs, want):
        return max(errs[p] / max(w.abs().max().item(), 1e-30) for p, w in flatten(want))

    def survey(params, bn_state, kc, pc):
        """How far kernel and plain gradients differ, and how far the plain
        path moves under the nudge, as shares of each leaf's max; no limit."""
        kg, pg, sens, _ = grads_pair(params, bn_state, kc, pc)
        errs = {p: (a - b).abs().max().item()
                for (p, a), b in zip(flatten(kg), leaves(pg), strict=True)}
        return {"kernel_vs_plain_max_rel": max_rel(errs, pg),
                "plain_nudge_max_rel": max_rel(sens, pg)}

    def frozen(cfg):
        return dataclasses.replace(
            cfg, execution=dataclasses.replace(cfg.execution, bn_mode="frozen"))

    # one step from the same state on both paths, compared leaf by leaf
    kg, pg, sens, paux = grads_pair(state0.params, state0.bn_state, kcfg, pcfg)
    sens_rel = max_rel(sens, pg)
    grad_err, grad_sens, grad_nearest = _leaf_errors(kg, pg, "gradient", GRAD_TOL,
                                                     sens=sens)
    ks, km = kstep(_clone(state0), batch)
    ps, pm = pstep(_clone(state0), batch)
    loss_err = abs(km["loss"].item() - pm["loss"].item()) / abs(pm["loss"].item())
    require(loss_err <= LOSS_TOL, f"loss {km['loss'].item()} vs plain {pm['loss'].item()}")
    # after one step from zero moments, m = (1 - b1) g on both paths
    b1 = base.optimizer.beta1
    m_err, m_sens, _ = _leaf_errors(ks.opt_state.means, ps.opt_state.means, "adam m",
                                    GRAD_TOL,
                                    sens={k: (1 - b1) * v for k, v in sens.items()})
    p_abs = max((a - b).abs().max().item()
                for a, b in zip(leaves(ks.params), leaves(ps.params), strict=True))
    require(p_abs <= 2 * lr + 1e-6, f"params differ by {p_abs} > 2 * lr + 1e-6")
    batch_share = _update_share(ks.params, ps.params, state0.params, lr)
    stat_err, _, _ = _leaf_errors(ks.bn_state, ps.bn_state, "running statistic",
                                  STAT_TOL, floor=1.0)
    del ks, ps, kg, pg

    # where else the gradient is as sensitive: after the main path's steps,
    # and with BN frozen at this batch's own statistics
    conditioning = {
        "batch_bn_after_steps": survey(state.params, state.bn_state, kcfg, pcfg),
        "frozen_at_batch_stats": survey(state0.params, _as_running(paux["bn_stats"]),
                                        frozen(kcfg), frozen(pcfg))}

    # the well-conditioned check: one step with BN frozen at the initial
    # running statistics (mean 0, var 1); conv dx and dW, the join masks, the
    # FC backward and Adam are all on this path
    kfcfg, pfcfg = frozen(kcfg), frozen(pcfg)
    fkg, fpg, fsens, _ = grads_pair(state0.params, state0.bn_state, kfcfg, pfcfg)
    frozen_sens = max_rel(fsens, fpg)
    frozen_err, frozen_ratio, frozen_nearest = _leaf_errors(
        fkg, fpg, "frozen-BN gradient", GRAD_TOL, sens=fsens)
    del fkg, fpg
    ks, _ = make_train_step(kfcfg)(_clone(state0), batch)
    ps, _ = make_train_step(pfcfg)(_clone(state0), batch)
    frozen_share = _update_share(ks.params, ps.params, state0.params, lr)
    require(frozen_share <= UPDATE_SHARE,
            f"frozen-BN step: {frozen_share} of the Adam updates differ from the "
            f"plain path's by more than lr / 100")
    frozen_m_err, _, _ = _leaf_errors(ks.opt_state.means, ps.opt_state.means,
                                      "frozen-BN adam m", GRAD_TOL,
                                      sens={k: (1 - b1) * v for k, v in fsens.items()})
    del ks, ps

    # step times in turns: plain, kernel, kernel, plain
    pstate = _clone(state0)
    step_ms = {"plain": [], "kernel": []}
    host = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "plain":
            pstate, ms, h = _timed_steps(torch, pstep, pstate, batch)
        else:
            state, ms, h = _timed_steps(torch, kstep, state, batch)
        step_ms[which].append(ms)
        host[which] += h
    # peak memory of one step of each path; both paths' states are resident
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    peak = {}
    torch.cuda.reset_peak_memory_stats()
    state, _ = kstep(state, batch)
    torch.cuda.synchronize()
    peak["kernel"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    pstate, _ = pstep(pstate, batch)
    torch.cuda.synchronize()
    peak["plain"] = torch.cuda.max_memory_allocated() / 2**30

    holder = {"state": state}

    def one_step():
        holder["state"], _ = kstep(holder["state"], batch)

    profile_rows = _profile(torch, one_step)
    busy = sum(r["ms"] for r in profile_rows)
    kernel_ms = float(np.median(step_ms["kernel"]))
    plain_ms = float(np.median(step_ms["plain"]))
    emit({"phase": "train", "model": kcfg.model.name, "batch": batch_n,
          "device": smi, "launches": launches, "per_step": per_step[0],
          "losses": losses, "loss_after_last_step": final_loss,
          "compare": {"loss_rel_err": loss_err, "grad_max_rel_err": grad_err,
                      "grad_max_err_over_sensitivity": grad_sens,
                      "plain_grad_max_rel_sensitivity": sens_rel,
                      "adam_m_max_rel_err": m_err,
                      "adam_m_max_err_over_sensitivity": m_sens,
                      "grad_nearest_limit": grad_nearest,
                      "param_max_abs_err": p_abs,
                      "update_share_beyond_lr_100": batch_share,
                      "running_stats_max_err": stat_err,
                      "frozen_bn": {"grad_max_rel_err": frozen_err,
                                    "grad_max_err_over_sensitivity": frozen_ratio,
                                    "grad_nearest_limit": frozen_nearest,
                                    "plain_grad_max_rel_sensitivity": frozen_sens,
                                    "adam_m_max_rel_err": frozen_m_err,
                                    "update_share_beyond_lr_100": frozen_share},
                      "conditioning": conditioning},
          "step_ms": step_ms, "host_step_ms": _host_medians(host),
          "kernel_step_ms": kernel_ms,
          "kernel_img_s": batch_n * 1e3 / kernel_ms, "plain_step_ms": plain_ms,
          "plain_img_s": batch_n * 1e3 / plain_ms, "peak_gib": peak,
          "resident_before_gib": resident,
          "profile_device_busy_ms": busy if profile_rows else "not measured",
          "profile": profile_rows[:30]})
    return {k: v for k, v in launches.items() if v}


def _engine_vs_plain(torch, cfg, pcfg, state0, batch):
    """One step of an engine from state0 against the plain standard path:
    summed loss, training logits, every layer's batch statistics, every
    gradient leaf (the rule of phase 5's batch-statistics step), then the
    step's loss and running statistics. Returns (compare, the plain loss)."""
    from resnet_tpu_torch.train import loss_and_grads, make_train_step

    fl, flogits, faux, fg = loss_and_grads(state0.params, batch, state0.bn_state, cfg)
    pl, plogits, paux, pg = loss_and_grads(state0.params, batch, state0.bn_state, pcfg)
    sum_loss_err = abs(fl.item() - pl.item()) / abs(pl.item())
    require(sum_loss_err <= LOSS_TOL, f"summed loss {fl.item()} vs plain {pl.item()}")
    logit_scale = plogits.abs().max().item()
    logit_err = (flogits - plogits).abs().max().item()
    require(logit_err <= LOGIT_TOL * logit_scale,
            f"training logits differ by {logit_err} > {LOGIT_TOL} * {logit_scale}")
    stat_batch_err, _, _ = _leaf_errors(faux["bn_stats"], paux["bn_stats"],
                                        "batch statistic", STAT_TOL, floor=1.0)
    sens = _nudge_sensitivity(batch, state0.params, state0.bn_state, pcfg, pg)
    grad_err, grad_sens, grad_nearest = _leaf_errors(fg, pg, f"{cfg.execution.kernels} "
                                                     "gradient", GRAD_TOL, sens=sens)
    del fg, pg, faux, paux
    fs, fm = make_train_step(cfg)(_clone(state0), batch)
    ps, pm = make_train_step(pcfg)(_clone(state0), batch)
    plain_loss = pm["loss"].item()
    loss_err = abs(fm["loss"].item() - plain_loss) / abs(plain_loss)
    require(loss_err <= LOSS_TOL, f"loss {fm['loss'].item()} vs plain {plain_loss}")
    stat_err, _, _ = _leaf_errors(fs.bn_state, ps.bn_state, "running statistic",
                                  STAT_TOL, floor=1.0)
    return {"summed_loss_rel_err": sum_loss_err, "loss_rel_err": loss_err,
            "logits_max_err": logit_err, "logits_max_abs": logit_scale,
            "batch_stats_max_rel_err": stat_batch_err, "running_stats_max_err": stat_err,
            "grad_max_rel_err": grad_err, "grad_max_err_over_sensitivity": grad_sens,
            "grad_nearest_limit": grad_nearest}, plain_loss


def _other_step(counters, cfg, state0, batch, expect, plain_loss, name):
    """One step of another configuration: its counts, its loss against the
    plain path's."""
    from resnet_tpu_torch.train import make_train_step

    before = counters.read()
    _, m = make_train_step(cfg)(_clone(state0), batch)
    delta = _moved(before, counters.read())
    require(delta == expect, f"{name} step moved the counters by {delta}, expected {expect}")
    err = abs(m["loss"].item() - plain_loss) / abs(plain_loss)
    require(err <= LOSS_TOL, f"{name} loss {m['loss'].item()} vs plain {plain_loss}")
    return {"per_step": delta, "loss": m["loss"].item(), "loss_rel_err": err}


def _host_medians(host):
    """The median host ms per path over all its timed steps."""
    return {k: float(np.median(v)) for k, v in host.items()}


def _times_and_peaks(torch, steps, states, batch, order):
    """Step times in turns (median of 5 steps per turn, in ``order``) and the
    host ms per path (``_host_medians``), then the peak memory of one step
    of each path with all their states resident. Updates ``states``."""
    step_ms = {k: [] for k in steps}
    host = {k: [] for k in steps}
    for which in order:
        states[which], ms, h = _timed_steps(torch, steps[which], states[which], batch)
        step_ms[which].append(ms)
        host[which] += h
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    peak = {}
    for which in steps:
        torch.cuda.reset_peak_memory_stats()
        states[which], _ = steps[which](states[which], batch)
        torch.cuda.synchronize()
        peak[which] = torch.cuda.max_memory_allocated() / 2**30
    return step_ms, _host_medians(host), peak, resident


def _engine_setup(torch, *kernels):
    """The "resnet" variant (ResNet-50, lr 1e-4, batch 32) under each engine
    with fused Adam, the plain standard path (per-tensor Adam), one state
    and one synthetic batch."""
    import dataclasses

    from resnet_tpu_torch.config import ExecutionConfig, variant_config
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.train import init_train_state

    base = variant_config("resnet")
    cfgs = [dataclasses.replace(
        base, execution=dataclasses.replace(base.execution, kernels=k),
        optimizer=dataclasses.replace(base.optimizer, fused=True)) for k in kernels]
    pcfg = dataclasses.replace(base, execution=ExecutionConfig(),
                               optimizer=dataclasses.replace(base.optimizer, fused=False))
    state0 = init_train_state(cfgs[0], torch.Generator().manual_seed(SEED), device="cuda")
    data = next(SyntheticDataset(base.data.batch_size, image_dim=base.model.input_dim,
                                 num_classes=base.model.num_classes, seed=SEED))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    return cfgs, pcfg, state0, batch


def _busy(profile_rows):
    return sum(r["ms"] for r in profile_rows) if profile_rows else "not measured"


# the bf16 GEMM kernels a profiled step's device time is split by: the
# kernel names of the wgmma core's and bf16_gemm.cuh's (whose loader's name
# the profile's cut to 90 characters keeps), each row under the first entry
# one of whose keys it holds (a kernel's name may list FusedConvBfA among
# its arguments); the FC above 32 rows runs K1's forward kernel, and is
# counted under "K1 fwd bf16"
BF16_SPLIT = {"K1 dW bf16": ("conv2d_dw_wg_kernel", "ConvDwBfA"),
              "K1 fwd bf16": ("conv2d_fwd_wg_kernel",), "K1 dx bf16": ("conv2d_dx_wg_kernel",),
              "K3 fwd bf16": ("matmul_fwd_wg_kernel",),
              "K10 bf16 GEMMs": ("block_stage_wg_kernel",),
              "K8 bf16 GEMM": ("fused_conv_wg_kernel", "FusedConvBfA")}
# K10's kernels in a profiled blockfused step, by part (the split sum, the
# rows kernel and the join body are K10's alone there), under their names
# in this tree and in older ones (fused_conv_wg_kernel, join_vec), so a
# tree timed beside this one splits the same way; K9's in a fused step
K10_PARTS = {"gemms": ("block_stage_wg_kernel", "fused_conv_wg_kernel", "splitk_sum_stats_bf16"),
             "rows": ("tile_sums_affine",), "join": ("join_group", "join_vec", "join_scalar")}
K9_PARTS = {"join": ("join_group", "join_vec", "join_scalar")}


def _split(profile_rows, table=None):
    """{name: device ms, share of the step's busy time} of each entry of
    ``table`` (BF16_SPLIT by default) in one profiled step, a kernel under
    the first entry that names it."""
    busy = _busy(profile_rows)
    if not profile_rows:
        return "not measured"
    table = BF16_SPLIT if table is None else table
    ms = dict.fromkeys(table, 0.0)
    for r in profile_rows:
        name = next((n for n, keys in table.items() if any(k in r["kernel"] for k in keys)),
                    None)
        if name is not None:
            ms[name] += r["ms"]
    return {name: {"ms": t, "share": t / busy} for name, t in ms.items()}


def phase_fused(torch, checks, counters, smi):
    """The fused engine's training step: main path, one step against the
    plain standard path, the other two engines, times, memory, profile.

    The fused engine runs only with batch-statistics BN (bn_mode='batch'),
    so the frozen-BN tight check of phase 5 has no counterpart here: the
    gradients are held to the rule of phase 5's batch-statistics step."""
    from resnet_tpu_torch.train import make_train_step

    (fcfg, hcfg, xcfg), pcfg, state0, batch = _engine_setup(
        torch, "fused", "hybrid", "fusedxla")
    batch_n = fcfg.data.batch_size
    fstep = make_train_step(fcfg)

    state, losses, per_step, launches, final_loss = _train_main_path(
        torch, counters, fstep, fcfg, state0, batch, FUSED_PER_STEP, "fused train")
    compare, plain_loss = _engine_vs_plain(torch, fcfg, pcfg, state0, batch)
    others = {name: _other_step(counters, cfg, state0, batch, expect, plain_loss, name)
              for name, cfg, expect in (("hybrid", hcfg, HYBRID_PER_STEP),
                                        ("fusedxla", xcfg, FUSEDXLA_PER_STEP))}

    steps = {"plain": make_train_step(pcfg), "fusedxla": make_train_step(xcfg),
             "fused": fstep}
    states = {"plain": _clone(state0), "fusedxla": _clone(state0), "fused": state}
    step_ms, host_ms, peak, resident = _times_and_peaks(
        torch, steps, states, batch, ("plain", "fusedxla", "fused", "fused", "fusedxla", "plain"))

    def one_step():
        states["fused"], _ = fstep(states["fused"], batch)

    profile_rows = _profile(torch, one_step)
    median = {k: float(np.median(v)) for k, v in step_ms.items()}
    emit({"phase": "fused_train", "model": fcfg.model.name, "batch": batch_n,
          "device": smi, "launches": launches, "per_step": per_step[0],
          "losses": losses, "loss_after_last_step": final_loss, "compare": compare,
          "engines": others, "step_ms": step_ms, "host_step_ms": host_ms,
          "fused_step_ms": median["fused"], "fused_img_s": batch_n * 1e3 / median["fused"],
          "fusedxla_step_ms": median["fusedxla"],
          "fusedxla_img_s": batch_n * 1e3 / median["fusedxla"],
          "plain_step_ms": median["plain"], "plain_img_s": batch_n * 1e3 / median["plain"],
          "peak_gib": peak, "resident_before_gib": resident,
          "profile_device_busy_ms": _busy(profile_rows), "profile": profile_rows[:30]})
    return {k: v for k, v in launches.items() if v}


def phase_blockfused(torch, checks, counters, smi):
    """The whole-block engine's training step (kernels='blockfused', fused
    Adam): main path, one step against the plain standard path by the rules
    of phase 6, one step with conv_kernels='pallas', times in turns beside
    the fused engine's and the plain path's, memory, profile."""
    import dataclasses

    from resnet_tpu_torch.train import make_train_step

    (bcfg, fcfg), pcfg, state0, batch = _engine_setup(torch, "blockfused", "fused")
    batch_n = bcfg.data.batch_size
    bstep = make_train_step(bcfg)

    state, losses, per_step, launches, final_loss = _train_main_path(
        torch, counters, bstep, bcfg, state0, batch, BLOCKFUSED_PER_STEP, "blockfused train")
    compare, plain_loss = _engine_vs_plain(torch, bcfg, pcfg, state0, batch)
    pallas_cfg = dataclasses.replace(
        bcfg, execution=dataclasses.replace(bcfg.execution, conv_kernels="pallas"))
    with_pallas = _other_step(counters, pallas_cfg, state0, batch, BLOCKFUSED_PALLAS_PER_STEP,
                              plain_loss, "blockfused with conv_kernels='pallas'")

    steps = {"plain": make_train_step(pcfg), "blockfused": bstep,
             "fused": make_train_step(fcfg)}
    states = {"plain": _clone(state0), "blockfused": state, "fused": _clone(state0)}
    step_ms, host_ms, peak, resident = _times_and_peaks(
        torch, steps, states, batch,
        ("plain", "blockfused", "fused", "fused", "blockfused", "plain"))

    def one_step():
        states["blockfused"], _ = bstep(states["blockfused"], batch)

    profile_rows = _profile(torch, one_step)
    median = {k: float(np.median(v)) for k, v in step_ms.items()}
    emit({"phase": "blockfused_train", "model": bcfg.model.name, "batch": batch_n,
          "device": smi, "launches": launches, "per_step": per_step[0],
          "losses": losses, "loss_after_last_step": final_loss, "compare": compare,
          "conv_kernels_pallas": with_pallas, "step_ms": step_ms, "host_step_ms": host_ms,
          **{f"{k}_step_ms": v for k, v in median.items()},
          **{f"{k}_img_s": batch_n * 1e3 / v for k, v in median.items()},
          "peak_gib": peak, "resident_before_gib": resident,
          "profile_device_busy_ms": _busy(profile_rows), "profile": profile_rows[:30]})
    return {k: v for k, v in launches.items() if v}


def _bn_entry(torch, counters, bf16=False):
    """batch_norm_act, the public BN(+ReLU) entry point, forward and backward
    at the stem's shape with and without ReLU, on fp32 rows or (``bf16``)
    bf16 ones with fp32 γ and β: the counts of one call (1 moments, 1
    bias_act, 1 bn_bwd, on the bf16 entries for bf16), (y, mean, var)
    against bn_act_reference (plain torch ops), the gradients against the
    plain backward (bn_bwd_reference) at the statistics the entry point
    returned. fp32 outputs within ENTRY_TOL of max|plain|; in bf16, y and dx
    within one bf16 ulp + 1e-5 of max (``checks.bf16_slack``), the fp32
    statistics, dγ and dβ within 1e-5. Autograd through bn_act_reference
    would normalize with its own statistics, and an element whose
    x_hat * gamma + beta lies within rounding of 0 would pass its gradient
    through one ReLU gate and not the other. Returns (the result, the
    launches)."""
    from resnet_tpu_torch.kernels import bn, checks

    dtype = torch.bfloat16 if bf16 else torch.float32
    expect = _on_bf16(BN_ENTRY_PER_CALL) if bf16 else BN_ENTRY_PER_CALL
    m, c, eps = 32 * 112 * 112, 64, 1e-7
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = (torch.randn(m, c, generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
    gamma = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.5 * torch.randn(c, generator=gen, device="cuda")
    dy = torch.randn(m, c, generator=gen, device="cuda").to(dtype)

    launches, errs = {}, {}
    names = ("y", "mean", "var", "dx", "dgamma", "dbeta")
    for relu in (True, False):
        counters.zero()  # the main path: counters from 0, one call, counters read
        xs, g, b = (t.detach().requires_grad_(True) for t in (x, gamma, beta))
        y, mean, var = bn.batch_norm_act(xs, g, b, eps, relu)
        got = (y.detach(), mean, var, *torch.autograd.grad(y, (xs, g, b), dy))
        torch.cuda.synchronize()
        moved = {k: v for k, v in counters.read().items() if v}
        require(moved == expect, f"{dtype} batch_norm_act (relu={relu}) moved the "
                f"counters by {moved}, expected {expect}")
        for k, v in moved.items():
            launches[k] = launches.get(k, 0) + v
        want = (*bn.bn_act_reference(x, gamma, beta, eps, relu),
                *bn.bn_bwd_reference(x, dy, mean, torch.rsqrt(var + eps), gamma, beta,
                                     relu=relu))
        for name, a, b in zip(names, got, want, strict=True):
            require(a.dtype == b.dtype, f"batch_norm_act {name}: {a.dtype} vs {b.dtype}")
            scale = b.float().abs().max().item()
            diff = (a.float() - b.float()).abs()
            limit = (checks.bf16_slack(b) + checks.BF16_REL_TOL * scale if bf16
                     else ENTRY_TOL * scale)
            require(bool((diff <= limit).all()), f"{dtype} batch_norm_act (relu={relu}) "
                    f"{name}: max|kernel - plain| = {diff.max().item()} beyond its limit")
            errs[f"{name}{' relu' if relu else ''}"] = (diff.max().item() / scale if scale
                                                        else diff.max().item())
    return {"rows": m, "channels": c, "launches": launches, "max_rel_err": errs}, launches


def phase_bn_entry(torch, counters):
    """batch_norm_act in fp32 (``_bn_entry``)."""
    out, launches = _bn_entry(torch, counters)
    emit({"phase": "batch_norm_act", **out})
    return launches


def _step_record(torch, cfg, state0, batch):
    """One step of cfg from state0: its summed loss, batch statistics and
    gradients (loss_and_grads), then train_step's state and metrics with the
    peak memory of that step (GiB, all earlier allocations included) and
    the memory allocated before it."""
    from resnet_tpu_torch.train import loss_and_grads, make_train_step

    loss_sum, _, aux, grads = loss_and_grads(state0.params, batch, state0.bn_state, cfg)
    state = _clone(state0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    state, metrics = make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    return {"loss_sum": loss_sum, "bn_stats": aux["bn_stats"], "grads": grads,
            "state": state, "metrics": metrics,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "before_gib": before}


def _hold_to(torch, got, want, lr, what, spread=None, stat_tol=REMAT_STAT_TOL,
             grad_tol=REMAT_GRAD_TOL):
    """A step record against another from the same state (``_step_record``):
    summed loss, batch and running statistics within ``stat_tol`` of
    max|.|, every gradient leaf within ``grad_tol`` of its max or, where
    ``spread`` (path -> the path's own change between two runs, or under
    the image nudge) is given, GRAD_SENS times that change if larger; the
    parameters within 2 lr + 1e-6. Returns the errors and how many gradient
    leaves are equal bit for bit."""
    from resnet_tpu_torch.bridge import flatten, leaves

    la, lb = got["loss_sum"].item(), want["loss_sum"].item()
    require(abs(la - lb) <= stat_tol * abs(lb), f"{what}: summed loss {la} vs {lb}")
    stat_err, _, _ = _leaf_errors(got["bn_stats"], want["bn_stats"],
                                  f"{what} batch statistic", stat_tol)
    run_err, _, _ = _leaf_errors(got["state"].bn_state, want["state"].bn_state,
                                 f"{what} running statistic", stat_tol)
    grad_err, grad_spread, nearest = _leaf_errors(got["grads"], want["grads"],
                                                  f"{what} gradient", grad_tol,
                                                  sens=spread)
    pairs = list(zip(leaves(got["grads"]), leaves(want["grads"]), strict=True))
    equal = sum(bool(torch.equal(a, b)) for a, b in pairs)
    p_err = max((a - b).abs().max().item() for a, b in zip(
        leaves(got["state"].params), leaves(want["state"].params), strict=True))
    require(p_err <= 2 * lr + 1e-6, f"{what}: parameters differ by {p_err} > 2 lr + 1e-6")
    return {"loss_rel_err": abs(la - lb) / abs(lb), "batch_stats_max_rel_err": stat_err,
            "running_stats_max_rel_err": run_err, "grad_max_rel_err": grad_err,
            "grad_nearest_limit": nearest, "grad_leaves_bit_equal": equal,
            **({"grad_max_err_over_spread": grad_spread} if spread else {}),
            "grad_leaves": len(pairs), "param_max_abs_err": p_err,
            "loss": got["metrics"]["loss"].item(), "peak_gib": got["peak_gib"]}


def _run_spread(torch, cfg, state0, batch, grads):
    """Per gradient leaf, how far a second run of cfg's forward and backward
    from state0 moves it from ``grads``, and how many leaves it leaves
    equal bit for bit: the run-to-run change of a path whose cuDNN
    backward adds in no fixed order."""
    from resnet_tpu_torch.bridge import flatten, leaves
    from resnet_tpu_torch.train import loss_and_grads

    again = loss_and_grads(state0.params, batch, state0.bn_state, cfg)[3]
    spread = {path: (a - b).abs().max().item()
              for (path, a), b in zip(flatten(again), leaves(grads), strict=True)}
    return spread, sum(v == 0.0 for v in spread.values())


def _counted_record(torch, counters, cfg, state0, batch, expect, what):
    """``_step_record`` of cfg, its counter moves required to be ``expect``
    per step (twice over loss_and_grads and train_step, Adam once)."""
    before = counters.read()
    rec = _step_record(torch, cfg, state0, batch)
    delta = _moved(before, counters.read())
    want = {k: 2 * v if k != "adam" else v for k, v in expect.items()}
    require(delta == want, f"{what} moved the counters by {delta} over loss_and_grads "
            f"and train_step, expected {want}")
    return rec


def _remat_case(torch, counters, cfg, remat, expect, none_rec, state0, batch, what,
                spread=None):
    """One step of cfg under ``remat`` (counted, ``_counted_record``) held to
    the no-remat step ``none_rec`` (with ``spread``, the run-to-run change
    of a path on cuDNN and its count of equal leaves, ``_hold_to``), its
    peak memory required below that step's. Emits the result as a line too."""
    import dataclasses

    rcfg = dataclasses.replace(cfg, execution=dataclasses.replace(cfg.execution,
                                                                  remat=remat))
    rec = _counted_record(torch, counters, rcfg, state0, batch, expect, what)
    out = _hold_to(torch, rec, none_rec, cfg.optimizer.learning_rate, what,
                   spread and spread[0])
    out.update(none_peak_gib=none_rec["peak_gib"],
               step_gib=rec["peak_gib"] - rec["before_gib"],
               none_step_gib=none_rec["peak_gib"] - none_rec["before_gib"])
    if spread:
        out["none_twice_grad_leaves_bit_equal"] = spread[1]
    emit({"phase": "remat_case", "case": what, **out})
    require(rec["peak_gib"] < none_rec["peak_gib"], f"{what}: peak {rec['peak_gib']} GiB "
            f"is not below the no-remat step's {none_rec['peak_gib']}")
    return out


def _cudnn_remat_case(torch, counters, cfg, expect, state0, batch, what):
    """``_remat_case`` of block remat for a path on cuDNN convs, whose
    backward adds in no fixed order: the no-remat step, its run-to-run
    change (``_run_spread``), then the remat step held to both."""
    none_rec = _step_record(torch, cfg, state0, batch)
    spread = _run_spread(torch, cfg, state0, batch, none_rec["grads"])
    return _remat_case(torch, counters, cfg, "block", expect, none_rec, state0, batch, what,
                       spread=spread)


def _ghost_vjp(torch):
    """batch_norm_ghost's closed-form VJP against autograd of the sliced
    moments (batch_norm_ghost_reference) at the stem's and stage 1's shapes
    at batch GHOST_BATCH, k = GHOST_STATS: y, the statistics, dx, dgamma
    and dbeta, each within GHOST_TOL of its max."""
    from resnet_tpu_torch.ops.batchnorm import batch_norm_ghost, batch_norm_ghost_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    for h, c in ((112, 64), (56, 256)):
        x = torch.randn(GHOST_BATCH, h, h, c, generator=gen, device="cuda") * 2 + 0.5
        gamma = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.3 * torch.randn(c, generator=gen, device="cuda")
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        outs = []
        for fn in (batch_norm_ghost, batch_norm_ghost_reference):
            xs, g, b = (t.detach().requires_grad_(True) for t in (x, gamma, beta))
            y, (mean, var) = fn(xs, g, b, GHOST_STATS)
            outs.append((y.detach(), mean.detach(), var.detach(),
                         *torch.autograd.grad(y, (xs, g, b), dy)))
        for name, a, b in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"), *outs):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            require(err <= GHOST_TOL * scale, f"ghost BN ({h}^2, {c}) {name}: closed form "
                    f"vs plain {err} > {GHOST_TOL} * {scale}")
            errs[f"{name} ({h}^2, {c})"] = err / scale if scale else err
    return errs


def phase_remat(torch, counters, smi):
    """The clean variant (ResNet-50, batch 224, Adam lr 1e-4, kernels='pallas',
    remat='block') with conv_kernels='pallas' and fused Adam: main path (5
    steps, counters per step, loss falls); one step each of remat 'block',
    'stage' and 'elementwise' against the 'none' step from one state (counts,
    statistics, gradients, parameters, peak memory); the whole-block engine
    under block remat against its no-remat step; lowmem at batch 192; a
    ghost-BN step at batch 32 and the ghost VJP against its plain version;
    step times of 'none' and 'block' in turns, with host time and device
    busy time."""
    import dataclasses

    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.config import variant_config
    from resnet_tpu_torch.train import init_train_state, make_train_step

    torch.cuda.empty_cache()
    base = variant_config("clean")  # ResNet-50, kernels='pallas', remat='block', batch 224

    def with_(cfg, **execution):
        return dataclasses.replace(
            cfg, execution=dataclasses.replace(cfg.execution, **execution),
            optimizer=dataclasses.replace(cfg.optimizer, fused=True))

    def batch_of(n):
        data = next(SyntheticDataset(n, image_dim=base.model.input_dim,
                                     num_classes=base.model.num_classes, seed=SEED,
                                     distinct_batches=1))
        return {k: torch.from_numpy(v).cuda() for k, v in data.items()}

    cfg = with_(base, conv_kernels="pallas")
    batch_n = cfg.data.batch_size
    state0 = init_train_state(cfg, torch.Generator().manual_seed(SEED), device="cuda")
    batch = batch_of(batch_n)
    rstep = make_train_step(cfg)
    state, losses, per_step, launches, final_loss = _train_main_path(
        torch, counters, rstep, cfg, state0, batch, REMAT_PER_STEP, "remat train")
    del state

    none_cfg = with_(cfg, remat="none")
    none_rec = _step_record(torch, none_cfg, state0, batch)
    cases = {remat: _remat_case(torch, counters, none_cfg, remat, expect, none_rec, state0,
                                batch, f"remat={remat!r}")
             for remat, expect in (("block", REMAT_PER_STEP), ("stage", REMAT_PER_STEP),
                                   ("elementwise", ELEMENTWISE_PER_STEP))}
    del none_rec

    # the whole-block engine, with the preset's cuDNN convs elsewhere
    cases["blockfused block"] = _cudnn_remat_case(
        torch, counters, with_(base, kernels="blockfused", remat="none"),
        BLOCKFUSED_REMAT_PER_STEP, state0, batch, "blockfused, remat='block'")
    del state0, batch

    # lowmem: the plain path with block remat at its batch (no hand kernel)
    low = variant_config("lowmem")
    low_state0 = init_train_state(low, torch.Generator().manual_seed(SEED), device="cuda")
    cases["lowmem"] = _cudnn_remat_case(
        torch, counters, dataclasses.replace(low, execution=dataclasses.replace(
            low.execution, remat="none")), {}, low_state0, batch_of(low.data.batch_size),
        "lowmem")
    cases["lowmem"]["batch"] = low.data.batch_size
    del low_state0

    # ghost BN at batch 32: one step, then the VJP against its plain version
    gcfg = with_(dataclasses.replace(base, data=dataclasses.replace(
        base.data, batch_size=GHOST_BATCH)), conv_kernels="pallas", remat="none",
        bn_stats_batch=GHOST_STATS)
    gstate0 = init_train_state(gcfg, torch.Generator().manual_seed(SEED), device="cuda")
    gbatch = batch_of(GHOST_BATCH)
    grec = _counted_record(torch, counters, gcfg, gstate0, gbatch, GHOST_PER_STEP,
                           "ghost BN")
    require(np.isfinite(grec["metrics"]["loss"].item()), "ghost BN: non-finite loss")
    ghost = {"batch": GHOST_BATCH, "bn_stats_batch": GHOST_STATS, "per_step": GHOST_PER_STEP,
             "loss": grec["metrics"]["loss"].item(), "vjp_max_rel_err": _ghost_vjp(torch)}
    del grec, gstate0, gbatch

    # step times in turns: none, block, block, none
    state0 = init_train_state(cfg, torch.Generator().manual_seed(SEED), device="cuda")
    batch = batch_of(batch_n)
    steps = {"none": make_train_step(none_cfg), "block": rstep}
    states = {"none": _clone(state0), "block": state0}
    step_ms, host_ms, peak, resident = _times_and_peaks(
        torch, steps, states, batch, ("none", "block", "block", "none"))
    busy = {}
    for which in steps:
        def one_step(which=which):
            states[which], _ = steps[which](states[which], batch)

        busy[which] = _busy(_profile(torch, one_step))
    median = {k: float(np.median(v)) for k, v in step_ms.items()}
    emit({"phase": "remat_train", "model": cfg.model.name, "batch": batch_n, "device": smi,
          "launches": launches, "per_step": per_step[0], "losses": losses,
          "loss_after_last_step": final_loss, "compare": cases, "ghost_bn": ghost,
          "step_ms": step_ms, "host_step_ms": host_ms,
          **{f"{k}_step_ms": v for k, v in median.items()},
          **{f"{k}_img_s": batch_n * 1e3 / v for k, v in median.items()},
          "profile_device_busy_ms": busy, "timed_peak_gib": peak,
          "resident_before_gib": resident})
    return {k: v for k, v in launches.items() if v}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Cli:
    """One run of the port's CLI in a subprocess (CLI_MAIN), its output in
    files under ``log_dir``; a run that fails prints its stderr and fails
    the phase. With ``ranks`` the run is that many ranks on this machine
    under torchrun, as a user starts them (cli.py's docstring), in a
    session of their own that ``stop`` ends whole."""

    def __init__(self, name, args, log_dir, ranks=0):
        self.name = name
        self.out_path = os.path.join(log_dir, f"{name}.out")
        self.err_path = os.path.join(log_dir, f"{name}.err")
        cmd = [sys.executable, "-c", CLI_MAIN, *args]
        if ranks:
            cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                   "--nproc-per-node", str(ranks), "--rdzv-backend", "c10d",
                   "--rdzv-endpoint", f"localhost:{_free_port()}", "--no-python", *cmd]
        self.t0 = time.perf_counter()
        with open(self.out_path, "w") as out, open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err,
                                         stdin=subprocess.DEVNULL,
                                         start_new_session=bool(ranks))
        self.ranks = ranks
        self.seconds = None

    def _fail(self, what):
        with open(self.err_path) as f:
            print(f.read()[-8000:], file=sys.stderr, flush=True)
        raise RuntimeError(f"CLI run {self.name}: {what}")

    def wait(self, timeout=900) -> str:
        """The run's stdout, once it exited with 0."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            self._fail(f"still running after {timeout} s")
        if self.seconds is None:
            self.seconds = time.perf_counter() - self.t0
        if self.ranks:
            self.stop()  # no rank outlives torchrun
        if rc != 0:
            self._fail(f"exited with {rc}")
        with open(self.out_path) as f:
            return f.read()

    def kill_after_dump(self, dump_dir, at_least, timeout=900):
        """SIGKILL the run once a dump with id >= at_least is published."""
        from resnet_tpu_torch.train import discover_latest_dump

        deadline = time.perf_counter() + timeout
        while True:
            latest = discover_latest_dump(dump_dir)
            if latest is not None and latest >= at_least:
                break
            if self.proc.poll() is not None:
                self._fail(f"ended with {self.proc.returncode} before dump {at_least}")
            if time.perf_counter() > deadline:
                self.stop()
                self._fail(f"no dump {at_least} after {timeout} s")
            time.sleep(0.02)
        self.stop()
        self.seconds = time.perf_counter() - self.t0

    def stop(self):
        if self.ranks:  # torchrun and its ranks
            try:
                os.killpg(self.proc.pid, 9)
            except ProcessLookupError:
                pass
        elif self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def _wait_all(runs, timeout=900):
    """Wait for runs started side by side, each one's wall time taken when
    it ends; returns their stdout."""
    deadline = time.perf_counter() + timeout
    while any(r.seconds is None and r.proc.poll() is None for r in runs):
        if time.perf_counter() > deadline:
            break  # wait() below fails the late ones
        time.sleep(0.02)
    for r in runs:
        if r.seconds is None and r.proc.poll() is not None:
            r.seconds = time.perf_counter() - r.t0
    return [r.wait(timeout=1) for r in runs]


def _cli_args(shards, dump_dir):
    """The trainer command of phase 10 (the reference "resnet" variant's
    settings, every hand kernel but fused Adam, which the CLI has no flag for)."""
    return ["--model", "resnet50", "--kernels", "pallas", "--conv-kernels", "pallas",
            "--batch-size", "32", "--lr", "1e-4", "--shard-dir", shards,
            "--num-shards", str(SHARDS), "--shard-images", str(SHARD_IMAGES),
            "--checkpoint-every", str(CLI_EVERY), "--checkpoint-dir", dump_dir,
            "--log-every", "1", "--device", "cuda"]


def _dump_diff(a, b, what):
    """Dump a against dump b: each leaf of the parameters, moments and
    running statistics within RESUME_TOL of b's max|.|, and the checkpoint
    fields (cursor, step, optimizer step, decay products) equal. Returns the
    largest error as a share of max|.| and the leaves equal bit for bit."""
    from resnet_tpu_torch.train.checkpoint import parse_trainer_checkpoint

    worst, equal = 0.0, {}
    for sub in ("model_params", "means", "vars", "bn_state"):
        names = sorted(os.listdir(os.path.join(b, sub)))
        require(sorted(os.listdir(os.path.join(a, sub))) == names, f"{what}: {sub} differs")
        n_equal = 0
        for name in names:
            x = np.fromfile(os.path.join(a, sub, name), np.float32)
            y = np.fromfile(os.path.join(b, sub, name), np.float32)
            require(x.shape == y.shape, f"{what} {sub}/{name}: {x.shape} vs {y.shape}")
            scale, err = float(np.abs(y).max()), float(np.abs(x - y).max())
            require(err <= RESUME_TOL * scale, f"{what} {sub}/{name}: max|a - b| = {err} > "
                    f"{RESUME_TOL} * {scale}")
            worst = max(worst, err / scale if scale else 0.0)
            n_equal += x.tobytes() == y.tobytes()
        equal[sub] = [n_equal, len(names)]
    ca, cb = (parse_trainer_checkpoint(os.path.join(d, "trainer_checkpoint.txt"))
              for d in (a, b))
    require(ca == cb, f"{what}: trainer_checkpoint.txt {ca} vs {cb}")
    return worst, equal


def _jsonl_losses(dump_dir):
    """step -> loss of metrics.jsonl, the last record of each step."""
    with open(os.path.join(dump_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["loss"] for r in recs}, len(recs)


def phase_trainer(torch, counters, smi):
    """The trainer from disk: shards written, the in-process Trainer (launch
    counts per step, the queue depth, an async dump under fused Adam against
    a sync one, the snapshot alone, step times), then the CLI: an
    uninterrupted run U, a run K killed by SIGKILL after a dump, K resumed
    from its latest dump (R) against U, evaluation and export of U's final
    dump."""
    import dataclasses

    from resnet_tpu_torch.config import variant_config
    from resnet_tpu_torch.data import ShardDataset, write_shard
    from resnet_tpu_torch.data.procedural import ProceduralDataset, ProceduralIterator
    from resnet_tpu_torch.export import load_inference
    from resnet_tpu_torch.models import forward
    from resnet_tpu_torch.ops import cross_entropy
    from resnet_tpu_torch.ops.precision import precision_scope
    from resnet_tpu_torch.train import FINAL_DUMP_ID, Trainer, init_train_state
    from resnet_tpu_torch.train import discover_latest_dump, restore_checkpoint
    from resnet_tpu_torch.train.checkpoint import _host, dump_id_dir
    from resnet_tpu_torch.train.cli import build_config

    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    base = variant_config("resnet")  # ResNet-50, kernels='pallas', lr 1e-4, batch 32
    mcfg, batch_n = base.model, base.data.batch_size
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            # 1. the shards: NCHW on disk, as build_training_shards.c writes them
            shards = os.path.join(tmp, "shards")
            t0 = time.perf_counter()
            stream = ProceduralIterator(ProceduralDataset(
                num_classes=100, image_dim=mcfg.input_dim, seed=SEED), SHARD_IMAGES, seed=SEED)
            for s in range(SHARDS):
                b = next(stream)
                write_shard(shards, s, b["images"].transpose(0, 3, 1, 2), b["labels"])
            shard_s = time.perf_counter() - t0

            # 6-7. the in-process Trainer first, alone on the card: every hand
            # kernel and fused Adam, async dumps every 2 steps, the finite check
            cfg = dataclasses.replace(
                base, execution=dataclasses.replace(base.execution, conv_kernels="pallas"),
                optimizer=dataclasses.replace(base.optimizer, fused=True),
                data=dataclasses.replace(base.data, shard_dir=shards, num_shards=SHARDS,
                                         shard_images=SHARD_IMAGES, layout="NCHW"),
                async_checkpoint=True, checkpoint_every=2, check_errors=True,
                checkpoint_dir=os.path.join(tmp, "async"), log_every=0)

            def timed_steps(t, n):
                """n steps of Trainer t, one run(1) each, on the host clock
                ending in a synchronize; the counters' moves and the prefetch
                queue's depth after each."""
                ms, moved, depth = [], [], []
                for _ in range(n):
                    before = counters.read()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    t.run(1)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    moved.append(_moved(before, counters.read()))
                    depth.append(t._dev_iter.qsize())
                return ms, moved, depth

            trainer = Trainer(cfg, device="cuda")
            counters.zero()
            step_ms, per_step, qsize = timed_steps(trainer, TRAINER_STEPS)
            launches = counters.read()
            for i, delta in enumerate(per_step):
                require(delta == PER_STEP, f"trainer step {i} moved the counters by {delta}, "
                        f"expected {PER_STEP}")
            loader = trainer.loader
            trainer.finalize()
            # a dump's snapshot alone (the state to owned host memory), no
            # write in flight
            snapshot_ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _host(trainer.state)
                snapshot_ms.append((time.perf_counter() - t0) * 1e3)
            # a sync run from the same seed: its dump at step 4 against the
            # async one, which the in-place Adam of step 4 could have torn
            synced = Trainer(dataclasses.replace(cfg, async_checkpoint=False,
                                                 checkpoint_dir=os.path.join(tmp, "sync")),
                             device="cuda")
            sync_ms, _, _ = timed_steps(synced, 5)
            synced.finalize()
            async_err, async_equal = _dump_diff(
                dump_id_dir(cfg.checkpoint_dir, 4), dump_id_dir(synced.cfg.checkpoint_dir, 4),
                "async vs sync dump 4")
            # the input pipeline alone (no dumps, no finite check): run(8),
            # metrics read one step behind, against 8 of the same Trainer's
            # bare train_step on a batch staged on the card, in turns
            plain_loop = Trainer(dataclasses.replace(
                cfg, async_checkpoint=False, checkpoint_every=0, check_errors=False,
                checkpoint_dir=""), device="cuda")
            plain_loop.run(2)  # the new state's first calls
            staged = dict(next(plain_loop._device_iter()))
            staged.pop("cursor")
            loops = {"bare": [], "trainer": []}
            for which in ("bare", "trainer", "trainer", "bare"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if which == "bare":
                    for _ in range(8):
                        plain_loop.state, _ = plain_loop.train_step(plain_loop.state, staged)
                else:
                    plain_loop.run(8)
                torch.cuda.synchronize()
                loops[which].append((time.perf_counter() - t0) * 1e3 / 8)
            plain_loop.finalize()
            del trainer, synced, plain_loop
            for d in ("async", "sync"):
                shutil.rmtree(os.path.join(tmp, d))
            torch.cuda.empty_cache()
            in_process_s = time.perf_counter() - phase_t0

            # 2-3. U, and K killed once a dump >= 4 is published, side by side
            cu, ck = os.path.join(tmp, "U"), os.path.join(tmp, "K")
            u = _Cli("U", _cli_args(shards, cu) + ["--steps", str(CLI_STEPS)],
                     tmp)
            runs.append(u)
            k = _Cli("K", _cli_args(shards, ck)
                     + ["--async-checkpoint", "--steps", "40"], tmp)
            runs.append(k)
            k.kill_after_dump(ck, CLI_EVERY)
            latest = discover_latest_dump(ck)
            require(latest is not None and latest % CLI_EVERY == 0 and latest < CLI_STEPS,
                    f"latest dump of the killed run: {latest}")
            left_tmp = sorted(n for n in os.listdir(ck) if ".tmp-" in n)

            # 4. R, K resumed, beside U; 5. eval and export of U's final dump
            # once U ends, beside R
            r = _Cli("R", _cli_args(shards, ck)
                     + ["--resume-from", "latest", "--steps", str(CLI_STEPS - latest)], tmp)
            runs.append(r)
            u_out, = _wait_all([u])
            ev = _Cli("eval", _cli_args(shards, cu)
                      + ["--evaluate", "--resume-from", "latest", "--eval-batches", "2"], tmp)
            runs.append(ev)
            art = os.path.join(tmp, "resnet50.pt")
            ex = _Cli("export", _cli_args(shards, cu)
                      + ["--resume-from", "latest", "--export", art], tmp)
            runs.append(ex)
            r_out, ev_out, ex_out = _wait_all([r, ev, ex])
        finally:
            for run in runs:
                run.stop()

        # U: its dumps, its 24 steps, the final cursor, the loss
        u_loader = "native" if "input: native loader" in u_out else "python"
        dumps = sorted(int(n) for n in os.listdir(cu) if n.isdigit())
        want = [*range(0, CLI_STEPS, CLI_EVERY), FINAL_DUMP_ID]
        require(dumps == want, f"U's dumps {dumps}, expected {want}")
        u_losses, n_lines = _jsonl_losses(cu)
        require(n_lines == CLI_STEPS and sorted(u_losses) == list(range(CLI_STEPS)),
                f"U's metrics.jsonl holds {n_lines} lines, steps {sorted(u_losses)}")
        ucfg, _ = build_config(_cli_args(shards, cu))
        state, cursor = restore_checkpoint(cu, FINAL_DUMP_ID,
                                           init_train_state(ucfg, device="cuda"))
        final_cursor = (cursor.shard, cursor.batch_in_shard, cursor.epoch)
        require(final_cursor == FINAL_CURSOR[u_loader],
                f"U's final cursor {final_cursor} ({u_loader} loader), expected "
                f"{FINAL_CURSOR[u_loader]}")
        images, labels = ShardDataset(shards, num_shards=SHARDS, shard_images=SHARD_IMAGES,
                                      image_dim=mcfg.input_dim).open_shard(0)
        x = torch.from_numpy(np.ascontiguousarray(images[:batch_n].transpose(0, 2, 3, 1)))
        x, y = x.to("cuda"), torch.from_numpy(np.array(labels[:batch_n])).to("cuda")
        with torch.no_grad(), precision_scope(ucfg.execution):
            # step 0's batch again, after the last update
            logits, _ = forward(state.params, x, ucfg.model, ucfg.execution, train=True,
                                bn_state=state.bn_state)
            final_loss = cross_entropy(logits, y, reduction="mean").item()
            want_logits, _ = forward(state.params, x, ucfg.model, ucfg.execution,
                                     train=False, bn_state=state.bn_state)
        require(np.isfinite(final_loss) and final_loss < u_losses[0],
                f"U: loss on step 0's batch after {CLI_STEPS} steps {final_loss} is not "
                f"below the first {u_losses[0]}")

        # K and R against U
        require(f"resumed from dump {latest} at step {latest}" in r_out,
                "R did not report its resume")
        resume_err, resume_equal = _dump_diff(dump_id_dir(ck, FINAL_DUMP_ID),
                                              dump_id_dir(cu, FINAL_DUMP_ID), "R vs U")
        r_losses, _ = _jsonl_losses(ck)
        for s in range(latest, CLI_STEPS):
            require(abs(r_losses[s] - u_losses[s]) <= RESUME_TOL * abs(u_losses[s]),
                    f"step {s}: R's loss {r_losses[s]} vs U's {u_losses[s]}")
        n_equal_losses = sum(r_losses[s] == u_losses[s] for s in range(latest, CLI_STEPS))

        # eval and export
        line = next((ln for ln in ev_out.splitlines() if ln.startswith("eval over 2 batches")),
                    None)
        require(line is not None, f"no eval line in: {ev_out[-2000:]}")
        eval_metrics = {k: float(v) for k, v in (f.split("=") for f in line.split()[4:])}
        require(all(np.isfinite(v) for v in eval_metrics.values()), f"eval: {line}")
        require("exported serving artifact" in ex_out, "export printed no artifact")
        got = load_inference(art, device="cuda").call(x)
        scale = want_logits.abs().max().item()
        export_err = (got - want_logits).abs().max().item()
        require(export_err <= LOGIT_TOL * scale, f"exported logits differ by {export_err} > "
                f"{LOGIT_TOL} * {scale}")

    loop_median = {k: float(np.median(v)) for k, v in loops.items()}
    emit({"phase": "trainer", "model": mcfg.name, "batch": batch_n, "device": smi,
          "phase_s": time.perf_counter() - phase_t0, "in_process_s": in_process_s,
          "shards": [SHARDS, SHARD_IMAGES], "shard_write_s": shard_s,
          "launches": launches, "per_step": per_step[0], "loader": loader,
          "qsize": qsize, "async_vs_sync_dump4": {"max_rel_err": async_err,
                                                  "bit_equal": async_equal},
          "step_ms": step_ms, "step_ms_median_2_5": float(np.median(step_ms[2:6])),
          "sync_dump_run_step_ms": sync_ms, "snapshot_ms": snapshot_ms,
          "loop_ms_per_step": loops,
          "loop_over_bare_in_turns": loop_median["trainer"] / loop_median["bare"] - 1,
          "cli": {"loader": u_loader, "dumps": dumps, "final_cursor": final_cursor,
                  "first_loss": u_losses[0], "loss_after_last_step": final_loss,
                  "killed_after_dump": latest, "tmp_dirs_left": left_tmp,
                  "resume_max_rel_err": resume_err, "resume_bit_equal": resume_equal,
                  "param_leaves_bit_equal": resume_equal["model_params"],
                  "resumed_losses_equal": [n_equal_losses, CLI_STEPS - latest],
                  "eval": eval_metrics, "export_max_err": export_err,
                  "export_max_abs_logit": scale,
                  "seconds": {run.name: run.seconds for run in runs}}})
    return {k: v for k, v in launches.items() if v}


def _to_nchw(batch):
    return dict(batch, images=batch["images"].permute(0, 3, 1, 2).contiguous())


def _gap_held(got, want, ref, what, floor=None, sens=None):
    """Arrays (loss, statistics, gradients: trees of tensors) of a bf16 step
    ``got`` against the plain bf16 step ``want`` from the same state, within
    2x the gap between ``want`` and the plain fp32 step ``ref`` (bf16 rounds
    at other places on the two paths), as shares of max|want|. With
    ``floor`` None the gap is pooled, its largest over all arrays; else each
    array has its own gap, at least ``floor``, or where ``sens`` (path ->
    want's own change under the bf16 image nudge) is given, GRAD_SENS times
    that change if larger. Returns the largest gap, the largest
    max|got - want| / max|want|, the least and median limit and the array
    nearest its limit."""
    from resnet_tpu_torch.bridge import flatten, leaves

    trios = list(zip(flatten(got), leaves(want), leaves(ref), strict=True))

    def amax(t):
        return max(t.float().abs().max().item(), 1e-30)

    def rel(a, b):
        return (a.float() - b.float()).abs().max().item() / amax(b)

    gaps = [rel(w, r) for _, w, r in trios]
    if floor is None:
        limits = [2 * max(gaps)] * len(gaps)
    else:
        limits = [max(2 * max(gap, floor),
                      GRAD_SENS * sens[path] / amax(w) if sens is not None else 0.0)
                  for ((path, _), w, _), gap in zip(trios, gaps)]
    worst, nearest = 0.0, None
    for ((path, g), w, _), limit in zip(trios, limits):
        err = rel(g, w)
        require(err <= limit, f"{what} {path}: max|kernel - plain| is {err:.3e} of "
                f"max|plain|, beyond its limit {limit:.3e}")
        worst = max(worst, err)
        if nearest is None or err / limit > nearest["err"] / nearest["limit"]:
            nearest = {"leaf": path, "err": err, "limit": limit}
    return {"gap_plain_bf16_vs_fp32": max(gaps),
            "median_gap_plain_bf16_vs_fp32": float(np.median(gaps)),
            "max_rel_err_vs_plain_bf16": worst, "least_limit": min(limits),
            "median_limit": float(np.median(limits)), "nearest_limit": nearest}


def _bf16_frozen_held(kcfg, p16, p32, state0, batch):
    """The well-conditioned check of a bf16 kernel step: the gradients of
    the kernel, plain bf16 and plain fp32 configs from state0 with BN
    frozen at its running statistics, the kernel's held to the plain bf16
    one per leaf by ``_gap_held``'s rule (2x its own gap to fp32, at least
    BF16_UNIT, or GRAD_SENS x the plain bf16 step's change under the bf16
    image nudge). With batch statistics bf16's rounding alone moves half
    the leaves by more than their max; here it moves them by a few percent,
    so a bf16 dW 10% off fails."""
    import dataclasses

    from resnet_tpu_torch.train import loss_and_grads

    def frozen(cfg):
        return dataclasses.replace(
            cfg, execution=dataclasses.replace(cfg.execution, bn_mode="frozen"))

    grads = {k: loss_and_grads(state0.params, batch, state0.bn_state, frozen(c))[3]
             for k, c in (("kernel", kcfg), ("plain", p16), ("fp32", p32))}
    sens = _nudge_sensitivity(batch, state0.params, state0.bn_state, frozen(p16),
                              grads["plain"], BF16_UNIT)
    return _gap_held(grads["kernel"], grads["plain"], grads["fp32"],
                     "bf16 kernel step, BN frozen, grads", BF16_UNIT, sens)


def _bf16_held(torch, kcfg, state0, batch):
    """Phase 11's hold of a bf16 kernel step on state0: the kernel, plain
    bf16 (kernels='xla', per-tensor Adam) and plain fp32 steps' records,
    the loss and the running statistics within 2x their pooled gap to the
    plain fp32 step, each gradient leaf within 2x its own gap (at least
    BF16_UNIT) or GRAD_SENS x the plain bf16 step's change under the bf16
    image nudge, and the same three steps' gradients with BN frozen at the
    running statistics (``_bf16_frozen_held``), the well-conditioned check.
    Returns those errors and the three steps' losses."""
    import dataclasses

    def plain(compute):
        return dataclasses.replace(
            kcfg, execution=dataclasses.replace(kcfg.execution, kernels="xla",
                                                conv_kernels="xla", compute_dtype=compute),
            optimizer=dataclasses.replace(kcfg.optimizer, fused=False))

    p16, p32 = plain("bfloat16"), plain("float32")
    recs = {k: _step_record(torch, c, state0, batch)
            for k, c in (("kernel", kcfg), ("plain", p16), ("fp32", p32))}
    sens = _nudge_sensitivity(batch, state0.params, state0.bn_state, p16,
                              recs["plain"]["grads"], BF16_UNIT)
    held = {}
    for what, pick, floor in (("loss", lambda r: {"loss": r["loss_sum"]}, None),
                              ("running_stats", lambda r: r["state"].bn_state, None),
                              ("grads", lambda r: r["grads"], BF16_UNIT)):
        held[what] = _gap_held(pick(recs["kernel"]), pick(recs["plain"]),
                               pick(recs["fp32"]), f"{kcfg.model.name} bf16 kernel step {what}",
                               floor, sens if floor else None)
    losses = {k: r["metrics"]["loss"].item() for k, r in recs.items()}
    del recs, sens
    held["frozen_bn_grads"] = _bf16_frozen_held(kcfg, p16, p32, state0, batch)
    return held, losses


def _cudnn_off_witness(torch, want_run, got_run, state0, want_on, got_on, nudge):
    """The witness that the NCHW-vs-NHWC gradient gap with cuDNN on comes
    from the order of sums, not from the layout: the same two steps
    (cfg, batch) from state0 with cuDNN off, where both layouts convolve by
    PyTorch's own im2col and cuBLAS GEMM on the same NCHW values, so that
    only the BN, pooling and FC sums run in other orders. With batch
    statistics each gradient leaf must then come within GRAD_TOL of its max
    or GRAD_SENS x ``nudge`` (the phase-5 rule); with BN frozen at the
    initial running statistics, where nothing amplifies the order of a sum,
    within REMAT_GRAD_TOL of its max. Returns those errors, the frozen-BN
    gap with cuDNN on beside them, and the leaf farthest apart with batch
    statistics and cuDNN on with its gap on and off (shares of its max)."""
    import dataclasses

    from resnet_tpu_torch.bridge import flatten, leaves
    from resnet_tpu_torch.train import loss_and_grads

    def pair(frozen):
        return [loss_and_grads(state0.params, batch, state0.bn_state, dataclasses.replace(
            cfg, execution=dataclasses.replace(cfg.execution, bn_mode="frozen"))
            if frozen else cfg)[3] for cfg, batch in (want_run, got_run)]

    def rel(got, want):
        return {path: (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                for (path, a), b in zip(flatten(got), leaves(want), strict=True)}

    frozen_want, frozen_got = pair(True)
    frozen_on = max(rel(frozen_got, frozen_want).values())
    torch.backends.cudnn.enabled = False
    try:
        want_off, got_off = pair(False)
        frozen_want, frozen_got = pair(True)
    finally:
        torch.backends.cudnn.enabled = True
    on, off = rel(got_on, want_on), rel(got_off, want_off)
    err, over_sens, nearest = _leaf_errors(got_off, want_off, "nchw vs nhwc with cuDNN off "
                                           "gradient", GRAD_TOL, sens=nudge)
    frozen_err, _, frozen_nearest = _leaf_errors(
        frozen_got, frozen_want, "nchw vs nhwc with cuDNN off, BN frozen, gradient",
        REMAT_GRAD_TOL)
    worst = max(on, key=on.get)
    return {"grad_max_rel_err": err, "grad_max_err_over_sensitivity": over_sens,
            "grad_nearest_limit": nearest, "leaves_closer_than_cudnn_on":
            sum(off[p] < on[p] for p in on), "grad_leaves": len(on),
            "farthest_leaf_cudnn_on": {"leaf": worst, "on": on[worst], "off": off[worst]},
            "frozen_bn": {"grad_max_rel_err": frozen_err, "grad_nearest_limit": frozen_nearest,
                          "cudnn_on_grad_max_rel_err": frozen_on}}


def _preset_run(torch, counters, cfg, state0, batch, expect, what):
    """A preset's main run (``_train_main_path``: counters per step, loss
    falls), then 5 timed steps and the peak memory of one more."""
    from resnet_tpu_torch.train import make_train_step

    step = make_train_step(cfg)
    state, losses, per_step, launches, final_loss = _train_main_path(
        torch, counters, step, cfg, state0, batch, expect, what)
    state, ms, host = _timed_steps(torch, step, state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    return state, {"batch": int(batch["labels"].shape[0]), "per_step": per_step[0],
                   "losses": losses, "loss_after_last_step": final_loss, "step_ms": ms,
                   "host_step_ms": float(np.median(host)), "peak_gib": peak}, launches


def phase_presets(torch, counters, smi):
    """The last two presets and bf16 on the hand kernels, at full width
    (ResNet-50, 224^2, one SyntheticDataset batch at seed 1234): bf16 on
    every standard-path kernel at batch 32 (the standard step's counts on
    the bf16 entries, one step held to the plain bf16 step within 2x that
    step's gap to the plain fp32 step, pooled for the loss and the running
    statistics, per gradient leaf at least BF16_UNIT; parameters fp32);
    'fast' at 192 (no hand kernel); 'nchw' at 192, one step held to the
    NHWC plain step on the transposed images (loss and statistics within
    1e-4, gradients within GRAD_SENS x the larger of cuDNN's run-to-run
    change and the image-nudge sensitivity), then both steps again with
    cuDNN off (``_cudnn_off_witness``); NCHW on the hand kernels at 32
    (no K4), held to the NHWC kernel step; the served bf16 forward at batch
    8, NHWC and NCHW, against the plain fp32 logits, then timed as phase 4
    times its batch 8 (CUDA events, and its device time)."""
    import dataclasses

    from resnet_tpu_torch.bridge import flatten, leaves
    from resnet_tpu_torch.config import ExecutionConfig, variant_config
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.export import export_inference
    from resnet_tpu_torch.kernels import checks
    from resnet_tpu_torch.train import init_train_state, make_train_step

    torch.cuda.empty_cache()

    def with_(cfg, fused=None, **execution):
        opt = cfg.optimizer if fused is None else dataclasses.replace(cfg.optimizer,
                                                                      fused=fused)
        return dataclasses.replace(
            cfg, execution=dataclasses.replace(cfg.execution, **execution), optimizer=opt)

    def setup(cfg):
        state0 = init_train_state(cfg, torch.Generator().manual_seed(SEED), device="cuda")
        data = next(SyntheticDataset(cfg.data.batch_size, image_dim=cfg.model.input_dim,
                                     num_classes=cfg.model.num_classes, seed=SEED))
        return state0, {k: torch.from_numpy(v).cuda() for k, v in data.items()}

    out, launched = {}, {}

    def add(launches):
        for k, v in launches.items():
            if v:
                launched[k] = launched.get(k, 0) + v

    # 1. bf16 on every standard-path hand kernel, batch 32
    base = variant_config("resnet")
    kcfg = with_(base, fused=True, conv_kernels="pallas", compute_dtype="bfloat16")
    state0, batch = setup(kcfg)
    state, run, launches = _preset_run(torch, counters, kcfg, state0, batch, BF16_PER_STEP,
                                       "bf16 kernels")
    add(launches)
    require(all(p.dtype is torch.float32 for p in leaves(state.params)),
            "bf16 compute changed the parameters' dtype")
    held_state, kstep = {"state": state}, make_train_step(kcfg)
    del state

    def one_step():
        held_state["state"], _ = kstep(held_state["state"], batch)

    rows = _profile(torch, one_step)
    run.update(profile=rows[:30], profile_device_busy_ms=_busy(rows),
               profile_split=_split(rows))
    del held_state, kstep, rows
    held, losses = _bf16_held(torch, kcfg, state0, batch)
    run.update(vs_plain_bf16=held, loss=losses)
    out["bf16_kernels"] = run
    del state0, batch

    # 2. fast at 192: the plain path in bf16 (cuDNN), cap 10, TF32 allowed
    fast = variant_config("fast")
    require(fast.data.batch_size == PRESET_BATCH, f"fast batch {fast.data.batch_size}")
    state0, batch = setup(fast)
    state, out["fast"], launches = _preset_run(torch, counters, fast, state0, batch, {},
                                               "fast")
    add(launches)
    del state, state0, batch
    torch.cuda.empty_cache()

    # 3. nchw at 192: NCHW cuDNN, held to the NHWC plain step
    nchw = variant_config("nchw")
    require(nchw.data.batch_size == PRESET_BATCH, f"nchw batch {nchw.data.batch_size}")
    state0, batch = setup(nchw)
    state, out["nchw"], launches = _preset_run(torch, counters, nchw, state0,
                                               _to_nchw(batch), {}, "nchw")
    add(launches)
    del state
    nhwc = with_(nchw, layout="NHWC")
    want = _step_record(torch, nhwc, state0, batch)
    spread, equal = _run_spread(torch, nhwc, state0, batch, want["grads"])
    nudge = _nudge_sensitivity(batch, state0.params, state0.bn_state, nhwc, want["grads"])
    got = _step_record(torch, nchw, state0, _to_nchw(batch))
    # cuDNN takes other algorithms for NCHW, which sum in other orders than
    # NHWC's: a gradient passes within GRAD_SENS x the larger of the NHWC
    # step's run-to-run change and its change under the image nudge
    sens = {path: max(spread[path], nudge[path]) for path in spread}
    out["nchw"]["vs_nhwc"] = _hold_to(torch, got, want, nchw.optimizer.learning_rate,
                                      "nchw vs nhwc", sens, stat_tol=LAYOUT_TOL)
    out["nchw"]["vs_nhwc"].update(
        nhwc_twice_grad_leaves_bit_equal=equal,
        grad_leaves_within_4x_run_to_run=sum(
            (a - b).abs().max().item() <= GRAD_SENS * spread[path]
            for (path, a), b in zip(flatten(got["grads"]), leaves(want["grads"]))))
    out["nchw"]["vs_nhwc_cudnn_off"] = _cudnn_off_witness(
        torch, (nhwc, batch), (nchw, _to_nchw(batch)), state0, want["grads"], got["grads"],
        nudge)
    del want, got, spread, nudge, state0, batch
    torch.cuda.empty_cache()

    # 4. NCHW on the hand kernels at 32: no K4; held to the NHWC kernel step
    # (its statistics are K4's, NCHW's the plain sums: gradients by the
    # phase-5 rule, GRAD_TOL or GRAD_SENS x the image-nudge sensitivity)
    kn = with_(base, fused=True, conv_kernels="pallas", layout="NCHW")
    kh = with_(kn, layout="NHWC")
    state0, batch = setup(kn)
    state, run, launches = _preset_run(torch, counters, kn, state0, _to_nchw(batch),
                                       NCHW_PER_STEP, "nchw kernels")
    add(launches)
    del state
    want, got = (_step_record(torch, kh, state0, batch),
                 _step_record(torch, kn, state0, _to_nchw(batch)))
    sens = _nudge_sensitivity(batch, state0.params, state0.bn_state, kh, want["grads"])
    run["vs_nhwc_kernels"] = _hold_to(torch, got, want, kn.optimizer.learning_rate,
                                      "nchw kernels vs nhwc kernels", sens,
                                      stat_tol=LAYOUT_TOL, grad_tol=GRAD_TOL)
    out["nchw_kernels"] = run
    del want, got, state0, batch

    # 5. the served bf16 forward at batch 8, NHWC and NCHW, from bf16 weights
    mcfg = base.model
    params, bn_state = _serving_state(torch, mcfg)
    x = np.random.default_rng(SEED).normal(0, 50, (8, mcfg.input_dim, mcfg.input_dim, 3)
                                           ).astype(np.float32)
    xc = np.ascontiguousarray(x.transpose(0, 3, 1, 2))

    def served(images, weights_dtype=None, **ecfg):
        model = export_inference(params, mcfg, bn_state=bn_state,
                                 ecfg=ExecutionConfig(**ecfg), weights_dtype=weights_dtype)
        logits = model.call(images)
        require(logits.dtype is torch.float32, f"served logits of {logits.dtype}")
        return logits.cpu().numpy(), model

    want, _ = served(x)
    gap = float(np.abs(served(x, "bfloat16", compute_dtype="bfloat16")[0] - want).max())
    serving = {"plain_bf16_vs_fp32_max_abs": gap, "max_abs_logit": float(np.abs(want).max())}
    for layout, images in (("NHWC", x), ("NCHW", xc)):
        counters.zero()
        got, model = served(images, "bfloat16", compute_dtype="bfloat16", layout=layout,
                            kernels="pallas", conv_kernels="pallas")
        delta = {k: v for k, v in counters.read().items() if v}
        add(delta)
        require(delta == BF16_PER_FORWARD, f"served bf16 {layout} forward moved the "
                f"counters by {delta}, expected {BF16_PER_FORWARD}")
        err = float(np.abs(got - want).max())
        require(np.isfinite(got).all() and err <= 2 * gap,
                f"served bf16 {layout}: max|kernel - fp32| logits {err} > 2 x {gap}")
        on_card = torch.from_numpy(images).cuda()  # timed as phase 4 times its batch 8
        serving[layout] = {"max_abs_err_vs_fp32": err, "per_forward": delta,
                           "batch8_ms": checks.median_ms(lambda: model.call(on_card), reps=10),
                           "batch8_device_ms": checks.device_ms(lambda: model.call(on_card))}
    out["serve_bf16"] = serving
    emit({"phase": "presets", "model": mcfg.name, "device": smi, **out})
    return launched


def _call_hashes(torch, step, state, batch, module, name):
    """One step(state, batch) with module.name (a kernel wrapper's forward)
    wrapped to record checks.output_hash of every call's outputs: the
    digests in call order, which two trees' steps from one state and batch
    give alike where their kernels give the same bits."""
    from resnet_tpu_torch.kernels import checks

    inner, hashes = getattr(module, name), []

    def recorded(*args, **kwargs):
        out = inner(*args, **kwargs)
        flat = [t for o in (out if isinstance(out, tuple) else (out,))
                for t in (o if isinstance(o, tuple) else (o,))]
        hashes.append(checks.output_hash(flat))
        return out

    setattr(module, name, recorded)
    try:
        step(state, batch)
        torch.cuda.synchronize()
    finally:
        setattr(module, name, inner)
    return hashes


def phase_bf16_engines(torch, counters, smi):
    """The fused and whole-block engines in bf16 at full width (ResNet-50,
    224^2, batch 32, lr 1e-4, fused Adam, one SyntheticDataset batch at seed
    1234): 'fused', 'hybrid', 'fusedxla' and 'blockfused' with bf16 compute
    and fp32 parameters, 'fused' and 'blockfused' with bf16 parameters too,
    and 'blockfused' with conv_kernels='pallas'. Each run: TRAIN_STEPS steps
    with the counters read after each (exact counts on the ``_bf16``
    entries), the loss after the last update below the first, the
    parameters' dtype kept; one step from the same state held to the plain
    bf16 standard step (kernels='xla', per-tensor Adam, the same parameter
    dtype): the loss and the running statistics within 2x their pooled gap
    to the plain fp32-compute step, each gradient leaf within 2x its own
    gap (at least 2^-8) or GRAD_SENS x the plain bf16 step's change under a
    1 +- 2^-8 image scaling (phase 11's rule with batch statistics: these
    engines take batch statistics only, so phase 3's per-kernel checks
    carry the precision). Then batch_norm_act on bf16 (``_bn_entry``);
    step times in turns of the bf16 standard step on its hand kernels and
    each engine's bf16 and fp32 steps, their peak memory, and a
    torch.profiler table of one fused and one blockfused bf16 step, each
    with its split by bf16 GEMM kernel (``_split``); last, the output
    hashes of the 12 K10 calls of one blockfused bf16 step and of the 16 K9
    calls of one fused bf16 step from the same state (``_call_hashes``)."""
    import dataclasses

    from resnet_tpu_torch.bridge import leaves
    from resnet_tpu_torch.config import variant_config
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.train import init_train_state, make_train_step

    torch.cuda.empty_cache()
    base = variant_config("resnet")

    def config(kernels, param="float32", compute="bfloat16", fused=True, **execution):
        return dataclasses.replace(
            base, execution=dataclasses.replace(base.execution, kernels=kernels,
                                                compute_dtype=compute, param_dtype=param,
                                                **execution),
            optimizer=dataclasses.replace(base.optimizer, fused=fused))

    data = next(SyntheticDataset(base.data.batch_size, image_dim=base.model.input_dim,
                                 num_classes=base.model.num_classes, seed=SEED))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    out, launched = {"model": base.model.name, "batch": base.data.batch_size,
                     "device": smi, "runs": {}}, {}

    def add(launches):
        for k, v in launches.items():
            if v:
                launched[k] = launched.get(k, 0) + v

    runs = [("fused", config("fused"), FUSED_BF16_PER_STEP),
            ("fused, bf16 params", config("fused", "bfloat16"), FUSED_BF16_PER_STEP),
            ("hybrid", config("hybrid"), HYBRID_BF16_PER_STEP),
            ("fusedxla", config("fusedxla"), {"adam": 1}),
            ("blockfused", config("blockfused"), BLOCKFUSED_BF16_PER_STEP),
            ("blockfused, bf16 params", config("blockfused", "bfloat16"),
             BLOCKFUSED_BF16_PER_STEP),
            ("blockfused, conv_kernels='pallas'", config("blockfused", conv_kernels="pallas"),
             BLOCKFUSED_PALLAS_BF16_PER_STEP)]
    for param in ("float32", "bfloat16"):
        state0 = init_train_state(config("xla", param), torch.Generator().manual_seed(SEED),
                                  device="cuda")
        # the plain references from state0: bf16 and fp32 compute
        p16 = config("xla", param, fused=False)
        ref = {k: _step_record(torch, c, state0, batch)
               for k, c in (("plain", p16), ("fp32", config("xla", param, "float32",
                                                              fused=False)))}
        sens = _nudge_sensitivity(batch, state0.params, state0.bn_state, p16,
                                  ref["plain"]["grads"], BF16_UNIT)

        def pooled(r):
            return {"loss": r["loss_sum"], "bn_state": r["state"].bn_state}

        for name, cfg, expect in runs:
            if cfg.execution.param_dtype != param:
                continue
            state, losses, per_step, launches, final_loss = _train_main_path(
                torch, counters, make_train_step(cfg), cfg, state0, batch, expect,
                f"bf16 {name}")
            add(launches)
            require(all(p.dtype == q.dtype for p, q in zip(leaves(state.params),
                                                           leaves(state0.params))),
                    f"bf16 {name} changed the parameters' dtype")
            del state
            rec = _step_record(torch, cfg, state0, batch)
            held = {"loss_and_running_stats": _gap_held(
                        pooled(rec), pooled(ref["plain"]), pooled(ref["fp32"]),
                        f"bf16 {name} loss and running statistics"),
                    "grads": _gap_held(rec["grads"], ref["plain"]["grads"],
                                       ref["fp32"]["grads"], f"bf16 {name} grads",
                                       BF16_UNIT, sens)}
            out["runs"][name] = {"per_step": per_step[0], "losses": losses,
                                 "loss_after_last_step": final_loss, "vs_plain_bf16": held,
                                 "loss": rec["metrics"]["loss"].item()}
            emit({"phase": "bf16_engine_run", "run": name, **out["runs"][name]})
            del rec
        del ref, sens, state0
        torch.cuda.empty_cache()

    out["batch_norm_act"], launches = _bn_entry(torch, counters, bf16=True)
    add(launches)

    # step times in turns, peak memory, profiles
    state0 = init_train_state(base, torch.Generator().manual_seed(SEED), device="cuda")
    paths = {"standard bf16": config("pallas", conv_kernels="pallas")}
    for kernels in ("fused", "hybrid", "fusedxla", "blockfused"):
        paths[f"{kernels} bf16"] = config(kernels)
        paths[f"{kernels} fp32"] = config(kernels, compute="float32")
    steps = {k: make_train_step(c) for k, c in paths.items()}
    states = {k: _clone(state0) for k in paths}
    order = tuple(paths) + tuple(reversed(paths))
    step_ms, host_ms, peak, resident = _times_and_peaks(torch, steps, states, batch, order)
    out.update(step_ms=step_ms, host_step_ms=host_ms, peak_gib=peak,
               resident_before_gib=resident,
               median_step_ms={k: float(np.median(v)) for k, v in step_ms.items()})
    for kernels in ("fused", "blockfused"):
        key = f"{kernels} bf16"

        def one_step():
            states[key], _ = steps[key](states[key], batch)

        rows = _profile(torch, one_step)
        out[f"profile_{kernels}_bf16"] = rows[:30]
        out[f"profile_{kernels}_bf16_device_busy_ms"] = _busy(rows)
        out[f"profile_{kernels}_bf16_split"] = _split(rows)
        # K10-bf16 by part (GEMMs, rows, join) in the blockfused step, K9 in the fused
        out[f"profile_{kernels}_bf16_parts"] = _split(
            rows, K10_PARTS if kernels == "blockfused" else K9_PARTS)
    from resnet_tpu_torch.kernels import block_fused, fused_conv

    out["call_hashes"] = {
        "blockfused bf16, K10": _call_hashes(torch, steps["blockfused bf16"], _clone(state0),
                                             batch, block_fused, "block_fused_forward"),
        "fused bf16, K9": _call_hashes(torch, steps["fused bf16"], _clone(state0), batch,
                                       fused_conv, "_join_forward")}
    require([len(v) for v in out["call_hashes"].values()] == [12, 16],
            f"bf16 call hashes: {[len(v) for v in out['call_hashes'].values()]} calls")
    emit({"phase": "bf16_engines", **out})
    return launched


def _stem_held(torch, x, w):
    """The s2d stem (ops.space_to_depth.s2d_stem_conv) against the 7x7/s2
    stem (ops.conv.conv2d) on the card in fp32, TF32 off: outputs and the
    VJP for one seeded cotangent (the weight's and the images' gradients),
    each within JAX's tolerances for its two stems (tests/test_model.py:
    rtol 1e-4, atol 1e-5, gradients rtol 1e-3, atol 1e-4), the atol as a
    share of max|7x7|."""
    from resnet_tpu_torch.ops.conv import conv2d
    from resnet_tpu_torch.ops.space_to_depth import s2d_stem_conv

    out = {}
    grads = []
    for name, fn in (("7x7", lambda a, b: conv2d(a, b, stride=2)), ("s2d", s2d_stem_conv)):
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(a, b)
        if not grads:
            g = torch.randn(y.shape, generator=torch.Generator(device="cuda").manual_seed(SEED),
                            device="cuda")
        dx, dw = torch.autograd.grad(y, (a, b), g)
        grads.append({"y": y.detach(), "dx": dx, "dw": dw})
    want, got = grads
    for key, rtol, atol in (("y", 1e-4, 1e-5), ("dx", 1e-3, 1e-4), ("dw", 1e-3, 1e-4)):
        scale = want[key].abs().max().item()
        err = (got[key] - want[key]).abs()
        over = (err - rtol * want[key].abs() - atol * scale).max().item()
        require(over <= 0, f"s2d stem {key}: beyond rtol {rtol} + {atol} of max by {over}")
        out[key] = {"max_abs_err": err.max().item(), "max_abs": scale,
                    "max_rel_err": err.max().item() / scale}
    return out


def phase_configs(torch, checks, counters, smi):
    """The configurations JAX runs that the phases above do not, at full
    width: ResNeXt-50 32x4d and the space-to-depth stem.

    1. ResNeXt-50 32x4d at 224, batch 32, kernels='pallas',
       conv_kernels='pallas', fused Adam: TRAIN_STEPS fp32 steps with the
       counters read after each (RESNEXT_PER_STEP: its 16 grouped 3x3s on
       the plain conv, as JAX sends them to XLA, every other conv on K1),
       the loss falling; one step against the plain path by phase 6's rule
       (``_engine_vs_plain``) and the frozen-BN gradients by phase 5's
       tight rule; then TRAIN_STEPS bf16 steps (the same counts on the bf16
       entries), one held to the plain bf16 step by phase 11's rule
       (``_bf16_held``); the fp32 and bf16 steps timed (median of 5).
    2. ResNeXt-50 served in int8 over HTTP (``_int8_http``): each request
       exactly 38 Q1, 16 Q3 and 54 Q2 launches, the logits the plain int8
       forward's bit for bit; the Pearson correlation with the fp32 folded
       forward; the int8 forward at batch 8 timed (CUDA events); at batch
       128 the int8 and the bf16 hand-kernel forwards in turns, and the
       int8 forward's device time split into Q1, Q3, Q2 and the rest
       (``_int8_vs_bf16``).
    3. ResNet-50 at JAX's headline configuration (BENCH_r05.json): batch
       256, bf16, the standard topology (1x1/s2 projections), grad_accum 2,
       space_to_depth, kernels='pallas', conv_kernels='pallas', fused Adam:
       TRAIN_STEPS steps with the counters read after each (S2D_PER_STEP:
       two microbatches, the folded stem on the plain conv), the loss
       falling; one step held to the plain s2d step by phase 11's rule; the
       step timed (median of 5). Then an fp32 s2d stem against the 7x7 stem
       at that batch (``_stem_held``)."""
    import dataclasses

    from resnet_tpu_torch.config import model_config, variant_config
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.train import init_train_state, make_train_step

    torch.cuda.empty_cache()
    out, launched = {}, {}

    def add(launches):
        for k, v in launches.items():
            if v:
                launched[k] = launched.get(k, 0) + v

    def setup(cfg):
        state0 = init_train_state(cfg, torch.Generator().manual_seed(SEED), device="cuda")
        data = next(SyntheticDataset(cfg.data.batch_size, image_dim=cfg.model.input_dim,
                                     num_classes=cfg.model.num_classes, seed=SEED))
        return state0, {k: torch.from_numpy(v).cuda() for k, v in data.items()}

    def with_(cfg, **execution):
        return dataclasses.replace(
            cfg, execution=dataclasses.replace(cfg.execution, **execution))

    def run(cfg, state0, batch, expect, what):
        step = make_train_step(cfg)
        state, losses, per_step, launches, final_loss = _train_main_path(
            torch, counters, step, cfg, state0, batch, expect, what)
        add(launches)
        _, ms, host = _timed_steps(torch, step, state, batch)
        return {"batch": int(batch["labels"].shape[0]), "per_step": per_step[0],
                "losses": losses, "loss_after_last_step": final_loss, "step_ms": ms,
                "host_step_ms": float(np.median(host))}

    # 1. ResNeXt-50 training on the hand kernels, fp32 then bf16
    base = variant_config("resnet", model=RESNEXT)
    kcfg = dataclasses.replace(with_(base, conv_kernels="pallas"),
                               optimizer=dataclasses.replace(base.optimizer, fused=True))
    pcfg = dataclasses.replace(with_(base, kernels="xla"),
                               optimizer=dataclasses.replace(base.optimizer, fused=False))
    state0, batch = setup(kcfg)
    fp32 = run(kcfg, state0, batch, RESNEXT_PER_STEP, "resnext50 fp32 kernels")
    fp32["vs_plain"], _ = _engine_vs_plain(torch, kcfg, pcfg, state0, batch)
    fp32["frozen_bn"] = _frozen_held(kcfg, pcfg, state0, batch)
    out["resnext50_fp32"] = fp32
    k16 = with_(kcfg, compute_dtype="bfloat16")
    bf16 = run(k16, state0, batch, _on_bf16(RESNEXT_PER_STEP), "resnext50 bf16 kernels")
    bf16["vs_plain_bf16"], bf16["loss"] = _bf16_held(torch, k16, state0, batch)
    out["resnext50_bf16"] = bf16
    del state0, batch
    torch.cuda.empty_cache()

    # 2. ResNeXt-50 served in int8, then timed against its bf16 hand-kernel
    # forward at batch 128
    rcfg = model_config(RESNEXT)
    served, fields, launches, state, x8, rng = _int8_http(torch, counters, rcfg,
                                                          RESNEXT_INT8_PER_FORWARD)
    add(launches)
    fields["batch8_ms"] = checks.median_ms(lambda: served.call(x8), reps=10)
    fields["timed"] = _int8_vs_bf16(torch, checks, served, rcfg, state, x8, rng,
                                    (max(INT8_TIMED_BATCHES),))
    out["resnext50_int8_serve"] = fields
    del served, x8, state
    torch.cuda.empty_cache()

    # 3. ResNet-50 with s2d at JAX's headline configuration
    hb = variant_config("resnet", model="resnet50")
    hb = dataclasses.replace(
        hb, model=model_config("resnet50", stride_projection_kernel=1),
        data=dataclasses.replace(hb.data, batch_size=S2D_BATCH),
        optimizer=dataclasses.replace(hb.optimizer, fused=True))
    scfg = with_(hb, conv_kernels="pallas", compute_dtype="bfloat16", space_to_depth=True,
                 grad_accum=S2D_ACCUM)
    state0, batch = setup(scfg)
    s2d = run(scfg, state0, batch, S2D_PER_STEP, "resnet50 s2d bf16 grad_accum 2")
    s2d["vs_plain_bf16"], s2d["loss"] = _bf16_held(torch, scfg, state0, batch)
    s2d["stem_fp32_vs_7x7"] = _stem_held(torch, batch["images"],
                                         state0.params["init_conv"]["w"].float())
    out["resnet50_s2d_headline"] = s2d
    del state0, batch
    torch.cuda.empty_cache()
    emit({"phase": "configs", "device": smi, **out})
    return launched


def _frozen_held(kcfg, pcfg, state0, batch):
    """Phase 5's tight check: the kernel and plain steps' gradients from
    state0 with BN frozen at its running statistics (mean 0, var 1), each
    leaf within GRAD_TOL of its max or GRAD_SENS x the plain path's change
    under the 1 +- 2^-20 image nudge."""
    import dataclasses

    from resnet_tpu_torch.train import loss_and_grads

    def frozen(cfg):
        return dataclasses.replace(
            cfg, execution=dataclasses.replace(cfg.execution, bn_mode="frozen"))

    kg = loss_and_grads(state0.params, batch, state0.bn_state, frozen(kcfg))[3]
    pg = loss_and_grads(state0.params, batch, state0.bn_state, frozen(pcfg))[3]
    sens = _nudge_sensitivity(batch, state0.params, state0.bn_state, frozen(pcfg), pg)
    err, over_sens, nearest = _leaf_errors(kg, pg, f"{kcfg.model.name} frozen-BN gradient",
                                           GRAD_TOL, sens=sens)
    return {"grad_max_rel_err": err, "grad_max_err_over_sensitivity": over_sens,
            "grad_nearest_limit": nearest}


# phase 15: a server of a saved artifact runs in a process where the model
# code cannot be imported; it serves serve.py's HTTP contract and, for this
# smoke alone, GET /counters (the kernels' launch counters) and POST
# /logits (the bucketed logits as raw fp32 bytes)
MODEL_CODE = ("resnet_tpu_torch.models", "resnet_tpu_torch.quantize", "resnet_tpu_torch.train")
ARTIFACT_SERVER = """
import importlib, json, sys
for name in %r:
    sys.modules[name] = None  # an import of the model code raises
import numpy as np
from resnet_tpu_torch import serve

httpd = serve.serve(sys.argv[1], port=0, device="cuda")
served = httpd.served
# kernel name -> (its module, its counter), as kernels.checks.KERNELS maps them
where = {k: (importlib.import_module(m), a) for k, (m, a) in json.loads(sys.argv[2]).items()}


class Handler(httpd.RequestHandlerClass):
    def do_GET(self):
        if self.path != "/counters":
            return super().do_GET()
        self._reply(200, {k: getattr(m, a) for k, (m, a) in where.items()})

    def do_POST(self):
        if self.path != "/logits":
            return super().do_POST()
        shape = tuple(int(v) for v in self.headers["X-Shape"].split(","))
        n = int(self.headers["Content-Length"])
        x = np.frombuffer(self.rfile.read(n), dtype=np.float32).reshape(shape)
        body = serve.bucketed_call(served, x, httpd.max_bucket).tobytes()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


httpd.RequestHandlerClass = Handler
loaded = sorted(n for n, m in sys.modules.items() if m is not None and n.startswith(%r))
print(json.dumps({"port": httpd.server_address[1], "kind": served.kind,
                  "model_code_imported": loaded, "jax": "jax" in sys.modules}), flush=True)
httpd.serve_forever()
""" % (MODEL_CODE, MODEL_CODE)
ARTIFACT_BATCHES = (1, 3, 8)


def _http(addr, method, path, x=None):
    """(status, body bytes) of one request to the artifact server."""
    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        if x is None:
            conn.request(method, path)
        else:
            conn.request(method, path, body=x.tobytes(),
                         headers={"X-Shape": ",".join(map(str, x.shape))})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _artifact_saved(counters, name, model, per_forward, batches, path):
    """One artifact's eager side: ``model`` (an eager served model on the
    card) asked for each batch (at its bucket), each forward moving the
    counters by ``per_forward``, then saved to ``path`` by
    ``save_inference`` (a torch.export program over a symbolic batch).
    Returns what ``_artifact_checked`` holds the served program to."""
    from resnet_tpu_torch.export import save_inference
    from resnet_tpu_torch.serve import bucketed_call

    eager, eager_moved = [], []
    for x in batches:
        before = counters.read()
        eager.append(bucketed_call(model, x))
        eager_moved.append(_moved(before, counters.read()))
    require(all(m == per_forward for m in eager_moved),
            f"{name}: the eager forward moved the counters by {eager_moved}, "
            f"expected {per_forward}")
    t0 = time.perf_counter()
    save_inference(path, model)
    return {"name": name, "kind": model.meta()["kind"], "path": path, "batches": batches,
            "eager": eager, "moved": eager_moved, "export_s": time.perf_counter() - t0,
            "file_bytes": os.path.getsize(path)}


def _artifact_server(counters, saved, errlog):
    """The artifact server process of one saved artifact (ARTIFACT_SERVER)."""
    where = json.dumps({k: (m.__name__, a) for k, (m, a) in counters.where.items()})
    return subprocess.Popen([sys.executable, "-c", ARTIFACT_SERVER, saved["path"], where],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=errlog, text=True)


def _artifact_checked(saved, proc, errlog, exact, t0):
    """One artifact served by ``proc`` (loaded in a process where
    ``MODEL_CODE`` cannot be imported, by resnet_tpu_torch.serve): each
    batch asked for over HTTP must move that process's counters as the
    eager model's forward moved them; the served logits (at the request's
    bucket) against the eager model's: equal bit for bit where ``exact``,
    else within LOGIT_TOL of max|logits|, the bit equality printed."""
    name = saved["name"]
    line = proc.stdout.readline()
    ready_s = time.perf_counter() - t0
    if not line:
        errlog.seek(0)
        raise RuntimeError(f"{name}: the artifact server died:\n{errlog.read()[-4000:]}")
    hello = json.loads(line)
    require(hello["kind"] == saved["kind"] and not hello["jax"],
            f"{name}: the server reports {hello}")
    require(not hello["model_code_imported"],
            f"{name}: the server imported {hello['model_code_imported']}")
    addr = ("127.0.0.1", hello["port"])
    status, body = _http(addr, "GET", "/healthz")
    require(status == 200 and json.loads(body) == {"ok": True}, "/healthz: not ok")
    rows = []
    for x, want, moved in zip(saved["batches"], saved["eager"], saved["moved"]):
        before = json.loads(_http(addr, "GET", "/counters")[1])
        status, body = _http(addr, "POST", "/predict", x)
        after = json.loads(_http(addr, "GET", "/counters")[1])
        require(status == 200, f"{name}: /predict answered {status}: {body[:200]}")
        reply = json.loads(body)
        served_moved = _moved(before, after)
        require(served_moved == moved, f"{name} batch {x.shape[0]}: the served "
                f"program moved the counters by {served_moved}, eager by {moved}")
        status, body = _http(addr, "POST", "/logits", x)
        require(status == 200, f"{name}: /logits answered {status}")
        got = np.frombuffer(body, dtype=np.float32).reshape(want.shape)
        require(np.isfinite(got).all(), f"{name}: non-finite served logits")
        require(reply["top1"] == got.argmax(-1).tolist()
                and reply["logits_shape"] == list(want.shape),
                f"{name}: /predict's reply differs from the served logits")
        bits = got.tobytes() == want.tobytes()
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        if exact:
            require(bits, f"{name} batch {x.shape[0]}: served logits differ from the "
                    f"eager model's by {err}")
        else:
            require(err <= LOGIT_TOL * scale, f"{name} batch {x.shape[0]}: max|served "
                    f"- eager| = {err} > {LOGIT_TOL} * {scale}")
        rows.append({"batch": int(x.shape[0]), "per_request": served_moved,
                     "bit_equal_to_eager": bits, "max_abs_err": err,
                     "max_abs_logit": scale, "latency_ms": reply["latency_ms"]})
    return {"export_s": saved["export_s"], "file_bytes": saved["file_bytes"],
            "server_ready_s": ready_s, "compare": rows}


def phase_artifact(torch, counters):
    """Phase 15: three self-contained artifacts, each saved here after its
    eager forwards (``_artifact_saved``), then served by its own process
    without the model code, the three started together
    (``_artifact_checked``): phase 4's seeded ResNet-50 under
    kernels='pallas', conv_kernels='pallas' (fp32: 53 K1, 16 K2, 1 K3 a
    forward; within LOGIT_TOL of the eager model), phase 13's int8
    ResNet-50 (54 Q1, 54 Q2) and phase 14's int8 ResNeXt-50 32x4d (38 Q1,
    16 Q3, 54 Q2), both bit for bit."""
    from resnet_tpu_torch.config import ExecutionConfig, model_config
    from resnet_tpu_torch.export import export_inference, export_quantized_inference

    torch.cuda.empty_cache()
    out, launched, saved = {}, {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for name, arch, kind, per_forward in (
                ("resnet50_fp32", "resnet50", "fp", PER_FORWARD),
                ("resnet50_int8", "resnet50", "int8", INT8_PER_FORWARD),
                (f"{RESNEXT}_int8", RESNEXT, "int8", RESNEXT_INT8_PER_FORWARD)):
            mcfg = model_config(arch)
            params, bn_state = _serving_state(torch, mcfg)
            rng = np.random.default_rng(SEED)
            d = mcfg.input_dim
            if kind == "fp":
                model = export_inference(params, mcfg, bn_state=bn_state, ecfg=ExecutionConfig(
                    kernels="pallas", conv_kernels="pallas"))
            else:
                calib = rng.normal(0, 50, (8, d, d, 3)).astype(np.float32)
                model = export_quantized_inference(params, mcfg, calib, bn_state=bn_state)
            batches = [rng.normal(0, 50, (n, d, d, 3)).astype(np.float32)
                       for n in ARTIFACT_BATCHES]
            saved.append(_artifact_saved(counters, name, model, per_forward, batches,
                                         os.path.join(tmp, f"{name}.pt2")))
            del model, params, bn_state
            torch.cuda.empty_cache()
        counters.zero()
        logs = [open(os.path.join(tmp, f"{s['name']}.err"), "w+") for s in saved]
        t0 = time.perf_counter()
        procs = [_artifact_server(counters, s, log) for s, log in zip(saved, logs)]
        try:
            for s, proc, log in zip(saved, procs, logs):
                out[s["name"]] = _artifact_checked(s, proc, log, s["kind"] == "int8", t0)
                for rows in out[s["name"]]["compare"]:
                    for k, v in rows["per_request"].items():
                        launched[k] = launched.get(k, 0) + v
        finally:
            for proc in procs:
                proc.terminate()
            for proc, log in zip(procs, logs):
                proc.wait(timeout=60)
                log.close()
    emit({"phase": "artifact", **out})
    return launched


# phase 16: the convergence tool's learnability recipe (resnet18, 32^2, 10
# classes, batch 32, lr 0.02, warmup 50) on the hand kernels, at 1600 steps
# with the resume halfway: with this recipe JAX's tools/convergence_run.py
# reaches fp top-1 0.48 on the CPU at 400 steps, 0.92 at 1600
CONVERGE_ARGS = ["--model", "resnet18", "--steps", "1600", "--batch", "32", "--dim", "32",
                 "--classes", "10", "--eval-every", "400", "--eval-batches", "4",
                 "--warmup", "50", "--lr", "0.02", "--resume-at", "800",
                 "--kernels", "pallas", "--conv-kernels", "pallas", "--device", "cuda"]
CONVERGE_TOP1 = 0.80


def phase_converge(torch, counters):
    """Phase 16: ``python -m resnet_tpu_torch.tools.convergence`` with
    CONVERGE_ARGS, in this process: the resume exact, the training loss
    finite and falling, fp top-1 at least CONVERGE_TOP1, and Q1 and Q2
    launched by its int8 evaluation."""
    from resnet_tpu_torch.tools import convergence

    with tempfile.TemporaryDirectory() as tmp:
        counters.zero()
        rec = convergence.main(CONVERGE_ARGS + ["--out", os.path.join(tmp, "converge.json")])
        launched = {k: v for k, v in counters.read().items() if v}
    losses = [r["train_loss"] for r in rec["curve"]]
    emit({"phase": "converge", "resume": rec["resume"], "final": rec["final"],
          "curve": rec["curve"], "wall_seconds": rec["wall_seconds"], "launches": launched})
    require(rec["resume"]["exact"], f"converge: the resume was not exact: {rec['resume']}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"converge: training losses {losses}")
    require(rec["final"]["fp_top1"] >= CONVERGE_TOP1,
            f"converge: fp top-1 {rec['final']['fp_top1']} < {CONVERGE_TOP1}")
    require(launched.get("qconv", 0) > 0 and launched.get("quant_act", 0) > 0,
            f"converge: the int8 evaluation launched no Q1 or Q2: {launched}")
    return launched

# phase 17: two gloo ranks sharing the card, their rows of the batch; the
# Trainer's uninterrupted run, the run killed after PARALLEL_KILL_AT steps and
# its resume, dumping every 2, from PARALLEL_SHARDS shards of SHARD_IMAGES
PARALLEL_RANKS, PARALLEL_STEPS, PARALLEL_KILL_AT, PARALLEL_SHARDS = 2, 4, 3, 2
WORKER = "resnet_tpu_torch.tools.distributed_worker"


def _ranks(spec, work, name, backend="gloo", ranks=PARALLEL_RANKS, kill=False):
    """``ranks`` processes of the distributed worker on ``spec``, side by
    side on this card; their results by rank (None where they were to kill
    themselves, which each must have done)."""
    import torch

    d = os.path.join(work, name)
    os.makedirs(d)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    logs = [os.path.join(d, f"rank{r}.log") for r in range(ranks)]
    procs = []
    for r in range(ranks):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", WORKER, str(r), str(ranks), os.path.join(d, "store"),
                 os.path.join(d, "spec.json"), os.path.join(d, "out"), "--backend", backend,
                 "--device", "cuda"], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL))
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want = -9 if kill else 0
    for r, rc in enumerate(rcs):
        if rc != want:
            with open(logs[r]) as f:
                print(f.read()[-8000:], file=sys.stderr, flush=True)
        require(rc == want, f"{name} rank {r} exited {rc}, expected {want}")
    if kill:
        return None
    return [torch.load(os.path.join(d, "out", f"rank{r}.pt"), weights_only=False)
            for r in range(ranks)]


def _spec_config(cfg):
    """A TrainConfig as the worker's JSON spec carries it."""
    import dataclasses

    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def _bn_stats_tree(stats):
    """aux["bn_stats"] as the worker writes it: [mean, var] per layer."""
    return {"init_bn": list(stats["init_bn"]),
            "blocks": [{k: list(v) for k, v in b.items()} for b in stats["blocks"]]}


def _to_cuda(tree):
    from resnet_tpu_torch.bridge import tree_map

    return tree_map(lambda t: t.cuda(), tree)


def _frozen(cfg):
    """cfg with BN frozen at the running statistics."""
    import dataclasses

    return dataclasses.replace(
        cfg, execution=dataclasses.replace(cfg.execution, bn_mode="frozen"))


# the cases of a data-parallel worker's 'auto' checks: batch statistics, and
# BN frozen at the initial running statistics (phase 5's tight check); each
# keeps what its step left on rank 0
AUTO_CASES = [{"name": "auto", "grads": True, "keep": ["params", "means", "bn_state"]},
              {"name": "frozen", "grads": True, "keep": ["params", "means", "bn_state"],
               "bn_mode": "frozen"}]


def _auto_specs(kcfg, time_steps):
    """AUTO_CASES as worker cases of kcfg, 'auto' timed over time_steps."""
    cases = []
    for case in AUTO_CASES:
        case = dict(case)
        if case.pop("bn_mode", None):
            case["config"] = {"execution": _spec_config(_frozen(kcfg))["execution"]}
        else:
            case["time"] = time_steps
        cases.append(case)
    return cases


def _parallel_cli_args(data, dump_dir, backend, steps):
    """The CLI's flags for a multi-rank run of phase 17's model (phase 10's
    command): ``data`` a shard directory, or None for synthetic batches."""
    src = (["--synthetic"] if data is None else
           ["--shard-dir", data, "--num-shards", str(PARALLEL_SHARDS),
            "--shard-images", str(SHARD_IMAGES)])
    return ["--model", "resnet50", "--kernels", "pallas", "--conv-kernels", "pallas",
            "--batch-size", "32", "--lr", "1e-4", *src, "--steps", str(steps),
            "--checkpoint-every", "2", "--checkpoint-dir", dump_dir, "--log-every", "1",
            "--device", "cuda", "--dist-backend", backend]


def _auto_checks(torch, ranks, state0, batch, kcfg, what):
    """The ranks' AUTO_CASES against this process's one-process step on the
    whole batch, by phase 5's rule. Their side path (a forward and backward
    under the statistics' sums, then the gradient bucket's sum): summed
    loss, gradients, batch statistics (every rank's the same). The counted
    step itself: its loss, its Adam moments (after one step from zero, (1 -
    b1) times the gradient the step reduced, held by the gradients' rule),
    running statistics and parameters (within 2 lr); with BN frozen, the
    tight check, at most UPDATE_SHARE of the Adam updates off by lr / 100."""
    from resnet_tpu_torch.bridge import leaves
    from resnet_tpu_torch.train import loss_and_grads, make_train_step

    lr, b1 = kcfg.optimizer.learning_rate, kcfg.optimizer.beta1
    out = {}
    for name, cfg in (("auto", kcfg), ("frozen", _frozen(kcfg))):
        case, label = ranks[0][name], f"{what} '{name}'"
        loss, _, aux, g = loss_and_grads(state0.params, batch, state0.bn_state, cfg)
        sens = _nudge_sensitivity(batch, state0.params, state0.bn_state, cfg, g)
        loss_err = abs(case["grad_loss_sum"] - loss.item()) / abs(loss.item())
        require(loss_err <= LOSS_TOL, f"{label} summed loss {case['grad_loss_sum']} vs one "
                f"process {loss.item()}")
        grad_err, grad_sens, grad_nearest = _leaf_errors(
            _to_cuda(case["grads"]), g, f"{label} gradient", GRAD_TOL, sens=sens)
        del g
        rec = {"loss_rel_err": loss_err, "grad_max_rel_err": grad_err,
               "grad_max_err_over_sensitivity": grad_sens, "grad_nearest_limit": grad_nearest}
        if name == "auto":
            rec["batch_stats_max_err"] = _leaf_errors(
                _to_cuda(case["bn_stats"]), _bn_stats_tree(aux["bn_stats"]),
                f"{label} batch statistic", STAT_TOL, floor=1.0)[0]
            require(all(all(torch.equal(a, b) for a, b in zip(
                leaves(ranks[0][name]["bn_stats"]), leaves(r[name]["bn_stats"])))
                for r in ranks[1:]), f"{label}: the ranks' batch statistics differ")
        ks, km = make_train_step(cfg)(_clone(state0), batch)
        step_loss_err = abs(case["metrics"]["loss"] - km["loss"].item()) / km["loss"].item()
        require(step_loss_err <= LOSS_TOL, f"{label} step loss {case['metrics']['loss']} vs "
                f"one process {km['loss'].item()}")
        m_err, m_sens, m_nearest = _leaf_errors(
            _to_cuda(case["means"]), ks.opt_state.means, f"{label} step's adam m", GRAD_TOL,
            sens={k: (1 - b1) * v for k, v in sens.items()})
        stat_err = _leaf_errors(_to_cuda(case["bn_state"]), ks.bn_state,
                                f"{label} step's running statistic", STAT_TOL, floor=1.0)[0]
        got = _to_cuda(case["params"])
        p_abs = max((a - b).abs().max().item()
                    for a, b in zip(leaves(got), leaves(ks.params), strict=True))
        require(p_abs <= 2 * lr + 1e-6, f"{label} params differ by {p_abs} > 2 lr + 1e-6")
        share = _update_share(got, ks.params, state0.params, lr)
        if name == "frozen":
            require(share <= UPDATE_SHARE,
                    f"{label} step: {share} of the Adam updates differ from the one-process "
                    "step's by more than lr / 100")
        del ks, got
        rec.update({"step_loss_rel_err": step_loss_err, "step_adam_m_max_rel_err": m_err,
                    "step_adam_m_max_err_over_sensitivity": m_sens,
                    "step_adam_m_nearest_limit": m_nearest,
                    "step_running_stats_max_err": stat_err, "param_max_abs_err": p_abs,
                    "update_share_beyond_lr_100": share})
        out[name] = rec
    return out


# A13's engines across ranks: the engines whose statistics come from their own
# kernels, in fp32 and bf16, and ghost BN (its sample inside rank 0's rows and
# across ranks), under 'auto', each rank's statistics the global batch's
ENGINE_RUNS = [(f"{k} {d}", k, d, 0) for k in ("fused", "hybrid", "fusedxla", "blockfused")
               for d in ("fp32", "bf16")] + [(f"ghost k={k}", "pallas", "fp32", k)
                                              for k in (8, 24)]
# parallel_nccl's: 'fused' and 'blockfused' in both dtypes
NCCL_ENGINE_RUNS = [r for r in ENGINE_RUNS if r[1] in ("fused", "blockfused")]


def _engine_cfg(kcfg, kernels, dtype, ghost):
    """kcfg (phase 17's "resnet" variant on every hand kernel) under another
    engine, compute dtype and ghost BN sample."""
    import dataclasses

    return dataclasses.replace(kcfg, execution=dataclasses.replace(
        kcfg.execution, kernels=kernels, bn_stats_batch=ghost,
        compute_dtype="bfloat16" if dtype == "bf16" else "float32"))


def _engine_expect(cfg):
    """A rank's counter moves in one 'auto' step of cfg across ranks: the
    engine's one-process counts, K10 on its stage entries (four a block,
    the statistics summed between them) in place of its one call."""
    kernels = cfg.execution.kernels
    if cfg.execution.bn_stats_batch:
        base = GHOST_PER_STEP
    else:
        base = {"fused": FUSED_PER_STEP, "hybrid": HYBRID_PER_STEP,
                "fusedxla": FUSEDXLA_PER_STEP, "blockfused": BLOCKFUSED_PALLAS_PER_STEP}[kernels]
    if kernels == "blockfused":
        base = dict({k: v for k, v in base.items() if k != "block_fused"},
                    block_fused_stage=4 * base["block_fused"])
    return _on_bf16(base) if cfg.execution.compute_dtype == "bfloat16" else dict(base)


def _engine_specs(kcfg, runs, time_steps=0):
    """Worker cases of ``runs`` (ENGINE_RUNS entries) on kcfg: the side path
    (forward and backward, then the bucket's sum) and one counted step."""
    return [{"name": name, "grads": True, "keep": [], "time": time_steps,
             "config": {"execution": _spec_config(_engine_cfg(kcfg, *run))["execution"]}}
            for name, *run in runs]


def _engine_checks(torch, ranks, state0, batch, kcfg, runs, what):
    """Each of ``runs`` on the ranks against this process's one-process step
    of the same engine on the whole batch: each rank's counts
    (``_engine_expect``), the ranks' batch statistics equal bit for bit, and
    the side path's summed loss, batch statistics and gradients by phase 5's
    rule in fp32 (LOSS_TOL, STAT_TOL, GRAD_TOL or GRAD_SENS x the 1 +- 2^-20
    nudge's change) and by phase 11's in bf16 (within 2x the one-process
    bf16-vs-fp32 gap of the engine, the gradients' at least 2^-8 or GRAD_SENS
    x the 1 +- 2^-8 nudge's change)."""
    out = {}
    for name, kernels, dtype, ghost in runs:
        cfg = _engine_cfg(kcfg, kernels, dtype, ghost)
        fcfg = _engine_cfg(kcfg, kernels, "fp32", ghost) if dtype == "bf16" else None
        out[name] = _side_path_checks(torch, ranks, name, state0, batch, cfg, fcfg,
                                      _engine_expect(cfg), f"{what} '{name}'")[0]
    return out


def _side_path_checks(torch, ranks, name, state0, batch, cfg, fcfg, expect, label):
    """One run of ``ranks`` (a worker case with ``"grads"``) against this
    process's one-process step of ``cfg`` on the whole batch: each rank's
    counts ``expect``, the ranks' batch statistics equal bit for bit, and
    the side path's summed loss, batch statistics and gradients by phase
    5's rule in fp32 (``fcfg`` None) and by phase 11's in bf16 (within 2x
    the one-process bf16-vs-fp32 gap, ``fcfg`` the fp32 config). Returns
    (the record, the nudge sensitivity of the fp32 gradients or None)."""
    from resnet_tpu_torch.bridge import leaves
    from resnet_tpu_torch.train import loss_and_grads

    case = ranks[0][name]
    for r, rank in enumerate(ranks):
        require(rank[name]["counts"] == expect, f"{label}: rank {r} moved the counters "
                f"by {rank[name]['counts']}, expected {expect}")
    require(all(all(torch.equal(a, b) for a, b in zip(
        leaves(case["bn_stats"]), leaves(r[name]["bn_stats"]), strict=True))
        for r in ranks[1:]), f"{label}: the ranks' batch statistics differ")
    loss, _, aux, g = loss_and_grads(state0.params, batch, state0.bn_state, cfg)
    got_stats, want_stats = _to_cuda(case["bn_stats"]), _bn_stats_tree(aux["bn_stats"])
    rec = {"launches_per_rank": [rank[name]["counts"] for rank in ranks],
           "step_loss": case["metrics"]["loss"]}
    sens = None
    if fcfg is None:
        sens = _nudge_sensitivity(batch, state0.params, state0.bn_state, cfg, g)
        loss_err = abs(case["grad_loss_sum"] - loss.item()) / abs(loss.item())
        require(loss_err <= LOSS_TOL, f"{label} summed loss {case['grad_loss_sum']} vs "
                f"one process {loss.item()}")
        grad_err, grad_sens, nearest = _leaf_errors(
            _to_cuda(case["grads"]), g, f"{label} gradient", GRAD_TOL, sens=sens)
        stat_err = _leaf_errors(got_stats, want_stats, f"{label} batch statistic",
                                STAT_TOL, floor=1.0)[0]
        rec.update(loss_rel_err=loss_err, grad_max_rel_err=grad_err,
                   grad_max_err_over_sensitivity=grad_sens, grad_nearest_limit=nearest,
                   batch_stats_max_err=stat_err)
    else:
        floss, _, faux, fg = loss_and_grads(state0.params, batch, state0.bn_state, fcfg)
        bsens = _nudge_sensitivity(batch, state0.params, state0.bn_state, cfg, g, BF16_UNIT)

        def pooled(lo, stats):
            return {"loss": lo.reshape(1), "bn_stats": stats}

        rec["loss_and_batch_stats"] = _gap_held(
            pooled(torch.tensor(case["grad_loss_sum"], device="cuda"), got_stats),
            pooled(loss, want_stats), pooled(floss, _bn_stats_tree(faux["bn_stats"])),
            f"{label} loss and batch statistics")
        rec["grads"] = _gap_held(_to_cuda(case["grads"]), g, fg, f"{label} grads",
                                 BF16_UNIT, bsens)
        del fg, faux
    del g, aux
    step_ms = case.get("step_ms") or []
    if step_ms:
        rec["step_ms"] = float(np.median(step_ms))
    return rec, sens


def _composite_checks(torch, ranks, state0, batch, kcfg, what):
    """The composite step's ranks (``"composite"``: a data x model grid,
    the FC split over the model group) against this process's one-process
    step on the whole batch: every rank's counts phase 5's (K3 on its class
    slice, K7 on its own leaves), each rank's FC weight (features, classes /
    model), the same metrics on every rank, the loss within LOSS_TOL,
    grad_norm within GRAD_TOL, the gathered parameters within 2 lr + 1e-6
    and the gathered Adam m by the gradients' rule (after one step from
    zero, (1 - b1) times the gradient)."""
    from resnet_tpu_torch.bridge import leaves
    from resnet_tpu_torch.train import loss_and_grads, make_train_step

    case, label = ranks[0]["composite"], f"{what} composite"
    model = len(ranks) // 2
    for r, rank in enumerate(ranks):
        require(rank["composite"]["counts"] == PER_STEP, f"{label}: rank {r} moved the "
                f"counters by {rank['composite']['counts']}, expected {PER_STEP}")
        require(rank["composite"]["metrics"] == case["metrics"],
                f"{label}: rank {r}'s metrics differ from rank 0's")
    width, classes = state0.params["fc"]["w"].shape
    fc_shapes = [rank["composite"]["fc_shape"] for rank in ranks]
    require(all(s == [width, classes // model] for s in fc_shapes),
            f"{label}: FC slices {fc_shapes}, expected [{width}, {classes // model}]")
    lr, b1 = kcfg.optimizer.learning_rate, kcfg.optimizer.beta1
    _, _, _, g = loss_and_grads(state0.params, batch, state0.bn_state, kcfg)
    sens = _nudge_sensitivity(batch, state0.params, state0.bn_state, kcfg, g)
    del g
    ks, km = make_train_step(kcfg)(_clone(state0), batch)
    loss_err = abs(case["metrics"]["loss"] - km["loss"].item()) / km["loss"].item()
    require(loss_err <= LOSS_TOL, f"{label} loss {case['metrics']['loss']} vs one process "
            f"{km['loss'].item()}")
    norm_err = abs(case["metrics"]["grad_norm"] - km["grad_norm"].item()) / km[
        "grad_norm"].item()
    require(norm_err <= GRAD_TOL, f"{label} grad_norm {case['metrics']['grad_norm']} vs one "
            f"process {km['grad_norm'].item()}")
    got = _to_cuda(case["params"])
    p_abs = max((a - b).abs().max().item()
                for a, b in zip(leaves(got), leaves(ks.params), strict=True))
    require(p_abs <= 2 * lr + 1e-6, f"{label} params differ by {p_abs} > 2 lr + 1e-6")
    m_err, m_sens, m_nearest = _leaf_errors(
        _to_cuda(case["means"]), ks.opt_state.means, f"{label} adam m", GRAD_TOL,
        sens={k: (1 - b1) * v for k, v in sens.items()})
    del ks, got
    rec = {"grid": [2, model], "fc_slice": fc_shapes[0],
           "launches_per_rank": [rank["composite"]["counts"] for rank in ranks],
           "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
           "param_max_abs_err": p_abs, "adam_m_max_rel_err": m_err,
           "adam_m_max_err_over_sensitivity": m_sens, "adam_m_nearest_limit": m_nearest}
    if case.get("step_ms"):
        rec["step_ms"] = float(np.median(case["step_ms"]))
    return rec


# A13's item 3: the data x spatial grid (the images' height split over the
# spatial group) on the 'pallas' path with K1 on the haloed tiles, in fp32
# and bf16, and on the plain path in fp32; A13b: the fused engines (K8 on
# the haloed tiles of each site's raw input; 'fused' in fp32 and bf16,
# 'hybrid' and 'fusedxla' in fp32) and the s2d stem on the 'pallas' path in
# bf16. (name, kernels, conv_kernels, dtype, space_to_depth)
SPATIAL_RUNS = [("spatial pallas fp32", "pallas", "pallas", "fp32", False),
                ("spatial pallas bf16", "pallas", "pallas", "bf16", False),
                ("spatial xla fp32", "xla", "xla", "fp32", False),
                ("spatial fused fp32", "fused", "pallas", "fp32", False),
                ("spatial fused bf16", "fused", "pallas", "bf16", False),
                ("spatial hybrid fp32", "hybrid", "pallas", "fp32", False),
                ("spatial fusedxla fp32", "fusedxla", "pallas", "fp32", False),
                ("spatial s2d pallas bf16", "pallas", "pallas", "bf16", True)]
# parallel_nccl's: 'pallas' and 'fused' in fp32
NCCL_SPATIAL_RUNS = [r for r in SPATIAL_RUNS if r[0] in ("spatial pallas fp32",
                                                         "spatial fused fp32")]


def _spatial_cfg(kcfg, kernels, conv, dtype, s2d=False):
    """kcfg under another engine, conv engine, compute dtype and stem."""
    import dataclasses

    return dataclasses.replace(kcfg, execution=dataclasses.replace(
        kcfg.execution, kernels=kernels, conv_kernels=conv, space_to_depth=s2d,
        compute_dtype="bfloat16" if dtype == "bf16" else "float32"))


# phase 17's spatial runs (gloo ranks sharing one card) take ResNet-50 at
# 224 and full width cut to one block a stage: the stem, the four stages'
# strided and projection sites, every seam geometry of the row plan, in a
# quarter of the blocks' time (parallel_nccl's run the whole depth)
SPATIAL_DEPTH = (1, 1, 1, 1)


def _spatial_expect(cfg):
    """A spatial rank's counter moves in one step of cfg, on its model's
    blocks (ResNet-50: 16 blocks, a projection a stage, 52 block convs):
    the engine's one-process counts (phase 5's on the hand kernels, the
    fused engines' own, Adam alone on the plain path; the s2d stem leaves
    K1's forward and dW), on the bf16 entries in bf16."""
    ex, blocks = cfg.execution, cfg.model.num_blocks
    sites = 3 * blocks + len(cfg.model.block_sizes)
    fused = {"fused_conv": sites, "fused_join": blocks, "bias_act": 1, "moments": 1}
    counts = {
        "xla": {}, "fusedxla": {},
        "hybrid": {k: v for k, v in fused.items() if k != "fused_conv"}, "fused": fused,
        "pallas": {"conv2d": sites + 1 - ex.space_to_depth, "conv2d_dx": sites,
                   "conv2d_dw": sites + 1 - ex.space_to_depth, "moments": sites + 1,
                   "add_relu": blocks, "add_relu_mask": blocks, "matmul": 1, "matmul_bwd": 1},
    }[ex.kernels]
    counts = dict(counts, adam=1)
    return _on_bf16(counts) if ex.compute_dtype == "bfloat16" else counts


def _spatial_specs(kcfg, grid, runs=SPATIAL_RUNS, time_steps=0, state=None):
    """Worker cases of ``runs`` on the data x spatial ``grid``: the side path
    (forward and backward, then the bucket's sums) and one counted step, of
    kcfg's model from ``state`` (a saved params and bn_state; default the
    spec's)."""
    def case(name, kernels, conv, dtype, s2d):
        config = _spec_config(_spatial_cfg(kcfg, kernels, conv, dtype, s2d))
        out = {"name": f"{name} {grid[0]}x{grid[1]}", "mesh": grid,
               "axes": ["data", "spatial"], "grads": True, "time": time_steps,
               "keep": ["params", "means", "bn_state"] if dtype == "fp32" else [],
               "config": {"execution": config["execution"], "model": config["model"]}}
        return dict(out, state=state) if state else out

    return [case(*run) for run in runs]


def _spatial_checks(torch, ranks, state0, batch, kcfg, grid, runs, what):
    """Each of ``runs`` on the data x spatial ``grid`` against this
    process's one-process step on the whole batch: each rank's counts
    phase 5's on the hand kernels (on the bf16 entries in bf16; Adam alone on
    the plain path), the same metrics on every rank, the side path by
    ``_side_path_checks``, and in fp32 the counted step's loss, Adam m,
    running statistics and parameters by phase 5's rule (``_auto_checks``)."""
    from resnet_tpu_torch.bridge import leaves
    from resnet_tpu_torch.train import make_train_step

    lr, b1 = kcfg.optimizer.learning_rate, kcfg.optimizer.beta1
    out = {}
    for name, kernels, conv, dtype, s2d in runs:
        key = f"{name} {grid[0]}x{grid[1]}"
        cfg = _spatial_cfg(kcfg, kernels, conv, dtype, s2d)
        case, label = ranks[0][key], f"{what} {key}"
        expect = _spatial_expect(cfg)
        require(all(rank[key]["metrics"] == case["metrics"] for rank in ranks),
                f"{label}: the ranks' metrics differ")
        fcfg = _spatial_cfg(kcfg, kernels, conv, "fp32", s2d) if dtype == "bf16" else None
        rec, sens = _side_path_checks(torch, ranks, key, state0, batch, cfg, fcfg, expect,
                                      label)
        rec["grid"] = grid
        if fcfg is None:
            ks, km = make_train_step(cfg)(_clone(state0), batch)
            step_loss_err = abs(case["metrics"]["loss"] - km["loss"].item()) / km["loss"].item()
            require(step_loss_err <= LOSS_TOL, f"{label} step loss {case['metrics']['loss']} "
                    f"vs one process {km['loss'].item()}")
            m_err, m_sens, _ = _leaf_errors(
                _to_cuda(case["means"]), ks.opt_state.means, f"{label} step's adam m",
                GRAD_TOL, sens={k: (1 - b1) * v for k, v in sens.items()})
            run_err = _leaf_errors(_to_cuda(case["bn_state"]), ks.bn_state,
                                   f"{label} step's running statistic", STAT_TOL, floor=1.0)[0]
            p_abs = max((a - b).abs().max().item() for a, b in zip(
                leaves(_to_cuda(case["params"])), leaves(ks.params), strict=True))
            require(p_abs <= 2 * lr + 1e-6, f"{label} params differ by {p_abs} > 2 lr + 1e-6")
            del ks
            rec.update(step_loss_rel_err=step_loss_err, step_adam_m_max_rel_err=m_err,
                       step_adam_m_max_err_over_sensitivity=m_sens,
                       step_running_stats_max_err=run_err, param_max_abs_err=p_abs)
        out[key] = rec
    return out


def phase_parallel(torch, smi):
    import dataclasses

    import torch.distributed as dist

    from resnet_tpu_torch.bridge import flatten, leaves, tree_map
    from resnet_tpu_torch.config import RESUME_LATEST, variant_config
    from resnet_tpu_torch.data import SyntheticDataset, write_shard
    from resnet_tpu_torch.data.procedural import ProceduralDataset, ProceduralIterator
    from resnet_tpu_torch.parallel import make_mesh
    from resnet_tpu_torch.train import init_train_state, loss_and_grads, make_train_step
    from resnet_tpu_torch.train.cli import build_config
    from resnet_tpu_torch.train.step import _merge_running_stats

    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    base = variant_config("resnet")  # ResNet-50, kernels='pallas', lr 1e-4, batch 32
    kcfg = dataclasses.replace(
        base, execution=dataclasses.replace(base.execution, conv_kernels="pallas"),
        optimizer=dataclasses.replace(base.optimizer, fused=True))
    batch_n = base.data.batch_size
    per = batch_n // PARALLEL_RANKS

    state0 = init_train_state(kcfg, torch.Generator().manual_seed(SEED), device="cuda")
    data = next(SyntheticDataset(batch_n, image_dim=base.model.input_dim,
                                 num_classes=base.model.num_classes, seed=SEED))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    out = {"phase": "parallel", "model": kcfg.model.name, "ranks": PARALLEL_RANKS,
           "backend": "gloo", "rank_batch": per, "global_batch": batch_n, "device": smi}
    with tempfile.TemporaryDirectory() as work:
        # 1. the two ranks: every step case from state0 on batch, and the
        # Trainer's uninterrupted run U, in one start of the ranks
        torch.save({"params": tree_map(lambda t: t.cpu(), state0.params),
                    "bn_state": tree_map(lambda t: t.cpu(), state0.bn_state)},
                   os.path.join(work, "state.pt"))
        torch.save({k: v.cpu() for k, v in batch.items()}, os.path.join(work, "batch.pt"))
        # the spatial runs' model (SPATIAL_DEPTH) and its seeded state
        scfg = dataclasses.replace(kcfg, model=dataclasses.replace(
            kcfg.model, block_sizes=SPATIAL_DEPTH))
        sstate0 = init_train_state(scfg, torch.Generator().manual_seed(SEED), device="cuda")
        sstate = os.path.join(work, "spatial_state.pt")
        torch.save({"params": tree_map(lambda t: t.cpu(), sstate0.params),
                    "bn_state": tree_map(lambda t: t.cpu(), sstate0.bn_state)}, sstate)
        shards = os.path.join(work, "shards")
        stream = ProceduralIterator(ProceduralDataset(
            num_classes=100, image_dim=kcfg.model.input_dim, seed=SEED), SHARD_IMAGES,
            seed=SEED)
        for s in range(PARALLEL_SHARDS):
            b = next(stream)
            write_shard(shards, s, b["images"].transpose(0, 3, 1, 2), b["labels"])

        # U is the CLI under torchrun, as a user starts the ranks; K and R
        # are the worker's Trainer on the config the CLI builds from U's flags
        u_args = _parallel_cli_args(shards, os.path.join(work, "u"), "gloo", PARALLEL_STEPS)
        ucfg, _ = build_config(u_args)

        def trainer_spec(dumps, steps, **kw):
            cfg = dataclasses.replace(ucfg, checkpoint_dir=os.path.join(work, dumps), **kw)
            return {"config": _spec_config(cfg), "steps": steps}

        spec = {"config": _spec_config(kcfg), "state": os.path.join(work, "state.pt"),
                "batch": os.path.join(work, "batch.pt"),
                "cases": _auto_specs(kcfg, 3) + [
                    {"name": "shard_map", "grads": True, "time": 3,
                     "keep": ["bn_state", "means"],
                     "config": {"parallel": {"mode": "shard_map"}}},
                    {"name": "zero", "time": 3, "zero": True, "keep": ["params", "means"],
                     "config": {"parallel": {"zero_sharding": True}}}]
                + _engine_specs(kcfg, ENGINE_RUNS)
                + _spatial_specs(scfg, [1, 2], state=sstate)}
        t0 = time.perf_counter()
        ranks = _ranks(spec, work, "steps")
        out["steps_spawn_s"] = time.perf_counter() - t0
        r0 = ranks[0]
        # the composite step: four ranks on a 2 x 2 grid, the FC split in two;
        # the data x spatial steps on a 2 x 2 grid
        t0 = time.perf_counter()
        grid = _ranks({"config": spec["config"], "state": spec["state"],
                       "batch": spec["batch"],
                       "cases": [{"name": "composite", "mesh": [2, 2], "time": 2,
                                  "keep": ["params", "means"]}]
                       + _spatial_specs(scfg, [2, 2], state=sstate)},
                      work, "composite", ranks=4)
        out["composite_spawn_s"] = time.perf_counter() - t0

        # 2. the launches of each rank's 'auto' step: phase 5's counts
        out["launches_per_rank"] = [r["auto"]["counts"] for r in ranks]
        for r, rank in enumerate(ranks):
            require(rank["auto"]["counts"] == PER_STEP,
                    f"rank {r}'s 'auto' step moved the counters by "
                    f"{rank['auto']['counts']}, expected {PER_STEP}")

        # 3. 'auto' (batch statistics and frozen BN) against the one-process
        # step at 32, by phase 5's rule; the engines and ghost BN, each
        # against its one-process step; the composite step
        out["auto"] = _auto_checks(torch, ranks, state0, batch, kcfg, "gloo")
        auto = r0["auto"]
        out["engines"] = _engine_checks(torch, ranks, state0, batch, kcfg, ENGINE_RUNS,
                                        "gloo")
        out["composite"] = _composite_checks(torch, grid, state0, batch, kcfg, "gloo")
        out["spatial"] = {
            **_spatial_checks(torch, ranks, sstate0, batch, scfg, [1, 2], SPATIAL_RUNS, "gloo"),
            **_spatial_checks(torch, grid, sstate0, batch, scfg, [2, 2], SPATIAL_RUNS, "gloo")}
        out["spatial_model"] = {"block_sizes": list(SPATIAL_DEPTH), "input_dim":
                                scfg.model.input_dim, "init_filters": scfg.model.init_filters}
        del grid, sstate0

        # 4. 'shard_map' against each rank's local-BN step, gradients summed
        def halves(factor=1.0):
            loss, grads, merged = 0.0, None, []
            for r in range(PARALLEL_RANKS):
                rows = {"images": batch["images"][r * per:(r + 1) * per] * factor,
                        "labels": batch["labels"][r * per:(r + 1) * per]}
                lo, _, aux, g = loss_and_grads(state0.params, rows, state0.bn_state, kcfg)
                loss += lo.item()
                grads = g if grads is None else tree_map(torch.add, grads, g)
                merged.append(_merge_running_stats(state0.bn_state, aux["bn_stats"],
                                                   kcfg.model.bn_momentum))
            return loss, grads, merged

        hl, hg, merged = halves()
        hsens = {}
        for factor in (1 + IMAGE_NUDGE, 1 - IMAGE_NUDGE):
            for (path, a), b in zip(flatten(halves(factor)[1]), leaves(hg), strict=True):
                hsens[path] = max(hsens.get(path, 0.0), (a - b).abs().max().item())
        sm = r0["shard_map"]
        require(abs(sm["grad_loss_sum"] - hl) <= LOSS_TOL * abs(hl),
                f"'shard_map' summed loss {sm['grad_loss_sum']} vs the halves' {hl}")
        sm_err, sm_sens, sm_nearest = _leaf_errors(_to_cuda(sm["grads"]), hg,
                                                   "'shard_map' gradient", GRAD_TOL, sens=hsens)
        mean_bn = tree_map(lambda a, b: (a + b) / 2, *merged)
        sm_stat, _, _ = _leaf_errors(_to_cuda(sm["bn_state"]), mean_bn,
                                     "'shard_map' running statistic", STAT_TOL, floor=1.0)
        # the counted step's own sum: after one step from zero, Adam's m is
        # (1 - b1) times the gradient it reduced
        b1 = kcfg.optimizer.beta1
        sm_m_err, sm_m_sens, _ = _leaf_errors(
            _to_cuda(sm["means"]), tree_map(lambda g: (1 - b1) * g, hg),
            "'shard_map' step's adam m", GRAD_TOL,
            sens={k: (1 - b1) * v for k, v in hsens.items()})
        del hg, merged
        out["shard_map"] = {"grad_max_rel_err": sm_err,
                            "grad_max_err_over_sensitivity": sm_sens,
                            "grad_nearest_limit": sm_nearest, "running_stats_max_err": sm_stat,
                            "step_adam_m_max_rel_err": sm_m_err,
                            "step_adam_m_max_err_over_sensitivity": sm_m_sens}

        # 5. ZeRO against the replicated step: the same bits
        zero = r0["zero"]
        for what in ("params", "means"):
            pairs = list(zip(leaves(zero[what]), leaves(auto[what]), strict=True))
            n_equal = sum(torch.equal(a, b) for a, b in pairs)
            require(n_equal == len(pairs), f"ZeRO {what}: {n_equal} of {len(pairs)} leaves "
                    "equal to the replicated step's")
        require(zero["metrics"] == auto["metrics"], "ZeRO metrics differ")
        out["zero"] = {"bit_equal_leaves": len(leaves(zero["params"])) * 2,
                       "state_bytes_per_rank": [r["zero"]["state_bytes"] for r in ranks],
                       "replicated_state_bytes": zero["replicated_state_bytes"]}

        # 6. NCCL in a world of one, here: the data-parallel step is the
        # step without a group, to the bit
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(work, "nccl"), 1),
                                rank=0, world_size=1)
        try:
            dp_step, no_group_step = make_train_step(kcfg, make_mesh()), make_train_step(kcfg)
            ds, dm = dp_step(_clone(state0), batch)
            # what the data-parallel step adds with no peer to wait for: the
            # bucket, the all-reduce call, the views (turns dp, none, none, dp)
            world1_ms = {"dp": [], "no_group": []}
            states = {"dp": _clone(state0), "no_group": _clone(state0)}
            for which in ("dp", "no_group", "no_group", "dp"):
                step = dp_step if which == "dp" else no_group_step
                states[which], ms, _ = _timed_steps(torch, step, states[which], batch, n=3)
                world1_ms[which].append(ms)
            del states
        finally:
            dist.destroy_process_group()
        ss, sm1 = make_train_step(kcfg)(_clone(state0), batch)
        nccl_equal = [sum(torch.equal(a, b) for a, b in zip(leaves(x), leaves(y)))
                      for x, y in ((ds.params, ss.params), (ds.opt_state.means,
                                                            ss.opt_state.means),
                                   (ds.bn_state, ss.bn_state))]
        require(nccl_equal == [len(leaves(ss.params)), len(leaves(ss.params)),
                               len(leaves(ss.bn_state))] and
                {k: v.item() for k, v in dm.items()} == {k: v.item() for k, v in sm1.items()},
                f"NCCL world-1 step differs from the step without a group: {nccl_equal}")
        del ds, ss
        out["nccl_world_1"] = {"bit_equal_leaves": sum(nccl_equal), "step_ms": world1_ms}
        out["nccl_ranks"] = (phase_parallel_nccl(torch, smi) if torch.cuda.device_count() >= 2
                             else f"not run: {torch.cuda.device_count()} card on this machine "
                             "(NCCL takes one GPU a rank)")

        # 7. the Trainer: U, the CLI's uninterrupted run under torchrun; K
        # killed after PARALLEL_KILL_AT steps, R resumed from K's latest dump
        # to step PARALLEL_STEPS
        u = _Cli("U", u_args, work, ranks=PARALLEL_RANKS)
        u.wait(timeout=600)
        u_losses, n_lines = _jsonl_losses(os.path.join(work, "u"))
        require(n_lines == PARALLEL_STEPS and sorted(u_losses) == list(range(PARALLEL_STEPS))
                and all(np.isfinite(v) for v in u_losses.values()),
                f"U's metrics.jsonl: {n_lines} lines, losses {u_losses} (one line a step, "
                "from rank 0 alone)")
        killed = {"trainer": dict(trainer_spec("k", PARALLEL_KILL_AT), kill=True)}
        t0 = time.perf_counter()
        _ranks(killed, work, "killed", kill=True)
        dumps = sorted(d for d in os.listdir(os.path.join(work, "k")) if d.isdigit())
        require(dumps == ["00000000", "00000002"], f"K's dumps {dumps}")
        resumed = _ranks({"trainer": trainer_spec("k", PARALLEL_STEPS - 2,
                                                  resume_from=RESUME_LATEST)},
                         work, "resumed")
        trainer_s = time.perf_counter() - t0
        # R's final dump is U's: R read, on each rank, the rows U read there
        # (the Adam moments would differ otherwise); and the ranks' rows differ
        worst, equal = _dump_diff(os.path.join(work, "k", "77777777"),
                                  os.path.join(work, "u", "77777777"), "R against U")
        require(not any(torch.equal(a, b) for a, b in zip(
            *(r["trainer"]["rows"] for r in resumed))), "the ranks read the same rows")
        out["trainer"] = {"entry": "torchrun -m resnet_tpu_torch.train.cli (U)",
                          "loader": resumed[0]["trainer"]["loader"],
                          "resume_max_rel_err": worst, "bit_equal_leaves": equal,
                          "u_losses": u_losses, "u_seconds": u.seconds,
                          "killed_and_resumed_s": trainer_s}

    # 8. step times: the one-process step at 32, then each two-rank layout
    state, one_ms, _ = _timed_steps(torch, make_train_step(kcfg), _clone(state0), batch, n=3)
    del state
    out["step_ms"] = {"one_process_32": one_ms,
                      **{f"{k}_2x{per}": float(np.median(r0[k]["step_ms"]))
                         for k in ("auto", "shard_map", "zero")}}
    out["step_ms_note"] = ("two ranks share one card and every all-reduce goes through "
                           "host memory (gloo): these times are no scaling figure")
    out["phase_s"] = time.perf_counter() - phase_t0
    emit(out)
    return dict(auto["counts"])



def phase_parallel_nccl(torch, smi):
    """The 'auto' (batch statistics and frozen BN) and ZeRO steps on one NCCL
    rank per card (every card of the machine, at most 4) at phase 17's global
    batch of 32, against this process's one-process step by phase 5's rule
    (``_auto_checks``), ZeRO against the replicated step bit for bit;
    'fused' and 'blockfused' in fp32 and bf16 (``_engine_checks``) and the
    composite step on a 2 x (cards / 2) grid (``_composite_checks``); the
    spatial 'pallas' and 'fused' fp32 steps on 1 x cards and 2 x (cards /
    2) grids (``_spatial_checks``); the step times of all of them, of
    'shard_map' and of one process on one card. Then
    the CLI under torchrun, one NCCL rank a card, on synthetic batches: its
    first step's loss that of one process on the card. Runs where the
    machine has two cards or more."""
    import dataclasses

    from resnet_tpu_torch.bridge import leaves, tree_map
    from resnet_tpu_torch.config import variant_config
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.train import Trainer, init_train_state, make_train_step
    from resnet_tpu_torch.train.cli import build_config

    n = min(torch.cuda.device_count(), 4)
    require(n >= 2, f"{n} card: NCCL ranks need one card each")
    t0 = time.perf_counter()
    base = variant_config("resnet")
    kcfg = dataclasses.replace(
        base, execution=dataclasses.replace(base.execution, conv_kernels="pallas"),
        optimizer=dataclasses.replace(base.optimizer, fused=True))
    batch_n = base.data.batch_size
    state0 = init_train_state(kcfg, torch.Generator().manual_seed(SEED), device="cuda")
    data = next(SyntheticDataset(batch_n, image_dim=base.model.input_dim,
                                 num_classes=base.model.num_classes, seed=SEED))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    out = {"phase": "parallel_nccl", "ranks": n, "backend": "nccl", "rank_batch": batch_n // n,
           "global_batch": batch_n, "device": smi}
    with tempfile.TemporaryDirectory() as work:
        torch.save({"params": tree_map(lambda t: t.cpu(), state0.params),
                    "bn_state": tree_map(lambda t: t.cpu(), state0.bn_state)},
                   os.path.join(work, "state.pt"))
        torch.save({k: v.cpu() for k, v in batch.items()}, os.path.join(work, "batch.pt"))
        spec = {"config": _spec_config(kcfg), "state": os.path.join(work, "state.pt"),
                "batch": os.path.join(work, "batch.pt"),
                "cases": _auto_specs(kcfg, 5) + [
                    {"name": "zero", "zero": True, "time": 5, "keep": ["params", "means"],
                     "config": {"parallel": {"zero_sharding": True}}},
                    # local BN: the step without the statistics' sums
                    {"name": "shard_map", "time": 5, "keep": [],
                     "config": {"parallel": {"mode": "shard_map"}}}]
                + _engine_specs(kcfg, NCCL_ENGINE_RUNS, 5)
                # the composite step on a 2 x (n / 2) grid
                + ([{"name": "composite", "mesh": [2, n // 2], "time": 5,
                     "keep": ["params", "means"]}] if n % 2 == 0 else [])
                # the spatial steps on 1 x n and 2 x (n / 2) grids
                + _spatial_specs(kcfg, [1, n], NCCL_SPATIAL_RUNS, 5)
                + (_spatial_specs(kcfg, [2, n // 2], NCCL_SPATIAL_RUNS, 5)
                   if n % 2 == 0 and n > 2 else [])}
        ranks = _ranks(spec, work, "nccl", backend="nccl", ranks=n)
        auto, zero = ranks[0]["auto"], ranks[0]["zero"]
        for r, rank in enumerate(ranks):
            require(rank["auto"]["counts"] == PER_STEP,
                    f"NCCL rank {r} moved the counters by {rank['auto']['counts']}")
        out["auto"] = _auto_checks(torch, ranks, state0, batch, kcfg, "NCCL")
        out["engines"] = _engine_checks(torch, ranks, state0, batch, kcfg, NCCL_ENGINE_RUNS,
                                        "NCCL")
        if n % 2 == 0:
            out["composite"] = _composite_checks(torch, ranks, state0, batch, kcfg, "NCCL")
        out["spatial"] = _spatial_checks(torch, ranks, state0, batch, kcfg, [1, n],
                                         NCCL_SPATIAL_RUNS, "NCCL")
        if n % 2 == 0 and n > 2:
            out["spatial"].update(_spatial_checks(torch, ranks, state0, batch, kcfg,
                                                  [2, n // 2], NCCL_SPATIAL_RUNS, "NCCL"))
        for what in ("params", "means"):
            require(all(torch.equal(a, b) for a, b in zip(
                leaves(zero[what]), leaves(auto[what]), strict=True)),
                f"NCCL ZeRO {what} differ from the replicated step's")

        # the CLI as a user starts it on this machine's cards
        cli_args = _parallel_cli_args(None, os.path.join(work, "cli"), "nccl", 2)
        cli = _Cli("cli", cli_args, work, ranks=n)
        cli.wait(timeout=600)
        cli_losses, n_lines = _jsonl_losses(os.path.join(work, "cli"))
        require(n_lines == 2 and all(np.isfinite(v) for v in cli_losses.values()),
                f"the CLI's metrics.jsonl: {n_lines} lines, losses {cli_losses}")
        require(os.path.isdir(os.path.join(work, "cli", "77777777")), "no final dump")
    ccfg, _ = build_config(cli_args)
    one = Trainer(dataclasses.replace(ccfg, checkpoint_dir="", checkpoint_every=0, log_every=0),
                  device="cuda", use_mesh=False)
    one_loss = one.run(1)["loss"]
    del one
    cli_err = abs(cli_losses[0] - one_loss) / abs(one_loss)
    require(cli_err <= LOSS_TOL, f"the CLI's first loss on {n} NCCL ranks {cli_losses[0]} vs "
            f"one process {one_loss}")
    # one card at the global batch, and at one rank's rows (the step's own
    # work on each rank, no collective)
    _, one_ms, _ = _timed_steps(torch, make_train_step(kcfg), _clone(state0), batch, n=5)
    rows = {k: v[:batch_n // n] for k, v in batch.items()}
    _, rank_ms, _ = _timed_steps(torch, make_train_step(kcfg), _clone(state0), rows, n=5)
    out.update({"launches_per_rank": [r["auto"]["counts"] for r in ranks],
                "zero_state_bytes_per_rank": zero["state_bytes"],
                "replicated_state_bytes": zero["replicated_state_bytes"],
                "cli": {"entry": f"torchrun --nproc-per-node {n} -m resnet_tpu_torch.train.cli",
                        "losses": cli_losses, "first_loss_rel_err": cli_err,
                        "seconds": cli.seconds},
                "step_ms": {"one_card_32": one_ms, f"one_card_{batch_n // n}": rank_ms,
                            **{f"{k}_{n}x{batch_n // n}": float(np.median(ranks[0][k]["step_ms"]))
                               for k in ("auto", "zero", "shard_map")},
                            **{k: v["step_ms"] for k, v in out["spatial"].items()}},
                "phase_s": time.perf_counter() - t0})
    emit(out)
    return out


PHASE_SECONDS = {}


def _timed_phase(name, run):
    """run(), its wall seconds printed and kept in PHASE_SECONDS."""
    t0 = time.perf_counter()
    out = run()
    PHASE_SECONDS[name] = time.perf_counter() - t0
    emit({"phase_s": {name: PHASE_SECONDS[name]}})
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", help="comma-separated kernel names: phases 1-3 "
                        "for those only, no plans, no final line")
    parser.add_argument("--phases", help="comma-separated names of phases 4-17 (serve, "
                        "train, ..., presets, bf16_engines, int8_serve, configs, artifact, "
                        "converge, parallel): phases 1-2 and those only, no final line")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke runs on a CUDA card only")
    sys.path.insert(0, str(ROOT))
    import resnet_tpu_torch

    pkg = Path(resnet_tpu_torch.__file__).resolve().parent
    require(pkg == ROOT / "resnet_tpu_torch",
            f"resnet_tpu_torch imported from {pkg}, not from this checkout")
    from resnet_tpu_torch.kernels import build, checks

    checks.fp32_strict()
    smi = phase_env(torch, build)
    _timed_phase("build", lambda: phase_build(build))
    if args.kernels:
        names = args.kernels.split(",")
        require(set(names) <= set(checks.KERNELS), f"unknown kernels in {names}")
        phase_kernels(checks, names)
        require("jax" not in sys.modules, "jax was imported")
        print(nvidia_smi(), flush=True)
        return
    counters = Counters(checks)
    phases = {"serve": lambda: phase_serve(torch, checks, counters),
              "train": lambda: phase_train(torch, checks, counters, smi),
              "fused_train": lambda: phase_fused(torch, checks, counters, smi),
              "blockfused_train": lambda: phase_blockfused(torch, checks, counters, smi),
              "batch_norm_act": lambda: phase_bn_entry(torch, counters),
              "remat_train": lambda: phase_remat(torch, counters, smi),
              "trainer": lambda: phase_trainer(torch, counters, smi),
              "presets": lambda: phase_presets(torch, counters, smi),
              "bf16_engines": lambda: phase_bf16_engines(torch, counters, smi),
              "int8_serve": lambda: phase_int8_serve(torch, checks, counters),
              "configs": lambda: phase_configs(torch, checks, counters, smi),
              "artifact": lambda: phase_artifact(torch, counters),
              "converge": lambda: phase_converge(torch, counters),
              "parallel": lambda: phase_parallel(torch, smi)}
    # run alone only (``parallel`` runs it where the machine has the cards)
    solo = {"parallel_nccl": lambda: phase_parallel_nccl(torch, smi)}
    if args.phases:
        names = args.phases.split(",")
        require(set(names) <= set(phases) | set(solo), f"unknown phases in {names}")
        for name in names:
            _timed_phase(name, {**phases, **solo}[name])
        require("jax" not in sys.modules, "jax was imported")
        print(nvidia_smi(), flush=True)
        return
    results = _timed_phase("kernels", lambda: phase_kernels(checks, list(checks.KERNELS),
                                                            build))
    paths = {name: _timed_phase(name, run) for name, run in phases.items()}
    emit({"phase_seconds": PHASE_SECONDS})
    require("jax" not in sys.modules, "jax was imported")
    launched = {name: sum(p.get(name, 0) for p in paths.values()) for name in KERNEL_SOURCES}
    require(all(launched.values()), f"kernels no main path launched: "
            f"{[k for k, v in launched.items() if not v]}")

    rows = []
    for name, (src, ref) in KERNEL_SOURCES.items():
        every = results[name]
        # K1's tiles under spatial partitioning (JAX's explicit padding)
        # apart: the rest are the cases earlier trees sum
        tiles = [r for r in every if r["case"].startswith(checks.TILE)]
        rs = [r for r in every if not r["case"].startswith(checks.TILE)]
        by = {}
        for r in rs:  # the bound that sets most of the summed least time
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
        extra = {}
        covered = [r for r in rs if r.get("library_ms") is not None]
        if 0 < len(covered) < len(rs):  # the yardstick over the cases it takes
            extra["library_covered"] = {
                "cases": len(covered), "library_ms": checks.total(covered),
                "library_device_ms": checks.total(covered, "library_device_ms"),
                "device_ms": checks.total(covered, "device_ms")}
        prefix = checks.APART.get(name)
        if prefix:  # cases summed apart from the rest, by label
            for key, part in (("apart", [r for r in rs if r["case"].startswith(prefix)]),
                              ("rest", [r for r in rs if not r["case"].startswith(prefix)])):
                extra[key] = {"cases": len(part), "ms": checks.total(part, "ms"),
                              "device_ms": checks.total(part, "device_ms"),
                              "bound_ms": checks.total(part, "bound_ms"),
                              "host_us": checks.total(part, "host_us")}
        if tiles:
            extra["tiles"] = {key: checks.total(tiles, key) for key in (
                "ms", "device_ms", "plain_ms", "bound_ms", "host_us")}
            extra["tiles"].update(cases=len(tiles),
                                  max_abs_err=max(r["max_abs_err"] for r in tiles))
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": ref,
            "launches": launched[name],
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "ms": sum(r["ms"] for r in rs),
            "host_us": sum(r["host_us"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": max(by, key=by.get),
            "library_ms": checks.total(rs),
            "device_ms": checks.total(rs, "device_ms"),
            "library_device_ms": checks.total(rs, "library_device_ms"), **extra})
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
