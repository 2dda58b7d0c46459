#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ddgan_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA. It drives the port's two sampler paths, its two
train steps, its train loop through both train CLIs, its evaluation (FID
through the sampler CLI, the Inception Score), the PSO optimizer, loop and
hyperparameter search, the content.ckpt bridge, every generator option,
the legacy layer library, data parallelism, with seeded weights, the
datasets of image files, LUNA16 volumes and LMDBs, remat and the sampler
CLI over ranks, and fails (non-zero exit) if any phase fails. Each phase
prints its wall time.

The flagship CIFAR-10 T=4 sampler (NCSN++ nf 128, ch_mult 1 2 2 2, batch 64):

  1. print the card's name and power limit (nvidia-smi), and whether PIL,
     lmdb and torchvision import here (each tried in a subprocess; phases
     47-49 use PIL as their reference, the port never imports it);
  2. build both CUDA kernels from ddgan_torch/csrc/ (sm_90a), one nvcc
     each, started together: fir2x.cu and pair_conv3x3.cu, printing what
     ptxas reports for each kernel (registers, shared memory, spills) and
     one summary line per kernel; with them, one host compiler for each
     image decoder of csrc/ (JPEG, TIFF, WebP, GIF), which later phases
     load built;
  3. hold down2x / up2x against their plain PyTorch versions at every
     flagship shape, f32 and bf16, symmetric and asymmetric taps, and up2x
     at odd sides (5 x 7: the scalar path) and at D's 4-wide backward
     shape (4, 512, 4, 4);
  4. build the generator with non-trivial weights (output std > 0.05);
  5. run the T=4 sampler at batch 64 in f32 (TF32 off for matmuls and
     cuDNN) and compare its first 16 rows with the port's plain path on the
     CPU, on the same weights, x_init, z's and noises (max-abs <= 2e-3);
  6. check the launch counts: 6 down2x and 6 up2x per generator forward,
     24 of each per sampler call, and no pair_conv3x3 (no flagship conv
     passes its gate);
  7. the main path: the sampler CLI (`ddgan_torch.cli.test_cli`) on a temp
     experiment with a content_args.json and netG_1.pth written here, with
     the launch counts reset before it and read after; then its FID-set
     loop `generate_samples`; the PNGs must appear;
  8. time the sampler (bf16 as the recipe sets it, and f32) and each FIR
     kernel beside its plain version, the one PyTorch call that computes
     the same function, and its bound; per kernel, the lowest share of the
     bound over the shapes whose bound is >= 5 us, and the shapes where the
     library call is faster;
  9. profile a bf16 sampler call: device time by kernel class and the
     share of the call's time that the device spends in kernels.

The CelebA-HQ 256 T=2 sampler (nf 64, ch_mult 1 1 2 2 4 4, 2 resblocks,
attention at 16, n_mlp 3; batch 16):

 10. hold pair_conv3x3 against its plain version at the four shapes of the
     generator's gated convs at batch 16 and at batch 2, and at an edge of
     its gate, (3, 2, 160, 160) (max-abs <= 1 bf16 ulp of max|ref|), and
     check that gated-out shapes and dtypes raise;
 11. hold down2x / up2x against their plain versions at the 256² shapes,
     down2x at bf16 rows of 24 bytes (its scalar path), and up2x at W 6
     (its scalar path at even sides), at odd H on the vector path and at
     rows wider than a warp (W 260);
 12. build the full-width generator with weights N(0,1)/sqrt(fan_in): its
     parameter count and output std (> 0.05);
 13. run the T=2 sampler in f32, TF32 off, against the CPU plain path at
     batch 2 (max-abs <= 2e-3; pair_conv3x3 is gated off in f32);
 14. run it in bf16 at batch 16: 46 pair_conv3x3, 20 down2x and 20 up2x
     launches, and the output within 0.03 max-abs of the f32 GPU run (the
     bound of tests/test_torch_ncsnpp.py::test_bf16_close_to_f32);
 15. the main path: the sampler CLI on a temp CelebA-HQ 256 experiment,
     launch counts reset before it and read after; 256² PNGs must appear;
 16. time the sampler (samples/s, bf16 and f32) and pair_conv3x3 per shape
     beside its bound, its plain version and the library call
     (`F.conv2d` in bf16, timed only), and the FIR kernels at 256², each
     with its TFLOP/s or GB/s and its share of the bound, and the summary
     lines of phase 8;
 17. profile a bf16 call, with pair_conv3x3 as its own kernel class.

Training (`ddgan_torch.train.make_train_step`), the CelebA-HQ 256 recipe
(DiscriminatorLarge ngf 64, r1_gamma 2, lazy_reg 10, batch 4, bf16) and the
flagship one (DiscriminatorSmall, r1_gamma 0.02, lazy_reg 15, batch 64):

 19. down2x / up2x gradients against autograd through their plain versions,
     first order and R1's second order, at DiscriminatorLarge's (batch 4),
     DiscriminatorSmall's and both generators' shapes and at odd sides (a
     down2x output of 3 x 5, an up2x input of 5 x 7), f32 and bf16;
 20. pair_conv3x3's VJP against autograd through its plain version at the
     four gated shapes at batch 4 (dx within 1 bf16 ulp, dW within 2, db
     against float64), the dx route by the gate, and a refused input;
 21. the full-width 256² G and DiscriminatorLarge and their parameter counts;
 22. one D and G update (R1 on) in f32, TF32 off, on the GPU against the
     port's CPU path, batch 2: losses, penalty, every gradient, parameters;
 23. 11 bf16 steps of the 256² recipe at batch 4 from its init: launches
     per step by kernel and role (pair_conv3x3 64: 46 forward, 18 dx; FIR
     as `expected_fir_calls`), finite losses and parameters; 6 steps at
     lr 1e-7 against the same run in f32 within 5e-2 max |Δloss|;
 23b. step 0 of the recipe at its lr, where Adam's first, sign-like step
     moves D's output by tens and bf16 and f32 separate: bf16 with the
     kernels against bf16 with their plain versions on the card (losses,
     D's and G's gradients, errG against the same updated D) and against
     f32, D's step-0 gradient swapped between the precisions, which must
     carry errG across, and the plain versions' own bf16 step, which must
     separate from f32 too (`first_step_attribution`);
 24. the flagship step: f32 GPU against CPU at batch 4, then 3 bf16 steps at
     batch 64 with dropout 0.1 (no pair_conv3x3);
 25. ms per bf16 step (R1 steps and the others apart), samples/s, peak
     memory, and each kernel's time per step by role beside its bound, its
     plain version and the library call (K2's dx as the step launches it:
     the forward weight, flipped in the kernel, no bias), each launch shape
     on its own line, and per role the summary lines of phase 8;
 26. profile two bf16 256² steps: device time by kernel class, K1 and K2 by
     role, the busy share and the kernel launches per step;

The train loop (`ddgan_torch.train.loop`) through the CLIs, each run in a
temporary working directory whose ./configs/config.json it writes:

 27. the flagship recipe in bf16 at batch 64 through the quality soak
     tool's functions (`tools/quality_soak_torch.py`, the JAX soak's
     flags, on 512 of its CIFAR-10 pickle images: 8 steps an epoch, netG
     and content.pth every epoch, R1 at steps 0 and 15): its data and
     the statistics of 256 real PNGs; `python -m ddgan_torch.cli.train_cli`
     in a subprocess, killed with SIGKILL one second after the content.pth
     save of its first epoch; then the same command with --resume in this
     process: it must load that checkpoint (at most the cut epoch redone),
     keep losses.json's entries up to that epoch verbatim and end it at
     epoch 2, write content.pth with global_step 16 and netG files that
     load with strict=True, and launch K1 per `expected_fir_calls` for
     each of its steps; the sampler CLI then writes 64 PNGs from the last
     netG_*.pth; then the tool's raw and EMA snapshot of content.pth (the
     EMA equal to netG_1, the raw G not), one EMA FID point of 256 samples
     through `test_cli --compute_fid` (one sampler call's launches, a
     finite FID > 0) and the tool's record (continuity, events, the JAX
     record beside it);
 28. the CelebA-HQ 256 recipe in bf16 at batch 4 on `synthetic` 256² data
     through `ddgan_torch.cli.main_cli` in this process (3 epochs of 4
     steps): K2 64 launches a step (46 forward, 18 dx) and K1 per
     `expected_fir_calls`, then the sampler CLI at 256²; both phases print
     the loop's ms per step without the epoch-end saves (from its epoch
     lines; phase 27 also from the subprocess, a fresh process) beside
     phase 25's bare step and the bare step timed on the run's own state
     right after it, for the same mix of R1 steps, samples/s, and the bytes
     and seconds of each checkpoint write and of the resume's read;

Evaluation (`ddgan_torch.eval`), with seeded random Inception weights (no
real ones are in the repository):

 29. FID-InceptionV3 with `random_fid_inception_logits_params(0)`: 16
     seeded images at 32² (grown to 299) and at 512² (shrunk), all four
     blocks and the logits on the GPU (f32, TF32 off) against the CPU
     (max-abs <= 1e-4 of max|ref|); one batch of 50 at 299² timed beside
     its bound (the multiply-adds of one forward, counted from the layer
     shapes, at 67 TFLOP/s f32);
 30. the main path: `test_cli --compute_fid` on the full-width flagship at
     batch 64 (phase 7's weights in a netG_1.pth), 2,112 samples against
     2,112 seeded 32² images that the phase writes, PNGs with a row filter
     chosen as PIL chooses it (the files a user's real directory holds)
     and every 16th file in one of 20 other layouts in turn (24-bit and
     8-bit palette BMP, PPM, PGM, TIFF with LZW, Deflate or PackBits,
     progressive and arithmetic-coded JPEG, 16-bit, Adam7 and 4-bit
     palette PNG, CCITT T.6 and T.4 2-D TIFF, YCbCr 4:2:0 JPEG-in-TIFF,
     LZMA float TIFF with predictor 3, signed 16-bit TIFF, BigTIFF, 4:4:0
     and 4:1:1 JPEG; the tests' writers and PIL write them): 24
     down2x and 24 up2x launches per sampler call and no pair_conv3x3, a
     finite FID > 0 that fid_output_path holds, the same FID from .npz
     statistics of both directories (`save_statistics`) within 1e-6
     relative, and the real directory against its own statistics within
     1e-3 of trace(sigma); the seconds of sampling (the device span of the
     calls), PNG encoding, PNG decoding, Inception and the Fréchet distance
     (sqrtm) apart, and samples/s of the whole CLI call; then the FID
     loader on the real set (every file equal to this host's PIL, and to
     the pixels written where the file is lossless; ms per image of the
     whole set and of its PNGs alone, each layout beside PIL's) and on
     100 filtered 256² PNGs, every image exact, ms per image;
 31. the Inception Score: the CelebA-HQ 256 bf16 sampler at batch 16 writes
     256 samples as one .npy stack (46 pair_conv3x3, 20 down2x and 20 up2x
     launches per call), which `ddgan_torch.eval.inception_score.main`
     scores (splits 1, random logits): finite and >= 1, timed;

PSO (`ddgan_torch.train.pso_optim`, `pso_step`, the loop's PSO branch, the
HPO search `ddgan_torch.pso`) and a run between the packages
(`ddgan_torch.compat.content`):

 32. `AdaptivePSO.step` at DiscriminatorSmall's full parameter set (swarm
     20) on the card against the CPU plain path on the same draws, drawn on
     the card and copied: two steps (every particle improving; equal
     fitness values), every swarm tensor and the parameters within 1e-6 of
     their max-abs, whether bit-exact printed; then G's full set on the
     card: ms per swarm step for G and D (CUDA events), kernel launches, the
     bytes bound at 3.35 TB/s and peak memory;
 33. three full-width flagship PSO steps in f32 (TF32 off) at batch 4, swarm
     3 and trigger 2 (the third fires both swarms), on the card against the
     CPU plain path with injected `StepDraws` and `PSODraws`: losses within
     2e-3 max-abs; after the firing G's and D's parameters equal bit for
     bit the previous global best or one particle's pre-update position;
 34. the flagship recipe with kind_of_optim 'pso' through `train_cli` in
     this process: bf16, batch 64, synthetic 32² data, 22 steps an epoch,
     epochs 0 and 1, no content.pth: 30 down2x and 12 up2x forward launches
     a step and no other role, no pair_conv3x3, finite losses, losses.json,
     final_loss.txt, netG_*.pth, 4 updates of each swarm (the 21st step and
     the epoch end, twice); ms per step with and without a swarm update,
     samples/s, the epoch-end swarm seconds, peak memory, the bytes a
     content.pth would hold; the sampler CLI's 64 PNGs;
 35. the same at nf and ngf 32 with content.pth: two epochs, then --resume
     for a third; the loaded swarms, ring buffers, counters and EMA equal
     the first run's final state bit for bit and the global step continues;
     bytes and seconds of each write and read;
 36. `python -m ddgan_torch.pso.cli` in process, in a directory holding
     copies of the repository's configs (dataset synthetic and no
     content.pth, the rest as shipped: 64², 1 channel, nf 128, batch 16): 2
     particles x 2 iterations at 1 step an epoch with combined scoring, the
     pso-optim preset (1 x 1), and one evaluation in a subprocess; every
     score finite or inf, best_hyperparameters.json written, no pso_eval_*
     directory or configs/config_*.json left, the repository's
     configs/config.json unchanged (sha256); seconds per evaluation, FIR
     calls by role;
 37. phase 27's content.pth to content.ckpt and back through `python -m
     ddgan_torch.compat.content`, equal bit for bit (the optimizers'
     learning rate apart), and `train_cli --resume` from content.ckpt
     alone; bytes and seconds each way;

The generator options (`FAMILIES`: DDPM and one-adaGN resblocks, the
output and input pyramids, the Fourier embedding, naive resampling, no
time conditioning, inputs in [0, 1], no tanh), the buffer in the bridges,
and the legacy layer library:

 38. down2x / up2x against their plain versions at the pyramids' (B, 3, H,
     W) planes, H 256 down to 4, B 16 and 64, f32 and bf16, forward and
     first- and second-order gradients; the pyramids' bf16 launch shapes
     timed beside their bounds (phase 8's rows);
 39. each family at flagship width with N(0,1)/sqrt(fan_in) weights: one
     f32 forward at batch 2 on the card (TF32 off) against the CPU plain
     path (max-abs <= 2e-3, output std > 0.05) at t >= 1, and for the
     Fourier family a batch whose row at t = 0 is not finite on either
     device (it embeds log t, as the JAX package does); one bf16 forward at
     batch 64 whose FIR launches equal `expected_g_fir` (the pyramids add
     one up2x or down2x per transition; a DDPM Upsample / Downsample with
     FIR and no conv one call), and no pair_conv3x3;
 40. `pyramid_sum` (NCSN++'s 256² option set) at the CelebA-HQ 256
     recipe's widths: the T=2 sampler in bf16 at batch 16 (30 down2x, 30
     up2x and 46 pair_conv3x3 launches a call; within 0.03 of the f32 run
     on the card), one f32 D and G update with R1 on the card against the
     same update with the kernels' plain versions on the card at batch 2
     (the bounds of phase 22), three bf16 steps at batch 4 from the
     recipe's init (launches by role: `expected_fir_calls` with the
     pyramids' roles, the input pyramid's down2x without a backward; K2's
     64 of the recipe), ms per step and samples/s beside the recipe's, each
     timed here, peak memory, and the sampler beside the recipe's;
 41. `pyramid_sum` at flagship width through `python -m
     ddgan_torch.cli.train_cli` (bf16, batch 64, synthetic 32², 2 steps an
     epoch, R1 at step 0) in this process: epochs 0 and 1, then --resume
     for epoch 2 (launches by role as the formula says), the checks of
     phase 27, and the sampler CLI's 64 PNGs;
 42. a full-width `pyramid_cat_fourier_one` state (G holds the Fourier W as
     a buffer) as an Adam run and as a PSO run (swarm 1) through
     content.pth -> content.ckpt -> content.pth, equal bit for bit, W in
     buffers_G and never in params_G, Adam, the EMA or a swarm; its netG
     written in the JAX package's layout and loaded by `load_netg_ckpt`
     with strict=True; bytes and seconds of each;
 43. every class of `nn/legacy.py` and both `ops/fused_act.py` functions
     once on the card against the CPU, f32, TF32 off (<= 1e-5 of max|ref|);

Data parallelism (`ddgan_torch.parallel`, `train/zero1.py`). The card is
one GPU, and NCCL refuses two ranks on one device, so the ranks here are
one NCCL rank, or two gloo ranks sharing the card:

 44. an NCCL group of size 1 (a `file://` rendezvous) runs `all_reduce`,
     `reduce_scatter_tensor` and `all_gather_into_tensor` on one float32
     buffer of the flagship G's parameter count, each checked and timed
     (CUDA events); then two spawned gloo processes report which of the
     three they take on CUDA tensors;
 45. the flagship from its init, bf16, batch 64, dropout 0.1, four steps
     (R1 at step 0) with the same draws three ways in lockstep: without a
     group, replicated under the size-1 group (equal to the group-less run
     bit for bit, cuDNN deterministic) and ZeRO-1 under it (within rtol
     3e-4, atol 3e-5 of replicated, the JAX package's bounds in
     tests/test_zero1.py, after the first step, whose gradients are the
     same; after each later one its distance is printed: bf16 carries the
     last-bit differences of the two Adam formulas into gradients near
     zero, whose sign-like Adam steps then differ by up to 2·lr); the same
     four steps of replicated and ZeRO-1 in float32, TF32 off, within those
     bounds after every step; then ms per step of the three bf16 runs in
     turns, and the gradient means and ZeRO-1's collectives alone, per
     step;
 46. two gloo ranks sharing the card through `parallel.init_processes` and
     `train.loop.train` (`device` cuda): the flagship at batch 64 per rank,
     one epoch of 2 steps (the one-process emulation first checks that
     every AdaGN of the loop's G starts with gamma-bias 1 and beta-bias 0,
     the JAX package's init); the ranks' weights and EMA equal (a CRC of
     every byte), each rank's FIR calls as `expected_run_calls`, each
     rank's time, peak memory and optimizer bytes; rank 0's weights after
     the first step against a one-process emulation (each shard's losses
     backpropagated at half weight, then the step) within phase 45's
     bounds; rank 0's content.pth resumed by a one-process run for a second
     epoch, and the sampler CLI's 64 PNGs from its netG; and the same two
     ranks with ZeRO-1, in the same launch after the replicated run, if
     phase 44 found that gloo takes its collectives on CUDA tensors (else
     printed as held on the CPU only);
Image files and LUNA16 volumes (`ddgan_torch.data`: the JPEG decoder,
PIL's resize in numpy, the datasets of image files and the cache of
decoded volumes). PIL writes the files and is the reference here; the
package never imports it. The decoder and resize times are this machine's
host:

 47. the JPEG decoder (`data/jpeg.py`, built with the host C++ compiler)
     against PIL on 76 seeded JPEGs (smooth fields plus noise) that PIL
     writes: sizes 1x1, 7x9, 17x33 and 255x257 x quality 50, 75, 95, 100 x
     4:4:4, 4:2:2, 4:2:0 and grey, then each layout with optimized tables,
     restart markers every MCU and every MCU row: every file bit for bit
     (no case has a bound), and a progressive file (refused until the
     decoder read progressive files) equal to PIL's decode;
     ms per 256² q95 4:2:0 image, the port's and PIL's; then `resize`
     against PIL, bilinear and bicubic, "L" and "RGB", shrinking and
     enlarging (171 cases with `Luna16Dataset2`'s crop), bit for bit, and
     the ms of a 256²->64² bicubic and a 320x288->284x256 bilinear;
 48. the CelebA-HQ 256 recipe on `custom` through `main_cli --data_dir`
     (phase 28's run and checks: bf16, batch 4, epochs 0 and 1 of 2 steps,
     K2 64 launches a step and K1 as `expected_fir_calls`, then the sampler
     CLI at 256²) on 64 seeded 320x288 JPEGs written at q95 as
     `tools/quality_soak256.py:61` writes them, 24 baseline, 16
     progressive, 8 arithmetic-coded sequential and 8 progressive (PIL's
     baseline files re-encoded by the tests' `_torch_jpeg_arith.py`), 4 at
     4:4:0 and 4 at h4v1 (true 4:1:1; coded by the tests'
     `_torch_imagewriters.py` with PIL's tables: a set that covers the
     codings, not a traffic mix), the loader's batches 0 and 1 holding one
     of each, with do_resize (284x256), ToTensor, Normalize and CenterCrop
     (256²); then the loop's loader: batches 0 and 1 against the same
     eight files decoded by PIL and put through the JAX package's
     transform arithmetic (copied here; max-abs <= 1e-6), and its seconds
     per batch beside the bare step, on that set and on the same 64
     images written all baseline;
 49. the shipped configs/config.json (luna16, 64², 1 channel, nf 128, batch
     16, T=1, f32) through `main_cli --data_dir ... --limited_slices True`
     on three seeded 256³ int16 volumes with masks written by the port's
     `write_nifti` (the slices-info file scanned from the masks first):
     epochs 0 and 1 of 2 steps, K1 as `expected_fir_calls`, no K2, then
     the sampler CLI. Its 256² slices need do_resize 'yes' (Resize(64),
     PIL's bilinear): a generator built for 64² does not run at 256², in
     either package. Then the loop's loader with the cache of decoded
     volumes and without it (the same batch from both), and `nii_to_png`
     with do_resize_to (64, 64) over the
     slices-info file, every PNG equal to PIL's bicubic of its slice;

LMDB datasets, remat and the sampler CLI over ranks (`ddgan_torch.data.lmdb`,
`data.lmdb_datasets`, `models.ncsnpp`'s use_remat, `cli.test_cli`). The
LMDB files come from the tests' writer (`tests/_torch_lmdb.py`, loaded by
path): no `lmdb` package is needed, and where one imports it is the
reference too:

 50. the LMDB reader on this host: the writer's files (depth >= 3, inline
     values and overflow runs on both sides of LMDB's nodemax, the newer
     of two meta pages, an empty database), every key read back and the
     cursor in key order; ms per get over 20,000 random keys of 126,227
     (LSUN church_outdoor train's size, 2,048-byte values on overflow
     pages); both directions against the `lmdb` package if it imports;
 51. the LSUN Church Outdoor 256 recipe (`tools/bench_extra.py:192-206`:
     the 256² network, DiscriminatorLarge, T=4, r1_gamma 1, bf16, batch
     8) through `main_cli --dataset lsun --data_dir` on a
     church_outdoor_train_lmdb of 64 seeded 341 x 256 JPEGs (q95, PIL)
     under 40-hex-character keys, with do_resize, ToTensor, Normalize and
     CenterCrop (256²) and the port's "auto" remat: epochs 0 and 1 of 2
     steps, K1 and K2 by role as the formulas with the recompute term of
     the remat "auto" picks, the sampler CLI at 256², T=4; the key cache
     written in epoch 0 and read, not rebuilt, by a --resume for epoch 2;
     batch 0 of the loader against PIL + the JAX transform arithmetic
     (<= 1e-6) and the loader's seconds a batch beside the bare step;
 52. celeba_256 through `make_dataset` on a train.lmdb of 27,000 keys "0"
     .. "26999" whose values cycle over 64 seeded 64² JPEGs: len 27000,
     items 0, 9, 10, 13500 and 26999 (resized to 256²) against PIL + the
     JAX arithmetic (<= 1e-6), ms an item; a raw-mode LMDB of 8 entries;
 53. the lsun256 bf16 step at batch 8 with remat off, "full" and
     "save-convs" from the same state and draws (an R1 step and one
     without, cuDNN deterministic): G's gradients and weights, the EMA
     and D equal bit for bit; launches by role (K2's recompute term under
     "full", K1's under both) and under "save-convs" as many conv runs as
     without remat; then three R1-free steps of each in turns, ms and the
     peak memory above the resident state;
 53b. `test_cli.main` with `--num_process_per_node 2 --device cuda:0` (a
     `file://` rendezvous) on the full-width flagship (saved with
     what_backend gloo): an FID set of 256 at 64 a rank, every PNG equal to a one-process
     emulation of the two ranks, the FID printed and written once after
     the last PNG; plain sampling of 63 over the two ranks, the same;

WebP (`ddgan_torch.data.webp`, C++ built with the host C++ compiler, the
format of the LSUN release's LMDB values); PIL writes the files and is the
reference:

 54. the WebP decoder against PIL on this host (PIL's and its libwebp's
     versions printed): every file of the tests' matrix
     (`tests/_torch_webp.py`, loaded by path: lossy sizes 1x1 to 40x1100 x
     qualities 0-100 x methods 0, 4, 6; "L", "RGB", "RGBA" with ALPH and
     ICC/EXIF/XMP chunks; lossless fields and palettes of 2-200 colours;
     frame 0 of four animations and of a built one at an offset; and where
     the bundled libwebp loads through ctypes, its WebPEncode's files with
     the simple filter, every sharpness, 1-4 segments and 1-8 partitions)
     bit for bit, every malformed file of the matrix refused with
     ValueError; ms per 341x256 lossy image, the port's and PIL's, in
     turns on this host's clock;
 55. the LSUN Church Outdoor 256 recipe of phase 51 (bf16, batch 8, T=4)
     through `main_cli --dataset lsun --data_dir` on a
     church_outdoor_train_lmdb of WebP values, the release's format: 64
     seeded 341 x 256 lossy WebPs at qualities 60-95 and methods 0-6 and 4
     lossless ones, written by PIL under 40-hex-character keys: one epoch
     of 2 steps (R1 at step 0), K1 and K2 by role as phase 51's formulas
     count them, the sampler CLI at 256²; batch 0 of the loop's loader
     against PIL + the JAX transform arithmetic (<= 1e-6), and its ms a
     batch beside the bare step (phase 51's JPEG share beside it);

BMP, PBM/PGM/PPM and TIFF (`ddgan_torch.data.bmp`, `data.netpbm`,
`data.tiff` with C++ LZW, PackBits and CCITT, JPEG strips through the
JPEG decoder), progressive, arithmetic-coded, CMYK and RGB-coded JPEG at
any integral sampling and PNG at every bit depth and with Adam7, all
through `utils.decode_images`; the tests' writers and PIL write the files
and PIL is the reference:

 56. every file of the tests' matrices (`tests/_torch_imagewriters.py` and
     `tests/_torch_jpeg_arith.py`, loaded by path: CCITT, JPEG-in-TIFF,
     old-style JPEG, YCbCr, LZMA, BigTIFF, float, signed and fill order 2
     TIFF, JPEG at 4:4:0,
     4:1:1 and other samplings, lossless JPEG at every predictor among
     them, PFM and Pillow's other Netpbm magics, GIF, TGA and ICO, and the
     layouts once refused)
     against this host's PIL, bit for bit; their malformed files refused
     with ValueError and their still-refused layouts (arithmetic-coded
     lossless, hierarchical and 12-bit JPEG, non-integral sampling ratios,
     lossless JPEG asking for a colour conversion, JPEG whose
     scans libjpeg would smooth, old-style JPEG with its tables in tags,
     Zstd, uncompressed YCbCr, 4x4 YCbCr at an odd block count, CIELAB and
     big-endian BigTIFF TIFF, BMP with JPEG inside, a GIF without a frame,
     TGA layouts PIL cannot decode)
     with NotImplementedError naming item 13i; ms per image, the port's
     and PIL's in turns: at 256², a q95 4:2:0 JPEG baseline, progressive
     and arithmetic-coded, an LZW TIFF, a 24-bit BMP, a 16-bit PNG, a YCbCr
     4:2:0 JPEG-in-TIFF, a float TIFF, a 4:4:0 JPEG, an interlaced 8-bit
     GIF and an RLE TGA; a 1728x2200 CCITT Group 4 page;
 57. print the result, a `{"kernels": [...]}` line (the forward entries and
     one per backward role, with the launches of every driven path, the
     pyramids' 3-channel shapes timed beside each FIR kernel's rows), and
     the `{"ok": true, ...}` line last.

It imports nothing of JAX or of the JAX package, and exits non-zero
without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import io
import json
import logging
import math
import os
import pickle
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
BATCH = 64
T = 4
BATCH_256 = 16
T_256 = 2
CPU_ROWS = 16  # rows of the flagship sampler's batch that phase 5 also runs on the CPU
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
FIR = (1.0, 3.0, 3.0, 1.0)
FIR_ASYM = (1.0, 2.0, 3.0, 4.0)
# flagship FIR inputs (B, C, H, W): the down blocks at 32/16/8, the up blocks at 4/8/16
DOWN_SHAPES = [(BATCH, 128, 32, 32), (BATCH, 256, 16, 16), (BATCH, 256, 8, 8)]
UP_SHAPES = [(BATCH, 256, 4, 4), (BATCH, 256, 8, 8), (BATCH, 256, 16, 16)]
# CelebA-HQ 256 FIR inputs: the down blocks at 256..16, the up blocks at 8..128
DOWN_SHAPES_256 = [(BATCH_256, 64, 256, 256), (BATCH_256, 64, 128, 128),
                   (BATCH_256, 128, 64, 64), (BATCH_256, 128, 32, 32), (BATCH_256, 256, 16, 16)]
UP_SHAPES_256 = [(BATCH_256, 256, 8, 8), (BATCH_256, 256, 16, 16), (BATCH_256, 128, 32, 32),
                 (BATCH_256, 128, 64, 64), (BATCH_256, 64, 128, 128)]
# CelebA-HQ 256 gated convs: (C_in, side) -> convs per generator forward
PAIR_CONVS = {(64, 256): 9, (128, 256): 3, (64, 128): 9, (128, 128): 2}
REPLACES = {
    "down2x": "ddgan_tpu/ops/experimental/pallas_upfirdn.py:133",
    "up2x": "ddgan_tpu/ops/experimental/pallas_upfirdn.py:158",
    "pair_conv3x3": "ddgan_tpu/ops/experimental/pallas_conv.py:189",
}
HOST_SOURCES = ["jpeg_decode.cpp", "tiff_decode.cpp", "webp_decode.cpp", "gif_decode.cpp"]
SOURCES = {
    "down2x": "ddgan_torch/csrc/fir2x.cu",
    "up2x": "ddgan_torch/csrc/fir2x.cu",
    "pair_conv3x3": "ddgan_torch/csrc/pair_conv3x3.cu",
}


# The generator option families (options over a recipe's config), and the
# FIR roles each has (`expected_g_fir`'s keywords): a BigGAN or one-adaGN
# resampling block runs the kernel twice (h and the skip), a DDPM
# Upsample / Downsample with FIR and no conv once, and any other resampling
# (naive, or FIR fused with a conv) not at all; the output pyramid adds an
# up2x per transition and the input pyramid a down2x.
FAMILIES = {
    "pyramid_sum": dict(progressive="output_skip", progressive_input="input_skip",
                        progressive_combine="sum"),
    "pyramid_cat_fourier_one": dict(progressive="output_skip", progressive_input="input_skip",
                                    progressive_combine="cat", embedding_type="fourier",
                                    resblock_type="biggan_oneadagn", attn_resolutions=[]),
    "residual_pyramid": dict(progressive="residual", progressive_input="residual"),
    "ddpm_fir": dict(resblock_type="ddpm", fir=True, resamp_with_conv=False, not_use_tanh=True,
                     skip_rescale=False, attn_resolutions=[]),
    "ddpm_fir_conv": dict(resblock_type="ddpm", fir=True, resamp_with_conv=True),
    "naive": dict(fir=False, progressive_input="none"),
    "ddpm_naive": dict(resblock_type="ddpm", fir=False, resamp_with_conv=True),
    "uncond_uncentered": dict(conditional=False, centered=False),
}
FAMILY_FIR = {
    "pyramid_sum": dict(out_pyramid=True, in_pyramid=True),
    "pyramid_cat_fourier_one": dict(out_pyramid=True, in_pyramid=True),
    "residual_pyramid": {},
    "ddpm_fir": dict(g_resample=1),
    "ddpm_fir_conv": dict(g_resample=0),
    "naive": dict(g_resample=0),
    "ddpm_naive": dict(g_resample=0),
    "uncond_uncentered": {},
}


def expected_g_fir(n_g: int, g_resample: int = 2, out_pyramid: bool = False,
                   in_pyramid: bool = False) -> dict:
    """FIR calls of one generator forward with `n_g` transitions each way:
    `g_resample` per resampling block, and one per transition for each
    pyramid (FAMILY_FIR)."""
    return {"down2x": n_g * (g_resample + int(in_pyramid)),
            "up2x": n_g * (g_resample + int(out_pyramid))}


def expected_fir_calls(n_d: int, n_g: int, r1: bool, shared: bool, *, g_resample: int = 2,
                       out_pyramid: bool = False, in_pyramid: bool = False,
                       remat: bool = False) -> dict:
    """FIR calls of one train step by pattern and role, for a discriminator
    with `n_d` downsampling blocks and a generator with `n_g` transitions
    each way (its FIR calls per forward as `expected_g_fir`). Each D forward
    runs down2x twice per downsampling block (the block's output and its
    skip input); D runs on the fakes and on x_t in the D update, once more
    on x_t for a recomputed (not shared) R1, and on the fakes of the G
    update. Every D forward is differentiated once more in its update, and
    an R1 step differentiates D(x_t) a second time for the penalty, whose
    own backward is the second order. G runs twice (the D update's fakes
    under no_grad, the G update) and is differentiated once: each of its
    calls on a tensor that needs a gradient gets one backward call, which
    leaves out the input pyramid's down2x (it acts on x_{t+1}). The
    backward of down2x is an up2x call and the backward of up2x a down2x
    call (`ddgan_torch/ops/fir2x.py`). With `remat` (BigGAN resblocks
    checkpointed, under either policy) G's backward recomputes each
    resblock's forward, so the resblocks' FIR forwards run once more: the
    recompute term, n_g · g_resample of each."""
    if remat and g_resample == 1:
        raise ValueError("a DDPM Upsample / Downsample is not a resblock: remat does not "
                         "recompute its FIR call")
    per_d = 2 * n_d
    d_fwd = 3 + int(r1 and not shared)
    d_bwd = d_fwd + int(r1)
    g = expected_g_fir(n_g, g_resample, out_pyramid, in_pyramid)
    g_down_grad = n_g * g_resample  # the input pyramid's down2x needs no gradient
    recompute = n_g * g_resample if remat else 0
    return {
        "down2x": {"forward": d_fwd * per_d + 2 * g["down2x"] + recompute,
                   "backward": g["up2x"], "second_order": per_d if r1 else 0},
        "up2x": {"forward": 2 * g["up2x"] + recompute,
                 "backward": d_bwd * per_d + g_down_grad, "second_order": 0},
    }


# K2's calls a bf16 step of the 256² recipes by role (46 forward: 23 gated
# convs in each of G's two forwards; 18 dx through the kernel, 5 through the
# library), and with remat "full" the recompute term: G's backward runs each
# resblock's forward again, and every gated conv sits in a resblock
K2_PER_STEP_256 = {"forward": 46, "dx": 18, "dx_library": 5}


def expected_k2_per_step(remat_policy: str | None) -> dict:
    return {**K2_PER_STEP_256,
            "forward": K2_PER_STEP_256["forward"] + (23 if remat_policy == "full" else 0)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


PHASE_S: dict = {}
_PHASE_T = [time.perf_counter(), None]


def phase(name: str) -> None:
    """Start phase `name`; print the wall time of the one before."""
    now = time.perf_counter()
    if _PHASE_T[1] is not None:
        PHASE_S[_PHASE_T[1]] = now - _PHASE_T[0]
        print(f"   ({_PHASE_T[1].split()[0]}: {now - _PHASE_T[0]:.1f} s)", flush=True)
    _PHASE_T[:] = [now, name]
    print(f"== {name}", flush=True)


def flagship_config(Config):
    """The CIFAR-10 recipe of `__graft_entry__._flagship_config` (weights random)."""
    return Config(
        dataset="cifar10", image_size=32, num_channels=3,
        num_channels_dae=128, ch_mult=[1, 2, 2, 2], num_res_blocks=2,
        attn_resolutions=[16], nz=100, z_emb_dim=256, n_mlp=4,
        t_emb_dim=256, ngf=64, num_timesteps=T, batch_size=BATCH,
        lr_d=1.25e-4, lr_g=1.6e-4, r1_gamma=0.02, lazy_reg=15,
        ema_decay=0.9999, dropout=0.1, beta1_g=0.5, beta2_g=0.9,
        beta1_d=0.5, beta2_d=0.9, compute_dtype="bfloat16",
    )


def celeba256_config(Config):
    """The CelebA-HQ 256 paper recipe of `tools/bench_extra.py:105-113`
    (readme.md:50-57 of the reference), weights random."""
    return Config(
        dataset="celeba_256", image_size=256, num_channels=3,
        num_channels_dae=64, ch_mult=[1, 1, 2, 2, 4, 4], num_res_blocks=2,
        attn_resolutions=[16], nz=100, z_emb_dim=256, n_mlp=3,
        t_emb_dim=256, ngf=64, num_timesteps=T_256, batch_size=BATCH_256,
        r1_gamma=2.0, lazy_reg=10, ema_decay=0.999, dropout=0.0,
        disc_small="no", compute_dtype="bfloat16",
    )


def taps(kind: str, fir) -> tuple:
    """The separable taps the resample layer hands the kernel (gain 1)."""
    k = np.asarray(fir, np.float64)
    return tuple((k / k.sum() * (2 if kind == "up2x" else 1)).tolist())


def bf16_ulp(v: float) -> float:
    """The spacing of bf16 numbers at magnitude v (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def device_ms(fn, inputs, iters: int) -> float:
    """Device time of one call of `fn`, from CUDA events around `iters`
    calls cycling over `inputs`. A sleep kernel queued first keeps the GPU
    busy for twice the first pass's host time while the host enqueues, so
    host overhead does not show."""
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * host_s * 2e9 + 2e6, 2e10)))
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotation(shape, dtype, out_elems: int, seed: int, max_copies: int | None = None):
    """Copies of one input, enough that inputs and outputs of a cycle
    (> 128 MB) do not stay in the 50 MB L2 cache; at most `max_copies`
    (for a caller whose input was just written, and so is in L2)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    per = (x.numel() + out_elems) * x.element_size()
    n = max(2, math.ceil(128e6 / per))
    n = min(n, max_copies) if max_copies else n
    return [x.clone() for _ in range(n)]


def fir_bound_ms(kind: str, shape, dtype) -> tuple[float, str]:
    n, c, h, w = shape
    planes, item = n * c, torch.empty((), dtype=dtype).element_size()
    if kind == "down2x":
        out = h * w // 4
        flops = planes * (h * (w // 2) * 8 + out * 8)  # 4 taps a pass
    else:
        out = 4 * h * w
        flops = planes * (h * 2 * w * 4 + out * 4)  # 2 taps a pass
    t_bytes = planes * (h * w + out) * item / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pair_bound_ms(shape) -> tuple[float, str]:
    """x and w (bf16) and b (f32) read once, y (bf16) written once, at the
    HBM rate; 2*64*9*C_in flops per output pixel at the bf16 peak."""
    n, c, h, w = shape
    t_bytes = (n * c * h * w * 2 + 64 * c * 9 * 2 + 64 * 4 + n * 64 * h * w * 2) / HBM_BYTES_PER_S
    t_ops = 2 * n * h * w * 64 * 9 * c / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_call(kind: str, k1d):
    """The one PyTorch call that computes the same function (timed only)."""
    k = torch.tensor(np.outer(k1d, k1d), dtype=torch.float32, device="cuda")

    def call(x):
        c = x.shape[1]
        if kind == "down2x":  # correlation with the flipped kernel, pad 1, stride 2
            w = torch.flip(k, (0, 1)).to(x.dtype).expand(c, 1, 4, 4)
            return F.conv2d(x, w, stride=2, padding=1, groups=c)
        # transposed conv applies the flipped kernel to the dilated input
        w = k.to(x.dtype).expand(c, 1, 4, 4)
        return F.conv_transpose2d(x, w, stride=2, padding=1, groups=c)

    return call


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "fir2x" in low or "down2x_kernel" in low or "up2x_kernel" in low:
        return "fir2x"
    if "pair_conv3x3" in low:
        return "pair_conv3x3"
    if any(s in low for s in ("conv", "cudnn", "xmma", "implicit", "winograd", "fft")):
        return "convolution"
    if any(s in low for s in ("gemm", "cutlass", "cublas", "sm90_")):
        return "matmul"
    if "reduce" in low or "norm" in low or "softmax" in low:
        return "reduction/norm/softmax"
    return "elementwise/copy/other"


def profile_sampler(call, call_ms: float, calls: int = 1) -> dict:
    """Device time by kernel class over `calls` sampler calls, and the share
    of a call's time (`call_ms`, timed without the profiler, whose host
    overhead stretches the window it records) that the device spends in
    kernels (they run on one stream)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_class: dict[str, float] = {}
    kernels = []
    for ev in prof.key_averages():
        # kernel entries only: an operator's entry repeats its kernels' time
        us = float(getattr(ev, "self_device_time_total", 0.0))
        if (us > 0 and str(ev.device_type).endswith("CUDA")
                and not getattr(ev, "is_user_annotation", False)):
            cls = _kernel_class(ev.key)
            by_class[cls] = by_class.get(cls, 0.0) + us
            kernels.append((us, ev.count, ev.key))
    busy_us = sum(by_class.values())
    kernels.sort(reverse=True)
    for us, count, key in kernels[:12]:
        print(f"{us / calls / 1e3:9.3f} ms/call {count // calls:6d} launches/call  {key[:90]}")
    out = {
        "calls": calls,
        "call_ms": call_ms,
        "profiled_wall_ms_per_call": wall_us / calls / 1e3,
        "device_busy_ms_per_call": busy_us / calls / 1e3,
        "device_busy_share": busy_us / calls / 1e3 / call_ms if busy_us else None,
        "kernel_launches_per_call": sum(c for _, c, _ in kernels) // calls,
        "ms_per_call_by_class": {k: v / calls / 1e3 for k, v in sorted(by_class.items())},
    }
    if not busy_us:
        print("profiler recorded no device time: device breakdown not measured")
    print(json.dumps({"profile": out}))
    return out


def sampler_ms(call, warmup: int, iters: int) -> float:
    """Mean time of one sampler call, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_summary(report: str) -> list:
    """One line per kernel of a ptxas report: registers and spill bytes."""
    lines, name, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = name = m.group(1)
            for d in re.finditer(r"\d+", mangled):  # <length><name> in the mangled name
                end = d.end() + int(d.group())
                if mangled[d.end():end].endswith("_kernel"):
                    name = mangled[d.end():end]
                    t = re.match(r"I(f|13__nv_bfloat16)Lb([01])E", mangled[end:])
                    if t:
                        name += (f"<{'float' if t.group(1) == 'f' else 'bf16'}, "
                                 f"{'vector' if t.group(2) == '1' else 'scalar'}>")
                    break
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lines.append(f"{name}: {regs} registers; {spill}")
            name = None
    return lines


def share_summary(label: str, rows: list) -> dict:
    """The lowest share of the bound over `rows` whose bound is >= 5 us, and
    the rows where the library call is faster than the kernel."""
    big = [r for r in rows if r["bound_ms"] >= 0.005]
    low = min(big, key=lambda r: r["bound_ms"] / r["ms"]) if big else None
    slower = [f"{tuple(r['shape'])} {r['dtype']}" for r in rows if r["ms"] >= r["library_ms"]]
    out = {"lowest_share": low["bound_ms"] / low["ms"] if low else None,
           "at": f"{tuple(low['shape'])} {low['dtype']}" if low else None,
           "shapes_with_bound_ge_5us": len(big), "shapes": len(rows),
           "library_faster_at": slower}
    print(f"{label}: lowest share of the bound over the {len(big)} of {len(rows)} shapes with a "
          f"bound >= 5 us: " + (f"{out['lowest_share']:.1%} at {out['at']}" if low else "none")
          + f"; library call faster at {len(slower)} shapes {slower}")
    return out


def check_fir_kernels(fir2x, shapes_by_kind, max_abs: dict) -> None:
    """Each FIR kernel against its plain version at `shapes_by_kind`, f32
    (max-abs 1e-5) and bf16 (2e-2 of max|ref|), both tap sets."""
    for name, shapes in shapes_by_kind.items():
        fn, ref = (fir2x.down2x, fir2x.down2x_ref) if name == "down2x" else (fir2x.up2x,
                                                                              fir2x.up2x_ref)
        for i_shape, shape in enumerate(shapes):
            for dtype in (torch.float32, torch.bfloat16):
                for fir in (FIR, FIR_ASYM):
                    g = torch.Generator(device="cuda").manual_seed(i_shape)
                    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
                    k = taps(name, fir)
                    with torch.no_grad():
                        got, want = fn(x, k), ref(x, k)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    scale = want.float().abs().max().item()
                    if dtype == torch.float32:
                        max_abs[name] = max(max_abs[name], err)
                        check(err <= 1e-5, f"{name} {shape} f32 {fir}: max-abs {err}")
                    else:
                        check(err <= 2e-2 * scale, f"{name} {shape} bf16 {fir}: {err} vs {scale}")
                    print(f"{name} {shape} {str(dtype)[6:]} taps {fir}: max-abs {err:.3g} "
                          f"(max|ref| {scale:.3g})")


def time_fir_kernels(fir2x, shapes_by_kind, model: str,
                     dtypes=(torch.bfloat16, torch.float32), max_copies: int | None = None) -> dict:
    """Per-shape rows (kernel, plain, library, bound) for each FIR kernel;
    `max_copies` as `rotation`'s."""
    rows_by_kind = {}
    for name, shapes in shapes_by_kind.items():
        fn, ref = (fir2x.down2x, fir2x.down2x_ref) if name == "down2x" else (fir2x.up2x,
                                                                              fir2x.up2x_ref)
        k = taps(name, FIR)
        lib = library_call(name, k)
        rows = []
        for shp in shapes:
            # in a bf16 forward the h path runs bf16 and the skip path f32
            for dtype in dtypes:
                n_in = math.prod(shp)
                bufs = rotation(shp, dtype, n_in * 4 if name == "up2x" else n_in // 4, seed=3,
                                max_copies=max_copies)
                iters = max(50, len(bufs))
                with torch.no_grad():
                    k_ms = device_ms(lambda x: fn(x, k), bufs, iters)
                    p_ms = device_ms(lambda x: ref(x, k), bufs, iters)
                    l_ms = device_ms(lib, bufs, iters)
                    want = ref(bufs[0], k).float()
                    same = (lib(bufs[0]).float() - want).abs().max().item()
                tol = 1e-5 if dtype == torch.float32 else 2e-2 * want.abs().max().item()
                check(same <= tol, f"library call for {name} computes another function ({same})")
                b_ms, b_by = fir_bound_ms(name, shp, dtype)
                rows.append({"model": model, "shape": list(shp), "dtype": str(dtype)[6:],
                             "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                             "bound_by": b_by})
                moved = math.prod(shp) * (1.25 if name == "down2x" else 5) * bufs[0].element_size()
                print(f"{name} {shp} {str(dtype)[6:]}: kernel {k_ms:.4f} ms, plain {p_ms:.4f}, "
                      f"library {l_ms:.4f}, bound {b_ms:.4f} ({b_by}); kernel at "
                      f"{moved / k_ms / 1e6:.0f} GB/s, {b_ms / k_ms:.1%} of its bound")
                del bufs
        rows_by_kind[name] = rows
        share_summary(f"{name} ({model})", rows)
    return rows_by_kind


# ---------------------------------------------------------------------------
# training phases
TRAIN_BATCH_256 = 4  # the CelebA-HQ 256 recipe's batch per chip (tools/bench_extra.py:173)
TRAIN_STEPS_256 = 11  # R1 fires at steps 0 and 10 (lazy_reg 10)
TRAIN_BATCH = 64  # the flagship recipe's batch
TRAJ_LR = 1e-7  # the lr of the bounded bf16-vs-f32 trajectory
TIMED_STEPS = 2  # `time_steps`: timed steps of each kind, after one warm-up step
# down2x inputs of DiscriminatorLarge (ngf 64) at batch 4: each block's output
# path and skip input, 256² down to 8²
D_LARGE_DOWN = [(4, 256, 256, 256), (4, 128, 256, 256), (4, 512, 128, 128), (4, 256, 128, 128),
                (4, 512, 64, 64), (4, 512, 32, 32), (4, 512, 16, 16), (4, 512, 8, 8)]
# down2x inputs of DiscriminatorSmall (ngf 64) at batch 64
D_SMALL_DOWN = [(64, 256, 32, 32), (64, 128, 32, 32), (64, 512, 16, 16), (64, 256, 16, 16),
                (64, 512, 8, 8)]
REPLACES_BWD = {
    "up2x.backward": "ddgan_tpu/ops/experimental/pallas_upfirdn.py:142",  # _down2x_bwd
    "down2x.backward": "ddgan_tpu/ops/experimental/pallas_upfirdn.py:167",  # _up2x_bwd
    "down2x.second_order": "ddgan_tpu/ops/experimental/pallas_upfirdn.py:167",
    "pair_conv3x3.dx": "ddgan_tpu/ops/experimental/pallas_conv.py:208",  # _bwd
}


def out_shape(kind: str, shape) -> tuple:
    n, c, h, w = shape
    return (n, c, h // 2, w // 2) if kind == "down2x" else (n, c, 2 * h, 2 * w)


def check_fir_grads(fir2x, cases, max_abs: dict) -> None:
    """First- and second-order gradients of each FIR kernel against autograd
    through its plain version: the grad in x of sum(f(a·x)²·r), and the
    grad in the upstream scale a of ‖that grad‖² (R1's grad-of-grad).
    float32: max-abs ≤ 1e-5 of max|ref| and 1e-5 relative for the scalar;
    bfloat16: 2e-2 of max|ref| and 2e-2 relative (one rounding per pass,
    taps rounded to bf16 in the plain version)."""
    for name, shape in cases:
        fn, ref = (fir2x.down2x, fir2x.down2x_ref) if name == "down2x" else (fir2x.up2x,
                                                                              fir2x.up2x_ref)
        for dtype in (torch.float32, torch.bfloat16):
            for fir in (FIR, FIR_ASYM):
                k = taps(name, fir)
                g = torch.Generator(device="cuda").manual_seed(sum(shape))
                x = torch.randn(shape, generator=g, device="cuda").to(dtype)
                r = torch.randn(out_shape(name, shape), generator=g, device="cuda").to(dtype)
                res = []
                for f in (fn, ref):
                    a = torch.ones((), device="cuda", dtype=dtype, requires_grad=True)
                    xi = a * x
                    (gx,) = torch.autograd.grad((f(xi, k).square() * r).sum(), xi,
                                                create_graph=True)
                    (ga,) = torch.autograd.grad(gx.float().square().sum(), a)
                    res.append((gx.detach().float(), ga.float().item()))
                torch.cuda.synchronize()
                (gx, ga), (gx_r, ga_r) = res
                scale = gx_r.abs().max().item()
                err, err2 = (gx - gx_r).abs().max().item(), abs(ga - ga_r) / abs(ga_r)
                tol = 1e-5 if dtype == torch.float32 else 2e-2
                if dtype == torch.float32:
                    max_abs[name + ".grad"] = max(max_abs.get(name + ".grad", 0.0), err)
                check(err <= tol * scale and err2 <= tol,
                      f"{name} grads {shape} {dtype} {fir}: {err} of {scale}, second order {err2}")
        print(f"{name} {shape}: first and second order grads match the plain version "
              f"(f32 and bf16, both tap sets)")


def check_pair_vjp(pair_conv, shapes) -> float:
    """pair_conv3x3's VJP against autograd through its plain version: dx
    within 1 bf16 ulp of max|ref| (both round f32 sums once), dW within 2
    ulp (bf16-rounded on both sides), db within 1e-4 of the float64 sum.
    Returns the largest dx error (max-abs) of the kernel's dx launches."""
    worst = 0.0
    for i, shape in enumerate(shapes):
        n, c, h, w = shape
        g0 = torch.Generator(device="cuda").manual_seed(300 + i)
        x = torch.randn(shape, generator=g0, device="cuda").to(torch.bfloat16)
        wt = torch.randn((64, c, 3, 3), generator=g0, device="cuda") / math.sqrt(9 * c)
        b = torch.randn((64,), generator=g0, device="cuda")
        gy = torch.randn((n, 64, h, w), generator=g0, device="cuda").to(torch.bfloat16)
        grads = []
        pair_conv.reset_launch_counts()
        for f in (pair_conv.pair_conv3x3, pair_conv.pair_conv3x3_ref):
            xi, wi, bi = (t.clone().requires_grad_(True) for t in (x, wt, b))
            f(xi, wi, bi).backward(gy)
            grads.append((xi.grad.float(), wi.grad, bi.grad))
        torch.cuda.synchronize()
        gated = c == 64
        check(pair_conv.CALLS == {"forward": 1, "dx": int(gated), "dx_library": int(not gated)}
              and pair_conv.LAUNCHES["pair_conv3x3"] == 1 + gated, f"{shape}: routes {pair_conv.CALLS}")
        (dx, dw, db), (dx_r, dw_r, db_r) = grads
        ulp = bf16_ulp(dx_r.abs().max().item())
        err = (dx - dx_r).abs().max().item()
        if gated:
            worst = max(worst, err)
        dw_err = (dw - dw_r).abs().max().item()
        dw_ulp = bf16_ulp(dw_r.abs().max().item())
        db_true = gy.double().sum((0, 2, 3))
        db_err = (db.double() - db_true).abs().max().item() / db_true.abs().max().item()
        check(err <= ulp and dw_err <= 2 * dw_ulp and db_err <= 1e-4,
              f"pair_conv3x3 VJP {shape}: dx {err} (ulp {ulp}), dW {dw_err} (ulp {dw_ulp}), "
              f"db {db_err}")
        print(f"pair_conv3x3 VJP {shape}: dx {'kernel' if gated else 'library'} max-abs "
              f"{err:.4g} (1 ulp {ulp:.4g}); dW {dw_err:.4g} (1 ulp {dw_ulp:.4g}); db rel {db_err:.3g}")
    return worst


def build_trainer(cfg, gen_sd, disc_sd, dev, dtype_name: str):
    """(state, step) of a config on `dev` in `dtype_name`, from state dicts."""
    from ddgan_torch.diffusion import DiffusionCoefficients, PosteriorCoefficients
    from ddgan_torch.models import NCSNpp, build_discriminator
    from ddgan_torch.train import ClippedAdam, create_train_state, make_train_step

    c = cfg.replace(compute_dtype=dtype_name)
    gen, disc = NCSNpp.from_config(c), build_discriminator(c)
    gen.load_state_dict(gen_sd)
    disc.load_state_dict(disc_sd)
    state = create_train_state(
        gen.to(dev), disc.to(dev),
        ClippedAdam(gen.parameters(), c.beta1_g, c.beta2_g, c.weight_decay_G, c.grad_clip_norm),
        ClippedAdam(disc.parameters(), c.beta1_d, c.beta2_d, c.weight_decay_D, c.grad_clip_norm),
        use_ema=c.use_ema,
    )
    step = make_train_step(
        DiffusionCoefficients.create(c.num_timesteps, c.beta_min, c.beta_max, device=dev),
        PosteriorCoefficients.create(c.num_timesteps, c.beta_min, c.beta_max, device=dev),
        num_timesteps=c.num_timesteps, nz=c.nz, r1_gamma=c.r1_gamma, lazy_reg=c.lazy_reg,
        ema_decay=c.ema_decay, use_ema=c.use_ema,
    )
    return state, step


def real_batch(cfg, batch: int, seed: int) -> torch.Tensor:
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.uniform(-1, 1, (batch, cfg.num_channels, cfg.image_size,
                                                cfg.image_size)).astype(np.float32))


def compare_step_gpu_cpu(cfg, gen_sd, disc_sd, batch: int, seed: int,
                         plain: tuple | None = None) -> dict:
    """One train step (R1 on, step 0) in float32 with TF32 off on the GPU and
    on the port's CPU plain path, same weights and injected draws. With
    `plain` (fir2x and pair_conv) the reference is the same step on the card
    with the kernels' plain versions in their place (`PlainKernels`) instead
    of the CPU. Losses within 1e-4 relative, the penalty within 1e-3; every
    gradient tensor within 1e-3 of its max-abs (floored at 1e-6 of the
    network's largest gradient, for gradients that are zero in exact
    arithmetic); parameters within 2·lr + 1e-6: Adam's first step moves each
    by about lr·sign(g), so a gradient at the noise floor may flip its
    update."""
    from ddgan_torch.train import StepDraws, draw_step

    dev = torch.device("cuda")
    ref_dev, ref = (dev, "plain") if plain else (torch.device("cpu"), "CPU")
    sg, step_g = build_trainer(cfg, gen_sd, disc_sd, dev, "float32")
    sc, step_c = build_trainer(cfg, gen_sd, disc_sd, ref_dev, "float32")
    real = real_batch(cfg, batch, seed)
    draws = draw_step(real, cfg.num_timesteps, cfg.nz, torch.Generator().manual_seed(seed))
    t0 = time.perf_counter()
    m_g = step_g(sg, real.to(dev), None, cfg.lr_g, cfg.lr_d,
                 draws=StepDraws(*(d.to(dev) for d in draws)))
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with PlainKernels(*plain) if plain else contextlib.nullcontext():
        m_c = step_c(sc, real.to(ref_dev), None, cfg.lr_g, cfg.lr_d,
                     draws=StepDraws(*(d.to(ref_dev) for d in draws)))
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    out = {"gpu_s": gpu_s, "reference": ref, "reference_s": ref_s, "losses": {}, "grads": {},
           "params": {}}
    for name in m_g._fields:
        a, b = float(getattr(m_g, name)), float(getattr(m_c, name))
        out["losses"][name] = (a, b)
        tol = 1e-3 if name == "grad_penalty" else 1e-4
        check(np.isfinite(a) and abs(a - b) <= tol * abs(b) + 1e-12, f"{name}: GPU {a} {ref} {b}")
    check(out["losses"]["grad_penalty"][1] > 0, "R1 did not fire")
    for net, lr in (("gen", cfg.lr_g), ("disc", cfg.lr_d)):
        pg = dict(getattr(sg, net).named_parameters())
        pc = dict(getattr(sc, net).named_parameters())
        floor = 1e-6 * max(float(p.grad.abs().max()) for p in pc.values())
        errs = {k: float((pg[k].grad.cpu() - p.grad.cpu()).abs().max())
                / max(float(p.grad.abs().max()), floor) for k, p in pc.items()}
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        dp = max(float((pg[k].detach().cpu() - p.detach().cpu()).abs().max())
                 for k, p in pc.items())
        out["grads"][net] = {"tensors": len(errs), "worst": worst}
        out["params"][net] = {"max_abs": dp, "bound": 2 * lr + 1e-6}
        check(worst[0][1] <= 1e-3, f"{net} gradient GPU vs {ref}: {worst}")
        check(dp <= 2 * lr + 1e-6, f"{net} parameters GPU vs {ref}: {dp} > 2·lr")
    print(json.dumps({"gpu_vs_cpu_step" if ref == "CPU" else "kernels_vs_plain_step": out}))
    return out


class PlainKernels:
    """While active, the FIR and pair_conv3x3 Functions run their plain
    versions on the card in place of the kernels (the autograd structure,
    the routes and the calls by role stay)."""

    def __init__(self, fir2x, pair_conv):
        self.fir2x, self.pair_conv = fir2x, pair_conv

    def __enter__(self):
        fir2x, pair_conv = self.fir2x, self.pair_conv
        self._saved = (fir2x._resample, pair_conv._conv)

        def fir(name, x, k1d, order):
            fir2x.CALLS[name][fir2x.ROLES[min(order, 2)]] += 1
            return fir2x.down2x_ref(x, k1d) if name == "down2x" else fir2x.up2x_ref(x, k1d)

        fir2x._resample, pair_conv._conv = fir, pair_conv.pair_conv3x3_ref
        return self

    def __exit__(self, *exc):
        self.fir2x._resample, self.pair_conv._conv = self._saved


def rel_l2(a: list, b: list) -> float:
    """‖a − b‖ / ‖b‖ over lists of tensors taken as one vector."""
    num = sum(float((x.float() - y.float()).square().sum()) for x, y in zip(a, b))
    return math.sqrt(num / sum(float(y.float().square().sum()) for y in b))


def first_step(cfg, g_sd, d_sd, real, draws, dtype_name: str, fir2x, pair_conv, *,
               plain: bool = False, d_grads: list | None = None) -> dict:
    """One train step (step 0: R1 on) of `cfg` at its lrs on the card from
    the given weights and draws. Records D's and G's raw gradients (before
    the clip) as each optimizer steps. `plain`: the kernels' plain versions
    in their place. `d_grads`: D's update uses these gradients instead of
    its own (which are still recorded)."""
    st, stp = build_trainer(cfg, g_sd, d_sd, real.device, dtype_name)
    rec = {}

    def recording(opt, key, swap):
        inner = opt.step

        def step(lr):
            rec[key] = [p.grad.detach().clone() for p in opt.params]
            if swap is not None:
                for p, g in zip(opt.params, swap):
                    p.grad = g.clone()
            inner(lr)
        opt.step = step

    recording(st.opt_D, "gD", d_grads)
    recording(st.opt_G, "gG", None)
    fir2x.reset_launch_counts()
    pair_conv.reset_launch_counts()
    if plain:
        with PlainKernels(fir2x, pair_conv):
            m = stp(st, real, None, cfg.lr_g, cfg.lr_d, draws=draws)
    else:
        m = stp(st, real, None, cfg.lr_g, cfg.lr_d, draws=draws)
    torch.cuda.synchronize()
    rec["launches"] = sum(fir2x.LAUNCHES.values()) + pair_conv.LAUNCHES["pair_conv3x3"]
    rec.update({k: float(v) for k, v in m._asdict().items()})
    return rec


def first_step_attribution(cfg, g_sd, d_sd, real, fir2x, pair_conv) -> dict:
    """The recipe's step 0 at its lr, from its init, same draws in every run:
    bf16 with the kernels (b), bf16 with their plain versions on the card
    (po; p: the same with b's D gradient, so that p's G update sees b's
    updated D), f32 (f); then D's gradient swapped between the precisions
    (f32 with b's: fb; bf16 with f's: bf), and f32 with f's D gradient plus
    Gaussian noise of b − f's size, tensor by tensor (fn, printed). errG is
    taken after the step's D update, against the updated D.

    Bounds (each fails the phase):
    - the losses before the update: b against f within 5e-2 (the
      trajectory bound); b against p within 1e-3 relative (the penalty,
      a grad-of-grad through every FIR in bf16, 2e-2);
    - D's gradient: b against p no farther than b against f (relative L2);
    - errG b against p within 1e-2 relative, G's gradient b against p no
      farther than b against fb (f32 against the same updated D);
    - the gap |errG_b − errG_f| is larger than 1; swapping D's gradient
      carries errG across to within a quarter of the gap
      (|errG_fb − errG_b|, |errG_bf − errG_f|); and the plain versions'
      own bf16 step lands at least a quarter of the gap away from f32
      (|errG_po − errG_f|). So what separates the precisions is D's step-0
      gradient in bf16, through Adam's sign-like first step, with the
      kernels or without them; the kernels' rounding and the plain
      versions' land at different places too (printed)."""
    from ddgan_torch.train import draw_step

    # the draws of phase 23's step 0 (its generator, seed 15): its first D
    # update moves D's output on the G update's fakes to about -60, so errG
    # is ~60. Other draws can move it to about +30, where errG saturates at
    # ~1e-13 and the comparison is vacuous.
    draws = draw_step(real, cfg.num_timesteps, cfg.nz,
                      torch.Generator(device=real.device).manual_seed(15))
    args = (cfg, g_sd, d_sd, real, draws)
    b = first_step(*args, "bfloat16", fir2x, pair_conv)
    check(b["launches"] > 0, "the bf16 step launched no kernel")
    p = first_step(*args, "bfloat16", fir2x, pair_conv, plain=True, d_grads=b["gD"])
    po = first_step(*args, "bfloat16", fir2x, pair_conv, plain=True)
    check(p["launches"] == 0 and po["launches"] == 0, "a plain run launched a kernel")
    f = first_step(*args, "float32", fir2x, pair_conv)
    fb = first_step(*args, "float32", fir2x, pair_conv, d_grads=b["gD"])
    bf = first_step(*args, "bfloat16", fir2x, pair_conv, d_grads=f["gD"])
    gen = torch.Generator(device=real.device).manual_seed(26)
    noisy = [gf + torch.randn(gf.shape, generator=gen, device=gf.device)
             * float((gb - gf).square().mean().sqrt()) for gf, gb in zip(f["gD"], b["gD"])]
    fn = first_step(*args, "float32", fir2x, pair_conv, d_grads=noisy)
    flips = (sum(int((torch.sign(x) != torch.sign(y)).sum()) for x, y in zip(b["gD"], f["gD"]))
             / sum(x.numel() for x in f["gD"]))
    losses = ("errD_real", "errD_fake", "grad_penalty", "errG")
    out = {"runs": {k: {n: r[n] for n in losses} for k, r in
                    (("b", b), ("p", p), ("po", po), ("f", f), ("fb", fb), ("bf", bf),
                     ("fn", fn))},
           "d_grad_rel_l2": {"b_vs_p": rel_l2(b["gD"], p["gD"]), "b_vs_f": rel_l2(b["gD"], f["gD"])},
           "g_grad_rel_l2": {"b_vs_p": rel_l2(b["gG"], p["gG"]),
                             "b_vs_fb": rel_l2(b["gG"], fb["gG"])},
           "d_grad_sign_flips_b_vs_f": flips}
    gap = abs(b["errG"] - f["errG"])
    out["errG_gap_b_f"] = gap
    print(json.dumps({"first_step_attribution": out}))
    for n in losses[:3]:
        tol = 2e-2 if n == "grad_penalty" else 1e-3
        check(abs(b[n] - f[n]) <= 5e-2, f"{n}: bf16 {b[n]} f32 {f[n]}")
        check(abs(b[n] - p[n]) <= tol * abs(p[n]), f"{n}: kernels {b[n]} plain {p[n]}")
    check(out["d_grad_rel_l2"]["b_vs_p"] <= out["d_grad_rel_l2"]["b_vs_f"],
          f"D gradient, kernels vs plain: {out['d_grad_rel_l2']}")
    check(abs(b["errG"] - p["errG"]) <= 1e-2 * abs(p["errG"]),
          f"errG kernels {b['errG']} plain {p['errG']}")
    check(out["g_grad_rel_l2"]["b_vs_p"] <= out["g_grad_rel_l2"]["b_vs_fb"],
          f"G gradient, kernels vs plain: {out['g_grad_rel_l2']}")
    check(gap > 1.0, f"bf16 and f32 do not separate at the recipe's lr ({gap})")
    check(abs(fb["errG"] - b["errG"]) <= gap / 4 and abs(bf["errG"] - f["errG"]) <= gap / 4,
          f"swapping D's gradient does not carry errG across: {out['runs']}")
    check(abs(po["errG"] - f["errG"]) >= gap / 4,
          f"without the kernels bf16 does not separate from f32: {out['runs']}")
    return out


class LaunchRecorder:
    """Records every FIR and pair_conv3x3 launch (kernel.role, shape, dtype),
    in launch order, while active, by wrapping the wrappers' inner routes."""

    def __init__(self, fir2x, pair_conv):
        self.fir2x, self.pair_conv = fir2x, pair_conv
        self.launches: list = []

    def __enter__(self):
        fir_inner, pair_inner = self.fir2x._resample, self.pair_conv._apply
        self._saved = (fir_inner, pair_inner)
        roles = self.fir2x.ROLES

        def fir(name, x, k1d, order):
            return self._run(f"{name}.{roles[min(order, 2)]}", x, fir_inner, name, x, k1d, order)

        def pair(x, w, b, role, flip=False):
            return self._run(f"pair_conv3x3.{role}", x, pair_inner, x, w, b, role, flip)

        self.fir2x._resample, self.pair_conv._apply = fir, pair
        return self

    def _run(self, key, x, fn, *args):
        self.launches.append((key, tuple(x.shape), str(x.dtype)[6:]))
        return fn(*args)

    def __exit__(self, *exc):
        self.fir2x._resample, self.pair_conv._apply = self._saved

    def counts(self) -> dict:
        out: dict = {}
        for key in self.launches:
            out[key] = out.get(key, 0) + 1
        return out


def profile_steps(call, step_ms: float, fir2x, pair_conv, calls: int = 2) -> dict:
    """Device time by kernel class over `calls` train steps, K1 and K2 split
    by role, and the share of a step (`step_ms`, timed without the
    profiler) that the device spends in kernels. User annotations (the
    optimizer's range) are not kernels and are left out. The kernels run in
    order on one stream, so the n-th FIR (pair_conv3x3) kernel on the device
    is the n-th FIR (pair_conv3x3) launch that the recorder saw."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with LaunchRecorder(fir2x, pair_conv) as rec, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((ev for ev in prof.events() if str(ev.device_type).endswith("CUDA")
                      and not getattr(ev, "is_user_annotation", False)),
                     key=lambda ev: ev.time_range.start)
    by_class: dict[str, float] = {}
    by_role: dict[str, float] = {}
    for cls in ("fir2x", "pair_conv3x3"):
        evs = [ev for ev in kernels if _kernel_class(ev.name) == cls]
        keys = [k for k, _, _ in rec.launches if k.startswith("pair") == (cls == "pair_conv3x3")]
        check(len(evs) == len(keys), f"profile: {len(evs)} {cls} kernels, {len(keys)} launches")
        for ev, key in zip(evs, keys):
            by_role[key] = by_role.get(key, 0.0) + ev.time_range.elapsed_us() / calls / 1e3
    for ev in kernels:
        cls = _kernel_class(ev.name)
        by_class[cls] = by_class.get(cls, 0.0) + ev.time_range.elapsed_us() / calls / 1e3
    busy = sum(by_class.values())
    out = {"calls": calls, "step_ms": step_ms, "profiled_wall_ms_per_step": wall_ms / calls,
           "device_busy_ms_per_step": busy, "device_busy_share": busy / step_ms,
           "kernel_launches_per_step": len(kernels) // calls,
           "ms_per_step_by_class": dict(sorted(by_class.items())),
           "ms_per_step_by_role": dict(sorted(by_role.items()))}
    print(json.dumps({"train_profile": out}))
    return out


def time_launches(fir2x, pair_conv, counts_by_step: dict) -> dict:
    """Each role's device time per step: every distinct (kernel, shape,
    dtype) launch of the recorded steps timed alone (CUDA events, L2 cold),
    beside its plain version, the library call and its bound, summed over
    the step's launches."""
    timed: dict = {}
    for counts in counts_by_step.values():
        for (key, shape, dt) in counts:
            if (key, shape, dt) in timed:
                continue
            kernel, role = key.split(".")
            dtype = getattr(torch, dt)
            n_in = math.prod(shape)
            if kernel in ("down2x", "up2x"):
                fn, ref = (fir2x.down2x, fir2x.down2x_ref) if kernel == "down2x" else (
                    fir2x.up2x, fir2x.up2x_ref)
                k = taps(kernel, FIR)
                bufs = rotation(shape, dtype, n_in // 4 if kernel == "down2x" else 4 * n_in, seed=7)
                lib = library_call(kernel, k)
                iters = max(30, len(bufs))
                with torch.no_grad():
                    row = {"ms": device_ms(lambda x: fn(x, k), bufs, iters),
                           "plain_ms": device_ms(lambda x: ref(x, k), bufs, iters),
                           "library_ms": device_ms(lib, bufs, iters)}
                row["bound_ms"], row["bound_by"] = fir_bound_ms(kernel, shape, dtype)
            else:
                n, c, h, w = shape
                bufs = rotation(shape, torch.bfloat16, n * 64 * h * w, seed=8)
                g0 = torch.Generator(device="cuda").manual_seed(9)
                wt = torch.randn((64, c, 3, 3), generator=g0, device="cuda") / math.sqrt(9 * c)
                w16 = wt.to(torch.bfloat16)
                iters = max(20, len(bufs))
                if role == "dx":
                    # as the step launches it: the forward weight (64, 64) with
                    # the in-kernel flip and no bias; the library's input
                    # gradient of the forward conv
                    b, flip = None, True
                    lib = lambda y: torch.nn.grad.conv2d_input((n, c, h, w), w16, y, padding=1)
                else:
                    b, flip = torch.zeros((64,), device="cuda"), False
                    lib = lambda y: F.conv2d(y, w16, padding=1)
                with torch.no_grad():
                    row = {"ms": device_ms(lambda y: pair_conv._conv(y, wt, b, flip), bufs, iters),
                           "plain_ms": device_ms(lambda y: pair_conv.pair_conv3x3_ref(y, wt, b, flip),
                                                 bufs, iters),
                           "library_ms": device_ms(lib, bufs, iters)}
                row["bound_ms"], row["bound_by"] = pair_bound_ms(shape)
            timed[(key, shape, dt)] = {**row, "shape": list(shape), "dtype": dt}
            print(f"  {key} {shape} {dt}: kernel {row['ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} ({row['bound_by']}), "
                  f"{row['bound_ms'] / row['ms']:.1%} of its bound")
            del bufs
    for key in sorted({k for k, _, _ in timed}):
        if key.split(".")[0] in ("down2x", "up2x"):
            share_summary(key, [r for (k, _, _), r in timed.items() if k == key])
    roles: dict = {}
    for step_name, counts in counts_by_step.items():
        for (key, shape, dt), n in counts.items():
            r = roles.setdefault(key, {}).setdefault(step_name, {
                "launches": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                "bound_by": set()})
            r["launches"] += n
            for f in ("ms", "plain_ms", "library_ms", "bound_ms"):
                r[f] += n * timed[(key, shape, dt)][f]
            r["bound_by"].add(timed[(key, shape, dt)]["bound_by"])
    for per_step in roles.values():
        for r in per_step.values():
            r["bound_by"] = "bytes" if r["bound_by"] == {"bytes"} else "operations"
    return roles


def time_steps(state, step, real, rng, n: int = TIMED_STEPS) -> dict:
    """ms per step (CUDA events around each step, the first of each kind
    excluded as warm-up), for R1 steps and the others apart: the step
    counter is set before each call so that R1 fires or not. Also the peak
    device memory of an R1 step."""
    lr = 1e-4
    out = {}
    for label in ("r1_step", "plain_step"):
        times = []
        for i in range(n + 1):
            state.step = 0 if label == "r1_step" else 1
            if label == "r1_step" and i == 1:
                torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, real, rng, lr, lr)
            end.record()
            torch.cuda.synchronize()
            if label == "r1_step" and i == 1:
                out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            if i >= 1:
                times.append(start.elapsed_time(end))
        out[label] = float(np.mean(times))
    return out


# ---------------------------------------------------------------------------
# the train loop through the CLIs
LOOP_EPOCHS = 1  # phase 27's num_epoch: epochs 0..1 of 8 steps, R1 at steps 0 and 15
SOAK_TRAIN = 512  # phase 27's CIFAR-10 pickles: 8 steps an epoch at batch 64
SOAK_REAL = 256  # its real PNGs (the FID statistics)
SOAK_FID = 256  # samples of its one EMA FID point
LOOP_ITERS_256 = 4  # CelebA-HQ 256 steps an epoch (batch 4): 3 epochs, R1 at steps 0 and 10
LOOP_EPOCHS_256 = 2
EPOCH_LINE = re.compile(r"\[epoch (\d+)\] (\d+) iters in ([0-9.]+)s \(.*\), saves ([0-9.]+)s")


class Tee:
    """While active, what is printed goes to stdout and into a buffer (the
    loop's and the CLIs' own lines, read by the checks)."""

    def __enter__(self):
        self._out, self.parts = sys.stdout, []
        sys.stdout = self
        return self

    def write(self, s: str) -> int:
        self.parts.append(s)
        return self._out.write(s)

    def flush(self) -> None:
        self._out.flush()

    def __exit__(self, *exc):
        sys.stdout = self._out

    def text(self) -> str:
        return "".join(self.parts)


class CheckpointIO:
    """While active, times each checkpoint write and read that the loop makes
    (`ddgan_torch.train.checkpoint`'s functions wrapped), with the file's
    bytes. A write's time includes the copy of the state to the host."""

    def __init__(self, ckpt):
        self.ckpt, self.rows = ckpt, []

    def __enter__(self):
        c = self.ckpt
        self._saved = (c.save_content, c.save_netg, c.load_content)

        def timed(op, fn, path_of):
            def call(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                path = path_of(*args)
                self.rows.append({"op": op, "file": path.name, "s": time.perf_counter() - t0,
                                  "bytes": path.stat().st_size})
                return out
            return call

        c.save_content = timed("write", c.save_content, lambda exp, *_: Path(exp) / "content.pth")
        c.save_netg = timed("write", c.save_netg,
                            lambda exp, epoch, *_: Path(exp) / f"netG_{epoch}.pth")
        c.load_content = timed("read", c.load_content, lambda exp, *_: Path(exp) / "content.pth")
        return self

    def __exit__(self, *exc):
        self.ckpt.save_content, self.ckpt.save_netg, self.ckpt.load_content = self._saved

    def summary(self) -> dict:
        out = {}
        for r in self.rows:
            key = f"{r['op']} {'netG_*.pth' if r['file'].startswith('netG_') else r['file']}"
            row = out.setdefault(key, {"count": 0, "bytes": r["bytes"], "s": []})
            row["count"] += 1
            row["s"].append(r["s"])
        for row in out.values():
            row["mean_s"] = float(np.mean(row["s"]))
            row["gb_per_s"] = row["bytes"] / row["mean_s"] / 1e9
        return out


def epoch_times(log: str) -> list:
    """The loop's per-epoch lines: epoch, iterations, seconds of the steps
    (up to the epoch's loss fetch, which waits for the device) and of the
    saves after them."""
    return [{"epoch": int(m[1]), "iters": int(m[2]), "s": float(m[3]), "saves_s": float(m[4])}
            for m in EPOCH_LINE.finditer(log)]


def loop_vs_bare(epochs: list, limited: int, lazy_reg: int, bares: dict, batch: int) -> list:
    """Loop ms per step without the saves, per epoch after the first of a
    process (its first steps warm up), beside each bare step time of
    `bares` (label -> `time_steps` result) for the same mix of R1 steps and
    others."""
    rows = []
    for e in epochs[1:]:
        first = e["epoch"] * limited
        n_r1 = sum(1 for s in range(first, first + e["iters"]) if s % lazy_reg == 0)
        ms = 1e3 * e["s"] / e["iters"]
        row = {"epoch": e["epoch"], "r1_steps": n_r1, "loop_ms_per_step": ms,
               "samples_per_s": batch / ms * 1e3, "saves_s": e["saves_s"]}
        for label, bare in bares.items():
            bare_ms = (n_r1 * bare["r1_step"] + (e["iters"] - n_r1) * bare["plain_step"]) \
                / e["iters"]
            row[f"{label}_ms_per_step"], row[f"loop_over_{label}"] = bare_ms, ms / bare_ms
        rows.append(row)
    return rows


def bare_step_ms(cfg, state) -> dict:
    """`time_steps` of the loop's own final state in this process, right
    after its run: the bare step beside the loop with the host as it is
    now (the host-bound step's time drifts between phases)."""
    from ddgan_torch.diffusion import DiffusionCoefficients, PosteriorCoefficients
    from ddgan_torch.train import make_train_step

    dev = next(state.gen.parameters()).device
    step = make_train_step(
        DiffusionCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max, device=dev),
        PosteriorCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max, device=dev),
        num_timesteps=cfg.num_timesteps, nz=cfg.nz, r1_gamma=cfg.r1_gamma, lazy_reg=cfg.lazy_reg,
        ema_decay=cfg.ema_decay, use_ema=True)
    return time_steps(state, step, real_batch(cfg, cfg.batch_size, 30).to(dev),
                      torch.Generator(device=dev).manual_seed(31))


def expected_run_calls(steps, lazy_reg: int, n_d: int, n_g: int, shared: bool,
                       **g_fir) -> dict:
    """`expected_fir_calls` summed over the global steps `steps`."""
    total: dict = {}
    for s in steps:
        for name, roles in expected_fir_calls(n_d, n_g, s % lazy_reg == 0, shared,
                                              **g_fir).items():
            for role, n in roles.items():
                total.setdefault(name, {}).setdefault(role, 0)
                total[name][role] += n
    return total


def check_netg_files(exp: Path, cfg, epochs) -> int:
    """Every netG_{e}.pth loads into NCSNpp with strict=True; returns the count."""
    from ddgan_torch.compat import load_netg_pth
    from ddgan_torch.models import NCSNpp

    net = NCSNpp.from_config(cfg)
    for e in epochs:
        net.load_state_dict(load_netg_pth(str(exp / f"netG_{e}.pth")), strict=True)
    return len(epochs)


def check_cli_pngs(tmp: Path, dataset: str, n: int, side: int) -> int:
    pngs = sorted((tmp / "generated_samples" / dataset).glob("sample_*.png"))
    check(len(pngs) == n, f"sampler CLI wrote {len(pngs)} PNGs, expected {n}")
    head = pngs[0].read_bytes()[:24]
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[16:24] == side.to_bytes(4, "big") * 2,
          f"sampler CLI PNG is not {side}x{side}")
    return len(pngs)



def _reset(fir2x, pair_conv) -> None:
    fir2x.reset_launch_counts()
    pair_conv.reset_launch_counts()


def _calls(fir2x, pair_conv) -> dict:
    return {"fir": {k: dict(v) for k, v in fir2x.CALLS.items()},
            "pair_conv3x3": dict(pair_conv.CALLS)}


def check_loop_run(cfg, exp: Path, steps, fir2x, pair_conv, k2_per_step: dict | None,
                   g_fir: dict | None = None) -> dict:
    """After a loop run over the global `steps`: the kernels' calls and
    launches by role against the per-step counts of phases 23-25 (`g_fir`:
    the generator family's FIR roles, FAMILY_FIR), every netG_{e}.pth
    against NCSNpp (strict), losses.json's epochs, and content.pth's
    counters. Returns the calls."""
    torch.cuda.synchronize()
    calls = _calls(fir2x, pair_conv)
    n_d = 3 if str(cfg.disc_small).lower() == "yes" else 6
    want = expected_run_calls(steps, cfg.lazy_reg, n_d, len(cfg.ch_mult) - 1,
                              shared=cfg.image_size >= 256, **(g_fir or {}))
    check(calls["fir"] == want and fir2x.LAUNCHES == {k: sum(v.values()) for k, v in want.items()},
          f"loop: FIR calls {calls['fir']}, launches {fir2x.LAUNCHES}, expected {want}")
    k2 = {r: n * len(steps) for r, n in (k2_per_step or dict.fromkeys(pair_conv.CALLS, 0)).items()}
    check(calls["pair_conv3x3"] == k2
          and pair_conv.LAUNCHES["pair_conv3x3"] == k2["forward"] + k2["dx"],
          f"loop: pair_conv3x3 {calls['pair_conv3x3']} {pair_conv.LAUNCHES}, expected {k2}")
    n_epochs = cfg.num_epoch + 1
    losses = json.loads((exp / "losses.json").read_text())
    check([e["epoch"] for e in losses] == list(range(1, n_epochs + 1))
          and all(np.isfinite([e["G_loss"], e["D_loss"]]).all() for e in losses),
          f"losses.json: {losses}")
    raw = torch.load(exp / "content.pth", map_location="cpu", mmap=True, weights_only=False)
    check(raw["global_step"] == n_epochs * cfg.limited_iter and raw["epoch"] == n_epochs,
          f"content.pth: step {raw['global_step']}, epoch {raw['epoch']}")
    del raw
    check_netg_files(exp, cfg, range(n_epochs))
    return calls


def sample_from_loop(cfg, tmp: Path, fir2x, pair_conv, want_launches: dict) -> int:
    """The sampler CLI on the run's last netG_*.pth: its PNGs and launches."""
    from ddgan_torch.cli import test_cli

    _reset(fir2x, pair_conv)
    test_cli.main(["--dataset", cfg.dataset, "--exp", cfg.exp, "--epoch_id", str(cfg.num_epoch),
                   "--seed", "0"])
    torch.cuda.synchronize()
    got = {**fir2x.LAUNCHES, **pair_conv.LAUNCHES}
    check(got == want_launches, f"sampler CLI: launches {got}, expected {want_launches}")
    return check_cli_pngs(tmp, cfg.dataset, cfg.batch_size, cfg.image_size)


def _config_dir(tmp: Path, cfg) -> None:
    (tmp / "configs").mkdir()
    # synthetic_size is not a schema key: the config file carries it
    (tmp / "configs" / "config.json").write_text(json.dumps(
        {**cfg.to_dict(), "synthetic_size": cfg.limited_iter * cfg.batch_size}))


def soak_tool():
    """`tools/quality_soak_torch.py`, imported from this checkout."""
    sys.path.insert(0, str(ROOT / "tools"))
    import quality_soak_torch

    return quality_soak_torch


def flagship_soak(bare: dict, fir2x, pair_conv, sample_launches: dict, keep: Path) -> tuple:
    """Phase 27: the flagship recipe through the quality soak tool's own
    functions at full width on SOAK_TRAIN images (8 steps an epoch): its
    data and real statistics; `python -m ddgan_torch.cli.train_cli` with
    the recipe's flags in a subprocess, SIGKILLed one second after the
    content.pth save of its first epoch; then the same command with
    --resume in this process (launches counted), the checks of
    `check_loop_run` and of the kept loss history, and the sampler CLI on
    the last netG_*.pth; then the tool's raw and EMA snapshot, one EMA FID
    point of SOAK_FID samples through `test_cli --compute_fid` (launches
    counted: one sampler call) and its record. `keep` receives the run's
    content.pth, content_args.json and losses.json. Returns the phase's
    numbers, the run's config and the FID point's launches."""
    from ddgan_torch.cli import train_cli
    from ddgan_torch.train import checkpoint as ckpt

    qs = soak_tool()
    with tempfile.TemporaryDirectory() as tmp, random_inception_env():
        tmp = Path(tmp)
        args = qs.parse_args([
            "--recipe", "flagship", "--root", str(tmp), "--out", str(tmp / "record.json"),
            "--n-train", str(SOAK_TRAIN), "--n-real", str(SOAK_REAL), "--segments",
            str(LOOP_EPOCHS), "--schedule-epochs", "0", "--kill-after", str(LOOP_EPOCHS),
            "--kill-delay", "1", "--ckpt-every", "1", "--content-every", "1", "--fid-samples",
            str(SOAK_FID), "--fid-batch", str(SOAK_FID), "--train-timeout", "300"])
        soak = qs.Soak(args)
        soak.prepare(floor=False)
        limited = SOAK_TRAIN // args.batch_size  # the epoch's steps: the whole set
        cfg = train_cli.resolve_config(train_cli.build_parser().parse_args(
            qs.train_argv(args, LOOP_EPOCHS, False))).replace(limited_iter=limited)
        exp, n_steps = soak.exp_path, (LOOP_EPOCHS + 1) * limited
        check(soak.run_segment(LOOP_EPOCHS, resume=False, kill_after=LOOP_EPOCHS) == "killed",
              f"the train CLI was not killed:\n{soak.log.read_text()[-4000:]}")
        kill = soak.events[-1]
        killed_log = soak.log.read_text()
        pre = json.loads((exp / "losses.json").read_text())
        with qs.working_directory(soak.root):
            _reset(fir2x, pair_conv)
            t0 = time.perf_counter()
            with Tee() as tee, CheckpointIO(ckpt) as io_:
                state = train_cli.main(qs.train_argv(args, LOOP_EPOCHS, True))
            soak.append_log(tee.text(), "train_cli --resume, in process")
            soak.segment_done(LOOP_EPOCHS, True, tee.text(), time.perf_counter() - t0)
            start = soak.events[-1]["resumed_from_epoch"]
            check(start is not None and kill["at_logged_epoch"] - 1 <= start
                  <= kill["at_logged_epoch"], f"kill {kill}, then resumed from epoch {start}")
            calls = check_loop_run(cfg, exp, range(start * limited, n_steps), fir2x, pair_conv,
                                   None)
            check(state.step == n_steps, f"resumed run ended at step {state.step}")
            post = json.loads((exp / "losses.json").read_text())
            kept = [e for e in pre if e["epoch"] <= start]
            check(len(kept) == start and post[:start] == kept,
                  f"losses.json lost its history: before the kill {pre}, after {post}")
            bares = {**({"bare": bare} if bare else {}), "bare_after": bare_step_ms(cfg, state)}
            del state
            n_png = sample_from_loop(cfg, soak.root, fir2x, pair_conv, sample_launches)
            keep.mkdir(parents=True, exist_ok=True)
            for name in ("content.pth", "content_args.json", "losses.json"):
                shutil.copy(exp / name, keep / name)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        snap = qs.snapshot_netg(exp)
        soak.snapshots.append(snap)
        snap_s = time.perf_counter() - t0
        raw, ema = (torch.load(exp / f"netG_{n + snap}.pth", weights_only=True)
                    for n in (90000, 80000))
        check(snap == LOOP_EPOCHS and qs.same_weights(exp / f"netG_{80000 + snap}.pth",
                                                      exp / f"netG_{snap}.pth")
              and any(not torch.equal(raw[k], ema[k]) for k in raw),
              f"snapshot at {snap}: the EMA is not netG_{snap}, or the raw G is the EMA")
        _reset(fir2x, pair_conv)
        fid = soak.score(LOOP_EPOCHS)
        torch.cuda.synchronize()
        fid_launches = {**fir2x.LAUNCHES, **pair_conv.LAUNCHES}
        n_calls = -(-SOAK_FID // args.fid_batch)
        want = {k: v * n_calls for k, v in sample_launches.items()}
        check(fid_launches == want, f"soak FID point: launches {fid_launches}, expected {want}")
        rec = soak.write_record(False)
        check(np.isfinite(fid) and fid > 0 and rec["resume_continuity_ok"]
              and rec["ema_fid_curve"] == [{"epoch": LOOP_EPOCHS, "fid_ema": fid,
                                            "s": soak.point_s[LOOP_EPOCHS]}]
              and [e["event"] for e in rec["events"]] == ["hard_kill", "segment_done"]
              and rec["jax_reference"]["file"] == "QUALITY_r03.json"
              and "DDGAN_TPU_INCEPTION_RANDOM=0" in rec["feature_space"],
              f"soak record: {json.dumps(rec)[:3000]}")
    out = {"killed_after_s": kill["wall_s"], "losses_before_kill": len(pre),
           "resumed_from_epoch": start, "steps": n_steps, "pngs": n_png, "launches": calls,
           "checkpoint_io": io_.summary(),
           # a fresh process, as a user's run
           "subprocess_epochs": loop_vs_bare(epoch_times(killed_log), limited, cfg.lazy_reg,
                                             {"bare": bare} if bare else {}, cfg.batch_size),
           "bare_after": bares["bare_after"],
           "resumed_epochs": loop_vs_bare(epoch_times(tee.text()), limited, cfg.lazy_reg, bares,
                                          cfg.batch_size),
           "soak": {"snapshot_s": snap_s, "fid_ema": fid, "fid_s": soak.point_s[LOOP_EPOCHS],
                    "fid_samples": SOAK_FID, "launches": fid_launches,
                    "record": {k: rec[k] for k in ("events", "resume_continuity_ok",
                                                   "ema_fid_curve", "epoch_seconds",
                                                   "device")}}}
    print(json.dumps({"train_loop_flagship_soak": out}))
    print(f"soak tool: killed {kill}, resumed from epoch {start}; snapshot at {snap} in "
          f"{snap_s:.2f} s; EMA FID of netG_{LOOP_EPOCHS} at {SOAK_FID} samples {fid} in "
          f"{soak.point_s[LOOP_EPOCHS]:.1f} s; launches {fid_launches}")
    return out, cfg, fid_launches


def loop_through_main_cli(cfg, bare: dict | None, fir2x, pair_conv, k2_per_step: dict | None,
                          sample_launches: dict, extra_argv: tuple = (), g_fir: dict | None = None,
                          after=None) -> dict:
    """`cfg` through `ddgan_torch.cli.main_cli` in this process (launches
    counted; `extra_argv` the flags a user adds, as --data_dir; `g_fir` the
    generator's FIR roles, as `check_loop_run` takes them), the checks of
    `check_loop_run`, and the sampler CLI on the last netG_*.pth; then
    `after(argv, exp)` in the run's directory, whose result is the output's
    "after"."""
    from ddgan_torch.cli import main_cli
    from ddgan_torch.train import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        exp = tmp / "saved_info" / "dd_gan" / cfg.dataset / cfg.exp
        _config_dir(tmp, cfg)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            _reset(fir2x, pair_conv)
            # main_cli writes its own defaults over the config: name each that matters
            argv = ["--dataset", cfg.dataset, "--exp", cfg.exp, "--batch_size",
                    str(cfg.batch_size), "--num_epoch", str(cfg.num_epoch), "--save_content",
                    *extra_argv]
            with Tee() as tee, CheckpointIO(ckpt) as io_:
                state = main_cli.main(argv)
            n_steps = (cfg.num_epoch + 1) * cfg.limited_iter
            calls = check_loop_run(cfg, exp, range(n_steps), fir2x, pair_conv, k2_per_step,
                                   g_fir)
            check(state.step == n_steps, f"main_cli run ended at step {state.step}")
            bares = {**({"bare": bare} if bare else {}), "bare_after": bare_step_ms(cfg, state)}
            n_png = sample_from_loop(cfg, tmp, fir2x, pair_conv, sample_launches)
            after_out = after(argv, exp) if after is not None else None
        finally:
            os.chdir(cwd)
    out = {"steps": n_steps, "pngs": n_png, "launches": calls, "checkpoint_io": io_.summary(),
           "bare_after": bares["bare_after"], **({"after": after_out} if after else {}),
           "epochs": loop_vs_bare(epoch_times(tee.text()), cfg.limited_iter, cfg.lazy_reg, bares,
                                  cfg.batch_size)}
    print(json.dumps({f"train_loop_{cfg.exp}": out}))
    return out


def print_loops(loops: dict) -> None:
    for model, lp in loops.items():
        for key, row in lp["checkpoint_io"].items():
            print(f"{model} {key}: {row['bytes']} bytes, {row['mean_s']:.3f} s mean over "
                  f"{row['count']} ({row['gb_per_s']:.2f} GB/s)")
        for where in ("subprocess_epochs", "resumed_epochs", "epochs"):
            for e in lp.get(where, []):
                after = (f" and {e['bare_after_ms_per_step']:.3f} ms right after the run "
                         f"({e['loop_over_bare_after']:.3f}x)" if "bare_after_ms_per_step" in e
                         else "")
                print(f"{model} loop ({where.split('_')[0]}) epoch {e['epoch']}: "
                      f"{e['loop_ms_per_step']:.3f} ms per step ({e['samples_per_s']:.2f} "
                      f"samples/s) beside the bare step's {e['bare_ms_per_step']:.3f} ms in phase "
                      f"25 ({e['loop_over_bare']:.3f}x){after}; saves {e['saves_s']:.3f} s")


# ---------------------------------------------------------------------------
# evaluation: FID-InceptionV3, the sampler CLI's --compute_fid, the IS CLI
FID_SAMPLES = 2112  # above 2048, so both 2048-dim covariances are full rank
IS_SAMPLES = 256
DECODE_256_IMAGES = 100  # filtered 256² PNGs timed through the FID loader
INCEPTION_BATCH = 50  # the FID path's batch (test_cli passes 50)


def inception_macs(inc) -> int:
    """Multiply-adds of one 299² image through the FID Inception and its
    classifier head, counted from the layer shapes (a forward on the meta
    device: every conv's output elements x its input channels x kernel
    taps, and the fc's)."""
    model = inc.InceptionV3FID(num_classes=inc.NUM_CLASSES, resize_input=False).to("meta")
    total = [0]

    def hook(mod, _, out):
        if isinstance(mod, torch.nn.Conv2d):
            total[0] += out.numel() * mod.in_channels * math.prod(mod.kernel_size) // mod.groups
        elif isinstance(mod, torch.nn.Linear):
            total[0] += out.numel() * mod.in_features

    for mod in model.modules():
        mod.register_forward_hook(hook)
    model.logits(torch.zeros((1, 3, 299, 299), device="meta"))
    return total[0]


def check_inception(inc, dev) -> dict:
    """The full network with `random_fid_inception_logits_params(0)` on the
    GPU (f32, TF32 off) against the port's CPU path, all four blocks and the
    logits, on 16 seeded images at 32² (grown to 299) and 512² (shrunk);
    then one batch of 50 at 299² timed against the bound of its operations."""
    model = inc.InceptionV3FID(output_blocks=(0, 1, 2, 3), num_classes=inc.NUM_CLASSES)
    model.load_state_dict(inc.random_fid_inception_logits_params(0), strict=True)
    model_gpu = copy.deepcopy(model).to(dev)
    errs = {}
    for side in (32, 512):
        x = torch.from_numpy(np.random.RandomState(side).rand(16, 3, side, side).astype(np.float32))
        with torch.no_grad():
            want = model(x)
            want.append(model.fc(want[3][:, :, 0, 0]))
            with inc.float32_exact():
                got = model_gpu(x.to(dev))
                got.append(model_gpu.fc(got[3][:, :, 0, 0]))
        errs[side] = [((g.cpu() - w).abs().max() / w.abs().max()).item()
                      for g, w in zip(got, want)]
        print(f"Inception at {side}² (batch 16), GPU vs CPU, max-abs over max|ref| of blocks "
              f"0-3 and the logits: {[f'{e:.3g}' for e in errs[side]]}")
        check(all(e <= 1e-4 for e in errs[side]), f"Inception at {side}²: {errs[side]}")
        check(all(bool(torch.isfinite(g).all()) for g in got), "Inception output not finite")
    feats = inc.InceptionV3FID().to(dev)
    feats.load_state_dict({k: v for k, v in model.state_dict().items()
                           if k in feats.state_dict()}, strict=True)
    g = torch.Generator(device=dev).manual_seed(29)
    bufs = [torch.rand((INCEPTION_BATCH, 3, 299, 299), generator=g, device=dev) for _ in range(2)]
    with torch.no_grad(), inc.float32_exact():
        ms = device_ms(feats.pool_features, bufs, iters=10)
    macs = inception_macs(inc)
    bound = 2 * macs * INCEPTION_BATCH / FP32_FLOPS * 1e3
    out = {"max_rel_err": {str(k): v for k, v in errs.items()}, "batch": INCEPTION_BATCH,
           "ms": ms, "images_per_s": INCEPTION_BATCH / ms * 1e3, "macs_per_image": macs,
           "bound_ms": bound, "bound_by": "operations", "share_of_bound": bound / ms,
           "tflops": 2 * macs * INCEPTION_BATCH / ms / 1e9}
    print(f"Inception pool3, batch {INCEPTION_BATCH} at 299², f32 (TF32 off): {ms:.3f} ms = "
          f"{out['images_per_s']:.1f} images/s, {out['tflops']:.2f} TFLOP/s; {macs} "
          f"multiply-adds an image; bound {bound:.3f} ms (operations at 67 TFLOP/s f32), "
          f"{out['share_of_bound']:.1%} of it")
    return out


class Stopwatch:
    """While active, sums the seconds (and counts the calls) of the module
    functions it wraps, from any thread; `wrap_result` also wraps the
    function that a call returns (a feature function a factory builds)."""

    def __init__(self):
        self.s, self.n, self._lock, self._saved = {}, {}, threading.Lock(), []

    def _timed(self, label: str, fn, sync: bool = False):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if sync:
                    torch.cuda.synchronize()
                with self._lock:
                    self.s[label] = self.s.get(label, 0.0) + time.perf_counter() - t0
                    self.n[label] = self.n.get(label, 0) + 1
        return timed

    def wrap(self, mod, name: str, label: str, wrap_result: str | None = None) -> None:
        fn = getattr(mod, name)
        self._saved.append((mod, name, fn))
        if wrap_result:
            inner = fn

            def fn(*a, **kw):
                return self._timed(wrap_result, inner(*a, **kw), sync=True)
        setattr(mod, name, self._timed(label, fn))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)


class SamplerSpans:
    """While active, the sampler the CLI builds records CUDA events around
    each call (no sync): the device span of every call, summed after."""

    def __init__(self, test_cli):
        self.cli, self.events = test_cli, []

    def __enter__(self):
        self.make = make = self.cli.make_sampler
        events = self.events

        def make_sampler(*a, **kw):
            sample = make(*a, **kw)

            def spanned():
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                out = sample()
                end.record()
                events.append((start, end))
                return out
            return spanned

        self.cli.make_sampler = make_sampler
        return self

    def __exit__(self, *exc):
        self.cli.make_sampler = self.make

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


@contextlib.contextmanager
def random_inception_env():
    """DDGAN_TPU_INCEPTION_RANDOM=0 and no weights path while the block runs."""
    saved = {k: os.environ.pop(k, None)
             for k in ("DDGAN_TPU_INCEPTION_RANDOM", "DDGAN_TPU_INCEPTION_PATH")}
    os.environ["DDGAN_TPU_INCEPTION_RANDOM"] = "0"
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def smooth_image(rs, side: int) -> np.ndarray:
    """(side, side, 3) uint8 with an image's local correlation (a cumulative
    sum of small steps), so the adaptive filter picks Sub and Paeth rows as
    it does on photographs, where noise would give it no preference."""
    x = np.cumsum(np.cumsum(rs.randint(-3, 4, (side, side, 3)), 0), 1)
    return ((x + rs.randint(0, 256, (1, 1, 3))) % 256).astype(np.uint8)


def encode_png_adaptive(arr: np.ndarray) -> tuple[bytes, np.ndarray]:
    """An 8-bit RGB PNG of (H, W, 3) uint8 pixels whose every row takes the
    filter (0-4) with the least sum of absolute residuals as signed bytes,
    the heuristic of libpng and PIL's adaptive filtering; and the row
    filters chosen. The files PIL writes reach a decoder this way; the
    port's own PNGs are unfiltered."""
    h, w, _ = arr.shape
    cur = arr.reshape(h, w * 3).astype(np.int16)
    up = np.concatenate([np.zeros((1, w * 3), np.int16), cur[:-1]])
    left = np.concatenate([np.zeros((h, 3), np.int16), cur[:, :-3]], axis=1)
    upleft = np.concatenate([np.zeros((h, 3), np.int16), up[:, :-3]], axis=1)
    pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(cur), left, up, (left + up) >> 1, paeth])
    residual = ((cur - preds) % 256).astype(np.uint8)  # (5, H, W * 3)
    filters = np.abs(residual.view(np.int8).astype(np.int32)).sum(axis=2).argmin(axis=0)
    rows = residual[filters, np.arange(h)]
    raw = np.concatenate([filters[:, None].astype(np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (len(body).to_bytes(4, "big") + tag + body
                + (zlib.crc32(tag + body) & 0xFFFFFFFF).to_bytes(4, "big"))

    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 2, 0, 0, 0])
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    return png, filters


# phase 30's real set: every 16th file in one of these layouts, in turn
# (written by the tests' writers and PIL), the rest adaptively filtered PNGs
REAL_SET_LAYOUTS = ["bmp 24-bit", "bmp 8-bit palette", "ppm", "pgm", "tiff LZW", "tiff Deflate",
                    "tiff PackBits", "jpeg progressive", "jpeg arithmetic", "png 16-bit",
                    "png Adam7", "png 4-bit palette", "tiff CCITT T.6", "tiff CCITT T.4 2-D",
                    "tiff JPEG YCbCr 4:2:0", "tiff LZMA float predictor 3",
                    "tiff signed 16-bit", "tiff BigTIFF LZW", "jpeg 4:4:0", "jpeg 4:1:1"]
REAL_SET_EVERY = 16


def quantized(px: np.ndarray, bits: tuple) -> tuple[np.ndarray, np.ndarray]:
    """Palette indices of (H, W, 3) pixels at (r, g, b) bits each, and the
    palette (its levels spread over 0-255)."""
    idx = np.zeros(px.shape[:2], np.int64)
    for c, b in enumerate(bits):
        idx = (idx << b) | (px[:, :, c].astype(np.int64) >> (8 - b))
    levels = [np.arange(1 << b) * 255 // ((1 << b) - 1) for b in bits]
    grid = np.stack(np.meshgrid(*levels, indexing="ij"), -1).reshape(-1, 3)
    return idx, grid.astype(np.uint8)


def real_set_file(layout: str, px: np.ndarray, Image, writers, arith) -> tuple:
    """(extension, bytes, pixels) of one 32² image in a layout of
    REAL_SET_LAYOUTS; pixels are what the file holds (None for lossy JPEG)."""
    if layout == "bmp 24-bit":
        return "bmp", writers.bmp(px, 24), px
    if layout == "bmp 8-bit palette":
        idx, pal = quantized(px, (3, 3, 2))
        return "bmp", writers.bmp(idx, 8, palette=pal), pal[idx]
    if layout == "ppm":
        return "ppm", writers.netpbm(px, "P6"), px
    if layout == "pgm":
        return "pgm", writers.netpbm(px[:, :, 1], "P5"), np.repeat(px[:, :, 1:2], 3, axis=2)
    grey = px[:, :, 1]
    if layout.startswith("tiff CCITT"):
        white = grey > 127
        im = Image.fromarray(white.astype(np.uint8) * 255).convert("1")
        data = writers.pil_tiff(Image, im, compression="group4" if layout.endswith("T.6")
                                else "group3", tiffinfo={} if layout.endswith("T.6") else {292: 1})
        return "tif", data, np.repeat(white[:, :, None] * np.uint8(255), 3, axis=2)
    if layout == "tiff JPEG YCbCr 4:2:0":
        return "tif", writers.jpeg_tiff(px, 6, [(2, 2), (1, 1), (1, 1)],
                                        writers.jpeg_tables(Image, 90), rows_per_strip=16), None
    if layout == "tiff LZMA float predictor 3":  # PIL's "F" to RGB truncates: grey + 0.25 -> grey
        f = (grey.astype(np.float32) + 0.25)[:, :, None]
        return "tif", writers.tiff(f, photometric=1, bits=32, sample_format=3,
                                   compression=34925, predictor=3), np.repeat(grey[:, :, None], 3, 2)
    if layout == "tiff signed 16-bit":
        v = grey.astype(np.int16)[:, :, None] * 2 - 100
        return "tif", writers.tiff(v, photometric=1, bits=16, sample_format=2,
                                   compression=5, predictor=2), np.repeat(
            np.clip(v, 0, 255).astype(np.uint8), 3, axis=2)
    if layout.startswith("jpeg 4:"):
        sampling = {"jpeg 4:4:0": [(1, 2), (1, 1), (1, 1)],
                    "jpeg 4:1:1": [(4, 1), (1, 1), (1, 1)]}[layout]
        return "jpg", writers.jpeg_encode(px, sampling, writers.jpeg_tables(Image, 90)), None
    if layout.startswith("tiff"):
        comp = {"tiff LZW": 5, "tiff Deflate": 8, "tiff PackBits": 32773,
                "tiff BigTIFF LZW": 5}[layout]
        if layout == "tiff BigTIFF LZW":
            return "tif", writers.tiff(px, photometric=2, compression=comp, big=True,
                                       rows_per_strip=8), px
        return "tif", writers.tiff(px, photometric=2, compression=comp,
                                   predictor=2 if comp == 5 else 1), px
    if layout == "png 16-bit":
        return "png", writers.png(px.astype(np.uint16) * 257, 2, 16), px
    if layout == "png Adam7":
        return "png", writers.png(px, 2, 8, interlace=1), px
    if layout == "png 4-bit palette":
        idx, pal = quantized(px, (2, 1, 1))
        return "png", writers.png(idx[:, :, None], 3, 4, palette=pal), pal[idx]
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG", quality=90, progressive=layout == "jpeg progressive")
    data = buf.getvalue()
    return "jpg", arith.to_arithmetic(data) if layout == "jpeg arithmetic" else data, None


def write_filtered_set(directory: Path, n: int, side: int, seed: int, Image=None) -> dict:
    """n smooth side² images as adaptively filtered PNGs; with PIL's
    `Image`, every REAL_SET_EVERY-th one in the next of REAL_SET_LAYOUTS
    instead. Their pixels (None where lossy), layouts, the PNG rows'
    filter counts and the seconds it took."""
    directory.mkdir()
    rs = np.random.RandomState(seed)
    writers = arith = None
    if Image is not None:
        writers, arith = tests_helper("_torch_imagewriters"), tests_helper("_torch_jpeg_arith")
    t0 = time.perf_counter()
    pixels, layouts, hist = [], [], np.zeros(5, np.int64)
    for i in range(n):
        px = smooth_image(rs, side)
        if Image is not None and i % REAL_SET_EVERY == 0:
            layout = REAL_SET_LAYOUTS[(i // REAL_SET_EVERY) % len(REAL_SET_LAYOUTS)]
            ext, data, held = real_set_file(layout, px, Image, writers, arith)
            (directory / f"{i}.{ext}").write_bytes(data)
            pixels.append(held)
            layouts.append(layout)
            continue
        png, filters = encode_png_adaptive(px)
        hist += np.bincount(filters, minlength=5)
        (directory / f"{i}.png").write_bytes(png)
        pixels.append(px)
        layouts.append("png filtered")
    return {"pixels": pixels, "layouts": layouts, "filters": hist.tolist(),
            "write_s": time.perf_counter() - t0}


def decode_check(fid_mod, directory: Path, written: dict, batch: int = 50, Image=None) -> dict:
    """A real set as the FID loader reads it, in FID batches of 50: the
    files' bytes, then `decode_images`, timed apart; every image must come
    back as written where the file is lossless, and, with PIL's `Image`,
    as this host's PIL decodes it. ms per image on this host, of the
    set's PNGs alone as well where it mixes layouts (the path a PNG-only
    folder takes), and by layout (each file decoded alone, in turns with
    PIL where given)."""
    from ddgan_torch.utils import decode_images

    files = fid_mod.list_image_files(directory)
    files.sort(key=lambda f: int(f.stem))
    read_s, decode_s, bad = 0.0, 0.0, 0
    for k in range(0, len(files), batch):
        t0 = time.perf_counter()
        datas = [f.read_bytes() for f in files[k:k + batch]]
        t1 = time.perf_counter()
        images = decode_images(datas)
        decode_s += time.perf_counter() - t1
        read_s += t1 - t0
        for img, px, data in zip(images, written["pixels"][k:k + batch], datas):
            wrong = px is not None and not np.array_equal(img, px)
            if Image is not None:
                want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
                wrong = wrong or img.shape != want.shape or not np.array_equal(img, want)
            bad += wrong
    check(bad == 0 and len(files) == len(written["pixels"]),
          f"{bad} of {len(files)} files of the real set decoded wrong")
    png = [f for f, layout in zip(files, written["layouts"]) if layout == "png filtered"]
    png_s = 0.0
    if 0 < len(png) < len(files):
        for k in range(0, len(png), batch):
            datas = [f.read_bytes() for f in png[k:k + batch]]
            t0 = time.perf_counter()
            decode_images(datas)
            png_s += time.perf_counter() - t0
    by_layout: dict = {}
    if Image is not None:
        per: dict = {}
        for f, layout in zip(files, written["layouts"]):
            per.setdefault(layout, f.read_bytes())
        for layout, data in per.items():
            by_layout[layout] = host_ms_in_turns(
                {"port": lambda d=data: decode_images([d]),
                 "pil": lambda d=data: np.asarray(Image.open(io.BytesIO(d)).convert("RGB"))},
                calls=5)
    return {"files": len(files), "read_s": read_s, "decode_s": decode_s,
            "decode_ms_per_image": 1e3 * decode_s / len(files),
            "png_only_ms_per_image": 1e3 * png_s / len(png) if png_s else None,
            "png_only_files": len(png),
            "row_filters_0_to_4": written["filters"],
            "layouts": {k: written["layouts"].count(k) for k in sorted(set(written["layouts"]))},
            "ms_by_layout": by_layout}


def fid_cli_run(cfg, gen_sd, dev, reset_counts, counts) -> dict:
    """`python -m ddgan_torch.cli.test_cli --compute_fid` in this process, on
    a temp experiment (content_args.json, netG_1.pth) of the full-width
    flagship at batch 64, 2,112 samples against 2,112 seeded 32² images
    (PNGs filtered as PIL filters them, every 16th file BMP, PPM, PGM,
    TIFF (LZW, Deflate, PackBits, CCITT T.6 and T.4 2-D, YCbCr
    JPEG-in-TIFF, LZMA float with predictor 3, signed 16-bit, BigTIFF),
    progressive, arithmetic, 4:4:0 or 4:1:1 JPEG, or a 16-bit, Adam7 or
    palette PNG), random Inception weights; the FID's checks and its time split;
    then the FID loader's decoding of the real set, each file against this
    host's PIL, and of filtered PNGs at 256²."""
    from ddgan_torch.cli import test_cli
    from ddgan_torch.eval import fid as fid_mod
    from ddgan_torch.eval import inception as inc
    with tempfile.TemporaryDirectory() as tmp, random_inception_env():
        tmp = Path(tmp)
        exp = tmp / "saved_info" / "dd_gan" / "cifar10" / "fid"
        exp.mkdir(parents=True)
        (exp / "content_args.json").write_text(json.dumps(cfg.replace(exp="fid").to_dict()))
        torch.save(gen_sd, exp / "netG_1.pth")
        real = tmp / "real"
        from PIL import Image

        real_set = write_filtered_set(real, FID_SAMPLES, 32, seed=30, Image=Image)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            with Stopwatch() as sw, SamplerSpans(test_cli) as spans:
                sw.wrap(test_cli, "generate_samples", "generate_wall")
                sw.wrap(test_cli, "save_image", "png_encode")
                sw.wrap(fid_mod, "decode_images", "png_decode")
                sw.wrap(inc, "default_feature_fn", "inception_build", wrap_result="inception")
                sw.wrap(fid_mod, "calculate_frechet_distance", "frechet_sqrtm")
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fid = test_cli.main(["--dataset", "cifar10", "--exp", "fid", "--epoch_id", "1",
                                     "--seed", "0", "--compute_fid", "--num_fid_samples",
                                     str(FID_SAMPLES), "--real_img_dir", str(real),
                                     "--fid_output_path", str(tmp / "fid.txt")])
                cli_s = time.perf_counter() - t0
                launches = counts()
                sampling_s = spans.seconds()
            calls = len(spans.events)
            fake = tmp / "generated_samples" / "cifar10"
            n_png = len(list(fake.glob("*.png")))
            check(n_png == FID_SAMPLES, f"--compute_fid wrote {n_png} PNGs")
            check(calls == FID_SAMPLES // BATCH, f"{calls} sampler calls")
            check(launches == {"down2x": 24 * calls, "up2x": 24 * calls, "pair_conv3x3": 0},
                  f"--compute_fid launches {launches} over {calls} sampler calls")
            check(math.isfinite(fid) and fid > 0, f"FID {fid}")
            written = float((tmp / "fid.txt").read_text())
            check(written == fid, f"fid_output_path holds {written}, the CLI returned {fid}")

            # the same FID from .npz statistics of both directories
            feature_fn = inc.default_feature_fn(2048, device=dev)
            stats = {}
            for name, d in (("fake", fake), ("real", real)):
                stats[name] = fid_mod.compute_statistics_of_path(str(d), feature_fn, 50, 2048)
                fid_mod.save_statistics(str(tmp / f"{name}.npz"), *stats[name])
            from_npz = fid_mod.calculate_fid_given_paths(
                [str(tmp / "fake.npz"), str(tmp / "real.npz")], feature_fn=feature_fn)
            npz_rel = abs(from_npz - fid) / fid
            check(npz_rel <= 1e-6, f"FID from .npz {from_npz} vs the CLI's {fid}")
            # the real directory against its own statistics
            self_fid = fid_mod.calculate_fid_given_paths(
                [str(real), str(tmp / "real.npz")], batch_size=50, feature_fn=feature_fn)
            trace = float(np.trace(stats["real"][1]))
            check(abs(self_fid) <= 1e-3 * trace, f"self-FID {self_fid}, trace(sigma) {trace}")
            # the FID loader on PIL-style filtered PNGs: the real set, and a
            # CelebA-HQ-sized one
            decode = {"32": decode_check(fid_mod, real, real_set, Image=Image)}
            decode["256"] = decode_check(fid_mod, tmp / "real256", write_filtered_set(
                tmp / "real256", DECODE_256_IMAGES, 256, seed=31))
        finally:
            os.chdir(cwd)
    out = {"fid": fid, "fid_from_npz": from_npz, "npz_rel_diff": npz_rel,
           "self_fid": self_fid, "trace_sigma_real": trace, "samples": FID_SAMPLES,
           "batch": BATCH, "sampler_calls": calls, "launches": launches,
           "cli_s": cli_s, "samples_per_s": FID_SAMPLES / cli_s,
           "sampling_device_span_s": sampling_s, "real_png_write_s": real_set["write_s"],
           "filtered_decode": decode,
           "seconds": sw.s, "calls": sw.n}
    print(f"--compute_fid: FID {fid!r} (from .npz {from_npz!r}, rel {npz_rel:.3g}); "
          f"self-FID {self_fid:.4g} against trace(sigma) {trace:.4g}; launches {launches} "
          f"over {calls} sampler calls")
    print(f"--compute_fid split (s): whole CLI {cli_s:.3f} = {out['samples_per_s']:.2f} samples/s;"
          f" sampling, device span of the calls {sampling_s:.3f}; generate loop wall "
          f"{sw.s['generate_wall']:.3f}; PNG encoding {sw.s['png_encode']:.3f} (in 2 threads, "
          f"{sw.n['png_encode']} files); PNG decoding {sw.s['png_decode']:.3f} "
          f"({2 * FID_SAMPLES} files in {sw.n['png_decode']} batches; the real set filtered as "
          f"PIL filters, rows by filter 0-4 {real_set['filters']}); Inception "
          f"{sw.s['inception']:.3f} "
          f"({sw.n['inception']} batches, with the copies); Fréchet distance (sqrtm) "
          f"{sw.s['frechet_sqrtm']:.3f} ({sw.n['frechet_sqrtm']} calls)")
    for side, d in decode.items():
        print(f"real-set decoding at {side}², FID batches of 50: {d['files']} files "
              f"({d['layouts']}), decode_images {d['decode_s']:.3f} s = "
              f"{d['decode_ms_per_image']:.3f} ms an image (reading the files {d['read_s']:.3f} "
              f"s apart; PNG rows by filter 0-4 {d['row_filters_0_to_4']}), every image exact")
        if d["png_only_ms_per_image"] is not None:
            print(f"  its {d['png_only_files']} PNGs alone, FID batches of 50: "
                  f"{d['png_only_ms_per_image']:.3f} ms an image")
        for layout, ms in d["ms_by_layout"].items():
            print(f"  {layout}: {ms['port']:.3f} ms an image (port), {ms['pil']:.3f} (PIL), "
                  "each file alone, on this host")
    return out


def is_run(cfg2, net2_16, dev, reset_counts, counts) -> dict:
    """The full-width CelebA-HQ 256 bf16 sampler at batch 16 writes 256
    samples as one [0, 1] NCHW .npy stack, which `python -m
    ddgan_torch.eval.inception_score` scores (splits 1, random logits)."""
    from ddgan_torch.cli import test_cli
    from ddgan_torch.eval import inception_score
    from ddgan_torch.utils import to_range_0_1

    sample = test_cli.make_sampler(cfg2, net2_16, BATCH_256, dev,
                                   torch.Generator(device=dev).manual_seed(31))
    calls = IS_SAMPLES // BATCH_256
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stack = [to_range_0_1(sample()).float().cpu() for _ in range(calls)]
    sampling_s = time.perf_counter() - t0
    launches = counts()
    check(launches == {"down2x": 20 * calls, "up2x": 20 * calls, "pair_conv3x3": 46 * calls},
          f"IS run launches {launches} over {calls} sampler calls")
    with tempfile.TemporaryDirectory() as tmp, random_inception_env():
        path = Path(tmp) / "samples.npy"
        np.save(path, torch.cat(stack).numpy())
        t0 = time.perf_counter()
        score, std = inception_score.main(["--sample_dir", str(path), "--splits", "1"])
        is_s = time.perf_counter() - t0
    check(math.isfinite(score) and score >= 1, f"Inception Score {score}")
    out = {"inception_score": score, "std": std, "samples": IS_SAMPLES, "batch": BATCH_256,
           "sampler_calls": calls, "launches": launches, "sampling_s": sampling_s,
           "inception_score_cli_s": is_s}
    print(f"IS {score!r} (std {std}) over {IS_SAMPLES} 256² samples; sampling {sampling_s:.3f} s "
          f"({calls} calls, launches {launches}); IS CLI {is_s:.3f} s")
    return out


# ---------------------------------------------------------------------------
# PSO: the swarm update, the PSO step, the PSO loop and the HPO search; a
# training run between content.ckpt and content.pth
PSO_SWARM = 20  # the loop's swarm (the reference's)
PSO_LOOP_ITERS = 22  # steps an epoch: the in-step swarm fires at the 21st
PSO_RESUME_ITERS = 4
PSO_RESUME_NF = 32  # keeps a PSO content.pth near 2 GB (2,044,343,757 bytes)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_launches(fn) -> int:
    """Device kernels that one call of `fn` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events() if str(ev.device_type).endswith("CUDA")
               and not getattr(ev, "is_user_annotation", False))


def swarm_bytes(params) -> int:
    """The least traffic of one swarm update: particles, velocities and
    personal bests (swarm x P each), the global best and the parameters (P
    each), each read once and written once, float32."""
    p = sum(t.numel() for t in params)
    return 2 * 4 * (3 * PSO_SWARM * p + 2 * p)


def _swarm_error(a, b) -> dict:
    """max-abs of a - b over max|b| for each kind of swarm tensor, and
    whether all of them are equal to the last bit."""
    out, exact = {}, True
    for f in ("particles", "velocities", "pbest_pos", "gbest_pos"):
        xs, ys = getattr(a, f), getattr(b, f)
        err = max(float((x.cpu() - y).abs().max()) for x, y in zip(xs, ys))
        scale = max(float(y.abs().max()) for y in ys)
        exact &= all(torch.equal(x.cpu(), y) for x, y in zip(xs, ys))
        out[f] = err / scale
    for f in ("pbest_scores", "gbest_score", "c1", "c2", "iteration"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        exact &= torch.equal(x, y)
        out[f] = float((x.double() - y.double()).abs().max())
    return {"rel_err": out, "bit_exact": exact}


def swarm_update_check(cfg, dev) -> dict:
    """`AdaptivePSO.step` at DiscriminatorSmall's full parameter set on the
    card against the CPU plain path on the same draws (drawn on the card,
    copied): two steps, the first where every particle improves, the second
    with equal fitness values; every tensor within 1e-6 of its max-abs. Then
    G's full set on the card alone, timed, with D's: ms per swarm step (CUDA
    events, mean of 3 after a warm-up), kernel launches, the byte bound at
    3.35 TB/s and peak memory."""
    from ddgan_torch.models import NCSNpp, build_discriminator
    from ddgan_torch.train import AdaptivePSO

    pso = AdaptivePSO(swarm_size=PSO_SWARM)
    c32 = cfg.replace(compute_dtype="float32")
    d_cpu = [p.detach() for p in
             build_discriminator(c32, generator=torch.Generator().manual_seed(40)).parameters()]
    d_gpu = [p.to(dev, copy=True) for p in d_cpu]
    g = torch.Generator(device=dev).manual_seed(41)
    noise = [torch.randn((PSO_SWARM,) + tuple(p.shape), generator=g, device=dev) for p in d_gpu]
    st_gpu = pso.init(d_gpu, noise=noise)
    st_cpu = pso.init(d_cpu, noise=[n.cpu() for n in noise])
    del noise
    rs = np.random.RandomState(42)
    fitness = [rs.uniform(1.0, 2.0, PSO_SWARM), np.repeat(rs.uniform(0.5, 0.9, PSO_SWARM // 2), 2)]
    out: dict = {"D_parameters": sum(p.numel() for p in d_cpu), "steps": []}
    for losses in fitness:
        draws = pso.draws(d_gpu, g)
        loss = torch.tensor(losses, dtype=torch.float32)
        pso.step(st_gpu, d_gpu, loss.to(dev), draws=draws)
        t0 = time.perf_counter()
        pso.step(st_cpu, d_cpu, loss, draws=type(draws)(*([t.cpu() for t in r] for r in draws)))
        cpu_s = time.perf_counter() - t0
        del draws
        err = _swarm_error(st_gpu, st_cpu)
        err["params"] = max(float((x.cpu() - y).abs().max()) / float(y.abs().max())
                            for x, y in zip(d_gpu, d_cpu))
        err["cpu_s"] = cpu_s
        out["steps"].append(err)
        worst = max(max(v for k, v in err["rel_err"].items() if k in
                        ("particles", "velocities", "pbest_pos", "gbest_pos")), err["params"])
        check(worst <= 1e-6 and all(err["rel_err"][k] == 0 for k in ("pbest_scores", "gbest_score",
                                                                       "c1", "c2", "iteration")),
              f"swarm update GPU vs CPU: {err}")
        print(f"swarm update, DiscriminatorSmall ({out['D_parameters']} parameters x "
              f"{PSO_SWARM}): GPU vs CPU max-abs/max|ref| {err['rel_err']}, params "
              f"{err['params']:.3g}; bit-exact {err['bit_exact']}; CPU {cpu_s:.2f} s")
    del st_cpu, d_cpu

    timing = {}
    g_gpu = [p.detach().to(dev) for p in
             NCSNpp.from_config(c32, generator=torch.Generator().manual_seed(43)).parameters()]
    for name, params, st in (("D", d_gpu, st_gpu), ("G", g_gpu, None)):
        if st is None:
            st = pso.init(params, g)
        loss = torch.rand(PSO_SWARM, generator=g, device=dev)
        pso.step(st, params, loss, g)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # from what is allocated now: the swarm(s)
        times = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            pso.step(st, params, torch.rand(PSO_SWARM, generator=g, device=dev), g)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        n_bytes = swarm_bytes(params)
        row = {"parameters": sum(p.numel() for p in params), "ms": float(np.mean(times)),
               "ms_each": times, "bytes": n_bytes, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
               "launches": kernel_launches(lambda: pso.step(st, params, loss, g)),
               "tensors": len(params),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        timing[name] = row
        print(f"swarm update {name}: {row['parameters']} parameters x {PSO_SWARM}, "
              f"{row['ms']:.3f} ms per step ({row['bound_share']:.1%} of its "
              f"{row['bound_ms']:.3f} ms bound, {n_bytes / 1e9:.2f} GB at 3.35 TB/s), "
              f"{row['launches']} kernel launches over {row['tensors']} tensors, peak memory "
              f"{row['peak_memory_gb']:.2f} GB")
        del st
    out["timing"] = timing
    return out


def _same_as_one_of(params, candidates) -> int | None:
    """The index of the candidate (a list of tensors like `params`) that
    `params` equals bit for bit, or None."""
    for j, cand in enumerate(candidates):
        if all(torch.equal(p.detach(), c) for p, c in zip(params, cand)):
            return j
    return None


def pso_step_check(cfg, g_sd, d_sd, dev, batch: int = 4, swarm: int = 3, trigger: int = 2) -> dict:
    """Three full-width f32 PSO steps (TF32 off) with a swarm of 3 and a
    trigger of 2, so that the third fires both swarms, on the card against
    the port's CPU plain path: the same weights, swarms and injected draws
    (`StepDraws`, `PSODraws`). Losses within 2e-3 max-abs; after the firing,
    G's and D's parameters equal bit for bit the previous global best or one
    particle's pre-update position, on both devices."""
    from ddgan_torch.diffusion import DiffusionCoefficients, PosteriorCoefficients
    from ddgan_torch.models import NCSNpp, build_discriminator
    from ddgan_torch.train import (AdaptivePSO, PSODraws, PSOTrainState, StepDraws, draw_step,
                                   ema_init, make_pso_train_step)

    c = cfg.replace(compute_dtype="float32")
    pso = AdaptivePSO(swarm_size=swarm)
    g = torch.Generator(device=dev).manual_seed(44)
    runs = {}
    for where in ("gpu", "cpu"):
        d = dev if where == "gpu" else torch.device("cpu")
        gen, disc = NCSNpp.from_config(c), build_discriminator(c)
        gen.load_state_dict(g_sd)
        disc.load_state_dict(d_sd)
        gen, disc = gen.to(d), disc.to(d)
        if where == "gpu":
            noise = {k: [torch.randn((swarm,) + tuple(p.shape), generator=g, device=dev)
                         for p in m.parameters()] for k, m in (("G", gen), ("D", disc))}
        state = PSOTrainState(
            gen, disc, pso_G=pso.init(list(gen.parameters()), noise=[n.to(d) for n in noise["G"]]),
            pso_D=pso.init(list(disc.parameters()), noise=[n.to(d) for n in noise["D"]]),
            ema_G=ema_init(gen), loss_buf_G=torch.zeros(trigger + 1, device=d),
            loss_buf_D=torch.zeros(trigger + 1, device=d))
        step = make_pso_train_step(
            DiffusionCoefficients.create(c.num_timesteps, c.beta_min, c.beta_max, device=d),
            PosteriorCoefficients.create(c.num_timesteps, c.beta_min, c.beta_max, device=d),
            pso, num_timesteps=c.num_timesteps, nz=c.nz, ema_decay=c.ema_decay, use_ema=True,
            trigger=trigger)
        runs[where] = (state, step, d)
    del noise
    real = real_batch(c, batch, 45)
    out: dict = {"steps": []}
    for i in range(trigger + 1):
        draws = draw_step(real, c.num_timesteps, c.nz, torch.Generator().manual_seed(46 + i))
        fires = i == trigger
        pso_draws = None
        if fires:
            sg = runs["gpu"][0]
            pso_draws = (pso.draws(list(sg.disc.parameters()), g),
                         pso.draws(list(sg.gen.parameters()), g))
        metrics, picks = {}, {}
        for where, (state, step, d) in runs.items():
            before = {net: ([x.clone() for x in getattr(state, "pso_" + net).gbest_pos],
                            [[x[j].clone() for x in getattr(state, "pso_" + net).particles]
                             for j in range(swarm)]) for net in ("G", "D")} if fires else None
            pd = None if pso_draws is None else tuple(
                PSODraws(*([t.to(d) for t in r] for r in dr)) for dr in pso_draws)
            t0 = time.perf_counter()
            m = step(state, real.to(d), None, 0.0, 0.0,
                     draws=StepDraws(*(t.to(d) for t in draws)), pso_draws=pd)
            sync(d)
            metrics[where] = {k: float(v) for k, v in m._asdict().items()}
            metrics[where]["s"] = time.perf_counter() - t0
            if fires:
                for net, module in (("G", state.gen), ("D", state.disc)):
                    old_gbest, old_parts = before[net]
                    params = list(module.parameters())
                    j = _same_as_one_of(params, old_parts)
                    prev = all(torch.equal(p.detach(), x) for p, x in zip(params, old_gbest))
                    check(j is not None or prev, f"PSO step {i} ({where}): {net}'s parameters are "
                          "neither the previous gbest nor a particle's pre-update position")
                    picks[f"{where}_{net}"] = "previous gbest" if j is None else f"particle {j}"
            del before
        err = max(abs(metrics["gpu"][k] - metrics["cpu"][k]) for k in
                  ("errD", "errD_real", "errD_fake", "errG"))
        check(err <= 2e-3 and all(np.isfinite(list(metrics["gpu"].values()))),
              f"PSO step {i}: GPU {metrics['gpu']} CPU {metrics['cpu']}")
        row = {"step": i, "fires": fires, "loss_max_abs": err, "gpu": metrics["gpu"],
               "cpu": metrics["cpu"], "picks": picks}
        if fires:
            sg, sc = runs["gpu"][0], runs["cpu"][0]
            row["swarm_gpu_vs_cpu"] = {net: _swarm_error(getattr(sg, "pso_" + net),
                                                         getattr(sc, "pso_" + net))
                                       for net in ("G", "D")}
            row["params_bit_equal"] = all(
                torch.equal(p.detach().cpu(), q.detach())
                for a, b in ((sg.gen, sc.gen), (sg.disc, sc.disc))
                for p, q in zip(a.parameters(), b.parameters()))
            check(all(picks[f"gpu_{net}"] == picks[f"cpu_{net}"] for net in ("G", "D"))
                  and row["params_bit_equal"],
                  f"PSO step {i}: the GPU picked {picks}; parameters GPU == CPU bit for bit: "
                  f"{row['params_bit_equal']}")
            pos_err = max(e["rel_err"][f] for e in row["swarm_gpu_vs_cpu"].values()
                          for f in ("particles", "velocities", "pbest_pos", "gbest_pos"))
            check(pos_err <= 1e-6, f"PSO step {i}: swarm positions GPU vs CPU {pos_err:.3g} "
                  "of max|ref|")
        out["steps"].append(row)
        print(f"PSO step {i}{' (fires both swarms)' if fires else ''}: losses GPU vs CPU "
              f"max-abs {err:.3g}; errD {metrics['gpu']['errD']:.5f} errG "
              f"{metrics['gpu']['errG']:.5f}; {picks if fires else ''}"
              + (f" parameters GPU == CPU bit for bit: {row['params_bit_equal']}" if fires else ""))
    return out


def content_bytes(state) -> int:
    """The tensor bytes a content.pth of `state` holds (weights, EMA, and
    the swarms or the Adam moments), without the pickle's own."""
    from ddgan_torch.train import PSOTrainState

    tensors = list(state.gen.state_dict().values()) + list(state.disc.state_dict().values())
    tensors += list((state.ema_G or {}).values())
    if isinstance(state, PSOTrainState):
        for sw, buf in ((state.pso_G, state.loss_buf_G), (state.pso_D, state.loss_buf_D)):
            for f in ("particles", "velocities", "pbest_pos", "gbest_pos"):
                tensors += getattr(sw, f)
            tensors += [sw.pbest_scores, sw.gbest_score, sw.c1, sw.c2, sw.iteration, buf]
    return sum(t.numel() * t.element_size() for t in tensors)


def time_pso_steps(cfg, state, dev, n: int = 4) -> dict:
    """ms per PSO step on the loop's final state (CUDA events), steps that do
    not fire the swarms and steps that fire both apart (the counts are set
    before each call), with samples/s."""
    from ddgan_torch.diffusion import DiffusionCoefficients, PosteriorCoefficients
    from ddgan_torch.train import AdaptivePSO, make_pso_train_step

    step = make_pso_train_step(
        DiffusionCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max, device=dev),
        PosteriorCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max, device=dev),
        AdaptivePSO(swarm_size=PSO_SWARM), num_timesteps=cfg.num_timesteps, nz=cfg.nz,
        ema_decay=cfg.ema_decay, use_ema=True)
    real = real_batch(cfg, cfg.batch_size, 47).to(dev)
    rng = torch.Generator(device=dev).manual_seed(48)
    out = {}
    for label, count in (("plain_step", 0), ("swarm_step", 20)):
        times = []
        for i in range(n + 1):
            state.buf_count_G = state.buf_count_D = count
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, real, rng, 0.0, 0.0)
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
        out[label] = float(np.mean(times))
        out[label + "_samples_per_s"] = cfg.batch_size / out[label] * 1e3
    return out


def pso_loop_through_train_cli(cfg, fir2x, pair_conv, sample_launches: dict) -> dict:
    """The flagship recipe with kind_of_optim 'pso' through
    `ddgan_torch.cli.train_cli` in this process, epochs 0 and 1 of
    PSO_LOOP_ITERS steps at batch 64 in bf16 on synthetic 32² data, no
    content.pth: the forward rows of `expected_fir_calls(3, 3, r1=False,
    shared=False)` each step and no other role, no pair_conv3x3, finite
    losses, losses.json, final_loss.txt and netG_*.pth, the in-step swarm at
    each epoch's 21st step and the epoch-end one (4 updates of each swarm);
    then the timed steps on the final state and the sampler CLI's 64 PNGs."""
    from ddgan_torch.cli import train_cli
    from ddgan_torch.train import checkpoint as ckpt

    n_steps = (cfg.num_epoch + 1) * cfg.limited_iter
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        exp = tmp / "saved_info" / "dd_gan" / cfg.dataset / cfg.exp
        _config_dir(tmp, cfg)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            _reset(fir2x, pair_conv)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with Tee() as tee, CheckpointIO(ckpt) as io_:
                state = train_cli.main(["--use_config_file", "True", "--exp", cfg.exp,
                                        "--num_epoch", str(cfg.num_epoch)])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            calls = _calls(fir2x, pair_conv)
            per_step = expected_fir_calls(3, len(cfg.ch_mult) - 1, r1=False, shared=False)
            want = {k: {r: (n * n_steps if r == "forward" else 0) for r, n in roles.items()}
                    for k, roles in per_step.items()}
            check(calls["fir"] == want and fir2x.LAUNCHES == {k: v["forward"]
                                                              for k, v in want.items()},
                  f"PSO loop: FIR calls {calls['fir']}, launches {fir2x.LAUNCHES}, expected {want}")
            check(pair_conv.LAUNCHES["pair_conv3x3"] == 0, "PSO loop launched pair_conv3x3")
            losses = json.loads((exp / "losses.json").read_text())
            check([e["epoch"] for e in losses] == [1, 2]
                  and all(np.isfinite([e["G_loss"], e["D_loss"]]).all() for e in losses),
                  f"PSO loop losses.json: {losses}")
            check((exp / "final_loss.txt").exists() and not (exp / "content.pth").exists(),
                  "PSO loop: final_loss.txt missing or content.pth written")
            check_netg_files(exp, cfg, range(cfg.num_epoch + 1))
            check(state.step == n_steps and int(state.pso_G.iteration) == 4
                  and int(state.pso_D.iteration) == 4,
                  f"PSO loop: step {state.step}, swarm updates G {int(state.pso_G.iteration)} "
                  f"D {int(state.pso_D.iteration)}")
            epochs = epoch_times(tee.text())
            swarm_s = [float(x) for x in re.findall(r"epoch-end swarm ([0-9.]+)s", tee.text())]
            pred = content_bytes(state)
            steps = time_pso_steps(cfg, state, next(state.gen.parameters()).device)
            del state
            torch.cuda.empty_cache()
            # without save_content the loop writes no content_args.json (as the
            # JAX package's), which the sampler CLI reads: written as phase 7 does
            (exp / "content_args.json").write_text(json.dumps(cfg.to_dict()))
            n_png = sample_from_loop(cfg, tmp, fir2x, pair_conv, sample_launches)
        finally:
            os.chdir(cwd)
    out = {"steps": n_steps, "run_s": run_s, "peak_memory_gb": peak, "launches": calls,
           "epochs": [{**e, "ms_per_step": 1e3 * e["s"] / e["iters"]} for e in epochs],
           "epoch_end_swarm_s": swarm_s, "content_pth_tensor_bytes": pred,
           "timed_steps": steps, "checkpoint_io": io_.summary(), "pngs": n_png}
    print(json.dumps({"pso_loop_flagship": out}))
    print(f"PSO loop: {n_steps} steps in {run_s:.1f} s; epochs "
          + ", ".join(f"{e['ms_per_step']:.1f} ms/step" for e in out["epochs"])
          + f"; epoch-end swarm {swarm_s} s; bare PSO step {steps['plain_step']:.3f} ms "
          f"({steps['plain_step_samples_per_s']:.1f} samples/s), one that fires both swarms "
          f"{steps['swarm_step']:.3f} ms; peak memory {peak:.2f} GB; a content.pth would hold "
          f"{pred} tensor bytes ({pred / 1e9:.2f} GB); {n_png} PNGs")
    return out


def _assert_state_equal(a, b, what: str) -> None:
    """Two PSO states equal bit for bit: weights, swarms, buffers, counters, EMA."""
    for x, y in ((a.gen, b.gen), (a.disc, b.disc)):
        for (k, p), q in zip(x.state_dict().items(), y.state_dict().values()):
            check(torch.equal(p, q), f"{what}: {k}")
    for name in ("pso_G", "pso_D"):
        sa, sb = getattr(a, name), getattr(b, name)
        for f in ("particles", "velocities", "pbest_pos", "gbest_pos"):
            check(all(torch.equal(x, y) for x, y in zip(getattr(sa, f), getattr(sb, f))),
                  f"{what}: {name}.{f}")
        for f in ("pbest_scores", "gbest_score", "c1", "c2", "iteration"):
            check(torch.equal(getattr(sa, f), getattr(sb, f)), f"{what}: {name}.{f}")
    check(torch.equal(a.loss_buf_G, b.loss_buf_G) and torch.equal(a.loss_buf_D, b.loss_buf_D)
          and (a.buf_count_G, a.buf_count_D, a.step, a.epoch)
          == (b.buf_count_G, b.buf_count_D, b.step, b.epoch), f"{what}: buffers and counters")
    check(all(torch.equal(a.ema_G[k], b.ema_G[k]) for k in b.ema_G), f"{what}: EMA")


def pso_resume(cfg, fir2x, pair_conv) -> dict:
    """The PSO recipe at nf PSO_RESUME_NF through `train_cli`: epochs 0 and
    1 with content.pth written, then --resume for epoch 2. The state the
    resume loads equals the first run's final state bit for bit, and the
    global step continues; the bytes and seconds of each write and read."""
    from ddgan_torch.cli import train_cli
    from ddgan_torch.train import checkpoint as ckpt

    argv = ["--use_config_file", "True", "--exp", cfg.exp]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _config_dir(tmp, cfg)
        cwd = os.getcwd()
        os.chdir(tmp)
        loaded = []
        try:
            with CheckpointIO(ckpt) as io_:
                first = train_cli.main(argv + ["--num_epoch", "1"])
                timed_load = ckpt.load_content

                def load_and_keep(exp_path, state):
                    out = timed_load(exp_path, state)
                    _assert_state_equal(state, first, "the resumed state against the saved one")
                    loaded.append(state.epoch)
                    return out

                ckpt.load_content = load_and_keep
                second = train_cli.main(argv + ["--num_epoch", "2", "--resume"])
        finally:
            os.chdir(cwd)
    check(loaded == [2] and second.step == first.step + cfg.limited_iter == 3 * cfg.limited_iter
          and second.epoch == 3, f"PSO resume: loaded {loaded}, steps {first.step} -> "
          f"{second.step}, epoch {second.epoch}")
    out = {"parameters_G": sum(p.numel() for p in first.gen.parameters()),
           "steps": [first.step, second.step], "checkpoint_io": io_.summary()}
    for key, row in out["checkpoint_io"].items():
        print(f"PSO resume (nf {cfg.num_channels_dae}) {key}: {row['bytes']} bytes, "
              f"{row['mean_s']:.3f} s mean over {row['count']} ({row['gb_per_s']:.2f} GB/s)")
    print(f"PSO resume: the loaded swarms, ring buffers, counters and EMA equal the saved ones "
          f"bit for bit; global step {first.step} -> {second.step}")
    return out


def _sha256(path: Path) -> str:
    import hashlib

    return hashlib.sha256(path.read_bytes()).hexdigest()


class _ErrorLog(logging.Handler):
    """Keeps the error records that reach a logger (an evaluation that fails
    logs one to ddgan_torch.pso)."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records: list = []

    def emit(self, record) -> None:
        self.records.append(record.getMessage()[:2000])


HPO_ITERS = 1  # steps an epoch of each HPO evaluation (R1 at step 0)


def hpo_search(fir2x, pair_conv, iters: int = HPO_ITERS) -> dict:
    """`python -m ddgan_torch.pso.cli` in this process, in a directory that
    holds copies of the repository's configs/config.json (dataset switched
    to synthetic and save_content off, since no evaluation resumes; the
    rest as shipped) and configs/search_space_params.json:
    2 particles x 2 iterations of `iters` steps an epoch with combined scoring; the
    pso-optim preset, 1 particle x 1 iteration; one evaluation in a
    subprocess. Every evaluation must train to its end: no evaluation
    logs a failure, each leaves a losses.json of its epochs and a finite
    final_loss.txt for its scorer (read by a spy on the scorers), and each
    score is finite. The FIR calls by role over the in-process evaluations
    must be `expected_fir_calls` over the steps they ran (a subprocess
    counts its own). best_hyperparameters.json written, no pso_eval_*
    directory or configs/config_*.json left, the repository's config
    unchanged; seconds per evaluation."""
    from ddgan_torch.pso import cli as pso_cli
    from ddgan_torch.pso import evaluate as pso_eval

    repo_cfg = ROOT / "configs" / "config.json"
    sha0 = _sha256(repo_cfg)
    shipped = json.loads(repo_cfg.read_text())
    runs = {"search": (["--num_particles", "2", "--num_iterations", "2",
                        "--limited_iteration_mode", str(iters), "--scoring", "combined",
                        "--eval_mode", "inprocess"], 1),
            "pso_optim": (["--preset", "pso-optim", "--num_particles", "1", "--num_iterations",
                           "1", "--limited_iteration_mode", str(iters)], 5),
            "subprocess": (["--num_particles", "1", "--num_iterations", "1",
                            "--limited_iteration_mode", str(iters), "--eval_mode", "subprocess"],
                           1)}
    out: dict = {}
    inner = pso_cli.make_evaluator
    scorers = {"compute_loss": pso_eval.compute_loss,
               "loss_stability_score": pso_eval.loss_stability_score}
    reads: list = []

    def spy(name):
        def scorer(exp_path, *args, **kw):
            exp = Path(exp_path)
            losses = exp / "losses.json"
            final = exp / "final_loss.txt"
            reads.append({"epochs": len(json.loads(losses.read_text())) if losses.exists()
                          else None,
                          "final_G_loss": float(final.read_text()) if final.exists() else None})
            return scorers[name](exp_path, *args, **kw)
        return scorer

    errors = _ErrorLog()
    want: dict = {}  # the in-process evaluations' FIR calls
    n_d = 3 if str(shipped["disc_small"]).lower() == "yes" else 6
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "configs").mkdir()
        (tmp / "configs" / "config.json").write_text(json.dumps(
            {**shipped, "dataset": "synthetic", "save_content": False}))
        shutil.copy(ROOT / "configs" / "search_space_params.json", tmp / "configs")
        cwd = os.getcwd()
        os.chdir(tmp)
        logging.getLogger("ddgan_torch").addHandler(errors)  # the CLI resets its own
        try:
            _reset(fir2x, pair_conv)
            for name, (argv, num_epoch) in runs.items():
                evals = []
                reads.clear()

                def timed_evaluator(*args, **kw):
                    evaluate = inner(*args, **kw)

                    def timed(position, seed):
                        t0 = time.perf_counter()
                        score = evaluate(position, seed)
                        evals.append({"s": time.perf_counter() - t0, "score": score})
                        return score
                    return timed

                pso_cli.make_evaluator = timed_evaluator
                for f in scorers:
                    setattr(pso_eval, f, spy(f))
                with Tee() as tee:
                    best = pso_cli.main(argv + ["--batch_size", "16"])
                for f, fn in scorers.items():
                    setattr(pso_eval, f, fn)
                check(errors.records == [], f"HPO {name}: failed evaluations {errors.records}")
                scores = [float(m) for m in re.findall(r"Score: (\S+)", tee.text())]
                check(len(scores) == len(evals) == len(reads)
                      and all(np.isfinite(s) for s in scores),
                      f"HPO {name}: scores {scores} over {len(evals)} evaluations")
                epochs = num_epoch + 1  # the loop runs epochs 0..num_epoch
                check(all(r["epochs"] == epochs and r["final_G_loss"] is not None
                          and np.isfinite(r["final_G_loss"]) for r in reads),
                      f"HPO {name}: what the evaluations left for their scorers {reads}")
                for e, r in zip(evals, reads):
                    e.update(r)
                if "subprocess" not in argv:
                    for _ in evals:
                        for k, roles in expected_run_calls(
                                range(epochs * iters), int(shipped["lazy_reg"]), n_d,
                                len(shipped["ch_mult"]) - 1,
                                shared=int(shipped["image_size"]) >= 256).items():
                            for role, n in roles.items():
                                want.setdefault(k, {}).setdefault(role, 0)
                                want[k][role] += n
                check((tmp / "best_hyperparameters.json").exists()
                      and json.loads((tmp / "best_hyperparameters.json").read_text()) == best,
                      f"HPO {name}: best_hyperparameters.json")
                left = sorted(str(p.relative_to(tmp)) for p in tmp.rglob("*")
                              if p.name.startswith("pso_eval_") or p.name.startswith("config_"))
                check(left == [], f"HPO {name}: left behind {left}")
                out[name] = {"evaluations": evals, "scores": scores,
                             "s_per_evaluation": float(np.mean([e["s"] for e in evals])),
                             "best": best}
                print(f"HPO {name}: {len(evals)} evaluations, scores {scores}, final G losses "
                      f"{[r['final_G_loss'] for r in reads]}, "
                      f"{out[name]['s_per_evaluation']:.2f} s per evaluation")
            torch.cuda.synchronize()
            calls = _calls(fir2x, pair_conv)
            launches = {"fir": dict(fir2x.LAUNCHES), "pair_conv3x3": dict(pair_conv.LAUNCHES)}
        finally:
            for f, fn in scorers.items():
                setattr(pso_eval, f, fn)
            pso_cli.make_evaluator = inner
            logging.getLogger("ddgan_torch").removeHandler(errors)
            os.chdir(cwd)
    check(_sha256(repo_cfg) == sha0, "the repository's configs/config.json changed")
    check(calls["fir"] == want
          and launches["fir"] == {k: sum(v.values()) for k, v in want.items()},
          f"HPO: FIR calls {calls['fir']}, launches {launches['fir']}, expected {want}")
    check(not any(calls["pair_conv3x3"].values()),
          f"HPO: pair_conv3x3 {calls['pair_conv3x3']} at 64²")
    out["launches"] = calls
    print(f"HPO in-process evaluations: FIR calls by role {calls['fir']} (as expected over "
          f"their steps), pair_conv3x3 {calls['pair_conv3x3']}; the repository's "
          "configs/config.json unchanged")
    return out


def assert_content_equal(x, y, path: str = "") -> None:
    """Two content.pth dicts equal key for key and bit for bit, the
    optimizers' learning rate apart (the step sets it, and content.ckpt
    does not hold it)."""
    if path.endswith("/param_groups/0/lr"):
        return
    if isinstance(y, (list, tuple)):
        y, x = dict(enumerate(y)), dict(enumerate(x))
    if isinstance(y, dict):
        check(isinstance(x, dict) and set(x) == set(y), f"round trip {path}: keys")
        for k in y:
            assert_content_equal(x[k], y[k], f"{path}/{k}")
    elif isinstance(y, torch.Tensor):
        check(x.dtype == y.dtype and torch.equal(x, y), f"round trip {path}")
    else:
        check(x == y, f"round trip {path}: {x} != {y}")


def content_round_trip(kept: Path, cfg) -> dict:
    """Phase 27's flagship Adam run: content.pth to content.ckpt
    (`python -m ddgan_torch.compat.content --to ckpt`) and back (`--to
    pth`), every tensor and counter equal bit for bit (the optimizers'
    learning rate apart: the step sets it, and content.ckpt does not hold
    it); then `train_cli --resume` from a directory that holds only
    content.ckpt (with its args and losses) continues the run for one epoch."""
    from ddgan_torch.cli import train_cli
    from ddgan_torch.compat import content

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        exp = tmp / "saved_info" / "dd_gan" / cfg.dataset / cfg.exp
        shutil.copytree(kept, exp)
        orig = torch.load(exp / "content.pth", map_location="cpu", weights_only=False)
        to_ckpt = content.main([str(exp), "--to", "ckpt"])
        (exp / "content.pth").unlink()
        to_pth = content.main([str(exp), "--to", "pth"])
        back = torch.load(exp / "content.pth", map_location="cpu", weights_only=False)
        assert_content_equal(back, orig)
        (exp / "content.pth").unlink()
        _config_dir(tmp, cfg)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            with Tee() as tee:
                state = train_cli.main(["--use_config_file", "True", "--exp", cfg.exp,
                                        "--num_epoch", str(orig["epoch"]), "--resume"])
        finally:
            os.chdir(cwd)
    m = re.search(r"=> Loaded checkpoint \(epoch (\d+)\)", tee.text())
    check(m is not None and int(m[1]) == orig["epoch"]
          and state.step == orig["global_step"] + cfg.limited_iter,
          f"resume from content.ckpt: {m and m[0]}, step {state.step}")
    out = {"to_ckpt": to_ckpt, "to_pth": to_pth, "resumed_step": state.step}
    print(f"content round trip: {to_ckpt['read_bytes']} B content.pth -> "
          f"{to_ckpt['write_bytes']} B content.ckpt in {to_ckpt['read_s']:.2f} + "
          f"{to_ckpt['write_s']:.2f} s; back in {to_pth['read_s']:.2f} + "
          f"{to_pth['write_s']:.2f} s; "
          f"equal bit for bit; train_cli --resume from content.ckpt alone: epoch {m[1]}, global "
          f"step {orig['global_step']} -> {state.step}")
    return out


# ---------------------------------------------------------------------------
# the generator option families (phases 38-43)
PYRAMID_SIDES = [256, 128, 64, 32, 16, 8, 4]  # the pyramids' planes: 256² down to 8², 32² to 4²
# the pyramids' FIR inputs in a bf16 forward: the input pyramid's down2x
# (C = 3) at 256..16 (CelebA-HQ 256, batch 16) and 32..8 (flagship, batch
# 64), the output pyramid's up2x at 8..128 and 4..16
PYRAMID_DOWN = ([(BATCH_256, 3, s, s) for s in (256, 128, 64, 32, 16)]
                + [(BATCH, 3, s, s) for s in (32, 16, 8)])
PYRAMID_UP = ([(BATCH_256, 3, s, s) for s in (8, 16, 32, 64, 128)]
              + [(BATCH, 3, s, s) for s in (4, 8, 16)])
FAMILY_LOOP_ITERS = 2  # steps an epoch of phase 41's train CLI run (R1 at step 0)
FAMILY_PSO_SWARM = 1  # phase 42's PSO state: G's swarm at full width, 4 arrays of it


def family_config(base, family: str):
    return base.replace(**FAMILIES[family])


def family_forwards(Config, dev, fir2x, pair_conv) -> dict:
    """Phase 39: each option family at flagship width (N(0,1)/sqrt(fan_in)
    weights, output std > 0.05): one f32 forward at batch 2 on the card
    (TF32 off) against the port's CPU plain path (max-abs <= 2e-3), at t
    >= 1; for the Fourier family also a batch whose row at t = 0 is not
    finite on either device; then one bf16 forward at batch 64 whose FIR
    launches equal `expected_g_fir` and which launches no pair_conv3x3."""
    from ddgan_torch.models import NCSNpp
    from ddgan_torch.utils import randomize_parameters_

    out = {}
    for i, family in enumerate(FAMILIES):
        cfg = family_config(flagship_config(Config), family)
        cfg32 = cfg.replace(compute_dtype="float32")
        net_cpu = randomize_parameters_(NCSNpp.from_config(
            cfg32, generator=torch.Generator().manual_seed(40 + i)), seed=40 + i).eval()
        net_gpu = copy.deepcopy(net_cpu).to(dev)
        rs = np.random.RandomState(50 + i)
        shape = (2, cfg.num_channels, cfg.image_size, cfg.image_size)
        x = rs.randn(*shape) if cfg.centered else rs.uniform(0, 1, shape)  # [0, 1] uncentered
        x = torch.from_numpy(x.astype(np.float32))
        z = torch.from_numpy(rs.randn(2, cfg.nz).astype(np.float32))
        rows = {"t>=1": torch.tensor([1, T - 1])}
        if cfg.embedding_type == "fourier":
            rows["t=0"] = torch.tensor([0, 2])
        res = {}
        for label, t in rows.items():
            with torch.no_grad():
                want = net_cpu(x, t, z)
                got = net_gpu(x.to(dev), t.to(dev), z.to(dev)).cpu()
            if label == "t=0":  # log(0): the JAX package's behaviour, kept
                check(not torch.isfinite(want[0]).any() and not torch.isfinite(got[0]).any()
                      and torch.isfinite(want[1]).all() and torch.isfinite(got[1]).all()
                      and (got[1] - want[1]).abs().max().item() <= 2e-3,
                      f"{family}: the t = 0 row")
                res["t0_row_finite"] = {"cpu": bool(torch.isfinite(want[0]).any()),
                                        "gpu": bool(torch.isfinite(got[0]).any())}
                continue
            err, std = (got - want).abs().max().item(), want.std().item()
            check(bool(torch.isfinite(got).all()) and std > 0.05 and err <= 2e-3,
                  f"{family}: GPU vs CPU max-abs {err} (std {std})")
            res.update(gpu_vs_cpu_max_abs=err, std=std)
        net16 = NCSNpp.from_config(cfg)
        net16.load_state_dict(net_cpu.state_dict())
        net16 = net16.to(dev).eval()
        g = torch.Generator(device=dev).manual_seed(60 + i)
        xb = torch.randn((BATCH,) + shape[1:], generator=g, device=dev)
        tb = torch.randint(1, T, (BATCH,), generator=g, device=dev)
        zb = torch.randn((BATCH, cfg.nz), generator=g, device=dev)
        _reset(fir2x, pair_conv)
        with torch.no_grad():
            y = net16(xb, tb, zb)
        torch.cuda.synchronize()
        launches = {**fir2x.LAUNCHES, **pair_conv.LAUNCHES}
        want_l = {**expected_g_fir(len(cfg.ch_mult) - 1, **FAMILY_FIR[family]), "pair_conv3x3": 0}
        check(launches == want_l and bool(torch.isfinite(y).all()),
              f"{family} bf16 forward: launches {launches}, expected {want_l}")
        res.update(parameters=sum(p.numel() for p in net_cpu.parameters()),
                   buffers=[k for k, _ in net_cpu.named_buffers()], launches_bf16=launches)
        out[family] = res
        print(f"{family}: {res['parameters']} parameters, buffers {res['buffers']}; f32 GPU vs "
              f"CPU max-abs {res['gpu_vs_cpu_max_abs']:.3g} (std {res['std']:.4f})"
              + (f"; t = 0 row finite {res['t0_row_finite']}" if "t0_row_finite" in res else "")
              + f"; bf16 batch {BATCH} launches {launches}")
        del net_cpu, net_gpu, net16, y
    return out


def pyramid_sum_256(cfg2, d_sd, gi_sd, di_sd, net2_16, sampler256_ms: float,
                    recipe_step: dict, dev, fir2x, pair_conv) -> dict:
    """Phase 40: `pyramid_sum` at the CelebA-HQ 256 recipe's widths. The T=2
    sampler in bf16 at batch 16 (K1 and K2 launches per call, within 0.03
    of the f32 run on the card); one f32 D and G update with R1 on the card
    against the same update with the kernels' plain versions on the card
    (batch 2, `compare_step_gpu_cpu` with `plain`); bf16 steps at batch 4
    from the recipe's init (launches by role per step: `expected_fir_calls`
    with the pyramids' roles, and K2's 64 of the recipe); ms per step and
    samples/s beside the recipe's, each timed here in turn, peak memory,
    and the sampler's samples/s beside the recipe's."""
    from ddgan_torch.cli import test_cli
    from ddgan_torch.diffusion import PosteriorCoefficients, sample_from_model_with_noise
    from ddgan_torch.models import NCSNpp
    from ddgan_torch.utils import randomize_parameters_

    fam = FAMILY_FIR["pyramid_sum"]
    cfg = family_config(cfg2, "pyramid_sum")
    cfg32 = cfg.replace(compute_dtype="float32")
    n_g = len(cfg.ch_mult) - 1
    net32 = randomize_parameters_(NCSNpp.from_config(cfg32), seed=70).to(dev).eval()
    net16 = NCSNpp.from_config(cfg)
    net16.load_state_dict(net32.state_dict())
    net16 = net16.to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(71)
    shape = (BATCH_256, cfg.num_channels, cfg.image_size, cfg.image_size)
    x = torch.randn(shape, generator=g, device=dev)
    zs = [torch.randn((BATCH_256, cfg.nz), generator=g, device=dev) for _ in range(T_256)]
    noises = [torch.randn(shape, generator=g, device=dev) for _ in range(T_256)]
    coeff = PosteriorCoefficients.create(T_256, cfg.beta_min, cfg.beta_max, device=dev)
    with torch.no_grad():
        ref32 = sample_from_model_with_noise(coeff, net32, T_256, x, zs, noises)
    _reset(fir2x, pair_conv)
    got16 = sample_from_model_with_noise(coeff, net16, T_256, x, zs, noises)
    torch.cuda.synchronize()
    sampler_launches = {**fir2x.LAUNCHES, **pair_conv.LAUNCHES}
    per_fwd = expected_g_fir(n_g, **fam)
    want = {k: T_256 * v for k, v in per_fwd.items()}
    want["pair_conv3x3"] = T_256 * 23
    err16 = (got16.float() - ref32).abs().max().item()
    std = ref32.std().item()
    print(f"pyramid_sum 256² sampler: bf16 vs f32 max-abs {err16:.4g} (f32 std {std:.4f}); "
          f"launches per call {sampler_launches}")
    check(bool(torch.isfinite(got16).all()) and std > 0.05, "pyramid_sum 256² sampler output")
    check(sampler_launches == want, f"pyramid_sum 256² sampler launches {sampler_launches}, "
          f"expected {want}")
    check(err16 < 0.03, f"pyramid_sum 256² bf16 vs f32 max-abs {err16} >= 0.03")
    del ref32, got16, net32

    g_sd = randomize_parameters_(NCSNpp.from_config(cfg32), seed=72).state_dict()
    step_cmp = compare_step_gpu_cpu(cfg32, g_sd, d_sd, batch=2, seed=73,
                                    plain=(fir2x, pair_conv))

    gfi_sd = NCSNpp.from_config(cfg32, generator=torch.Generator().manual_seed(11)).state_dict()
    st, stp = build_trainer(cfg, gfi_sd, di_sd, dev, "bfloat16")
    real = real_batch(cfg, TRAIN_BATCH_256, 14).to(dev)
    rng = torch.Generator(device=dev).manual_seed(74)
    paths, losses = {}, []
    for i in range(3):
        _reset(fir2x, pair_conv)
        m = stp(st, real, rng, cfg.lr_g, cfg.lr_d)
        torch.cuda.synchronize()
        vals = [float(v) for v in m]
        r1 = i % cfg.lazy_reg == 0
        calls = _calls(fir2x, pair_conv)
        want = expected_fir_calls(6, n_g, r1, shared=True, **fam)
        check(all(np.isfinite(vals)) and r1 == (vals[4] > 0), f"pyramid_sum step {i}: {vals}")
        check(calls["fir"] == want
              and fir2x.LAUNCHES == {k: sum(v.values()) for k, v in want.items()},
              f"pyramid_sum step {i}: FIR calls {calls['fir']}, expected {want}")
        check(calls["pair_conv3x3"] == {"forward": 46, "dx": 18, "dx_library": 5}
              and pair_conv.LAUNCHES["pair_conv3x3"] == 64,
              f"pyramid_sum step {i}: pair_conv3x3 {calls['pair_conv3x3']} {pair_conv.LAUNCHES}")
        if i < 2:
            paths["pyramid_sum_celeba256_train_" + ("r1" if r1 else "plain")] = calls
        losses.append((vals[0], vals[3]))
    print(f"pyramid_sum 256² bf16 steps (errD, errG): {losses}; launches "
          f"{json.dumps(paths)}")
    recipe_st, recipe_stp = build_trainer(cfg2.replace(dropout=0.0), gi_sd, di_sd, dev,
                                          "bfloat16")
    times = {}
    for label, (s_, f_) in (("recipe", (recipe_st, recipe_stp)), ("pyramid_sum", (st, stp))):
        times[label] = time_steps(s_, f_, real, torch.Generator(device=dev).manual_seed(75))
        t_ = times[label]
        for k in ("r1_step", "plain_step"):
            t_[k.replace("step", "samples_per_s")] = TRAIN_BATCH_256 / t_[k] * 1e3
        print(f"256² bf16 train step, {label}: R1 {t_['r1_step']:.3f} ms, other "
              f"{t_['plain_step']:.3f} ms ({t_['plain_samples_per_s']:.2f} samples/s at batch "
              f"{TRAIN_BATCH_256}); peak memory {t_['peak_memory_gb']:.2f} GB")
    print(f"(phase 25's recipe step: R1 {recipe_step['r1_step']:.3f} ms, other "
          f"{recipe_step['plain_step']:.3f} ms)")
    del st, stp, recipe_st, recipe_stp
    sampler = {}
    for label, (c_, n_) in (("recipe", (cfg2, net2_16)), ("pyramid_sum", (cfg, net16))):
        call = test_cli.make_sampler(c_, n_, BATCH_256, dev, torch.Generator(device=dev).manual_seed(76))
        sampler[label] = sampler_ms(call, warmup=2, iters=5)
        print(f"256² bf16 sampler, {label}: {sampler[label]:.3f} ms per T=2 call = "
              f"{BATCH_256 / sampler[label] * 1e3:.2f} samples/s (phase 16's recipe: "
              f"{BATCH_256 / sampler256_ms * 1e3:.2f})")
    return {"sampler_launches": sampler_launches, "bf16_vs_f32_max_abs": err16,
            "kernels_vs_plain_step": step_cmp, "train_paths": paths, "losses": losses,
            "step_ms": times, "sampler_ms": sampler}


def family_loop_through_train_cli(cfg, family: str, fir2x, pair_conv,
                                  sample_launches: dict) -> dict:
    """Phase 41: `cfg` (a family at flagship width, bf16, batch 64,
    synthetic 32²) through `python -m ddgan_torch.cli.train_cli
    --use_config_file True` in this process for epochs 0 and 1 (R1 at step
    0; phase 27 runs the train CLI in a fresh process), then --resume for
    epoch 2 (launches counted against `expected_fir_calls` with the
    family's roles), the checks of `check_loop_run`, and the sampler CLI's
    64 PNGs from the last netG."""
    from ddgan_torch.cli import train_cli

    argv = ["--use_config_file", "True", "--exp", cfg.exp]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        exp = tmp / "saved_info" / "dd_gan" / cfg.dataset / cfg.exp
        _config_dir(tmp, cfg)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            with Tee() as first:
                train_cli.main(argv + ["--num_epoch", "1"])
            first_s = time.perf_counter() - t0
            _reset(fir2x, pair_conv)
            with Tee() as tee:
                state = train_cli.main(argv + ["--num_epoch", "2", "--resume"])
            m = re.search(r"=> Loaded checkpoint \(epoch (\d+)\)", tee.text())
            check(m is not None and int(m[1]) == 2, "the resumed run did not load epoch 2")
            run = cfg.replace(num_epoch=2)
            calls = check_loop_run(run, exp, range(2 * cfg.limited_iter, 3 * cfg.limited_iter),
                                   fir2x, pair_conv, None, FAMILY_FIR[family])
            check(state.step == 3 * cfg.limited_iter, f"resumed run ended at step {state.step}")
            n_png = sample_from_loop(run, tmp, fir2x, pair_conv, sample_launches)
        finally:
            os.chdir(cwd)
    epochs = epoch_times(first.text() + tee.text())
    out = {"family": family, "first_run_s": first_s, "steps": 3 * cfg.limited_iter,
           "launches": calls, "pngs": n_png, "epochs": epochs}
    print(f"{family} through train_cli: epochs 0-1 ({first_s:.1f} s), epoch 2 resumed; epoch "
          f"lines {epochs}; FIR calls of the resumed epoch {calls['fir']}; {n_png} PNGs")
    return out


def buffer_bridges(Config, dev) -> dict:
    """Phase 42: a full-width `pyramid_cat_fourier_one` state, whose G holds
    the Fourier projection W as a buffer, through content.pth ->
    content.ckpt -> content.pth (`ddgan_torch.compat.content`), as an Adam
    run (moments set by one step on seeded gradients) and as a PSO run
    (swarm FAMILY_PSO_SWARM, seeded loss buffers): equal bit for bit (the
    optimizers' learning rate apart), W included, and the content.ckpt's
    params_G without W, its buffers_G with it; and its netG in the JAX
    package's layout (`write_msgpack` of {"params", "buffers"}), which
    `load_netg_ckpt` loads with strict=True. Bytes and seconds of each."""
    from ddgan_torch.compat import (content, flax_trees_from_port, load_netg_ckpt,
                                    read_msgpack, write_msgpack)
    from ddgan_torch.models import NCSNpp
    from ddgan_torch.train import AdaptivePSO, create_pso_train_state
    from ddgan_torch.train import checkpoint as ckpt

    cfg = family_config(flagship_config(Config), "pyramid_cat_fourier_one").replace(
        dataset="synthetic", compute_dtype="float32")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("adam", "pso"):
            c = cfg.replace(kind_of_optim=kind, exp=f"fourier_{kind}")
            exp = Path(tmp) / kind
            state = content.empty_state(c, dev)
            g = torch.Generator(device=dev).manual_seed(80)
            if kind == "adam":
                for opt, net in ((state.opt_G, state.gen), (state.opt_D, state.disc)):
                    for p_ in net.parameters():
                        p_.grad = torch.randn(p_.shape, generator=g, device=dev)
                    opt.step(1e-4)
                    opt.zero_grad()
            else:
                state = create_pso_train_state(state.gen, state.disc,
                                               AdaptivePSO(swarm_size=FAMILY_PSO_SWARM), g)
                for name in ("loss_buf_G", "loss_buf_D"):
                    setattr(state, name, torch.rand(getattr(state, name).shape, generator=g,
                                                    device=dev))
                state.buf_count_G, state.buf_count_D = 3, 5
            state.step, state.epoch = 7, 2
            names = [k for k, _ in state.gen.named_parameters()]
            check("all_modules.0.W" in state.gen.state_dict() and "all_modules.0.W" not in names
                  and list(state.ema_G) == names, f"{kind}: W is not a buffer alone")
            ckpt.save_content(exp, state, c.to_dict())
            orig = torch.load(exp / "content.pth", map_location="cpu", weights_only=False)
            to_ckpt = content.main([str(exp), "--to", "ckpt"])
            raw = read_msgpack((exp / "content.ckpt").read_bytes())
            check(set(raw["buffers_G"]) == {"all_modules_0"}
                  and "W" not in raw["params_G"].get("all_modules_0", {}),
                  f"{kind}: content.ckpt's buffers_G {list(raw['buffers_G'])}")
            (exp / "content.pth").unlink()
            to_pth = content.main([str(exp), "--to", "pth"])
            back = torch.load(exp / "content.pth", map_location="cpu", weights_only=False)
            assert_content_equal(back, orig)
            out[kind] = {"to_ckpt": to_ckpt, "to_pth": to_pth}
            print(f"{kind}: content.pth {to_ckpt['read_bytes']} B -> content.ckpt "
                  f"{to_ckpt['write_bytes']} B in {to_ckpt['read_s']:.3f} + "
                  f"{to_ckpt['write_s']:.3f} s, back in {to_pth['read_s']:.3f} + "
                  f"{to_pth['write_s']:.3f} s; equal bit for bit, W included")
            if kind == "adam":
                params, buffers = flax_trees_from_port(state.gen, state.gen.state_dict())
                path = Path(tmp) / "netG_2.ckpt"
                t0 = time.perf_counter()
                path.write_bytes(write_msgpack({"params": params, "buffers": buffers}))
                write_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                net = NCSNpp.from_config(c)
                net.load_state_dict(load_netg_ckpt(str(path)), strict=True)
                read_s = time.perf_counter() - t0
                for k, v in state.gen.state_dict().items():
                    check(torch.equal(net.state_dict()[k], v.cpu()), f"netG_2.ckpt: {k}")
                out["netg_ckpt"] = {"bytes": path.stat().st_size, "write_s": write_s,
                                    "read_s": read_s}
                print(f"netG_2.ckpt (params and buffers): {path.stat().st_size} B, written in "
                      f"{write_s:.3f} s, loaded with strict=True in {read_s:.3f} s")
            del state, orig, back, raw
            torch.cuda.empty_cache()
    return out


def legacy_on_card(dev) -> dict:
    """Phase 43: each class of `nn/legacy.py` and both `ops/fused_act.py`
    functions once on the card against the CPU, f32 with TF32 off,
    N(0,1)/sqrt(fan_in) weights: max-abs <= 1e-5 of max|ref|."""
    from ddgan_torch.nn import legacy
    from ddgan_torch.ops import fused_act
    from ddgan_torch.utils import randomize_parameters_

    g = torch.Generator().manual_seed(90)

    def rand(*shape):
        return torch.randn(shape, generator=g)

    x64, x128 = rand(4, 64, 32, 32), rand(4, 128, 16, 16)
    cases = {
        "CRPBlock": (legacy.CRPBlock(64, 2), (x64,)),
        "CRPBlock avg": (legacy.CRPBlock(64, 2, maxpool=False), (x64,)),
        "RCUBlock": (legacy.RCUBlock(64, 2, 2), (x64,)),
        "MSFBlock": (legacy.MSFBlock([64, 128], 64), ([x64, x128], (32, 32))),
        "RefineBlock": (legacy.RefineBlock([64, 128], 64), ([x64, x128], (32, 32))),
        "ConvMeanPool": (legacy.ConvMeanPool(64, 128), (x64,)),
        "MeanPoolConv": (legacy.MeanPoolConv(64, 128), (x64,)),
        "UpsampleConv": (legacy.UpsampleConv(128, 64), (x128,)),
        "ResidualBlock": (legacy.ResidualBlock(64, 128, resample="down"), (x64,)),
        "AttnBlock": (legacy.AttnBlock(128), (x128,)),
        "UpsampleDDPM": (legacy.UpsampleDDPM(128, with_conv=True), (x128,)),
        "DownsampleDDPM": (legacy.DownsampleDDPM(64, with_conv=True), (x64,)),
        "ResnetBlockDDPM": (legacy.ResnetBlockDDPM(F.silu, 64, 128, temb_dim=32),
                            (x64, rand(4, 32))),
    }
    errs = {}

    def to(v, device):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return [to(u, device) for u in v] if isinstance(v, list) else v

    for name, (module, args) in cases.items():
        cpu = randomize_parameters_(module, seed=91).eval()
        gpu = copy.deepcopy(cpu).to(dev)
        with torch.no_grad():
            want, got = cpu(*args), gpu(*to(list(args), dev)).cpu()
        errs[name] = (got - want).abs().max().item() / want.abs().max().item()
    b = rand(64)
    for name, fn in (("fused_leaky_relu", lambda x_, b_: fused_act.fused_leaky_relu(x_, b_)),
                     ("fused_bias_act linear",
                      lambda x_, b_: fused_act.fused_bias_act(x_, b_, act="linear"))):
        want, got = fn(x64, b), fn(x64.to(dev), b.to(dev)).cpu()
        errs[name] = (got - want).abs().max().item() / want.abs().max().item()
    errs["get_act lrelu"] = (legacy.get_act("lrelu")(x64.to(dev)).cpu()
                             - legacy.get_act("lrelu")(x64)).abs().max().item()
    worst = max(errs, key=errs.get)
    print("legacy and fused_act on the card against the CPU, max-abs over max|ref|: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    check(errs[worst] <= 1e-5, f"{worst}: {errs[worst]} of max|ref|")
    return errs


# ---------------------------------------------------------------------------
# data parallelism (ddgan_torch.parallel, train/zero1.py) on the one card
PARALLEL_ITERS = 2  # steps an epoch of phase 46's two ranks (R1 at step 0)
PARALLEL_BOUNDS = dict(rtol=3e-4, atol=3e-5)  # ZeRO-1 against replicated (tests/test_zero1.py)
# past the first bf16 step, the share of weight and EMA elements that may lie
# beyond PARALLEL_BOUNDS: about 5x the 23,400 of 109.6M (2.1e-4) measured after
# four steps on an H100 from G's JAX init, where every AdaGN passes its
# normalized input on (gamma-bias 1) and far more of G's gradients are small
# and nonzero, each free to take a sign-like Adam step that bf16 rounding can
# flip (apart_bound still holds every element)
ZERO1_BF16_OUTSIDE = 1e-3


def adam_ratio_bound(b1: float, b2: float, t: int) -> float:
    """The most |m_hat| / sqrt(v_hat) can be at Adam's step t, whatever the
    gradients: by Cauchy-Schwarz over the two moments' weights w_k and u_k,
    sqrt(sum w_k^2 / u_k)."""
    w = [(1 - b1) * b1 ** (t - k) / (1 - b1 ** t) for k in range(1, t + 1)]
    u = [(1 - b2) * b2 ** (t - k) / (1 - b2 ** t) for k in range(1, t + 1)]
    return math.sqrt(sum(a * a / b for a, b in zip(w, u)))


def apart_bound(cfg, steps: int) -> float:
    """The most two Adam runs' weights can lie apart after `steps` steps from
    one init: each step moves either run by at most lr times the ratio bound
    (eps only shrinks it), and the EMA lies within its weights' spread."""
    return 2 * sum(max(cfg.lr_g * adam_ratio_bound(cfg.beta1_g, cfg.beta2_g, t),
                       cfg.lr_d * adam_ratio_bound(cfg.beta1_d, cfg.beta2_d, t))
                   for t in range(1, steps + 1))


def launch_on_card(fn, args, directory: Path, deadline_s: float, what: str) -> None:
    """`parallel.launch` of `fn(rank, local_rank, args)` on two gloo ranks
    sharing cuda:0 (NCCL refuses two ranks on one device), meeting through a
    `file://` rendezvous in `directory`. A rank that fails, or the deadline,
    kills the other and fails the phase, with the ranks' logs."""
    import datetime

    from ddgan_torch.parallel import launch

    args.num_process_per_node, args.num_proc_node, args.node_rank = 2, 1, 0
    args.what_backend = "gloo"
    try:
        launch(args, fn, init_method=f"file://{directory}/rendezvous", device="cuda:0",
               deadline_s=deadline_s, timeout=datetime.timedelta(seconds=300))
    except RuntimeError as e:
        for log in sorted(directory.rglob("rank*.log")):
            print(f"--- {log.relative_to(directory)}:\n" + log.read_text()[-3000:])
        check(False, f"{what}: {e}")


def rank_log(directory: str, rank: int) -> None:
    """This rank's output, and its traceback if it fails, into rank<r>.log."""
    sys.stdout = sys.stderr = open(Path(directory) / f"rank{rank}.log", "w", buffering=1)


def _gloo_probe_rank(rank: int, local_rank: int, args) -> None:
    """Which of the three flat collectives gloo takes on CUDA tensors."""
    import torch.distributed as dist

    del local_rank
    rank_log(args.directory, rank)
    world = dist.get_world_size()
    dev = torch.device("cuda", 0)
    n = 1 << 20
    x = torch.full((n,), float(rank + 1), device=dev)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return bool((y == 3.0).all())

    def reduce_scatter_tensor():
        y = torch.empty(n // world, device=dev)
        dist.reduce_scatter_tensor(y, x)
        return bool((y == 3.0).all())

    def all_gather_into_tensor():
        y = torch.empty(n * world, device=dev)
        dist.all_gather_into_tensor(y, x)
        return bool((y[:n] == 1.0).all() and (y[n:] == 2.0).all())

    out = {}
    for fn in (all_reduce, reduce_scatter_tensor, all_gather_into_tensor):
        try:
            out[fn.__name__] = "yes" if fn() else "wrong values"
        except Exception as e:  # the probe reports what gloo refuses
            out[fn.__name__] = f"no: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    Path(args.directory, f"gloo_probe_{rank}.json").write_text(json.dumps(out))


def collectives_on_card(n: int, dev: torch.device, tmp: Path) -> dict:
    """Phase 44: an NCCL group of size 1 (left initialised for phase 45)
    runs the three flat collectives on n float32 values, checked and timed
    (CUDA events); then two gloo processes probe them on CUDA tensors."""
    import datetime

    import torch.distributed as dist
    from ddgan_torch.parallel import all_gather_, reduce_scatter_

    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_rendezvous", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))
    x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(44), device=dev)
    y, out = x.clone(), torch.empty_like(x)
    dist.all_reduce(y)
    reduce_scatter_(out, x)
    check(torch.equal(y, x) and torch.equal(out, x), "size-1 NCCL all_reduce / reduce_scatter")
    all_gather_(out, y)
    check(torch.equal(out, x), "size-1 NCCL all_gather_into_tensor")
    res = {"n": n, "bytes": 4 * n, "backend": dist.get_backend()}
    for name, fn in (("all_reduce", lambda _: dist.all_reduce(y)),
                     ("reduce_scatter_tensor", lambda _: reduce_scatter_(out, x)),
                     ("all_gather_into_tensor", lambda _: all_gather_(out, y))):
        ms = device_ms(fn, [None], 20)
        res[name] = {"ms": ms, "GB_per_s": 4 * n / ms / 1e6}
        print(f"NCCL size 1, {name} of {n} float32 ({4 * n / 1e6:.1f} MB): {ms:.4f} ms "
              f"({res[name]['GB_per_s']:.1f} GB/s)")
    probe_dir = tmp / "gloo_probe"
    probe_dir.mkdir()
    launch_on_card(_gloo_probe_rank, types.SimpleNamespace(directory=str(probe_dir)),
                   probe_dir, 180, "gloo probe on CUDA tensors")
    probe = [json.loads((probe_dir / f"gloo_probe_{r}.json").read_text()) for r in range(2)]
    check(probe[0] == probe[1], f"gloo probe: the ranks disagree: {probe}")
    res["gloo_cuda"] = probe[0]
    print(f"gloo, 2 processes, CUDA tensors: {probe[0]}")
    return res


def opt_state_bytes(opt) -> int:
    """The optimizer-state bytes this rank holds (the Adam moments)."""
    if hasattr(opt, "mu"):  # Zero1Adam
        return 4 * (opt.mu.numel() + opt.nu.numel())
    return sum(v.numel() * v.element_size() for st in opt.adam.state.values()
               for k, v in st.items() if k != "step")


def _state_tensors(state) -> list:
    return [t.detach() for t in (*state.gen.parameters(), *state.disc.parameters(),
                                 *state.ema_G.values())]


def _add_calls(a: dict | None, b: dict) -> dict:
    if a is None:
        return b
    return {"fir": {k: {r: a["fir"][k][r] + n for r, n in v.items()} for k, v in b["fir"].items()},
            "pair_conv3x3": {r: a["pair_conv3x3"][r] + n for r, n in b["pair_conv3x3"].items()}}


def _outside(a, b) -> tuple[float, int]:
    """max |a - b| over two states' weights and EMA, and the elements beyond
    PARALLEL_BOUNDS of b."""
    worst, bad = 0.0, 0
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        d = (x - y).abs()
        worst = max(worst, float(d.max()))
        bad += int((d > PARALLEL_BOUNDS["atol"] + PARALLEL_BOUNDS["rtol"] * y.abs()).sum())
    return worst, bad


def group_steps(cfg, dev: torch.device, fir2x, pair_conv, train_paths: dict) -> dict:
    """Phase 45: the flagship (bf16, batch 64, dropout 0.1) from its init for
    four steps (R1 at step 0) without a group, replicated under the size-1
    NCCL group, and ZeRO-1 under it, in lockstep with the same draws;
    deterministic cuDNN algorithms, so that the two replicated runs can be
    equal to the last bit. ZeRO-1 against replicated after each step: within
    PARALLEL_BOUNDS after the first (the same gradients on both) and after
    all four in float32 (TF32 off); in bf16 after the later three, whose
    rounding carries sign-like Adam steps of near-zero gradients apart,
    within `apart_bound` and with at most ZERO1_BF16_OUTSIDE of the
    elements beyond PARALLEL_BOUNDS. Then ms per step of the three bf16 runs
    in turns, and the collectives each adds per step timed alone."""
    import torch.distributed as dist
    from ddgan_torch.diffusion import DiffusionCoefficients, PosteriorCoefficients
    from ddgan_torch.models import NCSNpp, build_discriminator
    from ddgan_torch.parallel import all_gather_, mean_across_ranks_, reduce_scatter_
    from ddgan_torch.train import ClippedAdam, Zero1Adam, create_train_state, make_train_step

    group = dist.group.WORLD
    c32 = cfg.replace(compute_dtype="float32")
    g_sd = NCSNpp.from_config(c32, generator=torch.Generator().manual_seed(45)).state_dict()
    d_sd = build_discriminator(c32, generator=torch.Generator().manual_seed(46)).state_dict()
    real = real_batch(cfg, TRAIN_BATCH, 47).to(dev)
    step = make_train_step(
        DiffusionCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max, device=dev),
        PosteriorCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max, device=dev),
        num_timesteps=cfg.num_timesteps, nz=cfg.nz, r1_gamma=cfg.r1_gamma,
        lazy_reg=cfg.lazy_reg, ema_decay=cfg.ema_decay, use_ema=True)
    modes = {"group-less": (ClippedAdam, None), "replicated": (ClippedAdam, group),
             "zero1": (Zero1Adam, group)}

    def build(c, cls, grp):
        gen, disc = NCSNpp.from_config(c), build_discriminator(c)
        gen.load_state_dict(g_sd)
        disc.load_state_dict(d_sd)
        st = create_train_state(
            gen.to(dev), disc.to(dev),
            cls(gen.parameters(), c.beta1_g, c.beta2_g, c.weight_decay_G, c.grad_clip_norm,
                group=grp),
            cls(disc.parameters(), c.beta1_d, c.beta2_d, c.weight_decay_D, c.grad_clip_norm,
                group=grp), use_ema=True)
        return st, torch.Generator(device=dev).manual_seed(48)

    def lockstep(runs: dict, what: str) -> list:
        calls, out_ = None, []
        for i in range(4):
            for name, (st, rng) in runs.items():
                _reset(fir2x, pair_conv)
                vals = [float(v) for v in step(st, real, rng, cfg.lr_g, cfg.lr_d)]
                sync(dev)
                check(all(np.isfinite(vals)) and (vals[4] > 0) == (i == 0),
                      f"{what} {name} step {i}: {vals}")
                if name == "replicated":
                    calls = _add_calls(calls, _calls(fir2x, pair_conv))
            worst, bad = _outside(runs["zero1"][0], runs["replicated"][0])
            rec = {"zero1_max_abs": worst, "zero1_outside": bad}
            if "group-less" in runs:
                rec["replicated_equals_group_less"] = all(
                    torch.equal(a, b) for a, b in zip(_state_tensors(runs["group-less"][0]),
                                                      _state_tensors(runs["replicated"][0])))
            out_.append(rec)
            print(f"{what} step {i}: {rec}")
        train_paths[f"flagship_nccl_group_{what}_4_steps"] = calls
        return out_

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {"steps": 4}
    try:
        runs = {name: build(cfg, cls, grp) for name, (cls, grp) in modes.items()}
        out["bf16"] = lockstep(runs, "bf16")
        check(all(r["replicated_equals_group_less"] for r in out["bf16"]),
              "replicated under the size-1 NCCL group is not the group-less run bit for bit")
        check(out["bf16"][0]["zero1_outside"] == 0,
              f"ZeRO-1 after the first bf16 step (the same gradients): {out['bf16'][0]}")
        n_elems = sum(t.numel() for t in _state_tensors(runs["replicated"][0]))
        for i, r in enumerate(out["bf16"][1:], start=1):
            r["max_abs_bound"] = apart_bound(cfg, i + 1)
            r["outside_share"] = r["zero1_outside"] / n_elems
            check(r["zero1_max_abs"] <= r["max_abs_bound"]
                  and r["outside_share"] <= ZERO1_BF16_OUTSIDE,
                  f"ZeRO-1 after bf16 step {i}: {r} (of {n_elems} elements; share limit "
                  f"{ZERO1_BF16_OUTSIDE})")
        print(f"bf16 steps 1-3 held within apart_bound and a share of {ZERO1_BF16_OUTSIDE} "
              f"of {n_elems} elements: " + ", ".join(
                  f"{r['zero1_max_abs']:.3g} <= {r['max_abs_bound']:.3g}, "
                  f"{r['outside_share']:.3g}" for r in out["bf16"][1:]))
        runs32 = {name: build(c32, modes[name][0], group) for name in ("replicated", "zero1")}
        out["f32"] = lockstep(runs32, "f32")
        check(all(r["zero1_outside"] == 0 for r in out["f32"]),
              f"ZeRO-1 outside rtol {PARALLEL_BOUNDS['rtol']} atol {PARALLEL_BOUNDS['atol']} "
              f"of replicated in f32: {out['f32']}")
        del runs32
        states = {name: r[0] for name, r in runs.items()}
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # ms per step (R1-free steps), the three modes in turns
    times = {name: [] for name in modes}
    for _ in range(2):
        for name, st in states.items():
            rng = torch.Generator(device=dev).manual_seed(49)
            for _ in range(2):
                st.step = 1
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                step(st, real, rng, cfg.lr_g, cfg.lr_d)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end))
    out["ms_per_step"] = {name: float(np.mean(t[1:])) for name, t in times.items()}
    out["ms_per_step_all"] = times
    # what each mode's collectives cost a step, timed alone (both networks)
    st = states["replicated"]
    grads = {"G": [torch.randn_like(p) for p in st.gen.parameters()],
             "D": [torch.randn_like(p) for p in st.disc.parameters()]}
    out["mean_across_ranks_ms"] = sum(
        device_ms(lambda _, g=g: mean_across_ranks_(g, group), [None], 10) for g in grads.values())
    zero1_ms = 0.0
    for opt in (states["zero1"].opt_G, states["zero1"].opt_D):
        flat = torch.randn(opt.world * opt.shard, device=dev)
        shard, full, sq = (torch.empty(opt.shard, device=dev),
                           torch.empty(opt.world * opt.shard, device=dev),
                           torch.ones((), device=dev))

        def collectives(_, flat=flat, shard=shard, full=full, sq=sq):
            reduce_scatter_(shard, flat, group)
            dist.all_reduce(sq, group=group)
            all_gather_(full, shard, group)

        zero1_ms += device_ms(collectives, [None], 10)
    out["zero1_collectives_ms"] = zero1_ms
    out["optimizer_bytes"] = {name: opt_state_bytes(s_.opt_G) + opt_state_bytes(s_.opt_D)
                              for name, s_ in states.items()}
    print("ms per flagship bf16 step (R1-free, batch 64), three modes in turns: "
          + ", ".join(f"{k} {v:.3f}" for k, v in out["ms_per_step"].items())
          + f"; alone, per step: the replicated gradient means {out['mean_across_ranks_ms']:.3f} "
          f"ms, the ZeRO-1 collectives {zero1_ms:.3f} ms; optimizer bytes "
          f"{out['optimizer_bytes']}")
    return out


def _rank_train(rank: int, local_rank: int, args) -> None:
    """One rank of phase 46: each run of `args.runs` in turn, all in one
    process group, so the ranks start and join it once."""
    for run in args.runs:
        _rank_train_run(rank, local_rank, run)


def _rank_train_run(rank: int, local_rank: int, args) -> None:
    """One rank's run of phase 46: `loop.train` on the rank's device (cuda:0
    for both ranks), in the run directory, with its first step's weights
    written and its launches counted."""
    from ddgan_torch.data import SyntheticDataset
    from ddgan_torch.ops import fir2x, pair_conv
    from ddgan_torch.parallel import rank_device
    from ddgan_torch.train import loop

    rank_log(args.smoke_dir, rank)
    dev = rank_device(local_rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    directory = Path(args.smoke_dir)
    os.chdir(directory)
    make = loop.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def rec(state, *sa, **skw):
            m = step(state, *sa, **skw)
            if state.step == 1:
                torch.save({"params_G": {k: v.detach().cpu() for k, v in
                                         state.gen.named_parameters()},
                            "params_D": {k: v.detach().cpu() for k, v in
                                         state.disc.named_parameters()},
                            "ema": {k: v.cpu() for k, v in state.ema_G.items()}},
                           directory / f"step1_rank{rank}.pt")
            return m
        return rec

    loop.make_train_step = recording
    _reset(fir2x, pair_conv)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        state = loop.train(args, dataset=SyntheticDataset(
            n=2 * args.batch_size * args.limited_iter, image_size=args.image_size,
            num_channels=args.num_channels, seed=args.seed), device=dev)
    finally:
        loop.make_train_step = make  # the next run records into its own directory
    sync(dev)
    digest = 0
    for t in _state_tensors(state):
        digest = zlib.crc32(t.detach().cpu().numpy().tobytes(), digest)
    (directory / f"rank{rank}.json").write_text(json.dumps({
        "s": time.perf_counter() - t0,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else math.nan,
        "calls": _calls(fir2x, pair_conv), "launches": dict(fir2x.LAUNCHES),
        "crc32": digest, "step": state.step, "epoch": state.epoch,
        "optimizer_bytes": opt_state_bytes(state.opt_G) + opt_state_bytes(state.opt_D)}))


def run_two_ranks(runs: list, directory: Path) -> list:
    """`loop.train` of each (config, run directory) of `runs` in turn on two
    gloo ranks sharing cuda:0, in one launch; each run's rank records."""
    args = types.SimpleNamespace(runs=[])
    for cfg, run_dir in runs:
        run_dir.mkdir(parents=True)
        run = copy.copy(cfg)
        run.smoke_dir = str(run_dir)
        args.runs.append(run)
    launch_on_card(_rank_train, args, directory, 600,
                   "two ranks (" + ", ".join(c.optimizer_sharding for c, _ in runs) + ")")
    return [[json.loads((d / f"rank{r}.json").read_text()) for r in range(2)] for _, d in runs]


def check_adagn_init(gen) -> None:
    """Every AdaGN of a freshly built G starts with gamma-bias 1 and beta-bias
    0, as the JAX package's `style_bias_init` sets them."""
    from ddgan_torch.nn import AdaptiveGroupNorm

    norms = [m for m in gen.modules() if isinstance(m, AdaptiveGroupNorm)]
    bad = [i for i, m in enumerate(norms)
           if not (bool((m.style.bias[:m.channels] == 1).all())
                   and bool((m.style.bias[m.channels:] == 0).all()))]
    check(norms and not bad, f"AdaGN style bias not [1]*C + [0]*C at {bad} of {len(norms)}")
    print(f"the loop's G: {len(norms)} AdaGN, each style bias [1]*C + [0]*C")


def emulate_first_step(cfg, dev: torch.device, want: dict) -> dict:
    """The two ranks' first step in this process: each shard's D loss
    backpropagated at half weight into one gradient (the mean of the two,
    as the all-reduce gives it), Adam, then the same for G against the
    updated D, then the EMA; each shard with its rank's batch and generator,
    as the loop builds them. Compared with rank 0's weights after its step."""
    import torch.nn.functional as F_
    from ddgan_torch.data import SyntheticDataset
    from ddgan_torch.diffusion import (DiffusionCoefficients, PosteriorCoefficients,
                                       q_sample_pairs_with_noise, sample_posterior_with_noise)
    from ddgan_torch.train import build_adam_state, build_models, cosine_lr, draw_step, ema_update
    from ddgan_torch.train import loop

    init_rng = torch.Generator().manual_seed(int(cfg.seed))
    gen, disc = build_models(cfg, init_rng)
    check_adagn_init(gen)
    data_seed = int(torch.randint(2**62, (1,), generator=init_rng))
    gen, disc = gen.to(dev), disc.to(dev)
    state = build_adam_state(cfg, gen, disc)
    rngs = [torch.Generator(device=dev).manual_seed(data_seed + r) for r in range(2)]
    ds = SyntheticDataset(n=2 * cfg.batch_size * cfg.limited_iter, image_size=cfg.image_size,
                          num_channels=cfg.num_channels, seed=cfg.seed)
    reals = []
    for r in range(2):
        loader = loop.build_loader(cfg, ds, cfg.batch_size, 2, r)
        loader.set_epoch(0)
        reals.append(loop._to_device(next(iter(loader))[0], dev))
    coeff = DiffusionCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max,
                                         device=dev)
    pos = PosteriorCoefficients.create(cfg.num_timesteps, cfg.beta_min, cfg.beta_max, device=dev)

    def apply_D(x, t, x_t):
        return disc(x, t, x_t).reshape(-1).float()

    gen.train()
    disc.train()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        draws = []
        state.opt_D.zero_grad()
        for real, rng in zip(reals, rngs):  # D: step 0, R1 on, recomputed at 32²
            gen.set_dropout_generator(rng)
            d = draw_step(real, cfg.num_timesteps, cfg.nz, rng)
            draws.append(d)
            x_t, x_tp1 = q_sample_pairs_with_noise(coeff, real, d.t, d.noise_q, d.noise_next)
            with torch.no_grad():
                x_pos = sample_posterior_with_noise(pos, gen(x_tp1, d.t, d.z), x_tp1, d.t,
                                                    d.noise_post)
            errD_fake = F_.softplus(apply_D(x_pos, d.t, x_tp1)).mean()
            errD_real = F_.softplus(-apply_D(x_t, d.t, x_tp1)).mean()
            x_in = x_t.detach().requires_grad_(True)
            (grad_real,) = torch.autograd.grad(apply_D(x_in, d.t, x_tp1).sum(), x_in,
                                               create_graph=True)
            penalty = cfg.r1_gamma / 2.0 * grad_real.float().reshape(
                real.shape[0], -1).square().sum(1).mean()
            ((errD_real + errD_fake + penalty) * 0.5).backward(inputs=list(disc.parameters()))
        state.opt_D.step(cosine_lr(cfg.lr_d, 0, cfg.num_epoch))
        state.opt_G.zero_grad()
        for real, rng, d in zip(reals, rngs, draws):
            gen.set_dropout_generator(rng)
            _, x_tp1_g = q_sample_pairs_with_noise(coeff, real, d.t_g, d.noise_q_g,
                                                   d.noise_next_g)
            x_pos_g = sample_posterior_with_noise(pos, gen(x_tp1_g, d.t_g, d.z_g), x_tp1_g,
                                                  d.t_g, d.noise_post_g)
            errG = F_.softplus(-apply_D(x_pos_g, d.t_g, x_tp1_g)).mean()
            (errG * 0.5).backward(inputs=list(gen.parameters()))
        state.opt_G.step(cosine_lr(cfg.lr_g, 0, cfg.num_epoch))
        ema_update(state.ema_G, gen, cfg.ema_decay)
        sync(dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return step_outside({"params_G": dict(gen.named_parameters()),
                         "params_D": dict(disc.named_parameters()), "ema": state.ema_G}, want)


def step_outside(got: dict, want: dict) -> dict:
    """Two records of a step's weights and EMA ({"params_G": {name: tensor},
    ...}): max |got - want|, the elements beyond PARALLEL_BOUNDS of want,
    and whether they are equal to the last bit."""
    worst, bad, exact = 0.0, 0, True
    for key, tensors in got.items():
        for k, v in tensors.items():
            v = v.detach()
            w = want[key][k].to(v.device)
            d_ = (v - w).abs()
            worst = max(worst, float(d_.max()))
            bad += int((d_ > PARALLEL_BOUNDS["atol"] + PARALLEL_BOUNDS["rtol"] * w.abs()).sum())
            exact = exact and torch.equal(v, w)
    return {"max_abs": worst, "outside": bad, "bit_exact": exact}


def two_ranks_on_card(cfg, dev: torch.device, fir2x, pair_conv, gloo_cuda: dict,
                      sampler_launches: dict, train_paths: dict) -> dict:
    """Phase 46: two ranks over gloo sharing cuda:0 (NCCL refuses two ranks
    on one device) through `init_processes` and `loop.train`: the flagship
    at full width, batch 64 per rank, one epoch of PARALLEL_ITERS steps."""
    from ddgan_torch.data import SyntheticDataset
    from ddgan_torch.train import loop

    run_cfg = cfg.replace(dataset="synthetic", exp="two_ranks", batch_size=TRAIN_BATCH,
                          limited_iter=PARALLEL_ITERS, num_epoch=0, save_ckpt_every=1,
                          what_backend="gloo", num_workers=0)
    tmp = Path(tempfile.mkdtemp(prefix="two_ranks_"))
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    out = {}
    zero1 = gloo_cuda["reduce_scatter_tensor"] == gloo_cuda["all_gather_into_tensor"] == "yes"
    runs = [(run_cfg, tmp / "replicated")] + (
        [(run_cfg.replace(exp="two_ranks_zero1", optimizer_sharding="zero1"), tmp / "zero1")]
        if zero1 else [])
    ranks, *z = run_two_ranks(runs, tmp)
    steps = range(PARALLEL_ITERS)
    want = expected_run_calls(steps, cfg.lazy_reg, 3, len(cfg.ch_mult) - 1, shared=False)
    for r, rec in enumerate(ranks):
        check(rec["calls"]["fir"] == want and rec["step"] == len(steps) and rec["epoch"] == 1,
              f"rank {r}: FIR calls {rec['calls']['fir']}, step {rec['step']}, expected {want}")
        train_paths[f"two_ranks_rank{r}"] = rec["calls"]
    check(ranks[0]["crc32"] == ranks[1]["crc32"], "the two ranks' weights and EMA differ")
    emulated = emulate_first_step(run_cfg, dev, torch.load(
        tmp / "replicated" / "step1_rank0.pt", weights_only=False))
    check(emulated["outside"] == 0, f"step 1 against the emulation: {emulated}")
    epochs = [line for line in (tmp / "replicated" / "rank0.log").read_text().splitlines()
              if line.startswith("[epoch")]
    out["replicated"] = {"ranks": ranks, "emulated_first_step": emulated, "epoch_lines": epochs}
    print(f"two ranks (gloo, cuda:0, batch {TRAIN_BATCH} each): weights equal across ranks; "
          f"step 1 against the one-process emulation: {emulated}; per rank: "
          + "; ".join(f"{rec['s']:.1f} s, peak {rec['peak_gb']:.2f} GB, optimizer bytes "
                      f"{rec['optimizer_bytes']}" for rec in ranks))
    print("\n".join(epochs))

    # rank 0's content.pth resumes in one process; its netG samples
    cwd = os.getcwd()
    os.chdir(tmp / "replicated")
    try:
        ds = SyntheticDataset(n=2 * TRAIN_BATCH * PARALLEL_ITERS, image_size=cfg.image_size,
                              num_channels=cfg.num_channels, seed=cfg.seed)
        resumed_cfg = run_cfg.replace(num_epoch=1, resume=True)
        st = loop.train(resumed_cfg, dataset=ds, device=dev)
        check(st.epoch == 2 and st.step == 2 * PARALLEL_ITERS,
              f"resumed in one process: epoch {st.epoch}, step {st.step}")
        del st
        out["resumed_pngs"] = sample_from_loop(resumed_cfg, tmp / "replicated", fir2x,
                                               pair_conv, sampler_launches)
    finally:
        os.chdir(cwd)

    if zero1:  # run in the same launch, after replicated
        z = z[0]
        check(z[0]["crc32"] == z[1]["crc32"] and all(r_["step"] == len(steps) for r_ in z),
              "ZeRO-1 on two ranks: the ranks' weights differ")
        against = step_outside(*(torch.load(tmp / mode / "step1_rank0.pt", weights_only=False)
                                 for mode in ("zero1", "replicated")))
        check(against["outside"] == 0,
              f"ZeRO-1's step 1 on two ranks against replicated's: {against}")
        out["zero1"] = {"ranks": z, "step1_against_replicated": against}
        print(f"ZeRO-1 on two ranks: weights equal across ranks; step 1 against replicated's: "
              f"{against}; per rank: "
              + "; ".join(f"{rec['s']:.1f} s, peak {rec['peak_gb']:.2f} GB, optimizer bytes "
                          f"{rec['optimizer_bytes']}" for rec in z))
    else:
        out["zero1"] = "held on the CPU only: gloo does not take its collectives on CUDA tensors"
        print(f"ZeRO-1 on two ranks: {out['zero1']} ({gloo_cuda})")
    return out


# ---------------------------------------------------------------------------
# image files and LUNA16 volumes (phases 47-49)
JPEG_SIZES = [(1, 1), (7, 9), (17, 33), (255, 257)]  # (H, W): 1 pixel, and not multiples of the MCU
JPEG_QUALITIES = [50, 75, 95, 100]
JPEG_LAYOUTS = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "L": None}  # PIL's subsampling, or grey
# ms of the decoders and resizers: the port's and PIL's calls in turns, this many each
HOST_TIMING_CALLS = 10
CUSTOM_IMAGES = 64  # the 256² recipe's `custom` set: 320 x 288 JPEGs at q95
CUSTOM_W, CUSTOM_H = 320, 288
CUSTOM_ITERS = 2  # steps an epoch (batch 4): epochs 0 and 1, R1 at step 0
LUNA_SIDE = 256  # LUNA16 volumes are 256³ (Luna16Dataset.DATA_SHAPE)
LUNA_NODULE_Z = [(100, 120), (60, 84), (150, 178)]  # each mask's z extent: 72 slices at bound 0
LUNA_ITERS = 2  # steps an epoch (batch 16): epochs 0 and 1, R1 at step 0
TOY_PALETTE = np.array([[0.95, 0.35, 0.25], [0.30, 0.75, 0.95], [0.45, 0.90, 0.40],
                        [0.95, 0.85, 0.30]], np.float32)  # tools/quality_e2e.py:43-51


def smooth_field(rs, h: int, w: int, channels: int) -> np.ndarray:
    """A seeded (h, w, channels) uint8 image: a smooth field per channel plus
    noise, so a JPEG coder meets flat blocks and busy ones."""
    yy, xx = np.mgrid[0:h, 0:w]
    planes = []
    for _ in range(channels):
        a, b, phase_ = rs.uniform(0.02, 0.25, 3)
        planes.append(127 + 90 * np.sin(a * xx + phase_) * np.cos(b * yy)
                      + rs.normal(0, 14, (h, w)))
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def pil_jpeg(Image, rs, h: int, w: int, layout: str, **save) -> bytes:
    """A smooth field written by PIL as a JPEG of `layout` (JPEG_LAYOUTS)."""
    arr = smooth_field(rs, h, w, 1 if layout == "L" else 3)
    im = Image.fromarray(arr[:, :, 0] if layout == "L" else arr)
    if layout != "L":
        save["subsampling"] = JPEG_LAYOUTS[layout]
    buf = io.BytesIO()
    im.save(buf, "JPEG", **save)
    return buf.getvalue()


def jpeg_cases(Image) -> list:
    """(label, bytes) of every JPEG the decoder is held to: each size x
    quality x layout, then each layout with optimized Huffman tables and
    with restart markers every MCU and every MCU row."""
    rs = np.random.RandomState(47)
    cases = [(f"{h}x{w} q{q} {layout}", pil_jpeg(Image, rs, h, w, layout, quality=q))
             for h, w in JPEG_SIZES for q in JPEG_QUALITIES for layout in JPEG_LAYOUTS]
    for layout in JPEG_LAYOUTS:
        for name, save in (("optimize", dict(optimize=True)),
                           ("restart every MCU", dict(restart_marker_blocks=1)),
                           ("restart every MCU row", dict(restart_marker_rows=1))):
            cases.append((f"37x45 q85 {layout} {name}",
                          pil_jpeg(Image, rs, 37, 45, layout, quality=85, **save)))
    return cases


def host_ms_in_turns(fns: dict, calls: int = HOST_TIMING_CALLS) -> dict:
    """ms per call of each host function, measured in turns (a, b, b, a) of
    `calls` calls each after one warm-up call, the two turns' means."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            t0 = time.perf_counter()
            for _ in range(calls):
                fns[k]()
            times[k].append(1e3 * (time.perf_counter() - t0) / calls)
    return {k: float(np.mean(v)) for k, v in times.items()}


def jpeg_against_pil(Image) -> dict:
    """The port's JPEG decoder against PIL on this host: every file of
    `jpeg_cases` bit for bit (no case has a bound), and a progressive file
    (refused before the decoder read them, now decoded as PIL decodes it);
    the ms per 256² q95 4:2:0 image of each."""
    from ddgan_torch.data.jpeg import decode_jpeg

    cases = jpeg_cases(Image)
    bad = []
    for label, data in cases:
        want = np.asarray(Image.open(io.BytesIO(data)))
        got = decode_jpeg(data)
        if got.shape != want.shape or not np.array_equal(got, want):
            bad.append(label)
    check(not bad, f"JPEG decoder differs from PIL on {len(bad)} of {len(cases)} files: {bad}")
    buf = io.BytesIO()
    Image.fromarray(smooth_field(np.random.RandomState(0), 32, 32, 3)).save(
        buf, "JPEG", quality=80, progressive=True)
    progressive = decode_jpeg(buf.getvalue())
    check(np.array_equal(progressive, np.asarray(Image.open(io.BytesIO(buf.getvalue())))),
          "a progressive JPEG decodes unlike PIL")
    data = pil_jpeg(Image, np.random.RandomState(48), 256, 256, "4:2:0", quality=95)
    ms = host_ms_in_turns({"port": lambda: decode_jpeg(data),
                           "pil": lambda: np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))})
    print(f"JPEG decoder: {len(cases)} PIL files bit for bit ({len(JPEG_SIZES)} sizes x "
          f"{len(JPEG_QUALITIES)} qualities x {len(JPEG_LAYOUTS)} layouts, and optimized tables "
          f"and restart markers in each layout); a progressive file as PIL; 256² q95 4:2:0 "
          f"{ms['port']:.3f} ms an image (port), {ms['pil']:.3f} ms (PIL), on this host")
    return {"files": len(cases), "exact": len(cases), "ms_256_q95_420": ms}


def resize_against_pil(Image) -> dict:
    """The port's resize against PIL on this host, both filters on "L" and
    "RGB" images, shrinking and enlarging, bit for bit; `Luna16Dataset2`'s
    crop and bicubic on slices of three sizes; the ms of a 256²->64² bicubic
    ("L") and a 320x288->284x256 bilinear ("RGB"), the port's and PIL's."""
    from ddgan_torch.data import resize as rz
    from ddgan_torch.data.datasets import Luna16Dataset2, crop

    pil_filter = {rz.BILINEAR: Image.BILINEAR, rz.BICUBIC: Image.BICUBIC}
    rs = np.random.RandomState(49)
    shapes = [(1, 1), (5, 7), (64, 64), (140, 180), (256, 256), (288, 320), (300, 17)]
    sizes = [(1, 1), (64, 64), (284, 256), (300, 3), (7, 300), (33, 47)]  # (W, H)
    n, bad = 0, []
    for h, w in shapes:
        for rgb in (False, True):
            img = smooth_field(rs, h, w, 3 if rgb else 1)
            img = img if rgb else img[:, :, 0]
            for size in sizes:
                for name, f in pil_filter.items():
                    want = np.asarray(Image.fromarray(img).resize(size, f))
                    got = rz.resize(img, size, name)
                    n += 1
                    if got.shape != want.shape or not np.array_equal(got, want):
                        bad.append(f"{h}x{w} {'RGB' if rgb else 'L'} -> {size} {name}")
    for h, w in ((256, 256), (230, 210), (64, 70)):
        img = smooth_field(rs, h, w, 1)[:, :, 0]
        want = np.asarray(Image.fromarray(img).crop(Luna16Dataset2.CROP_BOX).resize((64, 64)))
        got = rz.resize(crop(img, Luna16Dataset2.CROP_BOX), (64, 64), rz.BICUBIC)
        n += 1
        if not np.array_equal(got, want):
            bad.append(f"Luna16Dataset2 crop and resize of {h}x{w}")
    check(not bad, f"resize differs from PIL in {len(bad)} of {n} cases: {bad}")
    grey = smooth_field(rs, 256, 256, 1)[:, :, 0]
    rgb = smooth_field(rs, CUSTOM_H, CUSTOM_W, 3)
    ms = {"bicubic_256_to_64_L": host_ms_in_turns({
              "port": lambda: rz.resize(grey, (64, 64), rz.BICUBIC),
              "pil": lambda: np.asarray(Image.fromarray(grey).resize((64, 64), Image.BICUBIC))}),
          "bilinear_320x288_to_284x256_RGB": host_ms_in_turns({
              "port": lambda: rz.resize(rgb, (284, 256), rz.BILINEAR),
              "pil": lambda: np.asarray(Image.fromarray(rgb).resize((284, 256), Image.BILINEAR))})}
    print(f"resize: {n} cases bit for bit against PIL (bilinear and bicubic, L and RGB, "
          f"shrinking and enlarging, Luna16Dataset2's crop); on this host, ms port / PIL: "
          + "; ".join(f"{k} {v['port']:.3f} / {v['pil']:.3f}" for k, v in ms.items()))
    return {"cases": n, "exact": n, "ms": ms}


def toy_image_wh(rng, w: int, h: int) -> np.ndarray:
    """`tools/quality_e2e.py:toy_image` at w x h: a tilted background and
    one or two coloured blobs, in [0, 1]."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / (h - 1), xx / (w - 1)
    base = rng.uniform(0.05, 0.25, size=3).astype(np.float32)
    tilt = rng.uniform(-0.15, 0.15, size=3).astype(np.float32)
    img = base[None, None, :] + yy[:, :, None] * tilt[None, None, :]
    for _ in range(rng.randint(1, 3)):
        color = TOY_PALETTE[rng.randint(len(TOY_PALETTE))] * rng.uniform(0.8, 1.0)
        cy, cx = rng.uniform(0.25, 0.75, size=2)
        rad = rng.uniform(0.10, 0.22)
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * rad ** 2)))
        img = img + blob[:, :, None] * color[None, None, :]
    return np.clip(img, 0.0, 1.0)


# phase 48's JPEG codings: (coding, files of CUSTOM_IMAGES)
CUSTOM_KINDS = {"baseline": 24, "progressive": 16, "arithmetic": 8, "arithmetic progressive": 8,
                "4:4:0": 4, "h4v1": 4}
CUSTOM_SAMPLINGS = {"4:4:0": [(1, 2), (1, 1), (1, 1)], "h4v1": [(4, 1), (1, 1), (1, 1)]}


def write_custom_jpegs(Image, data_dir: Path, n: int, w: int, h: int, seed: int,
                       kinds: list | None = None) -> float:
    """`custom`'s layout, data_dir/train/imgs/*.jpg: n seeded toy images at
    w x h written at q95 as `tools/quality_soak256.py:61` writes them, file
    i in the coding kinds[i] (baseline if None: PIL's; progressive: PIL's
    scan script; arithmetic, sequential or progressive: PIL's baseline file
    re-encoded by the tests' `_torch_jpeg_arith`; 4:4:0 or h4v1, true
    4:1:1: coded at those samplings by the tests' `_torch_imagewriters`
    with PIL's q95 tables, as PIL cannot write them). Returns the seconds
    it took."""
    arith = tests_helper("_torch_jpeg_arith") if kinds else None
    writers = tests_helper("_torch_imagewriters") if kinds else None
    tables = writers.jpeg_tables(Image, 95) if kinds else None
    t0 = time.perf_counter()
    folder = data_dir / "train" / "imgs"
    folder.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        rng = np.random.RandomState(seed * 7_000_003 + i)
        arr = (toy_image_wh(rng, w, h) * 255).astype(np.uint8)
        kind = kinds[i] if kinds else "baseline"
        if kind in CUSTOM_SAMPLINGS:
            data = writers.jpeg_encode(arr, CUSTOM_SAMPLINGS[kind], tables)
            (folder / f"img_{i:05d}.jpg").write_bytes(data)
            continue
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=95, progressive=kind == "progressive")
        data = buf.getvalue()
        if kind.startswith("arithmetic"):
            data = arith.to_arithmetic(data, progressive=kind.endswith("progressive"))
        (folder / f"img_{i:05d}.jpg").write_bytes(data)
    return time.perf_counter() - t0


def custom_kinds(first: list, n: int, seed: int) -> list:
    """The coding of each of n files: CUSTOM_KINDS' counts, one of each
    kind at the indices `first` (the loader's batch 0), the rest drawn."""
    kinds = [k for k, c in CUSTOM_KINDS.items() for _ in range(c)]
    check(len(kinds) == n and len(first) >= len(CUSTOM_KINDS),
          f"{len(kinds)} codings for {n} files, batch 0 of {len(first)}")
    out = [None] * n
    order = list(CUSTOM_KINDS)
    for i, kind in zip(first, order):
        out[i] = kind
        kinds.remove(kind)
    rest = [i for i in range(n) if out[i] is None]
    for i, kind in zip(rest, np.random.RandomState(seed).permutation(kinds)):
        out[i] = str(kind)
    return out


def pil_reference_items(Image, files, size: int) -> np.ndarray:
    """The JAX package's item of each file with do_resize, ToTensor,
    Normalize(0.5, 0.5) and CenterCrop (`ddgan_tpu/data/transforms.py`:
    Resize :27-39, ToTensor :42-51, Normalize :54-60, CenterCrop :63-85,
    copied here), on PIL's decode: (N, size, size, 3) float32."""
    out = []
    for f in files:
        img = Image.open(f).convert("RGB")
        w, h = img.size
        if w <= h:
            new_w, new_h = size, max(1, round(h * size / w))
        else:
            new_w, new_h = max(1, round(w * size / h)), size
        x = np.asarray(img.resize((new_w, new_h), Image.BILINEAR)).astype(np.float32) / 255.0
        mean = std = np.asarray((0.5,) * 3, np.float32)
        x = (x - mean.reshape(1, 1, -1)) / std.reshape(1, 1, -1)
        top, left = (x.shape[0] - size) // 2, (x.shape[1] - size) // 2
        out.append(x[top:top + size, left:left + size])
    return np.stack(out)


def loader_seconds(loader, epoch: int, n: int) -> tuple[list, list]:
    """Seconds of each of the first `n` batches of `epoch` from `loader`
    (the loop's own loader class), and those batches' images."""
    loader.set_epoch(epoch)
    it = iter(loader)
    times, images = [], []
    try:
        for _ in range(n):
            t0 = time.perf_counter()
            images.append(next(it)[0])
            times.append(time.perf_counter() - t0)
    finally:
        it.close()
    return times, images


def custom_run(Image, cfg2, bare: dict, fir2x, pair_conv, sample_launches: dict) -> dict:
    """The CelebA-HQ 256 recipe on `custom` through `main_cli` (phase 28's
    run and checks, with --data_dir): 64 seeded 320 x 288 JPEGs (24
    baseline, 16 progressive, 8 arithmetic-coded sequential and 8
    progressive, 4 at 4:4:0 and 4 at h4v1, batches 0 and 1 holding one of
    each: a set that covers the codings, not a mix users are known to
    send), do_resize (284 x 256), ToTensor, Normalize and CenterCrop
    (256²); then the loop's loader alone: batches 0 and 1 of epoch 0
    against the same files decoded by PIL through the JAX package's
    transform arithmetic (<= 1e-6), and seconds
    per batch over an epoch, on that set and on the same 64 images all
    baseline (the files PIL and cameras write most)."""
    from ddgan_torch.data import make_dataset
    from ddgan_torch.train.loop import build_loader

    with tempfile.TemporaryDirectory() as data_tmp:
        data = Path(data_tmp) / "custom"
        cfg = cfg2.replace(dataset="custom", data_dir=str(data), mode="train", do_resize="yes",
                           to_tensor_transform="yes", use_normalize="yes", CenterCrop="yes",
                           exp="celeba256_custom", batch_size=TRAIN_BATCH_256,
                           limited_iter=CUSTOM_ITERS, num_epoch=1, save_ckpt_every=1)
        # batches 0 and 1's indices depend on the file count only: draw the
        # codings so that they hold one file of each
        write_custom_jpegs(Image, data, CUSTOM_IMAGES, 8, 8, seed=48)
        probe = build_loader(cfg, make_dataset(cfg), cfg.batch_size)
        probe.set_epoch(0)
        kinds = custom_kinds([int(i) for i in probe._indices()[:2 * cfg.batch_size]],
                             CUSTOM_IMAGES, seed=48)
        write_s = write_custom_jpegs(Image, data, CUSTOM_IMAGES, CUSTOM_W, CUSTOM_H, seed=48,
                                     kinds=kinds)
        run = loop_through_main_cli(cfg, bare, fir2x, pair_conv,
                                    k2_per_step={"forward": 46, "dx": 18, "dx_library": 5},
                                    sample_launches=sample_launches,
                                    extra_argv=("--data_dir", str(data)))
        ds = make_dataset(cfg)
        loader = build_loader(cfg, ds, cfg.batch_size)
        loader.set_epoch(0)
        first = [ds.images_all[i] for i in loader._indices()[:2 * cfg.batch_size]]
        first_kinds = [kinds[int(i)] for i in loader._indices()[:2 * cfg.batch_size]]
        check(set(first_kinds) == set(CUSTOM_KINDS), f"batches 0 and 1 hold {first_kinds}")
        times, images = loader_seconds(loader, 0, len(loader))
        base = Path(data_tmp) / "baseline"
        write_custom_jpegs(Image, base, CUSTOM_IMAGES, CUSTOM_W, CUSTOM_H, seed=48)
        base_cfg = cfg.replace(data_dir=str(base))
        base_times, _ = loader_seconds(build_loader(base_cfg, make_dataset(base_cfg),
                                                    cfg.batch_size), 0, len(loader))
        want = pil_reference_items(Image, first, cfg.image_size)
        got = np.concatenate(images[:2])
        err = float(np.abs(got - want).max())
        check(got.shape == (2 * cfg.batch_size, cfg.image_size, cfg.image_size, 3)
              and err <= 1e-6,
              f"custom batches 0-1 {got.shape} against PIL and the JAX transforms: {err}")
    s_per_batch, base_s = float(np.mean(times)), float(np.mean(base_times))
    bare_ms = run["bare_after"]["plain_step"]
    print(f"custom at 256²: {CUSTOM_IMAGES} JPEGs ({CUSTOM_KINDS}) written in {write_s:.2f} s; "
          f"batches 0-1 ({first_kinds}) against "
          f"PIL + the JAX transforms max-abs {err!r}; loader (decode, resize to 284x256, "
          f"ToTensor, Normalize, crop; {len(times)} batches of {cfg.batch_size}, one thread) "
          f"beside the bare bf16 step {bare_ms:.1f} ms: all baseline {1e3 * base_s:.1f} ms a "
          f"batch ({100 * 1e3 * base_s / bare_ms:.1f}% of it), the coverage set "
          f"{1e3 * s_per_batch:.1f} ms ({100 * 1e3 * s_per_batch / bare_ms:.1f}%)")
    return {**run, "jpeg_write_s": write_s, "batch0_max_abs": err, "batch0_kinds": first_kinds,
            "kinds": {k: kinds.count(k) for k in CUSTOM_KINDS},
            "loader_s_per_batch": s_per_batch, "loader_batch_s": times,
            "loader_share_of_bare_step": 1e3 * s_per_batch / bare_ms,
            "baseline_loader_s_per_batch": base_s,
            "baseline_loader_share_of_bare_step": 1e3 * base_s / bare_ms}


def write_luna_volumes(write_nifti, data_dir: Path, mask_dir: Path, side: int, nodule_z,
                       seed: int) -> float:
    """One seeded side³ int16 CT volume per entry of `nodule_z` (values
    -1024..3071: 16³ blocks plus noise) and its mask, a box of ones over
    that z extent; written by the port's `write_nifti`. Returns the seconds."""
    t0 = time.perf_counter()
    data_dir.mkdir()
    mask_dir.mkdir()
    rs = np.random.RandomState(seed)
    for i, (z0, z1) in enumerate(nodule_z):
        coarse = rs.randint(-1000, 3048, (side // 16,) * 3).astype(np.int16)
        vol = coarse.repeat(16, 0).repeat(16, 1).repeat(16, 2)
        vol += rs.randint(-24, 24, vol.shape).astype(np.int16)
        write_nifti(data_dir / f"case{i}.nii.gz", vol)
        mask = np.zeros((side,) * 3, np.uint8)
        c = side // 2
        mask[c - 12:c + 12, c - 10:c + 10, z0:z1] = 1
        write_nifti(mask_dir / f"case{i}.nii.gz", mask)
    return time.perf_counter() - t0


def luna16_run(Image, fir2x, pair_conv) -> dict:
    """The shipped configs/config.json (luna16, 64², 1 channel, nf 128,
    batch 16, T=1) through `main_cli` at its own widths, on three seeded
    256³ int16 volumes: the slices-info file scanned from the masks, the
    run and checks of phase 28 (epochs 0 and 1 of 2 steps) and the sampler
    CLI. Its 256² slices need do_resize 'yes' (Resize(64), PIL's bilinear):
    a generator built for 64² does not run at 256² in either package.
    Then the loop's loader alone, with the cache of decoded volumes and
    without it (the same batches); and nii_to_png with
    do_resize_to (64, 64) over the slices-info file against PIL's bicubic
    of the same slices."""
    from ddgan_torch.config import Config
    from ddgan_torch.data import (Luna16Dataset, load_slice_info, make_dataset, read_nifti,
                                  save_slice_info, slicecache, write_nifti)
    from ddgan_torch.data.converters import nii_to_png
    from ddgan_torch.train.loop import build_loader

    shipped = json.loads((ROOT / "configs" / "config.json").read_text())
    with tempfile.TemporaryDirectory() as data_tmp:
        data_tmp = Path(data_tmp)
        data_dir, mask_dir = data_tmp / "Ones", data_tmp / "processed_masks"
        write_s = write_luna_volumes(write_nifti, data_dir, mask_dir, LUNA_SIDE, LUNA_NODULE_Z,
                                     seed=49)
        cwd = os.getcwd()
        os.chdir(data_tmp)  # the scan writes ./slices_info.txt
        try:
            t0 = time.perf_counter()
            scanned = Luna16Dataset(str(data_dir), str(mask_dir),
                                    bound_exp_lim=int(shipped["bound_expand_limit"]),
                                    single_axis=True, _where=shipped["axis_for_limit"])
            scan_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        info = data_tmp / "SlicesInfoZ.txt"
        save_slice_info(scanned.slice_info, str(info))
        want_slices = sum(z1 - z0 for z0, z1 in LUNA_NODULE_Z)
        check(len(scanned.slice_info) == want_slices, f"{len(scanned.slice_info)} slices scanned")
        cfg = Config.from_dict({**shipped, "data_dir": str(data_dir), "mask_dir": str(mask_dir),
                                "path_to_slices_info": str(info), "do_resize": "yes",
                                "exp": "luna16_shipped", "limited_iter": LUNA_ITERS,
                                "num_epoch": 1, "save_ckpt_every": 1})
        per_call = {k: v * cfg.num_timesteps
                    for k, v in expected_g_fir(len(cfg.ch_mult) - 1).items()}
        run = loop_through_main_cli(cfg, None, fir2x, pair_conv, None,
                                    {**per_call, "pair_conv3x3": 0},
                                    extra_argv=("--data_dir", str(data_dir),
                                                "--limited_slices", "True"))
        # the loader alone, with the cache and without it
        loader = build_loader(cfg, make_dataset(cfg), cfg.batch_size)
        saved = slicecache.CACHE
        rounds, batches = [], {}
        try:
            for mode in ("cache", "none"):
                slicecache.CACHE = slicecache.VolumeCache(0 if mode == "none" else
                                                          slicecache.CAPACITY)
                times, images = loader_seconds(loader, 1, 1 if mode == "none" else 2)
                rounds.append({"mode": mode, "batch_s": times,
                               "decodes": slicecache.CACHE.decodes})
                batches.setdefault(mode, images[0])
        finally:
            slicecache.CACHE = saved
        check(np.array_equal(batches["cache"], batches["none"]),
              "the loader's batch with the cache differs from the one without")
        # the converter's resized PNGs against PIL's bicubic of the same slices
        slices = load_slice_info(str(info))
        t0 = time.perf_counter()
        nii_to_png(slices, save_dir=str(data_tmp / "real_images"), do_resize_to=(64, 64))
        convert_s = time.perf_counter() - t0
        volumes, bad = {}, 0
        for path, axis, index in slices:
            if path not in volumes:
                volumes[path] = read_nifti(path)
            plane = np.take(volumes[path], index, axis="xyz".index(axis)).astype(np.uint8)
            want = np.asarray(Image.fromarray(plane).resize((64, 64)))
            name = f"{Path(path).name.split('.nii.gz')[0]}_{axis}_{index}.png"
            bad += not np.array_equal(np.asarray(Image.open(data_tmp / "real_images" / name)),
                                      want)
        check(bad == 0, f"{bad} of {len(slices)} resized PNGs differ from PIL's bicubic")
    cached = [r["batch_s"] for r in rounds if r["mode"] == "cache"]
    uncached = [r["batch_s"][0] for r in rounds if r["mode"] == "none"]
    step_ms = run["bare_after"]
    print(f"luna16 (shipped config, do_resize yes): 3 volumes of {LUNA_SIDE}³ written in "
          f"{write_s:.2f} s, {want_slices} slices scanned in {scan_s:.2f} s; loader s a batch "
          f"of {cfg.batch_size}: with the cache (first batch from a cold cache, then "
          f"warm) {cached}, without {uncached}; bare f32 step {step_ms['plain_step']:.1f} ms "
          f"(R1 {step_ms['r1_step']:.1f}); nii_to_png of {len(slices)} slices to 64² "
          f"{convert_s:.2f} s, every PNG equal to PIL's bicubic")
    return {**run, "volume_write_s": write_s, "scan_s": scan_s, "slices": len(slices),
            "loader_rounds": rounds, "nii_to_png_s": convert_s, "pngs_exact": len(slices)}


# ---------------------------------------------------------------------------
# LMDB datasets, remat and the sampler CLI over ranks (phases 50-53b)
LMDB_GET_ENTRIES = 126_227  # LSUN church_outdoor train's entries
LMDB_GET_VALUE = 2048  # bytes a value: on an overflow page, as every LSUN image is
LMDB_GET_CALLS = 20_000
LSUN_IMAGES = 64
LSUN_LOSSLESS = 4  # lossless WebP values beside the lossy ones (phase 55)
LSUN_W, LSUN_H = 341, 256  # LSUN's images have 256 on the short side
LSUN_ITERS = 2  # steps an epoch (batch 8): epochs 0 and 1, R1 at step 0; epoch 2 resumed
TRAIN_BATCH_LSUN = 8  # the LSUN Church 256 recipe's batch per GPU (tools/bench_extra.py:194)
CELEBA_LMDB_ENTRIES = 27_000  # `num_samples('celeba', True)`
CELEBA_JPEGS = 64
CELEBA_ITEMS = [0, 9, 10, 13_500, 26_999]
REMAT_TIMED_STEPS = 3  # each mode once in each place of the rotation
RANKS = 2
RANKS_FID_SAMPLES = 256
RANKS_PLAIN_BATCH = 63


def lsun256_config(Config):
    """The LSUN Church Outdoor 256 recipe of `tools/bench_extra.py:192-206`
    (readme.md:39-46 of the reference): the CelebA-HQ 256 network, T=4,
    r1_gamma 1, lazy_reg 10, ema 0.999, lr_d 1e-4, lr_g 1.6e-4, dropout 0,
    bf16, batch 8 a GPU; weights random, use_remat the port's "auto"."""
    return celeba256_config(Config).replace(
        dataset="lsun", num_timesteps=4, batch_size=TRAIN_BATCH_LSUN, r1_gamma=1.0,
        lr_d=1e-4, lr_g=1.6e-4)


def tests_helper(name: str):
    """A helper module of tests/ that imports torch, numpy and the standard
    library only (the LMDB writer), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jpeg_bytes(Image, arr: np.ndarray, quality: int = 95) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def lmdb_on_host(writer) -> dict:
    """The LMDB reader on this host: files from the tests' writer (depth >= 3,
    inline values and overflow runs on both sides of LMDB's nodemax, the
    newer of two meta pages, an empty database), every key read back and
    the cursor in key order; ms per `get` at LSUN church train's 126,227
    entries; then both directions against the `lmdb` package, if it
    imports here."""
    from ddgan_torch.data import lmdb

    rs = np.random.RandomState(50)
    nodemax = writer.nodemax(4096)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 5-byte keys: a node of 8 + 5 + v bytes stays inline up to v = nodemax - 13
        sizes = [0, 10, nodemax - 13, nodemax - 12, 5000]
        items = {f"{i:05d}".encode(): rs.bytes(sizes[i % 5]) for i in range(200)}
        info = writer.write_lmdb(tmp / "deep", items, max_keys=8, txnid=7,
                                 older={b"stale": b"old"})
        with lmdb.open(str(tmp / "deep")).begin() as txn:
            keys = list(txn.cursor().iternext(keys=True, values=False))
            check(info["depth"] >= 3 and info["overflow"] >= 80 and keys == sorted(items)
                  and all(txn.get(k) == v for k, v in items.items())
                  and txn.get(b"stale") is None and txn.stat()["entries"] == len(items),
                  f"LMDB reader against the writer: {info}, {len(keys)} keys")
        writer.write_lmdb(tmp / "empty", {})
        with lmdb.open(str(tmp / "empty")).begin() as txn:
            check(txn.stat()["entries"] == 0 and txn.get(b"0") is None
                  and not list(txn.cursor().iternext(keys=True, values=False)), "empty LMDB")
        out["writer_files"] = {"depth": info["depth"], "entries": len(items),
                               "overflow_pages": info["overflow"]}

        keys = [rs.bytes(20).hex().encode() for _ in range(LMDB_GET_ENTRIES)]
        value = rs.bytes(LMDB_GET_VALUE)  # one value for every key: the walk is timed
        t0 = time.perf_counter()
        info = writer.write_lmdb(tmp / "church", dict.fromkeys(keys, value))
        write_s = time.perf_counter() - t0
        with lmdb.open(str(tmp / "church")).begin() as txn:
            order = rs.permutation(LMDB_GET_ENTRIES)[:LMDB_GET_CALLS]
            t0 = time.perf_counter()
            got = [txn.get(keys[i]) for i in order]
            get_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            walked = sum(1 for _ in txn.cursor().iternext(keys=True, values=False))
            cursor_s = time.perf_counter() - t0
        check(all(v == value for v in got) and walked == LMDB_GET_ENTRIES,
              f"LMDB at {LMDB_GET_ENTRIES} entries: {walked} keys walked")
        out["church_train_size"] = {
            "entries": LMDB_GET_ENTRIES, "depth": info["depth"], "bytes": info["bytes"],
            "write_s": write_s, "ms_per_get": 1e3 * get_s / LMDB_GET_CALLS,
            "cursor_s": cursor_s}
        print(f"LMDB reader: {LMDB_GET_ENTRIES} entries of {LMDB_GET_VALUE} bytes, depth "
              f"{info['depth']}, {info['bytes']} bytes written in {write_s:.2f} s; "
              f"{1e3 * get_s / LMDB_GET_CALLS:.4f} ms per get over {LMDB_GET_CALLS} random keys; "
              f"the cursor over every key {cursor_s:.2f} s (this host's CPU)")
        try:
            import lmdb as real  # noqa: F401  (the reference, where installed)
        except ImportError:
            out["lmdb_package"] = "not installed: the reader is held against the writer only"
        else:
            small = dict(list(items.items())[:100])
            env = real.open(str(tmp / "real"), map_size=1 << 28)
            with env.begin(write=True) as txn:
                for k, v in small.items():
                    txn.put(k, v)
            env.close()
            with lmdb.open(str(tmp / "real")).begin() as txn:
                check(list(txn.cursor().iternext(keys=True, values=False)) == sorted(small)
                      and all(txn.get(k) == v for k, v in small.items()),
                      "the reader on the lmdb package's file")
            env = real.open(str(tmp / "deep"), readonly=True, lock=False)
            with env.begin() as txn:
                check(all(bytes(txn.get(k)) == v for k, v in items.items()),
                      "the lmdb package on the writer's file")
            out["lmdb_package"] = "both directions equal"
        print(f"lmdb package: {out['lmdb_package']}")
    return out


def lsun_values(Image, fmt: str) -> dict:
    """{40-hex-character key: value} of LSUN_IMAGES seeded 341 x 256 toy
    images: JPEGs at q95 (`fmt` "jpeg"), or lossy WebPs at qualities 60-95
    and methods 0-6 and LSUN_LOSSLESS lossless ones ("webp"), all by PIL."""
    rs = np.random.RandomState(51 if fmt == "jpeg" else 55)
    items = {}
    for i in range(LSUN_IMAGES + (LSUN_LOSSLESS if fmt == "webp" else 0)):
        arr = (toy_image_wh(np.random.RandomState(51 * 7_000_003 + i), LSUN_W, LSUN_H)
               * 255).astype(np.uint8)
        if fmt == "jpeg":
            value = jpeg_bytes(Image, arr)
        else:
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, "WEBP", quality=60 + 5 * (i % 8), method=i % 7,
                                      lossless=i >= LSUN_IMAGES)
            value = buf.getvalue()
        items[rs.bytes(20).hex().encode()] = value
    return items


def lsun_run(Image, writer, cfg, fir2x, pair_conv, fmt: str = "jpeg", resume_run: bool = True
             ) -> dict:
    """The LSUN Church Outdoor 256 recipe through `main_cli --dataset lsun
    --data_dir` on a church_outdoor_train_lmdb written by the tests' writer
    (`lsun_values(fmt)` under 40-hex-character keys), with do_resize,
    ToTensor, Normalize and CenterCrop (256²) and the port's "auto" remat:
    epochs 0 and 1 of 2 steps, or epoch 0 alone without `resume_run`
    (phase 28's checks, K1 and K2 by role with the recompute term of the
    remat that "auto" picks), the sampler CLI at 256², T=4; with
    `resume_run` the key cache written in epoch 0 and read, not rebuilt, by
    a --resume for epoch 2; then batch 0 of the loop's loader against PIL +
    the JAX transform arithmetic (<= 1e-6) and its seconds a batch beside
    the bare step."""
    from ddgan_torch.cli import main_cli
    from ddgan_torch.data import lmdb, make_dataset
    from ddgan_torch.models.ncsnpp import resolve_remat_policy, resolve_use_remat
    from ddgan_torch.train.loop import build_loader

    remat = resolve_use_remat(cfg)
    policy = resolve_remat_policy(str(cfg.remat_policy)) if remat else None
    g = expected_g_fir(len(cfg.ch_mult) - 1)
    per_forward_k2 = sum(PAIR_CONVS.values())
    sample_launches = {"down2x": cfg.num_timesteps * g["down2x"],
                       "up2x": cfg.num_timesteps * g["up2x"],
                       "pair_conv3x3": cfg.num_timesteps * per_forward_k2}
    k2 = expected_k2_per_step(policy)
    with tempfile.TemporaryDirectory() as data_tmp:
        data = Path(data_tmp) / "lsun"
        t0 = time.perf_counter()
        items = lsun_values(Image, fmt)
        root = data / "church_outdoor_train_lmdb"
        info = writer.write_lmdb(root, items)
        write_s = time.perf_counter() - t0
        cache = root / ("_cache_" + "".join(c for c in str(root) if c.isascii() and c.isalnum()))
        run_cfg = cfg.replace(data_dir=str(data), do_resize="yes", to_tensor_transform="yes",
                              use_normalize="yes", CenterCrop="yes",
                              exp="lsun256" if fmt == "jpeg" else f"lsun256{fmt}",
                              limited_iter=LSUN_ITERS, num_epoch=1 if resume_run else 0,
                              save_ckpt_every=1)

        def resume(argv, exp):
            check(cache.is_file() and pickle.loads(cache.read_bytes()) == sorted(items),
                  f"epoch 0 wrote no key cache {cache} of the LMDB's keys")
            stamp = cache.stat().st_mtime_ns
            walks = []
            iternext = lmdb.Cursor.iternext
            lmdb.Cursor.iternext = lambda self, *a, **k: walks.append(1) or iternext(self, *a, **k)
            _reset(fir2x, pair_conv)
            try:
                at = argv.index("--num_epoch") + 1
                with Tee():
                    state = main_cli.main(argv[:at] + ["2"] + argv[at + 1:] + ["--resume"])
            finally:
                lmdb.Cursor.iternext = iternext
            check(not walks and cache.stat().st_mtime_ns == stamp,
                  f"the resumed run rebuilt the key cache ({len(walks)} cursor walks)")
            calls = check_loop_run(run_cfg.replace(num_epoch=2), exp,
                                   range(2 * LSUN_ITERS, 3 * LSUN_ITERS), fir2x, pair_conv, k2,
                                   {"remat": remat})
            check(state.step == 3 * LSUN_ITERS, f"resumed lsun run ended at step {state.step}")
            return {"cache_bytes": cache.stat().st_size, "launches": calls}

        run = loop_through_main_cli(run_cfg, None, fir2x, pair_conv, k2_per_step=k2,
                                    sample_launches=sample_launches,
                                    extra_argv=("--data_dir", str(data)),
                                    g_fir={"remat": remat},
                                    after=resume if resume_run else None)
        ds = make_dataset(run_cfg)
        loader = build_loader(run_cfg, ds, run_cfg.batch_size)
        loader.set_epoch(0)
        keys = ds.dbs[0].keys
        first = [io.BytesIO(items[keys[i]]) for i in loader._indices()[:run_cfg.batch_size]]
        times, images = loader_seconds(loader, 0, len(loader))
        want = pil_reference_items(Image, first, run_cfg.image_size)
        err = float(np.abs(images[0] - want).max())
        side = run_cfg.image_size
        check(images[0].shape == (run_cfg.batch_size, side, side, 3) and err <= 1e-6,
              f"lsun batch 0 {images[0].shape} against PIL and the JAX transforms: {err}")
    s_per_batch = float(np.mean(times))
    bare_ms = run["bare_after"]["plain_step"]
    cached = (f"; key cache {run['after']['cache_bytes']} bytes, read by the resume"
              if resume_run else "")
    print(f"{run_cfg.exp}: {len(items)} {fmt} values into an LMDB of {info['bytes']} bytes in "
          f"{write_s:.2f} s; use_remat 'auto' -> {remat}; batch 0 against PIL + the JAX transforms "
          f"max-abs {err!r}; loader {1e3 * s_per_batch:.1f} ms a batch of {run_cfg.batch_size} "
          f"(LMDB get, decode, ToTensor, Normalize, crop; {len(times)} batches, one thread) beside "
          f"the bare bf16 step {bare_ms:.1f} ms ({100 * 1e3 * s_per_batch / bare_ms:.1f}% of "
          f"it){cached}")
    return {**run, "format": fmt, "values": len(items), "remat": remat,
            "lmdb_bytes": info["bytes"], "write_s": write_s,
            "batch0_max_abs": err, "loader_s_per_batch": s_per_batch, "loader_batch_s": times,
            "loader_share_of_bare_step": 1e3 * s_per_batch / bare_ms}


def celeba_lmdb_run(Image, writer) -> dict:
    """celeba_256 through `make_dataset`: train.lmdb of 27,000 keys "0" ..
    "26999" whose values cycle over 64 seeded 64² toy JPEGs (q95), so that
    len() = 27000 is real and any shuffled index resolves; items 0, 9, 10,
    13500 and 26999 with do_resize (256²), ToTensor, Normalize and
    CenterCrop against PIL + the JAX transform arithmetic (<= 1e-6), and
    ms per item over 200 shuffled indices; then a raw-mode validation.lmdb
    of 8 entries (32² RGB bytes) read the same way."""
    from ddgan_torch.config import Config
    from ddgan_torch.data import make_dataset
    from ddgan_torch.data.lmdb_datasets import LMDBDataset
    from ddgan_torch.data.transforms import build_transform

    jpegs = [jpeg_bytes(Image, (toy_image_wh(np.random.RandomState(52 * 7_000_003 + i), 64, 64)
                                * 255).astype(np.uint8)) for i in range(CELEBA_JPEGS)]
    rs = np.random.RandomState(52)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        info = writer.write_lmdb(Path(tmp) / "train.lmdb",
                                 {str(i).encode(): jpegs[i % CELEBA_JPEGS]
                                  for i in range(CELEBA_LMDB_ENTRIES)})
        write_s = time.perf_counter() - t0
        cfg = Config(dataset="celeba_256", data_dir=tmp, image_size=256, num_channels=3,
                     do_resize="yes", to_tensor_transform="yes", use_normalize="yes",
                     CenterCrop="yes")
        ds = make_dataset(cfg)
        check(isinstance(ds, LMDBDataset) and len(ds) == CELEBA_LMDB_ENTRIES,
              f"celeba_256 dataset {type(ds).__name__} of {len(ds)}")
        got = np.stack([ds[i][0] for i in CELEBA_ITEMS])
        want = pil_reference_items(Image, [io.BytesIO(jpegs[i % CELEBA_JPEGS])
                                           for i in CELEBA_ITEMS], 256)
        err = float(np.abs(got - want).max())
        check(got.shape == (len(CELEBA_ITEMS), 256, 256, 3) and err <= 1e-6,
              f"celeba_256 items {CELEBA_ITEMS} against PIL + the JAX transforms: {err}")
        order = rs.permutation(CELEBA_LMDB_ENTRIES)[:200]
        t0 = time.perf_counter()
        for i in order:
            ds[int(i)]
        item_ms = 1e3 * (time.perf_counter() - t0) / len(order)
        raw = [rs.randint(0, 256, (32, 32, 3)).astype(np.uint8) for _ in range(8)]
        writer.write_lmdb(Path(tmp) / "validation.lmdb",
                          {str(i).encode(): a.tobytes() for i, a in enumerate(raw)})
        rds = LMDBDataset(tmp, name="celeba", train=False, transform=build_transform(
            cfg.replace(image_size=32, do_resize="no")))
        pngs = []
        for a in raw:
            buf = io.BytesIO()
            Image.fromarray(a).save(buf, format="PNG")
            pngs.append(io.BytesIO(buf.getvalue()))
        raw_err = float(np.abs(np.stack([rds[i][0] for i in range(8)])
                               - pil_reference_items(Image, pngs, 32)).max())
        check(len(rds) == 3000 and raw_err == 0.0 and rds[3][1] == [0],
              f"raw CelebA LMDB: len {len(rds)}, max-abs {raw_err}")
    print(f"celeba_256 LMDB: {CELEBA_LMDB_ENTRIES} keys ({info['bytes']} bytes, depth "
          f"{info['depth']}) written in {write_s:.2f} s; items {CELEBA_ITEMS} against PIL + the "
          f"JAX transforms max-abs {err!r}; {item_ms:.2f} ms an item (get, decode, resize to "
          f"256², transforms); raw mode max-abs {raw_err!r}")
    return {"entries": CELEBA_LMDB_ENTRIES, "bytes": info["bytes"], "depth": info["depth"],
            "write_s": write_s, "items_max_abs": err, "ms_per_item": item_ms,
            "raw_max_abs": raw_err}


REMAT_MODES = {"off": dict(use_remat="no"), "full": dict(use_remat="yes", remat_policy="full"),
               "save-convs": dict(use_remat="yes", remat_policy="save-convs")}


class _CountingCalls:
    """`module` with its function `name` counted in `counts["convs"]`."""

    def __init__(self, module, name: str, counts: dict):
        self._module, self._name, self._counts = module, name, counts

    def __getattr__(self, attr):
        fn = getattr(self._module, attr)
        if attr != self._name:
            return fn

        def counted(*args, **kwargs):
            self._counts["convs"] += 1
            return fn(*args, **kwargs)
        return counted


@contextlib.contextmanager
def counting_convs():
    """Counts of the convs of `nn/layers.py` that run, its calls of
    `F.conv2d` and `pair_conv.pair_conv3x3` (a conv output that
    "save-convs" replays is not run)."""
    from ddgan_torch.nn import layers

    counts = {"convs": 0}
    real = layers.F, layers.pair_conv
    layers.F = _CountingCalls(layers.F, "conv2d", counts)
    layers.pair_conv = _CountingCalls(layers.pair_conv, "pair_conv3x3", counts)
    try:
        yield counts
    finally:
        layers.F, layers.pair_conv = real


def remat_on_card(cfg, dev, fir2x, pair_conv) -> dict:
    """The lsun256 bf16 step at batch 8 with remat off, "full" and
    "save-convs": an R1 step and a step without from the same state and
    draws, cuDNN deterministic: G's gradients and weights, the EMA and D's
    weights equal to the remat-free run bit for bit; launches by role
    (the recompute term under "full", K1's under both), and under
    "save-convs" as many conv runs as without remat; then three R1-free
    steps of each in turns (the order rotating), ms and the peak memory above the
    resident state."""
    from ddgan_torch.models import NCSNpp, build_discriminator
    from ddgan_torch.utils import randomize_parameters_

    gen_sd = randomize_parameters_(NCSNpp.from_config(cfg.replace(use_remat="no")), 53).state_dict()
    disc = build_discriminator(cfg)
    disc.init_weights(torch.Generator().manual_seed(54))
    disc_sd = disc.state_dict()
    real = real_batch(cfg, cfg.batch_size, 53).to(dev)
    n_g, n_d, shared = len(cfg.ch_mult) - 1, 6, cfg.image_size >= 256  # R1 shares D(x_t)
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        for mode, keys in REMAT_MODES.items():
            state, step = build_trainer(cfg.replace(**keys), gen_sd, disc_sd, dev, "bfloat16")
            rng = torch.Generator(device=dev).manual_seed(55)
            per_step = []
            for _ in range(2):  # R1 at step 0, none at step 1
                _reset(fir2x, pair_conv)
                with counting_convs() as convs:
                    step(state, real, rng, cfg.lr_g, cfg.lr_d)
                torch.cuda.synchronize()
                per_step.append({**_calls(fir2x, pair_conv), **convs})
            g_params = list(state.gen.named_parameters())
            tensors = {**{f"G.{k}": p.detach().clone() for k, p in g_params},
                       **{f"G.grad.{k}": p.grad.clone() for k, p in g_params},
                       **{f"ema.{k}": v.clone() for k, v in state.ema_G.items()},
                       **{f"D.{k}": p.detach().clone() for k, p in state.disc.named_parameters()}}
            runs[mode] = {"tensors": tensors, "rng": rng.get_state(), "calls": per_step}
            del state, step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    base = runs["off"]
    out = {"calls": {m: r["calls"] for m, r in runs.items()}}
    for mode in ("full", "save-convs"):
        r = runs[mode]
        diff = max(float((r["tensors"][k].float() - v.float()).abs().max())
                   for k, v in base["tensors"].items())
        same = all(torch.equal(r["tensors"][k], v) for k, v in base["tensors"].items())
        check(same and torch.equal(r["rng"], base["rng"]),
              f"remat {mode}: two steps apart from the remat-free run, max-abs {diff}")
        out[f"{mode}_max_abs"] = diff
        policy = "full" if mode == "full" else "save-convs"
        for i, c in enumerate(r["calls"]):
            want_fir = expected_fir_calls(n_d, n_g, i == 0, shared, remat=True)
            check(c["fir"] == want_fir and c["pair_conv3x3"] == expected_k2_per_step(policy),
                  f"remat {mode} step {i}: {c}, expected FIR {want_fir}, K2 "
                  f"{expected_k2_per_step(policy)}")
            off = base["calls"][i]
            more = c["convs"] == off["convs"] if mode == "save-convs" else c["convs"] > off["convs"]
            check(more,
                  f"remat {mode} step {i}: {c['convs']} convs run against {off['convs']} off")
    for i, c in enumerate(base["calls"]):
        check(c["fir"] == expected_fir_calls(n_d, n_g, i == 0, shared)
              and c["pair_conv3x3"] == expected_k2_per_step(None), f"remat off step {i}: {c}")
    print(f"remat on the card: full and save-convs equal to off bit for bit after an R1 step and "
          f"a step without (cuDNN deterministic); convs run a step off / full / save-convs: "
          + " / ".join(str(runs[m]["calls"][1]["convs"]) for m in REMAT_MODES))
    del runs

    states = {m: build_trainer(cfg.replace(**k), gen_sd, disc_sd, dev, "bfloat16")
              for m, k in REMAT_MODES.items()}
    rngs = {m: torch.Generator(device=dev).manual_seed(56) for m in REMAT_MODES}
    modes = list(REMAT_MODES)
    times = {m: [] for m in modes}
    peaks = {m: [] for m in modes}
    for m in modes:  # warm-up: an R1-free step each
        states[m][0].step = 1
        states[m][1](states[m][0], real, rngs[m], cfg.lr_g, cfg.lr_d)
    for i in range(REMAT_TIMED_STEPS):
        for m in modes[i % 3:] + modes[:i % 3]:
            state, step = states[m]
            state.step = 1  # no R1
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            step(state, real, rngs[m], cfg.lr_g, cfg.lr_d)
            torch.cuda.synchronize()
            times[m].append(1e3 * (time.perf_counter() - t0))
            peaks[m].append((torch.cuda.max_memory_allocated() - resident) / 1e9)
    del states
    torch.cuda.empty_cache()
    out["ms"] = times
    out["peak_above_resident_gb"] = {m: max(v) for m, v in peaks.items()}
    for m in modes:
        print(f"lsun256 bf16 step at batch {cfg.batch_size}, remat {m}: "
              f"{np.median(times[m]):.3f} ms median ({min(times[m]):.3f}-{max(times[m]):.3f}, "
              f"{REMAT_TIMED_STEPS} in turns), peak {out['peak_above_resident_gb'][m]:.3f} GB "
              "above the resident state")
    out["median_ms"] = {m: float(np.median(v)) for m, v in times.items()}
    return out


@contextlib.contextmanager
def stdout_to(path: Path):
    """File descriptor 1, and so the output of the processes started within,
    sent to `path`."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
        try:
            yield
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)


def sample_uint8(x: torch.Tensor) -> np.ndarray:
    """Samples in [-1, 1] as the uint8 HWC pixels `utils.save_image` writes."""
    x = ((x.float() + 1.0) / 2.0).permute(0, 2, 3, 1).cpu().numpy()
    return np.clip(np.clip(x, 0.0, 1.0) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def sampler_cli_over_ranks(cfg, gen_sd, dev) -> dict:
    """`test_cli.main` with `--num_process_per_node 2 --device cuda:0` (two
    gloo ranks sharing the card, spawned by `parallel.launch` and meeting
    through a `file://` rendezvous, as phase 46 runs them) on a
    full-width flagship experiment whose saved args say 8 processes over
    gloo: with --compute_fid, 256 samples at 64 a rank
    against 256 seeded 32² PNGs (random Inception weights): every {i}.png
    equal to a one-process emulation of the two ranks (rank r's generator
    seeded with seed + r, calls in turn), the FID printed once and written
    once after the last PNG; then plain sampling with batch 63 over the two
    ranks: 63 PNGs, each equal to the emulation's."""
    import datetime

    from ddgan_torch.cli import test_cli
    from ddgan_torch.utils import decode_pngs

    out = {}
    with tempfile.TemporaryDirectory() as tmp, random_inception_env():
        tmp = Path(tmp)
        exp = tmp / "saved_info" / "dd_gan" / "cifar10" / "ranks"
        exp.mkdir(parents=True)
        # trained on 8 ranks over gloo: the sampler takes the backend, not the count
        (exp / "content_args.json").write_text(json.dumps(
            cfg.replace(exp="ranks", num_process_per_node=8, what_backend="gloo").to_dict()))
        torch.save(gen_sd, exp / "netG_1.pth")
        write_filtered_set(tmp / "real", RANKS_FID_SAMPLES, 32, seed=53)
        # every rank on the one card (on the CPU when a rehearsal runs there)
        device = "cuda:0" if dev.type == "cuda" else "cpu"
        argv = ["--dataset", "cifar10", "--exp", "ranks", "--epoch_id", "1", "--seed", "0",
                "--device", device, "--num_process_per_node", str(RANKS)]
        folder = tmp / "generated_samples" / "cifar10"
        args = test_cli.build_parser().parse_args(argv)
        ccfg = test_cli.load_config(exp, args)
        net = test_cli.load_generator(exp, ccfg, 1, dev)

        def emulate(per_rank: int, calls: int) -> np.ndarray:
            # the ranks run with torch's default TF32 flags, not with this script's
            tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
            try:
                rngs = [torch.Generator(device=dev).manual_seed(r) for r in range(RANKS)]
                samplers = [test_cli.make_sampler(ccfg, net, per_rank, dev, rng) for rng in rngs]
                return np.concatenate([sample_uint8(s()) for _ in range(calls) for s in samplers])
            finally:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

        with contextlib.chdir(tmp):  # the CLI writes under its working directory
            for mode, extra, n, names in (
                    ("fid", ["--compute_fid", "--num_fid_samples", str(RANKS_FID_SAMPLES),
                             "--batch_size", str(BATCH), "--real_img_dir", "real"],
                     RANKS_FID_SAMPLES, "{}.png"),
                    ("plain", ["--batch_size", str(RANKS_PLAIN_BATCH)], RANKS_PLAIN_BATCH,
                     "sample_{}.png")):
                log = tmp / f"{mode}.log"
                t0 = time.perf_counter()
                try:
                    with stdout_to(log):  # the spawned ranks print to the same descriptor
                        test_cli.main([*argv, *extra],
                                      init_method=f"file://{tmp}/rendezvous_{mode}",
                                      deadline_s=600, timeout=datetime.timedelta(seconds=300))
                except RuntimeError as e:
                    check(False, f"test_cli over {RANKS} ranks ({mode}): {e}\n"
                          f"{log.read_text()[-3000:]}")
                run_s = time.perf_counter() - t0
                files = sorted(folder.glob(names.format("*")))
                check(len(files) == n and {p.name for p in files} == {names.format(i)
                                                                     for i in range(n)},
                      f"test_cli over ranks ({mode}): {len(files)} files, expected {n}")
                per_rank = BATCH if mode == "fid" else -(-n // RANKS)
                want = emulate(per_rank, -(-n // (per_rank * RANKS)))
                got = decode_pngs([(folder / names.format(i)).read_bytes() for i in range(n)])
                bad = [i for i in range(n) if not np.array_equal(got[i], want[i])]
                check(not bad, f"test_cli over ranks ({mode}): {len(bad)} PNGs differ from the "
                      f"one-process emulation, first {bad[:5]}")
                out[mode] = {"files": n, "s": run_s}
                if mode == "fid":
                    fids = [ln for ln in log.read_text().splitlines() if ln.startswith("FID = ")]
                    score = tmp / "fid_score.txt"
                    check(len(fids) == 1 and score.is_file()
                          and score.stat().st_mtime_ns >= max(p.stat().st_mtime_ns for p in files)
                          and np.isfinite(float(score.read_text())),
                          f"FID lines {fids}; fid_score.txt after the PNGs: {score.is_file()}")
                    out[mode]["fid"] = float(score.read_text())
                print(f"test_cli over {RANKS} gloo ranks on the card ({mode}): {n} PNGs equal "
                      f"to the one-process emulation, {run_s:.1f} s"
                      + (f"; FID {out[mode]['fid']!r} printed and written once" if mode == "fid"
                         else ""))
    return out


# ---------------------------------------------------------------------------
# WebP: the decoder against PIL on the host, and lsun from WebP values
WEBP_TIMED_QUALITY = 90  # the 341 x 256 lossy image timed in phase 54


def webp_against_pil(Image) -> dict:
    """The port's WebP decoder against PIL on this host: every file of the
    tests' matrix (`tests/_torch_webp.py`'s `matrix`, PIL's files and, where
    the bundled libwebp loads through ctypes, WebPEncode's) bit for bit (no
    case has a bound), every malformed file of its `BROKEN` refused with
    ValueError; ms per 341 x 256 lossy image of each, in turns."""
    import PIL
    from PIL import features

    from ddgan_torch.data.webp import decode_webp

    lw = tests_helper("_torch_webp")
    libwebp = lw.version() if lw.load() is not None else "does not load through ctypes"
    print(f"PIL {PIL.__version__}, its libwebp {features.version('webp')}; ctypes libwebp "
          f"{libwebp} ({lw.libwebp_path()})")
    t0 = time.perf_counter()
    files = lw.matrix()
    write_s = time.perf_counter() - t0
    bad = []
    for label, data in files:
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        got = decode_webp(data)
        if got.shape != want.shape or not np.array_equal(got, want):
            bad.append(label)
    check(not bad, f"WebP decoder differs from PIL on {len(bad)} of {len(files)} files: {bad}")
    kept = []
    for kind, make in lw.BROKEN.items():
        try:
            decode_webp(make())
            kept.append(kind)
        except ValueError:
            pass
    check(not kept, f"malformed WebP files decoded without a ValueError: {kept}")
    arr = (toy_image_wh(np.random.RandomState(54), LSUN_W, LSUN_H) * 255).astype(np.uint8)
    data = lw.pil_save(arr, quality=WEBP_TIMED_QUALITY)
    ms = host_ms_in_turns({"port": lambda: decode_webp(data),
                           "pil": lambda: np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))})
    encoder = sum(label.startswith("encoder") for label, _ in files)
    print(f"WebP decoder: {len(files)} files bit for bit ({encoder} of them WebPEncode's; written "
          f"in {write_s:.1f} s), {len(lw.BROKEN)} malformed files refused; {LSUN_W}x{LSUN_H} lossy "
          f"q{WEBP_TIMED_QUALITY} ({len(data)} bytes) {ms['port']:.3f} ms an image (port), "
          f"{ms['pil']:.3f} ms (PIL), on this host")
    return {"pil": PIL.__version__, "pil_libwebp": features.version("webp"),
            "ctypes_libwebp": libwebp, "files": len(files), "exact": len(files),
            "encoder_files": encoder, "malformed_refused": len(lw.BROKEN),
            "ms_341x256_lossy": ms, "timed_bytes": len(data)}


# ---------------------------------------------------------------------------
# BMP, Netpbm, TIFF, progressive / arithmetic / CMYK JPEG, PNG at every depth
def image_formats_against_pil(Image, smi: str) -> dict:
    """The port's readers against PIL on this host through
    `utils.decode_images`: every file of the tests' matrices
    (`tests/_torch_imagewriters.py`, loaded by path with
    `tests/_torch_jpeg_arith.py`: PNG at every colour type and depth, Adam7
    or not; BMP; PBM/PGM/PPM; TIFF; progressive, arithmetic-coded, CMYK,
    YCCK and RGB-coded JPEG; CCITT, JPEG-in-TIFF, LZMA, BigTIFF, float,
    signed and fill order 2 TIFF; JPEG at 4:4:0, 4:1:1 and the other
    sampling layouts PIL cannot write; lossless JPEG at every predictor;
    PFM and PIL's other Netpbm magics; GIF, TGA and ICO; files PIL writes
    among them) bit for
    bit (no case has a bound); the layouts the tests once listed as
    refused, now read, the same; every malformed file raising ValueError,
    every layout still refused raising NotImplementedError naming item
    13i; then ms per image, the port's and PIL's, in turns on this host's
    clock: at 256², a q95 4:2:0 JPEG baseline, progressive and
    arithmetic-coded (the same coefficients), an LZW TIFF, a 24-bit BMP, a
    16-bit PNG, a YCbCr 4:2:0 JPEG-in-TIFF, a float TIFF (Deflate,
    predictor 3), a 4:4:0 JPEG, an 8-bit GIF (256 colours, interlaced) and
    an RLE TGA of one image; and a 1728x2200 CCITT Group 4 page."""
    import PIL
    from PIL import features

    from ddgan_torch.utils import decode_images, image_format

    writers, arith = tests_helper("_torch_imagewriters"), tests_helper("_torch_jpeg_arith")
    print(f"PIL {PIL.__version__}, its libjpeg {features.version('jpg')}, libtiff "
          f"{features.version('libtiff')}, zlib {features.version('zlib')}")
    t0 = time.perf_counter()
    files = (writers.png_matrix(Image) + writers.bmp_matrix(Image)
             + writers.netpbm_matrix(Image) + writers.tiff_matrix(Image)
             + writers.jpeg_matrix(Image, arith)
             # the newer matrices at fewer sizes than the tests take (sizes not a
             # multiple of a strip, tile or MCU kept): depth, for the time limit
             + writers.tiff_more_matrix(Image, sizes=[(7, 9), (37, 45)])
             + writers.jpeg_sampling_matrix(Image, arith, sizes=[(7, 9), (37, 45)])
             + writers.jpeg_lossless_matrix(Image) + writers.gif_matrix(Image)
             + writers.tga_matrix(Image) + writers.ico_matrix(Image)
             + list(writers.once_refused(Image).items()))
    write_s = time.perf_counter() - t0
    bad, by_format = [], {}
    for label, data in files:
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        got = decode_images([data])[0]
        by_format[image_format(data)] = by_format.get(image_format(data), 0) + 1
        if got.shape != want.shape or not np.array_equal(got, want):
            bad.append(label)
    check(not bad, f"the readers differ from PIL on {len(bad)} of {len(files)} files: {bad[:20]}")
    kept, raised = [], []
    for label, data in writers.broken(Image).items():
        try:
            decode_images([data])
            kept.append(label)
        except ValueError:
            pass
    for label, data in writers.refused(Image).items():
        try:
            decode_images([data])
            raised.append(f"{label}: read")
        except NotImplementedError as e:
            if "item 13i" not in str(e):
                raised.append(f"{label}: {e}")
    check(not kept, f"malformed files decoded without a ValueError: {kept}")
    check(not raised, f"refused layouts not refused naming item 13i: {raised}")
    rs = np.random.RandomState(56)
    arr = smooth_field(rs, 256, 256, 3)
    baseline = pil_jpeg(Image, np.random.RandomState(48), 256, 256, "4:2:0", quality=95)
    tables = writers.jpeg_tables(Image, 95)
    page = writers.bilevel(np.random.RandomState(56), 2200, 1728, "sparse blocks")
    timed = {
        "jpeg baseline": baseline,
        "jpeg progressive": writers.pil_jpeg(Image, np.random.RandomState(48), 256, 256, "4:2:0",
                                             quality=95, progressive=True),
        "jpeg arithmetic": arith.to_arithmetic(baseline),
        "tiff LZW": writers.tiff(arr, photometric=2, compression=5),
        "bmp 24-bit": writers.bmp(arr, 24),
        "png 16-bit": writers.png(arr.astype(np.uint16) * 257, 2, 16),
        "tiff JPEG YCbCr 4:2:0": writers.jpeg_tiff(arr, 6, [(2, 2), (1, 1), (1, 1)], tables,
                                                   rows_per_strip=16),
        "tiff float predictor 3": writers.tiff(arr[:, :, :1].astype(np.float32) * 1.5 - 60,
                                               photometric=1, bits=32, sample_format=3,
                                               compression=8, predictor=3),
        "jpeg 4:4:0": writers.jpeg_encode(arr, [(1, 2), (1, 1), (1, 1)], tables),
        "gif 8-bit interlaced": writers.gif(arr[:, :, 0], 8, interlace=True,
                                            global_table=rs.randint(0, 256, (256, 3))),
        "tga RLE 24-bit": writers.tga(writers.tga_rle(arr[::-1, :, ::-1].tobytes(), 3, 256, rs),
                                      256, 256, 10, 24),
        "tiff CCITT T.6 1728x2200 page": writers.pil_tiff(
            Image, Image.fromarray(page.astype(np.uint8) * 255).convert("1"),
            compression="group4"),
    }
    fns = {}
    for name, data in timed.items():
        fns[f"{name} port"] = lambda d=data: decode_images([d])
        fns[f"{name} pil"] = lambda d=data: np.asarray(Image.open(io.BytesIO(d)).convert("RGB"))
    ms = host_ms_in_turns(fns)
    ms = {name: {"port": ms[f"{name} port"], "pil": ms[f"{name} pil"], "bytes": len(d)}
          for name, d in timed.items()}
    print(f"image formats: {len(files)} files bit for bit against PIL ({by_format}; written in "
          f"{write_s:.1f} s), {len(writers.once_refused(Image))} of them once refused, "
          f"{len(writers.broken(Image))} malformed files refused with ValueError, "
          f"{len(writers.refused(Image))} layouts refused naming item 13i")
    print(f"ms an image (256² but the page) on this host ({smi}): " + "; ".join(
        f"{k} {v['port']:.3f} (port) / {v['pil']:.3f} (PIL)" for k, v in ms.items()))
    return {"pil": PIL.__version__, "pil_libjpeg": features.version("jpg"),
            "pil_libtiff": features.version("libtiff"), "files": len(files), "exact": len(files),
            "by_format": by_format, "once_refused_read": len(writers.once_refused(Image)),
            "malformed_refused": len(writers.broken(Image)),
            "refused_13i": len(writers.refused(Image)), "write_s": write_s, "ms_256": ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "ddgan_torch" / "csrc" / "pair_conv3x3.cu").is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ddgan_torch.cli import test_cli
    from ddgan_torch.config import Config
    from ddgan_torch.diffusion import PosteriorCoefficients, sample_from_model_with_noise
    from ddgan_torch.models import NCSNpp
    from ddgan_torch.ops import _cxx, _nvcc, fir2x, pair_conv
    from ddgan_torch.utils import randomize_parameters_

    def reset_counts() -> None:
        fir2x.reset_launch_counts()
        pair_conv.reset_launch_counts()

    def counts() -> dict:
        return {**fir2x.LAUNCHES, **pair_conv.LAUNCHES}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    phase("1 card")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    for mod in ("PIL", "lmdb", "torchvision"):  # what the image-file datasets could use
        res = subprocess.run([sys.executable, "-c", f"import {mod}; print({mod}.__version__)"],
                             capture_output=True, text=True)
        print(f"import {mod}: " + (f"yes, {res.stdout.strip()}" if res.returncode == 0
                                   else f"no ({res.stderr.strip().splitlines()[-1:]})"))

    phase("2 build (one nvcc per kernel source and one host compiler per decoder source, "
          "started together)")

    def timed_build(build, *args):
        t0 = time.perf_counter()
        build(*args)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    builds = {"fir2x": (fir2x.build, True), "pair_conv3x3": (pair_conv.build, True),
              **{src: (_cxx.build, src) for src in HOST_SOURCES}}
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        futs = {name: pool.submit(timed_build, *job) for name, job in builds.items()}
        build_s = {name: f.result() for name, f in futs.items()}
    print(f"built {build_s} (s); all in {time.perf_counter() - t0:.1f} s")
    for source, report in sorted(_nvcc.PTXAS.items()):
        for line in ptxas_summary(report):
            print(f"ptxas {source}: {line}")

    phase("3 FIR kernels against their plain versions, flagship shapes")
    max_abs = {"down2x": 0.0, "up2x": 0.0, "pair_conv3x3": 0.0}
    # and up2x at odd sides (W 7: the scalar path) and at D's 4-wide VJP shape
    check_fir_kernels(fir2x, {"down2x": DOWN_SHAPES,
                              "up2x": UP_SHAPES + [(1, 2, 5, 7), (4, 512, 4, 4)]}, max_abs)

    phase("4 flagship generator")
    cfg = flagship_config(Config)
    cfg32 = cfg.replace(compute_dtype="float32")
    net_cpu = randomize_parameters_(NCSNpp.from_config(cfg32), seed=0).eval()
    net32 = copy.deepcopy(net_cpu).to(dev).eval()
    net16 = NCSNpp.from_config(cfg)
    net16.load_state_dict(net_cpu.state_dict())
    net16 = net16.to(dev).eval()
    n_params = sum(p.numel() for p in net_cpu.parameters())
    rs = np.random.RandomState(0)
    shape = (BATCH, cfg.num_channels, cfg.image_size, cfg.image_size)
    x_init = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    zs = [torch.from_numpy(rs.randn(BATCH, cfg.nz).astype(np.float32)) for _ in range(T)]
    noises = [torch.from_numpy(rs.randn(*shape).astype(np.float32)) for _ in range(T)]
    t_last = torch.full((BATCH,), T - 1, dtype=torch.int64)
    reset_counts()
    with torch.no_grad():
        out = net32(x_init.to(dev), t_last.to(dev), zs[0].to(dev))
    torch.cuda.synchronize()
    fwd_launches = counts()
    std = out.std().item()
    print(f"NCSNpp {n_params} parameters; forward {tuple(out.shape)} std {std:.4f}; "
          f"launches {fwd_launches}")
    check(out.shape == shape and bool(torch.isfinite(out).all()), "bad generator output")
    check(std > 0.05, f"generator output std {std}: weights are trivial")

    phase("5 T=4 sampler, GPU f32 (TF32 off) against the CPU plain path")
    coeff_gpu = PosteriorCoefficients.create(T, cfg.beta_min, cfg.beta_max, device=dev)
    coeff_cpu = PosteriorCoefficients.create(T, cfg.beta_min, cfg.beta_max, device="cpu")
    reset_counts()
    got = sample_from_model_with_noise(
        coeff_gpu, net32, T, x_init.to(dev), [z.to(dev) for z in zs], [n.to(dev) for n in noises])
    torch.cuda.synchronize()
    sampler_launches = counts()
    # the CPU plain path on the first CPU_ROWS rows (each row is computed alone)
    t0 = time.perf_counter()
    want = sample_from_model_with_noise(coeff_cpu, net_cpu, T, x_init[:CPU_ROWS],
                                        [z[:CPU_ROWS] for z in zs],
                                        [n[:CPU_ROWS] for n in noises])
    cpu_s = time.perf_counter() - t0
    sampler_err = (got[:CPU_ROWS].cpu() - want).abs().max().item()
    print(f"sampler GPU vs CPU max-abs {sampler_err:.3g} over the first {CPU_ROWS} rows "
          f"(CPU took {cpu_s:.1f} s); "
          f"sample std {want.std().item():.4f}; launches {sampler_launches}")
    check(bool(torch.isfinite(got).all()) and got.shape == shape, "bad sampler output")
    check(sampler_err <= 2e-3, f"sampler GPU vs CPU max-abs {sampler_err} > 2e-3")

    phase("6 launch counts")
    check(fwd_launches == {"down2x": 6, "up2x": 6, "pair_conv3x3": 0},
          f"per forward: {fwd_launches}")
    check(sampler_launches == {"down2x": 24, "up2x": 24, "pair_conv3x3": 0},
          f"per sampler call: {sampler_launches}")

    phase("7 main path: the sampler CLI and its FID-set loop")
    with tempfile.TemporaryDirectory() as tmp:
        exp = Path(tmp) / "saved_info" / "dd_gan" / "cifar10" / "smoke"
        exp.mkdir(parents=True)
        (exp / "content_args.json").write_text(json.dumps(cfg.replace(exp="smoke").to_dict()))
        torch.save(net_cpu.state_dict(), exp / "netG_1.pth")
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            reset_counts()
            test_cli.main(["--dataset", "cifar10", "--exp", "smoke", "--epoch_id", "1",
                           "--seed", "0"])
            torch.cuda.synchronize()
            main_launches = counts()
            pngs = sorted((Path(tmp) / "generated_samples" / "cifar10").glob("sample_*.png"))
            check(len(pngs) == BATCH, f"CLI wrote {len(pngs)} PNGs, expected {BATCH}")
            head = pngs[0].read_bytes()[:24]
            check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[16:24] == (32).to_bytes(4, "big") * 2,
                  "CLI PNG is not a 32x32 PNG")
            check(main_launches == {"down2x": 24, "up2x": 24, "pair_conv3x3": 0},
                  f"CLI run: {main_launches}")

            args = test_cli.build_parser().parse_args(["--dataset", "cifar10", "--exp", "smoke"])
            loaded = test_cli.load_config(exp, args)
            gen = test_cli.load_generator(exp, loaded, 1, dev)
            sample = test_cli.make_sampler(loaded, gen, BATCH, dev,
                                           torch.Generator(device=dev).manual_seed(1))
            reset_counts()
            n = test_cli.generate_samples(sample, 100, BATCH, Path(tmp) / "fid_set", tag="smoke")
            loop_launches = counts()
            n_png = len(list((Path(tmp) / "fid_set").glob("*.png")))
            check(n == 100 and n_png == 100, f"FID-set loop wrote {n_png} PNGs, expected 100")
            check(loop_launches == {"down2x": 48, "up2x": 48, "pair_conv3x3": 0},
                  f"FID-set loop: {loop_launches}")
        finally:
            os.chdir(cwd)
    print(f"CLI: {len(pngs)} PNGs, launches {main_launches}; FID-set loop: {n_png} PNGs, "
          f"launches {loop_launches}")

    phase("8 flagship timing")
    results = {}
    for label, net in (("bf16", net16), ("f32", net32)):
        call = test_cli.make_sampler(cfg, net, BATCH, dev, torch.Generator(device=dev).manual_seed(2))
        results[label] = sampler_ms(call, warmup=2, iters=5)
        print(f"sampler {label}: {results[label]:.3f} ms per T=4 call at batch {BATCH} = "
              f"{BATCH / results[label] * 1e3:.1f} samples/s")
    fir_rows = time_fir_kernels(fir2x, {"down2x": DOWN_SHAPES, "up2x": UP_SHAPES}, "flagship")

    phase("9 where the flagship sampler's time goes (torch.profiler, bf16)")
    profile = profile_sampler(test_cli.make_sampler(
        cfg, net16, BATCH, dev, torch.Generator(device=dev).manual_seed(4)), results["bf16"])
    flag_sd = net_cpu.state_dict()  # phase 30 samples an FID set from these weights
    del net16, net32, net_cpu, got, want, out

    phase("10 pair_conv3x3 against its plain version")
    # and an edge of the gate: 2 input channels (one 16-channel step, mostly
    # zero-filled) and a 160-wide map (its last 64-column tile half outside)
    pair_shapes = [(BATCH_256, c, s, s) for (c, s) in PAIR_CONVS] + [(2, 64, 128, 128),
                                                                     (3, 2, 160, 160)]
    for i, shp in enumerate(pair_shapes):
        n, c, h, w = shp
        g = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.randn(shp, generator=g, device=dev).to(torch.bfloat16)
        wt = torch.randn((64, c, 3, 3), generator=g, device=dev) / math.sqrt(9 * c)
        b = torch.randn((64,), generator=g, device=dev)
        with torch.no_grad():
            got_k, want_k = pair_conv.pair_conv3x3(x, wt, b), pair_conv.pair_conv3x3_ref(x, wt, b)
        torch.cuda.synchronize()
        err = (got_k.float() - want_k.float()).abs().max().item()
        scale = want_k.float().abs().max().item()
        max_abs["pair_conv3x3"] = max(max_abs["pair_conv3x3"], err)
        check(got_k.dtype == torch.bfloat16 and got_k.shape == (n, 64, h, w), f"{shp}: bad output")
        check(err <= bf16_ulp(scale), f"pair_conv3x3 {shp}: max-abs {err} > 1 ulp of {scale}")
        print(f"pair_conv3x3 {shp}: max-abs {err:.4g} (max|ref| {scale:.4g}, "
              f"1 ulp {bf16_ulp(scale):.4g})")
    x = torch.zeros((1, 64, 128, 128), device=dev, dtype=torch.bfloat16)
    wt, b = torch.zeros((64, 64, 3, 3), device=dev), torch.zeros((64,), device=dev)
    refused = [(x.float(), wt, b), (x[:, :, :96, :96].contiguous(), wt, b),
               (x, torch.cat([wt, wt]), b), (x[:, :63].contiguous(), wt[:, :63], b),
               (x.half(), wt, b), (x.transpose(2, 3), wt, b)]
    before = pair_conv.LAUNCHES["pair_conv3x3"]
    for args in refused:
        try:
            pair_conv.pair_conv3x3(*args)
        except ValueError:
            continue
        raise AssertionError(f"pair_conv3x3 took {tuple(args[0].shape)} {args[0].dtype} "
                             f"with w {tuple(args[1].shape)}")
    check(pair_conv.LAUNCHES["pair_conv3x3"] == before, "a refused call launched")
    print(f"{len(refused)} gated-out shapes and dtypes raised ValueError")

    phase("11 FIR kernels against their plain versions, 256² shapes")
    # and a down2x input whose bf16 rows are 24 bytes (W 12): the scalar path;
    # up2x at W 6 (the scalar path at even sides), at odd H on the vector
    # path, and at rows wider than a warp (halo loads at the warps' edges)
    check_fir_kernels(fir2x, {"down2x": DOWN_SHAPES_256 + [(2, 3, 10, 12)],
                              "up2x": UP_SHAPES_256 + [(3, 5, 6, 6), (2, 3, 9, 12), (1, 3, 7, 260)]},
                      max_abs)

    phase("12 CelebA-HQ 256 generator, full width")
    cfg2 = celeba256_config(Config)
    cfg2_32 = cfg2.replace(compute_dtype="float32")
    net2_cpu = randomize_parameters_(NCSNpp.from_config(cfg2_32), seed=1).eval()
    net2_32 = copy.deepcopy(net2_cpu).to(dev).eval()
    net2_16 = NCSNpp.from_config(cfg2)
    net2_16.load_state_dict(net2_cpu.state_dict())
    net2_16 = net2_16.to(dev).eval()
    n_params2 = sum(p.numel() for p in net2_cpu.parameters())
    shape2 = (BATCH_256, 3, 256, 256)
    g = torch.Generator(device=dev).manual_seed(5)
    x2 = torch.randn(shape2, generator=g, device=dev)
    zs2 = [torch.randn((BATCH_256, cfg2.nz), generator=g, device=dev) for _ in range(T_256)]
    noises2 = [torch.randn(shape2, generator=g, device=dev) for _ in range(T_256)]
    with torch.no_grad():
        out2 = net2_32(x2[:2], torch.full((2,), T_256 - 1, device=dev), zs2[0][:2])
    std2 = out2.std().item()
    print(f"NCSNpp (CelebA-HQ 256) {n_params2} parameters; forward {tuple(out2.shape)} "
          f"std {std2:.4f}")
    check(bool(torch.isfinite(out2).all()), "bad 256² generator output")
    check(std2 > 0.05, f"256² generator output std {std2}: weights are trivial")

    phase("13 T=2 sampler at 256², GPU f32 (TF32 off) against the CPU plain path, batch 2")
    coeff2_gpu = PosteriorCoefficients.create(T_256, cfg2.beta_min, cfg2.beta_max, device=dev)
    coeff2_cpu = PosteriorCoefficients.create(T_256, cfg2.beta_min, cfg2.beta_max, device="cpu")
    reset_counts()
    got2 = sample_from_model_with_noise(coeff2_gpu, net2_32, T_256, x2[:2],
                                        [z[:2] for z in zs2], [e[:2] for e in noises2])
    torch.cuda.synchronize()
    f32_launches = counts()
    t0 = time.perf_counter()
    want2 = sample_from_model_with_noise(coeff2_cpu, net2_cpu, T_256, x2[:2].cpu(),
                                         [z[:2].cpu() for z in zs2],
                                         [e[:2].cpu() for e in noises2])
    cpu2_s = time.perf_counter() - t0
    err256 = (got2.cpu() - want2).abs().max().item()
    print(f"256² sampler GPU vs CPU max-abs {err256:.3g} (CPU took {cpu2_s:.1f} s); "
          f"sample std {want2.std().item():.4f}; launches {f32_launches}")
    check(bool(torch.isfinite(got2).all()) and got2.shape == (2, 3, 256, 256), "bad output")
    check(err256 <= 2e-3, f"256² sampler GPU vs CPU max-abs {err256} > 2e-3")
    check(f32_launches == {"down2x": 20, "up2x": 20, "pair_conv3x3": 0},
          f"f32 256² sampler call: {f32_launches}")
    del net2_cpu, got2, want2

    phase("14 T=2 sampler at 256², bf16 against f32 on the GPU, batch 16")
    with torch.no_grad():
        ref32 = sample_from_model_with_noise(coeff2_gpu, net2_32, T_256, x2, zs2, noises2)
    reset_counts()
    got16 = sample_from_model_with_noise(coeff2_gpu, net2_16, T_256, x2, zs2, noises2)
    torch.cuda.synchronize()
    bf16_launches = counts()
    bf16_err = (got16.float() - ref32).abs().max().item()
    print(f"256² sampler bf16 vs f32 max-abs {bf16_err:.4g}; launches {bf16_launches}")
    check(bool(torch.isfinite(got16).all()) and got16.shape == shape2, "bad bf16 output")
    check(bf16_launches == {"down2x": 20, "up2x": 20, "pair_conv3x3": 46},
          f"bf16 256² sampler call: {bf16_launches}")
    check(bf16_err < 0.03, f"256² bf16 vs f32 max-abs {bf16_err} >= 0.03")
    del ref32, got16

    phase("15 main path: the sampler CLI on a CelebA-HQ 256 experiment")
    with tempfile.TemporaryDirectory() as tmp:
        exp = Path(tmp) / "saved_info" / "dd_gan" / "celeba_256" / "smoke256"
        exp.mkdir(parents=True)
        (exp / "content_args.json").write_text(json.dumps(cfg2.replace(exp="smoke256").to_dict()))
        torch.save({k: v.cpu() for k, v in net2_32.state_dict().items()}, exp / "netG_1.pth")
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            reset_counts()
            test_cli.main(["--dataset", "celeba_256", "--exp", "smoke256", "--epoch_id", "1",
                           "--seed", "0"])
            torch.cuda.synchronize()
            main256_launches = counts()
            pngs = sorted((Path(tmp) / "generated_samples" / "celeba_256").glob("sample_*.png"))
            check(len(pngs) == BATCH_256, f"CLI wrote {len(pngs)} PNGs, expected {BATCH_256}")
            head = pngs[0].read_bytes()[:24]
            check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[16:24] == (256).to_bytes(4, "big") * 2,
                  "CLI PNG is not a 256x256 PNG")
        finally:
            os.chdir(cwd)
    check(main256_launches == {"down2x": 20, "up2x": 20, "pair_conv3x3": 46},
          f"256² CLI run: {main256_launches}")
    print(f"CLI (CelebA-HQ 256): {len(pngs)} PNGs, launches {main256_launches}")

    phase("16 CelebA-HQ 256 timing")
    results256 = {}
    for label, net in (("bf16", net2_16), ("f32", net2_32)):
        call = test_cli.make_sampler(cfg2, net, BATCH_256, dev,
                                     torch.Generator(device=dev).manual_seed(6))
        results256[label] = sampler_ms(call, warmup=2, iters=5)
        print(f"sampler 256² {label}: {results256[label]:.3f} ms per T=2 call at batch "
              f"{BATCH_256} = {BATCH_256 / results256[label] * 1e3:.2f} samples/s")
    pair_rows = []
    for i, (c, s) in enumerate(PAIR_CONVS):
        shp = (BATCH_256, c, s, s)
        bufs = rotation(shp, torch.bfloat16, BATCH_256 * 64 * s * s, seed=7 + i)
        g = torch.Generator(device=dev).manual_seed(200 + i)
        wt = torch.randn((64, c, 3, 3), generator=g, device=dev) / math.sqrt(9 * c)
        b = torch.randn((64,), generator=g, device=dev)
        w16, b16 = wt.to(torch.bfloat16), b.to(torch.bfloat16)
        iters = max(20, len(bufs))
        with torch.no_grad():
            k_ms = device_ms(lambda x: pair_conv.pair_conv3x3(x, wt, b), bufs, iters)
            p_ms = device_ms(lambda x: pair_conv.pair_conv3x3_ref(x, wt, b), bufs, iters)
            l_ms = device_ms(lambda x: F.conv2d(x, w16, b16, padding=1), bufs, iters)
            want_k = pair_conv.pair_conv3x3_ref(bufs[0], wt, b).float()
            same = (F.conv2d(bufs[0], w16, b16, padding=1).float() - want_k).abs().max().item()
        check(same <= 2e-2 * want_k.abs().max().item(),
              f"library call for pair_conv3x3 computes another function ({same})")
        b_ms, b_by = pair_bound_ms(shp)
        pair_rows.append({"model": "celeba256", "shape": list(shp), "dtype": "bfloat16",
                          "per_forward": PAIR_CONVS[(c, s)], "ms": k_ms, "plain_ms": p_ms,
                          "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by})
        print(f"pair_conv3x3 {shp}: kernel {k_ms:.4f} ms, plain {p_ms:.4f}, library "
              f"{l_ms:.4f}, bound {b_ms:.4f} ({b_by}); kernel at "
              f"{2 * BATCH_256 * s * s * 64 * 9 * c / k_ms / 1e9:.1f} TFLOP/s, "
              f"{b_ms / k_ms:.1%} of its bound")
        del bufs
    fir_rows256 = time_fir_kernels(fir2x, {"down2x": DOWN_SHAPES_256, "up2x": UP_SHAPES_256},
                                   "celeba256")

    phase("17 where the 256² sampler's time goes (torch.profiler, bf16)")
    profile256 = profile_sampler(test_cli.make_sampler(
        cfg2, net2_16, BATCH_256, dev, torch.Generator(device=dev).manual_seed(8)),
        results256["bf16"])


    phase("19 FIR gradients against autograd through the plain versions (first and second order)")
    grad_cases = ([("down2x", s) for s in D_LARGE_DOWN + D_SMALL_DOWN + DOWN_SHAPES]
                  + [("down2x", (TRAIN_BATCH_256,) + s[1:]) for s in DOWN_SHAPES_256]
                  + [("up2x", s) for s in UP_SHAPES]
                  + [("up2x", (TRAIN_BATCH_256,) + s[1:]) for s in UP_SHAPES_256]
                  # odd sides: a down2x output of 3 x 5 (its VJP an odd-sided up2x)
                  + [("down2x", (2, 3, 6, 10)), ("up2x", (1, 2, 5, 7))])
    check_fir_grads(fir2x, grad_cases, max_abs)

    phase("20 pair_conv3x3 VJP against autograd through its plain version, batch 4")
    pair_train_shapes = [(TRAIN_BATCH_256, c, s_, s_) for (c, s_) in PAIR_CONVS]
    max_abs["pair_conv3x3.dx"] = check_pair_vjp(pair_conv, pair_train_shapes)
    x = torch.zeros((1, 64, 128, 128), device=dev, dtype=torch.bfloat16)
    try:
        pair_conv.pair_conv3x3(x.float().requires_grad_(), torch.zeros((64, 64, 3, 3), device=dev),
                               torch.zeros((64,), device=dev))
    except ValueError:
        print("an ungated input that needs a gradient still raises ValueError")
    else:
        raise AssertionError("pair_conv3x3 took an f32 input")

    phase("21 CelebA-HQ 256 G and DiscriminatorLarge, full width")
    from ddgan_torch.models import build_discriminator

    tcfg = cfg2.replace(dropout=0.0)
    tcfg32 = tcfg.replace(compute_dtype="float32")
    # N(0,1)/sqrt(fan_in) weights for the GPU-vs-CPU check (the recipe's
    # init gives G an output of ~0, which would make it vacuous), and the
    # recipe's own init, drawn from seeds, for the runs that train
    g_sd = randomize_parameters_(NCSNpp.from_config(tcfg32), seed=11).state_dict()
    d_sd = randomize_parameters_(build_discriminator(tcfg32), seed=12).state_dict()
    gi_sd = NCSNpp.from_config(tcfg32, generator=torch.Generator().manual_seed(11)).state_dict()
    di_sd = build_discriminator(tcfg32, generator=torch.Generator().manual_seed(12)).state_dict()
    n_g_params = sum(v.numel() for v in g_sd.values())
    n_d_params = sum(v.numel() for v in d_sd.values())
    print(f"G {n_g_params} parameters, DiscriminatorLarge {n_d_params} parameters")

    phase("22 one 256² train step (D and G update, R1) in f32: GPU (TF32 off) against the CPU, batch 2")
    step_cmp256 = compare_step_gpu_cpu(tcfg32, g_sd, d_sd, batch=2, seed=13)

    phase("23 the CelebA-HQ 256 recipe in bf16 at batch 4 from its init: 11 steps, launches by "
          "role, f32 trajectory")
    real256 = real_batch(tcfg, TRAIN_BATCH_256, 14).to(dev)
    # At the recipe's lr the first Adam step moves D's output by tens and
    # the bf16 and f32 runs separate after step 0 (phase 23b shows why); the
    # bf16-vs-f32 trajectory is held at lr 1e-7, where what differs is the
    # arithmetic of each step.
    traj = {}
    train_paths = {}
    runs = (("recipe_bf16", "bfloat16", TRAIN_STEPS_256, None),
            ("small_lr_bf16", "bfloat16", 6, TRAJ_LR), ("small_lr_f32", "float32", 6, TRAJ_LR))
    for run, dt_name, n_steps, lr in runs:
        st, stp = build_trainer(tcfg, gi_sd, di_sd, dev, dt_name)
        rng = torch.Generator(device=dev).manual_seed(15)
        losses = []
        for i in range(n_steps):
            reset_counts()
            m = stp(st, real256, rng, lr or tcfg.lr_g, lr or tcfg.lr_d)
            torch.cuda.synchronize()
            vals = [float(v) for v in m]
            check(all(np.isfinite(vals)), f"{run} step {i}: {vals}")
            losses.append((vals[0], vals[3]))
            if run == "recipe_bf16":
                r1 = i % tcfg.lazy_reg == 0
                check(r1 == (vals[4] > 0), f"step {i}: penalty {vals[4]}")
                want = expected_fir_calls(6, len(tcfg.ch_mult) - 1, r1, shared=True)
                calls = {k: dict(v) for k, v in fir2x.CALLS.items()}
                check(calls == want, f"step {i} FIR calls {calls}, expected {want}")
                check(fir2x.LAUNCHES == {k: sum(v.values()) for k, v in want.items()},
                      f"step {i}: FIR launches {fir2x.LAUNCHES}")
                check(pair_conv.CALLS == {"forward": 46, "dx": 18, "dx_library": 5}
                      and pair_conv.LAUNCHES["pair_conv3x3"] == 64,
                      f"step {i}: pair_conv3x3 {pair_conv.CALLS} {pair_conv.LAUNCHES}")
                if i in (0, 1):
                    train_paths["celeba256_train_" + ("r1" if r1 else "plain")] = {
                        "fir": calls, "pair_conv3x3": dict(pair_conv.CALLS)}
        finite = all(bool(torch.isfinite(p_).all()) for m_ in (st.gen, st.disc)
                     for p_ in m_.parameters())
        check(finite, f"{run}: parameters not finite")
        traj[run] = losses
        print(f"{run} losses (errD, errG): {[(round(a, 5), round(b, 5)) for a, b in losses]}")
        if run == "recipe_bf16":
            train256 = (st, stp)
        else:
            del st, stp
    traj_diff = float(np.abs(np.asarray(traj["small_lr_bf16"])
                             - np.asarray(traj["small_lr_f32"])).max())
    print(f"bf16 vs f32 over 6 steps at lr {TRAJ_LR}: max |Δloss| {traj_diff:.4g}; launches "
          f"per step {json.dumps(train_paths)}")
    check(traj_diff < 5e-2, f"bf16 trajectory left f32: {traj_diff}")

    phase("23b the recipe's step 0 at its lr: bf16 with the kernels and with their plain "
          "versions, f32, and D's gradient swapped between them")
    attribution = first_step_attribution(tcfg, gi_sd, di_sd, real256, fir2x, pair_conv)

    phase("24 the flagship train step: f32 GPU vs CPU at batch 4, then bf16 at batch 64 from "
          "its init")
    fcfg = cfg.replace(dropout=0.0)
    fcfg32 = fcfg.replace(compute_dtype="float32")
    fg_sd = randomize_parameters_(NCSNpp.from_config(fcfg32), seed=16).state_dict()
    fd_sd = randomize_parameters_(build_discriminator(fcfg32), seed=17).state_dict()
    print(f"flagship G {sum(v.numel() for v in fg_sd.values())} parameters, "
          f"DiscriminatorSmall {sum(v.numel() for v in fd_sd.values())} parameters")
    step_cmp32 = compare_step_gpu_cpu(fcfg32, fg_sd, fd_sd, batch=4, seed=18)
    fgi_sd = NCSNpp.from_config(fcfg32, generator=torch.Generator().manual_seed(16)).state_dict()
    fdi_sd = build_discriminator(fcfg32, generator=torch.Generator().manual_seed(17)).state_dict()
    fst, fstep = build_trainer(cfg, fgi_sd, fdi_sd, dev, "bfloat16")  # the recipe: dropout 0.1
    freal = real_batch(cfg, TRAIN_BATCH, 19).to(dev)
    frng = torch.Generator(device=dev).manual_seed(20)
    for i in range(3):
        reset_counts()
        m = fstep(fst, freal, frng, cfg.lr_g, cfg.lr_d)
        torch.cuda.synchronize()
        vals = [float(v) for v in m]
        r1 = i % cfg.lazy_reg == 0
        want = expected_fir_calls(3, len(cfg.ch_mult) - 1, r1, shared=False)
        calls = {k: dict(v) for k, v in fir2x.CALLS.items()}
        check(all(np.isfinite(vals)) and r1 == (vals[4] > 0), f"flagship step {i}: {vals}")
        check(calls == want and fir2x.LAUNCHES == {k: sum(v.values()) for k, v in want.items()},
              f"flagship step {i}: FIR calls {calls}, expected {want}")
        check(pair_conv.LAUNCHES["pair_conv3x3"] == 0, "flagship step launched pair_conv3x3")
        if i in (0, 1):
            train_paths["flagship_train_" + ("r1" if r1 else "plain")] = {
                "fir": calls, "pair_conv3x3": dict(pair_conv.CALLS)}
        print(f"flagship bf16 step {i}: errD {vals[0]:.4f} errG {vals[3]:.4f} "
              f"penalty {vals[4]:.3g}; FIR {calls}")
    check(all(bool(torch.isfinite(p_).all()) for p_ in fst.gen.parameters()), "flagship params")

    phase("25 train-step timing (bf16) and each kernel's time by role")
    st, stp = train256
    train_times = {
        "celeba256": {**time_steps(st, stp, real256, torch.Generator(device=dev).manual_seed(21)),
                      "batch": TRAIN_BATCH_256},
        "flagship": {**time_steps(fst, fstep, freal, torch.Generator(device=dev).manual_seed(22)),
                     "batch": TRAIN_BATCH},
    }
    for model, t_ in train_times.items():
        for label in ("r1_step", "plain_step"):
            t_[label.replace("step", "samples_per_s")] = t_["batch"] / t_[label] * 1e3
        print(f"{model} bf16 train step: R1 {t_['r1_step']:.3f} ms, other "
              f"{t_['plain_step']:.3f} ms ({t_['plain_samples_per_s']:.2f} samples/s at batch "
              f"{t_['batch']}); peak memory {t_['peak_memory_gb']:.2f} GB")
    recorded = {}
    for model, (s_, f_, x_) in (("celeba256", (st, stp, real256)), ("flagship", (fst, fstep, freal))):
        for label, counter in (("r1", 0), ("plain", 1)):
            s_.step = counter
            with LaunchRecorder(fir2x, pair_conv) as rec:
                f_(s_, x_, torch.Generator(device=dev).manual_seed(23), 1e-4, 1e-4)
            torch.cuda.synchronize()
            recorded[f"{model}_{label}"] = rec.counts()
    role_times = time_launches(fir2x, pair_conv, recorded)
    for key, per_step in sorted(role_times.items()):
        for step_name, r in per_step.items():
            print(f"{key} {step_name}: {r['launches']} launches, {r['ms']:.4f} ms per step, "
                  f"bound {r['bound_ms']:.4f} ({r['bound_by']}), plain {r['plain_ms']:.4f}, "
                  f"library {r['library_ms']:.4f}")

    phase("26 where the 256² train step's time goes (torch.profiler, bf16, two steps)")
    st.step = 9  # a warm-up step, then an R1 step (10) and another (11) under the profiler
    train_profile = profile_steps(
        lambda: stp(st, real256, torch.Generator(device=dev).manual_seed(24), 1e-4, 1e-4),
        (train_times["celeba256"]["r1_step"] + train_times["celeba256"]["plain_step"]) / 2,
        fir2x, pair_conv)
    print(f"{train_profile['kernel_launches_per_step']} kernel launches per 256² step "
          f"(mean of an R1 step and another)")

    phase("27 the flagship through the quality soak tool at full width: train_cli killed after "
          "one epoch, resumed, sampled, snapshot, one EMA FID point")
    del train256, st, stp, fst, fstep
    torch.cuda.empty_cache()
    keep = Path(tempfile.mkdtemp(prefix="flagship_loop_"))  # phase 37's Adam run
    atexit.register(shutil.rmtree, keep, ignore_errors=True)  # also when a phase fails
    flagship_loop, loop_cfg, soak_launches = flagship_soak(
        train_times["flagship"], fir2x, pair_conv, sampler_launches, keep)
    loops = {"flagship": flagship_loop}

    phase("28 the CelebA-HQ 256 recipe through main_cli at full width, sampled at 256²")
    loops["celeba256"] = loop_through_main_cli(
        cfg2.replace(dataset="synthetic", exp="celeba256_loop", batch_size=TRAIN_BATCH_256,
                     limited_iter=LOOP_ITERS_256, num_epoch=LOOP_EPOCHS_256, save_ckpt_every=1),
        train_times["celeba256"], fir2x, pair_conv, k2_per_step={"forward": 46, "dx": 18,
                                                                 "dx_library": 5},
        sample_launches=bf16_launches)
    print_loops(loops)
    train_paths.update({"flagship_train_cli_resumed": loops["flagship"]["launches"],
                        "celeba256_main_cli": loops["celeba256"]["launches"]})

    phase("29 FID-InceptionV3 on the card: GPU (f32, TF32 off) against the CPU; its time")
    from ddgan_torch.eval import inception as inc

    evals = {"inception": check_inception(inc, dev)}

    phase("30 main path: the sampler CLI with --compute_fid, full-width flagship, "
          f"{FID_SAMPLES} samples")
    evals["compute_fid"] = fid_cli_run(cfg, flag_sd, dev, reset_counts, counts)

    phase(f"31 Inception Score of {IS_SAMPLES} CelebA-HQ 256 samples (bf16 sampler, IS CLI)")
    evals["inception_score"] = is_run(cfg2, net2_16, dev, reset_counts, counts)

    phase("32 the swarm update at full width: DiscriminatorSmall on the card against the CPU, "
          "then G's and D's timed")
    pso_runs = {"swarm_update": swarm_update_check(cfg, dev)}
    torch.cuda.empty_cache()

    phase("33 the flagship PSO step at full width: three f32 steps on the card against the CPU "
          "(swarm 3, trigger 2)")
    pso_runs["step_gpu_vs_cpu"] = pso_step_check(fcfg, fg_sd, fd_sd, dev)
    torch.cuda.empty_cache()

    phase("34 the flagship PSO loop through train_cli at full width (bf16, batch 64), sampled")
    pso_cfg = cfg.replace(dataset="synthetic", exp="flagship_pso", kind_of_optim="pso",
                          limited_iter=PSO_LOOP_ITERS, num_epoch=1, save_content=False,
                          save_ckpt_every=1)
    pso_runs["loop"] = pso_loop_through_train_cli(pso_cfg, fir2x, pair_conv, sampler_launches)
    train_paths["flagship_pso_train_cli"] = pso_runs["loop"]["launches"]
    torch.cuda.empty_cache()

    phase(f"35 PSO resume at nf {PSO_RESUME_NF}: two epochs with content.pth, then --resume")
    pso_runs["resume"] = pso_resume(
        pso_cfg.replace(exp="pso_resume", num_channels_dae=PSO_RESUME_NF, ngf=PSO_RESUME_NF,
                        limited_iter=PSO_RESUME_ITERS, save_content=True), fir2x, pair_conv)
    torch.cuda.empty_cache()

    phase("36 the PSO hyperparameter search in process on the card (the shipped config, "
          "synthetic data)")
    pso_runs["hpo"] = hpo_search(fir2x, pair_conv)
    train_paths["pso_hpo_search"] = pso_runs["hpo"]["launches"]
    torch.cuda.empty_cache()

    phase("37 content.pth -> content.ckpt -> content.pth of phase 27's run; train_cli --resume "
          "from content.ckpt")
    pso_runs["content_round_trip"] = content_round_trip(keep, loop_cfg.replace(dataset="synthetic"))
    shutil.rmtree(keep)

    phase("38 FIR kernels at the pyramids' 3-channel shapes: forward and gradients against "
          "their plain versions, and their times")
    pyr = [(b, 3, s_, s_) for b in (BATCH_256, BATCH) for s_ in PYRAMID_SIDES]
    check_fir_kernels(fir2x, {"down2x": pyr, "up2x": pyr}, max_abs)
    check_fir_grads(fir2x, [(k, s_) for k in ("down2x", "up2x") for s_ in pyr], max_abs)
    # a pyramid plane is a few MB at most, just written by the op before: L2-warm
    pyramid_rows = time_fir_kernels(fir2x, {"down2x": PYRAMID_DOWN, "up2x": PYRAMID_UP},
                                    "pyramid", dtypes=(torch.bfloat16,), max_copies=4)

    phase("39 every generator option family at flagship width: f32 GPU vs CPU, bf16 launches")
    families = family_forwards(Config, dev, fir2x, pair_conv)

    phase("40 pyramid_sum at the CelebA-HQ 256 recipe: sampler, f32 step against the plain "
          "versions, bf16 steps by role, times beside the recipe's")
    pyramid256 = pyramid_sum_256(cfg2, d_sd, gi_sd, di_sd, net2_16, results256["bf16"],
                                 train_times["celeba256"], dev, fir2x, pair_conv)
    train_paths.update(pyramid256["train_paths"])
    torch.cuda.empty_cache()

    phase("41 pyramid_sum at flagship width through train_cli: two epochs, --resume, sampled")
    fam_loop_cfg = family_config(cfg, "pyramid_sum").replace(
        dataset="synthetic", exp="pyramid_sum_loop", limited_iter=FAMILY_LOOP_ITERS,
        num_epoch=1, save_ckpt_every=1)
    fam_sample = {k: T * v for k, v in expected_g_fir(len(cfg.ch_mult) - 1,
                                                      **FAMILY_FIR["pyramid_sum"]).items()}
    families["pyramid_sum_train_cli"] = family_loop_through_train_cli(
        fam_loop_cfg, "pyramid_sum", fir2x, pair_conv, {**fam_sample, "pair_conv3x3": 0})
    train_paths["pyramid_sum_train_cli_resumed"] = families["pyramid_sum_train_cli"]["launches"]
    torch.cuda.empty_cache()

    phase("42 the bridges with a buffer: a Fourier generator's Adam and PSO states through "
          "content.ckpt and back, and its netG_*.ckpt")
    families["bridges"] = buffer_bridges(Config, dev)

    phase("43 the legacy layer library and fused_act on the card against the CPU")
    families["legacy"] = legacy_on_card(dev)

    phase("44 collectives on the card: a size-1 NCCL group over the flagship G's parameter "
          "count, and a 2-process gloo probe on CUDA tensors")
    import torch.distributed as dist

    par_tmp = Path(tempfile.mkdtemp(prefix="collectives_"))
    atexit.register(shutil.rmtree, par_tmp, ignore_errors=True)
    n_flagship = sum(p_.numel() for p_ in NCSNpp.from_config(cfg).parameters())
    parallel = {"collectives": collectives_on_card(n_flagship, dev, par_tmp)}

    phase("45 the flagship under the size-1 NCCL group: group-less, replicated and ZeRO-1, "
          "four bf16 steps at batch 64, ZeRO-1 in f32 too, then their times in turns")
    try:
        parallel["group_steps"] = group_steps(cfg, dev, fir2x, pair_conv, train_paths)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    phase("46 two ranks over gloo sharing the card: the flagship through init_processes and "
          "loop.train, one epoch; the first step against an emulation; resumed, sampled")
    parallel["two_ranks"] = two_ranks_on_card(cfg, dev, fir2x, pair_conv,
                                              parallel["collectives"]["gloo_cuda"],
                                              sampler_launches, train_paths)
    torch.cuda.empty_cache()

    phase("47 the JPEG decoder and both resize filters against PIL on this host")
    from PIL import Image

    image_files = {"jpeg": jpeg_against_pil(Image), "resize": resize_against_pil(Image)}

    phase("48 the CelebA-HQ 256 recipe on `custom` JPEGs through main_cli at full width "
          "(do_resize, crop), sampled at 256²")
    image_files["custom_256"] = custom_run(Image, cfg2, train_times["celeba256"], fir2x,
                                           pair_conv, bf16_launches)
    train_paths["celeba256_custom_main_cli"] = image_files["custom_256"]["launches"]
    torch.cuda.empty_cache()

    phase("49 the shipped luna16 config through main_cli on 256³ volumes, sampled; the loader "
          "with and without the volume cache; nii_to_png at 64²")
    image_files["luna16_shipped"] = luna16_run(Image, fir2x, pair_conv)
    train_paths["luna16_shipped_main_cli"] = image_files["luna16_shipped"]["launches"]
    torch.cuda.empty_cache()

    phase("50 the LMDB reader on this host: the tests' writer's files, ms per get at LSUN "
          "church train's size, the lmdb package where it imports")
    lmdb_writer = tests_helper("_torch_lmdb")
    lmdb_runs = {"reader": lmdb_on_host(lmdb_writer)}

    phase("51 the LSUN Church Outdoor 256 recipe from an LMDB through main_cli at full width "
          "(bf16, batch 8, T=4): two epochs, resumed, sampled at 256²")
    cfg_lsun = lsun256_config(Config)
    lmdb_runs["lsun256"] = lsun_run(Image, lmdb_writer, cfg_lsun, fir2x, pair_conv)
    train_paths["lsun256_main_cli"] = lmdb_runs["lsun256"]["launches"]
    train_paths["lsun256_main_cli_resumed"] = lmdb_runs["lsun256"]["after"]["launches"]
    torch.cuda.empty_cache()

    phase("52 celeba_256 from a 27,000-key LMDB through make_dataset; a raw-mode LMDB")
    lmdb_runs["celeba_256"] = celeba_lmdb_run(Image, lmdb_writer)

    phase("53 remat on the card: the lsun256 bf16 step at batch 8 off, full and save-convs, "
          "bit for bit and timed in turns")
    lmdb_runs["remat"] = remat_on_card(cfg_lsun, dev, fir2x, pair_conv)
    torch.cuda.empty_cache()

    phase("53b the sampler CLI over two gloo ranks sharing the card: an FID set of "
          f"{RANKS_FID_SAMPLES} and plain sampling of {RANKS_PLAIN_BATCH}")
    lmdb_runs["sampler_cli_ranks"] = sampler_cli_over_ranks(cfg, flag_sd, dev)

    phase("54 the WebP decoder against PIL on this host: the tests' matrix, malformed files, "
          "ms per 341x256 lossy image")
    lmdb_runs["webp"] = webp_against_pil(Image)

    phase("55 the LSUN Church Outdoor 256 recipe from an LMDB of WebP values through main_cli "
          "(bf16, batch 8, T=4): one epoch, sampled at 256²")
    lmdb_runs["lsun256_webp"] = lsun_run(Image, lmdb_writer, cfg_lsun, fir2x, pair_conv,
                                         fmt="webp", resume_run=False)
    train_paths["lsun256_webp_main_cli"] = lmdb_runs["lsun256_webp"]["launches"]
    print(f"loader share of the bare step: WebP "
          f"{100 * lmdb_runs['lsun256_webp']['loader_share_of_bare_step']:.1f}%, JPEG (phase 51) "
          f"{100 * lmdb_runs['lsun256']['loader_share_of_bare_step']:.1f}%")
    torch.cuda.empty_cache()

    phase("56 BMP, PBM/PGM/PPM, TIFF (CCITT, JPEG, LZMA, BigTIFF, float and signed samples "
          "among them), progressive, arithmetic and 4:4:0 / 4:1:1 JPEG, PNG at every depth "
          "against PIL on this host: the tests' matrices, malformed and refused files, ms an "
          "image")
    image_files["formats"] = image_formats_against_pil(Image, smi)

    phase("57 result")
    main_paths = {"flagship_cli": main_launches, "celeba256_cli": main256_launches,
                  "flagship_compute_fid": evals["compute_fid"]["launches"],
                  "flagship_quality_soak_fid": soak_launches,
                  "celeba256_inception_score": evals["inception_score"]["launches"],
                  "pyramid_sum_celeba256_sampler": pyramid256["sampler_launches"],
                  **{f"{f}_flagship_forward_bf16": r["launches_bf16"]
                     for f, r in families.items() if "launches_bf16" in r}}
    train_forward = {path: {**{k: v["forward"] for k, v in c["fir"].items()},
                            "pair_conv3x3": c["pair_conv3x3"]["forward"]}
                     for path, c in train_paths.items()}
    entries = []
    for name in ("down2x", "up2x", "pair_conv3x3"):
        if name == "pair_conv3x3":
            # per CelebA-HQ 256 generator forward: each shape as often as it runs
            rows = pair_rows
            total = {key: sum(r[key] * r["per_forward"] for r in rows)
                     for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        else:
            # per generator forward of each model: each shape once in bf16
            # (the h path) and once in f32 (the skip x path)
            rows = fir_rows[name] + fir_rows256[name]
            total = {key: sum(r[key] for r in rows)
                     for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        by_path = {**{k: p_[name] for k, p_ in main_paths.items()},
                   **{k: p_[name] for k, p_ in train_forward.items()}}
        entries.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max_abs[name],
            **total,
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
            "shapes": rows,
            **({"pyramid_shapes": pyramid_rows[name]} if name in pyramid_rows else {}),
        })
    # the backward roles: times per CelebA-HQ 256 bf16 R1 step (the other
    # steps in "per_step"); launches over the four driven train steps
    role_err = {"up2x.backward": max_abs["down2x.grad"], "down2x.backward": max_abs["up2x.grad"],
                "down2x.second_order": max(max_abs["down2x.grad"], max_abs["up2x.grad"]),
                "pair_conv3x3.dx": max_abs["pair_conv3x3.dx"]}
    for key in ("up2x.backward", "down2x.backward", "down2x.second_order", "pair_conv3x3.dx"):
        kernel, role = key.split(".")
        by_path = {}
        for path, c in train_paths.items():
            by_path[path] = (c["pair_conv3x3"]["dx"] if kernel == "pair_conv3x3"
                             else c["fir"][kernel][role])
        r = role_times[key]["celeba256_r1"]
        entries.append({
            "name": key,
            "route": "cuda",
            "source": SOURCES[kernel],
            "replaces": REPLACES_BWD[key],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": role_err[key],
            **{f: r[f] for f in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by")},
            "per_step": role_times[key],
        })
    print(json.dumps({
        "flagship": {"sampler_ms": results, "batch": BATCH, "steps": T,
                     "samples_per_s": {k: BATCH / v * 1e3 for k, v in results.items()},
                     "gpu_vs_cpu_max_abs": sampler_err, "profile": profile},
        "celeba256": {"sampler_ms": results256, "batch": BATCH_256, "steps": T_256,
                      "samples_per_s": {k: BATCH_256 / v * 1e3 for k, v in results256.items()},
                      "parameters": n_params2, "gpu_vs_cpu_max_abs": err256,
                      "bf16_vs_f32_max_abs": bf16_err, "profile": profile256},
        "train": {"times": train_times, "launches_by_path": train_paths, "loops": loops,
                  "gpu_vs_cpu_step": {"celeba256": step_cmp256, "flagship": step_cmp32},
                  "bf16_vs_f32_max_abs_dloss": traj_diff, "first_step_attribution": attribution,
                  "trajectories": traj, "parameters":
                  {"celeba256_G": n_g_params, "celeba256_D": n_d_params},
                  "roles": role_times, "profile": train_profile},
        "eval": evals,
        "pso": pso_runs,
        "families": {**families, "pyramid_sum_celeba256": pyramid256},
        "parallel": parallel,
        "image_files": image_files,
        "lmdb_remat_ranks": lmdb_runs,
        "build_s": build_s,
        "phase_s": PHASE_S,
    }))
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
