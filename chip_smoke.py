"""Smoke run of the PyTorch port (afan_torch) on one CUDA card.

Run from the repository root, with one card and no arguments:

    python3 chip_smoke.py

``--only nms`` runs phases 1-3, 5 and the NMS timings of phase 6 (the
greedy-NMS kernel alone, no server); ``--only ce`` runs phases 1, 2, 7 and
the kernel timings of phase 10 (the upsample + CE kernels alone, no
trainer); ``--only seg`` phases 1, 2 and
7-10; ``--only det`` phases 1-6; ``--only cls`` phases 1, 2 and 11-14 (phase
11 then lacks the segmentation ascents' shapes); ``--only dettrain`` phases
1, 2 and 15-17; ``--only scan`` phases 1, 2, 18-21 and 52-54; ``--only
variants``
phases 1, 2 and 22-26; ``--only bf16`` phases 1, 2 and 27-29; ``--only
detbf16`` phases 1, 2 and 30-32; ``--only clsbf16`` phases 1, 2 and 33-35;
``--only eval`` phases 1, 2 and 36-39; ``--only mobilenet`` phases 1, 2
and 40-42; ``--only coco`` phases 1, 2 and 43-46; ``--only data`` phases 1,
2 and 47-51; ``--only dp`` phases 1, 2 and 55-58; ``--only spatial``
phases 1, 2 and 59-62 (in a whole run phases 56 and 60 share one launch of
their two ranks, and phase 59 takes phase 55's f32 seg runs); ``--only
remat`` phases 1, 2 and 63-67.
The kernels
line then lists the kernels of the phases that ran; without phase 8 the
upsample + CE kernels have no launch count (null), and under ``--only
variants`` only the PGD update has times.

Phases (any failure exits non-zero):
  1. the device: name, power limit, TF32 settings;
  2. build the hand-written CUDA kernels from afan_torch/csrc, one nvcc per
     source, all at once;
  3. hold the greedy-NMS kernel against its plain PyTorch version on the
     card: the reference's golden fixture, uniform and clustered boxes
     (N = 12000 too), invalid slots, plus_one off, a batched call, and the
     edges of its per-word scan (NMS_EDGE_CASES) — keep masks equal;
  4. serve frames through the detection server's FrameBatcher with the
     ResNet-50 Faster R-CNN at full width (seeded random weights, 21 VOC
     classes, canvas 608x1008, max_batch 4), in batches of 1 and 4, and
     check the answers and that the main path launched the kernel;
  5. hold the post-backbone path with the kernel against the same path with
     the plain NMS: proposals and keep masks identical;
  6. time the detect call and the peak memory, and the NMS kernel (CUDA
     events; each pass's device time from torch.profiler), its plain
     version and its bound at the detect call's two NMS calls, then the
     kernel where most boxes are kept (G=4, N=6000 uniform) and at the
     training proposal NMS (G=1 and 4, N=12000, uniform and clustered);
  7. hold the upsample + CE forward and backward kernels against their
     plain version on eleven geometries (city768 at B=2 and B=8, city512,
     voc513 with odd H, two focal cases, tiny32, 9x7 -> 33x28, 1x1 -> 4x4,
     6x5 -> 24x20, an entry whose labels are all 255): sums within 1e-5,
     gradient within 1.1e-5 (max abs error over max abs value), two runs
     bit-equal;
  8. train the A-FAN DeepLabv3+ ResNet-50 at full width through
     ``afan_torch.cli.train_segment.main`` (Cityscapes final recipe: OS 16,
     19 classes, crop 768, batch 4, SE tap 2 with AFN on the spectrum's
     adversarial point, SD concat, mix_sd, synthetic data, seeded random
     weights) for a few iterations and one validation: finite losses, a
     checkpoint, and the kernels' launch counts;
  9. one A-FAN step with the kernels against one with the plain op, from
     the same weights, batch and dropout masks (cuDNN deterministic, no
     TF32): losses within 1e-4, logits-conv gradient within 1e-4;
 10. time the A-FAN and base steps and their peak memory, profile where
     the A-FAN step's device time goes, and time each upsample + CE kernel
     in turns with the library composition F.interpolate + F.cross_entropy
     (library, kernel, kernel, library, twice) and its plain version at the
     step's shapes, with what ptxas and the card report of each kernel
     (registers, shared memory, spills, blocks per SM);
 11. hold the PGD-update kernel against its plain PyTorch version, bit for
     bit (NaN included): the sizes of tests/test_kernels.py, odd counts,
     misaligned views, the ALFA and learnable tap shapes and the
     segmentation ascents' shapes, gradients with zeros, -0, denormals, NaN
     and infinities, with and without the clip;
 12. train ALFA ResNet-56 on CIFAR-10 at full width through
     ``afan_torch.cli.train_classify.main`` (batch 128, tap 13, 5 PGD
     steps, synthetic data, seeded random weights) for a few batches, one
     validation and one test pass: finite losses, the reference's four
     output files, and exactly 5 kernel launches per step; then a few
     batches of the learnable-eta mode (27 launches per step) and of ALFA
     with clip, randinit and the train split kept on the card; then the
     inference CLI on the best checkpoint;
 13. one ALFA step with the kernel against one with the plain update, from
     the same weights and batch (cuDNN deterministic, no TF32): adversarial
     feature bit-equal, loss, perturbation norms and updated parameters
     within 1e-6;
 14. time the ALFA, base and learnable steps and their peak memory, the
     ALFA step with the plain update in turns with the kernel, profile
     where the ALFA step's device time goes, and time the kernel, its plain
     version and its bound at the ALFA tap shape;
 15. train the A-FAN Faster R-CNN ResNet-50 at full width through
     ``afan_torch.cli.train_detect.main`` (VOC final setting 1: batch 8,
     canvas 608x1008, 12000 -> 2000 proposals at 0.7, SE tap 2 with AFN on
     the upper spectrum points, SD on the pooled ROI vector; synthetic VOC,
     seeded random weights, the torso through ``--pretrained_backbone``
     with its frozen-BatchNorm statistics fitted on a synthetic batch, as
     an ImageNet torso's fit its data) for a few steps, resume one more step from its
     checkpoint, train the baseline for two, each run ending with the VOC
     mAP of the 16 test images: finite losses, the checkpoints, and the
     proposal-NMS and PGD-update launches of every step (2 and 2 per A-FAN
     step, 1 and 0 per baseline step) and of each eval (2 per image);
 16. one A-FAN detection step with the NMS and PGD-update kernels against
     one with their plain versions, from the same weights, batch and seeded
     draws (cuDNN deterministic, no TF32): proposal keep masks identical,
     losses and updated parameters within 1e-4;
 17. time the A-FAN and baseline detection steps and their peak memory,
     the A-FAN step with each image's ROIs pooled from its own rows in
     turns with the contraction over all images' rows, profile where the
     A-FAN step's device time goes, and time the NMS
     kernel on the step's own proposals (G=8, N=12000) and the PGD update
     at the step's two ascent shapes, with their plain versions and bounds;
 18. train ALFA ResNet-56 at full width through
     ``train_classify.main --epoch_scan`` (batch 128, 24 steps per epoch):
     2 epochs, a resume for a third (step count 72, the lr of count 72), and
     one epoch with clip and randinit, then a whole epoch (351 steps);
     each run's first 3 steps are eager
     and the rest are replays of one captured CUDA graph of the step:
     finite losses, the checkpoints, 20 PGD-update launches counted by the
     wrapper (3 eager steps and the capture), and exactly 5 PGD-update
     kernels (5 clipped) per replay in a profiler trace of 6 more replays
     of each run's graph;
 19. 8 steps of the epoch scan (3 eager, 5 replays) against 8 eager
     device-data steps from the same weights, permutation and generator
     seed (cuDNN deterministic, no TF32): crop offsets and flips equal step
     by step, consecutive replays drawing anew, metrics, parameters and
     BatchNorm buffers within 1e-5;
 20. time the graphed ALFA step and the eager device-data step in turns
     (graph, eager, eager, graph, twice, 10 steps each), their peak
     memory (the graph's pool reserved), the host time per replay, the
     device busy share and kernels per step from profiles of 5 replays and
     of 3 eager steps;
 21. robust evaluation: the PGD update at the input shape (128, 32, 32, 3)
     against its plain version, bit for bit; a batch-128 PGD-3 robust-eval
     batch timed; ``infer_classify --pgd`` on the best checkpoint of
     phase 18's whole-epoch run:
     robust accuracy at most the clean one, 3 PGD-update launches per
     batch; the kernel, its plain version and bound at that shape;
 22. train the segmentation variants at full width through
     ``train_segment.main`` with phase 8's flags and ``--variant
     advtrain``, ``sat`` and ``sat_multi --mix_all`` (input PGD, extra SE
     taps 1, 2 and 4, the SAT and multi loss presets), 2 iterations and one
     validation each: finite losses, a checkpoint, and the upsample + CE
     and PGD-update launches of every step equal to what the step's config
     implies (``seg_launches_per_step``);
 23. train the detection variants at full width through
     ``train_detect.main`` with phase 15's flags and ``--variant
     advtrain``, ``sat``, ``multi`` and ``single``, 2 steps and the final
     mAP each: finite losses, the checkpoints, and the proposal-NMS and
     PGD-update launches of every step as the config implies
     (``det_launches_per_step``; ``advtrain`` samples in each of its 5
     ascent forwards and its loss forward);
 24. one segmentation ``sat_multi --mix_all`` step and one detection
     ``multi`` step with the kernels against the same step with the plain
     upsample + CE, NMS and PGD update, from the same weights, batch and
     seeded draws (cuDNN deterministic, no TF32): phase 9's and phase 16's
     checks; the segmentation step's input ascent is held apart first (its
     gradient within 1e-4), and its adversarial image is then shared by
     both steps, since a sign step turns float differences at near-zero
     gradient entries into whole steps on those pixels;
 25. the PGD-update shapes and clip modes that phases 22-24 record go to
     phase 11's bit-for-bit cases (with ``--only variants``, which skips
     phase 11, the same check runs here);
 26. time each variant step of phases 22 and 23 (median and p90 of 3
     steps, peak memory), and the PGD-update kernel at the two input
     shapes, clipped and unclipped, with its plain version and bound;
 27. train the segmentation recipes as written, ``--bf16`` included, at
     full width through ``train_segment.main``:
     ``recipes/seg_voc07_final1.sh`` (VOC, 21 classes, crop 513, batch 4)
     and ``recipes/seg_city_final.sh`` (Cityscapes, 19 classes, crop 768,
     batch 4), synthetic data, 2 iterations and one validation each: finite
     losses, a float32 checkpoint, a bf16-compute model, and per step the
     bf16 upsample + CE and PGD-update launches that
     ``seg_launches_per_step`` implies (every launch bf16); the share of
     each ascent's entries that the bf16 update changed (a step below half
     a bf16 ulp rounds back to x, as in ``afan``);
 28. the bf16 paths against their plain versions: the upsample + CE
     kernels on bf16 logits at the VOC, Cityscapes and B=8 shapes (sums
     within 1e-5 and equal to the f32 kernel's on the widened logits; the
     gradient the f32 kernel's rounded to bf16, bit for bit, and within
     1.1e-5 + 2^-8 of the plain version's), and the PGD update at phase 27's
     ascent shapes and step sizes, clipped and not, bit for bit;
 29. the Cityscapes recipe's A-FAN step with the model in bf16 in turns
     with the f32 step (median and p90, images per second, peak memory, the
     device's busy share and top kernels of each), and the bf16 kernels'
     times, bounds (bf16 bytes), plain versions and library compositions
     at the step's shapes;
 30. train the detection recipes as written, ``--bf16`` included, at full
     width through ``train_detect.main``: ``recipes/detect_voc07_baseline.sh``
     and ``detect_voc07_final_setting{1,2,3}.sh`` (ResNet-50, batch 8,
     608x1008; settings 2 and 3 change the SD gamma, 3 adds AFN on the SD
     point), synthetic VOC, phase 15's calibrated torso, 2 steps and the
     final mAP of the 16 test images each: a bf16-compute model with float32
     parameters, finite losses, a float32 checkpoint, and per step the
     proposal-NMS launches (on float32 boxes) and bf16 PGD-update launches
     that ``det_launches_per_step`` implies; the share of each ascent's
     entries that the bf16 update changed;
 31. one bf16 A-FAN detection step (setting 1) with the NMS and PGD-update
     kernels against one with their plain versions (phase 16's checks), the
     NMS kernel on that step's proposals, and the bf16 PGD update at each
     of phase 30's shapes and step sizes, clipped and not, bit for bit;
 32. the bf16 A-FAN detection step in turns with the f32 step from the same
     weights and batch (median, p90, peak memory, each one's profile: busy
     share and kernels per step), then the NMS kernel on the bf16 step's
     proposals and the bf16 PGD update at its SE and SD shapes, with plain
     versions and bounds;
 33. ``train_classify.main --bf16`` at full width in base, ALFA and
     learnable mode (2 steps, validation and test each) and ALFA with
     ``--epoch_scan`` (one epoch of 24 steps, the bf16 PGD-update kernels
     per replay counted in a profiler trace): a bf16-compute model with
     float32 parameters, finite losses, float32 checkpoints, every
     PGD-update launch bf16;
 34. the bf16 PGD update at phase 33's shapes (the ALFA tap, the learnable
     taps) and step sizes, clipped and not, bit for bit;
 35. the graphed bf16 ALFA step in turns with the graphed f32 one (peak
     memory, each one's profile), the eager bf16 base and learnable steps,
     and the bf16 PGD update at the ALFA tap;
 36. every ``eval_detect`` task at full width through
     ``afan_torch.cli.eval_detect.main`` (ResNet-50 Faster R-CNN, 21
     classes, canvas 608x1008, batch 1, eval NMS 6000 -> 300 at 0.7 and per
     class at 0.3; phase 15's calibrated torso and seeded heads through
     ``--checkpoint``; synthetic VOC): ``map`` on the 16 test images, ``rob``
     (PGD-3, 2/255, 8/255) on the first 2, ``sat_layers`` (tap 2, alpha
     0.5, with and without ``--mix``) on the first 4, ``sat_vis`` (spectrum
     5) on 2,
     ``input_surface`` at 8x8 points on 1 (its centre NaN), ``loss_vis``:
     mAPs, the PNG count, the pickled surface, the probe's losses, and the
     NMS and PGD-update launches of each run as its task implies;
 37. ``eval_segment`` through its ``main`` (DeepLabv3+ ResNet-50, OS 16,
     batch 1; seeded weights with BatchNorm statistics fitted on two VOC
     images, through ``--ckpt``): VOC (21 classes, crop 513, ``--crop_val``)
     ``--task miou`` with ``--save_val_results`` and ``--task pgd`` (3 steps,
     2/255, 8/255), plain and with ``--randinit_pgd --clip_pgd``; Cityscapes
     (19 classes, crop 768) ``--task pgd``; ``train_segment --test_only`` on
     the same checkpoint, whose mIoU must equal ``--task miou``'s; the
     upsample + CE and PGD-update launches of each run;
 38. the kernels at the evaluation shapes: NMS on the eval paths' own
     inputs (G=1, N=6000; per class G=20, N=300; N=12000 in the attack
     losses; the all-NaN proposals of the surface's centre image) and on NaN
     boxes (``NMS_NAN_CASES``), keep masks equal; the PGD update bit-equal
     at (1, 608, 1008, 3), (1, 512, 76, 126), (1, 513, 513, 3) and every
     shape the runs recorded, clipped and not; the upsample + CE at batch 1
     (``EVAL_CE_CASES``, Cityscapes' 1024x2048 validation image included)
     within phase 7's tolerances; then ``map``, ``rob`` and the VOC ``pgd``
     (1 and 3 steps) again with the plain versions patched in: mAP and the
     1-step mIoU equal, attacked images compared entry by entry;
 39. ms per image of each eval task (CUDA events, data loading left out),
     the ms per surface grid point, and each kernel at the new shapes with
     its plain version, bound and (upsample + CE) library composition;
 40. the DeepLab MobileNetV2 through ``train_segment.main`` at full width,
     2 iterations and a validation each, launch counts per step:
     ``recipes/seg_city_final.sh`` (crop 768, batch 4, ``--bf16``) and
     ``recipes/seg_voc07_final1.sh`` (crop 513, ``--separable_conv``) as
     written with ``--model deeplabv3plus_mobilenet``,
     ``deeplabv3_mobilenet --pertub_idx_sd aspp`` in f32, and
     ``--pretrained_backbone`` from a seeded torchvision-keyed ResNet-50
     ``.pth`` on ResNet-50 (100% of parameters and statistics logged) and
     on MobileNetV2 (0%, as ``afan``);
 41. one MobileNet A-FAN step with the kernels against one with the plain
     op (cuDNN deterministic, no TF32): losses and the logits-conv gradient
     within 1e-4; the upsample + CE at the MobileNet sites' shapes, f32 and
     bf16; the PGD update at every shape, step size and dtype of phase 40,
     bit for bit;
 42. the MobileNet A-FAN step in f32 and bf16 in turns (median, p90, peak
     memory, launches, profile), and the kernels at its shapes;
 43. ``recipes/detect_coco_final_setting.sh`` 1-6 as written through
     ``train_detect.main`` (``--bf16``, 800x1333, anchors [64, 128, 256,
     512], batch 8, synthetic COCO, 92 classes; phase 15's torso): 2 steps
     and the COCO-protocol score of the 16 test images each, launch counts
     per step and in the eval;
 44. ``recipes/detect_voc07_final_setting1.sh`` with ``--pertub_idx_sd
     rpn``, f32 and as written (``--bf16``), the same way;
 45. one sd=rpn A-FAN step with the NMS and PGD-update kernels against one
     with the plain versions (losses and updated parameters within 1e-4);
     the NMS kernel on that step's proposals and on the COCO runs' calls
     (the eval's per-class G=91, N=300 among them), keep masks equal; the
     PGD update at every shape of phases 43-44 and at the RPN tap on
     COCO's canvas, bit for bit;
 46. the COCO bf16 A-FAN step and the sd=rpn A-FAN step (median, p90, peak
     memory, launches, profile), the NMS kernel at the new shapes and the
     PGD update at the new ascent shapes, with plain versions and bounds;
 47. build the host image decoder (``csrc/imdecode.cpp``, ``c++``) and
     decode each committed fixture of ``tests/fixtures/torch_images``: its
     sha256 equals the manifest's (PIL's bytes);
 48. write dataset trees at the real sizes and layouts under
     ``checkpoints/chip_smoke_data/DATA``: Cityscapes (8 train and 2 val
     images at 1024x2048, RGB and ``_gtFine_labelIds`` PNGs, ids 0-33,
     rows filtered by the five PNG filter types in turn), VOC 2012
     segmentation (the fixture JPEGs, palette label PNGs with 255 borders),
     VOC 2007 detection (16 trainval, 4 test, wide and tall fixture JPEGs,
     one difficult object per test image) and COCO 2017 (8 train, 2 val,
     one crowd annotation per split); the decode ms per image (median of
     20) of a 500x375 JPEG and a 2048x1024 PNG on the host's CPU, and of a
     500x375 progressive JPEG, a 320x240 CMYK JPEG and a 500x375 Adam7
     label PNG;
 49. ``recipes/seg_city_final.sh``, ``seg_voc07_final1.sh``,
     ``detect_voc07_final_setting1.sh`` and ``detect_coco_final_setting.sh``
     setting 1 as written with DATA pointing at the trees (2 steps each,
     the Cityscapes one 4, two epochs of its images; a validation or the
     final score each; launch counts per step as in phases 27 and 43),
     each step's ms and the host's ms for its batch (the segmentation
     loop reads it between steps, the detection loop waits on its
     prefetch queue);
     then ``eval_segment --task miou`` on the Cityscapes val canvas
     (1024x2048), ``--task pgd`` (1 step) on the VOC val canvas (512x512)
     and ``eval_detect --task map`` on the VOC 2007 test split (its
     difficult objects in the evaluator's ground truth), with launch
     counts;
 50. the kernels at the new shapes: the upsample + CE at the VOC eval
     canvas (logits (1, 21, 128, 128)) within phase 7's tolerances; one
     A-FAN step on a tall batch of decoded images (1008x608) with the NMS
     and PGD-update kernels against one with their plain versions, and the
     NMS kernel on its proposals; the PGD update at every shape of phase
     49's runs, bit for bit; then the loaders' host ms per batch alone
     (Cityscapes batch 4, VOC detection batch 8) beside the recipe steps'
     ms and waits, and the kernels at the new shapes with plain versions,
     bounds and (upsample + CE) the library;
 51. ``recipes/seg_city_final.sh`` on the Cityscapes tree with the
     reference scripts' ``--gpu_id 0 --vis_port 8097 --download``, in f32,
     with ``--fused_ce on`` and then ``off``, 2 steps and a validation
     each: 5 upsample + CE launches each way per step with ``on``, none
     with ``off``; the first steps' losses within 1e-4 (relative); each
     run's ``runs/<exp>/scalars.jsonl`` holding every step's
     ``train/loss`` and the ``val/mIoU``, and its log the ``--download``
     warning (phase 49's detection runs hold ``train/loss`` per step in
     ``<outputs_dir>/summaries/scalars.jsonl``);
 52. ``train_classify.main --epoch_scan --pgd_random_steps`` at full width
     (ALFA ResNet-56, batch 128), f32 and ``--bf16``, one epoch of 8 steps:
     phase 18's checks, the launches being the PGD update's
     device-step-size entry points (its step sizes drawn on the card, each
     replay anew), 5 of its kernels per replay in a profiler trace;
 53. 6 one-step epochs of a random-steps epoch scan (3 eager, the capture,
     replays) against 6 eager device-data steps from the same weights and
     draws, each fed the step sizes the scan's step used (read back after
     it ran), f32 and bf16: metrics and parameters within 1e-4 (f32) or one
     bf16 ulp (2^-8, bf16), every step's sizes new; ``profile_trace``
     (``afan_torch/utils/observe.py``) around 3 more replays, its trace
     holding 15 device-step-size kernels; the device-step-size kernel
     against the host-step-size kernel and the plain version at the ALFA
     tap, f32 and bf16, clipped and not, bit for bit;
 54. the device-step-size kernel at the ALFA tap in turns with the
     host-step-size kernel, f32 and bf16, its plain version and bound;
 55. data parallelism: the world-1 steps (2 each, full f32, deterministic
     cuDNN, dropout off) of ALFA (batch 128), the Cityscapes A-FAN seg step
     (batch 4, crop 768) and the VOC setting-1 A-FAN detection step (batch
     8), their step times, peak memory and kernel launches, the detection
     samplers' uniforms and the ascents' perturbations recorded; then each
     again on the batch with its halves swapped, replaying them: how far
     the same function in another row order moves;
 56. the same steps at world 2: two gloo ranks on cuda:0
     (``afan_torch.parallel.launch``), each on its rows of the global batch
     (global BatchNorm statistics and pixel counts, summed gradients), the
     uniforms and the ascents' perturbations of phase 55 replayed by rows
     (each rank's own ascent still runs; its flips against phase 55's are
     shown); the losses, each ascent's first gradient, the trained
     parameters and their update within twice what phase 55's
     swapped-batch run differs by (and no less than ``DP_MIN_BOUND``),
     every kernel of each path launched on every rank (as often per rank
     as at world 1: the per-rank shapes are smaller, the counts the same),
     each kernel held against its plain version at its per-rank inputs
     and timed at the per-rank shapes in one process; step ms and peak GiB per rank (a correctness run: two
     ranks share the card);
 57. the NCCL backend initialised at world 1 through the same launcher,
     one ALFA run of 2 steps whose all-reduces run on it, its losses those
     of phase 55;
 58. ``train_classify --num_devices 2`` on a one-card machine raises,
     naming the count;
 59. spatial sharding: the world-1 Cityscapes A-FAN seg step (2 steps,
     deterministic cuDNN, dropout off) in f32 and in bf16, then each again
     on the batch with its halves swapped, replaying its ascents;
 60. the same steps on a 1 x 2 data x spatial mesh: two gloo ranks on
     cuda:0, each holding the rows of its half of every image
     (``afan_torch.parallel.spatial``: halo exchanges through host buffers,
     the upsample + CE kernels on a row window), phase 59's ascents
     replayed by rows; the losses, each ascent's first gradient, the
     trained parameters and their update within twice what the swapped
     run differs by (and no less than ``DP_MIN_BOUND``), every upsample +
     CE launch of each rank a windowed one, as many as at world 1, and
     each rank's windowed kernels at its first site's inputs against the
     plain version; step ms and peak GiB per rank (a correctness run: two
     ranks share the card);
 61. the windowed kernels against their plain versions at the recipe's
     per-rank shapes, f32 and bf16: the top-edge and bottom-edge windows of
     a 1 x 2 mesh, the interior window of a 1 x 3 one, and the whole map's
     kernels against the two windows' added up;
 62. the windowed kernels timed at rank 0's shapes, f32 and bf16, in turns
     with the library composition on the window, with their plain versions
     and bounds; ``train_segment --num_devices 2 --spatial_shards 2`` on a
     one-card machine raises, naming the count;
 63. recomputation: phase 8's Cityscapes A-FAN step, f32 (dropout off,
     as phase 55), deterministic cuDNN, plain (twice: the card's run-to-run
     noise of the step; and on the batch with its halves swapped), with
     ``--backbone_remat``, ``--remat_tails`` and both, 2 steps each from
     the same weights and seeds: the peak memory above what was resident
     before the case's model, the losses, the launches, and the trained
     parameters and BatchNorm running statistics after 2 steps, each equal
     to the plain step's where the plain step run twice is, else within
     twice the swapped-batch run's difference (phase 56's bound; the f32
     step's decoder upsample adds with atomics in its backward); then 2
     more steps of each case in turns, timed on the host clock with the
     card synchronized;
 64. the same under bf16, dropout on (the step is deterministic: each case
     must equal the plain one);
 65. the same for phase 15's VOC setting-1 A-FAN detection step with
     ``--remat_tails``, with ``share_proposals`` and with each forward
     sampling its own (the tails' proposal NMS then runs again in each
     recompute), the CUDA generator's state after the steps equal;
 66. ``train_segment --backbone_remat --remat_tails`` (the Cityscapes
     recipe) and ``train_detect --remat_tails`` (VOC setting 1, its mAP)
     through their CLIs, 2 steps each, with their launches per step;
 67. ``infer_detect image`` and ``dir`` on the committed fixtures: the
     detections equal ``detect_batch``'s, each written PNG reads back
     through the port's reader as the drawing; then the kernels against
     their plain versions on the recomputed steps' first inputs.

The line before the last lists each kernel with its launches on its main
paths (the bf16 paths of phases 27-29 as entries of their own, ``_bf16``,
timed per bf16 A-FAN step), its largest disagreement with the plain
version, its time, the plain
version's time, its bound and the library's time (NMS: per batch-4 detect
call plus per A-FAN detection step; PGD update: per ALFA step plus per A-FAN
detection step plus per robust-eval batch); its launches include the variant
runs of phases 22 and 23 and the bf16 runs of phases 30 and 33 (NMS in
``nms``, the bf16 updates in ``pgd_update_bf16``, whose times are phase
29's where it ran, else the bf16 detection or ALFA step's) and the eval runs
of phases 36 and 37 (under ``--only eval`` the times are per ``rob`` image
for NMS and the PGD update, per VOC ``pgd`` image for the upsample + CE)
and the runs of phases 40, 43, 44, 49 and 51 (under ``--only mobilenet``,
``--only coco`` or ``--only data`` the times are phase 42's, 46's or 50's).
The device-step-size PGD update has entries of its own,
``pgd_update_dev`` and ``pgd_update_dev_bf16``: phase 52's launches and
phase 54's times per replay (5 launches). The upsample + CE kernels on a
row window have entries of their own, ``resize_ce_forward_window``,
``resize_ce_backward_window`` and their ``_bf16``: rank 0's launches in
phase 60 and phase 62's times per launch at rank 0's B=4 window. The
launches include the recomputed paths of phases 63-67 (their bf16 ones in
the ``_bf16`` entries).
Launches are the wrappers' counts: a graph replay runs kernels that no
wrapper call counts, so phase 18 prints the PGD-update kernels its replays
ran (the profiled kernels per replay times the replays) beside the
wrapper's count. Before the kernels
line the script prints its total time; the last line is the device
summary.
"""
import argparse
import asyncio
import contextlib
import copy
import dataclasses
import functools
import gc
import inspect
import itertools
import json
import os
import pickle
import platform
import shlex
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from afan_torch.cli import (eval_detect, eval_segment, infer_classify,
                            train_classify, train_detect, train_segment)
from afan_torch.cli.infer_detect import build_state, preprocess_frame
from afan_torch.cli.serve_websocket import FrameBatcher
from afan_torch.core import attack
from afan_torch.data import cifar, seg_data
from afan_torch.data.registry import detection_loaders
from afan_torch.data.voc_det import voc_detection_loaders
from afan_torch.eval import feature_vis, robustness
from afan_torch.eval.robustness import make_robust_eval_step
from afan_torch.models.deeplab import build_model
from afan_torch.models.deeplab.heads import (AtrousSeparableConv,
                                             resize_window)
from afan_torch.models.deeplab.modeling import segmentation_param_groups
from afan_torch.models.frcnn import FasterRCNN, FRCNNConfig, roi_head
from afan_torch.models.frcnn import sampling
from afan_torch.models.frcnn.rpn import generate_proposals
from afan_torch.models.resnet import (FrozenBatchNorm, from_name,
                                      frozen_bn_stats)
from afan_torch.models.resnet_s import LEARNABLE_TAPS, resnet56
from afan_torch.ops import nms as tnms
from afan_torch.ops import pgd_step as tpgd
from afan_torch.ops import resize_ce as trce
from afan_torch.ops.kernels import build as kbuild
from afan_torch.ops.kernels import nms as knms
from afan_torch.ops.kernels import pgd_step as kpgd
from afan_torch.ops.kernels import resize_ce as krce
from afan_torch.parallel import mesh as dp
from afan_torch.parallel import spatial
from afan_torch.parallel.launch import launch
from afan_torch.train import loop as cls_loop
from afan_torch.train import detect_loop, segment_loop
from afan_torch.train.checkpoint import load_checkpoint, overlap_restore
from afan_torch.train.detect_loop import make_detect_fn
from afan_torch.train.optim import (capturable_sgd, learnable_sgd,
                                    multistep_warmup_schedule,
                                    multistep_warmup_schedule_tensor,
                                    poly_schedule, sgd,
                                    warmup_multistep_schedule)

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
MIN_SIDE, MAX_SIDE = 600.0, 1000.0
PROB_THRESH = 0.6
MAX_BATCH = 4
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s
# outside the tensor cores. Each IoU test is 16 f32 operations (see
# afan_torch/csrc/nms.cu:over).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_IOU = 16
# f32 operations that the upsample + CE function needs, counted from the
# function at its least, not from the kernels. Bilinear upsampling is
# separable: a pass along W over the h low-res rows (each output a 2-tap
# lerp a + t * (b - a), 3 operations), then a pass along H over the H output
# rows (3 again), so per (output pixel, class) it costs 3 + 3 * h / H
# (3.75 at 192 -> 768); its transpose, in the backward, costs the same.
# Per (valid pixel, class) the forward then adds max, exp of the difference
# (2) and the sum of exps (CE_LSE_OPS = 4); the backward recomputes all of
# the forward (its input is lo, not the upsampled logits), forms
# softmax - onehot scaled by the cotangent (CE_SOFTMAX_GRAD_OPS = 3), and
# runs the transposed interpolation. Per valid pixel the forward adds log,
# lse - picked and the masked sum (CE_PIXEL_OPS = 3).
CE_LERP_OPS = 3
CE_LSE_OPS = 4
CE_SOFTMAX_GRAD_OPS = 3
CE_PIXEL_OPS = 3
# (name, B, (h, w) in, (H, W) out, C, focal): the first six are
# scripts/smoke_fused_ce_tpu.py:27-34; then the A-FAN step's B=8 spectrum
# site and the band plan's edges (tests/test_torch_resize_ce.py:PLAN_CASES):
# odd sizes, a single low-res pixel, h not a multiple of the band's rows and
# odd w; "all_ignored" gives its last entry only 255 labels.
CE_CASES = [
    ("city768", 2, (192, 192), (768, 768), 19, None),
    ("city512", 2, (128, 128), (512, 512), 19, None),
    ("voc513", 2, (129, 129), (513, 513), 21, None),
    ("voc513_focal", 2, (129, 129), (513, 513), 21, (1.0, 2.0)),
    ("city768_focal", 2, (192, 192), (768, 768), 19, (1.0, 2.0)),
    ("tiny32", 2, (8, 8), (32, 32), 4, None),
    ("city768_b8", 8, (192, 192), (768, 768), 19, None),
    ("odd9x7", 2, (9, 7), (33, 28), 5, None),
    ("one_pixel", 2, (1, 1), (4, 4), 4, None),
    ("h6_w5", 2, (6, 5), (24, 20), 3, (1.0, 2.0)),
    ("all_ignored", 2, (128, 128), (512, 512), 19, None),
]
CE_SUM_TOL, CE_GRAD_TOL = 1e-5, 1.1e-5
SEG_MODEL, SEG_CROP, SEG_BATCH, SEG_ITRS = "deeplabv3plus_resnet50", 768, 4, 6
# recipes/seg_city_final.sh's flags but --bf16 (phases 27-29 run it) and the
# data: no --data_root, so the 19-class synthetic Cityscapes
SEG_FLAGS = ["--variant", "afan", "--dataset", "cityscapes", "--model",
             SEG_MODEL, "--output_stride", "16", "--crop_size", str(SEG_CROP),
             "--batch_size", str(SEG_BATCH), "--lr", "0.1",
             "--pertub_idx_se", "2", "--pertub_idx_sd", "concat",
             "--adv_loss_weight_sd", "0.3", "--gamma_se", "0.02",
             "--gamma_sd", "1.5", "--mix_layer", "01", "--mix_sd"]
# The ALFA recipe (`afan/train/loop.py:70-83`, `afan/cli/train_classify.py`
# defaults): ResNet-56, CIFAR-10, batch 128, tap 13, 5 sign steps of
# 1.5/255, eps 2/255; the learnable-eta mode takes 3 steps at 9 taps.
CLS_BATCH, CLS_ALFA_BATCHES, CLS_SHORT_BATCHES = 128, 8, 2
ALFA_TAP, ALFA_STEPS, ALFA_GAMMA, ALFA_EPS = 13, 5, 1.5 / 255, 2.0 / 255
LEARNABLE_STEPS = 3
# The PGD update reads x and g (and the centre, with the clip) once and
# writes its output once; its least operations per element are the step's
# sign, multiply and add (3), and with the clip c - eps, c + eps, maximum
# and minimum (4 more).
PGD_OPS, PGD_CLIP_OPS = 3, 7


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sorted_boxes(n, seed, clustered=False):
    rng = np.random.RandomState(seed)
    if clustered:
        centers = rng.rand(8, 2) * 300
        xy = centers[rng.randint(0, 8, n)] + rng.randn(n, 2) * 12
        wh = rng.rand(n, 2) * 120 + 60
    else:
        xy = rng.rand(n, 2) * 1000
        wh = rng.rand(n, 2) * 150 + 4
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return boxes[np.argsort(-rng.rand(n), kind="stable")]


def chain_boxes(n, lead=0):
    """Boxes sliding right by 3 of their 12 pixels: iou(i, i+1) >= 0.5 >
    iou(i, i+2) (with or without +1-pixel areas), so greedy NMS keeps every
    other box; ``lead`` far-away boxes first shift the kept ones by one
    slot, so that a kept box ends a 64-box word and suppresses the next
    word's first."""
    x = 3.0 * np.arange(n)
    chain = np.stack([x, 0 * x, x + 12, 0 * x + 12], 1)
    far = [[1000.0 + 20 * i, 1000, 1010 + 20 * i, 1010] for i in range(lead)]
    return np.concatenate([np.reshape(far, (-1, 4)), chain]).astype(
        np.float32)


def degenerate_boxes(n, seed):
    """Zero-width, zero-height and inverted (x2 < x1, y2 < y1) boxes among
    ordinary ones."""
    b = sorted_boxes(n, seed).copy()
    b[0::5, 2] = b[0::5, 0]
    b[1::5, 3] = b[1::5, 1]
    b[2::5, [0, 2]] = b[2::5, [2, 0]]
    b[3::7, [1, 3]] = b[3::7, [3, 1]]
    return b


def holes(n):
    """All valid but a few slots inside words and at their edges."""
    v = np.ones(n, bool)
    v[[3, 4, 10, 62, 63, 64, 65, 100, 101, 102, 127, 128]] = False
    return v


# The edges of the kernel's per-word scan: name -> () -> (boxes (N, 4) f32
# score-sorted, valid (N,) bool, threshold). Ragged last words, suppression
# chains inside and across words, identical boxes, thresholds under which
# everything or nothing suppresses, degenerate boxes, invalid slots inside a
# word. tests/test_torch_nms.py holds the plain version to afan on them.
NMS_EDGE_CASES = {
    **{f"n{n}": (lambda n=n: (sorted_boxes(n, n), np.ones(n, bool), 0.6))
       for n in (1, 63, 64, 65, 6001)},
    "chain": lambda: (chain_boxes(200), np.ones(200, bool), 0.5),
    "chain_shifted": lambda: (chain_boxes(200, 1), np.ones(201, bool), 0.5),
    "identical": lambda: (np.tile(np.float32([[10, 20, 50, 70]]), (150, 1)),
                          np.ones(150, bool), 0.5),
    "thr_zero": lambda: (sorted_boxes(150, 7), np.ones(150, bool), 0.0),
    "thr_above_one": lambda: (sorted_boxes(150, 8), np.ones(150, bool), 1.01),
    "degenerate": lambda: (degenerate_boxes(300, 9), np.ones(300, bool), 0.3),
    "invalid_in_word": lambda: (chain_boxes(200), holes(200), 0.5),
}


def cuda(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def kernel_vs_plain(name, boxes, valid, thr, plus_one, errs):
    """Kernel and plain version on the same (G, N, 4) / (G, N) inputs;
    appends the largest |kernel - plain| over the keep mask to ``errs`` and
    returns the kernel's keep mask after requiring equality."""
    got = knms.nms_sorted_mask(boxes, valid, thr, plus_one)
    want = tnms.nms_sorted_mask_plain(boxes, valid, thr, plus_one)
    torch.cuda.synchronize()
    errs.append(float((got.float() - want.float()).abs().max()))
    require(torch.equal(got, want), f"NMS kernel != plain on {name}")
    print(f"  nms {name}: G={boxes.shape[0]} N={boxes.shape[1]} thr={thr} "
          f"plus_one={plus_one} kept={int(got.sum())} equal")
    return got


@contextlib.contextmanager
def patched_nms(fn):
    """Route afan_torch.ops.nms through ``fn`` instead of the kernel
    wrapper for the duration of the block."""
    saved = tnms.nms_sorted_mask
    tnms.nms_sorted_mask = fn
    try:
        yield
    finally:
        tnms.nms_sorted_mask = saved


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_samples(fn, n, warmup=3):
    """Per-call device times (ms) of ``n`` calls, each between two CUDA
    events."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return np.array([s.elapsed_time(e) for s, e in events])


def host_ms(fn, n=20):
    """Median wall time (ms) of ``n`` calls of the host function ``fn``,
    after one warmup call."""
    fn()
    t = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        t.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(t))


def nms_bound_parts(boxes, valid, keep):
    """The two floors (ms) of the same work on an H100: the bytes the
    function must move (boxes and valid read once, keep written once) over
    HBM bandwidth, and the IoU tests this data needs over the f32 rate. A
    kept box must be tested against every earlier kept box; a suppressed
    valid box needs at least one test."""
    g, n = valid.shape
    nbytes = g * n * (16 + 1 + 1)
    kc = torch.cumsum(keep.to(torch.int64), dim=1)
    tests = int(((kc - 1) * keep).sum()) + int((valid & ~keep).sum())
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            tests * OPS_PER_IOU / F32_OPS_PER_S * 1e3)


async def serve_group(batcher, frames):
    """Enqueue ``frames`` together, then let a worker drain them (one
    batched device call when they fit in max_batch)."""
    subs = [asyncio.create_task(batcher.submit(f)) for f in frames]
    await asyncio.sleep(0)
    worker = asyncio.create_task(batcher.worker())
    try:
        return await asyncio.gather(*subs)
    finally:
        worker.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await worker


async def serve_all(batcher, groups, zero_frames):
    """Serve each group in turn on one event loop (the batcher's queue
    belongs to the loop that first used it), then ``zero_frames`` at
    prob_thresh 0 → (answers, answers at 0)."""
    answers = []
    for group in groups:
        answers += await serve_group(batcher, group)
    batcher.prob_thresh = 0.0
    try:
        zero = await serve_group(batcher, zero_frames)
    finally:
        batcher.prob_thresh = PROB_THRESH
    return answers, zero[0]


def check_answer(dets, thresh):
    require(isinstance(dets, list), "answer is not a list")
    for box, label, prob in dets:
        require(np.shape(box) == (4,) and np.isfinite(box).all(),
                f"bad box {box}")
        require(1 <= label <= 20, f"label {label} outside 1..20")
        require(prob > thresh, f"prob {prob} not above {thresh}")


def nms_kernel_vs_plain(errs):
    """Phase 3."""
    print("[3] NMS kernel vs plain version")
    det = np.load(os.path.join(FIXTURES, "nms-large-input.npy"))
    order = np.argsort(-det[:, 4], kind="stable")
    gold = cuda(det[order, :4].astype(np.float32))[None]
    ones = torch.ones(gold.shape[:2], dtype=torch.bool, device="cuda")
    keep = kernel_vs_plain("golden", gold, ones, 0.7, True, errs)
    kept = sorted(order[keep[0].cpu().numpy()].tolist())
    expect = np.load(os.path.join(FIXTURES, "nms-large-output.npy"))
    require(len(kept) == 1934 and kept == sorted(expect.tolist()),
            f"golden fixture kept {len(kept)}, expected 1934")
    public = tnms.nms_mask(cuda(det[:, :4].astype(np.float32)),
                           cuda(det[:, 4].astype(np.float32)), 0.7)
    require(int(public.sum()) == 1934, "nms_mask on the card != 1934 kept")
    for n in (6000, 12000):
        b = cuda(sorted_boxes(n, n))[None]
        ones = torch.ones(b.shape[:2], dtype=torch.bool, device="cuda")
        kernel_vs_plain(f"uniform{n}", b, ones, 0.7, True, errs)
    b = cuda(sorted_boxes(12000, 12, clustered=True))[None]
    kernel_vs_plain("clustered12000", b, ones, 0.7, True, errs)
    b = cuda(sorted_boxes(2600, 99, clustered=True))[None]
    ones = torch.ones(b.shape[:2], dtype=torch.bool, device="cuda")
    kernel_vs_plain("clustered", b, ones, 0.5, True, errs)
    keep = kernel_vs_plain("all_invalid", b, ~ones, 0.5, True, errs)
    require(not keep.any(), "all-invalid input kept a box")
    b = cuda(sorted_boxes(6000, 1))[None]
    part = cuda(np.random.RandomState(2).rand(1, 6000) < 0.7)
    keep = kernel_vs_plain("partial_valid", b, part, 0.7, True, errs)
    require(not (keep & ~part).any(), "an invalid slot was kept")
    kernel_vs_plain("no_plus_one", b, torch.ones_like(part), 0.7, False, errs)
    b = cuda(np.stack([sorted_boxes(300, i, clustered=True)
                       for i in range(80)]))
    ones = torch.ones(b.shape[:2], dtype=torch.bool, device="cuda")
    kernel_vs_plain("batched", b, ones, 0.3, True, errs)
    for name, case in NMS_EDGE_CASES.items():
        boxes, valid, thr = case()
        for plus_one in (True, False):
            kernel_vs_plain(name, cuda(boxes)[None], cuda(valid)[None], thr,
                            plus_one, errs)


def detector():
    """The served ResNet-50 Faster R-CNN (21 classes, seeded weights) and
    its canvas."""
    args = argparse.Namespace(backbone="resnet50", checkpoint=None,
                              image_min_side=MIN_SIDE,
                              image_max_side=MAX_SIDE)
    model, canvas_hw = build_state(args, num_classes=21)
    require(next(model.parameters()).is_cuda, "model is not on the card")
    return model, canvas_hw


def serve(model, canvas_hw, frames):
    """Phase 4; returns the NMS kernel's launches in the served calls."""
    print("[4] serve: FrameBatcher, ResNet-50 Faster R-CNN, 21 classes")
    detect_fn = make_detect_fn(model)
    batch_sizes = []

    def recording_detect(images):
        batch_sizes.append(images.shape[0])
        return detect_fn(images)

    batcher = FrameBatcher(recording_detect, canvas_hw, MIN_SIDE, MAX_SIDE,
                           PROB_THRESH, max_batch=MAX_BATCH)
    t0 = time.time()
    batcher.warmup()
    torch.cuda.synchronize()
    print(f"    canvas {canvas_hw}, warmup {time.time() - t0:.1f} s")
    groups = [frames[0:1], frames[1:2], frames[2:6], frames[6:8]]
    batch_sizes.clear()
    knms.launches = 0
    t0 = time.time()
    answers, zero = asyncio.run(serve_all(batcher, groups, frames[8:9]))
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    launches = knms.launches
    for dets in answers:
        check_answer(dets, PROB_THRESH)
    check_answer(zero, 0.0)
    require(len(zero) > 0, "no detections at prob_thresh 0")
    require(batch_sizes == [1, 1, 4, 4, 1],
            f"unexpected batch sizes {batch_sizes}")
    require(launches == 2 * len(batch_sizes),
            f"NMS kernel launched {launches} times in "
            f"{len(batch_sizes)} detect calls (expected 2 per call)")
    print(f"    {len(frames)} frames in {serve_s:.2f} s, batch sizes "
          f"{batch_sizes}, detections per frame "
          f"{[len(d) for d in answers]} (>{PROB_THRESH}), {len(zero)} at "
          f"prob_thresh 0; NMS kernel launches {launches}")
    return launches


def path_kernel_vs_plain(model, hw, x4, errs):
    """Phase 5; returns the NMS inputs of the batch-4 detect call (the
    proposal NMS and the per-class NMS)."""
    print("[5] path with the kernel vs path with the plain NMS")
    recorded = []

    def recording_kernel(boxes, valid, thr, plus_one=True):
        recorded.append((boxes.clone(), valid.clone(), thr, plus_one))
        return knms.nms_sorted_mask(boxes, valid, thr, plus_one)

    def post(features):
        obj, reg = model.rpn(features)
        anchors = model._anchors(hw, tuple(features.shape[2:]))
        props = generate_proposals(anchors, obj, reg, hw[1], hw[0],
                                   model.cfg.eval_pre_nms_top_n,
                                   model.cfg.eval_post_nms_top_n)
        return props + model.detect_from_features(features, hw)

    with torch.inference_mode():
        features = model.features_clean(x4.permute(0, 3, 1, 2))
        with patched_nms(recording_kernel):
            k_out = post(features)
        with patched_nms(tnms.nms_sorted_mask_plain):
            p_out = post(features)
    torch.cuda.synchronize()
    names = ("proposals", "proposal_valid", "boxes", "probs", "keep")
    for nm, a, b in zip(names, k_out, p_out):
        require(torch.equal(a, b), f"{nm} differ between kernel and plain")
    props, pvalid, boxes, probs, keep = k_out
    require(tuple(boxes.shape) == (MAX_BATCH, 300, 21, 4)
            and tuple(probs.shape) == (MAX_BATCH, 300, 21)
            and tuple(keep.shape) == (MAX_BATCH, 300, 21),
            f"detect shapes {boxes.shape} {probs.shape} {keep.shape}")
    require(bool(torch.isfinite(boxes[keep]).all()), "non-finite kept box")
    require(bool(torch.allclose(probs.sum(-1), torch.ones_like(probs[..., 0]),
                                atol=1e-4)), "probs do not sum to 1")
    print(f"    proposals {tuple(props.shape)}, valid per image "
          f"{pvalid.sum(1).tolist()}, kept detections per image "
          f"{keep.sum((1, 2)).tolist()}: identical")
    # recorded: proposal NMS twice (props, detect) then per-class NMS
    main_inputs = [recorded[1], recorded[2]]
    for boxes_in, valid_in, thr, plus_one in main_inputs:
        kernel_vs_plain("main_path", boxes_in, valid_in, thr, plus_one, errs)
    return main_inputs


def time_detect(card, model, x4, frame, canvas_hw):
    """Phase 6, the detect call and the host's pre-processing."""
    x1 = x4[:1].contiguous()
    with torch.inference_mode():
        for bs, x in ((1, x1), (MAX_BATCH, x4)):
            t = cuda_samples(lambda: model.detect(x), 110)
            print(f"    detect batch {bs}: median {np.median(t):.3f} ms, "
                  f"p90 {np.percentile(t, 90):.3f} ms over {len(t)} calls, "
                  f"{bs * 1e3 / np.median(t):.1f} frames/s ({card})")
        torch.cuda.reset_peak_memory_stats()
        model.detect(x4)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"    peak memory, detect at batch {MAX_BATCH}: {peak:.2f} GiB")
    pre_ms = host_ms(lambda: preprocess_frame(frame, canvas_hw, MIN_SIDE,
                                              MAX_SIDE))
    _, scale = preprocess_frame(frame, canvas_hw, MIN_SIDE, MAX_SIDE)
    u8 = torch.from_numpy((frame * 255).astype(np.uint8))
    x = u8.permute(2, 0, 1)[None].to(torch.float32)
    size = (round(frame.shape[0] * scale), round(frame.shape[1] * scale))
    lib_ms = host_ms(lambda: F.interpolate(x, size=size, mode="bilinear",
                                           antialias=True))
    print(f"    host pre-processing of a {frame.shape[0]}x{frame.shape[1]} "
          f"frame at scale {scale}: preprocess_frame (PIL's integer resize) "
          f"median {pre_ms:.3f} ms; one antialiased F.interpolate of the "
          f"same frame {lib_ms:.3f} ms ({torch.get_num_threads()} host "
          f"threads)")


def nms_pass_ms(call, n=5):
    """Device ms per call of the kernel's two passes, from a torch.profiler
    trace of ``n`` calls: (mask pass, scan pass), or None when the trace
    holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for part in ("nms_mask_kernel", "nms_scan_kernel"):
                if part in e.key:
                    ms[part] = e.self_device_time_total / 1e3 / n
    if len(ms) < 2:
        return None
    return ms["nms_mask_kernel"], ms["nms_scan_kernel"]


def time_nms_shape(card, label, boxes, valid, thr, plus_one=True, plain=True):
    """One shape of phase 6: kept count, the two passes' device time, the
    kernel's time (calls queued behind a sleep kernel, so that the host's
    cost per call does not hide the card's), the plain version's and the
    bound."""
    call = lambda: knms.nms_sorted_mask(boxes, valid, thr, plus_one)
    keep = call()
    kept = keep.sum(1).tolist()
    k_ms = queued_ms(call, reps=50)
    # the plain version takes up to a second a call at the training
    # shapes: one call, after the kernel's
    p_ms = (cuda_ms(lambda: tnms.nms_sorted_mask_plain(
        boxes, valid, thr, plus_one), reps=1, warmup=0) if plain else None)
    b, o = nms_bound_parts(boxes, valid, keep)
    split = nms_pass_ms(call)
    parts = ("passes not measured (no device time in the trace)"
             if split is None else
             f"mask pass {split[0]:.4f} ms + scan pass {split[1]:.4f} ms")
    plain_s = "" if p_ms is None else f", plain {p_ms:.3f} ms"
    print(f"    nms {label} G={valid.shape[0]} N={valid.shape[1]} thr={thr}, "
          f"kept {kept}: kernel {k_ms:.4f} ms ({parts}){plain_s}, bound "
          f"max(bytes {b:.6f}, operations {o:.6f}) ms ({card})")
    return k_ms, p_ms, b, o


def time_nms(card, main_inputs):
    """Phase 6, the kernel: the detect call's two NMS calls (with the plain
    version), then the shapes where most boxes are kept and the training
    proposal NMS (12000 in, at 0.7). Returns (ms, plain ms, bound ms,
    bound_by) per batch-4 detect call."""
    ms = plain_ms = byte_ms = op_ms = 0.0
    for boxes_in, valid_in, thr, plus_one in main_inputs:
        k, p, b, o = time_nms_shape(card, "main path", boxes_in, valid_in,
                                    thr, plus_one)
        ms, plain_ms = ms + k, plain_ms + p
        byte_ms, op_ms = byte_ms + b, op_ms + o
    bound = max(byte_ms, op_ms)
    bound_by = "bytes" if byte_ms >= op_ms else "operations"
    print(f"    nms per detect call at batch {MAX_BATCH}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound:.6f} ms ({bound_by})")
    # random weights keep few proposals; uniform boxes keep most
    shapes = [("uniform", 6000, 4, False)] + [
        ("clustered" if cl else "uniform", 12000, g, cl)
        for g in (1, 4) for cl in (False, True)]
    for label, n, g, cl in shapes:
        b = cuda(np.stack([sorted_boxes(n, 10 + i, clustered=cl)
                           for i in range(g)]))
        ones = torch.ones(b.shape[:2], dtype=torch.bool, device="cuda")
        time_nms_shape(card, label, b, ones, 0.7, plain=False)
    return ms, plain_ms, bound, bound_by


def detection_phases(card, nms_only=False):
    """Phases 3-6 (with ``nms_only``, phases 3 and 5 and the NMS timings of
    phase 6: no server, no detect timing); returns the NMS kernel's entry
    of the kernels line."""
    errs = []
    nms_kernel_vs_plain(errs)
    model, canvas_hw = detector()
    rng = np.random.RandomState(0)
    frames = [rng.rand(480, 640, 3).astype(np.float32) for _ in range(9)]
    launches = None if nms_only else serve(model, canvas_hw, frames)
    x4 = cuda(np.stack([preprocess_frame(f, canvas_hw, MIN_SIDE, MAX_SIDE)[0]
                        for f in frames[:MAX_BATCH]]))
    main_inputs = path_kernel_vs_plain(model, tuple(canvas_hw), x4, errs)
    print(f"[6] timing on {card}")
    if not nms_only:
        time_detect(card, model, x4, frames[0], canvas_hw)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ms, plain_ms, bound, bound_by = time_nms(card, main_inputs)
    return {
        "name": "nms", "route": "cuda", "source": "afan_torch/csrc/nms.cu",
        "replaces": "afan/ops/kernels/nms_kernel.py:65",
        "launches": launches, "max_abs_err": max(errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None}


def rel_err(got, want):
    """max |got - want| / max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def ce_inputs(B, hw, HW, C, seed=0, all_ignored=False):
    """Seeded logits (B, C, h, w), labels (B, H, W) with an ignored corner
    (and, with ``all_ignored``, a last entry of ignored labels only), and a
    per-entry cotangent."""
    rng = np.random.RandomState(seed)
    lo = cuda(rng.randn(B, C, *hw).astype(np.float32))
    lab = rng.randint(0, C, (B, *HW)).astype(np.int32)
    lab[:, :3, :3] = 255
    if all_ignored:
        lab[-1] = 255
    g = cuda(np.linspace(0.5, 1.5, B).astype(np.float32))
    return lo, cuda(lab), g


@contextlib.contextmanager
def patched_update(fn):
    """Route ``core.attack.pgd``'s sign steps through ``fn`` instead of
    ``ops.pgd_step.pgd_update`` for the duration of the block."""
    saved = attack.pgd_update
    attack.pgd_update = fn
    try:
        yield
    finally:
        attack.pgd_update = saved


def recording_update(shapes):
    """``pgd_update`` that appends each call's (shape, clip) to ``shapes``
    and then runs it (its kernel wrapper counts the launch)."""
    def update(x, g, center=None, **kw):
        shapes.append((tuple(x.shape), bool(kw.get("clip"))))
        return tpgd.pgd_update(x, g, center, **kw)
    return update


@contextlib.contextmanager
def patched_site_op(fn):
    """Route the segmentation step's loss and ascent sites through ``fn``
    instead of ``fused_resize_nll_sums`` for the duration of the block."""
    saved = segment_loop.fused_resize_nll_sums
    segment_loop.fused_resize_nll_sums = fn
    try:
        yield
    finally:
        segment_loop.fused_resize_nll_sums = saved


def ce_case(name, B, hw, HW, C, focal, errs):
    """Both upsample + CE kernels (twice) against the plain version on one
    geometry: sums within ``CE_SUM_TOL`` and gradient within
    ``CE_GRAD_TOL`` (max abs error over max abs value), two runs
    bit-equal; the largest absolute errors go to ``errs``."""
    lo, lab, g = ce_inputs(B, hw, HW, C, all_ignored=name == "all_ignored")
    sums = krce.resize_ce_forward(lo, lab, focal)
    dlo = krce.resize_ce_backward(lo, lab, g, focal)
    again = (krce.resize_ce_forward(lo, lab, focal),
             krce.resize_ce_backward(lo, lab, g, focal))
    want_s = trce.fused_resize_nll_sums_plain(lo, lab, HW, focal)
    want_d = trce.resize_ce_grad_plain(lo, lab, g, focal)
    torch.cuda.synchronize()
    es, eg = rel_err(sums, want_s), rel_err(dlo, want_d)
    errs["fwd"].append(float((sums - want_s).abs().max()))
    errs["bwd"].append(float((dlo - want_d).abs().max()))
    repeat = torch.equal(again[0], sums) and torch.equal(again[1], dlo)
    print(f"  {name}: B={B} {hw}->{HW} C={C} focal={focal}: sums rel "
          f"{es:.3e}, grad rel {eg:.3e}, repeat bit-equal {repeat}")
    require(es <= CE_SUM_TOL, f"{name}: sums rel err {es} > {CE_SUM_TOL}")
    require(eg <= CE_GRAD_TOL, f"{name}: grad rel err {eg} > {CE_GRAD_TOL}")
    require(repeat, f"{name}: two runs of the kernels differ")
    if name == "all_ignored":
        require(float(sums[-1]) == 0.0 and not dlo[-1].any(),
                "an entry of ignored labels has a loss or a gradient")


def ce_kernels_vs_plain(errs):
    """Phase 7: both kernels against the plain version on the geometries
    of ``CE_CASES``; appends the largest absolute errors to ``errs``."""
    print("[7] upsample + CE kernels vs plain version")
    for case in CE_CASES:
        ce_case(*case, errs)
    # the autograd Function on a CUDA tensor goes through both kernels
    lo, lab, g = ce_inputs(2, (192, 192), (768, 768), 19, seed=1)
    before = (krce.fwd_launches, krce.bwd_launches)
    x = lo.clone().requires_grad_(True)
    sums = trce.fused_resize_nll_sums(x, lab.long(), (768, 768))
    (grad,) = torch.autograd.grad(sums, x, g)
    require((krce.fwd_launches, krce.bwd_launches)
            == (before[0] + 1, before[1] + 1),
            "fused_resize_nll_sums did not launch both kernels")
    require(torch.equal(sums, krce.resize_ce_forward(lo, lab))
            and torch.equal(grad, krce.resize_ce_backward(lo, lab, g)),
            "the autograd Function disagrees with the kernel wrappers")


def train_full_width():
    """Phase 8: the trainer through its CLI entry point. Returns (forward
    launches, backward launches, launches per step, per-step losses, the
    (shape, clip) of each PGD update)."""
    print("[8] train: A-FAN DeepLabv3+ ResNet-50, OS 16, crop 768, batch 4, "
          "Cityscapes final recipe, synthetic data")
    for d in os.listdir("checkpoints") if os.path.isdir("checkpoints") else ():
        if d.startswith("cityscapes_chip_smoke_"):
            shutil.rmtree(os.path.join("checkpoints", d))
    losses, configs = [], []
    real = train_segment.make_afan_seg_step

    def recording(model, optimizer, scheduler, cfg, **kw):
        configs.append(cfg)
        step = real(model, optimizer, scheduler, cfg, **kw)

        def run(images, labels, generator=None):
            out = step(images, labels, generator)
            losses.append({k: float(v) for k, v in out.items()})
            return out
        return run

    train_segment.make_afan_seg_step = recording
    updates = []
    krce.fwd_launches = krce.bwd_launches = kpgd.launches = 0
    t0 = time.time()
    try:
        with patched_update(recording_update(updates)):
            score = train_segment.main(SEG_FLAGS + [
                "--limit_itrs", str(SEG_ITRS), "--val_interval",
                str(SEG_ITRS), "--print_interval", "1", "--exp",
                "chip_smoke"])
        torch.cuda.synchronize()
    finally:
        train_segment.make_afan_seg_step = real
    fwd, bwd, pgd_launches = (krce.fwd_launches, krce.bwd_launches,
                              kpgd.launches)
    secs = time.time() - t0
    cfg = configs[0]
    per_step, pgd_per_step = seg_launches_per_step(cfg)
    require(len(losses) == SEG_ITRS, f"{len(losses)} steps ran")
    require(all(np.isfinite(v) for rec in losses for v in rec.values()),
            f"non-finite loss in {losses}")
    require(fwd == bwd == SEG_ITRS * per_step,
            f"resize+CE launches fwd={fwd} bwd={bwd} in {SEG_ITRS} steps "
            f"(expected {per_step} each per step)")
    require(cfg.step_mode == "sign"
            and pgd_launches == len(updates) == SEG_ITRS * pgd_per_step,
            f"PGD-update launches {pgd_launches} ({len(updates)} updates) in "
            f"{SEG_ITRS} steps (expected {pgd_per_step} per step)")
    dirs = [d for d in os.listdir("checkpoints")
            if d.startswith("cityscapes_chip_smoke_")]
    path = os.path.join("checkpoints", dirs[0],
                        f"latest_{SEG_MODEL}_cityscapes.pt")
    require(len(dirs) == 1 and os.path.isfile(path), "no checkpoint written")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    require(saved["cur_itrs"] == SEG_ITRS
            and all(bool(torch.isfinite(v).all())
                    for v in saved["model_state"].values()
                    if v.is_floating_point()),
            "checkpoint is not the finished run's")
    print(f"    {SEG_ITRS} steps + 1 validation in {secs:.1f} s (first "
          f"step includes cuDNN set-up); losses "
          f"{[round(r['loss'], 4) for r in losses]}; mIoU {score:.4f}; "
          f"checkpoint {path}")
    print(f"    resize+CE launches: forward {fwd}, backward {bwd} = "
          f"{per_step} each per step; PGD-update launches {pgd_launches} = "
          f"{pgd_per_step} per step, shapes {sorted(set(updates))}")
    return fwd, bwd, per_step, losses, updates


def seg_recipe():
    args = train_segment.get_parser().parse_args(SEG_FLAGS)
    return train_segment.afan_config(args)


def seg_launches_per_step(cfg, advtrain_steps=None):
    """(upsample + CE launches each way, PGD-update launches) per
    segmentation step of ``cfg`` (an A-FAN family config; None for the
    baseline; ``advtrain_steps`` for the input-adversarial step). A site
    launches once per forward: one per PGD step of each ascent (the input
    under ``input_adv``, SE, each extra tap, SD when set) and one per loss
    site (clean, the stacked spectrum tails, SD, each extra tap); each sign
    step launches one update."""
    if advtrain_steps is not None:
        return advtrain_steps + 1, advtrain_steps
    if cfg is None:
        return 1, 0
    sd, extra = cfg.sd is not None, len(cfg.extra_taps)
    updates = (cfg.input_adv * cfg.input_adv_steps
               + (1 + sd + extra) * cfg.steps)
    return updates + 2 + sd + extra, updates * (cfg.step_mode == "sign")


def seg_batch(seed=0):
    loader, _, _ = train_segment.cityscapes_loaders(None, SEG_BATCH,
                                                    SEG_CROP, seed=seed)
    imgs, labs = next(iter(loader))
    return cuda(imgs), cuda(labs)


def seg_model_and_batch(seed=0):
    model = build_model(SEG_MODEL, 19, 16)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return (model.cuda(),) + seg_batch(seed)


def seg_optimizer(model):
    return sgd(segmentation_param_groups(model), poly_schedule(0.1, 30000),
               0.1, 0.9, 1e-4)


def seg_step(model, afan=True, cfg=None):
    """The recipe's A-FAN step (``cfg``: another A-FAN family config) or
    the base step, with the recipe's optimizer."""
    opt, sched = seg_optimizer(model)
    if afan:
        return segment_loop.make_afan_seg_step(model, opt, sched,
                                               cfg or seg_recipe())
    return segment_loop.make_seg_base_step(model, opt, sched)


@contextlib.contextmanager
def deterministic():
    """cuDNN deterministic, no TF32, for the block."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32) = flags


def step_kernel_vs_plain(model, imgs, labs, cfg=None, updates=None,
                         label="[9] A-FAN step with the kernels vs with the "
                               "plain op"):
    """Phase 9: one A-FAN step with the kernels and one with the plain op
    from the same weights, batch and dropout masks, in full f32. With
    ``updates`` (phase 24: ``cfg``, another A-FAN family config), the plain
    step's PGD updates are the plain version too, and the kernel step's
    (shape, clip) are appended to ``updates``.

    With input-adversarial training (``cfg.input_adv``) the input ascent's
    gradient is held to the plain one first, and the plain step then takes
    the kernel step's adversarial image: a sign step turns the kernels'
    float differences at gradient entries near zero into whole steps of
    gamma on those pixels (:func:`input_grad_kernel_vs_plain`)."""
    print(label)
    pin = cfg is not None and cfg.input_adv
    if pin:
        input_grad_kernel_vs_plain(model, imgs, labs)
    state = copy.deepcopy(model.state_dict())
    kernel_update = (tpgd.pgd_update if updates is None
                     else recording_update(updates))
    plain_update = (tpgd.pgd_update if updates is None
                    else tpgd.pgd_update_plain)
    real_input_pgd, adv_images = segment_loop.input_pgd, []

    def recording_input_pgd(*a, **kw):
        adv_images.append(real_input_pgd(*a, **kw))
        return adv_images[-1]

    def pinned_input_pgd(*a, **kw):
        # the plain ascent runs all the same, so that both steps draw the
        # same dropout masks after it
        real_input_pgd(*a, **kw)
        return adv_images[0]

    runs = []
    try:
        with deterministic():
            for op, update, input_pgd in (
                    (trce.fused_resize_nll_sums, kernel_update,
                     recording_input_pgd if pin else real_input_pgd),
                    (trce.fused_resize_nll_sums_plain, plain_update,
                     pinned_input_pgd if pin else real_input_pgd)):
                model.load_state_dict(state)
                step = seg_step(model, cfg=cfg)
                torch.manual_seed(0)
                segment_loop.input_pgd = input_pgd
                with patched_site_op(op), patched_update(update):
                    out = step(imgs, labs,
                               torch.Generator("cuda").manual_seed(0))
                conv = model.classifier.classifier[3]
                runs.append(({k: float(v) for k, v in out.items()},
                             conv.weight.grad.clone(), conv.bias.grad.clone()))
            torch.cuda.synchronize()
    finally:
        segment_loop.input_pgd = real_input_pgd
        model.load_state_dict(state)
    (lk, wk, bk), (lp, wp, bp) = runs
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lk)
    grad_err = max(rel_err(wk, wp), rel_err(bk, bp))
    print(f"    losses kernel {lk}")
    print(f"    losses plain  {lp}")
    print(f"    largest loss rel err {loss_err:.3e}; logits-conv gradient "
          f"rel err {grad_err:.3e} (weight {rel_err(wk, wp):.3e}, bias "
          f"{rel_err(bk, bp):.3e})")
    require(loss_err <= 1e-4, f"step losses differ by {loss_err}")
    require(grad_err <= 1e-4, f"logits-conv gradients differ by {grad_err}")


def input_grad_kernel_vs_plain(model, imgs, labs):
    """Phase 24, the input ascent: the gradient of the clean loss with
    respect to the image through the upsample + CE kernels and through the
    plain version, on the same image and dropout masks (train-mode
    BatchNorm, running statistics untouched): within 1e-4 (max abs error
    over max abs value); the entries whose sign differs are counted."""
    size = tuple(labs.shape[1:])
    npix = (labs != 255).sum().clamp_min(1)
    grads = []
    with deterministic(), frozen_bn_stats(model):
        model.train()
        for op in (trce.fused_resize_nll_sums,
                   trce.fused_resize_nll_sums_plain):
            torch.manual_seed(0)
            x = imgs.clone().requires_grad_(True)
            lo = model.forward_logits(x.permute(0, 3, 1, 2))
            (g,) = torch.autograd.grad(op(lo, labs, size).sum() / npix, x)
            grads.append(g)
        torch.cuda.synchronize()
    gk, gp = grads
    err = rel_err(gk, gp)
    flips = int((torch.sign(gk) != torch.sign(gp)).sum())
    print(f"    input gradient {tuple(gk.shape)}, kernels vs plain: rel err "
          f"{err:.3e}; sign differs at {flips} of {gk.numel()} entries (a "
          f"sign step moves those pixels by 2 gamma), so the plain step "
          f"below takes the kernel step's adversarial image")
    require(err <= 1e-4, f"input gradients differ by {err}")


def ce_library(size, lab64, window=None):
    """The library composition F.interpolate + F.cross_entropy + per-entry
    sum for labels of ``size``; on a row ``window`` of a resize by an
    integral factor, the interpolate of the window by that factor (whose
    output row j is global row ``factor * y0 + j``: the source index of
    each row past the window's first is the global one) cut to the labels'
    rows."""
    def library(x):
        if window is None:
            hi = F.interpolate(x, size=size, mode="bilinear",
                               align_corners=False)
        else:
            hg, Hg, y0, Y0 = window
            fy, fx = Hg // hg, size[1] // x.shape[3]
            hi = F.interpolate(x, scale_factor=(fy, fx), mode="bilinear",
                               align_corners=False,
                               recompute_scale_factor=False)
            hi = hi[:, :, Y0 - fy * y0:Y0 - fy * y0 + size[0]]
        return F.cross_entropy(hi, lab64, reduction="none",
                               ignore_index=255).sum(dim=(1, 2))
    return library


def ce_parts(lo, lab, g, window=None):
    """Timings (ms) at one of the step's shapes (on a row ``window``, a
    row-sharded step's): each kernel in turns with the library composition
    F.interpolate + F.cross_entropy + per-entry sum (library, kernel,
    kernel, library, twice; the backward's library on a kept graph), each
    the device time of calls queued back to back; the plain version
    (forward; backward alone on a kept graph); and the two bounds."""
    size = tuple(lab.shape[1:])
    library = ce_library(size, lab.long(), window)
    x = lo.clone().requires_grad_(True)
    plain_sums = trce.fused_resize_nll_sums_plain(x, lab, size, None, window)
    lib_sums = library(x)
    if window is not None:
        # the composition computes the window's function (in f32: in bf16
        # it rounds where the plain version does not)
        err = rel_err(library(lo.float()), plain_sums.detach())
        require(err <= CE_SUM_TOL, f"the library composition on the window "
                                   f"{window} is off by {err}")
    calls = {
        "fwd": lambda: krce.resize_ce_forward(lo, lab, None, window),
        "bwd": lambda: krce.resize_ce_backward(lo, lab, g, None, window),
        "lib_fwd": lambda: library(lo),
        "lib_bwd": lambda: torch.autograd.grad(lib_sums, x, g,
                                               retain_graph=True),
    }
    turns = {}
    for theirs, ours in (("lib_fwd", "fwd"), ("lib_bwd", "bwd")):
        got = turns[theirs] = {theirs: [], ours: []}
        for k in (theirs, ours, ours, theirs) * 2:
            got[k].append(queued_ms(calls[k], reps=50))
    out = {
        "fwd": float(np.mean(turns["lib_fwd"]["fwd"])),
        "bwd": float(np.mean(turns["lib_bwd"]["bwd"])),
        "lib_fwd": float(np.mean(turns["lib_fwd"]["lib_fwd"])),
        "lib_bwd": float(np.mean(turns["lib_bwd"]["lib_bwd"])),
        "turns": turns,
        "plain_fwd": cuda_ms(
            lambda: trce.fused_resize_nll_sums_plain(lo, lab, size, None,
                                                     window), reps=20),
        "plain_bwd": cuda_ms(lambda: torch.autograd.grad(
            plain_sums, x, g, retain_graph=True), reps=20),
    }
    b, c, h = lo.shape[:3]
    hg, Hg = (h, size[0]) if window is None else window[:2]
    valid = int((lab != 255).sum())
    lo_bytes, lab_bytes = lo.numel() * lo.element_size(), lab.numel() * 4
    interp = CE_LERP_OPS * (1 + hg / Hg)
    fwd_ops = interp + CE_LSE_OPS
    bwd_ops = fwd_ops + CE_SOFTMAX_GRAD_OPS + interp
    for half, nbytes, ops in (
            ("fwd", lo_bytes + lab_bytes + b * 4,
             valid * (c * fwd_ops + CE_PIXEL_OPS)),
            ("bwd", 2 * lo_bytes + lab_bytes + b * 4,
             valid * (c * bwd_ops + CE_PIXEL_OPS))):
        out[f"{half}_bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        out[f"{half}_ops_ms"] = ops / F32_OPS_PER_S * 1e3
    return out


def profile_step(step, n=3, label="A-FAN", per_call=1):
    """Where the device time of ``label`` steps goes: torch.profiler over
    ``n`` calls of ``step()`` (each ``per_call`` steps) after a warmup call;
    the device's busy share of the wall time and the kernels with the most
    device time. Returns the per-step wall and busy ms and the kernel
    events (None when the trace holds no device time)."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    steps = n * per_call
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / steps
    # user annotations (the optimizer's "Optimizer.step#..." range) are
    # spans over kernels, not kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if not busy_ms:
        print("    profile: the trace holds no device time (not measured)")
        return None
    launches = sum(e.count for e in kernels) / steps
    print(f"    profile of {steps} {label} steps: {wall_ms:.3f} ms wall per "
          f"step, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {launches:.0f} device kernels "
          f"per step; top kernels by device time per step:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3 / steps
        print(f"      {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% "
              f"x{e.count // steps:<4d} {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels": kernels,
            "steps": steps}


def time_seg_steps(card, model, imgs, labs):
    """Phase 10, the steps: the A-FAN and base steps' times and peak
    memory, and where the A-FAN step's device time goes."""
    for afan, name in ((True, "A-FAN"), (False, "base")):
        step = seg_step(model, afan)
        t = cuda_samples(lambda: step(imgs, labs), 20)
        torch.cuda.reset_peak_memory_stats()
        step(imgs, labs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"    {name} step, batch {SEG_BATCH}, crop {SEG_CROP}: median "
              f"{np.median(t):.3f} ms, p90 {np.percentile(t, 90):.3f} ms over "
              f"{len(t)} steps, {SEG_BATCH * 1e3 / np.median(t):.2f} imgs/s, "
              f"peak memory {peak:.2f} GiB ({card})")
    step = seg_step(model)
    profile_step(lambda: step(imgs, labs))


def ptxas_lines(log, key):
    """The lines of a ``ptxas -v`` log about the kernels whose mangled
    names contain ``key``."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = key in line
        if keep:
            out.append(line.strip())
    return out


def time_ce_kernels(card, labs, per_step, dtype=torch.float32):
    """Phase 10 (and 29 for bfloat16 logits), the kernels: what ptxas and
    the card report of the two upsample + CE kernels, and each kernel in
    turns with the library composition, its plain version and its bound at
    the step's shapes, on ``dtype`` logits. Returns the two kernels' entries
    of the kernels line (times per A-FAN step: its B=4 sites and its B=8
    spectrum site; names ending in ``_bf16`` for bfloat16)."""
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    if not suffix:
        log = kbuild.build_log("resize_ce.cu")
        for key in ("resize_ce_fwd", "resize_ce_bwd_bands"):
            for line in (ptxas_lines(log, key)
                         or [f"no ptxas record of {key}"]):
                print(f"    ptxas: {line}")
    h = SEG_CROP // 4
    for kind in ("forward", "backward"):
        info = krce.kernel_info(kind, 19, h, h, SEG_CROP, SEG_CROP, dtype)
        print(f"    {kind} kernel at C=19 {h}->{SEG_CROP} on {dtype}: {info} "
              f"({card})")
    # the step's sites: SE and SD ascents, clean and SD losses at B=4; the
    # two stacked spectrum tails at B=8
    shapes = {SEG_BATCH: per_step - 1, 2 * SEG_BATCH: 1}
    total = {}
    rng = np.random.RandomState(5)
    for b, count in shapes.items():
        lab = labs.repeat(b // SEG_BATCH, 1, 1).to(torch.int32).contiguous()
        lo = cuda(rng.randn(b, 19, h, h).astype(np.float32)).to(dtype)
        parts = ce_parts(lo, lab, torch.ones(b, device="cuda"))
        for k, v in parts.items():
            if k != "turns":
                total[k] = total.get(k, 0.0) + count * v
        print(f"    resize+CE {dtype} B={b} {h}->{SEG_CROP} C=19 (x{count} "
              f"per step): "
              f"forward kernel {parts['fwd']:.4f} ms, plain "
              f"{parts['plain_fwd']:.4f}, library {parts['lib_fwd']:.4f}, "
              f"bound max(bytes {parts['fwd_bytes_ms']:.5f}, operations "
              f"{parts['fwd_ops_ms']:.5f}); backward kernel "
              f"{parts['bwd']:.4f} ms, plain {parts['plain_bwd']:.4f}, "
              f"library {parts['lib_bwd']:.4f}, bound max(bytes "
              f"{parts['bwd_bytes_ms']:.5f}, operations "
              f"{parts['bwd_ops_ms']:.5f}) ({card})")
        for theirs, got in parts["turns"].items():
            (t_name, t_ms), (o_name, o_ms) = got.items()
            print(f"    B={b} in turns ({t_name}, {o_name}, {o_name}, "
                  f"{t_name}, twice): {o_name} {[round(t, 4) for t in o_ms]}"
                  f" ms, mean {np.mean(o_ms):.4f}; {t_name} "
                  f"{[round(t, 4) for t in t_ms]} ms, mean "
                  f"{np.mean(t_ms):.4f}; {o_name} "
                  f"{np.mean(t_ms) / np.mean(o_ms):.2f}x faster ({card})")
    entries = []
    for half, name, line in (("fwd", "resize_ce_forward" + suffix, 92),
                             ("bwd", "resize_ce_backward" + suffix, 127)):
        byte_ms, op_ms = total[f"{half}_bytes_ms"], total[f"{half}_ops_ms"]
        entries.append({
            "name": name, "route": "cuda",
            "source": "afan_torch/csrc/resize_ce.cu",
            "replaces": f"afan/ops/kernels/resize_ce_kernel.py:{line}",
            "ms": total[half], "plain_ms": total[f"plain_{half}"],
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": total[f"lib_{half}"]})
        print(f"    {name} per A-FAN step ({per_step} launches): kernel "
              f"{total[half]:.4f} ms, plain {total[f'plain_{half}']:.4f}, "
              f"library {total[f'lib_{half}']:.4f}, bound "
              f"{max(byte_ms, op_ms):.5f} ms ({entries[-1]['bound_by']}); "
              f"kernel at {total[half] / max(byte_ms, op_ms):.1f}x its bound")
    return entries


def segmentation_phases(card, kernels_only=False):
    """Phases 7-10 (with ``kernels_only``, phase 7 and the kernel timings
    of phase 10); returns the upsample + CE kernels' entries and the
    (shape, clip) of the PGD updates of the segmentation trainer."""
    errs = {"fwd": [], "bwd": []}
    ce_kernels_vs_plain(errs)
    per_step, launches, updates = (seg_launches_per_step(seg_recipe())[0],
                                   None, [])
    if kernels_only:
        print(f"[10] upsample + CE kernel timing on {card} (no trainer)")
        _, labs = seg_batch()
    else:
        fwd, bwd, per_step, _, updates = train_full_width()
        launches = (fwd, bwd)
        gc.collect()
        torch.cuda.empty_cache()
        model, imgs, labs = seg_model_and_batch()
        step_kernel_vs_plain(model, imgs, labs)
        print(f"[10] timing on {card}")
        time_seg_steps(card, model, imgs, labs)
        del model, imgs
        gc.collect()
        torch.cuda.empty_cache()
    entries = time_ce_kernels(card, labs, per_step)
    for i, (entry, half) in enumerate(zip(entries, ("fwd", "bwd"))):
        entry["launches"] = launches[i] if launches else None
        entry["max_abs_err"] = max(errs[half])
    return entries, sorted(set(updates))


def bits_equal(a, b):
    """Bit-equal, NaN included: the integer views of the same width are
    compared."""
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


SPECIAL = (0.0, -0.0, 1e-40, -1e-40, 1e-45, float("nan"), float("inf"),
           -float("inf"))


def pgd_inputs(shape, seed):
    """Seeded x, g, c on the card; g holds zeros, -0, denormals, NaN and
    infinities among normal values."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = int(np.prod(shape))
    x, g, c = (torch.randn(n, generator=gen, device="cuda")
               for _ in range(3))
    pos = torch.randperm(n, generator=gen, device="cuda")[:min(n, 1024)]
    special = torch.tensor(SPECIAL, device="cuda")
    g[pos] = special[torch.arange(len(pos), device="cuda") % len(SPECIAL)]
    return tuple(t.reshape(shape) for t in (x, g, c))


def pgd_case(name, x, g, c, clip, errs, gamma=ALFA_GAMMA, eps=ALFA_EPS):
    """Kernel (twice) and plain version on the same inputs: bit-equal, and
    the largest |kernel - plain| over entries finite in both goes to
    ``errs``."""
    kw = dict(gamma=gamma, eps=eps if clip else None, clip=clip)
    centre = c if clip else None
    got = kpgd.pgd_update(x, g, centre, **kw)
    again = kpgd.pgd_update(x, g, centre, **kw)
    want = tpgd.pgd_update_plain(x, g, centre, **kw)
    torch.cuda.synchronize()
    finite = torch.isfinite(got) & torch.isfinite(want)
    errs.append(float((got - want)[finite].abs().max()) if finite.any()
                else 0.0)
    same, repeat = bits_equal(got, want), bits_equal(got, again)
    print(f"  {name}: shape {tuple(x.shape)} clip={clip} gamma={gamma:.6g}: "
          f"bit-equal {same}, repeat bit-equal {repeat}")
    require(same, f"PGD-update kernel != plain on {name} clip={clip}")
    require(repeat, f"two runs of the PGD-update kernel differ on {name}")


def pgd_kernel_vs_plain(seg_updates, errs):
    """Phase 11; ``seg_updates`` holds the (shape, clip) that the
    segmentation trainer and the variant paths recorded."""
    print("[11] PGD-update kernel vs plain version")
    special = torch.tensor(SPECIAL + (2.0, -3.0), device="cuda")
    print(f"    torch.sign on the card of {special.tolist()}: "
          f"{torch.sign(special).tolist()}")
    model = resnet56().cuda().eval()
    with torch.no_grad():
        feats = model.multi_head(torch.zeros(CLS_BATCH, 3, 32, 32,
                                             device="cuda"),
                                 (ALFA_TAP,) + LEARNABLE_TAPS)
    cls_shapes = sorted({tuple(f.shape) for f in feats}, reverse=True)
    del model, feats
    # the sizes of tests/test_kernels.py:9-31, odd counts (a float4 pass
    # and a scalar tail; fewer than 4 elements), the ALFA and learnable taps
    # and the segmentation trainer's and the variant paths' ascents
    cases = [((128,), False), ((4, 33, 7), False), ((2, 16, 16, 16), False),
             ((3, 50), True), ((1001,), False), ((1001,), True),
             ((3,), True), ((2_097_153,), True)]
    cases += [(s, clip) for s in cls_shapes for clip in (False, True)]
    cases += [(s, clip) for s in sorted({s for s, _ in seg_updates})
              for clip in (False, True)]
    for i, (shape, clip) in enumerate(cases):
        pgd_case(f"case {i}", *pgd_inputs(shape, i), clip, errs)
    x, g, c = pgd_inputs((4097,), 99)
    for clip in (False, True):
        # views one float off 16-byte alignment take the scalar loop
        pgd_case("all views offset", x[1:], g[1:], c[1:], clip, errs)
        pgd_case("x offset", x[1:], g[:-1], c[:-1], clip, errs)
    x, g, c = pgd_inputs((4096,), 7)
    x[:8] = torch.tensor(SPECIAL, device="cuda")
    c[8:16] = torch.tensor(SPECIAL, device="cuda")
    for clip in (False, True):
        pgd_case("special x and centre", x, g, c, clip, errs)
        pgd_case("gamma 0.3 eps 0.2", x, g, c, clip, errs, 0.3, 0.2)
    print(f"    {len(errs)} cases bit-equal; classification tap shapes "
          f"{cls_shapes}; segmentation and variant ascent shapes "
          f"{sorted({s for s, _ in seg_updates}) or 'not run'}")


def run_classify_cli(mode, flags, batches, tag):
    """One run of the classification CLI at full width on synthetic
    CIFAR-10, ``batches`` steps, one validation and one test pass; checks
    its losses and outputs. Returns (kernel launches in the run, losses,
    save_dir)."""
    save_dir = os.path.join("checkpoints", f"chip_smoke_classify_{tag}")
    shutil.rmtree(save_dir, ignore_errors=True)
    losses = []
    real = train_classify.build_step

    def recording(*a, **kw):
        step = real(*a, **kw)

        def run(*args):
            out = step(*args)
            losses.append(float(out["loss"]))
            return out
        return run

    train_classify.build_step = recording
    kpgd.launches = 0
    t0 = time.time()
    try:
        best = train_classify.main(
            ["--mode", mode, "--epochs", "1", "--limit_batches", str(batches),
             "--batch_size", str(CLS_BATCH), "--seed", "0", "--print_freq",
             "1", "--data", os.path.join(ROOT, "no_cifar_here"),
             "--save_dir", save_dir] + flags)
        torch.cuda.synchronize()
    finally:
        train_classify.build_step = real
    launches = kpgd.launches
    secs = time.time() - t0
    require(len(losses) == batches and np.isfinite(losses).all(),
            f"{tag}: losses {losses}")
    for f in ("checkpoint.pt", "best_model.pt", "result.pkl",
              "result_norm.pkl"):
        require(os.path.isfile(os.path.join(save_dir, f)), f"{tag}: no {f}")
    saved = torch.load(os.path.join(save_dir, "checkpoint.pt"),
                       map_location="cpu", weights_only=True)
    require(saved["epoch"] == 1 and saved["step"] == batches
            and all(bool(torch.isfinite(v).all())
                    for v in saved["state_dict"].values()
                    if v.is_floating_point()),
            f"{tag}: checkpoint is not the finished run's")
    with open(os.path.join(save_dir, "result.pkl"), "rb") as f:
        result = pickle.load(f)
    with open(os.path.join(save_dir, "result_norm.pkl"), "rb") as f:
        norms = pickle.load(f)
    require([len(v) for v in result.values()] == [1, 1, 1]
            and 0.0 <= result["test_ta"][0] <= 100.0,
            f"{tag}: result.pkl {result}")
    require(mode == "base" or norms["l2"][1] > 0,
            f"{tag}: result_norm.pkl {norms}")
    print(f"    {tag}: {batches} steps + validation + test in {secs:.1f} s; "
          f"losses {[round(v, 4) for v in losses]}; val {result['ta'][0]:.2f} "
          f"test {result['test_ta'][0]:.2f} (best {best:.2f}); perturbation "
          f"L2 {norms['l2'].get(1)}; PGD-update launches {launches}")
    return launches, losses, save_dir, result


def train_classify_full_width():
    """Phase 12; returns the ALFA run's kernel launches."""
    print(f"[12] train: ALFA ResNet-56, CIFAR-10 (synthetic), batch "
          f"{CLS_BATCH}, tap {ALFA_TAP}, {ALFA_STEPS} PGD steps")
    t0 = time.time()
    cifar.synthetic_arrays(seed=0)
    print(f"    synthetic CIFAR-10 (50k + 10k images) made on the host in "
          f"{time.time() - t0:.1f} s, once: every CLI run below reuses it")
    n = CLS_ALFA_BATCHES
    alfa, _, alfa_dir, result = run_classify_cli("alfa", [], n, "alfa")
    require(alfa == ALFA_STEPS * n,
            f"ALFA: {alfa} PGD-update launches in {n} steps (expected "
            f"{ALFA_STEPS} per step)")
    n = CLS_SHORT_BATCHES
    # the learnable recipe (`afan/train/loop.py:LearnableConfig`): 3 steps
    # of 1/255; the CLI's defaults are ALFA's
    learn, *_ = run_classify_cli(
        "learnable", ["--steps", str(LEARNABLE_STEPS), "--gamma", "1.0"], n,
        "learnable")
    per = LEARNABLE_STEPS * len(LEARNABLE_TAPS)
    require(learn == per * n,
            f"learnable: {learn} launches in {n} steps (expected {per})")
    clip, *_ = run_classify_cli(
        "alfa", ["--clip", "--randinit", "--device_data"], n,
        "alfa_clip_randinit_device_data")
    require(clip == ALFA_STEPS * n,
            f"ALFA with clip: {clip} launches in {n} steps")
    acc = infer_classify.main(
        ["--pretrained", os.path.join(alfa_dir, "best_model.pt"),
         "--batch_size", str(CLS_BATCH), "--data",
         os.path.join(ROOT, "no_cifar_here")])
    # the same weights on the same test set as the run's own test pass;
    # a logit tie broken the other way may move an image or two
    require(abs(acc - result["test_ta"][0]) <= 0.05,
            f"infer_classify read {acc} from best_model.pt, the run's test "
            f"pass {result['test_ta'][0]}")
    print(f"    PGD-update launches: ALFA {alfa} = {ALFA_STEPS} per step, "
          f"learnable {learn} = {per} per step, ALFA with clip {clip}; "
          f"infer_classify on best_model.pt: test {acc:.2f}")
    return alfa


def cls_batch(seed):
    x, y, _, _ = cifar.synthetic_arrays(CLS_BATCH, 1, 10, seed)
    return cuda(x.astype(np.float32) / 255.0), cuda(y)


def cls_step(mode, schedule=None, seed=0, dtype=torch.float32):
    """A fresh seeded ResNet-56 (compute dtype ``dtype``) on the card and a
    ``mode`` step with the CLI's optimizer (lr 0.1, momentum 0.9, wd 5e-4,
    the CLI's warmup + multistep schedule at 351 steps per epoch; base and
    alfa on the device count of a ``CapturableSGD``, whose schedule
    ``schedule`` replaces)."""
    spe = 45000 // CLS_BATCH
    milestones = [50 * spe, 150 * spe]
    init = 1.0 / 9 if mode == "learnable" else 1.0
    model = resnet56(init_weight_eta=init,
                     generator=torch.Generator().manual_seed(seed),
                     dtype=dtype).cuda()
    if mode == "learnable":
        opt, sched = learnable_sgd(
            model, multistep_warmup_schedule(0.1, milestones,
                                             warmup_steps=spe),
            0.1, 0.01, 0.9, 5e-4)
        return model, cls_loop.make_learnable_step(
            model, opt, sched, cls_loop.LearnableConfig())
    if schedule is None:
        schedule = multistep_warmup_schedule_tensor(0.1, milestones,
                                                    warmup_steps=spe)
    opt, sched = capturable_sgd(list(model.parameters()), schedule, 0.1,
                                0.9, 5e-4)
    if mode == "base":
        return model, cls_loop.make_base_step(model, opt, sched)
    return model, cls_loop.make_alfa_step(model, opt, sched,
                                          cls_loop.AlfaConfig())


def alfa_step_kernel_vs_plain():
    """Phase 13: the same step, from the same weights and batch, with the
    kernel and with the plain update, in full f32 with deterministic
    cuDNN."""
    print("[13] ALFA step with the kernel vs with the plain update")
    x, y = cls_batch(0)
    real_pgd = cls_loop.pgd
    runs = []
    try:
        with deterministic():
            for update in (tpgd.pgd_update, tpgd.pgd_update_plain):
                # a constant lr: the CLI's schedule starts at lr 0
                model, step = cls_step(
                    "alfa", schedule=lambda count: torch.full_like(
                        count, 0.1, dtype=torch.float64))
                advs = []

                def recording_pgd(*a, **kw):
                    advs.append(real_pgd(*a, **kw))
                    return advs[-1]

                cls_loop.pgd = recording_pgd
                kpgd.launches = 0
                with patched_update(update):
                    out = step(x, y)
                torch.cuda.synchronize()
                runs.append(({k: float(v) for k, v in out.items()}, advs[0],
                             {k: v.detach().clone()
                              for k, v in model.state_dict().items()
                              if v.is_floating_point()}, kpgd.launches))
    finally:
        cls_loop.pgd = real_pgd
    (mk, ak, pk, lk), (mp, ap, pp, lp) = runs
    metric_err = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in mk)
    param_err = max(float((pk[k] - pp[k]).abs().max())
                    / max(float(pp[k].abs().max()), 1e-30) for k in pk)
    print(f"    metrics kernel {mk}")
    print(f"    metrics plain  {mp}")
    print(f"    PGD-update launches {lk} (kernel) and {lp} (plain); "
          f"adversarial feature {tuple(ak.shape)} bit-equal "
          f"{bits_equal(ak, ap)}; largest metric rel err {metric_err:.3e}; "
          f"largest parameter / running-statistic rel err {param_err:.3e}")
    require(lk == ALFA_STEPS and lp == 0,
            f"launches {lk} with the kernel, {lp} with the plain update")
    require(bits_equal(ak, ap), "adversarial features differ")
    require(metric_err <= 1e-6, f"metrics differ by {metric_err}")
    require(param_err <= 1e-6, f"updated parameters differ by {param_err}")


def queued_ms(fn, reps=100):
    """Device ms per call of ``fn``: a sleep kernel holds the card while the
    host queues every call, so the events time the calls back to back on
    the card and not the host's launch rate."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def back_to_back_us(fn, reps=200):
    """Wall microseconds per call of ``fn`` called back to back and then
    synchronised: the host's cost per call where it exceeds the card's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def time_pgd_update(card, shape, dtype=torch.float32, gamma=ALFA_GAMMA,
                    eps=ALFA_EPS):
    """The kernel, its plain version and the bound at ``shape`` on
    ``dtype`` tensors, with and without the clip: per-call device ms,
    inputs cycled through 8 sets (above the 50 MB L2 at the trainers'
    shapes) so each call reads them from HBM; and the wall time per call
    back to back."""
    n = int(np.prod(shape))
    sets = itertools.cycle([tuple(t.to(dtype) for t in
                                  pgd_inputs(shape, 100 + i))
                            for i in range(8)])
    size = torch.tensor([], dtype=dtype).element_size()
    out = {}
    for clip in (False, True):
        kw = dict(gamma=gamma, eps=eps if clip else None, clip=clip)

        def call(fn):
            x, g, c = next(sets)
            return fn(x, g, c if clip else None, **kw)

        k_ms = queued_ms(lambda: call(kpgd.pgd_update))
        p_ms = queued_ms(lambda: call(tpgd.pgd_update_plain))
        k_us = back_to_back_us(lambda: call(tpgd.pgd_update))
        p_us = back_to_back_us(lambda: call(tpgd.pgd_update_plain))
        byte_ms = (3 + clip) * size * n / HBM_BYTES_PER_S * 1e3
        op_ms = (PGD_CLIP_OPS if clip else PGD_OPS) * n / F32_OPS_PER_S * 1e3
        out[clip] = (k_ms, p_ms, byte_ms, op_ms)
        print(f"    pgd_update {shape} {dtype} clip={clip}: kernel "
              f"{k_ms:.5f} ms, "
              f"plain {p_ms:.5f} ms, bound max(bytes {byte_ms:.5f}, "
              f"operations {op_ms:.6f}) ms; kernel at "
              f"{k_ms / max(byte_ms, op_ms):.2f}x its bound; back to back, "
              f"through ops.pgd_step: {k_us:.1f} us per call with the "
              f"kernel, {p_us:.1f} us plain ({card})")
    return out


def time_classify(card):
    """Phase 14; returns the kernel's per-ALFA-step times and bound."""
    print(f"[14] timing on {card}")
    x, y = cls_batch(1)
    medians = {}
    for mode, n in (("alfa", 10), ("base", 10), ("learnable", 5)):
        _, step = cls_step(mode)
        t = cuda_samples(lambda: step(x, y), n)
        torch.cuda.reset_peak_memory_stats()
        step(x, y)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        medians[mode] = float(np.median(t))
        print(f"    {mode} step, ResNet-56, batch {CLS_BATCH}: median "
              f"{np.median(t):.3f} ms, p90 {np.percentile(t, 90):.3f} ms over "
              f"{len(t)} steps, {CLS_BATCH * 1e3 / np.median(t):.1f} imgs/s, "
              f"peak memory {peak:.3f} GiB ({card})")
        if mode == "alfa":
            alfa_step = step
    # the same step with the plain update, in turns with the kernel:
    # kernel, plain, plain, kernel, 10 steps each
    turns = {tpgd.pgd_update: [], tpgd.pgd_update_plain: []}
    for update in (tpgd.pgd_update, tpgd.pgd_update_plain,
                   tpgd.pgd_update_plain, tpgd.pgd_update):
        with patched_update(update):
            t = cuda_samples(lambda: alfa_step(x, y), 10)
        turns[update].append(float(np.median(t)))
    for update, meds in turns.items():
        print(f"    ALFA step with {update.__name__}: medians of 2 turns of "
              f"10 steps {[round(m, 3) for m in meds]} ms, their median "
              f"{np.median(meds):.3f} ms ({card})")
    profile_step(lambda: alfa_step(x, y), n=5, label="ALFA")
    k_ms, p_ms, byte_ms, op_ms = time_pgd_update(
        card, (CLS_BATCH, 16, 32, 32))[False]
    print(f"    pgd_update per ALFA step ({ALFA_STEPS} launches): kernel "
          f"{ALFA_STEPS * k_ms:.5f} ms = "
          f"{100 * ALFA_STEPS * k_ms / medians['alfa']:.3f}% of the step, "
          f"plain {ALFA_STEPS * p_ms:.5f} ms, bound "
          f"{ALFA_STEPS * max(byte_ms, op_ms):.5f} ms ({card})")
    return {"ms": ALFA_STEPS * k_ms, "plain_ms": ALFA_STEPS * p_ms,
            "bound_ms": ALFA_STEPS * max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def classification_phases(card, seg_updates):
    """Phases 11-14; returns the PGD-update kernel's entry."""
    errs = []
    pgd_kernel_vs_plain(seg_updates, errs)
    launches = train_classify_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    alfa_step_kernel_vs_plain()
    times = time_classify(card)
    return {"name": "pgd_update", "route": "cuda",
            "source": "afan_torch/csrc/pgd_step.cu",
            "replaces": "afan/ops/kernels/pgd_step.py:40",
            "launches": launches, "max_abs_err": max(errs), **times,
            "library_ms": None}


# recipes/detect_voc07_final_setting1.sh's flags but --bf16 (not ported),
# its output directory and its length; the data is the synthetic VOC
DET_BATCH, DET_STEPS = 8, 2
DET_FLAGS = ["--variant", "afan", "-s", "voc2007", "-b", "resnet50",
             "--batch_size", str(DET_BATCH), "--learning_rate", "0.008",
             "--step_lr_sizes", "[6250, 8750]", "--mix_layer", "0011",
             "--pertub_idx_se", "2", "--gamma_se", "1.0", "--gamma_sd", "0.1",
             "--sd_adv_loss_weight", "0.3", "--only_roi_sd"]
DET_OUT = os.path.join("checkpoints", "chip_smoke_detect")
DET_BACKBONE = os.path.join(DET_OUT, "resnet50_calibrated.pth")
DET_EVAL_IMAGES = 16


def det_launches_per_step(cfg, advtrain_steps=None):
    """(proposal NMS, PGD-update) launches per detection step of ``cfg`` (an
    A-FAN family config; None for the baseline; ``advtrain_steps`` for the
    input-adversarial step). NMS runs once per forward that samples: with
    ``share_proposals`` the shared sample and the SD pass (the ROI tap), or
    each SD ascent step and the SD loss term (the RPN tap, which makes its
    proposals in every forward); without it also every SE and input ascent
    step, the clean forward and each tail, and under ``remat_tails`` each
    spectrum tail once more, in its recompute. Each sign step launches one
    update: the input ascent's under ``input_adv``, each tap's and SD's."""
    if advtrain_steps is not None:
        return advtrain_steps + 1, advtrain_steps
    if cfg is None:
        return 1, 0
    sd, taps = cfg.sd is not None, len(cfg.taps_se)
    inp = cfg.input_adv * cfg.input_adv_steps
    ascents = inp + (taps + sd) * cfg.steps
    spectrum = (cfg.spectrum - 1 if taps else 0) * (1 + cfg.remat_tails)
    tails = spectrum + max(taps - 1, 0)
    sd_nms = {"roi": 1, "rpn": cfg.steps + 1, None: 0}[cfg.sd]
    nms = 1 + sd_nms if cfg.share_proposals else (
        ascents - sd * cfg.steps + sd_nms + 1 + tails)
    return nms, ascents * (cfg.step_mode == "sign")


def det_recipe():
    args = train_detect.get_parser().parse_args(DET_FLAGS)
    return train_detect.afan_config_for(args)


def calibrated_backbone(seed=0):
    """Write a seeded random ResNet-50 torso, in torchvision's keys, to
    ``DET_BACKBONE``, for ``--pretrained_backbone``. The recipe starts from
    an ImageNet backbone whose frozen BatchNorms fit their inputs; with
    identity statistics the random torso's activations grow block by block
    and the recipe's SGD diverges within a few steps. So each frozen
    BatchNorm takes its input's per-channel mean and variance on a
    synthetic VOC batch, in one forward in which each one is set before it
    runs."""
    torso = det_model(seed, backbone=None).features

    def fit(bn, inputs):
        var, mean = torch.var_mean(inputs[0], dim=(0, 2, 3), correction=0)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)

    hooks = [m.register_forward_pre_hook(fit) for m in torso.modules()
             if isinstance(m, FrozenBatchNorm)]
    try:
        with torch.no_grad():
            torso(det_batch(seed + 1)[0].permute(0, 3, 1, 2), 0, 4)
    finally:
        for h in hooks:
            h.remove()
    os.makedirs(DET_OUT, exist_ok=True)
    torch.save(torso.state_dict(), DET_BACKBONE)
    return DET_BACKBONE


DET_FACTORIES = {"baseline": "make_baseline_det_step",
                 "advtrain": "make_advtrain_det_step"}


def det_expected(factory, a, kw):
    """(NMS, PGD-update) launches per step of the step that
    ``train_detect.<factory>(*a, **kw)`` builds."""
    if factory == "make_afan_det_step":
        return det_launches_per_step(a[3])
    if factory == "make_advtrain_det_step":
        return det_launches_per_step(None, kw.get("steps", inspect.signature(
            detect_loop.make_advtrain_det_step).parameters["steps"].default))
    return det_launches_per_step(None)


def run_detect_cli(variant, steps, tag, extra=(), updates=None):
    """One run of the detection CLI at full width with the recipe's flags
    and ``--variant variant``, until step ``steps``, and its final mAP; with
    ``updates``, the (shape, clip) of each PGD update is appended to it.
    Returns (per-step (NMS, PGD-update) launches, losses, NMS launches of
    the final eval, mAP, output directory)."""
    out = os.path.join(DET_OUT, tag)
    if not extra:
        shutil.rmtree(out, ignore_errors=True)
    per_step, losses, expected = [], [], []
    factory = DET_FACTORIES.get(variant, "make_afan_det_step")
    real = getattr(train_detect, factory)

    def recording(*a, **kw):
        step = real(*a, **kw)
        expected.append(det_expected(factory, a, kw))

        def run(*args):
            before = (knms.launches, kpgd.launches)
            res = step(*args)
            per_step.append((knms.launches - before[0],
                             kpgd.launches - before[1]))
            losses.append({k: float(v) for k, v in res.items()})
            return res
        return run

    setattr(train_detect, factory, recording)
    knms.launches = kpgd.launches = 0
    t0 = time.time()
    try:
        with (patched_update(recording_update(updates)) if updates is not None
              else contextlib.nullcontext()):
            mean_ap = train_detect.main(
                DET_FLAGS + ["--variant", variant, "-o", out, "--data_dir",
                             os.path.join(ROOT, "no_voc_here"),
                             "--num_steps_to_finish", str(steps),
                             "--num_steps_to_snapshot", str(steps),
                             "--num_steps_to_display", "1",
                             "--pretrained_backbone", DET_BACKBONE]
                + list(extra))
        torch.cuda.synchronize()
    finally:
        setattr(train_detect, factory, real)
    secs = time.time() - t0
    eval_nms = knms.launches - sum(n for n, _ in per_step)
    require(all(np.isfinite(v) for rec in losses for v in rec.values()),
            f"{tag}: non-finite loss in {losses}")
    require(per_step == expected * len(per_step),
            f"{tag}: (NMS, PGD-update) launches per step {per_step}, "
            f"expected {expected}")
    require(eval_nms == 2 * DET_EVAL_IMAGES,
            f"{tag}: {eval_nms} NMS launches in the final eval (expected 2 "
            f"per image)")
    saved = torch.load(os.path.join(out, f"model-{steps}.pt"),
                       map_location="cpu", weights_only=True)
    require(saved["step"] == steps
            and saved["scheduler_state_dict"]["last_epoch"] == steps
            and len(saved["optimizer_state_dict"]["state"]) > 0
            and all(bool(torch.isfinite(v).all())
                    for v in saved["state_dict"].values()
                    if v.is_floating_point()),
            f"{tag}: model-{steps}.pt is not the finished run's")
    require(0.0 <= mean_ap <= 1.0, f"{tag}: mAP {mean_ap}")
    print(f"    {tag}: {len(per_step)} steps + the final mAP of "
          f"{DET_EVAL_IMAGES} images in {secs:.1f} s (the first step "
          f"includes cuDNN set-up); losses "
          f"{[round(r['loss'], 4) for r in losses]}; (NMS, PGD-update) "
          f"launches per step {per_step[0] if per_step else None}, NMS in "
          f"the eval {eval_nms}; mAP {mean_ap:.4f}; model-{steps}.pt")
    return per_step, losses, eval_nms, mean_ap, out


def train_detect_full_width():
    """Phase 15; returns the (NMS, PGD-update) kernel launches of the
    training path (steps and final evals) and the A-FAN steps' losses."""
    print(f"[15] train: A-FAN Faster R-CNN ResNet-50, VOC final setting 1, "
          f"batch {DET_BATCH}, synthetic VOC")
    print(f"    backbone: seeded random weights, frozen-BatchNorm statistics "
          f"fitted on a synthetic VOC batch: {calibrated_backbone()}")
    afan, afan_losses, ev1, _, out = run_detect_cli("afan", DET_STEPS,
                                                    "afan")
    resumed, _, ev2, _, _ = run_detect_cli(
        "afan", DET_STEPS + 1, "afan",
        ["--resume_checkpoint", os.path.join(out, f"model-{DET_STEPS}.pt")])
    require(len(resumed) == 1, f"the resumed run took {len(resumed)} steps")
    base, _, ev3, _, _ = run_detect_cli("baseline", 2, "baseline")
    steps = afan + resumed + base
    nms = sum(n for n, _ in steps) + ev1 + ev2 + ev3
    pgd = sum(p for _, p in steps)
    print(f"    NMS launches {nms} ({len(afan) + len(resumed)} A-FAN steps x "
          f"2 + {len(base)} baseline steps x 1 + 3 evals x "
          f"{2 * DET_EVAL_IMAGES}); PGD-update launches {pgd}")
    return nms, pgd, afan_losses


def det_batch(seed=0):
    loader, _, _ = voc_detection_loaders(None, DET_BATCH, MIN_SIDE, MAX_SIDE,
                                         seed)
    b = next(iter(loader))
    return (cuda(b.images), cuda(b.boxes), cuda(b.labels.astype(np.int64)),
            cuda(b.valid))


def det_model(seed=0, backbone=DET_BACKBONE):
    """The recipe's ResNet-50 Faster R-CNN (21 classes) on the card, from
    seeded weights, its torso from ``backbone`` where given."""
    model = FasterRCNN(FRCNNConfig())
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if backbone:
        overlap_restore(model.features, load_checkpoint(backbone))
    return model.cuda()


def det_step(model, afan=True, cfg=None):
    """The recipe's A-FAN step (``cfg``: another A-FAN family config) or
    the baseline step, with the recipe's optimizer."""
    opt, sched = sgd(detect_loop.detection_param_groups(model),
                     warmup_multistep_schedule(0.008, [6250, 8750]), 0.008,
                     0.9, 5e-4)
    if afan:
        return detect_loop.make_afan_det_step(model, opt, sched,
                                              cfg or det_recipe())
    return detect_loop.make_baseline_det_step(model, opt, sched)


def recording_nms(fn, calls):
    """NMS keep-mask function that runs ``fn`` and appends its inputs and
    keep mask to ``calls``."""
    def run(boxes, valid, thr, plus_one=True):
        keep = fn(boxes, valid, thr, plus_one)
        calls.append((boxes.clone(), valid.clone(), thr, plus_one,
                      keep.clone()))
        return keep
    return run


def det_step_kernel_vs_plain(model, batch, cfg=None, label="[16] A-FAN"):
    """Phase 16: one A-FAN step (``cfg``: another A-FAN family config) with
    the NMS and PGD-update kernels and one with their plain versions, from
    the same weights and batch and the same seeded generator (so the same
    draws), in full f32. Returns the recorded NMS calls of the kernel step
    and the PGD updates' inputs."""
    cfg = cfg or det_recipe()
    print(f"{label} detection step with the kernels vs with the plain "
          f"NMS and PGD update")
    state = copy.deepcopy(model.state_dict())
    runs, updates = [], []

    def update_recorder(fn):
        def update(x, g, center=None, **kw):
            updates.append((x.contiguous().clone(), g.contiguous().clone()))
            return fn(x, g, center, **kw)
        return update

    try:
        with deterministic():
            for nms_fn, update in ((knms.nms_sorted_mask, tpgd.pgd_update),
                                   (tnms.nms_sorted_mask_plain,
                                    tpgd.pgd_update_plain)):
                model.load_state_dict(state)
                step = det_step(model, cfg=cfg)
                calls = []
                with patched_nms(recording_nms(nms_fn, calls)), \
                        patched_update(update_recorder(update)):
                    out = step(*batch, torch.Generator("cuda").manual_seed(0))
                params = {n: p.detach().clone()
                          for n, p in model.named_parameters()
                          if p.requires_grad}
                runs.append(({k: float(v) for k, v in out.items()}, calls,
                             params))
            torch.cuda.synchronize()
    finally:
        model.load_state_dict(state)
    (lk, ck, pk), (lp, cp, pp) = runs
    n_nms = det_launches_per_step(cfg)[0]
    require(len(ck) == len(cp) == n_nms,
            f"{len(ck)}, {len(cp)} NMS calls (expected {n_nms})")
    for (bk, vk, _, _, kk), (bp, vp, _, _, kp) in zip(ck, cp):
        require(torch.equal(bk, bp) and torch.equal(vk, vp),
                "the NMS inputs differ between the kernel and plain steps")
        require(torch.equal(kk, kp), "keep masks differ")
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lk)
    param_err = max(float(torch.linalg.vector_norm(pk[n] - pp[n])
                          / torch.linalg.vector_norm(pp[n]).clamp_min(1e-30))
                    for n in pk)
    kept = [c[4].sum(1).tolist() for c in ck]
    print(f"    proposal NMS G={ck[0][0].shape[0]} N={ck[0][0].shape[1]}: "
          f"keep masks identical, kept per image {kept}")
    print(f"    losses kernel {lk}")
    print(f"    losses plain  {lp}")
    print(f"    largest loss rel err {loss_err:.3e}; updated parameters "
          f"{len(pk)} tensors, largest L2 rel err {param_err:.3e}")
    require(loss_err <= 1e-4, f"step losses differ by {loss_err}")
    require(param_err <= 1e-4, f"updated parameters differ by {param_err}")
    return ck, updates[:len(updates) // 2]


def time_det_steps(card, model, batch):
    """Phase 17, the steps: the A-FAN and baseline steps' times and peak
    memory, and where the A-FAN step's device time goes."""
    gen = torch.Generator("cuda").manual_seed(1)
    medians = {}
    for afan, name, n in ((True, "A-FAN", 5), (False, "baseline", 5)):
        step = det_step(model, afan)
        t = cuda_samples(lambda: step(*batch, gen), n, warmup=2)
        torch.cuda.reset_peak_memory_stats()
        step(*batch, gen)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        medians[name] = float(np.median(t))
        print(f"    {name} detection step, batch {DET_BATCH}, canvas "
              f"{tuple(batch[0].shape[1:3])}: median {np.median(t):.3f} ms, "
              f"p90 {np.percentile(t, 90):.3f} ms over {len(t)} steps, "
              f"{DET_BATCH * 1e3 / np.median(t):.2f} imgs/s, peak memory "
              f"{peak:.2f} GiB ({card})")
    step = det_step(model)
    # the A-FAN step with each image's ROIs pooled from its own rows (the
    # path) in turns with the concatenated contraction over all images'
    # rows: per-image, concatenated, concatenated, per-image
    turns = {"per-image": [], "concatenated": []}
    for how in ("per-image", "concatenated"):
        for name in (how, "per-image" if how == "concatenated"
                     else "concatenated"):
            with patched_pooler(name == "concatenated"):
                t = cuda_samples(lambda: step(*batch, gen), 4, warmup=1)
            turns[name].append(float(np.median(t)))
    for name, meds in turns.items():
        print(f"    A-FAN step with the {name} ROIAlign contraction: medians "
              f"of 2 turns of 4 steps {[round(m, 3) for m in meds]} ms, "
              f"their median {np.median(meds):.3f} ms ({card})")
    profile_step(lambda: step(*batch, gen), n=3, label="A-FAN detection")
    return medians


@contextlib.contextmanager
def patched_pooler(concatenated):
    """With ``concatenated``, pool each image's boxes through the contraction
    over all images' rows (``roi_align_einsum`` with batch indices) instead
    of the per-image one, for the duration of the block."""
    saved = roi_head.pool_rois
    if concatenated:
        def pool(feat, boxes, batch_indices=None, mode="align"):
            bidx = torch.arange(boxes.shape[0], device=boxes.device)
            return saved(feat, boxes.reshape(-1, 4),
                         bidx.repeat_interleave(boxes.shape[1]), mode)
        roi_head.pool_rois = pool
    try:
        yield
    finally:
        roi_head.pool_rois = saved


def time_det_kernels(card, nms_calls, updates, afan_ms):
    """Phase 17, the kernels at the A-FAN step's own shapes: the proposal
    NMS on the step's real proposals (G=8, N=12000; both of the step's
    launches take the same proposals) and the two PGD updates (the layer-2
    feature and the pooled ROI vector). Returns their per-step entries."""
    boxes, valid, thr, plus_one, _ = nms_calls[0]
    require(all(torch.equal(boxes, c[0]) for c in nms_calls),
            "the step's two proposal NMS took different proposals")
    k, p, b, o = time_nms_shape(card, "training proposals", boxes, valid,
                                thr, plus_one)
    n = det_launches_per_step(det_recipe())[0]
    print(f"    nms per A-FAN step ({n} launches): kernel {n * k:.4f} ms = "
          f"{100 * n * k / afan_ms:.3f}% of the step, plain {n * p:.3f} ms, "
          f"bound {n * max(b, o):.6f} ms ({card})")
    nms = {"ms": n * k, "plain_ms": n * p, "bound_ms": n * max(b, o),
           "bound_by": "bytes" if b >= o else "operations"}
    pgd = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    parts = []
    for x, _ in updates:
        k_ms, p_ms, byte_ms, op_ms = time_pgd_update(card,
                                                     tuple(x.shape))[False]
        pgd["ms"] += k_ms
        pgd["plain_ms"] += p_ms
        pgd["bound_ms"] += max(byte_ms, op_ms)
        parts.append("bytes" if byte_ms >= op_ms else "operations")
    pgd["bound_by"] = max(set(parts), key=parts.count)
    print(f"    pgd_update per A-FAN step ({len(updates)} launches, shapes "
          f"{[tuple(x.shape) for x, _ in updates]}): kernel {pgd['ms']:.5f} "
          f"ms = {100 * pgd['ms'] / afan_ms:.4f}% of the step, plain "
          f"{pgd['plain_ms']:.5f} ms, bound {pgd['bound_ms']:.5f} ms "
          f"({card})")
    return nms, pgd


def detection_training_phases(card):
    """Phases 15-17; returns the NMS and PGD-update kernels' entries for
    the detection training path."""
    nms_launches, pgd_launches, _ = train_detect_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    model, batch = det_model(), det_batch()
    nms_calls, updates = det_step_kernel_vs_plain(model, batch)
    nms_err = [0.0]
    for boxes, valid, thr, plus_one, _ in nms_calls:
        kernel_vs_plain("training proposals", boxes, valid, thr, plus_one,
                        nms_err)
    pgd_err = []
    for x, g in updates:
        for clip in (False, True):
            pgd_case(f"detection ascent {tuple(x.shape)}", x, g, x, clip,
                     pgd_err)
    print(f"[17] timing on {card}")
    medians = time_det_steps(card, model, batch)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    nms, pgd = time_det_kernels(card, nms_calls, updates, medians["A-FAN"])
    return (
        {"name": "nms", "route": "cuda", "source": "afan_torch/csrc/nms.cu",
         "replaces": "afan/ops/kernels/nms_kernel.py:65",
         "launches": nms_launches, "max_abs_err": max(nms_err), **nms,
         "library_ms": None},
        {"name": "pgd_update", "route": "cuda",
         "source": "afan_torch/csrc/pgd_step.cu",
         "replaces": "afan/ops/kernels/pgd_step.py:40",
         "launches": pgd_launches, "max_abs_err": max(pgd_err), **pgd,
         "library_ms": None})


# The variants of both trainers (phases 22-26) at the recipes' width: the
# flags of SEG_FLAGS and DET_FLAGS with another --variant, two steps a run.
SEG_VARIANT_RUNS = (("advtrain", ()), ("sat", ()),
                    ("sat_multi", ("--mix_all",)))
DET_VARIANT_RUNS = ("advtrain", "sat", "multi", "single")
VARIANT_STEPS = 2


def seg_variant_args(variant, extra=()):
    return train_segment.get_parser().parse_args(
        SEG_FLAGS + ["--variant", variant] + list(extra))


def seg_expected(args):
    """(upsample + CE launches each way, PGD-update launches) per step of
    the step that ``train_segment.build_step`` builds for ``args``; under
    ``--fused_ce off`` no upsample + CE kernel launches."""
    if args.variant == "advtrain":
        sites, pgd = seg_launches_per_step(None, args.steps)
    elif args.variant == "baseline":
        sites, pgd = seg_launches_per_step(None)
    else:
        sites, pgd = seg_launches_per_step(train_segment.afan_config(args))
    return (0 if args.fused_ce == "off" else sites), pgd


def run_segment_cli(variant, extra, updates):
    """Phase 22, one run: ``train_segment.main`` with the recipe's flags
    and ``--variant variant``, ``VARIANT_STEPS`` iterations and one
    validation; the (shape, clip) of each PGD update is appended to
    ``updates``. Returns the run's (forward, backward, PGD-update)
    launches."""
    tag = f"chip_variant_{variant}"
    for d in os.listdir("checkpoints") if os.path.isdir("checkpoints") else ():
        if d.startswith(f"cityscapes_{tag}_"):
            shutil.rmtree(os.path.join("checkpoints", d))
    per_step, losses, expected = [], [], []
    real = train_segment.build_step

    def recording(args, *a):
        step = real(args, *a)
        expected.append(seg_expected(args))

        def run(images, labels, generator=None):
            before = (krce.fwd_launches, krce.bwd_launches, kpgd.launches)
            out = step(images, labels, generator)
            per_step.append((krce.fwd_launches - before[0],
                             krce.bwd_launches - before[1],
                             kpgd.launches - before[2]))
            losses.append({k: float(v) for k, v in out.items()})
            return out
        return run

    train_segment.build_step = recording
    t0 = time.time()
    try:
        with patched_update(recording_update(updates)):
            score = train_segment.main(
                SEG_FLAGS + ["--variant", variant] + list(extra)
                + ["--limit_itrs", str(VARIANT_STEPS), "--val_interval",
                   str(VARIANT_STEPS), "--print_interval", "1", "--exp", tag])
        torch.cuda.synchronize()
    finally:
        train_segment.build_step = real
    secs = time.time() - t0
    name = " ".join([variant] + list(extra))
    (sites, pgd), = expected
    require(len(losses) == VARIANT_STEPS, f"{name}: {len(losses)} steps ran")
    require(all(np.isfinite(v) for rec in losses for v in rec.values()),
            f"{name}: non-finite loss in {losses}")
    require(per_step == [(sites, sites, pgd)] * VARIANT_STEPS,
            f"{name}: (forward, backward, PGD-update) launches per step "
            f"{per_step}, expected {(sites, sites, pgd)}")
    dirs = [d for d in os.listdir("checkpoints")
            if d.startswith(f"cityscapes_{tag}_")]
    path = os.path.join("checkpoints", dirs[0] if dirs else "",
                        f"latest_{SEG_MODEL}_cityscapes.pt")
    require(len(dirs) == 1 and os.path.isfile(path),
            f"{name}: no checkpoint written")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    require(saved["cur_itrs"] == VARIANT_STEPS
            and all(bool(torch.isfinite(v).all())
                    for v in saved["model_state"].values()
                    if v.is_floating_point()),
            f"{name}: the checkpoint is not the finished run's")
    print(f"    {name}: {VARIANT_STEPS} steps + 1 validation in {secs:.1f} s; "
          f"losses {[round(r['loss'], 4) for r in losses]}; mIoU "
          f"{score:.4f}; per step: upsample + CE {sites} forward and "
          f"{sites} backward launches, PGD-update {pgd}, as expected; "
          f"checkpoint {path}")
    return tuple(int(sum(c)) for c in zip(*per_step))


def variant_step(trainer, model, variant, extra=()):
    """The train step that the ``trainer`` CLI (``"seg"`` or ``"det"``)
    builds for ``--variant variant`` with the recipe's flags, with the
    recipe's optimizer."""
    if trainer == "seg":
        return train_segment.build_step(seg_variant_args(variant, extra),
                                        model, *seg_optimizer(model))
    args = train_detect.get_parser().parse_args(
        DET_FLAGS + ["--variant", variant])
    opt, sched = sgd(detect_loop.detection_param_groups(model),
                     warmup_multistep_schedule(0.008, [6250, 8750]), 0.008,
                     0.9, 5e-4)
    if variant == "advtrain":
        return detect_loop.make_advtrain_det_step(model, opt, sched)
    return detect_loop.make_afan_det_step(model, opt, sched,
                                          train_detect.afan_config_for(args))


def time_variant_steps(card, trainer, model, inputs, runs):
    """Phase 26, the steps: each variant step's device time (median and p90
    of 3 steps after 1) and peak memory."""
    gen = torch.Generator("cuda").manual_seed(2)
    for variant, extra in runs:
        step = variant_step(trainer, model, variant, extra)
        t = cuda_samples(lambda: step(*inputs, gen), 3, warmup=1)
        torch.cuda.reset_peak_memory_stats()
        step(*inputs, gen)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        bsz = inputs[0].shape[0]
        print(f"    {trainer} {' '.join((variant,) + tuple(extra))} step, "
              f"batch {bsz}, {tuple(inputs[0].shape[1:3])}: median "
              f"{np.median(t):.3f} ms, p90 {np.percentile(t, 90):.3f} ms over "
              f"{len(t)} steps, {bsz * 1e3 / np.median(t):.2f} imgs/s, peak "
              f"memory {peak:.2f} GiB ({card})")


def variant_phases(card, own_pgd_check):
    """Phases 22-26. The PGD-update shapes that the variant paths record go
    to phase 11's bit-for-bit cases; with ``own_pgd_check`` (phase 11 does
    not run) phase 25 holds the kernel to its plain version on them here.
    Returns the launches of the variant runs per kernel of the kernels
    line, the recorded (shape, clip) and the PGD update's times at the
    segmentation input shape."""
    print("[22] train the segmentation variants at full width: "
          + ", ".join(" ".join((v,) + e) for v, e in SEG_VARIANT_RUNS))
    updates = []
    fwd = bwd = pgd = 0
    for variant, extra in SEG_VARIANT_RUNS:
        f, b, p = run_segment_cli(variant, extra, updates)
        fwd, bwd, pgd = fwd + f, bwd + b, pgd + p
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[23] train the detection variants at full width: "
          f"{', '.join(DET_VARIANT_RUNS)}")
    calibrated_backbone()
    nms = 0
    for variant in DET_VARIANT_RUNS:
        per_step, _, eval_nms, _, _ = run_detect_cli(
            variant, VARIANT_STEPS, f"variant_{variant}", updates=updates)
        nms += sum(n for n, _ in per_step) + eval_nms
        pgd += sum(p for _, p in per_step)
    gc.collect()
    torch.cuda.empty_cache()

    model, imgs, labs = seg_model_and_batch()
    cfg = train_segment.afan_config(seg_variant_args("sat_multi",
                                                     ["--mix_all"]))
    step_kernel_vs_plain(
        model, imgs, labs, cfg, updates,
        "[24] segmentation sat_multi --mix_all step with the kernels vs "
        "with the plain upsample + CE and PGD update")
    print(f"[26] timing on {card}: the segmentation variants")
    time_variant_steps(card, "seg", model, (imgs, labs), SEG_VARIANT_RUNS)
    del model, imgs, labs
    gc.collect()
    torch.cuda.empty_cache()

    model, batch = det_model(), det_batch()
    args = train_detect.get_parser().parse_args(
        DET_FLAGS + ["--variant", "multi"])
    nms_calls, det_updates = det_step_kernel_vs_plain(
        model, batch, train_detect.afan_config_for(args), "[24] multi")
    nms_err = [0.0]
    for boxes, valid, thr, plus_one, _ in nms_calls:
        kernel_vs_plain("multi step proposals", boxes, valid, thr, plus_one,
                        nms_err)
    updates += [(tuple(x.shape), clip) for x, _ in det_updates
                for clip in (False, True)]
    print(f"[26] timing on {card}: the detection variants")
    time_variant_steps(card, "det", model, batch,
                       [(v, ()) for v in DET_VARIANT_RUNS])
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()

    shapes = sorted(set(updates))
    print(f"    PGD-update (shape, clip) on the variant paths: {shapes}")
    pgd_err = [0.0]
    if own_pgd_check:
        print("[25] PGD-update kernel vs plain version at the variant paths' "
              "shapes")
        for i, shape in enumerate(sorted({s for s, _ in shapes})):
            for clip in (False, True):
                pgd_case(f"variant shape {i}", *pgd_inputs(shape, 300 + i),
                         clip, pgd_err)
    print(f"[26] PGD-update kernel at the input shapes ({card})")
    seg_input = (SEG_BATCH, SEG_CROP, SEG_CROP, 3)
    det_input = next(s for s, _ in shapes if len(s) == 4 and s[-1] == 3
                     and s[0] == DET_BATCH)
    times = time_pgd_update(card, seg_input)
    time_pgd_update(card, det_input)
    k_ms, p_ms, byte_ms, op_ms = times[True]
    return {"launches": {"nms": (nms, max(nms_err)),
                         "resize_ce_forward": (fwd, None),
                         "resize_ce_backward": (bwd, None),
                         "pgd_update": (pgd, max(pgd_err))},
            "updates": shapes,
            "pgd_times": {"ms": k_ms, "plain_ms": p_ms,
                          "bound_ms": max(byte_ms, op_ms),
                          "bound_by": ("bytes" if byte_ms >= op_ms
                                       else "operations")}}

# recipes/seg_voc07_final1.sh (MIX 01) and recipes/seg_city_final.sh (sweep
# 1) as written, --bf16 included, with no data flag (the synthetic VOC and
# Cityscapes): phases 27-29.
BF16_RECIPES = (("seg_voc07_final1.sh", {"MIX": "01"}),
                ("seg_city_final.sh", {"N": "1", "GAMMASE": "0.02",
                                       "MIX": "01"}))
# iterations (steps) of each recipe run through a CLI
RECIPE_STEPS = 2
# (name, B, (h, w), (H, W), C): the bf16 logits of the VOC recipe's sites
# (crop 513), the Cityscapes recipe's (crop 768) and its B=8 spectrum site
BF16_CE_CASES = [("voc513", 4, (129, 129), (513, 513), 21),
                 ("city768", 4, (192, 192), (768, 768), 19),
                 ("city768_b8", 8, (192, 192), (768, 768), 19)]
# The bf16 gradient against the plain version's (max abs error over max abs
# value): the f32 kernels' tolerance plus each side's rounding to bf16, at
# most half an ulp, 2^-9 of the largest value, each.
BF16_GRAD_TOL = CE_GRAD_TOL + 2 * 2.0 ** -9


def recipe_flags(name, env, cli="train_segment"):
    """The flags that ``recipes/<name>`` passes to afan's ``cli``, with its
    shell variables set to ``env`` and its data flag (``$(seg_smoke_flags)``
    or ``$(det_smoke_flags)``) left out."""
    with open(os.path.join(ROOT, "recipes", name)) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if f"-m afan.cli.{cli}" in ln)
    for k, v in env.items():
        line = line.replace("${%s}" % k, v)
    for smoke in ("$(seg_smoke_flags)", "$(det_smoke_flags)"):
        line = line.replace(smoke, "")
    require("$" not in line, f"a shell variable is left in {line}")
    argv = shlex.split(line)
    return argv[argv.index(f"afan.cli.{cli}") + 1:]


def seg_counts():
    return (krce.fwd_launches, krce.bwd_launches, kpgd.launches,
            krce.bf16_fwd_launches, krce.bf16_bwd_launches,
            kpgd.bf16_launches)


def run_seg_recipe(tag, flags, dtype, updates, fractions=None,
                   step_times=None, steps=RECIPE_STEPS):
    """One run of ``train_segment.main`` with ``flags`` (phases 27, 40 and
    49): ``steps`` iterations and one validation, every kernel count read
    around each step against ``seg_launches_per_step``, the model's compute
    dtype ``dtype``; each PGD update's (shape, clip, gamma, dtype, share of
    entries changed) goes to ``updates``; with ``fractions``, the line
    ``--pretrained_backbone`` logs must hold it; with ``step_times``, each
    step's start and end (``perf_counter``, its losses read back) are
    appended to it. Returns the run's (forward, backward, PGD-update, and
    their bf16) launches."""
    argv = flags + ["--limit_itrs", str(steps), "--val_interval",
                    str(steps), "--print_interval", "1", "--exp",
                    "chip_" + tag]
    args = train_segment.get_parser().parse_args(argv)
    prefix = f"{args.dataset}_chip_{tag}_"
    for d in os.listdir("checkpoints") if os.path.isdir("checkpoints") else ():
        if d.startswith(prefix):
            shutil.rmtree(os.path.join("checkpoints", d))
    per_step, losses, expected, built = [], [], [], []
    real = train_segment.build_step

    def recording(args_, model, *a):
        built.append((model.dtype, next(model.parameters()).dtype,
                      type(model.backbone).__name__,
                      sum(isinstance(m, AtrousSeparableConv)
                          for m in model.modules())))
        step = real(args_, model, *a)
        expected.append(seg_expected(args_))

        def run(images, labels, generator=None):
            before = seg_counts()
            t0 = time.perf_counter()
            out = step(images, labels, generator)
            losses.append({k: float(v) for k, v in out.items()})
            if step_times is not None:
                step_times.append((t0, time.perf_counter()))
            per_step.append(tuple(x - y for x, y in
                                  zip(seg_counts(), before)))
            return out
        return run

    train_segment.build_step = recording
    start = seg_counts()
    t0 = time.time()
    try:
        with patched_update(share_recording_update(updates)):
            score = train_segment.main(argv)
        torch.cuda.synchronize()
    finally:
        train_segment.build_step = real
    secs = time.time() - t0
    total = tuple(x - y for x, y in zip(seg_counts(), start))
    (sites, pgd), = expected
    bf16 = dtype == torch.bfloat16
    want = (sites, sites, pgd) + ((sites, sites, pgd) if bf16 else (0,) * 3)
    (model_dtype, param_dtype, backbone, separable), = built
    require((model_dtype, param_dtype, args.bf16) == (dtype, torch.float32,
                                                      bf16),
            f"{tag}: model compute and parameter dtypes {model_dtype}, "
            f"{param_dtype}; expected {dtype}, float32")
    require((backbone == "MobileNetV2Backbone") == ("mobilenet" in args.model)
            and bool(separable) == args.separable_conv,
            f"{tag}: built {backbone} with {separable} separable convs")
    require(len(losses) == steps
            and all(np.isfinite(v) for r in losses for v in r.values()),
            f"{tag}: losses {losses}")
    require(per_step == [want] * steps and total == tuple(
        steps * w for w in want),
            f"{tag}: (forward, backward, PGD-update; bf16 forward, backward, "
            f"PGD-update) launches per step {per_step}, run {total}; "
            f"expected {want} per step")
    dirs = [d for d in os.listdir("checkpoints") if d.startswith(prefix)]
    path = os.path.join("checkpoints", dirs[0] if dirs else "",
                        f"latest_{args.model}_{args.dataset}.pt")
    require(len(dirs) == 1 and os.path.isfile(path),
            f"{tag}: no checkpoint written")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    require(saved["cur_itrs"] == steps
            and all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
                    for v in saved["model_state"].values()
                    if v.is_floating_point()),
            f"{tag}: the checkpoint is not the finished run's f32 state")
    note = ""
    if fractions is not None:
        with open(os.path.join("checkpoints", dirs[0], "train.log")) as f:
            lines = [ln for ln in f if "ImageNet backbone loaded" in ln]
        require(len(lines) == 1 and fractions in lines[0],
                f"{tag}: logged {lines}, expected {fractions}")
        note = f"; logged: ImageNet backbone loaded {fractions}"
    print(f"    {tag} ({args.model}{' --separable_conv' * bool(separable)}"
          f", {args.dataset}, crop {args.crop_size}, batch "
          f"{args.batch_size}, {str(dtype)[6:]}): {steps} steps + 1 "
          f"validation in {secs:.1f} s; losses "
          f"{[round(r['loss'], 4) for r in losses]}; mIoU {score:.4f}; per "
          f"step {sites} upsample + CE launches each way and {pgd} PGD "
          f"updates, as expected{note}; checkpoint {path}")
    return total


def bf16_recipes(updates):
    """Phase 27: both recipes, each run's PGD updates in ``updates[name]``;
    returns the bf16 launches of both runs."""
    print("[27] train the segmentation recipes as written (--bf16) at full "
          "width: " + ", ".join(n for n, _ in BF16_RECIPES))
    totals = [0, 0, 0]
    for name, env in BF16_RECIPES:
        run = run_seg_recipe("bf16_" + os.path.splitext(name)[0],
                             recipe_flags(name, env), torch.bfloat16,
                             updates.setdefault(name, []))
        totals = [t + r for t, r in zip(totals, run[3:])]
        gc.collect()
        torch.cuda.empty_cache()
    print_update_shares(sum(updates.values(), []))
    return totals


def share_recording_update(updates):
    """``pgd_update`` that appends each call's (shape, clip, gamma, dtype,
    share of entries it changed) to ``updates``; it reads the share back,
    so it cannot run inside a CUDA-graph capture."""
    def update(x, g, center=None, **kw):
        out = tpgd.pgd_update(x, g, center, **kw)
        updates.append((tuple(x.shape), bool(kw.get("clip")), kw["gamma"],
                        x.dtype, float((out != x).float().mean())))
        return out
    return update


def print_update_shares(updates):
    """The share of entries each bf16 ascent's update changed, by shape and
    step size."""
    shares = {}
    for shape, _, gamma, _, changed in updates:
        shares.setdefault((shape, round(gamma * 255, 4)), []).append(changed)
    for (shape, gamma), got in sorted(shares.items()):
        print(f"    bf16 PGD update at {shape}, gamma {gamma}/255: it "
              f"changed {100 * np.mean(got):.2f}% of the entries (mean of "
              f"{len(got)} updates; a step below half a bf16 ulp rounds "
              f"back to x, as in afan)")


def bf16_ce_case(name, B, hw, HW, C, errs, seed=0):
    """Both upsample + CE kernels on bf16 logits of one geometry against the
    plain version: sums within ``CE_SUM_TOL`` and equal to the f32 kernel's
    on the widened logits, the gradient the f32 kernel's rounded to bf16 bit
    for bit and within ``BF16_GRAD_TOL``; the largest absolute errors go to
    ``errs``."""
    lo, lab, g = ce_inputs(B, hw, HW, C, seed=seed)
    lo = lo.bfloat16()
    sums = krce.resize_ce_forward(lo, lab)
    dlo = krce.resize_ce_backward(lo, lab, g)
    sums32 = krce.resize_ce_forward(lo.float(), lab)
    dlo32 = krce.resize_ce_backward(lo.float(), lab, g)
    want_s = trce.fused_resize_nll_sums_plain(lo, lab, HW)
    want_d = trce.resize_ce_grad_plain(lo, lab, g)
    torch.cuda.synchronize()
    es = rel_err(sums, want_s)
    eg = rel_err(dlo.float(), want_d.float())
    diff = (dlo.float() - want_d.float()).abs()
    errs["fwd"].append(float((sums - want_s).abs().max()))
    errs["bwd"].append(float(diff.max()))
    same = torch.equal(sums, sums32) and torch.equal(dlo, dlo32.bfloat16())
    print(f"  {name}: B={B} {hw}->{HW} C={C} bf16 logits: sums rel "
          f"{es:.3e}; gradient {dlo.dtype}, the f32 kernel's on the "
          f"widened logits rounded to bf16 bit for bit: {same}; against "
          f"the plain version rel {eg:.3e} ({int((diff > 0).sum())} of "
          f"{diff.numel()} entries differ)")
    require(es <= CE_SUM_TOL, f"{name}: bf16 sums rel err {es}")
    require(same, f"{name}: the bf16 kernels differ from the f32 ones "
                  f"on the widened logits")
    require(dlo.dtype == torch.bfloat16 and eg <= BF16_GRAD_TOL,
            f"{name}: bf16 gradient rel err {eg} > {BF16_GRAD_TOL}")


def bf16_kernels_vs_plain(updates, errs):
    """Phase 28: the bf16 paths of the upsample + CE kernels at the
    recipes' shapes (sums within CE_SUM_TOL of the plain version and equal
    to the f32 kernel's on the widened logits; the gradient the f32
    kernel's rounded to bf16, bit for bit, and within BF16_GRAD_TOL of the
    plain version's), and of the PGD update at the shapes of phase 27's
    updates, clipped and not, bit-equal to its plain version."""
    print("[28] bf16 upsample + CE and PGD-update kernels vs their plain "
          "versions")
    for case in BF16_CE_CASES:
        bf16_ce_case(*case, errs)
    lo, lab, g = ce_inputs(4, (129, 129), (513, 513), 21, seed=1)
    x = lo.bfloat16().requires_grad_(True)
    before = (krce.bf16_fwd_launches, krce.bf16_bwd_launches)
    (grad,) = torch.autograd.grad(
        trce.fused_resize_nll_sums(x, lab.long(), (513, 513)), x, g)
    require((krce.bf16_fwd_launches, krce.bf16_bwd_launches)
            == (before[0] + 1, before[1] + 1) and grad.dtype == torch.bfloat16,
            "fused_resize_nll_sums on bf16 logits did not launch the bf16 "
            "kernels")
    pgd_err = []
    cases = sorted({(shape, gamma) for shape, _, gamma, dtype, _ in updates
                    if dtype == torch.bfloat16})
    for i, (shape, gamma) in enumerate(cases):
        x, g, c = (t.bfloat16() for t in pgd_inputs(shape, 400 + i))
        for clip in (False, True):
            pgd_case(f"bf16 recipe shape {i}", x, g, c, clip, pgd_err,
                     gamma, 2.0 / 255)
    print(f"    {len(pgd_err)} bf16 PGD-update cases bit-equal at "
          f"{[c[0] for c in cases]}")
    return max(pgd_err)


def time_bf16_step(card, per_step, city_updates):
    """Phase 29: the Cityscapes recipe's A-FAN step with the model in bf16
    in turns with the f32 step (f32, bf16, bf16, f32; 5 steps each after
    2), from the same weights and batch: median and p90 ms, images
    per second, peak memory, each step's profile; then the bf16 kernels at
    the step's shapes. Returns the bf16 kernels' entries."""
    print(f"[29] timing on {card}: the bf16 A-FAN step in turns with the "
          f"f32 step (Cityscapes recipe, crop {SEG_CROP}, batch {SEG_BATCH})")
    model32, imgs, labs = seg_model_and_batch()
    model16 = build_model(SEG_MODEL, 19, 16, torch.bfloat16)
    model16.reset_parameters(torch.Generator().manual_seed(0))
    model16.cuda()
    steps = {k: (lambda s=s: s(imgs, labs)) for k, s in (
        ("f32", seg_step(model32)), ("bf16", seg_step(model16)))}
    samples = time_in_turns(steps, ("f32", "bf16", "bf16", "f32"), 5,
                            warmup=2)
    med = report_turns(card, samples, steps, SEG_BATCH, "A-FAN step")
    print(f"    bf16 step {med['f32'] / med['bf16']:.2f}x faster than f32 "
          f"(medians in turns, {card})")
    for k in ("bf16", "f32"):
        profile_step(steps[k], label=f"{k} A-FAN")
    del steps, model32, model16, imgs
    gc.collect()
    torch.cuda.empty_cache()
    entries = time_ce_kernels(card, labs, per_step, torch.bfloat16)
    times = pgd_bf16_times(card, unclipped_bf16_gammas(city_updates),
                           "bf16 A-FAN step")
    source, replaces = KERNEL_SOURCES["pgd_update"]
    entries.append({"name": "pgd_update_bf16", "route": "cuda",
                    "source": source, "replaces": replaces, **times,
                    "library_ms": None})
    return entries


def unclipped_bf16_gammas(updates):
    """{shape: step size} of the recorded unclipped bf16 updates."""
    return {shape: gamma for shape, clip, gamma, dtype, _ in updates
            if dtype == torch.bfloat16 and not clip}


def bf16_phases(card):
    """Phases 27-29; returns the bf16 kernels' entries of the kernels
    line."""
    updates = {}
    fwd, bwd, pgd = bf16_recipes(updates)
    gc.collect()
    torch.cuda.empty_cache()
    errs = {"fwd": [], "bwd": []}
    pgd_err = bf16_kernels_vs_plain(sum(updates.values(), []), errs)
    per_step = seg_launches_per_step(seg_recipe())[0]
    entries = time_bf16_step(card, per_step, updates["seg_city_final.sh"])
    for e in entries:
        e["launches"], e["max_abs_err"] = {
            "resize_ce_forward_bf16": (fwd, max(errs["fwd"])),
            "resize_ce_backward_bf16": (bwd, max(errs["bwd"])),
            "pgd_update_bf16": (pgd, pgd_err)}[e["name"]]
    return entries


# recipes/detect_voc07_{baseline,final_setting1,2,3}.sh as written, --bf16
# included, with no data flag (the synthetic VOC), from the calibrated torso
# of phase 15, 2 steps and the final mAP each: phases 30-32.
DET_BF16_RECIPES = ("detect_voc07_baseline.sh",
                    "detect_voc07_final_setting1.sh",
                    "detect_voc07_final_setting2.sh",
                    "detect_voc07_final_setting3.sh")


def nms_shape_recorder(calls, dtypes):
    """NMS keep-mask function: the kernel wrapper, with the boxes' dtype
    added to ``dtypes`` and the first call of each (G, N, thr) kept in
    ``calls``."""
    def run(boxes, valid, thr, plus_one=True):
        keep = knms.nms_sorted_mask(boxes, valid, thr, plus_one)
        dtypes.add(boxes.dtype)
        key = (tuple(valid.shape), thr)
        if key not in calls:
            calls[key] = (boxes.clone(), valid.clone(), thr, plus_one)
        return keep
    return run


def det_recipe_flags(name, tag, env=None):
    """``recipes/<name>``'s flags as written, its output under
    ``DET_OUT/tag``, for ``RECIPE_STEPS`` steps from phase 15's calibrated
    torso."""
    return recipe_flags(name, dict(env or {}, OUT=os.path.join(DET_OUT, tag)),
                        "train_detect") + [
        "--num_steps_to_finish", str(RECIPE_STEPS),
        "--num_steps_to_snapshot", str(RECIPE_STEPS),
        "--num_steps_to_display", "1", "--pretrained_backbone",
        DET_BACKBONE]


def run_det_recipe(tag, argv, dtype, updates, nms_calls=None,
                   eval_images=None, step_times=None):
    """One run of ``train_detect.main(argv)`` (phases 30, 43, 44 and 49):
    ``RECIPE_STEPS`` steps and the final score, every kernel count read
    around each step against ``det_launches_per_step`` and around the whole
    run, the NMS on float32 boxes; the first NMS call of each shape goes to
    ``nms_calls`` and each PGD update's (shape, clip, gamma, dtype, share)
    to ``updates``; with ``step_times``, each step's start and end
    (``perf_counter``, its losses read back) are appended to it. The data
    is synthetic (``DET_EVAL_IMAGES``
    test images) unless ``argv`` names a data directory whose test split
    has ``eval_images``. Returns the run's NMS, PGD-update and bf16
    PGD-update launches."""
    args = train_detect.get_parser().parse_args(argv)
    on_disk = eval_images is not None
    eval_images = eval_images or DET_EVAL_IMAGES
    require((args.bf16, any(a.startswith("--data") for a in argv))
            == (dtype == torch.bfloat16, on_disk),
            f"{tag}: {argv} is not the {'on-disk' if on_disk else 'synthetic'}"
            f" {dtype} run")
    shutil.rmtree(args.outputs_dir, ignore_errors=True)
    factory = ("make_baseline_det_step" if args.variant == "baseline"
               else "make_afan_det_step")
    per_step, losses, expected, built, boxes = [], [], [], [], set()
    real_model, real_step = (train_detect.FasterRCNN,
                             getattr(train_detect, factory))

    def counts():
        return knms.launches, kpgd.launches, kpgd.bf16_launches

    def model_recording(*a):
        model = real_model(*a)
        built.append((model.dtype, {p.dtype for p in model.parameters()},
                      model.cfg))
        return model

    def step_recording(*a, **kw):
        step = real_step(*a, **kw)
        expected.append(det_expected(factory, a, kw))

        def run(*args_):
            before = counts()
            t0 = time.perf_counter()
            res = step(*args_)
            losses.append({k: float(v) for k, v in res.items()})
            if step_times is not None:
                step_times.append((t0, time.perf_counter()))
            per_step.append(tuple(x - y for x, y in zip(counts(), before)))
            return res
        return run

    train_detect.FasterRCNN = model_recording
    setattr(train_detect, factory, step_recording)
    start = counts()
    t0 = time.time()
    try:
        with patched_update(share_recording_update(updates)), \
                patched_nms(nms_shape_recorder(
                    {} if nms_calls is None else nms_calls, boxes)):
            score = train_detect.main(argv)
        torch.cuda.synchronize()
    finally:
        train_detect.FasterRCNN = real_model
        setattr(train_detect, factory, real_step)
    secs = time.time() - t0
    total = tuple(x - y for x, y in zip(counts(), start))
    (n_nms, n_pgd), = expected
    (model_dtype, param_dtypes, cfg), = built
    eval_nms = total[0] - sum(n for n, _, _ in per_step)
    bf16 = dtype == torch.bfloat16
    want = (n_nms, n_pgd, n_pgd * bf16)
    require((model_dtype, param_dtypes) == (dtype, {torch.float32}),
            f"{tag}: model compute and parameter dtypes {model_dtype}, "
            f"{param_dtypes}")
    require(len(losses) == RECIPE_STEPS
            and all(np.isfinite(v) for r in losses for v in r.values()),
            f"{tag}: losses {losses}")
    require(per_step == [want] * RECIPE_STEPS,
            f"{tag}: (NMS, PGD-update, bf16 PGD-update) launches per step "
            f"{per_step}, expected {want}")
    require(eval_nms == 2 * eval_images,
            f"{tag}: {eval_nms} NMS launches in the final eval")
    require(boxes == {torch.float32}, f"{tag}: NMS took {boxes}")
    saved = torch.load(os.path.join(args.outputs_dir,
                                    f"model-{RECIPE_STEPS}.pt"),
                       map_location="cpu", weights_only=True)
    require(saved["step"] == RECIPE_STEPS
            and all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
                    for v in saved["state_dict"].values()
                    if v.is_floating_point()),
            f"{tag}: model-{RECIPE_STEPS}.pt is not the finished run's f32 "
            f"state")
    require(0.0 <= score <= 1.0, f"{tag}: score {score}")
    print(f"    {tag} ({args.variant}, {args.dataset}, {cfg.num_classes} "
          f"classes, anchors {tuple(cfg.anchor_sizes)}, batch "
          f"{args.batch_size}, {str(dtype)[6:]}): {RECIPE_STEPS} steps + the "
          f"final score of {eval_images} images in {secs:.1f} s; losses "
          f"{[round(r['loss'], 4) for r in losses]}; per step {n_nms} NMS "
          f"launches on float32 boxes and {n_pgd} PGD updates, as expected; "
          f"NMS in the eval {eval_nms}; score {score:.4f} (COCO's "
          f"AP@[.5:.95] for the COCO names, else the VOC mAP); "
          f"model-{RECIPE_STEPS}.pt float32")
    return total


def det_bf16_recipes(updates):
    """Phase 30: the four VOC recipes; returns their NMS and bf16
    PGD-update launches."""
    print("[30] train the detection recipes as written (--bf16) at full "
          "width: " + ", ".join(DET_BF16_RECIPES))
    if not os.path.isfile(DET_BACKBONE):
        print(f"    backbone: {calibrated_backbone()}")
    nms = pgd = 0
    for name in DET_BF16_RECIPES:
        tag = "bf16_" + os.path.splitext(name)[0]
        n, _, p = run_det_recipe(tag, det_recipe_flags(name, tag),
                                 torch.bfloat16, updates)
        nms, pgd = nms + n, pgd + p
        gc.collect()
        torch.cuda.empty_cache()
    print_update_shares(updates)
    return nms, pgd


def det_bf16_model(model32):
    """A bf16-compute copy of ``model32`` (same weights) on the card."""
    model = FasterRCNN(FRCNNConfig(), torch.bfloat16)
    model.load_state_dict(model32.state_dict())
    return model.cuda()


def det_bf16_kernels_vs_plain(updates, errs):
    """Phase 31: one bf16 A-FAN step (setting 1) with the NMS and PGD-update
    kernels against one with their plain versions, and the bf16 PGD update
    at every shape and step size of phase 30, clipped and not, bit for bit.
    Returns the step's NMS calls."""
    model32, batch = det_model(), det_batch()
    model = det_bf16_model(model32)
    del model32
    calls, _ = det_step_kernel_vs_plain(model, batch,
                                        label="[31] bf16 A-FAN")
    for b, v, thr, plus_one, _ in calls:
        kernel_vs_plain("bf16 training proposals", b, v, thr, plus_one,
                        errs["nms"])
    cases = sorted({(shape, gamma) for shape, _, gamma, dtype, _ in updates
                    if dtype == torch.bfloat16})
    for i, (shape, gamma) in enumerate(cases):
        x, g, c = (t.bfloat16() for t in pgd_inputs(shape, 500 + i))
        for clip in (False, True):
            pgd_case(f"bf16 detection shape {i}", x, g, c, clip, errs["pgd"],
                     gamma, 2.0 / 255)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return calls


def time_in_turns(steps, order, n, warmup=1):
    """CUDA-event samples of each named step, in the turns ``order``."""
    samples = {k: [] for k in steps}
    for k in order:
        samples[k] += list(cuda_samples(steps[k], n, warmup=warmup))
    return samples


def report_turns(card, samples, steps, batch, what):
    """Median, p90, images per second and peak memory of each step."""
    med = {}
    for k, t in samples.items():
        torch.cuda.reset_peak_memory_stats()
        steps[k]()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        med[k] = float(np.median(t))
        print(f"    {k} {what}: median {med[k]:.3f} ms, p90 "
              f"{np.percentile(t, 90):.3f} ms over {len(t)} steps in turns, "
              f"{batch * 1e3 / med[k]:.2f} imgs/s, peak memory {peak:.2f} GiB "
              f"({card})")
    return med


def time_det_bf16(card, calls, updates):
    """Phase 32: the bf16 A-FAN detection step (setting 1) in turns with the
    f32 step from the same weights and batch (f32, bf16, bf16, f32; 3 steps
    each after 1), each one's profile; then the NMS kernel on the
    bf16 step's proposals and the bf16 PGD update at its two ascent shapes.
    Returns the kernels' entries for this path."""
    print(f"[32] timing on {card}: the bf16 A-FAN detection step in turns "
          f"with the f32 step (setting 1, batch {DET_BATCH}, canvas "
          f"608x1008)")
    model32, batch = det_model(), det_batch()
    model16 = det_bf16_model(model32)
    gen = torch.Generator("cuda").manual_seed(1)
    made = {"f32": det_step(model32), "bf16": det_step(model16)}
    steps = {k: (lambda s=s: s(*batch, gen)) for k, s in made.items()}
    samples = time_in_turns(steps, ("f32", "bf16", "bf16", "f32"), 3)
    med = report_turns(card, samples, steps, DET_BATCH,
                       "A-FAN detection step")
    print(f"    bf16 step {med['f32'] / med['bf16']:.2f}x the f32 step's "
          f"speed (medians in turns, {card})")
    prof = {k: profile_step(steps[k], n=2, label=f"{k} A-FAN detection")
            for k in ("bf16", "f32")}
    if all(prof.values()):
        print(f"    device busy share: bf16 "
              f"{100 * prof['bf16']['busy_ms'] / prof['bf16']['wall_ms']:.1f}"
              f"%, f32 "
              f"{100 * prof['f32']['busy_ms'] / prof['f32']['wall_ms']:.1f}% "
              f"({card})")
    del made, steps, model32, model16, prof
    gc.collect()
    torch.cuda.empty_cache()
    boxes, valid, thr, plus_one, _ = calls[0]
    k, p, b, o = time_nms_shape(card, "bf16 training proposals", boxes,
                                valid, thr, plus_one)
    n = len(calls)
    nms = {"ms": n * k, "plain_ms": n * p, "bound_ms": n * max(b, o),
           "bound_by": "bytes" if b >= o else "operations"}
    pgd = pgd_bf16_times(card, unclipped_bf16_gammas(updates),
                         "bf16 A-FAN detection step")
    return nms, pgd


def pgd_bf16_times(card, gammas, per):
    """The bf16 PGD update at each shape of ``gammas`` (its step size),
    unclipped, summed: kernel, plain and bound ms."""
    k_ms = p_ms = byte_ms = op_ms = 0.0
    for shape, gamma in sorted(gammas.items()):
        k, p, b, o = time_pgd_update(card, shape, torch.bfloat16, gamma,
                                     2.0 / 255)[False]
        k_ms, p_ms, byte_ms, op_ms = k_ms + k, p_ms + p, byte_ms + b, op_ms + o
    print(f"    pgd_update_bf16 per {per} ({len(gammas)} updates at "
          f"{sorted(gammas)}): kernel {k_ms:.5f} ms, plain {p_ms:.5f}, "
          f"bound {max(byte_ms, op_ms):.5f} ms ({card})")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def det_bf16_phases(card):
    """Phases 30-32; returns (launches, error, times) of the NMS and bf16
    PGD-update kernels on this path."""
    updates = []
    nms_launches, pgd_launches = det_bf16_recipes(updates)
    errs = {"nms": [0.0], "pgd": []}
    calls = det_bf16_kernels_vs_plain(updates, errs)
    nms, pgd = time_det_bf16(card, calls, updates)
    return {"nms": (nms_launches, max(errs["nms"]), nms),
            "pgd_update_bf16": (pgd_launches, max(errs["pgd"]), pgd)}


# train_classify --bf16 at full width in each mode (phases 33-35)
CLS_BF16_RUNS = (("base", [], "bf16_base"), ("alfa", [], "bf16_alfa"),
                 ("learnable", ["--steps", str(LEARNABLE_STEPS), "--gamma",
                                "1.0"], "bf16_learnable"))


def cls_bf16_runs(updates):
    """Phase 33: ``train_classify.main --bf16`` in base, ALFA and
    learnable mode (a few steps, validation and test each) and ALFA with
    ``--epoch_scan`` (one epoch of 24 steps: 3 eager, the capture, the rest
    replays): a bf16-compute model with float32 parameters, finite losses,
    a float32 checkpoint, and every PGD-update launch bf16 (5 per ALFA
    step, 27 per learnable step). Returns the bf16 launches the wrappers
    counted."""
    print(f"[33] train_classify --bf16 at full width (ResNet-56, batch "
          f"{CLS_BATCH}): base, alfa, learnable, alfa --epoch_scan")
    built = []
    real = train_classify.build_model

    def recording(args, generator):
        model = real(args, generator)
        built.append((model.dtype, {p.dtype for p in model.parameters()}))
        return model

    per_step = {"base": 0, "alfa": ALFA_STEPS,
                "learnable": LEARNABLE_STEPS * len(LEARNABLE_TAPS)}
    total = 0
    train_classify.build_model = recording
    try:
        with patched_update(share_recording_update(updates)):
            for mode, flags, tag in CLS_BF16_RUNS:
                before = kpgd.bf16_launches
                n = CLS_SHORT_BATCHES
                launches, _, save_dir, _ = run_classify_cli(
                    mode, ["--bf16"] + flags, n, tag)
                bf16 = kpgd.bf16_launches - before
                require(bf16 == launches == per_step[mode] * n,
                        f"{tag}: {bf16} bf16 of {launches} PGD-update "
                        f"launches in {n} steps")
                check_f32_checkpoint(save_dir, tag)
                total += bf16
        # no recorder here: it reads each update back, which a capture
        # cannot
        before = kpgd.bf16_launches
        scan, save_dir, wrapper, _ = run_scan_cli(["--bf16"], 1, "bf16_scan")
        require(kpgd.bf16_launches - before == wrapper,
                f"bf16_scan: {kpgd.bf16_launches - before} bf16 of "
                f"{wrapper} PGD-update launches")
        check_f32_checkpoint(save_dir, "bf16_scan")
        total += wrapper
        del scan
    finally:
        train_classify.build_model = real
    require(built == [(torch.bfloat16, {torch.float32})] * 4,
            f"model compute and parameter dtypes {built}")
    print(f"    every run's model bf16 with float32 parameters; bf16 "
          f"PGD-update launches counted by the wrappers {total}")
    print_update_shares(updates)
    return total


def check_f32_checkpoint(save_dir, tag):
    saved = torch.load(os.path.join(save_dir, "checkpoint.pt"),
                       map_location="cpu", weights_only=True)
    require(all(v.dtype == torch.float32 for v in saved["state_dict"].values()
                if v.is_floating_point()),
            f"{tag}: the checkpoint is not float32")


def cls_bf16_kernels_vs_plain(updates, errs):
    """Phase 34: the bf16 PGD update at every shape and step size of phase
    33 (the ALFA tap and the learnable taps), clipped and not, bit for
    bit."""
    print("[34] bf16 PGD update vs its plain version at the classification "
          "shapes")
    cases = sorted({(shape, gamma) for shape, _, gamma, dtype, _ in updates
                    if dtype == torch.bfloat16})
    for i, (shape, gamma) in enumerate(cases):
        x, g, c = (t.bfloat16() for t in pgd_inputs(shape, 600 + i))
        for clip in (False, True):
            pgd_case(f"bf16 classification shape {i}", x, g, c, clip, errs,
                     gamma, ALFA_EPS)


def time_cls_bf16(card):
    """Phase 35: the graphed bf16 ALFA step in turns with the graphed f32
    one (f32, bf16, bf16, f32, three times, 20 steps each), peak memory and
    each one's profile; the eager bf16 base and learnable steps; the bf16
    PGD update at the ALFA tap. Returns its times per bf16 ALFA step."""
    print(f"[35] timing on {card}: the graphed ALFA step, bf16 in turns "
          f"with f32; the eager bf16 base and learnable steps")
    split = device_split()
    cfg = cls_loop.AlfaConfig()
    scans, args, runs = {}, {}, {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(1)
        perm = torch.randperm(len(split[0]), generator=gen, device="cuda")
        model = resnet56(generator=torch.Generator().manual_seed(1),
                         dtype=dtype).cuda()
        opt, _ = alfa_optimizer(model)
        scans[name] = cls_loop.make_epoch_scan_alfa(model, opt, cfg,
                                                    CLS_BATCH,
                                                    SCAN_CALL_STEPS)
        args[name] = (split[0], split[1], perm, gen)
        scans[name](*args[name])       # 3 eager steps, the capture, replays
        runs[name] = scan_turn(scans[name], args[name])
    steps_per_turn = SCAN_CALL_STEPS * SCAN_TURN_CALLS
    turns = {"f32": [], "bf16": []}
    for name in ("f32", "bf16", "bf16", "f32") * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - t0) * 1e3 / steps_per_turn)
    med = {}
    for name, ts in turns.items():
        med[name] = float(np.median(ts))
        print(f"    graphed ALFA step, {name}: ms per step in 6 turns of "
              f"{steps_per_turn} steps {[round(t, 3) for t in ts]}; median "
              f"{med[name]:.3f} ms, p90 {np.percentile(ts, 90):.3f} ms, "
              f"{CLS_BATCH * 1e3 / med[name]:.1f} imgs/s ({card})")
    print(f"    graphed bf16 ALFA step {med['f32'] / med['bf16']:.2f}x the "
          f"graphed f32 step's speed (medians in turns, {card}); memory "
          f"reserved with both graphs' pools "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB")
    for name in ("bf16", "f32"):
        prof = profile_step(lambda: scans[name](*args[name]), n=1,
                            label=f"graphed {name} ALFA",
                            per_call=SCAN_CALL_STEPS)
        if prof:
            print(f"    device busy share, graphed {name}: "
                  f"{100 * prof['busy_ms'] / prof['wall_ms']:.1f}% ({card})")
    del scans, args, runs, split
    gc.collect()
    torch.cuda.empty_cache()
    x, y = cls_batch(1)
    for mode, n in (("base", 20), ("learnable", 5)):
        _, step = cls_step(mode, dtype=torch.bfloat16)
        t = cuda_samples(lambda: step(x, y), n, warmup=2)
        torch.cuda.reset_peak_memory_stats()
        step(x, y)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"    eager bf16 {mode} step, ResNet-56, batch {CLS_BATCH}: "
              f"median {np.median(t):.3f} ms, p90 {np.percentile(t, 90):.3f} "
              f"ms over {n} steps, {CLS_BATCH * 1e3 / np.median(t):.1f} "
              f"imgs/s, peak memory {peak:.3f} GiB ({card})")
    gc.collect()
    torch.cuda.empty_cache()
    times = pgd_bf16_times(card, {(CLS_BATCH, 16, 32, 32): ALFA_GAMMA},
                           "launch at the ALFA tap")
    return {k: ALFA_STEPS * v if k != "bound_by" else v
            for k, v in times.items()}


def cls_bf16_phases(card):
    """Phases 33-35; returns (launches, error, times per bf16 ALFA step) of
    the bf16 PGD-update kernel on this path."""
    updates, errs = [], []
    launches = cls_bf16_runs(updates)
    gc.collect()
    torch.cuda.empty_cache()
    cls_bf16_kernels_vs_plain(updates, errs)
    times = time_cls_bf16(card)
    return {"pgd_update_bf16": (launches, max(errs), times)}


def merge_launches(entries, parts):
    """Add a path's kernel launches and largest error to the kernels'
    entries; a kernel with no entry yet (an ``--only`` group) gets one with
    this path's times."""
    for name, (launches, err, times) in parts.items():
        entry = next((e for e in entries if e["name"] == name), None)
        if entry is None:
            source, replaces = KERNEL_SOURCES[name.replace("_bf16", "")]
            entries.append({"name": name, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": launches,
                            "max_abs_err": err, "library_ms": None,
                            **times})
            continue
        entry["launches"] = (entry["launches"] or 0) + launches
        entry["max_abs_err"] = max(entry["max_abs_err"], err)


KERNEL_SOURCES = {
    "nms": ("afan_torch/csrc/nms.cu", "afan/ops/kernels/nms_kernel.py:65"),
    "resize_ce_forward": ("afan_torch/csrc/resize_ce.cu",
                          "afan/ops/kernels/resize_ce_kernel.py:92"),
    "resize_ce_backward": ("afan_torch/csrc/resize_ce.cu",
                           "afan/ops/kernels/resize_ce_kernel.py:127"),
    "resize_ce_forward_window": ("afan_torch/csrc/resize_ce.cu",
                                 "afan/ops/kernels/resize_ce_kernel.py:92"),
    "resize_ce_backward_window": ("afan_torch/csrc/resize_ce.cu",
                                  "afan/ops/kernels/resize_ce_kernel.py:127"),
    "pgd_update": ("afan_torch/csrc/pgd_step.cu",
                   "afan/ops/kernels/pgd_step.py:40"),
    "pgd_update_dev": ("afan_torch/csrc/pgd_step.cu",
                       "afan/ops/kernels/pgd_step.py:40"),
}


def merge_variant_launches(entries, variant):
    """Add the variant runs' launches (and the largest errors they
    measured) to the kernels' entries; with no entry for a kernel (``--only
    variants``) add one with what phases 22-26 measured."""
    for name, (launches, err) in variant["launches"].items():
        entry = next((e for e in entries if e["name"] == name), None)
        if entry is None:
            source, replaces = KERNEL_SOURCES[name]
            times = (variant["pgd_times"] if name == "pgd_update" else
                     dict(ms=None, plain_ms=None, bound_ms=None,
                          bound_by=None))
            entries.append({"name": name, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": launches,
                            "max_abs_err": err, **times,
                            "library_ms": None})
            continue
        entry["launches"] = (entry["launches"] or 0) + launches
        if err is not None:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)


# --epoch_scan at full width: 24 steps per epoch (the CLI's --limit_batches)
# for 2 epochs, then a resume for a third; the timing turns run 20 steps
# each, as 4 calls of a 5-step epoch scan.
SCAN_BATCHES, SCAN_EPOCHS = 24, 2
SCAN_CALL_STEPS, SCAN_TURN_CALLS = 5, 2
# graph replays in each profiler trace that counts the PGD-update kernels
# per replay
SCAN_TRACE_REPLAYS = 6
TRAIN_SPLIT = 45000
ROBUST_STEPS = 3


class RecordingScan:
    """The CLI's epoch scan, recorded: the data and generator of its calls
    and each epoch's metrics on the host."""

    def __init__(self, scan):
        self.scan = scan
        self.args = None
        self.epochs = []

    def __getattr__(self, name):
        return getattr(self.scan, name)

    def __call__(self, data_x, data_y, perm, generator):
        self.args = (data_x, data_y, generator)
        out = self.scan(data_x, data_y, perm, generator)
        self.epochs.append({k: v.cpu().numpy() for k, v in out.items()})
        return out


def pgd_kernel_name(clip, bf16=False, dev=False):
    """The aligned PGD-update kernel's instantiation, as the profiler names
    it: clipped with ``clip``, bf16 with ``bf16``, reading its step size on
    the card with ``dev``."""
    return (f"pgd_step_{'bf16_vec8' if bf16 else 'vec4'}"
            f"<{'true' if clip else 'false'}, {'true' if dev else 'false'}>")


def pgd_per_replay(scan, clip, bf16=False, dev=False):
    """PGD-update kernels per replay, by kernel name (the clipped
    instantiation with ``clip``, the bf16 one with ``bf16``, the
    device-step-size one with ``dev``), in a profiler trace of
    ``SCAN_TRACE_REPLAYS`` more replays of ``scan``'s own graph, its step index
    reset to row 0 first. The replays train the model on: run it after the
    run's checkpoint is written. The profiler has lost records on the card
    (a trace short of a few kernels, in the same runs as a trace with no
    device time at all, phase 17), so a trace whose count is not
    ``ALFA_STEPS`` per replay is taken once more, and the second count
    stands."""
    from torch.profiler import ProfilerActivity, profile
    want = pgd_kernel_name(clip, bf16, dev)
    n = min(SCAN_TRACE_REPLAYS, scan.steps_per_epoch)
    for attempt in (1, 2):
        scan.scan._static["i"].zero_()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                scan.graph.replay()
            torch.cuda.synchronize()
        found = {e.key: e.count for e in prof.key_averages()
                 if "pgd_step" in e.key}
        other = [k for k in found if want not in k]
        require(not other, f"PGD kernels {found} in {n} replays")
        per = sum(found.values()) / n
        if per == ALFA_STEPS or attempt == 2:
            return per
        print(f"    trace {attempt} held {sum(found.values())} PGD-update "
              f"kernels in {n} replays; tracing them again")


def run_scan_cli(flags, epochs, tag, resume=False, batches=SCAN_BATCHES):
    """One ``train_classify --mode alfa --epoch_scan`` run at full width,
    ``batches`` steps per epoch (0: the whole split's 351); checks its
    losses, graph and checkpoint, then profiles its graph
    (:func:`pgd_per_replay`). Returns (the recorded scan, save_dir, the
    PGD-update launches the wrapper counted in the run, the kernels per
    replay in the trace). Under ``--pgd_random_steps`` the launches are the
    device-step-size entry points' (``dev_launches``)."""
    spe = batches or TRAIN_SPLIT // CLS_BATCH
    dev = "--pgd_random_steps" in flags
    save_dir = os.path.join("checkpoints", f"chip_smoke_classify_{tag}")
    if not resume:
        shutil.rmtree(save_dir, ignore_errors=True)
    scans = []
    real = train_classify.make_epoch_scan_alfa

    def recording(*a, **kw):
        scans.append(RecordingScan(real(*a, **kw)))
        return scans[-1]

    train_classify.make_epoch_scan_alfa = recording
    kpgd.launches = kpgd.dev_launches = 0
    t0 = time.time()
    try:
        train_classify.main(
            ["--mode", "alfa", "--epoch_scan", "--epochs", str(epochs),
             "--limit_batches", str(batches), "--batch_size",
             str(CLS_BATCH), "--seed", "0", "--data",
             os.path.join(ROOT, "no_cifar_here"), "--save_dir", save_dir]
            + flags + (["--resume"] if resume else []))
        torch.cuda.synchronize()
    finally:
        train_classify.make_epoch_scan_alfa = real
    secs = time.time() - t0
    wrapper = kpgd.dev_launches if dev else kpgd.launches
    require((kpgd.launches if dev else kpgd.dev_launches) == 0,
            f"{tag}: PGD-update launches of the other step-size entry")
    (scan,) = scans
    ran = len(scan.epochs)
    losses = np.concatenate([e["loss"] for e in scan.epochs])
    require(ran >= 1 and len(losses) == ran * spe
            and np.isfinite(losses).all(), f"{tag}: losses {losses}")
    eager = cls_loop.GRAPH_WARMUP_STEPS
    require(scan.graph is not None and scan.eager_steps == eager
            and scan.replays == ran * spe - eager
            and wrapper == ALFA_STEPS * (eager + 1),
            f"{tag}: {scan.eager_steps} eager steps, {scan.replays} replays, "
            f"{wrapper} PGD-update launches from the wrapper")
    saved = torch.load(os.path.join(save_dir, "checkpoint.pt"),
                       map_location="cpu", weights_only=True)
    host_lr = multistep_warmup_schedule(
        0.1, [50 * spe, 150 * spe], warmup_steps=spe)(epochs * spe)
    require(saved["epoch"] == epochs and saved["step"] == epochs * spe
            and saved["scheduler"]["last_epoch"] == epochs * spe
            and saved["optimizer"]["param_groups"][0]["lr"] == host_lr
            and all(bool(torch.isfinite(v).all())
                    for v in saved["state_dict"].values()
                    if v.is_floating_point()),
            f"{tag}: checkpoint epoch {saved['epoch']} step {saved['step']}")
    with open(os.path.join(save_dir, "result.pkl"), "rb") as f:
        result = pickle.load(f)
    replays = scan.replays
    per = pgd_per_replay(scan, clip="--clip" in flags, bf16="--bf16" in flags,
                         dev=dev)
    print(f"    {tag}: {ran} epoch(s) of {spe} steps + validation "
          f"and test in {secs:.1f} s: {scan.eager_steps} eager steps, "
          f"{replays} graph replays; per-epoch mean loss "
          f"{[round(float(e['loss'].mean()), 4) for e in scan.epochs]}, "
          f"last-step loss {losses[-1]:.4f}; checkpoint step "
          f"{saved['step']}, lr {host_lr}; val accuracy {result['ta']}; "
          f"PGD-update launches counted by the wrapper {wrapper} (eager "
          f"steps and the capture); kernels per replay in a profiler trace "
          f"of {min(SCAN_TRACE_REPLAYS, spe)} replays of this graph "
          f"{per:g}, so "
          f"{per * replays:g} run by the run's replays")
    require(per == ALFA_STEPS, f"{tag}: {per} PGD-update kernels per replay")
    return scan, save_dir, wrapper, per * replays


def train_scan_full_width():
    """Phase 18; returns the PGD-update launches the wrapper counted in the
    runs and the directory of the last run, a whole epoch (a model that
    has learned the synthetic classes, for phase 21)."""
    print(f"[18] train_classify --epoch_scan: ALFA ResNet-56, batch "
          f"{CLS_BATCH}, {SCAN_BATCHES} steps per epoch, each epoch replays "
          f"one CUDA graph of the step")
    runs = [run_scan_cli([], SCAN_EPOCHS, "scan")]
    runs.append(run_scan_cli([], SCAN_EPOCHS + 1, "scan", resume=True))
    require(len(runs[-1][0].epochs) == 1,
            "the resume trained more than 1 epoch")
    runs.append(run_scan_cli(["--clip", "--randinit"], 1,
                             "scan_clip_randinit"))
    runs.append(run_scan_cli([], 1, "scan_full", batches=0))
    full_dir = runs[-1][1]
    wrapper = sum(r[2] for r in runs)
    replayed = sum(r[3] for r in runs)
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"    PGD-update launches counted by the wrapper in the four runs "
          f"{wrapper}; kernels run by their graph replays (profiled "
          f"kernels per replay x replays) {replayed:g}")
    return wrapper, full_dir


def device_split():
    x, y, _, _ = cifar.synthetic_arrays(seed=0)
    return cuda(x[:TRAIN_SPLIT]), cuda(y[:TRAIN_SPLIT])


def alfa_optimizer(model):
    spe = TRAIN_SPLIT // CLS_BATCH
    return capturable_sgd(
        list(model.parameters()),
        multistep_warmup_schedule_tensor(0.1, [50 * spe, 150 * spe],
                                         warmup_steps=spe), 0.1, 0.9, 5e-4)


def scan_graph_vs_eager(split, steps=8):
    """Phase 19: ``steps`` steps through the epoch scan (3 eager, then
    replays) against as many eager device-data steps, from the same
    weights, permutation and generator seed."""
    print(f"[19] epoch scan (graph replays) vs eager device-data steps, "
          f"{steps} steps from the same weights and draws (cuDNN "
          f"deterministic, no TF32)")
    data_x, data_y = split
    runs = []
    with deterministic():
        for graphed in (True, False):
            model = resnet56(generator=torch.Generator().manual_seed(0))
            model.cuda()
            opt, count = alfa_optimizer(model)
            gen = torch.Generator(device="cuda").manual_seed(0)
            perm = torch.randperm(len(data_x), generator=gen, device="cuda")
            if graphed:
                scan = cls_loop.make_epoch_scan_alfa(
                    model, opt, cls_loop.AlfaConfig(), CLS_BATCH, steps,
                    record_augment=True)
                out = scan(data_x, data_y, perm, gen)
            else:
                step = cls_loop.make_device_data_alfa_step(
                    model, opt, count, cls_loop.AlfaConfig(), CLS_BATCH,
                    record_augment=True)
                ms = [step(data_x, data_y, perm, i, gen)
                      for i in range(steps)]
                out = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
            torch.cuda.synchronize()
            runs.append((out, {k: v.detach().clone()
                               for k, v in model.state_dict().items()}))
    (mg, sg), (me, se) = runs
    draws_equal = [bool(torch.equal(mg["crop"][i], me["crop"][i])
                        and torch.equal(mg["flip"][i], me["flip"][i]))
                   for i in range(steps)]
    first = scan.eager_steps
    fresh = all(not torch.equal(mg["crop"][i], mg["crop"][i + 1])
                for i in range(first, steps - 1))
    metric_err = max(float(((mg[k] - me[k]).abs()
                            / me[k].abs().clamp_min(1e-30)).max())
                     for k in ("loss", "accuracy", "pert_l2", "pert_linf"))
    param_err = max(float((sg[k] - v).abs().max())
                    / max(float(v.abs().max()), 1e-30)
                    for k, v in se.items() if v.is_floating_point())
    ints_equal = all(torch.equal(sg[k], v) for k, v in se.items()
                     if not v.is_floating_point())
    bits = all(torch.equal(sg[k], v) for k, v in se.items())
    print(f"    {first} eager steps then {scan.replays} replays; crop "
          f"offsets and flips equal per step {draws_equal}; consecutive "
          f"replays draw anew {fresh}; loss graph "
          f"{[round(float(v), 6) for v in mg['loss']]}, eager "
          f"{[round(float(v), 6) for v in me['loss']]}; largest metric rel "
          f"err {metric_err:.3e}; largest parameter / BatchNorm-buffer rel "
          f"err {param_err:.3e} (bit-equal {bits})")
    require(all(draws_equal), "the graph's augmentation draws differ")
    require(fresh, "two consecutive replays drew the same crop offsets")
    require(metric_err <= 1e-5 and param_err <= 1e-5 and ints_equal,
            f"graph and eager differ: metrics {metric_err}, parameters "
            f"{param_err}")


def scan_turn(scan, args):
    def run():
        for _ in range(SCAN_TURN_CALLS):
            scan(*args)
    return run


def time_scan(card, split):
    """Phase 20: the graphed ALFA step and the eager device-data step in
    turns (graph, eager, eager, graph, twice, 10 steps each), peak
    memory, host time per replay, and a profile of 5 replays; then the
    robust-eval batch."""
    print(f"[20] timing on {card}")
    data_x, data_y = split
    cfg = cls_loop.AlfaConfig()
    gen_g = torch.Generator(device="cuda").manual_seed(1)
    gen_e = torch.Generator(device="cuda").manual_seed(1)
    perm = torch.randperm(len(data_x), generator=gen_g, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model_g = resnet56(generator=torch.Generator().manual_seed(1)).cuda()
    opt_g, _ = alfa_optimizer(model_g)
    scan = cls_loop.make_epoch_scan_alfa(model_g, opt_g, cfg, CLS_BATCH,
                                         SCAN_CALL_STEPS)
    args = (data_x, data_y, perm, gen_g)
    scan(*args)                          # 3 eager steps, capture, 2 replays
    torch.cuda.synchronize()
    peak_g = torch.cuda.max_memory_allocated() / 2**30
    reserved_g = torch.cuda.memory_reserved() / 2**30
    torch.cuda.reset_peak_memory_stats()
    model_e = resnet56(generator=torch.Generator().manual_seed(1)).cuda()
    opt_e, count_e = alfa_optimizer(model_e)
    step = cls_loop.make_device_data_alfa_step(model_e, opt_e, count_e, cfg,
                                               CLS_BATCH)
    steps_per_turn = SCAN_CALL_STEPS * SCAN_TURN_CALLS

    def eager_turn():
        for i in range(steps_per_turn):
            step(data_x, data_y, perm, i, gen_e)

    eager_turn()
    torch.cuda.synchronize()
    peak_e = torch.cuda.max_memory_allocated() / 2**30
    turns = {"graph": [], "eager": []}
    runs = {"graph": scan_turn(scan, args), "eager": eager_turn}
    for name in ("graph", "eager", "eager", "graph") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - t0) * 1e3 / steps_per_turn)
    for name, ts in turns.items():
        med = float(np.median(ts))
        print(f"    ALFA step, {name}: ms per step in {len(ts)} turns of "
              f"{steps_per_turn} steps {[round(t, 3) for t in ts]}; median "
              f"{med:.3f} ms, p90 {np.percentile(ts, 90):.3f} ms, "
              f"{CLS_BATCH * 1e3 / med:.1f} imgs/s ({card})")
    print(f"    peak memory allocated: graph {peak_g:.3f} GiB (its eager "
          f"steps and the capture; {reserved_g:.3f} GiB reserved with the "
          f"graph's pool), eager {peak_e:.3f} GiB ({card})")
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        scan(*args)
        host.append((time.perf_counter() - t0) * 1e6 / SCAN_CALL_STEPS)
    torch.cuda.synchronize()
    print(f"    host time per replay, the card kept busy: "
          f"{[round(h, 1) for h in host]} us (a 5-step call: its replays, "
          f"the permutation copy and the metric rows' clones) ({card})")
    graph = profile_step(lambda: scan(*args), n=1, label="graphed ALFA",
                         per_call=SCAN_CALL_STEPS)
    eager = profile_step(lambda: step(data_x, data_y, perm, 0, gen_e), n=3,
                         label="eager device-data ALFA")
    if graph and eager:
        print(f"    device busy share: graph "
              f"{100 * graph['busy_ms'] / graph['wall_ms']:.1f}%, eager "
              f"{100 * eager['busy_ms'] / eager['wall_ms']:.1f}% ({card})")
    del scan, step, model_g, model_e, opt_g, opt_e
    gc.collect()
    torch.cuda.empty_cache()


def robust_eval_phase(card, split, ckpt_dir, errs):
    """Phase 21: the PGD update against its plain version at the input
    shape, a robust-eval batch timed, and ``infer_classify --pgd`` on the
    epoch-scan run's best checkpoint. Returns the kernel's launches and its
    times per robust-eval batch."""
    shape = (CLS_BATCH, 32, 32, 3)
    print(f"[21] robust evaluation: input PGD-{ROBUST_STEPS} at {shape}")
    for clip in (False, True):
        pgd_case("robust eval input", *pgd_inputs(shape, 21), clip, errs,
                 gamma=2.0 / 255, eps=8.0 / 255)
    model = resnet56(generator=torch.Generator().manual_seed(2)).cuda()
    x = split[0][:CLS_BATCH].float() / 255
    y = split[1][:CLS_BATCH]
    rob = make_robust_eval_step(
        model, 10, generator=torch.Generator(device="cuda").manual_seed(0))
    t = cuda_samples(lambda: rob(x, y), 10)
    print(f"    robust-eval batch (PGD-{ROBUST_STEPS}, ResNet-56, batch "
          f"{CLS_BATCH}): median {np.median(t):.3f} ms, p90 "
          f"{np.percentile(t, 90):.3f} ms over {len(t)} batches ({card})")
    del model
    best = os.path.join(ckpt_dir, "best_model.pt")
    common = ["--pretrained", best, "--batch_size", str(CLS_BATCH), "--data",
              os.path.join(ROOT, "no_cifar_here")]
    clean = infer_classify.main(common)
    kpgd.launches = 0
    robust = infer_classify.main(common + ["--pgd"])
    torch.cuda.synchronize()
    launches = kpgd.launches
    batches = -(-10000 // CLS_BATCH)
    print(f"    infer_classify on {best}: clean {clean:.2f}%, robust "
          f"(PGD-{ROBUST_STEPS}) {robust:.2f}%; PGD-update launches "
          f"{launches} over {batches} batches")
    require(robust <= clean, f"robust accuracy {robust} > clean {clean}")
    require(launches == ROBUST_STEPS * batches,
            f"{launches} PGD-update launches in {batches} batches")
    k_ms, p_ms, byte_ms, op_ms = time_pgd_update(card, shape)[False]
    return launches, {
        "ms": ROBUST_STEPS * k_ms, "plain_ms": ROBUST_STEPS * p_ms,
        "bound_ms": ROBUST_STEPS * max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


# --pgd_random_steps under --epoch_scan (phases 52-54): the CLI runs' steps
# per epoch; the graph against eager, each replay's step sizes read back and
# fed to the eager step, within 1e-4 (relative) in f32 and one bf16 ulp in
# bf16; the device-step-size kernel's trace goes under TRACE_DIR.
RANDOM_STEPS_BATCHES = 8
RANDOM_STEPS_RUNS = (([], torch.float32, "scan_random_steps"),
                     (["--bf16"], torch.bfloat16, "scan_random_steps_bf16"))
RANDOM_GRAPH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -8}
TRACE_DIR = os.path.join("checkpoints", "chip_smoke_trace")


def random_steps_runs():
    """Phase 52: ``train_classify --mode alfa --epoch_scan
    --pgd_random_steps``, f32 and ``--bf16``, :func:`run_scan_cli`'s checks
    with the device-step-size launches. Returns them by dtype."""
    print(f"[52] train_classify --epoch_scan --pgd_random_steps: ALFA "
          f"ResNet-56, batch {CLS_BATCH}, one epoch of "
          f"{RANDOM_STEPS_BATCHES} steps, f32 and bf16; each step's sizes "
          f"drawn on the card, read there by the PGD-update kernel")
    launches = {}
    for flags, dtype, tag in RANDOM_STEPS_RUNS:
        before = kpgd.bf16_dev_launches
        scan, _, launches[dtype], _ = run_scan_cli(
            ["--pgd_random_steps"] + flags, 1, tag,
            batches=RANDOM_STEPS_BATCHES)
        bf16 = kpgd.bf16_dev_launches - before
        require(bf16 == (launches[dtype] if dtype == torch.bfloat16 else 0),
                f"{tag}: {bf16} bf16 of {launches[dtype]} device-step-size "
                f"launches")
        del scan
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def random_steps_graph_vs_eager(split, dtype, steps=6):
    """Phase 53, one dtype: ``steps`` one-step epochs of a random-steps
    epoch scan (3 eager, the capture, replays), each epoch's step sizes
    read back after it ran, against as many eager device-data steps from
    the same weights, permutations and generator seed, each fed the scan's
    step sizes (its own draws, taken to keep the generator in step, are
    compared with them); then :func:`afan_torch.utils.observe.profile_trace`
    around three more replays."""
    from afan_torch.utils.observe import profile_trace
    data_x, data_y = split
    cfg = cls_loop.AlfaConfig(random_steps=True)
    real = attack.random_step_sizes
    recorded, own, runs = [], [], []
    before = kpgd.dev_launches

    def record(*a):
        recorded.append(real(*a))
        return recorded[-1]

    def feed(*a):
        own.append(real(*a))
        return sizes[len(own) - 1].clone()

    with deterministic():
        for graphed in (True, False):
            model = resnet56(generator=torch.Generator().manual_seed(0),
                             dtype=dtype).cuda()
            opt, count = alfa_optimizer(model)
            gen = torch.Generator(device="cuda").manual_seed(0)
            perms = [torch.randperm(len(data_x), generator=gen,
                                    device="cuda") for _ in range(steps)]
            attack.random_step_sizes = record if graphed else feed
            try:
                if graphed:
                    scan = cls_loop.make_epoch_scan_alfa(model, opt, cfg,
                                                         CLS_BATCH, 1)
                    out, sizes = [], []
                    for perm in perms:
                        out.append(scan(data_x, data_y, perm, gen))
                        sizes.append(recorded[-1].clone())
                else:
                    step = cls_loop.make_device_data_alfa_step(
                        model, opt, count, cfg, CLS_BATCH)
                    out = [step(data_x, data_y, perm, 0, gen)
                           for perm in perms]
            finally:
                attack.random_step_sizes = real
            torch.cuda.synchronize()
            runs.append(({k: torch.stack([m[k].reshape(()) for m in out])
                          for k in out[0]},
                         {k: v.detach().clone()
                          for k, v in model.state_dict().items()}))
            if graphed:
                graph = scan
            else:
                del model, opt, step
    (mg, sg), (me, se) = runs
    launches = kpgd.dev_launches - before
    metric_err = max(float(((mg[k] - me[k]).abs()
                            / me[k].abs().clamp_min(1e-30)).max())
                     for k in ("loss", "accuracy", "pert_l2", "pert_linf"))
    param_err = max(float((sg[k] - v).float().abs().max())
                    / max(float(v.float().abs().max()), 1e-30)
                    for k, v in se.items() if v.is_floating_point())
    same_draws = all(bits_equal(a, b) for a, b in zip(own, sizes))
    fresh = len({tuple(u.float().tolist()) for u in sizes}) == steps
    tol = RANDOM_GRAPH_TOL[dtype]
    print(f"    {str(dtype)[6:]}: {graph.eager_steps} eager steps, then "
          f"{graph.replays} replays; step sizes x255 per epoch "
          f"{[[round(v * 255, 4) for v in u.float().tolist()] for u in sizes]}"
          f" (each replay's new: {fresh}; the eager steps' own draws equal "
          f"them bit for bit: {same_draws}); loss graph "
          f"{[round(float(v), 6) for v in mg['loss']]}, eager "
          f"{[round(float(v), 6) for v in me['loss']]}; largest metric rel "
          f"err {metric_err:.3e}, parameter / buffer rel err "
          f"{param_err:.3e} (tolerance {tol:.3g}); device-step-size "
          f"launches counted by the wrapper {launches}")
    require(fresh, "two replays of the random-steps graph drew the same "
            "step sizes")
    require(metric_err <= tol and param_err <= tol,
            f"random-steps graph and eager differ: metrics {metric_err}, "
            f"parameters {param_err}")
    require(launches == ALFA_STEPS * (steps + graph.eager_steps + 1),
            f"{launches} device-step-size launches counted: the eager "
            f"steps of both runs and the capture expected")
    name = pgd_kernel_name(False, dtype == torch.bfloat16, dev=True)
    logdir = os.path.join(TRACE_DIR, str(dtype)[6:])
    shutil.rmtree(logdir, ignore_errors=True)
    with profile_trace(logdir):
        for _ in range(3):
            graph._static["i"].zero_()     # the epoch's one row
            graph.graph.replay()
    (trace,) = os.listdir(logdir)
    with open(os.path.join(logdir, trace)) as f:
        events = json.load(f)["traceEvents"]
    found = sum(name in str(ev.get("name", "")) for ev in events)
    print(f"    profile_trace of 3 replays: {os.path.join(logdir, trace)}, "
          f"{len(events)} events, {found} of them {name}")
    require(found == 3 * ALFA_STEPS,
            f"the trace of 3 replays holds {found} {name} kernels")


def dev_gamma_kernel_checks(errs):
    """Phase 53: the device-step-size kernel against the host-step-size one
    on the same step size and against the plain version, at the ALFA tap,
    f32 and bf16, clipped and not, over step sizes drawn on the card: bit
    for bit. The errors (0) go to ``errs`` by dtype."""
    shape = (CLS_BATCH, 16, 32, 32)
    for dtype in (torch.float32, torch.bfloat16):
        x, g, c = (t.to(dtype) for t in pgd_inputs(shape, 530))
        sizes = attack.random_step_sizes(
            ALFA_GAMMA, 4, torch.Generator(device="cuda").manual_seed(5),
            dtype, "cuda")
        for clip in (False, True):
            kw = dict(eps=ALFA_EPS if clip else None, clip=clip)
            centre = c if clip else None
            for t in range(len(sizes)):
                dev = kpgd.pgd_update(x, g, centre, gamma=sizes[t:t + 1],
                                      **kw)
                host = kpgd.pgd_update(x, g, centre, gamma=float(sizes[t]),
                                       **kw)
                plain = tpgd.pgd_update_plain(x, g, centre,
                                              gamma=sizes[t:t + 1], **kw)
                torch.cuda.synchronize()
                require(bits_equal(dev, host) and bits_equal(dev, plain),
                        f"device-step-size kernel {dtype} clip={clip} step "
                        f"{t}: not bit-equal to the host-step-size kernel "
                        f"and the plain version")
                finite = torch.isfinite(dev) & torch.isfinite(plain)
                errs[dtype].append(float((dev.float() - plain.float())[
                    finite].abs().max()))
        print(f"    device-step-size kernel {str(dtype)[6:]} at {shape}, "
              f"clipped and not, {len(sizes)} step sizes drawn on the card "
              f"(x255: {[round(float(v) * 255, 4) for v in sizes]}): "
              f"bit-equal to the host-step-size kernel and the plain "
              f"version")


def time_dev_gamma(card, launches, errs):
    """Phase 54: at the ALFA tap, f32 and bf16, unclipped: the
    device-step-size kernel in turns with the host-step-size kernel (host,
    device, device, host, twice; device ms per call queued behind a sleep
    kernel, inputs cycled through 8 sets), the plain version with the
    tensor step size, and the bound: x and g read and the output written
    once, and the step size read once, at HBM's rate; PGD_OPS per element
    at the f32 peak. Per replay: ALFA_STEPS launches. Returns the kernels
    line's parts by name."""
    print(f"[54] the device-step-size PGD update at the ALFA tap, in turns "
          f"with the host-step-size kernel, on {card}")
    shape = (CLS_BATCH, 16, 32, 32)
    n = int(np.prod(shape))
    parts = {}
    for dtype, name in ((torch.float32, "pgd_update_dev"),
                        (torch.bfloat16, "pgd_update_dev_bf16")):
        sets = itertools.cycle([tuple(t.to(dtype) for t in
                                      pgd_inputs(shape, 540 + i))
                                for i in range(8)])
        step = attack.random_step_sizes(
            ALFA_GAMMA, 1, torch.Generator(device="cuda").manual_seed(6),
            dtype, "cuda")
        value = float(step)

        def call(fn, gamma):
            x, g, _ = next(sets)
            return fn(x, g, gamma=gamma)

        runs = {"host": lambda: call(kpgd.pgd_update, value),
                "device": lambda: call(kpgd.pgd_update, step)}
        turns = {"host": [], "device": []}
        for which in ("host", "device", "device", "host") * 2:
            turns[which].append(queued_ms(runs[which]))
        p_ms = queued_ms(lambda: call(tpgd.pgd_update_plain, step))
        size = step.element_size()
        byte_ms = (3 * size * n + size) / HBM_BYTES_PER_S * 1e3
        op_ms = PGD_OPS * n / F32_OPS_PER_S * 1e3
        k_ms = float(np.median(turns["device"]))
        h_ms = float(np.median(turns["host"]))
        print(f"    {name} {shape}: device step size "
              f"{[round(t, 5) for t in turns['device']]} ms per launch, host "
              f"step size {[round(t, 5) for t in turns['host']]} (medians "
              f"{k_ms:.5f} and {h_ms:.5f}, {k_ms / h_ms:.3f}x); plain "
              f"{p_ms:.5f} ms; bound max(bytes {byte_ms:.6f}, operations "
              f"{op_ms:.6f}) ms; kernel at {k_ms / max(byte_ms, op_ms):.2f}x "
              f"its bound; per replay ({ALFA_STEPS} launches) "
              f"{ALFA_STEPS * k_ms:.5f} ms ({card})")
        parts[name] = (launches[dtype], max(errs[dtype]), kernel_times(
            ALFA_STEPS * k_ms, ALFA_STEPS * p_ms, ALFA_STEPS * byte_ms,
            ALFA_STEPS * op_ms))
    return parts


def random_steps_phases(card, split):
    """Phases 52-54; returns the device-step-size kernel's parts for the
    kernels line: the launches of phase 52's runs, the largest error,
    times per replay."""
    launches = random_steps_runs()
    print(f"[53] the random-steps epoch scan (graph replays) vs eager "
          f"device-data steps fed each replay's step sizes, from the same "
          f"weights and draws (cuDNN deterministic, no TF32)")
    for dtype in (torch.float32, torch.bfloat16):
        random_steps_graph_vs_eager(split, dtype)
        gc.collect()
        torch.cuda.empty_cache()
    errs = {torch.float32: [], torch.bfloat16: []}
    dev_gamma_kernel_checks(errs)
    return time_dev_gamma(card, launches, errs)


def epoch_scan_phases(card):
    """Phases 18-21 and 52-54; returns the PGD-update kernel's part (the
    launches of the epoch-scan runs and of the robust evaluation, its times
    per robust-eval batch) and the device-step-size kernel's parts."""
    launches, ckpt_dir = train_scan_full_width()
    split = device_split()
    scan_graph_vs_eager(split)
    gc.collect()
    torch.cuda.empty_cache()
    time_scan(card, split)
    errs = []
    rob_launches, times = robust_eval_phase(card, split, ckpt_dir, errs)
    gc.collect()
    torch.cuda.empty_cache()
    dev_parts = random_steps_phases(card, split)
    return {"name": "pgd_update", "route": "cuda",
            "source": "afan_torch/csrc/pgd_step.cu",
            "replaces": "afan/ops/kernels/pgd_step.py:40",
            "launches": launches + rob_launches, "max_abs_err": max(errs),
            **times, "library_ms": None}, dev_parts


# ---------- evaluation: phases 36-39 ----------

EVAL_OUT = os.path.join("checkpoints", "chip_smoke_eval")
# afan's eval loader and the VOC canvas: ResNet-50, 21 classes, batch 1,
# 608x1008, the eval NMS 6000 -> 300 at 0.7 and per class at 0.3; the
# attack losses sample with the training NMS (12000 -> 2000 at 0.7)
EVAL_DET_FLAGS = ["-s", "voc2007", "-b", "resnet50", "--data_dir",
                  os.path.join(ROOT, "no_voc_here"), "--image_min_side",
                  "600", "--image_max_side", "1000", "--rpn_pre_nms_top_n",
                  "6000", "--rpn_post_nms_top_n", "300"]
# the probe's grid holds 0 exactly at 8 points (-0.1 + 4 * f32(0.025)), so
# its centre image is all zero and its loss NaN, which sends NaN boxes
# through the proposal NMS; at 6 or at the reference's 40 points the float32
# grid misses 0 by 7.45e-9 and no cell is NaN, in afan as here
ROB_IMAGES, SAT_IMAGES, SAT_VIS_IMAGES, SURFACE_POINTS = 2, 4, 2, 8
EVAL_PGD_STEPS = 3
SEG_EVAL_FLAGS = ["--model", SEG_MODEL, "--output_stride", "16",
                  "--data_root", os.path.join(ROOT, "no_data_here")]
VOC_EVAL = ["--dataset", "voc", "--crop_size", "513", "--crop_val",
            "--val_batch_size", "1"]
CITY_EVAL = ["--dataset", "cityscapes", "--crop_size", "768"]
SEG_PGD = ["--task", "pgd", "--pgd_steps", str(EVAL_PGD_STEPS),
           "--pgd_gamma", "2", "--pgd_eps", "8"]
SEG_VAL_IMAGES = 16
# the new shapes: the PGD update on the VOC canvas, at the SE tap feature
# (layer 2 of the ResNet-50, stride 8) and on the VOC crop; the upsample +
# CE at batch 1 on the VOC and Cityscapes crops and on Cityscapes' whole
# 1024x2048 validation image (afan/data/seg_data.py:257)
EVAL_PGD_SHAPES = ((1, 608, 1008, 3), (1, 512, 76, 126), (1, 513, 513, 3))
EVAL_CE_CASES = [
    ("voc513_b1", 1, (129, 129), (513, 513), 21, None),
    ("city768_b1", 1, (192, 192), (768, 768), 19, None),
    ("city_val_1024x2048", 1, (256, 512), (1024, 2048), 19, None),
]
# differing entries between the attacked images of the kernel and plain
# segmentation runs: after one step only entries whose gradient float
# order turns over (near zero); after three the trajectories part (about a
# fifth of the entries on the H100 at the VOC crop) though most entries
# still agree (unrelated sign fields would leave 7/8 of them apart)
ADV_DIFF_SHARE, ADV_DIFF_SHARE_3 = 0.001, 0.5
# a few attacked entries apart can move a pixel's prediction across a class
# boundary, so the segmentation mIoU is held within these of the plain run's
MIOU_TOL, MIOU_TOL_3 = 1e-4, 1e-2


def nan_mixed_boxes(n, seed):
    """Score-sorted boxes with whole NaN boxes and single NaN coordinates
    among ordinary ones."""
    b = sorted_boxes(n, seed).copy()
    b[5::7] = np.nan
    b[3::11, 2] = np.nan
    b[2::13, 1] = np.nan
    return b


# NaN boxes: what a NaN image sends into the proposal NMS (every box NaN),
# NaN boxes among ordinary ones, and NaN boxes in invalid slots
NMS_NAN_CASES = {
    "nan_all": lambda: (np.full((12000, 4), np.nan, np.float32),
                        np.ones(12000, bool), 0.7),
    "nan_mixed": lambda: (nan_mixed_boxes(6000, 3), np.ones(6000, bool),
                          0.7),
    "nan_mixed_0.3": lambda: (nan_mixed_boxes(300, 4), np.ones(300, bool),
                              0.3),
    "nan_invalid": lambda: (nan_mixed_boxes(600, 5),
                            ~np.isnan(nan_mixed_boxes(600, 5)).any(1), 0.7),
}


def eval_counts():
    return {"nms": knms.launches, "pgd_update": kpgd.launches,
            "resize_ce_forward": krce.fwd_launches,
            "resize_ce_backward": krce.bwd_launches}


def run_eval_cli(main, argv, tag, images, expected):
    """One run of an eval CLI's ``main``: every kernel count set to 0 just
    before it and read just after; ``expected`` per image (a dict of
    counts) is required. Returns (result, counts)."""
    knms.launches = kpgd.launches = 0
    krce.fwd_launches = krce.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = main(argv)
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = eval_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: images * expected.get(k, 0) for k in counts}
    require(counts == want, f"{tag}: launches {counts}, expected {want}")
    print(f"    {tag}: {images} images in {secs:.2f} s wall "
          f"({secs * 1e3 / images:.1f} ms per image, data and host work "
          f"included), launches {counts} ("
          f"{ {k: v // images for k, v in counts.items() if v} } per image), "
          f"peak memory {peak:.2f} GiB")
    return out, counts


@contextlib.contextmanager
def first_test_images(n):
    """``eval_detect`` on the first ``n`` test images: ``afan``'s ``map``,
    ``rob`` and ``sat_layers`` go through the whole test split and ignore
    ``--limit_images``, so the phase cuts the loader's samples."""
    real = eval_detect.detection_loaders

    def cut(*a, **kw):
        train, ev, nc = real(*a, **kw)
        ev.samples = ev.samples[:n]
        return train, ev, nc

    eval_detect.detection_loaders = cut
    try:
        yield
    finally:
        eval_detect.detection_loaders = real


@contextlib.contextmanager
def recording(module, name, outputs):
    """``module.name``, an attack factory, patched so that each attack's
    output is appended to ``outputs``."""
    real = getattr(module, name)

    def factory(*a, **kw):
        attack_fn = real(*a, **kw)

        def run(*args):
            adv = attack_fn(*args)
            outputs.append(adv.detach().clone())
            return adv
        return run

    setattr(module, name, factory)
    try:
        yield
    finally:
        setattr(module, name, real)


def eval_det_weights():
    """The detection phases' seeded torso (frozen-BatchNorm statistics
    fitted, ``calibrated_backbone``) in the seeded ResNet-50 Faster R-CNN,
    written as a port checkpoint for ``--checkpoint``."""
    calibrated_backbone()
    os.makedirs(EVAL_OUT, exist_ok=True)
    path = os.path.join(EVAL_OUT, "frcnn_resnet50_voc.pt")
    torch.save({"state_dict": det_model(0).state_dict()}, path)
    return path


def eval_detect_runs(ckpt, nms_calls, updates):
    """Phase 36: every ``eval_detect`` task at full width through its
    ``main``; the NMS inputs go to ``nms_calls`` and the PGD updates'
    (shape, clip) to ``updates``. Returns the tasks' results and launches."""
    print(f"[36] eval_detect: ResNet-50 Faster R-CNN, 21 classes, canvas "
          f"608x1008, batch 1, eval NMS 6000 -> 300 at 0.7, per class at "
          f"0.3; weights: the seeded calibrated torso and seeded heads "
          f"through --checkpoint {ckpt}; depth cut: map on the "
          f"{DET_EVAL_IMAGES} synthetic test images, rob on the first "
          f"{ROB_IMAGES}, sat_layers on the first {SAT_IMAGES}, sat_vis on "
          f"{SAT_VIS_IMAGES}, "
          f"input_surface at {SURFACE_POINTS}x{SURFACE_POINTS} points on 1 "
          f"(the reference probes 40x40 on 20)")
    base = EVAL_DET_FLAGS + ["--checkpoint", ckpt, "--pgd_steps",
                             str(EVAL_PGD_STEPS)]
    out, launches = {}, {}
    steps = EVAL_PGD_STEPS
    runs = [
        ("map", [], DET_EVAL_IMAGES, {"nms": 2}),
        ("rob", [], ROB_IMAGES, {"nms": steps + 2, "pgd_update": steps}),
        ("sat_layers", ["--sat_tap", "2", "--sat_alpha", "0.5"], SAT_IMAGES,
         {"nms": steps + 2, "pgd_update": steps}),
        ("sat_layers_mix", ["--sat_tap", "2", "--sat_alpha", "0.5", "--mix"],
         SAT_IMAGES, {"nms": steps + 2, "pgd_update": steps}),
        ("sat_vis", ["--spectrum", "5", "--limit_images",
                     str(SAT_VIS_IMAGES), "--dump_dir",
                     os.path.join(EVAL_OUT, "feature_maps")],
         SAT_VIS_IMAGES, {"nms": steps, "pgd_update": steps}),
        ("input_surface", ["--grid_points", str(SURFACE_POINTS),
                           "--limit_images", "1", "--surface_out",
                           os.path.join(EVAL_OUT, "alp_adv.pkl")],
         1, {"nms": SURFACE_POINTS ** 2 + 1}),
        ("loss_vis", [], 1, {"nms": len(eval_detect.LOSS_VIS_SCALES)}),
    ]
    shutil.rmtree(os.path.join(EVAL_OUT, "feature_maps"), ignore_errors=True)
    for tag, extra, images, expected in runs:
        task = tag.replace("_mix", "")
        calls = []
        cut = (first_test_images(images) if task in ("rob", "sat_layers")
               else contextlib.nullcontext())
        with cut, patched_nms(recording_nms(knms.nms_sorted_mask, calls)), \
                patched_update(recording_update(updates)):
            out[tag], launches[tag] = run_eval_cli(
                eval_detect.main, base + ["--task", task] + extra,
                f"eval_detect --task {tag}", images, expected)
        nms_calls[tag] = calls
    for tag in ("map", "rob", "sat_layers", "sat_layers_mix"):
        require(0.0 <= out[tag] <= 1.0, f"{tag}: mAP {out[tag]}")
    files = sorted(os.listdir(os.path.join(EVAL_OUT, "feature_maps")))
    require(out["sat_vis"] == SAT_VIS_IMAGES * 6 == len(files),
            f"sat_vis wrote {out['sat_vis']} PNGs, {len(files)} files")
    for name in files:
        with open(os.path.join(EVAL_OUT, "feature_maps", name), "rb") as f:
            require(f.read(8) == b"\x89PNG\r\n\x1a\n", f"{name} is not a PNG")
    with open(os.path.join(EVAL_OUT, "alp_adv.pkl"), "rb") as f:
        surfaces = pickle.load(f)
    (z,) = surfaces.values()
    c = SURFACE_POINTS // 2
    zero = (robustness.surface_grid(0.1, SURFACE_POINTS) == 0).numpy()
    require(z.shape == (SURFACE_POINTS,) * 2 and zero[c] and zero.sum() == 1
            and np.array_equal(~np.isfinite(z), zero[:, None] & zero[None]),
            f"input surface {z.shape}, non-finite at "
            f"{np.argwhere(~np.isfinite(z)).tolist()} (expected only "
            f"[{c}, {c}], where the grid is 0)")
    require(len(out["loss_vis"]) == 5 and np.isfinite(out["loss_vis"]).all(),
            f"loss_vis {out['loss_vis']}")
    print(f"    mAP: map {out['map']:.4f}, rob {out['rob']:.4f}, sat_layers "
          f"{out['sat_layers']:.4f}, with --mix {out['sat_layers_mix']:.4f}; "
          f"sat_vis {out['sat_vis']} PNGs; input surface NaN only at the "
          f"centre [{c}, {c}], finite range [{np.nanmin(z):.4f}, "
          f"{np.nanmax(z):.4f}]; loss_vis "
          f"{[round(v, 4) for v in out['loss_vis']]}")
    return out, launches


def seg_eval_checkpoint():
    """A seeded DeepLabv3+ ResNet-50 (21 classes) whose BatchNorms take
    their inputs' per-channel mean and variance on two synthetic VOC
    validation images, each set before it runs in one eval-mode forward
    (random weights with identity statistics predict one class
    everywhere), written as a port training checkpoint (``model_state``)
    for ``--ckpt`` and ``--test_only``."""
    model = build_model(SEG_MODEL, 21, 16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.cuda().eval()

    def fit(bn, inputs):
        var, mean = torch.var_mean(inputs[0], dim=(0, 2, 3), correction=0)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)

    hooks = [m.register_forward_pre_hook(fit) for m in model.modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    _, val, _ = seg_data.voc_seg_loaders(None, 2, 513, val_batch_size=2,
                                         crop_val=True)
    try:
        with torch.no_grad():
            model(cuda(next(iter(val))[0]).permute(0, 3, 1, 2))
    finally:
        for h in hooks:
            h.remove()
    os.makedirs(EVAL_OUT, exist_ok=True)
    path = os.path.join(EVAL_OUT, "deeplabv3plus_resnet50_voc.pt")
    torch.save({"model_state": model.state_dict()}, path)
    return path


def eval_segment_runs(ckpt, updates):
    """Phase 37: ``eval_segment --task miou|pgd`` on VOC (plain and with
    ``--randinit_pgd --clip_pgd``, ``--save_val_results``), ``--task pgd``
    on Cityscapes (19 classes, crop 768; its weights are the VOC
    checkpoint's but the classifier's last layer), and ``train_segment
    --test_only`` on the VOC checkpoint."""
    print(f"[37] eval_segment: DeepLabv3+ ResNet-50, OS 16, batch 1; "
          f"weights: seeded, BatchNorm statistics of two VOC images, "
          f"through --ckpt {ckpt}; the {SEG_VAL_IMAGES} synthetic validation "
          f"images of each dataset (no cut)")
    res_dir = os.path.join(EVAL_OUT, "results")
    shutil.rmtree(res_dir, ignore_errors=True)
    steps = EVAL_PGD_STEPS
    pgd_counts = {"resize_ce_forward": steps, "resize_ce_backward": steps,
                  "pgd_update": steps}
    voc = SEG_EVAL_FLAGS + VOC_EVAL + ["--ckpt", ckpt]
    runs = [
        ("voc miou", voc + ["--task", "miou", "--save_val_results",
                            "--results_dir", res_dir], {}),
        ("voc pgd", voc + SEG_PGD, pgd_counts),
        ("voc pgd --randinit_pgd --clip_pgd",
         voc + SEG_PGD + ["--randinit_pgd", "--clip_pgd"], pgd_counts),
        ("cityscapes pgd", SEG_EVAL_FLAGS + CITY_EVAL + SEG_PGD
         + ["--ckpt", ckpt], pgd_counts),
    ]
    out, launches = {}, {}
    for tag, argv, expected in runs:
        rec = []
        # the clean runs are held to train_segment --test_only's below
        exact = deterministic() if tag == "voc miou" else \
            contextlib.nullcontext()
        with exact, patched_update(recording_update(rec)):
            out[tag], launches[tag] = run_eval_cli(
                eval_segment.main, argv, f"eval_segment {tag}",
                SEG_VAL_IMAGES, expected)
        updates += rec
        clips = {c for _, c in rec}
        require(clips == ({True} if "clip" in tag else {False} if rec
                          else set()), f"{tag}: clip modes {clips}")
    pngs = sorted(os.listdir(res_dir))
    require(len(pngs) == SEG_VAL_IMAGES, f"{len(pngs)} result PNGs")
    with deterministic():
        test_out, _ = run_eval_cli(
            train_segment.main, ["--test_only", ckpt, "--variant",
                                 "baseline", "--random_seed", "0"]
            + SEG_EVAL_FLAGS + VOC_EVAL,
            "train_segment --test_only", SEG_VAL_IMAGES, {})
    for tag, v in out.items():
        require(np.isfinite(v) and 0.0 <= v <= 1.0, f"{tag}: mIoU {v}")
    require(test_out["Mean IoU"] == out["voc miou"],
            f"--test_only mIoU {test_out['Mean IoU']} != eval_segment "
            f"--task miou {out['voc miou']}")
    print(f"    mIoU: {', '.join(f'{k} {v:.4f}' for k, v in out.items())}; "
          f"train_segment --test_only {test_out['Mean IoU']:.4f} (equal to "
          f"--task miou); {len(pngs)} prediction PNGs")
    return out, launches


def eval_kernels_vs_plain(nms_calls, updates, errs):
    """Phase 38, the kernels at the new shapes: NMS on the eval paths'
    recorded inputs and on NaN boxes, the PGD update at the new shapes, the
    upsample + CE at batch 1."""
    print("[38] kernels vs plain versions at the evaluation shapes")
    picks = [("detect proposals", nms_calls["map"][0]),
             ("detect per-class", nms_calls["map"][1]),
             ("rob attack losses", nms_calls["rob"][0]),
             ("rob detect proposals", nms_calls["rob"][EVAL_PGD_STEPS]),
             ("input_surface gradient", nms_calls["input_surface"][0]),
             ("input_surface centre cell",
              nms_calls["input_surface"][1 + (SURFACE_POINTS // 2)
                                         * (SURFACE_POINTS + 1)])]
    for name, (boxes, valid, thr, plus_one, keep) in picks:
        got = kernel_vs_plain(name, boxes, valid, thr, plus_one, errs["nms"])
        require(torch.equal(got, keep), f"{name}: a second kernel run differs")
        print(f"    {name}: NaN boxes {int(torch.isnan(boxes).any(-1).sum())}")
    centre = picks[-1][1][0]
    require(bool(torch.isnan(centre).all()),
            "the centre cell's proposals are not all NaN")
    for name, case in NMS_NAN_CASES.items():
        boxes, valid, thr = case()
        kernel_vs_plain(name, cuda(boxes[None]), cuda(valid[None]), thr,
                        True, errs["nms"])
    shapes = sorted(set(EVAL_PGD_SHAPES) | {s for s, _ in updates})
    for i, shape in enumerate(shapes):
        for clip in (False, True):
            pgd_case(f"eval {shape}", *pgd_inputs(shape, 200 + i), clip,
                     errs["pgd_update"], gamma=2.0 / 255, eps=8.0 / 255)
    ce_errs = {"fwd": [], "bwd": []}
    for case in EVAL_CE_CASES:
        ce_case(*case, ce_errs)
    errs["resize_ce_forward"] += ce_errs["fwd"]
    errs["resize_ce_backward"] += ce_errs["bwd"]


def eval_paths_vs_plain(det_ckpt, seg_ckpt):
    """Phase 38, the paths: ``eval_detect --task map`` and ``rob`` and
    ``eval_segment --task pgd`` (1 and 3 steps) run again with the plain
    NMS, PGD update and upsample + CE patched in, cuDNN deterministic and
    no TF32 in both runs. A sign step turns a float difference at a
    near-zero gradient entry into a whole step on that entry, and later
    steps start from images that differ there: the attacked images are
    compared entry by entry, the mAP exactly and the mIoU within
    ``MIOU_TOL`` (1 step) and ``MIOU_TOL_3``."""
    det = EVAL_DET_FLAGS + ["--checkpoint", det_ckpt, "--pgd_steps",
                            str(EVAL_PGD_STEPS)]
    seg = SEG_EVAL_FLAGS + VOC_EVAL + SEG_PGD + ["--ckpt", seg_ckpt]
    results = {}
    with deterministic():
        for plain in (False, True):
            patches = contextlib.ExitStack()
            if plain:
                patches.enter_context(patched_nms(tnms.nms_sorted_mask_plain))
                patches.enter_context(patched_update(tpgd.pgd_update_plain))
                patches.enter_context(
                    patched_site_op(trce.fused_resize_nll_sums_plain))
            adv = {"rob": [], "pgd-1": [], "pgd-3": []}
            with patches:
                m = eval_detect.main(det + ["--task", "map"])
                with first_test_images(ROB_IMAGES), recording(
                        eval_detect, "make_detection_pgd_fn", adv["rob"]):
                    r = eval_detect.main(det + ["--task", "rob"])
                with recording(eval_segment, "make_seg_pgd_fn", adv["pgd-1"]):
                    p1 = eval_segment.main(seg + ["--pgd_steps", "1"])
                with recording(eval_segment, "make_seg_pgd_fn", adv["pgd-3"]):
                    p3 = eval_segment.main(seg)
            results[plain] = (m, r, p1, p3, adv)
    (m, r, p1, p3, ours), (mp, rp, pp1, pp3, theirs) = (results[False],
                                                        results[True])
    print(f"    kernels vs plain versions, cuDNN deterministic: map mAP "
          f"{m:.6f} vs {mp:.6f}; rob mAP {r:.6f} vs {rp:.6f}; VOC pgd mIoU "
          f"1 step {p1:.6f} vs {pp1:.6f}, {EVAL_PGD_STEPS} steps {p3:.6f} "
          f"vs {pp3:.6f}")
    for what, bound in (("rob", 0.0), ("pgd-1", ADV_DIFF_SHARE),
                        ("pgd-3", ADV_DIFF_SHARE_3)):
        a, b = ours[what], theirs[what]
        require(len(a) == len(b) == (ROB_IMAGES if what == "rob"
                                     else SEG_VAL_IMAGES),
                f"{what}: recorded attacks {len(a)}, {len(b)}")
        n_diff = sum(int((x != y).sum()) for x, y in zip(a, b))
        n_all = sum(x.numel() for x in a)
        max_diff = max(float((x - y).abs().max()) for x, y in zip(a, b))
        steps = 1 if what == "pgd-1" else EVAL_PGD_STEPS
        print(f"    {what} attacked images: {n_diff} of {n_all} entries "
              f"differ ({100 * n_diff / n_all:.5f}%; bound "
              f"{100 * bound}%), by at most {max_diff:.6g} (bound "
              f"{2 * steps} steps of 2/255)")
        require(n_diff <= bound * n_all,
                f"{what}: {n_diff} of {n_all} attacked entries differ")
        require(max_diff <= 2 * steps * 2.0 / 255 + 1e-6,
                f"{what}: attacked entries differ by {max_diff}")
    require(m == mp and r == rp, "detection mAP differs with the plain "
            "versions")
    require(abs(p1 - pp1) <= MIOU_TOL and abs(p3 - pp3) <= MIOU_TOL_3,
            f"VOC pgd mIoU {p1}, {p3} against {pp1}, {pp3} with the plain "
            f"versions (tolerances {MIOU_TOL}, {MIOU_TOL_3})")


def kernel_times(ms, plain_ms, byte_ms, op_ms, library_ms=None):
    """A kernel's times for the kernels line: its bound the larger of the
    byte and operation bounds, named by which one it is."""
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": library_ms}


def eval_timings(card, det_ckpt, seg_ckpt, nms_calls):
    """Phase 39: ms per image of each eval task (CUDA events around the
    task's device work for one image, data loading left out), and each
    kernel at the new shapes with its plain version and bound. Returns the
    kernels' times per attacked image: NMS and PGD update per ``rob``
    image, the upsample + CE per VOC ``pgd`` image."""
    print(f"[39] eval timing on {card}")
    args = eval_detect.get_parser().parse_args(
        EVAL_DET_FLAGS + ["--checkpoint", det_ckpt])
    model = eval_detect.build_model(args, 21, torch.device("cuda"))
    _, loader, _ = voc_detection_loaders(None, 1, MIN_SIDE, MAX_SIDE)
    batch = eval_detect.batch_tensors(next(iter(loader)),
                                      torch.device("cuda"))
    x, gt = batch[0], batch[1:]
    gen = torch.Generator("cuda")
    detect = make_detect_fn(model)
    attack = robustness.make_detection_pgd_fn(model, EVAL_PGD_STEPS,
                                              2.0 / 255, 8.0 / 255)
    per_image = {
        "map": lambda: detect(x),
        "rob": lambda: detect(attack(x, *gt, gen.manual_seed(1))),
        "sat_layers": lambda: robustness.make_sat_layer_detect_fn(
            model, 2, 0.5, EVAL_PGD_STEPS, 2.0 / 255)(
                x, *gt, gen.manual_seed(1)),
        "sat_layers --mix": lambda: robustness.make_sat_layer_detect_fn(
            model, 2, 0.5, EVAL_PGD_STEPS, 2.0 / 255, mix=True)(
                x, *gt, gen.manual_seed(1)),
        "sat_vis (device part)": lambda: feature_vis.make_spectrum_features_fn(
            model, 2, 0.9 / 255, EVAL_PGD_STEPS, 8.0 / 255, 5)(
                x, *gt, gen.manual_seed(0)),
    }
    for name, fn in per_image.items():
        t = cuda_samples(fn, 5, warmup=1)
        print(f"    eval_detect {name}: median {np.median(t):.3f} ms per "
              f"image over {len(t)} ({card})")
    surface = robustness.make_input_surface_fn(model, 0.1, SURFACE_POINTS)
    t = cuda_samples(lambda: surface(x, *gt, gen.manual_seed(0)), 2,
                     warmup=1)
    print(f"    eval_detect input_surface {SURFACE_POINTS}x{SURFACE_POINTS}: "
          f"median {np.median(t):.3f} ms per image, "
          f"{np.median(t) / SURFACE_POINTS ** 2:.3f} ms per grid point; the "
          f"reference's 40x40 probe would take about "
          f"{1600 * np.median(t) / SURFACE_POINTS ** 2 / 1e3:.1f} s per image "
          f"({card})")
    dirs = robustness.perturb_weight_directions(model,
                                                np.random.RandomState(0))
    scales = eval_detect.LOSS_VIS_SCALES
    t = cuda_samples(lambda: robustness.loss_landscape_probe(
        lambda: model.losses(x, *gt, gen.manual_seed(0)).total(), model,
        dirs, scales), 2, warmup=1)
    print(f"    eval_detect loss_vis: median {np.median(t):.3f} ms for "
          f"{len(scales)} scales, {np.median(t) / len(scales):.3f} ms per "
          f"scale ({card})")
    del model, dirs
    gc.collect()
    torch.cuda.empty_cache()

    for tag, flags, nc in (("VOC", VOC_EVAL, 21), ("Cityscapes", CITY_EVAL,
                                                   19)):
        sargs = eval_segment.get_parser().parse_args(
            SEG_EVAL_FLAGS + flags + SEG_PGD + ["--ckpt", seg_ckpt])
        seg = build_model(SEG_MODEL, nc, 16)
        seg.reset_parameters(torch.Generator().manual_seed(0))
        eval_segment.restore(seg, sargs)
        seg.cuda().eval()
        loaders = (seg_data.voc_seg_loaders if nc == 21
                   else seg_data.cityscapes_loaders)
        _, val, _ = loaders(None, 1, sargs.crop_size, crop_val=sargs.crop_val)
        imgs, labs = next(iter(val))
        xs, ys = cuda(imgs), cuda(labs)
        step = segment_loop.make_seg_eval_step(seg, nc)
        seg_attack = eval_segment.make_seg_pgd_fn(seg, sargs)
        for task, fn in (("miou", lambda: step(xs, ys)),
                         ("pgd", lambda: step(seg_attack(
                             xs, ys, gen.manual_seed(0)), ys))):
            t = cuda_samples(fn, 5, warmup=1)
            print(f"    eval_segment {tag} --task {task} "
                  f"{tuple(xs.shape)}: median {np.median(t):.3f} ms per "
                  f"image over {len(t)} ({card})")
        del seg
        gc.collect()
        torch.cuda.empty_cache()

    nms = {}
    for name, (tag, idx) in {
            "detect proposals": ("map", 0), "detect per-class": ("map", 1),
            "attack losses": ("rob", 0),
            "input_surface centre cell (NaN)": (
                "input_surface",
                1 + (SURFACE_POINTS // 2) * (SURFACE_POINTS + 1))}.items():
        boxes, valid, thr, plus_one, _ = nms_calls[tag][idx]
        nms[name] = time_nms_shape(card, name, boxes, valid, thr, plus_one)
    pgd = {shape: time_pgd_update(card, shape, gamma=2.0 / 255,
                                  eps=8.0 / 255)
           for shape in EVAL_PGD_SHAPES}
    ce = {}
    for name, B, hw, HW, C, _ in EVAL_CE_CASES:
        lo, lab, g = ce_inputs(B, hw, HW, C, seed=3)
        ce[name] = parts = ce_parts(lo, lab, g)
        print(f"    resize+CE {name} B={B} {hw}->{HW} C={C}: forward kernel "
              f"{parts['fwd']:.4f} ms, plain {parts['plain_fwd']:.4f}, "
              f"library {parts['lib_fwd']:.4f}, bound max(bytes "
              f"{parts['fwd_bytes_ms']:.5f}, operations "
              f"{parts['fwd_ops_ms']:.5f}); backward kernel "
              f"{parts['bwd']:.4f} ms, plain {parts['plain_bwd']:.4f}, "
              f"library {parts['lib_bwd']:.4f}, bound max(bytes "
              f"{parts['bwd_bytes_ms']:.5f}, operations "
              f"{parts['bwd_ops_ms']:.5f}) ({card})")

    # per rob image: the attack's losses, then the detect call
    rob_nms = [nms["attack losses"]] * EVAL_PGD_STEPS + [
        nms["detect proposals"], nms["detect per-class"]]
    k, p, b, o = (sum(v[i] for v in rob_nms) for i in range(4))
    k_pgd, p_pgd, b_pgd, o_pgd = pgd[EVAL_PGD_SHAPES[0]][False]
    voc = ce["voc513_b1"]
    n = EVAL_PGD_STEPS
    times = {
        "nms": kernel_times(k, p, b, o),
        "pgd_update": kernel_times(n * k_pgd, n * p_pgd, n * b_pgd,
                                   n * o_pgd),
        "resize_ce_forward": kernel_times(
            n * voc["fwd"], n * voc["plain_fwd"], n * voc["fwd_bytes_ms"],
            n * voc["fwd_ops_ms"], n * voc["lib_fwd"]),
        "resize_ce_backward": kernel_times(
            n * voc["bwd"], n * voc["plain_bwd"], n * voc["bwd_bytes_ms"],
            n * voc["bwd_ops_ms"], n * voc["lib_bwd"]),
    }
    for name, t in times.items():
        per = "rob" if name in ("nms", "pgd_update") else "VOC pgd"
        print(f"    {name} per {per} image: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.5f} "
              f"({t['bound_by']}), library {t['library_ms']} ({card})")
    return times


def eval_phases(card):
    """Phases 36-39; returns (launches, error, times) of each kernel on the
    eval paths."""
    det_ckpt = eval_det_weights()
    nms_calls, det_updates, seg_updates = {}, [], []
    _, det_launches = eval_detect_runs(det_ckpt, nms_calls, det_updates)
    gc.collect()
    torch.cuda.empty_cache()
    seg_ckpt = seg_eval_checkpoint()
    _, seg_launches = eval_segment_runs(seg_ckpt, seg_updates)
    gc.collect()
    torch.cuda.empty_cache()
    errs = {k: [] for k in eval_counts()}
    eval_kernels_vs_plain(nms_calls, det_updates + seg_updates, errs)
    eval_paths_vs_plain(det_ckpt, seg_ckpt)
    gc.collect()
    torch.cuda.empty_cache()
    times = eval_timings(card, det_ckpt, seg_ckpt, nms_calls)
    launches = {k: sum(c[k] for c in list(det_launches.values())
                       + list(seg_launches.values()))
                for k in eval_counts()}
    print(f"    eval launches (phases 36 and 37): {launches}")
    return {k: (launches[k], max(errs[k]), times[k]) for k in launches}


# The remaining model configurations at full width (phases 40-46): afan's
# DeepLab MobileNetV2 (40-42) and the COCO detection recipes with the RPN SD
# tap (43-46).
MB_MODEL = "deeplabv3plus_mobilenet"
MB_OUT = os.path.join("checkpoints", "chip_smoke_mobilenet")
MB_BACKBONE = os.path.join(MB_OUT, "resnet50_torchvision.pth")
CITY_ENV = {"N": "1", "GAMMASE": "0.02", "MIX": "01"}
# (tag, flags, compute dtype, the fractions --pretrained_backbone logs)
MB_RUNS = (
    ("city_final_mobilenet",
     lambda: recipe_flags("seg_city_final.sh", CITY_ENV)
     + ["--model", MB_MODEL], torch.bfloat16, None),
    ("voc07_final1_mobilenet_separable",
     lambda: recipe_flags("seg_voc07_final1.sh", {"MIX": "01"})
     + ["--model", MB_MODEL, "--separable_conv"], torch.bfloat16, None),
    ("v3_mobilenet_aspp",
     lambda: SEG_FLAGS + ["--model", "deeplabv3_mobilenet",
                          "--pertub_idx_sd", "aspp"], torch.float32, None),
    ("resnet50_pretrained",
     lambda: SEG_FLAGS + ["--pretrained_backbone", MB_BACKBONE],
     torch.float32, "(params 100.0%, stats 100.0%)"),
    ("mobilenet_pretrained",
     lambda: SEG_FLAGS + ["--model", MB_MODEL, "--pretrained_backbone",
                          MB_BACKBONE], torch.float32,
     "(params 0.0%, stats 0.0%)"),
)


def torchvision_resnet50():
    """A seeded ResNet-50 in torchvision's keys (``fc`` included, every key
    under ``module.`` as a DataParallel checkpoint has it) at
    ``MB_BACKBONE``, for ``--pretrained_backbone``."""
    torso = from_name("resnet50")
    torso.reset_parameters(torch.Generator().manual_seed(7))
    sd = dict(torso.state_dict(), **{"fc.weight": torch.zeros(1000, 2048),
                                     "fc.bias": torch.zeros(1000)})
    os.makedirs(MB_OUT, exist_ok=True)
    torch.save({f"module.{k}": v for k, v in sd.items()}, MB_BACKBONE)
    return MB_BACKBONE


def mobilenet_runs(updates):
    """Phase 40: every run of ``MB_RUNS``; returns their launches summed."""
    print(f"[40] train the DeepLab MobileNetV2 at full width through "
          f"train_segment.main: {', '.join(r[0] for r in MB_RUNS)}")
    print(f"    --pretrained_backbone: {torchvision_resnet50()}")
    total = [0] * 6
    for tag, flags, dtype, fractions in MB_RUNS:
        run = run_seg_recipe("mb_" + tag, flags(), dtype, updates, fractions)
        total = [t + r for t, r in zip(total, run)]
        gc.collect()
        torch.cuda.empty_cache()
    print_update_shares([u for u in updates if u[3] == torch.bfloat16])
    return total


MB_CE_CASES = [("mb_city768", 4, (192, 192), (768, 768), 19, None),
               ("mb_voc513", 4, (129, 129), (513, 513), 21, None)]


def mobilenet_kernels_vs_plain(updates, errs):
    """Phase 41: one MobileNet A-FAN step (the Cityscapes recipe's flags,
    f32) with the kernels against one with the plain op, from the same
    weights, batch and dropout masks (cuDNN deterministic, no TF32); then
    the upsample + CE kernels at the MobileNet steps' site shapes, f32 and
    bf16, and the PGD update at every shape, step size and dtype of phase
    40's updates, clipped and not, bit for bit."""
    model = build_model(MB_MODEL, 19, 16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.cuda()
    imgs, labs = seg_batch()
    step_kernel_vs_plain(model, imgs, labs, label="[41] MobileNet A-FAN step "
                         "with the kernels vs with the plain op")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for case in MB_CE_CASES:
        ce_case(*case, errs)
        name, B, hw, HW, C, _ = case
        lo, lab, g = ce_inputs(B, hw, HW, C)
        lo = lo.bfloat16()
        sums, dlo = (krce.resize_ce_forward(lo, lab),
                     krce.resize_ce_backward(lo, lab, g))
        want_s = trce.fused_resize_nll_sums_plain(lo, lab, HW)
        want_d = trce.resize_ce_grad_plain(lo, lab, g)
        torch.cuda.synchronize()
        es, eg = rel_err(sums, want_s), rel_err(dlo.float(), want_d.float())
        errs["fwd_bf16"].append(float((sums - want_s).abs().max()))
        errs["bwd_bf16"].append(float((dlo.float() - want_d.float())
                                      .abs().max()))
        print(f"  {name} bf16 logits: sums rel {es:.3e}, gradient rel "
              f"{eg:.3e}")
        require(es <= CE_SUM_TOL and eg <= BF16_GRAD_TOL,
                f"{name} bf16: sums rel {es}, gradient rel {eg}")
    cases = sorted({(shape, gamma, dtype)
                    for shape, _, gamma, dtype, _ in updates},
                   key=lambda c: (c[0], c[1], str(c[2])))
    for i, (shape, gamma, dtype) in enumerate(cases):
        x, g, c = (t.to(dtype) for t in pgd_inputs(shape, 600 + i))
        key = "pgd_bf16" if dtype == torch.bfloat16 else "pgd"
        for clip in (False, True):
            pgd_case(f"MobileNet ascent {i}", x, g, c, clip, errs[key],
                     gamma, 2.0 / 255)


def time_step(card, label, step, batch, n=5, warmup=2, profile=True):
    """A step's device time (median and p90 of ``n`` calls after
    ``warmup``, CUDA events), images per second, peak memory, kernel
    launches per step by wrapper and, profiled, the device's busy share and
    device kernels per step. Returns the median ms."""
    t = cuda_samples(step, n, warmup=warmup)
    before = (knms.launches, krce.fwd_launches, krce.bwd_launches,
              kpgd.launches)
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(zip(("nms", "resize_ce_forward", "resize_ce_backward",
                         "pgd_update"),
                        (a - b for a, b in zip(
                            (knms.launches, krce.fwd_launches,
                             krce.bwd_launches, kpgd.launches), before))))
    med = float(np.median(t))
    print(f"    {label}: median {med:.3f} ms, p90 "
          f"{np.percentile(t, 90):.3f} ms over {len(t)} steps after "
          f"{warmup}, {batch * 1e3 / med:.2f} imgs/s, peak memory "
          f"{peak:.2f} GiB, kernel launches per step "
          f"{ {k: v for k, v in launches.items() if v} } ({card})")
    if profile:
        profile_step(step, n=2, label=label)
    return med


def pgd_times(card, shapes):
    """The PGD update, unclipped, at each (shape, dtype, gamma) of
    ``shapes``, summed: kernel, plain and bound ms."""
    k_ms = p_ms = byte_ms = op_ms = 0.0
    for shape, dtype, gamma in shapes:
        k, p, b, o = time_pgd_update(card, shape, dtype, gamma,
                                     2.0 / 255)[False]
        k_ms, p_ms, byte_ms, op_ms = k_ms + k, p_ms + p, byte_ms + b, op_ms + o
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def time_mobilenet(card, updates, ce_times):
    """Phase 42: the MobileNet A-FAN step of the Cityscapes recipe (crop
    768, batch 4) in f32 and in bf16, in turns (f32, bf16, bf16, f32; 5
    steps each after 2), each one's launches and profile; then, with
    ``ce_times``, the upsample + CE kernels at the step's shapes (the
    ResNet-50 step's, which phases 10 and 29 time otherwise), and the PGD
    update at the MobileNet ascents' shapes, with their bounds. Returns the
    kernels' times."""
    print(f"[42] timing on {card}: the MobileNet A-FAN step (Cityscapes "
          f"recipe, crop {SEG_CROP}, batch {SEG_BATCH}), f32 and bf16 in "
          f"turns")
    imgs, labs = seg_batch()
    models = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        models[name] = build_model(MB_MODEL, 19, 16, dtype)
        models[name].reset_parameters(torch.Generator().manual_seed(0))
        models[name].cuda()
    steps = {k: (lambda s=seg_step(m): s(imgs, labs))
             for k, m in models.items()}
    samples = time_in_turns(steps, ("f32", "bf16", "bf16", "f32"), 5,
                            warmup=2)
    med = report_turns(card, samples, steps, SEG_BATCH,
                       "MobileNet A-FAN step")
    for k in ("f32", "bf16"):
        time_step(card, f"{k} MobileNet A-FAN step", steps[k], SEG_BATCH,
                  n=5, warmup=1)
    print(f"    bf16 step {med['f32'] / med['bf16']:.2f}x the f32 step's "
          f"speed (medians in turns, {card})")
    del steps, models
    gc.collect()
    torch.cuda.empty_cache()
    per_step = seg_launches_per_step(seg_recipe())[0]
    times = {}
    for dtype in (torch.float32, torch.bfloat16) if ce_times else ():
        for e in time_ce_kernels(card, labs, per_step, dtype):
            times[e["name"]] = {k: e[k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "bound_by",
                                                  "library_ms")}
    shapes = sorted({(shape, dtype, gamma)
                     for shape, clip, gamma, dtype, _ in updates if not clip},
                    key=lambda c: (c[0], str(c[1]), c[2]))
    for dtype, name in ((torch.float32, "pgd_update"),
                        (torch.bfloat16, "pgd_update_bf16")):
        mine = [s for s in shapes if s[1] == dtype]
        times[name] = pgd_times(card, mine)
        print(f"    {name} at the MobileNet ascents {[s[0] for s in mine]}: "
              f"kernel {times[name]['ms']:.5f} ms, plain "
              f"{times[name]['plain_ms']:.5f}, bound "
              f"{times[name]['bound_ms']:.5f} ms ({card})")
    return times


def mobilenet_phases(card, ce_times=True):
    """Phases 40-42; returns (launches, error, times) of each kernel on the
    MobileNet paths (the upsample + CE times only with ``ce_times``)."""
    updates = []
    launches = mobilenet_runs(updates)
    gc.collect()
    torch.cuda.empty_cache()
    errs = {"fwd": [], "bwd": [], "fwd_bf16": [], "bwd_bf16": [], "pgd": [],
            "pgd_bf16": []}
    mobilenet_kernels_vs_plain(updates, errs)
    gc.collect()
    torch.cuda.empty_cache()
    times = time_mobilenet(card, updates, ce_times)
    fwd, bwd, pgd, fwd16, bwd16, pgd16 = launches
    return {"resize_ce_forward": (fwd - fwd16, max(errs["fwd"]),
                                  times.get("resize_ce_forward")),
            "resize_ce_backward": (bwd - bwd16, max(errs["bwd"]),
                                   times.get("resize_ce_backward")),
            "resize_ce_forward_bf16": (fwd16, max(errs["fwd_bf16"]),
                                       times.get("resize_ce_forward_bf16")),
            "resize_ce_backward_bf16": (bwd16, max(errs["bwd_bf16"]),
                                        times.get(
                                            "resize_ce_backward_bf16")),
            "pgd_update": (pgd - pgd16, max(errs["pgd"]),
                           times["pgd_update"]),
            "pgd_update_bf16": (pgd16, max(errs["pgd_bf16"]),
                                times["pgd_update_bf16"])}


COCO_RECIPE = "detect_coco_final_setting.sh"
COCO_SETTINGS = (1, 2, 3, 4, 5, 6)
COCO_CLASSES = 92
# the eval's NMS: the proposals (G=1, N=6000 of 50400 anchors at 800x1344)
# and the per-class NMS over classes 1..91 (G=91, N=300)
COCO_EVAL_NMS = ((1, 6000), (COCO_CLASSES - 1, 300))
# the PGD update at this slice's shapes not met on the runs (the RPN tap
# at COCO's canvas); the runs' own shapes are recorded
RPN_COCO_SHAPE = ((8, 512, 50, 84), torch.bfloat16, 0.1 / 255)


def coco_knobs(n):
    """``recipes/detect_coco_final_setting.sh``'s KNOBS for setting ``n``."""
    with open(os.path.join(ROOT, "recipes", COCO_RECIPE)) as f:
        line = next(ln for ln in f if ln.strip().startswith(f"{n})"))
    return line.split('KNOBS="', 1)[1].split('"', 1)[0]


def det_runs(eval_calls, updates):
    """Phases 43 (the six COCO settings as written, --bf16) and 44 (VOC
    final setting 1 with --pertub_idx_sd rpn, f32 and bf16), each from
    phase 15's calibrated torso. Returns their launches summed."""
    print(f"[43] train {COCO_RECIPE} 1-6 as written (--bf16, 800x1333, "
          f"anchors [64, 128, 256, 512], batch 8, synthetic COCO, "
          f"{COCO_CLASSES} classes): {RECIPE_STEPS} steps and the COCO AP "
          f"each")
    if not os.path.isfile(DET_BACKBONE):
        print(f"    backbone: {calibrated_backbone()}")
    runs = [(f"coco_final{n}", det_recipe_flags(
        COCO_RECIPE, f"coco_final{n}", {"KNOBS": coco_knobs(n)}),
        torch.bfloat16) for n in COCO_SETTINGS]
    voc = det_recipe_flags("detect_voc07_final_setting1.sh",
                           "voc07_final1_rpn_bf16") + ["--pertub_idx_sd",
                                                       "rpn"]
    runs += [("voc07_final1_rpn_f32", [a for a in voc if a != "--bf16"]
              + ["-o", os.path.join(DET_OUT, "voc07_final1_rpn_f32")],
              torch.float32),
             ("voc07_final1_rpn_bf16", voc, torch.bfloat16)]
    total = [0, 0, 0]
    for i, (tag, argv, dtype) in enumerate(runs):
        if i == len(COCO_SETTINGS):
            print("[44] train recipes/detect_voc07_final_setting1.sh with "
                  "--pertub_idx_sd rpn, f32 and as written (--bf16)")
        run = run_det_recipe(tag, argv, dtype, updates, eval_calls)
        total = [t + r for t, r in zip(total, run)]
        gc.collect()
        torch.cuda.empty_cache()
    print_update_shares([u for u in updates if u[3] == torch.bfloat16])
    return total


def rpn_recipe():
    return train_detect.afan_config_for(train_detect.get_parser().parse_args(
        DET_FLAGS + ["--pertub_idx_sd", "rpn"]))


def coco_kernels_vs_plain(eval_calls, updates, errs):
    """Phase 45: one ``sd=rpn`` A-FAN step (VOC final setting 1, f32) with
    the NMS and PGD-update kernels against one with their plain versions;
    the NMS kernel on that step's proposals (the shared sample, each SD
    ascent step's and the SD loss term's) and on phase 43's COCO eval
    calls (G=91, N=300 among them), keep masks equal; the PGD update at
    every shape, step size and dtype of phases 43-44 and at the RPN tap on
    COCO's canvas, bit for bit. Returns the step's NMS calls."""
    model, batch = det_model(), det_batch()
    calls, _ = det_step_kernel_vs_plain(model, batch, cfg=rpn_recipe(),
                                        label="[45] sd=rpn A-FAN")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for i, (boxes, valid, thr, plus_one, _) in enumerate(calls):
        kernel_vs_plain(f"sd=rpn step call {i}", boxes, valid, thr,
                        plus_one, errs["nms"])
    for (shape, thr), (boxes, valid, _, plus_one) in sorted(
            eval_calls.items()):
        kernel_vs_plain(f"COCO run call {shape}", boxes, valid, thr,
                        plus_one, errs["nms"])
    got = {k[0] for k in eval_calls}
    require(all(s in got for s in COCO_EVAL_NMS)
            and (DET_BATCH, 12000) in got,
            f"the COCO runs' NMS shapes {sorted(got)} lack {COCO_EVAL_NMS} "
            f"or the training proposals (8, 12000)")
    cases = sorted({(shape, gamma, dtype)
                    for shape, _, gamma, dtype, _ in updates}
                   | {(RPN_COCO_SHAPE[0], RPN_COCO_SHAPE[2],
                       RPN_COCO_SHAPE[1])},
                   key=lambda c: (c[0], c[1], str(c[2])))
    for i, (shape, gamma, dtype) in enumerate(cases):
        x, g, c = (t.to(dtype) for t in pgd_inputs(shape, 700 + i))
        key = "pgd_bf16" if dtype == torch.bfloat16 else "pgd"
        for clip in (False, True):
            pgd_case(f"detection ascent {i}", x, g, c, clip, errs[key],
                     gamma, 2.0 / 255)
    return calls


def coco_batch(seed=0):
    loader, _, _ = detection_loaders("coco2017", None, DET_BATCH, 800, 1333,
                                     seed)
    b = next(iter(loader))
    return (cuda(b.images), cuda(b.boxes), cuda(b.labels.astype(np.int64)),
            cuda(b.valid))


def coco_step():
    """The COCO recipe's setting-1 bf16 A-FAN step (its model, optimizer
    and flags), the torso from ``DET_BACKBONE``, on a synthetic COCO batch.
    Returns (step(), recorded NMS calls, the A-FAN config)."""
    argv = recipe_flags(COCO_RECIPE, {"OUT": "unused",
                                      "KNOBS": coco_knobs(1)},
                        "train_detect")
    args = train_detect.get_parser().parse_args(argv)
    model = FasterRCNN(train_detect.frcnn_config(args, COCO_CLASSES),
                       torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    overlap_restore(model.features, load_checkpoint(DET_BACKBONE))
    model.cuda()
    opt, sched = sgd(detect_loop.detection_param_groups(model),
                     warmup_multistep_schedule(0.01, [120000, 160000]), 0.01,
                     0.9, 1e-4)
    cfg = train_detect.afan_config_for(args)
    step = detect_loop.make_afan_det_step(model, opt, sched, cfg)
    batch, gen = coco_batch(), torch.Generator("cuda").manual_seed(1)
    return (lambda: step(*batch, gen)), cfg


def time_coco(card, rpn_calls, eval_calls, updates):
    """Phase 46: the COCO bf16 A-FAN step (setting 1, batch 8, 800x1344)
    and the sd=rpn A-FAN step (VOC setting 1, f32): median and p90 of 5
    steps after 2, peak memory, launches and profile each; the NMS kernel
    on the COCO step's proposals (G=8, N=12000 of 50400 anchors), at the
    COCO eval's per-class NMS (G=91, N=300) and on the sd=rpn step's
    proposals; the PGD update at the slice's new shapes. Returns the
    kernels' times."""
    print(f"[46] timing on {card}: the COCO bf16 A-FAN step and the sd=rpn "
          f"A-FAN step")
    step, _ = coco_step()
    coco_calls = {}
    with patched_nms(nms_shape_recorder(coco_calls, set())):
        step()
    coco_ms = time_step(card, "COCO setting-1 bf16 A-FAN step, batch 8, "
                        "800x1344", step, DET_BATCH)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    model, batch = det_model(), det_batch()
    rpn = det_step(model, cfg=rpn_recipe())
    gen = torch.Generator("cuda").manual_seed(1)
    rpn_ms = time_step(card, "sd=rpn A-FAN step (VOC setting 1, f32), "
                       "batch 8, 608x1008", lambda: rpn(*batch, gen),
                       DET_BATCH)
    del rpn, model
    gc.collect()
    torch.cuda.empty_cache()
    nms = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    parts = []
    n_rpn = det_launches_per_step(rpn_recipe())[0]
    (key, (boxes, valid, thr, plus_one)), = [
        kv for kv in coco_calls.items() if kv[0][0] == (DET_BATCH, 12000)]
    cases = [("COCO training proposals (per step x2)", boxes, valid, thr,
              plus_one, 2),
             ("COCO eval per-class", *eval_calls[(COCO_EVAL_NMS[1], 0.3)],
              1)]
    # the step's launches share their shape and all but a few boxes: the
    # first stands for each
    b, v, t, p, _ = rpn_calls[0]
    cases.append((f"sd=rpn step's first call (x{n_rpn} per step)", b, v, t,
                  p, n_rpn))
    for label, b, v, t, p, n in cases:
        k, pl, byte, op = time_nms_shape(card, label, b, v, t, p)
        nms["ms"] += n * k
        nms["plain_ms"] += n * pl
        nms["bound_ms"] += n * max(byte, op)
        parts.append("bytes" if byte >= op else "operations")
    nms["bound_by"] = max(set(parts), key=parts.count)
    print(f"    nms at the new shapes: per COCO step 2 launches, per sd=rpn "
          f"step {n_rpn}; the sum above: kernel {nms['ms']:.4f} ms, plain "
          f"{nms['plain_ms']:.3f}, bound {nms['bound_ms']:.6f} ms; the "
          f"COCO step {coco_ms:.3f} ms, the sd=rpn step {rpn_ms:.3f} ms "
          f"({card})")
    shapes = sorted({(shape, dtype, gamma)
                     for shape, clip, gamma, dtype, _ in updates if not clip}
                    | {RPN_COCO_SHAPE},
                    key=lambda c: (c[0], str(c[1]), c[2]))
    times = {"nms": nms}
    for dtype, name in ((torch.float32, "pgd_update"),
                        (torch.bfloat16, "pgd_update_bf16")):
        mine = [s for s in shapes if s[1] == dtype]
        times[name] = pgd_times(card, mine)
        print(f"    {name} at the detection ascents {[s[0] for s in mine]}: "
              f"kernel {times[name]['ms']:.5f} ms, plain "
              f"{times[name]['plain_ms']:.5f}, bound "
              f"{times[name]['bound_ms']:.5f} ms ({card})")
    return times


def coco_phases(card):
    """Phases 43-46; returns (launches, error, times) of each kernel on the
    COCO and sd=rpn paths."""
    eval_calls, updates = {}, []
    nms, pgd, pgd16 = det_runs(eval_calls, updates)
    gc.collect()
    torch.cuda.empty_cache()
    errs = {"nms": [0.0], "pgd": [], "pgd_bf16": []}
    rpn_calls = coco_kernels_vs_plain(eval_calls, updates, errs)
    gc.collect()
    torch.cuda.empty_cache()
    times = time_coco(card, rpn_calls, eval_calls, updates)
    return {"nms": (nms, max(errs["nms"]), times["nms"]),
            "pgd_update": (pgd - pgd16, max(errs["pgd"]),
                           times["pgd_update"]),
            "pgd_update_bf16": (pgd16, max(errs["pgd_bf16"]),
                                times["pgd_update_bf16"])}


# Datasets from disk (phases 47-50): trees at the datasets' real sizes and
# layouts under a temporary DATA, the four recipes as written on them, the
# eval CLIs, the kernels at the new shapes and the host's data timings.
DATA_FIXTURES = os.path.join(FIXTURES, "torch_images")
DATA_OUT = os.path.join("checkpoints", "chip_smoke_data")
CITY_SPLITS = {"train": (8, ("aachen", "bochum")), "val": (2, ("frankfurt",))}
VOC_SEG_SPLITS = {"train": 8, "val": 2}
VOC_DET_SPLITS = {"trainval": 16, "test": 4}
COCO_SPLITS = {"train2017": 8, "val2017": 2}
CITY_HW = (1024, 2048)
# (recipe, its variables, steps): the Cityscapes run takes two epochs of
# its 8 images, so that its fourth step shows the wait of a batch made
# while one step ran
DATA_SEG_RECIPES = (("seg_city_final.sh", {"N": "1", "GAMMASE": "0.02",
                                           "MIX": "01"}, 4),
                    ("seg_voc07_final1.sh", {"MIX": "01"}, RECIPE_STEPS))
DATA_DET_RECIPES = (("detect_voc07_final_setting1.sh", None),
                    (COCO_RECIPE, 1))
# the VOC eval canvas's logits: DeepLabv3+ at stride 4 of 512x512
VOC_CANVAS_CE = ("voc_canvas512_b1", 1, (128, 128), (512, 512), 21, None)


def png_filtered_rows(raw, bpp, filters):
    """PNG's filtered scanlines of the rows ``raw`` (H, stride) uint8, row y
    filtered by type ``filters[y % len(filters)]`` (0 none, 1 sub, 2 up, 3
    average, 4 Paeth): (H, 1 + stride) uint8, the type byte first."""
    x = raw.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    predictors = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    types = np.asarray(filters, np.uint8)[np.arange(len(raw)) % len(filters)]
    out = np.empty((len(raw), raw.shape[1] + 1), np.uint8)
    out[:, 0] = types
    for t, pred in enumerate(predictors):
        rows = types == t
        out[rows, 1:] = (x[rows] - pred[rows]).astype(np.uint8)
    return out


def write_png(path, img, palette=None, filters=(0, 1, 2, 3, 4), level=1):
    """An 8-bit PNG of ``img``: (H, W) gray, or palette indices with
    ``palette`` (256, 3); (H, W, 2) gray+alpha, (H, W, 3) RGB, (H, W, 4)
    RGBA; its rows filtered in turn by the types ``filters``."""
    import struct
    import zlib
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    ctype = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[bpp]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    rows = png_filtered_rows(img.reshape(h, w * bpp), bpp, filters)
    data = [b"\x89PNG\r\n\x1a\n",
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    if palette is not None:
        data.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    data += [chunk(b"IDAT", zlib.compress(rows.tobytes(), level)),
             chunk(b"IEND", b"")]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"".join(data))


def city_pair(i):
    """A Cityscapes-sized street stand-in: smooth RGB with noise, and label
    ids 0-33 in blocks (ids outside the 19 train ids included)."""
    rng = np.random.RandomState(i)
    h, w = CITY_HW
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / 97 + i) * np.cos(y / 71),
                    128 + 110 * np.sin((x + 2 * y) / 131 + i),
                    128 + 90 * np.cos((x - y) / 113)], -1)
    img = np.clip(img + rng.randn(h, w, 3) * 4, 0, 255).astype(np.uint8)
    ids = ((y.astype(np.int64) // 64) * 7 + (x.astype(np.int64) // 128) * 3
           + i) % 34
    return img, ids.astype(np.uint8)


def voc_xml(path, image_id, w, h, objects):
    """A VOC annotation: (name, difficult, (xmin, ymin, xmax, ymax))."""
    objs = "".join(
        f"<object><name>{n}</name><difficult>{int(d)}</difficult><bndbox>"
        f"<xmin>{b[0]}</xmin><ymin>{b[1]}</ymin><xmax>{b[2]}</xmax>"
        f"<ymax>{b[3]}</ymax></bndbox></object>" for n, d, b in objects)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"<annotation><filename>{image_id}.jpg</filename><size>"
                f"<width>{w}</width><height>{h}</height><depth>3</depth>"
                f"</size>{objs}</annotation>")


def copy_fixture(name, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    shutil.copyfile(os.path.join(DATA_FIXTURES, name), path)


# the JPEG kinds PIL reads beyond Huffman, by their SOF markers; phase 48
# puts one in every second image of the VOC trees and phase 49 requires
# the VOC runs to read each
SOF_KINDS = {0xC0: "baseline", 0xC1: "extended", 0xC2: "progressive",
             0xC3: "lossless", 0xC9: "arithmetic",
             0xCA: "arithmetic progressive"}
NEW_JPEG_KINDS = ("arithmetic", "arithmetic progressive", "lossless")


def voc_fixture(k):
    """The JPEG of VOC image ``k`` (odd ones tall): every fourth one from
    the third is arithmetic-coded or lossless in turn (wide), every fourth
    from the fourth arithmetic-coded progressive (tall), the others
    baseline."""
    if k % 4 == 3:
        return "arith_progressive_375x500.jpg"
    if k % 4 == 2:
        return ("arith_500x375.jpg", "lossless_500x375.jpg")[k // 4 % 2]
    return "voc_375x500.jpg" if k % 2 else "voc_500x375.jpg"


def jpeg_kind(data):
    """The frame kind of a JPEG's bytes, from its SOF marker."""
    i = 2
    while i + 4 <= len(data) and data[i] == 0xFF:
        if data[i + 1] in SOF_KINDS:
            return SOF_KINDS[data[i + 1]]
        i += 2 + ((data[i + 2] << 8) | data[i + 3])
    return "unknown"


@contextlib.contextmanager
def counting_jpeg_kinds(counts):
    """Every JPEG that ``read_rgb`` decodes meanwhile, from any thread, is
    counted in ``counts`` by its frame kind."""
    from afan_torch.utils import imread
    saved, lock = imread._jpeg_rgb, threading.Lock()

    def counted(data, path):
        kind = jpeg_kind(data)
        with lock:
            counts[kind] = counts.get(kind, 0) + 1
        return saved(data, path)

    imread._jpeg_rgb = counted
    try:
        yield counts
    finally:
        imread._jpeg_rgb = saved


def write_data_tree(root):
    """Phase 48: Cityscapes (1024x2048 PNGs, ids 0-33), VOC 2012
    segmentation (the fixture JPEGs, palette labels with 255 borders), VOC
    2007 detection (wide and tall fixture JPEGs; one difficult object per
    test image) and COCO 2017 (the fixture JPEG; one crowd annotation per
    split) under ``root``; in the VOC trees every second image is
    arithmetic-coded or lossless (:func:`voc_fixture`). Returns the seconds
    each took."""
    from afan_torch.utils.imread import read_label
    from afan_torch.utils.png import voc_color_map
    secs = {}
    t0 = time.time()
    for split, (n, cities) in CITY_SPLITS.items():
        for i in range(n):
            city = cities[i % len(cities)]
            stem = f"{city}_{i:06d}_000019"
            img, ids = city_pair(i + (100 if split == "val" else 0))
            write_png(os.path.join(root, "leftImg8bit", split, city,
                                   f"{stem}_leftImg8bit.png"), img)
            write_png(os.path.join(root, "gtFine", split, city,
                                   f"{stem}_gtFine_labelIds.png"), ids)
    secs["cityscapes"] = time.time() - t0
    t0 = time.time()
    voc12 = os.path.join(root, "VOCdevkit", "VOC2012")
    wide_lab = read_label(os.path.join(DATA_FIXTURES, "label_500x375.png"))
    k = 0
    for split, n in VOC_SEG_SPLITS.items():
        ids = []
        for _ in range(n):
            image_id = f"2008_{k:06d}"
            tall = k % 2 == 1
            copy_fixture(voc_fixture(k),
                         os.path.join(voc12, "JPEGImages", f"{image_id}.jpg"))
            write_png(os.path.join(voc12, "SegmentationClass",
                                   f"{image_id}.png"),
                      wide_lab.T if tall else wide_lab,
                      palette=voc_color_map())
            ids.append(image_id)
            k += 1
        os.makedirs(os.path.join(voc12, "ImageSets", "Segmentation"),
                    exist_ok=True)
        with open(os.path.join(voc12, "ImageSets", "Segmentation",
                               f"{split}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    voc07 = os.path.join(root, "VOCdevkit", "VOC2007")
    names = ("person", "car", "dog", "cat", "bicycle", "chair")
    k = 0
    for split, n in VOC_DET_SPLITS.items():
        ids = []
        for j in range(n):
            image_id = f"{k:06d}"
            tall = k % 2 == 1
            w, h = (375, 500) if tall else (500, 375)
            copy_fixture(voc_fixture(k),
                         os.path.join(voc07, "JPEGImages", f"{image_id}.jpg"))
            objects = [(names[(k + m) % len(names)], False,
                        (20 + 40 * m, 30 + 25 * m, 180 + 40 * m,
                         200 + 30 * m)) for m in range(2)]
            if split == "test":
                objects.append((names[k % len(names)], True,
                                (w - 120, h - 110, w - 10, h - 5)))
            voc_xml(os.path.join(voc07, "Annotations", f"{image_id}.xml"),
                    image_id, w, h, objects)
            ids.append(image_id)
            k += 1
        os.makedirs(os.path.join(voc07, "ImageSets", "Main"), exist_ok=True)
        with open(os.path.join(voc07, "ImageSets", "Main", f"{split}.txt"),
                  "w") as f:
            f.write("\n".join(ids) + "\n")
    secs["voc"] = time.time() - t0
    t0 = time.time()
    coco = os.path.join(root, "COCO")
    ann_id = 1
    for split, n in COCO_SPLITS.items():
        images, anns = [], []
        for i in range(n):
            image_id = 1000 * (split == "val2017") + i + 1
            name = f"{image_id:012d}.jpg"
            copy_fixture("coco_640x480.jpg", os.path.join(coco, split, name))
            images.append({"id": image_id, "file_name": name, "width": 640,
                           "height": 480})
            for m, crowd in enumerate((0, 0, int(i == 0))):
                anns.append({"id": ann_id, "image_id": image_id,
                             "category_id": (1, 3, 18)[m],
                             "bbox": [40.0 + 90 * m, 60.0 + 40 * m, 150.0,
                                      120.0], "area": 18000.0,
                             "iscrowd": crowd})
                ann_id += 1
        os.makedirs(os.path.join(coco, "annotations"), exist_ok=True)
        with open(os.path.join(coco, "annotations",
                               f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": c} for c in range(1, 91)]}, f)
    secs["coco"] = time.time() - t0
    return secs


def decoder_on_the_card(card):
    """Phase 47: build the host decoder, decode each committed fixture and
    hold its sha256 to the manifest."""
    import hashlib
    from afan_torch.utils import imread
    t0 = time.time()
    path = kbuild.build_host("imdecode.cpp")
    imread.load_library()
    print(f"[47] built the image decoder with c++ in {time.time() - t0:.1f} "
          f"s into {os.path.relpath(path, ROOT)}")
    with open(os.path.join(DATA_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for name, want in sorted(manifest.items()):
        p = os.path.join(DATA_FIXTURES, name)
        a = imread.read_label(p) if name.endswith(".png") else \
            imread.read_rgb(p)
        got = hashlib.sha256(a.tobytes()).hexdigest()
        require(list(a.shape) == want["shape"] and got == want["sha256"],
                f"{name}: decoded {a.shape} sha256 {got}, manifest {want}")
        print(f"    {name}: {a.shape} sha256 {got[:16]}... equals the "
              f"manifest (PIL's bytes)")


def cpu_model():
    """The host CPU's model name: ``/proc/cpuinfo``'s, else ``lscpu``'s."""
    with open("/proc/cpuinfo") as f:
        name = next((ln.split(":", 1)[1].strip() for ln in f
                     if ln.lower().startswith("model name")), None)
    if name is None and shutil.which("lscpu"):
        said = subprocess.run(["lscpu"], capture_output=True, text=True,
                              timeout=60).stdout
        name = next((ln.split(":", 1)[1].strip()
                     for ln in said.splitlines()
                     if ln.lower().startswith("model name")), None)
    return name or f"unknown ({platform.machine()})"


def decode_timings(root):
    """Phase 48's decode times: ms per image, median of 20, of a 500x375
    JPEG and a 2048x1024 PNG on this host, and of the image kinds PIL reads
    beyond those: a 500x375 progressive JPEG, a 320x240 CMYK JPEG, a
    500x375 Adam7 label PNG, and the arithmetic-coded (500x375 sequential,
    375x500 progressive) and lossless (500x375) JPEGs that the VOC trees
    hold."""
    from afan_torch.utils import imread
    png = next(os.path.join(dp, f) for dp, _, fs in sorted(os.walk(
        os.path.join(root, "leftImg8bit", "train"))) for f in sorted(fs))
    fixture = functools.partial(os.path.join, DATA_FIXTURES)
    files = {"jpeg_500x375": (fixture("voc_500x375.jpg"), imread.read_rgb),
             "png_2048x1024": (png, imread.read_rgb),
             "progressive_jpeg_500x375": (fixture("progressive_500x375.jpg"),
                                          imread.read_rgb),
             "cmyk_jpeg_320x240": (fixture("cmyk_320x240.jpg"),
                                   imread.read_rgb),
             "adam7_label_png_500x375": (fixture("adam7_label_500x375.png"),
                                         imread.read_label),
             "arith_jpeg_500x375": (fixture("arith_500x375.jpg"),
                                    imread.read_rgb),
             "arith_progressive_jpeg_375x500": (
                 fixture("arith_progressive_375x500.jpg"), imread.read_rgb),
             "lossless_jpeg_500x375": (fixture("lossless_500x375.jpg"),
                                       imread.read_rgb)}
    times = {k: host_ms(lambda p=path, r=read: r(p))
             for k, (path, read) in files.items()}
    print(f"    decode, median of 20 on {cpu_model()} ({os.cpu_count()} "
          f"cores), ms per image: "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return times


@contextlib.contextmanager
def recording_prefetchers(out):
    """``train_detect``'s ``Prefetcher`` records its instances in
    ``out``."""
    saved = train_detect.Prefetcher

    class Recording(saved):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            out.append(self)

    train_detect.Prefetcher = Recording
    try:
        yield
    finally:
        train_detect.Prefetcher = saved


def step_ms(stamps):
    """Each step's ms from its (start, end) stamps."""
    return [(t1 - t0) * 1e3 for t0, t1 in stamps]


def data_recipe_runs(root, updates, host):
    """Phase 49: the four recipes as written with DATA at ``root``, 2 steps
    each (Cityscapes 4); per run the steps' ms and the host's ms before
    each step for its batch go to ``host``: the segmentation loop reads its
    batch between steps, as ``afan``'s does, and the detection loop waits
    on its prefetch queue. Returns the launches of the runs by kernel and
    the runs' checkpoints."""
    print(f"[49] the recipes as written with DATA={root}: "
          f"{', '.join(r[0] for r in DATA_SEG_RECIPES + DATA_DET_RECIPES)} "
          f"({RECIPE_STEPS} steps each, the Cityscapes one "
          f"{DATA_SEG_RECIPES[0][2]})")
    if not os.path.isfile(DET_BACKBONE):
        print(f"    backbone: {calibrated_backbone()}")
    launches = dict.fromkeys(("resize_ce_forward", "resize_ce_backward",
                              "pgd_update", "resize_ce_forward_bf16",
                              "resize_ce_backward_bf16", "pgd_update_bf16",
                              "nms"), 0)
    ckpts = {}
    kinds = {}
    for name, env, steps in DATA_SEG_RECIPES:
        tag = "data_" + os.path.splitext(name)[0]
        stamps = []
        with counting_jpeg_kinds(kinds.setdefault(tag, {})):
            run = run_seg_recipe(tag, recipe_flags(name, env)
                                 + ["--data_root", root], torch.bfloat16,
                                 updates, step_times=stamps, steps=steps)
        # the f32 counts include the bf16 launches, which go to their own
        # entries
        for i, k in enumerate(("resize_ce_forward", "resize_ce_backward",
                               "pgd_update")):
            launches[k] += run[i] - run[3 + i]
            launches[k + "_bf16"] += run[3 + i]
        args = train_segment.get_parser().parse_args(recipe_flags(name, env))
        (d,) = [d for d in os.listdir("checkpoints")
                if d.startswith(f"{args.dataset}_chip_{tag}_")]
        ckpts[args.dataset] = os.path.join(
            "checkpoints", d, f"latest_{args.model}_{args.dataset}.pt")
        gaps = [(b[0] - a[1]) * 1e3 for a, b in zip(stamps, stamps[1:])]
        host[tag] = (step_ms(stamps), gaps,
                     "host ms between steps, reading the next batch "
                     "(from the second step)")
    for name, setting in DATA_DET_RECIPES:
        tag = "data_" + os.path.splitext(name)[0]
        env = {"KNOBS": coco_knobs(setting)} if setting else None
        argv = det_recipe_flags(name, tag, env) + ["--data_dir", root]
        prefetchers, stamps = [], []
        eval_images = (COCO_SPLITS["val2017"] if setting
                       else VOC_DET_SPLITS["test"])
        with recording_prefetchers(prefetchers), \
                counting_jpeg_kinds(kinds.setdefault(tag, {})):
            nms, pgd, pgd16 = run_det_recipe(tag, argv, torch.bfloat16,
                                             updates, None, eval_images,
                                             stamps)
        launches["nms"] += nms
        launches["pgd_update"] += pgd - pgd16
        launches["pgd_update_bf16"] += pgd16
        ckpts[tag] = os.path.join(DET_OUT, tag, f"model-{RECIPE_STEPS}.pt")
        check_scalars(os.path.join(DET_OUT, tag, "summaries"),
                      [("train/loss", i + 1) for i in range(RECIPE_STEPS)],
                      tag)
        host[tag] = (step_ms(stamps),
                     [w * 1e3 for p in prefetchers for w in p.wait_seconds],
                     "wait on the prefetch queue before each step (an "
                     "epoch's first batch waits whole)")
        gc.collect()
        torch.cuda.empty_cache()
    for tag, counts in kinds.items():
        print(f"    {tag} decoded JPEGs by kind: {counts}")
        if "voc07" in tag:
            missing = [k for k in NEW_JPEG_KINDS if not counts.get(k)]
            require(not missing, f"{tag} read no {missing} JPEG")
    return launches, ckpts


def data_eval_runs(root, ckpts, updates):
    """Phase 49, the eval CLIs on the trees: ``eval_segment --task miou`` on
    the Cityscapes val canvas (1024x2048), ``--task pgd`` (1 step) on the
    VOC val canvas (512x512), ``eval_detect --task map`` on the VOC 2007
    test split (difficult objects neutral). Returns their launches."""
    from afan_torch.eval.det_map import ground_truth
    seg = ["--model", SEG_MODEL, "--output_stride", "16", "--data_root",
           root]
    n_city, n_voc = CITY_SPLITS["val"][0], VOC_SEG_SPLITS["val"]
    n_det = VOC_DET_SPLITS["test"]
    runs = [
        (eval_segment.main, seg + ["--dataset", "cityscapes", "--crop_size",
                                   "768", "--task", "miou", "--ckpt",
                                   ckpts["cityscapes"]],
         "eval_segment miou, Cityscapes val canvas 1024x2048", n_city, {}),
        (eval_segment.main, seg + ["--dataset", "voc", "--task", "pgd",
                                   "--pgd_steps", "1", "--ckpt",
                                   ckpts["voc"]],
         "eval_segment pgd (1 step), VOC val canvas 512x512", n_voc,
         {"resize_ce_forward": 1, "resize_ce_backward": 1,
          "pgd_update": 1}),
        (eval_detect.main, ["-s", "voc2007", "-b", "resnet50", "--data_dir",
                            root, "--task", "map", "--checkpoint",
                            ckpts["data_detect_voc07_final_setting1"]],
         "eval_detect map, VOC 2007 test", n_det, {"nms": 2}),
    ]
    total = dict.fromkeys(eval_counts(), 0)
    for main, argv, tag, images, expected in runs:
        with patched_update(share_recording_update(updates)):
            out, counts = run_eval_cli(main, argv, tag, images, expected)
        require(np.isfinite(out) and 0.0 <= out <= 1.0, f"{tag}: {out}")
        print(f"    {tag}: {out:.4f}")
        for k in total:
            total[k] += counts[k]
    _, test, _ = detection_loaders("voc2007", root, 1, MIN_SIDE, MAX_SIDE)
    difficult = sum(int(d.sum()) for _, _, d in
                    ground_truth(test.samples).values())
    require(difficult == n_det, f"{difficult} difficult objects in the "
            f"evaluator's ground truth, expected {n_det}")
    print(f"    the VOC07 mAP's ground truth holds the {difficult} difficult "
          f"objects (neutral)")
    return total


def tall_batch(root):
    """A batch of 8 tall VOC images from ``root`` on the tall canvas
    (1008x608), on the card."""
    loader, _, _ = detection_loaders("voc2007", root, DET_BATCH, MIN_SIDE,
                                     MAX_SIDE)
    b = next(b for b in loader if b.images.shape[1] > b.images.shape[2])
    return (cuda(b.images), cuda(b.boxes), cuda(b.labels.astype(np.int64)),
            cuda(b.valid))


def data_kernels_vs_plain(root, updates, errs):
    """Phase 50, the checks: the upsample + CE at VOC's eval canvas, and on
    bf16 logits at the bf16 recipes' crops; one A-FAN step on a tall batch
    of decoded images with the NMS and PGD-update kernels against one with
    their plain versions, and the NMS kernel on its proposals; the PGD
    update at every shape of phases 49's runs, bit for bit. Returns the
    tall step's NMS calls and batch."""
    print("[50] kernels vs plain versions at the new shapes")
    ce_case(*VOC_CANVAS_CE, {"fwd": errs["resize_ce_forward"],
                             "bwd": errs["resize_ce_backward"]})
    # the shapes the bf16 recipes give it in phase 49: VOC's crop 513 and
    # Cityscapes' crop 768
    for case in BF16_CE_CASES[:2]:
        bf16_ce_case(*case, {"fwd": errs["resize_ce_forward_bf16"],
                             "bwd": errs["resize_ce_backward_bf16"]}, seed=5)
    batch = tall_batch(root)
    model = det_model()
    calls, _ = det_step_kernel_vs_plain(model, batch,
                                        label="[50] tall-canvas A-FAN")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for i, (boxes, valid, thr, plus_one, _) in enumerate(calls):
        kernel_vs_plain(f"tall canvas call {i}", boxes, valid, thr,
                        plus_one, errs["nms"])
    cases = sorted({(shape, gamma, dtype)
                    for shape, _, gamma, dtype, _ in updates},
                   key=lambda c: (c[0], c[1], str(c[2])))
    for i, (shape, gamma, dtype) in enumerate(cases):
        x, g, c = (t.to(dtype) for t in pgd_inputs(shape, 800 + i))
        key = "pgd_update_bf16" if dtype == torch.bfloat16 else "pgd_update"
        for clip in (False, True):
            pgd_case(f"on-disk run ascent {i}", x, g, c, clip, errs[key],
                     gamma, 2.0 / 255)
    return calls, batch


def loader_host_ms(root):
    """The loaders' host ms per batch alone (median over two epochs):
    Cityscapes train at batch 4, crop 768, and VOC 2007 detection train at
    batch 8 on the 600/1000 canvases."""
    out = {}
    for tag, loader in (
            ("cityscapes batch 4", seg_data.cityscapes_loaders(
                root, SEG_BATCH, SEG_CROP)[0]),
            ("voc detection batch 8", detection_loaders(
                "voc2007", root, DET_BATCH, MIN_SIDE, MAX_SIDE)[0])):
        t = []
        for _ in range(2):
            it = iter(loader)
            while True:
                t0 = time.perf_counter()
                if next(it, None) is None:
                    break
                t.append((time.perf_counter() - t0) * 1e3)
        out[tag] = float(np.median(t))
    return out


def data_timings(card, root, calls, batch, updates, host):
    """Phase 50, the times: the loaders' host ms per batch beside the
    recipe steps' ms and the host's ms for each batch; the upsample +
    CE at the VOC canvas, the NMS kernel on the tall canvas's proposals and
    the PGD update at the tall canvas's SE tap and the eval's VOC canvas,
    with plain versions, bounds and the library. Returns the kernels'
    times."""
    print(f"[50] data and kernel timings on {card}")
    for tag, ms in loader_host_ms(root).items():
        print(f"    loader {tag}: {ms:.1f} ms of host time per batch "
              f"(median, two epochs, no card work beside it; {cpu_model()})")
    for tag, (ms, waits, what) in host.items():
        print(f"    {tag}: step wall ms {[round(t, 1) for t in ms]}; {what}: "
              f"{[round(w, 1) for w in waits]} ms")
    lo, lab, g = ce_inputs(*VOC_CANVAS_CE[1:5], seed=3)
    ce = ce_parts(lo, lab, g)
    print(f"    resize+CE {VOC_CANVAS_CE[0]}: forward kernel {ce['fwd']:.4f} "
          f"ms, plain {ce['plain_fwd']:.4f}, library {ce['lib_fwd']:.4f}, "
          f"bound max(bytes {ce['fwd_bytes_ms']:.5f}, operations "
          f"{ce['fwd_ops_ms']:.5f}); backward kernel {ce['bwd']:.4f} ms, "
          f"plain {ce['plain_bwd']:.4f}, library {ce['lib_bwd']:.4f}, bound "
          f"max(bytes {ce['bwd_bytes_ms']:.5f}, operations "
          f"{ce['bwd_ops_ms']:.5f}) ({card})")
    # the bf16 recipes' sites, at the Cityscapes crop
    lo16 = ce_inputs(*BF16_CE_CASES[1][1:5], seed=4)
    ce16 = ce_parts(lo16[0].to(torch.bfloat16), *lo16[1:])
    boxes, valid, thr, plus_one, _ = calls[0]
    k, p, b, o = time_nms_shape(card, "tall canvas proposals", boxes, valid,
                                thr, plus_one)
    tall_se = tuple(batch[0].shape[:1]) + (512, batch[0].shape[1] // 8,
                                           batch[0].shape[2] // 8)
    shapes = sorted({(shape, dtype, gamma)
                     for shape, clip, gamma, dtype, _ in updates
                     if not clip and shape[1:] == tall_se[1:]},
                    key=lambda c: (c[0], str(c[1]), c[2]))
    require(shapes, f"no PGD update at the tall SE tap {tall_se} in the "
            f"on-disk runs")

    times = {"nms": kernel_times(k, p, b, o)}
    for half in ("fwd", "bwd"):
        name = "resize_ce_forward" if half == "fwd" else "resize_ce_backward"
        for suffix, parts in (("", ce), ("_bf16", ce16)):
            times[name + suffix] = kernel_times(
                parts[half], parts[f"plain_{half}"],
                parts[f"{half}_bytes_ms"], parts[f"{half}_ops_ms"],
                parts[f"lib_{half}"])
    times["pgd_update_bf16"] = pgd_times(card, shapes)
    times["pgd_update"] = pgd_times(card, [((1, 512, 512, 3),
                                            torch.float32, 2.0 / 255)])
    for name, t in times.items():
        print(f"    {name} at its new shape: kernel {t['ms']:.5f} ms, plain "
              f"{t['plain_ms']:.5f}, bound {t['bound_ms']:.6f} "
              f"({t['bound_by']}), library {t.get('library_ms')} ({card})")
    return times


def check_scalars(logdir, want, tag):
    """``<logdir>/scalars.jsonl`` holds the records ``want`` ((tag, step)
    in order), finite; returns the records."""
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    require([(r["tag"], r["step"]) for r in recs] == want
            and all(np.isfinite(r["value"]) for r in recs),
            f"{tag}: scalars {recs}, expected {want}")
    mirrored = any(n.startswith("events.out.tfevents")
                   for n in os.listdir(logdir))
    print(f"    {tag}: {os.path.join(logdir, 'scalars.jsonl')} holds "
          f"{[(r['tag'], r['step'], round(r['value'], 5)) for r in recs]}; "
          f"TensorBoard mirror {'written' if mirrored else 'none'}")
    return recs


# Phase 51: recipes/seg_city_final.sh on the tree with the reference
# scripts' --gpu_id, --vis_port and --download, in f32 (its --bf16 left
# out: the library's upsample and cross-entropy on bf16 logits round each
# site's loss to bf16, as afan's do, 2^-8 relative, and the two paths are
# held within FUSED_CE_REL)
SEG_CLI_EXTRA = ["--gpu_id", "0", "--vis_port", "8097", "--download"]
FUSED_CE_REL = 1e-4


def seg_cli_flag_runs(root):
    """Phase 51: the Cityscapes recipe with afan's remaining flags,
    ``--fused_ce on`` and then ``off``, 2 steps and a validation each:
    per step 5 upsample + CE launches each way with ``on`` and none with
    ``off`` (:func:`run_seg_recipe`'s counts), the first steps' losses
    within ``FUSED_CE_REL``, ``runs/<exp>/scalars.jsonl`` holding each
    step's ``train/loss`` and the validation's ``val/mIoU``, the warning
    ``--download`` logs. Returns both runs' launches."""
    name, env, _ = DATA_SEG_RECIPES[0]
    flags = ([f for f in recipe_flags(name, env) if f != "--bf16"]
             + ["--data_root", root] + SEG_CLI_EXTRA)
    print(f"[51] {name} on the tree with {' '.join(SEG_CLI_EXTRA)}, f32, "
          f"--fused_ce on then off, {RECIPE_STEPS} steps each")
    first, total = {}, None
    for mode in ("on", "off"):
        tag = f"data_fused_{mode}"
        argv = flags + ["--fused_ce", mode]
        args = train_segment.get_parser().parse_args(
            argv + ["--exp", "chip_" + tag])
        exp = train_segment.experiment_name(args)
        shutil.rmtree(os.path.join("runs", exp), ignore_errors=True)
        run = run_seg_recipe(tag, argv, torch.float32, [])
        total = run if total is None else tuple(map(sum, zip(total, run)))
        want = [("train/loss", i + 1) for i in range(RECIPE_STEPS)] + [
            ("val/mIoU", RECIPE_STEPS)]
        first[mode] = check_scalars(os.path.join("runs", exp), want,
                                    tag)[0]["value"]
        with open(os.path.join("checkpoints", exp, "train.log")) as f:
            require("--download requested" in f.read(),
                    f"{tag}: no --download warning in its log")
        gc.collect()
        torch.cuda.empty_cache()
    rel = abs(first["on"] - first["off"]) / abs(first["on"])
    print(f"    first-step loss: --fused_ce on {first['on']:.7f}, off "
          f"{first['off']:.7f}, {rel:.3e} apart (relative; at most "
          f"{FUSED_CE_REL:g})")
    require(rel <= FUSED_CE_REL, f"--fused_ce on and off differ by {rel}")
    return total


def data_phases(card):
    """Phases 47-51; returns (launches, error, times) of each kernel on the
    on-disk paths."""
    decoder_on_the_card(card)
    root = os.path.join(DATA_OUT, "DATA")
    shutil.rmtree(DATA_OUT, ignore_errors=True)
    secs = write_data_tree(root)
    print(f"[48] wrote the trees under {root} at the datasets' sizes and "
          f"layouts in {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}"
          f": Cityscapes {CITY_SPLITS['train'][0]} train and "
          f"{CITY_SPLITS['val'][0]} val at {CITY_HW[1]}x{CITY_HW[0]}; VOC "
          f"2012 segmentation {VOC_SEG_SPLITS}; VOC 2007 detection "
          f"{VOC_DET_SPLITS}; COCO {COCO_SPLITS}")
    decode_timings(root)
    updates, host = [], {}
    launches, ckpts = data_recipe_runs(root, updates, host)
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in data_eval_runs(root, ckpts, updates).items():
        launches[k] += n
    gc.collect()
    torch.cuda.empty_cache()
    errs = {k: [] for k in launches}
    calls, batch = data_kernels_vs_plain(root, updates, errs)
    require(all(errs.values()), f"phase 50 held no kernel of "
            f"{[k for k, e in errs.items() if not e]} against its plain "
            f"version")
    times = data_timings(card, root, calls, batch, updates, host)
    gc.collect()
    torch.cuda.empty_cache()
    run = seg_cli_flag_runs(root)
    for i, k in enumerate(("resize_ce_forward", "resize_ce_backward",
                           "pgd_update")):
        launches[k] += run[i]
    print(f"    on-disk launches (phases 49-51's runs): {launches}")
    return {k: (launches[k], max(errs[k]), times[k]) for k in launches}


def merge_entry(entries, extra):
    """Add the detection training path's part to a kernel's entry: the
    launches, times and bounds of both paths summed, the larger error."""
    for e in entries:
        if e["name"] != extra["name"]:
            continue
        if e["bound_ms"] < extra["bound_ms"]:
            e["bound_by"] = extra["bound_by"]
        for key in ("ms", "plain_ms", "bound_ms"):
            e[key] += extra[key]
        e["launches"] = (e["launches"] or 0) + extra["launches"]
        e["max_abs_err"] = max(e["max_abs_err"], extra["max_abs_err"])
        return
    entries.append(extra)


# ---------- data parallelism (phases 55-58) ----------

DP_RANKS, DP_STEPS = 2, 2
DP_DIR = os.path.join(ROOT, "build", "chip_smoke_dp")
# World 2 against world 1, both in full f32 with deterministic cuDNN, world 2
# replaying world 1's sampler draws and ascent perturbations (each rank's
# own ascent still runs). Bound: twice what world 1 differs from itself on
# the same batch with its halves swapped (the same function in another row
# order: the float noise of these steps, which atomic adds in the upsample's
# backward, sign flips and AFN's division by a channel deviation magnify; a
# seg update moves some 20% that way), and no less than the least bound of
# each error: the losses (relative), the first step's gradient of each
# ascent without a random start (L2 relative: the part of the step that is
# A-FAN's own, the feature gradient through the global BatchNorm's backward
# and the loss shares), all trained parameters (L2 relative) and their
# update (final minus initial, L2 relative). The fraction of ascent entries
# that end more than half a step from world 1's, and of first-gradient
# entries whose sign differs, is shown and not bounded: the sign steps turn
# any float difference in a near-zero gradient entry into a whole step, and
# the steps after it compound it (seg's swapped run moves half the entries).
DP_FLOOR_FACTOR = 2.0
DP_MIN_BOUND = {"loss": 1e-5, "grad": 1e-3, "params": 1e-5, "update": 1e-3}
DP_TRAINERS = ("alfa", "seg", "det")


def dp_counts():
    return {"nms": knms.launches, "resize_ce_forward": krce.fwd_launches,
            "resize_ce_backward": krce.bwd_launches,
            "resize_ce_forward_bf16": krce.bf16_fwd_launches,
            "resize_ce_backward_bf16": krce.bf16_bwd_launches,
            "resize_ce_forward_window": krce.window_fwd_launches,
            "resize_ce_backward_window": krce.window_bwd_launches,
            "resize_ce_forward_window_bf16": krce.bf16_window_fwd_launches,
            "resize_ce_backward_window_bf16": krce.bf16_window_bwd_launches,
            "pgd_update": kpgd.launches}


def dp_reset_counts():
    knms.launches = krce.fwd_launches = krce.bwd_launches = 0
    krce.bf16_fwd_launches = krce.bf16_bwd_launches = 0
    krce.window_fwd_launches = krce.window_bwd_launches = 0
    krce.bf16_window_fwd_launches = krce.bf16_window_bwd_launches = 0
    kpgd.launches = 0


def dp_trainer(trainer, pick, dtype=torch.float32):
    """``trainer``'s full-width model, step and ``pick``'s rows of its
    global batch (phase 12's ALFA, phase 8's Cityscapes A-FAN, in
    ``dtype``, phase 15's VOC A-FAN; dropout off, so that no draw differs
    between the runs)."""
    if trainer == "alfa":
        model, step = cls_step("alfa")
        batch = cls_batch(0)
    elif trainer == "seg":
        model = build_model(SEG_MODEL, 19, 16, dtype)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.cuda()
        imgs, labs = seg_batch(0)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        step = seg_step(model)
        batch = (imgs, labs)
    else:
        model = det_model(0)
        step = det_step(model)
        batch = det_batch(0)
    dp.replicate_state(model)
    return model, step, tuple(pick(t) for t in batch)


def dp_swapped(t):
    """The global batch with its two halves swapped: the rows of world 2's
    rank 1 first. A world-1 run on it computes the same function in another
    row order, which bounds what world 2 may differ by."""
    n = t.shape[0] // 2
    return (torch.cat((t[n:], t[:n])) if torch.is_tensor(t)
            else np.concatenate((t[n:], t[:n])))


def dp_flat_params(model):
    return torch.cat([p.detach().reshape(-1).float() for p in
                      model.parameters() if p.requires_grad]).cpu().numpy()


@contextlib.contextmanager
def dp_priorities(pick, record=None, replay=None):
    """The detection samplers' uniforms: recorded (world 1), or ``pick``'s
    rows of the recorded global ones replayed, in call order."""
    real = sampling.draw_priorities
    it = iter(replay or ())
    if record is None and replay is None:
        yield
        return

    def draw(shape, generator, device=None):
        if replay is None:
            out = real(shape, generator, device)
            record.append(tuple(u.cpu() for u in out))
            return out
        out = tuple(pick(u).to(device) for u in next(it))
        require(tuple(out[0].shape) == tuple(shape),
                f"replayed uniforms {tuple(out[0].shape)} for {shape}")
        return out

    sampling.draw_priorities = draw
    try:
        yield
    finally:
        sampling.draw_priorities = real


@contextlib.contextmanager
def dp_ascents(pick, folder, replay, flips, grads):
    """World 1 (``replay`` false) saves each ascent's perturbation (result
    minus start) and the gradient of its first step (where the ascent has
    no random start) under ``folder`` in call order; a replaying run (a
    rank of world 2, or world 1 on the swapped batch) runs its own ascent
    (its kernels too), then goes on from its start plus ``pick``'s rows of
    the saved perturbation, so that sign flips of near-zero gradients
    between the runs do not compound. It appends to ``flips`` the fraction
    of its entries that differ from the saved ones by more than half a
    step, and to ``grads`` its first gradient's L2 error relative to
    ``pick``'s rows of the saved one and the fraction of its entries whose
    sign differs: the gradient of the global loss at
    the tap, through the global BatchNorm's backward and the loss shares,
    before any step compounds a difference."""
    mods = (cls_loop, segment_loop, detect_loop)
    count = itertools.count()

    def ascent(loss_fn, x, **kw):
        i = next(count)
        first = []
        inner = attack.pgd_update

        def update(xa, g, center=None, **ukw):
            if not first:
                first.append(g.detach().float())
            return inner(xa, g, center, **ukw)

        with patched_update(update):
            out = attack.pgd(loss_fn, x, **kw)
        path = os.path.join(folder, f"ascent{i}.npy")
        gpath = os.path.join(folder, f"ascent{i}_grad.npy")
        if not replay:
            np.save(path, (out.float() - x.float()).cpu().numpy())
            if not kw.get("randinit"):
                np.save(gpath, first[0].cpu().numpy())
            return out
        saved = np.load(path, mmap_mode="r")
        delta = torch.from_numpy(np.array(pick(saved))).to(x.device)
        flips.append(float(((out.float() - x.float() - delta).abs()
                            > float(kw["gamma"]) / 2).float().mean()))
        if not kw.get("randinit"):
            want = torch.from_numpy(np.array(pick(np.load(
                gpath, mmap_mode="r")))).to(x.device)
            grads.append((float((first[0] - want).norm()
                                / want.norm().clamp_min(1e-30)),
                          float((torch.sign(first[0]) != torch.sign(want))
                                .float().mean())))
        return (x.float() + delta).to(x.dtype)

    os.makedirs(folder, exist_ok=True)
    for m in mods:
        m.pgd = ascent
    try:
        yield
    finally:
        for m in mods:
            m.pgd = attack.pgd


def dp_steps(trainer, pick, priorities=None, record=None, probe=None,
             replay=False, flips=None, grads=None, dtype=torch.float32,
             mesh=None, pick_ascent=None, tag=None, folder=DP_DIR):
    """``DP_STEPS`` steps of ``trainer`` on ``pick``'s rows, in full f32
    (the seg model in ``dtype``) with deterministic cuDNN: the global
    losses, the last step's ms, the peak GiB, the kernels' launches in the
    steps, the flat trained parameters and their update. With ``flips`` and
    ``grads`` (lists) the ascents are saved (world 1) or replayed
    (``replay``, world 2) by :func:`dp_ascents`, under ``folder`` and
    ``tag`` (the trainer's name by default), their perturbations cut by
    ``pick_ascent`` (``pick`` by default). ``probe`` (a dict) takes the
    first inputs of each kernel's wrapper. With a ``mesh`` each step runs
    row-sharded on it."""
    tag = tag or trainer
    with deterministic():
        model, step, batch = dp_trainer(trainer, pick, dtype)
        start = dp_flat_params(model)
        gen = torch.Generator("cuda").manual_seed(dp.rank_seed(0))
        losses, ms = [], 0.0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dp_reset_counts()
        with dp_priorities(pick, record, priorities), \
                contextlib.ExitStack() as stack:
            if probe is not None:
                stack.enter_context(dp_probes(probe))
            if flips is not None:
                stack.enter_context(dp_ascents(
                    pick_ascent or pick,
                    os.path.join(folder, f"{tag}_ascents"), replay, flips,
                    grads))
            first_step = 0
            for i in range(DP_STEPS):
                t0 = time.perf_counter()
                with (spatial.sharded(mesh) if mesh is not None
                      else contextlib.nullcontext()):
                    out = (step(*batch) if trainer == "seg"
                           else step(*batch, gen))
                losses.append(float(out["loss"]))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if i == 0 and grads is not None:
                    first_step = len(grads)
        counts = dp_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        flat = dp_flat_params(model)
    del model, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "ms": ms, "peak_gib": peak,
            "counts": counts, "params": flat, "update": flat - start,
            "flips": flips, "grads": grads, "first_step": first_step}


@contextlib.contextmanager
def dp_probes(probe):
    """Keep the first call's inputs of the NMS, upsample + CE and PGD-update
    wrappers (the per-rank shapes) in ``probe``."""
    nms_fn, site_fn, upd_fn = (tnms.nms_sorted_mask,
                               segment_loop.fused_resize_nll_sums,
                               attack.pgd_update)

    def kept(t):
        return None if t is None else t.detach().contiguous().clone()

    def nms(boxes, valid, thr, plus_one=True):
        probe.setdefault("nms", (kept(boxes), kept(valid), thr, plus_one))
        return nms_fn(boxes, valid, thr, plus_one)

    def site(lo, lab, size, focal=None, window=None):
        probe.setdefault("ce", (kept(lo), kept(lab), size, focal, window))
        return site_fn(lo, lab, size, focal, window)

    def update(x, g, center=None, **kw):
        probe.setdefault("pgd", (kept(x), kept(g), kept(center), kw))
        return upd_fn(x, g, center, **kw)

    with patched_nms(nms), patched_site_op(site), patched_update(update):
        yield


def dp_probe_errs(probe, what="per-rank"):
    """Each kernel on the inputs that ``probe`` kept (``what``: the
    per-rank ones by default), against its plain version (phases 3, 7 and
    11's criteria); the largest absolute errors."""
    errs = {}
    if "nms" in probe:
        boxes, valid, thr, plus_one = probe["nms"]
        e = []
        kernel_vs_plain(f"{what} proposals", boxes, valid, thr, plus_one, e)
        errs["nms"] = max(e)
    if "ce" in probe:
        lo, lab, size, focal, _ = probe["ce"]
        g = torch.rand(lo.shape[0], device="cuda")
        sums = krce.resize_ce_forward(lo, lab, focal)
        dlo = krce.resize_ce_backward(lo, lab, g, focal)
        want_s = trce.fused_resize_nll_sums_plain(lo, lab, size, focal)
        want_d = trce.resize_ce_grad_plain(lo, lab, g, focal)
        es, eg = rel_err(sums, want_s), rel_err(dlo, want_d)
        errs["resize_ce_forward"] = float((sums - want_s).abs().max())
        errs["resize_ce_backward"] = float((dlo - want_d).abs().max())
        print(f"  upsample + CE on the {what} logits {tuple(lo.shape)} -> "
              f"{tuple(size)}: sums rel {es:.3e}, grad rel {eg:.3e}")
        require(es <= CE_SUM_TOL and eg <= CE_GRAD_TOL,
                f"{what} upsample + CE: {es}, {eg}")
    if "pgd" in probe:
        x, g, c, kw = probe["pgd"]
        got = kpgd.pgd_update(x, g, c, **kw)
        want = tpgd.pgd_update_plain(x, g, c, **kw)
        torch.cuda.synchronize()
        finite = torch.isfinite(got) & torch.isfinite(want)
        errs["pgd_update"] = float((got - want)[finite].abs().max())
        print(f"  PGD update at the {what} tap {tuple(x.shape)}: bit-equal "
              f"{bits_equal(got, want)}")
        require(bits_equal(got, want), f"{what} PGD update != plain")
    return errs


def dp_rank(rank, priorities, one_losses):
    """Phase 56, one rank of the gloo group on cuda:0: the three trainers'
    steps on this rank's rows; rank 0 also holds each kernel at its
    per-rank inputs against the plain version."""
    for m in (knms, krce, kpgd):
        m.load_library()
    out = {}
    for trainer in DP_TRAINERS:
        probe = {} if rank == 0 else None
        r = dp_steps(trainer, dp.shard_batch,
                     priorities if trainer == "det" else None,
                     probe=probe, replay=True, flips=[], grads=[])
        r["errors"] = dp_errors(r, trainer, one_losses[trainer])
        del r["params"], r["update"]
        if rank == 0:
            r["errs"] = dp_probe_errs(probe)
        out[trainer] = r
    return out


def dp_kernel_times(card):
    """Phase 56's kernel times, in this process (no rank runs then): each
    kernel at the per-rank shapes of the world-2 steps, its plain version,
    the library's where there is one, and its bound."""
    print("    the kernels at the per-rank shapes, timed in one process:")
    time_pgd_update(card, (CLS_BATCH // DP_RANKS, 16, 32, 32))
    time_pgd_update(card, (DET_BATCH // DP_RANKS, 512, 76, 126))
    h, b = SEG_CROP // 4, SEG_BATCH // DP_RANKS
    rng = np.random.RandomState(5)
    lab = seg_batch(0)[1][:b].to(torch.int32).contiguous()
    lo = cuda(rng.randn(b, 19, h, h).astype(np.float32))
    parts = ce_parts(lo, lab, torch.ones(b, device="cuda"))
    print(f"    resize+CE B={b} {h}->{SEG_CROP} C=19: forward kernel "
          f"{parts['fwd']:.4f} ms, plain {parts['plain_fwd']:.4f}, library "
          f"{parts['lib_fwd']:.4f}, bound max(bytes "
          f"{parts['fwd_bytes_ms']:.5f}, operations "
          f"{parts['fwd_ops_ms']:.5f}); backward kernel {parts['bwd']:.4f} "
          f"ms, plain {parts['plain_bwd']:.4f}, library "
          f"{parts['lib_bwd']:.4f}, bound max(bytes "
          f"{parts['bwd_bytes_ms']:.5f}, operations "
          f"{parts['bwd_ops_ms']:.5f}) ({card})")
    g = DET_BATCH // DP_RANKS
    boxes = cuda(np.stack([sorted_boxes(12000, 70 + i) for i in range(g)]))
    valid = torch.ones(g, 12000, dtype=torch.bool, device="cuda")
    time_nms_shape(card, "per-rank training proposals", boxes, valid, 0.7)


def dp_nccl_rank(rank):
    """Phase 57: one ALFA step on the NCCL backend at world 1, counting the
    all-reduces it runs there."""
    kpgd.load_library()
    calls = []
    real = dp.dist.all_reduce

    def counting(t, *a, **k):
        calls.append(t.numel())
        return real(t, *a, **k)

    dp.dist.all_reduce = counting
    try:
        r = dp_steps("alfa", lambda t: t)
    finally:
        dp.dist.all_reduce = real
    return {"backend": dp.dist.get_backend(), "size": dp.world_size(),
            "losses": r["losses"], "all_reduces": len(calls),
            "elements": sum(calls)}


def dp_grads(r):
    """Each ascent's first-gradient error and sign flips, the first step's
    before the bar."""
    def fmt(part):
        return ", ".join(f"{e:.3g}/{f:.3g}" for e, f in part)
    return (f"[{fmt(r['grads'][:r['first_step']])} | "
            f"{fmt(r['grads'][r['first_step']:])}]")


def dp_errors(r, trainer, losses, folder=DP_DIR):
    """A replaying run's relative errors against phase 55's world-1 run:
    largest loss, largest first-step ascent gradient (L2) and fraction of
    its entries with another sign, all trained parameters (L2), their
    update (L2), and the largest fraction of flipped ascent entries. The
    gradients are those of the first step's ascents, taken at the same
    parameters in both runs; a later step's (``grad_later``, shown) start
    from parameters that the first update already moved apart."""
    first, later = (r["grads"][:r["first_step"]],
                    r["grads"][r["first_step"]:])
    out = {"loss": max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(r["losses"], losses)),
           "grad": max([e for e, _ in first] or [0.0]),
           "grad_flips": max([f for _, f in first] or [0.0]),
           "grad_later": max([e for e, _ in later] or [0.0]),
           "flips": max(r["flips"] or [0.0])}
    for key in ("params", "update"):
        want = np.load(os.path.join(folder, f"{trainer}_{key}.npy"))
        out[key] = float(np.linalg.norm(r[key] - want)
                         / max(np.linalg.norm(want), 1e-30))
    return out


def dp_world_one(card):
    """Phase 55: the world-1 steps and their swapped-batch floors; (world
    1's results, the floors, the detection samplers' uniforms)."""
    print(f"[55] data parallelism: the world-1 steps ({DP_STEPS} each, full "
          f"f32, deterministic cuDNN) of ALFA (batch {CLS_BATCH}), the "
          f"Cityscapes A-FAN seg step (batch {SEG_BATCH}, crop {SEG_CROP}) "
          f"and the VOC setting-1 A-FAN detection step (batch {DET_BATCH}); "
          f"again on the batch with its halves swapped, replaying the "
          f"first run's draws and ascents")
    if not os.path.exists(DET_BACKBONE):
        calibrated_backbone()
    os.makedirs(DP_DIR, exist_ok=True)
    one, floor, uniforms = {}, {}, []
    for trainer in DP_TRAINERS:
        r = dp_steps(trainer, lambda t: t, record=uniforms
                     if trainer == "det" else None, flips=[], grads=[])
        for key in ("params", "update"):
            np.save(os.path.join(DP_DIR, f"{trainer}_{key}.npy"), r.pop(key))
        one[trainer] = r
        print(f"    {trainer}: losses {r['losses']}, step {r['ms']:.3f} ms, "
              f"peak {r['peak_gib']:.2f} GiB, launches {r['counts']} "
              f"({card})")
        sw = dp_steps(trainer, dp_swapped, uniforms if trainer == "det"
                      else None, replay=True, flips=[], grads=[])
        floor[trainer] = dp_errors(sw, trainer, r["losses"])
        print(f"      the swapped batch: losses {sw['losses']}; errors "
              f"{floor[trainer]}; each ascent's gradient error and sign "
              f"flips {dp_grads(sw)}")
    return one, floor, uniforms


def dp_check(card, ranks, one, floor):
    """Phases 56 (the world-2 ranks' results against world 1), 57 and 58;
    the kernels' launches per rank of the world-2 steps and their largest
    errors at the per-rank inputs."""
    print(f"[56] the same steps at world {DP_RANKS}: {DP_RANKS} gloo ranks on "
          f"cuda:0, each on its rows of the global batch; the detection "
          f"samplers' uniforms and the ascents of phase 55 replayed. A "
          f"correctness run: {DP_RANKS} ranks sharing one card are no speed "
          f"figure")
    parts = {}
    for trainer in DP_TRAINERS:
        for r in ranks:
            require(r[trainer]["losses"] == ranks[0][trainer]["losses"],
                    f"{trainer}: the ranks report different global losses")
        got = ranks[0][trainer]
        errs = {k: max(r[trainer]["errors"][k] for r in ranks)
                for k in floor[trainer]}
        per_rank = [r[trainer]["counts"] for r in ranks]
        print(f"    {trainer}: losses {got['losses']} (world 1 "
              f"{one[trainer]['losses']}); errors {errs}; the swapped "
              f"batch's {floor[trainer]}")
        for i, r in enumerate(ranks):
            print(f"      rank {i}: step {r[trainer]['ms']:.3f} ms, peak "
                  f"{r[trainer]['peak_gib']:.2f} GiB, launches "
                  f"{r[trainer]['counts']} ({card}); each ascent's gradient "
                  f"error and sign flips {dp_grads(r[trainer])}")
        for k, least in DP_MIN_BOUND.items():
            bound = max(DP_FLOOR_FACTOR * floor[trainer][k], least)
            require(errs[k] <= bound, f"{trainer}: world-2 {k} error "
                    f"{errs[k]} above {bound}")
        kernels = {"alfa": ("pgd_update",),
                   "seg": ("resize_ce_forward", "resize_ce_backward",
                           "pgd_update"),
                   "det": ("nms", "pgd_update")}[trainer]
        for k in kernels:
            require(all(c[k] > 0 for c in per_rank),
                    f"{trainer}: a rank launched no {k} kernel")
            require(per_rank[0][k] == one[trainer]["counts"][k],
                    f"{trainer}: {k} launched {per_rank[0][k]} times per "
                    f"rank, {one[trainer]['counts'][k]} at world 1")
            launches, err, times = parts.get(k, (0, 0.0, None))
            parts[k] = (launches + per_rank[0][k],
                        max(err, got["errs"].get(k, 0.0)),
                        dict(ms=None, plain_ms=None, bound_ms=None,
                             bound_by=None))

    dp_kernel_times(card)

    print("[57] the NCCL backend at world 1 through the same launcher: one "
          "ALFA step")
    nccl = launch(dp_nccl_rank, 1, device="cuda", timeout=600,
                  deadline=600)[0]
    print(f"    backend {nccl['backend']}, world {nccl['size']}: losses "
          f"{nccl['losses']} (phase 55 {one['alfa']['losses']}); "
          f"{nccl['all_reduces']} all-reduces of {nccl['elements']} "
          f"elements in {DP_STEPS} steps")
    require(nccl["backend"] == "nccl" and nccl["all_reduces"] > 0,
            "no all-reduce ran on NCCL")
    err = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(nccl["losses"], one["alfa"]["losses"]))
    require(err <= 1e-6, f"NCCL world-1 ALFA losses off by {err}")

    print("[58] train_classify --num_devices 2 on this machine")
    if torch.cuda.device_count() >= 2:
        print(f"    {torch.cuda.device_count()} cards visible: not a "
              f"one-card machine, skipped")
    else:
        try:
            train_classify.main(["--num_devices", "2", "--save_dir",
                                 os.path.join(DP_DIR, "refused")])
        except ValueError as e:
            require("--num_devices 2" in str(e), f"the message {e}")
            print(f"    raised: {e}")
        else:
            require(False, "--num_devices 2 ran on a one-card machine")
    return parts


# ---------- spatial sharding (phases 59-62) ----------

SP_MESH = (1, 2)
SP_DIR = os.path.join(ROOT, "build", "chip_smoke_spatial")
SP_DTYPES = (torch.float32, torch.bfloat16)
# the windowed kernels' rows of the kernels line, by dtype: (forward,
# backward)
SP_KERNELS = {torch.float32: ("resize_ce_forward_window",
                              "resize_ce_backward_window"),
              torch.bfloat16: ("resize_ce_forward_window_bf16",
                               "resize_ce_backward_window_bf16")}


def sp_tag(dtype):
    return "seg_" + str(dtype).rsplit(".", 1)[-1]


def sp_picks(mesh):
    """This rank's block of the global batch (data rows, then the rows of
    the NHWC images and NHW labels), and its block of an NCHW feature of
    the global batch (the ascents' perturbations and gradients)."""
    def feature(t):
        t = t[dp.split_rows(t.shape[0], mesh.data_index, mesh.data)]
        return t[:, :, dp.split_rows(t.shape[2], mesh.spatial_index,
                                     mesh.spatial)]
    return (lambda t: dp.shard_batch_spatial(mesh, t)), feature


def sp_window_case(label, lo, lab, window, g, errs):
    """The windowed kernels on ``lo`` (a window's logits rows) and ``lab``
    (its label rows) against the plain version on the same window: f32 as
    phase 7 holds them (sums within ``CE_SUM_TOL``, gradient within
    ``CE_GRAD_TOL``); bf16 logits: sums within ``CE_SUM_TOL`` and equal to
    the f32 kernel's on the widened logits, the gradient the f32 kernel's
    rounded to bf16, bit for bit, and that f32 gradient within
    ``CE_GRAD_TOL`` of the plain version's on the widened logits (against
    the plain bf16 gradient one bf16 ulp of an entry near the largest, up
    to 2^-7 of it, is shown, not bounded: phase 28's ``BF16_GRAD_TOL``
    allows half that, and a step's logits reach it). The largest absolute
    errors go to ``errs[dtype]``."""
    size = tuple(lab.shape[1:])
    sums = krce.resize_ce_forward(lo, lab, None, window)
    dlo = krce.resize_ce_backward(lo, lab, g, None, window)
    want_s = trce.fused_resize_nll_sums_plain(lo, lab, size, None, window)
    want_d = trce.resize_ce_grad_plain(lo, lab, g, None, window)
    torch.cuda.synchronize()
    es = rel_err(sums, want_s)
    eg = rel_err(dlo.float(), want_d.float())
    e = errs.setdefault(lo.dtype, [0.0, 0.0])
    e[0] = max(e[0], float((sums - want_s).abs().max()))
    e[1] = max(e[1], float((dlo.float() - want_d.float()).abs().max()))
    line = (f"    {label}: lo {tuple(lo.shape)} {lo.dtype} rows "
            f"[{window[2]}, {window[2] + lo.shape[2]}) of {window[0]}, labels "
            f"rows [{window[3]}, {window[3] + size[0]}) of {window[1]}: sums "
            f"rel {es:.3e}, grad rel {eg:.3e}")
    require(es <= CE_SUM_TOL, f"{label}: sums rel err {es}")
    if lo.dtype == torch.bfloat16:
        wide = lo.float()
        dlo32 = krce.resize_ce_backward(wide, lab, g, None, window)
        same = (torch.equal(sums, krce.resize_ce_forward(wide, lab, None,
                                                         window))
                and torch.equal(dlo, dlo32.bfloat16()))
        eg32 = rel_err(dlo32, trce.resize_ce_grad_plain(wide, lab, g, None,
                                                        window))
        print(f"{line}; the f32 kernels' on the widened logits, rounded to "
              f"bf16, bit for bit: {same}; their f32 gradient against the "
              f"plain version's rel {eg32:.3e}")
        require(same and eg32 <= CE_GRAD_TOL,
                f"{label}: bf16 window {same}, f32 gradient {eg32}")
    else:
        print(line)
        require(eg <= CE_GRAD_TOL, f"{label}: grad rel err {eg}")


def sp_window_of(lo, lab, size, r):
    """Rank ``r`` of ``size``'s window of whole-map logits and labels: its
    logits rows, label rows and ``(hg, Hg, y0, Y0)``."""
    hg, Hg = lo.shape[2], lab.shape[1]
    rows = dp.split_rows(Hg, r, size)
    y0, y1 = resize_window(hg, Hg, rows)
    return (lo[:, :, y0:y1].contiguous(), lab[:, rows].contiguous(),
            (hg, Hg, y0, rows.start))


def sp_kernels_vs_plain(card, errs):
    """Phase 61: the windowed kernels at the recipe's per-rank shapes,
    f32 and bf16, on the top-edge and bottom-edge windows of a 1 x 2 mesh
    and the interior window of a 1 x 3 one; the whole map's sums are the
    two windows' sums and its gradient the windows' gradients added into
    their rows (f32, within ``CE_SUM_TOL`` and ``CE_GRAD_TOL``)."""
    print(f"[61] windowed upsample + CE kernels vs their plain versions at "
          f"the recipe's per-rank shapes ({card})")
    h = SEG_CROP // 4
    lo, lab, g = ce_inputs(SEG_BATCH, (h, h), (SEG_CROP, SEG_CROP), 19,
                           seed=3)
    for dtype in SP_DTYPES:
        x = lo.to(dtype)
        for label, r, size in (("top edge, 1 x 2", 0, 2),
                               ("bottom edge, 1 x 2", 1, 2),
                               ("interior, 1 x 3", 1, 3)):
            lw, bw, win = sp_window_of(x, lab, size, r)
            sp_window_case(label, lw, bw, win, g, errs)
    whole_s = krce.resize_ce_forward(lo, lab)
    whole_d = krce.resize_ce_backward(lo, lab, g)
    sums, dlo = torch.zeros_like(whole_s), torch.zeros_like(whole_d)
    for r in range(2):
        lw, bw, win = sp_window_of(lo, lab, 2, r)
        sums += krce.resize_ce_forward(lw, bw, None, win)
        dlo[:, :, win[2]:win[2] + lw.shape[2]] += krce.resize_ce_backward(
            lw, bw, g, None, win)
    es, eg = rel_err(sums, whole_s), rel_err(dlo, whole_d)
    print(f"    the two windows against the whole map's kernels: sums rel "
          f"{es:.3e}, gradient rel {eg:.3e}")
    require(es <= CE_SUM_TOL and eg <= CE_GRAD_TOL,
            f"the windows do not add up to the whole map: {es}, {eg}")


def sp_rank(rank, one_losses, refs):
    """Phase 60, one rank of the 1 x 2 mesh on cuda:0: the recipe's step
    in f32 and bf16, row-sharded, replaying phase 59's ascents (saved under
    ``refs[tag]``: a folder and a name); each rank holds the windowed
    kernels at its own first site's inputs against the plain version."""
    for m in (krce, kpgd):
        m.load_library()
    mesh = dp.make_mesh_2d(*SP_MESH)
    batch_pick, feature_pick = sp_picks(mesh)
    out = {}
    for dtype in SP_DTYPES:
        tag, probe, errs = sp_tag(dtype), {}, {}
        folder, name = refs[tag]
        r = dp_steps("seg", batch_pick, probe=probe, replay=True, flips=[],
                     grads=[], dtype=dtype, mesh=mesh,
                     pick_ascent=feature_pick, tag=name, folder=folder)
        r["errors"] = dp_errors(r, name, one_losses[tag], folder)
        del r["params"], r["update"]
        lo, lab, size, _, window = probe["ce"]
        sp_window_case(f"rank {rank} of 2, its first site", lo, lab, window,
                       torch.rand(lo.shape[0], device="cuda"), errs)
        r["errs"] = errs[dtype]
        r["window"] = (tuple(lo.shape), tuple(lab.shape), window)
        out[tag] = r
    return out


def sp_kernel_times(card, window_shapes):
    """Phase 62's kernel times: each windowed kernel at rank 0's shapes
    (the step's B=4 sites; the spectrum site is B=8), f32 and bf16, in
    turns with the library composition on the window, with its plain
    version and its bound."""
    times = {}
    for dtype in SP_DTYPES:
        lo_shape, lab_shape, window = window_shapes[dtype]
        rng = np.random.RandomState(6)
        lo = cuda(rng.randn(*lo_shape).astype(np.float32)).to(dtype)
        lab = seg_batch(0)[1][:lab_shape[0], :lab_shape[1]].to(
            torch.int32).contiguous()
        parts = ce_parts(lo, lab, torch.ones(lo_shape[0], device="cuda"),
                         window)
        fwd, bwd = SP_KERNELS[dtype]
        for name, half in ((fwd, "fwd"), (bwd, "bwd")):
            times[name] = kernel_times(
                parts[half], parts[f"plain_{half}"], parts[f"{half}_bytes_ms"],
                parts[f"{half}_ops_ms"], parts[f"lib_{half}"])
            t = times[name]
            print(f"    {name} at rank 0's window: lo {lo_shape} {dtype} -> "
                  f"labels {lab_shape}, window {window}: kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, library "
                  f"{t['library_ms']:.4f}, bound {t['bound_ms']:.5f} "
                  f"({t['bound_by']}); kernel at "
                  f"{t['ms'] / t['bound_ms']:.1f}x its bound ({card})")
    return times


def sp_world_one(card, dp_seg=None):
    """Phase 59: the world-1 steps, f32 and bf16, and their swapped-batch
    floors; (world 1's results, the floors, where each one's records lie).
    ``dp_seg`` (phase 55's seg result and floor, the same f32 runs) stands
    in for the f32 ones when the data-parallel group ran."""
    os.makedirs(SP_DIR, exist_ok=True)
    print(f"[59] spatial sharding: the world-1 Cityscapes A-FAN seg step "
          f"(batch {SEG_BATCH}, crop {SEG_CROP}; {DP_STEPS} steps, "
          f"deterministic cuDNN, dropout off) in f32 and bf16, then on the "
          f"batch with its halves swapped, replaying the first run's "
          f"ascents")
    one, floor, refs = {}, {}, {}
    for dtype in SP_DTYPES:
        tag = sp_tag(dtype)
        if dtype == torch.float32 and dp_seg is not None:
            one[tag], floor[tag] = dp_seg
            refs[tag] = (DP_DIR, "seg")
            print(f"    {tag}: phase 55's seg runs")
            continue
        refs[tag] = (SP_DIR, tag)
        r = dp_steps("seg", lambda t: t, flips=[], grads=[], dtype=dtype,
                     tag=tag, folder=SP_DIR)
        for key in ("params", "update"):
            np.save(os.path.join(SP_DIR, f"{tag}_{key}.npy"), r.pop(key))
        one[tag] = r
        print(f"    {tag}: losses {r['losses']}, step {r['ms']:.3f} ms, "
              f"peak {r['peak_gib']:.2f} GiB ({card})")
        sw = dp_steps("seg", dp_swapped, replay=True, flips=[], grads=[],
                      dtype=dtype, tag=tag, folder=SP_DIR)
        floor[tag] = dp_errors(sw, tag, r["losses"], SP_DIR)
        print(f"      the swapped batch: errors {floor[tag]}; each ascent's "
              f"gradient error and sign flips {dp_grads(sw)}")
    return one, floor, refs


def sp_check(card, ranks, one, floor):
    """Phases 60 (the 1 x 2 ranks' results against world 1), 61 and 62;
    the windowed kernels' entries of the kernels line (launches per rank
    of the 1 x 2 steps)."""
    d, sp = SP_MESH
    print(f"[60] the same steps on a {d} x {sp} data x spatial mesh: {d * sp} "
          f"gloo ranks on cuda:0, each on its rows of each image (the halo "
          f"rows through host buffers), phase 59's ascents replayed. A "
          f"correctness run: ranks sharing one card are no speed figure")
    parts, window_shapes = {}, {}
    for dtype in SP_DTYPES:
        tag = sp_tag(dtype)
        for r in ranks:
            require(r[tag]["losses"] == ranks[0][tag]["losses"],
                    f"{tag}: the ranks report different global losses")
        errs = {k: max(r[tag]["errors"][k] for r in ranks)
                for k in floor[tag]}
        print(f"    {tag}: losses {ranks[0][tag]['losses']} (world 1 "
              f"{one[tag]['losses']}); errors {errs}; the swapped batch's "
              f"{floor[tag]}")
        for i, r in enumerate(ranks):
            print(f"      rank {i}: step {r[tag]['ms']:.3f} ms, peak "
                  f"{r[tag]['peak_gib']:.2f} GiB, launches "
                  f"{r[tag]['counts']}, window {r[tag]['window']} ({card}); "
                  f"each ascent's gradient error and sign flips "
                  f"{dp_grads(r[tag])}")
        for k, least in DP_MIN_BOUND.items():
            bound = max(DP_FLOOR_FACTOR * floor[tag][k], least)
            require(errs[k] <= bound, f"{tag}: 1 x 2 {k} error {errs[k]} "
                                      f"above {bound}")
        suffix = "_bf16" if dtype == torch.bfloat16 else ""
        fwd, bwd = SP_KERNELS[dtype]
        for name, whole in ((fwd, "resize_ce_forward" + suffix),
                            (bwd, "resize_ce_backward" + suffix)):
            want = one[tag]["counts"][whole]
            for i, r in enumerate(ranks):
                got = r[tag]["counts"]
                require(got[name] == got[whole] == want > 0,
                        f"{tag}: rank {i} launched {got[name]} windowed "
                        f"{whole} of {got[whole]}; world 1 {want}")
        for i, r in enumerate(ranks):
            require(r[tag]["counts"]["pgd_update"]
                    == one[tag]["counts"]["pgd_update"],
                    f"{tag}: rank {i} launched another count of PGD updates")
        err = max(max(r[tag]["errs"]) for r in ranks)
        parts[fwd] = (ranks[0][tag]["counts"][fwd],
                      max(r[tag]["errs"][0] for r in ranks), None)
        parts[bwd] = (ranks[0][tag]["counts"][bwd],
                      max(r[tag]["errs"][1] for r in ranks), None)
        lo_shape, lab_shape, window = ranks[0][tag]["window"]
        window_shapes[dtype] = (lo_shape, lab_shape, window)
        print(f"    {tag}: windowed kernels at the ranks' first sites, "
              f"largest abs error {err:.3e}")

    errs = {}
    sp_kernels_vs_plain(card, errs)
    print(f"[62] the windowed kernels at rank 0's shapes, timed in one "
          f"process ({card})")
    times = sp_kernel_times(card, window_shapes)
    out = {}
    for name, (launches, err, _) in parts.items():
        dtype = torch.bfloat16 if name.endswith("_bf16") else torch.float32
        err = max(err, errs[dtype][int("backward" in name)])
        out[name] = (launches, err, times[name])
    print("    train_segment --num_devices 2 --spatial_shards 2 on this "
          "machine")
    if torch.cuda.device_count() >= 2:
        print(f"    {torch.cuda.device_count()} cards visible: not a "
              f"one-card machine, skipped")
    else:
        try:
            train_segment.main(["--num_devices", "2", "--spatial_shards",
                                "2"])
        except ValueError as e:
            require("--num_devices 2" in str(e), f"the message {e}")
            print(f"    raised: {e}")
        else:
            require(False, "--num_devices 2 --spatial_shards 2 ran on a "
                           "one-card machine")
    return out


def pair_rank(rank, dp_args, sp_args):
    """One rank of the two gloo ranks on cuda:0: phase 56's steps
    (``dp_args``), then phase 60's (``sp_args``), each where given."""
    out = {}
    if dp_args is not None:
        out["dp"] = dp_rank(rank, *dp_args)
    if sp_args is not None:
        out["spatial"] = sp_rank(rank, *sp_args)
    return out


def parallel_phases(card, seconds, with_dp, with_spatial):
    """The data-parallel (55-58) and spatial (59-62) groups, whose ranks
    run in one launch of two gloo ranks on cuda:0; the kernels' parts of
    both."""
    dp_args = sp_args = dp_ref = None
    if with_dp:
        with group_time(seconds, "dp"):
            one, floor, uniforms = dp_world_one(card)
            dp_args = (uniforms, {t: one[t]["losses"] for t in DP_TRAINERS})
            dp_ref = (one, floor)
    if with_spatial:
        with group_time(seconds, "spatial"):
            sp_one, sp_floor, refs = sp_world_one(
                card, dp_ref and (dp_ref[0]["seg"], dp_ref[1]["seg"]))
            sp_args = ({t: sp_one[t]["losses"] for t in sp_one}, refs)
    with group_time(seconds, "ranks"):
        t0 = time.time()
        ranks = launch(pair_rank, DP_RANKS, (dp_args, sp_args),
                       backend="gloo", devices=["cuda:0"] * DP_RANKS,
                       timeout=900, deadline=900)
        print(f"    the ranks of phases {'56' if with_dp else ''}"
              f"{' and ' if with_dp and with_spatial else ''}"
              f"{'60' if with_spatial else ''}: launch and run "
              f"{time.time() - t0:.1f} s")
    parts = {}
    if with_dp:
        with group_time(seconds, "dp"):
            parts.update(dp_check(card, [r["dp"] for r in ranks], *dp_ref))
            gc.collect()
            torch.cuda.empty_cache()
    if with_spatial:
        with group_time(seconds, "spatial"):
            parts.update(sp_check(card, [r["spatial"] for r in ranks],
                                  sp_one, sp_floor))
    return parts


# ---------- recomputation (phases 63-67) ----------

REMAT_DIR = os.path.join("checkpoints", "chip_smoke_remat")
# (label, backbone_remat, remat_tails): the plain step twice, to read the
# run-to-run noise of the step on this card, then each flag and both
REMAT_SEG_CASES = (("plain", False, False), ("plain again", False, False),
                   ("--backbone_remat", True, False),
                   ("--remat_tails", False, True), ("both", True, True))
# the plain step on the batch with its halves swapped (phase 55's floor):
# the same function in another row order
REMAT_SWAPPED = ("swapped batch", False, False)
# (label, share_proposals, remat_tails)
REMAT_DET_CASES = (("shared, plain", True, False),
                   ("shared, plain again", True, False),
                   ("shared, --remat_tails", True, True),
                   ("own samples, plain", False, False),
                   ("own samples, plain again", False, False),
                   ("own samples, --remat_tails", False, True))
REMAT_TURNS = 2


def remat_case(trainer, flags, dtype=torch.float32, dropout=True,
               swapped=False):
    """A case's model, step and batch: phase 8's Cityscapes A-FAN step
    (``dropout`` on or off; the batch's halves ``swapped``) with ``flags`` =
    (backbone_remat, remat_tails), or phase 15's VOC A-FAN step with
    ``flags`` = (share_proposals, remat_tails)."""
    if trainer == "seg":
        model = build_model(SEG_MODEL, 19, 16, dtype,
                            backbone_remat=flags[0])
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.cuda()
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout) and not dropout:
                m.p = 0.0
        cfg = dataclasses.replace(seg_recipe(), remat_tails=flags[1])
        batch = seg_batch(0)
        if swapped:
            batch = tuple(dp_swapped(t) for t in batch)
        return model, seg_step(model, cfg=cfg), batch, cfg
    model = det_model(0)
    cfg = dataclasses.replace(det_recipe(), share_proposals=flags[0],
                              remat_tails=flags[1])
    return model, det_step(model, cfg=cfg), det_batch(0), cfg


def remat_state(model):
    """The trained parameters and the BatchNorm running statistics, flat,
    in float64 on the host."""
    params = [p.detach().double().reshape(-1) for p in model.parameters()
              if p.requires_grad]
    stats = [b.detach().double().reshape(-1)
             for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    return (torch.cat(params).cpu().numpy(),
            torch.cat(stats).cpu().numpy() if stats else np.zeros(0))


def remat_counts():
    """The wrappers' launches since :func:`remat_reset_counts`, f32 and
    bf16 apart (the kernels line's entries), those that ran."""
    c = dp_counts()
    c["pgd_update_bf16"] = kpgd.bf16_launches
    c["pgd_update"] -= kpgd.bf16_launches
    for k in ("resize_ce_forward", "resize_ce_backward"):
        c[k] -= c[f"{k}_bf16"]
    return {k: v for k, v in c.items() if v}


def remat_reset_counts():
    dp_reset_counts()
    kpgd.bf16_launches = 0


def remat_runs(trainer, cases, dtype=torch.float32, probe=None,
               dropout=True):
    """``DP_STEPS`` steps of each case from the same weights, batch and
    seeds (the default generators for the dropout, a CUDA generator for
    the detection samples), deterministic cuDNN, no TF32: losses, peak GiB
    above what was resident before the case's model was built, launches,
    parameters, running statistics and the generator's state after; then
    ``REMAT_TURNS`` rounds of one more step of each case in turns
    (alternating order), host ms with the card synchronized. ``probe``
    keeps the kernels' first inputs of the recomputed cases; ``dropout``
    goes to :func:`remat_case`, and the :data:`REMAT_SWAPPED` case runs on
    the swapped batch."""
    runs = {}
    with deterministic():
        for label, *flags in cases:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            model, step, batch, cfg = remat_case(
                trainer, flags, dtype, dropout,
                swapped=label == REMAT_SWAPPED[0])
            torch.manual_seed(0)
            gen = torch.Generator("cuda").manual_seed(0)
            remat_reset_counts()
            losses = []
            with (dp_probes(probe) if probe is not None and flags[1]
                  else contextlib.nullcontext()):
                for _ in range(DP_STEPS):
                    out = (step(*batch) if trainer == "seg"
                           else step(*batch, gen))
                    losses.append({k: float(v) for k, v in out.items()})
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            params, stats = remat_state(model)
            runs[label] = dict(
                model=model, step=step, batch=batch, gen=gen, cfg=cfg,
                losses=losses, peak=peak, counts=remat_counts(),
                params=params, stats=stats, gen_state=gen.get_state(),
                ms=[])
        timed = [label for label, *_ in cases
                 if "again" not in label and label != REMAT_SWAPPED[0]]
        for turn in range(REMAT_TURNS):
            for label in (timed if turn % 2 == 0 else timed[::-1]):
                r = runs[label]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (r["step"](*r["batch"]) if trainer == "seg"
                 else r["step"](*r["batch"], r["gen"]))
                torch.cuda.synchronize()
                r["ms"].append((time.perf_counter() - t0) * 1e3)
    for r in runs.values():
        del r["model"], r["step"], r["batch"]
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def remat_diffs(r, plain):
    """Largest absolute differences of a run from the plain run: losses,
    trained parameters, running statistics."""
    loss = max(abs(a[k] - b[k]) for a, b in zip(r["losses"], plain["losses"])
               for k in b)
    return {"loss": loss,
            "params": float(np.abs(r["params"] - plain["params"]).max()),
            "stats": (float(np.abs(r["stats"] - plain["stats"]).max())
                      if plain["stats"].size else 0.0)}


def remat_report(card, what, runs, plain, again, expected):
    """Print each case beside the plain step and check it: finite losses,
    the launches ``expected`` gives for its config, the generator's state,
    and each difference from the plain step: 0 where the plain step run
    twice differs by 0, else within twice the swapped-batch run's
    difference (phase 56's bound), or twice the rerun's where there is no
    swapped run. Returns the launches."""
    rerun = remat_diffs(runs[again], runs[plain])
    swapped = (remat_diffs(runs[REMAT_SWAPPED[0]], runs[plain])
               if REMAT_SWAPPED[0] in runs else rerun)
    bound = {k: 0.0 if v == 0 else 2 * max(v, swapped[k])
             for k, v in rerun.items()}
    print(f"    {what}: the plain step twice differs by {rerun} (the "
          f"card's run-to-run noise of this step); on the swapped batch by "
          f"{swapped}; bounds {bound}")
    launches = {}
    for label, r in runs.items():
        require(all(np.isfinite(v) for rec in r["losses"]
                    for v in rec.values()), f"{what} {label}: non-finite loss")
        want = expected(r["cfg"])
        got = r["counts"]
        require(got == want, f"{what} {label}: launches {got}, expected "
                f"{want} in {DP_STEPS} steps")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        d = remat_diffs(r, runs[plain])
        ms = float(np.median(r["ms"])) if r["ms"] else None
        print(f"    {what} {label}: peak {r['peak']:.3f} GiB, step "
              f"{'%.3f ms' % ms if ms is not None else '(not timed)'} "
              f"(median of {len(r['ms'])} in turns), losses "
              f"{[round(x['loss'], 6) for x in r['losses']]}, launches "
              f"{got} in {DP_STEPS} steps; from the plain step: {d} ({card})")
        require(torch.equal(r["gen_state"], runs[plain]["gen_state"]),
                f"{what} {label}: the generator's state differs")
        if label == REMAT_SWAPPED[0]:
            continue
        for k, v in d.items():
            require(v <= bound[k], f"{what} {label}: {k} differs by {v}, "
                    f"above its bound {bound[k]}")
    return launches


def seg_expected_launches(dtype):
    """A seg case's launches in ``DP_STEPS`` steps: every upsample + CE
    site and every update in ``dtype`` (the bf16 model's logits and tap
    features are bf16)."""
    tag = "_bf16" if dtype == torch.bfloat16 else ""

    def expected(cfg):
        sites, pgd = seg_launches_per_step(cfg)
        return {f"resize_ce_forward{tag}": sites * DP_STEPS,
                f"resize_ce_backward{tag}": sites * DP_STEPS,
                f"pgd_update{tag}": pgd * DP_STEPS}
    return expected


def det_expected_launches(cfg):
    nms, pgd = det_launches_per_step(cfg)
    return {"nms": nms * DP_STEPS, "pgd_update": pgd * DP_STEPS}


def remat_seg_phase(card, n, dtype, probe):
    """Phases 63 (f32: dropout off, as phase 55, and a swapped-batch run
    for the bound, since the f32 step is not deterministic: its decoder's
    upsample adds with atomics in the backward) and 64 (bf16: dropout on,
    the step deterministic, so every recomputed case must equal it)."""
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    dropout = dtype == torch.bfloat16
    print(f"[{n}] recomputation: the Cityscapes A-FAN step (DeepLabv3+ "
          f"ResNet-50, OS 16, crop {SEG_CROP}, batch {SEG_BATCH}, dropout "
          f"{'on' if dropout else 'off'}), {name}, deterministic cuDNN: "
          f"plain, --backbone_remat, --remat_tails and both, {DP_STEPS} "
          f"steps each from the same weights and seeds, then timed in "
          f"turns")
    cases = REMAT_SEG_CASES + (() if dropout else (REMAT_SWAPPED,))
    runs = remat_runs("seg", cases, dtype, probe, dropout)
    return remat_report(card, f"seg {name}", runs, "plain", "plain again",
                        seg_expected_launches(dtype))


def remat_det_phase(card, probe):
    print(f"[65] recomputation: the VOC setting-1 A-FAN detection step "
          f"(ResNet-50, batch {DET_BATCH}, 608x1008), deterministic cuDNN: "
          f"plain and --remat_tails, with share_proposals and with each "
          f"forward sampling its own, {DP_STEPS} steps each from the same "
          f"weights and generator, then timed in turns")
    if not os.path.exists(DET_BACKBONE):
        calibrated_backbone()
    launches = {}
    for share in (True, False):
        cases = [c for c in REMAT_DET_CASES if c[1] == share]
        runs = remat_runs("det", cases, probe=probe)
        for k, v in remat_report(card, "det", runs, cases[0][0], cases[1][0],
                                 det_expected_launches).items():
            launches[k] = launches.get(k, 0) + v
    return launches


def remat_cli_phase():
    """Phase 66: both CLIs with the recomputation flags, 2 steps each."""
    print("[66] the CLIs with recomputation: train_segment --backbone_remat "
          "--remat_tails (the Cityscapes recipe) and train_detect "
          "--remat_tails (VOC setting 1), 2 steps each")
    fwd, bwd, pgd = run_segment_cli("afan", ("--backbone_remat",
                                             "--remat_tails"), [])
    per_step, _, eval_nms, _, _ = run_detect_cli("afan", DET_STEPS, "remat",
                                                 ("--remat_tails",))
    return {"resize_ce_forward": fwd, "resize_ce_backward": bwd,
            "pgd_update": pgd + sum(p for _, p in per_step),
            "nms": sum(n for n, _ in per_step) + eval_nms}


def infer_detect_phase():
    """Phase 67: ``infer_detect image`` and ``dir`` on the committed
    fixtures; their detections against ``detect_batch``'s, their PNGs read
    back as the drawing. Returns the NMS launches."""
    from afan_torch.cli import infer_detect
    from afan_torch.utils.imread import read_rgb
    print("[67] infer_detect image and dir (ResNet-50, seeded weights, "
          "600x1000 canvas) on tests/fixtures/torch_images, with neither PIL "
          "nor OpenCV")
    out = os.path.join(REMAT_DIR, "infer")
    shutil.rmtree(out, ignore_errors=True)
    src = os.path.join(out, "in")
    os.makedirs(src)
    names = ("label_500x375.png", "voc_500x375.jpg")       # sorted
    for name in names:
        shutil.copy(os.path.join(DATA_FIXTURES, name), src)
    args = argparse.Namespace(backbone="resnet50", checkpoint=None,
                              image_min_side=MIN_SIDE,
                              image_max_side=MAX_SIDE)
    model, canvas_hw = build_state(args, device="cuda")
    detect_fn = make_detect_fn(model)

    def detections(name, thresh):
        img = read_rgb(os.path.join(src, name)).astype(np.float32) / 255.0
        canvas, scale = preprocess_frame(img, canvas_hw, MIN_SIDE, MAX_SIDE)
        return img, infer_detect.detect_batch(detect_fn, canvas[None],
                                              [scale], thresh)[0]

    # a threshold between the seeded model's 20th and 21st best
    # probabilities on the photograph, so that the drawing has boxes
    probs = sorted(p for _, _, p in detections(names[1], 0.0)[1])
    thresh = (probs[-20] + probs[-21]) / 2 if len(probs) > 20 else 0.0
    want = {name: detections(name, thresh) for name in names}
    got = []
    real = infer_detect.detect_image
    infer_detect.detect_image = lambda *a: got.append(real(*a)) or got[-1]
    knms.launches = 0
    flags = ["--device", "cuda", "-p", repr(thresh)]
    image_png = os.path.join(out, "image.png")
    try:
        infer_detect.main(["image", os.path.join(src, names[1]), image_png]
                          + flags)
        infer_detect.main(["dir", src, os.path.join(out, "dir")] + flags)
    finally:
        infer_detect.detect_image = real
    launches = knms.launches
    written = sorted(os.listdir(os.path.join(out, "dir")))
    require(written == [os.path.splitext(n)[0] + ".png" for n in names],
            f"dir wrote {written}")
    runs = [(names[1], got[0], image_png)] + [
        (n, g, os.path.join(out, "dir", os.path.splitext(n)[0] + ".png"))
        for n, g in zip(names, got[1:])]
    require(len(got) == 3, f"{len(got)} images detected")
    for name, dets_got, path in runs:
        img, dets = want[name]
        require(len(dets_got) == len(dets) and all(
            c1 == c2 and abs(p1 - p2) <= 1e-5
            and np.abs(b1 - b2).max() <= 1e-4 * max(np.abs(b2).max(), 1.0)
            for (b1, c1, p1), (b2, c2, p2) in zip(dets_got, dets)),
            f"{path}: the CLI's detections are not detect_batch's")
        require(np.array_equal(read_rgb(path),
                               infer_detect.draw(img, dets_got)),
                f"{path} does not read back as the drawing")
        print(f"    {path}: {len(dets)} detections above {thresh:.6f}, "
              f"detect_batch's; the PNG reads back as the drawing")
    del model, detect_fn
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def remat_phases(card):
    """Phases 63-67; the kernels' parts (launches, largest error at the
    recomputed paths' inputs; times with the phases that time them)."""
    seg_probe, det_probe = {}, {}
    counts = [remat_seg_phase(card, 63, torch.float32, seg_probe),
              remat_seg_phase(card, 64, torch.bfloat16, {}),
              remat_det_phase(card, det_probe), remat_cli_phase()]
    with deterministic():
        counts.append({"nms": infer_detect_phase()})
    print("    the kernels on the recomputed steps' first inputs against "
          "their plain versions:")
    errs = {**dp_probe_errs(seg_probe, "recomputed step's"),
            **dp_probe_errs(det_probe, "recomputed step's")}
    none = dict(ms=None, plain_ms=None, bound_ms=None, bound_by=None)
    parts = {}
    for c in counts:
        for k, v in c.items():
            launches = parts.get(k, (0, 0.0, none))[0] + v
            parts[k] = (launches, errs.get(k.replace("_bf16", ""), 0.0),
                        none)
    for k in ("nms", "resize_ce_forward", "resize_ce_backward",
              "pgd_update"):
        require(parts.get(k, (0,))[0] > 0, f"no {k} launch on the "
                f"recomputed paths")
    print(f"    launches on phases 63-67: "
          f"{ {k: v[0] for k, v in parts.items()} }")
    return parts


@contextlib.contextmanager
def group_time(seconds, name):
    """The block's wall seconds are added to ``seconds[name]``."""
    t0 = time.time()
    yield
    seconds[name] = round(seconds.get(name, 0.0) + time.time() - t0, 1)


GROUPS = ("nms", "ce", "seg", "det", "cls", "dettrain", "scan", "variants",
          "bf16", "detbf16", "clsbf16", "eval", "mobilenet", "coco", "data",
          "dp", "spatial", "remat")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=GROUPS,
                        help="run only this group's phases (see above)")
    args = parser.parse_args(argv)
    only = args.only
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = f"{name}, power limit {smi.split(',')[-1].strip()}"
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[1] device: {name} (x{torch.cuda.device_count()}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    print(f"    cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # 2. build
    t0 = time.time()
    seconds = kbuild.build_all()
    knms.load_library()
    krce.load_library()
    kpgd.load_library()
    print(f"[2] built {', '.join(f'{s} in {t:.1f} s' for s, t in seconds.items())}"
          f" (one nvcc each, together {time.time() - t0:.1f} s) into "
          f"{os.path.relpath(kbuild.BUILD_DIR, ROOT)}")

    entries, seg_updates, variant, seconds = [], [], None, {}
    if only in (None, "det", "nms"):
        with group_time(seconds, "det"):
            entries.append(detection_phases(card, only == "nms"))
            gc.collect()
            torch.cuda.empty_cache()
    if only in (None, "seg", "ce"):
        with group_time(seconds, "seg"):
            seg_entries, seg_updates = segmentation_phases(card, only == "ce")
            entries += seg_entries
            gc.collect()
            torch.cuda.empty_cache()
    if only in (None, "bf16"):
        with group_time(seconds, "bf16"):
            entries += bf16_phases(card)
            gc.collect()
            torch.cuda.empty_cache()
    if only in (None, "variants"):
        with group_time(seconds, "variants"):
            variant = variant_phases(card, own_pgd_check=only == "variants")
            gc.collect()
            torch.cuda.empty_cache()
    if only in (None, "cls"):
        with group_time(seconds, "cls"):
            entries.append(classification_phases(
                card, seg_updates + (variant["updates"] if variant else [])))
            gc.collect()
            torch.cuda.empty_cache()
    if only in (None, "dettrain"):
        with group_time(seconds, "dettrain"):
            for extra in detection_training_phases(card):
                merge_entry(entries, extra)
            gc.collect()
            torch.cuda.empty_cache()
    if only in (None, "scan"):
        with group_time(seconds, "scan"):
            pgd_entry, dev_parts = epoch_scan_phases(card)
            merge_entry(entries, pgd_entry)
            merge_launches(entries, dev_parts)
            gc.collect()
            torch.cuda.empty_cache()
    if variant:
        merge_variant_launches(entries, variant)
    if only in (None, "detbf16"):
        with group_time(seconds, "detbf16"):
            merge_launches(entries, det_bf16_phases(card))
            gc.collect()
            torch.cuda.empty_cache()
    if only in (None, "clsbf16"):
        with group_time(seconds, "clsbf16"):
            merge_launches(entries, cls_bf16_phases(card))
            gc.collect()
            torch.cuda.empty_cache()
    if only in (None, "eval"):
        with group_time(seconds, "eval"):
            merge_launches(entries, eval_phases(card))
            gc.collect()
            torch.cuda.empty_cache()
    if only in (None, "mobilenet"):
        with group_time(seconds, "mobilenet"):
            merge_launches(entries, mobilenet_phases(
                card, ce_times=only == "mobilenet"))
            gc.collect()
            torch.cuda.empty_cache()
    if only in (None, "coco"):
        with group_time(seconds, "coco"):
            merge_launches(entries, coco_phases(card))
            gc.collect()
            torch.cuda.empty_cache()
    if only in (None, "data"):
        with group_time(seconds, "data"):
            merge_launches(entries, data_phases(card))
            gc.collect()
            torch.cuda.empty_cache()
    if only in (None, "dp", "spatial"):
        merge_launches(entries, parallel_phases(
            card, seconds, only in (None, "dp"), only in (None, "spatial")))
    if only in (None, "remat"):
        with group_time(seconds, "remat"):
            merge_launches(entries, remat_phases(card))

    print(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s "
          f"(seconds by group: {seconds})")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
