#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``oadg_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit, the torch and CUDA versions; turns TF32 off for matmuls and
   convolutions so float32 means float32.
2. build: compiles every CUDA kernel of the serving and training paths
   from ``oadg_tpu_torch/ops/csrc/`` (B1-B7, five sources), one nvcc per
   source, and the port's host library (PNG unfilter, evaluation matchers;
   ``utils/csrc/host_kernels.cpp``) with g++, all at once.
3. kernels: each kernel against its plain PyTorch version, with its times,
   the least time the card could take (the bytes the function must move
   over 3.35 TB/s) and, where one PyTorch call computes the same function,
   that call's times. ``device_ms`` is the time per launch of a run of
   launches that the host enqueued while the device was kept busy, one
   CUDA-event pair around the run (``device_time``); ``host_us`` is the host
   clock per call of the wrapper; kernel and library call are timed in turns
   (kernel, library, library, kernel) over three rounds, the median and the
   rounds' least and largest printed; the time of one launch from an idle
   device, wrapper included, stands beside them. B1 (RoIAlign forward) at the
   serving shapes (one 1024x2048 image: FPN levels 256x512 .. 32x64, C=256,
   1000 rois, the report's case) and at the training step's two calls (4
   images, 2048 sampled and 40 random rois); B2 (RoIAlign backward) at the
   training shapes (4 images, both calls' 2088 rois, the report's case), at
   each of the two calls and at 2048 rois whose positives cluster around 32
   gts; each f32 and bf16, each beside its bound and the bytes its design
   moves; B2 must give equal bits in two calls. B3 (OA-Mix foreground maps, G=16 on
   1024x2048: the seeded gts' blurred profiles, then dense ones; with the
   mean number of live boxes a 16x256 tile, a row and a lane's 8 pixels),
   B4 (row shift: x and column passes at the rotate
   shifts of severity 10 and the translate shifts, on uint8 3-channel and
   float32 4-channel images; library call ``F.grid_sample``), B5 (per-box
   row shift on B3's own ``best_id``: the three passes of a per-box rotate,
   uint8 then float32 3-channel, the column pass on uint8, and the x pass on
   a chain-like image of flat blocks; ``F.grid_sample``), B6 (256-bin
   histograms of a 1024x2048x3 uint8 image: random, then the chain-like
   image and a constant one; ``torch.bincount`` on the random one) and B7
   (merged row shift on the float32 4-channel image with B3's ``best_id`` as
   the composite id: per-box x and column passes, a background pass, the
   identity, three slots with mixed flags, and the per-box x pass on the
   chain-like image; ``F.grid_sample``). B5 and B7 must take their fast
   route (the kernel specialised for these shapes) in every case.
3b. dwd-kernels: B1 and B2 at the DWD config's one level (stride 16) and
   C = 2048, f32 and bf16, each against its plain version, timed and beside
   its bound (``check_fwd_case``, ``check_bwd_case``): B1 at one 64x128x2048
   map (a 1024x2048 test canvas) with R=1000, B2 at 4 maps of 46x80x2048
   (the 736x1280 train canvas) with the step's R = 4 x 512 + 4 x 10; added
   to B1's and B2's rows as cases.
3c. mask-kernels: B1 and B2 at the mask head's 14x14 bins (their second
   instantiation), f32 and bf16, each against its plain version with the
   7x7 cases' ``TOL_*``, timed beside its bound (``roi_fwd_bytes`` /
   ``roi_bwd_bytes`` at 14x14 bins): B1 at a request's R = 100 detections
   on one image's FPN maps and at the mask branch's training call (2
   images, R = 2 x 128 positive slots jittered around seeded gts), B2 at
   that training call. Two report rows of their own, ``roi_align_fwd_14x14``
   and ``roi_align_bwd_14x14``, joined to the others before phase 7g.
4. slice: ``init_detector`` on the flagship config (OA-DG Faster R-CNN
   R50-FPN, Cityscapes, 8 classes) with seeded random weights, once in
   float32 and once with ``dtype=torch.bfloat16`` (the JAX package's bench
   precision: bfloat16 convolutions and FCs, frozen BN folded, float32
   parameters), each with one warm-up request, then 3 timed requests of
   1024x2048 uint8 images through ``DetectorHandle.test``. B1 must have
   launched once per request, entered with maps of the model's dtype. One
   request's RoI head is run again with the plain RoIAlign on the same maps
   and compared.
5. reference: each dtype's seeded model on the CPU (plain PyTorch
   throughout, the path the CPU tests hold to the JAX package) against the
   card on a small 256x512 request: FPN outputs, and the RoI head on the
   card's proposals.
5b. evaluate: the test path (``tools/torch_test.py``'s). 16 synthetic
   Cityscapes-like 1024x2048 RGB PNGs (a smooth texture plus noise, ~3.7 MB
   each) written by the port's own PNG encoder with a COCO json of the 8
   classes; ``CityscapesDataset`` with the flagship's test pipeline through
   ``build_test_loader`` (the config's ``workers_per_gpu`` threads, batches
   in pinned memory); ``single_gpu_test`` with one seeded model per dtype
   (float32, bfloat16), then ``dataset.evaluate(metric="bbox")``. B1 must
   launch once per image on maps of the model's dtype; each image's results
   must equal ``DetectorHandle.test`` on the same image through
   ``prepare_image`` (the same counts, boxes within 1e-3 px, scores within
   1e-4 relative); the ground truth as detections must score AP 1.0; the
   native matcher must give the numpy matcher's 12 numbers on the model's
   results and on jittered ground truth with seeded scores (0 < AP < 1); and
   ``tools/torch_test.py CONFIG none --eval bbox`` on the same dataset, run
   as a subprocess, must exit 0 and print the summary. A timed loop then
   reads the 16 files ``STEADY_REPEATS`` times over (one loader over a
   ``RepeatDataset``, one fill of its threads) and prints images/s from the
   first batch to the last result, the fill (the first batch's request to
   its arrival) apart, each pass's images/s (the spread), and the loader's
   host ms per image split into decode (``LoadImageFromFile``), pipeline
   (``MultiScaleFlipAug``: resize, normalize, pad) and collate, in the loop
   and for one image alone; then the evaluation's ms and the COCO summary.
   After every timed run, one profiled loop per dtype over the first 4 of
   the 16 images (``PROFILE_IMAGES``) gives the device's
   busy share.
5c. robustness: the robustness path on 2 of phase 5b's PNGs. The host ms
   of each of the 19 corruptions (``ops/corruptions.py``, numpy) at severity
   3 on one 1024x2048 image, alone in one thread; then
   ``tools/torch_test_robustness.py CONFIG none --corruptions benchmark
   --severities 0 3`` as a subprocess in float32, counted by
   ``TOOL_PRELUDE``: exit 0, P / mPC / rPC printed, the pickle's 15
   corruptions each at severities 0 and 3, B1 launched 2 x 16 times (the
   clean cell once, 15 corrupted cells) and no other kernel; its sweep's
   images/s. ``tools/torch_get_corrupted_dataset.py`` (in this process,
   ``run_tool``) writes fog and glass_blur at severity 1; through
   ``--load-dataset corrupted`` fog's cell must load the on-the-fly cell's
   images byte for byte and give its detections. One cell run twice must
   load byte-identical images and give equal detections; the second run's
   loader host ms per image, split into decode, corrupt and pipeline.
6. oamix: ``oamix_batch`` with the flagship's ``oamix_config`` on 2 seeded
   1024x2048 uint8 images with 32 seeded gts each, inside
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), once per
   chain: on the slots chain B3-B6 launch exactly as often as the drawn
   table implies and B7 never; on the merged chain B3, B6 and B7 do and B4
   and B5 never; outputs uint8 of the expected shape, boxes inside the
   image. Then, per chain, one table per op index (every slot drawing op k)
   with B3-B7 checked in place against their plain versions; the merged
   chain against the slots chain on one table (differ by at most 1 on at
   most 1e-4 of values); then each chain on the card against the CPU on one
   table at 256x512.
7. train: the flagship built for training (``num_views=2``), SGD with the
   config's LR schedule through ``make_train_step(...,
   preprocess=make_oadg_preprocess(oamix_config, img_norm_cfg,
   out_dtype=model.dtype))``, in float32 and then in bfloat16 (one model
   each): one warm-up step and 3 timed steps on uint8 batches of 2 images
   of 1024x2048 (OA-Mix makes view 2; 32 seeded gts each), first with
   OA-Mix on the slots chain, then the same again on the merged chain
   (``make_oadg_preprocess(..., chain="merged")``). B1 and B2 must each
   launch twice per step, entered with maps of the model's dtype, and B3-B7
   as often as each step's table implies for its chain; losses finite
   float32, ``loss_cont`` > 0, parameters and gradients float32, every
   trainable parameter moved, every frozen one (stem, ``layer1``)
   unchanged. One more step checks B1's RoI features and B2's level
   gradients inside the path against the plain versions on the same inputs.
   After both dtypes' timed steps, one step per dtype and chain under
   ``torch.profiler``: host and device time of each stage's
   ``record_function`` span (OA-Mix included), and the device's busy share;
   then one profiled request per dtype (the device's busy share of a
   request), and a line of step medians, ``max_memory_allocated`` and busy
   shares.
7a. baseline: the plain Faster R-CNN
   (``faster_rcnn_r50_fpn_1x_cityscapes.py``, the flagship's ``_base_``: one
   view, no OA-Mix, the stock losses) through ``make_train_step`` in float32
   and in bfloat16: one warm-up and 3 timed steps on 2 seeded uint8 images of
   1024x2048 (``prepare_image``). B1 and B2 must launch once per step, the
   losses be finite float32, the frozen parameters unchanged and every
   trainable one but the top FPN output's (no anchor reads it) move; step
   medians and ``max_memory_allocated``.
7b. train-loop: the training entry point. 4 synthetic 1024x2048 Cityscapes
   PNGs (``write_cityscapes``) as the train set, the first 4 of phase 5b's
   16 as the val set (``TOOL_VAL_IMAGES``). ``tools/torch_train.py`` on the flagship config as a subprocess, in
   float32: 2 epochs of 2 iterations (``RepeatDataset`` times 1), an
   evaluation after each; a prelude (``TOOL_PRELUDE``) sets the kernel
   wrappers' counts to 0 and records each step's OA-Mix table, and B1-B6
   must launch as the tables and the val set imply (B7 never); ``log.json``
   must hold 8 iterations and 2 evaluations, ``epoch_1.pth`` and
   ``epoch_2.pth`` their epoch and iteration; then ``--resume-from
   epoch_1.pth`` must continue at iteration 5. Then ``train_detector`` in
   this process in bfloat16 for 12 iterations (``RepeatDataset`` times 6),
   the same launch check. Printed beside the card's name and power limit:
   images/s over the steps (the fill apart), the medians of ``time`` and
   ``data_time``, each iteration's, the loader's host ms per image for each
   pipeline stage and the collate (in the loop and for one image alone),
   the checkpoint's save ms, and (after every timed run) the device's busy
   share of one profiled bf16 iteration.
7c. dwd: the DWD OA-DG config (``configs/OA-DG/dwd/faster_rcnn_r101_dc5_1x_dwd_oadg.py``:
   R101-DC5, caffe style, no neck, one 2048-channel level at stride 16, 7
   classes) at full width with seeded weights. dwd-serve: per dtype 3 timed
   requests of a 720x1280 image through the test pipeline (``prepare_batch``,
   1024x1824), the model's share apart, B1 once a request on maps of the
   model's dtype, the RoI head on kernel vs plain RoIAlign features, the
   card against the CPU on a 256x448 request. dwd-train: per dtype the
   OA-DG step (OA-Mix ``augmix.all`` of width 1 on the card, 2 uint8 images
   x 2 views on the 736x1280 canvas): warm-up and 3 timed steps, B1-B6
   launched as the tables imply (B7 never), losses finite, trainable
   parameters moved and frozen ones (stem, ``layer1``, every BN) not, one
   step with B1 and B2 checked in place, the proposals' NMS at
   ``nms_pre=12000`` timed with its peak memory; then OA-Mix alone on the
   DWD canvas with every op forced on each chain, B3-B7 checked in place.
   dwd-eval: 2 synthetic VOC-XML domains of 8 JPEGs of 720x1280 written by
   ``encode_jpeg``; ``decode_jpeg`` of 2 files a domain equals its numpy twin; the
   f32 model over each domain through ``build_test_loader(cfg, domain)``
   (images/s, the loader's decode and pipeline host ms an image, per-domain
   mAP, B1 once an image, ground truth scoring mAP 1.0); then
   ``tools/torch_test_dwd.py CONFIG none`` as a subprocess counted by
   ``TOOL_PRELUDE`` (B1 once an image, no other kernel, ``dwd_results.json``).
7d. yolo: the OA-DG YOLOv3 config (``configs/OA-DG/cityscapes/yolov3_d53_mstrain-1024_20e_oadg.py``:
   Darknet-53 with its BNs in eval mode, ``YOLOV3Neck`` and
   ``YOLOV3HeadCont`` with live BNs, 8 classes) at full width with seeded
   weights. yolo-serve: per dtype a warm-up and 3 timed requests of a
   1024x2048 uint8 image through the test pipeline (``prepare_batch``:
   512x1024) and ``DetectorHandle.test``, the model's share apart, memory;
   the card against the CPU on a 256x512 request: the neck's outputs, the
   head's maps, the detections (f32: 95% of the card's held by the CPU's).
   yolo-train: per dtype the config's batch (8 float32 images x 2 OA-Mix
   views, ``keep_orig=False``, on the 1024x1024 canvas, 32 gts each): a
   warm-up and 3 timed steps on the slots chain, B3-B6 as the drawn tables
   imply, then one step on the merged chain (B3, B6, B7 as implied); the 7
   losses finite float32; the backbone's BN buffers unchanged, the neck's
   and head's all moved, every parameter moved; B3-B7 checked in place on
   the step's table on each chain (f32); one step card vs CPU on 2 images
   x 2 fixed views of 128x128 (f32 losses 1e-3, the head's gradients 1e-3
   of the largest, the neck's and backbone's 1e-2 (the CPU's own f32 step is
   3e-3 from float64 there), the whole gradient's cosine 0.9999; bf16 no
   farther from the f32 CPU step than the bf16 CPU step is). yolo-tools: ``tools/torch_train.py`` on 8 synthetic 1024x2048
   PNGs (1 step of the config's batch, an evaluation on the tools' val
   set, 4 of 5b's PNGs) counted by ``TOOL_PRELUDE``, then in this process
   ``--resume-from epoch_1.pth`` for a second epoch and
   ``tools/torch_test.py`` on the val set; the loader alone
   over the train set: images/s and host ms per stage (``Expand``,
   ``MinIoURandomCrop``, the float ``Resize``, ``PhotoMetricDistortion``)
   and the collate. (Its profiled request and step per dtype, the phase
   ``profile-yolo``, were cut to keep the run inside its limit; the
   flagship's profiled steps read the same stage spans.)
7e. tta: test-time augmentation on 4 of phase 5b's PNGs, per dtype: the
   flagship's test pipeline as ``MultiScaleFlipAug(img_scale=[(2048, 1024),
   (1536, 768)], flip=True)`` (4 views) through ``build_test_loader`` and
   ``single_gpu_test``: B1 once per view (16 launches, counted from 0) on
   maps of the model's dtype; the 4 requests timed alone (upload, 4 views,
   the merge, the NMS, results on the host); a one-view, no-flip TTA equal
   to ``simple_test``; in f32 a 4-view request at 512x256 and 384x192 on the
   card against the same seeded model on the CPU (the same counts, boxes
   within 1e-3 px, scores within 1e-4 relative). Soft-NMS, linear and
   gaussian (``iou_threshold=0.5, min_score=0.05``), on a 1024x2048
   request's 1000 proposals x 8 classes: timed (CUDA events, and the
   host's enqueue of the call) with its memory peak inside
   ``set_sync_debug_mode("error")``, against the CPU
   (the same kept set, within 1e-4), and the config's route through
   ``DetectorHandle.test``; ``async_inference_detector`` against
   ``inference_detector`` on the 4 images; one flip TTA request of the
   YOLOv3 config. After every timed run each soft-NMS call profiled: its
   device kernels, the device's busy ms and the call's wall ms.
7f. engine: a seeded flagship written as a published mmdet ``.pth``
   (``num_batches_tracked`` per BN, ``meta``, ``optimizer``);
   ``init_detector`` of it takes every model tensor, skips the counters and
   serves the source model's detections bit for bit. ``tools/torch_train.py``
   from it (``load_from``) as a subprocess counted by ``TOOL_PRELUDE``:
   AdamW (lr 1e-4, weight decay 0.05), ``CosineAnnealing`` with exp warmup,
   ``ProfilerHook`` (the third step), ``FeatureHook``, ``SyncNormHook`` and
   ``SetEpochInfoHook``; 3 epochs of one step on 2 of phase 5b's PNGs: exit
   0, the logged LR equal at each iteration to the schedule in closed form
   (the cosine by epoch from 1e-4 to 1e-6 times the exp warmup 0.1 ** (1 -
   t / 2) for t < 2), B1-B6 as the tables imply,
   the Chrome trace naming B1's and B2's kernels, every trainable parameter
   moved and every frozen one not; the AdamW step's ms.
7g. mask: the Cityscapes Mask R-CNN (``configs/cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py``:
   R50-FPN, 8 classes, ``FCNMaskHead`` with 4 convs of 256 channels) at full
   width with seeded weights, its train pipeline loading and collecting
   masks (``mask_cfg``). mask-serve: per dtype a warm-up and 3 timed
   1024x2048 requests through ``DetectorHandle.test`` (dets, labels, valid
   and (1, 100, 28, 28) mask probabilities), B1 once at 7x7 and once at
   14x14 a request, one more request with both calls held to the plain
   version in place, the host's ``paste_masks`` of the valid detections
   timed. mask-train: per dtype a warm-up and 3 timed steps
   (``make_train_step``, no OA-Mix) on 2 of phase 5b's PNGs with 6-10
   polygon instances each through the train pipeline (the collate's
   (2, 128, 56, 56) masks): B1 and B2 each once at 7x7 and once at 14x14 a
   step, losses finite float32 with ``loss_mask`` > 0, frozen parameters
   unchanged and the mask head's all moved, one more step with every B1
   and B2 call held to the plain versions in place. mask-tools:
   ``train_detector`` (f32) for 2 steps over 4 of the PNGs with polygons,
   then its evaluation on them (COCO ``bbox``), ``loss_mask`` logged, the
   checkpoint holding the mask head, B1 and B2 at both bin counts as the
   steps and val images imply. Each run's counts are set to 0 just before
   it (``zero_roi_counts``) and read just after; its 14x14 launches go to
   the ``_14x14`` rows, its 7x7 ones to B1's and B2's. After every timed
   run, one profiled request and one profiled step per dtype give the busy
   shares, the step's stages and its ``forward_train: mask branch`` span.
8. dist: data parallel on the card, one card: world 1 over NCCL, the
   group joined in this process through ``parallel.init_distributed`` from
   torchrun's environment (``MASTER_ADDR=127.0.0.1``, a free port). (a) Per
   dtype the flagship's OA-DG step (OA-Mix on the slots chain) from phase
   7's start (seeded weights, generator seed 0, ``raw_train_batch`` of
   ``RandomState(3)``): a warm-up and 3 timed steps without a group, then
   the same through the distributed step (gathered contrastive rows,
   all-reduced normalizers and logged values, the gradient summed in the
   ``train_step: allreduce`` span); every logged value and every parameter
   and buffer bit-equal; B1-B6 counted over the distributed run against the
   tables (``launches_dist``, ``launches_dist_bf16``, added to
   ``launches``); both step medians; after every timed run, one profiled
   distributed step per dtype: the all-reduce span's host and device ms.
   (b) The OA-DG YOLOv3 step (2 x 2 fixed views of 256x256) without and
   with the group (SyncBN's arithmetic) within phase 7d's card limits. (c)
   ``tools/torch_dist_train.sh FLAGSHIP 1`` (``--launcher pytorch``) for
   one epoch of 1 step on 2 of phase 7b's PNGs with an evaluation on the
   first ``DIST_VAL_IMAGES`` = 2 of the tools' val set, then
   ``tools/torch_dist_test.sh`` of its checkpoint over them,
   whose pickle must equal ``single_gpu_test``'s in this process; a script
   that exits non-zero fails the phase.
8b. longtail: the long tail's first eight configs, each at its config's
   full width with seeded weights (the classifier drawn wider so that
   detections pass ``score_thr``), per dtype: GIoU Faster R-CNN
   (``configs/faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py``, standing in
   for the IoU family), RetinaNet, the caffe-C4 Faster R-CNN, X101-32x4d
   and the DCNv2 R50 (``LONGTAIL``): one request through the config's test
   pipeline (COCO 800x1333, Cityscapes 1024x2048; RetinaNet's
   ``multiclass_nms`` recorded: candidates, those above ``score_thr``, the
   tiles run, its peak), the f32 model against the CPU on a 256x384
   request, and two training steps on ``samples_per_gpu`` images (B1 and B2
   once a step; C4's at 14x14 on one level at C = 1024, held to the plain
   versions in place on a third step; the IoU family held, on the GIoU
   step's decoded boxes, to the CPU's values), each with the counts set to
   0 just before it and read just after, peaks printed (DCN's backward
   keeps its gathered taps). Then the NMS sizes: RetinaNet's
   ``multiclass_nms`` over 5 x 1000 x 80 = 400,000 seeded candidates
   (~20,000 above ``score_thr``) against the CPU's, and YOLOv3's 24,000
   and DWD's 12,000 candidates resolved in one tile (the NMS before the
   tiling) and in 256-box tiles: equal keep sets, times and peaks.
8c. twostage: the two-stage family's seven configs (``TWOSTAGE``: Cascade
   R-CNN, HTC, SCNet, Dynamic R-CNN, Double-Head, Mask Scoring R-CNN, PISA
   Faster R-CNN), each at its config's full width with seeded weights (each
   stage's classifier drawn wider), 80 classes as published; HTC, SCNet
   and MS R-CNN with mmdet's 14x14 mask RoI layer, which their configs
   lack, and the Double-Head config with ``schedule_1x``, which it lacks
   (``twostage_cfg``); per dtype ``longtail_serve`` (a 1024x2048 request,
   the f32 model against the CPU on a 256x384 request) and
   ``longtail_train`` (two steps on one 1024x2048 image with seeded gts,
   box-cropped gt masks from polygons for the three mask configs), each
   with B1's and B2's counts set to 0 just before it and read just after,
   by (bins, levels) as ``path_launches`` implies: a cascade's 7x7 once
   a box stage, the mask stages' 14x14 on the pyramid, HTC's and SCNet's
   14x14 on the semantic level; one more HTC step a dtype with every B1 and
   B2 call held to the plain versions in place.
8d. twostage2: the two-stage family's last four configs (``TWOSTAGE2``:
   Sparse R-CNN, QueryInst, Grid R-CNN, PointRend), each at its config's
   full width with seeded weights (each stage's classifier drawn wider), 80
   classes as published, PointRend with mmdet's 14x14 mask RoI layer, which
   its config lacks (``twostage_cfg``); per dtype ``longtail_serve`` (a
   1024x2048 request, the f32 model against the CPU on a 256x384 request)
   and ``longtail_train`` (two steps on one 1024x2048 image with seeded
   gts, polygon gt masks for PointRend), each with B1's and B2's counts set
   to 0 just before it and read just after, by (bins, levels) as
   ``path_launches`` implies: Sparse R-CNN's 7x7 six times (a stage), Grid
   R-CNN's 7x7 and its grid branch's 14x14, PointRend's 7x7 and its mask
   branch's 14x14 (a request's masks too); one more Sparse and Grid step a
   dtype with every B1 and B2 call held to the plain versions in place.
8e. onestage: the one-stage family's twenty-five configs (``ONESTAGE``:
   FCOS, ATSS, GFL, VFNet, TOOD, PAA, AutoAssign, FoveaBox, FSAF,
   FreeAnchor, PISA-RetinaNet, LD with its R50-FPN GFL teacher,
   GA-RetinaNet, SABL-RetinaNet, NAS-FPN, NAS-FCOS with its neck's
   ``start_level`` at 1, ``ONESTAGE_OPTIONS``: the config as given is
   refused, RepPoints, CenterNet on R18 with the Cityscapes base's data
   and the Cityscapes config's warm-up, which its config lacks, CornerNet
   and CentripetalNet on the two-stack Hourglass-104, YOLOF, YOLOX-S,
   SSD300, SOLO and YOLACT, ``FIFTH``: YOLOX's and SSD's configs take the
   Cityscapes base's data and warm-up too, SSD's pipelines resized to its
   fixed 300x300 with ``keep_ratio=False``, ``SSD_OPTIONS``, and its
   requests and steps on the unpadded 300x300 image; SOLO's and YOLACT's
   steps take polygon gt masks, and their requests give their own outputs,
   SOLO's masks held to the CPU's but at pixels within 1e-5 of
   ``mask_thr``), each at
   its config's full width with seeded weights, 80 classes as published, on the Cityscapes
   base's 1024x2048 canvas; the classifier bias moved to the 0.01 prior
   plus N(0, 1.5) a class (``widen_classifier``: the JAX heads start it at
   0, where every one of the 5 x 1000 x 80 candidates would pass
   ``score_thr``); per dtype ``longtail_serve`` (a request, its
   ``multiclass_nms`` recorded, the f32 model of one or two configs a slice,
   ``ONESTAGE_CPU_CHECKED``, against the CPU on a 256x384 request) and
   ``longtail_train`` (two steps on one image with seeded
   gts from mmdet's classifier prior, every loss finite float32), each
   with B1's and B2's counts set to 0
   just before it and read just after: none of these paths launches them.
   LD's teacher forward is timed after its steps and logged as a share of
   the second step; FreeAnchor's step peak must stay within
   ``BAG_PEAK_GIB`` of PISA-RetinaNet's (the same 392,832 anchors and no
   bags), per dtype: a (G, N, C) ``box_prob`` would not. NAS-FPN's neck
   forward (56 merging cells) is timed after its steps and logged, and so
   is the Hourglass's forward (CornerNet and CentripetalNet). CenterNet,
   CornerNet and CentripetalNet decode without NMS (a top 100, none
   recorded); their heatmaps start at mmdet's 0.1 prior, RepPoints' classes
   at 0.01.
8f. transformer: DETR, Deformable DETR (ChannelMapper's 3 levels, the
   multi-scale deformable attention on ``F.grid_sample``) and PanopticFPN
   (``TRANSFORMER``) at their configs' full width with seeded weights on
   the Cityscapes base's 1024x2048 canvas (DETR's config names no data:
   the base's, ``DATA_BASE``), per dtype ``longtail_serve`` (the f32 model
   against the CPU on a 256x384 request, PanopticFPN's stuff probabilities
   within 1e-4) and ``longtail_train`` (a warm-up and two steps on one
   image; DETR with its config's AdamW, Deformable DETR's classifiers at
   the 0.01 prior; every loss finite float32; the backbone's frozen
   tensors unchanged). PanopticFPN trains with mmdet's 14x14 mask RoI
   layer (its config names none and cannot train as given) on the image,
   box-cropped thing masks and label map that ``LoadPanopticAnnotations``
   reads from a 2-image ``CocoPanopticDataset`` written here
   (``write_panoptic``). B1's and B2's counts are set to 0 just before
   each request and step pair and read just after: none in the DETRs',
   PanopticFPN's as ``path_launches`` says; its third step and its warm-up
   request hold every B1 and B2 call to the plain versions in place.
   QueryInst (Sparse R-CNN's model): one f32 request. ``TridentResNet``
   (its detector is refused): one 1024x2048 forward per dtype in train mode
   (3 x 2048 x 32 x 64) and in test mode, shapes and finite values.
8g. backbones: the convolutional backbones and necks of A.2.9a
   (``BACKBONE_CONFIGS``): the Faster R-CNNs on RegNetX-3.2GF, Res2Net-101,
   ResNeSt-50 (JAX's bottleneck widths), R50 with FPN-CARAFE and R50 with
   FPG (9 stacks, 77 live BNs), and YOLOv3 on MobileNetV2 (live BNs), each
   as published with seeded weights, per dtype: ``longtail_serve`` (a
   1024x2048 request through the config's test pipeline, YOLOv3's resized
   to 208x416; the f32 model against the CPU on a 256x384 request, the
   Faster R-CNNs' neck and RPN maps within ``TOL_HEAD`` and their RoI heads
   on the card's proposals, ``shared_proposal_test``: FPG's 77 BNs at their
   seeded statistics leave its RPN scores so close together that the
   ranking of the 100 proposals kept on the CPU moves with any rounding,
   and 9 of the card's 100 detections were not the CPU's) and
   ``longtail_train`` (a warm-up and two timed steps: one 1024x2048 image a
   step for the Faster R-CNNs, 8 images on YOLOv3's largest train canvas,
   416x416), every loss finite float32; the backbone's frozen tensors still
   and the stems that JAX's ``frozen_mask`` leaves trainable moved
   (RegNet's ``conv1`` and ``bn1``; ResNeSt's second and third stem BNs;
   Res2Net's get no gradient through the JAX Res2Net's ``stop_gradient``
   and must stay), every live BN's statistics moved (MobileNetV2's whole
   model, FPG's neck). B1 and B2 counted around each request and step
   pair: one B1 a request and one B1 and B2 a step in the Faster R-CNNs,
   none in YOLOv3; their third step and their warm-up request hold every
   call to the plain versions in place. Then CARAFE's P3-to-P2 reassembly at
   1024x2048 alone, forward and backward, its peak above its inputs. After
   every timed run, one f32 step a config under torch.profiler
   (``profile-backbones``, ~36 s) gives the device's busy share.
9. train reference: per dtype, one step of the same seeded model on the
   CPU and on the card, 2 x 2 fixed views of 256x512 (no OA-Mix), the draws
   made on the CPU and handed to both, the card's proposals used on both:
   losses, and the gradients of ``rpn_head.rpn_conv``,
   ``roi_head.bbox_head.fc_cls`` and ``backbone.layer4.*.conv3``; then the
   same for the plain Faster R-CNN on 2 images of one view.
10. profiled: the times that need ``torch.profiler`` (the plain versions
   of B1 and B2, on float32 and on bfloat16 maps, and ``torch.bincount`` wait for the device inside a call, so
   a run of them cannot be queued ahead: their device time is the sum of
   their kernels' durations). Last, because the profiler's tracing stays
   attached to the process and slows every later launch on the host. The
   profiler at times loses a session's device records (all of them in one
   session of an earlier run, 131 of 400 in another): a session whose
   kernel, copy and memset records fall short of the host's launch, copy
   and memset calls (``profile_census``) by more than 5% is made again, up
   to three times, and the most complete one is kept, any shortfall logged.
11. a JSON line of the kernels (``launches``: the training step's, B1's
   test loop's and robustness sweep's, the baseline step's, the f32
   training loop's, the DWD f32 step's, requests' and test loop's, and the
   YOLOv3 f32 step's, B1's f32 TTA loop's, the AdamW run's and the f32
   distributed steps'; each path's
   count beside it, ``launches_robustness``, ``launches_dwd_step``,
   ``launches_baseline_step``, ``launches_train_loop``,
   ``launches_train_loop_bf16``, ``launches_yolo``, ``launches_yolo_bf16``,
   ``launches_tta``, ``launches_tta_bf16``, ``launches_engine``,
   ``launches_dist``, ``launches_dist_bf16`` and the long tail's
   ``launches_longtail_<family>`` (and ``_bf16``)
   included; the ``_c4`` rows' ``launches`` are phase 8b's C4 runs, the
   ``_sem`` rows' phase 8c's HTC and SCNet steps (``launches_twostage_<family>``
   and ``_bf16`` on every row they reach; phase 8d's
   ``launches_twostage2_<family>`` likewise), the ``_14x14`` rows'
   ``launches`` are phase 7g's, 8c's and 8d's, each run's
   beside it, ``launches_mask_serve``, ``launches_mask_train`` (and their
   ``_bf16``) and ``launches_mask_tools``, which B1's and B2's rows carry
   too for their 7x7 launches on that path), the card's
   ``nvidia-smi`` line, and last the result line ``{"ok": true, "device":
   {...}}``.

3d. c4-kernels: B1 and B2 at the C4 config's 14x14 bins on one level
   (stride 16) at C = 1024, f32 and bf16, against their plain versions,
   timed beside their bounds: B1 at a request (one 50x84 map, R = 1000
   proposals), B2 at the step (2 maps, R = 2 x 512): the report rows
   ``roi_align_fwd_c4`` and ``roi_align_bwd_c4``, joined before phase 8b.
3f. sparse-kernels: B1 and B2 at Sparse R-CNN's stage (7x7 bins on one
   1024x2048 image's four FPN maps, R = 100 learned proposals), f32 and
   bf16, against their plain versions, timed beside their bounds; added to
   B1's and B2's rows as cases (launched six times a request and 6 + 6 a
   step, the most-launched RoIAlign shape of any config).
3e. sem-kernels: B1 and B2 at HTC's semantic RoIAlign (14x14 bins on the
   one stride-8 embedding of a 1024x2048 image, a 128x256 map of 256
   channels, R = 128 mask slots), f32 and bf16, against their plain
   versions, timed beside their bounds: the report rows
   ``roi_align_fwd_sem`` and ``roi_align_bwd_sem``, joined before phase 8c.

Each phase's wall seconds are logged as it ends (``[time]`` lines) and
all of them with the script's total before the kernels' JSON line.

``python3 chip_smoke.py --kernels-only`` runs phases 1-3f and 10 and prints the
kernels' JSON line and no result line: for work on one kernel.
``python3 chip_smoke.py --only longtail`` runs phases 1, 2, 3, 3d and 8b
and prints the kernels' JSON line and no result line;
``python3 chip_smoke.py --only twostage`` runs phases 1, 2, 3, 3c, 3e, 8c
and the semantic rows' plain times, the same way;
``python3 chip_smoke.py --only twostage2`` runs phases 1, 2, 3, 3c, 3f, 8d
and the Sparse cases' plain times, the same way;
``python3 chip_smoke.py --only onestage`` runs phases 1, 2, 3 and 8e the
same way; ``python3 chip_smoke.py --only transformer`` phases 1, 2, 3, 3c and
``transformer`` (DETR, Deformable DETR and PanopticFPN); ``python3
chip_smoke.py --only backbones`` phases 1, 2, 3, ``backbones`` and
``profile-backbones``.

The script imports nothing of JAX and nothing of the JAX package.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "configs/OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes_oadg.py"
IMG_H, IMG_W = 1024, 2048
STRIDES = (4, 8, 16, 32)
CHANNELS = 256
NUM_ROIS = 1000
TRAIN_IMAGES = 4            # 2 images x 2 views
TRAIN_ROIS = 512            # rcnn sampler num, per image
RANDOM_ROIS = 10            # oagrb random proposals, per image
NUM_GTS = 32
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
CITYSCAPES_TRAIN_IMAGES = 2975
# Kernel vs plain version, measured in this run (max abs error over the
# largest magnitude of the result: feature for B1, gradient for B2):
# float32 taps and weights are bit-identical, so only the sum order differs
# (the kernels contract separably, the plain versions tap by tap; B2 sums in
# a fixed order, so its bits repeat from call to call); bfloat16 features
# are widened to f32 before any arithmetic, and B2's bfloat16 gradient is
# the rounding of its f32 sum, so it may sit one bfloat16 step (2**-8
# relative) from the rounding of the plain sum.
TOL_F32 = 1e-5
TOL_BF16 = 1e-4
# RoI head on kernel vs plain RoIAlign features, and the card vs the CPU,
# relative to the largest output magnitude (cuDNN, cuBLAS and the CPU sum
# convolutions and FC layers over up to 12544 inputs in other orders).
TOL_HEAD = 1e-4
# The same with bfloat16 FCs: the kernel's and the plain version's float32
# features differ in their last bits, which moves a bfloat16 input or output
# by one step (2**-8 relative) where it lands on a rounding boundary.
TOL_HEAD_BF16 = 2 ** -6
# bfloat16 on the card against bfloat16 on the CPU, relative to the largest
# magnitude: cuDNN / cuBLAS and the CPU sum in float32 in other orders and
# round once; a value one step apart travels through the following layers.
# Losses (same proposals and draws on both) 2**-6 relative.
TOL_BF16_CARD = 2 ** -4
TOL_BF16_LOSS = 2 ** -6
# B4 and B5 vs their plain versions, absolute on values up to 255: the
# kernels fuse the lerp's multiply-add (one rounding), the plain versions
# emulate it in float64 and round a float32 tie a second time, at most one
# float32 ulp (1.5e-5 at 255).
TOL_WARP = 1e-4


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def idle_launch_ms(fn, iters=20):
    """One launch from an idle device, wrapper included: the median
    CUDA-event time of single calls of ``fn(i)``, each started after a
    synchronise. The start event completes at once on the idle device, so
    this is the wrapper's host time to reach the launch plus the kernel; it
    is kept beside ``device_ms`` for comparison with earlier records."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    times = []
    for i in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class HostBound(RuntimeError):
    """The host did not enqueue a run of launches before the device began
    it, so the run's elapsed time would be the host's."""


_SPIN = {}


def _spin(ms):
    """Keeps the device busy for about ``ms`` on the current stream."""
    import torch
    if "cycles_per_ms" not in _SPIN:
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SPIN["cycles_per_ms"] = 20_000_000 / start.elapsed_time(end)
    torch.cuda._sleep(int(ms * _SPIN["cycles_per_ms"]))


def _queued_run(fn, n, ring, head_ms):
    """``n`` calls ``fn(i)`` enqueued while the device spins for
    ``head_ms``, one event pair around them. -> (device ms per call, median
    host us per call, whether every call was enqueued before the device
    reached the first). The last ``ring`` results stay alive, so that the
    allocator hands out ``ring`` output buffers in turn."""
    import torch
    kept = [None] * ring
    host = []
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _spin(head_ms)
    start.record()
    for i in range(n):
        t0 = time.perf_counter()
        kept[i % ring] = fn(i)
        host.append(time.perf_counter() - t0)
    ahead = not start.query()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, statistics.median(host) * 1e6, ahead


PROFILE_ATTEMPTS = 3
PROFILE_SHORTFALL = 0.05    # of a session's device calls: more lost records and it is made again


def _profiled_run(fn, n, ring):
    """The device time per call as the sum of the durations of every kernel
    and copy ``torch.profiler`` saw in ``n`` calls, for a call that
    synchronises inside and so cannot be queued ahead. The profiler loses
    device records at times (PERF.md 7): a session whose kernel, copy and
    memset records fall short of the host calls that make one
    (``profile_census``) by more than ``PROFILE_SHORTFALL`` of them is made
    again, up to ``PROFILE_ATTEMPTS`` sessions; the most complete one is
    kept and any shortfall logged. It raises if that one saw no device
    time. -> (device ms per call, median host us per call, synchronises
    included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    best = None
    for attempt in range(PROFILE_ATTEMPTS):
        kept = [None] * ring
        host = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                t0 = time.perf_counter()
                kept[i % ring] = fn(i)
                host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        census = profile_census(prof)
        lost = census["device_calls"] - census["device_records"]
        if best is None or lost < best[0]:
            best = (lost, census, host)
        if lost <= PROFILE_SHORTFALL * census["device_calls"] and census["device_us"] > 0:
            break
        log("profiled", f"session {attempt + 1} of {PROFILE_ATTEMPTS} lost {lost} device "
                        f"records: {json.dumps(census)}")
    lost, census, host = best
    if not census["device_us"] > 0:
        raise RuntimeError(f"torch.profiler saw no device time in {PROFILE_ATTEMPTS} sessions")
    if lost > 0:
        log("profiled", f"kept a session {lost} of {census['device_calls']} device records "
                        "short (its time is low by theirs)")
    return census["device_us"] / 1e3 / n, statistics.median(host) * 1e6


# host calls that each put one record on the device's timeline (kernel,
# copy, memset)
DEVICE_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync", "cudaMemset")


def profile_census(prof):
    """What a profiler session recorded: the device time of the CUDA-typed
    entries (``device_us``) and what the CPU ops carry of it, the device
    records (kernels, copies, memsets) against the host calls that make one
    (``DEVICE_CALLS``), kineto's raw events by device type, and every
    CUDA API call's count."""
    import collections
    from torch.autograd import DeviceType
    events = prof.events()
    records = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    api = collections.Counter(e.name for e in events if e.device_type == DeviceType.CPU
                              and e.name.startswith("cu"))
    averages = prof.key_averages()
    return {
        "device_us": sum(e.self_device_time_total for e in averages
                         if e.device_type == DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)),
        "cpu_ops_device_us": sum(e.self_device_time_total for e in averages
                                 if e.device_type == DeviceType.CPU),
        "device_records": len(records),
        "device_calls": sum(api[k] for k in DEVICE_CALLS),
        "kineto_events": dict(collections.Counter(
            str(e.device_type()).split(".")[-1] for e in prof.profiler.kineto_results.events())),
        "api_calls": dict(api)}


def device_time(fn, n, ring=3, method=None):
    """``fn``'s time per call with the device never idle between calls. ->
    {"device_ms", "host_us", "timer"}.

    ``timer`` "events": ``n`` calls are enqueued behind a head start (the
    device spins meanwhile) that is 1.5 times what the host took to enqueue
    a first run of ``n``, and one CUDA-event pair around them is divided by
    ``n``. The run counts only if the start event had not completed when the
    last call was enqueued: then the device found every launch waiting and
    the time is its own, whatever the host's speed. A run that fails this is
    made again with the head doubled and half the calls (a plain version of
    hundreds of small kernels fills CUDA's launch queue, and the host
    then waits for the device), four times before it is refused
    (``HostBound``). ``timer`` "profiler" (asked
    for with ``method``, for a call that synchronises inside): the sum of
    the kernels' own durations from ``torch.profiler``. ``host_us`` is the
    median host-clock time of one call (enqueue only, no synchronise)."""
    import torch
    fn(0)
    if method == "profiler":
        ms, host_us = _profiled_run(fn, n, ring)
        return {"device_ms": ms, "host_us": host_us, "timer": "profiler"}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kept = [None] * ring
    for i in range(n):
        kept[i % ring] = fn(i)
    head_ms = 1.0 + 1.5e3 * (time.perf_counter() - t0)
    del kept
    for _ in range(5):
        ms, host_us, ahead = _queued_run(fn, n, ring, head_ms)
        if ahead:
            return {"device_ms": ms, "host_us": host_us, "timer": "events"}
        head_ms, n = head_ms * 2, max(1, n // 2)
    raise HostBound(f"not even {n} calls were enqueued within a head start of "
                    f"{head_ms / 2:.1f} ms: the call synchronises or the host stalls")


TIMER_ROUNDS = 3


def in_turns(fns, n, ring=3):
    """Times the candidates ``fns`` (name -> ``fn(i)``) in turns: each of
    ``TIMER_ROUNDS`` rounds runs them a, b, b, a (``device_time`` each) and
    reads each candidate as the mean of its two runs. -> name ->
    {"device_ms": median of the rounds, "spread": [min, max] of the rounds,
    "host_us": median of the rounds, "timer"}."""
    names = list(fns)
    rounds = {k: [] for k in names}
    for _ in range(TIMER_ROUNDS):
        got = {k: [] for k in names}
        for k in names + names[::-1]:
            got[k].append(device_time(fns[k], n, ring))
        for k in names:
            rounds[k].append({key: statistics.mean(g[key] for g in got[k])
                              for key in ("device_ms", "host_us")} | {"timer": got[k][0]["timer"]})
    out = {}
    for k in names:
        ms = [r["device_ms"] for r in rounds[k]]
        out[k] = {"device_ms": statistics.median(ms), "spread": [min(ms), max(ms)],
                  "host_us": statistics.median(r["host_us"] for r in rounds[k]),
                  "timer": rounds[k][0]["timer"]}
    return out


def time_kernel(kernel, plain, library=None, n=50, plain_n=5, ring=3):
    """The numbers of one case: the kernel and, where there is one, the
    library call in turns (``in_turns``), the plain version by the same
    timer in a run of its own, and the single-launch time of kernel and
    library call. All take the iteration index, to rotate their inputs.
    ``plain`` and ``library`` are None where the call cannot be queued ahead
    of the device: ``phase_profiled`` times those after the path. -> the
    row's timing keys."""
    fns = {"kernel": kernel}
    if library is not None:
        fns["library"] = library
    got = in_turns(fns, n, ring)
    k = got["kernel"]
    out = {"ms": k["device_ms"], "device_ms": k["device_ms"], "host_us": k["host_us"],
           "spread": k["spread"], "timer": k["timer"],
           "idle_launch_ms": idle_launch_ms(kernel),
           "plain_ms": device_time(plain, plain_n, ring)["device_ms"] if plain else None,
           "library_ms": None, "library_host_us": None, "library_spread": None,
           "library_timer": None, "library_idle_launch_ms": None}
    if library is not None:
        lib = got["library"]
        out.update(library_ms=lib["device_ms"], library_host_us=lib["host_us"],
                   library_spread=lib["spread"], library_timer=lib["timer"],
                   library_idle_launch_ms=idle_launch_ms(library))
    return out


def timing_text(t, library_name=None):
    """One case's timing keys as a log fragment."""
    text = (f"kernel device {t['device_ms']:.4f} ms (rounds {t['spread'][0]:.4f}-"
            f"{t['spread'][1]:.4f}, timer {t['timer']}), host {t['host_us']:.1f} us a call, "
            f"one launch from an idle device, wrapper included, {t['idle_launch_ms']:.4f} ms")
    if t["plain_ms"] is not None:
        text += f"; plain {t['plain_ms']:.4f} ms"
    if t["library_ms"] is not None:
        text += (f"; {library_name} device {t['library_ms']:.4f} ms (rounds "
                 f"{t['library_spread'][0]:.4f}-{t['library_spread'][1]:.4f}, timer "
                 f"{t['library_timer']}), host {t['library_host_us']:.1f} us, one launch "
                 f"from an idle device {t['library_idle_launch_ms']:.4f} ms")
    return text


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card")
    log("device", f"nvidia-smi: {nvidia_smi_line()}")
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from oadg_tpu_torch.ops import fg_maps, hist, warp
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
    libs = [ROI_ALIGN_FWD.library, ROI_ALIGN_BWD.library, fg_maps.FG_MAPS.library,
            warp.SHEAR_ROWS.library, hist.HIST256.library]
    from oadg_tpu_torch.utils import host_kernels as native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs) + 1) as pool:     # one nvcc each, g++, all at once
        host = pool.submit(native.build)
        built = list(pool.map(lambda lib: lib.build(), libs))
        host_so = host.result()
    log("build", f"{len(built)} libraries in {time.perf_counter() - t0:.2f} s "
                 "(one nvcc each, in parallel)")
    native.load()
    log("build", f"{native.SOURCE.relative_to(ROOT)} -> {host_so.name} "
                 f"(g++ {' '.join(native.CXX_FLAGS)})")
    for lib, so in zip(libs, built):
        log("build", f"{lib.source.relative_to(ROOT)} -> {so.name}")
        spills = 0
        for line in lib.build_log.splitlines():
            if "Compiling entry function" in line:
                log("build", f"ptxas: {line.strip().split('Compiling entry function ')[1]}")
            if "registers" in line or "spill" in line:
                log("build", f"ptxas:   {line.strip()}")
            if "spill" in line:
                spills += sum(int(tok) for tok, nxt in zip(line.split(), line.split()[1:])
                              if tok.isdigit() and nxt == "bytes")
        log("build", f"{lib.source.name}: {spills} bytes of stack, spill stores and spill "
                     "loads in all its kernels")
        lib.load()


def flagship_rois(rng, num=NUM_ROIS, image=0, img_h=IMG_H, img_w=IMG_W):
    """``num`` seeded rois on one image of img_h x img_w (1024x2048 unless
    told): ordinary boxes of log-uniform size plus edge, out-of-range,
    extreme-aspect, tiny and zero (padded) boxes (a tenth), covering every
    level."""
    n_special = num // 10 // 5 * 5
    n = num - n_special
    w = np.exp(rng.uniform(np.log(4), np.log(1500 * img_w / IMG_W), n))
    h = np.exp(rng.uniform(np.log(4), np.log(900 * img_h / IMG_H), n))
    cx = rng.uniform(0, img_w, n)
    cy = rng.uniform(0, img_h, n)
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    boxes = np.clip(boxes, 0, [img_w, img_h, img_w, img_h])
    special = []
    for i in range(n_special // 5):
        s = rng.uniform(20, 400)
        special += [
            [0, 0, s, s * 0.7],                            # top-left edge
            [img_w - s, img_h - s, img_w, img_h],           # bottom-right edge
            [-s, -0.5 * s, s, 0.5 * s],                     # out of range
            [10 + i, 100, img_w - 48, 100 + 3 + i % 7],     # extreme aspect
            [500 + i, 300 + i, 500 + i + 0.5 * (i % 3), 300 + i],  # tiny / zero
        ]
    boxes = np.concatenate([boxes, np.asarray(special).reshape(-1, 4)],
                           0).astype(np.float32)
    return np.concatenate([np.full((num, 1), image, np.float32), boxes], 1)


def training_rois(rng):
    """The RoI head's rois of one training step at full size: 512 sampled
    per image and 10 random proposals per image over 4 images."""
    parts = [flagship_rois(rng, TRAIN_ROIS, b) for b in range(TRAIN_IMAGES)]
    parts += [flagship_rois(rng, RANDOM_ROIS, b) for b in range(TRAIN_IMAGES)]
    return np.concatenate(parts)


def clustered_rois(rng, image):
    """The RoI sampler's rois of one image where positives cluster: 128 of
    ``TRAIN_ROIS`` jittered around ``NUM_GTS`` seeded gts (4 each, every
    side moved by at most a tenth of the gt's size, so IoU >= 0.5), the rest
    as ``flagship_rois``."""
    gt = seeded_gts(rng, 1, IMG_H, IMG_W)[0][0].astype(np.float64)
    k = np.repeat(np.arange(NUM_GTS), 4)
    size = np.stack([gt[k, 2] - gt[k, 0], gt[k, 3] - gt[k, 1]] * 2, 1)
    pos = gt[k] + rng.uniform(-0.1, 0.1, (len(k), 4)) * size
    pos = np.concatenate([np.full((len(k), 1), image), pos], 1).astype(np.float32)
    return np.concatenate([pos, flagship_rois(rng, TRAIN_ROIS - len(k), image)])


def roi_tap_counts(feat_shapes, rois, tile=8, strides=STRIDES, out=7):
    """What this run's rois read and write at ``out`` x ``out`` bins, for the
    bounds and the design bytes: (distinct map cells (level, image, y, x)
    read by their in-range taps; the sum over rois of each roi's distinct tap
    rows x distinct tap columns, the cells B1 reads; the sum over the tiles
    of B2's lists of the dy bins a tile stages per channel)."""
    import torch
    from oadg_tpu_torch.ops.roi_align import _CHUNK, _Pyramid, _geometry
    pyr = _Pyramid(feat_shapes, strides, rois.device)
    rows, fwd_cells, staged = [], 0, 0
    for i in range(0, rois.shape[0], _CHUNK):
        g = _geometry(pyr, rois[i:i + _CHUNK].float(), out, 2, 56)
        for yi in (g.y0, g.y1):
            for xi in (g.x0, g.x1):
                rows.append(g.rows(yi, xi)[g.ok])
        oky, okx = g.ok.any(2).cpu().numpy(), g.ok.any(1).cpu().numpy()
        per_axis = []
        for ok, taps in ((oky, (g.y0, g.y1)), (okx, (g.x0, g.x1))):
            lo, hi = (t.reshape(t.shape[0], -1).cpu().numpy() for t in taps)
            both = np.where(np.concatenate([ok, ok], 1), np.concatenate([lo, hi], 1), -1)
            both.sort(1)
            distinct = ((both >= 0) & (np.diff(both, axis=1, prepend=-1) != 0)).sum(1)
            # the bins of each tile row (column) that reach it: B2 stages
            # the range first..last of them
            n = len(lo)
            touched = np.zeros((n, max(1, int(both.max()) // tile + 1), out), bool)
            for s in range(lo.shape[1]):
                for t in (lo[:, s], hi[:, s]):
                    sel = ok[:, s]
                    touched[np.arange(n)[sel], t[sel] // tile, s // 2] = True
            any_ = touched.any(2)
            first = touched.argmax(2)
            last = out - 1 - touched[:, :, ::-1].argmax(2)
            per_axis.append((distinct, np.where(any_, last - first + 1, 0).sum(1)))
        (dy_, sy), (dx_, sx) = per_axis
        fwd_cells += int((dy_ * dx_).sum())
        staged += int((sy * sx).sum())
    return int(torch.unique(torch.cat(rows)).numel()), fwd_cells, staged


def bound_ms(nbytes):
    """Least time for ``nbytes`` of device-memory traffic on the card; both
    kernels' FLOPs are negligible beside it."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def flagship_maps(dev, images, seed):
    """``images`` images' seeded FPN maps at the flagship's shapes, f32,
    channels-last."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(images, CHANNELS, IMG_H // s, IMG_W // s, device=dev,
                        generator=gen).contiguous(memory_format=torch.channels_last)
            for s in STRIDES]


def roi_fwd_inputs(dev):
    """B1's inputs at the serving shapes: one image's FPN maps and 1000 rois."""
    import torch
    return (flagship_maps(dev, 1, 0),
            torch.from_numpy(flagship_rois(np.random.RandomState(0))).to(dev))


def roi_bwd_inputs(dev):
    """B2's inputs at the training shapes: 4 images' FPN maps, 2048 sampled
    + 40 random rois and the gradient of their features."""
    import torch
    feats = flagship_maps(dev, TRAIN_IMAGES, 1)
    rois = torch.from_numpy(training_rois(np.random.RandomState(1))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    dy = torch.randn(rois.shape[0], CHANNELS, 7, 7, device=dev, generator=gen)
    return feats, rois, dy


def roi_cases(dev):
    """The RoIAlign cases of phase 3 and of tools/torch_compare_roi_align.py,
    each f32 and bf16 (the maps cast): B1 at serving (1 image, R=1000) and
    at the step's two calls (4 images, R=2048 sampled and R=40 random); B2
    at R=2088 (both calls' rois at once, the report's case), at the step's
    two calls, and at R=2048 with clustered positives. The first of each is
    its report row. -> (B1 cases, B2 cases), each a list of (label, feats,
    rois[, dy])."""
    import torch
    serving, srois = roi_fwd_inputs(dev)
    train, trois, dy = roi_bwd_inputs(dev)
    n = TRAIN_IMAGES * TRAIN_ROIS
    rng = np.random.RandomState(4)
    crois = torch.from_numpy(np.concatenate([clustered_rois(rng, b)
                                             for b in range(TRAIN_IMAGES)])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    cdy = torch.randn(crois.shape[0], CHANNELS, 7, 7, device=dev, generator=gen)
    fwd, bwd = [], []
    for name, cast in (("f32", lambda fs: fs), ("bf16", lambda fs: [f.bfloat16() for f in fs])):
        sv, tr = cast(serving), cast(train)
        fwd += [(f"{name}, serving, 1 image, R={srois.shape[0]}", sv, srois),
                (f"{name}, training, 4 images, R={n} sampled", tr, trois[:n]),
                (f"{name}, training, 4 images, R={trois.shape[0] - n} random", tr, trois[n:])]
        bwd += [(f"{name}, 4 images, R={trois.shape[0]} (both calls' rois)", tr, trois, dy),
                (f"{name}, 4 images, R={n} sampled", tr, trois[:n], dy[:n].contiguous()),
                (f"{name}, 4 images, R={trois.shape[0] - n} random", tr, trois[n:],
                 dy[n:].contiguous()),
                (f"{name}, 4 images, R={crois.shape[0]} clustered", tr, crois, cdy)]
    return fwd, bwd


def roi_fwd_bytes(feats, rois, strides=STRIDES, bins=7):
    """B1's bound and design bytes at ``bins`` x ``bins``: the f32 output
    written once plus each distinct tap cell's channels read once; the design
    reads each roi's distinct tap rows x columns once."""
    cells, per_roi, _ = roi_tap_counts([f.shape for f in feats], rois, strides=strides,
                                       out=bins)
    c = feats[0].shape[1]
    out = rois.shape[0] * c * bins * bins * 4
    e = feats[0].element_size()
    return out + cells * c * e, out + per_roi * c * e, cells


def roi_bwd_bytes(feats, rois, strides=STRIDES, bins=7):
    """B2's bound and design bytes at ``bins`` x ``bins``: dy read once plus
    the gradient maps written once in the maps' dtype; the design writes the
    maps once and reads the dy bins that its tiles stage (each at least
    once)."""
    _, _, staged = roi_tap_counts([f.shape for f in feats], rois, strides=strides, out=bins)
    c = feats[0].shape[1]
    table = sum(math.prod(f.shape) for f in feats) * feats[0].element_size()
    return rois.shape[0] * c * bins * bins * 4 + table, table + staged * c * 4, table


def check_fwd_case(label, fs, rois, strides=STRIDES, phase="kernels", bins=7):
    """B1 at one case (``bins`` x ``bins``) against its plain version, then
    timed beside its bound. -> (max abs error, timing, bound bytes)."""
    import torch
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_FWD, roi_align_multilevel_ref
    tol = TOL_F32 if "f32" in label else TOL_BF16
    got = ROI_ALIGN_FWD(fs, rois, bins, strides, 2, 56)
    want = roi_align_multilevel_ref(fs, rois, bins, strides, 2, 56)
    torch.cuda.synchronize()
    fmax = max(float(f.float().abs().max()) for f in fs)
    err = float((got - want).abs().max())
    log(phase, f"roi_align_fwd {label}: shape {tuple(got.shape)} "
               f"max_abs_err {err:.3e} (limit {tol * fmax:.3e})")
    if not (torch.isfinite(got).all() and err <= tol * fmax):
        raise AssertionError(f"roi_align_fwd {label} disagrees with the "
                             f"plain version: {err} > {tol * fmax}")
    del got, want
    t = time_kernel(lambda i: ROI_ALIGN_FWD(fs, rois, bins, strides, 2, 56), None, n=30)
    nbytes, design, cells = roi_fwd_bytes(fs, rois, strides, bins)
    log(phase, f"roi_align_fwd {label}: {timing_text(t)}; bound "
               f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB, {cells} distinct "
               f"tap cells; {bound_ms(nbytes) / t['device_ms']:.0%} of the bound); "
               f"the design moves {design / 1e6:.1f} MB ({bound_ms(design):.4f} ms)"
               + (f" ({nvidia_smi_line()})" if phase != "kernels" else ""))
    return err, t, nbytes


def check_bwd_case(label, fs, rois, dy, strides=STRIDES, phase="kernels"):
    """B2 at one case (dy's bins) against its plain version and against
    itself (equal bits in two calls), then timed beside its bound. -> (max
    abs error, timing, bound bytes)."""
    import torch
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, roi_align_multilevel_ref_backward
    shapes = [f.shape for f in fs]
    bins = dy.shape[-1]
    want = roi_align_multilevel_ref_backward(dy, shapes, rois, bins, strides, 2, 56)
    scale = max(float(w.abs().max()) for w in want)
    got = ROI_ALIGN_BWD(fs, rois, dy, bins, strides, 2, 56)
    again = ROI_ALIGN_BWD(fs, rois, dy, bins, strides, 2, 56)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
    if "f32" in label:
        limit = TOL_F32 * scale
        ok = err <= limit
    else:
        limit = TOL_BF16 * scale
        ok = all(bool(((g.float() - w).abs() <= 2 ** -8 * w.abs() + limit).all())
                 for g, w in zip(got, want))
    ok = ok and same and all(g.dtype == fs[0].dtype and g.shape == f.shape
                             and bool(torch.isfinite(g).all()) for g, f in zip(got, fs))
    log(phase, f"roi_align_bwd {label}: {len(got)} levels, max_abs_err {err:.3e} "
               f"(limit {limit:.3e}{' + 2^-8 |value|' if 'bf16' in label else ''}; "
               f"largest gradient {scale:.3e}); two calls give equal bits: {same}")
    if not ok:
        raise AssertionError(f"roi_align_bwd {label} disagrees with the plain "
                             f"version ({err} > {limit}) or with itself ({same})")
    del got, again, want
    t = time_kernel(lambda i: ROI_ALIGN_BWD(fs, rois, dy, bins, strides, 2, 56), None, n=20)
    nbytes, design, table = roi_bwd_bytes(fs, rois, strides, bins)
    log(phase, f"roi_align_bwd {label}: {timing_text(t)}; bound "
               f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB: dy "
               f"{dy.numel() * 4 / 1e6:.1f}, gradient maps {table / 1e6:.1f}; "
               f"{bound_ms(nbytes) / t['device_ms']:.0%} of the bound); the tiled "
               f"design moves {design / 1e6:.1f} MB ({bound_ms(design):.4f} ms: the "
               f"maps once and {(design - table) / 1e6:.1f} MB of staged dy bins)"
               + (f" ({nvidia_smi_line()})" if phase != "kernels" else ""))
    return err, t, nbytes


def phase_kernels():
    """B1 and B2 vs their plain versions at every case of ``roi_cases``,
    B2's bits equal in two calls, each case timed beside its bound; returns
    the kernels' report rows. The plain versions' times come from
    ``phase_profiled``."""
    import torch
    dev = torch.device("cuda", 0)
    fwd_cases, bwd_cases = roi_cases(dev)
    rows = []
    main, others = None, []
    for label, fs, rois in fwd_cases:
        err, t, nbytes = check_fwd_case(label, fs, rois)
        if main is None:
            main = (err, t, nbytes)
        else:
            others.append(case_row(label, err, t, nbytes))
    rows.append(row("roi_align_fwd", "roi_align_fwd.cu", "oadg_tpu/ops/pallas_roi_bwd.py:248",
                    *main, cases=others))
    main, others = None, []
    for label, fs, rois, dy in bwd_cases:
        err, t, nbytes = check_bwd_case(label, fs, rois, dy)
        if main is None:
            main = (err, t, nbytes)
        else:
            others.append(case_row(label, err, t, nbytes))
    rows.append(row("roi_align_bwd", "roi_align_bwd.cu", "oadg_tpu/ops/pallas_roi_bwd.py:316",
                    *main, cases=others))
    del fwd_cases, bwd_cases
    torch.cuda.empty_cache()
    return rows


def flagship_oamix_cfg():
    from oadg_tpu_torch.config import load_config
    cfg = dict(load_config(FLAGSHIP)["oamix_config"])
    cfg.pop("type", None)
    return cfg


def seeded_gts(rng, n_images, h, w):
    """``NUM_GTS`` seeded gts per image of log-uniform size over the 8
    classes: boxes (n, NUM_GTS, 4) float32 and labels (n, NUM_GTS)."""
    bw = np.exp(rng.uniform(np.log(16), np.log(w / 2), (n_images, NUM_GTS)))
    bh = np.exp(rng.uniform(np.log(16), np.log(h / 2), (n_images, NUM_GTS)))
    x1 = rng.uniform(0, w - bw)
    y1 = rng.uniform(0, h - bh)
    gt = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    return gt, rng.randint(0, 8, (n_images, NUM_GTS))


def fg_inputs(gt, h, w):
    """The gated blurred-mask profiles of the first 16 gts, as OA-Mix makes
    them for B3: fx (16, W), fy (16, H)."""
    import torch
    from oadg_tpu_torch.ops.oamix_device import MAX_FG, _blurred_profiles
    fx, fy = _blurred_profiles(gt[:MAX_FG], h, w, 0.3)
    small = ((gt[:MAX_FG, 2] - gt[:MAX_FG, 0]) < 1) | ((gt[:MAX_FG, 3] - gt[:MAX_FG, 1]) < 1)
    return fx.contiguous(), (fy * (~small).float()[:, None]).contiguous()


FG_TILE = (16, 256)  # rows and columns of B3's tile (a block); a warp owns one row of it


def fg_cases(inp):
    """B3's cases (label, fx, fy) at the flagship's shapes: the gated blurred
    profiles of ``warp_inputs``' 16 seeded gts (the report's main case; most
    products are exact zeros), then 16 dense profiles, non-zero everywhere,
    where every box is live on every pixel."""
    import torch
    rng = np.random.RandomState(7)
    dense = [torch.from_numpy(rng.uniform(0.01, 1.0, (16, n)).astype(np.float32))
             .to(inp.fx.device) for n in (inp.w, inp.h)]
    return (("seeded gts' blurred profiles", inp.fx, inp.fy),
            ("dense profiles", *dense))


def hist_cases(inp):
    """B6's cases (label, uint8 image (H, W, 3)): the random image (the
    report's main case), the chain-like image of flat 64x64 blocks, and a
    constant image (every value of a channel in one bin)."""
    import torch
    const = torch.tensor([17, 200, 93], dtype=torch.uint8, device=inp.img3.device)
    return (("random", inp.img3), ("chain-like", inp.flat3),
            ("constant", const.expand(inp.h, inp.w, 3).contiguous()))


def check_fg_maps(got, want, fx, fy):
    """B3 against its plain version: ``best_id`` equal except where two
    masks tie exactly; cover and union within one bf16 step. -> (pixels
    whose id differs, max abs error of cover and union)."""
    import torch
    g = fx.shape[0]
    diff = got[0] != want[0]
    n = int(diff.sum())
    if n:
        ys, xs = diff.nonzero(as_tuple=True)
        ids = [t[ys, xs].long() for t in (got[0], want[0])]
        if not all(bool((i < g).all()) for i in ids):
            raise AssertionError(f"fg_maps: {n} ids differ, some at the sentinel")
        m = [fy[i, ys] * fx[i, xs] for i in ids]
        if not torch.equal(m[0], m[1]):
            raise AssertionError(f"fg_maps: {n} ids differ where the masks do not tie")
    err = 0.0
    for a, b in zip(got[1:], want[1:]):
        d = (a.float() - b.float()).abs()
        err = max(err, float(d.max()))
        if not bool((d <= 2 ** -7 * b.float().abs()).all()):
            raise AssertionError("fg_maps: cover or union off by more than one bf16 step")
    return n, err


def row(name, source, replaces, err, timing, nbytes, cases=None):
    """One kernel's line of the report: ``timing`` from ``time_kernel`` (``ms``
    is ``device_ms``), the bound from the bytes the function must move, and
    for the row shifts the other cases timed in this run."""
    out = {"name": name, "route": "cuda", "source": f"oadg_tpu_torch/ops/csrc/{source}",
           "replaces": replaces, "launches": None, "max_abs_err": err, **timing,
           "bound_ms": bound_ms(nbytes), "bound_by": "bytes"}
    if cases is not None:
        out["cases"] = cases
    return out


def case_row(label, err, timing, nbytes):
    return {"label": label, "max_abs_err": err, "bound_ms": bound_ms(nbytes),
            **{k: timing[k] for k in ("device_ms", "host_us", "spread", "idle_launch_ms",
                                      "plain_ms", "library_ms", "library_host_us",
                                      "library_spread")}}


def shift_grid(off, axis, h, w):
    """The ``F.grid_sample`` grid (1, H, W, 2) that reads each pixel ``off``
    (H, W) pixels along ``axis`` (align_corners=True, zeros outside)."""
    import torch
    ys = torch.arange(h, dtype=torch.float32, device=off.device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=off.device)[None, :].expand(h, w)
    if axis == 1:
        xs = xs + off
    else:
        ys = ys + off
    return torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], -1)[None]


ROTATE = 3       # copies of a row shift's inputs, taken in turn by the timed calls


def chain_like_image(rng, h, w):
    """A uint8 image as OA-Mix's chain leaves it in flat scenes: 64x64 blocks
    of one colour each, 8 distinct colours."""
    palette = rng.randint(0, 256, (8, 3)).astype(np.uint8)
    blocks = rng.randint(0, 8, (h // 64, w // 64))
    return np.ascontiguousarray(palette[np.kron(blocks, np.ones((64, 64), np.int64))])


def grid_sampler(img, per_px, axis):
    """The library call beside a row shift: ``F.grid_sample`` of the float32
    NCHW image (``ROTATE`` copies, taken in turn) on the grid of the
    per-pixel offsets ``per_px`` (H, W). -> ``fn(i)``."""
    import torch.nn.functional as F
    h, w = per_px.shape
    grid = shift_grid(per_px, axis, h, w)
    inps = [img.float().permute(2, 0, 1)[None].contiguous() for _ in range(ROTATE)]
    return lambda i: F.grid_sample(inps[i % ROTATE], grid, mode="bilinear",
                                   padding_mode="zeros", align_corners=True)


def warp_inputs(dev):
    """The seeded inputs of B3-B7's cases at the flagship's shapes: a random
    uint8 image and a chain-like one, each also as float32 with B3's alpha
    as fourth channel, 16 gts with B3's profiles and maps (``best_id`` is
    B5's box id and B7's composite id), and the shift tables of a per-box
    rotate of 16 seeded angles."""
    import types
    import torch
    from oadg_tpu_torch.ops import fg_maps as fgm
    h, w = IMG_H, IMG_W
    rng = np.random.RandomState(6)
    inp = types.SimpleNamespace(h=h, w=w)
    inp.img3 = torch.from_numpy(request_image(rng)).to(dev)
    inp.gt = torch.from_numpy(seeded_gts(rng, 1, h, w)[0][0]).to(dev)
    inp.fx, inp.fy = fg_inputs(inp.gt, h, w)
    inp.fg = fgm.FG_MAPS(inp.fx, inp.fy, h, w)
    inp.best_id = inp.fg[0]
    alpha = (inp.fy.amax(0)[:, None] * inp.fx.amax(0)[None, :] * 255).bfloat16().float()[..., None]
    inp.img4 = torch.cat([inp.img3.float(), alpha], -1).contiguous()
    lvl = torch.from_numpy(rng.uniform(0.1, 10.0, 16).astype(np.float32)).to(dev)
    sign = torch.from_numpy(np.where(rng.rand(16) > 0.5, -1.0, 1.0).astype(np.float32)).to(dev)
    rad = torch.deg2rad(torch.floor(lvl * 3.0) * sign)
    cx, cy = (inp.gt[:16, 0] + inp.gt[:16, 2]) / 2, (inp.gt[:16, 1] + inp.gt[:16, 3]) / 2
    inp.ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    inp.xs = torch.arange(w, dtype=torch.float32, device=dev)[:, None]
    inp.table_x = -torch.tan(rad / 2)[None, :] * (inp.ys - cy[None, :])
    inp.table_y = torch.sin(rad)[None, :] * (inp.xs - cx[None, :])
    inp.flat3 = torch.from_numpy(chain_like_image(rng, h, w)).to(dev)
    inp.flat4 = torch.cat([inp.flat3.float(), alpha], -1).contiguous()
    return inp


def piecewise_cases(inp, piecewise):
    """B5's cases (label, image, axis, table, max_shift): the three passes
    of a per-box rotate as the slots chain runs them (x on the uint8 image,
    then column and x on the float32 result of the pass before, made here
    with ``piecewise``), the column pass on the uint8 image, and the x pass
    on the chain-like image. The first is the report's main case."""
    pass1 = piecewise(inp.img3, inp.best_id, inp.table_x, 512, 1)
    pass2 = piecewise(pass1, inp.best_id, inp.table_y, 768, 0)
    return (("x pass, uint8 3-channel", inp.img3, 1, inp.table_x, 512),
            ("column pass, float32 3-channel (a rotate's second pass)", pass1, 0,
             inp.table_y, 768),
            ("x pass, float32 3-channel (a rotate's third pass)", pass2, 1, inp.table_x, 512),
            ("column pass, uint8 3-channel", inp.img3, 0, inp.table_y, 768),
            ("x pass, uint8 3-channel, chain-like image", inp.flat3, 1, inp.table_x, 512))


def piecewise_offsets(best_id, table, ms_max, axis):
    """The offset (H, W) that B5 gives each pixel, for ``grid_sampler``."""
    import torch
    p = torch.clamp(table, -ms_max, ms_max)
    bid = best_id.long().clamp(max=15)
    per_px = torch.gather(p, 1, bid) if axis == 1 else torch.gather(p.T, 0, bid)
    return torch.where(best_id.long() < 16, per_px, torch.zeros_like(per_px))


def merged_cases(inp):
    """B7's cases (label, image, axis, cid, p_bb, p_sl, is_bb, is_bg) on the
    4-channel float32 image with B3's ``best_id`` as the composite id (S =
    1, as the merged chain calls it): per-box x and column passes, a
    background pass, the identity, three slots with mixed flags, and the
    per-box x pass on the chain-like image. The first is the report's main
    case."""
    import torch
    h, w, dev = inp.h, inp.w, inp.img4.device
    a, b = -math.tan(math.radians(15)), math.sin(math.radians(30))
    bg = torch.clamp(a * (inp.ys - h / 2.0), -(int(0.27 * h / 2) + 4), int(0.27 * h / 2) + 4)
    slot = torch.full((h, w), 2, dtype=torch.long, device=dev)
    slot[100:500, 200:900], slot[600:1000, 1100:1900] = 0, 1
    best_id = inp.best_id
    cid3 = torch.where(best_id.long() < 16, slot * 16 + best_id.long(),
                       torch.full_like(slot, 48)).to(torch.int8)
    p_rot_x = torch.clamp(inp.table_x, -512, 512)
    p_rot_y = torch.clamp(inp.table_y, -768, 768)
    zero = lambda n, k: torch.zeros((n, k), device=dev)
    return (
        ("per-box x pass", inp.img4, 1, best_id, p_rot_x, zero(h, 1), [True], [False]),
        ("per-box column pass", inp.img4, 0, best_id, p_rot_y, zero(w, 1), [True], [False]),
        ("background x pass", inp.img4, 1, best_id, zero(h, 16), bg, [False], [True]),
        ("identity", inp.img4, 1, best_id, p_rot_x, bg, [False], [False]),
        ("3 slots x pass", inp.img4, 1, cid3, p_rot_x.repeat(1, 3) * 0.5, bg.repeat(1, 3),
         [True, False, False], [False, False, True]),
        ("3 slots column pass", inp.img4, 0, cid3, p_rot_y.repeat(1, 3) * 0.5,
         torch.clamp(b * (inp.xs - w / 2.0), -516, 516).repeat(1, 3),
         [False, True, False], [True, False, False]),
        ("per-box x pass, chain-like image", inp.flat4, 1, best_id, p_rot_x, zero(h, 1),
         [True], [False]))


def merged_offsets(cid, p_bb, p_sl, is_bb, is_bg, axis):
    """The offset (H, W) that B7 gives each pixel, for ``grid_sampler``."""
    import torch
    from oadg_tpu_torch.ops.warp import _merged_table
    table = _merged_table(p_bb, p_sl, np.asarray(is_bb), np.asarray(is_bg))
    k = cid.long().clamp(0, p_bb.shape[1])
    return torch.gather(table, 1, k) if axis == 1 else torch.gather(table.T, 0, k)


def phase_oamix_kernels():
    """B3-B7 vs their plain versions at the flagship's shapes. The timed
    calls of a kernel take ``ROTATE`` copies of its inputs in turn and keep
    their last results alive, so that a call finds neither its input nor
    the lines it writes in the 50 MB L2 cache."""
    import torch
    from oadg_tpu_torch.ops import fg_maps as fgm
    from oadg_tpu_torch.ops import hist, warp
    dev = torch.device("cuda", 0)
    h, w = IMG_H, IMG_W
    inp = warp_inputs(dev)
    img3, img4, best_id = inp.img3, inp.img4, inp.best_id
    rows = []
    copies = lambda t: [t.clone() for _ in range(ROTATE)]

    # B3: the 16 seeded gts' profiles on 1024x2048 (main), then 16 dense ones
    main, others = None, []
    for label, pfx, pfy in fg_cases(inp):
        got = fgm.FG_MAPS(pfx, pfy, h, w)
        want = fgm.fg_maps_ref(pfx, pfy, h, w)
        torch.cuda.synchronize()
        n_ties, err = check_fg_maps(got, want, pfx, pfy)
        live = {key: float(fgm._live_boxes(pfx, pfy, *tile).sum(-1).float().mean())
                for key, tile in (("tile", FG_TILE), ("row", (1, FG_TILE[1])), ("lane", (1, 8)))}
        t = time_kernel(lambda i: fgm.FG_MAPS(pfx, pfy, h, w),
                        lambda i: fgm.fg_maps_ref(pfx, pfy, h, w), ring=8)
        nbytes = (pfx.numel() + pfy.numel()) * 4 + h * w * (1 + 2 + 2)
        log("kernels", f"fg_maps {label}, G=16 {h}x{w}: live boxes (of 16) a "
                       f"{FG_TILE[0]}x{FG_TILE[1]} tile {live['tile']:.2f}, a row of it "
                       f"{live['row']:.2f}, a lane's 8 pixels {live['lane']:.2f}; best_id "
                       f"differs at {n_ties} exact ties; cover/union max_abs_err {err:.3e} "
                       f"(limit one bf16 step); {timing_text(t)}; bound "
                       f"{bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB)")
        if main is None:
            main, main_live = (err, t, nbytes), live
        else:
            others.append(case_row(label, err, t, nbytes) | {"live_boxes": live})
    rows.append(row("fg_maps", "fg_maps.cu", "oadg_tpu/ops/pallas_fg.py:54", *main,
                    cases=others) | {"live_boxes": main_live})
    in_boxes = int((best_id < 16).sum())

    # B4: x and column passes at the severity-10 rotate and translate shifts
    a, b = -math.tan(math.radians(15)), math.sin(math.radians(30))
    cases = (("x rotate", 1, a, -a * h / 2, int(0.27 * h / 2) + 4),
             ("column rotate", 0, b, -b * w / 2, int(0.50 * w / 2) + 4),
             ("x translate", 1, 0.0, -float(np.floor(9.9 * (w / 3) / 10)), w // 3 + 4),
             ("column translate", 0, 0.0, float(np.floor(9.9 * (h / 3) / 10)), h // 3 + 4))
    main, others = None, []
    for label, axis, k1, k2, ms_max in cases:
        n = h if axis == 1 else w
        shifts, fracs = warp._row_shift_params(k1, k2, n, ms_max, dev)
        off = (shifts.float() + fracs)
        off = off[:, None].expand(h, w) if axis == 1 else off[None, :].expand(h, w)
        for im in (img3, img4):
            got = warp.SHEAR_ROWS(im, shifts, fracs, ms_max, axis)
            want = warp.shear_rows_ref(im, shifts, fracs, ms_max, axis)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            c = im.shape[-1]
            if not err <= TOL_WARP:
                raise AssertionError(f"shear_rows {label} C={c}: {err} > {TOL_WARP}")
            ims = copies(im)
            t = time_kernel(
                lambda i: warp.SHEAR_ROWS(ims[i % ROTATE], shifts, fracs, ms_max, axis),
                lambda i: warp.shear_rows_ref(ims[i % ROTATE], shifts, fracs, ms_max, axis),
                grid_sampler(im, off, axis))
            nbytes = im.numel() * im.element_size() + im.numel() * 4 + n * 8
            log("kernels", f"shear_rows {label} C={c} {im.dtype}: max_abs_err "
                           f"{err:.3e} (limit {TOL_WARP:.0e}); {timing_text(t, 'F.grid_sample')}; "
                           f"bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB)")
            if label == "x rotate" and c == 4:        # the bg rotate's pass
                main = (err, t, nbytes)
            else:
                others.append(case_row(f"{label} C={c} {im.dtype}", err, t, nbytes))
    rows.append(row("shear_rows", "shift_rows.cu", "oadg_tpu/ops/pallas_warp.py:131",
                    *main, cases=others))

    # B5 on B3's own best_id, rotate shifts of 16 boxes
    main, others = None, []
    for label, im, axis, table, ms_max in piecewise_cases(inp, warp.PIECEWISE_SHIFT_ROWS):
        fast = warp.PIECEWISE_SHIFT_ROWS.routes["fast"]
        got = warp.PIECEWISE_SHIFT_ROWS(im, best_id, table, ms_max, axis)
        want = warp.piecewise_shift_rows_ref(im, best_id, table, ms_max, axis)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= TOL_WARP:
            raise AssertionError(f"piecewise_shift_rows {label}: {err} > {TOL_WARP}")
        if warp.PIECEWISE_SHIFT_ROWS.routes["fast"] != fast + 1:
            raise AssertionError(f"piecewise_shift_rows {label} did not take the fast route")
        ims, ids = copies(im), copies(best_id)
        t = time_kernel(
            lambda i: warp.PIECEWISE_SHIFT_ROWS(ims[i % ROTATE], ids[i % ROTATE], table,
                                                ms_max, axis),
            lambda i: warp.piecewise_shift_rows_ref(ims[i % ROTATE], ids[i % ROTATE], table,
                                                    ms_max, axis),
            grid_sampler(im, piecewise_offsets(best_id, table, ms_max, axis), axis))
        nbytes = (im.numel() * im.element_size() + best_id.numel() + table.numel() * 4
                  + im.numel() * 4)
        log("kernels", f"piecewise_shift_rows {label}, 16 boxes, {in_boxes} pixels in "
                       f"boxes: max_abs_err {err:.3e} (limit {TOL_WARP:.0e}); "
                       f"{timing_text(t, 'F.grid_sample')}; bound {bound_ms(nbytes):.4f} ms "
                       f"({nbytes / 1e6:.1f} MB, {nbytes / t['device_ms'] / 1e9:.3f} TB/s)")
        if main is None:
            main = (err, t, nbytes)
        else:
            others.append(case_row(label, err, t, nbytes))
    rows.append(row("piecewise_shift_rows", "shift_rows.cu", "oadg_tpu/ops/pallas_warp.py:647",
                    *main, cases=others))

    # B7
    main, others = None, []
    for label, im, axis, cid, p_bb, p_sl, is_bb, is_bg in merged_cases(inp):
        args = (cid, p_bb, p_sl, is_bb, is_bg, axis)
        fast = warp.MERGED_SHIFT_ROWS.routes["fast"]
        got = warp.MERGED_SHIFT_ROWS(im, *args)
        want = warp.merged_shift_rows_ref(im, *args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= TOL_WARP:
            raise AssertionError(f"merged_shift_rows {label}: {err} > {TOL_WARP}")
        if warp.MERGED_SHIFT_ROWS.routes["fast"] != fast + 1:
            raise AssertionError(f"merged_shift_rows {label} did not take the fast route")
        if label == "identity" and not torch.equal(got, im):
            raise AssertionError("merged_shift_rows with no flag set is not the identity")
        ims, ids = copies(im), copies(cid)
        t = time_kernel(
            lambda i: warp.MERGED_SHIFT_ROWS(ims[i % ROTATE], ids[i % ROTATE], *args[1:]),
            lambda i: warp.merged_shift_rows_ref(ims[i % ROTATE], ids[i % ROTATE], *args[1:]),
            grid_sampler(im, merged_offsets(*args), axis))
        nbytes = 2 * im.numel() * 4 + cid.numel() + (p_bb.numel() + p_sl.numel()) * 4
        log("kernels", f"merged_shift_rows {label}, S={len(is_bb)}, 16 boxes: max_abs_err "
                       f"{err:.3e} (limit {TOL_WARP:.0e}); {timing_text(t, 'F.grid_sample')}; "
                       f"bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB, "
                       f"{nbytes / t['device_ms'] / 1e9:.3f} TB/s)")
        if main is None:
            main = (err, t, nbytes)
        else:
            others.append(case_row(label, err, t, nbytes))
    rows.append(row("merged_shift_rows", "shift_rows.cu", "oadg_tpu/ops/pallas_warp.py:564",
                    *main, cases=others))

    # B6: the three channels' histograms of one 1024x2048 image, random
    # (main), chain-like and constant; 9 copies in turn (57 MB).
    # torch.bincount's times come from phase_profiled.
    main, others = None, []
    for label, im in hist_cases(inp):
        got = hist.HIST256(im, 3)
        want = hist.hist256_ref(im, 3)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"hist256 {label}: counts differ from the plain version")
        imgs = [im.clone() for _ in range(9)]
        t = time_kernel(lambda i: hist.HIST256(imgs[i % 9], 3),
                        lambda i: hist.hist256_ref(imgs[i % 9], 3), plain_n=10)
        nbytes = im.numel() + 3 * 256 * 4
        log("kernels", f"hist256 {label} {h}x{w}x3 uint8: counts equal; {timing_text(t)}; "
                       f"bound {bound_ms(nbytes):.4f} ms ({nbytes / 1e6:.1f} MB)")
        if main is None:
            main = (0.0, t, nbytes)
        else:
            others.append(case_row(label, 0.0, t, nbytes))
        del imgs
    rows.append(row("hist256", "hist256.cu", "oadg_tpu/ops/pallas_hist.py:73", *main,
                    cases=others))
    torch.cuda.empty_cache()
    return rows


def _set_plain_ms(row, name, case, ms):
    """The plain version's time: the row's own (its f32 report case), or
    that of its bf16 case whose label holds ``case``."""
    if name == "f32":
        row["plain_ms"] = ms
        return
    for c in row["cases"]:
        if c["label"].startswith("bf16") and case in c["label"]:
            c["plain_ms"] = ms
            return
    raise KeyError(f"{row['name']} has no bf16 case {case!r}")


def _set_case_plain_ms(row, label, ms):
    """The plain version's time of the row's case ``label``."""
    for c in row["cases"]:
        if c["label"] == label:
            c["plain_ms"] = ms
            return
    raise KeyError(f"{row['name']} has no case {label!r}")


def _set_row_or_case_plain_ms(row, label, ms):
    """The plain version's time of ``label``: the row's own where it is the
    row's report case, else that of its case."""
    if row.get("label") == label:
        row["plain_ms"] = ms
    else:
        _set_case_plain_ms(row, label, ms)


def profile_roi_plain(by_name, suffix, cases, bins, strides):
    """The plain versions' times, by the profiler, at the B1 and B2 cases
    that ``cases(device)`` gives ((B1 cases, B2 cases), as ``mask_roi_cases``
    and its siblings make them), into the rows ``roi_align_fwd<suffix>`` and
    ``roi_align_bwd<suffix>``: each case's own, or the row's where it is the
    row's report case."""
    import torch
    from oadg_tpu_torch.ops.roi_align import (roi_align_multilevel_ref,
                                              roi_align_multilevel_ref_backward)
    fwd, bwd = cases(torch.device("cuda", 0))
    for label, fs, rois in fwd:
        t = device_time(lambda i: roi_align_multilevel_ref(fs, rois, bins, strides, 2, 56),
                        3, method="profiler")
        _set_row_or_case_plain_ms(by_name[f"roi_align_fwd{suffix}"], label, t["device_ms"])
        log("profiled", f"roi_align_fwd plain version ({label}): device {t['device_ms']:.4f} "
                        f"ms (timer profiler), host {t['host_us']:.1f} us a call")
    for label, fs, rois, dy in bwd:
        dt, shapes = fs[0].dtype, [f.shape for f in fs]
        t = device_time(lambda i: [g.to(dt) for g in roi_align_multilevel_ref_backward(
            dy, shapes, rois, bins, strides, 2, 56)], 2, method="profiler")
        _set_row_or_case_plain_ms(by_name[f"roi_align_bwd{suffix}"], label, t["device_ms"])
        log("profiled", f"roi_align_bwd plain version ({label}): device {t['device_ms']:.4f} "
                        f"ms (timer profiler), host {t['host_us']:.1f} us a call")
    del fwd, bwd
    torch.cuda.empty_cache()


def phase_profiled(rows):
    """The three times that need ``torch.profiler``, made after the path:
    the plain versions of B1 and B2 build small index tensors from host
    lists on every call (such a copy from pageable memory waits for the
    stream) and ``torch.bincount`` reads its input's largest value, so no
    run of them can be queued ahead of the device, and their device time
    is the profiler's sum of their kernels and copies. They come last
    because the profiler's tracing stays attached to the process once it
    has run, and every later launch then costs the host more: OA-Mix and
    the training steps, which the host bounds, are timed before it."""
    import torch
    from oadg_tpu_torch.ops.roi_align import (roi_align_multilevel_ref,
                                              roi_align_multilevel_ref_backward)
    dev = torch.device("cuda", 0)
    by_name = {r["name"]: r for r in rows}
    feats, rois = roi_fwd_inputs(dev)
    for name in DTYPES:
        fs = [f.to(torch_dtype(name)) for f in feats]
        t = device_time(lambda i: roi_align_multilevel_ref(fs, rois, 7, STRIDES, 2, 56), 5,
                        method="profiler")
        _set_plain_ms(by_name["roi_align_fwd"], name, "serving", t["device_ms"])
        log("profiled", f"roi_align_fwd {name} plain version (serving): device "
                        f"{t['device_ms']:.4f} ms (timer profiler), host {t['host_us']:.1f} "
                        "us a call")
    feats, rois, dy = roi_bwd_inputs(dev)
    for name in DTYPES:
        shapes, dt = [f.shape for f in feats], torch_dtype(name)
        # the plain backward reads only the maps' shapes and sums in float32;
        # the autograd function rounds its result once to the maps' dtype
        t = device_time(lambda i: [g.to(dt) for g in roi_align_multilevel_ref_backward(
            dy, shapes, rois, 7, STRIDES, 2, 56)], 3, method="profiler")
        _set_plain_ms(by_name["roi_align_bwd"], name, f"R={rois.shape[0]}", t["device_ms"])
        log("profiled", f"roi_align_bwd {name} plain version (R={rois.shape[0]}): device "
                        f"{t['device_ms']:.4f} ms (timer profiler), host {t['host_us']:.1f} "
                        "us a call")
    del feats, dy
    fwd, bwd = dwd_roi_cases(dev)
    for (label, fs, rois), (blabel, bfs, brois, bdy) in zip(fwd, bwd):
        t = device_time(lambda i: roi_align_multilevel_ref(fs, rois, 7, DWD_STRIDES, 2, 56), 3,
                        method="profiler")
        _set_case_plain_ms(by_name["roi_align_fwd"], label, t["device_ms"])
        log("profiled", f"roi_align_fwd plain version ({label}): device {t['device_ms']:.4f} "
                        f"ms (timer profiler), host {t['host_us']:.1f} us a call")
        dt, shapes = bfs[0].dtype, [f.shape for f in bfs]
        t = device_time(lambda i: [g.to(dt) for g in roi_align_multilevel_ref_backward(
            bdy, shapes, brois, 7, DWD_STRIDES, 2, 56)], 2, method="profiler")
        _set_case_plain_ms(by_name["roi_align_bwd"], blabel, t["device_ms"])
        log("profiled", f"roi_align_bwd plain version ({blabel}): device {t['device_ms']:.4f} "
                        f"ms (timer profiler), host {t['host_us']:.1f} us a call")
    del fwd, bwd
    torch.cuda.empty_cache()
    for suffix, cases, bins, strides in (
            ("_14x14", mask_roi_cases, MASK_BINS, STRIDES), ("_c4", c4_roi_cases, 14, (16,)),
            ("_sem", sem_roi_cases, MASK_BINS, (SEM_STRIDE,)), ("", sparse_roi_cases, 7, STRIDES)):
        if f"roi_align_fwd{suffix}" in by_name:
            profile_roi_plain(by_name, suffix, cases, bins, strides)
    img3 = torch.from_numpy(request_image(np.random.RandomState(6))).to(dev)
    flats = [(img3.long() + 256 * torch.arange(3, device=dev)).reshape(-1).clone()
             for _ in range(9)]
    bincount = lambda i: torch.bincount(flats[i % 9], minlength=768)
    runs = [device_time(bincount, 50, method="profiler") for _ in range(TIMER_ROUNDS)]
    ms = [r["device_ms"] for r in runs]
    by_name["hist256"].update(
        library_ms=statistics.median(ms), library_spread=[min(ms), max(ms)],
        library_host_us=statistics.median(r["host_us"] for r in runs),
        library_timer="profiler", library_idle_launch_ms=idle_launch_ms(bincount))
    log("profiled", f"hist256's library call: {timing_text(by_name['hist256'], 'torch.bincount')}")
    torch.cuda.empty_cache()


def oamix_wrappers():
    from oadg_tpu_torch.ops import fg_maps, hist, warp
    return {"fg_maps": fg_maps.FG_MAPS, "shear_rows": warp.SHEAR_ROWS,
            "piecewise_shift_rows": warp.PIECEWISE_SHIFT_ROWS, "hist256": hist.HIST256,
            "merged_shift_rows": warp.MERGED_SHIFT_ROWS}


def expected_launches(draws, version, chain="slots"):
    """The launches of B3-B7 that an OA-Mix draw table implies: one B3 per
    view. On the slots chain, per active slot of every chain step, B6 for
    equalize, B5 three times for a per-box rotate and once for a per-box
    shear or translate, B4 likewise for the background ops. On the merged
    chain, B6 once per chain step in which any active slot drew equalize,
    and B7 three times per active slot that drew a rotate (per-box or
    background) and once per shear or translate."""
    from oadg_tpu_torch.ops.oamix_device import MAX_ML, N_SLOTS, num_photometric
    n_photo = num_photometric(version)
    counts = dict.fromkeys(oamix_wrappers(), 0)
    b, v, width = draws["op_idx"].shape[:3]
    for i in range(b):
        for j in range(v):
            counts["fg_maps"] += 1
            for c in range(width):
                for d in range(int(draws["depth"][i, j, c])):
                    ops = [int(draws["op_idx"][i, j, c, d, s]) for s in range(N_SLOTS)
                           if s >= MAX_ML or draws["ml_valid"][i, j, s]]
                    if chain == "merged":
                        counts["hist256"] += 1 in ops
                        counts["merged_shift_rows"] += sum(
                            3 if op in (n_photo, n_photo + 3) else 1
                            for op in ops if op >= n_photo)
                        continue
                    for op in ops:
                        if op == 1:
                            counts["hist256"] += 1
                        elif n_photo <= op < n_photo + 3:
                            counts["piecewise_shift_rows"] += 3 if op == n_photo else 1
                        elif op >= n_photo + 3:
                            counts["shear_rows"] += 3 if op == n_photo + 3 else 1
    return counts


class _CheckedKernel:
    """Stands in for a B3-B7 wrapper: launches the kernel, then holds its
    result against the plain version on the same inputs."""

    def __init__(self, name, kernel, check):
        self.name, self.kernel, self.check = name, kernel, check
        self.errors = []

    def __call__(self, *args):
        out = self.kernel(*args)
        self.errors.append(self.check(out, *args))
        return out


def _check_shear(out, img, shifts, fracs, max_shift, axis):
    from oadg_tpu_torch.ops.warp import shear_rows_ref
    err = float((out - shear_rows_ref(img, shifts, fracs, max_shift, axis)).abs().max())
    if not err <= TOL_WARP:
        raise AssertionError(f"shear_rows in the path: {err} > {TOL_WARP}")
    return err


def _check_piecewise(out, img, bid, shifts, max_shift, axis):
    from oadg_tpu_torch.ops.warp import piecewise_shift_rows_ref
    err = float((out - piecewise_shift_rows_ref(img, bid, shifts, max_shift,
                                                axis)).abs().max())
    if not err <= TOL_WARP:
        raise AssertionError(f"piecewise_shift_rows in the path: {err} > {TOL_WARP}")
    return err


def _check_merged(out, img, cid, p_bb, p_sl, is_bb, is_bg, axis):
    from oadg_tpu_torch.ops.warp import merged_shift_rows_ref
    err = float((out - merged_shift_rows_ref(img, cid, p_bb, p_sl, is_bb, is_bg,
                                             axis)).abs().max())
    if not err <= TOL_WARP:
        raise AssertionError(f"merged_shift_rows in the path: {err} > {TOL_WARP}")
    return err


def _check_hist(out, x, c):
    import torch
    from oadg_tpu_torch.ops.hist import hist256_ref
    if not torch.equal(out, hist256_ref(x, c)):
        raise AssertionError("hist256 in the path differs from the plain version")
    return 0.0


def _check_fg(out, fx, fy, h, w):
    from oadg_tpu_torch.ops.fg_maps import fg_maps_ref
    return check_fg_maps(out, fg_maps_ref(fx, fy, h, w), fx, fy)[1]


class checked_kernels:
    """Within the block B3-B7's wrappers are ``_CheckedKernel``s: each call
    launches the kernel and holds its result against the plain version on
    the same inputs. ``as`` gives the checks by wrapper name."""

    MODULES = {"fg_maps": ("fg_maps", "FG_MAPS", "_check_fg"),
               "shear_rows": ("warp", "SHEAR_ROWS", "_check_shear"),
               "piecewise_shift_rows": ("warp", "PIECEWISE_SHIFT_ROWS", "_check_piecewise"),
               "hist256": ("hist", "HIST256", "_check_hist"),
               "merged_shift_rows": ("warp", "MERGED_SHIFT_ROWS", "_check_merged")}

    def __enter__(self):
        import importlib
        self.slots = {}
        for name, (mod, attr, check) in self.MODULES.items():
            module = importlib.import_module(f"oadg_tpu_torch.ops.{mod}")
            self.slots[name] = (module, attr, getattr(module, attr))
            setattr(module, attr, _CheckedKernel(name, getattr(module, attr),
                                                 globals()[check]))
        return {name: getattr(m, a) for name, (m, a, _) in self.slots.items()}

    def __exit__(self, *exc):
        for module, attr, kernel in self.slots.values():
            setattr(module, attr, kernel)
        return False


def check_ops_in_place(phase, imgs, gt, gv, shapes, cfg, table0):
    """Every op index of ``cfg``'s version in every slot of ``table0``, on
    each chain, with B3-B7 checked in place against their plain versions
    at these images' shapes."""
    import copy
    import torch
    from oadg_tpu_torch.ops.oamix_device import num_photometric, oamix_batch
    n_photo = num_photometric(cfg["version"])
    with checked_kernels() as checks:
        for chain in ("slots", "merged"):
            for k in range(n_photo + 6):
                table = copy.deepcopy(table0)
                table["op_idx"][:] = k
                before = {n: len(c.errors) for n, c in checks.items()}
                oamix_batch(imgs, gt, gv, shapes, cfg, draws=table, chain=chain)
                torch.cuda.synchronize()
                calls = {n: len(c.errors) - before[n] for n, c in checks.items()}
                if k == 1:
                    need = "hist256"
                elif k < n_photo:
                    need = None
                elif chain == "merged":
                    need = "merged_shift_rows"
                else:
                    need = "piecewise_shift_rows" if k < n_photo + 3 else "shear_rows"
                if need and not calls[need]:
                    raise AssertionError(f"op {k} on the {chain} chain did not run {need}")
                log(phase, f"op {k} in every slot, {chain} chain: checked in place {calls}")
    for n, c in checks.items():
        log(phase, f"{n} in the path: {len(c.errors)} calls, vs plain max_abs_err "
                   f"{max(c.errors):.3e}")


def phase_oamix():
    """OA-Mix alone at the flagship's shapes, on each chain: launch counts
    against the drawn table with no host sync, every op in place against
    the plain kernels, the merged chain against the slots chain, and the
    card against the CPU."""
    import torch
    from oadg_tpu_torch.ops.oamix_device import oamix_batch
    dev = torch.device("cuda", 0)
    cfg = flagship_oamix_cfg()
    rng = np.random.RandomState(5)
    imgs = torch.from_numpy(np.stack([request_image(rng) for _ in range(2)])).to(dev)
    gt = torch.from_numpy(seeded_gts(rng, 2, IMG_H, IMG_W)[0]).to(dev)
    gv = torch.ones((2, NUM_GTS), dtype=torch.bool, device=dev)
    shapes = np.array([[IMG_H, IMG_W]] * 2, np.float32)
    gen = torch.Generator().manual_seed(0)
    wrappers = oamix_wrappers()
    outs = {}
    for chain in ("slots", "merged"):
        oamix_batch(imgs, gt, gv, shapes, cfg, generator=gen, chain=chain)      # warm-up
        torch.cuda.synchronize()
        for wr in wrappers.values():
            wr.launches = 0
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = oamix_batch(imgs, gt, gv, shapes, cfg, generator=gen, chain=chain)
            enqueued = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = {k: wr.launches for k, wr in wrappers.items()}
        expected = expected_launches(out["draws"], cfg["version"], chain)
        log("oamix", f"oamix_batch ({cfg['version']}, {chain} chain, 2 images of "
                     f"{IMG_H}x{IMG_W}, 1 view each) under sync debug mode 'error': "
                     f"{wall:.3f} ms wall, {enqueued:.3f} ms to enqueue; launches {launched}, "
                     f"the table implies {expected}")
        if launched != expected:
            raise AssertionError(f"OA-Mix ({chain}) launched {launched}, the table implies "
                                 f"{expected}")
        aug = out["aug"]
        if aug.shape != (2, 1, IMG_H, IMG_W, 3) or aug.dtype != torch.uint8:
            raise AssertionError(f"aug {tuple(aug.shape)} {aug.dtype}")
        for key, n in (("multilevel", 2), ("oamix", 5)):
            boxes, valid = out[f"{key}_boxes"], out[f"{key}_valid"]
            if boxes.shape != (2, n, 4) or valid.dtype != torch.bool or not valid.any():
                raise AssertionError(f"{key} boxes {tuple(boxes.shape)} {valid.dtype}")
            b = boxes[valid]
            if not bool(((b[:, 0] >= 0) & (b[:, 1] >= 0) & (b[:, 2] <= IMG_W)
                         & (b[:, 3] <= IMG_H) & (b[:, 2] > b[:, 0])
                         & (b[:, 3] > b[:, 1])).all()):
                raise AssertionError(f"{key} boxes outside the image")
        changed = float((aug[:, 0] != imgs).float().mean())
        log("oamix", f"{chain}: aug (2, 1, {IMG_H}, {IMG_W}, 3) uint8, {100 * changed:.1f}% "
                     f"of values changed; multilevel valid "
                     f"{out['multilevel_valid'].sum().item()}, oamix valid "
                     f"{out['oamix_valid'].sum().item()}; boxes inside the image")
        outs[chain] = out

    # the merged chain against the slots chain on the slots run's table
    again = oamix_batch(imgs, gt, gv, shapes, cfg, draws=outs["slots"]["draws"],
                        chain="merged")
    diff = (again["aug"].int() - outs["slots"]["aug"].int()).abs()
    share = float((diff > 0).float().mean())
    log("oamix", f"merged vs slots chain on one table, 2 images of {IMG_H}x{IMG_W}: "
                 f"{100 * share:.5f}% of values differ (limit 0.01%), largest difference "
                 f"{int(diff.max())} (limit 1)")
    if share > 1e-4 or int(diff.max()) > 1:
        raise AssertionError(f"merged vs slots: {share} of values differ, max {diff.max()}")

    check_ops_in_place("oamix", imgs, gt, gv, shapes, cfg, outs["slots"]["draws"])

    # the card against the CPU on one table, 256x512, each chain
    h, w = 256, 512
    small = imgs[:1, :h, :w].contiguous()
    gt_s = torch.from_numpy(seeded_gts(rng, 1, h, w)[0])
    gv_s = torch.ones((1, NUM_GTS), dtype=torch.bool)
    draws = None
    for chain in ("slots", "merged"):
        card = oamix_batch(small, gt_s.to(dev), gv_s.to(dev), np.array([[h, w]], np.float32),
                           cfg, draws=draws, chain=chain,
                           generator=None if draws else torch.Generator().manual_seed(1))
        draws = card["draws"]
        cpu = oamix_batch(small.cpu(), gt_s, gv_s, np.array([[h, w]], np.float32), cfg,
                          draws=draws, chain=chain)
        diff = (card["aug"].cpu().int() - cpu["aug"].int()).abs()
        same = float((diff == 0).float().mean())
        log("oamix", f"{chain} chain, card vs CPU, one table on {h}x{w}: {100 * same:.4f}% "
                     f"of values equal (limit 99.5%), largest difference {int(diff.max())}; "
                     f"ops {sorted(set(draws['op_idx'].ravel().tolist()))}")
        if same < 0.995:
            raise AssertionError(f"OA-Mix ({chain}) card vs CPU: {same} of values equal")
        for key in ("multilevel_boxes", "multilevel_valid", "oamix_boxes", "oamix_valid"):
            if not torch.equal(card[key].cpu(), cpu[key]):
                raise AssertionError(f"OA-Mix ({chain}) card vs CPU: {key} differs")
    torch.cuda.empty_cache()


def request_image(rng):
    return rng.randint(0, 256, (IMG_H, IMG_W, 3), dtype=np.uint8)


DTYPES = ("f32", "bf16")


def torch_dtype(name):
    import torch
    return {"f32": torch.float32, "bf16": torch.bfloat16}[name]


class _EntryDtypes:
    """Stands in for a RoIAlign kernel wrapper on the main path: records the
    dtype of the level maps of each call, then launches the kernel (whose
    wrapper counts the launch)."""

    def __init__(self, kernel):
        self.kernel, self.dtypes = kernel, []

    def __call__(self, feats, *rest):
        self.dtypes.append(feats[0].dtype)
        return self.kernel(feats, *rest)


def phase_slice(rows):
    """3 timed requests per dtype; -> the two handles (f32, bf16)."""
    import torch
    from oadg_tpu_torch.apis import init_detector, prepare_image
    from oadg_tpu_torch.ops import roi_align
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_FWD, roi_align_multilevel_ref
    handles = {}
    for name in DTYPES:
        dtype = torch_dtype(name)
        t0 = time.perf_counter()
        handle = handles[name] = init_detector(str(FLAGSHIP), device="cuda", seed=0,
                                               dtype=dtype)
        log("slice", f"init_detector (R50-FPN, 8 classes, {name}, channels-last) in "
                     f"{time.perf_counter() - t0:.2f} s")
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("init_detector on the card left TF32 on")
        log("slice", "TF32 off for cuDNN convolutions and matmuls (build_detector)")
        rng = np.random.RandomState(1)
        handle.test(prepare_image(request_image(rng), handle.cfg, handle.device))
        torch.cuda.synchronize()                              # warm-up request
        images = [request_image(rng) for _ in range(3)]

        entry = _EntryDtypes(ROI_ALIGN_FWD)
        roi_align.ROI_ALIGN_FWD = entry
        ROI_ALIGN_FWD.launches = 0
        torch.cuda.reset_peak_memory_stats()
        latencies, results = [], []
        try:
            for img in images:
                t0 = time.perf_counter()
                out = handle.test(prepare_image(img, handle.cfg, handle.device))
                torch.cuda.synchronize()
                latencies.append((time.perf_counter() - t0) * 1e3)
                results.append(out)
        finally:
            roi_align.ROI_ALIGN_FWD = ROI_ALIGN_FWD
        launches = ROI_ALIGN_FWD.launches
        log("slice", f"{name}: 3 requests of {IMG_H}x{IMG_W}: latency ms "
                     f"{[round(x, 3) for x in latencies]}, median "
                     f"{statistics.median(latencies):.3f} ({nvidia_smi_line()}); "
                     f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
                     f"GiB (weights included); roi_align_fwd launches {launches} on maps of "
                     f"{sorted(set(map(str, entry.dtypes)))}")
        if launches != 3 or entry.dtypes != [dtype] * 3:
            raise AssertionError(f"{name}: roi_align_fwd launched {launches} times in 3 "
                                 f"requests, on maps {entry.dtypes}")
        rows[0]["launches_serving" if name == "f32" else "launches_serving_bf16"] = launches

        for dets, labels, valid in results:
            if tuple(dets.shape) != (1, 100, 5) or not torch.isfinite(dets).all():
                raise AssertionError(f"bad dets: shape {tuple(dets.shape)}")
            if int(valid.sum()) < 1:
                raise AssertionError("no valid detection")
            if not ((labels[valid] >= 0) & (labels[valid] < handle.num_classes)).all():
                raise AssertionError("label out of range")
        log("slice", f"{name}: dets (1, 100, 5) finite; valid rows per request "
                     f"{[int(v.sum()) for _, _, v in results]}")

        # The same request's RoI head on plain-RoIAlign features from the same
        # maps: a check of the kernel inside the path, not a fallback.
        with torch.inference_mode():
            batch = prepare_image(images[0], handle.cfg, handle.device)
            det = handle.model
            feats = det.extract_feat(batch["img"])
            cls_scores, bbox_preds = det.rpn_head(feats)
            boxes, _, _ = det.rpn_head.get_proposals(cls_scores, bbox_preds,
                                                     batch["img_shape"])
            rois = det.roi_head.proposals_to_rois(boxes)
            head = det.roi_head.bbox_head
            cls_k, reg_k, _ = head(det.roi_head.bbox_roi_extractor(feats, rois))
            ex = det.roi_head.bbox_roi_extractor
            cls_p, reg_p, _ = head(roi_align_multilevel_ref(
                feats[:len(ex.featmap_strides)], rois, 7, ex.featmap_strides,
                ex.sampling_ratio, ex.finest_scale))
        if feats[0].dtype != dtype:
            raise AssertionError(f"{name}: FPN maps are {feats[0].dtype}")
        for what, a, b in (("cls_score", cls_k, cls_p), ("bbox_pred", reg_k, reg_p)):
            check_close("slice", f"{name}: RoI head {what} kernel vs plain RoIAlign", a, b,
                        TOL_HEAD if name == "f32" else TOL_HEAD_BF16)
    return handles


def serving_profile(name, cfg=FLAGSHIP, tag="slice-profile"):
    """One request of the seeded ``cfg`` at ``name`` (after a warm-up)
    under torch.profiler: its wall time, the device's busy share and the
    kernels that take most of it. The request goes through
    ``prepare_image``. After every timed run (the profiler slows the host's
    launches for the rest of the process)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from oadg_tpu_torch.apis import init_detector, prepare_image
    handle = init_detector(cfg if isinstance(cfg, dict) else str(cfg), device="cuda", seed=0,
                           dtype=torch_dtype(name))
    img = request_image(np.random.RandomState(1))

    def request():
        handle.test(prepare_image(img, handle.cfg, handle.device))
        torch.cuda.synchronize()

    request()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(tag, f"{name}: profiled request {wall:.3f} ms wall, device busy {busy:.3f} ms "
             f"({100 * busy / wall:.1f}%; {nvidia_smi_line()})")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]:
        log(tag, f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} {e.key[:90]}")
    del handle
    torch.cuda.empty_cache()
    return busy / wall


def check_close(phase, name, got, want, tol):
    err = float((got.float().cpu() - want.float().cpu()).abs().max())
    lim = tol * max(float(want.float().abs().max()), 1e-6)
    log(phase, f"{name}: max_abs_err {err:.3e} (limit {lim:.3e}, "
               f"{err / max(float(want.float().abs().max()), 1e-6):.2e} of the largest)")
    if not err <= lim:
        raise AssertionError(f"{phase} {name} disagrees: {err} > {lim}")


def phase_reference(handles):
    """Each dtype's card model against the same seeded model on the CPU."""
    import torch
    from oadg_tpu_torch.apis import init_detector, prepare_image
    img = request_image(np.random.RandomState(2))[:256, :512]
    for name, handle in handles.items():
        tol = TOL_HEAD if name == "f32" else TOL_BF16_CARD
        cpu = init_detector(str(FLAGSHIP), device="cpu", seed=0, dtype=torch_dtype(name))
        bc = prepare_image(img, cpu.cfg, "cpu")
        bg = prepare_image(img, handle.cfg, handle.device)
        with torch.inference_mode():
            fc = cpu.model.extract_feat(bc["img"])
            fg = handle.model.extract_feat(bg["img"])
            for i, (a, b) in enumerate(zip(fg, fc)):
                check_close("reference", f"{name}: FPN level {i} card vs CPU", a, b, tol)
            boxes, _, _ = handle.model.rpn_head.get_proposals(
                *handle.model.rpn_head(fg), bg["img_shape"])
            rois = handle.model.roi_head.proposals_to_rois(boxes)
            outs = [m.roi_head.bbox_head(m.roi_head.bbox_roi_extractor(f, r))
                    for m, f, r in ((handle.model, fg, rois),
                                    (cpu.model, fc, rois.cpu()))]
        for what, a, b in zip(("cls_score", "bbox_pred"), *outs):
            check_close("reference", f"{name}: RoI head {what} card vs CPU", a, b, tol)


EVAL_IMAGES = 16
TOOL_VAL_IMAGES = 4     # the tools' val set (phases 7b, 7d, 8): the first 4 of the 16
PROFILE_IMAGES = 4      # the profiled test loop's images: the first 4 of the 16
STEADY_REPEATS = 4      # passes over the 16 files in the timed loop
CITYSCAPES_CATS = (24, 25, 26, 27, 28, 31, 32, 33)    # person .. bicycle


def write_cityscapes(root, n=EVAL_IMAGES, seed=0):
    """``n`` synthetic Cityscapes-like 1024x2048 RGB PNGs, written by the
    port's own encoder under ``root/leftImg8bit/``, and a COCO json of the 8
    Cityscapes classes with 6-10 boxes an image -> (ann_file, img_prefix).
    The pixels are a smooth colour texture (sinusoids, shifted per image) plus
    Gaussian noise of sigma 3, so that inflating them costs what a photograph
    costs (~3.7 MB a file)."""
    import json
    import os
    from concurrent.futures import ThreadPoolExecutor
    from oadg_tpu_torch.data.pipelines.image_io import imwrite
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "leftImg8bit")
    os.makedirs(img_dir)
    yy, xx = np.mgrid[0:IMG_H, 0:IMG_W]
    base = (np.sin(xx / 37.0) + np.cos(yy / 23.0)) * 60 + 128
    base = np.stack([base, np.roll(base, 17, 0), np.roll(base, 31, 1)], -1)
    images, annotations = [], []

    def write(i):
        r = np.random.RandomState(seed * 1000 + i)
        img = np.roll(base, (37 * i, 101 * i), (0, 1)) + r.normal(0, 3, base.shape)
        imwrite(os.path.join(img_dir, f"city_{i:03d}_leftImg8bit.png"),
                np.clip(img, 0, 255).astype(np.uint8))

    with ThreadPoolExecutor(8) as pool:              # zlib releases the GIL
        list(pool.map(write, range(n)))
    for i in range(n):
        images.append(dict(id=i, file_name=f"city_{i:03d}_leftImg8bit.png",
                           width=IMG_W, height=IMG_H))
        for _ in range(rng.randint(6, 11)):
            bw, bh = rng.uniform(16, 400), rng.uniform(16, 300)
            x, y = rng.uniform(0, IMG_W - bw), rng.uniform(0, IMG_H - bh)
            annotations.append(dict(id=len(annotations) + 1, image_id=i,
                                    category_id=int(rng.choice(CITYSCAPES_CATS)),
                                    bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0))
    names = ("person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle")
    ann_file = os.path.join(root, "instances_val.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=[dict(id=c, name=nm) for c, nm in
                                   zip(CITYSCAPES_CATS, names)]), f)
    return ann_file, img_dir + os.sep


class _HostTimer:
    """Stands in for a pipeline stage or the loader's collate: calls it and
    adds its host seconds (worker threads included) to ``seconds``."""

    def __init__(self, fn):
        import threading
        self.fn, self.seconds, self.calls = fn, 0.0, 0
        self.lock = threading.Lock()

    def __call__(self, x):
        t0 = time.perf_counter()
        out = self.fn(x)
        dt = time.perf_counter() - t0
        with self.lock:
            self.seconds += dt
            self.calls += 1
        return out


def jittered_detections(dataset, seed=0):
    """The dataset's non-crowd annotations as detections that miss a fifth
    of them, move the rest by 8% of their size, add seeded false positives
    and carry seeded scores with ties: a result that scores 0 < AP < 1."""
    rng = np.random.RandomState(seed)
    results = []
    for info in dataset.data_infos:
        per_cls = [np.zeros((0, 5), np.float32) for _ in dataset.CLASSES]

        def add(c, x, y, w, h):
            per_cls[c] = np.concatenate(
                [per_cls[c], np.asarray([[x, y, x + w, y + h, 0.0]], np.float32)])

        for a in dataset.coco.img_anns.get(info["id"], []):
            if (a["category_id"] in dataset.cat2label and not a.get("iscrowd", 0)
                    and rng.rand() >= 0.2):
                size = np.tile(a["bbox"][2:], 2)
                add(dataset.cat2label[a["category_id"]],
                    *(np.asarray(a["bbox"]) + rng.normal(0, 0.08, 4) * size))
        for _ in range(rng.randint(2, 8)):
            add(rng.randint(len(dataset.CLASSES)), rng.uniform(0, info["width"] - 40),
                rng.uniform(0, info["height"] - 40),
                *np.exp(rng.uniform(np.log(8), np.log(400), 2)))
        for d in per_cls:
            d[:, 4] = np.round(rng.uniform(0.05, 1, len(d)), 2)
        results.append(per_cls)
    return results


def gt_as_detections(dataset):
    """Every non-crowd annotation of the dataset as a detection of score 1."""
    results = []
    for info in dataset.data_infos:
        per_cls = [np.zeros((0, 5), np.float32) for _ in dataset.CLASSES]
        for a in dataset.coco.img_anns.get(info["id"], []):
            if a["category_id"] in dataset.cat2label and not a.get("iscrowd", 0):
                x, y, w, h = a["bbox"]
                c = dataset.cat2label[a["category_id"]]
                per_cls[c] = np.concatenate(
                    [per_cls[c], np.asarray([[x, y, x + w, y + h, 1.0]], np.float32)])
        results.append(per_cls)
    return results


def results_close(got, want):
    """Two images' per-class detection lists: per class the same number of
    detections, boxes within 1e-3 px and scores within 1e-4 relative ->
    (ok, largest box error, largest score error)."""
    box_err = score_err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return False, float("inf"), float("inf")
        if len(g):
            box_err = max(box_err, float(np.abs(g[:, :4] - w[:, :4]).max()))
            score_err = max(score_err, float((np.abs(g[:, 4] - w[:, 4]) / w[:, 4]).max()))
    return box_err <= 1e-3 and score_err <= 1e-4, box_err, score_err


def phase_evaluate(rows):
    """The test path: ``EVAL_IMAGES`` synthetic 1024x2048 Cityscapes PNGs
    through ``build_test_loader`` (the flagship's test pipeline, its
    ``workers_per_gpu`` threads, pinned batches) and ``single_gpu_test``, in
    float32 and in bfloat16, then ``dataset.evaluate(metric="bbox")``. B1
    must launch once per image on maps of the model's dtype; every image's
    results must equal ``DetectorHandle.test`` on the same image through
    ``prepare_image``; the ground truth as detections must score AP 1.0;
    the native matcher must give the numpy matcher's 12 numbers, on the
    model's results and on ``jittered_detections``;
    ``tools/torch_test.py`` must exit 0 on the same dataset. A loop over
    ``STEADY_REPEATS`` passes of the files is then timed. -> a function
    that profiles one loop per dtype (after every timed run)."""
    import os
    import tempfile
    import torch
    from oadg_tpu_torch.apis import (build_test_loader, load_model_state, prepare_image,
                                     single_gpu_test)
    from oadg_tpu_torch.apis.test import dets_to_results, fetch_dets
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.data import build_dataloader
    from oadg_tpu_torch.data.datasets import RepeatDataset
    from oadg_tpu_torch.data.pipelines.image_io import imread
    from oadg_tpu_torch.ops import roi_align
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_FWD
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    ann_file, img_prefix = write_cityscapes(tmp.name, EVAL_IMAGES)
    size = sum(os.path.getsize(os.path.join(img_prefix, f)) for f in os.listdir(img_prefix))
    log("evaluate", f"wrote {EVAL_IMAGES} PNGs of {IMG_H}x{IMG_W} ({size / EVAL_IMAGES / 1e6:.2f} "
                    f"MB each) and their COCO json in {time.perf_counter() - t0:.2f} s")
    cfg = load_config(str(FLAGSHIP))
    options = {"data.test.ann_file": ann_file, "data.test.img_prefix": img_prefix}
    cfg.merge_from_dict(options)
    loops = {}
    for name in DTYPES:
        dtype = torch_dtype(name)
        dataset, loader = build_test_loader(cfg, pin_memory=True)
        state = load_model_state(cfg, "none", device="cuda", dtype=dtype)
        handle = state["handle"]
        decode, pipeline = (_HostTimer(t) for t in dataset.pipeline.transforms)
        dataset.pipeline.transforms = [decode, pipeline]
        collate = loader.batcher = _HostTimer(loader.batcher)
        # a warm-up step on the first image's batch; then the second image
        # alone in one thread: the loader's stages without contention
        batch = collate([dataset[0]])
        state["test_fn"](batch)
        torch.cuda.synchronize()
        pinned = torch.from_numpy(batch["img"]).is_pinned()
        for t in (decode, pipeline, collate):
            t.seconds, t.calls = 0.0, 0
        collate([dataset[1]])
        alone = {k: t.seconds * 1e3 for k, t in
                 (("decode", decode), ("pipeline", pipeline), ("collate", collate))}
        for t in (decode, pipeline, collate):
            t.seconds, t.calls = 0.0, 0

        entry = _EntryDtypes(ROI_ALIGN_FWD)
        roi_align.ROI_ALIGN_FWD = entry
        ROI_ALIGN_FWD.launches = 0
        try:
            results = single_gpu_test(state, loader)
        finally:
            roi_align.ROI_ALIGN_FWD = ROI_ALIGN_FWD
        launches = ROI_ALIGN_FWD.launches
        log("evaluate", f"{name}: roi_align_fwd launches {launches} on maps of "
                        f"{sorted(set(map(str, entry.dtypes)))}")
        if (len(dataset) != EVAL_IMAGES or launches != EVAL_IMAGES
                or entry.dtypes != [dtype] * EVAL_IMAGES or not pinned):
            raise AssertionError(f"{name}: roi_align_fwd launched {launches} times for "
                                 f"{EVAL_IMAGES} images on maps {entry.dtypes}; pinned {pinned}")
        rows[0]["launches_evaluate" + ("" if name == "f32" else "_bf16")] = launches
        if len(results) != EVAL_IMAGES or not all(
                len(r) == 8 and all(np.isfinite(c).all() for c in r) for r in results):
            raise AssertionError(f"{name}: bad results")

        # each image's results against DetectorHandle.test on the same image
        worst = (0.0, 0.0)
        for i, info in enumerate(dataset.data_infos):
            img = imread(os.path.join(img_prefix, info["filename"]))
            out = handle.test(prepare_image(img, handle.cfg, handle.device))
            want = dets_to_results(*fetch_dets(*out), handle.num_classes)[0]
            ok, box_err, score_err = results_close(results[i], want)
            worst = (max(worst[0], box_err), max(worst[1], score_err))
            if not ok:
                raise AssertionError(
                    f"{name}: image {i}: the loop's detections {[len(g) for g in results[i]]} "
                    f"differ from DetectorHandle.test's {[len(w) for w in want]} (box error "
                    f"{box_err}, score error {score_err})")
        log("evaluate", f"{name}: every image's results equal DetectorHandle.test through "
                        f"prepare_image ({sum(len(c) for r in results for c in r)} detections; "
                        f"largest box error {worst[0]:.3e} px, score error {worst[1]:.3e} "
                        "relative)")

        # the timed loop: the files STEADY_REPEATS times over, one fill
        steady = build_dataloader(RepeatDataset(dataset, STEADY_REPEATS), samples_per_gpu=1,
                                  workers_per_gpu=loader.num_workers, shuffle=False,
                                  static_hw=collate.fn.static_hw, pin_memory=True)
        steady.batcher = collate
        for t in (decode, pipeline, collate):
            t.seconds, t.calls = 0.0, 0
        arrivals = []

        def timed(it):
            for b in it:
                arrivals.append(time.perf_counter())
                yield b

        n = len(steady.dataset)
        t0 = time.perf_counter()
        single_gpu_test(state, timed(steady))
        end = time.perf_counter()
        fill_ms = (arrivals[0] - t0) * 1e3
        images_per_s = n / (end - arrivals[0])
        marks = arrivals[::EVAL_IMAGES] + [end]
        passes = [EVAL_IMAGES / (b - a) for a, b in zip(marks, marks[1:])]
        per_image = {k: t.seconds * 1e3 / n for k, t in
                     (("decode", decode), ("pipeline", pipeline), ("collate", collate))}
        log("evaluate", f"{name}: {n} images ({STEADY_REPEATS} passes over the {EVAL_IMAGES} "
                        f"files), {loader.num_workers} loader threads, batches pinned: "
                        f"{pinned}; {images_per_s:.3f} images/s from the first batch to the "
                        f"last result; fill {fill_ms:.3f} ms (the first batch's request to "
                        f"its arrival); {n / (end - t0):.3f} images/s with the fill; per "
                        f"pass {', '.join(f'{r:.3f}' for r in passes)} images/s "
                        f"({nvidia_smi_line()})")
        log("evaluate", f"{name}: loader host ms per image in the loop (wall per call, "
                        f"{loader.num_workers} threads): decode {per_image['decode']:.3f}, "
                        f"pipeline {per_image['pipeline']:.3f}, collate "
                        f"{per_image['collate']:.3f}; one image alone in one thread: decode "
                        f"{alone['decode']:.3f}, pipeline {alone['pipeline']:.3f}, collate "
                        f"{alone['collate']:.3f} ({nvidia_smi_line()})")

        t0 = time.perf_counter()
        summary = dataset.evaluate(results, metric="bbox")
        eval_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plain = dataset.evaluate(results, metric="bbox", native=False)
        plain_ms = (time.perf_counter() - t0) * 1e3
        log("evaluate", f"{name}: COCO bbox summary {json.dumps(summary)} ({nvidia_smi_line()})")
        log("evaluate", f"{name}: evaluation of {EVAL_IMAGES} images {eval_ms:.3f} ms with the "
                        f"native matcher, {plain_ms:.3f} ms with the numpy one; the 12 numbers "
                        f"equal: {plain == summary} (host; {nvidia_smi_line()})")
        if plain != summary or len(summary) != 12:
            raise AssertionError(f"native {summary} != numpy {plain}")
        loops[name] = dict(state=state, loader=loader, images_per_s=images_per_s,
                           fill_ms=fill_ms, passes=passes, host_ms=per_image,
                           alone_ms=alone, eval_ms=eval_ms)

    gt = dataset.evaluate(gt_as_detections(dataset), metric="bbox")
    log("evaluate", f"ground truth as detections: bbox_mAP {gt['bbox_mAP']}, "
                    f"bbox_mAP_50 {gt['bbox_mAP_50']}")
    if gt["bbox_mAP"] != 1.0 or gt["bbox_mAP_50"] != 1.0:
        raise AssertionError(f"ground truth as detections scored {gt}")
    jittered = jittered_detections(dataset)
    native, plain = (dataset.evaluate(jittered, metric="bbox", native=m) for m in (True, False))
    log("evaluate", f"jittered ground truth with seeded scores: native {json.dumps(native)}; "
                    f"the numpy matcher's 12 numbers equal: {plain == native}")
    if plain != native or not 0 < native["bbox_mAP"] < 1:
        raise AssertionError(f"jittered ground truth: native {native} != numpy {plain}, "
                             "or AP not strictly between 0 and 1")

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_test.py"), str(FLAGSHIP),
                          "none", "--eval", "bbox", "--cfg-options",
                          *(f"{k}={v}" for k, v in options.items())],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    last = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    log("evaluate", f"tools/torch_test.py (f32, seeded weights) exit {res.returncode} in "
                    f"{time.perf_counter() - t0:.2f} s: {last}")
    if res.returncode != 0 or "bbox_mAP" not in last:
        raise AssertionError(f"tools/torch_test.py failed:\n{res.stdout[-2000:]}"
                             f"{res.stderr[-4000:]}")

    def profile():
        """One profiled loop over the first ``PROFILE_IMAGES`` images per
        dtype: the device's busy share (after every timed run: the profiler
        slows the host's launches for the rest of the process)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as torch_profile
        out = {}
        sub = load_config(str(FLAGSHIP))
        sub.merge_from_dict({"data.test.ann_file": _subset_json(
            ann_file, PROFILE_IMAGES, os.path.join(tmp.name, "profile.json")),
            "data.test.img_prefix": img_prefix})
        for name, loop in loops.items():
            _, loader = build_test_loader(sub, pin_memory=True)
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                single_gpu_test(loop["state"], loader)
                wall = (time.perf_counter() - t0) * 1e3
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)) / 1e3
            log("evaluate-profile", f"{name}: profiled loop of {PROFILE_IMAGES} images "
                                    f"{wall:.3f} ms wall, device busy {busy:.3f} ms "
                                    f"({100 * busy / wall:.1f}%; {nvidia_smi_line()})")
            out[name] = {k: loop[k] for k in ("images_per_s", "fill_ms", "passes", "host_ms",
                                              "alone_ms", "eval_ms")}
            out[name]["busy"] = busy / wall
        log("evaluate", f"per dtype ({nvidia_smi_line()}): {json.dumps(out)}")
        tmp.cleanup()

    profile.val = (ann_file, img_prefix)        # the training loop's val set
    return profile


def raw_train_batch(rng, h, w, device):
    """The training step's input: 2 seeded uint8 BGR images of h x w on the
    device with ``NUM_GTS`` seeded gts each, ``img_shape`` on the host (OA-Mix
    draws its boxes from it)."""
    import torch
    images = np.stack([rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(2)])
    gt, labels = seeded_gts(rng, 2, h, w)
    return {"img_raw": torch.from_numpy(images).to(device),
            "gt_bboxes": torch.from_numpy(gt).to(device),
            "gt_labels": torch.from_numpy(labels).to(device),
            "gt_valid": torch.ones((2, NUM_GTS), dtype=torch.bool, device=device),
            "img_shape": torch.tensor([[h, w]] * 2, dtype=torch.float32)}


def fixed_view_batch(rng, h, w, cfg, device, views=2):
    """2 images x ``views`` views, views-major, through ``prepare_image``:
    seeded uint8 images, each further view the image with seeded noise
    (fixed views, for the card-vs-CPU step), and 32 seeded gts, the same in
    every view."""
    import torch
    from oadg_tpu_torch.apis import prepare_image
    images = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(2)]
    noisy = [np.clip(im.astype(np.int16) + rng.randint(-24, 25, im.shape), 0, 255)
             .astype(np.uint8) for im in images]
    parts = [prepare_image(im, cfg, device) for im in images + noisy[:2 * (views - 1)]]
    gt, labels = seeded_gts(rng, 2, h, w)
    img = torch.cat([b["img"] for b in parts])
    if img.is_cuda:
        img = img.contiguous(memory_format=torch.channels_last)
    return {"img": img,
            "img_shape": torch.cat([b["img_shape"] for b in parts]),
            "gt_bboxes": torch.from_numpy(np.concatenate([gt] * views)).to(device),
            "gt_labels": torch.from_numpy(np.concatenate([labels] * views)).to(device),
            "gt_valid": torch.ones((2 * views, NUM_GTS), dtype=torch.bool, device=device)}


def build_trainer(device, cfg, preprocess=None, dtype=None):
    """The config's detector (the flagship: built for OA-DG training) with seeded random weights,
    SGD with the config's ``grad_clip`` and its LR schedule (a constant LR
    where it names none, as ATSS's and GFL's configs do: the runners of both
    packages read a missing ``lr_config`` so), through the port's entry
    points, in the compute ``dtype`` (None: float32)."""
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                       make_train_step)
    handle = init_detector(cfg, device=device, seed=0, num_views=cfg.get("num_views", 1),
                           dtype=dtype)
    steps_per_epoch = -(-CITYSCAPES_TRAIN_IMAGES // cfg["data"]["samples_per_gpu"])
    grad_clip = (cfg.get("optimizer_config") or {}).get("grad_clip")
    step = make_train_step(
        handle.model, build_optimizer(handle.model, cfg["optimizer"], grad_clip=grad_clip),
        build_lr_schedule(cfg.get("lr_config"), cfg["optimizer"]["lr"], steps_per_epoch),
        preprocess=preprocess)
    return handle.model, step


class _Checked:
    """Stands in for a kernel wrapper for one step: launches the kernel,
    then holds its result against the plain version on the same inputs, so
    that each kernel is checked inside the path at the path's own shapes.
    ``plain(feats, rois, *rest)`` returns the plain results and the scale of
    the limit. A float32 result within ``TOL_F32`` of the scale; with
    bfloat16 maps within ``TOL_BF16`` of it, plus one bfloat16 step of each
    value for B2's bfloat16 gradient (the rounding of its float32 sum)."""

    def __init__(self, name, kernel, plain):
        self.name, self.kernel, self.plain = name, kernel, plain
        self.calls = []                  # (R, maps' dtype, max abs error, limit, within)

    def __call__(self, feats, rois, *rest):
        import torch
        out = self.kernel(feats, rois, *rest)
        want, scale = self.plain(feats, rois, *rest)
        got = out if isinstance(out, list) else [out]
        want = want if isinstance(want, list) else [want]
        bf16 = feats[0].dtype == torch.bfloat16
        lim = (TOL_BF16 if bf16 else TOL_F32) * scale
        err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
        within = all(bool(((g.float() - w).abs()
                           <= lim + (2 ** -8 * w.abs() if g.dtype == torch.bfloat16 else 0)).all())
                     for g, w in zip(got, want))
        self.calls.append((rois.shape[0], feats[0].dtype, err, lim, within))
        return out


def _plain_fwd(feats, rois, *cfg):
    from oadg_tpu_torch.ops.roi_align import roi_align_multilevel_ref
    return (roi_align_multilevel_ref(feats, rois, *cfg),
            max(float(f.float().abs().max()) for f in feats))


def _plain_bwd(feats, rois, dy, *cfg):
    from oadg_tpu_torch.ops.roi_align import roi_align_multilevel_ref_backward
    want = roi_align_multilevel_ref_backward(dy, [f.shape for f in feats], rois, *cfg)
    return want, max(float(w.abs().max()) for w in want)


def _checked_roi_align():
    """Stand-ins for B1's and B2's wrappers that hold every call of a run to
    the plain versions (``_Checked``), installed in ``ops.roi_align``; ->
    (the checks, a function that puts the wrappers back)."""
    from oadg_tpu_torch.ops import roi_align
    real = (roi_align.ROI_ALIGN_FWD, roi_align.ROI_ALIGN_BWD)
    checks = (_Checked("roi_align_fwd", real[0], _plain_fwd),
              _Checked("roi_align_bwd", real[1], _plain_bwd))
    roi_align.ROI_ALIGN_FWD, roi_align.ROI_ALIGN_BWD = checks

    def restore():
        roi_align.ROI_ALIGN_FWD, roi_align.ROI_ALIGN_BWD = real

    return checks, restore


def phase_train(rows, name):
    """Training at ``name`` (f32 or bf16): one model, OA-Mix on either chain,
    warm-up and 3 timed steps each, launches against the drawn tables, one
    step with B1 and B2 checked in place. -> (per chain {"median_ms",
    "peak_gib"}, and ``profile()``, which profiles one step per chain and
    adds its "busy" share)."""
    import torch
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.engine import make_oadg_preprocess
    from oadg_tpu_torch.ops import roi_align
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
    dev = torch.device("cuda", 0)
    dtype = torch_dtype(name)
    cfg = load_config(FLAGSHIP)
    oamix_cfg = flagship_oamix_cfg()
    t0 = time.perf_counter()
    # one model and optimizer, OA-Mix on either chain: the same entry point
    # with ``chain`` set, switched between the two runs; the preprocess
    # emits the model's dtype, as the JAX package's train API builds it
    current = ["slots"]
    preprocess = {}
    model, step = build_trainer("cuda", cfg, lambda b, g: preprocess[current[0]](b, g),
                                dtype=dtype)
    preprocess.update({chain: make_oadg_preprocess(oamix_cfg, cfg["img_norm_cfg"],
                                                   out_dtype=model.dtype, chain=chain)
                       for chain in ("slots", "merged")})
    batch = raw_train_batch(np.random.RandomState(3), IMG_H, IMG_W, dev)
    log("train", f"{name}: flagship for training (num_views {cfg['num_views']}, "
                 f"{name} compute, float32 parameters, channels-last), OA-Mix preprocess "
                 f"({oamix_cfg['version']}, out_dtype {model.dtype}), and a uint8 batch of "
                 f"2 images of {IMG_H}x{IMG_W} in {time.perf_counter() - t0:.2f} s")
    params = dict(model.named_parameters())
    frozen = [k for k, p in params.items() if not p.requires_grad]
    if any(p.dtype != torch.float32 for p in params.values()):
        raise AssertionError(f"{name}: a parameter is not float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    wrappers = dict(roi_align_fwd=ROI_ALIGN_FWD, roi_align_bwd=ROI_ALIGN_BWD,
                    **oamix_wrappers())
    entries = dict(roi_align_fwd=_EntryDtypes(ROI_ALIGN_FWD),
                   roi_align_bwd=_EntryDtypes(ROI_ALIGN_BWD))
    out = {}
    for chain in ("slots", "merged"):
        current[0] = chain
        before = {k: p.detach().clone() for k, p in params.items()}
        step(batch, gen)                                       # warm-up step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for wr in wrappers.values():
            wr.launches = 0
        for e in entries.values():
            e.dtypes.clear()
        expected = dict(roi_align_fwd=6, roi_align_bwd=6,
                        **dict.fromkeys(oamix_wrappers(), 0))
        times, logs = [], []
        roi_align.ROI_ALIGN_FWD, roi_align.ROI_ALIGN_BWD = entries.values()
        try:
            for _ in range(3):
                t0 = time.perf_counter()
                logs.append(step(batch, gen))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                implied = expected_launches(preprocess[chain].draws, oamix_cfg["version"],
                                            chain)
                for k, n in implied.items():
                    expected[k] += n
        finally:
            roi_align.ROI_ALIGN_FWD, roi_align.ROI_ALIGN_BWD = ROI_ALIGN_FWD, ROI_ALIGN_BWD
        launched = {k: wr.launches for k, wr in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for i, lv in enumerate(logs):
            log("train", f"{name}, {chain} chain, step {i + 1}: " + ", ".join(
                f"{k} {float(v):.5f}" for k, v in lv.items()))
        median = statistics.median(times)
        log("train", f"{name}, {chain} chain, 3 steps: ms {[round(t, 3) for t in times]}, "
                     f"median {median:.3f}; max_memory_allocated {peak:.2f} GiB; "
                     f"launches {launched}; the tables imply {expected}")
        if launched != expected:
            raise AssertionError(f"3 steps ({name}, {chain}) launched {launched}, "
                                 f"not {expected}")
        for k, e in entries.items():
            if e.dtypes != [dtype] * 6:
                raise AssertionError(f"{name}: {k} entered with maps of {e.dtypes}")
        log("train", f"{name}, {chain} chain: roi_align_fwd and roi_align_bwd each entered "
                     f"6 times with {dtype} maps")
        idle = {"slots": {"merged_shift_rows"},
                "merged": {"shear_rows", "piecewise_shift_rows"}}[chain]
        unlaunched = [k for k, n in launched.items() if not n and k not in idle]
        if unlaunched:
            raise AssertionError(f"3 steps ({name}, {chain}) never launched {unlaunched}")
        for r in rows:
            r[f"launches_{chain}" + ("" if name == "f32" else "_bf16")] = launched[r["name"]]
        for lv in logs:
            if not all(bool(torch.isfinite(v).all()) and v.dtype == torch.float32
                       for v in lv.values()):
                raise AssertionError(f"a loss is not a finite float32: {lv}")
            if not float(lv["loss_cont"]) > 0:
                raise AssertionError("loss_cont is not positive")
        still = [k for k, p in params.items() if p.requires_grad
                 and torch.equal(p.detach(), before[k])]
        moved = [k for k in frozen if not torch.equal(params[k].detach(), before[k])]
        grads = {p.grad.dtype for p in params.values() if p.grad is not None}
        log("train", f"{name}, {chain} chain: {len(params) - len(frozen)} trainable "
                     f"parameters, {len(still)} unmoved; {len(frozen)} frozen (stem, layer1), "
                     f"{len(moved)} moved; parameters float32, gradients {sorted(map(str, grads))}")
        if still or moved or not frozen or grads != {torch.float32}:
            raise AssertionError(f"unmoved trainable {still[:5]}, moved frozen {moved[:5]}, "
                                 f"gradient dtypes {grads}")
        out[chain] = {"median_ms": median, "peak_gib": peak}
    # each kernel's launches on the path that runs it: the slots run's, and
    # the merged run's for the kernel that only the merged chain launches
    if name == "f32":
        for r in rows:
            r["launches"] = r["launches_slots"] or r["launches_merged"]
    log("train", f"{name}: step medians in this call ({nvidia_smi_line()}): slots chain "
                 f"{out['slots']['median_ms']:.3f} ms, merged chain "
                 f"{out['merged']['median_ms']:.3f} ms")

    # One more step with both kernels checked in place: B1's RoI features
    # and B2's level gradients against the plain versions on the same inputs
    # (the step's FPN maps, rois and dy).
    checks, restore = _checked_roi_align()
    try:
        step(batch, gen)
    finally:
        restore()
    torch.cuda.synchronize()
    for check in checks:
        for i, (r, maps, err, lim, within) in enumerate(check.calls):
            log("train", f"{name}: {check.name} call {i} in the step (R={r}, 4 images, "
                         f"{maps} maps): vs plain version max_abs_err {err:.3e} (limit "
                         f"{lim:.3e}{' + 2^-8 |value|' if check.name.endswith('bwd') and maps == torch.bfloat16 else ''})")
            if not within or maps != dtype:
                raise AssertionError(f"{check.name} in the step disagrees: {err} > {lim}")
        if len(check.calls) != 2:
            raise AssertionError(f"{len(check.calls)} {check.name} calls in a step")

    def profile():
        """One profiled step per chain (after every timed step of the run:
        the profiler slows the host's launches for the rest of the process)."""
        for chain in ("slots", "merged"):
            current[0] = chain
            out[chain]["busy"] = train_profile(step, batch, gen, chain, name)[0]

    return out, profile


TRAIN_LOOP_IMAGES = 4       # one epoch of the f32 tool run: 2 iterations of 2 images
TRAIN_LOOP_BF16_TIMES = 6   # RepeatDataset times of the bf16 run: 12 iterations
LOOP_KERNELS = ("roi_align_fwd", "roi_align_bwd", "fg_maps", "shear_rows",
                "piecewise_shift_rows", "hist256")        # B1-B6: the slots chain's path

# The f32 run of tools/torch_train.py as a subprocess: this prelude sets the
# kernel wrappers' launch counts to 0, records each step's OA-Mix table (op
# indices, depths, slot validity) and runs the tool as ``__main__`` with the
# arguments that follow; at its end it writes the counts and the tables to
# the JSON file named by LOOP_RECORD.
TOOL_PRELUDE = """
import json, os, runpy, sys
from oadg_tpu_torch.engine import preprocess
from oadg_tpu_torch.ops import fg_maps, hist, roi_align, warp
wrappers = dict(roi_align_fwd=roi_align.ROI_ALIGN_FWD, roi_align_bwd=roi_align.ROI_ALIGN_BWD,
                fg_maps=fg_maps.FG_MAPS, shear_rows=warp.SHEAR_ROWS,
                piecewise_shift_rows=warp.PIECEWISE_SHIFT_ROWS, hist256=hist.HIST256,
                merged_shift_rows=warp.MERGED_SHIFT_ROWS)
for w in wrappers.values():
    w.launches = 0
tables, real = [], preprocess.oamix_batch
def recording(*a, **k):
    out = real(*a, **k)
    tables.append({key: out["draws"][key].tolist() for key in ("op_idx", "depth", "ml_valid")})
    return out
preprocess.oamix_batch = recording
sys.argv = sys.argv[1:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    with open(os.environ["LOOP_RECORD"], "w") as f:
        json.dump(dict(launches={k: w.launches for k, w in wrappers.items()}, tables=tables), f)
"""


def run_tool(name, argv):
    """``tools/<name>.py``'s ``main(argv)`` in this process: the entry point
    and argument parsing a user's command line takes, without a process
    start (~10 s on the card machine). -> what ``main`` returns."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"{name}_tool", ROOT / "tools" / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.main(list(argv))


def loop_launches(tables, version, steps, val_images):
    """What a training loop of ``steps`` steps on the slots chain must launch,
    by its OA-Mix tables, plus B1 once per val image."""
    want = dict(roi_align_fwd=2 * steps + val_images, roi_align_bwd=2 * steps,
                **dict.fromkeys(oamix_wrappers(), 0))
    for t in tables:
        for k, n in expected_launches({k: np.asarray(v) for k, v in t.items()},
                                      version).items():
            want[k] += n
    return want


def read_log(work_dir):
    with open(Path(work_dir) / "log.json") as f:
        return [json.loads(line) for line in f]


def loop_rate(train_lines, images_per_step=2):
    """Images/s over a run's steps from its per-iteration log lines: the
    steps' ``time`` and every ``data_time`` but the first (the loader's fill)."""
    wall = sum(ln["time"] for ln in train_lines) + sum(ln["data_time"] for ln in train_lines[1:])
    return images_per_step * len(train_lines) / wall


class _TimedLoader:
    """Stands in for the runner's loader: yields its batches and notes the
    host clock at each arrival."""

    def __init__(self, loader):
        self.loader, self.arrivals = loader, []

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for b in self.loader:
            self.arrivals.append(time.perf_counter())
            yield b


def phase_train_loop(rows, val):
    """The training entry point on ``TRAIN_LOOP_IMAGES`` synthetic 1024x2048
    Cityscapes PNGs (``val``: ``TOOL_VAL_IMAGES`` of phase 5b's as the val set): the f32 run of
    ``tools/torch_train.py`` as a subprocess (2 epochs of 2 iterations, an
    evaluation after each, then ``--resume-from epoch_1.pth``), and a bf16
    ``train_detector`` run in this process (12 iterations). Launches against
    the drawn tables, the logs, the checkpoints, the rates and the loader's
    host ms per image. -> a function that profiles one bf16 iteration."""
    import os
    import shutil
    import tempfile
    import torch
    from oadg_tpu_torch.apis import init_detector, set_random_seed
    from oadg_tpu_torch.apis.train import build_runner
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.core.hook import Hook
    from oadg_tpu_torch.data import build_dataset
    from oadg_tpu_torch.engine import preprocess as preprocess_mod
    from oadg_tpu_torch.engine.runner import Checkpointer
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
    tmp = tempfile.TemporaryDirectory()
    t0 = t_phase = time.perf_counter()
    ann_file, img_prefix = write_cityscapes(os.path.join(tmp.name, "train"), TRAIN_LOOP_IMAGES,
                                            seed=1)
    log("train-loop", f"wrote {TRAIN_LOOP_IMAGES} training PNGs of {IMG_H}x{IMG_W} in "
                      f"{time.perf_counter() - t0:.2f} s; val set: {TOOL_VAL_IMAGES} of phase "
                      "5b's")
    options = {"data.train.times": 1, "data.train.dataset.ann_file": ann_file,
               "data.train.dataset.img_prefix": img_prefix, "data.val.ann_file": val[0],
               "data.val.img_prefix": val[1], "runner.max_epochs": 2, "log_config.interval": 1}
    version = flagship_oamix_cfg()["version"]
    steps = TRAIN_LOOP_IMAGES // 2

    # f32: tools/torch_train.py, 2 epochs with evaluation, launches counted
    work = os.path.join(tmp.name, "work")
    record = os.path.join(tmp.name, "record.json")
    argv = [str(ROOT / "tools" / "torch_train.py"), str(FLAGSHIP), "--work-dir", work,
            "--seed", "0", "--cfg-options", *(f"{k}={v}" for k, v in options.items())]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", TOOL_PRELUDE, *argv], cwd=ROOT,
                         env=dict(os.environ, LOOP_RECORD=record), capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"tools/torch_train.py failed:\n{res.stdout[-2000:]}"
                             f"{res.stderr[-4000:]}")
    with open(record) as f:
        rec = json.load(f)
    lines = read_log(work)
    train = [ln for ln in lines if ln["mode"] == "train"]
    vals = [ln for ln in lines if ln["mode"] == "val"]
    saves = [float(ln.rsplit(" in ", 1)[1].split()[0]) for ln in res.stderr.splitlines()
             if " saved " in ln]
    ckpts = {n: Checkpointer.load(os.path.join(work, f"epoch_{n}.pth"))["meta"] for n in (1, 2)}
    launched = rec["launches"]
    want = loop_launches(rec["tables"], version, 2 * steps, 2 * TOOL_VAL_IMAGES)
    log("train-loop", f"f32: tools/torch_train.py exit 0 in {wall:.2f} s; {len(train)} "
                      f"iterations logged, {len(vals)} evaluations; checkpoints "
                      f"{json.dumps(ckpts)}; launches {launched}; the tables and the val set "
                      f"imply {want}")
    if (len(train) != 2 * steps or [ln["iter"] for ln in train] != list(range(1, 2 * steps + 1))
            or len(vals) != 2 or any(len(v) != 14 for v in vals)
            or ckpts != {1: dict(epoch=1, iter=steps, seed=0),
                         2: dict(epoch=2, iter=2 * steps, seed=0)}
            or not all(math.isfinite(ln["loss"]) and ln["loss_cont"] > 0 for ln in train)):
        raise AssertionError(f"the f32 run's log or checkpoints are wrong: {lines} {ckpts}")
    if launched != want or not all(launched[k] for k in LOOP_KERNELS):
        raise AssertionError(f"the f32 training loop launched {launched}, not {want}")
    for r in rows:
        if r["name"] in launched:
            r["launches_train_loop"] = launched[r["name"]]
            r["launches"] += launched[r["name"]]
    f32 = dict(images_per_s=loop_rate(train), epoch2_images_per_s=loop_rate(train[steps:]),
               time=statistics.median(ln["time"] for ln in train),
               data_time=statistics.median(ln["data_time"] for ln in train[1:]),
               save_ms=statistics.median(saves), val=vals[-1])
    log("train-loop", f"f32: {f32['images_per_s']:.3f} images/s over the steps (time and "
                      f"data_time of the log, the fill apart), epoch 2 alone "
                      f"{f32['epoch2_images_per_s']:.3f}; median time {f32['time'] * 1e3:.3f} ms, "
                      f"data_time {f32['data_time'] * 1e3:.3f} ms; checkpoint save "
                      f"{f32['save_ms']:.3f} ms; evaluation {json.dumps(vals[-1])} "
                      f"({nvidia_smi_line()})")
    log("train-loop", "f32: per iteration, time / data_time ms " + ", ".join(
        f"{ln['time'] * 1e3:.1f} / {ln['data_time'] * 1e3:.1f}" for ln in train))

    # --resume-from epoch_1.pth: continues at iteration steps + 1
    resumed = os.path.join(tmp.name, "resumed")
    t0 = time.perf_counter()
    run_tool("torch_train", [argv[1], "--work-dir", resumed, "--seed", "0", "--no-validate",
                             "--resume-from", os.path.join(work, "epoch_1.pth"),
                             "--cfg-options", *(f"{k}={v}" for k, v in options.items())])
    torch.cuda.synchronize()
    again = read_log(resumed)
    meta = Checkpointer.load(os.path.join(resumed, "epoch_2.pth"))["meta"]
    log("train-loop", f"f32: --resume-from epoch_1.pth (in this process) in "
                      f"{time.perf_counter() - t0:.2f} "
                      f"s: iterations {[ln['iter'] for ln in again]} of epochs "
                      f"{sorted({ln['epoch'] for ln in again})}; epoch_2.pth meta {meta}")
    if ([ln["iter"] for ln in again] != list(range(steps + 1, 2 * steps + 1))
            or {ln["epoch"] for ln in again} != {2} or meta != dict(epoch=2, iter=2 * steps,
                                                                    seed=0)):
        raise AssertionError(f"the resumed run did not continue at iteration {steps}: {again}")
    shutil.rmtree(work)
    shutil.rmtree(resumed)

    # bf16: train_detector in this process, 12 iterations, timed
    cfg = load_config(FLAGSHIP)
    cfg.merge_from_dict(dict(options, **{"data.train.times": TRAIN_LOOP_BF16_TIMES,
                                         "runner.max_epochs": 1, "seed": 0}))
    set_random_seed(0)
    model = init_detector(cfg, device="cuda", seed=0, num_views=2, dtype=torch.bfloat16).model
    dataset = build_dataset(dict(cfg["data"]["train"]))
    stages = dataset.dataset.pipeline.transforms
    names = [type(t).__name__ for t in stages]
    timers = [_HostTimer(t) for t in stages]
    dataset.dataset.pipeline.transforms = timers
    runner = build_runner(model, dataset, cfg, work_dir=os.path.join(tmp.name, "bf16"))
    collate = runner.loader.batcher = _HostTimer(runner.loader.batcher)
    collate([dataset[0]])                          # one image alone, in one thread
    alone = {nm: t.seconds * 1e3 for nm, t in zip(names, timers)}
    alone["collate"] = collate.seconds * 1e3
    for t in timers + [collate]:
        t.seconds, t.calls = 0.0, 0
    timed = runner.loader = _TimedLoader(runner.loader)
    class Marks(Hook):                  # the host clock after each iteration
        def __init__(self):
            self.times = []

        def after_train_iter(self, runner, log_vars):
            self.times.append(time.perf_counter())

    marks = Marks()
    runner.hooks.append(marks)
    tables, real = [], preprocess_mod.oamix_batch

    def recording(*a, **k):
        out = real(*a, **k)
        tables.append(out["draws"])
        return out

    wrappers = dict(roi_align_fwd=ROI_ALIGN_FWD, roi_align_bwd=ROI_ALIGN_BWD, **oamix_wrappers())
    preprocess_mod.oamix_batch = recording
    for w in wrappers.values():
        w.launches = 0
    try:
        runner.run()
    finally:
        preprocess_mod.oamix_batch = real
    launched = {k: w.launches for k, w in wrappers.items()}
    n_steps = TRAIN_LOOP_BF16_TIMES * steps
    want = loop_launches([{k: t[k] for k in ("op_idx", "depth", "ml_valid")} for t in tables],
                         version, n_steps, 0)
    train = [ln for ln in read_log(runner.work_dir) if ln["mode"] == "train"]
    log("train-loop", f"bf16: train_detector, {n_steps} iterations: launches {launched}; the "
                      f"tables imply {want}")
    if launched != want or not all(launched[k] for k in LOOP_KERNELS):
        raise AssertionError(f"the bf16 training loop launched {launched}, not {want}")
    if len(train) != n_steps or not all(math.isfinite(ln["loss"]) for ln in train) or \
            runner.iter != n_steps or model.dtype != torch.bfloat16:
        raise AssertionError(f"the bf16 run's log is wrong: {train}")
    for r in rows:
        if r["name"] in launched:
            r["launches_train_loop_bf16"] = launched[r["name"]]
    n_images = 2 * n_steps
    bf16 = dict(images_per_s=n_images / (marks.times[-1] - timed.arrivals[0]),
                log_images_per_s=loop_rate(train),
                fill_ms=train[0]["data_time"] * 1e3,
                time=statistics.median(ln["time"] for ln in train),
                data_time=statistics.median(ln["data_time"] for ln in train[1:]),
                save_ms=runner.last_save_ms,
                host_ms={nm: t.seconds * 1e3 / max(t.calls, 1) for nm, t in zip(names, timers)})
    bf16["host_ms"]["collate"] = collate.seconds * 1e3 / max(2 * collate.calls, 1)
    bf16["alone_ms"] = alone
    log("train-loop", f"bf16: {bf16['images_per_s']:.3f} images/s from the first batch to the "
                      f"last step (fill {bf16['fill_ms']:.3f} ms apart), "
                      f"{bf16['log_images_per_s']:.3f} by the log's times; median time "
                      f"{bf16['time'] * 1e3:.3f} ms, data_time {bf16['data_time'] * 1e3:.3f} ms; "
                      f"checkpoint save {bf16['save_ms']:.3f} ms ({nvidia_smi_line()})")
    log("train-loop", "bf16: per iteration, time / data_time ms " + ", ".join(
        f"{ln['time'] * 1e3:.1f} / {ln['data_time'] * 1e3:.1f}" for ln in train))
    for what, ms in (("in the loop (4 threads, wall per call)", bf16["host_ms"]),
                     ("for one image alone in one thread", alone)):
        log("train-loop", f"bf16: loader host ms per training image {what}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in ms.items()) + f" ({nvidia_smi_line()})")
    log("train-loop", f"phase {time.perf_counter() - t_phase:.2f} s")
    batch = next(iter(timed.loader))

    def profile():
        """One profiled bf16 iteration (upload, step, the log's copy): the
        device's busy share."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as torch_profile
        from oadg_tpu_torch.engine.runner import fetch_log_vars, step_generator
        from oadg_tpu_torch.engine.train_step import upload_train_batch
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fetch_log_vars(runner.step(upload_train_batch(batch, runner.device),
                                       step_generator(0, runner.iter, runner.device)))
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)) / 1e3
        bf16["busy"] = busy / wall
        log("train-loop-profile", f"bf16: profiled iteration {wall:.3f} ms wall, device busy "
                                  f"{busy:.3f} ms ({100 * busy / wall:.1f}%; {nvidia_smi_line()})")
        log("train-loop", f"per dtype ({nvidia_smi_line()}): "
                          f"{json.dumps(dict(f32=f32, bf16=bf16))}")
        tmp.cleanup()

    profile.train = (ann_file, img_prefix)      # the data-parallel phase's train set
    return profile


STAGES = ("train_step: oamix", "forward_train: backbone+neck", "forward_train: rpn head+loss",
          "forward_train: proposals", "forward_train: roi head+loss",
          "train_step: backward", "train_step: sgd")


def train_profile(step, batch, gen, chain, dtype_name="f32", stages=STAGES,
                  tag="train-profile", nested=()):
    """One step (OA-Mix on ``chain``) under torch.profiler, read through the ``record_function``
    spans of ``forward_train`` and ``make_train_step``: per stage the host
    time of its span and the device time of the kernels launched in it, and
    the device's busy share of the step; ``nested`` spans (inside a stage,
    forward only) are read too and not counted twice. Autograd launches the backward's
    kernels from its own thread, outside the backward span, so the
    backward's device time is the sum over autograd's ``evaluate_function``
    events. -> the device's busy share of the step's wall time, and per stage
    its (host ms, device ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    host = {e.key: e for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    autograd = sum(e.device_time_total for k, e in host.items()
                   if k.startswith("autograd::engine::evaluate_function")) / 1e3
    spanned = 0.0
    spans = {}
    for name in stages + tuple(nested):
        if name not in host:
            raise AssertionError(f"the profiled step has no span {name!r}")
        dev_ms = autograd if name == "train_step: backward" else \
            host[name].device_time_total / 1e3
        spanned += 0 if name in nested else dev_ms
        spans[name] = (host[name].cpu_time_total / 1e3, dev_ms)
        log(tag, f"{dtype_name}, {chain} chain, {name}: host "
                 f"{host[name].cpu_time_total / 1e3:.3f} ms, "
                 f"device {dev_ms:.3f} ms ({100 * dev_ms / busy:.1f}% of busy)"
                 + (" (inside a stage)" if name in nested else ""))
    log(tag, f"profiled step ({dtype_name}, {chain} chain) {wall:.3f} ms wall, "
             f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%), of which "
             f"{busy - spanned:.3f} ms outside the stages")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        log(tag, f"  {e.self_device_time_total / 1e3:9.3f} ms "
                 f"x{e.count:<5d} {e.key[:90]}")
    return busy / wall, spans


def phase_train_reference(name, config=FLAGSHIP, tag="train-reference"):
    """One step's losses and gradients at ``name`` (f32 or bf16), CPU vs
    card, on 256x512 views of ``config``'s model (its ``num_views``)."""
    import torch
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.utils.draws import UniformDraws
    dev = torch.device("cuda", 0)
    dtype = torch_dtype(name)
    loss_tol, grad_tol = (1e-3, 1e-3) if name == "f32" else (TOL_BF16_LOSS, TOL_BF16_CARD)
    cfg = load_config(config)
    card, _ = build_trainer("cuda", cfg, dtype=dtype)
    cpu, _ = build_trainer("cpu", cfg, dtype=dtype)
    batch = fixed_view_batch(np.random.RandomState(4), 256, 512, cfg, "cpu",
                             views=cfg.get("num_views", 1))
    batch["img"] = batch["img"].to(dtype)
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    card_batch["img"] = card_batch["img"].contiguous(memory_format=torch.channels_last)

    # The card's proposals go to both: the sampler's draws are per candidate,
    # so proposals in another order (near-tied objectness of random weights)
    # would sample other rois. The CPU's own proposals are reported.
    proposals = {}
    card_props = card.rpn_head.get_proposals
    cpu_props = cpu.rpn_head.get_proposals

    def record(*args):
        proposals["card"] = card_props(*args)
        return proposals["card"]

    def replay(*args):
        proposals["cpu"] = cpu_props(*args)
        return tuple(t.cpu() for t in proposals["card"])

    card.rpn_head.get_proposals = record
    cpu.rpn_head.get_proposals = replay
    def one_step(model, b, draws):
        losses = model.forward_train(b, draws)
        sum(v for k, v in losses.items() if "loss" in k).backward()
        return losses, dict(model.named_parameters())

    draws = UniformDraws(torch.Generator().manual_seed(7))       # made on the CPU
    lc, pc = one_step(card, card_batch, draws)
    lh, ph = one_step(cpu, batch, UniformDraws(given=draws.drawn))
    (bc, _, vc), (bh, _, vh) = proposals["card"], proposals["cpu"]
    same = (vc.cpu() == vh) & ((bc.cpu() - bh).abs().max(-1).values < 1e-2)
    log(tag, f"{name}: CPU proposals equal to the card's in place: "
                           f"{int(same.sum())} of {int(vc.sum())} valid")
    for k in sorted(lc):
        if "loss" not in k:
            continue
        a, b = float(lc[k].detach()), float(lh[k].detach())
        err = abs(a - b) / max(abs(b), 1e-6)
        log(tag, f"{name}: {k}: card {a:.6f} CPU {b:.6f} rel err {err:.2e} "
                               f"(limit {loss_tol:.1e})")
        if not (err <= loss_tol and lc[k].dtype == torch.float32):
            raise AssertionError(f"{k} card vs CPU: {a} vs {b}")
    names = [k for k in ph if k.startswith(("rpn_head.rpn_conv.",
                                            "roi_head.bbox_head.fc_cls."))
             or (k.startswith("backbone.layer4.") and ".conv3." in k)]
    for k in names:
        want = ph[k].grad
        err = float((pc[k].grad.cpu() - want).abs().max())
        lim = grad_tol * float(want.abs().max())
        log(tag, f"{name}: grad {k} ({pc[k].grad.dtype}): max_abs_err "
                               f"{err:.3e} (limit {lim:.3e})")
        if not (err <= lim and pc[k].grad.dtype == torch.float32):
            raise AssertionError(f"grad {k} card vs CPU: {err} > {lim}")


BASELINE = ROOT / "configs/OA-DG/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py"
ROBUST_IMAGES = 1           # images of phase 5b's set in the robustness sweep
ROBUST_SEVERITY = 3


def _subset_json(ann_file, n, out):
    """The first ``n`` images of a COCO json and their annotations -> ``out``."""
    with open(ann_file) as f:
        ann = json.load(f)
    keep = {im["id"] for im in ann["images"][:n]}
    ann["images"] = ann["images"][:n]
    ann["annotations"] = [a for a in ann["annotations"] if a["image_id"] in keep]
    with open(out, "w") as f:
        json.dump(ann, f)
    return out


def _same_results(a, b):
    """Per image and class: equal bits, or within ``results_close``'s limits
    -> (within, bit-equal)."""
    bits = all(np.array_equal(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb))
    return bits or all(results_close(ra, rb)[0] for ra, rb in zip(a, b)), bits


def phase_robustness(rows, val):
    """The robustness path on ``ROBUST_IMAGES`` of phase 5b's PNGs (``val``):
    the host ms of each of the 19 corruptions at severity 3 on one
    1024x2048 image; ``tools/torch_test_robustness.py`` over the 15
    benchmark corruptions at severities 0 and 3 as a subprocess, in float32,
    B1 counted by ``TOOL_PRELUDE``; ``tools/torch_get_corrupted_dataset.py``
    for 2 corruptions at severity 1, fog's read back through ``--load-dataset
    corrupted`` against the on-the-fly cell; one cell twice; the loader's
    host ms per image split into decode, corrupt and pipeline."""
    import os
    import pickle
    import tempfile
    import torch
    sys.path.insert(0, str(ROOT / "tools"))
    from torch_test_robustness import cell_test_cfg
    from oadg_tpu_torch.apis import build_test_loader, load_model_state, single_gpu_test
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.data.pipelines.image_io import imread
    from oadg_tpu_torch.ops.corruptions import (BENCHMARK_CORRUPTIONS, CORRUPTIONS,
                                                corrupt_numpy, sample_seed)
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    ann_file = _subset_json(val[0], ROBUST_IMAGES, os.path.join(tmp.name, "robust.json"))
    img_prefix = val[1]
    options = {"data.test.ann_file": ann_file, "data.test.img_prefix": img_prefix}

    # each corruption alone on one image, in this process's one thread
    first = sorted(f for f in os.listdir(img_prefix) if f.endswith(".png"))[0]
    img = imread(os.path.join(img_prefix, first))
    host_ms = {}
    for name in CORRUPTIONS:
        t0 = time.perf_counter()
        out = corrupt_numpy(img, name, ROBUST_SEVERITY,
                            rng=np.random.RandomState(sample_seed(0, name, ROBUST_SEVERITY)))
        host_ms[name] = (time.perf_counter() - t0) * 1e3
        if out.shape != img.shape or out.dtype != np.uint8 or np.array_equal(out, img):
            raise AssertionError(f"{name}: corrupted image {out.shape} {out.dtype} unchanged "
                                 "or malformed")
    slowest = sorted(host_ms, key=host_ms.get, reverse=True)[:4]
    log("robustness", f"host ms per {IMG_H}x{IMG_W} image at severity {ROBUST_SEVERITY}, one "
                      f"thread: {json.dumps({k: round(v, 3) for k, v in host_ms.items()})}; "
                      f"sum {sum(host_ms.values()):.3f} ms, benchmark 15 "
                      f"{sum(host_ms[k] for k in BENCHMARK_CORRUPTIONS):.3f} ms; slowest "
                      f"{slowest} ({nvidia_smi_line()})")

    # the tool: 15 corruptions at severities 0 and 3, launches counted
    out_pkl = os.path.join(tmp.name, "robustness.pkl")
    record = os.path.join(tmp.name, "record.json")
    argv = [str(ROOT / "tools" / "torch_test_robustness.py"), str(FLAGSHIP), "none",
            "--corruptions", "benchmark", "--severities", "0", str(ROBUST_SEVERITY),
            "--out", out_pkl, "--cfg-options", *(f"{k}={v}" for k, v in options.items())]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", TOOL_PRELUDE, *argv], cwd=ROOT,
                         env=dict(os.environ, LOOP_RECORD=record), capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"tools/torch_test_robustness.py failed:\n{res.stdout[-2000:]}"
                             f"{res.stderr[-4000:]}")
    with open(record) as f:
        launched = json.load(f)["launches"]
    with open(out_pkl, "rb") as f:
        agg = pickle.load(f)
    lines = res.stdout.strip().splitlines()
    printed = [ln for ln in lines if ln.startswith(("P (clean", "mPC (", "rPC:"))]
    sweep = next((ln for ln in lines if ln.startswith("sweep:")), "")
    cells = 1 + len(BENCHMARK_CORRUPTIONS)
    want = dict(dict.fromkeys(launched, 0), roi_align_fwd=ROBUST_IMAGES * cells)
    log("robustness", f"tools/torch_test_robustness.py (f32, seeded weights, "
                      f"{ROBUST_IMAGES} images, 15 corruptions x severities 0 {ROBUST_SEVERITY}) "
                      f"exit 0 in {wall:.2f} s; {sweep}; launches {launched}; {printed}")
    if (launched != want or len(printed) != 3 or sorted(agg) != sorted(BENCHMARK_CORRUPTIONS)
            or any(sorted(agg[c]) != [0, ROBUST_SEVERITY] for c in agg)
            or not all(math.isfinite(v) for c in agg for cell in agg[c].values()
                       for v in cell.values())):
        raise AssertionError(f"the robustness tool launched {launched} (want {want}), printed "
                             f"{printed}, pickled {agg}")
    sweep_rate = float(sweep.rsplit(", ", 1)[1].split()[0])
    for r in rows:
        r["launches_robustness"] = launched.get(r["name"], 0)

    # a corrupted copy, read back: the same images and detections
    copy_root = os.path.join(tmp.name, "city-c")
    t0 = time.perf_counter()
    run_tool("torch_get_corrupted_dataset", [str(FLAGSHIP), "--out", copy_root, "--corruptions",
                                             "fog", "glass_blur", "--severities", "1",
                                             "--cfg-options",
                                             *(f"{k}={v}" for k, v in options.items())])
    log("robustness", f"tools/torch_get_corrupted_dataset.py (fog, glass_blur at severity 1, "
                      f"{ROBUST_IMAGES} images; in this process) in "
                      f"{time.perf_counter() - t0:.2f} s")
    cfg = load_config(str(FLAGSHIP))
    cfg.merge_from_dict(options)
    state = load_model_state(cfg, "none", device="cuda")

    def cell(corr, sev, mode=None, timers=False):
        c = load_config(str(FLAGSHIP))
        c.merge_from_dict(options)
        c["data"]["test"] = cell_test_cfg(c["data"]["test"], corr, sev, mode, copy_root)
        dataset, loader = build_test_loader(c, pin_memory=True)
        stages = None
        if timers:
            stages = [_HostTimer(t) for t in dataset.pipeline.transforms]
            dataset.pipeline.transforms = stages
        batches = list(loader)
        return batches, single_gpu_test(state, iter(batches)), stages

    for corr in ("fog",):       # the tool writes glass_blur too; its cell runs twice below
        (b_copy, r_copy, _), (b_fly, r_fly, _) = cell(corr, 1, "corrupted"), cell(corr, 1)
        same_img = all(np.array_equal(a["img"], b["img"]) for a, b in zip(b_copy, b_fly))
        within, bits = _same_results(r_copy, r_fly)
        log("robustness", f"{corr} severity 1: the corrupted copy's batches equal the "
                          f"on-the-fly cell's: {same_img}; detections within limits: "
                          f"{within}, bit-equal: {bits}")
        if not (same_img and within):
            raise AssertionError(f"{corr}: the corrupted copy and the on-the-fly cell differ")

    # one cell twice: byte-identical Corrupt outputs, equal detections; the
    # second run's stages timed in the loop
    (b1, r1, _), (b2, r2, stages) = (cell("glass_blur", ROBUST_SEVERITY),
                                     cell("glass_blur", ROBUST_SEVERITY, timers=True))
    same_img = all(np.array_equal(a["img"], b["img"]) for a, b in zip(b1, b2))
    within, bits = _same_results(r1, r2)
    per_image = {k: t.seconds * 1e3 / ROBUST_IMAGES
                 for k, t in zip(("decode", "corrupt", "pipeline"), stages)}
    log("robustness", f"glass_blur severity {ROBUST_SEVERITY} twice: batches byte-identical "
                      f"{same_img}; detections within limits {within}, bit-equal {bits}; loader "
                      f"host ms per image in the loop ({cfg['data']['workers_per_gpu']} threads): "
                      f"{json.dumps({k: round(v, 3) for k, v in per_image.items()})} "
                      f"({nvidia_smi_line()})")
    if not (same_img and within) or [t.calls for t in stages] != [ROBUST_IMAGES] * 3:
        raise AssertionError("two runs of one cell differ")
    del state
    torch.cuda.empty_cache()
    tmp.cleanup()
    out = dict(host_ms=host_ms, sweep_images_per_s=sweep_rate, loader_ms=per_image,
               printed=printed)
    log("robustness", f"phase {time.perf_counter() - t_phase:.2f} s; {json.dumps(out)}")
    return out


def baseline_batch(rng, h, w, cfg, device, dtype):
    """2 seeded uint8 images through ``prepare_image`` (normalized on the
    device), one view, ``NUM_GTS`` seeded gts each, cast to ``dtype``."""
    import torch
    from oadg_tpu_torch.apis import prepare_image
    parts = [prepare_image(rng.randint(0, 256, (h, w, 3), dtype=np.uint8), cfg, device)
             for _ in range(2)]
    gt, labels = seeded_gts(rng, 2, h, w)
    img = torch.cat([b["img"] for b in parts]).to(dtype)
    if img.is_cuda:
        img = img.contiguous(memory_format=torch.channels_last)
    return {"img": img, "img_shape": torch.cat([b["img_shape"] for b in parts]),
            "gt_bboxes": torch.from_numpy(gt).to(device),
            "gt_labels": torch.from_numpy(labels).to(device),
            "gt_valid": torch.ones((2, NUM_GTS), dtype=torch.bool, device=device)}


def phase_baseline(rows):
    """The plain Faster R-CNN (the flagship's ``_base_``: one view, no OA-Mix,
    the stock losses) trained on the card in float32 and bfloat16: one
    warm-up and 3 timed steps on 2 uint8 images of 1024x2048. B1 and B2 once
    per step; losses finite float32; frozen parameters unchanged; every
    trainable one but the top FPN output's moves."""
    import torch
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
    cfg = load_config(BASELINE)
    out = {}
    for name in DTYPES:
        dtype = torch_dtype(name)
        model, step = build_trainer("cuda", cfg, dtype=dtype)
        batch = baseline_batch(np.random.RandomState(5), IMG_H, IMG_W, cfg, "cuda", model.dtype)
        params = dict(model.named_parameters())
        frozen = [k for k, p in params.items() if not p.requires_grad]
        before = {k: p.detach().clone() for k, p in params.items()}
        gen = torch.Generator(device="cuda").manual_seed(0)
        step(batch, gen)                                       # warm-up step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ROI_ALIGN_FWD.launches = ROI_ALIGN_BWD.launches = 0
        times, logs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            logs.append(step(batch, gen))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launched = (ROI_ALIGN_FWD.launches, ROI_ALIGN_BWD.launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        median = statistics.median(times)
        log("baseline", f"{name}: plain Faster R-CNN R50-FPN, 3 steps on 2 images of "
                        f"{IMG_H}x{IMG_W}: ms {[round(t, 3) for t in times]}, median "
                        f"{median:.3f}; max_memory_allocated {peak:.2f} GiB; roi_align_fwd / "
                        f"roi_align_bwd launches {launched} ({nvidia_smi_line()})")
        log("baseline", f"{name}: last step " + ", ".join(
            f"{k} {float(v):.5f}" for k, v in logs[-1].items()))
        if launched != (3, 3):
            raise AssertionError(f"{name}: 3 baseline steps launched B1 / B2 {launched} times")
        if not all(bool(torch.isfinite(v).all()) and v.dtype == torch.float32
                   for lv in logs for v in lv.values()):
            raise AssertionError(f"{name}: a baseline loss is not a finite float32: {logs}")
        moved = [k for k in frozen if not torch.equal(params[k].detach(), before[k])]
        still = [k for k, p in params.items() if p.requires_grad
                 and torch.equal(p.detach(), before[k])]
        log("baseline", f"{name}: {len(frozen)} frozen parameters, {len(moved)} moved; "
                        f"{len(params) - len(frozen)} trainable, unmoved {still}")
        if moved or not frozen or any(not k.startswith("neck.fpn_convs.3.") for k in still):
            raise AssertionError(f"{name}: frozen moved {moved}, trainable unmoved {still}")
        for r in rows:
            r["launches_baseline_step" + ("" if name == "f32" else "_bf16")] = \
                dict(roi_align_fwd=launched[0], roi_align_bwd=launched[1]).get(r["name"], 0)
        if name == "f32":
            rows[0]["launches"] += launched[0]
            rows[1]["launches"] += launched[1]
        out[name] = dict(median_ms=median, peak_gib=peak)
        del model, step, batch, params, before
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- DWD ----
#
# The DWD OA-DG config: R101-DC5 Faster R-CNN (caffe style, layer4 at stride
# 16 dilated by 2, no neck), one RoIAlign level at stride 16 with C = 2048
# (B1 and B2 at 8 times the flagship's width), 7 classes, OA-Mix augmix.all
# of width 1 on a 736x1280 canvas, VOC-XML data of JPEG images.

DWD = ROOT / "configs/OA-DG/dwd/faster_rcnn_r101_dc5_1x_dwd_oadg.py"
DWD_STRIDES = (16,)
DWD_CHANNELS = 2048
DWD_IMG_H, DWD_IMG_W = 720, 1280        # a DWD image
DWD_CANVAS = (736, 1280)                # the train pipeline's static canvas
DWD_TRAIN_IMAGES = 19395                # Daytime-Sunny train split, for the LR schedule
DWD_EVAL_DOMAINS = ("daytime_clear", "night_sunny")
DWD_EVAL_IMAGES = 4                     # per domain
DWD_TWIN_FILES = 2                      # per domain, decoded by the numpy twin too
DWD_CLASSES = ("bus", "bike", "car", "motor", "person", "rider", "truck")


def dwd_cfg():
    """The DWD OA-DG config, its backbone seeded (the model-zoo
    ``init_cfg`` names weights this machine cannot reach)."""
    from oadg_tpu_torch.config import load_config
    cfg = load_config(str(DWD))
    cfg["model"]["backbone"]["init_cfg"] = None
    return cfg


def dwd_image(rng, h=DWD_IMG_H, w=DWD_IMG_W):
    """A smooth colour texture plus noise, shifted per image: compresses
    like a photograph."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / rng.uniform(20, 40)) + np.cos(yy / rng.uniform(15, 30))) * 60 + 128
    base = np.stack([base, np.roll(base, 17, 0), np.roll(base, 31, 1)], -1)
    return np.clip(base + rng.normal(0, 4, base.shape), 0, 255).astype(np.uint8)


def dwd_roi_cases(dev):
    """B1 and B2 at the DWD shapes, f32 and bf16 (the maps cast): B1 at
    one 64x128x2048 map (a 1024x2048 test canvas at stride 16) with R=1000;
    B2 at 4 maps of 46x80x2048 (the 736x1280 train canvas) with the step's
    R = 4 x 512 sampled + 4 x 10 random rois. -> (B1 cases, B2 cases)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(20)
    serve = torch.randn(1, DWD_CHANNELS, IMG_H // 16, IMG_W // 16, device=dev,
                        generator=gen).contiguous(memory_format=torch.channels_last)
    srois = torch.from_numpy(flagship_rois(np.random.RandomState(20))).to(dev)
    h, w = DWD_CANVAS
    train = torch.randn(TRAIN_IMAGES, DWD_CHANNELS, h // 16, w // 16, device=dev,
                        generator=gen).contiguous(memory_format=torch.channels_last)
    rng = np.random.RandomState(21)
    parts = [flagship_rois(rng, TRAIN_ROIS, b, h, w) for b in range(TRAIN_IMAGES)]
    parts += [flagship_rois(rng, RANDOM_ROIS, b, h, w) for b in range(TRAIN_IMAGES)]
    trois = torch.from_numpy(np.concatenate(parts)).to(dev)
    dy = torch.randn(trois.shape[0], DWD_CHANNELS, 7, 7, device=dev, generator=gen)
    fwd, bwd = [], []
    for name in DTYPES:
        dt = torch_dtype(name)
        fwd.append((f"dwd {name}, serving, 1 map 64x128x2048, R={srois.shape[0]}",
                    [serve.to(dt)], srois))
        bwd.append((f"dwd {name}, training, 4 maps 46x80x2048, R={trois.shape[0]}",
                    [train.to(dt)], trois, dy))
    return fwd, bwd


def phase_dwd_kernels(rows):
    """dwd-kernels: B1 and B2 at one level and C = 2048 against their plain
    versions, in f32 and bf16, each timed beside its bound; added to the
    rows as cases (their plain times from ``phase_profiled``)."""
    import torch
    dev = torch.device("cuda", 0)
    fwd, bwd = dwd_roi_cases(dev)
    by_name = {r["name"]: r for r in rows}
    for label, fs, rois in fwd:
        err, t, nbytes = check_fwd_case(label, fs, rois, DWD_STRIDES, "dwd-kernels")
        by_name["roi_align_fwd"]["cases"].append(case_row(label, err, t, nbytes))
    for label, fs, rois, dy in bwd:
        err, t, nbytes = check_bwd_case(label, fs, rois, dy, DWD_STRIDES, "dwd-kernels")
        by_name["roi_align_bwd"]["cases"].append(case_row(label, err, t, nbytes))
    del fwd, bwd
    torch.cuda.empty_cache()


def phase_dwd_serve(rows):
    """dwd-serve: ``init_detector`` on the DWD OA-DG config at full width
    (R101-DC5, C = 2048, FC 1024), seeded weights, per dtype: a warm-up and
    3 timed requests of a 720x1280 image through the test pipeline
    (``prepare_batch``: rescaled to 1024x1820 on the host, padded to
    1024x1824: one 64x114x2048 map), the model's share timed apart, B1 once a
    request on maps of the model's dtype, the RoI head on kernel vs plain
    RoIAlign features, and the card against the CPU on a 256x448 request
    (feature map and the RoI head on the card's first 200 proposals) with
    the flagship's reference tolerances. -> per dtype {median_ms, model_ms,
    peak_gib}."""
    import torch
    from oadg_tpu_torch.apis import init_detector, prepare_batch, prepare_image
    from oadg_tpu_torch.ops import roi_align
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_FWD, roi_align_multilevel_ref
    out = {}
    for name in DTYPES:
        dtype = torch_dtype(name)
        t0 = time.perf_counter()
        handle = init_detector(dwd_cfg(), device="cuda", seed=0, dtype=dtype)
        log("dwd-serve", f"init_detector (R101-DC5, C=2048, 7 classes, {name}) in "
                         f"{time.perf_counter() - t0:.2f} s")
        rng = np.random.RandomState(30)
        images = [dwd_image(rng) for _ in range(4)]
        handle.test(prepare_batch(handle, images[0]))
        torch.cuda.synchronize()                                  # warm-up request
        entry = _EntryDtypes(ROI_ALIGN_FWD)
        roi_align.ROI_ALIGN_FWD = entry
        ROI_ALIGN_FWD.launches = 0
        torch.cuda.reset_peak_memory_stats()
        latencies, model_ms, results = [], [], []
        try:
            for img in images[1:]:
                t0 = time.perf_counter()
                batch = prepare_batch(handle, img)
                t1 = time.perf_counter()
                results.append(handle.test(batch))
                torch.cuda.synchronize()
                latencies.append((time.perf_counter() - t0) * 1e3)
                model_ms.append((time.perf_counter() - t1) * 1e3)
        finally:
            roi_align.ROI_ALIGN_FWD = ROI_ALIGN_FWD
        launches, peak = ROI_ALIGN_FWD.launches, torch.cuda.max_memory_allocated() / 2 ** 30
        median = statistics.median(latencies)
        log("dwd-serve", f"{name}: 3 requests of {DWD_IMG_H}x{DWD_IMG_W}: latency ms "
                         f"{[round(x, 3) for x in latencies]}, median {median:.3f}, of which "
                         f"the test pipeline on the host (resize to 1024x1820, normalize, "
                         f"pad) {statistics.median(latencies) - statistics.median(model_ms):.3f} "
                         f"and the model (upload, simple_test, synchronize) "
                         f"{[round(x, 3) for x in model_ms]}, median "
                         f"{statistics.median(model_ms):.3f}; max_memory_allocated "
                         f"{peak:.2f} GiB (weights included); roi_align_fwd launches "
                         f"{launches} on maps of {sorted(set(map(str, entry.dtypes)))} "
                         f"({nvidia_smi_line()})")
        if launches != 3 or entry.dtypes != [dtype] * 3:
            raise AssertionError(f"dwd {name}: roi_align_fwd launched {launches} times in "
                                 f"3 requests, on maps {entry.dtypes}")
        rows[0]["launches_dwd_serve" + ("" if name == "f32" else "_bf16")] = launches
        for dets, labels, valid in results:
            if tuple(dets.shape) != (1, 100, 5) or not torch.isfinite(dets).all():
                raise AssertionError(f"dwd: bad dets {tuple(dets.shape)}")
            if not ((labels[valid] >= 0) & (labels[valid] < 7)).all():
                raise AssertionError("dwd: label out of range")
        with torch.inference_mode():
            batch = prepare_batch(handle, images[1])
            det = handle.model
            feats = det.extract_feat(batch["img"])
            boxes, _, _ = det.rpn_head.get_proposals(*det.rpn_head(feats), batch["img_shape"])
            rois = det.roi_head.proposals_to_rois(boxes)
            head = det.roi_head.bbox_head
            cls_k, reg_k, _ = head(det.roi_head.bbox_roi_extractor(feats, rois))
            cls_p, reg_p, _ = head(roi_align_multilevel_ref(feats, rois, 7, DWD_STRIDES, 2, 56))
        log("dwd-serve", f"{name}: feature maps {[tuple(f.shape) for f in feats]} "
                         f"{feats[0].dtype}; valid detections a request "
                         f"{[int(v.sum()) for _, _, v in results]}")
        if len(feats) != 1 or tuple(feats[0].shape[1:]) != (DWD_CHANNELS, 64, 114) \
                or feats[0].dtype != dtype:
            raise AssertionError(f"dwd {name}: maps {[tuple(f.shape) for f in feats]}")
        for what, a, b in (("cls_score", cls_k, cls_p), ("bbox_pred", reg_k, reg_p)):
            check_close("dwd-serve", f"{name}: RoI head {what} kernel vs plain RoIAlign",
                        a, b, TOL_HEAD if name == "f32" else TOL_HEAD_BF16)
        del feats, rois, cls_k, reg_k, cls_p, reg_p

        # the card against the CPU at full width on a 256x448 request
        # (normalized and padded, not resized)
        tol = TOL_HEAD if name == "f32" else TOL_BF16_CARD
        cpu = init_detector(dwd_cfg(), device="cpu", seed=0, dtype=dtype)
        img = images[2][:256, :448]
        bc, bg = prepare_image(img, cpu.cfg, "cpu"), prepare_image(img, handle.cfg, handle.device)
        with torch.inference_mode():
            fc, fg = cpu.model.extract_feat(bc["img"]), handle.model.extract_feat(bg["img"])
            check_close("dwd-serve", f"{name}: layer4 map {tuple(fg[0].shape)} card vs CPU",
                        fg[0], fc[0], tol)
            boxes, _, _ = handle.model.rpn_head.get_proposals(
                *handle.model.rpn_head(fg), bg["img_shape"])
            rois = handle.model.roi_head.proposals_to_rois(boxes)[:200]
            outs = [m.roi_head.bbox_head(m.roi_head.bbox_roi_extractor(f, r))
                    for m, f, r in ((handle.model, fg, rois), (cpu.model, fc, rois.cpu()))]
        for what, a, b in zip(("cls_score", "bbox_pred"), *outs):
            check_close("dwd-serve", f"{name}: RoI head {what} card vs CPU (200 rois)",
                        a, b, tol)
        out[name] = dict(median_ms=median, model_ms=statistics.median(model_ms),
                         peak_gib=peak)
        del handle, cpu, det, head, outs
        torch.cuda.empty_cache()
    return out


def dwd_train_batch(rng, device):
    """2 uint8 images of 720x1280 on the 736x1280 canvas, ``NUM_GTS``
    seeded gts each over the 7 classes."""
    import torch
    h, w = DWD_CANVAS
    images = np.zeros((2, h, w, 3), np.uint8)
    for i in range(2):
        images[i, :DWD_IMG_H, :DWD_IMG_W] = dwd_image(rng)
    gt, labels = seeded_gts(rng, 2, DWD_IMG_H, DWD_IMG_W)
    return {"img_raw": torch.from_numpy(images).to(device),
            "gt_bboxes": torch.from_numpy(gt).to(device),
            "gt_labels": torch.from_numpy(labels % 7).to(device),
            "gt_valid": torch.ones((2, NUM_GTS), dtype=torch.bool, device=device),
            "img_shape": torch.tensor([[DWD_IMG_H, DWD_IMG_W]] * 2, dtype=torch.float32)}


def phase_dwd_train(rows):
    """dwd-train: the OA-DG training step on the DWD config at full width,
    per dtype: OA-Mix ``augmix.all`` of width 1 on the card (slots chain),
    a warm-up and 3 timed steps of 2 uint8 images x 2 views on the 736x1280
    canvas; B1 and B2 twice a step on maps of the model's dtype, B3-B6 as the
    drawn tables imply, B7 never; losses finite float32, every trainable
    parameter moved, every frozen one (stem, ``layer1``, every BN) not; one
    step with B1 and B2 checked in place; the proposals' NMS at
    ``nms_pre=12000`` timed with its memory. Then OA-Mix alone on the DWD
    canvas with every op forced on each chain, B3-B7 checked in place.
    -> per dtype {median_ms, peak_gib, nms_ms, nms_peak_gib}."""
    import torch
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                       make_oadg_preprocess, make_train_step)
    from oadg_tpu_torch.ops import roi_align
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
    dev = torch.device("cuda", 0)
    cfg = dwd_cfg()
    oamix_cfg = dict(cfg["oamix_config"])
    oamix_cfg.pop("type")
    wrappers = dict(roi_align_fwd=ROI_ALIGN_FWD, roi_align_bwd=ROI_ALIGN_BWD,
                    **oamix_wrappers())
    out = {}
    for name in DTYPES:
        dtype = torch_dtype(name)
        handle = init_detector(cfg, device="cuda", seed=0, num_views=cfg["num_views"],
                               dtype=dtype)
        model = handle.model
        pre = make_oadg_preprocess(oamix_cfg, cfg["img_norm_cfg"], out_dtype=model.dtype)
        step = make_train_step(
            model, build_optimizer(model, cfg["optimizer"],
                                   grad_clip=cfg["optimizer_config"]["grad_clip"]),
            build_lr_schedule(cfg["lr_config"], cfg["optimizer"]["lr"],
                              -(-DWD_TRAIN_IMAGES // cfg["data"]["samples_per_gpu"])),
            preprocess=pre)
        batch = dwd_train_batch(np.random.RandomState(31), dev)
        params = dict(model.named_parameters())
        frozen = [k for k, p in params.items() if not p.requires_grad]
        gen = torch.Generator(device=dev).manual_seed(0)
        before = {k: p.detach().clone() for k, p in params.items()}
        step(batch, gen)                                           # warm-up step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for wr in wrappers.values():
            wr.launches = 0
        entries = dict(roi_align_fwd=_EntryDtypes(ROI_ALIGN_FWD),
                       roi_align_bwd=_EntryDtypes(ROI_ALIGN_BWD))
        expected = dict(roi_align_fwd=6, roi_align_bwd=6, **dict.fromkeys(oamix_wrappers(), 0))
        times, logs = [], []
        roi_align.ROI_ALIGN_FWD, roi_align.ROI_ALIGN_BWD = entries.values()
        try:
            for _ in range(3):
                t0 = time.perf_counter()
                logs.append(step(batch, gen))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                for k, n in expected_launches(pre.draws, oamix_cfg["version"]).items():
                    expected[k] += n
        finally:
            roi_align.ROI_ALIGN_FWD, roi_align.ROI_ALIGN_BWD = ROI_ALIGN_FWD, ROI_ALIGN_BWD
        launched = {k: wr.launches for k, wr in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        median = statistics.median(times)
        for i, lv in enumerate(logs):
            log("dwd-train", f"{name}, step {i + 1}: " + ", ".join(
                f"{k} {float(v):.5f}" for k, v in lv.items()))
        log("dwd-train", f"{name}: 3 steps of 2 images x 2 views on {DWD_CANVAS[0]}x"
                         f"{DWD_CANVAS[1]}: ms {[round(t, 3) for t in times]}, median "
                         f"{median:.3f}; max_memory_allocated {peak:.2f} GiB; launches "
                         f"{launched}; the tables imply {expected} ({nvidia_smi_line()})")
        if launched != expected or any(e.dtypes != [dtype] * 6 for e in entries.values()):
            raise AssertionError(f"dwd {name}: launched {launched}, not {expected}, or maps "
                                 f"of {[e.dtypes for e in entries.values()]}")
        unlaunched = [k for k, n in launched.items() if not n and k != "merged_shift_rows"]
        if unlaunched:
            raise AssertionError(f"dwd {name}: 3 steps never launched {unlaunched}")
        for r in rows:
            r["launches_dwd_step" + ("" if name == "f32" else "_bf16")] = launched[r["name"]]
        for lv in logs:
            if not all(bool(torch.isfinite(v).all()) and v.dtype == torch.float32
                       for v in lv.values()) or not float(lv["loss_cont"]) > 0:
                raise AssertionError(f"dwd {name}: a loss is not a finite float32: {lv}")
        still = [k for k, p in params.items() if p.requires_grad
                 and torch.equal(p.detach(), before[k])]
        moved = [k for k in frozen if not torch.equal(params[k].detach(), before[k])]
        bns = [k for k in params if ".bn" in k or "downsample.1" in k or k.startswith(
            "backbone.bn1")]
        log("dwd-train", f"{name}: {len(params) - len(frozen)} trainable parameters, "
                         f"{len(still)} unmoved; {len(frozen)} frozen (stem, layer1, "
                         f"{len(bns)} BN affines), {len(moved)} moved")
        if still or moved or not set(bns) <= set(frozen) or any(
                not k.startswith(("backbone.conv1", "backbone.layer1.")) and k not in bns
                for k in frozen):
            raise AssertionError(f"dwd {name}: unmoved trainable {still[:5]}, moved frozen "
                                 f"{moved[:5]}")

        checks, restore = _checked_roi_align()
        try:
            step(batch, gen)
        finally:
            restore()
        torch.cuda.synchronize()
        for check in checks:
            for i, (r, maps, err, lim, within) in enumerate(check.calls):
                log("dwd-train", f"{name}: {check.name} call {i} in the step (R={r}, 4 maps "
                                 f"of 46x80x2048, {maps}): vs plain version max_abs_err "
                                 f"{err:.3e} (limit {lim:.3e})")
                if not within or maps != dtype:
                    raise AssertionError(f"dwd: {check.name} in the step disagrees: "
                                         f"{err} > {lim}")
            if len(check.calls) != 2:
                raise AssertionError(f"dwd: {len(check.calls)} {check.name} calls in a step")

        # the proposals' NMS at nms_pre=12000 on the clean images' maps
        with torch.no_grad():
            views = pre(batch, gen)
            feats = model.extract_feat(views["img"][:2])
            heads = model.rpn_head(feats)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, _, valid = model.rpn_head.get_proposals(*heads, views["img_shape"][:2],
                                                       cfg["model"]["train_cfg"]["rpn_proposal"])
            torch.cuda.synchronize()
            nms_ms = (time.perf_counter() - t0) * 1e3
            nms_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        log("dwd-train", f"{name}: proposals of 2 images ({heads[0][0].shape[-2]}x"
                         f"{heads[0][0].shape[-1]}x15 anchors, nms_pre 12000, max_per_img "
                         f"2000): {nms_ms:.3f} ms, peak above the step's live tensors "
                         f"{nms_peak:.2f} GiB, {int(valid.sum())} proposals kept "
                         f"({nvidia_smi_line()})")
        out[name] = dict(median_ms=median, peak_gib=peak, nms_ms=nms_ms, nms_peak_gib=nms_peak)
        del model, step, handle, params, before, views, feats, heads
        torch.cuda.empty_cache()

    # OA-Mix alone on the DWD canvas: every op forced on each chain, B3-B7 in place
    from oadg_tpu_torch.ops.oamix_device import oamix_batch
    batch = dwd_train_batch(np.random.RandomState(32), dev)
    shapes = batch["img_shape"].numpy()
    first = oamix_batch(batch["img_raw"], batch["gt_bboxes"], batch["gt_valid"], shapes,
                        oamix_cfg, generator=torch.Generator().manual_seed(2))
    check_ops_in_place("dwd-train", batch["img_raw"], batch["gt_bboxes"], batch["gt_valid"],
                       shapes, oamix_cfg, first["draws"])
    torch.cuda.empty_cache()
    return out


def write_dwd_domains(root, seed=0):
    """``DWD_EVAL_IMAGES`` 720x1280 JPEGs a domain, written by the port's
    encoder (quality 95), with VOC XMLs of 4-8 objects over the 7 classes
    (every fourth difficult) -> per domain (name, img_prefix, ann_file)."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    from oadg_tpu_torch.data.pipelines.image_io import imwrite
    out = []
    for d, name in enumerate(DWD_EVAL_DOMAINS):
        dom = os.path.join(root, name, "VOC2007")
        for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
            os.makedirs(os.path.join(dom, sub))
        ids = [f"{name}_{i:03d}" for i in range(DWD_EVAL_IMAGES)]

        def write(i, ids=ids, dom=dom, d=d):
            rng = np.random.RandomState(seed * 1000 + d * 100 + i)
            imwrite(os.path.join(dom, "JPEGImages", f"{ids[i]}.jpg"), dwd_image(rng))
            objects = []
            for k in range(rng.randint(4, 9)):
                bw, bh = rng.uniform(16, 400), rng.uniform(16, 300)
                x, y = rng.uniform(0, DWD_IMG_W - bw), rng.uniform(0, DWD_IMG_H - bh)
                objects.append(
                    f"<object><name>{DWD_CLASSES[rng.randint(7)]}</name><difficult>"
                    f"{int(k % 4 == 3)}</difficult><bndbox><xmin>{x:.0f}</xmin><ymin>{y:.0f}"
                    f"</ymin><xmax>{x + bw:.0f}</xmax><ymax>{y + bh:.0f}</ymax></bndbox>"
                    "</object>")
            with open(os.path.join(dom, "Annotations", f"{ids[i]}.xml"), "w") as f:
                f.write(f"<annotation><filename>{ids[i]}.jpg</filename><size><width>"
                        f"{DWD_IMG_W}</width><height>{DWD_IMG_H}</height><depth>3</depth>"
                        f"</size>{''.join(objects)}</annotation>")

        with ThreadPoolExecutor(8) as pool:
            list(pool.map(write, range(DWD_EVAL_IMAGES)))
        ann = os.path.join(dom, "ImageSets", "Main", "test.txt")
        with open(ann, "w") as f:
            f.write("\n".join(ids) + "\n")
        out.append((name, dom + os.sep, ann))
    return out


def phase_dwd_eval(rows):
    """dwd-eval: a synthetic 2-domain VOC-XML set (``write_dwd_domains``).
    ``DWD_TWIN_FILES`` files a domain: ``decode_jpeg`` equals the numpy twin's; in this process
    the f32 model over each domain through ``build_test_loader(cfg,
    domain)`` and ``single_gpu_test``, B1 once an image, the loader's
    decode and pipeline host ms per image, images/s, per-domain mAP; the
    ground truth as detections scores mAP 1.0 in each domain; then
    ``tools/torch_test_dwd.py CONFIG none`` as a subprocess, counted by
    ``TOOL_PRELUDE``: exit 0, B1 once an image and no other kernel, the
    domains' metrics and ``mean_mAP`` in ``dwd_results.json``."""
    import os
    import tempfile
    import torch
    from oadg_tpu_torch.apis import build_test_loader, load_model_state, single_gpu_test
    from oadg_tpu_torch.ops import roi_align
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_FWD
    from oadg_tpu_torch.utils.jpeg import decode_jpeg
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    domains = write_dwd_domains(tmp.name)
    files = [os.path.join(p, "JPEGImages", f) for _, p, _ in domains
             for f in sorted(os.listdir(os.path.join(p, "JPEGImages")))]
    size = sum(os.path.getsize(f) for f in files) / len(files)
    log("dwd-eval", f"wrote {len(domains)} domains of {DWD_EVAL_IMAGES} JPEGs of "
                    f"{DWD_IMG_H}x{DWD_IMG_W} ({size / 1e6:.2f} MB each, encode_jpeg quality "
                    f"95) in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    twins = files[::DWD_EVAL_IMAGES // DWD_TWIN_FILES]      # the numpy twin is slow
    for f in twins:
        with open(f, "rb") as fh:
            data = fh.read()
        if not np.array_equal(decode_jpeg(data), decode_jpeg(data, native=False)):
            raise AssertionError(f"{f}: decode_jpeg differs from its numpy twin")
    log("dwd-eval", f"decode_jpeg of {len(twins)} of the {len(files)} files equals the numpy "
                    f"twin's ({time.perf_counter() - t0:.2f} s for both)")
    cfg = dwd_cfg()
    cfg["data"]["test"] = [dict(cfg["data"]["val"], domain=name, img_prefix=prefix,
                                ann_file=ann) for name, prefix, ann in domains]
    cfg_path = os.path.join(tmp.name, "dwd_eval.py")
    cfg.dump(cfg_path)
    state = load_model_state(cfg, "none", device="cuda")
    summary, per_image, launches = {}, {}, 0
    for name, prefix, ann in domains:
        dataset, loader = build_test_loader(cfg, cfg["data"]["test"][len(summary)],
                                            pin_memory=True)
        decode, pipeline = (_HostTimer(t) for t in dataset.pipeline.transforms)
        dataset.pipeline.transforms = [decode, pipeline]
        if not summary:                                 # warm-up request
            state["test_fn"](loader.batcher([dataset[0]]))
            torch.cuda.synchronize()
            decode.seconds = pipeline.seconds = 0.0
        ROI_ALIGN_FWD.launches = 0
        t0 = time.perf_counter()
        results = single_gpu_test(state, loader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches += ROI_ALIGN_FWD.launches
        if ROI_ALIGN_FWD.launches != len(dataset) or len(results) != DWD_EVAL_IMAGES:
            raise AssertionError(f"dwd {name}: B1 launched {ROI_ALIGN_FWD.launches} times "
                                 f"for {len(dataset)} images")
        metrics = dataset.evaluate(results)
        gt = []
        for i in range(len(dataset)):
            a = dataset.get_ann_info(i)
            per = [np.zeros((0, 5), np.float32) for _ in DWD_CLASSES]
            for box, lab in zip(a["bboxes"], a["labels"]):
                per[int(lab)] = np.concatenate([per[int(lab)], np.r_[box, 1.0][None]]
                                               ).astype(np.float32)
            gt.append(per)
        gt_map = dataset.evaluate(gt)["mAP"]
        per_image[name] = dict(images_per_s=len(dataset) / wall,
                               decode_ms=decode.seconds * 1e3 / len(dataset),
                               pipeline_ms=pipeline.seconds * 1e3 / len(dataset))
        summary[name] = metrics
        log("dwd-eval", f"{name}: {len(dataset)} images at {per_image[name]['images_per_s']:.3f} "
                        f"images/s ({loader.num_workers} loader threads); loader host ms per "
                        f"image: decode {per_image[name]['decode_ms']:.3f}, pipeline "
                        f"{per_image[name]['pipeline_ms']:.3f}; mAP {metrics['mAP']} (seeded "
                        f"weights); ground truth as detections mAP {gt_map} "
                        f"({nvidia_smi_line()})")
        if gt_map != 1.0 or set(metrics) != {"mAP"} | {f"AP_{c}" for c in DWD_CLASSES}:
            raise AssertionError(f"dwd {name}: ground truth scored {gt_map}, keys {set(metrics)}")
    rows[0]["launches_dwd_eval"] = launches
    del state
    torch.cuda.empty_cache()

    record = os.path.join(tmp.name, "record.json")
    out_dir = os.path.join(tmp.name, "out")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", TOOL_PRELUDE,
                          str(ROOT / "tools" / "torch_test_dwd.py"), cfg_path, "none",
                          "--out-dir", out_dir], cwd=ROOT,
                         env=dict(os.environ, LOOP_RECORD=record), capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"tools/torch_test_dwd.py failed:\n{res.stdout[-2000:]}"
                             f"{res.stderr[-4000:]}")
    with open(record) as f:
        launched = json.load(f)["launches"]
    with open(os.path.join(out_dir, "dwd_results.json")) as f:
        dumped = json.load(f)
    want = dict(dict.fromkeys(launched, 0), roi_align_fwd=len(files))
    log("dwd-eval", f"tools/torch_test_dwd.py (f32, seeded weights) exit 0 in {wall:.2f} s: "
                    f"launches {launched}; dwd_results.json {json.dumps(dumped)}")
    # the tool's own process picks its own cuDNN algorithms: its metrics
    # are held to this process's keys, and to its mAPs within 1e-3
    if launched != want or list(dumped) != [*DWD_EVAL_DOMAINS, "mean_mAP"] or any(
            set(dumped[d]) != set(summary[d]) or abs(dumped[d]["mAP"] - summary[d]["mAP"]) > 1e-3
            for d in DWD_EVAL_DOMAINS):
        raise AssertionError(f"tools/torch_test_dwd.py launched {launched}, not {want}, or "
                             f"wrote {dumped}, not {summary}")
    tmp.cleanup()
    return per_image


def phase_dwd(rows):
    """The DWD slice's paths: serving, the training step and the test tool,
    each driven with the kernels' counts set to 0 just before it; the
    main-path launches (f32 step, f32 requests, the in-process test loop)
    are added to each row's ``launches``. -> their numbers."""
    out = {"serve": phase_dwd_serve(rows), "train": phase_dwd_train(rows),
           "eval": phase_dwd_eval(rows)}
    for r in rows:
        r["launches"] += r["launches_dwd_step"] + r.get(
            "launches_dwd_serve", 0) + r.get("launches_dwd_eval", 0)
    return out


# --------------------------------------------------------------- YOLO ----
#
# The OA-DG YOLOv3 config (configs/OA-DG/cityscapes/yolov3_d53_mstrain-1024_20e_oadg.py):
# Darknet-53 with its BNs in eval mode (norm_eval), YOLOV3Neck and
# YOLOV3HeadCont with live BNs, 8 classes; OA-Mix on every view
# (keep_orig=False) over the SSD-style float32 train pipeline; the config's 8
# images a card x 2 views on a 1024x1024 canvas; the test pipeline resizes a
# 1024x2048 image to 512x1024.

YOLO = ROOT / "configs/OA-DG/cityscapes/yolov3_d53_mstrain-1024_20e_oadg.py"
YOLO_CANVAS = 1024                      # the train pipeline's static canvas
YOLO_BATCH = 8                          # the config's samples_per_gpu
YOLO_BF16_DET_FLOOR = 0.6               # the bf16 card's detections the bf16 CPU holds
# float32 gradients from the float64 step, each as its distance's norm over
# the float64 gradient's norm: every one within YOLO_F32_LEAF, their median
# within YOLO_F32_MEDIAN. The x86 CPU's float32 step at 128x128 reads a
# median of 2.6e-3, at worst 4.6e-3, the H100's 5.6e-3 and 2.1e-2
# (bbox_head.convs_bridge.0.conv: 2 of its BN's 65,536 outputs change sign
# from the float64 step's); planted faults read, median / worst:
# the live BNs' statistics detached 2.8 / 19.7, normalized by the unbiased
# variance 0.22 / 0.31, LeakyReLU slope 0.11 0.91 / 1.4, live BNs on the
# stored statistics 1.0 / 73.7. (The largest entry's distance over the
# largest magnitude is no fit: where a LeakyReLU input near 0 changes sign,
# a few entries of one gradient move by a large share of it.)
YOLO_F32_LEAF = 0.1
YOLO_F32_MEDIAN = 2e-2
# bf16 gradients from the f32 step, as ``leaf_distances``: the card's median
# within YOLO_BF16_MEDIAN_RATIO times the bf16 CPU step's. At 128x128 the
# bf16 step is rounding-dominated (the x86 CPU's: median 0.77, cosine 0.80
# to f32); LeakyReLU slope 0.01 in bf16 reads 1.58 everywhere, 1.54 in the
# neck. Faults of precision alone read as clean here: they are held on the
# CPU against JAX's bf16 step (tests/test_torch_yolo_slice.py).
YOLO_BF16_MEDIAN_RATIO = 1.5
YOLO_TOOL_IMAGES = 8                    # the tool run: 1 step of the config's batch an epoch
YOLO_LOSSES = ("loss_cls", "loss_conf", "loss_xy", "loss_wh", "loss_csconf", "loss_cscls",
               "loss_cont")


def yolo_cfg():
    """The OA-DG YOLOv3 config, its backbone seeded (``init_cfg`` names
    model-zoo weights this machine cannot reach)."""
    from oadg_tpu_torch.config import load_config
    cfg = load_config(str(YOLO))
    cfg["model"]["backbone"]["init_cfg"] = None
    return cfg


def yolo_oamix_cfg(cfg):
    oamix_cfg = dict(cfg["oamix_config"])
    oamix_cfg.pop("type")
    return oamix_cfg


def yolo_train_batch(rng, n, device):
    """``n`` images as the SSD-style pipeline hands them to the collate:
    float32 BGR values in [0, 255] (``PhotoMetricDistortion``'s output), each
    ``keep_ratio``-resized into the 1024x1024 canvas (a long side of 1024 or
    800-1024, the short side 55-100% of it) and zero-padded, with
    ``NUM_GTS`` seeded gts inside its own extent; ``img_shape`` on the host."""
    import torch
    c = YOLO_CANVAS
    img = np.zeros((n, c, c, 3), np.float32)
    shapes, gts, labels = [], [], []
    for i in range(n):
        long = c if i % 2 == 0 else int(rng.randint(800, c + 1))
        short = int(long * rng.uniform(0.55, 1.0))
        h, w = (short, long) if i % 3 else (long, short)
        img[i, :h, :w] = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        gt, lab = seeded_gts(rng, 1, h, w)
        shapes.append((h, w))
        gts.append(gt[0])
        labels.append(lab[0])
    return {"img_raw": torch.from_numpy(img).to(device),
            "gt_bboxes": torch.from_numpy(np.stack(gts)).to(device),
            "gt_labels": torch.from_numpy(np.stack(labels)).to(device),
            "gt_valid": torch.ones((n, NUM_GTS), dtype=torch.bool, device=device),
            "img_shape": torch.tensor(shapes, dtype=torch.float32)}


def _match_dets(a, b, box_tol, score_tol):
    """The share of ``a``'s valid detections (dets, labels, valid of one
    image) that ``b`` holds: the same label, the box within ``box_tol`` px
    and the score within ``score_tol``."""
    (da, la, va), (db, lb, vb) = [tuple(t[0].float().cpu() for t in x) for x in (a, b)]
    da, la = da[va.bool()], la[va.bool()]
    db, lb = db[vb.bool()], lb[vb.bool()]
    if not len(da):
        return 1.0
    close = ((da[:, None, :4] - db[None, :, :4]).abs().max(-1).values <= box_tol) & \
        ((da[:, None, 4] - db[None, :, 4]).abs() <= score_tol) & (la[:, None] == lb[None, :])
    return float(close.any(1).float().mean())


def phase_yolo_serve(rows):
    """yolo-serve, per dtype: ``init_detector`` on the OA-DG YOLOv3 config
    (seeded weights), a warm-up and 3 timed requests of a 1024x2048 uint8
    image through the config's test pipeline (``prepare_batch``: 512x1024)
    and ``DetectorHandle.test``; then the card against the same seeded model
    on the CPU on a 256x512 request: the neck's outputs, the head's maps
    and the detections. -> {dtype: numbers}."""
    import torch
    from oadg_tpu_torch.apis import init_detector, prepare_batch, prepare_image
    cfg = yolo_cfg()
    out = {}
    for name in DTYPES:
        dtype = torch_dtype(name)
        t0 = time.perf_counter()
        handle = init_detector(cfg, device="cuda", seed=0, dtype=dtype)
        log("yolo-serve", f"init_detector (Darknet-53, YOLOV3Neck, YOLOV3HeadCont, 8 classes, "
                          f"{name}, channels-last) in {time.perf_counter() - t0:.2f} s")
        rng = np.random.RandomState(41)
        handle.test(prepare_batch(handle, request_image(rng)))
        torch.cuda.synchronize()                                  # warm-up request
        images = [request_image(rng) for _ in range(3)]
        torch.cuda.reset_peak_memory_stats()
        walls, models, results = [], [], []
        for img in images:
            t0 = time.perf_counter()
            batch = prepare_batch(handle, img)
            t1 = time.perf_counter()
            res = handle.test(batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            walls.append((t2 - t0) * 1e3)
            models.append((t2 - t1) * 1e3)
            results.append(res)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        shape = tuple(batch["img"].shape)
        out[name] = dict(median_ms=statistics.median(walls),
                         model_ms=statistics.median(models), peak_gib=peak)
        log("yolo-serve", f"{name}: 3 requests of {IMG_H}x{IMG_W} (input {shape}): latency ms "
                          f"{[round(x, 3) for x in walls]}, median {out[name]['median_ms']:.3f}; "
                          f"the model's share (test alone) median {out[name]['model_ms']:.3f}; "
                          f"max_memory_allocated {peak:.2f} GiB (weights included) "
                          f"({nvidia_smi_line()})")
        for dets, labels, valid in results:
            if tuple(dets.shape) != (1, 100, 5) or not torch.isfinite(dets).all() or \
                    int(valid.sum()) < 1 or not ((labels[valid] >= 0) & (labels[valid] < 8)).all():
                raise AssertionError(f"yolo {name}: bad detections {tuple(dets.shape)}")
        if shape[2:] != (512, 1024) or handle.num_classes != 8:
            raise AssertionError(f"yolo {name}: the test pipeline gave {shape}")

        # the card against the same seeded model on the CPU, 256x512
        cpu = init_detector(cfg, device="cpu", seed=0, dtype=dtype)
        img = request_image(np.random.RandomState(42))[:256, :512]
        bc, bg = prepare_image(img, cfg, "cpu"), prepare_image(img, cfg, handle.device)
        tol = TOL_HEAD if name == "f32" else TOL_BF16_CARD
        t0 = time.perf_counter()
        with torch.inference_mode():
            fc = cpu.model.extract_feat(bc["img"].to(dtype))
            fg = handle.model.extract_feat(bg["img"].to(dtype))
            for i, (a, b) in enumerate(zip(fg, fc)):
                check_close("yolo-serve", f"{name}: neck level {i} card vs CPU", a, b, tol)
            mg, mc = handle.model.bbox_head(fg), cpu.model.bbox_head(fc)
            for i, (a, b) in enumerate(zip(mg[0] + mg[1], mc[0] + mc[1])):
                check_close("yolo-serve", f"{name}: head map {i} card vs CPU", a, b, tol)
            dg = handle.model.bbox_head.get_bboxes(mg, bg["img_shape"], bg["scale_factor"])
            dc = cpu.model.bbox_head.get_bboxes(mc, bc["img_shape"], bc["scale_factor"])
        matched = _match_dets(dg, dc, 1e-2 if name == "f32" else 2.0,
                              1e-4 if name == "f32" else 2 ** -6)
        log("yolo-serve", f"{name}: detections card vs CPU: {int(dg[2].sum())} and "
                          f"{int(dc[2].sum())} valid, {100 * matched:.1f}% of the card's held by "
                          f"the CPU's (label, box and score); CPU side "
                          f"{time.perf_counter() - t0:.2f} s")
        # bf16: the card's and the CPU's maps are ~1e-2 of the largest apart
        # (bf16 rounding through 75 convolutions), which moves scores near
        # the cut-offs; a seeded detector's detections are decided by small
        # margins, so a model that went wrong in bf16 holds few of them
        floor, spread = (0.95, 2) if name == "f32" else (YOLO_BF16_DET_FLOOR, 5)
        if matched < floor or abs(int(dg[2].sum()) - int(dc[2].sum())) > spread:
            raise AssertionError(f"yolo {name} detections card vs CPU: {matched} matched "
                                 f"(floor {floor})")
        del handle, cpu
        torch.cuda.empty_cache()

    return out


def phase_yolo_train(rows):
    """yolo-train, per dtype: the OA-DG step on the config's batch (8 images
    x 2 OA-Mix views, ``keep_orig=False``, on the 1024x1024 canvas, 32 gts
    each): a warm-up and 3 timed steps on the slots chain, then one step on
    the merged chain; B3-B6 (B7 on the merged chain) launched as the drawn
    tables imply; the 7 losses finite float32; the backbone's BN buffers
    unchanged, every neck and head BN buffer moved, every parameter moved;
    then B3-B7 checked in place on the batch's own table on each chain; and
    ``check_yolo_step_on_card``. -> {dtype: numbers}."""
    import torch
    from oadg_tpu_torch.engine import make_oadg_preprocess
    from oadg_tpu_torch.ops.oamix_device import oamix_batch
    dev = torch.device("cuda", 0)
    cfg = yolo_cfg()
    oamix_cfg = yolo_oamix_cfg(cfg)
    version = oamix_cfg["version"]
    wrappers = oamix_wrappers()
    out = {}
    for name in DTYPES:
        dtype = torch_dtype(name)
        current = ["slots"]
        pre = {}
        model, step = build_trainer("cuda", cfg,
                                    lambda b, g, pre=pre, current=current: pre[current[0]](b, g),
                                    dtype)
        pre.update({chain: make_oadg_preprocess(oamix_cfg, cfg["img_norm_cfg"],
                                                out_dtype=model.dtype, chain=chain)
                    for chain in ("slots", "merged")})
        batch = yolo_train_batch(np.random.RandomState(43), YOLO_BATCH, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = dict(model.named_parameters())
        buffers = {k: v for k, v in model.state_dict().items() if "running_" in k}
        before = {k: v.detach().clone() for k, v in {**params, **buffers}.items()}
        step(batch, gen)                                        # warm-up step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        expected = dict.fromkeys(wrappers, 0)
        times, logs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            logs.append(step(batch, gen))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            for k, n in expected_launches(pre["slots"].draws, version).items():
                expected[k] += n
        launched = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        median = statistics.median(times)
        table = pre["slots"].draws
        for i, lv in enumerate(logs):
            log("yolo-train", f"{name}, step {i + 1}: " + ", ".join(
                f"{k} {float(v):.5f}" for k, v in lv.items()))
        log("yolo-train", f"{name}: 3 steps of {YOLO_BATCH} images x 2 OA-Mix views on "
                          f"{YOLO_CANVAS}x{YOLO_CANVAS} (slots chain): ms "
                          f"{[round(t, 3) for t in times]}, median {median:.3f}; "
                          f"max_memory_allocated {peak:.2f} GiB; launches {launched}; the "
                          f"tables imply {expected} (table {tuple(table['op_idx'].shape)}) "
                          f"({nvidia_smi_line()})")
        if launched != expected or any(not launched[k] for k in wrappers
                                       if k != "merged_shift_rows"):
            raise AssertionError(f"yolo {name}: launched {launched}, not {expected}")
        for lv in logs:
            if set(YOLO_LOSSES) - set(lv) or not all(
                    bool(torch.isfinite(v).all()) and v.dtype == torch.float32
                    for v in lv.values()) or not float(lv["loss_cont"]) > 0:
                raise AssertionError(f"yolo {name}: a loss is missing or not finite: {lv}")
        sd = model.state_dict()
        unmoved = [k for k in buffers if not k.startswith("backbone.")
                   and torch.equal(sd[k], before[k])]
        moved_bb = [k for k in buffers if k.startswith("backbone.")
                    and not torch.equal(sd[k], before[k])]
        still = [k for k, p in params.items() if torch.equal(p.detach(), before[k])]
        n_bb = sum(k.startswith("backbone.") for k in buffers)
        log("yolo-train", f"{name}: BN buffers: backbone {n_bb} (norm_eval), {len(moved_bb)} "
                          f"moved; neck and head {len(buffers) - n_bb}, {len(unmoved)} unmoved; "
                          f"{len(params)} parameters, {len(still)} unmoved")
        if unmoved or moved_bb or still:
            raise AssertionError(f"yolo {name}: BN buffers {unmoved[:3]} {moved_bb[:3]}, "
                                 f"parameters {still[:3]}")

        # one step on the merged chain: B3, B6 and B7 as its table implies
        current[0] = "merged"
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        merged_ms = (time.perf_counter() - t0) * 1e3
        merged = {k: w.launches for k, w in wrappers.items()}
        want = expected_launches(pre["merged"].draws, version, "merged")
        log("yolo-train", f"{name}: one step on the merged chain {merged_ms:.3f} ms: launches "
                          f"{merged}; its table implies {want}")
        if merged != want or not merged["merged_shift_rows"]:
            raise AssertionError(f"yolo {name}: the merged step launched {merged}, not {want}")
        current[0] = "slots"
        suffix = "" if name == "f32" else "_bf16"
        for r in rows:
            r["launches_yolo" + suffix] = launched.get(r["name"], 0) + (
                merged["merged_shift_rows"] if r["name"] == "merged_shift_rows" else 0)
        out[name] = dict(median_ms=median, peak_gib=peak, merged_ms=merged_ms)

        if name == "f32":          # B3-B7 in place on the batch's own table, each chain
            with checked_kernels() as checks:
                for chain in ("slots", "merged"):
                    oamix_batch(batch["img_raw"], batch["gt_bboxes"], batch["gt_valid"],
                                batch["img_shape"].numpy(), oamix_cfg, draws=table,
                                chain=chain)
                torch.cuda.synchronize()
            for n, c in checks.items():
                log("yolo-train", f"{n} in place on the step's table: {len(c.errors)} calls, "
                                  f"vs plain max_abs_err {max(c.errors, default=0):.3e}")
                if not c.errors:
                    raise AssertionError(f"yolo: {n} did not run on the step's table")
        del model, step
        torch.cuda.empty_cache()

    check_yolo_step_on_card(cfg)
    return out


def yolo_step_grads(where, cfg, dtype, batch, draws):
    """One training forward and backward of the seeded OA-DG YOLOv3 (built
    by ``build_trainer``) on ``where`` in ``dtype`` on ``batch`` with
    ``draws``; ``torch.float64`` is the float32 model widened by
    ``model.double()`` (statistics and losses follow it: ``layers.widen``),
    the reference. -> ({loss: value}, {parameter: float64 gradient on the
    CPU})."""
    import torch
    wide = dtype == torch.float64
    model, _ = build_trainer(where, cfg, dtype=None if wide else dtype)
    if wide:
        model.double()
        model.dtype = torch.float64
    b = {k: v.to(where) for k, v in batch.items()}
    b["img"] = b["img"].to(model.dtype)
    if b["img"].is_cuda:
        b["img"] = b["img"].contiguous(memory_format=torch.channels_last)
    losses = model.forward_train(b, draws)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()})


def leaf_distances(got, want):
    """Each gradient's distance from ``want``'s: the norm of the difference
    over the norm of ``want``'s."""
    return {k: float((got[k] - w).norm()) / max(float(w.norm()), 1e-30)
            for k, w in want.items()}


def check_yolo_step_on_card(cfg):
    """One step of the seeded OA-DG YOLOv3 on the card and on the CPU on 2
    images x 2 fixed views of 128x128 (``fixed_view_batch``), with the same
    cont draws, in float32 and bfloat16, and a float64 copy of the float32
    model on the CPU as the reference:
    - float32: each loss of the card within 1e-3 of the CPU's; every
      gradient of the card and of the CPU within ``YOLO_F32_LEAF`` of the
      float64 step's (``leaf_distances``), their median within
      ``YOLO_F32_MEDIAN``; the whole gradient's cosine, card to CPU, at least
      0.9999;
    - bfloat16: each loss of the card within twice the bf16 CPU step's
      distance from the f32 CPU step plus 2**-6 of it; the gradients' median
      distance from the f32 CPU step's within ``YOLO_BF16_MEDIAN_RATIO``
      times the bf16 CPU's, the whole gradient's cosine to it at least the
      bf16 CPU's minus 0.05."""
    import torch
    from oadg_tpu_torch.utils.draws import UniformDraws
    fixed = fixed_view_batch(np.random.RandomState(44), 128, 128, cfg, "cpu", views=2)
    runs = {}
    for name in DTYPES:
        draws = UniformDraws(torch.Generator().manual_seed(7))
        runs[name, "cuda"] = yolo_step_grads("cuda", cfg, torch_dtype(name), fixed, draws)
        runs[name, "cpu"] = yolo_step_grads("cpu", cfg, torch_dtype(name), fixed,
                                            UniformDraws(given=draws.drawn))
        torch.cuda.empty_cache()
    runs["f64", "cpu"] = yolo_step_grads("cpu", cfg, torch.float64, fixed,
                                         UniformDraws(given=draws.drawn))
    (l32, g32), (lc32, gc32) = runs["f32", "cuda"], runs["f32", "cpu"]
    l64, g64 = runs["f64", "cpu"]
    for k in YOLO_LOSSES:
        err = abs(l32[k] - lc32[k]) / max(abs(lc32[k]), 1e-6)
        log("yolo-train", f"f32 card vs CPU step: {k} card {l32[k]:.6f} CPU {lc32[k]:.6f} "
                          f"(float64 {l64[k]:.6f}) rel err {err:.2e} (limit 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"yolo f32 {k} card vs CPU: {l32[k]} vs {lc32[k]}")
    card, cpu = leaf_distances(g32, g64), leaf_distances(gc32, g64)
    worst = sorted(card, key=lambda k: max(card[k], cpu[k]), reverse=True)
    for k in worst[:6]:
        log("yolo-train", f"f32 step from float64: grad {k}: card {card[k]:.3e}, CPU "
                          f"{cpu[k]:.3e} of its norm (limit {YOLO_F32_LEAF:g})")
    log("yolo-train", f"f32 step from float64 over {len(card)} gradients: card median "
                      f"{statistics.median(card.values()):.3e} max {max(card.values()):.3e}, "
                      f"CPU median {statistics.median(cpu.values()):.3e} max "
                      f"{max(cpu.values()):.3e} (limits {YOLO_F32_MEDIAN:g}, {YOLO_F32_LEAF:g})")
    if not max(max(card.values()), max(cpu.values())) <= YOLO_F32_LEAF:
        raise AssertionError(f"yolo f32 grad {worst[0]} from float64: card {card[worst[0]]}, "
                             f"CPU {cpu[worst[0]]} > {YOLO_F32_LEAF}")
    if not max(statistics.median(d.values()) for d in (card, cpu)) <= YOLO_F32_MEDIAN:
        raise AssertionError(f"yolo f32 grads from float64: medians above {YOLO_F32_MEDIAN}")

    def flat(g):
        return torch.cat([v.reshape(-1) for v in g.values()])

    def cos(a, c):
        return float(a @ c / (a.norm() * c.norm()))

    c32 = cos(flat(g32), flat(gc32))
    log("yolo-train", f"f32 gradient cosine, card to CPU: {c32:.8f} (limit 0.9999); card to "
                      f"float64 {cos(flat(g32), flat(g64)):.8f}, CPU {cos(flat(gc32), flat(g64)):.8f}")
    if not c32 >= 0.9999:
        raise AssertionError(f"yolo f32 gradients card vs CPU: cosine {c32}")

    (lb, gb), (lcb, gcb) = runs["bf16", "cuda"], runs["bf16", "cpu"]
    for k in YOLO_LOSSES:
        lim = 2 * abs(lcb[k] - lc32[k]) + 2 ** -6 * abs(lc32[k])
        log("yolo-train", f"bf16 card vs f32 CPU step: {k} {lb[k]:.6f} vs {lc32[k]:.6f} "
                          f"(bf16 CPU {lcb[k]:.6f}; limit {lim:.3e})")
        if not abs(lb[k] - lc32[k]) <= lim:
            raise AssertionError(f"yolo bf16 {k}: {lb[k]} vs {lc32[k]}")
    card_b, cpu_b = leaf_distances(gb, gc32), leaf_distances(gcb, gc32)
    mc, mp = statistics.median(card_b.values()), statistics.median(cpu_b.values())
    c_card, c_cpu = cos(flat(gb), flat(gc32)), cos(flat(gcb), flat(gc32))
    log("yolo-train", f"bf16 gradients from the f32 CPU step's: median over {len(card_b)} "
                      f"{mc:.3e} card, {mp:.3e} bf16 CPU (limit {YOLO_BF16_MEDIAN_RATIO:g}x the "
                      f"CPU's); worst {max(card_b.values()):.3e} / {max(cpu_b.values()):.3e}; "
                      f"cosine {c_card:.4f} / {c_cpu:.4f} (limit: the CPU's minus 0.05)")
    if not (mc <= YOLO_BF16_MEDIAN_RATIO * mp and c_card >= c_cpu - 0.05):
        raise AssertionError(f"yolo bf16 gradients: median {mc} vs {mp}, cosine {c_card} vs "
                             f"{c_cpu}")


def phase_yolo_tools(rows, val):
    """yolo-tools: ``tools/torch_train.py`` on the OA-DG YOLOv3 config over
    ``YOLO_TOOL_IMAGES`` synthetic 1024x2048 PNGs (``write_cityscapes``) as a
    subprocess counted by ``TOOL_PRELUDE``: 2 steps of the config's batch, an
    evaluation on the tools' val set (``val``), B3-B6 as the tables imply and
    B7 never; then, in this process (``run_tool``), ``--resume-from
    epoch_1.pth`` for a second epoch and ``tools/torch_test.py`` on the val set. In this process the loader alone
    over the train set: images/s and its host ms per image for each stage
    and the collate. -> its numbers."""
    import os
    import tempfile
    from oadg_tpu_torch.data import build_dataloader, build_dataset, static_hw_from_pipeline
    from oadg_tpu_torch.engine.runner import Checkpointer
    tmp = tempfile.TemporaryDirectory()
    t0 = t_phase = time.perf_counter()
    ann_file, img_prefix = write_cityscapes(os.path.join(tmp.name, "train"), YOLO_TOOL_IMAGES,
                                            seed=3)
    log("yolo-tools", f"wrote {YOLO_TOOL_IMAGES} training PNGs of {IMG_H}x{IMG_W} in "
                      f"{time.perf_counter() - t0:.2f} s; val set: {TOOL_VAL_IMAGES} of phase "
                      "5b's")
    options = {"data.train.ann_file": ann_file, "data.train.img_prefix": img_prefix,
               "data.val.ann_file": val[0], "data.val.img_prefix": val[1],
               "runner.max_epochs": 1, "log_config.interval": 1,
               "model.backbone.init_cfg": None}
    cfg_opts = [f"{k}={v}" for k, v in options.items()]
    work = os.path.join(tmp.name, "work")
    record = os.path.join(tmp.name, "record.json")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", TOOL_PRELUDE, str(ROOT / "tools" / "torch_train.py"),
                          str(YOLO), "--work-dir", work, "--seed", "0", "--cfg-options",
                          *cfg_opts], cwd=ROOT, env=dict(os.environ, LOOP_RECORD=record),
                         capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"tools/torch_train.py (YOLOv3) failed:\n{res.stdout[-2000:]}"
                             f"{res.stderr[-4000:]}")
    with open(record) as f:
        rec = json.load(f)
    version = yolo_oamix_cfg(yolo_cfg())["version"]
    want = dict.fromkeys(rec["launches"], 0)
    for t in rec["tables"]:
        for k, n in expected_launches({k: np.asarray(v) for k, v in t.items()}, version).items():
            want[k] += n
    lines = read_log(work)
    train = [ln for ln in lines if ln["mode"] == "train"]
    vals = [ln for ln in lines if ln["mode"] == "val"]
    meta = Checkpointer.load(os.path.join(work, "epoch_1.pth"))["meta"]
    steps = YOLO_TOOL_IMAGES // YOLO_BATCH
    log("yolo-tools", f"f32: tools/torch_train.py exit 0 in {wall:.2f} s: {len(train)} iterations "
                      f"of {YOLO_BATCH} images x 2 views, {len(vals)} evaluation "
                      f"{json.dumps(vals)}; epoch_1.pth meta {meta}; launches {rec['launches']}; "
                      f"the tables imply {want}")
    if (len(train) != steps or len(vals) != 1 or meta != dict(epoch=1, iter=steps, seed=0)
            or not all(math.isfinite(ln["loss"]) and ln["loss_cont"] > 0 for ln in train)
            or rec["launches"] != want or len(rec["tables"]) != steps
            or any(rec["launches"][k] for k in ("roi_align_fwd", "roi_align_bwd",
                                                "merged_shift_rows"))
            or not all(rec["launches"][k] for k in ("fg_maps", "shear_rows",
                                                    "piecewise_shift_rows", "hist256"))):
        raise AssertionError(f"the YOLOv3 tool run is wrong: {lines} {meta} {rec['launches']}")
    tool = dict(images_per_s=loop_rate(train, YOLO_BATCH),
                time=statistics.median(ln["time"] for ln in train),
                data_time=[ln["data_time"] for ln in train], val=vals[0])
    log("yolo-tools", f"f32: {tool['images_per_s']:.3f} images/s over the steps (time and "
                      f"data_time of the log, the fill apart); per iteration time / data_time ms "
                      + ", ".join(f"{ln['time'] * 1e3:.1f} / {ln['data_time'] * 1e3:.1f}"
                                  for ln in train) + f" ({nvidia_smi_line()})")

    resumed = os.path.join(tmp.name, "resumed")
    t0 = time.perf_counter()
    run_tool("torch_train", [str(YOLO), "--work-dir", resumed, "--seed", "0", "--no-validate",
                             "--resume-from", os.path.join(work, "epoch_1.pth"),
                             "--cfg-options", *cfg_opts, "runner.max_epochs=2"])
    again = read_log(resumed)
    meta2 = Checkpointer.load(os.path.join(resumed, "epoch_2.pth"))["meta"]
    log("yolo-tools", f"f32: --resume-from epoch_1.pth (in this process) in "
                      f"{time.perf_counter() - t0:.2f} s: iterations "
                      f"{[ln['iter'] for ln in again]}; epoch_2.pth meta {meta2}")
    if [ln["iter"] for ln in again] != list(range(steps + 1, 2 * steps + 1)) or \
            meta2 != dict(epoch=2, iter=2 * steps, seed=0):
        raise AssertionError(f"the resumed YOLOv3 run did not continue: {again} {meta2}")

    t0 = time.perf_counter()
    metrics = run_tool("torch_test", [str(YOLO), os.path.join(resumed, "epoch_2.pth"),
                                      "--eval", "bbox", "--cfg-options",
                                      f"data.test.ann_file={val[0]}",
                                      f"data.test.img_prefix={val[1]}"])
    test_wall = time.perf_counter() - t0
    if not metrics or "bbox_mAP" not in metrics:
        raise AssertionError(f"tools/torch_test.py (YOLOv3) gave {metrics}")
    tool["test_s"] = test_wall
    log("yolo-tools", f"tools/torch_test.py on epoch_2.pth over the {TOOL_VAL_IMAGES} val images "
                      f"(in this process) in {test_wall:.2f} s (model build and loading "
                      f"included); {metrics}")

    # the loader alone over the train set: the host cost of each stage
    cfg = yolo_cfg()
    cfg.merge_from_dict({k: v for k, v in options.items() if k.startswith("data.train")})
    dataset = build_dataset(dict(cfg["data"]["train"]))
    stages = dataset.pipeline.transforms
    names = [type(t).__name__ for t in stages]
    timers = [_HostTimer(t) for t in stages]
    dataset.pipeline.transforms = timers
    loader = build_dataloader(dataset, YOLO_BATCH, workers_per_gpu=cfg["data"]["workers_per_gpu"],
                              seed=0, static_hw=static_hw_from_pipeline(cfg["data"]["train"]
                                                                        ["pipeline"]),
                              pin_memory=True)
    collate = loader.batcher = _HostTimer(loader.batcher)
    t0 = time.perf_counter()
    batches = list(loader)
    loader_wall = time.perf_counter() - t0
    host = {nm: t.seconds * 1e3 / max(t.calls, 1) for nm, t in zip(names, timers)}
    host["collate"] = collate.seconds * 1e3 / max(YOLO_BATCH * collate.calls, 1)
    raw = batches[0]["img_raw"]
    tool.update(loader_images_per_s=YOLO_TOOL_IMAGES / loader_wall, host_ms=host)
    log("yolo-tools", f"the loader alone ({loader.num_workers} threads, pinned): "
                      f"{tool['loader_images_per_s']:.3f} images/s; img_raw {raw.dtype} "
                      f"{raw.shape}; host ms per training image (wall per call, in the loop): "
                      + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
                      + f" ({nvidia_smi_line()})")
    if raw.dtype != np.float32 or raw.shape != (YOLO_BATCH, YOLO_CANVAS, YOLO_CANVAS, 3):
        raise AssertionError(f"the YOLOv3 loader gave img_raw {raw.dtype} {raw.shape}")
    log("yolo-tools", f"phase {time.perf_counter() - t_phase:.2f} s")
    tmp.cleanup()
    return tool


def phase_yolo(rows, val):
    """The YOLOv3 slice's paths: serving, the training step and the tools,
    each driven with the kernels' counts set to 0 just before it; the f32
    step's launches (slots chain, and the merged step's B7) are added to each
    row's ``launches``. -> numbers. (Its profiled request and step, the
    phase ``profile-yolo``, were cut to keep the run inside its limit.)"""
    serve = phase_yolo_serve(rows)
    train = phase_yolo_train(rows)
    tools = phase_yolo_tools(rows, val)
    for r in rows:
        r["launches"] += r["launches_yolo"]
    return dict(serve=serve, train=train, tools=tools)


TTA_IMAGES = 4              # images of phase 5b's set in the TTA phase
TTA_SCALES = [(2048, 1024), (1536, 768)]
SMALL_TTA_SCALES = [(512, 256), (384, 192)]


def tta_cfg(config, scales, flip=True, options=None):
    """``config`` with its test ``MultiScaleFlipAug`` at ``scales`` (None:
    the config's) and ``flip``, and ``options`` merged."""
    from oadg_tpu_torch.config import load_config
    cfg = load_config(str(config))
    if config == YOLO:
        cfg["model"]["backbone"]["init_cfg"] = None
    options = dict(options or {}, **{"data.test.pipeline.1.flip": flip})
    if scales is not None:
        options["data.test.pipeline.1.img_scale"] = scales
    cfg.merge_from_dict(options)
    return cfg


def fetched_results(fetched):
    """One image's fetched (dets, labels, valid) -> its per-class lists."""
    from oadg_tpu_torch.apis.test import dets_to_results
    return dets_to_results(*fetched, 8)[0]


def first_tta_batch(cfg):
    from oadg_tpu_torch.apis import build_test_loader
    _, loader = build_test_loader(cfg)
    return next(iter(loader))


def _timed_soft_nms(boxes, scores, nms):
    """``multiclass_nms`` with the flagship's rcnn cut-offs and ``nms`` on the
    card inside ``set_sync_debug_mode("error")`` (no host sync in the
    picks): a warm-up and 3 timed calls -> (outputs, its keyword arguments,
    ms between CUDA events around the call, host ms to enqueue it (the
    call's return on the host clock), peak GiB above the inputs), medians
    of the 3."""
    import torch
    from oadg_tpu_torch.core.post_processing.nms import multiclass_nms
    kw = dict(score_thr=0.05, iou_threshold=float(nms.get("iou_threshold", 0.5)),
              max_per_img=100, num_classes=8, nms_type=(
                  "soft_nms_gaussian" if nms.get("method") == "gaussian" else "soft_nms"),
              sigma=float(nms.get("sigma", 0.5)), min_score=float(nms["min_score"]))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, hosts = [], []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(4):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            out = multiclass_nms(boxes, scores, **kw)
            host = (time.perf_counter() - t0) * 1e3
            end.record()
            if i:
                times.append((start, end))
                hosts.append(host)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    return (out, kw, statistics.median(s.elapsed_time(e) for s, e in times),
            statistics.median(hosts), peak)


def soft_nms_profile(boxes, scores, kw):
    """One soft-NMS call (after a warm-up) under torch.profiler -> its
    device kernels launched, the device's busy ms (their summed time) and
    the call's wall ms to a synchronize. After every timed run (the
    profiler slows the host's launches for the rest of the process)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from oadg_tpu_torch.core.post_processing.nms import multiclass_nms
    with torch.inference_mode():
        multiclass_nms(boxes, scores, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            multiclass_nms(boxes, scores, **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return dict(kernels=sum(e.count for e in kernels), busy_ms=busy, profiled_wall_ms=wall,
                top=[(e.key[:60], e.count, round(e.self_device_time_total / 1e3, 3))
                     for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                                     reverse=True)[:4]])


def phase_tta(rows, val):
    """tta: test-time augmentation on ``TTA_IMAGES`` of phase 5b's PNGs
    (``val``), per dtype: the flagship's test pipeline as
    ``MultiScaleFlipAug(img_scale=TTA_SCALES, flip=True)`` (4 views)
    through ``build_test_loader`` and ``single_gpu_test`` (B1 once per view
    on maps of the model's dtype, its count set to 0 just before), then the
    4 requests timed alone; a one-view, no-flip TTA equal to
    ``simple_test``; in f32 a 4-view request on the card against the same
    seeded model on the CPU at 512x256 and 384x192. Then soft-NMS (linear
    and gaussian) on a 1024x2048 request's 1000 x 8 candidates, card vs
    CPU, timed with its memory; one flip TTA request of the YOLOv3 config;
    ``async_inference_detector`` against ``inference_detector`` on the 4
    images. -> numbers."""
    import asyncio
    import os
    import tempfile
    import torch
    from oadg_tpu_torch.apis import (async_inference_detector, build_test_loader,
                                     inference_detector, init_detector, load_model_state,
                                     prepare_image, single_gpu_test)
    from oadg_tpu_torch.apis.test import fetch_dets
    from oadg_tpu_torch.core.post_processing.nms import multiclass_nms
    from oadg_tpu_torch.data.pipelines.image_io import imread
    from oadg_tpu_torch.engine.train_step import make_aug_test_step, make_test_step
    from oadg_tpu_torch.ops import roi_align
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_FWD
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    options = {"data.test.ann_file": _subset_json(val[0], TTA_IMAGES,
                                                  os.path.join(tmp.name, "tta.json")),
               "data.test.img_prefix": val[1]}
    cfg = tta_cfg(FLAGSHIP, TTA_SCALES, options=options)
    out = {}
    for name in DTYPES:
        dtype = torch_dtype(name)
        state = load_model_state(cfg, "none", device="cuda", dtype=dtype)
        model = state["handle"].model
        dataset, loader = build_test_loader(cfg, pin_memory=True)
        entry = _EntryDtypes(ROI_ALIGN_FWD)
        roi_align.ROI_ALIGN_FWD = entry
        ROI_ALIGN_FWD.launches = 0
        try:
            results = single_gpu_test(state, loader)
        finally:
            roi_align.ROI_ALIGN_FWD = ROI_ALIGN_FWD
        launches = ROI_ALIGN_FWD.launches
        if launches != 4 * TTA_IMAGES or entry.dtypes != [dtype] * launches:
            raise AssertionError(f"tta {name}: roi_align_fwd launched {launches} times for "
                                 f"{TTA_IMAGES} images of 4 views, on maps {entry.dtypes}")
        rows[0]["launches_tta" if name == "f32" else "launches_tta_bf16"] = launches
        if name == "f32":
            rows[0]["launches"] += launches
        if len(results) != TTA_IMAGES or not all(
                len(r) == 8 and all(np.isfinite(c).all() for c in r) for r in results) or \
                sum(len(c) for r in results for c in r) < TTA_IMAGES:
            raise AssertionError(f"tta {name}: bad results")

        batches = list(build_test_loader(cfg, pin_memory=True)[1])
        metas = batches[0]["__tta_metas__"]
        shapes = [tuple(v["img"].shape[1:3]) for v in batches[0]["__tta_views__"]]
        step = make_aug_test_step(model, metas)
        walls = []
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            t0 = time.perf_counter()
            fetch_dets(*step(b["__tta_views__"]))
            walls.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[name] = dict(request_ms=statistics.median(walls), peak_gib=peak, launches=launches)
        log("tta", f"{name}: {TTA_IMAGES} images x {len(metas)} views {shapes} "
                   f"(flips {[f for f, _ in metas]}) through single_gpu_test: roi_align_fwd "
                   f"launches {launches} on maps of {sorted(set(map(str, entry.dtypes)))}; "
                   f"TTA request (upload, 4 views, merge, NMS, results on the host) ms "
                   f"{[round(x, 3) for x in walls]}, median {out[name]['request_ms']:.3f}; "
                   f"max_memory_allocated {peak:.2f} GiB ({nvidia_smi_line()})")

        # one view, no flip: aug_test equals simple_test
        plain = first_tta_batch(tta_cfg(FLAGSHIP, TTA_SCALES[0], flip=False, options=options))
        got = fetch_dets(*make_aug_test_step(model, ((False, "horizontal"),))([plain]))
        want = fetch_dets(*make_test_step(model)(plain))
        ok, box_err, score_err = results_close(fetched_results(got), fetched_results(want))
        log("tta", f"{name}: one-view no-flip TTA vs simple_test: {int(got[2].sum())} and "
                   f"{int(want[2].sum())} detections, box err {box_err:.3e} px, score err "
                   f"{score_err:.3e}")
        if not ok:
            raise AssertionError(f"tta {name}: one-view TTA differs from simple_test")

        if name == "f32":   # the card against the CPU, 4 views at 512x256 and 384x192
            small = first_tta_batch(tta_cfg(FLAGSHIP, SMALL_TTA_SCALES, options=options))
            cpu = init_detector(cfg, device="cpu", seed=0).model
            t0 = time.perf_counter()
            want = fetch_dets(*make_aug_test_step(cpu, metas)(small["__tta_views__"]))
            cpu_s = time.perf_counter() - t0
            got = fetch_dets(*make_aug_test_step(model, metas)(small["__tta_views__"]))
            ok, box_err, score_err = results_close(fetched_results(got), fetched_results(want))
            views = [tuple(v["img"].shape[1:3]) for v in small["__tta_views__"]]
            log("tta", f"f32: 4-view request at {views} card vs CPU: {int(got[2].sum())} "
                       f"and {int(want[2].sum())} detections, box err {box_err:.3e} px (limit "
                       f"1e-3), score err {score_err:.3e} relative (limit 1e-4); CPU side "
                       f"{cpu_s:.2f} s")
            if not ok or int(got[2].sum()) < 1:
                raise AssertionError("tta f32: the card's 4-view request differs from the CPU's")
            del cpu
        del state, model
        torch.cuda.empty_cache()

    # soft-NMS on a 1024x2048 request's candidates (1000 proposals x 8 classes)
    handle = init_detector(str(FLAGSHIP), device="cuda", seed=0)
    img = request_image(np.random.RandomState(7))
    with torch.inference_mode():
        batch = prepare_image(img, handle.cfg, handle.device)
        det = handle.model
        feats = det.extract_feat(batch["img"])
        props, _, pvalid = det.rpn_head.get_proposals(*det.rpn_head(feats), batch["img_shape"])
        n, p = props.shape[:2]
        boxes, scores = det.roi_head.view_scores(
            feats, det.roi_head.proposals_to_rois(props).view(n, p, 5), batch["img_shape"],
            batch["scale_factor"], rescale=True)
        scores = torch.where(pvalid[..., None], scores, torch.zeros_like(scores))
        del feats
        soft, soft_inputs = {}, {}
        for method in ("linear", "gaussian"):
            nms = dict(type="soft_nms", iou_threshold=0.5, min_score=0.05)
            if method == "gaussian":
                nms.update(method="gaussian", sigma=0.5)
            (d, lb, v), kw, ms, host_ms, peak = _timed_soft_nms(boxes, scores, nms)
            t0 = time.perf_counter()
            wd, wl, wv = multiclass_nms(boxes.cpu(), scores.cpu(), **kw)
            cpu_s = time.perf_counter() - t0
            err = float((d.cpu() - wd).abs().max())
            same = torch.equal(v.cpu(), wv) and torch.equal(lb.cpu(), wl)
            soft[method] = dict(ms=ms, host_ms=host_ms, peak_gib=peak,
                                candidates=int(boxes.shape[1] * 8))
            soft_inputs[method] = kw
            log("tta", f"soft-NMS {method} over {n} x {p} x 8 = {p * 8} candidates "
                       f"({int((scores[..., :8] > 0.05).sum())} above score_thr, "
                       f"{min(400, p * 8)} picks): {ms:.3f} ms (CUDA events, median of 3, "
                       f"inside set_sync_debug_mode('error')), of it {host_ms:.3f} ms on the "
                       f"host to enqueue the call, peak above the inputs "
                       f"{peak:.3f} GiB; {int(v.sum())} kept; card vs CPU: same kept set "
                       f"and labels {same}, max abs err {err:.3e}; CPU side {cpu_s:.2f} s "
                       f"({nvidia_smi_line()})")
            if not same or err > 1e-4 or int(v.sum()) < 1:
                raise AssertionError(f"soft-NMS {method}: the card differs from the CPU")
        # the config's route: rcnn soft_nms through DetectorHandle.test
        det.roi_head.test_cfg["nms"] = dict(type="soft_nms", iou_threshold=0.5,
                                            min_score=0.05)
        dets, labels, valid = handle.test(batch)
        if not torch.isfinite(dets).all() or int(valid.sum()) < 1:
            raise AssertionError("soft-NMS request: bad detections")
    out["soft_nms"] = soft
    soft_boxes, soft_scores = boxes.clone(), scores.clone()

    def profile():
        """Each soft-NMS call profiled, into ``out``: its kernels, busy ms."""
        for method, kw in soft_inputs.items():
            prof = soft_nms_profile(soft_boxes, soft_scores, kw)
            soft[method].update(prof)
            log("tta-profile", f"soft-NMS {method}: profiled call {prof['profiled_wall_ms']:.3f} "
                               f"ms wall, {prof['kernels']} device kernels, device busy "
                               f"{prof['busy_ms']:.3f} ms "
                               f"({100 * prof['busy_ms'] / prof['profiled_wall_ms']:.1f}%); "
                               f"the most time: {prof['top']} ({nvidia_smi_line()})")

    # async_inference_detector equals inference_detector on the 4 images
    images = [imread(os.path.join(val[1], f)) for f in sorted(os.listdir(val[1]))
              if f.endswith(".png")][:TTA_IMAGES]
    handle = init_detector(str(FLAGSHIP), device="cuda", seed=0)
    want = inference_detector(handle, images)
    t0 = time.perf_counter()
    got = asyncio.run(async_inference_detector(handle, images))
    async_s = time.perf_counter() - t0
    checks = [results_close(g, w) for g, w in zip(got, want)]
    log("tta", f"async_inference_detector on {len(images)} images in {async_s:.3f} s: equal to "
               f"inference_detector {all(c[0] for c in checks)} (largest box err "
               f"{max(c[1] for c in checks):.3e} px)")
    if len(got) != len(images) or not all(c[0] for c in checks):
        raise AssertionError("async_inference_detector differs from inference_detector")
    del handle
    torch.cuda.empty_cache()

    # one flip TTA request of the YOLOv3 config
    ycfg = tta_cfg(YOLO, None, options=options)
    yolo = init_detector(ycfg, device="cuda", seed=0).model
    batch = first_tta_batch(ycfg)
    metas = batch["__tta_metas__"]
    step = make_aug_test_step(yolo, metas)
    fetch_dets(*step(batch["__tta_views__"]))                    # warm-up
    t0 = time.perf_counter()
    d, lb, v = fetch_dets(*step(batch["__tta_views__"]))
    yolo_ms = (time.perf_counter() - t0) * 1e3
    out["yolo_flip_ms"] = yolo_ms
    views = [tuple(x["img"].shape[1:3]) for x in batch["__tta_views__"]]
    log("tta", f"YOLOv3 flip TTA ({len(metas)} views {views}): {yolo_ms:.3f} ms, "
               f"{int(v.sum())} detections ({nvidia_smi_line()})")
    if metas != ((False, "horizontal"), (True, "horizontal")) or not np.isfinite(d).all() \
            or int(v.sum()) < 1 or not ((lb[v] >= 0) & (lb[v] < 8)).all():
        raise AssertionError("YOLOv3 flip TTA: bad detections")
    del yolo
    torch.cuda.empty_cache()
    log("tta", f"phase {time.perf_counter() - t_phase:.2f} s")
    return out, profile


ENGINE_TRAIN_IMAGES = 2     # one step of 2 images of phase 5b's set an epoch
ENGINE_EPOCHS = 3


def engine_lr(t, epoch):
    """The LR that ``ENGINE_CONFIG``'s schedule gives iteration ``t`` of
    ``epoch``, in closed form: mmcv's cosine by epoch from 1e-4 to 1e-6
    over ``ENGINE_EPOCHS``, times the exp warmup 0.1 ** (1 - t / 2) while
    t < 2."""
    lr = 1e-6 + (1e-4 - 1e-6) * (1 + math.cos(math.pi * epoch / ENGINE_EPOCHS)) / 2
    return lr * 0.1 ** (1 - t / 2) if t < 2 else lr


def mmdet_checkpoint(path, model):
    """``model``'s weights as a published mmdet ``.pth``: ``state_dict``
    with a ``num_batches_tracked`` per BN, ``meta`` and ``optimizer``."""
    import torch
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    extra = {k[:-len("running_mean")] + "num_batches_tracked": torch.tensor(0)
             for k in sd if k.endswith("running_mean")}
    torch.save({"meta": {"mmdet_version": "2.28.2", "epoch": 12, "iter": 35700,
                         "CLASSES": ("person", "rider", "car", "truck", "bus", "train",
                                     "motorcycle", "bicycle")},
                "state_dict": dict(sd, **extra),
                "optimizer": {"state": {}, "param_groups": [dict(lr=0.01, momentum=0.9,
                                                                 params=[])]}}, path)
    return sd, sorted(extra)


ENGINE_CONFIG = """_base_ = [{flagship!r}]
load_from = {load_from!r}
optimizer = dict(_delete_=True, type='AdamW', lr=1e-4, weight_decay=0.05)
lr_config = dict(_delete_=True, policy='CosineAnnealing', min_lr_ratio=0.01, warmup='exp',
                 warmup_iters=2, warmup_ratio=0.1)
custom_hooks = [dict(type='ProfilerHook', start_iter=2, num_iters=1),
                dict(type='FeatureHook', layer_list=['neck']),
                dict(type='SyncNormHook'), dict(type='SetEpochInfoHook')]
"""


def phase_engine(rows, val):
    """engine: a seeded flagship written as an mmdet ``.pth``; ``init_detector``
    of it serves the source model's detections; then ``tools/torch_train.py``
    as a subprocess from it (``load_from``) with AdamW, the cosine schedule
    with exp warmup, ``ProfilerHook``, ``FeatureHook``, ``SyncNormHook`` and
    ``SetEpochInfoHook``, 3 epochs of one step on 2 of phase 5b's PNGs
    (``val``), launches counted by ``TOOL_PRELUDE``: exit 0, the logged LR
    equal to the closed form ``engine_lr`` at each iteration, the trace
    naming B1's and B2's kernels, every trainable parameter moved and every
    frozen one not. -> numbers."""
    import os
    import tempfile
    import torch
    from oadg_tpu_torch.apis import init_detector, prepare_image
    from oadg_tpu_torch.engine.runner import Checkpointer
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    pth = os.path.join(tmp.name, "faster_rcnn_r50_fpn_1x_cityscapes_oadg.pth")
    src = init_detector(str(FLAGSHIP), device="cuda", seed=0)
    sd, counters = mmdet_checkpoint(pth, src.model)
    loaded = init_detector(str(FLAGSHIP), pth, device="cuda", seed=11)
    report = loaded.checkpoint_report
    img = request_image(np.random.RandomState(12))
    a = src.test(prepare_image(img, src.cfg, src.device))
    b = loaded.test(prepare_image(img, loaded.cfg, loaded.device))
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    log("engine", f"mmdet .pth ({os.path.getsize(pth) / 2 ** 20:.1f} MiB, {len(sd)} tensors + "
                  f"{len(counters)} num_batches_tracked, meta, optimizer): init_detector loaded "
                  f"{len(report['loaded'])}, skipped {len(report['skipped'])}, missing "
                  f"{len(report['missing'])}; detections equal to the source model's {equal} "
                  f"({int(a[2].sum())} valid)")
    if (set(report["loaded"]) != set(sd) or report["missing"]
            or sorted(s.split(" ")[0] for s in report["skipped"]) != counters or not equal):
        raise AssertionError(f"the mmdet .pth did not load as its source: {report}")
    del src, loaded
    torch.cuda.empty_cache()

    config = os.path.join(tmp.name, "engine.py")
    with open(config, "w") as f:
        f.write(ENGINE_CONFIG.format(flagship=str(FLAGSHIP), load_from=pth))
    ann_file = _subset_json(val[0], ENGINE_TRAIN_IMAGES, os.path.join(tmp.name, "train.json"))
    options = {"data.train.times": 1, "data.train.dataset.ann_file": ann_file,
               "data.train.dataset.img_prefix": val[1], "runner.max_epochs": ENGINE_EPOCHS,
               "log_config.interval": 1, "checkpoint_config.interval": ENGINE_EPOCHS}
    work = os.path.join(tmp.name, "work")
    record = os.path.join(tmp.name, "record.json")
    argv = [str(ROOT / "tools" / "torch_train.py"), config, "--work-dir", work, "--seed", "0",
            "--no-validate", "--cfg-options", *(f"{k}={v}" for k, v in options.items())]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", TOOL_PRELUDE, *argv], cwd=ROOT,
                         env=dict(os.environ, LOOP_RECORD=record), capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"tools/torch_train.py (AdamW, cosine) failed:\n"
                             f"{res.stdout[-2000:]}{res.stderr[-4000:]}")
    with open(record) as f:
        rec = json.load(f)
    steps = ENGINE_EPOCHS * ENGINE_TRAIN_IMAGES // 2
    train = [ln for ln in read_log(work) if ln["mode"] == "train"]
    lrs = [ln["lr"] for ln in train]
    want_lrs = [engine_lr(t, t * ENGINE_EPOCHS // steps) for t in range(steps)]
    traces = [os.path.join(work, "profiler", f) for f in os.listdir(os.path.join(work, "profiler"))]
    with open(traces[0]) as f:
        trace = f.read()
    named = {k: k in trace for k in ("roi_align_fwd_kernel", "roi_grad_tile_kernel")}
    want = loop_launches(rec["tables"], flagship_oamix_cfg()["version"], steps, 0)
    log("engine", f"tools/torch_train.py from the .pth, AdamW + CosineAnnealing (exp warmup), 4 "
                  f"custom hooks: exit 0 in {wall:.2f} s; {len(train)} iterations in "
                  f"{ENGINE_EPOCHS} epochs; lr {lrs} (closed form {want_lrs}); step ms "
                  f"{[round(ln['time'] * 1e3, 3) for ln in train]} (the last under the "
                  f"profiler); trace {os.path.basename(traces[0])} "
                  f"({os.path.getsize(traces[0]) / 2 ** 20:.1f} MiB) names {named}; launches "
                  f"{rec['launches']} (the tables imply {want}) ({nvidia_smi_line()})")
    if (len(train) != steps or len(traces) != 1 or not all(named.values())
            or not np.allclose(lrs, want_lrs, rtol=1e-12, atol=0)
            or not all(math.isfinite(ln["loss"]) for ln in train) or rec["launches"] != want):
        raise AssertionError(f"the AdamW run went wrong: {train} {named} {rec['launches']}")
    trained = Checkpointer.load(os.path.join(work, f"epoch_{ENGINE_EPOCHS}.pth"))["state_dict"]
    model = init_detector(str(FLAGSHIP), device="cpu", num_views=2).model
    moved = frozen_moved = trainable = frozen = 0
    for k, p in model.named_parameters():
        changed = not torch.equal(trained[k], sd[k])
        if p.requires_grad:
            trainable += 1
            moved += changed
        else:
            frozen += 1
            frozen_moved += changed
    log("engine", f"parameters: {moved} of {trainable} trainable moved, {frozen_moved} of "
                  f"{frozen} frozen moved; phase {time.perf_counter() - t_phase:.2f} s")
    if moved != trainable or frozen_moved or not frozen:
        raise AssertionError("AdamW: a trainable parameter stayed or a frozen one moved")
    for r in rows:
        if r["name"] in rec["launches"]:
            r["launches_engine"] = rec["launches"][r["name"]]
            r["launches"] += rec["launches"][r["name"]]
    return dict(step_ms=train[1]["time"] * 1e3, first_step_ms=train[0]["time"] * 1e3,
                profiled_step_ms=train[2]["time"] * 1e3, wall_s=wall)


# ----------------------------------------------------------- Mask R-CNN ----
#
# The Cityscapes Mask R-CNN (configs/cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py):
# R50-FPN, 8 classes, FCNMaskHead with 4 convs of 256 channels; its mask
# branch runs B1 and B2 a second time a step, at 14x14 bins, beside the box
# head's 7x7.

MASK = ROOT / "configs/cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py"
MASK_ROIS = 100             # a request's detections (test_cfg.rcnn.max_per_img)
MASK_SLOTS = 128            # the mask branch's slots an image: round(512 * 0.25)
MASK_TOOL_IMAGES = 4        # images of phase 5b's set in the tools run: 2 steps of 2
MASK_BINS = 14
MASK_STAGES = STAGES[1:]    # no OA-Mix


def mask_cfg():
    """The config as published, with seeded weights (its backbone's
    ``torchvision://`` init cut) and its train pipeline loading and
    collecting masks (``LoadAnnotations(with_mask=True)``, ``Collect`` with
    ``gt_masks``: the Cityscapes dataset base loads boxes only)."""
    from oadg_tpu_torch.config import load_config
    cfg = load_config(MASK)
    cfg.model.backbone.init_cfg = None
    pipeline = []
    for op in cfg.data.train.dataset.pipeline:
        op = dict(op)
        if op["type"] == "LoadAnnotations":
            op["with_mask"] = True
        if op["type"] == "Collect":
            op["keys"] = list(op["keys"]) + ["gt_masks"]
        pipeline.append(op)
    cfg.data.train.dataset.pipeline = pipeline
    return cfg


def add_polygons(ann_file, seed):
    """Gives each annotation of a COCO json an instance polygon: an octagon
    touching the four sides of its box, inner points jittered."""
    rng = np.random.RandomState(seed)
    with open(ann_file) as f:
        ann = json.load(f)
    for a in ann["annotations"]:
        x, y, w, h = a["bbox"]
        (p, q), (r, t) = rng.uniform(0.15, 0.45, 2), rng.uniform(0.55, 0.85, 2)
        pts = [(p, 0), (r, 0), (1, q), (1, t), (r, 1), (p, 1), (0, t), (0, q)]
        a["segmentation"] = [[float(v) for px, py in pts for v in (x + px * w, y + py * h)]]
    with open(ann_file, "w") as f:
        json.dump(ann, f)
    return ann_file


def mask_slot_rois(rng, image):
    """The mask branch's rois of one training image: ``MASK_SLOTS`` positives
    jittered around ``NUM_GTS`` seeded gts (each side by at most a tenth of
    the gt's size, so IoU >= 0.5)."""
    gt = seeded_gts(rng, 1, IMG_H, IMG_W)[0][0].astype(np.float64)
    k = np.arange(MASK_SLOTS) % NUM_GTS
    size = np.stack([gt[k, 2] - gt[k, 0], gt[k, 3] - gt[k, 1]] * 2, 1)
    pos = gt[k] + rng.uniform(-0.1, 0.1, (MASK_SLOTS, 4)) * size
    return np.concatenate([np.full((MASK_SLOTS, 1), image), pos], 1).astype(np.float32)


def mask_roi_cases(dev):
    """B1 and B2 at 14x14 bins, f32 and bf16 (the maps cast): B1 at a
    request (one image's FPN maps, R = 100 detections of ``flagship_rois``)
    and at the mask branch's training call (2 images, R = 2 x 128 positive
    slots); B2 at that training call. -> (B1 cases, B2 cases); the first of
    each is its report row."""
    import torch
    serving = flagship_maps(dev, 1, 30)
    srois = torch.from_numpy(flagship_rois(np.random.RandomState(30), MASK_ROIS)).to(dev)
    train = flagship_maps(dev, 2, 31)
    rng = np.random.RandomState(31)
    trois = torch.from_numpy(np.concatenate([mask_slot_rois(rng, b) for b in range(2)])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(32)
    dy = torch.randn(trois.shape[0], CHANNELS, MASK_BINS, MASK_BINS, device=dev, generator=gen)
    fwd, bwd = [], []
    for name in DTYPES:
        sv, tr = ([f.to(torch_dtype(name)) for f in fs] for fs in (serving, train))
        fwd += [(f"{name}, 14x14, serving, 1 image, R={srois.shape[0]} detections", sv, srois),
                (f"{name}, 14x14, training, 2 images, R={trois.shape[0]} mask slots", tr, trois)]
        bwd.append((f"{name}, 14x14, training, 2 images, R={trois.shape[0]} mask slots",
                    tr, trois, dy))
    return fwd, bwd


def phase_mask_kernels():
    """mask-kernels: B1 and B2 at the mask head's 14x14 bins against their
    plain versions (``TOL_F32`` / ``TOL_BF16``, as at 7x7), timed beside
    their bounds. -> the two report rows ``roi_align_fwd_14x14`` and
    ``roi_align_bwd_14x14`` (the f32 case first; their plain times from
    ``phase_profiled``)."""
    import torch
    fwd, bwd = mask_roi_cases(torch.device("cuda", 0))
    out = []
    for name, source, replaces, cases, check in (
            ("roi_align_fwd_14x14", "roi_align_fwd.cu", "oadg_tpu/ops/pallas_roi_bwd.py:248",
             fwd, lambda c: check_fwd_case(*c, phase="mask-kernels", bins=MASK_BINS)),
            ("roi_align_bwd_14x14", "roi_align_bwd.cu", "oadg_tpu/ops/pallas_roi_bwd.py:316",
             bwd, lambda c: check_bwd_case(*c, phase="mask-kernels"))):
        results = [(c[0], check(c)) for c in cases]
        (label, main), others = results[0], results[1:]
        out.append(row(name, source, replaces, *main,
                       cases=[case_row(label, *r) for label, r in others]) | {"label": label})
    del fwd, bwd
    torch.cuda.empty_cache()
    return out


def zero_roi_counts():
    """B1's and B2's launch counts, in all, per bin count and per (bin
    count, level count), set to 0."""
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
    for w in (ROI_ALIGN_FWD, ROI_ALIGN_BWD):
        w.launches = 0
        w.launches_by_shape = {}


def roi_shape_counts():
    """-> {"roi_align_fwd": {(bins, levels): n}, "roi_align_bwd": {...}}."""
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
    return {"roi_align_fwd": dict(ROI_ALIGN_FWD.launches_by_shape),
            "roi_align_bwd": dict(ROI_ALIGN_BWD.launches_by_shape)}


def _count_shape_launches(rows, counts, key):
    """Adds a run's counts by shape to the rows: 7x7 on the pyramid to B1's
    and B2's, 14x14 on the pyramid to the mask head's ``_14x14`` rows, 14x14
    on one level to the ``_c4`` rows (phase ``longtail``'s C4) or the
    ``_sem`` rows (HTC's stride-8 semantic embedding), each under ``key``
    and in ``launches``."""
    by_name = {r["name"]: r for r in rows}
    one_level = "_c4" if key.startswith("launches_longtail") else "_sem"
    suffix = {(7, 4): "", (MASK_BINS, 4): "_14x14", (MASK_BINS, 1): one_level}
    for kernel, per_shape in counts.items():
        for shape, n in per_shape.items():
            r = by_name[kernel + suffix[shape]]
            r[key] = r.get(key, 0) + n
            r["launches"] = (r["launches"] or 0) + n


def roi_counts():
    """-> {"roi_align_fwd": {7: n, 14: n}, "roi_align_bwd": {...}}."""
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
    return {"roi_align_fwd": dict(ROI_ALIGN_FWD.launches_by_size),
            "roi_align_bwd": dict(ROI_ALIGN_BWD.launches_by_size)}


def _count_launches(rows, counts, key, suffix14="_14x14"):
    """Adds a run's counts to the rows: the 14x14 ones to the ``...<suffix14>``
    rows (the mask head's, or C4's ``_c4``), the 7x7 ones to B1's and B2's,
    each under ``key`` and in ``launches``."""
    by_name = {r["name"]: r for r in rows}
    for kernel, per_size in counts.items():
        for bins, suffix in ((7, ""), (MASK_BINS, suffix14)):
            r = by_name[kernel + suffix]
            r[key] = r.get(key, 0) + per_size[bins]
            r["launches"] = (r["launches"] or 0) + per_size[bins]


def _report_checks(phase, name, checks, want_calls):
    """Logs each checked call (R, maps' dtype, error, limit) and fails if
    one disagrees or the run made other calls than ``want_calls`` (kernel
    name -> its calls' R, in any order: autograd orders the backward calls)."""
    import torch
    for check in checks:
        rs = [c[0] for c in check.calls]
        for r, maps, err, lim, within in check.calls:
            log(phase, f"{name}: {check.name} in the path (R={r}, {maps} maps): vs plain "
                       f"version max_abs_err {err:.3e} (limit {lim:.3e}"
                       f"{' + 2^-8 |value|' if check.name.endswith('bwd') and maps == torch.bfloat16 else ''})")
            if not within:
                raise AssertionError(f"{phase} {name}: {check.name} disagrees: {err} > {lim}")
        if sorted(rs) != sorted(want_calls[check.name]):
            raise AssertionError(f"{phase} {name}: {check.name} called at R={rs}, not "
                                 f"{want_calls[check.name]}")


def phase_mask_serve(rows):
    """mask-serve: per dtype a warm-up and 3 timed requests of a 1024x2048
    uint8 image (``prepare_image``, ``DetectorHandle.test``): dets, labels,
    valid and (1, 100, 28, 28) mask probabilities; B1 once at 7x7 (1000
    proposals) and once at 14x14 (100 detections) a request, B2 never; one
    more request with both calls held to the plain version in place; the
    host's ``paste_masks`` of the request's valid detections into the image."""
    import torch
    from oadg_tpu_torch.apis import init_detector, prepare_image
    from oadg_tpu_torch.apis.test import fetch_dets
    from oadg_tpu_torch.core.mask import paste_masks
    out = {}
    for name in DTYPES:
        handle = init_detector(mask_cfg(), device="cuda", seed=0, dtype=torch_dtype(name))
        img = request_image(np.random.RandomState(33))
        handle.test(prepare_image(img, handle.cfg, handle.device))        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_roi_counts()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = handle.test(prepare_image(img, handle.cfg, handle.device))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = roi_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        dets, labels, valid = fetch_dets(*res[:3])
        masks = res[3]
        probs = masks[0][torch.from_numpy(valid[0]).to(masks.device)].cpu().numpy()
        t0 = time.perf_counter()
        pasted = paste_masks(probs, dets[0][valid[0]], IMG_H, IMG_W)
        paste_ms = (time.perf_counter() - t0) * 1e3
        median = statistics.median(times)
        log("mask-serve", f"{name}: Mask R-CNN R50-FPN, 3 requests of {IMG_H}x{IMG_W}: ms "
                          f"{[round(t, 3) for t in times]}, median {median:.3f}; "
                          f"max_memory_allocated {peak:.2f} GiB; {int(valid.sum())} valid "
                          f"detections, masks {tuple(masks.shape)} {masks.dtype}; launches by "
                          f"bin count {counts}; paste_masks of the valid detections on the "
                          f"host {paste_ms:.3f} ms ({nvidia_smi_line()})")
        if (len(res) != 4 or tuple(masks.shape) != (1, MASK_ROIS, 28, 28)
                or masks.dtype != torch.float32 or not bool(torch.isfinite(masks).all())
                or not bool(((masks >= 0) & (masks <= 1)).all()) or not valid.any()):
            raise AssertionError(f"mask-serve {name}: wrong outputs")
        if counts != {"roi_align_fwd": {7: 3, MASK_BINS: 3},
                      "roi_align_bwd": {7: 0, MASK_BINS: 0}}:
            raise AssertionError(f"mask-serve {name}: launches {counts}")
        if pasted.shape != (int(valid.sum()), IMG_H, IMG_W) or pasted.dtype != np.uint8:
            raise AssertionError(f"mask-serve {name}: paste_masks gave {pasted.shape}")
        checks, restore = _checked_roi_align()
        try:
            handle.test(prepare_image(img, handle.cfg, handle.device))
        finally:
            restore()
        torch.cuda.synchronize()
        _report_checks("mask-serve", name, checks,
                       {"roi_align_fwd": [1000, MASK_ROIS], "roi_align_bwd": []})
        _count_launches(rows, counts, "launches_mask_serve" + ("" if name == "f32" else "_bf16"))
        out[name] = dict(median_ms=median, peak_gib=peak, paste_ms=paste_ms,
                         valid=int(valid.sum()))
        del handle, res, masks
        torch.cuda.empty_cache()
    return out


def mask_train_batch(cfg, val, tmp):
    """2 of phase 5b's 1024x2048 PNGs with polygon instances (``add_polygons``)
    through the config's train pipeline with masks at the 1024x2048 scale
    (resize, flip, normalize, pad, the collate's (2, 128, 56, 56) masks) ->
    the step's batch on the card, and the instances an image."""
    import os
    from oadg_tpu_torch.data import build_dataset
    from oadg_tpu_torch.data.builder import StaticBatcher
    from oadg_tpu_torch.engine.train_step import upload_train_batch
    ann = add_polygons(_subset_json(val[0], 2, os.path.join(tmp, "step.json")), 34)
    pipeline = [dict(op, img_scale=(IMG_W, IMG_H)) if op["type"] == "Resize" else op
                for op in cfg.data.train.dataset.pipeline]
    dataset = build_dataset(dict(cfg.data.train.dataset, ann_file=ann, img_prefix=val[1],
                                 pipeline=pipeline))
    np.random.seed(34)
    samples = [dataset[i] for i in range(2)]
    batch = StaticBatcher((IMG_H, IMG_W), max_gt=int(cfg.get("max_gt", 128)),
                          pin_memory=True)(samples)
    return upload_train_batch(batch, "cuda"), [len(s["gt_masks"]) for s in samples]


def phase_mask_train(rows, val, tmp):
    """mask-train: per dtype the Mask R-CNN training step (``make_train_step``,
    SGD with the config's schedule, no OA-Mix) on 2 images of 1024x2048 with
    6-10 polygon instances each: a warm-up and 3 timed steps; B1 and B2 each
    once at 7x7 (1024 sampled rois) and once at 14x14 (256 mask slots) a
    step; the losses finite float32, ``loss_mask`` > 0; the frozen
    parameters (stem, ``layer1``) unchanged and the mask head's all moved;
    one more step with every B1 and B2 call held to the plain versions in
    place. -> (numbers, a function that profiles one step per dtype)."""
    import torch
    cfg = mask_cfg()
    batch, instances = mask_train_batch(cfg, val, tmp)
    out, steps = {}, {}
    for name in DTYPES:
        model, step = build_trainer("cuda", cfg, dtype=torch_dtype(name))
        params = dict(model.named_parameters())
        frozen = [k for k, p in params.items() if not p.requires_grad]
        before = {k: p.detach().clone() for k, p in params.items()}
        gen = torch.Generator(device="cuda").manual_seed(0)
        step(batch, gen)                                       # warm-up step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_roi_counts()
        times, logs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            logs.append(step(batch, gen))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = roi_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        median = statistics.median(times)
        log("mask-train", f"{name}: Mask R-CNN R50-FPN, 3 steps on 2 images of {IMG_H}x{IMG_W} "
                          f"({instances} polygon instances): ms {[round(t, 3) for t in times]}, "
                          f"median {median:.3f}; max_memory_allocated {peak:.2f} GiB; launches "
                          f"by bin count {counts} ({nvidia_smi_line()})")
        log("mask-train", f"{name}: last step " + ", ".join(
            f"{k} {float(v):.5f}" for k, v in logs[-1].items()))
        if counts != {"roi_align_fwd": {7: 3, MASK_BINS: 3},
                      "roi_align_bwd": {7: 3, MASK_BINS: 3}}:
            raise AssertionError(f"mask-train {name}: launches {counts}")
        if not all(bool(torch.isfinite(v).all()) and v.dtype == torch.float32
                   for lv in logs for v in lv.values()) or \
                not all(float(lv["loss_mask"]) > 0 for lv in logs):
            raise AssertionError(f"mask-train {name}: a loss is wrong: {logs}")
        moved = [k for k in frozen if not torch.equal(params[k].detach(), before[k])]
        mask_still = [k for k, p in params.items() if k.startswith("roi_head.mask_head.")
                      and torch.equal(p.detach(), before[k])]
        log("mask-train", f"{name}: {len(frozen)} frozen parameters, {len(moved)} moved; the "
                          f"mask head's unmoved: {mask_still}")
        if moved or not frozen or mask_still:
            raise AssertionError(f"mask-train {name}: frozen moved {moved}, mask head "
                                 f"unmoved {mask_still}")
        checks, restore = _checked_roi_align()
        try:
            step(batch, gen)
        finally:
            restore()
        torch.cuda.synchronize()
        slots = 2 * MASK_SLOTS
        _report_checks("mask-train", name, checks,
                       {"roi_align_fwd": [2 * TRAIN_ROIS, slots],
                        "roi_align_bwd": [slots, 2 * TRAIN_ROIS]})
        _count_launches(rows, counts, "launches_mask_train" + ("" if name == "f32" else "_bf16"))
        out[name] = dict(median_ms=median, peak_gib=peak,
                         loss_mask=float(logs[-1]["loss_mask"]))
        steps[name] = (step, gen)
        del model, params, before
        torch.cuda.empty_cache()

    def profile():
        """One profiled step per dtype, its stages and the mask branch's
        span (after every timed run)."""
        for name, (step, gen) in steps.items():
            out[name]["busy"] = train_profile(step, batch, gen, "no OA-Mix", name, MASK_STAGES,
                                              "mask-profile", ("forward_train: mask branch",))[0]
        steps.clear()

    return out, profile


def phase_mask_tools(rows, val, tmp):
    """mask-tools: ``train_detector`` (f32) on the config with masks, 1
    epoch of 2 steps over 4 of phase 5b's PNGs with polygon instances, then
    its evaluation on them (the test loop, COCO ``bbox``): ``loss_mask``
    logged finite and > 0, the checkpoint holding the mask head, B1 at 7x7
    and 14x14 once a step and once a val image, B2 at both once a step."""
    import os
    import torch
    from oadg_tpu_torch.apis import init_detector, train_detector
    from oadg_tpu_torch.engine.runner import Checkpointer
    ann = add_polygons(_subset_json(val[0], MASK_TOOL_IMAGES, os.path.join(tmp, "tool.json")),
                       35)
    cfg = mask_cfg()
    cfg.merge_from_dict({"data.samples_per_gpu": 2, "data.train.times": 1,
                         "data.train.dataset.ann_file": ann,
                         "data.train.dataset.img_prefix": val[1],
                         "data.val.ann_file": ann, "data.val.img_prefix": val[1],
                         "runner.max_epochs": 1, "log_config.interval": 1, "seed": 0})
    model = init_detector(cfg, device="cuda", seed=0).model
    work = os.path.join(tmp, "tools")
    zero_roi_counts()
    t0 = time.perf_counter()
    train_detector(model, dict(cfg.data.train), cfg, validate=True, work_dir=work)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = roi_counts()
    lines = read_log(work)
    train = [ln for ln in lines if ln["mode"] == "train"]
    evals = [ln for ln in lines if ln["mode"] == "val"]
    steps = MASK_TOOL_IMAGES // 2
    sd = Checkpointer.load(os.path.join(work, "epoch_1.pth"))["state_dict"]
    log("mask-tools", f"train_detector: {len(train)} steps in {wall:.2f} s (build of the "
                      f"loaders and the evaluation included); loss_mask "
                      f"{[round(ln['loss_mask'], 5) for ln in train]}; step ms "
                      f"{[round(ln['time'] * 1e3, 3) for ln in train]}; evaluation "
                      f"{ {k: v for k, v in (evals[0] if evals else {}).items() if k.startswith('bbox_mAP')} }; "
                      f"launches by bin count {counts} ({nvidia_smi_line()})")
    want = {"roi_align_fwd": {7: steps + MASK_TOOL_IMAGES, MASK_BINS: steps + MASK_TOOL_IMAGES},
            "roi_align_bwd": {7: steps, MASK_BINS: steps}}
    if (len(train) != steps or len(evals) != 1 or "bbox_mAP" not in evals[0]
            or not all(math.isfinite(ln["loss_mask"]) and ln["loss_mask"] > 0 for ln in train)
            or "roi_head.mask_head.upsample.weight" not in sd or counts != want):
        raise AssertionError(f"mask-tools: the run went wrong: {train} {evals} {counts} "
                             f"(want {want})")
    _count_launches(rows, counts, "launches_mask_tools")
    del model
    torch.cuda.empty_cache()
    return dict(wall_s=wall, step_ms=[ln["time"] * 1e3 for ln in train],
                bbox_mAP=evals[0]["bbox_mAP"])


def phase_mask(rows, val):
    """7g: the Cityscapes Mask R-CNN's paths (serving, the training step, the
    tools), each driven with B1's and B2's counts set to 0 just before it and
    read just after. -> (numbers, a function that profiles a request per
    dtype)."""
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    serve = phase_mask_serve(rows)
    train, train_profile_fn = phase_mask_train(rows, val, tmp.name)
    tools = phase_mask_tools(rows, val, tmp.name)
    tmp.cleanup()
    log("mask", f"phase 7g: {time.perf_counter() - t0:.2f} s")

    def profile():
        cfg = mask_cfg()
        for name in DTYPES:
            serve[name]["busy"] = serving_profile(name, cfg, "mask-profile")
        train_profile_fn()

    return dict(serve=serve, train=train, tools=tools), profile


# ------------------------------------------------------------ long tail ----
#
# The long tail's first slice: the IoU-loss family (GIoU stands in for it),
# RetinaNet, the caffe-C4 Faster R-CNN (B1 and B2 at 14x14 on one level at
# C = 1024), ResNeXt-101 32x4d and the DCNv2 ResNet-50, each at its config's
# full width; RetinaNet and DCN on Cityscapes 2048x1024, the rest on COCO
# 1333x800, each training at its config's samples_per_gpu.

COCO_HW = (800, 1333)
LONGTAIL = (
    ("giou", "configs/faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py", COCO_HW),
    ("retinanet", "configs/retinanet/retinanet_r50_fpn_1x_coco.py", (IMG_H, IMG_W)),
    ("c4", "configs/faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py", COCO_HW),
    ("x101", "configs/faster_rcnn/faster_rcnn_x101_32x4d_fpn_1x_coco.py", COCO_HW),
    ("dcn", "configs/dcn/faster_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py", (IMG_H, IMG_W)),
)
C4_H, C4_W = 800 // 16, 1344 // 16      # the C4 level of an 800x1344 canvas
C4_CHANNELS = 1024
C4_PROPOSALS = 1000                     # test_cfg.rpn.max_per_img
C4_SAMPLED = 2 * 512                    # 2 images x the rcnn sampler's 512
RETINA_NMS = (5 * 1000, 80)             # 5 levels x nms_pre candidates, 80 classes
NMS_EXPONENT = 58.4                     # u ** 58.4 > 0.05 for 5% of u: ~20,000 pass


def longtail_cfg(path):
    """The config as published, with seeded weights (its backbone's
    model-zoo ``init_cfg`` cut)."""
    from oadg_tpu_torch.config import load_config
    cfg = load_config(str(ROOT / path))
    cfg.model.backbone.init_cfg = None
    cfg.model.pop("pretrained", None)
    return cfg


ONESTAGE_CLASSIFIERS = ("retina_cls", "conv_cls", "atss_cls", "gfl_cls", "vfnet_cls", "tood_cls",
                        "reppoints_cls_out", "cls_score")
PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
HEAT_PRIOR_BIAS = -math.log((1 - 0.1) / 0.1)     # mmdet's CenterNet and corner heatmaps
SOFTMAX_HEADS = ("SSDHead", "YOLACTHead")         # their classifier: ``softmax_classifier``
DETR_HEADS = ("DETRHead", "DeformableDETRHead")
CORNER_SHIFT = math.log(5.0)                      # a served CentripetalNet's log shift, cells


def classifier_biases(head):
    """A one-stage head's classifier biases: the class conv's, or
    CenterNet's heatmap conv's, or each stack's two corner heatmap convs'."""
    if hasattr(head, "heatmap_head"):
        return [head.heatmap_head[2].bias]
    if hasattr(head, "cls_branches"):                         # Deformable DETR: one a layer
        return [c.bias for c in head.cls_branches]
    if hasattr(head, "tl_heat"):
        return [branch[1].conv.bias for branch in (*head.tl_heat, *head.br_heat)]
    if hasattr(head, "multi_level_conv_cls"):                 # YOLOX: class and objectness
        return [c.bias for c in (*head.multi_level_conv_cls, *head.multi_level_conv_obj)]
    return [getattr(head, next(n for n in ONESTAGE_CLASSIFIERS if hasattr(head, n))).bias]


def classifier_prior(model):
    """mmdet's start for a one-stage classifier: the bias at the 0.01 prior
    (and TOOD's probability map's; CenterNet's and the corner heads'
    heatmaps at 0.1), where the JAX heads start at 0 (ROADMAP C: a seeded
    JAX-init TOOD or VFNet step sums every negative's loss over ~one
    positive and two SGD steps overflow; a JAX-init CenterNet's heatmap
    loss sums every cell's). RetinaNet's, PAA's and NAS-FPN's ``retina_cls``
    start there already, GA's and SABL's at 0. -> the classifier biases."""
    import torch
    head = model.bbox_head
    if type(head).__name__ in SOFTMAX_HEADS + ("DETRHead",):   # softmax: mmdet's bias is 0 too
        return []
    biases = classifier_biases(head)
    heat = hasattr(head, "heatmap_head") or hasattr(head, "tl_heat")
    with torch.no_grad():
        for b in biases:
            b.fill_(HEAT_PRIOR_BIAS if heat else PRIOR_BIAS)
        if hasattr(head, "cls_prob_module"):
            head.cls_prob_module[2].bias.fill_(PRIOR_BIAS)
    return biases


def widen_classifier(model, seed=50):
    """Seeded wider class logits, so that a random detector's scores pass
    ``score_thr`` (81-way softmax or sigmoid at the 0.01 prior would not):
    ``fc_cls`` weights N(0, 0.1) (each stage's of a cascade); a dense head's
    classifier bias moved by N(0, 1.5) per output channel from the 0.01
    prior (``classifier_prior``; YOLOv3's class logits the same a prior
    of each level, its objectness as initialized), and PAA's IoU branch's
    bias set to a 0.03
    prior (its score is the root of the class sigmoid times the IoU
    sigmoid: at 0 most of its 400,000 candidates would pass ``score_thr``,
    at 0.01 none; at 0.03 the classes drawn 1.4 sigma above the prior, 4
    of 80 with this seed). The corner heads pair their top corners only
    where both are of one class and the embeddings are within 0.5 of each
    other (CornerNet) or the shifted centres within 0.3 of the box
    (CentripetalNet): so that seeded corners make boxes, their heatmaps
    share one draw a class, and the last convs of their heatmap, offset,
    embedding and shift branches are drawn N(0, 1e-4) (with the JAX init
    the logits and the offsets spread ~10 over the cells), the heatmaps'
    positive (so that the top corners sit where the pooled maps are
    largest: top-left corners above and left of bottom-right ones), the
    shifts' bias at ``CORNER_SHIFT`` (centres 5 cells in: boxes of 8 to 14
    cells pass)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        if hasattr(model, "roi_head"):
            heads = model.roi_head.bbox_head         # a cascade's: one a stage
            for head in heads if isinstance(heads, torch.nn.ModuleList) else [heads]:
                w = head.fc_cls.weight
                w.copy_(torch.randn(w.shape, generator=gen) * 0.1)
        elif type(model.bbox_head).__name__ in SOFTMAX_HEADS:
            softmax_classifier(model.bbox_head, gen)
        elif type(model.bbox_head).__name__ in DETR_HEADS:
            pass           # their test calls keep the top queries: no score threshold
        elif type(model.bbox_head).__name__ == "YOLOV3Head":
            # the class logits from the 0.01 prior plus N(0, 1.5) a class, as
            # the dense heads' below: at the JAX init (0) each prior's 80
            # sigmoid(0) * objectness 0.5 pass score_thr, and the NMS of a
            # 208x416 request sorts 240,000 candidates (1.8 s on the card)
            head = model.bbox_head
            noise = torch.randn(head.num_classes, generator=gen) * 1.5
            for conv in head.convs_pred:
                conv.bias.view(-1, head.num_attrib)[:, 5:] = PRIOR_BIAS + noise.to(conv.bias.device)
        else:
            biases = classifier_prior(model)
            if hasattr(model.bbox_head, "multi_level_conv_obj"):      # YOLOX
                for conv in model.bbox_head.multi_level_conv_obj:
                    conv.bias.add_(YOLOX_OBJ_SHIFT)
                biases = biases[:len(model.bbox_head.multi_level_conv_cls)]
            noise = torch.randn(biases[0].shape, generator=gen) * 1.5   # the corners' shared
            for b in biases:
                b.add_(noise.to(b.device))
            head = model.bbox_head
            shifts = [*getattr(head, "tl_centripetal_shift", ()),
                      *getattr(head, "br_centripetal_shift", ())]
            narrow = [*getattr(head, "tl_heat", ()), *getattr(head, "br_heat", ()),
                      *getattr(head, "tl_off", ()), *getattr(head, "br_off", ()),
                      *getattr(head, "tl_emb", ()), *getattr(head, "br_emb", ()), *shifts]
            for branch in narrow:
                conv = branch[1].conv
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 1e-4)
            for branch in (*getattr(head, "tl_heat", ()), *getattr(head, "br_heat", ())):
                branch[1].conv.weight.abs_()
            for branch in shifts:
                branch[1].conv.bias.fill_(CORNER_SHIFT)
            if hasattr(model.bbox_head, "retina_iou"):
                model.bbox_head.retina_iou.bias.fill_(-math.log(0.97 / 0.03))


SOFTMAX_BG = 8.0         # a served softmax head's background logit bias
YOLOX_OBJ_SHIFT = 2.5    # a served YOLOX's objectness bias above the 0.01 prior


def softmax_classifier(head, gen):
    """A softmax head's (SSD's, YOLACT's) class logits drawn so that a
    realistic number of candidates passes ``score_thr``: each anchor's
    background bias at ``SOFTMAX_BG`` and the class biases N(0, 1.5) (at the
    JAX init's 0 every one of SSD's 8,732 x 80 candidates sits near 1/81,
    under its 0.02, and YOLACT's under its 0.05)."""
    import torch
    convs = list(head.cls_convs) if hasattr(head, "cls_convs") else [head.conv_cls]
    nc1 = head.num_classes + 1
    for conv in convs:
        b = conv.bias.view(-1, nc1)
        b[:, -1] = SOFTMAX_BG
        b[:, :-1] = (torch.randn(b[:, :-1].shape, generator=gen) * 1.5).to(b.device)


def c4_roi_cases(dev):
    """B1 and B2 at the C4 shapes (14x14 bins, one level at stride 16, C =
    1024), f32 and bf16: B1 at a request (one 50x84 map of an 800x1344
    canvas, R = 1000 proposals), B2 at the training step (2 maps, R = 2 x
    512 sampled rois). -> (B1 cases, B2 cases), the f32 case first."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(60)
    serve = torch.randn(1, C4_CHANNELS, C4_H, C4_W, device=dev, generator=gen)
    train = torch.randn(2, C4_CHANNELS, C4_H, C4_W, device=dev, generator=gen)
    rng = np.random.RandomState(60)
    srois = torch.from_numpy(flagship_rois(rng, C4_PROPOSALS, 0, 800, 1333)).to(dev)
    trois = torch.from_numpy(np.concatenate(
        [flagship_rois(rng, C4_SAMPLED // 2, b, 800, 1333) for b in range(2)])).to(dev)
    dy = torch.randn(trois.shape[0], C4_CHANNELS, 14, 14, device=dev, generator=gen)
    fwd, bwd = [], []
    for name in DTYPES:
        dt = torch_dtype(name)
        s, t = (m.to(dt).contiguous(memory_format=torch.channels_last) for m in (serve, train))
        fwd.append((f"{name}, c4 14x14, serving, 1 map {C4_H}x{C4_W}x{C4_CHANNELS}, "
                    f"R={srois.shape[0]}", [s], srois))
        bwd.append((f"{name}, c4 14x14, training, 2 maps {C4_H}x{C4_W}x{C4_CHANNELS}, "
                    f"R={trois.shape[0]}", [t], trois, dy))
    return fwd, bwd


def phase_c4_kernels():
    """c4-kernels: B1 and B2 at the C4 shapes against their plain versions
    (``TOL_F32`` / ``TOL_BF16``), timed beside their bounds. -> the report
    rows ``roi_align_fwd_c4`` and ``roi_align_bwd_c4`` (their plain times
    from ``phase_profiled``, their launches from phase ``longtail``)."""
    import torch
    fwd, bwd = c4_roi_cases(torch.device("cuda", 0))
    out = []
    for name, source, replaces, cases, check in (
            ("roi_align_fwd_c4", "roi_align_fwd.cu", "oadg_tpu/ops/pallas_roi_bwd.py:248",
             fwd, lambda c: check_fwd_case(*c, strides=(16,), phase="c4-kernels", bins=14)),
            ("roi_align_bwd_c4", "roi_align_bwd.cu", "oadg_tpu/ops/pallas_roi_bwd.py:316",
             bwd, lambda c: check_bwd_case(*c, strides=(16,), phase="c4-kernels"))):
        results = [(c[0], check(c)) for c in cases]
        (label, main), others = results[0], results[1:]
        out.append(row(name, source, replaces, *main,
                       cases=[case_row(label, *r) for label, r in others]) | {"label": label})
    del fwd, bwd
    torch.cuda.empty_cache()
    return out


class _NmsRecorder:
    """Stands in for ``multiclass_nms`` in one module for one call: the
    candidates, those above ``score_thr``, the tiles the tiled NMS runs, its
    ms by the host clock between two synchronises, and the peak memory above
    what was allocated when it was called."""

    def __init__(self, module):
        self.module, self.real, self.calls = module, module.multiclass_nms, []
        module.multiclass_nms = self

    def __call__(self, boxes, scores, score_thr, *args, **kwargs):
        import torch
        c = scores.shape[-1] - 1
        above = (scores[..., :c] > score_thr).flatten(1).sum(1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = self.real(boxes, scores, score_thr, *args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append(dict(candidates=scores.shape[1] * c, above=above.tolist(),
                               tiles=[-(-int(a) // 256) for a in above],
                               ms=(time.perf_counter() - t0) * 1e3,
                               peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30))
        return out

    def restore(self):
        self.module.multiclass_nms = self.real


def longtail_batch(cfg, hw, n, seed):
    """``n`` seeded uint8 images of ``hw`` through the config's test
    pipeline (resize, normalize, pad; no flip) with ``NUM_GTS`` seeded gts
    each: the training step's batch on the card."""
    import torch
    from oadg_tpu_torch.apis import prepare_image
    rng = np.random.RandomState(seed)
    parts = [prepare_image(rng.randint(0, 256, (*hw, 3), dtype=np.uint8), cfg, "cuda")
             for _ in range(n)]
    h, w = (int(v) for v in parts[0]["img_shape"][0].tolist())
    gt, labels = seeded_gts(rng, n, h, w)
    return {"img": torch.cat([p["img"] for p in parts]).contiguous(
                memory_format=torch.channels_last),
            "img_shape": torch.cat([p["img_shape"] for p in parts]),
            "gt_bboxes": torch.from_numpy(gt).cuda(),
            "gt_labels": torch.from_numpy(labels).cuda(),
            "gt_valid": torch.ones((n, NUM_GTS), dtype=torch.bool, device="cuda")}


def _record_giou_inputs():
    """Records the (pred, target, weight, avg_factor) of ``GIoULoss`` calls;
    -> (the records, a function that puts the loss back)."""
    from oadg_tpu_torch.models.losses import common
    real, seen = common.GIoULoss.__call__, []

    def recording(self, pred, target, weight=None, avg_factor=None, **kw):
        seen.append((pred.detach(), target, weight, avg_factor))
        return real(self, pred, target, weight=weight, avg_factor=avg_factor, **kw)

    common.GIoULoss.__call__ = recording

    def restore():
        common.GIoULoss.__call__ = real

    return seen, restore


def check_iou_family(records):
    """The IoU family on the GIoU step's decoded boxes: each loss on the card
    against the same on the CPU (float32; rtol 1e-5: the same elementwise
    arithmetic, the sums over the rows in another order)."""
    import torch
    from oadg_tpu_torch.utils.registry import LOSSES, build_from_cfg
    pred, target, weight, avg = records[-1]
    out = {}
    for cfg in (dict(type="IoULoss", loss_weight=10.0), dict(type="GIoULoss", loss_weight=10.0),
                dict(type="CIoULoss", loss_weight=12.0),
                dict(type="BoundedIoULoss", loss_weight=10.0)):
        loss = build_from_cfg(dict(cfg), LOSSES)
        card = float(loss(pred.float(), target, weight, avg_factor=avg))
        cpu = float(loss(pred.float().cpu(), target.cpu(), weight.cpu(),
                         avg_factor=avg.cpu() if torch.is_tensor(avg) else avg))
        out[cfg["type"]] = card
        log("longtail", f"giou step's decoded boxes ({pred.shape[0]} rows, "
                        f"{int((weight[:, 0] > 0).sum())} positive): {cfg['type']} card "
                        f"{card:.6f} CPU {cpu:.6f}")
        if not (math.isfinite(card) and abs(card - cpu) <= 1e-5 * abs(cpu) + 1e-7):
            raise AssertionError(f"longtail {cfg['type']}: card {card} vs CPU {cpu}")
    return out


def shared_proposal_test(phase, family, cpu, card, bc, gc):
    """A two-stage f32 model's test call on the card and on the CPU with the
    RoI head on the card's proposals on both (so that no RPN near-tie in the
    proposals' ranking decides which boxes are compared): the neck's levels
    and the RPN's maps held within ``TOL_HEAD`` of each one's largest. ->
    (the card's (dets, labels, valid), the CPU's)."""
    fc, fg = cpu.extract_feat(bc["img"]), card.extract_feat(gc["img"])
    cc, rc = cpu.rpn_head(fc)
    cg, rg = card.rpn_head(fg)
    for what, got, want in (("neck level", fg, fc), ("rpn cls level", cg, cc),
                            ("rpn reg level", rg, rc)):
        for i, (a, b) in enumerate(zip(got, want)):
            check_close(phase, f"{family} f32: {what} {i} card vs CPU", a, b, TOL_HEAD)
    boxes, _, valid = card.rpn_head.get_proposals(cg, rg, gc["img_shape"])
    dg = card.roi_head.simple_test(fg, boxes, valid, gc["img_shape"], gc["scale_factor"])
    dc = cpu.roi_head.simple_test(fc, boxes.cpu(), valid.cpu(), bc["img_shape"],
                                  bc["scale_factor"])
    return dg, dc


def longtail_serve(rows, family, path, hw, name, cfg=None, phase="longtail",
                   shared_proposals=False, checked=False, cpu_check=True):
    """One request of a ``hw`` uint8 image through the config's test
    pipeline (``serve_batch``) and ``DetectorHandle.test`` after a warm-up
    (every dense head's ``multiclass_nms`` recorded on the warm-up; the
    fifth slice's (anchor, class) candidates above ``score_thr`` counted,
    ``candidates_above``), and the card against the same seeded model on
    the CPU on a 256x384 request (SSD's resized to 300x300 by its
    pipeline; f32; detections matched, SOLO's masks by ``_match_masks``;
    the two-stage models on 100 proposals there; the CPU model takes the
    card model's weights). ``cfg`` is the config to
    build (``longtail_cfg(path)`` when None); the request must launch B1 and
    B2 as ``path_launches(family, False)`` says. ``shared_proposals`` runs the
    CPU comparison through ``shared_proposal_test``; ``checked`` holds B1's
    every call in the warm-up request to its plain version in place (its
    1,000 proposals at 7x7); ``cpu_check`` False leaves the CPU comparison
    out."""
    import copy
    import torch
    from oadg_tpu_torch.apis import init_detector
    from oadg_tpu_torch.models.dense_heads import retina_head
    cfg = longtail_cfg(path) if cfg is None else cfg
    handle = init_detector(cfg, device="cuda", seed=0, dtype=torch_dtype(name))
    widen_classifier(handle.model)
    img = np.random.RandomState(51).randint(0, 256, (*hw, 3), dtype=np.uint8)
    # every dense head's NMS goes through retina_head.nms_detections
    rec = (_NmsRecorder(retina_head) if family == "retinanet" or (
        family in ONESTAGE_NAMES and family not in WITHOUT_NMS) else None)
    checks, restore = _checked_roi_align() if checked else ((), lambda: None)
    try:
        handle.test(serve_batch(family, handle, img, handle.cfg))          # warm-up
    finally:
        restore()
        if rec is not None:
            rec.restore()
    torch.cuda.synchronize()
    if checked:
        _report_checks(phase, f"{family} {name} request", checks,
                       {"roi_align_fwd": [NUM_ROIS], "roi_align_bwd": []})
    torch.cuda.reset_peak_memory_stats()
    zero_roi_counts()
    t0 = time.perf_counter()
    res = handle.test(serve_batch(family, handle, img, handle.cfg))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    shapes = roi_shape_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    head = getattr(handle.model, "bbox_head", None)
    k = int(getattr(head, "test_cfg", {}).get("max_per_img", 100))
    ok, valid, labels = served_outputs(family, head, res, k)
    nc = handle.num_classes
    out = dict(request_ms=ms, peak_gib=peak, valid=int(valid.sum()))
    if rec is not None:
        out["nms"] = rec.calls[0]
    if family in FIFTH:
        batch = serve_batch(family, handle, img, handle.cfg)
        out["above_score_thr"], total, thr = candidates_above(family, handle.model, batch)
    log(phase, f"{family} {name}: a request of {hw[0]}x{hw[1]}: {ms:.3f} ms, "
               f"max_memory_allocated {peak:.2f} GiB, {int(valid.sum())} valid "
               f"detections of {k}; launches by (bins, levels) {shapes}"
               + (f"; multiclass_nms {rec.calls[0]}" if rec is not None else "")
               + (f"; {out['above_score_thr']} of {total} (anchor, class) candidates above "
                  f"score_thr {thr}" if family in FIFTH else "")
               + f" ({nvidia_smi_line()})")
    want = path_launches(family, False)
    if (not ok or not valid.any() or not ((labels[valid] >= 0) & (labels[valid] < nc)).all()
            or shapes != want):
        raise AssertionError(f"{phase} {family} {name}: bad request {shapes} (want {want})")
    _count_shape_launches(rows, shapes, f"launches_{phase}_{family}"
                          + ("" if name == "f32" else "_bf16"))
    if name == "f32" and cpu_check:   # the card's weights on the CPU: drawing them again costs ~1 s
        from oadg_tpu_torch.apis.inference import DetectorHandle
        from oadg_tpu_torch.models import build_detector
        cpu_model = build_detector(dict(cfg.model), device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in handle.model.state_dict().items()})
        cpu = DetectorHandle(cpu_model.eval(), cfg, torch.device("cpu"))
        small = copy.deepcopy(cfg)
        small.merge_from_dict({"data.test.pipeline.1.img_scale": (384, 256)})
        bc = serve_batch(family, cpu, img[:256, :384], small)
        gc = {k: v.cuda() if torch.is_tensor(v) else v for k, v in bc.items()}
        rpn_cfgs = [m.rpn_head.test_cfg for m in (cpu.model, handle.model)
                    if getattr(getattr(m, "rpn_head", None), "test_cfg", None) is not None]
        kept = [c["max_per_img"] for c in rpn_cfgs]
        for c in rpn_cfgs:              # 100 proposals keep the CPU's RoI head short
            c["max_per_img"] = 100
        test = solo_test if family == "solo" else lambda model, b: model.simple_test(b)
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                if shared_proposals:
                    dg, dc = shared_proposal_test(phase, family, cpu.model, handle.model, bc, gc)
                else:
                    dc = test(cpu.model, bc)
                    dg = test(handle.model, gc)
        finally:
            for c, k in zip(rpn_cfgs, kept):
                c["max_per_img"] = k
        if family == "panoptic_fpn":                 # the stuff probabilities, then the boxes
            (dg, pg), (dc, pc) = dg, dc
            stuff_err = float((pg.cpu() - pc).abs().max())
            if stuff_err > 1e-4:
                raise AssertionError(f"{phase} {family}: stuff probabilities card vs CPU "
                                     f"{stuff_err}")
            log(phase, f"{family} f32: stuff probabilities card vs CPU within {stuff_err:.3e}")
        if family == "solo":
            matched, what = _match_masks(dg, dc, 1e-4, float(head.test_cfg.get("mask_thr", 0.5)))
            counts = (int((dg[2] > 0).sum()), int((dc[2] > 0).sum()))
        else:
            # Sparse R-CNN's boxes are its proposals moved by six stages' deltas,
            # never clipped to the image: held within 1e-4 of the largest coordinate
            scale = float(dc[0][..., :4].abs().max())
            box_tol = 1e-4 * scale if family in SPARSE else 1e-2
            matched = _match_dets(dg[:3], dc[:3], box_tol, 1e-4)
            counts = (int(dg[2].sum()), int(dc[2].sum()))
            what = (f"boxes within {box_tol:.3g} px, the largest coordinate {scale:.1f}; "
                    f"scores within 1e-4")
        log(phase, f"{family} f32: a {tuple(bc['img'].shape[2:])} request card vs CPU: "
                   f"{counts[0]} and {counts[1]} valid, {100 * matched:.1f}% of the card's "
                   f"held by the CPU's ({what}); CPU side {time.perf_counter() - t0:.2f} s")
        if matched < 0.95 or abs(counts[0] - counts[1]) > 2 or not counts[1]:
            raise AssertionError(f"{phase} {family}: card vs CPU {matched} {counts}")
        out["card_vs_cpu"] = matched
        del cpu
    del handle
    torch.cuda.empty_cache()
    return out


def longtail_train(rows, family, path, hw, name, cfg=None, phase="longtail", masks=False,
                   prepare=None, probe=None, unpad=False, batch=None, warmup_batch=None):
    """Two training steps (``make_train_step``, SGD at the config's LR, no
    OA-Mix) on ``samples_per_gpu`` images of ``hw`` through the test
    pipeline with seeded gts: losses finite float32, B1 and B2 once a step
    at 7x7 (14x14 for C4, where a third step holds every call to the plain
    versions in place); the GIoU step's decoded boxes kept for
    ``check_iou_family``. Phase ``twostage`` gives the config (``cfg``) and
    ``masks`` (box-cropped gt masks from polygons, ``polygon_gt_masks``;
    every ``loss_mask`` then > 0); phase ``onestage`` ``prepare``, applied
    to the model before the steps (``classifier_prior``). The two steps must launch B1 and B2 as
    ``path_launches(family, True)`` says; C4 and HTC run a third step with
    every call held to the plain versions in place (``IN_PLACE_CALLS``).
    ``probe(model, batch)``, where given, runs after the steps and its dict
    joins the result (LD's ``teacher_ms``). ``unpad`` cuts the batch's
    images to SSD's 300x300 (``unpadded``). ``batch``, where given, is the
    steps' batch (PanopticFPN's from its loader); a step on ``warmup_batch``,
    where given, runs before the counted two."""
    import torch
    cfg = longtail_cfg(path) if cfg is None else cfg
    n = cfg.data.samples_per_gpu
    model, step = build_trainer("cuda", cfg, dtype=torch_dtype(name))
    if prepare is not None:
        prepare(model)
    if batch is None:
        batch = longtail_batch(cfg, hw, n, 52)
    if unpad:
        batch = unpadded(batch)
    if masks:
        batch["gt_masks"] = polygon_gt_masks(batch["gt_bboxes"], batch["img_shape"], 53)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if warmup_batch is not None:
        step(warmup_batch, gen)
    seen, restore = _record_giou_inputs() if family == "giou" else ([], lambda: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_roi_counts()
    times, logs = [], []
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            logs.append(step(batch, gen))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        restore()
    shapes = roi_shape_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(phase, f"{family} {name}: 2 steps on {n} image(s) of "
               f"{tuple(batch['img'].shape[2:])}: ms {[round(t, 3) for t in times]}; "
               f"max_memory_allocated {peak:.2f} GiB; launches by (bins, levels) {shapes}; "
               f"last step "
               + ", ".join(f"{k} {float(v):.5f}" for k, v in logs[-1].items())
               + f" ({nvidia_smi_line()})")
    want = path_launches(family, True)
    finite = all(bool(torch.isfinite(v).all()) and v.dtype == torch.float32
                 for lv in logs for v in lv.values())
    mask_ok = not masks or all(float(v) > 0 for lv in logs for k, v in lv.items()
                               if k.endswith("loss_mask"))
    if not (shapes == want and finite and mask_ok):
        raise AssertionError(f"{phase} {family} {name}: {shapes} (want {want}), {logs[-1]}")
    _count_shape_launches(rows, shapes, f"launches_{phase}_{family}"
                          + ("" if name == "f32" else "_bf16"))
    out = dict(step_ms=times, peak_gib=peak,
               losses={k: float(v) for k, v in logs[-1].items()})
    if family == "giou":
        out["iou_family"] = check_iou_family(seen)
    if probe is not None:
        out.update(probe(model, batch))
    if family in IN_PLACE_CALLS:
        checks, restore = _checked_roi_align()
        try:
            step(batch, gen)
        finally:
            restore()
        torch.cuda.synchronize()
        calls = IN_PLACE_CALLS[family]
        _report_checks(phase, f"{family} {name}", checks,
                       {"roi_align_fwd": calls, "roi_align_bwd": calls})
    del model, step, batch
    torch.cuda.empty_cache()
    return out


def _peak_above(fn):
    """-> (fn's result, its ms by the host clock with a synchronise, the
    peak memory it allocated above what was allocated when it started, GiB)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            (torch.cuda.max_memory_allocated() - base) / 2 ** 30)


def longtail_nms():
    """The tiled NMS at the sizes that made the one-tile NMS hold tens of
    GiB: RetinaNet's ``multiclass_nms`` over 5 x 1000 x 80 = 400,000 seeded
    candidates (about 20,000 above ``score_thr``; its detections equal the
    CPU's), then YOLOv3's 3 x 1000 x 8 = 24,000 candidates (half above
    ``score_thr``) and the DWD RPN level's 12,000 proposals, each resolved
    in one tile (the NMS before this change) and in 256-box tiles: equal
    keep sets, each's time and peak above its inputs."""
    import torch
    from oadg_tpu_torch.core.post_processing.nms import (batched_nms_padded, multiclass_nms,
                                                         nms_padded)
    rng = np.random.RandomState(53)
    out = {}
    n, c = RETINA_NMS
    xy = rng.uniform(0, [IMG_W, IMG_H], (1, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 400, (1, n, 2))], -1).astype(np.float32)
    scores = np.zeros((1, n, c + 1), np.float32)
    scores[..., :c] = rng.uniform(0, 1, (1, n, c)) ** NMS_EXPONENT
    above = int((scores[..., :c] > 0.05).sum())
    bc, sc = torch.from_numpy(boxes), torch.from_numpy(scores)
    bg, sg = bc.cuda(), sc.cuda()
    runs = [_peak_above(lambda: multiclass_nms(bg, sg, 0.05, 0.5, 100, c)) for _ in range(3)]
    t0 = time.perf_counter()
    want = multiclass_nms(bc, sc, 0.05, 0.5, 100, c)
    cpu_s = time.perf_counter() - t0
    same = all(torch.equal(g.cpu(), w) for g, w in zip(runs[-1][0], want))
    out["retinanet"] = dict(candidates=n * c, above=above, tiles=-(-above // 256),
                            ms=statistics.median(r[1] for r in runs),
                            peak_gib=max(r[2] for r in runs))
    log("longtail-nms", f"RetinaNet's multiclass_nms over 1 x {n} x {c} = {n * c} candidates, "
                        f"{above} above score_thr ({-(-above // 256)} tiles of 256): ms "
                        f"{[round(r[1], 3) for r in runs]}, peak above the inputs "
                        f"{out['retinanet']['peak_gib']:.3f} GiB; {int(want[2].sum())} "
                        f"detections equal to the CPU's: {same} (CPU {cpu_s:.2f} s) "
                        f"({nvidia_smi_line()})")
    if not same or int(want[2].sum()) != 100:
        raise AssertionError("longtail-nms: RetinaNet's multiclass_nms disagrees with the CPU")
    del bg, sg, runs
    # YOLOv3's request: 3 levels x 1000 priors x 8 classes, class-offset boxes
    k = 3 * 1000 * 8
    xy = rng.uniform(0, 1024, (1, k, 2))
    yb = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(8, 500, (1, k, 2))], -1)
                          .astype(np.float32)).cuda()
    ys = torch.from_numpy(rng.uniform(0, 1, (1, k)).astype(np.float32) ** 2).cuda()
    yl = torch.arange(8, device="cuda").repeat(k // 8)[None]
    # the DWD RPN level: 12,000 proposals, all valid
    xy = rng.uniform(0, [1280, 736], (1, 1, 12000, 2))
    db = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(16, 600, (1, 1, 12000, 2))], -1)
                          .astype(np.float32)).cuda()
    ds = torch.rand(1, 1, 12000, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(54))
    for case, fn in (("yolov3", lambda t: batched_nms_padded(yb, ys, yl, 0.45, ys > 0.05,
                                                             tile_size=t)),
                     ("dwd_rpn", lambda t: nms_padded(db, ds, 0.7, tile_size=t))):
        one, one_ms, one_gib = _peak_above(lambda: fn(None))
        tiled, tiled_ms, tiled_gib = _peak_above(lambda: fn(256))
        same = torch.equal(one, tiled)
        out[case] = dict(one_tile_ms=one_ms, one_tile_gib=one_gib, tiled_ms=tiled_ms,
                         tiled_gib=tiled_gib, kept=int(tiled.sum()))
        log("longtail-nms", f"{case} NMS over {tiled.numel()} candidates: one tile {one_ms:.3f} "
                            f"ms, peak above the inputs {one_gib:.3f} GiB; 256-box tiles "
                            f"{tiled_ms:.3f} ms, {tiled_gib:.3f} GiB; keep sets equal: {same} "
                            f"({int(tiled.sum())} kept) ({nvidia_smi_line()})")
        if not same:
            raise AssertionError(f"longtail-nms {case}: tiled and one-tile keep sets differ")
        del one, tiled
        torch.cuda.empty_cache()
    return out


def phase_longtail(rows):
    """longtail: per family of ``LONGTAIL``, per dtype, a request and two
    training steps at the config's full width (``longtail_serve``,
    ``longtail_train``), each with B1's and B2's counts set to 0 just
    before it and read just after, then the NMS sizes (``longtail_nms``).
    -> numbers."""
    import torch
    t0 = time.perf_counter()
    out = {}
    for family, path, hw in LONGTAIL:
        for name in DTYPES:
            out[f"{family}_{name}"] = dict(serve=longtail_serve(rows, family, path, hw, name),
                                           train=longtail_train(rows, family, path, hw, name))
            torch.cuda.empty_cache()
    out["nms"] = longtail_nms()
    log("longtail", f"phase longtail: {time.perf_counter() - t0:.2f} s")
    return out


# ---------------------------------------------------------------- twostage ----
# The two-stage family's seven configs, each on the Cityscapes
# dataset base: 1024x2048, one image a step, 80 classes as published.
TWOSTAGE = (
    ("cascade", "configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py"),
    ("htc", "configs/htc/htc_r50_fpn_1x_coco.py"),
    ("scnet", "configs/scnet/scnet_r50_fpn_1x_coco.py"),
    ("dynamic", "configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_coco.py"),
    ("double_head", "configs/double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py"),
    ("ms_rcnn", "configs/ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py"),
    ("pisa", "configs/pisa/pisa_faster_rcnn_r50_fpn_1x_coco.py"),
)
CASCADES = ("cascade", "htc", "scnet")
SEMANTIC = ("htc", "scnet")
WITH_MASKS = ("htc", "scnet", "ms_rcnn", "point_rend")
# mmdet's mask RoI layer, which the four mask configs lack: without it the
# mask head's 14x14 logits meet MS R-CNN's and PointRend's 28x28 targets
# (JAX raises), and HTC and SCNet run their masks at the box layer's 7x7
MASK_ROI_EXTRACTOR = dict(type="SingleRoIExtractor",
                          roi_layer=dict(type="RoIAlign", output_size=14, sampling_ratio=0),
                          out_channels=CHANNELS, featmap_strides=list(STRIDES))
SEM_STRIDE = 8                  # the semantic embedding's one level


def twostage_cfg(family, path):
    """``longtail_cfg`` with mmdet's 14x14 mask RoI layer for the mask
    configs (``WITH_MASKS``), and ``schedule_1x`` for the Double-Head config,
    which names no schedule (neither package can train it as published)."""
    from oadg_tpu_torch.config import load_config
    cfg = longtail_cfg(path)
    if "optimizer" not in cfg:
        sched = load_config(str(ROOT / "configs/_base_/schedules/schedule_1x.py"))
        cfg.merge_from_dict({k: sched[k] for k in ("optimizer", "optimizer_config",
                                                   "lr_config")})
    if family in WITH_MASKS:
        cfg.merge_from_dict({"model.roi_head.mask_roi_extractor": dict(MASK_ROI_EXTRACTOR)})
    return cfg


# ------------------------------------------------------------ twostage2 ----
# The two-stage family's last four configs on the Cityscapes dataset base
# (1024x2048, one image a step, 80 classes as published), and TridentNet's
# backbone alone (its detector is refused: the JAX one cannot run).
TWOSTAGE2 = (
    ("sparse", "configs/sparse_rcnn/sparse_rcnn_r50_fpn_1x_coco.py"),
    ("queryinst", "configs/queryinst/queryinst_r50_fpn_1x_coco.py"),
    ("grid", "configs/grid_rcnn/grid_rcnn_r50_fpn_gn-head_2x_coco.py"),
    ("point_rend", "configs/point_rend/point_rend_r50_caffe_fpn_mstrain_1x_coco.py"),
)
SPARSE = ("sparse", "queryinst")
SPARSE_STAGES = 6
SPARSE_PROPOSALS = 100
TRIDENT_SHAPE = (3, 2048, IMG_H // 32, IMG_W // 32)


def sparse_roi_cases(dev):
    """B1 and B2 at Sparse R-CNN's stage: 7x7 bins on one 1024x2048 image's
    four FPN maps (256x512 .. 32x64, C = 256), R = 100 learned-proposal
    boxes (log-uniform sizes up to the whole image), f32 and bf16. ->
    (B1 cases, B2 cases)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(80)
    maps = [torch.randn(1, CHANNELS, IMG_H // s, IMG_W // s, device=dev, generator=gen)
            for s in STRIDES]
    rng = np.random.RandomState(80)
    bw = np.exp(rng.uniform(np.log(32), np.log(IMG_W), SPARSE_PROPOSALS))
    bh = np.exp(rng.uniform(np.log(32), np.log(IMG_H), SPARSE_PROPOSALS))
    x1, y1 = rng.uniform(0, IMG_W - bw), rng.uniform(0, IMG_H - bh)
    rois = torch.from_numpy(np.stack([np.zeros(SPARSE_PROPOSALS), x1, y1, x1 + bw, y1 + bh],
                                     1).astype(np.float32)).to(dev)
    dy = torch.randn(SPARSE_PROPOSALS, CHANNELS, 7, 7, device=dev, generator=gen)
    fwd, bwd = [], []
    for name in DTYPES:
        fs = [m.to(torch_dtype(name)).contiguous(memory_format=torch.channels_last)
              for m in maps]
        label = f"sparse {name}, 7x7, 1 image's 4 maps 256x512..32x64x256, R={SPARSE_PROPOSALS}"
        fwd.append((label, fs, rois))
        bwd.append((label, fs, rois, dy))
    return fwd, bwd


def phase_sparse_kernels(rows):
    """sparse-kernels: B1 and B2 at Sparse R-CNN's stage shape against their
    plain versions (``TOL_F32`` / ``TOL_BF16``), f32 and bf16, timed beside
    their bounds; added to B1's and B2's rows as cases (their plain times
    from ``profile_roi_plain``, their launches from phase ``twostage2``,
    which counts them under the 7x7 rows)."""
    import torch
    fwd, bwd = sparse_roi_cases(torch.device("cuda", 0))
    by_name = {r["name"]: r for r in rows}
    for label, fs, rois in fwd:
        err, t, nbytes = check_fwd_case(label, fs, rois, phase="sparse-kernels")
        by_name["roi_align_fwd"]["cases"].append(case_row(label, err, t, nbytes))
    for label, fs, rois, dy in bwd:
        err, t, nbytes = check_bwd_case(label, fs, rois, dy, phase="sparse-kernels")
        by_name["roi_align_bwd"]["cases"].append(case_row(label, err, t, nbytes))
    del fwd, bwd
    torch.cuda.empty_cache()


def trident_forward(name):
    """``TridentResNet`` as the config builds it (depth 50, three branches at
    dilations 1, 2, 3) with seeded weights, one forward of a normalized
    1024x2048 image in train mode (the branches on the batch) and one in
    test mode: shapes, finite values, ms and peak memory."""
    import torch
    from oadg_tpu_torch.models.layers import init_default_
    from oadg_tpu_torch.utils.registry import BACKBONES, build_from_cfg
    cfg = longtail_cfg("configs/tridentnet/tridentnet_r50_caffe_1x_coco.py")
    net = build_from_cfg(dict(cfg.model.backbone), BACKBONES,
                         dict(device=torch.device("cuda"), dtype=torch_dtype(name)))
    init_default_(net, torch.Generator().manual_seed(0))
    x = torch.randn(1, 3, IMG_H, IMG_W, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(81))
    out = {}
    with torch.inference_mode():
        net(x)                                                       # warm-up
        for mode, shape in (("train", TRIDENT_SHAPE), ("test", (1, *TRIDENT_SHAPE[1:]))):
            net.mode = mode
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (y,) = net(x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            ok = tuple(y.shape) == shape and bool(torch.isfinite(y).all())
            out[mode] = dict(shape=list(y.shape), ms=ms,
                             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            log("twostage2", f"trident {name} {mode}: {tuple(y.shape)} {y.dtype}, finite "
                             f"{bool(torch.isfinite(y).all())}, {ms:.3f} ms, "
                             f"max_memory_allocated {out[mode]['peak_gib']:.2f} GiB "
                             f"({nvidia_smi_line()})")
            if not ok:
                raise AssertionError(f"twostage2 trident {name} {mode}: {tuple(y.shape)}, "
                                     f"want {shape} finite")
    del net
    torch.cuda.empty_cache()
    return out


def phase_twostage2(rows):
    """twostage2: Sparse R-CNN, Grid R-CNN and PointRend (with mmdet's 14x14
    mask RoI layer) per dtype at the config's full width with seeded weights
    (the classifiers drawn wider): a request of a 1024x2048 image (the f32
    model against the CPU on a 256x384 request) and two training steps on
    one image with seeded gts (box-cropped gt masks from polygons for
    PointRend), each with B1's and B2's counts set to 0 just before it and
    read just after, held to ``path_launches``; one more Sparse step (six
    stages) and Grid step (7x7 and the grid branch's 14x14) a dtype with
    every B1 and B2 call held to the plain versions in place. QueryInst:
    one f32 request. TridentResNet: one forward per dtype and mode. ->
    numbers."""
    import torch
    t0 = time.perf_counter()
    out = {}
    for family, path in TWOSTAGE2:
        cfg = twostage_cfg(family, path)
        for name in (("f32",) if family == "queryinst" else DTYPES):
            res = dict(serve=longtail_serve(rows, family, path, (IMG_H, IMG_W), name, cfg=cfg,
                                            phase="twostage2"))
            if family != "queryinst":
                res["train"] = longtail_train(rows, family, path, (IMG_H, IMG_W), name,
                                              cfg=cfg, phase="twostage2",
                                              masks=family in WITH_MASKS)
            out[f"{family}_{name}"] = res
            torch.cuda.empty_cache()
    for name in DTYPES:
        out[f"trident_{name}"] = trident_forward(name)
    log("twostage2", f"phase twostage2: {time.perf_counter() - t0:.2f} s")
    return out


def path_launches(family, train):
    """B1's and B2's launches by (bins, levels) that one request (``train``
    False) or two steps (of ``samples_per_gpu`` images) of a long-tail or
    two-stage family make: 7x7 on the pyramid once a box stage (three in a
    cascade, six in Sparse R-CNN; none in RetinaNet and the one-stage
    family and the DETRs; C4's 14x14 on one level
    instead); with masks 14x14 on the pyramid once a mask stage (PointRend's
    request too: Mask R-CNN's test path), Grid R-CNN's grid branch the same
    in training, and for HTC and SCNet 14x14 on the semantic embedding's one
    level once a mask stage; B2 as B1 in training, never in a request."""
    if family == "retinanet" or family in ONESTAGE_NAMES or family in DETRS or \
            family == YOLO_BACKBONE:
        per = {}
    elif family == "c4":
        per = {(MASK_BINS, 1): 1}
    elif family in SPARSE:
        per = {(7, 4): SPARSE_STAGES}
    else:
        per = {(7, 4): 3 if family in CASCADES else 1}
    if family == "point_rend":              # Mask R-CNN's request: masks on the detections
        per[(MASK_BINS, 4)] = 1
    if not train:
        return {"roi_align_fwd": per, "roi_align_bwd": {}}
    if family in WITH_MASKS + ("grid", "panoptic_fpn"):    # the mask or the grid branch
        per[(MASK_BINS, 4)] = per[(7, 4)]
    if family in SEMANTIC:
        per[(MASK_BINS, 1)] = per[(7, 4)]
    return {k: {shape: 2 * n for shape, n in per.items()}
            for k in ("roi_align_fwd", "roi_align_bwd")}


# Each kernel's calls' R on the third step held in place: C4's 2 x 512
# sampled rois; one HTC image's 512 sampled rois a box stage and 128 mask
# slots a mask stage, on the pyramid and on the semantic level; Sparse
# R-CNN's 100 proposals a stage; Grid R-CNN's 512 sampled rois and 128 grid
# slots at 14x14; PanopticFPN's 512 sampled rois and 128 mask slots.
IN_PLACE_CALLS = {"c4": [C4_SAMPLED],
                  "htc": [TRAIN_ROIS] * 3 + [MASK_SLOTS] * 6,
                  "sparse": [100] * 6,
                  "grid": [TRAIN_ROIS, MASK_SLOTS],
                  "panoptic_fpn": [TRAIN_ROIS, MASK_SLOTS],
                  **{f: [TRAIN_ROIS] for f in ("regnet", "res2net", "resnest", "carafe", "fpg")}}


def polygon_gt_masks(gt, img_shape, seed, m0=56):
    """(N, G, m0, m0) box-cropped gt masks on the card: an octagon polygon
    touching the four sides of each seeded gt box (inner points jittered),
    rasterised by the port's ``PolygonMasks`` over the image and cropped to
    its box, as the train pipeline and the collate make them."""
    import torch
    from oadg_tpu_torch.core.mask.structures import PolygonMasks
    rng = np.random.RandomState(seed)
    boxes = gt.cpu().numpy()
    out = []
    for b, (h, w) in zip(boxes, img_shape.cpu().numpy().astype(int)):
        polys = []
        for x1, y1, x2, y2 in b:
            (p, q), (r, t) = rng.uniform(0.15, 0.45, 2), rng.uniform(0.55, 0.85, 2)
            pts = [(p, 0), (r, 0), (1, q), (1, t), (r, 1), (p, 1), (0, t), (0, q)]
            polys.append([np.array([v for px, py in pts
                                    for v in (x1 + px * (x2 - x1), y1 + py * (y2 - y1))])])
        out.append(PolygonMasks(polys, h, w).to_bitmap().to_box_cropped(b, m0))
    return torch.from_numpy(np.stack(out)).cuda()


def sem_roi_cases(dev):
    """B1 and B2 at HTC's semantic RoIAlign: 14x14 bins on the one stride-8
    embedding of a 1024x2048 image (1 map 128x256x256), R = 128 mask slots
    jittered around the seeded gts; f32 and bf16. -> (B1 cases, B2 cases),
    the f32 case first."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(70)
    emb = torch.randn(1, CHANNELS, IMG_H // SEM_STRIDE, IMG_W // SEM_STRIDE, device=dev,
                      generator=gen)
    rois = torch.from_numpy(mask_slot_rois(np.random.RandomState(70), 0)).to(dev)
    dy = torch.randn(rois.shape[0], CHANNELS, MASK_BINS, MASK_BINS, device=dev, generator=gen)
    fwd, bwd = [], []
    for name in DTYPES:
        m = emb.to(torch_dtype(name)).contiguous(memory_format=torch.channels_last)
        label = (f"{name}, semantic 14x14, 1 map {emb.shape[2]}x{emb.shape[3]}x{CHANNELS} "
                 f"(stride {SEM_STRIDE}), R={rois.shape[0]}")
        fwd.append((label, [m], rois))
        bwd.append((label, [m], rois, dy))
    return fwd, bwd


def phase_sem_kernels():
    """sem-kernels: B1 and B2 at HTC's semantic RoIAlign shape against their
    plain versions (``TOL_F32`` / ``TOL_BF16``), timed beside their bounds.
    -> the report rows ``roi_align_fwd_sem`` and ``roi_align_bwd_sem``
    (their plain times from ``phase_profiled``, their launches from phase
    ``twostage``)."""
    import torch
    fwd, bwd = sem_roi_cases(torch.device("cuda", 0))
    out = []
    strides = (SEM_STRIDE,)
    for name, source, replaces, cases, check in (
            ("roi_align_fwd_sem", "roi_align_fwd.cu", "oadg_tpu/ops/pallas_roi_bwd.py:248",
             fwd, lambda c: check_fwd_case(*c, strides=strides, phase="sem-kernels",
                                           bins=MASK_BINS)),
            ("roi_align_bwd_sem", "roi_align_bwd.cu", "oadg_tpu/ops/pallas_roi_bwd.py:316",
             bwd, lambda c: check_bwd_case(*c, strides=strides, phase="sem-kernels"))):
        results = [(c[0], check(c)) for c in cases]
        (label, main), others = results[0], results[1:]
        out.append(row(name, source, replaces, *main,
                       cases=[case_row(label, *r) for label, r in others]) | {"label": label})
    del fwd, bwd
    torch.cuda.empty_cache()
    return out


def phase_twostage(rows):
    """twostage: per config of ``TWOSTAGE``, per dtype, at the config's full
    width with seeded weights (the classifiers drawn wider): a request of a
    1024x2048 image (with the f32 model against the CPU on a 256x384
    request) and two training steps on one image with seeded gts (and
    box-cropped gt masks from polygons for HTC, SCNet and MS R-CNN), each
    with B1's and B2's counts set to 0 just before it and read just after,
    held to ``path_launches``; one more HTC step a dtype with every B1
    and B2 call held to the plain versions in place. -> numbers."""
    import torch
    t0 = time.perf_counter()
    out = {}
    for family, path in TWOSTAGE:
        cfg = twostage_cfg(family, path)
        for name in DTYPES:
            out[f"{family}_{name}"] = dict(
                serve=longtail_serve(rows, family, path, (IMG_H, IMG_W), name, cfg=cfg,
                                     phase="twostage"),
                train=longtail_train(rows, family, path, (IMG_H, IMG_W), name, cfg=cfg,
                                     phase="twostage", masks=family in WITH_MASKS))
            torch.cuda.empty_cache()
    log("twostage", f"phase twostage: {time.perf_counter() - t0:.2f} s")
    return out


DIST_STEPS = 2                  # timed steps a side, after one warm-up step
DIST_STAGES = STAGES[:5] + ("train_step: backward", "train_step: allreduce",
                            "train_step: sgd")
DIST_TRAIN_IMAGES = 2           # the launch script's run: 1 step of 2 images, one epoch
DIST_VAL_IMAGES = 2             # its evaluation's and the test script's images
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_world_one():
    """This process as rank 0 of a world of 1 over NCCL, through
    ``parallel.init_distributed`` from torchrun's environment
    (``MASTER_ADDR=127.0.0.1``, a free port). -> a function that destroys
    the group and puts the environment back."""
    import os
    import torch
    from oadg_tpu_torch.parallel import init_distributed
    saved = {k: os.environ.get(k) for k in DIST_ENV}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))
    info = init_distributed("pytorch", device="cuda")
    backend = torch.distributed.get_backend()
    if info != (0, 1) or backend != "nccl":
        raise AssertionError(f"init_distributed gave {info} over {backend}, not (0, 1) over nccl")

    def close():
        torch.distributed.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    return close


class deterministic:
    """cuDNN's deterministic algorithms and PyTorch's deterministic mode
    (``warn_only``: an op without a deterministic version warns, and its
    warnings are kept in ``warned``) for the duration; the settings are put
    back on exit. The flagship's step without them is not reproducible bit
    for bit on the card (cuDNN's weight gradients)."""

    def __enter__(self):
        import warnings
        import torch
        self.saved = (torch.backends.cudnn.deterministic,
                      torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled())
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        self.catch = warnings.catch_warnings(record=True)
        self.records = self.catch.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        import torch
        self.catch.__exit__(*exc)
        self.warned = sorted({str(w.message).split(".")[0][:160] for w in self.records
                              if "deterministic" in str(w.message)})
        torch.backends.cudnn.deterministic = self.saved[0]
        torch.use_deterministic_algorithms(self.saved[1], warn_only=self.saved[2])


def dist_flagship(name, rows):
    """8a at ``name``: the flagship's OA-DG step (OA-Mix on the slots chain)
    from phase 7's start (seeded weights, generator seed 0, the uint8 batch
    of ``raw_train_batch(RandomState(3))``), a warm-up and ``DIST_STEPS``
    timed steps without a process group, then the same with the NCCL group
    of world 1 (the distributed step: gathered contrastive rows, all-reduced
    normalizers, the summed gradient in ``train_step: allreduce``), both
    under ``deterministic()``. Every logged value of every step, every
    parameter and buffer after them bit-equal; B1-B6 counted over the
    distributed run against the tables.
    -> (numbers, the distributed step and its inputs, for the profile)."""
    import torch
    from oadg_tpu_torch.config import load_config
    from oadg_tpu_torch.engine import make_oadg_preprocess
    from oadg_tpu_torch.ops.roi_align import ROI_ALIGN_BWD, ROI_ALIGN_FWD
    dev = torch.device("cuda", 0)
    cfg = load_config(FLAGSHIP)
    oamix_cfg = flagship_oamix_cfg()
    wrappers = dict(roi_align_fwd=ROI_ALIGN_FWD, roi_align_bwd=ROI_ALIGN_BWD, **oamix_wrappers())

    def run(group):
        pre = {}
        model, step = build_trainer("cuda", cfg, lambda b, g: pre["p"](b, g),
                                    dtype=torch_dtype(name))
        pre["p"] = make_oadg_preprocess(oamix_cfg, cfg["img_norm_cfg"], out_dtype=model.dtype)
        batch = raw_train_batch(np.random.RandomState(3), IMG_H, IMG_W, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        close = nccl_world_one() if group else None
        for w in wrappers.values():
            w.launches = 0
        want = dict(roi_align_fwd=0, roi_align_bwd=0, **dict.fromkeys(oamix_wrappers(), 0))
        logs, times = [], []
        try:
            for i in range(1 + DIST_STEPS):
                t0 = time.perf_counter()
                logs.append(step(batch, gen))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                want["roi_align_fwd"] += 2
                want["roi_align_bwd"] += 2
                for k, n in expected_launches(pre["p"].draws, oamix_cfg["version"]).items():
                    want[k] += n
        except BaseException:
            if close:
                close()
            raise
        launched = {k: w.launches for k, w in wrappers.items()}
        return dict(model=model, step=step, batch=batch, gen=gen, logs=logs, close=close,
                    ms=statistics.median(times[1:]), launched=launched, want=want)

    with deterministic() as mode:
        one = run(False)
        state_one = {k: v.detach().clone() for k, v in one["model"].state_dict().items()}
        del one["model"], one["step"]
        torch.cuda.empty_cache()
        two = run(True)
    log("dist", f"{name}: both runs with cuDNN's deterministic algorithms and PyTorch's "
                f"deterministic mode; ops without a deterministic version: {mode.warned}")
    try:
        bad_logs = [(i, k) for i, (a, b) in enumerate(zip(two["logs"], one["logs"]))
                    for k in b if not torch.equal(a[k].float(), b[k].float())]
        state = two["model"].state_dict()
        bad_state = [k for k, v in state_one.items() if not torch.equal(state[k], v)]
        log("dist", f"{name}: {1 + DIST_STEPS} steps with and without the NCCL group: "
                    f"logged values of every step {'bit-equal' if not bad_logs else bad_logs}; "
                    f"{len(state_one)} parameters and buffers after them, "
                    f"{len(bad_state)} differ {bad_state[:4]}")
        for i, lv in enumerate(two["logs"]):
            log("dist", f"{name}, distributed step {i}: " + ", ".join(
                f"{k} {float(v):.6f}" for k, v in lv.items()))
        if bad_logs or bad_state:
            raise AssertionError(f"{name}: the world-1 NCCL step is not bit-equal to the "
                                 f"non-distributed one: logs {bad_logs[:4]}, state "
                                 f"{bad_state[:4]}")
        log("dist", f"{name}: step median of {DIST_STEPS}: without a group {one['ms']:.3f} ms, "
                    f"NCCL world 1 {two['ms']:.3f} ms ({nvidia_smi_line()})")
        log("dist", f"{name}: launches in the distributed run {two['launched']}; the tables "
                    f"imply {two['want']}")
        if two["launched"] != two["want"] or not all(two["launched"][k] for k in LOOP_KERNELS):
            raise AssertionError(f"{name}: the distributed steps launched {two['launched']}, "
                                 f"not {two['want']}")
        for r in rows:
            if r["name"] in two["launched"]:
                r["launches_dist" + ("" if name == "f32" else "_bf16")] = \
                    two["launched"][r["name"]]
    except BaseException:
        two["close"]()
        raise
    return dict(step_ms=one["ms"], dist_step_ms=two["ms"]), two


def dist_yolo():
    """8b: one step of the seeded OA-DG YOLOv3 (2 images x 2 fixed views of
    256x256, the same generator) without a group and with the NCCL group of
    world 1 (its live BNs then sum their statistics through the group:
    SyncBN's arithmetic), held to each other within phase 7d's card limits:
    each loss within 1e-3, every gradient within ``YOLO_F32_LEAF`` of its
    norm and their median within ``YOLO_F32_MEDIAN``, the whole gradient's
    cosine at least 0.9999; the live BNs' stored statistics within 1e-3 of
    their norm."""
    import torch
    cfg = yolo_cfg()
    dev = torch.device("cuda", 0)
    fixed = fixed_view_batch(np.random.RandomState(44), 256, 256, cfg, dev, views=2)

    def run(group):
        model, step = build_trainer("cuda", cfg)
        close = nccl_world_one() if group else None
        try:
            lv = step(fixed, torch.Generator(device=dev).manual_seed(5))
            torch.cuda.synchronize()
        finally:
            if close:
                close()
        return ({k: float(v) for k, v in lv.items()},
                {k: p.grad.double().cpu() for k, p in model.named_parameters()},
                {k: v.double().cpu() for k, v in model.state_dict().items() if "running_" in k})

    (l1, g1, s1), (l2, g2, s2) = run(False), run(True)
    for k in YOLO_LOSSES:
        err = abs(l2[k] - l1[k]) / max(abs(l1[k]), 1e-6)
        log("dist", f"yolo f32: {k} with the group {l2[k]:.6f}, without {l1[k]:.6f}, rel err "
                    f"{err:.2e} (limit 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"yolo {k} with vs without the group: {l2[k]} vs {l1[k]}")
    d = leaf_distances(g2, g1)
    flat = [torch.cat([g[k].reshape(-1) for k in sorted(g1)]) for g in (g2, g1)]
    cos = float(flat[0] @ flat[1] / (flat[0].norm() * flat[1].norm()))
    ds = leaf_distances(s2, s1)
    log("dist", f"yolo f32: gradients with the group from without, over {len(d)}: median "
                f"{statistics.median(d.values()):.3e}, worst {max(d.values()):.3e} (limits "
                f"{YOLO_F32_MEDIAN:g}, {YOLO_F32_LEAF:g}); cosine {cos:.8f} (limit 0.9999); "
                f"{len(ds)} stored BN statistics, worst {max(ds.values()):.3e} (limit 1e-3)")
    if not (max(d.values()) <= YOLO_F32_LEAF and statistics.median(d.values()) <= YOLO_F32_MEDIAN
            and cos >= 0.9999 and max(ds.values()) <= 1e-3):
        raise AssertionError("yolo: the world-1 SyncBN step is not within phase 7d's limits of "
                             "the non-distributed one")


def dist_tools(val, train):
    """8c: ``tools/torch_dist_train.sh FLAGSHIP 1 --launcher pytorch`` (f32)
    on ``DIST_TRAIN_IMAGES`` of phase 7b's PNGs: one epoch of 1 step and an
    evaluation on the first ``DIST_VAL_IMAGES`` of the tools' val set; then
    ``tools/torch_dist_test.sh`` of its checkpoint over those PNGs with
    ``--out``, whose pickle must equal this process's ``single_gpu_test`` of
    the same checkpoint."""
    import os
    import pickle
    import tempfile
    import torch
    from oadg_tpu_torch.apis import build_test_loader, load_model_state, single_gpu_test
    from oadg_tpu_torch.config import load_config
    tmp = tempfile.TemporaryDirectory()
    try:
        ann = _subset_json(train[0], DIST_TRAIN_IMAGES, os.path.join(tmp.name, "train.json"))
        val = (_subset_json(val[0], DIST_VAL_IMAGES, os.path.join(tmp.name, "val.json")), val[1])
        work = os.path.join(tmp.name, "work")
        env = dict(os.environ, PYTHON=sys.executable, PORT=str(free_port()))
        for k in DIST_ENV:
            env.pop(k, None)
        options = {"data.train.times": 1, "data.train.dataset.ann_file": ann,
                   "data.train.dataset.img_prefix": train[1], "data.val.ann_file": val[0],
                   "data.val.img_prefix": val[1], "runner.max_epochs": 1,
                   "log_config.interval": 1}
        t0 = time.perf_counter()
        res = subprocess.run(["bash", str(ROOT / "tools" / "torch_dist_train.sh"), str(FLAGSHIP),
                              "1", "--work-dir", work, "--seed", "0", "--cfg-options",
                              *(f"{k}={v}" for k, v in options.items())],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        train_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"tools/torch_dist_train.sh exited {res.returncode}:\n"
                                 f"{res.stdout[-2000:]}{res.stderr[-4000:]}")
        lines = read_log(work)
        modes = [ln["mode"] for ln in lines]
        ckpt = os.path.join(work, "epoch_1.pth")
        log("dist", f"tools/torch_dist_train.sh (1 process, NCCL) exit 0 in {train_s:.2f} s: "
                    f"log.json modes {modes}, losses "
                    f"{[round(ln['loss'], 5) for ln in lines if ln['mode'] == 'train']}")
        if modes != ["train", "val"] or not os.path.exists(ckpt) or \
                not all(math.isfinite(ln["loss"]) for ln in lines if ln["mode"] == "train"):
            raise AssertionError(f"the launch script's run logged {modes}")
        out = os.path.join(tmp.name, "dist.pkl")
        test_opts = [f"data.test.ann_file={val[0]}", f"data.test.img_prefix={val[1]}"]
        env["PORT"] = str(free_port())
        t0 = time.perf_counter()
        res = subprocess.run(["bash", str(ROOT / "tools" / "torch_dist_test.sh"), str(FLAGSHIP),
                              ckpt, "1", "--out", out, "--eval", "bbox", "--cfg-options",
                              *test_opts], cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=600)
        test_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"tools/torch_dist_test.sh exited {res.returncode}:\n"
                                 f"{res.stdout[-2000:]}{res.stderr[-4000:]}")
        with open(out, "rb") as f:
            got = pickle.load(f)
        cfg = load_config(FLAGSHIP)
        cfg.merge_from_dict(dict(a.split("=", 1) for a in test_opts))
        _, loader = build_test_loader(cfg, pin_memory=True)
        want = single_gpu_test(load_model_state(cfg, ckpt, device="cuda"), loader)
        within, bits = _same_results(got, want)
        n_dets = sum(len(a) for r in want for a in r)
        log("dist", f"tools/torch_dist_test.sh exit 0 in {test_s:.2f} s: {len(got)} images' "
                    f"results, {n_dets} detections; against single_gpu_test in this process: "
                    f"{'bit-equal' if bits else 'not bit-equal'}; "
                    + (res.stdout.strip().splitlines() or ["(no output)"])[-1][:200])
        if len(got) != DIST_VAL_IMAGES or not bits:
            raise AssertionError("the launch script's test pickle differs from single_gpu_test")
        torch.cuda.empty_cache()
        return dict(train_s=train_s, test_s=test_s)
    finally:
        tmp.cleanup()


def phase_dist(rows, val, train):
    """8: data parallel on the card (one card: world 1 over NCCL).
    -> (numbers, a function that profiles one distributed step per dtype and
    then destroys the group)."""
    import torch
    t0 = time.perf_counter()
    out, kept = {}, {}
    for name in DTYPES:
        out[name], kept[name] = dist_flagship(name, rows)
        kept[name]["close"]()               # the group lives again only for the profile
        torch.cuda.empty_cache()
    for r in rows:
        r["launches"] += r.get("launches_dist", 0)
    dist_yolo()
    out["tools"] = dist_tools(val, train)
    log("dist", f"phase 8: {time.perf_counter() - t0:.2f} s")

    def profile():
        """One profiled distributed step per dtype (after every timed run):
        the ``train_step: allreduce`` span's host and device ms beside the
        step's, and the device's busy share."""
        for name in DTYPES:
            k = kept[name]
            close = nccl_world_one()
            try:
                busy, spans = train_profile(k["step"], k["batch"], k["gen"], "slots", name,
                                            stages=DIST_STAGES, tag="dist-profile")
            finally:
                close()
            out[name].update(busy=busy, allreduce_host_ms=spans["train_step: allreduce"][0],
                             allreduce_device_ms=spans["train_step: allreduce"][1])
        kept.clear()

    return out, profile


# ------------------------------------------------------------- onestage ----
# The one-stage family's first seven configs on the Cityscapes dataset base
# (1024x2048, one image a step, 80 classes as published).
ONESTAGE = (
    ("fcos", "configs/fcos/fcos_r50_fpn_1x_coco.py"),
    ("atss", "configs/atss/atss_r50_fpn_1x_coco.py"),
    ("gfl", "configs/gfl/gfl_r50_fpn_1x_coco.py"),
    ("vfnet", "configs/vfnet/vfnet_r50_fpn_1x_coco.py"),
    ("tood", "configs/tood/tood_r50_fpn_1x_coco.py"),
    ("paa", "configs/paa/paa_r50_fpn_1x_coco.py"),
    ("autoassign", "configs/autoassign/autoassign_r50_fpn_8x2_1x_coco.py"),
    ("fovea", "configs/foveabox/fovea_r50_fpn_4x4_1x_coco.py"),
    ("fsaf", "configs/fsaf/fsaf_r50_fpn_1x_coco.py"),
    ("free_anchor", "configs/free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py"),
    ("pisa_retina", "configs/pisa/pisa_retinanet_r50_fpn_1x_coco.py"),
    ("ld", "configs/ld/ld_r18_gflv1_r101_fpn_coco_1x.py"),
    ("ga_retina", "configs/guided_anchoring/ga_retinanet_r50_fpn_1x_coco.py"),
    ("sabl_retina", "configs/sabl/sabl_retinanet_r50_fpn_1x_coco.py"),
    ("nas_fpn", "configs/nas_fpn/retinanet_r50_nasfpn_crop640_50e_coco.py"),
    ("nas_fcos", "configs/nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_4x4_1x_coco.py"),
    ("reppoints", "configs/reppoints/reppoints_moment_r50_fpn_1x_coco.py"),
    ("centernet", "configs/centernet/centernet_resnet18_140e_coco.py"),
    ("cornernet", "configs/cornernet/cornernet_hourglass104_mstest_8x6_210e_coco.py"),
    ("centripetalnet",
     "configs/centripetalnet/centripetalnet_hourglass104_mstest_16x6_210e_coco.py"),
    ("yolof", "configs/yolof/yolof_r50_c5_8x8_1x_coco.py"),
    ("yolox", "configs/yolox/yolox_s_8x8_300e_coco.py"),
    ("ssd", "configs/ssd/ssd300_coco.py"),
    ("solo", "configs/solo/solo_r50_fpn_1x_coco.py"),
    ("yolact", "configs/yolact/yolact_r50_1x8_coco.py"),
)
ONESTAGE_NAMES = tuple(f for f, _ in ONESTAGE)
# the f32 requests held to the CPU: one config of each group of the family
# as ONESTAGE lists it (RepPoints and CornerNet both, for the DCNv1 head and
# the corner pools), not all 25 (22 s of CPU there; the CPU tests hold every
# one to the JAX package)
ONESTAGE_CPU_CHECKED = ("fcos", "free_anchor", "nas_fpn", "reppoints", "cornernet", "solo")
# the fifth slice's configs (their requests log the (anchor, class)
# candidates above ``score_thr``) and the two instance heads among them
# (their steps take polygon gt masks; their requests give their own outputs)
FIFTH = ("yolof", "yolox", "ssd", "solo", "yolact")
INSTANCE = ("solo", "yolact")
# heads that decode with no ``multiclass_nms``: by a top-k, or by the
# instance heads' matrix NMS and fast NMS
WITHOUT_NMS = ("centernet", "cornernet", "centripetalnet") + INSTANCE
HOURGLASS = ("cornernet", "centripetalnet")
# CenterNet's config names no data (nor a schedule): its request and steps
# take the Cityscapes base's data, as the other configs do, and the
# Cityscapes config's linear warm-up (at its config's constant LR one step
# on one image moves the heatmap bias by ~10 and the second step's losses
# read up to 1.5e16)
DATA_BASE = {f: "configs/_base_/datasets/cityscapes_detection.py"
             for f in ("centernet", "yolox", "ssd", "detr")}
# SSD's anchors are fixed to its 300x300 input: the Cityscapes base's
# pipelines resize to it with keep_ratio=False, as mmdet's ssd300_coco.py's
# do (a fix of this run; the repo's SSD config names no data)
SSD_OPTIONS = {"data.test.pipeline.1.img_scale": (300, 300),
               "data.test.pipeline.1.transforms.0.keep_ratio": False,
               "data.train.dataset.pipeline.2.img_scale": (300, 300),
               "data.train.dataset.pipeline.2.keep_ratio": False}
SCHEDULE_BASE = "configs/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py"
# the port refuses NAS-FCOS's config as given (its neck's outputs at strides 4
# to 64, its head's points at 8 to 128; ROADMAP C): it runs with this fix
ONESTAGE_OPTIONS = {"nas_fcos": {"model.neck.start_level": 1}}
BAG_PEAK_GIB = 2.0      # FreeAnchor's step peak over PISA-RetinaNet's: a (G, N, C) box_prob
                        # (4.02 GB f32 at 392,832 anchors, 32 gts, 80 classes) would pass it


def teacher_ms(model, batch):
    """LD's teacher forward (its backbone, neck and head under ``no_grad``)
    on the step's batch: the host-clock ms of the second of two runs, each
    between two synchronises."""
    import torch
    teacher = model.teacher_model
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            teacher.bbox_head(teacher.extract_feat(batch["img"]))
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def neck_ms(model, batch):
    """NAS-FPN's neck forward on the step's batch's backbone maps (under
    ``no_grad``, in the model's mode): the host-clock ms of the second of two
    runs, each between two synchronises."""
    import torch
    with torch.no_grad():
        maps = model.backbone(batch["img"])
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.neck(maps)
            torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def backbone_ms(model, batch):
    """The backbone's forward on the step's batch (under ``no_grad``, in the
    model's mode): the host-clock ms of the second of two runs, each between
    two synchronises."""
    import torch
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.backbone(batch["img"])
            torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def onestage_cfg(family, path):
    """``longtail_cfg(path)`` with the family's ``ONESTAGE_OPTIONS``, and the
    dataset base's ``data`` and ``img_norm_cfg`` and the Cityscapes config's
    ``lr_config`` where the config has none (``DATA_BASE``,
    ``SCHEDULE_BASE``)."""
    from oadg_tpu_torch.config import load_config
    cfg = longtail_cfg(path)
    cfg.merge_from_dict(ONESTAGE_OPTIONS.get(family, {}))
    if family in DATA_BASE and not cfg.get("data"):
        base = load_config(str(ROOT / DATA_BASE[family]))
        cfg.data = base.data
        cfg.img_norm_cfg = base.img_norm_cfg
        cfg.lr_config = load_config(str(ROOT / SCHEDULE_BASE)).lr_config
    if family == "ssd":
        cfg.merge_from_dict(SSD_OPTIONS)
    return cfg


def unpadded(batch, size=(300, 300)):
    """SSD's batch cut to its fixed 300x300 input (``prepare_image`` and
    ``prepare_batch`` pad every image to a multiple of 32, 320), its
    ``img_shape`` with it."""
    h, w = size
    shape = batch["img_shape"]
    return dict(batch, img=batch["img"][..., :h, :w].contiguous(),
                img_shape=shape.new_tensor([[h, w]] * shape.shape[0]))


def serve_batch(family, handle, img, cfg):
    """A request's batch of the uint8 image ``img`` on the handle's device:
    SSD's through its test pipeline's 300x300 resize (``prepare_batch``,
    ``unpadded``), the others' through ``prepare_image`` with ``cfg``."""
    from oadg_tpu_torch.apis import prepare_batch, prepare_image
    if family == "ssd":
        return unpadded(prepare_batch(handle, img))
    return prepare_image(img, cfg, handle.device)


def served_outputs(family, head, res, k):
    """A test call's outputs -> (their shapes, dtypes and values as they
    should be for ``k`` rows an image, the valid rows, the labels): SOLO's
    (masks, labels, scores), YOLACT's (dets, labels, valid, coefficients),
    PanopticFPN's ((dets, labels, valid), stuff probabilities at stride 8
    summing to 1), the others' (dets, labels, valid)."""
    import torch
    from oadg_tpu_torch.apis.test import fetch_dets
    if family == "panoptic_fpn":                  # ((dets, labels, valid), stuff probabilities)
        res, probs = res
        ok = (probs.dim() == 4 and probs.shape[:3] == (1, IMG_H // 8, IMG_W // 8)
              and bool(torch.isfinite(probs).all())
              and float((probs.float().sum(-1) - 1).abs().max()) < 1e-2)
        dets, labels, valid = fetch_dets(*res)
        return ok and dets.shape == (1, k, 5) and np.isfinite(dets).all(), valid, labels
    if family == "solo":
        masks, labels, scores = res
        ok = (masks.shape[:2] == (1, k) and masks.dtype == torch.bool
              and bool(torch.isfinite(scores).all()))
        return ok, (scores > 0).cpu().numpy(), labels.cpu().numpy()
    dets, labels, valid = fetch_dets(*res[:3])
    ok = dets.shape == (1, k, 5) and np.isfinite(dets).all()
    if family == "yolact":
        ok = ok and res[3].shape == (1, k, head.num_protos) and bool(torch.isfinite(res[3]).all())
    return ok, valid, labels


def candidates_above(family, model, batch):
    """The fifth slice's (anchor, class) candidates of ``batch`` above the
    head's ``score_thr``, over every anchor, point or grid cell (before any
    ``nms_pre``) -> (the count, all candidates, the threshold)."""
    import torch
    head = model.bbox_head
    thr = float(head.test_cfg.get("score_thr", 0.05))
    with torch.inference_mode():
        outs = head(model.extract_feat(batch["img"]))
        if family == "yolox":
            _, _, cls, _, obj = head._flat(outs)
            scores = torch.sigmoid(cls) * torch.sigmoid(obj)[..., None]
        elif family == "yolof":
            scores = torch.sigmoid(outs[0][0])
        elif family == "solo":
            scores = torch.cat([torch.sigmoid(c).flatten(1) for c in outs[0]], 1)
        else:
            scores = torch.softmax(head._flat(outs)[1], -1)[..., :-1]
        return int((scores > thr).sum()), scores.numel(), thr


def solo_test(model, batch):
    """SOLO's test call with what its masks were thresholded from ->
    (masks, labels, scores, each kept row's mask probabilities (N, K, H, W)
    and its (cell, class) candidate (N, K, 2)), read from the head's
    ``candidates`` and ``mask_matrix_nms``'s kept indices on the way."""
    import torch
    from oadg_tpu_torch.models.dense_heads import instance_seg_heads
    head, seen = model.bbox_head, {"keep": []}
    real_candidates, real_nms = head.candidates, instance_seg_heads.mask_matrix_nms

    def candidates(*args, **kwargs):
        seen["candidates"] = real_candidates(*args, **kwargs)
        return seen["candidates"]

    def nms(*args, **kwargs):
        out = real_nms(*args, **kwargs)
        seen["keep"].append(out[3])
        return out

    head.candidates, instance_seg_heads.mask_matrix_nms = candidates, nms
    try:
        masks, labels, scores = model.simple_test(batch)
    finally:
        del head.candidates
        instance_seg_heads.mask_matrix_nms = real_nms
    _, ci, ni, logits = seen["candidates"]
    keep = torch.stack(seen["keep"])
    probs = torch.sigmoid(torch.gather(logits, 1, keep[..., None, None].expand(
        *keep.shape, *logits.shape[-2:])))
    ids = torch.stack([torch.gather(ni, 1, keep), torch.gather(ci, 1, keep)], -1)
    return masks, labels, scores, probs, ids


def _match_masks(a, b, score_tol, mask_thr):
    """The share of SOLO result ``a``'s valid rows (``solo_test``'s, one
    image) that ``b`` holds: the same (cell, class) candidate, the score
    within ``score_tol`` and the mask equal but at pixels whose probability
    in ``b`` lies within 1e-5 of ``mask_thr`` -> (the share, what was
    found). Raises where a candidate both hold has a pixel apart farther
    from ``mask_thr``."""
    (ma, _, sa, _, ia), (mb, _, sb, pb, ib) = [tuple(t[0].cpu() for t in x) for x in (a, b)]
    va, vb = sa > 0, sb > 0
    if not va.any():
        return 1.0, "no valid rows"
    held, flipped, far = 0, 0, 0
    near = (pb - mask_thr).abs() <= 1e-5
    for r in va.nonzero()[:, 0].tolist():
        same = (vb & (ib == ia[r]).all(-1)).nonzero()[:, 0].tolist()
        if not same:
            continue
        apart = ma[r] != mb[same[0]]
        off = int((apart & ~near[same[0]]).sum())
        flipped, far = flipped + int(apart.sum()), far + off
        held += int(abs(float(sa[r]) - float(sb[same[0]])) <= score_tol and not off)
    what = (f"the same candidates' masks {flipped} pixels apart, {far} of them farther than "
            f"1e-5 from mask_thr {mask_thr} on the CPU; scores within {score_tol}")
    if far:
        raise AssertionError(f"solo: card vs CPU: {what}")
    return held / int(va.sum()), what


def phase_onestage(rows):
    """onestage: each config of ``ONESTAGE`` per dtype at its full width with
    seeded weights (the classifier drawn wider): a request of a 1024x2048
    image (its ``multiclass_nms`` recorded, where the head has one; the f32
    model of ``ONESTAGE_CPU_CHECKED`` against the CPU on a 256x384 request)
    and two training steps on one image with seeded
    gts from mmdet's classifier prior (``classifier_prior``), every loss
    finite float32, each with B1's and B2's counts set to 0
    just before it and read just after (none launched). -> numbers."""
    import torch
    t0 = time.perf_counter()
    out = {}
    probes = {"ld": lambda model, batch: {"teacher_ms": teacher_ms(model, batch)},
              "nas_fpn": lambda model, batch: {"neck_ms": neck_ms(model, batch)}}
    for family in HOURGLASS:
        probes[family] = lambda model, batch: {"backbone_ms": backbone_ms(model, batch)}
    for family, path in ONESTAGE:
        for name in DTYPES:
            cfg = onestage_cfg(family, path)
            res = out[f"{family}_{name}"] = dict(
                serve=longtail_serve(rows, family, path, (IMG_H, IMG_W), name, cfg=cfg,
                                     phase="onestage",
                                     cpu_check=family in ONESTAGE_CPU_CHECKED),
                train=longtail_train(rows, family, path,
                                     (300, 300) if family == "ssd" else (IMG_H, IMG_W), name, cfg=cfg,
                                     phase="onestage", prepare=classifier_prior,
                                     probe=probes.get(family), masks=family in INSTANCE,
                                     unpad=family == "ssd"))
            if family == "nas_fpn":
                log("onestage", f"nas_fpn {name}: the neck's forward (7 stacks of 8 cells) "
                                f"{res['train']['neck_ms']:.3f} ms on one image of "
                                f"{IMG_H}x{IMG_W} ({nvidia_smi_line()})")
            if family in HOURGLASS:
                log("onestage", f"{family} {name}: the Hourglass-104's forward (2 stacks) "
                                f"{res['train']['backbone_ms']:.3f} ms on one image of "
                                f"{IMG_H}x{IMG_W} in train mode, steps' peak "
                                f"{res['train']['peak_gib']:.2f} GiB ({nvidia_smi_line()})")
            if family == "ld":
                step = res["train"]["step_ms"][-1]
                res["train"]["teacher_share"] = res["train"]["teacher_ms"] / step
                log("onestage", f"ld {name}: the teacher's forward {res['train']['teacher_ms']:.3f}"
                                f" ms, {100 * res['train']['teacher_share']:.1f}% of the second "
                                f"step's {step:.3f} ms ({nvidia_smi_line()})")
            nms = res["serve"].get("nms")
            log("onestage", f"{family} {name}: request {res['serve']['request_ms']:.3f} ms "
                            f"(peak {res['serve']['peak_gib']:.2f} GiB, "
                            + (f"NMS {nms['above']} of {nms['candidates']} candidates above "
                               f"score_thr, {nms['ms']:.3f} ms), " if nms else "no NMS), ")
                            + f"steps {[round(t, 3) for t in res['train']['step_ms']]} ms (peak "
                            f"{res['train']['peak_gib']:.2f} GiB), B1 and B2 launches 0 "
                            f"({nvidia_smi_line()})")
            torch.cuda.empty_cache()
    for name in DTYPES:
        bag, plain = (out[f"{f}_{name}"]["train"]["peak_gib"] for f in ("free_anchor", "pisa_retina"))
        log("onestage", f"{name}: FreeAnchor's step peak {bag:.2f} GiB, PISA-RetinaNet's (the same "
                        f"392,832 anchors, no bags) {plain:.2f} GiB ({nvidia_smi_line()})")
        if not bag - plain < BAG_PEAK_GIB:
            raise AssertionError(f"onestage {name}: FreeAnchor's peak {bag:.2f} GiB is "
                                 f"{bag - plain:.2f} GiB over PISA-RetinaNet's")
    log("onestage", f"phase onestage: {time.perf_counter() - t0:.2f} s")
    return out


# ---------------------------------------------------------- transformer ----
# DETR, Deformable DETR and PanopticFPN on the Cityscapes dataset base
# (1024x2048, one image a step, their classes as published). DETR's config
# names no data: it takes the base's, as CenterNet's does (``DATA_BASE``).
# PanopticFPN trains with mmdet's 14x14 mask RoI layer (its config names
# none: the box layer's 7x7 gives 14x14 logits against 28x28 targets, and
# both packages' steps raise; ROADMAP C) and with the gt masks and label map
# that ``LoadPanopticAnnotations`` reads from a ``CocoPanopticDataset``
# written here.
TRANSFORMER = (
    ("detr", "configs/detr/detr_r50_8x2_150e_coco.py"),
    ("deformable_detr", "configs/deformable_detr/deformable_detr_r50_16x2_50e_coco.py"),
    ("panoptic_fpn", "configs/panoptic_fpn/panoptic_fpn_r50_fpn_1x_coco.py"),
)
DETRS = ("detr", "deformable_detr")
PANOPTIC_IMAGES = 2
PANOPTIC_THINGS = 12         # thing segments an image
PANOPTIC_STUFF = (101, 102, 103, 104)     # stuff category ids: 4 bands an image


def transformer_cfg(family, path):
    """``onestage_cfg`` (the base's data where the config has none) with
    mmdet's 14x14 mask RoI layer for PanopticFPN."""
    cfg = onestage_cfg(family, path)
    if family == "panoptic_fpn":
        cfg.merge_from_dict({"model.roi_head.mask_roi_extractor": dict(MASK_ROI_EXTRACTOR)})
    return cfg


def write_panoptic(root, seed=0):
    """``PANOPTIC_IMAGES`` 1024x2048 PNGs and their COCO-panoptic PNG id maps
    (``PANOPTIC_THINGS`` rectangles of the 8 Cityscapes thing classes over 4
    stuff bands, a void strip), written by the port's encoder, and the json
    -> (ann_file, img_prefix, seg_prefix)."""
    import json
    import os
    from oadg_tpu_torch.core.evaluation.panoptic_eval import id2rgb
    from oadg_tpu_torch.data.pipelines.image_io import imwrite
    rng = np.random.RandomState(seed)
    img_dir, pan_dir = os.path.join(root, "images"), os.path.join(root, "panoptic")
    os.makedirs(img_dir)
    os.makedirs(pan_dir)
    images, anns = [], []
    for i in range(PANOPTIC_IMAGES):
        imwrite(os.path.join(img_dir, f"pan_{i}.png"),
                rng.randint(0, 256, (IMG_H, IMG_W, 3), dtype=np.uint8))
        id_map = np.zeros((IMG_H, IMG_W), np.uint32)
        segs = []
        band = IMG_H // len(PANOPTIC_STUFF)
        for k, cat in enumerate(PANOPTIC_STUFF):
            sid = 1000 + k
            id_map[k * band:(k + 1) * band] = sid
            segs.append(dict(id=sid, category_id=cat, bbox=[0, k * band, IMG_W, band],
                             iscrowd=0))
        id_map[:, :64] = 0                                          # void
        for j in range(PANOPTIC_THINGS):
            bw, bh = rng.randint(48, IMG_W // 5), rng.randint(48, IMG_H // 3)
            x, y = rng.randint(64, IMG_W - bw), rng.randint(0, IMG_H - bh)
            sid = 2000 + j
            id_map[y:y + bh, x:x + bw] = sid
            segs.append(dict(id=sid, category_id=int(rng.choice(CITYSCAPES_CATS)),
                             bbox=[x, y, bw, bh], iscrowd=0))
        segs = [s for s in segs if (id_map == s["id"]).any()]
        for s in segs:               # the boxes of what later things left visible
            ys, xs = np.nonzero(id_map == s["id"])
            s["bbox"] = [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                         int(ys.max() - ys.min() + 1)]
        imwrite(os.path.join(pan_dir, f"pan_{i}.png"), id2rgb(id_map)[..., ::-1])
        images.append(dict(id=i, file_name=f"pan_{i}.png", width=IMG_W, height=IMG_H))
        anns.append(dict(image_id=i, file_name=f"pan_{i}.png", segments_info=segs))
    names = ("person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle")
    cats = ([dict(id=c, name=n, isthing=1) for c, n in zip(CITYSCAPES_CATS, names)]
            + [dict(id=c, name=f"stuff{c}", isthing=0) for c in PANOPTIC_STUFF])
    ann_file = os.path.join(root, "panoptic.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=cats), f)
    return ann_file, img_dir, pan_dir


def panoptic_batches(cfg, root):
    """The written dataset through ``CocoPanopticDataset`` with
    ``LoadImageFromFile`` and ``LoadPanopticAnnotations`` -> one training
    batch an image on the card: the image normalized and padded
    (``prepare_image``), the thing boxes and labels, their full-image masks
    cropped to their boxes at 56x56 (``BitmapMasks.to_box_cropped``, the
    port's mask layout), the label map ``gt_semantic_seg``; each checked
    against the written id map."""
    import torch
    from oadg_tpu_torch.apis import prepare_image
    from oadg_tpu_torch.core.mask.structures import BitmapMasks
    from oadg_tpu_torch.data import build_dataset
    ann_file, img_dir, pan_dir = write_panoptic(root)
    ds = build_dataset(dict(type="CocoPanopticDataset", ann_file=ann_file, img_prefix=img_dir,
                            seg_prefix=pan_dir,
                            pipeline=[dict(type="LoadImageFromFile"),
                                      dict(type="LoadPanopticAnnotations")]))
    batches = []
    for i in range(len(ds)):
        s = ds[i]
        g = len(s["gt_bboxes"])
        sem = s["gt_semantic_seg"]
        if not (g and s["gt_masks"].shape == (g, IMG_H, IMG_W) and (sem[:, :64] == 255).all()
                and set(np.unique(sem[:, 64:])) <= set(range(len(ds.CLASSES)))):
            raise AssertionError(f"the panoptic loader's sample {i}: {g} things, "
                                 f"masks {s['gt_masks'].shape}")
        b = prepare_image(s["img"], cfg, "cuda")
        masks = BitmapMasks(list(s["gt_masks"]), IMG_H, IMG_W).to_box_cropped(s["gt_bboxes"], m0=56)
        b.update(gt_bboxes=torch.from_numpy(s["gt_bboxes"])[None].cuda(),
                 gt_labels=torch.from_numpy(s["gt_labels"].astype(np.int32))[None].cuda(),
                 gt_valid=torch.ones((1, g), dtype=torch.bool, device="cuda"),
                 gt_masks=torch.from_numpy(np.asarray(masks, np.float32))[None].cuda(),
                 gt_semantic_seg=torch.from_numpy(sem)[None].cuda())
        b["img"] = b["img"].contiguous(memory_format=torch.channels_last)
        batches.append(b)
    log("transformer", f"panoptic_fpn: CocoPanopticDataset of {len(ds)} images through "
                       f"LoadPanopticAnnotations: {[int(b['gt_valid'].sum()) for b in batches]} "
                       f"things, label maps of {len(ds.CLASSES)} classes and void")
    return batches


def frozen_watch(prepare=None):
    """-> (a ``prepare`` that keeps the backbone's frozen parameters and
    statistics after ``prepare``'s own, a ``probe`` that fails if one moved
    in the steps and returns their count)."""
    import torch
    kept = {}

    def before(model):
        if prepare is not None:
            prepare(model)
        grads = dict(model.backbone.named_parameters())
        kept.update({k: v.detach().clone() for k, v in model.backbone.state_dict().items()
                     if k not in grads or not grads[k].requires_grad})

    def after(model, batch):
        now = model.backbone.state_dict()
        moved = [k for k, v in kept.items() if not torch.equal(now[k], v)]
        if moved or not any(k.startswith("layer1.") for k in kept):
            raise AssertionError(f"frozen backbone tensors moved: {moved[:4]}")
        return {"frozen_still": len(kept)}

    return before, after


def phase_transformer(rows):
    """transformer: each config of ``TRANSFORMER`` per dtype at its full
    width with seeded weights: a request of a 1024x2048 image (the f32 model
    against the CPU on a 256x384 request, PanopticFPN's stuff probabilities
    too), a warm-up step and two timed training steps on one image (DETR
    with its config's AdamW; Deformable DETR's classifiers from the 0.01
    prior, ``classifier_prior``; PanopticFPN's image, masks and label map from
    ``panoptic_batches``), every loss finite float32, the backbone's frozen
    stages still; B1's and B2's counts set to 0 just before each request and
    step pair and read just after: none in the DETRs', PanopticFPN's as
    ``path_launches`` says, and its third step and its warm-up request hold
    every call to the plain versions in place. -> numbers."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    out = {}
    tmp = tempfile.TemporaryDirectory()
    try:
        for family, path in TRANSFORMER:
            cfg = transformer_cfg(family, path)
            batches = panoptic_batches(cfg, tmp.name) if family == "panoptic_fpn" else None
            for name in DTYPES:
                prepare, probe = frozen_watch(classifier_prior if family in DETRS else None)
                steps = batches or [longtail_batch(cfg, (IMG_H, IMG_W),
                                                   cfg.data.samples_per_gpu, 52)] * 2
                res = out[f"{family}_{name}"] = dict(
                    serve=longtail_serve(rows, family, path, (IMG_H, IMG_W), name, cfg=cfg,
                                         phase="transformer",
                                         checked=family == "panoptic_fpn"),
                    train=longtail_train(rows, family, path, (IMG_H, IMG_W), name, cfg=cfg,
                                         phase="transformer", prepare=prepare, probe=probe,
                                         batch=steps[0], warmup_batch=steps[1]))
                del steps
                losses = res["train"]["losses"]
                if family == "panoptic_fpn":
                    seg_mask = [k for k in losses if k == "loss_semantic_seg"
                                or k.endswith("loss_mask")]
                    if len(seg_mask) < 2 or not all(losses[k] > 0 for k in seg_mask):
                        raise AssertionError(f"panoptic_fpn {name}: the step's semantic and "
                                             f"mask losses {seg_mask} not all > 0: {losses}")
                log("transformer", f"{family} {name}: request {res['serve']['request_ms']:.3f} ms "
                                   f"(peak {res['serve']['peak_gib']:.2f} GiB), steps after a "
                                   f"warm-up {[round(t, 3) for t in res['train']['step_ms']]} ms "
                                   f"(peak {res['train']['peak_gib']:.2f} GiB), {len(losses)} "
                                   f"losses finite"
                                   f"{' (loss_semantic_seg and loss_mask > 0)' if family == 'panoptic_fpn' else ''}, "
                                   f"{res['train']['frozen_still']} frozen "
                                   f"backbone tensors still, B1 and B2 launches "
                                   f"{'0' if family in DETRS else 'as path_launches'} "
                                   f"({nvidia_smi_line()})")
                torch.cuda.empty_cache()
            del batches
    finally:
        tmp.cleanup()
    log("transformer", f"phase transformer: {time.perf_counter() - t0:.2f} s")
    return out


# ---------------------------------------------------------------- backbones ----
# The configs of A.2.9a, on the Cityscapes dataset base as published
# (1024x2048, one image a step, 80 classes): four backbones under the
# Faster R-CNN R50-FPN heads, the two necks on R50, and YOLOv3 on
# MobileNetV2 (its own pipeline's 416 scale). RegNet's and Res2Net's configs
# name no schedule: they take the Cityscapes config's (``SCHEDULE_BASE``).
BACKBONE_CONFIGS = (
    ("regnet", "configs/regnet/faster_rcnn_regnetx-3.2GF_fpn_1x_coco.py"),
    ("res2net", "configs/res2net/faster_rcnn_r2_101_fpn_2x_coco.py"),
    ("resnest",
     "configs/resnest/faster_rcnn_s50_fpn_syncbn-backbone+head_mstrain-range_1x_coco.py"),
    ("carafe", "configs/carafe/faster_rcnn_r50_fpn_carafe_1x_coco.py"),
    ("fpg", "configs/fpg/faster_rcnn_r50_fpg_crop640_50e_coco.py"),
    ("mobilenet_v2", "configs/yolo/yolov3_mobilenetv2_mstrain-416_300e_coco.py"),
)
YOLO_BACKBONE = "mobilenet_v2"
YOLO_BACKBONE_CANVAS = (416, 416)       # the largest of its train pipeline's scales
# the stem parameters JAX's frozen_mask leaves trainable: moved by the steps,
# or (Res2Net, whose JAX backbone stops the gradient after the stem) kept
TRAINABLE_STEM = {"regnet": (("conv1.weight", "bn1.weight", "bn1.bias"), True),
                  "resnest": (("stem.4.weight", "stem.4.bias", "stem.7.weight", "stem.7.bias"),
                              True),
                  "res2net": (("stem.4.weight", "stem.4.bias", "stem.7.weight", "stem.7.bias"),
                              False)}
CARAFE_P3 = (1, 256, IMG_H // 8, IMG_W // 8)     # the P3 lateral CARAFE upsamples to P2


def backbone_cfg(family, path):
    """``longtail_cfg`` with the Cityscapes config's optimizer and
    schedule where the config names none."""
    from oadg_tpu_torch.config import load_config
    cfg = longtail_cfg(path)
    if not cfg.get("optimizer"):
        base = load_config(str(ROOT / SCHEDULE_BASE))
        for key in ("optimizer", "optimizer_config", "lr_config"):
            cfg[key] = base[key]
    return cfg


def backbone_watch(family):
    """-> (a ``prepare`` that keeps what the steps must leave and what they
    must move, a ``probe`` that fails where the steps did otherwise): the
    backbone's frozen tensors (``frozen_watch``) and its trainable stem
    (``TRAINABLE_STEM``), every live BN's stored statistics (MobileNetV2's
    model, FPG's neck)."""
    import torch
    from oadg_tpu_torch.models.layers import BatchNorm
    frozen = (None, None) if family == YOLO_BACKBONE else frozen_watch()
    kept = {}

    def live_stats(model):
        return {f"{n}.{k}": v for n, m in model.named_modules() if isinstance(m, BatchNorm)
                for k, v in (("running_mean", m.running_mean), ("running_var", m.running_var))}

    def before(model):
        if frozen[0] is not None:
            frozen[0](model)
        names, _ = TRAINABLE_STEM.get(family, ((), True))
        params = dict(model.backbone.named_parameters())
        if not all(params[n].requires_grad for n in names):
            raise AssertionError(f"backbones {family}: the stem's {names} are frozen")
        kept.update({f"backbone.{n}": params[n].detach().clone() for n in names})
        kept.update({k: v.clone() for k, v in live_stats(model).items()})

    def after(model, batch):
        out = frozen[1](model, batch) if frozen[1] is not None else {}
        now = {**{f"backbone.{n}": p for n, p in model.backbone.named_parameters()},
               **live_stats(model)}
        moved = {k for k, v in kept.items() if not torch.equal(now[k].detach(), v)}
        names, should_move = TRAINABLE_STEM.get(family, ((), True))
        stem = {f"backbone.{n}" for n in names}
        stats = set(live_stats(model))
        bad = (stem - moved if should_move else stem & moved) | (stats - moved)
        if bad or (family in (YOLO_BACKBONE, "fpg")) != bool(stats):
            raise AssertionError(f"backbones {family}: {sorted(bad)[:4]} "
                                 f"{'did not move' if should_move else 'moved'}")
        out.update(stem_moved=len(stem & moved), stem_kept=len(stem - moved),
                   live_bn_stats_moved=len(stats & moved))
        return out

    return before, after


def carafe_memory():
    """CARAFE's P3-to-P2 reassembly alone at 1024x2048 (a 256x512 output of
    256 channels, 5x5 taps, one group), float32, forward and backward: its
    ms and the peak it allocates above its inputs, beside the 2x-repeated
    taps the JAX layout would form (``(1, 256, 512, 25, 256)`` float32)."""
    import torch
    from oadg_tpu_torch.ops.misc_ops import carafe
    gen = torch.Generator(device="cuda").manual_seed(61)
    b, c, h, w = CARAFE_P3
    x = torch.randn(CARAFE_P3, device="cuda", generator=gen, requires_grad=True)
    masks = torch.softmax(torch.randn(b, 25, 2 * h, 2 * w, device="cuda", generator=gen), 1)
    cot = torch.randn(b, c, 2 * h, 2 * w, device="cuda", generator=gen)

    def run():
        (carafe(x, masks, 5, 1, 2) * cot).sum().backward()
        x.grad = None

    run()
    _, ms, gib = _peak_above(run)
    jax_taps = b * 2 * h * 2 * w * 25 * c * 4 / 2 ** 30
    log("backbones", f"carafe P3 {h}x{w} -> P2 {2 * h}x{2 * w}, {c} channels, float32: forward "
                     f"and backward {ms:.3f} ms, peak {gib:.3f} GiB above the inputs (the JAX "
                     f"layout's repeated taps alone {jax_taps:.3f} GiB) ({nvidia_smi_line()})")
    return dict(ms=ms, peak_gib=gib, jax_taps_gib=jax_taps)


def backbones_profile(out):
    """Per config of ``BACKBONE_CONFIGS``, one f32 step after a warm-up
    under torch.profiler: its wall ms and the device's busy share, into
    ``out`` (after every timed run: the profiler slows the host's launches
    for the rest of the process)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for family, path in BACKBONE_CONFIGS:
        cfg = backbone_cfg(family, path)
        hw = YOLO_BACKBONE_CANVAS if family == YOLO_BACKBONE else (IMG_H, IMG_W)
        model, step = build_trainer("cuda", cfg)
        batch = longtail_batch(cfg, hw, cfg.data.samples_per_gpu, 52)
        gen = torch.Generator(device="cuda").manual_seed(0)
        step(batch, gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(batch, gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)) / 1e3
        out[f"{family}_f32"]["train"].update(profiled_ms=wall, busy=busy / wall)
        log("backbones-profile", f"{family} f32: profiled step {wall:.3f} ms wall, device busy "
                                 f"{busy:.3f} ms ({100 * busy / wall:.1f}%; {nvidia_smi_line()})")
        del model, step, batch
        torch.cuda.empty_cache()


def phase_backbones(rows):
    """backbones: each config of ``BACKBONE_CONFIGS`` per dtype at its full
    width with seeded weights: ``longtail_serve`` and ``longtail_train``
    with ``backbone_watch``'s probe (a warm-up step first), B1's and B2's
    counts set to 0 just before each request and step pair and read just
    after (``path_launches``); the Faster R-CNNs' third step and warm-up
    request hold every call to the plain versions in place; then
    ``carafe_memory``. -> (numbers, a function that profiles an f32 step a
    config, ``backbones_profile``)."""
    import torch
    t0 = time.perf_counter()
    out = {}
    for family, path in BACKBONE_CONFIGS:
        cfg = backbone_cfg(family, path)
        hw = YOLO_BACKBONE_CANVAS if family == YOLO_BACKBONE else (IMG_H, IMG_W)
        for name in DTYPES:
            prepare, probe = backbone_watch(family)
            steps = [longtail_batch(cfg, hw, cfg.data.samples_per_gpu, seed) for seed in (52, 53)]
            res = out[f"{family}_{name}"] = dict(
                serve=longtail_serve(rows, family, path, (IMG_H, IMG_W), name, cfg=cfg,
                                     phase="backbones",
                                     shared_proposals=family != YOLO_BACKBONE,
                                     checked=family != YOLO_BACKBONE),
                train=longtail_train(rows, family, path, hw, name, cfg=cfg, phase="backbones",
                                     prepare=prepare, probe=probe, batch=steps[0],
                                     warmup_batch=steps[1]))
            del steps
            tr = res["train"]
            log("backbones", f"{family} {name}: request {res['serve']['request_ms']:.3f} ms "
                             f"(peak {res['serve']['peak_gib']:.2f} GiB), steps after a warm-up "
                             f"{[round(t, 3) for t in tr['step_ms']]} ms (peak "
                             f"{tr['peak_gib']:.2f} GiB), {len(tr['losses'])} losses finite, "
                             f"{tr.get('frozen_still', 0)} frozen backbone tensors still, "
                             f"stem: {tr['stem_moved']} trainable tensors moved, "
                             f"{tr['stem_kept']} kept; {tr['live_bn_stats_moved']} live BN "
                             f"statistics moved; B1 and B2 launches "
                             f"{'0' if family == YOLO_BACKBONE else 'as path_launches'} "
                             f"({nvidia_smi_line()})")
            torch.cuda.empty_cache()
    out["carafe_p3"] = carafe_memory()
    log("backbones", f"phase backbones: {time.perf_counter() - t0:.2f} s")
    return out, lambda: backbones_profile(out)


PHASE_SECONDS = {}


def timed(name, fn, *args):
    """``fn(*args)``, its wall seconds logged and kept under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0
    log("time", f"{name}: {PHASE_SECONDS[name]:.2f} s")
    return out


def main():
    import os
    import tempfile
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import oadg_tpu_torch.apis  # noqa: F401  (fails here outside a checkout)
    start = time.perf_counter()
    timed("device", phase_device)
    timed("build", phase_build)
    if sys.argv[1:] == ["--only", "longtail"]:   # the long tail's phases alone: no result line
        rows = timed("kernels", phase_kernels)
        rows += timed("c4-kernels", phase_c4_kernels)
        longtail = timed("longtail", phase_longtail, rows)
        log("longtail", f"summary ({nvidia_smi_line()}): {json.dumps(longtail)}")
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "twostage2"]:  # the family's last four alone: no result line
        rows = timed("kernels", phase_kernels)
        rows += timed("mask-kernels", phase_mask_kernels)
        timed("sparse-kernels", phase_sparse_kernels, rows)
        twostage2 = timed("twostage2", phase_twostage2, rows)
        timed("profiled", profile_roi_plain, {r["name"]: r for r in rows}, "",
              sparse_roi_cases, 7, STRIDES)
        log("twostage2", f"summary ({nvidia_smi_line()}): {json.dumps(twostage2)}")
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "onestage"]:   # the one-stage family alone: no result line
        rows = timed("kernels", phase_kernels)
        onestage = timed("onestage", phase_onestage, rows)
        log("onestage", f"summary ({nvidia_smi_line()}): {json.dumps(onestage)}")
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "transformer"]:   # DETR, Deformable DETR, PanopticFPN alone
        rows = timed("kernels", phase_kernels)
        rows += timed("mask-kernels", phase_mask_kernels)
        transformer = timed("transformer", phase_transformer, rows)
        log("transformer", f"summary ({nvidia_smi_line()}): {json.dumps(transformer)}")
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "backbones"]:   # the A.2.9a configs alone: no result line
        rows = timed("kernels", phase_kernels)
        backbones, backbones_prof = timed("backbones", phase_backbones, rows)
        timed("profile-backbones", backbones_prof)
        log("backbones", f"summary ({nvidia_smi_line()}): {json.dumps(backbones)}")
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if sys.argv[1:] == ["--only", "twostage"]:   # the two-stage family alone: no result line
        rows = timed("kernels", phase_kernels)
        rows += timed("mask-kernels", phase_mask_kernels)
        rows += timed("sem-kernels", phase_sem_kernels)
        twostage = timed("twostage", phase_twostage, rows)
        timed("profiled", profile_roi_plain, {r["name"]: r for r in rows}, "_sem",
              sem_roi_cases, MASK_BINS, (SEM_STRIDE,))
        log("twostage", f"summary ({nvidia_smi_line()}): {json.dumps(twostage)}")
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    rows = timed("kernels", phase_kernels) + timed("oamix-kernels", phase_oamix_kernels)
    timed("dwd-kernels", phase_dwd_kernels, rows)
    timed("sparse-kernels", phase_sparse_kernels, rows)
    mask_rows = timed("mask-kernels", phase_mask_kernels)    # joined before phase 7g
    c4_rows = timed("c4-kernels", phase_c4_kernels)          # joined before phase 9
    sem_rows = timed("sem-kernels", phase_sem_kernels)       # joined before phase 8c
    if "--kernels-only" in sys.argv[1:]:        # the kernels' phases alone: no result line
        rows += mask_rows + c4_rows + sem_rows
        timed("profiled", phase_profiled, rows)
        print(json.dumps({"kernels": rows}), flush=True)
        print(f"nvidia-smi: {nvidia_smi_line()}", flush=True)
        return 0
    handles = timed("slice", phase_slice, rows)
    timed("reference", phase_reference, handles)
    del handles
    evaluate_profile = timed("evaluate", phase_evaluate, rows)
    val = evaluate_profile.val
    tool_dir = tempfile.TemporaryDirectory()     # the tools' val set: 4 of the 16
    tool_val = (_subset_json(val[0], TOOL_VAL_IMAGES, os.path.join(tool_dir.name, "val.json")),
                val[1])
    robustness = timed("robustness", phase_robustness, rows, val)
    timed("oamix", phase_oamix)
    trains = {name: timed("train", phase_train, rows, name) for name in DTYPES}
    for r in rows:          # B1 on the test loop's and the robustness sweep's paths too
        r["launches"] += r.get("launches_evaluate", 0) + r["launches_robustness"]
    baseline = timed("baseline", phase_baseline, rows)
    loop_profile = timed("train-loop", phase_train_loop, rows, tool_val)
    dwd = timed("dwd", phase_dwd, rows)
    yolo = timed("yolo", phase_yolo, rows, tool_val)
    tta, tta_profile = timed("tta", phase_tta, rows, evaluate_profile.val)
    engine = timed("engine", phase_engine, rows, evaluate_profile.val)
    rows += mask_rows
    mask, mask_profile = timed("mask", phase_mask, rows, evaluate_profile.val)
    dist, dist_profile = timed("dist", phase_dist, rows, tool_val, loop_profile.train)
    rows += c4_rows
    longtail = timed("longtail", phase_longtail, rows)
    rows += sem_rows
    twostage = timed("twostage", phase_twostage, rows)
    twostage2 = timed("twostage2", phase_twostage2, rows)
    onestage = timed("onestage", phase_onestage, rows)
    transformer = timed("transformer", phase_transformer, rows)
    backbones, backbones_prof = timed("backbones", phase_backbones, rows)

    for _, profile in trains.values():
        timed("profile-train", profile)
    timed("profile-tta", tta_profile)
    timed("profile-mask", mask_profile)
    timed("profile-dist", dist_profile)
    summary = {name: out for name, (out, _) in trains.items()}
    for name in DTYPES:
        summary[name]["serving_busy"] = timed("profile-serving", serving_profile, name)
    timed("profile-evaluate", evaluate_profile)
    timed("profile-train-loop", loop_profile)
    timed("profile-backbones", backbones_prof)
    del trains
    torch.cuda.empty_cache()
    log("train", f"per dtype and chain ({nvidia_smi_line()}): {json.dumps(summary)}")
    log("baseline", f"per dtype ({nvidia_smi_line()}): {json.dumps(baseline)}")
    log("robustness", f"summary ({nvidia_smi_line()}): {json.dumps(robustness)}")
    log("dwd", f"summary ({nvidia_smi_line()}): {json.dumps(dwd)}")
    log("yolo", f"summary ({nvidia_smi_line()}): {json.dumps(yolo)}")
    log("tta", f"summary ({nvidia_smi_line()}): {json.dumps(tta)}")
    log("engine", f"summary ({nvidia_smi_line()}): {json.dumps(engine)}")
    log("mask", f"summary ({nvidia_smi_line()}): {json.dumps(mask)}")
    log("dist", f"summary ({nvidia_smi_line()}): {json.dumps(dist)}")
    log("longtail", f"summary ({nvidia_smi_line()}): {json.dumps(longtail)}")
    log("twostage", f"summary ({nvidia_smi_line()}): {json.dumps(twostage)}")
    log("twostage2", f"summary ({nvidia_smi_line()}): {json.dumps(twostage2)}")
    log("onestage", f"summary ({nvidia_smi_line()}): {json.dumps(onestage)}")
    log("transformer", f"summary ({nvidia_smi_line()}): {json.dumps(transformer)}")
    log("backbones", f"summary ({nvidia_smi_line()}): {json.dumps(backbones)}")
    for name in DTYPES:
        timed("train-reference", phase_train_reference, name)
        timed("train-reference", phase_train_reference, name, BASELINE, "baseline-reference")
    timed("profiled", phase_profiled, rows)
    log("time", f"phases {json.dumps({k: round(v, 2) for k, v in PHASE_SECONDS.items()})}; "
                f"the script {time.perf_counter() - start:.2f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"nvidia-smi: {nvidia_smi_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
