#!/usr/bin/env python3
"""Drive the PyTorch port (``twinvoice_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, each printing one line with its wall time:

1. device: the card's name and ``nvidia-smi`` name and power limit
2. build every CUDA kernel of the port from ``twinvoice_tpu_torch/csrc``, and
   the host C++ libraries beside them: the QR decoder from
   ``native/qrdecode.cpp``, the image codec from ``csrc/host_codec.cpp``, the
   QR locator, the TrueType engine, the DFT filter (``csrc/host_dft.cpp``)
   and the zstd decoder (``csrc/host_zstd.cpp``)
3. K1 (``ops.bbox_postprocess``) against its plain PyTorch version on the
   card: exact equality of boxes and valid flags on planted rectangles
   (float32 and bfloat16), all-below and all-above logits, H≠W, odd widths,
   NHWC-contiguous and strided layouts, and the serving shape
4. the main path at float32 (TF32 off): the bundled w16 segmenter,
   ``segment_batch(pre_resized=False)`` on the fixture pages, crops with
   ``crop_fields``; valid and ok flags equal to the JAX package's (stored in
   ``tests/data/torch_smoke_pages.npz``), grid boxes within one grid cell
5. the same pages at bfloat16, agreement with float32
6. a batch of 128 at 512², pre-resized, box-only, bfloat16: img/s with the
   boxes read back to the host after every batch (``bench.py``'s serial
   protocol)
7. K1's time on the model's serving logits against its bound and the plain
   version's
8. the int8 kernels K2 (``ops.head``), K4a and K5 (``ops.qconv``) and K6
   (``ops.qupsample``) against their plain versions on the card: exactly
   equal int8 outputs (K2 within a stated float32 summation bound) on planted
   and random inputs, H≠W, odd W, Cin 3, 5, 16, 48 and 256, ReLU and none,
   scales that clip at both ends; K4a and K5's tensor-core contract: Cin 1,
   2, 4, 8, 17, 31, 33, 64, 129 and 1024, Co 1, 8, 40, 72, 128 and 256, each
   epilogue form at a narrow and a wide Cin, K5's shared-sum and two-scale
   forms at Cin 3, 16, 33 and 129, H and W off the output tile, inputs and
   outputs 1 byte off alignment; K6's tensor-core contract: Cin 1, 2, 4, 17,
   31, 33, 64, 129 and 1024, Co 1, 8, 40, 72 and 256, inputs, weights and
   outputs 1 byte off alignment, a 1x1 image, H != W and odd W; and every
   layer shape of the w16 int8 trunk at b128 (held on a subset of the batch)
9. the int8 routes on the fixture pages against the JAX package
   (``tests/data/torch_smoke_int8.npz``): the port's calibration scales
   within 1e-5 of JAX's; then, with JAX's scales carried in, each route's ok
   flags equal to JAX's and its grid boxes within one grid cell; the
   Pallas-trunk route against the port's ``xla`` route (flags equal, row/col
   maxima within JAX's own tolerance)
10. b128 512² box-only int8 serving, one img/s line per route, boxes read
    back after every batch, as phase 6
11. the int8 kernels' times at the serving shapes against their bounds and
    their plain versions'; K4a, K5 and K6 beside their earlier CUDA-core
    times, K4a beside cuDNN's bf16 conv of the same shape and K6 beside
    ``torch._int_mm``'s [px, Cin] x [Cin, 4 Co] product (context, not library
    times: other functions), and the summed K4a and K5 time of a route batch
    and K6's four launches against their summed bounds
12. K7b (``ops.nhwc_conv``) against its plain version on the card: exactly
    equal int8 outputs A->B and B->A, odd pair counts, no ReLU, the chain
    A->B->A, two packed sources, packed weights ``pack_w_pair`` could not
    produce, zero pad half-pairs of every B->A output; its tensor-core
    contract in both phases: Cpk 1, 2, 4, 17, 31, 33, 64, 129 and 1024, Co2 2,
    8, 40, 72 and 256, P = 3 (A) and P = 2 (B) at H = 1, H off the tile,
    inputs, weights and outputs 1 byte off alignment; and the three K7b calls
    of the w16 "nhwc" trunk at b128 (held on a subset of the batch)
13. the W-phase routes (``int8_wpack`` "full", "enc", "nhwc" box-only, and
    "nhwc" with masks, its "full" fallback) on the fixture pages against the
    JAX package (``tests/data/torch_smoke_wpack.npz``), with JAX's scales
    carried in: ok flags and grid boxes equal, row/col maxima within 1e-5,
    the trunk's int8 channel sums equal to JAX's on all four pages
14. b128 512² box-only img/s on each W-phase route, and K7b's time at its
    three serving shapes against its bound, its earlier CUDA-core time and
    its plain version's, summed over an "nhwc" batch
15. K3b, K3a (``ops.nhwc_conv.qconv3x3_nhwc_requant``, ``qconv3x3_nhwc_dma``
    on ``pad_nhwc`` inputs), K4b (``ops.qconv.qconv3x3_requant_dma``) and K7a
    (``ops.nhwc_conv.qconv3x3_pair_dma``) against their plain versions on the
    card, exactly equal int8: odd W, H not a multiple of 8, Cin 3, 16, 64 and
    128, ReLU and none, clips at both ends, live H-pad rows for K3a and K3b,
    A->B, B->A and the chain A->B->A for K7a; the contract of the TMA-fed
    tensor-core kernel all four run on: C and Cpk 1, 2, 4, 17, 31, 33, 64,
    129 (K4b 128) and 1024 (not K4b), Co and Co2 2, 8, 40, 72 and 256, inputs,
    weights and outputs 1 byte off alignment, H = 1, H off the tile, odd W,
    live H-pad rows (K3a reads them; K3b, by TMA and by copy, must not: it
    differs from K3a on the first and last rows exactly), P = 3 (A) and P = 2
    (B) and zero pad half-pairs (K7a); against their siblings (K4a, K7b) at
    every w64 trunk layer shape their contracts admit at b128 (plain versions
    held on images 0 and 127), each loading its slabs by TMA at every one
    whose channels are a multiple of 16; then the slice's path: the bundled
    w64 model quantised with the port's calibration on the fixture pages,
    enc0 conv2 (512², 64->64) on enc0 conv1's int8 output through each of the
    four entry points, equal to K4a's (K7a to K7b's on the phase-A packing),
    all four by TMA
16. the four kernels' times at the flagship shape (b128, 512², 64->64, the
    shape of JAX's probes; K7a on it packed to phase A) against their bounds,
    their plain versions' and their siblings', each beside its first
    design's time (dp4a; K4b's mma.sync); K3a and K3b at every w64 trunk
    shape, K4b at every w64 and w16 trunk shape with Cin <= 128, and K7a at
    the w64 "nhwc" trunk's three pair calls, beside their bounds and
    siblings
17. the recognition stack (``ocr.torchocr``; no kernel of its own: cuDNN
    convs and plain PyTorch on the card, numpy on the host) against the JAX
    package's outputs in ``tests/data/torch_smoke_ocr.npz``, the bundled
    recognizer and textness head on the card with TF32 off (by the engine
    itself: cuDNN's TF32 flag is on around these checks): the device half
    on JAX's prepared rows (argmax equal wherever JAX's top-1/top-2 gap is
    above 1e-3 nats, the frames under it counted; log-probs within 1e-3,
    confidences within 1e-4; top-8 ids equal where the values stand apart);
    ``read_batch`` on the fixture crops with their modes under "greedy",
    "beam_lm" and "cascade" (texts equal, confidences within 1e-4);
    ``detect_lines`` ("classical", "hybrid") and ``read_page`` on the four
    pages (boxes and texts equal); and the chained path: the port's fp32
    ``segment_batch``, ``crop_fields`` and ``read_batch`` (invoice, date,
    amount) on the pages, texts equal to JAX's chain on every field whose
    port box is JAX's box, the others listed
18. a bulk batch of 384 lines (128 invoices × 3 fields, tiled from the
    fixture crops): the recognizer's device time a call beside its float32
    bound under the engine's settings (NCHW, cuDNN's heuristics) and three
    others (channels_last, cuDNN off, cuDNN autotuned over every algorithm),
    each held against JAX's rows, with each conv alone under each and the
    engine's two slowest convs at b128; and ``read_batch``'s lines/s with its
    host steps under "cascade" and "greedy", with the recognizer's and the
    classical detector's device calls timed apart from the rest
19. field fusion and the QR pipeline (``fusion``, ``qr``; no kernel of their
    own) against the JAX extractor's outputs in
    ``tests/data/torch_smoke_fusion.npz``: the bundled w16 segmenter at fp32,
    ``QrPipeline()`` (its C++ decoder built in phase 2) and
    ``TorchOcrEngine()`` on the four RGB fixture pages, through
    ``extract_batch`` under the default ``FusionConfig`` (QR on, gray upload,
    two chunks), ``extract_batch`` with QR off, ``extract`` on each page, and
    ``extract`` with a segmenter that finds no field (the full-page read):
    ``qr_raw`` and ``items`` equal to JAX's on every page, every meta field
    (failures as ``(stage, error)``) equal on every page whose port boxes
    are JAX's (the others listed); no page needs the OpenCV region pass;
    then ``extract_batch`` on the int8 "pallas" route, its fields counted
    against the fp32 run's (not a gate)
20. a bulk batch of 128 pages tiled from the fixture: ``extract_batch`` at
    the segmenter's default dtype (bf16) and the default ``FusionConfig``,
    the cache cleared before each timed call: invoices/s, and each stage's
    share of the call (``StageTimer``: the QR scans, the segmenter call and
    its prep, upload, dispatch and fetch, the OCR)
21. segmenter training (``train``; no kernel of its own: cuDNN convs and
    plain PyTorch) against the JAX trainer's numbers in
    ``tests/data/torch_smoke_train.npz``: from the bundled w16 weights, 3
    ``make_train_step`` steps on its b4 512² batch at fp32 (TF32 off), bf16
    and bf16 with ``fast_norm``: the losses, the step-1 gradients' norms and
    sampled elements (also against the exact float64 step stored there), the
    BN running statistics after steps 1 and 3, the step norms of every leaf
    after step 3, and the eval step's loss and per-class IoU, each within
    ``TRAIN_TOLS``; then one fp32 step with ``remat`` against one without
22. the bundled w64 model (31,043,651 parameters) trained on the fixture
    batch at fp32 (TF32 off) and bf16: the median ms of 10 steps after 2,
    img/s, the step's bound (FLOPs from the layer shapes over the card's
    peak for the dtype) and the share of it reached, peak memory, and the
    losses, which must fall; ``fit`` for 3 epochs from the bundled weights
    (a checkpoint of them at epoch 0 that ``fit`` resumes from) on the four
    pages, checkpoints and visual dumps in a temporary directory, resumed
    from ``latest`` for a fourth, and its first epoch again without the
    prefetch thread (the same loss); the ``best`` weights saved with
    ``save_params_npz``, read back with ``weights.load_npz`` and served at
    bf16 through ``Segmenter``, which must launch K1; its ok flags and boxes
    equal to K1's plain version on the logits the served call handed K1,
    and those logits within ``SERVED_LOGIT_RTOL`` of the plain path's on the
    same weights (eval-mode ``unet_apply`` at fp32, ``bbox_from_probs``),
    which must find fields; how far the boxes of the two differ is printed
23. recognizer and textness-head training (``ocr/torchocr/train.py``,
    ``textness.py``; no kernel of their own: cuDNN's convs, cuBLAS, PyTorch's
    CTC and plain PyTorch, as the JAX trainers are plain XLA) against the
    JAX trainers' numbers in ``tests/data/torch_smoke_ocrtrain.npz``, TF32
    off: from the bundled recognizer (t64, 420 classes) 3 steps on its b64
    batch of lines at lr 3e-4, and from the bundled textness head 3 steps on
    its 8 pages at ``textness.train``'s optimizer: the losses, the step-1
    gradients' norms and sampled elements (also against the exact float64
    step stored there), the recognizer's BN running statistics after steps
    1 and 3, and every leaf's step norm after step 3, each within
    ``OCR_TRAIN_TOLS``; the textness labels equal to JAX's; the bundled
    recognizer's greedy texts on the eval batch equal to JAX's away from
    near-ties (``OCR_NEAR_TIE``), with ``evaluate``'s exact-match and CER;
    ``ctc_loss`` on infeasible t32 rows beside feasible ones equal to its
    plain recursion
24. the recognizer at b64 t64 fp32 (TF32 off): the median ms of 10 steps
    after 2, lines/s, the step's bound (FLOPs from the layer shapes over the
    card's float32 peak), peak memory and device time by kernel kind, the
    losses over 12 steps, which must fall; ``train()`` for 120 steps from
    the bundled weights (``resume_from``) on the fixture's pool, saved with
    ``save_weights`` into a temporary directory under the kernels' build
    directory, served by ``TorchOcrEngine(weights_dir=...)`` on phase 17's
    fixture crops with the texts of an engine built from the in-memory
    params; the textness head at b32 256² (the 8 pages tiled) beside its
    bound, then ``save_textness``, ``load_textness`` and ``textness_map``
    equal to the in-memory head's
25. parallelism (``core.mesh``, ``core.collectives``, ``parallel``; no kernel of
    its own: every collective is a ``dist.all_reduce``) on two gloo ranks that
    share the card (NCCL refuses two ranks on one device), spawned with their
    own deadline, each collective with a timeout: the bundled w64 at b4 512²
    fp32 (TF32 off) on the training fixture, one SGD step under (a)
    ``data=2``, (b) ``model=2`` and (c) ``spatial=2``, each against the
    one-rank step (loss, every gradient and the BN running statistics within
    ``TRAIN_TOLS["fp32"]``); under (a) also one finite AdamW step and
    ``fit(mesh)`` for 2 epochs of one step from the bundled weights, whose
    first loss is the one-rank step's; (d) ``spatial_unet_forward`` of the
    folded w64 on a 1024² frame (the four pages in a 2×2 mosaic) equal to the
    dense forward at JAX's 2e-4; (e) ``pipeline_apply`` on 2 stages, JAX's
    tanh tower at 1e-5 and identity at 1e-6; which collectives gloo runs on
    CUDA tensors; (f) NCCL at world size 1, the one NCCL group one card
    allows: the collectives exact and the ``data=1`` step against the
    one-rank step. Each 2-rank step's ms and the spatial forward's beside
    the one-rank ones (context: two ranks on one card show no scaling).
    Rank 0's ``best`` checkpoint (the whole tree) restored into the one-rank
    template and served at bf16 through ``Segmenter``, which must launch K1,
    against the plain path, as phase 22
26. the serving edges and the gauntlet (``port``, ``compat``,
    ``train.checkpoint.save_params``/``restore_params``, ``eval``; no kernel
    of their own) against the JAX package: (a) the bundled w64 exported with
    ``export_state_dict`` to a ``.pth``, saved with ``save_params`` and as a
    ``fit`` ``train_state.pt``, served back through ``Segmenter.from_pth``,
    ``compat.load_model`` (called twice: one object) and
    ``Segmenter.from_checkpoint``, each at fp32 on the four fixture pages
    (``segment_array_batch``) equal to the bundled w64's masks and crops
    exactly; (b) ``run_segmenter_gauntlet`` with the bundled w16 at fp32 on
    the nine perturbed cases of ``tests/data/torch_smoke_gauntlet.npz`` (one
    a tier: clean, mild, hard, the four scenarios, and clean and mild on
    held-out fonts), tier by tier, against JAX's per-case results stored
    there: ok flags equal, boxes within one grid cell, each field's IoU
    within ``GAUNTLET_IOU_TOL``, hits equal wherever the boxes are; (c) the
    same for the w16 at bf16, the w16 int8 concat trunk on JAX's stored
    scales, and the w64 at bf16, every differing case printed with its tier
    and field, and each route's IoU/box-hit table by tier beside JAX's;
    (d) ``run_e2e_gauntlet`` on the clean and mild training-font cases (the
    w16 at bf16, ``TorchOcrEngine()``, no QR pass, no auto-rotate), each
    case's fields equal to JAX's wherever the port's boxes are JAX's
27. the QR locator, encoder, labelme core and CLI (``qr.locate``,
    ``qr.encode``, ``data.labelme``, ``__main__``; no kernel of their own)
    against the JAX package's outputs in ``tests/data/torch_smoke_qr.npz``:
    (a) 40 ``encode_qr_matrix`` matrices equal to JAX's, each
    ``render_qr`` read back by ``qr.native``; (b) ``enhance_qr_region`` on
    three crops byte for byte equal to OpenCV's; (c) the locator
    (``cv2.QRCodeDetector``'s own localisation in host C++) against cv2's
    quads on 96 pages (14 fixture pages: landscape, 0.45×, 0.5×, 0.55×,
    perspective, soft, 7°, low contrast, blank; the sweep's 82 INTER_AREA
    downscales, 0.40–0.80×, rebuilt from the portrait pages), each call from
    a generator seeded with 0 as cv2's were: the flag, count, order and int
    boxes equal, corners within 1e-3 px, ``detect_qr_regions`` JAX's boxes,
    the median and range of host ms a page; (d) the scan with the native
    decoder on the same 96 pages: payload sets equal to JAX's, one payload
    on the 0.45× pages as JAX's, the passes of each page; (e) ``auto_rotate_by_qr``'s
    turn equal to JAX's on the four landscape pages; (f) ``extract`` with
    the bundled w16 at fp32 (TF32 off) and ``TorchOcrEngine()`` on the
    landscape and 0.45× pages, fields equal to JAX's wherever the port's
    boxes are JAX's; (g) the training fixture's pages written by
    ``ops.host_imageio.imwrite_jpeg`` into ``fixed_images/`` and their masks
    into ``fixed_masks/``, read back by ``data.dataset.load_invoice_dataset``
    equal to ``jpeg_roundtrip_u8`` of each page, then
    ``__main__.main(["train", "--epochs", "1", "--resume", ...])`` from the
    bundled w64 on those files, its checkpoint served by
    ``Segmenter.from_checkpoint`` against the plain path, fields found;
    (h) ``main(["train-ocr", ...])`` for 101 steps (the fewest the trainer
    takes) on the OCR training fixture's pool; (i) ``rasterize_labelme`` and
    ``build_one``'s resizes equal to JAX's
28. the store, the app, the network OCR engines and the CLI's ``app``
    (``store``, ``app``, ``ocr.enhance``, ``ocr.ocrspace``,
    ``ocr.easyocr_engine``; no kernel of their own) against the JAX
    package's outputs in ``tests/data/torch_smoke_app.npz`` (on the pages of
    ``torch_smoke_fusion.npz``): (a) the in-memory store and the Supabase
    store on a fake client, a failing one and none: every row and return
    equal; (b) ``enhance_for_ocr`` (text, amount), ``grayscale_for_ocr`` and
    ``enhance_camera`` on the twelve field crops, as arrays and as
    ``PilPixels``, byte for byte OpenCV's (IPP off); (c) ``OcrSpaceEngine``
    (a recording transport) and ``EasyOcrEngine`` (a recording reader) in
    ``InvoiceExtractor``: the fields, every payload field, each PNG's
    pixels and row filters (read by ``png_pixels``) and every reader array
    equal to JAX's; (d) the app's flow through ``app.main._build_engine()``
    (no environment variable: the bundled w16 at bf16 on the card,
    ``TorchOcrEngine``) and ``_build_store()`` on the four pages:
    ``extract``, ``classify_invoice``, ``save_invoice``, then the lists and
    every dashboard aggregate, equal to JAX's app wherever the boxes are
    JAX's (phase 19's rule), and the port's store and dashboard on JAX's
    fields equal to JAX's; the host ms of each ``extract`` and of the
    dashboard pass; (e) ``main(["app"])`` runs ``python -m streamlit run``
    on the port's ``app/main.py``
29. the perturbation engine and augmented training on the card
    (``data.augment`` on ``ops.host_warp``, ``host_filter``, ``host_draw``
    and ``host_jpeg``; numpy on the host, no OpenCV): (a) the port's
    ``eval.perturb_cases(..., seed=7)`` rebuilds the gauntlet fixture's
    seven perturbed tiers from its two clean bases: masks byte for byte the
    JAX package's, images within the tests' bound (at most 0.5% of the
    bytes differ, by at most 16), each case's differing bytes, largest
    |Δ| and host ms printed; (b) the four gauntlet routes of phase 26 on
    the two clean bases and the port's seven cases, held to JAX's stored
    per-case results as phase 26 holds them; (c) ``fit`` of the bundled
    w64 (b4 512², phase 22's ``TrainConfig``, two epochs of one step) on
    ``AugmentedDataset`` of the training fixture, every loss finite, its
    last checkpoint served against the plain path; the host ms to augment
    a b4 batch beside the epoch's seconds with and without augmentation
30. image files on the card's machine, which has neither OpenCV nor Pillow
    (``ops.host_jpeg``, ``host_png``, ``host_imageio`` on the host C++
    library ``csrc/host_codec.cpp``; no kernel), against OpenCV's and the
    JAX package's outputs in ``tests/data/torch_smoke_codec.npz``: (a) every
    fixture file (JPEGs at each sampling and gray, a restart interval, EXIF
    orientations 1-8 in both byte orders; PNGs of every colour type and
    depth, each row filter, Adam7, ``eXIf``) read by ``imread_rgb`` from a
    file whose name says nothing of its format, byte-equal to cv2's RGB, and
    two frames through ``encode_jpeg`` byte-equal to ``cv2.imencode``'s;
    (b) the training fixture's first page resized to a 4032×3024 phone
    photo, and the same under seeded noise and texture: ``encode_jpeg`` at
    q95 and ``decode_jpeg`` of its bytes equal to ``jpeg_roundtrip_u8`` byte
    for byte, the host ms of each (and of the C++ scan in each) and the
    file's size; the median host ms of ``encode_jpeg`` on the 512² page;
    (c) ``__main__.main(["build-dataset", ...])`` at 512² on the fixture's
    labelme photo and JSON: the written ``.jpg`` byte-equal to
    the JAX package's ``build_one`` output and the ``.npy`` mask equal
31. TrueType text and the training renderers on the card's machine, which has
    neither Pillow nor FreeType (``ocr/fonts/truetype`` on the host C++
    library ``csrc/host_truetype.cpp``, ``ops/host_pildraw``; no kernel),
    against ``tests/data/torch_smoke_render.npz``: (a) the glyph sheet of the
    13 bundled fonts × sizes 10-29 × the charset (the 12 DejaVu faces through
    the bytecode interpreter, Atkinson through the auto-hinter) and of
    Pillow's default font × printable ASCII, 0 bytes differing from
    Pillow's, and the µs a glyph; (b) the port's own registry equal to the
    fixture's, three ``make_batch`` batches (default, every fraction, CJK)
    and four ``render_textpage`` pages equal to JAX's with the generator's
    state, and the host ms a line, a timed batch of 64 and a page (the JAX
    renderers' figures, from the machine that made the fixture, printed
    for reference only); (c) ``train-ocr --steps 101 --out W`` without
    ``--pool`` at the CLI's batch of 64 (TF32 off), its weights served by
    ``TorchOcrEngine``; (d) the textness head trained 20 steps on its own
    pages
32. the invoice renderer and the gauntlet from nothing (``data.synthetic.
    render_invoice`` on the bundled training and held-out faces, no kernel
    of its own; the gauntlet's segmenter routes run K1, K4a and K6), against
    ``tests/data/torch_smoke_invoice.npz``: (a) the four pages of
    ``torch_smoke_pages.npz`` re-rendered from their arguments and the knob
    grid's pages and boxes equal to JAX's, and the host ms a plain,
    stylized and dot-matrix page; (b) ``make_base_cases(25)`` for the three
    bases of ``eval_gauntlet.py`` and their 11 tiers (275 cases) equal to
    JAX's digests, and the host ms a case; (c) the gauntlet on the w16 fp32,
    w16 bf16, w16 int8 and w64 bf16 routes, the w16 fp32 and int8 held per
    case to JAX's (ok flags equal, IoU within ``GAUNTLET_IOU_TOL``), and
    ``eval_gauntlet.py``'s table; (d) the extractor on the three clean tiers
    (75 pages), records equal to JAX's wherever the boxes are
33. the JAX package's Orbax checkpoints on the card's machine, which has
    neither orbax nor TensorStore nor ``zstandard`` (``train/orbax.py`` on
    ``train/ocdbt.py`` and ``ops/host_zstd``; no kernel of their own),
    committed under ``tests/data/torch_smoke_orbax/`` and held to
    ``tests/data/torch_smoke_orbax.npz``: (a) ``w16_params`` (``save_params``
    of the bundled w16) and ``w8_state`` (a JAX ``TrainState`` after two
    steps) read with every leaf bit-equal to orbax's restore, and the host ms
    of each; (b) ``Segmenter.from_checkpoint(w16_params)`` at fp32 (ok flags
    and pixel boxes equal to JAX's ``from_checkpoint``), K1 held to its plain
    version on the served logits at fp32 and bf16 (``served_vs_plain``), the
    int8 "pallas" and "pallas trunk" routes (K2, K4a, K5, K6) held to
    ``torch_smoke_int8.npz`` as in phase 9; (c) ``compat.load_model`` on the
    same directory; (d) ``restore`` of ``w8_state`` into a fresh port
    ``TrainState`` (epoch, best loss, AdamW steps and moments exact) and one
    resumed step held to the float64 step and JAX's; (e) ``fit(resume_dir=
    w8_state)`` resuming at epoch 2
34. JPEG forms ``cv2.imread`` reads beyond baseline (``ops.host_jpeg`` on
    ``csrc/host_codec.cpp``'s progressive scan decoder and block smoothing;
    no kernel of their own), against OpenCV's and the JAX package's outputs
    in ``tests/data/torch_smoke_jpegforms.npz``: (a) 38 files (cv2 and
    Pillow progressive at each sampling and gray, a restart interval, EXIF,
    per-scan Huffman tables; one file cut after each of its first 9 of 10
    scans, read through libjpeg-turbo's block smoothing; a bad progression,
    refused as cv2 refuses it, and two bogus ones; CMYK, YCCK and RGB-coded
    files) read by ``imread_rgb`` byte-equal to cv2's RGB; (b) a 4032×3024
    progressive q95 photo of the training fixture's first page: the
    SHA-256 of ``decode_jpeg``'s RGB cv2's, its host ms beside phase 30
    (b)'s baseline decode of the same page; (c) ``build-dataset`` on a
    progressive and a CMYK photo: JAX's ``.jpg`` bytes and masks, and
    ``load_invoice_dataset`` on the output and on the photos: JAX's arrays;
    (d) the progressive photo served by the bundled w16 fp32 through the
    raw path: boxes and ok flags equal to JAX's on cv2's pixels, K1 held to
    its plain version (``served_vs_plain``)

Kernel launch counts are zeroed before phase 4 and read after phase 6's
batches, before phase 7's timing launches, so they show that the main path
ran the kernels. Each int8 route of phases 9, 10, 13 and 14 is driven with
the counts zeroed just before it and read just after; every kernel of the
route must have launched its expected number of times, and no other (so no
route runs K3a, K3b, K4b or K7a). Phase 15's w64 enc0 path is driven the same
way, and each of the four must have launched there. Phase 17's chained path
is driven the same way: its one ``segment_batch`` call must launch K1 once
and nothing else (the recognition stack itself runs none of the kernels).
So is each route of phase 19 and phase 20's timed calls: K1 once per
segmenter call (two per chunked ``extract_batch``, one per ``extract``) and
nothing else, and on the int8 "pallas" route K4a, K6 and K2 their route
counts per segmenter call. Phase 22's serving of the trained w64 weights is
driven the same way: K1 once, and so is phase 25's serving of ``fit(mesh)``'s
checkpoint. Phases 23-24 must leave every count as it was. In phase 26,
(a) and (d) are driven the same way (K1 once a segmenter call), and so is
each route of (b)-(c): K1 once a tier, and on the int8 route K4a and K6
their ``xla`` counts too. Phase 27's ``extract`` calls are driven the same
way (K1 once a page), and so is the serving of the CLI's checkpoint (K1
once). So are phase 28's app ``extract`` calls (K1 once a page), phase
29's gauntlet routes (as phase 26's) and its serving of the augmented
checkpoint (K1 once). Phases 30 and 31 must leave every count as they were. In
phase 32, (a)-(b) must leave every count as it was, each route of (c) is
driven as phase 26's and (d) as its (d). In phase 33 each served call of
(b)-(c) is driven the same way (K1 once a call; on the int8 routes their
phase-9 counts), and (d)-(e) must leave every count as it was. In phase
34, (a)-(c) must leave every count as it was and (d)'s served call is
driven the same way (K1 once). The kernel rows' launches sum every such
path.

It imports torch, numpy, the standard library and ``twinvoice_tpu_torch``
only. Without a CUDA device, or if any phase fails, it exits non-zero and
prints no result line. Its last lines are the card's name and power limit,
one JSON object per kernel row, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import json
import os
import subprocess
import sys
import time
import types
import warnings

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from twinvoice_tpu_torch import FIELDS, _build  # noqa: E402
from twinvoice_tpu_torch.config import (  # noqa: E402
    Config,
    FusionConfig,
    InferConfig,
    MeshConfig,
    TrainConfig,
    replace,
)
from twinvoice_tpu_torch.core.collectives import copy_to, gather_from, sum_over  # noqa: E402
from twinvoice_tpu_torch.core.mesh import Axis, Mesh, gather_tree, make_mesh  # noqa: E402
from twinvoice_tpu_torch.data.dataset import ArrayDataset  # noqa: E402
from twinvoice_tpu_torch.infer.pipeline import Segmenter, crop_fields  # noqa: E402
from twinvoice_tpu_torch.infer.postprocess import (  # noqa: E402
    bbox_from_probs,
    probability_to_logit_thresholds,
    scale_and_pad_boxes,
)
from twinvoice_tpu_torch.infer import quant  # noqa: E402
from twinvoice_tpu_torch.models.pretrained import (  # noqa: E402
    VARIANTS,
    load_pretrained_segmenter,
    variant_path,
)
from twinvoice_tpu_torch.models.unet import (  # noqa: E402
    _tree_map,
    fold_unet,
    param_count,
    tree_leaves,
    unet_apply,
    unet_apply_folded,
)
from twinvoice_tpu_torch.ocr.torchocr import charset as rec_charset  # noqa: E402
from twinvoice_tpu_torch.ocr.torchocr import model as rec_model  # noqa: E402
from twinvoice_tpu_torch.ocr.torchocr import textness as ttex  # noqa: E402
from twinvoice_tpu_torch.ocr.torchocr import train as rec_train  # noqa: E402
from twinvoice_tpu_torch.ocr.torchocr.data import encode_labels, lines_to_tensor  # noqa: E402
from twinvoice_tpu_torch.ops import bbox_postprocess as k1  # noqa: E402
from twinvoice_tpu_torch.ops import head as k2  # noqa: E402
from twinvoice_tpu_torch.ops import nhwc_conv as nhwc  # noqa: E402
from twinvoice_tpu_torch.ops import qconv  # noqa: E402
from twinvoice_tpu_torch.ops import qupsample as k6  # noqa: E402
from twinvoice_tpu_torch.ops.image import normalize_uint8, resize_bilinear  # noqa: E402
from twinvoice_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params  # noqa: E402
from twinvoice_tpu_torch.parallel.spatial import spatial_unet_forward  # noqa: E402
from twinvoice_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from twinvoice_tpu_torch.train.trainer import (  # noqa: E402
    DTYPES,
    TrainState,
    fit,
    make_eval_step,
    make_optimizer,
    make_train_step,
    shard_train_state,
    to_device_batch,
)
from twinvoice_tpu_torch.weights import keystr_items, load_npz, to_jax_params  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_pages.npz")
INT8_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_int8.npz")
WPACK_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_wpack.npz")
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp32 outside tensor
# cores, int8 and bf16 on the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
SERVE_BATCH = 128
SERVE_ITERS = 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Phases:
    def __init__(self):
        self.t0 = time.perf_counter()

    def run(self, n, name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[phase {n}] {name}: ok in {time.perf_counter() - t:.2f} s "
              f"(total {time.perf_counter() - self.t0:.2f} s)", flush=True)
        return out


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, name, iters=3, tries=3):
    """Mean device time of a kernel whose name holds ``name`` (``fn()``
    launches one a call), from ``torch.profiler`` over ``iters`` calls after
    one warm-up: the kernel alone, without the gaps a slow host leaves
    between the calls, which :func:`cuda_ms` counts at small shapes. The mean
    is over the launches the profiler recorded (it can miss one of a long
    kernel's). A profile that recorded none is taken again, up to ``tries``
    times, then raises (as :func:`device_kernels`: on an H100 one profile of
    a TMA kernel at a w16 shape recorded none)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages() if name in ev.key]
        us = sum(getattr(ev, "self_device_time_total", None) or ev.self_cuda_time_total
                 for ev in events)
        if us:
            return us / sum(ev.count for ev in events) / 1e3
    raise AssertionError(f"the profiler saw no device time of a kernel {name!r} in {tries} "
                         f"profiles")


# -- phase 1-2 ---------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to run")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name}; nvidia-smi: {card}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)
    return name, card


def phase_build():
    """The CUDA kernels (one nvcc each), the QR decoder, the image codec, the
    QR locator, the TrueType engine, the DFT filter and the zstd decoder (the
    host C++ compiler), all at once."""
    from concurrent.futures import ThreadPoolExecutor

    from twinvoice_tpu_torch.ocr.fonts import truetype
    from twinvoice_tpu_torch.ops import host_filter, host_imageio, host_zstd
    from twinvoice_tpu_torch.qr import locate as qr_locate
    from twinvoice_tpu_torch.qr import native as qr_native

    with ThreadPoolExecutor(max_workers=6) as pool:
        host_libs = {"qrdecode": pool.submit(qr_native.build),
                     "hostcodec": pool.submit(host_imageio.build_codec),
                     "hostqrlocate": pool.submit(qr_locate.build),
                     "hosttruetype": pool.submit(truetype.build),
                     "hostdft": pool.submit(host_filter.build_dft),
                     "hostzstd": pool.submit(host_zstd.build)}
        built = _build.build()
        built.update((name, lib.result()) for name, lib in host_libs.items())
    for name, path in built.items():
        print(f"built {name}: {os.path.relpath(path, ROOT)}", flush=True)


# -- phase 3: K1 against its plain version -----------------------------------


def planted_logits(g, b, h, w, c, dtype, nchw=False):
    """Background logits far below the thresholds, with a random rectangle of
    high logits planted in most (image, class) planes and a few lone pixels."""
    shape = (b, c, h, w) if nchw else (b, h, w, c)
    x = torch.randn(shape, generator=g, device="cuda") - 6.0
    planes = x if nchw else x.permute(0, 3, 1, 2)  # (b, c, h, w) view
    for bi in range(b):
        for ci in range(c):
            r = torch.randint(0, 10, (6,), generator=g, device="cuda").tolist()
            if r[0] < 2:
                continue  # leave this class empty: sentinel box
            y0, x0 = r[1] * h // 10, r[2] * w // 10
            y1 = min(h, y0 + 1 + r[3] * h // 10)
            x1 = min(w, x0 + 1 + r[4] * w // 10)
            planes[bi, ci, y0:y1, x0:x1] += 8.0
            if r[5] > 6:  # a lone pixel outside the rectangle
                planes[bi, ci, (y0 * 7 + 3) % h, (x0 * 13 + 5) % w] = 4.0
    x = x.to(dtype)
    return x.permute(0, 2, 3, 1) if nchw else x


def check_k1(label, logits, thr):
    boxes, valid = k1.bbox_postprocess(logits, thr)
    rb, rv = k1.bbox_postprocess_reference(logits, thr)
    torch.cuda.synchronize()
    if not (torch.equal(valid, rv) and torch.equal(boxes, rb)):
        bad = (boxes != rb).any(-1) | (valid != rv)
        idx = bad.nonzero()[:4].tolist()
        raise AssertionError(
            f"K1 {label}: kernel != plain at (b,c) {idx}: "
            f"{[boxes[i, j].tolist() for i, j in idx]} vs "
            f"{[rb[i, j].tolist() for i, j in idx]}")
    err = int((boxes.to(torch.int64) - rb.to(torch.int64)).abs().max()) \
        if boxes.numel() else 0
    print(f"  K1 {label} {tuple(logits.shape)} {logits.dtype} strides "
          f"{logits.stride()}: equal ({int(valid.sum())}/{valid.numel()} valid)",
          flush=True)
    return err


def phase_k1(thr):
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    err = 0
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        err = max(err, check_k1(f"planted {tag}",
                                planted_logits(g, 4, 96, 128, 3, dtype), thr))
        err = max(err, check_k1(f"planted NCHW view {tag}",
                                planted_logits(g, 4, 64, 64, 3, dtype, nchw=True), thr))
        for nchw in (False, True):
            lay = "NCHW view" if nchw else "NHWC"
            err = max(err, check_k1(f"H!=W {lay} {tag}",
                                    planted_logits(g, 3, 40, 72, 3, dtype, nchw), thr))
            err = max(err, check_k1(f"odd W {lay} {tag}",
                                    planted_logits(g, 2, 33, 37, 3, dtype, nchw), thr))
        base = planted_logits(g, 2, 64, 96, 3, dtype, nchw=True)
        err = max(err, check_k1(f"row-strided slice {tag}", base[:, ::2, 1:], thr))
        for fill in (-10.0, 10.0):
            x = torch.full((2, 24, 40, 3), fill, dtype=dtype, device="cuda")
            err = max(err, check_k1(f"all {'below' if fill < 0 else 'above'} "
                                    f"{tag}", x, thr))
    for nchw in (False, True):
        serving = planted_logits(g, SERVE_BATCH, 512, 512, 3, torch.bfloat16, nchw)
        err = max(err, check_k1(f"serving shape {'NCHW view' if nchw else 'NHWC'} "
                                f"bf16", serving, thr))
    return err


# -- phases 4-6: the main path -----------------------------------------------


def grid_boxes(mask):
    """Inclusive boxes of (B,S,S,3) bool masks on the grid, as the fixture's."""
    b, v = bbox_from_probs(mask.to(torch.float32), [0.5, 0.5, 0.5])
    return b.cpu().numpy(), v.cpu().numpy()


def phase_fp32(fix):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("  TF32 off: torch.backends.cudnn.allow_tf32 = "
          "torch.backends.cuda.matmul.allow_tf32 = False", flush=True)
    seg = load_pretrained_segmenter(variant="w16", dtype=torch.float32)
    pages = fix["pages"]
    rgb = np.repeat(pages[..., None], 3, axis=-1)
    mask, boxes, ok = seg.segment_batch(rgb, pre_resized=False)
    boxes, ok = boxes.cpu().numpy(), ok.cpu().numpy()
    gboxes, gvalid = grid_boxes(mask)
    if not np.array_equal(ok, fix["ok"]):
        raise AssertionError(f"fp32 ok flags {ok.tolist()} != JAX {fix['ok'].tolist()}")
    if not np.array_equal(gvalid, fix["grid_valid"]):
        raise AssertionError(f"fp32 valid flags {gvalid.tolist()} != JAX "
                             f"{fix['grid_valid'].tolist()}")
    dg = np.abs(gboxes - fix["grid_boxes"])[gvalid]
    if dg.size and dg.max() > 1:
        raise AssertionError(f"fp32 grid boxes off by {dg.max()} cells from JAX:\n"
                             f"{gboxes.tolist()}\nvs\n{fix['grid_boxes'].tolist()}")
    n_crops = 0
    for i, page in enumerate(pages):
        crops = crop_fields(page, boxes[i], ok[i], seg.cfg.black_crop_mean)
        for j, (field, crop) in enumerate(crops.items()):
            if ok[i, j] and crop is None:
                raise AssertionError(f"page {i} {field}: found but no crop")
            if crop is not None:
                x1, y1, x2, y2 = boxes[i, j]
                if crop.shape != (y2 - y1, x2 - x1):
                    raise AssertionError(f"page {i} {field}: crop {crop.shape} "
                                         f"for box {boxes[i, j].tolist()}")
                n_crops += 1
    exact = int((gboxes == fix["grid_boxes"]).all(-1)[gvalid].sum())
    exact_px = int((boxes == fix["boxes"]).all(-1)[ok].sum())
    print(f"  fp32 vs JAX: valid {int(gvalid.sum())}/{gvalid.size} equal; grid "
          f"boxes exactly equal {exact}/{int(gvalid.sum())}, max |d| "
          f"{int(dg.max()) if dg.size else 0} cell; pixel boxes exactly equal "
          f"{exact_px}/{int(ok.sum())}; {n_crops} crops", flush=True)
    return gboxes, gvalid


def phase_bf16(fix, ref):
    gb32, gv32 = ref
    seg = load_pretrained_segmenter(variant="w16", dtype=torch.bfloat16)
    rgb = np.repeat(fix["pages"][..., None], 3, axis=-1)
    mask, _, ok = seg.segment_batch(rgb, pre_resized=False)
    gb, gv = grid_boxes(mask)
    both = gv & gv32
    d = np.abs(gb - gb32)[both]
    print(f"  bf16 vs fp32: valid equal {int((gv == gv32).sum())}/{gv.size}; grid "
          f"boxes exactly equal {int((d == 0).all(-1).sum())}/{int(both.sum())}, "
          f"max |d| {int(d.max()) if d.size else 0} cells", flush=True)
    return seg


def serving_batch(fix, size):
    """The fixture pages resized to the grid on the device, repeated to the
    serving batch: (128, 512, 512, 3) uint8 on the card."""
    raw = torch.as_tensor(fix["pages"], device="cuda")[:, None].expand(-1, 3, -1, -1)
    small = resize_bilinear(raw, size, size).round().clamp(0, 255).to(torch.uint8)
    small = small.permute(0, 2, 3, 1)
    reps = -(-SERVE_BATCH // small.shape[0])
    return small.repeat(reps, 1, 1, 1)[:SERVE_BATCH].contiguous()


def phase_serving(seg, fix, card):
    size = seg.cfg.img_size
    imgs = serving_batch(fix, size)
    h, w = fix["pages"].shape[1:]
    sizes = np.tile(np.asarray([[w, h]], np.int32), (SERVE_BATCH, 1))
    for _ in range(3):
        _, boxes, ok = seg.segment_batch(imgs, sizes, return_masks=False)
        boxes.cpu()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(SERVE_ITERS):
        _, boxes, ok = seg.segment_batch(imgs, sizes, return_masks=False)
        host_boxes = boxes.cpu().numpy()
    dt = time.perf_counter() - t
    ok = ok.cpu().numpy()
    if not ok.all() or host_boxes.shape != (SERVE_BATCH, 3, 4):
        raise AssertionError(f"b{SERVE_BATCH} serving: {int(ok.sum())}/{ok.size} ok")
    ips = SERVE_BATCH * SERVE_ITERS / dt
    print(f"  b{SERVE_BATCH} {size}^2 bf16 box-only, boxes to host each batch: "
          f"{ips:.1f} img/s ({1e3 * dt / SERVE_ITERS:.2f} ms/batch, "
          f"{SERVE_ITERS} batches) [{card}]", flush=True)
    return imgs, 3 + SERVE_ITERS, ips


def time_k1(seg, imgs, thr, card):
    """K1 on the w16 model's own serving logits (NHWC-contiguous: the U-Net
    runs channels-last), and on the same values as an NCHW tensor's view."""
    with torch.inference_mode():
        x = imgs.permute(0, 3, 1, 2).to(seg.dtype) / 255.0
        x = x.contiguous(memory_format=torch.channels_last)
        logits = unet_apply_folded(seg.folded, x).permute(0, 2, 3, 1)
    if not logits.is_contiguous():
        raise AssertionError(f"serving logits strides {logits.stride()}: "
                             f"expected NHWC-contiguous")
    nchw_view = logits.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    check_k1("serving logits of the w16 model", logits, thr)
    check_k1("serving logits as an NCHW view", nchw_view, thr)
    ms = cuda_ms(lambda: k1.bbox_postprocess(logits, thr), iters=50)
    view_ms = cuda_ms(lambda: k1.bbox_postprocess(nchw_view, thr), iters=50)
    plain_ms = cuda_ms(lambda: k1.bbox_postprocess_reference(logits, thr), iters=10)
    b, _, _, c = logits.shape
    n_bytes = logits.numel() * logits.element_size() + b * c * (4 * 4 + 1) + 4 * c
    ops = logits.numel()  # one compare per logit; min/max updates only on hits
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / FP32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  K1 {tuple(logits.shape)} {logits.dtype} NHWC-contiguous: {ms:.4f} ms "
          f"vs bound {bound_ms:.4f} ms ({n_bytes} B at 3.35 TB/s; "
          f"{100 * bound_ms / ms:.1f}% of bound); as an NCHW view {view_ms:.4f} ms; "
          f"plain PyTorch {plain_ms:.4f} ms; no single PyTorch call computes it "
          f"[{card}]", flush=True)
    return ms, plain_ms, bound_ms, bound_by


# -- phase 8: the int8 kernels against their plain versions -------------------


def trunk_launches(base=16, size=512, depth=4):
    """The int8 trunk's launches at a ``size``² grid, in order, repeats kept:
    → (convs, decoder conv1s, upsamples), each [(hw, cin, cout)] with ``hw``
    the input's side; a decoder conv1's ``cin`` is one half's (K4a takes both
    halves concatenated, 2·cin; K5 takes them apart)."""
    convs, conv1s, ups = [], [], []
    cin, hw = 3, size
    widths = [base * 2 ** i for i in range(depth)]
    for w in widths:
        convs += [(hw, cin, w), (hw, w, w)]
        cin, hw = w, hw // 2
    convs += [(hw, cin, 2 * cin), (hw, 2 * cin, 2 * cin)]
    c = 2 * cin
    for w in reversed(widths):
        ups.append((hw, c, w))
        hw *= 2
        conv1s.append((hw, w, w))
        convs.append((hw, w, w))
        c = w
    return convs, conv1s, ups


def trunk_shapes(base=16, size=512, depth=4):
    """The int8 trunk's launches at a ``size``² grid, each shape once:
    → {kernel: [(hw, cin, cout)]} (K5's ``cin`` is each half's; K4a's
    decoder conv1 takes both halves concatenated)."""
    convs, conv1s, ups = trunk_launches(base, size, depth)
    k4a = convs[:2 * depth + 2]
    for (hw, c, co), conv2 in zip(conv1s, convs[2 * depth + 2:]):
        k4a += [(hw, 2 * c, co), conv2]
    return {qconv.K4A: list(dict.fromkeys(k4a)), qconv.K5: conv1s, k6.K6: ups}


def route_conv_launches(base=16):
    """K4a's and K5's launches in one box-only batch of the concat routes
    ("pallas", "xla", the W-phase "full") and of the split "pallas trunk":
    → {route: [(kernel, (hw, cin, cout))]}."""
    convs, conv1s, _ = trunk_launches(base)
    concat = [(qconv.K4A, s) for s in convs] + [
        (qconv.K4A, (hw, 2 * c, co)) for hw, c, co in conv1s]
    split = [(qconv.K4A, s) for s in convs] + [(qconv.K5, s) for s in conv1s]
    return {"concat": concat, "pallas trunk": split}


def conv_bound_ms(kind, n, hw, cin, co):
    """Least time for one launch on the H100 SXM: each input byte read once,
    each output byte written once, against the int8 operations at the
    tensor-core rate. → (bound_ms, "bytes" or "operations")."""
    px = n * hw * hw
    if kind == k6.K6:
        n_bytes = px * cin + 4 * cin * co + 4 * px * co + 8 * co
        ops = 2 * 4 * px * cin * co
    else:
        halves = 2 if kind == qconv.K5 else 1
        n_bytes = halves * (px * cin + 9 * cin * co) + px * co + 8 * co
        ops = 2 * 9 * px * halves * cin * co
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / INT8_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def head_bound_ms(b, h, w, c):
    n_bytes = b * h * w * c + 12 * c + 12 * b * (h + w)
    ops = 2 * 3 * c * b * h * w  # float32 multiply-adds on the CUDA cores
    bytes_ms, ops_ms = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def rand_s8(g, shape, lo=-127, hi=128):
    return torch.randint(lo, hi, shape, generator=g, device="cuda").to(torch.int8)


def planted_s8(g, shape):
    """Zeros with extreme values at the corners and the centre, and a random
    3×3 patch on the right edge: SAME padding and tap orientation show."""
    n, h, w, c = shape
    x = torch.zeros(shape, dtype=torch.int8, device="cuda")
    x[:, 0, 0] = 127
    x[:, h - 1, w - 1] = -127
    x[:, h // 2, w // 2] = rand_s8(g, (n, c))
    r0, r1, c0 = max(0, h // 2 - 1), min(h, h // 2 + 2), max(0, w - 3)
    x[:, r0:r1, c0:] = rand_s8(g, (n, r1 - r0, w - c0, c))
    return x


def epilogue_operands(g, co):
    w_scale = 1e-3 + 1e-3 * torch.rand(co, generator=g, device="cuda")
    bias = 0.5 * torch.randn(co, generator=g, device="cuda")
    return w_scale, bias


MAX_ABS_ERR = {}  # int8 kernel → the largest |kernel − plain or sibling| seen


def check_same(kind, label, got, want, what="its plain version"):
    """Hold ``kind``'s int8 output to ``want`` exactly and record the largest
    difference in MAX_ABS_ERR."""
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)}, {what} "
                             f"{tuple(want.shape)}")
    err = max((int((g.to(torch.int16) - w.to(torch.int16)).abs().max())  # 16 images
               for g, w in zip(got.split(16), want.split(16)) if g.numel()), default=0)
    MAX_ABS_ERR[kind] = max(MAX_ABS_ERR.get(kind, 0), err)
    if err:
        ne = got != want
        idx = ne.nonzero()[:4].tolist()
        raise AssertionError(f"{label}: {int(ne.sum())} of {ne.numel()} outputs differ "
                             f"from {what} (max |d| {err}), first at {idx}")


def check_int8(kind, label, got, ref, lo, need_clips):
    check_same(kind, label, got, ref)
    top, bottom = int((ref == 127).sum()), int((ref == lo).sum())
    if need_clips and not (top and bottom):
        raise AssertionError(f"{label}: the case does not clip at both ends "
                             f"({top} at 127, {bottom} at {lo})")
    print(f"  {label}: equal, {ref.numel()} outputs ({top} at 127, {bottom} at {lo})",
          flush=True)


def spread_scale(y):
    """An out_scale that puts the top and bottom of ``y`` past the clip."""
    return float(0.5 * y.abs().max().clamp_min(1e-6))


def misaligned(t):
    """A contiguous copy of ``t`` whose storage starts 1 byte into its buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def case_conv(g, kind, label, n, h, w, cin, co, *, relu=True, scale_first=False,
              s_in2=None, planted=False, subset=None, need_clips=True, misalign=False):
    """One K4a/K5/K6 launch held against its plain version on ``subset`` of
    the batch (all of it by default). ``misalign``: K4a/K5/K6 read inputs
    (K6 its weights too) and write an output that start 1 byte into their
    buffers."""
    taps = 2 if kind == k6.K6 else 3
    make = planted_s8 if planted else rand_s8
    x = make(g, (n, h, w, cin))
    x2 = make(g, (n, h, w, cin)) if kind == qconv.K5 else None
    kern = rand_s8(g, (co, taps, taps, cin))
    if misalign:
        x, x2 = misaligned(x), None if x2 is None else misaligned(x2)
        kern = misaligned(kern) if kind == k6.K6 else kern
    kern2 = rand_s8(g, (co, taps, taps, cin)) if kind == qconv.K5 else None
    ws, b = epilogue_operands(g, co)
    s_in = 0.5 + float(torch.rand((), generator=g, device="cuda"))
    sub = slice(None) if subset is None else subset
    xs = x[sub]
    if kind == k6.K6:
        relu = False
        acc = qconv.conv_transpose2x2_i8(xs, kern)
    else:
        acc = qconv.conv3x3_i8(xs, kern)
        if x2 is not None:
            acc2 = qconv.conv3x3_i8(x2[sub], kern2)
    if kind == qconv.K5 and s_in2 is not None:
        y = (acc.float() * np.float32(s_in) + acc2.float() * np.float32(s_in2)) * ws + b
    elif kind == qconv.K5:
        y = qconv.dequant(acc + acc2, ws, b, s_in)
    else:
        y = qconv.dequant(acc, ws, b, s_in, scale_first=scale_first)
    out_scale = spread_scale(y)
    del acc, y
    if misalign and kind == k6.K6:  # the wrappers allocate aligned outputs
        out = misaligned(torch.zeros((n, 2 * h, 2 * w, co), dtype=torch.int8,
                                     device="cuda"))
        got = k6._launch(x, kern, ws, b, s_in, out_scale, out=out)
        ref = k6.qupsample2x2_requant_reference(xs, kern, ws, b, s_in, out_scale)
        label += " (in and out 1 byte off alignment)"
    elif misalign:  # the wrappers allocate aligned outputs: launch into a view
        out = misaligned(torch.zeros((n, h, w, co), dtype=torch.int8, device="cuda"))
        sep = s_in2 is not None
        mode = qconv._SEPARATE if sep else qconv._CHAIN if scale_first else qconv._PROD
        got = qconv._launch(kind, x, x2, kern, kern2, ws, b, s_in, s_in2 if sep else 0.0,
                            out_scale, mode, relu, out=out)
        ref = (qconv.qconv3x3_split_requant_reference(
            xs, x2[sub], kern, kern2, ws, b, s_in, out_scale, s_in2=s_in2, relu=relu)
            if kind == qconv.K5 else qconv.qconv3x3_requant_reference(
                xs, kern, ws, b, s_in, out_scale, relu=relu, scale_first=scale_first))
        label += " (in and out 1 byte off alignment)"
    elif kind == k6.K6:
        got = k6.qupsample2x2_requant(x, kern, ws, b, s_in, out_scale)
        ref = k6.qupsample2x2_requant_reference(xs, kern, ws, b, s_in, out_scale)
    elif kind == qconv.K5:
        got = qconv.qconv3x3_split_requant(x, x2, kern, kern2, ws, b, s_in, out_scale,
                                           s_in2=s_in2, relu=relu)
        ref = qconv.qconv3x3_split_requant_reference(
            xs, x2[sub], kern, kern2, ws, b, s_in, out_scale, s_in2=s_in2, relu=relu)
    else:
        got = qconv.qconv3x3_requant(x, kern, ws, b, s_in, out_scale, relu=relu,
                                     scale_first=scale_first)
        ref = qconv.qconv3x3_requant_reference(xs, kern, ws, b, s_in, out_scale,
                                               relu=relu, scale_first=scale_first)
    torch.cuda.synchronize()
    check_int8(kind, f"{kind} {label} {tuple(x.shape)}->{co}", got[sub], ref,
               0 if relu else -127, need_clips)


def check_k2(label, x, w, scale, compute_dtype=torch.bfloat16):
    """K2 against its plain version. The int8 × bf16 products are exact in
    float32; the sums differ only in order, so each maximum may differ by at
    most C·2^-23 times the largest sum of |terms| over the pixels it spans
    (twice the float32 bound (C−1)·2^-24·Σ|terms| of a sum of C terms). With
    float32 weights each product is rounded once more (or fused into its
    sum), which the same bound still covers: C·2^-24·Σ|terms| a side."""
    row, col = k2.head_rowcol_max(x, w, scale, compute_dtype)
    rrow, rcol = k2.head_rowcol_max_reference(x, w, scale, compute_dtype)
    absterms = x.abs().to(torch.float32) @ k2.head_weight(w, scale, compute_dtype).abs()
    c = x.shape[-1]
    tol_row = c * 2.0 ** -23 * absterms.amax(dim=2)
    tol_col = c * 2.0 ** -23 * absterms.amax(dim=1)
    del absterms
    torch.cuda.synchronize()
    err_row, err_col = (row - rrow).abs(), (col - rcol).abs()
    if (err_row > tol_row).any() or (err_col > tol_col).any():
        raise AssertionError(f"K2 {label}: row err {float(err_row.max())}, col err "
                             f"{float(err_col.max())} beyond the summation bound")
    err = max(float(err_row.max()), float(err_col.max()))
    print(f"  K2 {label} {tuple(x.shape)} {compute_dtype} weights: max |d| {err:.3g} (bound "
          f"{float(max(tol_row.max(), tol_col.max())):.3g})", flush=True)
    return err


def phase_int8_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    # planted and random inputs; H != W and odd W; Cin 3, 5, 16, 48, 256;
    # ReLU and none; the out scale clips at both ends
    for cin in (3, 5, 16, 48, 256):
        for relu in (True, False):
            case_conv(g, qconv.K4A, f"random relu={relu}", 2, 13, 37, cin, 16, relu=relu)
    case_conv(g, qconv.K4A, "planted", 2, 9, 21, 16, 16, need_clips=False)
    case_conv(g, qconv.K4A, "planted Cin=5 Co=3", 1, 7, 5, 5, 3, relu=False,
              need_clips=False)
    case_conv(g, qconv.K4A, "concat form (scale first)", 2, 11, 17, 32, 16,
              scale_first=True)
    case_conv(g, qconv.K4A, "Co=24", 1, 8, 33, 48, 24)
    for cin in (5, 16, 48):
        case_conv(g, qconv.K5, "shared sum", 2, 13, 37, cin, 16)
        case_conv(g, qconv.K5, "two scales", 2, 13, 37, cin, 16, s_in2=0.7)
    case_conv(g, qconv.K5, "planted", 1, 10, 19, 16, 16, need_clips=False)
    # the tensor-core kernel's contract: every k layout (stem Cin <= 4, tap
    # pairs Cin <= 16, 32-channel steps) and its edges, the Cin chunk carry,
    # Co off the block's tile and past one block, each epilogue mode at a
    # narrow and a wide Cin, K5's two forms, H and W off the output tile, and
    # inputs and outputs 1 byte off alignment
    for cin in (1, 2, 4, 8, 17, 31, 33, 64, 129):
        case_conv(g, qconv.K4A, "Cin edge", 2, 11, 35, cin, 16, relu=cin % 2 == 0)
    case_conv(g, qconv.K4A, "Cin 1024", 1, 9, 33, 1024, 24)
    for cin, co in ((5, 1), (16, 8), (33, 40), (64, 72), (48, 128), (129, 256)):
        case_conv(g, qconv.K4A, "Co edge", 1, 10, 34, cin, co, need_clips=co > 1)
    for cin in (3, 129):
        case_conv(g, qconv.K4A, "chain form", 2, 9, 40, cin, 24, scale_first=True)
        case_conv(g, qconv.K4A, "product form, no ReLU", 2, 9, 40, cin, 24, relu=False)
        case_conv(g, qconv.K5, "two scales", 1, 9, 40, cin, 40, s_in2=0.7)
    for cin in (3, 16, 33, 129):
        case_conv(g, qconv.K5, "shared sum", 2, 12, 36, cin, 24)
        case_conv(g, qconv.K5, "two scales", 2, 12, 36, cin, 24, s_in2=0.45, relu=False)
    for cin, co in ((3, 16), (16, 16), (17, 32), (129, 48)):
        case_conv(g, qconv.K4A, "misaligned", 2, 9, 35, cin, co, misalign=True)
        case_conv(g, qconv.K5, "misaligned", 1, 9, 35, cin, co, misalign=True,
                  s_in2=0.6 if cin > 16 else None)
    case_conv(g, qconv.K4A, "one pixel", 1, 1, 1, 16, 16, need_clips=False)
    for cin, co in ((3, 16), (5, 3), (16, 16), (48, 24), (256, 128)):
        case_conv(g, k6.K6, "random", 2, 9, 13, cin, co)
    case_conv(g, k6.K6, "planted", 1, 6, 7, 32, 16, need_clips=False)
    # K6's tensor-core contract: Cin over the 32-byte k step and the chunk
    # carry, Co off the 8-, 16- and 32-channel block and past one block,
    # inputs, weights and outputs 1 byte off alignment, a 1x1 image, H != W
    # and odd W, pixels off the 256- and 128-pixel tiles
    for cin in (1, 2, 4, 17, 31, 33, 64, 129):
        case_conv(g, k6.K6, "Cin edge", 2, 7, 19, cin, 16)
    case_conv(g, k6.K6, "Cin 1024", 1, 5, 9, 1024, 24)
    for cin, co in ((5, 1), (16, 8), (33, 40), (64, 72), (129, 256)):
        case_conv(g, k6.K6, "Co edge", 1, 6, 11, cin, co, need_clips=co > 1)
    for cin, co in ((3, 16), (16, 16), (17, 32), (129, 48), (64, 64)):
        case_conv(g, k6.K6, "misaligned", 2, 5, 13, cin, co, misalign=True)
    case_conv(g, k6.K6, "one pixel", 1, 1, 1, 16, 16, need_clips=False)
    case_conv(g, k6.K6, "H != W, odd W", 3, 17, 29, 32, 32)

    err = 0.0
    for b, h, w, c in ((2, 16, 24, 8), (3, 9, 13, 16), (8, 16, 256, 32),
                       (2, 7, 11, 5), (2, 12, 20, 12)):
        x = rand_s8(g, (b, h, w, c))
        wt = 0.2 * torch.randn((c, 3), generator=g, device="cuda")
        err = max(err, check_k2("random", x, wt, 0.037))
    x = torch.zeros((2, 33, 47, 16), dtype=torch.int8, device="cuda")
    x[0, 5, 40] = 127
    x[1, 32, 0] = -127
    err = max(err, check_k2("planted", x, 0.2 * torch.randn((16, 3), generator=g,
                                                            device="cuda"), 0.05))

    # every layer shape of the w16 trunk at b128, held on images 0 and 127
    sub = torch.tensor([0, SERVE_BATCH - 1], device="cuda")
    for kind, shapes in trunk_shapes().items():
        for hw, cin, co in shapes:
            case_conv(g, kind, "w16 trunk", SERVE_BATCH, hw, hw, cin, co, subset=sub,
                      relu=kind != k6.K6)
    x = rand_s8(g, (SERVE_BATCH, 512, 512, 16), 0, 128)
    err = max(err, check_k2("w16 serving shape", x,
                            0.2 * torch.randn((16, 3), generator=g, device="cuda"), 0.05))
    return err


# -- phases 9-10: the int8 routes --------------------------------------------


ROUTE_KERNELS = {  # kernels each box-only route launches, per segment_batch call
    "xla": {qconv.K4A: 18, k6.K6: 4, k1.NAME: 1},
    "xla-bf16": {qconv.K4A: 18, k6.K6: 4, k1.NAME: 1},
    "pallas": {qconv.K4A: 18, k6.K6: 4, k2.NAME: 1},
    "pallas trunk": {qconv.K4A: 14, qconv.K5: 4, k6.K6: 4},
}
ROUTE_ARGS = {"xla": {"int8_head": "xla"}, "xla-bf16": {"int8_head": "xla-bf16"},
              "pallas": {"int8_head": "pallas"}, "pallas trunk": {"int8_pallas": True}}


def counted(route, expect, calls, fn):
    """Run ``fn`` with the launch counts zeroed just before and read just
    after; every kernel in ``expect`` must have launched ``expect·calls`` times
    and no other int8 kernel at all. → (fn's result, the counts)."""
    _build.launches.clear()
    out = fn()
    torch.cuda.synchronize()
    got = dict(_build.launches)
    want = {k: v * calls for k, v in expect.items()}
    if got != want:
        raise AssertionError(f"route {route}: launches {got}, expected {want}")
    return out, got


def grid_check(label, gboxes, gvalid, ref_boxes, ref_valid):
    gboxes, gvalid = np.asarray(torch.as_tensor(gboxes).cpu()), np.asarray(
        torch.as_tensor(gvalid).cpu())
    if not np.array_equal(gvalid, ref_valid):
        raise AssertionError(f"{label}: valid {gvalid.tolist()} != JAX {ref_valid.tolist()}")
    d = np.abs(gboxes - ref_boxes)[gvalid]
    if d.size and d.max() > 1:
        raise AssertionError(f"{label}: grid boxes off by {d.max()} cells from JAX:\n"
                             f"{gboxes.tolist()}\nvs\n{ref_boxes.tolist()}")
    return int((d == 0).all(-1).sum()), int(gvalid.sum()), int(d.max()) if d.size else 0


def ok_check(label, ok, boxes, ref_ok, ref_boxes, tol_px):
    ok, boxes = ok.cpu().numpy(), boxes.cpu().numpy()
    if not np.array_equal(ok, ref_ok):
        raise AssertionError(f"{label}: ok {ok.tolist()} != JAX {ref_ok.tolist()}")
    d = np.abs(boxes.astype(np.int64) - ref_boxes)[ok]
    if d.size and d.max() > tol_px:
        raise AssertionError(f"{label}: pixel boxes off by {d.max()} px from JAX "
                             f"(one grid cell is {tol_px} px)")
    return int((d == 0).all(-1).sum()), int(ok.sum())


def phase_int8_routes(fix, fix8):
    from twinvoice_tpu_torch.config import UNetConfig
    from twinvoice_tpu_torch.models.pretrained import variant_path
    from twinvoice_tpu_torch.models.unet import fold_unet
    from twinvoice_tpu_torch.weights import load_npz

    calib = fix8["calib"]
    rgb = np.repeat(calib[..., None], 3, axis=-1)
    params, state = load_npz(variant_path("w16"))
    folded = fold_unet(params, state, cfg=UNetConfig(base_width=16),
                       dtype=torch.float32, device="cuda")
    mine = quant.scales_to_array(quant.calibrate(folded, [rgb]))
    rel = np.abs(mine - fix8["scales"]) / fix8["scales"]
    if rel.max() > 1e-5:
        raise AssertionError(f"calibration scales off JAX's by {rel.max():.3g} relative")
    print(f"  calibration: {len(mine)} scales, max relative difference from JAX "
          f"{rel.max():.3g} (TF32 off inside calibrate)", flush=True)
    scales = quant.scales_from_array(fix8["scales"])
    pages = fix["pages"]
    h, w = pages.shape[1:]
    grid = calib.shape[1]
    sizes = np.tile(np.asarray([[w, h]], np.int32), (len(pages), 1))
    tol_px = -(-max(h, w) // grid) + 1  # one grid cell in pixels, +1 for the pad's floor
    segs = {r: load_pretrained_segmenter(torch.float32, variant="w16",
                                         int8_scales=scales, **ROUTE_ARGS[r])
            for r in ROUTE_KERNELS}
    thr = probability_to_logit_thresholds((0.25, 0.40, 0.30))
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    seg = segs["xla"]
    (mask, boxes, ok), n = counted("xla (masks)", ROUTE_KERNELS["xla"], 1,
                                   lambda: seg.segment_batch(rgb, sizes))
    add(n)
    exact = grid_check("xla", *grid_boxes(mask), fix8["xla_grid_boxes"],
                       fix8["xla_grid_valid"])
    px = ok_check("xla", ok, boxes, fix8["xla_ok"], fix8["xla_boxes"], tol_px)
    print(f"  xla (masks): ok equal; grid boxes exactly equal {exact[0]}/{exact[1]}, "
          f"max |d| {exact[2]} cell; pixel boxes exactly equal {px[0]}/{px[1]}; "
          f"launches {n}", flush=True)

    raw = np.repeat(pages[..., None], 3, axis=-1)
    (mask, boxes, ok), n = counted("raw (device resize)", ROUTE_KERNELS["xla"], 1,
                                   lambda: seg.segment_batch(raw, pre_resized=False))
    add(n)
    exact = grid_check("raw", *grid_boxes(mask), fix8["raw_grid_boxes"],
                       fix8["raw_grid_valid"])
    px = ok_check("raw", ok, boxes, fix8["raw_ok"], fix8["raw_boxes"], tol_px)
    print(f"  raw (device resize): ok equal; grid boxes exactly equal "
          f"{exact[0]}/{exact[1]}, max |d| {exact[2]} cell; pixel boxes exactly "
          f"equal {px[0]}/{px[1]}; launches {n}", flush=True)

    u8 = torch.as_tensor(rgb, device="cuda")
    q = seg.qparams
    thr_eff = thr - q["out"]["bias"].cpu()  # the bias folded into the thresholds
    with torch.inference_mode():
        logits = quant.unet_apply_quantized(q, u8)
        grids = {
            "xla-bf16": k1.bbox_postprocess(
                quant.unet_apply_quantized(q, u8, logits_dtype=torch.bfloat16), thr),
            "pallas": k2.bbox_from_rowcol_max(
                *quant.unet_apply_quantized_rowcol_max(q, u8), thr_eff),
        }
        trunk = quant.unet_apply_quantized_pallas_rowcol_max(
            q, segs["pallas trunk"].pallas_params, u8)
    ref_route = {"xla-bf16": "xla", "pallas": "pallas"}
    for route in ("xla-bf16", "pallas", "pallas trunk"):
        s = segs[route]
        (_, boxes, ok), n = counted(route, ROUTE_KERNELS[route], 1,
                                    lambda: s.segment_batch(rgb, sizes, return_masks=False))
        add(n)
        jr = ref_route.get(route, "pallas")
        px = ok_check(route, ok, boxes, fix8[f"{jr}_ok"], fix8[f"{jr}_boxes"], tol_px)
        msg = f"pixel boxes within {tol_px} px, exactly equal {px[0]}/{px[1]}"
        if route in grids:
            exact = grid_check(route, *grids[route], fix8[f"{jr}_grid_boxes"],
                               fix8[f"{jr}_grid_valid"])
            msg = (f"grid boxes exactly equal {exact[0]}/{exact[1]}, max |d| "
                   f"{exact[2]} cell; " + msg)
        print(f"  {route} (box-only) vs JAX {jr}: ok equal; {msg}; launches {n}",
              flush=True)

    # the Pallas-trunk route against the port's xla route: bias-free maxima
    bias = q["out"]["bias"]
    row_ref, col_ref = logits.amax(dim=2) - bias, logits.amax(dim=1) - bias
    for name, got, ref in (("row", trunk[0], row_ref), ("col", trunk[1], col_ref)):
        if not torch.allclose(got, ref, rtol=2e-2, atol=5e-2):
            raise AssertionError(f"pallas trunk {name} maxima off the xla route's: "
                                 f"max |d| {float((got - ref).abs().max())}")
    d = max(float((trunk[0] - row_ref).abs().max()), float((trunk[1] - col_ref).abs().max()))
    print(f"  pallas trunk vs the port's xla route: row/col maxima within rtol 2e-2, "
          f"atol 5e-2 (max |d| {d:.3g})", flush=True)
    return segs, launches


def phase_int8_serving(segs, fix, card, bf16_ips):
    size = 512
    imgs = serving_batch(fix, size)
    h, w = fix["pages"].shape[1:]
    sizes = np.tile(np.asarray([[w, h]], np.int32), (SERVE_BATCH, 1))
    launches, rates = {}, {}
    for route, expect in ROUTE_KERNELS.items():
        seg = segs[route]

        def serve():
            for _ in range(3):
                seg.segment_batch(imgs, sizes, return_masks=False)[1].cpu()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(SERVE_ITERS):
                _, boxes, ok = seg.segment_batch(imgs, sizes, return_masks=False)
                host = boxes.cpu().numpy()
            return time.perf_counter() - t, host, ok.cpu().numpy()

        (dt, host, ok), n = counted(route, expect, 3 + SERVE_ITERS, serve)
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        if not ok.all() or host.shape != (SERVE_BATCH, 3, 4):
            raise AssertionError(f"{route} b{SERVE_BATCH}: {int(ok.sum())}/{ok.size} ok")
        rates[route] = SERVE_BATCH * SERVE_ITERS / dt
        per_call = {k: v // (3 + SERVE_ITERS) for k, v in n.items()}
        print(f"  b{SERVE_BATCH} {size}^2 int8 {route} box-only, boxes to host each "
              f"batch: {rates[route]:.1f} img/s ({1e3 * dt / SERVE_ITERS:.2f} ms/batch; "
              f"bf16 {bf16_ips:.1f} img/s in phase 6); launches per batch {per_call} "
              f"[{card}]", flush=True)
    return launches, rates


# -- phase 11: int8 kernel times ------------------------------------------------


# The int8 kernels' times before their tensor-core redesigns, when they ran on
# the CUDA cores (__dp4a), at the w16 serving shapes at b128, on an NVIDIA H100
# 80GB HBM3 at 700.00 W: K4a's and K5's from this script's phase 11 before
# their redesign; K6's (phase 11) and K7b's (phase 14, by call) from the run of
# the tree before theirs
DP4A_MS = {
    (qconv.K4A, (512, 3, 16)): 1.2044, (qconv.K4A, (512, 16, 16)): 2.4522,
    (qconv.K4A, (256, 16, 32)): 1.2178, (qconv.K4A, (256, 32, 32)): 2.0120,
    (qconv.K4A, (128, 32, 64)): 0.9919, (qconv.K4A, (128, 64, 64)): 1.8397,
    (qconv.K4A, (64, 64, 128)): 0.9434, (qconv.K4A, (64, 128, 128)): 1.9055,
    (qconv.K4A, (32, 128, 256)): 0.9640, (qconv.K4A, (32, 256, 256)): 1.8378,
    (qconv.K4A, (64, 256, 128)): 3.6391, (qconv.K4A, (128, 128, 64)): 3.8027,
    (qconv.K4A, (256, 64, 32)): 3.6855, (qconv.K4A, (512, 32, 16)): 3.9748,
    (qconv.K5, (64, 128, 128)): 4.2706, (qconv.K5, (128, 64, 64)): 4.0704,
    (qconv.K5, (256, 32, 32)): 4.4499, (qconv.K5, (512, 16, 16)): 5.1803,
    (k6.K6, (32, 256, 128)): 0.6555, (k6.K6, (64, 128, 64)): 0.6626,
    (k6.K6, (128, 64, 32)): 0.5988, (k6.K6, (256, 32, 16)): 0.7111,
    (nhwc.K7B, "enc0 conv2 A->B"): 3.5447, (nhwc.K7B, "dec0 conv1 B->A"): 6.7482,
    (nhwc.K7B, "dec0 conv2 A->B"): 3.5964,
}


def cudnn_bf16_ms(g, hw, cin, co):
    """cuDNN's bf16 channels-last 3x3 conv (no bias) at one K4a shape: context
    for K4a's time, not its library time (it computes another function)."""
    x = torch.randn((SERVE_BATCH, cin, hw, hw), generator=g, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = torch.randn((co, cin, 3, 3), generator=g, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        return cuda_ms(lambda: torch.nn.functional.conv2d(x, wt, padding=1), iters=10,
                       warmup=2)


def int_mm_ms(x, kern):
    """``torch._int_mm`` on K6's [pixels, Cin] × [Cin, 4·Co] product, the
    weight rows read as the columns (context for K6's design, not its library
    time: it computes neither the requant nor the output layout). → ms, or
    None where ``_int_mm`` does not accept the shape."""
    a = x.reshape(-1, x.shape[-1])
    b = kern.reshape(-1, x.shape[-1]).t()
    for bb in (b, b.contiguous()):
        try:
            torch._int_mm(a, bb)
        except RuntimeError:
            continue
        return cuda_ms(lambda: torch._int_mm(a, bb), iters=10, warmup=2)
    return None


def time_int8_kernels(card):
    """Each int8 kernel at every serving shape of the w16 trunk (b128), K4a,
    K5 and K6 beside their bound and their CUDA-core times, K4a beside cuDNN's
    bf16 conv and K6 beside ``torch._int_mm``'s product; the summed K4a and K5
    time of a route batch and K6's four launches against their summed bound;
    the plain version at the kernel's heaviest shape. → {kernel: (ms, plain
    ms, bound ms, bound by)} at that shape."""
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    calls = {
        qconv.K4A: (qconv.qconv3x3_requant, qconv.qconv3x3_requant_reference),
        qconv.K5: (qconv.qconv3x3_split_requant,
                   qconv.qconv3x3_split_requant_reference),
        k6.K6: (k6.qupsample2x2_requant, k6.qupsample2x2_requant_reference),
    }
    rows, shape_ms = {}, {}
    for kind, shapes in trunk_shapes().items():
        kernel_fn, plain_fn = calls[kind]
        best = None
        for hw, cin, co in shapes:
            taps = 2 if kind == k6.K6 else 3
            x = rand_s8(g, (SERVE_BATCH, hw, hw, cin), 0, 128)
            kern = rand_s8(g, (co, taps, taps, cin))
            ws, b = epilogue_operands(g, co)
            args = ((x, rand_s8(g, x.shape, 0, 128), kern, kern) if kind == qconv.K5
                    else (x, kern)) + (ws, b, 0.01, 3.0)
            ms = cuda_ms(lambda: kernel_fn(*args), iters=10, warmup=2)
            bound, by = conv_bound_ms(kind, SERVE_BATCH, hw, cin, co)
            shape_ms[kind, (hw, cin, co)] = (ms, bound)
            extra = ""
            if (kind, (hw, cin, co)) in DP4A_MS:
                extra = f"; CUDA-core (dp4a) kernel {DP4A_MS[kind, (hw, cin, co)]:.4f} ms"
            if kind == qconv.K4A:
                extra += f"; cuDNN bf16 conv {cudnn_bf16_ms(g, hw, cin, co):.4f} ms"
            if kind == k6.K6:
                mm = int_mm_ms(x, kern)
                extra += ("; torch._int_mm does not take the product" if mm is None else
                          f"; torch._int_mm of the [px, Cin] x [Cin, 4 Co] product "
                          f"{mm:.4f} ms")
            print(f"  {kind} b{SERVE_BATCH} {hw}^2 {cin}->{co}: {ms:.4f} ms vs bound "
                  f"{bound:.4f} ms ({by}; {100 * bound / ms:.1f}% of bound){extra}",
                  flush=True)
            if best is None or ms > best[0]:
                best = (ms, bound, by, (hw, cin, co), args)
            del x, args
        if kind == qconv.K5:
            for route, launches in route_conv_launches().items():
                ms = sum(shape_ms[k, sh][0] for k, sh in launches)
                bound = sum(shape_ms[k, sh][1] for k, sh in launches)
                before = sum(DP4A_MS[k, sh] for k, sh in launches)
                print(f"  K4a+K5 per {route} batch ({len(launches)} launches, b"
                      f"{SERVE_BATCH}): {ms:.4f} ms vs summed bound {bound:.4f} ms "
                      f"({100 * bound / ms:.1f}% of bound); CUDA-core (dp4a) kernels "
                      f"{before:.4f} ms [{card}]", flush=True)
        if kind == k6.K6:
            ms = sum(shape_ms[kind, sh][0] for sh in shapes)
            bound = sum(shape_ms[kind, sh][1] for sh in shapes)
            before = sum(DP4A_MS[kind, sh] for sh in shapes)
            print(f"  K6 per route batch ({len(shapes)} launches, b{SERVE_BATCH}): "
                  f"{ms:.4f} ms vs summed bound {bound:.4f} ms ({100 * bound / ms:.1f}% "
                  f"of bound); CUDA-core (dp4a) kernel {before:.4f} ms [{card}]", flush=True)
        ms, bound, by, shape, args = best
        plain_ms = cuda_ms(lambda: plain_fn(*args), iters=2, warmup=1)
        rows[kind] = (ms, plain_ms, bound, by)
        print(f"  {kind} heaviest, b{SERVE_BATCH} {shape[0]}^2 {shape[1]}->{shape[2]}: "
              f"{ms:.4f} ms, plain PyTorch (float64 sums) {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}); no single PyTorch call computes it (PyTorch "
              f"has no int8 conv with an s32 sum) [{card}]", flush=True)
        del best, args
    x = rand_s8(g, (SERVE_BATCH, 512, 512, 16), 0, 128)
    wt = 0.2 * torch.randn((16, 3), generator=g, device="cuda")
    ms = cuda_ms(lambda: k2.head_rowcol_max(x, wt, 0.05), iters=20)
    plain_ms = cuda_ms(lambda: k2.head_rowcol_max_reference(x, wt, 0.05), iters=5)
    bound, by = head_bound_ms(*x.shape)
    rows[k2.NAME] = (ms, plain_ms, bound, by)
    print(f"  {k2.NAME} {tuple(x.shape)}: {ms:.4f} ms vs bound {bound:.4f} ms ({by}; "
          f"{100 * bound / ms:.1f}% of bound); plain PyTorch {plain_ms:.4f} ms; no "
          f"single PyTorch call computes it [{card}]", flush=True)
    return rows


# -- phase 12: K7b against its plain version ------------------------------------


def k7b_bound_ms(n, h, p_in, cpk, co2, in_phase):
    """Least time of one K7b launch on the H100 SXM: each input byte read
    once, each output byte written once, against the packed int8 operations
    (6 taps of Cpk channels for each output pair and channel) at the
    tensor-core rate. → (bound_ms, "bytes" or "operations")."""
    p_out = p_in - 1 if in_phase == "A" else p_in + 1
    n_bytes = n * h * p_in * cpk + 6 * cpk * co2 + n * h * p_out * co2 + 8 * co2
    ops = 2 * 6 * n * h * p_out * co2 * cpk
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / INT8_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def k7b_serving_calls(base=16, size=512, n=SERVE_BATCH):
    """The three K7b launches of the w16 "nhwc" trunk at ``size``²:
    → [(label, (n, h, p_in, cpk, co2), in_phase)]."""
    p = size // 2
    return [("enc0 conv2 A->B", (n, size, p + 1, 2 * base, 2 * base), "A"),
            ("dec0 conv1 B->A", (n, size, p, 4 * base, 2 * base), "B"),
            ("dec0 conv2 A->B", (n, size, p + 1, 2 * base, 2 * base), "A")]


def check_k7b(g, label, x, wp, in_phase, *, relu=True, subset=None, need_clips=True,
              misalign=False):
    """One K7b launch held against its plain version on ``subset`` of the
    batch; a B->A output's pad half-pairs must be zero. ``misalign``: the
    input, the weights and the output start 1 byte into their buffers.
    → the output."""
    co2 = wp.shape[0]
    a2, b2 = epilogue_operands(g, co2)
    sub = slice(None) if subset is None else subset
    acc = nhwc.pair_conv_i8(x[sub], wp, in_phase)
    out_scale = spread_scale(acc.to(torch.float32) * a2 + b2)
    del acc
    if misalign:  # the wrapper allocates an aligned output: launch into a view
        x, wp = misaligned(x), misaligned(wp)
        n, h, p_in = x.shape[:3]
        out = misaligned(torch.zeros((n, h, p_in - 1 if in_phase == "A" else p_in + 1,
                                      co2), dtype=torch.int8, device="cuda"))
        got = nhwc._launch_pair(x, wp, a2, b2, out_scale, in_phase, relu, out=out)
        label += " (in and out 1 byte off alignment)"
    else:
        got = nhwc.qconv3x3_pair_requant(x, wp, a2, b2, out_scale, in_phase=in_phase,
                                         relu=relu)
    ref = nhwc.qconv3x3_pair_requant_reference(x[sub], wp, a2, b2, out_scale,
                                               in_phase=in_phase, relu=relu)
    torch.cuda.synchronize()
    check_int8(nhwc.K7B, f"{nhwc.K7B} {label} {in_phase}: {tuple(x.shape)}->{co2}",
               got[sub], ref,
               0 if relu else -127, need_clips)
    if in_phase == "B":
        half = co2 // 2
        if got[:, :, 0, :half].any() or got[:, :, -1, half:].any():
            raise AssertionError(f"{nhwc.K7B} {label}: pad half-pairs not zero")
    return got


def phase_k7b():
    """K7b's cases, then K2 with float32 weights (the W-phase heads). → K2's
    largest difference from its plain version."""
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    # one conv each way, odd P_out (w=24 -> 13 pairs in A, 13 out of B), no
    # ReLU on signed inputs, Cpk and Co2 off the 16-wide tiles
    for (n, h, w, c, co), relu in (((2, 32, 24, 16, 8), True), ((1, 24, 16, 8, 8), True),
                                   ((1, 9, 8, 4, 8), True), ((2, 16, 40, 6, 10), False),
                                   ((2, 13, 68, 16, 16), True)):
        x = rand_s8(g, (n, h, w, c), 0 if relu else -127, 127)
        wp = nhwc.pack_w_pair(rand_s8(g, (co, 3, 3, c)))
        check_k7b(g, "pack_w_pair", nhwc.to_phase_a(x), wp, "A", relu=relu)
        check_k7b(g, "pack_w_pair", x.view(n, h, w // 2, 2 * c), wp, "B", relu=relu)
    # the chain A->B->A: the second launch reads the first's output as it lies
    x = rand_s8(g, (1, 16, 16, 8), 0, 127)
    wp1, wp2 = (nhwc.pack_w_pair(rand_s8(g, (8, 3, 3, 8))) for _ in range(2))
    t1 = check_k7b(g, "chain step 1", nhwc.to_phase_a(x), wp1, "A")
    check_k7b(g, "chain step 2", t1, wp2, "B")
    # two packed sources, the decoder's conv1
    up, skip = rand_s8(g, (2, 16, 24, 8)), rand_s8(g, (2, 16, 24, 8), 0, 127)
    tcat = torch.cat([up.view(2, 16, 12, 16), skip.view(2, 16, 12, 16)], -1).contiguous()
    wp = nhwc.pack_w_pair_multi([rand_s8(g, (8, 3, 3, 8)), rand_s8(g, (8, 3, 3, 8))])
    check_k7b(g, "two sources", tcat, wp, "B")
    # packed weights pack_w_pair could not produce
    for in_phase, p in (("A", 7), ("B", 6)):
        check_k7b(g, "random wp", rand_s8(g, (2, 16, p, 12)), rand_s8(g, (10, 3, 2, 12)),
                  in_phase, relu=False)
    # the tensor-core contract, in both phases: every k layout (six taps a k
    # step at Cpk <= 4, two at Cpk <= 16, 32-channel steps) and its edges, the
    # Cpk chunk carry, Co2 off the block's tile and past one block, the
    # narrowest inputs (P = 3 in phase A, P = 2 in phase B) and H = 1, inputs,
    # weights and outputs 1 byte off alignment
    for in_phase, p in (("A", 7), ("B", 6)):
        for cpk in (1, 2, 4, 17, 31, 33, 64, 129):
            check_k7b(g, "Cpk edge", rand_s8(g, (2, 5, p, cpk)),
                      rand_s8(g, (16, 3, 2, cpk)), in_phase, relu=cpk % 2 == 0)
        check_k7b(g, "Cpk 1024", rand_s8(g, (1, 4, p + 2, 1024)),
                  rand_s8(g, (24, 3, 2, 1024)), in_phase)
        for cpk, co2 in ((5, 2), (16, 8), (33, 40), (64, 72), (129, 256)):
            check_k7b(g, "Co2 edge", rand_s8(g, (1, 6, p + 4, cpk)),
                      rand_s8(g, (co2, 3, 2, cpk)), in_phase, need_clips=co2 > 2)
        for cpk, co2 in ((3, 16), (16, 16), (17, 32), (64, 48)):
            check_k7b(g, "misaligned", rand_s8(g, (2, 5, p, cpk)),
                      rand_s8(g, (co2, 3, 2, cpk)), in_phase, misalign=True)
        check_k7b(g, "narrowest, H = 1", rand_s8(g, (2, 1, 3 if in_phase == "A" else 2, 32)),
                  rand_s8(g, (16, 3, 2, 32)), in_phase, need_clips=False)
        check_k7b(g, "H off the tile", rand_s8(g, (2, 37, 2 * 33 + (in_phase == "A"), 32)),
                  rand_s8(g, (64, 3, 2, 32)), in_phase, relu=False)
    # the three serving calls of the w16 "nhwc" trunk at b128, held on images
    # 0 and 127
    sub = torch.tensor([0, SERVE_BATCH - 1], device="cuda")
    for label, (n, h, p, cpk, co2), in_phase in k7b_serving_calls():
        x = rand_s8(g, (n, h, p, cpk), 0, 128)
        if in_phase == "A":
            x[:, :, 0, : cpk // 2] = 0  # the baked-in W pad of a phase-A input
            x[:, :, -1, cpk // 2:] = 0
        check_k7b(g, f"w16 {label}", x, rand_s8(g, (co2, 3, 2, cpk)), in_phase, subset=sub)
        del x
    err = 0.0
    for shape in ((3, 9, 13, 16), (2, 7, 11, 5), (SERVE_BATCH, 512, 512, 16)):
        x = rand_s8(g, shape, 0, 128)
        wt = 0.2 * torch.randn((shape[-1], 3), generator=g, device="cuda")
        err = max(err, check_k2("random", x, wt, 0.037, torch.float32))
    return err


# -- phases 13-14: the W-phase routes ------------------------------------------


WPACK_ROUTE_KERNELS = {  # kernels each route launches, per segment_batch call
    "full": {qconv.K4A: 18, k6.K6: 4, k2.NAME: 1},
    "enc": {qconv.K4A: 18, k6.K6: 4, k2.NAME: 1},
    "nhwc": {qconv.K4A: 15, nhwc.K7B: 3, k6.K6: 4, k2.NAME: 1},
}


def fingerprints(hp, c):
    """Final int8 activations of ``c`` channels (any packing) → (B, c) int64
    channel sums."""
    b, h = hp.shape[:2]
    return hp.reshape(b, h, -1, c).to(torch.int64).sum(dim=(1, 2)).cpu().numpy()


def phase_wpack_routes(fix, fix8, fixw):
    from twinvoice_tpu_torch.infer import wpack

    scales = quant.scales_from_array(fix8["scales"])
    calib = fix8["calib"]
    rgb = np.repeat(calib[..., None], 3, axis=-1)
    u8 = torch.as_tensor(rgb, device="cuda")
    h, w = fix["pages"].shape[1:]
    sizes = np.tile(np.asarray([[w, h]], np.int32), (len(calib), 1))
    tol_px = -(-max(h, w) // calib.shape[1]) + 1
    thr = probability_to_logit_thresholds((0.25, 0.40, 0.30))
    segs = {}
    for mode in WPACK_ROUTE_KERNELS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # the "nhwc" fallback note
            segs[mode] = load_pretrained_segmenter(torch.float32, variant="w16",
                                                   int8_scales=scales, int8_wpack=mode)
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    for mode, expect in WPACK_ROUTE_KERNELS.items():
        seg = segs[mode]
        (_, boxes, ok), n = counted(mode, expect, 1, lambda: seg.segment_batch(
            rgb, sizes, return_masks=False))
        add(n)
        px = ok_check(mode, ok, boxes, fixw[f"{mode}_ok"], fixw[f"{mode}_boxes"], tol_px)
        q = seg.qparams
        with torch.inference_mode():
            if mode == "nhwc":
                hp, _ = wpack.unet_apply_quantized_features_nhwc(q, u8)
                row, col = wpack.unet_apply_quantized_nhwc_rowcol_max(q, u8)
            else:
                hp, _ = wpack.unet_apply_quantized_features_wpack(q, u8, mode)
                row, col = wpack.unet_apply_quantized_wpack_rowcol_max(q, u8, mode)
        thr_eff = thr - q["out"]["bias"].cpu()
        jrow = torch.as_tensor(fixw[f"{mode}_row_max"], device="cuda")
        jcol = torch.as_tensor(fixw[f"{mode}_col_max"], device="cuda")
        exact = grid_check(mode, *k2.bbox_from_rowcol_max(row, col, thr_eff),
                           *(t.cpu().numpy() for t in k2.bbox_from_rowcol_max(
                               jrow, jcol, thr_eff)))
        if exact[0] != exact[1]:
            raise AssertionError(f"{mode}: grid boxes {exact[0]}/{exact[1]} equal JAX's")
        # the bound of tests/unit/test_wpack.py; K2 sums the 1x1 head in
        # channel order, XLA in its own
        if not (torch.allclose(row, jrow, rtol=1e-5, atol=1e-5)
                and torch.allclose(col, jcol, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"{mode}: row/col maxima off JAX's beyond rtol 1e-5, "
                                 f"atol 1e-5")
        d = max(float((row - jrow).abs().max()), float((col - jcol).abs().max()))
        fp = fingerprints(hp, q["out"]["weight"].shape[0])
        if not np.array_equal(fp, fixw[f"{mode}_fingerprint"]):
            raise AssertionError(f"{mode}: trunk channel sums {fp.tolist()} != JAX's "
                                 f"{fixw[f'{mode}_fingerprint'].tolist()}")
        print(f"  {mode} (box-only) vs JAX: ok equal; grid boxes exactly equal "
              f"{exact[0]}/{exact[1]}; pixel boxes exactly equal {px[0]}/{px[1]}; "
              f"maxima within rtol 1e-5, atol 1e-5 (max |d| {d:.3g}); trunk channel "
              f"sums equal JAX's on all {len(fp)} pages; launches {n}", flush=True)

    seg = segs["nhwc"]
    expect = {qconv.K4A: 18, k6.K6: 4, k1.NAME: 1}
    (mask, boxes, ok), n = counted("nhwc (masks)", expect, 1,
                                   lambda: seg.segment_batch(rgb, sizes))
    add(n)
    px = ok_check("nhwc (masks)", ok, boxes, fixw["nhwc_masks_ok"],
                  fixw["nhwc_masks_boxes"], tol_px)
    # JAX's "full" logits are the concat graph's bits (tests/unit/test_wpack.py),
    # so its mask grid boxes are those of the int8 fixture's xla route
    exact = grid_check("nhwc (masks)", *grid_boxes(mask), fix8["xla_grid_boxes"],
                       fix8["xla_grid_valid"])
    print(f"  nhwc with masks (the full fallback) vs JAX: ok equal; grid boxes exactly "
          f"equal {exact[0]}/{exact[1]}, max |d| {exact[2]} cell; pixel boxes exactly "
          f"equal {px[0]}/{px[1]}; launches {n}", flush=True)
    return segs, launches


def phase_wpack_serving(segs, fix, card):
    imgs = serving_batch(fix, 512)
    h, w = fix["pages"].shape[1:]
    sizes = np.tile(np.asarray([[w, h]], np.int32), (SERVE_BATCH, 1))
    launches, rates = {}, {}
    for mode, expect in WPACK_ROUTE_KERNELS.items():
        seg = segs[mode]

        def serve():
            for _ in range(3):
                seg.segment_batch(imgs, sizes, return_masks=False)[1].cpu()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(SERVE_ITERS):
                _, boxes, ok = seg.segment_batch(imgs, sizes, return_masks=False)
                host = boxes.cpu().numpy()
            return time.perf_counter() - t, host, ok.cpu().numpy()

        (dt, host, ok), n = counted(mode, expect, 3 + SERVE_ITERS, serve)
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        if not ok.all() or host.shape != (SERVE_BATCH, 3, 4):
            raise AssertionError(f"{mode} b{SERVE_BATCH}: {int(ok.sum())}/{ok.size} ok")
        rates[mode] = SERVE_BATCH * SERVE_ITERS / dt
        print(f"  b{SERVE_BATCH} 512^2 int8_wpack={mode!r} box-only, boxes to host each "
              f"batch: {rates[mode]:.1f} img/s ({1e3 * dt / SERVE_ITERS:.2f} ms/batch); "
              f"launches per batch {expect} [{card}]", flush=True)

    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    worst, total = None, [0.0, 0.0, 0.0]
    for label, (n, hh, p, cpk, co2), in_phase in k7b_serving_calls():
        x = rand_s8(g, (n, hh, p, cpk), 0, 128)
        args = (x, rand_s8(g, (co2, 3, 2, cpk))) + epilogue_operands(g, co2) + (3.0,)
        ms = cuda_ms(lambda: nhwc.qconv3x3_pair_requant(*args, in_phase=in_phase),
                     iters=10, warmup=2)
        bound, by = k7b_bound_ms(n, hh, p, cpk, co2, in_phase)
        before = DP4A_MS[nhwc.K7B, label]
        for i, v in enumerate((ms, bound, before)):
            total[i] += v
        print(f"  {nhwc.K7B} {label} b{n} {(hh, p, cpk)}->{co2}: {ms:.4f} ms vs bound "
              f"{bound:.4f} ms ({by}; {100 * bound / ms:.1f}% of bound); CUDA-core "
              f"(dp4a) kernel {before:.4f} ms [{card}]", flush=True)
        if worst is None or ms > worst[0]:
            worst = (ms, bound, by, label, args, in_phase)
        del x, args
    ms, bound, before = total
    print(f"  K7b per nhwc batch (3 launches, b{SERVE_BATCH}): {ms:.4f} ms vs summed bound "
          f"{bound:.4f} ms ({100 * bound / ms:.1f}% of bound); CUDA-core (dp4a) kernel "
          f"{before:.4f} ms [{card}]", flush=True)
    ms, bound, by, label, args, in_phase = worst
    plain_ms = cuda_ms(lambda: nhwc.qconv3x3_pair_requant_reference(
        *args, in_phase=in_phase), iters=2, warmup=1)
    print(f"  {nhwc.K7B} heaviest, {label}: {ms:.4f} ms, plain PyTorch (float64 sums) "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); no single PyTorch call "
          f"computes it (PyTorch has no int8 conv with an s32 sum) [{card}]", flush=True)
    return launches, rates, (ms, plain_ms, bound, by)


# -- phases 15-16: K3a, K3b, K4b and K7a, the ops/ entry points ------------------


DMA_KERNELS = {  # name → (source, the JAX function it replaces)
    nhwc.K3B: ("qconv3x3_nhwc_requant.cu", "ops/nhwc_conv.py:168"),
    nhwc.K3A: ("qconv3x3_nhwc_dma.cu", "ops/nhwc_conv.py:52"),
    qconv.K4B: ("qconv3x3_requant_dma.cu", "ops/qconv_pallas.py:324"),
    nhwc.K7A: ("qconv3x3_pair_dma.cu", "ops/nhwc_conv.py:299"),
}
NHWC_CALLS = {  # K3b, K3a, K4b: (kernel, plain version, takes the padded input)
    nhwc.K3B: (nhwc.qconv3x3_nhwc_requant, nhwc.qconv3x3_nhwc_requant_reference, True),
    nhwc.K3A: (nhwc.qconv3x3_nhwc_dma, nhwc.qconv3x3_nhwc_dma_reference, True),
    qconv.K4B: (qconv.qconv3x3_requant_dma, qconv.qconv3x3_requant_dma_reference, False),
}
FLAGSHIP = (SERVE_BATCH, 512, 64, 64)  # the reference's flagship conv: n, side, cin, co
# Each kernel's time on its first design, before its redesign on TMA and
# wgmma, at the flagship shape (K7a on it packed to phase A), b128: this
# script's phase 16 in the last run of a tree that had that design, on an
# NVIDIA H100 80GB HBM3 at 700.00 W. K3a, K7a and K3b multiplied with dp4a on
# the CUDA cores; K4b with mma.sync behind a two-slot cp.async ring.
DMA_DP4A_MS = {nhwc.K3A: 46.8506, nhwc.K7A: 63.6082, nhwc.K3B: 42.5731}
DMA_MMA_SYNC_MS = {qconv.K4B: 5.8640}


def first_design(kind):
    """``kind``'s time on its first design, as printed beside its own."""
    if kind in DMA_MMA_SYNC_MS:
        return f"mma.sync kernel {DMA_MMA_SYNC_MS[kind]:.4f} ms (before the TMA design)"
    return f"dp4a kernel {DMA_DP4A_MS[kind]:.4f} ms (before the TMA design)"


def padded_conv_bound_ms(n, hw, cin, co, rows_read):
    """K3a's and K3b's least time on the H100 SXM: ``rows_read`` rows of the
    padded input (hw + 2 for K3a; hw for K3b, which skips the two H-pad rows)
    read once, the output written once, against the int8 operations at the
    tensor-core rate. → (bound_ms, "bytes" or "operations")."""
    n_bytes = n * rows_read * (hw + 2) * cin + 9 * cin * co + n * hw * hw * co + 8 * co
    ops = 2 * 9 * n * hw * hw * cin * co
    bytes_ms, ops_ms = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * ops / INT8_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def dma_bound_ms(kind, n, hw, cin, co):
    if kind == qconv.K4B:
        return conv_bound_ms(qconv.K4A, n, hw, cin, co)
    if kind == nhwc.K7A:
        return k7b_bound_ms(n, hw, hw // 2 + 1, 2 * cin, 2 * co, "A")
    return padded_conv_bound_ms(n, hw, cin, co, hw if kind == nhwc.K3B else hw + 2)


def nhwc_case(g, kind, label, n, h, w, cin, co, *, relu=True, live_pad=False,
              subset=None, need_clips=True, x=None):
    """K3b, K3a or K4b on a random (or the given) NHWC input, held against its
    plain version on ``subset`` of the batch and, with zero pads, against K4a
    (with ``s_in·w_scale`` equal to its ``a``) on the whole batch."""
    fn, plain, padded = NHWC_CALLS[kind]
    if x is None:
        x = rand_s8(g, (n, h, w, cin), 0 if relu else -127, 128)
    kern = rand_s8(g, (co, 3, 3, cin))
    ws, b = epilogue_operands(g, co)
    s_in = 0.5 + float(torch.rand((), generator=g, device="cuda"))
    a = torch.tensor(np.float32(s_in), device="cuda") * ws
    xin = nhwc.pad_nhwc(x) if padded else x
    if live_pad:  # pad rows and columns that are not zero
        xin[:, 0], xin[:, -1] = rand_s8(g, xin[:, 0].shape), rand_s8(g, xin[:, -1].shape)
        xin[:, :, 0], xin[:, :, -1] = rand_s8(g, xin[:, :, 0].shape), rand_s8(
            g, xin[:, :, -1].shape)
    sub = slice(None) if subset is None else subset
    acc = qconv.conv3x3_i8(x[sub], kern)
    out_scale = spread_scale(acc.to(torch.float32) * a + b)
    del acc
    got = fn(xin, kern, a, b, out_scale, relu=relu)
    ref = plain(xin[sub], kern, a, b, out_scale, relu=relu)
    torch.cuda.synchronize()
    check_int8(kind, f"{kind} {label} {tuple(xin.shape)}->{co}", got[sub], ref,
               0 if relu else -127, need_clips)
    if not live_pad:
        sib = qconv.qconv3x3_requant(x, kern, ws, b, s_in, out_scale, relu=relu)
        check_same(kind, f"{kind} {label}", got, sib, "K4a")
    return got


def k7a_case(g, label, x, wp, in_phase, *, relu=True, subset=None, need_clips=True):
    """K7a held against its plain version on ``subset`` of the batch and
    against K7b on the whole batch; a B->A output's pad half-pairs must be
    zero. → the output."""
    co2 = wp.shape[0]
    a2, b2 = epilogue_operands(g, co2)
    sub = slice(None) if subset is None else subset
    acc = nhwc.pair_conv_i8(x[sub], wp, in_phase)
    out_scale = spread_scale(acc.to(torch.float32) * a2 + b2)
    del acc
    got = nhwc.qconv3x3_pair_dma(x, wp, a2, b2, out_scale, in_phase=in_phase, relu=relu)
    ref = nhwc.qconv3x3_pair_requant_reference(x[sub], wp, a2, b2, out_scale,
                                               in_phase=in_phase, relu=relu)
    torch.cuda.synchronize()
    check_int8(nhwc.K7A, f"{nhwc.K7A} {label} {in_phase}: {tuple(x.shape)}->{co2}",
               got[sub], ref,
               0 if relu else -127, need_clips)
    sib = nhwc.qconv3x3_pair_requant(x, wp, a2, b2, out_scale, in_phase=in_phase,
                                     relu=relu)
    check_same(nhwc.K7A, f"{nhwc.K7A} {label}", got, sib, "K7b")
    if in_phase == "B":
        half = co2 // 2
        if got[:, :, 0, :half].any() or got[:, :, -1, half:].any():
            raise AssertionError(f"{nhwc.K7A} {label}: pad half-pairs not zero")
    return got


def dma_contract_case(g, kind, label, x, wts, *, in_phase=None, relu=True, misalign=False,
                      need_clips=True):
    """K3a or K3b (``x`` a padded (N,H+2,W+2,C) input, random pad rows and
    columns included; ``wts`` (Co,3,3,C)), K4b (``x`` an unpadded (N,H,W,C)
    input) or K7a (``x`` a pair tensor in ``in_phase``; ``wts``
    (Co2,3,2,Cpk)) held against its plain version on the whole batch; K3b
    also against K3a on the same input, from which it must differ on the
    first and last output rows (the live pad rows it must not read) and
    nowhere else. ``misalign``: the input, the weights and the output start
    1 byte into their buffers (no tensor map: the producer copies, the tile
    leaves by bytes). → the output."""
    co = wts.shape[0]
    a, b = epilogue_operands(g, co)
    extra = {}
    if kind == nhwc.K7A:
        acc = nhwc.pair_conv_i8(x, wts, in_phase)
        fn, plain = nhwc.qconv3x3_pair_dma, nhwc.qconv3x3_pair_requant_reference
        extra = {"in_phase": in_phase}
    elif kind == qconv.K4B:
        acc = qconv.conv3x3_i8(x, wts)
        fn, plain, _ = NHWC_CALLS[kind]
    else:
        acc = nhwc.nhwc_conv_i8(x, wts, drop_h_pad=kind == nhwc.K3B)
        fn, plain, _ = NHWC_CALLS[kind]
    out_scale = spread_scale(acc.to(torch.float32) * a + b)
    if misalign:  # the wrapper allocates an aligned output: launch into a view
        x, wts = misaligned(x), misaligned(wts)
        out = misaligned(torch.zeros(acc.shape, dtype=torch.int8, device="cuda"))
        got = nhwc._launch_dma(kind, x, wts, a, b, out_scale, relu, out, in_phase=in_phase)
        label += " (in, weights and out 1 byte off alignment)"
    else:
        got = fn(x, wts, a, b, out_scale, relu=relu, **extra)
    del acc
    ref = plain(x, wts, a, b, out_scale, relu=relu, **extra)
    torch.cuda.synchronize()
    phase = f" {in_phase}" if in_phase else ""
    check_int8(kind, f"{kind} {label}{phase}: {tuple(x.shape)}->{co}", got, ref,
               0 if relu else -127, need_clips)
    if in_phase == "B":
        half = co // 2
        if got[:, :, 0, :half].any() or got[:, :, -1, half:].any():
            raise AssertionError(f"{kind} {label}: pad half-pairs not zero")
    if kind == nhwc.K3B:
        k3a = nhwc.qconv3x3_nhwc_dma(x, wts, a, b, out_scale, relu=relu)
        rows = (got != k3a).any(dim=3).any(dim=2).any(dim=0).tolist()
        if not (rows[0] and rows[-1]) or any(rows[1:-1]):
            raise AssertionError(f"{kind} {label}: rows where K3b and K3a differ on live "
                                 f"H-pad rows {rows}; expected the first and last only")
    return got


def phase_dma_contract(g):
    """The contract of the TMA-fed tensor-core kernel, for K3a, K7a, K3b and
    K4b: C and Cpk over the 16-channel chunk (half a k step), the 32- to
    128-channel chunks and the streamed weights (1024; K4b takes Cin <= 128);
    Co and Co2 off and past the 32-, 64- and 128-channel blocks; inputs,
    weights and outputs 1 byte off alignment; H = 1, H off the tile, odd W;
    every K3a and K3b case with live H-pad rows; K7a in both phases, P = 3 (A)
    and P = 2 (B), the pad half-pairs of a B->A output."""
    k3a, k7a = nhwc.K3A, nhwc.K7A
    for c in (1, 2, 4, 17, 31, 33, 64, 129):
        dma_contract_case(g, k3a, "C edge", rand_s8(g, (2, 7, 39, c)),
                          rand_s8(g, (16, 3, 3, c)), relu=c % 2 == 0)
    dma_contract_case(g, k3a, "C 1024", rand_s8(g, (1, 5, 23, 1024)),
                      rand_s8(g, (24, 3, 3, 1024)))
    for c, co in ((5, 2), (16, 8), (33, 40), (64, 72), (129, 256)):
        dma_contract_case(g, k3a, "Co edge", rand_s8(g, (1, 8, 43, c)),
                          rand_s8(g, (co, 3, 3, c)), need_clips=co > 2)
    for c, co in ((3, 16), (16, 16), (17, 32), (64, 48), (64, 64)):
        dma_contract_case(g, k3a, "misaligned", rand_s8(g, (2, 7, 39, c)),
                          rand_s8(g, (co, 3, 3, c)), misalign=True)
    dma_contract_case(g, k3a, "H = 1", rand_s8(g, (2, 3, 35, 32)),
                      rand_s8(g, (16, 3, 3, 32)), need_clips=False)
    dma_contract_case(g, k3a, "H off the tile, odd W", rand_s8(g, (2, 39, 69, 32)),
                      rand_s8(g, (64, 3, 3, 32)), relu=False)
    for in_phase, p in (("A", 7), ("B", 6)):
        for cpk in (1, 2, 4, 17, 31, 33, 64, 129):
            dma_contract_case(g, k7a, "Cpk edge", rand_s8(g, (2, 5, p, cpk)),
                              rand_s8(g, (16, 3, 2, cpk)), in_phase=in_phase,
                              relu=cpk % 2 == 0)
        dma_contract_case(g, k7a, "Cpk 1024", rand_s8(g, (1, 4, p + 2, 1024)),
                          rand_s8(g, (24, 3, 2, 1024)), in_phase=in_phase)
        for cpk, co2 in ((5, 2), (16, 8), (33, 40), (64, 72), (129, 256)):
            dma_contract_case(g, k7a, "Co2 edge", rand_s8(g, (1, 6, p + 4, cpk)),
                              rand_s8(g, (co2, 3, 2, cpk)), in_phase=in_phase,
                              need_clips=co2 > 2)
        for cpk, co2 in ((3, 16), (16, 16), (17, 32), (64, 48), (64, 64)):
            dma_contract_case(g, k7a, "misaligned", rand_s8(g, (2, 5, p, cpk)),
                              rand_s8(g, (co2, 3, 2, cpk)), in_phase=in_phase, misalign=True)
        dma_contract_case(g, k7a, "narrowest, H = 1",
                          rand_s8(g, (2, 1, 3 if in_phase == "A" else 2, 32)),
                          rand_s8(g, (16, 3, 2, 32)), in_phase=in_phase, need_clips=False)
        dma_contract_case(g, k7a, "H off the tile",
                          rand_s8(g, (2, 37, 2 * 33 + (in_phase == "A"), 32)),
                          rand_s8(g, (64, 3, 2, 32)), in_phase=in_phase, relu=False)
    # K3b (its padded input's pad rows and columns random) and K4b, which
    # takes Cin <= 128: the same edges at the same output shapes
    for kind in (nhwc.K3B, qconv.K4B):
        pad = 2 if kind == nhwc.K3B else 0
        top = 129 if pad else 128
        for c in (1, 2, 4, 17, 31, 33, 64, top):
            dma_contract_case(g, kind, "C edge", rand_s8(g, (2, 5 + pad, 37 + pad, c)),
                              rand_s8(g, (16, 3, 3, c)), relu=c % 2 == 0)
        if pad:
            dma_contract_case(g, kind, "C 1024", rand_s8(g, (1, 5, 23, 1024)),
                              rand_s8(g, (24, 3, 3, 1024)))
        for c, co in ((5, 2), (16, 8), (33, 40), (64, 72), (top, 256)):
            dma_contract_case(g, kind, "Co edge", rand_s8(g, (1, 6 + pad, 41 + pad, c)),
                              rand_s8(g, (co, 3, 3, c)), need_clips=co > 2)
        for c, co in ((3, 16), (16, 16), (17, 32), (64, 48), (64, 64)):
            dma_contract_case(g, kind, "misaligned", rand_s8(g, (2, 5 + pad, 37 + pad, c)),
                              rand_s8(g, (co, 3, 3, c)), misalign=True)
        dma_contract_case(g, kind, "H = 1", rand_s8(g, (2, 1 + pad, 33 + pad, 32)),
                          rand_s8(g, (16, 3, 3, 32)), need_clips=False)
        dma_contract_case(g, kind, "H off the tile, odd W",
                          rand_s8(g, (2, 37 + pad, 67 + pad, 32)),
                          rand_s8(g, (64, 3, 3, 32)), relu=False)


def tma_count(kind):
    """The launches of ``kind`` (K3a, K3b, K4b, K7a) whose slabs came by TMA
    so far."""
    return _build.launches[f"{kind}:tma"]


def w64_enc0(fix8):
    """The bundled w64 model (``segmenter_synth_w64.npz``, base width 64),
    quantised with the port's calibration on the fixture pages: → (enc0
    conv1's int8 output on those pages, enc0 conv2's qparams, its input
    scale, its output scale)."""
    from twinvoice_tpu_torch.config import UNetConfig
    from twinvoice_tpu_torch.models.pretrained import variant_path
    from twinvoice_tpu_torch.models.unet import fold_unet
    from twinvoice_tpu_torch.weights import load_npz

    rgb = np.repeat(fix8["calib"][..., None], 3, axis=-1)
    params, state = load_npz(variant_path("w64"))
    folded = fold_unet(params, state, cfg=UNetConfig(base_width=64), dtype=torch.float32,
                       device="cuda")
    q = quant.quantize_unet(folded, [rgb])
    del folded
    e0 = q["enc"][0]
    x = (torch.as_tensor(rgb, device="cuda") >> 1).to(torch.int8).contiguous()
    with torch.inference_mode():
        h1 = qconv.qconv3x3_requant(x, e0["conv1"]["kernel"], e0["conv1"]["w_scale"],
                                    e0["conv1"]["bias"], np.float32(quant.INPUT_SCALE),
                                    e0["s1"])
    return h1, e0["conv2"], quant.act_scale(e0["s1"]), e0["s2"]


def phase_dma_kernels(fix8):
    """Phase 15: K3b, K3a, K4b and K7a against their plain versions and their
    siblings; then the slice's path, each entry point once at the flagship
    layer of the bundled w64 model, with the launch counts zeroed just before
    and read just after. → those counts."""
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    # odd W, H not a multiple of 8, Cin 3, 16, 64, 128, ReLU and none, clips
    # at both ends; Co off the 16-wide tile at Cin 64
    for kind in NHWC_CALLS:
        for cin in (3, 16, 64, 128):
            for relu in (True, False):
                nhwc_case(g, kind, f"random relu={relu}", 2, 13, 37, cin,
                          24 if cin == 64 else 16, relu=relu)
    for kind in (nhwc.K3B, nhwc.K3A):
        for relu in (True, False):
            nhwc_case(g, kind, f"live pad rows relu={relu}", 2, 11, 21, 16, 16, relu=relu,
                      live_pad=True)
    nhwc_case(g, qconv.K4B, "Co=5", 1, 9, 33, 12, 5, relu=False)
    # K7a: A->B and B->A, odd pair counts, no ReLU, H not a multiple of 8, the
    # chain A->B->A, two packed sources, random packed weights
    for (n, h, w, c, co), relu in (((2, 32, 24, 16, 8), True), ((1, 13, 16, 8, 8), True),
                                   ((1, 9, 8, 4, 8), True), ((2, 16, 40, 6, 10), False),
                                   ((2, 13, 68, 64, 64), True)):
        x = rand_s8(g, (n, h, w, c), 0 if relu else -127, 127)
        wp = nhwc.pack_w_pair(rand_s8(g, (co, 3, 3, c)))
        k7a_case(g, "pack_w_pair", nhwc.to_phase_a(x), wp, "A", relu=relu)
        k7a_case(g, "pack_w_pair", x.view(n, h, w // 2, 2 * c), wp, "B", relu=relu)
    x = rand_s8(g, (1, 16, 16, 8), 0, 127)
    wp1, wp2 = (nhwc.pack_w_pair(rand_s8(g, (8, 3, 3, 8))) for _ in range(2))
    t1 = k7a_case(g, "chain step 1", nhwc.to_phase_a(x), wp1, "A")
    k7a_case(g, "chain step 2", t1, wp2, "B")
    up, skip = rand_s8(g, (2, 16, 24, 8)), rand_s8(g, (2, 16, 24, 8), 0, 127)
    tcat = torch.cat([up.view(2, 16, 12, 16), skip.view(2, 16, 12, 16)], -1).contiguous()
    wp = nhwc.pack_w_pair_multi([rand_s8(g, (8, 3, 3, 8)), rand_s8(g, (8, 3, 3, 8))])
    k7a_case(g, "two sources", tcat, wp, "B")
    for in_phase, p in (("A", 7), ("B", 6)):
        k7a_case(g, "random wp", rand_s8(g, (2, 16, p, 12)), rand_s8(g, (10, 3, 2, 12)),
                 in_phase, relu=False)
    phase_dma_contract(g)

    # every w64 trunk layer shape each contract admits at b128: K3b and K3a
    # at every conv (the decoder conv1 on its concatenated halves), K4b where
    # Cin <= 128, K7a at the three calls of the "nhwc" trunk; held against
    # the plain versions on images 0 and 127 and the siblings on all 128
    # (each must load its slabs by TMA wherever C or Cpk is a multiple of 16:
    # every shape but enc0 conv1, Cin 3)
    sub = torch.tensor([0, SERVE_BATCH - 1], device="cuda")
    shapes = trunk_shapes(base=64)[qconv.K4A]
    by_tma = {kind: [] for kind in (*NHWC_CALLS, nhwc.K7A)}
    for hw, cin, co in shapes:
        x = rand_s8(g, (SERVE_BATCH, hw, hw, cin), 0, 128)
        for kind in NHWC_CALLS:
            if kind == qconv.K4B and cin > qconv.K4B_MAX_CIN:
                continue
            before = tma_count(kind)
            nhwc_case(g, kind, f"w64 trunk {hw}^2", SERVE_BATCH, hw, hw, cin, co, x=x,
                      subset=sub)
            by_tma[kind].append((cin, tma_count(kind) - before))
        del x
    for label, (n, h, p, cpk, co2), in_phase in k7b_serving_calls(base=64):
        x = rand_s8(g, (n, h, p, cpk), 0, 128)
        if in_phase == "A":
            x[:, :, 0, : cpk // 2] = 0  # the baked-in W pad of a phase-A input
            x[:, :, -1, cpk // 2:] = 0
        before = tma_count(nhwc.K7A)
        k7a_case(g, f"w64 {label}", x, rand_s8(g, (co2, 3, 2, cpk)), in_phase, subset=sub)
        by_tma[nhwc.K7A].append((cpk, tma_count(nhwc.K7A) - before))
        del x
    for kind, cases in by_tma.items():
        if any(n_tma != (c % 16 == 0) for c, n_tma in cases):
            raise AssertionError(f"{kind}: TMA loads at the w64 shapes (channels, TMA "
                                 f"launches) {cases}; expected one wherever the channels "
                                 f"are a multiple of 16")
    print("  TMA loads at the w64 shapes: " + "; ".join(
        f"{kind} {sum(n for _, n in cases)} of {len(cases)} (not at C "
        f"{[c for c, n in cases if not n]})" for kind, cases in by_tma.items()), flush=True)
    torch.cuda.empty_cache()

    # the slice's path: the flagship layer of the real w64 model, enc0 conv2
    # (512^2, 64 -> 64) on enc0 conv1's int8 output for the fixture pages
    h1, c2, s, s2 = w64_enc0(fix8)
    a = torch.tensor(np.float32(s), device="cuda") * c2["w_scale"]
    args = (c2["kernel"], a, c2["bias"], s2)
    _build.launches.clear()
    ref = qconv.qconv3x3_requant(h1, c2["kernel"], c2["w_scale"], c2["bias"], s, s2)
    x_pad = nhwc.pad_nhwc(h1)
    outs = {nhwc.K3B: nhwc.qconv3x3_nhwc_requant(x_pad, *args),
            nhwc.K3A: nhwc.qconv3x3_nhwc_dma(x_pad, *args),
            qconv.K4B: qconv.qconv3x3_requant_dma(h1, *args)}
    wp = nhwc.pack_w_pair(c2["kernel"])
    a2, b2 = torch.cat([a, a]), torch.cat([c2["bias"], c2["bias"]])
    xa = nhwc.to_phase_a(h1)
    outs[nhwc.K7A] = nhwc.qconv3x3_pair_dma(xa, wp, a2, b2, s2, in_phase="A")
    k7b = nhwc.qconv3x3_pair_requant(xa, wp, a2, b2, s2, in_phase="A")
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for kind in DMA_KERNELS:
        if launches.get(kind, 0) < 1:
            raise AssertionError(f"{kind} did not launch on the w64 enc0 path: {launches}")
    for kind in DMA_KERNELS:
        if launches.get(f"{kind}:tma", 0) != launches[kind]:
            raise AssertionError(f"{kind} did not load by TMA on the w64 enc0 path: "
                                 f"{launches}")
    for kind, out in outs.items():
        k7 = kind == nhwc.K7A
        check_same(kind, f"w64 enc0 conv2: {kind}", out, k7b if k7 else ref,
                   "K7b" if k7 else "K4a")
    if not torch.equal(nhwc.from_phase_b(k7b), ref):
        raise AssertionError("w64 enc0 conv2: K7b's phase-B output is not K4a's")
    print(f"  w64 enc0 conv2 on the fixture pages {tuple(h1.shape)}->64 (the port's "
          f"calibration): K3b, K3a and K4b equal K4a, K7a equals K7b, and K7b's "
          f"phase-B output is K4a's ({ref.numel()} outputs, {int((ref == 127).sum())} "
          f"at 127, {int((ref == 0).sum())} at 0); launches {launches}", flush=True)
    return launches


def chunked(plain, x, *rest, chunk=16, **kw):
    """The plain version over the batch in chunks of ``chunk`` images (its
    float64 sums of the whole b128 batch would not fit the card)."""
    return [plain(x[i:i + chunk], *rest, **kw) for i in range(0, x.shape[0], chunk)]


def time_dma_kernels(card):
    """Phase 16: each new kernel and its sibling at the flagship shape (b128,
    512^2, 64 -> 64; K7a on it packed to phase A). → {kernel: (ms, plain ms,
    bound ms, bound by, sibling ms)}."""
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    n, hw, cin, co = FLAGSHIP
    x = rand_s8(g, (n, hw, hw, cin), 0, 128)
    kern = rand_s8(g, (co, 3, 3, cin))
    ws, b = epilogue_operands(g, co)
    s_in, out_scale = 0.01, 3.0
    a = torch.tensor(np.float32(s_in), device="cuda") * ws
    x_pad = nhwc.pad_nhwc(x)
    k4a_ms = cuda_ms(lambda: qconv.qconv3x3_requant(x, kern, ws, b, s_in, out_scale),
                     iters=5, warmup=1)
    print(f"  {qconv.K4A} (sibling) b{n} {hw}^2 {cin}->{co}: {k4a_ms:.4f} ms [{card}]",
          flush=True)
    rows = {}
    for kind, (fn, plain, padded) in NHWC_CALLS.items():
        xin = x_pad if padded else x
        ms = cuda_ms(lambda: fn(xin, kern, a, b, out_scale), iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: chunked(plain, xin, kern, a, b, out_scale), iters=1,
                           warmup=1)
        bound, by = dma_bound_ms(kind, n, hw, cin, co)
        rows[kind] = (ms, plain_ms, bound, by, k4a_ms)
        print(f"  {kind} b{n} {hw}^2 {cin}->{co}: {ms:.4f} ms vs bound {bound:.4f} ms "
              f"({by}; {100 * bound / ms:.1f}% of bound); sibling K4a {k4a_ms:.4f} ms; "
              f"{first_design(kind)}; plain PyTorch (float64 sums, 16 images a call) "
              f"{plain_ms:.4f} ms; no single PyTorch call computes it [{card}]", flush=True)
    del x_pad
    xa = nhwc.to_phase_a(x)
    del x
    wp = rand_s8(g, (2 * co, 3, 2, 2 * cin))
    a2, b2 = epilogue_operands(g, 2 * co)
    k7b_ms = cuda_ms(lambda: nhwc.qconv3x3_pair_requant(xa, wp, a2, b2, out_scale),
                     iters=5, warmup=1)
    ms = cuda_ms(lambda: nhwc.qconv3x3_pair_dma(xa, wp, a2, b2, out_scale), iters=5,
                 warmup=1)
    plain_ms = cuda_ms(lambda: chunked(nhwc.qconv3x3_pair_requant_reference, xa, wp, a2,
                                       b2, out_scale), iters=1, warmup=1)
    bound, by = dma_bound_ms(nhwc.K7A, n, hw, cin, co)
    rows[nhwc.K7A] = (ms, plain_ms, bound, by, k7b_ms)
    print(f"  {nhwc.K7A} A->B b{n} {tuple(xa.shape[1:])}->{2 * co}: {ms:.4f} ms vs bound "
          f"{bound:.4f} ms ({by}; {100 * bound / ms:.1f}% of bound); sibling K7b "
          f"{k7b_ms:.4f} ms; {first_design(nhwc.K7A)}; plain PyTorch (float64 sums, 16 "
          f"images a call) {plain_ms:.4f} ms; no single PyTorch call computes it [{card}]",
          flush=True)
    del xa
    time_dma_w64(g, card)
    return rows


TMA_KERNEL = "tma_conv_kernel"        # the names of the kernels K3a, K3b, K4b and K7a
WINDOW_KERNEL = "window_conv_kernel"  # and K4a and K7b launch (csrc/*.cuh)


def time_dma_w64(g, card):
    """K3a and K3b at every w64 trunk layer shape, K4b at every w64 and w16
    trunk layer shape with Cin <= 128, and K7a at the w64 "nhwc" trunk's
    three pair calls, b128, each beside its bound and its sibling (K4a, K7b)
    on the same inputs: the time of a call (CUDA events around back-to-back
    calls) and of its kernel alone (the profiler), which differ where the
    host's work for a call outlasts the kernel."""
    print(f"  K3a, K3b, K4b and K7a at the w64 shapes, K4b at the w16 shapes, "
          f"b{SERVE_BATCH} [{card}]:", flush=True)
    shapes = [(64, s) for s in trunk_shapes(base=64)[qconv.K4A]]
    shapes += [(16, s) for s in trunk_shapes(base=16)[qconv.K4A]
               if s[1] <= qconv.K4B_MAX_CIN]
    for base, (hw, cin, co) in shapes:
        x = rand_s8(g, (SERVE_BATCH, hw, hw, cin), 0, 128)
        kern = rand_s8(g, (co, 3, 3, cin))
        ws, b = epilogue_operands(g, co)
        a = torch.tensor(np.float32(0.01), device="cuda") * ws
        x_pad = nhwc.pad_nhwc(x) if base == 64 else None
        k4a = lambda: qconv.qconv3x3_requant(x, kern, ws, b, 0.01, 3.0)
        sib, sib_kernel = cuda_ms(k4a, iters=3, warmup=1), kernel_ms(k4a, WINDOW_KERNEL)
        for kind, (fn, _, padded) in NHWC_CALLS.items():
            if (base == 16 and kind != qconv.K4B) or (kind == qconv.K4B
                                                      and cin > qconv.K4B_MAX_CIN):
                continue
            xin = x_pad if padded else x
            call = lambda: fn(xin, kern, a, b, 3.0)
            ms, in_kernel = cuda_ms(call, iters=3, warmup=1), kernel_ms(call, TMA_KERNEL)
            bound, by = dma_bound_ms(kind, SERVE_BATCH, hw, cin, co)
            print(f"    {kind} w{base} {hw}^2 {cin}->{co}: {ms:.4f} ms a call, "
                  f"{in_kernel:.4f} ms in its kernel, vs bound {bound:.4f} ms ({by}; "
                  f"{100 * bound / in_kernel:.1f}% of bound in the kernel); sibling K4a "
                  f"{sib:.4f} ms a call, {sib_kernel:.4f} ms in its kernel", flush=True)
        del x, x_pad
    for label, (n, h, p, cpk, co2), in_phase in k7b_serving_calls(base=64):
        x = rand_s8(g, (n, h, p, cpk), 0, 128)
        wp = rand_s8(g, (co2, 3, 2, cpk))
        a2, b2 = epilogue_operands(g, co2)
        ms = cuda_ms(lambda: nhwc.qconv3x3_pair_dma(x, wp, a2, b2, 3.0, in_phase=in_phase),
                     iters=3, warmup=1)
        sib = cuda_ms(lambda: nhwc.qconv3x3_pair_requant(x, wp, a2, b2, 3.0,
                                                         in_phase=in_phase),
                      iters=3, warmup=1)
        bound, by = k7b_bound_ms(n, h, p, cpk, co2, in_phase)
        print(f"    {nhwc.K7A} {label} ({h}, {p}, {cpk} -> {co2}): {ms:.4f} ms vs bound "
              f"{bound:.4f} ms ({by}; {100 * bound / ms:.1f}% of bound); sibling K7b "
              f"{sib:.4f} ms", flush=True)
        del x
    torch.cuda.empty_cache()


# -- phases 17-18: the recognition stack ---------------------------------------


OCR_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_ocr.npz")
OCR_POLICIES = ("greedy", "beam_lm", "cascade")
OCR_METHODS = ("classical", "hybrid")
OCR_NEAR_TIE = 1e-3   # nats: frames whose top-1/top-2 gap is below this may flip
OCR_LP_TOL = 1e-3     # |log-prob − JAX's|, top-8 and blank
OCR_CONF_TOL = 1e-4   # |confidence − JAX's|, rows and read_batch results
OCR_BATCH = 3 * SERVE_BATCH  # lines of a bulk batch: 128 invoices × 3 fields


def ocr_fixture():
    with np.load(OCR_FIXTURE) as z:
        fix = {k: z[k] for k in z.files}
    fix["crop_list"] = []
    for (h, w, c), a, b in zip(fix["crop_shapes"], fix["crop_offsets"][:-1],
                               fix["crop_offsets"][1:]):
        shape = (int(h), int(w)) + ((int(c),) if c else ())
        fix["crop_list"].append(fix["crops"][a:b].reshape(shape))
    return fix


def ocr_rows_compare(fix, run):
    """``run`` (the device half: float32 rows (B, 32, 256) → its five outputs
    as numpy arrays) on JAX's prepared rows against JAX's outputs. → dict:
    ``near`` and ``frames`` (frames whose top-1/top-2 gap is at most
    OCR_NEAR_TIE, and all), ``ids`` (the argmax equal on every other frame),
    ``lp_err`` and ``conf_err`` (max |Δ|, top-8 and blank log-probs;
    confidences), ``topk`` (top-8 ids equal wherever the log-probs stand more
    than 2·OCR_LP_TOL apart)."""
    ids, conf, tk_ids, tk_lp, blank = run(fix["rows_u8"].astype(np.float32) / 255.0)
    gap = fix["row_tk_lp"][..., 0] - fix["row_tk_lp"][..., 1]
    clear = gap > OCR_NEAR_TIE
    d = -np.diff(fix["row_tk_lp"], axis=-1)
    apart = np.ones(tk_ids.shape, bool)
    apart[..., :-1] &= d > 2 * OCR_LP_TOL
    apart[..., 1:] &= d > 2 * OCR_LP_TOL
    return {
        "near": int((~clear).sum()), "frames": int(clear.size),
        "ids": bool(np.array_equal(ids[clear], fix["row_ids"][clear])),
        "bad": np.argwhere(clear & (ids != fix["row_ids"]))[:8].tolist(),
        "lp_err": max(float(np.abs(tk_lp - fix["row_tk_lp"]).max()),
                      float(np.abs(blank - fix["row_blank_lp"]).max())),
        "conf_err": float(np.abs(conf - fix["row_conf"]).max()),
        "topk": bool(np.array_equal(tk_ids[apart], fix["row_tk_ids"][apart])),
    }


def ocr_rows_check(fix, eng):
    """The engine's device half (``eng._infer``) on JAX's prepared rows: ids
    equal to JAX's on every frame whose top-1/top-2 gap is above
    OCR_NEAR_TIE; conf, top-8 log-probs and blank log-probs within their
    tolerances; top-8 ids equal where apart (:func:`ocr_rows_compare`). →
    (near-tie frames, frames, max |Δ log-prob|, max |Δ conf|)."""
    r = ocr_rows_compare(fix, eng._infer)
    if not r["ids"]:
        raise AssertionError(f"device half: argmax differs from JAX's at clear frames "
                             f"(row, frame) {r['bad']}")
    if r["lp_err"] > OCR_LP_TOL or r["conf_err"] > OCR_CONF_TOL:
        raise AssertionError(f"device half: |d log-prob| {r['lp_err']:.3g} (tol "
                             f"{OCR_LP_TOL}), |d conf| {r['conf_err']:.3g} (tol {OCR_CONF_TOL})")
    if not r["topk"]:
        raise AssertionError("device half: top-8 ids differ from JAX's where the "
                             "log-probs stand apart")
    return r["near"], r["frames"], r["lp_err"], r["conf_err"]


def ocr_crops_check(fix, eng):
    """read_batch on the fixture crops with their modes under each decode
    policy: texts equal to JAX's, confidences within OCR_CONF_TOL. → max
    |Δ conf|."""
    crops, modes = fix["crop_list"], [str(m) for m in fix["crop_modes"]]
    err = 0.0
    for policy in OCR_POLICIES:
        eng.decode = policy
        res = eng.read_batch(crops, modes=modes)
        texts = [r.text for r in res]
        want = [str(t) for t in fix[f"text_{policy}"]]
        if texts != want:
            diff = [(i, modes[i], t, w) for i, (t, w) in enumerate(zip(texts, want)) if t != w]
            raise AssertionError(f"read_batch {policy}: texts differ from JAX's at {diff}")
        conf = np.asarray([np.nan if r.confidence is None else r.confidence for r in res])
        ref = fix[f"conf_{policy}"]
        if not np.array_equal(np.isnan(conf), np.isnan(ref)):
            raise AssertionError(f"read_batch {policy}: confidences set where JAX's are not")
        e = float(np.nanmax(np.abs(conf - ref), initial=0.0))
        if e > OCR_CONF_TOL:
            raise AssertionError(f"read_batch {policy}: |d conf| {e:.3g} > {OCR_CONF_TOL}")
        err = max(err, e)
    eng.decode = "cascade"
    return err


def _split(flat, counts):
    out, k = [], 0
    for n in counts:
        out.append(flat[k:k + n])
        k += n
    return out


def ocr_pages_check(pages, fix, eng):
    """detect_lines (classical, hybrid) boxes and read_page boxes and texts on
    the four pages equal to JAX's. → {method: boxes}, read_page lines."""
    from twinvoice_tpu_torch.ocr.torchocr.detector import detect_lines, read_page

    counts = {}
    for method in OCR_METHODS:
        want = _split(fix[f"boxes_{method}"], fix[f"nboxes_{method}"])
        for i, page in enumerate(pages):
            got = detect_lines(page, method=method, device=eng.device)
            if got != [tuple(int(v) for v in b) for b in want[i]]:
                raise AssertionError(f"detect_lines {method} page {i}: {got} != JAX's "
                                     f"{want[i].tolist()}")
        counts[method] = int(fix[f"nboxes_{method}"].sum())
    boxes = _split(fix["page_boxes"], fix["page_counts"])
    texts = _split(fix["page_texts"], fix["page_counts"])
    confs = _split(fix["page_confs"], fix["page_counts"])
    for i, page in enumerate(pages):
        got = read_page(page, eng)
        if [b for b, _ in got] != [tuple(int(v) for v in b) for b in boxes[i]]:
            raise AssertionError(f"read_page page {i}: boxes differ from JAX's")
        if [r.text for _, r in got] != [str(t) for t in texts[i]]:
            raise AssertionError(f"read_page page {i}: texts {[r.text for _, r in got]} "
                                 f"!= JAX's {texts[i].tolist()}")
        e = max((abs(r.confidence - c) for (_, r), c in zip(got, confs[i])), default=0.0)
        if e > OCR_CONF_TOL:
            raise AssertionError(f"read_page page {i}: |d conf| {e:.3g}")
    return counts, int(fix["page_counts"].sum())


def ocr_chain(fix_pages, fix, eng, seg):
    """The chained path: the port's fp32 segment_batch on the pages, its
    crops, read_batch (invoice, date, amount). → rows (page, field, port
    box == JAX box, port text, JAX chain text)."""
    pages = fix_pages["pages"]
    rgb = np.repeat(pages[..., None], 3, axis=-1)
    _, boxes, ok = seg.segment_batch(rgb, pre_resized=False)
    boxes, ok = boxes.cpu().numpy(), ok.cpu().numpy()
    crops, where = [], []
    for i, page in enumerate(pages):
        for j, crop in enumerate(crop_fields(page, boxes[i], ok[i],
                                             seg.cfg.black_crop_mean).values()):
            if crop is not None:
                crops.append(crop)
                where.append((i, j))
    modes = ["invoice", "date", "amount"]
    res = eng.read_batch(crops, modes=[modes[j] for _, j in where])
    jax_text = {(int(i), int(j)): str(t) for i, j, t in zip(
        fix["field_page"], fix["field_slot"], fix["text_cascade"])}
    rows = []
    for (i, j), r in zip(where, res):
        same_box = bool(np.array_equal(boxes[i, j], fix_pages["boxes"][i, j]))
        rows.append((i, FIELDS[j], same_box, r.text, jax_text.get((i, j))))
    return rows


def phase_ocr(fix_pages):
    """Phase 17: the recognition stack against JAX's outputs on the card."""
    from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine

    fix = ocr_fixture()
    eng = TorchOcrEngine()
    if not eng.available() or eng.device.type != "cuda":
        raise AssertionError(f"TorchOcrEngine: available {eng.available()} on {eng.device}")
    # cuDNN's TF32 flag at PyTorch's default (phase 4 turned it off): the engine
    # must turn it off itself
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        near, frames, lp_err, conf_err = ocr_rows_check(fix, eng)
        crop_err = ocr_crops_check(fix, eng)
        counts, n_lines = ocr_pages_check(fix_pages["pages"], fix, eng)
    print(f"  device half on JAX's {len(fix['rows_u8'])} prepared rows ({eng.arch}, "
          f"{eng.charset.num_classes} classes, TF32 off inside the engine with cuDNN's "
          f"flag on outside): ids equal on every frame with a "
          f"top-1/top-2 gap above {OCR_NEAR_TIE} nats; {near} of {frames} frames under "
          f"it; max |d log-prob| {lp_err:.3g} (tol {OCR_LP_TOL}), max |d conf| "
          f"{conf_err:.3g} (tol {OCR_CONF_TOL}); top-8 ids equal where apart", flush=True)
    print(f"  read_batch on {len(fix['crop_list'])} fixture crops (modes "
          f"{sorted(set(fix['crop_modes'].tolist()))}) under {', '.join(OCR_POLICIES)}: "
          f"texts equal to JAX's; max |d conf| {crop_err:.3g}", flush=True)
    print(f"  detect_lines on the {len(fix_pages['pages'])} pages: boxes equal to JAX's "
          f"({', '.join(f'{m} {n}' for m, n in counts.items())}); read_page: "
          f"{n_lines} lines, boxes and texts equal to JAX's", flush=True)
    _build.launches.clear()  # the chained path starts here
    seg = load_pretrained_segmenter(variant="w16", dtype=torch.float32)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        rows = ocr_chain(fix_pages, fix, eng, seg)
    launches = dict(_build.launches)
    if launches != {k1.NAME: 1}:
        raise AssertionError(f"the chained path launched {launches}; expected K1 once")
    other = []
    for i, field, same_box, text, want in rows:
        print(f"    page {i} {field}: port {text!r}, JAX chain {want!r}"
              f"{'' if same_box else ' (port box differs from JAX box)'}", flush=True)
        if same_box and text != want:
            raise AssertionError(f"chained path page {i} {field}: {text!r} != JAX's {want!r}")
        if not same_box:
            other.append(f"page {i} {field}")
    print(f"  chained path (fp32 segment_batch, crop_fields, read_batch): "
          f"{len(rows) - len(other)} of {len(rows)} fields on JAX's box, their texts "
          f"equal to JAX's; other fields: {other or 'none'}; launches {launches}",
          flush=True)
    return eng, fix


def ocr_layers(params, arch, b, h=32, w=256):
    """The CRNN's convs in forward order for ``b`` lines → [(name, params,
    input shape, multiply-adds)], and its time steps T."""
    layers, hh, ww = [], h, w
    for i, cp in enumerate(params["conv"]):
        co, ci, kh, kw = cp["weight"].shape
        layers.append((f"conv{i}", cp, (b, ci, hh, ww), b * hh * ww * co * ci * kh * kw))
        if i < 3:
            hh //= 2
            if not (i == 2 and arch == "t64"):  # t64's third pool: height only
                ww //= 2
    heads = [("proj", params["proj"])]
    heads += [(f"ctx{i}", cp) for i, cp in enumerate(params["ctx"])]
    heads += [("head", params["head"])]
    for name, cp in heads:
        co, ci, kh, kw = cp["weight"].shape
        layers.append((name, cp, (b, ci, 1, ww), b * ww * co * ci * kh * kw))
    return layers, ww


# phase 18's device-half settings, each held against JAX's rows: {name: (layout
# of the rows and conv weights, cuDNN on, cuDNN's autotuner over every
# algorithm)}; the first is the engine's own
OCR_VARIANTS = {
    "NCHW, cuDNN heuristics (the engine's)": (torch.contiguous_format, True, False),
    "channels_last, cuDNN heuristics": (torch.channels_last, True, False),
    "NCHW, cuDNN off (PyTorch's im2col and cuBLAS)": (torch.contiguous_format, False, False),
    "NCHW, cuDNN autotuned over every algorithm": (torch.contiguous_format, True, True),
}


@contextlib.contextmanager
def ocr_flags(cudnn, autotune):
    """Inference with TF32 off, cuDNN on or off, and its autotuner off or
    trying every algorithm (``benchmark_limit`` 0); all restored on exit."""
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=cudnn, benchmark=autotune, allow_tf32=False):
        if autotune:
            torch.backends.cudnn.benchmark_limit = 0
        yield


def device_kernels(fn, iters=3, tries=3):
    """``torch.profiler`` (device activity only) over ``iters`` calls of
    ``fn()`` after one warm-up → [(device ms a call, kernel)], slowest first;
    their sum is ``fn``'s device busy time a call. A profile that recorded no
    kernel is taken again, up to ``tries`` times, then raises: on an H100 the
    profiler once recorded none of a 1×1 conv's under cuDNN's autotuner,
    whose calls run kernels."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = sorted(((ev.self_device_time_total / iters / 1e3, ev.key)
                          for ev in prof.key_averages() if ev.self_device_time_total),
                         reverse=True)
        if kernels:
            return kernels
    raise AssertionError(f"the profiler recorded no device kernel in {tries} profiles")


def ocr_conv_alone(cp, shape, fmt, cudnn, autotune):
    """One CRNN conv alone on random input of ``shape`` under a phase-18
    setting (bias included, as the model runs it) → (device ms a call, its
    slowest kernel)."""
    x = torch.rand(shape, device="cuda").contiguous(memory_format=fmt)
    w = cp["weight"].contiguous(memory_format=fmt)
    pad = (w.shape[2] // 2, w.shape[3] // 2)

    def conv():
        with ocr_flags(cudnn, autotune):
            return torch.nn.functional.conv2d(x, w, cp["bias"], padding=pad)

    kernels = device_kernels(conv)
    return sum(ms for ms, _ in kernels), kernels[0][1]


def phase_ocr_throughput(eng, fix, card):
    """Phase 18: b384 lines (128 invoices × 3 fields) tiled from the fixture
    crops: the recognizer's device time a call against its float32 bound
    under the engine's settings and three others (each held against JAX's
    rows), each conv alone under each; and read_batch's lines/s with its
    host steps, cascade and greedy, with the recognizer's and the detector's
    device calls timed apart from the rest."""
    from twinvoice_tpu_torch.ocr.torchocr import detector
    from twinvoice_tpu_torch.ocr.torchocr.engine import infer_rows, prepare_crop

    crops, modes = fix["crop_list"], [str(m) for m in fix["crop_modes"]]
    reps = -(-OCR_BATCH // len(crops))
    crops, modes = (crops * reps)[:OCR_BATCH], (modes * reps)[:OCR_BATCH]
    rows = np.stack([r for r in (prepare_crop(c) for c in crops) if r is not None])
    x = torch.from_numpy(rows[:OCR_BATCH]).to(eng.device)[:, None]
    n = x.shape[0]
    layers, steps = ocr_layers(eng._params, eng.arch, n)
    flops = 2 * sum(layer[-1] for layer in layers)
    n_bytes = x.numel() * 4 + sum(t.numel() * 4 for t in
                                   [*tree_leaves(eng._params), *tree_leaves(eng._state)])
    # out: int64 ids and top-8 ids, float32 top-8 and blank log-probs a frame;
    # a float32 confidence a line
    n_bytes += n * (steps * (8 + 8 * 8 + 8 * 4 + 4) + 4)
    bound = max(1e3 * flops / FP32_OPS_PER_S, 1e3 * n_bytes / HBM_BYTES_PER_S)
    print(f"  cuDNN {torch.backends.cudnn.version()}; TF32 off in every setting below",
          flush=True)
    # a channels_last input alone leaves conv0 (Cin 1), and so every later
    # layer, in NCHW: the weights go channels_last too
    nhwc_params = _tree_map(lambda t: t.contiguous(memory_format=torch.channels_last)
                            if t.dim() == 4 else t, eng._params)
    engine_convs = {}
    for k, (variant, (fmt, cudnn, autotune)) in enumerate(OCR_VARIANTS.items()):
        params = nhwc_params if fmt == torch.channels_last else eng._params

        def half(rows_):
            with ocr_flags(cudnn, autotune):
                return infer_rows(params, eng._state,
                                  rows_.contiguous(memory_format=fmt), arch=eng.arch)

        def run(rows_):
            out = half(torch.from_numpy(rows_).to(eng.device)[:, None])
            return [t.cpu().numpy() for t in out]

        ms = cuda_ms(lambda: half(x), iters=20 if k == 0 else 10)
        r = ocr_rows_compare(fix, run)
        print(f"  recognizer device half, b{n} lines (CRNN {eng.arch} + log-softmax, argmax, "
              f"top-8), {variant}: {ms:.4f} ms a call (CUDA events) vs float32 bound "
              f"{bound:.4f} ms ({flops / 1e9:.1f} GFLOP at 67 TFLOP/s; "
              f"{100 * bound / ms:.1f}% of bound) [{card}]", flush=True)
        print(f"    on JAX's rows: ids equal on clear frames {r['ids']}, max |d log-prob| "
              f"{r['lp_err']:.3g}, max |d conf| {r['conf_err']:.3g}, top-8 ids equal where "
              f"apart {r['topk']}; each conv alone on random input of its shape "
              f"(device ms a call, torch.profiler; operations bound; slowest kernel):",
              flush=True)
        for name, cp, shape, macs in layers:
            lms, kernel = ocr_conv_alone(cp, shape, fmt, cudnn, autotune)
            if k == 0:
                engine_convs[name] = lms
            print(f"    {name} {shape} * {tuple(cp['weight'].shape)}: {lms:.4f} ms "
                  f"({1e3 * 2 * macs / FP32_OPS_PER_S:.4f} ms; {kernel[:64]})", flush=True)
    # the engine's two slowest convs at b128: whether cuDNN's choice changes
    # with the batch
    for name, cp, shape, _ in sorted(layers, key=lambda lay: -engine_convs[lay[0]])[:2]:
        lms, kernel = ocr_conv_alone(cp, (SERVE_BATCH,) + shape[1:],
                                     *OCR_VARIANTS["NCHW, cuDNN heuristics (the engine's)"])
        print(f"    {name} at b{SERVE_BATCH}, the engine's settings: {lms:.4f} ms "
              f"({kernel[:64]}); at b{n} {engine_convs[name]:.4f} ms", flush=True)
    infer, cmap = eng._infer, detector._classical_map
    spent = {"recognizer": [], "detector": []}

    def timed(fn, key):
        def call(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            spent[key].append(time.perf_counter() - t)
            return out
        return call

    eng._infer = timed(infer, "recognizer")
    detector._classical_map = timed(cmap, "detector")
    try:
        for policy in ("cascade", "greedy"):
            eng.decode = policy
            eng.read_batch(crops[:8], modes=modes[:8])  # warm-up
            for v in spent.values():
                v.clear()
            t = time.perf_counter()
            res = eng.read_batch(crops, modes=modes)
            dt = time.perf_counter() - t
            if len(res) != OCR_BATCH or not sum(bool(r.text) for r in res):
                raise AssertionError(f"b{OCR_BATCH} read_batch {policy}: nothing read")
            rec, det = sum(spent["recognizer"]), sum(spent["detector"])
            print(f"  read_batch b{OCR_BATCH} lines, {policy}, host steps included: "
                  f"{OCR_BATCH / dt:.1f} lines/s ({1e3 * dt:.1f} ms; "
                  f"{len(spent['recognizer'])} recognizer calls {1e3 * rec:.1f} ms with "
                  f"their copies; {len(spent['detector'])} classical detector maps "
                  f"{1e3 * det:.1f} ms with the page pad and copies; share outside both "
                  f"{1 - (rec + det) / dt:.3f}) [{card}]", flush=True)
    finally:
        eng._infer = infer
        detector._classical_map = cmap
        eng.decode = "cascade"


# -- phases 19-20: field fusion and the QR pipeline -------------------------


FUSION_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_fusion.npz")
# route → FusionConfig keywords; "batch*" drive extract_batch, the others
# extract, "fallback" with a segmenter that finds no field
FUSION_ROUTES = {"batch": {}, "batch_noqr": {"use_qr": False}, "single": {},
                 "fallback": {"use_qr": False}}
FUSION_BATCH = SERVE_BATCH  # pages of phase 20's bulk call
FUSION_REPS = 5
FUSION_STAGES = ("fusion.qr_scan_submit", "fusion.qr_scan", "fusion.segment",
                 "segment.prep", "segment.h2d", "segment.dispatch", "segment.fetch",
                 "fusion.ocr")


def fusion_record(meta, items, qr_raw):
    """An extractor's ``(meta, items, qr_raw)`` as plain JSON data: the
    failures as ``[stage, error]`` (their time stamps and details differ run
    to run)."""
    meta = dict(meta, failures=[[f["stage"], f["error"]] for f in meta["failures"]])
    return json.loads(json.dumps({"meta": meta, "items": items, "qr_raw": list(qr_raw)},
                                 ensure_ascii=False))


class NoFieldSegmenter:
    """A segmenter that finds no field (both packages' entry points), so
    ``extract`` falls back to reading the whole page."""

    def segment_array(self, page):
        return {}, {f: None for f in FIELDS}

    segment_pil = segment_array


def fusion_fixture():
    with np.load(FUSION_FIXTURE) as z:
        fix = {k: z[k] for k in z.files}
    for route in FUSION_ROUTES:
        fix[f"jax_{route}"] = json.loads(str(fix[f"jax_{route}"]))
    return fix


def fusion_boxes(seg, pages):
    """The port's boxes for the pages as the extractor's segmenter calls make
    them: extract_batch's (gray INTER_AREA prep, ``h2d_chunks`` chunks) and
    extract's (``segment_array``'s bicubic resize). → {"batch": (boxes, ok),
    "single": (boxes, ok)}, numpy."""
    from twinvoice_tpu_torch.ops.host_image import (
        resize_area_u8,
        resize_pil_bicubic,
        rgb_to_gray,
    )

    size = seg.cfg.img_size
    sizes = np.asarray([(p.shape[1], p.shape[0]) for p in pages], np.int32)
    _, boxes, ok = seg._segment_host(
        lambda a, b: np.stack([resize_area_u8(rgb_to_gray(p), size, size)
                               for p in pages[a:b]]),
        sizes, return_masks=False, h2d_chunks=FusionConfig().h2d_chunks)
    single = [seg._segment_one(resize_pil_bicubic(p, size, size), *sz)[1:]
              for p, sz in zip(pages, sizes)]
    return {"batch": (boxes, ok),
            "single": (np.stack([b for b, _ in single]), np.stack([o for _, o in single]))}


def fusion_same_boxes(fix, boxes):
    """Per route, per page: whether the port's boxes and ok flags for the page
    are JAX's (the fallback route segments nothing: all True)."""
    n = len(fix["pages"])
    same = {"fallback": [True] * n}
    for kind in ("batch", "single"):
        b, o = boxes[kind]
        same[kind] = [bool(np.array_equal(b[i], fix[f"boxes_{kind}"][i])
                           and np.array_equal(o[i], fix[f"ok_{kind}"][i]))
                      for i in range(n)]
    return {route: same["batch" if route.startswith("batch") else route]
            for route in FUSION_ROUTES}


def fusion_run(route, seg, qr, eng, pages):
    """One route of FUSION_ROUTES through the port's extractor. → the
    records (:func:`fusion_record`) of the pages."""
    from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor

    ex = InvoiceExtractor(NoFieldSegmenter() if route == "fallback" else seg, qr,
                          [eng], cfg=FusionConfig(**FUSION_ROUTES[route]))
    res = (ex.extract_batch(list(pages)) if route.startswith("batch")
           else [ex.extract(p) for p in pages])
    return [fusion_record(*r) for r in res]


def fusion_check(fix, route, got, same_box):
    """``qr_raw`` and ``items`` equal to JAX's on every page, every meta field
    equal on every page whose port boxes are JAX's. → the other pages."""
    want = fix[f"jax_{route}"]
    if len(got) != len(want):
        raise AssertionError(f"fusion {route}: {len(got)} results for {len(want)} pages")
    other = []
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("qr_raw", "items"):
            if g[key] != w[key]:
                raise AssertionError(f"fusion {route} page {i}: {key} {g[key]} != JAX's "
                                     f"{w[key]}")
        if not same_box[i]:
            other.append(i)
        elif g["meta"] != w["meta"]:
            diff = {k: (g["meta"].get(k), v) for k, v in w["meta"].items()
                    if g["meta"].get(k) != v}
            raise AssertionError(f"fusion {route} page {i}: meta (port, JAX) differs "
                                 f"at {diff}")
    return other


def fusion_segment_calls(n):
    """Segmenter calls a route makes on ``n`` pages: extract_batch splits
    its batch into ``h2d_chunks`` when it holds two pages a chunk, extract
    makes one a page, the fallback route none."""
    chunks = FusionConfig().h2d_chunks
    batch = chunks if n >= 2 * chunks else 1
    return {"batch": batch, "batch_noqr": batch, "single": n, "fallback": 0}


def fusion_routes_check(fix, seg, qr, eng, expect_k1=True):
    """Every route of FUSION_ROUTES on the fixture pages against JAX's, each
    driven with the launch counts zeroed just before and read just after:
    K1 once per segment call (2 for a chunked extract_batch, 1 per extract,
    0 on the fallback) and nothing else (``expect_k1=False``: no launch at
    all, the CPU). → {route: (records, pages not on JAX's boxes, launches)}."""
    same = fusion_same_boxes(fix, fusion_boxes(seg, fix["pages"]))
    calls = fusion_segment_calls(len(fix["pages"]))
    out = {}
    for route in FUSION_ROUTES:
        _build.launches.clear()
        got = fusion_run(route, seg, qr, eng, fix["pages"])
        launches = dict(_build.launches)
        want = {k1.NAME: calls[route]} if expect_k1 and calls[route] else {}
        if launches != want:
            raise AssertionError(f"fusion {route}: launches {launches}, expected {want}")
        other = fusion_check(fix, route, got, same[route])
        out[route] = (got, other, launches)
    return out


def meta_fields_agree(a, b):
    """Meta fields (failures aside), items and payloads equal between two
    runs' records. → (equal, compared)."""
    keys = [k for k in a[0]["meta"] if k != "failures"]
    eq = sum(x["meta"][k] == y["meta"][k] for x, y in zip(a, b) for k in keys)
    eq += sum(x[k] == y[k] for x, y in zip(a, b) for k in ("items", "qr_raw"))
    return eq, len(a) * (len(keys) + 2)


def phase_fusion(fix8):
    """Phase 19: the port's InvoiceExtractor on the fixture pages against the
    JAX extractor's outputs, on every route; then extract_batch on the int8
    "pallas" route."""
    from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine
    from twinvoice_tpu_torch.qr import detect as qr_detect

    fix = fusion_fixture()
    seg = load_pretrained_segmenter(torch.float32)
    qr = qr_detect.QrPipeline()
    eng = TorchOcrEngine()
    qr_detect.passes.clear()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = fusion_routes_check(fix, seg, qr, eng)
    passes = dict(qr_detect.passes)
    if passes.get("regions", 0):
        raise AssertionError(f"a page needed the QR region pass: {passes}")
    launches = {}
    for route, (got, other, n) in out.items():
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        print(f"  {route}: qr_raw and items equal to JAX's on {len(got)} pages; every "
              f"meta field equal on the {len(got) - len(other)} pages whose port boxes "
              f"are JAX's (others: {other or 'none'}); launches {n}", flush=True)
    print(f"  QR passes over every route: {passes} (no region pass, no OpenCV step)",
          flush=True)
    for i, rec in enumerate(out["single"][0]):
        m = rec["meta"]
        print(f"    page {i}: {m['invoice_no']} ({m['source']}), {m['date']} "
              f"({m['date_source']}), {m['total_amount']}; items {rec['items']}",
              flush=True)
    for i, rec in enumerate(out["fallback"][0]):
        m = rec["meta"]
        print(f"    page {i} full-page fallback: {m['invoice_no']} ({m['source']}), "
              f"{m['date']} ({m['date_source']})", flush=True)
    scales = quant.scales_from_array(fix8["scales"])
    s8 = load_pretrained_segmenter(torch.float32, variant="w16", int8_scales=scales,
                                   **ROUTE_ARGS["pallas"])
    calls = fusion_segment_calls(len(fix["pages"]))["batch"]
    (got8, _), n8 = counted("pallas (extract_batch)", ROUTE_KERNELS["pallas"], calls,
                            lambda: (fusion_run("batch", s8, qr, eng, fix["pages"]), None))
    for k, v in n8.items():
        launches[k] = launches.get(k, 0) + v
    eq, total = meta_fields_agree(got8, out["batch"][0])
    print(f"  int8 pallas route, extract_batch: launches {n8} ({calls} segment calls); "
          f"{eq} of {total} fields equal to the fp32 run's (not a gate)", flush=True)
    return fix, launches


def phase_fusion_throughput(fix, card):
    """Phase 20: extract_batch on FUSION_BATCH pages tiled from the fixture,
    the bundled w16 segmenter at its default dtype (bf16), the default
    FusionConfig, the cache cleared before each timed call: invoices/s and
    each stage's share of the call (StageTimer). → K1's launches."""
    from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor
    from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine
    from twinvoice_tpu_torch.qr.detect import QrPipeline
    from twinvoice_tpu_torch.utils.tracing import get_timer

    pages = [fix["pages"][i % len(fix["pages"])] for i in range(FUSION_BATCH)]
    seg = load_pretrained_segmenter()
    ex = InvoiceExtractor(seg, QrPipeline(), [TorchOcrEngine()], cfg=FusionConfig())
    ex.extract_batch(pages)  # warm-up
    timer = get_timer()
    _build.launches.clear()
    rates, shares = [], {}
    for _ in range(FUSION_REPS):
        ex.clear_cache()
        timer.reset()
        t = time.perf_counter()
        res = ex.extract_batch(pages)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        rates.append(FUSION_BATCH / dt)
        stats = timer.stats()
        shares = {k: stats[k]["total_s"] / dt for k in FUSION_STAGES if k in stats}
        want = fix["jax_batch"]
        bad = [i for i, (meta, _, qr_raw) in enumerate(res)
               if qr_raw != want[i % len(want)]["qr_raw"] or not meta["total_amount"]]
        if bad:
            raise AssertionError(f"phase 20: qr_raw differs from JAX's, or no amount, "
                                 f"at pages {bad}")
        print(f"  b{FUSION_BATCH} extract_batch: {FUSION_BATCH / dt:.2f} invoices/s "
              f"({1e3 * dt:.1f} ms; stage shares "
              + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()) + f") [{card}]",
              flush=True)
    launches = dict(_build.launches)
    chunks = FusionConfig().h2d_chunks
    if launches != {k1.NAME: chunks * FUSION_REPS}:
        raise AssertionError(f"phase 20: launches {launches}, expected K1 "
                             f"{chunks * FUSION_REPS}")
    print(f"  invoices/s over {FUSION_REPS} calls: median {sorted(rates)[len(rates) // 2]:.2f}; "
          f"qr_raw equal to JAX's on every page; launches {launches}; the last call's "
          f"stages (host wall time of each span):", flush=True)
    for line in timer.report().splitlines():
        print(f"    {line}", flush=True)
    host_steps_alone(ex, pages, card)
    return launches


def host_steps_alone(ex, pages, card):
    """The bulk call's host steps one at a time on the same pages, no thread
    pool: the QR scans, the segmenter's numpy prep, and read_batch on the
    crops of a segmenter call (whose own launches are not counted)."""
    from twinvoice_tpu_torch.fusion.extract import _FIELD_MODES, _engine_crop
    from twinvoice_tpu_torch.ops.host_image import resize_area_u8, rgb_to_gray

    size = ex.segmenter.cfg.img_size
    times = {}
    t = time.perf_counter()
    for p in pages:
        ex.qr.scan(p)
    times["QR scans"] = time.perf_counter() - t
    t = time.perf_counter()
    for p in pages:
        resize_area_u8(rgb_to_gray(p), size, size)
    times["segmenter prep"] = time.perf_counter() - t
    crops = [c for _, c in ex.segmenter.segment_array_batch(
        pages, return_masks=False, gray_h2d=True, h2d_chunks=FusionConfig().h2d_chunks)]
    flat = [_engine_crop(c.get(f)) for c in crops for f in _FIELD_MODES]
    modes = [m for _ in crops for m in _FIELD_MODES.values()]
    t = time.perf_counter()
    ex.engines[0].read_batch(flat, modes=modes)
    times["read_batch"] = time.perf_counter() - t
    cores = len(os.sched_getaffinity(0))
    print(f"  each host step alone on the {len(pages)} pages, serial ({cores} CPU cores): "
          + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in times.items())
          + f" [{card}]", flush=True)


# -- phases 21-22: segmenter training -------------------------------------------


TRAIN_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_train.npz")
TRAIN_LR = 1e-3       # the fixture's: TrainConfig.lr, epoch 1 of the schedule
TRAIN_SETTINGS = {"fp32": ("float32", False), "bf16": ("bfloat16", False),
                  "bf16_fast": ("bfloat16", True)}


def train_fixture():
    with np.load(TRAIN_FIXTURE) as z:
        return {k: z[k] for k in z.files}


def _copy_to(tree, device):
    """A copy of a params/state tree on ``device``."""
    return _tree_map(lambda t: t.to(device, copy=True), tree)


def train_batch(fix, dtype, device):
    """The fixture's b4 512² batch as ``ArrayDataset.batches`` gives it,
    NCHW on ``device``."""
    images, masks = next(ArrayDataset(fix["pages"], fix["masks"]).batches(4, shuffle=False))
    return to_device_batch(images, masks, dtype, device)


def train_run(fix, device, dtype, fast=False, *, steps=3, remat=False):
    """The port's ``make_train_step`` from the bundled w16 weights on the
    fixture batch: ``steps`` steps at lr 1e-3, the numbers the fixture
    stores (its module doc), keyed as there, plus the eval step's."""
    _, mcfg, _ = VARIANTS["w16"]
    params, state = load_npz(variant_path("w16"))
    start = dict(keystr_items(to_jax_params(params, state)[0]))
    params, state = _copy_to(params, device), _copy_to(state, device)
    tcfg = TrainConfig(dtype=dtype, fast_norm=fast, remat=remat)
    x, y = train_batch(fix, DTYPES[dtype], device)
    out = {}
    if not fast:
        loss, iou = make_eval_step(mcfg, tcfg)(params, state, x, y)
        out["eval_loss"], out["eval_iou"] = float(loss), iou.cpu().numpy()
    opt = make_optimizer(params, tcfg)
    step = make_train_step(mcfg, tcfg, device=device)
    skeys = [str(k) for k in fix["state_keys"]]
    losses, bn = [], []
    for i in range(steps):
        params, state, loss = step(params, state, opt, x, y, TRAIN_LR)
        losses.append(loss)
        sd = dict(keystr_items(to_jax_params(params, state)[1]))
        bn.append(np.concatenate([sd[k] for k in skeys]))
        if i == 0:
            grads = dict(keystr_items(to_jax_params(_tree_map(lambda t: t.grad, params),
                                                    state)[0]))
    pkeys = [str(k) for k in fix["param_keys"]]
    after = dict(keystr_items(to_jax_params(params, state)[0]))
    out.update({
        "losses": torch.stack(losses).cpu().numpy(),
        "grad_norms": np.array([np.linalg.norm(grads[k].astype(np.float64)) for k in pkeys]),
        "grad_sample": np.stack([grads[k].reshape(-1)[i] for k, i in
                                 zip(pkeys, fix["sample_idx"])]),
        "bn1": bn[0], "bn3": bn[-1],
        "step_norms": np.array([np.linalg.norm((after[k] - start[k]).astype(np.float64))
                                for k in pkeys]),
        "grads": grads,
    })
    return out


# Phase 21's tolerances, per setting. Each number is held to the exact float64
# step where the fixture has it (``exact_*``: step 1's loss, gradients and BN
# state) and to JAX's within JAX's own distance from the exact value (or, for
# the bf16 losses, from JAX's float32 loss) plus the same tolerance: XLA's CPU
# reductions add up one element after another (in bf16 at bf16), so JAX's
# gradients are up to 1e-4 from the exact ones at float32 and up to 80% at
# bf16 (the out bias: a bf16 sum over 1M pixels). "loss": relative, each of
# the 3 steps and the eval step; "grad": a leaf's norm and its 16 sampled
# elements, relative to the leaf's exact norm (the first two levels' ReLU and
# pool kinks on the flat paper background route a float32 gradient by the
# activations' last bit); "bn1"/"bn3": relative ‖·‖ of the BN running
# statistics after steps 1 and 3; "step": a kernel's step norm after 3 steps,
# relative to JAX's (Adam's ±lr steps, but for near-0 gradients); "iou": the
# eval step's per-class IoU, absolute; "bias": the norm of a pre-BN conv
# bias's gradient (exactly 0) relative to its kernel's. The 1-D leaves' step
# norms are held to Adam's bound, 3·lr·√n.
TRAIN_TOLS = {
    "fp32": dict(loss=1e-4, grad=2e-2, bn1=1e-5, bn3=1e-4, step=1e-2, iou=1e-3, bias=1e-3),
    "bf16": dict(loss=1e-2, grad=0.25, bn1=1e-3, bn3=5e-2, step=0.3, iou=1e-2, bias=2e-2),
}
TRAIN_TOLS["bf16_fast"] = TRAIN_TOLS["bf16"]


def rel_dist(a, b):
    """‖a − b‖ / ‖b‖ in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def pre_bn_bias(key):
    """A conv bias that train-mode BatchNorm follows: its exact gradient is 0."""
    return "['conv" in key and key.endswith("['bias']")


def train_parity(fix, tag, got):
    """Hold one setting's numbers (:func:`train_run`) to the fixture's with
    ``TRAIN_TOLS[tag]``; print each leaf's gradient and step norms beside
    JAX's (and the exact gradient norm), then the losses beside JAX's and
    each check's worst case. Returns the failures (empty: it passed)."""
    tol = TRAIN_TOLS[tag]
    fails = []
    jl = fix[f"{tag}_losses"]
    for i, (a, b, f) in enumerate(zip(got["losses"], jl, fix["fp32_losses"])):
        if abs(a - b) > abs(b - f) * 1.01 + tol["loss"] * b:
            fails.append(f"step {i + 1} loss {a:.8f} vs JAX {b:.8f}")
    pkeys = [str(k) for k in fix["param_keys"]]
    ex, jn, gn = fix["exact_grad_norms"], fix[f"{tag}_grad_norms"], got["grad_norms"]
    es, js, gs = fix["exact_grad_sample"], fix[f"{tag}_grad_sample"], got["grad_sample"]
    worst = {"grad": (0.0, ""), "step": (0.0, "")}
    rows = []
    for i, key in enumerate(pkeys):
        step, jstep = got["step_norms"][i], fix[f"{tag}_step_norms"][i]
        rows.append(f"    {tag} {key:38s} grad {gn[i]:.5e} JAX {jn[i]:.5e} exact "
                    f"{ex[i]:.5e} | step {step:.5e} JAX {jstep:.5e}")
        n = got["grads"][key].size
        if pre_bn_bias(key):
            kern = ex[pkeys.index(key.replace("['bias']", "['kernel']"))]
            if gn[i] > tol["bias"] * kern:
                fails.append(f"{key}: gradient norm {gn[i]:.3e} (exactly 0)")
        else:
            err = max(abs(gn[i] - ex[i]), np.abs(gs[i] - es[i]).max()) / ex[i]
            jerr = max(abs(jn[i] - ex[i]), np.abs(js[i] - es[i]).max()) / ex[i]
            vs_jax = max(abs(gn[i] - jn[i]), np.abs(gs[i] - js[i]).max()) / ex[i]
            if err > tol["grad"] or vs_jax > jerr * 1.01 + tol["grad"]:
                fails.append(f"{key}: gradient {err:.3e} from exact, {vs_jax:.3e} from JAX "
                             f"(JAX {jerr:.3e} from exact)")
            worst["grad"] = max(worst["grad"], (err, key))
        if key.endswith("['kernel']"):
            rel = abs(step - jstep) / jstep
            worst["step"] = max(worst["step"], (rel, key))
            if rel > tol["step"]:
                fails.append(f"{key}: step norm {step:.4e} vs JAX {jstep:.4e}")
        elif step > 3.03 * TRAIN_LR * np.sqrt(n):
            fails.append(f"{key}: step norm {step:.4e} above Adam's bound")
    bn1_exact = rel_dist(got["bn1"], fix["exact_bn1"])
    bn1_jax = rel_dist(got["bn1"], fix[f"{tag}_bn1"])
    bn1_own = rel_dist(fix[f"{tag}_bn1"], fix["exact_bn1"])
    bn3 = rel_dist(got["bn3"], fix[f"{tag}_bn3"])
    if bn1_exact > tol["bn1"] or bn1_jax > bn1_own * 1.01 + tol["bn1"]:
        fails.append(f"BN state after step 1: {bn1_exact:.3e} from exact, {bn1_jax:.3e} from JAX")
    if bn3 > tol["bn3"]:
        fails.append(f"BN state after step 3: {bn3:.3e} from JAX")
    line = (f"  {tag}: losses {np.round(got['losses'].astype(np.float64), 8).tolist()} vs JAX "
            f"{np.round(jl.astype(np.float64), 8).tolist()}; step-1 gradient worst {worst['grad'][0]:.2e} of its "
            f"norm from exact ({worst['grad'][1]}); BN after step 1 {bn1_exact:.2e} from "
            f"exact, {bn1_jax:.2e} from JAX; after step 3 {bn3:.2e}; kernel step norms worst "
            f"{worst['step'][0]:.2e} from JAX's ({worst['step'][1]})")
    if "eval_loss" in got:
        el, jel = got["eval_loss"], float(fix[f"{tag}_eval_loss"])
        diou = np.abs(got["eval_iou"] - fix[f"{tag}_eval_iou"]).max()
        if abs(el - jel) > tol["loss"] * jel or diou > tol["iou"]:
            fails.append(f"eval loss {el:.8f} vs JAX {jel:.8f}, IoU off by {diou:.3e}")
        line += (f"; eval loss {el:.8f} vs JAX {jel:.8f}, IoU "
                 f"{np.round(got['eval_iou'].astype(np.float64), 5).tolist()} vs "
                 f"{np.round(fix[f'{tag}_eval_iou'].astype(np.float64), 5).tolist()}")
    print("\n".join(rows) + "\n" + line, flush=True)
    return fails


def remat_check(fix, device):
    """One float32 step with ``remat=True`` against one without, from the
    same start: the loss equal within 1e-6, each gradient within 1e-4 of
    its norm (the recompute reruns cuDNN's convs, whose backward may sum in
    another order), the new BN state within 1e-6."""
    runs = [train_run(fix, device, "float32", steps=1, remat=r) for r in (False, True)]
    a, b = runs
    errs = [rel_dist(b["grads"][k], a["grads"][k]) for k in a["grads"] if not pre_bn_bias(k)]
    dl = abs(float(a["losses"][0]) - float(b["losses"][0])) / float(a["losses"][0])
    dbn = rel_dist(b["bn1"], a["bn1"])
    print(f"  remat vs plain, one fp32 step: loss {float(b['losses'][0]):.8f} vs "
          f"{float(a['losses'][0]):.8f}; gradients within {max(errs):.2e}; BN state within "
          f"{dbn:.2e}", flush=True)
    if dl > 1e-6 or max(errs) > 1e-4 or dbn > 1e-6:
        raise AssertionError(f"remat differs from plain: loss {dl:.3e}, gradients "
                             f"{max(errs):.3e}, BN {dbn:.3e}")


def phase_train_parity(card):
    """Phase 21: the port's train step against the JAX trainer's numbers."""
    fix = train_fixture()
    device = torch.device("cuda")
    fails = []
    with tf32_off():
        for tag, (dtype, fast) in TRAIN_SETTINGS.items():
            got = train_run(fix, device, dtype, fast)
            fails += [f"{tag}: {f}" for f in train_parity(fix, tag, got)]
        remat_check(fix, device)
    print(f"  [{card}]", flush=True)
    if fails:
        raise AssertionError("training parity:\n" + "\n".join(fails))


@contextlib.contextmanager
def tf32_off():
    """TF32 off for cuDNN's convs and for matmuls, restored after."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def unet_macs(cfg, size):
    """Multiply-adds of one image's U-Net forward, from the layer shapes."""
    macs, cin, hw = 0, cfg.in_channels, size
    for w in cfg.encoder_widths():
        macs += hw * hw * 9 * (cin * w + w * w)
        cin, hw = w, hw // 2
    bw = cfg.bottleneck_width()
    macs += hw * hw * 9 * (cin * bw + bw * bw)
    up_in = bw
    for w in reversed(cfg.encoder_widths()):
        macs += hw * hw * 4 * up_in * w      # the 2×2 transpose conv, at its input size
        hw *= 2
        macs += hw * hw * 9 * (2 * w * w + w * w)
        up_in = w
    return macs + hw * hw * cfg.encoder_widths()[0] * cfg.num_classes


def step_bound_ms(macs, first_macs, n_params, in_bytes, peak=FP32_OPS_PER_S):
    """The least time of one train step: its operations (the forward's
    ``macs`` multiply-adds, and the input and weight gradients of every layer
    but the first layer's input gradient, ``first_macs``; 2 FLOPs a
    multiply-add) over the card's ``peak``, or the bytes it must move (the
    params and AdamW's two moments, float32, each read and written once, and
    the batch's ``in_bytes`` read once), whichever is larger.
    → (ms, "operations" or "bytes", FLOPs)."""
    flops = 2 * (3 * macs - first_macs)
    nbytes = 2 * 3 * 4 * n_params + in_bytes
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / HBM_BYTES_PER_S
    return (ops_ms, "operations", flops) if ops_ms >= bytes_ms else (bytes_ms, "bytes", flops)


def train_step_bound_ms(cfg, n, size, n_params, dtype):
    """:func:`step_bound_ms` of a U-Net step on ``n`` images of ``size``² at
    ``dtype``'s peak (its images and masks the batch)."""
    stem = size * size * 9 * cfg.in_channels * cfg.encoder_widths()[0]
    return step_bound_ms(n * unet_macs(cfg, size), n * stem, n_params,
                         n * size * size * 6 * (4 if dtype == "float32" else 2),
                         FP32_OPS_PER_S if dtype == "float32" else BF16_OPS_PER_S)


TRAIN_WARMUP = 2   # untimed steps before phase 22's timed ones
TRAIN_TIMED = 10
# a train step's device kernels by kind: the first kind whose words a
# kernel's name holds
TRAIN_KERNEL_KINDS = (
    ("conv", ("conv", "xmma", "cudnn", "fprop", "dgrad", "wgrad", "winograd", "fft",
              "nchwToNhwc", "nhwcToNchw", "complex", "region_transform")),
    ("gemm", ("gemm", "cutlass", "sm90_")),
    ("reduction", ("reduce",)),
    ("AdamW", ("multi_tensor", "adam")),
    ("pool", ("pool",)),
    ("cat", ("CatArray",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def train_step_kinds(step_fn, ms):
    """Two train steps under ``torch.profiler``: their device time a step
    by kernel kind (``TRAIN_KERNEL_KINDS``), beside the event-timed step's
    ``ms`` and 1 − busy/ms unclamped (negative where the profiled steps'
    kernels outlast the timed steps), and the three slowest kernels."""
    kernels = device_kernels(step_fn, iters=2)
    kinds = {}
    for t, name in kernels:
        kind = next((k for k, words in TRAIN_KERNEL_KINDS
                     if any(w.lower() in name.lower() for w in words)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + t
    busy = sum(kinds.values())
    print(f"    profiled device {busy:.3f} ms a step beside {ms:.3f} ms timed, 1 - busy/ms "
          f"{1 - busy / ms:.4f}; "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
          + "; slowest: " + "; ".join(f"{t:.3f} {n[:60]}" for t, n in kernels[:3]),
          flush=True)


def timed_steps(step_fn):
    """``TRAIN_WARMUP`` untimed calls of ``step_fn()`` (→ a loss tensor), then
    ``TRAIN_TIMED`` timed by CUDA events around each. → (median ms, peak GiB
    over all the calls, the losses of every call)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, events = [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        losses.append(step_fn())
        ev[1].record()
        if i >= TRAIN_WARMUP:
            events.append(ev)
    torch.cuda.synchronize()
    return (float(np.median([a.elapsed_time(b) for a, b in events])),
            torch.cuda.max_memory_allocated() / 2 ** 30,
            torch.stack(losses).cpu().numpy())


def train_speed(fix, card, params, state, dtype):
    """Phase 22's timing at one dtype: the w64 train step on the fixture
    batch, ``TRAIN_WARMUP`` steps then ``TRAIN_TIMED`` timed ones (CUDA
    events around each). → the losses of every step."""
    device = torch.device("cuda")
    mcfg = VARIANTS["w64"][1]
    params, state = _copy_to(params, device), _copy_to(state, device)
    tcfg = TrainConfig(dtype=dtype)
    opt = make_optimizer(params, tcfg)
    step = make_train_step(mcfg, tcfg, device=device)
    x, y = train_batch(fix, DTYPES[dtype], device)
    box = [params, state]

    def one():
        box[0], box[1], loss = step(box[0], box[1], opt, x, y, TRAIN_LR)
        return loss

    ms, peak, losses = timed_steps(one)
    bound, by, flops = train_step_bound_ms(mcfg, x.shape[0], x.shape[2],
                                           param_count(params), dtype)
    print(f"  w64 b{x.shape[0]} {x.shape[2]}^2 {dtype}: {ms:.3f} ms a step (median of "
          f"{TRAIN_TIMED}), {1e3 * x.shape[0] / ms:.2f} img/s; bound {bound:.3f} ms by "
          f"{by} ({flops / 1e12:.3f} TFLOP), {bound / ms:.3f} of it reached; peak memory "
          f"{peak:.2f} GiB [{card}]", flush=True)
    print(f"    losses {np.round(losses.astype(np.float64), 6).tolist()}", flush=True)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"w64 {dtype} losses do not fall: {losses.tolist()}")
    train_step_kinds(one, ms)
    return {"ms": ms, "bound_ms": bound, "peak_gib": peak}


# the served logits against the plain fp32 path's, as ‖served − plain‖₂ / ‖plain‖₂:
# bf16 keeps 8 significant bits (unit roundoff 2^-9), and 2^-5 covers the rounding
# of the input, the weights and every layer's output over the U-Net's depth; at
# fp32 (TF32 off) only the folded batch norm and the summation order differ
SERVED_LOGIT_RTOL = {torch.bfloat16: 2.0 ** -5, torch.float32: 1e-4}


def served_vs_plain(seg, params, state, mcfg, pages, *, label="the trained w64", raw=False,
                    device="cuda"):
    """The trained weights served through ``seg`` (K1, box-only; with
    ``raw``, the raw path: pages at their own size, resized on the device,
    masks too) against the plain path on the same weights: eval-mode
    ``unet_apply`` at fp32 (TF32 off) on the pages (with ``raw``, on their
    ``resize_bilinear`` / 255, as the raw path feeds its U-Net),
    ``bbox_from_probs`` and ``scale_and_pad_boxes``. The plain path
    must find fields. The served boxes and ok flags must equal K1's plain
    version on the logits the served call handed K1, and those logits must
    be within ``SERVED_LOGIT_RTOL`` of the plain path's. The boxes are not
    held to the plain path's within a grid cell: a bf16 logit that lands on
    the other side of a threshold can move a box edge by any number of cells
    (a box spans every pixel above it), so how far they differ is printed.
    → (served ok, boxes, the launches of the served call)."""
    icfg = seg.cfg
    sizes = torch.tensor([[pages.shape[2], pages.shape[1]]] * len(pages), dtype=torch.int32,
                         device=device)
    seen = []
    post = seg._post

    def keep(logits, *args):  # the logits K1 reads in the served call
        seen.append(logits)
        return post(logits, *args)

    seg._post = keep
    try:
        _build.launches.clear()  # the trained model's serving path starts here
        _, boxes, ok = seg.segment_batch(pages, pre_resized=not raw, return_masks=False)
        sync(device)
        launches = dict(_build.launches)
    finally:
        del seg._post
    if len(seen) != 1:
        raise AssertionError(f"{label}: the served call handed K1 {len(seen)} logits")
    served = seen[0]
    params, state = _copy_to(params, device), _copy_to(state, device)
    with torch.no_grad(), tf32_off():
        gb, gv = k1.bbox_postprocess_reference(served, seg._logit_thr.to(device))
        own_boxes, own_ok = scale_and_pad_boxes(gb, gv, sizes, icfg.img_size, icfg.pad_frac)
        u8 = torch.as_tensor(pages, device=device).permute(0, 3, 1, 2)
        if raw:
            x = resize_bilinear(u8, icfg.img_size, icfg.img_size) / 255.0
        else:
            x = normalize_uint8(u8, torch.float32)
        logits, _ = unet_apply(params, state, x, cfg=mcfg, train=False)
        plain = logits.permute(0, 2, 3, 1)
        gb, gv = bbox_from_probs(torch.sigmoid(plain), icfg.thresholds)
        ref_boxes, ref_ok = scale_and_pad_boxes(gb, gv, sizes, icfg.img_size, icfg.pad_frac)
        diff = served.to(torch.float64) - plain.to(torch.float64)
        rel = float(diff.norm() / plain.to(torch.float64).norm())
        max_abs = float(diff.abs().max())
    ref_ok, ref_boxes = ref_ok.cpu().numpy(), ref_boxes.cpu().numpy().astype(np.int64)
    print(f"  {label} served at {str(seg.dtype).split('.')[-1]} on the {len(pages)} pages: "
          f"ok {ok.cpu().numpy().tolist()}, "
          f"boxes {boxes.cpu().numpy().tolist()}; plain fp32 boxes {ref_boxes.tolist()}; "
          f"launches {launches}", flush=True)
    if not ref_ok.any():
        raise AssertionError(f"{label} finds no field on the plain path")
    if not (torch.equal(ok, own_ok) and torch.equal(boxes, own_boxes)):
        raise AssertionError(f"{label}: K1 in the served call gave ok {ok.tolist()}, boxes "
                             f"{boxes.tolist()}; its plain version on the same logits ok "
                             f"{own_ok.tolist()}, boxes {own_boxes.tolist()}")
    rtol = SERVED_LOGIT_RTOL[seg.dtype]
    if not rel <= rtol:
        raise AssertionError(f"{label}: served logits off the plain fp32 path's by {rel:.3g} "
                             f"relative (max |d| {max_abs:.4g}), above {rtol:.3g}")
    ok = ok.cpu().numpy()
    both = ok & ref_ok
    d = np.abs(boxes.cpu().numpy().astype(np.int64) - ref_boxes)[both].max(-1)
    cell = -(-max(pages.shape[1:3]) // icfg.img_size)
    print(f"  served vs plain: K1's boxes and ok equal to its plain version on the served "
          f"logits; logits off the plain fp32 path's by {rel:.3g} relative (limit {rtol:.3g}), "
          f"max |d| {max_abs:.4g}; ok equal {int((ok == ref_ok).sum())}/{ok.size} "
          f"({int(ref_ok.sum())} fields found on the plain path); boxes exactly equal "
          f"{int((d == 0).sum())}/{d.size}, within a {cell} px cell and the pad's floor "
          f"{int((d <= cell + 1).sum())}/{d.size}, max |d| {int(d.max()) if d.size else 0} px",
          flush=True)
    return ok, boxes, launches


def phase_train_w64(card):
    """Phase 22: the bundled w64 U-Net trained on the card (see the module
    doc), then served. → K1's launches by the trained model's ``Segmenter``."""
    import tempfile

    fix = train_fixture()
    bundled = load_npz(variant_path("w64"))
    with tf32_off():
        for dtype in ("float32", "bfloat16"):
            train_speed(fix, card, *bundled, dtype)
    mcfg = VARIANTS["w64"][1]
    ds = ArrayDataset(fix["pages"], fix["masks"])
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp, tf32_off():
        tcfg = TrainConfig(epochs=3, checkpoint_dir=os.path.join(tmp, "ckpt"),
                           visualize_dir=os.path.join(tmp, "vis"))
        cfg = Config(model=mcfg, train=tcfg)
        # fit starts from its seeded init or from a checkpoint: the bundled
        # weights at epoch 0 make the checkpoint it starts from
        start = os.path.join(tmp, "start")
        params, state = _copy_to(bundled[0], "cpu"), _copy_to(bundled[1], "cpu")
        ckpt.save(start, TrainState(params, state, make_optimizer(params, tcfg)))
        del params, state
        t = time.perf_counter()
        state, history = fit(ds, cfg, resume_dir=start,
                             log=lambda m: print("   ", m, flush=True))
        fit_s = time.perf_counter() - t
        latest = os.path.join(tcfg.checkpoint_dir, "latest")
        t = time.perf_counter()
        state, resumed = fit(ds, replace(cfg, train=replace(tcfg, epochs=4)),
                             resume_dir=latest, log=lambda m: print("   ", m, flush=True))
        resume_s = time.perf_counter() - t
        if [r["epoch"] for r in history] != [1, 2, 3] or [r["epoch"] for r in resumed] != [4]:
            raise AssertionError(f"fit ran epochs {[r['epoch'] for r in history]}, then "
                                 f"{[r['epoch'] for r in resumed]}")
        losses = [r["loss"] for r in history + resumed]
        if not np.isfinite(losses).all():
            raise AssertionError(f"fit losses {losses}")
        # the same first epoch without the prefetch thread: its one loss is
        # the forward at the bundled weights, so a batch the side stream had
        # not finished uploading would show here
        _, sync = fit(ds, replace(cfg, train=replace(
            tcfg, epochs=1, prefetch=0, visualize=False,
            checkpoint_dir=os.path.join(tmp, "sync"))), resume_dir=start, log=lambda m: None)
        if abs(sync[0]["loss"] - losses[0]) > 1e-6 * losses[0]:
            raise AssertionError(f"epoch 1 loss {losses[0]} with prefetch, "
                                 f"{sync[0]['loss']} without")
        pngs = sorted(os.listdir(tcfg.visualize_dir))
        want = [f"epoch{e:03d}_{k}.png" for e in range(1, 5) for k in ("img", "pred", "true")]
        if pngs != want:
            raise AssertionError(f"visual dumps {pngs}")
        for name in pngs:
            with open(os.path.join(tcfg.visualize_dir, name), "rb") as f:
                if f.read(8) != b"\x89PNG\r\n\x1a\n":
                    raise AssertionError(f"{name} is not a PNG")
        best = ckpt.restore(os.path.join(tcfg.checkpoint_dir, "best"), state)
        npz = os.path.join(tmp, "best.npz")
        ckpt.save_params_npz(npz, best.params, best.bn_state)
        print(f"  fit w64 fp32 from the bundled weights, 3 epochs of 1 step on the 4 pages: "
              f"{fit_s:.2f} s; resumed from latest for epoch 4: {resume_s:.2f} s (both "
              f"mostly checkpoint writes); losses {np.round(losses, 6).tolist()} (epoch 1 "
              f"without prefetch {sync[0]['loss']:.6f}), best {best.best_loss:.6f} at epoch "
              f"{int(np.argmin(losses)) + 1}; {len(pngs)} PNGs; best.npz "
              f"{os.path.getsize(npz) / 2 ** 20:.1f} MiB [{card}]", flush=True)
        del state, best
        params, state = ckpt.load_params_npz(npz)
    seg = Segmenter(params, state, mcfg, InferConfig(img_size=512), dtype=torch.bfloat16)
    _, boxes, launches = served_vs_plain(seg, params, state, mcfg, fix["pages"])
    if launches.get(k1.NAME, 0) != 1 or tuple(boxes.shape) != (4, 3, 4):
        raise AssertionError(f"serving the trained w64 launched {launches}")
    return launches[k1.NAME]


# -- phases 23-24: recognizer and textness-head training -------------------------


OCR_TRAIN_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_ocrtrain.npz")
OCR_TRAIN_LR = 3e-4   # the fixture's recognizer steps, at a constant lr
TX_TRAIN_LR = 2e-3    # the textness steps: textness.train's cosine decay over 3 steps
OCR_TRAIN_STEPS = 120  # phase 24's train() run: the 100 warmup steps and 20 more
TX_BATCH = 32          # textness.train's batch, tiled from the fixture's 8 pages


def ocr_train_fixture():
    with np.load(OCR_TRAIN_FIXTURE) as z:
        return {k: z[k] for k in z.files}


def _leaf_stats(grads, keys, idx):
    """{keystr: gradient} → (norms (L,), the sampled elements (L, 16))."""
    g = [grads[str(k)].astype(np.float64) for k in keys]
    return (np.array([np.linalg.norm(v) for v in g]),
            np.stack([v.reshape(-1)[i] for v, i in zip(g, idx)]))


def ocr_train_run(fix, device, steps=3):
    """The port's recognizer ``make_train_step`` from the bundled weights on
    the fixture's batch 0, ``steps`` steps at lr 3e-4: the numbers the
    fixture stores, keyed as there."""
    params, state, _, arch = rec_model.load_crnn_weights()
    start = dict(keystr_items(rec_model.crnn_params_to_jax(params, state)[0]))
    params, state = _copy_to(params, device), _copy_to(state, device)
    opt = rec_train.make_optimizer(params)
    step = rec_train.make_train_step(arch, device=device)
    x = lines_to_tensor(fix["lines"], device)
    skeys = [str(k) for k in fix["state_keys"]]
    losses, bn = [], []
    for i in range(steps):
        params, state, loss = step(params, state, opt, x, fix["labels"], fix["label_pad"],
                                   OCR_TRAIN_LR)
        losses.append(loss)
        sd = dict(keystr_items(rec_model.crnn_params_to_jax(params, state)[1]))
        bn.append(np.concatenate([sd[k] for k in skeys]))
        if i == 0:
            grads = dict(keystr_items(rec_model.crnn_params_to_jax(
                _tree_map(lambda t: t.grad, params), state)[0]))
    after = dict(keystr_items(rec_model.crnn_params_to_jax(params, state)[0]))
    norms, sample = _leaf_stats(grads, fix["param_keys"], fix["sample_idx"])
    return {"losses": torch.stack(losses).cpu().numpy(), "grad_norms": norms,
            "grad_sample": sample, "bn1": bn[0], "bn3": bn[-1], "grads": grads,
            "step_norms": np.array([np.linalg.norm((after[k] - start[k]).astype(np.float64))
                                    for k in map(str, fix["param_keys"])])}


def textness_train_run(fix, device, steps=3):
    """The port's textness ``make_train_step`` from the bundled head on the
    fixture's 8 pages, ``steps`` steps of ``train``'s optimizer and schedule
    at ``steps=3``: the numbers the fixture stores, keyed as there."""
    params = ttex.load_textness()
    start = dict(keystr_items(ttex.textness_params_to_jax(params)))
    params = _copy_to(params, device)
    opt = rec_train.make_optimizer(params)
    step = ttex.make_train_step(device=device)
    schedule = rec_train.cosine_decay(TX_TRAIN_LR, 3)
    x, y = ttex.pages_to_batch(fix["pages"], fix["masks"], device)
    losses = []
    for i in range(steps):
        params, loss = step(params, opt, x, y, schedule(i))
        losses.append(loss)
        if i == 0:
            grads = dict(keystr_items(ttex.textness_params_to_jax(
                _tree_map(lambda t: t.grad, params))))
    after = dict(keystr_items(ttex.textness_params_to_jax(params)))
    norms, sample = _leaf_stats(grads, fix["tx_keys"], fix["tx_sample_idx"])
    return {"losses": torch.stack(losses).cpu().numpy(), "grad_norms": norms,
            "grad_sample": sample, "grads": grads, "labels": y[:, 0].cpu().numpy(),
            "step_norms": np.array([np.linalg.norm((after[k] - start[k]).astype(np.float64))
                                    for k in map(str, fix["tx_keys"])])}


# Phase 23's tolerances, as phase 21's (``TRAIN_TOLS``): each step-1 number is
# held to the fixture's float64 step (``*_exact_*``) and to JAX's within JAX's
# own distance from it plus the tolerance. XLA's CPU reductions add one
# element after another, and E[x²] − E[x]² over a b64 32×256 BatchNorm
# amplifies that: JAX's step-1 gradients are up to 1.3% of a leaf's norm from
# exact (``['bn'][1]['scale']``), its loss 1.3e-4 from exact, its BN state
# 1.7e-5; the port's on the CPU 6.0e-4, 3.8e-7 and 9.9e-8. So JAX's own
# trajectory leaves the exact one, and the later steps are held to JAX's
# more loosely. "loss": step 1 relative to exact; "later": steps 2 and 3
# relative to JAX's (9.3e-4 for the recognizer on the CPU); "grad": a leaf's
# norm and its 16 sampled elements, relative to the leaf's exact norm (the
# lines' flat paper background ties pool windows and sets ReLUs near 0, so
# the activations' last bit routes a float32 gradient; on the segmenter that
# was 8.3e-3); "bn1"/"bn3": relative ‖·‖ of the BN running statistics after
# steps 1 (to exact) and 3 (to JAX's: 1.6e-4 on the CPU); "step": a leaf's
# step norm after 3 steps relative to JAX's (Adam's ±lr steps, but for
# near-0 gradients), the kernels' (and the textness head's biases'); the
# recognizer's 1-D leaves' step norms are held to Adam's bound 3·lr·√n;
# "bias": the norm of a pre-BN conv bias's gradient (exactly 0) relative to
# its kernel's exact one. The textness head has no BatchNorm.
OCR_TRAIN_TOLS = {
    "rec": dict(loss=1e-5, later=3e-3, grad=2e-2, bn1=1e-5, bn3=1e-3, step=1e-2, bias=1e-3),
    "tx": dict(loss=1e-5, later=1e-3, grad=1e-3, step=1e-3),
}


def crnn_pre_bn_bias(key):
    """A CRNN bias that train-mode BatchNorm follows: its exact gradient is 0."""
    return key.startswith(("['conv']", "['ctx']")) and key.endswith("['bias']")


def ocr_train_parity(fix, tag, got):
    """Hold one model's numbers (``tag`` "rec": :func:`ocr_train_run`, "tx":
    :func:`textness_train_run`) to the fixture's with ``OCR_TRAIN_TOLS[tag]``;
    print each leaf's gradient and step norms beside JAX's and the exact
    gradient norm, then the losses and each check's worst case. → the
    failures (empty: it passed)."""
    tol = OCR_TRAIN_TOLS[tag]
    fails = []
    jl, exact_loss = fix[f"{tag}_losses"], float(fix[f"{tag}_exact_loss"])
    lerr = abs(float(got["losses"][0]) - exact_loss) / exact_loss
    ljax = abs(float(got["losses"][0]) - float(jl[0])) / float(jl[0])
    lown = abs(float(jl[0]) - exact_loss) / exact_loss
    if lerr > tol["loss"] or ljax > lown * 1.01 + tol["loss"]:
        fails.append(f"step 1 loss {got['losses'][0]:.8f} vs exact {exact_loss:.8f}, "
                     f"JAX {jl[0]:.8f}")
    for i, (a, b) in enumerate(zip(got["losses"][1:], jl[1:]), 2):
        if abs(a - b) > tol["later"] * b:
            fails.append(f"step {i} loss {a:.8f} vs JAX {b:.8f}")
    keys = [str(k) for k in fix["param_keys" if tag == "rec" else "tx_keys"]]
    ex, jn, gn = fix[f"{tag}_exact_grad_norms"], fix[f"{tag}_grad_norms"], got["grad_norms"]
    es, js, gs = (fix[f"{tag}_exact_grad_sample"], fix[f"{tag}_grad_sample"],
                  got["grad_sample"])
    worst = {"grad": (0.0, ""), "step": (0.0, "")}
    rows = []
    for i, key in enumerate(keys):
        step, jstep = got["step_norms"][i], fix[f"{tag}_step_norms"][i]
        rows.append(f"    {tag} {key:24s} grad {gn[i]:.5e} JAX {jn[i]:.5e} exact "
                    f"{ex[i]:.5e} | step {step:.5e} JAX {jstep:.5e}")
        if tag == "rec" and crnn_pre_bn_bias(key):
            kern = ex[keys.index(key.replace("['bias']", "['kernel']"))]
            if gn[i] > tol["bias"] * kern:
                fails.append(f"{key}: gradient norm {gn[i]:.3e} (exactly 0)")
            continue
        err = max(abs(gn[i] - ex[i]), np.abs(gs[i] - es[i]).max()) / ex[i]
        jerr = max(abs(jn[i] - ex[i]), np.abs(js[i] - es[i]).max()) / ex[i]
        vs_jax = max(abs(gn[i] - jn[i]), np.abs(gs[i] - js[i]).max()) / ex[i]
        if err > tol["grad"] + jerr or vs_jax > jerr * 1.01 + tol["grad"]:
            fails.append(f"{key}: gradient {err:.3e} from exact, {vs_jax:.3e} from JAX "
                         f"(JAX {jerr:.3e} from exact)")
        worst["grad"] = max(worst["grad"], (err, key))
        if tag == "tx" or key.endswith("['kernel']"):
            rel = abs(step - jstep) / jstep
            worst["step"] = max(worst["step"], (rel, key))
            if rel > tol["step"]:
                fails.append(f"{key}: step norm {step:.4e} vs JAX {jstep:.4e}")
        elif step > 3.03 * OCR_TRAIN_LR * np.sqrt(got["grads"][key].size):
            fails.append(f"{key}: step norm {step:.4e} above Adam's bound")
    line = (f"  {tag}: losses {np.round(got['losses'].astype(np.float64), 8).tolist()} vs JAX "
            f"{np.round(jl.astype(np.float64), 8).tolist()} (exact step 1 {exact_loss:.8f}); "
            f"step-1 gradient worst {worst['grad'][0]:.2e} of its norm from exact "
            f"({worst['grad'][1]}); step norms worst {worst['step'][0]:.2e} from JAX's "
            f"({worst['step'][1]})")
    if tag == "rec":
        bn1_exact = rel_dist(got["bn1"], fix["rec_exact_bn1"])
        bn1_jax = rel_dist(got["bn1"], fix["rec_bn1"])
        bn1_own = rel_dist(fix["rec_bn1"], fix["rec_exact_bn1"])
        bn3 = rel_dist(got["bn3"], fix["rec_bn3"])
        if bn1_exact > tol["bn1"] + bn1_own or bn1_jax > bn1_own * 1.01 + tol["bn1"]:
            fails.append(f"BN state after step 1: {bn1_exact:.3e} from exact, "
                         f"{bn1_jax:.3e} from JAX (JAX {bn1_own:.3e} from exact)")
        if bn3 > tol["bn3"]:
            fails.append(f"BN state after step 3: {bn3:.3e} from JAX")
        line += (f"; BN after step 1 {bn1_exact:.2e} from exact, {bn1_jax:.2e} from JAX "
                 f"(JAX {bn1_own:.2e}); after step 3 {bn3:.2e}")
    print("\n".join(rows) + "\n" + line, flush=True)
    return fails


def ocr_eval_check(fix, device):
    """``evaluate`` and the greedy texts of the bundled recognizer on the
    fixture's eval batch: each text equal to JAX's unless its line has a
    frame whose top-1/top-2 gap is at most ``OCR_NEAR_TIE``; exact-match and
    CER equal to JAX's when every text is. → (texts differing, near-tie
    lines, exact, cer)."""
    params, state, charset, arch = rec_model.load_crnn_weights()
    params, state = _copy_to(params, device), _copy_to(state, device)
    texts = rec_train.greedy_texts(params, state, lines_to_tensor(fix["eval_lines"], device),
                                   charset, arch)
    exact, cer = rec_train.evaluate(params, state, [(fix["eval_lines"], fix["eval_texts"])],
                                    charset, arch, device=device)
    near = (fix["eval_gap"] <= OCR_NEAR_TIE).any(axis=1)
    diff = [i for i, (a, b) in enumerate(zip(texts, fix["eval_greedy"])) if a != str(b)]
    if any(not near[i] for i in diff):
        raise AssertionError(f"greedy texts differ from JAX's away from near-ties at "
                             f"{[(i, texts[i], str(fix['eval_greedy'][i])) for i in diff]}")
    if not diff and (exact, cer) != (float(fix["eval_exact"]), float(fix["eval_cer"])):
        raise AssertionError(f"evaluate: exact {exact}, cer {cer}; JAX's "
                             f"{float(fix['eval_exact'])}, {float(fix['eval_cer'])}")
    return len(diff), int(near.sum()), exact, cer


def ctc_infeasible_check(device):
    """``ctc_loss`` on crafted t32 rows (T = 32) whose labels do not fit the
    frames (23 chars with doubled letters, 24 repeats of one char), beside
    feasible ones, against its plain version: the losses within 1e-6 of
    theirs relative, finite, and the gradients within 1e-3 of their norm
    (the plain recursion runs at ε ≈ −1e5, where float32 keeps 3 decimals).
    → (infeasible rows, max relative loss error, max gradient error)."""
    g = torch.Generator().manual_seed(5)
    logits = torch.randn((6, 32, 420), generator=g).to(device)
    rows = ["AABBCCDDEEFFGGHHIIJJKKL", "A" * 24, "JJ-12345678", "AB12345678",
            "OO0O0I1SS5BB8", "ZZ22QQ" * 3]
    labels, pad, _ = encode_labels(rows, rec_charset.cjk_charset())
    infeasible = int((~rec_train.ctc_feasible(labels, pad, 32)).sum())
    a = logits.clone().requires_grad_()
    b = logits.clone().requires_grad_()
    la = rec_train.ctc_loss(a, labels, pad)
    lb = rec_train.ctc_loss_plain(b, labels, pad)
    la.mean().backward()
    lb.mean().backward()
    loss_err = float(((la - lb).abs() / lb.abs()).max().detach())
    grad_err = float((a.grad - b.grad).norm() / b.grad.norm())
    if infeasible < 2 or not torch.isfinite(la).all() or loss_err > 1e-6 or grad_err > 1e-3:
        raise AssertionError(f"ctc_loss on infeasible rows: {infeasible} infeasible, losses "
                             f"{la.tolist()} vs plain {lb.tolist()}, gradient {grad_err:.3e}")
    return infeasible, loss_err, grad_err


def phase_ocr_train_parity(card):
    """Phase 23: the port's recognizer and textness train steps against the
    JAX trainers' numbers, the bundled recognizer's greedy texts, and
    ``ctc_loss`` on infeasible rows."""
    fix = ocr_train_fixture()
    device = torch.device("cuda")
    print("  no kernel of the port on this path: cuDNN's convs, cuBLAS, PyTorch's CTC and "
          "plain PyTorch, as the JAX trainers are plain XLA", flush=True)
    fails = []
    with tf32_off():
        fails += [f"rec: {f}" for f in ocr_train_parity(fix, "rec", ocr_train_run(fix, device))]
        tx = textness_train_run(fix, device)
        if not np.array_equal(tx["labels"], fix["page_labels"]):
            fails.append("textness labels differ from JAX's")
        fails += [f"tx: {f}" for f in ocr_train_parity(fix, "tx", tx)]
        ndiff, near, exact, cer = ocr_eval_check(fix, device)
        infeasible, lerr, gerr = ctc_infeasible_check(device)
    print(f"  bundled recognizer on the eval batch: greedy texts equal to JAX's on "
          f"{len(fix['eval_greedy']) - ndiff} of {len(fix['eval_greedy'])} lines ({near} with "
          f"a near-tie frame); exact {exact:.4f} cer {cer:.4f}, JAX {float(fix['eval_exact']):.4f} "
          f"{float(fix['eval_cer']):.4f}", flush=True)
    print(f"  ctc_loss on {infeasible} infeasible t32 rows beside feasible ones: losses within "
          f"{lerr:.2e} of the plain recursion's, gradients within {gerr:.2e} [{card}]",
          flush=True)
    if fails:
        raise AssertionError("OCR training parity:\n" + "\n".join(fails))


def textness_layers(params, b, hw):
    """The textness head's convs for ``b`` pages of ``hw``² → [(name,
    params, input shape, multiply-adds)]."""
    layers, h = [], hw
    for i, p in enumerate(params):
        co, ci, kh, kw = p["weight"].shape
        out = h // 2 if i < 2 else h
        layers.append((f"l{i}", p, (b, ci, h, h), b * out * out * co * ci * kh * kw))
        h = out
    return layers


def recognizer_speed(fix, card):
    """Phase 24's recognizer step at b64 t64 fp32 (TF32 off) on the fixture's
    batch 0 from the bundled weights, beside its bound; the losses must
    fall."""
    device = torch.device("cuda")
    params, state, _, arch = rec_model.load_crnn_weights()
    params, state = _copy_to(params, device), _copy_to(state, device)
    opt = rec_train.make_optimizer(params)
    step = rec_train.make_train_step(arch, device=device)
    x = lines_to_tensor(fix["lines"], device)
    box = [params, state]

    def one():
        box[0], box[1], loss = step(box[0], box[1], opt, x, fix["labels"], fix["label_pad"],
                                    OCR_TRAIN_LR)
        return loss

    ms, peak, losses = timed_steps(one)
    n = x.shape[0]
    layers, _ = ocr_layers(params, arch, n)
    bound, by, flops = step_bound_ms(sum(lay[-1] for lay in layers), layers[0][-1],
                                     param_count(params), x.numel() * 4)
    print(f"  recognizer {arch} b{n} 32x256 fp32 (TF32 off), {param_count(params)} params, "
          f"{params['head']['weight'].shape[0]} classes: {ms:.3f} ms a step "
          f"(median of {TRAIN_TIMED}), {1e3 * n / ms:.1f} lines/s; bound {bound:.3f} ms by {by} "
          f"({flops / 1e9:.1f} GFLOP at 67 TFLOP/s), {bound / ms:.3f} of it reached; peak "
          f"memory {peak:.3f} GiB [{card}]", flush=True)
    print(f"    losses {np.round(losses.astype(np.float64), 6).tolist()}", flush=True)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"recognizer losses do not fall: {losses.tolist()}")
    train_step_kinds(one, ms)
    return ms, bound


def recognizer_train_serve(fix, tmp, card, device, steps=OCR_TRAIN_STEPS):
    """``train()`` for ``steps`` steps from the bundled weights
    (``resume_from``) over the fixture's pool, saved with ``save_weights``,
    loaded into ``TorchOcrEngine(weights_dir=...)`` and read on phase 17's
    fixture crops: the texts equal to an engine's built from the in-memory
    params. → how many differ from the bundled weights' (JAX's) texts."""
    from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine

    charset = rec_charset.Charset(str(fix["charset"]))
    out = os.path.join(tmp, "recognizer.npz")
    t = time.perf_counter()
    params, state, metrics = rec_train.train(
        out, steps=steps, batches=(fix["lines"], fix["labels"], fix["label_pad"]),
        eval_batches=[(fix["eval_lines"], [str(s) for s in fix["eval_texts"]])],
        charset=charset, resume_from=rec_model.DEFAULT_WEIGHTS_PATH,
        log=lambda m: print("   ", m, flush=True), device=device)
    train_s = time.perf_counter() - t
    ocr = ocr_fixture()
    crops, modes = ocr["crop_list"], [str(m) for m in ocr["crop_modes"]]
    saved = TorchOcrEngine(weights_dir=out, device=device)
    if not saved.available() or saved.arch != "t64" or saved.charset.chars != charset.chars:
        raise AssertionError(f"the saved recognizer does not load: {out}")
    live = TorchOcrEngine(params=params, state=state, charset=charset, arch="t64",
                          device=device)
    got = [r.text for r in saved.read_batch(crops, modes=modes)]
    want = [r.text for r in live.read_batch(crops, modes=modes)]
    if got != want:
        raise AssertionError(f"the saved weights read {got}, the in-memory ones {want}")
    bundled = [str(t) for t in ocr["text_cascade"]]
    ndiff = sum(a != b for a, b in zip(got, bundled))
    print(f"  train() {steps} steps from the bundled weights on the fixture pool: "
          f"{train_s:.2f} s, eval exact {metrics['exact']:.4f} cer {metrics['cer']:.4f}; saved "
          f"{os.path.getsize(out) / 2 ** 20:.2f} MiB, served by TorchOcrEngine: {len(got)} "
          f"crops read as by the in-memory params, {ndiff} differ from the bundled weights' "
          f"texts [{card}]", flush=True)
    return ndiff


def textness_speed(fix, card):
    """Phase 24's textness step at b32 256² (the fixture's 8 pages tiled),
    beside its bound. → (ms, bound ms, the trained params)."""
    device = torch.device("cuda")
    reps = TX_BATCH // len(fix["pages"])
    pages, masks = np.tile(fix["pages"], (reps, 1, 1)), np.tile(fix["masks"], (reps, 1, 1))
    params = _copy_to(ttex.load_textness(), device)
    opt = rec_train.make_optimizer(params)
    step = ttex.make_train_step(device=device)
    x, y = ttex.pages_to_batch(pages, masks, device)
    schedule = rec_train.cosine_decay(TX_TRAIN_LR, TRAIN_WARMUP + TRAIN_TIMED)
    count = [0]

    def one():
        _, loss = step(params, opt, x, y, schedule(count[0]))
        count[0] += 1
        return loss

    ms, peak, losses = timed_steps(one)
    layers = textness_layers(params, x.shape[0], x.shape[2])
    bound, by, flops = step_bound_ms(sum(lay[-1] for lay in layers), layers[0][-1],
                                     param_count(params), x.numel() * 4 + y.numel() * 4)
    print(f"  textness head b{x.shape[0]} {x.shape[2]}^2 fp32 (TF32 off), "
          f"{param_count(params)} params: {ms:.3f} ms a step (median of {TRAIN_TIMED}), "
          f"{1e3 * x.shape[0] / ms:.1f} pages/s; bound {bound:.3f} ms by {by} "
          f"({flops / 1e9:.1f} GFLOP at 67 TFLOP/s), {bound / ms:.3f} of it reached; peak "
          f"memory {peak:.3f} GiB [{card}]", flush=True)
    print(f"    losses {np.round(losses.astype(np.float64), 6).tolist()}", flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError(f"textness losses {losses.tolist()}")
    train_step_kinds(one, ms)
    return ms, bound, params


def textness_save_serve(fix, tmp, params, device):
    """``save_textness``, ``load_textness`` and ``textness_map`` on a page
    from the loaded and the in-memory params: equal."""
    path = os.path.join(tmp, "textness.npz")
    ttex.save_textness(path, params)
    loaded = _copy_to(ttex.load_textness(path), device)
    page = fix["pages"][0]
    a = ttex.textness_map(page, loaded, device=device)
    b = ttex.textness_map(page, params, device=device)
    if a.shape != page.shape or a.dtype != bool or not np.array_equal(a, b):
        raise AssertionError("textness_map from the saved head differs from the in-memory one")
    print(f"  save_textness, load_textness, textness_map on a {page.shape} page: equal to the "
          f"in-memory head's ({int(a.sum())} text pixels)", flush=True)


def phase_ocr_train_speed(card):
    """Phase 24: the recognizer's and the textness head's train steps timed,
    ``train()`` saved and served."""
    import tempfile

    fix = ocr_train_fixture()
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    device = torch.device("cuda")
    with tf32_off(), tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp:
        rec = recognizer_speed(fix, card)
        recognizer_train_serve(fix, tmp, card, device)
        *tx, params = textness_speed(fix, card)
        textness_save_serve(fix, tmp, params, device)
    return rec, tuple(tx)


# -- phase 25: data, tensor, spatial and pipeline parallelism -------------------


PAR_RANKS = 2           # gloo ranks on the one card
PAR_TIMEOUT_S = 60      # every collective's
PAR_DEADLINE_S = 400    # the ranks' whole run
# each mesh with the number of steps timed after its held one (a model=2 step
# all-reduces ~4.4 GB of activations and input gradients through gloo: 5-7 s
# on an H100)
PAR_MESHES = (("data", MeshConfig(data=2), 3), ("model", MeshConfig(data=1, model=2), 1),
              ("spatial", MeshConfig(data=1, spatial=2), 3))
PAR_TIMED = 3           # timed forwards and one-rank steps
SPATIAL_TOL = 2e-4      # JAX's (tests/distributed/test_spatial.py), atol and rtol
PIPE_TOL, PIPE_ID_TOL = 1e-5, 1e-6   # JAX's (tests/distributed/test_pipeline.py)
BLOCKED = ("jax", "jaxlib", "twinvoice_tpu")


def _rank_entry(rank, world, workdir, fn, threads):
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    try:
        args = torch.load(os.path.join(workdir, "args.pt"), weights_only=False)
        result = fn(rank, world, *args)
        loaded = sorted(m for m, v in sys.modules.items()
                        if v is not None and m.split(".")[0] in BLOCKED)
        if loaded:
            raise AssertionError(f"rank {rank} imported {loaded}")
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, workdir, args, *, threads=1, deadline=PAR_DEADLINE_S):
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined into a
    gloo group over a ``file://`` store in the new directory
    ``workdir`` (every collective times out after ``PAR_TIMEOUT_S``); → their
    results in rank order. Raises with a failed rank's traceback, or when the
    ranks outlast ``deadline`` seconds, after killing them all. The arguments
    go through a file: a pipe's worth of them would hold each spawn until the
    process before it has started. ``spawn``, because the caller may hold a
    CUDA context, which a forked child cannot use."""
    os.makedirs(workdir)
    torch.save(args, os.path.join(workdir, "args.pt"))
    ctx = torch.multiprocessing.start_processes(
        _rank_entry, args=(world, workdir, fn, threads), nprocs=world, join=False,
        start_method="spawn")
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.1)):
            if time.monotonic() >= end:
                raise TimeoutError(f"{fn.__name__} on {world} ranks outlasted {deadline} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(5)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def par_frame(fix):
    """One 1024×1024 camera-size frame: the fixture's four 512² pages in a
    2×2 mosaic, → (1, 3, 1024, 1024) uint8."""
    p = fix["pages"]
    frame = np.concatenate([np.concatenate(p[:2], 1), np.concatenate(p[2:], 1)], 0)
    return torch.from_numpy(np.ascontiguousarray(frame.transpose(2, 0, 1)[None]))


def device_ms(fn, iters, device):
    """Mean ms of ``iters`` calls of ``fn()`` after one: CUDA events on a
    card, the host clock on the CPU (a rehearsal there)."""
    if device.type == "cuda":
        return cuda_ms(fn, iters, warmup=1)
    fn()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t) / iters


def par_step(variant, fix, device, mesh=None, *, timed=PAR_TIMED):
    """One SGD step (lr 1e-3: its update is linear in the gradient) of the
    bundled ``variant`` on the fixture's b4 batch, on ``mesh`` (every rank
    calls it) or alone, then ``timed`` more. → ({"loss", "grads", "bn"}
    whole, on the CPU, of the first step; the mean ms of the others, or
    None)."""
    mcfg = VARIANTS[variant][1]
    params, state = (_copy_to(t, device) for t in load_npz(variant_path(variant)))
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    ts = TrainState(params, state, torch.optim.SGD(leaves, lr=TRAIN_LR))
    if mesh is not None:
        ts = shard_train_state(ts, mesh)
    step = make_train_step(mcfg, TrainConfig(), device=device, mesh=mesh)
    x, y = train_batch(fix, torch.float32, device)
    box = [ts.params, ts.bn_state]

    def one():
        box[0], box[1], loss = step(box[0], box[1], ts.optimizer, x, y, TRAIN_LR)
        return loss

    loss = float(one())
    grads = _tree_map(lambda t: t.grad.detach().clone(), box[0])
    bn = box[1]
    if mesh is not None and ts.shardings is not None:
        grads = gather_tree(grads, mesh, ts.shardings["params"])
        bn = gather_tree(bn, mesh, ts.shardings["bn_state"])
    held = {"loss": loss, "grads": _copy_to(grads, "cpu"), "bn": _copy_to(bn, "cpu")}
    return held, device_ms(one, timed, device) if timed else None


def par_compare(ref, got):
    """A step's numbers against the one-rank step's, as phase 21 holds two
    trainers (``TRAIN_TOLS["fp32"]``): the loss (relative), each gradient
    (‖·‖ of the difference relative to the one-rank gradient's norm; a pre-BN
    conv bias's, exactly 0, relative to its kernel's), the new BN running
    statistics (relative ‖·‖, the ``bn1`` tolerance). → (line, failures)."""
    tol = TRAIN_TOLS["fp32"]
    fails = []
    dl = abs(got["loss"] - ref["loss"]) / ref["loss"]
    if dl > tol["loss"]:
        fails.append(f"loss {got['loss']:.8f} vs {ref['loss']:.8f}")
    rg, gg = dict(keystr_items(ref["grads"])), dict(keystr_items(got["grads"]))
    worst = (0.0, "")
    for key, want in rg.items():
        have = gg[key].numpy()
        if pre_bn_bias(key):
            kern = np.linalg.norm(rg[key.replace("['bias']", "['weight']")].numpy())
            if np.linalg.norm(have) > tol["bias"] * kern:
                fails.append(f"{key}: gradient norm {np.linalg.norm(have):.3e} (exactly 0)")
            continue
        err = rel_dist(have, want.numpy())
        worst = max(worst, (err, key))
        if err > tol["grad"]:
            fails.append(f"{key}: gradient {err:.3e} from the one-rank step's")
    rb = dict(keystr_items(ref["bn"]))
    bn = rel_dist(np.concatenate([t.numpy().ravel() for _, t in sorted(keystr_items(got["bn"]))]),
                  np.concatenate([rb[k].numpy().ravel() for k in sorted(rb)]))
    if bn > tol["bn1"]:
        fails.append(f"BN state {bn:.3e} from the one-rank step's")
    line = (f"loss {got['loss']:.8f} vs {ref['loss']:.8f} ({dl:.2e}); gradients worst "
            f"{worst[0]:.2e} of their norm ({worst[1]}); BN state within {bn:.2e}")
    return line, fails


def pipeline_cases(device):
    """JAX's pipeline cases on ``PAR_RANKS`` stages (no JAX here: the
    tower's weights from numpy): the tanh tower (dim 16, 6 microbatches of
    2) against the sequential run, the identity of a ×2 and a ×0.5 stage.
    → (worst |Δ| of each)."""
    mesh = Mesh(("stage",), (PAR_RANKS,), timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    rng = np.random.default_rng(0)
    tower = [{"w": torch.tensor(rng.standard_normal((16, 16)) * 0.3, dtype=torch.float32,
                                device=device), "b": torch.zeros(16, device=device)}
             for _ in range(PAR_RANKS)]
    x = torch.tensor(rng.standard_normal((6, 2, 16)), dtype=torch.float32, device=device)
    seq = x
    for p in tower:
        seq = torch.tanh(seq @ p["w"] + p["b"])
    got = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                         stack_stage_params(tower), x, mesh)
    ident = [{"w": torch.eye(8, device=device) * 2.0}, {"w": torch.eye(8, device=device) * 0.5}]
    xi = torch.tensor(rng.standard_normal((3, 8)), dtype=torch.float32, device=device)
    out = pipeline_apply(lambda p, h: h @ p["w"], stack_stage_params(ident), xi, mesh)
    return float((got - seq).abs().max()), float((out - xi).abs().max())


def gloo_cuda_probe(device):
    """Which collectives gloo runs on ``device``'s tensors: each on a group
    of its own with a 10 s timeout (a rank whose peer raised times out
    there). → {name: "ok" or the error's first line}. Not ``send``/``recv``:
    on CUDA tensors gloo writes from device memory (``writev: Bad
    address``), and where its transport thread does the write the error
    aborts the process (four of seven runs of phase 25 on an H100)."""
    out = {}
    ops = {
        "all_reduce": lambda g, t: dist.all_reduce(t, group=g),
        "broadcast": lambda g, t: dist.broadcast(t, 0, group=g),
        "all_gather": lambda g, t: dist.all_gather([torch.empty_like(t) for _ in
                                                    range(PAR_RANKS)], t, group=g),
        "all_to_all_single": lambda g, t: dist.all_to_all_single(torch.empty_like(t), t,
                                                                 group=g),
    }
    for name, op in ops.items():
        group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=10))
        try:
            op(group, torch.ones(4, device=device))
            if device.type == "cuda":
                torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # the probe reports what raised; nothing depends on it
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"
    return out


def par_rank(rank, world, workdir, device, variant):
    """Phase 25 on one of ``PAR_RANKS`` gloo ranks sharing the card: cases
    (a)-(e) (see :func:`phase_parallel`), then the gloo probe. Rank 0 holds
    each result to the one-rank numbers in ``workdir/ref.pt``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    fix = train_fixture()
    ref = torch.load(os.path.join(workdir, "ref.pt"), weights_only=True)
    mcfg = VARIANTS[variant][1]
    out = {}
    with tf32_off():
        for name, cfg, timed in PAR_MESHES:
            mesh = make_mesh(cfg)
            got, ms = par_step(variant, fix, device, mesh, timed=timed)
            out[name] = (par_compare(ref, got) if rank == 0 else None, ms)
            if name == "data":
                # (a) one AdamW step, then fit for 2 epochs from the bundled weights
                params, bn = (_copy_to(t, device) for t in load_npz(variant_path(variant)))
                ts = shard_train_state(TrainState(params, bn, make_optimizer(
                    params, TrainConfig())), mesh)
                x, y = train_batch(fix, torch.float32, device)
                *_, loss = make_train_step(mcfg, TrainConfig(), device=device, mesh=mesh)(
                    ts.params, ts.bn_state, ts.optimizer, x, y, TRAIN_LR)
                out["adamw"] = (float(loss), all(bool(torch.isfinite(t).all())
                                                 for t in tree_leaves(ts.params)))
                del ts, params, bn
                cfg_fit = Config(model=mcfg, train=TrainConfig(
                    epochs=2, checkpoint_dir=os.path.join(workdir, "fit", "ckpt"),
                    visualize_dir=os.path.join(workdir, "fit", "vis")))
                t = time.perf_counter()
                hist = fit(ArrayDataset(fix["pages"], fix["masks"]), cfg_fit, mesh=mesh,
                           device=device, resume_dir=os.path.join(workdir, "start"),
                           log=lambda m: print(f"    rank {rank}:", m, flush=True))[1]
                out["fit"] = ([r["loss"] for r in hist], time.perf_counter() - t)
            if name == "spatial":
                # (d) the folded model H-sharded on the 1024² frame
                folded = fold_unet(*load_npz(variant_path(variant)), cfg=mcfg, device=device)
                frame = normalize_uint8(par_frame(fix).to(device), torch.float32)
                with torch.no_grad():
                    logits = spatial_unet_forward(folded, frame, mesh)
                    ms = device_ms(lambda: spatial_unet_forward(folded, frame, mesh),
                                   PAR_TIMED, device)
                out["serve"] = (logits.cpu() if rank == 0 else None, ms)
                del folded, frame, logits
            if device.type == "cuda":
                torch.cuda.empty_cache()  # the card is shared with the other rank
        out["pipeline"] = pipeline_cases(device)
    out["probe"] = gloo_cuda_probe(device)
    return out


def nccl_world1(ref, variant, fix, device, workdir):
    """(f) NCCL at world size 1, the one NCCL group a one-card machine has:
    the collectives of ``core.collectives`` on its group (all exact at one
    rank, forward and backward) and the data-parallel step on
    ``make_mesh(MeshConfig(data=1))`` against the one-rank step. → the
    comparison's line."""
    dist.init_process_group("nccl", init_method=f"file://{workdir}/nccl_store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    try:
        ax = Axis("world", 1, 0, dist.group.WORLD)
        x = torch.randn(2, 6, 5, device=device, requires_grad=True)
        g = torch.randn(2, 6, 5, device=device)
        for name, fn in (("sum_over", lambda t: sum_over(t, ax)),
                         ("copy_to", lambda t: copy_to(t, ax)),
                         ("gather_from", lambda t: gather_from(t, ax, 1)),
                         ("halo gather", lambda t: gather_from(t, ax, 1, sum_grads=True))):
            y = fn(x)
            (gx,) = torch.autograd.grad(y, x, g)
            if not (torch.equal(y, x) and torch.equal(gx, g)):
                raise AssertionError(f"{name} under NCCL at world size 1 is not exact")
        with tf32_off():
            got, _ = par_step(variant, fix, device, make_mesh(MeshConfig(data=1)), timed=0)
        line, fails = par_compare(ref, got)
    finally:
        dist.destroy_process_group()
    if fails:
        raise AssertionError("NCCL world size 1 step:\n" + "\n".join(fails))
    return line


def phase_parallel(card, device="cuda", variant="w64"):
    """Phase 25: the bundled ``variant`` trained and served across ranks.
    Two gloo ranks share the card (NCCL refuses two ranks on one device):
    (a) ``data=2``: one SGD step against the one-rank step, one AdamW step,
    ``fit(mesh)`` for 2 epochs of one step from the bundled weights; (b)
    ``model=2`` and (c) ``spatial=2``: the same SGD step; (d) the folded model
    H-sharded over the two ranks on a 1024² frame against the dense forward;
    (e) the GPipe schedule on 2 stages; (f) NCCL at world size 1. Then
    rank 0's ``fit`` checkpoint served through K1 against the plain path.
    → K1's launches there."""
    import tempfile

    device = torch.device(device)
    fix = train_fixture()
    mcfg = VARIANTS[variant][1]
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp:
        with tf32_off():
            ref, plain_ms = par_step(variant, fix, device)
            torch.save(ref, os.path.join(tmp, "ref.pt"))
            folded = fold_unet(*load_npz(variant_path(variant)), cfg=mcfg, device=device)
            frame = normalize_uint8(par_frame(fix).to(device), torch.float32)
            with torch.no_grad():
                dense = unet_apply_folded(folded, frame)
                dense_ms = device_ms(lambda: unet_apply_folded(folded, frame), PAR_TIMED,
                                     device)
            dense = dense.cpu()
            del folded, frame
        params, state = load_npz(variant_path(variant))
        ckpt.save(os.path.join(tmp, "start"),
                  TrainState(params, state, make_optimizer(params, TrainConfig())))
        del params, state
        if device.type == "cuda":
            # the ranks share the card with this process, whose allocator
            # still caches the earlier phases' blocks: a rank ran out of
            # memory creating its cuBLAS handle after phases 1-24
            gc.collect()
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info()
            print(f"  before the ranks: {free / 2 ** 30:.1f} of {total / 2 ** 30:.1f} GiB free "
                  f"on the card", flush=True)
        t = time.perf_counter()
        ranks = run_ranks(par_rank, PAR_RANKS, os.path.join(tmp, "ranks"),
                          (os.path.join(tmp), str(device), variant), threads=2)
        ranks_s = time.perf_counter() - t
        r0 = ranks[0]
        fails = []
        print(f"  {PAR_RANKS} gloo ranks on one {device.type} device, {variant} b4 512^2 "
              f"fp32 (TF32 off), {ranks_s:.2f} s for (a)-(e); one-rank SGD step "
              f"{plain_ms:.3f} ms [{card}]", flush=True)
        for case, (name, _, timed) in zip("abc", PAR_MESHES):
            (line, f), ms = r0[name]
            print(f"  ({case}) {name}=2 SGD step: {line}; {ms:.3f} ms a step (mean of "
                  f"{timed}) beside the one-rank {plain_ms:.3f} ms", flush=True)
            fails += [f"{name}=2: {x}" for x in f]
        adamw_loss, finite = r0["adamw"]
        fit_losses, fit_s = r0["fit"]
        print(f"  (a) AdamW step on data=2: loss {adamw_loss:.8f}, params finite {finite}; "
              f"fit(mesh) 2 epochs of one step from the bundled weights: losses "
              f"{np.round(fit_losses, 6).tolist()} in {fit_s:.2f} s", flush=True)
        if not (np.isfinite(adamw_loss) and finite):
            fails.append("the AdamW step is not finite")
        if abs(fit_losses[0] - ref["loss"]) > TRAIN_TOLS["fp32"]["loss"] * ref["loss"]:
            fails.append(f"fit(mesh) epoch 1 loss {fit_losses[0]:.8f} is not the bundled "
                         f"weights' {ref['loss']:.8f}")
        logits, spatial_ms = r0["serve"]
        err = float((logits - dense).abs().max())
        ok = torch.allclose(logits, dense, atol=SPATIAL_TOL, rtol=SPATIAL_TOL)
        print(f"  (d) spatial_unet_forward on the 1024^2 frame over 2 ranks: max |diff| "
              f"{err:.3e} from the dense forward (atol=rtol {SPATIAL_TOL:g}); {spatial_ms:.3f} "
              f"ms beside the dense {dense_ms:.3f} ms", flush=True)
        if not ok:
            fails.append(f"spatial forward {err:.3e} from the dense one")
        tower, ident = r0["pipeline"]
        print(f"  (e) pipeline_apply on 2 stages: tanh tower {tower:.2e} from the sequential "
              f"run (tol {PIPE_TOL:g}); identity {ident:.2e} (tol {PIPE_ID_TOL:g})", flush=True)
        if tower > PIPE_TOL or ident > PIPE_ID_TOL:
            fails.append(f"pipeline: tower {tower:.3e}, identity {ident:.3e}")
        for rank, r in enumerate(ranks):
            print(f"  gloo on 4-float {device.type} tensors, rank {rank}: {r['probe']}",
                  flush=True)
        if device.type == "cuda":
            line = nccl_world1(ref, variant, fix, device, tmp)
            print(f"  (f) NCCL at world size 1: the collectives exact; the data=1 step: "
                  f"{line}", flush=True)
        if fails:
            raise AssertionError("parallelism:\n" + "\n".join(fails))
        # rank 0's whole checkpoint restores into the one-rank template
        params, state = load_npz(variant_path(variant))
        best = ckpt.restore(os.path.join(tmp, "fit", "ckpt", "best"),
                            TrainState(params, state, make_optimizer(params, TrainConfig())))
        params, state = _tree_map(torch.Tensor.detach, best.params), best.bn_state
    seg = Segmenter(params, state, mcfg, InferConfig(img_size=512), dtype=torch.bfloat16,
                    device=device)
    _, boxes, launches = served_vs_plain(seg, params, state, mcfg, fix["pages"])
    if launches.get(k1.NAME, 0) != 1 or tuple(boxes.shape) != (4, 3, 4):
        raise AssertionError(f"serving fit(mesh)'s checkpoint launched {launches}")
    return launches[k1.NAME]


# -- phase 26: the serving edges and the gauntlet --------------------------------

GAUNTLET_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_gauntlet.npz")
# route → (bundled variant, dtype, int8 on the concat trunk with JAX's scales)
GAUNTLET_ROUTES = {"w16_fp32": ("w16", torch.float32, False),
                   "w16_bf16": ("w16", torch.bfloat16, False),
                   "w16_int8": ("w16", torch.bfloat16, True),
                   "w64_bf16": ("w64", torch.bfloat16, False)}
# kernels one segment_batch call with masks launches on each route
GAUNTLET_KERNELS = {"w16_fp32": {k1.NAME: 1}, "w16_bf16": {k1.NAME: 1},
                    "w16_int8": ROUTE_KERNELS["xla"], "w64_bf16": {k1.NAME: 1}}
# the most a case's per-field IoU at the grid may differ from JAX's, by
# route. On the CPU the port gives JAX's masks exactly at float32 and int8,
# and at bf16 moves at most 3 mask pixels a field (|ΔIoU| at most 1.3e-3 on
# the w16, 6.1e-4 on the w64). On the card cuDNN sums each conv in another
# order, which moves a float32 logit by ~1e-6 of its size and flips only
# the pixels that close to a threshold; 0.01 lets 8 pixels flip on the
# smallest field union of the cases (840 pixels). The int8 route's
# trunk is JAX's to the bit, its float32 head is not: as float32. bf16
# rounds each layer's output to 8 bits, so a flipped rounding carries into
# the next layers: 0.02, 15× the CPU's largest difference.
GAUNTLET_IOU_TOL = {"w16_fp32": 0.01, "w16_int8": 0.01, "w16_bf16": 0.02,
                    "w64_bf16": 0.02}
GAUNTLET_E2E = {"use_qr": False, "auto_rotate": False}  # eval_gauntlet.py --e2e's


def sync(device=None):
    """Wait for the card (``device`` None or CUDA); nothing on the CPU."""
    if torch.device(device or "cuda").type == "cuda":
        torch.cuda.synchronize()


def gauntlet_fixture():
    """The gauntlet fixture: its cases (``eval.load_cases``), tiers, JAX's
    per-case results and summaries (``scripts/make_torch_smoke_gauntlet.py``)."""
    from twinvoice_tpu_torch.eval import load_cases

    with np.load(GAUNTLET_FIXTURE) as z:
        fix = {k: z[k] for k in z.files if not k.startswith("case")}
    for k in list(fix):
        if k.endswith("_summary") or k == "e2e_records":
            fix[k] = json.loads(str(fix[k]))
    fix["cases"] = load_cases(GAUNTLET_FIXTURE)
    fix["tiers"] = [str(t) for t in fix["tiers"]]
    return fix


def gauntlet_segmenter(route, fix, device=None):
    """The bundled segmenter of a route at the 512² grid (int8: the concat
    trunk on JAX's stored scales, so its int8 activations are JAX's)."""
    variant, dtype, int8 = GAUNTLET_ROUTES[route]
    kw = {"int8_scales": quant.scales_from_array(fix["int8_scales"])} if int8 else {}
    return load_pretrained_segmenter(dtype, InferConfig(img_size=512), variant,
                                     device=device, **kw)


class Recorder:
    """Passes ``segment_batch`` (a segmenter) or ``extract`` (an extractor)
    on to ``inner`` and keeps each result, on the host."""

    def __init__(self, inner):
        self.inner, self.out = inner, []
        self.cfg = inner.cfg

    def segment_batch(self, imgs, sizes):
        out = self.inner.segment_batch(imgs, sizes)
        self.out.append(tuple(o.cpu().numpy() for o in out))
        return out

    def clear_cache(self):
        self.inner.clear_cache()

    def extract(self, page):
        out = self.inner.extract(page)
        self.out.append(out)
        return out


def gauntlet_run(seg, fix):
    """``run_segmenter_gauntlet`` tier by tier, as ``eval_gauntlet.py`` runs
    it. → {"summary": {tier: dict}, "iou", "hit", "boxes", "ok", "mask"} over
    the cases, each case's scores the module's own (``_case_scores``), whose
    tier means must be the dict's."""
    from twinvoice_tpu_torch.eval import gauntlet
    from twinvoice_tpu_torch.ops.host_image import resize_nearest_u8

    rec = Recorder(seg)
    cases, tiers = fix["cases"], fix["tiers"]
    summary, iou, hit = {}, [], []
    for t in dict.fromkeys(tiers):
        sel = [c for c, tt in zip(cases, tiers) if tt == t]
        res = gauntlet.run_segmenter_gauntlet(rec, sel)
        pred, boxes, ok = rec.out[-1]
        size = seg.cfg.img_size  # the module's grid masks (``_resize_case``'s INTER_NEAREST)
        gts = np.stack([resize_nearest_u8(c.mask, size, size) > 127 for c in sel])
        i, h = gauntlet._case_scores(sel, gts, pred, boxes, ok)
        if i.mean(0).tolist() != res["iou"] or h.mean(0).tolist() != res["box_hit"]:
            raise AssertionError(f"{t}: per-case scores {i}, {h} do not give {res}")
        summary[t] = res
        iou.append(i)
        hit.append(h)
    pred, boxes, ok = (np.concatenate(a) for a in zip(*rec.out))
    return {"summary": summary, "iou": np.concatenate(iou), "hit": np.concatenate(hit),
            "boxes": boxes, "ok": ok, "mask": pred}


def gauntlet_compare(route, fix, got):
    """One route's per-case results against JAX's: ok flags equal, boxes
    within one grid cell (``ok_check``, per case), IoU within
    ``GAUNTLET_IOU_TOL``, hits equal wherever the boxes are; every case and
    field that differs in any of these or in a mask pixel is printed (where
    the fixture holds JAX's masks; else the mask count is None). →
    (max |ΔIoU|, differing mask pixels, fields with equal boxes, fields)."""
    tol = GAUNTLET_IOU_TOL[route]
    want_mask = (np.unpackbits(fix[f"{route}_mask"]).reshape(got["mask"].shape).astype(bool)
                 if f"{route}_mask" in fix else None)
    size = got["mask"].shape[1]
    bad, d_iou, eq_boxes = [], 0.0, 0
    for i, (c, tier) in enumerate(zip(fix["cases"], fix["tiers"])):
        h, w = c.image.shape[:2]
        tol_px = -(-max(h, w) // size) + 1  # one grid cell in pixels, +1 for the floor
        try:
            ok_check(f"{route} case {i} ({tier})", torch.as_tensor(got["ok"][i]),
                     torch.as_tensor(got["boxes"][i]), fix[f"{route}_ok"][i],
                     fix[f"{route}_boxes"][i], tol_px)
        except AssertionError as e:
            bad.append(str(e))
        for f, field in enumerate(FIELDS):
            same_box = bool(np.array_equal(got["boxes"][i, f], fix[f"{route}_boxes"][i, f])
                            and got["ok"][i, f] == fix[f"{route}_ok"][i, f])
            eq_boxes += same_box
            di = abs(float(got["iou"][i, f]) - float(fix[f"{route}_iou"][i, f]))
            d_iou = max(d_iou, di)
            px = 0 if want_mask is None else int(
                (got["mask"][i, ..., f] != want_mask[i, ..., f]).sum())
            hit, jhit = bool(got["hit"][i, f]), bool(fix[f"{route}_hit"][i, f])
            if px or not same_box or hit != jhit:
                print(f"    {route} case {i} {tier} {field}: mask pixels differing "
                  f"{px if want_mask is not None else 'n/a'}; "
                      f"IoU {got['iou'][i, f]:.6f} vs JAX {fix[f'{route}_iou'][i, f]:.6f}; "
                      f"box {got['boxes'][i, f].tolist()} ok {bool(got['ok'][i, f])} vs "
                      f"JAX {fix[f'{route}_boxes'][i, f].tolist()} "
                      f"{bool(fix[f'{route}_ok'][i, f])}; hit {hit} vs {jhit}", flush=True)
            if di > tol:
                bad.append(f"{route} case {i} {tier} {field}: IoU off JAX's by {di:.4g} "
                           f"(tolerance {tol})")
            if same_box and hit != jhit:
                bad.append(f"{route} case {i} {tier} {field}: hit {hit} with JAX's box, "
                           f"JAX's {jhit}")
    if bad:
        raise AssertionError("; ".join(bad))
    px = None if want_mask is None else int((got["mask"] != want_mask).sum())
    return d_iou, px, eq_boxes, got["ok"].size


def gauntlet_table(rows):
    """``scripts/eval_gauntlet.py``'s summary table: one row per (variant,
    summary), each tier's mean IoU/hit."""
    tiers = list(rows[0][1])
    print("  | variant | grid | " + " | ".join(f"{t} IoU/hit" for t in tiers) + " |")
    print("  |" + "---|" * (len(tiers) + 2))
    for name, summary in rows:
        cells = [f"{summary[t]['iou_mean']:.2f}/{summary[t]['box_hit_mean']:.2f}"
                 for t in tiers]
        print(f"  | {name} | 512 | " + " | ".join(cells) + " |", flush=True)


def edges_check(fix_pages, card, device=None):
    """(a): the bundled w64 exported to a ``.pth``, a ``save_params``
    directory and a ``fit``-style ``train_state.pt``, served back through
    ``Segmenter.from_pth``, ``compat.load_model`` (twice: one object) and
    ``from_checkpoint``, each at fp32 on the four fixture pages equal to
    ``load_pretrained_segmenter("w64", torch.float32)`` exactly. → launches
    (none on the CPU)."""
    import tempfile

    from twinvoice_tpu_torch import compat
    from twinvoice_tpu_torch.config import UNetConfig
    from twinvoice_tpu_torch.port import export_state_dict, load_pth

    pages = list(np.repeat(fix_pages[..., None], 3, axis=-1))
    mcfg = UNetConfig(base_width=64)
    params, state = load_npz(variant_path("w64"))
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp, tf32_off():
        pth = os.path.join(tmp, "best_unet_model.pth")
        sd = export_state_dict(params, state, mcfg)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
        back, src = tree_leaves(list(load_pth(pth, mcfg))), tree_leaves([params, state])
        if len(back) != len(src) or not all(map(torch.equal, back, src)):
            raise AssertionError("load_pth(export_state_dict(w64)) is not the w64 tree")
        ckpt.save_params(os.path.join(tmp, "params"), params, state)
        ckpt.save(os.path.join(tmp, "fit"), TrainState(
            _copy_to(params, "cpu"), _copy_to(state, "cpu"),
            make_optimizer(_copy_to(params, "cpu"), TrainConfig())))
        _build.launches.clear()
        ref = load_pretrained_segmenter(torch.float32, variant="w64", device=device)
        built = {
            "from_pth": Segmenter.from_pth(pth, mcfg, device=device),
            "compat.load_model": compat.load_model(pth, device=device),
            "from_checkpoint(save_params)": Segmenter.from_checkpoint(
                os.path.join(tmp, "params"), mcfg, device=device),
            "from_checkpoint(train_state.pt)": Segmenter.from_checkpoint(
                os.path.join(tmp, "fit"), mcfg, device=device),
        }
        if compat.load_model(pth, device=device) is not built["compat.load_model"]:
            raise AssertionError("compat.load_model loaded the .pth twice")
        want = ref.segment_array_batch(pages)
        for name, seg in built.items():
            got = seg.segment_array_batch(pages)
            for i, ((gm, gc), (wm, wc)) in enumerate(zip(got, want)):
                for f in wm:
                    same = np.array_equal(gm[f], wm[f]) and (
                        (gc[f] is None and wc[f] is None)
                        or (gc[f] is not None and wc[f] is not None
                            and np.array_equal(gc[f], wc[f])))
                    if not same:
                        raise AssertionError(f"{name}: page {i} {f} differs from the "
                                             f"bundled w64's")
        sync(device)
        launches = dict(_build.launches)
        pth_mib = os.path.getsize(pth) / 2 ** 20
    n = sum(c is not None for _, crops in want for c in crops.values())
    print(f"  (a) w64 exported to a .pth ({len(sd)} tensors, {pth_mib:.1f} MiB), a "
          f"save_params directory and a fit train_state.pt: "
          f"{', '.join(built)} equal to load_pretrained_segmenter('w64', fp32) on the "
          f"4 pages (masks and {n} crops exactly); compat.load_model loaded once; "
          f"launches {launches} [{card}]", flush=True)
    want_k1 = {k1.NAME: len(built) + 1} if ref.device.type == "cuda" else {}
    if launches != want_k1:
        raise AssertionError(f"(a) launched {launches}, expected {want_k1}")
    return launches


def e2e_check(fix, card, device=None):
    """(d): ``run_e2e_gauntlet`` on the clean and mild training-font cases,
    the w16 at bf16, ``TorchOcrEngine()``, ``FusionConfig(use_qr=False,
    auto_rotate=False)``; each case's record equal to JAX's wherever the
    port's boxes are JAX's (the others counted). → launches (none on the
    CPU)."""
    from twinvoice_tpu_torch.eval import run_e2e_gauntlet
    from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor
    from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine
    from twinvoice_tpu_torch.ops.host_image import resize_pil_bicubic

    seg = gauntlet_segmenter("w16_bf16", fix, device)
    ex = Recorder(InvoiceExtractor(seg, None, [TorchOcrEngine(device=device)],
                                   cfg=FusionConfig(**GAUNTLET_E2E)))
    idx = [int(i) for i in fix["e2e_cases"]]
    tiers = list(fix["e2e_summary"])
    _build.launches.clear()
    summary = {t: run_e2e_gauntlet(ex, [fix["cases"][i] for i in idx
                                        if fix["tiers"][i] == t]) for t in tiers}
    sync(device)
    launches = dict(_build.launches)
    if launches != ({k1.NAME: len(idx)} if seg.device.type == "cuda" else {}):
        raise AssertionError(f"(d) launched {launches}, expected K1 once a case")
    size = seg.cfg.img_size
    other = []
    for j, (i, out, want) in enumerate(zip(idx, ex.out, fix["e2e_records"])):
        page = fix["cases"][i].image
        _, boxes, ok = seg._segment_one(resize_pil_bicubic(page, size, size),
                                        page.shape[1], page.shape[0])
        got = fusion_record(*out)
        m = got["meta"]
        print(f"    case {i} {fix['tiers'][i]}: {m['invoice_no']}, {m['date']}, "
              f"{m['total_amount']} (JAX {want['meta']['invoice_no']}, "
              f"{want['meta']['date']}, {want['meta']['total_amount']}; truth "
              f"{fix['cases'][i].invoice_no}, {fix['cases'][i].date}, "
              f"{fix['cases'][i].amount})", flush=True)
        if not (np.array_equal(boxes, fix["e2e_boxes"][j])
                and np.array_equal(ok, fix["e2e_ok"][j])):
            other.append(i)
        elif got != want:
            raise AssertionError(f"(d) case {i}: record {got} != JAX's {want}")
    for t in tiers:
        print(f"  (d) e2e {t}: port {summary[t]} JAX {fix['e2e_summary'][t]}", flush=True)
    print(f"  (d) records equal to JAX's on the {len(idx) - len(other)} cases whose port "
          f"boxes are JAX's (others, not held: {other or 'none'}); launches {launches} "
          f"[{card}]", flush=True)
    return launches


def phase_gauntlet(fix_pages, card):
    """Phase 26: the serving edges and the gauntlet against the JAX package
    on the card. → the launches of every kernel in the phase."""
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    add(edges_check(fix_pages, card))
    fix = gauntlet_fixture()
    n_tiers = len(dict.fromkeys(fix["tiers"]))
    rows = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for route in GAUNTLET_ROUTES:
            seg = gauntlet_segmenter(route, fix)
            got, n = counted(route, GAUNTLET_KERNELS[route], n_tiers,
                             lambda: gauntlet_run(seg, fix))
            add(n)
            d_iou, px, eq, total = gauntlet_compare(route, fix, got)
            label = "(b)" if route == "w16_fp32" else "(c)"
            print(f"  {label} {route}: ok flags equal on {len(fix['cases'])} cases, boxes "
                  f"within one grid cell ({eq}/{total} fields exactly equal), max |ΔIoU| "
                  f"{d_iou:.3g} (tolerance {GAUNTLET_IOU_TOL[route]}), mask pixels "
                  f"differing {px} of {got['mask'].size}; launches {n}", flush=True)
            rows += [(f"{route} port", got["summary"]),
                     (f"{route} JAX", fix[f"{route}_summary"])]
            del seg
    print(f"  {card}", flush=True)
    gauntlet_table(rows)
    add(e2e_check(fix, card))
    return launches


# -- phase 27: the QR locator, encoder, labelme core and CLI ---------------------


QR_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_qr.npz")
QR_LOCATE_REPS = 3    # locator calls a page, the median timed
QR_QUAD_TOL = 1e-3    # px: the port's quad corners against cv2's float32 ones
QR_SWEEP_SCALES = tuple(round(0.40 + 0.01 * i, 2) for i in range(41))


def qr_fixture():
    """``tests/data/torch_smoke_qr.npz`` (``scripts/make_torch_smoke_qr.py``)
    with its pages rebuilt (a landscape page is ``np.rot90`` of a portrait
    one) and its JSON lists read."""
    with np.load(QR_FIXTURE) as z:
        raw = {k: z[k] for k in z.files}
    names = [str(n) for n in raw["names"]]
    pages = []
    for i in range(len(names)):
        if f"turned_{i}" in raw:
            seed, k = (int(v) for v in raw[f"turned_{i}"])
            pages.append(np.ascontiguousarray(np.rot90(raw[f"portrait_{seed}"], k)))
        else:
            pages.append(raw[f"page_{i}"])
    fix = {k: v for k, v in raw.items() if not k.startswith(("page_", "turned_"))}
    for key in ("truth", "cv2_boxes", "cv2_quads", "sweep_quads", "sweep_native",
                "jax_native", "jax_default", "jax_noregion", "jax_extract", "encode", "lm_json"):
        fix[key] = json.loads(str(raw[key]))
    fix.update(names=names, pages=pages)
    return fix


def qr_encode_check(fix):
    """(a) Every encoder case's matrix equal to JAX's; each case's
    ``render_qr`` read back to its payload by ``qr.native``. → cases."""
    from twinvoice_tpu_torch.qr import native
    from twinvoice_tpu_torch.qr.encode import encode_qr_matrix, render_qr

    for case in fix["encode"]:
        n, payload = case["side"], case["payload"]
        m = encode_qr_matrix(payload, level=case["level"], mask=case["mask"],
                             version=case["version"])
        bits = np.unpackbits(np.frombuffer(bytes.fromhex(case["bits"]), np.uint8))
        if m.shape != (n, n) or not np.array_equal(m, bits[:n * n].reshape(n, n).astype(bool)):
            raise AssertionError(f"encode_qr_matrix{payload, case['level'], case['mask'], case['version']} "
                                 f"differs from JAX's")
        got = native.decode(render_qr(payload, level=case["level"], mask=case["mask"]))
        if got != [payload]:
            raise AssertionError(f"render_qr({payload!r}) decodes to {got}")
    return len(fix["encode"])


def qr_enhance_check(fix):
    """(b) ``enhance_qr_region`` on the fixture crops byte for byte equal to
    OpenCV's (its own code path: the fixture script turns IPP off). → crops."""
    from twinvoice_tpu_torch.qr.detect import enhance_qr_region

    i = 0
    while f"enhance_in_{i}" in fix:
        got, want = enhance_qr_region(fix[f"enhance_in_{i}"]), fix[f"enhance_out_{i}"]
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"enhance_qr_region crop {i}: "
                                 f"{int((got != want).sum()) if got.shape == want.shape else got.shape} "
                                 f"differs from cv2's {want.shape}")
        i += 1
    return i


def qr_sweep_pages(fix):
    """The sweep's 82 pages, rebuilt: ``resize_area_u8`` of ``portrait_<seed>``
    (the fixture script holds it equal to ``cv2.resize``'s INTER_AREA) at
    ``QR_SWEEP_SCALES``. → {"<seed>_<scale>": uint8 RGB page}."""
    from twinvoice_tpu_torch.ops.host_image import resize_area_u8

    return {key: resize_area_u8(fix[f"portrait_{key.split('_')[0]}"], fx=float(key.split("_")[1]),
                                fy=float(key.split("_")[1]))
            for key in fix["sweep_quads"]}


def qr_quads_equal(got, want):
    """``locate_qr_quads``'s (found, quads) against cv2's stored ``[found,
    quads]``: the flag, the count and order, JAX's int boxes and every corner
    within ``QR_QUAD_TOL``. → the reason they differ, or None."""
    ok, quads = got
    want_ok, want_q = want
    want_q = np.asarray(want_q, np.float32).reshape(-1, 4, 2)
    got_q = np.zeros((0, 4, 2), np.float32) if quads is None else quads
    if bool(ok) != bool(want_ok) or len(got_q) != len(want_q):
        return f"found {ok} with {len(got_q)} quads, cv2's {want_ok} with {len(want_q)}"
    def boxes(quads):  # JAX's int() of each quad's extremes
        return [(int(q[:, 0].min()), int(q[:, 1].min()), int(q[:, 0].max()), int(q[:, 1].max()))
                for q in quads]

    if boxes(got_q) != boxes(want_q):
        return f"boxes {boxes(got_q)}, cv2's {boxes(want_q)}"
    if len(got_q) and float(np.abs(got_q - want_q).max()) > QR_QUAD_TOL:
        return f"corners {float(np.abs(got_q - want_q).max())} px off cv2's"
    return None


def qr_locate_check(fix):
    """(c) The locator on every fixture page and the sweep's 82 against cv2's
    (``[found, quads]`` stored in the fixture, made from a generator seeded
    with 0, as is the port's before each call): ``qr_quads_equal``; on the
    fixture pages ``detect_qr_regions`` gives JAX's boxes. → {page: (quads,
    boxes, median host ms of a call)}."""
    from twinvoice_tpu_torch.ops.host_image import rgb_to_gray
    from twinvoice_tpu_torch.qr.detect import detect_qr_regions
    from twinvoice_tpu_torch.qr.locate import locate_qr_boxes, locate_qr_quads, set_rng_seed

    pages = list(zip(fix["names"], fix["pages"], fix["cv2_quads"], fix["cv2_boxes"]))
    pages += [(f"sweep_{key}", page, fix["sweep_quads"][key], None)
              for key, page in qr_sweep_pages(fix).items()]
    out = {}
    for name, page, want, want_boxes in pages:
        gray = rgb_to_gray(page)
        times = []
        for _ in range(QR_LOCATE_REPS):
            set_rng_seed(0)
            t = time.perf_counter()
            got = locate_qr_quads(gray)
            times.append(time.perf_counter() - t)
        why = qr_quads_equal(got, want)
        if why:
            raise AssertionError(f"locator on {name}: {why}")
        set_rng_seed(0)
        boxes = locate_qr_boxes(gray)
        if want_boxes is not None:
            set_rng_seed(0)
            regions = [list(b) for b in detect_qr_regions(page)]
            if regions != want_boxes:
                raise AssertionError(f"detect_qr_regions on {name}: {regions}, JAX's {want_boxes}")
        out[name] = (0 if got[1] is None else len(got[1]), boxes,
                     1e3 * sorted(times)[len(times) // 2])
    return out


def qr_scan_check(fix):
    """(d) ``QrPipeline(decoders=[native_decode]).scan`` against JAX's on every
    fixture page and the sweep's 82, each from a generator seeded with 0: the
    payload set equal, a single payload on the 0.45× pages as JAX's. →
    {page: (payloads, passes)}."""
    from twinvoice_tpu_torch.qr import detect
    from twinvoice_tpu_torch.qr.locate import set_rng_seed

    pipe = detect.QrPipeline(decoders=[detect.native_decode])
    pages = list(zip(fix["names"], fix["pages"], fix["jax_native"]))
    pages += [(f"sweep_{key}", page, fix["sweep_native"][key])
              for key, page in qr_sweep_pages(fix).items()]
    out = {}
    for name, page, want in pages:
        detect.passes.clear()
        set_rng_seed(0)
        got = pipe.scan(page)
        passes = dict(detect.passes)
        if set(got) != set(want):
            raise AssertionError(f"scan of {name}: {got} != JAX's {want}")
        if "x0.45" in name and len(got) != 1:
            raise AssertionError(f"scan of {name}: {got}, JAX's single payload {want}")
        out[name] = (got, passes)
    return out


def qr_turn_check(fix):
    """(e) ``auto_rotate_by_qr`` on each landscape page turned as JAX's (each
    from a generator seeded with 0). → {page: np.rot90's k}."""
    from twinvoice_tpu_torch.fusion.extract import auto_rotate_by_qr
    from twinvoice_tpu_torch.qr.locate import set_rng_seed

    out = {}
    for name, page, k in zip(fix["names"], fix["pages"], fix["jax_turn"]):
        if page.shape[1] <= page.shape[0]:
            continue
        set_rng_seed(0)
        got = auto_rotate_by_qr(page)
        if not np.array_equal(got, np.rot90(page, int(k))):
            raise AssertionError(f"auto_rotate_by_qr on {name}: not JAX's turn {int(k)}")
        out[name] = int(k)
    return out


def qr_extract_check(fix, seg, eng, expect_k1=True):
    """(f) ``InvoiceExtractor.extract`` (``QrPipeline()``, auto-rotate on) on
    the landscape and 0.45× pages against JAX's: ``qr_raw`` and ``items``
    equal on every page, every meta field on the pages whose port boxes
    (``segment_array`` on the page ``extract`` segments) are JAX's; each
    extract from a locator generator seeded with 0, as JAX's; driven with the
    launch counts zeroed just before and read just after: K1 once a page
    (``expect_k1=False``: none, the CPU). → (records, pages off JAX's boxes,
    launches)."""
    from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor
    from twinvoice_tpu_torch.ops.host_image import resize_pil_bicubic
    from twinvoice_tpu_torch.qr.detect import QrPipeline
    from twinvoice_tpu_torch.qr.locate import set_rng_seed

    def seeded_extract(page):
        set_rng_seed(0)
        return fusion_record(*ex.extract(page))

    idx = [int(i) for i in fix["extract_pages"]]
    pages = [fix["pages"][i] for i in idx]
    size = seg.cfg.img_size
    same = []
    for j, (i, page) in enumerate(zip(idx, pages)):
        seen = np.ascontiguousarray(np.rot90(page, int(fix["jax_turn"][i])))
        _, b, o = seg._segment_one(resize_pil_bicubic(seen, size, size),
                                   seen.shape[1], seen.shape[0])
        same.append(bool(np.array_equal(b, fix["extract_boxes"][j])
                         and np.array_equal(o, fix["extract_ok"][j])))
    ex = InvoiceExtractor(seg, QrPipeline(), [eng], cfg=FusionConfig())
    _build.launches.clear()
    got = [seeded_extract(p) for p in pages]
    launches = dict(_build.launches)
    want = {k1.NAME: len(pages)} if expect_k1 else {}
    if launches != want:
        raise AssertionError(f"extract on the QR pages: launches {launches}, expected {want}")
    other = fusion_check({"jax_extract": fix["jax_extract"]}, "extract", got, same)
    return got, [fix["names"][idx[j]] for j in other], launches


def labelme_check(fix):
    """(i) ``rasterize_labelme`` and ``build_one``'s two resizes on the
    fixture's JSON and image equal to JAX's mask and OpenCV's resizes. →
    the resized shape."""
    from twinvoice_tpu_torch.data.labelme import rasterize_labelme
    from twinvoice_tpu_torch.ops.host_image import resize_linear_u8, resize_nearest_u8

    meta, img = fix["lm_json"], fix["portrait_5"]
    h, w = img.shape[:2]
    mask = rasterize_labelme(meta["shapes"], (h, w),
                             (w / meta["imageWidth"], h / meta["imageHeight"]))
    th, tw = fix["lm_img_r"].shape[:2]
    for what, got, want in (("mask", mask, fix["lm_mask"]),
                            ("image resize", resize_linear_u8(img, tw, th), fix["lm_img_r"]),
                            ("mask resize", resize_nearest_u8(mask, tw, th), fix["lm_mask_r"])):
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"labelme {what} differs from JAX's")
    return th, tw


def training_files(tmp, pages, masks):
    """The layout ``build-dataset`` writes, from arrays: ``pages`` through
    ``imwrite_jpeg`` into ``tmp/fixed_images``, ``masks`` into
    ``tmp/fixed_masks``; read back by ``load_invoice_dataset``, each page
    must equal its ``jpeg_roundtrip_u8`` at q95 and each mask itself.
    → (the image directory, the mask directory, the host ms of the read)."""
    from twinvoice_tpu_torch.data import dataset
    from twinvoice_tpu_torch.ops.host_imageio import imwrite_jpeg
    from twinvoice_tpu_torch.ops.host_jpeg import jpeg_roundtrip_u8

    img_dir, mask_dir = os.path.join(tmp, "fixed_images"), os.path.join(tmp, "fixed_masks")
    os.makedirs(img_dir)
    os.makedirs(mask_dir)
    for i, (page, mask) in enumerate(zip(pages, masks)):
        imwrite_jpeg(os.path.join(img_dir, f"page{i}.jpg"), page)
        np.save(os.path.join(mask_dir, f"page{i}.npy"), mask)
    t0 = time.perf_counter()
    ds = dataset.load_invoice_dataset(img_dir, mask_dir)
    ms = (time.perf_counter() - t0) * 1e3
    want = np.stack([jpeg_roundtrip_u8(p, 95) for p in pages])
    if (ds.names != tuple(f"page{i}" for i in range(len(pages)))
            or not np.array_equal(ds.images, want) or not np.array_equal(ds.masks, masks)):
        raise AssertionError(f"load_invoice_dataset read back {ds.names}, images or masks "
                             f"other than the files hold")
    return img_dir, mask_dir, ms


def cli_train_check(tmp, card):
    """(g) ``python -m twinvoice_tpu_torch train --epochs 1 --resume START``
    through ``__main__.main`` on the training fixture's pages written as
    files (:func:`training_files`), START the bundled w64 saved as a
    checkpoint at epoch 0 (as phase 22 starts), so that the checkpoint it
    writes finds fields; that checkpoint served by
    ``Segmenter.from_checkpoint`` through K1 against the plain path on the
    same weights. → K1's launches."""
    from twinvoice_tpu_torch import __main__ as cli
    from twinvoice_tpu_torch.config import UNetConfig

    fix = train_fixture()
    img_dir, mask_dir, read_ms = training_files(tmp, fix["pages"], fix["masks"])
    print(f"  (g) the training fixture's {len(fix['pages'])} pages of "
          f"{fix['pages'].shape[1]}² written by imwrite_jpeg, read back by "
          f"load_invoice_dataset in {read_ms:.1f} ms on the host ({host_cpu()}): each equal to "
          f"jpeg_roundtrip_u8(page, 95), masks equal", flush=True)
    ckpt_dir, start = os.path.join(tmp, "checkpoints"), os.path.join(tmp, "start")
    bundled = load_npz(variant_path("w64"))
    params, state = _copy_to(bundled[0], "cpu"), _copy_to(bundled[1], "cpu")
    ckpt.save(start, TrainState(params, state, make_optimizer(params, TrainConfig())))
    del bundled, params, state
    cwd = os.getcwd()
    os.chdir(tmp)  # fit writes its visual dumps under ./visualize, as JAX's CLI does
    try:
        t = time.perf_counter()
        cli.main(["train", "--images", img_dir, "--masks", mask_dir, "--epochs", "1",
                  "--checkpoint-dir", ckpt_dir, "--resume", start])
        dt = time.perf_counter() - t
    finally:
        os.chdir(cwd)
    best = os.path.join(ckpt_dir, "best")
    mcfg = UNetConfig()
    seg = Segmenter.from_checkpoint(best, mcfg, InferConfig(img_size=512), torch.float32)
    params, state = ckpt.restore_params(best, mcfg)
    with tf32_off():
        _, boxes, launches = served_vs_plain(seg, params, state, mcfg, fix["pages"],
                                             label="the CLI's w64")
    if launches.get(k1.NAME, 0) != 1 or tuple(boxes.shape) != (4, 3, 4):
        raise AssertionError(f"serving the CLI's checkpoint launched {launches}")
    print(f"  (g) train --epochs 1 --resume (the bundled w64, b4 512² from the files, one "
          f"step): {dt:.2f} s, checkpoint {sorted(os.listdir(ckpt_dir))} served by "
          f"Segmenter.from_checkpoint [{card}]", flush=True)
    return launches[k1.NAME]


def cli_train_ocr_check(tmp, steps, device=None):
    """(h) ``python -m twinvoice_tpu_torch train-ocr`` on the OCR training
    fixture's pool for ``steps`` steps; the weights it writes load, finite,
    in the fixture's charset. → seconds."""
    from twinvoice_tpu_torch import __main__ as cli

    out = os.path.join(tmp, "recognizer.npz")
    argv = ["train-ocr", "--pool", OCR_TRAIN_FIXTURE, "--out", out, "--steps", str(steps)]
    t = time.perf_counter()
    cli.main(argv + (["--device", str(device)] if device else []))
    dt = time.perf_counter() - t
    params, state, charset, arch = rec_train.load_weights_ex(out)
    with np.load(OCR_TRAIN_FIXTURE) as z:
        want = str(z["charset"])
    if arch != "t64" or charset.chars != want:
        raise AssertionError(f"train-ocr wrote arch {arch!r} and a charset of "
                             f"{len(charset.chars)} characters")
    if not all(torch.isfinite(t).all() for t in tree_leaves(params) + tree_leaves(state)):
        raise AssertionError("train-ocr wrote non-finite weights")
    return dt


def phase_qr_cli(card):
    """Phase 27: the QR locator, scan, auto-rotate and encoder, the labelme
    core and the CLI on the card's machine against the JAX package. → K1's
    launches in (f) and (g)."""
    import tempfile

    from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine

    fix = qr_fixture()
    n = qr_encode_check(fix)
    print(f"  (a) {n} encoder matrices equal to JAX's (levels L/M/Q/H, masks 0-7, versions "
          f"1-10, 12, 15 and 20); each render_qr read back by qr.native", flush=True)
    print(f"  (b) {qr_enhance_check(fix)} enhance_qr_region crops equal to OpenCV's byte for "
          f"byte", flush=True)
    located = qr_locate_check(fix)
    for name, (n, boxes, ms) in located.items():
        if not name.startswith("sweep_"):
            print(f"  (c) {name}: {n} quads, cv2's; boxes {boxes}; {ms:.2f} ms a call on the "
                  f"host", flush=True)
    all_ms = sorted(v[2] for v in located.values())
    print(f"  (c) locator on {len(all_ms)} pages (14 fixture, {len(all_ms) - 14} sweep): quads, "
          f"order and int boxes cv2's, corners within {QR_QUAD_TOL} px; host ms a page: median "
          f"{all_ms[len(all_ms) // 2]:.2f}, range {all_ms[0]:.2f}-{all_ms[-1]:.2f} [{card}]",
          flush=True)
    scanned = qr_scan_check(fix)
    for name, (got, passes) in scanned.items():
        if not name.startswith("sweep_"):
            print(f"  (d) {name}: {len(got)} payloads, passes {passes}", flush=True)
    print(f"  (d) scans on {len(scanned)} pages: payload sets JAX's "
          f"({sum(len(v[0]) == 2 for v in scanned.values())} with both codes read)", flush=True)
    print(f"  (e) auto_rotate_by_qr turns as JAX's: {qr_turn_check(fix)}", flush=True)
    seg = load_pretrained_segmenter(torch.float32)
    eng = TorchOcrEngine()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got, other, launches = qr_extract_check(fix, seg, eng)
    for rec, i in zip(got, fix["extract_pages"]):
        m = rec["meta"]
        print(f"    {fix['names'][int(i)]}: {m['invoice_no']} ({m['source']}), {m['date']}, "
              f"{m['total_amount']}; items {rec['items']}", flush=True)
    print(f"  (f) extract on {len(got)} pages: qr_raw and items equal to JAX's; every meta "
          f"field equal on the pages on JAX's boxes (others: {other or 'none'}); launches "
          f"{launches}", flush=True)
    del seg, eng
    k1_launches = launches[k1.NAME]
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp:
        k1_launches += cli_train_check(tmp, card)
        before = dict(_build.launches)
        dt = cli_train_ocr_check(tmp, 101)
        if dict(_build.launches) != before:
            raise AssertionError("train-ocr launched a kernel of the port")
        print(f"  (h) train-ocr --steps 101 on the OCR training fixture's pool: {dt:.2f} s; the "
              f"weights load, finite [{card}]", flush=True)
    th, tw = labelme_check(fix)
    print(f"  (i) rasterize_labelme and build_one's resizes to {tw}×{th} equal to JAX's",
          flush=True)
    return k1_launches


# -- phase 28: the store, the app, the network OCR engines and the CLI's app -----


APP_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_app.npz")
# the JAX package's knobs of the app: (d) runs with none of them set
APP_ENV = ("TWINVOICE_CKPT", "TWINVOICE_PTH", "OCR_SPACE_API_KEY", "SUPABASE_URL",
           "SUPABASE_KEY")
APP_KEY = "k"  # (c)'s OCR.space key
# (c)'s canned replies: the OCR.space transport's in call order, the EasyOCR
# reader's words
APP_SPACE_TEXTS = ("AB-12345678", "2025/03/07", "NT$ 1,250", "", "2024/12/31", "99")
APP_READER_WORDS = ("XY-98765432", "2025/01/02")
APP_DASH_REPS = 5  # dashboard passes timed, the median printed
STORE_META = {"invoice_no": "AB12345678XX", "date": "2025-09-09", "total_amount": "120",
              "category": "餐飲", "source": "QR", "qr_raw": ["a", "b"]}
STORE_ITEMS = [{"name": "奶茶", "qty": 2, "price": 30, "amount": 60}]


def plain(v):
    """Store rows, dashboard rows and their values as JSON data, alike from
    the port's lists and from pandas' frames: a datetime (a pandas Timestamp
    too) → its ISO string, NaT and NaN → None, numpy scalars → Python."""
    if isinstance(v, dict):
        return {str(k): plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, datetime.datetime):
        return None if str(v) == "NaT" else v.isoformat()
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and v != v:
        return None
    return v


class FakeSupabaseTable:
    """A ``supabase`` table of the in-memory fake client (the JAX package's
    ``tests/unit/test_store.py``): insert, delete with ``eq`` filters, and
    select of every row; ``fail`` makes ``execute`` raise."""

    def __init__(self, db, name, fail=False):
        self.db, self.name, self.fail = db, name, fail
        self._op, self._filters = None, []

    def insert(self, rows):
        self._op = ("insert", rows)
        return self

    def delete(self):
        self._op = ("delete", None)
        return self

    def select(self, *_):
        self._op = ("select", None)
        return self

    def eq(self, col, val):
        self._filters.append((col, val))
        return self

    def order(self, *a, **k):
        return self

    def limit(self, n):
        return self

    def execute(self):
        if self.fail:
            raise RuntimeError("supabase is down")
        op, payload = self._op
        table = self.db.setdefault(self.name, [])

        class Response:
            data = None

        r = Response()
        if op == "insert":
            rows = payload if isinstance(payload, list) else [payload]
            for row in rows:
                row = dict(row)
                row.setdefault("id", len(table) + 1)
                table.append(row)
            r.data = rows if isinstance(payload, list) else [table[-1]]
        elif op == "delete":
            self.db[self.name] = [row for row in table
                                  if not all(row.get(c) == v for c, v in self._filters)]
            r.data = []
        else:
            r.data = list(table)
        return r


class FakeSupabaseClient:
    def __init__(self, fail=False):
        self.db, self.fail = {}, fail

    def table(self, name):
        return FakeSupabaseTable(self.db, name, self.fail)


@contextlib.contextmanager
def app_env_unset():
    """The app's environment variables unset for the block, then restored."""
    saved = {k: os.environ.pop(k) for k in APP_ENV if k in os.environ}
    try:
        yield
    finally:
        os.environ.update(saved)


def store_ops(store):
    """(a)'s scripted calls on one store, each result (or the exception's
    type) taken as JSON data when the call returns. → [[call, result]]."""
    out = []

    def run(op, fn, *args):
        try:
            r = plain(json.loads(json.dumps(fn(*args), ensure_ascii=False)))
        except Exception as e:  # the store's own failures are part of its contract
            r = ["raises", type(e).__name__]
        out.append([op, r])

    run("save", store.save_invoice, STORE_META, STORE_ITEMS)
    run("save second", store.save_invoice, dict(STORE_META, invoice_no="CD11111111"), [])
    run("save amount 1,200", store.save_invoice, dict(STORE_META, total_amount="1,200"),
        STORE_ITEMS)
    run("save amount None", store.save_invoice, dict(STORE_META, total_amount=None), None)
    run("save bad item", store.save_invoice, STORE_META, [{"name": "x", "qty": "x"}])
    run("save empty meta", store.save_invoice, {}, [])
    run("list", store.list_invoices)
    run("list 2", store.list_invoices, 2)
    run("items", store.list_items)
    run("delete 1", store.delete_invoice, 1)
    run("delete 99", store.delete_invoice, 99)
    run("list after", store.list_invoices)
    run("items after", store.list_items)
    return out


def store_record(memory_cls, supabase_cls):
    """(a) on one package's stores: the in-memory one, the Supabase one on
    the fake client (with its tables after), on a client whose calls fail,
    and built with no credentials. → JSON data."""
    client = FakeSupabaseClient()
    out = {"memory": store_ops(memory_cls()),
           "supabase": store_ops(supabase_cls(client=client))}
    out["supabase_tables"] = plain(client.db)
    out["supabase_failing"] = store_ops(supabase_cls(client=FakeSupabaseClient(fail=True)))
    with app_env_unset():
        bare = supabase_cls()
        out["supabase_bare"] = [bare.available()] + store_ops(bare)
        out["supabase_creds"] = supabase_cls(url="http://localhost:1", key="x").available()
    return out


def dashboard_record(D, rows, inv_rows, item_rows):
    """Every aggregate the dashboard tab reads, through the dashboard module
    ``D`` (``rows`` turns what ``D`` returns into row dicts): the frames, the
    years, and per year its rows, total, months, monthly totals, category
    totals and sorted rows (whole year and each month), and each invoice's
    items. → JSON data."""
    df, df_items = D.prepare_frames(inv_rows, item_rows)
    out = {"frame": rows(df), "items": rows(df_items), "years": D.years(df), "by_year": {}}
    for year in out["years"]:
        sel, total = D.year_summary(df, year)
        months = D.months_in(sel)
        out["by_year"][year] = {
            "rows": rows(sel), "total": total, "months": months,
            "monthly": rows(D.monthly_totals(sel)),
            "categories": [rows(D.category_totals(sel, m)) for m in [None] + months],
            "sorted": [rows(D.invoices_sorted(sel, m)) for m in [None] + months]}
    ids = sorted({r["id"] for r in inv_rows})
    out["items_for"] = [rows(D.items_for_invoice(df_items, i)) for i in ids + [0]]
    return plain(out)


def app_fixture():
    """``tests/data/torch_smoke_app.npz`` (``scripts/make_torch_smoke_app.py``)
    with its JSON read, its crops as ``{(page, field): RGB}`` and the pages
    of ``tests/data/torch_smoke_fusion.npz``."""
    with np.load(APP_FIXTURE) as z:
        raw = {k: z[k] for k in z.files}
    fix = {k: v for k, v in raw.items() if not k.startswith(("crop_", "enh_"))}
    for key in ("store", "net", "flow", "ipp"):
        fix[key] = json.loads(str(raw[key]))
    fix["crops"] = {}
    for k, v in raw.items():
        if k.startswith("crop_"):
            p, f = k[len("crop_"):].split("_", 1)
            fix["crops"][int(p), f] = v
    fix["enh"] = {k[len("enh_"):]: v for k, v in raw.items() if k.startswith("enh_")}
    with np.load(FUSION_FIXTURE) as z:
        fix["pages"] = z["pages"]
    return fix


def store_check(fix):
    """(a) The port's stores against JAX's rows and returns. → calls held."""
    from twinvoice_tpu_torch.store.memory import MemoryStore
    from twinvoice_tpu_torch.store.supabase_store import SupabaseStore

    got = store_record(MemoryStore, SupabaseStore)
    for key, want in fix["store"].items():
        if got[key] != want:
            raise AssertionError(f"store {key}: {got[key]} != JAX's {want}")
    return sum(len(v) for v in got.values() if isinstance(v, list))


ENHANCE_FNS = ("text", "amount", "gray", "camera")


def enhance_outputs(enhance, crop):
    """The four enhancements of (b) of one crop through the module
    ``enhance`` (the port's ``ocr.enhance`` or JAX's), by
    :data:`ENHANCE_FNS`."""
    return {"text": enhance.enhance_for_ocr(crop, mode="text"),
            "amount": enhance.enhance_for_ocr(crop, mode="amount"),
            "gray": enhance.grayscale_for_ocr(crop),
            "camera": enhance.enhance_camera(crop)}


def enhance_check(fix):
    """(b) ``enhance_for_ocr`` (text and amount), ``grayscale_for_ocr`` and
    ``enhance_camera`` on each fixture crop, as an array and as the
    extractor hands it (``PilPixels``), byte for byte JAX's (OpenCV with
    IPP off). → (crops, bytes compared, host ms of the four on all crops)."""
    from twinvoice_tpu_torch.ocr import enhance
    from twinvoice_tpu_torch.ops.host_image import PilPixels

    n = 0
    t = time.perf_counter()
    for (p, f), crop in sorted(fix["crops"].items()):
        for form, src in (("array", crop), ("PIL", PilPixels(crop))):
            for kind, got in enhance_outputs(enhance, src).items():
                want = fix["enh"][f"{kind}_{p}_{f}"]
                if got.shape != want.shape or not np.array_equal(got, want):
                    raise AssertionError(
                        f"{kind} of crop {p} {f} ({form}): "
                        f"{int((got != want).sum()) if got.shape == want.shape else got.shape}"
                        f" differs from JAX's {want.shape}")
                n += want.size
    return len(fix["crops"]), n, 1e3 * (time.perf_counter() - t) / 2


def png_pixels(png: bytes):
    """A grayscale 8-bit PNG (no interlace) → (pixels, the inflated IDAT
    stream), read with the standard library and numpy: rows of filter None,
    Sub and Up at once, Average and Paeth byte by byte."""
    import zlib

    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    i, idat, hdr = 8, b"", None
    while i < len(png):
        n = int.from_bytes(png[i:i + 4], "big")
        tag, data = png[i + 4:i + 8], png[i + 8:i + 8 + n]
        if tag == b"IHDR":
            hdr = data
        elif tag == b"IDAT":
            idat += data
        i += 12 + n
    w, h = int.from_bytes(hdr[:4], "big"), int.from_bytes(hdr[4:8], "big")
    if hdr[8:13] != bytes([8, 0, 0, 0, 0]):
        raise ValueError(f"not 8-bit gray: {hdr[8:13]}")
    raw = zlib.decompress(idat)
    rows = np.frombuffer(raw, np.uint8).reshape(h, w + 1).astype(np.int64)
    out = np.zeros((h, w), np.int64)
    prev = np.zeros(w, np.int64)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(w, np.int64)
            for x in range(w):
                a = int(cur[x - 1]) if x else 0
                b, c = int(prev[x]), (int(prev[x - 1]) if x else 0)
                if kind == 3:
                    pred = (a + b) // 2
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[x] = (int(line[x]) + pred) & 0xFF
        out[y], prev = cur, cur
    return out.astype(np.uint8), raw


class RecordingTransport:
    """OCR.space's transport for (c): records each payload, answers with
    :data:`APP_SPACE_TEXTS` in turn."""

    def __init__(self):
        self.payloads = []

    def __call__(self, payload):
        self.payloads.append(dict(payload))
        text = APP_SPACE_TEXTS[(len(self.payloads) - 1) % len(APP_SPACE_TEXTS)]
        return {"ParsedResults": [{"ParsedText": text}]}


class RecordingReader:
    """EasyOCR's reader for (c): records each array, answers
    :data:`APP_READER_WORDS`."""

    def __init__(self):
        self.arrays = []

    def readtext(self, img, detail=0):
        self.arrays.append(np.array(img))
        return list(APP_READER_WORDS)


class CropSegmenter:
    """(c)'s segmenter: a page's fixture crops, by the page's index in the
    array ``segment_array`` (or ``segment_pil``) is handed; ``as_crop``
    turns a crop into what the package's extractor expects."""

    def __init__(self, crops, pages, as_crop=lambda c: c):
        self.crops, self.as_crop = crops, as_crop
        self.keys = [np.ascontiguousarray(p).tobytes() for p in pages]

    def segment_array(self, page):
        p = self.keys.index(np.asarray(page).tobytes())
        return {}, {f: (self.as_crop(self.crops[p, f]) if (p, f) in self.crops else None)
                    for f in FIELDS}

    segment_pil = segment_array


def net_record(extract, transport, reader, pages):
    """(c)'s records: each page's fields through an extractor (``extract``)
    whose engines are OCR.space and EasyOCR, the payloads the transport saw
    (the image as the digest of its inflated IDAT stream and its shape) and
    the arrays the reader saw (their digests and shapes). → JSON data."""
    import base64
    import hashlib

    fields = [fusion_record(*extract(p)) for p in pages]
    payloads = []
    for pl in transport.payloads:
        head = "data:image/png;base64,"
        if not pl["base64Image"].startswith(head):
            raise AssertionError(f"payload image {pl['base64Image'][:40]}")
        pix, raw = png_pixels(base64.b64decode(pl["base64Image"][len(head):]))
        payloads.append(dict({k: v for k, v in pl.items() if k != "base64Image"},
                             image=[list(pix.shape), hashlib.sha256(pix.tobytes()).hexdigest(),
                                    hashlib.sha256(raw).hexdigest()]))
    arrays = [[list(a.shape), str(a.dtype), hashlib.sha256(a.tobytes()).hexdigest()]
              for a in reader.arrays]
    return {"fields": fields, "payloads": payloads, "arrays": arrays}


def network_check(fix):
    """(c) ``OcrSpaceEngine`` (key, recording transport) and ``EasyOcrEngine``
    (recording reader) in the port's ``InvoiceExtractor`` on the fixture
    crops: the fields, every payload field, each PNG's pixels (read by
    :func:`png_pixels`) and its inflated stream (Pillow's row filters), and
    every array the reader saw equal to JAX's. → (payloads, arrays)."""
    from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor
    from twinvoice_tpu_torch.ocr.easyocr_engine import EasyOcrEngine
    from twinvoice_tpu_torch.ocr.ocrspace import OcrSpaceEngine

    transport, reader = RecordingTransport(), RecordingReader()
    ex = InvoiceExtractor(CropSegmenter(fix["crops"], fix["pages"]), None,
                          [OcrSpaceEngine(api_key=APP_KEY, transport=transport),
                           EasyOcrEngine(reader=reader)],
                          cfg=FusionConfig(use_qr=False, auto_rotate=False))
    got = net_record(ex.extract, transport, reader, fix["pages"])
    want = fix["net"]
    for key in ("fields", "payloads", "arrays"):
        if got[key] != want[key]:
            diff = [i for i, (a, b) in enumerate(zip(got[key], want[key])) if a != b]
            raise AssertionError(f"network engines: {key} differ from JAX's at {diff or 'length'}"
                                 f": {got[key][diff[0]] if diff else len(got[key])} vs "
                                 f"{want[key][diff[0]] if diff else len(want[key])}")
    return len(got["payloads"]), len(got["arrays"])


def app_flow(build_engine, build_store, classify, D, rows, pages, to_image=lambda p: p):
    """(d)'s flow of the app on ``pages``: one engine and one store as the
    app builds them, then per page ``extract``, ``classify_invoice``, the
    category set and ``save_invoice``; then ``list_invoices(500)``,
    ``list_items(5000)`` and :func:`dashboard_record`. → (JSON data, the
    extractor, host seconds of each extract, of the dashboard pass)."""
    with app_env_unset():
        ex, store = build_engine(), build_store()
    out = {"fields": [], "categories": [], "ids": []}
    ext_s = []
    for page in pages:
        t = time.perf_counter()
        meta, items, qr_raw = ex.extract(to_image(page))
        ext_s.append(time.perf_counter() - t)
        out["fields"].append(fusion_record(meta, items, qr_raw))
        cat = classify(meta, items)
        meta["category"] = cat
        out["categories"].append(cat)
        out["ids"].append(store.save_invoice(meta, items))
    dash_s = []
    for _ in range(APP_DASH_REPS):
        t = time.perf_counter()
        inv, its = store.list_invoices(500), store.list_items(5000)
        dash = dashboard_record(D, rows, inv, its)
        dash_s.append(time.perf_counter() - t)
    out["rows"], out["items"], out["dashboard"] = plain(inv), plain(its), dash
    return out, ex, ext_s, sorted(dash_s)[len(dash_s) // 2]


def app_same_boxes(fix, seg):
    """Per page: whether the port segmenter's boxes and ok flags (as
    ``extract`` makes them: Pillow's bicubic resize of the page) are JAX's."""
    from twinvoice_tpu_torch.ops.host_image import resize_pil_bicubic

    size = seg.cfg.img_size
    same = []
    for i, page in enumerate(fix["pages"]):
        _, b, o = seg._segment_one(resize_pil_bicubic(page, size, size), page.shape[1],
                                   page.shape[0])
        same.append(bool(np.array_equal(b, fix["app_boxes"][i])
                         and np.array_equal(o, fix["app_ok"][i])))
    return same


def app_flow_check(fix, device=None, expect_k1=True):
    """(d) The app's flow through the port's ``app.main._build_engine()`` and
    ``_build_store()`` (no environment variable set: the bundled w16 at
    bf16, ``TorchOcrEngine``, the in-memory store) on the fixture pages,
    driven with the launch counts zeroed just before the extracts and read
    just after: K1 once an ``extract`` (``expect_k1=False``: none, the CPU).
    ``qr_raw`` and ``items`` equal to JAX's app on every page, every meta
    field on the pages whose boxes are JAX's (phase 19's rule); where all
    are, the categories, the stored rows and every dashboard aggregate too;
    and the port's store and dashboard on JAX's fields (the categories
    JAX's) equal to JAX's rows and aggregates on every page. → (records,
    pages off JAX's boxes, launches, extract ms, dashboard ms)."""
    from twinvoice_tpu_torch.app import dashboard as D
    from twinvoice_tpu_torch.app import main as app
    from twinvoice_tpu_torch.fusion.classify import classify_invoice

    def build_engine():
        return app._build_engine(device)

    want = fix["flow"]
    _build.launches.clear()
    got, ex, ext_s, dash_s = app_flow(build_engine, app._build_store, classify_invoice, D, list,
                                      fix["pages"])
    launches = dict(_build.launches)
    expect = {k1.NAME: len(fix["pages"])} if expect_k1 else {}
    if launches != expect:
        raise AssertionError(f"the app's extracts: launches {launches}, expected {expect}")
    same = app_same_boxes(fix, ex.segmenter)
    other = fusion_check({"jax_app": want["fields"]}, "app", got["fields"], same)
    if not other:
        for key in ("categories", "ids", "rows", "items", "dashboard"):
            if got[key] != want[key]:
                raise AssertionError(f"the app's {key}: {got[key]} != JAX's {want[key]}")
    # the store and the dashboard on JAX's fields
    from twinvoice_tpu_torch.store.memory import MemoryStore

    store = MemoryStore()
    for rec, cat in zip(want["fields"], want["categories"]):
        store.save_invoice(dict(rec["meta"], category=cat), rec["items"])
    dash = dashboard_record(D, list, store.list_invoices(500), store.list_items(5000))
    if (plain(store.list_invoices(500)), dash) != (want["rows"], want["dashboard"]):
        raise AssertionError("the port's store and dashboard on JAX's fields differ from "
                             "JAX's")
    return got, other, launches, [1e3 * s for s in ext_s], 1e3 * dash_s


def cli_app_check():
    """(e) ``python -m twinvoice_tpu_torch app`` through ``__main__.main``
    with ``subprocess.run`` replaced by a recorder. → the command."""
    from twinvoice_tpu_torch import __main__ as cli

    calls = []
    real = subprocess.run
    subprocess.run = lambda cmd, **kw: calls.append((cmd, kw))
    try:
        cli.main(["app"])
    finally:
        subprocess.run = real
    app_py = os.path.join(os.path.dirname(os.path.abspath(cli.__file__)), "app", "main.py")
    want = [([sys.executable, "-m", "streamlit", "run", app_py], {"check": True})]
    if [(c[:4] + [os.path.abspath(c[4])], kw) for c, kw in calls] != want:
        raise AssertionError(f"the CLI's app ran {calls}")
    return calls[0][0]


def phase_app(card):
    """Phase 28: the store, the app's flow, the network OCR engines and the
    CLI's ``app`` on the card's machine against the JAX package. → K1's
    launches in (d)."""
    fix = app_fixture()
    print(f"  (a) {store_check(fix)} store calls (in memory; Supabase on a fake client, a "
          f"failing one and none) equal to JAX's rows and returns", flush=True)
    n, nbytes, ms = enhance_check(fix)
    print(f"  (b) enhance_for_ocr (text, amount), grayscale_for_ocr and enhance_camera on {n} "
          f"crops, as arrays and as PilPixels: {nbytes} bytes equal to JAX's (OpenCV, IPP "
          f"off); {ms:.2f} ms for the four on all crops on the host [{card}]", flush=True)
    n_pay, n_arr = network_check(fix)
    print(f"  (c) OCR.space and EasyOCR in the extractor: fields, {n_pay} payloads (pixels "
          f"and row filters of each PNG) and {n_arr} reader arrays equal to JAX's",
          flush=True)
    got, other, launches, ext_ms, dash_ms = app_flow_check(fix)
    for rec, cat in zip(got["fields"], got["categories"]):
        m = rec["meta"]
        print(f"    {m['invoice_no']} ({m['source']}), {m['date']}, {m['total_amount']}; "
              f"{cat}; items {rec['items']}", flush=True)
    print(f"  (d) the app's flow on {len(got['fields'])} pages (_build_engine(): the bundled "
          f"w16 at bf16, TorchOcrEngine; _build_store(): MemoryStore): qr_raw and items "
          f"equal to JAX's; every meta field on the pages on JAX's boxes (others: "
          f"{other or 'none'}); categories, rows and the dashboard "
          f"{'equal' if not other else 'held on JAX’s fields only'}; launches {launches}; "
          f"extract {', '.join(f'{v:.2f}' for v in ext_ms)} ms, the dashboard pass "
          f"{dash_ms:.2f} ms (median of {APP_DASH_REPS}) on the host [{card}]", flush=True)
    print(f"  (e) the CLI's app runs {cli_app_check()[1:4]} on the port's app/main.py",
          flush=True)
    return launches[k1.NAME]


# -- phase 29: the perturbation engine and augmented training --------------------

AUG_MAX_SHARE, AUG_MAX_DELTA = 0.005, 16  # tests/test_torch_augment.py's bound
AUG_SEVERITY, AUG_P_CLEAN, AUG_SEED = 0.6, 0.3, 29  # scripts/train_synthetic_segmenter.py's
GAUNTLET_PERTURB_SEED = 7  # scripts/make_torch_smoke_gauntlet.py's


def perturb_tiers_check(fix):
    """(a): the port's ``perturb_cases(..., seed=7)`` on the fixture's clean
    bases, tier by tier, against the fixture's cases (the JAX package's).
    Masks must be equal; images within ``AUG_MAX_SHARE``/``AUG_MAX_DELTA``.
    → (the cases in the fixture's order, the clean ones its own; rows of
    (tier, differing bytes, bytes, max |Δ|, host ms))."""
    from twinvoice_tpu_torch.eval import perturb_cases

    cases, tiers = fix["cases"], fix["tiers"]
    bases = {t.partition("+")[2]: c for c, t in zip(cases, tiers)
             if t.partition("+")[0] == "clean"}
    out, rows, bad = [], [], []
    for c, tier in zip(cases, tiers):
        level, _, font = tier.partition("+")
        if level == "clean":
            out.append(c)
            continue
        t0 = time.perf_counter()
        (got,) = perturb_cases([bases[font]], level, seed=GAUNTLET_PERTURB_SEED)
        ms = (time.perf_counter() - t0) * 1e3
        d = np.abs(got.image.astype(np.int16) - c.image.astype(np.int16))
        n, delta = int((d > 0).sum()), int(d.max())
        rows.append((tier, n, d.size, delta, ms))
        if not np.array_equal(got.mask, c.mask):
            bad.append(f"{tier}: mask differs from JAX's in {int((got.mask != c.mask).sum())} bytes")
        if n > AUG_MAX_SHARE * d.size or delta > AUG_MAX_DELTA:
            bad.append(f"{tier}: {n} image bytes differ (max |d| {delta}), above "
                       f"{AUG_MAX_SHARE:.1%} or {AUG_MAX_DELTA}")
        out.append(got)
    if bad:
        raise AssertionError("; ".join(bad))
    return out, rows


def augment_batch_ms(pages, masks, reps=3):
    """Host ms to draw one augmented b4 batch (``AugmentedDataset.batches``,
    the training fixture at 512²), the median of ``reps`` fresh datasets."""
    from twinvoice_tpu_torch.data.augment import AugmentedDataset

    ms = []
    for r in range(reps):
        ds = AugmentedDataset(ArrayDataset(pages, masks), severity=AUG_SEVERITY,
                              p_clean=AUG_P_CLEAN, seed=AUG_SEED + r)
        t0 = time.perf_counter()
        next(ds.batches(len(pages), rng=np.random.default_rng(r)))
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def augmented_fit(card):
    """(c): ``fit`` of the bundled w64 on ``AugmentedDataset`` of the
    training fixture and the same ``fit`` on the plain dataset, both from
    the bundled weights; the augmented run's last checkpoint served against
    the plain path. → K1's launches in the serving call."""
    import tempfile

    from twinvoice_tpu_torch.data.augment import AugmentedDataset

    fix = train_fixture()
    mcfg = VARIANTS["w64"][1]
    bundled = load_npz(variant_path("w64"))
    aug_ms = augment_batch_ms(fix["pages"], fix["masks"])
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp, tf32_off():
        start = os.path.join(tmp, "start")
        tcfg = TrainConfig(epochs=2, checkpoint_dir=os.path.join(tmp, "ckpt"),
                           visualize_dir=os.path.join(tmp, "vis"))
        params, state = _copy_to(bundled[0], "cpu"), _copy_to(bundled[1], "cpu")
        ckpt.save(start, TrainState(params, state, make_optimizer(params, tcfg)))
        del params, state
        runs = {}
        # the plain run first, so that the cuDNN warm-up lands on it
        for name, ds in (("plain", ArrayDataset(fix["pages"], fix["masks"])),
                         ("augmented", AugmentedDataset(
                             ArrayDataset(fix["pages"], fix["masks"]), severity=AUG_SEVERITY,
                             p_clean=AUG_P_CLEAN, seed=AUG_SEED))):
            cfg = Config(model=mcfg, train=replace(
                tcfg, checkpoint_dir=os.path.join(tmp, name), visualize=False))
            _, history = fit(ds, cfg, resume_dir=start,
                             log=lambda m: print("   ", m, flush=True))
            runs[name] = history
        losses = [r["loss"] for r in runs["augmented"]]
        if [r["epoch"] for r in runs["augmented"]] != [1, 2] or not np.isfinite(losses).all():
            raise AssertionError(f"augmented fit: epochs {[r['epoch'] for r in runs['augmented']]}, "
                                 f"losses {losses}")
        sec = {k: [r["sec"] for r in v] for k, v in runs.items()}
        # one step an epoch: the prefetch thread starts with the epoch, so the
        # epoch's only batch waits for its augmentation
        exposed_ms = 1e3 * (np.median(sec["augmented"]) - np.median(sec["plain"]))
        print(f"  (c) fit w64 fp32 from the bundled weights on AugmentedDataset(severity "
              f"{AUG_SEVERITY}, p_clean {AUG_P_CLEAN}) of the 4 training pages, b4 512^2, 2 "
              f"epochs of 1 step: losses {np.round(losses, 6).tolist()} (plain dataset "
              f"{np.round([r['loss'] for r in runs['plain']], 6).tolist()}); augmenting a b4 "
              f"batch {aug_ms:.1f} ms on the host (median of 3); epoch seconds augmented "
              f"{np.round(sec['augmented'], 3).tolist()}, plain "
              f"{np.round(sec['plain'], 3).tolist()}: {exposed_ms:.0f} ms an epoch not "
              f"hidden by the prefetch thread "
              f"(one step an epoch leaves it nothing to overlap) [{card}]", flush=True)
        params, state = _copy_to(bundled[0], "cpu"), _copy_to(bundled[1], "cpu")
        latest = ckpt.restore(os.path.join(tmp, "augmented", "latest"),
                              TrainState(params, state, make_optimizer(params, tcfg)))
        if latest.epoch != 2:
            raise AssertionError(f"the augmented checkpoint is at epoch {latest.epoch}")
        npz = os.path.join(tmp, "augmented.npz")
        ckpt.save_params_npz(npz, latest.params, latest.bn_state)
        del latest
        params, state = ckpt.load_params_npz(npz)
    seg = Segmenter(params, state, mcfg, InferConfig(img_size=512), dtype=torch.bfloat16)
    _, boxes, launches = served_vs_plain(seg, params, state, mcfg, fix["pages"],
                                         label="the augmented w64")
    if launches.get(k1.NAME, 0) != 1 or tuple(boxes.shape) != (4, 3, 4):
        raise AssertionError(f"serving the augmented w64 launched {launches}")
    return launches


def phase_augment(card):
    """Phase 29: the perturbation engine and augmented training on the card.
    → the launches of every kernel in the phase."""
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    fix = gauntlet_fixture()
    cases, rows = perturb_tiers_check(fix)
    for tier, n, size, delta, ms in rows:
        print(f"    {tier}: {n} of {size} image bytes differ from JAX's ({n / size:.4%}), "
              f"max |d| {delta}; mask equal; {ms:.1f} ms on the host", flush=True)
    from numpy._core._multiarray_umath import __cpu_features__ as cpu

    simd = [f for f in ("AVX2", "FMA3", "AVX512F", "AVX512_SKX") if cpu.get(f)]
    print(f"  (a) perturb_cases(seed={GAUNTLET_PERTURB_SEED}) rebuilt the {len(rows)} perturbed "
          f"tiers: masks byte-equal, images within {AUG_MAX_SHARE:.1%} / {AUG_MAX_DELTA} "
          f"(numpy {np.__version__}, the host's SIMD {simd}) [{card}]", flush=True)
    port = dict(fix, cases=cases)
    n_tiers = len(dict.fromkeys(fix["tiers"]))
    table = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for route in GAUNTLET_ROUTES:
            seg = gauntlet_segmenter(route, fix)
            got, n = counted(route, GAUNTLET_KERNELS[route], n_tiers,
                             lambda: gauntlet_run(seg, port))
            add(n)
            d_iou, px, eq, total = gauntlet_compare(route, port, got)
            print(f"  (b) {route} on the port's cases: ok flags equal to JAX's on "
                  f"{len(cases)} cases, boxes within one grid cell ({eq}/{total} fields "
                  f"exactly equal), max |ΔIoU| {d_iou:.3g} (tolerance "
                  f"{GAUNTLET_IOU_TOL[route]}), mask pixels differing {px} of "
                  f"{got['mask'].size}; launches {n}", flush=True)
            table += [(f"{route} port cases", got["summary"]),
                      (f"{route} JAX", fix[f"{route}_summary"])]
            del seg
    gauntlet_table(table)
    add(augmented_fit(card))
    return launches


# -- phase 30: image files on the card ------------------------------------------

CODEC_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_codec.npz")
PHONE_SIZE = (4032, 3024)  # (b)'s photos, width and height: a 12 MP phone camera's
PHONE_QUALITY = 95
PHONE_NOISE_SIGMA = 6.0  # (b)'s noisy photo: Gaussian noise on 0-255 values
SMALL_ENCODES = 5  # (b)'s 512² encode: the median of this many


def host_cpu() -> str:
    """The host CPU, which every host time is printed beside: the model name
    and the AVX2 and AVX-512 flags of ``/proc/cpuinfo``'s first processor,
    its cores and numpy's version."""
    model, flags = "model name not given", None
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key.strip() == "model name" and model == "model name not given":
                    model = value.strip()
                elif key.strip() == "flags" and flags is None:
                    flags = value.split()
    except OSError:
        pass
    simd = "/".join(f for f in ("avx2", "avx512f", "avx512bw") if f in (flags or ()))
    return (f"{model}, {os.cpu_count()} cores, {simd or 'no AVX2 flag'}, "
            f"numpy {np.__version__}")


def codec_fixture():
    with np.load(CODEC_FIXTURE) as z:
        fix = {k: z[k] for k in z.files}
    fix["names"] = [str(n) for n in fix["names"]]
    return fix


def codec_files_check(fix, tmp):
    """(a) each fixture file written under ``tmp`` as ``<i>.bin`` (a name that
    says nothing of its format) and read by ``imread_rgb``: byte-equal to
    cv2's RGB; each of the two frames through ``encode_jpeg``: byte-equal
    to ``cv2.imencode``'s bytes. → (files, host ms of all the reads, host ms
    of both encodes)."""
    from twinvoice_tpu_torch.ops.host_imageio import imread_rgb
    from twinvoice_tpu_torch.ops.host_jpeg import encode_jpeg

    bad, read_ms, enc_ms = [], 0.0, 0.0
    for i, name in enumerate(fix["names"]):
        path = os.path.join(tmp, f"{i}.bin")
        fix[f"file_{i}"].tofile(path)
        t0 = time.perf_counter()
        got = imread_rgb(path)
        read_ms += (time.perf_counter() - t0) * 1e3
        want = fix[f"want_{i}"]
        if got is None or got.shape != want.shape or not np.array_equal(got, want):
            bad.append(f"{name}: {None if got is None else got.shape} against {want.shape}")
    for i, q in enumerate(fix["enc_quality"]):
        t0 = time.perf_counter()
        data = encode_jpeg(fix[f"enc_frame_{i}"], int(q))
        enc_ms += (time.perf_counter() - t0) * 1e3
        if data != fix[f"enc_bytes_{i}"].tobytes():
            bad.append(f"encode_jpeg of frame {i} at q{q}: {len(data)} bytes, not cv2's")
    if bad:
        raise AssertionError("codec against cv2: " + "; ".join(bad))
    return len(fix["names"]), read_ms, enc_ms


def phone_photos(page, size=PHONE_SIZE, seed=0):
    """(b)'s two photos at ``size`` (width, height): ``page`` upscaled by
    ``resize_linear_u8``, as smooth as a flat scan, and the same under seeded
    Gaussian noise (σ ``PHONE_NOISE_SIGMA``) and a fine sine texture, as a
    phone's sensor and the paper's grain give a real photo several times
    the entropy-coded data. → {name: uint8 (H, W, 3)}."""
    from twinvoice_tpu_torch.ops.host_image import resize_linear_u8

    smooth = resize_linear_u8(page, *size)
    h, w = smooth.shape[:2]
    texture = 10 * np.sin(0.7 * np.arange(h))[:, None] * np.sin(0.9 * np.arange(w))[None]
    noise = np.random.default_rng(seed).normal(0, PHONE_NOISE_SIGMA, smooth.shape)
    noisy = np.clip(np.rint(smooth + noise + texture[..., None]), 0, 255).astype(np.uint8)
    return {"upscaled page": smooth, "noisy page": noisy}


@contextlib.contextmanager
def scan_timer():
    """Inside the block, ``host_jpeg``'s calls of the host C++ library
    (``jpeg_decode_scan``, ``jpeg_decode_progressive_scan``,
    ``jpeg_smooth_blocks``, ``jpeg_encode_scan``) are timed. → a dict of
    their summed host ms by name, filled as they run."""
    from twinvoice_tpu_torch.ops import host_jpeg

    lib, saved = host_jpeg.codec(), host_jpeg.codec
    ms = dict.fromkeys(("jpeg_decode_scan", "jpeg_decode_progressive_scan",
                        "jpeg_smooth_blocks", "jpeg_encode_scan"), 0.0)

    def timed(name):
        fn = getattr(lib, name)

        def call(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                ms[name] += (time.perf_counter() - t0) * 1e3

        return call

    proxy = types.SimpleNamespace(**{name: timed(name) for name in ms})
    host_jpeg.codec = lambda: proxy
    try:
        yield ms
    finally:
        host_jpeg.codec = saved


def phone_photo_check(photo, quality=PHONE_QUALITY):
    """(b) ``photo`` through ``encode_jpeg`` and ``decode_jpeg``: equal to
    ``jpeg_roundtrip_u8`` of it, byte for byte. → (encode ms, of it the C++
    scan's, decode ms, of it the C++ scan's, round-trip ms, the file's
    bytes), each ms on the host."""
    from twinvoice_tpu_torch.ops.host_jpeg import decode_jpeg, encode_jpeg, jpeg_roundtrip_u8

    with scan_timer() as scan:
        t0 = time.perf_counter()
        data = encode_jpeg(photo, quality)
        t1 = time.perf_counter()
        got = decode_jpeg(data)
        t2 = time.perf_counter()
    want = jpeg_roundtrip_u8(photo, quality)
    t3 = time.perf_counter()
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"decode_jpeg(encode_jpeg(photo)) differs from jpeg_roundtrip_u8 "
                             f"in {int((got != want).sum())} bytes at {photo.shape}")
    return ((t1 - t0) * 1e3, scan["jpeg_encode_scan"], (t2 - t1) * 1e3,
            scan["jpeg_decode_scan"], (t3 - t2) * 1e3, len(data))


def small_encode_ms(page, quality=PHONE_QUALITY, reps=SMALL_ENCODES):
    """(b) the median host ms of ``reps`` ``encode_jpeg`` calls on ``page``
    (a 512² training page, as ``build_one`` writes them). → (ms, bytes)."""
    from twinvoice_tpu_torch.ops.host_jpeg import encode_jpeg

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        data = encode_jpeg(page, quality)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), len(data)


def build_dataset_check(fix, tmp):
    """(c) ``python -m twinvoice_tpu_torch build-dataset --size 512`` through
    ``__main__.main`` on the fixture's labelme photo and JSON under ``tmp``:
    the written ``.jpg`` byte-equal to the JAX package's ``build_one``
    output, the ``.npy`` mask equal. → host ms."""
    from twinvoice_tpu_torch import __main__ as cli

    dirs = {k: os.path.join(tmp, k) for k in ("json", "images", "fixed_images", "fixed_masks")}
    for k in ("json", "images"):
        os.makedirs(dirs[k])
    fix["lm_photo"].tofile(os.path.join(dirs["images"], "photo0.jpg"))
    with open(os.path.join(dirs["json"], "photo0.json"), "w", encoding="utf-8") as f:
        f.write(str(fix["lm_json"]))
    t0 = time.perf_counter()
    cli.main(["build-dataset", "--json-dir", dirs["json"], "--images-dir", dirs["images"],
              "--out-images", dirs["fixed_images"], "--out-masks", dirs["fixed_masks"],
              "--size", "512"])
    ms = (time.perf_counter() - t0) * 1e3
    with open(os.path.join(dirs["fixed_images"], "photo0.jpg"), "rb") as f:
        jpg = f.read()
    mask = np.load(os.path.join(dirs["fixed_masks"], "photo0.npy"))
    if jpg != fix["lm_jpg"].tobytes():
        raise AssertionError(f"build-dataset wrote a {len(jpg)}-byte JPEG, not JAX's "
                             f"{fix['lm_jpg'].size} bytes")
    if mask.shape != fix["lm_mask"].shape or not np.array_equal(mask, fix["lm_mask"]):
        raise AssertionError("build-dataset wrote a mask other than JAX's")
    return ms


def phase_codec(card):
    """Phase 30: the image file codec on the card's machine. It launches no
    kernel of the port. → the host ms of (b)'s decode of the upscaled page."""
    import tempfile

    cpu = host_cpu()
    fix = codec_fixture()
    before = dict(_build.launches)
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp:
        n, read_ms, enc_ms = codec_files_check(fix, tmp)
        print(f"  (a) {n} files read by imread_rgb byte-equal to cv2's RGB in {read_ms:.1f} ms; "
              f"{len(fix['enc_quality'])} encode_jpeg outputs byte-equal to cv2.imencode's in "
              f"{enc_ms:.1f} ms (host: {cpu})", flush=True)
        page = train_fixture()["pages"][0]
        decode_ms = {}
        for kind, photo in phone_photos(page).items():
            e_ms, e_scan, d_ms, d_scan, rt_ms, size = phone_photo_check(photo)
            decode_ms[kind] = d_ms
            print(f"  (b) a {PHONE_SIZE[0]}×{PHONE_SIZE[1]} photo at q{PHONE_QUALITY}, {kind}: "
                  f"encode_jpeg {e_ms:.1f} ms (the C++ scan {e_scan:.1f}; {size} bytes), "
                  f"decode_jpeg {d_ms:.1f} ms (the C++ scan {d_scan:.1f}), equal to "
                  f"jpeg_roundtrip_u8 ({rt_ms:.1f} ms) byte for byte (host: {cpu}) [{card}]",
                  flush=True)
            del photo
        ms, size = small_encode_ms(page)
        print(f"  (b) a {page.shape[1]}×{page.shape[0]} training page at q{PHONE_QUALITY}: "
              f"encode_jpeg {ms:.2f} ms, the median of {SMALL_ENCODES} ({size} bytes; host: "
              f"{cpu})", flush=True)
        os.makedirs(os.path.join(tmp, "lm"))
        ms = build_dataset_check(fix, os.path.join(tmp, "lm"))
        print(f"  (c) build-dataset --size 512 on a {fix['lm_mask'].shape[1]}² target from the "
              f"fixture's photo: the .jpg byte-equal to JAX's build_one output "
              f"({fix['lm_jpg'].size} bytes), the mask equal, in {ms:.1f} ms (host: {cpu})",
              flush=True)
    if dict(_build.launches) != before:
        raise AssertionError(f"phase 30 launched kernels of the port: {before} -> "
                             f"{dict(_build.launches)}")
    return decode_ms["upscaled page"]



# -- phase 31: text rendering without Pillow or FreeType -------------------------

RENDER_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_render.npz")
RENDER_OCR_STEPS = 101  # (c): one past the learning rate's 100-step warmup, at the CLI's batch
RENDER_TIMED_BATCH = 64  # (b): the lines of the batch timed, the CLI's batch size
RENDER_TX_STEPS = 20  # (d)
RENDER_TX_BATCH = 8  # (d): pages a batch
RENDER_TX_POOL = 2  # (d): batches in the cached pool


def render_fixture():
    with np.load(RENDER_FIXTURE) as z:
        fix = {k: z[k] for k in z.files}
    for k in ("sheet_fonts", "registry"):
        fix[k] = [str(n) for n in fix[k]]
    fix["sheet_chars"] = str(fix["sheet_chars"])
    fix["dsheet_chars"] = str(fix["dsheet_chars"])
    fix["batch_kwargs"] = json.loads(str(fix["batch_kwargs"]))
    fix["jax_host"] = str(fix["jax_host"])
    return fix


@contextlib.contextmanager
def render_registry(names):
    """The port's training-font registry cut to the bundled faces ``names``
    (file names, in order) for the fixture's renders, restored after."""
    from twinvoice_tpu_torch.data import synthetic
    from twinvoice_tpu_torch.ocr.torchocr import data as rec_data

    paths = [str(synthetic.BUNDLED_FONTS / n) for n in names]
    old = rec_data._FONT_PATHS, synthetic.train_fonts
    rec_data._FONT_PATHS, synthetic.train_fonts = paths, (lambda: list(paths))
    try:
        yield paths
    finally:
        rec_data._FONT_PATHS, synthetic.train_fonts = old


def _sheet_diff(font, chars, meta, buf, i):
    """The port's masks of ``chars`` against the sheet's from entry ``i``:
    → (glyphs differing, bytes differing, seconds rendering). A glyph whose
    box, offset or length differs counts all the bytes of the larger mask."""
    bad = nbytes = 0
    t = 0.0
    for k, ch in enumerate(chars):
        off, h, w, xo, yo, length = (int(v) for v in meta[i + k])
        want = buf[off:off + h * w].reshape(h, w)
        t0 = time.perf_counter()
        got, goff = font.getmask2(ch)
        t += time.perf_counter() - t0
        if got.shape == want.shape and goff == (xo, yo) and \
                round(font.getlength(ch) * 64) == length:
            d = int((got != want).sum())
        else:
            d = max(got.size, want.size, 1)
        bad += d > 0
        nbytes += d
    return bad, nbytes, t


def render_sheet_check(fix):
    """(a) every glyph of the sheets rendered by the port's ``FreeTypeFont``
    from the bundled copies (the twelve DejaVu faces through the bytecode
    interpreter, Atkinson Hyperlegible Next through the auto-hinter) and by
    ``load_default()`` (Pillow's default font, auto-hinted, BASIC layout):
    → ({font: (glyphs, glyphs differing, bytes differing)}, host µs a
    glyph)."""
    from twinvoice_tpu_torch.data import synthetic
    from twinvoice_tpu_torch.ocr.fonts import truetype

    meta, buf, chars = fix["sheet_meta"], fix["sheet_buf"], fix["sheet_chars"]
    sizes = len(meta) // (len(fix["sheet_fonts"]) * len(chars))
    out, i, t = {}, 0, 0.0
    for name in fix["sheet_fonts"]:
        glyphs = bad = nbytes = 0
        for size in range(10, 10 + sizes):
            b, n, dt = _sheet_diff(truetype.FreeTypeFont(synthetic.BUNDLED_FONTS / name, size),
                                   chars, meta, buf, i)
            glyphs, bad, nbytes, t, i = glyphs + len(chars), bad + b, nbytes + n, t + dt, i + len(chars)
        out[name] = (glyphs, bad, nbytes)
    dchars = fix["dsheet_chars"]
    b, n, dt = _sheet_diff(truetype.load_default(), dchars, fix["dsheet_meta"], fix["dsheet_buf"], 0)
    out["load_default() " + truetype.DEFAULT_FONT.name] = (len(dchars), b, n)
    return out, (t + dt) / (i + len(dchars)) * 1e6


def render_batches_check(fix):
    """(b) the fixture's three recognizer batches and four textness pages
    rendered by the port from the same seeds, on the registry in force (the
    port's own on the card, which phase 31 holds to the fixture's):
    lines, labels, pads, texts, pages, masks and the generator's state after
    each equal; then one batch of ``RENDER_TIMED_BATCH`` lines timed. →
    (host ms a line, ms a batch of 64, ms a page)."""
    from twinvoice_tpu_torch.ocr.torchocr import data as rec_data

    line_s, batch_s = [], []
    for k, kw in enumerate(fix["batch_kwargs"]):
        kw = dict(kw)
        rng = np.random.default_rng(kw.pop("seed"))
        charset = rec_charset.cjk_charset() if kw.pop("cjk", False) else rec_charset.DEFAULT
        n = len(fix[f"b{k}_lines"])
        t0 = time.perf_counter()
        lines, labels, pad, texts = rec_data.make_lines(n, rng, charset, **kw)
        batch_s.append(time.perf_counter() - t0)
        line_s.append(batch_s[-1] / n)
        for name, got in (("lines", lines), ("labels", labels), ("pad", pad)):
            if not np.array_equal(got, fix[f"b{k}_{name}"]):
                raise AssertionError(f"batch {k} ({kw}): {name} differ from JAX's "
                                     f"({int((got != fix[f'b{k}_{name}']).sum())} values)")
        if texts != [str(t) for t in fix[f"b{k}_texts"]]:
            raise AssertionError(f"batch {k}: texts {texts} are not JAX's")
        if json.dumps(rng.bit_generator.state) != str(fix[f"b{k}_state"]):
            raise AssertionError(f"batch {k}: the generator's state differs from JAX's")
    rng = np.random.default_rng(3)
    page_s = []
    for j in range(len(fix["pages"])):
        t0 = time.perf_counter()
        page, mask = ttex.render_textpage(rng)
        page_s.append(time.perf_counter() - t0)
        if not (np.array_equal(page, fix["pages"][j]) and np.array_equal(mask, fix["masks"][j])):
            raise AssertionError(f"textness page {j} differs from JAX's "
                                 f"({int((page != fix['pages'][j]).sum())} pixels)")
    if json.dumps(rng.bit_generator.state) != str(fix["pages_state"]):
        raise AssertionError("pages: the generator's state differs from JAX's")
    t0 = time.perf_counter()
    rec_data.make_lines(RENDER_TIMED_BATCH, np.random.default_rng(0))
    batch64_s = time.perf_counter() - t0
    return float(np.mean(line_s)) * 1e3, batch64_s * 1e3, float(np.mean(page_s)) * 1e3


def train_ocr_cli_check(tmp, device="cuda", steps=RENDER_OCR_STEPS, batch=None):
    """(c) ``python -m twinvoice_tpu_torch train-ocr --steps N --out W``
    without ``--pool`` (a fresh batch of the port's own renders each step,
    of the CLI's 64 lines unless ``batch`` is given), through
    ``__main__.main``, then the weights served by
    ``TorchOcrEngine(weights_dir=W)``. → (seconds, the engine)."""
    from twinvoice_tpu_torch import __main__ as cli
    from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine

    out = os.path.join(tmp, "recognizer.npz")
    argv = ["train-ocr", "--steps", str(steps), "--out", out, "--device", str(device)]
    if batch is not None:
        argv += ["--batch-size", str(batch)]
    t0 = time.perf_counter()
    cli.main(argv)
    secs = time.perf_counter() - t0
    eng = TorchOcrEngine(weights_dir=out, device=device)
    if not eng.available() or eng.arch != "t64":
        raise AssertionError(f"train-ocr's weights do not load: {out}")
    params, state, _, _ = rec_train.load_weights_ex(out)
    if not all(torch.isfinite(torch.as_tensor(np.asarray(v))).all()
               for v in tree_leaves(params) + tree_leaves(state)):
        raise AssertionError("train-ocr wrote weights that are not finite")
    return secs, eng


def textness_own_pages_check(device="cuda", steps=RENDER_TX_STEPS, bs=RENDER_TX_BATCH,
                             pool=RENDER_TX_POOL):
    """(d) the textness head trained from a fresh init for ``steps`` steps
    on a cached pool of its own pages (``train`` without pages). → (seconds,
    the params)."""
    t0 = time.perf_counter()
    params = ttex.train(steps=steps, bs=bs, cache_batches=pool, seed=0, device=device,
                        log=lambda m: print("   ", m, flush=True))
    secs = time.perf_counter() - t0
    if not all(torch.isfinite(p[k]).all() for p in params for k in p):
        raise AssertionError("the textness head trained on its own pages is not finite")
    return secs, params


def phase_render(card):
    """Phase 31: TrueType text, the line and page renderers and the trainers
    that draw their own data, on the card's host. It launches no kernel of
    the port."""
    import tempfile

    from twinvoice_tpu_torch.data import synthetic

    cpu = host_cpu()
    fix = render_fixture()
    before = dict(_build.launches)
    own = [os.path.basename(p) for p in synthetic.train_fonts()]
    if own != fix["registry"]:
        raise AssertionError(f"the port's training fonts here {own} are not the fixture's "
                             f"{fix['registry']}")
    sheet, us = render_sheet_check(fix)
    for name, (glyphs, bad, nbytes) in sheet.items():
        if bad:
            raise AssertionError(f"(a) {name}: {bad} of {glyphs} glyphs ({nbytes} bytes) differ "
                                 f"from Pillow's")
    print(f"  (a) glyph sheets: {sum(g for g, _, _ in sheet.values())} glyphs ({len(sheet) - 1} "
          f"training faces × sizes 10-29 × the charset, Atkinson auto-hinted; Pillow's default "
          f"font × printable ASCII): 0 bytes differ from Pillow 12.1 (FreeType 2.14.1); "
          f"{us:.1f} µs a glyph (host: {cpu})", flush=True)
    line_ms, batch_ms, page_ms = render_batches_check(fix)
    print(f"  (b) 3 make_batch batches of {len(fix['b0_lines'])} lines and "
          f"{len(fix['pages'])} render_textpage pages on the {len(own)} training fonts, equal "
          f"to JAX's with the generator's state: {line_ms:.2f} ms a line, {batch_ms:.1f} ms a "
          f"batch of {RENDER_TIMED_BATCH} (make_lines, default_rng(0)), {page_ms:.1f} ms a page "
          f"(host: {cpu}) [{card}]; for reference, JAX with Pillow and cv2 on another machine "
          f"({fix['jax_host']}): {float(fix['jax_batch64_s']) * 1e3:.0f} ms a batch of 64, "
          f"{float(fix['jax_page_s']) * 1e3:.1f} ms a page", flush=True)
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    device = torch.device("cuda")
    with tf32_off(), tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp:
        secs, eng = train_ocr_cli_check(tmp, device)
        ocr = ocr_fixture()
        texts = [r.text for r in eng.read_batch(ocr["crop_list"][:8],
                                                 modes=[str(m) for m in ocr["crop_modes"][:8]])]
        print(f"  (c) train-ocr --steps {RENDER_OCR_STEPS} (batch 64) without --pool "
              f"(TF32 off): {secs:.1f} s, its weights served by "
              f"TorchOcrEngine: {texts} [{card}]", flush=True)
        secs, params = textness_own_pages_check(device)
        m = ttex.textness_map(fix["pages"][0], params, device=device)
        print(f"  (d) the textness head, {RENDER_TX_STEPS} steps on {RENDER_TX_POOL} batches "
              f"of {RENDER_TX_BATCH} of its own pages: {secs:.1f} s; its map of a fixture "
              f"page has {int(m.sum())} text pixels [{card}]", flush=True)
    if dict(_build.launches) != before:
        raise AssertionError(f"phase 31 launched kernels of the port: {before} -> "
                             f"{dict(_build.launches)}")

# -- phase 32: the invoice renderer and the gauntlet from nothing ------------------

INVOICE_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_invoice.npz")
INVOICE_HELD_ROUTES = ("w16_fp32", "w16_int8")  # per case against JAX's
INVOICE_TIMED = 8  # pages a kind timed (seeds 0-7), as the fixture timed JAX's


def scripts_module(name):
    """A module of ``scripts/`` (the fixture scripts import only numpy and
    the standard library at their top)."""
    import importlib

    scripts = os.path.join(ROOT, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


def invoice_script():
    """``scripts/make_torch_smoke_invoice.py``: the fixture's bases, tiers,
    knob grid and digest."""
    return scripts_module("make_torch_smoke_invoice")


def invoice_fixture():
    with np.load(INVOICE_FIXTURE) as z:
        fix = {k: z[k] for k in z.files}
    for k in ("grid_kwargs", "e2e_records", "jax_ms") + tuple(
            k for k in fix if k.endswith("_summary") or k.endswith("_content")):
        fix[k] = json.loads(str(fix[k]))
    for k in ("train_registry", "heldout_registry", "tiers"):
        fix[k] = [str(t) for t in fix[k]]
    fix["jax_host"] = str(fix["jax_host"])
    return fix


@contextlib.contextmanager
def invoice_registries(fix):
    """The port's training and held-out registries cut to the fixture's
    bundled faces (the card's own: on the card this changes nothing),
    restored after. → {file name: path}."""
    from twinvoice_tpu_torch.data import synthetic

    train = [str(synthetic.BUNDLED_FONTS / n) for n in fix["train_registry"]]
    held = [str(synthetic.BUNDLED_FONTS / n) for n in fix["heldout_registry"]]
    old = synthetic.train_fonts, synthetic.heldout_fonts
    synthetic.train_fonts, synthetic.heldout_fonts = (lambda: list(train)), (lambda: list(held))
    try:
        yield {os.path.basename(p): p for p in train + held}
    finally:
        synthetic.train_fonts, synthetic.heldout_fonts = old


def invoice_pages_check(fix_pages):
    """(a) first: the four pages of ``torch_smoke_pages.npz`` re-rendered from
    ``scripts/make_torch_smoke_pages.py``'s arguments, in Pillow's luma."""
    from twinvoice_tpu_torch.data.synthetic import render_invoice

    args = scripts_module("make_torch_smoke_pages").PAGES
    for i, kw in enumerate(args):
        got = render_invoice(**kw)[0].convert("L").array
        if not np.array_equal(got, fix_pages[i]):
            raise AssertionError(f"(a) page {i} ({kw}): {int((got != fix_pages[i]).sum())} "
                                 f"pixels differ from JAX's")
    return len(args)


def invoice_grid_check(fix, paths, calls=None):
    """(a): the knob grid's pages and boxes (all, or the first ``calls``)
    against JAX's digests, the stored pages byte for byte. → pages checked."""
    from twinvoice_tpu_torch import FIELDS
    from twinvoice_tpu_torch.data.synthetic import render_invoice

    M = invoice_script()
    grid = fix["grid_kwargs"][:calls]
    bad = []
    for i, kw in enumerate(grid):
        img, boxes = render_invoice(**M.resolve(kw, paths))
        if f"grid_page{i}" in fix and not np.array_equal(img.array, fix[f"grid_page{i}"]):
            bad.append(f"grid {i} {kw}: the stored page differs")
        if M.digest(img.array) != str(fix["grid_sha"][i]):
            bad.append(f"grid {i} {kw}: the page's digest is not JAX's")
        got = np.asarray([boxes[f] for f in FIELDS], np.int32)
        if not np.array_equal(got, fix["grid_boxes"][i]):
            bad.append(f"grid {i} {kw}: boxes {got.tolist()} != JAX "
                       f"{fix['grid_boxes'][i].tolist()}")
    if bad:
        raise AssertionError("; ".join(bad))
    return len(grid)


def invoice_page_ms():
    """Host ms a page of the port's renderer: plain, stylized at 1.0 and
    dot-matrix, over seeds 0-7 (the fixture timed JAX's so)."""
    from twinvoice_tpu_torch.data.synthetic import render_invoice

    out = {}
    for name, kw in (("plain", {}), ("stylized", {"stylize": 1.0}), ("dot", {"dot_print": True})):
        t0 = time.perf_counter()
        for seed in range(INVOICE_TIMED):
            render_invoice(seed=seed, **kw)
        out[name] = (time.perf_counter() - t0) * 1e3 / INVOICE_TIMED
    return out


def timed_perturb(cases, level, seed):
    """``perturb_cases`` and its host seconds (a process pool's task)."""
    from twinvoice_tpu_torch.eval import perturb_cases

    t0 = time.perf_counter()
    out = perturb_cases(cases, level, seed=seed)
    return out, time.perf_counter() - t0


def invoice_cases_check(fix, n=None, level_sets=None, workers=1):
    """(b): ``make_base_cases(n)`` (default: the fixture's 25) for the three
    bases and their tiers (default: all eleven) after ``perturb_cases(...,
    seed=7)``, each case's image, mask and content against JAX's (the
    first ``n`` of each base's and tier's). The tiers are independent (each
    draws from its own generator), so ``workers`` > 1 perturbs them in that
    many processes. → (cases, tiers, host ms a base case per base, host ms
    a perturbed case)."""
    import concurrent.futures
    import multiprocessing

    from twinvoice_tpu_torch.eval import make_base_cases

    M = invoice_script()
    n = M.N_CASES if n is None else n
    digest = M.digest
    bases, ms, bad = {}, {}, []
    for base, kw in M.BASES.items():
        t0 = time.perf_counter()
        bases[base] = make_base_cases(n, **kw)
        ms[base] = (time.perf_counter() - t0) * 1e3 / n
        for i, c in enumerate(bases[base]):
            want = fix[f"{base}_content"][i]
            if [c.invoice_no, c.date, c.amount, c.font] != want:
                bad.append(f"{base} case {i}: content {[c.invoice_no, c.date, c.amount, c.font]}"
                           f" != JAX {want}")
            if digest(c.image) != str(fix[f"{base}_image_sha"][i]):
                bad.append(f"{base} case {i}: image differs from JAX's")
            if digest(c.mask) != str(fix[f"{base}_mask_sha"][i]):
                bad.append(f"{base} case {i}: mask differs from JAX's")
    sets = list(level_sets or M.LEVEL_SETS)
    args = [(bases[base], level, GAUNTLET_PERTURB_SEED) for level, base in sets]
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            done = list(pool.map(timed_perturb, *zip(*args)))
    else:
        done = [timed_perturb(*a) for a in args]
    cases, tiers, t_pert, n_pert = [], [], 0.0, 0
    for (level, base), (got, secs) in zip(sets, done):
        tier = level + M.SUFFIX[base]
        if level != "clean":
            t_pert += secs
            n_pert += len(got)
        first = fix["tiers"].index(tier)
        for i, c in enumerate(got):
            j = first + i
            if digest(c.image) != str(fix["tier_image_sha"][j]):
                bad.append(f"{tier} case {i}: image differs from JAX's")
            if digest(c.mask) != str(fix["tier_mask_sha"][j]):
                bad.append(f"{tier} case {i}: mask differs from JAX's")
        cases += got
        tiers += [tier] * len(got)
    if bad:
        raise AssertionError("; ".join(bad[:20]) + (f" (and {len(bad) - 20} more)"
                                                    if len(bad) > 20 else ""))
    return cases, tiers, ms, t_pert * 1e3 / max(n_pert, 1)


def invoice_route_fix(fix, route, idx):
    """The fixture's JAX results of ``route`` on the cases ``idx``, in the
    keys ``gauntlet_compare`` reads."""
    out = {f"{route}_{k}": fix[f"{route}_{k}"][idx] for k in ("iou", "hit", "ok", "boxes")}
    out[f"{route}_summary"] = fix[f"{route}_summary"]
    return out


def phase_invoice(fix_pages, card):
    """Phase 32: the invoice renderer and the gauntlet from nothing on the
    card: (a) the renderer against JAX's pages, (b) the gauntlet's 275 base
    and tier cases, (c) the gauntlet on four routes, (d) the extractor on
    the three clean tiers. → the launches of every kernel in the phase."""
    from twinvoice_tpu_torch.data import synthetic

    cpu = host_cpu()
    fix = invoice_fixture()
    own = ([os.path.basename(p) for p in synthetic.train_fonts()],
           [os.path.basename(p) for p in synthetic.heldout_fonts()])
    if own != (fix["train_registry"], fix["heldout_registry"]):
        raise AssertionError(f"the port's registries here {own} are not the fixture's "
                             f"{fix['train_registry']}, {fix['heldout_registry']}")
    paths = {os.path.basename(p): p for p in synthetic.train_fonts() + synthetic.heldout_fonts()}
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    before = dict(_build.launches)
    n_pages = invoice_pages_check(fix_pages)
    n_grid = invoice_grid_check(fix, paths)
    ms = invoice_page_ms()
    jms = fix["jax_ms"]
    print(f"  (a) render_invoice: the {n_pages} pages of torch_smoke_pages.npz and the "
          f"{n_grid} pages of the knob grid ({len(fix['train_registry'])} training and "
          f"{len(fix['heldout_registry'])} held-out faces) equal to JAX's, boxes too; "
          f"{ms['plain']:.1f} ms a plain page, {ms['stylized']:.1f} stylized, "
          f"{ms['dot']:.1f} dot-matrix (host: {cpu}) [{card}]; JAX with Pillow and cv2 on "
          f"another machine ({fix['jax_host']}): {jms['page_plain']:.1f}, "
          f"{jms['page_stylized']:.1f}, {jms['page_dot']:.1f}", flush=True)
    t0 = time.perf_counter()
    cases, tiers, case_ms, pert_ms = invoice_cases_check(fix, workers=min(8, os.cpu_count() or 1))
    secs_b = time.perf_counter() - t0
    n_tiers = len(dict.fromkeys(tiers))
    print(f"  (b) make_base_cases({len(cases) // n_tiers}) × 3 and the {n_tiers} tiers: "
          f"{len(cases)} cases equal to JAX's (images, masks, content); "
          + ", ".join(f"{b} {v:.1f} ms a base case" for b, v in case_ms.items())
          + f", {pert_ms:.1f} ms a perturbed case (the tiers in "
          f"{min(8, os.cpu_count() or 1)} processes: {secs_b:.1f} s) (host: {cpu}); JAX on "
          f"{fix['jax_host']}: " + ", ".join(f"{b} {jms['case_' + b]:.1f}" for b in case_ms),
          flush=True)
    if dict(_build.launches) != before:
        raise AssertionError(f"(a)-(b) launched kernels of the port: {before} -> "
                             f"{dict(_build.launches)}")
    port = {"cases": cases, "tiers": tiers, "int8_scales": fix["int8_scales"]}
    table = []
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for route in GAUNTLET_ROUTES:
            seg = gauntlet_segmenter(route, port)
            got, n = counted(route, GAUNTLET_KERNELS[route], n_tiers,
                             lambda: gauntlet_run(seg, port))
            add(n)
            line = (f"  (c) {route}: {len(cases)} cases, launches {n}, "
                    f"{time.perf_counter() - t0:.1f} s since (c) began")
            if route in INVOICE_HELD_ROUTES:
                held = dict(port, **invoice_route_fix(fix, route, slice(None)))
                d_iou, _, eq, total = gauntlet_compare(route, held, got)
                line += (f"; ok flags equal to JAX's, boxes within one grid cell ({eq}/{total} "
                         f"fields exactly equal), max |ΔIoU| {d_iou:.3g} (tolerance "
                         f"{GAUNTLET_IOU_TOL[route]})")
                table.append((f"{route} JAX", fix[f"{route}_summary"]))
            print(line, flush=True)
            table.append((f"{route} port", got["summary"]))
            del seg
    print(f"  {card}", flush=True)
    gauntlet_table(table)
    e2e = {k: fix[k] for k in ("e2e_cases", "e2e_records", "e2e_summary", "e2e_boxes",
                               "e2e_ok")}
    t0 = time.perf_counter()
    add(e2e_check(dict(port, **e2e), card))
    print(f"  (d) {len(e2e['e2e_cases'])} pages in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches

# -- phase 33: the JAX package's Orbax checkpoints -------------------------------

ORBAX_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_orbax.npz")
ORBAX_DIR = os.path.join(ROOT, "tests", "data", "torch_smoke_orbax")
ORBAX_DIRS = {"w16": "w16_params", "w8": "w8_state"}
ORBAX_TOLS = TRAIN_TOLS["fp32"]  # the resumed step, held as phase 21 holds its fp32 step


def orbax_fixture():
    with np.load(ORBAX_FIXTURE) as z:
        return {k: z[k] for k in z.files}


def leaf_digest(leaf) -> str:
    """SHA-256 of a leaf's dtype, shape and C-order bytes, as
    ``scripts/make_torch_smoke_orbax.py`` stores it."""
    import hashlib

    a = np.ascontiguousarray(np.asarray(leaf))
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def flat_leaves(tree, prefix=()):
    """(``/``-joined path, leaf) of a nested dict/list/tuple tree without its
    ``None`` and empty leaves, as the fixture script lists them."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flat_leaves(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in flat_leaves(v, prefix + (str(i),))]
    return [] if tree is None else [("/".join(prefix), tree)]


def orbax_read_check(fix):
    """(a) Both directories read by the port (``train/orbax.py``): every leaf
    bit-equal to orbax's own restore (the fixture's digests), the w16 leaves
    equal to the bundled npz's. → ({tag: host ms to read}, {tag: tree})."""
    from twinvoice_tpu_torch.train import orbax
    from twinvoice_tpu_torch.weights import read_npz_tree

    ms, trees = {}, {}
    for tag, name in ORBAX_DIRS.items():
        t = time.perf_counter()
        tree = orbax.read(os.path.join(ORBAX_DIR, name))
        ms[tag] = 1e3 * (time.perf_counter() - t)
        leaves = flat_leaves(tree)
        if [k for k, _ in leaves] != [str(k) for k in fix[f"{tag}_keys"]]:
            raise AssertionError(f"{name}: the port reads the leaves "
                                 f"{[k for k, _ in leaves][:4]}..., orbax "
                                 f"{[str(k) for k in fix[f'{tag}_keys']][:4]}...")
        bad = [k for (k, v), want in zip(leaves, fix[f"{tag}_digests"])
               if leaf_digest(v) != str(want)]
        if bad:
            raise AssertionError(f"{name}: {len(bad)} leaves differ from orbax's, {bad[:3]}")
        trees[tag] = tree
    for part, want in zip(("params", "bn_state"), read_npz_tree(variant_path("w16"))):
        got, ref = dict(keystr_items(trees["w16"][part])), dict(keystr_items(want))
        if set(got) != set(ref) or any(got[k].dtype != ref[k].dtype
                                       or not np.array_equal(got[k], ref[k]) for k in ref):
            raise AssertionError(f"w16_params {part}: not the bundled w16 weights")
    return ms, trees


def orbax_resume_check(fix, tree, device):
    """(d) ``restore`` of ``w8_state`` into a fresh port ``TrainState`` on
    ``device``: params, BN state, epoch, best loss, each leaf's ``step``,
    ``exp_avg`` and ``exp_avg_sq`` exactly the checkpoint's; then one step on
    the fixture's next batch held to the float64 step and to JAX's with
    ``ORBAX_TOLS``. → (restore ms, the step's loss, a summary line)."""
    from twinvoice_tpu_torch.config import UNetConfig
    from twinvoice_tpu_torch.models.unet import init_unet
    from twinvoice_tpu_torch.weights import from_jax_params

    mcfg, tcfg = UNetConfig(base_width=8), TrainConfig()
    params, bn = init_unet(torch.Generator().manual_seed(0), mcfg, device=device)
    state = TrainState(params, bn, make_optimizer(params, tcfg))
    t = time.perf_counter()
    ckpt.restore(os.path.join(ORBAX_DIR, ORBAX_DIRS["w8"]), state)
    restore_ms = 1e3 * (time.perf_counter() - t)
    if (state.epoch, state.best_loss) != (int(fix["epoch"]), float(fix["best_loss"])):
        raise AssertionError(f"restored epoch {state.epoch}, best loss {state.best_loss}; "
                             f"saved {int(fix['epoch'])}, {float(fix['best_loss'])}")
    adam = tree["opt_state"]["inner_state"][0]
    jp, js = from_jax_params(tree["params"], tree["bn_state"])
    mu = dict(keystr_items(from_jax_params(adam["mu"], tree["bn_state"])[0]))
    nu = dict(keystr_items(from_jax_params(adam["nu"], tree["bn_state"])[0]))
    want_p, want_s = dict(keystr_items(jp)), dict(keystr_items(js))
    lr = float(tree["opt_state"]["hyperparams"]["learning_rate"])
    for name, p in keystr_items(state.params):
        st = state.optimizer.state[p]
        if not (float(st["step"]) == float(fix["count"])
                and torch.equal(p.detach().cpu(), want_p[name])
                and torch.equal(st["exp_avg"].cpu(), mu[name])
                and torch.equal(st["exp_avg_sq"].cpu(), nu[name])):
            raise AssertionError(f"{name}: the restored param or its AdamW state is not the "
                                 "checkpoint's")
    if any(not torch.equal(t.cpu(), want_s[k]) for k, t in keystr_items(state.bn_state)):
        raise AssertionError("the restored BN state is not the checkpoint's")
    if any(g["lr"] != lr for g in state.optimizer.param_groups):
        raise AssertionError(f"restored lr {[g['lr'] for g in state.optimizer.param_groups]}, "
                             f"saved {lr}")

    images, masks = next(ArrayDataset(fix["images"], fix["masks"]).batches(4, shuffle=False))
    x, y = to_device_batch(images, masks, torch.float32, device)
    before = dict(keystr_items(to_jax_params(state.params, state.bn_state)[0]))
    step = make_train_step(mcfg, tcfg, device=device)
    with tf32_off():
        _, new_bn, loss = step(state.params, state.bn_state, state.optimizer, x, y,
                               float(fix["lr"]))
    loss = float(loss)
    jp1, js1 = to_jax_params(state.params, new_bn)
    grads = dict(keystr_items(to_jax_params(_tree_map(lambda t: t.grad, state.params),
                                            new_bn)[0]))
    after = dict(keystr_items(jp1))
    skeys = [str(k) for k in fix["state_keys"]]
    bn_after = dict(keystr_items(js1))
    bn_got = np.concatenate([bn_after[k].reshape(-1) for k in skeys])

    tol, fails = ORBAX_TOLS, []
    ex, jl = float(fix["exact_loss"]), float(fix["jax_loss"])
    if abs(loss - ex) > tol["loss"] * ex or abs(loss - jl) > abs(jl - ex) * 1.01 + tol["loss"] * ex:
        fails.append(f"loss {loss:.8f}, exact {ex:.8f}, JAX {jl:.8f}")
    pkeys = [str(k) for k in fix["param_keys"]]
    worst_g = worst_s = (0.0, "")
    for i, key in enumerate(pkeys):
        g = grads[key].astype(np.float64)
        gn, en = np.linalg.norm(g), fix["exact_grad_norms"][i]
        if pre_bn_bias(key):
            kern = fix["exact_grad_norms"][pkeys.index(key.replace("['bias']", "['kernel']"))]
            if gn > tol["bias"] * kern:
                fails.append(f"{key}: gradient norm {gn:.3e} (exactly 0)")
        else:
            gs = g.reshape(-1)[fix["sample_idx"][i]]
            err = max(abs(gn - en), np.abs(gs - fix["exact_grad_sample"][i]).max()) / en
            worst_g = max(worst_g, (err, key))
            if err > tol["grad"]:
                fails.append(f"{key}: gradient {err:.3e} of its norm from exact")
        sn = np.linalg.norm((after[key] - before[key]).astype(np.float64))
        jn = fix["jax_step_norms"][i]
        rel = abs(sn - jn) / jn
        if not pre_bn_bias(key):  # a pre-BN bias steps on rounding noise on both sides
            worst_s = max(worst_s, (rel, key))
            if rel > tol["step"]:
                fails.append(f"{key}: step norm {sn:.5e}, JAX {jn:.5e}")
    bn_exact = rel_dist(bn_got, fix["exact_bn"])
    bn_jax = rel_dist(bn_got, fix["jax_bn"])
    bn_own = rel_dist(fix["jax_bn"], fix["exact_bn"])
    if bn_exact > tol["bn1"] or bn_jax > bn_own * 1.01 + tol["bn1"]:
        fails.append(f"BN state: {bn_exact:.3e} from exact, {bn_jax:.3e} from JAX")
    line = (f"loss {loss:.8f} (exact {ex:.8f}, JAX {jl:.8f}); gradients worst "
            f"{worst_g[0]:.2e} of their norm from exact ({worst_g[1]}); step norms worst "
            f"{worst_s[0]:.2e} from JAX's ({worst_s[1]}); BN state {bn_exact:.2e} from exact, "
            f"{bn_jax:.2e} from JAX")
    if fails:
        raise AssertionError("the resumed step:\n" + "\n".join(fails))
    return restore_ms, loss, line


def orbax_fit_check(fix, device, tmp):
    """(e) ``fit(resume_dir=w8_state)`` for one more epoch of one step (the
    fixture's four images at batch 4): it starts at epoch 3, not from
    scratch. → the history."""
    from twinvoice_tpu_torch.config import UNetConfig

    cfg = Config(model=UNetConfig(base_width=8),
                 train=replace(TrainConfig(), epochs=int(fix["epoch"]) + 1,
                               checkpoint_dir=os.path.join(tmp, "ck"),
                               visualize_dir=os.path.join(tmp, "vis")))
    logs = []
    state, history = fit(ArrayDataset(fix["images"], fix["masks"]), cfg, device=device,
                         resume_dir=os.path.join(ORBAX_DIR, ORBAX_DIRS["w8"]), log=logs.append)
    resumed = [m for m in logs if m.startswith("resumed from")]
    if ([h["epoch"] for h in history] != [int(fix["epoch"]) + 1] or not resumed
            or state.epoch != int(fix["epoch"]) + 1):
        raise AssertionError(f"fit from the JAX state ran epochs {[h['epoch'] for h in history]}"
                             f" (log {logs[:2]})")
    return history


def orbax_serve_check(fix, pages_fix, fix8):
    """(b)-(c) ``Segmenter.from_checkpoint(w16_params)`` on the card at fp32
    (boxes and ok flags equal to JAX's ``from_checkpoint``), K1 held to its
    plain version on the served logits at fp32 and bf16, the int8 "pallas"
    and "pallas trunk" routes held to ``torch_smoke_int8.npz`` as phase 9
    holds them, and ``compat.load_model`` on the same directory. → the
    launches of every kernel in the served calls."""
    from twinvoice_tpu_torch import compat
    from twinvoice_tpu_torch.config import UNetConfig
    from twinvoice_tpu_torch.train.checkpoint import restore_params

    d = os.path.join(ORBAX_DIR, ORBAX_DIRS["w16"])
    _, mcfg, grid = VARIANTS["w16"]
    icfg = InferConfig(img_size=grid)
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    rgb = np.repeat(pages_fix["pages"][..., None], 3, axis=-1)
    with tf32_off():
        seg = Segmenter.from_checkpoint(d, mcfg, icfg, torch.float32)
        (_, boxes, ok), n = counted("fp32", {k1.NAME: 1}, 1, lambda: seg.segment_batch(
            rgb, pre_resized=False, return_masks=False))
        add(n)
        boxes, ok = boxes.cpu().numpy(), ok.cpu().numpy()
        if not (np.array_equal(ok, fix["pages_ok"]) and np.array_equal(boxes, fix["pages_boxes"])):
            raise AssertionError(f"from_checkpoint fp32: ok {ok.tolist()}, boxes "
                                 f"{boxes.tolist()}; JAX's ok {fix['pages_ok'].tolist()}, "
                                 f"boxes {fix['pages_boxes'].tolist()}")
        print(f"  (b) from_checkpoint(w16_params) fp32 on the {len(rgb)} pages: ok and pixel "
              f"boxes equal to JAX's from_checkpoint; launches {n}", flush=True)
        params, state = restore_params(d, mcfg)
        train_pages = train_fixture()["pages"]
        for dtype in (torch.float32, torch.bfloat16):
            s = seg if dtype == torch.float32 else Segmenter.from_checkpoint(d, mcfg, icfg, dtype)
            *_, n = served_vs_plain(s, params, state, mcfg, train_pages,
                                    label="the Orbax w16 weights")
            add(n)

    calib = fix8["calib"]
    rgb8 = np.repeat(calib[..., None], 3, axis=-1)
    h, w = pages_fix["pages"].shape[1:]
    sizes = np.tile(np.asarray([[w, h]], np.int32), (len(rgb8), 1))
    tol_px = -(-max(h, w) // calib.shape[1]) + 1
    scales = quant.scales_from_array(fix8["scales"])
    thr = probability_to_logit_thresholds((0.25, 0.40, 0.30))
    for route in ("pallas", "pallas trunk"):
        s = Segmenter.from_checkpoint(d, mcfg, icfg, torch.float32, int8_scales=scales,
                                      **ROUTE_ARGS[route])
        (_, boxes, ok), n = counted(route, ROUTE_KERNELS[route], 1,
                                    lambda: s.segment_batch(rgb8, sizes, return_masks=False))
        add(n)
        px = ok_check(route, ok, boxes, fix8["pallas_ok"], fix8["pallas_boxes"], tol_px)
        msg = f"pixel boxes within {tol_px} px, exactly equal {px[0]}/{px[1]}"
        if route == "pallas":
            q = s.qparams
            with torch.inference_mode():
                grids = k2.bbox_from_rowcol_max(*quant.unet_apply_quantized_rowcol_max(
                    q, torch.as_tensor(rgb8, device="cuda")), thr - q["out"]["bias"].cpu())
            exact = grid_check(route, *grids, fix8["pallas_grid_boxes"],
                               fix8["pallas_grid_valid"])
            msg = f"grid boxes exactly equal {exact[0]}/{exact[1]}; " + msg
        print(f"  (b) from_checkpoint(w16_params) int8 {route} vs JAX pallas: ok equal; {msg}; "
              f"launches {n}", flush=True)

    saved = compat.UNetConfig, compat.InferConfig
    compat.UNetConfig, compat.InferConfig = (lambda: UNetConfig(base_width=16),
                                             lambda: InferConfig(img_size=grid))
    compat._segmenters.clear()
    try:
        with tf32_off():
            seg = compat.load_model(d, dtype=torch.float32)
            (_, cboxes, cok), n = counted("compat", {k1.NAME: 1}, 1, lambda: seg.segment_batch(
                rgb, pre_resized=False, return_masks=False))
    finally:
        compat.UNetConfig, compat.InferConfig = saved
        compat._segmenters.clear()
    add(n)
    if not (np.array_equal(cok.cpu().numpy(), fix["pages_ok"])
            and np.array_equal(cboxes.cpu().numpy(), fix["pages_boxes"])):
        raise AssertionError("compat.load_model(w16_params): boxes differ from JAX's")
    print(f"  (c) compat.load_model(w16_params) fp32: boxes equal to JAX's from_checkpoint; "
          f"launches {n}", flush=True)
    return launches


def phase_orbax(pages_fix, fix8, card):
    """Phase 33: the JAX package's Orbax checkpoints (committed under
    ``tests/data/torch_smoke_orbax/``) read by the port with its own zstd,
    OCDBT and zarr code, served and resumed on the card. → the launches of
    every kernel in the phase."""
    import tempfile

    fix = orbax_fixture()
    cpu = host_cpu()
    ms, trees = orbax_read_check(fix)
    print(f"  (a) read with the port's zstd/OCDBT/zarr: w16_params "
          f"{len(fix['w16_keys'])} leaves in {ms['w16']:.1f} ms, w8_state "
          f"{len(fix['w8_keys'])} leaves in {ms['w8']:.1f} ms, every leaf bit-equal to "
          f"orbax's restore (host: {cpu}) [{card}]", flush=True)
    launches = orbax_serve_check(fix, pages_fix, fix8)
    before = dict(_build.launches)
    restore_ms, _, line = orbax_resume_check(fix, trees["w8"], torch.device("cuda"))
    print(f"  (d) restore(w8_state) into a fresh TrainState on the card in {restore_ms:.1f} ms: "
          f"epoch, best loss, params, BN state, AdamW step and moments exact; the resumed "
          f"step: {line}", flush=True)
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp:
        history = orbax_fit_check(fix, "cuda", tmp)
    print(f"  (e) fit(resume_dir=w8_state): resumed at epoch {int(fix['epoch'])}, ran epoch "
          f"{history[0]['epoch']} (loss {history[0]['loss']:.6f}) [{card}]", flush=True)
    if dict(_build.launches) != before:
        raise AssertionError(f"(d)-(e) launched kernels of the port: {before} -> "
                             f"{dict(_build.launches)}")
    return launches


# -- phase 34: the JPEG forms cv2 reads beyond baseline --------------------------

JPEGFORMS_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_jpegforms.npz")


def jpegforms_fixture():
    """The fixture of ``scripts/make_torch_smoke_jpegforms.py``."""
    with np.load(JPEGFORMS_FIXTURE) as z:
        fix = {k: z[k] for k in z.files}
    for k in ("names", "reasons", "lm_names"):
        fix[k] = [str(n) for n in fix[k]]
    return fix


def array_digest(a: np.ndarray) -> str:
    """SHA-256 of an array's dtype, shape and bytes (the fixture script's
    ``digest``)."""
    import hashlib

    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def jpegforms_files_check(fix, tmp):
    """(a) each fixture file written under ``tmp`` as ``<i>.bin`` (a name that
    says nothing of its format) and read by ``imread_rgb``: byte-equal to
    cv2's RGB, or, where cv2 reads nothing, a ``ValueError`` that names the
    fixture's reason. → (files, of them refused, host ms of all the reads)."""
    from twinvoice_tpu_torch.ops.host_imageio import imread_rgb

    bad, refused, read_ms = [], 0, 0.0
    for i, (name, reason) in enumerate(zip(fix["names"], fix["reasons"])):
        path = os.path.join(tmp, f"{i}.bin")
        fix[f"file_{i}"].tofile(path)
        want = fix[f"want_{i}"]
        t0 = time.perf_counter()
        try:
            got = imread_rgb(path)
        except ValueError as e:
            if not reason or reason not in str(e):
                bad.append(f"{name}: raised {e}")
            refused += 1
            continue
        finally:
            read_ms += (time.perf_counter() - t0) * 1e3
        if reason:
            bad.append(f"{name}: read, where cv2 reads nothing ({reason})")
        elif got is None or got.shape != want.shape or not np.array_equal(got, want):
            bad.append(f"{name}: {None if got is None else got.shape} against {want.shape}"
                       + ("" if got is None or got.shape != want.shape else
                          f", {int((got != want).sum())} bytes differ"))
    if bad:
        raise AssertionError("JPEG forms against cv2: " + "; ".join(bad))
    return len(fix["names"]), refused, read_ms


def jpegforms_photo_check(fix):
    """(b) the progressive phone photo through ``decode_jpeg``: the SHA-256
    of its RGB is cv2's. → (host ms, of it the C++ scans', of it the block
    smoothing's, (width, height), the file's bytes)."""
    from twinvoice_tpu_torch.ops.host_jpeg import decode_jpeg

    data = fix["photo"].tobytes()
    with scan_timer() as scan:
        t0 = time.perf_counter()
        rgb = decode_jpeg(data)
        ms = (time.perf_counter() - t0) * 1e3
    w, h = (int(v) for v in fix["photo_size"])
    if rgb.shape != (h, w, 3) or array_digest(rgb) != str(fix["photo_sha"]):
        raise AssertionError(f"the progressive photo decodes to {rgb.shape}, not cv2's "
                             f"{w}×{h} pixels")
    return ms, scan["jpeg_decode_progressive_scan"], scan["jpeg_smooth_blocks"], (w, h), len(data)


def jpegforms_build_check(fix, tmp):
    """(c) ``python -m twinvoice_tpu_torch build-dataset --size 512``
    through ``__main__.main`` on the labelme case (a progressive photo and a
    CMYK one): each ``.jpg`` byte-equal to the JAX package's ``build_one``
    output and each ``.npy`` mask equal; then ``load_invoice_dataset`` on the
    build's output and on the two photos themselves (zero masks of their
    size): the digests of its arrays are those of the JAX package's. → (host
    ms of the build, of the two loads)."""
    from twinvoice_tpu_torch import __main__ as cli
    from twinvoice_tpu_torch.data.dataset import load_invoice_dataset

    dirs = {k: os.path.join(tmp, k) for k in ("json", "images", "fixed_images", "fixed_masks",
                                              "zero_masks")}
    for k in ("json", "images", "zero_masks"):
        os.makedirs(dirs[k])
    for name in fix["lm_names"]:
        fix[f"lm_photo_{name}"].tofile(os.path.join(dirs["images"], f"{name}.jpg"))
        meta = json.loads(str(fix[f"lm_json_{name}"]))
        with open(os.path.join(dirs["json"], f"{name}.json"), "w", encoding="utf-8") as f:
            f.write(str(fix[f"lm_json_{name}"]))
        np.save(os.path.join(dirs["zero_masks"], f"{name}.npy"),
                np.zeros((meta["imageHeight"], meta["imageWidth"], 3), np.uint8))
    t0 = time.perf_counter()
    cli.main(["build-dataset", "--json-dir", dirs["json"], "--images-dir", dirs["images"],
              "--out-images", dirs["fixed_images"], "--out-masks", dirs["fixed_masks"],
              "--size", "512"])
    build_ms = (time.perf_counter() - t0) * 1e3
    bad = []
    for name in fix["lm_names"]:
        with open(os.path.join(dirs["fixed_images"], f"{name}.jpg"), "rb") as f:
            jpg = f.read()
        mask = np.load(os.path.join(dirs["fixed_masks"], f"{name}.npy"))
        if jpg != fix[f"lm_jpg_{name}"].tobytes():
            bad.append(f"{name}.jpg: {len(jpg)} bytes, not JAX's {fix[f'lm_jpg_{name}'].size}")
        if mask.shape != fix[f"lm_mask_{name}"].shape or not np.array_equal(
                mask, fix[f"lm_mask_{name}"]):
            bad.append(f"{name}.npy: a mask other than JAX's")
    t0 = time.perf_counter()
    for key, (img_dir, mask_dir) in (("load_built_sha", ("fixed_images", "fixed_masks")),
                                     ("load_photos_sha", ("images", "zero_masks"))):
        ds = load_invoice_dataset(dirs[img_dir], dirs[mask_dir])
        got = [array_digest(ds.images), array_digest(ds.masks)]
        if ds.names != tuple(sorted(fix["lm_names"])) or got != [str(d) for d in fix[key]]:
            bad.append(f"load_invoice_dataset({img_dir}): {ds.names}, arrays other than JAX's")
    load_ms = (time.perf_counter() - t0) * 1e3
    if bad:
        raise AssertionError("build-dataset on progressive and CMYK photos: " + "; ".join(bad))
    return build_ms, load_ms


def jpegforms_serve_check(fix, tmp, device="cuda"):
    """(d) the labelme case's progressive photo read by ``imread_rgb`` and
    served by the bundled w16 at fp32 through the raw path (TF32 off): its
    boxes and ok flags equal to the JAX package's on cv2's pixels, K1 held
    to its plain version on the served logits by ``served_vs_plain``. → the
    launches of the served call."""
    from twinvoice_tpu_torch.ops.host_imageio import imread_rgb

    path = os.path.join(tmp, "served.bin")
    fix["lm_photo_prog"].tofile(path)
    photo = imread_rgb(path)[None]
    params, state = load_npz(variant_path("w16"))
    mcfg = VARIANTS["w16"][1]
    with tf32_off():
        seg = load_pretrained_segmenter(torch.float32, variant="w16", device=device)
        ok, boxes, launches = served_vs_plain(seg, params, state, mcfg, photo, raw=True,
                                              device=device, label="the bundled w16 fp32")
    boxes = boxes.cpu().numpy()
    if not (np.array_equal(ok[0], fix["serve_ok"]) and np.array_equal(boxes[0],
                                                                      fix["serve_boxes"])):
        raise AssertionError(f"the progressive photo served: ok {ok[0].tolist()}, boxes "
                             f"{boxes[0].tolist()}; JAX's ok {fix['serve_ok'].tolist()}, "
                             f"boxes {fix['serve_boxes'].tolist()}")
    want = {k1.NAME: 1} if torch.device(device).type == "cuda" else {}
    if launches != want:
        raise AssertionError(f"the served call launched {launches}, not {want}")
    return launches


def phase_jpegforms(card, baseline_ms=None):
    """Phase 34: the JPEG forms ``cv2.imread`` reads beyond baseline
    (progressive with block smoothing, CMYK, YCCK, RGB-coded) through the
    port's codec on the card's host, a progressive photo through
    ``build-dataset`` and ``load_invoice_dataset``, and served on the card.
    ``baseline_ms``: phase 30 (b)'s decode of the same page at the same size
    as a baseline file. → the launches of every kernel in the phase."""
    import tempfile

    cpu = host_cpu()
    fix = jpegforms_fixture()
    _build.build_dir().mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.build_dir()) as tmp:
        before = dict(_build.launches)
        n, refused, read_ms = jpegforms_files_check(fix, tmp)
        print(f"  (a) {n} files read by imread_rgb: {n - refused} byte-equal to cv2's RGB "
              f"(progressive, cut and smoothed, bogus progressions, CMYK, YCCK, RGB-coded), "
              f"{refused} refused where cv2 reads nothing, in {read_ms:.1f} ms (host: {cpu})",
              flush=True)
        ms, scan_ms, smooth_ms, (w, h), size = jpegforms_photo_check(fix)
        base = "not run" if baseline_ms is None else f"{baseline_ms:.1f} ms"
        print(f"  (b) a {w}×{h} progressive q95 photo ({size} bytes): decode_jpeg {ms:.1f} ms "
              f"(the C++ scans {scan_ms:.1f}, block smoothing {smooth_ms:.1f}), its RGB's "
              f"SHA-256 cv2's; phase 30 (b)'s baseline decode of the same page: {base} "
              f"(host: {cpu})", flush=True)
        os.makedirs(os.path.join(tmp, "lm"))
        build_ms, load_ms = jpegforms_build_check(fix, os.path.join(tmp, "lm"))
        print(f"  (c) build-dataset --size 512 on a progressive and a CMYK photo: the .jpg "
              f"files byte-equal to JAX's build_one output, the masks equal, in "
              f"{build_ms:.1f} ms; load_invoice_dataset on the output and on the photos: "
              f"JAX's arrays, in {load_ms:.1f} ms (host: {cpu})", flush=True)
        if dict(_build.launches) != before:
            raise AssertionError(f"(a)-(c) launched kernels of the port: {before} -> "
                                 f"{dict(_build.launches)}")
        launches = jpegforms_serve_check(fix, tmp)
    print(f"  (d) the progressive photo served by the w16 fp32 through the raw path: boxes "
          f"and ok equal to JAX's on cv2's pixels {fix['serve_boxes'].tolist()}; launches "
          f"{launches} [{card}]", flush=True)
    return launches


def main():
    ph = Phases()
    name, card = ph.run(1, "device", phase_device)
    ph.run(2, "build CUDA kernels", phase_build)
    thr = probability_to_logit_thresholds((0.25, 0.40, 0.30))
    max_err = ph.run(3, "K1 vs plain PyTorch on the card", phase_k1, thr)
    with np.load(FIXTURE) as z:
        fix = {k: z[k] for k in z.files}

    _build.launches.clear()  # the main path starts here
    ref = ph.run(4, "w16 fp32 end to end vs JAX", phase_fp32, fix)
    seg = ph.run(5, "w16 bf16 end to end", phase_bf16, fix, ref)
    imgs, serve_calls, bf16_ips = ph.run(6, f"b{SERVE_BATCH} bf16 serving",
                                         phase_serving, seg, fix, card)
    launches = dict(_build.launches)
    calls = 2 + serve_calls  # segment_batch calls in phases 4-6
    if launches.get(k1.NAME, 0) != calls:
        raise AssertionError(f"K1 launched {launches.get(k1.NAME, 0)} times in "
                             f"{calls} segment_batch calls")
    print(f"  launches on the main path: {launches}; K1 per segment_batch call: "
          f"{launches[k1.NAME] / calls:g}", flush=True)
    ms, plain_ms, bound_ms, bound_by = ph.run(
        7, "K1 timing", time_k1, seg, imgs, thr, card)
    del seg, imgs

    with np.load(INT8_FIXTURE) as z:
        fix8 = {k: z[k] for k in z.files}
    k2_err = ph.run(8, "int8 kernels vs plain PyTorch on the card", phase_int8_kernels)
    segs, int8_launches = ph.run(9, "int8 routes vs JAX on the fixture pages",
                                 phase_int8_routes, fix, fix8)
    served, _ = ph.run(10, f"b{SERVE_BATCH} int8 serving", phase_int8_serving, segs,
                       fix, card, bf16_ips)
    del segs
    for k, v in served.items():
        int8_launches[k] = int8_launches.get(k, 0) + v
    print(f"  launches on the int8 routes (phases 9-10): {int8_launches}", flush=True)
    times = ph.run(11, "int8 kernel timing", time_int8_kernels, card)

    with np.load(WPACK_FIXTURE) as z:
        fixw = {k: z[k] for k in z.files}
    k2_err = max(k2_err, ph.run(12, "K7b (and K2's float32 weights) vs plain PyTorch "
                                    "on the card", phase_k7b))
    wsegs, wlaunches = ph.run(13, "W-phase routes vs JAX on the fixture pages",
                              phase_wpack_routes, fix, fix8, fixw)
    wserved, _, k7b_time = ph.run(14, f"b{SERVE_BATCH} W-phase serving and K7b timing",
                                  phase_wpack_serving, wsegs, fix, card)
    del wsegs
    for counts in (wlaunches, wserved):
        for k, v in counts.items():
            int8_launches[k] = int8_launches.get(k, 0) + v
    print(f"  launches on the int8 routes (phases 9-10, 13-14): {int8_launches}",
          flush=True)
    times[nhwc.K7B] = k7b_time

    dma_launches = ph.run(15, "K3b, K3a, K4b and K7a vs plain PyTorch and their "
                              "siblings on the card; the w64 enc0 path",
                          phase_dma_kernels, fix8)
    dma_times = ph.run(16, "K3b, K3a, K4b and K7a timing at the flagship shape",
                       time_dma_kernels, card)

    eng, ocr_fix = ph.run(17, "recognition stack vs JAX on the card", phase_ocr, fix)
    ph.run(18, f"b{OCR_BATCH} recognition throughput", phase_ocr_throughput, eng,
           ocr_fix, card)
    del eng

    fusion_fix, fusion_launches = ph.run(19, "field fusion and the QR pipeline vs JAX "
                                             "on the card", phase_fusion, fix8)
    bulk_launches = ph.run(20, f"b{FUSION_BATCH} bulk extraction throughput",
                           phase_fusion_throughput, fusion_fix, card)
    for counts in (fusion_launches, bulk_launches):
        for k, v in counts.items():
            if k == k1.NAME:
                launches[k] += v
            else:
                int8_launches[k] = int8_launches.get(k, 0) + v
    print(f"  launches of K1 on the main path and phases 19-20: {launches[k1.NAME]}; "
          f"on the int8 routes (phases 9-10, 13-14, 19): {int8_launches}", flush=True)

    ph.run(21, "segmenter training vs the JAX trainer on the card", phase_train_parity, card)
    launches[k1.NAME] += ph.run(22, "w64 training speed, fit, resume and serving",
                                phase_train_w64, card)
    print(f"  launches of K1 on the main path and phases 19-20, 22: {launches[k1.NAME]}",
          flush=True)
    before = dict(_build.launches)
    ph.run(23, "recognizer and textness training vs the JAX trainers on the card",
           phase_ocr_train_parity, card)
    ph.run(24, "recognizer and textness training speed, save and serve",
           phase_ocr_train_speed, card)
    if dict(_build.launches) != before:
        raise AssertionError(f"phases 23-24 launched kernels of the port: {before} -> "
                             f"{dict(_build.launches)}")
    print("  launches in phases 23-24: none (the training paths run no kernel of the port)",
          flush=True)
    launches[k1.NAME] += ph.run(25, "data, tensor, spatial and pipeline parallelism",
                                phase_parallel, card)
    print(f"  launches of K1 on the main path and phases 19-20, 22, 25: {launches[k1.NAME]}",
          flush=True)
    gauntlet_launches = ph.run(26, "serving edges and the gauntlet vs JAX on the card",
                               phase_gauntlet, fix["pages"], card)
    for k, v in gauntlet_launches.items():
        if k == k1.NAME:
            launches[k] += v
        else:
            int8_launches[k] = int8_launches.get(k, 0) + v
    print(f"  launches in phase 26: {gauntlet_launches}; of K1 on the main path and phases "
          f"19-20, 22, 25-26: {launches[k1.NAME]}; on the int8 routes (phases 9-10, 13-14, "
          f"19, 26): {int8_launches}", flush=True)
    qr_launches = ph.run(27, "QR locator, encoder, labelme core and CLI on the card",
                         phase_qr_cli, card)
    launches[k1.NAME] += qr_launches
    print(f"  launches of K1 in phase 27: {qr_launches}; on the main path and phases 19-20, "
          f"22, 25-27: {launches[k1.NAME]}", flush=True)
    app_launches = ph.run(28, "store, app, network OCR engines and CLI app on the card",
                          phase_app, card)
    launches[k1.NAME] += app_launches
    print(f"  launches of K1 in phase 28: {app_launches}; on the main path and phases 19-20, "
          f"22, 25-28: {launches[k1.NAME]}", flush=True)
    aug_launches = ph.run(29, "perturbation engine and augmented training on the card",
                          phase_augment, card)
    for k, v in aug_launches.items():
        if k == k1.NAME:
            launches[k] += v
        else:
            int8_launches[k] = int8_launches.get(k, 0) + v
    print(f"  launches in phase 29: {aug_launches}; of K1 on the main path and phases 19-20, "
          f"22, 25-29: {launches[k1.NAME]}; on the int8 routes (phases 9-10, 13-14, 19, 26, "
          f"29): {int8_launches}", flush=True)

    baseline_ms = ph.run(30, "image files without OpenCV: the codec against cv2, a phone "
                             "photo, build-dataset", phase_codec, card)
    ph.run(31, "TrueType text, the line and page renderers, train-ocr from its own renders",
           phase_render, card)
    invoice_launches = ph.run(32, "the invoice renderer and the gauntlet from nothing",
                              phase_invoice, fix["pages"], card)
    for k, v in invoice_launches.items():
        if k == k1.NAME:
            launches[k] += v
        else:
            int8_launches[k] = int8_launches.get(k, 0) + v
    print(f"  launches in phase 32: {invoice_launches}; of K1 on the main path and phases "
          f"19-20, 22, 25-29, 32: {launches[k1.NAME]}; on the int8 routes (phases 9-10, 13-14, "
          f"19, 26, 29, 32): {int8_launches}", flush=True)

    orbax_launches = ph.run(33, "the JAX package's Orbax checkpoints read, served and resumed",
                            phase_orbax, fix, fix8, card)
    for k, v in orbax_launches.items():
        if k == k1.NAME:
            launches[k] += v
        else:
            int8_launches[k] = int8_launches.get(k, 0) + v
    print(f"  launches in phase 33: {orbax_launches}; of K1 on the main path and phases "
          f"19-20, 22, 25-29, 32-33: {launches[k1.NAME]}; on the int8 routes (phases 9-10, "
          f"13-14, 19, 26, 29, 32-33): {int8_launches}", flush=True)

    jpeg_launches = ph.run(34, "JPEG forms cv2 reads", phase_jpegforms, card, baseline_ms)
    launches[k1.NAME] += jpeg_launches.get(k1.NAME, 0)
    print(f"  launches in phase 34: {jpeg_launches}; of K1 on the main path and phases 19-20, "
          f"22, 25-29, 32-34: {launches[k1.NAME]}", flush=True)

    rows = [(k1.NAME, "bbox_postprocess.cu", "ops/pallas/postprocess.py:52",
             launches[k1.NAME], max_err, (ms, plain_ms, bound_ms, bound_by))]
    MAX_ABS_ERR[k2.NAME] = k2_err
    rows += [(name, src, where, int8_launches[name], MAX_ABS_ERR[name], times[name])
             for name, src, where in (
                 (k2.NAME, "head_rowcol_max.cu", "ops/pallas_head.py:87"),
                 (qconv.K4A, "qconv3x3.cu", "ops/qconv_pallas.py:229"),
                 (qconv.K5, "qconv3x3.cu", "ops/qconv_pallas.py:275"),
                 (k6.K6, "qupsample2x2.cu", "ops/qconv_pallas.py:495"),
                 (nhwc.K7B, "qconv3x3_pair.cu", "ops/nhwc_conv.py:474"))]
    rows += [(kind, src, where, dma_launches[kind], MAX_ABS_ERR[kind], dma_times[kind][:4])
             for kind, (src, where) in DMA_KERNELS.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"twinvoice_tpu_torch/csrc/{src}",
        "replaces": f"twinvoice_tpu/{where}",
        "launches": n,
        "max_abs_err": err,
        "ms": t[0],
        "plain_ms": t[1],
        "bound_ms": t[2],
        "bound_by": t[3],
        "library_ms": None,
    } for name, src, where, n, err, t in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
