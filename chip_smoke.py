#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device and build: print the card's name and power limit, build the
     flash-attention kernels (forward, backward dq and dk/dv) from the
     sources and print ptxas's registers and spills for each kernel, switch
     TF32 and bf16 reduced-precision reductions off;
  2. kernel against its plain PyTorch version on the card, at Transformer-
     base attention shapes (B=8, T=1024, H=8, dh=64, ragged lengths), with
     q, k, v as strided slices of one fused projection (self-attention) and
     as dense tensors (cross-attention), bf16 and f32, causal off and on;
     times of the kernel, the plain version and torch's
     scaled_dot_product_attention (a yardstick only: the port never calls
     it; the kernels it ran on are named from the profiler) beside the
     least time the card could take;
  3. the slice: Transformer-base (32000/32000 vocab) with random weights from
     a seed, bf16 compute, the flash flag on, serving 16 requests with source
     and target lengths in 600-1024 through Inference.infer in two batches of
     8; every distribution finite and summing to 1, 18 kernel launches per
     batch, agreement with the dense attention path on the first batch;
  4. the backward kernels against the plain backward on the card, at the
     same shapes, layouts, dtypes and masks as phase 2: dq, dk and dv (f32
     within 1e-4, bf16 within the derived per-element bar of
     flash_attention_bwd_bar, whose worst |d|/bar is printed), the device
     kernel the bf16 dq launch ran (from the profiler), the time of each
     kernel beside its bound, the plain backward's time and the time of
     scaled_dot_product_attention's backward alone (a yardstick only); and
     two planted faults of the plain backward (ds left unrounded, the
     length mask dropped), each of which must exceed the bf16 bar somewhere
     in these cases;
  4a. the bf16 bar's sweep: seeds x causal off/on x fused/dense operands at
     phase 4's shapes, every gradient within the bar, the worst |d|/bar of
     dq, dk and dv printed;
  4b. edge shapes of the bf16 tensor-core kernels against the plain
     versions: the forward (O, lse) and the backward (dq, dk, dv) at
     T = 200 with dh = 40 (padded to 48 in shared memory), a length-0 row
     and a length that is not a multiple of 16, at dh = 64 and at dh = 128,
     fused and dense operands, causal off and on, at the bars of phases 2
     and 4;
  5. training: Transformer-base (32000/32000, bf16 compute, f32 masters) with
     random weights from a seed, through trainer.SGD(...).train with
     Momentum(0.05 / 1024, 0.9) on batches of 8 with source and target
     lengths in 600-1024 (one of each at 1024, so every slot pads to
     T = 1024): every
     cost finite, the cost falling over repeated steps on one batch, 18
     forward, 18 dq and 18 dk/dv launches per step, one step's gradients
     with flash against the dense path (f32 and bf16 compute), seconds per
     step, tokens per second and peak memory; (5b) the flash kernels' two
     routes, launched straight (training) and through their custom
     operators (``as_graph_ops``, a traced step's route): host µs per call
     of flash_attention and of flash_attention_diff's forward and backward
     at a small shape, and phase 5's seconds per step on each, in turns;
  6. torch.profiler over two training steps: the top device kernels by time,
     the device's busy share of the window, and the dq kernel, which must
     run as fa_bwd_dq_mma_kernel 18 times per step (this shows the main
     path's bf16 dq route; phase 4's lone launches are sometimes missing
     from the profiler's window);
  8. ResNet-50 training at bench.py's configuration (depth 50, 1000
     classes, 224x224x3, batch 128, bf16 compute over f32 masters,
     Momentum(0.01, 0.9): bench.py's rate 0.1 oscillates on the fixed
     batch; random images and labels from a seed) through
     trainer.SGD(...).train, with cuDNN autotuning switched on: one warm-up
     step, 4 timed steps on distinct batches (seconds per step, images/s,
     the convs' analytic FLOPs and their share of the bf16 peak, peak
     memory), 5 steps on one batch (the cost must fall), every batch-norm
     moving statistic moved and finite, and one step's gradients at B=2 on
     the card in f32 held to the CPU's f64 gradient no further than the
     CPU's own f32 gradient is (times 2);
  7. ResNet-50 serving from phase 8's parameters and state through
     Inference.infer: 256 images in two batches of 128, bf16, every
     distribution finite and summing to 1; two images in f32 on the card
     and on the CPU, probabilities and logits compared;
  9. torch.profiler over two ResNet-50 training steps: the top device
     kernels, the busy share, device time by origin (torch's kernels,
     memcpy, cuDNN and cuBLAS) and the layout-transform kernels per step
     beside the convs.  No flash kernel may launch in phases 8, 7, 9.
     Phase 8 also reads the first batch norm's sum |moving mean| in an
     EndPass handler (non-zero, and equal to the value after train
     returns), and takes one step on a batch with a NaN pixel, which the
     divergence sentinel must skip: health 0, and params, layer state and
     optimizer state torch.equal to before;
 10. the training spine at full width, on phase 5's Transformer-base
     configuration (bf16 over f32 masters, flash on, Momentum(0.05 / 1024,
     0.9)): SGD.train over 2 passes of 3 batches with save_dir and
     saving_period=1, an EndPass handler running trainer.test on a
     held-out batch and saving the parameter tar into a buffer; a
     Parameters.from_tar of the last buffer must serve the same batch
     bit-identically to the trained parameters; save_checkpoint after step
     2, and a trainer built from fresh parameters restores it (params,
     momentum and step counter equal to the first trainer's at step 2, bit
     for bit) and trains the remaining 4 batches, whose costs must equal
     the uninterrupted run's bit for bit (or, if a second uninterrupted run
     in this process shows the step is not bit-reproducible, lie within
     three times their spread); bytes and seconds of every save and
     restore, the flash launches over the phase, and seconds per step with
     the sentinel on and off beside phase 5's;
 10b. the eight optimizers on the card: 3 updates of the full
     Transformer-base parameter tree in f32 with gradients from a seeded
     generator, on the card and on the CPU from the same numbers; worst
     |d| / max|param| per leaf <= 1e-5;
 10c. dropout and error clipping on the card: an fc of width 2048 over
     8x1024 tokens with drop_rate 0.1 (bf16): kept share within 5 sigma of
     0.9, kept values equal the undropped ones / 0.9, the same seed gives
     the same mask and the next another, train=False leaves the output
     untouched; an error_clipping_threshold's clipped gradient on the card
     against the CPU's (f32, relative L2 <= 1e-5);
 11. attention-GRU NMT training at bench.py's bench_nmt configuration
     (seq2seq_cost with word and hidden width 512 and vocab 30000/30000,
     bf16 compute over f32 masters, Momentum(0.05, 0.9), bench_nmt's 4096
     pairs with lengths 8-50 drawn beta(2, 3) from RandomState(0)) through
     trainer.SGD(...).train over reader.bucketing.token_budget_batch at
     128 x 64 padded tokens, with the use_bucketing feeder: one warm-up
     step, 4 timed steps (costs, seconds per step, valid target tokens/s,
     peak memory), the decoder's lowering on each step (it fails unless
     every step took the fused attention-GRU core), the recurrences' steps
     run and skipped by the early exit, torch.profiler over two more steps
     (busy share, device kernels per step, top kernels), no flash launch
     over the phase; and one step's gradients in f32 at a small width,
     card against CPU and the fused core against the generic loop on the
     card (relative L2 over every leaf <= 1e-4);
 12. NMT generation at bench.py's bench_nmt_generate configuration (the
     same model in f32 with random weights from a seed, B = 64, beam 5,
     max_length 32, sources of 40 ids from RandomState(0)) through
     Seq2SeqGenerator.generate and generate_greedy on the card: seconds per
     call, top-beam tokens/s by bench.py's count, ms per sentence, and
     torch.profiler over one call of each (device kernels per decode step,
     busy share, top kernels); it fails unless every decoder step took the
     fused attention-GRU step.  At vocab 512, width 64 and 8 rows in f32:
     beam and greedy tokens card == CPU, beam scores within 1e-5 relative,
     and fused == generic stepping on the card;
 13. the ServingEngine at the same width (max_slots 16, block_steps 8,
     max_new_tokens 32, hbm_budget_mb 64: 682 blocks of 16 tokens x 1536
     f32 features) serving 64 requests of 4-30 source tokens drawn as
     bench_serving draws them, admitted as slots free, one preempted after
     the second dispatch and re-admitted, one cancelled after the third:
     requests/s, generated tokens/s, p50 and p99 per-token latency
     ((last token - admission) / tokens, from token_times), decode
     dispatches and shape variants, torch.profiler's busy share over a
     second run; that at the engine's row count a row's product does not
     depend on its position (and which other row counts round it alike);
     and every served request against reference_decode: where its tokens
     leave the one-shot path, the one-shot path's top-2 log-prob gap at
     that step must be below 1e-4 (the count of such requests and the
     largest |d| of the emitted tokens' log-probs over the matching
     prefixes are printed), and the engine's own claim, tokens and
     log-probs bit for bit, must hold.  No flash kernel may launch in
     phases 12 and 13;
 14. LSTM text classification at bench.py's bench_lstm_textcls width (the
     reference's benchmark/paddle/rnn network: embedding 30000 -> 128, two
     simple_lstm(512), last_seq, fc(2, softmax), classification cost; bf16
     over f32 masters, Adam(5e-4), reviews of 100 tokens from
     RandomState(0) in batches of 128) through trainer.SGD(...).train: one
     warm-up step, 4 timed steps on distinct batches (seconds per step,
     reviews/s, tokens/s, peak memory, every timestep run by the LSTM core),
     5 steps on one batch (the cost must fall), torch.profiler over two
     steps (busy share, device kernels per step and per timestep, top
     kernels, and the chain GEMMs, which must be 2 layers x 100 steps
     forward and as many backward), the early exit's steps on a ragged
     batch of bench.py's beta(2, 3) corpus (lengths 10-100), 256 ragged
     reviews served through paddle.infer in batches of 128 (every
     distribution finite and summing to 1), and one step's f32 cost and
     gradients card vs CPU at vocab 512, width 32, 4 ragged rows for a
     forward LSTM, a reverse one and lstmemory_group (relative L2 <= 1e-5);
 15. the CRF sequence tagger (models/sequence_tagging.py ner_crf_cost:
     vocab 30000, 23 IOB labels of 11 chunk types, word and hidden width 32,
     sparse_update=True, f32, Adam(2e-2)) through trainer.SGD(...).train
     with chunk_evaluator and crf_decoding as an extra layer, 200 fresh
     batches of 128 sentences from synthetic_tag_reader: the mean of the
     last 4 costs under half the first 4's, seconds per step, tokens/s,
     chunk F1, torch.profiler over two steps, then a fresh batch decoded by
     paddle.infer(field='id') above 0.9 tag accuracy; and at vocab 512 in
     f32, card vs CPU: the crf cost and gradients (relative L2 <= 1e-5,
     ragged rows with a length-1 sentence) and crf_decoding's paths equal,
     on random weights and on a constructed three-way tie (both take the
     first maximum).  No flash kernel may launch in phases 14 and 15;
 16. bench_lstm_textcls as bench.py runs it, through the v1 front end: a v1
     config (phase 14's network, widths through get_config_arg parsed from
     "hidden_size=512,lstm_num=2,batch_size=128") and a @provider over a
     pickle in the rnn benchmark's schema (512 reviews of 100 tokens from
     RandomState(0)), written to a temporary directory that is removed
     afterwards; parse_config, make_optimizer, make_provider_reader,
     DataFeeder(p.topology.data_types()) and SGD.train in bf16 over f32
     masters: one warm-up step and 4 timed steps (seconds per step,
     reviews/s, tokens/s, peak memory beside phase 14's, every timestep on
     the LSTM core), torch.profiler over two steps; make_batched_reader with
     use_bucketing and a 12800-token budget over 512 reviews of 10-100
     tokens drawn beta(2, 3) (no batch may pad past the budget; rungs and
     valid share printed); card against CPU in f32 at vocab 512, width 32,
     4 ragged rows: the v1-parsed network's cost and gradients, a nested
     batch (4 paragraphs of 1-5 sentences of 2-12 ids) through the feeder
     (its tensors equal on both sides), fc and mixed, and a
     sparse_binary_vector(512) slot through fc(32) as a multi-hot product
     and as the gather-sum of its padded ids (relative L2 <= 1e-5); and the
     pruning hook on the card: fc(2048 -> 512) with HookAttr("pruning",
     0.75) after 5 steps has exactly 0.75 of w0 at zero, at the smallest
     initial magnitudes.  No flash kernel may launch in phase 16;
 17. nested sequences: (a) the reference's hierarchical RNN
     (paddle/gserver/tests/sequence_nest_rnn.conf: an outer recurrent_group
     over SubsequenceInput(embedding) whose step runs an inner group over
     the words, the inner memory booted from the outer memory, which links
     last_seq of the inner sequence; last_seq, fc(2, softmax),
     classification cost) at bench_lstm_textcls's widths (vocab 30000,
     embedding 128, hidden 512), on 128 reviews of 100 tokens from
     RandomState(0) split into sentences of 5-25 tokens, against its flat
     twin (sequence_rnn.conf: one group over the same words, the same
     parameters moved by path): in f32 the cost per row nested == flat
     (rtol 1e-5, atol 1e-6), the gradients nested vs flat and card vs CPU
     (relative L2 <= 1e-5); then bf16 over f32 masters, Adam(5e-4), 8
     steps of each form in turns on the same batches (median s per step,
     reviews/s, nested/flat), and one step of each with its host syncs by
     file:line (torch.cuda's sync debug mode; none may come from the
     layers or the loops), the outer and inner loop steps run and skipped
     (exactly the live ones), peak memory, device kernels and busy share;
     (b) quick_start's trainer_config.cnn.py (embedding 128,
     sequence_conv_pool(context_len=3, hidden_size=512), fc(2, softmax);
     Adam(2e-3) with L2 8e-4 and clipping 25, its settings) on phase 14's
     batches: card vs CPU in f32 at full width, 8 bf16 steps (s per step,
     reviews/s) and a profile of two; (c) each of the 13 new layer types,
     nested and stride pooling and selection, and a sequence memory's
     running sum, card vs CPU in f32 (relative L2 <= 1e-5, ids equal), and
     sampling_id's frequencies over 20,000 draws within 0.02.  No flash
     kernel may launch in phase 17;
 18. the costs, the sampled output layers and the elementwise layers:
     (a) the word2vec N-gram language model of the PaddlePaddle book (4
     context words through one shared embedding of width 32, concat,
     fc(256, sigmoid)) over a dictionary of 10,000 words (the PTB
     vocabulary imikolov ships), through fc(10000, softmax) with
     classification_cost, hsigmoid(num_classes=10000) and nce at 10
     negative samples, uniform and with a Zipf neg_distribution, on batches
     of 256 five-word windows of a Markov stream of Zipf-distributed ids
     from RandomState(0): card vs CPU in f32 (cost relative and gradients
     relative L2 <= 1e-5; nce with a one-hot neg_distribution, so both
     draw the same ids), then 8 bf16 steps of each head in turns with Adam
     over f32 masters (median s per step, windows/s; the cost must fall),
     and for each head one step's host syncs by file:line (none may come
     from the layers), peak memory and a profile of one more (device
     kernels, busy share); (b) nce's sampler on the card: 200,000 draws
     from a 20-class non-uniform distribution, each frequency within 0.005
     of its probability, and no host sync; (c) RankNet (a scoring network
     fc(10, tanh), fc(1) shared by name between the two documents, and
     rank_cost) and LambdaRank (fc(128, tanh), fc(10, tanh), fc(1) over a
     query list, lambda_cost(NDCG_num=6)) over MQ2007's 46 features and
     grades 0-2 on lists of 8-64 documents from RandomState(0): card vs
     CPU in f32 within 1e-5 and 8 bf16 steps each (s per step); (d) every
     type of the slice on the networks of tests/test_layer_grad_sweep.py,
     card vs CPU in f32 (relative L2 <= 1e-5, ids equal), with
     data_norm's three strategies on random statistics, and print's line
     once, outside any timed step.  No flash kernel may launch in phase
     18;
 19. the image layers, the conv operator and CTC: (a) AlexNet at
     bench.py's bench_alexnet configuration (the reference's
     benchmark/paddle/image/alexnet.py with batch_size=128, layer_num=1:
     227x227x3, conv 11x11/4 96, cross-map norm 5, max pool 3/2, conv 5x5
     256, norm, pool, convs 3x3 384, 384, 256, pool, fc 4096 twice with
     dropout 0.5, fc 1000 softmax; its learning_rate 0.01 / 128 and L2
     0.0005 x 128 are per-sample settings, so Momentum(0.01, 0.9) with L2
     5e-4 under the mean cost), bf16 over f32 masters, random images and
     labels from a seed, through trainer.SGD(...).train with cuDNN
     autotuning: one warm-up step, 4 timed steps on distinct batches
     (seconds per step, images/s, peak memory, the convs' analytic FLOPs
     and their share of the bf16 peak), 5 steps on one batch (the cost must
     fall), torch.profiler over two steps (busy share, top kernels) and the
     two norm layers' device time, forward and backward at their shapes in
     the step; one step's f32 gradients at B=2 from a seeded init with
     cuDNN's heuristic algorithms, the card against the CPU's f64, relative
     L2 <= 1e-4 per leaf (the CPU's f32 printed beside them);
     (b) AlexNet served from (a)'s parameters through Inference.infer, 256
     images in two batches of 128, every distribution finite and summing to
     1, and two images in f32 card against CPU; (c) convt (the DCGAN
     generator's ladder, and groups 2), the cross-map norm, maxout, spp
     (max and avg over AlexNet's conv5 output), bilinear_interp (2x up and
     down), pad and crop (227 to 224), featmap_expand, block_expand and
     conv_op (plain and transposed) in f32 on the card and on the CPU, held
     to the CPU's f64 evaluation by phase 8's rule: outputs and gradients
     within max(2 x the CPU f32's own error, 1e-5) relative L2 (the DCGAN
     ladder's ReLUs put its first layer's f32 gradients ~1e-4 from f64 on
     either device); (d) a CRNN-CTC line recognizer
     (grayscale 32x100 lines, conv 3x3 64 + max pool 2, conv 3x3 128 + max
     pool 2, block_expand 8x1 into 25 frames of 1024, bidirectional_gru
     128, fc 38, warp_ctc(blank=0) with ctc_error_evaluator; B = 64 lines
     with labels of 3-12 ids from a seed): 10 bf16 Adam(1e-3) steps on one
     batch (the cost must fall; the ctc_error of each step), one step's
     host syncs by site (none from the layers, the evaluator's one copy),
     device kernels and busy share; the path's f32 cost and gradients and
     warp_ctc's logit gradients card against CPU at B = 4 (<= 1e-5); and
     the port's cost against F.ctc_loss (a yardstick the port never calls,
     <= 1e-4 relative) with the time of each, forward and backward, and
     the port's kernels per frame.  No flash kernel may launch in phase 19;
 20. the last five layer types: (a) SSD300-VGG16 (Liu et al., ECCV 2016;
     Caffe's ssd_pascal.py: 300x300x3, 21 classes, VGG-16 with ceil
     pooling, pool5 3x3/1, fc6 3x3 1024 and fc7 1x1 1024 as convs, the
     extras conv6-conv9, loc/conf heads and a priorbox on conv4_3, fc7,
     conv6_2, conv7_2, conv8_2 and conv9_2: 8732 priors, concatenated;
     without conv4_3's L2 norm and fc6's dilation, which the DSL lacks),
     multibox_loss (overlap 0.5, 3 negatives per positive, neg_overlap
     0.5), bf16 over f32 masters, Momentum(0.001, 0.9) with L2 5e-4, B = 32
     images from N(0, 1) with 1-8 random ground-truth boxes: one warm-up
     step, 4 timed steps (s per step, images/s, the convs' share of the
     bf16 peak, peak memory), 5 steps on one batch at that rate and 5 more
     at Momentum(1e-4, 0.9) (these costs must fall: from a random VGG the
     paper's rate oscillates on a fixed batch),
     one step's host syncs by site (none from the layers) and a profile of
     one (kernels, busy share), one step's gradients at B = 2 (of the loss
     with every negative kept: random-init scores tie in the hard-negative
     ranks) card vs CPU in f64 (<= 1e-9) and in f32 (each from f64, the
     card's within 1e-3);
     (b) detection_output (nms 0.45, top 400, keep 200, confidence 0.01)
     and detection_map_evaluator (11point) over 3 batches of 32 (s per
     batch, kernels per batch), then in f32 the same head outputs through
     the priorboxes and detection_output on the card and on the CPU: labels
     and order equal, scores and boxes within 1e-5, the mAP equal;
     (c) Transformer-base with 8-expert MoE encoder FFNs (top-1, capacity
     factor 1.25) against phase 5's dense model, B = 8, T = 1024, bf16,
     flash on, 3 rounds of (dense, moe, moe, dense) steps (median s per
     step each), 18/18/18 flash launches per step, a profile of one step
     of each (kernels, busy share), the tokens each MoE layer dropped and
     its aux term; the moe layer alone, forward and backward, against the
     one-hot einsum form (a yardstick; outputs within 2^-7 of their
     largest, a bf16 rounding or two) and the dense FFN; a 2-layer d 64 MoE model's f32 cost
     and gradients card vs CPU (<= 1e-4); (d) an MDLSTM-CTC line
     recognizer on phase 19d's lines and stem (a 1x1 conv to 5 x 64 gates
     and mdlstmemory(64) in each of the four directions, summed,
     block_expand 8x1, fc 38, warp_ctc): 8 bf16 Adam(1e-3) steps on one
     batch of 64 (the cost must fall), host syncs by site, kernels and busy
     share, the gradients at B = 4 card vs CPU in f64 and f32 as in (a);
     (e) priorbox,
     multibox_loss, detection_output, moe and mdlstmemory (four
     directions) at their models' shapes in f32 on the card and on the
     CPU, held to the CPU's f64 by phase 19c's rule.  No flash kernel may
     launch in 20a, 20b or 20d;
 21. the op framework, the GAN and VAE trainers and the v2 surface, in f32
     with TF32 off, random weights and data from seeds (widths fixed by the
     issue that ported them where no published config applies): (a) an MLP
     as one NetOp (x [256, 784] -> mul w1 [784, 128] -> rowwise_add ->
     sigmoid -> mul w2 [128, 10] -> rowwise_add -> softmax ->
     onehot_cross_entropy -> mean) with Backward(no_grad_set={x, label})
     and one sgd op per parameter in one Scope on the card: 30 steps on one
     batch at lr 0.5 (the cost must fall), ms per step, device kernels and
     busy share of one step, its host syncs by site (none may come from the
     package), and one forward and Backward card vs CPU f32 per output and
     gradient (relative L2 within max(1e-5, 2x the CPU f32's distance from
     f64)); (b) RecurrentOp with tests/test_framework_ops.py:199's step net
     (h = sigmoid(x_t W + h U)) at T = 100, B = 64, D = 128: forward +
     Backward ms, kernels per time step, and card vs CPU by (a)'s rule;
     (c) the GAN trainer at gan_conf_image.py's MNIST setting (noise 100,
     data 784), hidden 128, B = 128, Adam(1e-3, beta1 0.5) on each
     network, real rows from a seeded two-component Gaussian mixture: one
     D step's and one G step's gradients card vs CPU from the same trees
     (<= 1e-5) and 5 batches' losses (<= 1e-4 relative), then a warm-up and
     50 timed batches (ms per batch, D's loss below 2 ln 2 at some batch,
     every loss finite), one batch's host syncs by site (exactly the two
     loss reads), kernels and busy share; (d) the VAE trainer (data 784,
     hidden 128, latent 100, B = 128, Adam(1e-3)): one step's loss and
     gradients at one eps and reconstruct of 128 rows card vs CPU (<= 1e-5),
     50 timed steps (the loss must fall), syncs, kernels and busy share;
     (e) save_model/load_model and merge_model/load_merged_model
     round-trip the GAN's generator on the card (equal samples), and
     make_diagram of the VAE's encoder.  No flash kernel may launch in
     phase 21;
 22. the training plane's feeding and fault tolerance; each line says
     whether cuDNN ran its autotuned or its deterministic algorithms:
     (a) ResNet-50 at bench.py's bench_resnet_pipeline configuration (512
     records of uint8 224x224x3 pixels and a label byte written to a
     temporary recordio file and read by io.recordio.Prefetcher, B = 128,
     the data layer's feed_dtype uint8 and feed_scale 1/255, bf16,
     Momentum(0.01, 0.9)) in five arms in turns: inline staging, the
     DevicePrefetcher with pinned side-stream staging, data echo x2 over
     12 transfers, the cached pass replayed stepwise and the whole-pass
     epoch program over 3 passes of 4 batches (images/s and s/step each),
     the consumer's wait_s, one batch's isolated copy rate pinned and
     pageable, profiler windows of arms 1, 2, 4 and 5 (busy share, the
     copies' kind and stream, H2D bytes per cached pass, the main
     thread's launch calls), host syncs per cached pass (exactly 1 for
     the epoch program), the pass cache's summary; deterministic: arms 1
     and 2 bit-identical after the same 8 batches, arms 4 and 5 after one
     cached pass, a cached batch's crc32 unchanged; (b) AlexNet with
     bench_alexnet's uint8 pixels (feed_scale 1/255, feed_shift -0.5) at
     B = 128 and SSD300 at phase 20a's setting through SGD.train fed
     inline and prefetched in turns: s/step, busy, top device items, no
     pageable pixel copy in the prefetched window, s per call of
     single-batch train calls both ways with the feed's parts timed alone
     (convert, synchronous upload, staged upload), and the parameters and
     costs of 4 steps bit-identical (deterministic); (c) the robustness
     plane on ResNet-50 (f32 pixels) through SGD.train with a temporary
     checkpoint_dir: a nan_batch step skipped with the state bit-identical
     across it, rollback 3 times and quarantine of a poisoned window,
     checkpoint bytes and save and restore seconds, SIGTERM at step 5 and
     a resume from another seed bit-identical to an uninterrupted run.  No
     flash kernel may launch in phase 22;
 23. elastic fleets of worker processes (``elastic_drive`` through
     ``sys.executable -c``) sharing the card under an HA master in this
     process: (a) LeNet-5 at BASELINE config #1 (4,096 seeded records, 32
     tasks of 128 a pass, 2 passes, f32): (i) N=1, then at once (ii) N=2,
     (iii) N=2 with kill_worker@3 in one worker, (iv) N=2 with worker_hang
     in one, pruned and rejoining, (v) a resume from the manifest of a
     fleet stopped after pass 1, (vi) N=2 under a leader subprocess armed
     with kill_master@8 and this process's warm standby; every final state
     and restored manifest bit-identical to (i), the card's free memory
     back after them; (b) ResNet-50 (4 tasks of B = 128 a pass, bf16,
     uint8 feed, quantized contributions) at N=1 and N=2, bit-identical,
     with s/pass, task compute, quantize/fence/fetch/reduce/apply seconds,
     payload and wire bytes, journal bytes and peak memory per worker.
     Every worker runs deterministic kernels; the frame bound is 256 MB.
     No flash kernel may launch in phase 23;
 24. the serving plane at phase 13's width: (a) the engine's arms (chunked
     prefill, prefix cache, speculative decoding, beam, int8 weights), (b)
     the scheduler under open-loop load and its drills, (c) a two-engine
     fleet behind the router.  No flash kernel may launch in phase 24;
 25. the v1 command line (``python -m paddle_tpu_torch``), the profiler and
     the NaN trap, on phase 16's bench_lstm_textcls config and corpus:
     (a) the reference rnn benchmark's line ``train --job=time
     --config_args=hidden_size=512,lstm_num=2,batch_size=128
     --test_period=20 --use_gpu=True --trainer_count=1`` as a subprocess
     (bf16 through the compute_dtype flag), with and without --feed_data:
     ms/batch and samples/s beside phase 16's s/step; (b) --job=train
     --save_dir (a v1 pass dir), then --job=test on it, bit-equal to
     SGD.test in this process on the same loaded parameters; (c)
     merge_model and --job=test on the bundle, bit-equal to (b); (d)
     --job=checkgrad in f64 on a tanh MLP at batch 8; (e) --job=time of a
     2-layer Transformer-base encoder classifier (batch 8, T = 1024, flash
     on): 2 launches of each kernel per step; (f) profiler.profile around
     two textcls steps: a trace with device kernels and the obs spans as
     record_function ranges; (g) init(check_nans=True): a NaN planted in
     an input and one made only in the backward raise FloatingPointError
     naming the op and the layer, disarmed the sentinel skips; armed
     against disarmed step time; (h) lint --config (clean; a planted
     dangling input exits 1 with G002), lint --journal (J001 on a corrupt
     frame), dump_config, make_diagram, version, trace validate;
 26. scenarios and the fuzzer (robustness/scenarios.py, fuzz.py): (a) the
     dynamic-width repair: fc(trans(data(12)), size=4, Tanh) with sum_cost
     and Momentum(0.05) trained on the card at batches 7, 100 and 160 (3
     passes, drop_last): w0 resolves to [batch, 4] and the pass-mean cost
     falls by more than 0.1; the card's first-pass costs at batch 7 equal
     the CPU's from the same imported parameters; (b) the seven fast
     scenarios in this process at the JAX package's default sizes on a
     card engine, each scenario's own gates asserted and its metrics line
     printed, then a NaN planted in one decode slot's hidden state stays in
     that slot; (c) ``python -m paddle_tpu_torch fuzz`` as subprocesses: a
     clean 25-composition batch (seed 0) exits 0, the ledger_skew canary
     (seed 7) exits 1 with its spec shrunk to the one overload arrival
     item, and the spec's replay exits 0; (d) the drills ``scenario --name
     fleet_kill_worker`` and ``--name fleet_rolling_restart`` with their
     engines on the card, their gates asserted.  No flash kernel may launch
     in phase 26;
 27. the port's gates through ``paddle_tpu_torch.cli.main`` (host code that
     imports no JAX): (a) ``lint --extra chip_smoke.py`` (the
     self-lint), ``lint --concurrency`` and ``lint --protocol`` each exit 0;
     (b) ``reader/creator.py`` copied with its A206 pragma cut reports A206
     at that line; (c) the explore batch of the JAX package's Makefile
     (router 200 schedules with DFS to depth 3, ha 200 to depth 4, master
     60, all seed 0) prints clean, the double_serve canary (router, seed 7,
     12 events) exits 1 with a spec of at most 6 events and its replay
     exits 0.  Seconds of each step and runs/s beside the card.  No flash
     kernel may launch in phase 27;
 28. the traced-step lints and the numerics sanitizer on phase 5's model
     and batch shape: (a) in two subprocesses, ``lint --numerics`` over the
     package probes and over three tests/configs demos, at f32 and at bf16
     compute, each exit 0 and clean; (b) one train step traced (make_fx):
     18 forward and 18 backward flash custom-op nodes, each kernel launched
     18 times by the trace, the T-rules raw naming the step's host sync and
     clean with the pragmas, ``lint --donation``'s audit of the three step
     builders raw naming the epoch program's clone of the carry and clean
     with the pragmas, the bf16 numerics lint clean, certificates ACCEPT /
     REJECT (N402) / REJECT without a trace; (c) the sanitizer armed through
     SGD.train: a healthy step captured once and torch.equal to an unarmed
     trainer's, then a NaN in the first encoder attention's query weight and
     that weight scaled until q.k leaves the f32 range, each step skipped by
     the sentinel, the postmortems naming the query ``mm`` and the flash
     forward node (whose re-execution launches the forward kernel); (d) in
     a subprocess, ``init(compute_dtype="bfloat16")`` turns cuBLAS's bf16
     reduced-precision switch off, N401 is clean on a bf16 step and fires
     with the switch forced on.  Phase 28's launches are the kernels line's
     ``phase28_launches``.

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launches on the main path (the timed training steps of
phase 5; the NMT paths of phases 11-13, the LSTM classifier of phases 14
and 16, the tagger of phase 15, the nested networks of phase 17, the
N-gram and ranking networks of phase 18, the image and CTC networks of
phase 19, the SSD and MDLSTM networks of phase 20, phase 21's framework,
GAN and VAE paths, phase 22's image networks, phase 23's fleets, phase
24's serving plane, phase 26's scenarios and phase 27's gates run none of them; phase 20's MoE Transformer runs each
18 times per step, phase 25e's encoder twice per step, and phase 28's
trace, steps and postmortems run them as ``phase28_launches`` counts),
errors and times.
Without a CUDA device, or without the paddle_tpu_torch package beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

B, T, H, DH = 8, 1024, 8, 64
LENGTHS = [1024, 1000, 617, 1, 512, 800, 1024, 333]
# kernel vs plain version: |dO| <= TOL_O + TOL_O_REL * |O| (O is rounded once
# to its dtype, so a bf16 value may land one step away), |dlse| <= TOL_LSE
TOL_O = {"bfloat16": 1e-3, "float32": 1e-4}
TOL_O_REL = {"bfloat16": 1e-2, "float32": 0.0}
TOL_LSE = {"bfloat16": 1e-4, "float32": 1e-4}  # f32 in both

# backward kernels vs plain backward: f32 |d| <= TOL_G32 (the f32 kernels
# round nothing); bf16 |d| <= fa.flash_attention_bwd_bar, per element: the
# rounding flips of ds and p that the two summation orders can cause, the
# f32 sum-order slack and the store's rounding, with no flat floor
TOL_G32 = 1e-4
BAR_SEEDS = (10, 11, 12, 13)  # the bf16 bar's sweep at phase 4's shapes
# per (query, key, head) the masks keep: operations of each kernel
OPS_PER_PAIR = {"fwd": 4 * DH, "dq": 6 * DH, "dkv": 8 * DH}

N_REQUESTS = 16
BATCH = 8
MIN_LEN = 600  # shortest training source or target
# bench.py's transformer_long_ctx trains with Momentum(0.05, 0.9); the cost is
# summed over each sample's tokens, and at that rate repeated steps diverge,
# so the smoke takes the same rate per token of the padded length
TRAIN_LR = 0.05 / T
TRAIN_BATCHES = 4  # distinct batches of the timed training run
FIXED_STEPS = 5  # repeated steps on one batch: the cost must fall
DISPATCH_CALLS = 1000  # calls per turn of phase 5b's host-time loops
DISPATCH_STEPS = 7  # phase 5 steps per turn of phase 5b (the first is dropped)
# one step's gradients, flash against dense: |dg| / |g_dense|, L2 over every
# leaf.  Per-leaf maxima are no bar at this size: a ReLU unit of the FFN
# whose pre-activation is within rounding of 0 flips between the paths and
# moves its bias gradient by one token's share (about 1% of a sum over ~8000
# tokens), even in f32.  f32: summation order and such flips, <= 1e-3.
# bf16: the dense path rounds scores and the whole softmax to bf16, where the
# kernels keep f32 and round only p and ds before their products, <= 5e-2.
GRAD_REL = {"float32": 1e-3, "bfloat16": 5e-2}
VOCAB = 32000
FEEDING = {"src_word": 0, "trg_word": 1, "trg_next": 2}


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3) -> float:
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


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) per entry
    function of an nvcc -Xptxas -v log, names demangled by c++filt where the
    toolkit's host has it."""
    import re
    import shutil

    regs, spills, cur = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spills[cur] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs[cur] = int(m.group(1))
    names = list(regs)
    shown = names
    if names and shutil.which("c++filt"):
        shown = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True).stdout.splitlines()
    return [(nice.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void "), regs[n],
             *spills.get(n, (0, 0))) for n, nice in zip(names, shown)]


def build_with_report(fa):
    """Build the kernels and return (ptxas_report of the build, seconds)."""
    import contextlib
    import io

    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        fa.build(verbose=True)
    return ptxas_report(log.getvalue()), time.perf_counter() - t0


def bwd_excess(torch, got, want, bars):
    """{gradient: (max(|d| - bar), worst |d| / bar, max |d|)} of kernel
    outputs `got` against `want`; the first <= 0 passes (a non-finite output
    counts as inf; where the bar is 0 only d = 0 passes)."""
    out = {}
    for name, x, r, bar in zip(("dq", "dk", "dv"), got, want, bars):
        d = (x.double() - r.double()).abs()
        bar = torch.as_tensor(bar, dtype=torch.float64, device=d.device)
        ratio = torch.where(bar > 0, d / bar, torch.where(d > 0, float("inf"), 0.0))
        finite = bool(torch.isfinite(x.float()).all())
        out[name] = ((d - bar).max().item() if finite else float("inf"),
                     ratio.max().item() if finite else float("inf"), d.max().item())
    return out


def device_kernels(torch, fn) -> str:
    """The device kernels a call of fn runs, by name and time per recorded
    launch, from torch.profiler over three calls ("not measured" when the
    profiler shows no device time; the record of a lone ctypes launch is
    sometimes missing from the window)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with record_function("call"):
                fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
           and e.key != "call"]  # the range's own device-side annotation
    if not dev:
        return "not measured"
    dev.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return "; ".join(f"{e.key[:90]} {e.self_device_time_total / e.count:.1f} us per launch "
                     f"({e.count} of 3 calls recorded)"
                     for e in dev[:4])


def attention_pairs(lengths, t, causal) -> int:
    """(query, key) pairs the masks leave valid: the work this data needs."""
    total = 0
    for n in lengths:
        n = min(max(n, 0), t)
        if causal:
            # query q sees keys 0..min(q, n-1)
            total += sum(min(q + 1, n) for q in range(t))
        else:
            total += t * n
    return total


def bound_ms(kernel, lengths, causal, elem_bytes, peak_flops):
    """(least ms, "operations" or "bytes") of one flash kernel: each input
    read once and each output written once (fwd: q, k, v -> O, lse; dq:
    q, k, v, dO, lse, delta -> dq; dkv: the same -> dk, dv), and
    OPS_PER_PAIR[kernel] * H operations per (query, key) pair the masks keep."""
    ops = OPS_PER_PAIR[kernel] * H * attention_pairs(lengths, T, causal)
    tile = B * T * H * DH * elem_bytes
    stats = B * H * T * 4  # one f32 [B, H, T] array
    nbytes = {
        "fwd": 4 * tile + stats,
        "dq": 5 * tile + 2 * stats,
        "dkv": 6 * tile + 2 * stats,
    }[kernel] + B * 4
    t_ops, t_bytes = ops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_mask(torch, lengths, causal):
    """[B, 1, T, T] boolean mask of the flash kernels' masks, for SDPA."""
    key_ok = torch.arange(T, device="cuda")[None, :] < lengths[:, None].long()
    mask = key_ok[:, None, None, :]
    if causal:
        mask = mask & torch.tril(torch.ones(T, T, dtype=torch.bool, device="cuda"))[None, None]
    return mask


def qkv_operands(torch, gen, dtype, layout):
    """q, k, v [B, T, H, dh] as the main path hands them to the kernel:
    "fused" are column slices of one [B, T, 3*H*dh] projection (self-
    attention's fused QKV GEMM, token stride 3*H*dh), "separate" are three
    dense tensors (cross-attention's projections)."""
    if layout == "fused":
        qkv = torch.randn((B, T, 3 * H * DH), generator=gen, device="cuda").to(dtype)
        return tuple(x.view(B, T, H, DH) for x in qkv.split(H * DH, dim=-1))
    return tuple(
        torch.randn((B, T, H, DH), generator=gen, device="cuda").to(dtype)
        for _ in range(3)
    )


def phase_kernel(torch, fa):
    """Kernel vs plain version on the card; returns the kernels-line row."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
    row = None
    worst = 0.0
    for layout in ("fused", "separate"):
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v = qkv_operands(torch, gen, dtype, layout)
            for causal in (False, True):
                o_k, lse_k = fa.flash_attention(q, k, v, lengths, causal, return_lse=True)
                o_r, lse_r = fa.flash_attention_reference(q, k, v, lengths, causal, return_lse=True)
                torch.cuda.synchronize()
                d_o = (o_k.float() - o_r.float()).abs()
                err_o = d_o.max().item()
                # O's bar is relative: one rounding of O to bf16 may differ
                excess_o = (d_o - TOL_O_REL[dtype_name] * o_r.float().abs()).max().item()
                err_l = (lse_k - lse_r).abs().max().item()
                finite = bool(torch.isfinite(o_k.float()).all() and torch.isfinite(lse_k).all())
                tol_o, tol_l = TOL_O[dtype_name], TOL_LSE[dtype_name]
                mask = attention_mask(torch, lengths, causal)
                qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
                # the kernel alone, into preallocated outputs (as phase 4 times
                # dq and dk/dv: the wrapper's host time per call is about as
                # long as the kernel, phase 5b), and through the wrapper
                outs = (torch.empty_like(o_k), torch.empty_like(lse_k))
                ms = time_ms(torch, lambda: fa._launch_fwd((q, k, v, lengths), outs, causal))
                wrapped = time_ms(torch, lambda: fa.flash_attention(q, k, v, lengths, causal))
                plain = time_ms(torch, lambda: fa.flash_attention_reference(q, k, v, lengths, causal), iters=5)
                lib = time_ms(torch, lambda: sdpa(qh, kh, vh, attn_mask=mask))
                peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
                bnd, bound_by = bound_ms("fwd", LENGTHS, causal, q.element_size(), peak)
                say(f"kernel {layout} {dtype_name} causal={causal} strides {q.stride()}: "
                    f"max|dO|={err_o:.3e} (<= {tol_o} + {TOL_O_REL[dtype_name]}*|O|, "
                    f"worst excess {excess_o:.3e}) max|dlse|={err_l:.3e} (<= {tol_l}); "
                    f"kernel {ms:.4f} ms ({wrapped:.4f} through the wrapper), plain "
                    f"{plain:.4f} ms, sdpa {lib:.4f} ms, "
                    f"bound {bnd:.4f} ms ({bound_by})")
                if not finite or excess_o > tol_o or err_l > tol_l:
                    raise SystemExit(f"flash kernel disagrees with its plain version "
                                     f"({layout}, {dtype_name}, causal={causal})")
                worst = max(worst, err_o, err_l)
                if layout == "fused" and dtype == torch.bfloat16 and not causal:
                    row = {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                           "bound_by": bound_by, "library_ms": lib}
                    say("kernel: sdpa (bool mask, bf16) ran on: " + device_kernels(
                        torch, lambda: sdpa(qh, kh, vh, attn_mask=mask)))
    row["max_abs_err"] = worst
    return row


def make_requests(rng):
    reqs = []
    for _ in range(N_REQUESTS):
        ns, nt = rng.randint(MIN_LEN, T + 1, size=2)
        trg = rng.randint(2, VOCAB, size=nt)
        reqs.append((list(rng.randint(2, VOCAB, size=ns)), [0] + list(trg[:-1]), list(trg)))
    return reqs


def phase_slice(torch, P, fa, card):
    from paddle_tpu_torch.models.transformer import transformer_base

    P.init(seed=7, compute_dtype="bfloat16", use_flash_attention=True)
    _, probs = transformer_base(VOCAB, VOCAB)
    t0 = time.perf_counter()
    params = P.parameters.create(probs, seed=7)
    say(f"params: {sum(v.numel() for p in params.params.values() for v in p.values())} "
        f"on {params.params['dec_out']['w0'].device} in {time.perf_counter() - t0:.1f} s")
    inf = P.Inference(probs, params)
    reqs = make_requests(np.random.RandomState(0))
    inf.infer(reqs[:2], feeding=FEEDING, batch_size=BATCH)  # warm-up
    torch.cuda.synchronize()

    fa.flash_attention.launches = 0
    per_batch, results, batch_s = [], [], []
    t0 = time.perf_counter()
    for res in inf.iter_infer_field(field="value", input=reqs, feeding=FEEDING, batch_size=BATCH):
        # each batch ends in a host copy of its outputs, which waits for the card
        batch_s.append(time.perf_counter() - t0 - sum(batch_s))
        per_batch.append(fa.flash_attention.launches - sum(per_batch))
        results.append(res[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    say(f"slice: {len(results)} batches, kernel launches per batch {per_batch}, "
        f"seconds per batch {[round(x, 4) for x in batch_s]}")
    if per_batch != [18] * (N_REQUESTS // BATCH):
        raise SystemExit(f"expected 18 flash launches per batch, got {per_batch}")

    out = np.concatenate(results, axis=0)
    n_trg = sum(len(r[1]) for r in reqs)
    n_src = sum(len(r[0]) for r in reqs)
    if out.shape != (n_trg, VOCAB):
        raise SystemExit(f"output shape {out.shape} != {(n_trg, VOCAB)}")
    if not np.isfinite(out).all():
        raise SystemExit("non-finite probabilities")
    sums = out.sum(axis=1)
    say(f"slice: row sums in [{sums.min():.6f}, {sums.max():.6f}]")
    if np.abs(sums - 1.0).max() > 1e-2:
        raise SystemExit("a distribution does not sum to 1 within 1e-2")

    say(f"slice: {N_REQUESTS} requests ({n_src} source + {n_trg} target tokens) in "
        f"{wall:.4f} s: {N_REQUESTS / wall:.3f} requests/s, "
        f"{(n_src + n_trg) / wall:.1f} tokens/s on {card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the first batch again through the dense attention path, in bf16 and
    # then (both paths) in f32 compute
    first = reqs[:BATCH]
    dense = _infer_with(P, inf, first, flash=False)
    compare("bf16 flash vs bf16 dense", results[0], dense, max_dp=2e-4)
    P.init(compute_dtype="float32")
    inf32 = P.Inference(probs, params)
    compare("f32 flash vs f32 dense", _infer_with(P, inf32, first, flash=True),
            _infer_with(P, inf32, first, flash=False), max_dp=1e-5)
    if fa.flash_attention.launches != launches + 18:
        raise SystemExit("the dense path launched the flash kernel")
    return launches


def _infer_with(P, inf, reqs, flash):
    P.flags.set_flag("use_flash_attention", flash)
    try:
        return inf.infer(reqs, feeding=FEEDING, batch_size=BATCH)
    finally:
        P.flags.set_flag("use_flash_attention", True)


def compare(name, a, b, max_dp, min_agree=0.99):
    """max |dp| and top-token agreement.  Random weights give flat
    distributions (top probability ~1e-3) whose bf16 values often tie at the
    top, and argmax then picks the first of the tied tokens: a position
    agrees when the top tokens are equal or one path's top token ties for
    the top in the other.  The strict argmax agreement is printed beside it."""
    rows = np.arange(len(a))
    aa, ba = a.argmax(axis=1), b.argmax(axis=1)
    strict = float((aa == ba).mean())
    tied = (a[rows, ba] == a.max(axis=1)) | (b[rows, aa] == b.max(axis=1))
    agree = float(((aa == ba) | tied).mean())
    dp = float(np.abs(a - b).max())
    say(f"slice {name} (first batch): max|dp|={dp:.3e} (<= {max_dp}), top-token "
        f"agreement {agree:.5f} (>= {min_agree}), strict argmax {strict:.5f}")
    if dp > max_dp or agree < min_agree:
        raise SystemExit(f"{name}: the paths disagree")


def launch_counts(fa):
    return (fa.flash_attention.launches, fa.flash_attention_bwd.dq_launches,
            fa.flash_attention_bwd.dkv_launches)


def reset_counts(fa):
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd.dq_launches = 0
    fa.flash_attention_bwd.dkv_launches = 0


def bwd_case(torch, fa, gen, dtype, layout, causal, lengths):
    """Operands of one backward check at phase 4's shapes: (q, k, v, do,
    lse, delta, o) with lse and o from the forward kernel."""
    q, k, v = qkv_operands(torch, gen, dtype, layout)
    do = torch.randn((B, T, H, DH), generator=gen, device="cuda").to(dtype)
    o, lse = fa.flash_attention(q, k, v, lengths, causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    return q, k, v, do, lse, delta, o


def fmt_excess(ex):
    return "; ".join(f"{n} max|d|={e[2]:.3e} worst |d|/bar {e[1]:.3f} excess {e[0]:+.3e}"
                     for n, e in ex.items())


# the planted faults of the plain backward that the bf16 bar must reject
FAULTS = {
    "ds unrounded": lambda fa, a, lengths, causal: fa.flash_attention_bwd_reference(
        *a, lengths, causal, round_ds=False),
    "length mask dropped": lambda fa, a, lengths, causal: fa.flash_attention_bwd_reference(
        *a, None, causal),
}


def phase_bwd_kernel(torch, fa):
    """Backward kernels vs the plain backward on the card; returns the
    kernels-line rows of dq and dk/dv (their times at the fused bf16
    non-causal case, the self-attention layout of the main path).  bf16 is
    held to the derived bar, which must also reject both planted faults."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
    rows, worst = {}, {"dq": 0.0, "dkv": 0.0}
    caught = {f: {"dq": 0, "dk": 0, "dv": 0} for f in FAULTS}
    for layout in ("fused", "separate"):
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            for causal in (False, True):
                q, k, v, do, lse, delta, o = bwd_case(torch, fa, gen, dtype, layout, causal, lengths)
                args = (q, k, v, lse, delta, do)
                got = fa.flash_attention_bwd(q, k, v, o, lse, delta, do, lengths, causal)
                want = fa.flash_attention_bwd_reference(*args, lengths, causal)
                bf16 = dtype == torch.bfloat16
                bars = (fa.flash_attention_bwd_bar(*args, lengths, causal) if bf16
                        else (TOL_G32,) * 3)
                torch.cuda.synchronize()
                ex = bwd_excess(torch, got, want, bars)
                if bf16:
                    for fault, plant in FAULTS.items():
                        wrong = plant(fa, args, lengths, causal)
                        for name, x, r, bar in zip(("dq", "dk", "dv"), got, wrong, bars):
                            over = ~((x.double() - r.double()).abs() <= bar)
                            caught[fault][name] += int(over.sum().item())
                        del wrong
                for name, e in ex.items():
                    if e[0] > 0:
                        raise SystemExit(f"backward kernel disagrees with the plain backward "
                                         f"({name}, {layout}, {dtype_name}, causal={causal})")
                    kn = "dq" if name == "dq" else "dkv"
                    worst[kn] = max(worst[kn], e[2])
                # each kernel alone, into preallocated outputs
                operands = (q, k, v, do, lse, delta, lengths)
                outs = tuple(torch.empty_like(x) for x in got)
                ms_dq = time_ms(torch, lambda: fa._launch_bwd("dq", operands, outs[:1], causal))
                ms_dkv = time_ms(torch, lambda: fa._launch_bwd("dkv", operands, outs[1:], causal))
                plain = time_ms(torch, lambda: fa.flash_attention_bwd_reference(
                    q, k, v, lse, delta, do, lengths, causal), iters=3)
                # SDPA's backward alone, over one retained forward graph
                mask = attention_mask(torch, lengths, causal)
                qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
                lib_out = sdpa(qh, kh, vh, attn_mask=mask)
                lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
                    lib_out, (qh, kh, vh), do.transpose(1, 2), retain_graph=True))
                main = layout == "fused" and bf16 and not causal
                if main:
                    ran = device_kernels(torch, lambda: fa._launch_bwd("dq", operands, outs[:1], causal))
                    say("bwd: the bf16 dq launch ran on: " + ran)
                    if ran != "not measured" and "fa_bwd_dq_mma_kernel" not in ran:
                        raise SystemExit("the bf16 dq launch did not run fa_bwd_dq_mma_kernel")
                    say("bwd: sdpa backward (bool mask, bf16) ran on: " + device_kernels(
                        torch, lambda: torch.autograd.grad(
                            lib_out, (qh, kh, vh), do.transpose(1, 2), retain_graph=True)))
                del lib_out
                peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
                bnd = {kn: bound_ms(kn, LENGTHS, causal, q.element_size(), peak)
                       for kn in ("dq", "dkv")}
                say(f"bwd {layout} {dtype_name} causal={causal}: {fmt_excess(ex)} "
                    f"(bar: {'derived bf16 bar' if bf16 else TOL_G32}); dq {ms_dq:.4f} ms (bound "
                    f"{bnd['dq'][0]:.4f}, {bnd['dq'][1]}), dkv {ms_dkv:.4f} ms (bound "
                    f"{bnd['dkv'][0]:.4f}, {bnd['dkv'][1]}), plain backward {plain:.4f} ms, "
                    f"sdpa backward {lib_bwd:.4f} ms")
                if main:
                    for kn, ms in (("dq", ms_dq), ("dkv", ms_dkv)):
                        rows[kn] = {"ms": ms, "plain_ms": plain, "bound_ms": bnd[kn][0],
                                    "bound_by": bnd[kn][1], "library_ms": lib_bwd}
    for fault, counts in caught.items():
        say(f"bwd planted fault '{fault}' in the plain backward: elements past the bf16 bar "
            f"over phase 4's bf16 cases: " + ", ".join(f"{n} {c}" for n, c in counts.items()))
        if not any(counts.values()):
            raise SystemExit(f"the bf16 bar let the planted fault '{fault}' through")
    for kn, r in rows.items():
        r["max_abs_err"] = worst[kn]
    return rows


def phase_bar_sweep(torch, fa):
    """The bf16 backward kernels against the plain backward under the derived
    bar over seeds x causal x operand layouts at phase 4's shapes; prints the
    worst |d| / bar of dq, dk and dv."""
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for seed in BAR_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for layout in ("fused", "separate"):
            for causal in (False, True):
                q, k, v, do, lse, delta, o = bwd_case(
                    torch, fa, gen, torch.bfloat16, layout, causal, lengths)
                args = (q, k, v, lse, delta, do)
                got = fa.flash_attention_bwd(q, k, v, o, lse, delta, do, lengths, causal)
                ex = bwd_excess(torch, got, fa.flash_attention_bwd_reference(*args, lengths, causal),
                                fa.flash_attention_bwd_bar(*args, lengths, causal))
                for name, e in ex.items():
                    worst[name] = max(worst[name], e[1])
                    if e[0] > 0:
                        raise SystemExit(f"bar sweep: {name} past the bf16 bar (seed {seed}, "
                                         f"{layout}, causal={causal}): {fmt_excess(ex)}")
    say(f"bar sweep: seeds {list(BAR_SEEDS)} x causal off/on x fused/separate, bf16, phase 4's "
        f"shapes: worst |d|/bar " + ", ".join(f"{n} {w:.3f}" for n, w in worst.items())
        + " (<= 1 passes)")


# edge shapes of the bf16 tensor-core kernels: (B, T, H, dh, lengths)
EDGE_CASES = (
    (3, 200, 4, 40, [200, 77, 0]),
    (3, 200, 4, 64, [200, 77, 0]),
    (2, 256, 4, 128, [256, 131]),
)


def phase_edges(torch, fa):
    """bf16 forward and backward kernels against their plain versions at the
    edge shapes, both operand layouts, causal off and on; phase 2's O and
    lse bars and the derived bf16 backward bar.  The f32 kernels are the
    scalar ones of the earlier phases."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    dt, name = torch.bfloat16, "bfloat16"
    for b, t, h, dh, lens in EDGE_CASES:
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for layout in ("fused", "separate"):
            if layout == "fused":
                qkv = torch.randn((b, t, 3 * h * dh), generator=gen, device="cuda").to(dt)
                q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
            else:
                q, k, v = (torch.randn((b, t, h, dh), generator=gen, device="cuda").to(dt)
                           for _ in range(3))
            do = torch.randn((b, t, h, dh), generator=gen, device="cuda").to(dt)
            for causal in (False, True):
                o, lse = fa.flash_attention(q, k, v, lengths, causal, return_lse=True)
                o_r, lse_r = fa.flash_attention_reference(q, k, v, lengths, causal, return_lse=True)
                delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
                args = (q, k, v, lse, delta, do)
                got = fa.flash_attention_bwd(q, k, v, o, lse, delta, do, lengths, causal)
                want = fa.flash_attention_bwd_reference(*args, lengths, causal)
                bars = fa.flash_attention_bwd_bar(*args, lengths, causal)
                torch.cuda.synchronize()
                excess = {}
                for key, x, r, tol, rel in (
                        ("O", o, o_r, TOL_O[name], TOL_O_REL[name]),
                        ("lse", lse, lse_r, TOL_LSE[name], 0.0)):
                    d = (x.float() - r.float()).abs()
                    excess[key] = (d - rel * r.float().abs()).max().item() - tol
                    if not bool(torch.isfinite(x.float()).all()):
                        excess[key] = float("inf")
                ex = bwd_excess(torch, got, want, bars)
                excess.update({g: e[0] for g, e in ex.items()})
                zero = all(torch.count_nonzero(x[i]) == 0
                           for x in (o, *got) for i, n in enumerate(lens) if n == 0)
                say(f"edge B={b} T={t} H={h} dh={dh} lengths {lens} {layout} causal={causal}: "
                    + ", ".join(f"{key} {e:+.3e}" for key, e in excess.items())
                    + " (excess over the bar; <= 0 passes), worst |d|/bar "
                    + ", ".join(f"{g} {e[1]:.3f}" for g, e in ex.items())
                    + f", length-0 rows zero: {zero}")
                if max(excess.values()) > 0 or not zero:
                    raise SystemExit(f"bf16 kernels disagree with the plain versions at an "
                                     f"edge shape (dh={dh}, {layout}, causal={causal})")


def train_samples(rng, n):
    """n (src, trg, trg_next) samples with lengths in 600-1024; the first
    has a source and a target of length 1024, so a batch led by it pads
    every slot to T = 1024."""
    out = []
    for i in range(n):
        ns, nt = (T, T) if i == 0 else rng.randint(MIN_LEN, T + 1, size=2)
        trg = rng.randint(2, VOCAB, size=nt)
        out.append((list(rng.randint(2, VOCAB, size=ns)), [0] + list(trg[:-1]), list(trg)))
    return out


def run_steps(P, trainer, samples, on_event=None):
    trainer.train(P.batch(lambda: iter(samples), BATCH), feeding=FEEDING,
                  event_handler=on_event)


def grads_of(torch, net, params, batch, state=None):
    """(cost, {dotted name: gradient}) of the network's mean cost on `batch`
    in training mode (batch norm on batch statistics); the tree may nest (a
    recurrent group's parameters)."""
    from paddle_tpu_torch.utils.tree import leaf_paths, map_leaves

    leaves = map_leaves(lambda v: v.detach().requires_grad_(True), params)
    paths = list(leaf_paths(leaves))
    cost, _ = net.cost(leaves, batch, state=state, train=True)
    gs = torch.autograd.grad(cost, [v for _, v in paths], allow_unused=True)
    return cost.item(), {".".join(p): g for (p, _), g in zip(paths, gs) if g is not None}


def phase_train(torch, P, fa, card):
    """Transformer-base training through SGD.train; returns the launches of
    each kernel in the timed run and the trainer (for the profiler)."""
    from paddle_tpu_torch.models.transformer import transformer_base
    from paddle_tpu_torch.reader.feeder import DataFeeder

    P.init(seed=11, compute_dtype="bfloat16", use_flash_attention=True)
    cost, _ = transformer_base(VOCAB, VOCAB)
    params = P.parameters.create(cost, seed=11)
    trainer = P.trainer.SGD(
        cost, params, P.optimizer.Momentum(learning_rate=TRAIN_LR, momentum=0.9))
    rng = np.random.RandomState(1)
    warm = train_samples(rng, BATCH)
    timed = [s for _ in range(TRAIN_BATCHES) for s in train_samples(rng, BATCH)]
    run_steps(P, trainer, warm)  # first step: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts(fa)
    steps, clock = [], [0.0]

    def on_event(e):
        if isinstance(e, P.event.BeginIteration):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
        elif isinstance(e, P.event.EndIteration):
            # the cost's host copy waits for the whole step, update included
            steps.append((time.perf_counter() - clock[0], launch_counts(fa), e.cost))

    run_steps(P, trainer, timed, on_event)
    launches = launch_counts(fa)
    per_step = [tuple(c - p for c, p in zip(cur[1], prev))
                for cur, prev in zip(steps, [(0, 0, 0)] + [s[1] for s in steps[:-1]])]
    costs = [s[2] for s in steps]
    secs = [s[0] for s in steps]
    say(f"train: {len(steps)} steps, costs {[round(c, 4) for c in costs]}, launches per step "
        f"(fwd, dq, dkv) {per_step}, seconds per step {[round(x, 4) for x in secs]}")
    if len(steps) != TRAIN_BATCHES or not all(np.isfinite(costs)):
        raise SystemExit("training gave a non-finite cost or a missing step")
    if per_step != [(18, 18, 18)] * TRAIN_BATCHES:
        raise SystemExit(f"expected 18/18/18 flash launches per step, got {per_step}")
    valid = sum(len(s[0]) + len(s[1]) for s in timed)
    mean_s = float(np.mean(secs))
    say(f"train: {mean_s:.4f} s per step (mean of {len(secs)}), "
        f"{valid / sum(secs):.1f} valid tokens/s ({2 * BATCH * T * len(secs) / sum(secs):.1f} "
        f"padded tokens/s), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"on {card}")

    fixed = train_samples(rng, BATCH)
    fixed_costs = []
    run_steps(P, trainer, fixed * FIXED_STEPS,
              lambda e: fixed_costs.append(e.cost) if isinstance(e, P.event.EndIteration) else None)
    say(f"train: {FIXED_STEPS} steps on one batch, costs {[round(c, 4) for c in fixed_costs]}")
    if not all(np.isfinite(fixed_costs)) or not fixed_costs[-1] < fixed_costs[0]:
        raise SystemExit("the cost did not fall over repeated steps on one batch")

    # one step's gradients, flash against dense, from the trained parameters
    for dtype_name in ("float32", "bfloat16"):
        net = P.CompiledNetwork(P.Topology(cost), compute_dtype=dtype_name)
        feeder = DataFeeder(net.topology.data_types(), FEEDING, device=trainer.device)
        batch = feeder(fixed)
        before = launch_counts(fa)
        c_f, g_f = grads_of(torch, net, trainer.parameters.params, batch)
        flash_launches = tuple(a - b for a, b in zip(launch_counts(fa), before))
        P.flags.set_flag("use_flash_attention", False)
        try:
            c_d, g_d = grads_of(torch, net, trainer.parameters.params, batch)
        finally:
            P.flags.set_flag("use_flash_attention", True)
        if flash_launches != (18, 18, 18) or launch_counts(fa) != tuple(
                b + f for b, f in zip(before, flash_launches)):
            raise SystemExit(f"{dtype_name} gradients: flash launches {flash_launches}, "
                             "or the dense path launched a flash kernel")
        diff2 = {n: ((g_f[n].float() - g_d[n].float()) ** 2).sum().item() for n in g_d}
        norm2 = {n: (g_d[n].float() ** 2).sum().item() for n in g_d}
        rel_l2 = (sum(diff2.values()) / sum(norm2.values())) ** 0.5
        leaf = max(g_d, key=lambda n: diff2[n] / max(norm2[n], 1e-30))
        say(f"train {dtype_name} gradients flash vs dense: cost {c_f:.6f} vs {c_d:.6f}; "
            f"|dg|/|g| over all {len(g_d)} leaves = {rel_l2:.3e} (<= "
            f"{GRAD_REL[dtype_name]}); worst leaf {leaf} "
            f"{(diff2[leaf] / max(norm2[leaf], 1e-30)) ** 0.5:.3e}")
        if set(g_f) != set(g_d) or not rel_l2 <= GRAD_REL[dtype_name]:
            raise SystemExit(f"{dtype_name} gradients: flash and dense disagree")
        del g_f, g_d
    return {"fwd": launches[0], "dq": launches[1], "dkv": launches[2]}, trainer, mean_s


def host_us_per_call(torch, fn, n):
    """Wall µs per call of `fn` over `n` calls, the card synchronized at both
    ends (host time per call while each launch is shorter than it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def phase_dispatch(torch, P, fa, card, trainer):
    """5b: what routing the flash kernels through their custom operators
    (``fa.as_graph_ops``, the route a traced step takes) costs against
    launching them straight (the training route).  Host µs per call at a
    small shape (B=1, T=128, H=8, dh=64, bf16: each kernel takes a few µs,
    so a call's wall time is its host time), then phase 5's trainer,
    seconds per step, on each route in turns."""
    import contextlib

    routes = {"straight": contextlib.nullcontext, "custom op": fa.as_graph_ops}
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((1, 128, 8, 64), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

    def diff():
        torch.autograd.grad(fa.flash_attention_diff(qg, kg, vg), (qg, kg, vg), do)

    calls = (("flash_attention", lambda: fa.flash_attention(q, k, v), DISPATCH_CALLS),
             ("flash_attention_diff fwd+bwd", diff, DISPATCH_CALLS // 2))
    us = {(name, r): [] for name, _, _ in calls for r in routes}
    order = ("straight", "custom op", "custom op", "straight")
    for r in order:
        with routes[r]():
            for name, fn, n in calls:
                fn()
                us[name, r].append(host_us_per_call(torch, fn, n))
    for name, _, _ in calls:
        say(f"dispatch 5b {name}: host µs per call straight "
            f"{[round(x, 2) for x in us[name, 'straight']]}, through the custom op "
            f"{[round(x, 2) for x in us[name, 'custom op']]} on {card}")
    samples = train_samples(np.random.RandomState(55), BATCH)
    secs = {r: [] for r in routes}
    for r in ("straight", "custom op", "custom op", "straight", "straight", "custom op"):
        turn, clock = [], [0.0]

        def on_event(e):
            if isinstance(e, P.event.BeginIteration):
                torch.cuda.synchronize()
                clock[0] = time.perf_counter()
            elif isinstance(e, P.event.EndIteration):
                turn.append(time.perf_counter() - clock[0])

        with routes[r]():
            run_steps(P, trainer, samples * DISPATCH_STEPS, on_event)
        secs[r].extend(turn[1:])
    mean = {r: float(np.mean(x)) for r, x in secs.items()}
    extra_ms = 18 * (np.mean(us["flash_attention_diff fwd+bwd", "custom op"])
                     - np.mean(us["flash_attention_diff fwd+bwd", "straight"])) / 1e3
    say(f"dispatch 5b: phase 5 seconds per step straight {mean['straight']:.5f} (median "
        f"{float(np.median(secs['straight'])):.5f}), through the custom ops "
        f"{mean['custom op']:.5f} (median {float(np.median(secs['custom op'])):.5f}), "
        f"{len(secs['straight'])} steps a route in turns; the custom ops' host cost at 18 "
        f"differentiable calls a step {extra_ms:.3f} ms = "
        f"{100 * extra_ms / 1e3 / mean['straight']:.2f}% of a straight step, on {card}")
    for r, x in secs.items():
        say(f"dispatch 5b {r} steps: {[round(t, 5) for t in x]}")


PROFILE_TRIES = 3  # profiler windows run in turn while none records device activity


def device_window(torch, fn, what):
    """(wall s, key averages, device events) of one call of fn under
    torch.profiler.  The card's host now and then hands the profiler no
    device records for a window, so while a window shows no device time the
    call runs in a fresh one, PROFILE_TRIES windows in all; `what` names the
    window in the line that reports a lost one.  The device events are []
    when no window recorded any."""
    from torch.profiler import ProfilerActivity, profile

    for n in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        dev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        if dev:
            return wall, events, dev
        say(f"{what}: profiler window {n} of {PROFILE_TRIES} recorded no device time")
    return wall, events, []


def phase_profile(torch, P, trainer):
    """Top device kernels over two training steps from torch.profiler."""
    samples = [s for _ in range(2) for s in train_samples(np.random.RandomState(2), BATCH)]
    wall, _, dev = device_window(torch, lambda: run_steps(P, trainer, samples), "profile")
    total_us = sum(e.self_device_time_total for e in dev)
    if total_us <= 0:
        raise SystemExit("profile: the profiler shows no device time, so the dq route "
                         "is not shown")
    say(f"profile: 2 steps in {wall:.4f} s (profiler on), device busy {total_us / 1e6:.4f} s "
        f"({total_us / 1e6 / wall:.3f} of the window); top device kernels per step:")
    for e in sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        say(f"  {e.self_device_time_total / 2e3:9.3f} ms  {e.count / 2:6.1f} calls  "
            f"{100 * e.self_device_time_total / total_us:5.1f}%  {e.key[:100]}")
    # fa_fwd_kernel / fa_fwd_mma_kernel, fa_bwd_dkv_kernel / fa_bwd_dkv_mma_kernel
    flash = {kn: sum(e.self_device_time_total for e in dev if f"fa_{kn}_" in e.key)
             for kn in ("fwd", "bwd_dq", "bwd_dkv")}
    say("profile: flash kernels per step " + ", ".join(
        f"{kn} {us / 2e3:.3f} ms ({100 * us / total_us:.1f}%)" for kn, us in flash.items()))
    dq = [e for e in dev if "fa_bwd_dq_" in e.key]
    for e in dq:
        say(f"profile: dq ran as {e.key[:90]}: {e.count / 2:.1f} calls and "
            f"{e.self_device_time_total / 2e3:.3f} ms per step")
    # the timed steps are bf16: every dq launch must be the tensor-core kernel
    if len(dq) != 1 or "fa_bwd_dq_mma_kernel<" not in dq[0].key or dq[0].count != 2 * 18:
        raise SystemExit("profile: the training steps' dq did not run as 18 launches per "
                         "step of fa_bwd_dq_mma_kernel")

# ResNet-50 at bench.py's configuration (bench.py:386-392): depth 50, 1000
# classes, 224x224x3, batch 128, bf16 compute over f32 masters, Momentum with
# momentum 0.9; random images and labels from a seed, as bench.py's.
# bench.py's rate 0.1, from this random init, drives the cost on distinct
# batches up (7.6 -> 8.7 in four steps) and makes it oscillate on the fixed
# batch (9.54 -> 11.03 over five steps in one of five runs), so the smoke
# takes 0.01; the work of a step, and so its time, does not depend on it
RN_DEPTH, RN_CLASSES, RN_IMG, RN_BATCH = 50, 1000, 224, 128
RN_LR = 0.01
RN_TIMED = 4  # distinct batches of the timed run, after one warm-up step
RN_FIXED = 5  # steps on one fixed batch: the cost must fall
RN_INFER = 256  # served images, in batches of RN_BATCH
RN_CHECK_B = 2  # batch of the card-against-CPU checks
# Card against CPU in f32 (TF32 off), through the same port code and
# weights: summation order only (cuDNN's autotuned algorithms against the
# CPU's convolutions).
# - One training step's gradients at B=2 are ill-conditioned: the pooled
#   gradient is constant over each image's last 8x8 map, and batch norm's
#   backward on batch statistics subtracts its mean, so f32 rounding is
#   amplified (the CPU's own f32 gradient lies 1.6e-3 to 2.2e-2, relative
#   L2, from its f64 gradient, trained and untrained).  So both f32
#   gradients are held to the CPU's f64 gradient of the same function: the
#   card's may be at most RN_GRAD_SLACK times as far from it as the CPU's
#   f32 one, and never needs to be nearer than RN_GRAD_FLOOR.
# - Served outputs (global statistics: batch norm is affine) are
#   well-conditioned: 1e-4 on the probabilities and 1e-3 of the largest
#   |logit| on the logits (the moving statistics of a few steps can
#   saturate the softmax, where the logits still show a disagreement).
RN_GRAD_SLACK = 2.0
RN_GRAD_FLOOR = 1e-5
RN_PROB_ABS = 1e-4
RN_LOGIT_REL = 1e-3
RN_FEEDING = {"image": 0, "label": 1}


def resnet_images(rng, n):
    """n (image, label) samples: flat CHW images from N(0, 1), as bench.py's."""
    imgs = rng.randn(n, 3 * RN_IMG * RN_IMG).astype(np.float32)
    labels = rng.randint(0, RN_CLASSES, size=n)
    return [(imgs[i], int(labels[i])) for i in range(n)]


def run_resnet(P, trainer, samples, on_event=None):
    trainer.train(P.batch(lambda: iter(samples), RN_BATCH), feeding=RN_FEEDING,
                  event_handler=on_event)


def conv_flops(topology) -> int:
    """Forward FLOPs per image of the topology's convs: 2 kh kw (cin/groups)
    cout out_h out_w each."""
    return sum(2 * a["filter_h"] * a["filter_w"] * (a["in_c"] // a["groups"]) * a["channels"]
               * a["out_h"] * a["out_w"]
               for a in (c.attrs for c in topology.layers.values() if c.type == "conv"))


def rel_l2(torch, got, want) -> float:
    """|got - want| / |want| over every leaf of two {name: tensor} dicts."""
    d2 = sum(((got[n].double().cpu() - want[n].double().cpu()) ** 2).sum().item() for n in want)
    n2 = sum((want[n].double().cpu() ** 2).sum().item() for n in want)
    return (d2 / n2) ** 0.5


def phase_resnet_train(torch, P, card):
    """Phase 8: ResNet-50 training through SGD.train; returns the trainer
    and the prediction layer."""
    from paddle_tpu_torch.models.resnet import resnet_cost
    from paddle_tpu_torch.reader.feeder import DataFeeder

    torch.backends.cudnn.benchmark = True
    say("resnet: torch.backends.cudnn.benchmark on from here on (autotuned conv algorithms)")
    P.init(seed=21, compute_dtype="bfloat16")
    cost, probs = resnet_cost(depth=RN_DEPTH, class_num=RN_CLASSES, img_size=RN_IMG)
    params = P.parameters.create(cost, seed=21)
    state0 = {l: {k: v.clone() for k, v in s.items()} for l, s in params.state.items()}
    trainer = P.trainer.SGD(cost, params, P.optimizer.Momentum(learning_rate=RN_LR, momentum=0.9))
    topo = trainer.topology
    step_flops = 3 * RN_BATCH * conv_flops(topo)
    say(f"resnet: ResNet-{RN_DEPTH} {RN_IMG}x{RN_IMG}x3, {RN_CLASSES} classes, batch {RN_BATCH}, "
        f"bf16 compute, Momentum({RN_LR}, 0.9), "
        f"{sum(v.numel() for p in params.params.values() for v in p.values())} "
        f"parameters, {sum(c.type == 'conv' for c in topo.layers.values())} convs, "
        f"{len(params.state)} batch norms; {step_flops:.6e} conv FLOPs per training step "
        f"(3 x forward)")
    rng = np.random.RandomState(5)
    t0 = time.perf_counter()
    run_resnet(P, trainer, resnet_images(rng, RN_BATCH))  # cuDNN autotuning, allocator
    torch.cuda.synchronize()
    say(f"resnet: warm-up step {time.perf_counter() - t0:.3f} s")
    timed = resnet_images(rng, RN_TIMED * RN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    steps, clock = [], [0.0]

    first_bn = next(n for n, c in topo.layers.items() if c.type == "batch_norm")
    end_pass_mean = []

    def on_event(e):
        if isinstance(e, P.event.BeginIteration):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
        elif isinstance(e, P.event.EndIteration):
            # the cost's host copy waits for the whole step, update included
            steps.append((time.perf_counter() - clock[0], e.cost))
        elif isinstance(e, P.event.EndPass):
            end_pass_mean.append(trainer.parameters.state[first_bn]["mean"].abs().sum().item())

    run_resnet(P, trainer, timed, on_event)
    after = trainer.parameters.state[first_bn]["mean"].abs().sum().item()
    say(f"resnet train: sum |moving mean| of {first_bn} read in the EndPass handler "
        f"{end_pass_mean}, after train returned {after}")
    if len(end_pass_mean) != 1 or not end_pass_mean[0] > 0 or end_pass_mean[0] != after:
        raise SystemExit("resnet: EndPass did not see the trained batch-norm state")
    secs, costs = [s[0] for s in steps], [s[1] for s in steps]
    peak = torch.cuda.max_memory_allocated()
    say(f"resnet train: {len(steps)} steps, costs {[round(c, 4) for c in costs]}, seconds per "
        f"step {[round(x, 4) for x in secs]} (each includes feeding the batch from the host)")
    if len(steps) != RN_TIMED or not all(np.isfinite(costs)):
        raise SystemExit("resnet training gave a non-finite cost or a missing step")
    mean_s = float(np.mean(secs))
    say(f"resnet train: {mean_s:.4f} s per step (mean of {len(secs)}), "
        f"{RN_BATCH * len(secs) / sum(secs):.2f} images/s, conv FLOPs "
        f"{step_flops / mean_s / 1e12:.2f} TFLOP/s = {step_flops / mean_s / PEAK_BF16_FLOPS:.4f} of "
        f"the bf16 peak, peak memory {peak / 2**30:.2f} GiB on {card}")

    feeder = DataFeeder(topo.data_types(), RN_FEEDING, device=trainer.device)
    t0 = time.perf_counter()
    feeder(timed[:RN_BATCH])
    torch.cuda.synchronize()
    say(f"resnet train: feeding one batch from the host (numpy stack, copy to the card) "
        f"{time.perf_counter() - t0:.4f} s of each step")

    fixed = resnet_images(rng, RN_BATCH)
    fixed_costs = []
    run_resnet(P, trainer, fixed * RN_FIXED,
               lambda e: fixed_costs.append(e.cost) if isinstance(e, P.event.EndIteration) else None)
    say(f"resnet train: {RN_FIXED} steps on one batch, costs {[round(c, 4) for c in fixed_costs]}")
    if not all(np.isfinite(fixed_costs)) or not fixed_costs[-1] < fixed_costs[0]:
        raise SystemExit("resnet: the cost did not fall over repeated steps on one batch")

    phase_nan_step(torch, P, trainer)
    state = trainer.parameters.state
    still = [l for l in state0 for k in ("mean", "var") if torch.equal(state[l][k], state0[l][k])]
    finite = all(bool(torch.isfinite(v).all()) for s in state.values() for v in s.values())
    var_lo = min(s["var"].min().item() for s in state.values())
    say(f"resnet train: batch-norm state of {len(state)} layers after {1 + RN_TIMED + RN_FIXED} "
        f"steps: {len(still)} statistics unmoved, finite {finite}, smallest moving var {var_lo:.4e}")
    if still or not finite or set(state) != set(state0):
        raise SystemExit("resnet: a batch-norm moving statistic did not move or is not finite")

    # one step's gradients at B=2, card (f32) against CPU (f32, f64), from the
    # trained parameters and state
    net = P.CompiledNetwork(P.Topology(cost), compute_dtype="float32")
    check = resnet_images(np.random.RandomState(6), RN_CHECK_B)
    got = {}
    for where, dev, dtype in (("card f32", trainer.device, torch.float32),
                              ("CPU f32", torch.device("cpu"), torch.float32),
                              ("CPU f64", torch.device("cpu"), torch.float64)):
        batch = DataFeeder(net.topology.data_types(), RN_FEEDING, device=dev)(check)
        batch["image"] = batch["image"].with_data(batch["image"].data.to(dtype))
        cast = lambda tree: {l: {k: v.to(dev, dtype) for k, v in p.items()} for l, p in tree.items()}
        t0 = time.perf_counter()
        got[where] = grads_of(torch, net, cast(trainer.parameters.params), batch, cast(state))
        say(f"resnet gradients, {where}: cost {got[where][0]:.9f} in {time.perf_counter() - t0:.2f} s")
    ref = got["CPU f64"][1]
    e_card, e_cpu = (rel_l2(torch, got[w][1], ref) for w in ("card f32", "CPU f32"))
    bar = max(RN_GRAD_SLACK * e_cpu, RN_GRAD_FLOOR)
    say(f"resnet gradients B={RN_CHECK_B}, |dg|/|g| over all {len(ref)} leaves against the CPU's "
        f"f64: card f32 {e_card:.3e} (<= {bar:.3e} = max({RN_GRAD_SLACK} x CPU f32's, "
        f"{RN_GRAD_FLOOR})), CPU f32 {e_cpu:.3e}; card vs CPU f32 "
        f"{rel_l2(torch, got['card f32'][1], got['CPU f32'][1]):.3e}")
    if set(got["card f32"][1]) != set(ref) or not e_card <= bar:
        raise SystemExit("resnet: the card's gradients stray from the CPU's")
    return trainer, probs


def clone_tree(tree):
    """A copy of nested dicts and tuples of tensors (numbers pass)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(clone_tree(v) for v in tree)
    return tree.clone() if hasattr(tree, "clone") else tree


def trees_equal(torch, a, b) -> bool:
    """Bit equality of two nested dicts and tuples of tensors."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(trees_equal(torch, a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(trees_equal(torch, x, y) for x, y in zip(a, b))
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def phase_nan_step(torch, P, trainer):
    """Phase 8: one step on a batch with a NaN pixel through the trainer's
    train step: the divergence sentinel must report health 0 and leave
    params, layer state and optimizer state torch.equal to before."""
    from paddle_tpu_torch.reader.feeder import DataFeeder

    samples = resnet_images(np.random.RandomState(9), RN_BATCH)
    samples[3][0][RN_IMG] = np.nan
    batch = DataFeeder(trainer.topology.data_types(), RN_FEEDING, device=trainer.device)(samples)
    params, state, opt = trainer.parameters.params, trainer.parameters.state, trainer._opt_state
    before = clone_tree((params, state, opt))
    step = P.trainer.make_train_step(trainer.network, trainer.optimizer)
    p2, s2, o2, m = step(params, state, opt, batch, 1)
    health = float(m["health"])
    same = trees_equal(torch, (p2, s2, o2), before)
    say(f"resnet sentinel: a batch with a NaN pixel: cost {float(m['cost'])}, grad_norm "
        f"{float(m['grad_norm'])}, health {health}; params, batch-norm state and momentum "
        f"(step {o2['step']}) torch.equal to before: {same}")
    if health != 0.0 or not same:
        raise SystemExit("resnet: the NaN step was not skipped with the state unchanged")


def phase_resnet_infer(torch, P, probs, trainer, card):
    """Phase 7: ResNet-50 serving through Inference.infer from the trained
    parameters and state (global statistics)."""
    from paddle_tpu_torch.core.device import tree_to
    from paddle_tpu_torch.reader.feeder import DataFeeder

    P.init(compute_dtype="bfloat16")
    inf = P.Inference(probs, trainer.parameters)
    images = [(x,) for x, _ in resnet_images(np.random.RandomState(7), RN_INFER + RN_BATCH)]
    inf.infer(images[RN_INFER:], batch_size=RN_BATCH)  # warm-up
    torch.cuda.synchronize()
    results, batch_s = [], []
    t0 = time.perf_counter()
    for res in inf.iter_infer_field(field="value", input=images[:RN_INFER], batch_size=RN_BATCH):
        # each batch ends in a host copy of its outputs, which waits for the card
        batch_s.append(time.perf_counter() - t0 - sum(batch_s))
        results.append(res[0])
    wall = time.perf_counter() - t0
    out = np.concatenate(results, axis=0)
    sums = out.sum(axis=1)
    say(f"resnet infer: {RN_INFER} images in {len(results)} batches of {RN_BATCH}, bf16, seconds "
        f"per batch {[round(x, 4) for x in batch_s]}, {RN_INFER / wall:.2f} images/s on {card}; "
        f"row sums in [{sums.min():.6f}, {sums.max():.6f}], top probability "
        f"{out.max(axis=1).mean():.4f} on average")
    if out.shape != (RN_INFER, RN_CLASSES) or not np.isfinite(out).all():
        raise SystemExit(f"resnet infer: output {out.shape} not finite or not "
                         f"{(RN_INFER, RN_CLASSES)}")
    if np.abs(sums - 1.0).max() > 1e-2:
        raise SystemExit("resnet infer: a distribution does not sum to 1 within 1e-2")

    P.init(compute_dtype="float32")
    two = images[:RN_CHECK_B]
    card_p = P.Inference(probs, trainer.parameters).infer(two, batch_size=RN_CHECK_B)
    cpu_p = P.Inference(probs, trainer.parameters, device="cpu").infer(two, batch_size=RN_CHECK_B)
    dp = float(np.abs(card_p - cpu_p).max())
    # the same forward's logits, on each device
    net = P.CompiledNetwork(P.Topology(probs), compute_dtype="float32")
    logits = []
    for dev in (trainer.device, torch.device("cpu")):
        batch = DataFeeder(net.topology.data_types(), {"image": 0}, device=dev)(two)
        with torch.inference_mode():
            outs, _ = net.apply(tree_to(trainer.parameters.params, dev), batch,
                                state=tree_to(trainer.parameters.state, dev), train=False)
        logits.append(outs[probs.name + "@logits"].data.cpu().double())
    dl = ((logits[0] - logits[1]).abs().max() / logits[1].abs().max()).item()
    say(f"resnet infer f32 B={RN_CHECK_B}, card vs CPU: max|dp| = {dp:.3e} (<= {RN_PROB_ABS}), "
        f"max|dlogit|/max|logit| = {dl:.3e} (<= {RN_LOGIT_REL}, largest |logit| "
        f"{logits[1].abs().max().item():.4e}), top classes {card_p.argmax(axis=1).tolist()} vs "
        f"{cpu_p.argmax(axis=1).tolist()}")
    if not dp <= RN_PROB_ABS or not dl <= RN_LOGIT_REL:
        raise SystemExit("resnet infer: card and CPU outputs disagree")
    P.init(compute_dtype="bfloat16")


# device kernels that only change a tensor's layout or dtype
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw", "direct_copy")


def phase_resnet_profile(torch, P, trainer):
    """Phase 9: torch.profiler over two ResNet-50 training steps: the top
    device kernels, the busy share, and the layout-transform kernels per
    step beside the convs, which shows whether the convs run in NHWC."""
    samples = resnet_images(np.random.RandomState(8), 2 * RN_BATCH)
    wall, events, dev = device_window(torch, lambda: run_resnet(P, trainer, samples),
                                      "resnet profile")
    total_us = sum(e.self_device_time_total for e in dev)
    if total_us <= 0:
        say("resnet profile: device time not measured (no window recorded any)")
        return
    say(f"resnet profile: 2 steps in {wall:.4f} s (profiler on), device busy {total_us / 1e6:.4f} s "
        f"({total_us / 1e6 / wall:.3f} of the window); top device kernels per step:")
    for e in sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        say(f"  {e.self_device_time_total / 2e3:9.3f} ms  {e.count / 2:6.1f} calls  "
            f"{100 * e.self_device_time_total / total_us:5.1f}%  {e.key[:100]}")
    ops = {e.key: e.count / 2 for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    say("resnet profile: conv ops per step: " + ", ".join(
        f"{k} {ops.get(k, 0):.1f}" for k in ("aten::cudnn_convolution", "aten::convolution_backward")))
    for pat in LAYOUT_KERNELS:
        hits = [e for e in dev if pat in e.key]
        say(f"resnet profile: '{pat}' kernels per step: {sum(e.count for e in hits) / 2:.1f} "
            f"launches, {sum(e.self_device_time_total for e in hits) / 2e3:.3f} ms "
            f"({100 * sum(e.self_device_time_total for e in hits) / total_us:.1f}% of device time)")
    groups = {"torch's own kernels (elementwise, reductions, copies)": lambda k: "at::native" in k,
              "memcpy and memset": lambda k: k.startswith(("Memcpy", "Memset")),
              "library kernels (cuDNN convs, cuBLAS)": lambda k: True}
    left = list(dev)
    for name, match in groups.items():
        hits = [e for e in left if match(e.key)]
        left = [e for e in left if not match(e.key)]
        us = sum(e.self_device_time_total for e in hits)
        say(f"resnet profile: {name}: {us / 2e3:.3f} ms per step ({100 * us / total_us:.1f}% of "
            f"device time), {sum(e.count for e in hits) / 2:.1f} launches")

# Phase 10: the training spine at full width, on phase 5's configuration.
SPINE_BATCHES, SPINE_PASSES = 3, 2  # distinct batches per pass, passes
SPINE_SAVE_STEP = 2  # save_checkpoint after this step
SPINE_SPREAD_SLACK = 3.0  # restored costs within this times two runs' spread
SENTINEL_ROUNDS = 10  # (off, on, on, off) rounds timing the sentinel's cost
# Phase 10b: each rule 3 updates of the full parameter tree in f32, card
# against CPU from the same numbers: elementwise arithmetic that may round
# differently in the last place (fused multiply-adds), far below 1e-5 of the
# leaf's largest |param|
OPT_UPDATES, OPT_REL = 3, 1e-5
OPT_RULES = {
    "Momentum": dict(learning_rate=0.01, momentum=0.9),
    "SparseMomentum": dict(learning_rate=0.01),
    "AdaGrad": dict(learning_rate=0.01),
    "AdaDelta": dict(learning_rate=1.0),
    "RMSProp": dict(learning_rate=1e-3),
    "DecayedAdaGrad": dict(learning_rate=1e-3),
    "Adam": dict(learning_rate=1e-3),
    "AdaMax": dict(learning_rate=2e-3),
}
# Phase 10c: dropout on an fc of width 2048 over 8 x 1024 tokens (bf16), and
# error clipping card against CPU in f32 (summation order only: relative L2
# of the gradients <= 1e-5; the clip must bind, moving them >= 1e-2)
DROP_RATE, DROP_IN, DROP_W = 0.1, 512, 2048
CLIP_T, CLIP_REL, CLIP_BINDS = 1e-3, 1e-5, 1e-2


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def phase_spine(torch, P, fa, card, phase5_s):
    """Phase 10; returns the trained parameter tree (for phase 10b)."""
    import io
    import tempfile

    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch.models.transformer import transformer_base

    P.init(seed=31, compute_dtype="bfloat16", use_flash_attention=True)
    cost, probs = transformer_base(VOCAB, VOCAB)
    rng = np.random.RandomState(31)
    batches = [train_samples(rng, BATCH) for _ in range(SPINE_BATCHES)]
    held = train_samples(rng, BATCH)
    n_steps = SPINE_BATCHES * SPINE_PASSES

    def make_trainer(seed):
        return P.trainer.SGD(cost, P.parameters.create(cost, seed=seed),
                             P.optimizer.Momentum(learning_rate=TRAIN_LR, momentum=0.9))

    def run(trainer, batch_list, num_passes, log, on_extra=None, **kw):
        samples = [x for b in batch_list for x in b]
        clock = [0.0]

        def on_event(e):
            if isinstance(e, P.event.BeginIteration):
                torch.cuda.synchronize()
                clock[0] = time.perf_counter()
            elif isinstance(e, P.event.EndIteration):
                log.append((e.cost, time.perf_counter() - clock[0]))
            if on_extra is not None:
                on_extra(e)

        trainer.train(P.batch(lambda: iter(samples), BATCH), num_passes=num_passes,
                      feeding=FEEDING, event_handler=on_event, **kw)

    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-spine-")
    reset_counts(fa)
    t_phase = time.perf_counter()
    # (a) the uninterrupted run, sentinel on (the default)
    trainer = make_trainer(31)
    man = ckpt.CheckpointManager(os.path.join(tmp.name, "ckpt"), max_to_keep=1)
    log_a, info, snap = [], {"test": [], "tar": []}, {}

    def on_extra(e):
        if isinstance(e, P.event.EndIteration) and len(log_a) == SPINE_SAVE_STEP:
            # the parameters and momentum are updated in place: the trainer
            # holds this step's values
            t0 = time.perf_counter()
            trainer.save_checkpoint(man)
            info["save"] = (dir_bytes(man.directory), time.perf_counter() - t0)
            snap["state"] = clone_tree((trainer.parameters.params, trainer._opt_state["m"]))
            snap["step"] = (trainer._opt_state["step"], trainer._step_count)
        elif isinstance(e, P.event.EndPass):
            t0 = time.perf_counter()
            res = trainer.test(P.batch(lambda: iter(held), BATCH), feeding=FEEDING)
            info["test"].append((e.pass_id, res.cost, time.perf_counter() - t0))
            buf = io.BytesIO()
            t0 = time.perf_counter()
            trainer.save_parameter_to_tar(buf)
            info["tar"].append((len(buf.getvalue()), time.perf_counter() - t0))
            info["last_tar"] = buf

    pass_dir = os.path.join(tmp.name, "passes")
    t0 = time.perf_counter()
    run(trainer, batches, SPINE_PASSES, log_a, on_extra, save_dir=pass_dir, saving_period=1)
    t_train = time.perf_counter() - t0
    costs_a = [c for c, _ in log_a]
    say(f"spine: SGD.train {SPINE_PASSES} passes of {SPINE_BATCHES} batches in {t_train:.2f} s "
        f"(saves and tests included): costs {costs_a}, seconds per step "
        f"{[round(x, 4) for _, x in log_a]}")
    say(f"spine: EndPass trainer.test on a held-out batch (pass, cost, s): {info['test']}; "
        f"parameter tar into a buffer (bytes, s): {info['tar']}")
    passes = sorted(os.listdir(pass_dir))
    say(f"spine: save_dir holds {passes}, {dir_bytes(pass_dir)} bytes "
        f"(params.tar and one v1 file per parameter in each)")
    if (len(costs_a) != n_steps or not all(np.isfinite(costs_a)) or len(info["test"]) != 2
            or not all(np.isfinite(c) for _, c, _ in info["test"])
            or passes != ["pass-00000", "pass-00001"]):
        raise SystemExit("spine: the run, its EndPass tests or its pass dirs are incomplete")

    # (b) a Parameters from the last tar serves bit-identically
    buf = info["last_tar"]
    buf.seek(0)
    t0 = time.perf_counter()
    loaded = P.parameters.Parameters.from_tar(buf)
    t_load = time.perf_counter() - t0
    out_mem = P.Inference(probs, trainer.parameters).infer(batches[0], feeding=FEEDING,
                                                           batch_size=BATCH)
    out_tar = P.Inference(probs, loaded).infer(batches[0], feeding=FEEDING, batch_size=BATCH)
    same = bool(np.array_equal(out_mem, out_tar))
    say(f"spine: Parameters.from_tar of the last tar ({len(buf.getvalue())} bytes, read in "
        f"{t_load:.3f} s): Inference of batch 0 {out_tar.shape}, bit-identical to the "
        f"trained in-memory parameters: {same}")
    if not same or not np.isfinite(out_mem).all():
        raise SystemExit("spine: the parameters loaded from the tar serve differently")

    # (c) a trainer from fresh parameters restores the step-2 checkpoint
    restored = make_trainer(77)
    t0 = time.perf_counter()
    if not restored.restore_checkpoint(man):
        raise SystemExit("spine: restore_checkpoint found no checkpoint")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    equal = trees_equal(torch, (restored.parameters.params, restored._opt_state["m"]),
                        snap["state"])
    steps = (restored._opt_state["step"], restored._step_count)
    say(f"spine: save_checkpoint after step {SPINE_SAVE_STEP}: {info['save'][0]} bytes in "
        f"{info['save'][1]:.3f} s; restore_checkpoint into fresh parameters in {t_restore:.3f} s: "
        f"params and momentum bit-identical to the first trainer's at step {SPINE_SAVE_STEP}: "
        f"{equal}; optimizer step and step count {steps} (want {snap['step']})")
    if not equal or steps != snap["step"] or steps[0] != SPINE_SAVE_STEP:
        raise SystemExit("spine: the restored state differs from the saved one")
    del snap
    log_b = []
    rest = batches[SPINE_SAVE_STEP:] + batches * (SPINE_PASSES - 1)
    run(restored, rest, 1, log_b)
    costs_b = [c for c, _ in log_b]
    del restored
    # a second uninterrupted run, with the sentinel off: its costs give the
    # spread of two runs, its steps the time without the sentinel
    P.flags.set_flag("divergence_sentinel", False)
    try:
        plain = make_trainer(31)
    finally:
        P.flags.set_flag("divergence_sentinel", True)
    log_c = []
    run(plain, batches, SPINE_PASSES, log_c)
    costs_c = [c for c, _ in log_c]
    # the sentinel's cost: the train step with it on and off, in turns on
    # this trainer's state (off, on, on, off, ...), from batches fed before
    from paddle_tpu_torch.reader.feeder import DataFeeder

    feeder = DataFeeder(plain.topology.data_types(), FEEDING, device=plain.device)
    fed = [feeder(b) for b in batches]
    step_fns = {flag: P.trainer.make_train_step(plain.network, plain.optimizer, sentinel=flag)
                for flag in (False, True)}
    turns = {False: [], True: []}
    tree = (plain.parameters.params, plain.parameters.state, plain._opt_state)
    for i, flag in enumerate((False, True, True, False) * SENTINEL_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *tree, m = step_fns[flag](*tree, fed[i % len(fed)])
        float(m["cost"])  # waits for the step, update included
        turns[flag].append(time.perf_counter() - t0)
    del plain, tree, fed
    tail_a, tail_c = costs_a[SPINE_SAVE_STEP:], costs_c[SPINE_SAVE_STEP:]
    spread = max(abs(a - c) for a, c in zip(tail_a, tail_c))
    diff = max(abs(a - b) for a, b in zip(tail_a, costs_b)) if len(costs_b) == len(tail_a) else None
    bitwise = costs_b == tail_a
    say(f"spine: restored trainer's costs over the remaining {len(costs_b)} batches {costs_b}; "
        f"uninterrupted {tail_a}; bit for bit: {bitwise}; max |d| {diff}; a second "
        f"uninterrupted run {tail_c}, spread {spread} (bar when not bit for bit: "
        f"{SPINE_SPREAD_SLACK} x spread)")
    if diff is None or not (bitwise or (spread > 0 and diff <= SPINE_SPREAD_SLACK * spread)):
        raise SystemExit("spine: the restored trainer does not continue like the uninterrupted one")

    # (d) the kernels were on the path, (e) the sentinel's cost per step
    counts = launch_counts(fa)
    n_train = len(log_a) + len(log_b) + len(log_c) + len(turns[False]) + len(turns[True])
    say(f"spine: flash launches (fwd, dq, dkv) over phase 10: {counts} for {n_train} training "
        f"steps (18 per step each), 2 tests and 2 served batches; phase {time.perf_counter() - t_phase:.1f} s")
    if counts[0] < 18 * n_train or counts[1] != 18 * n_train or counts[2] != 18 * n_train:
        raise SystemExit("spine: the flash kernels were not on the path of every step")
    on = float(np.mean([x for _, x in log_a[1:]]))
    off = float(np.mean([x for _, x in log_c[1:]]))
    say(f"spine: seconds per SGD.train step (mean of steps 2-{n_steps}, feeding included) "
        f"sentinel on {on:.4f} (first run), off {off:.4f} (third run) ({100 * (on / off - 1):+.1f}%); "
        f"phase 5 (sentinel on) {phase5_s:.4f}; on {card}")
    q_on, q_off = (np.percentile(turns[flag], [25, 50, 75]) for flag in (True, False))
    say(f"spine: the train step alone in turns (off, on, on, off) x {SENTINEL_ROUNDS}: sentinel on "
        f"{[round(x, 4) for x in turns[True]]}, off {[round(x, 4) for x in turns[False]]}; "
        f"quartiles on {[round(float(x), 4) for x in q_on]} s, off "
        f"{[round(float(x), 4) for x in q_off]} s; "
        f"medians {100 * (q_on[1] / q_off[1] - 1):+.1f}%")
    params = trainer.parameters.params
    tmp.cleanup()
    return params


def phase_optimizers(torch, P, params, card_dev):
    """Phase 10b: the eight rules on the full Transformer-base tree, card
    against CPU."""
    base = {l: {k: v.detach().float().cpu() for k, v in p.items()} for l, p in params.items()}
    n = sum(v.numel() for p in base.values() for v in p.values())
    gen = torch.Generator().manual_seed(53)
    grads = [{l: {k: torch.randn(v.shape, generator=gen) for k, v in p.items()}
              for l, p in base.items()} for _ in range(OPT_UPDATES)]
    to_card = lambda tree: {l: {k: v.to(card_dev) for k, v in p.items()} for l, p in tree.items()}  # noqa: E731
    worst_all = 0.0
    for name, kw in OPT_RULES.items():
        cpu_p, card_p = clone_tree(base), to_card(base)
        cpu_o, card_o = getattr(P.optimizer, name)(**kw), getattr(P.optimizer, name)(**kw)
        cpu_s, card_s = cpu_o.init(cpu_p), card_o.init(card_p)
        t0 = time.perf_counter()
        for g in grads:
            card_o.update(to_card(g), card_s, card_p)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        for g in grads:
            cpu_o.update(g, cpu_s, cpu_p)
        t_cpu = time.perf_counter() - t0
        worst, leaf = -1.0, None
        for l, p in cpu_p.items():
            for k, v in p.items():
                r = ((card_p[l][k].cpu() - v).abs().max() / v.abs().max().clamp(min=1e-30)).item()
                if not r <= worst:
                    worst, leaf = r, f"{l}.{k}"
        slots = card_o.slot_names()
        say(f"optimizers: {name}({kw}) slots {slots}: {OPT_UPDATES} updates of {n} f32 parameters, "
            f"card {t_card:.3f} s (the gradients' copy included), CPU {t_cpu:.3f} s; worst "
            f"|d| / max|param| per leaf {worst:.3e} at {leaf} (<= {OPT_REL})")
        if not worst <= OPT_REL or not card_s["step"] == cpu_s["step"] == OPT_UPDATES:
            raise SystemExit(f"optimizers: {name} on the card strays from the CPU")
        worst_all = max(worst_all, worst)
        del cpu_p, card_p, cpu_s, card_s
    say(f"optimizers: worst over the eight rules {worst_all:.3e} (<= {OPT_REL})")


def phase_dropout_clip(torch, P, card_dev):
    """Phase 10c: dropout statistics on the card, and error clipping card
    against CPU."""
    from paddle_tpu_torch.core.batch import SeqTensor

    L, A, dt = P.layer, P.activation, P.data_type
    P.init(seed=41, compute_dtype="bfloat16")
    x = L.data("spine_x", dt.dense_vector_sequence(DROP_IN))
    h = L.fc(x, size=DROP_W, act=A.Sigmoid(), name="spine_drop",
             layer_attr=P.attr.ExtraAttr(drop_rate=DROP_RATE))
    net = P.CompiledNetwork(P.Topology(h))
    params = net.init_params(41)
    gen = torch.Generator(device=card_dev).manual_seed(41)
    batch = {"spine_x": SeqTensor(
        torch.randn((BATCH, T, DROP_IN), generator=gen, device=card_dev),
        torch.full((BATCH,), T, dtype=torch.int32, device=card_dev))}
    keep = 1.0 - DROP_RATE
    with torch.no_grad():
        out = lambda train, rng: net.apply(params, batch, train=train, rng=rng)[0]["spine_drop"].data  # noqa: E731
        plain = out(False, None)
        a, a2, b, off = out(True, 5), out(True, 5), out(True, 6), out(False, 5)
        torch.cuda.synchronize()
        ms_plain = time_ms(torch, lambda: out(False, None), iters=10)
        ms_drop = time_ms(torch, lambda: out(True, 5), iters=10)
    mask = a != 0
    share = mask.float().mean().item()
    sigma = (keep * DROP_RATE / mask.numel()) ** 0.5
    scaled = torch.equal(a[mask], (plain / keep)[mask])
    same, other = torch.equal(a, a2), not torch.equal(mask, b != 0)
    untouched = torch.equal(off, plain) and bool((plain != 0).all())
    say(f"dropout: fc {DROP_IN}->{DROP_W} over {BATCH}x{T} tokens, {plain.dtype}, rate {DROP_RATE}: "
        f"kept share {share:.6f} ({abs(share - keep) / sigma:.2f} sigma from {keep}, bar 5); kept "
        f"values == undropped / {keep}: {scaled}; same seed same mask: {same}; next seed another "
        f"mask: {other}; train=False untouched: {untouched}; forward {ms_drop:.4f} ms with "
        f"dropout, {ms_plain:.4f} ms without")
    if not (abs(share - keep) <= 5 * sigma and scaled and same and other and untouched):
        raise SystemExit("dropout: a check failed on the card")

    P.init(seed=43, compute_dtype="float32")
    rng = np.random.RandomState(43)
    xs = rng.randn(64, 256).astype(np.float32)
    labels = rng.randint(0, 16, size=64)
    got = {}
    for clip in (CLIP_T, 0.0):
        cx = L.data("clip_x", dt.dense_vector(256))
        lab = L.data("clip_label", dt.integer_value(16))
        attr = P.attr.ExtraAttr(error_clipping_threshold=clip) if clip else None
        hh = L.fc(cx, size=256, act=A.Tanh(), layer_attr=attr, name="clip_h")
        pred = L.fc(hh, size=16, act=A.Softmax(), name="clip_pred")
        cnet = P.CompiledNetwork(P.Topology(L.classification_cost(pred, lab)))
        cpu_params = cnet.init_params(43, device="cpu")
        for where, dev in (("card", card_dev), ("CPU", torch.device("cpu"))):
            batch = {"clip_x": SeqTensor(torch.from_numpy(xs).to(dev)),
                     "clip_label": SeqTensor(torch.from_numpy(labels).to(dev))}
            tree = {l: {k: v.to(dev) for k, v in p.items()} for l, p in cpu_params.items()}
            got[where, clip] = grads_of(torch, cnet, tree, batch)[1]
    e = rel_l2(torch, got["card", CLIP_T], got["CPU", CLIP_T])
    binds = rel_l2(torch, got["CPU", CLIP_T], got["CPU", 0.0])
    say(f"error clip: threshold {CLIP_T}, f32: clipped gradients card vs CPU relative L2 "
        f"{e:.3e} (<= {CLIP_REL}); clipped vs unclipped (CPU) {binds:.3e} (>= {CLIP_BINDS})")
    if not e <= CLIP_REL or not binds >= CLIP_BINDS:
        raise SystemExit("error clip: the card's clipped gradient strays, or the clip did not bind")
    P.init(compute_dtype="bfloat16")


# Phase 11: attention NMT training at bench.py's bench_nmt configuration
# (bench.py:486-502): word and hidden width 512, source and target vocab
# 30000, bf16 compute over f32 masters, Momentum(0.05, 0.9), 4096 pairs with
# lengths 8-50 drawn beta(2, 3) from RandomState(0), token_budget_batch with a
# budget of 128 x ladder_len(50) = 8192 padded tokens (batches of 128 at rung
# 64, 256 at rung 32, 512 at rung 16), the feeder on the shape ladder
NMT_VOCAB, NMT_WIDTH, NMT_BATCH = 30000, 512, 128
NMT_PAIRS, NMT_MIN_LEN, NMT_MAX_LEN = 4096, 8, 50
NMT_LR = 0.05
NMT_TIMED, NMT_PROFILED = 4, 2  # timed steps after one warm-up; profiled steps
# card against CPU and fused against generic: one step's gradients in f32 at a
# small width (vocab, width, batch, longest length), relative L2 over every
# leaf: summation order only
NMT_SMALL = (512, 64, 8, 30)
NMT_GRAD_REL = 1e-4


def nmt_corpus(vocab, n, seed=0):
    """bench_nmt's corpus: (src, trg, trg_next) id lists with lengths
    NMT_MIN_LEN..NMT_MAX_LEN drawn beta(2, 3)."""
    rng = np.random.RandomState(seed)
    lens = (NMT_MIN_LEN + np.floor((NMT_MAX_LEN - NMT_MIN_LEN + 1)
                                   * rng.beta(2.0, 3.0, n))).astype(int)
    return [tuple([int(t) for t in rng.randint(1, vocab, size=int(n_))] for _ in range(3))
            for n_ in lens]


def nmt_counts():
    from paddle_tpu_torch.layers.recurrent_group import counters as group
    from paddle_tpu_torch.ops.rnn import counters as cores

    return group, cores


def phase_nmt(torch, P, fa, card):
    """Phase 11: attention NMT training through SGD.train over
    token_budget_batch at bench_nmt's configuration, its profile, and one
    step's gradients card vs CPU and fused vs generic in f32."""
    from paddle_tpu_torch.core.batch import DEFAULT_LADDER, ladder_len
    from paddle_tpu_torch.core.device import tree_to
    from paddle_tpu_torch.models.seq2seq import seq2seq_cost
    from paddle_tpu_torch.reader.bucketing import token_budget_batch
    from paddle_tpu_torch.reader.feeder import DataFeeder
    from paddle_tpu_torch.utils.tree import leaves

    group, cores = nmt_counts()
    P.init(seed=51, compute_dtype="bfloat16", use_bucketing=True)
    cost, _ = seq2seq_cost(NMT_VOCAB, NMT_VOCAB, NMT_WIDTH, NMT_WIDTH)
    params = P.parameters.create(cost, seed=51)
    n_params = sum(v.numel() for v in leaves(params.params))
    trainer = P.trainer.SGD(cost, params, P.optimizer.Momentum(learning_rate=NMT_LR, momentum=0.9))
    budget = NMT_BATCH * ladder_len(NMT_MAX_LEN)
    batches = list(token_budget_batch(lambda: iter(nmt_corpus(NMT_VOCAB, NMT_PAIRS)),
                                      token_budget=budget, drop_last=True)())
    need = 1 + NMT_TIMED + NMT_PROFILED
    say(f"nmt: {n_params} parameters in {len(leaves(params.params))} leaves; {len(batches)} "
        f"batches of budget {budget} padded tokens from {NMT_PAIRS} pairs; steps: "
        + ", ".join(f"{len(b)}x{ladder_len(max(len(s[1]) for s in b))}" for b in batches[:need]))

    def train(batch_list, on_event=None):
        trainer.train(lambda: iter(batch_list), feeding=FEEDING, event_handler=on_event)

    reset_counts(fa)
    train(batches[:1])  # first step: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    group.clear()
    cores.clear()
    steps, clock = [], [0.0]

    def on_event(e):
        if isinstance(e, P.event.BeginIteration):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
        elif isinstance(e, P.event.EndIteration):
            # the cost's host copy waits for the whole step, update included
            steps.append((time.perf_counter() - clock[0], e.cost))

    timed = batches[1:1 + NMT_TIMED]
    train(timed, on_event)
    secs, costs = [s[0] for s in steps], [s[1] for s in steps]
    valid = sum(len(s[2]) for b in timed for s in b)
    say(f"nmt: {len(steps)} timed steps at Momentum({NMT_LR}, 0.9), bf16: costs "
        f"{[round(c, 4) for c in costs]}, seconds per step {[round(x, 4) for x in secs]}")
    say(f"nmt: {float(np.mean(secs)):.4f} s per step (mean of {len(secs)}), "
        f"{valid / sum(secs):.1f} valid target tokens/s ({valid} tokens), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    say(f"nmt: decoder lowerings {dict(group)}; recurrence steps run/skipped by the early "
        f"exit: gru {cores['gru_steps']}/{cores['gru_skipped']}, attention-gru "
        f"{cores['attgru_steps']}/{cores['attgru_skipped']}")
    if len(steps) != NMT_TIMED or not all(np.isfinite(costs)):
        raise SystemExit("nmt: training gave a non-finite cost or a missing step")
    if group["fused"] != NMT_TIMED or group["generic"]:
        raise SystemExit("nmt: the decoder did not take the fused attention-GRU core on every step")

    prof_batches = batches[1 + NMT_TIMED:need]
    wall, _, dev = device_window(torch, lambda: train(prof_batches), "nmt profile")
    total_us = sum(e.self_device_time_total for e in dev)
    launches = sum(e.count for e in dev)
    if total_us <= 0:
        say("nmt profile: device time not measured (no window recorded any)")
    else:
        say(f"nmt profile: {NMT_PROFILED} steps in {wall:.4f} s (profiler on), device busy "
            f"{total_us / 1e6:.4f} s ({total_us / 1e6 / wall:.3f} of the window), "
            f"{launches / NMT_PROFILED:.0f} device kernels per step; top device kernels per step:")
    for e in sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        say(f"  {e.self_device_time_total / NMT_PROFILED / 1e3:9.3f} ms  "
            f"{e.count / NMT_PROFILED:7.1f} calls  {100 * e.self_device_time_total / total_us:5.1f}%  "
            f"{e.key[:100]}")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("nmt: the NMT path launched a flash kernel")
    del trainer, params
    torch.cuda.empty_cache()

    # one step's gradients in f32 at a small width: card vs CPU, fused vs generic
    vocab, width, rows, max_len = NMT_SMALL
    P.init(seed=53, compute_dtype="float32", use_bucketing=True)
    small, _ = seq2seq_cost(vocab, vocab, width, width)
    net = P.CompiledNetwork(P.Topology(small), compute_dtype="float32")
    cpu_params = net.init_params(53, device="cpu")
    samples = [tuple(x[:max_len] for x in s) for s in nmt_corpus(vocab, rows, seed=53)]
    got = {}
    for where, dev_ in (("card", torch.device("cuda")), ("CPU", torch.device("cpu"))):
        batch = DataFeeder(net.topology.data_types(), FEEDING, ladder=DEFAULT_LADDER,
                           device=dev_)(samples)
        tree = tree_to(cpu_params, dev_)
        group.clear()
        got[where] = grads_of(torch, net, tree, batch)
        if group["fused"] != 1:
            raise SystemExit(f"nmt: the {where} gradient step did not take the fused core")
        if where == "card":
            P.flags.set_flag("fused_attention_gru", False)
            try:
                got["generic"] = grads_of(torch, net, tree, batch)
            finally:
                P.flags.set_flag("fused_attention_gru", True)
            if group["generic"] != 1:
                raise SystemExit("nmt: the generic loop did not run with the fused flag off")
    e_cpu = rel_l2(torch, got["card"][1], got["CPU"][1])
    e_gen = rel_l2(torch, got["card"][1], got["generic"][1])
    say(f"nmt f32 gradients at vocab {vocab}, width {width}, {rows} rows: cost card "
        f"{got['card'][0]:.6f} CPU {got['CPU'][0]:.6f} generic {got['generic'][0]:.6f}; "
        f"relative L2 over all {len(got['CPU'][1])} leaves: card vs CPU {e_cpu:.3e}, fused vs "
        f"generic (card) {e_gen:.3e} (<= {NMT_GRAD_REL})")
    if set(got["card"][1]) != set(got["CPU"][1]) or not (e_cpu <= NMT_GRAD_REL
                                                         and e_gen <= NMT_GRAD_REL):
        raise SystemExit("nmt: the card's gradients stray from the CPU's or the generic loop's")
    P.init(compute_dtype="bfloat16", use_bucketing=False)


# ---------------------------------------------------------------------------
# phases 12 and 13: NMT generation and serving
# ---------------------------------------------------------------------------

GEN_B, GEN_BEAM, GEN_MAXLEN, GEN_SRC = 64, 5, 32, 40  # bench_nmt_generate
GEN_TIMED = 4  # timed calls of each search, after one warm-up call
GEN_SMALL = (512, 64, 8)  # vocab, width, rows of the card-vs-CPU checks
GEN_SCORE_REL = 1e-5
SERVE_REQUESTS, SERVE_SLOTS, SERVE_K, SERVE_BUDGET_MB = 64, 16, 8, 64
NEAR_TIE = 1e-4  # a served token may leave the one-shot path's only where its top-2 gap is below


def profile_call(torch, fn):
    """(wall s, device busy s, device kernels, top kernels) of one call of fn
    under torch.profiler (device_window); busy is nan and the kernels 0,
    reported as not measured, when no window recorded device time."""
    wall, _, dev = device_window(torch, fn, "profile")
    busy_us = sum(e.self_device_time_total for e in dev)
    if busy_us <= 0:
        say("profile: device busy and kernels not measured (no window recorded device time)")
        return wall, float("nan"), 0, []
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return wall, busy_us / 1e6, sum(e.count for e in dev), [
        f"{e.self_device_time_total / 1e3:8.3f} ms {e.count:6d} calls  {e.key[:90]}" for e in top]


def top_beam_tokens(seqs, eos):
    """bench_nmt_generate's count: top-beam tokens before the first EOS (the
    whole row when there is none)."""
    top = seqs[:, 0, :].cpu().numpy()
    eos_pos = np.where(top == eos, np.arange(top.shape[1])[None, :], top.shape[1])
    return int(eos_pos.min(axis=1).sum()) or top.size


def phase_generate(torch, P, fa, card):
    """Phase 12: beam and greedy generation at bench_nmt_generate's
    configuration through Seq2SeqGenerator on the card; card vs CPU and
    fused vs generic stepping at a small width."""
    from paddle_tpu_torch.core.batch import DEFAULT_LADDER, SeqTensor, set_host_lengths
    from paddle_tpu_torch.models import seq2seq as S
    from paddle_tpu_torch.reader.feeder import DataFeeder

    P.init(seed=61, compute_dtype="float32")
    cost, _ = S.seq2seq_cost(NMT_VOCAB, NMT_VOCAB, NMT_WIDTH, NMT_WIDTH)
    params = P.parameters.create(cost, seed=61)
    gen = S.Seq2SeqGenerator(params, NMT_VOCAB, NMT_VOCAB, word_dim=NMT_WIDTH,
                             hidden_dim=NMT_WIDTH, bos_id=0, eos_id=1, max_length=GEN_MAXLEN,
                             beam_size=GEN_BEAM)
    ids = np.random.RandomState(0).randint(2, NMT_VOCAB, size=(GEN_B, GEN_SRC)).astype(np.int32)
    lens = np.full((GEN_B,), GEN_SRC, np.int32)
    batch = {"src_word": SeqTensor(torch.from_numpy(ids).cuda(),
                                   set_host_lengths(torch.from_numpy(lens).cuda(), lens))}
    reset_counts(fa)
    S.counters.clear()
    out = {}
    for name, call in (("beam", lambda: gen.generate(batch)),
                       ("greedy", lambda: gen.generate_greedy(batch))):
        res = call()  # warm-up: cuBLAS handles and heuristics
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GEN_TIMED):
            res = call()
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / GEN_TIMED
        if name == "beam":
            n_tok = top_beam_tokens(res[0], gen.eos_id)
            if not torch.isfinite(res[1]).all() or not (res[1][:, :-1] >= res[1][:, 1:]).all():
                raise SystemExit("generate: scores not finite or not sorted best first")
        else:
            n_tok = int(res[1].sum()) or res[0].numel()
        wall, busy, kernels, top = profile_call(torch, call)
        out[name] = secs
        say(f"generate {name}: {secs:.4f} s per call (mean of {GEN_TIMED}), {n_tok / secs:.1f} "
            f"{'top-beam ' if name == 'beam' else ''}tokens/s ({n_tok} tokens), "
            f"{secs / GEN_B * 1e3:.4f} ms per sentence; profiled call {wall:.4f} s, device busy "
            f"{busy:.4f} s ({busy / wall:.3f} of the window), {kernels} device kernels "
            f"({kernels / GEN_MAXLEN:.1f} per decode step) on {card}")
        for line in top:
            say(f"  {line}")
    steps = (1 + GEN_TIMED + 1) * GEN_MAXLEN
    say(f"generate: decoder steps fused {S.counters['fused']}, generic {S.counters['generic']} "
        f"({steps} beam steps and up to {steps} greedy); flash launches {launch_counts(fa)}")
    if S.counters["generic"] or S.counters["fused"] <= steps:
        raise SystemExit("generate: generation did not take the fused attention-GRU step")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("generate: the generation path launched a flash kernel")
    del gen, params
    torch.cuda.empty_cache()

    # card vs CPU, and fused vs generic on the card, at a small width in f32
    vocab, width, rows = GEN_SMALL
    small, _ = S.seq2seq_cost(vocab, vocab, width, width)
    cpu_params = P.parameters.create(small, seed=63, device="cpu")
    rng = np.random.RandomState(63)
    samples = [(rng.randint(2, vocab, size=n).tolist(),) for n in rng.randint(4, 40, size=rows)]
    got = {}
    for where in ("card", "CPU", "generic"):
        dev = "cpu" if where == "CPU" else "cuda"
        g = S.Seq2SeqGenerator(cpu_params, vocab, vocab, word_dim=width, hidden_dim=width,
                               bos_id=0, eos_id=1, max_length=GEN_MAXLEN, beam_size=GEN_BEAM,
                               device=dev)
        b = DataFeeder(g._enc_net.topology.data_types(), ladder=DEFAULT_LADDER, min_seq_len=1,
                       device=dev)(samples)
        P.flags.set_flag("fused_attention_gru", where != "generic")
        S.counters.clear()
        try:
            seqs, scores = g.generate(b)
            toks, lengths = g.generate_greedy(b, early_exit=False)
        finally:
            P.flags.set_flag("fused_attention_gru", True)
        if S.counters["fused" if where != "generic" else "generic"] != 2 * GEN_MAXLEN:
            raise SystemExit(f"generate: the {where} run took the other stepping")
        got[where] = [x.cpu() for x in (seqs, scores, toks, lengths)]
    rel = float(((got["card"][1] - got["CPU"][1]).abs() / got["CPU"][1].abs()).max())
    same = {k: all(torch.equal(a, b) for i, (a, b) in enumerate(zip(got["card"], got[k])) if i != 1)
            for k in ("CPU", "generic")}
    say(f"generate f32 at vocab {vocab}, width {width}, {rows} rows: beam and greedy tokens card "
        f"== CPU {same['CPU']}, fused == generic on the card {same['generic']}; beam scores card "
        f"vs CPU worst relative {rel:.3e} (<= {GEN_SCORE_REL}), fused vs generic "
        f"{float((got['card'][1] - got['generic'][1]).abs().max()):.3e} absolute")
    if not (same["CPU"] and same["generic"] and rel <= GEN_SCORE_REL):
        raise SystemExit("generate: the card's tokens or scores stray from the CPU's or the "
                         "generic stepping's")
    return out


def oneshot_trace(torch, eng, src, n):
    """The one-shot greedy path's chosen log-prob and top-2 gap at each of n
    steps for one request (teacher-forced on its own argmax, so the tokens
    are reference_decode's), through the same batch of the engine's rows."""
    from paddle_tpu_torch.core.batch import pad_batch_rows

    gen = eng._gen
    with torch.no_grad():
        statics, carry, b, gp = gen._prepare(pad_batch_rows(eng._feeder([(list(src),)]), eng.rows))
        step = gen._step_fn(statics, gp)
        ids = torch.full((b,), gen.bos_id, dtype=torch.int32, device=eng.device)
        toks, chosen, gaps = [], [], []
        for _ in range(n):
            logp, carry = step(ids, carry)
            top2 = torch.topk(logp[0], 2).values
            ids = torch.argmax(logp, dim=-1).to(torch.int32)
            toks.append(ids[0])
            chosen.append(top2[0])
            gaps.append(top2[0] - top2[1])
    toks = torch.stack(toks).tolist()
    n_ok = toks.index(gen.eos_id) if gen.eos_id in toks else n
    return toks[:n_ok], torch.stack(chosen).tolist(), torch.stack(gaps).tolist()


def drive_engine(eng, reqs, drills=False):
    """Admit as slots free and step until every request is served; with
    `drills`, preempt the newest request after the second dispatch (it is
    re-queued first) and cancel one after the third.  Returns (seconds,
    dispatches, preempted, cancelled)."""
    import collections

    queue = collections.deque(reqs)
    preempted = cancelled = None
    dispatches = 0
    t0 = time.perf_counter()
    while queue or eng.n_live:
        if queue and eng.n_free_slots:
            for r in eng.admit(list(queue)):
                queue.remove(r)
        eng.step()
        dispatches += 1
        if drills and dispatches == 2:
            preempted = eng.preempt()
            queue.appendleft(preempted)
        if drills and dispatches == 3:
            victim = next(r for r in eng.outstanding_requests() if r is not preempted)
            cancelled = eng.cancel_by_id(victim.req_id)
    return time.perf_counter() - t0, dispatches, preempted, cancelled


def phase_serve(torch, P, fa, card):
    """Phase 13: the ServingEngine at full width serving bench_serving's
    request mix, a preemption and a cancel, every request held to
    reference_decode under the near-tie rule."""
    from paddle_tpu_torch.models import seq2seq as S
    from paddle_tpu_torch.serving import Request, ServingEngine

    P.init(seed=61, compute_dtype="float32")
    cost, _ = S.seq2seq_cost(NMT_VOCAB, NMT_VOCAB, NMT_WIDTH, NMT_WIDTH)
    params = P.parameters.create(cost, seed=61)
    gen = S.Seq2SeqGenerator(params, NMT_VOCAB, NMT_VOCAB, word_dim=NMT_WIDTH,
                             hidden_dim=NMT_WIDTH, bos_id=0, eos_id=1, max_length=GEN_MAXLEN)
    eng = ServingEngine(gen, max_slots=SERVE_SLOTS, block_steps=SERVE_K,
                        max_new_tokens=GEN_MAXLEN, hbm_budget_mb=SERVE_BUDGET_MB)
    pages = eng.pages.summary()
    rng = np.random.RandomState(0)
    srcs = [rng.randint(2, NMT_VOCAB, size=rng.randint(4, 31)).tolist()
            for _ in range(SERVE_REQUESTS)]
    say(f"serve: {pages['n_blocks']} blocks of {pages['block_tokens']} tokens x "
        f"{pages['bytes_per_block']} bytes under {SERVE_BUDGET_MB} MB; decode bundle "
        f"{eng.weight_bytes} bytes; {SERVE_REQUESTS} requests of {min(map(len, srcs))}-"
        f"{max(map(len, srcs))} source tokens")
    # warm-up: both page rungs at every slot rung the run can reach
    for n in (16, 8, 4, 2):
        drive_engine(eng, [Request([2] * (5 + 20 * (i % 2))) for i in range(n)])
    eng.decode_shapes.clear()
    eng.prefill_shapes.clear()
    reset_counts(fa)
    reqs = [Request(s) for s in srcs]
    secs, dispatches, preempted, cancelled = drive_engine(eng, reqs, drills=True)
    served = [r for r in reqs if r is not cancelled]
    n_tok = sum(len(r.tokens) for r in served)
    tpots = sorted((r.token_times[-1] - r.t_admit) / len(r.tokens) for r in served if r.tokens)
    pct = lambda p: tpots[min(len(tpots) - 1, int(p * len(tpots)))]  # noqa: E731
    say(f"serve: {len(served)} requests in {secs:.4f} s: {len(served) / secs:.2f} requests/s, "
        f"{n_tok / secs:.1f} generated tokens/s ({n_tok} tokens); per-token latency p50 "
        f"{pct(0.5) * 1e3:.4f} ms, p99 {pct(0.99) * 1e3:.4f} ms; {dispatches} decode dispatches, "
        f"{len(eng.decode_shapes)} decode shape variants {sorted(eng.decode_shapes)}, "
        f"{len(eng.prefill_shapes)} prefill shapes; preempted {preempted.req_id}, cancelled "
        f"{cancelled.req_id} on {card}")
    if cancelled.tokens is not None or eng.pages.n_used or eng.n_free_slots != SERVE_SLOTS:
        raise SystemExit("serve: the cancel or the drain left pages or slots behind")
    wall, busy, kernels, top = profile_call(
        torch, lambda: drive_engine(eng, [Request(s) for s in srcs]))
    say(f"serve profile: the same {SERVE_REQUESTS} requests in {wall:.4f} s (profiler on), device "
        f"busy {busy:.4f} s ({busy / wall:.3f} of the window), {kernels} device kernels on "
        f"{card}; flash launches over the phase {launch_counts(fa)}")
    for line in top:
        say(f"  {line}")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("serve: the serving path launched a flash kernel")

    # the decode's products at the engine's rows: a row's bits must not
    # depend on its position, and (for the record) which other row counts
    # would round it alike
    w = eng._w
    x_gen = torch.Generator(device=eng.device).manual_seed(0)
    moved, alike = [], {}
    for name in ("w_emb", "w1", "w_ctx", "w_c", "head_w"):
        wt = w[name]
        x = torch.randn((eng.rows, wt.shape[0]), generator=x_gen, device=eng.device)
        perm = torch.randperm(eng.rows, generator=x_gen, device=eng.device)
        full = x @ wt
        if not torch.equal(x[perm] @ wt, full[perm]):
            moved.append(name)
        alike[name] = [m for m in (1, 2, 4, 8) if torch.equal(x[:m] @ wt, full[:m])]
    say(f"serve: at M = {eng.rows} rows a row's product depends on its position for {moved}; "
        "the rows of x[:M] @ W equal to M = " + f"{eng.rows}'s at M = " + "; ".join(
            f"{n} {tuple(w[n].shape)}: {ms}" for n, ms in alike.items()))
    if moved:
        raise SystemExit("serve: a product's row depends on its position at a fixed M")

    diverged, worst_d, gaps = 0, 0.0, []
    for r in served:
        ref = eng.reference_decode(r.src_ids, GEN_MAXLEN)
        toks, chosen, gap = oneshot_trace(torch, eng, r.src_ids, GEN_MAXLEN)
        if toks != ref:
            raise SystemExit(f"serve: the one-shot trace of {r.req_id} is not reference_decode's")
        j = next((i for i, (a, b) in enumerate(zip(r.tokens, ref)) if a != b),
                 None if len(r.tokens) == len(ref) else min(len(r.tokens), len(ref)))
        n_match = len(r.tokens) if j is None else j
        worst_d = max([worst_d] + [abs(a - b) for a, b in zip(r.token_logprobs[:n_match],
                                                               chosen[:n_match])])
        if j is not None:
            diverged += 1
            gaps.append((r.req_id, j, gap[j]))
    say(f"serve vs reference_decode: {diverged} of {len(served)} requests diverged "
        f"{[(rid, j, f'{g:.3e}') for rid, j, g in gaps]}; largest |d| of the emitted tokens' "
        f"log-probs over the matching prefixes {worst_d:.3e}")
    if any(g >= NEAR_TIE for _, _, g in gaps):
        raise SystemExit(f"serve: a request left the one-shot path where its top-2 gap is >= "
                         f"{NEAR_TIE}")
    # the engine's own claim is stronger: every product at the one-shot
    # path's shapes gives each request its tokens and log-probs bit for bit
    if diverged or worst_d:
        raise SystemExit("serve: the engine is not bit-identical to reference_decode")
    return {"requests_per_s": len(served) / secs, "tokens_per_s": n_tok / secs}


# ---------------------------------------------------------------------------
# phases 14 and 15: LSTM text classification and the CRF tagger
# ---------------------------------------------------------------------------

# bench_lstm_textcls (bench.py:2013): the reference's benchmark/paddle/rnn
# network at hidden_size=512, lstm_num=2, vocab 30000, reviews of 100
# tokens, batch 128.  tests/configs/demo_text_lstm.py trains this family
# with Adam(2e-3).  At width 512, on a fixed batch, Adam overshoots once the
# cost nears 0.4, not alike from run to run: at 2e-3 the cost rose to 2-6
# after 3-5 steps, in bf16 and in f32; at 1e-3 it rose at step 5 in one run
# of two.  At 5e-4 it fell over 7 steps, so the phase takes Adam(5e-4)
TXT_VOCAB, TXT_EMB, TXT_HIDDEN, TXT_LAYERS = 30000, 128, 512, 2
TXT_B, TXT_T, TXT_LR = 128, 100, 5e-4
TXT_TIMED, TXT_FIXED, TXT_PROFILED = 4, 5, 2
TXT_SERVE = 256  # reviews served through paddle.infer, in batches of TXT_B
TXT_SMALL = (512, 32, 4)  # vocab, width, rows of the card-vs-CPU checks
TXT_GRAD_REL = 1e-5
# the CRF tagger (models/sequence_tagging.py, BASELINE config #4): CoNLL-2000's
# 11 chunk types in IOB (23 labels), vocab 30000, the function's own widths,
# Adam(2e-2) as tests/test_demos.py trains it
TAG_VOCAB, TAG_LABELS, TAG_TYPES, TAG_B, TAG_LR = 30000, 23, 11, 128, 2e-2
TAG_STEPS = 200  # fresh batches: every word id is seen ~5 times
TAG_ACC = 0.9
TAG_GRAD_REL = 1e-5


def text_lstm_cost(P, vocab, emb, hidden, layers):
    """benchmark/paddle/rnn/rnn.py through the v2 DSL: embedding -> `layers`
    x simple_lstm(hidden) -> last_seq -> fc(2, softmax) -> classification
    cost.  Returns (cost, probabilities)."""
    L = P.layer
    net = L.embedding(L.data("word", P.data_type.integer_value_sequence(vocab)), size=emb)
    for _ in range(layers):
        net = P.networks.simple_lstm(net, hidden)
    probs = L.fc(L.last_seq(net), size=2, act=P.activation.Softmax())
    label = L.data("label", P.data_type.integer_value(2))
    return L.classification_cost(input=probs, label=label), probs


def text_reviews(rng, n, vocab, ragged):
    """n (token ids, label) reviews from `rng`: TXT_T tokens each, or (ragged)
    10-100 tokens drawn beta(2, 3) as bench.py draws its variable-length
    corpus (bench.py:2089-2096)."""
    if ragged:
        lens = (10 + np.floor(91 * rng.beta(2.0, 3.0, size=n))).astype(int)
    else:
        lens = np.full(n, TXT_T)
    return [([int(t) for t in rng.randint(2, vocab, size=int(m))], int(rng.randint(0, 2)))
            for m in lens]


def addmm_counts(run) -> dict:
    """{input shapes: count} of the aten::addmm calls `run()` makes, from
    torch.profiler with shapes recorded (a window of its own: recording
    shapes slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        run()
    return {str(e.input_shapes[:3]): e.count
            for e in prof.key_averages(group_by_input_shape=True) if e.key == "aten::addmm"}


def small_grads_card_cpu(torch, P, cost, samples, feeding):
    """One step's f32 cost and gradients of `cost` on the card and on the
    CPU from the same parameters: (card, CPU) pairs of (cost, {name:
    gradient})."""
    from paddle_tpu_torch.core.device import tree_to
    from paddle_tpu_torch.reader.feeder import DataFeeder

    net = P.CompiledNetwork(P.Topology(cost), compute_dtype="float32")
    cpu_params = net.init_params(71, device="cpu")
    out = []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        batch = DataFeeder(net.topology.data_types(), feeding, device=dev)(samples)
        out.append(grads_of(torch, net, tree_to(cpu_params, dev), batch))
    return out


def phase_text_lstm(torch, P, fa, card):
    """Phase 14: LSTM text classification at bench_lstm_textcls's width
    through SGD.train and paddle.infer, its profile, the early exit on a
    ragged batch and one step's f32 gradients card vs CPU."""
    from paddle_tpu_torch.ops.rnn import counters as cores
    from paddle_tpu_torch.utils.tree import leaves

    feeding = {"word": 0, "label": 1}
    P.init(seed=81, compute_dtype="bfloat16")
    cost, probs = text_lstm_cost(P, TXT_VOCAB, TXT_EMB, TXT_HIDDEN, TXT_LAYERS)
    params = P.parameters.create(cost, seed=81)
    trainer = P.trainer.SGD(cost, params, P.optimizer.Adam(learning_rate=TXT_LR))
    rng = np.random.RandomState(0)
    reviews = text_reviews(rng, TXT_B * (1 + TXT_TIMED + TXT_PROFILED), TXT_VOCAB, False)
    batches = [reviews[i * TXT_B:(i + 1) * TXT_B] for i in range(1 + TXT_TIMED + TXT_PROFILED)]
    say(f"text lstm: {sum(v.numel() for v in leaves(params.params))} parameters; batches of "
        f"{TXT_B} reviews x {TXT_T} tokens, bf16 over f32 masters, Adam({TXT_LR})")

    def train(batch_list, on_event=None):
        trainer.train(lambda: iter(batch_list), feeding=feeding, event_handler=on_event)

    reset_counts(fa)
    train(batches[:1])  # first step: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cores.clear()
    steps, clock = [], [0.0]

    def on_event(e):
        if isinstance(e, P.event.BeginIteration):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
        elif isinstance(e, P.event.EndIteration):
            # the cost's host copy waits for the whole step, update included
            steps.append((time.perf_counter() - clock[0], e.cost))

    train(batches[1:1 + TXT_TIMED], on_event)
    secs, costs = [s[0] for s in steps], [s[1] for s in steps]
    mean_s = float(np.mean(secs))
    say(f"text lstm: {len(steps)} timed steps: costs {[round(c, 4) for c in costs]}, seconds per "
        f"step {[round(x, 4) for x in secs]}; {mean_s:.4f} s per step, {TXT_B / mean_s:.1f} "
        f"reviews/s, {TXT_B * TXT_T / mean_s:.1f} tokens/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    say(f"text lstm: LSTM steps run/skipped over the timed steps {cores['lstm_steps']}/"
        f"{cores['lstm_skipped']} ({TXT_LAYERS} layers x {TXT_T} steps x {TXT_TIMED})")
    if len(steps) != TXT_TIMED or not all(np.isfinite(costs)):
        raise SystemExit("text lstm: training gave a non-finite cost or a missing step")
    if cores["lstm_steps"] != TXT_LAYERS * TXT_T * TXT_TIMED:
        raise SystemExit("text lstm: the LSTM cores did not run every timestep")

    fixed = []
    trainer.train(lambda: iter([batches[1]] * TXT_FIXED), feeding=feeding,
                  event_handler=lambda e: fixed.append(e.cost)
                  if isinstance(e, P.event.EndIteration) else None)
    say(f"text lstm: {TXT_FIXED} steps on one batch: costs {[round(c, 4) for c in fixed]}")
    if not (np.isfinite(fixed).all() and fixed[-1] < fixed[0]):
        raise SystemExit("text lstm: the cost did not fall over repeated steps on one batch")

    wall, busy, kernels, top = profile_call(torch, lambda: train(batches[1 + TXT_TIMED:]))
    kernels /= TXT_PROFILED
    addmm = addmm_counts(lambda: train(batches[1:2]))
    h, g = TXT_HIDDEN, 4 * TXT_HIDDEN
    fwd_chain = addmm.get(str([[TXT_B, g], [TXT_B, h], [h, g]]), 0)
    bwd_chain = addmm.get(str([[TXT_B, h], [TXT_B, g], [g, h]]), 0)
    say(f"text lstm profile: {TXT_PROFILED} steps in {wall:.4f} s (profiler on), device busy "
        f"{busy:.4f} s ({busy / wall:.3f} of the window; {busy / TXT_PROFILED / mean_s:.3f} of a "
        f"timed step), {kernels:.0f} device kernels per step, {kernels / TXT_T:.1f} per "
        f"timestep (both layers, forward and backward); chain GEMMs in one step: forward "
        f"{fwd_chain}, backward {bwd_chain} (expected {TXT_LAYERS * TXT_T} each) on {card}; top "
        f"device kernels over the {TXT_PROFILED} steps:")
    for line in top:
        say(f"  {line}")
    if fwd_chain != TXT_LAYERS * TXT_T or bwd_chain != TXT_LAYERS * TXT_T:
        raise SystemExit(f"text lstm: chain GEMMs per step {fwd_chain}/{bwd_chain}, not "
                         f"{TXT_LAYERS * TXT_T} each")

    # the early exit on a ragged batch of bench.py's variable-length corpus
    ragged = text_reviews(np.random.RandomState(1), TXT_SERVE, TXT_VOCAB, True)
    cores.clear()
    train([ragged[:TXT_B]])
    longest = max(len(r[0]) for r in ragged[:TXT_B])
    say(f"text lstm: ragged batch (lengths {min(len(r[0]) for r in ragged[:TXT_B])}-{longest}, "
        f"mean {np.mean([len(r[0]) for r in ragged[:TXT_B]]):.1f}): LSTM steps run/skipped "
        f"{cores['lstm_steps']}/{cores['lstm_skipped']}")
    if cores["lstm_steps"] != TXT_LAYERS * longest:
        raise SystemExit("text lstm: the early exit did not run exactly the live steps")

    t0 = time.perf_counter()
    out = P.infer(probs, trainer.parameters, [(r[0],) for r in ragged], batch_size=TXT_B)
    wall = time.perf_counter() - t0
    sums = out.sum(axis=1)
    say(f"text lstm infer: {TXT_SERVE} ragged reviews in batches of {TXT_B}, bf16, in "
        f"{wall:.4f} s ({TXT_SERVE / wall:.1f} reviews/s) on {card}; row sums in "
        f"[{sums.min():.6f}, {sums.max():.6f}]")
    if out.shape != (TXT_SERVE, 2) or not np.isfinite(out).all() or np.abs(sums - 1).max() > 1e-2:
        raise SystemExit("text lstm infer: a distribution is not finite or does not sum to 1")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("text lstm: the LSTM path launched a flash kernel")
    del trainer, params
    torch.cuda.empty_cache()

    # one step's f32 gradients at a small width, card vs CPU
    vocab, width, rows = TXT_SMALL
    P.init(seed=83, compute_dtype="float32")
    samples = text_reviews(np.random.RandomState(2), rows, vocab, True)
    samples = [(s[0][: 5 + 7 * i], s[1]) for i, s in enumerate(samples)]

    def small_net(kind):
        L = P.layer
        emb = L.embedding(L.data("word", P.data_type.integer_value_sequence(vocab)), size=width)
        if kind == "lstm_group":
            proj = L.fc(emb, size=4 * width, act=P.activation.Identity(), bias_attr=False)
            seq = P.networks.lstmemory_group(proj, size=width)
        else:
            seq = P.networks.simple_lstm(emb, width, reverse=kind == "reverse")
        probs_ = L.fc(L.last_seq(seq), size=2, act=P.activation.Softmax())
        return L.classification_cost(input=probs_,
                                     label=L.data("label", P.data_type.integer_value(2)))

    for kind in ("lstm", "reverse", "lstm_group"):
        (c_card, g_card), (c_cpu, g_cpu) = small_grads_card_cpu(
            torch, P, small_net(kind), samples, feeding)
        err = rel_l2(torch, g_card, g_cpu)
        say(f"text lstm f32 {kind} at vocab {vocab}, width {width}, {rows} rows (lengths "
            f"{[len(s[0]) for s in samples]}): cost card {c_card:.7f} CPU {c_cpu:.7f}; gradients "
            f"relative L2 over {len(g_cpu)} leaves {err:.3e} (<= {TXT_GRAD_REL})")
        if (set(g_card) != set(g_cpu) or abs(c_card - c_cpu) > TXT_GRAD_REL * abs(c_cpu)
                or not err <= TXT_GRAD_REL):
            raise SystemExit(f"text lstm: the card's {kind} gradients stray from the CPU's")
    P.init(compute_dtype="bfloat16")
    return {"s_per_step": mean_s}


def phase_tagger(torch, P, fa, card):
    """Phase 15: the CRF tagger (ner_crf_cost) trained through SGD.train with
    chunk_evaluator, decoded through paddle.infer(field='id'); its profile;
    crf costs, gradients and paths card vs CPU."""
    from paddle_tpu_torch.evaluator import chunk_evaluator
    from paddle_tpu_torch.models.sequence_tagging import ner_crf_cost, synthetic_tag_reader

    P.init(seed=91, compute_dtype="float32")
    cost, decode = ner_crf_cost(TAG_VOCAB, TAG_LABELS, sparse_update=True)
    label = cost.parents[1]
    trainer = P.trainer.SGD(
        cost, P.parameters.create(cost, seed=91), P.optimizer.Adam(learning_rate=TAG_LR),
        extra_layers=[decode], evaluators=[chunk_evaluator(decode, label, "IOB", TAG_TYPES,
                                                           name="chunk")])
    corpus = list(synthetic_tag_reader(TAG_VOCAB, TAG_LABELS, n=TAG_B * TAG_STEPS, seed=0)())
    reset_counts(fa)
    steps, clock = [], [0.0]

    def on_event(e):
        if isinstance(e, P.event.BeginIteration):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
        elif isinstance(e, P.event.EndIteration):
            steps.append((time.perf_counter() - clock[0], e.cost, e.evaluator["chunk.F1"]))

    trainer.train(P.batch(lambda: iter(corpus), TAG_B), event_handler=on_event)
    secs = [s[0] for s in steps[1:]]  # the first step builds cuBLAS handles
    costs = [s[1] for s in steps]
    tokens = sum(len(w) for w, _ in corpus[TAG_B:])
    first, last = float(np.mean(costs[:4])), float(np.mean(costs[-4:]))
    say(f"tagger: {len(steps)} steps of {TAG_B} sentences (vocab {TAG_VOCAB}, {TAG_LABELS} "
        f"labels, f32, Adam({TAG_LR})): mean cost of the first 4 {first:.4f}, of the last 4 "
        f"{last:.4f}; {float(np.mean(secs)):.4f} s per step after the first, "
        f"{tokens / sum(secs):.1f} tokens/s; chunk F1 of the first and last step "
        f"{steps[0][2]:.4f}, {steps[-1][2]:.4f} on {card}")
    if not (np.isfinite(costs).all() and last < 0.5 * first):
        raise SystemExit("tagger: the mean of the last 4 costs is not under half the first 4's")

    wall, busy, kernels, top = profile_call(
        torch, lambda: trainer.train(P.batch(lambda: iter(corpus[:2 * TAG_B]), TAG_B)))
    say(f"tagger profile: 2 steps in {wall:.4f} s (profiler on), device busy {busy:.4f} s "
        f"({busy / wall:.3f} of the window; {busy / 2 / float(np.mean(secs)):.3f} of a timed "
        f"step), {kernels / 2:.0f} device kernels per step on {card}; top device kernels over "
        "the 2 steps:")
    for line in top:
        say(f"  {line}")

    fresh = list(synthetic_tag_reader(TAG_VOCAB, TAG_LABELS, n=TAG_B, seed=11)())
    t0 = time.perf_counter()
    ids = P.infer(output_layer=decode, parameters=trainer.parameters,
                  input=[(w,) for w, _ in fresh], field="id")
    wall = time.perf_counter() - t0
    want = np.concatenate([np.asarray(w) % TAG_LABELS for w, _ in fresh])
    acc = float((ids == want).mean()) if ids.shape == want.shape else 0.0
    say(f"tagger infer: {TAG_B} fresh sentences decoded by paddle.infer(field='id') in "
        f"{wall:.4f} s on {card}: {ids.shape[0]} tags, accuracy {acc:.4f} (> {TAG_ACC})")
    if not acc > TAG_ACC:
        raise SystemExit("tagger: the decoded tag accuracy is not above 0.9")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("tagger: the tagger's path launched a flash kernel")
    del trainer
    torch.cuda.empty_cache()

    # crf costs, gradients and paths in f32, card vs CPU, on ragged rows
    # with a length-1 sentence, and a constructed Viterbi tie
    from paddle_tpu_torch.core.device import tree_to
    from paddle_tpu_torch.reader.feeder import DataFeeder

    P.init(seed=93, compute_dtype="float32")
    small_cost, small_decode = ner_crf_cost(512, TAG_LABELS)
    rows = list(synthetic_tag_reader(512, TAG_LABELS, n=8, seed=3)())
    rows[1] = (rows[1][0][:1], rows[1][1][:1])
    (c_card, g_card), (c_cpu, g_cpu) = small_grads_card_cpu(torch, P, small_cost, rows, None)
    err = rel_l2(torch, g_card, g_cpu)
    say(f"tagger f32 at vocab 512, 8 rows (lengths {[len(r[0]) for r in rows]}): crf cost card "
        f"{c_card:.7f} CPU {c_cpu:.7f}; gradients relative L2 over {len(g_cpu)} leaves "
        f"{err:.3e} (<= {TAG_GRAD_REL})")
    if abs(c_card - c_cpu) > TAG_GRAD_REL * abs(c_cpu) or not err <= TAG_GRAD_REL:
        raise SystemExit("tagger: the card's crf cost or gradients stray from the CPU's")
    net = P.CompiledNetwork(P.Topology([small_cost, small_decode]), compute_dtype="float32")
    cpu_params = net.init_params(95, device="cpu")
    tied = {k: dict(v) for k, v in cpu_params.items()}
    tied["crf_cost"]["w"] = torch.zeros_like(tied["crf_cost"]["w"])
    tied["crf_input"]["w0"] = torch.zeros_like(tied["crf_input"]["w0"])
    tied["crf_input"]["b"] = torch.zeros_like(tied["crf_input"]["b"]).index_fill_(
        0, torch.tensor([3, 7, 19]), 2.0)  # labels 3, 7 and 19 tie at every step
    paths = {}
    for name, tree in (("random", cpu_params), ("tie", tied)):
        for where, dev in (("card", torch.device("cuda")), ("CPU", torch.device("cpu"))):
            batch = DataFeeder(net.topology.data_types(), None, device=dev)(rows)
            with torch.inference_mode():
                outs, _ = net.apply(tree_to(tree, dev), batch, train=False)
            paths[name, where] = outs[small_decode.name].data.cpu()
        same = torch.equal(paths[name, "card"], paths[name, "CPU"])
        say(f"tagger crf_decoding {name}: card paths equal the CPU's: {same}")
        if not same:
            raise SystemExit(f"tagger: the card's Viterbi paths ({name}) differ from the CPU's")
    lengths = [len(r[0]) for r in rows]
    tie_rows = [paths["tie", "card"][i, :n].tolist() for i, n in enumerate(lengths)]
    if any(set(r) != {3} for r in tie_rows):
        raise SystemExit(f"tagger: the tie did not take the first maximum: {tie_rows}")
    P.init(compute_dtype="bfloat16")
    return {"s_per_step": float(np.mean(secs))}


# phase 16: bench_lstm_textcls as bench.py runs it, through the port's v1
# front end: a v1 config (the network of bench.py:2013-2020, widths through
# get_config_arg) and a @provider over a pickle in the rnn benchmark's
# schema, (token lists, labels)
V1_CONFIG = """
from paddle.trainer_config_helpers import *

vocab = get_config_arg("vocab", int, 30000)
hidden_size = get_config_arg("hidden_size", int, 128)
lstm_num = get_config_arg("lstm_num", int, 1)
batch_size = get_config_arg("batch_size", int, 128)
settings(batch_size=batch_size, learning_rate=5e-4, learning_method=AdamOptimizer())
define_py_data_sources2("train.list", None, module="provider", obj="process",
                        args={"vocab": vocab})
net = data_layer("data", vocab)
net = embedding_layer(input=net, size=128)
for i in range(lstm_num):
    net = simple_lstm(input=net, size=hidden_size)
net = last_seq(input=net)
net = fc_layer(input=net, size=2, act=SoftmaxActivation())
lab = data_layer("label", 2)
outputs(classification_cost(input=net, label=lab))
"""
V1_PROVIDER = """
import pickle
from paddle.trainer.PyDataProvider2 import *

@provider(input_types=[integer_value_sequence(30000), integer_value(2)], should_shuffle=False)
def process(settings, path, vocab=30000):
    with open(path, "rb") as f:
        x, y = pickle.load(f)
    for ids, label in zip(x, y):
        yield [int(t) % vocab for t in ids], int(label)
"""
V1_ARGS = "hidden_size=512,lstm_num=2,batch_size=128"
V1_REVIEWS = 512
V1_BUDGET = 12800  # bucketing_token_budget of the ragged corpus
V1_PRUNE = (2048, 512, 0.75, 5)  # fc in, out, sparsity ratio, steps
V1_TURNS = 4  # rounds of the in-turns v1 / v2 comparison


def v1_stage(d, name, reviews):
    """Write the reviews as the rnn benchmark's pickle `name` and point
    train.list at it."""
    import pickle

    with open(os.path.join(d, name), "wb") as f:
        pickle.dump(([r[0] for r in reviews], [r[1] for r in reviews]), f, protocol=2)
    with open(os.path.join(d, "train.list"), "w") as f:
        f.write(os.path.join(d, name) + "\n")


def phase_v1(torch, P, fa, card, lstm14):
    """Phase 16: bench_lstm_textcls through the v1 front end at full width
    (parse_config -> make_optimizer -> make_provider_reader -> DataFeeder ->
    SGD.train), token-budget bucketing through make_batched_reader, card
    against CPU for the v1-parsed network, a nested batch and a sparse slot,
    and the pruning hook."""
    import shutil
    import tempfile

    from paddle_tpu_torch import v1_compat
    from paddle_tpu_torch.core.batch import ladder_len
    from paddle_tpu_torch.ops.rnn import counters as cores
    from paddle_tpu_torch.reader import feeder as feeder_mod
    from paddle_tpu_torch.utils.tree import leaves

    d = tempfile.mkdtemp(prefix="v1_textcls_")
    try:
        with open(os.path.join(d, "textcls.py"), "w") as f:
            f.write(V1_CONFIG)
        with open(os.path.join(d, "provider.py"), "w") as f:
            f.write(V1_PROVIDER)
        v1_stage(d, "reviews.pkl", text_reviews(np.random.RandomState(0), V1_REVIEWS, TXT_VOCAB,
                                                False))
        reset_counts(fa)
        # the reference's init arguments: use_gpu=False does not move the port
        # off the card
        P.init(seed=91, compute_dtype="bfloat16", use_gpu=False, trainer_count=1)
        from paddle_tpu_torch.core.device import resolve_device

        if resolve_device(None).type != "cuda":
            raise SystemExit("v1: init(use_gpu=False) moved the port off the card")
        parsed = v1_compat.parse_config(os.path.join(d, "textcls.py"), V1_ARGS)
        st = parsed.settings
        opt = v1_compat.make_optimizer(st)
        types = parsed.topology.data_types()
        say(f"v1: parse_config(textcls.py, {V1_ARGS!r}): {len(parsed.topology.layers)} layers, "
            f"outputs {parsed.output_layers}, slots {[(n, t.kind.value, t.seq.name, t.dim) for n, t in types]}, "
            f"batch_size {st.batch_size}, {type(opt).__name__}({st.learning_rate})")
        if st.batch_size != TXT_B or type(opt).__name__ != "Adam" or st.learning_rate != TXT_LR:
            raise SystemExit("v1: the settings did not parse as written")
        reader = v1_compat.make_provider_reader(parsed, d)
        first = list(P.reader.firstn(reader, TXT_B)())
        fed = P.reader.DataFeeder(types, parsed.feeding)(first)
        say(f"v1: DataFeeder(p.topology.data_types()) on the first {TXT_B} reviews: "
            f"{ {k: (tuple(v.data.shape), str(v.data.device)) for k, v in fed.items()} }")
        params = P.parameters.create(parsed.topology.outputs, seed=91)
        trainer = P.trainer.SGD(parsed.topology, params, opt)
        batched = P.batch(reader, st.batch_size)
        trainer.train(P.batch(P.reader.firstn(reader, TXT_B), TXT_B),
                      feeding=parsed.feeding)  # warm-up step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cores.clear()
        steps, clock = [], [0.0]

        def on_event(e):
            if isinstance(e, P.event.BeginIteration):
                torch.cuda.synchronize()
                clock[0] = time.perf_counter()
            elif isinstance(e, P.event.EndIteration):
                steps.append((time.perf_counter() - clock[0], e.cost))

        trainer.train(batched, feeding=parsed.feeding, event_handler=on_event)
        secs, costs = [s[0] for s in steps], [s[1] for s in steps]
        mean_s = float(np.mean(secs))
        n_timed = V1_REVIEWS // TXT_B
        say(f"v1 text lstm: {sum(v.numel() for v in leaves(params.params))} parameters; "
            f"{len(steps)} timed steps: costs {[round(c, 4) for c in costs]}, seconds per step "
            f"{[round(x, 4) for x in secs]}; {mean_s:.4f} s per step, {TXT_B / mean_s:.1f} "
            f"reviews/s, {TXT_B * TXT_T / mean_s:.1f} tokens/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}; phase 14 (the same "
            f"network through the v2 DSL): {lstm14['s_per_step']:.4f} s per step, "
            f"{TXT_B / lstm14['s_per_step']:.1f} reviews/s, "
            f"{TXT_B * TXT_T / lstm14['s_per_step']:.1f} tokens/s")
        say(f"v1 text lstm: LSTM steps run/skipped over the timed steps {cores['lstm_steps']}/"
            f"{cores['lstm_skipped']} ({TXT_LAYERS} layers x {TXT_T} steps x {n_timed})")
        if len(steps) != n_timed or not all(np.isfinite(costs)):
            raise SystemExit("v1: training gave a non-finite cost or a missing step")
        if cores["lstm_steps"] != TXT_LAYERS * TXT_T * n_timed:
            raise SystemExit("v1: the LSTM cores did not run every timestep")
        two = list(P.reader.firstn(batched, 2)())  # read before the window opens
        wall, busy, kernels, _ = profile_call(
            torch, lambda: trainer.train(lambda: iter(two), feeding=parsed.feeding))
        say(f"v1 text lstm profile: 2 steps in {wall:.4f} s (profiler on), device busy "
            f"{busy:.4f} s ({busy / wall:.3f} of the window), {kernels / 2:.0f} device kernels "
            f"per step")
        v1_against_v2(torch, P, trainer, parsed.feeding, two)
        del trainer, params
        torch.cuda.empty_cache()

        # token-budget bucketing over a ragged corpus through make_batched_reader
        ragged = text_reviews(np.random.RandomState(3), V1_REVIEWS, TXT_VOCAB, True)
        v1_stage(d, "ragged.pkl", ragged)
        saved = {k: P.flags.get_flag(k) for k in ("use_bucketing", "bucketing_token_budget")}
        P.flags.set_flag("use_bucketing", True)
        P.flags.set_flag("bucketing_token_budget", V1_BUDGET)
        try:
            buckets = list(v1_compat.make_batched_reader(parsed, d, st.batch_size)())
        finally:
            for k, v in saved.items():
                P.flags.set_flag(k, v)
        rungs, valid, padded, worst = {}, 0, 0, 0
        for b in buckets:
            rung = ladder_len(max(8, max(len(s[0]) for s in b)))
            rungs[rung] = rungs.get(rung, 0) + 1
            valid += sum(len(s[0]) for s in b)
            padded += rung * len(b)
            worst = max(worst, rung * len(b))
        say(f"v1 bucketing (budget {V1_BUDGET} tokens, {V1_REVIEWS} reviews of 10-100 tokens "
            f"drawn beta(2, 3)): {len(buckets)} batches, {{rung: batches}} {dict(sorted(rungs.items()))}, "
            f"largest padded batch {worst} tokens, valid share {valid / padded:.4f}")
        if sum(len(b) for b in buckets) != V1_REVIEWS or worst > V1_BUDGET:
            raise SystemExit("v1: a bucketed batch padded past the token budget or lost a review")

        # card against CPU in f32 at a small width
        vocab, width, rows = TXT_SMALL
        P.init(seed=93, compute_dtype="float32")
        small = v1_compat.parse_config(os.path.join(d, "textcls.py"),
                                       f"vocab={vocab},hidden_size={width},lstm_num=2,batch_size={rows}")
        samples = text_reviews(np.random.RandomState(2), rows, vocab, True)
        samples = [(s[0][: 5 + 7 * i], s[1]) for i, s in enumerate(samples)]
        net = P.CompiledNetwork(small.topology, compute_dtype="float32")
        from paddle_tpu_torch.core.device import tree_to

        cpu_params = net.init_params(95, device="cpu")
        got = []
        for dev in (torch.device("cuda"), torch.device("cpu")):
            batch = P.reader.DataFeeder(small.topology.data_types(), small.feeding,
                                        device=dev)(samples)
            got.append(grads_of(torch, net, tree_to(cpu_params, dev), batch))
        (c_card, g_card), (c_cpu, g_cpu) = got
        err = rel_l2(torch, g_card, g_cpu)
        say(f"v1 f32 at vocab {vocab}, width {width}, {rows} rows (lengths "
            f"{[len(s[0]) for s in samples]}): cost card {c_card:.7f} CPU {c_cpu:.7f}; gradients "
            f"relative L2 over {len(g_cpu)} leaves {err:.3e} (<= {TXT_GRAD_REL})")
        if (set(g_card) != set(g_cpu) or abs(c_card - c_cpu) > TXT_GRAD_REL * abs(c_cpu)
                or not err <= TXT_GRAD_REL):
            raise SystemExit("v1: the card's gradients of the v1-parsed network stray from the CPU's")
        phase_v1_nested_sparse(torch, P, feeder_mod, vocab, width)
        phase_v1_prune(torch, P, card)
        if launch_counts(fa) != (0, 0, 0):
            raise SystemExit("v1: the v1 path launched a flash kernel")
        P.init(compute_dtype="bfloat16")
        return {"s_per_step": mean_s}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def v1_against_v2(torch, P, trainer, feeding, batches, rounds=V1_TURNS):
    """Seconds per step of the v1-parsed trainer and of phase 14's network
    built through the v2 DSL, in turns (v2, v1, v1, v2, then v1 first) on
    the same batches: the host's clock drifts between phases, so only steps
    taken in turns compare."""
    cost, _ = text_lstm_cost(P, TXT_VOCAB, TXT_EMB, TXT_HIDDEN, TXT_LAYERS)
    v2 = P.trainer.SGD(cost, P.parameters.create(cost, seed=91),
                       P.optimizer.Adam(learning_rate=TXT_LR))
    runs = {"v2": (v2, {"word": 0, "label": 1}), "v1": (trainer, feeding)}

    def step(name, batch):
        t, feed = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train(lambda: iter([batch]), feeding=feed)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    step("v2", batches[0])  # v2's first step: allocator, handles
    times = {"v2": [], "v1": []}
    for r in range(rounds):
        order = ("v2", "v1", "v1", "v2") if r % 2 == 0 else ("v1", "v2", "v2", "v1")
        for i, name in enumerate(order):
            times[name].append(step(name, batches[(r + i) % len(batches)]))
    med = {k: float(np.median(v)) for k, v in times.items()}
    say(f"v1 against the v2 DSL in turns ({rounds} rounds, {len(times['v1'])} steps each, same "
        f"batches): median s per step v1 {med['v1']:.4f} v2 {med['v2']:.4f} (v1/v2 "
        f"{med['v1'] / med['v2']:.3f}); v1 {[round(x, 4) for x in times['v1']]}, v2 "
        f"{[round(x, 4) for x in times['v2']]}")
    del v2, runs


def _card_cpu(torch, P, out, feed, seed):
    """f32 outputs and gradients (of the sum of squares of the valid
    outputs) of `out`'s network on the card and on the CPU from the same
    parameters and samples: ((card out, grads), (CPU out, grads))."""
    from paddle_tpu_torch.core.device import tree_to
    from paddle_tpu_torch.utils.tree import leaf_paths, map_leaves

    net = P.CompiledNetwork(P.Topology(out), compute_dtype="float32")
    cpu_params = net.init_params(seed, device="cpu")
    res = []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        batch = feed(dev)
        leaves_ = map_leaves(lambda v: v.detach().requires_grad_(True), tree_to(cpu_params, dev))
        outs, _ = net.apply(leaves_, batch, train=True)
        y = outs[out.name].masked_data()
        paths = list(leaf_paths(leaves_))
        gs = torch.autograd.grad((y.float() ** 2).sum(), [v for _, v in paths])
        res.append((y.detach().cpu(), {".".join(p): g for (p, _), g in zip(paths, gs)}, batch))
    return res


def phase_v1_nested_sparse(torch, P, feeder_mod, vocab, width):
    """A nested batch through the feeder, embedding, fc and mixed, and a
    sparse_binary slot through fc's multi-hot product and its gather-sum,
    card against CPU in f32."""
    L, dt, A = P.layer, P.data_type, P.activation
    rng = np.random.RandomState(5)
    paras = [([[int(t) for t in rng.randint(0, vocab, size=rng.randint(2, 13))]
               for _ in range(rng.randint(1, 6))],) for _ in range(4)]
    words = L.data("para", dt.integer_value_sub_sequence(vocab))
    h = L.fc(L.embedding(words, size=width), size=width, act=A.Tanh())
    out = L.mixed(size=width, input=[L.full_matrix_projection(h), L.identity_projection(h)],
                  act=A.Tanh())

    def feed(dev):
        return P.reader.DataFeeder([("para", dt.integer_value_sub_sequence(vocab))],
                                   device=dev)(paras)

    (y_card, g_card, b_card), (y_cpu, g_cpu, b_cpu) = _card_cpu(torch, P, out, feed, 97)
    same = all(torch.equal(getattr(b_card["para"], k).cpu(), getattr(b_cpu["para"], k))
               for k in ("data", "lengths", "sub_lengths"))
    err_y = rel_l2(torch, {"y": y_card}, {"y": y_cpu})
    err_g = rel_l2(torch, g_card, g_cpu)
    say(f"v1 nested: 4 paragraphs of {[len(p[0]) for p in paras]} sentences of 2-12 ids, fed "
        f"{tuple(b_card['para'].data.shape)} with sub-lengths "
        f"{b_card['para'].sub_lengths.cpu().tolist()}; feeder tensors card == CPU: {same}; "
        f"fc + mixed output relative L2 {err_y:.3e}, gradients {err_g:.3e} (<= {TXT_GRAD_REL})")
    if not (same and err_y <= TXT_GRAD_REL and err_g <= TXT_GRAD_REL and y_card.dim() == 4):
        raise SystemExit("v1: the nested batch strays between the card and the CPU")

    docs = [(sorted(rng.choice(vocab, size=rng.randint(3, 20), replace=False).tolist()),)
            for _ in range(16)]
    sparse = L.data("doc", dt.sparse_binary_vector(vocab))
    sfc = L.fc(sparse, size=width, act=A.Tanh())
    outs = {}
    saved = feeder_mod.SPARSE_IDS_THRESHOLD
    for form, threshold in (("multi-hot", saved), ("padded ids", vocab // 2)):
        feeder_mod.SPARSE_IDS_THRESHOLD = threshold
        try:
            def feed_s(dev):
                return P.reader.DataFeeder([("doc", dt.sparse_binary_vector(vocab))],
                                           device=dev)(docs)

            outs[form] = _card_cpu(torch, P, sfc, feed_s, 99)
        finally:
            feeder_mod.SPARSE_IDS_THRESHOLD = saved
    for form, ((y_card, g_card, b_card), (y_cpu, g_cpu, _)) in outs.items():
        err_y = rel_l2(torch, {"y": y_card}, {"y": y_cpu})
        err_g = rel_l2(torch, g_card, g_cpu)
        say(f"v1 sparse_binary_vector({vocab}) through fc({width}), {form} "
            f"{tuple(b_card['doc'].data.shape)}: output relative L2 card vs CPU {err_y:.3e}, "
            f"gradients {err_g:.3e} (<= {TXT_GRAD_REL})")
        if not (err_y <= TXT_GRAD_REL and err_g <= TXT_GRAD_REL):
            raise SystemExit(f"v1: the sparse slot's {form} path strays between card and CPU")
    forms = rel_l2(torch, {"y": outs["padded ids"][0][0]}, {"y": outs["multi-hot"][0][0]})
    say(f"v1 sparse: gather-sum against the multi-hot product on the card: relative L2 {forms:.3e}")
    if not outs["padded ids"][0][2]["doc"].sparse_ids or forms > TXT_GRAD_REL:
        raise SystemExit("v1: the gather-sum path did not run or disagrees with the product")


def phase_v1_prune(torch, P, card):
    """The pruning hook on the card: after the steps, exactly the ratio of
    w0 is zero, at the smallest initial magnitudes."""
    n_in, n_out, ratio, n_steps = V1_PRUNE
    L, dt, A = P.layer, P.data_type, P.activation
    x = L.data("x", dt.dense_vector(n_in))
    h = L.fc(x, size=n_out, act=A.Tanh(), name="pruned",
             param_attr=P.attr.ParamAttr(update_hooks=P.attr.HookAttr("pruning", ratio)))
    cost = L.classification_cost(input=L.fc(h, size=2, act=A.Softmax()),
                                 label=L.data("y", dt.integer_value(2)))
    params = P.parameters.create(cost, seed=101)
    w_init = params.params["pruned"]["w0"].detach().clone()
    trainer = P.trainer.SGD(cost, params, P.optimizer.Momentum(learning_rate=0.01, momentum=0.9))
    rng = np.random.RandomState(7)
    data = [(rng.randn(n_in).astype(np.float32), int(rng.randint(0, 2))) for _ in range(64 * n_steps)]
    trainer.train(P.batch(lambda: iter(data), 64), feeding={"x": 0, "y": 1})
    w = trainer.parameters.params["pruned"]["w0"]
    k = int(w.numel() * (1 - ratio))
    keep = torch.zeros(w.numel(), dtype=torch.bool, device=w.device)
    keep[torch.topk(w_init.abs().reshape(-1), k).indices] = True
    zero = (w == 0).reshape(-1)
    say(f"v1 pruning: fc({n_in} -> {n_out}) with HookAttr('pruning', {ratio}) after {n_steps} "
        f"steps on {card}: zero share {zero.float().mean().item():.6f}, zeros at the smallest "
        f"initial magnitudes: {bool(torch.equal(zero, ~keep))}")
    if zero.float().mean().item() != ratio or not torch.equal(zero, ~keep):
        raise SystemExit("v1: the pruning hook did not hold on the card")


# phase 17: nested sequences.  The hierarchical RNN is the reference's
# paddle/gserver/tests/sequence_nest_rnn.conf (its flat twin
# sequence_rnn.conf) at bench_lstm_textcls's widths; the text CNN is
# v1_api_demo/quick_start/trainer_config.cnn.py with its settings
HIER_VOCAB, HIER_EMB, HIER_HIDDEN, HIER_LABELS = 30000, 128, 512, 2
HIER_SENT = (5, 25)  # sentence lengths, uniform; the last takes the remainder
HIER_STEPS = 8  # training steps of each form, taken in turns
HIER_LR = 5e-4
HIER_RTOL, HIER_ATOL = 1e-5, 1e-6  # nested == flat per row (tests/test_network_compare.py:256)
HIER_REL = 1e-5  # gradients nested vs flat, card vs CPU (relative L2)
CNN_CTX, CNN_HIDDEN, CNN_LR, CNN_L2, CNN_CLIP = 3, 512, 2e-3, 8e-4, 25.0
CNN_STEPS = 8
SMALL_REL = 1e-5


def hier_cost(P, nested, vocab=HIER_VOCAB, emb=HIER_EMB, hidden=HIER_HIDDEN,
              labels=HIER_LABELS):
    """sequence_nest_rnn.conf (nested: an outer group over the sentences
    whose step runs an inner group over the words, the inner memory booted
    from the outer one, which links the last state of the previous
    sentence) or sequence_rnn.conf (flat: one group over the words), then
    last_seq, fc(softmax) and the classification cost."""
    L, A, dt = P.layer, P.activation, P.data_type
    word_t = dt.integer_value_sub_sequence(vocab) if nested else dt.integer_value_sequence(vocab)
    emb_l = L.embedding(L.data("word", word_t), size=emb, name="emb")
    if nested:
        def outer_step(x):
            outer_mem = L.memory(name="outer_rnn_state", size=hidden)

            def inner_step(y):
                inner_mem = L.memory(name="inner_rnn_state", size=hidden, boot_layer=outer_mem)
                return L.fc([y, inner_mem], size=hidden, act=A.Tanh(), bias_attr=True,
                            name="inner_rnn_state")

            inner = L.recurrent_group(step=inner_step, name="inner", input=x)
            L.last_seq(inner, name="outer_rnn_state")
            return inner

        out = L.recurrent_group(name="outer", step=outer_step, input=L.SubsequenceInput(emb_l))
    else:
        def step(y):
            mem = L.memory(name="rnn_state", size=hidden)
            return L.fc([y, mem], size=hidden, act=A.Tanh(), bias_attr=True, name="rnn_state")

        out = L.recurrent_group(name="rnn", step=step, input=emb_l)
    prob = L.fc(L.last_seq(out), size=labels, act=A.Softmax(), bias_attr=True, name="prob")
    return L.classification_cost(input=prob, label=L.data("label", dt.integer_value(labels)))


def hier_from_flat(flat):
    """The nested network's parameter tree from the flat one's, moved by
    path (rnn.rnn_state -> outer.inner.inner_rnn_state)."""
    out = {k: v for k, v in flat.items() if k != "rnn"}
    out["outer"] = {"inner": {"inner_rnn_state": flat["rnn"]["rnn_state"]}}
    return out


def hier_name(flat_name: str) -> str:
    return flat_name.replace("rnn.rnn_state.", "outer.inner.inner_rnn_state.", 1)


def hier_reviews(rng, n, vocab=HIER_VOCAB):
    """n (sentences, words, label): TXT_T token ids each, split into
    sentences of 5-25 tokens drawn uniformly, the last taking the
    remainder."""
    out = []
    for _ in range(n):
        ids = [int(t) for t in rng.randint(2, vocab, size=TXT_T)]
        sents, i = [], 0
        while i < TXT_T:
            k = int(rng.randint(HIER_SENT[0], HIER_SENT[1] + 1))
            sents.append(ids[i:i + k])
            i += k
        out.append((sents, ids, int(rng.randint(0, 2))))
    return out


def count_syncs(torch, fn) -> list:
    """The host synchronisations `fn()` makes (a device value read, a
    synchronous copy either way, a stream wait), as torch.cuda's sync debug
    mode reports them: one "file:line" per sync, the innermost frame of
    this repository's code that made it."""
    import traceback
    import warnings

    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(HERE)]
        sites.append(f"{os.path.relpath(frames[-1].filename, HERE)}:{frames[-1].lineno}"
                     if frames else "outside the repository")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def phase_hier(torch, P, fa, card):
    """Phase 17a: the hierarchical RNN against its flat twin at full width:
    f32 checks on the card (costs per row, gradients) and card vs CPU, then
    bf16 training of both forms in turns."""
    from paddle_tpu_torch.core.device import tree_to
    from paddle_tpu_torch.layers.recurrent_group import counters as groups
    from paddle_tpu_torch.utils.tree import leaves, map_leaves

    feeding = {"word": 0, "label": 1}
    P.init(seed=111, compute_dtype="float32")
    nested, flat = hier_cost(P, True), hier_cost(P, False)
    nets = {"nested": P.CompiledNetwork(P.Topology(nested), compute_dtype="float32"),
            "flat": P.CompiledNetwork(P.Topology(flat), compute_dtype="float32")}
    flat_cpu = nets["flat"].init_params(113, device="cpu")
    params_cpu = {"flat": flat_cpu, "nested": hier_from_flat(flat_cpu)}
    # batches: the first, HIER_STEPS timed, one for the sync count and profile
    rows = hier_reviews(np.random.RandomState(0), TXT_B * (2 + HIER_STEPS))
    samples = {"nested": [(r[0], r[2]) for r in rows], "flat": [(r[1], r[2]) for r in rows]}

    def feed(form, dev, lo=0, n=TXT_B):
        return P.reader.DataFeeder(nets[form].topology.data_types(), feeding,
                                   device=dev)(samples[form][lo:lo + n])

    nb = feed("nested", torch.device("cuda"))
    n_sub = nb["word"].lengths.cpu()
    say(f"hier: {TXT_B} reviews of {TXT_T} tokens in {int(n_sub.min())}-{int(n_sub.max())} "
        f"sentences of {HIER_SENT[0]}-{HIER_SENT[1]} tokens; the nested batch pads to "
        f"{tuple(nb['word'].data.shape)}, the flat one to "
        f"{tuple(feed('flat', torch.device('cuda'))['word'].data.shape)}")
    res = {}
    for side, dev in (("card", torch.device("cuda")), ("cpu", torch.device("cpu"))):
        for form in ("nested", "flat"):
            batch = feed(form, dev)
            prm = tree_to(params_cpu[form], dev)
            cost_rows = nets[form].apply(prm, batch, train=False)[0][
                (nested if form == "nested" else flat).name].data.detach()
            mean, grads = grads_of(torch, nets[form], prm, batch)
            if form == "flat":
                grads = {hier_name(k): v for k, v in grads.items()}
            res[(side, form)] = (cost_rows.cpu(), mean, grads)
    cn, cf = res[("card", "nested")][0], res[("card", "flat")][0]
    worst = float((cn - cf).abs().max())
    g_nf = rel_l2(torch, res[("card", "nested")][2], res[("card", "flat")][2])
    c_cc = float(((cn - res[("cpu", "nested")][0]).abs() / res[("cpu", "nested")][0].abs()).max())
    g_cc = rel_l2(torch, res[("card", "nested")][2], res[("cpu", "nested")][2])
    say(f"hier f32 on {card}: cost per row nested vs flat worst |d| {worst:.3e} (rtol "
        f"{HIER_RTOL}, atol {HIER_ATOL}); mean cost nested {res[('card', 'nested')][1]:.7f} flat "
        f"{res[('card', 'flat')][1]:.7f}; gradients nested vs flat relative L2 over "
        f"{len(res[('card', 'flat')][2])} leaves {g_nf:.3e} (<= {HIER_REL}); card vs CPU "
        f"(nested): cost per row worst relative {c_cc:.3e}, gradients {g_cc:.3e} (<= {HIER_REL})")
    if not torch.allclose(cn, cf, rtol=HIER_RTOL, atol=HIER_ATOL):
        raise SystemExit("hier: the nested cost strays from the flat one on the card")
    if not (g_nf <= HIER_REL and c_cc <= HIER_REL and g_cc <= HIER_REL):
        raise SystemExit("hier: gradients or the card-vs-CPU check strayed")
    del res
    torch.cuda.empty_cache()

    # bf16 training of both forms in turns, from the same parameters
    P.init(compute_dtype="bfloat16")
    pf = P.parameters.create(flat, seed=113)
    pn = P.parameters.create(nested, seed=113)
    pn.params = hier_from_flat(map_leaves(lambda v: v.detach().clone(), pf.params))
    trainers = {form: P.trainer.SGD(c, p, P.optimizer.Adam(learning_rate=HIER_LR))
                for form, c, p in (("nested", nested, pn), ("flat", flat, pf))}
    say(f"hier: {sum(v.numel() for v in leaves(pf.params))} parameters in each form; bf16 over "
        f"f32 masters, Adam({HIER_LR})")

    def step(form, k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = []
        trainers[form].train(lambda: iter([samples[form][k * TXT_B:(k + 1) * TXT_B]]),
                             feeding=feeding, event_handler=lambda e: got.append(e.cost)
                             if isinstance(e, P.event.EndIteration) else None)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, got[0]

    for form in ("nested", "flat"):
        step(form, 0)  # first step: allocator, handles
    times = {"nested": [], "flat": []}
    costs = {"nested": [], "flat": []}
    for r in range(HIER_STEPS // 2):
        order = ("nested", "flat", "flat", "nested") if r % 2 == 0 else (
            "flat", "nested", "nested", "flat")
        for form in order:
            k = 1 + len(times[form])
            secs, cost = step(form, k)
            times[form].append(secs)
            costs[form].append(cost)
    med = {f: float(np.median(v)) for f, v in times.items()}
    say(f"hier training in turns on {card} ({HIER_STEPS} steps each, the same batches): median "
        f"s per step nested {med['nested']:.4f} flat {med['flat']:.4f} (nested/flat "
        f"{med['nested'] / med['flat']:.3f}); reviews/s nested {TXT_B / med['nested']:.1f} flat "
        f"{TXT_B / med['flat']:.1f}; nested {[round(x, 4) for x in times['nested']]}, flat "
        f"{[round(x, 4) for x in times['flat']]}")
    d_cost = max(abs(a - b) for a, b in zip(costs["nested"], costs["flat"]))
    say(f"hier training costs: nested {[round(c, 4) for c in costs['nested']]}, flat "
        f"{[round(c, 4) for c in costs['flat']]} (worst |d| {d_cost:.4f}, bf16)")
    if not (np.isfinite(costs["nested"]).all() and np.isfinite(costs["flat"]).all()):
        raise SystemExit("hier: training gave a non-finite cost")
    if d_cost > 0.1 * max(abs(c) for c in costs["flat"]):
        raise SystemExit("hier: the nested form trains away from the flat one")

    # one step of each form: syncs, steps run and skipped, peak memory
    for form in ("nested", "flat"):
        k = 1 + HIER_STEPS
        groups.clear()
        torch.cuda.reset_peak_memory_stats()
        sites = count_syncs(torch, lambda f=form, kk=k: step(f, kk))
        syncs = len(sites)
        peak = torch.cuda.max_memory_allocated() / 2**30
        loops = groups.copy()
        rb = feed(form, torch.device("cpu"), k * TXT_B)["word"]
        wall, busy, kernels, top = profile_call(torch, lambda f=form, kk=k: step(f, kk))
        by_site = {x: sites.count(x) for x in sorted(set(sites))}
        say(f"hier {form} step on {card}: {syncs} host syncs by site {by_site}, peak memory {peak:.2f} GiB, {kernels:.0f} device kernels, device busy "
            f"{busy:.4f} s of {wall:.4f} s ({busy / wall:.3f}; {busy / med[form]:.3f} of the "
            f"median step); group loop steps run/skipped {loops['steps']}/{loops['skipped']}, "
            f"outer {loops['outer_steps']}/{loops['outer_skipped']}, inner "
            f"{loops['inner_steps']}/{loops['inner_skipped']} (batch padded to "
            f"{tuple(rb.data.shape)}); top device kernels:")
        for line in top[:4]:
            say(f"  {line}")
        if form == "nested":
            sub = rb.sub_lengths.numpy()
            want_inner = sum(int(sub[:, s].max()) for s in range(int(rb.lengths.max())))
            if (loops["outer_steps"] != int(rb.lengths.max())
                    or loops["inner_steps"] != want_inner):
                raise SystemExit("hier: the loops did not run exactly the live steps")
        else:
            if loops["steps"] != TXT_T or loops["outer_steps"] or loops["inner_steps"]:
                raise SystemExit("hier: the flat loop did not run its 100 steps")
        # a sync inside the layers or the loops would come once per (outer)
        # step: the host copies of the lengths must spare every one
        inside = [x for x in sites if x.startswith(("paddle_tpu_torch/layers/",
                                                    "paddle_tpu_torch/ops/"))]
        if inside:
            raise SystemExit(f"hier: the {form} step reads the device inside its layers: {inside}")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("hier: the nested path launched a flash kernel")
    del trainers, pf, pn
    torch.cuda.empty_cache()
    return med


def text_cnn_cost(P, vocab=TXT_VOCAB):
    """quick_start's trainer_config.cnn.py: embedding 128,
    sequence_conv_pool(context_len=3, hidden_size=512), fc(2, softmax),
    classification cost.  Returns (cost, probabilities)."""
    L = P.layer
    emb = L.embedding(L.data("word", P.data_type.integer_value_sequence(vocab)), size=TXT_EMB)
    conv = P.networks.sequence_conv_pool(input=emb, context_len=CNN_CTX, hidden_size=CNN_HIDDEN)
    probs = L.fc(conv, size=2, act=P.activation.Softmax())
    label = L.data("label", P.data_type.integer_value(2))
    return L.classification_cost(input=probs, label=label), probs


def phase_text_cnn(torch, P, fa, card):
    """Phase 17b: the quick_start text CNN on phase 14's batches, bf16
    training and its profile; card vs CPU in f32."""
    from paddle_tpu_torch.core.device import tree_to

    feeding = {"word": 0, "label": 1}
    reviews = text_reviews(np.random.RandomState(0), TXT_B * (1 + CNN_STEPS), TXT_VOCAB, False)
    batches = [reviews[i * TXT_B:(i + 1) * TXT_B] for i in range(1 + CNN_STEPS)]
    P.init(seed=121, compute_dtype="float32")
    cost, _ = text_cnn_cost(P)
    net = P.CompiledNetwork(P.Topology(cost), compute_dtype="float32")
    cpu_params = net.init_params(123, device="cpu")
    got = []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        batch = P.reader.DataFeeder(net.topology.data_types(), feeding, device=dev)(batches[0])
        got.append(grads_of(torch, net, tree_to(cpu_params, dev), batch))
    (c_card, g_card), (c_cpu, g_cpu) = got
    err = rel_l2(torch, g_card, g_cpu)
    say(f"text cnn f32 at full width ({TXT_B} x {TXT_T}): cost card {c_card:.7f} CPU "
        f"{c_cpu:.7f}; gradients relative L2 over {len(g_cpu)} leaves {err:.3e} (<= {HIER_REL})")
    if abs(c_card - c_cpu) > HIER_REL * abs(c_cpu) or not err <= HIER_REL:
        raise SystemExit("text cnn: the card strays from the CPU")

    P.init(compute_dtype="bfloat16")
    params = P.parameters.create(cost, seed=123)
    opt = P.optimizer.Adam(learning_rate=CNN_LR,
                           regularization=P.optimizer.L2Regularization(CNN_L2),
                           gradient_clipping_threshold=CNN_CLIP)
    trainer = P.trainer.SGD(cost, params, opt)
    trainer.train(lambda: iter(batches[:1]), feeding=feeding)  # first step
    steps, clock = [], [0.0]

    def on_event(e):
        if isinstance(e, P.event.BeginIteration):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
        elif isinstance(e, P.event.EndIteration):
            steps.append((time.perf_counter() - clock[0], e.cost))

    trainer.train(lambda: iter(batches[1:]), feeding=feeding, event_handler=on_event)
    secs, costs = [x[0] for x in steps], [x[1] for x in steps]
    mean_s = float(np.mean(secs))
    wall, busy, kernels, top = profile_call(
        torch, lambda: trainer.train(lambda: iter(batches[1:3]), feeding=feeding))
    say(f"text cnn on {card}: {len(steps)} steps, costs {[round(c, 4) for c in costs]}, s per "
        f"step {[round(x, 4) for x in secs]}; {mean_s:.4f} s per step, {TXT_B / mean_s:.1f} "
        f"reviews/s; profile 2 steps: device busy {busy:.4f} s of {wall:.4f} s "
        f"({busy / wall:.3f}), {kernels / 2:.0f} device kernels per step; top:")
    for line in top[:4]:
        say(f"  {line}")
    if len(steps) != CNN_STEPS or not np.isfinite(costs).all():
        raise SystemExit("text cnn: training gave a non-finite cost or a missing step")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("text cnn: the path launched a flash kernel")
    del trainer, params
    torch.cuda.empty_cache()
    return mean_s


def small_card_cpu(torch, P, out, types, samples, seed, state=None, dev=None):
    """f32 outputs of `out`'s network on the card (`dev`) and on the CPU
    from the same parameters, layer state (a CPU tree, else none) and
    samples, and for a float output the gradients of the sum of squares of
    its valid part with respect to the parameters and the float slots:
    (output |d| or relative L2, gradient relative L2 or None)."""
    params = P.CompiledNetwork(P.Topology(out)).init_params(seed, device="cpu")
    (y_card, g_card), (y_cpu, g_cpu) = (
        values_and_grads(torch, P, out, types, samples, params, d, torch.float32, state)
        for d in (dev or torch.device("cuda"), torch.device("cpu")))
    if not y_cpu.is_floating_point() or not g_cpu:
        return float((y_card != y_cpu).sum()), None
    return rel_l2(torch, {"y": y_card}, {"y": y_cpu}), rel_l2(torch, g_card, g_cpu)


def values_and_grads(torch, P, out, types, samples, params, dev, dtype, state=None):
    """`out`'s output (its valid part) on `samples` in `dtype` on `dev` from
    the CPU trees `params` and `state`, and for a float output the
    gradients of its sum of squares with respect to the parameters and the
    float slots, on the CPU."""
    from paddle_tpu_torch.core.device import tree_to
    from paddle_tpu_torch.utils.tree import leaf_paths, map_leaves

    net = P.CompiledNetwork(P.Topology(out), compute_dtype="float32")
    batch = P.reader.DataFeeder(types, device=dev)(samples)
    xs = {}
    for k, t in batch.items():
        if t.data.is_floating_point():
            t.data = t.data.detach().to(dtype).requires_grad_(True)
            xs[k] = t.data
    prm = map_leaves(lambda v: v.detach().to(dtype).requires_grad_(True), tree_to(params, dev))
    st = None if state is None else tree_to(state, dev)
    y = net.apply(prm, batch, state=st, train=False)[0][out.name]
    data = y.masked_data() if y.is_seq else y.data
    wrt = [(".".join(p), v) for p, v in leaf_paths(prm)] + list(xs.items())
    grads = {}
    if data.is_floating_point() and wrt and data.requires_grad:
        gs = torch.autograd.grad((data ** 2).sum(), [v for _, v in wrt], allow_unused=True)
        grads = {n: g.detach().cpu() for (n, _), g in zip(wrt, gs) if g is not None}
    return data.detach().cpu(), grads


def phase_sequence_small(torch, P, card):
    """Phase 17c: each of the slice's 13 types, nested and stride pooling
    and a sequence memory's running sum, card vs CPU in f32; sampling_id's
    frequencies on the card."""
    L, A, dt = P.layer, P.activation, P.data_type
    rng = np.random.RandomState(17)

    def vecs(n, d):
        return [rng.randn(d).astype(np.float32).tolist() for _ in range(n)]

    def seqs(d, lens):
        return [vecs(n, d) for n in lens]

    def nested(d, shape):
        return [[vecs(n, d) for n in sub] for sub in shape]

    lens = [5, 2, 7, 1]
    shape = [[3, 1], [4, 4, 2], [1], [2, 5]]
    P.init(seed=125, compute_dtype="float32")
    ds = lambda n, d: L.data(n, dt.dense_vector_sequence(d))  # noqa: E731
    st = P.core.topology
    s4 = ds("s", 4)
    cases = [
        ("seqreshape", L.seq_reshape(ds("s", 4), reshape_size=8), [("s", dt.dense_vector_sequence(4))],
         [(x,) for x in seqs(4, lens)]),
        ("seqconcat", L.seq_concat(ds("a", 4), ds("b", 4)),
         [("a", dt.dense_vector_sequence(4)), ("b", dt.dense_vector_sequence(4))],
         list(zip(seqs(4, lens), seqs(4, lens[::-1])))),
        ("context_projection(start -1)", L.mixed(size=12, input=L.context_projection(
            ds("s", 4), context_len=3, context_start=-1)), [("s", dt.dense_vector_sequence(4))],
         [(x,) for x in seqs(4, lens)]),
        ("context_projection(start +1)", L.mixed(size=12, input=L.context_projection(
            ds("s", 4), context_len=3, context_start=1)), [("s", dt.dense_vector_sequence(4))],
         [(x,) for x in seqs(4, lens)]),
        ("row_conv", L.row_conv(ds("s", 4), context_len=3), [("s", dt.dense_vector_sequence(4))],
         [(x,) for x in seqs(4, lens)]),
        ("conv_shift", L.conv_shift(L.data("a", dt.dense_vector(8)), L.data("b", dt.dense_vector(3))),
         [("a", dt.dense_vector(8)), ("b", dt.dense_vector(3))], list(zip(vecs(4, 8), vecs(4, 3)))),
        ("slice_time", st.LayerOutput(st.LayerConf(
            name="st", type="slice_time", size=4, inputs=(s4.name,), act="identity", bias=False,
            attrs={"offset": 1}), [s4]), [("s", dt.dense_vector_sequence(4))],
         [(x,) for x in seqs(4, [3, 2, 4, 2])]),
        ("sub_seq", L.sub_seq(ds("s", 3), L.data("off", dt.integer_value(8)),
                              L.data("sz", dt.integer_value(8))),
         [("s", dt.dense_vector_sequence(3)), ("off", dt.integer_value(8)),
          ("sz", dt.integer_value(8))], [(x, 1, 2) for x in seqs(3, [5, 4, 7, 3])]),
        ("agent", L.agent(L.fc(ds("s", 4), size=5)), [("s", dt.dense_vector_sequence(4))],
         [(x,) for x in seqs(4, lens)]),
        ("scatter_agent", L.scatter_agent(L.fc(ds("s", 4), size=5), L.data("ids", dt.integer_value(4))),
         [("s", dt.dense_vector_sequence(4)), ("ids", dt.integer_value(4))],
         [(x, i) for x, i in zip(seqs(4, lens), [3, 0, 0, 2])]),
        ("gather_agent", L.gather_agent([ds("a", 4), ds("b", 4)]),
         [("a", dt.dense_vector_sequence(4)), ("b", dt.dense_vector_sequence(4))],
         list(zip(seqs(4, lens), seqs(4, lens)))),
        ("eos_id", L.eos(L.data("ids", dt.integer_value_sequence(6)), 2),
         [("ids", dt.integer_value_sequence(6))],
         [([int(t) for t in rng.randint(0, 6, size=n)],) for n in lens]),
        ("kmax_seq_score", L.kmax_seq_score(L.fc(ds("s", 4), size=1), beam_size=2),
         [("s", dt.dense_vector_sequence(4))], [(x,) for x in seqs(4, lens)]),
        ("sampling_id (no seed: argmax)", L.sampling_id(L.fc(L.data("x", dt.dense_vector(6)), size=5,
                                                             act=A.Softmax())),
         [("x", dt.dense_vector(6))], [(x,) for x in vecs(8, 6)]),
        ("seqpool nested TO_SEQUENCE", L.pooling(
            L.data("n", dt.dense_vector_sub_sequence(4)), pooling_type=P.pooling.Max(),
            agg_level=L.AggregateLevel.TO_SEQUENCE), [("n", dt.dense_vector_sub_sequence(4))],
         [(x,) for x in nested(4, shape)]),
        ("seqpool nested TO_NO_SEQUENCE", L.pooling(
            L.data("n", dt.dense_vector_sub_sequence(4)), pooling_type=P.pooling.Avg()),
         [("n", dt.dense_vector_sub_sequence(4))], [(x,) for x in nested(4, shape)]),
        ("last_seq nested TO_SEQUENCE", L.last_seq(L.data("n", dt.dense_vector_sub_sequence(4)),
                                                   agg_level=L.AggregateLevel.TO_SEQUENCE),
         [("n", dt.dense_vector_sub_sequence(4))], [(x,) for x in nested(4, shape)]),
        ("seqpool stride 2", L.pooling(ds("s", 4), pooling_type=P.pooling.Sum(), stride=2),
         [("s", dt.dense_vector_sequence(4))], [(x,) for x in seqs(4, lens)]),
        ("first_seq stride 3", L.first_seq(ds("s", 4), stride=3),
         [("s", dt.dense_vector_sequence(4))], [(x,) for x in seqs(4, lens)]),
    ]

    def running_sum(sub):
        prev = L.memory(name="acc", size=4, is_seq=True)
        return L.addto([L.fc(sub, size=4, act=A.Tanh()), prev], name="acc")

    cases.append(("memory(is_seq=True) running sum", L.recurrent_group(
        step=running_sum, input=L.SubsequenceInput(L.data("n", dt.dense_vector_sub_sequence(4)))),
        [("n", dt.dense_vector_sub_sequence(4))], [(x,) for x in nested(4, shape)]))
    worst = 0.0
    for k, (name, out, types, samples) in enumerate(cases):
        err_y, err_g = small_card_cpu(torch, P, out, types, samples, 127 + k)
        kind = "values off" if err_g is None else "relative L2"
        say(f"seq small f32 on {card}: {name}: output card vs CPU {kind} {err_y:.3e}"
            + ("" if err_g is None else f", gradients {err_g:.3e}") + f" (<= {SMALL_REL})")
        worst = max(worst, err_y, err_g or 0.0)
        if err_y > (0 if err_g is None else SMALL_REL) or (err_g or 0.0) > SMALL_REL:
            raise SystemExit(f"seq small: {name} strays between the card and the CPU")

    # sampling_id with a step seed: 20,000 draws from one distribution
    out = L.sampling_id(L.data("p", dt.dense_vector(4)))
    p = torch.tensor([[0.1, 0.2, 0.3, 0.4]], device="cuda").expand(20000, 4).contiguous()
    net = P.CompiledNetwork(P.Topology(out), compute_dtype="float32")
    ids = net.apply({}, {"p": P.core.batch.SeqTensor(p)}, train=True, rng=5)[0][out.name].data
    freq = torch.bincount(ids.long(), minlength=4).double().cpu() / 20000
    say(f"seq small: sampling_id on {card}, 20,000 draws of [0.1, 0.2, 0.3, 0.4]: frequencies "
        f"{[round(x, 4) for x in freq.tolist()]} (within 0.02)")
    if not torch.allclose(freq, p[0].double().cpu(), atol=0.02):
        raise SystemExit("seq small: sampling_id's draws do not follow the distribution")
    return worst


def phase_nested(torch, P, fa, card):
    """Phase 17: the hierarchical RNN and its flat twin, the quick_start
    text CNN, and the slice's layer types card vs CPU."""
    reset_counts(fa)
    t0 = time.perf_counter()
    med = phase_hier(torch, P, fa, card)
    t1 = time.perf_counter()
    cnn_s = phase_text_cnn(torch, P, fa, card)
    t2 = time.perf_counter()
    phase_sequence_small(torch, P, card)
    t3 = time.perf_counter()
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("nested: phase 17 launched a flash kernel")
    say(f"nested: phase 17 split: hierarchical RNN {t1 - t0:.1f} s, text CNN {t2 - t1:.1f} s, "
        f"small checks {t3 - t2:.1f} s; flash launches (fwd, dq, dkv) over it "
        f"{launch_counts(fa)}; nested/flat {med['nested'] / med['flat']:.3f}, text cnn "
        f"{cnn_s:.4f} s per step")
    P.init(compute_dtype="bfloat16")


# phase 18: the word2vec N-gram language model (the PaddlePaddle book's
# word2vec chapter) through three output heads, RankNet and LambdaRank (the
# ltr example of PaddlePaddle's models repository over MQ2007), and every
# cost, sampled-output and elementwise type card vs CPU
NGRAM_VOCAB = 10000  # the PTB vocabulary imikolov ships
NGRAM_CTX, NGRAM_EMB, NGRAM_HIDDEN = 4, 32, 256
NGRAM_B = 256  # five-word windows per batch
NGRAM_STEPS = 8  # bf16 steps of each head, taken in turns
NGRAM_LR = 2e-3
NGRAM_ZIPF = 1.0  # word frequency ~ rank^-s, as in natural text
NGRAM_FEEDING = {"w0": 0, "w1": 1, "w2": 2, "w3": 3, "next": 4}
SAMPLER_DRAWS = (20000, 10)  # nce's sampler on the card: 200,000 draws
SAMPLER_TOL = 0.005  # about 10 sigma at these counts
LTR_DIM = 46  # MQ2007's features per document
LTR_DOCS = (8, 64)  # documents per query list
LTR_PAIRS = 256  # RankNet pairs per batch
LTR_LISTS = 32  # LambdaRank query lists per batch
LTR_STEPS = 8
LTR_LR = 1e-3
LTR_NDCG = 6
CARD_REL = 1e-5  # card vs CPU in f32: costs (relative) and gradients (relative L2)


def zipf(n, s=NGRAM_ZIPF):
    p = 1.0 / np.arange(1, n + 1) ** s
    return p / p.sum()


def ngram_stream(rng, n, vocab=NGRAM_VOCAB):
    """n word ids of a first-order Markov chain, as dataset/imikolov.py's
    synthetic corpus draws it (each word goes on to one of 4 fixed
    successors with probability 0.85, else to any word), with successors
    and jumps drawn by Zipf frequency so the ids follow a natural text's
    rank-frequency law."""
    p = zipf(vocab)
    succ = rng.choice(vocab, size=(vocab, 4), p=p)
    jump = rng.choice(vocab, size=n, p=p)
    stay = rng.rand(n) < 0.85
    pick = rng.randint(4, size=n)
    out = np.empty(n, np.int64)
    w = int(jump[0])
    for i in range(n):
        w = int(succ[w, pick[i]]) if stay[i] else int(jump[i])
        out[i] = w
    return out


def ngram_cost(P, head, dist=None):
    """The book's N-gram model: NGRAM_CTX context words through one shared
    embedding ("_proj"), concat, fc(NGRAM_HIDDEN, sigmoid), then the head:
    fc(softmax) with classification_cost, hsigmoid, or nce (10 negative
    samples from `dist`, uniform when None)."""
    L, A, dt = P.layer, P.activation, P.data_type
    words = [L.data(f"w{i}", dt.integer_value(NGRAM_VOCAB)) for i in range(NGRAM_CTX)]
    nxt = L.data("next", dt.integer_value(NGRAM_VOCAB))
    embs = [L.embedding(w, size=NGRAM_EMB, param_attr=P.attr.ParamAttr(name="_proj"))
            for w in words]
    hidden = L.fc(L.concat(embs), size=NGRAM_HIDDEN, act=A.Sigmoid())
    if head == "softmax":
        return L.classification_cost(L.fc(hidden, size=NGRAM_VOCAB, act=A.Softmax()), nxt)
    if head == "hsigmoid":
        return L.hsigmoid(hidden, nxt, num_classes=NGRAM_VOCAB)
    return L.nce(hidden, nxt, num_classes=NGRAM_VOCAB,
                 neg_distribution=None if dist is None else [float(x) for x in dist])


def card_cpu_grads(torch, P, cost, feeding, samples, seed, dev):
    """f32 mean cost and gradients of `cost`'s network on `samples`, on
    `dev` and on the CPU from the same parameters: (cost on dev, cost on
    the CPU, relative L2 of the gradients, leaves)."""
    from paddle_tpu_torch.core.device import tree_to

    net = P.CompiledNetwork(P.Topology(cost), compute_dtype="float32")
    cpu_params = net.init_params(seed, device="cpu")
    got = []
    for d in (dev, torch.device("cpu")):
        batch = P.reader.DataFeeder(net.topology.data_types(), feeding, device=d)(samples)
        got.append(grads_of(torch, net, tree_to(cpu_params, d), batch))
    (c_dev, g_dev), (c_cpu, g_cpu) = got
    return c_dev, c_cpu, rel_l2(torch, g_dev, g_cpu), len(g_cpu)


# one step's gradients of a whole network, card against CPU: in f64 the
# two evaluate the same function within rounding of 1e-16, so they must
# agree to GRAD_F64_REL; in f32 each lies from f64 by its own summation
# order (cuDNN's f32 weight gradients over 180,000-term reductions sit ~2x
# further than the CPU's on SSD300), held to the f32 envelope GRAD_F32_REL
GRAD_F64_REL = 1e-9
GRAD_F32_REL = 1e-3


def grads_four_ways(torch, P, net, params, feeding, samples, dev):
    """{where: (mean cost, {leaf: gradient})} of `net`'s mean cost on
    `samples` from the tree `params`, in f32 and in f64 on `dev` and on the
    CPU."""
    got = {}
    for where, d, dtype in (("card f32", dev, torch.float32),
                            ("CPU f32", torch.device("cpu"), torch.float32),
                            ("card f64", dev, torch.float64),
                            ("CPU f64", torch.device("cpu"), torch.float64)):
        batch = P.reader.DataFeeder(net.topology.data_types(), feeding, device=d)(samples)
        batch = {k: v.with_data(v.data.to(dtype)) if v.data.is_floating_point() else v
                 for k, v in batch.items()}
        cast = lambda tree: {l: {k: v.to(d, dtype) for k, v in p.items()}  # noqa: E731
                             for l, p in tree.items()}
        got[where] = grads_of(torch, net, cast(params), batch)
    return got


def judge_four_ways(torch, got, name):
    """Print and check grads_four_ways' result: the f64 card against the f64
    CPU (costs relative, gradients relative L2 over every leaf, the leaves
    equal) within GRAD_F64_REL, the f32 card against the f64 CPU within
    GRAD_F32_REL beside the f32 CPU's own distance, and the worst f32 leaf."""
    ref = got["CPU f64"]
    rel = lambda w: (abs(got[w][0] - ref[0]) / abs(ref[0]),  # noqa: E731
                     rel_l2(torch, got[w][1], ref[1]))
    f64, f32, cpu32 = rel("card f64"), rel("card f32"), rel("CPU f32")
    live = [n for n, g in ref[1].items() if g.abs().max() > 0]
    per_leaf = {n: tuple(rel_l2(torch, {n: got[w][1][n]}, {n: ref[1][n]})
                         for w in ("card f32", "CPU f32")) for n in live}
    worst = max(per_leaf, key=lambda n: per_leaf[n][0])
    say(f"{name}: costs card f32 {got['card f32'][0]:.9f}, CPU f32 {got['CPU f32'][0]:.9f}, "
        f"card f64 {got['card f64'][0]:.12f}, CPU f64 {ref[0]:.12f}; f64 card vs CPU: cost "
        f"{f64[0]:.3e}, gradients {f64[1]:.3e} over {len(ref[1])} leaves (<= {GRAD_F64_REL}); "
        f"f32 from f64: card {f32[1]:.3e} (<= {GRAD_F32_REL}), CPU {cpu32[1]:.3e}, card vs CPU "
        f"f32 {rel_l2(torch, got['card f32'][1], got['CPU f32'][1]):.3e}; the f32 leaf "
        f"furthest from f64 {worst}: card {per_leaf[worst][0]:.3e}, CPU {per_leaf[worst][1]:.3e}; "
        f"{len(ref[1]) - len(live)} leaves with a zero gradient")
    if (any(set(got[w][1]) != set(ref[1]) for w in got) or not max(f64) <= GRAD_F64_REL
            or not max(f32) <= GRAD_F32_REL):
        raise SystemExit(f"{name}: the card's cost or gradients stray from the CPU's")


def one_step(torch, P, trainer, feeding, samples):
    """(seconds, cost) of one trainer step on `samples`, synchronised."""
    got = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(lambda: iter([samples]), feeding=feeding,
                  event_handler=lambda e: got.append(e.cost)
                  if isinstance(e, P.event.EndIteration) else None)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, got[0]


def step_report(torch, P, trainer, feeding, samples, name, card, med):
    """One step's host syncs by file:line (none may come from the layers)
    and peak memory, and a profile of one more step: device kernels and
    the busy share."""
    torch.cuda.reset_peak_memory_stats()
    sites = count_syncs(torch, lambda: one_step(torch, P, trainer, feeding, samples[0]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall, busy, kernels, top = profile_call(
        torch, lambda: one_step(torch, P, trainer, feeding, samples[1]))
    by_site = {x: sites.count(x) for x in sorted(set(sites))}
    say(f"{name} step on {card}: {len(sites)} host syncs by site {by_site}, peak memory "
        f"{peak:.3f} GiB, {kernels:.0f} device kernels, device busy {busy:.4f} s of "
        f"{wall:.4f} s ({busy / wall:.3f}; {busy / med:.3f} of the median step); top:")
    for line in top[:3]:
        say(f"  {line}")
    inside = [x for x in sites if x.startswith("paddle_tpu_torch/layers/")]
    if inside:
        raise SystemExit(f"{name}: the step reads the device inside its layers: {inside}")


def phase_ngram(torch, P, card, dev):
    """Phase 18a: the N-gram LM at full width through each head: f32 card
    vs CPU, then bf16 training of the four heads in turns."""
    from paddle_tpu_torch.utils.tree import leaves

    per_head = 2 + NGRAM_STEPS + 2  # first step, timed steps, syncs, profile
    n_batches = 1 + per_head * 4
    stream = ngram_stream(np.random.RandomState(0), NGRAM_B * n_batches + NGRAM_CTX)
    win = np.lib.stride_tricks.sliding_window_view(stream, NGRAM_CTX + 1)
    batches = [[tuple(int(v) for v in row) for row in win[i * NGRAM_B:(i + 1) * NGRAM_B]]
               for i in range(n_batches)]
    say(f"ngram: {NGRAM_CTX} context words, embedding {NGRAM_EMB}, hidden {NGRAM_HIDDEN}, "
        f"dictionary {NGRAM_VOCAB}; {n_batches} batches of {NGRAM_B} windows from a Markov "
        f"stream of Zipf({NGRAM_ZIPF}) ids ({len(set(stream.tolist()))} distinct ids)")

    P.init(seed=181, compute_dtype="float32")
    one_hot = np.zeros(NGRAM_VOCAB)
    one_hot[1] = 1.0
    for head, dist in (("softmax", None), ("hsigmoid", None), ("nce", one_hot)):
        c_dev, c_cpu, err, n = card_cpu_grads(torch, P, ngram_cost(P, head, dist),
                                              NGRAM_FEEDING, batches[0], 183, dev)
        c_err = abs(c_dev - c_cpu) / abs(c_cpu)
        say(f"ngram {head} f32 on {card}: cost card {c_dev:.7f} CPU {c_cpu:.7f} (relative "
            f"{c_err:.3e}), gradients relative L2 over {n} leaves {err:.3e} (<= {CARD_REL})"
            + ("; one-hot neg_distribution, both draw the same ids" if dist is not None
               else ""))
        if not (c_err <= CARD_REL and err <= CARD_REL):
            raise SystemExit(f"ngram: the {head} head strays between the card and the CPU")

    P.init(compute_dtype="bfloat16")
    heads = {"softmax": ngram_cost(P, "softmax"), "hsigmoid": ngram_cost(P, "hsigmoid"),
             "nce uniform": ngram_cost(P, "nce"),
             "nce zipf": ngram_cost(P, "nce", zipf(NGRAM_VOCAB))}
    trainers = {h: P.trainer.SGD(c, P.parameters.create(c, seed=185),
                                 P.optimizer.Adam(learning_rate=NGRAM_LR))
                for h, c in heads.items()}
    say(f"ngram training: bf16 over f32 masters, Adam({NGRAM_LR}), {NGRAM_STEPS} steps of "
        f"each head in turns; parameters: "
        + ", ".join(f"{h} {sum(v.numel() for v in leaves(t.parameters.params))}"
                    for h, t in trainers.items()))
    names = list(heads)
    cursor = {h: 1 + k * per_head for k, h in enumerate(names)}

    def take(h):
        cursor[h] += 1
        return batches[cursor[h] - 1]

    for h in names:
        one_step(torch, P, trainers[h], NGRAM_FEEDING, take(h))  # first step: allocator
    times = {h: [] for h in names}
    costs = {h: [] for h in names}
    for r in range(NGRAM_STEPS):
        for h in (names if r % 2 == 0 else names[::-1]):
            secs, cost = one_step(torch, P, trainers[h], NGRAM_FEEDING, take(h))
            times[h].append(secs)
            costs[h].append(cost)
    med = {h: float(np.median(v)) for h, v in times.items()}
    for h in names:
        say(f"ngram {h} on {card}: median {med[h]:.4f} s per step, "
            f"{NGRAM_B / med[h]:.0f} windows/s; s per step "
            f"{[round(x, 4) for x in times[h]]}; costs {[round(c, 4) for c in costs[h]]}")
        if not np.isfinite(costs[h]).all():
            raise SystemExit(f"ngram: the {h} head gave a non-finite cost")
        if not np.mean(costs[h][-3:]) < np.mean(costs[h][:3]):
            raise SystemExit(f"ngram: the {h} head's cost did not fall")
    say("ngram: median s per step relative to the softmax head: "
        + ", ".join(f"{h} {med[h] / med['softmax']:.3f}" for h in names))
    for h in names:
        step_report(torch, P, trainers[h], NGRAM_FEEDING, [take(h), take(h)], f"ngram {h}",
                    card, med[h])
    del trainers
    torch.cuda.empty_cache()
    return med


def phase_sampler(torch, P, card, dev):
    """Phase 18b: nce's sampler on the card, 200,000 draws from a 20-class
    non-uniform distribution by inverse CDF, and its host syncs."""
    from paddle_tpu_torch.layers import sampled

    q = np.random.RandomState(18).uniform(0.1, 1.0, 20)
    q /= q.sum()
    L, dt = P.layer, P.data_type
    conf = L.nce(L.data("x", dt.dense_vector(4)), L.data("y", dt.integer_value(20)),
                 num_classes=20, neg_distribution=q.tolist()).conf
    _, cdf = sampled.noise_tables(conf, {}, dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    sites = count_syncs(torch, lambda: sampled.draw_noise(cdf, 20, SAMPLER_DRAWS, gen, dev))
    ids = sampled.draw_noise(cdf, 20, SAMPLER_DRAWS, gen, dev)
    n = SAMPLER_DRAWS[0] * SAMPLER_DRAWS[1]
    freq = torch.bincount(ids.reshape(-1), minlength=20).double().cpu().numpy() / n
    worst = float(np.abs(freq - q).max())
    say(f"nce sampler on {card}: {n} draws from 20 classes (probabilities "
        f"{q.min():.4f}-{q.max():.4f}): worst |frequency - probability| {worst:.5f} (<= "
        f"{SAMPLER_TOL}); host syncs of one draw {len(sites)}")
    if worst > SAMPLER_TOL or sites:
        raise SystemExit("nce sampler: the draws stray from the distribution or sync")


def ltr_lists(rng, n, w):
    """n query lists of LTR_DOCS documents: LTR_DIM features uniform in
    [0, 1) (MQ2007's are normalised per query), relevance 0-2 from a fixed
    linear score of the features, as dataset/mq2007.py's synthetic lists
    grade them."""
    out = []
    for _ in range(n):
        feats = rng.rand(rng.randint(LTR_DOCS[0], LTR_DOCS[1] + 1), LTR_DIM).astype(np.float32)
        z = (feats - 0.5) @ w / np.sqrt((w ** 2).sum() / 12.0)
        out.append((feats, np.digitize(z, [-0.3, 0.9]).astype(np.float32)))
    return out


def ltr_pairs(rng, lists, n):
    """n (left, right, [label]) pairs of documents of one query with
    different grades, label 1 where the left one is better."""
    out = []
    while len(out) < n:
        feats, grades = lists[rng.randint(len(lists))]
        i, j = rng.randint(len(grades), size=2)
        if grades[i] != grades[j]:
            out.append((feats[i].tolist(), feats[j].tolist(), [float(grades[i] > grades[j])]))
    return out


def ranknet_cost(P):
    """RankNet: one scoring network, fc(10, tanh) then fc(1, linear), shared
    by name between the two documents of a pair, and rank_cost."""
    L, A, dt, attr = P.layer, P.activation, P.data_type, P.attr

    def score(x):
        h = L.fc(x, size=10, act=A.Tanh(), param_attr=attr.ParamAttr(name="_rank_h.w"),
                 bias_attr=attr.ParamAttr(name="_rank_h.b"))
        return L.fc(h, size=1, act=A.Identity(), param_attr=attr.ParamAttr(name="_rank_o.w"),
                    bias_attr=attr.ParamAttr(name="_rank_o.b"))

    return L.rank_cost(score(L.data("left", dt.dense_vector(LTR_DIM))),
                       score(L.data("right", dt.dense_vector(LTR_DIM))),
                       L.data("label", dt.dense_vector(1)))


def lambdarank_cost(P):
    """LambdaRank: per document fc(128, tanh), fc(10, tanh), fc(1, linear)
    over the list as a sequence, and lambda_cost(NDCG_num=6)."""
    L, A, dt = P.layer, P.activation, P.data_type
    x = L.data("docs", dt.dense_vector_sequence(LTR_DIM))
    h = L.fc(L.fc(x, size=128, act=A.Tanh()), size=10, act=A.Tanh())
    return L.lambda_cost(L.fc(h, size=1, act=A.Identity()),
                         L.data("grades", dt.dense_vector_sequence(1)), NDCG_num=LTR_NDCG)


def phase_ltr(torch, P, card, dev):
    """Phase 18c: RankNet and LambdaRank, f32 card vs CPU and 8 bf16 steps
    of each."""
    rng = np.random.RandomState(0)
    w = rng.randn(LTR_DIM)
    lists = ltr_lists(rng, LTR_LISTS * (2 + LTR_STEPS), w)
    grades = np.concatenate([g for _, g in lists])
    say(f"ltr: {len(lists)} query lists of {LTR_DOCS[0]}-{LTR_DOCS[1]} documents, "
        f"{LTR_DIM} features, grades 0/1/2 in shares "
        f"{[round(float((grades == k).mean()), 3) for k in range(3)]}")
    nets = {
        "ranknet": (ranknet_cost, {"left": 0, "right": 1, "label": 2},
                    [ltr_pairs(rng, lists, LTR_PAIRS) for _ in range(2 + LTR_STEPS)]),
        "lambdarank": (lambdarank_cost, {"docs": 0, "grades": 1},
                       [[(f.tolist(), [[g] for g in gs.tolist()])
                         for f, gs in lists[k * LTR_LISTS:(k + 1) * LTR_LISTS]]
                        for k in range(2 + LTR_STEPS)]),
    }
    med = {}
    for name, (build, feeding, batches) in nets.items():
        P.init(seed=187, compute_dtype="float32")
        c_dev, c_cpu, err, n = card_cpu_grads(torch, P, build(P), feeding, batches[0], 189, dev)
        c_err = abs(c_dev - c_cpu) / abs(c_cpu)
        say(f"{name} f32 on {card}: cost card {c_dev:.7f} CPU {c_cpu:.7f} (relative "
            f"{c_err:.3e}), gradients relative L2 over {n} leaves {err:.3e} (<= {CARD_REL})")
        if not (c_err <= CARD_REL and err <= CARD_REL):
            raise SystemExit(f"{name}: the card strays from the CPU")
        P.init(compute_dtype="bfloat16")
        cost = build(P)
        trainer = P.trainer.SGD(cost, P.parameters.create(cost, seed=189),
                                P.optimizer.Adam(learning_rate=LTR_LR))
        one_step(torch, P, trainer, feeding, batches[1])  # first step
        steps = [one_step(torch, P, trainer, feeding, b) for b in batches[2:]]
        med[name] = float(np.median([s for s, _ in steps]))
        costs = [c for _, c in steps]
        say(f"{name} on {card}: {LTR_STEPS} bf16 steps, median {med[name]:.4f} s per step; s "
            f"per step {[round(s, 4) for s, _ in steps]}; costs {[round(c, 4) for c in costs]}")
        if not np.isfinite(costs).all():
            raise SystemExit(f"{name}: training gave a non-finite cost")
        del trainer
    return med


def elementwise_cases(P, rng):
    """(name, network, slot types, samples, CPU state or None) for each
    type ported with the costs, the sampled outputs and the elementwise
    layers, on the networks of tests/test_layer_grad_sweep.py."""
    L, A, dt = P.layer, P.activation, P.data_type
    st = P.core.topology
    lens = [5, 2, 7, 1, 4, 3]
    kinds = {"d": dt.dense_vector, "p": dt.dense_vector, "u": dt.dense_vector,
             "i": dt.integer_value, "s": dt.dense_vector_sequence,
             "g": dt.dense_vector_sequence}

    def sample(kind, n, b):
        if kind == "d":
            return rng.randn(n).tolist()
        if kind == "p":
            return (np.abs(rng.randn(n)) + 0.5).tolist()
        if kind == "u":
            return rng.uniform(0.05, 0.95, n).tolist()
        if kind == "i":
            return int(rng.randint(n))
        if kind == "s":
            return [rng.randn(n).tolist() for _ in range(lens[b])]
        return [[float(rng.randint(3))] for _ in range(lens[b])]

    def cols(*specs):
        """Slot types and 6 samples from specs of (name, kind, width): kind
        "d" dense, "p" dense positive, "u" dense in (0, 1), "i" ids, "s" a
        dense sequence, "g" a sequence of grades 0-2."""
        types = [(name, kinds[kind](n)) for name, kind, n in specs]
        return types, [tuple(sample(kind, n, b) for _, kind, n in specs)
                       for b in range(len(lens))]

    def d(name, n):
        return L.data(name, dt.dense_vector(n))

    def fc(x, n, act):
        return L.fc(x, size=n, act=act)

    def conf_out(name, type_, size, parents, **attrs):
        return st.LayerOutput(st.LayerConf(name=name, type=type_, size=size,
                                           inputs=tuple(p.name for p in parents), bias=False,
                                           attrs=attrs), parents)

    one_hot = [0.0] * 10
    one_hot[3] = 1.0
    multi = [L.classification_cost(fc(d("xa", 6), 3, A.Softmax()),
                                   L.data("la", dt.integer_value(3))),
             L.square_error_cost(fc(d("xb", 4), 2, A.Identity()), d("lb", 2))]
    cases = [
        ("soft_binary_class_cross_entropy", L.soft_binary_class_cross_entropy_cost(
            fc(d("x", 6), 6, A.Sigmoid()), d("t", 6)), cols(("x", "d", 6), ("t", "u", 6))),
        ("smooth_l1", L.smooth_l1_cost(fc(d("x", 8), 3, A.Identity()), d("y", 3)),
         cols(("x", "d", 8), ("y", "d", 3))),
        ("huber_regression", L.huber_regression_cost(fc(d("x", 8), 3, A.Identity()), d("y", 3)),
         cols(("x", "d", 8), ("y", "d", 3))),
        ("huber_classification", L.huber_classification_cost(
            fc(d("x", 8), 1, A.Identity()), L.data("y", dt.integer_value(2))),
         cols(("x", "d", 8), ("y", "i", 2))),
        ("rank_cost", L.rank_cost(fc(d("a", 4), 1, A.Identity()), fc(d("b", 4), 1, A.Identity()),
                                  L.data("y", dt.integer_value(2))),
         cols(("a", "d", 4), ("b", "d", 4), ("y", "i", 2))),
        ("sum_cost", L.sum_cost(fc(d("x", 8), 4, A.Tanh())), cols(("x", "d", 8))),
        ("cross_entropy_with_selfnorm", L.cross_entropy_with_selfnorm_cost(
            fc(d("x", 8), 5, A.Softmax()), L.data("y", dt.integer_value(5))),
         cols(("x", "d", 8), ("y", "i", 5))),
        ("multi_nn_cost", conf_out("__multi_nn_cost__", "multi_nn_cost", 1, multi),
         cols(("xa", "d", 6), ("la", "i", 3), ("xb", "d", 4), ("lb", "d", 2))),
        ("nce (one-hot neg_distribution)", L.nce(d("x", 8), L.data("y", dt.integer_value(10)),
                                                 num_neg_samples=4, neg_distribution=one_hot),
         cols(("x", "d", 8), ("y", "i", 10))),
        ("hsigmoid", L.hsigmoid(d("x", 8), L.data("y", dt.integer_value(9)), num_classes=9),
         cols(("x", "d", 8), ("y", "i", 9))),
        ("selective_fc", L.selective_fc(d("x", 8), d("sel", 9), size=9),
         cols(("x", "d", 8), ("sel", "d", 9))),
        ("lambda_cost", L.lambda_cost(fc(L.data("s", dt.dense_vector_sequence(4)), 1,
                                         A.Identity()), L.data("g", dt.dense_vector_sequence(1))),
         cols(("s", "s", 4), ("g", "g", 1))),
        ("slope_intercept", L.slope_intercept(d("x", 8), slope=2.0, intercept=0.5),
         cols(("x", "d", 8))),
        ("interpolation", L.interpolation(d("w", 1), d("a", 8), d("b", 8)),
         cols(("w", "d", 1), ("a", "d", 8), ("b", "d", 8))),
        ("sum_to_one_norm", L.sum_to_one_norm(d("x", 8)), cols(("x", "p", 8))),
        # a unit row's sum of squares is constant: an fc after the norm
        # gives the gradient something to carry
        ("row_l2_norm (then fc)", fc(L.row_l2_norm(d("x", 8)), 3, A.Identity()),
         cols(("x", "d", 8))),
        ("maxid", L.maxid(d("x", 8)), cols(("x", "d", 8))),
        ("multiplex", L.multiplex([L.data("sel", dt.integer_value(2)), d("a", 6), d("b", 6)]),
         cols(("sel", "i", 2), ("a", "d", 6), ("b", "d", 6))),
        ("trans", L.trans(d("x", 12), height=3), cols(("x", "d", 12))),
        ("trans (whole batch)", L.trans(d("x", 12)), cols(("x", "d", 12))),
        ("repeat", L.repeat(d("x", 6), num_repeats=2), cols(("x", "d", 6))),
        ("resize", L.resize(d("x", 12), size=6), cols(("x", "d", 12))),
        ("clip", L.clip(d("x", 8), min=-0.4, max=0.4), cols(("x", "d", 8))),
        ("dotmul", L.dotmul_operator(d("a", 8), d("b", 8)), cols(("a", "d", 8), ("b", "d", 8))),
        ("dotmul projection", conf_out("dm", "dotmul", 8, [d("x", 8)], projection=True),
         cols(("x", "d", 8))),
        ("out_prod", L.out_prod(d("a", 4), d("b", 3)), cols(("a", "d", 4), ("b", "d", 3))),
        ("cos", L.cos_sim(d("a", 8), d("b", 8), scale=5.0), cols(("a", "d", 8), ("b", "d", 8))),
        ("cos (cos_n 3)", L.cos_sim(d("a", 4), d("b", 12), scale=2.0, size=3),
         cols(("a", "d", 4), ("b", "d", 12))),
        ("tensor", L.tensor(d("a", 4), d("b", 3), size=5, act=A.Tanh()),
         cols(("a", "d", 4), ("b", "d", 3))),
        ("prelu (partial_sum 4)", L.prelu(d("x", 8), partial_sum=4), cols(("x", "d", 8))),
        ("power", L.power(d("w", 1), d("x", 8)), cols(("w", "p", 1), ("x", "p", 8))),
        ("rotate", L.rotate(d("x", 12), height=3, width=4), cols(("x", "d", 12))),
        ("linear_comb", L.linear_comb(d("w", 3), d("x", 12), size=4),
         cols(("w", "d", 3), ("x", "d", 12))),
        ("cos_vm", L.cos_sim_vec_mat(d("v", 3), d("m", 12), size=4),
         cols(("v", "d", 3), ("m", "d", 12))),
        ("scale_shift", L.scale_shift(d("x", 8)), cols(("x", "d", 8))),
    ]
    out = [(name, net, types, samples, None) for name, net, (types, samples) in cases]
    for strategy in ("z-score", "min-max", "decimal-scaling"):
        lo = rng.randn(8)
        hi = (rng.uniform(0.03, 700.0, 8) * rng.choice([-1.0, 1.0], 8)
              if strategy == "decimal-scaling" else lo + rng.uniform(0.5, 3.0, 8))
        stats = {"mean": rng.randn(8), "std": rng.uniform(0.5, 2.0, 8), "min": lo, "max": hi}
        out.append((f"data_norm {strategy}", L.data_norm(d("x", 8), strategy=strategy,
                                                         name="dn"),
                    *cols(("x", "d", 8)),
                    {"dn": {k: np.asarray(v, np.float32) for k, v in stats.items()}}))
    return out


def phase_elementwise_small(torch, P, card, dev):
    """Phase 18d: each type ported with the costs, the sampled outputs and
    the elementwise layers, card vs CPU in f32, and print's line."""
    import contextlib
    import io

    P.init(seed=191, compute_dtype="float32")
    worst = 0.0
    cases = elementwise_cases(P, np.random.RandomState(18))
    for k, (name, out, types, samples, state) in enumerate(cases):
        if state is not None:
            state = {n: {kk: torch.from_numpy(v) for kk, v in s.items()} for n, s in state.items()}
        err_y, err_g = small_card_cpu(torch, P, out, types, samples, 193 + k, state=state,
                                      dev=dev)
        kind = "values off" if err_g is None else "relative L2"
        say(f"elementwise f32 on {card}: {name}: output card vs CPU {kind} {err_y:.3e}"
            + ("" if err_g is None else f", gradients {err_g:.3e}") + f" (<= {CARD_REL})")
        worst = max(worst, err_y, err_g or 0.0)
        if err_y > (0 if err_g is None else CARD_REL) or (err_g or 0.0) > CARD_REL:
            raise SystemExit(f"elementwise: {name} strays between the card and the CPU")
    # print: once, outside any timed step; its line and its pass-through
    L, dt = P.layer, P.data_type
    out = L.print_layer(L.data("x", dt.dense_vector(4)), name="print18")
    net = P.CompiledNetwork(P.Topology(out), compute_dtype="float32")
    x = torch.arange(8, dtype=torch.float32, device=dev).reshape(2, 4)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        y = net.apply({}, {"x": P.core.batch.SeqTensor(x)}, train=False)[0][out.name].data
    line = buf.getvalue()
    say(f"elementwise: print on {card} printed {line.strip()!r}")
    if line != f"print18: {x.cpu().numpy()}\n" or not torch.equal(y, x):
        raise SystemExit("elementwise: print's line or its pass-through is wrong")
    say(f"elementwise: {len(cases) + 1} cases, worst card vs CPU {worst:.3e}")
    return worst


def phase_costs(torch, P, fa, card):
    """Phase 18: the N-gram LM through its three heads, nce's sampler,
    RankNet and LambdaRank, and every type ported with them, card vs CPU."""
    dev = torch.device("cuda")
    reset_counts(fa)
    t0 = time.perf_counter()
    med = phase_ngram(torch, P, card, dev)
    t1 = time.perf_counter()
    phase_sampler(torch, P, card, dev)
    t2 = time.perf_counter()
    ltr = phase_ltr(torch, P, card, dev)
    t3 = time.perf_counter()
    phase_elementwise_small(torch, P, card, dev)
    t4 = time.perf_counter()
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("costs: phase 18 launched a flash kernel")
    say(f"costs: phase 18 split: ngram {t1 - t0:.1f} s, sampler {t2 - t1:.1f} s, ltr "
        f"{t3 - t2:.1f} s, small checks {t4 - t3:.1f} s; flash launches (fwd, dq, dkv) over "
        f"it {launch_counts(fa)}; ngram median s per step "
        + ", ".join(f"{h} {s:.4f}" for h, s in med.items())
        + "; " + ", ".join(f"{h} {s:.4f} s per step" for h, s in ltr.items()))
    P.init(compute_dtype="bfloat16")


# Phase 19: AlexNet at bench_alexnet's configuration (the reference's
# benchmark/paddle/image/alexnet.py, batch_size=128, layer_num=1) and a
# CRNN-CTC line recognizer.  The config's learning_rate 0.01 / 128 and
# L2Regularization(0.0005 * 128) are v1's per-sample settings over a summed
# gradient; under the port's mean cost they are Momentum(0.01, 0.9), L2 5e-4.
AX_IMG, AX_CLASSES, AX_BATCH = 227, 1000, 128
AX_LR, AX_L2 = 0.01, 5e-4
AX_TIMED, AX_FIXED, AX_CHECK_B, AX_INFER = 4, 5, 2, 256
AX_GRAD_REL = 1e-4  # one step's f32 gradients, card vs the CPU's f64, relative L2 per leaf
AX_PROB_ABS, AX_LOGIT_REL = 1e-5, 1e-4  # two images served in f32, card vs CPU
AX_FEEDING = {"data": 0, "label": 1}
# the CRNN-CTC path: grayscale lines, two conv + pool stages, 8x1 blocks,
# a bidirectional GRU, 37 symbols + the blank, warp_ctc(blank=0)
CTC_H, CTC_W, CTC_FILTERS, CTC_GRU, CTC_CLASSES = 32, 100, (64, 128), 128, 38
CTC_B, CTC_LABELS, CTC_STEPS, CTC_LR, CTC_CHECK_B = 64, (3, 12), 10, 1e-3, 4
CTC_LOSS_REL = 1e-4  # F.ctc_loss against the port's cost: a yardstick
CTC_FEEDING = {"image": 0, "label": 1}


def alexnet_cost(P, **feed):
    """alexnet.py's network through the port's DSL: (cost, prediction);
    `feed` (feed_dtype, feed_scale, feed_shift) goes to the data layer."""
    L, A, dt = P.layer, P.activation, P.data_type
    drop = P.attr.ExtraAttr(drop_rate=0.5)
    net = L.data("data", dt.dense_vector(AX_IMG * AX_IMG * 3), height=AX_IMG, width=AX_IMG,
                 **feed)
    net = L.img_conv(net, filter_size=11, num_channels=3, num_filters=96, stride=4, padding=1)
    net = L.img_cmrnorm(net, size=5, scale=0.0001, power=0.75)
    net = L.img_pool(net, pool_size=3, stride=2)
    net = L.img_conv(net, filter_size=5, num_filters=256, stride=1, padding=2)
    net = L.img_cmrnorm(net, size=5, scale=0.0001, power=0.75)
    net = L.img_pool(net, pool_size=3, stride=2)
    for filters in (384, 384, 256):
        net = L.img_conv(net, filter_size=3, num_filters=filters, stride=1, padding=1)
    net = L.img_pool(net, pool_size=3, stride=2)
    net = L.fc(net, size=4096, act=A.Relu(), layer_attr=drop)
    net = L.fc(net, size=4096, act=A.Relu(), layer_attr=drop)
    net = L.fc(net, size=AX_CLASSES, act=A.Softmax())
    label = L.data("label", dt.integer_value(AX_CLASSES))
    return L.classification_cost(input=net, label=label), net


def alexnet_images(rng, n):
    """n (image, label) samples: flat CHW images from N(0, 1)."""
    imgs = rng.randn(n, 3 * AX_IMG * AX_IMG).astype(np.float32)
    labels = rng.randint(0, AX_CLASSES, size=n)
    return [(imgs[i], int(labels[i])) for i in range(n)]


def run_alexnet(P, trainer, samples, on_event=None):
    trainer.train(P.batch(lambda: iter(samples), AX_BATCH), feeding=AX_FEEDING,
                  event_handler=on_event)


def phase_alexnet_train(torch, P, card):
    """Phase 19a: AlexNet training through SGD.train at bench_alexnet's
    configuration; returns (trainer, prediction layer)."""
    torch.backends.cudnn.benchmark = True
    P.init(seed=31, compute_dtype="bfloat16")
    cost, probs = alexnet_cost(P)
    params = P.parameters.create(cost, seed=31)
    opt = P.optimizer.Momentum(learning_rate=AX_LR, momentum=0.9,
                               regularization=P.optimizer.L2Regularization(rate=AX_L2))
    trainer = P.trainer.SGD(cost, params, opt)
    topo = trainer.topology
    step_flops = 3 * AX_BATCH * conv_flops(topo)
    n_params = sum(v.numel() for p in params.params.values() for v in p.values())
    say(f"alexnet: {AX_IMG}x{AX_IMG}x3, {AX_CLASSES} classes, batch {AX_BATCH}, bf16 compute "
        f"over f32 masters, Momentum({AX_LR}, 0.9) with L2 {AX_L2} (alexnet.py's "
        f"0.01 / 128 and L2 0.0005 x 128 per sample, under the mean cost), {n_params} "
        f"parameters, {sum(c.type == 'conv' for c in topo.layers.values())} convs, "
        f"{sum(c.type == 'norm' for c in topo.layers.values())} cross-map norms; "
        f"{step_flops:.6e} conv FLOPs per training step (3 x forward)")
    rng = np.random.RandomState(31)
    t0 = time.perf_counter()
    run_alexnet(P, trainer, alexnet_images(rng, AX_BATCH))  # cuDNN autotuning, allocator
    torch.cuda.synchronize()
    say(f"alexnet: warm-up step {time.perf_counter() - t0:.3f} s")
    timed = alexnet_images(rng, AX_TIMED * AX_BATCH)
    torch.cuda.reset_peak_memory_stats()
    steps, clock = [], [0.0]

    def on_event(e):
        if isinstance(e, P.event.BeginIteration):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
        elif isinstance(e, P.event.EndIteration):
            steps.append((time.perf_counter() - clock[0], e.cost))

    run_alexnet(P, trainer, timed, on_event)
    secs, costs = [s[0] for s in steps], [s[1] for s in steps]
    peak = torch.cuda.max_memory_allocated()
    if len(steps) != AX_TIMED or not all(np.isfinite(costs)):
        raise SystemExit("alexnet: training gave a non-finite cost or a missing step")
    mean_s = float(np.mean(secs))
    say(f"alexnet train: {len(steps)} steps, costs {[round(c, 4) for c in costs]}, seconds per "
        f"step {[round(x, 4) for x in secs]} (each includes feeding the batch from the host)")
    say(f"alexnet train: {mean_s:.4f} s per step (mean of {len(secs)}), "
        f"{AX_BATCH * len(secs) / sum(secs):.2f} images/s, conv FLOPs "
        f"{step_flops / mean_s / 1e12:.2f} TFLOP/s = {step_flops / mean_s / PEAK_BF16_FLOPS:.4f} of "
        f"the bf16 peak, peak memory {peak / 2**30:.2f} GiB on {card}")
    feeder = P.reader.DataFeeder(topo.data_types(), AX_FEEDING, device=trainer.device)
    t0 = time.perf_counter()
    feeder(timed[:AX_BATCH])
    torch.cuda.synchronize()
    say(f"alexnet train: feeding one batch from the host {time.perf_counter() - t0:.4f} s")

    fixed = alexnet_images(rng, AX_BATCH)
    fixed_costs = []
    run_alexnet(P, trainer, fixed * AX_FIXED, lambda e: fixed_costs.append(e.cost)
                if isinstance(e, P.event.EndIteration) else None)
    say(f"alexnet train: {AX_FIXED} steps on one batch, costs "
        f"{[round(c, 4) for c in fixed_costs]}")
    if not all(np.isfinite(fixed_costs)) or not fixed_costs[-1] < fixed_costs[0]:
        raise SystemExit("alexnet: the cost did not fall over repeated steps on one batch")
    phase_alexnet_profile(torch, P, trainer, topo)

    # one step's gradients at B=2 in f32 (dropout off) on the card, held per
    # leaf to the CPU's f64, with the CPU's f32 beside it.  The CPU's f32 is
    # no reference: from this init it lies 0.7-1.9e-3 from f64 over every
    # leaf (a max pool's near-ties fall the other way), the card 1.4e-6.  The
    # parameters are a seeded init and cuDNN picks its algorithms by
    # heuristics, not by timing, so every run computes the same f32 values:
    # from the trained parameters (which vary with the bf16 steps' rounding)
    # under timed algorithms the card's f32 also broke such a tie now and
    # then (1.0e-3 from f64 over every leaf)
    net = P.CompiledNetwork(P.Topology(cost), compute_dtype="float32")
    check = alexnet_images(np.random.RandomState(32), AX_CHECK_B)
    init = net.init_params(32, device="cpu")
    torch.backends.cudnn.benchmark = False
    got = {}
    for where, dev, dtype in (("card f32", trainer.device, torch.float32),
                              ("CPU f32", torch.device("cpu"), torch.float32),
                              ("CPU f64", torch.device("cpu"), torch.float64)):
        batch = P.reader.DataFeeder(net.topology.data_types(), AX_FEEDING, device=dev)(check)
        batch["data"] = batch["data"].with_data(batch["data"].data.to(dtype))
        cast = lambda tree: {l: {k: v.to(dev, dtype) for k, v in p.items()}  # noqa: E731
                             for l, p in tree.items()}
        got[where] = grads_of(torch, net, cast(init), batch)
    torch.backends.cudnn.benchmark = True
    ref = got["CPU f64"]
    per_leaf = {n: rel_l2(torch, {n: got["card f32"][1][n]}, {n: g}) for n, g in ref[1].items()}
    worst = max(per_leaf, key=per_leaf.get)
    say(f"alexnet gradients B={AX_CHECK_B} f32 from a seeded init, card vs the CPU's f64: "
        f"costs card {got['card f32'][0]:.9f}, CPU f32 {got['CPU f32'][0]:.9f}, CPU f64 "
        f"{ref[0]:.9f}; worst leaf {worst} {per_leaf[worst]:.3e} (<= {AX_GRAD_REL}) over "
        f"{len(per_leaf)} leaves, the CPU's f32 there "
        f"{rel_l2(torch, {worst: got['CPU f32'][1][worst]}, {worst: ref[1][worst]}):.3e}; over "
        f"every leaf: card {rel_l2(torch, got['card f32'][1], ref[1]):.3e}, CPU f32 "
        f"{rel_l2(torch, got['CPU f32'][1], ref[1]):.3e}, card vs CPU f32 "
        f"{rel_l2(torch, got['card f32'][1], got['CPU f32'][1]):.3e}")
    if set(got["card f32"][1]) != set(ref[1]) or not per_leaf[worst] <= AX_GRAD_REL:
        raise SystemExit("alexnet: the card's gradients stray from the CPU's f64")
    return trainer, probs


def phase_alexnet_profile(torch, P, trainer, topo):
    """Phase 19a: torch.profiler over two training steps (busy share, top
    kernels), and the device time of the two norm layers' kernels: their
    forward and backward alone at the step's shapes, in bf16."""
    samples = alexnet_images(np.random.RandomState(33), 2 * AX_BATCH)
    wall, _, dev = device_window(torch, lambda: run_alexnet(P, trainer, samples),
                                 "alexnet profile")
    total_us = sum(e.self_device_time_total for e in dev)
    if total_us <= 0:
        say("alexnet profile: device time not measured (no window recorded any)")
        return
    say(f"alexnet profile: 2 steps in {wall:.4f} s (profiler on), device busy "
        f"{total_us / 1e6:.4f} s ({total_us / 1e6 / wall:.3f} of the window), "
        f"{sum(e.count for e in dev) / 2:.1f} kernels per step; top device kernels per step:")
    for e in sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        say(f"  {e.self_device_time_total / 2e3:9.3f} ms  {e.count / 2:6.1f} calls  "
            f"{100 * e.self_device_time_total / total_us:5.1f}%  {e.key[:100]}")
    norm_ms = norm_device_ms(torch, P, topo, trainer.device)
    say(f"alexnet profile: the norm layers' kernels {norm_ms:.3f} ms per step = "
        f"{norm_ms / (total_us / 2e3):.3f} of the step's device time")


def norm_device_ms(torch, P, topo, dev) -> float:
    """Device ms of the topology's norm layers' kernels: each layer's
    forward and backward alone in bf16 at its shape in the step, under the
    profiler."""
    L, dt = P.layer, P.data_type
    norm_us = 0.0
    for conf in (c for c in topo.layers.values() if c.type == "norm"):
        a = conf.attrs
        x = L.data("x", dt.dense_vector(a["in_c"] * a["in_h"] * a["in_w"]), height=a["in_h"],
                   width=a["in_w"])
        out = L.img_cmrnorm(x, size=a["norm_size"], scale=a["scale"], power=a["power"])
        net = P.CompiledNetwork(P.Topology(out), compute_dtype="bfloat16")
        xs = torch.randn(AX_BATCH, a["in_h"], a["in_w"], a["in_c"], device=dev,
                         dtype=torch.bfloat16, requires_grad=True)

        def fwd_bwd():
            y = net.apply({}, {"x": P.core.batch.SeqTensor(xs)}, train=True)[0][out.name].data
            y.backward(torch.ones_like(y))

        fwd_bwd()
        wall, busy, kernels, _ = profile_call(torch, fwd_bwd)
        norm_us += busy * 1e6
        say(f"alexnet norm {conf.name} [{AX_BATCH}, {a['in_h']}, {a['in_w']}, {a['in_c']}] "
            f"size {a['norm_size']}: forward + backward {busy * 1e3:.3f} ms on the device, "
            f"{kernels} kernels")
    return norm_us / 1e3


def phase_alexnet_infer(torch, P, probs, trainer, card):
    """Phase 19b: AlexNet served through Inference.infer from 19a's
    parameters, and two images in f32 card against CPU."""
    from paddle_tpu_torch.core.device import tree_to

    P.init(compute_dtype="bfloat16")
    inf = P.Inference(probs, trainer.parameters)
    images = [(x,) for x, _ in alexnet_images(np.random.RandomState(34), AX_INFER + AX_BATCH)]
    inf.infer(images[AX_INFER:], batch_size=AX_BATCH)  # warm-up
    torch.cuda.synchronize()
    results, batch_s = [], []
    t0 = time.perf_counter()
    for res in inf.iter_infer_field(field="value", input=images[:AX_INFER], batch_size=AX_BATCH):
        batch_s.append(time.perf_counter() - t0 - sum(batch_s))
        results.append(res[0])
    wall = time.perf_counter() - t0
    out = np.concatenate(results, axis=0)
    sums = out.sum(axis=1)
    say(f"alexnet infer: {AX_INFER} images in {len(results)} batches of {AX_BATCH}, bf16, "
        f"seconds per batch {[round(x, 4) for x in batch_s]}, {AX_INFER / wall:.2f} images/s on "
        f"{card}; row sums in [{sums.min():.6f}, {sums.max():.6f}]")
    if out.shape != (AX_INFER, AX_CLASSES) or not np.isfinite(out).all():
        raise SystemExit(f"alexnet infer: output {out.shape} not finite or not "
                         f"{(AX_INFER, AX_CLASSES)}")
    if np.abs(sums - 1.0).max() > 1e-2:
        raise SystemExit("alexnet infer: a distribution does not sum to 1 within 1e-2")
    P.init(compute_dtype="float32")
    two = images[:AX_CHECK_B]
    card_p = P.Inference(probs, trainer.parameters).infer(two, batch_size=AX_CHECK_B)
    cpu_p = P.Inference(probs, trainer.parameters, device="cpu").infer(two, batch_size=AX_CHECK_B)
    dp = float(np.abs(card_p - cpu_p).max())
    net = P.CompiledNetwork(P.Topology(probs), compute_dtype="float32")
    logits = []
    for dev in (trainer.device, torch.device("cpu")):
        batch = P.reader.DataFeeder(net.topology.data_types(), {"data": 0}, device=dev)(two)
        with torch.inference_mode():
            outs, _ = net.apply(tree_to(trainer.parameters.params, dev), batch, train=False)
        logits.append(outs[probs.name + "@logits"].data.cpu().double())
    dl = ((logits[0] - logits[1]).abs().max() / logits[1].abs().max()).item()
    say(f"alexnet infer f32 B={AX_CHECK_B}, card vs CPU: max|dp| = {dp:.3e} (<= {AX_PROB_ABS}), "
        f"max|dlogit|/max|logit| = {dl:.3e} (<= {AX_LOGIT_REL})")
    if not dp <= AX_PROB_ABS or not dl <= AX_LOGIT_REL:
        raise SystemExit("alexnet infer: card and CPU outputs disagree")
    P.init(compute_dtype="bfloat16")


def image_cases(P, rng):
    """Phase 19c's cases: (name, output, data types, samples), at shapes of
    the models that use each type."""
    L, A, dt = P.layer, P.activation, P.data_type

    def img(name, c, h, w):
        return L.data(name, dt.dense_vector(c * h * w), height=h, width=w)

    def samples(n, *widths):
        cols = [rng.randn(n, w).astype(np.float32) for w in widths]
        return [tuple(col[i] for col in cols) for i in range(n)]

    def dense(name, c, h, w):
        return (name, dt.dense_vector(c * h * w))

    out = []
    z = img("z", 512, 4, 4)
    h = L.img_conv(z, 4, 256, stride=2, padding=1, trans=True, act=A.Relu())
    h = L.img_conv(h, 4, 128, stride=2, padding=1, trans=True, act=A.Relu())
    h = L.img_conv(h, 4, 3, stride=2, padding=1, trans=True, act=A.Tanh())
    out.append(("convt DCGAN ladder [128, 4, 4, 512] -> 8x8x256 -> 16x16x128 -> 32x32x3", h,
                [dense("z", 512, 4, 4)], samples(128, 512 * 16)))
    g = L.img_conv(img("g", 256, 8, 8), 4, 128, stride=2, padding=1, groups=2, trans=True,
                   act=A.Identity())
    out.append(("convt groups 2 [128, 8, 8, 256] -> 16x16x128", g, [dense("g", 256, 8, 8)],
                samples(128, 256 * 64)))
    n = L.img_cmrnorm(img("n", 96, 55, 55), size=5, scale=0.0001, power=0.75)
    out.append(("norm size 5 over AlexNet's conv1 [128, 55, 55, 96]", n,
                [dense("n", 96, 55, 55)], samples(128, 96 * 55 * 55)))
    m = L.maxout(img("m", 192, 32, 32), groups=2)
    out.append(("maxout groups 2 [128, 32, 32, 192]", m, [dense("m", 192, 32, 32)],
                samples(128, 192 * 32 * 32)))
    for kind in ("max", "avg"):
        pool = P.pooling.Max() if kind == "max" else P.pooling.Avg()
        s = L.spp(img("s", 256, 13, 13), pyramid_height=3, pool_type=pool)
        out.append((f"spp {kind} pyramid 3 over AlexNet's conv5 [128, 13, 13, 256]", s,
                    [dense("s", 256, 13, 13)], samples(128, 256 * 169)))
    u = L.bilinear_interp(img("u", 64, 28, 28), out_size_x=56, out_size_y=56)
    out.append(("bilinear_interp 2x up [32, 28, 28, 64]", u, [dense("u", 64, 28, 28)],
                samples(32, 64 * 28 * 28)))
    d = L.bilinear_interp(img("d", 64, 56, 56), out_size_x=28, out_size_y=28)
    out.append(("bilinear_interp 2x down [32, 56, 56, 64]", d, [dense("d", 64, 56, 56)],
                samples(32, 64 * 56 * 56)))
    p = L.img_pad(img("p", 3, 227, 227), pad_c=(0, 1), pad_h=(2, 1), pad_w=(1, 2))
    out.append(("pad [32, 227, 227, 3] -> 230x230x4", p, [dense("p", 3, 227, 227)],
                samples(32, 3 * 227 * 227)))
    c = L.crop(img("c", 3, 227, 227), offset=[1, 2], axis=2, shape=[224, 224])
    out.append(("crop [32, 227, 227, 3] to 224x224 at (1, 2)", c, [dense("c", 3, 227, 227)],
                samples(32, 3 * 227 * 227)))
    for as_row in (True, False):
        f = L.featmap_expand(L.data("f", dt.dense_vector(4096)), 4, as_row_vector=as_row)
        out.append((f"featmap_expand x4 of AlexNet's fc [128, 4096], as_row_vector {as_row}", f,
                    [("f", dt.dense_vector(4096))], samples(128, 4096)))
    b = L.block_expand(img("b", 128, 8, 25), block_x=1, block_y=8)
    out.append(("block_expand 8x1 over the CTC path's [64, 8, 25, 128]", b,
                [dense("b", 128, 8, 25)], samples(64, 128 * 8 * 25)))
    o = L.conv_operator(img("o", 256, 13, 13), L.data("w", dt.dense_vector(256 * 256 * 9)),
                        filter_size=3, num_filters=256, num_channels=256, padding=1)
    out.append(("conv_op 3x3 256 -> 256 per sample over [8, 13, 13, 256]", o,
                [dense("o", 256, 13, 13), ("w", dt.dense_vector(256 * 256 * 9))],
                samples(8, 256 * 169, 256 * 256 * 9)))
    t = L.conv_operator(img("o", 128, 8, 25), L.data("w", dt.dense_vector(64 * 128 * 9)),
                        filter_size=3, num_filters=64, num_channels=128, padding=1, trans=True)
    out.append(("conv_op trans 3x3 128 -> 64 per sample over [8, 8, 25, 128]", t,
                [dense("o", 128, 8, 25), ("w", dt.dense_vector(64 * 128 * 9))],
                samples(8, 128 * 200, 64 * 128 * 9)))
    return out


def phase_image_types(torch, P, card, dev):
    """Phase 19c: each image type in f32 on the card and on the CPU, held
    to the CPU's f64 evaluation (phase 8's rule): outputs and the gradients
    of their sum of squares (parameters and inputs) within max(2 x the
    CPU f32's own error, 1e-5) relative L2."""
    P.init(seed=191, compute_dtype="float32")
    worst = 0.0
    cases = image_cases(P, np.random.RandomState(19))
    for k, (name, out, types, samples) in enumerate(cases):
        params = P.CompiledNetwork(P.Topology(out)).init_params(193 + k, device="cpu")
        got = {w: values_and_grads(torch, P, out, types, samples, params, d, dt)
               for w, d, dt in (("card", dev, torch.float32),
                                ("cpu", torch.device("cpu"), torch.float32),
                                ("f64", torch.device("cpu"), torch.float64))}
        errs = {}
        for part, i in (("output", 0), ("gradients", 1)):
            card_, cpu_, f64 = (got[w][i] if i else {"y": got[w][0]} for w in ("card", "cpu", "f64"))
            errs[part] = (rel_l2(torch, card_, f64),
                          max(RN_GRAD_SLACK * rel_l2(torch, cpu_, f64), CARD_REL),
                          rel_l2(torch, card_, cpu_))
        say(f"image f32 on {card}: {name}: " + "; ".join(
            f"{part} card vs CPU f64 {e:.3e} (<= {bar:.3e}), card vs CPU f32 {d:.3e}"
            for part, (e, bar, d) in errs.items()))
        worst = max(worst, *(e / bar for e, bar, _ in errs.values()))
        if any(e > bar for e, bar, _ in errs.values()):
            raise SystemExit(f"image types: {name} strays between the card and the CPU")
    say(f"image types: {len(cases)} cases, worst error / bar {worst:.3f}")
    P.init(compute_dtype="bfloat16")


def crnn_ctc_cost(P, evaluator=False):
    """The CRNN-CTC line recognizer: (cost, logits, ctc_error evaluator or
    None)."""
    L, A, dt = P.layer, P.activation, P.data_type
    net = L.data("image", dt.dense_vector(CTC_H * CTC_W), height=CTC_H, width=CTC_W)
    for k, f in enumerate(CTC_FILTERS):
        net = L.img_conv(net, filter_size=3, num_filters=f, padding=1, act=A.Relu(),
                         num_channels=1 if k == 0 else None)
        net = L.img_pool(net, pool_size=2, stride=2, pool_type=P.pooling.Max())
    net = L.block_expand(net, block_x=1, block_y=CTC_H // 4)
    net = P.networks.bidirectional_gru(net, size=CTC_GRU, return_seq=True)
    logits = L.fc(net, size=CTC_CLASSES, act=A.Identity(), name="ctc_logits")
    label = L.data("label", dt.integer_value_sequence(CTC_CLASSES))
    cost = L.warp_ctc(logits, label, size=CTC_CLASSES, blank=0, norm_by_times=False)
    ev = P.evaluator.ctc_error_evaluator(logits, label, name="ctc_error") if evaluator else None
    return cost, logits, ev


def ctc_lines(rng, n):
    """n (line image, label ids) samples: images from N(0, 1), 3-12 ids in
    1..37 (0 is the blank)."""
    x = rng.randn(n, CTC_H * CTC_W).astype(np.float32)
    return [(x[i], [int(v) for v in rng.randint(1, CTC_CLASSES, size=rng.randint(
        CTC_LABELS[0], CTC_LABELS[1] + 1))]) for i in range(n)]


def phase_ctc(torch, P, card, dev):
    """Phase 19d: the CRNN-CTC path: bf16 training with the evaluator, host
    syncs by site, f32 card vs CPU, and F.ctc_loss as a yardstick."""
    import torch.nn.functional as F

    P.init(seed=41, compute_dtype="bfloat16")
    cost, logits, ev = crnn_ctc_cost(P, evaluator=True)
    trainer = P.trainer.SGD(cost, P.parameters.create(cost, seed=41),
                            P.optimizer.Adam(learning_rate=CTC_LR), evaluators=[ev])
    rng = np.random.RandomState(41)
    batch = ctc_lines(rng, CTC_B)
    frames = CTC_W // 4
    say(f"ctc: lines {CTC_H}x{CTC_W}, convs {CTC_FILTERS}, block_expand 8x1 -> {frames} frames "
        f"of {CTC_FILTERS[-1] * CTC_H // 4}, bidirectional_gru {CTC_GRU}, fc {CTC_CLASSES}, "
        f"warp_ctc(blank=0); B = {CTC_B}, labels of {CTC_LABELS[0]}-{CTC_LABELS[1]} ids; bf16, "
        f"Adam({CTC_LR})")
    one_step(torch, P, trainer, CTC_FEEDING, batch)  # warm-up
    steps = []
    for _ in range(CTC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = []
        trainer.train(lambda: iter([batch]), feeding=CTC_FEEDING, event_handler=lambda e: got.append(
            (e.cost, e.evaluator["ctc_error"])) if isinstance(e, P.event.EndIteration) else None)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0, *got[0]))
    secs, costs, errs = zip(*steps)
    med = float(np.median(secs))
    say(f"ctc train: {CTC_STEPS} steps on one batch after a warm-up: costs "
        f"{[round(c, 4) for c in costs]}, ctc_error {[round(e, 4) for e in errs]}, median "
        f"{med:.4f} s per step, {CTC_B / med:.1f} lines/s on {card}")
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise SystemExit("ctc: the cost did not fall over repeated steps on one batch")
    sites = count_syncs(torch, lambda: one_step(torch, P, trainer, CTC_FEEDING, batch))
    by_site = {x: sites.count(x) for x in sorted(set(sites))}
    inside = [x for x in sites if x.startswith(("paddle_tpu_torch/layers/", "paddle_tpu_torch/ops/"))]
    evals = [x for x in sites if x.startswith("paddle_tpu_torch/evaluator.py")]
    say(f"ctc step: {len(sites)} host syncs by site {by_site}; from the layers and ops "
        f"{len(inside)}, the evaluator's copy per batch {evals}")
    if inside or len(evals) != 1:
        raise SystemExit(f"ctc: host syncs from the layers {inside} or not one evaluator copy "
                         f"{evals}")
    wall, busy, kernels, top = profile_call(
        torch, lambda: one_step(torch, P, trainer, CTC_FEEDING, batch))
    say(f"ctc step: {kernels} device kernels, device busy {busy:.4f} s of {wall:.4f} s "
        f"({busy / wall:.3f}); top:")
    for line in top[:3]:
        say(f"  {line}")
    del trainer

    # f32 card vs CPU at B = 4: the path's cost and gradients, and the cost's
    # gradient with respect to the logits alone
    P.init(seed=42, compute_dtype="float32")
    small = ctc_lines(np.random.RandomState(42), CTC_CHECK_B)
    cost32, _, _ = crnn_ctc_cost(P)
    c_dev, c_cpu, g_rel, n_leaves = card_cpu_grads(torch, P, cost32, CTC_FEEDING, small, 43, dev)
    c_rel = abs(c_dev - c_cpu) / abs(c_cpu)
    L, dt = P.layer, P.data_type
    lone = L.warp_ctc(L.data("logits", dt.dense_vector_sequence(CTC_CLASSES)),
                      L.data("label", dt.integer_value_sequence(CTC_CLASSES)),
                      size=CTC_CLASSES, blank=0)
    lrng = np.random.RandomState(44)
    lone_samples = [(lrng.randn(int(lrng.randint(2 * len(ids) + 1, frames + 1)),
                                CTC_CLASSES).astype(np.float32), ids) for _, ids in small]
    err_y, err_g = small_card_cpu(torch, P, lone, [
        ("logits", dt.dense_vector_sequence(CTC_CLASSES)),
        ("label", dt.integer_value_sequence(CTC_CLASSES))], lone_samples, 45, dev=dev)
    say(f"ctc f32 B={CTC_CHECK_B}, card vs CPU: path cost {c_dev:.9f} vs {c_cpu:.9f} (relative "
        f"{c_rel:.3e}), gradients relative L2 {g_rel:.3e} over {n_leaves} leaves; warp_ctc alone "
        f"on ragged logits: costs {err_y:.3e}, logit gradients {err_g:.3e} (<= {CARD_REL})")
    if not max(c_rel, g_rel, err_y, err_g) <= CARD_REL:
        raise SystemExit("ctc: the card's cost or gradients stray from the CPU's")

    # F.ctc_loss against the port's cost on the card, at the path's shape
    net = P.CompiledNetwork(P.Topology(lone), compute_dtype="float32")
    feeder = P.reader.DataFeeder([("logits", dt.dense_vector_sequence(CTC_CLASSES)),
                                  ("label", dt.integer_value_sequence(CTC_CLASSES))], device=dev)
    yrng = np.random.RandomState(46)
    fb = feeder([(yrng.randn(frames, CTC_CLASSES).astype(np.float32), ids)
                 for _, ids in ctc_lines(yrng, CTC_B)])
    x = fb["logits"].data.detach().requires_grad_(True)
    lab, lab_len, in_len = fb["label"].data.long(), fb["label"].lengths.long(), \
        fb["logits"].lengths.long()

    def port():
        b = {"logits": fb["logits"].with_data(x), "label": fb["label"]}
        c = net.apply({}, b, train=True)[0][lone.name].data
        c.sum().backward()
        return c

    def library():
        lp = F.log_softmax(x, dim=-1).transpose(0, 1)
        c = F.ctc_loss(lp, lab, in_len, lab_len, blank=0, reduction="none")
        c.sum().backward()
        return c

    mine, ref = port().detach()[:, 0], library().detach()
    d = ((mine - ref).abs() / ref.abs()).max().item()
    port_ms, lib_ms = time_ms(torch, port), time_ms(torch, library)
    _, busy, kernels, _ = profile_call(torch, port)
    say(f"ctc cost on the card, B={CTC_B}, T={frames}, {CTC_CLASSES} classes: port vs F.ctc_loss "
        f"max relative {d:.3e} (<= {CTC_LOSS_REL}); forward + backward {port_ms:.4f} ms (port, "
        f"{kernels} kernels, {kernels / frames:.1f} per frame, device busy {busy * 1e3:.3f} ms) "
        f"vs {lib_ms:.4f} ms (F.ctc_loss, a yardstick the port never calls)")
    if not d <= CTC_LOSS_REL:
        raise SystemExit("ctc: the port's cost and F.ctc_loss disagree")
    P.init(compute_dtype="bfloat16")


def phase_image_ctc(torch, P, fa, card):
    """Phase 19: AlexNet training and serving, each image type card vs CPU,
    and the CRNN-CTC path."""
    reset_counts(fa)
    t0 = time.perf_counter()
    trainer, probs = phase_alexnet_train(torch, P, card)
    t1 = time.perf_counter()
    phase_alexnet_infer(torch, P, probs, trainer, card)
    del trainer
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    dev = torch.device("cuda")
    phase_image_types(torch, P, card, dev)
    t3 = time.perf_counter()
    phase_ctc(torch, P, card, dev)
    t4 = time.perf_counter()
    say(f"image: phase 19 split: alexnet train {t1 - t0:.1f} s, infer {t2 - t1:.1f} s, types "
        f"{t3 - t2:.1f} s, ctc {t4 - t3:.1f} s; flash launches (fwd, dq, dkv) over it "
        f"{launch_counts(fa)}")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("image: phase 19 launched a flash kernel")


# Phase 20: the last five layer types.  SSD300-VGG16 (Liu et al., ECCV 2016;
# Caffe's ssd_pascal.py, which the PaddlePaddle models repository's v2 ssd
# example followed): 300x300x3, 21 classes (background 0), VGG-16 with v1's
# ceil pooling (150/75/38/19), pool5 3x3/1, fc6 as a 3x3 conv of 1024 (no
# dilation: img_conv has none), fc7 1x1 1024, the extras conv6-conv9, and
# loc/conf heads with a priorbox on conv4_3 (no L2 norm: the DSL has no
# cross_channel_norm), fc7, conv6_2, conv7_2, conv8_2, conv9_2: 8732 priors;
# the paper's Momentum(0.001, 0.9) with L2 5e-4
SSD_IMG, SSD_CLASSES, SSD_B = 300, 21, 32
SSD_LR, SSD_L2 = 1e-3, 5e-4
# from a random (not ImageNet-trained) VGG and N(0, 1) pixels the paper's
# rate makes the cost on one fixed batch oscillate (12.76, 14.56, 11.20,
# 15.89, 15.10 in five steps on an H100; at 1e-4 still 15.17, 14.17,
# 14.14, 14.75, 14.27): the falling-cost check takes 3e-5
SSD_FIXED_LR = 3e-5
SSD_TIMED, SSD_FIXED, SSD_CHECK_B, SSD_INFER = 4, 5, 2, 3
SSD_VGG = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
SSD_EXTRAS = (("conv6", 256, 512, 2, 1), ("conv7", 128, 256, 2, 1), ("conv8", 128, 256, 1, 0),
              ("conv9", 128, 256, 1, 0))  # (name, 1x1 width, 3x3 width, stride, padding)
SSD_HEADS = (("conv4_3", 30, 60, (2,)), ("fc7", 60, 111, (2, 3)), ("conv6_2", 111, 162, (2, 3)),
             ("conv7_2", 162, 213, (2, 3)), ("conv8_2", 213, 264, (2,)),
             ("conv9_2", 264, 315, (2,)))  # (map, min size, max size, aspect ratios)
SSD_VAR = (0.1, 0.1, 0.2, 0.2)
SSD_PRIORS = 8732
SSD_GT = (1, 8)  # ground-truth boxes per image
SSD_FEEDING = {"image": 0, "gt": 1}
DET_ABS = 1e-5  # detection scores and boxes, card vs CPU in f32 on the same head outputs
# Transformer-base with MoE encoder FFNs (Switch Transformer, Fedus et al.
# 2021: top-1 routing, capacity factor 1.25) against phase 5's dense model
MOE_EXPERTS, MOE_ROUNDS = 8, 3
MOE_WIDTHS = (512, 8, 6, 2048)  # d_model, heads, layers, d_ff: phase 5's Transformer-base
MOE_SMALL = dict(d_model=64, n_heads=4, n_layers=2, d_ff=128, moe_experts=4)
MOE_GRAD_REL = 1e-4  # the small model's f32 gradients card vs CPU (relative L2)
# MDLSTM-CTC: phase 19d's lines and stem, a 1x1 conv to 5 x 64 gates and
# mdlstmemory(64) in each of the four directions, summed
MD_N, MD_STEPS, MD_LR = 64, 8, 1e-3
MD_DIRS = ((False, False), (True, False), (False, True), (True, True))


def ssd300(P, neg_pos_ratio=3.0):
    """SSD300-VGG16 through the port's DSL: (cost, detection_output, gt
    slot)."""
    L, A, dt = P.layer, P.activation, P.data_type
    img = L.data("image", dt.dense_vector(3 * SSD_IMG * SSD_IMG), height=SSD_IMG, width=SSD_IMG)
    gt = L.data("gt", dt.dense_vector_sequence(6))
    net, maps = img, {}
    for k, block in enumerate(SSD_VGG):
        for j, f in enumerate(block):
            net = L.img_conv(net, 3, f, padding=1, act=A.Relu(), name=f"conv{k + 1}_{j + 1}",
                             num_channels=3 if k == j == 0 else None)
        maps[f"conv{k + 1}_{len(block)}"] = net
        if k < 4:
            net = L.img_pool(net, 2, stride=2, pool_type=P.pooling.Max(), name=f"pool{k + 1}")
    net = L.img_pool(net, 3, stride=1, padding=1, pool_type=P.pooling.Max(), name="pool5")
    net = L.img_conv(net, 3, 1024, padding=1, act=A.Relu(), name="fc6")
    net = maps["fc7"] = L.img_conv(net, 1, 1024, act=A.Relu(), name="fc7")
    for name, mid, out, stride, pad in SSD_EXTRAS:
        net = L.img_conv(net, 1, mid, act=A.Relu(), name=f"{name}_1")
        net = maps[f"{name}_2"] = L.img_conv(net, 3, out, stride=stride, padding=pad,
                                             act=A.Relu(), name=f"{name}_2")
    locs, confs, pbs = [], [], []
    for name, lo, hi, ratios in SSD_HEADS:
        k = 2 + 2 * len(ratios)  # min, sqrt(min * max), r and 1/r per ratio
        locs.append(L.img_conv(maps[name], 3, 4 * k, padding=1, act=A.Identity(),
                               name=f"{name}_loc"))
        confs.append(L.img_conv(maps[name], 3, SSD_CLASSES * k, padding=1, act=A.Identity(),
                                name=f"{name}_conf"))
        pbs.append(L.priorbox(maps[name], img, aspect_ratio=list(ratios), variance=list(SSD_VAR),
                              min_size=[lo], max_size=[hi], name=f"{name}_priors"))
    priors = L.concat(pbs, name="priors")  # the reference's multi-map form
    cost = L.multibox_loss(locs, confs, priors, gt, num_classes=SSD_CLASSES,
                           overlap_threshold=0.5, neg_pos_ratio=neg_pos_ratio, neg_overlap=0.5,
                           name="mbox_loss")
    det = L.detection_output(locs, confs, priors, num_classes=SSD_CLASSES, nms_threshold=0.45,
                             nms_top_k=400, keep_top_k=200, confidence_threshold=0.01,
                             name="detections")
    return cost, det, gt


def ssd_boxes(rng, n):
    """1-8 ground-truth rows (label 1-20, corners with sides >= 0.05,
    difficult one time in ten) for each of n images."""
    out = []
    for _ in range(n):
        rows = []
        for _ in range(rng.randint(SSD_GT[0], SSD_GT[1] + 1)):
            w, h = rng.uniform(0.05, 0.6, size=2)
            x, y = rng.uniform(0.0, 1.0 - w), rng.uniform(0.0, 1.0 - h)
            rows.append((float(rng.randint(1, SSD_CLASSES)), x, y, x + w, y + h,
                         float(rng.rand() < 0.1)))
        out.append(rows)
    return out


def ssd_samples(rng, n):
    """n (image, ground truth) samples: flat CHW images from N(0, 1)."""
    imgs = rng.randn(n, 3 * SSD_IMG * SSD_IMG).astype(np.float32)
    return list(zip(imgs, ssd_boxes(rng, n)))


def phase_ssd_train(torch, P, card):
    """Phase 20a: SSD300-VGG16 training through SGD.train; returns the
    trainer, the detection layer and the gt slot."""
    torch.backends.cudnn.benchmark = True
    P.init(seed=51, compute_dtype="bfloat16")
    cost, det, gt = ssd300(P)
    trainer = P.trainer.SGD(cost, P.parameters.create(cost, seed=51), P.optimizer.Momentum(
        learning_rate=SSD_LR, momentum=0.9,
        regularization=P.optimizer.L2Regularization(rate=SSD_L2)))
    topo = trainer.topology
    n_priors = topo.layers["priors"].size // 8
    step_flops = 3 * SSD_B * conv_flops(topo)
    n_params = sum(v.numel() for p in trainer.parameters.params.values() for v in p.values())
    say(f"ssd: SSD300-VGG16, {SSD_IMG}x{SSD_IMG}x3, {SSD_CLASSES} classes, {n_priors} priors, "
        f"batch {SSD_B}, bf16 over f32 masters, Momentum({SSD_LR}, 0.9) with L2 {SSD_L2}, "
        f"{n_params} parameters, {sum(c.type == 'conv' for c in topo.layers.values())} convs; "
        f"{conv_flops(topo) / 1e9:.3f} GFLOP of convs per image forward, {step_flops:.6e} per "
        f"training step (3 x forward)")
    if n_priors != SSD_PRIORS:
        raise SystemExit(f"ssd: {n_priors} priors, not {SSD_PRIORS}")
    rng = np.random.RandomState(51)
    t0 = time.perf_counter()
    one_step(torch, P, trainer, SSD_FEEDING, ssd_samples(rng, SSD_B))  # cuDNN autotuning
    say(f"ssd: warm-up step {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    steps = [one_step(torch, P, trainer, SSD_FEEDING, ssd_samples(rng, SSD_B))
             for _ in range(SSD_TIMED)]
    peak = torch.cuda.max_memory_allocated()
    secs, costs = [s for s, _ in steps], [c for _, c in steps]
    if not all(np.isfinite(costs)):
        raise SystemExit("ssd: training gave a non-finite cost")
    mean_s = float(np.mean(secs))
    say(f"ssd train: {SSD_TIMED} steps on distinct batches, costs {[round(c, 4) for c in costs]}, "
        f"seconds per step {[round(x, 4) for x in secs]} (each feeds its batch from the host)")
    say(f"ssd train: {mean_s:.4f} s per step (mean), {SSD_B / mean_s:.2f} images/s, conv FLOPs "
        f"{step_flops / mean_s / 1e12:.2f} TFLOP/s = {step_flops / mean_s / PEAK_BF16_FLOPS:.4f} "
        f"of the bf16 peak, peak memory {peak / 2**30:.2f} GiB on {card}")
    fixed = ssd_samples(rng, SSD_B)
    paper = [one_step(torch, P, trainer, SSD_FEEDING, fixed)[1] for _ in range(SSD_FIXED)]
    slow = P.trainer.SGD(cost, trainer.parameters, P.optimizer.Momentum(
        learning_rate=SSD_FIXED_LR, momentum=0.9,
        regularization=P.optimizer.L2Regularization(rate=SSD_L2)))
    fixed_costs = [one_step(torch, P, slow, SSD_FEEDING, fixed)[1] for _ in range(SSD_FIXED)]
    del slow
    say(f"ssd train: {SSD_FIXED} steps on one batch at Momentum({SSD_LR}), costs "
        f"{[round(c, 4) for c in paper]}; then {SSD_FIXED} at Momentum({SSD_FIXED_LR}), costs "
        f"{[round(c, 4) for c in fixed_costs]}")
    if not all(np.isfinite(paper + fixed_costs)) or not fixed_costs[-1] < fixed_costs[0]:
        raise SystemExit("ssd: the cost did not fall over repeated steps on one batch")
    sites = count_syncs(torch, lambda: one_step(torch, P, trainer, SSD_FEEDING, fixed))
    by_site = {x: sites.count(x) for x in sorted(set(sites))}
    inside = [x for x in sites if x.startswith(("paddle_tpu_torch/layers/",
                                                "paddle_tpu_torch/ops/"))]
    wall, busy, kernels, top = profile_call(
        torch, lambda: one_step(torch, P, trainer, SSD_FEEDING, fixed))
    say(f"ssd step: {len(sites)} host syncs by site {by_site}, {len(inside)} from the layers and "
        f"ops; {kernels} device kernels, device busy {busy:.4f} s of {wall:.4f} s "
        f"({busy / wall:.3f}); top:")
    for line in top:
        say(f"  {line}")
    if inside:
        raise SystemExit(f"ssd: the step reads the device inside its layers: {inside}")

    # one step's gradients at B=2, card against CPU in f32 and in f64, of
    # the loss with every negative kept: the hard-negative ranks of a random
    # init's near-uniform scores tie within f32 rounding, and which of two
    # tied priors a device keeps moves the gradients; 20e holds the ranking
    # itself on separated scores
    cost_all, _, _ = ssd300(P, neg_pos_ratio=float(SSD_PRIORS))
    net = P.CompiledNetwork(P.Topology(cost_all), compute_dtype="float32")
    got = grads_four_ways(torch, P, net, trainer.parameters.params, SSD_FEEDING,
                          ssd_samples(np.random.RandomState(52), SSD_CHECK_B), trainer.device)
    judge_four_ways(torch, got, f"ssd gradients B={SSD_CHECK_B}, every negative kept")
    return trainer, det, gt


def phase_ssd_infer(torch, P, trainer, det, gt, card):
    """Phase 20b: detection_output and detection_map_evaluator on the card
    from 20a's parameters (bf16), then in f32 the same head outputs through
    detection_output on the card and on the CPU."""
    from paddle_tpu_torch.core.device import tree_to

    net = P.CompiledNetwork(P.Topology([det, gt]), compute_dtype="bfloat16")
    ev = P.evaluator.detection_map_evaluator(det, gt, num_classes=SSD_CLASSES, name="map")
    feeder = P.reader.DataFeeder(net.topology.data_types(), SSD_FEEDING, device=trainer.device)
    params = trainer.parameters.params
    rng = np.random.RandomState(53)

    def run(batch):
        with torch.inference_mode():
            outs = net.apply(params, batch, train=False)[0]
            return {k: v.cpu().numpy() for k, v in ev.update(outs).items()}, outs[det.name]

    run(feeder(ssd_samples(rng, SSD_B)))  # warm-up
    sums, secs = {}, []
    for _ in range(SSD_INFER):
        batch = feeder(ssd_samples(rng, SSD_B))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, out = run(batch)
        secs.append(time.perf_counter() - t0)
        sums = {k: sums.get(k, 0) + v for k, v in acc.items()}
    m_ap = ev.finalize(sums)["map"]
    live = float((out.data[..., 0] >= 0).float().mean())
    say(f"ssd infer: {SSD_INFER} batches of {SSD_B}, bf16, nms 0.45 top 400 keep 200 confidence "
        f"0.01, detection_map_evaluator 11point: seconds per batch (detection_output and the "
        f"evaluator's update, to the host copy) {[round(s, 4) for s in secs]}, "
        f"{SSD_B * SSD_INFER / sum(secs):.2f} images/s; {live:.3f} of the 200 slots live; mAP "
        f"{m_ap:.6f} (random weights) on {card}")
    if out.data.shape != (SSD_B, 200, 6) or not torch.isfinite(out.data).all():
        raise SystemExit(f"ssd infer: detections {tuple(out.data.shape)} not finite or not "
                         f"{(SSD_B, 200, 6)}")
    batch = feeder(ssd_samples(rng, SSD_B))
    wall, busy, kernels, top = profile_call(torch, lambda: run(batch))
    say(f"ssd infer batch: {kernels} device kernels ({kernels / 400:.1f} per NMS round), device "
        f"busy {busy:.4f} s of {wall:.4f} s ({busy / wall:.3f}); top:")
    for line in top[:4]:
        say(f"  {line}")

    # f32: the head outputs of 2 images computed once on the card, then the
    # priorboxes, their concat and detection_output on each device
    net32 = P.CompiledNetwork(P.Topology([det, gt]), compute_dtype="float32")
    check = ssd_samples(np.random.RandomState(54), SSD_CHECK_B)
    cpu = torch.device("cpu")
    with torch.inference_mode():
        outs = net32.apply(tree_to(params, trainer.device), P.reader.DataFeeder(
            net32.topology.data_types(), SSD_FEEDING, device=trainer.device)(check),
            train=False)[0]
    tail = {n for n, c in net32.topology.layers.items()
            if c.type in ("priorbox", "concat", "detection_output")}
    heads = {n: outs[n] for n in net32.topology.layers[det.name].inputs[1:]}
    heads.update({i: outs[i] for n in tail if net32.topology.layers[n].type == "priorbox"
                  for i in net32.topology.layers[n].inputs})
    got, maps = {}, {}
    for where, dev in (("card", trainer.device), ("CPU", cpu)):
        preset = {n: P.core.batch.SeqTensor(t.data.to(dev), None if t.lengths is None
                                            else t.lengths.to(dev)) for n, t in heads.items()}
        with torch.inference_mode():
            o = net32.apply(tree_to(params, dev), {}, train=False, only=tail, preset=preset)[0]
        got[where] = o[det.name].data.cpu()
        gtb = P.reader.DataFeeder([("gt", P.data_type.dense_vector_sequence(6))],
                                  device=dev)([(b,) for _, b in check])
        maps[where] = ev.finalize({k: v.cpu().numpy() for k, v in ev.update(
            {det.name: o[det.name], gt.name: gtb["gt"]}).items()})["map"]
    a, b = got["card"], got["CPU"]
    labels_equal = torch.equal(a[..., 0], b[..., 0])
    d = float((a[..., 1:] - b[..., 1:]).abs().max())
    say(f"ssd detections f32 B={SSD_CHECK_B}, card vs CPU on the same head outputs: labels and "
        f"order equal {labels_equal}, max |d| of scores and boxes {d:.3e} (<= {DET_ABS}); mAP "
        f"card {maps['card']:.9f} CPU {maps['CPU']:.9f}")
    if not labels_equal or not d <= DET_ABS or maps["card"] != maps["CPU"]:
        raise SystemExit("ssd: card and CPU detections disagree")


def phase_moe(torch, P, fa, card, dev):
    """Phase 20c: Transformer-base with MoE encoder FFNs against the dense
    model of phase 5, in turns; dropped tokens, the aux values, the flash
    launches; the small model's f32 gradients card vs CPU."""
    from paddle_tpu_torch.models.transformer import transformer_cost

    P.init(seed=11, compute_dtype="bfloat16", use_flash_attention=True)
    costs = {"dense": transformer_cost(VOCAB, VOCAB, *MOE_WIDTHS)[0],
             "moe": transformer_cost(VOCAB, VOCAB, *MOE_WIDTHS, moe_experts=MOE_EXPERTS)[0]}
    trainers = {k: P.trainer.SGD(c, P.parameters.create(c, seed=11), P.optimizer.Momentum(
        learning_rate=TRAIN_LR, momentum=0.9)) for k, c in costs.items()}
    n_params = {k: sum(v.numel() for p in t.parameters.params.values() for v in p.values())
                for k, t in trainers.items()}
    rng = np.random.RandomState(61)
    for t in trainers.values():
        one_step(torch, P, t, FEEDING, train_samples(rng, BATCH))  # warm-up
    secs = {"dense": [], "moe": []}
    per_step = {"dense": [], "moe": []}
    for _ in range(MOE_ROUNDS):
        for k in ("dense", "moe", "moe", "dense"):
            before = launch_counts(fa)
            s, c = one_step(torch, P, trainers[k], FEEDING, train_samples(rng, BATCH))
            if not np.isfinite(c):
                raise SystemExit(f"moe: the {k} step gave a non-finite cost")
            secs[k].append(s)
            per_step[k].append(tuple(a - b for a, b in zip(launch_counts(fa), before)))
    med = {k: float(np.median(v)) for k, v in secs.items()}
    say(f"moe: Transformer-base with {MOE_EXPERTS}-expert MoE encoder FFNs (top-1, capacity "
        f"factor 1.25; {n_params['moe']} parameters) vs dense ({n_params['dense']}), B = {BATCH}, "
        f"T = {T}, bf16, flash on, {MOE_ROUNDS} rounds of (dense, moe, moe, dense): seconds per "
        f"step dense {[round(x, 4) for x in secs['dense']]}, moe {[round(x, 4) for x in secs['moe']]}"
        f"; median dense {med['dense']:.4f} s, moe {med['moe']:.4f} s, moe/dense "
        f"{med['moe'] / med['dense']:.3f} on {card}")
    say(f"moe: flash launches (fwd, dq, dkv) per step {sorted(set(per_step['moe']))} (moe), "
        f"{sorted(set(per_step['dense']))} (dense)")
    if set(per_step["moe"]) != {(18, 18, 18)} or set(per_step["dense"]) != {(18, 18, 18)}:
        raise SystemExit("moe: expected 18/18/18 flash launches per step")
    batch = train_samples(rng, BATCH)
    for k, t in trainers.items():
        wall, busy, kernels, top = profile_call(torch, lambda: one_step(torch, P, t, FEEDING, batch))
        say(f"moe: a {k} step under the profiler: {kernels} device kernels, device busy {busy:.4f} "
            f"s of {wall:.4f} s ({busy / wall:.3f}); top:")
        for line in top[:4]:
            say(f"  {line}")
    # the tokens each MoE layer dropped (their output row is zero) and its
    # aux term, on one batch
    trainer = trainers["moe"]
    net = P.CompiledNetwork(trainer.topology, compute_dtype="bfloat16")
    samples = train_samples(rng, BATCH)
    batch = P.reader.DataFeeder(net.topology.data_types(), FEEDING, device=trainer.device)(samples)
    with torch.inference_mode():
        outs = net.apply(trainer.parameters.params, batch, train=False)[0]
    valid = batch["src_word"].mask().bool()
    report = []
    for i in range(MOE_WIDTHS[2]):
        y = outs[f"enc{i}_moe"].data
        dropped = int(((y == 0).all(-1) & valid).sum())
        aux = float(outs[f"enc{i}_moe@aux_loss"].data[0, 0])
        report.append((dropped, aux))
    n_valid = int(valid.sum())
    say(f"moe: of {n_valid} valid source tokens ({BATCH * T} with padding; capacity "
        f"{int(BATCH * T / MOE_EXPERTS * 1.25)} per expert) the six layers dropped "
        f"{[d for d, _ in report]} ({max(d for d, _ in report) / n_valid:.4f} at most); aux "
        f"{[round(a, 4) for _, a in report]}")
    if not all(np.isfinite(a) and a >= 1.0 - 1e-3 for _, a in report):
        raise SystemExit("moe: an aux value is not finite or below 1")
    del trainers, trainer, net, outs
    torch.cuda.empty_cache()
    phase_moe_layer(torch, P, card, dev)

    P.init(compute_dtype="float32", use_flash_attention=False)
    small = transformer_cost(512, 512, **MOE_SMALL)[0]
    srng = np.random.RandomState(62)
    samples = []
    for _ in range(4):
        n = srng.randint(8, 33)
        trg = list(srng.randint(2, 512, size=n))
        samples.append((list(srng.randint(2, 512, size=srng.randint(8, 33))), [0] + trg[:-1], trg))
    c_dev, c_cpu, g_rel, leaves = card_cpu_grads(torch, P, small, FEEDING, samples, 63, dev)
    c_rel = abs(c_dev - c_cpu) / abs(c_cpu)
    say(f"moe f32 small ({MOE_SMALL}), card vs CPU: cost {c_dev:.9f} vs {c_cpu:.9f} (relative "
        f"{c_rel:.3e}), gradients relative L2 {g_rel:.3e} over {leaves} leaves (<= "
        f"{MOE_GRAD_REL})")
    if not max(c_rel, g_rel) <= MOE_GRAD_REL:
        raise SystemExit("moe: the card's cost or gradients stray from the CPU's")
    P.init(compute_dtype="bfloat16", use_flash_attention=False)


def moe_onehot(torch, tokens, p, e, cap):
    """The JAX package's form of the moe layer (all tokens valid), written
    out here as a yardstick the port never calls: [N, E, C] one-hot dispatch
    and combine tensors contracted by einsums."""
    gates = torch.softmax((tokens @ p["router"]).float(), dim=-1)
    idx = torch.argmax(gates, dim=-1)
    top = torch.gather(gates, 1, idx[:, None])[:, 0]
    onehot = (idx[:, None] == torch.arange(e, device=tokens.device)).float()
    pos = torch.cumsum(onehot, dim=0) * onehot - onehot
    keep = (pos < cap).float() * onehot
    # a one-hot of the position that is zero out of range, as jax.nn.one_hot
    dispatch = keep[..., None] * (pos.long()[..., None] == torch.arange(
        cap, device=tokens.device)).float()
    xin = torch.einsum("nec,nd->ecd", dispatch.to(tokens.dtype), tokens)
    h = torch.relu(torch.einsum("ecd,edh->ech", xin, p["w1"]) + p["b1"][:, None, :])
    y = torch.einsum("ech,ehd->ecd", h, p["w2"]) + p["b2"][:, None, :]
    return torch.einsum("nec,ecd->nd", (dispatch * top[:, None, None]).to(y.dtype), y)


def phase_moe_layer(torch, P, card, dev):
    """Phase 20c: the moe layer alone, forward and backward in bf16 at the
    MoE Transformer's shape (8 x 1024 tokens of 512, 8 experts of 2048,
    capacity 1280): the port's dispatch by index against the one-hot einsum
    form and the dense FFN (two fcs) it replaces."""
    from paddle_tpu_torch.utils.tree import map_leaves

    L, A, dt = P.layer, P.activation, P.data_type
    d, h = MOE_WIDTHS[0], MOE_WIDTHS[3]
    x = L.data("x", dt.dense_vector_sequence(d))
    outs = {"moe": L.moe_layer(x, expert_hidden=h, num_experts=MOE_EXPERTS, size=d),
            "dense": L.fc(L.fc(x, size=h, act=A.Relu()), size=d, act=A.Identity())}
    gen = torch.Generator(device=dev).manual_seed(64)
    xs = torch.randn(BATCH, T, d, device=dev, generator=gen).to(torch.bfloat16).requires_grad_(True)
    lengths = torch.full((BATCH,), T, dtype=torch.int32, device=dev)
    runs, ys = {}, {}
    for k, out in outs.items():
        net = P.CompiledNetwork(P.Topology(out), compute_dtype="bfloat16")
        prm = map_leaves(lambda v: v.to(torch.bfloat16).requires_grad_(True),
                         net.init_params(seed=65, device=dev))

        def fwd(net=net, out=out, prm=prm):
            return net.apply(prm, {"x": P.core.batch.SeqTensor(xs, lengths)},
                             train=True)[0][out.name].data

        fwds = {k: fwd}
        if k == "moe":
            cap = int(BATCH * T / MOE_EXPERTS * 1.25)
            fwds["one-hot"] = lambda p=prm[out.name], cap=cap: moe_onehot(
                torch, xs.reshape(-1, d), p, MOE_EXPERTS, cap).reshape(BATCH, T, d)
        for name, f in fwds.items():
            runs[name] = lambda f=f: f().backward(torch.ones_like(xs))
            with torch.no_grad():
                ys[name] = f().float()
    ms = {k: time_ms(torch, f, iters=10) for k, f in runs.items()}
    busy = {k: profile_call(torch, f)[1:3] for k, f in runs.items()}
    d_max = float((ys["moe"] - ys["one-hot"]).abs().max())
    scale = float(ys["one-hot"].abs().max())
    say(f"moe layer alone, bf16 forward + backward over {BATCH}x{T} tokens of {d}, "
        f"{MOE_EXPERTS} experts of {h}, ms per call (device busy ms, kernels): "
        + ", ".join(f"{k} {ms[k]:.4f} ({busy[k][0] * 1e3:.4f}, {busy[k][1]})" for k in (
            "moe", "one-hot", "dense"))
        + f" [moe: dispatch by index, the port; one-hot: the einsum form, a yardstick]; "
        f"outputs index vs one-hot max |d| {d_max:.3e} (<= 2^-7 of their largest, "
        f"{scale:.3e}) on {card}")
    if not d_max <= scale * 2 ** -7:
        raise SystemExit("moe: dispatch by index and the one-hot form disagree")


def mdlstm_ctc_cost(P, evaluator=False):
    """The MDLSTM-CTC line recognizer: (cost, logits, ctc_error evaluator or
    None)."""
    L, A, dt = P.layer, P.activation, P.data_type
    net = L.data("image", dt.dense_vector(CTC_H * CTC_W), height=CTC_H, width=CTC_W)
    for k, f in enumerate(CTC_FILTERS):
        net = L.img_conv(net, filter_size=3, num_filters=f, padding=1, act=A.Relu(),
                         num_channels=1 if k == 0 else None)
        net = L.img_pool(net, pool_size=2, stride=2, pool_type=P.pooling.Max())
    dirs = []
    for rh, rw in MD_DIRS:
        gates = L.img_conv(net, filter_size=1, num_filters=5 * MD_N, act=A.Identity())
        dirs.append(L.mdlstmemory(gates, size=MD_N, reverse_h=rh, reverse_w=rw))
    net = L.addto(dirs, act=A.Identity(), bias_attr=False)
    net = L.block_expand(net, block_x=1, block_y=CTC_H // 4, num_channels=MD_N)
    logits = L.fc(net, size=CTC_CLASSES, act=A.Identity(), name="md_logits")
    label = L.data("label", dt.integer_value_sequence(CTC_CLASSES))
    cost = L.warp_ctc(logits, label, size=CTC_CLASSES, blank=0, norm_by_times=False)
    ev = P.evaluator.ctc_error_evaluator(logits, label, name="ctc_error") if evaluator else None
    return cost, logits, ev


def phase_mdlstm_ctc(torch, P, card, dev):
    """Phase 20d: the MDLSTM-CTC path: bf16 training with the evaluator, host
    syncs by site, kernels and busy share; f32 card vs CPU at B = 4."""
    P.init(seed=71, compute_dtype="bfloat16")
    cost, _, ev = mdlstm_ctc_cost(P, evaluator=True)
    trainer = P.trainer.SGD(cost, P.parameters.create(cost, seed=71),
                            P.optimizer.Adam(learning_rate=MD_LR), evaluators=[ev])
    batch = ctc_lines(np.random.RandomState(71), CTC_B)
    diags = CTC_H // 4 + CTC_W // 4 - 1
    say(f"mdlstm: lines {CTC_H}x{CTC_W}, convs {CTC_FILTERS} with max pool 2 -> "
        f"{CTC_H // 4}x{CTC_W // 4}x{CTC_FILTERS[-1]}, per direction a 1x1 conv to {5 * MD_N} "
        f"gates and mdlstmemory({MD_N}) ({diags} diagonals each), the 4 summed, block_expand 8x1 "
        f"-> {CTC_W // 4} frames, fc {CTC_CLASSES}, warp_ctc(blank=0); B = {CTC_B}, bf16, "
        f"Adam({MD_LR})")
    one_step(torch, P, trainer, CTC_FEEDING, batch)  # warm-up
    steps = [one_step(torch, P, trainer, CTC_FEEDING, batch) for _ in range(MD_STEPS)]
    secs, costs = [s for s, _ in steps], [c for _, c in steps]
    med = float(np.median(secs))
    say(f"mdlstm train: {MD_STEPS} steps on one batch after a warm-up: costs "
        f"{[round(c, 4) for c in costs]}, median {med:.4f} s per step, {CTC_B / med:.1f} lines/s "
        f"on {card}")
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise SystemExit("mdlstm: the cost did not fall over repeated steps on one batch")
    sites = count_syncs(torch, lambda: one_step(torch, P, trainer, CTC_FEEDING, batch))
    by_site = {x: sites.count(x) for x in sorted(set(sites))}
    inside = [x for x in sites if x.startswith(("paddle_tpu_torch/layers/",
                                                "paddle_tpu_torch/ops/"))]
    wall, busy, kernels, top = profile_call(
        torch, lambda: one_step(torch, P, trainer, CTC_FEEDING, batch))
    say(f"mdlstm step: {len(sites)} host syncs by site {by_site}, {len(inside)} from the layers "
        f"and ops; {kernels} device kernels ({kernels / (4 * diags):.1f} per direction and "
        f"diagonal, all of the step's included), device busy {busy:.4f} s of {wall:.4f} s "
        f"({busy / wall:.3f}); top:")
    for line in top[:4]:
        say(f"  {line}")
    if inside:
        raise SystemExit(f"mdlstm: host syncs from the layers {inside}")
    del trainer
    # B = 4, card against CPU in f32 and in f64
    P.init(seed=72, compute_dtype="float32")
    cost32, _, _ = mdlstm_ctc_cost(P)
    net = P.CompiledNetwork(P.Topology(cost32), compute_dtype="float32")
    got = grads_four_ways(torch, P, net, net.init_params(73, device="cpu"), CTC_FEEDING,
                          ctc_lines(np.random.RandomState(72), CTC_CHECK_B), dev)
    judge_four_ways(torch, got, f"mdlstm gradients B={CTC_CHECK_B}")
    P.init(compute_dtype="bfloat16")


def spread_logits(rng, b, p, c):
    """[b, p * c] class logits with well-separated probabilities: one class
    per prior (1..c-1) gets a logit from an evenly spaced grid, shuffled,
    the others 0, so no two priors' scores of a class lie within f32
    rounding of each other (random head weights give near-equal scores)."""
    logits = np.zeros((b * p, c), np.float32)
    logits[np.arange(b * p), rng.randint(1, c, size=b * p)] = (
        rng.permutation(b * p) * (6.0 / (b * p)) - 2.0)
    return logits.reshape(b, p * c)


def new_type_cases(P, rng):
    """Phase 20e's cases: (name, output, data types, samples), at the shapes
    of the models that use each type."""
    L, dt = P.layer, P.data_type

    def geometry(name, h, w, c=1):
        """A data slot of width c carrying an h x w map's geometry (the
        priorbox reads only the shape)."""
        d = L.data(name, dt.dense_vector(c))
        d.conf.attrs.update(in_h=h, in_w=w, out_h=h, out_w=w, channels=c)
        return d

    out = []
    img = geometry("img", SSD_IMG, SSD_IMG)
    pb = L.priorbox(geometry("feat", 38, 38), img, aspect_ratio=[2], variance=list(SSD_VAR),
                    min_size=[30], max_size=[60])
    out.append(("priorbox over SSD's conv4_3 (38x38, 4 per cell) [2, 5776, 8]", pb,
                [("feat", dt.dense_vector(1)), ("img", dt.dense_vector(1))],
                [(np.ones(1, np.float32), np.ones(1, np.float32))] * 2))
    for name, (h, k, lo, hi, ratios, b) in (("multibox_loss", (19, 6, 60, 111, [2, 3], 8)),
                                            ("detection_output", (10, 6, 111, 162, [2, 3], 2))):
        p = h * h * k
        pbm = L.priorbox(geometry("feat", h, h), img, aspect_ratio=ratios, variance=list(SSD_VAR),
                         min_size=[lo], max_size=[hi])
        loc = L.data("loc", dt.dense_vector(p * 4))
        conf = L.data("conf", dt.dense_vector(p * SSD_CLASSES))
        types = [("feat", dt.dense_vector(1)), ("img", dt.dense_vector(1)),
                 ("loc", dt.dense_vector(p * 4)), ("conf", dt.dense_vector(p * SSD_CLASSES))]
        locs = (rng.randn(b, p * 4) * 0.5).astype(np.float32)
        confs = spread_logits(rng, b, p, SSD_CLASSES)
        ones = np.ones(1, np.float32)
        if name == "multibox_loss":
            o = L.multibox_loss(loc, conf, pbm, L.data("gt", dt.dense_vector_sequence(6)),
                                num_classes=SSD_CLASSES)
            types.append(("gt", dt.dense_vector_sequence(6)))
            samples = [(ones, ones, locs[i], confs[i], rows)
                       for i, rows in enumerate(ssd_boxes(rng, b))]
        else:
            o = L.detection_output(loc, conf, pbm, num_classes=SSD_CLASSES, nms_threshold=0.45,
                                   nms_top_k=400, keep_top_k=200, confidence_threshold=0.01)
            samples = [(ones, ones, locs[i], confs[i]) for i in range(b)]
        out.append((f"{name} over SSD's {h}x{h} map ({p} priors, {SSD_CLASSES} classes), B={b}",
                    o, types, samples))
    m = L.moe_layer(L.data("x", dt.dense_vector_sequence(512)), expert_hidden=2048,
                    num_experts=MOE_EXPERTS)
    xs = rng.randn(4, 64, 512).astype(np.float32)
    out.append(("moe 8 experts, 512 -> 2048 -> 512, [4, <=64, 512] ragged", m,
                [("x", dt.dense_vector_sequence(512))],
                [(xs[i, : n],) for i, n in enumerate((64, 50, 17, 33))]))
    hh, ww = CTC_H // 4, CTC_W // 4
    for rh, rw in MD_DIRS:
        g = L.data("g", dt.dense_vector(5 * MD_N * hh * ww), height=hh, width=ww)
        md = L.mdlstmemory(g, size=MD_N, reverse_h=rh, reverse_w=rw)
        out.append((f"mdlstmemory({MD_N}) reverse ({rh}, {rw}) over [4, {hh}, {ww}, {5 * MD_N}]",
                    md, [("g", dt.dense_vector(5 * MD_N * hh * ww))],
                    [(x,) for x in rng.randn(4, 5 * MD_N * hh * ww).astype(np.float32)]))
    return out


def phase_new_types(torch, P, card, dev):
    """Phase 20e: each new type in f32 on the card and on the CPU, held to
    the CPU's f64 (phase 19c's rule): outputs and the gradients of their sum
    of squares (parameters and float slots) within max(2 x the CPU f32's own
    error, 1e-5) relative L2."""
    P.init(seed=201, compute_dtype="float32")
    worst = 0.0
    cases = new_type_cases(P, np.random.RandomState(20))
    for k, (name, out, types, samples) in enumerate(cases):
        params = P.CompiledNetwork(P.Topology(out)).init_params(203 + k, device="cpu")
        got = {w: values_and_grads(torch, P, out, types, samples, params, d, dt)
               for w, d, dt in (("card", dev, torch.float32),
                                ("cpu", torch.device("cpu"), torch.float32),
                                ("f64", torch.device("cpu"), torch.float64))}
        errs = {}
        for part, i in (("output", 0), ("gradients", 1)):
            card_, cpu_, f64 = (got[w][i] if i else {"y": got[w][0]} for w in ("card", "cpu", "f64"))
            if not f64:  # priorbox: no float input reaches its output
                continue
            errs[part] = (rel_l2(torch, card_, f64),
                          max(RN_GRAD_SLACK * rel_l2(torch, cpu_, f64), CARD_REL),
                          rel_l2(torch, card_, cpu_))
        say(f"new type f32 on {card}: {name}: " + "; ".join(
            f"{part} card vs CPU f64 {e:.3e} (<= {bar:.3e}), card vs CPU f32 {d:.3e}"
            for part, (e, bar, d) in errs.items()))
        worst = max(worst, *(e / bar for e, bar, _ in errs.values()))
        if any(e > bar for e, bar, _ in errs.values()):
            raise SystemExit(f"new types: {name} strays between the card and the CPU")
    say(f"new types: {len(cases)} cases, worst error / bar {worst:.3f}")
    P.init(compute_dtype="bfloat16")


def phase_last_types(torch, P, fa, card):
    """Phase 20: SSD training and inference, the MoE Transformer, the
    MDLSTM-CTC path and each new type card vs CPU."""
    dev = torch.device("cuda")
    reset_counts(fa)
    t0 = time.perf_counter()
    trainer, det, gt = phase_ssd_train(torch, P, card)
    t1 = time.perf_counter()
    phase_ssd_infer(torch, P, trainer, det, gt, card)
    t2 = time.perf_counter()
    del trainer
    torch.cuda.empty_cache()
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("ssd: phase 20a-b launched a flash kernel")
    phase_moe(torch, P, fa, card, dev)
    t3 = time.perf_counter()
    reset_counts(fa)
    phase_mdlstm_ctc(torch, P, card, dev)
    t4 = time.perf_counter()
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("mdlstm: phase 20d launched a flash kernel")
    phase_new_types(torch, P, card, dev)
    t5 = time.perf_counter()
    say(f"last types: phase 20 split: ssd train {t1 - t0:.1f} s, infer {t2 - t1:.1f} s, moe "
        f"{t3 - t2:.1f} s, mdlstm {t4 - t3:.1f} s, types {t5 - t4:.1f} s")


# phase 21: the op framework, the GAN and VAE trainers, the v2 surface
FW_B, FW_DIMS = 256, (784, 128, 10)  # the MLP of the framework's net: batch, widths
FW_STEPS, FW_LR = 30, 0.5
RNN_T, RNN_B, RNN_D = 100, 64, 128  # tests/test_framework_ops.py:199's step net, widened
GAN_NOISE, GAN_DATA, GAN_HIDDEN, GAN_B = 100, 784, 128, 128  # gan_conf_image.py's MNIST
VAE_DATA, VAE_HIDDEN, VAE_LATENT, VAE_B = 784, 128, 100, 128
GEN_TIMED_STEPS = 50  # timed GAN batches and VAE steps, after one warm-up
GAN_CPU_BATCHES = 5  # GAN batches card vs CPU: losses within GAN_LOSS_REL
GAN_LOSS_REL = 1e-4
FW_REL = 1e-5  # card vs CPU, relative L2, or 2x the CPU f32's distance from f64 if larger


def flat_tree(tree) -> dict:
    """{dotted path: tensor} of a parameter or gradient tree."""
    from paddle_tpu_torch.utils.tree import dotted, leaf_paths

    return {dotted(path): v for path, v in leaf_paths(tree)}


def cpu_copy(tree):
    """A copy of a parameter tree on the CPU (never sharing storage)."""
    from paddle_tpu_torch.utils.tree import map_leaves

    return map_leaves(lambda v: v.detach().cpu().clone(), tree)


def mixture_rows(rng, n, dim):
    """n rows of a two-component Gaussian mixture in `dim` dimensions (the
    centres from RandomState(0)), float32: the phase's "real" data."""
    centres = np.random.RandomState(0).randn(2, dim)
    return (centres[rng.randint(2, size=n)] + 0.3 * rng.randn(n, dim)).astype(np.float32)


def mlp_step_net(fw):
    """(forward NetOp, its Backward with x and label out, the training NetOp
    [forward, backward, one sgd op per parameter])."""
    c = fw.create_op
    fwd = fw.NetOp([
        c("mul", X="x", Y="w1", Out="h1"), c("rowwise_add", X="h1", b="b1", Out="h1b"),
        c("sigmoid", X="h1b", Y="s1"), c("mul", X="s1", Y="w2", Out="h2"),
        c("rowwise_add", X="h2", b="b2", Out="h2b"), c("softmax", X="h2b", Y="prob"),
        c("onehot_cross_entropy", X="prob", label="label", Y="ce"),
        c("mean", X="ce", Out="cost")]).complete_add_op()
    bwd = fw.Backward(fwd, no_grad_set={"x", "label"})
    sgds = [c("sgd", param=n, grad=n + "@GRAD", param_out=n, learning_rate=FW_LR)
            for n in ("w1", "b1", "w2", "b2")]
    return fwd, bwd, fw.NetOp([fwd, bwd] + sgds).complete_add_op()


def mlp_inputs(seed):
    """The MLP's inputs and parameters as float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    d0, d1, d2 = FW_DIMS
    return {"x": rng.randn(FW_B, d0).astype(np.float32),
            "label": rng.randint(0, d2, size=FW_B).astype(np.float32),
            "w1": (rng.randn(d0, d1) / np.sqrt(d0)).astype(np.float32),
            "b1": np.zeros(d1, np.float32),
            "w2": (rng.randn(d1, d2) / np.sqrt(d1)).astype(np.float32),
            "b2": np.zeros(d2, np.float32)}


def seed_out_grads(torch, fwd, scope, cost="cost"):
    """d cost / d cost = 1 and zeros for the forward's other outputs (a
    missing out@GRAD would be seeded with ones)."""
    fwd.infer_shape(scope)
    for n in fwd.output_names():
        shape = scope.get_var(n).shape
        scope.new_var(n + "@GRAD").set(
            torch.ones(shape, device=scope.device) if n == cost
            else torch.zeros(shape, device=scope.device))


def fwd_bwd_values(torch, fw, fwd, bwd, arrays, seeds, dev, dtype):
    """{name: tensor} of every forward output and every gradient of one
    forward and Backward on `dev` in `dtype` (float64 through the traces,
    which cast nothing; float32 through the scope runs)."""
    if dtype == torch.float32:
        scope = fw.Scope(device=dev)
        for k, v in arrays.items():
            scope.new_var(k).set(v)
        for k, v in seeds.items():
            scope.new_var(k).set(v)
        fwd.run(scope)
        bwd.run(scope)
        names = fwd.output_names() + bwd.output_names()
        return {n: scope.get_var(n).get() for n in names}
    vals = {k: torch.as_tensor(v, dtype=dtype, device=dev) for k, v in {**arrays, **seeds}.items()}
    vals = bwd.trace(fwd.trace(vals))
    return {n: vals[n] for n in fwd.output_names() + bwd.output_names()}


def judge_card_cpu(torch, fw, fwd, bwd, arrays, seeds, dev, name):
    """Card f32 against CPU f32, each output and gradient, relative L2 within
    max(FW_REL, 2x the CPU f32's distance from the CPU's f64); returns the
    worst ratio."""
    card = fwd_bwd_values(torch, fw, fwd, bwd, arrays, seeds, dev, torch.float32)
    cpu = fwd_bwd_values(torch, fw, fwd, bwd, arrays, seeds, torch.device("cpu"), torch.float32)
    f64 = fwd_bwd_values(torch, fw, fwd, bwd, arrays, seeds, torch.device("cpu"), torch.float64)
    worst, rows = 0.0, []
    for n in card:
        d = rel_l2(torch, {n: card[n]}, {n: cpu[n]})
        own = rel_l2(torch, {n: cpu[n]}, {n: f64[n]})
        bar = max(FW_REL, 2 * own)
        worst = max(worst, d / bar)
        rows.append(f"{n} {d:.3g} (CPU f32 from f64 {own:.3g})")
    say(f"{name} card vs CPU f32, relative L2 per output and gradient (bar max({FW_REL}, 2x the "
        f"CPU's own distance from f64)): worst / bar {worst:.3f}; " + ", ".join(rows))
    if not worst <= 1.0:
        raise SystemExit(f"{name}: card and CPU disagree past the bar ({worst:.3f})")
    return worst


def phase_framework_mlp(torch, P, card, dev):
    """Phase 21a: the op framework's MLP trained on the card: one NetOp of
    the forward, its Backward and four sgd ops in one Scope."""
    from paddle_tpu_torch import framework as fw

    fwd, bwd, step = mlp_step_net(fw)
    arrays = mlp_inputs(81)
    scope = fw.Scope(device=dev)
    for k, v in arrays.items():
        scope.new_var(k).set(v)
    seed_out_grads(torch, fwd, scope)
    say(f"framework mlp: x[{FW_B}, {FW_DIMS[0]}] -> mul w1 [{FW_DIMS[0]}, {FW_DIMS[1]}] -> "
        f"rowwise_add -> sigmoid -> mul w2 [{FW_DIMS[1]}, {FW_DIMS[2]}] -> rowwise_add -> "
        f"softmax -> onehot_cross_entropy -> mean; Backward(no_grad_set x, label) and 4 sgd "
        f"ops at lr {FW_LR}: one NetOp of the forward (8 ops), its Backward and the sgd "
        f"ops, in one Scope on {scope.device}")
    step.run(scope)  # warm-up
    costs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FW_STEPS):
        step.run(scope)
        costs.append(scope.get_var("cost").get())
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / FW_STEPS
    costs = [c.item() for c in costs]
    sites = count_syncs(torch, lambda: step.run(scope))
    by_site = {x: sites.count(x) for x in sorted(set(sites))}
    inside = [x for x in sites if x.startswith("paddle_tpu_torch/")]
    wall, busy, kernels, top = profile_call(torch, lambda: step.run(scope))
    say(f"framework mlp on {card}: {FW_STEPS} steps {per_step * 1e3:.4f} ms per step, costs "
        f"{costs[0]:.4f} -> {costs[-1]:.4f}; one step: {len(sites)} host syncs by site "
        f"{by_site}, {kernels} device kernels, device busy {busy * 1e3:.4f} ms of "
        f"{wall * 1e3:.4f} ms ({busy / wall:.3f}); top:")
    for line in top[:3]:
        say(f"  {line}")
    if not (all(np.isfinite(costs)) and costs[-1] < costs[0]):
        raise SystemExit("framework mlp: the cost did not fall")
    if inside:
        raise SystemExit(f"framework mlp: host syncs from the package {inside}")
    grad_seeds = {n + "@GRAD": (np.ones((), np.float32) if n == "cost" else
                                np.zeros(scope.get_var(n).shape, np.float32))
                  for n in fwd.output_names()}
    judge_card_cpu(torch, fw, fwd, bwd, mlp_inputs(82), grad_seeds, dev, "framework mlp")


def phase_framework_rnn(torch, P, card, dev):
    """Phase 21b: RecurrentOp (h = sigmoid(x_t W + h U)) forward and
    Backward on the card, timed, profiled and held to the CPU."""
    from paddle_tpu_torch import framework as fw

    step = fw.NetOp()
    step.add_op(fw.create_op("mul", X="x_t", Y="W", Out="xw"))
    step.add_op(fw.create_op("mul", X="h_pre", Y="U", Out="hu"))
    step.add_op(fw.create_op("add", X="xw", Y="hu", Out="pre_act"))
    step.add_op(fw.create_op("sigmoid", X="pre_act", Y="h"))
    step.complete_add_op()
    rnn = fw.RecurrentOp(step_net=step, inlinks={"x": "x_t"}, outlinks=["h"],
                         memories=[("h_pre", "h", "h0")])
    bwd = fw.Backward(rnn)
    rng = np.random.RandomState(83)
    arrays = {"x": rng.randn(RNN_T, RNN_B, RNN_D).astype(np.float32),
              "W": (rng.randn(RNN_D, RNN_D) / np.sqrt(RNN_D)).astype(np.float32),
              "U": (rng.randn(RNN_D, RNN_D) / np.sqrt(RNN_D)).astype(np.float32),
              "h0": (0.1 * rng.randn(RNN_B, RNN_D)).astype(np.float32)}
    seeds = {"h@GRAD": rng.randn(RNN_T, RNN_B, RNN_D).astype(np.float32)}
    scope = fw.Scope(device=dev)
    for k, v in {**arrays, **seeds}.items():
        scope.new_var(k).set(v)

    def fwd_bwd():
        rnn.run(scope)
        bwd.run(scope)

    fwd_bwd()  # warm-up
    ms = time_ms(torch, fwd_bwd, iters=5, warmup=1)
    wall, busy, kernels, top = profile_call(torch, fwd_bwd)
    say(f"framework rnn: T = {RNN_T}, B = {RNN_B}, D = {RNN_D} on {card}: forward + Backward "
        f"{ms:.3f} ms, {kernels} device kernels ({kernels / RNN_T:.1f} per time step), device "
        f"busy {busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms ({busy / wall:.3f}); top:")
    for line in top[:3]:
        say(f"  {line}")
    judge_card_cpu(torch, fw, rnn, bwd, arrays, seeds, dev, "framework rnn")


def gan_pair_card_cpu(torch, P, dev, seed):
    """A GAN trainer on the card and one on the CPU holding the card's trees
    (fresh Adam states on both)."""
    from paddle_tpu_torch.models.gan import GANTrainer

    kw = dict(hidden=GAN_HIDDEN, seed=seed)
    card_t = GANTrainer(GAN_NOISE, GAN_DATA, device=dev, **kw)
    cpu_t = GANTrainer(GAN_NOISE, GAN_DATA, device="cpu", **kw)
    cpu_t.g_params, cpu_t.d_params = cpu_copy(card_t.g_params), cpu_copy(card_t.d_params)
    cpu_t.g_opt_state, cpu_t.d_opt_state = (cpu_t.g_opt.init(cpu_t.g_params),
                                            cpu_t.d_opt.init(cpu_t.d_params))
    return card_t, cpu_t


def phase_gan(torch, P, card, dev):
    """Phase 21c: the GAN trainer on the card: card vs CPU gradients and 5
    batches' losses, then 50 timed batches with syncs, kernels and busy."""
    rng = np.random.RandomState(84)
    card_t, cpu_t = gan_pair_card_cpu(torch, P, dev, seed=85)
    real = mixture_rows(rng, GAN_B, GAN_DATA)
    z = rng.randn(GAN_B, GAN_NOISE).astype(np.float32)
    rows = []
    for what, fn in (("d_step", lambda t, d: t.d_grads(torch.from_numpy(real).to(d),
                                                       torch.from_numpy(z).to(d))),
                     ("g_step", lambda t, d: t.g_grads(torch.from_numpy(z).to(d)))):
        (lc, gc), (lp, gp) = fn(card_t, dev), fn(cpu_t, torch.device("cpu"))
        err = rel_l2(torch, flat_tree(gc), flat_tree(gp))
        rows.append(f"{what} loss {lc.item():.6f} vs {lp.item():.6f}, gradients {err:.3g}")
        if not err <= FW_REL:
            raise SystemExit(f"gan: {what} gradients card vs CPU {err:.3g} > {FW_REL}")
    worst = 0.0
    rc, rp = np.random.RandomState(86), np.random.RandomState(86)
    for _ in range(GAN_CPU_BATCHES):
        batch = mixture_rows(rng, GAN_B, GAN_DATA)
        for a, b in zip(card_t.train_batch(batch, rc), cpu_t.train_batch(batch, rp)):
            worst = max(worst, abs(a - b) / abs(b))
    say(f"gan card vs CPU f32 from the same trees: {'; '.join(rows)}; {GAN_CPU_BATCHES} batches' "
        f"losses worst relative {worst:.3g} (bar {GAN_LOSS_REL})")
    if not worst <= GAN_LOSS_REL:
        raise SystemExit(f"gan: losses card vs CPU {worst:.3g} > {GAN_LOSS_REL}")
    del cpu_t
    from paddle_tpu_torch.models.gan import GANTrainer

    gan = GANTrainer(GAN_NOISE, GAN_DATA, hidden=GAN_HIDDEN, seed=87, device=dev)
    say(f"gan: noise {GAN_NOISE}, data {GAN_DATA} (gan_conf_image.py's MNIST setting), hidden "
        f"{GAN_HIDDEN}, B = {GAN_B}, Adam(1e-3, beta1 0.5) on each network, real rows from a "
        f"two-component mixture")
    batches = [mixture_rows(rng, GAN_B, GAN_DATA) for _ in range(GEN_TIMED_STEPS + 3)]
    noise = np.random.RandomState(88)
    gan.train_batch(batches[0], noise)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [gan.train_batch(b, noise) for b in batches[1:GEN_TIMED_STEPS + 1]]
    per = (time.perf_counter() - t0) / GEN_TIMED_STEPS
    d_losses = [d for d, _ in losses]
    sites = count_syncs(torch, lambda: gan.train_batch(batches[-2], noise))
    by_site = {x: sites.count(x) for x in sorted(set(sites))}
    wall, busy, kernels, top = profile_call(torch, lambda: gan.train_batch(batches[-1], noise))
    say(f"gan on {card}: {GEN_TIMED_STEPS} batches (a D step and a G step each) "
        f"{per * 1e3:.4f} ms per batch; D loss {d_losses[0]:.4f} -> {d_losses[-1]:.4f} "
        f"(min {min(d_losses):.4f}), G loss {losses[0][1]:.4f} -> {losses[-1][1]:.4f}; one "
        f"batch: {len(sites)} host syncs by site {by_site}, {kernels} device kernels, device "
        f"busy {busy * 1e3:.4f} ms of {wall * 1e3:.4f} ms ({busy / wall:.3f}); top:")
    for line in top[:3]:
        say(f"  {line}")
    if not np.isfinite(losses).all():
        raise SystemExit("gan: a loss is not finite")
    if not min(d_losses) < 2 * np.log(2):
        raise SystemExit("gan: D never beat chance (2 ln 2)")
    if len(sites) != 2 or any(not x.startswith("paddle_tpu_torch/models/gan.py") for x in sites):
        raise SystemExit(f"gan: a batch must sync exactly at its two loss reads: {by_site}")
    return gan


def phase_vae(torch, P, card, dev):
    """Phase 21d: the VAE trainer on the card: card vs CPU at one eps, then
    50 timed steps with syncs, kernels and busy."""
    from paddle_tpu_torch.models.vae import VAETrainer

    kw = dict(latent_dim=VAE_LATENT, hidden=VAE_HIDDEN, lr=1e-3, seed=89)
    vae = VAETrainer(VAE_DATA, device=dev, **kw)
    cpu = VAETrainer(VAE_DATA, device="cpu", **kw)
    cpu.params = cpu_copy(vae.params)
    rng = np.random.RandomState(90)
    x = mixture_rows(rng, VAE_B, VAE_DATA)
    eps = rng.randn(VAE_B, VAE_LATENT).astype(np.float32)
    lc, gc = vae.loss_grads(vae.params, torch.from_numpy(x).to(dev), torch.from_numpy(eps).to(dev))
    lp, gp = cpu.loss_grads(cpu.params, torch.from_numpy(x), torch.from_numpy(eps))
    g_err = rel_l2(torch, flat_tree(gc), flat_tree(gp))
    l_err = abs(lc.item() - lp.item()) / abs(lp.item())
    r_err = rel_l2(torch, {"r": torch.from_numpy(vae.reconstruct(x))},
                   {"r": torch.from_numpy(cpu.reconstruct(x))})
    say(f"vae card vs CPU f32 at one eps: loss {lc.item():.6f} vs {lp.item():.6f} ({l_err:.3g}), "
        f"gradients {g_err:.3g}, reconstruct of {VAE_B} rows {r_err:.3g} (bar {FW_REL})")
    if not max(l_err, g_err, r_err) <= FW_REL:
        raise SystemExit("vae: card and CPU disagree")
    del cpu
    say(f"vae: data {VAE_DATA}, hidden {VAE_HIDDEN}, latent {VAE_LATENT}, B = {VAE_B}, Adam(1e-3)")
    batches = [mixture_rows(rng, VAE_B, VAE_DATA) for _ in range(GEN_TIMED_STEPS + 3)]
    vae.train_batch(batches[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [vae.train_batch(b) for b in batches[1:GEN_TIMED_STEPS + 1]]
    per = (time.perf_counter() - t0) / GEN_TIMED_STEPS
    sites = count_syncs(torch, lambda: vae.train_batch(batches[-2]))
    by_site = {x: sites.count(x) for x in sorted(set(sites))}
    wall, busy, kernels, top = profile_call(torch, lambda: vae.train_batch(batches[-1]))
    say(f"vae on {card}: {GEN_TIMED_STEPS} steps {per * 1e3:.4f} ms per step, loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}; one step: {len(sites)} host syncs by site "
        f"{by_site}, {kernels} device kernels, device busy {busy * 1e3:.4f} ms of "
        f"{wall * 1e3:.4f} ms ({busy / wall:.3f}); top:")
    for line in top[:3]:
        say(f"  {line}")
    if not (np.isfinite(losses).all() and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise SystemExit("vae: the loss did not fall")
    return vae


def phase_surface(torch, P, gan, vae, dev):
    """Phase 21e: save_model/load_model and merge_model/load_merged_model
    round-trip the GAN's generator on the card; make_diagram of the VAE's
    encoder."""
    import tempfile

    from paddle_tpu_torch import model
    from paddle_tpu_torch.utils import model_tools

    z = torch.from_numpy(np.random.RandomState(91).randn(64, GAN_NOISE).astype(np.float32)).to(dev)
    with torch.no_grad():
        before = gan.generate(gan.g_params, z)
    params = P.parameters.Parameters(gan.g_net, gan.g_params)
    with tempfile.TemporaryDirectory() as d:
        for what, save, load in (
                ("save_model/load_model", lambda f: model.save_model(params, f),
                 lambda p, f: model.load_model(p, f)),
                ("merge_model/load_merged_model", lambda f: model_tools.merge_model(params, f),
                 lambda p, f: model_tools.load_merged_model(f, p))):
            path = os.path.join(d, "g.bundle")
            save(path)
            fresh = P.parameters.Parameters(gan.g_net, gan.g_net.init_params(92, dev))
            load(fresh, path)
            with torch.no_grad():
                after = gan.generate(fresh.params, z)
            same = torch.equal(after, before)
            say(f"surface: {what} of the GAN's generator ({os.path.getsize(path)} bytes) on "
                f"{after.device}: generated samples equal before and after: {same}")
            if not same:
                raise SystemExit(f"surface: {what} did not round-trip the generator")
    dot = model_tools.make_diagram(vae.enc.topology)
    say(f"surface: make_diagram of the VAE's encoder: {len(dot.splitlines())} lines")


def phase_framework_gen(torch, P, fa, card):
    """Phase 21: the op framework, the GAN and VAE trainers and the v2 surface
    in f32 (TF32 off); no flash kernel may launch."""
    dev = torch.device("cuda")
    P.init(seed=80, compute_dtype="float32")
    reset_counts(fa)
    t = [time.perf_counter()]
    phase_framework_mlp(torch, P, card, dev)
    t.append(time.perf_counter())
    phase_framework_rnn(torch, P, card, dev)
    t.append(time.perf_counter())
    gan = phase_gan(torch, P, card, dev)
    t.append(time.perf_counter())
    vae = phase_vae(torch, P, card, dev)
    t.append(time.perf_counter())
    phase_surface(torch, P, gan, vae, dev)
    t.append(time.perf_counter())
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("framework: phase 21 launched a flash kernel")
    say(f"framework: phase 21 split: mlp {t[1] - t[0]:.1f} s, rnn {t[2] - t[1]:.1f} s, gan "
        f"{t[3] - t[2]:.1f} s, vae {t[4] - t[3]:.1f} s, surface {t[5] - t[4]:.1f} s; flash "
        f"launches (fwd, dq, dkv) over it: {launch_counts(fa)}")


# ---------------------------------------------------------------------------
# phase 22: the training plane's feeding and fault tolerance
# ---------------------------------------------------------------------------

# (a) ResNet-50 at bench.py's bench_resnet_pipeline configuration
# (bench.py:1588-1614): 512 records of uint8 224x224x3 pixels and a label
# byte in a recordio file, read by io.recordio.Prefetcher, batched on the
# host, the uint8 batch copied to the card and normalised there by the data
# layer's feed_dtype="uint8" / feed_scale=1/255; B=128, bf16 over f32
# masters, Momentum at phase 8's rate (0.01, 0.9)
PL_RECORDS, PL_STEPS, PL_ECHO, PL_ECHO_TRANSFERS, PL_EPOCHS = 512, 24, 2, 12, 3
PL_CHECK_BATCHES = 8  # arms 1 and 2 held bit for bit over these batches
PL_TRACE_STEPS = 3  # steps in each profiled window
PL_BIG_COPY = 1 << 20  # a host-to-device copy at least this large carries pixels
# (c) the robustness plane on (a)'s ResNet-50 through SGD.train.  Its pixels
# are f32: a uint8 slot cannot hold the NaN chaos.poison_batch writes (it
# poisons the first floating-point slot, as the JAX package's does)
RB_BATCHES, RB_PERIOD, RB_SIGTERM_AT, RB_NAN_AT = 8, 2, 5, 3
# (b) AlexNet at bench_alexnet's uint8 feed (bench.py:2186-2197) and SSD300
# at phase 20a's configuration, each through SGD.train fed inline and on the
# prefetch thread, in turns
FEED_STEPS, FEED_ROUNDS, FEED_TRACE_STEPS = 4, 2, 2


def set_deterministic(torch, on: bool) -> str:
    """cuDNN's deterministic algorithms (benchmark off) for the bit-identity
    checks, or the autotuned ones the timed arms use; returns the mode's
    tag, which every line of phase 22 carries."""
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = not on
    return "[deterministic]" if on else "[autotuned]"


def trace_window(torch, fn, what):
    """(wall s, trace events) of one call of fn under torch.profiler, from
    its Chrome trace (each event's stream, thread and copy kind); while a
    window records no device event, fn runs in a fresh one, PROFILE_TRIES
    in all.  The events are [] when no window recorded any."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    for n in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
        if any(e.get("cat") in ("kernel", "gpu_memcpy") for e in events):
            return wall, events
        say(f"{what}: profiler window {n} of {PROFILE_TRIES} recorded no device time")
    return wall, []


def window_report(events, wall):
    """Busy share (the union of the device's kernel, copy and memset
    intervals over the wall time), the host-to-device copies, the streams
    the kernels ran on, the top device items and the main thread's kernel
    launches of one traced window."""
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    h2d = [e for e in dev if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    streams = {e.get("args", {}).get("stream", e.get("tid")) for e in dev
               if e.get("cat") == "kernel"}
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:5]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name", "").startswith("cudaLaunchKernel")]
    by_tid = {}
    for e in launches:
        by_tid.setdefault(e.get("tid"), []).append(float(e["dur"]))
    main = max(by_tid.values(), key=len) if by_tid else []
    return {
        "busy": busy / 1e6 / wall if wall > 0 else float("nan"),
        "h2d": [(e["name"], e.get("args", {}).get("bytes"),
                 e.get("args", {}).get("stream", e.get("tid"))) for e in h2d],
        "compute_streams": streams,
        "top": [f"{us / 1e3:8.3f} ms  {name[:80]}" for name, us in top],
        "launches": len(main),
        "launch_us": float(np.mean(main)) if main else float("nan"),
        "launch_rate": len(main) / wall if wall > 0 else float("nan"),
    }


def h2d_bytes(rep) -> str:
    sizes = [b for _, b, _ in rep["h2d"]]
    if any(b is None for b in sizes):
        return f"{len(sizes)} copies (bytes not in the trace)"
    return f"{sum(sizes)} bytes in {len(sizes)} copies"


def pipeline_records(path, rng):
    from paddle_tpu_torch.io import recordio

    recordio.write_records(path, (
        rng.randint(0, 256, size=RN_IMG * RN_IMG * 3, dtype=np.uint8).tobytes()
        + bytes([rng.randint(100)]) for _ in range(PL_RECORDS)), max_chunk_records=64)


def record_batches(path):
    """Host batches of RN_BATCH (uint8 pixels, label) samples from the
    recordio file through io.recordio.Prefetcher, pass after pass."""
    from paddle_tpu_torch.io import recordio

    while True:
        pf = recordio.Prefetcher([path])
        try:
            batch = []
            while True:
                rec = pf.next()
                if rec is None:
                    break
                batch.append((np.frombuffer(rec[:-1], np.uint8), rec[-1]))
                if len(batch) == RN_BATCH:
                    yield batch
                    batch = []
        finally:
            pf.close()


def tree_crc(torch, t) -> int:
    import zlib

    return zlib.crc32(t.detach().cpu().contiguous().numpy().tobytes())


def phase_pipeline(torch, P, card):
    """Phase 22a: the ResNet-50 pipeline's five arms in turns, their
    windows, and the bit-identity checks."""
    import itertools
    import tempfile

    from paddle_tpu_torch.models.resnet import resnet_cost
    from paddle_tpu_torch.reader.feeder import DataFeeder, feed_dtypes_of
    from paddle_tpu_torch.reader.pass_cache import PassCache
    from paddle_tpu_torch.reader.prefetch import DevicePrefetcher
    from paddle_tpu_torch.trainer.step import (
        draw_seed, fetch_metrics, make_epoch_program, make_train_carry, split_train_carry)

    P.init(seed=61, compute_dtype="bfloat16")
    cost, _ = resnet_cost(depth=RN_DEPTH, class_num=RN_CLASSES, img_size=RN_IMG)
    topo = P.Topology(cost)
    topo.layers["image"].attrs["feed_dtype"] = "uint8"
    topo.layers["image"].attrs["feed_scale"] = 1.0 / 255.0
    net = P.CompiledNetwork(topo)
    opt = P.optimizer.Momentum(learning_rate=RN_LR, momentum=0.9)
    step = P.trainer.make_train_step(net, opt)
    feeder = DataFeeder(topo.data_types(), RN_FEEDING, feed_dtypes=feed_dtypes_of(topo),
                        device="cuda")
    params, state = net.init(seed=61)
    st = {"params": params, "state": state, "opt": opt.init(params),
          "gen": torch.Generator().manual_seed(62)}
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "train.rio")
    pipeline_records(path, np.random.RandomState(0))
    src = record_batches(path)
    mode = set_deterministic(torch, False)

    def run(batches, n):
        costs = []
        for _ in range(n):
            b = DataFeeder.consume(next(batches))
            st["params"], st["state"], st["opt"], m = step(
                st["params"], st["state"], st["opt"], b, draw_seed(st["gen"]))
            costs.append(float(m["cost"]))
        return costs

    def timed(what, fn, steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        costs = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        say(f"pipeline {mode} arm {what}: {steps} steps in {dt:.4f} s, {dt / steps:.4f} s/step, "
            f"{RN_BATCH * steps / dt:.2f} images/s; costs {costs[0]:.4f} .. {costs[-1]:.4f}")
        if not all(np.isfinite(costs)):
            raise SystemExit(f"pipeline: arm {what} gave a non-finite cost")
        return dt / steps

    def inline(n):
        return run((feeder(s) for s in src), n)

    def prefetched(n):
        pf = DevicePrefetcher(src, feeder.stage, depth=2)
        try:
            return run(pf, n), pf
        finally:
            pf.close()

    t0 = time.perf_counter()
    inline(2)  # cuDNN autotuning, the allocator
    prefetched(2)
    say(f"pipeline {mode}: ResNet-{RN_DEPTH} B={RN_BATCH} from {PL_RECORDS} recordio records "
        f"(uint8 pixels, feed_scale 1/255), warm-up {time.perf_counter() - t0:.2f} s")
    secs = {"1 inline": timed("1 inline", lambda: inline(PL_STEPS), PL_STEPS)}
    pf = DevicePrefetcher(src, feeder.stage, depth=2)
    DataFeeder.consume(next(pf))  # fill the double buffer before the clock
    pf.wait_s = 0.0
    secs["2 prefetch"] = timed("2 prefetch", lambda: run(pf, PL_STEPS), PL_STEPS)
    wait_s = pf.wait_s
    pf.close()
    say(f"pipeline {mode} arm 2: the consumer waited {wait_s:.4f} s on the queue over "
        f"{PL_STEPS} steps")

    def echo():
        pf = DevicePrefetcher(src, feeder.stage, depth=2)
        try:
            return run((b for bb in itertools.islice(pf, PL_ECHO_TRANSFERS)
                        for b in (bb,) * PL_ECHO), PL_ECHO * PL_ECHO_TRANSFERS)
        finally:
            pf.close()

    secs["3 echo"] = timed(f"3 echo x{PL_ECHO} ({PL_ECHO_TRANSFERS} transfers)", echo,
                           PL_ECHO * PL_ECHO_TRANSFERS)

    n_pass = PL_RECORDS // RN_BATCH
    cache = PassCache(seed=61)
    pf = DevicePrefetcher(src, feeder.stage, depth=2)
    for b in cache.capture(itertools.islice(pf, n_pass)):
        DataFeeder.consume(b)
    pf.close()
    first = cache.sample_batch()["image"].data
    crc0 = tree_crc(torch, first)
    stacked = cache.stacked()
    prog = make_epoch_program(net, opt)

    def stepwise_epochs(passes):
        out = []
        for p in passes:
            out += run(iter(cache.epoch(p)), n_pass)
        return out

    def program_epochs(passes):
        out = []
        for p in passes:
            carry = make_train_carry(st["params"], st["state"], st["opt"], st["gen"])
            carry, ms = prog(carry, stacked, cache.epoch_perm(p))
            host = fetch_metrics({**ms, "skipped": carry["skipped"]})
            if float(host["skipped"]):
                raise SystemExit(f"pipeline: the epoch program skipped a step in pass {p}")
            st["params"], st["state"], st["opt"], st["gen"] = split_train_carry(carry)
            out += [float(c) for c in host["cost"]]
        return out

    stepwise_epochs([0])
    program_epochs([0])
    secs["4 cached stepwise"] = timed(f"4 cached stepwise ({PL_EPOCHS} passes of {n_pass})",
                                      lambda: stepwise_epochs(range(1, 1 + PL_EPOCHS)),
                                      PL_EPOCHS * n_pass)
    secs["5 epoch program"] = timed(f"5 epoch program ({PL_EPOCHS} passes of {n_pass})",
                                    lambda: program_epochs(range(1, 1 + PL_EPOCHS)),
                                    PL_EPOCHS * n_pass)
    say(f"pipeline {mode}: s/step by arm " + ", ".join(f"{k} {v:.4f}" for k, v in secs.items())
        + f" on {card}")
    say(f"pipeline: pass cache {cache.summary()}")

    # isolated host-to-device copy of one uint8 batch, best of 3
    arr = np.stack([s[0] for s in next(src)])
    rates = {}
    for kind in ("pageable", "pinned"):
        host = torch.from_numpy(arr)
        if kind == "pinned":
            host = host.pin_memory()
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host.to("cuda", non_blocking=(kind == "pinned"))
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        rates[kind] = arr.nbytes / best / 1e9
    say(f"pipeline: one uint8 batch ({arr.nbytes} bytes) to the card alone: pinned "
        f"{rates['pinned']:.2f} GB/s, pageable {rates['pageable']:.2f} GB/s")

    # windows of arms 1, 2 and 4
    reps = {}
    wall, ev = trace_window(torch, lambda: inline(PL_TRACE_STEPS), "pipeline arm 1")
    reps["1 inline"] = window_report(ev, wall)
    wall, ev = trace_window(torch, lambda: prefetched(PL_TRACE_STEPS), "pipeline arm 2")
    reps["2 prefetch"] = window_report(ev, wall)
    wall, ev = trace_window(torch, lambda: stepwise_epochs([PL_EPOCHS + 1]), "pipeline arm 4")
    reps["4 cached stepwise"] = window_report(ev, wall)
    wall, ev = trace_window(torch, lambda: program_epochs([PL_EPOCHS + 2]), "pipeline arm 5")
    reps["5 epoch program"] = window_report(ev, wall)
    for k, r in reps.items():
        say(f"pipeline {mode} window arm {k}: busy {r['busy']:.3f}, host-to-device "
            f"{h2d_bytes(r)}, kernel streams {sorted(map(str, r['compute_streams']))}, main-"
            f"thread launches {r['launches']} at {r['launch_us']:.2f} us per call, "
            f"{r['launch_rate']:.0f} per s of the window; top:")
        for line in r["top"]:
            say(f"    {line}")
    big = [(n, b, s) for n, b, s in reps["2 prefetch"]["h2d"] if b is None or b >= PL_BIG_COPY]
    pinned = bool(big) and all("Pinned" in n for n, _, _ in big)
    apart = bool(big) and not ({s for _, _, s in big} & reps["2 prefetch"]["compute_streams"])
    say(f"pipeline: arm 2's pixel copies {[(n, b, s) for n, b, s in big]}: pinned {pinned}, on "
        f"a stream apart from the compute kernels' {apart}")
    if not (pinned and apart):
        raise SystemExit("pipeline: the prefetched pixel copies are not pinned copies on a "
                         "side stream")
    if any(n for n, b, _ in reps["2 prefetch"]["h2d"] if "Pageable" in n
           and (b is None or b >= PL_BIG_COPY)):
        raise SystemExit("pipeline: a pageable pixel copy is left in arm 2's window")
    for k in ("4 cached stepwise", "5 epoch program"):
        say(f"pipeline: host-to-device per cached pass, arm {k}: {h2d_bytes(reps[k])}")
    # the first set_sync_debug_mode of a process reports one sync at its own
    # line (seen when this phase runs alone): spend it on an empty window
    count_syncs(torch, lambda: None)
    syncs4 = count_syncs(torch, lambda: stepwise_epochs([PL_EPOCHS + 3]))
    syncs5 = count_syncs(torch, lambda: program_epochs([PL_EPOCHS + 4]))
    say(f"pipeline: host syncs per cached pass of {n_pass} steps: arm 4 {len(syncs4)} "
        f"({sorted(set(syncs4))}), arm 5 {len(syncs5)} ({sorted(set(syncs5))})")
    if len(syncs5) != 1:
        raise SystemExit(f"pipeline: the epoch program made {len(syncs5)} host syncs in a pass")

    # bit identity, deterministic algorithms
    mode = set_deterministic(torch, True)
    fixed = [next(src) for _ in range(PL_CHECK_BATCHES)]
    start = clone_tree((st["params"], st["state"], st["opt"]))
    gen0 = st["gen"].get_state()

    def from_start():
        st["params"], st["state"], st["opt"] = clone_tree(start)
        st["gen"].set_state(gen0)

    from_start()
    run((feeder(s) for s in fixed), PL_CHECK_BATCHES)
    inline_end = clone_tree((st["params"], st["state"], st["opt"]))
    from_start()
    pf = DevicePrefetcher(iter(fixed), feeder.stage, depth=2)
    run(pf, PL_CHECK_BATCHES)
    pf.close()
    same12 = trees_equal(torch, (st["params"], st["state"], st["opt"]), inline_end)
    from_start()
    c4 = stepwise_epochs([PL_EPOCHS + 5])
    end4 = clone_tree((st["params"], st["state"], st["opt"]))
    from_start()
    c5 = program_epochs([PL_EPOCHS + 5])
    same45 = trees_equal(torch, (st["params"], st["state"], st["opt"]), end4) and c4 == c5
    crc1 = tree_crc(torch, first)
    say(f"pipeline {mode}: arms 1 and 2 after the same {PL_CHECK_BATCHES} batches: params, "
        f"batch-norm state and momentum bit-identical {same12}; arms 4 and 5 after one cached "
        f"pass: bit-identical {same45} (costs {[round(c, 6) for c in c4]} and "
        f"{[round(c, 6) for c in c5]}); a cached batch's crc32 {crc0:#010x} before the cached "
        f"passes, {crc1:#010x} after")
    set_deterministic(torch, False)
    if not same12 or not same45 or crc0 != crc1:
        raise SystemExit("pipeline: a bit-identity check failed")
    cache.drop()
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return reps


def feed_arms(torch, P, name, make_trainer, feeding, batches, card):
    """Phase 22b for one model: SGD.train fed inline and on the prefetch
    thread, in turns, timed and traced, then the parameters after
    FEED_STEPS steps from one start, deterministic."""
    mode = set_deterministic(torch, False)
    trainer = make_trainer()

    def train(async_load, n):
        trainer.train(lambda: iter(batches[:n]), feeding=feeding, async_load_data=async_load)

    train(False, 1)  # cuDNN autotuning, the allocator
    train(True, 1)
    secs = {True: [], False: []}
    for _ in range(FEED_ROUNDS):
        for async_load in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train(async_load, FEED_STEPS)
            torch.cuda.synchronize()
            secs[async_load].append((time.perf_counter() - t0) / FEED_STEPS)
    reps = {}
    for async_load in (True, False):
        wall, ev = trace_window(torch, lambda: train(async_load, FEED_TRACE_STEPS),
                                f"{name} feed")
        reps[async_load] = window_report(ev, wall)
    for async_load, label in ((True, "prefetch"), (False, "inline")):
        r = reps[async_load]
        say(f"{name} {mode} {label}: s/step {[round(s, 4) for s in secs[async_load]]}, busy "
            f"{r['busy']:.3f}, host-to-device {h2d_bytes(r)}, main-thread launches "
            f"{r['launches']} at {r['launch_us']:.2f} us per call, {r['launch_rate']:.0f} per s "
            f"on {card}; top:")
        for line in r["top"]:
            say(f"    {line}")
    # one batch per train call (phase 20a's one_step): nothing to overlap;
    # the feed's parts timed alone on the main thread
    single = {True: [], False: []}
    for _ in range(FEED_ROUNDS):
        for async_load in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train(async_load, 1)
            torch.cuda.synchronize()
            single[async_load].append(time.perf_counter() - t0)
    feeder = trainer._make_feeder(feeding)
    t0 = time.perf_counter()
    host = feeder.convert(batches[0])
    convert_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feeder.upload(host)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    feeder.upload(host, staged=True)
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    say(f"{name} {mode}: one batch per train call, s per call prefetched "
        f"{[round(x, 4) for x in single[True]]}, inline {[round(x, 4) for x in single[False]]}; "
        f"the feed alone: convert on the host {convert_s:.4f} s, synchronous upload "
        f"{upload_s:.4f} s, staged upload {issue_s:.4f} s to pin and issue, {staged_s:.4f} s "
        f"until the copy landed")
    pageable = [(n, b) for n, b, _ in reps[True]["h2d"]
                if "Pageable" in n and (b is None or b >= PL_BIG_COPY)]
    say(f"{name}: pageable pixel copies in the prefetch window {pageable}, in the inline "
        f"window {[(n, b) for n, b, _ in reps[False]['h2d'] if 'Pageable' in n][:3]}")
    if pageable:
        raise SystemExit(f"{name}: a pageable pixel copy is left in the prefetch window")
    del trainer
    mode = set_deterministic(torch, True)
    ends = {}
    for async_load in (True, False):
        t = make_trainer()
        costs = []
        t.train(lambda: iter(batches[:FEED_STEPS]), feeding=feeding, async_load_data=async_load,
                event_handler=lambda e: costs.append(e.cost)
                if isinstance(e, P.event.EndIteration) else None)
        ends[async_load] = (clone_tree(t.parameters.params), costs)
        del t
    same = trees_equal(torch, ends[True][0], ends[False][0]) and ends[True][1] == ends[False][1]
    say(f"{name} {mode}: prefetch and inline after {FEED_STEPS} steps from one start: params "
        f"and costs bit-identical {same} (costs {[round(c, 5) for c in ends[True][1]]})")
    set_deterministic(torch, False)
    if not same:
        raise SystemExit(f"{name}: the prefetched run left the inline one")
    return secs, reps


def phase_feed_models(torch, P, card):
    """Phase 22b: AlexNet (uint8 pixels) and SSD300 (f32 pixels)."""
    P.init(seed=71, compute_dtype="bfloat16")
    ax_cost, _ = alexnet_cost(P, feed_dtype="uint8", feed_scale=1 / 255.0, feed_shift=-0.5)
    rng = np.random.RandomState(71)
    pix = rng.randint(0, 256, size=(FEED_STEPS * AX_BATCH, 3 * AX_IMG * AX_IMG), dtype=np.uint8)
    labels = rng.randint(0, AX_CLASSES, size=len(pix))
    ax_batches = [[(pix[i], int(labels[i])) for i in range(k * AX_BATCH, (k + 1) * AX_BATCH)]
                  for k in range(FEED_STEPS)]
    say(f"alexnet feed: bench_alexnet's uint8 pixels with feed_scale 1/255, feed_shift -0.5, "
        f"B={AX_BATCH}: {pix[:AX_BATCH].nbytes} bytes of pixels per batch")
    feed_arms(torch, P, "alexnet feed", lambda: P.trainer.SGD(
        ax_cost, P.parameters.create(ax_cost, seed=71), P.optimizer.Momentum(
            learning_rate=AX_LR, momentum=0.9,
            regularization=P.optimizer.L2Regularization(rate=AX_L2))),
        AX_FEEDING, ax_batches, card)
    torch.cuda.empty_cache()
    P.init(seed=72, compute_dtype="bfloat16")
    ssd_cost, _, _ = ssd300(P)
    srng = np.random.RandomState(72)
    ssd_batches = [ssd_samples(srng, SSD_B) for _ in range(FEED_STEPS)]
    feed_arms(torch, P, "ssd feed", lambda: P.trainer.SGD(
        ssd_cost, P.parameters.create(ssd_cost, seed=72), P.optimizer.Momentum(
            learning_rate=SSD_LR, momentum=0.9,
            regularization=P.optimizer.L2Regularization(rate=SSD_L2))),
        SSD_FEEDING, ssd_batches, card)


def phase_robust(torch, P, card):
    """Phase 22c: the robustness plane on ResNet-50 through SGD.train with
    checkpoint_dir, deterministic algorithms throughout."""
    import signal
    import shutil
    import tempfile

    from paddle_tpu_torch.models.resnet import resnet_cost
    from paddle_tpu_torch.robustness import chaos, read_marker
    from paddle_tpu_torch.utils.timers import global_stats

    mode = set_deterministic(torch, True)
    P.init(seed=81, compute_dtype="bfloat16")
    cost, _ = resnet_cost(depth=RN_DEPTH, class_num=RN_CLASSES, img_size=RN_IMG)
    data = [resnet_images(np.random.RandomState(81 + k), RN_BATCH) for k in range(RB_BATCHES)]
    reader = lambda: iter(data)  # noqa: E731 — batches of RN_BATCH samples
    tmp = tempfile.mkdtemp()

    def trainer(seed):
        return P.trainer.SGD(cost, P.parameters.create(cost, seed=seed), P.optimizer.Momentum(
            learning_rate=RN_LR, momentum=0.9), seed=seed)

    # a poisoned step is skipped, the state bit-identical across it
    t = trainer(81)
    chaos.arm(f"nan_batch@{RB_NAN_AT}")
    seen = {}

    def around(e):
        if isinstance(e, P.event.BeginIteration) and e.batch_id == RB_NAN_AT - 1:
            seen["before"] = clone_tree((t.parameters.params, t._opt_state))
        if isinstance(e, P.event.EndIteration) and e.batch_id == RB_NAN_AT - 1:
            seen["cost"] = e.cost
            seen["same"] = trees_equal(torch, (t.parameters.params, t._opt_state),
                                       seen["before"])

    skipped0 = global_stats.count("robustness.skipped_steps")
    t.train(lambda: iter(data[:4]), feeding=RN_FEEDING, event_handler=around,
            checkpoint_dir=os.path.join(tmp, "poison"), checkpoint_period_batches=RB_PERIOD)
    chaos.disarm()
    skipped = global_stats.count("robustness.skipped_steps") - skipped0
    say(f"robust {mode}: nan_batch@{RB_NAN_AT}: cost {seen.get('cost')}, {skipped} step "
        f"skipped, params and momentum bit-identical across it {seen.get('same')}")
    if skipped != 1 or not seen.get("same") or np.isfinite(seen.get("cost", 0.0)):
        raise SystemExit("robust: the poisoned step was not skipped with the state unchanged")
    del t

    # rollback and quarantine (tests/test_robustness.py:264-284's drive)
    P.flags.set_flag("sentinel_skip_limit", 1)
    P.flags.set_flag("failure_max", 3)
    rb0 = global_stats.count("robustness.rollbacks")
    q0 = global_stats.count("robustness.quarantined_batches")
    t = trainer(82)
    chaos.arm("nan_batch@1")
    t0 = time.perf_counter()
    t.train(lambda: iter(data[:3]), feeding=RN_FEEDING,
            checkpoint_dir=os.path.join(tmp, "rollback"))
    chaos.disarm()
    P.flags.set_flag("sentinel_skip_limit", 3)
    P.flags.set_flag("failure_max", 3)
    rb = global_stats.count("robustness.rollbacks") - rb0
    q = global_stats.count("robustness.quarantined_batches") - q0
    finite = all(bool(torch.isfinite(v).all()) for p in t.parameters.params.values()
                 for v in p.values())
    say(f"robust {mode}: nan_batch@1 with sentinel_skip_limit=1, failure_max=3: {rb} rollbacks, "
        f"{q} batch quarantined, parameters finite {finite} ({time.perf_counter() - t0:.2f} s)")
    if rb != 3 or q != 1 or not finite:
        raise SystemExit("robust: the poisoned window was not rolled back 3 times and "
                         "quarantined")
    del t

    # checkpoint bytes and seconds
    manager = P.checkpoint.CheckpointManager(os.path.join(tmp, "timing"))
    t = trainer(83)
    t0 = time.perf_counter()
    t.save_checkpoint(manager, step=1)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    t.restore_checkpoint(manager)
    restore_s = time.perf_counter() - t0
    say(f"robust: one full-state checkpoint {dir_bytes(os.path.join(tmp, 'timing'))} bytes, "
        f"save {save_s:.3f} s, restore {restore_s:.3f} s")
    del t

    # preemption and resume, against an uninterrupted run
    ref = trainer(84)
    ref.train(reader, feeding=RN_FEEDING)
    ck = os.path.join(tmp, "preempt")
    t = trainer(84)
    steps = [0]

    def sigterm(e):
        if isinstance(e, P.event.EndIteration):
            steps[0] += 1
            if steps[0] == RB_SIGTERM_AT:
                os.kill(os.getpid(), signal.SIGTERM)

    t.train(reader, feeding=RN_FEEDING, event_handler=sigterm, checkpoint_dir=ck,
            checkpoint_period_batches=RB_PERIOD)
    marker = read_marker(ck)
    resumed = trainer(85)  # another seed: the restored state must win
    resumed.train(reader, feeding=RN_FEEDING, checkpoint_dir=ck, resume=True)
    same = trees_equal(torch, resumed.parameters.params, ref.parameters.params) and \
        trees_equal(torch, resumed._opt_state, ref._opt_state)
    say(f"robust {mode}: SIGTERM at step {RB_SIGTERM_AT}: preempted {t.preempted}, marker "
        f"{marker}; a trainer of another seed resumed and finished: params and momentum "
        f"bit-identical to an uninterrupted run {same}; the marker consumed "
        f"{read_marker(ck) is None}")
    set_deterministic(torch, False)
    shutil.rmtree(tmp, ignore_errors=True)
    if not t.preempted or not marker or not marker.get("preempted") or not same:
        raise SystemExit("robust: preemption and resume did not continue the run bit for bit")


def phase_training_plane(torch, P, fa, card):
    """Phase 22: (a) the ResNet-50 pipeline, (b) AlexNet and SSD300 fed
    inline and prefetched, (c) the robustness plane; no flash kernel may
    launch."""
    reset_counts(fa)
    t = [time.perf_counter()]
    phase_pipeline(torch, P, card)
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    phase_feed_models(torch, P, card)
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    phase_robust(torch, P, card)
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("training plane: phase 22 launched a flash kernel")
    say(f"training plane: phase 22 split: pipeline {t[1] - t[0]:.1f} s, feed {t[2] - t[1]:.1f} s, "
        f"robust {t[3] - t[2]:.1f} s; flash launches (fwd, dq, dkv) over it: {launch_counts(fa)}")


# ---------------------------------------------------------------------------
# phase 23: elastic fleets of worker processes sharing the one card
# ---------------------------------------------------------------------------
# (a) LeNet-5 at BASELINE config #1 (28x28x1, 10 classes, Momentum, f32):
# 4,096 seeded records of uint8 pixels and a label byte, 64 per chunk,
# chunks_per_task 2: 128 rows and 32 tasks a pass, 2 passes
EL_LN_RECORDS, EL_CHUNK, EL_CPT, EL_PASSES = 4096, 64, 2, 2
EL_LN_LR = 0.01
EL_LN_TASKS = EL_LN_RECORDS // (EL_CHUNK * EL_CPT)
# (b) ResNet-50 at bench_resnet_pipeline's configuration on phase 22a's
# records (PL_RECORDS uint8 224x224x3 and a label byte, 64 per chunk): 4
# tasks of RN_BATCH a pass, bf16 over f32 masters, quantized contributions
EL_RN_TASKS = PL_RECORDS // (EL_CHUNK * EL_CPT)
EL_CHUNK_BYTES = 1 << 30  # chunks end at EL_CHUNK records, never at the 1 MiB default
# a pass's result map rides one frame: LeNet's 32 f32 contributions of
# ~5 MB and ResNet's 4 quantized ones of ~26 MB are both over the 64 MB
# default, so the master and every worker run at 256 MB
EL_RPC_MB = 256
# the master: worker leases of 10 s (a worker's first task pays for CUDA
# start-up; its heartbeat thread holds the lease through it), task leases
# of 120 s, a 6 s HA lease; the hung worker sleeps past its lease
EL_MASTER = dict(chunks_per_task=EL_CPT, timeout_s=120.0, worker_timeout_s=10.0,
                 auto_rotate=False, lease_timeout=6.0)
EL_HANG_S = 14
EL_MEM_SLACK = 256 << 20  # free card memory must come back within this after a fleet
EL_DETERMINISM = ("cudnn.deterministic=True, cudnn.benchmark=False, "
                  "use_deterministic_algorithms(True, warn_only=True), "
                  "CUBLAS_WORKSPACE_CONFIG=:4096:8, TF32 off")


def el_lenet(P, seed, dev):
    """LeNet-5's trainer and record decoder, as a worker builds them (layer
    names from a fresh counter, so this process's earlier phases do not
    rename the checkpoint's leaves)."""
    from paddle_tpu_torch.core.topology import reset_auto_names
    from paddle_tpu_torch.models.lenet import lenet_cost

    reset_auto_names()
    P.init(seed=seed, compute_dtype="float32", device=dev)
    cost, _ = lenet_cost(class_num=10)
    trainer = P.trainer.SGD(cost, P.parameters.create(cost, seed=seed, device=dev),
                            P.optimizer.Momentum(learning_rate=EL_LN_LR, momentum=0.9),
                            seed=seed, device=dev)

    def decode(rec):
        return np.frombuffer(rec[:-1], np.uint8).astype(np.float32) / 255.0, rec[-1]

    return trainer, decode


def el_resnet(P, seed, dev):
    """ResNet-50's trainer at phase 22a's feed (uint8 pixels, feed_scale
    1/255, bf16) and its record decoder."""
    from paddle_tpu_torch.core.topology import reset_auto_names
    from paddle_tpu_torch.models.resnet import resnet_cost

    reset_auto_names()
    P.init(seed=seed, compute_dtype="bfloat16", device=dev)
    cost, _ = resnet_cost(depth=RN_DEPTH, class_num=RN_CLASSES, img_size=RN_IMG)
    image = P.Topology(cost).layers["image"]
    image.attrs["feed_dtype"] = "uint8"
    image.attrs["feed_scale"] = 1.0 / 255.0
    trainer = P.trainer.SGD(cost, P.parameters.create(cost, seed=seed, device=dev),
                            P.optimizer.Momentum(learning_rate=RN_LR, momentum=0.9),
                            seed=seed, device=dev)

    def decode(rec):
        return np.frombuffer(rec[:-1], np.uint8), rec[-1]

    return trainer, decode


def state_digest(tree) -> str:
    """sha256 over a state tree's leaves in sorted key order (tensors as
    their host bytes)."""
    import hashlib

    h = hashlib.sha256()

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
            return
        a = t.detach().cpu().contiguous().numpy() if hasattr(t, "detach") else np.asarray(t)
        h.update(f"{path}:{a.dtype}:{a.shape}".encode())
        h.update(a.tobytes())

    walk(tree, "")
    return h.hexdigest()


def elastic_drive(spec_json: str) -> int:
    """One worker process of phase 23 (``sys.executable -c``): the port's
    ElasticWorker over an HAClient of the fleet's directory, with the model
    built through the public API on deterministic kernels; writes its
    summary, its per-pass timings, its peak card memory and its final
    state's digest to the spec's stats file."""
    import warnings

    import torch

    spec = json.loads(spec_json)
    sys.path.insert(0, HERE)
    import paddle_tpu_torch as P
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.master_ha import HAClient
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.trainer import elastic

    dev = spec.get("device", "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    trainer, decode = (el_lenet if spec["model"] == "lenet" else el_resnet)(P, spec["seed"], dev)
    model = trainer.elastic_model(decode)
    window = 60.0
    client_kw = dict(timeout=window / 2.0, call_timeout_s=15.0)
    worker = elastic.ElasticWorker(
        HAClient(spec["dir"], **client_kw), spec["wid"], model,
        manager=CheckpointManager(spec["ckpt"]) if spec.get("ckpt") else None,
        resume=spec.get("resume", False), heartbeat_client=HAClient(spec["dir"], **client_kw),
        min_workers=spec["min_workers"], rpc_retry_window_s=window)

    times = {"fence": [], "fetch": [], "reduce": [], "apply": [], "quantize": [], "task": []}
    ends = []

    def timed(key, fn, sync=False):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if sync and dev == "cuda":
                    torch.cuda.synchronize()
                times[key].append(time.perf_counter() - t0)
                if key == "apply":
                    ends.append(time.perf_counter())
        return run

    rpc = worker._rpc
    fetch = timed("fetch", rpc)
    worker._rpc = lambda method, *args: (fetch if method == "pass_results" else rpc)(method, *args)
    worker._fence = timed("fence", worker._fence)
    elastic.reduce_results = timed("reduce", elastic.reduce_results)
    elastic._bsq.quantize_tree = timed("quantize", elastic._bsq.quantize_tree)
    model.apply = timed("apply", model.apply, sync=True)
    model.task_grad = timed("task", model.task_grad)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    boot_s = time.time() - spec["t_spawn"]
    t_start = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        summary = worker.run(spec["passes"])
    nondet = sorted({str(w.message).splitlines()[0][:160] for w in caught
                     if "determinis" in str(w.message)})
    marks = [t_start] + ends
    out = dict(summary, times=times, pass_s=[b - a for a, b in zip(marks, marks[1:])],
               boot_s=boot_s,
               digest=state_digest(model.state()), nondeterministic=nondet,
               peak_bytes=torch.cuda.max_memory_allocated() if dev == "cuda" else 0,
               flash=[fa.flash_attention.launches, fa.flash_attention_bwd.dq_launches,
                      fa.flash_attention_bwd.dkv_launches])
    with open(spec["stats"], "w") as f:
        json.dump(out, f)
    return 0


def el_records(path, n, pixels, classes, seed):
    """n seeded records of uint8 pixels and a label byte, EL_CHUNK to a
    chunk."""
    from paddle_tpu_torch.io import recordio

    rng = np.random.RandomState(seed)
    recordio.write_records(path, (
        rng.randint(0, 256, size=pixels, dtype=np.uint8).tobytes() + bytes([rng.randint(classes)])
        for _ in range(n)), max_chunk_records=EL_CHUNK, max_chunk_bytes=EL_CHUNK_BYTES)


def el_journal_bytes(hadir) -> int:
    return sum(os.path.getsize(os.path.join(hadir, f)) for f in os.listdir(hadir)
               if f.startswith("master_journal-"))


def el_wait(cond, secs, what):
    deadline = time.time() + secs
    while not cond():
        if time.time() > deadline:
            raise SystemExit(f"elastic: {what}")
        time.sleep(0.05)


def el_fleet(d, model, n, data, *, passes=EL_PASSES, chaos=None, resume=False,
             failover=False, ckpt=True, env_extra=None, dev="cuda"):
    """One fleet of n worker processes under an HA master in this process
    (with failover, a leader subprocess armed with kill_master@8 and this
    process's warm standby).  Returns what the phase prints and checks."""
    from paddle_tpu_torch.master_ha import HAMaster, discover_endpoint

    os.makedirs(d, exist_ok=True)
    hadir = os.path.join(d, "ha")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PADDLE_TPU_TORCH_RPC_MAX_MESSAGE_MB=str(EL_RPC_MB),
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **(env_extra or {}))
    leader = None
    if failover:
        leader = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch", "master", "--dir", hadir, "--patterns",
             data, "--chunks-per-task", str(EL_CPT), "--timeout-s", str(EL_MASTER["timeout_s"]),
             "--worker-timeout-s", str(EL_MASTER["worker_timeout_s"]), "--lease-timeout",
             str(EL_MASTER["lease_timeout"]), "--chaos", "kill_master@8"],
            cwd=HERE, env=env, stdout=open(os.path.join(d, "leader.log"), "w"),
            stderr=subprocess.STDOUT)
        el_wait(lambda: discover_endpoint(hadir) is not None or leader.poll() is not None, 60,
                "the leader master published no endpoint")
        ha = HAMaster(hadir, [data], owner_id="standby", **EL_MASTER)
        ha.start()
        el_wait(lambda: ha._replica is not None, 30, "the standby built no replica")
    else:
        ha = HAMaster(hadir, [data], owner_id="smoke", **EL_MASTER)
        ha.start()
        if not ha.wait_leader(30):
            raise SystemExit("elastic: the in-process master never led")
    code = ("import sys; sys.path.insert(0, sys.argv[2]); import chip_smoke as cs; "
            "sys.exit(cs.elastic_drive(sys.argv[1]))")
    procs, rcs = [], []
    t0 = time.perf_counter()
    try:
        for i in range(n):
            spec = {"model": model, "dir": hadir, "wid": f"w{i}", "passes": passes,
                    "min_workers": n, "seed": 5, "device": dev, "resume": resume,
                    "t_spawn": time.time(),
                    "ckpt": os.path.join(d, "ck") if ckpt else None,
                    "stats": os.path.join(d, f"stats-w{i}.json")}
            wenv = dict(env, **(chaos or {}).get(i, {}))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, json.dumps(spec), HERE], env=wenv,
                stdout=open(os.path.join(d, f"w{i}.log"), "w"), stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=600) for p in procs]
        secs = time.perf_counter() - t0
        if failover:
            el_wait(lambda: ha.is_leader.is_set(), 30, "the standby never took over")
        mstats = ha.service.stats()
        takeover = ha.last_takeover
        jbytes = el_journal_bytes(hadir)
    finally:
        ha.stop()
        for p in procs + ([leader] if leader else []):
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, rc in enumerate(rcs):
        if rc != 0 and not (chaos and rc == -9):
            with open(os.path.join(d, f"w{i}.log")) as f:
                tail = f.read()[-3000:]
            raise SystemExit(f"elastic: worker w{i} of {d} exited {rc}:\n{tail}")
    stats = {}
    for i in range(n):
        path = os.path.join(d, f"stats-w{i}.json")
        if os.path.exists(path):
            with open(path) as f:
                stats[i] = json.load(f)
    return {"rcs": rcs, "secs": secs, "master": mstats, "takeover": takeover,
            "journal_bytes": jbytes, "stats": stats,
            "leader_rc": leader.returncode if leader else None, "ck": os.path.join(d, "ck")}


def el_restored_digest(ck, template) -> tuple:
    from paddle_tpu_torch.checkpoint import CheckpointManager

    restored = CheckpointManager(ck).restore_latest(template)
    if restored is None:
        raise SystemExit(f"elastic: no committed manifest in {ck}")
    step, tree, extra = restored
    return step, state_digest(tree), extra


def el_check(name, r, ref_digest, ref_costs, template, *, killed=(), tasks=None):
    """Every finishing worker's final state and the restored manifest equal
    the reference bit for bit; no worker launched a flash kernel or met a
    nondeterministic op."""
    alive = [i for i in range(len(r["rcs"])) if i not in killed]
    if any(i not in r["stats"] for i in alive):
        raise SystemExit(f"elastic {name}: a surviving worker wrote no stats")
    digests = {r["stats"][i]["digest"] for i in alive}
    step, mdigest, extra = el_restored_digest(r["ck"], template)
    nondet = sorted({m for i in alive for m in r["stats"][i]["nondeterministic"]})
    flash = [r["stats"][i]["flash"] for i in alive]
    costs = r["stats"][alive[0]]["pass_costs"]
    same = digests == {ref_digest} and mdigest == ref_digest
    done = sum(s["tasks_done"] for s in r["stats"].values())
    say(f"elastic {name}: exit codes {r['rcs']}, {r['secs']:.2f} s, fail events "
        f"{r['master']['fail_events']}, tasks done {done}, manifest step {step} (pass "
        f"{extra.get('pass_id')}); final states and manifest bit-identical to (i): {same}; "
        f"pass costs {['%.6f' % c for c in costs]}; worker boot s "
        f"{['%.2f' % r['stats'][i]['boot_s'] for i in alive]}; flash launches {flash}; "
        f"nondeterministic ops {nondet or 'none'}")
    if not same:
        raise SystemExit(f"elastic {name}: the final state left (i)'s")
    if ref_costs is not None and costs != ref_costs[len(ref_costs) - len(costs):]:
        raise SystemExit(f"elastic {name}: the pass costs left (i)'s")
    if any(f != [0, 0, 0] for f in flash):
        raise SystemExit(f"elastic {name}: a worker launched a flash kernel")
    if tasks is not None and done != tasks:
        raise SystemExit(f"elastic {name}: {done} tasks done, not {tasks}")


def el_free(torch, dev) -> int:
    return torch.cuda.mem_get_info()[0] if dev == "cuda" else 0


def el_timing(name, st, per_task=False) -> str:
    t = st["times"]
    tasks = f" ({['%.3f' % x for x in t['task']]})" if per_task else ""
    return (f"elastic {name}: boot {st['boot_s']:.2f} s, s/pass "
            f"{['%.3f' % x for x in st['pass_s']]}, tasks {st['tasks_done']}, task compute "
            f"{st['busy_s']:.3f} s{tasks}, quantize {sum(t['quantize']):.3f} s, fence "
            f"{['%.3f' % x for x in t['fence']]}, fetch {['%.3f' % x for x in t['fetch']]}, "
            f"reduce {['%.3f' % x for x in t['reduce']]}, apply "
            f"{['%.3f' % x for x in t['apply']]} s; grad_payload_bytes "
            f"{st['grad_payload_bytes']}, wire_bytes_per_pass {st['wire_bytes_per_pass']}; "
            f"peak card memory {st['peak_bytes']} B")


def phase_elastic_lenet(torch, P, root, card, dev="cuda"):
    """Phase 23a: LeNet-5 fleets (i)-(vi).  (i) runs alone; (ii)-(vi) run
    at once (each under its own master), since a fleet's bits cannot
    depend on its timing; the card's free memory before (ii)-(vi) must come
    back after them, SIGKILLed workers included."""
    from concurrent.futures import ThreadPoolExecutor

    data = os.path.join(root, "lenet.rio")
    el_records(data, EL_LN_RECORDS, 784, 10, 23)
    template_trainer, _ = el_lenet(P, 5, dev)
    template = template_trainer._full_state()
    say(f"elastic lenet: {EL_LN_RECORDS} records, {EL_CHUNK} per chunk, chunks_per_task "
        f"{EL_CPT}: {EL_LN_TASKS} tasks of {EL_CHUNK * EL_CPT} rows a pass, {EL_PASSES} passes, "
        f"Momentum({EL_LN_LR}, 0.9), f32; workers on {EL_DETERMINISM}; {card}")
    r1 = el_fleet(os.path.join(root, "ln1"), "lenet", 1, data, dev=dev)
    ref = r1["stats"][0]["digest"]
    ref_costs = r1["stats"][0]["pass_costs"]
    total = EL_LN_TASKS * EL_PASSES
    el_check("(i) N=1", r1, ref, ref_costs, template, tasks=total)
    say(el_timing("(i) N=1 w0", r1["stats"][0]) + f"; {card}")

    def resumed():
        d5 = os.path.join(root, "ln5")
        first = el_fleet(d5, "lenet", 2, data, passes=1, dev=dev)
        step, _, _ = el_restored_digest(first["ck"], template)
        return step, el_fleet(d5, "lenet", 2, data, resume=True, dev=dev)

    free0 = el_free(torch, dev)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=5) as pool:
        f2 = pool.submit(el_fleet, os.path.join(root, "ln2"), "lenet", 2, data, dev=dev)
        f3 = pool.submit(el_fleet, os.path.join(root, "ln3"), "lenet", 2, data,
                         dev=dev, chaos={1: {"PADDLE_TPU_TORCH_CHAOS": "kill_worker@3"}})
        f4 = pool.submit(el_fleet, os.path.join(root, "ln4"), "lenet", 2, data,
                         dev=dev, chaos={1: {"PADDLE_TPU_TORCH_CHAOS": "worker_hang@2",
                                             "PADDLE_TPU_TORCH_CHAOS_HANG_SECS": str(EL_HANG_S)}})
        f5 = pool.submit(resumed)
        f6 = pool.submit(el_fleet, os.path.join(root, "ln6"), "lenet", 2, data,
                         failover=True, dev=dev)
        r2, r3, r4, (step5, r5), r6 = (f.result() for f in (f2, f3, f4, f5, f6))
    group_s = time.perf_counter() - t0
    deadline = time.time() + 15
    free1 = el_free(torch, dev)
    while free1 < free0 - EL_MEM_SLACK and time.time() < deadline:
        time.sleep(0.2)
        free1 = el_free(torch, dev)
    el_check("(ii) N=2", r2, ref, ref_costs, template, tasks=total)
    if r3["rcs"][1] != -9 or r3["master"]["fail_events"] < 1:
        raise SystemExit(f"elastic (iii): kill_worker@3 did not land ({r3['rcs']})")
    el_check("(iii) N=2, kill_worker@3 in w1", r3, ref, ref_costs, template, killed=(1,))
    if r4["master"]["fail_events"] < 1:
        raise SystemExit("elastic (iv): the hung worker was never pruned")
    el_check(f"(iv) N=2, worker_hang@2 ({EL_HANG_S} s) in w1: pruned, rejoined "
             f"(rejected acks {r4['stats'][1]['rejected_acks']})", r4, ref, None, template)
    el_check(f"(v) N=2 resumed from the manifest of step {step5} that a fleet stopped after "
             f"pass 1 committed", r5, ref, ref_costs, template)
    tk = r6["takeover"] or {}
    say(f"elastic (vi): leader exit {r6['leader_rc']}, the standby's takeover {tk}")
    if r6["leader_rc"] != -9 or not tk.get("warm") or not tk.get("replayed_records"):
        raise SystemExit("elastic (vi): the standby did not take over warm from a killed leader")
    el_check("(vi) N=2, kill_master@8 on the leader, warm standby", r6, ref, ref_costs,
             template, tasks=total)
    say(f"elastic lenet: (ii)-(vi) at once in {group_s:.2f} s; free card memory "
        f"{free0 >> 20} MiB before them, {free1 >> 20} MiB after (the SIGKILLed worker's "
        f"included); {card}")
    if free1 < free0 - EL_MEM_SLACK:
        raise SystemExit("elastic: the card's memory did not come back after the fleets")


def phase_elastic_resnet(root, card, dev="cuda"):
    """Phase 23b: ResNet-50 fleets at N=1 and N=2, quantized
    contributions."""
    data = os.path.join(root, "resnet.rio")
    el_records(data, PL_RECORDS, RN_IMG * RN_IMG * 3, 100, 0)
    env = {"PADDLE_TPU_TORCH_ELASTIC_QUANTIZED_GRADS": "1"}
    say(f"elastic resnet: ResNet-{RN_DEPTH} B={RN_BATCH} per task, {PL_RECORDS} records of "
        f"{EL_CHUNK} per chunk: {EL_RN_TASKS} tasks a pass, {EL_PASSES} passes, bf16, uint8 feed, "
        f"quantized contributions, rpc_max_message_mb {EL_RPC_MB}; {card}")
    runs = {}
    for n in (1, 2):
        r = el_fleet(os.path.join(root, f"rn{n}"), "resnet", n, data, ckpt=False,
                     env_extra=env, dev=dev)
        runs[n] = r
        for i, st in sorted(r["stats"].items()):
            say(el_timing(f"resnet N={n} w{i}", st, per_task=True) + f"; pass costs "
                f"{['%.6f' % c for c in st['pass_costs']]}; flash launches {st['flash']}; "
                f"nondeterministic ops {st['nondeterministic'] or 'none'}")
        say(f"elastic resnet N={n}: fleet {r['secs']:.2f} s, master journal "
            f"{r['journal_bytes']} B, fail events {r['master']['fail_events']}; {card}")
    digests = {st["digest"] for r in runs.values() for st in r["stats"].values()}
    flash = [st["flash"] for r in runs.values() for st in r["stats"].values()]
    costs = {tuple(st["pass_costs"]) for r in runs.values() for st in r["stats"].values()}
    done = {n: sum(st["tasks_done"] for st in r["stats"].values()) for n, r in runs.items()}
    say(f"elastic resnet: N=1 and N=2 final states bit-identical {len(digests) == 1}, pass "
        f"costs equal {len(costs) == 1}, tasks done {done}")
    if len(digests) != 1 or len(costs) != 1:
        raise SystemExit("elastic resnet: N=1 and N=2 ended apart")
    if any(f != [0, 0, 0] for f in flash) or any(v != EL_RN_TASKS * EL_PASSES
                                                 for v in done.values()):
        raise SystemExit("elastic resnet: a flash launch, or a task count off")
    if not all(np.isfinite(c) for c in next(iter(costs))):
        raise SystemExit("elastic resnet: a non-finite pass cost")


def phase_elastic(torch, P, fa, card):
    """Phase 23: LeNet-5 and ResNet-50 fleets of worker processes under an
    HA master in this process; no flash kernel may launch."""
    import shutil
    import tempfile

    reset_counts(fa)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp()
    rpc_mb = P.flags.get_flag("rpc_max_message_mb")
    P.flags.set_flag("rpc_max_message_mb", EL_RPC_MB)
    t = [time.perf_counter()]
    try:
        phase_elastic_lenet(torch, P, root, card)
        t.append(time.perf_counter())
        phase_elastic_resnet(root, card)
        t.append(time.perf_counter())
    finally:
        P.flags.set_flag("rpc_max_message_mb", rpc_mb)
        shutil.rmtree(root, ignore_errors=True)
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("elastic: phase 23 launched a flash kernel")
    say(f"elastic: phase 23 split: lenet {t[1] - t[0]:.1f} s, resnet {t[2] - t[1]:.1f} s; flash "
        f"launches (fwd, dq, dkv) over it: {launch_counts(fa)}")


# ---------------------------------------------------------------------------
# phase 24: the serving plane (the engine's arms, the scheduler, the fleet)
# ---------------------------------------------------------------------------

# phase 13's model and engine (512/512, vocab 30000, f32, 16 slots, K = 8,
# 64 MB of pages); chunked prefill at 64 tokens a chunk
SP_CHUNK = 64
SP_LONG, SP_SHORT = 12, 52  # 24a.1: prompts of 300-500 and of 4-30 source tokens
SP_BEAMS, SP_BEAM_K = 8, 5  # 24a.4: beam requests among 56 greedy ones
SP_LOAD = 128  # 24b: requests of each open-loop run
SP_FLEET = 64  # 24c: requests through the fleet, then again under the kill
SP_LEASE_S = 5.0  # the fleet's engine lease: room for a busy engine's heartbeat
SP_HANG_S = 2.0  # serve_slow_client's frozen callback


def sp_mix(n, seed=0):
    """Phase 13's request mix: n sources of 4-30 tokens from `seed` (the
    first 64 of seed 0 are phase 13's)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(2, NMT_VOCAB, size=rng.randint(4, 31)).tolist() for _ in range(n)]


def sp_generator(P, dev):
    """Phase 13's generator: seed 61, f32."""
    from paddle_tpu_torch.models import seq2seq as S

    P.init(seed=61, compute_dtype="float32", device=dev)
    cost, _ = S.seq2seq_cost(NMT_VOCAB, NMT_VOCAB, NMT_WIDTH, NMT_WIDTH)
    params = P.parameters.create(cost, seed=61, device=dev)
    return S.Seq2SeqGenerator(params, NMT_VOCAB, NMT_VOCAB, word_dim=NMT_WIDTH,
                              hidden_dim=NMT_WIDTH, bos_id=0, eos_id=1, max_length=GEN_MAXLEN,
                              device=dev)


def sp_engine(gen, dev, **kw):
    from paddle_tpu_torch.serving import ServingEngine

    return ServingEngine(gen, max_slots=SERVE_SLOTS, block_steps=SERVE_K,
                         max_new_tokens=GEN_MAXLEN, hbm_budget_mb=SERVE_BUDGET_MB, device=dev,
                         **kw)


def sp_drive(eng, reqs, long_from=None):
    """Admit as slots free and step until every request is done.  Returns
    (seconds, gaps): each gap is the time from one decode dispatch's end to
    the next while sequences were live, with whether a prompt longer than
    `long_from` tokens prefilled (whole, or one chunk) inside it."""
    import collections

    queue = collections.deque(reqs)
    gaps, t_last = [], None
    t0 = time.perf_counter()
    while queue or eng.n_live or eng.n_prefilling:
        long_pf = eng.n_prefilling > 0
        if queue and eng.n_free_slots:
            for r in eng.admit(list(queue)):
                queue.remove(r)
                long_pf |= long_from is not None and len(r.src_ids) > long_from
        live = eng.n_live
        eng.step()
        t = time.perf_counter()
        if live and t_last is not None:
            gaps.append((t - t_last, long_pf))
        t_last = t if live else None
    return time.perf_counter() - t0, gaps


def sp_golden(torch, eng, cache, srcs):
    """The one-shot path's (tokens, log-probs) of each source, cached by
    source: tokens from reference_decode, log-probs from phase 13's trace."""
    for s in srcs:
        key = tuple(s)
        if key not in cache:
            toks = eng.reference_decode(s, GEN_MAXLEN)
            t2, chosen, _ = oneshot_trace(torch, eng, s, GEN_MAXLEN)
            if t2 != toks:
                raise SystemExit("serving plane: the one-shot trace is not reference_decode's")
            cache[key] = (toks, chosen[:len(toks)])
    return [cache[tuple(s)] for s in srcs]


def sp_check(name, reqs, golden, logprobs=True):
    """Every request's tokens (and log-probs) bit for bit the golden's."""
    bad = [r.req_id for r, (toks, lps) in zip(reqs, golden)
           if r.tokens != toks or (logprobs and r.token_logprobs != lps)]
    if bad:
        raise SystemExit(f"serving plane {name}: requests {bad} left the one-shot path")


def sp_arms(torch, P, gen, dev, card, golden):
    """24a: the engine's arms, each request bit for bit the one-shot path's."""
    from paddle_tpu_torch.reader.loadgen import PrefixMixer
    from paddle_tpu_torch.serving import Request

    g0 = sp_engine(gen, dev)
    # the attention scores' product at the engine's rows: one product over
    # every padded position rounds a row by the extent; the generation step
    # takes it in blocks of 16 positions (ops/rnn.py _att_scores_blocks)
    from paddle_tpu_torch.ops.rnn import _att_scores_blocks

    x_gen = torch.Generator(device=g0.device).manual_seed(1)
    p_dim = int(g0._w["v"].shape[0])
    t = torch.randn((g0.rows, 512, p_dim), generator=x_gen, device=g0.device)
    sp_ = torch.randn((g0.rows, p_dim), generator=x_gen, device=g0.device)
    v = g0._w["v"]
    whole = {s: (torch.tanh(t[:, :s] + sp_[:, None]) @ v)[:, :16] for s in (16, 32, 512)}
    blocked = {s: _att_scores_blocks("tanh", t[:, :s], sp_, v)[:, :16] for s in (16, 32, 512)}
    say(f"serving: scores of the first 16 positions as one product over the extent equal the "
        f"extent-16 product's at 32 {torch.equal(whole[32], whole[16])}, at 512 "
        f"{torch.equal(whole[512], whole[16])}; in blocks of 16 at 32 "
        f"{torch.equal(blocked[32], blocked[16])}, at 512 {torch.equal(blocked[512], blocked[16])}")
    if not (torch.equal(blocked[32], blocked[16]) and torch.equal(blocked[512], blocked[16])):
        raise SystemExit("serving: the blocked scores depend on the extent")
    # 24a.1 chunked prefill against whole-prompt prefill, in turns
    rng = np.random.RandomState(24)
    longs = [rng.randint(2, NMT_VOCAB, size=rng.randint(300, 501)).tolist()
             for _ in range(SP_LONG)]
    shorts = [rng.randint(2, NMT_VOCAB, size=rng.randint(4, 31)).tolist()
              for _ in range(SP_SHORT)]
    mix = []
    for i in range(SP_LONG + SP_SHORT):  # a long prompt among every ~5 requests
        pool = longs if (i % 5 == 2 and longs) or not shorts else shorts
        mix.append(pool.pop(0))
    gold = sp_golden(torch, g0, golden, mix)
    engines = {"whole": g0, "chunked": sp_engine(gen, dev, prefill_chunk_tokens=SP_CHUNK)}
    for name, eng in engines.items():  # warm-up: every rung and the chunk path
        sp_drive(eng, [Request([2] * n) for n in (5, 20, 40, 400, 5, 20)])
    for name in ("whole", "chunked", "chunked", "whole"):
        eng = engines[name]
        c0 = dict(eng.trace_counts)
        reqs = [Request(s) for s in mix]
        secs, gaps = sp_drive(eng, reqs, long_from=SP_CHUNK)
        sp_check(f"24a.1 {name}", reqs, gold)
        during = [g for g, lp in gaps if lp]
        quiet = [g for g, lp in gaps if not lp]
        chunks = eng.trace_counts["prefill_chunk"] - c0["prefill_chunk"]
        say(f"serving 24a.1 {name}: {len(reqs)} requests ({SP_LONG} of 300-500 source tokens) in "
            f"{secs:.4f} s, {len(reqs) / secs:.2f} requests/s; longest gap between decode "
            f"dispatches while a long prompt prefilled {max(during) * 1e3:.3f} ms (median "
            f"{float(np.median(during)) * 1e3:.3f} ms over {len(during)}), otherwise "
            f"{max(quiet) * 1e3:.3f} ms; chunk dispatches {chunks} "
            f"({chunks / SP_LONG:.1f} per long prompt); bit-identical on {card}")
        if name == "chunked" and chunks != SP_LONG * 2 * (512 // SP_CHUNK):
            raise SystemExit("serving 24a.1: a long prompt did not take two dispatches per chunk")
    del engines

    # 24a.2 the copy-on-write prefix cache over bench.py's prefix mix
    mixer = PrefixMixer(NMT_VOCAB, pool_size=4, prefix_frac=0.6, prefix_tokens=16,
                        tail_tokens=10, dup_frac=0.5, seed=4)
    p_srcs = [mixer.source(i) for i in range(SERVE_REQUESTS)]
    gold = sp_golden(torch, g0, golden, p_srcs)
    eng = sp_engine(gen, dev, prefix_cache=True)
    sp_drive(eng, [Request([2] * n) for n in (5, 20, 5, 20)])
    eng.prefix_hits = eng.prefix_misses = 0
    prefilled = []
    orig = eng._prefill_group
    eng._prefill_group = lambda group: (prefilled.extend(r.req_id for _, r, _ in group),
                                        orig(group))[1]
    peak = [0]
    orig_admit = eng.admit
    eng.admit = lambda rs: (lambda a: (peak.__setitem__(0, max(peak[0], eng.pages.n_shared)),
                                       a)[1])(orig_admit(rs))
    c0 = eng.trace_counts["prefill"]
    reqs = [Request(s) for s in p_srcs]
    secs, _ = sp_drive(eng, reqs)
    sp_check("24a.2 prefix", reqs, gold)
    hits = [r.req_id for r in reqs if r.req_id not in prefilled]
    rate = eng.prefix_hits / len(reqs)
    say(f"serving 24a.2 prefix cache: hit rate {rate:.4f} ({eng.prefix_hits} hits, "
        f"{eng.prefix_misses} misses of {len(reqs)}), {len(hits)} requests admitted without a "
        f"prefill, {eng.trace_counts['prefill'] - c0} prefill dispatches, peak blocks shared "
        f"{peak[0]}, entries {eng.prefix_cache_len}; {len(reqs) / secs:.2f} requests/s; "
        f"bit-identical on {card}")
    if not eng.prefix_hits or len(hits) != eng.prefix_hits or eng.pages.n_used:
        raise SystemExit("serving 24a.2: a hit made a prefill dispatch, or no request hit")
    del eng

    # 24a.3 speculative decoding against greedy over phase 13's mix
    srcs = sp_mix(SERVE_REQUESTS)
    gold = sp_golden(torch, g0, golden, srcs)
    spec = sp_engine(gen, dev, spec_decode=True)
    for e in (g0, spec):
        sp_drive(e, [Request([2] * (5 + 20 * (i % 2))) for i in range(16)])
    for name, e in (("greedy", g0), ("spec", spec), ("spec", spec), ("greedy", g0)):
        c0 = dict(e.trace_counts)
        p0, a0 = e.spec_proposed, e.spec_accepted
        reqs = [Request(s) for s in srcs]
        secs, _ = sp_drive(e, reqs)
        sp_check(f"24a.3 {name}", reqs, gold)
        n_tok = sum(len(r.tokens) for r in reqs)
        disp = (e.trace_counts["verify"] - c0["verify"]) + (e.trace_counts["decode"] - c0["decode"])
        # a request's dispatches: the distinct stamps of its tokens
        row_disp = sum(len(set(r.token_times)) for r in reqs)
        acc = (e.spec_accepted - a0) / max(1, e.spec_proposed - p0)
        say(f"serving 24a.3 {name}: {disp} dispatches for {n_tok} tokens, "
            f"{n_tok / row_disp:.3f} tokens per request per dispatch (K = {SERVE_K}), accept "
            f"rate {acc:.4f}, {len(reqs) / secs:.2f} requests/s; bit-identical on {card}")
    del spec

    # 24a.4 beam requests (width 5) mixed into greedy ones
    srcs = sp_mix(SERVE_REQUESTS, seed=1)
    beam_at = set(range(3, SERVE_REQUESTS, SERVE_REQUESTS // SP_BEAMS))
    reqs = [Request(s, GEN_MAXLEN, beam_size=SP_BEAM_K if i in beam_at else None)
            for i, s in enumerate(srcs)]
    sp_drive(g0, [Request([2] * 5, beam_size=SP_BEAM_K), Request([2] * 20)])
    c0 = g0.trace_counts["beam"]
    secs, _ = sp_drive(g0, reqs)
    greedy = [r for r in reqs if not r.beam_size]
    sp_check("24a.4 greedy", greedy, sp_golden(torch, g0, golden, [r.src_ids for r in greedy]))
    worst = 0
    for r in reqs:
        if r.beam_size:
            toks, score = g0.reference_beam(r.src_ids, SP_BEAM_K, GEN_MAXLEN)
            if r.tokens != toks or r.beam_score != score:
                raise SystemExit(f"serving 24a.4: beam request {r.req_id} left generate's "
                                 f"({r.beam_score} vs {score})")
            worst = max(worst, len(toks))
    say(f"serving 24a.4 beam: {len(beam_at)} requests at width {SP_BEAM_K} among "
        f"{len(greedy)} greedy, {g0.trace_counts['beam'] - c0} beam dispatches of "
        f"{g0.rows * SP_BEAM_K} beam rows, {len(reqs) / secs:.2f} requests/s; tokens and "
        f"beam_score equal the one-shot generate's on {card}")

    # 24a.5 int8 weights: the engine's tokens against the one-shot path
    # stepping on the same dequantized bundle (bit for bit), the drift of a
    # step's logits from f32's (the serving_int8_drift_budget flag's
    # measure), and, for the record, how many requests keep f32's tokens
    from paddle_tpu_torch.core.batch import pad_batch_rows
    from paddle_tpu_torch.models.seq2seq import make_fused_logits

    q8 = sp_engine(gen, dev, int8_weights=True)
    srcs = sp_mix(SERVE_REQUESTS)
    sp_drive(q8, [Request([2] * (5 + 20 * (i % 2))) for i in range(16)])
    reqs = [Request(s) for s in srcs]
    secs, _ = sp_drive(q8, reqs)
    gold = sp_golden(torch, g0, golden, srcs)
    same = sum(r.tokens == toks for r, (toks, _) in zip(reqs, gold))
    deq = q8._weights()
    gen.fused_decode_weights = lambda gp: deq
    try:
        ref8 = [q8.reference_decode(s, GEN_MAXLEN) for s in srcs]
    finally:
        del gen.fused_decode_weights
    bad = [r.req_id for r, toks in zip(reqs, ref8) if r.tokens != toks]
    with torch.no_grad():
        batch = pad_batch_rows(g0._feeder([(s,) for s in srcs[:SERVE_SLOTS]]), g0.rows)
        statics, carry, _, _ = gen._prepare(batch)
        mt = gen._match
        enc_t = statics[mt.enc_name]
        ep = statics[mt.ep_name].data
        ep = ep + g0._w["sp_b"] if g0._w["sp_b"] is not None else ep
        ids = torch.full((g0.rows,), gen.bos_id, dtype=torch.int32, device=g0.device)
        h = next(iter(carry.values()))
        logits = [make_fused_logits(w, enc_t.data, ep, enc_t.mask(torch.bool), **g0._acts)(
            ids, h)[0] for w in (g0._w, deq)]
    logit_drift = float((logits[1] - logits[0]).abs().max() / logits[0].abs().max())
    deq_ms = sp_ms(torch, dev, q8._weights)
    drift = q8.weight_drift()
    budget = P.flags.get_flag("serving_int8_drift_budget")
    say(f"serving 24a.5 int8: weight bytes {g0.weight_bytes} f32, {q8.weight_bytes} int8 "
        f"({g0.weight_bytes / q8.weight_bytes:.3f}x); weight_drift {drift:.6f}, a step's logit "
        f"drift {logit_drift:.6f} (budget {budget}); slots per GB at 16 source tokens "
        f"{g0.slots_per_gb(16):.1f} f32, {q8.slots_per_gb(16):.1f} int8; every request's tokens "
        f"the int8 one-shot path's: {not bad}; {same} of {len(reqs)} requests with f32's tokens "
        f"(random weights: near-tied logits); dequantize {deq_ms:.4f} ms per dispatch (CUDA "
        f"events); {len(reqs) / secs:.2f} requests/s on {card}")
    if bad or not (drift < budget and logit_drift < budget):
        raise SystemExit(f"serving 24a.5: int8 requests {bad} left the int8 one-shot path, or "
                         "the drift is over budget")
    return g0


def sp_ms(torch, dev, fn, iters=20) -> float:
    """Milliseconds per call of fn: CUDA events on the card."""
    if dev != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    return time_ms(torch, fn, iters=iters)


def sp_scheduler(torch, P, g0, card, golden):
    """24b: the scheduler at saturation, at 90% of it and at 2x it with
    deadlines, and the two chaos drills."""
    from paddle_tpu_torch.reader.loadgen import OpenLoopLoadGen
    from paddle_tpu_torch.robustness import chaos
    from paddle_tpu_torch.serving import Request, ServingScheduler, percentile, status_counts

    srcs = sp_mix(SP_LOAD)
    gold = sp_golden(torch, g0, golden, srcs)
    # a request is served late only by the loop iteration that finishes it:
    # the longest admission plus the longest step bound its lateness
    durs = {"admit": [0.0], "step": [0.0]}

    def timed(name, fn):
        def call(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                durs[name].append(time.perf_counter() - t)
        return call

    g0.admit, g0.step = timed("admit", g0.admit), timed("step", g0.step)
    with ServingScheduler(g0) as sched:
        for r in [sched.submit(Request(s)) for s in srcs[:32]]:  # warm-up, calibration
            r.wait(120)
        reqs = [Request(s) for s in srcs]
        t0 = time.perf_counter()
        for r in reqs:
            sched.submit(r)
        for r in reqs:
            if not r.wait(300):
                raise SystemExit("serving 24b: a request was never finalized")
        sat = len(reqs) / (time.perf_counter() - t0)
        sp_check("24b saturation", reqs, gold)
        say(f"serving 24b saturation: {len(reqs)} requests submitted at once, {sat:.2f} "
            f"requests/s on {card}")
        runs = {}
        for name, rate, deadline in (("90%", 0.9 * sat, None), ("2x", 2.0 * sat, "3x")):
            if deadline == "3x":
                service = [r.t_done - r.t_admit for r in runs["90%"]]
                deadline = 3.0 * float(np.mean(service))
            # at 2x the backlog must outgrow the deadline: twice the requests
            reqs = [Request(s) for s in (srcs if deadline is None else srcs + srcs)]
            t0 = time.perf_counter()
            OpenLoopLoadGen(rate, len(reqs), lambda i: reqs[i], seed=0,
                            deadline_s=deadline).run(sched.submit)
            for r in reqs:
                if not r.wait(300):
                    raise SystemExit("serving 24b: a request was never finalized")
            wall = time.perf_counter() - t0
            runs[name] = reqs
            ok = [r for r in reqs if r.status == "served"]
            tpot = sorted((r.t_done - r.t_admit) / len(r.tokens) for r in ok if r.tokens)
            ledger = status_counts(reqs)
            late = [r.t_done - r.t_deadline for r in ok
                    if r.t_deadline is not None and r.t_done > r.t_deadline]
            say(f"serving 24b {name}: offered {rate:.2f} requests/s"
                f"{'' if deadline is None else f' with deadline {deadline * 1e3:.3f} ms'}, "
                f"sustained {len(ok) / wall:.2f} requests/s over {wall:.4f} s; per-token latency "
                f"p50 {percentile(tpot, 0.5) * 1e3:.4f} ms, p99 {percentile(tpot, 0.99) * 1e3:.4f} "
                f"ms; ledger {ledger}; served past the deadline {len(late)} (by at most "
                f"{max(late, default=0.0) * 1e3:.3f} ms) on {card}")
            sp_check(f"24b {name}", ok, [golden[tuple(r.src_ids)] for r in ok])
            if name == "90%" and ledger["served"] != len(reqs):
                raise SystemExit("serving 24b: not every request was served at 90% of saturation")
            if name == "2x":
                if not ledger["shed"] or ledger["timeout"] >= ledger["shed"]:
                    raise SystemExit("serving 24b: at 2x saturation the plane did not shed")
                if late and max(late) > max(durs["admit"]) + max(durs["step"]):
                    raise SystemExit("serving 24b: a request was served past its deadline by "
                                     "more than the iteration that finished it")
    del g0.admit, g0.step

    # the chaos drills of tests/test_serving_e2e.py
    chaos.arm("nan_request@3")
    try:
        t0 = time.perf_counter()
        with ServingScheduler(g0) as sched:
            reqs = [sched.submit(Request(s)) for s in srcs[:8]]
            for r in reqs:
                r.wait(60)
        wall = time.perf_counter() - t0
    finally:
        chaos.disarm()
    poisoned = [r for r in reqs if r.error is not None]
    if poisoned != [reqs[2]] or "non-integral" not in reqs[2].error:
        raise SystemExit("serving 24b: nan_request was not rejected alone")
    sp_check("24b nan_request", reqs[:2] + reqs[3:], [golden[tuple(s)] for s in
                                                       srcs[:2] + srcs[3:8]])
    say(f"serving 24b nan_request: the 3rd submission rejected ({reqs[2].error[:40]}...), the "
        f"other 7 served bit-identical in {wall:.4f} s on {card}")
    os.environ["PADDLE_TPU_TORCH_CHAOS_HANG_SECS"] = str(SP_HANG_S)
    chaos.arm("serve_slow_client@1")
    delivered = []
    try:
        with ServingScheduler(g0) as sched:
            reqs = [sched.submit(Request(s, callback=delivered.append)) for s in srcs[:6]]
            t0 = time.perf_counter()
            for r in reqs:
                r.wait(60)
            wait_s = time.perf_counter() - t0
    finally:
        chaos.disarm()
        os.environ.pop("PADDLE_TPU_TORCH_CHAOS_HANG_SECS", None)
    sp_check("24b serve_slow_client", reqs, [golden[tuple(s)] for s in srcs[:6]])
    say(f"serving 24b serve_slow_client: every wait() returned in {wait_s:.4f} s while the "
        f"first callback hung {SP_HANG_S} s; {len(delivered)} callbacks delivered after it on "
        f"{card}")
    if wait_s >= SP_HANG_S or len(delivered) != len(reqs):
        raise SystemExit("serving 24b: the slow client stalled more than delivery")


def sp_fleet(torch, P, g0, dev, card, golden):
    """24c: a Router in this process over two ``serve --register`` engine
    processes sharing the card: requests through FleetClient, one engine
    SIGKILLed under load, the survivor drained."""
    import signal
    import tempfile

    from paddle_tpu_torch.serving import FleetClient, Request, Router
    from paddle_tpu_torch.serving.scheduler import TERMINAL_STATUSES

    d = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    tar = os.path.join(d, "params.tar")
    with open(tar, "wb") as f:
        g0._gen.params.to_tar(f)
    free0 = el_free(torch, dev)
    router = Router(address=("127.0.0.1", 0), lease_timeout_s=SP_LEASE_S, stats_poll_s=0.1,
                    journal_path=os.path.join(d, "journal.jsonl"))
    host, port = router.address
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""),
               PADDLE_TPU_TORCH_SERVING_DECODE_BLOCK_STEPS=str(SERVE_K))
    args = ["--register", f"{host}:{port}", "--model", tar, "--src-vocab", str(NMT_VOCAB),
            "--trg-vocab", str(NMT_VOCAB), "--word-dim", str(NMT_WIDTH), "--hidden-dim",
            str(NMT_WIDTH), "--max-length", str(GEN_MAXLEN), "--max-new-tokens",
            str(GEN_MAXLEN), "--max-slots", str(SERVE_SLOTS), "--hbm-budget-mb",
            str(SERVE_BUDGET_MB), "--seed", "61"] + ([] if dev == "cuda" else ["--device", dev])
    procs = {}
    t0 = time.perf_counter()
    try:
        for i in range(2):
            procs[f"eng{i}"] = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch", "serve", *args, "--engine-id",
                 f"eng{i}"], cwd=HERE, env=env, stdout=open(os.path.join(d, f"eng{i}.log"), "w"),
                stderr=subprocess.STDOUT)
        first = None
        while len(router.live_engines()) < 2:
            if first is None and router.live_engines():
                first = time.perf_counter() - t0
            if time.perf_counter() - t0 > 300 or any(p.poll() is not None for p in procs.values()):
                raise SystemExit("serving 24c: an engine never registered: " + sp_logs(d))
            time.sleep(0.05)
        both = time.perf_counter() - t0
        first = both if first is None else first
        srcs = sp_mix(SP_FLEET)
        gold = sp_golden(torch, g0, golden, srcs)
        fc = FleetClient(router.address)
        try:
            warm = [fc.submit(Request(s, GEN_MAXLEN, req_id=f"warm{i}"))
                    for i, s in enumerate(srcs[:16])]
            for r in warm:
                r.wait(300)
            reqs = [Request(s, GEN_MAXLEN, req_id=f"fleet{i}") for i, s in enumerate(srcs)]
            t1 = time.perf_counter()
            for r in reqs:
                fc.submit(r)
            for r in reqs:
                if not r.wait(300):
                    raise SystemExit("serving 24c: a fleet request was never finalized")
            secs = time.perf_counter() - t1
            ledger = router.fleet_stats()["ledger"]
            per = {e: h.get("served") for e, h in router.fleet_stats().get("engines", {}).items()}
            say(f"serving 24c fleet: first lease {first:.2f} s, both {both:.2f} s after spawn; "
                f"{len(reqs)} requests in {secs:.4f} s, {len(reqs) / secs:.2f} requests/s; "
                f"ledger {ledger}; per engine {per}; duplicates discarded "
                f"{router.duplicates_discarded}; free card memory {free0 >> 20} MiB before the "
                f"engines on {card}")
            if any(r.status != "served" for r in reqs) or router.duplicates_discarded:
                raise SystemExit("serving 24c: a fleet request was not served once")
            sp_check("24c fleet", reqs, gold, logprobs=False)

            # SIGKILL one engine under load
            kill = [Request(s, GEN_MAXLEN, req_id=f"kill{i}") for i, s in enumerate(srcs)]
            t1 = time.perf_counter()
            for i, r in enumerate(kill):
                fc.submit(r)
                if i == len(kill) // 4:
                    procs["eng1"].send_signal(signal.SIGKILL)
                    t_kill = time.perf_counter()
                time.sleep(0.01)
            for r in kill:
                if not r.wait(300):
                    raise SystemExit("serving 24c: a request under the kill was never finalized")
            recover = max(r.t_done for r in kill) - t_kill
            procs["eng1"].wait(30)
            while router.live_engines() != ["eng0"] and time.perf_counter() - t_kill < 60:
                time.sleep(0.05)
            pruned = time.perf_counter() - t_kill
            free_kill = el_free(torch, dev)
            statuses = [r.status for r in kill]
            ok = [r for r in kill if r.status == "served"]
            ledger = router.fleet_stats()["ledger"]
            say(f"serving 24c kill: eng1 SIGKILLed after {len(kill) // 4 + 1} of {len(kill)} "
                f"submissions; statuses {{{', '.join(f'{s}: {statuses.count(s)}' for s in TERMINAL_STATUSES)}}}; "
                f"all finalized {recover:.3f} s after the kill; eng1 pruned {pruned:.3f} s "
                f"after it (lease {SP_LEASE_S} s), live engines {router.live_engines()}; "
                f"reroutes {router.reroutes}; ledger {ledger}; duplicates discarded "
                f"{router.duplicates_discarded}; free card memory {free_kill >> 20} MiB after "
                f"the kill, rc {procs['eng1'].returncode}")
            if any(s not in TERMINAL_STATUSES for s in statuses) or router.duplicates_discarded:
                raise SystemExit("serving 24c: a request under the kill did not end once")
            if router.live_engines() != ["eng0"] or len(ok) < len(kill) // 2:
                raise SystemExit("serving 24c: the fleet did not re-route around the dead engine")
            sp_check("24c kill", ok, [golden[tuple(r.src_ids)] for r in ok], logprobs=False)
        finally:
            fc.close()
        t1 = time.perf_counter()
        clean = router.drain_engine("eng0", timeout_s=120.0)
        drained = time.perf_counter() - t1
        procs["eng0"].send_signal(signal.SIGTERM)
        rc = procs["eng0"].wait(120)
        time.sleep(1.0)
        free_end = el_free(torch, dev)
        say(f"serving 24c drain: eng0 drained {'clean' if clean else 'NOT clean'} in "
            f"{drained:.3f} s, exit code {rc} after SIGTERM; free card memory {free_end >> 20} "
            f"MiB after both engines (before {free0 >> 20} MiB)")
        if not clean or rc != 0:
            raise SystemExit("serving 24c: the survivor did not drain clean: " + sp_logs(d))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(30)
        router.close()


def sp_logs(d) -> str:
    out = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".log"):
            with open(os.path.join(d, f)) as fh:
                out.append(f"--- {f}\n" + fh.read()[-3000:])
    return "\n".join(out)


def phase_serving_plane(torch, P, fa, card, dev="cuda"):
    """Phase 24: the serving plane at phase 13's width: 24a the engine's
    arms (chunked prefill, prefix cache, speculative decoding, beam, int8
    weights), 24b the scheduler under open-loop load and its drills, 24c a
    two-engine fleet behind the router.  No flash kernel may launch."""
    reset_counts(fa)
    gen = sp_generator(P, dev)
    golden = {}
    t = [time.perf_counter()]
    g0 = sp_arms(torch, P, gen, dev, card, golden)
    t.append(time.perf_counter())
    sp_scheduler(torch, P, g0, card, golden)
    t.append(time.perf_counter())
    sp_fleet(torch, P, g0, dev, card, golden)
    t.append(time.perf_counter())
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("serving plane: phase 24 launched a flash kernel")
    say(f"serving plane: phase 24 split: 24a {t[1] - t[0]:.1f} s, 24b {t[2] - t[1]:.1f} s, 24c "
        f"{t[3] - t[2]:.1f} s; flash launches (fwd, dq, dkv) over it: {launch_counts(fa)}")


# phase 25: the v1 command line (paddle_tpu_torch/cli.py), the profiler and
# the NaN trap, carried by bench_lstm_textcls (phase 16's config and corpus)
CLI_TIMED = 20  # --test_period of 25a, the reference rnn benchmark's line
CLI_ENC_B, CLI_ENC_TIMED = 8, 10  # 25e: batch and timed steps
CLI_ENC_CONFIG = """
from paddle.trainer_config_helpers import *

settings(batch_size=8, learning_rate=1e-4, learning_method=AdamOptimizer())
define_py_data_sources2("enc.list", None, module="enc_provider", obj="process")
x = pos_encoding(embedding_layer(input=data_layer("src", 32000), size=512), emb_scale=512 ** 0.5)
for i in range(2):
    att = multi_head_attention(layer_norm(x, name="l%d_ln1" % i), n_heads=8, name="l%d_att" % i)
    x = addto_layer([x, att], name="l%d_res1" % i)
    h = fc_layer(input=layer_norm(x, name="l%d_ln2" % i), size=2048, act=ReluActivation(),
                 name="l%d_ff1" % i)
    x = addto_layer([x, fc_layer(input=h, size=512, name="l%d_ff2" % i)], name="l%d_res2" % i)
pooled = pooling_layer(input=layer_norm(x, name="enc_ln"), pooling_type=AvgPooling())
prob = fc_layer(input=pooled, size=2, act=SoftmaxActivation())
outputs(classification_cost(input=prob, label=data_layer("label", 2)))
"""
CLI_ENC_PROVIDER = """
import pickle
from paddle.trainer.PyDataProvider2 import *

@provider(input_types=[integer_value_sequence(32000), integer_value(2)], should_shuffle=False)
def process(settings, path):
    with open(path, "rb") as f:
        for ids, label in pickle.load(f):
            yield ids, label
"""
CLI_MLP_CONFIG = """
from paddle.trainer_config_helpers import *

settings(batch_size=8, learning_rate=1e-2, learning_method=MomentumOptimizer(0.9))
define_py_data_sources2("mlp.list", None, module="mlp_provider", obj="process")
h = fc_layer(input=data_layer(name="x", size=784), size=128, act=TanhActivation())
h = fc_layer(input=h, size=64, act=TanhActivation())
p = fc_layer(input=h, size=10, act=SoftmaxActivation())
outputs(classification_cost(input=p, label=data_layer(name="y", size=10)))
"""
CLI_MLP_PROVIDER = """
import pickle
from paddle.trainer.PyDataProvider2 import *

@provider(input_types=[dense_vector(784), integer_value(10)], should_shuffle=False)
def process(settings, path):
    with open(path, "rb") as f:
        for x, y in pickle.load(f):
            yield x, y
"""
CLI_DANGLING = """
from paddle.trainer_config_helpers import *

x = data_layer(name="x", size=8)
hidden = fc_layer(input=x, size=8, act=TanhActivation(), name="hidden")
outputs(LayerOutput(LayerConf(name="sum", type="addto", size=8,
                              inputs=("hidden", "ghost_layer")), [hidden]))
"""
TRAP_WIDTH, TRAP_B, TRAP_STEPS = 1024, 128, 5  # 25g's MLP and its timed steps


def cli_run(tcli, argv):
    """(exit code, stdout) of the port's command line in this process."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(argv)
    return rc, out.getvalue()


def cli_time_line(out):
    """(batches, batch size, ms/batch, samples/s) of a --job=time report."""
    import re

    m = re.search(r"(\d+) batches of (\d+): ([0-9.]+) ms/batch, ([0-9.]+) samples/sec", out)
    if m is None:
        raise SystemExit(f"cli: no ms/batch line in the time job's output:\n{out[-2000:]}")
    return int(m.group(1)), int(m.group(2)), float(m.group(3)), float(m.group(4))


def cli_write(d, files):
    for name, text in files.items():
        with open(os.path.join(d, name), "w") as f:
            f.write(text)


def recorded_tests(P):
    """Patch SGD.test to record each result's cost (the command line's test
    job prints it to 6 decimals); returns (costs, undo)."""
    costs, orig = [], P.trainer.SGD.test

    def test(self, *a, **k):
        res = orig(self, *a, **k)
        costs.append(res.cost)
        return res

    P.trainer.SGD.test = test
    return costs, lambda: setattr(P.trainer.SGD, "test", orig)


def phase_cli_shell(d, v1):
    """25a: the reference rnn benchmark's line as a subprocess, with and
    without --feed_data, at phase 16's precision (bf16 through the
    compute_dtype flag)."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""),
               PADDLE_TPU_TORCH_COMPUTE_DTYPE="bfloat16")
    for extra in ([], ["--feed_data"]):
        argv = [sys.executable, "-m", "paddle_tpu_torch", "train", "--config=textcls.py",
                f"--config_args={V1_ARGS}", "--job=time", f"--test_period={CLI_TIMED}",
                "--use_gpu=True", "--trainer_count=1", "--log_period=10"] + extra
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=d, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SystemExit(f"cli 25a: {' '.join(argv[2:])} exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
        n, b, ms, sps = cli_time_line(proc.stdout)
        table = [ln for ln in proc.stdout.splitlines() if ln.startswith(("FwdBwd", "GetData"))]
        say(f"cli 25a: `python -m paddle_tpu_torch {' '.join(argv[3:])}` (bf16): {n} batches of "
            f"{b}: {ms:.3f} ms/batch, {sps:.1f} samples/s; StatSet {table}; process wall "
            f"{wall:.1f} s; phase 16 in-process: {v1['s_per_step'] * 1e3:.3f} ms per step, "
            f"{TXT_B / v1['s_per_step']:.1f} samples/s")


def phase_cli_train_test(P, tcli, d):
    """25b and 25c: train one pass with --save_dir, --job=test on the pass
    dir against SGD.test in this process on the same loaded parameters
    (bit-equal: a forward on the same parameters and batches), then
    merge_model and --job=test on the bundle (bit-equal to 25b)."""
    from paddle_tpu_torch.v1_compat import make_config_reader, parse_config

    cfg = os.path.join(d, "textcls.py")
    save = os.path.join(d, "model")
    t0 = time.perf_counter()
    rc, out = cli_run(tcli, ["train", f"--config={cfg}", f"--config_args={V1_ARGS}",
                             "--num_passes=1", f"--save_dir={save}"])
    pass_dir = os.path.join(save, "pass-00000")
    files = sorted(os.listdir(pass_dir)) if os.path.isdir(pass_dir) else []
    say(f"cli 25b: --job=train --num_passes=1 over {V1_REVIEWS} reviews: exit {rc} in "
        f"{time.perf_counter() - t0:.1f} s; {[ln for ln in out.splitlines() if 'Pass 0' in ln]}; "
        f"pass-00000 holds {files}")
    if rc != 0 or "params.tar" not in files or "__lstmemory_0__.w_h" not in files:
        raise SystemExit("cli 25b: the train job failed or wrote no v1 pass dir")
    costs, undo = recorded_tests(P)
    try:
        rc, out = cli_run(tcli, ["train", f"--config={cfg}", f"--config_args={V1_ARGS}",
                                 "--job=test", f"--init_model_path={pass_dir}"])
        bundle = os.path.join(d, "textcls.paddle")
        rc_m, _ = cli_run(tcli, ["merge_model", f"--model_dir={pass_dir}",
                                 f"--config_file={cfg}", f"--model_file={bundle}",
                                 f"--config_args={V1_ARGS}"])
        rc_b, out_b = cli_run(tcli, ["train", f"--config={cfg}", f"--config_args={V1_ARGS}",
                                     "--job=test", f"--init_model_path={bundle}"])
    finally:
        undo()
    if rc or rc_m or rc_b or len(costs) != 2:
        raise SystemExit(f"cli 25b/25c: exit codes test {rc}, merge_model {rc_m}, bundle test "
                         f"{rc_b}; {len(costs)} test results")
    parsed = parse_config(cfg, V1_ARGS)
    trainer = tcli._make_trainer(parsed, 0, "cuda")
    tcli._load_init_model(trainer, pass_dir)
    # the config declares no test list: the test job reads the train stream
    want = trainer.test(P.batch(make_config_reader(parsed, d, train=True),
                                parsed.settings.batch_size), feeding=parsed.feeding).cost
    line = [ln for ln in out.splitlines() if ln.startswith("Test cost")]
    say(f"cli 25b: --job=test on pass-00000: {line} (unrounded {costs[0]!r}); SGD.test in this "
        f"process on the same loaded parameters: {want!r}; bit-equal {costs[0] == want}")
    say(f"cli 25c: merge_model -> {os.path.getsize(bundle)} bytes; --job=test on the bundle: "
        f"{costs[1]!r}; bit-equal to 25b {costs[1] == costs[0]}")
    if costs[0] != want:
        raise SystemExit(f"cli 25b: the test job's cost {costs[0]!r} != SGD.test's {want!r}")
    if costs[1] != costs[0]:
        raise SystemExit(f"cli 25c: the bundle's test cost {costs[1]!r} != the pass dir's")
    return trainer, parsed


def phase_cli_checkgrad(torch, tcli, d):
    """25d: --job=checkgrad on the card, f64, an MLP at batch 8."""
    rng = np.random.RandomState(25)
    rows = [([float(v) for v in rng.standard_normal(784)], int(rng.randint(10)))
            for _ in range(16)]
    import pickle

    with open(os.path.join(d, "mlp.pkl"), "wb") as f:
        pickle.dump(rows, f, protocol=2)
    cli_write(d, {"mlp.py": CLI_MLP_CONFIG, "mlp_provider.py": CLI_MLP_PROVIDER,
                  "mlp.list": "mlp.pkl\n"})
    t0 = time.perf_counter()
    rc, out = cli_run(tcli, ["train", f"--config={os.path.join(d, 'mlp.py')}",
                             "--job=checkgrad"])
    line = [ln for ln in out.splitlines() if "checkgrad" in ln or ln.startswith("FAIL")]
    say(f"cli 25d: --job=checkgrad (784-128-64-10 tanh MLP, batch 8, f64 on the card): exit "
        f"{rc} in {time.perf_counter() - t0:.1f} s: {line}")
    if rc != 0 or "checkgrad PASSED" not in out or torch.get_default_dtype() != torch.float32:
        raise SystemExit("cli 25d: checkgrad failed on the card (or left f64 as the default)")


def phase_cli_encoder(P, fa, tcli, d, card):
    """25e: --job=time of a 2-layer Transformer-base encoder classifier with
    use_flash_attention on, in this process: every step launches the
    forward, dq and dk/dv kernels twice (2 layers)."""
    import pickle

    rng = np.random.RandomState(26)
    n = CLI_ENC_B * 4
    lens = [1024 if i % CLI_ENC_B == 0 else int(rng.randint(600, 1025)) for i in range(n)]
    rows = [([int(t) for t in rng.randint(2, 32000, size=m)], int(rng.randint(2)))
            for m in lens]
    with open(os.path.join(d, "enc.pkl"), "wb") as f:
        pickle.dump(rows, f, protocol=2)
    cli_write(d, {"enc.py": CLI_ENC_CONFIG, "enc_provider.py": CLI_ENC_PROVIDER,
                  "enc.list": "enc.pkl\n"})
    P.flags.set_flag("use_flash_attention", True)
    reset_counts(fa)
    try:
        rc, out = cli_run(tcli, ["train", f"--config={os.path.join(d, 'enc.py')}", "--job=time",
                                 f"--test_period={CLI_ENC_TIMED}", "--feed_data"])
    finally:
        P.flags.set_flag("use_flash_attention", False)
    steps = 10 + CLI_ENC_TIMED
    got = launch_counts(fa)
    nb, b, ms, sps = cli_time_line(out)
    say(f"cli 25e: --job=time of a 2-layer Transformer-base encoder classifier (d 512, 8 heads, "
        f"d_ff 2048, batch {b}, lengths 600-1024 padded to 1024, bf16, flash on): exit {rc}; "
        f"{nb} batches: {ms:.3f} ms/batch, {sps:.1f} samples/s on {card}; flash launches "
        f"(fwd, dq, dkv) over {steps} steps: {got}, per step "
        f"{tuple(round(c / steps, 3) for c in got)}")
    if rc != 0 or got != (2 * steps,) * 3:
        raise SystemExit(f"cli 25e: expected 2 launches of each kernel per step, got {got}")
    reset_counts(fa)


def phase_cli_profile(torch, P, trainer, parsed, d):
    """25f: profiler.profile around two textcls training steps: a trace file
    holding device kernels and the obs spans as record_function ranges.
    Returns the obs trace file the spans were exported to."""
    import glob

    two = list(P.reader.firstn(P.batch(P.v1_compat.make_config_reader(parsed, d),
                                       parsed.settings.batch_size), 2)())
    P.obs.tracer.reset()
    for n in range(1, PROFILE_TRIES + 1):
        logdir = os.path.join(d, f"profile{n}")
        with P.profiler.profile(logdir):
            trainer.train(lambda: iter(two), feeding=parsed.feeding)
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        if len(files) != 1:
            raise SystemExit(f"cli 25f: profile wrote {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        spans = {}
        for e in events:
            if e.get("cat") == "user_annotation":
                spans[e["name"]] = spans.get(e["name"], 0) + 1
        say(f"cli 25f: profiler.profile window {n}: {os.path.basename(files[0])} "
            f"({os.path.getsize(files[0])} bytes): {len(kernels)} device kernels, obs spans as "
            f"record_function ranges {dict(sorted(spans.items()))}")
        if kernels:
            break
    if not kernels:
        raise SystemExit("cli 25f: no profiler window recorded device kernels")
    if spans.get("train_step", 0) < 2 or spans.get("block_fetch", 0) < 2:
        raise SystemExit("cli 25f: the obs train_step/block_fetch spans are missing")
    return P.obs.tracer.dump(os.path.join(d, "obs", "trace-trainer.json"))


def trap_net(P, nan_backward):
    L, A = P.layer, P.activation
    x = L.data("x", P.data_type.dense_vector(TRAP_WIDTH))
    if nan_backward:
        # sqrt(relu(W x)) * 0 at x = 0: a finite forward, 0 / (2 sqrt(0)) in
        # the sqrt's backward
        h = L.fc(x, size=TRAP_WIDTH, act=A.Relu(), bias_attr=False, name="h")
        q = L.addto([h], act=A.Sqrt(), bias_attr=False, name="q")
        return L.sum_cost(L.slope_intercept(q, slope=0.0, name="z"))
    h = L.fc(x, size=TRAP_WIDTH, act=A.Tanh(), name="h")
    out = L.fc(h, size=10, act=A.Softmax(), name="out")
    return L.classification_cost(out, L.data("y", P.data_type.integer_value(10)))


def phase_cli_trap(torch, P, card):
    """25g: init(check_nans=True) on the card: a NaN planted in an input
    raises naming the op and the layer, a NaN made only in the backward
    raises naming the backward node and the layer (autograd's device
    thread carries the mode), disarmed the sentinel skips the same batch;
    the armed step's time against the disarmed one."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    P.init(compute_dtype="float32")
    rng = np.random.RandomState(27)
    rows = [(rng.standard_normal(TRAP_WIDTH).astype(np.float32), int(rng.randint(10)))
            for _ in range(TRAP_B)]
    poisoned = list(rows)
    poisoned[5] = (np.where(np.arange(TRAP_WIDTH) == 7, np.nan, rows[5][0]).astype(np.float32),
                   rows[5][1])
    feeding = {"x": 0, "y": 1}
    cost = trap_net(P, False)
    trainer = P.trainer.SGD(cost, P.parameters.create(cost, seed=27),
                            P.optimizer.Momentum(learning_rate=0.01))

    def steps(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(P.batch(lambda: iter(rows * n), TRAP_B), feeding=feeding)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    steps(1)  # warm-up
    off = steps(TRAP_STEPS)
    P.init(check_nans=True, compute_dtype="float32")
    try:
        if _get_current_dispatch_mode() is not P.profiler.active_trap():
            raise SystemExit("cli 25g: init(check_nans=True) did not arm the trap")
        on = steps(TRAP_STEPS)
        errors = []
        try:
            trainer.train(P.batch(lambda: iter(poisoned), TRAP_B), feeding=feeding)
        except FloatingPointError as e:
            errors.append(str(e))
        bcost = trap_net(P, True)
        btrainer = P.trainer.SGD(bcost, P.parameters.create(bcost, seed=28),
                                 P.optimizer.Momentum(learning_rate=0.01))
        zeros = [(np.zeros(TRAP_WIDTH, np.float32),) for _ in range(TRAP_B)]
        try:
            btrainer.train(P.batch(lambda: iter(zeros), TRAP_B), feeding={"x": 0})
        except FloatingPointError as e:
            errors.append(str(e))
    finally:
        P.profiler.enable_nan_checks(False)
        P.flags.set_flag("check_nans", False)
    say(f"cli 25g: NaN trap on {card}: planted input -> {errors[0] if errors else None!r}; "
        f"backward only -> {errors[1] if len(errors) > 1 else None!r}")
    if (len(errors) != 2 or "forward of layer 'h'" not in errors[0] or "aten." not in errors[0]
            or "backward (SqrtBackward0) of layer 'q'" not in errors[1]):
        raise SystemExit("cli 25g: the trap missed a NaN or did not name the op and the layer")
    if _get_current_dispatch_mode() is not None:
        raise SystemExit("cli 25g: a dispatch mode is still on the stack after disarming")
    before = {k: v.clone() for k, v in trainer.parameters.params["h"].items()}
    seen = []
    trainer.train(P.batch(lambda: iter(poisoned), TRAP_B), feeding=feeding,
                  event_handler=lambda e: seen.append(e.cost)
                  if isinstance(e, P.event.EndIteration) else None)
    kept = all(torch.equal(v, before[k]) for k, v in trainer.parameters.params["h"].items())
    say(f"cli 25g: disarmed, the planted batch's cost {seen} and the parameters kept: {kept} "
        f"(the sentinel's skip); step of the {TRAP_WIDTH}-wide MLP at batch {TRAP_B} (f32): "
        f"disarmed {off * 1e3:.3f} ms, armed {on * 1e3:.3f} ms ({on / off:.1f}x: a host sync "
        f"per op)")
    if len(seen) != 1 or not np.isnan(seen[0]) or not kept:
        raise SystemExit("cli 25g: disarmed, the sentinel did not skip the planted batch")


def phase_cli_faces(torch, tcli, d, obs_trace):
    """25h: lint --config (clean, and a planted dangling input), lint
    --journal (a corrupt frame), dump_config, make_diagram, version, trace
    validate on 25f's obs trace file."""
    from paddle_tpu_torch.master_journal import JournalWriter
    from paddle_tpu_torch.v1_compat import parse_config

    cfg = os.path.join(d, "textcls.py")
    cli_write(d, {"dangling.py": CLI_DANGLING})
    jpath = os.path.join(d, "master_journal-000001.log")
    w = JournalWriter(jpath, fsync=False)
    for i in range(4):
        w.append(i + 1, {"t": "join", "worker": f"w{i}"})
    w.close()
    raw = bytearray(open(jpath, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(jpath, "wb") as f:
        f.write(bytes(raw))
    dot = os.path.join(d, "textcls.dot")
    runs = {
        "lint clean": cli_run(tcli, ["lint", "--config", cfg]),
        "lint dangling": cli_run(tcli, ["lint", "--config", os.path.join(d, "dangling.py")]),
        "lint journal": cli_run(tcli, ["lint", "--journal", jpath]),
        "dump_config": cli_run(tcli, ["dump_config", cfg, f"--config_args={V1_ARGS}"]),
        "make_diagram": cli_run(tcli, ["make_diagram", cfg, dot]),
        "version": cli_run(tcli, ["version"]),
        "trace validate": cli_run(tcli, ["trace", "validate", obs_trace]),
    }
    for name, (rc, out) in runs.items():
        lines = out.strip().splitlines()
        say(f"cli 25h: {name}: exit {rc}: {lines[0][:160]}"
            + (f" ... {lines[-1][:160]}" if len(lines) > 1 else ""))
    checks = {
        "lint clean": runs["lint clean"][0] == 0,
        "lint dangling": runs["lint dangling"][0] == 1 and "error[G002]" in runs["lint dangling"][1],
        "lint journal": runs["lint journal"][0] == 1 and "J001" in runs["lint journal"][1],
        "dump_config": runs["dump_config"][1] == parse_config(cfg, V1_ARGS).serialize() + "\n",
        "make_diagram": open(dot).read().startswith("digraph"),
        "version": torch.cuda.get_device_name(0) in runs["version"][1],
        "trace validate": runs["trace validate"][0] == 0,
    }
    if not all(checks.values()):
        raise SystemExit(f"cli 25h: failed {[k for k, v in checks.items() if not v]}")


def phase_cli(torch, P, fa, card, v1):
    """Phase 25: the v1 command line on phase 16's bench_lstm_textcls config
    and corpus (25a-25c, 25f, 25h), an MLP (25d, 25g) and a Transformer-base
    encoder classifier (25e).  Only 25e may launch a flash kernel."""
    import shutil
    import tempfile

    from paddle_tpu_torch import cli as tcli

    d = tempfile.mkdtemp(prefix="cli_textcls_")
    t = [time.perf_counter()]
    try:
        cli_write(d, {"textcls.py": V1_CONFIG, "provider.py": V1_PROVIDER})
        v1_stage(d, "reviews.pkl", text_reviews(np.random.RandomState(0), V1_REVIEWS, TXT_VOCAB,
                                                False))
        phase_cli_shell(d, v1)
        t.append(time.perf_counter())
        P.init(seed=95, compute_dtype="bfloat16")
        reset_counts(fa)
        trainer, parsed = phase_cli_train_test(P, tcli, d)
        phase_cli_checkgrad(torch, tcli, d)
        if launch_counts(fa) != (0, 0, 0):
            raise SystemExit("cli: 25b-25d launched a flash kernel")
        t.append(time.perf_counter())
        phase_cli_encoder(P, fa, tcli, d, card)
        t.append(time.perf_counter())
        obs_trace = phase_cli_profile(torch, P, trainer, parsed, d)
        del trainer
        phase_cli_trap(torch, P, card)
        P.init(compute_dtype="bfloat16")
        phase_cli_faces(torch, tcli, d, obs_trace)
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(d, ignore_errors=True)
    say(f"cli: phase 25 split: 25a {t[1] - t[0]:.1f} s, 25b-25d {t[2] - t[1]:.1f} s, 25e "
        f"{t[3] - t[2]:.1f} s, 25f-25h {t[4] - t[3]:.1f} s")


# phase 26: the dynamic-width repair, the scenario harness and the
# chaos-composition fuzzer (robustness/scenarios.py, robustness/fuzz.py)
DW_BATCHES = (7, 100, 160)
DW_FALL = 0.1  # the pass-mean cost must fall by more than this over 3 passes
DW_RTOL, DW_ATOL = 1e-5, 1e-6  # card vs CPU first-pass costs (f32, TF32 off)
FUZZ_COUNT = 25  # compositions of the clean batch and the canary, as the JAX package's Makefile
FUZZ_CANARY = [{"axis": "arrival", "process": "burst", "rate_factor": 2.0}]


def dw_train(P, dev, batch, passes, params=None):
    """fc(trans(data(12)), size=4, Tanh) -> sum_cost trained with
    Momentum(0.05) on `dev`; returns (trainer, per-batch costs, pass means)."""
    from paddle_tpu_torch.core.topology import reset_auto_names

    reset_auto_names()
    L = P.layer
    x = L.data("x", P.data_type.dense_vector(12))
    cost = L.sum_cost(L.fc(L.trans(x), size=4, act=P.activation.Tanh(), name="dynfc"))
    if params is None:
        params = P.parameters.create(cost, seed=0, device=dev)
        if tuple(params.params["dynfc"]["w0"].shape) != (12, 4):
            raise SystemExit("dynamic width: init did not build the static [12, 4] weight")
    trainer = P.trainer.SGD(cost=cost, parameters=params,
                            update_equation=P.optimizer.Momentum(learning_rate=0.05), device=dev)
    rng = np.random.RandomState(0)
    rows = [(rng.randn(12).astype(np.float32),) for _ in range(batch * 4)]
    costs, means = [], []

    def handler(e):
        if isinstance(e, P.event.EndIteration):
            costs.append(e.cost)
        elif isinstance(e, P.event.EndPass):
            means.append(e.evaluator["mean_cost"])

    trainer.train(reader=P.batch(lambda: iter(rows), batch, drop_last=True),
                  num_passes=passes, event_handler=handler, async_load_data=False)
    return trainer, costs, means


def sc_dynamic_width(torch, P, dev):
    """26a: the dynamic-width repair on the card."""
    from paddle_tpu_torch.core.batch import SeqTensor

    for batch in DW_BATCHES:
        trainer, costs, means = dw_train(P, dev, batch, 3)
        w0 = trainer.parameters.params["dynfc"]["w0"]
        ok = (tuple(w0.shape) == (batch, 4) and w0.device.type == torch.device(dev).type
              and all(np.isfinite(costs)) and means[-1] < means[0] - DW_FALL)
        say(f"dynamic width batch {batch}: w0 {tuple(w0.shape)} on {w0.device}, pass-mean cost "
            f"{' -> '.join(f'{m:.6f}' for m in means)} (must fall by > {DW_FALL})")
        if not ok:
            raise SystemExit(f"dynamic width: batch {batch} did not train")
    # the same imported parameters on the CPU and the card: the resolved
    # [7, 4] weight from the CPU, one pass each
    cpu_tr, _, _ = dw_train(P, "cpu", 7, 0)
    resolved, changed = cpu_tr.network.resolve_dynamic_widths(
        cpu_tr.parameters.params, {"x": SeqTensor(torch.zeros(7, 12))})
    if not changed:
        raise SystemExit("dynamic width: the CPU resolve changed nothing")
    tree = {k: {kk: vv.detach().cpu().numpy() for kk, vv in v.items()}
            for k, v in resolved.items()}
    got = {}
    for d in ("cpu", dev):
        _, costs, _ = dw_train(P, d, 7, 1, params=P.parameters.from_numpy(tree, {}, device=d))
        got[d] = np.asarray(costs, np.float64)
    err = np.abs(got[dev] - got["cpu"])
    say(f"dynamic width batch 7 first pass, card vs CPU from the same parameters: costs "
        f"{np.round(got[dev], 6).tolist()}, worst |d| {err.max():.3e} (bar {DW_RTOL:g} rel + "
        f"{DW_ATOL:g})")
    if not np.all(err <= DW_RTOL * np.abs(got["cpu"]) + DW_ATOL):
        raise SystemExit("dynamic width: the card's first-pass costs differ from the CPU's")


def sc_metrics(r) -> dict:
    """The metrics line of one fast scenario: latency percentiles, goodput,
    the status counts and the recovery time, per window."""
    keep = ("p50_ms", "p95_ms", "p99_ms", "goodput_frac", "goodput_rps", "statuses",
            "n_offered", "wall_s")
    out = {k: r[k] for k in ("scenario", "slo_ms", "saturation_rps", "goodput_2x_over_1x",
                             "recovery_after_fault_ms", "recovery_after_partition_ms",
                             "train_steps_per_s_solo", "train_steps_per_s_mixed", "passed")
           if k in r}
    for win in ("at_1x", "at_2x", "live", "replay"):
        if win in r:
            out[win] = {k: r[win][k] for k in keep if k in r[win]}
    if "at_1x" not in r and "live" not in r:
        out["window"] = {k: r[k] for k in keep if k in r}
    out["gates"] = {k: v for k, v in r.items() if k.startswith("gate_")}
    return out


def sc_fast(P, dev):
    """26b: every fast scenario at the JAX package's default sizes, each on
    a fresh card engine (as ``scenario --all-fast`` builds them), its own
    gates asserted."""
    from paddle_tpu_torch.robustness import scenarios

    times = {}
    for name in scenarios.FAST_SCENARIOS:
        t0 = time.perf_counter()
        r = scenarios.run_scenario(name, device=dev)
        times[name] = time.perf_counter() - t0
        r.pop("_requests", None)
        say(f"scenario {name} ({times[name]:.1f} s): {json.dumps(sc_metrics(r))}")
        if not r.get("passed"):
            raise SystemExit(f"scenario {name} failed its gates: {json.dumps(r)[:4000]}")
    return times


def sc_nan_slot(torch, dev):
    """26b: a NaN in one decode slot's hidden state stays in that slot: the
    other slot's tokens equal its reference decode, and a request admitted
    into the poisoned slot afterwards decodes cleanly."""
    from paddle_tpu_torch.robustness import scenarios
    from paddle_tpu_torch.serving import Request

    eng = scenarios.make_serving_engine(0, device=dev)
    srcs = scenarios._srcs(5, 3)
    r0, r1 = Request(srcs[0]), Request(srcs[1])
    eng.admit([r0, r1])
    sid0 = next(sid for sid, sl in eng._slots.items() if sl.request is r0)
    with torch.no_grad():
        eng._h[sid0] = float("nan")
    done = []
    for _ in range(4 * scenarios._MAXLEN):
        done += eng.step()
        if not eng.n_live:
            break
    want1 = eng.reference_decode(r1.src_ids, scenarios._MAXLEN)
    r2 = Request(srcs[2])
    eng.admit([r2])
    for _ in range(4 * scenarios._MAXLEN):
        eng.step()
        if not eng.n_live:
            break
    want2 = eng.reference_decode(r2.src_ids, scenarios._MAXLEN)
    say(f"nan slot isolation: slot {sid0} poisoned; the other slot's {len(r1.tokens)} tokens "
        f"{'equal' if r1.tokens == want1 else 'DIFFER from'} its reference decode; the next "
        f"request's {len(r2.tokens)} tokens {'equal' if r2.tokens == want2 else 'DIFFER from'} "
        f"its reference; pages in use after: {eng.pages.n_used}")
    if r1.tokens != want1 or r2.tokens != want2 or eng.pages.n_used or eng.n_live:
        raise SystemExit("nan slot isolation: a NaN in one slot reached another request")


class ScCli:
    """``python -m paddle_tpu_torch <argv>`` started as a subprocess, on the
    card by default (``--device`` only elsewhere), its output in files
    under `d`; ``result()`` waits within `timeout` (killing it past that)
    and gives (exit code, stdout, stderr, seconds of command)."""

    def __init__(self, argv, d, dev, timeout, tag):
        env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
        argv = list(argv) + ([] if dev == "cuda" else ["--device", dev])
        self.paths = [os.path.join(d, f"{tag}.{k}") for k in ("out", "err")]
        self.files = [open(p, "w") for p in self.paths]
        self.timeout = timeout
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", "paddle_tpu_torch", *argv], cwd=d,
                                     env=env, stdout=self.files[0], stderr=self.files[1])

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)

    def result(self):
        try:
            self.proc.wait(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
        secs = time.perf_counter() - self.t0
        for f in self.files:
            f.close()
        out, err = (open(p).read() for p in self.paths)
        return self.proc.returncode, out, err, secs


def sc_fuzz_clean(run):
    rc, out, err, secs = run.result()
    say(f"fuzz clean batch (--count {FUZZ_COUNT} --seed 0): exit {rc} in {secs:.1f} s: "
        f"{out.strip().splitlines()[-1] if out.strip() else err[-500:]}")
    if rc != 0 or f"clean: {FUZZ_COUNT} compositions" not in out:
        raise SystemExit(f"fuzz: the clean batch was not clean:\n{out[-3000:]}\n{err[-3000:]}")


def sc_fuzz_canary(d, dev):
    """26c: the planted canary, found and shrunk to the one overload item,
    and its spec replayed."""
    spec_path = os.path.join(d, "ledger_skew.spec.json")
    rc, out, err, secs = ScCli(["fuzz", "--count", str(FUZZ_COUNT), "--seed", "7", "--plant",
                                "ledger_skew", "--out", spec_path], d, dev, 600,
                               "canary").result()
    if not os.path.exists(spec_path):
        raise SystemExit(f"fuzz: the canary wrote no spec (exit {rc}):\n{out[-3000:]}\n"
                         f"{err[-3000:]}")
    with open(spec_path) as f:
        spec = json.load(f)
    say(f"fuzz canary (--seed 7 --plant ledger_skew): exit {rc} in {secs:.1f} s; shrunk to "
        f"{spec['items']} after composition {spec['index']}: {spec['violations']}")
    if rc != 1 or spec["items"] != FUZZ_CANARY or spec["planted"] != "ledger_skew" or not any(
            v.startswith("ledger_sum_mismatch") for v in spec["violations"]):
        raise SystemExit(f"fuzz: the canary was not found and shrunk:\n{out[-3000:]}")
    rc, out, err, secs = ScCli(["fuzz", "--replay", spec_path], d, dev, 300, "replay").result()
    say(f"fuzz replay of the shrunk spec: exit {rc} in {secs:.1f} s: "
        f"{' '.join(out.split()[:3])}")
    if rc != 0 or "reproduced" not in out:
        raise SystemExit(f"fuzz: the replay did not reproduce:\n{out[-2000:]}\n{err[-2000:]}")


def sc_drill(name, run):
    """26d: one drill's own gates through the command line, engines on the
    card, and for the worker kill also zero recomputed tasks."""
    rc, out, err, secs = run.result()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    r = json.loads(lines[-1]) if lines else {}
    say(f"drill {name}: exit {rc}, {secs:.1f} s of command: {json.dumps(r)}")
    ok = rc == 0 and r.get("passed") is True
    if name == "fleet_kill_worker":
        ok = ok and r.get("recovery_after_fault_s") is not None and r.get(
            "zero_recomputed_tasks") is True and r.get("train_params_bit_identical") is True \
            and r.get("only_shed_or_timeout_failed") is True
    else:
        ok = ok and r.get("min_live_engines", 0) >= r.get("n_engines", 2) - 1 and all(
            s in ("served", "shed", "timeout") or n == 0 for s, n in r.get("statuses", {}).items())
    if not ok:
        raise SystemExit(f"drill {name} failed:\n{out[-3000:]}\n{err[-3000:]}")


def sc_processes(d, dev):
    """26c and 26d.  Their gates are structural (exit codes, ledgers,
    bit-identity, leaks), so the clean fuzz batch and the worker-kill drill
    run beside the canary; the rolling restart, whose 2 s engine leases a
    busy host could expire, runs alone."""
    runs = [ScCli(["fuzz", "--count", str(FUZZ_COUNT), "--seed", "0"], d, dev, 600, "clean"),
            ScCli(["scenario", "--name", "fleet_kill_worker", "--workdir",
                   os.path.join(d, "fleet_kill_worker")], d, dev, 600, "kill_worker")]
    try:
        sc_fuzz_canary(d, dev)
        sc_fuzz_clean(runs[0])
        sc_drill("fleet_kill_worker", runs[1])
        runs.append(ScCli(["scenario", "--name", "fleet_rolling_restart", "--workdir",
                           os.path.join(d, "fleet_rolling_restart")], d, dev, 600, "rolling"))
        sc_drill("fleet_rolling_restart", runs[2])
    finally:
        for run in runs:  # a failed check leaves no process behind
            run.stop()


def phase_scenarios(torch, P, fa, card, dev="cuda"):
    """Phase 26: the dynamic-width repair (26a), the fast scenarios and the
    NaN slot check (26b), the fuzzer (26c) and two fleet drills (26d), the
    subprocesses of 26c-26d partly side by side.  No flash kernel may
    launch."""
    import shutil
    import tempfile

    P.init(compute_dtype="float32", device=dev)
    reset_counts(fa)
    d = tempfile.mkdtemp(prefix="scenarios_")
    t = [time.perf_counter()]
    try:
        sc_dynamic_width(torch, P, dev)
        t.append(time.perf_counter())
        times = sc_fast(P, dev)
        sc_nan_slot(torch, dev)
        t.append(time.perf_counter())
        sc_processes(d, dev)
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("scenarios: phase 26 launched a flash kernel")
    say(f"scenarios: phase 26 split on {card}: 26a {t[1] - t[0]:.1f} s, 26b {t[2] - t[1]:.1f} s "
        f"({', '.join(f'{k} {v:.1f}' for k, v in times.items())}), 26c-26d {t[3] - t[2]:.1f} s; "
        f"flash launches (fwd, dq, dkv) over it: {launch_counts(fa)}")


# phase 27: the jax-free lints and the interleaving explorer (analysis/
# ast_rules.py, concurrency_lint.py, protocol_lint.py, interleave.py)
EXPLORE_BATCH = (  # the JAX package's Makefile batch: (model, schedules, seed, dfs depth)
    ("router", 200, 0, 3), ("ha", 200, 0, 4), ("master", 60, 0, 0))


def gate_lints(tcli, card):
    """27a: the self-lint (with this script), ``--concurrency`` and
    ``--protocol`` over the port's tree through the command line, each clean;
    seconds of each beside the card."""
    times = {}
    for name, argv in (("self-lint", ["lint", "--extra", os.path.join(HERE, "chip_smoke.py")]),
                       ("concurrency", ["lint", "--concurrency"]),
                       ("protocol", ["lint", "--protocol"])):
        t0 = time.perf_counter()
        rc, out = cli_run(tcli, argv)
        times[name] = time.perf_counter() - t0
        if rc != 0 or "no diagnostics" not in out:
            raise SystemExit(f"gates 27a: lint {name} exited {rc}:\n{out[-3000:]}")
    say(f"gates 27a on {card}: lint " + ", ".join(f"{k} {v:.2f} s" for k, v in times.items())
        + ", each clean")


def gate_planted(d):
    """27b: ``reader/creator.py`` copied into a temporary tree with its first
    A206 pragma cut off must report A206 at that line, and nothing else."""
    from paddle_tpu_torch.analysis import ast_rules

    src_path = os.path.join(HERE, "paddle_tpu_torch", "reader", "creator.py")
    with open(src_path) as f:
        lines = f.read().split("\n")
    at = next(i for i, line in enumerate(lines) if "# wire: allow[A206]" in line)
    lines[at] = lines[at][:lines[at].index("# wire:")].rstrip()
    copy = os.path.join(d, "paddle_tpu_torch", "reader", "creator.py")
    os.makedirs(os.path.dirname(copy))
    with open(copy, "w") as f:
        f.write("\n".join(lines))
    found = [(x.rule, x.line) for x in ast_rules.lint_file(copy, root=d)]
    if found != [("A206", at + 1)]:
        raise SystemExit(f"gates 27b: the planted raw pickle.loads at creator.py:{at + 1} gave "
                         f"{found}, not [('A206', {at + 1})]")
    say(f"gates 27b: pragma cut at reader/creator.py:{at + 1}: the self-lint reports {found}")


def gate_explore(tcli, d, card):
    """27c: the explore batch of the JAX package's Makefile: three clean
    models, then the double_serve canary (exit 1, shrunk to at most 6
    events) and the replay of its spec (exit 0)."""
    import re

    for model, schedules, seed, depth in EXPLORE_BATCH:
        argv = ["explore", "--model", model, "--schedules", str(schedules), "--seed", str(seed)]
        if depth:
            argv += ["--dfs-depth", str(depth)]
        t0 = time.perf_counter()
        rc, out = cli_run(tcli, argv)
        secs = time.perf_counter() - t0
        if rc != 0 or f"clean: {schedules} schedules on model {model!r}" not in out:
            raise SystemExit(f"gates 27c: explore {model} exited {rc}:\n{out[-3000:]}")
        m = re.search(r"dfs: (\d+) paths", out)
        paths = int(m.group(1)) if m else 0
        say(f"gates 27c on {card}: explore {model}: {schedules} schedules (seed {seed})"
            + (f" + {paths} dfs paths to depth {depth}" if depth else "")
            + f" clean in {secs:.2f} s, {(schedules + paths) / secs:.1f} runs/s")
    spec_path = os.path.join(d, "double_serve.spec.json")
    t0 = time.perf_counter()
    rc, out = cli_run(tcli, ["explore", "--model", "router", "--schedules", "200", "--seed", "7",
                             "--max-events", "12", "--plant", "double_serve",
                             "--out", spec_path])
    canary_s = time.perf_counter() - t0
    if rc != 1 or "double-serve" not in out or not os.path.exists(spec_path):
        raise SystemExit(f"gates 27c: the double_serve canary exited {rc}:\n{out[-3000:]}")
    with open(spec_path) as f:
        spec = json.load(f)
    if len(spec["events"]) > 6:
        raise SystemExit(f"gates 27c: the canary shrank to {len(spec['events'])} events, not <= 6")
    t0 = time.perf_counter()
    rc, out = cli_run(tcli, ["explore", "--replay", spec_path])
    replay_s = time.perf_counter() - t0
    if rc != 0 or "reproduced" not in out:
        raise SystemExit(f"gates 27c: the canary spec's replay exited {rc}:\n{out[-3000:]}")
    say(f"gates 27c on {card}: canary double_serve found and shrunk to {len(spec['events'])} "
        f"events ({' -> '.join(e['op'] for e in spec['events'])}) in {canary_s:.2f} s, "
        f"replay reproduced in {replay_s:.2f} s")


def phase_gates(fa, card):
    """Phase 27: the port's static gates and the interleaving explorer
    through ``paddle_tpu_torch.cli.main``: host code that imports no JAX.
    No flash kernel may launch."""
    import logging
    import shutil
    import tempfile

    from paddle_tpu_torch import cli as tcli

    reset_counts(fa)
    level = logging.getLogger("paddle_tpu_torch").level
    d = tempfile.mkdtemp(prefix="gates_")
    t = [time.perf_counter()]
    try:
        gate_lints(tcli, card)
        t.append(time.perf_counter())
        gate_planted(d)
        t.append(time.perf_counter())
        gate_explore(tcli, d, card)
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(d, ignore_errors=True)
        logging.getLogger("paddle_tpu_torch").setLevel(level)
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("gates: phase 27 launched a flash kernel")
    say(f"gates: phase 27 split on {card}: 27a {t[1] - t[0]:.2f} s, 27b {t[2] - t[1]:.2f} s, "
        f"27c {t[3] - t[2]:.2f} s; flash launches (fwd, dq, dkv) over it: {launch_counts(fa)}")


# Phase 28: the traced-step lints and the numerics sanitizer (PR 24).  The
# step is phase 5's: Transformer-base, bf16 compute over f32 masters, B=8,
# lengths 600-1024, flash on.
NS_LAYER = "enc0_att"  # the first encoder attention: the planted faults' weight
NS_Q_MAX = 1e38  # the overflow plant scales the query weight until max |q| is this:
# finite in bf16 (max 3.39e38), while q.k over dh = 64 passes the f32 range
NS_CONFIGS = ("demo_mnist_mlp.py", "demo_seq2seq_attention.py", "demo_text_lstm.py")


def lint_legs_drive(half: int) -> int:
    """28a in its own process (two, each running one half of the legs): the
    port's command line lints traced train steps on the card —
    ``--numerics`` over the package probes and over tests/configs/*.py, at
    f32 and at bf16 compute (28b runs ``--donation``'s audit, raw and with
    the pragmas).  Prints each leg's exit code, seconds and findings; exits
    1 unless every leg is clean."""
    from paddle_tpu_torch import cli as tcli

    cfgs = []
    for c in NS_CONFIGS:
        cfgs += ["--config", os.path.join(HERE, "tests", "configs", c)]
    bf16 = ["--compute-dtype", "bfloat16"]
    legs = ((("numerics f32", ["lint", "--numerics"]),
             ("numerics configs f32", ["lint", "--numerics"] + cfgs)),
            (("numerics bf16", ["lint", "--numerics"] + bf16),
             ("numerics configs bf16", ["lint", "--numerics"] + bf16 + cfgs)))[half]
    bad = 0
    for name, argv in legs:
        t0 = time.perf_counter()
        rc, out = cli_run(tcli, argv)
        findings = [ln for ln in out.splitlines() if re.match(r"(error|warning|info)\[", ln)]
        say(f"lint 28a {name}: exit {rc} in {time.perf_counter() - t0:.2f} s, "
            f"{len(findings)} finding(s) {findings}")
        bad += rc != 0 or "no diagnostics" not in out
    return 1 if bad else 0


def f32_acc_drive() -> int:
    """28d in its own process, which never sets the reduced-precision
    switch: ``init(compute_dtype="bfloat16")`` pins f32 accumulation, N401
    stays clean on a bf16 step; with the switch forced True it fires on
    the step's GEMMs."""
    import torch

    import paddle_tpu_torch as P
    from paddle_tpu_torch.analysis import numerics_lint as NL
    from paddle_tpu_torch.analysis import trace_lint as TL
    from paddle_tpu_torch.models.transformer import transformer_cost
    from paddle_tpu_torch.reader.feeder import DataFeeder
    from paddle_tpu_torch.trainer.step import make_train_step

    m = torch.backends.cuda.matmul
    before = m.allow_bf16_reduced_precision_reduction
    P.init(seed=3, compute_dtype="bfloat16", use_flash_attention=True)
    after = m.allow_bf16_reduced_precision_reduction
    cost, _ = transformer_cost(512, 512, d_model=64, n_heads=4, n_layers=1, d_ff=128)
    net = P.CompiledNetwork(P.Topology(cost))
    params, state = net.init(3)
    opt = P.optimizer.Momentum(learning_rate=1e-3, momentum=0.9)
    rng = np.random.RandomState(3)
    batch = DataFeeder(net.topology.data_types(), FEEDING)(
        [tuple(list(rng.randint(2, 512, 128)) for _ in range(3)) for _ in range(4)])
    step = make_train_step(net, opt)
    clean = NL.lint_numerics_graph(TL.trace_step(step, params, state, opt.init(params), batch, 1))
    m.allow_bf16_reduced_precision_reduction = True
    forced = NL.lint_numerics_graph(TL.trace_step(step, params, state, opt.init(params), batch, 1))
    n401 = [d for d in forced if d.rule == "N401"]
    say(f"f32 accumulation 28d: switch {before} before init, {after} after "
        f"init(compute_dtype='bfloat16'); N401 on the bf16 step {sum(d.rule == 'N401' for d in clean)}"
        f" with it pinned, {len(n401)} with it forced True, e.g. "
        f"{n401[0].message[:90] if n401 else '-'}")
    ok = before is True and after is False and not clean and n401 \
        and all(d.rule == "N401" for d in forced)
    return 0 if ok else 1


def ns_drive(call):
    """A ``python -c`` subprocess running chip_smoke's drive `call` (28a or
    28d), its output kept for the end of the phase."""
    code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke as cs; "
            f"sys.exit(cs.{call})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def ns_step_parts(torch, P, dev, rng):
    """Phase 5's network, a fresh Momentum state and one batch."""
    from paddle_tpu_torch.models.transformer import transformer_base
    from paddle_tpu_torch.reader.feeder import DataFeeder

    cost, _ = transformer_base(VOCAB, VOCAB)
    samples = train_samples(rng, BATCH)
    net = P.CompiledNetwork(P.Topology(cost))
    batch = DataFeeder(net.topology.data_types(), FEEDING, device=dev)(samples)
    return cost, net, samples, batch


def ns_trace(torch, P, fa, card, cost, net, batch, dev):
    """28b: one traced Transformer-base train step, its flash nodes, the
    T-rules raw and triaged, the numerics lint at bf16 and three
    certificates."""
    from paddle_tpu_torch.analysis import format_diagnostics
    from paddle_tpu_torch.analysis import numerics_lint as NL
    from paddle_tpu_torch.analysis import trace_lint as TL
    from paddle_tpu_torch.trainer.step import make_train_step

    params, state = net.init(11, device=dev)
    opt = P.optimizer.Momentum(learning_rate=TRAIN_LR, momentum=0.9)
    before = launch_counts(fa)
    tr = TL.trace_step(make_train_step(net, opt), params, state, opt.init(params), batch, 1)
    torch.cuda.synchronize()
    ran = tuple(a - b for a, b in zip(launch_counts(fa), before))
    ops = [TL.op_name(n) for n in tr.graph.nodes if n.op == "call_function"]
    fwd = [n for n in tr.graph.nodes if n.op == "call_function"
           and TL.op_name(n) == "paddle_tpu_torch.flash_attention_fwd"]
    n_fwd, n_bwd = len(fwd), ops.count("paddle_tpu_torch.flash_attention_bwd")
    say(f"trace 28b on {card}: Transformer-base step traced in {tr.seconds:.2f} s, "
        f"{len(tr.graph.nodes)} nodes, flash custom-op nodes {n_fwd} forward / {n_bwd} "
        f"backward (layers {sorted({TL.node_layer(n) for n in fwd})[:3]}...), launches the "
        f"trace ran (fwd, dq, dkv) {ran}")
    if (n_fwd, n_bwd) != (18, 18) or ran != (18, 18, 18):
        raise SystemExit("trace 28b: expected 18 forward and 18 backward flash nodes, each "
                         "launched once by the trace")
    raw = TL.lint_graph(tr, apply_pragmas=False)
    kept = TL.lint_graph(tr)
    say(f"trace 28b T-rules without pragmas ({len(raw)}): " + " | ".join(
        f"{d.rule} {d.message}" for d in raw))
    if not any(d.rule == "T103" and "trainer/step.py" in d.message for d in raw) or kept:
        raise SystemExit(f"trace 28b: the step's one sync is not named, or a T finding is "
                         f"left:\n{format_diagnostics(kept)}")
    # lint --donation's audit of the three step builders on its probe MLP (a
    # full-width epoch would be one more full trace): raw, the epoch
    # program's snapshot of the carry; with the pragmas (the command's own
    # run), clean
    from paddle_tpu_torch import cli as tcli

    t0 = time.perf_counter()
    t106 = tcli._donation_audit_builders(dev, apply_pragmas=False)
    t106_kept = tcli._donation_audit_builders(dev)
    say(f"trace 28b lint --donation's audit, raw and with the pragmas "
        f"({time.perf_counter() - t0:.2f} s), step builders without pragmas: "
        + " | ".join(f"{d.rule} {d.source} {d.message}" for d in t106)
        + f"; with them {len(t106_kept)} finding(s)")
    if not any(d.rule == "T106" and "make_epoch_program" in d.source and "clones" in d.message
               for d in t106) or t106_kept:
        raise SystemExit("trace 28b: the epoch program's clone of the carry is not named, or "
                         f"a donation finding is left:\n{format_diagnostics(t106_kept)}")
    t0 = time.perf_counter()
    cert = NL.certify_precision_plan(net.topology, {"compute_dtype": "bfloat16"}, _traced=tr)
    nl_s = time.perf_counter() - t0
    say(f"trace 28b numerics lint at bf16 ({nl_s:.2f} s): {len(cert.diagnostics)} finding(s) "
        f"{[(d.rule, d.layer) for d in cert.diagnostics]}")
    rej = NL.certify_precision_plan(net.topology, {"compute_dtype": "bfloat16",
                                                   "master_dtype": "bfloat16"}, _traced=tr)
    int8 = NL.certify_precision_plan(net.topology, {"master_dtype": "int8"})
    verdicts = [c.format().splitlines()[0] for c in (cert, rej, int8)]
    say(f"trace 28b certificates: {verdicts}; the ACCEPT's first rows: "
        + "; ".join(f"{r['layer']} {r['dtype']} {r['dots']}({r['acc']})" for r in cert.rows[:4]))
    if not (cert.ok and not rej.ok and "N402" in {d.rule for d in rej.diagnostics}
            and not int8.ok and int8.rows == [] and not cert.diagnostics):
        raise SystemExit("trace 28b: the certificates are not ACCEPT / REJECT(N402) / "
                         "REJECT without a trace, or the bf16 step has numerics findings:\n"
                         + cert.format())
    return tr


def ns_postmortem(torch, P, fa, trainer, samples, d, what):
    """One skipped step of `trainer` with the sanitizer armed: the flight
    dump's numerics record, and the launches (fwd, dq, dkv) the call made."""
    from paddle_tpu_torch.utils.timers import global_stats

    path = os.path.join(d, f"flight-{os.getpid()}.json")
    if os.path.exists(path):
        os.remove(path)
    before = {k: v.clone() for k, v in trainer.parameters.params[NS_LAYER].items()}
    skipped = global_stats.count("robustness.skipped_steps")
    costs = []
    counts = launch_counts(fa)
    t0 = time.perf_counter()
    run_steps(P, trainer, samples,
              lambda e: costs.append(e.cost) if isinstance(e, P.event.EndIteration) else None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = tuple(a - b for a, b in zip(launch_counts(fa), counts))
    if not os.path.exists(path):
        raise SystemExit(f"sanitizer 28c {what}: no flight dump at {path}")
    with open(path) as f:
        rec = json.load(f)["otherData"]["numerics"]
    same = all(torch.equal(v, before[k]) or k == "wq"
               for k, v in trainer.parameters.params[NS_LAYER].items())
    say(f"sanitizer 28c {what}: cost {costs}, skipped by the sentinel "
        f"{global_stats.count('robustness.skipped_steps') - skipped}, params untouched {same}; "
        f"postmortem in {secs:.2f} s (step, trace and re-execution): first non-finite "
        f"{rec['node']} layer {rec['layer']} at {rec['source']}:{rec['line']}, inputs "
        f"{[(s['shape'], s['dtype'], s.get('max_abs'), s.get('n_nonfinite')) for s in rec['inputs'][:3]]}"
        f", poisoned inputs {[p['input'] for p in rec['poisoned_inputs']]}; flash launches "
        f"(fwd, dq, dkv) {launches}; flight dump {path}")
    if np.isfinite(costs[0]) or not same:
        raise SystemExit(f"sanitizer 28c {what}: the planted step was not skipped")
    return rec, launches


def ns_sanitize(torch, P, fa, card, cost, net, samples, dev):
    """28c: the sanitizer armed through SGD.train on phase 5's model."""
    import tempfile

    from paddle_tpu_torch.utils.timers import global_stats

    d = tempfile.mkdtemp(prefix="numsan_")
    P.flags.set_flag("trace_dir", d)
    trainers = []
    for armed in (True, False):
        P.flags.set_flag("num_sanitizer", armed)
        t = P.trainer.SGD(cost, P.parameters.create(cost, seed=11),
                          P.optimizer.Momentum(learning_rate=TRAIN_LR, momentum=0.9))
        caps = global_stats.count("num_sanitizer/captures")
        t0 = time.perf_counter()
        run_steps(P, t, samples)
        torch.cuda.synchronize()
        trainers.append((t, global_stats.count("num_sanitizer/captures") - caps,
                         time.perf_counter() - t0))
    (a, caps_a, secs_a), (b, caps_b, secs_b) = trainers
    equal = all(torch.equal(v, b.parameters.params[k][kk])
                for k, dd in a.parameters.params.items() for kk, v in dd.items())
    say(f"sanitizer 28c on {card}: one healthy step armed {secs_a:.2f} s ({caps_a} capture), "
        f"unarmed {secs_b:.2f} s ({caps_b}); parameters torch.equal after it: {equal}")
    if (caps_a, caps_b) != (1, 0) or not equal:
        raise SystemExit("sanitizer 28c: the armed step captured otherwise than once, or "
                         "changed the trajectory")
    del b, trainers
    P.flags.set_flag("num_sanitizer", True)
    wq = a.parameters.params[NS_LAYER]["wq"]
    saved = wq.detach().clone()
    with torch.no_grad():
        wq[0, 0] = float("nan")
    rec, _ = ns_postmortem(torch, P, fa, a, samples, d, "NaN in the query weight")
    if rec["primitive"] != "aten.mm" or rec["layer"] != NS_LAYER:
        raise SystemExit("sanitizer 28c: the NaN postmortem does not name the query mm")
    with torch.no_grad():
        wq.copy_(saved)
        feeder_batch = a._make_feeder(FEEDING)(samples)
        outs, _ = a.network.apply(a.parameters.params, feeder_batch, state=a.parameters.state,
                                  train=True)
        q = outs[a.network.topology.layers[NS_LAYER].inputs[0]].data \
            @ wq.to(torch.bfloat16)
        alpha = NS_Q_MAX / float(q.abs().max().float())
        del outs, q
        wq.mul_(alpha)
    rec, launches = ns_postmortem(torch, P, fa, a, samples, d,
                                  f"query weight x{alpha:.3e} (q.k past f32)")
    interp_fwd = launches[0] - 36
    say(f"sanitizer 28c: the re-execution launched the forward kernel {interp_fwd} more "
        f"time(s) (launches beyond the step's and the trace's 18 each), dq/dkv "
        f"{launches[1] - 36}/{launches[2] - 36}")
    if (rec["primitive"] != "paddle_tpu_torch.flash_attention_fwd" or rec["layer"] != NS_LAYER
            or rec["inputs"][0].get("n_nonfinite") or interp_fwd < 1
            or launches[1:] != (36, 36)):
        raise SystemExit("sanitizer 28c: the overflow postmortem does not name the flash "
                         "forward node, or the re-execution did not launch its kernel")
    with torch.no_grad():
        wq.copy_(saved)
    P.flags.set_flag("num_sanitizer", False)
    P.flags.set_flag("trace_dir", "")
    shutil.rmtree(d, ignore_errors=True)


def phase_numerics(torch, P, fa, card):
    """Phase 28: 28a (two processes) and 28d run in subprocesses beside 28b
    and 28c."""
    procs = {"28a": ns_drive("lint_legs_drive(0)"), "28a'": ns_drive("lint_legs_drive(1)"),
             "28d": ns_drive("f32_acc_drive()")}
    t = [time.perf_counter()]
    dev = torch.device("cuda")
    P.init(seed=11, compute_dtype="bfloat16", use_flash_attention=True)
    cost, net, samples, batch = ns_step_parts(torch, P, dev, np.random.RandomState(28))
    ns_trace(torch, P, fa, card, cost, net, batch, dev)
    t.append(time.perf_counter())
    ns_sanitize(torch, P, fa, card, cost, net, samples, dev)
    t.append(time.perf_counter())
    failed = []
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        for line in out.strip().splitlines():
            say(f"  {name}| {line}")
        if proc.returncode != 0:
            failed.append(name)
    t.append(time.perf_counter())
    say(f"numerics: phase 28 split on {card}: 28b {t[1] - t[0]:.2f} s, 28c {t[2] - t[1]:.2f} s,"
        f" then waited {t[3] - t[2]:.2f} s for 28a and 28d (run beside them)")
    if failed:
        raise SystemExit(f"numerics: {failed} failed")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import paddle_tpu_torch as P
        from paddle_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    start = time.perf_counter()
    card = card_line()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    say("tf32 off for matmul and cudnn; bf16 reduced-precision reductions off")
    report, secs = build_with_report(fa)
    say(f"build: {', '.join(os.path.basename(x) for x in fa.SOURCES)} in {secs:.2f} s")
    for name, regs, st, ld in report:
        say(f"ptxas: {name}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    if not report:
        say("ptxas: the library was built before this run; no report")

    rows = {"fwd": phase_kernel(torch, fa)}
    phase_slice(torch, P, fa, card)
    rows.update(phase_bwd_kernel(torch, fa))
    phase_bar_sweep(torch, fa)
    phase_edges(torch, fa)
    launches, trainer, phase5_s = phase_train(torch, P, fa, card)
    phase_dispatch(torch, P, fa, card, trainer)
    phase_profile(torch, P, trainer)
    del trainer
    # the ResNet path runs no flash kernel: its counts stay 0 over phases 8, 7, 9
    reset_counts(fa)
    t0 = time.perf_counter()
    rn_trainer, rn_probs = phase_resnet_train(torch, P, card)
    phase_resnet_infer(torch, P, rn_probs, rn_trainer, card)
    phase_resnet_profile(torch, P, rn_trainer)
    say(f"resnet: phases 8, 7, 9 took {time.perf_counter() - t0:.1f} s; flash launches "
        f"(fwd, dq, dkv) over them: {launch_counts(fa)}")
    if launch_counts(fa) != (0, 0, 0):
        raise SystemExit("the ResNet path launched a flash kernel")
    trainer_dev = rn_trainer.device
    del rn_trainer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spine_params = phase_spine(torch, P, fa, card, phase5_s)
    phase_optimizers(torch, P, spine_params, trainer_dev)
    del spine_params
    phase_dropout_clip(torch, P, trainer_dev)
    say(f"spine: phases 10, 10b, 10c took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_nmt(torch, P, fa, card)
    say(f"nmt: phase 11 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_generate(torch, P, fa, card)
    say(f"generate: phase 12 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_serve(torch, P, fa, card)
    say(f"serve: phase 13 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lstm14 = phase_text_lstm(torch, P, fa, card)
    say(f"text lstm: phase 14 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_tagger(torch, P, fa, card)
    say(f"tagger: phase 15 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    v1 = phase_v1(torch, P, fa, card, lstm14)
    say(f"v1: phase 16 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_nested(torch, P, fa, card)
    say(f"nested: phase 17 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_costs(torch, P, fa, card)
    say(f"costs: phase 18 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_image_ctc(torch, P, fa, card)
    say(f"image: phase 19 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_last_types(torch, P, fa, card)
    say(f"last types: phase 20 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_framework_gen(torch, P, fa, card)
    say(f"framework: phase 21 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_training_plane(torch, P, fa, card)
    say(f"training plane: phase 22 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_elastic(torch, P, fa, card)
    say(f"elastic: phase 23 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_serving_plane(torch, P, fa, card)
    say(f"serving plane: phase 24 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_cli(torch, P, fa, card, v1)
    say(f"cli: phase 25 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_scenarios(torch, P, fa, card)
    say(f"scenarios: phase 26 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_gates(fa, card)
    say(f"gates: phase 27 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reset_counts(fa)
    phase_numerics(torch, P, fa, card)
    launches28 = launch_counts(fa)
    say(f"numerics: phase 28 took {time.perf_counter() - t0:.1f} s; flash launches (fwd, dq, "
        f"dkv) over it: {launches28}")
    kernels = [
        {"name": name, "route": "cuda", "source": f"paddle_tpu_torch/csrc/{src}",
         "replaces": f"paddle_tpu/ops/pallas_attention.py:{line}",
         "launches": launches[kn],
         "phase28_launches": launches28[("fwd", "dq", "dkv").index(kn)],
         **{key: rows[kn][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for kn, name, src, line in (
            ("fwd", "flash_attention_fwd", "flash_attention_fwd.cu", 82),
            ("dq", "flash_attention_bwd_dq", "flash_attention_bwd.cu", 133),
            ("dkv", "flash_attention_bwd_dkv", "flash_attention_bwd.cu", 173),
        )
    ]
    say(f"chip_smoke: all phases in {time.perf_counter() - start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
