#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                   # every phase, one card
    python3 chip_smoke.py --only kernels    # build + kernel checks only
    python3 chip_smoke.py --ptxas           # also print nvcc's `ptxas -v`
                                            # (fails on a K1-K3, K6, K8 or
                                            # K9 spill, or on serialised
                                            # wgmma in the bf16 K1-K3)
    python3 chip_smoke.py --trace out.json  # keep the traced steps' traces

Transformer-base runs at its full depth (6+6 layers) and width, the
IMDB sentiment classifiers at their book widths, the attention
translator of book chapter 08 at the reference benchmark's widths, the
DeepASR stacked-LSTMP acoustic model at its train.py widths, book
chapter 02's LeNet, ResNet-50, VGG-16, AlexNet, GoogLeNet and
SE-ResNeXt-50 at 224 x 224, the CTR model, the recommender, word2vec and
the PTB language model at their defaults, book chapter 07's semantic
role labeller at the book's widths, the CRNN-CTC OCR model at the
PaddlePaddle models repo's settings, and the beam decoders of
Transformer-base and the translator, with random weights from the fixed
seed SEED.

Phases, each reported on lines of its own; any failure exits non-zero:

1. device   — refuse to run without CUDA; print the card's name and power
              limit as nvidia-smi reports them.
2. build    — compile the hand-written kernels from paddle_tpu_torch/csrc
              (nvcc, one process per source) and report the seconds.
3. kernels  — hold each kernel against its plain PyTorch version on the
              card at the main paths' shapes (max |kernel - plain| <= 1e-4:
              fp32 with a different summation order; for the flash
              backward the error is relative to max(1, max |plain|), as
              its sums run over up to T terms), and time the kernel,
              the plain version and one library call computing the same
              function (CUDA graph of 20 calls, CUDA events, warmup,
              median), beside the least time the card could take (bound).
              K6 (fused LSTM, a thread-block cluster per group of rows;
              its launch plan printed) is checked forward and reverse,
              with zero and given h0/c0, each launched directly and
              replayed from a CUDA graph, at a serving dispatch's x [8,
              256, 512] and a training step's [128, 64, 512] (h = 128),
              at B = 1 and 4, T = 1, a length-0 row (exactly h0 and c0),
              D 1, 37, 100 and 512 (W streamed from L2), x cut as a
              strided view from a wider buffer, and under plans pinned
              to every cluster size 1-16; timed beside the K6 of
              commit 276bea2 (--k6-baseline, or git history), cuDNN's
              LSTM and the step floor (k6_ablation.py's "floor": the
              same launch doing only the exchange of h and the cluster
              barrier). K9 (masked pool, a thread-block cluster over
              time per row and feature tile, 16-byte loads) in its three
              pool types at the conv net's x [8, 256, 32], a wide [128,
              256, 512] and a long [4, 4096, 512] (ragged lengths with 1
              and T), at B = 70000 (fault C6), T = 1, F = 3, an
              unaligned and a strided x, lengths 0 (exactly 0), negative
              and over T, under every pinned cluster size (each plan run
              twice: the same bits) and from a CUDA graph; timed beside
              the launch floor (an empty kernel), the K9 of commit
              bc496a2 (--k9-baseline, or git history) and x.sum(1), the
              wide shape also cold (calls rotating over copies of x
              beyond L2). K8 (masked softmax) at the
              translator's decoder step x [16, 48], a wide [2048, 256],
              T 1023 and 3000 (the online pass above the registers'
              1024) and rows whose stride is not a multiple of 4,
              lengths 0, 1 and T, direct and from a CUDA graph; timed at
              the first two beside the K8 of commit 276bea2
              (--k8-baseline); its library call is torch.softmax(x, 1)
              at full lengths. K4 is also held on
              labels -1 and V, which pick class V - 1 (the JAX CPU rule).
              K7 (fused LSTMP, one cooperative launch of one block per
              SM) is checked forward and reverse, with zero and given
              r0/c0, at a serving dispatch's x [8, 512, 4096] and a
              training step's [32, 512, 4096] (D 1024, P 512), at B = 1,
              at T = 1, at D 1000 / P 500, at hidden 8 / proj 4, with
              weights read from L2 (D 4096 / P 2048) and at B = 1024
              (no x prefetch), ragged lengths with 1 and T, and replayed
              from a CUDA graph; its library call is torch.nn.LSTM(1320, 1024,
              proj_size=512) (cuDNN) on the frames at full lengths, which
              has no tanh on its projection: only its time compares. The
              K7 of commit c644094 (one block per batch row) is built
              from its source (--k7-baseline, or git history) and timed
              beside it. K1 (flash forward) and K2/K3 (flash backward),
              all three 3xTF32 on the tensor cores, are also checked at
              D 16-128, T = 1 and 100, on strided q/k/v/g cut from one
              packed [B, T, H, 4D] buffer and at B*H = 2048, each case
              also replayed from a CUDA graph, a kv_len-0 row exactly out
              0 and lse -1e30 + log(1e-30) (K1) and its gradients exactly
              0 (K2/K3); timed at the serving shape and at the training
              step's [32, 256, 8, 64] with and without the causal mask,
              beside the fp32 (67 TFLOP/s) and 3xTF32 (TF32 peak / 3)
              bounds and the library's forward or backward (its device
              kernels named from a trace), with the K1 of commit db823af
              and the K2/K3 of commit 0ba7d56 (fp32 CUDA cores) built
              from their sources (--flash-fwd-baseline,
              --flash-bwd-baseline, or git history) and timed in turns
              with them. The same three in bf16 (mixed precision: bf16
              q, k, v, g, out, dQ, dK, dV; lse and delta fp32; K1, K2
              and K3 the bf16 wgmma kernels of
              flash_attention_fwd_bf16.cu, flash_attention_bwd_dkdv_
              bf16.cu and flash_attention_bwd_dq_bf16.cu, whose SASS
              must hold HGMMA and no HMMA in each of their 12 kernels)
              against their plain versions in bf16 at the timing
              shapes, D 16, 32 and 128 at odd T and packed views,
              launched directly and replayed from a CUDA graph (within
              2^-7 of max(1, max |plain|): two bf16 ulps, each side
              rounding an fp32 sum once; lse within 1e-4), timed beside
              the fp32 kernels on the same values, the bf16 K1 and K2 of
              commit bb43ba4 and the bf16 K3 of commit dbc895c (TF32
              mma.sync; built from --flash-bf16-fwd-baseline,
              --flash-bf16-bwd-baseline, --flash-bf16-dq-baseline or git
              history, each held to the current one first; the new ones
              must be faster), the plain versions and
              scaled_dot_product_attention on the bf16 inputs, with
              bounds from bf16 bytes and the function's products at the
              bf16 peak, and the design's (K1, K2: 1.5 bf16 products a
              product, K3: 8 D bf16 flops for 6 D; P and dS split in
              two). Then the flash-vs-dense crossover, measured and
              not acted on: K1 against the dense attention_reference at
              q, k, v [8, T, 8, 64], T = 16-1024 (`crossover:` lines).
              Then fused_attention with a query length other than the
              key length (fault C5): a one-op program with its gradients
              on the card against the CPU, through the dense path, K1
              never launched. Then K1-K3 at B * H = 65544 (fault C7: B
              8193, H 8, T 16, D 64) against their plain versions. Then
              fault C8: sequence_last_step and sequence_pool LAST on a
              padded feed whose @SEQLEN (5) exceeds T (3) give a NaN row
              and no device-side assert, and the next Executor run and an
              InferenceEngine request on the card match the CPU exactly;
              and fault C9: fused_attention with a kv_len-0 row gives
              the mean of v at T = 8 and 0 at T = 1024 (K1 launched once
              each), within 1e-4 of the CPU. Then faults C12 and C13:
              topk on tied, zero and NaN rows gives lax.top_k's indices
              (the lower index first among equal values) on the card
              and the CPU, accuracy on a uniform row with label 0 is
              1.0, and abs's gradient at 0 is +1 (`C12:`, `C13:`).
              Then set_while_condition (csrc/graph_while.cu, the
              conditional while node's kernel): a captured loop of 0, 1,
              7 and WHILE_LOOP_ITERS iterations against the same loop on
              the host reading its condition each iteration (the
              counters equal), timed alone (a body of
              WHILE_SET_LAUNCHES launches) and an iteration of the loop.
4. serving  — the main path: build Transformer-base scoring (vocab 30000,
              d_model 512, 8 heads, 6+6 layers, d_inner 2048, T=256) with
              the port's layers, run its startup program on the card from
              a seed, save it with save_inference_model, serve it with
              InferenceEngine(batch_buckets=[1, 4, 8]) and answer 16
              concurrent requests (source and target lengths 32-256).
              Checks: every answer finite; each equals run_direct at the
              bucket its future recorded (<= 1e-5); one answer matches a
              CPU run of the same saved model (plain versions, atol 1e-3);
              the flash and layer-norm kernels launched exactly once per
              fused_attention / layer_norm op of every engine dispatch.
5. training — the second path: build Transformer-base training
              (transformer.build_train: the same widths, fused attention,
              label smoothing 0.1, append_backward through Adam(0.9,
              0.98, 1e-9) on noam with 40 warm-up steps; bench.py's
              bench_transformer model in fp32: its own default is bf16,
              phase 19), run its startup program on the card
              and take TRAIN_STEPS steps of batch 32 x T=256 on bench.py's
              copy task through Executor.run, fetching avg_cost. Reports
              step time, trained tokens/s, each loss, peak device memory
              and launches per step. Checks: every loss finite and the
              last below the first; per step one K1, K2 and K3 launch per
              fused_attention op, one K4 per softmax_with_cross_entropy,
              one K5 per layer_norm (18/18/18/1/32 at 6+6 layers); the
              frozen position tables unchanged. One more step runs under
              torch.profiler: device time by kernel, host and device time
              and launches by program op, and the device's idle share
              (the chrome trace kept with --trace). Then one step at 1+1
              layers, batch 2, T=64 from the same weights on the card and
              on the CPU: loss within 1e-4 relative, every gradient within
              1e-3 of its largest value, every parameter within 2 * lr.
6. sequences, serving — the sequence path: the sentiment conv net as
              written (dictionary 5148, emb 32, 32 filters of sizes 3 and
              4, tanh, SQRT pools) and the stacked LSTM at its book widths
              (emb 128, hid_dim 512 so h = 128, 3 layers, alternate ones
              reversed, max pools) built with use_peepholes=False, each
              initialized on the card, saved and served with LoD feeds
              by InferenceEngine(batch_buckets=[1, 4, 8]) and the default
              seq buckets, 16 concurrent one-review requests (lengths
              16-256). Checks: answers finite, probabilities summing to 1;
              each equals run_direct at its (batch, seq) bucket (<= 1e-5);
              request 0 matches the CPU (<= 1e-4); K9 twice per conv-net
              dispatch, K6 three times per LSTM dispatch.
7. sequences, training — the no-peephole stacked LSTM at bench.py's
              bench_stacked_lstm widths (vocab 10000, emb = hid = 512, 3
              layers), mean(cross_entropy) and Adam(0.002) in fp32, batch
              128 x T=64: TRAIN_STEPS steps through Executor.run, one
              traced step, then one step at 1 layer, batch 4, lengths
              1-16 on the card and on the CPU (the tolerances of phase 5).
              Checks: losses finite and falling, K6 three times a step.
8. translation, training — the attention seq2seq translator (book
              chapter 08; the reference's benchmark/fluid/
              machine_translation.py defaults: embedding = encoder =
              decoder size 512, dictionary 30000, batch 16, Adam at lr
              2e-4) built by machine_translation.build_train(...,
              use_attention=True): an LSTM encoder with peepholes (the
              torch loop, no K6) and a DynamicRNN decoder, one rnn_scan op
              whose step block runs attention with sequence_softmax (K8).
              Source and target lengths 8-48 from SEED, one row of each at
              48, random ids, the label the target shifted by one:
              TRAIN_STEPS steps through Executor.run, then one traced step
              (host and device time by program op, the step block's ops
              as rnn_scan/<type>). Checks: losses finite and falling; K8
              once per decoder step (48 a step) and no other kernel. Then
              one step at dictionary 200, widths 32, batch 4, lengths
              1-12 on the card and on the CPU (the tolerances of phase 5).
9. acoustic, serving — the DeepASR stacked-LSTMP model (PaddlePaddle/
              models fluid/DeepASR stacked_lstmp_model at its train.py
              defaults: 5 layers of fc(4096) + dynamic_lstmp(hidden 1024,
              proj 512), a per-frame softmax over 1749 classes; frames of
              1320 = 120 filterbank features x 11 spliced frames) built
              without its batch_norm layers and with use_peepholes=False,
              initialized on the card, saved and served by
              InferenceEngine(batch_buckets=[1, 4, 8], seq_buckets=[128,
              256, 512]) with float LoD frame feeds: 16 concurrent
              one-utterance requests of 100-500 N(0, 1) frames. Checks:
              answers finite, each frame's posteriors summing to 1; each
              equals run_direct at its bucket (<= 1e-5); request 0
              matches the CPU (<= 1e-4); K7 five times per dispatch.
10. acoustic, training — the same model with cross_entropy against
              random per-frame labels, the length-masked mean
              (models/common.masked_mean_cost) and Adam at DeepASR's
              0.00016, batch 32 utterances of 150-500 frames (one at
              500): TRAIN_STEPS steps through Executor.run, one traced
              step, then one step at 2 layers, hidden 8, proj 4, batch 4,
              lengths 1-12 on the card and on the CPU (the tolerances of
              phase 5). Checks: losses finite and falling; K7 five times
              a step and no other kernel.
11. lenet   — book chapter 02's conv net (zoo mnist:
              recognize_digits.build, Adam 0.001), 5 steps of batch 64 on
              the card and on the CPU from the same weights: each loss
              within 1e-4 relative. No kernel of the port (the conv-net
              path reaches no Pallas kernel in the JAX package).
12. resnet50, training — image_classification.build_train("resnet50"):
              resnet_imagenet of depth 50, 1000 classes, 224 x 224,
              Momentum(0.01, 0.9), batch 32 (benchmark/fluid's default),
              conv, pool and batch_norm as plain torch calls (cuDNN):
              TRAIN_STEPS steps plus a traced one in fp32 (TF32 off) and
              again under enable_mixed_precision (bf16 convolutions and
              fc, f32 masters; --trace PATH keeps PATH's stem +
              _resnet50_fp32.json / _resnet50_bf16.json). Reports
              images/s, the device's busy share, peak memory and launches
              a step. Checks: losses finite and falling, the batch_norm
              moving statistics moved, every parameter f32, no kernel of
              the port launched.
13. resnet50, serving — the same net on a uint8 image feed (cast and
              scaled by 1/255 in the program), saved with
              save_inference_model (batch_norm is_test) and served by
              InferenceEngine(batch_buckets=[1, 8, 32]): 16 concurrent
              requests of 1-8 images. p50 / p99, images/s, the burst
              again under the profiler for the device's busy share, and
              run_direct's time at each bucket. Checks:
              rows finite and summing to 1, each answer equal to
              run_direct at its bucket (<= 1e-5), request 0 against the
              CPU (<= 1e-3), no kernel of the port launched.
14. resnet, card vs CPU — one step of build_train("resnet50") at 3 x 32
              x 32 (resnet_cifar10 of depth 32 by the JAX package's rule),
              batch 8, Momentum(1e-4), from one state and batch, in fp32
              (TF32 off) and under use_bf16. fp32: the loss within 1e-4
              relative, each gradient within 1e-3 and their median within
              1e-4 as ||card - cpu|| / ||cpu||. bf16: the loss within
              1e-2 relative; each gradient and each moving statistic's
              change within 3 x the CPU's own bf16-vs-fp32 spread of it
              + 2e-2 (bf16 rounding grows through the backward; see
              run_resnet_training_vs_cpu).
              A `convnet:` line then sums up phases 12-14.
15. ctr     — the wide & deep CTR model (models/ctr.build at its
              defaults: 26 slots of 100000 ids, each an [N, 16] and an
              [N, 1] table, 13 dense features, a 3 x 400 relu tower, sums,
              sigmoid_cross_entropy_with_logits, Adam 1e-3) trained at
              batch 1024 (ids uniform per slot, dense features in [0, 1),
              0/1 labels from SEED): TRAIN_STEPS steps and a traced one;
              then its predict program (with_optimizer=False) saved and
              served by InferenceEngine(batch_buckets=[1, 64, 256]) to 16
              concurrent requests of 1-64 rows. Reports step time, rows/s,
              peak memory, launches a step, the device's idle share and
              p50 / p99. Checks: losses finite and falling; answers in [0,
              1], each equal to run_direct at its bucket (<= 1e-5),
              request 0 against the CPU (<= 1e-4); no kernel of the port
              launched (its path reaches no Pallas kernel in the JAX
              package).
16. recommender — book chapter 05 (recommender_system.build_train at its
              book widths: emb 32, fc 200, SGD 0.2) over the port's
              movielens metadata, trained at batch 256 (1-3 categories and
              1-5 title words a movie) and its scale_infer served with LoD
              feeds (batch buckets [1, 8, 32], seq bucket 8) to 16 requests
              of 1-8 pairs; the same reports and checks (answers in [-5,
              5]), and K9 twice a step and twice a dispatch (the category
              sum pool and the title's sequence_conv_pool).
17. word2vec, language model — book chapter 04's word2vec
              (word2vec.build at its defaults: dictionary 1000, embed 32,
              hidden 256, SGD 1e-3) at batch 128, and the PTB RNN LM
              (language_model.build at its defaults: vocabulary 2075, emb
              = hidden = 64, 2 peephole LSTM layers run as the torch loop,
              the output tied to the embedding, Adam 3e-3) at 20
              sentences of 8-35 words (one of 35), fetching avg_cost and
              ppl = exp(avg_cost); the training reports and checks, no
              kernel of the port. Then one step of each of the four models
              at its zoo config on the card and on the CPU (phase 5's
              tolerances).
18. optimizers — fit_a_line (book chapter 01) under Adamax,
              DecayedAdagrad, Adadelta, RMSProp with momentum, Ftrl
              (lr_power -0.5 and -0.3), ProximalGD and ProximalAdagrad,
              and under SGD on the exponential, natural_exp and
              inverse_time schedules with staircase, polynomial with and
              without cycle and piecewise (boundaries crossed within the
              steps): 6 steps from one state on the card and on the CPU,
              each loss and learning rate within 1e-5 relative, every
              persistable within 1e-5 of its largest value; ModelAverage's
              apply and restore on the card; each schedule alone three
              times under torch.cuda.set_sync_debug_mode("error") (no host
              sync in its Switch). A `dense_zoo:` line sums up phases
              15-18.

19. transformer, bf16 — bench.py's bench_transformer configuration as
              the JAX package benchmarks it (BENCH_DTYPE bf16, its
              default): phase 5's program under
              Program.enable_mixed_precision, trained the same way. Checks:
              losses finite and falling; per step 18 / 18 / 18 launches of
              the bf16 K1 / K2 / K3 (none of the fp32 ones), one K4 and
              32 K5 (layer_norm sees f32: the residual adds promote the
              bf16 projections); every parameter an f32 master. Then one
              step at 1+1 layers, batch 2, T=64 on the card and on the
              CPU, each gradient within 3 x the CPU's own bf16-vs-fp32
              spread of it + 2e-2, the loss within 1e-2 relative.
20. transformer, dropout — the JAX package's default dense attention
              (the attn_bias feeds) with Transformer-base's dropout 0.1,
              the unfused label smoothing (one_hot -> label_smooth ->
              soft-label softmax_with_cross_entropy) and the fused qkv
              projection, fp32, batch 32 x T=256: K5 32 a step, K1-K4
              none (a soft label never takes K4); the loss falls; peak
              memory reported. A `transformer_variants:` line sums up
              phases 5, 19 and 20.
21. image nets — image_classification.build_train at the JAX defaults
              (224 x 224, 1000 classes, Momentum 0.01 / 0.9), fp32 with
              TF32 off, batch 32: vgg16, alexnet, googlenet and
              se_resnext50, each with its dropout, trained as phase 12
              trains ResNet-50 (--trace PATH keeps PATH's stem +
              _<model>.json); VGG-16 served as phase 13 serves ResNet-50
              (its batch_norms and dropout in test mode, dropout scaling
              by 0.5). Then one step of each at the CPU tests' sizes
              (vgg16 and se_resnext50 32 x 32, googlenet 64 x 64, alexnet
              67 x 67, the least its pools take), 10 classes, batch 8,
              every dropout at p = 0, card against CPU: the loss within
              1e-4, the gradients within 10x each net's own readings
              (IMAGE_NETS_GRAD_BOUNDS; vgg16's biases before a batch_norm,
              0 in exact arithmetic, within IMAGE_NETS_BIAS_FLOOR of the
              largest gradient's norm). No kernel of the port. An
              `image_nets:` line sums up.
22. clipping — fit_a_line under GradientClipByValue(0.5),
              GradientClipByNorm(0.5), GradientClipByGlobalNorm(0.5) and
              ErrorClipByValue(0.02) on the prediction, SGD 0.05, 6 steps
              from one state on the card under
              torch.cuda.set_sync_debug_mode("error") (feeds placed on the
              card, losses fetched as device tensors) and on the CPU:
              losses within 1e-5 relative, persistables within 1e-5 of
              their largest value, each clip changing the CPU's losses.
23. language model, clipped — phase 17's PTB LM with
              GradientClipByGlobalNorm(5.0) before Adam, trained as phase
              17 (--trace PATH keeps PATH's stem +
              _language_model_clip.json). A `clipping_summary:` line sets
              its step beside phase 17's.
24. verbatim scripts — the four book scripts of
              tests/book/test_migration_verbatim.py (fit_a_line, the
              recognize_digits conv net, the word2vec N-gram model, the
              sentiment LSTM on LoD feeds), their text read from that file
              and run unmodified with `fluid` bound to paddle_tpu_torch,
              `fluid.CPUPlace()` given as `fluid.CUDAPlace(0)`: on the
              card, then on the CPU from the card run's startup state (its
              Executor records the state after the script's startup run;
              the CPU run's takes it). Checks: each script's own
              assertions on the card's results; the first VERBATIM_FIRST
              losses within VERBATIM_FIRST_RTOL of the CPU's and every one
              within VERBATIM_TOL of the first CPU loss (the sentiment
              script returns accuracies of 16 rows: its first
              VERBATIM_FIRST equal); no kernel of the port launched. A
              `verbatim:` line sums up.
25. multi-step — Executor.run(steps=K), one step captured into a CUDA
              graph and replayed K times, on seven training paths at the
              full width of the phase each comes from (MULTISTEP_PATHS:
              the Transformer in fp32, bf16 AMP and with dropout, the
              PTB LM, the stacked LSTM, DeepASR, the SRL of phase 28;
              the fp32 and dropout Transformers cut to 2 layers, DeepASR
              and the SRL to 1, MULTISTEP_LAYERS). From one copied state
              and seed counter, under torch.use_deterministic_algorithms
              (index_add_ then sums in a fixed order): two eager runs of
              4 steps, then run(steps=4). Checks: fetches and every
              persistable bit-identical to the eager run where the two
              eager runs are, else within MULTISTEP_GAP x their gap (the
              largest max |diff| / max |value| over the arrays; the line
              says which case held); then, in the default mode, a new
              runner's second steps=4 call with return_numpy=False under
              torch.cuda.set_sync_debug_mode("error"), its launch counts
              equal to 4 eager steps'; on the LM, fetch_reduce "last"
              and "mean" (MEAN_RTOL) against the eager losses. Recorded:
              the eager steps' median (deterministic; the path's own
              phase times the default one), the step's wall time at K =
              4 (median of MULTISTEP_TIMED calls, host clock to a
              synchronize), the device's busy time (the port's kernels'
              part) and idle share over a K = 4 call (torch.profiler),
              peak memory, the graph's pool, the warm-up and capture
              seconds, the state's bytes and one clone's time; one
              `multistep:` line a path. Then a step with a
              Print op (a host sync) must raise GraphCaptureError
              naming it.
26. pipelined serving — phase 4's Transformer-base scoring model and
              phase 6's IMDB stacked LSTM (LoD feeds, K6) saved and
              served at pipeline_depth 0 and 2 (PIPELINE_DEPTHS), bursts
              of 16 and 64 concurrent requests (PIPELINE_BURSTS). Checks:
              a burst under torch.cuda.set_sync_debug_mode("error")
              (clients wait on their futures only: a host sync on the
              dispatch path fails its batch); each answer equal to
              run_direct at its recorded bucket within BUCKET_TOL; the
              launches a dispatch predicts; at depth 2 the window's
              completions equal the dispatches. A `pipelined:` line
              gives p50, p99, items a second and the window's idle_s.
              The serving phases before it run at the engine's default
              depth, 2.
27. sequence ops — every op rule of ROADMAP A5 and the CRF ops, plain
              torch on both sides (the JAX package has no kernel for
              them), on the card against the CPU on the same inputs from
              SEED (seq_op_cases): dynamic_gru forward and reverse at
              width 512 over T = 64, batch 32 of lengths 1-64, gru_unit
              and lstm_unit at width 512, linear_chain_crf with 59 tags
              over T = 60, batch 32 of lengths 5-60, crf_decoding with and
              without Label, chunk_eval (IOB, 29 types, one excluded),
              sequence_reshape, sequence_expand, lod_reset, row_conv,
              sequence_cache_write, sequence_slice and sequence_concat at
              [32, 64, 512], sequence_erase and edit_distance: outputs
              and the gradients of a random cotangent within SEQ_OPS_TOL
              of max(1, max |cpu|), the decodes, counts, moved values and
              lengths exact; the eager forward ms of dynamic_gru,
              linear_chain_crf and crf_decoding. Then the in-graph
              assertion channel on the card: an indivisible
              sequence_reshape raises the JAX package's RuntimeError at
              steps=1; a steps=4 call (one CUDA graph, 4 replays) whose
              step 2 alone trips (the lengths follow a step counter; the
              feeds replay every step) raises after the call with the
              counter at 4, and the next steps=4 call does not; a clean
              asserting call makes exactly one synchronizing CUDA call
              (the combined flag's read, counted under
              set_sync_debug_mode("warn")) and a program with no
              asserting op none.
28. srl      — book chapter 07's semantic role labeller
              (label_semantic_roles.build_train: 8 feature embeddings,
              the frozen `emb` made label-informative, a depth-8 stack of
              relu-candidate LSTMs, forward and reverse, hidden 512,
              word_dim 32, mark_dim 5, a linear-chain CRF cost, SGD on
              exponential_decay, `crfw` at learning_rate 1e-3; lr SRL_LR
              = 0.003, as the book's 0.01 diverges on this data in both
              packages (see SRL); the
              dictionaries 4000 / 300 / 59 of the JAX package's synthetic
              conll05) trained on batch 32 sentences of 5-60 words (one of
              60): TRAIN_STEPS steps through Executor.run and a traced one
              (--trace PATH keeps PATH's stem + _srl.json), then a step
              whose chunk counts (chunk_eval on crf_decoding's path) are
              printed; losses finite and falling. One step at depth 2,
              batch 4 of lengths 60, 1, 17 and 33, lr 0.01, on the card
              and on the CPU (phase 5's tolerances). Then the inference program (the
              8 feature feeds, db_lstm and crf_decoding on the trained
              `crfw`) saved and served by InferenceEngine(batch_buckets=
              [1, 4, 8], seq_buckets=[16, 32, 64]) to a burst of 16
              one-sentence requests with 8 int LoD feeds: each decode
              equal to run_direct at its bucket and to a CPU engine's at
              the same bucket, exactly. No kernel of the port on either
              path: the book's LSTMs (relu candidate, sigmoid cell) run
              the torch loop in the port and the lax.scan in the JAX
              package. Phase 25 also runs this training as its seventh
              path. An `srl_summary:` line sums up.
29. ocr      — the CRNN-CTC OCR model (ocr_recognition.ctc_train_net: four
              conv-bn-pool groups of 16, 32, 64, 128 channels,
              im2sequence into 24 columns of 384 features, a relu-
              candidate bidirectional GRU of 200, 95 classes and the blank,
              warpctc with norm_by_times, Momentum 0.9 at 1e-3; see OCR)
              trained on batch 32 of 1 x 48 x 384 images of 1-12 glyphs:
              TRAIN_STEPS steps and a traced one (--trace PATH keeps PATH's
              stem + _ocr.json), losses finite and falling; the is_test
              encoder's greedy decode (ctc_greedy_decoder) and edit
              distance on the batch; warpctc's eager forward beside
              F.ctc_loss on the same feasible logits [32, 24, 96] (within
              CTC_TOL). One step at two conv groups, batch 4, on the card
              and on the CPU (phase 5's tolerances). The is_test encoder
              with the greedy decoder saved (the decode and its lengths as
              targets) and served by InferenceEngine(batch_buckets=[1, 4,
              8, 16]) to 16 one-image requests: each answer equal to
              run_direct at its bucket and to a CPU engine's, exactly.
              K1-K9: 0 launches. An `ocr_summary:` line sums up.
30. decode   — beam decoding through While, tensor arrays, beam_search and
              beam_search_decode: Transformer-base (MODEL, N_LAYER
              layers) trained DECODE_TRAIN_STEPS steps as phase 5 trains
              it, then build_cached_decode and build_decode for 8 source
              sentences of 16-64 tokens, beam 4, max_out_len 24 (DECODE):
              ids [8, 4, 25] from BOS, the two decodes equal for the first
              DECODE_SAME_TOKENS tokens, K5 once per layer_norm outside the
              loop and once per loop-block layer_norm an iteration; the
              cached decode cut to DECODE_SAME_TOKENS tokens on the card
              and on the CPU: ids equal, scores within DECODE_SCORE_RTOL.
              The attention translator at phase 8's widths trained
              DECODE_TRAIN_STEPS steps, then its build_decode (beam 4,
              MT_DECODE_LEN steps) for phase 8's 16 sentences. For each
              decode: host ms (a token's), device ms under the profiler,
              and the synchronizing calls (set_sync_debug_mode("warn"): at
              most the loop's condition reads, the assertion read and one
              constant's copy). Then each decode again at
              Executor.run(steps=DECODE_STEPS): DECODE_STEPS decodes in
              one CUDA graph, the While a conditional while node whose
              condition set_while_condition sets on the card: ids and
              scores equal to the eager run's bit for bit, at most one
              synchronizing call (the assertion read after the
              replays), the loop's iterations counted on the card, K5
              and set_while_condition launched as predicted, host and
              device ms a token beside the eager numbers. Then a While
              writing past its array's capacity raises the JAX package's
              RuntimeError and K5 still runs after it (no device-side
              assert); at steps=4 the While within capacity gives 11 at
              each step and the overflow raises the same message. A
              `decode_summary:` line sums up.
31. serving  — decode serving, weight dtypes and HTTP (ROADMAP A7).
              (a) bench.py's decode leg at its defaults (DECODE_BENCH:
              slots 8, 48 streams, its mixed budgets about 24 tokens,
              hidden 256, vocab 4096, 4 tanh fcs, seed 11) through
              DecodeEngine: the serial run through solo_clone, the open
              loop on bench.py's fixed arrival schedule at 2x the serial
              stream rate; every stream equal to its solo decode, the
              first DECODE_VS_CPU equal to a CPU engine's on the same
              weights; tokens/s continuous and serial, inter-token p50 /
              p99, slot occupancy, and over closed bursts of DECODE_PROBE
              streams host ms an iteration, device ms an iteration and
              the idle share under the profiler, and synchronizing calls
              an iteration (set_sync_debug_mode("warn"): one, the token
              and finished rows' read). (b) the same step with a
              layer_norm after each fc at Transformer-base's d_model 512
              and vocab 30000, 6 layers, 16 streams of 8-32 tokens
              (DECODE_LN): (a)'s gates, K5 6 launches an iteration, and K5
              at [8, 512] against its plain version (KERNEL_TOL), timed
              beside its bound and F.layer_norm. (c) Transformer-base
              scoring (phase 4's model and requests) at weights_dtype
              fp32, "bf16" and "int8", 16 requests each: answers within
              divergence_bound of fp32's, p50 / p99, the weights' bytes on
              the card, a bucket-8 dispatch's ms, int8's dequantize ms a
              dispatch, the bf16 K1 18 launches a dispatch and held to its
              plain version at [8, 256, 8, 64] (BF16_KERNEL_TOL). (d) a
              ModelServer on 127.0.0.1, port 0, over (a)'s engine and
              (c)'s fp32 engine: a :predict equal to run_direct, a
              streamed :decode equal to the solo decode, /metrics with
              the decode gauges. A `decode_serving_summary:` line sums
              up. Phase 3 also prints `C14:` / `C15:` lines: warpctc and
              edit_distance with out-of-range indices on the card equal
              to the CPU, NaN for NaN (faults C14, C15).
32. readers  — A8's inputs: Transformer-base (phase 19's bf16 AMP program,
              fused attention, batch 32, T=256) trained from recordio: 16
              batches of the copy task through a DataFeeder and
              recordio_writer into two files (READER), read back by
              open_files(thread_num=2) -> double_buffer -> read_file at
              Executor.run(steps=4, prefetch=True), two calls (8 steps):
              the losses and every parameter bit-equal to 8 eager
              feed-fed steps=1 runs of the same batches in the order the
              reader gave them (under deterministic algorithms, as phase
              25), the reader's state_dict 8 records on, no synchronizing
              call from the reader path, the native recordio library
              loaded, K1-K5 launched per step as in phase 25 (18/18/18/1/
              32 through the bf16 K1-K3). Timed over whole passes of the
              files with prefetch off and on (twice each): step ms,
              device ms a step and idle share; the io pre-pass's host ms
              from the runs' spans (exec/host_io inline, the staging
              thread's exec/prefetch_stage). A `reader_summary:` line
              sums up.
33. persistence — A8's persistence half (PERSIST): (a) phase 32's bf16
              Transformer-base program fed from ONE recordio file of the
              16 batches (open_recordio_file -> double_buffer ->
              read_file, a fixed record order) at steps=4,
              prefetch=True: 4 calls with an async CheckpointManager
              save of step 8 after call 2 (0 synchronizing calls on the
              training thread), then a fresh scope, executor and reader
              restored from it (restore() returns 8, the reader's
              state_dict equal) for 2 calls: losses of steps 9-16 and
              every parameter and Adam moment bit-equal to the straight
              run under deterministic algorithms, K1-K5 18/18/18/1/32 a
              step through the bf16 K1-K3; then call ms with no save in
              flight and with the writer running (PERSIST["timed_calls"]
              each). (b) phase 20's dropout program at steps=4 saved
              after call 1 and resumed for calls 2-3: bit-equal, the
              seed cursor restored, K5 32 a step. (c) (a)'s step-8
              snapshot served by InferenceEngine.from_checkpoint at
              phase 4's buckets and requests, in fp32 and with
              weights_dtype="bf16", each bit-equal to an engine over
              save_inference_model of the restored scope with the same
              weights_dtype; the pruned program keeps the training
              program's mixed precision, so both launch the bf16 K1 (18)
              and K5 (32) a dispatch; with the newest snapshot's largest
              parameter file bit-flipped, from_checkpoint serves step 8.
              (d) Three models written by io.save_reference_model and
              served by InferenceEngine(model_format="reference") and a
              ModelServer :predict: test_era_export_roundtrip_
              transformer_encoder's classifier at Transformer-base's
              widths (params_filename "__params__"; K5 13 a dispatch),
              phase 6's stacked LSTM (LoD feeds through
              adapt_sequence_layout; K6 3) and conv net (K9 2), each
              within rtol 1e-4, atol 1e-5 of its native engine on the
              same requests. Snapshots go under a temporary directory
              the phase removes. A `persistence_summary:` line sums up.
34. resilience — ROADMAP A9 (RESIL): phase 33's bf16 Transformer-base
              program fed from one recordio file (phase 32's 16 batches,
              then its first 8 again) at steps=4 under
              install_numeric_guards(loss=avg_cost, grad_norm=True),
              every check under deterministic algorithms. (a) 4 guarded
              calls against 4 unguarded ones in turns from the same
              state: losses bit-equal, medians of the call ms, the
              guard's kernels and device ms a step (torch.profiler), one
              synchronizing call (the flag read) a guarded call and none
              unguarded, K1-K5 18/18/18/1/32 a step; eager steps=1 steps
              in turns. (b) reader_nan@5 in the second call: it raises
              NumericalGuardError naming the loss and the gradients, and
              its state is bit-equal to 8 guarded steps=1 runs under the
              same plan (step 6 gated, 5, 7 and 8 applied); a Supervisor
              with skip_batch trains on to step 16 with one
              numeric:skip_batch, bit-equal to the unsupervised run.
              (c) loss_spike@13 (lbl_weight x 1000: sum_cost spikes,
              avg_cost does not), a TrainingSentinel on the first fetch
              and last_stats["grad_norm"], a snapshot at step 8:
              rollback_skip_data restores it and skips the 8 records
              read since; losses and state bit-equal to a fault-free run
              that skipped them. (d) slow_step at steps 8 and 12 under
              watchdog_timeout: a bundle and hang:rollback, the next call
              bit-equal to the straight run, then a bundle and an abort
              whose bundle read_bundle reads; the sleeping worker pops no
              record, draws no seed and writes nothing when it wakes.
              (e) CanaryChecker on the card: one digest over 8 checks,
              ms a check; bitflip@3 convicts check 3 of device 0; a
              Supervisor with sdc_every=4 aborts with the
              SilentCorruptionError. (f) phase 20's program at
              learning_rate 1e38 under Executor(check_nan_inf=True)
              raises naming a var; the sweep's ms a call in turns with a
              run without it. Snapshots and bundles go under a temporary
              directory the phase removes. A `resilience_summary:` line
              sums up (with the recoveries' seconds and the sentinel's
              host us an observe).
35. parallel — ROADMAP A10's first half (PARALLEL): bench.py's bf16 AMP
              Transformer-base (batch 32, T=256) through
              fluid.ParallelExecutor on the card. Timed first, in the
              default mode, one side after another: eager and steps=4
              step ms, device ms a step and the state bytes of the mesh
              of the card alone and {"dp": 2} with ZeRO (the Executor's
              are phase 25's); an eager step's collectives on each mesh (calls,
              bytes, device ms inside record_function ranges). The op: fused_attention at [32, 256, 8, 64] bf16 on
              {"sp": 2}, ring and Ulysses, forward and backward, within
              the bf16 tolerance of the single-card op. Then, under
              deterministic algorithms: (a) ParallelExecutor(use_cuda=
              True) on the mesh of the card alone, 4 steps=1 calls and
              one steps=4, losses and state bit-equal to Executor.run,
              K1-K5 18/18/18/1/32 a step, its eager collectives through
              torch.cuda.nccl; (b) {"dp": 2} on the card with
              sharded_weight_update=True: the first step's summed
              gradients (Adam's first moments) within 1e-2 of (a)'s by
              norm, losses within 2e-3 and every state value within
              twice the summed noam rates of (a), K1-K5 twice a step,
              the split state as ShardedValues; the same step with lane
              0's partial sums alone (a planted fault) must read past
              1e-2;
              (c) {"dp": 1, "tp": 2} with tp_axis="tp" ("gather"):
              bit-equal to (a); (d) the program on {"dp": 1, "sp": 2},
              ring (no K1-K3) and Ulysses (K1-K3 on each of 2 head
              groups), 4 steps=1 calls and one steps=4 each, losses
              within 2e-3 of (a)'s, the first step's summed gradients
              within 5e-2 (ring: fp32 blocks) and 1e-2 (Ulysses);
              (e) (at 2 layers) a snapshot saved under (b)'s layout
              restored onto the
              card's mesh and onto (b)'s equal to what was saved, the
              resume on (b)'s layout bit-equal to the straight run; a
              guarded (b) run under a Supervisor with restore_layout=
              (b)'s plan takes loss_spike@4 to a rollback, bit-equal to
              the run without it; (f) the CTR program through the
              DistributeTranspiler with 2 pservers: the pserver
              simulation (the trainer program under a {"dp": 2}
              ParallelExecutor with parameter_shardings) and the sharded
              monolithic program, within rtol 1e-4 / atol 1e-5 of the
              monolithic program on one card. A `parallel_summary:` line
              sums up.
36. parallel programs — ROADMAP A10b (PPM), every check under
              deterministic algorithms, bf16 AMP at Transformer-base's
              widths, batch 32 x T=256: (a) bench.py's encoder as a
              language model (encoder_lm: prepare_encoder, a
              pipelined_stack of 6 encoder_layer stages over fused
              attention with no mask, the final layer_norm, an fc to
              30000 and softmax_with_cross_entropy, Adam on noam) on
              Executor (the stages one after the other) and on {"dp":
              1, "pp": 6} (8 microbatches of 4 rows through the looped
              schedule): 4 steps=1 calls and one steps=4 each, the pp
              run's losses within 2e-3 and its first step's Adam first
              moments within 1e-2 of the Executor's by norm; eager,
              captured and device ms a step; the bf16 K1-K3, K4 and K5
              launches a step (K1-K3 and K5 once a stage call: 8x on
              pp). (b) the same encoder with every FFN a switch_moe (8
              experts, d_hidden 2048, capacity 1.25; loss + 0.01 x the
              summed aux losses) on Executor and on {"dp": 2, "ep": 4}
              (the moe op on the gathered batch, the rest once a dp
              shard) and {"dp": 1, "ep": 4}, held as (a) but for the dp2
              losses (1e-2: routing is discrete, PPM_MOE_LOSS_RTOL); the
              share of tokens each layer drops and its aux loss on the
              first step. (c) phase 35's program
              on {"dp": 1, "tp": 2} under tp_placement="compute" (the
              weights and their moments on their pieces, each product
              a piece at a time), held as (a) against phase 35 (a)'s
              Executor run; step ms, state bytes a replica. (d) phase
              35's program with enable_rematerialization, 4 steps=1 calls
              and one steps=4 from (a)'s state: losses and state
              against phase 35 (a)'s run (bit-equal, else the distance
              within phase 35 (b)'s bounds); max_memory_allocated
              eager, at the steps=4 call that captures and at one that
              replays, with and without remat; step ms of each; the
              recomputed segments' forward kernels counted in its
              launches. A `parallel_programs_summary:` line sums up.

37. serving fleet — ROADMAP A10c, the serving side of A10, over phase
              4's Transformer-base scoring model (batch buckets [1, 4, 8];
              weights from SEED, the reload's and the canaries' from
              FLEET_SEED; phase 4's first 8 requests), every answer held
              bit for bit to a lone engine's run_direct at its bucket:
              (a) ReplicaPool(replicas=2) (both replicas on cuda:0) and
              the lone engine under a closed loop of 16 client threads x
              6 batch-1 requests (x 3 in (b) and (c)'s loops): p50,
              p99, items a second, K1 and K5 launches a dispatch, and the
              device's idle share over a shorter loop under
              torch.profiler; (b) replica_exc, replica_poison (the finite
              check must fire), replica_crash, replica_wedge (4 s behind
              a 0.4 s attempt timeout, 4 clients) through the replicas'
              taps, and
              kill_replica mid-loop: zero client errors, the failed-over
              requests' worst latency, pool_state()'s replica states;
              (c) reload(model_dir=) to FLEET_SEED's weights mid-loop
              (generations 1, later answers the new weights'), then
              promote(traffic_fraction=0.25) of a canary_poison canary
              (rolled back, every answer the incumbent's) and of a
              healthy one (promoted); (d) a ModelFleet of the model at
              priorities 1 and 0 behind a ModelServer: under the top
              tier's closed loop the lower tier answers 429 with
              Retry-After over HTTP, and answers after the load; an
              autoscale=True pool over [1, 3] replicas (queue capacity
              8) under 32 clients that retry their 429s grows and
              contracts back to 1 with no accepted request failing,
              last_scale_up_s; (e) InferenceEngine(tp=2, mesh_devices=
              ["cuda:0"] * 2) bit-equal to the one-card engine at every
              bucket in fp32 and with weights_dtype="bf16", K1 (or the
              bf16 K1) and K5 launches a dispatch, one dispatch's ms at
              bucket 8 beside the one-card engine's; a 2-replica tp pool
              through engine_factory under kill_replica; (f) a
              DecodePool of two DecodeEngines over phase 31 (b)'s step:
              every stream's tokens equal the solo decode's; tokens a
              second beside one engine; (g) two HeartbeatWriters and
              write_plan in a cluster directory that watch_cluster
              puts on (d)'s /metrics (ptpu_cluster_worker_steps_behind
              at the writers' lag, beside the pool families, each TYPE
              once), /healthz with `pools` and `fleet`. A
              `serving_fleet_summary:` line sums up.

38. elastic cluster — ROADMAP A10's last module (resilience/cluster.py
              and the port's launcher, paddle_tpu_torch.tools.
              ptpu_elastic), with real worker processes on the card:
              `python3 chip_smoke.py elastic-worker` is the workers'
              --worker-cmd (it refuses to run without CUDA or off CUDA
              devices), under deterministic algorithms with
              CUBLAS_WORKSPACE_CONFIG set; see ELASTIC. (a) A
              ClusterCoordinator(num_workers=2, total_device_count=4) in
              a thread; two workers, spawned by the launcher's
              _WorkerPool with PTPU_HOST_DEVICES=4 (the card four times,
              as the JAX leg's workers see four devices), train phase
              35's bf16 AMP Transformer-base on the plan's {"dp": 2}
              (sharded_weight_update, rank 0 checkpointing every 2
              steps); host_death kills w1 at exactly step
              ELASTIC["death_at"] (rc -9); w0 is fenced, restores the
              newest valid snapshot onto {"dp": 4}, and its steps until
              the grow are bit-equal to `chip_smoke.py
              elastic-reference`, a process of its own restored from the
              same snapshot on the same mesh shape; a standby replacement
              spawned when the cohort forms starts up, waits at its gate
              until w0 holds at step ELASTIC["hold_at"], joins at that
              step barrier (no aborted step) and its stream is w0's. Formation s, death to
              `detected`, the fence s, restore ms, the death to the first
              step after the rescale, the join to the first grown step,
              eager step ms on {"dp": 2} and {"dp": 4}, save ms,
              max_memory_allocated of each worker; the workers' kernel
              launches (written at exit) against phase 35's counts a lane
              for each mesh. (b) slow_step against a watchdog: a bundle
              and a same-size rollback, every step once in the final
              history. (c) bitflip on the canary of local device 1: the
              device quarantined in every later plan, the next mesh
              built around it. (d) `python -m
              paddle_tpu_torch.tools.ptpu_elastic launch` with
              heartbeat_stall on w1: fenced out on missed beats alone,
              the cohort finishes; w0's /metrics read while it trains
              (ptpu_cluster_worker_steps_behind); after it, `status
              --json` (the stall; (c)'s shows the quarantine). (b)-(d)
              train the launcher's demo MLP beside (a), each in a
              directory of its own, started once (a)'s cohort has formed.
              An `elastic_summary:` line sums up.

Every path counts launches from zero and predicts each kernel's count on
it (0 for a kernel it does not run; the bf16 flash kernels counted under
their own names); each kernel must also launch on at least one path. The
last lines are one JSON object listing every kernel with its launches by
path, the card line, and `{"ok": true, "device": {...}}`.
"""
import argparse
import collections
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# published peaks (NVIDIA data sheets): fp32 outside the tensor cores in
# FLOP/s, device memory in bytes/s, dense TF32 on the tensor cores in
# FLOP/s (a 3xTF32 product costs three TF32 ones), dense bf16 on the
# tensor cores in FLOP/s
PEAKS = (("H100 PCIe", 51e12, 2.0e12, 378e12, 756e12),
         ("H100 NVL", 60e12, 3.9e12, 417e12, 835e12),
         ("H100", 67e12, 3.35e12, 495e12, 989e12),
         ("H200", 67e12, 4.8e12, 495e12, 989e12))
KERNEL_TOL = 1e-4       # fp32, different summation order than the plain
BUCKET_TOL = 1e-5       # coalesced vs run_direct at the same bucket
CPU_TOL = 1e-3          # card vs CPU through 12 fp32 layers
SEED = 0                # weights, kernel inputs and requests
N_LAYER = 6             # encoder and decoder depth of Transformer-base
TRAIN_BATCH = 32        # sequences per training step (bench.py's batch)
TRAIN_STEPS = (2, 6)    # training steps: warm-up, then timed
WARMUP_STEPS = 40       # noam warm-up (bench.py's build_train default)
LOSS_RTOL = 1e-4        # card vs CPU loss after one training step
GRAD_RTOL = 1e-3        # card vs CPU gradients, relative to max |grad|

# the main path's model: Transformer-base (bench.py's configuration)
MODEL = dict(vocab=30000, max_length=256, d_model=512, n_head=8, d_key=64,
             d_inner=2048)

FLASH_SRC = "paddle_tpu_torch/csrc/flash_attention_fwd.cu"
FLASH_BWD_SRC = "paddle_tpu_torch/csrc/flash_attention_bwd.cu"
# the bf16 K1, K2 and K3 (bf16 wgmma kernels fed by TMA)
FLASH_BF16_SRC = "paddle_tpu_torch/csrc/flash_attention_fwd_bf16.cu"
DKDV_BF16_SRC = "paddle_tpu_torch/csrc/flash_attention_bwd_dkdv_bf16.cu"
DQ_BF16_SRC = "paddle_tpu_torch/csrc/flash_attention_bwd_dq_bf16.cu"
XENT_SRC = "paddle_tpu_torch/csrc/softmax_xent_fwd.cu"
LN_SRC = "paddle_tpu_torch/csrc/layer_norm_fwd.cu"
FLASH_TPU = "paddle_tpu/ops/pallas_kernels.py:64 (_flash_fwd_kernel, " \
    "launched by _flash_fwd :116)"
DKDV_TPU = "paddle_tpu/ops/pallas_kernels.py:157 (_flash_bwd_dkdv_kernel, " \
    "launched by _flash_bwd :240)"
DQ_TPU = "paddle_tpu/ops/pallas_kernels.py:201 (_flash_bwd_dq_kernel, " \
    "launched by _flash_bwd :240)"
XENT_TPU = "paddle_tpu/ops/pallas_kernels.py:377 (_xent_kernel, launched " \
    "by _xent_fwd_call :389)"
LN_TPU = "paddle_tpu/ops/pallas_kernels.py:451 (_ln_kernel, launched by " \
    "_ln_fwd_call :464)"
LSTM_SRC = "paddle_tpu_torch/csrc/fused_lstm_fwd.cu"
POOL_SRC = "paddle_tpu_torch/csrc/masked_pool_fwd.cu"
LSTM_TPU = "paddle_tpu/ops/pallas_kernels.py:544 (_lstm_seq_kernel, " \
    "launched by _lstm_fwd_call :575)"
POOL_TPU = "paddle_tpu/ops/pallas_kernels.py:947 (_masked_pool_kernel, " \
    "launched by _masked_pool_call :961)"
SOFTMAX_SRC = "paddle_tpu_torch/csrc/masked_softmax_fwd.cu"
SOFTMAX_TPU = "paddle_tpu/ops/pallas_kernels.py:883 " \
    "(_masked_softmax_kernel, launched by _masked_softmax_call :895)"

# the sequence path: the IMDB sentiment classifiers (book chapter 06).
# Serving: the conv net as written and the stacked LSTM at its book
# widths, no peepholes; training: the stacked LSTM at bench.py's
# stacked-LSTM configuration (bench_stacked_lstm), no peepholes, fp32.
SENTIMENT = dict(dict_dim=5148, classes=2, conv_emb=32, conv_hid=32,
                 lstm_emb=128, lstm_hid=512, stacked=3)
SEQ_TRAIN = dict(vocab=10000, hid=512, stacked=3, batch=128, seq=64,
                 lr=0.002)
SEQ_BUCKETS = [16, 32, 64, 128, 256]  # the engine's default seq buckets
# card vs CPU sentiment probabilities: fp32 through up to three 256-step
# recurrences summed in another order than the CPU's (K6 alone agrees with
# its plain loop to ~2e-7)
SEQ_CPU_TOL = 1e-4

# the translation path: book chapter 08's attention seq2seq trainer at the
# reference benchmark's defaults (benchmark/fluid/machine_translation.py:
# embedding_dim = encoder_size = decoder_size = 512, dict_size 30000,
# batch_size 16, Adam at 2e-4); WMT14-like sentence lengths 8-48
MT = dict(dict_size=30000, word=512, hidden=512, decoder=512, batch=16,
          lr=2e-4, min_len=8, max_len=48)
# the card-vs-CPU step: the same program at small widths
MT_SMALL = dict(dict_size=200, word=32, hidden=32, decoder=32, batch=4,
                lr=2e-4, min_len=1, max_len=12)

# the acoustic path: PaddlePaddle's DeepASR stacked-LSTMP model
# (PaddlePaddle/models fluid/DeepASR model_utils/model.py
# stacked_lstmp_model at its train.py defaults: hidden_dim 1024, proj_dim
# 512, stacked_num 5, class_num 1749, batch_size 32, Adam at 0.00016),
# frames of 120 filterbank features x 11 spliced frames, without its
# batch_norm layers and with use_peepholes=False (the K7 configuration)
ASR = dict(frame=1320, hidden=1024, proj=512, layers=5, classes=1749,
           batch=32, lr=0.00016, min_len=150, max_len=500)
ASR_SERVE_LENS = (100, 500)               # utterance frames per request
ASR_SEQ_BUCKETS = [128, 256, 512]
# the card-vs-CPU step: the same program at small LSTMP widths
ASR_SMALL = dict(ASR, hidden=8, proj=4, layers=2, batch=4, min_len=1,
                 max_len=12)
# the conv-net path: ResNet-50 as the JAX package's benchmark trains it
# (image_classification.build_train: resnet_imagenet of depth 50, 1000
# classes, 224 x 224, Momentum 0.9 at lr 0.01) at benchmark/fluid's
# default batch of 32; served on uint8 pixels from requests of 1-8
# images; the card-vs-CPU step at 3 x 32 x 32, where build_train makes
# resnet_cifar10 of depth 32 (the JAX package's rule); book chapter 02's
# LeNet (zoo mnist) with its Adam at 0.001
RESNET = dict(image=224, classes=1000, batch=32, lr=0.01)
RESNET_SERVE = dict(requests=16, images=(1, 8), buckets=[1, 8, 32])
RESNET_SMALL = dict(image=32, classes=10, batch=8, lr=1e-4)
LENET = dict(batch=64, steps=5, lr=0.001)
CONV_LOSS_RTOL = 1e-4            # card vs CPU, fp32
# card vs CPU fp32 gradients, ||card - cpu|| / ||cpu|| per parameter, on
# RESNET_SMALL (an NVIDIA H100 80GB HBM3 at 700 W read 9.5e-6 and 3.7e-6)
CONV_GRAD_MAX, CONV_GRAD_MEDIAN = 1e-3, 1e-4
# card vs CPU under use_bf16: the loss's relative error (the same card
# read 3.0e-3, the CPU's own bf16 against its fp32 2.0e-3), and each
# gradient's and moving statistic's within BF16_SPREAD_X x the CPU's
# bf16-vs-fp32 spread of it + BF16_FLOOR (the worst read 0.41 of that;
# see run_resnet_training_vs_cpu)
BF16_LOSS_RTOL, BF16_SPREAD_X, BF16_FLOOR = 1e-2, 3.0, 2e-2
# the dense zoo paths at their JAX package defaults (models/ctr.py: the
# era's wide & deep CTR over Criteo's 26 categorical and 13 dense fields,
# 100000 hashed ids a slot; book chapter 05's recommender at its book
# widths over the MovieLens metadata; book chapter 04's word2vec; the PTB
# RNN LM at its defaults), batches as the reference's scripts take them
CTR = dict(sparse=100000, emb=16, hidden=(400, 400, 400), lr=1e-3,
           batch=1024)
CTR_SERVE = dict(requests=16, rows=(1, 64), buckets=[1, 64, 256])
REC = dict(emb=32, fc=200, lr=0.2, batch=256)
REC_SERVE = dict(requests=16, pairs=(1, 8), buckets=[1, 8, 32],
                 seq_buckets=[8])
W2V = dict(dict_size=1000, embed=32, hidden=256, lr=1e-3, batch=128)
LM = dict(vocab=2075, emb=64, hidden=64, layers=2, lr=3e-3, batch=20,
          min_len=8, max_len=35)
# the optimizers and schedules, card against CPU: fit_a_line (book chapter
# 01: fc(13 -> 1), square_error_cost, mean) at batch 32 for 6 steps from
# one state. fp32 in another order on each device: each step's loss within
# OPT_LOSS_RTOL and every persistable after the steps within OPT_STATE_TOL
# of its largest value (schedules: every learning rate within
# OPT_LOSS_RTOL)
OPT_STEPS, OPT_BATCH = 6, 32
OPT_LOSS_RTOL, OPT_STATE_TOL = 1e-5, 1e-5
LSTMP_SRC = "paddle_tpu_torch/csrc/fused_lstmp_fwd.cu"
LSTMP_TPU = "paddle_tpu/ops/pallas_kernels.py:714 (_lstmp_seq_kernel, " \
    "launched by _lstmp_fwd_call :745)"
# the commit whose K7 (one block per batch row) the current one is timed
# against
K7_BASELINE_COMMIT = "c644094"
# the commit whose K2/K3 (fp32 on the CUDA cores) the current ones are
# timed against
FLASH_BWD_BASELINE_COMMIT = "0ba7d56"
# the commit whose K1 (fp32 on the CUDA cores) the current one is timed
# against
FLASH_FWD_BASELINE_COMMIT = "db823af"
# the commit whose bf16 K1 and K2 (the fp32 kernels' template on bf16
# tiles, TF32 mma.sync) the bf16 wgmma ones are timed against; they lie in
# FLASH_SRC and FLASH_BWD_SRC at that commit
FLASH_BF16_BASELINE_COMMIT = "bb43ba4"
# the commit whose bf16 K3 (the fp32 template on bf16 tiles, TF32
# mma.sync) the bf16 wgmma K3 is timed against; it lies in FLASH_BWD_SRC
# at that commit
FLASH_BF16_DQ_BASELINE_COMMIT = "dbc895c"
# each bf16 kernel's earlier version: (commit, its source at that commit)
BF16_BASELINES = {"fwd": (FLASH_BF16_BASELINE_COMMIT, FLASH_SRC),
                  "dkdv": (FLASH_BF16_BASELINE_COMMIT, FLASH_BWD_SRC),
                  "dq": (FLASH_BF16_DQ_BASELINE_COMMIT, FLASH_BWD_SRC)}
# the commit whose K6 (one block per batch row, W read from L2 at every
# step) and K8 (three walks over each row) the current ones are timed
# against
K6_BASELINE_COMMIT = "276bea2"
K8_BASELINE_COMMIT = "276bea2"
# the commit whose K9 (one block per row and feature tile, rows on grid.y)
# the current one is timed against
K9_BASELINE_COMMIT = "bc496a2"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    """`name, power.limit` of the first card, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return "nvidia-smi unavailable (%s)" % e
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else "nvidia-smi printed nothing"


def peaks_for(name):
    """(fp32 FLOP/s, bytes/s, TF32 FLOP/s, bf16 FLOP/s) of the card named
    `name`."""
    for key, *peaks in PEAKS:
        if key in name:
            return tuple(peaks)
    return tuple(PEAKS[2][1:])


def time_ms(torch, fn, iters=20, reps=7):
    """Device time of one call, in ms: `iters` calls captured in one CUDA
    graph (so the host's launch cost is not in the number), the graph
    replayed `reps` times after warmup and timed by CUDA events; the median
    over replays, divided by `iters`. Inputs stay in L2 between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    del graph
    return statistics.median(times)


def eager_ms(torch, fn, iters=20, reps=7):
    """Time of one call as a Python caller sees it back to back (host
    launch cost included): CUDA events around `iters` eager calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


def bound(flops, nbytes, peak_flops, peak_bw):
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# --------------------------------------------------------------- kernels --

def flash_registers(log):
    """Registers and spill bytes of each flash kernel (K1 forward, K2 dK/dV,
    K3 dQ) per D and element type (fp32; bf16: the wgmma kernels of
    FLASH_BF16_SRC, DKDV_BF16_SRC and DQ_BF16_SRC), from nvcc's `ptxas
    -v` lines; fails on a spill, and
    on ptxas serialising a wgmma kernel's products (it says so when an
    accumulator or A fragment is touched between an issue and its
    wait)."""
    import re
    name, found = None, []
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line.strip())
        if m:
            name = m.group(1)
            continue
        kind = name and re.search(r"flash_(fwd|bwd_dkdv|bwd_dq)(_bf16)?_kernel"
                                  r"ILi(\d+)E(?:(f|13__nv_bfloat16)E)?", name)
        if not kind:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            dtype = "bf16" if kind.group(2) or kind.group(4) != "f" \
                else "fp32"
            found.append([kind.group(1) + (kind.group(2) or ""),
                          int(kind.group(3)), dtype, None,
                          int(m.group(1)) + int(m.group(2))])
        m = re.search(r"Used (\d+) registers", line)
        if m and found and found[-1][3] is None:
            found[-1][3] = int(m.group(1))
    for kind, d, dtype, regs, spill in sorted(found):
        print("ptxas: flash_%s_kernel<%d, %s>: %s registers, %d bytes "
              "spilled" % (kind, d, dtype, regs, spill))
    check(len(found) == 24, "ptxas: expected the register lines of 24 flash "
          "kernels (3 kernels x 4 D x fp32, bf16; the bf16 ones the wgmma "
          "kernels), found %d" % len(found))
    check(sum(kind.endswith("_bf16") for kind, *_ in found) == 12,
          "ptxas: expected 12 wgmma flash kernels (bf16 K1, K2, K3 x 4 D)")
    check(all(spill == 0 for *_, spill in found),
          "a flash kernel spills registers")
    serial = [line.strip() for line in log.splitlines()
              if "wgmma" in line and "serializ" in line]
    print("ptxas: %d lines on serialised wgmma" % len(serial))
    check(not serial, "ptxas serialises wgmma: %s" % "; ".join(serial))


def wgmma_sass(ck):
    """The bf16 K1, K2 and K3 (wgmma) in the built library's SASS
    (cuobjdump -sass): each of their 12 kernels (4 D each) holds HGMMA,
    Hopper's warpgroup product, and no HMMA (mma.sync). Returns {kernel:
    HGMMA count}."""
    import re
    tool = os.path.join(os.path.dirname(ck._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", ck.build_info.path],
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, "cuobjdump -sass failed: %s" % out.stderr)
    counts = {}
    for body in re.split(r"\n\s*Function : ", out.stdout)[1:]:
        fname = body.split("\n", 1)[0].strip()
        kind = re.search(r"flash_(fwd|bwd_dkdv|bwd_dq)_bf16_kernelILi(\d+)E",
                         fname)
        if not kind:
            continue
        key = "flash_%s_bf16_kernel<%s>" % kind.groups()
        counts[key] = body.count("HGMMA")
        check(counts[key] > 0 and not re.search(r"\bHMMA\b", body),
              "SASS: %s holds %d HGMMA and %d HMMA" % (
                  key, counts[key], len(re.findall(r"\bHMMA\b", body))))
    check(len(counts) == 12, "SASS: expected 12 wgmma flash kernels, found "
          "%s" % sorted(counts))
    print("kernels: SASS of the bf16 K1, K2 and K3: HGMMA in every kernel, no "
          "HMMA: %s" % ", ".join("%s %d" % kv for kv in sorted(
              counts.items())))
    return counts


def sequence_registers(log):
    """Registers and spill bytes of every K6 instantiation
    (fused_lstm_fwd_kernel<RESIDENT, RG>) and K8 one
    (masked_softmax_reg_kernel<CHUNKS, VEC>, masked_softmax_online_kernel)
    from nvcc's `ptxas -v` lines; fails on a spill."""
    import re
    name, found = None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+?)'", line)
        if m:
            name = m.group(1)
            kind = re.search(r"(fused_lstm_fwd_kernel)ILb(\d)ELi(\d+)E|"
                             r"(masked_softmax_reg_kernel)ILi(\d+)ELi(\d+)E|"
                             r"(masked_softmax_online_kernel)", name)
            if kind:
                parts = [p for p in kind.groups() if p is not None]
                found.append([parts[0] + ("<%s>" % ", ".join(parts[1:])
                                          if parts[1:] else ""), None, None])
            continue
        if not found or found[-1][1] is not None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found[-1][2] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[-1][1] = int(m.group(1))
    for kname, regs, spill in found:
        print("ptxas: %s: %s registers, %s bytes spilled" % (kname, regs,
                                                              spill))
    check(len(found) == 15, "ptxas: expected the register lines of 4 K6 and "
          "11 K8 kernels, found %d" % len(found))
    check(all(spill == 0 for _, _, spill in found),
          "a K6 or K8 kernel spills registers")


def flash_work(b, t, h, d, lens, causal, part="fwd", elem=4):
    """(flops, bytes) this input needs. Per valid (query, key) pair: 4*D
    flops forward ("fwd"), 8*D for dK/dV ("dkdv"), 6*D for dQ ("dq").
    Bytes: the [B, T, H, D] tensors the kernel reads and writes in full
    (fwd: q, out; dkdv: q, g, dk, dv; dq: q, g, dq), the k/v rows below
    each length, at `elem` bytes an element (4 fp32, 2 bf16); the fp32
    [B, H, T] rows (fwd: lse; backward: lse, delta), and kv_len, each
    once."""
    pairs = 0
    for n in lens:
        n = max(0, min(int(n), t))
        if causal:
            pairs += sum(min(n, q + 1) for q in range(t))
        else:
            pairs += n * t
    valid_rows = sum(max(0, min(int(n), t)) for n in lens)
    full, rows, per_pair = {"fwd": (2, 1, 4), "dkdv": (4, 2, 8),
                            "dq": (3, 2, 6)}[part]
    nbytes = (elem * (full * b * t * h * d      # q, out / q, g, grads
                      + 2 * valid_rows * h * d)  # k, v rows that matter
              + 4 * (rows * b * h * t            # lse (and delta)
                     + b))                       # kv_len
    return per_pair * d * pairs * h, nbytes


def rel_err(got, want):
    """max |got - want| over the larger of 1 and max |want|: backward
    sums run over up to T terms, so their error grows with the values."""
    return max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
               for g, w in zip(got, want))


def norm_rel(a, b):
    """||a - b|| / ||b|| of two numpy arrays."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def hold_fp32_grads(what, names, got, want, each, median, floored=()):
    """An fp32 training step, card (`got`: loss, [gradients `names`])
    against the CPU (`want`): the loss within CONV_LOSS_RTOL
    relative, each gradient within `each` and their median within
    `median` as ||card - cpu|| / ||cpu||. The gradients in `floored` (0 in
    exact arithmetic: the biases before a batch_norm) are held instead to
    IMAGE_NETS_BIAS_FLOOR of the largest gradient's norm in
    ||card - cpu||. Prints `what`'s line; returns the report."""
    rel = abs(got[0] - want[0]) / abs(want[0])
    top = max(float(np.linalg.norm(b)) for b in want[1])
    held, floor = [], []
    for name, a, b in zip(names, got[1], want[1]):
        if name in floored:
            floor.append((float(np.linalg.norm(a - b)) / top, name))
        else:
            held.append((norm_rel(a, b), name))
    errs = [e for e, _ in held]
    worst = max(held)
    print("%s: loss %.6f vs %.6f (rel %.3e), gradients ||card - cpu|| / "
          "||cpu|| median %.3e, max %.3e (%s), over %d%s"
          % (what, got[0], want[0], rel,
             float(np.median(errs)), worst[0], worst[1], len(errs),
             "; %d biases before a batch_norm: ||card - cpu|| up to %.3e of "
             "the largest gradient's norm (%s)" % (len(floor), *max(floor))
             if floor else ""))
    check(rel <= CONV_LOSS_RTOL, "%s: card and CPU losses differ by %r"
          % (what, rel))
    check(worst[0] <= each and np.median(errs) <= median,
          "%s: card and CPU gradients differ: median %r, max %r (%s)"
          % (what, float(np.median(errs)), worst[0], worst[1]))
    check(all(e <= IMAGE_NETS_BIAS_FLOOR for e, _ in floor),
          "%s: a bias before a batch_norm differs: %r"
          % (what, max(floor, default=None)))
    report = {"loss_rel": rel, "grad_err_max": worst[0],
              "grad_err_median": float(np.median(errs))}
    if floor:
        report["bn_bias_err_of_top"] = max(floor)[0]
    return report


def hold_bf16_step(what, names, card16, cpu16, cpu32, extra=(),
                   kinds="gradients"):
    """A bf16 training step, card (`card16`: loss, [arrays of `names`])
    against the CPU's bf16 step (`cpu16`), with the CPU's fp32 step
    (`cpu32`) as the measure of bf16's own error. bf16 rounds at other
    places on each device, so each array is held, as ||card - cpu|| /
    ||cpu|| in bf16, within BF16_SPREAD_X x the CPU's own bf16-vs-fp32
    spread of it + BF16_FLOOR, as are the (name, err, spread) triples in
    `extra`; the loss within BF16_LOSS_RTOL. Prints `what`'s line; returns
    the report."""
    pairs = [(n, norm_rel(a, b), norm_rel(b, c))
             for n, a, b, c in zip(names, card16[1], cpu16[1], cpu32[1])]
    pairs += list(extra)
    worst = max((err / (BF16_SPREAD_X * spread + BF16_FLOOR), n, err, spread)
                for n, err, spread in pairs)
    rel = abs(card16[0] - cpu16[0]) / abs(cpu16[0])
    report = {"loss_rel": rel, "worst_of_limit": worst[0],
              "grad_err_median": float(np.median([p[1] for p in pairs])),
              "grad_spread_median": float(np.median([p[2] for p in pairs]))}
    print("%s card vs CPU: loss %.6f vs %.6f (rel %.3e; the CPU's fp32 "
          "%.6f); %d %s: card vs CPU median %.3e, max %.3e; the CPU's bf16 "
          "vs fp32 median %.3e, max %.3e; worst against its limit %s: %.3e "
          "vs spread %.3e (%.2f of the limit)"
          % (what, card16[0], cpu16[0], rel, cpu32[0], len(pairs), kinds,
             report["grad_err_median"], max(p[1] for p in pairs),
             report["grad_spread_median"], max(p[2] for p in pairs),
             worst[1], worst[2], worst[3], worst[0]))
    check(np.isfinite(card16[0]) and rel <= BF16_LOSS_RTOL,
          "%s bf16 card and CPU losses differ by %r" % (what, rel))
    check(worst[0] <= 1.0, "%s bf16 card and CPU differ at %s: %r, the "
          "CPU's bf16-vs-fp32 spread %r" % (what, worst[1], worst[2],
                                            worst[3]))
    return report


def run_kernels(torch, ck, peak_flops, peak_bw, tc_flops, bf16_flops,
                flash_fwd_source=None, flash_bwd_source=None,
                flash_bf16_sources=None):
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    results = {}

    # K1: flash attention forward (run_flash_fwd_kernels), with the
    # flash-vs-dense crossover (run_flash_crossover)
    results.update(run_flash_fwd_kernels(torch, ck, g, peak_flops, peak_bw,
                                         tc_flops, flash_fwd_source))
    results["flash_attention_fwd"]["crossover"] = run_flash_crossover(
        torch, ck, g)
    t_max = MODEL["max_length"]

    # K2, K3: flash attention backward (run_flash_bwd_kernels)
    results.update(run_flash_bwd_kernels(torch, ck, g, peak_flops,
                                         peak_bw, tc_flops, flash_bwd_source))
    # K1-K3 in bf16 (mixed precision): run_flash_bf16_kernels, after the
    # SASS of the bf16 K1-K3 shows their wgmma products
    wgmma_sass(ck)
    results.update(run_flash_bf16_kernels(torch, ck, g, peak_bw, tc_flops,
                                          bf16_flops, flash_bf16_sources))

    # K4: softmax cross-entropy forward at the training path's shape
    n, vocab = TRAIN_BATCH * MODEL["max_length"], MODEL["vocab"]
    logits = torch.randn((n, vocab), generator=g, device=dev) * 3
    labels = torch.randint(0, vocab, (n,), generator=g, device=dev)
    odd = labels.clone()
    odd[:4] = torch.tensor([-1, vocab, -5, vocab + 7], device=dev)
    xent_err = 0.0
    for lab in (labels, odd):
        got = ck.softmax_xent_fwd(logits, lab)
        ref = ck.softmax_xent_fwd_plain(logits, lab)
        torch.cuda.synchronize()
        xent_err = max(xent_err, max((a - r).abs().max().item()
                                     for a, r in zip(got, ref)))
    print("kernels: softmax_xent N=%d V=%d (with out-of-range labels) "
          "max_abs_err=%.3e" % (n, vocab, xent_err))
    check(np.isfinite(xent_err) and xent_err <= KERNEL_TOL,
          "softmax_xent_fwd disagrees with its plain version by %r"
          % xent_err)
    # labels -1 and V pick class V - 1 (the JAX CPU path's rule) in K4 and
    # in its plain version alike
    edge = torch.tensor([-1, vocab, -1, vocab], device=dev)
    got = ck.softmax_xent_fwd(logits[:4], edge)
    ref = ck.softmax_xent_fwd_plain(logits[:4], edge)
    rule = ref[1] - logits[:4, vocab - 1:]
    torch.cuda.synchronize()
    edge_err = max(max((a - r).abs().max().item() for a, r in zip(got, ref)),
                   (got[0] - rule).abs().max().item())
    print("kernels: softmax_xent labels -1 and V against the plain version "
          "and the class V - 1: max_abs_err=%.3e" % edge_err)
    check(np.isfinite(edge_err) and edge_err <= KERNEL_TOL,
          "softmax_xent_fwd on labels -1 and V is %r away from class V - 1 "
          "or from its plain version" % edge_err)
    xent_err = max(xent_err, edge_err)
    bms, bby = bound(4 * n * vocab, 4 * n * vocab + 8 * n + 2 * 4 * n,
                     peak_flops, peak_bw)
    results["softmax_xent_fwd"] = {
        "name": "softmax_xent_fwd", "route": "cuda", "source": XENT_SRC,
        "replaces": XENT_TPU, "shape": "logits [%d,%d] fp32" % (n, vocab),
        "max_abs_err": xent_err,
        "ms": time_ms(torch, lambda: ck.softmax_xent_fwd(logits, labels)),
        "plain_ms": time_ms(
            torch, lambda: ck.softmax_xent_fwd_plain(logits, labels)),
        "library_ms": time_ms(torch, lambda: F.cross_entropy(
            logits, labels, reduction="none")),
        "bound_ms": bms, "bound_by": bby,
    }
    del logits

    # K5: layer norm forward, checked at a serving dispatch's rows, the
    # training step's and the beam decodes' (phase 30), timed at the first
    # and at the decodes'
    dm = MODEL["d_model"]
    sc = torch.randn((dm,), generator=g, device=dev)
    bi = torch.randn((dm,), generator=g, device=dev)
    ln_err = 0.0
    decode_rows = (DECODE["sentences"] * DECODE["beam"],
                   DECODE["sentences"] * DECODE["beam"] * t_max)
    decode_x = {}
    for n in (TRAIN_BATCH * t_max,) + decode_rows + (2048,):
        x = torch.randn((n, dm), generator=g, device=dev)
        decode_x[n] = x
        y, mean, var = ck.layer_norm_fwd(x, sc, bi, 1e-5)
        ry, rmean, rvar = ck.layer_norm_fwd_plain(x, sc, bi, 1e-5)
        torch.cuda.synchronize()
        err = max((y - ry).abs().max().item(),
                  (mean - rmean).abs().max().item(),
                  (var - rvar).abs().max().item())
        print("kernels: layer_norm N=%d D=%d max_abs_err=%.3e" % (n, dm, err))
        check(np.isfinite(err) and err <= KERNEL_TOL,
              "layer_norm_fwd disagrees with its plain version by %r" % err)
        ln_err = max(ln_err, err)
    bms, bby = bound(8 * n * dm, 4 * (2 * n * dm + 2 * dm + 2 * n),
                     peak_flops, peak_bw)
    results["layer_norm_fwd"] = {
        "name": "layer_norm_fwd", "route": "cuda", "source": LN_SRC,
        "replaces": LN_TPU, "shape": "x [%d,%d] fp32" % (n, dm),
        "max_abs_err": ln_err,
        "ms": time_ms(torch, lambda: ck.layer_norm_fwd(x, sc, bi, 1e-5)),
        "plain_ms": time_ms(
            torch, lambda: ck.layer_norm_fwd_plain(x, sc, bi, 1e-5)),
        "library_ms": time_ms(
            torch, lambda: F.layer_norm(x, (dm,), sc, bi, 1e-5)),
        "bound_ms": bms, "bound_by": bby,
        "eager_ms": eager_ms(
            torch, lambda: ck.layer_norm_fwd(x, sc, bi, 1e-5)),
    }
    # the beam decodes' rows (phase 30): a cached-decode step's [B*K, 512]
    # and a full-decode step's [B*K*T, 512]
    results["layer_norm_fwd"]["decode_shapes"] = []
    for kind, n in zip(("cached", "full"), decode_rows):
        xd = decode_x[n]
        bms_d, bby_d = bound(8 * n * dm, 4 * (2 * n * dm + 2 * dm + 2 * n),
                             peak_flops, peak_bw)
        results["layer_norm_fwd"]["decode_shapes"].append({
            "decode": kind, "shape": "x [%d,%d] fp32" % (n, dm),
            "ms": time_ms(torch, lambda: ck.layer_norm_fwd(xd, sc, bi,
                                                           1e-5)),
            "plain_ms": time_ms(
                torch, lambda: ck.layer_norm_fwd_plain(xd, sc, bi, 1e-5)),
            "library_ms": time_ms(
                torch, lambda: F.layer_norm(xd, (dm,), sc, bi, 1e-5)),
            "bound_ms": bms_d, "bound_by": bby_d})
        print("kernels: layer_norm decode %s %s" % (
            kind, json.dumps(results["layer_norm_fwd"]["decode_shapes"][-1])))
    del decode_x
    for r in results.values():
        print("kernels: %s ms=%.4f plain_ms=%.4f library_ms=%.4f "
              "bound_ms=%.4f (%s)%s"
              % (r["name"], r["ms"], r["plain_ms"], r["library_ms"],
                 r["bound_ms"], r["bound_by"],
                 " eager_ms=%.4f" % r["eager_ms"] if "eager_ms" in r
                 else ""))
    return results


def flash_path_cases():
    """K1's inputs on the paths (b, t, h, d, kv_len): serving's ragged
    timing batch, a small odd one, and the training step's q, k, v at full
    lengths."""
    t_max = MODEL["max_length"]
    return [(8, 256, 8, 64, [256, 0, 37, 129, 200, 64, 255, 96]),
            (2, 40, 2, 16, [17, 0]),
            (TRAIN_BATCH, t_max, MODEL["n_head"], MODEL["d_key"],
             [t_max] * TRAIN_BATCH)]


def flash_check_cases():
    """(what, (b, t, h, d, kv_len), packed) every flash kernel is checked
    at: the path cases, D 16-128, T = 1 and 100, q/k/v/g cut from one
    packed [B, T, H, 4D] buffer, and B*H = 2048; every kv_len holds a 0."""
    rng = np.random.RandomState(SEED + 3)
    big_lens = rng.randint(1, 129, size=64).tolist()
    big_lens[0], big_lens[1], big_lens[-1] = 128, 0, 1
    return [("path", c, False) for c in flash_path_cases()] + [
        ("D=32, T=100", (4, 100, 3, 32, [100, 0, 57, 1]), False),
        ("D=128", (2, 256, 4, 128, [256, 0]), False),
        ("D=128, T=100", (3, 100, 2, 128, [100, 1, 0]), False),
        ("T=1", (3, 1, 2, 64, [1, 0, 1]), False),
        ("T=1, D=16", (2, 1, 3, 16, [1, 0]), False),
        ("packed [B,T,H,4D] views", (4, 100, 8, 64, [100, 0, 33, 71]), True),
        ("packed [B,T,H,4D] views, D=16", (2, 40, 2, 16, [17, 0]), True),
        ("B*H=2048", (64, 128, 32, 64, big_lens), False)]


def flash_timing_shapes():
    """(what, (b, t, h, d, kv_len), causal) the flash kernels are timed
    at: the serving shape, and the training step's without and with the
    causal mask."""
    t_max = MODEL["max_length"]
    train = (TRAIN_BATCH, t_max, MODEL["n_head"], MODEL["d_key"],
             [t_max] * TRAIN_BATCH)
    return [("serving", flash_path_cases()[0], False),
            ("training", train, False), ("training causal", train, True)]


def flash_inputs(torch, gen, b, t, h, d, packed, n):
    """n random [B, T, H, D] tensors on the card: separate, or strided
    views cut from one packed [B, T, H, 4D] buffer."""
    dev = torch.device("cuda")
    if packed:
        buf = torch.randn((b, t, h, 4 * d), generator=gen, device=dev)
        return [buf[..., i * d:(i + 1) * d] for i in range(n)]
    return [torch.randn((b, t, h, d), generator=gen, device=dev)
            for _ in range(n)]


# lse of a row with no valid key: -1e30 + log(1e-30) in fp32, the TPU
# kernel's l_safe value (and out exactly 0)
EMPTY_LSE = np.float32(-1e30) + np.float32(np.log(np.float32(1e-30)))


def flash_fwd_case(torch, ck, q, k, v, kv_len, causal):
    """K1 against flash_attention_fwd_plain on one input, launched directly
    and replayed from a CUDA graph: out and lse within KERNEL_TOL, and
    every row of a kv_len-0 batch row exactly out 0 and lse EMPTY_LSE.
    Returns the largest error."""
    ref = ck.flash_attention_fwd_plain(q, k, v, kv_len, causal)
    direct = ck.flash_attention_fwd(q, k, v, kv_len, causal)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ck.flash_attention_fwd(q, k, v, kv_len, causal)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ck.flash_attention_fwd(q, k, v, kv_len, causal)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    errs = []
    for out, lse in (direct, replayed):
        errs.append(max((out - ref[0]).abs().max().item(),
                        (lse - ref[1]).abs().max().item()))
        if kv_len is not None:
            empty = kv_len.long() == 0
            check(bool((out[empty] == 0).all())
                  and bool((lse[empty] == float(EMPTY_LSE)).all()),
                  "flash forward: a kv_len-0 row is not out 0, lse %r"
                  % float(EMPTY_LSE))
    del graph
    err = max(errs)
    check(np.isfinite(err) and err <= KERNEL_TOL,
          "flash_attention_fwd disagrees with its plain version by %r "
          "(direct, CUDA graph: %r; tolerance %r)" % (err, errs, KERNEL_TOL))
    return err


def flash_fwd_baseline(torch, ck, source, build_dir):
    """The K1 of commit FLASH_FWD_BASELINE_COMMIT (fp32 on the CUDA cores)
    built from `source`: a function with flash_attention_fwd's signature
    and no launch count (it is on no path)."""
    lib = build_baseline(ck, source, build_dir, "ptt_flash_fwd_baseline",
                         "flash forward")
    ck._bind_flash_fwd(lib)

    def call(q, k, v, kv_len=None, causal=False):
        b, t, h, d = q.shape
        out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
        lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        lens = None if kv_len is None else \
            kv_len.to(dtype=torch.int32).contiguous()
        err = ck._fwd_call(lib.ptt_flash_attention_fwd, q, k, v, lens, out,
                           lse, 1.0 / d ** 0.5, causal)
        check(err == 0, "the baseline flash forward failed to launch "
              "(cudaError %d)" % err)
        return out, lse

    return call


def run_flash_fwd_kernels(torch, ck, gen, peak_flops, peak_bw, tc_flops,
                          source=None):
    """K1 against its plain version at flash_check_cases, causal and not,
    ragged kv_len (with a 0) and none, each launched directly and from a
    CUDA graph. Then timed at flash_timing_shapes: the new kernel and the
    FLASH_FWD_BASELINE_COMMIT one when its source is at hand, in turns;
    the plain version; the forward of scaled_dot_product_attention (fp32,
    TF32 off, the same mask; its device kernels from a trace at the
    training shapes); beside the fp32 (67 TFLOP/s) and 3xTF32 (TF32 peak
    / 3) bounds."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    err_max = 0.0
    for what, (b, t, h, d, lens), packed in flash_check_cases():
        q, k, v = flash_inputs(torch, gen, b, t, h, d, packed, 3)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        for causal in (False, True):
            for kv_len in (kv, None):
                err = flash_fwd_case(torch, ck, q, k, v, kv_len, causal)
                print("kernels: flash fwd %s B=%d T=%d H=%d D=%d causal=%s "
                      "kv_len=%s max_abs_err=%.3e (direct and CUDA graph)"
                      % (what, b, t, h, d, causal,
                         "ragged" if kv_len is not None else "full", err))
                err_max = max(err_max, err)
        del q, k, v
        torch.cuda.empty_cache()

    base = None
    build_dir = tempfile.mkdtemp(prefix="ptt_flash_fwd_baseline_")
    if source is not None:
        t0 = time.perf_counter()
        base = flash_fwd_baseline(torch, ck, source, build_dir)
        print("kernels: built the baseline flash forward (%s) in %.1f s"
              % (FLASH_FWD_BASELINE_COMMIT, time.perf_counter() - t0))
    else:
        print("kernels: the baseline flash forward source is not at hand; "
              "its time is not measured")

    rows = []
    eager = None
    for what, (b, t, h, d, lens), causal in flash_timing_shapes():
        q, k, v = flash_inputs(torch, gen, b, t, h, d, False, 3)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        if base is not None:
            got = base(q, k, v, kv, causal)
            ref = ck.flash_attention_fwd_plain(q, k, v, kv, causal)
            torch.cuda.synchronize()
            print("kernels: the baseline flash forward at %s agrees with the "
                  "plain version to %.3e" % (what, max(
                      (a - r).abs().max().item() for a, r in zip(got, ref))))
            del got, ref
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None if all(n == t for n in lens) else \
            (torch.arange(t, device=dev)[None, :]
             < kv.long()[:, None])[:, None, None, :]

        def sdpa(qt=qt, kt=kt, vt=vt, mask=mask, causal=causal):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=causal)

        if what != "serving":
            print("kernels: the library forward's device kernels at %s: %s"
                  % (what, device_kernel_names(torch, sdpa)))
        runs = {"new": [], "old": []}
        # in turns, old new new old, so that drift shows
        for order in ("old", "new", "new", "old"):
            fn = ck.flash_attention_fwd if order == "new" else base
            if fn is not None:
                runs[order].append(time_ms(
                    torch, lambda fn=fn: fn(q, k, v, kv, causal)))
        flops, nbytes = flash_work(b, t, h, d, lens, causal)
        row = {"what": what, "causal": causal,
               "shape": "q,k,v [%d,%d,%d,%d] fp32, kv_len %s"
               % (b, t, h, d, lens if what == "serving" else "full"),
               "ms": statistics.mean(runs["new"]), "runs": runs["new"],
               "baseline_ms": statistics.mean(runs["old"]) if base else None,
               "baseline_runs": runs["old"],
               "plain_ms": time_ms(torch, lambda: ck.flash_attention_fwd_plain(
                   q, k, v, kv, causal)),
               "library_ms": time_ms(torch, sdpa)}
        row["bound_fp32_ms"], row["bound_fp32_by"] = bound(
            flops, nbytes, peak_flops, peak_bw)
        row["bound_3xtf32_ms"], row["bound_3xtf32_by"] = bound(
            flops, nbytes, tc_flops / 3, peak_bw)
        if what == "serving":
            eager = eager_ms(torch, lambda: ck.flash_attention_fwd(q, k, v,
                                                                   kv))
        print("kernels: flash fwd timing %s (%s, causal=%s): K1 %s ms; "
              "baseline K1 %s ms; plain %.4f ms; library %.4f ms; bound "
              "3xTF32 %.4f ms (%s), fp32 %.4f ms (%s)"
              % (what, row["shape"], causal,
                 " / ".join("%.4f" % x for x in runs["new"]),
                 " / ".join("%.4f" % x for x in runs["old"])
                 or "not measured", row["plain_ms"], row["library_ms"],
                 row["bound_3xtf32_ms"], row["bound_3xtf32_by"],
                 row["bound_fp32_ms"], row["bound_fp32_by"]))
        rows.append(row)
        del q, k, v, qt, kt, vt
    shutil.rmtree(build_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    serve = rows[0]
    return {"flash_attention_fwd": {
        "name": "flash_attention_fwd", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_TPU, "shape": serve["shape"],
        "max_abs_err": err_max, "ms": serve["ms"],
        "plain_ms": serve["plain_ms"], "library_ms": serve["library_ms"],
        # the products run on the tensor cores in 3xTF32
        "bound_ms": serve["bound_3xtf32_ms"],
        "bound_by": serve["bound_3xtf32_by"],
        "bound_fp32_ms": serve["bound_fp32_ms"],
        "baseline_ms": serve["baseline_ms"], "eager_ms": eager,
        "rows": rows}}


CROSSOVER_T = (16, 32, 64, 128, 256, 512, 1024)


def run_flash_crossover(torch, ck, gen):
    """The flash-vs-dense crossover, measured and not acted on: K1 against
    the port's dense attention_reference (what fused_attention runs where
    kernel_config.flash_at says dense) at q, k, v [8, T, 8, 64], T in
    CROSSOVER_T, non-causal, full lengths, each timed in a CUDA graph
    (time_ms). One `crossover:` line per T; returns the rows."""
    from paddle_tpu_torch.ops.nn_ops import attention_reference
    rows = []
    for t in CROSSOVER_T:
        q, k, v = flash_inputs(torch, gen, 8, t, 8, 64, False, 3)
        flash = time_ms(torch, lambda: ck.flash_attention_fwd(q, k, v))
        dense = time_ms(torch, lambda: attention_reference(q, k, v))
        rows.append({"t": t, "flash_ms": flash, "dense_ms": dense})
        print("crossover: q,k,v [8,%d,8,64] fp32, full lengths: flash K1 "
              "%.4f ms, dense attention_reference %.4f ms, dense / flash "
              "%.3f" % (t, flash, dense, dense / flash))
        del q, k, v
    torch.cuda.empty_cache()
    return rows


def run_unequal_attention_vs_cpu(torch):
    """Fault C5: fused_attention of q [B, Tq, H, D] over k, v [B, Tk, H,
    D] with Tq != Tk (a decoder over a source of another padded length)
    takes the dense path on the card. A one-op program (the loss
    mean(out * w), q, k, v's gradients through append_backward) runs
    through Executor.run on the card and on the CPU, causal and not, with
    ragged key lengths (a 0 among them): every fetch within KERNEL_TOL of
    the larger of 1 and its largest CPU value, and K1 never launched."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import cuda_kernels as ck
    rng = np.random.RandomState(SEED + 9)
    for b, tq, tk, h, d in ((2, 5, 7, 2, 8), (8, 128, 256, 8, 64)):
        lens = rng.randint(1, tk + 1, size=(b, 1)).astype(np.int32)
        lens[-1, 0] = 0
        feed = {n: rng.randn(b, t, h, d).astype(np.float32)
                for n, t in (("q", tq), ("k", tk), ("v", tk), ("w", tq))}
        feed["kv_len"] = lens
        for causal in (False, True):
            main, startup = fluid.Program(), fluid.Program()
            with fluid.unique_name.guard(), \
                    fluid.program_guard(main, startup):
                q, k, v = (fluid.layers.data(n, shape=[t, h, d],
                                             dtype="float32")
                           for n, t in (("q", tq), ("k", tk), ("v", tk)))
                for x in (q, k, v):
                    x.stop_gradient = False
                w = fluid.layers.data("w", shape=[tq, h, d], dtype="float32")
                kv_len = fluid.layers.data("kv_len", shape=[1],
                                           dtype="int32")
                out = fluid.layers.fused_attention(q, k, v, causal=causal,
                                                   kv_len=kv_len)
                loss = fluid.layers.mean(fluid.layers.elementwise_mul(out,
                                                                      w))
                fluid.append_backward(loss)
            fetch = [out.name, loss.name, "q@GRAD", "k@GRAD", "v@GRAD"]
            ck.reset_launch_counts()
            got = fluid.Executor().run(main, feed=feed, fetch_list=fetch,
                                       scope=fluid.Scope())
            launched = ck.launch_counts()["flash_attention_fwd"]
            want = fluid.Executor("cpu").run(main, feed=feed,
                                             fetch_list=fetch,
                                             scope=fluid.Scope())
            err = max(float(np.abs(a - c).max())
                      / max(1.0, float(np.abs(c).max()))
                      for a, c in zip(got, want))
            print("unequal lengths: fused_attention q [%d,%d,%d,%d] over k, "
                  "v [%d,%d,%d,%d] causal=%s on the card vs the CPU (out, "
                  "loss, dq, dk, dv): max error %.3e of max(1, max |cpu|), "
                  "K1 launches %d" % (b, tq, h, d, b, tk, h, d, causal, err,
                                      launched))
            check(got[0].shape == (b, tq, h, d), "fused_attention with Tq "
                  "!= Tk gave shape %s" % (got[0].shape,))
            check(np.isfinite(err) and err <= KERNEL_TOL,
                  "fused_attention with Tq != Tk: card and CPU differ by %r"
                  % err)
            check(launched == 0, "fused_attention with Tq != Tk launched "
                  "K1 %d times" % launched)


def flash_bwd_case(torch, ck, q, k, v, g_out, kv_len, causal):
    """K2 and K3 against flash_attention_bwd_plain on one input (from the
    plain forward's out and lse, delta = rowsum(g * out)), launched directly
    and replayed from a CUDA graph. Checks both within KERNEL_TOL (relative,
    rel_err) and every gradient of a kv_len-0 row exactly 0. Returns the
    largest dK/dV and dQ errors."""
    out, lse = ck.flash_attention_fwd_plain(q, k, v, kv_len, causal)
    delta = ck.flash_delta(g_out, out)
    args = (q, k, v, lse, delta, g_out, kv_len, causal)
    ref = ck.flash_attention_bwd_plain(*args)
    direct = ck.flash_attention_bwd_dkdv(*args) + (
        ck.flash_attention_bwd_dq(*args),)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ck.flash_attention_bwd_dkdv(*args)
        ck.flash_attention_bwd_dq(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ck.flash_attention_bwd_dkdv(*args) + (
            ck.flash_attention_bwd_dq(*args),)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    errs = []
    for dk, dv, dq in (direct, replayed):
        errs.append((rel_err((dk, dv), ref[1:]), rel_err((dq,), ref[:1])))
        if kv_len is not None:
            empty = kv_len.long() == 0
            check(all(bool((x[empty] == 0).all()) for x in (dk, dv, dq)),
                  "flash backward: a kv_len-0 row has a nonzero gradient")
    del graph
    e_kv = max(e for e, _ in errs)
    e_q = max(e for _, e in errs)
    check(np.isfinite(e_kv) and e_kv <= KERNEL_TOL
          and np.isfinite(e_q) and e_q <= KERNEL_TOL,
          "flash backward disagrees with its plain version: dK/dV %r, dQ %r "
          "(direct, CUDA graph: %r; tolerance %r)"
          % (e_kv, e_q, errs, KERNEL_TOL))
    return e_kv, e_q


def flash_bwd_baseline(torch, ck, source, build_dir):
    """The K2/K3 of commit FLASH_BWD_BASELINE_COMMIT (fp32 on the CUDA
    cores) built from `source`: (dkdv, dq) functions with the wrappers'
    signatures and no launch count (they are on no path)."""
    lib = build_baseline(ck, source, build_dir, "ptt_flash_bwd_baseline",
                         "flash backward")
    ck._bind_flash_bwd(lib)

    def call(fn, n_out, q, k, v, lse, delta, g, kv_len=None, causal=False):
        b, t, h, d, lens, lse, delta = ck._flash_bwd_args(
            "baseline flash backward", q, k, v, lse, delta, g, kv_len)
        outs = [torch.empty((b, t, h, d), dtype=torch.float32,
                            device=q.device) for _ in range(n_out)]
        err = ck._bwd_call(fn, q, k, v, g, lse, delta, lens, outs, b, t, h,
                           d, 1.0 / d ** 0.5, causal)
        check(err == 0, "the baseline flash backward failed to launch "
              "(cudaError %d)" % err)
        return tuple(outs)

    return (lambda *a: call(lib.ptt_flash_attention_bwd_dkdv, 2, *a),
            lambda *a: call(lib.ptt_flash_attention_bwd_dq, 1, *a))


def flash_bf16_call(torch, ck, lib, part):
    """A function with flash_attention_fwd's signature (part "fwd"),
    flash_attention_bwd_dkdv's ("dkdv") or flash_attention_bwd_dq's
    ("dq"), on bf16 inputs, that launches the bf16 entry of `lib`: an
    earlier or a variant kernel's library, with no launch count (it is on
    no path). The backward ones return a tuple (dk, dv) or (dq,)."""
    ck._bind_flash_bf16(lib, (part,))
    if part == "fwd":
        fn = lib.ptt_flash_attention_fwd_bf16

        def call(q, k, v, kv_len=None, causal=False):
            b, t, h, d = q.shape
            out = torch.empty((b, t, h, d), dtype=torch.bfloat16,
                              device=q.device)
            lse = torch.empty((b, h, t), dtype=torch.float32,
                              device=q.device)
            lens = None if kv_len is None else \
                kv_len.to(dtype=torch.int32).contiguous()
            err = ck._fwd_call(fn, q, k, v, lens, out, lse, 1.0 / d ** 0.5,
                               causal)
            check(err == 0, "a bf16 flash forward of another source failed "
                  "to launch (cudaError %d)" % err)
            return out, lse

        return call
    fn = getattr(lib, "ptt_flash_attention_bwd_%s_bf16" % part)
    n_out = 2 if part == "dkdv" else 1

    def call(q, k, v, lse, delta, g, kv_len=None, causal=False):
        b, t, h, d, lens, lse, delta = ck._flash_bwd_args(
            "bf16 flash %s of another source" % part, q, k, v, lse, delta, g,
            kv_len)
        outs = [torch.empty((b, t, h, d), dtype=torch.bfloat16,
                            device=q.device) for _ in range(n_out)]
        err = ck._bwd_call(fn, q, k, v, g, lse, delta, lens, outs, b, t, h, d,
                           1.0 / d ** 0.5, causal)
        check(err == 0, "a bf16 flash %s of another source failed to "
              "launch (cudaError %d)" % (part, err))
        return tuple(outs)

    return call


def device_events(torch, prof):
    """[(name, us)] of every event a finished torch.profiler session
    recorded on the device, read from its raw results: parsing them into
    FunctionEvents (`prof.events()`) costs seconds a session for the same
    names and durations."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def device_kernel_names(torch, fn):
    """The device kernels one call of fn runs (from a torch.profiler
    trace): what a library yardstick is."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({name for name, _ in device_events(torch, prof)})


def run_flash_bwd_kernels(torch, ck, gen, peak_flops, peak_bw, tc_flops,
                          source=None):
    """K2 (dK, dV) and K3 (dQ) against their plain version at
    flash_check_cases, causal and not, ragged kv_len (with a 0) and none,
    each launched directly and from a CUDA graph. Then timed (new
    kernels, the FLASH_BWD_BASELINE_COMMIT kernels when their source is at
    hand, plain, library) beside two bounds at flash_timing_shapes."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    dkdv_err = dq_err = 0.0
    for what, (b, t, h, d, lens), packed in flash_check_cases():
        q, k, v, g_out = flash_inputs(torch, gen, b, t, h, d, packed, 4)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        for causal in (False, True):
            for kv_len in (kv, None):
                e_kv, e_q = flash_bwd_case(torch, ck, q, k, v, g_out, kv_len,
                                           causal)
                print("kernels: flash bwd %s B=%d T=%d H=%d D=%d causal=%s "
                      "kv_len=%s dkdv_rel_err=%.3e dq_rel_err=%.3e (direct "
                      "and CUDA graph)"
                      % (what, b, t, h, d, causal,
                         "ragged" if kv_len is not None else "full", e_kv,
                         e_q))
                dkdv_err, dq_err = max(dkdv_err, e_kv), max(dq_err, e_q)
        del q, k, v, g_out
        torch.cuda.empty_cache()

    base = None
    build_dir = tempfile.mkdtemp(prefix="ptt_flash_bwd_baseline_")
    if source is not None:
        t0 = time.perf_counter()
        base = flash_bwd_baseline(torch, ck, source, build_dir)
        print("kernels: built the baseline flash backward (%s) in %.1f s"
              % (FLASH_BWD_BASELINE_COMMIT, time.perf_counter() - t0))
    else:
        print("kernels: the baseline flash backward source is not at hand; "
              "its time is not measured")

    rows = []
    for what, (b, t, h, d, lens), causal in flash_timing_shapes():
        q, k, v, g_out = (torch.randn((b, t, h, d), generator=gen,
                                      device=dev) for _ in range(4))
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        out, lse = ck.flash_attention_fwd(q, k, v, kv, causal)
        delta = ck.flash_delta(g_out, out)
        args = (q, k, v, lse, delta, g_out, kv, causal)
        if base is not None:
            got = base[0](*args) + base[1](*args)
            ref = ck.flash_attention_bwd_plain(*args)
            torch.cuda.synchronize()
            print("kernels: the baseline flash backward at %s agrees with "
                  "the plain version to dK/dV %.3e, dQ %.3e"
                  % (what, rel_err(got[:2], ref[1:]),
                     rel_err(got[2:], ref[:1])))
            del got, ref
        # the library yardstick: the backward of scaled_dot_product_attention
        # with the same mask (dQ, dK and dV together). Autograd runs a
        # backward on its forward's stream, so the graph captures forward +
        # backward, and the forward's own time is taken off.
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        gt = g_out.transpose(1, 2)
        mask = None if all(n == t for n in lens) else \
            (torch.arange(t, device=dev)[None, :]
             < kv.long()[:, None])[:, None, None, :]

        def sdpa(qt=qt, kt=kt, vt=vt, mask=mask, causal=causal):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=causal)

        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            sdpa(), (qt, kt, vt), gt)) - time_ms(torch, sdpa)
        if what != "serving":
            out_t = sdpa()
            print("kernels: the library backward's device kernels at %s: %s"
                  % (what, device_kernel_names(torch, lambda: torch.autograd
                                               .grad(out_t, (qt, kt, vt),
                                                     gt))))
            del out_t
        times = {"dkdv": [], "dq": [], "base_dkdv": [], "base_dq": []}
        # in turns, old new new old, so that drift shows
        for order in ("old", "new", "new", "old"):
            pair = ((ck.flash_attention_bwd_dkdv, ck.flash_attention_bwd_dq)
                    if order == "new" else base)
            if pair is None:
                continue
            for key, fn in zip(("dkdv", "dq"), pair):
                times[key if order == "new" else "base_" + key].append(
                    time_ms(torch, lambda fn=fn: fn(*args)))
        row = {"what": what, "causal": causal, "library_ms": library_ms,
               "shape": "q,k,v,g [%d,%d,%d,%d] fp32, kv_len %s"
               % (b, t, h, d, lens if what == "serving" else "full"),
               "plain_ms": time_ms(
                   torch, lambda: ck.flash_attention_bwd_plain(*args))}
        for part in ("dkdv", "dq"):
            flops, nbytes = flash_work(b, t, h, d, lens, causal, part)
            row[part + "_ms"] = statistics.mean(times[part])
            row[part + "_runs"] = times[part]
            row["baseline_%s_ms" % part] = (
                statistics.mean(times["base_" + part]) if base else None)
            row["baseline_%s_runs" % part] = times["base_" + part]
            row[part + "_bound_fp32_ms"], row[part + "_bound_fp32_by"] = \
                bound(flops, nbytes, peak_flops, peak_bw)
            row[part + "_bound_3xtf32_ms"], row[part + "_bound_3xtf32_by"] = \
                bound(flops, nbytes, tc_flops / 3, peak_bw)
        row["sum_ms"] = row["dkdv_ms"] + row["dq_ms"]
        row["baseline_sum_ms"] = (row["baseline_dkdv_ms"]
                                  + row["baseline_dq_ms"] if base else None)

        def runs(key):
            return " / ".join("%.4f" % x for x in times[key]) or \
                "not measured"

        print("kernels: flash bwd timing %s (%s, causal=%s): K2 %s ms, K3 %s "
              "ms, sum %.4f ms; baseline K2 %s, K3 %s, sum %s ms; plain "
              "%.4f ms; library %.4f ms; bound 3xTF32 %.4f + %.4f ms (%s), "
              "fp32 %.4f + %.4f ms (%s)"
              % (what, row["shape"], causal, runs("dkdv"), runs("dq"),
                 row["sum_ms"], runs("base_dkdv"), runs("base_dq"),
                 "not measured" if base is None
                 else "%.4f" % row["baseline_sum_ms"],
                 row["plain_ms"], library_ms, row["dkdv_bound_3xtf32_ms"],
                 row["dq_bound_3xtf32_ms"], row["dkdv_bound_3xtf32_by"],
                 row["dkdv_bound_fp32_ms"], row["dq_bound_fp32_ms"],
                 row["dkdv_bound_fp32_by"]))
        rows.append(row)
        del q, k, v, g_out, out, qt, kt, vt
    shutil.rmtree(build_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    serve = rows[0]
    results = {}
    for name, tpu, err, part, other in (
            ("flash_attention_bwd_dkdv", DKDV_TPU, dkdv_err, "dkdv", "dq"),
            ("flash_attention_bwd_dq", DQ_TPU, dq_err, "dq", "dkdv")):
        results[name] = {
            "name": name, "route": "cuda", "source": FLASH_BWD_SRC,
            "replaces": tpu, "shape": serve["shape"], "max_abs_err": err,
            "err_kind": "relative (max |kernel - plain| / max(1, max "
            "|plain|))",
            "ms": serve[part + "_ms"], "plain_ms": serve["plain_ms"],
            "library_ms": serve["library_ms"],
            "library_covers": "dQ, dK and dV (one backward call)",
            # the products run on the tensor cores in 3xTF32
            "bound_ms": serve[part + "_bound_3xtf32_ms"],
            "bound_by": serve[part + "_bound_3xtf32_by"],
            "bound_fp32_ms": serve[part + "_bound_fp32_ms"],
            "baseline_ms": serve["baseline_%s_ms" % part],
            "rows": [{key: val for key, val in r.items()
                      if not key.startswith((other, "baseline_" + other))}
                     for r in rows],
        }
    return results


# bf16 K1-K3 against their plain versions, both fed the same bf16 inputs:
# every product and sum runs in fp32 in each, in another order, and each
# rounds its outputs to bf16 once; a sum that lands near a rounding
# boundary takes the neighbouring bf16 value, one ulp (2^-8 of the
# value) away. Held to two ulps of the largest value: max |kernel - plain|
# / max(1, max |plain|) <= 2^-7. lse (fp32) stays at KERNEL_TOL.
BF16_KERNEL_TOL = 2.0 ** -7
# what a useful fp32 product costs in the bf16 kernels as they are built
# (the `bound_design_ms` beside each bf16 row's bound), and on which
# tensor-core peak. All three are wgmma kernels: S, dP one bf16 product
# each (exact: bf16 operands), P V, dV, dK, dQ two (P and dS split into
# bf16 hi + lo), so 1.5 for K1 (4 D a pair), 1.5 for K2 (12 D for 8 D)
# and 8 / 6 for K3 (8 D for 6 D)
BF16_DESIGN = {"fwd": (1.5, "bf16"), "dkdv": (12.0 / 8.0, "bf16"),
               "dq": (8.0 / 6.0, "bf16")}


def flash_bf16_cases():
    """(what, (b, t, h, d, kv_len), causal, packed) the bf16 flash kernels
    are held against their plain versions at: flash_timing_shapes (the
    serving batch with ragged lengths and a 0, the training step's without
    and with the causal mask), then D 16, 32 and 128 at odd T, and strided
    views of one packed [B, T, H, 4D] buffer."""
    return [(what, shape, causal, False)
            for what, shape, causal in flash_timing_shapes()] + [
        ("D=16, T=40", (2, 40, 2, 16, [17, 0]), True, False),
        ("D=32, T=100", (4, 100, 3, 32, [100, 0, 57, 1]), False, False),
        ("D=128, T=100", (3, 100, 2, 128, [100, 1, 0]), True, False),
        ("packed [B,T,H,4D] views", (4, 100, 8, 64, [100, 0, 33, 71]),
         False, True)]


def flash_bf16_inputs(torch, gen, b, t, h, d, packed, n):
    """flash_inputs rounded to bf16 (the packed buffer rounded whole, so
    the views keep their strides)."""
    dev = torch.device("cuda")
    if packed:
        buf = torch.randn((b, t, h, 4 * d), generator=gen,
                          device=dev).to(torch.bfloat16)
        return [buf[..., i * d:(i + 1) * d] for i in range(n)]
    return [torch.randn((b, t, h, d), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(n)]


def flash_bf16_case(torch, ck, q, k, v, g_out, kv_len, causal):
    """bf16 K1, K2 and K3 against their plain versions on one input,
    launched directly and replayed from a CUDA graph: out, dK, dV and dQ
    bf16 within BF16_KERNEL_TOL (rel_err), lse fp32 within KERNEL_TOL, and
    a kv_len-0 row out 0, lse EMPTY_LSE and gradients 0. Returns the three
    errors (K1 the larger of out's and lse's), the worse of the two
    runs."""
    ref_out, ref_lse = ck.flash_attention_fwd_plain(q, k, v, kv_len, causal)
    delta = ck.flash_delta(g_out, ref_out)
    args = (q, k, v, ref_lse, delta, g_out, kv_len, causal)
    ref = ck.flash_attention_bwd_plain(*args)

    def run():
        return (ck.flash_attention_fwd(q, k, v, kv_len, causal)
                + ck.flash_attention_bwd_dkdv(*args)
                + (ck.flash_attention_bwd_dq(*args),))

    direct = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = run()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    errs = []
    for how, (out, lse, dk, dv, dq) in (("direct", direct),
                                        ("CUDA graph", replayed)):
        check(out.dtype == dk.dtype == dv.dtype == dq.dtype == torch.bfloat16
              and lse.dtype == delta.dtype == torch.float32,
              "bf16 flash kernels: out %s, dK %s, dV %s, dQ %s, lse %s"
              % (out.dtype, dk.dtype, dv.dtype, dq.dtype, lse.dtype))
        e_out = rel_err((out.float(),), (ref_out.float(),))
        e_lse = (lse - ref_lse).abs().max().item()
        e_kv = rel_err((dk.float(), dv.float()),
                       (ref[1].float(), ref[2].float()))
        e_q = rel_err((dq.float(),), (ref[0].float(),))
        if kv_len is not None:
            empty = kv_len.long() == 0
            check(bool((out[empty] == 0).all())
                  and bool((lse[empty] == float(EMPTY_LSE)).all())
                  and all(bool((x[empty] == 0).all()) for x in (dk, dv, dq)),
                  "bf16 flash kernels (%s): a kv_len-0 row is not out 0, "
                  "lse %r, gradients 0" % (how, float(EMPTY_LSE)))
        check(np.isfinite(e_out) and e_out <= BF16_KERNEL_TOL
              and np.isfinite(e_lse) and e_lse <= KERNEL_TOL
              and np.isfinite(e_kv) and e_kv <= BF16_KERNEL_TOL
              and np.isfinite(e_q) and e_q <= BF16_KERNEL_TOL,
              "bf16 flash kernels (%s) disagree with their plain versions: "
              "out %r, lse %r, dK/dV %r, dQ %r (tolerances %r, %r)"
              % (how, e_out, e_lse, e_kv, e_q, BF16_KERNEL_TOL, KERNEL_TOL))
        errs.append((max(e_out, e_lse), e_kv, e_q))
    del graph
    return tuple(max(e) for e in zip(*errs))


def flash_bf16_baseline(torch, ck, sources):
    """The bf16 K1 and K2 of commit FLASH_BF16_BASELINE_COMMIT and the bf16
    K3 of FLASH_BF16_DQ_BASELINE_COMMIT (each the fp32 template on bf16
    tiles, TF32 mma.sync), built from sources {part: source or None (not
    measured)}, all at once: {part: fn} with the wrappers' signatures and
    no launch count (they are on no path)."""
    import concurrent.futures
    todo = {}
    for part, source in sources.items():
        if source is None:
            print("kernels: the %s bf16 %s source is not at hand; its time "
                  "prints as not measured" % (BF16_BASELINES[part][0], part))
        else:
            todo[part] = source
    t0 = time.perf_counter()

    def one(part):
        return build_baseline(ck, todo[part], tempfile.mkdtemp(
            prefix="ptt_flash_bf16_baseline_"), "ptt_flash_bf16_" + part,
            "bf16 flash " + part)

    with concurrent.futures.ThreadPoolExecutor(max(1, len(todo))) as pool:
        libs = dict(zip(todo, pool.map(one, todo)))
    fns = {part: flash_bf16_call(torch, ck, lib, part)
           for part, lib in libs.items()}
    if fns:
        print("kernels: built the earlier bf16 %s in %.1f s" % (
            ", ".join("%s (%s)" % (part, BF16_BASELINES[part][0])
                      for part in fns), time.perf_counter() - t0))
    return fns


def run_flash_bf16_kernels(torch, ck, gen, peak_bw, tc_flops, bf16_flops,
                           sources=None):
    """K1, K2 and K3 on bf16 q, k, v and g (the mixed-precision
    Transformer's): each against its plain version in bf16 at
    flash_bf16_cases (flash_bf16_case: directly and from a CUDA graph),
    then timed at flash_timing_shapes beside the fp32 kernels on the same
    values widened and the earlier bf16 kernels (BF16_BASELINES: K1 and K2
    of commit FLASH_BF16_BASELINE_COMMIT, K3 of
    FLASH_BF16_DQ_BASELINE_COMMIT) built from `sources` {part: source}
    (in turns: earlier, fp32, bf16, bf16, fp32, earlier), the plain
    versions, and scaled_dot_product_attention on the bf16 inputs
    (forward; backward as the graph of forward + backward less the
    forward). Bound: the larger of the bytes at 2 an element (lse, delta
    fp32) over the memory rate and the function's products over the bf16
    tensor-core peak. Beside it the bound of the kernels' design
    (bound_design_ms): the products they issue (BF16_DESIGN) over their
    peak. Returns the three kernels' rows for the `kernels` line, keyed by
    ck.launch_counts()' names."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    base = flash_bf16_baseline(torch, ck, sources or {})
    errs = {"fwd": 0.0, "dkdv": 0.0, "dq": 0.0}
    for what, (b, t, h, d, lens), causal, packed in flash_bf16_cases():
        q, k, v, g_out = flash_bf16_inputs(torch, gen, b, t, h, d, packed, 4)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        for kv_len in (kv, None):
            got = flash_bf16_case(torch, ck, q, k, v, g_out, kv_len, causal)
            print("kernels: flash bf16 %s B=%d T=%d H=%d D=%d causal=%s "
                  "kv_len=%s (direct and CUDA graph) K1 err %.3e, K2 (dK, "
                  "dV) rel err %.3e, K3 (dQ) rel err %.3e"
                  % (what, b, t, h, d, causal,
                     "ragged" if kv_len is not None else "full", *got))
            for key, e in zip(("fwd", "dkdv", "dq"), got):
                errs[key] = max(errs[key], e)
        del q, k, v, g_out
        torch.cuda.empty_cache()
    peaks = {"bf16": bf16_flops, "tf32": tc_flops}

    rows = []
    for what, (b, t, h, d, lens), causal in flash_timing_shapes():
        q, k, v, g_out = flash_bf16_inputs(torch, gen, b, t, h, d, False, 4)
        q32, k32, v32, g32 = (x.float() for x in (q, k, v, g_out))
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        out, lse = ck.flash_attention_fwd(q, k, v, kv, causal)
        out32, lse32 = ck.flash_attention_fwd(q32, k32, v32, kv, causal)
        args = (q, k, v, lse, ck.flash_delta(g_out, out), g_out, kv, causal)
        args32 = (q32, k32, v32, lse32, ck.flash_delta(g32, out32), g32, kv,
                  causal)
        fns = {"fwd": (lambda: ck.flash_attention_fwd(q, k, v, kv, causal),
                       lambda: ck.flash_attention_fwd(q32, k32, v32, kv,
                                                      causal)),
               "dkdv": (lambda: ck.flash_attention_bwd_dkdv(*args),
                        lambda: ck.flash_attention_bwd_dkdv(*args32)),
               "dq": (lambda: ck.flash_attention_bwd_dq(*args),
                      lambda: ck.flash_attention_bwd_dq(*args32))}
        old = {}
        if "fwd" in base:
            old["fwd"] = lambda: base["fwd"](q, k, v, kv, causal)
        if "dkdv" in base:
            old["dkdv"] = lambda: base["dkdv"](*args)
        if "dq" in base:
            old["dq"] = lambda: base["dq"](*args)
        for part, fn in old.items():
            got = fn()
            want = fns[part][0]()
            if part == "dq":
                want = (want,)
            torch.cuda.synchronize()
            err = rel_err([x.float() for x in got], [x.float() for x in want])
            print("kernels: the %s bf16 %s at %s agrees with the current "
                  "one within %.3e" % (BF16_BASELINES[part][0], part,
                                       what, err))
            check(err <= 2 * BF16_KERNEL_TOL, "the %s bf16 %s disagrees "
                  "with the current one by %r" % (BF16_BASELINES[part][0],
                                                  part, err))
        row = {"what": what, "causal": causal,
               "shape": "q,k,v,g [%d,%d,%d,%d] bf16, kv_len %s"
               % (b, t, h, d, lens if what == "serving" else "full")}
        for part, (fn16, fn32) in fns.items():
            runs = {"bf16": [], "fp32": [], "old": []}
            order = ("fp32", "bf16", "bf16", "fp32")
            if part in old:
                order = ("old",) + order + ("old",)
            for turn in order:
                runs[turn].append(time_ms(torch, {
                    "bf16": fn16, "fp32": fn32}.get(turn, old.get(part))))
            flops, nbytes = flash_work(b, t, h, d, lens, causal, part, 2)
            row[part + "_ms"] = statistics.mean(runs["bf16"])
            row[part + "_runs"] = runs["bf16"]
            row[part + "_fp32_ms"] = statistics.mean(runs["fp32"])
            row[part + "_fp32_runs"] = runs["fp32"]
            row[part + "_baseline_ms"] = (statistics.mean(runs["old"])
                                          if runs["old"] else None)
            row[part + "_baseline_runs"] = runs["old"]
            row[part + "_bound_ms"], row[part + "_bound_by"] = bound(
                flops, nbytes, bf16_flops, peak_bw)
            cost, peak = BF16_DESIGN[part]
            row[part + "_bound_design_ms"], row[part + "_bound_design_by"] = \
                bound(flops * cost, nbytes, peaks[peak], peak_bw)
        row["fwd_plain_ms"] = time_ms(
            torch, lambda: ck.flash_attention_fwd_plain(q, k, v, kv, causal))
        row["bwd_plain_ms"] = time_ms(
            torch, lambda: ck.flash_attention_bwd_plain(*args))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        gt = g_out.transpose(1, 2)
        mask = None if all(n == t for n in lens) else \
            (torch.arange(t, device=dev)[None, :]
             < kv.long()[:, None])[:, None, None, :]

        def sdpa(qt=qt, kt=kt, vt=vt, mask=mask, causal=causal):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=causal)

        row["fwd_library_ms"] = time_ms(torch, sdpa)
        row["bwd_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            sdpa(), (qt, kt, vt), gt)) - row["fwd_library_ms"]
        if what != "serving":
            print("kernels: the library's bf16 forward device kernels at %s: "
                  "%s" % (what, device_kernel_names(torch, sdpa)))

        def runs_of(key):
            return " / ".join("%.4f" % x for x in row[key]) or "not measured"

        print("kernels: flash bf16 timing %s (%s, causal=%s): K1 %s ms (%s "
              "K1 %s; fp32 K1 %s), bound %.4f ms (%s; design %.4f, %s), "
              "plain %.4f, library %.4f; K2 %s ms (%s K2 %s; fp32 %s), bound "
              "%.4f (%s; design %.4f, %s); K3 %s ms (%s K3 %s; fp32 %s), "
              "bound %.4f (%s; design %.4f, %s); backward plain %.4f, "
              "library %.4f ms (dQ, dK, dV)"
              % (what, row["shape"], causal, runs_of("fwd_runs"),
                 FLASH_BF16_BASELINE_COMMIT, runs_of("fwd_baseline_runs"),
                 runs_of("fwd_fp32_runs"),
                 row["fwd_bound_ms"], row["fwd_bound_by"],
                 row["fwd_bound_design_ms"], row["fwd_bound_design_by"],
                 row["fwd_plain_ms"], row["fwd_library_ms"],
                 runs_of("dkdv_runs"), FLASH_BF16_BASELINE_COMMIT,
                 runs_of("dkdv_baseline_runs"), runs_of("dkdv_fp32_runs"),
                 row["dkdv_bound_ms"], row["dkdv_bound_by"],
                 row["dkdv_bound_design_ms"], row["dkdv_bound_design_by"],
                 runs_of("dq_runs"), FLASH_BF16_DQ_BASELINE_COMMIT,
                 runs_of("dq_baseline_runs"), runs_of("dq_fp32_runs"),
                 row["dq_bound_ms"], row["dq_bound_by"],
                 row["dq_bound_design_ms"], row["dq_bound_design_by"],
                 row["bwd_plain_ms"], row["bwd_library_ms"]))
        for part in ("fwd", "dkdv", "dq"):
            if row[part + "_baseline_ms"] is not None:
                check(row[part + "_ms"] < row[part + "_baseline_ms"],
                      "the bf16 %s (%.4f ms) is not faster than the %s one "
                      "(%.4f ms) at %s" % (part, row[part + "_ms"],
                                           BF16_BASELINES[part][0],
                                           row[part + "_baseline_ms"], what))
        rows.append(row)
        del q, k, v, g_out, q32, k32, v32, g32, out, out32, qt, kt, vt
    torch.cuda.empty_cache()

    serve = rows[0]
    results = {}
    for name, src, tpu, part, stage in (
            ("flash_attention_fwd", FLASH_BF16_SRC, FLASH_TPU, "fwd", "fwd"),
            ("flash_attention_bwd_dkdv", DKDV_BF16_SRC, DKDV_TPU, "dkdv",
             "bwd"),
            ("flash_attention_bwd_dq", DQ_BF16_SRC, DQ_TPU, "dq", "bwd")):
        results[name + "_bf16"] = {
            "name": name + "_bf16", "route": "cuda", "source": src,
            "replaces": tpu, "shape": serve["shape"],
            "max_abs_err": errs[part],
            "err_kind": "relative to max(1, max |plain|), bf16 outputs"
            + (" (lse absolute)" if part == "fwd" else ""),
            "ms": serve[part + "_ms"], "fp32_kernel_ms": serve[
                part + "_fp32_ms"],
            "plain_ms": serve[stage + "_plain_ms"],
            "library_ms": serve[stage + "_library_ms"],
            "library_covers": "scaled_dot_product_attention on the bf16 "
            "inputs" + (", backward: dQ, dK and dV in one call"
                        if stage == "bwd" else ""),
            "bound_ms": serve[part + "_bound_ms"],
            "bound_by": serve[part + "_bound_by"],
            "bound_design_ms": serve[part + "_bound_design_ms"],
            "bound_design_by": serve[part + "_bound_design_by"],
            "rows": [{key: val for key, val in r.items()
                      if key in ("what", "causal", "shape")
                      or key.startswith((part + "_", stage + "_"))}
                     for r in rows],
        }
        results[name + "_bf16"]["baseline_ms"] = serve[part + "_baseline_ms"]
        results[name + "_bf16"]["baseline_commit"] = BF16_BASELINES[part][0]
    return results


def lstm_work(lens, t, d, b, with_state):
    """(flops, bytes) K6 needs for these lengths: per valid (row, step)
    the recurrent product (8*D*D) and ~18*D elementwise operations, and
    the rows of x those steps read; W, the bias, the lengths, h0/c0 when
    given and the full [B, T, D] hidden and cell outputs, each once."""
    valid = sum(max(0, min(int(n), t)) for n in lens)
    flops = valid * (8 * d * d + 18 * d)
    nbytes = 4 * (valid * 4 * d + 4 * d * d + 4 * d + b
                  + (2 * b * d if with_state else 0) + 2 * b * t * d)
    return flops, nbytes


def pool_work(lens, t, f, b):
    """(flops, bytes) K9 needs: one add per valid element, the valid rows
    of x, the lengths and the [B, F] output."""
    valid = sum(max(0, min(int(n), t)) for n in lens)
    return valid * f, 4 * (valid * f + b + b * f)


def cudnn_lstm(torch, w, b):
    """torch.nn.LSTM (cuDNN) computing fused_lstm at full lengths: input
    size 4D with an identity input projection that reorders the port's
    {candidate, input, forget, output} gates into torch's {i, f, g, o}, as
    tests/unittests/test_torch_crossval.py maps them."""
    d = w.shape[0]
    order = [1, 2, 0, 3]
    lstm = torch.nn.LSTM(input_size=4 * d, hidden_size=d, batch_first=True)
    lstm = lstm.to(w.device)
    with torch.no_grad():
        wi = torch.zeros((4 * d, 4 * d), device=w.device)
        for r, k in enumerate(order):
            wi[r * d:(r + 1) * d, k * d:(k + 1) * d] = torch.eye(
                d, device=w.device)
        lstm.weight_ih_l0.copy_(wi)
        lstm.weight_hh_l0.copy_(torch.cat(
            [w[:, k * d:(k + 1) * d].t() for k in order], dim=0))
        lstm.bias_ih_l0.copy_(torch.cat([b[k * d:(k + 1) * d]
                                         for k in order]))
        lstm.bias_hh_l0.zero_()
    return lstm


def lstm_inputs(torch, g, b, t, d, strided=False):
    """K6's inputs at one shape: w at the path's 0.1 (D = 128, as the
    serving and training checks always used) or 1.13 / sqrt(D) elsewhere,
    bias 0.1, x 0.5, h0 and c0 0.2; x either contiguous or a view [B, T,
    4D] cut at an odd offset from a wider [B, T, 4D + 12] buffer."""
    dev = torch.device("cuda")
    scale = 0.1 if d == 128 else 1.13 / d ** 0.5
    w = torch.randn((d, 4 * d), generator=g, device=dev) * scale
    bias = torch.randn((4 * d,), generator=g, device=dev) * 0.1
    if strided:
        wide = torch.randn((b, t, 4 * d + 12), generator=g, device=dev) * 0.5
        x = wide[:, :, 5:5 + 4 * d]
    else:
        x = torch.randn((b, t, 4 * d), generator=g, device=dev) * 0.5
    h0 = torch.randn((b, d), generator=g, device=dev) * 0.2
    c0 = torch.randn((b, d), generator=g, device=dev) * 0.2
    return x, w, bias, h0, c0


def direct_and_graph(torch, fn):
    """fn() launched directly, then captured in a CUDA graph (after a warm
    call on a side stream) and replayed twice: (direct, replayed)."""
    direct = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    del graph
    return direct, replayed


def lstm_check(torch, ck, what, x, w, bias, h0, c0, lens):
    """K6 against fused_lstm_plain, forward and reverse, zero and given
    h0/c0, each launched directly and replayed from a CUDA graph: the
    largest absolute error on hidden and cell; a row of length 0 must be
    exactly h0 and c0 (zeros) at every step."""
    b, t, four_d = x.shape
    lt = torch.tensor(lens, dtype=torch.int32, device=x.device)
    empty = [i for i, n in enumerate(lens) if n == 0]
    err_max = 0.0
    for reverse in (False, True):
        for state in (None, (h0, c0)):
            args = (x, w, bias) + (state or (None, None)) + (lt, reverse)
            want = ck.fused_lstm_plain(*args)
            runs = direct_and_graph(torch, lambda: ck.fused_lstm(*args))
            # absolute, on hidden and cell after up to 256 steps: each
            # step's gates differ by the rounding of a D-term product, the
            # gates are squashed and the forget gate is below 1, so the
            # carried error does not grow with T
            err = max((a - r).abs().max().item()
                      for got in runs for a, r in zip(got, want))
            for i in empty:
                hh = h0[i] if state else torch.zeros_like(h0[i])
                cc = c0[i] if state else torch.zeros_like(c0[i])
                check(all(bool((got[0][i] == hh).all())
                          and bool((got[1][i] == cc).all())
                          for got in runs),
                      "fused_lstm (%s): a length-0 row is not exactly its "
                      "initial state" % what)
            print("kernels: fused_lstm %s B=%d T=%d D=%d reverse=%s "
                  "h0/c0=%s max_abs_err=%.3e (direct and CUDA graph)"
                  % (what, b, t, four_d // 4, reverse,
                     "given" if state else "zero", err))
            check(np.isfinite(err) and err <= KERNEL_TOL,
                  "fused_lstm (%s) disagrees with its plain version by %r "
                  "(tolerance %r)" % (what, err, KERNEL_TOL))
            err_max = max(err_max, err)
    return err_max


def baseline_lstm(torch, ck, source, build_dir):
    """The K6 of commit K6_BASELINE_COMMIT (one block per batch row, W from
    L2) built from `source`: a function with fused_lstm's signature and no
    launch count (it is on no path)."""
    import ctypes
    lib = build_baseline(ck, source, build_dir, "ptt_lstm_baseline", "K6")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ptt_fused_lstm_fwd.argtypes = [P, L, L] + [P] * 7 + [I] * 4 + [P]
    lib.ptt_fused_lstm_fwd.restype = I

    def run(x, w, bias, h0, c0, lens, reverse=False):
        b, t, four_d = x.shape
        d = four_d // 4
        hidden = torch.empty((b, t, d), dtype=torch.float32, device=x.device)
        cell = torch.empty_like(hidden)
        err = lib.ptt_fused_lstm_fwd(
            x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(),
            bias.data_ptr(), h0.data_ptr() if h0 is not None else None,
            c0.data_ptr() if c0 is not None else None,
            lens.data_ptr() if lens is not None else None, hidden.data_ptr(),
            cell.data_ptr(), b, t, d, int(reverse), ck._stream_of(x))
        check(err == 0, "the baseline K6 failed to launch (cudaError %d)"
              % err)
        return hidden, cell
    return run


def run_sequence_kernels(torch, ck, peak_flops, peak_bw, k6_source=None):
    """K6 against its plain version at the sequence path's shapes, and
    timed (kernel, plain, library) beside its bound; also at the other
    batch buckets, T = 1, a length-0 row, D 1, 37, 100
    and 512 (streamed W), x strided, each direct and from a CUDA graph,
    and timed beside the K6 of commit K6_BASELINE_COMMIT and the step
    floor (k6_ablation.py's "floor" variant: only the exchange of h and
    the cluster barrier of each step)."""
    import k6_ablation
    dev = torch.device("cuda")

    def plan_of(b, dd):
        return k6_ablation.describe(ck.lstm_plan_on_card(ck.build(), b, dd,
                                                         dev))

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    rng = np.random.RandomState(SEED + 2)
    results = {}

    def ragged(b, t, empty=False):
        lens = rng.randint(1, t + 1, size=b)
        lens[0], lens[-1] = t, 1
        if empty:
            lens[1] = 0
        return lens.tolist()

    # K6: a serving dispatch of the stacked LSTM (batch bucket 8, seq
    # bucket 256) and a training step (batch 128, T 64), both at h = 128,
    # then the other shapes the lstm rule sends it
    d = SENTIMENT["lstm_hid"] // 4
    lstm_cases = [(8, 256, ragged(8, 256)),
                  (SEQ_TRAIN["batch"], SEQ_TRAIN["seq"],
                   ragged(SEQ_TRAIN["batch"], SEQ_TRAIN["seq"]))]
    for b, t, _ in lstm_cases:
        print("kernels: fused_lstm launch plan at B=%d D=%d: %s"
              % (b, d, plan_of(b, d)))
    lstm_err = 0.0
    for what, (b, t, dd, lens, strided) in (
            ("B=1", (1, 64, d, [64], False)),
            ("B=4", (4, 128, d, ragged(4, 128), False)),
            ("T=1", (8, 1, d, [1] * 8, False)),
            ("a length-0 row", (8, 32, d, ragged(8, 32, True), False)),
            ("D=1", (4, 16, 1, ragged(4, 16, True), False)),
            ("D=37", (4, 16, 37, ragged(4, 16), False)),
            ("D=100", (4, 16, 100, ragged(4, 16), False)),
            ("D=512 (W streamed)", (8, 16, 512, ragged(8, 16), False)),
            ("x strided", (8, 32, d, ragged(8, 32), True))):
        inputs = lstm_inputs(torch, g, b, t, dd, strided)
        if dd != d:
            print("kernels: fused_lstm launch plan at B=%d D=%d: %s"
                  % (b, dd, plan_of(b, dd)))
        lstm_err = max(lstm_err, lstm_check(torch, ck, what, *inputs, lens))
        del inputs
    # every cluster size under plans pinned as k6_ablation.py sweeps them
    # (the default plan picks one size per shape)
    x, w, bias, h0, c0 = lstm_inputs(torch, g, 8, 32, d)
    lens = ragged(8, 32, True)
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    want = ck.fused_lstm_plain(x, w, bias, h0, c0, lt, True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for cs, rows in ((1, 8), (2, 2), (4, 4), (8, 1), (16, 2), (16, 8)):
        plan = ck.lstm_launch_plan(8, d, sms, cs=cs, rows=rows)
        got = ck._launch_lstm(ck.build(), plan, x, w, bias, h0, c0, lt,
                              True)
        torch.cuda.synchronize()
        err = max((a - r).abs().max().item() for a, r in zip(got, want))
        print("kernels: fused_lstm pinned plan %s B=8 T=32 reverse h0/c0 "
              "given max_abs_err=%.3e" % (k6_ablation.describe(plan), err))
        check(np.isfinite(err) and err <= KERNEL_TOL
              and bool((got[0][1] == h0[1]).all()),
              "fused_lstm under the pinned plan %s disagrees with its plain "
              "version by %r" % (k6_ablation.describe(plan), err))
        lstm_err = max(lstm_err, err)
    del x, w, bias, h0, c0, got, want
    base = None
    build_dir = tempfile.mkdtemp(prefix="ptt_k6_baseline_")
    if k6_source is not None:
        t0 = time.perf_counter()
        base = baseline_lstm(torch, ck, k6_source, build_dir)
        print("kernels: built the baseline fused_lstm (%s) in %.1f s"
              % (K6_BASELINE_COMMIT, time.perf_counter() - t0))
    else:
        print("kernels: the baseline fused_lstm source is not at hand; its "
              "time is not measured")
    floor_lib = k6_ablation.floor_lib(ck, build_dir)
    timing = {}
    for b, t, lens in lstm_cases:
        x, w, bias, h0, c0 = lstm_inputs(torch, g, b, t, d)
        lstm_err = max(lstm_err, lstm_check(torch, ck, "path shape", x, w,
                                            bias, h0, c0, lens))
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        if base is not None:
            got = base(x, w, bias, h0, c0, lt, True)
            want = ck.fused_lstm_plain(x, w, bias, h0, c0, lt, True)
            torch.cuda.synchronize()
            print("kernels: the baseline fused_lstm B=%d agrees with the "
                  "plain version to %.3e"
                  % (b, max((a - r).abs().max().item()
                            for a, r in zip(got, want))))
            del got, want
        full = torch.full((b,), t, dtype=torch.int32, device=dev)
        ref = cudnn_lstm(torch, w, bias)
        with torch.no_grad():
            lib_out, _ = ref(x)
            mine, _ = ck.fused_lstm(x, w, bias, None, None, full)
        torch.cuda.synchronize()
        lib_err = (lib_out - mine).abs().max().item()
        print("kernels: fused_lstm B=%d T=%d vs cuDNN LSTM at full lengths: "
              "max_abs_diff=%.3e" % (b, t, lib_err))

        def lib_call(ref=ref, x=x):
            with torch.no_grad():
                return ref(x)

        runs = {"new": [], "old": []}
        # in turns, old new new old, so that drift shows
        for order in ("old", "new", "new", "old"):
            fn = ck.fused_lstm if order == "new" else base
            if fn is not None:
                runs[order].append(time_ms(
                    torch, lambda fn=fn: fn(x, w, bias, None, None, lt)))
        floor = k6_ablation.step_floor_ms(torch, ck, floor_lib, x, w, bias,
                                          full, time_ms)
        flops, nbytes = lstm_work(lens, t, d, b, False)
        bms, bby = bound(flops, nbytes, peak_flops, peak_bw)
        timing[(b, t)] = {
            "ms": statistics.mean(runs["new"]), "runs": runs["new"],
            "baseline_ms": statistics.mean(runs["old"]) if base else None,
            "baseline_runs": runs["old"],
            "plain_ms": time_ms(torch, lambda: ck.fused_lstm_plain(
                x, w, bias, None, None, lt), iters=2, reps=3),
            # a CUDA graph like the kernel's: device time, no launch cost
            "library_ms": time_ms(torch, lib_call),
            "bound_ms": bms, "bound_by": bby, "floor_ms": floor,
            "lens": lens, "cudnn_max_abs_diff": lib_err,
            "plan": plan_of(b, d)}
        tm = timing[(b, t)]
        print("kernels: fused_lstm timing x [%d,%d,%d]: new %s ms; baseline "
              "%s ms; plain %.4f ms; cuDNN %.4f ms; bound %.4f ms (%s); step "
              "floor %.4f ms (%.3f us a step)"
              % (b, t, 4 * d, " / ".join("%.4f" % v for v in runs["new"]),
                 " / ".join("%.4f" % v for v in runs["old"])
                 or "not measured", tm["plain_ms"], tm["library_ms"], bms,
                 bby, floor, floor * 1e3 / t))
        del x, ref
    shutil.rmtree(build_dir, ignore_errors=True)
    (sb, st), (tb, tt) = [(b, t) for b, t, _ in lstm_cases]
    serve, train = timing[(sb, st)], timing[(tb, tt)]
    results["fused_lstm"] = {
        "name": "fused_lstm", "route": "cuda", "source": LSTM_SRC,
        "replaces": LSTM_TPU,
        "shape": "x [%d,%d,%d] fp32, h=%d, lens %s" % (
            sb, st, 4 * d, d, serve["lens"]),
        "max_abs_err": lstm_err,
        "ms": serve["ms"], "plain_ms": serve["plain_ms"],
        "library_ms": serve["library_ms"],
        "library_covers": "torch.nn.LSTM (cuDNN) at full lengths, identity "
                          "input projection, in a CUDA graph",
        "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
        "baseline_ms": serve["baseline_ms"], "floor_ms": serve["floor_ms"],
        "plan": serve["plan"],
        "train_shape": "x [%d,%d,%d]" % (tb, tt, 4 * d),
        "train_ms": train["ms"], "train_plain_ms": train["plain_ms"],
        "train_library_ms": train["library_ms"],
        "train_bound_ms": train["bound_ms"],
        "train_baseline_ms": train["baseline_ms"],
        "train_floor_ms": train["floor_ms"], "train_plan": train["plan"],
        "cudnn_max_abs_diff": max(serve["cudnn_max_abs_diff"],
                                  train["cudnn_max_abs_diff"]),
    }

    for r in results.values():
        print("kernels: %s ms=%.4f plain_ms=%.4f library_ms=%.4f "
              "bound_ms=%.4f (%s)" % (r["name"], r["ms"], r["plain_ms"],
                                      r["library_ms"], r["bound_ms"],
                                      r["bound_by"]))
    print("kernels: fused_lstm at %s ms=%.4f plain_ms=%.4f library_ms=%.4f "
          "bound_ms=%.4f" % (results["fused_lstm"]["train_shape"],
                             train["ms"], train["plain_ms"],
                             train["library_ms"], train["bound_ms"]))
    return results


def pool_registers(log):
    """Registers and spill bytes of both K9 instantiations
    (masked_pool_fwd_kernel<VEC>, VEC 1 and 4) from nvcc's `ptxas -v`
    lines; fails on a spill."""
    import re
    name, found = None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+?)'", line)
        if m:
            kind = re.search(r"masked_pool_fwd_kernelILi(\d+)E", m.group(1))
            name = kind and "masked_pool_fwd_kernel<%s>" % kind.group(1)
            if name:
                found.append([name, None, None])
            continue
        if not name or found[-1][1] is not None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found[-1][2] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[-1][1] = int(m.group(1))
    for kname, regs, spill in found:
        print("ptxas: %s: %s registers, %s bytes spilled" % (kname, regs,
                                                              spill))
    check(len(found) == 2, "ptxas: expected the register lines of 2 K9 "
          "kernels, found %d" % len(found))
    check(all(spill == 0 for _, _, spill in found), "a K9 kernel spills "
          "registers")


def pool_plans(ck, x):
    """{name: plan}: K9's plan for x on this card pinned to every cluster
    size."""
    return {"CS=%d" % cs: ck.pool_plan_of(x, cs=cs)
            for cs in ck.POOL_CLUSTERS}


def pool_case(torch, ck, what, x, lens):
    """K9 against masked_pool_plain on x and lens (int32 on the card) in
    every pool type: through the wrapper, and launched under each plan of
    pool_plans twice (the two runs must give the same bits). Checks every
    result within KERNEL_TOL and every row of length <= 0 exactly 0.
    Returns the largest error."""
    import k9_ablation
    lib = ck.build()
    b, _, f = x.shape
    plans = pool_plans(ck, x)
    err = 0.0
    for ptype in ck.POOL_TYPES:
        want = ck.masked_pool_plain(x, lens, ptype)
        got = {"wrapper": ck.masked_pool(x, lens, ptype)}
        for name, plan in plans.items():
            got[name] = [ck._launch_pool(
                lib, plan, x, lens, ptype,
                torch.empty((b, f), dtype=torch.float32, device=x.device))
                for _ in range(2)]
        torch.cuda.synchronize()
        for name, outs in got.items():
            outs = outs if isinstance(outs, list) else [outs]
            check(all(torch.equal(outs[0], o) for o in outs[1:]),
                  "masked_pool %s %s: two runs of one plan differ"
                  % (what, name))
            e = (outs[0] - want).abs().max().item()
            check(np.isfinite(e) and e <= KERNEL_TOL,
                  "masked_pool %s %s %s disagrees with its plain version by "
                  "%r" % (what, ptype, name, e))
            check(bool((outs[0][lens <= 0] == 0).all()),
                  "masked_pool %s %s: a row of length <= 0 is not exactly 0"
                  % (what, name))
            err = max(err, e)
    print("kernels: masked_pool %s x %s strides %s, plan %s, every pool type "
          "and plans %s (twice each, same bits): max_abs_err=%.3e"
          % (what, list(x.shape), list(x.stride()),
             k9_ablation.describe(ck.pool_plan_of(x)),
             ", ".join(plans), err))
    return err


def run_pool_kernels(torch, ck, peak_flops, peak_bw, k9_source=None):
    """K9 against its plain version: every pool type at the timing shapes
    (k9_ablation.SHAPES: the conv net's serving x [8, 256, 32], a wide
    [128, 256, 512], a long [4, 4096, 512]), at B = 70000 (fault C6), T =
    1, F = 3 and an unaligned x (4-byte loads), a strided x (time stride
    2F), lengths 0, negative and over T among them, each under every
    pinned cluster size, and replayed from a CUDA graph. Timed beside the launch floor (an empty kernel),
    the K9 of commit K9_BASELINE_COMMIT in turns with it, x.sum(1) and the
    plain version; the wide shape also cold (calls rotating over copies
    of x beyond L2)."""
    import k9_ablation
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 9)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 9)
    err = 0.0
    for what, b, t, f in k9_ablation.SHAPES:
        xs, lens = k9_ablation.case_inputs(torch, b, t, f)
        err = max(err, pool_case(torch, ck, what, xs[0], lens))
        del xs

    def edge_lens(b, t):
        lens = rng.randint(0, t + 3, size=b)
        lens[:4] = [t, 0, -3, t + 5][:b] if b >= 4 else lens[:4]
        return torch.tensor(lens, dtype=torch.int32, device=dev)

    # (what, x): C6's batch, T = 1, the scalar path, a strided x
    wide_base = torch.randn((8, 40, 65), generator=g, device=dev)
    strided_base = torch.randn((8, 40, 128), generator=g, device=dev)
    for what, x in (
            ("B=70000 (C6)", torch.randn((70000, 8, 32), generator=g,
                                         device=dev)),
            ("T=1", torch.randn((16, 1, 64), generator=g, device=dev)),
            ("F=3", torch.randn((8, 40, 3), generator=g, device=dev)),
            ("unaligned", wide_base[..., 1:]),
            ("strided", strided_base[..., :64])):
        err = max(err, pool_case(torch, ck, what, x,
                                 edge_lens(x.shape[0], x.shape[1])))
    # a CUDA graph: the wrapper captured, replayed twice
    xs, lens = k9_ablation.case_inputs(torch, *k9_ablation.SHAPES[0][1:])
    want = ck.masked_pool_plain(xs[0], lens, "SQRT")
    runs = direct_and_graph(torch, lambda: ck.masked_pool(xs[0], lens,
                                                          "SQRT"))
    e = max((r - want).abs().max().item() for r in runs)
    print("kernels: masked_pool serving SQRT direct and from a CUDA graph: "
          "max_abs_err=%.3e" % e)
    check(np.isfinite(e) and e <= KERNEL_TOL, "masked_pool in a CUDA graph "
          "disagrees with its plain version by %r" % e)
    err = max(err, e)

    build_dir = tempfile.mkdtemp(prefix="ptt_k9_baseline_")
    base = None
    if k9_source is not None:
        t0 = time.perf_counter()
        base = k9_ablation.baseline_pool(torch, ck, build_baseline(
            ck, k9_source, build_dir, "ptt_pool_baseline", "K9"))
        print("kernels: built the baseline masked_pool (%s) in %.1f s"
              % (K9_BASELINE_COMMIT, time.perf_counter() - t0))
    else:
        print("kernels: the baseline masked_pool source is not at hand; its "
              "time is not measured")
    empty = k9_ablation.empty_lib(ck, build_dir)
    floor = time_ms(torch, k9_ablation.launch_floor(torch, ck, empty,
                                                    xs[0]))
    print("launch floor: an empty kernel (1 block of 256 threads) %.4f ms in "
          "a CUDA graph of 20" % floor)
    timing = {}
    for what, b, t, f in k9_ablation.SHAPES:
        cold_n = k9_ablation.cold_copies(b, t, f) if what == "wide" else 1
        xs, lens = k9_ablation.case_inputs(torch, b, t, f, copies=cold_n)
        x = xs[0]
        fns = {"new": lambda c: ck.masked_pool(c, lens, "SQRT"),
               "old": base and (lambda c: base(c, lens, "SQRT")),
               "x.sum(1)": lambda c: c.sum(1)}
        tm = {"new": [], "old": [], "x.sum(1)": []}
        cold = {"new": [], "old": [], "x.sum(1)": []}
        for order in ("old", "new", "x.sum(1)", "new", "old", "x.sum(1)"):
            fn = fns[order]
            if fn is None:
                continue
            tm[order].append(time_ms(torch, lambda fn=fn: fn(x)))
            if cold_n > 1:
                cold[order].append(k9_ablation.rotating_ms(
                    torch, [lambda fn=fn, c=c: fn(c) for c in xs]))
        flops, nbytes = pool_work(lens.tolist(), t, f, b)
        bms, bby = bound(flops, nbytes, peak_flops, peak_bw)

        def mean(v):
            return statistics.mean(v) if v else None
        timing[what] = {
            "shape": "x [%d,%d,%d] fp32, SQRT" % (b, t, f),
            "ms": mean(tm["new"]), "runs": tm["new"],
            "baseline_ms": mean(tm["old"]), "baseline_runs": tm["old"],
            "library_ms": mean(tm["x.sum(1)"]),
            "cold_ms": mean(cold["new"]),
            "cold_baseline_ms": mean(cold["old"]),
            "cold_library_ms": mean(cold["x.sum(1)"]),
            "plain_ms": time_ms(torch, lambda: ck.masked_pool_plain(
                x, lens, "SQRT")),
            "bound_ms": bms, "bound_by": bby,
            "plan": k9_ablation.describe(ck.pool_plan_of(x)),
            "lens": lens.tolist()}
        r = timing[what]

        def ms(v):
            return " / ".join("%.4f" % u for u in v) + " ms" if v \
                else "not measured"
        print("kernels: masked_pool timing %s x [%d,%d,%d] SQRT, plan %s: new "
              "%s%s; old %s%s; x.sum(1) %s%s; plain %.4f ms; bound %.5f ms "
              "(%s); launch floor %.4f ms"
              % (what, b, t, f, r["plan"], ms(tm["new"]),
                 " (cold %s)" % ms(cold["new"]) if cold_n > 1 else "",
                 ms(tm["old"]),
                 " (cold %s)" % ms(cold["old"]) if cold_n > 1 else "",
                 ms(tm["x.sum(1)"]),
                 " (cold %s)" % ms(cold["x.sum(1)"]) if cold_n > 1 else "",
                 r["plain_ms"], bms, bby, floor))
        del xs, x
    shutil.rmtree(build_dir, ignore_errors=True)
    # the recommender's title pool: x [256, 8, 32] (batch 256, titles of
    # 1-5 words padded to 8 steps), SUM
    x = torch.randn((REC["batch"], 8, REC["emb"]), generator=g, device=dev)
    lens = torch.tensor(rng.randint(1, 6, REC["batch"]), dtype=torch.int32,
                        device=dev)
    err = max(err, pool_case(torch, ck, "recommender", x, lens))
    flops, nbytes = pool_work(lens.tolist(), 8, REC["emb"], REC["batch"])
    rec = {"shape": "x [%d,8,%d] fp32, SUM, lens 1-5" % (REC["batch"],
                                                          REC["emb"]),
           "ms": time_ms(torch, lambda: ck.masked_pool(x, lens, "SUM")),
           "library_ms": time_ms(torch, lambda: x.sum(1)),
           "plain_ms": time_ms(torch, lambda: ck.masked_pool_plain(
               x, lens, "SUM"))}
    rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, peak_flops,
                                             peak_bw)
    print("kernels: masked_pool timing recommender %s: %.4f ms; x.sum(1) "
          "%.4f ms; plain %.4f ms; bound %.5f ms (%s)"
          % (rec["shape"], rec["ms"], rec["library_ms"], rec["plain_ms"],
             rec["bound_ms"], rec["bound_by"]))
    serve, wide, long_ = (timing[w] for w, *_ in k9_ablation.SHAPES)
    return {"masked_pool": {
        "name": "masked_pool", "route": "cuda", "source": POOL_SRC,
        "replaces": POOL_TPU,
        "shape": serve["shape"] + ", lens %s" % serve["lens"],
        "max_abs_err": err,
        "ms": serve["ms"], "plain_ms": serve["plain_ms"],
        "library_ms": serve["library_ms"],
        "library_covers": "x.sum(1) at full lengths",
        "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
        "baseline_ms": serve["baseline_ms"], "floor_ms": floor,
        "plan": serve["plan"],
        **{"%s_%s" % (w, k): r[k] for w, r in (("wide", wide),
                                               ("long", long_))
           for k in ("shape", "ms", "cold_ms", "plain_ms", "library_ms",
                     "cold_library_ms", "bound_ms", "baseline_ms",
                     "cold_baseline_ms", "plan")},
        **{"recommender_" + k: v for k, v in rec.items()},
    }}


def run_flash_grid_check(torch, ck):
    """Fault C7: K1, K2 and K3 at B * H = 65544 (B = 8193, H = 8, T = 16,
    D = 64, one kv_len-0 row) against their plain versions, direct and
    from a CUDA graph (flash_fwd_case, flash_bwd_case)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 10)
    b, t, h, d = 8193, 16, 8, 64
    q, k, v, g_out = (torch.randn((b, t, h, d), generator=g, device=dev)
                      for _ in range(4))
    kv_len = torch.randint(1, t + 1, (b,), generator=g, device=dev,
                           dtype=torch.int32)
    kv_len[1] = 0
    e_fwd = flash_fwd_case(torch, ck, q, k, v, kv_len, False)
    e_kv, e_q = flash_bwd_case(torch, ck, q, k, v, g_out, kv_len, False)
    print("kernels: flash at B*H = %d (C7) q [%d,%d,%d,%d]: forward "
          "max_abs_err=%.3e, dK/dV %.3e, dQ %.3e (relative; direct and CUDA "
          "graph)" % (b * h, b, t, h, d, e_fwd, e_kv, e_q))


def softmax_work(lens, t, n):
    """(flops, bytes) K8 needs: per valid element a max, a subtraction, an
    exp, an add and a division; the valid steps of x, the full [N, T]
    output and the lengths."""
    valid = sum(max(0, min(int(v), t)) for v in lens)
    return 5 * valid, 4 * (valid + n * t + n)


def baseline_softmax(torch, ck, source, build_dir):
    """The K8 of commit K8_BASELINE_COMMIT (three walks over each row)
    built from `source`: a function with masked_softmax's signature and
    no launch count (it is on no path)."""
    import ctypes
    lib = build_baseline(ck, source, build_dir, "ptt_softmax_baseline", "K8")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ptt_masked_softmax_fwd.argtypes = [P, L, P, P, I, I, P]
    lib.ptt_masked_softmax_fwd.restype = I

    def run(x, lens):
        n, t = x.shape
        y = torch.empty((n, t), dtype=torch.float32, device=x.device)
        err = lib.ptt_masked_softmax_fwd(x.data_ptr(), x.stride(0),
                                         lens.data_ptr(), y.data_ptr(), n, t,
                                         ck._stream_of(x))
        check(err == 0, "the baseline K8 failed to launch (cudaError %d)"
              % err)
        return y
    return run


def run_translation_kernels(torch, ck, peak_flops, peak_bw, k8_source=None):
    """K8 against its plain version at the translator's decoder-step shape
    x [16, 48], a wide [2048, 256], rows of 1023 steps and of 3000 (above
    the registers' 1024: the online pass), and rows whose stride is not a
    multiple of 4 (scalar loads), lengths 0, 1 and T among them, each
    launched directly and from a CUDA graph; a length-0 row exactly 0.
    Timed at the first two (kernel, the K8 of commit K8_BASELINE_COMMIT in
    turns with it, plain, library) beside its bound."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 5)
    rng = np.random.RandomState(SEED + 5)

    def case_lens(n, t):
        lens = rng.randint(1, t + 1, size=n)
        lens[0], lens[-1], lens[1] = t, 1, 0
        return lens.tolist()

    err_max = 0.0
    # (what, rows, steps, row stride)
    for what, n, t, stride in (
            ("translator step", MT["batch"], MT["max_len"], MT["max_len"]),
            ("wide", 2048, 256, 256), ("T=1023", 64, 1023, 1023),
            ("T=3000 (online pass)", 64, 3000, 3000),
            ("row stride 51", MT["batch"], MT["max_len"], 51),
            ("row stride 259", 64, 256, 259)):
        # attention scores: products of 512-wide states, a few units large
        x = (torch.randn((n, stride), generator=g, device=dev) * 3)[:, :t]
        lens = case_lens(n, t)
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        want = ck.masked_softmax_plain(x, lt)
        runs = direct_and_graph(torch, lambda: ck.masked_softmax(x, lt))
        err = max((got - want).abs().max().item() for got in runs)
        print("kernels: masked_softmax %s N=%d T=%d row stride %d "
              "max_abs_err=%.3e (direct and CUDA graph)"
              % (what, n, t, x.stride(0), err))
        check(np.isfinite(err) and err <= KERNEL_TOL,
              "masked_softmax disagrees with its plain version by %r "
              "(tolerance %r)" % (err, KERNEL_TOL))
        check(all(bool((got[lt == 0] == 0).all()) for got in runs),
              "masked_softmax: a length-0 row is not all 0")
        err_max = max(err_max, err)

    base = None
    build_dir = tempfile.mkdtemp(prefix="ptt_k8_baseline_")
    if k8_source is not None:
        t0 = time.perf_counter()
        base = baseline_softmax(torch, ck, k8_source, build_dir)
        print("kernels: built the baseline masked_softmax (%s) in %.1f s"
              % (K8_BASELINE_COMMIT, time.perf_counter() - t0))
    else:
        print("kernels: the baseline masked_softmax source is not at hand; "
              "its time is not measured")
    # (rows, steps, a length-0 row among them)
    cases = [(MT["batch"], MT["max_len"], False), (2048, 256, True)]
    timing = {}
    for n, t, empty_row in cases:
        lens = rng.randint(1, t + 1, size=n)
        lens[0], lens[-1] = t, 1
        if empty_row:
            lens[1] = 0
        lens = lens.tolist()
        x = torch.randn((n, t), generator=g, device=dev) * 3
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        if base is not None:
            got = base(x, lt)
            torch.cuda.synchronize()
            print("kernels: the baseline masked_softmax N=%d T=%d agrees "
                  "with the plain version to %.3e" % (n, t, (
                      got - ck.masked_softmax_plain(x, lt)).abs().max()
                      .item()))
        runs = {"new": [], "old": []}
        for order in ("old", "new", "new", "old"):
            fn = ck.masked_softmax if order == "new" else base
            if fn is not None:
                runs[order].append(time_ms(torch, lambda fn=fn: fn(x, lt)))
        flops, nbytes = softmax_work(lens, t, n)
        bms, bby = bound(flops, nbytes, peak_flops, peak_bw)
        timing[(n, t)] = {
            "ms": statistics.mean(runs["new"]), "runs": runs["new"],
            "baseline_ms": statistics.mean(runs["old"]) if base else None,
            "baseline_runs": runs["old"],
            "plain_ms": time_ms(torch,
                                lambda: ck.masked_softmax_plain(x, lt)),
            "library_ms": time_ms(torch, lambda: torch.softmax(x, 1)),
            "bound_ms": bms, "bound_by": bby, "lens": lens}
        tm = timing[(n, t)]
        print("kernels: masked_softmax timing x [%d,%d]: new %s ms; baseline "
              "%s ms; plain %.4f ms; torch.softmax %.4f ms; bound %.5f ms "
              "(%s)" % (n, t, " / ".join("%.4f" % v for v in runs["new"]),
                        " / ".join("%.4f" % v for v in runs["old"])
                        or "not measured", tm["plain_ms"], tm["library_ms"],
                        bms, bby))
    shutil.rmtree(build_dir, ignore_errors=True)
    (pn, pt, _), (wn, wt, _) = cases
    path, wide = timing[(pn, pt)], timing[(wn, wt)]
    r = {
        "name": "masked_softmax", "route": "cuda", "source": SOFTMAX_SRC,
        "replaces": SOFTMAX_TPU,
        "shape": "x [%d,%d] fp32, lens %s" % (pn, pt, path["lens"]),
        "max_abs_err": err_max,
        "ms": path["ms"], "plain_ms": path["plain_ms"],
        "library_ms": path["library_ms"],
        "library_covers": "torch.softmax(x, 1) at full lengths",
        "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
        "baseline_ms": path["baseline_ms"],
        "wide_shape": "x [%d,%d]" % (wn, wt),
        "wide_ms": wide["ms"], "wide_plain_ms": wide["plain_ms"],
        "wide_library_ms": wide["library_ms"],
        "wide_bound_ms": wide["bound_ms"],
        "wide_baseline_ms": wide["baseline_ms"],
    }

    def opt(v):
        return "not measured" if v is None else "%.4f" % v

    print("kernels: masked_softmax ms=%.4f baseline_ms=%s plain_ms=%.4f "
          "library_ms=%.4f bound_ms=%.5f (%s); at %s ms=%.4f baseline_ms=%s "
          "plain_ms=%.4f library_ms=%.4f bound_ms=%.5f"
          % (r["ms"], opt(r["baseline_ms"]), r["plain_ms"], r["library_ms"],
             r["bound_ms"], r["bound_by"], r["wide_shape"], wide["ms"],
             opt(wide["baseline_ms"]), wide["plain_ms"], wide["library_ms"],
             wide["bound_ms"]))
    return {"masked_softmax": r}


def lstmp_work(lens, t, d, p, b, with_state):
    """(flops, bytes) K7 needs for these lengths: per valid (row, step)
    the two products, 2 * (P * 4D + D * P) flops (the ~20 * D
    elementwise operations are under 1% of it), and the row of x it
    reads; W, W_proj, the bias, the lengths, r0/c0 when given and the
    full [B, T, P] projection and [B, T, D] cell outputs, each once."""
    valid = sum(max(0, min(int(n), t)) for n in lens)
    flops = valid * 2 * (p * 4 * d + d * p)
    nbytes = 4 * (valid * 4 * d + p * 4 * d + d * p + 4 * d + b
                  + (b * (p + d) if with_state else 0) + b * t * (p + d))
    return flops, nbytes


def lstmp_inputs(torch, g, b, t, d, p):
    """K7's inputs at one shape: weights at the scale of a Xavier init
    (the gates stay unsaturated), x [B, T, 4D], r0 [B, P], c0 [B, D]."""
    dev = torch.device("cuda")
    w = torch.randn((p, 4 * d), generator=g, device=dev) * (1.13 / p ** 0.5)
    wp = torch.randn((d, p), generator=g, device=dev) * (1.28 / d ** 0.5)
    bias = torch.randn((4 * d,), generator=g, device=dev) * 0.1
    x = torch.randn((b, t, 4 * d), generator=g, device=dev) * 0.5
    r0 = torch.tanh(torch.randn((b, p), generator=g, device=dev) * 0.3)
    c0 = torch.randn((b, d), generator=g, device=dev) * 0.2
    return x, w, wp, bias, r0, c0


def lstmp_check(torch, ck, what, x, w, wp, bias, r0, c0, lens):
    """K7 against its plain version, forward and reverse, zero and given
    r0/c0: the largest absolute error on projection and cell."""
    b, t = x.shape[:2]
    lt = torch.tensor(lens, dtype=torch.int32, device=x.device)
    err_max = 0.0
    for reverse in (False, True):
        for state in (None, (r0, c0)):
            args = (x, w, wp, bias) + (state or (None, None)) + (lt, reverse)
            got = ck.fused_lstmp(*args)
            want = ck.fused_lstmp_plain(*args)
            torch.cuda.synchronize()
            # absolute, on projection and cell after up to 512 steps: each
            # step's gates differ by the rounding of a P-term product and
            # the projection's by a D-term one; the gates squash and the
            # forget gate is below 1, so the carried error does not grow
            # with T
            err = max((a - r).abs().max().item() for a, r in zip(got, want))
            print("kernels: fused_lstmp %s B=%d T=%d D=%d P=%d reverse=%s "
                  "r0/c0=%s max_abs_err=%.3e"
                  % (what, b, t, w.shape[1] // 4, wp.shape[1], reverse,
                     "given" if state else "zero", err))
            check(np.isfinite(err) and err <= KERNEL_TOL,
                  "fused_lstmp (%s) disagrees with its plain version by %r "
                  "(tolerance %r)" % (what, err, KERNEL_TOL))
            err_max = max(err_max, err)
    return err_max


def lstmp_graph_check(torch, ck, x, w, wp, bias, r0, c0, lens):
    """K7 captured in a CUDA graph (as time_ms captures it: a cooperative
    launch must capture) and replayed, against its plain version."""
    lt = torch.tensor(lens, dtype=torch.int32, device=x.device)
    args = (x, w, wp, bias, r0, c0, lt, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ck.fused_lstmp(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ck.fused_lstmp(*args)
    graph.replay()
    graph.replay()
    want = ck.fused_lstmp_plain(*args)
    torch.cuda.synchronize()
    err = max((a - r).abs().max().item() for a, r in zip(got, want))
    print("kernels: fused_lstmp in a CUDA graph B=%d T=%d reverse r0/c0 "
          "given max_abs_err=%.3e" % (x.shape[0], x.shape[1], err))
    check(np.isfinite(err) and err <= KERNEL_TOL,
          "fused_lstmp replayed from a CUDA graph disagrees with its plain "
          "version by %r" % err)
    del graph
    return err


def baseline_source(path, commit, src):
    """An earlier kernel's source to time beside the current one: `path`
    when given, else `git show commit:src` when the checkout has its
    history, else None (not measured)."""
    if path:
        with open(path) as f:
            return f.read()
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, ".git")):
        return None
    out = subprocess.run(["git", "-C", here, "show", "%s:%s" % (commit, src)],
                         capture_output=True, text=True, timeout=60)
    return out.stdout if out.returncode == 0 else None


def build_baseline(ck, source, build_dir, stem, what):
    """Compile an earlier kernel's source into build_dir/lib<stem>.so,
    outside the package, and load it (its C entry points keep their
    names; ctypes loads it apart from the package's library)."""
    import ctypes
    src = os.path.join(build_dir, stem + ".cu")
    lib_path = os.path.join(build_dir, "lib%s.so" % stem)
    with open(src, "w") as f:
        f.write(source)
    out = subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-shared", src, "-o",
                          lib_path], capture_output=True, text=True,
                         timeout=600)
    check(out.returncode == 0, "nvcc failed for the baseline %s:\n%s%s"
          % (what, out.stdout, out.stderr))
    return ctypes.CDLL(lib_path)


def baseline_lstmp(torch, ck, source, build_dir):
    """Build the baseline K7 (one block per batch row) into build_dir, outside
    the package, and return a function with fused_lstmp's signature that
    launches it (no launch count: it is not on any path)."""
    import ctypes
    lib = build_baseline(ck, source, build_dir, "ptt_lstmp_baseline", "K7")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ptt_fused_lstmp_fwd.argtypes = [P, L, L] + [P] * 8 + [I] * 5 + [P]
    lib.ptt_fused_lstmp_fwd.restype = I

    def run(x, w, wp, bias, r0, c0, lens, reverse=False):
        b, t, four_d = x.shape
        d, p = four_d // 4, wp.shape[1]
        proj = torch.empty((b, t, p), dtype=torch.float32, device=x.device)
        cell = torch.empty((b, t, d), dtype=torch.float32, device=x.device)
        err = lib.ptt_fused_lstmp_fwd(
            x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(),
            wp.data_ptr(), bias.data_ptr(),
            r0.data_ptr() if r0 is not None else None,
            c0.data_ptr() if c0 is not None else None,
            lens.data_ptr() if lens is not None else None,
            proj.data_ptr(), cell.data_ptr(), b, t, d, p, int(reverse),
            ck._stream_of(x))
        check(err == 0, "the baseline K7 failed to launch (cudaError %d)"
              % err)
        return proj, cell
    return run


def run_acoustic_kernels(torch, ck, peak_flops, peak_bw,
                         k7_source=None):
    """K7 against its plain version, forward and reverse, zero and given
    r0/c0, ragged lengths with 1 and T: at the acoustic path's shapes (a
    serving dispatch x [8, 512, 4096], a training step's [32, 512, 4096];
    D 1024, P 512), at B = 1, at T = 1, at D 1000 / P 500 (slices not
    multiples of the grid), at the card-vs-CPU step's hidden 8 / proj 4,
    with weights too wide to stay in shared memory and with a batch too
    large for the x prefetch, and replayed from a CUDA graph. Timed
    (kernel, the baseline K7 when its source is at hand, plain, library)
    beside its bound at the two path shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    rng = np.random.RandomState(SEED + 7)
    d, p, t = ASR["hidden"], ASR["proj"], ASR_SEQ_BUCKETS[-1]
    print("kernels: fused_lstmp launch plan at B=8 %s; at B=%d %s" % (
        {k: v for k, v in ck.lstmp_launch_plan(
            8, d, p, torch.cuda.get_device_properties(
                0).multi_processor_count).items()
         if k not in ("units", "cols")}, ASR["batch"],
        {k: v for k, v in ck.lstmp_launch_plan(
            ASR["batch"], d, p, torch.cuda.get_device_properties(
                0).multi_processor_count).items()
         if k not in ("units", "cols")}))

    def ragged(b, tt):
        lens = rng.randint(1, tt + 1, size=b)
        lens[0], lens[-1] = tt, 1
        return lens.tolist()

    err_max = 0.0
    # the other shapes: one row, one step, ragged slices, the small
    # widths, and the plans that leave shared memory: weights read from L2
    # (4 x DeepASR's widths) and a batch whose x does not fit (several row
    # tiles and h tiles)
    for what, (b, tt, dd, pp) in (
            ("one row", (1, t, d, p)), ("one step", (8, 1, d, p)),
            ("D 1000 / P 500", (ASR["batch"], 64, 1000, 500)),
            ("hidden 8 / proj 4", (ASR_SMALL["batch"], 12,
                                   ASR_SMALL["hidden"], ASR_SMALL["proj"])),
            ("streamed weights", (8, 4, 4 * d, 4 * p)),
            ("no x prefetch", (1024, 2, d, p))):
        inputs = lstmp_inputs(torch, g, b, tt, dd, pp)
        lens = ragged(b, tt) if b > 1 else [tt]
        err_max = max(err_max, lstmp_check(torch, ck, what, *inputs, lens))
        err_max = max(err_max, lstmp_graph_check(torch, ck, *inputs, lens))
        del inputs
    base_k7 = None
    build_dir = tempfile.mkdtemp(prefix="ptt_k7_baseline_")
    if k7_source is not None:
        t0 = time.perf_counter()
        base_k7 = baseline_lstmp(torch, ck, k7_source, build_dir)
        print("kernels: built the baseline fused_lstmp (%s) in %.1f s"
              % (K7_BASELINE_COMMIT, time.perf_counter() - t0))
    else:
        print("kernels: the baseline fused_lstmp source is not at hand; its "
              "time is not measured")
    timing = {}
    for b in (8, ASR["batch"]):
        lens = ragged(b, t)
        x, w, wp, bias, r0, c0 = lstmp_inputs(torch, g, b, t, d, p)
        err_max = max(err_max, lstmp_check(torch, ck, "path shape", x, w,
                                           wp, bias, r0, c0, lens))
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        if base_k7 is not None:
            got = base_k7(x, w, wp, bias, r0, c0, lt, True)
            want = ck.fused_lstmp_plain(x, w, wp, bias, r0, c0, lt, True)
            torch.cuda.synchronize()
            print("kernels: the baseline fused_lstmp B=%d agrees with the "
                  "plain version to %.3e"
                  % (b, max((a - r).abs().max().item()
                            for a, r in zip(got, want))))
            del got, want
        # the library yardstick: cuDNN's LSTM with a projection, from the
        # frames (its input product included) at full lengths. It has no
        # tanh on the projection and orders its gates {i, f, g, o}, so
        # only its time compares
        lib = torch.nn.LSTM(ASR["frame"], d, proj_size=p,
                            batch_first=True).to(dev)
        frames = torch.randn((b, t, ASR["frame"]), generator=g, device=dev)

        def lib_call(lib=lib, frames=frames):
            with torch.no_grad():
                return lib(frames)

        def new_call():
            return ck.fused_lstmp(x, w, wp, bias, None, None, lt)

        def old_call():
            return base_k7(x, w, wp, bias, None, None, lt)

        flops, nbytes = lstmp_work(lens, t, d, p, b, False)
        bms, bby = bound(flops, nbytes, peak_flops, peak_bw)
        # in turns, old new new old, so that drift shows
        old_ms = ([time_ms(torch, old_call, iters=2, reps=3)] if base_k7
                  else [])
        new_ms = [time_ms(torch, new_call, iters=10, reps=5)]
        new_ms.append(time_ms(torch, new_call, iters=10, reps=5))
        if base_k7:
            old_ms.append(time_ms(torch, old_call, iters=2, reps=3))
        timing[b] = {
            "ms": statistics.mean(new_ms), "ms_runs": new_ms,
            "baseline_ms": statistics.mean(old_ms) if old_ms else None,
            "baseline_ms_runs": old_ms,
            "plain_ms": time_ms(torch, lambda: ck.fused_lstmp_plain(
                x, w, wp, bias, None, None, lt), iters=1, reps=3),
            "library_ms": time_ms(torch, lib_call, iters=4, reps=5),
            "bound_ms": bms, "bound_by": bby, "lens": lens}
        tm = timing[b]
        print("kernels: fused_lstmp timing x [%d,%d,%d]: new %s ms, baseline "
              "%s ms, plain %.4f ms, cuDNN %.4f ms, bound %.4f ms (%s)"
              % (b, t, 4 * d, " / ".join("%.4f" % v for v in new_ms),
                 " / ".join("%.4f" % v for v in old_ms) or "not measured",
                 tm["plain_ms"], tm["library_ms"], bms, bby))
        del x, lib, frames
    serve, train = timing[8], timing[ASR["batch"]]
    r = {
        "name": "fused_lstmp", "route": "cuda", "source": LSTMP_SRC,
        "replaces": LSTMP_TPU,
        "shape": "x [8,%d,%d] fp32, D=%d, P=%d, lens %s" % (
            t, 4 * d, d, p, serve["lens"]),
        "max_abs_err": err_max,
        "ms": serve["ms"], "plain_ms": serve["plain_ms"],
        "library_ms": serve["library_ms"],
        "library_covers": "torch.nn.LSTM(%d, %d, proj_size=%d) (cuDNN) on "
                          "the frames at full lengths, its input product "
                          "included, in a CUDA graph; no tanh on its "
                          "projection and another gate order, so only the "
                          "time compares" % (ASR["frame"], d, p),
        "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
        "baseline_ms": serve["baseline_ms"],
        "train_shape": "x [%d,%d,%d]" % (ASR["batch"], t, 4 * d),
        "train_ms": train["ms"], "train_plain_ms": train["plain_ms"],
        "train_library_ms": train["library_ms"],
        "train_bound_ms": train["bound_ms"],
        "train_baseline_ms": train["baseline_ms"],
    }

    def opt(v):
        return "not measured" if v is None else "%.4f" % v

    print("kernels: fused_lstmp ms=%.4f baseline_ms=%s plain_ms=%.4f "
          "library_ms=%.4f bound_ms=%.4f (%s); at %s ms=%.4f baseline_ms=%s "
          "plain_ms=%.4f library_ms=%.4f bound_ms=%.4f"
          % (r["ms"], opt(r["baseline_ms"]), r["plain_ms"], r["library_ms"],
             r["bound_ms"], r["bound_by"], r["train_shape"], train["ms"],
             opt(train["baseline_ms"]), train["plain_ms"], train["library_ms"],
             train["bound_ms"]))
    shutil.rmtree(build_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"fused_lstmp": r}


# --------------------------------------------------------------- serving --

def build_scoring(fluid, transformer, n_layer=N_LAYER, seed=SEED):
    """Transformer-base scoring (MODEL, fused attention, startup seeded
    by `seed`): (main, startup, predict)."""
    vocab, t_max = MODEL["vocab"], MODEL["max_length"]
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, predict = transformer.transformer(
            vocab, vocab, t_max, n_layer=n_layer, n_head=MODEL["n_head"],
            d_key=MODEL["d_key"], d_value=MODEL["d_key"],
            d_model=MODEL["d_model"], d_inner_hid=MODEL["d_inner"],
            use_fused_attention=True)
    return main, startup, predict


def scoring_requests(transformer, n=16):
    """Phase 4's requests: `n` single-sentence scoring feeds of 32-256
    source and target tokens, from SEED."""
    vocab, t_max = MODEL["vocab"], MODEL["max_length"]
    rng = np.random.RandomState(SEED)
    requests = []
    for _ in range(n):
        s = rng.randint(3, vocab, rng.randint(t_max // 8, t_max + 1)).tolist()
        tg = rng.randint(3, vocab, rng.randint(t_max // 8, t_max + 1)).tolist()
        requests.append(transformer.prepare_batch([s], [tg], t_max))
    return requests


def run_serving(torch, card, n_layer=N_LAYER):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.serving import InferenceEngine

    vocab, t_max = MODEL["vocab"], MODEL["max_length"]
    t0 = time.perf_counter()
    main, startup, predict = build_scoring(fluid, transformer, n_layer)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(scope.get(p.name).shape))
                   for p in main.all_parameters())
    print("serving: built Transformer-base scoring (%d+%d layers, %d "
          "parameters) and ran its startup program on %s in %.1f s"
          % (n_layer, n_layer, n_params, exe.device,
             time.perf_counter() - t0))

    requests = scoring_requests(transformer)

    with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as model_dir:
        t0 = time.perf_counter()
        program = fluid.io.save_inference_model(
            model_dir, transformer.SCORING_FEED_NAMES, [predict], exe, main,
            scope=scope)
        del scope
        ops = program.global_block().ops
        n_flash = sum(op.type == "fused_attention" for op in ops)
        n_ln = sum(op.type == "layer_norm" and bool(op.inputs.get("Scale"))
                   and bool(op.inputs.get("Bias")) for op in ops)
        print("serving: saved the inference model (%d ops: %d "
              "fused_attention, %d layer_norm) in %.1f s"
              % (len(ops), n_flash, n_ln, time.perf_counter() - t0))
        # per layer pair: encoder self, decoder causal self and cross
        # attention; 2 encoder + 3 decoder layer norms, plus the two final
        # ones (18 and 32 at 6+6 layers)
        check(n_flash == 3 * n_layer and n_ln == 5 * n_layer + 2,
              "the scoring program has %d fused_attention and %d layer_norm "
              "ops, expected %d and %d"
              % (n_flash, n_ln, 3 * n_layer, 5 * n_layer + 2))

        t0 = time.perf_counter()
        engine = InferenceEngine(model_dir, batch_buckets=[1, 4, 8])
        torch.cuda.synchronize()
        print("serving: engine loaded and warmed up in %.1f s"
              % (time.perf_counter() - t0))
        try:
            # the counts: zero just before the main path, read just after
            ck.reset_launch_counts()
            batches0 = engine.metrics.snapshot()["batches_total"]
            answers, latencies, futures, wall = serve_burst(
                engine, requests, predict.name)
            counts = ck.launch_counts()
            snap = engine.metrics.snapshot()
            batches = snap["batches_total"] - batches0
            print("serving: launches %s over %d engine dispatches"
                  % (counts, batches))
            check(counts["flash_attention_fwd"] == n_flash * batches,
                  "flash kernel launched %d times, expected %d x %d"
                  % (counts["flash_attention_fwd"], n_flash, batches))
            check(counts["layer_norm_fwd"] == n_ln * batches,
                  "layer-norm kernel launched %d times, expected %d x %d"
                  % (counts["layer_norm_fwd"], n_ln, batches))

            for i, a in enumerate(answers):
                check(a.shape == (1, t_max, vocab) and np.isfinite(a).all(),
                      "answer %d: shape %s, finite=%s"
                      % (i, a.shape, np.isfinite(a).all()))
            bucket_diff = 0.0
            for i, fut in enumerate(futures):
                direct, _ = engine.run_direct(requests[i],
                                              batch_bucket=fut.bucket[0])
                bucket_diff = max(bucket_diff, float(np.abs(
                    direct[predict.name] - answers[i]).max()))
            print("serving: coalesced vs run_direct at the same bucket: "
                  "max diff %.3e (buckets %s)"
                  % (bucket_diff, sorted(set(f.bucket[0] for f in futures))))
            check(bucket_diff <= BUCKET_TOL,
                  "coalesced answers differ from run_direct by %r"
                  % bucket_diff)
        finally:
            engine.close()

        t0 = time.perf_counter()
        cpu = InferenceEngine(model_dir, device="cpu", batch_buckets=[1],
                              warmup=False)
        try:
            ref = cpu.run_direct(requests[0])[0][predict.name]
        finally:
            cpu.close()
        cpu_diff = float(np.abs(ref - answers[0]).max())
        print("serving: request 0 on the card vs on the CPU (plain "
              "versions, same weights): max diff %.3e (%.1f s)"
              % (cpu_diff, time.perf_counter() - t0))
        check(cpu_diff <= CPU_TOL, "card and CPU disagree by %r" % cpu_diff)

    trg_tokens = int(sum(int(r["trg_len"].sum()) for r in requests))
    lat_ms = sorted(x * 1e3 for x in latencies)
    serving = {
        "requests": 16, "batches": batches,
        "occupancy": snap["mean_batch_occupancy"],
        "row_utilization": snap["row_utilization"],
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "wall_s": wall, "scored_tokens": trg_tokens,
        "scored_tokens_per_s": trg_tokens / wall,
        "bucket_max_diff": bucket_diff, "cpu_max_diff": cpu_diff,
        "card": card,
    }
    print("serving: " + json.dumps(serving))
    expected = dict.fromkeys(counts, 0)
    expected.update(flash_attention_fwd=n_flash * batches,
                    layer_norm_fwd=n_ln * batches)
    return counts, expected


# -------------------------------------------------------------- training --

# the Transformer-base training programs chip_smoke.py runs, each at
# bench.py's widths with label smoothing 0.1 (transformer.build_train's
# arguments; "amp" turns on Program.enable_mixed_precision):
TRAIN_VARIANTS = {
    # fused attention in fp32 (TF32 off): bench.py's bench_transformer
    # model with BENCH_DTYPE=fp32
    "fp32": dict(use_fused_attention=True),
    # bench.py's bench_transformer as the JAX package benchmarks it:
    # fused attention under bf16 mixed precision (BENCH_DTYPE bf16, its
    # default), the fused label smoothing
    "bf16": dict(use_fused_attention=True, amp=True),
    # the JAX package's default dense attention with Transformer-base's
    # published dropout 0.1, the unfused label smoothing (a soft-label
    # softmax_with_cross_entropy) and the fused qkv projection, fp32
    "dropout": dict(dropout_rate=0.1, use_fused_label_smooth=False,
                    use_qkv_fusion=True),
}


def build_train(fluid, transformer, n_layer, max_length=None,
                variant="fp32", **extra):
    """A Transformer-base training program of TRAIN_VARIANTS (`extra`:
    more transformer.build_train arguments): returns (main, startup,
    avg_cost)."""
    kwargs = dict(TRAIN_VARIANTS[variant], **extra)
    amp = kwargs.pop("amp", False)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    if amp:
        main.enable_mixed_precision()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, avg_cost, _ = transformer.build_train(
            MODEL["vocab"], MODEL["vocab"],
            max_length or MODEL["max_length"],
            d_model=MODEL["d_model"], warmup_steps=WARMUP_STEPS,
            n_layer=n_layer, n_head=MODEL["n_head"], d_key=MODEL["d_key"],
            d_value=MODEL["d_key"], d_inner_hid=MODEL["d_inner"],
            label_smooth_eps=0.1, **kwargs)
    return main, startup, avg_cost


def op_breakdown(trace_path):
    """{program op type: [host us, device us, kernel launches, ops]} from a
    chrome trace of a step whose ops each ran under record_function
    ("op:<type>"), grad_of ops named by the forward type they
    differentiate. A kernel belongs to the op during which the host
    launched it (the CUDA runtime or driver call and the kernel share a
    correlation id; autograd's device thread launches inside the grad_of
    op's range). An op run inside another (a step block's op inside
    rnn_scan) is its own row, "<outer>/<type>", and its time and kernels
    count in the outer op's row too: only the outermost rows add up to the
    step. Returns (rows, the set of outermost row names)."""
    import bisect
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][3:])
                   for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("op:"))
    starts = [sp[0] for sp in spans]
    rows, keys, parents, open_spans = {}, [], [], []
    for i, (t0, t1, name) in enumerate(spans):
        while open_spans and t0 >= spans[open_spans[-1]][1]:
            open_spans.pop()
        parent = open_spans[-1] if open_spans else -1
        keys.append(name if parent < 0 else keys[parent] + "/" + name)
        parents.append(parent)
        open_spans.append(i)
        row = rows.setdefault(keys[i], [0.0, 0.0, 0, 0])
        row[0] += t1 - t0
        row[3] += 1
    outermost = {keys[i] for i, p in enumerate(parents) if p < 0}
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ts = launched.get(e["args"].get("correlation"))
        i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
        # the innermost op still open at the launch: the last one started,
        # or one that encloses it
        while i >= 0 and ts > spans[i][1]:
            i = parents[i]
        while i >= 0:
            row = rows[keys[i]]
            row[1] += e["dur"]
            row[2] += 1
            i = parents[i]
    return rows, outermost


# parts of the port's kernels' device names (the profiler's "port kernels")
PORT_KERNEL_PARTS = ("flash_fwd", "flash_bwd", "xent_fwd",
                     "layer_norm_fwd_kernel", "fused_lstm_fwd_kernel",
                     "fused_lstmp_fwd_kernel", "masked_softmax_fwd_kernel",
                     "masked_pool_fwd_kernel")


def profile_step(torch, step, trace_path=None):
    """One training step under torch.profiler, each program op inside a
    record_function range: prints the device time by kernel (top 15),
    grouped as the port's kernels, convolutions (cuDNN), matrix products
    and the rest; host ms, device ms and kernel launches by program op
    type (top 12 by host time); and the device's idle share of the traced step's wall time (the
    profiler slows the host, so that share is an upper bound). The chrome
    trace is kept at `trace_path` when one is given. Returns the device
    busy ms, the groups' ms and the kernel launches of the step."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch.core import lowering

    run_op = lowering.lower_op

    def named_op(ctx, op, env):
        kind = op.type if op.type != "grad_of" else \
            "grad_of:" + op.attrs["fwd_type"]
        with record_function("op:" + kind):
            run_op(ctx, op, env)

    torch.cuda.synchronize()
    lowering.lower_op = named_op
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ts = time.perf_counter()
            step()
            wall_us = (time.perf_counter() - ts) * 1e6
    finally:
        lowering.lower_op = run_op
    with tempfile.TemporaryDirectory(prefix="ptt_trace_") as tmp:
        trace = trace_path or os.path.join(tmp, "train_step_trace.json")
        prof.export_chrome_trace(trace)
        rows, outermost = op_breakdown(trace)
    kernels, n_kernels = {}, 0
    for name, us in device_events(torch, prof):
        # the op ranges show on the device's timeline too: not kernels
        if not name.startswith("op:"):
            kernels[name] = kernels.get(name, 0.0) + us
            n_kernels += 1
    busy = sum(kernels.values())
    groups = {"port kernels": 0.0, "convolutions": 0.0,
              "matrix products": 0.0, "other": 0.0}
    for name, us in kernels.items():
        low = name.lower()
        if any(k in low for k in PORT_KERNEL_PARTS):
            groups["port kernels"] += us
        elif any(k in low for k in ("conv", "fprop", "dgrad", "wgrad",
                                    "cudnn")):
            groups["convolutions"] += us
        # nvjet: cuBLAS's Hopper GEMMs (the bf16 products run there)
        elif any(k in low for k in ("gemm", "gemv", "cutlass", "cublas",
                                    "nvjet")):
            groups["matrix products"] += us
        else:
            groups["other"] += us
    flash = {part: sum(us for name, us in kernels.items() if part in name)
             for part in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}
    print("profile: flash attention device ms %s, %.1f in all"
          % (json.dumps({k: v / 1e3 for k, v in flash.items()}),
             sum(flash.values()) / 1e3))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    print("profile: step wall %.1f ms, device busy %.1f ms, idle share "
          "%.3f, %d device kernels" % (wall_us / 1e3, busy / 1e3,
                                       1 - busy / wall_us, n_kernels))
    print("profile: device ms by group %s"
          % json.dumps({k: v / 1e3 for k, v in groups.items()}))
    for name, us in top:
        print("profile: %10.3f ms  %s" % (us / 1e3, name[:110]))
    top_rows = [rows[k] for k in outermost]
    print("profile: by program op: host ms in op rules %.1f, kernels "
          "attributed %d of %d" % (sum(r[0] for r in top_rows) / 1e3,
                                   sum(r[2] for r in top_rows), n_kernels))
    for name, (host, dev, n, ops) in sorted(rows.items(),
                                            key=lambda kv: -kv[1][0])[:16]:
        print("profile: op %-32s x%-4d host %8.3f ms  device %8.3f ms  "
              "%5d kernels" % (name, ops, host / 1e3, dev / 1e3, n))
    return busy / 1e3, {k: v / 1e3 for k, v in groups.items()}, n_kernels


def train_steps(torch, tag, exe, main, feed, avg_cost, scope, trace_path,
                tokens, unit):
    """TRAIN_STEPS steps of `main` on one feed through Executor.run (the
    numpy fetch of the loss waits for the step's last kernel), the launch
    counts zeroed just before them and read just after, then one more
    step under profile_step. Checks every loss finite and the last below
    the first. Returns (the report's timing, memory, loss and device
    fields, with `tokens` a step counted as `unit`; the launch counts;
    the number of counted steps)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck

    warm, timed = TRAIN_STEPS
    losses, step_s = [], []
    ck.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold: the peak below includes it
    at_start = torch.cuda.memory_allocated()
    for _ in range(warm + timed):
        ts = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[avg_cost], scope=scope)
        step_s.append(time.perf_counter() - ts)
        losses.append(float(loss.reshape(-1)[0]))
    counts = ck.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    busy_ms, groups_ms, n_kernels = profile_step(
        torch, lambda: exe.run(main, feed=feed, fetch_list=[avg_cost],
                               scope=scope), trace_path)
    print("%s losses %s" % (tag, ["%.6f" % x for x in losses]))
    check(all(np.isfinite(x) for x in losses), "a loss is not finite: %s"
          % losses)
    check(losses[-1] < losses[0], "the loss did not fall: %s" % losses)
    steps = warm + timed
    times = step_s[warm:]
    med = statistics.median(times)
    report = {
        "steps_timed": timed, "step_ms_median": med * 1e3,
        "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
        unit + "_per_s": tokens / med, "peak_mem_bytes": peak,
        "mem_at_start_bytes": at_start,
        "losses": losses,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "device_busy_ms": busy_ms, "device_ms_by_group": groups_ms,
        "device_kernels_per_step": n_kernels,
        # an estimate: the traced step's device time over the untraced
        # steps' median wall time (two runs; the trace slows only the host)
        "idle_share_est": 1 - busy_ms / (med * 1e3),
    }
    return report, counts, steps


def run_training(torch, card, n_layer=N_LAYER, batch=TRAIN_BATCH,
                 trace_path=None, variant="fp32"):
    """The training path: Adam + noam steps of Transformer-base (a
    TRAIN_VARIANTS program) on the card through Executor.run, on bench.py's
    copy task (src = trg = random ids in [3, V), full length, the same
    batch every step; the dense variant's attn_bias feeds from
    prepare_batch with n_head). Per step, one K1, K2 and K3 launch per
    fused_attention op (their bf16 kernels under mixed precision), one K4
    per hard-label softmax_with_cross_entropy, one K5 per layer_norm."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    vocab, t_max = MODEL["vocab"], MODEL["max_length"]
    tag = "training:" if variant == "fp32" else "training %s:" % variant
    t0 = time.perf_counter()
    main, startup, avg_cost = build_train(fluid, transformer, n_layer,
                                          variant=variant)
    ops = main.global_block().ops
    flash = "_bf16" if main._amp else ""
    n_attn = sum(op.type == "fused_attention" for op in ops)
    per_step = {
        "flash_attention_fwd" + flash: n_attn,
        "flash_attention_bwd_dkdv" + flash: sum(
            op.type == "grad_of" and op.attrs["fwd_type"] == "fused_attention"
            for op in ops),
        "softmax_xent_fwd": sum(op.type == "softmax_with_cross_entropy"
                                and not op.attrs.get("soft_label")
                                for op in ops),
        "layer_norm_fwd": sum(op.type == "layer_norm" for op in ops)}
    per_step["flash_attention_bwd_dq" + flash] = \
        per_step["flash_attention_bwd_dkdv" + flash]
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(scope.get(p.name).shape))
                   for p in main.all_parameters())
    print("%s built Transformer-base training (%s: %d+%d layers, %d "
          "parameters, %d ops, %d dropout) and ran its startup program on "
          "%s in %.1f s" % (tag, variant, n_layer, n_layer, n_params,
                            len(ops), sum(op.type == "dropout" for op in ops),
                            exe.device, time.perf_counter() - t0))
    frozen = {name: scope.get(name).clone()
              for name in transformer.POS_ENC_PARAM_NAMES}

    rng = np.random.RandomState(SEED)
    srcs = [rng.randint(3, vocab, t_max).tolist() for _ in range(batch)]
    dense = not TRAIN_VARIANTS[variant].get("use_fused_attention")
    feed = transformer.prepare_batch(
        srcs, srcs, t_max, labels=True,
        n_head=MODEL["n_head"] if dense else None)
    tokens = int(feed["lbl_weight"].sum())
    report, counts, steps = train_steps(torch, tag, exe, main, feed,
                                        avg_cost, scope, trace_path, tokens,
                                        "tokens")
    print("%s launches %s over %d steps (expected per step %s)"
          % (tag, counts, steps, per_step))
    for name, n in per_step.items():
        check(counts[name] == n * steps,
              "%s launched %d times over %d steps, expected %d per step"
              % (name, counts[name], steps, n))
    for name, before in frozen.items():
        check(torch.equal(scope.get(name), before),
              "the frozen table %s changed in training" % name)
    check(all(scope.get(p.name).dtype == torch.float32
              for p in main.all_parameters()),
          "a parameter is not an f32 master")
    training = {"variant": variant, "amp_bf16": main._amp,
                "layers": n_layer, "batch": batch, "seq": t_max,
                "tokens": tokens, **report, "card": card}
    print("%s %s" % (tag, json.dumps(training)))
    del scope
    torch.cuda.empty_cache()
    expected = dict.fromkeys(counts, 0)
    expected.update({k: n * steps for k, n in per_step.items()})
    return (counts, expected), training


def step_vs_cpu(main, startup, avg_cost, feed, lr, what):
    """One training step of `main` from the same weights (the CPU startup
    program's) on the card and on the CPU (plain versions): the loss
    within LOSS_RTOL relative, every gradient within GRAD_RTOL of its
    largest value, every parameter within 2 * lr (Adam's first step moves
    a parameter by about lr whatever its gradient, so a gradient at
    rounding-noise level may take it the other way on one device)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio

    cpu = fluid.Executor("cpu")
    cpu_scope = fluid.Scope()
    cpu.run(startup, scope=cpu_scope)
    state = {v.name: cpu_scope.get(v.name).numpy().copy()
             for v in main.list_vars() if v.persistable}
    card_scope = pio.scope_from_numpy(state, "cuda", program=main)
    grads = sorted(p.name + "@GRAD" for p in main.all_parameters()
                   if p.trainable)
    fetch = [avg_cost.name] + grads
    got = fluid.Executor().run(main, feed=feed, fetch_list=fetch,
                               scope=card_scope)
    want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    loss_diff = abs(float(got[0][0]) - float(want[0][0]))
    grad_err = max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                     1e-30)
                   for a, b in zip(got[1:], want[1:]))
    param_diff = max(float(np.abs(card_scope.get(name).cpu().numpy()
                                  - cpu_scope.get(name).numpy()).max())
                     for name in state)
    print("%s, card vs CPU: loss %.6f vs %.6f (diff %.3e), max gradient "
          "error %.3e of its max, max parameter diff %.3e (limit 2 * lr = "
          "%.3e)" % (what, float(got[0][0]), float(want[0][0]), loss_diff,
                     grad_err, param_diff, 2 * lr))
    check(loss_diff <= LOSS_RTOL * abs(float(want[0][0])),
          "card and CPU losses differ by %r" % loss_diff)
    check(grad_err <= GRAD_RTOL, "card and CPU gradients differ by %r of "
          "their max" % grad_err)
    check(param_diff <= 2 * lr * 1.001, "card and CPU parameters differ "
          "by %r after one step" % param_diff)


def run_training_vs_cpu(torch):
    """One training step of Transformer-base at full widths and reduced
    depth and batch (1+1 layers, batch 2, T=64 of ragged lengths) on the
    card and on the CPU, held by step_vs_cpu; lr is noam's first step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer

    vocab, t = MODEL["vocab"], 64
    main, startup, avg_cost = build_train(fluid, transformer, 1, t)
    rng = np.random.RandomState(SEED + 1)
    srcs = [rng.randint(3, vocab, n).tolist() for n in (t, 37)]
    trgs = [rng.randint(3, vocab, n).tolist() for n in (50, t)]
    feed = transformer.prepare_batch(srcs, trgs, t, labels=True)
    step_vs_cpu(main, startup, avg_cost, feed,
                MODEL["d_model"] ** -0.5 * WARMUP_STEPS ** -1.5,
                "training: one step at 1+1 layers, batch 2, T=%d" % t)


def run_training_bf16_vs_cpu(torch):
    """One step of the mixed-precision Transformer-base (TRAIN_VARIANTS
    "bf16": the bf16 K1-K3 on the card, their plain versions on the CPU)
    at full widths and reduced depth and batch (1+1 layers, batch 2, T=64
    of ragged lengths), from the CPU startup program's state, on the card
    and on the CPU, and the same step in fp32 on the CPU, held by
    hold_bf16_step (cuBLAS's bf16 products against the CPU's), as
    run_resnet_training_vs_cpu holds ResNet-50's bf16 step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    vocab, t = MODEL["vocab"], 64
    rng = np.random.RandomState(SEED + 1)
    srcs = [rng.randint(3, vocab, n).tolist() for n in (t, 37)]
    trgs = [rng.randint(3, vocab, n).tolist() for n in (50, t)]
    feed = transformer.prepare_batch(srcs, trgs, t, labels=True)
    main32, startup, avg = build_train(fluid, transformer, 1, t, "fp32")
    main16 = build_train(fluid, transformer, 1, t, "bf16")[0]
    cpu = fluid.Executor("cpu")
    scope0 = fluid.Scope()
    cpu.run(startup, scope=scope0)
    state = {v.name: scope0.get(v.name).numpy().copy()
             for v in main32.list_vars() if v.persistable}
    grads = sorted(p.name + "@GRAD" for p in main32.all_parameters()
                   if p.trainable)
    fetch = [avg.name] + grads

    def step(prog, device):
        scope = pio.scope_from_numpy(state, device, program=prog)
        out = fluid.Executor(device).run(prog, feed=feed, fetch_list=fetch,
                                         scope=scope)
        return float(out[0][0]), out[1:]

    card16, cpu16, cpu32 = step(main16, "cuda"), step(main16, "cpu"), \
        step(main32, "cpu")
    return hold_bf16_step("training bf16: one step at 1+1 layers, batch 2, "
                          "T=%d," % t, grads, card16, cpu16, cpu32)


# ------------------------------------------------------------- sequences --

def no_peephole_stacked_lstm_net(fluid, data, dict_dim, class_dim=2,
                                 emb_dim=128, hid_dim=512, stacked_num=3):
    """models/understand_sentiment.stacked_lstm_net's layer calls with
    use_peepholes=False on each dynamic_lstm: the configuration in which
    the JAX package dispatches its fused LSTM kernel, and the port K6."""
    emb = fluid.layers.embedding(input=data, size=[dict_dim, emb_dim])
    fc1 = fluid.layers.fc(input=emb, size=hid_dim)
    lstm1, _ = fluid.layers.dynamic_lstm(input=fc1, size=hid_dim,
                                         use_peepholes=False)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = fluid.layers.fc(input=inputs, size=hid_dim)
        lstm, _ = fluid.layers.dynamic_lstm(
            input=fc, size=hid_dim, is_reverse=(i % 2) == 0,
            use_peepholes=False)
        inputs = [fc, lstm]
    fc_last = fluid.layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = fluid.layers.sequence_pool(input=inputs[1], pool_type="max")
    return fluid.layers.fc(input=[fc_last, lstm_last], size=class_dim,
                           act="softmax")


def build_sentiment(fluid, kind):
    """The book's IMDB classifier: "conv" = understand_sentiment's
    convolution_net as written, "lstm" = the stacked LSTM at its book
    widths without peepholes. Returns (main, startup, prediction)."""
    from paddle_tpu_torch.models import understand_sentiment
    m = SENTIMENT
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                  lod_level=1)
        if kind == "conv":
            pred = understand_sentiment.convolution_net(
                words, m["dict_dim"], m["classes"], m["conv_emb"],
                m["conv_hid"])
        else:
            pred = no_peephole_stacked_lstm_net(
                fluid, words, m["dict_dim"], m["classes"], m["lstm_emb"],
                m["lstm_hid"], m["stacked"])
    return main, startup, pred


def serve_burst(engine, requests, fetch):
    """The requests, all at once from as many client threads, each
    answer's `fetch` (every fetch, as a dict, for None): (answers,
    latencies in s, futures, wall s)."""
    n = len(requests)
    answers, latencies, futures = [None] * n, [None] * n, [None] * n
    errors = []
    barrier = threading.Barrier(n)

    def client(i):
        try:
            barrier.wait()
            ts = time.perf_counter()
            fut = engine.submit(requests[i])
            out = fut.result(600).numpy()
            answers[i] = out if fetch is None else out[fetch]
            latencies[i] = time.perf_counter() - ts
            futures[i] = fut
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    tw = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    wall = time.perf_counter() - tw
    check(not any(th.is_alive() for th in threads),
          "a client thread did not finish")
    check(not errors, "requests failed: %s" % errors)
    return answers, latencies, futures, wall


def serve_lod_model(torch, what, model_dir, requests, answer_shape,
                    per_dispatch, unit, seq_buckets=SEQ_BUCKETS):
    """Serve one saved sequence model: the requests, all at once from as
    many client threads, through InferenceEngine(batch_buckets=[1, 4, 8],
    seq_buckets=seq_buckets) warmed over its (batch, seq) lattice. Checks
    every answer finite, of answer_shape(bucket) and summing to 1 over its
    last axis (per review, or per frame); each equal to run_direct at its
    recorded bucket (<= BUCKET_TOL); request 0 against the CPU at the
    same seq bucket (<= SEQ_CPU_TOL). per_dispatch(ops) gives the kernel
    launches one dispatch of the program predicts; `unit` names what a
    request's sequence holds in the report. Returns the report, the
    launch counts of the requests' run and the counts predicted."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import InferenceEngine

    n = len(requests)
    t0 = time.perf_counter()
    engine = InferenceEngine(model_dir, batch_buckets=[1, 4, 8],
                             seq_buckets=seq_buckets)
    torch.cuda.synchronize()
    per = per_dispatch(engine.program.global_block().ops)
    try:
        check(engine.seq_buckets == seq_buckets,
              "the engine's seq buckets are %s, expected %s"
              % (engine.seq_buckets, seq_buckets))
        print("%s engine loaded and warmed up over its %d (batch, seq) "
              "buckets in %.1f s; launches predicted per dispatch %s"
              % (what, len(engine.batch_buckets) * len(seq_buckets),
                 time.perf_counter() - t0, per))
        fetch = engine.fetch_names[0]
        # the counts: zero just before the main path, read just after
        ck.reset_launch_counts()
        batches0 = engine.metrics.snapshot()["batches_total"]
        answers, latencies, futures, wall = serve_burst(engine, requests,
                                                        fetch)
        counts = ck.launch_counts()
        snap = engine.metrics.snapshot()
        batches = snap["batches_total"] - batches0
        expected = dict.fromkeys(counts, 0)
        expected.update({k: v * batches for k, v in per.items()})
        print("%s launches %s over %d engine dispatches"
              % (what, counts, batches))
        for i, a in enumerate(answers):
            sum_err = float(np.abs(a.sum(axis=-1) - 1.0).max())
            check(a.shape == answer_shape(futures[i].bucket)
                  and np.isfinite(a).all() and sum_err <= 1e-5,
                  "%s answer %d: shape %s, finite %s, max |sum - 1| %r"
                  % (what, i, a.shape, np.isfinite(a).all(), sum_err))
        bucket_diff = 0.0
        for i, fut in enumerate(futures):
            direct, bucket = engine.run_direct(
                requests[i], batch_bucket=fut.bucket[0],
                seq_bucket=fut.bucket[1])
            check(bucket == fut.bucket, "run_direct ran at %s, the future "
                  "recorded %s" % (bucket, fut.bucket))
            bucket_diff = max(bucket_diff, float(np.abs(
                direct[fetch] - answers[i]).max()))
        print("%s coalesced vs run_direct at the same (batch, seq) bucket: "
              "max diff %.3e (buckets %s)"
              % (what, bucket_diff, sorted(set(f.bucket for f in futures))))
        check(bucket_diff <= BUCKET_TOL, "%s coalesced answers differ from "
              "run_direct by %r" % (what, bucket_diff))
    finally:
        engine.close()

    t0 = time.perf_counter()
    cpu = InferenceEngine(model_dir, device="cpu", batch_buckets=[1],
                          seq_buckets=seq_buckets, warmup=False)
    try:
        ref = cpu.run_direct(requests[0],
                             seq_bucket=futures[0].bucket[1])[0][fetch]
    finally:
        cpu.close()
    cpu_diff = float(np.abs(ref - answers[0]).max())
    print("%s request 0 on the card vs on the CPU (plain versions, same "
          "weights): max diff %.3e (%.1f s)"
          % (what, cpu_diff, time.perf_counter() - t0))
    check(cpu_diff <= SEQ_CPU_TOL, "%s: card and CPU disagree by %r"
          % (what, cpu_diff))
    tokens = sum(len(next(iter(r.values()))[0]) for r in requests)
    lat_ms = sorted(x * 1e3 for x in latencies)
    report = {
        "requests": n, "batches": batches,
        "occupancy": snap["mean_batch_occupancy"],
        "row_utilization": snap["row_utilization"],
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "wall_s": wall, unit: tokens, unit + "_per_s": tokens / wall,
        "bucket_max_diff": bucket_diff, "cpu_max_diff": cpu_diff,
    }
    return report, counts, expected


def sentiment_launches(ops):
    """K6 once per lstm op, K9 once per linear sequence_pool op."""
    return dict(k9_per_run(ops),
                fused_lstm=sum(op.type == "lstm" for op in ops))


def run_sequence_serving(torch, card):
    """The sequence path's serving half: both sentiment bodies, built with
    the port's layers, initialized on the card from SEED, saved and served
    with LoD feeds (16 concurrent one-review requests each, lengths
    16-256). Returns the summed launch counts and predictions."""
    import paddle_tpu_torch as fluid

    rng = np.random.RandomState(SEED + 3)
    requests = [{"words": [rng.randint(0, SENTIMENT["dict_dim"],
                                       (int(n), 1)).astype("int64")]}
                for n in rng.randint(16, 257, size=16)]
    counts, expected = {}, {}
    for kind in ("conv", "lstm"):
        t0 = time.perf_counter()
        main, startup, pred = build_sentiment(fluid, kind)
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as model_dir:
            fluid.io.save_inference_model(model_dir, ["words"], [pred], exe,
                                          main, scope=scope)
            del scope
            print("sequences: built, initialized and saved the %s sentiment "
                  "model in %.1f s" % (kind, time.perf_counter() - t0))
            report, c, e = serve_lod_model(
                torch, "sequences: " + kind, model_dir, requests,
                lambda bucket: (1, SENTIMENT["classes"]), sentiment_launches,
                "review_tokens")
        report.update(model=kind, card=card)
        print("sequences: serving " + json.dumps(report))
        for k in c:
            counts[k] = counts.get(k, 0) + c[k]
            expected[k] = expected.get(k, 0) + e[k]
    return counts, expected


def build_sentiment_train(fluid, stacked, vocab, hid):
    """The no-peephole stacked LSTM training program at bench.py's
    bench_stacked_lstm configuration: mean(cross_entropy(softmax)),
    Adam(0.002), fp32. Returns (main, startup, avg_cost)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        pred = no_peephole_stacked_lstm_net(
            fluid, words, vocab, 2, emb_dim=hid, hid_dim=hid,
            stacked_num=stacked)
        cost = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Adam(learning_rate=SEQ_TRAIN["lr"]).minimize(cost)
    return main, startup, cost


def run_sequence_training(torch, card, trace_path=None):
    """The sequence path's training half: the stacked LSTM at bench.py's
    widths (vocab 10000, emb = hid = 512, so h = 128; 3 layers) on batch
    128 x T=64 of random ids from a seed, the same batch every step,
    through Executor.run. Returns the launch counts and predictions."""
    import paddle_tpu_torch as fluid

    cfg = SEQ_TRAIN
    t0 = time.perf_counter()
    main, startup, avg_cost = build_sentiment_train(
        fluid, cfg["stacked"], cfg["vocab"], cfg["hid"])
    ops = main.global_block().ops
    n_lstm = sum(op.type == "lstm" for op in ops)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(scope.get(p.name).shape))
                   for p in main.all_parameters())
    print("sequences: built the stacked LSTM training program (%d layers, "
          "%d parameters, %d ops) and ran its startup program in %.1f s"
          % (cfg["stacked"], n_params, len(ops), time.perf_counter() - t0))
    # bench.py's feed: ids in [1, vocab), full length, labels in {0, 1}
    rng = np.random.RandomState(SEED)
    seqs = [rng.randint(1, cfg["vocab"], (cfg["seq"], 1)).astype("int64")
            for _ in range(cfg["batch"])]
    feed = {"words": fluid.LoDTensor.from_sequences(seqs),
            "label": rng.randint(0, 2, (cfg["batch"], 1)).astype("int64")}
    # bench.py's count: batch x T tokens per step
    report, counts, steps = train_steps(
        torch, "sequences: training", exe, main, feed, avg_cost, scope,
        trace_path, cfg["batch"] * cfg["seq"], "tokens")
    report = {"layers": cfg["stacked"], "hid": cfg["hid"],
              "batch": cfg["batch"], "seq": cfg["seq"], **report,
              "card": card}
    print("sequences: training " + json.dumps(report))
    del scope
    torch.cuda.empty_cache()
    expected = dict.fromkeys(counts, 0)
    expected["fused_lstm"] = n_lstm * steps
    return counts, expected


def run_sequence_training_vs_cpu(torch):
    """One training step of the stacked LSTM at full widths and 1 layer,
    batch 4 of ragged lengths 1-16, on the card and on the CPU, held by
    step_vs_cpu."""
    import paddle_tpu_torch as fluid

    cfg = SEQ_TRAIN
    main, startup, avg_cost = build_sentiment_train(fluid, 1, cfg["vocab"],
                                                    cfg["hid"])
    rng = np.random.RandomState(SEED + 4)
    lens = [16, 1, 9, 5]
    seqs = [rng.randint(1, cfg["vocab"], (n, 1)).astype("int64")
            for n in lens]
    feed = {"words": fluid.LoDTensor.from_sequences(seqs),
            "label": rng.randint(0, 2, (len(lens), 1)).astype("int64")}
    step_vs_cpu(main, startup, avg_cost, feed, cfg["lr"],
                "sequences: one step at 1 layer, batch 4, lengths %s"
                % lens)


# ----------------------------------------------------------- translation --

def build_mt_train(fluid, cfg):
    """machine_translation.build_train with attention and Adam at cfg's
    widths. Returns (main, startup, avg_cost)."""
    from paddle_tpu_torch.models import machine_translation
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        avg_cost, _ = machine_translation.build_train(
            dict_size=cfg["dict_size"], word_dim=cfg["word"],
            hidden_dim=cfg["hidden"], decoder_size=cfg["decoder"],
            learning_rate=cfg["lr"], use_attention=True, optimizer="adam")
    return main, startup, avg_cost


def mt_feed(fluid, cfg, seed):
    """A batch of source and target sentences with lengths in [min_len,
    max_len] (one of each at max_len), random ids; the label is the target
    shifted by one. Returns (feed, target token count)."""
    rng = np.random.RandomState(seed)
    b = cfg["batch"]
    src_lens = rng.randint(cfg["min_len"], cfg["max_len"] + 1, size=b)
    trg_lens = rng.randint(cfg["min_len"], cfg["max_len"] + 1, size=b)
    src_lens[0], trg_lens[-1] = cfg["max_len"], cfg["max_len"]
    src = [rng.randint(0, cfg["dict_size"], (n, 1)).astype("int64")
           for n in src_lens]
    trg = [rng.randint(0, cfg["dict_size"], (n + 1, 1)).astype("int64")
           for n in trg_lens]
    lod = fluid.LoDTensor.from_sequences
    feed = {"src_word_id": lod(src),
            "target_language_word": lod([s[:-1] for s in trg]),
            "target_language_next_word": lod([s[1:] for s in trg])}
    return feed, int(trg_lens.sum())


def run_translation_training(torch, card, trace_path=None):
    """The translation path: the attention translator at the reference
    benchmark's widths, Adam steps on one batch through Executor.run.
    Returns the launch counts and the counts it predicts."""
    import paddle_tpu_torch as fluid

    t0 = time.perf_counter()
    main, startup, avg_cost = build_mt_train(fluid, MT)
    ops = main.global_block().ops
    n_softmax = sum(op.type == "sequence_softmax" for op in main.blocks[1].ops)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(scope.get(p.name).shape))
                   for p in main.all_parameters())
    print("translation: built the attention translator's training program "
          "(dictionary %d, widths %d/%d/%d, %d parameters, %d ops + %d in "
          "the step block) and ran its startup program in %.1f s"
          % (MT["dict_size"], MT["word"], MT["hidden"], MT["decoder"],
             n_params, len(ops), len(main.blocks[1].ops),
             time.perf_counter() - t0))
    feed, tokens = mt_feed(fluid, MT, SEED)
    # the decoder runs one step per padded target step
    t_pad = feed["target_language_word"].to_padded()[0].shape[1]
    report, counts, steps = train_steps(
        torch, "translation: training", exe, main, feed, avg_cost, scope,
        trace_path, tokens, "target_tokens")
    report = {"dict_size": MT["dict_size"],
              "widths": [MT["word"], MT["hidden"], MT["decoder"]],
              "batch": MT["batch"], "decoder_steps": t_pad,
              "target_tokens": tokens, **report, "card": card}
    print("translation: training " + json.dumps(report))
    del scope
    torch.cuda.empty_cache()
    expected = dict.fromkeys(counts, 0)
    expected["masked_softmax"] = n_softmax * t_pad * steps
    return counts, expected


def run_translation_training_vs_cpu(torch):
    """One training step of the attention translator at dictionary 200,
    widths 32, batch 4 and lengths 1-12 on the card and on the CPU, held
    by step_vs_cpu."""
    import paddle_tpu_torch as fluid

    cfg = MT_SMALL
    main, startup, avg_cost = build_mt_train(fluid, cfg)
    feed, _ = mt_feed(fluid, cfg, SEED + 6)
    step_vs_cpu(main, startup, avg_cost, feed, cfg["lr"],
                "translation: one step at dictionary %d, widths %d, batch "
                "%d, lengths %d-%d" % (cfg["dict_size"], cfg["word"],
                                       cfg["batch"], cfg["min_len"],
                                       cfg["max_len"]))


# -------------------------------------------------------------- acoustic --

def stacked_lstmp_net(fluid, frames, hidden=1024, proj=512, layers=5,
                      classes=1749):
    """DeepASR's stacked_lstmp_model without its batch_norm layers and
    with use_peepholes=False: per layer fc(4 * hidden) and dynamic_lstmp
    (projection proj, tanh), then a per-frame softmax over the classes."""
    x = frames
    for _ in range(layers):
        fc = fluid.layers.fc(input=x, size=hidden * 4)
        x, _ = fluid.layers.dynamic_lstmp(
            input=fc, size=hidden * 4, proj_size=proj, use_peepholes=False,
            cell_activation="tanh", proj_activation="tanh")
    return fluid.layers.fc(input=x, size=classes, act="softmax")


def build_acoustic(fluid, cfg, train):
    """The acoustic model at cfg's widths. Serving: (main, startup,
    per-frame posteriors). Training: cross_entropy against per-frame
    labels, the length-masked mean (padding frames count for nothing, as
    in DeepASR's LoD mean) and Adam at cfg["lr"]: (main, startup,
    avg_cost)."""
    from paddle_tpu_torch.models.common import masked_mean_cost
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        frames = fluid.layers.data(name="frames", shape=[cfg["frame"]],
                                   dtype="float32", lod_level=1)
        pred = stacked_lstmp_net(fluid, frames, cfg["hidden"], cfg["proj"],
                                 cfg["layers"], cfg["classes"])
        if not train:
            return main, startup, pred
        label = fluid.layers.data(name="label", shape=[1], dtype="int64",
                                  lod_level=1)
        cost = fluid.layers.cross_entropy(input=pred, label=label)
        avg_cost = masked_mean_cost(cost, label, pred)
        fluid.optimizer.Adam(learning_rate=cfg["lr"]).minimize(avg_cost)
    return main, startup, avg_cost


def asr_feed(fluid, cfg, lens, seed):
    """Frames N(0, 1) [len, frame] and random class ids per frame."""
    rng = np.random.RandomState(seed)
    frames = [rng.randn(n, cfg["frame"]).astype("float32") for n in lens]
    labels = [rng.randint(0, cfg["classes"], (n, 1)).astype("int64")
              for n in lens]
    lod = fluid.LoDTensor.from_sequences
    return {"frames": lod(frames), "label": lod(labels)}


def run_acoustic_serving(torch, card):
    """The acoustic path's serving half: the 5-layer stacked-LSTMP model
    at DeepASR's widths, initialized on the card from SEED, saved and
    served with float LoD frame feeds (16 concurrent one-utterance
    requests of 100-500 frames, per-frame posteriors). Returns the launch
    counts and the counts it predicts."""
    import paddle_tpu_torch as fluid

    t0 = time.perf_counter()
    main, startup, pred = build_acoustic(fluid, ASR, train=False)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(scope.get(p.name).shape))
                   for p in main.all_parameters())
    rng = np.random.RandomState(SEED + 8)
    requests = [{"frames": [rng.randn(int(n), ASR["frame"]).astype(
        "float32")]} for n in rng.randint(ASR_SERVE_LENS[0],
                                          ASR_SERVE_LENS[1] + 1, size=16)]
    with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as model_dir:
        fluid.io.save_inference_model(model_dir, ["frames"], [pred], exe,
                                      main, scope=scope)
        del scope
        print("acoustic: built, initialized and saved the stacked-LSTMP "
              "model (%d layers, hidden %d, proj %d, %d classes, %d "
              "parameters) in %.1f s"
              % (ASR["layers"], ASR["hidden"], ASR["proj"], ASR["classes"],
                 n_params, time.perf_counter() - t0))
        report, counts, expected = serve_lod_model(
            torch, "acoustic:", model_dir, requests,
            lambda bucket: (1, bucket[1], ASR["classes"]),
            lambda ops: {"fused_lstmp": sum(op.type == "lstmp"
                                            for op in ops)},
            "frames", seq_buckets=ASR_SEQ_BUCKETS)
    report["card"] = card
    print("acoustic: serving " + json.dumps(report))
    return counts, expected


def run_acoustic_training(torch, card, trace_path=None):
    """The acoustic path's training half: the stacked-LSTMP model at
    DeepASR's widths, Adam steps on one batch of 32 utterances (150-500
    frames, one at 500) through Executor.run. Returns the launch counts
    and the counts it predicts."""
    import paddle_tpu_torch as fluid

    t0 = time.perf_counter()
    main, startup, avg_cost = build_acoustic(fluid, ASR, train=True)
    ops = main.global_block().ops
    n_lstmp = sum(op.type == "lstmp" for op in ops)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(scope.get(p.name).shape))
                   for p in main.all_parameters())
    print("acoustic: built the training program (%d parameters, %d ops) "
          "and ran its startup program in %.1f s"
          % (n_params, len(ops), time.perf_counter() - t0))
    rng = np.random.RandomState(SEED + 9)
    lens = rng.randint(ASR["min_len"], ASR["max_len"] + 1, size=ASR["batch"])
    lens[0] = ASR["max_len"]
    feed = asr_feed(fluid, ASR, lens, SEED + 10)
    frames = int(lens.sum())
    report, counts, steps = train_steps(
        torch, "acoustic: training", exe, main, feed, avg_cost, scope,
        trace_path, frames, "frames")
    report = {"layers": ASR["layers"], "hidden": ASR["hidden"],
              "proj": ASR["proj"], "classes": ASR["classes"],
              "batch": ASR["batch"], "max_frames": int(lens.max()),
              "frames": frames, "lr": ASR["lr"], **report, "card": card}
    print("acoustic: training " + json.dumps(report))
    del scope
    torch.cuda.empty_cache()
    expected = dict.fromkeys(counts, 0)
    expected["fused_lstmp"] = n_lstmp * steps
    return counts, expected


def run_acoustic_training_vs_cpu(torch):
    """One training step of the acoustic model at 2 layers, hidden 8,
    proj 4 (frame and class widths kept), batch 4 and lengths 1-12 on the
    card and on the CPU, held by step_vs_cpu."""
    import paddle_tpu_torch as fluid

    cfg = ASR_SMALL
    main, startup, avg_cost = build_acoustic(fluid, cfg, train=True)
    lens = [12, 1, 9, 5]
    step_vs_cpu(main, startup, avg_cost,
                asr_feed(fluid, cfg, lens, SEED + 11), cfg["lr"],
                "acoustic: one step at %d layers, hidden %d, proj %d, batch "
                "%d, lengths %s" % (cfg["layers"], cfg["hidden"],
                                    cfg["proj"], cfg["batch"], lens))


# -------------------------------------------------------------- conv net --

# phase 24: the migration scripts, read from this file (which imports the
# JAX package, so its text is parsed, never imported), and the assertions
# its tests make on their results
VERBATIM_SRC = "tests/book/test_migration_verbatim.py"
VERBATIM_ASSERTS = {
    "FIT_A_LINE": lambda r: r[-1] < 0.1 * r[0],
    "RECOGNIZE_DIGITS_CONV": lambda r: np.mean(r[1][-5:]) > 0.9
    and r[0][-1] < 0.5 * r[0][0],
    "WORD2VEC_NGRAM": lambda r: r[-1] < 0.3 * r[0],
    "SENTIMENT_LSTM": lambda r: np.mean(r[-10:]) > 0.85}
VERBATIM_FIRST = 5           # losses held tight, card vs CPU
VERBATIM_FIRST_RTOL = 1e-4   # as LeNet's: fp32, another summation order
VERBATIM_TOL = 1e-2          # every loss, of the first CPU loss: 40-300
#                              steps let the summation orders drift apart


def verbatim_scripts():
    """{name: script text} of VERBATIM_SRC's four scripts, taken from its
    syntax tree."""
    import ast
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        VERBATIM_SRC)
    with open(path) as f:
        tree = ast.parse(f.read())
    found = {node.targets[0].id: ast.literal_eval(node.value)
             for node in tree.body if isinstance(node, ast.Assign)
             and len(node.targets) == 1
             and isinstance(node.targets[0], ast.Name)
             and node.targets[0].id in VERBATIM_ASSERTS}
    check(set(found) == set(VERBATIM_ASSERTS), "%s holds scripts %s, "
          "expected %s" % (VERBATIM_SRC, sorted(found),
                           sorted(VERBATIM_ASSERTS)))
    return found


def run_verbatim(torch, src, place, init=None):
    """One script with `fluid` bound to paddle_tpu_torch in a fresh scope
    and programs (as the test file's _run_script), `fluid.CPUPlace()`
    replaced by `place`, its Executor recording the persistables after
    the startup run, or, given `init`, setting them to it. Returns the
    script's result and the recorded state."""
    import types
    import paddle_tpu_torch as fluid
    state = {}

    class Executor(fluid.Executor):
        def run(self, program=None, *args, **kwargs):
            out = fluid.Executor.run(self, program, *args, **kwargs)
            if program is fluid.default_startup_program():
                for v in program.list_vars():
                    if not v.persistable:
                        continue
                    if init is None:
                        state[v.name] = fluid.fetch_var(v.name)
                    else:
                        fluid.global_scope().set(v.name, torch.from_numpy(
                            init[v.name]).to(self.device))
            return out

    proxy = types.ModuleType("fluid")
    proxy.__dict__.update(vars(fluid))
    proxy.Executor = Executor
    env = {"fluid": proxy}
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.scope_guard(fluid.Scope()), \
            fluid.program_guard(main, startup):
        exec(src.replace("fluid.CPUPlace()", place), env)
    return env["result"], state


def run_verbatim_vs_cpu(torch, place="fluid.CUDAPlace(0)"):
    """Phase 24 (see the module's docstring). Returns the card runs'
    launch counts and the counts predicted (none)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    summary = {}
    counts = None
    for name, src in verbatim_scripts().items():
        t0 = time.perf_counter()
        ck.reset_launch_counts()
        card, state = run_verbatim(torch, src, place)
        run = ck.launch_counts()
        counts = run if counts is None else {
            k: counts[k] + n for k, n in run.items()}
        card_s = time.perf_counter() - t0
        cpu, _ = run_verbatim(torch, src, "fluid.CPUPlace()", init=state)
        check(VERBATIM_ASSERTS[name](card), "%s on the card fails %s's "
              "assertions: %s" % (name, VERBATIM_SRC, card))
        got, want = (card[0], cpu[0]) if name == "RECOGNIZE_DIGITS_CONV" \
            else (card, cpu)
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        first = np.abs(got[:VERBATIM_FIRST] - want[:VERBATIM_FIRST]) / \
            np.maximum(np.abs(want[:VERBATIM_FIRST]), 1e-12)
        drift = np.abs(got - want).max() / abs(want[0])
        summary[name] = {"steps": len(got), "first": float(got[0]),
                         "last": float(got[-1]), "cpu_last": float(want[-1]),
                         "first_rel_err": float(first.max()),
                         "max_drift": float(drift), "card_s": card_s}
        print("verbatim: %s, %d steps on %s: first %.6f, last %.6f (CPU "
              "%.6f); first %d within %.3e, drift %.3e of the first; %.1f s"
              % (name, len(got), place, got[0], got[-1], want[-1],
                 VERBATIM_FIRST, first.max(), drift, card_s))
        if name == "SENTIMENT_LSTM":
            # accuracies of 16 rows: one prediction more or less moves
            # one by 1/16, so only the first ones are held, exactly
            check(np.array_equal(got[:VERBATIM_FIRST],
                                 want[:VERBATIM_FIRST]),
                  "%s: the card's first accuracies %s, the CPU's %s"
                  % (name, got[:VERBATIM_FIRST], want[:VERBATIM_FIRST]))
            continue
        check(first.max() <= VERBATIM_FIRST_RTOL, "%s: the first losses "
              "on the card and the CPU differ by %r" % (name, first.max()))
        check(np.isfinite(drift) and drift <= VERBATIM_TOL,
              "%s: card and CPU losses drift apart by %r of the first"
              % (name, drift))
    print("verbatim: " + json.dumps(summary))
    return counts, zero_counts(counts)


def zero_counts(counts):
    """The expected launch counts of a path that runs none of the port's
    kernels: the conv-net path reaches no Pallas kernel in the JAX
    package (conv, pool, batch_norm, fc, softmax and cross_entropy are
    XLA there), so none of K1-K9 on the card."""
    return dict.fromkeys(counts, 0)


def build_resnet(fluid, use_bf16, cfg=None, model="resnet50"):
    """image_classification.build_train(model) (resnet50 or one of
    IMAGE_NETS) at cfg's image size, classes and Momentum rate (RESNET:
    resnet_imagenet of depth 50 at 224 x 224): (main, startup,
    avg_cost)."""
    from paddle_tpu_torch.models import image_classification
    cfg = cfg or RESNET
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, avg_cost, _ = image_classification.build_train(
            model, class_dim=cfg["classes"],
            image_shape=(3, cfg["image"], cfg["image"]),
            learning_rate=cfg["lr"], momentum=0.9, use_bf16=use_bf16)
    return main, startup, avg_cost


def image_feed(cfg, seed, dtype="float32"):
    """A batch of cfg's images (uniform in [0, 1), or uint8 pixels) and
    random class labels."""
    rng = np.random.RandomState(seed)
    shape = (cfg["batch"], 3, cfg["image"], cfg["image"])
    images = rng.randint(0, 256, shape).astype(np.uint8) \
        if dtype == "uint8" else rng.rand(*shape).astype(np.float32)
    return {"image": images, "label": rng.randint(
        0, cfg["classes"], (cfg["batch"], 1)).astype(np.int64)}


def run_resnet_training(torch, card, use_bf16, trace_path=None,
                        model="resnet50"):
    """The conv-net path's training half: ResNet-50 (or `model`, one of
    IMAGE_NETS, with its dropout layers) at 224 x 224, batch 32,
    Momentum(0.01, 0.9) on one batch through Executor.run, in fp32 (TF32
    off for matrix products and convolutions) or under
    enable_mixed_precision (bf16 convolutions and fc with f32 masters).
    Reports images/s, the device's busy share, peak memory and launches
    a step. Returns the launch counts and the counts it predicts (0)."""
    import paddle_tpu_torch as fluid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = "%s %s:" % (model, "bf16" if use_bf16 else "fp32")
    t0 = time.perf_counter()
    main, startup, avg_cost = build_resnet(fluid, use_bf16, model=model)
    ops = main.global_block().ops
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(scope.get(p.name).shape))
                   for p in main.all_parameters() if p.trainable)
    moving = [p.name for p in main.all_parameters() if not p.trainable]
    before = {name: scope.get(name).clone() for name in moving}
    print("%s built the training program (%d trainable parameters, %d "
          "ops: %d conv2d, %d batch_norm, %d dropout) and ran its startup "
          "program in %.1f s" % (tag, n_params, len(ops),
                                 sum(op.type == "conv2d" for op in ops),
                                 sum(op.type == "batch_norm" for op in ops),
                                 sum(op.type == "dropout" for op in ops),
                                 time.perf_counter() - t0))
    feed = image_feed(RESNET, SEED + 12)
    report, counts, steps = train_steps(
        torch, tag, exe, main, feed, avg_cost, scope, trace_path,
        RESNET["batch"], "images")
    check(all(not torch.equal(scope.get(n), before[n]) for n in moving),
          "a batch_norm moving statistic did not move")
    check(all(scope.get(p.name).dtype == torch.float32
              for p in main.all_parameters()),
          "a parameter is not an f32 master")
    report = {"model": model, "amp_bf16": use_bf16, "tf32": False,
              "image": RESNET["image"],
              "batch": RESNET["batch"], "lr": RESNET["lr"],
              "parameters": n_params, **report, "card": card}
    print("%s training %s" % (tag, json.dumps(report)))
    del scope
    torch.cuda.empty_cache()
    return (counts, zero_counts(counts)), report


def run_resnet_training_vs_cpu(torch):
    """One step of build_train("resnet50") at 3 x 32 x 32 (resnet_cifar10
    of depth 32, by the JAX package's rule), batch 8, Momentum(1e-4), on
    the card and on the CPU from the CPU startup program's state and one
    batch, in fp32 (TF32 off) and under use_bf16.

    fp32: the loss within CONV_LOSS_RTOL, each gradient within
    CONV_GRAD_MAX and their median within CONV_GRAD_MEDIAN, as
    ||card - cpu|| / ||cpu||.

    bf16 (cuDNN's bf16 convolutions and torch's batch_norm on a bf16
    input with f32 statistics, against the CPU's): bf16 rounding of the
    conv outputs grows through the backward, where each batch_norm takes
    the differences of its inputs from their mean, so the CPU's own bf16
    gradients lie about 1e-2 from its fp32 ones at the fc and up to 0.6
    at the first conv (the JAX package's bf16 likewise). Each gradient
    and each moving statistic's change after the step must lie within
    BF16_SPREAD_X x the CPU's bf16-vs-fp32 spread of it + BF16_FLOOR of
    the CPU's bf16 value (||a - b|| / ||b|| for a gradient, max |a - b| /
    max |b| for a change); the loss within BF16_LOSS_RTOL."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio

    cfg = RESNET_SMALL
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main, startup, avg_cost = build_resnet(fluid, False, cfg)
    cpu = fluid.Executor("cpu")
    scope0 = fluid.Scope()
    cpu.run(startup, scope=scope0)
    state = {v.name: scope0.get(v.name).numpy().copy()
             for v in main.list_vars() if v.persistable}
    moving = [p.name for p in main.all_parameters() if not p.trainable]
    grads = sorted(p.name + "@GRAD" for p in main.all_parameters()
                   if p.trainable)
    feed = image_feed(cfg, SEED + 13)
    fetch = [avg_cost.name] + grads

    def step(use_bf16, device):
        """(loss, [gradients], {moving statistic: its change})."""
        prog = build_resnet(fluid, use_bf16, cfg)[0] if use_bf16 else main
        scope = pio.scope_from_numpy(state, device, program=prog)
        out = fluid.Executor(device).run(prog, feed=feed, fetch_list=fetch,
                                         scope=scope)
        return float(out[0][0]), out[1:], {
            n: scope.get(n).cpu().numpy() - state[n] for n in moving}

    def max_rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    card32, cpu32 = step(False, "cuda"), step(False, "cpu")
    hold_fp32_grads("resnet: one step of resnet_cifar10 depth 32 at %d x %d, "
                    "batch %d, card vs CPU, fp32"
                    % (cfg["image"], cfg["image"], cfg["batch"]),
                    grads, card32, cpu32, CONV_GRAD_MAX, CONV_GRAD_MEDIAN)
    card16, cpu16 = step(True, "cuda"), step(True, "cpu")
    hold_bf16_step(
        "resnet: the same step under use_bf16,", grads, card16, cpu16, cpu32,
        [(n, max_rel(card16[2][n], cpu16[2][n]),
          max_rel(cpu16[2][n], cpu32[2][n])) for n in moving],
        "gradients and moving statistics")


def run_lenet_training_vs_cpu(torch):
    """Book chapter 02's LeNet (zoo mnist: recognize_digits.build, Adam
    0.001) for LENET["steps"] steps on the card and on the CPU from the
    CPU startup program's state, batch 64 of random 1 x 28 x 28 images:
    each loss within CONV_LOSS_RTOL. The card's steps are the path whose
    launches are counted. Returns the counts and the counts predicted."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.models import recognize_digits
    from paddle_tpu_torch.ops import cuda_kernels as ck

    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, avg_loss, _ = recognize_digits.build(
            nn_type="conv", learning_rate=LENET["lr"])
    cpu, cpu_scope = fluid.Executor("cpu"), fluid.Scope()
    cpu.run(startup, scope=cpu_scope)
    card_scope = pio.scope_from_numpy(
        {v.name: cpu_scope.get(v.name).numpy().copy()
         for v in main.list_vars() if v.persistable}, "cuda", program=main)
    rng = np.random.RandomState(SEED + 14)
    feeds = [{"img": rng.rand(LENET["batch"], 1, 28, 28).astype(np.float32),
              "label": rng.randint(0, 10, (LENET["batch"], 1)).astype(
                  np.int64)} for _ in range(LENET["steps"])]
    exe = fluid.Executor()
    ck.reset_launch_counts()
    got = [float(exe.run(main, feed=f, fetch_list=[avg_loss],
                         scope=card_scope)[0][0]) for f in feeds]
    counts = ck.launch_counts()
    want = [float(cpu.run(main, feed=f, fetch_list=[avg_loss],
                          scope=cpu_scope)[0][0]) for f in feeds]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print("lenet: %d Adam steps, batch %d, card vs CPU losses %s vs %s "
          "(max rel %.3e); launches %s"
          % (LENET["steps"], LENET["batch"], ["%.6f" % x for x in got],
             ["%.6f" % x for x in want], rel, counts))
    check(all(np.isfinite(got)), "LeNet losses on the card: %s" % got)
    check(rel <= CONV_LOSS_RTOL, "LeNet card and CPU losses differ by %r"
          % rel)
    return counts, zero_counts(counts)


# the test-mode ops a served net holds (save_inference_model sets is_test
# on each): resnet_imagenet's 53 batch_norms; VGG-16's 13 conv batch_norms,
# the fc's and its dropout
SERVED_TEST_OPS = {"resnet50": {"batch_norm": 53},
                   "vgg16": {"batch_norm": 14, "dropout": 1}}


def run_resnet_serving(torch, card, model="resnet50"):
    """The conv-net path's serving half: ResNet-50 (or VGG-16) at 224 x
    224 on a uint8 image feed (cast and scaled by 1/255 in the program),
    initialized on the card from SEED, saved by io.save_inference_model
    (every batch_norm and dropout is_test: a dropout then scales by 1 -
    p) and served by InferenceEngine(batch_buckets=[1,
    8, 32]): RESNET_SERVE["requests"] concurrent requests of 1-8 images.
    Checks every answer's rows finite and summing to 1, each equal to
    run_direct at its bucket (<= BUCKET_TOL), request 0 against the CPU
    (<= CPU_TOL). The same burst again (its p50), then once more under
    the profiler, gives the device's busy time; run_direct at each bucket
    (median of 5) the time of one dispatch. Returns the launch counts and the counts it predicts
    (0), and the report."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import image_classification
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import InferenceEngine

    side, classes = RESNET["image"], RESNET["classes"]
    t0 = time.perf_counter()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        raw = fluid.layers.data(name="image", shape=[3, side, side],
                                dtype="uint8")
        image = fluid.layers.scale(fluid.layers.cast(raw, "float32"),
                                   scale=1.0 / 255.0)
        if model == "resnet50":
            pred = image_classification.resnet_imagenet(image, classes, 50)
        else:
            pred = getattr(image_classification, model)(image, classes)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED + 15)
    n = RESNET_SERVE["requests"]
    requests = [{"image": rng.randint(0, 256, (int(k), 3, side, side)).astype(
        np.uint8)} for k in rng.randint(RESNET_SERVE["images"][0],
                                        RESNET_SERVE["images"][1] + 1, n)]
    with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as model_dir:
        program = fluid.io.save_inference_model(model_dir, ["image"], [pred],
                                                exe, main, scope=scope)
        del scope
        for kind, n in SERVED_TEST_OPS[model].items():
            held = [op for op in program.global_block().ops
                    if op.type == kind]
            check(len(held) == n and all(op.attrs["is_test"] for op in held),
                  "the saved %s has %d %s ops (expected %d), is_test %s"
                  % (model, len(held), kind, n,
                     sorted({op.attrs["is_test"] for op in held})))
        engine = InferenceEngine(model_dir,
                                 batch_buckets=RESNET_SERVE["buckets"])
        torch.cuda.synchronize()
        print("%s serving: built, initialized, saved, loaded and "
              "warmed up (buckets %s) in %.1f s"
              % (model, engine.batch_buckets, time.perf_counter() - t0))
        try:
            def burst():
                return serve_burst(engine, requests, pred.name)

            # the counts: zero just before the main path, read just after
            ck.reset_launch_counts()
            batches0 = engine.metrics.snapshot()["batches_total"]
            answers, latencies, futures, wall = burst()
            counts = ck.launch_counts()
            batches = engine.metrics.snapshot()["batches_total"] - batches0
            for i, a in enumerate(answers):
                rows = requests[i]["image"].shape[0]
                check(a.shape == (rows, classes) and np.isfinite(a).all()
                      and np.allclose(a.sum(1), 1.0, atol=1e-4),
                      "%s answer %d: shape %s, finite %s"
                      % (model, i, a.shape, np.isfinite(a).all()))
            bucket_diff = max(float(np.abs(engine.run_direct(
                requests[i], batch_bucket=fut.bucket[0])[0][pred.name]
                - answers[i]).max()) for i, fut in enumerate(futures))
            check(bucket_diff <= BUCKET_TOL, "%s coalesced answers differ "
                  "from run_direct by %r" % (model, bucket_diff))
            # the same burst again, untraced (the first after warm-up may
            # differ), then traced: the device's busy time over it
            again = sorted(x * 1e3 for x in burst()[1])
            busy_ms, _, n_kernels = profile_step(torch, burst)
            dispatch_ms = {}
            for nb in engine.batch_buckets:
                probe = {"image": requests[0]["image"][:1].repeat(nb, 0)}
                times = []
                for _ in range(5):
                    ts = time.perf_counter()
                    engine.run_direct(probe, batch_bucket=nb)
                    times.append(time.perf_counter() - ts)
                dispatch_ms[nb] = statistics.median(times) * 1e3
        finally:
            engine.close()
        cpu = InferenceEngine(model_dir, device="cpu", batch_buckets=[1],
                              warmup=False)
        try:
            ref = cpu.run_direct({"image": requests[0]["image"][:1]})[0][
                pred.name]
        finally:
            cpu.close()
    cpu_diff = float(np.abs(ref - answers[0][:1]).max())
    check(cpu_diff <= CPU_TOL, "%s card and CPU disagree by %r"
          % (model, cpu_diff))
    lat_ms = sorted(x * 1e3 for x in latencies)
    images = sum(r["image"].shape[0] for r in requests)
    report = {
        "model": model, "requests": n, "images": images, "batches": batches,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)), "wall_s": wall,
        "second_burst_p50_ms": float(np.percentile(again, 50)),
        "images_per_s": images / wall,
        "device_busy_ms": busy_ms,
        # an estimate: the traced burst's device time over the untraced
        # burst's wall time (the trace slows only the host)
        "busy_share_est": busy_ms / (wall * 1e3),
        "device_kernels": n_kernels,
        "run_direct_ms_by_bucket": dispatch_ms,
        "bucket_max_diff": bucket_diff, "cpu_max_diff": cpu_diff,
        "launches": counts, "card": card}
    print("%s serving %s" % (model, json.dumps(report)))
    return (counts, zero_counts(counts)), report


def run_fault_checks(torch):
    """Faults C8 and C9 on the card. C8: sequence_last_step and
    sequence_pool LAST on a padded feed whose @SEQLEN says 5 for a T of
    3 give a NaN row (no device-side assert), the other row its last
    step; the next runs on the same device (an Executor, then an
    InferenceEngine of the same model) still answer like the CPU. C9:
    fused_attention with a kv_len-0 row at T = 8 returns the mean of v
    there and at T = 1024 returns 0 (K1 launched once each), each within
    KERNEL_TOL of the CPU."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.lowering import LowerCtx
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import InferenceEngine

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[2], dtype="float32",
                              lod_level=1)
        outs = [fluid.layers.sequence_last_step(x),
                fluid.layers.sequence_pool(x, "last")]
    rng = np.random.RandomState(SEED + 16)
    padded = rng.randn(2, 3, 2).astype(np.float32)
    bad = {"x": padded, "x@SEQLEN": np.array([5, 1], np.int32)}
    good = {"x": padded, "x@SEQLEN": np.array([3, 1], np.int32)}
    exe, cpu = fluid.Executor(), fluid.Executor("cpu")
    got = exe.run(main, feed=bad, fetch_list=outs, scope=fluid.Scope())
    torch.cuda.synchronize()
    for g in got:
        check(np.isnan(g[0]).all() and np.array_equal(g[1], padded[1, 0]),
              "C8: LAST with a length above T gave %s" % g)
    again = exe.run(main, feed=good, fetch_list=outs, scope=fluid.Scope())
    want = cpu.run(main, feed=good, fetch_list=outs, scope=fluid.Scope())
    check(all(np.array_equal(a, b) for a, b in zip(again, want)),
          "C8: the run after it differs from the CPU")
    with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as model_dir:
        fluid.io.save_inference_model(model_dir, ["x"], outs[:1], cpu, main,
                                      scope=fluid.Scope())
        engine = InferenceEngine(model_dir, batch_buckets=[1],
                                 seq_buckets=[8], warmup=False)
        try:
            seq = [padded[0]]
            answer = engine.run_direct({"x": seq})[0][outs[0].name]
        finally:
            engine.close()
    check(np.array_equal(answer[0], padded[0, -1]),
          "C8: the engine's answer after the NaN run is %s" % answer)
    print("C8: LAST with length 5 > T = 3 on the card: NaN row, no device "
          "assert; the next Executor run and an InferenceEngine request "
          "match the CPU exactly")

    rule = registry.get("fused_attention").lower
    card_dev = fluid.Executor().device
    for t in (8, 1024):
        g = np.random.RandomState(SEED + t)
        q, k, v = (g.randn(2, t, 2, 64).astype(np.float32)
                   for _ in range(3))
        lens = np.array([0, t - 3], np.int32)
        res, launched = [], []
        for dev in (card_dev, torch.device("cpu")):
            ins = {"Q": [torch.from_numpy(q).to(dev)],
                   "K": [torch.from_numpy(k).to(dev)],
                   "V": [torch.from_numpy(v).to(dev)],
                   "KVLen": [torch.from_numpy(lens).to(dev)]}
            ck.reset_launch_counts()
            res.append(rule(LowerCtx(None, dev), ins, {"causal": False})[
                "Out"][0].cpu().numpy())
            launched.append(ck.launch_counts()["flash_attention_fwd"])
        check(launched == [1, 0], "C9: K1 launched %s times (card, CPU), "
              "expected [1, 0]" % launched)
        err = float(np.abs(res[0] - res[1]).max())
        row0 = v[0].mean(axis=0) if t < 1024 else np.zeros((2, 64))
        row_err = float(np.abs(res[0][0] - row0).max())
        print("C9: fused_attention at T = %d with a kv_len-0 row: card vs "
              "CPU max diff %.3e; row 0 vs %s max diff %.3e"
              % (t, err, "mean of v" if t < 1024 else "0", row_err))
        check(err <= KERNEL_TOL and row_err <= KERNEL_TOL,
              "C9 at T = %d: card vs CPU %r, row 0 %r" % (t, err, row_err))


# C12: lax.top_k's order (the lower index first among equal values, NaN
# above inf, +0 above -0), as the JAX package gives it on these rows (the
# CPU tests hold the port to it there): (row, k, indices)
_NAN_ROW = [1.0, float("nan"), 3.0, 3.0, -float("nan"), 2.0, 0.0, -0.0,
            float("inf"), -float("inf")]
TOPK_CASES = (([1.0, 3.0, 3.0, 2.0, 3.0], 3, [1, 2, 4]),
              ([0.0] * 40, 1, [0]),
              (_NAN_ROW, 10, [1, 8, 2, 3, 5, 0, 6, 7, 9, 4]))


def run_topk_abs_checks(torch):
    """Faults C12 and C13 on the card. C12: topk's indices on a tied row,
    a row of zeros and a row with NaN, inf and signed zeros are
    lax.top_k's (TOPK_CASES) and the CPU rule's, its values the CPU's; a
    uniform [4, 10] input with label 0 gives accuracy 1.0 at k 1 and 3.
    C13: the gradient of abs at [-1, 0, 1, 0, 2, -0] is jax.grad(jnp.abs)'s
    [-1, 1, 1, 1, 1, 1]."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.lowering import LowerCtx

    card = fluid.Executor().device
    cpu = torch.device("cpu")

    def rule(op, ins, attrs, dev):
        return registry.get(op).lower(LowerCtx(None, dev), ins, attrs)

    for row, k, want in TOPK_CASES:
        x = torch.tensor([row], dtype=torch.float32)
        got = [rule("topk", {"X": [x.to(dev)]}, {"k": k}, dev)
               for dev in (card, cpu)]
        idx = [g["Indices"][0].cpu().numpy() for g in got]
        vals = [g["Out"][0].cpu().numpy() for g in got]
        check(idx[0].tolist() == [want] and idx[1].tolist() == [want]
              and np.array_equal(vals[0], vals[1], equal_nan=True),
              "C12: topk of %s at k = %d: card %s, CPU %s, lax.top_k %s"
              % (row, k, idx[0].tolist(), idx[1].tolist(), want))
    x = torch.full((4, 10), 0.1, device=card)
    label = torch.zeros((4, 1), dtype=torch.int64, device=card)
    for k in (1, 3):
        top = rule("topk", {"X": [x]}, {"k": k}, card)
        acc = rule("accuracy", {"Indices": top["Indices"], "Label": [label]},
                   {}, card)["Accuracy"][0].item()
        check(acc == 1.0, "C12: accuracy on a uniform row at k = %d is %r"
              % (k, acc))
    print("C12: topk on the card: tied, zero and NaN rows in lax.top_k's "
          "order, equal to the CPU; accuracy 1.0 on a uniform [4, 10] with "
          "label 0")
    x = torch.tensor([-1.0, 0.0, 1.0, 0.0, 2.0, -0.0], device=card,
                     requires_grad=True)
    y = rule("abs", {"X": [x]}, {}, card)["Out"][0]
    grad, = torch.autograd.grad(y.sum(), x)
    check(grad.cpu().tolist() == [-1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
          "C13: the gradient of abs at %s is %s" % (x.tolist(),
                                                   grad.cpu().tolist()))
    print("C13: abs's gradient on the card at [-1, 0, 1, 0, 2, -0]: %s "
          "(jax.grad(jnp.abs): +1 at 0)" % grad.cpu().tolist())


# ------------------------------------------------------------- dense zoo --

def ctr_feed(rng, rows, sparse, with_label=True):
    """rows of the CTR feeds: 13 dense features uniform in [0, 1), one id
    uniform in [0, sparse) for each of the 26 slots, a 0/1 click label."""
    feed = {"dense_input": rng.rand(rows, 13).astype(np.float32)}
    for i in range(26):
        feed["C%d" % i] = rng.randint(0, sparse, (rows, 1)).astype(np.int64)
    if with_label:
        feed["label"] = rng.randint(0, 2, (rows, 1)).astype(np.float32)
    return feed


def rec_feed(fluid, rng, rows, with_score=True, lod=True):
    """rows of the recommender's feeds, the ids drawn within the port's
    movielens metadata: a user (id, gender, age bucket, job), a movie (id,
    1-3 distinct categories and 1-5 title words, as the synthetic tables
    give) and a 1-5 star score. Sequences as LoDTensors, or with lod=False
    as lists of per-row arrays (an InferenceEngine request)."""
    from paddle_tpu_torch.datasets import movielens

    def ids(lo, hi):
        return rng.randint(lo, hi, (rows, 1)).astype(np.int64)

    n_cat = len(movielens.movie_categories())
    n_title = len(movielens.get_movie_title_dict())
    cats = [rng.choice(n_cat, int(rng.randint(1, 4)), replace=False)
            .reshape(-1, 1).astype(np.int64) for _ in range(rows)]
    titles = [rng.randint(0, n_title, (int(rng.randint(1, 6)), 1))
              .astype(np.int64) for _ in range(rows)]
    seq = fluid.LoDTensor.from_sequences if lod else list
    feed = {"user_id": ids(1, movielens.max_user_id() + 1),
            "gender_id": ids(0, 2),
            "age_id": ids(0, len(movielens.age_table)),
            "job_id": ids(0, movielens.max_job_id() + 1),
            "movie_id": ids(1, movielens.max_movie_id() + 1),
            "category_id": seq(cats), "movie_title": seq(titles)}
    if with_score:
        feed["score"] = rng.randint(1, 6, (rows, 1)).astype(np.float32)
    return feed


def w2v_feed(rng, rows, dict_size):
    return {n: rng.randint(0, dict_size, (rows, 1)).astype(np.int64)
            for n in ("firstw", "secondw", "thirdw", "forthw", "nextw")}


def lm_feed(fluid, rng, cfg):
    """cfg["batch"] sentences of random ids, lengths min_len-max_len (one
    at max_len); nextwords is each shifted by one. Returns (feed,
    tokens)."""
    lens = rng.randint(cfg["min_len"], cfg["max_len"] + 1, cfg["batch"])
    lens[0] = cfg["max_len"]
    sents = [rng.randint(0, cfg["vocab"], (int(n) + 1, 1)).astype(np.int64)
             for n in lens]
    lod = fluid.LoDTensor.from_sequences
    return {"words": lod([s[:-1] for s in sents]),
            "nextwords": lod([s[1:] for s in sents])}, int(lens.sum())


def build_dense(fluid, name, cfg, train=True):
    """A dense zoo model at cfg's widths, startup seeded from SEED:
    (main, startup, avg_cost, extra) with extra the CTR's predict, the
    recommender's scale_infer or the LM's ppl (None for word2vec). With
    train=False, the CTR and the recommender are built with no
    optimizer (the programs their servers save)."""
    from paddle_tpu_torch.models import (ctr, language_model,
                                         recommender_system, word2vec)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if name == "ctr":
            _, avg, extra = ctr.build(
                sparse_feature_dim=cfg["sparse"], embedding_size=cfg["emb"],
                hidden_sizes=cfg["hidden"], learning_rate=cfg["lr"],
                with_optimizer=train)
        elif name == "recommender":
            if train:
                extra, avg = recommender_system.build_train(
                    cfg["lr"], cfg["emb"], cfg["fc"])
            else:
                extra, avg = recommender_system.model(cfg["emb"],
                                                      cfg["fc"])
        elif name == "word2vec":
            _, avg = word2vec.build(cfg["dict_size"], cfg["embed"],
                                    cfg["hidden"], learning_rate=cfg["lr"])
            extra = None
        else:
            _, _, avg, extra = language_model.build(
                cfg["vocab"], cfg["emb"], cfg["hidden"], cfg["layers"],
                learning_rate=cfg["lr"])
    return main, startup, avg, extra


def k9_per_run(ops):
    """K9 launches one run of a program predicts: one per SUM / AVERAGE /
    SQRT sequence_pool (every such pool of the ported models is fp32)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    return {"masked_pool": sum(op.type == "sequence_pool"
                               and op.attrs.get("pooltype") in ck.POOL_TYPES
                               for op in ops)}


def run_dense_training(torch, card, name, trace_path=None):
    """Training of one dense zoo model at its defaults: TRAIN_STEPS steps
    of one batch through Executor.run and a traced one (train_steps: step
    time, rows or tokens a second, peak memory, launches a step, the
    device's idle share). The CTR at batch 1024, the recommender at 256,
    word2vec at 128 and the LM at 20 sentences, whose ppl fetch must be
    exp(avg_cost). Returns ((launch counts, the counts predicted), the
    report)."""
    import paddle_tpu_torch as fluid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = {"ctr": CTR, "recommender": REC, "word2vec": W2V,
           "language_model": LM}[name]
    tag = "%s training:" % name
    t0 = time.perf_counter()
    main, startup, avg, extra = build_dense(fluid, name, cfg)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(scope.get(p.name).shape))
                   for p in main.all_parameters())
    rng = np.random.RandomState(SEED + 17)
    if name == "ctr":
        feed, work, unit = ctr_feed(rng, cfg["batch"], cfg["sparse"]), \
            cfg["batch"], "rows"
    elif name == "recommender":
        feed, work, unit = rec_feed(fluid, rng, cfg["batch"]), \
            cfg["batch"], "rows"
    elif name == "word2vec":
        feed, work, unit = w2v_feed(rng, cfg["batch"], cfg["dict_size"]), \
            cfg["batch"], "rows"
    else:
        (feed, work), unit = lm_feed(fluid, rng, cfg), "tokens"
    ops = main.global_block().ops
    print("%s built (%d parameters, %d ops) and ran its startup program in "
          "%.1f s" % (tag, n_params, len(ops), time.perf_counter() - t0))
    report, counts, steps = train_steps(torch, tag, exe, main, feed, avg,
                                        scope, trace_path, work, unit)
    if name == "language_model":
        cost, ppl = exe.run(main, feed=feed, fetch_list=[avg, extra],
                            scope=scope)
        check(np.isfinite(ppl).all() and np.allclose(
            ppl, np.exp(cost), rtol=1e-6),
            "LM ppl %s is not exp(avg_cost %s)" % (ppl, cost))
        report["ppl"] = float(ppl.reshape(-1)[0])
    expected = dict.fromkeys(counts, 0)
    expected.update({k: n * steps for k, n in k9_per_run(ops).items()})
    print("%s launches %s over %d steps (expected %s)"
          % (tag, counts, steps, expected))
    report = {"batch": cfg["batch"], unit: work, "parameters": n_params,
              **report, "card": card}
    print("%s %s" % (tag, json.dumps(report)))
    del scope
    torch.cuda.empty_cache()
    return (counts, expected), report


def run_dense_serving(torch, card, name):
    """Serving of the CTR (its predict, with no optimizer; 16 concurrent
    requests of 1-64 rows through InferenceEngine(batch_buckets=[1, 64,
    256])) or the recommender (scale_infer with LoD feeds, 16 requests of
    1-8 user-movie pairs, batch buckets [1, 8, 32], seq bucket 8), built
    and initialized on the card from SEED and saved by
    save_inference_model. Checks each answer's shape and range, each
    equal to run_direct at its bucket (<= BUCKET_TOL), request 0 against
    the CPU (<= SEQ_CPU_TOL); the burst again for its p50 and once more
    under the profiler for the device's busy share. Returns ((launch
    counts, the counts predicted: K9 twice a recommender dispatch), the
    report)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import recommender_system
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, serve = (CTR, CTR_SERVE) if name == "ctr" else (REC, REC_SERVE)
    tag = "%s serving:" % name
    t0 = time.perf_counter()
    main, startup, _, pred = build_dense(fluid, name, cfg, train=False)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED + 18)
    lo, hi = serve["rows"] if name == "ctr" else serve["pairs"]
    sizes = rng.randint(lo, hi + 1, serve["requests"])
    if name == "ctr":
        feeds = ["dense_input"] + ["C%d" % i for i in range(26)]
        requests = [ctr_feed(rng, int(k), cfg["sparse"], with_label=False)
                    for k in sizes]
        lo_ans, hi_ans = 0.0, 1.0
    else:
        feeds = recommender_system.FEED_ORDER[:-1]
        requests = [rec_feed(fluid, rng, int(k), with_score=False,
                             lod=False) for k in sizes]
        lo_ans, hi_ans = -5.0, 5.0
    with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as model_dir:
        fluid.io.save_inference_model(model_dir, feeds, [pred], exe, main,
                                      scope=scope)
        del scope
        engine = InferenceEngine(model_dir, batch_buckets=serve["buckets"],
                                 seq_buckets=serve.get("seq_buckets"))
        torch.cuda.synchronize()
        per = k9_per_run(engine.program.global_block().ops)
        print("%s built, initialized, saved, loaded and warmed up (buckets "
              "%s, seq %s) in %.1f s; launches predicted per dispatch %s"
              % (tag, engine.batch_buckets, engine.seq_buckets,
                 time.perf_counter() - t0, per))
        try:
            # the counts: zero just before the main path, read just after
            ck.reset_launch_counts()
            batches0 = engine.metrics.snapshot()["batches_total"]
            answers, latencies, futures, wall = serve_burst(
                engine, requests, pred.name)
            counts = ck.launch_counts()
            batches = engine.metrics.snapshot()["batches_total"] - batches0
            for i, a in enumerate(answers):
                check(a.shape == (int(sizes[i]), 1) and np.isfinite(a).all()
                      and a.min() >= lo_ans and a.max() <= hi_ans,
                      "%s answer %d: shape %s, range [%r, %r]"
                      % (tag, i, a.shape, float(a.min()), float(a.max())))
            bucket_diff = 0.0
            for i, fut in enumerate(futures):
                direct, bucket = engine.run_direct(
                    requests[i], batch_bucket=fut.bucket[0],
                    seq_bucket=fut.bucket[1])
                check(bucket == fut.bucket, "run_direct ran at %s, the "
                      "future recorded %s" % (bucket, fut.bucket))
                bucket_diff = max(bucket_diff, float(np.abs(
                    direct[pred.name] - answers[i]).max()))
            check(bucket_diff <= BUCKET_TOL, "%s coalesced answers differ "
                  "from run_direct by %r" % (tag, bucket_diff))
            again = sorted(x * 1e3 for x in serve_burst(
                engine, requests, pred.name)[1])
            busy_ms, _, n_kernels = profile_step(
                torch, lambda: serve_burst(engine, requests, pred.name))
        finally:
            engine.close()
        cpu = InferenceEngine(model_dir, device="cpu", batch_buckets=[hi],
                              seq_buckets=serve.get("seq_buckets"),
                              warmup=False)
        try:
            ref = cpu.run_direct(requests[0])[0][pred.name]
        finally:
            cpu.close()
    cpu_diff = float(np.abs(ref - answers[0]).max())
    check(cpu_diff <= SEQ_CPU_TOL, "%s card and CPU disagree by %r"
          % (tag, cpu_diff))
    expected = dict.fromkeys(counts, 0)
    expected.update({k: v * batches for k, v in per.items()})
    rows = int(sizes.sum())
    lat_ms = sorted(x * 1e3 for x in latencies)
    report = {
        "requests": len(requests), "rows": rows, "batches": batches,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)), "wall_s": wall,
        "second_burst_p50_ms": float(np.percentile(again, 50)),
        "rows_per_s": rows / wall, "device_busy_ms": busy_ms,
        # the traced burst's device time over the untraced one's wall
        "busy_share_est": busy_ms / (wall * 1e3),
        "device_kernels": n_kernels, "bucket_max_diff": bucket_diff,
        "cpu_max_diff": cpu_diff, "launches": counts, "card": card}
    print("%s %s" % (tag, json.dumps(report)))
    torch.cuda.empty_cache()
    return (counts, expected), report


def run_dense_vs_cpu(torch):
    """One step of each dense zoo model at its zoo config (models/zoo.py:
    ctr at 1000 ids and width 8, word2vec at 100 words, widths 8 / 16, the
    recommender at widths 8 / 16, the LM at vocabulary 120, widths 8, 2
    layers) on the card and on the CPU from the CPU startup state, held by
    step_vs_cpu (phase 5's tolerances)."""
    import paddle_tpu_torch as fluid

    rng = np.random.RandomState(SEED + 19)
    small = {"ctr": (dict(CTR, sparse=1000, emb=8), 16),
             "recommender": (dict(REC, emb=8, fc=16), 16),
             "word2vec": (dict(W2V, dict_size=100, embed=8, hidden=16), 16),
             "language_model": (dict(LM, vocab=120, emb=8, hidden=8,
                                     batch=4, min_len=1, max_len=12), 4)}
    for name, (cfg, rows) in small.items():
        main, startup, avg, _ = build_dense(fluid, name, cfg)
        if name == "ctr":
            feed = ctr_feed(rng, rows, cfg["sparse"])
        elif name == "recommender":
            feed = rec_feed(fluid, rng, rows)
        elif name == "word2vec":
            feed = w2v_feed(rng, rows, cfg["dict_size"])
        else:
            feed = lm_feed(fluid, rng, cfg)[0]
        step_vs_cpu(main, startup, avg, feed, cfg["lr"],
                    "%s: one step at the zoo config, batch %d" % (name, rows))


FIT_OPTIMIZERS = (
    ("Adamax", dict(learning_rate=0.01)),
    ("DecayedAdagrad", dict(learning_rate=0.01)),
    ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    ("RMSProp", dict(learning_rate=0.01, momentum=0.9)),
    ("Ftrl", dict(learning_rate=0.1, l1=0.01, l2=0.01)),
    ("Ftrl", dict(learning_rate=0.1, l1=0.01, l2=0.01, lr_power=-0.3)),
    ("ProximalGD", dict(learning_rate=0.05, l1=0.01, l2=0.01)),
    ("ProximalAdagrad", dict(learning_rate=0.05, l1=0.01, l2=0.01)),
)
FIT_SCHEDULES = (
    ("exponential_decay", (0.1, 2, 0.5), dict(staircase=True)),
    ("natural_exp_decay", (0.1, 2, 0.5), dict(staircase=True)),
    ("inverse_time_decay", (0.1, 2, 0.5), dict(staircase=True)),
    ("polynomial_decay", (0.1, 4, 0.01), dict(power=2.0)),
    ("polynomial_decay", (0.1, 2, 0.01), dict(power=2.0, cycle=True)),
    ("piecewise_decay", ([2, 4], [0.1, 0.05, 0.01]), {}),
)


def build_fit_a_line(fluid, optimizer=None, schedule=None, average=False,
                     clip=None):
    """Book chapter 01: fc(13 -> 1), square_error_cost, mean, under one of
    FIT_OPTIMIZERS, or SGD on one of FIT_SCHEDULES, or SGD(0.05) with one
    of CLIPS (a gradient clip on every parameter, or an error clip on the
    prediction), or SGD(0.05) with a ModelAverage after it. Returns (main,
    startup, avg_cost, lr or the ModelAverage)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        avg = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        extra = None
        if optimizer is not None:
            getattr(fluid.optimizer, optimizer[0])(**optimizer[1]) \
                .minimize(avg)
        elif schedule is not None:
            extra = getattr(fluid.layers, schedule[0])(*schedule[1],
                                                       **schedule[2])
            fluid.optimizer.SGD(learning_rate=extra).minimize(avg)
        elif clip is not None:
            attr = getattr(fluid.clip, clip[0])(**clip[1])
            if clip[0] == "ErrorClipByValue":
                pred.error_clip = attr
            else:
                fluid.clip.set_gradient_clip(attr)
            fluid.optimizer.SGD(learning_rate=0.05).minimize(avg)
        else:
            fluid.optimizer.SGD(learning_rate=0.05).minimize(avg)
            extra = fluid.optimizer.ModelAverage(0.15)
    return main, startup, avg, extra


def fit_feeds():
    """One batch of fit_a_line for every step (y = x w for a random w), so
    that every optimizer's loss falls from step to step."""
    rng = np.random.RandomState(SEED + 20)
    w = rng.randn(13, 1).astype(np.float32)
    x = rng.rand(OPT_BATCH, 13).astype(np.float32)
    return [{"x": x, "y": x @ w}] * OPT_STEPS


def run_optimizers_vs_cpu(torch, card):
    """Phase 18: fit_a_line under each of FIT_OPTIMIZERS and under SGD on
    each of FIT_SCHEDULES, OPT_STEPS steps from one state (the CPU startup
    program's) on the card and on the CPU: each loss (and learning rate)
    within OPT_LOSS_RTOL, every persistable after the steps within
    OPT_STATE_TOL of its largest value, the losses falling on the card.
    ModelAverage: apply() on the card swaps in sum / count as on the CPU,
    restore() puts the trained parameters back exactly. Each schedule's
    program alone runs three times on the card under
    torch.cuda.set_sync_debug_mode("error"): its Switch and
    conditional_blocks read no value on the host. Returns ((launch counts
    of the card's runs, the counts predicted: none), the report)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.ops import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    feeds = fit_feeds()
    cases = [("%s%s" % (o[0], "(lr_power=%s)" % o[1]["lr_power"]
                        if "lr_power" in o[1] else ""),
              dict(optimizer=o)) for o in FIT_OPTIMIZERS]
    cases += [("SGD on %s%s" % (s[0], "(cycle)" if s[2].get("cycle")
                                else ""), dict(schedule=s))
              for s in FIT_SCHEDULES]
    cases.append(("SGD + ModelAverage", dict(average=True)))
    counts = None
    worst = {"loss": 0.0, "state": 0.0}
    report = {}
    for what, kwargs in cases:
        main, startup, avg, extra = build_fit_a_line(fluid, **kwargs)
        cpu, cpu_scope = fluid.Executor("cpu"), fluid.Scope()
        cpu.run(startup, scope=cpu_scope)
        state = {v.name: cpu_scope.get(v.name).numpy().copy()
                 for v in main.list_vars() if v.persistable}
        card_scope = pio.scope_from_numpy(state, "cuda", program=main)
        fetch = [avg] + ([extra] if "schedule" in kwargs else [])
        exe = fluid.Executor()
        ck.reset_launch_counts()
        got = [exe.run(main, feed=f, fetch_list=fetch, scope=card_scope)
               for f in feeds]
        c = ck.launch_counts()
        counts = c if counts is None else {k: counts[k] + c[k] for k in c}
        want = [cpu.run(main, feed=f, fetch_list=fetch, scope=cpu_scope)
                for f in feeds]
        loss_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                       for g, w in zip(got, want) for a, b in zip(g, w))
        state_err = max(float(np.abs(card_scope.get(n).cpu().numpy()
                                     - cpu_scope.get(n).numpy()).max()
                              / max(np.abs(cpu_scope.get(n).numpy()).max(),
                                    1e-30)) for n in state)
        losses = [float(g[0][0]) for g in got]
        print("optimizers: %s, %d steps, card vs CPU: losses %s, max loss%s "
              "error %.3e, max persistable error %.3e of its largest value"
              % (what, OPT_STEPS, ["%.5f" % x for x in losses],
                 " / lr" if "schedule" in kwargs else "", loss_err,
                 state_err))
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              "%s: the card's losses %s" % (what, losses))
        check(loss_err <= OPT_LOSS_RTOL and state_err <= OPT_STATE_TOL,
              "%s: card and CPU differ (loss %r, state %r)"
              % (what, loss_err, state_err))
        worst["loss"] = max(worst["loss"], loss_err)
        worst["state"] = max(worst["state"], state_err)
        report[what] = {"loss_err": loss_err, "state_err": state_err,
                        "first_loss": losses[0], "last_loss": losses[-1]}
        if "average" in kwargs:
            params = [p.name for p in main.all_parameters()]
            trained = {n: card_scope.get(n).clone() for n in params}
            with extra.apply(cpu, scope=cpu_scope):
                cpu_avg = {n: cpu_scope.get(n).numpy().copy()
                           for n in params}
            with extra.apply(exe, need_restore=False, scope=card_scope):
                avg_err = max(float(np.abs(card_scope.get(n).cpu().numpy()
                                           - cpu_avg[n]).max())
                              for n in params)
                moved = all(not torch.equal(card_scope.get(n), trained[n])
                            for n in params)
            extra.restore(exe)
            back = all(torch.equal(card_scope.get(n), trained[n])
                       for n in params)
            print("optimizers: ModelAverage apply on the card vs the CPU: "
                  "max diff %.3e; restore puts the trained parameters back "
                  "exactly: %s" % (avg_err, back))
            check(moved and back and avg_err <= OPT_STATE_TOL,
                  "ModelAverage on the card: moved %s, restored %s, diff "
                  "%r" % (moved, back, avg_err))
            report[what]["average_err"] = avg_err
    for name, args, kw in FIT_SCHEDULES:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            lr = getattr(fluid.layers, name)(*args, **kw)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lrs = [exe.run(main, fetch_list=[lr], scope=scope,
                           return_numpy=False)[0] for _ in range(3)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print("optimizers: %s%s alone, 3 runs under sync debug mode "
              "'error': lr %s" % (name, "(cycle)" if kw.get("cycle")
                                    else "",
                                    [float(x[0]) for x in lrs]))
    report["max_loss_err"] = worst["loss"]
    report["max_state_err"] = worst["state"]
    report["card"] = card
    print("optimizers: " + json.dumps(report))
    return (counts, dict.fromkeys(counts, 0)), report


# ------------------------------------------------ image nets, clipping --

# the JAX zoo's other image nets: build_train(model) at its defaults (3 x
# 224 x 224, 1000 classes, Momentum 0.01 / 0.9), each with its dropout
IMAGE_NETS = ("vgg16", "alexnet", "googlenet", "se_resnext50")
# the card-vs-CPU step's image side per net, the CPU tests'
# (tests/test_torch_image_nets.py and the nets' own files): alexnet's
# stride-4 conv and three 3 x 3 / 2 pools leave nothing below a side of 67
IMAGE_NETS_SMALL = {"vgg16": 32, "alexnet": 67, "googlenet": 64,
                    "se_resnext50": 32}
# its bounds on ||card - cpu|| / ||cpu||, per gradient and for their
# median: 10x each net's own readings on an NVIDIA H100 80GB HBM3 at 700 W
# (fp32, TF32 off; PERF.md section 4 gives them)
IMAGE_NETS_GRAD_BOUNDS = {"vgg16": (2.6e-4, 2.0e-4),
                          "alexnet": (1.1e-5, 5.3e-6),
                          "googlenet": (1.2e-5, 6.8e-6),
                          "se_resnext50": (1.4e-3, 1.0e-3)}
# a bias before a batch_norm has a gradient of 0 in exact arithmetic (the
# batch_norm takes the mean out), so ||card - cpu|| / ||cpu|| of it says
# nothing: it is held to this share of the largest gradient's norm (10x
# vgg16's 14 such biases' worst reading, 9.1e-8, on the same card)
IMAGE_NETS_BIAS_FLOOR = 1e-6


def run_image_nets_vs_cpu(torch):
    """One step of each of IMAGE_NETS at IMAGE_NETS_SMALL's side, 10
    classes, batch 8, Momentum(1e-4), fp32 (TF32 off), on the card and on
    the CPU from the CPU startup program's state and one batch, with every
    dropout op's dropout_prob set to 0 in the built Program (the two
    devices' random streams differ; at p = 0 both masks are all ones):
    hold_fp32_grads with IMAGE_NETS_GRAD_BOUNDS, the biases before a
    batch_norm held to IMAGE_NETS_BIAS_FLOOR. Returns {net: its
    errors}."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    for model in IMAGE_NETS:
        cfg = dict(RESNET_SMALL, image=IMAGE_NETS_SMALL[model])
        main, startup, avg_cost = build_resnet(fluid, False, cfg, model)
        drops = [op for op in main.global_block().ops if op.type == "dropout"]
        for op in drops:
            op.attrs["dropout_prob"] = 0.0
        for op in main.global_block().ops:
            if op.type == "grad_of" and op.attrs["fwd_type"] == "dropout":
                op.attrs["fwd_attrs"]["dropout_prob"] = 0.0
        cpu = fluid.Executor("cpu")
        scope0 = fluid.Scope()
        cpu.run(startup, scope=scope0)
        state = {v.name: scope0.get(v.name).numpy().copy()
                 for v in main.list_vars() if v.persistable}
        grads = sorted(p.name + "@GRAD" for p in main.all_parameters()
                       if p.trainable)
        feed = image_feed(cfg, SEED + 21)
        fetch = [avg_cost.name] + grads
        got, want = (fluid.Executor(dev).run(
            main, feed=feed, fetch_list=fetch,
            scope=pio.scope_from_numpy(state, dev, program=main))
            for dev in ("cuda", "cpu"))
        check(len(drops) == {"vgg16": 1, "alexnet": 2}.get(model, 1),
              "%s has %d dropout ops" % (model, len(drops)))
        ops = main.global_block().ops
        bn_in = {op.inputs["X"][0] for op in ops if op.type == "batch_norm"}
        floored = {op.inputs["Y"][0] + "@GRAD" for op in ops
                   if op.type == "elementwise_add"
                   and op.outputs["Out"][0] in bn_in}
        report[model] = hold_fp32_grads(
            "image nets: %s, one step at %d x %d, batch %d, %d dropout at p "
            "= 0, card vs CPU" % (model, cfg["image"], cfg["image"],
                                  cfg["batch"], len(drops)),
            grads, (float(got[0][0]), got[1:]),
            (float(want[0][0]), want[1:]), *IMAGE_NETS_GRAD_BOUNDS[model],
            floored=floored)
    return report


# fit_a_line's clips (clip.py): the gradient clips on every parameter, the
# error clip on the prediction's gradient (2 (pred - y) / batch). Their
# limits bite at the first steps (the CPU tests show each changes the
# losses).
CLIPS = (("GradientClipByValue", dict(max=0.5)),
         ("GradientClipByNorm", dict(clip_norm=0.5)),
         ("GradientClipByGlobalNorm", dict(clip_norm=0.5)),
         ("ErrorClipByValue", dict(max=0.02)))


def run_clipping_vs_cpu(torch, card):
    """Fit_a_line under each of CLIPS with SGD(0.05), OPT_STEPS steps from
    one state (the CPU startup program's) on the card and on the CPU. The
    card's steps run under torch.cuda.set_sync_debug_mode("error"), their
    feeds placed on the card first and their losses fetched as device
    tensors: no clip rule reads a value on the host. Each loss within
    OPT_LOSS_RTOL, every persistable after the steps within OPT_STATE_TOL
    of its largest value, and the CPU's clipped losses differ from its
    unclipped ones (the clip bites). Returns ((launch counts, the counts
    predicted: none), the report)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.ops import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    feeds = fit_feeds()

    def cpu_losses(main, startup, avg):
        cpu, scope = fluid.Executor("cpu"), fluid.Scope()
        cpu.run(startup, scope=scope)
        state = {v.name: scope.get(v.name).numpy().copy()
                 for v in main.list_vars() if v.persistable}
        return state, scope, [float(cpu.run(main, feed=f, fetch_list=[avg],
                                            scope=scope)[0][0])
                              for f in feeds]

    plain = cpu_losses(*build_fit_a_line(fluid)[:3])[2]
    counts, report = None, {}
    for name, kwargs in CLIPS:
        main, startup, avg, _ = build_fit_a_line(fluid, clip=(name, kwargs))
        state, cpu_scope, want = cpu_losses(main, startup, avg)
        exe = fluid.Executor()
        card_scope = pio.scope_from_numpy(state, exe.device, program=main)
        card_feeds = [{k: torch.from_numpy(v).to(exe.device)
                       for k, v in f.items()} for f in feeds]
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = [exe.run(main, feed=f, fetch_list=[avg], scope=card_scope,
                           return_numpy=False)[0] for f in card_feeds]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        c = ck.launch_counts()
        counts = c if counts is None else {k: counts[k] + c[k] for k in c}
        got = [float(x.reshape(-1)[0]) for x in got]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        state_err = max(float(np.abs(card_scope.get(n).cpu().numpy()
                                     - cpu_scope.get(n).numpy()).max()
                              / max(np.abs(cpu_scope.get(n).numpy()).max(),
                                    1e-30)) for n in state)
        bite = max(abs(a - b) for a, b in zip(want, plain))
        ops = sorted({op.type for op in main.global_block().ops
                      if "clip" in op.type or op.type in (
                          "reduce_sum_square", "global_norm_scale")})
        print("clipping: %s(%s), %d steps under sync debug mode 'error', "
              "card vs CPU: losses %s, max loss error %.3e, max persistable "
              "error %.3e; clip ops %s; the CPU's losses move %.3e from the "
              "unclipped run's" % (name, kwargs, OPT_STEPS,
                                   ["%.5f" % x for x in got], loss_err,
                                   state_err, ops, bite))
        check(all(np.isfinite(got)) and loss_err <= OPT_LOSS_RTOL
              and state_err <= OPT_STATE_TOL,
              "%s: card and CPU differ (loss %r, state %r)"
              % (name, loss_err, state_err))
        check(bite > 0, "%s did not change the losses" % name)
        report[name] = {"loss_err": loss_err, "state_err": state_err,
                        "bite": bite}
    report["card"] = card
    print("clipping: " + json.dumps(report))
    return (counts, dict.fromkeys(counts, 0)), report


def run_lm_clip_training(torch, card, trace_path=None):
    """The PTB LM of phase 17 (LM: its defaults) built as
    language_model.build builds it, but with GradientClipByGlobalNorm(5.0)
    on every parameter before Adam: TRAIN_STEPS steps and a traced one
    (train_steps). What the clip costs a step, beside phase 17's LM.
    Returns ((launch counts, the counts predicted: none), the report)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import language_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LM
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        # is_test builds the training graph without its optimizer (the LM
        # has no dropout at its defaults)
        _, _, avg, _ = language_model.build(
            cfg["vocab"], cfg["emb"], cfg["hidden"], cfg["layers"],
            learning_rate=cfg["lr"], is_test=True)
        fluid.clip.set_gradient_clip(fluid.GradientClipByGlobalNorm(5.0))
        fluid.optimizer.Adam(learning_rate=cfg["lr"]).minimize(avg)
    ops = main.global_block().ops
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    feed, tokens = lm_feed(fluid, np.random.RandomState(SEED + 17), cfg)
    tag = "language_model clip training:"
    print("%s %d ops, %d reduce_sum_square, %d global_norm_scale"
          % (tag, len(ops), sum(op.type == "reduce_sum_square" for op in ops),
             sum(op.type == "global_norm_scale" for op in ops)))
    report, counts, _ = train_steps(torch, tag, exe, main, feed, avg, scope,
                                    trace_path, tokens, "tokens")
    report = {"clip": "GradientClipByGlobalNorm(5.0)", "tokens": tokens,
              **report, "card": card}
    print("%s %s" % (tag, json.dumps(report)))
    del scope
    torch.cuda.empty_cache()
    return (counts, dict.fromkeys(counts, 0)), report


# ------------------------------------------------------------ multi-step --

# phase 25: Executor.run(steps=K) on seven training paths, each at the
# full width of the phase named
MULTISTEP_PATHS = (
    ("transformer_fp32", "phase 5"), ("transformer_bf16", "phase 19"),
    ("transformer_dropout", "phase 20"), ("language_model", "phase 17"),
    ("stacked_lstm", "phase 7"), ("acoustic", "phase 10"),
    ("srl", "phase 28"))
# depth of a phase 25 path where it is cut for the 1200 s budget: the
# graph is held against eager steps of the same program, and the full
# depth trains in the path's own phase (Transformer-base in bf16 keeps
# its 6 + 6 layers: phases 32-36 run it)
MULTISTEP_LAYERS = {"transformer_fp32": 2, "transformer_dropout": 2,
                    "acoustic": 1, "srl": 1}
MULTISTEP_K = 4          # steps a call
MULTISTEP_TIMED = 2      # timed calls at each K
MULTISTEP_GAP = 10       # graph vs eager within 10x two eager runs' gap
MEAN_RTOL = 1e-6         # fetch_reduce="mean" against the eager losses


def multistep_program(fluid, path, layers=None):
    """(main, startup, avg_cost, feed) of a phase 25 path, built and fed as
    the phase it comes from builds and feeds it; `layers` cuts the depth
    of a Transformer, DeepASR or the SRL (MULTISTEP_LAYERS)."""
    if path.startswith("transformer_"):
        from paddle_tpu_torch.models import transformer
        variant = path[len("transformer_"):]
        main, startup, avg = build_train(fluid, transformer,
                                         layers or N_LAYER, variant=variant)
        rng = np.random.RandomState(SEED)
        t_max = MODEL["max_length"]
        srcs = [rng.randint(3, MODEL["vocab"], t_max).tolist()
                for _ in range(TRAIN_BATCH)]
        dense = not TRAIN_VARIANTS[variant].get("use_fused_attention")
        feed = transformer.prepare_batch(
            srcs, srcs, t_max, labels=True,
            n_head=MODEL["n_head"] if dense else None)
        return main, startup, avg, feed
    if path == "language_model":
        main, startup, avg, _ = build_dense(fluid, "language_model", LM)
        feed, _ = lm_feed(fluid, np.random.RandomState(SEED + 17), LM)
        return main, startup, avg, feed
    if path == "stacked_lstm":
        cfg = SEQ_TRAIN
        main, startup, avg = build_sentiment_train(
            fluid, cfg["stacked"], cfg["vocab"], cfg["hid"])
        rng = np.random.RandomState(SEED)
        seqs = [rng.randint(1, cfg["vocab"], (cfg["seq"], 1)).astype("int64")
                for _ in range(cfg["batch"])]
        feed = {"words": fluid.LoDTensor.from_sequences(seqs),
                "label": rng.randint(0, 2, (cfg["batch"], 1)).astype(
                    "int64")}
        return main, startup, avg, feed
    if path == "srl":
        main, startup, names, avg, _, _ = build_srl(
            fluid, dict(SRL, lr=SRL_LR, depth=layers or SRL["depth"]))
        rng = np.random.RandomState(SEED + 280)
        lens = rng.randint(SRL["min_len"], SRL["max_len"] + 1, SRL["batch"])
        lens[0] = SRL["max_len"]
        return main, startup, avg, srl_feed(
            fluid, names, srl_rows(rng, SRL, SRL["batch"], lens))
    main, startup, avg = build_acoustic(
        fluid, dict(ASR, layers=layers or ASR["layers"]), train=True)
    rng = np.random.RandomState(SEED + 9)
    lens = rng.randint(ASR["min_len"], ASR["max_len"] + 1, size=ASR["batch"])
    lens[0] = ASR["max_len"]
    return main, startup, avg, asr_feed(fluid, ASR, lens, SEED + 10)


def host_state(scope):
    """Every tensor of the scope, on the host (a reader's host-side state
    is no tensor)."""
    import torch
    return {n: scope.get(n).detach().cpu() for n in scope.names()
            if isinstance(scope.get(n), torch.Tensor)}


def state_diff(torch, ref, got):
    """(every array bit-identical, the largest max |got - ref| / max
    |ref| over the arrays, its name) of two {name: host tensor}."""
    check(sorted(ref) == sorted(got), "the arrays differ in names: %s"
          % sorted(set(ref) ^ set(got)))
    same, worst, where = True, 0.0, None
    for n in sorted(ref):
        a, b = ref[n], got[n]
        check(a.shape == b.shape and a.dtype == b.dtype,
              "%s: %s %s against %s %s" % (n, tuple(b.shape), b.dtype,
                                          tuple(a.shape), a.dtype))
        if torch.equal(a, b):
            continue
        same = False
        a, b = a.double(), b.double()
        d = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
        if d > worst or where is None:
            worst, where = d, n
    return same, worst, where


def call_ms(torch, fn):
    """Host wall ms of fn() and a synchronize after it."""
    torch.cuda.synchronize()
    ts = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - ts) * 1e3


def device_trace(torch, fn):
    """(device ms, of which the port's kernels', host wall ms, device
    kernels: copies and fills not counted) of fn() under torch.profiler,
    tracing the device only (no host ops: their events cost seconds to
    record and process, and slow the host the wall measures)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - ts) * 1e3
    busy = port = 0.0
    kernels = 0
    for name, us in device_events(torch, prof):
        busy += us / 1e3
        if any(k in name.lower() for k in PORT_KERNEL_PARTS):
            port += us / 1e3
        kernels += not name.startswith(("Memcpy", "Memset"))
    return busy, port, wall, kernels


def device_busy_ms(torch, fn):
    """(device ms, of which the port's kernels', host wall ms) of fn():
    `device_trace` without the kernel count."""
    return device_trace(torch, fn)[:3]


def run_multistep(torch, card, path, reduce_check=False):
    """Phase 25 on one path (see the module's docstring). Returns ((the
    launch counts of the second steps=4 call, 4 x one eager step's), the
    report)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k = MULTISTEP_K
    tag = "multistep %s:" % path
    t0 = time.perf_counter()
    main, startup, avg_cost, feed = multistep_program(
        fluid, path, MULTISTEP_LAYERS.get(path))
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get(n).clone() for n in scope.names()}
    counter = scope._rng_counter
    del scope
    print("%s built and initialized in %.1f s"
          % (tag, time.perf_counter() - t0))

    def fresh():
        s = fluid.Scope()
        for n, v in init.items():
            s.set(n, v.clone())
        s._rng_counter = counter
        return s

    def run(scope, steps, fetch_reduce="stack", return_numpy=True):
        return exe.run(main, feed=feed, fetch_list=[avg_cost], scope=scope,
                       steps=steps, fetch_reduce=fetch_reduce,
                       return_numpy=return_numpy)[0]

    # The comparison runs under torch.use_deterministic_algorithms, so
    # index_add_ (the embeddings' backward) sums in a fixed order: left
    # to its atomics the order varies from run to run, and Adam turns a
    # near-zero gradient's flipped sign into a step of ~lr, so any two
    # runs could differ by a few such steps in any array. Two eager runs
    # of k steps from the same state and seed counter: the reference, and
    # how far two eager runs differ; then one steps=k call.
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager, step_ms = [], []
        for i in range(2):
            s = fresh()
            ck.reset_launch_counts()
            losses = []
            for _ in range(k):
                ts = time.perf_counter()
                losses.append(run(s, 1))
                step_ms.append((time.perf_counter() - ts) * 1e3)
            eager_counts = ck.launch_counts()
            state = host_state(s)
            state["@losses"] = torch.from_numpy(np.stack(losses))
            eager.append(state)
            del s
        torch.cuda.empty_cache()
        eager_same, eager_gap, gap_at = state_diff(torch, eager[0],
                                                   eager[1])
        s = fresh()
        stacked = run(s, k)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    check(stacked.shape[0] == k, "%s stacked fetch of shape %s"
          % (tag, stacked.shape))
    graph = host_state(s)
    graph["@losses"] = torch.from_numpy(stacked)
    same, err, err_at = state_diff(torch, eager[0], graph)
    if eager_same:
        case = "bit-identical"
        check(same, "%s two eager runs agree bit for bit, the graph's run "
              "differs from them (%s by %r)" % (tag, err_at, err))
    else:
        case = "within %dx the eager gap" % MULTISTEP_GAP
        check(err <= MULTISTEP_GAP * eager_gap,
              "%s graph vs eager %r (%s) > %d x two eager runs' %r (%s)"
              % (tag, err, err_at, MULTISTEP_GAP, eager_gap, gap_at))
    exe._cache.clear()
    torch.cuda.empty_cache()

    # the default runner, from where that call left the state: its first
    # call (warm-up, capture and k replays), then the second call: no
    # host sync, the kernels' counts k x one eager step's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    ts = time.perf_counter()
    run(s, k, return_numpy=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - ts
    runner = next(reversed(exe._cache.values()))
    check(runner._graph is not None, "%s steps=%d ran no CUDA graph"
          % (tag, k))
    # the second call: no host sync, the kernels' counts k x one step's
    ck.reset_launch_counts()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts = time.perf_counter()
        run(s, k, return_numpy=False)
        enqueue_ms = (time.perf_counter() - ts) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    check(counts == eager_counts, "%s the second steps=%d call launched %s, "
          "%d eager steps %s" % (tag, k, counts, k, eager_counts))
    peak = torch.cuda.max_memory_allocated()
    times = {k: sorted(call_ms(torch, lambda: run(s, k, return_numpy=False))
                       for _ in range(MULTISTEP_TIMED))}
    busy, port, wall = device_busy_ms(
        torch, lambda: run(s, k, return_numpy=False))
    report = {
        "path": path, "from": dict(MULTISTEP_PATHS)[path], "case": case,
        "eager_gap": eager_gap, "eager_gap_at": gap_at,
        "graph_vs_eager": err, "graph_vs_eager_at": err_at,
        # the comparison's eager steps, under deterministic algorithms;
        # the phase the path comes from times the default eager step
        "eager_step_ms_deterministic": statistics.median(step_ms),
        "first_call_s": first_s, "warmup_s": runner.warmup_s,
        "capture_s": runner.capture_s, "pool_bytes": {k: runner.pool_bytes},
        "second_call_enqueue_ms": enqueue_ms,
        "peak_mem_bytes": peak, "mem_at_start_bytes": at_start,
        "device_busy_ms_per_step": busy / k,
        "port_kernels_ms_per_step": port / k,
        "idle_share": 1 - busy / wall if busy else None,
        "launches_per_step": {n: c // k for n, c in counts.items() if c},
    }
    # the state's copy-back: the step's last copies move these bytes in
    # the graph; a call hands the scope one clone of them
    bufs = list(runner._bufs.values())
    report["state_bytes"] = sum(b.numel() * b.element_size() for b in bufs)
    report["state_clone_ms"] = eager_ms(
        torch, lambda: [b.clone() for b in bufs], iters=5, reps=3)
    del runner, bufs
    exe._cache.clear()
    torch.cuda.empty_cache()
    report["step_ms"] = {kk: statistics.median(t) / kk
                         for kk, t in times.items()}
    if reduce_check:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            last = run(fresh(), k, "last")
            mean = run(fresh(), k, "mean")
        finally:
            torch.use_deterministic_algorithms(deterministic)
        ref = eager[0]["@losses"]
        same_last, err_last, _ = state_diff(
            torch, {"last": ref[-1]}, {"last": torch.from_numpy(last)})
        check(same_last if eager_same else
              err_last <= MULTISTEP_GAP * eager_gap,
              "%s fetch_reduce='last' %r from the last eager loss"
              % (tag, err_last))
        want = ref.double().mean(0).numpy()
        check(np.allclose(mean, want, rtol=MEAN_RTOL, atol=0),
              "%s fetch_reduce='mean' %s, the eager losses' mean %s"
              % (tag, mean, want))
        report["reduce"] = {"last": case if same_last else err_last,
                            "mean_rel_err": float(np.abs(
                                mean - want).max() / np.abs(want).max())}
        exe._cache.clear()
    report["card"] = card
    report["path_s"] = time.perf_counter() - t0
    print("multistep: " + json.dumps(report))
    del s, init
    torch.cuda.empty_cache()
    return (counts, eager_counts), report


def run_capture_refusal(torch):
    """Phase 25's refusal: a step that syncs with the host (a Print op:
    its values go to the host) cannot be captured, and steps=2 raises
    GraphCaptureError naming the op; the scope keeps its state: nothing
    ran eager instead."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.lowering import GraphCaptureError

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.Print(fluid.layers.fc(input=x, size=4),
                               message="refusal")
        loss = fluid.layers.mean(h)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    before = {n: scope.get(n).clone() for n in scope.names()}
    feed = {"x": np.ones((2, 4), "float32")}
    try:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope, steps=2)
        message = None
    except GraphCaptureError as e:
        message = str(e)
    check(message is not None and "'print'" in message,
          "a step with a Print op did not raise GraphCaptureError naming "
          "it: %r" % message)
    check(all(torch.equal(scope.get(n), v) for n, v in before.items()),
          "a refused steps=2 call changed the scope")
    print("multistep refusal: %s" % message.splitlines()[0][:300])


# ------------------------------------------------------ pipelined serving --

# phase 26: both depths, both burst sizes, on two served models
PIPELINE_DEPTHS = (0, 2)
PIPELINE_BURSTS = (16, 64)


def pipelined_models(fluid, tmp):
    """{name: (model dir, requests, fetch answer check, kernels a
    dispatch launches)} of phase 26: phase 4's Transformer-base scoring
    model and phase 6's IMDB stacked LSTM, built, initialized from SEED
    and saved under `tmp`, with max(PIPELINE_BURSTS) requests each."""
    from paddle_tpu_torch.models import transformer
    n = max(PIPELINE_BURSTS)
    vocab, t_max = MODEL["vocab"], MODEL["max_length"]
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, predict = transformer.transformer(
            vocab, vocab, t_max, n_layer=N_LAYER, n_head=MODEL["n_head"],
            d_key=MODEL["d_key"], d_value=MODEL["d_key"],
            d_model=MODEL["d_model"], d_inner_hid=MODEL["d_inner"],
            use_fused_attention=True)
    rng = np.random.RandomState(SEED + 26)
    requests = []
    for _ in range(n):
        s = rng.randint(3, vocab, rng.randint(t_max // 8, t_max + 1)).tolist()
        tg = rng.randint(3, vocab, rng.randint(t_max // 8, t_max + 1)).tolist()
        requests.append(transformer.prepare_batch([s], [tg], t_max))
    models = {}
    for name, (m, st, pred, feeds, reqs, per) in {
            "transformer_serving": (
                main, startup, predict, transformer.SCORING_FEED_NAMES,
                requests, lambda ops: {
                    "flash_attention_fwd": sum(op.type == "fused_attention"
                                               for op in ops),
                    "layer_norm_fwd": sum(
                        op.type == "layer_norm" and bool(op.inputs.get(
                            "Scale")) and bool(op.inputs.get("Bias"))
                        for op in ops)}),
            "sentiment_lstm_serving": build_sentiment(fluid, "lstm") + (
                ["words"], [{"words": [rng.randint(
                    0, SENTIMENT["dict_dim"], (int(t), 1)).astype("int64")]}
                    for t in rng.randint(16, 257, size=n)],
                sentiment_launches)}.items():
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(st, scope=scope)
        model_dir = os.path.join(tmp, name)
        fluid.io.save_inference_model(model_dir, feeds, [pred], exe, m,
                                      scope=scope)
        models[name] = (model_dir, reqs, per)
    return models


def no_sync_burst(torch, engine, requests):
    """Submit the requests and wait for every future with
    torch.cuda.set_sync_debug_mode("error") on: a host sync on the
    dispatch path fails its batch. Returns the errors."""
    errors = []
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        futures = [engine.submit(r) for r in requests]
        for f in futures:
            try:
                f.result(600)
            except Exception as e:  # noqa: BLE001 — reported by the caller
                errors.append(repr(e))
        engine.drain(600)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    return errors


def run_pipelined_serving(torch, card):
    """Phase 26 (see the module's docstring). Returns [(path, (launch
    counts, the counts predicted))] and the report."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import InferenceEngine

    paths, report = [], {}
    with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as tmp:
        t0 = time.perf_counter()
        models = pipelined_models(fluid, tmp)
        print("pipelined: built, initialized and saved %s in %.1f s"
              % (sorted(models), time.perf_counter() - t0))
        for name, (model_dir, requests, per_dispatch) in models.items():
            seq = name.startswith("sentiment")
            direct = {}   # (request, bucket) -> run_direct's answer
            for depth in PIPELINE_DEPTHS:
                engine = InferenceEngine(
                    model_dir, batch_buckets=[1, 4, 8],
                    seq_buckets=SEQ_BUCKETS if seq else None,
                    pipeline_depth=depth)
                try:
                    check(engine.pipeline_depth == depth and (
                        engine.pipeline_stats() is None) == (depth == 0),
                        "%s: an engine at depth %d" % (name, depth))
                    fetch = engine.fetch_names[0]
                    per = per_dispatch(engine.program.global_block().ops)
                    errors = no_sync_burst(torch, engine,
                                           requests[:PIPELINE_BURSTS[0]])
                    check(not errors, "%s depth %d: the dispatch path made "
                          "a host sync: %s" % (name, depth, errors[:2]))
                    for n in PIPELINE_BURSTS:
                        ck.reset_launch_counts()
                        batches0 = engine.metrics.snapshot()["batches_total"]
                        answers, lat, futures, wall = serve_burst(
                            engine, requests[:n], fetch)
                        counts = ck.launch_counts()
                        batches = engine.metrics.snapshot()[
                            "batches_total"] - batches0
                        expected = dict.fromkeys(counts, 0)
                        expected.update({kn: v * batches
                                         for kn, v in per.items()})
                        paths.append(("%s_depth%d_x%d" % (name, depth, n),
                                      (counts, expected)))
                        diff = 0.0
                        for i, fut in enumerate(futures):
                            key = (i, fut.bucket)
                            if key not in direct:
                                direct[key] = engine.run_direct(
                                    requests[i], batch_bucket=fut.bucket[0],
                                    seq_bucket=fut.bucket[1])[0][fetch]
                            check(np.isfinite(answers[i]).all(),
                                  "%s answer %d is not finite" % (name, i))
                            diff = max(diff, float(np.abs(
                                direct[key] - answers[i]).max()))
                        check(diff <= BUCKET_TOL, "%s depth %d x%d: answers "
                              "differ from run_direct by %r"
                              % (name, depth, n, diff))
                        lat_ms = [x * 1e3 for x in lat]
                        report.setdefault(name, {})["depth%d_x%d" % (
                            depth, n)] = {
                            "p50_ms": float(np.percentile(lat_ms, 50)),
                            "p99_ms": float(np.percentile(lat_ms, 99)),
                            "items_per_s": n / wall, "batches": batches,
                            "bucket_max_diff": diff}
                    check(engine.drain(600), "%s: drain timed out" % name)
                    stats = engine.pipeline_stats()
                    dispatches = engine.metrics.snapshot()["batches_total"]
                    if stats is not None:
                        limit = time.monotonic() + 10
                        while engine.pipeline_stats()["completed"] < \
                                dispatches and time.monotonic() < limit:
                            time.sleep(0.01)
                        stats = engine.pipeline_stats()
                        check(stats["completed"] == dispatches,
                              "%s: the window completed %d of %d dispatches"
                              % (name, stats["completed"], dispatches))
                    report[name]["depth%d" % depth] = {
                        "idle_s": stats and stats["idle_s"],
                        "window": stats, "dispatches": dispatches}
                finally:
                    engine.close()
    report["card"] = card
    print("pipelined: " + json.dumps(report))
    return paths, report


# -------------------------------------------------------- sequence ops --

# phase 27: the A5 sequence ops and the CRF, chunk and edit-distance ops on
# the card against the CPU (plain torch on both: the JAX package has no
# kernel for them), at the widths their paths use
SEQ_OPS_TOL = 1e-4      # fp32, another summation order, relative to max |cpu|
SEQ_OPS_T = 64          # steps of the recurrences (the SRL path's padded T)


def _seq_lens(rng, b, lo, hi):
    lens = rng.randint(lo, hi + 1, b).astype("int32")
    lens[0] = hi
    return lens


def seq_op_cases():
    """(name, op type, numpy inputs, attrs, outputs whose gradient is
    held, outputs held exactly) of phase 27."""
    rng = np.random.RandomState(SEED + 27)

    def f(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype("float32")

    b, t, d = 32, SEQ_OPS_T, 512
    lens = _seq_lens(rng, b, 1, t)
    gru = {"Input": [f(b, t, 3 * d, scale=0.5)],
           "Weight": [f(d, 3 * d, scale=0.05)],
           "Bias": [f(1, 3 * d, scale=0.1)], "XLen": [lens]}
    tags, tc = 59, 60
    crf_lens = _seq_lens(rng, b, 5, tc)
    label = rng.randint(0, tags, (b, tc)).astype("int64")
    crf = {"Emission": [f(b, tc, tags)], "Transition": [f(tags + 2, tags,
                                                          scale=0.5)],
           "XLen": [crf_lens]}
    decode_label = rng.randint(0, tags, (b, tc, 1)).astype("int64")
    chunk_infer = rng.randint(0, tags, (b, tc)).astype("int64")
    chunk_label = chunk_infer.copy()
    chunk_label[b // 2:] = rng.randint(0, tags, (b - b // 2, tc))
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype("int32")
    return [
        ("dynamic_gru", "gru", gru, {}, ["Hidden"], []),
        ("dynamic_gru reverse", "gru", gru, {"is_reverse": True},
         ["Hidden"], []),
        ("gru_unit", "gru_unit",
         {"Input": [f(b, 3 * d)], "HiddenPrev": [f(b, d)],
          "Weight": [f(d, 3 * d, scale=0.05)], "Bias": [f(1, 3 * d)]},
         {}, ["Hidden", "Gate", "ResetHiddenPrev"], []),
        ("lstm_unit", "lstm_unit", {"X": [f(b, 4 * d)], "C_prev": [f(b, d)]},
         {"forget_bias": 1.0}, ["C", "H"], []),
        ("linear_chain_crf", "linear_chain_crf",
         dict(crf, Label=[label]), {}, ["LogLikelihood"], []),
        ("crf_decoding", "crf_decoding", crf, {}, [], ["ViterbiPath"]),
        ("crf_decoding with Label", "crf_decoding",
         dict(crf, Label=[decode_label]), {}, [], ["ViterbiPath"]),
        ("chunk_eval", "chunk_eval",
         {"Inference": [chunk_infer], "Label": [chunk_label],
          "XLen": [crf_lens]},
         {"num_chunk_types": 29, "chunk_scheme": "IOB",
          "excluded_chunk_types": [3]}, [],
         ["NumInferChunks", "NumLabelChunks", "NumCorrectChunks"]),
        ("sequence_reshape", "sequence_reshape",
         {"X": [f(b, t, d)], "XLen": [lens]}, {"new_dim": d // 2}, ["Out"],
         ["Out", "OutLen"]),
        ("sequence_expand", "sequence_expand",
         {"X": [f(b, d)], "Y": [f(b, t, 8)], "YLen": [lens]}, {}, ["Out"],
         ["Out"]),
        ("lod_reset", "lod_reset",
         {"X": [f(b, t, d)], "XLen": [lens],
          "YData": [offsets[::2].copy()]}, {}, ["Out"], ["Out", "OutLen"]),
        ("row_conv", "row_conv",
         {"X": [f(b, t, d)], "Filter": [f(3, d, scale=0.3)],
          "XLen": [lens]}, {}, ["Out"], []),
        ("sequence_cache_write", "sequence_cache_write",
         {"Cache": [f(b, t, d)], "X": [f(b, d)],
          "Pos": [rng.randint(-t, t, (b, 1)).astype("int64")]}, {}, ["Out"],
         ["Out"]),
        ("sequence_slice", "sequence_slice",
         {"X": [f(b, t, d)],
          "Offset": [rng.randint(0, t // 2, (b, 1)).astype("int64")],
          "Length": [rng.randint(1, t // 2, (b, 1)).astype("int64")],
          "XLen": [lens]}, {}, ["Out"], ["Out", "OutLen"]),
        ("sequence_concat", "sequence_concat",
         {"X": [f(b, t, d), f(b, t // 2, d)],
          "XLen": [lens, _seq_lens(rng, b, 0, t // 2)]}, {"axis": 0},
         ["Out"], ["Out", "OutLen"]),
        ("sequence_erase", "sequence_erase",
         {"X": [chunk_infer % 7], "XLen": [crf_lens]}, {"tokens": [0, 3]},
         [], ["Out", "OutLen"]),
        ("edit_distance", "edit_distance",
         {"Hyps": [chunk_infer % 7], "Refs": [chunk_label % 7],
          "HypsLen": [crf_lens], "RefsLen": [crf_lens[::-1].copy()]},
         {"normalized": True}, [], ["Out", "SequenceNum"]),
    ]


def run_seq_op(torch, op_type, ins, attrs, grad_slots, device, cots=None):
    """One op rule on `device` under autograd: (outputs as host tensors,
    {input (slot, i): its gradient of sum(cot * out) over grad_slots}, the
    cotangents used, the rule's assertion flags on the host)."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.lowering import LowerCtx

    dev = torch.device(device)
    tins, leaves = {}, {}
    for slot, vals in ins.items():
        tins[slot] = []
        for i, a in enumerate(vals):
            v = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            if grad_slots and v.is_floating_point():
                v.requires_grad_(True)
                leaves[(slot, i)] = v
            tins[slot].append(v)
    ctx = LowerCtx(None, dev)
    with torch.enable_grad():
        out = registry.get(op_type).lower(ctx, tins, attrs)
        grads = {}
        if grad_slots:
            if cots is None:
                g = np.random.RandomState(SEED + 270)
                cots = {s: [g.randn(*o.shape).astype("float32")
                            for o in out[s]] for s in grad_slots}
            total = sum((o * torch.from_numpy(c).to(dev)).sum()
                        for s in grad_slots for o, c in zip(out[s], cots[s]))
            keys = list(leaves)
            gs = torch.autograd.grad(total, [leaves[k] for k in keys],
                                     allow_unused=True)
            grads = {k: (torch.zeros_like(leaves[k]) if v is None else v)
                     .detach().cpu() for k, v in zip(keys, gs)}
    host = {s: [o.detach().cpu() for o in vs] for s, vs in out.items()
            if isinstance(vs, (list, tuple))}
    flags = {m: bool(f) for m, f in ctx.op_errors.items()}
    return host, grads, cots, flags


def seq_op_err(torch, got, want):
    """max |got - want| over max(1, max |want|)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def run_sequence_ops_vs_cpu(torch):
    """Phase 27: every op rule of the slice on the card against the CPU,
    forward and gradient (seq_op_cases), then the in-graph assertion
    channel on the card. Returns the report."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.lowering import LowerCtx

    torch.backends.cuda.matmul.allow_tf32 = False
    report = {}
    cases = seq_op_cases()
    for name, op_type, ins, attrs, grad_slots, exact in cases:
        want, wgrads, cots, wflags = run_seq_op(torch, op_type, ins, attrs,
                                                grad_slots, "cpu")
        got, ggrads, _, gflags = run_seq_op(torch, op_type, ins, attrs,
                                            grad_slots, "cuda", cots)
        check(sorted(got) == sorted(want) and gflags == wflags,
              "sequence ops: %s gives outputs %s flags %s on the card, %s "
              "%s on the CPU" % (name, sorted(got), gflags, sorted(want),
                                 wflags))
        fwd = 0.0
        for slot in want:
            for g, w in zip(got[slot], want[slot]):
                check(g.shape == w.shape and g.dtype == w.dtype,
                      "sequence ops: %s %s is %s %s on the card, %s %s on "
                      "the CPU" % (name, slot, tuple(g.shape), g.dtype,
                                   tuple(w.shape), w.dtype))
                if slot in exact or not w.is_floating_point():
                    check(torch.equal(g, w), "sequence ops: %s %s differs "
                          "from the CPU's" % (name, slot))
                else:
                    fwd = max(fwd, seq_op_err(torch, g, w))
        bwd = max([seq_op_err(torch, ggrads[k], wgrads[k]) for k in wgrads]
                  or [0.0])
        check(fwd <= SEQ_OPS_TOL and bwd <= SEQ_OPS_TOL,
              "sequence ops: %s card vs CPU forward %r, gradient %r (limit "
              "%r)" % (name, fwd, bwd, SEQ_OPS_TOL))
        shapes = {s: [list(a.shape) for a in v] for s, v in ins.items()}
        report[name] = {"inputs": shapes, "forward_err": fwd,
                        "grad_err": bwd if grad_slots else None,
                        "exact": exact}
        print("sequence ops: %-24s card vs CPU forward %.3e, gradient %s%s"
              % (name, fwd, "%.3e" % bwd if grad_slots else "-",
                 " (exact: %s)" % ", ".join(exact) if exact else ""))
    by_name = {c[0]: c for c in cases}
    for name in ("dynamic_gru", "linear_chain_crf", "crf_decoding"):
        _, op_type, ins_np, attrs, _, _ = by_name[name]
        ins = {s: [torch.from_numpy(np.ascontiguousarray(a)).to(
            torch.device("cuda")) for a in v] for s, v in ins_np.items()}
        rule = registry.get(op_type).lower
        ctx = LowerCtx(None, torch.device("cuda"))
        with torch.no_grad():
            report[name]["forward_ms"] = eager_ms(
                torch, lambda: rule(ctx, ins, attrs), iters=5, reps=3)
    print("sequence ops: forward ms (eager, host launches included): %s"
          % json.dumps({n: report[n]["forward_ms"] for n in (
              "dynamic_gru", "linear_chain_crf", "crf_decoding")}))
    report["assertions"] = run_assertion_channel(torch)
    return report


def _reshape_prog(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                              lod_level=1)
        out = fluid.layers.reduce_sum(fluid.layers.sequence_reshape(x, 8))
    return main, startup, out


def _step2_prog(fluid):
    """lod_reset onto offsets base + shift * (counter == 2), then
    sequence_reshape to width 4: only step 2's lengths (3, 1) are odd,
    and len * 2 is not a multiple of 4 (the feeds replay every step, so
    the step counter decides which step trips)."""
    main, startup = fluid.Program(), fluid.Program()
    layers = fluid.layers
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[2], dtype="float32", lod_level=1)
        base = layers.data(name="base", shape=[3], dtype="int32",
                           append_batch_size=False)
        shift = layers.data(name="shift", shape=[3], dtype="int32",
                            append_batch_size=False)
        counter = layers.autoincreased_step_counter(begin=1)
        two = layers.fill_constant(shape=[1], dtype="int64", value=2)
        at_two = layers.cast(layers.equal(counter, two), "int32")
        offsets = layers.elementwise_add(
            base, layers.elementwise_mul(shift, at_two))
        r = layers.sequence_reshape(layers.lod_reset(x, y=offsets), 4)
        out = layers.reduce_sum(r)
    return main, startup, out, counter


def _sync_warnings(torch, fn, tag="sequence ops", through=None):
    """(fn()'s result, the number of synchronizing CUDA calls it made),
    counted by torch.cuda.set_sync_debug_mode("warn") (its "called a
    synchronizing CUDA operation" warnings, on any thread; setting the
    mode warns too, and is not counted); the Python lines that made them
    are printed, each with its count, after `tag`. With `through` (names
    of files or functions), also the number of those calls whose stack
    passes through one of them: (result, calls, calls through)."""
    import traceback
    import warnings
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.synchronize()
    where, hits = [], []

    def shown(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if "/warnings.py" not in f.filename]
            where.append(" <- ".join("%s:%d" % (os.path.basename(
                f.filename), f.lineno) for f in stack[-4:][::-1]))
            hits.append(any(os.path.basename(f.filename) in through
                            or f.name in through for f in stack)
                        if through else False)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = shown
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    for w, n in collections.Counter(where).items():
        print("%s: synchronizing call%s at %s" % (
            tag, " x %d" % n if n > 1 else "", w))
    if through:
        return out, len(where), sum(hits)
    return out, len(where)


def run_assertion_channel(torch):
    """Phase 27's assertion checks on the card: an indivisible
    sequence_reshape raises at steps=1; a steps=4 call whose step 2 alone
    trips raises after the 4 replays (the counter at 4: the state written
    back first), and the next call, clean, does not; a clean call reads
    its one combined flag (one synchronizing call, counted under
    set_sync_debug_mode("warn")), a program with no asserting op none."""
    import paddle_tpu_torch as fluid
    report = {}
    main, startup, out = _reshape_prog(fluid)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED + 271)

    def lod(lens, width):
        return fluid.LoDTensor.from_sequences(
            [rng.randn(n, width).astype("float32") for n in lens])
    try:
        exe.run(main, feed={"x": lod([3, 2], 4)}, fetch_list=[out],
                scope=scope)
        message = None
    except RuntimeError as e:
        message = str(e)
    check(message is not None and message.startswith(
        "sequence_reshape: a sequence's len*dim (4 per step) is not "
        "divisible by new_dim=8"), "an indivisible sequence_reshape did not "
        "raise at steps=1: %r" % message)
    report["steps_1"] = message
    clean = {"x": lod([2, 4], 4)}
    exe.run(main, feed=clean, fetch_list=[out], scope=scope)
    reads0 = exe.flag_reads
    _, syncs = _sync_warnings(torch, lambda: exe.run(
        main, feed=clean, fetch_list=[out], scope=scope,
        return_numpy=False))
    check(syncs == 1 and exe.flag_reads == reads0 + 1,
          "a clean call made %d synchronizing calls and %d flag reads, "
          "expected 1 and 1" % (syncs, exe.flag_reads - reads0))
    report["clean_call_syncs"] = syncs

    main, startup, out, counter = _step2_prog(fluid)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": lod([2, 2], 2), "base": np.array([0, 2, 4], "int32"),
            "shift": np.array([0, 1, 0], "int32")}
    try:
        exe.run(main, feed=feed, fetch_list=[out, counter], scope=scope,
                steps=4)
        message = None
    except RuntimeError as e:
        message = str(e)
    runner = next(reversed(exe._cache.values()))
    at = int(scope.get(counter.name).reshape(-1)[0])
    check(message is not None and message.startswith("sequence_reshape:")
          and (runner._graph is not None) == runner.cuda and at == 4,
          "steps=4 tripped at step 2: raised %r, graph %s, counter %d"
          % (message, runner._graph is not None, at))
    report["steps_4"] = message
    (_, counts), syncs = _sync_warnings(torch, lambda: exe.run(
        main, feed=feed, fetch_list=[out, counter], scope=scope, steps=4,
        return_numpy=False))
    check(counts.reshape(-1).tolist() == [5, 6, 7, 8] and syncs == 1,
          "the next steps=4 call ran steps %s with %d synchronizing calls"
          % (counts.reshape(-1).tolist(), syncs))
    report["clean_steps_4_syncs"] = syncs

    plain_main, plain_startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), \
            fluid.program_guard(plain_main, plain_startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                              lod_level=1)
        pooled = fluid.layers.reduce_sum(
            fluid.layers.sequence_pool(x, "max"))
    exe = fluid.Executor()
    exe.run(plain_main, feed=clean, fetch_list=[pooled])
    _, syncs = _sync_warnings(torch, lambda: exe.run(
        plain_main, feed=clean, fetch_list=[pooled], return_numpy=False))
    check(syncs == 0 and exe.flag_reads == 0, "a program with no asserting "
          "op made %d synchronizing calls and %d flag reads"
          % (syncs, exe.flag_reads))
    report["flag_free_syncs"] = syncs
    print("sequence ops: assertions: steps=1 raised %r; steps=4 raised after "
          "4 replays with the counter at 4; synchronizing calls: clean "
          "steps=1 %d, clean steps=4 %d, no asserting op %d"
          % (report["steps_1"][:60], report["clean_call_syncs"],
             report["clean_steps_4_syncs"], syncs))
    return report


# ----------------------------------------------------------------- srl --

# phase 28: book chapter 07's semantic role labeller at the book's widths;
# the dictionaries are the JAX package's synthetic conll05's
# (paddle_tpu/datasets/conll05.py:16-18), copied: the port has no conll05.
# The book's lr, 0.01, diverges on this data at these widths in both
# packages (the JAX package on the CPU, the same batch each step: losses
# 131.0, 174.8, 137.8, 477.5, 11313.5, 2.6e16, NaN; the port alike; 0.005
# turns back up by step 8): the phase trains at SRL_LR, the book's 0.01
# stays the vs-CPU step's
SRL = dict(word=4000, verb=300, label=59, word_dim=32, mark_dim=5,
           hidden=512, depth=8, mix_hidden_lr=1e-3, lr=0.01, batch=32,
           min_len=5, max_len=60)
SRL_LR = 0.003
SRL_SMALL = dict(SRL, depth=2, batch=4, min_len=1)   # the card-vs-CPU step
SRL_SERVE = dict(requests=16, buckets=[1, 4, 8], seq_buckets=[16, 32, 64])


def srl_rows(rng, cfg, n, lens=None):
    """n synthetic conll05 rows (tests/book/test_label_semantic_roles.py's
    synth_batch at cfg's dictionaries): 9 columns of [len, 1] int64 ids
    (the word, its 5-word context around the predicate, the predicate,
    the mark, the label, which follows the word)."""
    cols = [[] for _ in range(9)]
    for i in range(n):
        length = lens[i] if lens is not None else rng.randint(
            cfg["min_len"], cfg["max_len"] + 1)
        words = rng.randint(0, cfg["word"], length)
        pred = rng.randint(0, length)
        mark = np.zeros(length, "int64")
        mark[pred] = 1

        def ctx(off):
            return np.full(length, words[min(max(pred + off, 0),
                                             length - 1)], "int64")
        seqs = [words, ctx(-2), ctx(-1), ctx(0), ctx(1), ctx(2),
                np.full(length, rng.randint(0, cfg["verb"]), "int64"), mark,
                words % cfg["label"]]
        for c, s in zip(cols, seqs):
            c.append(np.asarray(s, "int64").reshape(-1, 1))
    return cols


def srl_feed(fluid, names, cols):
    return {n: fluid.LoDTensor.from_sequences(c) for n, c in zip(names, cols)}


def srl_kwargs(cfg):
    return dict(word_dict_len=cfg["word"], label_dict_len=cfg["label"],
                pred_dict_len=cfg["verb"], word_dim=cfg["word_dim"],
                mark_dim=cfg["mark_dim"], hidden_dim=cfg["hidden"],
                depth=cfg["depth"])


def build_srl(fluid, cfg):
    """label_semantic_roles.build_train at cfg. Returns (main, startup,
    feed names, avg_cost, crf_decode, chunk_eval's outputs)."""
    from paddle_tpu_torch.models import label_semantic_roles as srl
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        names, avg, decode, chunk = srl.build_train(
            mix_hidden_lr=cfg["mix_hidden_lr"], lr=cfg["lr"],
            **srl_kwargs(cfg))
    return main, startup, names, avg, decode, chunk


def build_srl_infer(fluid, cfg):
    """The inference program: the 8 feature feeds, db_lstm and the Viterbi
    decode on the trained `crfw` (built apart from the training program,
    whose pruning would keep its SGD ops: `crfw` is an SGD output). Its
    parameters take the training program's names. Returns (main,
    crf_decode)."""
    from paddle_tpu_torch.models import label_semantic_roles as srl
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feats = [fluid.layers.data(name=n, shape=[1], dtype="int64",
                                   lod_level=1) for n in srl.FEATURE_NAMES]
        word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb, mark = feats
        feature_out = srl.db_lstm(
            word=word, predicate=verb, ctx_n2=ctx_n2, ctx_n1=ctx_n1,
            ctx_0=ctx_0, ctx_p1=ctx_p1, ctx_p2=ctx_p2, mark=mark,
            **srl_kwargs(cfg))
        decode = fluid.layers.crf_decoding(
            input=feature_out, param_attr=fluid.ParamAttr(name="crfw"))
    return main, decode


def srl_emb(torch, cfg):
    """The frozen `emb` made label-informative, as the book test loads a
    pretrained table: each word's row is 0.1 N(0, 1) noise plus a random
    code of norm 2 of its label (the book test adds 2.0 at one column;
    word_dim 32 is below the 59 labels, so a code, not a one-hot)."""
    rng = np.random.RandomState(SEED + 28)
    codes = rng.randn(cfg["label"], cfg["word_dim"]).astype("float32")
    codes *= 2.0 / np.linalg.norm(codes, axis=1, keepdims=True)
    emb = 0.1 * rng.randn(cfg["word"], cfg["word_dim"]).astype("float32")
    emb += codes[np.arange(cfg["word"]) % cfg["label"]]
    return torch.from_numpy(emb).to(torch.device("cuda"))


def run_srl_training(torch, card, trace_path=None):
    """Phase 28's training: build_train at SRL's widths and SRL_LR, the
    startup program on the card, the frozen emb set, TRAIN_STEPS steps of
    one batch of SRL["batch"] sentences and a traced one (train_steps),
    then one more fetching the chunk counts. Returns ((launch counts, predicted: none of
    K1-K9), the report, the trained scope, the batch)."""
    import paddle_tpu_torch as fluid
    cfg = dict(SRL, lr=SRL_LR)
    t0 = time.perf_counter()
    main, startup, names, avg, decode, chunk = build_srl(fluid, cfg)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    scope.set("emb", srl_emb(torch, cfg))
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(scope.get(p.name).shape))
                   for p in main.all_parameters())
    ops = main.global_block().ops
    print("srl: built the training program (depth %d, hidden %d, %d "
          "parameters, %d ops: %d lstm) and ran its startup program in "
          "%.1f s" % (cfg["depth"], cfg["hidden"], n_params, len(ops),
                      sum(op.type == "lstm" for op in ops),
                      time.perf_counter() - t0))
    rng = np.random.RandomState(SEED + 280)
    lens = rng.randint(cfg["min_len"], cfg["max_len"] + 1, cfg["batch"])
    lens[0] = cfg["max_len"]
    cols = srl_rows(rng, cfg, cfg["batch"], lens)
    feed = srl_feed(fluid, names, cols)
    words = int(lens.sum())
    report, counts, _ = train_steps(torch, "srl: training", exe, main, feed,
                                    avg, scope, trace_path, words, "words")
    # one more step, fetching its loss and its decode's chunk counts
    out = exe.run(main, feed=feed, fetch_list=[avg] + list(chunk),
                  scope=scope)
    chunks = {k: float(np.ravel(v)[0]) for k, v in zip(
        ("loss", "precision", "recall", "f1", "infer_chunks",
         "label_chunks", "correct_chunks"), out)}
    print("srl: step %d's loss and chunk counts: %s"
          % (sum(TRAIN_STEPS) + 2, json.dumps(chunks)))
    check(np.isfinite(chunks["loss"]) and chunks["label_chunks"] > 0,
          "srl: the chunk counts after training: %s" % chunks)
    report = {"depth": cfg["depth"], "hidden": cfg["hidden"],
              "lr": cfg["lr"], "batch": cfg["batch"],
              "lengths": [int(lens.min()),
                                                 int(lens.max())],
              "words": words, "parameters": n_params, **report,
              "chunk_eval": chunks,
              "port_kernels": "none launched: the book's LSTMs use a relu "
              "candidate and a sigmoid cell, which K6 (default activations "
              "only) does not take in either package, and no op of the "
              "path reaches K1-K5 or K7-K9", "card": card}
    print("srl: training " + json.dumps(report))
    return (counts, dict.fromkeys(counts, 0)), report, scope, cols


def run_srl_training_vs_cpu(torch):
    """One SGD step of build_train at SRL's widths, depth 2, batch 4 of
    lengths 1-60, on the card and on the CPU from the same state, held by
    step_vs_cpu (phase 5's tolerances)."""
    import paddle_tpu_torch as fluid
    cfg = SRL_SMALL
    main, startup, names, avg, _, _ = build_srl(fluid, cfg)
    lens = [cfg["max_len"], 1, 17, 33]
    cols = srl_rows(np.random.RandomState(SEED + 281), cfg, len(lens), lens)
    step_vs_cpu(main, startup, avg, srl_feed(fluid, names, cols), cfg["lr"],
                "srl: one step at depth 2, batch 4, lengths %s" % lens)


def run_srl_serving(torch, card, scope):
    """Phase 28's serving: the inference program saved with the trained
    scope and served by InferenceEngine on the card (SRL_SERVE's buckets)
    to a burst of 16 one-sentence requests with 8 int LoD feeds. Checks:
    each decode equal to run_direct at its bucket and to a CPU engine's
    run_direct at the same bucket (exact), zero past the sentence, no
    port kernel launched. Returns ((counts, predicted), the report)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.models import label_semantic_roles as srl
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import InferenceEngine

    cfg, serve = SRL, SRL_SERVE
    infer, decode = build_srl_infer(fluid, cfg)
    with tempfile.TemporaryDirectory(prefix="ptt_srl_") as tmp:
        path = os.path.join(tmp, "srl")
        pio.save_inference_model(path, srl.FEATURE_NAMES, [decode],
                                 fluid.Executor(), main_program=infer,
                                 scope=scope)
        rng = np.random.RandomState(SEED + 282)
        lens = rng.randint(cfg["min_len"], cfg["max_len"] + 1,
                           serve["requests"])
        requests = [dict(zip(srl.FEATURE_NAMES,
                             srl_rows(rng, cfg, 1, [n])[:8])) for n in lens]
        t0 = time.perf_counter()
        engine = InferenceEngine(path, batch_buckets=serve["buckets"],
                                 seq_buckets=serve["seq_buckets"])
        warm_s = time.perf_counter() - t0
        try:
            fetch = engine.fetch_names[0]
            ck.reset_launch_counts()
            b0 = engine.metrics.snapshot()["batches_total"]
            answers, latencies, futures, wall = serve_burst(engine, requests,
                                                            fetch)
            counts = ck.launch_counts()
            batches = engine.metrics.snapshot()["batches_total"] - b0
            direct = [engine.run_direct(r, batch_bucket=f.bucket[0],
                                        seq_bucket=f.bucket[1])
                      for r, f in zip(requests, futures)]
        finally:
            engine.close()
        cpu = InferenceEngine(path, device="cpu",
                              batch_buckets=serve["buckets"],
                              seq_buckets=serve["seq_buckets"], warmup=False)
        try:
            on_cpu = [cpu.run_direct(r, batch_bucket=f.bucket[0],
                                     seq_bucket=f.bucket[1])[0][fetch]
                      for r, f in zip(requests, futures)]
        finally:
            cpu.close()
    for i, (ans, (d, bucket), c, n) in enumerate(zip(answers, direct, on_cpu,
                                                     lens)):
        check(bucket == futures[i].bucket and ans.shape == (1, bucket[1])
              and ans.dtype == np.int64,
              "srl: answer %d is %s %s at %s" % (i, ans.shape, ans.dtype,
                                                 bucket))
        check(np.array_equal(ans, d[fetch]), "srl: answer %d differs from "
              "run_direct at its bucket %s" % (i, bucket))
        check(np.array_equal(ans, c), "srl: answer %d differs from the "
              "CPU's decode (%d of %d tags)" % (i, int((ans != c).sum()), n))
        check(not ans[0, n:].any() and ((ans[0, :n] >= 0) &
                                        (ans[0, :n] < cfg["label"])).all(),
              "srl: answer %d has tags outside [0, %d) or past its %d words"
              % (i, cfg["label"], n))
    lat_ms = sorted(x * 1e3 for x in latencies)
    report = {"requests": serve["requests"], "batches": batches,
              "warmup_s": warm_s, "p50_ms": float(np.percentile(lat_ms, 50)),
              "p99_ms": float(np.percentile(lat_ms, 99)), "wall_s": wall,
              "words": int(lens.sum()), "words_per_s": float(lens.sum()) / wall,
              "buckets": sorted(set(f.bucket for f in futures)),
              "equal_to_run_direct_and_cpu": True, "card": card}
    print("srl: serving " + json.dumps(report))
    return (counts, dict.fromkeys(counts, 0)), report


# ------------------------------------------------------------------ ocr --

# phase 29: the CRNN-CTC OCR model (models/ocr_recognition.py ctc_train_net)
# at the settings of the PaddlePaddle models repo's fluid/ocr_recognition
# CRNN-CTC as far as the JAX function's arguments express them: channels
# (16, 32, 64, 128), rnn_hidden_size 200, 1 x 48 x 384 grey images, 95
# classes and the blank, batch 32, Momentum 0.9 at 1e-3. Four conv groups
# halve each side four times: 24 columns of 3 x 128 = 384 features. The
# images are each label's glyphs side by side, a glyph a fixed random
# 48 x 32 pattern of its class drawn from the seed; labels 1-12 characters
# (12 labels with repeats need at most 23 of the 24 steps)
OCR = dict(classes=95, hidden=200, channels=(16, 32, 64, 128), height=48,
           width=384, glyph=32, batch=32, lr=1e-3, min_chars=1,
           max_chars=12)
OCR_SMALL = dict(OCR, channels=(16, 32), batch=4)  # the card-vs-CPU step
OCR_SERVE = dict(requests=16, buckets=[1, 4, 8, 16])
CTC_TOL = 1e-4   # warpctc vs F.ctc_loss, relative (fp32, another order)


def ocr_batch(cfg, rng, n):
    """n images of 1-12 glyphs and their label sequences: (images [n, 1,
    H, W] float32, [labels [k, 1] int64])."""
    book = (np.random.RandomState(SEED + 290).rand(
        cfg["classes"], cfg["height"], cfg["glyph"]) < 0.5).astype("float32")
    imgs = np.zeros((n, 1, cfg["height"], cfg["width"]), "float32")
    labels = []
    for i in range(n):
        chars = rng.randint(0, cfg["classes"],
                            rng.randint(cfg["min_chars"],
                                        cfg["max_chars"] + 1))
        for j, c in enumerate(chars):
            imgs[i, 0, :, j * cfg["glyph"]:(j + 1) * cfg["glyph"]] = book[c]
        labels.append(chars.reshape(-1, 1).astype("int64"))
    return imgs, labels


def build_ocr(fluid, cfg):
    """ctc_train_net at cfg: (main, startup, sum_cost)."""
    from paddle_tpu_torch.models import ocr_recognition as ocr
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        images = fluid.layers.data(name="pixel", shape=[
            1, cfg["height"], cfg["width"]], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64",
                                  lod_level=1)
        sum_cost, _, _, _ = ocr.ctc_train_net(
            images, label, cfg["classes"], learning_rate=cfg["lr"],
            rnn_hidden_size=cfg["hidden"], channels=cfg["channels"])
    return main, startup, sum_cost


def build_ocr_infer(fluid, cfg, with_label=False):
    """The is_test encoder and the greedy decoder (and, with_label, the
    edit distance against a label), built apart from the training program
    with its parameter names: (program, [decoded, its lengths(, distance)
    ])."""
    from paddle_tpu_torch.models import ocr_recognition as ocr
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        images = fluid.layers.data(name="pixel", shape=[
            1, cfg["height"], cfg["width"]], dtype="float32")
        fc_out = ocr.encoder_net(images, cfg["classes"], is_test=True,
                                 rnn_hidden_size=cfg["hidden"],
                                 channels=cfg["channels"])
        decoded = fluid.layers.ctc_greedy_decoder(input=fc_out,
                                                  blank=cfg["classes"])
        fetch = [decoded, main.global_block().var(decoded.seq_len_var)]
        if with_label:
            label = fluid.layers.data(name="label", shape=[1],
                                      dtype="int64", lod_level=1)
            fetch.append(fluid.layers.edit_distance(
                input=decoded, label=label, normalized=True)[0])
    return main, fetch


def run_warpctc_vs_library(torch, labels, steps, classes):
    """warpctc's eager forward (the port's alpha loop) against
    F.ctc_loss on the same feasible input: logits [B, steps, classes + 1]
    from the seed, the batch's labels, blank = classes. The losses within
    CTC_TOL relative; returns their ms (eager, host included) and the
    error."""
    import torch.nn.functional as F
    from paddle_tpu_torch.core import registry
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 291)
    b = len(labels)
    logits = torch.randn((b, steps, classes + 1), generator=g, device=dev)
    u = max(len(x) for x in labels)
    lab = np.zeros((b, u), "int64")
    for i, x in enumerate(labels):
        lab[i, :len(x)] = x[:, 0]
    label = torch.from_numpy(lab).to(dev)
    xlen = torch.full((b,), steps, dtype=torch.int32, device=dev)
    llen = torch.tensor([len(x) for x in labels], dtype=torch.int32,
                        device=dev)
    ins = {"Logits": [logits], "Label": [label], "XLen": [xlen],
           "LabelLen": [llen]}
    attrs = {"blank": classes, "norm_by_times": True}
    rule = registry.get("warpctc").lower

    def port():
        return rule(None, ins, attrs)["Loss"][0]

    def library():
        lp = torch.log_softmax(logits, -1).transpose(0, 1)
        return F.ctc_loss(lp, label, xlen, llen, blank=classes,
                          reduction="none")

    with torch.no_grad():
        got, want = port()[:, 0], library()
        torch.cuda.synchronize()
        err = float(((got - want).abs() / want.abs()).max())
        ms, lib_ms = eager_ms(torch, port, 10, 5), eager_ms(torch, library,
                                                            10, 5)
    check(np.isfinite(err) and err <= CTC_TOL,
          "ocr: warpctc and F.ctc_loss differ by %r relative" % err)
    return {"shape": [b, steps, classes + 1], "labels": [
        min(len(x) for x in labels), u], "max_rel_err": err,
        "eager_ms": ms, "f_ctc_loss_eager_ms": lib_ms}


def run_ocr_training(torch, card, trace_path=None):
    """Phase 29's training and evaluation: ctc_train_net at OCR's settings
    on the card, TRAIN_STEPS Momentum steps on one batch and a traced one
    (train_steps), then the is_test encoder's greedy decode and edit
    distance on the batch; warpctc's eager forward beside F.ctc_loss's.
    Returns ((launch counts, predicted: none of K1-K9), the report, the
    trained scope)."""
    import paddle_tpu_torch as fluid
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = OCR
    t0 = time.perf_counter()
    main, startup, sum_cost = build_ocr(fluid, cfg)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(scope.get(p.name).shape))
                   for p in main.all_parameters())
    ops = main.global_block().ops
    print("ocr: built ctc_train_net (channels %s, hidden %d, %d classes, "
          "%d parameters, %d ops) and ran its startup program in %.1f s"
          % (list(cfg["channels"]), cfg["hidden"], cfg["classes"], n_params,
             len(ops), time.perf_counter() - t0))
    rng = np.random.RandomState(SEED + 292)
    imgs, labels = ocr_batch(cfg, rng, cfg["batch"])
    feed = {"pixel": imgs, "label": fluid.LoDTensor.from_sequences(labels)}
    report, counts, _ = train_steps(torch, "ocr: training", exe, main, feed,
                                    sum_cost, scope, trace_path,
                                    cfg["batch"], "images")
    infer, fetch = build_ocr_infer(fluid, cfg, with_label=True)
    decoded, lens, dist = exe.run(infer, feed=feed, fetch_list=fetch,
                                  scope=scope)
    steps = cfg["width"] // 2 ** len(cfg["channels"])
    check(decoded.shape == (cfg["batch"], steps) and (lens <= steps).all()
          and ((decoded >= 0) & (decoded < cfg["classes"])).all()
          and np.isfinite(dist).all(),
          "ocr: the greedy decode %s, lengths %s, distances %s"
          % (decoded.shape, lens.tolist(), dist.ravel().tolist()))
    evaluation = {"mean_edit_distance": float(dist.mean()),
                  "decoded_lengths": [int(lens.min()), int(lens.max())],
                  "label_lengths": [min(len(x) for x in labels),
                                    max(len(x) for x in labels)],
                  "first_decode": decoded[0, :int(lens[0])].tolist(),
                  "first_label": labels[0][:, 0].tolist()}
    print("ocr: evaluation (is_test, greedy decode + edit distance) "
          + json.dumps(evaluation))
    ctc = run_warpctc_vs_library(torch, labels, steps, cfg["classes"])
    print("ocr: warpctc " + json.dumps(ctc))
    report = {"classes": cfg["classes"], "hidden": cfg["hidden"],
              "channels": list(cfg["channels"]),
              "image": [1, cfg["height"], cfg["width"]],
              "batch": cfg["batch"], "steps_t": steps,
              "parameters": n_params, **report, "evaluation": evaluation,
              "warpctc": ctc,
              "port_kernels": "none launched: no op of the path reaches "
              "K1-K9 (the GRU's relu candidate runs the torch loop; the "
              "JAX package has no Pallas GRU or CTC kernel)", "card": card}
    print("ocr: training " + json.dumps(report))
    return (counts, dict.fromkeys(counts, 0)), report, scope


def run_ocr_training_vs_cpu(torch):
    """One Momentum step of ctc_train_net at OCR's widths and half its
    depth (two conv groups: 96 steps of 384 features), batch 4, on the
    card and on the CPU from the same state (step_vs_cpu)."""
    import paddle_tpu_torch as fluid
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = OCR_SMALL
    main, startup, sum_cost = build_ocr(fluid, cfg)
    imgs, labels = ocr_batch(cfg, np.random.RandomState(SEED + 293),
                             cfg["batch"])
    step_vs_cpu(main, startup, sum_cost, {
        "pixel": imgs, "label": fluid.LoDTensor.from_sequences(labels)},
        cfg["lr"], "ocr: one step at channels %s, batch %d"
        % (list(cfg["channels"]), cfg["batch"]))


def run_ocr_serving(torch, card, scope):
    """Phase 29's serving: the is_test encoder with the greedy decoder
    saved with the trained scope (its decode and the decode's lengths as
    targets) and served by InferenceEngine on the card (OCR_SERVE's
    buckets) to a burst of 16 one-image requests. Checks: each answer
    equal to run_direct at its bucket and to a CPU engine's run_direct at
    the same bucket (exact), classes in range, zero past its length, no
    port kernel launched. Returns ((counts, predicted), the report)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import InferenceEngine

    cfg, serve = OCR, OCR_SERVE
    infer, fetch = build_ocr_infer(fluid, cfg)
    imgs, labels = ocr_batch(cfg, np.random.RandomState(SEED + 294),
                             serve["requests"])
    requests = [{"pixel": img[None]} for img in imgs]
    with tempfile.TemporaryDirectory(prefix="ptt_ocr_") as tmp:
        path = os.path.join(tmp, "ocr")
        pio.save_inference_model(path, ["pixel"], fetch, fluid.Executor(),
                                 main_program=infer, scope=scope)
        t0 = time.perf_counter()
        engine = InferenceEngine(path, batch_buckets=serve["buckets"])
        warm_s = time.perf_counter() - t0
        try:
            names = engine.fetch_names
            ck.reset_launch_counts()
            b0 = engine.metrics.snapshot()["batches_total"]
            answers, latencies, futures, wall = serve_burst(engine,
                                                            requests, None)
            counts = ck.launch_counts()
            batches = engine.metrics.snapshot()["batches_total"] - b0
            direct = [engine.run_direct(r, batch_bucket=f.bucket[0])[0]
                      for r, f in zip(requests, futures)]
        finally:
            engine.close()
        cpu = InferenceEngine(path, device="cpu",
                              batch_buckets=serve["buckets"], warmup=False)
        try:
            on_cpu = [cpu.run_direct(r, batch_bucket=f.bucket[0])[0]
                      for r, f in zip(requests, futures)]
        finally:
            cpu.close()
    steps = cfg["width"] // 2 ** len(cfg["channels"])
    for i, (ans, d, c) in enumerate(zip(answers, direct, on_cpu)):
        dec, n = ans[names[0]], int(ans[names[1]][0])
        check(dec.shape == (1, steps) and dec.dtype == np.int64,
              "ocr: answer %d is %s %s" % (i, dec.shape, dec.dtype))
        for name in names:
            check(np.array_equal(ans[name], d[name]), "ocr: answer %d's %s "
                  "differs from run_direct at its bucket" % (i, name))
            check(np.array_equal(ans[name], c[name]), "ocr: answer %d's %s "
                  "differs from the CPU engine's" % (i, name))
        check(not dec[0, n:].any() and ((dec[0, :n] >= 0) &
                                        (dec[0, :n] < cfg["classes"])).all(),
              "ocr: answer %d has classes outside [0, %d) or past its "
              "length %d" % (i, cfg["classes"], n))
    lat_ms = sorted(x * 1e3 for x in latencies)
    report = {"requests": serve["requests"], "batches": batches,
              "warmup_s": warm_s, "p50_ms": float(np.percentile(lat_ms, 50)),
              "p99_ms": float(np.percentile(lat_ms, 99)), "wall_s": wall,
              "images_per_s": serve["requests"] / wall,
              "buckets": sorted(set(f.bucket for f in futures)),
              "decoded_lengths": [int(a[names[1]][0]) for a in answers],
              "equal_to_run_direct_and_cpu": True, "card": card}
    print("ocr: serving " + json.dumps(report))
    return (counts, dict.fromkeys(counts, 0)), report


# --------------------------------------------------------------- decode --

# phase 30: beam decoding through While, tensor arrays and beam_search.
# Transformer-base at bench.py's widths (MODEL, N_LAYER layers) trained
# as phase 5's fp32 program is (DECODE_TRAIN_STEPS steps of its copy
# task), then build_cached_decode and build_decode for 8 source
# sentences of 16-64 tokens, beam 4, max_out_len 24 (the cut: 24 of the
# 255 output tokens max_length 256 allows); the attention translator at
# phase 8's widths (MT) trained DECODE_TRAIN_STEPS Adam steps, then
# build_decode, beam 4, max_length MT_DECODE_LEN, for phase 8's 16
# source sentences
DECODE = dict(sentences=8, beam=4, max_out_len=24, min_len=16, max_len=64,
              bos=1, eos=2)
DECODE_TRAIN_STEPS = 2
DECODE_SAME_TOKENS = 8   # cached = full, and card = CPU, for this many
DECODE_STEPS = 2         # Executor.run(steps=K): K decodes, one graph
DECODE_SCORE_RTOL = 1e-4  # card vs CPU sentence scores (fp32, 8 steps)
MT_DECODE_LEN = 32


def transformer_decode_program(fluid, transformer, cached, max_out_len):
    """build_cached_decode (cached) or build_decode at MODEL's widths:
    (program, [sentence ids, sentence scores])."""
    fn = (transformer.build_cached_decode if cached
          else transformer.build_decode)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = fn(MODEL["vocab"], MODEL["vocab"], MODEL["max_length"],
                 n_layer=N_LAYER, n_head=MODEL["n_head"],
                 d_key=MODEL["d_key"], d_value=MODEL["d_key"],
                 d_model=MODEL["d_model"], d_inner_hid=MODEL["d_inner"],
                 beam_size=DECODE["beam"], max_out_len=max_out_len,
                 bos_id=DECODE["bos"], eos_id=DECODE["eos"])
    return main, list(out)


def while_iterations(program):
    """The iterations of `program`'s one While: its counter's limit, the
    fill_constant feeding the condition's less_than."""
    ops = program.global_block().ops
    wop = next(op for op in ops if op.type == "while")
    cond = wop.inputs["Condition"][0]
    less = next(op for op in ops if op.type == "less_than"
                and op.outputs["Out"][0] == cond)
    limit = next(op for op in ops if op.type == "fill_constant"
                 and op.outputs["Out"][0] == less.inputs["Y"][0])
    return int(limit.attrs["value"]), program.blocks[wop.attrs["sub_block"]]


def run_one_decode(torch, tag, exe, program, fetch, feed, scope, steps):
    """One decode program on the card: its fetches and launch counts from
    a first run, its host wall ms (call_ms), its synchronizing calls
    (_sync_warnings, fetching device tensors so only the run's own are
    counted) and its device ms (device_busy_ms). Returns (fetches,
    counts, report)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    ck.reset_launch_counts()
    out = exe.run(program, feed=feed, fetch_list=fetch, scope=scope)
    counts = ck.launch_counts()
    wall = call_ms(torch, lambda: exe.run(program, feed=feed,
                                          fetch_list=fetch, scope=scope))
    _, syncs = _sync_warnings(
        torch, lambda: exe.run(program, feed=feed, fetch_list=fetch,
                               scope=scope, return_numpy=False), tag)
    busy, port, prof_wall = device_busy_ms(
        torch, lambda: exe.run(program, feed=feed, fetch_list=fetch,
                               scope=scope))
    report = {"wall_ms": wall, "ms_per_output_token": wall / steps,
              "device_busy_ms": busy, "port_kernel_ms": port,
              "traced_wall_ms": prof_wall,
              "idle_share_est": 1 - busy / prof_wall,
              "synchronizing_calls": syncs, "loop_iterations": steps}
    print("%s: %s" % (tag, json.dumps(report)))
    # the condition's steps + 1 reads, the assertion flags' one read, and
    # in the cached decode one copy of an assign_value constant (pos_row)
    # to the card before the loop
    check(syncs <= steps + 3, "%s made %d synchronizing calls for %d "
          "iterations: the loop reads more than its condition" % (tag, syncs,
                                                                  steps))
    return out, counts, report


def run_captured_decode(torch, tag, exe, program, fetch, feed, scope, steps,
                        eager_out, eager_report):
    """The decode at Executor.run(steps=DECODE_STEPS): DECODE_STEPS decodes
    in one CUDA graph, the While a conditional while node whose condition
    set_while_condition sets on the card. Its first call builds and
    captures; each decode's ids and scores must equal the eager run's bit
    for bit. The second call: its launch counts (the body's counted by the
    iterations the card ran), its synchronizing calls (at most the one
    assertion read after the replays), host and device ms. Returns (the
    second call's counts, the report)."""
    from paddle_tpu_torch.core.executor import to_numpy
    from paddle_tpu_torch.ops import cuda_kernels as ck
    k = DECODE_STEPS

    def run(return_numpy=True):
        return exe.run(program, feed=feed, fetch_list=fetch, scope=scope,
                       steps=k, return_numpy=return_numpy)

    def same(out):
        return all(got.shape == (k,) + want.shape and all(
            np.array_equal(got[i], want) for i in range(k))
            for got, want in zip(out, eager_out))

    t0 = time.perf_counter()
    first = run()
    first_s = time.perf_counter() - t0
    check(same(first), "%s steps=%d: the captured decodes differ from the "
          "eager run" % (tag, k))
    runner = next(reversed(exe._cache.values()))
    check(runner._graph is not None and runner._while_loops,
          "%s steps=%d captured no conditional while node" % (tag, k))
    ck.reset_launch_counts()
    out, syncs = _sync_warnings(torch, lambda: run(False),
                                "%s steps=%d" % (tag, k))
    counts = ck.launch_counts()
    check(same([to_numpy(o) for o in out]), "%s steps=%d: the second call "
          "differs from the eager run" % (tag, k))
    check(syncs <= 1, "%s steps=%d made %d synchronizing calls: more than "
          "the assertion read after the replays" % (tag, k, syncs))
    iterations = counts["set_while_condition"] - k
    check(iterations == k * steps, "%s steps=%d: the card ran %d loop "
          "iterations, %d expected" % (tag, k, iterations, k * steps))
    wall = call_ms(torch, lambda: run(False))
    busy, port, prof_wall = device_busy_ms(torch, lambda: run(False))
    tokens = k * steps
    report = {"steps": k, "first_call_s": first_s,
              "warmup_s": runner.warmup_s, "capture_s": runner.capture_s,
              "wall_ms": wall, "ms_per_output_token": wall / tokens,
              "device_busy_ms": busy, "port_kernel_ms": port,
              "device_ms_per_output_token": busy / tokens,
              "traced_wall_ms": prof_wall,
              "idle_share_est": 1 - busy / prof_wall,
              "synchronizing_calls": syncs,
              "while_iterations": iterations,
              "eager_ms_per_output_token":
                  eager_report["ms_per_output_token"],
              "eager_device_ms_per_output_token":
                  eager_report["device_busy_ms"]
                  / eager_report["loop_iterations"],
              "ids_and_scores_equal_eager": True}
    print("%s steps=%d: %s" % (tag, k, json.dumps(report)))
    exe._cache.clear()
    torch.cuda.empty_cache()
    return counts, report


def run_transformer_decode(torch, card):
    """Phase 30's Transformer-base decodes (see DECODE): trained as phase
    5 trains, then the cached and the full decode on the card (ids of
    [8, 4, 25], BOS first, finite scores; the two equal for the first
    DECODE_SAME_TOKENS tokens), K5 once per layer_norm op of the program
    outside the loop and once per op of the loop's block per iteration;
    then the cached decode cut to DECODE_SAME_TOKENS tokens on the card
    and on the CPU: the same ids, the scores within DECODE_SCORE_RTOL.
    Returns ([(path, (counts, predicted))], the report)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    main, startup, avg_cost = build_train(fluid, transformer, N_LAYER)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    t_max = MODEL["max_length"]
    srcs = [rng.randint(3, MODEL["vocab"], t_max).tolist()
            for _ in range(TRAIN_BATCH)]
    feed = transformer.prepare_batch(srcs, srcs, t_max, labels=True)
    losses = [float(exe.run(main, feed=feed, fetch_list=[avg_cost],
                            scope=scope)[0][0])
              for _ in range(DECODE_TRAIN_STEPS)]
    print("decode: trained Transformer-base (phase 5's fp32 program) %d "
          "steps, losses %s, in %.1f s" % (DECODE_TRAIN_STEPS, losses,
                                           time.perf_counter() - t0))
    del main, feed
    rng = np.random.RandomState(SEED + 300)
    sents = [rng.randint(3, MODEL["vocab"], rng.randint(
        DECODE["min_len"], DECODE["max_len"] + 1)).tolist()
        for _ in range(DECODE["sentences"])]
    args = (sents, t_max, MODEL["n_head"], DECODE["beam"])
    paths, report, ids = [], {"train_losses": losses}, {}
    for kind, cached, prep in (
            ("cached", True, transformer.prepare_cached_decode_batch),
            ("full", False, transformer.prepare_decode_batch)):
        prog, fetch = transformer_decode_program(fluid, transformer, cached,
                                                 DECODE["max_out_len"])
        steps, sub = while_iterations(prog)
        n_ln = (sum(op.type == "layer_norm"
                    for op in prog.global_block().ops),
                sum(op.type == "layer_norm" for op in sub.ops))
        tag = "decode: transformer %s" % kind
        (sid, sscore), counts, r = run_one_decode(
            torch, tag, exe, prog, fetch, prep(*args), scope, steps)
        check(sid.shape == (DECODE["sentences"], DECODE["beam"], steps + 1)
              and (sid[:, :, 0] == DECODE["bos"]).all()
              and np.isfinite(sscore).all(),
              "%s: ids %s, scores %s" % (tag, sid.shape, sscore))
        expected = dict.fromkeys(counts, 0)
        expected["layer_norm_fwd"] = n_ln[0] + n_ln[1] * steps
        r.update({"layer_norm_ops": {"outside_loop": n_ln[0],
                                     "per_iteration": n_ln[1]},
                  "k5_launches": counts["layer_norm_fwd"],
                  "k5_per_iteration": n_ln[1], "first_beam": sid[0, 0,
                                                              :12].tolist()})
        report[kind], ids[kind] = r, sid
        paths.append(("transformer_%s_decode" % kind, (counts, expected)))
        k = DECODE_STEPS
        counts, r["captured"] = run_captured_decode(
            torch, tag, exe, prog, fetch, prep(*args), scope, steps,
            (sid, sscore), r)
        expected = dict.fromkeys(counts, 0)
        expected["layer_norm_fwd"] = k * (n_ln[0] + n_ln[1] * steps)
        expected["set_while_condition"] = k * (1 + steps)
        paths.append(("transformer_%s_decode_steps%d" % (kind, k),
                      (counts, expected)))
        del prog
    same = DECODE_SAME_TOKENS + 1
    check(np.array_equal(ids["cached"][:, :, :same],
                         ids["full"][:, :, :same]),
          "decode: the cached and the full decode differ within the first "
          "%d tokens" % DECODE_SAME_TOKENS)
    report["cached_equals_full_tokens"] = int(next(
        (t for t in range(1, steps + 1)
         if not np.array_equal(ids["cached"][:, :, t], ids["full"][:, :, t])),
        steps + 1) - 1)
    # the cached decode cut to DECODE_SAME_TOKENS tokens, card vs CPU
    prog, fetch = transformer_decode_program(fluid, transformer, True,
                                             DECODE_SAME_TOKENS)
    feed = transformer.prepare_cached_decode_batch(*args)
    card_out = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    state = {v.name: scope.get(v.name).cpu().numpy()
             for v in prog.list_vars() if v.persistable}
    t0 = time.perf_counter()
    cpu_out = fluid.Executor("cpu").run(
        prog, feed=feed, fetch_list=fetch,
        scope=pio.scope_from_numpy(state, "cpu", program=prog))
    cpu_s = time.perf_counter() - t0
    score_err = float((np.abs(card_out[1] - cpu_out[1])
                       / np.abs(cpu_out[1])).max())
    print("decode: the cached decode cut to %d tokens, card vs CPU: ids "
          "equal %s, scores max relative error %.3e (the CPU took %.1f s)"
          % (DECODE_SAME_TOKENS, np.array_equal(card_out[0], cpu_out[0]),
             score_err, cpu_s))
    check(np.array_equal(card_out[0], cpu_out[0]),
          "decode: the card's and the CPU's cached decodes differ")
    check(score_err <= DECODE_SCORE_RTOL, "decode: the card's and the "
          "CPU's sentence scores differ by %r relative" % score_err)
    report["card_vs_cpu"] = {"tokens": DECODE_SAME_TOKENS,
                             "ids_equal": True,
                             "score_max_rel_err": score_err}
    del scope
    torch.cuda.empty_cache()
    return paths, report


def run_translator_decode(torch, card):
    """Phase 30's translator decode: build_train at MT's widths trained
    DECODE_TRAIN_STEPS Adam steps on phase 8's batch, then build_decode
    (attention, beam 4, max_length MT_DECODE_LEN) for its 16 source
    sentences: ids [16, 4, MT_DECODE_LEN + 1] from the start id, finite
    scores, no port kernel. Returns ((counts, predicted), the report)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import machine_translation

    main, startup, avg_cost = build_mt_train(fluid, MT)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    feed, _ = mt_feed(fluid, MT, SEED)
    losses = [float(exe.run(main, feed=feed, fetch_list=[avg_cost],
                            scope=scope)[0][0])
              for _ in range(DECODE_TRAIN_STEPS)]
    prog, dstartup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, dstartup):
        fetch = machine_translation.build_decode(
            dict_size=MT["dict_size"], word_dim=MT["word"],
            hidden_dim=MT["hidden"], decoder_size=MT["decoder"],
            beam_size=DECODE["beam"], max_length=MT_DECODE_LEN,
            start_id=DECODE["bos"], end_id=DECODE["eos"],
            use_attention=True)
    b = MT["batch"]
    init_scores = np.zeros((b, DECODE["beam"]), "float32")
    init_scores[:, 1:] = -1e9
    dfeed = {"src_word_id": feed["src_word_id"],
             "init_ids": np.full((b, DECODE["beam"]), DECODE["bos"],
                                 "int64"),
             "init_scores": init_scores}
    steps, _ = while_iterations(prog)
    (sid, sscore), counts, report = run_one_decode(
        torch, "decode: translator", exe, prog, list(fetch), dfeed, scope,
        steps)
    check(sid.shape == (b, DECODE["beam"], steps + 1)
          and (sid[:, :, 0] == DECODE["bos"]).all()
          and np.isfinite(sscore).all(),
          "decode: translator ids %s, scores %s" % (sid.shape, sscore))
    report.update({"train_losses": losses, "sentences": b,
                   "first_beam": sid[0, 0, :12].tolist()})
    k = DECODE_STEPS
    cap_counts, report["captured"] = run_captured_decode(
        torch, "decode: translator", exe, prog, list(fetch), dfeed, scope,
        steps, (sid, sscore), report)
    cap_expected = dict.fromkeys(cap_counts, 0)
    cap_expected["set_while_condition"] = k * (1 + steps)
    del scope
    torch.cuda.empty_cache()
    return [("translator_decode", (counts, dict.fromkeys(counts, 0))),
            ("translator_decode_steps%d" % k, (cap_counts, cap_expected))], \
        report


# the JAX package's text for a While writing past its array's capacity 4
# (tests/test_torch_while.py holds the port to it on the CPU), %r the
# array's name
OVERFLOW_MESSAGE = (
    "2 in-graph assertions tripped in this run:\n"
    "- tensor array %r overflowed its capacity 4 inside traced "
    "control flow; pass a larger capacity to create_array()\n"
    "- a tensor array confined to a loop/conditional sub-block overflowed "
    "its capacity inside traced control flow; pass a larger capacity to "
    "create_array()")


def overflow_program(fluid, capacity, iters):
    """A While writing a new [4] value at index i + 1 for i < iters into
    an array of `capacity`."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        counter = layers.zeros(shape=[1], dtype="int32")
        counter.stop_gradient = True
        limit = layers.fill_constant(shape=[1], dtype="int32", value=iters)
        arr = layers.create_array("float32", capacity=capacity)
        x = layers.fill_constant(shape=[4], dtype="float32", value=1.0)
        layers.array_write(x, counter, arr)
        cond = layers.less_than(x=counter, y=limit)
        while_op = layers.While(cond=cond)
        with while_op.block():
            v = layers.array_read(arr, counter)
            layers.increment(counter, 1, in_place=True)
            layers.array_write(layers.elementwise_add(x=v, y=x), counter,
                               arr)
            layers.less_than(x=counter, y=limit, cond=cond)
        out = layers.array_read(arr, counter)
    return main, out, arr.name


def run_control_flow_checks(torch):
    """Phase 30's checks of the loop machinery on the card: a While
    writing past its array's capacity raises the JAX package's
    RuntimeError, and the context still runs a kernel after it (K5
    against its plain version: no device-side assert); within capacity
    the loop gives 11; Executor.run(steps=4) on the program gives 11 at
    each of its 4 steps through a conditional while node, and the
    overflowing program raises the same message under steps=4."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import cuda_kernels as ck

    exe = fluid.Executor()
    main, out, name = overflow_program(fluid, 4, 10)
    try:
        exe.run(main, fetch_list=[out], scope=fluid.Scope())
        raised = None
    except RuntimeError as e:
        raised = str(e)
    check(raised == OVERFLOW_MESSAGE % name, "decode: the overflowing "
          "While raised %r" % raised)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 301)
    x = torch.randn((32, MODEL["d_model"]), generator=g, device=dev)
    sc, bi = x[0].clone(), x[1].clone()
    y = ck.layer_norm_fwd(x, sc, bi, 1e-5)[0]
    torch.cuda.synchronize()
    err = float((y - ck.layer_norm_fwd_plain(x, sc, bi, 1e-5)[0]).abs().max())
    check(err <= KERNEL_TOL, "decode: K5 after the overflow is %r from its "
          "plain version" % err)
    main, out, _ = overflow_program(fluid, 16, 10)
    val, = exe.run(main, fetch_list=[out], scope=fluid.Scope())
    check(np.array_equal(val, np.full(4, 11.0, "float32")),
          "decode: the While within capacity gave %s" % val)
    val4, = exe.run(main, fetch_list=[out], scope=fluid.Scope(), steps=4)
    check(np.array_equal(val4, np.full((4, 4), 11.0, "float32")),
          "decode: the While within capacity at steps=4 gave %s" % val4)
    main, out, name = overflow_program(fluid, 4, 10)
    try:
        exe.run(main, fetch_list=[out], scope=fluid.Scope(), steps=4)
        raised4 = None
    except RuntimeError as e:
        raised4 = str(e)
    check(raised4 == OVERFLOW_MESSAGE % name, "decode: the overflowing "
          "While at steps=4 raised %r" % raised4)
    print("decode: an overflowing While raised the JAX package's message, "
          "then K5 ran (max_abs_err %.3e against its plain version); at "
          "steps=4 the While ran as a conditional while node (11 at each "
          "step) and the overflow raised the same message" % err)
    return {"overflow_raised": True, "k5_after_overflow_err": err,
            "steps4_equal": True, "steps4_overflow_raised": True}


# the kernel of the conditional while node (csrc/graph_while.cu): no TPU
# kernel; it replaces the device-side predicate of the JAX package's While
# rule, a lax.while_loop
GRAPH_WHILE_SRC = "paddle_tpu_torch/csrc/graph_while.cu"
GRAPH_WHILE_REPLACES = "paddle_tpu/ops/control_ops.py:249 (the While " \
    "rule's lax.while_loop predicate; no pl.pallas_call)"
WHILE_LOOP_ITERS = 10000   # the timed loop's iterations


def graph_while_loop(torch, ck, n):
    """A CUDA graph holding one conditional while node whose body adds 1
    to a counter, compares it with n and sets the node's condition
    (set_while_condition); returns (graph, counter, the tensors the graph
    reads and writes, which must outlive it). The body allocates
    nothing."""
    dev = torch.device("cuda")
    counter = torch.zeros((1,), dtype=torch.int64, device=dev)
    limit = torch.full((1,), n, dtype=torch.int64, device=dev)
    cond = torch.zeros((1,), dtype=torch.bool, device=dev)
    side, body = torch.cuda.Stream(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        counter.zero_()
        torch.lt(counter, limit, out=cond)
        handle = ck.graph_while_begin(cond, body)
        with torch.cuda.stream(body):
            counter.add_(1)
            torch.lt(counter, limit, out=cond)
            ck.set_while_condition(handle, cond)
        ck.graph_while_end(body)
    return graph, counter, (limit, cond)


WHILE_SET_LAUNCHES = 1000  # set_while_condition launches in the timed body


def graph_while_sets(torch, ck, m):
    """A CUDA graph holding one conditional while node whose body holds
    nothing but m launches of set_while_condition on a condition that is
    already False: the loop enters (its entry condition True) and runs its
    body once. Returns (graph, the tensors it reads, which must outlive
    it)."""
    dev = torch.device("cuda")
    entry = torch.ones((1,), dtype=torch.bool, device=dev)
    stop = torch.zeros((1,), dtype=torch.bool, device=dev)
    side, body = torch.cuda.Stream(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        handle = ck.graph_while_begin(entry, body)
        with torch.cuda.stream(body):
            for _ in range(m):
                ck.set_while_condition(handle, stop)
        ck.graph_while_end(body)
    return graph, (entry, stop)


def replay_ms(torch, graph, reps=7):
    """Median device ms of one replay of `graph` (CUDA events around it)."""
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def run_while_kernel(torch, ck, peak_bw):
    """set_while_condition held against its plain version: the loop of
    graph_while_loop replayed on the card against the same loop on the
    host, whose condition set_while_condition_plain reads each iteration
    (max_abs_err: the counters' difference) at 0, 1, 7 and
    WHILE_LOOP_ITERS iterations. Timed (CUDA events around a replay,
    median of 7): the kernel alone (`ms`: graph_while_sets' body of
    WHILE_SET_LAUNCHES launches, over the launches) and one iteration of
    the loop (`loop_iteration_ms`: add, compare, set_while_condition,
    over WHILE_LOOP_ITERS); the plain loop's host wall over its
    iterations. The bound is the byte it reads. Its launches are counted
    on phase 30's decodes."""
    dev = torch.device("cuda")
    err = 0.0
    for n in (0, 1, 7, WHILE_LOOP_ITERS):
        graph, counter, keep = graph_while_loop(torch, ck, n)
        graph.replay()
        torch.cuda.synchronize()
        plain = torch.zeros((1,), dtype=torch.int64, device=dev)
        while ck.set_while_condition_plain(plain < n):
            plain.add_(1)
        err = max(err, float((counter - plain).abs().max()))
        check(int(counter) == n, "set_while_condition: the loop of %d "
              "iterations ran %d" % (n, int(counter)))
    loop_ms = replay_ms(torch, graph) / WHILE_LOOP_ITERS
    check(int(counter) == WHILE_LOOP_ITERS, "set_while_condition: a timed "
          "replay ran %d iterations" % int(counter))
    sets, keep_sets = graph_while_sets(torch, ck, WHILE_SET_LAUNCHES)
    set_ms = replay_ms(torch, sets) / WHILE_SET_LAUNCHES
    plain = torch.zeros((1,), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    while ck.set_while_condition_plain(plain < WHILE_LOOP_ITERS):
        plain.add_(1)
    plain_ms = (time.perf_counter() - ts) * 1e3 / WHILE_LOOP_ITERS
    bms, bby = bound(0, 1, 1, peak_bw)
    r = {"name": "set_while_condition", "route": "cuda",
         "source": GRAPH_WHILE_SRC, "replaces": GRAPH_WHILE_REPLACES,
         "shape": "cond [1] bool; ms: one launch in a body of %d launches "
                  "and nothing else; loop_iteration_ms: one iteration of a "
                  "%d-iteration loop of 3 kernels (add, compare, "
                  "set_while_condition)"
                  % (WHILE_SET_LAUNCHES, WHILE_LOOP_ITERS),
         "max_abs_err": err, "ms": set_ms, "loop_iteration_ms": loop_ms,
         "plain_ms": plain_ms,
         "plain_covers": "one iteration of the host loop (add, compare, "
                         "read)",
         "library_ms": None, "bound_ms": bms, "bound_by": bby}
    print("kernels: set_while_condition %s" % json.dumps(r))
    check(err == 0, "set_while_condition's loop differs from the host "
          "loop by %r" % err)
    return {"set_while_condition": r}


# faults C14 and C15: warpctc and edit_distance with indices out of range
# take jnp.take_along_axis's rule (a negative index wraps, one past the end
# reads NaN); the card must equal the CPU, NaN for NaN
C14_CASES = {"label_len_above_u": dict(label_len=(4, 2, 7)),
             "label_len_negative": dict(label_len=(1, -1, 2)),
             "label_at_or_above_c": dict(labels=[[1, 2, 3], [7, 1, 2],
                                                 [5, 5, 1]]),
             "label_negative": dict(labels=[[-1, 2, 3], [1, -2, 3],
                                            [-6, 3, 4]])}
C15_CASES = {"hyps_len_above_u": ((5, 4), (4, 4)),
             "refs_len_above_u": ((4, 4), (3, 5)),
             "negative_lengths": ((-1, 4), (4, -2))}


def ctc_fault_inputs(labels=None, label_len=(3, 2, 1)):
    """warpctc's C14 case: B 3, T 6, C 5, U 3, blank 0, XLen 6."""
    rng = np.random.RandomState(SEED)
    label = rng.randint(1, 5, (3, 3)).astype(np.int64) if labels is None \
        else np.asarray(labels, np.int64)
    return {"Logits": [rng.randn(3, 6, 5).astype(np.float32)],
            "Label": [label[:, :, None]],
            "XLen": [np.full((3,), 6, np.int32)],
            "LabelLen": [np.asarray(label_len, np.int32)]}


def nan_equal(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same_nan = np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    return same_nan and (not ok.any() or float(
        np.abs(a[ok] - b[ok]).max()) <= tol * max(1.0, float(
            np.abs(b[ok]).max())))


def run_ctc_fault_checks(torch):
    """C14 (warpctc's loss and its gradient) and C15 (edit_distance, raw
    and normalized) on the card against the CPU, NaN for NaN, values
    within SEQ_OPS_TOL of max(1, max |cpu|)."""
    rows = []
    for case, kw in sorted(C14_CASES.items()):
        ins = ctc_fault_inputs(**kw)
        got, ggot, cots, _ = run_seq_op(torch, "warpctc", ins, {"blank": 0},
                                        ["Loss"], "cuda")
        want, gwant, _, _ = run_seq_op(torch, "warpctc", ins, {"blank": 0},
                                       ["Loss"], "cpu", cots=cots)
        loss, ref = got["Loss"][0].numpy(), want["Loss"][0].numpy()
        ok = nan_equal(loss, ref, SEQ_OPS_TOL) and nan_equal(
            ggot[("Logits", 0)].numpy(), gwant[("Logits", 0)].numpy(),
            SEQ_OPS_TOL)
        rows.append(ok)
        print("C14: warpctc %s: card loss %s, cpu %s, gradient NaN rows "
              "%d; %s" % (case, np.round(loss[:, 0], 4).tolist(),
                          np.round(ref[:, 0], 4).tolist(),
                          int(np.isnan(ggot[("Logits", 0)].numpy()).any(
                              axis=(1, 2)).sum()),
                          "equal" if ok else "DIFFER"))
    check(all(rows), "C14: warpctc differs between the card and the CPU")
    rows = []
    for case, (hlen, rlen) in sorted(C15_CASES.items()):
        ins = {"Hyps": [np.array([[1, 2, 3, 4], [2, 3, 4, 5]], np.int64)],
               "Refs": [np.array([[1, 2, 4, 0], [2, 2, 2, 2]], np.int64)],
               "HypsLen": [np.asarray(hlen, np.int64)],
               "RefsLen": [np.asarray(rlen, np.int64)]}
        for normalized in (False, True):
            attrs = {"normalized": normalized}
            got = run_seq_op(torch, "edit_distance", ins, attrs, [],
                             "cuda")[0]["Out"][0].numpy()
            want = run_seq_op(torch, "edit_distance", ins, attrs, [],
                              "cpu")[0]["Out"][0].numpy()
            ok = np.array_equal(got, want, equal_nan=True)
            rows.append(ok)
            print("C15: edit_distance %s normalized=%s: card %s, cpu %s; %s"
                  % (case, normalized, got[:, 0].tolist(),
                     want[:, 0].tolist(), "equal" if ok else "DIFFER"))
    check(all(rows), "C15: edit_distance differs between the card and the "
          "CPU")


# phase 31: decode serving (ROADMAP A7). (a) the repo's decode leg at its
# own defaults (bench.py:624-629: slots 8, 48 streams, base tokens 24 with
# the leg's mixed budgets, hidden 256, vocab 4096, 4 tanh layers, seed 11;
# the serial run through solo_clone, the open loop on the leg's fixed
# arrival schedule at 2x the serial stream rate); (b) the same step with a
# layer_norm after each hidden fc at Transformer-base's d_model 512 and
# vocab 30000, 6 layers, 16 streams of 8-32 tokens (K5 on rows [8, 512]);
# (c) Transformer-base scoring (phase 4's model and requests) at
# weights_dtype "bf16" and "int8" against fp32; (d) the HTTP ModelServer
# over (a)'s engine and (c)'s fp32 engine.
DECODE_BENCH = dict(slots=8, streams=48, tokens=24, hidden=256, vocab=4096,
                    layers=4, seed=11, layer_norm=False)
DECODE_LN = dict(slots=8, streams=16, tokens=(8, 32), hidden=512,
                 vocab=30000, layers=6, seed=11, layer_norm=True)
DECODE_VS_CPU = 8        # streams decoded on the CPU too, tokens equal
DECODE_PROBE = 8         # streams a closed burst (host / device / syncs)
WD_BUCKETS = [1, 4, 8]   # weight-dtype serving's batch buckets (phase 4's)


def build_decode_step(fluid, cfg):
    """bench.py's decode step (bench_decode): carried token, hidden and
    context rows per slot, `layers` tanh fcs (each followed by layer_norm
    with cfg["layer_norm"]), logits over the vocabulary, greedy argmax fed
    back, finished = (token == 0). Returns (main, startup, token,
    finished)."""
    slots, hidden = cfg["slots"], cfg["hidden"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = cfg["seed"]
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tok = fluid.layers.create_global_var([slots, 1], 0, "int64",
                                             persistable=True, name="tok")
        h = fluid.layers.create_global_var([slots, hidden], 0.0, "float32",
                                           persistable=True, name="h")
        ctx = fluid.layers.create_global_var([slots, hidden], 0.0,
                                             "float32", persistable=True,
                                             name="ctx")
        z = fluid.layers.concat(
            [fluid.layers.cast(tok, "float32"), h, ctx], axis=1)
        for _ in range(cfg["layers"]):
            z = fluid.layers.fc(input=z, size=hidden, act="tanh")
            if cfg["layer_norm"]:
                z = fluid.layers.layer_norm(z, begin_norm_axis=1)
        logits = fluid.layers.fc(input=z, size=cfg["vocab"])
        nxt = fluid.layers.reshape(
            fluid.layers.argmax(logits, axis=1), shape=[slots, 1])
        fin = fluid.layers.equal(
            nxt, fluid.layers.fill_constant([slots, 1], "int64", 0))
        fluid.layers.assign(nxt, output=tok)
        fluid.layers.assign(z, output=h)
    return main, startup, nxt, fin


def decode_streams(cfg):
    """(feeds, budgets): bench.py's stream feeds (start token i mod
    (vocab - 1) + 1, a random context row from seed 0) and its mixed
    budgets, or budgets spread over cfg["tokens"] = (lo, hi)."""
    n, vocab = cfg["streams"], cfg["vocab"]
    rng = np.random.RandomState(0)
    feeds = [{"tok": np.array([i % (vocab - 1) + 1], dtype="int64"),
              "ctx": rng.randn(cfg["hidden"]).astype("float32")}
             for i in range(n)]
    if isinstance(cfg["tokens"], tuple):
        lo, hi = cfg["tokens"]
        budgets = [lo + (i * 7) % (hi - lo + 1) for i in range(n)]
    else:
        base = cfg["tokens"]
        budgets = [max(4, base // 2 + (i * 7) % base) for i in range(n)]
    return feeds, budgets


def cpu_decoder(engine):
    """A DecodeEngine on the CPU over `engine`'s program and weights."""
    from paddle_tpu_torch.serving import DecodeEngine
    cpu = DecodeEngine(program=engine.program, token_var=engine.token_name,
                       finished_var=engine.finished_name,
                       slot_vars=list(engine.slot_vars),
                       max_slots=engine.max_slots, place="cpu",
                       name=engine.name + "-cpu", warmup=False)
    for n in engine._state_ro:
        if n not in engine.slot_vars:
            cpu._scope.set(n, engine._scope.get(n).detach().cpu())
    return cpu


def decode_burst(engine, feeds, budgets):
    """The streams submitted at once, each's tokens as a flat array."""
    streams = [engine.submit(f, max_new_tokens=b)
               for f, b in zip(feeds, budgets)]
    return [np.asarray(s.result(600)).reshape(-1) for s in streams]


def run_decode_leg(torch, card, cfg, tag):
    """One decode leg of phase 31 on the card: the serial run through
    solo_clone, then the open loop (counts zeroed just before it, read
    just after), divergence from solo (must be 0), the first
    DECODE_VS_CPU streams on the CPU (tokens equal), then closed bursts
    of DECODE_PROBE streams for host ms an iteration, device ms an
    iteration under the profiler and synchronizing calls an iteration.
    Returns ((counts, expected), summary, the engine, the serial
    tokens)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import DecodeEngine

    t0 = time.perf_counter()
    main, startup, nxt, fin = build_decode_step(fluid, cfg)
    feeds, budgets = decode_streams(cfg)
    base = max(budgets)
    engine = DecodeEngine(program=main, startup_program=startup,
                          token_var=nxt, finished_var=fin,
                          max_slots=cfg["slots"], name="decode-" + tag,
                          queue_capacity=max(1024, len(feeds)),
                          default_max_new_tokens=base)
    build_s = time.perf_counter() - t0
    solo = engine.solo_clone(name="decode-%s-solo" % tag)
    try:
        t0 = time.perf_counter()
        serial = [np.asarray(solo.decode(f, max_new_tokens=b)).reshape(-1)
                  for f, b in zip(feeds, budgets)]
        serial_dt = time.perf_counter() - t0
    finally:
        solo.close()
    serial_tokens = int(sum(len(s) for s in serial))

    rate = 2.0 * len(feeds) / serial_dt
    before = engine.decode_stats()
    ck.reset_launch_counts()
    streams, t0 = [], time.perf_counter()
    for i, f in enumerate(feeds):
        delay = t0 + i / rate - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        streams.append(engine.submit(f, max_new_tokens=budgets[i]))
    cont = [np.asarray(s.result(600)).reshape(-1) for s in streams]
    cont_dt = time.perf_counter() - t0
    counts = ck.launch_counts()
    stats = engine.decode_stats()
    iters = stats["iterations"] - before["iterations"]
    cont_tokens = int(sum(len(s) for s in cont))
    mismatched = [i for i, (a, b) in enumerate(zip(cont, serial))
                  if a.shape != b.shape or not np.array_equal(a, b)]
    print("decode %s: %d streams, %d tokens, %d iterations; divergence "
          "from solo %d/%d" % (tag, len(feeds), cont_tokens, iters,
                               len(mismatched), len(feeds)))
    check(not mismatched, "decode %s: streams %s differ from their solo "
          "decodes" % (tag, mismatched))

    cpu = cpu_decoder(engine)
    try:
        t0 = time.perf_counter()
        on_cpu = [np.asarray(cpu.decode(f, max_new_tokens=b)).reshape(-1)
                  for f, b in zip(feeds[:DECODE_VS_CPU],
                                  budgets[:DECODE_VS_CPU])]
        cpu_s = time.perf_counter() - t0
    finally:
        cpu.close()
    cpu_diff = [i for i, (a, b) in enumerate(zip(on_cpu, serial))
                if a.shape != b.shape or not np.array_equal(a, b)]
    print("decode %s: the first %d streams on the CPU (same weights): %d "
          "differ (%.1f s)" % (tag, DECODE_VS_CPU, len(cpu_diff), cpu_s))
    check(not cpu_diff, "decode %s: streams %s differ between the card "
          "and the CPU" % (tag, cpu_diff))

    probe_feeds = feeds[:DECODE_PROBE]
    probe_budgets = [base] * DECODE_PROBE

    def probe(fn):
        i0 = engine.decode_stats()["iterations"]
        out = fn()
        return out, engine.decode_stats()["iterations"] - i0

    wall_ms, n_plain = probe(lambda: call_ms(torch, lambda: decode_burst(
        engine, probe_feeds, probe_budgets)))
    (busy, port, wall), n_prof = probe(lambda: device_busy_ms(
        torch, lambda: decode_burst(engine, probe_feeds, probe_budgets)))
    (_, syncs), n_sync = probe(lambda: _sync_warnings(
        torch, lambda: decode_burst(engine, probe_feeds, probe_budgets),
        tag="decode %s" % tag))
    summary = {
        "config": {k: cfg[k] for k in ("slots", "streams", "hidden",
                                       "vocab", "layers", "seed",
                                       "layer_norm")},
        "build_s": build_s,
        "serial_tokens": serial_tokens, "serial_s": serial_dt,
        "serial_tokens_per_s": serial_tokens / serial_dt,
        "continuous_tokens": cont_tokens, "continuous_s": cont_dt,
        "continuous_tokens_per_s": cont_tokens / cont_dt,
        "speedup_vs_serial": (cont_tokens / cont_dt) /
        (serial_tokens / serial_dt),
        "open_arrival_streams_per_s": rate,
        "divergence_vs_solo": len(mismatched) / float(len(feeds)),
        "cpu_streams_equal": len(on_cpu) - len(cpu_diff),
        "iterations": iters,
        "mean_slot_occupancy": (stats["mean_slot_occupancy"]),
        "inter_token_p50_ms": stats["inter_token_p50_ms"],
        "inter_token_p99_ms": stats["inter_token_p99_ms"],
        "host_ms_per_iteration": wall_ms / max(n_plain, 1),
        "profiled_iterations": n_prof,
        "profiled_host_ms_per_iteration": wall / max(n_prof, 1),
        "device_ms_per_iteration": busy / max(n_prof, 1),
        "port_kernel_ms_per_iteration": port / max(n_prof, 1),
        "idle_share": 1.0 - busy / wall if wall > 0 else None,
        "sync_calls": syncs, "sync_iterations": n_sync,
        "sync_calls_per_iteration": syncs / max(n_sync, 1),
        "launches_per_iteration": {k: v / max(iters, 1)
                                   for k, v in counts.items() if v},
        "card": card,
    }
    print("decode %s: %s" % (tag, json.dumps(summary)))
    check(0.5 <= summary["sync_calls_per_iteration"] <= 1.5,
          "decode %s: %d synchronizing calls over %d iterations, expected "
          "one an iteration" % (tag, syncs, n_sync))
    expected = dict.fromkeys(counts, 0)
    if cfg["layer_norm"]:
        expected["layer_norm_fwd"] = cfg["layers"] * iters
    return (counts, expected), summary, engine, serial


def run_decode_k5(torch, card, peak_flops, peak_bw):
    """K5 against its plain version at the slot-decode rows [slots, d]
    (phase 30's tolerance), timed beside its bound and F.layer_norm."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import cuda_kernels as ck
    n, dm = DECODE_LN["slots"], DECODE_LN["hidden"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 310)
    x = torch.randn((n, dm), generator=g, device="cuda")
    sc = torch.randn((dm,), generator=g, device="cuda")
    bi = torch.randn((dm,), generator=g, device="cuda")
    got = ck.layer_norm_fwd(x, sc, bi, 1e-5)
    want = ck.layer_norm_fwd_plain(x, sc, bi, 1e-5)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    check(np.isfinite(err) and err <= KERNEL_TOL,
          "decode: layer_norm_fwd at [%d, %d] disagrees with its plain "
          "version by %r" % (n, dm, err))
    bms, bby = bound(8 * n * dm, 4 * (2 * n * dm + 2 * dm + 2 * n),
                     peak_flops, peak_bw)
    row = {"shape": "x [%d,%d] fp32" % (n, dm), "max_abs_err": err,
           "ms": time_ms(torch, lambda: ck.layer_norm_fwd(x, sc, bi, 1e-5)),
           "plain_ms": time_ms(
               torch, lambda: ck.layer_norm_fwd_plain(x, sc, bi, 1e-5)),
           "library_ms": time_ms(
               torch, lambda: F.layer_norm(x, (dm,), sc, bi, 1e-5)),
           "bound_ms": bms, "bound_by": bby, "card": card}
    print("decode k5: %s" % json.dumps(row))
    return row


def weights_bytes(engine):
    """Bytes of the engine scope's persistables on the device."""
    total = 0
    for v in engine.program.list_vars():
        t = engine._scope.get(v.name) if v.persistable else None
        if t is not None:
            total += t.numel() * t.element_size()
    return total


def run_bf16_k1_serving_shape(torch):
    """The bf16 K1 against its plain version at the scoring dispatch's
    attention shape ([8, 256, 8, 64], ragged kv_len), within
    BF16_KERNEL_TOL."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    g = torch.Generator(device="cuda").manual_seed(SEED + 311)
    b, t, h, d = WD_BUCKETS[-1], MODEL["max_length"], MODEL["n_head"], \
        MODEL["d_key"]
    q, k, v = [torch.randn((b, t, h, d), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3)]
    kv = torch.tensor([256, 0, 37, 129, 200, 64, 255, 96], device="cuda",
                      dtype=torch.int32)
    out, lse = ck.flash_attention_fwd(q, k, v, kv)
    ref, ref_lse = ck.flash_attention_fwd_plain(q, k, v, kv)
    torch.cuda.synchronize()
    err = rel_err((out.float(),), (ref.float(),))
    e_lse = (lse - ref_lse).abs().max().item()
    check(np.isfinite(err) and err <= BF16_KERNEL_TOL and e_lse <= KERNEL_TOL,
          "weights_dtype: the bf16 K1 at [%d, %d, %d, %d] disagrees with its "
          "plain version: out %r, lse %r" % (b, t, h, d, err, e_lse))
    return {"shape": "q, k, v [%d,%d,%d,%d] bf16" % (b, t, h, d),
            "rel_err": err, "lse_err": e_lse}


def run_weights_dtype_serving(torch, card, model_dir, requests, predict):
    """Phase 31 (c): the fp32, bf16 and int8 engines over one saved
    Transformer-base scoring model, 16 requests each (counts zeroed just
    before each burst and read just after); every bf16 / int8 answer
    within divergence_bound of the fp32 engine's; p50 / p99; the weights'
    bytes on the device; one dispatch's host ms at bucket 8; int8's
    dequantize ops' device ms a dispatch. Returns (paths, summary, the
    fp32 engine, its answers)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import InferenceEngine
    from paddle_tpu_torch.serving.quantize import divergence_bound

    n_flash, n_ln = 3 * N_LAYER, 5 * N_LAYER + 2
    paths, summary, ref, ref_engine = [], {}, None, None
    for wd in ("fp32", "bf16", "int8"):
        t0 = time.perf_counter()
        engine = InferenceEngine(model_dir, batch_buckets=WD_BUCKETS,
                                 weights_dtype=wd, name="transformer-" + wd)
        load_s = time.perf_counter() - t0
        try:
            ck.reset_launch_counts()
            b0 = engine.metrics.snapshot()["batches_total"]
            answers, latencies, _, wall = serve_burst(engine, requests,
                                                      predict.name)
            counts = ck.launch_counts()
            batches = engine.metrics.snapshot()["batches_total"] - b0
            flash = "flash_attention_fwd_bf16" if wd == "bf16" \
                else "flash_attention_fwd"
            expected = dict.fromkeys(counts, 0)
            expected.update({flash: n_flash * batches,
                             "layer_norm_fwd": n_ln * batches})
            paths.append(("transformer_serving_" + wd, (counts, expected)))
            lat = sorted(x * 1e3 for x in latencies)
            row = {"load_s": load_s, "batches": batches,
                   "p50_ms": float(np.percentile(lat, 50)),
                   "p99_ms": float(np.percentile(lat, 99)),
                   "wall_s": wall,
                   "weights_bytes": weights_bytes(engine),
                   "flash_launches_per_dispatch":
                   counts[flash] / max(batches, 1),
                   "layer_norm_launches_per_dispatch":
                   counts["layer_norm_fwd"] / max(batches, 1),
                   "dispatch_ms_bucket8": statistics.median(
                       call_ms(torch, lambda: engine.run_direct(
                           requests[0], batch_bucket=WD_BUCKETS[-1]))
                       for _ in range(5))}
            if wd == "fp32":
                ref, ref_engine = answers, engine
                engine = None
            else:
                div = max(float(np.abs(a.astype(np.float64)
                                       - r.astype(np.float64)).max()
                                / (np.abs(r).max() + 1e-6))
                          for a, r in zip(answers, ref))
                row["divergence"] = div
                row["divergence_bound"] = divergence_bound(wd)
                row["weights_bytes_vs_fp32"] = \
                    row["weights_bytes"] / summary["fp32"]["weights_bytes"]
                check(all(np.isfinite(a).all() for a in answers)
                      and div <= divergence_bound(wd),
                      "weights_dtype %s: answers %r from fp32's (bound %r)"
                      % (wd, div, divergence_bound(wd)))
            if wd == "int8":
                row["dequantize_ms_per_dispatch"] = int8_dequantize_ms(
                    torch, engine)
            summary[wd] = row
            print("weights_dtype %s: %s" % (wd, json.dumps(row)))
        finally:
            if engine is not None:
                engine.close()
    summary["bf16_k1_serving_shape"] = run_bf16_k1_serving_shape(torch)
    summary["card"] = card
    return paths, summary, ref_engine, ref


def int8_dequantize_ms(torch, engine):
    """Device ms of one dispatch's dequantize_channel ops: the plain
    widening of every int8 weight to f32 (the rule, replayed from a CUDA
    graph)."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.lowering import LowerCtx
    ops = [op for op in engine.program.global_block().ops
           if op.type == "dequantize_channel"]
    rule = registry.get("dequantize_channel")
    ctx = LowerCtx(None, engine.device)
    ins = [{"X": [engine._scope.get(op.input("X")[0])],
            "Scale": [engine._scope.get(op.input("Scale")[0])]}
           for op in ops]

    def run():
        for op, i in zip(ops, ins):
            rule.lower(ctx, i, op.attrs)
    return time_ms(torch, run, iters=5)


def http_json(url, payload=None, timeout=600):
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def run_model_server(torch, card, decoder, feed, budget, want_tokens,
                     scorer, request):
    """Phase 31 (d): a ModelServer on 127.0.0.1, port 0, over the decode
    engine and the fp32 scoring engine: one :predict equal to run_direct
    exactly, one streamed :decode equal to the solo decode exactly, and
    /metrics with the decode gauges."""
    from paddle_tpu_torch.serving import ModelServer
    server = ModelServer({"decode": decoder, "transformer": scorer},
                         port=0).start()
    base = "http://%s" % server.address
    try:
        t0 = time.perf_counter()
        resp = json.loads(http_json(
            base + "/v1/models/transformer:predict",
            {"inputs": {k: np.asarray(v).tolist()
                        for k, v in request.items()}}).read())
        predict_s = time.perf_counter() - t0
        name = scorer.fetch_names[0]
        got = np.asarray(resp["outputs"][name], dtype=np.float32)
        want, _ = scorer.run_direct(request, batch_bucket=resp["bucket"][0])
        check(got.shape == want[name].shape
              and np.array_equal(got, want[name]),
              "server: :predict differs from run_direct (shape %s)"
              % (got.shape,))
        t0 = time.perf_counter()
        lines = [json.loads(x) for x in http_json(
            base + "/v1/models/decode:decode",
            {"inputs": {k: np.asarray(v).tolist() for k, v in feed.items()},
             "max_new_tokens": budget}).read().decode().splitlines()
            if x.strip()]
        decode_s = time.perf_counter() - t0
        tokens = [ln["token"][0] for ln in lines if "token" in ln]
        check(lines and lines[-1].get("done") is True
              and np.array_equal(tokens, want_tokens),
              "server: :decode streamed %s, the solo decode gave %s"
              % (lines[-1:], list(want_tokens)))
        text = http_json(base + "/metrics").read().decode()
        check("ptpu_decode_slots" in text
              and "ptpu_decode_tokens_total" in text
              and 'ptpu_serving_requests_total{model="transformer"}' in text,
              "server: /metrics lacks the decode or serving families")
        health = json.loads(http_json(base + "/healthz").read())
        check(health["status"] == "ok", "server: /healthz %r" % health)
    finally:
        server.shutdown()
    row = {"predict_s": predict_s, "decode_s": decode_s,
           "decode_lines": len(lines), "metrics_lines": len(
               text.splitlines()), "card": card}
    print("server: %s" % json.dumps(row))
    return row


def run_decode_serving(torch, card, peak_flops, peak_bw):
    """Phase 31 (see the constants above). Returns (paths, summary)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer

    paths, summary = [], {}
    run, summary["bench"], bench_engine, bench_serial = run_decode_leg(
        torch, card, DECODE_BENCH, "bench")
    paths.append(("decode_bench", run))
    try:
        run, summary["layer_norm"], ln_engine, _ = run_decode_leg(
            torch, card, DECODE_LN, "layer_norm")
        ln_engine.close()
        paths.append(("decode_layer_norm", run))
        summary["k5_slot_rows"] = run_decode_k5(torch, card, peak_flops,
                                                peak_bw)
        summary["k5_slot_rows"]["launches_per_iteration"] = \
            summary["layer_norm"]["launches_per_iteration"].get(
                "layer_norm_fwd", 0)
        check(summary["k5_slot_rows"]["launches_per_iteration"] ==
              DECODE_LN["layers"], "decode: K5 launched %r times an "
              "iteration, expected %d" % (
                  summary["k5_slot_rows"]["launches_per_iteration"],
                  DECODE_LN["layers"]))
        requests = scoring_requests(transformer)
        main, startup, predict = build_scoring(fluid, transformer)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        with tempfile.TemporaryDirectory(prefix="ptt_smoke_") as model_dir:
            fluid.io.save_inference_model(
                model_dir, transformer.SCORING_FEED_NAMES, [predict], exe,
                main, scope=scope)
            del scope
            wd_paths, summary["weights_dtype"], scorer, _ = \
                run_weights_dtype_serving(torch, card, model_dir, requests,
                                          predict)
            paths += wd_paths
            try:
                feeds, budgets = decode_streams(DECODE_BENCH)
                summary["server"] = run_model_server(
                    torch, card, bench_engine, feeds[0], budgets[0],
                    bench_serial[0], scorer, requests[1])
            finally:
                scorer.close()
    finally:
        bench_engine.close()
    torch.cuda.empty_cache()
    return paths, summary


# ------------------------------------------------------------ readers --

# phase 32: Transformer-base (bench.py's configuration, phase 19's bf16
# AMP program with fused attention) trained from recordio files: 16
# batches of the copy task (batch 32, T=256) through a DataFeeder and
# recordio_writer into two files, read back by open_files(thread_num=2)
# -> double_buffer -> read_file, at Executor.run(steps=4, prefetch=True)
READER = dict(batches=16, files=2, threads=2, steps=4, calls=2)


def reader_batches(transformer):
    """The 16 batches of phase 32 as prepare_batch feeds (copy task, full
    length, a fixed seed)."""
    rng = np.random.RandomState(SEED + 320)
    t = MODEL["max_length"]
    out = []
    for _ in range(READER["batches"]):
        srcs = [rng.randint(3, MODEL["vocab"], t).tolist()
                for _ in range(TRAIN_BATCH)]
        out.append(transformer.prepare_batch(srcs, srcs, t, labels=True))
    return out


def write_reader_files(fluid, transformer, feed_main, batches, tmp,
                       files=None):
    """The batches, through a DataFeeder over the feed-fed program's data
    vars and recordio_writer, into `files` (default READER["files"])
    recordio files (the batches dealt out in turn); returns the paths."""
    files = files or READER["files"]
    names = transformer.FUSED_FEED_NAMES
    feeder = fluid.DataFeeder(feed_list=names, program=feed_main)
    paths = []
    for f in range(files):
        mine = batches[f::files]

        def rows():
            for b in mine:
                yield [tuple(b[n][i] for n in names)
                       for i in range(TRAIN_BATCH)]
        path = os.path.join(tmp, "transformer_%d.recordio" % f)
        check(fluid.recordio_writer.convert_reader_to_recordio_file(
            path, rows, feeder=feeder) == len(mine),
            "recordio_writer wrote a short file")
        paths.append(path)
    return paths


def transformer_reader_program(fluid, transformer, paths):
    """Phase 19's bf16 Transformer-base training program fed through a
    double buffer: open_files over `paths` (READER["threads"] threads) or,
    for one path, open_recordio_file (a fixed record order), then
    double_buffer -> read_file. Returns (main, startup, avg_cost, the read
    vars in FUSED_FEED_NAMES order, the reader var, predict)."""
    kwargs = dict(TRAIN_VARIANTS["bf16"])
    kwargs.pop("amp")
    t = MODEL["max_length"]
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    main.enable_mixed_precision()
    spec = dict(shapes=[[-1, t]] * 4 + [[-1, 1]] * 2 + [[-1, t, 1]] * 2,
                lod_levels=[0] * 8,
                dtypes=["int64"] * 4 + ["int32"] * 2 + ["int64", "float32"])
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if len(paths) == 1:
            reader = fluid.layers.open_recordio_file(filename=paths[0],
                                                     **spec)
        else:
            reader = fluid.layers.open_files(
                filenames=paths, thread_num=READER["threads"], **spec)
        reader = fluid.layers.double_buffer(reader)
        inputs = fluid.layers.read_file(reader)
        _, avg_cost, predict = transformer.build_train(
            MODEL["vocab"], MODEL["vocab"], t, d_model=MODEL["d_model"],
            warmup_steps=WARMUP_STEPS, n_layer=N_LAYER,
            n_head=MODEL["n_head"], d_key=MODEL["d_key"],
            d_value=MODEL["d_key"], d_inner_hid=MODEL["d_inner"],
            label_smooth_eps=0.1, inputs=tuple(inputs), **kwargs)
    return main, startup, avg_cost, list(inputs), reader, predict


def run_reader_training(torch, card):
    """Phase 32 (see READER and the module's docstring). Returns ((the
    second checked call's launch counts, 4 x a bf16 step's), the
    report)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.dispatch import rollback_all_staged
    from paddle_tpu_torch.observability import trace
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.recordio import _native

    torch.backends.cuda.matmul.allow_tf32 = False
    tag = "readers:"
    k, calls = READER["steps"], READER["calls"]
    n_steps = k * calls
    check(_native() is not None, "%s the native recordio library did not "
          "load" % tag)
    tmp = tempfile.mkdtemp(prefix="ptt_phase32_")
    try:
        t0 = time.perf_counter()
        feed_main, feed_startup, feed_cost = build_train(
            fluid, transformer, N_LAYER, variant="bf16")
        batches = reader_batches(transformer)
        paths = write_reader_files(fluid, transformer, feed_main, batches,
                                   tmp)
        write_s = time.perf_counter() - t0
        main, startup, avg_cost, inputs, reader_var, _ = \
            transformer_reader_program(fluid, transformer, paths)
        src_var = inputs[0]
        exe = fluid.Executor()
        ref_scope, scope = fluid.Scope(), fluid.Scope()
        exe.run(feed_startup, scope=ref_scope)
        exe.run(startup, scope=scope)
        init = host_state(ref_scope)
        check(set(init) <= set(host_state(scope)), "%s the reader-fed "
              "program's parameters are not the feed-fed one's" % tag)
        for n, v in init.items():
            scope.set(n, v.cuda())
        scope._rng_counter = ref_scope._rng_counter
        reader = scope.get(reader_var.name)

        def call(prefetch=True, fetch=(avg_cost, src_var),
                 return_numpy=True):
            return exe.run(main, fetch_list=list(fetch), scope=scope,
                           steps=k, prefetch=prefetch,
                           return_numpy=return_numpy)

        deterministic = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            ts = time.perf_counter()
            losses, srcs = call()
            first_s = time.perf_counter() - ts
            ck.reset_launch_counts()
            # a sync made by the reader path, on any thread
            out, syncs, stage_syncs = _sync_warnings(
                torch, call, tag, through=(
                    "readers.py", "run_host_io_prepass", "HostIoPrefetcher",
                    "consume_host_io", "kick_next_prepass"))
            counts = ck.launch_counts()
            losses = np.concatenate([losses, out[0]])
            srcs = np.concatenate([srcs, out[1]])
            state = host_state(scope)
            rollback_all_staged(scope)
            consumed = reader.state_dict()["consumed"]
            # the reference: one eager feed-fed step per batch, in the
            # order the reader delivered them
            order = []
            for i in range(n_steps):
                hit = [b for b, fb in enumerate(batches)
                       if np.array_equal(fb["src_word"], srcs[i])]
                check(len(hit) == 1, "%s step %d's batch is not one of "
                      "the 16" % (tag, i))
                order.append(hit[0])
            ref = [float(exe.run(feed_main, feed=batches[b],
                                 fetch_list=[feed_cost],
                                 scope=ref_scope)[0].reshape(-1)[0])
                   for b in order]
            ref_state = host_state(ref_scope)
        finally:
            torch.use_deterministic_algorithms(deterministic)
        check(len(set(order)) == n_steps, "%s the reader delivered a batch "
              "twice: %s" % (tag, order))
        check(consumed == n_steps, "%s the reader's state_dict advanced "
              "%d records for %d steps" % (tag, consumed, n_steps))
        got = [float(x) for x in losses.reshape(-1)]
        check(got == ref, "%s the steps=%d losses %s differ from %d eager "
              "feed-fed steps' %s" % (tag, k, got, n_steps, ref))
        params = {n: v for n, v in ref_state.items() if n in init}
        same, err, err_at = state_diff(
            torch, params, {n: state[n] for n in params})
        check(same, "%s the parameters after %d steps differ from the "
              "eager feed-fed run's (%s by %r)" % (tag, n_steps, err_at, err))
        check(stage_syncs == 0, "%s staging made %d synchronizing calls"
              % (tag, stage_syncs))
        check(np.isfinite(got).all(), "%s losses %s" % (tag, got))

        # timing from a reset stream: steps=k calls with prefetch off,
        # then on, then off and on again
        # (a whole pass over the files a timing)
        passes = READER["batches"] // k

        def timed(prefetch):
            rollback_all_staged(scope)
            reader.reset()
            trace.clear()
            ms = [call_ms(torch, lambda: call(prefetch, (avg_cost,), False))
                  for _ in range(passes)]
            # the io pre-pass's host ms from the run's spans: a call's
            # exec/host_io (inline: the whole pre-pass; prefetched: the
            # take), and the staging thread's exec/prefetch_stage
            spans = collections.defaultdict(list)
            for ev in trace.dump(include_open=False)["events"]:
                spans[ev["name"]].append(ev.get("dur", 0.0) / 1e3)
            # the device time of one call under the profiler, the second
            # of a pass (with prefetch, it takes a staged block)
            rollback_all_staged(scope)
            reader.reset()
            call(prefetch, (avg_cost,), False)
            busy, _, wall = device_busy_ms(
                torch, lambda: call(prefetch, (avg_cost,), False))
            return {"step_ms": statistics.median(ms) / k,
                    "step_ms_calls": [m / k for m in ms],
                    "device_ms_per_step": busy / k,
                    "traced_wall_ms_per_step": wall / k,
                    "idle_share": 1 - busy / wall,
                    "host_io_ms_calls": spans["exec/host_io"],
                    "prefetch_stage_ms_calls":
                        spans["exec/prefetch_stage"]}
        timing = {}
        for prefetch in (False, True, False, True):
            timing.setdefault("prefetch" if prefetch else "inline",
                              []).append(timed(prefetch))
        # the inline pre-pass of a block of k in steady state: the median
        # of the inline legs' exec/host_io spans after each pass's first
        prepass_ms = statistics.median(
            d for leg in timing["inline"]
            for d in leg["host_io_ms_calls"][1:])
        expected = dict.fromkeys(counts, 0)
        expected.update({"flash_attention_fwd_bf16": 18 * k,
                         "flash_attention_bwd_dkdv_bf16": 18 * k,
                         "flash_attention_bwd_dq_bf16": 18 * k,
                         "softmax_xent_fwd": k, "layer_norm_fwd": 32 * k})
        report = {
            "files": READER["files"], "batches": READER["batches"],
            "write_s": write_s, "steps": k, "trained_steps": n_steps,
            "reader_order": order, "losses": got,
            "equal_to_eager_feed_fed": True,
            "reader_consumed": consumed, "native_recordio": True,
            "first_call_s": first_s, "synchronizing_calls": syncs,
            "staging_synchronizing_calls": stage_syncs,
            "prepass_host_ms": prepass_ms, "timing": timing,
            "launches_per_step": {n: c / k for n, c in counts.items() if c},
            "card": card}
        print("%s %s" % (tag, json.dumps(report)))
        exe._cache.clear()
        del scope, ref_scope
        torch.cuda.empty_cache()
        return (counts, expected), report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------- persistence --

# phase 33: A8's persistence half. (a) phase 32's bf16 Transformer-base
# program fed from ONE recordio file of its 16 batches (a fixed record
# order) at steps=4, prefetch=True: 4 calls straight through with an
# async save after call 2, then a fresh scope, executor and reader
# resumed from it for 2 calls; (b) phase 20's dropout program at steps=4,
# saved after call 1 and resumed for call 2; (c) (a)'s step-8 snapshot
# served by from_checkpoint; (d) three era-wire models served.
PERSIST = dict(steps=4, calls=4, save_after=2, resume_calls=2,
               timed_calls=4)
ERA_TOL = dict(rtol=1e-4, atol=1e-5)  # the JAX era-wire tests' tolerance
ERA_ENCODER_CLASSES = 4   # test_era_export_roundtrip_transformer_encoder's


def _k5_ops(ops):
    """layer_norm ops with a scale and a bias: one K5 launch each."""
    return sum(op.type == "layer_norm" and bool(op.inputs.get("Scale"))
               and bool(op.inputs.get("Bias")) for op in ops)


def persist_resume_bf16(torch, card, tmp):
    """Phase 33 (a). Returns ((the resumed run's second call's launch
    counts, 4 x a bf16 step's), the report, what (c) serves)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck

    tag = "persistence (a):"
    k, calls, after = PERSIST["steps"], PERSIST["calls"], \
        PERSIST["save_after"]
    feed_main, _, _ = build_train(fluid, transformer, N_LAYER,
                                  variant="bf16")
    batches = reader_batches(transformer)
    paths = write_reader_files(fluid, transformer, feed_main, batches, tmp,
                               files=1)
    main, startup, avg_cost, inputs, reader_var, predict = \
        transformer_reader_program(fluid, transformer, paths)
    ckdir = os.path.join(tmp, "ckpt")

    def fresh():
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        return exe, scope

    def call(exe, scope):
        return exe.run(main, fetch_list=[avg_cost], scope=scope, steps=k,
                       prefetch=True)[0].reshape(-1)

    report = {"card": card}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        exe, scope = fresh()
        reader = scope.get(reader_var.name)
        mgr = CheckpointManager(ckdir)
        losses, call_ms_list, in_flight = [], [], []
        handle = None
        for c in range(calls):
            if c == after:
                # the training thread's syncs: the writer's copies (on
                # its own thread, after the event) are not the capture's
                handle, _, syncs = _sync_warnings(
                    torch, lambda: mgr.save(k * c, program=main,
                                            scope=scope),
                    tag, through=("_capture_job",))
                at_save = reader.state_dict()
            ts = time.perf_counter()
            losses.append(call(exe, scope))
            call_ms_list.append((time.perf_counter() - ts) * 1e3)
            in_flight.append(handle is not None and not handle.done())
        handle.result(600)
        mgr.close()
        straight = host_state(scope)
        report.update(
            save_capture_ms=handle.capture_seconds * 1e3,
            save_synchronizing_calls=syncs,
            writer_s=handle.write_seconds,
            snapshot_bytes=handle.bytes_written,
            call_ms=call_ms_list, save_in_flight_after_call=in_flight,
            reader_at_save=at_save)
        print("%s save(%d) on the training thread %.2f ms, %d synchronizing "
              "calls; the writer %.2f s for %d bytes; calls %s ms (a save "
              "in flight at the end of each: %s)"
              % (tag, k * after, handle.capture_seconds * 1e3, syncs,
                 handle.write_seconds, handle.bytes_written,
                 ["%.1f" % m for m in call_ms_list], in_flight))
        check(syncs == 0, "%s save() made %d synchronizing calls"
              % (tag, syncs))

        # resume: a fresh scope, executor and reader
        exe_b, scope_b = fresh()
        ts = time.perf_counter()
        with CheckpointManager(ckdir) as mgr_b:
            step = mgr_b.restore(program=main, scope=scope_b,
                                 executor=exe_b)
        torch.cuda.synchronize()
        report["restore_s"] = time.perf_counter() - ts
        check(step == k * after, "%s restore() returned %r, expected %d"
              % (tag, step, k * after))
        restored_reader = scope_b.get(reader_var.name).state_dict()
        check(restored_reader == at_save, "%s the restored reader's "
              "state_dict %s, the straight run's at step %d %s"
              % (tag, restored_reader, step, at_save))
        # (c)'s reference: save_inference_model of the feed-fed program
        # from the restored scope, before it trains on
        native_dir = os.path.join(tmp, "native_step_%d" % step)
        fluid.io.save_inference_model(
            native_dir, transformer.SCORING_FEED_NAMES, [predict.name],
            exe_b, feed_main, scope=scope_b)
        resumed = [call(exe_b, scope_b)]
        ck.reset_launch_counts()
        resumed.append(call(exe_b, scope_b))
        counts = ck.launch_counts()
        resumed_state = host_state(scope_b)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    got = [float(x) for x in np.concatenate(resumed)]
    want = [float(x) for x in np.concatenate(losses[after:])]
    check(got == want, "%s the resumed losses of steps %d-%d %s differ from "
          "the straight run's %s" % (tag, k * after + 1, k * calls, got,
                                     want))
    same, err, err_at = state_diff(
        torch, straight, {n: resumed_state[n] for n in straight})
    check(same, "%s the state after the resumed run differs from the "
          "straight run's (%s by %r)" % (tag, err_at, err))
    check(np.isfinite(want).all(), "%s losses %s" % (tag, want))
    expected = dict.fromkeys(counts, 0)
    expected.update({"flash_attention_fwd_bf16": 18 * k,
                     "flash_attention_bwd_dkdv_bf16": 18 * k,
                     "flash_attention_bwd_dq_bf16": 18 * k,
                     "softmax_xent_fwd": k, "layer_norm_fwd": 32 * k})
    report.update(losses_resumed=got, bit_equal=True,
                  launches_per_step={n: c / k for n, c in counts.items()
                                     if c})
    print("%s restore %.2f s; steps %d-%d bit-equal to the straight run "
          "(losses and %d arrays), the reader %s"
          % (tag, report["restore_s"], k * after + 1, k * calls,
             len(straight), restored_reader))
    # the timed save is the newest snapshot, the one (c)'s walk-back
    # corrupts
    report["timing"] = persist_save_timing(
        torch, lambda: call(exe, scope), reader,
        lambda mgr: mgr.save(k * calls, program=main, scope=scope), ckdir)
    del scope, scope_b, straight, resumed_state
    exe._cache.clear()
    exe_b._cache.clear()
    torch.cuda.empty_cache()
    served = dict(ckdir=ckdir, step=k * after, native_dir=native_dir,
                  predict=predict.name, read_names=[v.name for v in inputs])
    return (counts, expected), report, served


def persist_save_timing(torch, call, reader, save, ckdir):
    """The steps=4 call's wall ms (host clock, the loss fetched) over
    PERSIST["timed_calls"] calls with no save in flight, then as many
    right after an async save (the writer running through them), the
    reader reset before each pass of its records; the save's capture ms
    and the writer's seconds. The snapshot is written to `ckdir`."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.core.dispatch import rollback_all_staged
    n = PERSIST["timed_calls"]
    per_pass = READER["batches"] // PERSIST["steps"]

    def calls(flags=None, handle=None):
        out = []
        for i in range(n):
            if i % per_pass == 0:
                rollback_all_staged()
                reader.reset()
            ts = time.perf_counter()
            call()
            out.append((time.perf_counter() - ts) * 1e3)
            if flags is not None:
                flags.append(not handle.done())
        return out
    calls()                      # warm: every call after a reset alike
    without = calls()
    rollback_all_staged()
    reader.reset()
    with CheckpointManager(ckdir) as mgr:
        flags = []
        handle = save(mgr)
        with_save = calls(flags, handle)
        handle.result(600)
    return {"call_ms_without_save": without,
            "call_ms_with_save_in_flight": with_save,
            "save_in_flight_after_call": flags,
            "median_without": statistics.median(without),
            "median_with": statistics.median(with_save),
            "capture_ms": handle.capture_seconds * 1e3,
            "writer_s": handle.write_seconds}


def persist_resume_dropout(torch, card, tmp):
    """Phase 33 (b): phase 20's dropout program at steps=4, 3 calls
    straight through with a save after call 1; then a fresh scope and
    executor resumed from it for calls 2 and 3 (a runner's first call
    also counts the launches its capture records, so the second is the
    one counted)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.ops import cuda_kernels as ck

    tag = "persistence (b):"
    k = PERSIST["steps"]
    main, startup, avg_cost, feed = multistep_program(
        fluid, "transformer_dropout")
    ckdir = os.path.join(tmp, "ckpt_dropout")

    def call(exe, scope):
        return exe.run(main, feed=feed, fetch_list=[avg_cost], scope=scope,
                       steps=k)[0].reshape(-1)

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        call(exe, scope)
        with CheckpointManager(ckdir, async_save=False) as mgr:
            mgr.save(k, program=main, scope=scope)
        cursor = scope.seed_state()
        want = np.concatenate([call(exe, scope), call(exe, scope)])
        straight = host_state(scope)
        exe_b, scope_b = fluid.Executor(), fluid.Scope()
        exe_b.run(startup, scope=scope_b)
        with CheckpointManager(ckdir) as mgr:
            check(mgr.restore(program=main, scope=scope_b,
                              executor=exe_b) == k,
                  "%s restore() did not return %d" % (tag, k))
        check(scope_b.seed_state() == cursor, "%s the seed cursor %d, "
              "saved %d" % (tag, scope_b.seed_state(), cursor))
        got = [call(exe_b, scope_b)]
        ck.reset_launch_counts()
        got.append(call(exe_b, scope_b))
        counts = ck.launch_counts()
        got = np.concatenate(got)
        resumed_state = host_state(scope_b)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    check(np.array_equal(got, want), "%s the resumed losses %s differ from "
          "the straight run's %s" % (tag, got.tolist(), want.tolist()))
    same, err, err_at = state_diff(
        torch, straight, {n: resumed_state[n] for n in straight})
    check(same, "%s the state differs (%s by %r)" % (tag, err_at, err))
    expected = dict.fromkeys(counts, 0)
    expected["layer_norm_fwd"] = 32 * k
    print("%s steps %d-%d bit-equal after resuming at step %d (seed cursor "
          "%d; losses %s)" % (tag, k + 1, 3 * k, k, cursor,
                              [float(x) for x in got]))
    del scope, scope_b
    exe._cache.clear()
    exe_b._cache.clear()
    torch.cuda.empty_cache()
    return (counts, expected), {"losses_resumed": [float(x) for x in got],
                                "seed_cursor": cursor, "bit_equal": True,
                                "card": card}


def persist_from_checkpoint(torch, card, served):
    """Phase 33 (c): (a)'s step-8 snapshot served by from_checkpoint in fp32
    and with bf16 weights, each against an engine over save_inference_model
    of the restored scope with the same weights_dtype; then the walk-back
    past a corrupt newest snapshot. Returns the paths and the report."""
    from paddle_tpu_torch.checkpoint import load_manifest
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import InferenceEngine

    tag = "persistence (c):"
    predict, step = served["predict"], served["step"]
    requests = scoring_requests(transformer)
    rename = dict(zip(transformer.SCORING_FEED_NAMES, served["read_names"]))
    ck_requests = [{rename[n]: v for n, v in r.items()} for r in requests]
    paths, report, first = [], {"card": card}, None
    for dtype in ("fp32", "bf16"):
        ts = time.perf_counter()
        engine = InferenceEngine.from_checkpoint(
            served["ckdir"], [predict], step=step, batch_buckets=[1, 4, 8],
            weights_dtype=dtype, name="ckpt_%s" % dtype)
        engine.run_direct(ck_requests[0])
        first_s = time.perf_counter() - ts
        ref = InferenceEngine(served["native_dir"], batch_buckets=[1, 4, 8],
                              weights_dtype=dtype)
        try:
            check(engine.checkpoint_step == step and sorted(
                engine.feed_names) == sorted(rename[n] for n in
                                             transformer.SCORING_FEED_NAMES),
                  "%s engine at step %s with feeds %s" % (
                      tag, engine.checkpoint_step, engine.feed_names))
            ops = engine.program.global_block().ops
            n_flash = sum(op.type == "fused_attention" for op in ops)
            n_ln = _k5_ops(ops)
            ck.reset_launch_counts()
            batches0 = engine.metrics.snapshot()["batches_total"]
            answers, latencies, futures, wall = serve_burst(
                engine, ck_requests, predict)
            counts = ck.launch_counts()
            batches = engine.metrics.snapshot()["batches_total"] - batches0
            diff = 0.0
            for i, fut in enumerate(futures):
                mine = engine.run_direct(ck_requests[i],
                                         batch_bucket=fut.bucket[0])[0]
                theirs = ref.run_direct(requests[i],
                                        batch_bucket=fut.bucket[0])[0]
                check(np.array_equal(mine[predict], theirs[predict]),
                      "%s %s request %d: from_checkpoint differs from the "
                      "save_inference_model engine by %r" % (
                          tag, dtype, i, float(np.abs(
                              mine[predict] - theirs[predict]).max())))
                diff = max(diff, float(np.abs(
                    mine[predict] - answers[i]).max()))
            check(diff <= BUCKET_TOL and all(
                np.isfinite(a).all() for a in answers),
                "%s %s coalesced answers differ from run_direct by %r"
                % (tag, dtype, diff))
            if dtype == "fp32":
                first = engine.run_direct(ck_requests[0],
                                          batch_bucket=1)[0][predict]
        finally:
            engine.close()
            ref.close()
        # the pruned program keeps the training program's mixed precision
        # (both packages): every fused_attention runs the bf16 K1
        expected = dict.fromkeys(counts, 0)
        expected.update(flash_attention_fwd_bf16=n_flash * batches,
                        layer_norm_fwd=n_ln * batches)
        paths.append(("persistence_from_checkpoint_" + dtype,
                      (counts, expected)))
        lat = sorted(x * 1e3 for x in latencies)
        report[dtype] = {
            "first_answer_s": first_s, "batches": batches,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "wall_s": wall,
            "launches_per_dispatch": {n: c / batches for n, c in
                                      counts.items() if c},
            "bucket_max_diff": diff, "bit_equal_to_native": True}
        print("%s %s: first answer %.1f s after the call, launches %s over "
              "%d dispatches, bit-equal to save_inference_model's engine"
              % (tag, dtype, first_s, counts, batches))
    # the walk-back: the newest snapshot's largest parameter file flipped
    newest = os.path.join(served["ckdir"], "step_%d" % (
        PERSIST["steps"] * PERSIST["calls"]))
    manifest = load_manifest(newest)
    victim = max((e for e in manifest.values() if e.get("is_param")),
                 key=lambda e: os.path.getsize(os.path.join(newest,
                                                            e["file"])))
    with open(os.path.join(newest, victim["file"]), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    engine = InferenceEngine.from_checkpoint(
        served["ckdir"], [predict], batch_buckets=[1], warmup=False)
    try:
        got = engine.run_direct(ck_requests[0], batch_bucket=1)[0][predict]
        back = engine.checkpoint_step
    finally:
        engine.close()
    check(back == step, "%s with %s flipped the engine serves step %s, "
          "expected %d" % (tag, victim["file"], back, step))
    check(np.array_equal(got, first), "%s the walked-back engine's answer "
          "differs from step %d's fp32 engine's" % (tag, step))
    report["walk_back"] = {"flipped": victim["file"], "served_step": back}
    print("%s %s flipped in the newest snapshot: from_checkpoint served "
          "step %d" % (tag, victim["file"], back))
    torch.cuda.empty_cache()
    return paths, report


def build_era_encoder(fluid, transformer):
    """test_era_export_roundtrip_transformer_encoder's classifier at
    Transformer-base's widths (MODEL, N_LAYER layers, dense attention):
    (main, startup, feed names, prediction)."""
    t, h = MODEL["max_length"], MODEL["n_head"]
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.layers.data(name="src", shape=[t, 1], dtype="int64")
        pos = fluid.layers.data(name="pos", shape=[t, 1], dtype="int64")
        bias = fluid.layers.data(name="bias", shape=[h, t, t],
                                 dtype="float32")
        enc_in = transformer.prepare_encoder(src, pos, MODEL["vocab"],
                                             MODEL["d_model"], t)
        enc = transformer.encoder(
            enc_in, bias, n_layer=N_LAYER, n_head=h, d_key=MODEL["d_key"],
            d_value=MODEL["d_key"], d_model=MODEL["d_model"],
            d_inner_hid=MODEL["d_inner"])
        pooled = fluid.layers.reduce_mean(enc, dim=[1])
        pred = fluid.layers.fc(input=pooled, size=ERA_ENCODER_CLASSES,
                               act="softmax")
    return main, startup, ["src", "pos", "bias"], pred


def era_encoder_requests(n=16):
    """One-sentence requests of 32-256 tokens: ids, positions and the
    attention bias (-1e9 on padded keys)."""
    t, h = MODEL["max_length"], MODEL["n_head"]
    rng = np.random.RandomState(SEED + 330)
    out = []
    for length in rng.randint(t // 8, t + 1, size=n):
        src = np.zeros((1, t, 1), "int64")
        src[0, :length, 0] = rng.randint(3, MODEL["vocab"], length)
        pos = np.arange(t, dtype="int64").reshape(1, t, 1)
        bias = np.zeros((1, h, t, t), "float32")
        bias[..., length:] = -1e9
        out.append({"src": src, "pos": pos, "bias": bias})
    return out


def persist_era_models(torch, card, tmp):
    """Phase 33 (d): three models written by io.save_reference_model and
    served through InferenceEngine(model_format="reference") and a
    ModelServer, against the native engines of the same models on the
    same requests. Returns the paths and the report."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import InferenceEngine, ModelServer

    tag = "persistence (d):"
    rng = np.random.RandomState(SEED + 3)   # phase 6's requests
    lod_requests = [{"words": [rng.randint(0, SENTIMENT["dict_dim"],
                                           (int(n), 1)).astype("int64")]}
                    for n in rng.randint(16, 257, size=16)]
    models = [("encoder", "__params__", era_encoder_requests())]
    models += [(kind, None, lod_requests) for kind in ("lstm", "conv")]
    paths, report, engines = [], {"card": card}, {}
    try:
        for kind, params_file, requests in models:
            if kind == "encoder":
                main, startup, feeds, pred = build_era_encoder(fluid,
                                                               transformer)
                seq_buckets = None
            else:
                main, startup, pred = build_sentiment(fluid, kind)
                feeds, seq_buckets = ["words"], SEQ_BUCKETS
            exe, scope = fluid.Executor(), fluid.Scope()
            exe.run(startup, scope=scope)
            era = os.path.join(tmp, "era_" + kind)
            native = os.path.join(tmp, "native_" + kind)
            ts = time.perf_counter()
            fluid.io.save_reference_model(era, feeds, [pred], exe,
                                          main_program=main, scope=scope,
                                          params_filename=params_file)
            save_s = time.perf_counter() - ts
            fluid.io.save_inference_model(native, feeds, [pred], exe, main,
                                          scope=scope)
            del scope
            ts = time.perf_counter()
            engine = InferenceEngine(era, name="era_" + kind,
                                     model_format="reference",
                                     params_filename=params_file,
                                     batch_buckets=[1, 4, 8],
                                     seq_buckets=seq_buckets)
            load_s = time.perf_counter() - ts
            engines[kind] = engine
            ts = time.perf_counter()
            fluid.io.load_reference_model(era, fluid.Executor(),
                                          scope=fluid.Scope(),
                                          params_filename=params_file)
            torch.cuda.synchronize()
            read_s = time.perf_counter() - ts
            ref = InferenceEngine(native, batch_buckets=[1, 4, 8],
                                  seq_buckets=seq_buckets)
            try:
                ops = engine.program.global_block().ops
                per = {"layer_norm_fwd": _k5_ops(ops)}
                if kind != "encoder":
                    per = sentiment_launches(ops)
                fetch = engine.fetch_names[0]
                ck.reset_launch_counts()
                batches0 = engine.metrics.snapshot()["batches_total"]
                answers, latencies, futures, wall = serve_burst(
                    engine, requests, fetch)
                counts = ck.launch_counts()
                batches = engine.metrics.snapshot()["batches_total"] \
                    - batches0
                worst = 0.0
                for i, fut in enumerate(futures):
                    want = ref.run_direct(requests[i],
                                          batch_bucket=fut.bucket[0],
                                          seq_bucket=fut.bucket[1])[0][fetch]
                    check(np.allclose(answers[i], want, **ERA_TOL) and
                          np.isfinite(answers[i]).all(),
                          "%s %s request %d: the era-wire engine differs "
                          "from the native one by %r" % (
                              tag, kind, i,
                              float(np.abs(answers[i] - want).max())))
                    worst = max(worst, float(np.abs(answers[i] - want)
                                             .max()))
            finally:
                ref.close()
            expected = dict.fromkeys(counts, 0)
            expected.update({n: c * batches for n, c in per.items()})
            paths.append(("persistence_era_" + kind, (counts, expected)))
            lat = sorted(x * 1e3 for x in latencies)
            report[kind] = {
                "save_s": save_s, "engine_load_and_warmup_s": load_s,
                "load_reference_model_s": read_s, "batches": batches,
                "max_abs_diff_vs_native": worst,
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "launches_per_dispatch": per,
                "ops": len(ops), "files": len(os.listdir(era))}
            print("%s %s: saved %.1f s, read back %.1f s, engine loaded and "
                  "warmed %.1f s, launches %s over %d dispatches, max |era - "
                  "native| %.3e" % (tag, kind, save_s, read_s, load_s,
                                    counts, batches, worst))
        server = ModelServer({e.name: e for e in engines.values()},
                             port=0).start()
        try:
            base = "http://%s" % server.address
            for kind, _, requests in models:
                engine = engines[kind]
                inputs = {n: ({"sequences": [s.tolist() for s in v]}
                              if isinstance(v, list) else v.tolist())
                          for n, v in requests[0].items()}
                resp = json.loads(http_json(
                    base + "/v1/models/%s:predict" % engine.name,
                    {"inputs": inputs}).read())
                fetch = engine.fetch_names[0]
                got = np.asarray(resp["outputs"][fetch], dtype="float32")
                want = engine.run_direct(requests[0],
                                         batch_bucket=resp["bucket"][0],
                                         seq_bucket=resp["bucket"][1])[0]
                check(np.allclose(got, want[fetch], rtol=0,
                                  atol=BUCKET_TOL),
                      "%s %s :predict differs from run_direct" % (tag, kind))
        finally:
            server.shutdown()
    finally:
        for engine in engines.values():
            engine.close()
    print("%s :predict over the three era-wire engines equal to run_direct"
          % tag)
    torch.cuda.empty_cache()
    return paths, report


def run_persistence(torch, card):
    """Phase 33 (see PERSIST and the module's docstring): the paths and
    the `persistence_summary:` report."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="ptt_phase33_")
    t0 = time.perf_counter()
    try:
        run, resume, served = persist_resume_bf16(torch, card, tmp)
        paths = [("persistence_resume_bf16", run)]
        run, dropout = persist_resume_dropout(torch, card, tmp)
        paths.append(("persistence_resume_dropout", run))
        serve_paths, serving = persist_from_checkpoint(torch, card, served)
        paths += serve_paths
        era_paths, era = persist_era_models(torch, card, tmp)
        paths += era_paths
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {"resume_bf16": resume, "resume_dropout": dropout,
               "from_checkpoint": serving, "era_wire": era,
               "phase_s": time.perf_counter() - t0, "card": card}
    return paths, summary


# ------------------------------------------------------------ resilience --

# phase 34: ROADMAP A9. Phase 33's bf16 Transformer-base program fed from
# one recordio file (phase 32's 16 batches, then its first 8 again: 24
# records) at steps=4, guarded by install_numeric_guards(loss=avg_cost,
# grad_norm=True): (a) the guard's cost, (b) a NaN record inside a
# K-block, (c) a finite loss spike, (d) a hang, (e) the canary; (f)
# FLAGS_check_nan_inf on phase 20's program. Record indices count from 0
# (the plan's), steps from 1.
RESIL = dict(steps=4, timed_calls=4, eager_calls=2, nan_record=5,
             spike_record=13, hang_timeout=2.0, hang_sleep=3.0,
             canary_checks=8, sentinel_observes=2000, explode_lr=1e38)
CANARY_DEVICES = None    # the card's CUDA devices
GUARD_SEGS = 96          # vars a guard_restore launch (kMaxSegs in its .cu)
GUARD_RESTORE_SRC = "paddle_tpu_torch/csrc/guard_restore.cu"
GUARD_RESTORE_REPLACES = "paddle_tpu/ops/guard_ops.py:101 (the gate's " \
    "lax.cond in guard_select_all; no pl.pallas_call)"


def guard_state(torch, fluid, gen):
    """Random tensors shaped as every var install_numeric_guards gates in
    phase 34's program (Transformer-base, bf16 AMP, Adam on noam), on the
    card."""
    from paddle_tpu_torch import resilience as rz
    from paddle_tpu_torch.core.registry import torch_dtype
    from paddle_tpu_torch.models import transformer
    main, _, avg = build_train(fluid, transformer, N_LAYER, variant="bf16")
    info = rz.install_numeric_guards(main, loss=avg, grad_norm=True)
    block, dev, out = main.global_block(), torch.device("cuda"), []
    for n in info["gated"]:
        v = block.var(n)
        dt = torch_dtype(v.dtype)
        shape = tuple(v.shape)
        out.append(torch.randn(shape, generator=gen, device=dev).to(dt)
                   if dt.is_floating_point else
                   torch.randint(0, 1 << 20, shape, generator=gen,
                                 device=dev, dtype=dt))
    return out


def run_guard_kernel(torch, ck, peak_bw):
    """guard_restore held against its plain version (a torch.where a var,
    copied back) on tensors shaped as phase 34's gated state, with the
    flag True (the healthy step: nothing changes) and False (a trip: every
    var takes its backup): bit-equal. Timed in a CUDA graph both ways,
    and the plain version on a healthy step. The bound is the healthy
    step's work, the flag's byte (a trip's: the bytes copied, read and
    written, `trip_bound_ms`)."""
    import paddle_tpu_torch as fluid
    gen = torch.Generator(device="cuda").manual_seed(SEED + 34)
    ys = guard_state(torch, fluid, gen)
    dev = torch.device("cuda")
    flags = {v: torch.tensor([v], device=dev) for v in (True, False)}
    err = 0.0
    for v, ok in flags.items():
        xs = guard_state(torch, fluid, gen)
        want = [x.clone() for x in (xs if v else ys)]
        plain = [x.clone() for x in xs]
        ck.guard_restore(ok, xs, ys)
        ck.guard_restore_plain(ok, plain, ys)
        for a, b, w in zip(xs, plain, want):
            check(torch.equal(a, b) and torch.equal(a, w), "guard_restore "
                  "with the flag %s differs from its plain version" % v)
            err = max(err, float((a.double() - b.double()).abs().max()))
    nbytes = sum(x.numel() * x.element_size() for x in xs)
    ms = time_ms(torch, lambda: ck.guard_restore(flags[True], xs, ys))
    trip_ms = time_ms(torch, lambda: ck.guard_restore(flags[False], xs, ys),
                      iters=5)
    plain_ms = time_ms(torch, lambda: ck.guard_restore_plain(
        flags[True], xs, ys), iters=5)
    bms, bby = bound(0, 1, 1, peak_bw)
    r = {"name": "guard_restore", "route": "cuda",
         "source": GUARD_RESTORE_SRC, "replaces": GUARD_RESTORE_REPLACES,
         "shape": "%d vars, %d bytes (phase 34's gated state), %d launches "
                  "a call" % (len(xs), nbytes, -(-len(xs) // GUARD_SEGS)),
         "max_abs_err": err, "ms": ms, "trip_ms": trip_ms,
         "plain_ms": plain_ms, "library_ms": None, "bound_ms": bms,
         "bound_by": bby, "trip_bound_ms": bound(0, 2 * nbytes, 1,
                                                  peak_bw)[0]}
    print("kernels: guard_restore %s" % json.dumps(r))
    del xs, ys
    torch.cuda.empty_cache()
    return {"guard_restore": r}


class _ResilProgram(object):
    """One reader-fed training program of phase 34: its main and startup
    programs, what a call fetches (sum_cost, avg_cost), its reader var."""

    def __init__(self, fluid, transformer, paths, guard):
        from paddle_tpu_torch import resilience as rz
        self.main, self.startup, avg, _, reader, _ = \
            transformer_reader_program(fluid, transformer, paths)
        # avg_cost = sum_cost / token_num: the spike scales the records'
        # only float field, lbl_weight, which the ratio cancels
        op = next(op for op in self.main.global_block().ops
                  if avg.name in op.all_output_vars())
        self.fetch = [op.inputs["X"][0], avg.name]
        self.reader = reader.name
        self.guards = rz.install_numeric_guards(
            self.main, loss=avg, grad_norm=True) if guard else None


def _recovery_seconds(sup):
    """Wrap the supervisor's fault handler: the seconds each recovery
    took (the action, the restore, the bundle), in a list."""
    handle, secs = sup._handle_fault, []

    def timed(*a, **kw):
        ts = time.perf_counter()
        try:
            return handle(*a, **kw)
        finally:
            secs.append(time.perf_counter() - ts)
    sup._handle_fault = timed
    return secs


def _guard_names(err):
    import re
    return sorted(re.findall(r"non-finite value detected in '([^']+)'",
                             str(err)))


def resil_timing(torch, fluid, card, U, G, fresh, call):
    """Phase 34 (a), timed in the default (nondeterministic) mode a user
    trains in: RESIL["timed_calls"] guarded steps=4 calls against as many
    unguarded ones, in turns, from the same state over the same records;
    the host reads of a call, the kernels and device ms the guard adds a
    step (torch.profiler), and eager (steps=1) steps in turns."""
    from paddle_tpu_torch.core.dispatch import rollback_all_staged
    tag = "resilience (a):"
    k = RESIL["steps"]
    exe_u, exe_g = fluid.Executor(), fluid.Executor()
    su, sg = fresh(U), fresh(G)
    sides = ((exe_u, U, su), (exe_g, G, sg))

    def both(fn):
        return [fn(*side) for side in sides]

    def timed(exe, prog, scope, steps=k, prefetch=True):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = call(exe, prog, scope, steps=steps, prefetch=prefetch)
        torch.cuda.synchronize()
        check(np.isfinite(out[1]).all(), "%s losses %s" % (tag, out[1]))
        return (time.perf_counter() - ts) * 1e3

    def reset(exe, prog, scope):
        rollback_all_staged(scope)
        scope.get(prog.reader).reset()

    first_ms = both(timed)          # each side captures its step here
    ms = [[], []]
    for c in range(RESIL["timed_calls"]):
        if c % 4 == 0:
            both(reset)
        for i, m in enumerate(both(timed)):
            ms[i].append(m)
    # from the stream's start again (24 records: 2 calls and 3 eager steps)
    both(reset)
    # the host reads of one call each (no fetch copied: return_numpy off)
    reads0 = exe_g.flag_reads
    syncs = both(lambda exe, prog, scope: _sync_warnings(
        torch, lambda: call(exe, prog, scope, rn=False), tag,
        through=("raise_program_errors",))[1:])
    reads = exe_g.flag_reads - reads0
    # one profiler session a side: its device ms and its kernels
    traced = both(lambda exe, prog, scope: device_trace(
        torch, lambda: call(exe, prog, scope, rn=False)))
    busy = [t[0] for t in traced]
    kernels = [t[3] for t in traced]
    eager = [[], []]
    for c in range(RESIL["eager_calls"] + 1):   # the first warms up
        for i, m in enumerate(both(lambda *side: timed(
                *side, steps=1, prefetch=False))):
            if c:
                eager[i].append(m)
    check(reads == 1 and tuple(syncs[1]) == (1, 1) and syncs[0][0] == 0,
          "%s a guarded call made %s synchronizing calls (through "
          "raise_program_errors: %s) and %d flag reads, an unguarded one "
          "%s: expected 1, 1, 1 and 0" % (tag, syncs[1][0], syncs[1][1],
                                         reads, syncs[0][0]))
    for exe, prog, scope in sides:
        rollback_all_staged(scope)
        exe._cache.clear()
    med = [statistics.median(v) for v in ms]
    emed = [statistics.median(v) for v in eager]
    report = {
        "mode": "default", "calls_each": RESIL["timed_calls"],
        "first_call_ms": first_ms,
        "call_ms_unguarded": ms[0], "call_ms_guarded": ms[1],
        "median_call_ms_unguarded": med[0], "median_call_ms_guarded": med[1],
        "guard_ms_per_step": (med[1] - med[0]) / k,
        "guard_share": med[1] / med[0] - 1,
        "eager_step_ms_unguarded": eager[0],
        "eager_step_ms_guarded": eager[1],
        "eager_guard_ms_per_step": emed[1] - emed[0],
        "device_ms_per_step_unguarded": busy[0] / k,
        "device_ms_per_step_guarded": busy[1] / k,
        "kernels_per_step_unguarded": kernels[0] / k,
        "kernels_per_step_guarded": kernels[1] / k,
        "guard_kernels_per_step": (kernels[1] - kernels[0]) / k,
        "synchronizing_calls_guarded": syncs[1][0],
        "synchronizing_calls_unguarded": syncs[0][0],
        "flag_reads_per_call": reads,
        "watched": len(G.guards["checked"]), "gated": len(G.guards["gated"]),
        "card": card}
    print("%s %d calls each in turns, steps=%d: median %.2f ms guarded, "
          "%.2f unguarded (%.3f ms a step, %+.1f%%); eager steps %.1f / "
          "%.1f ms; device %.2f / %.2f ms a step; %.1f kernels a step more "
          "(%d watched, %d gated); %d synchronizing call and %d flag read a "
          "guarded call, %d unguarded"
          % (tag, RESIL["timed_calls"], k, med[1], med[0],
             report["guard_ms_per_step"], 100 * report["guard_share"],
             emed[1], emed[0], busy[1] / k, busy[0] / k,
             report["guard_kernels_per_step"], report["watched"],
             report["gated"], syncs[1][0], reads, syncs[0][0]))
    return report


def resil_equal(torch, fluid, card, U, G, fresh, call):
    """Phase 34 (a), under deterministic algorithms: two guarded steps=4
    calls and two unguarded ones from the same state give bit-equal
    losses (no step trips), the guarded one launching K1-K5 18/18/18/1/32
    a step and guard_restore once a GUARD_SEGS gated vars. Returns ((the
    second guarded call's launch counts, the counts predicted), the
    losses, the guarded executor, whose runner serves (b)-(e))."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    tag = "resilience (a):"
    k = RESIL["steps"]
    exe_u, exe_g = fluid.Executor(), fluid.Executor()
    su, sg = fresh(U), fresh(G)
    losses = [call(exe_u, U, su)[1], call(exe_g, G, sg)[1]]
    losses[0] = np.concatenate([losses[0], call(exe_u, U, su)[1]])
    ck.reset_launch_counts()
    second = call(exe_g, G, sg)[1]
    counts = ck.launch_counts()
    losses[1] = np.concatenate([losses[1], second])
    check(np.array_equal(losses[0], losses[1]) and
          np.isfinite(losses[1]).all(), "%s the guarded losses %s differ "
          "from the unguarded ones %s" % (tag, losses[1].tolist(),
                                          losses[0].tolist()))
    exe_u._cache.clear()
    restores = -(-len(G.guards["gated"]) // GUARD_SEGS)
    expected = dict.fromkeys(counts, 0)
    expected.update({"flash_attention_fwd_bf16": 18 * k,
                     "flash_attention_bwd_dkdv_bf16": 18 * k,
                     "flash_attention_bwd_dq_bf16": 18 * k,
                     "softmax_xent_fwd": k, "layer_norm_fwd": 32 * k,
                     "guard_restore": restores * k})
    print("%s deterministic: %d guarded and unguarded losses bit-equal; "
          "launches a step %s" % (tag, losses[1].size, {
              n: c / k for n, c in counts.items() if c}))
    return (counts, expected), [float(x) for x in losses[1].reshape(-1)], \
        exe_g


def resil_nan_block(torch, fluid, card, G, fresh, call, exe):
    """Phase 34 (b): reader_nan at RESIL["nan_record"] inside the second
    steps=4 call: it raises naming the non-finite vars, and the state is
    bit-equal to 8 guarded steps=1 runs under the same plan (the poisoned
    step gated, the three around it applied); then a Supervisor with
    skip_batch trains on to step 16."""
    from paddle_tpu_torch import resilience as rz
    tag = "resilience (b):"
    k, at = RESIL["steps"], RESIL["nan_record"]
    spec = ["reader_nan@%d" % at]
    sb = fresh(G)
    with rz.FaultPlan(spec):
        call(exe, G, sb)
        after_first = host_state(sb)
        err = None
        try:
            call(exe, G, sb)
        except rz.NumericalGuardError as e:
            err = e
    check(err is not None, "%s the K-block with a NaN record did not raise"
          % tag)
    names = _guard_names(err)
    check(G.fetch[1] in names and any(n.endswith("@GRAD") for n in names),
          "%s the raise names %s" % (tag, names))
    block = host_state(sb)
    same, _, _ = state_diff(torch, after_first, block)
    check(not same, "%s the K-block applied none of its steps" % tag)
    sr, trips = fresh(G), []
    ts = time.perf_counter()
    with rz.FaultPlan(spec):
        for i in range(2 * k):
            try:
                call(exe, G, sr, steps=1, prefetch=False)
            except rz.NumericalGuardError:
                trips.append(i)
    eager_s = time.perf_counter() - ts
    check(trips == [at], "%s the steps=1 runs tripped at %s" % (tag, trips))
    same, err_v, err_at = state_diff(torch, host_state(sr), block)
    check(same, "%s the K-block's state differs from 8 steps=1 runs' (%s "
          "by %r)" % (tag, err_at, err_v))
    del sr
    # the Supervisor: skip_batch, on to step 16; the K-block run above,
    # two calls on, is its reference
    for _ in range(2):
        call(exe, G, sb, prefetch=False)
    ss = fresh(G)
    sup = rz.Supervisor(exe, G.main, scope=ss, policies={
        "numeric": [rz.skip_batch(2), rz.abort()]})
    secs = _recovery_seconds(sup)
    try:
        with rz.FaultPlan(spec):
            sup.train(4 * k, fetch_list=G.fetch, steps=k)
    finally:
        sup.close()
    acts = [(e["class"], e["action"]) for e in sup.events]
    check(acts == [("numeric", "skip_batch")] and sup.step == 4 * k,
          "%s the supervised run logged %s and stopped at step %d"
          % (tag, acts, sup.step))
    same, err_v, err_at = state_diff(torch, host_state(sb), host_state(ss))
    check(same, "%s the supervised run differs from the unsupervised one "
          "(%s by %r)" % (tag, err_at, err_v))
    report = {"record": at, "named": names, "trips_steps1": trips,
              "bit_equal_to_steps1": True, "eager_8_steps_s": eager_s,
              "supervised_events": acts, "skip_s": secs, "card": card}
    print("%s record %d (step %d) tripped the second steps=%d call naming "
          "%d vars; its state bit-equal to 8 steps=1 runs; supervised: %s "
          "in %s s, step %d" % (tag, at, at + 1, k, len(names), acts,
                                ["%.4f" % s for s in secs], sup.step))
    return report


def resil_loss_spike(torch, fluid, card, G, fresh, call, exe, tmp):
    """Phase 34 (c): loss_spike at RESIL["spike_record"] (the 4th call),
    a TrainingSentinel on the loss (sum_cost: the spike scales lbl_weight)
    and the guard's grad norm, a snapshot at step 8; rollback_skip_data
    restores it and skips the 8 records read since. The run is bit-equal
    to a fault-free run that skipped the same records."""
    from paddle_tpu_torch import resilience as rz
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.checkpoint.manager import skip_reader_records
    tag = "resilience (c):"
    k = RESIL["steps"]
    ref = fresh(G)
    ref_losses = [call(exe, G, ref, prefetch=False)[0] for _ in range(2)]
    check(skip_reader_records(ref, [G.reader], 2 * k) == 2 * k,
          "%s the reference skipped short" % tag)
    ref_losses += [call(exe, G, ref, prefetch=False)[0] for _ in range(2)]
    sc = fresh(G)
    mgr = CheckpointManager(os.path.join(tmp, "ck_spike"), async_save=False)
    sentinel = rz.TrainingSentinel(window=8, warmup=3, z_threshold=50.0)
    sup = rz.Supervisor(exe, G.main, scope=sc, checkpoint_manager=mgr,
                        sentinel=sentinel, policies={
                            "loss_spike": [rz.rollback_skip_data(1),
                                           rz.abort()]})
    secs = _recovery_seconds(sup)
    try:
        with rz.FaultPlan(["loss_spike@%d" % RESIL["spike_record"]]):
            res = sup.train(4 * k, fetch_list=G.fetch, steps=k,
                            checkpoint_every=2 * k)
    finally:
        sup.close()
        mgr.close()
    acts = [(e["class"], e["action"]) for e in sup.events]
    skip = [e["detail"] for e in sup.events
            if e["action"] == "rollback_skip"]
    check(("loss_spike", "rollback") in acts and skip
          and "skipped %d records" % (2 * k) in skip[0]
          and sentinel.spikes == 1 and sup.step == 4 * k,
          "%s events %s, %d spikes, step %d" % (tag, sup.events,
                                                sentinel.spikes, sup.step))
    got = [r["fetches"][0] for r in res[-2:]]
    check(all(np.array_equal(a, b) for a, b in zip(got, ref_losses[2:])),
          "%s the losses after the rollback %s differ from the reference's "
          "%s" % (tag, got, ref_losses[2:]))
    same, err_v, err_at = state_diff(torch, host_state(ref), host_state(sc))
    check(same, "%s the state differs from the fault-free run that skipped "
          "the same records (%s by %r)" % (tag, err_at, err_v))
    report = {"events": acts, "skip_detail": skip[0],
              "spike": sup.events[0]["error"][:300], "bit_equal": True,
              "recovery_s": secs, "card": card}
    print("%s %s; %s; recovery %s s; losses and state bit-equal to the "
          "run that skipped the same records"
          % (tag, acts, skip[0], ["%.3f" % s for s in secs]))
    return report


def resil_hang(torch, fluid, card, G, fresh, call, exe, tmp):
    """Phase 34 (d): slow_step at step 8 with watchdog_timeout set: a
    DispatchTimeoutError, a bundle, hang:rollback to the step-8 snapshot,
    the next call bit-equal to the straight run; a second slow step runs
    the chain dry: an abort with a bundle that read_bundle reads. The
    sleeping workers, when they wake, pop no record, draw no seed and
    write nothing."""
    from paddle_tpu_torch import resilience as rz
    from paddle_tpu_torch.checkpoint import CheckpointManager
    tag = "resilience (d):"
    k, t_out, sleep = RESIL["steps"], RESIL["hang_timeout"], \
        RESIL["hang_sleep"]
    ref = fresh(G)
    ref_losses = [call(exe, G, ref, prefetch=False)[0] for _ in range(3)]
    ref_state = host_state(ref)
    del ref
    sd = fresh(G)
    bundles = os.path.join(tmp, "bundles")
    mgr = CheckpointManager(os.path.join(tmp, "ck_hang"), async_save=False)
    sup = rz.Supervisor(exe, G.main, scope=sd, checkpoint_manager=mgr,
                        watchdog_timeout=t_out, bundle_dir=bundles,
                        policies={"hang": [rz.rollback(1), rz.abort()]})
    secs = _recovery_seconds(sup)
    aborted = None
    try:
        with rz.FaultPlan(["slow_step@%d:%g" % (2 * k, sleep),
                           "slow_step@%d:%g" % (3 * k, sleep)]):
            try:
                sup.train(4 * k, fetch_list=G.fetch, steps=k,
                          checkpoint_every=2 * k)
            except rz.TrainingAborted as e:
                aborted = e
            ts = time.perf_counter()
            reader = sd.get(G.reader)
            at = (reader.state_dict()["consumed"], sd.seed_state())
            state = host_state(sd)
            # the second sleeper wakes after the deadline: wait it out
            time.sleep(max(0.0, sleep - t_out + 1.0))
            woke = (reader.state_dict()["consumed"], sd.seed_state())
            waited_s = time.perf_counter() - ts
    finally:
        sup.close()
        mgr.close()
    acts = [(e["class"], e["action"]) for e in sup.events]
    check(aborted is not None and isinstance(
        aborted.cause, rz.DispatchTimeoutError), "%s no abort on the second "
        "hang: %s" % (tag, aborted))
    check(acts == [("hang", "bundle"), ("hang", "rollback"),
                   ("hang", "bundle"), ("hang", "abort")],
          "%s events %s" % (tag, acts))
    check(at == woke and at[0] == 3 * k, "%s the woken worker moved the "
          "reader or the seed cursor: %s then %s" % (tag, at, woke))
    same, err_v, err_at = state_diff(torch, state, host_state(sd))
    check(same, "%s the woken worker wrote the scope" % tag)
    same, err_v, err_at = state_diff(torch, ref_state, state)
    check(same, "%s the state after the rollback's call differs from the "
          "straight run's at step %d (%s by %r)" % (tag, 3 * k, err_at,
                                                    err_v))
    last = [m["fetch0"] for m in sup.metrics][-1]
    want = float(np.mean(ref_losses[2]))
    check(last == want, "%s the rolled-back call's mean loss %r, the "
          "straight run's %r" % (tag, last, want))
    meta, program, _, saved = rz.read_bundle(aborted.bundle)
    check(meta["fault_class"] == "hang" and program is not None
          and saved and meta["thread_stacks"], "%s the bundle %s"
          % (tag, {k2: meta.get(k2) for k2 in ("fault_class", "step")}))
    report = {"timeout_s": t_out, "sleep_s": sleep, "events": acts,
              "recovery_s": secs, "bit_equal_after_rollback": True,
              "worker_consumed_nothing": True, "waited_s": waited_s,
              "bundle_state_arrays": len(saved), "card": card}
    print("%s %s; recovery (bundle + restore, bundle + abort) %s s; the "
          "step-12 state and loss bit-equal to the straight run; the woken "
          "worker consumed nothing; the bundle holds %d arrays"
          % (tag, acts, ["%.2f" % s for s in secs], len(saved)))
    return report


def resil_canary(torch, fluid, card, G, fresh, exe):
    """Phase 34 (e): CanaryChecker on the card: one digest over
    RESIL["canary_checks"] checks and its ms a check; bitflip@3 convicts
    check 3 of device 0; a Supervisor with sdc_every=4 aborts with the
    SilentCorruptionError as its cause."""
    from paddle_tpu_torch import resilience as rz
    tag = "resilience (e):"
    c = rz.CanaryChecker(devices=CANARY_DEVICES)
    digests, ms = [], []
    for _ in range(RESIL["canary_checks"]):
        ts = time.perf_counter()
        digests.append(c.check())
        ms.append((time.perf_counter() - ts) * 1e3)
    check(len(set(digests)) == 1, "%s digests %s" % (tag, digests))
    c2 = rz.CanaryChecker(devices=CANARY_DEVICES)
    got = None
    with rz.FaultPlan(["bitflip@3"]):
        try:
            for _ in range(4):
                c2.check()
        except rz.SilentCorruptionError as e:
            got = e
    check(got is not None and got.device_index == 0 and c2.checks == 4
          and got.expected == digests[0], "%s bitflip@3: %r after %d checks"
          % (tag, got, c2.checks))
    se = fresh(G)
    sup = rz.Supervisor(exe, G.main, scope=se, sdc_every=RESIL["steps"],
                        sdc=rz.CanaryChecker(devices=CANARY_DEVICES))
    aborted = None
    try:
        with rz.FaultPlan(["bitflip@1"]):
            try:
                sup.train(4 * RESIL["steps"], fetch_list=G.fetch,
                          steps=RESIL["steps"])
            except rz.TrainingAborted as e:
                aborted = e
    finally:
        sup.close()
    check(aborted is not None and isinstance(
        aborted.cause, rz.SilentCorruptionError)
        and ("sdc", "abort") in [(e["class"], e["action"])
                                 for e in sup.events],
          "%s the supervised run: %r, events %s" % (tag, aborted,
                                                    sup.events))
    report = {"digest": digests[0], "checks": len(digests),
              "check_ms": ms, "median_check_ms": statistics.median(ms[1:]),
              "bitflip_check": 3, "supervisor_abort_step": sup.step,
              "card": card}
    print("%s digest %s stable over %d checks, %.3f ms a check (the "
          "median of checks 2-%d; the first %.1f ms); bitflip@3 convicted "
          "check 3 of device 0; the supervisor aborted at step %d with the "
          "cause"
          % (tag, digests[0], len(digests), report["median_check_ms"],
             len(digests), ms[0], sup.step))
    return report


def resil_check_nan_inf(torch, fluid, card):
    """Phase 34 (f): phase 20's program (fp32, dense attention, dropout)
    at learning_rate RESIL["explode_lr"] under Executor(check_nan_inf=
    True) raises naming a var; at its own rate, RESIL["eager_calls"]
    steps with the sweep against as many without, in turns."""
    import re
    from paddle_tpu_torch.models import transformer
    tag = "resilience (f):"
    rng = np.random.RandomState(SEED)
    t_max = MODEL["max_length"]
    srcs = [rng.randint(3, MODEL["vocab"], t_max).tolist()
            for _ in range(TRAIN_BATCH)]
    feed = transformer.prepare_batch(srcs, srcs, t_max, labels=True,
                                     n_head=MODEL["n_head"])
    main, startup, avg = build_train(fluid, transformer, N_LAYER,
                                     variant="dropout",
                                     learning_rate=RESIL["explode_lr"])
    exe, scope = fluid.Executor(check_nan_inf=True), fluid.Scope()
    exe.run(startup, scope=scope)
    msg, steps = None, 0
    for steps in range(1, 4):
        try:
            exe.run(main, feed=feed, fetch_list=[avg], scope=scope)
        except RuntimeError as e:
            msg = str(e)
            break
    check(msg is not None and re.search(r"variable '[^']+' contains "
                                        r"(NaN|Inf)", msg),
          "%s the exploding run: %r" % (tag, msg))
    del scope
    main, startup, avg = build_train(fluid, transformer, N_LAYER,
                                     variant="dropout")
    ms = {True: [], False: []}
    exes = {on: fluid.Executor(check_nan_inf=on) for on in (False, True)}
    scopes = {}
    for on, e in exes.items():
        scopes[on] = fluid.Scope()
        e.run(startup, scope=scopes[on])
    for c in range(RESIL["eager_calls"] + 1):   # the first warms up
        for on in (False, True):
            m = call_ms(torch, lambda: exes[on].run(
                main, feed=feed, fetch_list=[avg], scope=scopes[on]))
            if c:
                ms[on].append(m)
    del scopes
    sweep = statistics.median(ms[True]) - statistics.median(ms[False])
    report = {"raised_at_step": steps, "message": msg[:200],
              "step_ms_with": ms[True], "step_ms_without": ms[False],
              "sweep_ms_per_call": sweep, "card": card}
    print("%s raised at step %d: %s; eager step %.1f ms with the sweep, "
          "%.1f without (%.2f ms a call)"
          % (tag, steps, msg.split(" (")[0], statistics.median(ms[True]),
             statistics.median(ms[False]), sweep))
    return report


def sentinel_host_us(torch):
    """The sentinel's host µs an observe (window 64, a loss and a grad
    norm, RESIL["sentinel_observes"] healthy calls)."""
    from paddle_tpu_torch import resilience as rz
    rng = np.random.RandomState(SEED + 34)
    vals = (1.0 + 0.01 * rng.rand(RESIL["sentinel_observes"], 2)).tolist()
    s = rz.TrainingSentinel()
    ts = time.perf_counter()
    for loss, gn in vals:
        s.observe(loss, grad_norm=gn)
    return (time.perf_counter() - ts) / len(vals) * 1e6


def run_resilience(torch, card):
    """Phase 34 (see RESIL and the module's docstring): the paths and the
    `resilience_summary:` report."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="ptt_phase34_")
    t0 = time.perf_counter()
    deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        feed_main, _, _ = build_train(fluid, transformer, N_LAYER,
                                      variant="bf16")
        batches = reader_batches(transformer)
        paths = write_reader_files(fluid, transformer, feed_main,
                                   batches + batches[:8], tmp, files=1)
        U = _ResilProgram(fluid, transformer, paths, guard=False)
        G = _ResilProgram(fluid, transformer, paths, guard=True)
        exe0, s0 = fluid.Executor(), fluid.Scope()
        exe0.run(U.startup, scope=s0)
        init, seed0 = host_state(s0), s0.seed_state()
        del s0

        def fresh(prog):
            """A scope with `prog`'s reader and the common initial state."""
            scope = fluid.Scope()
            exe0.run(prog.startup, scope=scope)
            for n, v in init.items():
                scope.set(n, v.to(exe0.device))
            scope.set_seed_state(seed0)
            return scope

        def call(exe, prog, scope, steps=RESIL["steps"], prefetch=True,
                 rn=True):
            return exe.run(prog.main, fetch_list=prog.fetch, scope=scope,
                           steps=steps, prefetch=prefetch, return_numpy=rn)

        # timed as a user trains (the default mode), then every check
        # under deterministic algorithms, as phases 25 and 32-33
        overhead = resil_timing(torch, fluid, card, U, G, fresh, call)
        nan_inf = resil_check_nan_inf(torch, fluid, card)
        torch.use_deterministic_algorithms(True, warn_only=True)
        run, overhead["deterministic_losses"], exe = resil_equal(
            torch, fluid, card, U, G, fresh, call)
        overhead["launches_per_step"] = {
            n: c / RESIL["steps"] for n, c in run[0].items() if c}
        nan = resil_nan_block(torch, fluid, card, G, fresh, call, exe)
        spike = resil_loss_spike(torch, fluid, card, G, fresh, call, exe,
                                 tmp)
        hang = resil_hang(torch, fluid, card, G, fresh, call, exe, tmp)
        canary = resil_canary(torch, fluid, card, G, fresh, exe)
        exe._cache.clear()
    finally:
        torch.use_deterministic_algorithms(deterministic)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    summary = {"overhead": overhead, "nan_block": nan, "loss_spike": spike,
               "hang": hang, "canary": canary, "check_nan_inf": nan_inf,
               "sentinel_us_per_observe": sentinel_host_us(torch),
               "phase_s": time.perf_counter() - t0, "card": card}
    return [("resilience_guarded", run)], summary


# phase 35: ROADMAP A10's first half. bench.py's bf16 AMP Transformer-base
# (batch 32, T=256, Adam on noam) trained through fluid.ParallelExecutor on
# the card: (a) the mesh of the card alone, (b) a 2-replica dp mesh with
# ZeRO, (c) tensor-parallel "gather" placement, (d) ring and Ulysses
# attention, (e) resharding restores and a Supervisor rollback onto a
# layout, (f) the DistributeTranspiler.
PARALLEL = dict(eager=4, steps=4, timed=2, timed_k=1, ckpt_at=2,
                sup_steps=5, sup_every=3, spike_at=4, ctr_batch=256,
                ctr_steps=2,
                # (e)'s depth, cut for the 1200 s budget: its checks are
                # of layouts and snapshots, whatever the depth
                reshard_layers=2)
PARALLEL_LOSS_RTOL = 2e-3   # bf16 AMP over another split of the batch or
# the sequence: products tile and sums add in another order (losses of up
# to 8 steps, relative)
PARALLEL_FP32_TOL = dict(rtol=1e-4, atol=1e-5)  # fp32 CTR, the JAX tests'
PARALLEL_GRAD_RTOL = 1e-2   # the first step's summed gradients (Adam's
# first moments) against (a)'s, ||got - ref|| / ||ref|| over all of them:
# bf16 products over another split of the batch (2.3e-3 on the card); a
# reduction that drops a replica's partial sum reads 0.70 there, one that
# doubles the sum 1.0
PARALLEL_RING_GRAD_RTOL = 5e-2  # the same on the ring sp step, whose
# attention blocks run in fp32 where (a)'s run the bf16 flash path (1.1e-2
# on the card)
PARALLEL_FAULT = "each batch-axis sum replaced by lane 0's partial sum"
PAR_DEV = "cuda:0"          # the card every replica of phase 35 shares


def parallel_launches(main, split=1, flash=True):
    """Launches a step of phase 35's bf16 program makes per batch shard:
    K1-K3 bf16 one each a fused_attention op (`split` a op when Ulysses
    attends each head group apart; none on the ring), K4 one a hard-label
    softmax_with_cross_entropy, K5 one a layer_norm."""
    ops = main.global_block().ops
    attn = sum(op.type == "fused_attention" for op in ops)
    grads = sum(op.type == "grad_of" and
                op.attrs["fwd_type"] == "fused_attention" for op in ops)
    return {"flash_attention_fwd_bf16": attn * split if flash else 0,
            "flash_attention_bwd_dkdv_bf16": grads * split if flash else 0,
            "flash_attention_bwd_dq_bf16": grads * split if flash else 0,
            "softmax_xent_fwd": sum(op.type == "softmax_with_cross_entropy"
                                    and not op.attrs.get("soft_label")
                                    for op in ops),
            "layer_norm_fwd": sum(op.type == "layer_norm" for op in ops)}


def adam_bound(steps):
    """Twice the noam learning rates summed over `steps` steps: how far
    two Adam runs whose gradients differ (in sign, at worst) can move a
    parameter apart (an Adam step moves it by about lr at most). A loose
    bound on drift only: Adam divides a gradient's scale away, so a wrong
    reduction passes it; the first step's moments are what tell
    (parallel_grad_check)."""
    d, w = MODEL["d_model"], WARMUP_STEPS
    return 2 * sum(d ** -0.5 * min(i ** -0.5, i * w ** -1.5)
                   for i in range(1, steps + 1))


def state_bytes(torch, scope):
    """(bytes the scope's state takes on the card, bytes one replica
    holds): a ShardedValue's distinct pieces, and replica 0's."""
    from paddle_tpu_torch.core.sharded import ShardedValue
    total = replica = 0
    for n in scope.names():
        v = scope.get_raw(n)
        if isinstance(v, ShardedValue):
            seen = {id(p): p for p in v.pieces}
            total += sum(p.numel() * p.element_size() for p in seen.values())
            replica += v.pieces[0].numel() * v.pieces[0].element_size()
        elif isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
            replica += v.numel() * v.element_size()
    return total, replica


COLLECTIVE_RANGE = "ptt_collective"


def collective_profile(torch, fn):
    """fn()'s collectives under torch.profiler: each of the mesh step's
    combines (_ParallelStep._all_reduce, _gather_rows, _reduce_piece, and
    ShardedValue.assemble, the ZeRO gathers) runs inside a record_function
    range, outermost only. Returns {the device ms the profiler links to
    the ranges (kernels and copies, NCCL's too, through their launches'
    correlation; a single-rank NCCL copy is not linked), the ranges' own
    spans on the device (the profiler's GPU-side annotations: they hold
    NCCL's copies too), the device ms of all fn()'s work, the collectives'
    included, the calls, the bytes they take in}."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch.core.sharded import ShardedValue, take_piece
    from paddle_tpu_torch.parallel import parallel_executor as pe
    tally = {"calls": 0, "bytes": 0}
    depth = [0]

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def wrap(cls, meth, size):
        orig = getattr(cls, meth)

        def inner(self, *a):
            if depth[0]:
                return orig(self, *a)
            depth[0] += 1
            tally["calls"] += 1
            tally["bytes"] += size(self, *a)
            try:
                with record_function(COLLECTIVE_RANGE):
                    return orig(self, *a)
            finally:
                depth[0] -= 1
        setattr(cls, meth, inner)
        return cls, meth, orig

    patched = [
        wrap(pe._ParallelStep, "_all_reduce", lambda st, vals: nbytes(vals)),
        wrap(pe._ParallelStep, "_gather_rows", lambda st, vals: nbytes(vals)),
        wrap(pe._ParallelStep, "_reduce_piece", lambda st, vals, idx: nbytes(
            take_piece(v, idx) for v in vals)),
        wrap(ShardedValue, "assemble", lambda sv, *a: nbytes(
            {id(p): p for p in sv.pieces}.values()))]
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for cls, meth, orig in reversed(patched):
            setattr(cls, meth, orig)
    linked = span = other = 0.0
    for e in prof.events():
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name == COLLECTIVE_RANGE:
            if on_device:
                span += e.device_time / 1e3
            else:
                linked += e.device_time_total / 1e3
        elif on_device:
            other += e.device_time / 1e3
    return {"collective_device_ms": linked, "collective_span_ms": span,
            "device_ms": other, "collective_calls": tally["calls"],
            "collective_bytes_in": tally["bytes"]}


def first_moments(scope):
    """Adam's first moments in the scope, on the host. After one step
    from zeros each is (1 - beta1) x its param's gradient summed over the
    batch: Adam's update divides a gradient's scale away, its moments
    keep it."""
    return {n: scope.get(n).detach().float().cpu() for n in scope.names()
            if n.startswith("moment1_")}


def grad_rel(ref, got):
    """(||got - ref|| / ||ref|| over all the moments, the largest of one
    var's own, that var)."""
    num = den = worst = 0.0
    where = None
    for n in sorted(ref):
        a, b = ref[n].double(), got[n].double()
        d2, r2 = float(((b - a) ** 2).sum()), float((a * a).sum())
        num, den = num + d2, den + r2
        if r2 > 0 and (d2 / r2) ** 0.5 >= worst:
            worst, where = (d2 / r2) ** 0.5, n
    return (num / den) ** 0.5, worst, where


def parallel_grad_check(tag, ref, got, tol=PARALLEL_GRAD_RTOL):
    """The first step's summed gradients (Adam's first moments) within
    `tol` of (a)'s; the reading for the report."""
    agg, worst, where = grad_rel(ref, got)
    check(agg <= tol,
          "%s the first step's summed gradients (Adam's first moments) "
          "%.3e from (a)'s (tolerance %.0e; worst var %s at %.3e)"
          % (tag, agg, tol, where, worst))
    return {"grad_rel_err": agg, "grad_tolerance": tol,
            "grad_worst_var": where, "grad_worst_var_rel_err": worst}


def parallel_grad_fault(torch, C, ref):
    """The gradient check against a planted fault: (b)'s {"dp": 2} ZeRO
    step with PARALLEL_FAULT (a reduction that drops a replica), one step
    from the same state. Its reading must be past the tolerance."""
    from paddle_tpu_torch.core.sharded import take_piece
    from paddle_tpu_torch.parallel import parallel_executor as pe
    tag = "parallel (b) fault:"
    cls = pe._ParallelStep
    saved = cls._all_reduce, cls._reduce_piece
    cls._all_reduce = lambda st, vals: [vals[0]] * len(vals)
    cls._reduce_piece = lambda st, vals, idx: take_piece(vals[0], idx)
    try:
        scope = C.fresh()
        pexe = C.pexe(scope, mesh=_card_mesh(2, dp=2),
                      sharded_weight_update=True)
        pexe.run(C.fetch, feed=C.feed)
        got = first_moments(scope)
    finally:
        cls._all_reduce, cls._reduce_piece = saved
    del scope, pexe
    agg, worst, where = grad_rel(ref, got)
    check(agg > PARALLEL_GRAD_RTOL,
          "%s %s reads %.3e from (a)'s gradients, within the tolerance "
          "%.0e: the check cannot see it" % (tag, PARALLEL_FAULT, agg,
                                              PARALLEL_GRAD_RTOL))
    print("%s %s: the first step's summed gradients %.3e from (a)'s "
          "(tolerance %.0e), caught" % (tag, PARALLEL_FAULT, agg,
                                        PARALLEL_GRAD_RTOL))
    return {"fault": PARALLEL_FAULT, "grad_rel_err": agg,
            "grad_worst_var": where, "grad_worst_var_rel_err": worst}


class _ParallelCase(object):
    """Phase 35's program (bench.py's bf16 Transformer-base, optionally
    guarded), its batch, its startup state and fresh scopes of it."""

    def __init__(self, torch, fluid, transformer, guard=False, init=None,
                 n_layer=None):
        self.torch, self.fluid = torch, fluid
        self.n_layer = n_layer or N_LAYER
        self.main, self.startup, avg = build_train(
            fluid, transformer, self.n_layer, variant="bf16")
        op = next(op for op in self.main.global_block().ops
                  if avg.name in op.all_output_vars())
        self.avg = avg.name
        self.fetch = [op.inputs["X"][0], avg.name]   # sum_cost, avg_cost
        self.guards = None
        if guard:
            from paddle_tpu_torch import resilience as rz
            self.guards = rz.install_numeric_guards(self.main, loss=avg,
                                                    grad_norm=True)
        rng = np.random.RandomState(SEED)
        srcs = [rng.randint(3, MODEL["vocab"], MODEL["max_length"]).tolist()
                for _ in range(TRAIN_BATCH)]
        self.feed = transformer.prepare_batch(srcs, srcs,
                                              MODEL["max_length"],
                                              labels=True)
        if init is None:
            scope = fluid.Scope()
            fluid.Executor(PAR_DEV).run(self.startup, scope=scope)
            init = (host_state(scope), scope.seed_state())
        self.init = init

    def fresh(self):
        scope = self.fluid.Scope()
        for n, v in self.init[0].items():
            scope.set(n, v.to(PAR_DEV))
        scope.set_seed_state(self.init[1])
        return scope

    def pexe(self, scope, **kw):
        with self.fluid.scope_guard(scope):
            return self.fluid.ParallelExecutor(
                main_program=self.main, loss_name=self.avg, **kw)


def _card_mesh(n, **axes):
    from paddle_tpu_torch.parallel import make_mesh
    return make_mesh(axes, [PAR_DEV] * n)


def _card_alone():
    """The ParallelExecutor arguments of the mesh of the card alone: the
    default, every local CUDA device."""
    return {"use_cuda": True} if PAR_DEV.startswith("cuda") else \
        {"devices": [PAR_DEV]}


def _losses(out):
    return [float(v) for v in np.ravel(out)]


def parallel_timing(torch, C, card):
    """Phase 35's step times, in the default (nondeterministic) mode a
    user trains in: eager (steps=1) and captured (steps=4) calls of (a)'s
    mesh of the card alone and (b)'s 2-replica ZeRO mesh, one side after
    the other (a captured step's memory pool each) from the same state;
    the state bytes each holds. The Executor's own step times on the same
    program are phase 25's transformer_bf16 lines."""
    tag = "parallel timing:"
    k = PARALLEL["steps"]
    sides = {}
    sa = C.fresh()
    sides["card_mesh"] = (C.pexe(sa, **_card_alone()), sa)
    sb = C.fresh()
    sides["dp2_zero"] = (C.pexe(sb, mesh=_card_mesh(2, dp=2),
                                sharded_weight_update=True), sb)

    def call(name, steps):
        exe, scope = sides[name]
        return exe.run(C.fetch, feed=C.feed, steps=steps)

    def timed(name, steps):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = call(name, steps)
        torch.cuda.synchronize()
        check(np.isfinite(out[1]).all(), "%s %s losses %s"
              % (tag, name, out[1]))
        return (time.perf_counter() - ts) * 1e3

    eager, captured, first, busy, pools = {}, {}, {}, {}, {}
    for name in sides:
        # one side at a time: each captured step holds a memory pool of
        # its own, and three at once do not fit beside the eager steps
        first[name] = [timed(name, 1)]
        eager[name] = [timed(name, 1) for _ in range(PARALLEL["timed"])]
        first[name].append(timed(name, k))          # the capture
        pools[name] = next(iter(sides[name][0]._cache.values())).pool_bytes
        captured[name] = [timed(name, k) / k
                          for _ in range(PARALLEL["timed_k"])]
        busy[name] = device_busy_ms(torch, lambda: call(name, k))[0] / k
        sides[name][0]._cache.clear()
        torch.cuda.empty_cache()
    mem = {name: state_bytes(torch, scope)
           for name, (_, scope) in sides.items()}
    # one eager step of each mesh: its collectives' device ms and bytes
    collectives = {name: collective_profile(torch, lambda: call(name, 1))
                   for name in ("card_mesh", "dp2_zero")}
    report = {
        "eager_step_ms": eager, "captured_step_ms": captured,
        "median_eager_step_ms": {n: statistics.median(v)
                                 for n, v in eager.items()},
        "median_captured_step_ms": {n: statistics.median(v)
                                    for n, v in captured.items()},
        "device_ms_per_step": busy, "first_calls_ms": first,
        "capture_pool_bytes": pools,
        "eager_collectives": collectives,
        "state_bytes_on_card": {n: m[0] for n, m in mem.items()},
        "state_bytes_per_replica": {n: m[1] for n, m in mem.items()},
        "memory_report_dp2_zero": sides["dp2_zero"][0].plan.memory_report()[
            "update_state"],
        "card": card}
    report["memory_report_dp2_zero"]["params"] = \
        sides["dp2_zero"][0].plan.memory_report()["params"]
    print("%s eager step ms (median of %d) %s; captured (steps=%d) %s; on "
          "the device %s; an eager step's collectives %s; capture pools "
          "%s; state bytes on the card %s, a replica %s"
          % (tag, PARALLEL["timed"],
             {n: round(v, 1) for n, v in
              report["median_eager_step_ms"].items()}, k,
             {n: round(v, 2) for n, v in
              report["median_captured_step_ms"].items()},
             {n: round(v, 2) for n, v in busy.items()}, collectives,
             pools, report["state_bytes_on_card"],
             report["state_bytes_per_replica"]))
    del sides, sa, sb
    torch.cuda.empty_cache()
    return report


def parallel_run(C, runner, scope, eager, k, moments=None):
    """`eager` steps=1 calls then one steps=k call: (the losses, the
    counts of the port's kernels the calls launched: those of eager + k
    steps and of the warm-up step the steps=k call runs before it
    captures). `moments` (a dict) takes the scope's first_moments after
    the first call."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    ck.reset_launch_counts()
    out = []
    for i in range(eager):
        out += _losses(runner(1)[1])
        if i == 0 and moments is not None:
            moments.update(first_moments(scope))
    if k:
        out += _losses(runner(k)[1])
    return out, ck.launch_counts()


def parallel_card(torch, C, card):
    """Phase 35 (a): ParallelExecutor(use_cuda=True) on the mesh of the
    card alone against Executor.run from the same state: 4 steps=1 calls
    and one steps=4, losses and state bit-equal; launches those of a
    single-card step; the transport of the eager calls."""
    tag = "parallel (a):"
    E, K = PARALLEL["eager"], PARALLEL["steps"]
    exe, se = C.fluid.Executor(PAR_DEV), C.fresh()
    moments = {}
    ref, _ = parallel_run(C, lambda s: exe.run(
        C.main, feed=C.feed, fetch_list=C.fetch, scope=se, steps=s),
        se, E, K, moments)
    exe._cache.clear()          # its captured step's pool
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    sp = C.fresh()
    pexe = C.pexe(sp, **_card_alone())
    check(pexe.device_count == 1 and pexe.mesh.size == 1,
          "%s the default mesh is %r" % (tag, pexe.mesh))
    transports = []

    def runner(s):
        out = pexe.run(C.fetch, feed=C.feed, steps=s)
        transports.append((pexe.last_transport, pexe.last_nccl_calls))
        return out

    got, counts = parallel_run(C, runner, sp, E, K)
    per = parallel_launches(C.main)
    expected = dict.fromkeys(counts, 0)
    expected.update({n: c * (E + K + 1) for n, c in per.items()})
    check(got == ref, "%s losses %s, Executor's %s" % (tag, got, ref))
    same, err, at = state_diff(torch, host_state(se), host_state(sp))
    check(same, "%s the state differs from the Executor's (%s by %r)"
          % (tag, at, err))
    check(PAR_DEV == "cpu" or transports[0][0] == "nccl" and
          transports[0][1] > 0 and transports[-1][0] == "torch",
          "%s transports %s" % (tag, transports))
    pexe._cache.clear()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated() - m0
    report = {"losses": got, "bit_equal_to_executor": True,
              "memory_allocated_state_bytes": mem,
              "transport_eager": transports[0][0],
              "nccl_calls_per_eager_step": transports[0][1],
              "transport_captured": transports[-1][0],
              "launches_per_step": per, "card": card}
    print("%s %d steps=1 calls and one steps=%d: losses and state "
          "bit-equal to Executor.run; eager collectives through %s (%d "
          "calls a step), captured through %s; the state takes %d bytes "
          "of the card (memory_allocated); launches a step %s"
          % (tag, E, K, transports[0][0], transports[0][1],
             transports[-1][0], mem, per))
    return (counts, expected), report, (ref, host_state(se), moments)


def parallel_close(torch, tag, ref, got, steps):
    """Held within PARALLEL_LOSS_RTOL (losses) and adam_bound (state):
    (max loss rel, max state |diff|, its var, the bound)."""
    (rl, rs), (gl, gs) = ref[:2], got
    lerr = max(abs(a - b) / abs(a) for a, b in zip(rl, gl))
    worst, where = 0.0, None
    for n in sorted(rs):
        d = float((rs[n].double() - gs[n].double()).abs().max()) \
            if rs[n].numel() else 0.0
        if d >= worst:
            worst, where = d, n
    lim = adam_bound(steps)
    check(lerr <= PARALLEL_LOSS_RTOL and worst <= lim,
          "%s losses within %.2e of (a)'s (tolerance %.0e), the state "
          "within %.3e (%s; bound %.3e)" % (tag, lerr, PARALLEL_LOSS_RTOL,
                                             worst, where, lim))
    return lerr, worst, where, lim


def parallel_dp2(torch, C, card, ref):
    """Phase 35 (b): {"dp": 2} on the card, sharded_weight_update=True:
    the same 4 + 4 steps, within tolerance of (a); K1-K5 twice a step
    (each replica's rows); the state split as the plan says."""
    from paddle_tpu_torch.core.sharded import ShardedValue
    tag = "parallel (b):"
    E, K = PARALLEL["eager"], PARALLEL["steps"]
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    scope = C.fresh()
    pexe = C.pexe(scope, mesh=_card_mesh(2, dp=2),
                  sharded_weight_update=True)
    moments = {}
    got, counts = parallel_run(
        C, lambda s: pexe.run(C.fetch, feed=C.feed, steps=s), scope, E, K,
        moments)
    per = parallel_launches(C.main)
    expected = dict.fromkeys(counts, 0)
    expected.update({n: 2 * c * (E + K + 1) for n, c in per.items()})
    grads = parallel_grad_check(tag, ref[2], moments)
    lerr, worst, where, lim = parallel_close(
        torch, tag, ref, (got, host_state(scope)), E + K)
    split = [e.name for e in pexe.plan if e.kind != "gradient" and
             e.sharded]
    check(split and all(isinstance(scope.get_raw(n), ShardedValue)
                        for n in split),
          "%s the plan's split vars are not split in the scope" % tag)
    mem = pexe.plan.memory_report()
    transport = pexe.last_transport
    pexe._cache.clear()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - m0
    report = {"losses": got, "loss_rel_err": lerr,
              "memory_allocated_state_bytes": allocated,
              "transport": transport, "state_max_abs": worst,
              "state_worst_var": where, "state_bound": lim,
              **grads, "split_vars": len(split),
              "update_state_bytes": mem["update_state"],
              "params_bytes": mem["params"],
              "launches_per_step": {n: 2 * c for n, c in per.items()},
              "card": card}
    print("%s the first step's summed gradients within %.3e of (a)'s "
          "(tolerance %.0e); losses within %.2e of (a)'s, state within "
          "%.3e (%s, bound %.3e); %d vars split; update state a replica %d "
          "of %d bytes; the state takes %d bytes of the card "
          "(memory_allocated); collectives through %s; launches a step %s"
          % (tag, grads["grad_rel_err"], PARALLEL_GRAD_RTOL, lerr, worst,
             where, lim, len(split),
             mem["update_state"]["per_chip_bytes"],
             mem["update_state"]["replicated_per_chip_bytes"], allocated,
             transport, report["launches_per_step"]))
    return (counts, expected), report, scope, pexe


def parallel_tp(torch, C, card, ref):
    """Phase 35 (c): {"dp": 1, "tp": 2} with tp_axis="tp" ("gather"
    placement: weights split at rest, gathered at the step's entry, every
    product and the update on full arrays): bit-equal to (a)."""
    tag = "parallel (c):"
    E, K = PARALLEL["eager"], PARALLEL["steps"]
    scope = C.fresh()
    pexe = C.pexe(scope, mesh=_card_mesh(2, dp=1, tp=2), tp_axis="tp")
    got, counts = parallel_run(
        C, lambda s: pexe.run(C.fetch, feed=C.feed, steps=s), scope, E, K)
    per = parallel_launches(C.main)
    expected = dict.fromkeys(counts, 0)
    expected.update({n: c * (E + K + 1) for n, c in per.items()})
    tp = [e.name for e in pexe.plan if e.kind == "param" and e.sharded]
    transport = pexe.last_transport
    same, err, at = state_diff(torch, ref[1], host_state(scope))
    check(got == ref[0] and same and tp,
          "%s %d tensor-parallel params; losses %s against (a)'s %s; "
          "state bit-equal %s (%s by %r)" % (tag, len(tp), got, ref[0],
                                             same, at, err))
    pexe._cache.clear()
    torch.cuda.empty_cache()
    report = {"tp_params": len(tp), "bit_equal_to_a": True,
              "transport": transport,
              "memory_report_params": pexe.plan.memory_report()["params"],
              "card": card}
    print("%s %d params split over tp; losses and state bit-equal to "
          "(a); collectives through %s" % (tag, len(tp), transport))
    del scope
    return (counts, expected), report


def parallel_sp_op(torch, card):
    """Phase 35 (d), the op: fused_attention at [32, 256, 8, 64] bf16 on
    {"sp": 2}, ring and Ulysses (each head group through the bf16 K1-K3),
    forward and backward, against the single-card op; ms of each."""
    from paddle_tpu_torch.ops.nn_ops import _attend
    from paddle_tpu_torch.parallel import (ring_attention_sharded,
                                           ulysses_attention_sharded)
    tag = "parallel (d) op:"
    b, t, h, d = (TRAIN_BATCH, MODEL["max_length"], MODEL["n_head"],
                  MODEL["d_key"])
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, go = [torch.randn(b, t, h, d, device="cuda", generator=g,
                               dtype=torch.bfloat16) for _ in range(4)]
    mesh = _card_mesh(2, sp=2)
    fns = {"single": lambda *a: _attend(*a, False, None, None),
           "ring": lambda *a: ring_attention_sharded(*a, mesh),
           "ulysses": lambda *a: ulysses_attention_sharded(
               *a, mesh, attend=_attend)}

    def run(fn):
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*ins)
        grads = torch.autograd.grad(out, ins, go)
        return [out.detach()] + list(grads)

    ref = run(fns["single"])
    report = {"shape": [b, t, h, d], "card": card}
    for name in ("ring", "ulysses"):
        got = run(fns[name])
        errs = [norm_rel(a.float().cpu().numpy(), r.float().cpu().numpy())
                for a, r in zip(got, ref)]
        tols = [BF16_KERNEL_TOL] + [2 * BF16_KERNEL_TOL] * 3
        check(all(e <= tol for e, tol in zip(errs, tols)),
              "%s %s out, dq, dk, dv off the single-card op by %s "
              "(tolerances %s)" % (tag, name, errs, tols))
        report[name] = {"errs_out_dq_dk_dv": errs, "tolerances": tols,
                        "fwd_bwd_ms": eager_ms(
                            torch, lambda: run(fns[name]), iters=3, reps=3)}
    report["single_fwd_bwd_ms"] = eager_ms(torch, lambda: run(fns["single"]),
                                           iters=3, reps=3)
    print("%s %s" % (tag, json.dumps(report)))
    return report


def parallel_sp_step(torch, C, card, ref, impl):
    """Phase 35 (d), the step: the program on {"dp": 1, "sp": 2}, its
    fused_attention ops through `impl` (ring: plain torch blocks, no
    K1-K3; ulysses: the bf16 K1-K3 on each of the two head groups), 4
    steps=1 calls and one steps=4, the losses and the first step's
    gradients within tolerance of (a)'s."""
    tag = "parallel (d) %s step:" % impl
    E, K = PARALLEL["eager"], PARALLEL["steps"]
    for op in C.main.global_block().ops:
        if op.type == "fused_attention":
            op.attrs["sp_impl"] = impl
    try:
        scope = C.fresh()
        # a dp axis of size 1 beside sp: the plan's shard axis defaults
        # to the batch axis, which must exist (as in the JAX package)
        pexe = C.pexe(scope, mesh=_card_mesh(2, dp=1, sp=2))
        moments = {}
        got, counts = parallel_run(
            C, lambda s: pexe.run(C.fetch, feed=C.feed, steps=s), scope, E,
            K, moments)
        transport = pexe.last_transport
        pexe._cache.clear()
    finally:
        for op in C.main.global_block().ops:
            if op.type == "fused_attention":
                op.attrs["sp_impl"] = "ring"
    per = parallel_launches(C.main, split=2, flash=impl == "ulysses")
    expected = dict.fromkeys(counts, 0)
    expected.update({n: c * (E + K + 1) for n, c in per.items()})
    grads = parallel_grad_check(
        tag, ref[2], moments,
        PARALLEL_RING_GRAD_RTOL if impl == "ring" else PARALLEL_GRAD_RTOL)
    check(len(got) == len(ref[0]), "%s %d losses, (a) %d"
          % (tag, len(got), len(ref[0])))
    lerr = max(abs(a - b) / abs(a) for a, b in zip(ref[0], got))
    check(lerr <= PARALLEL_LOSS_RTOL, "%s losses within %.2e of (a)'s "
          "(tolerance %.0e)" % (tag, lerr, PARALLEL_LOSS_RTOL))
    print("%s %d steps=1 calls and one steps=%d: the first step's summed "
          "gradients within %.3e of (a)'s (tolerance %.0e), losses within "
          "%.2e of (a)'s; eager collectives through %s; launches a step %s"
          % (tag, E, K, grads["grad_rel_err"], grads["grad_tolerance"], lerr,
             transport, per))
    del scope
    torch.cuda.empty_cache()
    return (counts, expected), {"loss_rel_err": lerr, "transport": transport,
                                **grads, "launches_per_step": per}


def parallel_reshard(torch, C, card, tmp):
    """Phase 35 (e): (b)'s layout trains 2 steps and saves, 2 more; the
    snapshot restored with restore(layout=) onto (a)'s mesh and (b)'s
    equals what was saved; resumed on (b)'s layout for 2 steps it is
    bit-equal to the straight run. A guarded (b) run of 5 steps under a
    Supervisor with restore_layout=(b)'s plan, a snapshot at step 3,
    takes loss_spike@4 (lbl_weight x 1000: sum_cost spikes) to a
    rollback onto the layout, bit-equal to the run without the spike."""
    from paddle_tpu_torch import resilience as rz
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.core.sharded import ShardedValue
    from paddle_tpu_torch.parallel import DeviceLayout
    tag = "parallel (e):"
    n = PARALLEL["ckpt_at"]
    lay_b = DeviceLayout(local_device_count=2, devices=[PAR_DEV] * 2)
    scope = C.fresh()
    pexe = C.pexe(scope, mesh=lay_b.local_mesh(),
                  sharded_weight_update=True)
    for _ in range(n):
        pexe.run(C.fetch, feed=C.feed)
    saved = host_state(scope)
    ckdir = os.path.join(tmp, "ck_reshard")
    with CheckpointManager(ckdir, async_save=False) as mgr:
        ts = time.perf_counter()
        mgr.save(n, program=C.main, scope=scope, layout=lay_b)
        save_s = time.perf_counter() - ts
    straight = [_losses(pexe.run(C.fetch, feed=C.feed)[1])
                for _ in range(n)]
    want = host_state(scope)
    restores = {}
    card_alone = 1 if PAR_DEV.startswith("cuda") else DeviceLayout(
        local_device_count=1, devices=[PAR_DEV])
    for name, layout in (("card_mesh", card_alone), ("dp2", pexe.plan)):
        rs = C.fresh()
        with CheckpointManager(ckdir, async_save=False) as mgr:
            ts = time.perf_counter()
            check(mgr.restore(program=C.main, scope=rs,
                              layout=layout) == n,
                  "%s restore onto %s" % (tag, name))
            restores[name] = time.perf_counter() - ts
        same, err, at = state_diff(torch, saved, host_state(rs))
        check(same, "%s restored onto %s, %s differs by %r"
              % (tag, name, at, err))
        if name == "dp2":
            split = [e.name for e in pexe.plan if e.kind != "gradient"
                     and e.sharded]
            check(all(isinstance(rs.get_raw(v), ShardedValue)
                      for v in split), "%s restored unsplit" % tag)
            p2 = C.pexe(rs, mesh=lay_b.local_mesh(),
                        sharded_weight_update=True)
            resumed = [_losses(p2.run(C.fetch, feed=C.feed)[1])
                       for _ in range(n)]
            same, err, at = state_diff(torch, want, host_state(rs))
            check(same and resumed == straight,
                  "%s the resume on (b)'s layout %s against %s; state %s "
                  "(%s by %r)" % (tag, resumed, straight, same, at, err))
        del rs
    del scope, pexe
    torch.cuda.empty_cache()
    # the Supervisor leg, on the guarded program
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    G = _ParallelCase(torch, fluid, transformer, guard=True, init=C.init,
                      n_layer=C.n_layer)

    def fresh_guarded():
        sc = G.fresh()
        return sc, G.pexe(sc, mesh=lay_b.local_mesh(),
                          sharded_weight_update=True)

    sc, gp = fresh_guarded()     # the run without the spike
    for _ in range(PARALLEL["sup_steps"]):
        gp.run(G.fetch, feed=G.feed)
    clean = host_state(sc)
    del sc, gp
    sc, gp = fresh_guarded()
    mgr = CheckpointManager(os.path.join(tmp, "ck_spike"), async_save=False)
    sentinel = rz.TrainingSentinel(window=8, warmup=3, z_threshold=50.0)
    sup = rz.Supervisor(gp, G.main, checkpoint_manager=mgr,
                        sentinel=sentinel, restore_layout=gp.plan,
                        policies={"loss_spike": [rz.rollback(1),
                                                 rz.abort()]})
    secs = _recovery_seconds(sup)
    plan = rz.FaultPlan(["loss_spike@%d:1000"
                         % PARALLEL["spike_at"]]).arm()
    try:
        sup.train(PARALLEL["sup_steps"], feed_fn=lambda i: G.feed,
                  fetch_list=G.fetch, checkpoint_every=PARALLEL["sup_every"])
    finally:
        plan.disarm()
        sup.close()
        mgr.close()
    spiked = host_state(sc)
    acts = [(e["class"], e["action"]) for e in sup.events]
    same, err, at = state_diff(torch, clean, spiked)
    check(("loss_spike", "rollback") in acts and sentinel.spikes == 1 and
          same, "%s events %s, %d spikes; state bit-equal to the run "
          "without the spike: %s (%s by %r)"
          % (tag, acts, sentinel.spikes, same, at, err))
    report = {"save_s": save_s, "restore_s": restores,
              "restored_equal": True, "resume_bit_equal": True,
              "supervisor_events": acts, "recovery_s": secs,
              "rollback_bit_equal": True, "card": card}
    print("%s save %.2f s; restore onto the card's mesh %.2f s, onto "
          "(b)'s %.2f s, values equal; the resume on (b)'s layout "
          "bit-equal; supervisor %s in %s s, bit-equal to the run without "
          "the spike" % (tag, save_s, restores["card_mesh"],
                         restores["dp2"], acts,
                         ["%.2f" % s for s in secs]))
    return report


def parallel_transpiler(torch, card):
    """Phase 35 (f): the CTR program (phase 14's widths) through the
    DistributeTranspiler with 2 pservers: the pserver simulation (its
    trainer program under a 2-replica ParallelExecutor with the
    transpiler's parameter_shardings, each pserver program's updates by
    an Executor on the card) and the monolithic program under the same
    mesh and shardings, each against the monolithic program on one card
    within rtol 1e-4 / atol 1e-5 (fp32)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.transpiler import DistributeTranspiler
    tag = "parallel (f):"
    rng = np.random.RandomState(SEED)
    cfg = PARALLEL.get("ctr_cfg", CTR)
    feed = ctr_feed(rng, PARALLEL["ctr_batch"], cfg["sparse"])
    exe = fluid.Executor(PAR_DEV)
    main, startup, avg, _ = build_dense(fluid, "ctr", cfg)
    s0 = fluid.Scope()
    exe.run(startup, scope=s0)
    init = host_state(s0)
    steps = PARALLEL["ctr_steps"]
    base = [float(exe.run(main, feed=feed, fetch_list=[avg],
                          scope=s0)[0][0]) for _ in range(steps)]

    def fresh():
        sc = fluid.Scope()
        for n, v in init.items():
            sc.set(n, v.to(PAR_DEV))
        return sc

    mesh = make_mesh({"dp": 2}, [PAR_DEV] * 2)
    main2, _, avg2, _ = build_dense(fluid, "ctr", cfg)
    t = DistributeTranspiler().transpile(0, program=main2,
                                         pservers="ps0,ps1", trainers=1)
    shard = t.parameter_shardings(mesh, axis="dp")
    trainer = t.get_trainer_program()
    pservers = {ep: t.get_pserver_program(ep) for ep in t.pserver_endpoints}
    ts = fresh()
    pscopes = {ep: fluid.Scope() for ep in t.pserver_endpoints}
    for ep in t.pserver_endpoints:
        t.scatter_scope(ts, pscopes[ep], ep, pservers[ep])
    grads = sorted(set(t.param_grad_map.values()))
    with fluid.scope_guard(ts):
        tp = fluid.ParallelExecutor(main_program=trainer, mesh=mesh,
                                    param_shardings=shard)
    sim = []
    for _ in range(steps):
        outs = tp.run([avg2.name] + grads, feed=feed)
        sim.append(float(outs[0][0]))
        g = dict(zip(grads, outs[1:]))
        for ep, prog in pservers.items():
            pfeed = {}
            for blk, e, bid in t._numbered_blocks():
                if e == ep:
                    gn = t.param_grad_map[blk.varname]
                    pfeed["%s.block%d" % (gn, bid)] = \
                        g[gn].reshape(-1)[blk.offset:blk.offset + blk.size]
            exe.run(prog, feed=pfeed, scope=pscopes[ep])
        t.gather_scope(pscopes, ts)
    ms = fresh()
    with fluid.scope_guard(ms):
        mp = fluid.ParallelExecutor(main_program=main2, mesh=mesh,
                                    param_shardings=shard)
    mono = [float(mp.run([avg2.name], feed=feed)[0][0])
            for _ in range(steps)]
    np.testing.assert_allclose(sim, base, **PARALLEL_FP32_TOL)
    np.testing.assert_allclose(mono, base, **PARALLEL_FP32_TOL)
    want = host_state(s0)
    params = [p.name for p in main.all_parameters()]
    # the simulation's trainer scope holds the params the pservers sent
    # back; their accumulators stay on the pservers
    for name, sc, names in (("simulation", ts, params),
                            ("monolithic", ms, sorted(want))):
        got = host_state(sc)
        for n in names:
            np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                       err_msg="%s %s" % (name, n),
                                       **PARALLEL_FP32_TOL)
    report = {"blocks": len(t.param_blocks), "sharded_vars": len(shard),
              "base_losses": base, "simulation_losses": sim,
              "monolithic_sharded_losses": mono, "card": card}
    print("%s %d blocks over 2 pservers, %d vars split over dp=2; losses "
          "%s (simulation) and %s (sharded monolithic) against %s"
          % (tag, len(t.param_blocks), len(shard), sim, mono, base))
    del ts, ms, s0, pscopes
    torch.cuda.empty_cache()
    return report


def run_parallel(torch, card):
    """Phase 35 (see PARALLEL and the module's docstring): the paths and
    the `parallel_summary:` report."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="ptt_phase35_")
    t0 = time.perf_counter()
    deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        legs = [t0]

        def leg(name):
            legs.append(time.perf_counter())
            leg_s[name] = legs[-1] - legs[-2]

        leg_s = {}
        C = _ParallelCase(torch, fluid, transformer)
        leg("build")
        timing = parallel_timing(torch, C, card)
        leg("timing")
        op = parallel_sp_op(torch, card)
        leg("sp_op")
        torch.use_deterministic_algorithms(True, warn_only=True)
        run_a, card_mesh, ref = parallel_card(torch, C, card)
        leg("a")
        run_b, dp2, _, _ = parallel_dp2(torch, C, card, ref)
        leg("b")
        dp2["planted_fault"] = parallel_grad_fault(torch, C, ref[2])
        leg("b_fault")
        run_c, tp = parallel_tp(torch, C, card, ref)
        leg("c")
        run_ring, ring = parallel_sp_step(torch, C, card, ref, "ring")
        leg("d_ring")
        run_uly, uly = parallel_sp_step(torch, C, card, ref, "ulysses")
        leg("d_ulysses")
        reshard = parallel_reshard(torch, _ParallelCase(
            torch, fluid, transformer, n_layer=PARALLEL["reshard_layers"]),
            card, tmp)
        leg("e")
        pserver = parallel_transpiler(torch, card)
        leg("f")
    finally:
        torch.use_deterministic_algorithms(deterministic)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    summary = {"timing": timing, "card_mesh": card_mesh, "dp2_zero": dp2,
               "tp2_gather": tp, "sp2_op": op, "sp2_ring_step": ring,
               "sp2_ulysses_step": uly, "reshard": reshard,
               "transpiler": pserver, "leg_s": leg_s,
               "phase_s": time.perf_counter() - t0, "card": card}
    return [("parallel_card_mesh", run_a), ("parallel_dp2_zero", run_b),
            ("parallel_tp2_gather", run_c), ("parallel_sp2_ring", run_ring),
            ("parallel_sp2_ulysses", run_uly)], summary, (C, ref)


# ------------------------------------------------------------------------
# Phase 36: the pipeline and MoE ops, "compute" tensor parallelism and
# rematerialization (ROADMAP A10b)
# ------------------------------------------------------------------------

PPM = dict(micro=8, experts=8, capacity=1.25, aux=0.01, eager=4, steps=4)
PPM_LOSS_RTOL = PARALLEL_LOSS_RTOL   # bf16 AMP over smaller products
# (microbatches of 4 rows, dp shards of 16), losses relative
PPM_GRAD_RTOL = PARALLEL_GRAD_RTOL   # the first step's Adam first
# moments against the Executor's, by norm (phase 35's reading)
PPM_MOE_LOSS_RTOL = 1e-2   # (b) on {"dp": 2, "ep": 4}: top-1 routing is
# discrete, so a bf16 difference upstream (the dp shards' smaller
# products) flips the odd token near a tie or at an expert's capacity
# edge, and Adam carries it on: 8 steps drift to 5.07e-3 (PR 26's first
# chip call; steps 1-4 within 1e-5). The first step's moments hold the
# reduction; the {"dp": 1, "ep": 4} leg, whose products are the
# Executor's, is held to PPM_LOSS_RTOL
PPM_KERNELS = ("flash_attention_fwd_bf16", "flash_attention_bwd_dkdv_bf16",
               "flash_attention_bwd_dq_bf16", "softmax_xent_fwd",
               "layer_norm_fwd")


def encoder_lm(fluid, transformer, kind, n_layer=None):
    """Phase 36's programs: bench.py's Transformer-base encoder (MODEL's
    widths, fused attention with no mask, bf16 AMP) as a language model:
    prepare_encoder, n_layer layers, the final layer_norm, an fc to the
    vocabulary and softmax_with_cross_entropy, Adam on noam (bench.py's
    build_train). kind "pipeline": the layers are pipelined_stack's
    stages (encoder_layer), PPM["micro"] microbatches; "moe": each
    layer's FFN is switch_moe(PPM["experts"], d_hidden d_inner,
    PPM["capacity"]) and the loss adds PPM["aux"] x the summed aux
    losses. Returns (main, startup, loss, the moe ops' input names)."""
    n_layer = n_layer or N_LAYER
    V, T, d = MODEL["vocab"], MODEL["max_length"], MODEL["d_model"]
    H, dk = MODEL["n_head"], MODEL["d_key"]
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = SEED
    main.enable_mixed_precision()
    auxes = []
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.layers.data("src_word", [T], dtype="int64")
        pos = fluid.layers.data("src_pos", [T], dtype="int64")
        lbl = fluid.layers.data("lbl_word", [T, 1], dtype="int64")
        h = transformer.prepare_encoder(src, pos, V, d, T)
        if kind == "pipeline":
            h = fluid.layers.pipelined_stack(
                h, n_layer, lambda x: transformer.encoder_layer(
                    x, None, H, dk, dk, d, MODEL["d_inner"],
                    use_fused=True), num_microbatches=PPM["micro"])
        else:
            for _ in range(n_layer):
                a = transformer.multi_head_attention(
                    transformer.pre_post_process_layer(None, h, "n"), None,
                    None, None, dk, dk, d, H, use_fused=True)
                a = transformer.pre_post_process_layer(h, a, "da")
                f, aux = fluid.layers.switch_moe(
                    transformer.pre_post_process_layer(None, a, "n"),
                    num_experts=PPM["experts"], d_hidden=MODEL["d_inner"],
                    capacity_factor=PPM["capacity"])
                auxes.append(aux)
                h = transformer.pre_post_process_layer(a, f, "da")
        h = transformer.pre_post_process_layer(None, h, "n")
        logits = fluid.layers.fc(input=h, size=V, bias_attr=False,
                                 num_flatten_dims=2)
        cost = fluid.layers.softmax_with_cross_entropy(
            logits=fluid.layers.reshape(logits, shape=[-1, V]),
            label=fluid.layers.reshape(lbl, shape=[-1, 1]))
        loss = fluid.layers.mean(cost)
        if auxes:
            loss = loss + PPM["aux"] * fluid.layers.sums(auxes)
        lr = fluid.layers.noam_decay(d, WARMUP_STEPS, 1.0)
        fluid.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98,
                             epsilon=1e-9).minimize(loss)
    moe_in = [op.inputs["X"][0] for op in main.global_block().ops
              if op.type == "moe"]
    return main, startup, loss, moe_in


def encoder_feed():
    """Phase 36's batch: TRAIN_BATCH random sequences of max_length
    tokens, each token's label the next token."""
    rng = np.random.RandomState(SEED + 36)
    B, T = TRAIN_BATCH, MODEL["max_length"]
    src = rng.randint(3, MODEL["vocab"], (B, T)).astype("int64")
    return {"src_word": src,
            "src_pos": np.tile(np.arange(T, dtype="int64"), (B, 1)),
            "lbl_word": np.roll(src, -1, axis=1)[..., None]}


def step_launches(main, lanes=1, micro=1, extra_fwd=()):
    """The bf16 K1-K3, K4 and K5 launches of one step of `main`: an op of
    a pipeline op's stage once a stage call (num_stages, times `micro`
    microbatches on a pp mesh), every other op once, all of it once a
    lane; `extra_fwd`: forward ops run once more (rematerialized)."""
    ops = main.global_block().ops
    grads = {op.attrs["fwd_uid"] for op in ops if op.type == "grad_of"}
    n = dict.fromkeys(PPM_KERNELS, 0)

    def add(op, times, grad):
        if op.type == "fused_attention":
            n["flash_attention_fwd_bf16"] += times
            if grad:
                n["flash_attention_bwd_dkdv_bf16"] += times
                n["flash_attention_bwd_dq_bf16"] += times
        elif op.type == "softmax_with_cross_entropy" and \
                not op.attrs.get("soft_label"):
            n["softmax_xent_fwd"] += times
        elif op.type == "layer_norm":
            n["layer_norm_fwd"] += times

    for op in ops:
        if op.type == "pipeline":
            calls = int(op.attrs["num_stages"]) * micro
            for sop in main.blocks[op.attrs["sub_block"]].ops:
                add(sop, calls, op.uid in grads)
        elif op.type != "grad_of":
            add(op, 1, op.uid in grads)
    for op in extra_fwd:
        add(op, 1, False)
    return {k: v * lanes for k, v in n.items()}


class _ProgramCase(_ParallelCase):
    """A phase 36 program, its batch, its startup state on the card and
    fresh scopes of it (_ParallelCase's interface)."""

    def __init__(self, torch, fluid, built, feed):
        self.torch, self.fluid = torch, fluid
        self.main, self.startup, loss, self.moe_in = built
        self.avg = loss.name
        self.fetch = [loss.name]
        self.feed = feed
        scope = fluid.Scope()
        fluid.Executor(PAR_DEV).run(self.startup, scope=scope)
        self.init = (host_state(scope), scope.seed_state())


def ppm_run(torch, runner, scope, eager, k, extra_fetch=()):
    """`eager` steps=1 calls (their wall ms) then one steps=k call:
    (losses, the kernels' launch counts, the first call's extra fetches,
    the first step's Adam first moments, eager ms, the steps=k call's
    wall ms a step)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    ck.reset_launch_counts()
    losses, eager_ms_, fetched, moments = [], [], None, None
    for i in range(eager):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = runner(1, list(extra_fetch) if i == 0 else [])
        torch.cuda.synchronize()
        eager_ms_.append((time.perf_counter() - ts) * 1e3)
        losses += _losses(out[-1])
        if i == 0:
            fetched = out[:-1]
            moments = first_moments(scope)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    out = runner(k, [])
    torch.cuda.synchronize()
    k_ms = (time.perf_counter() - ts) * 1e3 / k
    losses += _losses(out[-1])
    check(np.isfinite(losses).all(), "losses %s" % losses)
    return losses, ck.launch_counts(), fetched, moments, eager_ms_, k_ms


def ppm_close(tag, ref, got, moments, loss_tol=PPM_LOSS_RTOL):
    """Losses within `loss_tol` and the first moments within
    PPM_GRAD_RTOL of the reference run's."""
    lerr = max(abs(a - b) / abs(a) for a, b in zip(ref[0], got))
    check(len(got) == len(ref[0]) and lerr <= loss_tol,
          "%s losses %s within %.2e of the reference's %s (tolerance %.0e)"
          % (tag, got, lerr, ref[0], loss_tol))
    grads = parallel_grad_check(tag, ref[1], moments, PPM_GRAD_RTOL)
    return dict(grads, loss_rel_err=lerr, loss_tolerance=loss_tol)


def device_top(torch, fn, top=6):
    """(device kernel ms of fn(), its `top` kernels by device ms as
    [name, ms]) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = collections.Counter()
    for name, us in device_events(torch, prof):
        by[name[:60]] += us / 1e3
    return sum(by.values()), [[n, ms] for n, ms in by.most_common(top)]


def ppm_expected(counts, per, steps):
    expected = dict.fromkeys(counts, 0)
    expected.update({n: c * steps for n, c in per.items()})
    return expected


def ppm_program_leg(torch, C, tag, mesh_kw, lanes=1, micro=1, ref=None,
                    extra_fetch=(), loss_tol=PPM_LOSS_RTOL):
    """One side of (a) or (b): Executor (mesh_kw None) or a
    ParallelExecutor over mesh_kw, E steps=1 calls and one steps=K, under
    deterministic algorithms. Returns (path entry, report, (losses, first
    moments), extra fetches)."""
    E, K = PPM["eager"], PPM["steps"]
    scope = C.fresh()
    if mesh_kw is None:
        exe = C.fluid.Executor(PAR_DEV)
        runner = lambda s, extra: exe.run(  # noqa: E731
            C.main, feed=C.feed, fetch_list=extra + C.fetch, scope=scope,
            steps=s)
    else:
        exe = C.pexe(scope, **mesh_kw)
        runner = lambda s, extra: exe.run(  # noqa: E731
            extra + C.fetch, feed=C.feed, steps=s)
    losses, counts, fetched, moments, e_ms, k_ms = ppm_run(
        torch, runner, scope, E, K, extra_fetch)
    per = step_launches(C.main, lanes=lanes, micro=micro)
    report = {"losses": losses, "eager_step_ms": e_ms,
              "median_eager_step_ms": statistics.median(e_ms[1:]),
              "steps_k_call_ms_per_step": k_ms,
              "launches_per_step": per}
    # a second steps=K call: its step ms, and the device's share of it
    torch.cuda.synchronize()
    ts = time.perf_counter()
    if mesh_kw is None:
        exe.run(C.main, feed=C.feed, fetch_list=C.fetch, scope=scope,
                steps=K)
    else:
        exe.run(C.fetch, feed=C.feed, steps=K)
    torch.cuda.synchronize()
    report["captured_step_ms"] = (time.perf_counter() - ts) * 1e3 / K
    busy, top = device_top(torch, lambda: runner(K, []))
    report["device_ms_per_step"] = busy / K
    report["top_kernels_ms_per_step"] = [[n, ms / K] for n, ms in top]
    if ref is not None:
        report.update(ppm_close(tag, ref, losses, moments, loss_tol))
    exe._cache.clear()
    del scope
    torch.cuda.empty_cache()
    print("%s %d steps=1 calls and one steps=%d: losses %s; eager step ms "
          "%s, captured %.2f, on the device %.2f (top kernels %s)%s; "
          "launches a step %s"
          % (tag, E, K, [round(v, 4) for v in losses],
             [round(v, 1) for v in e_ms], report["captured_step_ms"],
             report["device_ms_per_step"],
             [[n, round(ms, 2)] for n, ms in
              report["top_kernels_ms_per_step"]],
             "" if ref is None else
             "; the first step's summed gradients within %.3e of the "
             "Executor's (tolerance %.0e), losses within %.2e"
             % (report["grad_rel_err"], PPM_GRAD_RTOL,
                report["loss_rel_err"]), per))
    return (counts, ppm_expected(counts, per, E + K + 1)), report, \
        (losses, moments), fetched


def ppm_pipeline(torch, fluid, transformer, card):
    """Phase 36 (a): the pipelined encoder LM on Executor (the stages one
    after the other) and on {"dp": 1, "pp": 6} (8 microbatches of 4
    rows through the looped schedule)."""
    tag = "pipeline (a)"
    C = _ProgramCase(torch, fluid, encoder_lm(fluid, transformer,
                                              "pipeline"), encoder_feed())
    run_e, rep_e, ref, _ = ppm_program_leg(torch, C, tag + " executor:",
                                           None)
    run_p, rep_p, _, _ = ppm_program_leg(
        torch, C, tag + " pp6:",
        {"mesh": _card_mesh(N_LAYER, dp=1, pp=N_LAYER)},
        micro=PPM["micro"], ref=ref)
    return [("pipeline_encoder_executor", run_e),
            ("pipeline_encoder_pp6", run_p)], \
        {"executor": rep_e, "pp6": rep_p, "card": card}


def ppm_moe(torch, fluid, transformer, card):
    """Phase 36 (b): the switch-MoE encoder LM on Executor, on {"dp": 1,
    "ep": 4} (the expert products in 4 groups, everything else the
    Executor's) and on {"dp": 2, "ep": 4}: the tokens each layer drops at
    capacity 1.25 on the first step, its aux losses, step ms."""
    from paddle_tpu_torch.parallel import moe
    tag = "moe (b)"
    C = _ProgramCase(torch, fluid, encoder_lm(fluid, transformer, "moe"),
                     encoder_feed())
    aux = [op.outputs["AuxLoss"][0] for op in C.main.global_block().ops
           if op.type == "moe"]
    gates = [op.inputs["Gate"][0] for op in C.main.global_block().ops
             if op.type == "moe"]
    run_e, rep_e, ref, fetched = ppm_program_leg(
        torch, C, tag + " executor:", None, extra_fetch=C.moe_in + aux)
    n = len(C.moe_in)
    dropped = []
    for x, gate in zip(fetched[:n], gates):
        x = torch.as_tensor(np.asarray(x)).to(PAR_DEV).reshape(
            -1, MODEL["d_model"])
        g = C.init[0][gate].to(PAR_DEV)
        probs = torch.softmax((x.float() @ g.float()), dim=-1)
        cap = int(np.ceil(x.shape[0] / PPM["experts"] * PPM["capacity"]))
        keep = moe.route(probs, cap)[3]
        dropped.append(float((~keep).float().mean()))
    rep_e["dropped_share_per_layer"] = dropped
    rep_e["aux_loss_per_layer"] = [float(np.ravel(a)[0])
                                   for a in fetched[n:]]
    run_q, rep_q, _, _ = ppm_program_leg(
        torch, C, tag + " dp1 ep4:",
        {"mesh": _card_mesh(4, dp=1, ep=4)}, ref=ref)
    run_p, rep_p, _, _ = ppm_program_leg(
        torch, C, tag + " dp2 ep4:",
        {"mesh": _card_mesh(8, dp=2, ep=4)}, lanes=2, ref=ref,
        loss_tol=PPM_MOE_LOSS_RTOL)
    print("%s the first step drops %s of the tokens a layer (capacity "
          "%.2f); aux losses %s" % (tag, [round(v, 4) for v in dropped],
                                    PPM["capacity"],
                                    [round(v, 4) for v in
                                     rep_e["aux_loss_per_layer"]]))
    return [("moe_encoder_executor", run_e), ("moe_encoder_dp1_ep4", run_q),
            ("moe_encoder_dp2_ep4", run_p)], \
        {"executor": rep_e, "dp1_ep4": rep_q, "dp2_ep4": rep_p,
         "card": card}


def ppm_tp_compute(torch, C, card, ref):
    """Phase 36 (c): phase 35's bf16 Transformer-base on {"dp": 1, "tp":
    2} under tp_placement="compute" (weights and their Adam moments on
    their pieces through the step, each product a piece at a time)
    against (a)'s Executor run, which the "gather" placement equals bit
    for bit (phase 35 (c))."""
    from paddle_tpu_torch.parallel import ShardingPlan
    tag = "tp compute (c):"
    E, K = PARALLEL["eager"], PARALLEL["steps"]
    scope = C.fresh()
    plan = ShardingPlan.build(C.main, _card_mesh(2, dp=1, tp=2),
                              tp_axis="tp", tp_placement="compute")
    pexe = C.pexe(scope, plan=plan)
    times = []

    def runner(s):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = pexe.run(C.fetch, feed=C.feed, steps=s)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - ts) * 1e3 / s)
        return out

    moments = {}
    got, counts = parallel_run(C, runner, scope, E, K, moments)
    per = parallel_launches(C.main)
    kinds = collections.Counter(
        next(iter(pexe._steps.values())).last_ran.values())
    check(kinds["tp_local"] > 0, "%s no product ran a piece at a time: %s"
          % (tag, dict(kinds)))
    res = ppm_close(tag, (ref[0], ref[2]), got, moments)
    total, replica = state_bytes(torch, scope)
    runner(K)       # a call that replays the captured step
    report = dict(res, losses=got, eager_step_ms=times[:E],
                  median_eager_step_ms=statistics.median(times[1:E]),
                  steps_k_call_ms_per_step=times[E],
                  captured_step_ms=times[E + 1],
                  piecewise_products=kinds["tp_local"],
                  state_bytes_on_card=total,
                  state_bytes_per_replica=replica,
                  launches_per_step=per, card=card)
    pexe._cache.clear()
    del scope, pexe
    torch.cuda.empty_cache()
    print("%s %d products a piece at a time; the first step's summed "
          "gradients within %.3e of (a)'s (tolerance %.0e), losses within "
          "%.2e; eager step ms %s, steps=%d %.2f a step (the capturing "
          "call), %.2f (a replaying one); state %d bytes on the card, %d a "
          "replica"
          % (tag, kinds["tp_local"], res["grad_rel_err"], PPM_GRAD_RTOL,
             res["loss_rel_err"], [round(v, 1) for v in times[:E]], K,
             times[E], times[E + 1], total, replica))
    return (counts, ppm_expected(counts, per, E + K + 1)), report


def ppm_remat(torch, fluid, transformer, C, card, ref):
    """Phase 36 (d): phase 35's bf16 Transformer-base with
    enable_rematerialization, 4 steps=1 calls and one steps=4 from (a)'s
    state: losses and state against (a)'s Executor run (bit-equal under
    deterministic algorithms unless a kernel's bits change on a
    recompute); max_memory_allocated eager and under steps=4 with and
    without remat, step ms of each."""
    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.ops import cuda_kernels as ck
    tag = "remat (d):"
    E, K = PARALLEL["eager"], PARALLEL["steps"]
    main_r, _, avg = build_train(fluid, transformer, N_LAYER,
                                 variant="bf16")
    fluid.memory_optimization_transpiler.enable_rematerialization(main_r)
    fetch = [next(op.inputs["X"][0] for op in main_r.global_block().ops
                  if avg.name in op.all_output_vars()), avg.name]
    plan, _ = lowering.remat_plan(
        main_r, [op for op in main_r.global_block().ops
                 if op.type not in lowering.HOST_IO_OPS], fetch)
    extra = [op for seg, interior in plan if interior for op in seg]
    side = {}
    for name, program in (("remat", main_r), ("plain", C.main)):
        exe = fluid.Executor(PAR_DEV)
        scope = C.fresh()
        eager_n = E if name == "remat" else 2
        for k0 in lowering.REMAT_COUNTS:
            lowering.REMAT_COUNTS[k0] = 0
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        at_start = torch.cuda.memory_allocated()
        losses, ms = [], []
        for _ in range(eager_n):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            losses += _losses(exe.run(program, feed=C.feed,
                                      fetch_list=fetch, scope=scope)[1])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - ts) * 1e3)
        peak_eager = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses += _losses(exe.run(program, feed=C.feed, fetch_list=fetch,
                                  scope=scope, steps=K)[1])
        torch.cuda.synchronize()
        peak_capture = torch.cuda.max_memory_allocated()
        counts = ck.launch_counts()
        if name == "remat":
            state = host_state(scope)
            rcounts = counts
        torch.cuda.reset_peak_memory_stats()
        ts = time.perf_counter()
        exe.run(program, feed=C.feed, fetch_list=fetch, scope=scope,
                steps=K)
        torch.cuda.synchronize()
        k_ms = (time.perf_counter() - ts) * 1e3 / K
        side[name] = {
            "losses": losses, "eager_step_ms": ms,
            "captured_step_ms": k_ms,
            "mem_at_start_bytes": at_start,
            "peak_eager_bytes": peak_eager,
            "peak_steps4_first_call_bytes": peak_capture,
            "peak_steps4_replay_bytes": torch.cuda.max_memory_allocated(),
            "capture_pool_bytes": next(iter(exe._cache.values())).pool_bytes,
            "remat_counts": dict(lowering.REMAT_COUNTS)}
        exe._cache.clear()
        del scope, exe
        torch.cuda.empty_cache()
    r = side["remat"]
    check(r["remat_counts"]["recomputed_segments"] > 0 and
          r["remat_counts"]["recomputed_segments"] ==
          r["remat_counts"]["deferred_segments"],
          "%s segments %s" % (tag, r["remat_counts"]))
    same, err, at = state_diff(torch, ref[1], state)
    lerr = max(abs(a - b) / abs(a) for a, b in zip(ref[0], r["losses"]))
    r.update(bit_equal_to_a=same and r["losses"] == ref[0],
             state_rel_err=err, state_worst_var=at, loss_rel_err=lerr)
    if not r["bit_equal_to_a"]:
        # not bit-equal on the card: held as (b) of phase 35 is, and the
        # distance reported
        lim = adam_bound(E + K)
        worst = max(float((ref[1][n].double() - state[n].double())
                          .abs().max()) if state[n].numel() else 0.0
                    for n in ref[1])
        check(lerr <= PPM_LOSS_RTOL and worst <= lim,
              "%s losses within %.2e of (a)'s, state within %.3e (bound "
              "%.3e)" % (tag, lerr, worst, lim))
        r["state_max_abs"] = worst
    per = step_launches(C.main)
    per_r = step_launches(main_r, extra_fwd=extra)
    steps = E + K + 1
    expected = dict.fromkeys(rcounts, 0)
    expected.update({n: per_r[n] * steps for n in per_r})
    p = side["plain"]
    print("%s %d segments deferred a step; losses and state %s (a)'s%s; "
          "max_memory_allocated eager %.2f GB (without remat %.2f), "
          "steps=%d first call %.2f GB (%.2f), replays %.2f GB (%.2f); "
          "step ms eager %s (%s), captured %.2f (%.2f); launches a step %s"
          % (tag, r["remat_counts"]["deferred_segments"] // (E + K + 2),
             "bit-equal to" if r["bit_equal_to_a"] else "within tolerance "
             "of", "" if r["bit_equal_to_a"] else
             " (losses %.2e, state %.2e at %s)" % (lerr, err, at),
             r["peak_eager_bytes"] / 1e9, p["peak_eager_bytes"] / 1e9, K,
             r["peak_steps4_first_call_bytes"] / 1e9,
             p["peak_steps4_first_call_bytes"] / 1e9,
             r["peak_steps4_replay_bytes"] / 1e9,
             p["peak_steps4_replay_bytes"] / 1e9,
             [round(v, 1) for v in r["eager_step_ms"]],
             [round(v, 1) for v in p["eager_step_ms"]],
             r["captured_step_ms"], p["captured_step_ms"], per_r))
    return [("remat_bf16", (rcounts, expected))], \
        {"remat": r, "plain": p, "launches_per_step": per_r,
         "launches_per_step_plain": per, "card": card}


def run_parallel_programs(torch, card, C, ref):
    """Phase 36 (see PPM and the module's docstring): the paths and the
    `parallel_programs_summary:` report. C and ref: phase 35's bf16
    Transformer-base case and (a)'s Executor run (losses, state, the
    first step's moments)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    leg_s, legs = {}, [t0]

    def leg(name):
        legs.append(time.perf_counter())
        leg_s[name] = legs[-1] - legs[-2]

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        paths, pipe = ppm_pipeline(torch, fluid, transformer, card)
        leg("a")
        more, moe_rep = ppm_moe(torch, fluid, transformer, card)
        paths += more
        leg("b")
        run_c, tp = ppm_tp_compute(torch, C, card, ref)
        paths.append(("tp2_compute", run_c))
        leg("c")
        more, remat = ppm_remat(torch, fluid, transformer, C, card, ref)
        paths += more
        leg("d")
    finally:
        torch.use_deterministic_algorithms(deterministic)
    torch.cuda.empty_cache()
    return paths, {"pipeline": pipe, "moe": moe_rep, "tp_compute": tp,
                   "remat": remat, "leg_s": leg_s,
                   "phase_s": time.perf_counter() - t0, "card": card}


# --------------------------------------------------------- serving fleet --

# phase 37: ROADMAP A10c, the serving side of A10, over phase 4's
# Transformer-base scoring model (weights from SEED; the reload's and the
# canary's candidate from FLEET_SEED) on the card
FLEET_SEED = SEED + 37
FLEET_BUCKETS = [1, 4, 8]     # phase 4's batch buckets
FLEET_REQUESTS = 8            # distinct scoring requests (phase 4's first)
FLEET_CLIENTS = 16            # closed-loop client threads
FLEET_PER_CLIENT = 6          # batch-1 requests each client sends in (a)
FLEET_LEG_PER_CLIENT = 3      # ... and in each leg of (b) and (c)
FLEET_WEDGE_S = 4.0           # the wedged dispatch's sleep: ten times
FLEET_ATTEMPT_S = 0.4         # the attempt timeout, itself ten times a
FLEET_WEDGE_CLIENTS = 4       # 4-client loop's dispatch on the card
FLEET_CLUSTER_STEPS = (40, 33)  # the heartbeat writers' step cursors
FLEET_CARD = "cuda:0"         # every replica's card, and the tp mesh's


class FleetRefs(object):
    """run_direct answers of a lone engine, by (request, batch bucket),
    made once (a pool's answer at a bucket is bit-equal to them)."""

    def __init__(self, engine, requests, fetch):
        self.engine, self.requests, self.fetch = engine, requests, fetch
        self._cache = {}
        self._lock = threading.Lock()

    def get(self, i, bucket):
        with self._lock:
            key = (i, bucket)
            if key not in self._cache:
                self._cache[key] = self.engine.run_direct(
                    self.requests[i], batch_bucket=bucket)[0][self.fetch]
            return self._cache[key]

    def fill(self):
        for i in range(len(self.requests)):
            for b in FLEET_BUCKETS:
                self.get(i, b)


def fleet_loop(target, requests, fetch, refs, clients=FLEET_CLIENTS,
               per_client=FLEET_PER_CLIENT, mid=None, retry_429=False):
    """A closed loop: `clients` threads each send `per_client` batch-1
    requests to `target` (a pool, an engine or a fleet entry), the next
    after the last answer; `mid()` runs once half of them are answered.
    Every answer is checked against `refs` (a list of FleetRefs: equal to
    one of them, bit for bit, at its bucket or, for a canary's answer,
    another) as it arrives. Returns a dict:
    latencies (s), wall (s), answered, errors, mismatches, failed-over
    latencies (s), 429s retried."""
    total = clients * per_client
    lat, over, errors, bad = [], [], [], []
    done = [0, 0]               # answered, 429s retried
    lock = threading.Lock()
    half = threading.Event()

    def client(c):
        for k in range(per_client):
            i = (c * per_client + k) % len(requests)
            ts = time.perf_counter()
            while True:
                try:
                    fut = target.submit(requests[i])
                    out = fut.result(600).numpy()[fetch]
                    break
                except Exception as e:  # noqa: BLE001 — counted below
                    if retry_429 and type(e).__name__ == "QueueFullError":
                        with lock:
                            done[1] += 1
                        time.sleep(getattr(e, "retry_after_s", 0.05))
                        continue
                    with lock:
                        errors.append(repr(e))
                    out = None
                    break
            dt = time.perf_counter() - ts
            if out is None:
                continue
            # a canary's answer rides its mirror's bucket label: it is
            # held to each bucket's reference when the labelled one differs
            buckets = [fut.bucket[0]] + [b for b in FLEET_BUCKETS
                                         if b != fut.bucket[0]]
            ok = np.isfinite(out).all() and any(
                np.array_equal(out, r.get(i, b)) for b in buckets
                for r in refs)
            with lock:
                lat.append(dt)
                if getattr(fut, "_retries_used", 0):
                    over.append(dt)
                if not ok:
                    bad.append(i)
                done[0] += 1
                if done[0] >= total // 2:
                    half.set()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    tw = time.perf_counter()
    for th in threads:
        th.start()
    if mid is not None:
        half.wait(600)
        mid()
    for th in threads:
        th.join(900)
    wall = time.perf_counter() - tw
    check(not any(th.is_alive() for th in threads),
          "a fleet client thread did not finish")
    return {"latencies": lat, "wall": wall, "answered": done[0],
            "errors": errors, "mismatches": bad, "failover": over,
            "retried_429": done[1]}


def fleet_row(r):
    lat = sorted(x * 1e3 for x in r["latencies"]) or [float("nan")]
    row = {"requests": r["answered"] + len(r["errors"]),
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "items_per_s": r["answered"] / r["wall"],
           "client_errors": len(r["errors"]),
           "mismatches": len(r["mismatches"])}
    if r["failover"]:
        row["failed_over"] = len(r["failover"])
        row["failover_max_ms"] = max(r["failover"]) * 1e3
    if r["retried_429"]:
        row["retried_429"] = r["retried_429"]
    return row


def fleet_check(tag, r):
    check(not r["errors"] and not r["mismatches"],
          "serving fleet %s: %d client errors (%s), %d answers not "
          "bit-equal to the lone engine's" % (
              tag, len(r["errors"]), r["errors"][:2], len(r["mismatches"])))


def fleet_idle_share(torch, target, requests, fetch, refs):
    """The device's idle share over a shorter closed loop (8 clients x 3
    requests) under torch.profiler: 1 - device kernel ms / wall ms."""
    box = {}
    busy, _, wall = device_busy_ms(torch, lambda: box.update(r=fleet_loop(
        target, requests, fetch, refs, clients=8, per_client=3)))
    fleet_check("idle share", box["r"])
    return {"idle_share": 1.0 - busy / wall, "device_busy_ms": busy,
            "wall_ms": wall}


def fleet_states(pool):
    return [r["state"] + ("/dead" if r["dead"] else "")
            for r in pool.pool_state()["replicas"]]


def fleet_pool_vs_engine(torch, d1, requests, fetch, refs, per):
    """(a): ReplicaPool(replicas=2) against the lone engine under the
    closed loop (counts zeroed just before each loop, read just after)."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import ReplicaPool
    rows, paths = {}, []
    t0 = time.perf_counter()
    pool = ReplicaPool(d1, replicas=2, batch_buckets=FLEET_BUCKETS,
                       name="scoring")
    build_s = time.perf_counter() - t0
    try:
        check([r["devices"] for r in pool.pool_state()["replicas"]]
              == [[FLEET_CARD], [FLEET_CARD]],
              "serving fleet (a): replicas placed on %r" % (
                  [r["devices"] for r in pool.pool_state()["replicas"]],))
        for tag, target, batches in (
                ("pool", pool, lambda: sum(
                    m.snapshot()["batches_total"]
                    for m in pool.replica_metrics().values())),
                ("engine", refs.engine, lambda: refs.engine.metrics
                 .snapshot()["batches_total"])):
            b0 = batches()
            ck.reset_launch_counts()
            r = fleet_loop(target, requests, fetch, [refs])
            counts = ck.launch_counts()
            n = batches() - b0
            fleet_check("(a) " + tag, r)
            expected = dict.fromkeys(counts, 0)
            expected.update({k: v * n for k, v in per.items()})
            paths.append(("serving_fleet_%s" % tag, (counts, expected)))
            rows[tag] = fleet_row(r)
            rows[tag]["dispatches"] = n
            rows[tag].update(fleet_idle_share(torch, target, requests,
                                              fetch, [refs]))
            rows[tag]["launches_per_dispatch"] = {
                k: counts[k] / max(n, 1) for k in per}
        rows["pool"]["build_s"] = build_s
        rows["pool"]["replica_dispatches"] = [
            r.dispatches for r in pool._replicas]
        check(all(r.dispatches for r in pool._replicas),
              "serving fleet (a): a replica took no dispatch: %r"
              % rows["pool"]["replica_dispatches"])
    finally:
        pool.close()
    return rows, paths


FLEET_FAULTS = [
    # (leg, fault plan, pool options, the pool metric the fault must move,
    # client threads)
    ("replica_wedge", ["replica_wedge@1:%g" % FLEET_WEDGE_S],
     dict(attempt_timeout_s=FLEET_ATTEMPT_S, eject_consecutive=2,
          eject_cooldown_s=60.0), "attempt_timeouts_total",
     FLEET_WEDGE_CLIENTS),
    ("replica_exc", ["replica_exc@3"], dict(eject_consecutive=3),
     "retries_total", FLEET_CLIENTS),
    ("replica_poison", ["replica_poison@3"], dict(eject_consecutive=2),
     "poisoned_results_total", FLEET_CLIENTS),
    ("replica_crash", ["replica_crash@3"], dict(eject_consecutive=2),
     "retries_total", FLEET_CLIENTS),
    ("kill_replica", [], dict(), "replica_kills_total", FLEET_CLIENTS),
]


def fleet_faults(d1, requests, fetch, refs):
    """(b): each serving fault kind through the replicas' taps (and
    kill_replica) under the closed loop: zero client errors, every
    answer bit-equal to the lone engine's. The wedge leg runs 4 clients
    (its attempt timeout must sit far above a healthy answer's latency)
    and waits for the wedged worker to wake before the next leg."""
    from paddle_tpu_torch.resilience.faults import FaultPlan
    from paddle_tpu_torch.serving import ReplicaPool
    rows = {}
    for leg, plan, opts, metric, clients in FLEET_FAULTS:
        pool = ReplicaPool(d1, replicas=2, batch_buckets=FLEET_BUCKETS,
                           name="scoring-" + leg, retries=3, **opts)
        try:
            mid = (lambda: pool.kill_replica(1)) if leg == "kill_replica" \
                else None
            with FaultPlan(plan):
                r = fleet_loop(pool, requests, fetch, [refs],
                               clients=clients,
                               per_client=FLEET_LEG_PER_CLIENT, mid=mid)
            fleet_check("(b) " + leg, r)
            snap = pool.metrics.snapshot()
            check(snap[metric] >= 1 and snap["errors_total"] == 0,
                  "serving fleet (b) %s: %s = %d, errors_total %d"
                  % (leg, metric, snap[metric], snap["errors_total"]))
            rows[leg] = fleet_row(r)
            rows[leg].update({
                metric: snap[metric], "retries": snap["retries_total"],
                "states": fleet_states(pool),
                "events": [e[1] for e in pool.events]})
            if leg == "replica_poison":
                check(snap["poisoned_results_total"] >= 1
                      and any(s.startswith("ejected")
                              for s in rows[leg]["states"]),
                      "serving fleet (b): the finite check never fired")
        finally:
            pool.close(timeout=60)
            # a wedged worker wakes and finishes its dispatch: before the
            # next leg, so no later path counts its launches
            for rep in pool._replicas:
                for w in rep.engine._batcher._workers:
                    w.join(FLEET_WEDGE_S + 30)
        print("serving fleet (b) %s: %s" % (leg, json.dumps(rows[leg])))
    return rows


def fleet_reload_promote(d1, d2, requests, fetch, refs, refs2):
    """(c): reload to FLEET_SEED's weights under the loop, then promote()
    with canary_poison (rolled back) and a healthy canary (promoted)."""
    from paddle_tpu_torch.resilience.faults import FaultPlan
    from paddle_tpu_torch.serving import ReplicaPool
    rows = {}
    pool = ReplicaPool(d1, replicas=2, batch_buckets=FLEET_BUCKETS,
                       name="scoring-reload")
    try:
        box = {}

        def reload():
            t0 = time.perf_counter()
            pool.reload(model_dir=d2)
            box["s"] = time.perf_counter() - t0

        r = fleet_loop(pool, requests, fetch, [refs, refs2], mid=reload,
                       per_client=FLEET_LEG_PER_CLIENT)
        fleet_check("(c) reload", r)
        gens = [rep.generation for rep in pool._replicas]
        check(gens == [1, 1], "serving fleet (c): generations %r" % gens)
        after = fleet_loop(pool, requests, fetch, [refs2], clients=4,
                           per_client=2)
        fleet_check("(c) after the reload", after)
        rows["reload"] = fleet_row(r)
        rows["reload"].update(reload_s=box["s"], generations=gens)
        for leg, plan, kw in (
                ("canary_poison", ["canary_poison@0"],
                 dict(model_dir=d1, traffic_fraction=0.25, min_requests=64,
                      max_breaches=2)),
                ("healthy_canary", [],
                 dict(model_dir=d2, traffic_fraction=0.25, min_requests=4,
                      max_breaches=2))):
            with FaultPlan(plan):
                t0 = time.perf_counter()
                ctrl = pool.promote(latency_ratio=None, **kw)
                build_s = time.perf_counter() - t0
                r = fleet_loop(pool, requests, fetch, [refs2],
                               per_client=FLEET_LEG_PER_CLIENT)
                limit = time.monotonic() + 120
                while ctrl.state()["state"] in ("canary", "promoting") \
                        and time.monotonic() < limit:
                    time.sleep(0.05)
            fleet_check("(c) " + leg, r)
            st = ctrl.state()
            want = "rolled_back" if plan else "promoted"
            check(st["state"] == want, "serving fleet (c) %s: %r"
                  % (leg, st))
            rows[leg] = fleet_row(r)
            rows[leg].update({k: st[k] for k in (
                "state", "sampled", "oks", "breaches", "breach_kinds",
                "max_divergence")})
            rows[leg]["canary_build_s"] = build_s
        rows["generations"] = [rep.generation for rep in pool._replicas]
    finally:
        pool.close()
    for k, v in rows.items():
        print("serving fleet (c) %s: %s" % (k, json.dumps(v)))
    return rows


def fleet_brownout_autoscale(d1, requests, fetch, refs, cluster_dir):
    """(d) and (g): a ModelFleet of the model at two priorities behind a
    ModelServer (the top tier under a closed loop, the lower one asked
    over HTTP: 429 with Retry-After), the cluster directory watched on
    its /metrics; then an autoscale=True pool over [1, 3] under a burst
    that sheds, contracted back to 1."""
    import urllib.error
    from paddle_tpu_torch.observability import registry as obsreg
    from paddle_tpu_torch.serving import ModelFleet, ModelServer, ReplicaPool
    rows = {}
    fleet = ModelFleet(shed_dwell_s=0.0, pressure_high=0.5,
                       pressure_low=0.25)
    # the top tier's admission ceiling is its queue capacity, 12: its 12
    # closed-loop clients hold it past pressure_high
    fleet.add_model("live", priority=1, weight=4.0, model_dir=d1,
                    replicas=1, queue_capacity=12,
                    batch_buckets=FLEET_BUCKETS)
    fleet.add_model("bulk", priority=0, weight=1.0, model_dir=d1,
                    replicas=1, queue_capacity=12,
                    batch_buckets=FLEET_BUCKETS)
    obsreg.watch_cluster(cluster_dir, heartbeat_timeout=600.0)
    server = ModelServer(fleet, port=0).start()
    base = "http://%s" % server.address
    # a 1 ms deadline: an admitted request expires in the queue (504)
    # instead of returning [1, 256, 30000] logits as JSON
    body = {"inputs": {k: np.asarray(v).tolist()
                       for k, v in requests[0].items()}, "deadline_ms": 1}
    shed, codes = [], []
    try:
        def ask_bulk():
            for _ in range(40):
                try:
                    http_json(base + "/v1/models/bulk:predict", body)
                    codes.append(200)
                except urllib.error.HTTPError as e:
                    codes.append(e.code)
                    if e.code == 429:
                        shed.append(int(e.headers["Retry-After"]))
                        return
                time.sleep(0.02)

        live = fleet.registry()["live"]
        r = fleet_loop(live, requests, fetch, [refs], clients=12,
                       per_client=6, mid=ask_bulk)
        fleet_check("(d) the top tier", r)
        check(shed and shed[0] >= 1, "serving fleet (d): the lower tier "
              "was never browned out (HTTP codes %r)" % codes)
        rows["brownout"] = fleet_row(r)
        rows["brownout"].update(
            bulk_http_codes=codes, retry_after=shed[0],
            shed_total=fleet.fleet_state()["models"]["bulk"]["shed_total"])
        # after the load the pressure falls and the lower tier answers
        out = fleet.infer("bulk", requests[1], timeout=600)[fetch]
        check(np.array_equal(out, refs.get(1, 1)),
              "serving fleet (d): the lower tier's answer after the load")
        health = json.loads(http_json(base + "/healthz").read())
        check(sorted(health.get("pools", {})) == ["bulk", "live"]
              and "brownout_level" in health.get("fleet", {}),
              "serving fleet (g): /healthz lacks pools or fleet: %r"
              % sorted(health))
        text = http_json(base + "/metrics").read().decode()
        lag = FLEET_CLUSTER_STEPS[0] - FLEET_CLUSTER_STEPS[1]
        want_line = ('ptpu_cluster_worker_steps_behind{cluster="%s",'
                     'worker="w1"} %d' % (os.path.basename(cluster_dir),
                                          lag))
        types = [ln.split()[2] for ln in text.splitlines()
                 if ln.startswith("# TYPE ")]
        check(want_line in text
              and 'ptpu_serving_pool_requests_total{model="live"}' in text
              and 'ptpu_serving_replica_state{model="bulk",replica="0"}'
              in text and len(types) == len(set(types)),
              "serving fleet (g): /metrics lacks the cluster lag, the "
              "pool families, or repeats a TYPE")
        rows["scrape"] = {"metrics_lines": len(text.splitlines()),
                          "families": len(types),
                          "cluster_line": want_line,
                          "healthz_status": health["status"],
                          "brownout_level": health["fleet"]
                          ["brownout_level"]}
    finally:
        obsreg.unwatch_cluster(cluster_dir)
        server.shutdown()

    pool = ReplicaPool(d1, replicas=1, batch_buckets=FLEET_BUCKETS,
                       name="scoring-autoscale", queue_capacity=8,
                       autoscale=True, min_replicas=1, max_replicas=3,
                       autoscale_kw=dict(interval_s=0.05, down_idle_s=1.0,
                                         scale_up_cooldown_s=0.5,
                                         scale_down_cooldown_s=1.0))
    try:
        r = fleet_loop(pool, requests, fetch, [refs], clients=32,
                       per_client=3, retry_429=True)
        fleet_check("(d) autoscale", r)
        st = pool._autoscaler.state()
        peak = 1 + st["scale_ups"]
        limit = time.monotonic() + 60
        while pool.live_replica_count() > 1 and time.monotonic() < limit:
            time.sleep(0.05)
        st = pool._autoscaler.state()
        check(st["scale_ups"] >= 1 and pool.live_replica_count() == 1
              and pool.metrics.snapshot()["errors_total"] == 0,
              "serving fleet (d): autoscale %r, live %d" % (
                  st, pool.live_replica_count()))
        rows["autoscale"] = fleet_row(r)
        rows["autoscale"].update(
            peak_replicas=peak, scale_ups=st["scale_ups"],
            scale_downs=st["scale_downs"],
            last_scale_up_s=st["last_scale_up_s"],
            rejected_429=pool.metrics.snapshot()["rejected_queue_full"])
    finally:
        pool.close()
    for k, v in rows.items():
        print("serving fleet (d) %s: %s" % (k, json.dumps(v)))
    return rows


def fleet_tp(torch, d1, requests, fetch, refs, per):
    """(e): InferenceEngine(tp=2, mesh_devices=[FLEET_CARD] * 2) against the
    one-card engine at every bucket, fp32 and bf16; its dispatch ms; a
    2-replica tp pool through engine_factory under kill_replica."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.serving import InferenceEngine, ReplicaPool
    rows, paths = {}, []
    for wd in ("fp32", "bf16"):
        one = InferenceEngine(d1, batch_buckets=FLEET_BUCKETS,
                              weights_dtype=wd, name="one-" + wd)
        tpe = InferenceEngine(d1, batch_buckets=FLEET_BUCKETS,
                              weights_dtype=wd, tp=2,
                              mesh_devices=[FLEET_CARD] * 2, name="tp-" + wd)
        try:
            check(tpe.device_span() == [FLEET_CARD] * 2
                  and any(e.sharded for e in tpe.plan if e.kind == "param"),
                  "serving fleet (e): the tp engine spans %r"
                  % tpe.device_span())
            for b in FLEET_BUCKETS:
                for i in range(2):
                    a = tpe.run_direct(requests[i], batch_bucket=b)[0][fetch]
                    w = one.run_direct(requests[i], batch_bucket=b)[0][fetch]
                    check(np.array_equal(a, w), "serving fleet (e) %s: the "
                          "tp engine differs from one card at bucket %d"
                          % (wd, b))
            flash = "flash_attention_fwd_bf16" if wd == "bf16" \
                else "flash_attention_fwd"
            kper = {flash: per["flash_attention_fwd"],
                    "layer_norm_fwd": per["layer_norm_fwd"]}
            b0 = tpe.metrics.snapshot()["batches_total"]
            ck.reset_launch_counts()
            futs = [tpe.submit(q) for q in requests]
            outs = [f.result(600).numpy()[fetch] for f in futs]
            counts = ck.launch_counts()
            n = tpe.metrics.snapshot()["batches_total"] - b0
            check(all(np.isfinite(o).all() for o in outs),
                  "serving fleet (e): a non-finite tp answer")
            expected = dict.fromkeys(counts, 0)
            expected.update({k: v * n for k, v in kper.items()})
            paths.append(("serving_fleet_tp_" + wd, (counts, expected)))
            feed = tpe._pad_batch([tpe.normalize_feed(requests[0])],
                                  FLEET_BUCKETS[-1], None)
            for e in (one, tpe):
                e._run(feed)
            torch.cuda.synchronize()
            ms = {tag: statistics.median(call_ms(torch, lambda e=e: e._run(
                feed)) for _ in range(5)) for tag, e in (("one", one),
                                                          ("tp", tpe))}
            rows[wd] = {"dispatch_ms_bucket8": ms["tp"],
                        "one_card_dispatch_ms_bucket8": ms["one"],
                        "dispatches": n,
                        "launches_per_dispatch": {
                            k: counts[k] / max(n, 1) for k in kper},
                        "bit_equal_buckets": FLEET_BUCKETS}
        finally:
            one.close()
            tpe.close()
            print("serving fleet (e) %s: %s" % (wd, json.dumps(rows[wd])))

    def factory(idx, place):
        return InferenceEngine(d1, batch_buckets=FLEET_BUCKETS, tp=2,
                               mesh_devices=[FLEET_CARD] * 2,
                               name="tp@%d" % idx)

    pool = ReplicaPool(engine_factory=factory, replicas=2, name="tp",
                       retries=3)
    try:
        r = fleet_loop(pool, requests, fetch, [refs], clients=8,
                       per_client=4, mid=lambda: pool.kill_replica(0))
        fleet_check("(e) tp pool", r)
        rows["tp_pool"] = fleet_row(r)
        rows["tp_pool"]["states"] = fleet_states(pool)
        rows["tp_pool"]["devices"] = [
            rep["devices"] for rep in pool.pool_state()["replicas"]]
    finally:
        pool.close()
    print("serving fleet (e) tp pool: %s" % json.dumps(rows["tp_pool"]))
    return rows, paths


def fleet_decode_pool():
    """(f): a DecodePool of two DecodeEngines over phase 31 (b)'s decode
    step against one engine and the solo decode."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.serving import DecodeEngine, DecodePool
    cfg = DECODE_LN
    feeds, budgets = decode_streams(cfg)
    engines = []
    for i in range(3):
        main, startup, nxt, fin = build_decode_step(fluid, cfg)
        engines.append(DecodeEngine(
            program=main, startup_program=startup, token_var=nxt,
            finished_var=fin, max_slots=cfg["slots"],
            name="decode-pool-%d" % i, queue_capacity=1024,
            default_max_new_tokens=max(budgets)))
    solo = engines[0].solo_clone(name="decode-pool-solo")
    pool = DecodePool(engines[1:], name="decode-pool")
    try:
        want = [np.asarray(solo.decode(f, max_new_tokens=b)).reshape(-1)
                for f, b in zip(feeds, budgets)]
        rows = {}
        for tag, target in (("one_engine", engines[0]), ("pool", pool)):
            t0 = time.perf_counter()
            got = decode_burst(target, feeds, budgets)
            dt = time.perf_counter() - t0
            bad = sum(not np.array_equal(g, w) for g, w in zip(got, want))
            check(bad == 0, "serving fleet (f) %s: %d streams differ from "
                  "the solo decode" % (tag, bad))
            tokens = int(sum(len(g) for g in got))
            rows[tag] = {"streams": len(feeds), "tokens": tokens,
                         "s": dt, "tokens_per_s": tokens / dt}
        rows["pool"]["replica_streams"] = [
            e.decode_stats()["streams_completed"] for e in engines[1:]]
    finally:
        pool.close()
        engines[0].close()
        solo.close()
    print("serving fleet (f): %s" % json.dumps(rows))
    return rows


def run_serving_fleet(torch, card):
    """Phase 37 (see the module's docstring). Returns [(path, (launch
    counts, the counts predicted))] and the report."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.resilience import HeartbeatWriter, write_plan
    from paddle_tpu_torch.serving import InferenceEngine

    report, paths = {"card": card}, []
    per = {"flash_attention_fwd": 3 * N_LAYER,
           "layer_norm_fwd": 5 * N_LAYER + 2}
    with tempfile.TemporaryDirectory(prefix="ptt_fleet_") as tmp:
        t0 = time.perf_counter()
        dirs = []
        for seed in (SEED, FLEET_SEED):
            main, startup, predict = build_scoring(fluid, transformer,
                                                   seed=seed)
            exe, scope = fluid.Executor(), fluid.Scope()
            exe.run(startup, scope=scope)
            d = os.path.join(tmp, "scoring_%d" % seed)
            fluid.io.save_inference_model(
                d, transformer.SCORING_FEED_NAMES, [predict], exe, main,
                scope=scope)
            dirs.append(d)
            del scope
        d1, d2 = dirs
        fetch = predict.name
        requests = scoring_requests(transformer, n=FLEET_REQUESTS)
        refs = FleetRefs(InferenceEngine(d1, batch_buckets=FLEET_BUCKETS,
                                         name="scoring-lone"),
                         requests, fetch)
        refs2 = FleetRefs(InferenceEngine(d2, batch_buckets=FLEET_BUCKETS,
                                          name="scoring-lone-2"),
                          requests, fetch)
        refs.fill()
        refs2.fill()
        report["setup_s"] = time.perf_counter() - t0
        print("serving fleet: saved seeds %d and %d, lone engines' "
              "answers at buckets %s in %.1f s" % (
                  SEED, FLEET_SEED, FLEET_BUCKETS, report["setup_s"]))
        cluster_dir = os.path.join(tmp, "cluster")
        writers = [HeartbeatWriter(cluster_dir, "w%d" % i, interval=0.5)
                   for i in range(2)]
        try:
            for w, step in zip(writers, FLEET_CLUSTER_STEPS):
                w.start()
                w.update(status="running", step=step)
            write_plan(cluster_dir, {"gen": 1, "phase": "run",
                                     "members": ["w0", "w1"],
                                     "quarantine": {}})
            rows, ps = fleet_pool_vs_engine(torch, d1, requests, fetch,
                                            refs, per)
            paths += ps
            report["pool_vs_engine"] = rows
            print("serving fleet (a): %s" % json.dumps(rows))
            refs2.engine.close()
            report["faults"] = fleet_faults(d1, requests, fetch, refs)
            report["reload_promote"] = fleet_reload_promote(
                d1, d2, requests, fetch, refs, refs2)
            report["fleet"] = fleet_brownout_autoscale(
                d1, requests, fetch, refs, cluster_dir)
            refs.engine.close()
            del refs2
            torch.cuda.empty_cache()
            report["tp"], ps = fleet_tp(torch, d1, requests, fetch, refs,
                                        per)
            paths += ps
        finally:
            for w in writers:
                w.close()
        torch.cuda.empty_cache()
    report["decode_pool"] = fleet_decode_pool()
    torch.cuda.empty_cache()
    return paths, report


# ------------------------------------------------------- elastic cluster --

# phase 38: ROADMAP A10's last module, the elastic cluster. Real worker
# processes on the card, spawned through the port's launcher
# (paddle_tpu_torch.tools.ptpu_elastic: its _WorkerPool, or `launch`) with
# this script's own `elastic-worker` subcommand as --worker-cmd: (a)
# bench.py's bf16 AMP Transformer-base trained by two workers on {"dp": 2}
# of the card shared twice (sharded_weight_update, a budget of 4 devices),
# host_death@ELASTIC["death_at"] kills w1, w0 reshards onto {"dp": 4} and
# is held bit for bit to a reference process, a replacement joins at a
# step barrier; (b) a hang escalated to a same-size rollback; (c) a canary
# conviction quarantining local device 1; (d) `launch` with a heartbeat
# stall, `status --json` and a worker's /metrics. (b)-(d) train the
# launcher's demo MLP beside (a). Every worker runs under deterministic
# algorithms with CUBLAS_WORKSPACE_CONFIG set, TF32 off.
ELASTIC = dict(steps=7, death_at=3, hold_at=5, checkpoint_every=2,
               budget=4, tiny_host_devices=2,
               # host deaths are seen by the vanished pid: the monitors'
               # timeouts exceed ten process starts
               monitor_timeout=600.0, fence_timeout=300.0,
               hold_timeout=180.0,
               # (b)'s watchdog outlasts a fresh process's first steps on
               # the card (cuBLAS and the kernels load there)
               tiny_steps=8, hang_at=3, hang_sleep=8.0, hang_timeout=5.0,
               sdc_every=2, stall_at=4, stall_steps=32, stall_delay=0.15,
               stall_timeout=3.0, deadline=300.0)
ELASTIC_CUBLAS = ":4096:8"   # CUBLAS_WORKSPACE_CONFIG in every process


def _elastic_devices_on_card(layout):
    """A phase 38 worker trains on the card or not at all."""
    import torch
    devs = layout.local_devices()
    if not torch.cuda.is_available() or not devs or any(
            torch.device(d).type != "cuda" for d in devs):
        raise RuntimeError("phase 38's workers train on CUDA devices; this "
                           "one sees %s (cuda available: %s)"
                           % ([str(d) for d in devs],
                              torch.cuda.is_available()))


def elastic_transformer_build(layout):
    """The ElasticWorker build_fn of (a): phase 35's bf16 AMP
    Transformer-base program (startup seeded by SEED), four batches of
    TRAIN_BATCH sequences from SEED fed in turn."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    _elastic_devices_on_card(layout)
    main, startup, avg = build_train(fluid, transformer, N_LAYER,
                                     variant="bf16")
    main.random_seed = SEED
    rng = np.random.RandomState(SEED)
    batches = []
    for _ in range(4):
        srcs = [rng.randint(3, MODEL["vocab"], MODEL["max_length"]).tolist()
                for _ in range(TRAIN_BATCH)]
        batches.append(transformer.prepare_batch(
            srcs, srcs, MODEL["max_length"], labels=True))
    return {"main": main, "startup": startup, "loss": avg,
            "feed_fn": lambda i: batches[i % len(batches)]}


def elastic_demo_build(layout):
    """The ElasticWorker build_fn of (b)-(d): the launcher's demo MLP, on
    the card."""
    from paddle_tpu_torch.tools.ptpu_elastic import demo_build
    _elastic_devices_on_card(layout)
    return demo_build(layout)


def _elastic_determinism():
    """The settings every phase 38 process trains under, set before the
    first CUDA call (cuBLAS reads its workspace config at init)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ELASTIC_CUBLAS)
    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def elastic_worker_main(argv):
    """`python3 chip_smoke.py elastic-worker [--model transformer|demo]
    ...`: one ElasticWorker of phase 38, on the card (exit 3 without
    one). The launcher appends --cluster-dir, --worker-id and --steps.
    At exit it writes stats_<id>.json to the cluster directory: each
    generation's mesh, steps and kernel launches, each step's wall
    time, the save and restore ms, max_memory_allocated."""
    ap = argparse.ArgumentParser(prog="chip_smoke.py elastic-worker")
    ap.add_argument("--model", choices=("transformer", "demo"),
                    default="demo")
    ap.add_argument("--cluster-dir",
                    default=os.environ.get("PTPU_CLUSTER_DIR"))
    ap.add_argument("--worker-id", default=os.environ.get("PTPU_WORKER_ID"))
    ap.add_argument("--steps", type=int,
                    default=int(os.environ.get("PTPU_ELASTIC_STEPS", "8")))
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--watchdog-timeout", type=float, default=None)
    ap.add_argument("--sdc-every", type=int, default=0)
    ap.add_argument("--step-delay", type=float, default=0.0)
    ap.add_argument("--hold-at", type=int, default=None,
                    help="in a world of one (after a shrink), wait after "
                         "step HOLD_AT - 1 until the plan moves on: the "
                         "replacement then joins mid-run")
    ap.add_argument("--join-gate", action="store_true",
                    help="start up, then join only once a survivor holds "
                         "(hold.json in the cluster directory)")
    ap.add_argument("--metrics-port", type=int,
                    default=(int(os.environ["PTPU_METRICS_PORT"])
                             if os.environ.get("PTPU_METRICS_PORT")
                             else None))
    args = ap.parse_args(argv)
    # the worker's output goes to <cluster dir>/<id>.log
    os.makedirs(args.cluster_dir, exist_ok=True)
    log = os.open(os.path.join(args.cluster_dir, "%s.log" % args.worker_id),
                  os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(log, 1)
    os.dup2(log, 2)
    os.close(log)
    torch = _elastic_determinism()
    if not torch.cuda.is_available():
        print("elastic-worker: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 3
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.resilience import cluster as cl
    from paddle_tpu_torch.resilience.cluster import (ClusterAborted,
                                                     ElasticWorker)
    ck.build()
    transformer = args.model == "transformer"
    stats = {"worker": args.worker_id, "model": args.model, "gens": [],
             "steps": [], "save_ms": [], "restore_ms": [], "gen": None}
    build = elastic_transformer_build if transformer else elastic_demo_build

    def build_counted(layout):
        """The generation's program, and phase 35's launch counts of one
        lane's step of it."""
        built = build(layout)
        stats["lane"] = parallel_launches(built["main"])
        return built
    worker = ElasticWorker(
        args.cluster_dir, args.worker_id, build_counted,
        checkpoint_every=args.checkpoint_every,
        watchdog_timeout=args.watchdog_timeout,
        sharded_weight_update=transformer, async_save=transformer,
        step_delay=args.step_delay, metrics_port=args.metrics_port,
        sdc=bool(args.sdc_every) or None, sdc_every=args.sdc_every or 64)

    def timed(name, fn):
        def wrapper(*a, **kw):
            ts = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                stats[name].append(
                    [stats["gen"], (time.perf_counter() - ts) * 1e3])
        return wrapper
    CheckpointManager.save = timed("save_ms", CheckpointManager.save)
    CheckpointManager.restore = timed("restore_ms", CheckpointManager.restore)
    record = worker._record

    def record_timed(gen, step, fetches):
        stats["steps"].append([gen, int(step), time.time()])
        out = record(gen, step, fetches)
        if args.hold_at is not None and step == args.hold_at - 1:
            _hold_for_grow(cl, args.cluster_dir, gen)
        return out
    worker._record = record_timed
    run_generation = worker._run_generation

    def run_generation_counted(plan, num_steps):
        ck.reset_launch_counts()
        stats["gen"] = plan["gen"]
        n0 = len(stats["steps"])
        try:
            return run_generation(plan, num_steps)
        finally:
            layout = worker._layout_for(plan)
            stats["gens"].append({
                "gen": plan["gen"],
                "local_device_count": layout.resolved_local_device_count(),
                "skip_local_devices": list(layout.skip_local_devices),
                "devices": [str(d) for d in layout.local_devices()],
                "steps": len(stats["steps"]) - n0,
                "lane": stats.get("lane"),
                "launches": ck.launch_counts()})
    worker._run_generation = run_generation_counted
    rc = 0
    if args.join_gate:
        # started up (torch, the card, the kernels): wait to join
        stats["ready"] = time.time()
        deadline = time.monotonic() + ELASTIC["hold_timeout"]
        while not os.path.exists(os.path.join(args.cluster_dir,
                                              "hold.json")) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
    try:
        out = worker.run(args.steps)
        print("elastic-worker %s finished: %s" % (args.worker_id, out))
    except ClusterAborted as e:
        print("elastic-worker %s: %s" % (args.worker_id, e), file=sys.stderr)
        rc = 1
    finally:
        stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        with open(os.path.join(args.cluster_dir,
                               "stats_%s.json" % args.worker_id), "w") as f:
            json.dump(stats, f)
    return rc


def _hold_for_grow(cl, cluster_dir, gen):
    """A survivor alone in its world (after the shrink) waits at its step
    barrier until the coordinator moves the plan on (the replacement's
    grow fence), for at most ELASTIC["hold_timeout"] s: the grow then
    lands at that step, with steps of the shrunk mesh before it."""
    plan = cl.read_plan(cluster_dir) or {}
    if plan.get("gen") != gen or len(plan.get("world", {})) != 1:
        return
    # opens the replacement's gate (`elastic-worker --join-gate`)
    with open(os.path.join(cluster_dir, "hold.json.tmp"), "w") as f:
        json.dump({"gen": gen, "wall_time": time.time()}, f)
    os.replace(os.path.join(cluster_dir, "hold.json.tmp"),
               os.path.join(cluster_dir, "hold.json"))
    deadline = time.monotonic() + ELASTIC["hold_timeout"]
    while time.monotonic() < deadline:
        plan = cl.read_plan(cluster_dir) or {}
        if plan.get("gen", gen) != gen:
            return
        time.sleep(0.02)


def elastic_reference_main(argv):
    """`python3 chip_smoke.py elastic-reference CKPT RESTORE UPTO OUT`:
    phase 38 (a)'s from-scratch run: (a)'s program restored from CKPT's
    step RESTORE onto {"dp": ELASTIC["budget"]} of the card (as many
    replicas, sharded_weight_update), stepped to UPTO under the workers'
    settings; the per-step losses written to OUT as JSON."""
    ckpt, restore, upto, out = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch = _elastic_determinism()
    if not torch.cuda.is_available():
        print("elastic-reference: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 3
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.parallel import DeviceLayout
    ck.build()
    layout = DeviceLayout(local_device_count=ELASTIC["budget"],
                          devices=["cuda:0"] * ELASTIC["budget"])
    mesh = layout.local_mesh()
    built = elastic_transformer_build(layout)
    scope = fluid.Scope()
    rows = {}
    with fluid.scope_guard(scope):
        fluid.Executor(mesh.devices.flat[0]).run(built["startup"])
        with CheckpointManager(ckpt, async_save=False) as mgr:
            got = mgr.restore(program=built["main"], scope=scope,
                              step=restore, layout=layout)
        check(got == restore, "restored %r, not %d" % (got, restore))
        pexe = fluid.ParallelExecutor(main_program=built["main"], mesh=mesh,
                                      sharded_weight_update=True)
        for i in range(restore, upto):
            v, = pexe.run([built["loss"].name], feed=built["feed_fn"](i))
            rows[i] = float(np.asarray(v).reshape(-1)[0])
    with open(out, "w") as f:
        json.dump(rows, f)
    return 0


class _ElasticProcs(object):
    """Every process phase 38 starts, each with the time it exited (a
    watcher polls it; the launcher's pool reaps its own at once): killed
    in `close`."""

    def __init__(self):
        self.procs = []
        self.groups = []
        self.exit_time = {}
        self._lock = threading.Lock()

    def watch(self, name, proc):
        with self._lock:
            self.procs.append(proc)

        def poll():
            while proc.poll() is None:
                time.sleep(0.01)
            self.exit_time[name] = time.time()
        threading.Thread(target=poll, daemon=True).start()
        return proc

    def spawn(self, name, cmd, log, env=None):
        """A process in a session of its own: `close` kills its whole
        group, the workers a launcher started included."""
        out = open(log, "w")
        try:
            proc = subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT, env=env,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                start_new_session=True)
        finally:
            out.close()
        with self._lock:
            self.groups.append(proc.pid)
        return self.watch(name, proc)

    def close(self):
        with self._lock:
            procs, groups = list(self.procs), list(self.groups)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for pgid in groups:
            try:
                os.killpg(pgid, signal.SIGKILL)
            except OSError:
                pass   # the group has no process left
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass


def _elastic_coord(cl, d, **kw):
    """A ClusterCoordinator over `d` in a thread of this process; returns
    (coordinator, thread, result box)."""
    coord = cl.ClusterCoordinator(
        d, heartbeat_timeout=ELASTIC["monitor_timeout"], poll_interval=0.05,
        fence_timeout=ELASTIC["fence_timeout"], **kw)
    box = {}

    def run():
        try:
            box["summary"] = coord.run(deadline=ELASTIC["deadline"])
        except Exception as e:  # noqa: BLE001 — checked by the leg
            box["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return coord, t, box


def _elastic_event(coord, name, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ev = [e for e in coord.events if e["event"] == name]
        if ev:
            return ev[-1]
        time.sleep(0.02)
    raise SmokeFailure("phase 38: no %r event within %.0f s; events %s"
                       % (name, timeout, [e["event"] for e in coord.events]))


def _elastic_rows(d, wid):
    path = os.path.join(d, "results_%s.jsonl" % wid)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def _elastic_stats(d, wid):
    path = os.path.join(d, "stats_%s.json" % wid)
    check(os.path.exists(path), "phase 38: worker %s wrote no stats; its "
          "log: %s" % (wid, _elastic_log_tail(os.path.join(d, "%s.log"
                                                            % wid))))
    with open(path) as f:
        return json.load(f)


def _elastic_log_tail(path, n=2000):
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return "(no log)"


def _worker_cmd(model, *extra):
    return " ".join([sys.executable, os.path.abspath(__file__),
                     "elastic-worker", "--model", model] + list(extra))


def _step_ms(stats, gen):
    """Median ms between a generation's successive recorded steps."""
    t = [s[2] for s in stats["steps"] if s[0] == gen]
    d = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    return statistics.median(d) if d else None


def elastic_kill_and_grow(torch, card, tmp, procs, on_formed=None):
    """Phase 38 (a); `on_formed()` is called once the cohort has formed.
    Returns ((launch counts, the counts predicted), the report)."""
    import argparse as _ap
    from paddle_tpu_torch.resilience import cluster as cl
    from paddle_tpu_torch.tools import ptpu_elastic as tool
    tag = "elastic (a):"
    E = ELASTIC
    d = os.path.join(tmp, "a")
    os.makedirs(d)
    steps, death = E["steps"], E["death_at"]
    times, spawned = {}, {}
    args = _ap.Namespace(
        cluster_dir=d, steps=steps, host_devices=E["budget"],
        fault_plan="host_death@%d" % death, metrics_port_base=None,
        worker_cmd=_worker_cmd("transformer", "--checkpoint-every",
                               str(E["checkpoint_every"]), "--hold-at",
                               str(E["hold_at"])))
    pool = tool._WorkerPool(args)
    ref_out = os.path.join(tmp, "reference.json")

    def on_event(ev):
        # the reference run, started the moment the cohort has rescaled
        if ev["event"] == "rescale" and "reference" not in spawned:
            spawned["reference"] = True
            env = dict(os.environ, PYTHONPATH=tool.REPO,
                       CUBLAS_WORKSPACE_CONFIG=ELASTIC_CUBLAS)
            env.pop("PTPU_FAULT_PLAN", None)
            procs.spawn("reference", [
                sys.executable, os.path.abspath(__file__),
                "elastic-reference", cl.default_checkpoint_dir(d),
                str(ev["restore_step"]), str(E["hold_at"]), ref_out],
                os.path.join(tmp, "reference.log"), env=env)

    coord, t, box = _elastic_coord(
        cl, d, num_workers=2, total_device_count=E["budget"],
        on_event=on_event)
    try:
        times["spawn"] = time.time()
        for i in range(2):
            wid = pool.spawn(with_fault=i == 1)
            spawned[wid] = procs.watch(wid, pool.procs[wid])
        formed = _elastic_event(coord, "formed", 300)
        # the replacement: a standby that starts up now and joins once the
        # survivor holds (`--join-gate`), so its start-up is off the path
        times["replacement_spawned"] = time.time()
        pool.args.worker_cmd += " --join-gate"
        wid = pool.spawn(with_fault=False)
        spawned[wid] = procs.watch(wid, pool.procs[wid])
        if on_formed is not None:
            on_formed()
        resc = _elastic_event(coord, "rescale", 300)
        grow = _elastic_event(coord, "grow", 300)
        t.join(E["deadline"])
        check("summary" in box, "%s the coordinator ended %s; events %s; "
              "w0's log: %s" % (tag, box, [e["event"] for e in coord.events],
                                _elastic_log_tail(os.path.join(d,
                                                               "w0.log"))))
        for wid in ("w0", "w2"):
            check(spawned[wid].wait(timeout=120) == 0, "%s %s exited %s"
                  % (tag, wid, spawned[wid].returncode))
        rc1 = spawned["w1"].wait(timeout=60)
        deadline = time.monotonic() + 300
        while "reference" not in procs.exit_time \
                and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        pool.kill_all()
    check(rc1 == -9, "%s w1 exited %s, not -9 (SIGKILL)" % (tag, rc1))
    summary = box["summary"]
    check(sorted(summary["world"]) == ["w0", "w2"]
          and summary["steps"] == {"w0": steps, "w2": steps},
          "%s the final world %s, steps %s" % (tag, summary["world"],
                                               summary["steps"]))
    names = [e["event"] for e in coord.events]
    check("abort" not in names and "refence" not in names,
          "%s events %s" % (tag, names))
    rows0, rows1, rows2 = (_elastic_rows(d, w) for w in ("w0", "w1", "w2"))
    # the death at exactly step `death`
    check(sorted(r["step"] for r in rows1) == list(range(death)),
          "%s w1 recorded steps %s, expected 0-%d" % (
              tag, [r["step"] for r in rows1], death - 1))
    before = {r["step"]: r["value"] for r in rows0 if r["gen"] < resc["gen"]}
    check(all(before[r["step"]] == r["value"] for r in rows1
              if r["step"] in before), "%s w0 and w1 disagreed before the "
          "death" % tag)
    check(resc["survivors"] == ["w0"], "%s rescale %s" % (tag, resc))
    restore, G = resc["restore_step"], grow["restore_step"]
    check(restore is not None and restore <= death
          and restore < G == E["hold_at"] < steps,
          "%s restore step %s, grow step %s of %d (the survivor held at %d)"
          % (tag, restore, G, steps, E["hold_at"]))
    plan_r = next(p for p in coord._plans if p["gen"] == resc["gen"])
    check(plan_r["world"] == {"w0": {"rank": 0, "local_device_count":
                                     E["budget"]}},
          "%s the rescaled world %s" % (tag, plan_r["world"]))
    post = {}
    for r in rows0:
        if r["gen"] >= resc["gen"]:
            check(r["step"] not in post, "%s step %d recorded twice after "
                  "the rescale" % (tag, r["step"]))
            post[r["step"]] = r["value"]
    check(sorted(post) == list(range(restore, steps)),
          "%s w0's steps after the rescale %s" % (tag, sorted(post)))
    check(procs.exit_time.get("reference") is not None
          and os.path.exists(ref_out), "%s the reference run failed: %s"
          % (tag, _elastic_log_tail(os.path.join(tmp, "reference.log"))))
    with open(ref_out) as f:
        ref = {int(k): v for k, v in json.load(f).items()}
    small = {s: v for s, v in post.items() if s < G}
    check(small == {s: ref[s] for s in small}, "%s w0's stream on {'dp': "
          "%d} %s differs from the reference process's %s"
          % (tag, E["budget"], small, {s: ref[s] for s in small}))
    pre_grow = [r["step"] for r in rows0
                if resc["gen"] <= r["gen"] < grow["gen"]]
    post_grow = [r["step"] for r in rows0 if r["gen"] >= grow["gen"]]
    check(pre_grow and post_grow and max(pre_grow) + 1 == min(post_grow)
          == G, "%s the grow at step %d aborted a step: %s then %s"
          % (tag, G, pre_grow, post_grow))
    joined = {r["step"]: r["value"] for r in rows2 if r["gen"] >= grow["gen"]}
    check(sorted(joined) == list(range(G, steps))
          and joined == {s: post[s] for s in joined},
          "%s the joiner's stream %s, w0's %s" % (
              tag, joined, {s: post[s] for s in joined}))
    st = {w: _elastic_stats(d, w) for w in ("w0", "w2")}
    # the launches: each generation's recorded steps x the mesh's lanes x
    # a lane's step of its program (phase 35's counts)
    counts, expected = None, None
    for s in st.values():
        for g in s["gens"]:
            check(all(dev.startswith("cuda") for dev in g["devices"]),
                  "%s a generation trained on %s" % (tag, g["devices"]))
            if counts is None:
                counts = dict.fromkeys(g["launches"], 0)
                expected = dict.fromkeys(g["launches"], 0)
            for n, c in g["launches"].items():
                counts[n] += c
            for n, c in g["lane"].items():
                expected[n] += c * g["steps"] * g["local_device_count"]
    ev = {e["event"]: e for e in coord.events}
    i = names.index("detected")
    fence = coord.events[names.index("fence", i)]
    fenced = coord.events[names.index("fenced", i)]
    death_t = procs.exit_time["w1"]
    first_after = min(s[2] for s in st["w0"]["steps"]
                      if s[0] >= resc["gen"])
    first_grown = min(s[2] for w in ("w0", "w2") for s in st[w]["steps"]
                      if s[0] >= grow["gen"])
    gen1 = min(g["gen"] for g in st["w0"]["gens"])
    rescale_gen = resc["gen"]
    report = {
        "steps": steps, "death_at": death, "restore_step": restore,
        "grow_step": G, "events": names,
        "formation_s": formed["wall_time"] - times["spawn"],
        "death_to_detected_s": ev["detected"]["wall_time"] - death_t,
        "fence_s": fenced["wall_time"] - fence["wall_time"],
        "restore_ms_after_rescale": [
            ms for g, ms in st["w0"]["restore_ms"] if g == resc["gen"]],
        "death_to_first_step_s": first_after - death_t,
        "replacement_start_up_s":
            st["w2"]["ready"] - times["replacement_spawned"],
        "join_to_first_grown_step_s":
            first_grown - ev["join_detected"]["wall_time"],
        "eager_step_ms_dp2": _step_ms(st["w2"], grow["gen"]),
        "eager_step_ms_dp2_w0_first_gen": _step_ms(st["w0"], gen1),
        "eager_step_ms_dp4": _step_ms(st["w0"], rescale_gen),
        "save_ms": {w: s["save_ms"] for w, s in st.items()},
        "restore_ms": {w: s["restore_ms"] for w, s in st.items()},
        "max_memory_allocated": {w: s["max_memory_allocated"]
                                 for w, s in st.items()},
        "bit_equal_to_reference": sorted(small),
        "launches_by_gen": {w: [(g["gen"], g["local_device_count"],
                                 g["steps"]) for g in s["gens"]]
                            for w, s in st.items()},
        "card": card}
    print("%s formed in %.1f s; w1 killed at step %d (rc -9), detected "
          "%+.3f s from this process's reading of its exit (both poll), "
          "fence %.3f s, restore %s ms, first step on {'dp': "
          "%d} %.1f s after the death; steps %d-%d bit-equal to the "
          "reference process; the replacement started up in %.1f s (then "
          "gated until the survivor held), its first grown step %.1f s "
          "after its join (grow at step %d, no aborted step); eager step "
          "ms dp2 %s, dp4 %s; save ms %s; "
          "max_memory_allocated %s; %s"
          % (tag, report["formation_s"], death,
             report["death_to_detected_s"], report["fence_s"],
             ["%.0f" % m for m in report["restore_ms_after_rescale"]],
             E["budget"], report["death_to_first_step_s"], restore, G - 1,
             report["replacement_start_up_s"],
             report["join_to_first_grown_step_s"], G,
             report["eager_step_ms_dp2"], report["eager_step_ms_dp4"],
             ["%.0f" % m for _, m in report["save_ms"]["w0"]],
             report["max_memory_allocated"], card))
    return (counts, expected), report


def elastic_hang(tmp, procs, pool_cls, cl, card):
    """Phase 38 (b): slow_step@hang_at for hang_sleep s against a
    watchdog of hang_timeout s: a local abort with a bundle, escalated
    through the heartbeat to a same-size rollback."""
    import argparse as _ap
    E, tag = ELASTIC, "elastic (b):"
    d = os.path.join(tmp, "b")
    os.makedirs(d)
    pool = pool_cls(_ap.Namespace(
        cluster_dir=d, steps=E["tiny_steps"], host_devices=E["tiny_host_devices"],
        fault_plan="slow_step@%d:%g" % (E["hang_at"], E["hang_sleep"]),
        metrics_port_base=None, worker_cmd=_worker_cmd(
            "demo", "--checkpoint-every", "2", "--watchdog-timeout",
            str(E["hang_timeout"]))))
    coord, t, box = _elastic_coord(cl, d, num_workers=1,
                                   local_device_count=E["tiny_host_devices"])
    try:
        procs.watch("b/w0", pool.procs[pool.spawn(with_fault=True)])
        t.join(E["deadline"])
    finally:
        pool.kill_all()
    check("summary" in box, "%s the coordinator ended %s (events %s)"
          % (tag, box, [e["event"] for e in coord.events]))
    det = next(e for e in coord.events if e["event"] == "detected")
    resc = next(e for e in coord.events if e["event"] == "rescale")
    rows = _elastic_rows(d, "w0")
    final = max(r["gen"] for r in rows)
    check(det["faulted"] == ["w0"] and det["dead"] == []
          and resc["survivors"] == ["w0"]
          and resc["restore_step"] == E["hang_at"] // 2 * 2,
          "%s detected %s, rescale %s" % (tag, det, resc))
    check(sorted(r["step"] for r in rows if r["gen"] == final)
          == list(range(resc["restore_step"], E["tiny_steps"]))
          and sorted({r["step"] for r in rows})
          == list(range(E["tiny_steps"])),
          "%s the final history %s" % (tag, rows))
    broot = os.path.join(d, "bundles", "w0")
    check(os.path.isdir(broot) and os.listdir(broot),
          "%s no bundle under %s" % (tag, broot))
    report = {"events": [e["event"] for e in coord.events],
              "restore_step": resc["restore_step"],
              "bundles": sorted(os.listdir(broot)),
              "detected_to_rescale_s": resc["wall_time"] - det["wall_time"]}
    print("%s slow_step@%d (%.1f s) against a %.1f s watchdog: %s; rolled "
          "back to step %d at the same size in %.2f s; bundle %s; every "
          "step once in the final history; %s"
          % (tag, E["hang_at"], E["hang_sleep"], E["hang_timeout"],
             report["events"], resc["restore_step"],
             report["detected_to_rescale_s"], report["bundles"], card))
    return report


def elastic_quarantine(tmp, procs, pool_cls, cl, card):
    """Phase 38 (c): the canary every sdc_every steps, bitflip@1 on local
    device 1: quarantined, every later plan carries it, the worker's next
    mesh is built around it."""
    import argparse as _ap
    E, tag = ELASTIC, "elastic (c):"
    d = os.path.join(tmp, "c")
    os.makedirs(d)
    pool = pool_cls(_ap.Namespace(
        cluster_dir=d, steps=E["tiny_steps"], host_devices=E["tiny_host_devices"],
        fault_plan="bitflip@1:1", metrics_port_base=None,
        worker_cmd=_worker_cmd("demo", "--sdc-every", str(E["sdc_every"]))))
    coord, t, box = _elastic_coord(cl, d, num_workers=1,
                                   local_device_count=E["tiny_host_devices"])
    try:
        procs.watch("c/w0", pool.procs[pool.spawn(with_fault=True)])
        t.join(E["deadline"])
        check(pool.procs["w0"].wait(timeout=120) == 0,
              "%s the worker exited %s" % (tag, pool.procs["w0"].returncode))
    finally:
        pool.kill_all()
    check("summary" in box, "%s the coordinator ended %s (events %s)"
          % (tag, box, [e["event"] for e in coord.events]))
    q = next(e for e in coord.events if e["event"] == "quarantine")
    check(q["worker"] == "w0" and q["device"] == 1, "%s %s" % (tag, q))
    later = [p for p in coord._plans if p["gen"] > q["gen"]]
    check(later and all(p["quarantine"] == {"w0": [1]} for p in later),
          "%s plans after the quarantine %s" % (
              tag, [p.get("quarantine") for p in later]))
    st = _elastic_stats(d, "w0")
    first, last = st["gens"][0], st["gens"][-1]
    check(first["local_device_count"] == 2 and last["local_device_count"]
          == 1 and last["skip_local_devices"] == [1]
          and last["devices"] == ["cuda:0"],
          "%s the meshes %s" % (tag, st["gens"]))
    rows = _elastic_rows(d, "w0")
    check(sorted({r["step"] for r in rows}) == list(range(E["tiny_steps"])),
          "%s steps %s" % (tag, rows))
    status = elastic_status(d, tag)
    check(status["plan"]["quarantine"] == {"w0": [1]},
          "%s status --json %s" % (tag, status["plan"]))
    report = {"events": [e["event"] for e in coord.events],
              "quarantine": later[-1]["quarantine"],
              "status_quarantine": status["plan"]["quarantine"],
              "meshes": [(g["gen"], g["local_device_count"],
                          g["skip_local_devices"]) for g in st["gens"]]}
    print("%s canary every %d steps, bitflip@1 on local device 1: %s; "
          "quarantine %s in every later plan and in `status --json`; "
          "meshes (gen, devices, skipped) %s; %s"
          % (tag, E["sdc_every"], report["events"], report["quarantine"],
             report["meshes"], card))
    return report


def elastic_launch_stall(tmp, procs, card):
    """Phase 38 (d): `python -m paddle_tpu_torch.tools.ptpu_elastic
    launch` with heartbeat_stall@stall_at on w1: fenced out on missed
    beats alone, the cohort finishes; w0's /metrics while it trains;
    `status --json` after it."""
    import urllib.request
    from paddle_tpu_torch.tools import ptpu_elastic as tool
    E, tag = ELASTIC, "elastic (d):"
    d = os.path.join(tmp, "d")
    env = dict(os.environ, PYTHONPATH=tool.REPO)
    env.pop("PTPU_FAULT_PLAN", None)
    cmd = [sys.executable, "-m", tool.MODULE, "launch", "--cluster-dir", d,
           "--workers", "2", "--steps", str(E["stall_steps"]),
           "--host-devices", str(E["tiny_host_devices"]), "--local-devices",
           str(E["tiny_host_devices"]), "--heartbeat-timeout",
           str(E["stall_timeout"]), "--fault-worker", "1", "--fault-plan",
           "heartbeat_stall@%d" % E["stall_at"], "--deadline",
           str(E["deadline"]), "--worker-cmd", _worker_cmd(
               "demo", "--metrics-port", "0", "--step-delay",
               str(E["stall_delay"]))]
    log = os.path.join(tmp, "launch.log")
    launch = procs.spawn("launch", cmd, log, env=env)
    scrape = None
    deadline = time.monotonic() + E["deadline"]
    while launch.poll() is None and time.monotonic() < deadline:
        if scrape is None:
            try:
                with open(os.path.join(d, "hb_w0.json")) as f:
                    hb = json.load(f)
            except (OSError, ValueError):
                hb = {}
            if hb.get("metrics_port") and hb.get("step", -1) >= 1:
                try:
                    with urllib.request.urlopen(
                            "http://127.0.0.1:%d/metrics"
                            % hb["metrics_port"], timeout=10) as r:
                        scrape = r.read().decode()
                except OSError:
                    pass
        time.sleep(0.05)
    rc = launch.wait(timeout=60)
    with open(log) as f:
        out = f.read()
    check(rc == 0, "%s launch exited %s: %s" % (tag, rc, out[-3000:]))
    done = [ln for ln in out.splitlines()
            if ln.startswith("[ptpu_elastic] done: ")]
    check(done, "%s no done line: %s" % (tag, out[-2000:]))
    summary = json.loads(done[-1].split("done: ", 1)[1])
    check(summary["steps"].get("w0") == E["stall_steps"]
          and summary["rescales"] >= 1 and "rescale" in summary["events"],
          "%s %s" % (tag, summary))
    check(scrape is not None and "ptpu_cluster_worker_steps_behind" in scrape,
          "%s w0's /metrics %s" % (tag, (scrape or "not reached")[:500]))
    status = elastic_status(d, tag)
    rows = {r["worker"]: r for r in status["workers"]}
    # the stalled w1: fenced out of the plan's world, its last beat left
    # at the generation it stalled in, short of the steps
    plan = status["plan"]
    check(plan["phase"] == "done" and plan["gen"] >= 3
          and plan["num_workers"] == 1
          and rows["w1"]["status"] == "left"
          and rows["w1"]["gen"] == 1 < plan["gen"]
          and rows["w1"]["step"] < E["stall_steps"]
          and rows["w0"]["status"] == "done"
          and rows["w0"]["step"] == E["stall_steps"],
          "%s status --json %s" % (tag, status))
    report = {"summary": summary, "status_plan": plan,
              "stalled_row": {k: rows["w1"][k] for k in (
                  "status", "alive", "step", "gen")},
              "steps_behind_lines": [
                  ln for ln in scrape.splitlines()
                  if ln.startswith("ptpu_cluster_worker_steps_behind")]}
    print("%s launch rc 0: %s; status --json: plan gen %s %s, the stalled "
          "w1 %s; w0's /metrics %s; %s"
          % (tag, summary, plan["gen"], plan["phase"],
             report["stalled_row"], report["steps_behind_lines"], card))
    return report


def elastic_status(d, tag):
    """`python -m paddle_tpu_torch.tools.ptpu_elastic status --json` of
    cluster directory `d` (its monitor's timeout ten process starts and
    more), parsed."""
    from paddle_tpu_torch.tools import ptpu_elastic as tool
    cp = subprocess.run(
        [sys.executable, "-m", tool.MODULE, "status", "--cluster-dir", d,
         "--json", "--heartbeat-timeout", str(ELASTIC["monitor_timeout"])],
        env=dict(os.environ, PYTHONPATH=tool.REPO), capture_output=True,
        text=True, timeout=300)
    check(cp.returncode == 0, "%s status: %s" % (tag, cp.stderr[-2000:]))
    return json.loads(cp.stdout)


def run_elastic_cluster(torch, card):
    """Phase 38 (see ELASTIC and the module's docstring): the paths and
    the `elastic_summary:` report. (b), (c) and (d) start once (a)'s
    cohort has formed (its two processes start on a quieter host) and run
    beside it, each in a cluster directory of its own."""
    from paddle_tpu_torch.resilience import cluster as cl
    from paddle_tpu_torch.tools import ptpu_elastic as tool
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="ptt_phase38_")
    procs = _ElasticProcs()
    t0 = time.perf_counter()
    side, threads = {}, []

    def beside(name, fn, *a):
        try:
            side[name] = fn(*a)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            side[name] = e

    def start_beside():
        for name, fn, a in (
                ("hang", elastic_hang,
                 (tmp, procs, tool._WorkerPool, cl, card)),
                ("quarantine", elastic_quarantine,
                 (tmp, procs, tool._WorkerPool, cl, card)),
                ("stall", elastic_launch_stall, (tmp, procs, card))):
            threads.append(threading.Thread(target=beside,
                                            args=(name, fn) + a))
            threads[-1].start()
    try:
        run, kill_grow = elastic_kill_and_grow(torch, card, tmp, procs,
                                               on_formed=start_beside)
        for th in threads:
            th.join(ELASTIC["deadline"])
        for name in ("hang", "quarantine", "stall"):
            check(name in side, "phase 38: %s did not end" % name)
            if isinstance(side[name], BaseException):
                raise side[name]
    finally:
        procs.close()
        for th in threads:
            th.join(60)
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {"kill_and_grow": kill_grow, "hang": side["hang"],
               "quarantine": side["quarantine"],
               "launch_stall": side["stall"],
               "phase_s": time.perf_counter() - t0, "card": card}
    return [("elastic_cluster", run)], summary


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "elastic-worker":
        return elastic_worker_main(argv[1:])
    if argv and argv[0] == "elastic-reference":
        return elastic_reference_main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("all", "kernels"), default="all")
    ap.add_argument("--k7-baseline", metavar="SRC",
                    help="the baseline fused_lstmp_fwd.cu (one block per "
                    "batch row) to time beside the "
                    "new K7 (default: `git show %s:%s` when the checkout "
                    "has its history)" % (K7_BASELINE_COMMIT, LSTMP_SRC))
    ap.add_argument("--k6-baseline", metavar="SRC",
                    help="the baseline fused_lstm_fwd.cu (one block per "
                    "batch row) to time beside the new K6 (default: `git "
                    "show %s:%s` when the checkout has its history)"
                    % (K6_BASELINE_COMMIT, LSTM_SRC))
    ap.add_argument("--k8-baseline", metavar="SRC",
                    help="the baseline masked_softmax_fwd.cu (three walks "
                    "over each row) to time beside the new K8 (default: "
                    "`git show %s:%s` when the checkout has its history)"
                    % (K8_BASELINE_COMMIT, SOFTMAX_SRC))
    ap.add_argument("--k9-baseline", metavar="SRC",
                    help="the baseline masked_pool_fwd.cu (one block per "
                    "row and feature tile) to time beside the new K9 "
                    "(default: `git show %s:%s` when the checkout has its "
                    "history)" % (K9_BASELINE_COMMIT, POOL_SRC))
    ap.add_argument("--flash-fwd-baseline", metavar="SRC",
                    help="the baseline flash_attention_fwd.cu (fp32 on the "
                    "CUDA cores) to time beside the new K1 (default: `git "
                    "show %s:%s` when the checkout has its history)"
                    % (FLASH_FWD_BASELINE_COMMIT, FLASH_SRC))
    ap.add_argument("--flash-bwd-baseline", metavar="SRC",
                    help="the baseline flash_attention_bwd.cu (fp32 on the "
                    "CUDA cores) to time beside the new K2/K3 (default: "
                    "`git show %s:%s` when the checkout has its history)"
                    % (FLASH_BWD_BASELINE_COMMIT, FLASH_BWD_SRC))
    ap.add_argument("--flash-bf16-fwd-baseline", metavar="SRC",
                    help="the %s flash_attention_fwd.cu (its bf16 K1: TF32 "
                    "mma.sync) to time beside the bf16 wgmma K1 (default: "
                    "`git show %s:%s` when the checkout has its history)"
                    % (FLASH_BF16_BASELINE_COMMIT, FLASH_BF16_BASELINE_COMMIT,
                       FLASH_SRC))
    ap.add_argument("--flash-bf16-bwd-baseline", metavar="SRC",
                    help="the %s flash_attention_bwd.cu (its bf16 K2) to "
                    "time beside the bf16 wgmma K2 (default: `git show "
                    "%s:%s` when the checkout has its history)"
                    % (FLASH_BF16_BASELINE_COMMIT, FLASH_BF16_BASELINE_COMMIT,
                       FLASH_BWD_SRC))
    ap.add_argument("--flash-bf16-dq-baseline", metavar="SRC",
                    help="the %s flash_attention_bwd.cu (its bf16 K3: TF32 "
                    "mma.sync) to time beside the bf16 wgmma K3 (default: "
                    "`git show %s:%s` when the checkout has its history)"
                    % (FLASH_BF16_DQ_BASELINE_COMMIT,
                       FLASH_BF16_DQ_BASELINE_COMMIT, FLASH_BWD_SRC))
    ap.add_argument("--ptxas", action="store_true",
                    help="print the compiler's register/shared-memory report")
    ap.add_argument("--trace", metavar="PATH",
                    help="keep the traced Transformer training step's "
                    "chrome trace here, the stacked LSTM's beside it as "
                    "<PATH stem>_sequences.json, the translator's as "
                    "<PATH stem>_translation.json, the acoustic "
                    "model's as <PATH stem>_acoustic.json, the ResNet-50's "
                    "as <PATH stem>_resnet50_{fp32,bf16}.json, the dense "
                    "zoo models' as <PATH stem>_<model>.json, the "
                    "SRL's as <PATH stem>_srl.json and the OCR model's as "
                    "<PATH stem>_ocr.json")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on a CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import cuda_kernels as ck

    card = card_line()
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw, tc_flops, bf16_flops = peaks_for(name)
    print("device: %s | torch %s, CUDA %s | peaks used for bounds: %.0f "
          "TFLOP/s fp32, %.0f TFLOP/s TF32, %.0f TFLOP/s bf16, %.2f TB/s"
          % (card, torch.__version__, torch.version.cuda, peak_flops / 1e12,
             tc_flops / 1e12, bf16_flops / 1e12, peak_bw / 1e12))

    started = time.perf_counter()
    laps = [started]

    def lap(what):
        """The seconds `what` took and the run's total so far: where the
        1200 s budget goes."""
        now = time.perf_counter()
        print("clock: %s %.1f s (total %.1f s)"
              % (what, now - laps[-1], now - started))
        laps.append(now)

    t0 = time.perf_counter()
    ck.build(verbose=args.ptxas)
    print("build: %s in %.1f s" % (os.path.relpath(ck.build_info.path),
                                   time.perf_counter() - t0))
    if args.ptxas:
        print(ck.build_info.log)
        flash_registers(ck.build_info.log)
        sequence_registers(ck.build_info.log)
        pool_registers(ck.build_info.log)

    kernels = run_kernels(
        torch, ck, peak_flops, peak_bw, tc_flops, bf16_flops,
        baseline_source(args.flash_fwd_baseline, FLASH_FWD_BASELINE_COMMIT,
                        FLASH_SRC),
        baseline_source(args.flash_bwd_baseline, FLASH_BWD_BASELINE_COMMIT,
                        FLASH_BWD_SRC),
        {part: baseline_source(path, *BF16_BASELINES[part])
         for part, path in (("fwd", args.flash_bf16_fwd_baseline),
                            ("dkdv", args.flash_bf16_bwd_baseline),
                            ("dq", args.flash_bf16_dq_baseline))})
    run_unequal_attention_vs_cpu(torch)
    run_flash_grid_check(torch, ck)
    run_fault_checks(torch)
    run_topk_abs_checks(torch)
    run_ctc_fault_checks(torch)
    kernels.update(run_sequence_kernels(
        torch, ck, peak_flops, peak_bw,
        baseline_source(args.k6_baseline, K6_BASELINE_COMMIT, LSTM_SRC)))
    kernels.update(run_pool_kernels(
        torch, ck, peak_flops, peak_bw,
        baseline_source(args.k9_baseline, K9_BASELINE_COMMIT, POOL_SRC)))
    kernels.update(run_translation_kernels(
        torch, ck, peak_flops, peak_bw,
        baseline_source(args.k8_baseline, K8_BASELINE_COMMIT, SOFTMAX_SRC)))
    kernels.update(run_acoustic_kernels(
        torch, ck, peak_flops, peak_bw,
        baseline_source(args.k7_baseline, K7_BASELINE_COMMIT, LSTMP_SRC)))
    kernels.update(run_while_kernel(torch, ck, peak_bw))
    kernels.update(run_guard_kernel(torch, ck, peak_bw))
    lap("build and kernels (phases 1-3)")
    if args.only == "all":
        stem = args.trace and os.path.splitext(args.trace)[0]
        # each path: the launch counts of its run and the counts it
        # predicts (0 for a kernel the path does not run)
        paths = [("transformer_serving", run_serving(torch, card))]
        lap("transformer serving")
        variants = {}
        run, variants["fp32"] = run_training(torch, card,
                                             trace_path=args.trace)
        paths.append(("transformer_training", run))
        run_training_vs_cpu(torch)
        for variant in ("bf16", "dropout"):
            run, variants[variant] = run_training(
                torch, card, variant=variant,
                trace_path=stem and stem + "_transformer_%s.json" % variant)
            paths.append(("transformer_training_" + variant, run))
        bf16_vs_cpu = run_training_bf16_vs_cpu(torch)
        summary = {variant: {k: r[k] for k in (
            "step_ms_median", "tokens_per_s", "peak_mem_bytes",
            "mem_at_start_bytes", "idle_share_est", "device_busy_ms",
            "device_kernels_per_step", "launches_per_step")}
            for variant, r in variants.items()}
        summary["dropout"]["losses"] = variants["dropout"]["losses"]
        summary["bf16_vs_cpu"] = bf16_vs_cpu
        summary["card"] = card
        print("transformer_variants: " + json.dumps(summary))
        lap("transformer training")
        paths += [("sentiment_serving", run_sequence_serving(torch, card)),
                  ("sentiment_training",
                   run_sequence_training(
                       torch, card,
                       trace_path=stem and stem + "_sequences.json"))]
        run_sequence_training_vs_cpu(torch)
        paths.append(("translation_training", run_translation_training(
            torch, card, trace_path=stem and stem + "_translation.json")))
        run_translation_training_vs_cpu(torch)
        paths += [("acoustic_serving", run_acoustic_serving(torch, card)),
                  ("acoustic_training", run_acoustic_training(
                      torch, card,
                      trace_path=stem and stem + "_acoustic.json"))]
        run_acoustic_training_vs_cpu(torch)
        lap("sequences, translation, acoustic")
        paths.append(("lenet_training", run_lenet_training_vs_cpu(torch)))
        conv = {}
        for bf16 in (False, True):
            kind = "bf16" if bf16 else "fp32"
            run, conv[kind] = run_resnet_training(
                torch, card, bf16,
                trace_path=stem and stem + "_resnet50_%s.json" % kind)
            paths.append(("resnet50_training_" + kind, run))
        run, conv["serving"] = run_resnet_serving(torch, card)
        paths.append(("resnet50_serving", run))
        run_resnet_training_vs_cpu(torch)
        nets = {}
        for model in IMAGE_NETS:
            run, nets[model] = run_resnet_training(
                torch, card, False, model=model,
                trace_path=stem and stem + "_%s.json" % model)
            paths.append((model + "_training", run))
        run, nets["vgg16_serving"] = run_resnet_serving(torch, card, "vgg16")
        paths.append(("vgg16_serving", run))
        nets_summary = {model: {k: nets[model][k] for k in (
            "images_per_s", "step_ms_median", "idle_share_est",
            "device_busy_ms", "peak_mem_bytes", "mem_at_start_bytes",
            "device_kernels_per_step")} for model in IMAGE_NETS}
        nets_summary["vgg16_serving"] = {k: nets["vgg16_serving"][k] for k in (
            "p50_ms", "p99_ms", "second_burst_p50_ms", "images_per_s",
            "busy_share_est", "run_direct_ms_by_bucket")}
        nets_summary["vs_cpu"] = run_image_nets_vs_cpu(torch)
        nets_summary["card"] = card
        print("image_nets: " + json.dumps(nets_summary))
        summary = {kind: {k: conv[kind][k] for k in (
            "images_per_s", "step_ms_median", "idle_share_est",
            "device_busy_ms", "peak_mem_bytes", "device_kernels_per_step")}
            for kind in ("fp32", "bf16")}
        summary["serving"] = {k: conv["serving"][k] for k in (
            "p50_ms", "p99_ms", "second_burst_p50_ms", "images_per_s",
            "busy_share_est", "run_direct_ms_by_bucket")}
        summary["port_kernel_launches"] = {
            path: sum(counts.values()) for path, (counts, _) in paths
            if path.startswith(("resnet50", "lenet"))}
        summary["card"] = card
        print("convnet: " + json.dumps(summary))
        lap("conv nets")
        dense = {}
        for model in ("ctr", "recommender", "word2vec", "language_model"):
            run, dense[model + "_training"] = run_dense_training(
                torch, card, model,
                trace_path=stem and stem + "_%s.json" % model)
            paths.append((model + "_training", run))
            if model in ("ctr", "recommender"):
                run, dense[model + "_serving"] = run_dense_serving(
                    torch, card, model)
                paths.append((model + "_serving", run))
        run_dense_vs_cpu(torch)
        run, opt = run_optimizers_vs_cpu(torch, card)
        paths.append(("fit_a_line_optimizers", run))
        run, clipping = run_clipping_vs_cpu(torch, card)
        paths.append(("fit_a_line_clipping", run))
        run, lm_clip = run_lm_clip_training(
            torch, card,
            trace_path=stem and stem + "_language_model_clip.json")
        paths.append(("language_model_clip_training", run))
        paths.append(("verbatim_scripts", run_verbatim_vs_cpu(torch)))
        lap("dense zoo, optimizers, clipping, verbatim")
        multistep = {}
        for path, _ in MULTISTEP_PATHS:
            run, multistep[path] = run_multistep(
                torch, card, path, reduce_check=path == "language_model")
            paths.append(("multistep_" + path, run))
        run_capture_refusal(torch)
        lap("multistep")
        pipelined_paths, pipelined = run_pipelined_serving(torch, card)
        paths += pipelined_paths
        lap("pipelined serving")
        seq_ops = run_sequence_ops_vs_cpu(torch)
        run, srl_train, srl_scope, _ = run_srl_training(
            torch, card, trace_path=stem and stem + "_srl.json")
        paths.append(("srl_training", run))
        run_srl_training_vs_cpu(torch)
        run, srl_serve = run_srl_serving(torch, card, srl_scope)
        paths.append(("srl_serving", run))
        del srl_scope
        torch.cuda.empty_cache()
        print("srl_summary: " + json.dumps({
            "training": {k: srl_train[k] for k in (
                "step_ms_median", "words_per_s", "device_busy_ms",
                "idle_share_est", "peak_mem_bytes", "device_kernels_per_step",
                "launches_per_step", "chunk_eval")},
            "multistep": {k: multistep["srl"][k] for k in (
                "case", "step_ms", "device_busy_ms_per_step", "idle_share")},
            "serving": {k: srl_serve[k] for k in (
                "p50_ms", "p99_ms", "words_per_s", "batches")},
            "sequence_ops_forward_ms": {
                n: seq_ops[n]["forward_ms"] for n in (
                    "dynamic_gru", "linear_chain_crf", "crf_decoding")},
            "card": card}))
        lap("sequence ops, srl")
        run, ocr_train, ocr_scope = run_ocr_training(
            torch, card, trace_path=stem and stem + "_ocr.json")
        paths.append(("ocr_training", run))
        run_ocr_training_vs_cpu(torch)
        run, ocr_serve = run_ocr_serving(torch, card, ocr_scope)
        paths.append(("ocr_serving", run))
        del ocr_scope
        torch.cuda.empty_cache()
        print("ocr_summary: " + json.dumps({
            "training": {k: ocr_train[k] for k in (
                "step_ms_median", "images_per_s", "device_busy_ms",
                "idle_share_est", "peak_mem_bytes", "device_kernels_per_step",
                "launches_per_step", "losses", "evaluation", "warpctc")},
            "serving": {k: ocr_serve[k] for k in (
                "p50_ms", "p99_ms", "images_per_s", "batches")},
            "card": card}))
        lap("ocr")
        decode_paths, transformer_decode = run_transformer_decode(torch, card)
        paths += decode_paths
        translator_paths, translator_decode = run_translator_decode(
            torch, card)
        paths += translator_paths
        loop_checks = run_control_flow_checks(torch)
        print("decode_summary: " + json.dumps({
            "transformer": transformer_decode,
            "translator": translator_decode, "control_flow": loop_checks,
            "card": card}))
        lap("decodes")
        serving_paths, decode_serving = run_decode_serving(
            torch, card, peak_flops, peak_bw)
        paths += serving_paths
        kernels["layer_norm_fwd"]["slot_decode"] = \
            decode_serving["k5_slot_rows"]
        kernels["flash_attention_fwd_bf16"]["serving_dispatch"] = {
            k: decode_serving["weights_dtype"]["bf16"][k] for k in (
                "flash_launches_per_dispatch", "batches")}
        kernels["flash_attention_fwd_bf16"]["serving_dispatch"].update(
            decode_serving["weights_dtype"]["bf16_k1_serving_shape"])
        print("decode_serving_summary: " + json.dumps(decode_serving))
        lap("decode serving")
        run, readers = run_reader_training(torch, card)
        paths.append(("transformer_reader_training", run))
        print("reader_summary: " + json.dumps({
            k: readers[k] for k in (
                "trained_steps", "equal_to_eager_feed_fed",
                "reader_consumed", "staging_synchronizing_calls",
                "prepass_host_ms", "timing", "card")}))
        lap("readers")
        persist_paths, persistence = run_persistence(torch, card)
        paths += persist_paths
        print("persistence_summary: " + json.dumps(persistence))
        lap("persistence")
        resil_paths, resilience = run_resilience(torch, card)
        paths += resil_paths
        print("resilience_summary: " + json.dumps(resilience))
        lap("resilience")
        par_paths, parallel, (case35, ref35) = run_parallel(torch, card)
        paths += par_paths
        print("parallel_summary: " + json.dumps(parallel))
        lap("parallel")
        ppm_paths, programs = run_parallel_programs(torch, card, case35,
                                                    ref35)
        paths += ppm_paths
        del case35, ref35
        print("parallel_programs_summary: " + json.dumps(programs))
        lap("parallel programs")
        fleet_paths, fleet = run_serving_fleet(torch, card)
        paths += fleet_paths
        print("serving_fleet_summary: " + json.dumps(fleet))
        lap("serving fleet")
        elastic_paths, elastic = run_elastic_cluster(torch, card)
        paths += elastic_paths
        print("elastic_summary: " + json.dumps(elastic))
        lap("elastic cluster")
        print("clipping_summary: " + json.dumps({
            "fit_a_line": {k: v for k, v in clipping.items() if k != "card"},
            "language_model_clip": {k: lm_clip[k] for k in (
                "step_ms_median", "tokens_per_s", "idle_share_est",
                "device_busy_ms", "device_kernels_per_step")},
            "language_model": {k: dense["language_model_training"][k]
                               for k in ("step_ms_median", "tokens_per_s",
                                         "device_kernels_per_step")},
            "card": card}))
        summary = {path: {k: v for k, v in r.items() if k in (
            "step_ms_median", "rows_per_s", "tokens_per_s", "peak_mem_bytes",
            "mem_at_start_bytes", "launches_per_step", "idle_share_est", "device_busy_ms",
            "device_kernels_per_step", "p50_ms", "p99_ms",
            "second_burst_p50_ms", "busy_share_est", "launches")}
            for path, r in dense.items()}
        summary["optimizers"] = {k: opt[k] for k in ("max_loss_err",
                                                     "max_state_err")}
        summary["card"] = card
        print("dense_zoo: " + json.dumps(summary))
        for path, (counts, expected) in paths:
            for kname, n in expected.items():
                check(counts[kname] == n, "%s: %s launched %d times, "
                      "expected %d" % (path, kname, counts[kname], n))
        for kname, r in kernels.items():
            r["launches_by_path"] = {path: counts[kname]
                                     for path, (counts, _) in paths}
            r["launches"] = sum(r["launches_by_path"].values())
            check(r["launches"] > 0, "%s never launched on any path that "
                  "chip_smoke.py drives" % kname)
    for r in kernels.values():
        r.setdefault("launches", None)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    if args.only == "all":
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
